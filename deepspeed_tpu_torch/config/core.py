"""Config-block machinery (own copy of `deepspeed_tpu/config/core.py`'s
`ConfigModel`): dataclass construction from dicts with unknown-key warnings
and recursive nesting."""

import dataclasses
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.utils.logging import logger


def issubclass_safe(t, parent):
    try:
        return issubclass(t, parent)
    except TypeError:
        return False


class ConfigModel:
    """Base for config blocks, mirroring `DeepSpeedConfigModel`."""

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]], path=""):
        d = dict(d or {})
        kwargs = {}
        field_map = {f.name: f for f in dataclasses.fields(cls)}
        for key, value in d.items():
            if key not in field_map:
                logger.warning(f"Config: unknown key '{path}{key}' ignored")
                continue
            ftype = field_map[key].type
            if isinstance(value, dict) and isinstance(ftype, type) \
                    and issubclass_safe(ftype, ConfigModel):
                value = ftype.from_dict(value, path=f"{path}{key}.")
            kwargs[key] = value
        return cls(**kwargs)
