"""`deepspeed_tpu_torch.moe` — the reference's `deepspeed.moe` import
namespace (`deepspeed/moe/`). The implementation lives in
`parallel/moe.py`; this package keeps the reference import path
(`from deepspeed.moe.layer import MoE`)."""

from deepspeed_tpu_torch.moe import layer
from deepspeed_tpu_torch.parallel.moe import MoE, MoELayer

__all__ = ["MoE", "MoELayer", "layer"]
