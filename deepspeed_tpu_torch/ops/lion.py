"""Lion under the reference's class names (counterpart of
`deepspeed_tpu/ops/lion.py`): `FusedLion` returns the port's Lion
(`ops/optim.py`); `DeepSpeedCPULion` the same, tagged for the engine's
host-resident state."""

import dataclasses

from deepspeed_tpu_torch.ops import optim


def FusedLion(params=None, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0):
    return optim._lion(lr, {"betas": tuple(betas),
                            "weight_decay": weight_decay})


def DeepSpeedCPULion(model_params=None, lr=1e-4, betas=(0.9, 0.99),
                     weight_decay=0.0):
    return dataclasses.replace(
        FusedLion(model_params, lr=lr, betas=betas,
                  weight_decay=weight_decay), offload_to_host=True)


__all__ = ["FusedLion", "DeepSpeedCPULion"]
