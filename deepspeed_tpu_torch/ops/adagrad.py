"""Adagrad under the reference's class name (counterpart of
`deepspeed_tpu/ops/adagrad.py`): `DeepSpeedCPUAdagrad` returns the port's
Adagrad (`ops/optim.py`), with coupled weight decay in front when set, as
JAX chains optax's `add_decayed_weights`, tagged for the engine's
host-resident state."""

import dataclasses

from deepspeed_tpu_torch.ops import optim
from deepspeed_tpu_torch.ops.adam import _decayed


def DeepSpeedCPUAdagrad(model_params=None, lr=1e-2, eps=1e-10,
                        weight_decay=0.0):
    tx = _decayed(optim._adagrad(lr, {"eps": eps}), weight_decay)
    return dataclasses.replace(tx, offload_to_host=True)


__all__ = ["DeepSpeedCPUAdagrad"]
