"""Adam variants under the reference's class names (counterpart of
`deepspeed_tpu/ops/adam.py`): `FusedAdam` and `DeepSpeedCPUAdam` return the
port's optimizer transforms (`ops/optim.py`). "Fused" is the `_foreach`
update over all leaves; `DeepSpeedCPUAdam` is tagged for the engine's
host-resident state (ZeRO-Offload's streamed tier), as JAX tags it.
"""

import dataclasses

from deepspeed_tpu_torch.ops import optim
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _decayed(tx, weight_decay):
    """`tx` after adding `weight_decay * p` to the grads (optax's
    `chain(add_decayed_weights(wd), tx)`: coupled L2 decay)."""
    if not weight_decay:
        return tx

    def update(grads, state, params, apply=None, **kw):
        g = [x.float() + weight_decay * p.float()
             for x, p in zip(tree_leaves(grads), tree_leaves(params))]
        tx.update(tree_unflatten(grads, g), state, params, apply, **kw)

    return dataclasses.replace(tx, update=update)


def FusedAdam(params=None, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
              eps=1e-8, adam_w_mode=True, weight_decay=0.0, amsgrad=False,
              set_grad_none=True):
    """Adam (AdamW with `adam_w_mode`); `params` is accepted for the
    reference's signature."""
    if amsgrad:
        raise ValueError("amsgrad not supported (matches reference FusedAdam)")
    hp = {"betas": tuple(betas), "eps": eps}
    if adam_w_mode:
        return optim._adamw(lr, {**hp, "weight_decay": weight_decay})
    return _decayed(optim._adam(lr, hp), weight_decay)


def DeepSpeedCPUAdam(model_params=None, lr=1e-3, bias_correction=True,
                     betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                     amsgrad=False, adamw_mode=True,
                     fp32_optimizer_states=True):
    """`FusedAdam`'s math with its state held in host memory (the engine's
    streamed ZeRO-Offload tier)."""
    tx = FusedAdam(model_params, lr=lr, bias_correction=bias_correction,
                   betas=betas, eps=eps, adam_w_mode=adamw_mode,
                   weight_decay=weight_decay, amsgrad=amsgrad)
    return dataclasses.replace(tx, offload_to_host=True)


__all__ = ["FusedAdam", "DeepSpeedCPUAdam"]
