"""LAMB under the reference's class name (counterpart of
`deepspeed_tpu/ops/lamb.py`): `FusedLamb` returns the port's LAMB
(`ops/optim.py`), with optax's global-norm clip in front when
`max_grad_norm` is set. `max_coeff` / `min_coeff` are accepted for the
reference's signature and unused, as in JAX (optax's LAMB does not clamp
its trust ratio).
"""

import dataclasses

import torch

from deepspeed_tpu_torch.ops import optim
from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_unflatten


def _clipped(tx, max_norm):
    """`tx` after optax's `clip_by_global_norm(max_norm)`: the grads
    scaled by max_norm / ‖g‖ where the global norm exceeds it (the norm
    over whole leaves where the leaves are shards)."""

    def update(grads, state, params, apply=None, leaf_norms=None):
        g = [x.float() for x in tree_leaves(grads)]
        norms = leaf_norms(g) if leaf_norms is not None \
            else torch._foreach_norm(g)
        total = torch.sqrt(sum(n * n for n in norms))
        scale = torch.where(total < max_norm, 1.0, max_norm / total)
        tx.update(tree_unflatten(grads, [x * scale for x in g]), state,
                  params, apply, leaf_norms=leaf_norms)

    return dataclasses.replace(tx, update=update)


def FusedLamb(params=None, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
              eps=1e-8, weight_decay=0.0, max_grad_norm=0.0, max_coeff=10.0,
              min_coeff=0.01):
    tx = optim._lamb(lr, {"betas": tuple(betas), "eps": eps,
                          "weight_decay": weight_decay})
    if max_grad_norm and max_grad_norm > 0:
        tx = _clipped(tx, max_grad_norm)
    return tx


__all__ = ["FusedLamb"]
