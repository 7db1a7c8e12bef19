"""Parameter-tree helpers (counterpart of `deepspeed_tpu/utils/tree.py`).

A parameter tree here is nested dicts / lists / tuples of tensors — the JAX
pytree's leaf names and shapes, kept so one initialisation moves across.
"""

import torch


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_cast(tree, dtype):
    """Cast the floating leaves of a tree to `dtype` (others untouched)."""

    def cast(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf.to(dtype)
        return leaf

    return tree_map(cast, tree)
