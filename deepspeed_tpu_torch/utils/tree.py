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


def tree_leaves(tree):
    """Leaves in the JAX pytree order: dict keys sorted, sequences in
    order — the order `jax.tree_util.tree_leaves` gives the same tree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped like `tree` holding `leaves` (in `tree_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    return build(tree)


def tree_num_params(tree):
    return int(sum(leaf.numel() for leaf in tree_leaves(tree)))


def tree_global_norm(tree):
    """L2 norm over all leaves, accumulated in fp32 (a bf16 reduction would
    round and overflow); a 0-d fp32 tensor."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(leaf.float().square().sum() for leaf in leaves))


def tree_all_finite(tree):
    """0-d bool tensor: every element of every floating leaf is finite."""
    finite = [torch.isfinite(leaf).all() for leaf in tree_leaves(tree)
              if leaf.is_floating_point()]
    if not finite:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(finite).all()
