"""`deepspeed_tpu_torch.runtime.utils` (counterpart of
`deepspeed_tpu/runtime/utils.py`): the reference's most imported helpers,
`see_memory_usage`, `get_global_norm` and `clip_grad_norm_`. As in the JAX
package they are functional: `clip_grad_norm_` returns the clipped tree and
the norm and leaves its input as it was."""


from deepspeed_tpu_torch.utils.memory import see_memory_usage
from deepspeed_tpu_torch.utils.tree import tree_global_norm, tree_map


def get_global_norm(norm_list=None, parameters=None):
    """The norm of per-group norms, or the global L2 norm of a tree (fp32
    sums), as a Python float."""
    if norm_list is not None:
        return float(sum(float(n) ** 2 for n in norm_list) ** 0.5)
    return float(tree_global_norm(parameters))


def clip_grad_norm_(parameters=None, max_norm=1.0, mpu=None, grads=None):
    """(the tree scaled by min(1, max_norm / (‖g‖ + 1e-6)), ‖g‖): `grads`,
    or the reference's `parameters` name for it."""
    tree = grads if grads is not None else parameters
    total = tree_global_norm(tree)
    factor = (max_norm / (total + 1e-6)).clamp_max(1.0)
    clipped = tree_map(lambda g: g * factor.to(g.dtype), tree)
    return clipped, float(total)


__all__ = ["see_memory_usage", "get_global_norm", "clip_grad_norm_"]
