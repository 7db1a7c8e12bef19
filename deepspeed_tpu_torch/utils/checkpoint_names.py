"""Named regions for selective remat (the port's counterpart of
`jax.ad_checkpoint.checkpoint_name`).

JAX tags one tensor with a name and a `save_only_these_names` policy keeps
the tagged tensors. The port's selective policies run under
`torch.utils.checkpoint`'s selective contexts, which decide op by op as
the dispatcher runs them, so a name here tags a REGION: every op run inside
`with checkpoint_name("mlp_up"):` carries that name, and the policy
(`models/gpt.py` `resolve_remat_policy`) reads it with `current_name()`.
A region costs a thread-local write and tags nothing when gradients are
off (serving).
"""

import contextlib
import threading

import torch

_STATE = threading.local()
_NULL = contextlib.nullcontext()


class _Region:
    __slots__ = ("name", "_prev")

    def __init__(self, name):
        self.name = name
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_STATE, "name", None)
        _STATE.name = self.name
        return self

    def __exit__(self, exc_type, exc, tb):
        _STATE.name = self._prev
        return False


def checkpoint_name(name):
    """Tag the ops run inside the block with `name` (a null context when
    gradients are off)."""
    if not torch.is_grad_enabled():
        return _NULL
    return _Region(name)


def current_name():
    """The name of the innermost open region on this thread, or None."""
    return getattr(_STATE, "name", None)
