"""Profiler range annotations (counterpart of `deepspeed_tpu/utils/nvtx.py`,
the reference's `utils/nvtx.py` `instrument_w_nvtx` and accelerator
`range_push/range_pop`).

On this package's device a range is a `torch.profiler.record_function`
region (it shows in a torch.profiler trace) and, on CUDA, an NVTX range
(`torch.cuda.nvtx`, for an external NVTX-aware profiler). Both are opened
only while a torch profiler records: otherwise every entry point is a hard
no-op, so the telemetry span layer (`telemetry/spans.py`) stays free to
call on every scheduler step. Setting `_Annotation` to None turns the
ranges off for good.
"""

import contextlib
import functools

import torch


def _nvtx_module():
    try:
        if torch.cuda.is_available():
            return torch.cuda.nvtx
    except Exception:          # pragma: no cover - depends on the build
        pass
    return None


_NVTX = _nvtx_module()


class _Range:
    """One named range: a record_function region, plus an NVTX range on
    CUDA."""

    __slots__ = ("name", "_rf")

    def __init__(self, name):
        self.name = name
        self._rf = None

    def __enter__(self):
        self._rf = torch.autograd.profiler.record_function(self.name)
        self._rf.__enter__()
        if _NVTX is not None:
            _NVTX.range_push(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        if _NVTX is not None:
            _NVTX.range_pop()
        self._rf.__exit__(exc_type, exc, tb)
        return False


_Annotation = _Range

# LIFO of open ranges so range_pop() matches the reference accelerator API
# (`accelerator/abstract_accelerator.py` range_pop takes no arguments).
_RANGE_STACK = []


def _active():
    """A range is opened only while a torch profiler records."""
    return _Annotation is not None and torch.autograd._profiler_enabled()


def range_push(msg):
    """Start a named range (reference accelerator.range_push); None when no
    profiler records."""
    if not _active():
        return None
    t = _Annotation(msg)
    t.__enter__()
    _RANGE_STACK.append(t)
    return t


def range_pop(t=None):
    """End a range started with range_push. With no argument, pops the most
    recently pushed range (reference API); a handle may also be passed."""
    if t is None:
        if not _RANGE_STACK:
            return
        t = _RANGE_STACK.pop()
    else:
        # remove the handle wherever it sits so a later argless pop never
        # exits it a second time
        try:
            _RANGE_STACK.remove(t)
        except ValueError:
            pass
    t.__exit__(None, None, None)


def instrument_w_nvtx(func):
    """Decorator: wrap `func` in a named range while a profiler records
    (reference `utils/nvtx.py:instrument_w_nvtx`); returns `func` unchanged
    when ranges are off."""
    if _Annotation is None:
        return func

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        with annotate(func.__qualname__):
            return func(*args, **kwargs)

    return wrapped


def annotate(name):
    """Context manager for a named range (null when no profiler records)."""
    if not _active():
        return contextlib.nullcontext()
    return _Annotation(name)
