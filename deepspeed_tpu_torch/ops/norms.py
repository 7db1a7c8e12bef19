"""Fused LayerNorm / RMSNorm over the last dim (counterpart of
`deepspeed_tpu/ops/pallas/norms.py`).

`fused_layer_norm(x, scale, bias, eps, residual)` and
`fused_rms_norm(x, scale, eps, residual)`: the residual, when given, is
added first in x's dtype; the statistics are fp32 (LayerNorm's variance is
the two-pass mean((x - mean)^2)); eps goes inside the rsqrt; scale and bias
apply in fp32 and the output is in x's dtype. The row sums accumulate in
fp64 and each statistic is rounded to fp32 once (the correctly rounded
fp32 mean and variance), and 1/sqrt is IEEE sqrt then division: so the
result does not depend on the order of the sums, and the kernel and its
plain version agree bit for bit.

On a CUDA tensor each op launches the hand-written kernel
(`csrc/norms.cu`: one warp per row, 16-byte loads, the row held in
registers between the passes) and counts the launch in
`op_builder.LAUNCHES`; on a CPU tensor it runs the plain version beside it.
As in the JAX package no model path calls these ops: `models/gpt.py`'s
`_norm` stays plain torch.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops import op_builder

MAX_DIM = 8192


def _add_residual(x, residual):
    return x if residual is None else x + residual


def _row_mean(t):
    """fp32 row mean, summed in fp64 and rounded once."""
    return t.double().mean(dim=-1, keepdim=True).float()


def layer_norm_reference(x, scale, bias, eps=1e-5, residual=None):
    """Plain version of `fused_layer_norm`."""
    x = _add_residual(x, residual)
    xf = x.float()
    mean = _row_mean(xf)
    var = _row_mean((xf - mean).square())
    y = (xf - mean) * (1.0 / torch.sqrt(var + eps))
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm_reference(x, scale, eps=1e-5, residual=None):
    """Plain version of `fused_rms_norm`."""
    x = _add_residual(x, residual)
    xf = x.float()
    y = xf * (1.0 / torch.sqrt(_row_mean(xf.square()) + eps))
    return (y * scale.float()).to(x.dtype)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def _launch(what, x, scale, bias, eps, residual, rms):
    if not x.is_cuda:
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: the kernel takes float32/bfloat16/float16, "
                         f"got {x.dtype}")
    D = x.shape[-1]
    vec = 16 // x.element_size()
    if D % vec or not 0 < D <= MAX_DIM:
        raise ValueError(f"{what}: last dim {D} must be a multiple of {vec} "
                         f"(16-byte loads) and at most {MAX_DIM}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"{what}: residual {tuple(residual.shape)} "
                         f"{residual.dtype} must match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (D,) or t.device != x.device):
            raise ValueError(f"{what}: {name} must be [{D}] on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    fn = op_builder.load("norms").dstt_norm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    x = x.contiguous()
    residual = None if residual is None else residual.contiguous()
    scale = scale.float().contiguous()
    bias = scale if bias is None else bias.float().contiguous()
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return out
    rc = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, D,
            float(eps), int(rms), op_builder.dtype_code(x.dtype),
            op_builder.stream_ptr(x.device))
    op_builder.check(rc, what)
    op_builder.LAUNCHES[what] += 1
    return out


def fused_layer_norm(x, scale, bias, eps=1e-5, residual=None):
    """LayerNorm over the last dim of x [..., D]; `residual` is added first."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps, residual)
    return _launch("fused_layer_norm", x, scale, bias, eps, residual, False)


def fused_rms_norm(x, scale, eps=1e-5, residual=None):
    """RMSNorm over the last dim of x [..., D]; `residual` is added first."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, scale, eps, residual)
    return _launch("fused_rms_norm", x, scale, None, eps, residual, True)
