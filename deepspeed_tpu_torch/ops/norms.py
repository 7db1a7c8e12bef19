"""Fused LayerNorm / RMSNorm over the last dim (counterpart of
`deepspeed_tpu/ops/pallas/norms.py`).

`fused_layer_norm(x, scale, bias, eps, residual)` and
`fused_rms_norm(x, scale, eps, residual)`: the residual, when given, is
added first, in the promoted dtype of x and the residual (JAX adds
`x + residual` before its call), and the output is in that dtype; the
statistics are fp32 (LayerNorm's variance is the two-pass
mean((x - mean)^2)); eps goes inside the rsqrt; scale and bias apply in
fp32. The row sums accumulate in fp64 and each statistic is rounded to
fp32 once (the correctly rounded fp32 mean and variance), and 1/sqrt is
IEEE sqrt then division: so the result does not depend on the order of
the sums, and the kernel and its plain version agree bit for bit.

On a CUDA tensor each op launches the hand-written kernel once
(`csrc/norms.cu`: a warp per row, the row in registers, up to
`WARP_MAX_BYTES` of output a row; a block per row through a ring of
shared-memory slots filled by bulk copies above, and for rows that are
not 16-byte aligned or whose residual has another dtype) and counts the
launch in `op_builder.LAUNCHES`. It takes any last dim up to `MAX_DIM`,
x, the residual and the parameters in any of float32 / bfloat16 /
float16, and reads scale and bias in their own dtype (only a scale and a
bias of two different dtypes are widened to fp32 first, exactly). On a
CPU tensor it runs the plain version beside it. As in the JAX package no
model path calls these ops: `models/gpt.py`'s `_norm` stays plain torch.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops import op_builder

# the widest row the kernel takes (`kMaxDim` in csrc/norms.cu)
MAX_DIM = 32768
# rows of at most this many bytes of output take the warp-row kernel
# (`kWarpMaxBytes` in csrc/norms.cu; read here, set there)
WARP_MAX_BYTES = 2048
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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
                                     ctypes.c_float] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]


def _check_operands(what, x, scale, bias, residual):
    """Raises on what the kernel does not take; returns the output dtype."""
    if not x.is_cuda:
        raise ValueError(f"{what}: unsupported device {x.device}")
    for name, t in (("x", x), ("residual", residual), ("scale", scale),
                    ("bias", bias)):
        if t is not None and t.dtype not in _DTYPES:
            raise ValueError(f"{what}: the kernel takes float32/bfloat16/"
                             f"float16, got {name} {t.dtype}")
    D = x.shape[-1]
    if not 0 < D <= MAX_DIM:
        raise ValueError(f"{what}: last dim {D} must be in 1..{MAX_DIM}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.device != x.device):
        raise ValueError(f"{what}: residual {tuple(residual.shape)} on "
                         f"{residual.device} must match x "
                         f"{tuple(x.shape)} on {x.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (D,) or t.device != x.device):
            raise ValueError(f"{what}: {name} must be [{D}] on {x.device}, "
                             f"got {tuple(t.shape)} on {t.device}")
    return x.dtype if residual is None else \
        torch.promote_types(x.dtype, residual.dtype)


def _launch(what, x, scale, bias, eps, residual, rms):
    out_dtype = _check_operands(what, x, scale, bias, residual)
    fn = op_builder.load("norms").dstt_norm
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    if bias is not None and bias.dtype != scale.dtype:
        scale, bias = scale.float(), bias.float()
    x = x.contiguous()
    residual = None if residual is None else residual.contiguous()
    scale = scale.contiguous()
    bias = scale if bias is None else bias.contiguous()
    out = x.new_empty(x.shape, dtype=out_dtype)
    D = x.shape[-1]
    rows = x.numel() // D
    if rows == 0:
        return out
    rc = fn(x.data_ptr(), None if residual is None else residual.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, D,
            float(eps), int(rms), op_builder.dtype_code(x.dtype),
            0 if residual is None else op_builder.dtype_code(residual.dtype),
            op_builder.dtype_code(scale.dtype),
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
