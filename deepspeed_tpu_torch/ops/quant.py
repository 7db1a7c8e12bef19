"""Groupwise symmetric int8 / packed int4 quantization (counterpart of
`deepspeed_tpu/ops/pallas/quant.py`).

Symmetric per group of `group_size` consecutive elements of the last dim:
scale = max(|x|, 1e-8) / qmax (qmax 127 for int8, 7 for int4),
q = clip(round_half_even(x / scale), -qmax, qmax). int4 packs two values a
byte as biased nibbles q + 8 (lo nibble = even index), stored as int8.
Dequantization multiplies in fp32 and narrows to the output dtype last.

These functions are the numerics of the weight-only quantization and of
the int8 KV pool (`inference/quantization.py`). On a CUDA tensor each
wrapper launches the hand-written kernel (`csrc/quant.cu`) and counts the
launch in `op_builder.LAUNCHES`; on a CPU tensor it runs the plain version
beside it. There is no fallback: a CUDA input the kernel does not take
raises. `dequantize_many` dequantizes several leaves (a model layer's) in
one launch; `dequantize` is its one-leaf case.
"""

import ctypes

import torch

from deepspeed_tpu_torch.ops import op_builder

_QMAX = {8: 127.0, 4: 7.0}


def _check_geometry(D, group_size, bits, what):
    if bits not in _QMAX:
        raise ValueError(f"{what}: bits must be 4 or 8 (got {bits})")
    if group_size < 1 or D % group_size:
        raise ValueError(f"{what}: last dim {D} does not tile into groups of "
                         f"{group_size}")
    if bits == 4 and D % 2:
        raise ValueError(f"{what}: int4 packs two values per byte — last dim "
                         f"{D} must be even")


def quantize_reference(x, group_size, bits=8):
    """Plain version: x [..., D] float -> (q int8 [..., D] for 8 bits or
    packed [..., D//2] for 4, scales f32 [..., D//group_size])."""
    D = x.shape[-1]
    _check_geometry(D, group_size, bits, "quantize")
    ng = D // group_size
    xg = x.float().reshape(x.shape[:-1] + (ng, group_size))
    amax = xg.abs().amax(dim=-1)
    # divide by a tensor, not a Python number: PyTorch's CUDA division by a
    # host scalar multiplies by its reciprocal, which is not IEEE division
    qmax = torch.tensor(_QMAX[bits], dtype=torch.float32, device=x.device)
    scale = amax.clamp_min(1e-8) / qmax
    q = torch.clamp(torch.round(xg / scale[..., None]), -qmax, qmax)
    q = q.to(torch.int32).reshape(x.shape)
    if bits == 4:
        qu = q + 8
        q = (qu[..., 0::2] | (qu[..., 1::2] << 4)).to(torch.uint8).view(
            torch.int8)
    else:
        q = q.to(torch.int8)
    return q, scale


def dequantize_reference(q, scales, dtype, group_size, bits=8):
    """Plain version: the inverse of `quantize_reference` -> [..., D] in
    `dtype` (fp32 product, narrowed last)."""
    if bits == 4:
        b = q.view(torch.uint8).to(torch.int32)
        q = torch.stack([(b & 0xF) - 8, (b >> 4) - 8], dim=-1).reshape(
            q.shape[:-1] + (2 * q.shape[-1],))
    D = q.shape[-1]
    ng = D // group_size
    x = q.float().reshape(q.shape[:-1] + (ng, group_size)) * scales[..., None]
    return x.reshape(q.shape).to(dtype)


# leaves one dequantize launch takes (quant.cu kMaxLeaves)
MAX_LEAVES = 32

_ARGTYPES = {
    "dstt_quantize": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p],
    "dstt_dequantize_many": [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def _kernel(name):
    fn = getattr(op_builder.load("quant"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(t, what):
    if not t.is_cuda:
        raise ValueError(f"{what}: unsupported device {t.device}")


def quantize(x, group_size, bits):
    """x [..., D] float -> (q, scales) at `bits` 8 or 4 (any other raises)."""
    what = f"quantize_int{bits}"
    if x.device.type == "cpu":
        return quantize_reference(x, group_size, bits)
    _check_cuda(x, what)
    D = x.shape[-1]
    _check_geometry(D, group_size, bits, what)
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: the kernel takes float32/bfloat16/float16, "
                         f"got {x.dtype}")
    x = x.contiguous()              # rows of a strided view, packed
    rows = x.numel() // D
    q = torch.empty(x.shape[:-1] + (D if bits == 8 else D // 2,),
                    dtype=torch.int8, device=x.device)
    s = torch.empty(x.shape[:-1] + (D // group_size,), dtype=torch.float32,
                    device=x.device)
    if rows == 0:
        return q, s
    rc = _kernel("dstt_quantize")(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, D, group_size, bits,
        op_builder.dtype_code(x.dtype), op_builder.stream_ptr(x.device))
    op_builder.check(rc, what)
    op_builder.LAUNCHES[what] += 1
    return q, s


def _check_dequantize(q, scales, dtype, group_size, bits, what):
    """Raise ValueError for a CUDA leaf the kernel does not take; returns
    the dense last dim."""
    _check_cuda(q, what)
    D = q.shape[-1] * (2 if bits == 4 else 1)
    _check_geometry(D, group_size, bits, what)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{what}: payload must be int8 and scales float32, "
                         f"got {q.dtype} / {scales.dtype}")
    if scales.device != q.device or \
            tuple(scales.shape) != tuple(q.shape[:-1]) + (D // group_size,):
        raise ValueError(f"{what}: scales {tuple(scales.shape)} on "
                         f"{scales.device} do not match payload "
                         f"{tuple(q.shape)} at group {group_size}")
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: output dtype {dtype} (the kernel writes "
                         f"float32/bfloat16/float16)")
    return D


def dequantize_many_reference(leaves):
    """Plain version of `dequantize_many`: `dequantize_reference` of each
    leaf in turn."""
    return [dequantize_reference(*leaf) for leaf in leaves]


def dequantize_many(leaves):
    """Several leaves dense, in order. Each leaf is `dequantize`'s
    arguments, (q, scales, dtype, group_size, bits); all of one `bits` and
    one `dtype` (mixed ones raise). On CUDA one launch takes up to
    MAX_LEAVES leaves, each with its own length and group size: a model
    layer's quantized leaves in one launch."""
    leaves = list(leaves)
    if not leaves:
        return []
    _, _, dtype, _, bits = leaves[0]
    if any(leaf[4] != bits for leaf in leaves) or \
            any(leaf[2] != dtype for leaf in leaves):
        raise ValueError(
            f"dequantize_many: one launch takes one bit width and one output "
            f"dtype, got bits {sorted({leaf[4] for leaf in leaves})} and "
            f"dtypes {sorted({str(leaf[2]) for leaf in leaves})}")
    what = f"dequantize_int{bits}"
    if all(leaf[0].device.type == "cpu" for leaf in leaves):
        return dequantize_many_reference(leaves)
    outs, args = [], []
    for q, scales, _, group_size, _ in leaves:
        D = _check_dequantize(q, scales, dtype, group_size, bits, what)
        q, scales = q.contiguous(), scales.contiguous()
        out = q.new_empty(tuple(q.shape[:-1]) + (D,), dtype=dtype)
        outs.append(out)
        n = out.numel()
        if n:
            args.append((q.data_ptr(), scales.data_ptr(), out.data_ptr(), n,
                         group_size))
    fn = _kernel("dstt_dequantize_many") if args else None
    for i in range(0, len(args), MAX_LEAVES):
        chunk = args[i:i + MAX_LEAVES]
        k = len(chunk)
        qp, sp, op, n, g = zip(*chunk)
        rc = fn(k, (ctypes.c_void_p * k)(*qp), (ctypes.c_void_p * k)(*sp),
                (ctypes.c_void_p * k)(*op), (ctypes.c_longlong * k)(*n),
                (ctypes.c_int * k)(*g), bits, op_builder.dtype_code(dtype),
                op_builder.stream_ptr(leaves[0][0].device))
        op_builder.check(rc, what)
        op_builder.LAUNCHES[what] += 1
    return outs


def dequantize(q, scales, dtype, group_size, bits):
    """Inverse of `quantize` at the same `bits` (one leaf of
    `dequantize_many`)."""
    return dequantize_many([(q, scales, dtype, group_size, bits)])[0]


def quantize_int8(x, group_size):
    """x [..., D] float -> (q int8 [..., D], scales f32 [..., D//group_size])."""
    return quantize(x, group_size, 8)


def dequantize_int8(q, scales, dtype, group_size):
    """Inverse of `quantize_int8`: int8 [..., D] + scales -> [..., D] in
    `dtype`."""
    return dequantize(q, scales, dtype, group_size, 8)


def quantize_int4(x, group_size):
    """x [..., D] float -> (packed int8 [..., D//2], scales f32
    [..., D//group_size]); D must be even."""
    return quantize(x, group_size, 4)


def dequantize_int4(q, scales, dtype, group_size):
    """Inverse of `quantize_int4`: packed [..., D//2] + scales -> [..., D] in
    `dtype`."""
    return dequantize(q, scales, dtype, group_size, 4)
