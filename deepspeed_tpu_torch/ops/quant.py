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
    "dstt_quantize_kv_write": [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4
    + [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    + [ctypes.c_int] * 8 + [ctypes.c_void_p],
}
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)
_INDEX = (torch.int32, torch.int64)


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
    """x [..., D] float -> (q, scales) at `bits` 8 or 4 (any other raises).
    On CUDA one launch of `dstt_quantize` at either width: the vector body
    where D is a multiple of 8, g divides 8 or is a multiple of 8 up to
    1024 and x is 16-byte aligned (q is allocated here, so its payload
    words are aligned), else the row body."""
    what = f"quantize_int{bits}"
    if x.device.type == "cpu":
        return quantize_reference(x, group_size, bits)
    _check_cuda(x, what)
    D = x.shape[-1]
    _check_geometry(D, group_size, bits, what)
    if x.dtype not in _FLOATS:
        raise ValueError(f"{what}: the kernel takes float32/bfloat16/float16, "
                         f"got {x.dtype}")
    x = x.contiguous()              # rows of a strided view, packed
    rows = x.numel() // D
    q = x.new_empty(x.shape[:-1] + (D if bits == 8 else D // 2,),
                    dtype=torch.int8)
    s = x.new_empty(x.shape[:-1] + (D // group_size,), dtype=torch.float32)
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


def _check_kv_write(k, v, block_tables, positions, k_pool, v_pool, k_scale,
                    v_scale):
    """Shapes and dtypes of the int8 pool write, on every device; returns
    the group size g (ValueError on a mismatch)."""
    what = "quantize_kv_write"
    if k.dim() != 4 or v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError(f"{what}: k {tuple(k.shape)} {k.dtype}, v "
                         f"{tuple(v.shape)} {v.dtype}: expected two "
                         f"[B, C, Hkv, hd] of one dtype")
    B, C, Hkv, D = k.shape
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 or \
            k_pool.dim() != 4 or v_pool.shape != k_pool.shape or \
            k_pool.shape[1] != Hkv or k_pool.shape[3] != D:
        raise ValueError(f"{what}: pool payload {tuple(k_pool.shape)} "
                         f"{k_pool.dtype} / {tuple(v_pool.shape)} "
                         f"{v_pool.dtype}: expected int8 [N, {Hkv}, bs, {D}]")
    ng = k_scale.shape[-1] if k_scale.dim() == 4 else 0
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32 or \
            ng < 1 or D % ng or v_scale.shape != k_scale.shape or \
            k_scale.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"{what}: scales {tuple(k_scale.shape)} "
                         f"{k_scale.dtype} / {tuple(v_scale.shape)} "
                         f"{v_scale.dtype}: expected float32 "
                         f"{tuple(k_pool.shape[:3])} + (hd // g,)")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or \
            tuple(positions.shape) != (B, C):
        raise ValueError(f"{what}: tables {tuple(block_tables.shape)}, "
                         f"positions {tuple(positions.shape)} for k "
                         f"{tuple(k.shape)}")
    return D // ng


def quantize_kv_write_reference(k, v, block_tables, positions, k_pool,
                                v_pool, k_scale, v_scale):
    """Plain version of `quantize_kv_write`: block and offset of each new
    token through the table, `quantize_reference` of K and of V, and four
    index writes into the pool."""
    g = _check_kv_write(k, v, block_tables, positions, k_pool, v_pool,
                        k_scale, v_scale)
    bs = k_pool.shape[2]
    blk = torch.gather(block_tables.long(), 1, (positions // bs).long())
    off = positions % bs
    for x, pool, scale in ((k, k_pool, k_scale), (v, v_pool, v_scale)):
        q, s = quantize_reference(x, g)
        pool[blk, :, off] = q
        scale[blk, :, off] = s


def quantize_kv_write(k, v, block_tables, positions, k_pool, v_pool,
                      k_scale, v_scale):
    """One layer's int8 pool write, in place: the new tokens' K and V
    [B, C, Hkv, hd] quantized groupwise (`quantize_int8`'s numerics, g =
    hd // k_scale.shape[-1]) into k_pool / v_pool int8 [N, Hkv, bs, hd] and
    k_scale / v_scale f32 [N, Hkv, bs, hd // g] at (block_tables[b,
    pos // bs], h, pos % bs), pos = positions[b, c]. On CUDA one launch
    (counted as a `quantize_int8` launch) computes blocks and offsets,
    quantizes both tensors and stores payload and scales; a K/V view
    whose (b, c) rows are not contiguous is packed first. Tokens of
    inactive slots (all-trash tables, pos 0) collide in the trash block,
    where the write order is unspecified; each real token's (block,
    offset) is unique in the step, so its payload and scales come from
    the same token. g must divide 8 or be a multiple of 8 (at most 1024)
    on CUDA."""
    if k.device.type == "cpu":
        return quantize_kv_write_reference(k, v, block_tables, positions,
                                           k_pool, v_pool, k_scale, v_scale)
    what = "quantize_int8"
    _check_cuda(k, what)
    g = _check_kv_write(k, v, block_tables, positions, k_pool, v_pool,
                        k_scale, v_scale)
    B, C, Hkv, D = k.shape
    if k.dtype not in _FLOATS:
        raise ValueError(f"{what}: the kernel takes float32/bfloat16/float16, "
                         f"got {k.dtype}")
    if not (g % 8 == 0 and g <= 1024 or 8 % g == 0) or D % 8:
        raise ValueError(f"{what}: the pool write takes head_dim a multiple "
                         f"of 8 and groups dividing 8 or a multiple of 8 up "
                         f"to 1024, got head_dim {D}, g {g}")
    if block_tables.dtype not in _INDEX or positions.dtype not in _INDEX:
        raise ValueError(f"{what}: tables {block_tables.dtype} and positions "
                         f"{positions.dtype} must be int32 or int64")
    dev, esize = k.device, k.element_size()
    for t in (v, block_tables, positions, k_pool, v_pool, k_scale, v_scale):
        if t.device != dev:
            raise ValueError(f"{what}: every tensor on {dev}, got {t.device}")
    for t in (k_pool, v_pool, k_scale, v_scale):
        if not t.is_contiguous():
            raise ValueError(f"{what}: the pool tensors must be contiguous")
    xs = []
    for x in (k, v):
        if x.stride(3) != 1 or x.stride(2) != D or x.data_ptr() % 16 \
                or (x.stride(0) * esize) % 16 or (x.stride(1) * esize) % 16:
            x = x.contiguous()
        xs.append(x)
    k, v = xs
    tables, positions = block_tables.contiguous(), positions.contiguous()
    rc = _kernel("dstt_quantize_kv_write")(
        k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), positions.data_ptr(), positions.dtype == torch.int64,
        tables.data_ptr(), tables.dtype == torch.int64, k_pool.data_ptr(),
        v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), B, C, Hkv,
        D, g, k_pool.shape[2], tables.shape[1], op_builder.dtype_code(k.dtype),
        op_builder.stream_ptr(dev))
    op_builder.check(rc, what)
    op_builder.LAUNCHES[what] += 1
