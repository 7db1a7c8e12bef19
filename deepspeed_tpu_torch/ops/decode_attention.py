"""Single-token KV-cache attention — the decode hot op (counterpart of
`deepspeed_tpu/ops/pallas/decode_attention.py`).

Layout: q [B, H, hd]; contiguous cache k/v [B, Hkv, M, hd]; paged pool
k/v [N, Hkv, block, hd] with block tables [B, nb]; pos [B] (current
position, inclusive — the new token's k/v is already written at pos).
GQA: H is a multiple of Hkv, each kv head serves G = H // Hkv query heads.
The int8 pool (`paged_decode_attention_quant`) keeps k/v as int8 with f32
scales k_scale/v_scale [N, Hkv, block, hd // g] beside them.

On a CUDA tensor the wrappers launch the hand-written kernel
(`csrc/decode_attention.cu`); on a CPU tensor they run the plain version.
There is no fallback: a CUDA input the kernel does not take raises.
"""

import ctypes
import math

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.attention_dispatch import (DECODE_DTYPES,
                                                        KERNEL_HEAD_DIMS)

NEG_INF = -1e30


def decode_attention_reference(q, k, v, pos, sm_scale=None):
    """Plain version (counterpart of `decode_attention_reference`): fp32
    grouped einsum over the whole cache, masked to 0..pos."""
    B, H, hd = q.shape
    _, Hkv, M, _ = k.shape
    G = H // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bkgd,bkmd->bkgm", qg, k.float()) * sm_scale
    valid = (torch.arange(M, device=q.device)[None, :]
             <= pos.to(q.device).long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgm,bkmd->bkgd", p, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables, pos,
                                     sm_scale=None):
    """Plain version (counterpart of `paged_decode_attention_reference`):
    gather each row's blocks into a contiguous cache — the same gather the
    serving path's fallback uses — then the contiguous plain version."""
    from deepspeed_tpu_torch.inference.kv_cache import gather_block_kv
    k, v = gather_block_kv(k_pool, v_pool, block_tables)
    return decode_attention_reference(q, k, v, pos, sm_scale=sm_scale)


def paged_decode_attention_quant_reference(q, pool_l, block_tables, pos,
                                           sm_scale=None):
    """Plain version (counterpart of `paged_decode_attention_quant_reference`),
    plain torch on every device: gather payload and scales of one layer's
    int8 pool {"k", "v", "k_scale", "v_scale"} through the table, dequantize
    them as `dequantize_kv` does (int8 x scale in fp32, narrowed to q's
    dtype), then the contiguous plain version."""
    from deepspeed_tpu_torch.inference.kv_cache import gather_block_kv
    from deepspeed_tpu_torch.ops.quant import dequantize_reference
    k, v = gather_block_kv(pool_l["k"], pool_l["v"], block_tables)
    ks, vs = gather_block_kv(pool_l["k_scale"], pool_l["v_scale"],
                             block_tables)
    g = k.shape[-1] // ks.shape[-1]
    return decode_attention_reference(
        q, dequantize_reference(k, ks, q.dtype, g),
        dequantize_reference(v, vs, q.dtype, g), pos, sm_scale=sm_scale)


_ARGTYPES = {
    "dstt_decode_attention": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "dstt_paged_decode_attention_quant": [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _kernel(name="dstt_decode_attention"):
    fn = getattr(op_builder.load("decode_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, what, kv_dtype=None):
    """Shapes, devices, dtypes and alignment the kernel takes; K/V are in
    q's dtype unless `kv_dtype` (int8) says otherwise."""
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
        if t.dtype != (kv_dtype or q.dtype):
            raise ValueError(f"{what}: {name} is {t.dtype}, expected "
                             f"{kv_dtype or q.dtype}")
    if str(q.dtype).replace("torch.", "") not in DECODE_DTYPES:
        raise ValueError(f"{what}: the kernel takes {DECODE_DTYPES}, got "
                         f"{q.dtype}")
    hd = q.shape[-1]
    if hd not in KERNEL_HEAD_DIMS or k.shape[-1] != hd:
        raise ValueError(f"{what}: head_dim {hd} (k {k.shape[-1]}); the "
                         f"kernel takes {KERNEL_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             f"16-byte aligned")
    if q.requires_grad:
        raise NotImplementedError(f"{what}: no backward kernel")
    B, H, _ = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"{what}: {H} query heads over {Hkv} kv heads")
    return B, H, Hkv, hd


def _launch(what, q, k, v, pos, table, m_or_bs, nb, sm_scale, scales=None):
    """Check and launch one kernel: the fp entry point, or with `scales`
    (k_scale, v_scale) the int8 pool's."""
    B, H, Hkv, hd = _check(q, k, v, what,
                           kv_dtype=torch.int8 if scales else None)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    if pos.shape != (B,):
        raise ValueError(f"{what}: pos {tuple(pos.shape)}, expected ({B},)")
    out = torch.empty_like(q)
    args = (pos.data_ptr(), table.data_ptr() if table is not None else None,
            B, H, Hkv, hd, m_or_bs, nb)
    if scales is None:
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), *args, float(sm_scale),
                       op_builder.dtype_code(q.dtype),
                       op_builder.stream_ptr(q.device))
    else:
        ks, vs = scales
        rc = _kernel("dstt_paged_decode_attention_quant")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), out.data_ptr(), *args, ks.shape[-1],
            float(sm_scale), op_builder.dtype_code(q.dtype),
            op_builder.stream_ptr(q.device))
    op_builder.check(rc, what)
    op_builder.LAUNCHES[what] += 1
    return out


def decode_attention(q, k, v, pos, sm_scale=None):
    """q [B, H, hd]; k, v [B, Hkv, M, hd]; pos [B] int -> [B, H, hd].

    Attends each query head to cache positions 0..pos inclusive. The kernel
    reads only the live prefix of each row, whatever M is allocated."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, pos, sm_scale=sm_scale)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _launch("decode_attention", q, k, v, pos, None, k.shape[2], 0,
                   sm_scale)


def paged_decode_attention(q, k_pool, v_pool, block_tables, pos,
                           sm_scale=None):
    """Decode attention over a paged pool (vLLM's PagedAttention layout).

    q [B, H, hd]; k_pool, v_pool [N, Hkv, block, hd]; block_tables [B, nb]
    int mapping each row's logical block to a physical pool block; pos [B].
    Returns [B, H, hd]. No gather is materialized: the kernel resolves each
    live position through the table. Rows whose tables point only at the
    trash block (inactive slots, pos 0) produce output callers ignore."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pool, v_pool,
                                                block_tables, pos,
                                                sm_scale=sm_scale)
    if not q.is_cuda:
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    table = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    if table.shape[0] != q.shape[0]:
        raise ValueError(f"paged_decode_attention: tables for "
                         f"{table.shape[0]} rows, q has {q.shape[0]}")
    return _launch("paged_decode_attention", q, k_pool, v_pool, pos, table,
                   k_pool.shape[2], table.shape[1], sm_scale)


def paged_decode_attention_quant(q, k_pool, v_pool, k_scale, v_scale,
                                 block_tables, pos, sm_scale=None):
    """Decode attention over the INT8 paged pool, dequantizing inside the
    kernel.

    q [B, H, hd]; k_pool, v_pool int8 [N, Hkv, block, hd]; k_scale, v_scale
    f32 [N, Hkv, block, hd // g]; block_tables [B, nb]; pos [B]. Returns
    [B, H, hd] in q's dtype. Each staged K/V element is dequantized as
    `dequantize_kv` does it (int8 x scale in fp32, narrowed to q's dtype),
    so the kernel and its plain version attend over the same values."""
    if q.device.type == "cpu":
        return paged_decode_attention_quant_reference(
            q, {"k": k_pool, "v": v_pool, "k_scale": k_scale,
                "v_scale": v_scale}, block_tables, pos, sm_scale=sm_scale)
    what = "paged_decode_attention_quant"
    if not q.is_cuda:
        raise ValueError(f"{what}: unsupported device {q.device}")
    ng = k_scale.shape[-1]
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != q.device or t.dtype != torch.float32 \
                or not t.is_contiguous() \
                or tuple(t.shape) != tuple(k_pool.shape[:-1]) + (ng,):
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{tuple(k_pool.shape[:-1]) + (ng,)} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    if ng < 1 or q.shape[-1] % ng:
        raise ValueError(f"{what}: {ng} scale groups do not tile head_dim "
                         f"{q.shape[-1]}")
    table = block_tables.to(device=q.device, dtype=torch.int32).contiguous()
    if table.shape[0] != q.shape[0]:
        raise ValueError(f"{what}: tables for {table.shape[0]} rows, q has "
                         f"{q.shape[0]}")
    return _launch(what, q, k_pool, v_pool, pos, table, k_pool.shape[2],
                   table.shape[1], sm_scale, scales=(k_scale, v_scale))
