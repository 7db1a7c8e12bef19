"""Single-token KV-cache attention — the decode hot op (counterpart of
`deepspeed_tpu/ops/pallas/decode_attention.py`).

Layout: q [B, H, hd]; contiguous cache k/v [B, Hkv, M, hd]; paged pool
k/v [N, Hkv, block, hd] with block tables [B, nb]; pos [B] (current
position, inclusive — the new token's k/v is already written at pos).
GQA: H is a multiple of Hkv, each kv head serves G = H // Hkv query heads.

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


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _kernel():
    fn = op_builder.load("decode_attention").dstt_decode_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, what):
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
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


def _launch(what, q, k, v, pos, table, m_or_bs, nb, sm_scale):
    B, H, Hkv, hd = _check(q, k, v, what)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    pos = pos.to(device=q.device, dtype=torch.int32).contiguous()
    if pos.shape != (B,):
        raise ValueError(f"{what}: pos {tuple(pos.shape)}, expected ({B},)")
    out = torch.empty_like(q)
    fn = _kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            pos.data_ptr(), table.data_ptr() if table is not None else None,
            B, H, Hkv, hd, m_or_bs, nb, float(sm_scale),
            op_builder.dtype_code(q.dtype), op_builder.stream_ptr(q.device))
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
