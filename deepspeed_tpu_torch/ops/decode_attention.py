"""Single-token KV-cache attention — the decode hot op (counterpart of
`deepspeed_tpu/ops/pallas/decode_attention.py`).

Layout: q [B, H, hd]; contiguous cache k/v [B, Hkv, M, hd]; paged pool
k/v [N, Hkv, block, hd] with block tables [B, nb]; pos [B] (current
position, inclusive — the new token's k/v is already written at pos).
GQA: H is a multiple of Hkv, each kv head serves G = H // Hkv query heads.
The int8 pool (`paged_decode_attention_quant`) keeps k/v as int8 with f32
scales k_scale/v_scale [N, Hkv, block, hd // g] beside them.

On a CUDA tensor the wrappers launch the hand-written kernel
(`csrc/decode_attention.cu`: one split kernel for the three, the
contiguous cache taken as a pool whose row b owns block b); on a CPU
tensor they run the plain version.
There is no fallback: a CUDA input the kernel does not take raises.

The kernel splits each row's live prefix into chunks of positions
(`split_plan`, from the shapes alone: the wrappers never read `pos` on the
host, which would wait for the card and break CUDA-graph capture); each
chunk's partial softmax (m, l, acc) goes to fp32 scratch and the row's last
chunk to finish merges them. `paged_partials_reference` and
`combine_partials_reference` are that algorithm in plain PyTorch, for the
tests and `chip_smoke.py`.
"""

import ctypes
import functools
import math

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.attention_dispatch import (DECODE_DTYPES,
                                                        KERNEL_HEAD_DIMS)

NEG_INF = -1e30
# the split kernel's plan: chunks of a power of two, at least MIN_CHUNK
# positions (every tile of the kernel divides it), at most about
# SPLIT_ITEMS work items a call (one wave of the H100's 132 SMs at the 4 to
# 6 blocks an SM the paths' kernels fit; PERF.md §5)
MIN_CHUNK = 64
SPLIT_ITEMS = 768
# the split kernel's scratch (the chunks' partials, fp32) and ticket
# counters, kept per (device, stream): a launch on a stream ends before the
# next one starts. At least this many tickets (rows x kv heads).
_MIN_TICKETS = 4096
_SCRATCH = {}
_DTYPES = {getattr(torch, name) for name in DECODE_DTYPES}


@functools.lru_cache(maxsize=256)
def split_plan(capacity, rows):
    """(chunk, n_chunks) of the split kernel, from shapes only: each of
    `rows` (rows x kv heads) cut into chunks of its `capacity` (nb *
    block, or the contiguous cache's M) of a power of two positions, at
    least MIN_CHUNK and at least capacity / (SPLIT_ITEMS / rows): 128 at
    the serving path's shape (96 rows of 1024), 64 at generate()'s (48
    rows of 1024), 512 at 64 rows of 4096."""
    n = max(1, min(-(-SPLIT_ITEMS // rows), -(-capacity // MIN_CHUNK)))
    chunk = max(MIN_CHUNK, 1 << (-(-capacity // n) - 1).bit_length())
    return chunk, -(-capacity // chunk)


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


def _gathered(q, k_pool, v_pool, block_tables, scales=None):
    """Each row's logical K/V [B, Hkv, nb * block, hd] through the table
    (the same gather the serving path's fallback uses), dequantized as
    `dequantize_kv` does for the int8 pool (`scales`: k_scale, v_scale;
    int8 x scale in fp32, narrowed to q's dtype)."""
    from deepspeed_tpu_torch.inference.kv_cache import gather_block_kv
    from deepspeed_tpu_torch.ops.quant import dequantize_reference
    k, v = gather_block_kv(k_pool, v_pool, block_tables)
    if scales is None:
        return k, v
    ks, vs = gather_block_kv(*scales, block_tables)
    g = k.shape[-1] // ks.shape[-1]
    return (dequantize_reference(k, ks, q.dtype, g),
            dequantize_reference(v, vs, q.dtype, g))


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables, pos,
                                     sm_scale=None):
    """Plain version (counterpart of `paged_decode_attention_reference`):
    gather each row's blocks into a contiguous cache, then the contiguous
    plain version."""
    k, v = _gathered(q, k_pool, v_pool, block_tables)
    return decode_attention_reference(q, k, v, pos, sm_scale=sm_scale)


def paged_decode_attention_quant_reference(q, pool_l, block_tables, pos,
                                           sm_scale=None):
    """Plain version (counterpart of `paged_decode_attention_quant_reference`),
    plain torch on every device: payload and scales of one layer's int8
    pool {"k", "v", "k_scale", "v_scale"} gathered and dequantized
    (`_gathered`), then the contiguous plain version."""
    k, v = _gathered(q, pool_l["k"], pool_l["v"], block_tables,
                     (pool_l["k_scale"], pool_l["v_scale"]))
    return decode_attention_reference(q, k, v, pos, sm_scale=sm_scale)


def paged_partials_reference(q, k_pool, v_pool, block_tables, pos, chunk,
                             sm_scale=None, scales=None):
    """Plain version of the paged kernels' first half (tests and
    chip_smoke only): each chunk of `chunk` positions of each row's prefix
    0..pos (clamped to the capacity) as one work item computes it, fp32:
    m [B, Hkv, n, G] the chunk's largest score, l [B, Hkv, n, G] the sum of
    exp(s - m) and acc [B, Hkv, n, G, hd] the sum of exp(s - m) v over its
    live positions; a chunk with none has m = -inf, l = 0, acc = 0."""
    k, v = _gathered(q, k_pool, v_pool, block_tables, scales)
    B, H, hd = q.shape
    _, Hkv, M, _ = k.shape
    G = H // Hkv
    n = -(-M // chunk)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    pad = (0, 0, 0, n * chunk - M)
    kf = torch.nn.functional.pad(k.float(), pad)
    vf = torch.nn.functional.pad(v.float(), pad)
    s = torch.einsum("bkgd,bkmd->bkgm", q.reshape(B, Hkv, G, hd).float(),
                     kf) * sm_scale
    live = (torch.arange(n * chunk, device=q.device)[None, :]
            <= pos.to(q.device).long().clamp(max=M - 1)[:, None])
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    s = s.reshape(B, Hkv, G, n, chunk)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    acc = torch.einsum("bkgnc,bkncd->bkngd", p,
                       vf.reshape(B, Hkv, n, chunk, hd))
    return m.transpose(2, 3), p.sum(-1).transpose(2, 3), acc


def combine_partials_reference(m, l, acc, dtype):
    """Plain version of the paged kernels' combine: each (row, kv head)'s
    chunk partials merged, out = sum_c e^(m_c - M) acc_c / sum_c
    e^(m_c - M) l_c with M the largest m_c (chunks with m = -inf add
    nothing; no live chunk at all gives 0) -> [B, H, hd] in `dtype`."""
    mx = m.amax(2, keepdim=True)
    w = torch.exp(m - torch.where(torch.isinf(mx), 0.0, mx))
    out = (w[..., None] * acc).sum(2) \
        / (w * l).sum(2).clamp_min(1e-30)[..., None]
    B, Hkv, G, hd = out.shape
    return out.reshape(B, Hkv * G, hd).to(dtype)


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _kernel():
    fn = op_builder.load("decode_attention").dstt_paged_decode
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, what, kv_dtype=None):
    """Shapes, devices, dtypes and alignment the kernel takes; K/V are in
    q's dtype unless `kv_dtype` (int8) says otherwise."""
    dev, want = q.device, kv_dtype or q.dtype
    if k.device != dev or v.device != dev or k.dtype != want \
            or v.dtype != want:
        raise ValueError(f"{what}: k {k.dtype} on {k.device}, v {v.dtype} "
                         f"on {v.device}; expected {want} on {dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: the kernel takes {DECODE_DTYPES}, got "
                         f"{q.dtype}")
    B, H, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS or k.shape[-1] != hd:
        raise ValueError(f"{what}: head_dim {hd} (k {k.shape[-1]}); the "
                         f"kernel takes {KERNEL_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             f"16-byte aligned")
    if q.requires_grad:
        raise NotImplementedError(f"{what}: no backward kernel")
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"{what}: {H} query heads over {Hkv} kv heads")
    return B, H, Hkv, hd


def _scratch(q, stream, n_part, n_tickets):
    """The paged kernel's scratch on q's card for `stream`: (fp32 partials,
    at least `n_part`; ticket counters, at least `n_tickets`, zero at rest:
    each launch leaves them zero), made by torch.empty (the tickets filled
    with 0) when first asked for or when they must grow."""
    key = (q.device, stream.value)
    have = _SCRATCH.get(key)
    if have is None or have[0].numel() < n_part \
            or have[1].numel() < n_tickets:
        part = q.new_empty((n_part,), dtype=torch.float32)
        if have is None or have[1].numel() < n_tickets:
            tickets = q.new_empty((max(n_tickets, _MIN_TICKETS),),
                                  dtype=torch.int32)
            tickets.zero_()
        else:
            tickets = have[1]
        have = _SCRATCH[key] = (part, tickets)
    return have


def _launch_paged(what, q, k, v, block_tables, pos, sm_scale, scales=None):
    """Check and launch the split kernel over the fp pool, or with `scales`
    (k_scale, v_scale) over the int8 pool, or with no `block_tables` over
    the contiguous cache [B, Hkv, M, hd] (a pool of B blocks of M rows,
    row b's one page block b): the split plan from the shapes, the
    stream's scratch for the chunks' partials, one launch; pos and the
    table stay on the card."""
    B, H, Hkv, hd = _check(q, k, v, what,
                           kv_dtype=torch.int8 if scales else None)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    dev = q.device
    if block_tables is None:
        if k.shape[0] != B or v.shape != k.shape:
            raise ValueError(f"{what}: cache k {tuple(k.shape)}, v "
                             f"{tuple(v.shape)} for {B} rows")
        table, bs, nb = None, k.shape[2], 1
    else:
        table = block_tables.to(device=dev, dtype=torch.int32).contiguous()
        if table.dim() != 2 or table.shape[0] != B:
            raise ValueError(f"{what}: tables {tuple(table.shape)} for {B} "
                             f"rows")
        bs, nb = k.shape[2], table.shape[1]
    pos = pos.to(device=dev, dtype=torch.int32).contiguous()
    if pos.shape != (B,):
        raise ValueError(f"{what}: pos {tuple(pos.shape)}, expected ({B},)")
    chunk, n_chunks = split_plan(nb * bs, B * Hkv)
    out = torch.empty_like(q)
    stream = op_builder.stream_ptr(dev)
    part, tickets = _scratch(q, stream, B * H * n_chunks * (hd + 2),
                             B * Hkv)
    ks, vs = scales if scales else (None, None)
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        ks.data_ptr() if scales else None, vs.data_ptr() if scales else None,
        out.data_ptr(), pos.data_ptr(),
        None if table is None else table.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), B, H, Hkv, hd, bs, nb,
        ks.shape[-1] if scales else 0, chunk, n_chunks, float(sm_scale),
        op_builder.dtype_code(q.dtype), stream)
    op_builder.check(rc, what)
    op_builder.LAUNCHES[what] += 1
    return out


def decode_attention(q, k, v, pos, sm_scale=None):
    """q [B, H, hd]; k, v [B, Hkv, M, hd]; pos [B] int -> [B, H, hd].

    Attends each query head to cache positions 0..pos inclusive (pos
    clamped to M - 1). The kernel reads only the live prefix of each row,
    whatever M is allocated: it is the paged split kernel with no table."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, pos, sm_scale=sm_scale)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return _launch_paged("decode_attention", q, k, v, None, pos, sm_scale)


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
    return _launch_paged("paged_decode_attention", q, k_pool, v_pool,
                         block_tables, pos, sm_scale)


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
    ng, dev = k_scale.shape[-1], q.device
    want = (*k_pool.shape[:-1], ng)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != want:
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{want} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if ng < 1 or q.shape[-1] % ng:
        raise ValueError(f"{what}: {ng} scale groups do not tile head_dim "
                         f"{q.shape[-1]}")
    return _launch_paged(what, q, k_pool, v_pool, block_tables, pos,
                         sm_scale, scales=(k_scale, v_scale))
