"""Evoformer attention (counterpart of `deepspeed_tpu/ops/pallas/evoformer_attn.py`):
biased attention for AlphaFold-style models.

`evoformer_attention(q, k, v, biases=(), sm_scale=None)`: q, k, v [B, N,
S, H, D] (batch, MSA rows / residue groups, sequence, heads, head dim);
`biases` holds at most one key-mask bias [B, N, 1, 1, S] and at most one
pair bias [B, 1, H, S, S] (each may broadcast over its batch, row or head
dims). Returns [B, N, S, H, D] in q's dtype; differentiable in q, k, v and
both biases.

The forward is one `torch.autograd.Function`: on a CUDA tensor it launches
the hand-written kernel (`csrc/evoformer_attn.cu`: bf16 / fp16 on the
tensor cores with fp32-accurate products, the pair bias read once per
group of at least 8 MSA rows; fp32 on the CUDA cores; any S and B * N *
H, D in {32, 64, 128}) or raises; on a CPU tensor it runs the plain version
(`evoformer_attention_reference`, the counterpart of `_evo_attn_math`).
The kernel reads the biases in their own dtype (the pair in q's dtype or
fp32) and q, k, v in place wherever its TMA maps can (strides multiples of
16 bytes); a view they cannot read is copied first.
The backward is plain PyTorch on every device, as the JAX backward is jnp
(`_evo_core_bwd`): it recomputes the attention a chunk of MSA rows at a
time, the chunk sized so that its fp32 intermediates stay under
`BWD_CHUNK_BYTES` (JAX's scan holds one row), and returns the mask and pair
gradients in their inputs' shapes. The JAX op falls back to jnp where its
TPU tiles do not fit; the port's kernel takes any S, and runs no such
fallback on the card.
"""

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from deepspeed_tpu_torch.ops import op_builder

KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the backward's fp32 [C, B, H, S, S] intermediates (scores / p, dp, ds and
# one product's temporary) held under this many bytes
BWD_CHUNK_BYTES = 256 << 20
_BWD_LIVE = 4


def _parse_biases(biases, B, N, S, H):
    """(mask [Bm, Nm, S] or None, pair [Bp, Hp, S, S] or None) from the
    op's bias list, with the JAX op's refusals."""
    mask = pair = None
    for b in biases:
        if b is None:
            continue
        if b.dim() != 5:
            raise ValueError(f"bias must be 5-D, got shape {tuple(b.shape)}")
        if b.shape[2] == 1 and b.shape[3] == 1:         # [B, N, 1, 1, S]
            if mask is not None:
                raise ValueError("duplicate mask bias")
            mask = b.reshape(b.shape[0], b.shape[1], b.shape[4])
        elif b.shape[1] == 1:                           # [B, 1, H, S, S]
            if pair is not None:
                raise ValueError("duplicate pair bias")
            pair = b[:, 0]
        else:
            raise ValueError(
                f"unsupported bias shape {tuple(b.shape)}: expected "
                "[B,N,1,1,S] (mask) or [B,1,H,S,S] (pair)")
    for name, t, lead, tail in (("mask", mask, (B, N), (S,)),
                                ("pair", pair, (B, H), (S, S))):
        if t is not None and (tuple(t.shape[2:]) != tail or any(
                a not in (1, w) for a, w in zip(t.shape[:2], lead))):
            raise ValueError(f"{name} bias of shape {tuple(t.shape)} does "
                             f"not broadcast to {lead + tail}")
    return mask, pair


def _scores(q, k, mask, pair, sm_scale):
    """fp32 [B, N, H, S, S] scores of [B, N, S, H, D] inputs."""
    s = torch.einsum("bnqhd,bnkhd->bnhqk", q.float(), k.float()) * sm_scale
    if mask is not None:
        s = s + mask.float()[:, :, None, None, :]
    if pair is not None:
        s = s + pair.float()[:, None]
    return s


def _reference_fwd(q, k, v, mask, pair, sm_scale):
    p = torch.softmax(_scores(q, k, mask, pair, sm_scale), dim=-1)
    return torch.einsum("bnhqk,bnkhd->bnqhd", p, v.float()).to(q.dtype)


def evoformer_attention_reference(q, k, v, biases=(), sm_scale=None):
    """Plain version (the counterpart of `_evo_attn_math`): materialized
    fp32 softmax attention, the output in q's dtype."""
    B, N, S, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    mask, pair = _parse_biases(biases, B, N, S, H)
    return _reference_fwd(q, k, v, mask, pair, sm_scale)


def bwd_rows(B, N, S, H):
    """MSA rows the backward recomputes at once: as many as keep its
    `_BWD_LIVE` fp32 [rows, B, H, S, S] intermediates under
    `BWD_CHUNK_BYTES`, at least one."""
    per_row = _BWD_LIVE * B * H * S * S * 4
    return max(1, min(N, BWD_CHUNK_BYTES // per_row))


def _backward(q, k, v, mask, pair, g, sm_scale, rows=None):
    """The counterpart of `_evo_core_bwd`: recompute `rows` MSA rows at a
    time (default `bwd_rows`; JAX scans one). Returns (dq, dk, dv, dmask
    [Bm, Nm, S] or None, dpair [Bp, Hp, S, S] or None)."""
    B, N, S, H, D = q.shape
    rows = rows or bwd_rows(B, N, S, H)
    dq, dk, dv = (torch.empty(q.shape, dtype=x.dtype, device=q.device)
                  for x in (q, k, v))
    dmask = torch.empty((B, N, S), dtype=torch.float32, device=q.device) \
        if mask is not None else None
    dpair = torch.zeros((B, H, S, S), dtype=torch.float32, device=q.device) \
        if pair is not None else None
    mask_full = mask.float().expand(B, N, S) if mask is not None else None
    pair_full = pair.float().expand(B, H, S, S) if pair is not None else None
    for n0 in range(0, N, rows):
        sl = slice(n0, n0 + rows)
        qn, kn, vn, gn = (x[:, sl].float() for x in (q, k, v, g))  # [B,C,S,H,D]
        s = torch.einsum("bnqhd,bnkhd->bnhqk", qn, kn) * sm_scale
        if mask_full is not None:
            s = s + mask_full[:, sl, None, None, :]
        if pair_full is not None:
            s = s + pair_full[:, None]
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, sl] = torch.einsum("bnhqk,bnqhd->bnkhd", p, gn)
        dp = torch.einsum("bnqhd,bnkhd->bnhqk", gn, vn)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        del p, dp
        dq[:, sl] = torch.einsum("bnhqk,bnkhd->bnqhd", ds, kn) * sm_scale
        dk[:, sl] = torch.einsum("bnhqk,bnqhd->bnkhd", ds, qn) * sm_scale
        if dmask is not None:
            dmask[:, sl] = ds.sum((2, 3))
        if dpair is not None:
            dpair += ds.sum(1)
    if dmask is not None:
        dmask = _unbroadcast(dmask, mask.shape).to(mask.dtype)
    if dpair is not None:
        dpair = _unbroadcast(dpair, pair.shape).to(pair.dtype)
    return dq, dk, dv, dmask, dpair


def _unbroadcast(grad, shape):
    """Sum `grad` over the dims where `shape` broadcasts (size 1)."""
    dims = [i for i, (g, s) in enumerate(zip(grad.shape, shape)) if s != g]
    return grad.sum(dims, keepdim=True) if dims else grad


# the extern "C" entry point's parameters: q, k, v, o, mask, pair | B, N, S,
# H, D | strides | mask_sb, mask_sn, pair_sb, pair_sh | mask_dtype,
# pair_dtype | scale | dtype | stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
    ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_longlong] * 4 + [
    ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _kernel():
    fn = op_builder.load("evoformer_attn").dstt_evoformer_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _bias_strides(t, dims):
    """Element strides of a contiguous bias over its leading `dims`, 0 where
    it broadcasts (size 1)."""
    return [t.stride(i) if t.shape[i] > 1 else 0 for i in range(dims)]


def _kernel_layout_ok(t):
    """What the 16-bit kernel's TMA maps read in place: a contiguous last
    dim, the other strides positive multiples of 16 bytes where the dim has
    more than one entry, a 16-byte aligned base."""
    step = 16 // t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and st % step == 0)
        for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def _kernel_bias(t, dtype, pair):
    """A bias as the kernel reads it: contiguous, in its own dtype where the
    kernel takes it (a 16-bit q's mask: any kernel dtype; its pair: q's
    dtype or fp32), widened to fp32 otherwise (and for an fp32 q)."""
    if t is None:
        return None
    if dtype == torch.float32 or t.dtype not in KERNEL_DTYPES or (
            pair and t.dtype not in (dtype, torch.float32)):
        t = t.float()
    return t.contiguous()


def check_kernel_operands(q, k, v):
    B, N, S, H, D = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"evoformer_attention: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, q is "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"evoformer_attention: the kernel takes "
                         f"{KERNEL_DTYPES}, got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"evoformer_attention: head dim {D}; the kernel "
                         f"takes {KERNEL_HEAD_DIMS}")
    if S < 1:
        raise ValueError(f"evoformer_attention: S={S} out of range")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(4) != 1:
            raise ValueError(f"evoformer_attention: {name} needs a "
                             f"contiguous last dim")


def _launch(q, k, v, mask, pair, sm_scale):
    check_kernel_operands(q, k, v)
    if q.dtype != torch.float32:
        q, k, v = (t if _kernel_layout_ok(t) else t.contiguous()
                   for t in (q, k, v))
    B, N, S, H, D = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    mask = _kernel_bias(mask, q.dtype, pair=False)
    pair = _kernel_bias(pair, q.dtype, pair=True)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:4]]
    code = op_builder.dtype_code
    rc = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if pair is None else pair.data_ptr(), B, N, S, H, D,
        (ctypes.c_longlong * 16)(*strides),
        *(_bias_strides(mask, 2) if mask is not None else (0, 0)),
        *(_bias_strides(pair, 2) if pair is not None else (0, 0)),
        code(mask.dtype) if mask is not None else 0,
        code(pair.dtype) if pair is not None else 0,
        float(sm_scale), code(q.dtype), op_builder.stream_ptr(q.device))
    op_builder.check(rc, "evoformer_attention")
    op_builder.LAUNCHES["evoformer_attention"] += 1
    return out


class _Evoformer(torch.autograd.Function):
    """out = evoformer(q, k, v, mask, pair); q/k/v [B, N, S, H, D], mask
    [Bm, Nm, S] or None, pair [Bp, Hp, S, S] or None."""

    @staticmethod
    def forward(ctx, q, k, v, mask, pair, sm_scale):
        if q.device.type == "cpu":
            out = _reference_fwd(q, k, v, mask, pair, sm_scale)
        elif q.is_cuda:
            out = _launch(q, k, v, mask, pair, sm_scale)
        else:
            raise ValueError(f"evoformer_attention: unsupported device "
                             f"{q.device}")
        ctx.save_for_backward(q, k, v, mask, pair)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, mask, pair = ctx.saved_tensors
        dq, dk, dv, dmask, dpair = _backward(q, k, v, mask, pair, g,
                                             ctx.sm_scale)
        return dq, dk, dv, dmask, dpair, None


def evoformer_attention(q, k, v, biases=(), sm_scale=None):
    """Biased attention for Evoformer-style models; q, k, v [B, N, S, H, D],
    `biases` at most one mask [B, N, 1, 1, S] and one pair [B, 1, H, S, S].
    Returns [B, N, S, H, D]."""
    B, N, S, H, D = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    mask, pair = _parse_biases(biases, B, N, S, H)
    return _Evoformer.apply(q, k, v, mask, pair, float(sm_scale))
