"""Flash attention, forward and backward (counterpart of
`deepspeed_tpu/ops/pallas/flash_attention.py`).

Online softmax over streamed K/V tiles with fp32 statistics; returns the
output and, through `flash_attention_with_lse`, the row log-sum-exp that
ring attention combines partials with. Layouts: "BTHD" ([B, T, H, D], the
model's) or "BHTD". GQA: k/v may carry Hkv heads with H a multiple of Hkv.

Both entry points are differentiable through one `torch.autograd.Function`
(the port of `_flash` / `_flash_lse` and their `custom_vjp`s): the forward
saves (q, k, v, out, lse) and the backward recomputes the probabilities
from lse. An lse cotangent folds in as delta' = delta - dlse, as
`_flash_lse_vjp_bwd` does. On a CUDA tensor every pass launches its
hand-written kernel (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`: bf16/fp16,
head_dim 64/128, any T) or raises; on a CPU tensor it runs the plain
version (`flash_attention_reference`, `flash_attention_bwd_reference`).
"""

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.attention_dispatch import (FLASH_DTYPES,
                                                        KERNEL_HEAD_DIMS)
from deepspeed_tpu_torch.utils.checkpoint_names import checkpoint_name

NEG_INF = -1e30


def _to_bhtd(x, layout):
    if layout == "BTHD":
        return x.transpose(1, 2)
    if layout == "BHTD":
        return x
    raise ValueError(f"unknown layout {layout!r} (expected BTHD or BHTD)")


def _repeat_kv(kh, vh, H):
    if kh.shape[1] == H:
        return kh, vh
    rep = H // kh.shape[1]
    return kh.repeat_interleave(rep, dim=1), vh.repeat_interleave(rep, dim=1)


def _scores(qh, kh, causal, sm_scale):
    """fp32 [B, H, T, S] scaled scores, causal entries at NEG_INF."""
    s = torch.einsum("bhtd,bhsd->bhts", qh, kh) * sm_scale
    if causal:
        T, S = s.shape[-2:]
        mask = torch.ones(T, S, dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_reference(q, k, v, causal=True, sm_scale=None,
                              layout="BTHD"):
    """Plain version: fp32 materialized attention. Returns (out in q's
    dtype and layout, lse [B, H, T] fp32)."""
    qh, kh, vh = (_to_bhtd(x, layout).float() for x in (q, k, v))
    kh, vh = _repeat_kv(kh, vh, qh.shape[1])
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(qh.shape[-1])
    s = _scores(qh, kh, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    with checkpoint_name("attn_probs"):     # save_matmuls_probs keeps it
        probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", probs, vh)
    if layout == "BTHD":
        out = out.transpose(1, 2)
    return out.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, out, lse, dout, dlse=None,
                                  causal=True, sm_scale=None, layout="BTHD"):
    """Plain version of the backward: the materialized fp32 softmax
    backward from the saved (out, lse), with the lse cotangent folded into
    delta and dk/dv summed over each kv head's query-head group. Returns
    (dq, dk, dv) in the inputs' dtypes and layout."""
    qh, kh, vh, oh, doh = (_to_bhtd(x, layout).float()
                           for x in (q, k, v, out, dout))
    H, Hkv = qh.shape[1], kh.shape[1]
    kr, vr = _repeat_kv(kh, vh, H)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(qh.shape[-1])
    p = torch.exp(_scores(qh, kr, causal, sm_scale) - lse.float()[..., None])
    delta = (doh * oh).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    dv = torch.einsum("bhts,bhtd->bhsd", p, doh)
    dp = torch.einsum("bhtd,bhsd->bhts", doh, vr)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kr) * sm_scale
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qh) * sm_scale
    if Hkv != H:
        B, _, S, D = dk.shape
        dk = dk.reshape(B, Hkv, H // Hkv, S, D).sum(2)
        dv = dv.reshape(B, Hkv, H // Hkv, S, D).sum(2)
    if layout == "BTHD":
        dq, dk, dv = (x.transpose(1, 2) for x in (dq, dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------------
# the CUDA kernels
# ----------------------------------------------------------------------

_LL = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = {
    # q, k, v, o, lse | B, H, Hkv, T, D | strides, scale, causal, dtype,
    # stream
    "dstt_flash_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        _LL, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # q, k, v, do, lse, delta, dq | B, H, Hkv, T, D | strides, ...
    "dstt_flash_bwd_dq": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        _LL, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # q, k, v, do, lse, delta, dk, dv | B, H, Hkv, T, D | strides, ...
    "dstt_flash_bwd_dkv": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        _LL, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _kernel(source, symbol):
    fn = getattr(op_builder.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


# where the (batch, head, time) dims sit in each layout's 4-D tensor
_BHT = {"BHTD": (0, 1, 2), "BTHD": (0, 2, 1)}
_STRIDE_ARRAY = ctypes.c_longlong * 18


def _strides(*tensors, layout="BHTD"):
    """(batch, head, time) element strides of up to six tensors in
    `layout`, padded to the 18 entries the backward kernels read."""
    b, h, t = _BHT[layout]
    flat = []
    for x in tensors:
        st = x.stride()
        flat += (st[b], st[h], st[t])
    return _STRIDE_ARRAY(*flat)


_KERNEL_DTYPES = tuple(getattr(torch, name) for name in FLASH_DTYPES)


def check_kernel_operands(q, k, v, extra=(), layout="BHTD"):
    """Raise ValueError for what the kernels do not take. q/k/v (and the
    `extra` (name, tensor) pairs, shaped like q) are 4-D tensors in
    `layout`. Every launch runs it, so it builds no message unless it
    raises."""
    bd, hd, td = _BHT[layout]
    B, H, T, D = q.shape[bd], q.shape[hd], q.shape[td], q.shape[3]
    Hkv = k.shape[hd]
    kv = (B, Hkv, T, D) if layout == "BHTD" else (B, T, Hkv, D)
    for name, t, shape in (("k", k, kv), ("v", v, kv),
                           *((n, t, q.shape) for n, t in extra)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if t.shape != shape:
            raise ValueError(f"flash_attention: {name} shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
    if H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads over {Hkv} kv "
                         f"heads")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash_attention: the kernels take {FLASH_DTYPES}, "
                         f"got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D}; the kernels take "
                         f"{KERNEL_HEAD_DIMS}")
    if T < 1:
        raise ValueError(f"flash_attention: T={T} out of range")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if not _kernel_layout_ok(t):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"last dim, positive strides in multiples of 8 "
                             f"and a 16-byte aligned base")


def _kernel_layout_ok(t):
    """What the kernels' loads take (the forward's TMA maps): a contiguous
    last dim, the other strides positive multiples of 8 elements (16
    bytes) where the dim has more than one entry, a 16-byte aligned
    base. The test is the same in either layout."""
    (s0, s1, s2, s3), (n0, n1, n2, _) = t.stride(), t.shape
    return s3 == 1 and t.data_ptr() % 16 == 0 \
        and (n0 == 1 or (s0 > 0 and s0 % 8 == 0)) \
        and (n1 == 1 or (s1 > 0 and s1 % 8 == 0)) \
        and (n2 == 1 or (s2 > 0 and s2 % 8 == 0))


def _launch_fwd(q, k, v, sm_scale, causal, layout="BHTD"):
    """(out, lse [B, H, T]) of q, k, v in `layout`; out in that layout over
    a [B, T, H, D] tensor. The kernel reads each operand by its strides
    (a fused projection's views in place)."""
    check_kernel_operands(q, k, v, layout=layout)
    bd, hd, td = _BHT[layout]
    B, H, T, D = q.shape[bd], q.shape[hd], q.shape[td], q.shape[3]
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    if layout == "BHTD":
        o = o.transpose(1, 2)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    rc = _kernel("flash_fwd", "dstt_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, H, k.shape[hd], T, D,
        _strides(q, k, v, o, layout=layout), float(sm_scale),
        int(bool(causal)), op_builder.dtype_code(q.dtype),
        op_builder.stream_ptr(q.device))
    op_builder.check(rc, "flash_attention")
    op_builder.LAUNCHES["flash_attention"] += 1
    return o, lse


def _launch_bwd(qh, kh, vh, doh, lse, delta, sm_scale, causal, need_dq,
                need_dkv):
    """(dq, dk, dv) as [B, H, T, D] views of [B, T, H, D] tensors (None
    where not needed). `do` that the kernel cannot read in place is made
    contiguous first (one copy of [B, T, H, D])."""
    if not _kernel_layout_ok(doh):
        doh = doh.transpose(1, 2).contiguous().transpose(1, 2)
    check_kernel_operands(qh, kh, vh, extra=[("do", doh)])
    B, H, T, D = qh.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, T) or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.device != qh.device:
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"contiguous fp32 [B, H, T] = {(B, H, T)} "
                             f"tensor on {qh.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    Hkv = kh.shape[1]
    args = (B, H, Hkv, T, D)
    tail = (float(sm_scale), int(bool(causal)),
            op_builder.dtype_code(qh.dtype), op_builder.stream_ptr(qh.device))
    new = lambda h: torch.empty((B, T, h, D), dtype=qh.dtype,
                                device=qh.device).transpose(1, 2)
    dq = dk = dv = None
    if need_dq:
        dq = new(H)
        rc = _kernel("flash_bwd", "dstt_flash_bwd_dq")(
            qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *args,
            _strides(qh, kh, vh, doh, dq), *tail)
        op_builder.check(rc, "flash_attention backward (dq)")
        op_builder.LAUNCHES["flash_attention_bwd_dq"] += 1
    if need_dkv:
        dk, dv = new(Hkv), new(Hkv)
        rc = _kernel("flash_bwd", "dstt_flash_bwd_dkv")(
            qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), doh.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *args, _strides(qh, kh, vh, doh, dk, dv), *tail)
        op_builder.check(rc, "flash_attention backward (dk/dv)")
        op_builder.LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dq, dk, dv


def _device_check(q):
    if q.device.type == "cpu":
        return False
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return True


class _FlashAttention(torch.autograd.Function):
    """(out, lse) = flash(q, k, v), q / k / v / out in `layout`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, layout):
        if _device_check(q):
            o, lse = _launch_fwd(q, k, v, sm_scale, causal, layout)
        else:
            o, lse = flash_attention_reference(q, k, v, causal, sm_scale,
                                               layout=layout)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale, ctx.layout = causal, sm_scale, layout
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if not _device_check(q):
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, o, lse, do, dlse, ctx.causal, ctx.sm_scale,
                layout=ctx.layout)
            return dq, dk, dv, None, None, None
        qh, kh, vh, oh, doh = (_to_bhtd(x, ctx.layout)
                               for x in (q, k, v, o, do))
        # delta = rowsum(do * o) in fp32 from the saved o, as XLA computes
        # it around the Pallas kernels (`_flash_bwd` :284)
        delta = (doh.float() * oh.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        need = ctx.needs_input_grad
        grads = _launch_bwd(qh, kh, vh, doh, lse, delta.contiguous(),
                            ctx.sm_scale, ctx.causal, need[0],
                            need[1] or need[2])
        if ctx.layout == "BTHD":
            grads = (None if g is None else g.transpose(1, 2) for g in grads)
        return (*grads, None, None, None)


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None,
                             layout="BTHD"):
    """(out, lse) flash attention, differentiable in both outputs; lse is
    [B, H, T] fp32 — the statistic ring attention merges per-shard partials
    with."""
    if layout not in _BHT:
        raise ValueError(f"unknown layout {layout!r} (expected BTHD or "
                         f"BHTD)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale),
                                 layout)


def flash_attention(q, k, v, causal=True, sm_scale=None, layout="BTHD"):
    """Flash attention. q [B, T, H, D] ("BTHD", the model's layout) or
    [B, H, T, D]; k/v likewise with Hkv heads. Any T."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale, layout)[0]
