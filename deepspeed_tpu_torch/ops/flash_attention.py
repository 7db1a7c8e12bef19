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
    out = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, dim=-1), vh)
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


def _strides(*tensors):
    """(batch, head, time) element strides of [B, H, T, D] views, padded to
    the 18 entries the backward kernels read."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * max(18, len(flat)))(*flat)


def check_kernel_operands(q, k, v, extra=()):
    """Raise ValueError for what the kernels do not take. q/k/v (and the
    `extra` (name, tensor) pairs, shaped like q) are [B, H, T, D] views."""
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    for name, t, shape in [("k", k, (B, Hkv, T, D)), ("v", v, (B, Hkv, T, D))] \
            + [(n, t, (B, H, T, D)) for n, t in extra]:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention: {name} shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads over {Hkv} kv "
                         f"heads")
    if str(q.dtype).replace("torch.", "") not in FLASH_DTYPES:
        raise ValueError(f"flash_attention: the kernels take {FLASH_DTYPES}, "
                         f"got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D}; the kernels take "
                         f"{KERNEL_HEAD_DIMS}")
    if T < 1 or B * H > 65535:
        raise ValueError(f"flash_attention: T={T}, B*H={B * H} out of range")
    for name, t in [("q", q), ("k", k), ("v", v), *extra]:
        if not _kernel_layout_ok(t):
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"last dim, strides in multiples of 8 and a "
                             f"16-byte aligned base")


def _kernel_layout_ok(t):
    return t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _launch_fwd(qh, kh, vh, sm_scale, causal):
    """out [B, H, T, D] view of a [B, T, H, D] tensor, lse [B, H, T]."""
    check_kernel_operands(qh, kh, vh)
    B, H, T, D = qh.shape
    oh = torch.empty((B, T, H, D), dtype=qh.dtype,
                     device=qh.device).transpose(1, 2)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=qh.device)
    rc = _kernel("flash_fwd", "dstt_flash_fwd")(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), oh.data_ptr(),
        lse.data_ptr(), B, H, kh.shape[1], T, D, _strides(qh, kh, vh, oh),
        float(sm_scale), int(bool(causal)), op_builder.dtype_code(qh.dtype),
        op_builder.stream_ptr(qh.device))
    op_builder.check(rc, "flash_attention")
    op_builder.LAUNCHES["flash_attention"] += 1
    return oh, lse


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
    """(out, lse) = flash(q, k, v), all [B, H, T, D] views."""

    @staticmethod
    def forward(ctx, qh, kh, vh, causal, sm_scale):
        if _device_check(qh):
            oh, lse = _launch_fwd(qh, kh, vh, sm_scale, causal)
        else:
            oh, lse = flash_attention_reference(qh, kh, vh, causal, sm_scale,
                                                layout="BHTD")
        ctx.save_for_backward(qh, kh, vh, oh, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return oh, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, doh, dlse):
        qh, kh, vh, oh, lse = ctx.saved_tensors
        if doh is None:
            doh = torch.zeros_like(oh)
        if not _device_check(qh):
            dq, dk, dv = flash_attention_bwd_reference(
                qh, kh, vh, oh, lse, doh, dlse, ctx.causal, ctx.sm_scale,
                layout="BHTD")
            return dq, dk, dv, None, None
        # delta = rowsum(do * o) in fp32 from the saved o, as XLA computes
        # it around the Pallas kernels (`_flash_bwd` :284)
        delta = (doh.float() * oh.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse.float()
        need = ctx.needs_input_grad
        dq, dk, dv = _launch_bwd(qh, kh, vh, doh, lse, delta.contiguous(),
                                 ctx.sm_scale, ctx.causal, need[0],
                                 need[1] or need[2])
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None,
                             layout="BTHD"):
    """(out, lse) flash attention, differentiable in both outputs; lse is
    [B, H, T] fp32 — the statistic ring attention merges per-shard partials
    with."""
    qh, kh, vh = (_to_bhtd(x, layout) for x in (q, k, v))
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(qh.shape[-1])
    oh, lse = _FlashAttention.apply(qh, kh, vh, bool(causal),
                                    float(sm_scale))
    return (oh.transpose(1, 2) if layout == "BTHD" else oh), lse


def flash_attention(q, k, v, causal=True, sm_scale=None, layout="BTHD"):
    """Flash attention. q [B, T, H, D] ("BTHD", the model's layout) or
    [B, H, T, D]; k/v likewise with Hkv heads. Any T."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale, layout)[0]
