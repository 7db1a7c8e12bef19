"""Flash attention, forward (counterpart of
`deepspeed_tpu/ops/pallas/flash_attention.py`).

Online softmax over streamed K/V tiles with fp32 statistics; returns the
output and, through `flash_attention_with_lse`, the row log-sum-exp that
ring attention combines partials with. Layouts: "BTHD" ([B, T, H, D], the
model's) or "BHTD". GQA: k/v may carry Hkv heads with H a multiple of Hkv.

On a CUDA tensor the wrappers launch the hand-written kernel
(`csrc/flash_fwd.cu`, bf16/fp16, head_dim 64/128, any T); on a CPU tensor
they run the plain version. There is no backward kernel yet: CUDA inputs
that require grad raise.
"""

import ctypes
import math

import torch

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


def flash_attention_reference(q, k, v, causal=True, sm_scale=None,
                              layout="BTHD"):
    """Plain version: fp32 materialized attention. Returns (out in q's
    dtype and layout, lse [B, H, T] fp32)."""
    qh, kh, vh = (_to_bhtd(x, layout).float() for x in (q, k, v))
    B, H, T, D = qh.shape
    if kh.shape[1] != H:
        rep = H // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bhtd,bhsd->bhts", qh, kh) * sm_scale
    if causal:
        mask = torch.ones(T, kh.shape[2], dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, dim=-1), vh)
    if layout == "BTHD":
        out = out.transpose(1, 2)
    return out.to(q.dtype), lse


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def _kernel():
    fn = op_builder.load("flash_fwd").dstt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, causal, sm_scale, layout):
    qh, kh, vh = (_to_bhtd(x, layout) for x in (q, k, v))
    B, H, T, D = qh.shape
    Hkv = kh.shape[1]
    for name, t in (("k", kh), ("v", vh)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if t.shape != (B, Hkv, T, D):
            raise ValueError(f"flash_attention: {name} shape "
                             f"{tuple(t.shape)}, expected {(B, Hkv, T, D)}")
    if H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads over {Hkv} kv "
                         f"heads")
    if str(q.dtype).replace("torch.", "") not in FLASH_DTYPES:
        raise ValueError(f"flash_attention: the kernel takes {FLASH_DTYPES}, "
                         f"got {q.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D}; the kernel takes "
                         f"{KERNEL_HEAD_DIMS}")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("flash_attention: the backward kernels are "
                                  "not ported yet")
    if T < 1 or B * H > 65535:
        raise ValueError(f"flash_attention: T={T}, B*H={B * H} out of range")
    for name, t in (("q", qh), ("k", kh), ("v", vh)):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             f"last dim, strides in multiples of 8 and a "
                             f"16-byte aligned base")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    oh = _to_bhtd(out, layout)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (qh, kh, vh, oh) for s in t.stride()[:3]))
    rc = _kernel()(qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), oh.data_ptr(),
                   lse.data_ptr(), B, H, Hkv, T, D, strides, float(sm_scale),
                   int(bool(causal)), op_builder.dtype_code(q.dtype),
                   op_builder.stream_ptr(q.device))
    op_builder.check(rc, "flash_attention")
    op_builder.LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_attention_with_lse(q, k, v, causal=True, sm_scale=None,
                             layout="BTHD"):
    """(out, lse) flash attention; lse is [B, H, T] fp32 — the statistic
    ring attention merges per-shard partials with."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, sm_scale, layout)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, causal, sm_scale, layout)


def flash_attention(q, k, v, causal=True, sm_scale=None, layout="BTHD"):
    """Flash attention. q [B, T, H, D] ("BTHD", the model's layout) or
    [B, H, T, D]; k/v likewise with Hkv heads. Any T."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale, layout)[0]
