"""The PyTorch port's attention kernels, held to the JAX package's Pallas
kernels (run in interpret mode on the CPU, as tests/test_serving.py runs
them).

On a CPU tensor each wrapper of `deepspeed_tpu_torch.ops` runs its kernel's
plain PyTorch version, so these tests hold that plain version — the
numerics the CUDA kernels are checked against on the card by
`chip_smoke.py` — to the TPU kernels on the same numpy inputs.

Tolerance: fp32 on both sides with different summation orders (online
softmax over 128-row tiles vs one materialized softmax): rtol = atol = 2e-5,
the tolerance the JAX package holds its own kernels to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import (decode_attention,
                                                     paged_decode_attention)
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_with_lse
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-5, atol=2e-5)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sm_scale", [None, 1.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 256])
def test_flash_forward_matches_pallas(T, causal, sm_scale):
    rng = np.random.default_rng(T + 7 * causal)
    q, k, v = (_normal(rng, 2, 2, T, 64) for _ in range(3))
    jo, jl = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=sm_scale)
    to, tl = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=sm_scale, layout="BHTD")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_flash_bthd_layout_and_gqa_match_pallas():
    """The model's [B, T, H, D] layout with 2 kv heads for 4 query heads
    equals the Pallas kernel on [B, H, T, D] with the kv heads repeated."""
    rng = np.random.default_rng(3)
    B, T, H, Hkv, D = 2, 128, 4, 2, 64
    q = _normal(rng, B, T, H, D)
    k, v = _normal(rng, B, T, Hkv, D), _normal(rng, B, T, Hkv, D)
    rep = lambda x: np.repeat(x, H // Hkv, axis=2).transpose(0, 2, 1, 3)
    jo, _ = flash_attention_with_lse(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(rep(k)),
        jnp.asarray(rep(v)), causal=True)
    to = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True, layout="BTHD")
    np.testing.assert_allclose(to.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3), **TOL)


@pytest.mark.parametrize("G", [1, 4])
def test_decode_matches_pallas(G):
    rng = np.random.default_rng(10 + G)
    B, Hkv, hd, M = 4, 2, 64, 256
    q = _normal(rng, B, Hkv * G, hd)
    k, v = _normal(rng, B, Hkv, M, hd), _normal(rng, B, Hkv, M, hd)
    pos = np.asarray([0, 5, 130, 255], np.int32)          # ragged prefixes
    jo = decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos))
    to = tda.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(pos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_paged_decode_matches_pallas():
    """The shuffled physical mapping with a row parked on the trash block
    only (tests/test_serving.py's kernel case)."""
    rng = np.random.default_rng(11)
    B, H, Hkv, hd, bm, N = 4, 8, 4, 64, 128, 12
    q = _normal(rng, B, H, hd)
    kp, vp = _normal(rng, N, Hkv, bm, hd), _normal(rng, N, Hkv, bm, hd)
    bt = np.asarray([[7, 2, 10], [1, 9, 4], [3, 5, 8], [0, 0, 0]], np.int32)
    pos = np.asarray([5, 200, 383, 0], np.int32)
    jo = paged_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(bt),
                                    jnp.asarray(pos))
    to = tda.paged_decode_attention(*(torch.from_numpy(a)
                                      for a in (q, kp, vp, bt, pos)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)



# ----------------------------------------------------------------------
# the flash wrappers' host side: what the forward kernel's TMA maps take
# ----------------------------------------------------------------------

def _views(case, dtype=torch.bfloat16):
    """(q, k, v) [B, H, T, D] views of the kinds the kernels take ("fused",
    "fused_gqa", "unit_dims") and refuse (the rest)."""
    B, T, H, D = 2, 40, 4, 64
    fused = torch.zeros(B, T, 3, H, D, dtype=dtype)
    q, k, v = (fused[:, :, i].transpose(1, 2) for i in range(3))
    if case == "fused":
        return q, k, v
    if case == "fused_gqa":
        qkv = torch.zeros(B, T, (H + 2) * D, dtype=dtype)
        q, k, v = qkv.split([H * D, D, D], dim=-1)
        return (q.reshape(B, T, H, D).transpose(1, 2),
                k.reshape(B, T, 1, D).transpose(1, 2),
                v.reshape(B, T, 1, D).transpose(1, 2))
    if case == "unit_dims":                  # extent-1 dims: any stride
        one = torch.zeros(T, D, dtype=dtype)[None, None] \
            .as_strided((1, 1, T, D), (3, 5, D, 1))
        return one, one, one
    if case == "expanded_heads":             # stride 0 over H > 1
        return q, torch.zeros(B, 1, T, D, dtype=dtype).expand(B, H, T, D), v
    if case == "row_stride_not_16_bytes":
        return q, torch.zeros(B, H, T, D + 4, dtype=dtype)[..., :D], v
    if case == "base_not_16_bytes":
        flat = torch.zeros(B * T * H * D + 8, dtype=dtype)
        return q, flat[4:4 + B * T * H * D].reshape(B, T, H, D) \
            .transpose(1, 2), v
    if case == "last_dim_strided":
        return q, torch.zeros(B, H, T, 2 * D, dtype=dtype)[..., ::2], v
    raise ValueError(case)


@pytest.mark.parametrize("case", ["fused", "fused_gqa", "unit_dims"])
def test_flash_operands_tma_describes_pass_the_check(case):
    q, k, v = _views(case)
    assert all(tfa._kernel_layout_ok(t) for t in (q, k, v))
    tfa.check_kernel_operands(q, k, v)


@pytest.mark.parametrize("layout", ["BHTD", "BTHD"])
@pytest.mark.parametrize("case", ["expanded_heads", "row_stride_not_16_bytes",
                                  "base_not_16_bytes", "last_dim_strided"])
def test_flash_views_tma_cannot_describe_are_refused_before_a_launch(
        case, layout, monkeypatch):
    """Handed (as on the card) a view the forward's TMA maps cannot
    describe, flash_attention raises ValueError before any kernel library
    is loaded, with or without gradients, and runs no plain version."""
    from deepspeed_tpu_torch.ops import op_builder

    def refuse(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    def load(name):
        raise AssertionError(f"kernel library {name} requested")

    monkeypatch.setattr(tfa, "_device_check", lambda q: True)
    monkeypatch.setattr(tfa, "flash_attention_reference", refuse)
    monkeypatch.setattr(op_builder, "load", load)
    q, k, v = _views(case)
    assert not all(tfa._kernel_layout_ok(t) for t in (q, k, v))
    if layout == "BTHD":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    for grad in (False, True):
        qq = q.clone().requires_grad_(grad) if grad else q
        with pytest.raises(ValueError, match="positive strides"):
            tfa.flash_attention(qq, k, v, causal=True, layout=layout)


@pytest.mark.parametrize("case, match", [
    ("dtype", "the kernels take"), ("head_dim", "head_dim 32"),
    ("shape", "k shape"), ("heads", "4 query heads over 3"),
    ("device", "k is")])
def test_flash_operand_check_names_what_the_kernels_refuse(case, match):
    q, k, v = _views("fused")
    if case == "dtype":
        q, k, v = (x.float() for x in (q, k, v))
    elif case == "head_dim":
        q, k, v = (x[..., :32] for x in (q, k, v))
    elif case == "shape":
        k = k[:, :, :20]
    elif case == "heads":
        k, v = k[:, :3], v[:, :3]            # 4 query heads over 3
    else:
        k = k.to("meta")
    with pytest.raises(ValueError, match=match):
        tfa.check_kernel_operands(q, k, v)


def test_flash_forward_without_gradients_builds_no_autograd_node():
    """With no input needing a gradient (inference) the wrapper's outputs
    carry no autograd node; they equal the autograd path's."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(_normal(rng, 2, 64, 4, 64))
               for _ in range(3))
    plain_out, plain_lse = tfa.flash_attention_with_lse(q, k, v)
    assert plain_out.grad_fn is None and plain_lse.grad_fn is None
    qg = q.clone().requires_grad_(True)
    out, lse = tfa.flash_attention_with_lse(qg, k, v)
    assert out.grad_fn is not None
    torch.testing.assert_close(plain_out, out.detach(), rtol=0, atol=0)
    torch.testing.assert_close(plain_lse, lse.detach(), rtol=0, atol=0)
    with torch.no_grad():
        nog, _ = tfa.flash_attention_with_lse(qg, k, v)
    assert nog.grad_fn is None
    torch.testing.assert_close(nog, plain_out, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["fused", "fused_gqa"])
def test_flash_inference_launch_reads_the_callers_layout(case, monkeypatch):
    """The [B, T, H, D] call hands the kernel the same dims and (batch,
    head, time) strides as the [B, H, T, D] views of the same memory (the
    kernel reads the caller's tensors in place), and returns out as a
    [B, T, H, D] tensor of its own."""
    from deepspeed_tpu_torch.ops import op_builder
    calls = []
    monkeypatch.setattr(tfa, "_kernel", lambda source, symbol:
                        lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(tfa, "_device_check", lambda q: True)
    monkeypatch.setattr(op_builder, "stream_ptr", lambda device: None)
    qh, kh, vh = _views(case)
    q, k, v = (x.transpose(1, 2) for x in (qh, kh, vh))
    out, lse = tfa.flash_attention_with_lse(q, k, v, causal=True)
    bthd = calls[-1]
    tfa.flash_attention_with_lse(qh, kh, vh, causal=True, layout="BHTD")
    bhtd = calls[-1]
    assert bthd[5:10] == bhtd[5:10]                  # B, H, Hkv, T, D
    assert list(bthd[10])[:9] == list(bhtd[10])[:9]  # q, k, v strides
    assert list(bthd[10])[:9] == [s for x in (q, k, v)
                                  for s in (x.stride(0), x.stride(2),
                                            x.stride(1))]
    assert out.shape == q.shape and out.is_contiguous()
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])


@pytest.mark.parametrize("layout", ["BTHD", "BHTD"])
def test_flash_kernel_route_keeps_the_callers_layout_in_both_passes(
        layout, monkeypatch):
    """The kernel route (as on the card, with the launches replaced by the
    plain versions in [B, H, T, D]) takes q/k/v in the caller's layout,
    hands the backward launch [B, H, T, D] views, and returns out and
    every gradient in the caller's layout, equal to the plain route's."""
    rng = np.random.default_rng(11)
    B, T, H, Hkv, D = 2, 48, 4, 2, 64
    shape = (lambda h: (B, T, h, D)) if layout == "BTHD" \
        else (lambda h: (B, h, T, D))
    q, k, v = (torch.from_numpy(_normal(rng, *shape(h)))
               for h in (H, Hkv, Hkv))
    do = torch.from_numpy(_normal(rng, *shape(H)))
    dlse = torch.from_numpy(_normal(rng, B, H, T))

    def grads(route):
        qs, ks, vs = (x.clone().requires_grad_(True) for x in (q, k, v))
        out, lse = route(qs, ks, vs)
        torch.autograd.backward((out, lse), (do, dlse))
        return out.detach(), lse.detach(), qs.grad, ks.grad, vs.grad

    want = grads(lambda *a: tfa.flash_attention_with_lse(*a, layout=layout))

    def launch_fwd(q, k, v, sm_scale, causal, lay):
        assert lay == layout
        return tfa.flash_attention_reference(q, k, v, causal, sm_scale,
                                             layout=lay)

    def launch_bwd(qh, kh, vh, doh, lse, delta, sm_scale, causal, need_dq,
                   need_dkv):
        assert qh.shape == (B, H, T, D) and kh.shape == (B, Hkv, T, D)
        assert doh.shape == qh.shape and delta.shape == (B, H, T)
        # the plain backward on the wrapper's delta (dlse folded in): a
        # zero out and -delta as the lse cotangent give delta back
        return tfa.flash_attention_bwd_reference(
            qh, kh, vh, torch.zeros_like(qh), lse, doh, -delta, causal,
            sm_scale, layout="BHTD")

    monkeypatch.setattr(tfa, "_device_check", lambda q: True)
    monkeypatch.setattr(tfa, "_launch_fwd", launch_fwd)
    monkeypatch.setattr(tfa, "_launch_bwd", launch_bwd)
    got = grads(lambda *a: tfa.flash_attention_with_lse(*a, layout=layout))
    for w, g in zip(want, got):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
