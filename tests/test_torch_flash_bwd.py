"""The PyTorch port's flash-attention backward held to the JAX package's
Pallas backward kernels (`_bwd_dq_kernel`, `_bwd_dkv_kernel`, run in
interpret mode on the CPU, as tests/test_torch_kernels.py runs the forward).

On CPU tensors the port's autograd function runs the plain forward and the
plain backward (`flash_attention_bwd_reference`) — the numerics the CUDA
kernels (`ops/csrc/flash_bwd.cu`) are checked against on the card by
`chip_smoke.py`. The JAX side is `jax.vjp` of `flash_attention_with_lse`,
whose custom VJP is the pair of Pallas kernels.

Tolerance: fp32 on both sides with different summation orders (the Pallas
kernels sum dq / dk / dv over 128-row tiles, the plain version in one
einsum): rtol = atol = 1e-4 on gradients whose entries reach ~10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_with_lse
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.ops import op_builder

TOL = dict(rtol=1e-4, atol=1e-4)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _port_grads(q, k, v, do, dlse, causal, sm_scale, layout):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                            sm_scale=sm_scale, layout=layout)
    outputs, cots = [out], [torch.from_numpy(do)]
    if dlse is not None:
        outputs.append(lse)
        cots.append(torch.from_numpy(dlse))
    return [g.numpy() for g in torch.autograd.grad(outputs, (tq, tk, tv),
                                                   cots)]


def _jax_grads(fn, q, k, v, do, dlse):
    (out, lse), vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v))
    dl = jnp.zeros_like(lse) if dlse is None else jnp.asarray(dlse)
    return [np.asarray(g) for g in vjp((jnp.asarray(do), dl))]


@pytest.mark.parametrize("sm_scale", [None, 1.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [128, 256])
def test_flash_backward_matches_pallas_vjp(T, causal, sm_scale):
    rng = np.random.default_rng(T + 3 * causal + 5 * (sm_scale is None))
    q, k, v, do = (_normal(rng, 2, 2, T, 64) for _ in range(4))
    want = _jax_grads(lambda a, b, c: flash_attention_with_lse(
        a, b, c, causal=causal, sm_scale=sm_scale), q, k, v, do, None)
    got = _port_grads(q, k, v, do, None, causal, sm_scale, "BHTD")
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_folds_the_lse_cotangent_like_pallas(causal):
    """A nonzero lse cotangent enters as delta' = delta - dlse, as
    `_flash_lse_vjp_bwd` folds it (ring attention's backward needs it)."""
    rng = np.random.default_rng(20 + causal)
    q, k, v, do = (_normal(rng, 2, 2, 128, 64) for _ in range(4))
    dlse = _normal(rng, 2, 2, 128)
    want = _jax_grads(lambda a, b, c: flash_attention_with_lse(
        a, b, c, causal=causal), q, k, v, do, dlse)
    got = _port_grads(q, k, v, do, dlse, causal, None, "BHTD")
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_flash_backward_gqa_sums_over_the_group_like_repeated_kv():
    """2 kv heads for 4 query heads in the model's [B, T, H, D] layout: the
    port's dk / dv [B, T, Hkv, D] equal the JAX kernel's on repeated k / v,
    summed by `jnp.repeat`'s transpose; with an lse cotangent."""
    rng = np.random.default_rng(30)
    B, T, H, Hkv, D = 2, 128, 4, 2, 64
    q, do = _normal(rng, B, T, H, D), _normal(rng, B, T, H, D)
    k, v = _normal(rng, B, T, Hkv, D), _normal(rng, B, T, Hkv, D)
    dlse = _normal(rng, B, H, T)
    bhtd = lambda x: jnp.swapaxes(x, 1, 2)

    def jax_fn(a, b, c):
        out, lse = flash_attention_with_lse(
            bhtd(a), jnp.repeat(bhtd(b), H // Hkv, axis=1),
            jnp.repeat(bhtd(c), H // Hkv, axis=1), causal=True)
        return bhtd(out), lse

    want = _jax_grads(jax_fn, q, k, v, do, dlse)
    got = _port_grads(q, k, v, do, dlse, True, None, "BTHD")
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_cpu_autograd_runs_the_plain_backward_and_launches_nothing():
    """Tensors that require grad go through the autograd function on the
    CPU too: its backward is `flash_attention_bwd_reference` on the saved
    (out, lse), bit for bit, and no kernel is built or launched."""
    rng = np.random.default_rng(31)
    q, k, v, do = (torch.from_numpy(_normal(rng, 1, 37, 4, 64))
                   for _ in range(4))
    op_builder.LAUNCHES.clear()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, lse = tfa.flash_attention_with_lse(*leaves)
    got = torch.autograd.grad(out, leaves, do)
    want = tfa.flash_attention_bwd_reference(q, k, v, out.detach(),
                                             lse.detach(), do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sum(op_builder.LAUNCHES.values()) == 0
