"""The PyTorch port's Evoformer attention held to the JAX package's
`evoformer_attention`: no bias, the key-mask bias, the pair bias, both,
broadcast biases, the triangle-attention pattern, the q / k / v / mask /
pair gradients, and the bad-shape and duplicate refusals — the cases of
tests/test_evoformer.py.

Inputs come from numpy seeds. The JAX op runs its Pallas forward in
interpret mode on the CPU (its backward is jnp); the port runs its kernel's
plain version (`csrc/evoformer_attn.cu` is checked against it on the card
by chip_smoke.py) and its plain backward. Everything is fp32: outputs and
gradients at rtol = atol = 2e-5 (the two sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.evoformer_attn import \
    evoformer_attention as jax_evoformer
from deepspeed_tpu_torch.ops import evoformer_attn as tevo
from deepspeed_tpu_torch.ops import op_builder

TOL = dict(rtol=2e-5, atol=2e-5)
B, N, S, H, D = 1, 3, 16, 2, 8


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _mask(shape, seed):
    return np.where(_rand(shape, seed) > 0, 0.0, -1e9).astype(np.float32)


def _qkv(seed=0, shape=(B, N, S, H, D)):
    return tuple(_rand(shape, seed + i) for i in range(3))


BIAS_CASES = {
    "none": lambda: [],
    "mask": lambda: [_mask((B, N, 1, 1, S), 3)],
    "pair": lambda: [_rand((B, 1, H, S, S), 4)],
    "both": lambda: [_mask((B, N, 1, 1, S), 5), _rand((B, 1, H, S, S), 6)],
    "pair_then_mask": lambda: [_rand((B, 1, H, S, S), 7),
                               _mask((B, N, 1, 1, S), 8)],
}


@pytest.mark.parametrize("case", list(BIAS_CASES))
def test_forward_matches_jax(case):
    q, k, v = _qkv()
    biases = BIAS_CASES[case]()
    want = jax_evoformer(*map(jnp.asarray, (q, k, v)),
                         biases=[jnp.asarray(b) for b in biases])
    op_builder.LAUNCHES.clear()
    got = tevo.evoformer_attention(
        *map(torch.from_numpy, (q, k, v)),
        biases=[torch.from_numpy(b) for b in biases])
    assert sum(op_builder.LAUNCHES.values()) == 0
    assert got.shape == (B, N, S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_reference_is_the_plain_version():
    q, k, v = _qkv(1)
    biases = [torch.from_numpy(b) for b in BIAS_CASES["both"]()]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    torch.testing.assert_close(
        tevo.evoformer_attention(tq, tk, tv, biases=biases),
        tevo.evoformer_attention_reference(tq, tk, tv, biases=biases),
        rtol=0, atol=0)


@pytest.mark.parametrize("shapes", [
    ((2, N, 1, 1, S), (2, 1, H, S, S)),        # full
    ((1, N, 1, 1, S), (1, 1, H, S, S)),        # shared over the batch
    ((2, 1, 1, 1, S), (2, 1, 1, S, S)),        # over rows / heads
], ids=["full", "batch-broadcast", "row-head-broadcast"])
def test_gradients_match_jax(shapes):
    """dq, dk, dv, dmask and dpair against jax.grad; broadcast biases get
    their gradients summed back to their own shapes."""
    q, k, v = _qkv(9, (2, N, S, H, D))
    mask = _rand(shapes[0], 11)
    pair = _rand(shapes[1], 12)
    g = _rand((2, N, S, H, D), 13)

    def f(q, k, v, m, p):
        return jnp.sum(jax_evoformer(q, k, v, biases=[m, p]) * g)
    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (q, k, v, mask, pair)))
    ins = [torch.from_numpy(x).requires_grad_(True)
           for x in (q, k, v, mask, pair)]
    out = tevo.evoformer_attention(*ins[:3], biases=ins[3:])
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for name, a, w in zip(("q", "k", "v", "mask", "pair"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_mask_only_gradient_matches_jax():
    q, k, v = _qkv(14)
    mask = _rand((B, N, 1, 1, S), 15)

    def f(m):
        return jnp.sum(jax_evoformer(*map(jnp.asarray, (q, k, v)),
                                     biases=[m]) ** 2)
    want = jax.grad(f)(jnp.asarray(mask))
    tm = torch.from_numpy(mask).requires_grad_(True)
    out = tevo.evoformer_attention(*map(torch.from_numpy, (q, k, v)),
                                   biases=[tm])
    got, = torch.autograd.grad((out ** 2).sum(), tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_triangle_attention_pattern():
    """Triangle attention on a pair activation [B, I, I, H, D]: rows of the
    pair matrix attend along J with a per-head triangle bias — the N = I
    case of the op."""
    Bt, I, Ht, Dt = 1, 4, 2, 8
    q, k, v = (_rand((Bt, I, I, Ht, Dt), 21 + i) for i in range(3))
    tri = _rand((Bt, 1, Ht, I, I), 24)
    want = jax_evoformer(*map(jnp.asarray, (q, k, v)),
                         biases=[jnp.asarray(tri)])
    got = tevo.evoformer_attention(*map(torch.from_numpy, (q, k, v)),
                                   biases=[torch.from_numpy(tri)])
    assert got.shape == (Bt, I, I, Ht, Dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("biases,match", [
    ([(B, N, H, S, S)], "unsupported bias shape"),
    ([(B, N, S, S)], "5-D"),
    ([(B, N, 1, 1, S), (B, N, 1, 1, S)], "duplicate mask"),
    ([(B, 1, H, S, S), (B, 1, H, S, S)], "duplicate pair"),
], ids=["full-bias", "4-d", "two-masks", "two-pairs"])
def test_refuses_what_jax_refuses(biases, match):
    q, k, v = _qkv(30)
    arrays = [_rand(s, 31 + i) for i, s in enumerate(biases)]
    with pytest.raises(ValueError, match=match):
        jax_evoformer(*map(jnp.asarray, (q, k, v)),
                      biases=[jnp.asarray(a) for a in arrays])
    with pytest.raises(ValueError, match=match):
        tevo.evoformer_attention(*map(torch.from_numpy, (q, k, v)),
                                 biases=[torch.from_numpy(a) for a in arrays])


def test_refuses_a_bias_that_does_not_broadcast():
    q, k, v = _qkv(40)
    with pytest.raises(ValueError, match="broadcast"):
        tevo.evoformer_attention(*map(torch.from_numpy, (q, k, v)), biases=[
            torch.zeros(B, N + 1, 1, 1, S)])
