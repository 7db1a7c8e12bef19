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

