"""The port's chunked-vocab cross entropy held to the JAX package's: the op's
nll and gradients against `jax.grad` of `deepspeed_tpu.ops.chunked_ce`, and
`gpt_loss` with `loss_chunks` against JAX's and against the port's own
unchunked loss. Inputs come from numpy seeds; weights move with
`params_from_jax`.

Tolerances: fp32 on both sides within 1e-5 (XLA and PyTorch's CPU kernels
sum in other orders). bf16 inputs: nll within 1e-2 and gradients within
2 bf16 steps of the largest entry (2^-7 x max|g|): both sides compute the
chunk logits in fp32 from the bf16 operands and round the chunk's
(p - onehot) · g to bf16 once before the gradient products, so they differ
by the rounding of values whose fp32 sums differ in order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.chunked_ce import chunked_softmax_xent as jxent
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops.chunked_ce import (chunk_width,
                                                chunked_softmax_xent)
from deepspeed_tpu_torch.utils.tree import tree_leaves

BF16_NLL_TOL = 1e-2
BF16_GRAD_STEPS = 2 ** -7


def _case(seed, N, D, V):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, D)).astype(np.float32)
    w = rng.normal(0, 0.5, (V, D)).astype(np.float32)
    labels = rng.integers(0, V, (N,)).astype(np.int32)
    labels[rng.random(N) < 0.2] = -1
    labels[0] = V - 1                      # a label in the last chunk
    return x, w, labels


def _jax(x, w, labels, n, dtype):
    mask = jnp.asarray(labels >= 0, jnp.float32)
    g = jnp.asarray(np.linspace(0.5, 1.5, len(labels)), jnp.float32) * mask

    def f(x, w):
        return (jxent(x, w, jnp.asarray(labels), n) * g).sum()
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    nll = jxent(xj, wj, jnp.asarray(labels), n)
    dx, dw = jax.grad(f, argnums=(0, 1))(xj, wj)
    return (np.asarray(nll), np.asarray(dx, np.float32),
            np.asarray(dw, np.float32), np.array(g))


def _port(x, w, labels, n, dtype, g):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    nll = chunked_softmax_xent(xt, wt, torch.from_numpy(labels), n)
    dx, dw = torch.autograd.grad((nll * torch.from_numpy(g)).sum(),
                                 (xt, wt))
    assert nll.dtype == torch.float32
    assert dx.dtype == dw.dtype == dtype
    return nll.detach().numpy(), dx.float().numpy(), dw.float().numpy()


@pytest.mark.parametrize("N,V,n", [(47, 1000, 3), (33, 1024, 4),
                                   (31, 1000, 1), (21, 300, 8)],
                         ids=["padded", "unpadded", "one-chunk",
                              "empty-chunks"])
def test_nll_and_gradients_match_jax_fp32(N, V, n):
    """V 1000 at 3 chunks: 3 x 384, the last holding 232 real columns
    (JAX pads and masks, the port slices); V 1024 at 4: 4 x 256 exactly;
    V 300 at 8: 8 x 128, of which the last five hold no real column. N
    odd, a fifth of the labels -1, a weighted cotangent."""
    x, w, labels = _case(N, N, 64, V)
    nll_j, dx_j, dw_j, g = _jax(x, w, labels, n, jnp.float32)
    nll, dx, dw = _port(x, w, labels, n, torch.float32, g)
    np.testing.assert_allclose(nll, nll_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dx, dx_j, atol=1e-5, rtol=0)
    np.testing.assert_allclose(dw, dw_j, atol=1e-5, rtol=0)


def test_nll_and_gradients_match_jax_bf16():
    x, w, labels = _case(5, 47, 64, 1000)
    nll_j, dx_j, dw_j, g = _jax(x, w, labels, 3, jnp.bfloat16)
    nll, dx, dw = _port(x, w, labels, 3, torch.bfloat16, g)
    np.testing.assert_allclose(nll, nll_j, atol=BF16_NLL_TOL, rtol=0)
    for name, a, b in (("dx", dx, dx_j), ("dw", dw, dw_j)):
        tol = BF16_GRAD_STEPS * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max(), tol)


def test_chunk_width_is_the_jax_padding():
    from deepspeed_tpu.ops.chunked_ce import _pad_rows
    for V, n in ((50304, 8), (1000, 3), (1024, 4), (300, 8), (50304, 12)):
        _, per, _ = _pad_rows(jnp.zeros((V, 1)), n)
        assert chunk_width(V, n) == per
    assert chunk_width(50304, 8) == 6400


def _cfgs(**flags):
    jcfg = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=64,
                          vocab_size=1000, dtype=jnp.float32, **flags)
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name != "dtype"]
    pcfg = tgpt.GPTConfig(dtype="float32",
                          **{k: getattr(jcfg, k) for k in names})
    return jcfg, pcfg


@pytest.mark.parametrize("tie", [True, False], ids=["tied", "lm_head"])
def test_gpt_loss_with_loss_chunks_matches_jax(tie):
    """`gpt_loss` with loss_chunks 4 on a 2-layer model: the loss and every
    gradient leaf against `jax.value_and_grad` of JAX's, within 1e-5, and
    against the port's own loss_chunks 0."""
    from deepspeed_tpu.comm import mesh as mesh_mod
    mesh_mod.clear_mesh()
    jcfg, pcfg = _cfgs(loss_chunks=4, tie_embeddings=tie)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jgpt.init_gpt_params(jcfg, seed=3))
    toks = np.random.default_rng(4).integers(0, 1000, (3, 18)) \
        .astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, :4] = -100
    batch = {"input_ids": toks[:, :-1], "labels": labels}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, None,
                                jcfg))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, grads = {}, {}
    for chunks in (4, 0):
        params = tgpt.params_from_jax(np_params)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        loss = tgpt.gpt_loss(params, tb,
                             cfg=dataclasses.replace(pcfg,
                                                     loss_chunks=chunks))
        losses[chunks] = float(loss.detach())
        grads[chunks] = torch.autograd.grad(loss, leaves)
    assert losses[4] == pytest.approx(float(jloss), abs=1e-5)
    assert losses[4] == pytest.approx(losses[0], abs=1e-5)
    for a, b, c in zip(grads[4], jax.tree_util.tree_leaves(jgrads),
                       grads[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5, rtol=0)
    mesh_mod.clear_mesh()


def test_gpt_loss_with_loss_chunks_refuses_a_tied_head_bias():
    _, pcfg = _cfgs(loss_chunks=2)
    params = tgpt.init_gpt_params(pcfg, seed=0)
    params["lm_head_bias"] = torch.zeros(pcfg.vocab_size)
    with pytest.raises(ValueError, match="LM-head bias"):
        tgpt.gpt_loss(params, {"tokens": torch.zeros((1, 5),
                                                     dtype=torch.int64)},
                      cfg=pcfg)
