"""The port's query-chunked attention held to the JAX package's
(`deepspeed_tpu/ops/chunked_attention.py`), the dispatch's `chunked`
program, and GPT through it against JAX's GPT. fp32 on the CPU, inputs from
numpy seeds, within 1e-5 (2e-5 for gradients summed over T keys)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.ops.chunked_attention import \
    chunked_attention as jchunked
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.ops import attention_dispatch as ad
from deepspeed_tpu_torch.ops.chunked_attention import chunked_attention
from deepspeed_tpu_torch.utils.tree import tree_leaves


@pytest.mark.parametrize("T,block_q,causal", [(200, 64, True),
                                              (200, 64, False),
                                              (96, 128, True),
                                              (130, 32, True)],
                         ids=["ragged-causal", "ragged-full",
                              "one-block", "ragged-small-blocks"])
def test_output_and_gradients_match_jax(T, block_q, causal):
    """T not a multiple of block_q: the query axis is padded, k and v are
    not, the padded rows are dropped; output and the q/k/v gradients of a
    weighted sum against `jax.grad`."""
    rng = np.random.default_rng(T + block_q)
    q, k, v = (rng.normal(0, 1, (2, 3, T, 64)).astype(np.float32)
               for _ in range(3))
    wt = rng.normal(0, 1, (2, 3, T, 64)).astype(np.float32)

    def jf(q, k, v):
        return (jchunked(q, k, v, causal=causal, block_q=block_q)
                * wt).sum()
    jout = jchunked(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                    block_q=block_q)
    jgrads = jax.grad(jf, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = chunked_attention(tq, tk, tv, causal=causal, block_q=block_q)
    grads = torch.autograd.grad((out * torch.from_numpy(wt)).sum(),
                                (tq, tk, tv))
    assert out.shape == (2, 3, T, 64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    for a, b in zip(grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=0)


def test_strips_are_recomputed_in_the_backward():
    """Each strip runs under torch.utils.checkpoint: the backward replays
    every strip's score product once more (ceil(T / block_q) strips; the
    replay stops there, as P·V's output is needed by no backward
    formula), where a strip kept whole would replay nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ == "bmm":
                self.n += 1
            return func(*args, **(kwargs or {}))

    q, k, v = (torch.randn(1, 2, 100, 32, requires_grad=True)
               for _ in range(3))
    fwd, both = Count(), Count()
    with fwd, torch.no_grad():
        chunked_attention(q, k, v, block_q=32)
    with both:
        torch.autograd.grad(chunked_attention(q, k, v, block_q=32).sum(),
                            (q, k, v))
    strips = 4
    assert fwd.n == 2 * strips
    # forward 2, replay 1, backward of the two products 4, a strip
    assert both.n == 7 * strips


@pytest.mark.parametrize("kw,want", [
    (dict(chunk_min=1024), "chunked"),
    (dict(chunk_min=4096), "flash"),
    (dict(), "flash"),
    (dict(chunk_min=512, external_fn=True), "external"),
], ids=["T-reaches-it", "T-short-of-it", "unset", "external-wins"])
def test_dispatch_takes_chunked_where_the_config_asks(kw, want):
    site = dict(phase="train", q_len=2048, kv_len=2048, head_dim=128,
                kv_dtype="bfloat16", on_cuda=True)
    assert ad.select(ad.AttnSite(**site, **kw)) == want


def test_dispatch_chunked_keeps_the_kernel_rules():
    """Chunked takes no alibi or window (a CUDA site then raises, as the
    flash site does) and nothing that use_flash_attention=False forbids
    (JAX's engages only where flash would); it runs alike on the CPU and
    on CUDA, forced or not, and at any dtype and head width (plain torch:
    nothing to refuse)."""
    base = dict(phase="train", q_len=2048, kv_len=2048, chunk_min=1024)
    for flag in ("has_bias", "has_window"):
        with pytest.raises(NotImplementedError):
            ad.select(ad.AttnSite(**base, on_cuda=True, **{flag: True}))
        assert ad.select(ad.AttnSite(**base, **{flag: True})) == "dense"
    assert ad.select(ad.AttnSite(**base)) == "chunked"
    assert ad.select(ad.AttnSite(**base, force_flash=True)) == "chunked"
    assert ad.select(ad.AttnSite(**base, force_flash=False)) == "dense"
    with pytest.raises(NotImplementedError):
        ad.select(ad.AttnSite(**base, on_cuda=True, force_flash=False))
    assert ad.select(ad.AttnSite(**base, on_cuda=True, kv_dtype="float32",
                                 head_dim=32)) == "chunked"


@pytest.mark.parametrize("gqa", [False, True], ids=["mha", "gqa"])
def test_gpt_loss_through_chunked_attention_matches_jax(gqa, monkeypatch):
    """A 2-layer GPT with chunked_attn_min_seq 64 and the kernels forced
    (JAX engages its chunked program where flash would, at T % 128 == 0):
    the loss and every gradient against JAX's; the chunked attention runs
    twice a layer (the forward and the remat replay), the flash wrapper
    never."""
    from deepspeed_tpu.comm import mesh as mesh_mod
    mesh_mod.clear_mesh()
    jcfg = jgpt.GPTConfig(n_layer=2, n_head=4, n_kv_head=2 if gqa else None,
                          d_model=64, max_seq_len=128, vocab_size=256,
                          dtype=jnp.float32, use_flash_attention=True,
                          chunked_attn_min_seq=64)
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name != "dtype"]
    pcfg = tgpt.GPTConfig(dtype="float32",
                          **{k: getattr(jcfg, k) for k in names})
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jgpt.init_gpt_params(jcfg, seed=5))
    toks = np.random.default_rng(6).integers(0, 256, (2, 129)) \
        .astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jgpt.gpt_loss(p, {"tokens": jnp.asarray(toks)}, None,
                                jcfg))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = tgpt.params_from_jax(np_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    calls = []
    monkeypatch.setattr(tgpt, "chunked_attention",
                        lambda *a, **k: calls.append(1)
                        or chunked_attention(*a, **k))
    monkeypatch.setattr(tgpt, "flash_attention", None)
    loss = tgpt.gpt_loss(params, {"tokens": torch.from_numpy(toks)},
                         cfg=pcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert len(calls) == 2 * pcfg.n_layer
    assert float(loss.detach()) == pytest.approx(float(jloss), abs=1e-5)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0)
    mesh_mod.clear_mesh()
