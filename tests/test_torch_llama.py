"""The PyTorch port's LLaMA family (`models/llama.py` over the GPT core)
held to the JAX package's: the same configurations, numpy-seeded weights
moved leaf by leaf with `params_from_jax`, fp32 on the CPU.

Tolerances (fp32 on both sides, other summation orders): the loss atol
1e-5, every gradient rtol 1e-4 / atol 1e-5, logits atol 1e-4; greedy
tokens identical (the untied random head keeps the top-2 gaps far above
the fp32 noise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.inference.engine import init_inference as jinit_inference
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import llama as jllama
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import llama as tllama
from deepspeed_tpu_torch.utils.tree import tree_leaves

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(n_layer=2, n_head=4, n_kv_head=2, d_model=64, d_ff=128,
             max_seq_len=128, vocab_size=256)


def _one_device_mesh():
    mesh_mod.clear_mesh()
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("dtype", "softmax_dtype")}


@pytest.mark.parametrize("name", sorted(jllama.LLAMA_CONFIGS))
def test_llama_configs_match_jax(name):
    """Every field the two GPTConfigs share, the dtype's name and the
    parameter count."""
    jc, tc = jllama.LLAMA_CONFIGS[name], tllama.LLAMA_CONFIGS[name]
    shared = set(_fields(tc)) & set(_fields(jc))
    assert {k: getattr(tc, k) for k in shared} == \
        {k: getattr(jc, k) for k in shared}
    for field in ("dtype", "softmax_dtype"):
        assert tgpt.dtype_name(getattr(tc, field)) == \
            jnp.dtype(getattr(jc, field)).name
    assert tc.num_params() == jc.num_params()
    for field in ("use_rotary", "use_swiglu", "use_rmsnorm"):
        assert getattr(tc, field)
    assert not tc.tie_embeddings


def _cfgs(**over):
    jc = jllama.llama_config(**{**SMALL, **over}, dtype=jnp.float32,
                             remat=False)
    tc = tllama.llama_config(**{**SMALL, **over}, dtype="float32",
                             remat=False)
    return jc, tc


@pytest.mark.parametrize("use_flash", [None, True],
                         ids=["plain-attention", "flash-wrappers"])
@pytest.mark.parametrize("n_kv_head", [2, 1], ids=["gqa2", "mqa"])
def test_llama_loss_and_grads_match_jax(n_kv_head, use_flash):
    """make_llama_model's loss and every gradient on llama-tiny (fp32; its
    GQA 2 and as MQA) against jax.value_and_grad, on the plain attention
    and through the flash wrappers."""
    _one_device_mesh()
    jc = dataclasses.replace(jllama.LLAMA_CONFIGS["llama-tiny"],
                             n_kv_head=n_kv_head, dtype=jnp.float32)
    tc = dataclasses.replace(tllama.LLAMA_CONFIGS["llama-tiny"],
                             n_kv_head=n_kv_head, dtype=torch.float32,
                             use_flash_attention=use_flash)
    jspec = jllama.make_llama_model(cfg=jc, name="llama-tiny", seed=4)
    np_params = jax.tree_util.tree_map(np.asarray, jspec.params)
    tspec = tllama.make_llama_model(cfg=tc, name="llama-tiny", seed=4)
    for a, b in zip(jax.tree_util.tree_leaves(np_params),
                    tree_leaves(tspec.params)):
        np.testing.assert_array_equal(b.numpy(), a)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (3, 25)) \
        .astype(np.int32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jspec.loss_fn(p, {"tokens": jnp.asarray(toks)}, None))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    params = tgpt.params_from_jax(np_params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss = tspec.loss_fn(params, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def _expand_gqa(params, cfg):
    """Each kv head repeated over its query group inside the fused qkv:
    the MHA model with the same function."""
    H, Hkv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    out = {**params, "blocks": dict(params["blocks"])}
    for key in ("attn_qkv_w", "attn_qkv_b"):
        w = params["blocks"][key]
        q, k, v = w.split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
        rep = lambda t: t.unflatten(-1, (Hkv, hd)).repeat_interleave(
            H // Hkv, dim=-2).flatten(-2)
        out["blocks"][key] = torch.cat([q, rep(k), rep(v)], dim=-1)
    return out


def test_gqa_matches_expanded_mha():
    _, tc = _cfgs()
    params = tgpt.init_gpt_params(tc, seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                              (2, 16)))
    out = tgpt.gpt_forward(params, toks, tc)
    mha = dataclasses.replace(tc, n_kv_head=tc.n_head)
    torch.testing.assert_close(
        tgpt.gpt_forward(_expand_gqa(params, tc), toks, mha), out,
        rtol=1e-5, atol=1e-5)


def test_gqa_decode_matches_the_forward():
    """generate() over the contiguous cache (GQA decode) gives the argmax of
    the full forward at every step."""
    _, tc = _cfgs()
    spec = tllama.make_llama_decode_model(cfg=tc, name="tiny", seed=1)
    engine = init_inference(spec, config={"dtype": "float32",
                                          "kv_cache_dtype": "float32",
                                          "greedy": True}, device="cpu")
    toks = np.random.default_rng(1).integers(0, 256, (2, 8)).astype(np.int32)
    out = engine.generate(toks, max_new_tokens=5)
    cur = torch.from_numpy(toks).long()
    for j in range(5):
        nxt = tgpt.gpt_forward(spec.params, cur, tc)[:, -1].argmax(-1)
        np.testing.assert_array_equal(np.asarray(out)[:, j], nxt.numpy())
        cur = torch.cat([cur, nxt[:, None]], dim=1)


def test_llama_tiny_greedy_tokens_equal_jax():
    """llama-tiny (the zoo's own entry, fp32) through both packages'
    generate(): the same weights from one seed, identical greedy tokens,
    and prefill logits within 1e-4."""
    _one_device_mesh()
    jc = dataclasses.replace(jllama.LLAMA_CONFIGS["llama-tiny"],
                             dtype=jnp.float32)
    tc = dataclasses.replace(tllama.LLAMA_CONFIGS["llama-tiny"],
                             dtype=torch.float32)
    conf = {"dtype": "float32", "kv_cache_dtype": "float32", "greedy": True}
    jspec = jllama.make_llama_decode_model(cfg=jc, name="llama-tiny", seed=2)
    tspec = tllama.make_llama_decode_model(cfg=tc, name="llama-tiny", seed=2)
    for a, b in zip(jax.tree_util.tree_leaves(jspec.params),
                    tree_leaves(tspec.params)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    toks = np.random.default_rng(3).integers(0, 1024, (2, 12)) \
        .astype(np.int32)
    jout = jinit_inference(model=jspec, config=conf).generate(
        toks, max_new_tokens=8)
    tout = init_inference(tspec, config=conf, device="cpu").generate(
        toks, max_new_tokens=8)
    np.testing.assert_array_equal(np.asarray(tout), np.asarray(jout))
    np.testing.assert_allclose(
        tgpt.gpt_forward(tspec.params, torch.from_numpy(toks), tc).numpy(),
        np.asarray(jgpt.gpt_forward(jspec.params, jnp.asarray(toks), jc)),
        atol=1e-4)
