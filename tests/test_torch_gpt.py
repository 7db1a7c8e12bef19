"""The PyTorch port's GPT decode model held to the JAX package's: the same
numpy-seeded weights (moved leaf by leaf with `params_from_jax`) and the
same tokens go through JAX `make_gpt_decode_model` and the port's, fp32 on
the CPU.

Tolerance: logits within atol 1e-4 (fp32 on both sides; matmul and
softmax summation orders differ between XLA and PyTorch's CPU kernels).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.models import gpt as tgpt

ATOL = 1e-4


def _mk_mesh():
    mesh_mod._CURRENT_MESH = None
    mesh_mod._CURRENT_SPEC = None
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def jax_cfg(**flags):
    return jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
                          vocab_size=256, dtype=jnp.float32, remat=False,
                          **flags)


def port_cfg(jcfg, **over):
    """The port's GPTConfig with every field the JAX config shares."""
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name != "dtype"]
    kw = {n: getattr(jcfg, n) for n in names}
    kw["dtype"] = str(jnp.dtype(jcfg.dtype))
    kw.update(over)
    return tgpt.GPTConfig(**kw)


def both_specs(jcfg, seed=0, **port_over):
    _mk_mesh()
    jspec = jgpt.make_gpt_decode_model(cfg=jcfg, name="tiny", seed=seed)
    params = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jspec.params))
    tspec = tgpt.make_gpt_decode_model(cfg=port_cfg(jcfg, **port_over),
                                       name="tiny", params=params)
    return jspec, tspec


def test_params_from_jax_round_trip():
    """Names, shapes and values move leaf by leaf; a shared seed already
    gives both packages the same weights; bf16 leaves move bit for bit."""
    jcfg = jax_cfg(use_swiglu=True, use_rmsnorm=True, use_rotary=True,
                   n_kv_head=2, tie_embeddings=False)
    jp = jax.tree_util.tree_map(np.asarray, jgpt.init_gpt_params(jcfg, 3))
    tp = tgpt.params_from_jax(jp)
    own = tgpt.init_gpt_params(port_cfg(jcfg), seed=3)
    flat_j = dict(jax.tree_util.tree_leaves_with_path(jp))
    assert len(flat_j) == sum(1 for k in tp if k != "blocks") \
        + len(tp["blocks"])

    def walk(a, b, c):
        assert a.keys() == b.keys() == c.keys()
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key], c[key])
                continue
            assert tuple(b[key].shape) == a[key].shape, key
            np.testing.assert_array_equal(b[key].numpy(), a[key])
            np.testing.assert_array_equal(c[key].numpy(), a[key])
    walk(jp, tp, own)
    jb = jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), jp)
    tb = tgpt.params_from_jax(jb)
    assert tb["wte"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb["wte"].float().numpy(), np.asarray(jb["wte"], np.float32))


ARCHS = {
    "gpt2": {},
    "rotary": dict(use_rotary=True),
    "rotary_partial": dict(use_rotary=True, rotary_pct=0.5),
    "rmsnorm": dict(use_rmsnorm=True),
    "swiglu": dict(use_swiglu=True),
    "gqa": dict(n_kv_head=2),
    "llama": dict(use_rotary=True, use_rmsnorm=True, use_swiglu=True,
                  n_kv_head=2),
    "bloom_emb_ln_untied": dict(use_emb_ln=True, tie_embeddings=False),
}


@functools.lru_cache(maxsize=None)
def _jax_rollout(arch):
    """JAX prefill logits and cache keys, then three greedy decode steps'
    (token, pos, logits) — computed once per arch, shared by both dispatch
    variants of the port."""
    jcfg = jax_cfg(**ARCHS[arch])
    _mk_mesh()
    jspec = jgpt.make_gpt_decode_model(cfg=jcfg, name="tiny", seed=0)
    rng = np.random.default_rng(5)
    B, T, M = 2, 13, 32
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    jcache = jspec.init_cache(B, M, jnp.float32)
    jlog, jcache = jspec.prefill_fn(jspec.params, jnp.asarray(tokens),
                                    jcache, None)
    prefill = (np.asarray(jlog), np.asarray(jcache["k"])[:, :, :, :T])
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)
    pos = np.full((B,), T, np.int32)
    steps = []
    for _ in range(3):
        jl, jcache = jspec.decode_fn(jspec.params, jnp.asarray(tok),
                                     jnp.asarray(pos), jcache)
        steps.append((tok, pos, np.asarray(jl)))
        tok = np.array(jnp.argmax(jl, -1), np.int32)
        pos = pos + 1
    params = jax.tree_util.tree_map(np.asarray, jspec.params)
    return jcfg, params, tokens, prefill, steps


@pytest.mark.parametrize("forced_kernels", [False, True],
                         ids=["dense", "kernel_programs"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_logits_match_jax(arch, forced_kernels):
    """Prefill logits and three decode steps' logits. `kernel_programs`
    forces the port's flash/decode dispatch programs (their plain versions
    on the CPU) against the JAX package's default dense path."""
    jcfg, jparams, tokens, (jlog, jk), steps = _jax_rollout(arch)
    tspec = tgpt.make_gpt_decode_model(
        cfg=port_cfg(jcfg, use_flash_attention=True if forced_kernels
                     else None),
        name="tiny", params=tgpt.params_from_jax(jparams))
    B, T = tokens.shape
    tcache = tspec.init_cache(B, 32, torch.float32)
    with torch.inference_mode():
        tlog, tcache = tspec.prefill_fn(tspec.params,
                                        torch.from_numpy(tokens).long(),
                                        tcache, None)
    np.testing.assert_allclose(tlog.numpy(), jlog, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tcache["k"][:, :, :, :T].numpy(), jk,
                               atol=ATOL, rtol=0)
    for tok, pos, jl in steps:
        with torch.inference_mode():
            tl, tcache = tspec.decode_fn(tspec.params,
                                         torch.from_numpy(tok),
                                         torch.from_numpy(pos).long(),
                                         tcache)
        np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_paged_prefill_chunk_and_decode_match_jax(arch):
    """The paged contract: two prefill chunks through a shuffled block table
    (plus a trash-only inactive row) and two decode steps, logits against
    JAX's `prefill_paged_fn` / `decode_paged_fn`."""
    jcfg = jax_cfg(**ARCHS[arch])
    jspec, tspec = both_specs(jcfg)
    rng = np.random.default_rng(6)
    bs, N, C = 8, 10, 8
    prompt = rng.integers(0, jcfg.vocab_size, (13,)).astype(np.int32)
    tables = np.asarray([[4, 7, 2], [0, 0, 0]], np.int32)
    jpool = jspec.init_paged_pool(N, bs, jnp.float32)
    tpool = tspec.init_paged_pool(N, bs, torch.float32)
    for start in (0, C):
        chunk = np.zeros((1, C), np.int32)
        seg = prompt[start:start + C]
        chunk[0, :len(seg)] = seg
        last = np.asarray([min(len(prompt) - 1 - start, C - 1)], np.int32)
        jl, jpool = jspec.prefill_paged_fn(
            jspec.params, jnp.asarray(chunk), jnp.asarray([start]),
            jnp.asarray(last), jpool, jnp.asarray(tables[:1]))
        with torch.inference_mode():
            tl, tpool = tspec.prefill_paged_fn(
                tspec.params, torch.from_numpy(chunk).long(),
                torch.tensor([start]), torch.from_numpy(last).long(), tpool,
                torch.from_numpy(tables[:1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    tok = np.asarray([int(np.argmax(np.asarray(jl)[0])), 0], np.int32)
    pos = np.asarray([len(prompt), 0], np.int32)
    for _ in range(2):
        jl, jpool = jspec.decode_paged_fn(jspec.params, jnp.asarray(tok),
                                          jnp.asarray(pos), jpool,
                                          jnp.asarray(tables))
        with torch.inference_mode():
            tl, tpool = tspec.decode_paged_fn(
                tspec.params, torch.from_numpy(tok),
                torch.from_numpy(pos).long(), tpool,
                torch.from_numpy(tables))
        np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                   atol=ATOL, rtol=0)
        tok = np.asarray([int(np.argmax(np.asarray(jl)[0])), 0], np.int32)
        pos = pos + np.asarray([1, 0], np.int32)


@pytest.mark.parametrize("flag", [dict(use_alibi=True),
                                  dict(sliding_window=4),
                                  dict(attn_layer_types=("global", "local"),
                                       sliding_window=4)],
                         ids=["alibi", "sliding_window", "attn_layer_types"])
def test_unported_arch_flags_refuse(flag):
    with pytest.raises(NotImplementedError, match="not ported"):
        tgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, **flag)


@pytest.mark.parametrize("flag", [dict(parallel_residual=True)],
                         ids=["parallel_residual"])
def test_ported_arch_flags_build(flag):
    """The NeoX/GPT-J parallel residual is ported
    (tests/test_torch_routing.py holds its logits to JAX's)."""
    cfg = tgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, **flag)
    assert all(getattr(cfg, k) == v for k, v in flag.items())
