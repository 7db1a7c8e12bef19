"""The port's speculative decoding held to the JAX package's: the n-gram
and draft-model drafters, the acceptance rule, `verify_paged_fn` (GPT and
MoE-GPT) and the scheduler's verify step, fp32 on the CPU with the same
numpy-seeded weights. Tokens and the `spec_decode` counters must be EQUAL;
verify logits within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.inference import spec_decode as jsd
from deepspeed_tpu.inference.engine import init_inference as jax_init
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import moe_gpt as jmoe
from deepspeed_tpu_torch.inference import spec_decode as tsd
from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.scheduler import _DECODE, Request
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import moe_gpt as tmoe
from deepspeed_tpu_torch.ops import attention_dispatch as ad

BS = 16
LIVELY = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
                        vocab_size=256, dtype=jnp.float32, remat=False,
                        tie_embeddings=False)
DRAFT = jgpt.GPTConfig(n_layer=1, n_head=2, d_model=32, max_seq_len=256,
                       vocab_size=256, dtype=jnp.float32, remat=False)
MOE = jmoe.MoEGPTConfig(n_layer=2, n_head=4, d_model=64, d_ff=128,
                        max_seq_len=256, vocab_size=256, dtype=jnp.float32,
                        remat=False, num_experts=4, moe_freq=2,
                        tie_embeddings=False)
CONF = {"dtype": "float32", "kv_cache_dtype": "float32", "greedy": True,
        "kv_block_size": BS, "max_out_tokens": 64}
SERVE = dict(max_slots=3, max_context=64, prefill_chunk=BS)


def _mk_mesh():
    mesh_mod._CURRENT_MESH = None
    mesh_mod._CURRENT_SPEC = None
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def _port_cfg(jcfg, cls=tgpt.GPTConfig):
    names = [f.name for f in dataclasses.fields(cls)
             if f.name not in ("dtype", "softmax_dtype", "remat",
                               "remat_policy", "use_flash_attention")]
    return cls(**{n: getattr(jcfg, n) for n in names
                  if hasattr(jcfg, n)}, dtype="float32")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _spec_pair(jcfg=LIVELY, name="tiny", seed=0, params=None):
    """(JAX spec, port spec) over the same weights."""
    if isinstance(jcfg, jmoe.MoEGPTConfig):
        jspec = jmoe.make_moe_gpt_decode_model(cfg=jcfg, name=name,
                                               seed=seed)
        return jspec, tmoe.make_moe_gpt_decode_model(
            _port_cfg(jcfg, tmoe.MoEGPTConfig), name=name,
            params=tgpt.params_from_jax(_np(jspec.params)))
    jspec = jgpt.make_gpt_decode_model(cfg=jcfg, name=name, seed=seed,
                                       params=params)
    return jspec, tgpt.make_gpt_decode_model(
        _port_cfg(jcfg), name=name,
        params=tgpt.params_from_jax(_np(jspec.params)))


def _twins(jcfg=LIVELY, **conf):
    if isinstance(jcfg, jmoe.MoEGPTConfig):
        mesh_mod.clear_mesh()
    else:
        _mk_mesh()
    jspec, tspec = _spec_pair(jcfg)
    return (jax_init(model=jspec, config={**CONF, **conf}),
            init_inference(tspec, config={**CONF, **conf}, device="cpu"))


def _reqs(cls, prompts, news, **kw):
    return [cls(uid=i, tokens=p, max_new_tokens=news[i % len(news)],
                stop_on_eos=False, **kw) for i, p in enumerate(prompts)]


def _ragged(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32) for n in lens]


def _repetitive(seed, n):
    """bench.py's spec-decode lane shape, small: a 4-11-token pattern tiled
    to 20-40 tokens."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pat = rng.integers(0, 256, (int(rng.integers(4, 12)),))
        reps = -(-int(rng.integers(20, 40)) // len(pat))
        out.append(np.tile(pat, reps).astype(np.int32))
    return out


def _same(jout, tout):
    assert sorted(jout) == sorted(tout)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid].tokens, jout[uid].tokens)
        assert tout[uid].finish_reason == jout[uid].finish_reason


# ----------------------------------------------------------------------
# the unit layer: proposals, acceptance, sizing, dispatch
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_ngram_propose_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        L = int(rng.integers(1, 60))
        hist = rng.integers(0, int(rng.integers(2, 9)), (L,)).astype(np.int32)
        k = int(rng.integers(1, 6))
        max_n = int(rng.integers(1, 5))
        min_n = int(rng.integers(1, max_n + 1))
        np.testing.assert_array_equal(
            tsd.ngram_propose(hist, k, max_n, min_n),
            jsd.ngram_propose(hist, k, max_n, min_n))


@pytest.mark.parametrize("draft,target,dlen", [
    ([5, 6, 7, 8], [5, 6, 7, 8, 9], 4), ([5, 6, 7, 8], [5, 6, 1, 8, 9], 4),
    ([5, 6, 7, 8], [1, 6, 7, 8, 9], 4), ([5, 6, 7, 8], [5, 6, 7, 8, 9], 2),
    ([0, 0, 0, 0], [3, 0, 0, 0, 0], 0)])
def test_accept_greedy_equals_jax(draft, target, dlen):
    d, t = np.asarray(draft), np.asarray(target)
    assert tsd.accept_greedy(d, t, dlen) == jsd.accept_greedy(d, t, dlen)


def test_verify_is_the_gather_on_every_device():
    """The verify chunk takes the (dequantizing) gather, as in the JAX
    registry; the paged kernels take single-token decode only."""
    site = lambda **kw: ad.AttnSite(**{**dict(
        phase="verify", q_len=5, kv_len=512, head_dim=64,
        kv_dtype="bfloat16", on_cuda=True), **kw})
    assert ad.select(site()) == "paged_gather"
    assert ad.select(site(on_cuda=False)) == "paged_gather"
    assert ad.select(site(force_flash=True)) == "paged_gather"
    assert ad.select(site(kv_dtype="int8")) == "paged_gather_quant"
    assert ad.select(site(q_len=1)) == "paged_gather"
    assert ad.select(site(phase="paged_decode", q_len=1)) == "paged_kernel"


# ----------------------------------------------------------------------
# verify_paged_fn: every position's logits, and the pool it writes
# ----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gpt", "moe"])
def test_verify_logits_and_pool_match_jax(arch):
    """Two rows prefilled through their tables, then one verify of 5
    tokens a row at cursors that cross a block edge (13 -> 17, 30 -> 34):
    logits [B, 5, V] and the written pool within 1e-5 of JAX's."""
    jcfg = MOE if arch == "moe" else LIVELY
    if arch == "moe":
        mesh_mod.clear_mesh()
    jspec, tspec = _spec_pair(jcfg)
    tcfg_pool = (8, BS)
    jpool = jspec.init_paged_pool(*tcfg_pool, jnp.float32)
    tpool = tspec.init_paged_pool(*tcfg_pool, torch.float32)
    tables = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    rng = np.random.default_rng(9)
    lens = (13, 30)
    jparams, tparams = jspec.params, tspec.params
    for row, n in enumerate(lens):
        prompt = rng.integers(0, 256, (n,)).astype(np.int32)
        for start in range(0, n, BS):
            chunk = np.zeros((1, BS), np.int32)
            seg = prompt[start:start + BS]
            chunk[0, :len(seg)] = seg
            last = min(n - 1 - start, BS - 1)
            _, jpool = jspec.prefill_paged_fn(
                jparams, jnp.asarray(chunk), jnp.asarray([start]),
                jnp.asarray([last]), jpool, jnp.asarray(tables[row:row + 1]))
            _, tpool = tspec.prefill_paged_fn(
                tparams, torch.as_tensor(chunk, dtype=torch.long),
                torch.tensor([start]), torch.tensor([last]), tpool,
                torch.as_tensor(tables[row:row + 1]))
    toks = rng.integers(0, 256, (2, 5)).astype(np.int32)
    pos = np.asarray(lens, np.int32)
    jl, jpool = jspec.verify_paged_fn(jparams, jnp.asarray(toks),
                                      jnp.asarray(pos), jpool,
                                      jnp.asarray(tables))
    with torch.inference_mode():
        tl, tpool = tspec.verify_paged_fn(
            tparams, torch.as_tensor(toks), torch.as_tensor(pos), tpool,
            torch.as_tensor(tables))
    assert tl.shape == (2, 5, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tpool[leaf].numpy(),
                                   np.asarray(jpool[leaf]), rtol=1e-5,
                                   atol=1e-5)
    if arch == "moe":
        mesh_mod.clear_mesh()


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_kv_past_the_cursor_is_never_read(quantized):
    """What makes rejection free: K/V (and scales) written past a row's
    position — a rejected draft's — never reach its output. Every pool
    row past each query's position set to a large finite value gives
    BIT-equal decode and verify logits, through the plain path and
    through the kernel wrappers (`use_flash_attention=True`)."""
    for force in (None, True):
        tcfg = dataclasses.replace(_port_cfg(LIVELY),
                                   use_flash_attention=force)
        spec = tgpt.make_gpt_decode_model(tcfg, name="tiny", seed=3)
        dtype = torch.int8 if quantized else torch.float32
        pool = spec.init_paged_pool(8, BS, dtype)
        gen = torch.Generator().manual_seed(0)
        for name, leaf in pool.items():
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape,
                                         generator=gen))
            else:
                leaf.copy_(torch.rand(leaf.shape, generator=gen) + 0.01)
        tables = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
        pos = torch.tensor([13, 30])
        poisoned = {k: v.clone() for k, v in pool.items()}
        for row, p in enumerate(pos.tolist()):
            for j in range(3):
                b = int(tables[row, j])
                lo = max(0, p + 1 - j * BS)
                if lo < BS:
                    for leaf in poisoned.values():
                        leaf[:, b, :, lo:] = 100 if leaf.dtype == \
                            torch.int8 else 1e4
        tok = torch.tensor([5, 9], dtype=torch.int32)
        with torch.inference_mode():
            a, _ = spec.decode_paged_fn(spec.params, tok, pos,
                                        {k: v.clone() for k, v in
                                         pool.items()}, tables)
            b, _ = spec.decode_paged_fn(spec.params, tok, pos,
                                        {k: v.clone() for k, v in
                                         poisoned.items()}, tables)
            assert torch.equal(a, b)
            toks = torch.tensor([[5, 6, 7], [9, 1, 2]], dtype=torch.int32)
            a, _ = spec.verify_paged_fn(spec.params, toks, pos - 2,
                                        {k: v.clone() for k, v in
                                         pool.items()}, tables)
            b, _ = spec.verify_paged_fn(spec.params, toks, pos - 2,
                                        {k: v.clone() for k, v in
                                         poisoned.items()}, tables)
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_verify_pool_write_touches_only_its_cells(dtype):
    """The verify's cache write, 5 tokens a row across a block edge
    (positions 14-18 of 16-token blocks) with read-only blocks shared by
    the rows' tables: equal to one token at a time (the int8 pool: to
    `quantize_kv_write_reference`), and no byte outside the written
    (block, offset) cells changes but in the trash block."""
    from deepspeed_tpu_torch.models.gpt import paged_kv_write
    from deepspeed_tpu_torch.ops import quant
    gen = torch.Generator().manual_seed(1)
    tables = torch.tensor([[1, 2, 7, 8], [3, 4, 7, 8], [0, 0, 0, 0]],
                          dtype=torch.int32)
    pos = torch.tensor([list(range(14, 19))] * 2 + [list(range(5))])
    k, v = (torch.randn(3, 5, 2, 32, generator=gen) for _ in range(2))
    shape = (9, 2, BS, 32)
    if dtype == "int8":
        pool = {n: torch.randint(-127, 128, shape, generator=gen,
                                 dtype=torch.int8) for n in ("k", "v")}
        pool.update({n: torch.rand(shape[:-1] + (4,), generator=gen)
                     for n in ("k_scale", "v_scale")})
    else:
        pool = {n: torch.randn(shape, generator=gen).to(getattr(torch,
                                                                dtype))
                for n in ("k", "v")}
    got = {n: t.clone() for n, t in pool.items()}
    ref = {n: t.clone() for n, t in pool.items()}
    paged_kv_write(got, k, v, tables, pos)
    written = torch.zeros(9, BS, dtype=torch.bool)
    for b in range(2):
        for p in pos[b].tolist():
            written[tables[b, p // BS], p % BS] = True
    if dtype == "int8":
        quant.quantize_kv_write_reference(
            k, v, tables, pos, ref["k"], ref["v"], ref["k_scale"],
            ref["v_scale"])
    else:
        for b in range(2):
            for c, p in enumerate(pos[b].tolist()):
                ref["k"][tables[b, p // BS], :, p % BS] = k[b, c]
                ref["v"][tables[b, p // BS], :, p % BS] = v[b, c]
    keep = ~written[1:, None, :, None]
    for n in got:
        assert torch.equal(got[n][1:], ref[n][1:]), n
        assert bool(((got[n][1:] == pool[n][1:]) | ~keep).all()), n
    assert torch.equal(got["k"][7:], pool["k"][7:])      # the shared blocks


# ----------------------------------------------------------------------
# the serving engine: tokens and counters equal to JAX's
# ----------------------------------------------------------------------


@pytest.mark.parametrize("drafter", ["off", "ngram", "model_self",
                                     "model_draft"])
def test_served_tokens_and_stats_equal_jax(drafter):
    """A ragged trace and a repetitive one through both packages with the
    drafter off, prompt lookup, the target drafting for itself and an
    unrelated small draft model: tokens identical, and identical to the
    drafter-off run; the spec_decode block of stats() equal."""
    je, te = _twins()
    kw, jkw, tkw = dict(SERVE), {}, {}
    if drafter != "off":
        kind = drafter.split("_")[0]
        kw["spec_decode"] = {"drafter": kind, "draft_k": 3}
    if drafter == "model_self":
        jkw["draft_spec"], tkw["draft_spec"] = je.model_spec, te.model_spec
    elif drafter == "model_draft":
        jkw["draft_spec"], tkw["draft_spec"] = _spec_pair(DRAFT, "draft",
                                                          seed=7)
    prompts = _ragged(2, (5, 9, 17, 3, 12)) + _repetitive(4, 3)
    news = (12, 7, 10)
    js, ts = je.serving(**kw, **jkw), te.serving(**kw, **tkw)
    jout = js.run(_reqs(JaxRequest, prompts, news))
    tout = ts.run(_reqs(Request, prompts, news))
    _same(jout, tout)
    base = te.serving(**SERVE).run(_reqs(Request, prompts, news))
    _same(base, tout)
    jst, tst = js.stats(), ts.stats()
    for key in ("decode_steps", "prefill_chunks", "tokens_generated",
                "spec_decode"):
        assert tst.get(key) == jst.get(key), key
    if drafter == "model_self":
        # below 1.0 in both packages: the draft loop never feeds its last
        # draft, so after a fully accepted verify the draft pool lacks that
        # position's K/V and the next first proposal reads a stale row
        assert tst["spec_decode"]["acceptance_rate"] > 0.8
    if drafter != "off":
        assert tst["spec_decode"]["verify_steps"] == tst["decode_steps"]
        assert ts.allocator.num_free == ts.allocator.capacity


def test_moe_ngram_tokens_equal_jax():
    je, te = _twins(MOE)
    prompts = _ragged(3, (5, 11, 8)) + _repetitive(5, 2)
    kw = dict(SERVE, spec_decode={"drafter": "ngram", "draft_k": 4})
    js, ts = je.serving(**kw), te.serving(**kw)
    jout = js.run(_reqs(JaxRequest, prompts, (9, 6)))
    tout = ts.run(_reqs(Request, prompts, (9, 6)))
    mesh_mod.clear_mesh()
    _same(jout, tout)
    assert ts.stats()["spec_decode"] == js.stats()["spec_decode"]


def test_model_drafter_over_the_int8_pool_equals_jax():
    """The draft mirror takes the int8 pool when the target's is int8: the
    target drafting for itself over int8 pools in both packages."""
    je, te = _twins()
    kw = dict(SERVE, spec_decode={"drafter": "model", "draft_k": 3},
              quantization={"kv_cache_dtype": "int8"})
    js = je.serving(**kw, draft_spec=je.model_spec)
    ts = te.serving(**kw, draft_spec=te.model_spec)
    assert ts.drafter.pool["k"].dtype == torch.int8
    assert set(ts.drafter.pool) == {"k", "v", "k_scale", "v_scale"}
    prompts = _ragged(6, (5, 20, 9))
    jout = js.run(_reqs(JaxRequest, prompts, (8,)))
    tout = ts.run(_reqs(Request, prompts, (8,)))
    _same(jout, tout)
    assert ts.stats()["spec_decode"] == js.stats()["spec_decode"]


def test_spec_composes_with_prefix_caching_equal_jax():
    je, te = _twins()
    rng = np.random.default_rng(8)
    prefix = rng.integers(0, 256, (32,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, 256, (t,))
                               .astype(np.int32)]) for t in (3, 7, 5)]
    kw = dict(max_slots=2, max_context=64, prefill_chunk=BS,
              enable_prefix_caching=True,
              spec_decode={"drafter": "ngram", "draft_k": 3})
    js, ts = je.serving(**kw), te.serving(**kw)
    for wave in (0, 1):
        jout = js.run(_reqs(JaxRequest, prompts, (8,)))
        tout = ts.run(_reqs(Request, prompts, (8,)))
        _same(jout, tout)
    for key in ("prefill_chunks", "spec_decode", "prefix_cache"):
        assert ts.stats()[key] == js.stats()[key], key
    assert ts.stats()["prefix_cache"]["hit_blocks"] > 0


class JunkDrafter(tsd.Drafter):
    """Proposes k uniform-random tokens: near-certain rejection."""

    name = "junk"

    def __init__(self, k, seed=0):
        self.k = int(k)
        self.rng = np.random.default_rng(seed)

    def propose(self, dec_slots, tok0, pos, tables):
        drafts = self.rng.integers(0, 256, (tok0.shape[0], self.k)) \
            .astype(np.int32)
        lens = np.zeros((tok0.shape[0],), np.int32)
        for s in dec_slots:
            lens[s.idx] = self.k
        return drafts, lens


def test_rollback_leaves_blocks_and_tables_alone():
    """Rejection rewinds the cursor only: across every verify a slot's
    blocks and table row are unchanged, the cursor moves by the tokens
    emitted (1..k+1), and junk drafts leave the tokens of the drafter-off
    run."""
    _, te = _twins()
    prompts = _ragged(3, (5, 11, 8))
    base = te.serving(max_slots=2, max_context=64, prefill_chunk=BS).run(
        _reqs(Request, prompts, (10,)))
    serving = te.serving(max_slots=2, max_context=64, prefill_chunk=BS,
                         spec_decode={"drafter": "ngram", "draft_k": 4})
    serving.drafter = JunkDrafter(4)
    for r in _reqs(Request, prompts, (10,)):
        serving.submit(r)
    out = {}
    while serving.queue or serving.num_active:
        before = {s.idx: (s.uid, list(s.blocks), serving.tables[s.idx].copy(),
                          s.pos, len(s.emitted))
                  for s in serving.slots if s.state == _DECODE}
        for done in serving.step():
            out[done.uid] = done
        for idx, (uid, blocks, table, pos, n) in before.items():
            s = serving.slots[idx]
            if s.uid != uid:
                continue
            assert s.blocks == blocks
            np.testing.assert_array_equal(serving.tables[idx], table)
            assert s.pos - pos == len(s.emitted) - n
            assert 1 <= s.pos - pos <= serving.draft_k + 1
    _same(base, out)
    assert serving.stats()["spec_decode"]["acceptance_rate"] < 0.2


class OracleDrafter(tsd.Drafter):
    """Proposes the known continuation: every draft is accepted."""

    name = "oracle"

    def __init__(self, k, continuation):
        self.k = int(k)
        self.cont = np.asarray(continuation, np.int32)

    def propose(self, dec_slots, tok0, pos, tables):
        drafts = np.zeros((tok0.shape[0], self.k), np.int32)
        lens = np.zeros((tok0.shape[0],), np.int32)
        for s in dec_slots:
            nxt = self.cont[len(s.emitted):len(s.emitted) + self.k]
            drafts[s.idx, :nxt.shape[0]] = nxt
            lens[s.idx] = nxt.shape[0]
        return drafts, lens


def test_eos_inside_an_accepted_draft_retires_there():
    _, te = _twins()
    prompt = _ragged(5, (7,))[0]
    ref = te.serving(max_slots=2, max_context=64, prefill_chunk=BS).run(
        _reqs(Request, [prompt], (20,)))[0].tokens
    eos_pos = int(np.nonzero([t not in ref[:i] for i, t in
                              enumerate(ref)])[0][2])
    serving = te.serving(max_slots=2, max_context=64, prefill_chunk=BS,
                         spec_decode={"drafter": "ngram", "draft_k": 4})
    serving.drafter = OracleDrafter(4, ref)
    out = serving.run([Request(uid=0, tokens=prompt, max_new_tokens=20,
                               eos_token_id=int(ref[eos_pos]))])[0]
    assert out.finish_reason == "eos"
    np.testing.assert_array_equal(out.tokens, ref[:eos_pos + 1])
    st = serving.stats()["spec_decode"]
    assert st["accepted_tokens"] > 0 and st["emitted_tokens"] == eos_pos
    assert serving.num_active == 0
    assert serving.allocator.num_free == serving.allocator.capacity


def test_contract_errors_are_the_references():
    _, te = _twins()
    no_verify = dataclasses.replace(te.model_spec, verify_paged_fn=None)
    engine_nv = init_inference(no_verify, config=dict(CONF), device="cpu")
    with pytest.raises(ValueError, match="verify_paged_fn"):
        engine_nv.serving(max_slots=2, max_context=64,
                          spec_decode={"drafter": "ngram", "draft_k": 2})
    with pytest.raises(ValueError, match="draft_spec"):
        te.serving(max_slots=2, max_context=64,
                   spec_decode={"drafter": "model", "draft_k": 2})
    with pytest.raises(ValueError, match="draft_k"):
        te.serving(max_slots=2, max_context=64,
                   spec_decode={"drafter": "ngram", "draft_k": 0})
    with pytest.raises(ValueError, match="unknown spec_decode.drafter"):
        te.serving(max_slots=2, max_context=64,
                   spec_decode={"drafter": "eagle"})
    draft = _spec_pair(DRAFT, "d", seed=1)[1]
    with pytest.raises(ValueError, match="draft_spec"):
        te.serving(max_slots=2, max_context=64, draft_spec=draft)
    bare = dataclasses.replace(draft, prefill_paged_fn=None)
    with pytest.raises(ValueError, match="paged serving contract"):
        te.serving(max_slots=2, max_context=64, draft_spec=bare,
                   spec_decode={"drafter": "model", "draft_k": 2})
    legacy = dataclasses.replace(
        draft, init_paged_pool=lambda n, bs, dtype, device="cpu":
        draft.init_paged_pool(n, bs, torch.float32, device=device))
    with pytest.raises(ValueError, match="quantized-pool contract"):
        te.serving(max_slots=2, max_context=64, draft_spec=legacy,
                   spec_decode={"drafter": "model", "draft_k": 2},
                   quantization={"kv_cache_dtype": "int8"})
    scaleless = dataclasses.replace(
        draft, init_paged_pool=lambda n, bs, dtype, g=0, device="cpu":
        draft.init_paged_pool(n, bs, torch.float32, device=device))
    with pytest.raises(ValueError, match="no k_scale"):
        te.serving(max_slots=2, max_context=64, draft_spec=scaleless,
                   spec_decode={"drafter": "model", "draft_k": 2},
                   quantization={"kv_cache_dtype": "int8"})


def test_admission_sizes_for_the_draft_overhang():
    """A request whose decode writes fit max_context only without the
    k-draft overhang is refused with spec decode on, as in JAX."""
    je, te = _twins()
    prompt = _ragged(1, (40,))[0]
    kw = dict(max_slots=1, max_context=64, prefill_chunk=BS)
    for engine, cls in ((te, Request), (je, JaxRequest)):
        # decode writes reach 39 + 22 = 61 < 64; with 4 drafts 65
        engine.serving(**kw).submit(cls(uid=0, tokens=prompt,
                                        max_new_tokens=23))
        spec = engine.serving(**kw, spec_decode={"drafter": "ngram",
                                                 "draft_k": 4})
        with pytest.raises(ValueError, match="draft_k 4"):
            spec.submit(cls(uid=0, tokens=prompt, max_new_tokens=23))


def test_latency_under_spec_decode_equals_jax():
    """An injected clock, one tick a sync: the TPOT samples interpolated
    across each verify's burst, TTFT and e2e equal JAX's snapshot."""
    tel = {"telemetry": {"enabled": True, "prometheus": False,
                         "jsonl": False, "monitor_bridge": False}}
    je, te = _twins(**tel)
    prompts = _repetitive(7, 3)
    snaps = []
    for engine, cls in ((je, JaxRequest), (te, Request)):
        t = {"now": 0.0}
        serving = engine.serving(max_slots=2, max_context=64,
                                 prefill_chunk=BS, clock=lambda: t["now"],
                                 spec_decode={"drafter": "ngram",
                                              "draft_k": 4})
        for r in _reqs(cls, prompts, (11, 7)):
            serving.submit(r)
        while serving.queue or serving.num_active:
            t["now"] += 1.0
            serving.step()
        snaps.append(serving.latency_snapshot())
        reg = serving.telemetry.registry.snapshot()
        assert reg["serving/spec_verify_steps"]["value"] == \
            serving.stats()["spec_decode"]["verify_steps"]
        assert "serving/spec_accept_rate" in reg
    assert snaps[1] == snaps[0]
    assert snaps[1]["tpot_ms"]["count"] == 11 + 7 + 11 - 3
