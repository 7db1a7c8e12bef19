"""The port's automatic prefix caching held to the JAX package's: the
allocator's refcounts and reclaimable LRU, the hash chain, admission's
longest-prefix match and registration, fp32 on the CPU with the same
numpy-seeded weights. Tokens, hash chains, allocator traces and the
`stats()` counters must be EQUAL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.inference import kv_cache as jkv
from deepspeed_tpu.inference import prefix_cache as jpc
from deepspeed_tpu.inference.engine import init_inference as jax_init
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu.models import moe_gpt as jmoe
from deepspeed_tpu_torch.inference import kv_cache as tkv
from deepspeed_tpu_torch.inference import prefix_cache as tpc
from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.scheduler import Request
from deepspeed_tpu_torch.models import gpt as tgpt
from deepspeed_tpu_torch.models import moe_gpt as tmoe

BS = 16
LIVELY = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
                        vocab_size=256, dtype=jnp.float32, remat=False,
                        tie_embeddings=False)
CONF = {"dtype": "float32", "kv_cache_dtype": "float32", "greedy": True,
        "kv_block_size": BS, "max_out_tokens": 64}
BLOCKS = ("prefill_chunks", "decode_steps", "tokens_generated",
          "free_blocks", "reclaimable_blocks", "available_blocks",
          "prefix_cache")


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


def _twins(jcfg=LIVELY, name="tiny"):
    """(JAX engine, port engine) over the same weights."""
    _mk_mesh()
    jspec = jgpt.make_gpt_decode_model(cfg=jcfg, name=name)
    params = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jspec.params))
    tspec = tgpt.make_gpt_decode_model(_port_cfg(jcfg), name=name,
                                       params=params)
    return (jax_init(model=jspec, config=dict(CONF)),
            init_inference(tspec, config=dict(CONF), device="cpu"))


def _shared_prefix(rng, prefix_len, tails, vocab=256):
    prefix = rng.integers(0, vocab, (prefix_len,)).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, vocab, (t,))
                            .astype(np.int32)]) for t in tails]


def _run_both(je, te, waves, news, **kw):
    """Each wave of prompts through one JAX and one port serving engine,
    wave after wave; returns both engines and their results by uid."""
    js, ts = je.serving(**kw), te.serving(**kw)
    jout, tout = {}, {}
    for w, prompts in enumerate(waves):
        jout.update(js.run([JaxRequest(uid=(w, i), tokens=p,
                                       max_new_tokens=news[i % len(news)],
                                       stop_on_eos=False)
                            for i, p in enumerate(prompts)]))
        tout.update(ts.run([Request(uid=(w, i), tokens=p,
                                    max_new_tokens=news[i % len(news)],
                                    stop_on_eos=False)
                            for i, p in enumerate(prompts)]))
    return js, ts, jout, tout


def _same_results(jout, tout):
    assert sorted(jout) == sorted(tout)
    for uid in jout:
        np.testing.assert_array_equal(tout[uid].tokens, jout[uid].tokens)
        assert tout[uid].cached_prefix_tokens == \
            jout[uid].cached_prefix_tokens, uid
        assert tout[uid].finish_reason == jout[uid].finish_reason


def _same_stats(js, ts, keys=BLOCKS):
    jst, tst = js.stats(), ts.stats()
    for k in keys:
        assert tst.get(k) == jst.get(k), (k, tst.get(k), jst.get(k))


# ----------------------------------------------------------------------
# allocator: one scripted sequence through both packages
# ----------------------------------------------------------------------


def _allocator_trace(mod, policy):
    """alloc / incref / free / evict / flush on a 9-block pool with a
    cache hook; every return value, eviction and counter recorded."""
    cached, evicted, trace = set(), [], []
    alloc = mod.BlockAllocator(9, policy=policy)
    alloc.is_cached = cached.__contains__
    alloc.on_evict = evicted.append

    def note(op, ret=None):
        trace.append((op, ret, alloc.num_free, alloc.num_reclaimable,
                      alloc.available, alloc.evictions, list(evicted),
                      sorted(alloc._refs.items()), list(alloc._reclaimable)))

    a = alloc.alloc(3)
    note("alloc3", a)
    b = alloc.alloc(4)
    note("alloc4", b)
    note("alloc2-fails", alloc.alloc(2))
    note("incref", alloc.incref(a[0]))
    cached.update(a + b[:2])
    alloc.free(a[::-1])
    note("free-a")
    alloc.free(b[::-1])
    note("free-b")
    note("incref-parked", alloc.incref(b[0]) if b[0] in alloc._refs
         else None)
    note("alloc5", alloc.alloc(5))
    note("flush1", alloc.flush_reclaimable(keep=1))
    note("alloc1", alloc.alloc(1))
    alloc.free([a[0]])
    note("free-last-reader")
    note("flush", alloc.flush_reclaimable())
    return trace


@pytest.mark.parametrize("policy", ["lru", "none"])
def test_allocator_trace_equals_jax(policy):
    assert _allocator_trace(tkv, policy) == _allocator_trace(jkv, policy)


def test_allocator_guards_raise_value_errors():
    """The port's guards stay ValueErrors (JAX asserts)."""
    alloc = tkv.BlockAllocator(4)
    got = alloc.alloc(2)
    alloc.free(got)
    with pytest.raises(ValueError, match="double free"):
        alloc.free([got[0]])
    with pytest.raises(ValueError, match="trash"):
        alloc.free([tkv.TRASH_BLOCK])
    with pytest.raises(ValueError, match="incref"):
        alloc.incref(got[0])
    with pytest.raises(ValueError, match="policy"):
        tkv.BlockAllocator(4, policy="mru")


@pytest.mark.parametrize("args", [
    (14, 16, 6, 1, 0), (14, 16, 6, 1, 4), (14, 16, 6, 8, 4), (16, 16, 1, 1, 8),
    (14, 16, 6, 4, 0), (40, 48, 9, 1, 14), (5, 16, 1, 4, 0)])
def test_sizing_equals_jax(args):
    pl, padded, new, window, k = args
    assert tkv.max_written_pos(pl, padded, new, window, k) == \
        jkv.max_written_pos(pl, padded, new, window, k)
    for bs in (4, 16):
        assert tkv.blocks_needed(pl, padded, new, bs, window, k) == \
            jkv.blocks_needed(pl, padded, new, bs, window, k)


# ----------------------------------------------------------------------
# hash chain
# ----------------------------------------------------------------------


def _moe_cfgs():
    jcfg = jmoe.MoEGPTConfig(n_layer=2, n_head=4, d_model=64, d_ff=128,
                             max_seq_len=256, vocab_size=256,
                             dtype=jnp.float32, remat=False, num_experts=4,
                             moe_freq=2)
    return jcfg, _port_cfg(jcfg, tmoe.MoEGPTConfig)


@pytest.mark.parametrize("arch", ["gpt", "gpt_rotary_gqa_bf16", "moe"])
def test_hash_chain_byte_equal_to_jax(arch):
    if arch == "moe":
        jcfg, tcfg = _moe_cfgs()
        jfp = jmoe.moe_cache_identity(jcfg, "moe-tiny")
        tfp = tmoe.moe_cache_identity(tcfg, "moe-tiny")
    else:
        jcfg = LIVELY if arch == "gpt" else jgpt.GPTConfig(
            n_layer=8, n_head=8, n_kv_head=4, d_model=1024,
            max_seq_len=1024, use_rotary=True)
        tcfg = _port_cfg(jcfg) if arch == "gpt" else tgpt.GPTConfig(
            n_layer=8, n_head=8, n_kv_head=4, d_model=1024,
            max_seq_len=1024, use_rotary=True)
        jfp = jgpt.gpt_cache_identity(jcfg, "tiny")
        tfp = tgpt.gpt_cache_identity(tcfg, "tiny")
    assert tfp == jfp
    prompt = np.random.default_rng(3).integers(0, 50000, (100,))
    for bs in (16, 128):
        tchain = tpc.PrefixCache(tkv.BlockAllocator(4), bs,
                                 fingerprint=tfp).hash_chain(prompt)
        jchain = jpc.PrefixCache(jkv.BlockAllocator(4), bs,
                                 fingerprint=jfp).hash_chain(prompt)
        assert tchain == jchain and len(tchain) == 100 // bs


def test_specs_carry_the_fingerprint():
    jcfg, tcfg = _moe_cfgs()
    spec = tmoe.make_moe_gpt_decode_model(tcfg, name="m")
    assert spec.cache_fingerprint == jmoe.moe_cache_identity(jcfg, "m")
    assert spec.verify_paged_fn is not None
    spec = tgpt.make_gpt_decode_model(_port_cfg(LIVELY), name="tiny")
    assert spec.cache_fingerprint == jgpt.gpt_cache_identity(LIVELY, "tiny")
    assert tgpt.gpt_cache_identity(_port_cfg(LIVELY), "a") != \
        tgpt.gpt_cache_identity(
            dataclasses.replace(_port_cfg(LIVELY), use_rotary=True), "a")


def test_match_register_first_writer_wins():
    cache = tpc.PrefixCache(tkv.BlockAllocator(8), 4, fingerprint="x")
    chain = cache.hash_chain(np.arange(12))
    assert cache.register(chain[0], 3) and cache.register(chain[1], 5)
    assert not cache.register(chain[0], 6)          # first writer wins
    assert not cache.register(chain[2], 5)          # block already named
    assert cache.match(chain) == [3, 5] and cache.match_len(chain) == 2
    assert cache.num_cached == 2
    assert cache.snapshot() == {chain[0].hex(): 3, chain[1].hex(): 5}
    assert cache.reverse_snapshot() == {3: chain[0].hex(), 5: chain[1].hex()}
    cache._unregister_block(3)
    assert cache.match(chain) == [] and cache.match_len(chain[1:]) == 1


# ----------------------------------------------------------------------
# the serving engine: tokens and counters equal to JAX's
# ----------------------------------------------------------------------


@pytest.mark.parametrize("caching", [False, True], ids=["off", "on"])
def test_served_tokens_and_stats_equal_jax(caching):
    """A cold wave and a warm wave of shared-prefix prompts (two blocks of
    shared prefix, ragged tails; requests admitted together before any
    registered, so the first writer wins), caching off and on: tokens,
    cached prefix tokens, prefill chunks and the prefix_cache block equal
    JAX's; caching on, the warm wave runs fewer chunks."""
    je, te = _twins()
    rng = np.random.default_rng(22)
    prompts = _shared_prefix(rng, 2 * BS, (3, 9, 14, 5, 20, 1))
    js, ts, jout, tout = _run_both(
        je, te, [prompts, prompts], (6, 4, 9),
        max_slots=3, max_context=96, prefill_chunk=BS,
        enable_prefix_caching=caching)
    _same_results(jout, tout)
    _same_stats(js, ts)
    assert ("prefix_cache" in ts.stats()) == caching
    for w in (0, 1):
        ref = te.generate(prompts[2][None], max_new_tokens=9,
                          stop_on_eos=False)[0]
        np.testing.assert_array_equal(tout[w, 2].tokens, ref)
    if caching:
        st = ts.stats()["prefix_cache"]
        assert st["hit_blocks"] > 0 and st["prefill_chunks_skipped"] > 0
        assert all(tout[1, i].cached_prefix_tokens >= 2 * BS
                   for i in range(6))
        assert ts.allocator.available == ts.allocator.capacity
        assert ts.audit().ok


def test_eviction_under_pressure_equals_jax():
    """An oversubscribed pool (3 usable blocks, each request needs 3):
    the second request is admitted by evicting the first one's cached
    blocks, oldest first — evictions and tokens equal JAX's."""
    je, te = _twins()
    rng = np.random.default_rng(23)
    p1 = rng.integers(0, 256, (40,)).astype(np.int32)
    p2 = rng.integers(0, 256, (40,)).astype(np.int32)
    js, ts, jout, tout = _run_both(
        je, te, [[p1], [p2], [p1]], (4,), max_slots=1, max_context=48,
        prefill_chunk=BS, num_kv_blocks=4, enable_prefix_caching=True)
    _same_results(jout, tout)
    _same_stats(js, ts)
    assert ts.stats()["prefix_cache"]["evictions"] >= 2


@pytest.mark.parametrize("policy", ["lru", "none"])
def test_block_edge_and_chunk_grid_equal_jax(policy):
    """A prompt exactly on a block edge (an identical re-prompt hits k-1
    blocks, a longer one all k), then prefill_chunk 32 over 16-token
    blocks (the hit cut to whole chunks), under both reclaim policies."""
    je, te = _twins()
    rng = np.random.default_rng(24)
    edge = rng.integers(0, 256, (2 * BS,)).astype(np.int32)
    longer = np.concatenate([edge, rng.integers(0, 256, (10,))
                             .astype(np.int32)])
    js, ts, jout, tout = _run_both(
        je, te, [[edge], [edge], [longer]], (4,), max_slots=1,
        max_context=96, prefill_chunk=BS, enable_prefix_caching=True,
        prefix_cache_policy=policy)
    _same_results(jout, tout)
    _same_stats(js, ts)
    if policy == "lru":
        assert [tout[w, 0].cached_prefix_tokens for w in range(3)] == \
            [0, BS, 2 * BS]
    prompt = rng.integers(0, 256, (58,)).astype(np.int32)
    js, ts, jout, tout = _run_both(
        je, te, [[prompt], [prompt]], (4,), max_slots=1, max_context=96,
        prefill_chunk=32, enable_prefix_caching=True,
        prefix_cache_policy=policy)
    _same_results(jout, tout)
    _same_stats(js, ts)


def test_moe_served_tokens_with_caching_equal_jax():
    jcfg, tcfg = _moe_cfgs()
    mesh_mod.clear_mesh()
    jspec = jmoe.make_moe_gpt_decode_model(cfg=jcfg, name="moe-tiny")
    te = init_inference(tmoe.make_moe_gpt_decode_model(
        tcfg, name="moe-tiny", params=tgpt.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jspec.params))),
        config=dict(CONF), device="cpu")
    je = jax_init(model=jspec, config=dict(CONF))
    rng = np.random.default_rng(25)
    prompts = _shared_prefix(rng, 2 * BS, (3, 9, 5))
    js, ts, jout, tout = _run_both(
        je, te, [prompts, prompts], (5, 3), max_slots=2, max_context=64,
        prefill_chunk=BS, enable_prefix_caching=True)
    mesh_mod.clear_mesh()
    _same_results(jout, tout)
    _same_stats(js, ts)


def test_router_surface_and_monitor_events():
    """hash_chain / prefix_affinity (read-only) and the monitor events,
    against JAX's on the same trace."""
    je, te = _twins()
    rng = np.random.default_rng(27)
    prompts = _shared_prefix(rng, 3 * BS, (4, 7))
    js, ts, _, _ = _run_both(je, te, [prompts], (3,), max_slots=2,
                             max_context=96, prefill_chunk=BS,
                             enable_prefix_caching=True)
    probe = _shared_prefix(np.random.default_rng(27), 3 * BS, (30,))[0]
    assert ts.hash_chain(probe) == js.hash_chain(probe)
    chain = ts.hash_chain(probe)
    before = ts.allocator.num_reclaimable
    assert ts.prefix_affinity(chain) == js.prefix_affinity(chain) == 3
    assert ts.allocator.num_reclaimable == before
    off = te.serving(max_slots=1, max_context=96, prefill_chunk=BS)
    assert off.hash_chain(probe) is None and off.prefix_affinity(chain) == 0

    class Capture:
        enabled = True

        def __init__(self):
            self.events = []

        def write_events(self, ev):
            self.events.extend(ev)

    tcap, jcap = Capture(), Capture()
    ts.write_monitor_events(tcap)
    js.write_monitor_events(jcap)
    assert tcap.events == jcap.events and len(tcap.events) == 3

    class Broken(Capture):
        def write_events(self, ev):
            raise OSError("disk full")

    ts.write_monitor_events(Broken())               # guarded: no raise
