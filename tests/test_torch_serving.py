"""The PyTorch port's serving path held to the JAX package's: `generate()`
and the continuous-batching `ServingEngine` over the paged pool, fp32 on
the CPU with the same numpy-seeded weights. Greedy tokens must be
IDENTICAL. The model unties its LM head so greedy rollouts wander instead
of repeating the last prompt token (a tied random head copies its input),
which makes token identity a discriminating check.

Also the allocator / sizing math, retirement, backpressure and refusal
cases of tests/test_serving.py, against the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.inference.engine import init_inference as jax_init
from deepspeed_tpu.inference.scheduler import Request as JaxRequest
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.inference.engine import (init_inference,
                                                  sample_logits)
from deepspeed_tpu_torch.inference.kv_cache import (BlockAllocator,
                                                    TRASH_BLOCK,
                                                    blocks_needed)
from deepspeed_tpu_torch.inference.scheduler import (InadmissibleRequestError,
                                                     Request)
from deepspeed_tpu_torch.models import gpt as tgpt

LIVELY = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
                        vocab_size=256, dtype=jnp.float32, remat=False,
                        tie_embeddings=False)
CONF = {"dtype": "float32", "kv_cache_dtype": "float32", "greedy": True,
        "kv_block_size": 16, "max_out_tokens": 64}
TRACE = (5, 11, 3, 8, 14, 2, 31, 17)     # tests/test_serving.py's trace


def _mk_mesh():
    mesh_mod._CURRENT_MESH = None
    mesh_mod._CURRENT_SPEC = None
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def _port_spec(jspec, jcfg, **over):
    kw = dict(n_layer=jcfg.n_layer, n_head=jcfg.n_head,
              d_model=jcfg.d_model, max_seq_len=jcfg.max_seq_len,
              vocab_size=jcfg.vocab_size,
              tie_embeddings=jcfg.tie_embeddings, dtype="float32", **over)
    params = tgpt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jspec.params))
    return tgpt.make_gpt_decode_model(tgpt.GPTConfig(**kw), name="tiny",
                                      params=params)


def _engines(jcfg=LIVELY, **port_cfg):
    """(JAX engine, port engine) over the same weights."""
    _mk_mesh()
    jspec = jgpt.make_gpt_decode_model(cfg=jcfg, name="tiny")
    return (jax_init(model=jspec, config=dict(CONF)),
            init_inference(_port_spec(jspec, jcfg, **port_cfg),
                           config=dict(CONF), device="cpu"))


def _port_engine(**over):
    _mk_mesh()
    jspec = jgpt.make_gpt_decode_model(cfg=LIVELY, name="tiny")
    return init_inference(_port_spec(jspec, LIVELY), config={**CONF, **over},
                          device="cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, LIVELY.vocab_size, (n,)).astype(np.int32)
            for n in lens]


# ----------------------------------------------------------------------
# token identity with the JAX package
# ----------------------------------------------------------------------


@pytest.mark.parametrize("forced_kernels", [False, True],
                         ids=["dense", "kernel_programs"])
def test_generate_tokens_identical_to_jax(forced_kernels):
    """Ragged prompts, then EOS semantics: the eos is kept and every later
    slot is pad_token_id, row by row."""
    je, te = _engines(use_flash_attention=True if forced_kernels else None)
    prompts = _prompts(1, (5, 11, 3, 8))
    free_j = je.generate(prompts, max_new_tokens=10, stop_on_eos=False)
    free_t = te.generate(prompts, max_new_tokens=10, stop_on_eos=False)
    np.testing.assert_array_equal(free_t, free_j)
    assert len(set(free_t[0].tolist())) > 3, "rollout should wander"
    eos = int(free_j[1, 4])
    kw = dict(max_new_tokens=10, eos_token_id=eos, pad_token_id=255)
    out_j, out_t = je.generate(prompts, **kw), te.generate(prompts, **kw)
    np.testing.assert_array_equal(out_t, out_j)
    hit = int(np.flatnonzero(free_t[1] == eos)[0])
    assert out_t[1, hit] == eos and (out_t[1, hit + 1:] == 255).all()


@pytest.mark.parametrize("window", [1, 4])
def test_serving_tokens_identical_to_jax_serving_and_generate(window):
    """The ragged trace through both packages' continuous-batching engines
    (chunked prefill + paged decode) and the port's static generate()."""
    je, te = _engines()
    prompts = _prompts(1, TRACE)
    kw = dict(max_slots=3, max_context=64, prefill_chunk=16,
              decode_steps_per_sync=window)
    jres = je.serving(**kw).run(
        [JaxRequest(uid=i, tokens=p, max_new_tokens=3 + i % 5,
                    stop_on_eos=False) for i, p in enumerate(prompts)])
    serving = te.serving(**kw)
    tres = serving.run([Request(uid=i, tokens=p, max_new_tokens=3 + i % 5,
                                stop_on_eos=False)
                        for i, p in enumerate(prompts)])
    assert sorted(tres) == list(range(len(prompts)))
    for i, p in enumerate(prompts):
        ref = te.generate(p[None], max_new_tokens=3 + i % 5,
                          stop_on_eos=False)[0]
        np.testing.assert_array_equal(tres[i].tokens, jres[i].tokens)
        np.testing.assert_array_equal(tres[i].tokens, ref)
        assert tres[i].finish_reason == "length"
    assert serving.allocator.num_free == serving.allocator.capacity


# ----------------------------------------------------------------------
# allocator + sizing math
# ----------------------------------------------------------------------


def test_block_allocator_free_list_and_refcounts():
    alloc = BlockAllocator(8)            # block 0 reserved
    assert alloc.capacity == 7
    a, b = alloc.alloc(3), alloc.alloc(4)
    assert TRASH_BLOCK not in a + b and len(set(a + b)) == 7
    assert alloc.alloc(1) is None        # exhausted: all-or-nothing
    alloc.free(a)
    assert alloc.num_free == 3
    assert sorted(alloc.alloc(3)) == sorted(a)   # freed blocks are reused
    with pytest.raises(ValueError, match="double free"):
        alloc.free([b[0], b[0]])
    alloc.incref(b[1])                   # a second reader
    alloc.free([b[1]])
    assert alloc.refcount(b[1]) == 1 and b[1] not in alloc._free_set
    alloc.free([b[1]])
    assert alloc.refcount(b[1]) == 0 and alloc.num_free == 2
    with pytest.raises(ValueError, match="trash"):
        alloc.free([TRASH_BLOCK])


def test_blocks_needed_math():
    assert blocks_needed(5, 16, 4, 16) == 1
    assert blocks_needed(14, 16, 6, 16) == 2
    assert blocks_needed(16, 16, 1, 16) == 1
    assert blocks_needed(14, 16, 6, 16, window=8) == 2
    assert blocks_needed(14, 16, 12, 16, window=8) == 2
    assert blocks_needed(14, 16, 20, 16, window=8) == 3


# ----------------------------------------------------------------------
# lifecycle: retirement, backpressure, refusal, cancellation
# ----------------------------------------------------------------------


def test_eos_retirement_frees_slot_and_blocks_immediately():
    engine = _port_engine()
    prompt = _prompts(3, (6,))[0]
    free = engine.generate(prompt[None], max_new_tokens=8,
                           stop_on_eos=False)[0]
    eos = int(free[2])
    serving = engine.serving(max_slots=1, max_context=64, prefill_chunk=16)
    res = serving.run([Request(uid="a", tokens=prompt, max_new_tokens=8,
                               eos_token_id=eos)])
    out = res["a"].tokens
    assert res["a"].finish_reason == "eos"
    hit = int(np.flatnonzero(free == eos)[0])
    np.testing.assert_array_equal(out, free[:hit + 1])
    assert serving.allocator.num_free == serving.allocator.capacity
    res2 = serving.run([Request(uid="b", tokens=prompt, max_new_tokens=4,
                                stop_on_eos=False)])
    np.testing.assert_array_equal(res2["b"].tokens, free[:4])


def test_pool_exhaustion_backpressure():
    """A pool sized for one request at a time: the rest WAIT in the queue
    and complete, in order, as blocks free up."""
    engine = _port_engine()
    prompts = _prompts(4, (17, 20, 18))
    serving = engine.serving(max_slots=3, max_context=48, prefill_chunk=16,
                             num_kv_blocks=4)
    res = serving.run([Request(uid=i, tokens=p, max_new_tokens=6,
                               stop_on_eos=False)
                       for i, p in enumerate(prompts)])
    assert sorted(res) == [0, 1, 2]
    assert serving.peak_active == 1
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            res[i].tokens,
            engine.generate(p[None], max_new_tokens=6, stop_on_eos=False)[0])
    assert serving.allocator.num_free == serving.allocator.capacity


def test_submit_rejects_impossible_requests():
    engine = _port_engine()
    serving = engine.serving(max_slots=2, max_context=32, prefill_chunk=16)
    with pytest.raises(InadmissibleRequestError, match="max_context"):
        serving.submit(Request(uid=0, tokens=list(range(30)),
                               max_new_tokens=16))
    with pytest.raises(InadmissibleRequestError, match="empty prompt"):
        serving.submit(Request(uid=1, tokens=[], max_new_tokens=4))
    small = engine.serving(max_slots=1, max_context=64, prefill_chunk=16,
                           num_kv_blocks=2)
    with pytest.raises(InadmissibleRequestError, match="KV blocks"):
        small.submit(Request(uid=2, tokens=list(range(40)),
                             max_new_tokens=8))
    with pytest.raises(ValueError, match="position table"):
        engine.serving(max_context=512)


def test_cancel_queued_and_active_requests():
    engine = _port_engine()
    serving = engine.serving(max_slots=1, max_context=64, prefill_chunk=16)
    p = _prompts(7, (9, 9))
    serving.submit(Request(uid="a", tokens=p[0], max_new_tokens=20,
                           stop_on_eos=False))
    serving.submit(Request(uid="b", tokens=p[1], max_new_tokens=20,
                           stop_on_eos=False))
    serving.step()       # prefill emits token 1, the decode step token 2
    serving.step()       # token 3
    queued = serving.cancel("b")
    assert queued.finish_reason == "cancelled" and len(queued.tokens) == 0
    active = serving.cancel("a")
    assert active.finish_reason == "cancelled" and len(active.tokens) == 3
    assert serving.cancel("nope") is None
    assert serving.allocator.num_free == serving.allocator.capacity
    assert serving.stats()["cancelled"] == 2 and serving.num_active == 0


def test_serving_interleaves_prefill_with_decode():
    """A long prompt arriving mid-flight prefills chunk by chunk while the
    running request keeps emitting one token per step."""
    engine = _port_engine(max_out_tokens=96)
    short, long = _prompts(5, (4, 60))
    serving = engine.serving(max_slots=2, max_context=96, prefill_chunk=16)
    serving.submit(Request(uid="short", tokens=short, max_new_tokens=12,
                           stop_on_eos=False))
    serving.step()
    before = len(serving.slots[1].emitted or serving.slots[0].emitted)
    serving.submit(Request(uid="long", tokens=long, max_new_tokens=2,
                           stop_on_eos=False))
    done = {}
    for _ in range(4):
        for f in serving.step():
            done[f.uid] = f
    slot = [s for s in serving.slots if s.uid == "short"][0]
    assert len(slot.emitted) == before + 4
    while serving.num_active or serving.queue:
        for f in serving.step():
            done[f.uid] = f
    for uid, p, n in (("short", short, 12), ("long", long, 2)):
        np.testing.assert_array_equal(
            done[uid].tokens,
            engine.generate(p[None], max_new_tokens=n, stop_on_eos=False)[0])


# ----------------------------------------------------------------------
# engine satellites: cache reuse, sampling
# ----------------------------------------------------------------------


def test_engine_reuses_kv_cache_across_calls():
    engine = _port_engine()
    toks = np.random.default_rng(10).integers(0, 256, (2, 8))
    first = engine.generate(toks, max_new_tokens=4, stop_on_eos=False)
    hits = engine._cache_hits
    again = engine.generate(toks, max_new_tokens=4, stop_on_eos=False)
    assert engine._cache_hits == hits + 1
    np.testing.assert_array_equal(again, first)   # in-place reuse is exact
    engine.forward(toks)
    h = engine._cache_hits
    engine.forward(toks)
    assert engine._cache_hits == h + 1


def test_sample_logits_filters():
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]])).repeat(64, 1)
    gen = torch.Generator().manual_seed(0)
    assert (sample_logits(logits, None) == 0).all()
    top_p = sample_logits(logits, gen, greedy=False, top_p=0.6)
    assert set(top_p.tolist()) <= {0, 1} and len(set(top_p.tolist())) == 2
    top_k = sample_logits(logits, gen, greedy=False, top_k=3)
    assert set(top_k.tolist()) <= {0, 1, 2}
    argmax = sample_logits(logits, gen, greedy=False, top_p=0.0)
    assert (argmax == 0).all() and argmax.dtype == torch.int32
