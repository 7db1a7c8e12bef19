"""The port's spill tier (`runtime/param_swap.py`) and host-ward landing
pipe (`runtime/offload_staging.py`) held to the JAX package's: store round
trips on the cpu and nvme tiers, the write budget, the streamer's counters
on the same layer walks, and the pipe's bounded landing. The device here is
the CPU (a streamed layer is a copy of the host one)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.offload_staging import HostwardPipe as JPipe
from deepspeed_tpu.runtime.param_swap import LayerParamStore as JStore
from deepspeed_tpu.runtime.param_swap import LayerStreamer as JStreamer
from deepspeed_tpu_torch.runtime.offload_staging import HostwardPipe
from deepspeed_tpu_torch.runtime.param_swap import (LayerParamStore,
                                                    LayerStreamer)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the AIO library builds with g++")
L = 6


def _stacked(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 1, (L, 8, 16)).astype(np.float32),
            "b": rng.normal(0, 1, (L, 5)).astype(np.float32)}


def _stores(tier, tmp_path, **kw):
    stacked = _stacked()
    j = JStore({k: jnp.asarray(v) for k, v in stacked.items()}, device=tier,
               swap_folder=str(tmp_path / "j") if tier == "nvme" else None,
               **kw)
    t = LayerParamStore({k: torch.from_numpy(v) for k, v in stacked.items()},
                        device=tier,
                        swap_folder=str(tmp_path / "t")
                        if tier == "nvme" else None, **kw)
    return stacked, j, t


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_store_round_trips(tier, tmp_path):
    stacked, jstore, store = _stores(tier, tmp_path)
    assert store.layer_bytes == jstore.layer_bytes
    assert store.host_bytes == jstore.host_bytes
    for i in (0, 3, L - 1, 2):
        got = store.get_tree(i)
        for k in stacked:
            assert np.array_equal(got[k].numpy(), stacked[k][i])
    new = [torch.full((8, 16), -1.0), torch.full((5,), 7.0)]   # a, b
    store.put(2, new, blocking=True)
    got = store.get_tree(2)
    assert torch.equal(got["a"], new[0]) and torch.equal(got["b"], new[1])
    store.release()
    jstore.release()


def test_the_write_budget_flushes_like_jax(tmp_path):
    _, jstore, store = _stores("nvme", tmp_path, max_write_bytes=1)
    for s, leaves in ((jstore, [np.zeros((8, 16), np.float32),
                                np.zeros((5,), np.float32)]),
                      (store, [torch.zeros(8, 16), torch.zeros(5)])):
        s.put(0, leaves)                  # past a 1-byte budget: flushes
        assert s.write_flushes == 1 and s.pending_write_bytes == 0
    _, jstore, store = _stores("nvme", tmp_path / "u", max_write_bytes=0)
    for s, leaves in ((jstore, [np.zeros((8, 16), np.float32),
                                np.zeros((5,), np.float32)]),
                      (store, [torch.zeros(8, 16), torch.zeros(5)])):
        s.put(0, leaves)                  # unbounded: waits for the flush
        s.put(1, leaves)
        assert s.write_flushes == 0
        assert s.pending_write_bytes == 2 * s.layer_bytes
        s.flush_writes()
        assert s.write_flushes == 1 and s.pending_write_bytes == 0
    assert torch.equal(store.get_tree(1)["a"], torch.zeros(8, 16))


def _walk(streamer, walk):
    for i, direction in walk:
        streamer.layer(i, direction=direction)
    return {k: v for k, v in streamer.stats().items()
            if k in ("acquires", "hits", "uploads", "peak_live_layers")}


FWD = [(i, 1) for i in range(L)]
BWD = [(i, -1) for i in reversed(range(L))]


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
@pytest.mark.parametrize("lookahead", [0, 1, 2])
@pytest.mark.parametrize("walk,cyclic", [
    (FWD, False), (FWD + BWD, False), (FWD + FWD + FWD, True)],
    ids=["forward", "forward_then_reverse", "cyclic"])
def test_streamer_counters_equal_jax_on_the_same_walk(tier, lookahead, walk,
                                                      cyclic, tmp_path):
    stacked, jstore, store = _stores(tier, tmp_path)
    js = JStreamer(jstore, lookahead=lookahead, cyclic=cyclic)
    ts = LayerStreamer(store, lookahead=lookahead, cyclic=cyclic)
    assert _walk(ts, walk) == _walk(js, walk)
    assert ts.peak_live_layers <= lookahead + 1
    got = ts.layer(3)
    assert np.array_equal(got["a"].numpy(), stacked["a"][3])
    store.release()
    jstore.release()


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_hostward_pipe_lands_a_bounded_window_like_jax(depth):
    rng = np.random.default_rng(0)
    trees = [{"g": rng.normal(0, 1, (7,)).astype(np.float32)}
             for _ in range(5)]
    jp, tp = JPipe(depth=depth), HostwardPipe(depth=depth)
    for i, t in enumerate(trees):
        jout = jp.submit(i, {"g": jnp.asarray(t["g"])})
        tout = tp.submit(i, {"g": torch.from_numpy(t["g"])})
        assert [k for k, _ in tout] == [k for k, _ in jout]
        assert len(tp) == len(jp) <= depth
        for (_, a), (_, b) in zip(tout, jout):
            assert np.array_equal(a["g"].numpy(), np.asarray(b["g"]))
    assert [k for k, _ in tp.drain()] == [k for k, _ in jp.drain()]
    ts, js = tp.stats(), jp.stats()
    assert ts["landings"] == js["landings"] == 5
    assert ts["bytes_total"] == js["bytes_total"]
    assert ts["in_flight"] == js["in_flight"] == 0
    # a bare tensor lands as a tensor
    (_, flat), = HostwardPipe(depth=0).submit("x", torch.ones(3))
    assert torch.equal(flat, torch.ones(3))


def test_moe_expert_store_streams_experts_like_jax():
    """`models/moe_gpt.py::moe_expert_store`: one MoE layer's experts as a
    store, streamed cyclically: the same weights and counters as JAX's."""
    import jax
    from deepspeed_tpu.models import moe_gpt as jmoe
    from deepspeed_tpu_torch.models import moe_gpt as tmoe
    from deepspeed_tpu_torch.models.gpt import params_from_jax
    jcfg = jmoe.MoEGPTConfig(n_layer=2, n_head=4, d_model=64, d_ff=128,
                             max_seq_len=64, vocab_size=256,
                             dtype=jnp.float32, num_experts=4, moe_freq=2)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jmoe.init_moe_gpt_params(jcfg, seed=0))
    layer_id = jcfg.moe_layer_ids()[0]
    jstore, _ = jmoe.moe_expert_store(jparams, layer_id)
    store, experts = tmoe.moe_expert_store(params_from_jax(jparams),
                                           layer_id)
    assert store.num_layers == jstore.num_layers == 4
    walk = [(e, 1) for e in range(4)] * 2
    js = JStreamer(jstore, lookahead=1, cyclic=True)
    ts = LayerStreamer(store, lookahead=1, cyclic=True)
    assert _walk(ts, walk) == _walk(js, walk)
    assert ts.hits > 0 and ts.peak_live_layers <= 2
    for e in range(4):
        got = ts.layer(e)
        for k, v in experts.items():
            assert torch.equal(got[k], v[e])


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
@pytest.mark.parametrize("lookahead", [0, 1, 2])
def test_the_streamer_reuses_a_ring_of_lookahead_plus_one_layers(
        tier, lookahead, tmp_path):
    """The device copies live in `lookahead + 1` buffer sets the streamer
    owns, whatever the depth and the walk: every acquisition returns one
    of them, holding the right layer though the sets are refilled."""
    stacked, jstore, store = _stores(tier, tmp_path)
    ts = LayerStreamer(store, lookahead=lookahead)
    ptrs = set()
    for i, direction in FWD + BWD + FWD:
        got = ts.layer(i, direction=direction)
        ptrs.add(got["a"].data_ptr())
        for k in stacked:
            assert np.array_equal(got[k].numpy(), stacked[k][i])
    assert len(ptrs) == lookahead + 1
    assert ts.device_bytes == (lookahead + 1) * store.layer_bytes
    ts.release()
    assert ts.device_bytes == 0
    store.release()
    jstore.release()
