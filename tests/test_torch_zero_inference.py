"""The port's ZeRO-Inference engine (`inference/zero_inference.py`, the
layered GPT of `models/gpt.py`, the scheduler's streamed mode) held to the
JAX package's `ZeroInferenceEngine` and to the port's resident engines on
the same numpy-seeded weights, fp32 on the CPU, on both weight tiers.

Tolerances: prefill logits atol 1e-5 against JAX (fp32, other orders of
sums); generated and served tokens identical (greedy); the streamed
serving's `stats()["offload"]` counters equal to JAX's.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.inference.engine import init_inference as jinit
from deepspeed_tpu.inference.scheduler import Request as JRequest
from deepspeed_tpu.models import gpt as jgpt
from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.scheduler import Request
from deepspeed_tpu_torch.inference.zero_inference import ZeroInferenceEngine
from deepspeed_tpu_torch.models import gpt as tgpt

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the AIO library builds with g++")
JCFG = jgpt.GPTConfig(n_layer=4, n_head=4, d_model=64, max_seq_len=128,
                      vocab_size=256, dtype=jnp.float32, remat=False)
TCFG = tgpt.GPTConfig(n_layer=4, n_head=4, d_model=64, max_seq_len=128,
                      vocab_size=256, dtype="float32", remat=False)
LOGIT_ATOL = 1e-5
ENGINE = {"dtype": "float32", "kv_cache_dtype": "float32", "greedy": True,
          "kv_block_size": 16, "max_out_tokens": 128}


def _params():
    return jax.tree_util.tree_map(np.asarray,
                                  jgpt.init_gpt_params(JCFG, seed=0))


def _offload(tier, tmp_path, side, lookahead=1):
    off = {"device": tier, "lookahead": lookahead}
    if tier == "nvme":
        off["nvme_path"] = str(tmp_path / side)
    return {**ENGINE, "zero": {"offload_param": off}}


def _jax_engine(params, tier, tmp_path, lookahead=1):
    mesh_mod._CURRENT_MESH = None
    mesh_mod._CURRENT_SPEC = None
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))
    return jinit(model=jgpt.make_gpt_layered_model(cfg=JCFG, params=params),
                 config=_offload(tier, tmp_path, "j", lookahead))


def _port_engine(params, tier, tmp_path, lookahead=1, **extra):
    return init_inference(
        model=tgpt.make_gpt_layered_model(TCFG,
                                          params=tgpt.params_from_jax(params)),
        config={**_offload(tier, tmp_path, "t", lookahead), **extra},
        device="cpu")


def _resident(params, **extra):
    return init_inference(
        model=tgpt.make_gpt_decode_model(TCFG,
                                         params=tgpt.params_from_jax(params)),
        config={**ENGINE, **extra}, device="cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_prefill_logits_match_jax(tier, tmp_path):
    params = _params()
    jeng = _jax_engine(params, tier, tmp_path)
    teng = _port_engine(params, tier, tmp_path)
    assert isinstance(teng, ZeroInferenceEngine)
    toks = np.stack(_prompts(0, [12, 12]))
    jl, _ = jeng.forward(toks, max_len=32)
    tl, _ = teng.forward(toks, max_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    jeng.release()
    teng.release()


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_generated_tokens_equal_jax_and_the_resident_engine(tier, tmp_path):
    params = _params()
    jeng = _jax_engine(params, tier, tmp_path)
    teng = _port_engine(params, tier, tmp_path)
    res = _resident(params)
    toks = np.stack(_prompts(1, [9, 9, 9]))
    out = teng.generate(toks, max_new_tokens=8)
    np.testing.assert_array_equal(out, jeng.generate(toks, max_new_tokens=8))
    np.testing.assert_array_equal(
        out, res.generate(toks, max_new_tokens=8, stop_on_eos=False))
    # the cache template is reused on a shape match, tokens unchanged
    toks2 = np.stack(_prompts(2, [9, 9, 9]))
    np.testing.assert_array_equal(
        teng.generate(toks2, max_new_tokens=8),
        res.generate(toks2, max_new_tokens=8, stop_on_eos=False))
    assert teng._cache_hits == 1
    assert teng.streamer.peak_live_layers <= 2
    assert teng.peak_param_hbm_bytes <= 2 * teng.store.layer_bytes
    assert teng.total_param_bytes >= 2 * teng.peak_param_hbm_bytes
    jeng.release()
    teng.release()


SERVE_LENS = [9, 23, 5, 17, 31, 12]


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_streamed_serving_tokens_and_offload_stats_equal_jax(tier,
                                                             tmp_path):
    params = _params()
    prompts = _prompts(4, SERVE_LENS)
    kw = dict(max_slots=4, max_context=128, prefill_chunk=16)
    jeng = _jax_engine(params, tier, tmp_path, lookahead=2)
    jserv = jeng.serving(**kw)
    jout = jserv.run([JRequest(uid=i, tokens=p, max_new_tokens=8,
                               stop_on_eos=False)
                      for i, p in enumerate(prompts)])
    teng = _port_engine(params, tier, tmp_path, lookahead=2)
    serv = teng.serving(**kw)
    reqs = [Request(uid=i, tokens=p, max_new_tokens=8, stop_on_eos=False)
            for i, p in enumerate(prompts)]
    out = serv.run(reqs)
    ref = _resident(params).serving(**kw).run(reqs)
    for u in range(len(prompts)):
        np.testing.assert_array_equal(out[u].tokens, jout[u].tokens)
        np.testing.assert_array_equal(out[u].tokens, ref[u].tokens)
    st, jst = serv.stats()["offload"], jserv.stats()["offload"]
    for k in ("acquires", "hits", "uploads", "peak_live_layers"):
        assert st["staging"][k] == jst["staging"][k], k
    for k in ("layer_bytes", "host_param_bytes", "staged_peak_bytes",
              "resident_param_bytes"):
        assert st[k] == jst[k], k
    assert serv.allocator.num_free == serv.allocator.num_blocks - 1
    jeng.release()
    teng.release()


def test_streamed_int8_pool_serves_the_resident_int8_tokens(tmp_path):
    """The int8 pool in the streamed mode: the same quantized writes and
    dequantizing attention as the resident int8 serving engine (and JAX's
    streamed int8 pool), token for token."""
    params = _params()
    prompts = _prompts(5, [7, 19, 26, 11])
    kw = dict(max_slots=2, max_context=96, prefill_chunk=16,
              quantization={"kv_cache_dtype": "int8"})
    reqs = [Request(uid=i, tokens=p, max_new_tokens=6, stop_on_eos=False)
            for i, p in enumerate(prompts)]
    teng = _port_engine(params, "cpu", tmp_path)
    serv = teng.serving(**kw)
    assert serv.kv_quant and "k_scale" in serv.pool
    out = serv.run(reqs)
    ref = _resident(params).serving(**kw).run(reqs)
    jeng = _jax_engine(params, "cpu", tmp_path)
    jout = jeng.serving(**kw).run([JRequest(uid=r.uid, tokens=r.tokens,
                                            max_new_tokens=6,
                                            stop_on_eos=False)
                                   for r in reqs])
    for u in range(len(prompts)):
        np.testing.assert_array_equal(out[u].tokens, ref[u].tokens)
        np.testing.assert_array_equal(out[u].tokens, jout[u].tokens)


@pytest.mark.parametrize("override,match", [
    ({"spec_decode": {"drafter": "ngram"}}, "[Ss]peculative"),
    ({"decode_steps_per_sync": 4}, "decode_steps_per_sync"),
    ({"quantization": {"weights": "int8"}}, "resident"),
], ids=["spec_decode", "window", "woq"])
def test_streamed_serving_refuses_resident_only_features(override, match,
                                                         tmp_path):
    teng = _port_engine(_params(), "cpu", tmp_path)
    with pytest.raises(ValueError, match=match):
        teng.serving(max_slots=2, max_context=64, **override)
    with pytest.raises(ValueError, match="resident"):
        teng.enable_weight_quant()


def test_offload_param_with_a_decode_spec_raises_like_jax(tmp_path):
    with pytest.raises(ValueError, match="needs a LayeredModelSpec"):
        init_inference(
            model=tgpt.make_gpt_decode_model(TCFG), device="cpu",
            config=_offload("cpu", tmp_path, "t"))
