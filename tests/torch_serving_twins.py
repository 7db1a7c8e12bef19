"""Shared helpers of the port's serving-fabric parity tests
(`test_torch_router.py`, `test_torch_selfheal.py`, `test_torch_fabric.py`,
`test_torch_tracing.py`): one tiny fp32 GPT built by both packages from the
same numpy draw, and a namespace per package so one scenario function runs
against the JAX package and the port alike."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np

from deepspeed_tpu.comm import mesh as mesh_mod
from deepspeed_tpu.config.core import MeshConfig
from deepspeed_tpu.inference.engine import init_inference as jax_init
from deepspeed_tpu.models import gpt as jgpt

BS = 16     # kv_block_size == prefill_chunk, as in the JAX router tests
TINY = jgpt.GPTConfig(n_layer=2, n_head=4, d_model=64, max_seq_len=256,
                      vocab_size=256, dtype=jnp.float32, remat=False,
                      tie_embeddings=False)
CONF = {"dtype": "float32", "kv_cache_dtype": "float32", "greedy": True,
        "kv_block_size": BS, "max_out_tokens": 64}
TELEMETRY = {"enabled": True, "prometheus": False, "jsonl": False,
             "monitor_bridge": False}


def port_cfg(jcfg):
    from deepspeed_tpu_torch.models import gpt as tgpt
    names = [f.name for f in dataclasses.fields(tgpt.GPTConfig)
             if f.name not in ("dtype", "softmax_dtype", "remat",
                               "remat_policy", "use_flash_attention")]
    return tgpt.GPTConfig(**{n: getattr(jcfg, n) for n in names
                             if hasattr(jcfg, n)}, dtype="float32")


def reset_mesh():
    mesh_mod._CURRENT_MESH = None
    mesh_mod._CURRENT_SPEC = None
    mesh_mod.init_mesh(MeshConfig(data=1, tensor=1, sequence=1, expert=1,
                                  pipe=1))


def twin_engines(cfg=TINY, **conf):
    """(JAX InferenceEngine, port InferenceEngine on the CPU), same
    weights leaf for leaf."""
    from deepspeed_tpu_torch.inference.engine import init_inference
    from deepspeed_tpu_torch.models import gpt as tgpt
    reset_mesh()
    jspec = jgpt.make_gpt_decode_model(cfg=cfg, name="tiny")
    tspec = tgpt.make_gpt_decode_model(
        port_cfg(cfg), name="tiny", params=tgpt.params_from_jax(
            jax.tree_util.tree_map(np.asarray, jspec.params)))
    return (jax_init(model=jspec, config={**CONF, **conf}),
            init_inference(tspec, config={**CONF, **conf}, device="cpu"))


def package(engine, jax_side):
    """The serving surface of one package around `engine`."""
    if jax_side:
        from deepspeed_tpu.config.core import TelemetryConfig
        from deepspeed_tpu.inference import scheduler as sch
        from deepspeed_tpu import serving as srv
        from deepspeed_tpu.testing import chaos
    else:
        from deepspeed_tpu_torch.config.core import TelemetryConfig
        from deepspeed_tpu_torch.inference import scheduler as sch
        from deepspeed_tpu_torch import serving as srv
        from deepspeed_tpu_torch.testing import chaos

    def replica(**over):
        kw = dict(max_slots=2, max_context=96, prefill_chunk=BS,
                  enable_prefix_caching=True)
        kw.update(over)
        return engine.serving(**kw)

    return types.SimpleNamespace(
        jax=jax_side, engine=engine, Request=sch.Request,
        Inadmissible=sch.InadmissibleRequestError,
        ServingRouter=srv.ServingRouter,
        InProcessReplica=srv.InProcessReplica, chaos=chaos,
        TelemetryConfig=TelemetryConfig, replica=replica)


def shared_prefix_trace(rng, n, prefix_blocks=2, vocab=TINY.vocab_size):
    """Ragged prompts all starting with the same `prefix_blocks` full
    blocks (the shared-system-prompt workload affinity routing targets)."""
    prefix = rng.integers(0, vocab, (prefix_blocks * BS,)).astype(np.int32)
    tails = rng.integers(2, 14, (n,))
    return [np.concatenate([prefix,
                            rng.integers(0, vocab, (t,)).astype(np.int32)])
            for t in tails]


def outcome(res):
    """uid -> (tokens, finish_reason) of a run's completions."""
    return {uid: (np.asarray(d.tokens).tolist(), d.finish_reason)
            for uid, d in res.items()}
