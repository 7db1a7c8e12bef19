"""Shared tiny serving-engine factory for the multi-process fabric
(counterpart of `deepspeed_tpu/testing/fabric.py`).

The fabric's tests and chip_smoke's fabric phase need the SAME engine on
both sides of a process boundary: parameters are drawn from numpy with
`seed` (the JAX package's draw), so a replica subprocess built from this
factory is bit-identical to the parent's oracle engine, and greedy
decoding makes token parity an equality.

The replica-server child resolves the factory by import path:
``--factory deepspeed_tpu_torch.testing.fabric:tiny_serving_engine``.
Every kwarg is JSON-safe, so the whole recipe ships through `--kwargs`.
The engine runs on the card unless `device` says otherwise; the reference's
tiny model (fp32, head width 16) is what the CPU tests run, and the card's
attention kernels need bf16 / fp16 and head width 64 or 128 (for example
``dtype="bfloat16", n_head=2, d_model=128``).
"""

from typing import Any, Dict

TINY_DEFAULTS: Dict[str, Any] = dict(
    n_layer=2, n_head=4, d_model=64, max_seq_len=256, vocab_size=256)
BS = 16   # kv_block_size == prefill_chunk, the router tests' convention


def tiny_serving_engine(seed: int = 0, max_slots: int = 2,
                        max_context: int = 96, telemetry=False,
                        device: str = None, dtype: str = "float32",
                        **model_overrides):
    """A fresh `ServingEngine` over a tiny seeded GPT. `device` None is the
    card (an engine with no card raises, as every entry point does);
    `dtype` is the compute and KV dtype. `telemetry` is a bool (True = a
    bare enabled registry) or a whole telemetry config dict (each process
    of a pool then records into its own `output_path`)."""
    from deepspeed_tpu_torch.inference.engine import init_inference
    from deepspeed_tpu_torch.models.gpt import (GPTConfig,
                                                make_gpt_decode_model)

    mk = dict(TINY_DEFAULTS)
    mk.update(model_overrides)
    cfg = GPTConfig(dtype=dtype, remat=False, **mk)
    spec = make_gpt_decode_model(cfg=cfg, name="fabric-tiny", seed=seed)
    inf_cfg: Dict[str, Any] = {
        "dtype": dtype, "kv_cache_dtype": dtype, "greedy": True,
        "kv_block_size": BS, "max_out_tokens": 64}
    if isinstance(telemetry, dict):
        inf_cfg["telemetry"] = dict(telemetry)
    elif telemetry:
        inf_cfg["telemetry"] = {"enabled": True}
    engine = init_inference(model=spec, config=inf_cfg, device=device)
    return engine.serving(max_slots=max_slots, max_context=max_context,
                          prefill_chunk=BS, enable_prefix_caching=True)


def tiny_oracle(prompts, news, seed: int = 0, device: str = None,
                dtype: str = "float32", **model_overrides):
    """Single-engine greedy reference completions for `prompts` — the
    baseline every fabric test compares the pool against."""
    import numpy as np

    serving = tiny_serving_engine(seed=seed, device=device, dtype=dtype,
                                  **model_overrides)
    return [serving.engine.generate(np.asarray(p)[None], max_new_tokens=n,
                                    stop_on_eos=False)[0]
            for p, n in zip(prompts, news)]
