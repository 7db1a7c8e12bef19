"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package (`deepspeed_tpu`) is the reference; this package re-implements
its training and serving paths in PyTorch for one NVIDIA H100, with the TPU's
Pallas kernels rewritten as CUDA C++ kernels for Hopper (`ops/csrc/`). It
imports torch and numpy only — never jax, never deepspeed_tpu.

Entry points run on `cuda` unless the caller passes `device="cpu"`:

    from deepspeed_tpu_torch import init_inference, initialize
    from deepspeed_tpu_torch.models.gpt import (make_gpt_decode_model,
                                                make_gpt_model)
    engine, *_ = initialize(model=make_gpt_model(name="gpt2-125m"),
                            config={"train_micro_batch_size_per_gpu": 8,
                                    "optimizer": {"type": "AdamW"},
                                    "bf16": {"enabled": True}})
    engine.train_batch({"tokens": tokens})      # [8, T + 1] int
    engine = init_inference(make_gpt_decode_model(name="gpt2-125m"))
    engine.generate(prompts, max_new_tokens=32)
    engine.serving(max_slots=8).run(requests)
"""

from deepspeed_tpu_torch.inference.engine import InferenceEngine, init_inference
from deepspeed_tpu_torch.runtime.engine import Engine, initialize

__all__ = ["Engine", "InferenceEngine", "init_inference", "initialize"]
