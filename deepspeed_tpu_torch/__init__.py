"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The JAX package (`deepspeed_tpu`) is the reference; this package re-implements
its serving path in PyTorch for one NVIDIA H100, with the TPU's Pallas kernels
rewritten as CUDA C++ kernels for Hopper (`ops/csrc/`). It imports torch and
numpy only — never jax, never deepspeed_tpu.

Entry points run on `cuda` unless the caller passes `device="cpu"`:

    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.gpt import make_gpt_decode_model
    engine = init_inference(make_gpt_decode_model(name="gpt2-125m"))
    engine.generate(prompts, max_new_tokens=32)
    engine.serving(max_slots=8).run(requests)
"""

from deepspeed_tpu_torch.inference.engine import InferenceEngine, init_inference

__all__ = ["InferenceEngine", "init_inference"]
