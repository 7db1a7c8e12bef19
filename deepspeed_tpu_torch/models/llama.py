"""LLaMA family — rotary + SwiGLU + RMSNorm + grouped-query attention
(counterpart of `deepspeed_tpu/models/llama.py`).

LLaMA is configuration over the shared GPT core (`models/gpt.py`): the same
training forward, decode model and paged serving path, with GQA reading each
kv head once for its group of query heads in the attention kernels. HF
checkpoints come in through `inference/adapters.py::from_hf_llama`.
"""

import torch

from deepspeed_tpu_torch.models.gpt import (GPTConfig, gpt_forward, gpt_loss,
                                            init_gpt_params,
                                            make_gpt_decode_model,
                                            make_gpt_model)


def llama_config(**kw) -> GPTConfig:
    base = dict(use_rotary=True, use_swiglu=True, use_rmsnorm=True,
                tie_embeddings=False, dtype=torch.bfloat16)
    base.update(kw)
    return GPTConfig(**base)


LLAMA_CONFIGS = {
    # tiny config for tests
    "llama-tiny": llama_config(n_layer=2, n_head=4, n_kv_head=2, d_model=128,
                               d_ff=256, max_seq_len=256, vocab_size=1024),
    "llama2-7b": llama_config(n_layer=32, n_head=32, d_model=4096, d_ff=11008,
                              max_seq_len=4096, vocab_size=32000),
    "llama2-13b": llama_config(n_layer=40, n_head=40, d_model=5120,
                               d_ff=13824, max_seq_len=4096,
                               vocab_size=32000),
    "llama2-70b": llama_config(n_layer=80, n_head=64, n_kv_head=8,
                               d_model=8192, d_ff=28672, max_seq_len=4096,
                               vocab_size=32000),
    "llama3-8b": llama_config(n_layer=32, n_head=32, n_kv_head=8,
                              d_model=4096, d_ff=14336, max_seq_len=8192,
                              vocab_size=128256, rope_theta=500000.0),
    "llama3-70b": llama_config(n_layer=80, n_head=64, n_kv_head=8,
                               d_model=8192, d_ff=28672, max_seq_len=8192,
                               vocab_size=128256, rope_theta=500000.0),
}


def make_llama_model(cfg: GPTConfig = None, name="llama2-7b", seed=0,
                     attn_fn=None):
    """Training ModelSpec over the GPT core."""
    cfg = cfg or LLAMA_CONFIGS[name]
    return make_gpt_model(cfg=cfg, name=name, seed=seed, attn_fn=attn_fn)


def make_llama_decode_model(cfg: GPTConfig = None, name="llama2-7b",
                            params=None, seed=0):
    """DecodeModelSpec for the inference engine."""
    cfg = cfg or LLAMA_CONFIGS[name]
    return make_gpt_decode_model(cfg=cfg, name=name, params=params, seed=seed)


__all__ = ["LLAMA_CONFIGS", "llama_config", "make_llama_model",
           "make_llama_decode_model", "init_gpt_params", "gpt_forward",
           "gpt_loss"]
