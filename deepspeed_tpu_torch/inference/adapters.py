"""HF and Megatron checkpoint adapters (counterpart of
`deepspeed_tpu/inference/adapters.py`): the reference's injection-container
role as a pure weight-layout transform.

Each adapter takes an HF model (anything with `state_dict()` and `config`)
or a state dict plus its config object, and returns (config, params): the
port's `GPTConfig` (or `BertConfig`, `MoEGPTConfig`) and its parameter tree
in the JAX package's layout, leaf for leaf — stacked `[L, ...]` blocks,
Linear `[out, in]` weights transposed to `[in, out]`, q / k / v fused, HF's
rotate-half RoPE rows put back in interleaved order. The whole zoo then
applies unchanged: `make_gpt_decode_model` / `make_gpt_model`, the engines
and the kernels. Nothing here imports transformers: a config may be any
object with the HF attribute names (a `types.SimpleNamespace` does).

BLOOM (alibi), GPT-Neo (local attention layers) and Mistral with a sliding
window map their weights as in JAX, but their configs raise
`NotImplementedError` naming the flag: the port's attention kernels take no
additive bias and no window yet, and nothing falls back to plain attention.
"""

import dataclasses
from functools import partial

import numpy as np
import torch

from deepspeed_tpu_torch.models.gpt import GPTConfig, as_dtype
from deepspeed_tpu_torch.utils.logging import logger


def _t(x):
    """torch tensor / numpy -> numpy fp32."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _state_dict(model_or_sd):
    if hasattr(model_or_sd, "state_dict"):
        return {k: _t(v) for k, v in model_or_sd.state_dict().items()}
    return {k: _t(v) for k, v in model_or_sd.items()}


def _stack(layers):
    """list of per-layer dicts -> stacked dict with a leading layer dim."""
    return {key: np.stack([layer[key] for layer in layers])
            for key in layers[0]}


def _tensor(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        as_dtype(dtype))


def _blocks(layers, dtype):
    return {k: _tensor(v, dtype) for k, v in _stack(layers).items()}


def _hf_config(model_or_sd, hf_config):
    if hf_config is None:
        hf_config = getattr(model_or_sd, "config", None)
    if hf_config is None:
        raise ValueError("this adapter needs the HF config (head counts): "
                         "pass hf_config, or a model that carries .config")
    return hf_config


# ----------------------------------------------------------------------
# GPT-2
# ----------------------------------------------------------------------


def from_hf_gpt2(model_or_sd, hf_config=None, dtype=torch.float32):
    """GPT2LMHeadModel -> (GPTConfig, params). Conv1D stores [in, out], the
    port's convention already: no transposes (reference container
    `containers/gpt2.py`)."""
    sd = _state_dict(model_or_sd)
    if hf_config is None:
        hf_config = getattr(model_or_sd, "config", None)
    pre = "transformer." if "transformer.wte.weight" in sd else ""

    n_layer = hf_config.n_layer if hf_config else 1 + max(
        int(k.split(".")[1 if not pre else 2]) for k in sd
        if ".h." in "." + k)
    cfg = GPTConfig(
        vocab_size=sd[f"{pre}wte.weight"].shape[0],
        n_layer=n_layer,
        n_head=hf_config.n_head if hf_config else 12,
        d_model=sd[f"{pre}wte.weight"].shape[1],
        max_seq_len=sd[f"{pre}wpe.weight"].shape[0],
        norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)
                       or 1e-5),
        use_rotary=False, use_swiglu=False, use_rmsnorm=False,
        tie_embeddings=True, dtype=dtype, remat=False)

    layers = []
    for i in range(cfg.n_layer):
        b = f"{pre}h.{i}."
        layers.append({
            "ln1_scale": sd[b + "ln_1.weight"],
            "ln1_bias": sd[b + "ln_1.bias"],
            "attn_qkv_w": sd[b + "attn.c_attn.weight"],     # [D, 3D], Conv1D
            "attn_qkv_b": sd[b + "attn.c_attn.bias"],
            "attn_out_w": sd[b + "attn.c_proj.weight"],
            "attn_out_b": sd[b + "attn.c_proj.bias"],
            "ln2_scale": sd[b + "ln_2.weight"],
            "ln2_bias": sd[b + "ln_2.bias"],
            "mlp_up_w": sd[b + "mlp.c_fc.weight"],
            "mlp_up_b": sd[b + "mlp.c_fc.bias"],
            "mlp_down_w": sd[b + "mlp.c_proj.weight"],
            "mlp_out_b": sd[b + "mlp.c_proj.bias"],
        })
    params = {
        "wte": _tensor(sd[f"{pre}wte.weight"], dtype),
        "wpe": _tensor(sd[f"{pre}wpe.weight"], dtype),
        "blocks": _blocks(layers, dtype),
        "lnf_scale": _tensor(sd[f"{pre}ln_f.weight"], dtype),
        "lnf_bias": _tensor(sd[f"{pre}ln_f.bias"], dtype),
    }
    logger.info(f"adapted HF GPT-2: {cfg.n_layer}L d={cfg.d_model} "
                f"vocab={cfg.vocab_size}")
    return cfg, params


# ----------------------------------------------------------------------
# LLaMA
# ----------------------------------------------------------------------


def _unpermute_rope_rows(w, n_heads, head_dim, rotary_dims=None):
    """HF rotate-half row order -> interleaved order, per head.

    HF applies RoPE as rotate_half over contiguous halves of the (first
    `rotary_dims` of the) head dim; `models/gpt._rope` rotates interleaved
    pairs. Reorder the rows so pair (i, i + rd/2) becomes (2i, 2i + 1);
    rows past `rotary_dims` (NeoX rotary_pct < 1) stay in place.
    w: [n_heads * head_dim, in_dim] (torch Linear layout)."""
    H, hd = n_heads, head_dim
    rd = rotary_dims if rotary_dims is not None else hd
    w = w.reshape(H, hd, -1)
    rot, keep = w[:, :rd], w[:, rd:]
    rot = rot.reshape(H, 2, rd // 2, -1)     # [H, {half0, half1}, rd/2, in]
    rot = np.transpose(rot, (0, 2, 1, 3))    # interleave the halves
    rot = rot.reshape(H, rd, -1)
    return np.concatenate([rot, keep], axis=1).reshape(H * hd, -1)


def _split_fused_qkv_per_head(w, n_heads, head_dim):
    """BLOOM / NeoX fused query_key_value stores [H, (q, k, v), hd] per
    head: split into contiguous q, k, v of [H * hd, in_dim] (or [H * hd]
    for a bias)."""
    in_dim = w.shape[-1] if w.ndim == 2 else 1
    w = w.reshape(n_heads, 3, head_dim, -1)
    q, k, v = w[:, 0], w[:, 1], w[:, 2]
    out = (lambda t: t.reshape(n_heads * head_dim, in_dim)) if in_dim > 1 \
        else (lambda t: t.reshape(n_heads * head_dim))
    return out(q), out(k), out(v)


def _llama_layers(sd, n_layer, H, Hkv, hd, D):
    layers = []
    for i in range(n_layer):
        b = f"model.layers.{i}."
        q = _unpermute_rope_rows(sd[b + "self_attn.q_proj.weight"], H, hd)
        k = _unpermute_rope_rows(sd[b + "self_attn.k_proj.weight"], Hkv, hd)
        v = sd[b + "self_attn.v_proj.weight"]
        qkv = np.concatenate([q, k, v], axis=0).T         # [D, (H+2Hkv)*hd]
        # attention biases (InternLM, LlamaConfig(attention_bias=True)): the
        # q / k biases take the weights' row un-permutation
        if b + "self_attn.q_proj.bias" in sd:
            qb = _unpermute_rope_rows(sd[b + "self_attn.q_proj.bias"], H,
                                      hd).ravel()
            kb = _unpermute_rope_rows(sd[b + "self_attn.k_proj.bias"], Hkv,
                                      hd).ravel()
            qkv_b = np.concatenate([qb, kb, sd[b + "self_attn.v_proj.bias"]])
        else:
            qkv_b = np.zeros(qkv.shape[1], np.float32)
        layers.append({
            "ln1_scale": sd[b + "input_layernorm.weight"],
            "attn_qkv_w": qkv,
            "attn_qkv_b": qkv_b,
            "attn_out_w": sd[b + "self_attn.o_proj.weight"].T,
            "attn_out_b": sd.get(b + "self_attn.o_proj.bias",
                                 np.zeros(D, np.float32)),
            "ln2_scale": sd[b + "post_attention_layernorm.weight"],
            "mlp_gate_w": sd[b + "mlp.gate_proj.weight"].T,
            "mlp_up_w": sd[b + "mlp.up_proj.weight"].T,
            "mlp_down_w": sd[b + "mlp.down_proj.weight"].T,
            "mlp_out_b": np.zeros(D, np.float32),
        })
    return layers


def from_hf_llama(model_or_sd, hf_config=None, dtype=torch.float32):
    """LlamaForCausalLM -> (GPTConfig, params). Transposes Linear [out, in]
    -> [in, out], fuses q / k / v, un-permutes the RoPE rows (reference
    container `containers/llama.py`)."""
    sd = _state_dict(model_or_sd)
    hf_config = _hf_config(model_or_sd, hf_config)
    H = hf_config.num_attention_heads
    Hkv = getattr(hf_config, "num_key_value_heads", H) or H
    D = hf_config.hidden_size
    hd = D // H
    cfg = GPTConfig(
        vocab_size=hf_config.vocab_size,
        n_layer=hf_config.num_hidden_layers,
        n_head=H, n_kv_head=Hkv, d_model=D,
        d_ff=hf_config.intermediate_size,
        max_seq_len=getattr(hf_config, "max_position_embeddings", 4096),
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(getattr(hf_config, "rms_norm_eps", 1e-6)),
        use_rotary=True, use_swiglu=True, use_rmsnorm=True,
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        dtype=dtype, remat=False)
    layers = _llama_layers(sd, cfg.n_layer, H, Hkv, hd, D)
    params = {
        "wte": _tensor(sd["model.embed_tokens.weight"], dtype),
        "blocks": _blocks(layers, dtype),
        "lnf_scale": _tensor(sd["model.norm.weight"], dtype),
    }
    if not cfg.tie_embeddings:
        head = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
        params["lm_head"] = _tensor(head, dtype)
    logger.info(f"adapted HF LLaMA: {cfg.n_layer}L d={cfg.d_model} "
                f"H={H}/{Hkv} vocab={cfg.vocab_size}")
    return cfg, params


# ----------------------------------------------------------------------
# OPT
# ----------------------------------------------------------------------


def from_hf_opt(model_or_sd, hf_config=None, dtype=torch.float32):
    """OPTForCausalLM -> (GPTConfig, params). Pre-LN decoder with a ReLU MLP
    and learned positions at a +2 offset, absorbed by trimming the first two
    position rows (reference container `containers/opt.py`)."""
    sd = _state_dict(model_or_sd)
    hf_config = _hf_config(model_or_sd, hf_config)
    if not getattr(hf_config, "do_layer_norm_before", True):
        raise NotImplementedError("post-LN OPT variants (350m) are not "
                                  "supported")
    D = hf_config.hidden_size
    if getattr(hf_config, "word_embed_proj_dim", D) != D:
        raise NotImplementedError("OPT word_embed_proj_dim != hidden_size is "
                                  "not supported")
    cfg = GPTConfig(
        vocab_size=hf_config.vocab_size,
        n_layer=hf_config.num_hidden_layers,
        n_head=hf_config.num_attention_heads,
        d_model=D,
        d_ff=hf_config.ffn_dim,
        max_seq_len=hf_config.max_position_embeddings,
        activation="relu",
        use_rotary=False, use_swiglu=False, use_rmsnorm=False,
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", True)),
        dtype=dtype, remat=False)

    layers = []
    for i in range(cfg.n_layer):
        b = f"model.decoder.layers.{i}."
        q = sd[b + "self_attn.q_proj.weight"]
        k = sd[b + "self_attn.k_proj.weight"]
        v = sd[b + "self_attn.v_proj.weight"]
        layers.append({
            "ln1_scale": sd[b + "self_attn_layer_norm.weight"],
            "ln1_bias": sd[b + "self_attn_layer_norm.bias"],
            "attn_qkv_w": np.concatenate([q, k, v], axis=0).T,
            "attn_qkv_b": np.concatenate([sd[b + "self_attn.q_proj.bias"],
                                          sd[b + "self_attn.k_proj.bias"],
                                          sd[b + "self_attn.v_proj.bias"]]),
            "attn_out_w": sd[b + "self_attn.out_proj.weight"].T,
            "attn_out_b": sd[b + "self_attn.out_proj.bias"],
            "ln2_scale": sd[b + "final_layer_norm.weight"],
            "ln2_bias": sd[b + "final_layer_norm.bias"],
            "mlp_up_w": sd[b + "fc1.weight"].T,
            "mlp_up_b": sd[b + "fc1.bias"],
            "mlp_down_w": sd[b + "fc2.weight"].T,
            "mlp_out_b": sd[b + "fc2.bias"],
        })
    params = {
        "wte": _tensor(sd["model.decoder.embed_tokens.weight"], dtype),
        # OPTLearnedPositionalEmbedding indexes at position + 2
        "wpe": _tensor(sd["model.decoder.embed_positions.weight"][2:], dtype),
        "blocks": _blocks(layers, dtype),
        "lnf_scale": _tensor(sd["model.decoder.final_layer_norm.weight"],
                             dtype),
        "lnf_bias": _tensor(sd["model.decoder.final_layer_norm.bias"], dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(sd["lm_head.weight"], dtype)
    logger.info(f"adapted HF OPT: {cfg.n_layer}L d={cfg.d_model} "
                f"vocab={cfg.vocab_size}")
    return cfg, params


# ----------------------------------------------------------------------
# BLOOM
# ----------------------------------------------------------------------


def _bloom_params(sd, n_layer, H, hd, dtype):
    """BLOOM's tree: per-head-interleaved fused qkv split, the
    word-embedding LayerNorm, no position table."""
    pre = "transformer." if "transformer.word_embeddings.weight" in sd else ""
    layers = []
    for i in range(n_layer):
        b = f"{pre}h.{i}."
        qw, kw, vw = _split_fused_qkv_per_head(
            sd[b + "self_attention.query_key_value.weight"], H, hd)
        qb, kb, vb = _split_fused_qkv_per_head(
            sd[b + "self_attention.query_key_value.bias"], H, hd)
        layers.append({
            "ln1_scale": sd[b + "input_layernorm.weight"],
            "ln1_bias": sd[b + "input_layernorm.bias"],
            "attn_qkv_w": np.concatenate([qw, kw, vw], axis=0).T,
            "attn_qkv_b": np.concatenate([qb, kb, vb]),
            "attn_out_w": sd[b + "self_attention.dense.weight"].T,
            "attn_out_b": sd[b + "self_attention.dense.bias"],
            "ln2_scale": sd[b + "post_attention_layernorm.weight"],
            "ln2_bias": sd[b + "post_attention_layernorm.bias"],
            "mlp_up_w": sd[b + "mlp.dense_h_to_4h.weight"].T,
            "mlp_up_b": sd[b + "mlp.dense_h_to_4h.bias"],
            "mlp_down_w": sd[b + "mlp.dense_4h_to_h.weight"].T,
            "mlp_out_b": sd[b + "mlp.dense_4h_to_h.bias"],
        })
    return {
        "wte": _tensor(sd[f"{pre}word_embeddings.weight"], dtype),
        "emb_ln_scale": _tensor(sd[f"{pre}word_embeddings_layernorm.weight"],
                                dtype),
        "emb_ln_bias": _tensor(sd[f"{pre}word_embeddings_layernorm.bias"],
                               dtype),
        "blocks": _blocks(layers, dtype),
        "lnf_scale": _tensor(sd[f"{pre}ln_f.weight"], dtype),
        "lnf_bias": _tensor(sd[f"{pre}ln_f.bias"], dtype),
    }


def from_hf_bloom(model_or_sd, hf_config=None, dtype=torch.float32):
    """BloomForCausalLM -> (GPTConfig, params): alibi attention, the
    word-embedding LayerNorm, per-head-interleaved fused qkv (reference
    container `containers/bloom.py`). The config sets `use_alibi`, which
    the port does not run yet: it raises NotImplementedError naming it."""
    hf_config = _hf_config(model_or_sd, hf_config)
    H = hf_config.n_head
    D = hf_config.hidden_size
    cfg = GPTConfig(
        vocab_size=hf_config.vocab_size,
        n_layer=hf_config.n_layer,
        n_head=H, d_model=D, d_ff=4 * D,
        max_seq_len=getattr(hf_config, "seq_length", 2048) or 2048,
        norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
        use_alibi=True, use_emb_ln=True,
        use_rotary=False, use_swiglu=False, use_rmsnorm=False,
        tie_embeddings=True, dtype=dtype, remat=False)
    params = _bloom_params(_state_dict(model_or_sd), cfg.n_layer, H, D // H,
                           dtype)
    logger.info(f"adapted HF BLOOM: {cfg.n_layer}L d={cfg.d_model} alibi "
                f"vocab={cfg.vocab_size}")
    return cfg, params


# ----------------------------------------------------------------------
# GPT-NeoX / GPT-J / GPT-Neo
# ----------------------------------------------------------------------


def from_hf_gpt_neox(model_or_sd, hf_config=None, dtype=torch.float32):
    """GPTNeoXForCausalLM -> (GPTConfig, params): partial rotary
    (rotary_pct), the parallel residual, per-head-interleaved fused qkv, an
    untied embed_out (reference container `containers/gptneox.py`)."""
    sd = _state_dict(model_or_sd)
    hf_config = _hf_config(model_or_sd, hf_config)
    H = hf_config.num_attention_heads
    D = hf_config.hidden_size
    hd = D // H
    rd = int(hf_config.rotary_pct * hd) // 2 * 2

    cfg = GPTConfig(
        vocab_size=hf_config.vocab_size,
        n_layer=hf_config.num_hidden_layers,
        n_head=H, d_model=D, d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        norm_eps=float(getattr(hf_config, "layer_norm_eps", 1e-5)),
        use_rotary=True, rotary_pct=float(hf_config.rotary_pct),
        rope_theta=float(getattr(hf_config, "rotary_emb_base", 10000.0)),
        parallel_residual=bool(getattr(hf_config, "use_parallel_residual",
                                       True)),
        use_swiglu=False, use_rmsnorm=False,
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings", False)),
        dtype=dtype, remat=False)

    layers = []
    for i in range(cfg.n_layer):
        b = f"gpt_neox.layers.{i}."
        qw, kw, vw = _split_fused_qkv_per_head(
            sd[b + "attention.query_key_value.weight"], H, hd)
        qb, kb, vb = _split_fused_qkv_per_head(
            sd[b + "attention.query_key_value.bias"], H, hd)
        qw = _unpermute_rope_rows(qw, H, hd, rd)
        kw = _unpermute_rope_rows(kw, H, hd, rd)
        qb = _unpermute_rope_rows(qb[:, None], H, hd, rd)[:, 0]
        kb = _unpermute_rope_rows(kb[:, None], H, hd, rd)[:, 0]
        layers.append({
            "ln1_scale": sd[b + "input_layernorm.weight"],
            "ln1_bias": sd[b + "input_layernorm.bias"],
            "attn_qkv_w": np.concatenate([qw, kw, vw], axis=0).T,
            "attn_qkv_b": np.concatenate([qb, kb, vb]),
            "attn_out_w": sd[b + "attention.dense.weight"].T,
            "attn_out_b": sd[b + "attention.dense.bias"],
            "ln2_scale": sd[b + "post_attention_layernorm.weight"],
            "ln2_bias": sd[b + "post_attention_layernorm.bias"],
            "mlp_up_w": sd[b + "mlp.dense_h_to_4h.weight"].T,
            "mlp_up_b": sd[b + "mlp.dense_h_to_4h.bias"],
            "mlp_down_w": sd[b + "mlp.dense_4h_to_h.weight"].T,
            "mlp_out_b": sd[b + "mlp.dense_4h_to_h.bias"],
        })
    params = {
        "wte": _tensor(sd["gpt_neox.embed_in.weight"], dtype),
        "blocks": _blocks(layers, dtype),
        "lnf_scale": _tensor(sd["gpt_neox.final_layer_norm.weight"], dtype),
        "lnf_bias": _tensor(sd["gpt_neox.final_layer_norm.bias"], dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(sd["embed_out.weight"], dtype)
    logger.info(f"adapted HF GPT-NeoX: {cfg.n_layer}L d={cfg.d_model} "
                f"rot%={cfg.rotary_pct} vocab={cfg.vocab_size}")
    return cfg, params


def from_hf_gptj(model_or_sd, hf_config=None, dtype=torch.float32):
    """GPTJForCausalLM -> (GPTConfig, params): natively interleaved rotary
    over `rotary_dim`, a single-LN parallel residual (ln2 := a copy of
    ln1), biasless attention projections, a biased LM head (reference
    container `containers/gptj.py`)."""
    sd = _state_dict(model_or_sd)
    hf_config = _hf_config(model_or_sd, hf_config)
    H = hf_config.n_head
    D = hf_config.n_embd
    hd = D // H
    rd = int(getattr(hf_config, "rotary_dim", hd) or hd)

    cfg = GPTConfig(
        vocab_size=hf_config.vocab_size,
        n_layer=hf_config.n_layer,
        n_head=H, d_model=D,
        d_ff=getattr(hf_config, "n_inner", None) or 4 * D,
        max_seq_len=hf_config.n_positions,
        norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
        use_rotary=True, rotary_pct=rd / hd,
        parallel_residual=True,
        use_swiglu=False, use_rmsnorm=False,
        tie_embeddings=False, dtype=dtype, remat=False)

    layers = []
    for i in range(cfg.n_layer):
        b = f"transformer.h.{i}."
        q = sd[b + "attn.q_proj.weight"]    # GPT-J rope is already interleaved
        k = sd[b + "attn.k_proj.weight"]
        v = sd[b + "attn.v_proj.weight"]
        ln_s, ln_b = sd[b + "ln_1.weight"], sd[b + "ln_1.bias"]
        layers.append({
            "ln1_scale": ln_s,
            "ln1_bias": ln_b,
            # single-LN parallel residual: the MLP reads the same normed input
            "ln2_scale": ln_s.copy(),
            "ln2_bias": ln_b.copy(),
            "attn_qkv_w": np.concatenate([q, k, v], axis=0).T,
            "attn_qkv_b": np.zeros(3 * D, np.float32),
            "attn_out_w": sd[b + "attn.out_proj.weight"].T,
            "attn_out_b": np.zeros(D, np.float32),
            "mlp_up_w": sd[b + "mlp.fc_in.weight"].T,
            "mlp_up_b": sd[b + "mlp.fc_in.bias"],
            "mlp_down_w": sd[b + "mlp.fc_out.weight"].T,
            "mlp_out_b": sd[b + "mlp.fc_out.bias"],
        })
    params = {
        "wte": _tensor(sd["transformer.wte.weight"], dtype),
        "blocks": _blocks(layers, dtype),
        "lnf_scale": _tensor(sd["transformer.ln_f.weight"], dtype),
        "lnf_bias": _tensor(sd["transformer.ln_f.bias"], dtype),
        "lm_head": _tensor(sd["lm_head.weight"], dtype),
    }
    if "lm_head.bias" in sd:
        params["lm_head_bias"] = _tensor(sd["lm_head.bias"], dtype)
    logger.info(f"adapted HF GPT-J: {cfg.n_layer}L d={cfg.d_model} rd={rd}")
    return cfg, params


def _gpt_neo_params(sd, n_layer, dtype):
    """GPT-Neo's tree: biasless q / k / v fused, learned positions."""
    layers = []
    for i in range(n_layer):
        b = f"transformer.h.{i}."
        q = sd[b + "attn.attention.q_proj.weight"]
        k = sd[b + "attn.attention.k_proj.weight"]
        v = sd[b + "attn.attention.v_proj.weight"]
        D = q.shape[1]
        layers.append({
            "ln1_scale": sd[b + "ln_1.weight"],
            "ln1_bias": sd[b + "ln_1.bias"],
            "attn_qkv_w": np.concatenate([q, k, v], axis=0).T,
            "attn_qkv_b": np.zeros(3 * D, np.float32),    # q/k/v are biasless
            "attn_out_w": sd[b + "attn.attention.out_proj.weight"].T,
            "attn_out_b": sd[b + "attn.attention.out_proj.bias"],
            "ln2_scale": sd[b + "ln_2.weight"],
            "ln2_bias": sd[b + "ln_2.bias"],
            "mlp_up_w": sd[b + "mlp.c_fc.weight"].T,
            "mlp_up_b": sd[b + "mlp.c_fc.bias"],
            "mlp_down_w": sd[b + "mlp.c_proj.weight"].T,
            "mlp_out_b": sd[b + "mlp.c_proj.bias"],
        })
    return {
        "wte": _tensor(sd["transformer.wte.weight"], dtype),
        "wpe": _tensor(sd["transformer.wpe.weight"], dtype),
        "blocks": _blocks(layers, dtype),
        "lnf_scale": _tensor(sd["transformer.ln_f.weight"], dtype),
        "lnf_bias": _tensor(sd["transformer.ln_f.bias"], dtype),
    }


def from_hf_gpt_neo(model_or_sd, hf_config=None, dtype=torch.float32):
    """GPTNeoForCausalLM -> (GPTConfig, params): alternating global / local
    attention (window 256), unscaled scores, biasless q / k / v, learned
    positions (reference container `containers/gptneo.py`). The config sets
    `sliding_window` and `attn_layer_types`, which the port does not run
    yet: it raises NotImplementedError naming them."""
    hf_config = _hf_config(model_or_sd, hf_config)
    D = hf_config.hidden_size
    layer_types = tuple(hf_config.attention_layers)  # expanded per layer
    cfg = GPTConfig(
        vocab_size=hf_config.vocab_size,
        n_layer=hf_config.num_layers,
        n_head=hf_config.num_heads, d_model=D,
        d_ff=getattr(hf_config, "intermediate_size", None) or 4 * D,
        max_seq_len=hf_config.max_position_embeddings,
        norm_eps=float(getattr(hf_config, "layer_norm_epsilon", 1e-5)),
        sliding_window=int(getattr(hf_config, "window_size", 256)),
        attn_layer_types=layer_types,
        scale_attn=False,                # GPT-Neo does not scale by 1/sqrt(hd)
        use_rotary=False, use_swiglu=False, use_rmsnorm=False,
        tie_embeddings=True, dtype=dtype, remat=False)
    params = _gpt_neo_params(_state_dict(model_or_sd), cfg.n_layer, dtype)
    logger.info(f"adapted HF GPT-Neo: {cfg.n_layer}L d={D} "
                f"types={layer_types[:4]}... window={cfg.sliding_window}")
    return cfg, params


# ----------------------------------------------------------------------
# Mistral
# ----------------------------------------------------------------------


def from_hf_mistral(model_or_sd, hf_config=None, dtype=torch.float32):
    """MistralForCausalLM -> (GPTConfig, params): the LLaMA layout plus
    sliding-window attention. A config with a window raises
    NotImplementedError naming `sliding_window` (the port runs no window
    yet); one without adapts as LLaMA."""
    cfg, params = from_hf_llama(model_or_sd, hf_config, dtype=dtype)
    hf_config = hf_config or getattr(model_or_sd, "config", None)
    window = getattr(hf_config, "sliding_window", None)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=int(window))
    return cfg, params


# ----------------------------------------------------------------------
# BERT / DistilBERT
# ----------------------------------------------------------------------


def from_hf_bert(model_or_sd, hf_config=None, dtype=torch.float32):
    """BertForMaskedLM -> (BertConfig, params) for `models/bert.py`
    (reference container `containers/bert.py`): Linear [out, in] transposed,
    q / k / v fused, the post-LN layout."""
    from deepspeed_tpu_torch.models.bert import BertConfig
    sd = _state_dict(model_or_sd)
    hf_config = _hf_config(model_or_sd, hf_config)
    D = hf_config.hidden_size
    cfg = BertConfig(
        vocab_size=hf_config.vocab_size,
        n_layer=hf_config.num_hidden_layers,
        n_head=hf_config.num_attention_heads,
        d_model=D,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        norm_eps=float(hf_config.layer_norm_eps),
        pre_layer_norm=False, dtype=dtype, remat=False)

    layers = []
    for i in range(cfg.n_layer):
        b = f"bert.encoder.layer.{i}."
        q, k, v = (sd[b + f"attention.self.{n}.weight"]
                   for n in ("query", "key", "value"))
        qb, kb, vb = (sd[b + f"attention.self.{n}.bias"]
                      for n in ("query", "key", "value"))
        layers.append({
            "attn_qkv_w": np.concatenate([q, k, v], axis=0).T,
            "attn_qkv_b": np.concatenate([qb, kb, vb]),
            "attn_out_w": sd[b + "attention.output.dense.weight"].T,
            "attn_out_b": sd[b + "attention.output.dense.bias"],
            "ln1_scale": sd[b + "attention.output.LayerNorm.weight"],
            "ln1_bias": sd[b + "attention.output.LayerNorm.bias"],
            "mlp_up_w": sd[b + "intermediate.dense.weight"].T,
            "mlp_up_b": sd[b + "intermediate.dense.bias"],
            "mlp_down_w": sd[b + "output.dense.weight"].T,
            "mlp_down_b": sd[b + "output.dense.bias"],
            "ln2_scale": sd[b + "output.LayerNorm.weight"],
            "ln2_bias": sd[b + "output.LayerNorm.bias"],
        })
    V = cfg.vocab_size
    e = "bert.embeddings."
    h = "cls.predictions."
    params = {
        "word_emb": _tensor(sd[e + "word_embeddings.weight"], dtype),
        "pos_emb": _tensor(sd[e + "position_embeddings.weight"], dtype),
        "type_emb": _tensor(sd[e + "token_type_embeddings.weight"], dtype),
        "emb_ln_scale": _tensor(sd[e + "LayerNorm.weight"], dtype),
        "emb_ln_bias": _tensor(sd[e + "LayerNorm.bias"], dtype),
        "blocks": _blocks(layers, dtype),
        "mlm_dense_w": _tensor(sd[h + "transform.dense.weight"].T, dtype),
        "mlm_dense_b": _tensor(sd[h + "transform.dense.bias"], dtype),
        "mlm_ln_scale": _tensor(sd[h + "transform.LayerNorm.weight"], dtype),
        "mlm_ln_bias": _tensor(sd[h + "transform.LayerNorm.bias"], dtype),
        "mlm_bias": _tensor(sd.get(h + "bias", np.zeros(V)), dtype),
        "pooler_w": _tensor(sd.get("bert.pooler.dense.weight",
                                   np.zeros((D, D))).T, dtype),
        "pooler_b": _tensor(sd.get("bert.pooler.dense.bias", np.zeros(D)),
                            dtype),
    }
    logger.info(f"adapted HF BERT: {cfg.n_layer}L d={cfg.d_model} vocab={V}")
    return cfg, params


def from_hf_internlm(model_or_sd, hf_config=None, dtype=torch.float32):
    """InternLMForCausalLM -> (GPTConfig, params) (reference container
    `containers/internlm.py`): the LLaMA layout with attention biases, the
    same key names, handled by the bias-aware LLaMA conversion."""
    return from_hf_llama(model_or_sd, hf_config=hf_config, dtype=dtype)


def from_hf_distilbert(model_or_sd, hf_config=None, dtype=torch.float32):
    """DistilBertForMaskedLM -> (BertConfig, params) (reference container
    `containers/distil_bert.py`): a post-LN encoder with no token-type
    embeddings and an MLM head tied to the word embeddings."""
    from deepspeed_tpu_torch.models.bert import BertConfig
    sd = _state_dict(model_or_sd)
    hf_config = _hf_config(model_or_sd, hf_config)
    D = hf_config.dim
    cfg = BertConfig(
        vocab_size=hf_config.vocab_size,
        n_layer=hf_config.n_layers,
        n_head=hf_config.n_heads,
        d_model=D,
        d_ff=hf_config.hidden_dim,
        max_seq_len=hf_config.max_position_embeddings,
        type_vocab_size=1,                      # distilbert has no segments
        norm_eps=1e-12,
        pre_layer_norm=False, dtype=dtype, remat=False)

    layers = []
    for i in range(cfg.n_layer):
        b = f"distilbert.transformer.layer.{i}."
        q, k, v = (sd[b + f"attention.{n}_lin.weight"] for n in ("q", "k", "v"))
        qb, kb, vb = (sd[b + f"attention.{n}_lin.bias"]
                      for n in ("q", "k", "v"))
        layers.append({
            "attn_qkv_w": np.concatenate([q, k, v], axis=0).T,
            "attn_qkv_b": np.concatenate([qb, kb, vb]),
            "attn_out_w": sd[b + "attention.out_lin.weight"].T,
            "attn_out_b": sd[b + "attention.out_lin.bias"],
            "ln1_scale": sd[b + "sa_layer_norm.weight"],
            "ln1_bias": sd[b + "sa_layer_norm.bias"],
            "mlp_up_w": sd[b + "ffn.lin1.weight"].T,
            "mlp_up_b": sd[b + "ffn.lin1.bias"],
            "mlp_down_w": sd[b + "ffn.lin2.weight"].T,
            "mlp_down_b": sd[b + "ffn.lin2.bias"],
            "ln2_scale": sd[b + "output_layer_norm.weight"],
            "ln2_bias": sd[b + "output_layer_norm.bias"],
        })
    V = cfg.vocab_size
    e = "distilbert.embeddings."
    params = {
        "word_emb": _tensor(sd[e + "word_embeddings.weight"], dtype),
        "pos_emb": _tensor(sd[e + "position_embeddings.weight"], dtype),
        "type_emb": torch.zeros((1, D), dtype=as_dtype(dtype)),
        "emb_ln_scale": _tensor(sd[e + "LayerNorm.weight"], dtype),
        "emb_ln_bias": _tensor(sd[e + "LayerNorm.bias"], dtype),
        "blocks": _blocks(layers, dtype),
        "mlm_dense_w": _tensor(sd["vocab_transform.weight"].T, dtype),
        "mlm_dense_b": _tensor(sd["vocab_transform.bias"], dtype),
        "mlm_ln_scale": _tensor(sd["vocab_layer_norm.weight"], dtype),
        "mlm_ln_bias": _tensor(sd["vocab_layer_norm.bias"], dtype),
        "mlm_bias": _tensor(sd.get("vocab_projector.bias", np.zeros(V)),
                            dtype),
        "pooler_w": torch.zeros((D, D), dtype=as_dtype(dtype)),  # no pooler
        "pooler_b": torch.zeros((D,), dtype=as_dtype(dtype)),
    }
    logger.info(f"adapted HF DistilBERT: {cfg.n_layer}L d={cfg.d_model} "
                f"vocab={V}")
    return cfg, params


# ----------------------------------------------------------------------
# Megatron-LM GPT
# ----------------------------------------------------------------------


def _megatron_qkv_to_packed(w, n_heads, head_dim, version):
    """Megatron fused query_key_value rows -> contiguous (q, k, v).

    Three row orderings exist across Megatron checkpoint versions
    (reference `MegatronSDLoader.merge_query_key_value`,
    `state_dict_factory.py:220`):
      0:   [3*H*hd, ...] — already [Q; K; V] blocks
      1.0: [H*hd*3, ...] — per head, per hd row, (q, k, v) triplets
      2.0: [H*3*hd, ...] — per head, (q, k, v) groups of hd rows
    Returns (q, k, v) each [H*hd, in_dim] (or [H*hd] for biases)."""
    in_dim = w.shape[-1] if w.ndim == 2 else 1
    flat = (lambda t: t.reshape(n_heads * head_dim, in_dim)) if in_dim > 1 \
        else (lambda t: t.reshape(n_heads * head_dim))
    if version == 0:
        q, k, v = np.split(w, 3, axis=0)
        return q, k, v
    if version == 1.0:
        w = w.reshape(n_heads, head_dim, 3, -1)
        return flat(w[:, :, 0]), flat(w[:, :, 1]), flat(w[:, :, 2])
    if version == 2.0:
        w = w.reshape(n_heads, 3, head_dim, -1)
        return flat(w[:, 0]), flat(w[:, 1]), flat(w[:, 2])
    raise ValueError(f"unsupported Megatron checkpoint version {version!r}")


def _megatron_unwrap(raw, version):
    """(state dict of array leaves, version) out of the checkpoint envelope:
    a 'module' / 'model' wrapper, a 'language_model' level, and the
    'checkpoint_version' key (reference `get_checkpoint_version`,
    `state_dict_factory.py:425`)."""
    if version is None and isinstance(raw, dict):
        version = raw.get("checkpoint_version", 0)
    if isinstance(raw, dict):
        for env in ("module", "model"):
            if env in raw and isinstance(raw[env], dict):
                raw = raw[env]
        if "language_model" in raw:
            raw = raw["language_model"]
    sd = _state_dict({k: v for k, v in raw.items()
                      if hasattr(v, "shape") or hasattr(v, "detach")})
    return sd, version


def from_megatron_gpt(model_or_sd, hf_config=None, dtype=torch.float32, *,
                      num_heads=None, version=None):
    """Megatron-LM GPT state dict -> (GPTConfig, params).

    Reference: `module_inject/containers/megatron_gpt.py` and
    `runtime/state_dict_factory.py:190` (MegatronSDLoader). Takes the old
    `attention.` and the new `self_attention.` module paths and the three
    qkv row orderings (`_megatron_qkv_to_packed`); the state dict may sit
    in a 'model' / 'module' envelope with a 'checkpoint_version' key.
    `num_heads` (not stored in the weights) is required: directly, or as
    `num_attention_heads` of an hf_config-like object."""
    sd, version = _megatron_unwrap(model_or_sd, version)
    version = float(version or 0)
    if num_heads is None and hf_config is not None:
        num_heads = getattr(hf_config, "num_attention_heads", None)
    if not num_heads:
        raise ValueError("from_megatron_gpt needs num_heads (not stored in "
                         "the weights)")

    wte = sd["word_embeddings.weight"]
    wpe = sd["position_embeddings.weight"]
    D = wte.shape[1]
    attn = "self_attention" if any("self_attention." in k for k in sd) \
        else "attention"
    n_layer = 1 + max(int(k.split(".")[2]) for k in sd
                      if k.startswith("transformer.layers."))
    H = int(num_heads)
    hd = D // H

    cfg = GPTConfig(
        vocab_size=wte.shape[0], n_layer=n_layer, n_head=H, d_model=D,
        d_ff=sd["transformer.layers.0.mlp.dense_h_to_4h.weight"].shape[0],
        max_seq_len=wpe.shape[0],
        use_rotary=False, use_swiglu=False, use_rmsnorm=False,
        tie_embeddings="lm_head.weight" not in sd,
        dtype=dtype, remat=False)

    layers = []
    for i in range(n_layer):
        b = f"transformer.layers.{i}."
        qw, kw, vw = _megatron_qkv_to_packed(
            sd[b + f"{attn}.query_key_value.weight"], H, hd, version)
        qb, kb, vb = _megatron_qkv_to_packed(
            sd[b + f"{attn}.query_key_value.bias"], H, hd, version)
        layers.append({
            "ln1_scale": sd[b + "input_layernorm.weight"],
            "ln1_bias": sd[b + "input_layernorm.bias"],
            "attn_qkv_w": np.concatenate([qw, kw, vw], axis=0).T,
            "attn_qkv_b": np.concatenate([qb, kb, vb]),
            "attn_out_w": sd[b + f"{attn}.dense.weight"].T,
            "attn_out_b": sd[b + f"{attn}.dense.bias"],
            "ln2_scale": sd[b + "post_attention_layernorm.weight"],
            "ln2_bias": sd[b + "post_attention_layernorm.bias"],
            "mlp_up_w": sd[b + "mlp.dense_h_to_4h.weight"].T,
            "mlp_up_b": sd[b + "mlp.dense_h_to_4h.bias"],
            "mlp_down_w": sd[b + "mlp.dense_4h_to_h.weight"].T,
            "mlp_out_b": sd[b + "mlp.dense_4h_to_h.bias"],
        })
    params = {
        "wte": _tensor(wte, dtype),
        "wpe": _tensor(wpe, dtype),
        "blocks": _blocks(layers, dtype),
        "lnf_scale": _tensor(sd["transformer.final_layernorm.weight"], dtype),
        "lnf_bias": _tensor(sd["transformer.final_layernorm.bias"], dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _tensor(sd["lm_head.weight"], dtype)
    logger.info(f"adapted Megatron GPT: {n_layer}L d={D} H={H} "
                f"ckpt_version={version}")
    return cfg, params


def from_megatron_gpt_moe(model_or_sd, hf_config=None, dtype=torch.float32,
                          *, num_heads=None, version=None):
    """Megatron-LM GPT + DeepSpeed-MoE state dict -> (MoEGPTConfig, params).

    Reference: `module_inject/containers/megatron_gpt_moe.py:1`. Composes
    `from_megatron_gpt`'s layer mapping with the MoE zoo layout
    (`models/moe_gpt.py`): layers whose MLP lives under
    `mlp.deepspeed_moe.` contribute a gate (`gate.wg.weight`) and stacked
    per-expert FFNs (`experts.deepspeed_experts.<e>.dense_{h_to_4h,
    4h_to_h}`); their dense-MLP slots in the stacked blocks are zero-filled
    (never read: those layers route through the expert MLP)."""
    from deepspeed_tpu_torch.models.moe_gpt import MoEGPTConfig

    sd, version = _megatron_unwrap(model_or_sd, version)
    moe_prefix = "mlp.deepspeed_moe."
    moe_keys = {k for k in sd if moe_prefix in k}
    if not moe_keys:
        raise ValueError("no deepspeed_moe keys found: use from_megatron_gpt "
                         "for a dense Megatron checkpoint")
    moe_ids = sorted({int(k.split(".")[2]) for k in moe_keys})
    # the dense skeleton: from_megatron_gpt over the MoE layers' dense-MLP
    # entries zero-filled (shapes from any expert's FFN)
    F_, D = sd[f"transformer.layers.{moe_ids[0]}.{moe_prefix}"
               f"experts.deepspeed_experts.0.dense_h_to_4h.weight"].shape
    dense_sd = {k: v for k, v in sd.items() if moe_prefix not in k}
    for lid in moe_ids:
        b = f"transformer.layers.{lid}."
        dense_sd[b + "mlp.dense_h_to_4h.weight"] = np.zeros((F_, D),
                                                            np.float32)
        dense_sd[b + "mlp.dense_h_to_4h.bias"] = np.zeros((F_,), np.float32)
        dense_sd[b + "mlp.dense_4h_to_h.weight"] = np.zeros((D, F_),
                                                            np.float32)
        dense_sd[b + "mlp.dense_4h_to_h.bias"] = np.zeros((D,), np.float32)
    base_cfg, params = from_megatron_gpt(dense_sd, hf_config, dtype,
                                         num_heads=num_heads,
                                         version=version)

    # moe_freq must reproduce the checkpoint's MoE placement (the zoo places
    # MoE at {i : i % freq == 1})
    freq = next((f for f in range(1, base_cfg.n_layer + 1)
                 if [i for i in range(base_cfg.n_layer) if i % f == 1]
                 == moe_ids), None)
    if freq is None:
        raise ValueError(f"MoE layer ids {moe_ids} do not match the zoo's "
                         f"every-freq pattern")

    moe, num_experts = {}, None
    for lid in moe_ids:
        b = f"transformer.layers.{lid}.{moe_prefix}"
        E = 1 + max(int(k.split("deepspeed_experts.")[1].split(".")[0])
                    for k in moe_keys if k.startswith(b + "experts."))
        num_experts = num_experts or E
        if E != num_experts:
            raise ValueError("the expert count must match across layers")
        ex = [f"{b}experts.deepspeed_experts.{e}." for e in range(E)]
        moe[str(lid)] = {
            "gate_w": _tensor(sd[b + "gate.wg.weight"].T, dtype),   # [D, E]
            "w_up": _tensor(np.stack([sd[p + "dense_h_to_4h.weight"].T
                                      for p in ex]), dtype),         # [E, D, F]
            "b_up": _tensor(np.stack([sd[p + "dense_h_to_4h.bias"]
                                      for p in ex]), dtype),
            "w_down": _tensor(np.stack([sd[p + "dense_4h_to_h.weight"].T
                                        for p in ex]), dtype),       # [E, F, D]
            "b_down": _tensor(np.stack([sd[p + "dense_4h_to_h.bias"]
                                        for p in ex]), dtype),
        }
    params["moe"] = moe
    cfg = MoEGPTConfig(**{f.name: getattr(base_cfg, f.name)
                          for f in dataclasses.fields(base_cfg)},
                       num_experts=num_experts, moe_freq=freq)
    logger.info(f"adapted Megatron GPT-MoE: {cfg.n_layer}L d={cfg.d_model} "
                f"E={num_experts} moe_layers={moe_ids}")
    return cfg, params


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------

_ADAPTERS = {
    "gpt2": from_hf_gpt2,
    "llama": from_hf_llama,
    "mistral": from_hf_mistral,
    "internlm": from_hf_internlm,
    "opt": from_hf_opt,
    "bloom": from_hf_bloom,
    "gpt_neox": from_hf_gpt_neox,
    "gpt_neo": from_hf_gpt_neo,
    "gptj": from_hf_gptj,
    "bert": from_hf_bert,
    "distilbert": from_hf_distilbert,
    "megatron": from_megatron_gpt,
}
_ENCODERS = ("bert", "distilbert")


def adapt_hf_model(model, dtype=torch.float32):
    """HF model -> (config, params), dispatched on `config.model_type`
    (reference: `replace_policy.py` policy matching)."""
    mt = getattr(model.config, "model_type", None)
    if mt not in _ADAPTERS:
        raise NotImplementedError(
            f"no adapter for model_type={mt!r}; available: "
            f"{sorted(_ADAPTERS)}")
    return _ADAPTERS[mt](model, model.config, dtype=dtype)


def hf_decode_model(model, dtype=torch.float32):
    """HF causal LM -> DecodeModelSpec for the inference engine. The BERT
    family (encoders) is refused: use hf_train_model / bert_encode."""
    from deepspeed_tpu_torch.models.gpt import make_gpt_decode_model
    mt = getattr(model.config, "model_type", None)
    if mt in _ENCODERS:
        raise ValueError("BERT-family models are encoders: use "
                         "hf_train_model / bert_encode")
    cfg, params = adapt_hf_model(model, dtype=dtype)
    spec = make_gpt_decode_model(cfg=cfg, params=params, name=mt or "hf")
    spec.eos_token_id = getattr(model.config, "eos_token_id", None)
    return spec


def hf_train_model(model, dtype=torch.float32):
    """HF model -> training ModelSpec (continued pretraining / finetuning):
    remat on, bf16 activations; the BERT family takes the MLM loss."""
    mt = getattr(model.config, "model_type", "hf")
    cfg, params = adapt_hf_model(model, dtype=dtype)
    cfg = dataclasses.replace(cfg, remat=True, dtype=torch.bfloat16)
    if mt in _ENCODERS:
        from deepspeed_tpu_torch.models.bert import (bert_encode,
                                                     bert_mlm_loss)
        from deepspeed_tpu_torch.runtime.engine import ModelSpec
        return ModelSpec(loss_fn=partial(bert_mlm_loss, cfg=cfg),
                         params=params,
                         apply_fn=partial(bert_encode, cfg=cfg),
                         arch_cfg=cfg, name=mt)
    from deepspeed_tpu_torch.models.gpt import make_gpt_model
    return make_gpt_model(cfg=cfg, name=mt, params=params)
