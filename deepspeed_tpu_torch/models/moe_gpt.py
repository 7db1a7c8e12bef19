"""MoE-GPT — GPT with Mixture-of-Experts MLPs, training and serving, at one
rank (counterpart of `deepspeed_tpu/models/moe_gpt.py`).

Every `moe_freq`-th block (from block 1) replaces its MLP with an expert
layer; the attention half and the rest of the block are `models/gpt.py`'s.
The dense MLP leaves of those blocks stay in the stacked `blocks` tree,
unused (their gradients are zero), exactly as in the JAX package, so one
initialisation moves across leaf by leaf with `params_from_jax`
(`params["moe"]["<layer>"]` holds the expert tree).

Training routes with static-capacity top-1 gating (`parallel/moe.py`'s
einsum path; the JAX package's cross-rank `shard_map` route raises here);
capacity overflow masks tokens, and the loss's aux dict carries
`moe/aux_loss`, `moe/overflow_tokens` and `moe/dropped_frac`, which the
engine surfaces in its step metrics. As in the JAX package the forward runs
no remat, whatever `cfg.remat` says.

Inference routes capacity-free (`_moe_mlp_nodrop`): every token goes to its
argmax expert, weighted by its gate probability, so routing depends only on
the token — any batching or chunking of a prompt gives the same outputs,
which the paged serving path relies on. Like the JAX package it computes
all E experts' FFN for every token and masks (E x the FFN work).
"""

import dataclasses
from functools import partial

import numpy as np
import torch

from deepspeed_tpu_torch.models.gpt import (
    GPTConfig, _attn_half, _block, _block_decode, _decode_attn_half, _embed,
    _head_logits, _layer, _lm_head, _norm, _paged_attn_half, _residual_mlp,
    as_dtype, init_gpt_params, init_kv_cache, init_paged_kv_pool)
from deepspeed_tpu_torch.parallel.moe import (_one_hot,
                                              can_use_expert_shard_map,
                                              expert_parallel_moe,
                                              gating_drop_stats, top1_gating)


@dataclasses.dataclass
class MoEGPTConfig(GPTConfig):
    num_experts: int = 8
    moe_freq: int = 2                 # every moe_freq-th block is MoE (from 1)
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    moe_aux_weight: float = 0.01

    def moe_layer_ids(self):
        return [i for i in range(self.n_layer) if i % self.moe_freq == 1]


def init_moe_gpt_params(cfg: MoEGPTConfig, seed: int = 0,
                        dtype=torch.float32):
    """The dense skeleton (`init_gpt_params`) plus each MoE layer's expert
    tree {layer_id: {gate_w, w_up [E, D, F], b_up, w_down [E, F, D],
    b_down}}, drawn from numpy at `seed + 7` in the JAX package's order."""
    params = init_gpt_params(cfg, seed=seed, dtype=dtype)
    rng = np.random.default_rng(seed + 7)
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    dtype = as_dtype(dtype)

    def normal(scale, shape):
        return torch.from_numpy(np.asarray(rng.normal(0, scale, shape),
                                           np.float32)).to(dtype)

    params["moe"] = {str(lid): {
        "gate_w": normal(0.02, (D, E)),
        "w_up": normal(0.02, (E, D, F_)),
        "b_up": torch.zeros((E, F_), dtype=dtype),
        "w_down": normal(0.02 / np.sqrt(2 * cfg.n_layer), (E, F_, D)),
        "b_down": torch.zeros((E, D), dtype=dtype),
    } for lid in cfg.moe_layer_ids()}
    return params


def _gate_logits(xf, gate_w):
    """(xf @ gate_w) in the promoted dtype of the two (x's on the model
    path), then widened to fp32 — unlike `dropless_moe`'s fp32 product."""
    dt = torch.promote_types(xf.dtype, gate_w.dtype)
    return (xf.to(dt) @ gate_w.to(dt)).float()


def _expert_ffn(xe, mp, cfg):
    """xe [E, C, D] tokens per expert -> [E, C, D], batched over experts."""
    h = xe @ mp["w_up"] + mp["b_up"][:, None, :]
    h = torch.nn.functional.gelu(h, approximate="tanh") \
        if cfg.activation == "gelu" else torch.relu(h)
    return h @ mp["w_down"] + mp["b_down"][:, None, :]


def _moe_mlp(x, mp, cfg: MoEGPTConfig, training=True, mesh=None):
    """x [B, T, D] -> (out, l_aux, drop_stats): static-capacity top-1
    routing, the GShard dispatch / combine einsums."""
    B, T, D = x.shape
    E = cfg.num_experts
    cf = cfg.capacity_factor if training else cfg.eval_capacity_factor
    xf = x.reshape(B * T, D)
    if can_use_expert_shard_map(mesh, E, B * T):
        expert_parallel_moe()
    l_aux, dispatch, combine, counts = top1_gating(
        _gate_logits(xf, mp["gate_w"]), capacity_factor=cf,
        min_capacity=cfg.min_capacity)
    stats = gating_drop_stats(dispatch, counts)
    xe = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), xf)
    ye = _expert_ffn(xe, mp, cfg)
    out = torch.einsum("nec,ecd->nd", combine.to(x.dtype), ye)
    return out.reshape(B, T, D), l_aux, stats


def _nodrop_gates(xf, gate_w):
    """Capacity-free routing of tokens xf [N, D]: (probs [N, E] fp32, the
    argmax expert [N])."""
    probs = torch.softmax(_gate_logits(xf, gate_w), dim=-1)
    return probs, torch.argmax(probs, dim=-1)


def _moe_mlp_nodrop(x, mp, cfg: MoEGPTConfig):
    """Capacity-free inference routing: x [B, T, D] -> (out, l_aux).

    Every token goes to its argmax expert, weighted by the gate
    probability; every token passes through all experts' rows and a one-hot
    mask keeps its own (E x the FFN work, static shapes, as in JAX). The
    me·ce aux loss is still reported."""
    B, T, D = x.shape
    E = cfg.num_experts
    xf = x.reshape(B * T, D)
    probs, top = _nodrop_gates(xf, mp["gate_w"])
    gate = probs.gather(-1, top[:, None])[:, 0].to(x.dtype)
    onehot = _one_hot(top, E, x.dtype)                      # [N, E]
    l_aux = torch.sum(probs.mean(dim=0) * onehot.float().mean(dim=0)) * E
    xe = torch.einsum("ne,nd->end", onehot, xf)             # [E, N, D]
    ye = _expert_ffn(xe, mp, cfg)
    out = torch.einsum("ne,end->nd", onehot, ye) * gate[:, None]
    return out.reshape(B, T, D), l_aux


def _zero_drop_stats(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"routed": z, "kept": z, "overflow_tokens": z, "dropped_frac": z}


def _sum_drop_stats(acc, s):
    acc = {k: acc[k] + s[k] for k in ("routed", "kept", "overflow_tokens")}
    acc["dropped_frac"] = acc["overflow_tokens"] / acc["routed"].clamp_min(1.0)
    return acc


def _moe_block(x, p, mp, cfg, positions, training, mesh=None):
    """A transformer block whose MLP half is the expert layer (the
    attention half is gpt.py's). Returns (x, l_aux, drop_stats)."""
    aux = []

    def moe_fn(h):
        if training:
            out, l_aux, stats = _moe_mlp(h, mp, cfg, training=True,
                                         mesh=mesh)
        else:
            out, l_aux = _moe_mlp_nodrop(h, mp, cfg)
            stats = _zero_drop_stats(h.device)
        aux.append((l_aux, stats))
        return out

    attn_out, _, _ = _attn_half(x, p, cfg, positions)
    x = _residual_mlp(x, attn_out, p, cfg, mlp_fn=moe_fn)
    return (x, *aux[0])


def moe_gpt_forward(params, tokens, cfg: MoEGPTConfig, training=True,
                    rng=None, mesh=None, return_stats=False):
    """tokens [B, T] -> (logits, total l_aux[, drop_stats]): a Python loop
    over the layers (MoE layers break the stacked-block homogeneity)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    x = _embed(params, tokens, positions, cfg)
    l_aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    stats_total = _zero_drop_stats(x.device)
    moe_ids = set(cfg.moe_layer_ids())
    # unbind, not v[i]: one stacked gradient per leaf (see gpt_hidden)
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for lid in range(cfg.n_layer):
        p = {k: v[lid] for k, v in layers.items()}
        if lid in moe_ids:
            x, l_aux, stats = _moe_block(x, p, params["moe"][str(lid)], cfg,
                                         positions, training, mesh)
            l_aux_total = l_aux_total + l_aux
            stats_total = _sum_drop_stats(stats_total, stats)
        else:
            x = _block(x, p, cfg, positions)
    x = _norm(x, params["lnf_scale"], params.get("lnf_bias"), cfg.use_rmsnorm,
              cfg.norm_eps)
    logits = _head_logits(params, x, cfg)
    if return_stats:
        return logits, l_aux_total, stats_total
    return logits, l_aux_total


def moe_gpt_loss(params, batch, rng=None, cfg: MoEGPTConfig = None,
                 mesh=None):
    """Causal-LM cross entropy (fp32 log-sum-exp, labels < 0 ignored) plus
    `moe_aux_weight` x the load-balancing loss. Returns (loss, aux); the
    slash-keyed aux entries are the engine's `moe/*` step metrics."""
    tokens = batch.get("tokens", batch.get("input_ids"))
    labels = batch.get("labels")
    if labels is None:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs = tokens
    logits, l_aux, stats = moe_gpt_forward(params, inputs, cfg, training=True,
                                           rng=rng, mesh=mesh,
                                           return_stats=True)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    safe = labels.clamp_min(0).long()
    gold = logits.gather(-1, safe[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)
    aux = {"lm_loss": nll, "l_aux": l_aux,
           "moe/aux_loss": l_aux,
           "moe/overflow_tokens": stats["overflow_tokens"],
           "moe/dropped_frac": stats["dropped_frac"]}
    return nll + cfg.moe_aux_weight * l_aux, aux


def make_moe_gpt_model(cfg: MoEGPTConfig, name="moe-gpt", seed=0, mesh=None,
                       params=None):
    """ModelSpec for the training engine (params drawn from numpy `seed`
    unless given)."""
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    return ModelSpec(
        loss_fn=partial(moe_gpt_loss, cfg=cfg, mesh=mesh),
        params=init_moe_gpt_params(cfg, seed=seed) if params is None
        else params,
        has_aux=True,
        apply_fn=partial(moe_gpt_forward, cfg=cfg, training=False),
        arch_cfg=cfg, name=name)


# ----------------------------------------------------------------------
# inference
# ----------------------------------------------------------------------


def _moe_mlp_decode(x, mp, cfg):
    """Single-token routing: the [B, 1, D] case of `_moe_mlp_nodrop`."""
    return _moe_mlp_nodrop(x, mp, cfg)[0]


def _moe_block_decode(x, p, mp, cache_k, cache_v, pos, cfg):
    """`_block_decode` with the MLP replaced by single-token MoE routing."""
    attn_out, cache_k, cache_v = _decode_attn_half(x, p, cache_k, cache_v,
                                                   pos, cfg)
    x = _residual_mlp(x, attn_out, p, cfg,
                      mlp_fn=lambda h: _moe_mlp_decode(h, mp, cfg))
    return x, cache_k, cache_v


def make_moe_gpt_decode_model(cfg: MoEGPTConfig, params=None, name="moe-gpt",
                              seed=0):
    """DecodeModelSpec for the inference engine: prefill + per-token decode
    over the contiguous cache, and the paged-pool serving contract, with
    capacity-free expert routing."""
    from deepspeed_tpu_torch.inference.engine import DecodeModelSpec
    if params is None:
        params = init_moe_gpt_params(cfg, seed=seed)
    moe_ids = set(cfg.moe_layer_ids())

    def mlp_fn(params, lid):
        if lid not in moe_ids:
            return None
        mp = params["moe"][str(lid)]
        return lambda h: _moe_mlp_nodrop(h, mp, cfg)[0]

    def prefill_fn(params, tokens, cache, pad_mask=None):
        B, T = tokens.shape
        positions = torch.arange(T, device=tokens.device).expand(B, T)
        x = _embed(params, tokens, positions, cfg)
        for lid in range(cfg.n_layer):
            p = _layer(params, lid)
            attn_out, k, v = _attn_half(x, p, cfg, positions)
            cache["k"][lid, :, :, :T] = k.transpose(1, 2)
            cache["v"][lid, :, :, :T] = v.transpose(1, 2)
            x = _residual_mlp(x, attn_out, p, cfg,
                              mlp_fn=mlp_fn(params, lid))
        cache["length"].fill_(T)
        return _lm_head(params, x, cfg), cache

    def decode_fn(params, token, pos, cache):
        x = _embed(params, token[:, None], pos[:, None], cfg)
        for lid in range(cfg.n_layer):
            p = _layer(params, lid)
            if lid in moe_ids:
                x, _, _ = _moe_block_decode(x, p, params["moe"][str(lid)],
                                            cache["k"][lid], cache["v"][lid],
                                            pos, cfg)
            else:
                x, _, _ = _block_decode(x, p, cache["k"][lid],
                                        cache["v"][lid], pos, cfg)
        cache["length"] += 1
        return _lm_head(params, x, cfg)[:, 0], cache

    def init_cache(batch_size, max_len, dtype=torch.bfloat16, device="cpu"):
        return init_kv_cache(cfg, batch_size, max_len, dtype, device)

    def _walk_paged(params, x, pool, block_tables, positions):
        for lid in range(cfg.n_layer):
            pool_l = {name: leaf[lid] for name, leaf in pool.items()}
            p = _layer(params, lid)
            attn_out, _ = _paged_attn_half(x, p, pool_l, positions,
                                           block_tables, cfg)
            x = _residual_mlp(x, attn_out, p, cfg,
                              mlp_fn=mlp_fn(params, lid))
        return x

    def prefill_paged_fn(params, tokens, start_pos, last_idx, pool,
                         block_tables):
        B, C = tokens.shape
        positions = start_pos[:, None] + torch.arange(
            C, device=tokens.device)[None]
        x = _embed(params, tokens, positions, cfg)
        x = _walk_paged(params, x, pool, block_tables, positions)
        last = x[torch.arange(B, device=x.device), last_idx][:, None]
        return _lm_head(params, last, cfg)[:, 0], pool

    def decode_paged_fn(params, token, pos, pool, block_tables):
        x = _embed(params, token[:, None], pos[:, None], cfg)
        x = _walk_paged(params, x, pool, block_tables, pos[:, None])
        return _lm_head(params, x, cfg)[:, 0], pool

    def init_paged_pool(num_blocks, block_size, dtype=torch.bfloat16,
                        kv_group_size=0, device="cpu"):
        return init_paged_kv_pool(cfg, num_blocks, block_size, dtype,
                                  kv_group_size, device)

    return DecodeModelSpec(
        prefill_fn=prefill_fn, decode_fn=decode_fn, init_cache=init_cache,
        params=params, name=name, prefill_paged_fn=prefill_paged_fn,
        decode_paged_fn=decode_paged_fn, init_paged_pool=init_paged_pool,
        dtype=cfg.dtype,
        max_positions=None if cfg.use_rotary else cfg.max_seq_len)
