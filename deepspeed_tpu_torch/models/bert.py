"""BERT encoder family — MLM pretraining and classification heads
(counterpart of `deepspeed_tpu/models/bert.py`).

Post-LN (original BERT) or pre-LN (`DeepSpeedTransformerConfig.
pre_layer_norm`) encoder blocks with exact GELU, learned word / position /
token-type embeddings, an MLM head tied to the word embeddings and a tanh
pooler. Parameters keep the JAX package's tree (stacked `[L, ...]` block
leaves under the same names and shapes), drawn from numpy in the same
order, so one seed gives both packages the same weights; a Python loop over
layers takes the place of `lax.scan`, and `remat=True` wraps each block in
non-reentrant `torch.utils.checkpoint`, as `jax.checkpoint` does.

Attention goes through the dispatch's `encoder` site
(`ops/attention_dispatch.py`): with no mask the flash kernels run with
`causal=False`; with a key-padding mask the block-sparse kernels on an
all-ones layout, the mask as their additive padding row; on CPU operands
the JAX package's dense arithmetic (scores from a product in the
activation dtype, widened to fp32, scaled by 1/sqrt(hd), the mask added,
an fp32 softmax, probabilities narrowed to the activation dtype before
P.V). The kernels form fp32 scores from exact products and, on the
block-sparse path, scale q before the product; the remat replay runs the
attention forward kernel twice a layer.

LayerNorm is plain torch, as in JAX (the norms kernels have no backward).
The embedding sum reads fp32 copies of the three tables and rounds once
(JAX sums in the tables' dtype): with bf16 tables the gathers' backward
would otherwise add every position's gradient of a shared row (the type
row takes all B x T) in bf16.
"""

import dataclasses
import math
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.models.gpt import as_dtype, dtype_name
from deepspeed_tpu_torch.ops import attention_dispatch as attn_dispatch
from deepspeed_tpu_torch.ops.block_sparse_attention import (
    key_padded_attention)
from deepspeed_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -1e30          # the JAX package's mask value (bert.py:197)


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30528          # padded to a multiple of 64
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: Optional[int] = None       # default 4*d_model
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    pre_layer_norm: bool = False     # DeepSpeedTransformerConfig's knob
    remat: bool = True               # torch.utils.checkpoint each block
    use_flash_attention: Optional[bool] = None  # None: the attention
                                     # kernels run on CUDA, the dense
                                     # arithmetic on the CPU; True routes the
                                     # CPU through the kernels' wrappers;
                                     # False forbids the kernels (CUDA then
                                     # raises; ops/attention_dispatch)
    dtype: torch.dtype = torch.bfloat16  # activation dtype

    def __post_init__(self):
        if self.d_ff is None:
            self.d_ff = 4 * self.d_model
        self.dtype = as_dtype(self.dtype)
        if self.d_model % self.n_head:
            raise ValueError(f"d_model {self.d_model} / n_head {self.n_head} "
                             f"do not tile")

    @property
    def head_dim(self):
        return self.d_model // self.n_head


BERT_CONFIGS = {
    "bert-tiny": BertConfig(n_layer=2, n_head=4, d_model=128, max_seq_len=128,
                            vocab_size=1024),
    "bert-base": BertConfig(n_layer=12, n_head=12, d_model=768),
    "bert-large": BertConfig(n_layer=24, n_head=16, d_model=1024),
}


def init_bert_params(cfg: BertConfig, seed: int = 0, dtype=torch.float32):
    """The parameter tree, drawn from numpy in the JAX package's order."""
    rng = np.random.default_rng(seed)
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    dtype = as_dtype(dtype)

    def norm(*shape, scale=0.02):
        return torch.from_numpy(np.asarray(rng.normal(0.0, scale, shape),
                                           np.float32)).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype)

    block = {
        "attn_qkv_w": norm(L, D, 3 * D),
        "attn_qkv_b": zeros(L, 3 * D),
        "attn_out_w": norm(L, D, D),
        "attn_out_b": zeros(L, D),
        "ln1_scale": ones(L, D),
        "ln1_bias": zeros(L, D),
        "mlp_up_w": norm(L, D, F_),
        "mlp_up_b": zeros(L, F_),
        "mlp_down_w": norm(L, F_, D),
        "mlp_down_b": zeros(L, D),
        "ln2_scale": ones(L, D),
        "ln2_bias": zeros(L, D),
    }
    return {
        "word_emb": norm(cfg.vocab_size, D),
        "pos_emb": norm(cfg.max_seq_len, D),
        "type_emb": norm(cfg.type_vocab_size, D),
        "emb_ln_scale": ones(D),
        "emb_ln_bias": zeros(D),
        "blocks": block,
        # MLM head: dense + LN + decoder (tied to word_emb) + bias
        "mlm_dense_w": norm(D, D),
        "mlm_dense_b": zeros(D),
        "mlm_ln_scale": ones(D),
        "mlm_ln_bias": zeros(D),
        "mlm_bias": zeros(cfg.vocab_size),
        # pooler (CLS) for classification
        "pooler_w": norm(D, D),
        "pooler_b": zeros(D),
    }


def _ln(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * scale.float() + bias.float()).to(x.dtype)


def mask_bias_of(attention_mask):
    """[B, T] 0/1 mask -> the additive [B, 1, 1, T] fp32 bias (0 kept,
    -1e30 padded), computed on the mask's device."""
    return torch.where(attention_mask[:, None, None, :] != 0, 0.0,
                       NEG_INF).float()


def _attention(q, k, v, mask_bias, cfg: BertConfig):
    """q, k, v: [B, T, H, hd] -> [B, T, H, hd], bidirectional; mask_bias
    None or an additive [B, 1, 1, T] row. The program comes from the
    dispatch's `encoder` site, which reads whether a mask was passed and
    never its values."""
    B, T, H, hd = q.shape
    program = attn_dispatch.select(attn_dispatch.AttnSite(
        phase="encoder", q_len=T, kv_len=T, head_dim=hd,
        kv_dtype=dtype_name(q.dtype), on_cuda=q.is_cuda,
        force_flash=cfg.use_flash_attention,
        key_padding=mask_bias is not None))
    if program == "flash":
        return flash_attention(q, k, v, causal=False)
    if program == "block_sparse":
        if tuple(mask_bias.shape) != (B, 1, 1, T):
            raise ValueError(f"the encoder's key-padding bias is "
                             f"{tuple(mask_bias.shape)}; the kernels take "
                             f"[B, 1, 1, T] = {(B, 1, 1, T)}")
        return key_padded_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            mask_bias.reshape(B, T)).transpose(1, 2)
    if program != "dense":
        raise NotImplementedError(f"attention program {program!r} selected "
                                  f"for the encoder site has no handler")
    s = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(hd)
    if mask_bias is not None:
        s = s + mask_bias
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _bert_block(x, p, mask_bias, cfg: BertConfig):
    """x: [B, T, D]; mask_bias: None or [B, 1, 1, T] additive."""
    B, T, D = x.shape
    H, hd = cfg.n_head, cfg.head_dim
    eps = cfg.norm_eps

    def attend(h):
        qkv = h @ p["attn_qkv_w"] + p["attn_qkv_b"]
        q, k, v = (t.reshape(B, T, H, hd) for t in qkv.split(D, dim=-1))
        attn = _attention(q, k, v, mask_bias, cfg).reshape(B, T, D)
        return attn @ p["attn_out_w"] + p["attn_out_b"]

    def mlp(h):
        up = F.gelu(h @ p["mlp_up_w"] + p["mlp_up_b"])     # exact GELU
        return up @ p["mlp_down_w"] + p["mlp_down_b"]

    if cfg.pre_layer_norm:
        x = x + attend(_ln(x, p["ln1_scale"], p["ln1_bias"], eps))
        return x + mlp(_ln(x, p["ln2_scale"], p["ln2_bias"], eps))
    # post-LN (original BERT)
    x = _ln(x + attend(x), p["ln1_scale"], p["ln1_bias"], eps)
    return _ln(x + mlp(x), p["ln2_scale"], p["ln2_bias"], eps)


def bert_encode(params, input_ids, cfg: BertConfig, token_type_ids=None,
                attention_mask=None):
    """input_ids [B, T] -> sequence output [B, T, D]. `attention_mask` [B,
    T] (1 = attend) becomes the additive key bias; None attends to every
    key (the flash kernels on CUDA)."""
    B, T = input_ids.shape
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    # the three gathers read fp32 copies of the tables and the sum rounds to
    # the activation dtype once: each gather's backward sums the gradient
    # of every position that reads a row (the type row 0 takes all B x T of
    # them) in fp32, where bf16 tables would sum them in bf16
    x = params["word_emb"].float()[input_ids]
    x = x + params["pos_emb"].float()[
        torch.arange(T, device=input_ids.device)][None]
    x = x + params["type_emb"].float()[token_type_ids]
    x = _ln(x.to(cfg.dtype), params["emb_ln_scale"], params["emb_ln_bias"],
            cfg.norm_eps)
    mask_bias = None if attention_mask is None else \
        mask_bias_of(attention_mask)
    # unbind, not v[i]: one stacked gradient a leaf (models/gpt.py)
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layer):
        p = {k: v[i] for k, v in layers.items()}
        x = checkpoint(_bert_block, x, p, mask_bias, cfg, use_reentrant=False) \
            if remat else _bert_block(x, p, mask_bias, cfg)
    return x


def bert_mlm_logits(params, seq_out, cfg: BertConfig):
    h = seq_out @ params["mlm_dense_w"] + params["mlm_dense_b"]
    h = _ln(F.gelu(h), params["mlm_ln_scale"], params["mlm_ln_bias"],
            cfg.norm_eps)
    return F.linear(h, params["word_emb"].to(h.dtype)) + params["mlm_bias"]


def bert_pooled(params, seq_out):
    """CLS-token pooled output (tanh dense)."""
    return torch.tanh(seq_out[:, 0] @ params["pooler_w"] + params["pooler_b"])


def _encode_batch(params, batch, cfg):
    return bert_encode(params, batch["input_ids"], cfg,
                       token_type_ids=batch.get("token_type_ids"),
                       attention_mask=batch.get("attention_mask"))


def bert_mlm_loss(params, batch, rng=None, cfg: BertConfig = None):
    """batch: input_ids [B, T], labels [B, T] with -100 = unmasked (HF
    convention), optional token_type_ids / attention_mask. Mean fp32 cross
    entropy over the labelled positions."""
    logits = bert_mlm_logits(params, _encode_batch(params, batch, cfg),
                             cfg).float()
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)


def bert_cls_loss(params, batch, rng=None, cfg: BertConfig = None,
                  num_classes=2):
    """Sequence classification on the pooled CLS token; labels [B]."""
    pooled = bert_pooled(params, _encode_batch(params, batch, cfg))
    logits = (pooled @ params["cls_w"] + params["cls_b"]).float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[:, None])[:, 0]
    return (logz - gold).mean()


def make_bert_model(cfg: BertConfig = None, name="bert-base", seed=0,
                    task="mlm", num_classes=2, params=None):
    """ModelSpec for the training engine: the MLM loss (`task="mlm"`) or
    the CLS classification loss (`task="cls"`, whose head is drawn from
    numpy `seed + 1`), the params (drawn from `seed` unless given) and
    `bert_encode` for evaluation."""
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    cfg = cfg or BERT_CONFIGS[name]
    if params is None:
        params = init_bert_params(cfg, seed=seed)
    if task == "cls":
        if "cls_w" not in params:
            rng = np.random.default_rng(seed + 1)
            params["cls_w"] = torch.from_numpy(np.asarray(
                rng.normal(0, 0.02, (cfg.d_model, num_classes)), np.float32))
            params["cls_b"] = torch.zeros((num_classes,), dtype=torch.float32)
        loss = partial(bert_cls_loss, cfg=cfg, num_classes=num_classes)
    elif task == "mlm":
        loss = partial(bert_mlm_loss, cfg=cfg)
    else:
        raise ValueError(f"unknown BERT task {task!r} (mlm or cls)")
    return ModelSpec(loss_fn=loss, params=params,
                     apply_fn=partial(bert_encode, cfg=cfg), arch_cfg=cfg,
                     name=name)
