"""GPT family — training and serving (counterpart of
`deepspeed_tpu/models/gpt.py`).

Pre-LN GPT-2 (learned positions, LayerNorm, GELU, MHA) with the cheap
LLaMA-style flags (rotary embeddings, RMSNorm, SwiGLU, grouped-query
attention) and the NeoX/GPT-J parallel residual. Alibi, sliding windows and
per-layer attention types raise `NotImplementedError` until a later slice
ports them (the flash kernels take no bias and no window). Training:
`gpt_hidden` / `gpt_forward` / `gpt_loss`, and `make_gpt_model` for the
engine; remat wraps each block in non-reentrant `torch.utils.checkpoint`
under the config's `remat_policy` (`resolve_remat_policy`: the argument-free
`jax.checkpoint_policies` names and the package's `save_matmuls` /
`save_matmuls_probs`). `loss_chunks > 0` takes the chunked-vocab cross
entropy (`ops/chunked_ce.py`), `chunked_attn_min_seq` the query-chunked
attention (`ops/chunked_attention.py`), and `gpt_hidden` runs the engine's
routing directives: progressive layer drop and random-LTD.
An `attn_fn` (q, k, v [B, T, H, hd] -> [B, T, H, hd], e.g.
`ops/sparse_attention.sparse_attn_fn`) replaces the attention of every
training and evaluation forward, as in the JAX package.

On a mesh whose `sequence` axis is above 1 the training forward and loss
take this rank's token shard [B, T/sp] (the engine cuts it): positions
are offset by rank x T/sp for the learned table and for rope, the
attention runs the ring programs (`attention_backend` "ring" /
"ring_ulysses") or a sequence-parallel `attn_fn`
(`parallel.DistributedAttention`), and the loss is JAX's global mean —
the nll sum and the label count summed over the `sequence` group, the
sum's backward the identity, so each rank's grads are its tokens' share
of the global loss's (the engine sums them over the group).

Parameters keep the JAX package's tree: stacked `[L, ...]` block leaves
under the same names and shapes, so `params_from_jax` moves one
initialisation across leaf by leaf. A Python loop over layers takes the
place of `lax.scan`. KV caches and pools are updated IN PLACE (the JAX
functions return new ones); every function still returns the cache/pool it
was given, so the call shapes match the reference.

Serving takes weight-only quantized trees (`inference/quantization.py`):
a `QuantizedTensor` leaf dequantizes where it is used — one layer's leaves
in `_layer`, the gathered rows in `_embed`, the table in `_head_logits` —
so the dense tree never exists whole. The paged pool may be int8
(`init_paged_kv_pool(dtype=torch.int8)`): K/V quantize as they are written
and dequantize as they are read.
"""

import dataclasses
import math
from functools import partial
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deepspeed_tpu_torch.inference.quantization import (
    QuantizedTensor, dense, dequantize_tensors, quantize_kv_write)
from deepspeed_tpu_torch.ops import attention_dispatch as attn_dispatch
from deepspeed_tpu_torch.ops.chunked_attention import chunked_attention
from deepspeed_tpu_torch.ops.chunked_ce import chunked_softmax_xent
from deepspeed_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference, paged_decode_attention,
    paged_decode_attention_quant)
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                     flash_attention_reference)
from deepspeed_tpu_torch.utils.checkpoint_names import (checkpoint_name,
                                                        current_name)

_DTYPES = {"float32": torch.float32, "float": torch.float32,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


def as_dtype(dtype):
    """torch dtype from a torch dtype, its name ("bfloat16", ...) or a
    numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPES:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            pass
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def dtype_name(dtype):
    return str(dtype).replace("torch.", "")


# ----------------------------------------------------------------------
# remat policies
# ----------------------------------------------------------------------


SAVE_MATMULS_NAMES = ("qkv_proj", "attn_out", "mlp_up", "mlp_down")

_aten = torch.ops.aten
# the dots without batch dimensions (the projections) and with them (the
# plain attention's score and value products)
_DOTS_NO_BATCH = frozenset({_aten.mm, _aten.addmm})
_DOTS = _DOTS_NO_BATCH | {_aten.bmm, _aten.baddbmm}
# allocations: the flash kernels write their outputs into these (through
# ctypes, unseen by the dispatcher), so a cached one would be written again
# by the recomputed kernel
_ALLOCS = frozenset({_aten.empty, _aten.empty_like, _aten.empty_strided,
                     _aten.new_empty, _aten.new_empty_strided})

_SAVE, _RECOMPUTE = CheckpointPolicy.MUST_SAVE, \
    CheckpointPolicy.PREFER_RECOMPUTE


def _savable(func, args, kwargs):
    """An op whose output a policy may keep: not a view, not a mutation,
    not an allocation, and computed from some tensor."""
    if func.is_view or func._schema.is_mutable \
            or func.overloadpacket in _ALLOCS:
        return False
    return any(isinstance(a, torch.Tensor) for a in args) or \
        any(isinstance(a, torch.Tensor) for a in kwargs.values())


def _ops_policy(ops):
    def policy(ctx, func, *args, **kwargs):
        return _SAVE if func.overloadpacket in ops else _RECOMPUTE
    return policy


def _everything_policy(ctx, func, *args, **kwargs):
    return _SAVE if _savable(func, args, kwargs) else _RECOMPUTE


def _names_policy(names):
    def policy(ctx, func, *args, **kwargs):
        return _SAVE if current_name() in names and \
            _savable(func, args, kwargs) else _RECOMPUTE
    return policy


# remat_policy name -> the op policy of torch's selective checkpoint (None:
# plain checkpoint, every op recomputed). JAX's argument-free
# `jax.checkpoint_policies` names and its two package names.
REMAT_POLICIES = {
    "nothing_saveable": None,
    "everything_saveable": _everything_policy,
    "dots_saveable": _ops_policy(_DOTS),
    "checkpoint_dots": _ops_policy(_DOTS),
    "dots_with_no_batch_dims_saveable": _ops_policy(_DOTS_NO_BATCH),
    "checkpoint_dots_with_no_batch_dims": _ops_policy(_DOTS_NO_BATCH),
    "save_matmuls": _names_policy(frozenset(SAVE_MATMULS_NAMES)),
    "save_matmuls_probs": _names_policy(
        frozenset(SAVE_MATMULS_NAMES + ("attn_probs",))),
}


def resolve_remat_policy(name):
    """remat_policy string -> the wrapper a block runs under with remat on:
    non-reentrant `torch.utils.checkpoint`, with torch's selective contexts
    over the name's op policy.

    * "nothing_saveable" keeps only the block's input (plain checkpoint);
    * "dots_with_no_batch_dims_saveable" keeps the outputs of `aten.mm` /
      `aten.addmm` (the projections), "dots_saveable" also `aten.bmm` /
      `aten.baddbmm`; every other op is recomputed;
    * "everything_saveable" keeps every op's output but views, mutations
      and allocations;
    * "save_matmuls" keeps the ops of the `qkv_proj`, `attn_out`, `mlp_up`
      and `mlp_down` regions (`utils/checkpoint_names.py`: the JAX
      package's checkpoint names), "save_matmuls_probs" also the plain
      attention's `attn_probs`. The flash path has no probs tensor, so
      there both keep the same ops.

    The recompute replays every op the policy does not keep. The attention
    kernels launch through ctypes and the dispatcher never sees them: no
    policy keeps their outputs, so the backward runs their forward again
    (in JAX a `pallas_call` is no dot either), and the allocations they
    write into are never kept. A name that is not in `REMAT_POLICIES` (an
    unknown one, or a `jax.checkpoint_policies` factory such as
    `save_only_these_names`) raises ValueError."""
    if name not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat_policy {name!r}: expected one of "
            f"{sorted(REMAT_POLICIES)} (the policy factories of "
            f"jax.checkpoint_policies take arguments a config cannot give)")
    policy = REMAT_POLICIES[name]
    if policy is None:
        return partial(checkpoint, use_reentrant=False)
    return partial(checkpoint, use_reentrant=False,
                   context_fn=partial(create_selective_checkpoint_contexts,
                                      policy))


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: Optional[int] = None  # grouped-query attention; None = n_head
    d_model: int = 768
    d_ff: Optional[int] = None       # default 4*d_model (8/3 for swiglu)
    max_seq_len: int = 1024
    use_rotary: bool = False         # False: learned positions (GPT-2)
    rotary_pct: float = 1.0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    use_swiglu: bool = False
    use_rmsnorm: bool = False
    activation: str = "gelu"         # "gelu" (tanh approx), "relu",
                                     # "quick_gelu"
    use_alibi: bool = False          # not ported
    use_emb_ln: bool = False         # BLOOM LayerNorm after the embedding
    parallel_residual: bool = False  # NeoX/GPT-J: x + attn(ln1 x) + mlp(ln2 x)
    sliding_window: Optional[int] = None      # not ported
    attn_layer_types: Optional[tuple] = None  # not ported
    scale_attn: bool = True          # False: unscaled scores (GPT-Neo)
    tie_embeddings: bool = True
    remat: bool = True               # torch.utils.checkpoint each block
    remat_policy: str = "nothing_saveable"  # REMAT_POLICIES
    dropout: float = 0.0             # accepted and never applied, as in the
                                     # JAX package, whose GPTConfig carries
                                     # the field (deepspeed_tpu/models/
                                     # gpt.py:46) and whose blocks read no
                                     # dropout (`_block`'s unused dropout_rng)
    loss_chunks: int = 0             # > 0: chunked-vocab CE in that many
                                     # vocabulary chunks (ops/chunked_ce.py)
    chunked_attn_min_seq: Optional[int] = None  # T >= this takes the
                                     # query-chunked attention
                                     # (ops/chunked_attention.py) in place of
                                     # the flash kernels; None = never
    softmax_dtype: torch.dtype = torch.float32  # the plain path's softmax
                                     # dtype (fp32 only); the flash kernels
                                     # keep fp32 statistics whatever it says
    attention_backend: Optional[str] = None  # explicit attention-program
                                     # request: "ring" / "ring_ulysses"
                                     # engage context parallelism over a
                                     # live `sequence` mesh axis
                                     # (ops/attention_dispatch); ignored
                                     # (the auto choice) without one
    use_flash_attention: Optional[bool] = None  # None: the attention
                                     # kernels run on CUDA, plain versions on
                                     # the CPU; True routes the CPU through
                                     # the wrappers; False forbids the kernels
                                     # (CUDA then raises; ops/attention_dispatch)
    dtype: torch.dtype = torch.bfloat16  # activation dtype

    def __post_init__(self):
        if self.d_ff is None:
            self.d_ff = int(8 * self.d_model / 3) if self.use_swiglu \
                else 4 * self.d_model
        if self.n_kv_head is None:
            self.n_kv_head = self.n_head
        self.dtype = as_dtype(self.dtype)
        self.softmax_dtype = as_dtype(self.softmax_dtype)
        if self.d_model % self.n_head or self.n_head % self.n_kv_head:
            raise ValueError(f"d_model {self.d_model} / n_head {self.n_head} "
                             f"/ n_kv_head {self.n_kv_head} do not tile")
        unported = [name for name, on in (
            ("use_alibi", self.use_alibi),
            ("sliding_window", bool(self.sliding_window)),
            ("attn_layer_types", self.attn_layer_types is not None),
        ) if on]
        if unported:
            raise NotImplementedError(
                f"GPTConfig flags {unported} are not ported to "
                f"deepspeed_tpu_torch yet (the JAX package serves them)")
        if self.remat:
            resolve_remat_policy(self.remat_policy)     # raises if unknown

    @property
    def head_dim(self):
        return self.d_model // self.n_head

    @property
    def qkv_dim(self):
        return (self.n_head + 2 * self.n_kv_head) * self.head_dim

    def num_params(self):
        """The JAX package's estimate (norms and biases approximated as 4 x
        d_model a block)."""
        wpe = 0 if self.use_rotary else self.max_seq_len * self.d_model
        per_block = (self.d_model * (self.qkv_dim + self.d_model)
                     + (3 if self.use_swiglu else 2) * self.d_model * self.d_ff
                     + 4 * self.d_model)
        emb = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        return emb + head + wpe + self.n_layer * per_block


GPT2_CONFIGS = {
    "gpt2-tiny": GPTConfig(n_layer=2, n_head=4, d_model=128, max_seq_len=256,
                           vocab_size=1024),
    "gpt2-125m": GPTConfig(n_layer=12, n_head=12, d_model=768,
                           max_seq_len=1024),
    "gpt2-350m": GPTConfig(n_layer=24, n_head=8, d_model=1024,
                           max_seq_len=1024),
    "gpt2-760m": GPTConfig(n_layer=24, n_head=12, d_model=1536,
                           max_seq_len=1024),
    "gpt2-1.3b": GPTConfig(n_layer=24, n_head=16, d_model=2048,
                           max_seq_len=1024),
    "gpt2-2.7b": GPTConfig(n_layer=32, n_head=20, d_model=2560,
                           max_seq_len=1024),
    "gpt2-6.7b": GPTConfig(n_layer=32, n_head=32, d_model=4096,
                           max_seq_len=1024),
}


# ----------------------------------------------------------------------
# init + weights from the JAX package
# ----------------------------------------------------------------------


def init_gpt_params(cfg: GPTConfig, seed: int = 0, dtype=torch.float32):
    """Stacked-block parameter tree, drawn from numpy in the same order as
    the JAX package's `init_gpt_params` — one seed gives both packages the
    same weights. Block leaves have leading dim n_layer."""
    rng = np.random.default_rng(seed)
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    dtype = as_dtype(dtype)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

    def norm(*shape, scale=0.02):
        return t(rng.normal(0.0, scale, shape))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype)

    proj_scale = 0.02 / math.sqrt(2 * L)
    block = {
        "ln1_scale": ones(L, D),
        "ln2_scale": ones(L, D),
        "attn_qkv_w": norm(L, D, cfg.qkv_dim),
        "attn_qkv_b": zeros(L, cfg.qkv_dim),
        "attn_out_w": norm(L, D, D, scale=proj_scale),
        "attn_out_b": zeros(L, D),
        "mlp_out_b": zeros(L, D),
    }
    if not cfg.use_rmsnorm:
        block["ln1_bias"] = zeros(L, D)
        block["ln2_bias"] = zeros(L, D)
    if cfg.use_swiglu:
        block["mlp_gate_w"] = norm(L, D, F_)
        block["mlp_up_w"] = norm(L, D, F_)
    else:
        block["mlp_up_w"] = norm(L, D, F_)
        block["mlp_up_b"] = zeros(L, F_)
    block["mlp_down_w"] = norm(L, F_, D, scale=proj_scale)

    params = {"wte": norm(cfg.vocab_size, D), "blocks": block,
              "lnf_scale": ones(D)}
    if not cfg.use_rmsnorm:
        params["lnf_bias"] = zeros(D)
    if not cfg.use_rotary:
        params["wpe"] = norm(cfg.max_seq_len, D, scale=0.01)
    if cfg.use_emb_ln:
        params["emb_ln_scale"] = ones(D)
        params["emb_ln_bias"] = zeros(D)
    if not cfg.tie_embeddings:
        params["lm_head"] = norm(cfg.vocab_size, D)
    return params


def params_from_jax(tree):
    """A JAX `init_gpt_params` / `make_gpt_decode_model(...).params` tree,
    already converted to numpy (`jax.tree_util.tree_map(np.asarray, ...)`),
    as the port's parameter tree: same names, shapes and dtypes, leaf by
    leaf. bfloat16 leaves (ml_dtypes) move bit for bit. A weight-only
    quantized leaf (the JAX `QuantizedTensor`: numpy `q` / `scale` plus
    bits, group_size, shape and dtype) becomes the port's QuantizedTensor
    with the same payload and scale bytes."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QuantizedTensor(
            q=params_from_jax(tree.q), scale=params_from_jax(tree.scale),
            bits=int(tree.bits), group_size=int(tree.group_size),
            shape=tuple(int(n) for n in tree.shape),
            dtype=as_dtype(tree.dtype))
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# ----------------------------------------------------------------------
# forward pieces
# ----------------------------------------------------------------------


def _norm(x, scale, bias, use_rms, eps=1e-5):
    xf = x.float()
    if use_rms:
        xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (xf * scale.float()).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * scale.float() + bias.float()).to(x.dtype)


def _act(x, cfg):
    if cfg.activation == "relu":
        return F.relu(x)
    if cfg.activation == "quick_gelu":  # CLIP: x * sigmoid(1.702x)
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="tanh")


def _rope(x, positions, rotary_dims, theta=10000.0):
    """Rotary position embedding over the first `rotary_dims` of the head
    dim (interleaved pairs, GPT-J style). x: [B, T, H, hd]; positions:
    [B, T]."""
    rd = rotary_dims
    freqs = 1.0 / (theta ** (torch.arange(0, rd, 2, dtype=torch.float32,
                                          device=x.device) / rd))
    angles = positions[..., None].float() * freqs            # [B, T, rd/2]
    cos = angles.cos()[:, :, None, :]
    sin = angles.sin()[:, :, None, :]
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(x_rot.shape)
    if rd < x.shape[-1]:
        rotated = torch.cat([rotated, x_pass.float()], dim=-1)
    return rotated.to(x.dtype)


def _rotary_dims(cfg):
    return int(cfg.rotary_pct * cfg.head_dim) // 2 * 2


def _embed(params, tokens, positions, cfg: GPTConfig):
    """Token embedding + learned position embedding + BLOOM emb LayerNorm.
    A quantized table dequantizes only the gathered rows."""
    x = dense(params["wte"][tokens]).to(cfg.dtype)
    if not cfg.use_rotary:
        x = x + dense(params["wpe"][positions]).to(cfg.dtype)
    if cfg.use_emb_ln:
        x = _norm(x, params["emb_ln_scale"], params["emb_ln_bias"],
                  use_rms=False, eps=cfg.norm_eps)
    return x


def _mlp(h, p, cfg):
    """The MLP half; the up projections and the activation are the
    `mlp_up` region of `save_matmuls`, the down projection `mlp_down` (the
    JAX package's checkpoint names)."""
    with checkpoint_name("mlp_up"):
        if cfg.use_swiglu:
            up = F.silu(h @ p["mlp_gate_w"]) * (h @ p["mlp_up_w"])
        else:
            up = _act(h @ p["mlp_up_w"] + p["mlp_up_b"], cfg)
    with checkpoint_name("mlp_down"):
        return up @ p["mlp_down_w"] + p["mlp_out_b"]


def _residual_mlp(x, attn_out, p, cfg: GPTConfig, mlp_fn=None):
    """Residual second half of a block; `mlp_fn` lets MoE swap the dense
    MLP. With `parallel_residual` (NeoX/GPT-J) both halves read the block's
    input: x + attn(ln1 x) + mlp(ln2 x)."""
    if not cfg.parallel_residual:
        x = x + attn_out
    h2 = _norm(x, p["ln2_scale"], p.get("ln2_bias"), cfg.use_rmsnorm,
               cfg.norm_eps)
    mlp = _mlp(h2, p, cfg) if mlp_fn is None else mlp_fn(h2)
    if cfg.parallel_residual:
        return x + attn_out + mlp
    return x + mlp


def _head_table(params, cfg: GPTConfig):
    """The (tied) LM-head table [V, D]."""
    return params["wte"] if cfg.tie_embeddings else params["lm_head"]


def _head_logits(params, x, cfg: GPTConfig):
    """LM-head matmul (+ GPT-J's tied bias). x: [B, T, D] -> [B, T, V]."""
    return F.linear(x, dense(_head_table(params, cfg)).to(x.dtype),
                    params.get("lm_head_bias"))


def _final_norm(params, x, cfg: GPTConfig):
    return _norm(x, params["lnf_scale"], params.get("lnf_bias"),
                 cfg.use_rmsnorm, cfg.norm_eps)


def _lm_head(params, x, cfg: GPTConfig):
    return _head_logits(params, _final_norm(params, x, cfg), cfg)


def _sm_scale(cfg):
    """Kernel sm_scale: None = 1/sqrt(hd); GPT-Neo's unscaled scores = 1."""
    return None if cfg.scale_attn else 1.0


def _site(cfg, phase, q, C, M, kv_dtype=None, attn_fn=None):
    train = phase == "train"
    return attn_dispatch.AttnSite(
        phase=phase, q_len=C, kv_len=M, head_dim=cfg.head_dim,
        kv_dtype=kv_dtype or dtype_name(q.dtype), on_cuda=q.is_cuda,
        force_flash=cfg.use_flash_attention,
        external_fn=attn_fn is not None, chunk_min=cfg.chunked_attn_min_seq,
        backend=cfg.attention_backend if train else None,
        mesh_axes=attn_dispatch.active_mesh_axes() if train else ())


def _attention(q, k, v, cfg, attn_fn=None):
    """q: [B, T, H, hd]; k, v: [B, S, Hkv, hd] -> [B, T, H, hd], causal.

    Program selection goes through the dispatch layer: the caller's
    `attn_fn` (K/V heads repeated to match q's first), the ring programs
    over the `sequence` axis (heads repeated too), the query-chunked
    attention where `chunked_attn_min_seq` asks for it, the flash kernel,
    or on CPU operands its plain version (fp32 softmax; GQA)."""
    T, S = q.shape[1], k.shape[1]
    program = attn_dispatch.select(_site(cfg, "train", q, T, S,
                                         attn_fn=attn_fn))
    if program in attn_dispatch.RING_PROGRAMS:
        from deepspeed_tpu_torch.parallel import ring
        fn = ring.ring_attention if program == "ring" \
            else ring.ring_ulysses_attention
        attn_fn = partial(fn, causal=True, sm_scale=_sm_scale(cfg))
        program = "external"
    if program in ("external", "chunked"):
        if k.shape[2] != q.shape[2]:    # both expect matched heads
            rep = q.shape[2] // k.shape[2]
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if program == "external":
            return attn_fn(q, k, v)
        return chunked_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, sm_scale=_sm_scale(cfg)).transpose(1, 2)
    if program == "flash":
        return flash_attention(q, k, v, causal=True, sm_scale=_sm_scale(cfg))
    if cfg.softmax_dtype != torch.float32:
        raise NotImplementedError(
            f"softmax_dtype {cfg.softmax_dtype} on the plain attention path "
            f"is not ported to deepspeed_tpu_torch yet (fp32 only)")
    return flash_attention_reference(q, k, v, causal=True,
                                     sm_scale=_sm_scale(cfg))[0]


def _decode_qkv(x, p, positions, cfg: GPTConfig):
    """Shared attention preamble (prefill, decode, paged): ln1 -> fused qkv -> split/reshape -> rope at absolute positions.
    x: [B, C, D]; positions: [B, C]. Returns q [B,C,H,hd], k/v [B,C,Hkv,hd]
    (views of the fused projection where no rope applies). The projection
    is the `qkv_proj` region of `save_matmuls`."""
    B, C, _ = x.shape
    H, Hkv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    h = _norm(x, p["ln1_scale"], p.get("ln1_bias"), cfg.use_rmsnorm,
              cfg.norm_eps)
    with checkpoint_name("qkv_proj"):
        qkv = h @ p["attn_qkv_w"] + p["attn_qkv_b"]
    q, k, v = qkv.split([H * hd, Hkv * hd, Hkv * hd], dim=-1)
    q = q.reshape(B, C, H, hd)
    k = k.reshape(B, C, Hkv, hd)
    v = v.reshape(B, C, Hkv, hd)
    if cfg.use_rotary:
        rd = _rotary_dims(cfg)
        q = _rope(q, positions, rd, cfg.rope_theta)
        k = _rope(k, positions, rd, cfg.rope_theta)
    return q, k, v


def _attn_half(x, p, cfg: GPTConfig, positions, attn_fn=None):
    """Attention half-block over a whole sequence: ln1 -> qkv -> rope ->
    causal attention -> out-proj. Returns (attn_out, k, v) so the prefill
    can write k/v into the KV cache."""
    B, T, D = x.shape
    q, k, v = _decode_qkv(x, p, positions, cfg)
    attn = _attention(q, k, v, cfg, attn_fn).reshape(B, T, D)
    with checkpoint_name("attn_out"):
        attn_out = attn @ p["attn_out_w"] + p["attn_out_b"]
    return attn_out, k, v


def _layer(params, i):
    """Layer i's block leaves, dense: quantized leaves dequantize here, one
    layer at a time, together (one launch for a layer's leaves of one bit
    width and dtype)."""
    p = {k: v[i] for k, v in params["blocks"].items()}
    names = [k for k, v in p.items() if isinstance(v, QuantizedTensor)]
    if names:
        p.update(zip(names, dequantize_tensors([p[k] for k in names])))
    return p


# ----------------------------------------------------------------------
# training forward and loss
# ----------------------------------------------------------------------


def _block(x, p, cfg: GPTConfig, positions, attn_fn=None):
    """One transformer block. x: [B, T, D]."""
    attn_out, _, _ = _attn_half(x, p, cfg, positions, attn_fn)
    return _residual_mlp(x, attn_out, p, cfg)


def gpt_hidden(params, tokens, cfg: GPTConfig, positions=None, pld=None,
               ltd=None, attn_fn=None):
    """tokens: [B, T] int -> final-norm'd hidden states [B, T, D].

    With `cfg.remat` each block runs under its `resolve_remat_policy`
    wrapper: the policy's ops are kept and the backward recomputes the rest,
    so the attention kernel's forward runs twice per block.

    `pld`: (keep_idx [n_keep] int, theta) — progressive layer drop: only the
    kept layers run, each as x + (block(x) - x) / max(theta, 1e-6) in x's
    dtype (inverted stochastic depth). keep_idx is read as Python ints.

    `ltd`: (start, keep_idx [B, n_ltd, K] int) — random-LTD: layers
    [start, start + n_ltd) run on each row's K kept positions only (gather,
    the block at the true positions, an out-of-place scatter back); the
    other tokens pass those layers unchanged. The indices come sorted, so
    causal attention over the subset is causal in the original positions.

    The JAX package's asserts stay, as ValueError: PLD does not compose
    with random-LTD, and random-LTD takes no `attn_fn`."""
    if pld is not None and ltd is not None:
        raise ValueError("progressive_layer_drop composes with neither "
                         "per-layer attention flags nor random-LTD")
    if ltd is not None and attn_fn is not None:
        raise ValueError("random-LTD gathers token subsets; a custom attn_fn "
                         "with a T-static layout cannot run on them")
    B, T = tokens.shape
    if positions is None:
        positions = (_sequence_offset(T) + torch.arange(
            T, device=tokens.device)).expand(B, T)
    x = _embed(params, tokens, positions, cfg)
    blocks = params["blocks"]
    remat = resolve_remat_policy(cfg.remat_policy) \
        if cfg.remat and torch.is_grad_enabled() else None
    if hasattr(blocks, "layer"):
        # ZeRO-3's `runtime/zero.ZeroParamView`: layer i is gathered inside
        # its block, so the rematerialized forward gathers it again
        def run(x, i, pos, fn):
            return _block(x, blocks.layer(i), cfg, pos, fn)
    else:
        # unbind, not v[i]: its backward stacks the L per-layer gradients
        # once, where L selects would each write a zero-filled [L, ...]
        # gradient
        layers = {k: v.unbind(0) for k, v in blocks.items()}

        def run(x, i, pos, fn):
            return _block(x, {k: v[i] for k, v in layers.items()}, cfg, pos,
                          fn)

    def block(x, i, pos, fn):
        return remat(run, x, i, pos, fn) if remat else run(x, i, pos, fn)

    if pld is not None:
        keep_idx, theta = pld
        inv = (1.0 / torch.as_tensor(theta, device=x.device).float()
               .clamp_min(1e-6)).to(x.dtype)
        for i in [int(i) for i in keep_idx]:
            x = x + (block(x, i, positions, attn_fn) - x) * inv
    elif ltd is not None:
        start, keep = ltd
        stop = start + keep.shape[1]
        for i in range(cfg.n_layer):
            if not start <= i < stop:
                x = block(x, i, positions, attn_fn)
                continue
            kx = keep[:, i - start].long()                       # [B, K]
            gidx = kx[..., None].expand(-1, -1, x.shape[-1])
            sub = block(torch.gather(x, 1, gidx), i, kx, None)
            x = x.scatter(1, gidx, sub.to(x.dtype))
    else:
        for i in range(cfg.n_layer):
            x = block(x, i, positions, attn_fn)
    return _norm(x, params["lnf_scale"], params.get("lnf_bias"),
                 cfg.use_rmsnorm, cfg.norm_eps)


def _sequence_parallel():
    """(sp, this rank's index) on the installed mesh's `sequence` axis."""
    from deepspeed_tpu_torch.comm import mesh as mesh_mod
    if not mesh_mod.has_mesh() or mesh_mod.get_spec().sequence == 1:
        return 1, 0
    return mesh_mod.get_spec().sequence, mesh_mod.axis_rank(
        mesh_mod.SEQ_AXIS)


def _sequence_offset(T):
    """The absolute position of this rank's first token: rank x T when
    the tokens are one shard of T of a `sequence` axis, else 0."""
    return _sequence_parallel()[1] * T


class _SequenceSum(torch.autograd.Function):
    """The sum over the `sequence` group, whose backward is the identity:
    each rank seeds its copy of the (replicated) global loss and gets its
    own tokens' share of the gradient."""

    @staticmethod
    def forward(ctx, x):
        from deepspeed_tpu_torch.comm import collectives as coll
        return coll.psum(x, "sequence")

    @staticmethod
    def backward(ctx, g):
        return g


def _mean_over_labels(nll_sum, count):
    """The loss: the nll sum over the labels >= 0 divided by their
    count, both over the whole sequence when the tokens are sharded over
    the `sequence` axis (JAX's global mean, not a mean of shard means)."""
    if _sequence_parallel()[0] > 1:
        from deepspeed_tpu_torch.comm import collectives as coll
        nll_sum = _SequenceSum.apply(nll_sum)
        count = coll.psum(count.detach(), "sequence")
    return nll_sum / count.clamp_min(1.0)


def gpt_forward(params, tokens, cfg: GPTConfig, positions=None,
                attn_fn=None):
    """tokens: [B, T] int -> logits [B, T, vocab]."""
    return _head_logits(params, gpt_hidden(params, tokens, cfg, positions,
                                           attn_fn=attn_fn), cfg)


def gpt_loss(params, batch, rng=None, cfg: GPTConfig = None, attn_fn=None):
    """Causal-LM cross entropy, mean over the labels >= 0. batch:
    {"tokens": [B, T+1]} (inputs and labels are its shifts) or
    {"input_ids": [B, T], "labels": [B, T]}; a label < 0 is ignored. The
    engine's routing directives ride in the batch (`pld_keep_idx`,
    `pld_theta`, `ltd_keep_idx`, `ltd_start`: runtime/engine.py), their
    counts in their shapes.

    The loss is `_causal_lm_nll` of the final hidden states."""
    tokens = batch.get("tokens", batch.get("input_ids"))
    labels = batch.get("labels")
    if labels is None:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs = tokens
    pld = ltd = None
    if "pld_keep_idx" in batch:
        pld = (batch["pld_keep_idx"][0], batch["pld_theta"][0])
    if "ltd_keep_idx" in batch:
        ltd = (batch["ltd_start"].shape[1], batch["ltd_keep_idx"])
    return _causal_lm_nll(params, gpt_hidden(params, inputs, cfg,
                                             attn_fn=attn_fn, pld=pld,
                                             ltd=ltd), labels, cfg)


def _causal_lm_nll(params, x, labels, cfg: GPTConfig):
    """Mean cross entropy over the labels >= 0 from the final-norm'd hidden
    states x [B, T, D] (`gpt_loss` and the layered spec's loss).

    With `cfg.loss_chunks` the chunked-vocab CE takes the hidden states and
    the head table (no [B, T, V] logits; a tied LM-head bias raises).
    Otherwise the log-sum-exp runs in fp32 over logits kept in the compute
    dtype: the max is taken (and not differentiated) in that dtype, the
    shifted logits are widened, and only [B, T] tensors are fp32 besides
    the exp."""
    if cfg.loss_chunks:
        if "lm_head_bias" in params:
            raise ValueError("chunked CE does not support a tied LM-head "
                             "bias")
        B, T = labels.shape
        nll = chunked_softmax_xent(
            x.reshape(B * T, -1), dense(_head_table(params, cfg)).to(x.dtype),
            labels.reshape(B * T), cfg.loss_chunks)
        mask = (labels.reshape(B * T) >= 0).float()
        return _mean_over_labels((nll * mask).sum(), mask.sum())
    logits = _head_logits(params, x, cfg)
    m = logits.detach().amax(dim=-1, keepdim=True)
    sumexp = torch.exp((logits - m).float()).sum(dim=-1)
    logz = m[..., 0].float() + torch.log(sumexp)
    safe_labels = labels.clamp_min(0).long()   # ignore-index must not wrap
    gold = logits.gather(-1, safe_labels[..., None])[..., 0].float()
    mask = (labels >= 0).float()
    nll = (logz - gold) * mask
    return _mean_over_labels(nll.sum(), mask.sum())


def gpt_param_specs(cfg: GPTConfig):
    """The JAX package's Megatron-style tensor-parallel specs of each leaf
    (tuples of entries, one a dimension: None or "tensor"; column-parallel
    qkv / up, row-parallel out / down, a vocab-parallel embedding). The
    port runs no tensor parallelism yet (ROADMAP item 8); ZeRO reads them
    to shard a free dimension, the one JAX's policy shards."""
    t = "tensor"
    block = {"ln1_scale": (None, None), "ln2_scale": (None, None),
             "attn_qkv_w": (None, None, t), "attn_qkv_b": (None, t),
             "attn_out_w": (None, t, None), "attn_out_b": (None, None),
             "mlp_out_b": (None, None)}
    if not cfg.use_rmsnorm:
        block["ln1_bias"] = (None, None)
        block["ln2_bias"] = (None, None)
    if cfg.use_swiglu:
        block["mlp_gate_w"] = (None, None, t)
        block["mlp_up_w"] = (None, None, t)
        block["mlp_down_w"] = (None, t, None)
    else:
        block["mlp_up_w"] = (None, None, t)
        block["mlp_up_b"] = (None, t)
        block["mlp_down_w"] = (None, t, None)
    specs = {"wte": (t, None), "blocks": block, "lnf_scale": (None,)}
    if not cfg.use_rmsnorm:
        specs["lnf_bias"] = (None,)
    if not cfg.use_rotary and not cfg.use_alibi:
        specs["wpe"] = (None, None)
    if cfg.use_emb_ln:
        specs["emb_ln_scale"] = (None,)
        specs["emb_ln_bias"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = (t, None)
    return specs


def make_gpt_model(cfg: GPTConfig = None, name="gpt2-125m", seed=0,
                   params=None, attn_fn=None):
    """ModelSpec for the training engine: the loss, the params (drawn from
    numpy `seed` unless given) and the forward for evaluation, both through
    `attn_fn` when one is given (a sparse attention must not fall back to
    dense in evaluation)."""
    from deepspeed_tpu_torch.runtime.engine import ModelSpec
    cfg = cfg or GPT2_CONFIGS[name]
    return ModelSpec(
        loss_fn=partial(gpt_loss, cfg=cfg, attn_fn=attn_fn),
        params=init_gpt_params(cfg, seed=seed) if params is None else params,
        apply_fn=partial(gpt_forward, cfg=cfg, attn_fn=attn_fn),
        arch_cfg=cfg, name=name, param_specs=gpt_param_specs(cfg),
        sequence_parallel=True)


# ----------------------------------------------------------------------
# contiguous KV cache — generate()
# ----------------------------------------------------------------------


def init_kv_cache(cfg: GPTConfig, batch_size, max_len, dtype=torch.bfloat16,
                  device="cpu"):
    """[L, B, Hkv, max_len, hd] stacked head-major cache: the decode kernel
    reads one head's K/V rows contiguously."""
    shape = (cfg.n_layer, batch_size, cfg.n_kv_head, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=as_dtype(dtype), device=device),
            "v": torch.zeros(shape, dtype=as_dtype(dtype), device=device),
            "length": torch.zeros(batch_size, dtype=torch.int32,
                                  device=device)}


def _decode_attn_half(x, p, cache_k, cache_v, pos, cfg: GPTConfig):
    """Single-token attention half: writes k/v at `pos` into the head-major
    cache (in place) and attends over 0..pos. x: [B, 1, D]; cache_[kv]:
    [B, Hkv, M, hd]; pos: [B]. Returns (attn_out, cache_k, cache_v)."""
    B, _, D = x.shape
    M = cache_k.shape[2]
    q, k, v = _decode_qkv(x, p, pos[:, None], cfg)
    rows = torch.arange(B, device=x.device)
    cache_k[rows, :, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, :, pos] = v[:, 0].to(cache_v.dtype)
    attend = decode_attention \
        if attn_dispatch.select(_site(cfg, "decode", q, 1, M)) \
        == "decode_kernel" else decode_attention_reference
    attn = attend(q[:, 0].contiguous(), cache_k, cache_v, pos,
                  sm_scale=_sm_scale(cfg)).reshape(B, 1, D)
    attn_out = attn @ p["attn_out_w"] + p["attn_out_b"]
    return attn_out, cache_k, cache_v


def _block_decode(x, p, cache_k, cache_v, pos, cfg: GPTConfig):
    attn_out, cache_k, cache_v = _decode_attn_half(x, p, cache_k, cache_v,
                                                   pos, cfg)
    return _residual_mlp(x, attn_out, p, cfg), cache_k, cache_v


# ----------------------------------------------------------------------
# paged pool — the continuous-batching serving engine
# ----------------------------------------------------------------------


def init_paged_kv_pool(cfg: GPTConfig, num_blocks, block_size,
                       dtype=torch.bfloat16, kv_group_size=0, device="cpu"):
    """[L, num_blocks, Hkv, block, hd] physical-block pool, allocated once at
    serving-engine init. Block 0 is the trash block (inference/kv_cache.py).

    `dtype=torch.int8` selects the QUANTIZED pool: the k/v payload is
    symmetric per-group int8 and the pool grows `k_scale` / `v_scale` f32
    leaves [L, N, Hkv, block, hd // g] (g = `kv_group_size`, 0 = head_dim).
    Scales share the block axis with the payload. Zero init is safe: a
    trash-block read dequantizes to exact zeros."""
    int8 = dtype in (torch.int8, "int8")
    dtype = torch.int8 if int8 else as_dtype(dtype)
    shape = (cfg.n_layer, num_blocks, cfg.n_kv_head, block_size,
             cfg.head_dim)
    pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    if int8:
        g = int(kv_group_size) or cfg.head_dim
        if g < 1 or cfg.head_dim % g:
            raise ValueError(
                f"init_paged_kv_pool: kv_group_size {g} does not tile "
                f"head_dim {cfg.head_dim} (one scale per {g}-element group "
                f"of each K/V vector)")
        sshape = shape[:-1] + (cfg.head_dim // g,)
        pool["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
    return pool


def _paged_attend(q, k_ctx, v_ctx, q_pos, cfg: GPTConfig):
    """Attend q over table-gathered KV with ABSOLUTE positions.

    q: [B, C, H, hd]; k_ctx/v_ctx: [B, Hkv, S, hd] in logical order (k index
    == absolute position); q_pos: [B, C]. Returns [B, C, H*hd]; fp32
    softmax."""
    B, C, H, hd = q.shape
    Hkv, S = k_ctx.shape[1], k_ctx.shape[2]
    scale = 1.0 / math.sqrt(hd) if cfg.scale_attn else 1.0
    k_pos = torch.arange(S, device=q.device)
    valid = k_pos[None, None, :] <= q_pos[:, :, None]          # [B, C, S]
    qg = q.reshape(B, C, Hkv, H // Hkv, hd)
    logits = torch.einsum("bckgd,bksd->bkgcs", qg, k_ctx).float() * scale
    logits = logits.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgcs,bksd->bckgd", probs, v_ctx)
    return out.reshape(B, C, H * hd)


def paged_kv_write(pool_l, k, v, block_tables, positions):
    """One layer's cache write, in place: the new tokens' k, v [B, C, Hkv,
    hd] into `pool_l` at each token's physical block (block_tables [B, nb]
    at positions [B, C] // block) and offset (positions % block);
    quantized first on the int8 pool (one `quantize_kv_write` launch on
    CUDA). Rows of inactive slots (all-trash tables, pos 0) collide in the
    trash block, where the write order is unspecified and irrelevant; a
    real row's (block, offset) is unique in the step, so its payload and
    its scales come from the same token."""
    if "k_scale" in pool_l:
        quantize_kv_write(pool_l, k, v, block_tables, positions)
        return
    bs = pool_l["k"].shape[2]
    blk = torch.gather(block_tables.long(), 1,
                       (positions // bs).long())                      # [B, C]
    off = positions % bs
    pool_l["k"][blk, :, off] = k.to(pool_l["k"].dtype)
    pool_l["v"][blk, :, off] = v.to(pool_l["v"].dtype)


def _paged_attn_half(x, p, pool_l, positions, block_tables, cfg: GPTConfig,
                     phase=None):
    """Attention half-block against one layer's paged pool.

    x: [B, C, D]; pool_l: {"k", "v"} [N, Hkv, block, hd] (plus
    {"k_scale", "v_scale"} [N, Hkv, block, hd // g] for the int8 pool);
    positions: [B, C] absolute; block_tables: [B, nb] int32. Writes the C
    new tokens' k/v into each row's blocks in place (position -> table ->
    physical block; quantized first on the int8 pool), then attends over
    the row's table through the program the dispatch names: the paged
    kernels for single-token steps, the (dequantizing) gather for prefill
    chunks and the spec-decode verify chunk. `phase` names the dispatch
    site ("verify"); None derives it from the chunk width. A program
    without a branch here raises."""
    from deepspeed_tpu_torch.inference.kv_cache import (
        gather_block_kv, gather_block_kv_dequant)
    B, C, D = x.shape
    bs = pool_l["k"].shape[2]
    nb = block_tables.shape[1]
    quantized = "k_scale" in pool_l
    q, k, v = _decode_qkv(x, p, positions, cfg)
    paged_kv_write(pool_l, k, v, block_tables, positions)
    phase = phase or ("paged_decode" if C == 1 else "prefill_chunk")
    program = attn_dispatch.select(_site(
        cfg, phase, q, C, nb * bs, kv_dtype="int8" if quantized else None))
    if program == "paged_kernel_quant":
        attn = paged_decode_attention_quant(
            q[:, 0].contiguous(), pool_l["k"], pool_l["v"],
            pool_l["k_scale"], pool_l["v_scale"], block_tables,
            positions[:, 0], sm_scale=_sm_scale(cfg)).reshape(B, 1, D)
    elif program == "paged_kernel":
        attn = paged_decode_attention(
            q[:, 0].contiguous(), pool_l["k"], pool_l["v"], block_tables,
            positions[:, 0], sm_scale=_sm_scale(cfg)).reshape(B, 1, D)
    elif program == "paged_gather_quant":
        k_ctx, v_ctx = gather_block_kv_dequant(pool_l, block_tables, q.dtype)
        attn = _paged_attend(q, k_ctx, v_ctx, positions, cfg)
    elif program == "paged_gather":
        k_ctx, v_ctx = gather_block_kv(pool_l["k"], pool_l["v"], block_tables)
        attn = _paged_attend(q, k_ctx, v_ctx, positions, cfg)
    else:
        # by-name dispatch: an unknown program taking the fp gather would
        # read the int8 payload as K/V
        raise NotImplementedError(
            f"attention program {program!r} selected for the paged site "
            f"has no handler in models/gpt.py")
    attn_out = attn @ p["attn_out_w"] + p["attn_out_b"]
    return attn_out, pool_l


def _block_paged(x, p, pool_l, positions, block_tables, cfg: GPTConfig,
                 phase=None):
    attn_out, pool_l = _paged_attn_half(x, p, pool_l, positions,
                                        block_tables, cfg, phase=phase)
    return _residual_mlp(x, attn_out, p, cfg), pool_l


# ----------------------------------------------------------------------
# the decode model
# ----------------------------------------------------------------------


def gpt_cache_identity(cfg: GPTConfig, name: str = "") -> str:
    """Cache-identity fingerprint for the prefix cache's hash chain
    (`DecodeModelSpec.cache_fingerprint`): every arch field that changes
    the K/V values a prompt writes into the pool, plus the spec name — the
    JAX package's field tuple and spelling, so both packages' chains are
    byte-equal (`dtype_name` spells a dtype as `jnp.dtype(...).name`
    does). Weights are engine-local and deliberately not hashed."""
    fields = (name, cfg.vocab_size, cfg.n_layer, cfg.n_head, cfg.n_kv_head,
              cfg.d_model, cfg.d_ff, cfg.max_seq_len, cfg.use_rotary,
              cfg.rotary_pct, cfg.rope_theta, cfg.use_alibi, cfg.use_emb_ln,
              cfg.use_rmsnorm, cfg.norm_eps, cfg.sliding_window,
              cfg.attn_layer_types, cfg.scale_attn, cfg.parallel_residual,
              cfg.use_swiglu, cfg.activation, dtype_name(cfg.dtype),
              dtype_name(cfg.softmax_dtype))
    return "gpt:" + "|".join(map(str, fields))


def make_gpt_decode_model(cfg: GPTConfig = None, name="gpt2-125m",
                          params=None, seed=0):
    """DecodeModelSpec for the inference engine: prefill + per-token decode
    over the contiguous cache, and the paged-pool serving contract (with
    the spec-decode verify and the prefix cache's fingerprint)."""
    from deepspeed_tpu_torch.inference.engine import DecodeModelSpec
    cfg = cfg or GPT2_CONFIGS[name]
    if params is None:
        params = init_gpt_params(cfg, seed=seed)

    def prefill_fn(params, tokens, cache, pad_mask=None):
        B, T = tokens.shape
        positions = torch.arange(T, device=tokens.device).expand(B, T)
        x = _embed(params, tokens, positions, cfg)
        for i in range(cfg.n_layer):
            p = _layer(params, i)
            attn_out, k, v = _attn_half(x, p, cfg, positions)
            cache["k"][i, :, :, :T] = k.transpose(1, 2)
            cache["v"][i, :, :, :T] = v.transpose(1, 2)
            x = _residual_mlp(x, attn_out, p, cfg)
        cache["length"].fill_(T)
        return _lm_head(params, x, cfg), cache

    def decode_fn(params, token, pos, cache):
        x = _embed(params, token[:, None], pos[:, None], cfg)
        for i in range(cfg.n_layer):
            x, _, _ = _block_decode(x, _layer(params, i), cache["k"][i],
                                    cache["v"][i], pos, cfg)
        cache["length"] += 1
        return _lm_head(params, x, cfg)[:, 0], cache

    def init_cache(batch_size, max_len, dtype=torch.bfloat16, device="cpu"):
        return init_kv_cache(cfg, batch_size, max_len, dtype, device)

    def _walk_paged(params, x, pool, block_tables, positions, phase=None):
        for i in range(cfg.n_layer):
            pool_l = {name: leaf[i] for name, leaf in pool.items()}
            x, _ = _block_paged(x, _layer(params, i), pool_l, positions,
                                block_tables, cfg, phase=phase)
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

    def verify_paged_fn(params, tokens, pos, pool, block_tables):
        """Spec-decode verify: C tokens a row at cursor `pos`, scored in one
        pass as a prefill chunk is, returning the logits of EVERY position
        [B, C, V] (row i's argmax is the greedy truth for draft i + 1)."""
        B, C = tokens.shape
        positions = pos[:, None].long() + torch.arange(
            C, device=tokens.device)[None]
        x = _embed(params, tokens, positions, cfg)
        x = _walk_paged(params, x, pool, block_tables, positions,
                        phase="verify")
        return _lm_head(params, x, cfg), pool

    def init_paged_pool(num_blocks, block_size, dtype=torch.bfloat16,
                        kv_group_size=0, device="cpu"):
        return init_paged_kv_pool(cfg, num_blocks, block_size, dtype,
                                  kv_group_size, device)

    return DecodeModelSpec(
        prefill_fn=prefill_fn, decode_fn=decode_fn, init_cache=init_cache,
        params=params, name=name, prefill_paged_fn=prefill_paged_fn,
        decode_paged_fn=decode_paged_fn, verify_paged_fn=verify_paged_fn,
        init_paged_pool=init_paged_pool,
        cache_fingerprint=gpt_cache_identity(cfg, name), dtype=cfg.dtype,
        max_positions=None if cfg.use_rotary else cfg.max_seq_len)


# ----------------------------------------------------------------------
# the layered model — the parameter spill tier
# ----------------------------------------------------------------------


def make_gpt_layered_model(cfg: GPTConfig = None, name="gpt2-125m",
                           params=None, seed=0):
    """LayeredModelSpec: the model factored into per-layer functions, so
    that the spill engines (`inference/zero_inference.py`,
    `runtime/infinity.py`) stream one layer's weights to the device at a
    time. The math of `make_gpt_decode_model` and `gpt_loss`; `resident`
    and `blocks` are cut from the same parameter tree (the JAX leaf
    names). The paged function takes the layer index as a Python int and
    writes the layer's view of the [L, ...] pool in place."""
    from deepspeed_tpu_torch.inference.zero_inference import LayeredModelSpec
    cfg = cfg or GPT2_CONFIGS[name]
    if params is None:
        params = init_gpt_params(cfg, seed=seed)
    resident = {k: v for k, v in params.items() if k != "blocks"}

    def embed_fn(res, tokens, positions):
        return _embed(res, tokens, positions, cfg)

    def layer_prefill_fn(p, x, ck, cv, positions):
        """x: [B, T, D]; ck / cv: [B, Hkv, M, hd], this layer's cache."""
        T = x.shape[1]
        attn_out, k, v = _attn_half(x, p, cfg, positions)
        ck[:, :, :T] = k.transpose(1, 2)
        cv[:, :, :T] = v.transpose(1, 2)
        return _residual_mlp(x, attn_out, p, cfg), ck, cv

    def layer_decode_fn(p, x, ck, cv, pos):
        return _block_decode(x, p, ck, cv, pos, cfg)

    def final_fn(res, x):
        return _lm_head(res, x, cfg)

    def init_layer_cache(batch_size, max_len, dtype=torch.bfloat16,
                         device="cpu"):
        shape = (batch_size, cfg.n_kv_head, max_len, cfg.head_dim)
        return (torch.zeros(shape, dtype=as_dtype(dtype), device=device),
                torch.zeros(shape, dtype=as_dtype(dtype), device=device))

    def layer_train_fn(p, x, positions):
        return _block(x, p, cfg, positions)

    def train_loss_fn(res, x, labels):
        return _causal_lm_nll(res, _final_norm(res, x, cfg), labels, cfg)

    def layer_paged_fn(p, x, layer, pool, block_tables, positions):
        pool_l = {k: v[layer] for k, v in pool.items()}
        x, _ = _block_paged(x, p, pool_l, positions, block_tables, cfg)
        return x, pool

    def init_paged_pool(num_blocks, block_size, dtype=torch.bfloat16,
                        kv_group_size=0, device="cpu"):
        return init_paged_kv_pool(cfg, num_blocks, block_size, dtype,
                                  kv_group_size, device)

    return LayeredModelSpec(
        embed_fn=embed_fn, layer_prefill_fn=layer_prefill_fn,
        layer_decode_fn=layer_decode_fn, final_fn=final_fn,
        layer_train_fn=layer_train_fn, train_loss_fn=train_loss_fn,
        resident=resident, blocks=params["blocks"], num_layers=cfg.n_layer,
        init_layer_cache=init_layer_cache, name=name,
        layer_paged_fn=layer_paged_fn, init_paged_pool=init_paged_pool,
        cache_fingerprint=gpt_cache_identity(cfg, name), dtype=cfg.dtype,
        max_positions=None if cfg.use_rotary else cfg.max_seq_len)
