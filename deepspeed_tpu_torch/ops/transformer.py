"""Reference-name frontends for the fused transformer (BERT-era) layer
(counterpart of `deepspeed_tpu/ops/transformer.py`).

`DeepSpeedTransformerConfig` keeps the reference constructor surface;
`DeepSpeedTransformerLayer` is an `nn.Module` holding one encoder block's
parameters under the JAX package's leaf names and applying
`models/bert.py::_bert_block` on call, so it runs the same attention
dispatch (the flash kernels without a mask, the block-sparse kernels with
one, the dense arithmetic on the CPU). The knobs that steer the reference
CUDA kernel's memory strategy (normalize_invertible, gelu_checkpoint,
attn_dropout_checkpoint, stochastic_mode) are accepted and ignored. Dropout
ratios are accepted for constructor parity and NOT applied; a nonzero
ratio logs a warning, as in the JAX package.
"""

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.utils.logging import logger

_DROPOUT_WARNING = ("DeepSpeedTransformerConfig: dropout ratios are accepted "
                    "for parity but not applied on this path")


class DeepSpeedTransformerConfig:
    """Constructor-parity config (reference `transformer.py:33`)."""

    def __init__(self, batch_size=1, hidden_size=768, intermediate_size=None,
                 heads=12, attn_dropout_ratio=0.0, hidden_dropout_ratio=0.0,
                 num_hidden_layers=12, initializer_range=0.02,
                 layer_norm_eps=1e-12, local_rank=-1, seed=0, fp16=False,
                 bf16=True, pre_layer_norm=True, normalize_invertible=False,
                 gelu_checkpoint=False, adjust_init_range=True,
                 attn_dropout_checkpoint=False, stochastic_mode=False,
                 return_tuple=False, training=True):
        self.batch_size = batch_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.heads = heads
        self.attn_dropout_ratio = attn_dropout_ratio
        self.hidden_dropout_ratio = hidden_dropout_ratio
        if attn_dropout_ratio or hidden_dropout_ratio:
            logger.warning(_DROPOUT_WARNING)
        self.num_hidden_layers = num_hidden_layers
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.local_rank = local_rank
        self.seed = seed
        self.fp16 = fp16
        self.bf16 = bf16
        self.pre_layer_norm = pre_layer_norm
        # memory-strategy knobs of the reference CUDA kernel: accepted
        self.normalize_invertible = normalize_invertible
        self.gelu_checkpoint = gelu_checkpoint
        self.adjust_init_range = adjust_init_range
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.stochastic_mode = stochastic_mode
        self.return_tuple = return_tuple
        self.training = training
        self.layer_id = -1

    @classmethod
    def from_dict(cls, json_object):
        cfg = cls()
        for key, value in json_object.items():
            setattr(cfg, key, value)
        if "hidden_size" in json_object and \
                "intermediate_size" not in json_object:
            cfg.intermediate_size = 4 * cfg.hidden_size   # re-derive
        if cfg.attn_dropout_ratio or cfg.hidden_dropout_ratio:
            # setattr bypassed __init__'s check: warn here
            logger.warning(_DROPOUT_WARNING)
        return cfg


def _np(a):
    """A torch tensor or array-like -> numpy (fp32 for tensors)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a)


class DeepSpeedTransformerLayer(nn.Module):
    """One encoder layer (reference `transformer.py:296`).

    Its parameters carry the JAX leaf names (`attn_qkv_w` [D, 3D], ...,
    `ln2_bias`); `params` gives them as the JAX tree. The seeded init draws
    from numpy `config.seed + layer_id` in the JAX package's order, with
    the sqrt(2L) adjustment of the output projections, so the same config,
    seed and layer_id give the JAX layer's weights. The layer is made on the
    CPU; `.to(device)` moves it."""

    def __init__(self, config: DeepSpeedTransformerConfig,
                 initial_weights=None, initial_biases=None, layer_id=None):
        """`layer_id`: explicit layer index. None takes a process-global
        counter (the reference's static layer_id), so the seeded init then
        depends on how many layers the process has built; an explicit id
        also moves the counter past itself."""
        super().__init__()
        from deepspeed_tpu_torch.models.bert import BertConfig

        self.config = config
        if layer_id is None:
            layer_id = getattr(DeepSpeedTransformerLayer, "_layer_id", 0)
        DeepSpeedTransformerLayer._layer_id = max(
            getattr(DeepSpeedTransformerLayer, "_layer_id", 0), layer_id + 1)
        self.config.layer_id = layer_id

        dtype = (torch.float16 if config.fp16
                 else torch.bfloat16 if config.bf16 else torch.float32)
        self._bert_cfg = BertConfig(
            n_layer=1, n_head=config.heads, d_model=config.hidden_size,
            d_ff=config.intermediate_size, norm_eps=config.layer_norm_eps,
            pre_layer_norm=config.pre_layer_norm, remat=False, dtype=dtype)

        D, F_ = config.hidden_size, config.intermediate_size
        rng = np.random.default_rng(config.seed + layer_id)
        std = config.initializer_range
        out_std = (std / np.sqrt(2.0 * config.num_hidden_layers)
                   if config.adjust_init_range else std)

        def t(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)

        def norm(shape, scale):
            return t(rng.normal(0.0, scale, shape))

        zeros = lambda *s: torch.zeros(s, dtype=dtype)
        ones = lambda *s: torch.ones(s, dtype=dtype)
        params = {
            "attn_qkv_w": norm((D, 3 * D), std),
            "attn_qkv_b": zeros(3 * D),
            "attn_out_w": norm((D, D), out_std),
            "attn_out_b": zeros(D),
            "ln1_scale": ones(D),
            "ln1_bias": zeros(D),
            "mlp_up_w": norm((D, F_), std),
            "mlp_up_b": zeros(F_),
            "mlp_down_w": norm((F_, D), out_std),
            "mlp_down_b": zeros(D),
            "ln2_scale": ones(D),
            "ln2_bias": zeros(D),
        }
        if initial_weights is not None or initial_biases is not None:
            # the reference's 8-entry layout (`transformer.py:339-358`):
            # weights [q, k, v, attn_ow, attn_nw, inter_w, output_w, norm_w],
            # biases  [-, -, -, attn_ob, attn_nb, inter_b, output_b, norm_b]
            # (the qkv biases are zeroed, as the reference does). torch
            # Linear weights are [out, in] and land transposed; LN entries
            # are 1-D. attn_n* is the LN beside attention and norm_* the one
            # beside the MLP in either residual placement, so ln1 / ln2 map
            # alike for pre- and post-LN.
            if initial_weights is None or initial_biases is None \
                    or len(initial_weights) != 8 or len(initial_biases) != 8:
                raise ValueError("initial_weights / initial_biases must be "
                                 "the reference's 8-entry lists "
                                 "(transformer.py:339-358)")
            w = lambda i: t(_np(initial_weights[i]))
            b = lambda i: t(_np(initial_biases[i]))
            params.update({
                "attn_qkv_w": torch.cat([w(0), w(1), w(2)], dim=0).T,
                "attn_qkv_b": zeros(3 * D),
                "attn_out_w": w(3).T, "attn_out_b": b(3),
                "ln1_scale": w(4), "ln1_bias": b(4),
                "mlp_up_w": w(5).T, "mlp_up_b": b(5),
                "mlp_down_w": w(6).T, "mlp_down_b": b(6),
                "ln2_scale": w(7), "ln2_bias": b(7),
            })
        for name, value in params.items():
            self.register_parameter(name, nn.Parameter(value.contiguous()))

    @property
    def params(self):
        """The layer's parameters as the JAX tree {leaf name: tensor}."""
        return dict(self.named_parameters())

    def forward(self, hidden_states, attention_mask=None, params=None):
        """hidden_states [B, T, D]; attention_mask [B, T] (1 = keep) or an
        additive [B, 1, 1, T] bias, as the reference's forward takes them.
        `params` replaces the layer's own (a tree with the same names)."""
        from deepspeed_tpu_torch.models.bert import _bert_block, mask_bias_of
        p = params if params is not None else self.params
        dev = p["attn_qkv_w"].device
        x = torch.as_tensor(hidden_states, device=dev).to(self._bert_cfg.dtype)
        mask_bias = None
        if attention_mask is not None:
            mask = torch.as_tensor(attention_mask, device=dev)
            mask_bias = mask_bias_of(mask) if mask.dim() == 2 \
                else mask.float()
        out = _bert_block(x, p, mask_bias, self._bert_cfg)
        return (out,) if self.config.return_tuple else out


__all__ = ["DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer"]
