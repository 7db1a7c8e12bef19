"""Inference engine (counterpart of `deepspeed_tpu/inference/engine.py`).

A model for inference is a `DecodeModelSpec`:
  * `prefill_fn(params, tokens, cache, pad_mask) -> (logits, cache)`
  * `decode_fn(params, token, pos, cache) -> (logits, cache)`
  * `init_cache(batch, max_len, dtype, device)` -> KV cache
plus, for the continuous-batching server, the paged contract
(`prefill_paged_fn`, `decode_paged_fn`, `init_paged_pool`).
`models.gpt.make_gpt_decode_model` provides all of them.

The engine runs on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no `device="cpu"` it raises — it never drops to the CPU quietly.

Weight-only quantization (`config.quant`, or the serving engine's
`quantization.weights`) replaces the resident params with a quantized tree
(`enable_weight_quant`); the model functions dequantize it on use, so
generate() and the serving engine both run on the quantized weights.
"""

import dataclasses
import json
from typing import Any, Callable, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.config import TpuInferenceConfig
from deepspeed_tpu_torch.models.gpt import as_dtype
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.tree import tree_map


def resolve_device(device=None) -> torch.device:
    """`cuda` by default; a CUDA request without a GPU raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on CUDA and no CUDA device is "
            "available; pass device='cpu' to run the plain versions on the "
            "CPU")
    return device


def sample_logits(logits, generator=None, greedy=True, temperature=1.0,
                  top_k=0, top_p=1.0):
    """One sampling rule for generate() and the serving engine: greedy
    argmax, or temperature/top-k/top-p categorical drawn from `generator`.
    Filters compose in the standard order: temperature, then top-k, then
    nucleus (top-p) on the surviving distribution. Returns int32 ids."""
    if greedy or generator is None:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / max(float(temperature), 1e-6)
    V = logits.shape[-1]
    want_k = bool(top_k) and top_k > 0
    want_p = top_p is not None and top_p < 1.0
    if want_k or want_p:
        # one sort pass serves both filters: the descending head gives the
        # kth value for top-k and the prefix the nucleus cumsum walks
        head = torch.topk(logits, min(int(top_k), V) if want_k else V,
                          dim=-1).values
        if want_k:
            logits = logits.masked_fill(logits < head[..., -1:],
                                        float("-inf"))
        if want_p:
            probs = torch.softmax(head, dim=-1)
            # exclusive cumsum keeps the argmax even when its own mass
            # exceeds top_p; the top-1 always survives (top_p <= 0 = argmax)
            keep = torch.cumsum(probs, dim=-1) - probs < top_p
            keep[..., 0] = True
            cutoff = torch.where(keep, head, torch.full_like(
                head, float("inf"))).min(dim=-1, keepdim=True).values
            logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@dataclasses.dataclass
class DecodeModelSpec:
    prefill_fn: Callable       # (params, tokens[B,T], cache, pad_mask) -> (logits[B,T,V], cache)
    decode_fn: Callable        # (params, token[B], pos[B], cache) -> (logits[B,V], cache)
    init_cache: Callable       # (batch, max_len, dtype, device) -> cache
    params: Any
    eos_token_id: Optional[int] = None
    name: str = "model"
    # paged-pool serving contract (inference/scheduler.py):
    #   prefill_paged_fn(params, tokens[B,C], start_pos[B], last_idx[B],
    #                    pool, block_tables[B,nb]) -> (logits[B,V], pool)
    #   decode_paged_fn(params, token[B], pos[B], pool, block_tables[B,nb])
    #       -> (logits[B,V], pool)
    #   init_paged_pool(num_blocks, block_size, dtype, kv_group_size=0,
    #                   device=...) -> pool; dtype int8 selects the
    #       quantized pool (k/v int8 plus k_scale/v_scale f32
    #       [L, N, Hkv, block, hd // g], g = kv_group_size or head_dim)
    prefill_paged_fn: Optional[Callable] = None
    decode_paged_fn: Optional[Callable] = None
    init_paged_pool: Optional[Callable] = None
    dtype: Any = None          # activation dtype the functions compute in
    max_positions: Optional[int] = None  # learned-position table size


class InferenceEngine:
    def __init__(self, model: DecodeModelSpec, config: TpuInferenceConfig,
                 device=None):
        self.model_spec = model
        self.config = config
        self.device = resolve_device(device)
        self.dtype = as_dtype(config.dtype)
        # "int8" selects the quantized paged pool for every serving engine
        # built from this one (generate()'s contiguous cache refuses it)
        if str(config.kv_cache_dtype) != "int8" \
                and as_dtype(config.kv_cache_dtype) != self.dtype:
            raise NotImplementedError(
                f"kv_cache_dtype {config.kv_cache_dtype} != dtype "
                f"{config.dtype}: the port keeps K/V in the compute dtype "
                f"(or int8 in the serving pool)")
        if model.dtype is not None and as_dtype(model.dtype) != self.dtype:
            raise ValueError(
                f"model '{model.name}' computes in {model.dtype} but the "
                f"engine dtype is {config.dtype}: make them match")
        # leaf by leaf, cast as it moves: the card never holds the fp32
        # tree beside its cast copy
        self.params = tree_map(
            lambda t: t.to(self.device, self.dtype)
            if isinstance(t, torch.Tensor) and t.is_floating_point()
            else t.to(self.device), model.params)
        self.quant_stats = None
        self._weight_quant = None         # (bits, group_size) once quantized
        if config.quant.enabled:
            self.enable_weight_quant(bits=config.quant.bits,
                                     group_size=config.quant.group_size)
        # engine-owned KV cache: forward()/generate() reuse it when
        # (B, max_len) matches the previous call. ONE entry only, so peak
        # memory never holds two caches. The cache is updated in place;
        # reuse without re-zeroing is exact because every call reads only
        # positions it wrote itself (prefill writes 0..T-1, each decode
        # step writes pos before attending over 0..pos).
        self._cache_entry = None          # ((B, max_len), cache)
        self._cache_hits = 0
        quant = f"int{self._weight_quant[0]}" if self._weight_quant else "off"
        log_dist(f"inference engine: {model.name} dtype={self.dtype} "
                 f"device={self.device} quant={quant}", ranks=[0])

    def enable_weight_quant(self, bits=8, group_size=64):
        """Weight-only quantization of the resident params: every large
        float matrix leaf becomes int8 (or int4 packed two a byte) with
        per-group scales, and the dense tree is dropped. Called at build
        for `config.quant.enabled` and by the serving engine for
        `quantization.weights`: a no-op for matching settings, a ValueError
        for conflicting ones (quantizing quantized leaves again would
        compound the error). Returns the quantization stats."""
        if self._weight_quant is not None:
            if self._weight_quant == (int(bits), int(group_size)):
                return self.quant_stats
            raise ValueError(
                f"params already quantized as int{self._weight_quant[0]} "
                f"(group {self._weight_quant[1]}) — cannot re-quantize as "
                f"int{bits} (group {group_size}); pick one of config.quant "
                f"and serving.quantization.weights, or make them agree")
        if isinstance(self.params, dict) and "moe" in self.params:
            raise NotImplementedError(
                "weight-only quantization of an MoE tree is not ported to "
                "deepspeed_tpu_torch yet: the expert leaves of params['moe'] "
                "do not dequantize on use")
        from deepspeed_tpu_torch.inference.quantization import \
            quantize_param_tree
        self.params, self.quant_stats = quantize_param_tree(
            self.params, bits=int(bits), group_size=int(group_size))
        self._weight_quant = (int(bits), int(group_size))
        return self.quant_stats

    def _cache_len(self, min_len):
        """Round the contiguous cache up to whole kv_block_size blocks."""
        bs = int(self.config.kv_block_size or 0)
        return -(-min_len // bs) * bs if bs else min_len

    def _get_cache(self, batch, max_len):
        if str(self.config.kv_cache_dtype) == "int8":
            raise ValueError(
                "kv_cache_dtype='int8' is a paged-pool serving feature "
                "(engine.serving()): the contiguous generate() cache has no "
                "scale storage — serve through the continuous-batching "
                "scheduler, or keep kv_cache_dtype float for generate()")
        key = (int(batch), int(max_len))
        if self._cache_entry is not None and self._cache_entry[0] == key:
            self._cache_hits += 1
            return self._cache_entry[1]
        self._cache_entry = None      # drop the old cache before allocating
        cache = self.model_spec.init_cache(batch, max_len, self.dtype,
                                           self.device)
        self._cache_entry = (key, cache)
        return cache

    def _check_positions(self, n):
        limit = self.model_spec.max_positions
        if limit is not None and n > limit:
            raise ValueError(f"{n} positions exceed the model's learned "
                             f"position table ({limit})")

    def _sample(self, logits, generator):
        cfg = self.config
        return sample_logits(logits, generator, greedy=cfg.greedy,
                             temperature=cfg.temperature, top_k=cfg.top_k,
                             top_p=cfg.top_p)

    def make_generator(self, seed=0):
        return torch.Generator(device=self.device).manual_seed(int(seed))

    @torch.inference_mode()
    def forward(self, tokens, cache=None, pad_mask=None):
        """Prefill forward: (logits [B, T, V], cache)."""
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=self.device)
        self._check_positions(tokens.shape[1])
        if cache is None:
            cache = self._get_cache(
                tokens.shape[0],
                self._cache_len(max(self.config.max_out_tokens,
                                    tokens.shape[1])))
        return self.model_spec.prefill_fn(self.params, tokens, cache,
                                          pad_mask)

    __call__ = forward

    @staticmethod
    def _pad_ragged(tokens):
        """Right-pad variable-length sequences to [B, T_max] with 0 (never
        attended; pad_token_id only masks the output). Returns
        (tokens[B,T], prompt_lens[B])."""
        lens = np.asarray([len(t) for t in tokens], np.int32)
        T = int(lens.max())
        out = np.zeros((len(tokens), T), np.int32)
        mask = np.arange(T)[None, :] < lens[:, None]
        out[mask] = np.concatenate([np.asarray(t, np.int32) for t in tokens])
        return out, lens

    @torch.inference_mode()
    def generate(self, tokens, max_new_tokens=32, generator=None,
                 prompt_lens=None, eos_token_id=None, pad_token_id=0,
                 stop_on_eos=True):
        """Greedy/sampled generation; returns the new tokens [B, max_new].

        `tokens` is a rectangular [B, T] batch or a list of ragged sequences
        (right-padded internally); `prompt_lens` gives per-row prompt
        lengths of rectangular right-padded input. A row stops at
        `eos_token_id` (default: the config's, then the model spec's): the
        eos is kept, later slots are `pad_token_id`. `generator` drives
        non-greedy sampling (default: seeded with 0)."""
        if isinstance(tokens, (list, tuple)) and tokens \
                and np.ndim(tokens[0]) == 1 \
                and len({len(t) for t in tokens}) > 1:
            tokens, prompt_lens = self._pad_ragged(tokens)
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                 device=self.device)
        B, T = tokens.shape
        max_new = int(max_new_tokens)
        self._check_positions(T + max_new - 1)
        cache = self._get_cache(B, self._cache_len(T + max_new))
        if prompt_lens is None:
            prompt_len = torch.full((B,), T, dtype=torch.long,
                                    device=self.device)
        else:
            prompt_len = torch.as_tensor(np.asarray(prompt_lens),
                                         dtype=torch.long, device=self.device)
        eos = eos_token_id
        if eos is None:
            eos = self.config.eos_token_id
        if eos is None:
            eos = self.model_spec.eos_token_id
        if not stop_on_eos or eos is None:
            eos = -1
        if generator is None and not self.config.greedy:
            generator = self.make_generator(0)

        spec, params = self.model_spec, self.params
        logits, cache = spec.prefill_fn(params, tokens, cache, None)
        # last prompt logits per row (rows are right-padded; causal masking
        # keeps the pads out of them)
        last = logits[torch.arange(B, device=self.device), prompt_len - 1]
        tok = self._sample(last, generator)
        pos = prompt_len.clone()
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        out = torch.full((B, max_new), pad_token_id, dtype=torch.int32,
                         device=self.device)
        for i in range(max_new):
            # eos semantics (reference generate()): the eos itself is kept,
            # everything after it is pad_token_id
            new_done = done | (tok == eos) if eos >= 0 else done
            out[:, i] = torch.where(done, pad_token_id, tok)
            if i == max_new - 1 or (eos >= 0 and bool(new_done.all())):
                break
            lg, cache = spec.decode_fn(params, tok, pos, cache)
            tok = torch.where(new_done, pad_token_id,
                              self._sample(lg, generator))
            pos, done = pos + 1, new_done
        return out.cpu().numpy()

    def serving(self, **overrides):
        """Continuous-batching serving engine over this engine's params:
        persistent paged KV pool + request scheduler (inference/
        scheduler.py). `overrides` patch `config.serving` fields."""
        from deepspeed_tpu_torch.inference.scheduler import ServingEngine
        return ServingEngine(self, **overrides)


def init_inference(model=None, config=None, device=None, **kwargs):
    """Reference signature (`deepspeed/__init__.py:269`): a config dict, a
    JSON path or a TpuInferenceConfig, plus kwargs overrides. `device`
    defaults to `cuda`; the CPU is used only when asked for."""
    if config is None:
        config = {}
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    if isinstance(config, dict):
        cfg = TpuInferenceConfig.from_dict({**config, **kwargs})
    else:
        cfg = config
    if not isinstance(model, DecodeModelSpec):
        raise TypeError("init_inference expects a DecodeModelSpec (see "
                        "deepspeed_tpu_torch.models.gpt.make_gpt_decode_model)")
    return InferenceEngine(model, cfg, device=device)
