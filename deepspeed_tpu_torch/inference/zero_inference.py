"""ZeRO-Inference: serve models whose weights exceed HBM (counterpart of
`deepspeed_tpu/inference/zero_inference.py`).

The weights stay in host RAM or on NVMe and stream through device memory a
layer at a time. The transformer stack is homogeneous, so one per-layer
function serves every layer with that layer's weights as arguments, and
`runtime/param_swap.LayerStreamer` copies the next layers in on its own
stream while the current one computes. The device holds the resident
leaves (embeddings, norms, head), `lookahead + 1` layers and the KV cache,
whatever the depth. Every token streams all the weights through HBM once,
so throughput is bounded by the host link: batch wide to amortize it.

The engine runs on `cuda` unless the caller passes `device="cpu"`.
"""

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.config import TpuInferenceConfig
from deepspeed_tpu_torch.inference.engine import (params_to, resolve_device,
                                                  sample_logits)
from deepspeed_tpu_torch.models.gpt import as_dtype
from deepspeed_tpu_torch.runtime.param_swap import (LayerParamStore,
                                                    LayerStreamer)
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.tree import tree_leaves


def tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@dataclasses.dataclass
class LayeredModelSpec:
    """A model factored into per-layer pieces
    (`models/gpt.py::make_gpt_layered_model`)."""
    embed_fn: Callable        # (resident, tokens[B,T], positions[B,T]) -> x[B,T,D]
    layer_prefill_fn: Callable  # (layer_p, x, ck, cv, positions) -> (x, ck, cv)
    layer_decode_fn: Callable   # (layer_p, x[B,1,D], ck, cv, pos[B]) -> (x, ck, cv)
    final_fn: Callable        # (resident, x[B,T,D]) -> logits[B,T,V]
    resident: Any             # always-on-device params (embed/norms/head)
    blocks: Any               # stacked per-layer params (leading dim L)
    num_layers: int
    init_layer_cache: Callable  # (B, max_len, dtype, device) -> (ck, cv)
    # training-side spill (runtime/infinity.py):
    layer_train_fn: Optional[Callable] = None  # (layer_p, x, positions) -> x
    train_loss_fn: Optional[Callable] = None   # (resident, x, labels) -> loss
    eos_token_id: Optional[int] = None
    name: str = "model"
    # streamed paged serving (inference/scheduler.py):
    #   layer_paged_fn(layer_p, x[B,C,D], layer_idx, pool, block_tables,
    #                  positions[B,C]) -> (x, pool)
    #     layer_idx is a Python int: the layer's view of the [L, ...] pool
    #     is written in place
    #   init_paged_pool(num_blocks, block_size, dtype, kv_group_size=0,
    #                   device=...) -> pool (the decode model's layout)
    layer_paged_fn: Optional[Callable] = None
    init_paged_pool: Optional[Callable] = None
    cache_fingerprint: Optional[str] = None
    dtype: Any = None          # activation dtype the functions compute in
    max_positions: Optional[int] = None  # learned-position table size


class ZeroInferenceEngine:
    """Inference engine over the parameter spill tier. `offload_device`:
    "cpu" (host RAM) or "nvme" (disk through the AIO library, O_DIRECT).
    `lookahead`: layers of weights in flight ahead of compute."""

    def __init__(self, model: LayeredModelSpec, config: TpuInferenceConfig,
                 offload_device="cpu", nvme_path=None, lookahead=1,
                 staging=3, device=None):
        self.model_spec = model
        self.config = config
        self.device = resolve_device(device)
        self.dtype = as_dtype(config.dtype)
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
        self.resident = params_to(model.resident, self.device, self.dtype)
        self.telemetry = Telemetry(getattr(config, "telemetry", None),
                                   subsystem="zero_inference")
        self.store = LayerParamStore(
            model.blocks, device=offload_device, swap_folder=nvme_path,
            staging=staging, dtype=self.dtype,
            pin=self.device.type == "cuda")
        self.store.telemetry = self.telemetry
        # cyclic: decode walks layers 0..L-1 over and over, so layer 0 is
        # staged while L-1 computes
        self.streamer = LayerStreamer(self.store, lookahead=lookahead,
                                      cyclic=True, telemetry=self.telemetry,
                                      device=self.device)
        self.total_param_bytes = self.store.host_bytes
        self._cache_entry = None       # ((B, max_len), caches)
        self._cache_hits = 0
        log_dist(f"zero-inference engine: {model.name} dtype={self.dtype} "
                 f"offload={offload_device} layers={self.store.num_layers} "
                 f"layer_mb={self.store.layer_bytes / 1e6:.1f} resident+"
                 f"{lookahead + 1} layers on {self.device}", ranks=[0])

    @property
    def params(self):
        """The device-resident tree (embeddings, norms, head): what the
        serving scheduler hands the embed and head functions."""
        return self.resident

    def enable_weight_quant(self, bits=8, group_size=64):
        raise ValueError(
            "weight-only quantization is a resident-engine feature "
            "(InferenceEngine.enable_weight_quant): the spill tier streams "
            "bit16 layers from the host store — quantize the HOST copies "
            "instead by building the store at a narrower dtype, or serve "
            "resident with serving.quantization.weights")

    def make_generator(self, seed=0):
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _sample(self, logits, generator):
        cfg = self.config
        return sample_logits(logits, generator, greedy=cfg.greedy,
                             temperature=cfg.temperature, top_k=cfg.top_k,
                             top_p=cfg.top_p)

    def _check_positions(self, n):
        limit = self.model_spec.max_positions
        if limit is not None and n > limit:
            raise ValueError(f"{n} positions exceed the model's learned "
                             f"position table ({limit})")

    # ---- forward ----

    def _as_tokens(self, tokens):
        if isinstance(tokens, torch.Tensor):
            return tokens.to(self.device, torch.long)
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def _init_caches(self, B, max_len):
        return [self.model_spec.init_layer_cache(B, max_len, self.dtype,
                                                 self.device)
                for _ in range(self.store.num_layers)]

    def _own_caches(self, B, max_len):
        """The engine's per-layer caches, reused on a (B, max_len) match
        (one entry). Reuse without zeroing is exact: every call reads only
        positions it wrote itself."""
        key = (int(B), int(max_len))
        if self._cache_entry is not None and self._cache_entry[0] == key:
            self._cache_hits += 1
            return self._cache_entry[1]
        self._cache_entry = None
        caches = self._init_caches(B, max_len)
        self._cache_entry = (key, caches)
        return caches

    @torch.inference_mode()
    def forward(self, tokens, caches=None, max_len=None):
        """Prefill: logits [B, T, V] and the per-layer caches, streaming the
        weights."""
        tokens = self._as_tokens(tokens)
        B, T = tokens.shape
        self._check_positions(T)
        if caches is None:
            caches = self._init_caches(B, max_len or max(
                self.config.max_out_tokens, T))
        spec = self.model_spec
        positions = torch.arange(T, device=self.device).expand(B, T)
        x = spec.embed_fn(self.resident, tokens, positions)
        for i in range(self.store.num_layers):
            x, ck, cv = spec.layer_prefill_fn(self.streamer.layer(i), x,
                                              caches[i][0], caches[i][1],
                                              positions)
            caches[i] = (ck, cv)
        return spec.final_fn(self.resident, x), caches

    __call__ = forward

    def _decode_step(self, token, pos, caches):
        spec = self.model_spec
        x = spec.embed_fn(self.resident, token[:, None], pos[:, None])
        for i in range(self.store.num_layers):
            x, ck, cv = spec.layer_decode_fn(self.streamer.layer(i), x,
                                             caches[i][0], caches[i][1], pos)
            caches[i] = (ck, cv)
        return spec.final_fn(self.resident, x)[:, 0], caches

    @torch.inference_mode()
    def generate(self, tokens, max_new_tokens=16, eos_token_id=None,
                 pad_token_id=0, generator=None):
        """Greedy generation (sampled per the config when greedy is off).
        Returns [B, n] with n ≤ max_new_tokens: generation stops once every
        row has emitted EOS, as the JAX engine's does. Each emitted token
        streams every layer's weights through HBM."""
        tokens = self._as_tokens(tokens)
        B, T = tokens.shape
        self._check_positions(T + max_new_tokens - 1)
        if generator is None and not self.config.greedy:
            generator = self.make_generator(0)
        # whole kv_block_size blocks, as the resident engine's cache (the
        # decode kernel then walks the same cache in both)
        bs = int(self.config.kv_block_size or 0)
        n = T + max_new_tokens
        caches = self._own_caches(B, -(-n // bs) * bs if bs else n)
        logits, caches = self.forward(tokens, caches)
        tok = self._sample(logits[:, -1, :], generator)
        pos = torch.full((B,), T, dtype=torch.long, device=self.device)
        eos = self.model_spec.eos_token_id if eos_token_id is None \
            else eos_token_id
        out = []
        done = np.zeros((B,), bool)
        for step in range(max_new_tokens):
            emitted = np.where(done, pad_token_id, tok.cpu().numpy())
            out.append(emitted)
            if eos is not None:
                done |= emitted == eos
            if step == max_new_tokens - 1 or done.all():
                break
            logits, caches = self._decode_step(tok, pos, caches)
            tok = self._sample(logits, generator)
            pos = pos + 1
        return np.stack(out, axis=1)

    # ---- serving ----

    def serving(self, **overrides):
        """Continuous-batching serving over the streamed weights: the paged
        pool and scheduler (inference/scheduler.py) walk one per-layer
        function fed by this engine's streamer. The streamed mode refuses
        a decode window above 1, speculative decoding and weight-only
        quantization."""
        from deepspeed_tpu_torch.inference.scheduler import ServingEngine
        return ServingEngine(self, **overrides)

    # ---- accounting ----

    @property
    def peak_param_hbm_bytes(self):
        """High-water mark of device-resident streamed weight bytes."""
        return self.streamer.peak_live_layers * self.store.layer_bytes

    def release(self):
        self.telemetry.close()
        self.streamer.release()
        self.store.release()
