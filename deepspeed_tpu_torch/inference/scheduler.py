"""Continuous-batching serving scheduler over the paged KV-cache pool
(counterpart of `deepspeed_tpu/inference/scheduler.py`, its core).

The engine owns `max_slots` fixed sequence slots and ONE paged KV pool
(`inference/kv_cache.py`), and drives every request through two step
shapes:

  * a prefill step — one [1, chunk] slice of a prompt, written through the
    slot's block table; `prefill_chunks_per_step` bounds how long an
    arriving prompt can stall the running batch;
  * a decode step — one token for ALL slots at once: inactive slots ride
    along pointed at the trash block (pos 0), so slot liveness never
    changes the step's shape. A decode WINDOW (`decode_steps_per_sync`)
    runs several tokens per host sync in a Python loop.

Scheduling happens between the steps, on the host: admit queued requests
into free slots (all-or-nothing block allocation, FIFO — a too-big request
waits instead of half-occupying the pool), retire a sequence the step it
emits EOS and free its blocks the same step.

Quantized serving (`quantization={...}`): weight-only int8/int4 applies to
the engine's resident params (`InferenceEngine.enable_weight_quant`), and
`kv_cache_dtype="int8"` builds the int8 pool, whose K/V quantize at cache
write and dequantize inside the paged decode kernel.

Telemetry (the engine config's `telemetry` block, off by default):
`serving/queue_wait_ms` at admission, `serving/ttft_ms` at a request's
first emitted token, `serving/tpot_ms` per token (interpolated inside each
emission burst, so a decode window of K tokens gives K samples) and
`serving/e2e_ms` at retirement, the queue / slot / pool gauges and the
admit / prefill-chunk / decode-window spans; `latency_snapshot()` reads
them. Every stamp is taken on the host clock after the tokens it times are
on the host, at the reads the scheduler makes anyway: telemetry adds no
device synchronization. With it off, no stamp is taken and no file is
written.

Automatic prefix caching (`serving.enable_prefix_caching`,
`inference/prefix_cache.py`): at admission the prompt's hash chain is
matched against previously written full blocks, the hit blocks are mapped
into the slot's table with a refcount bump, and the prefill cursor starts
at the cached boundary. Only host-side state changes.

Speculative decoding (`serving.spec_decode`, `inference/spec_decode.py`)
replaces the decode step and its window: a drafter proposes `draft_k`
tokens a slot, one verify call (`verify_paged_fn`) scores them for every
slot, and each slot emits its longest agreeing prefix plus a bonus token.
A rejected draft is rolled back by not advancing the cursor. A verify
step reads the device once (the target's tokens), plus once for the model
drafter's drafts.

The pool auditor (`inference/audit.py`) checks the bookkeeping's
invariants every `audit_interval` syncs, on demand and at `close()`, and
repairs or raises (`audit_action`). The degradation ladder
(`serving/degradation.py`) caps drafts, disables spec decode, forces the
1-step window, flushes the prefix cache and sheds low-priority queued
requests under sustained pressure.

Streamed mode (a `ZeroInferenceEngine`, `inference/zero_inference.py`):
the two step shapes walk the layered model's per-layer paged function over
the pool, each layer's weights from the engine's streamer; `stats()`
gains the `offload` block. It refuses speculative decoding and a decode
window above 1, as the JAX package does.

The router's hooks (`serving/router.py`): a request's hard deadline
(`Request.deadline_ms`, or an absolute `deadline_at` from the router)
retires it at the next sync with `finish_reason="deadline"`; a
`prefill_only` request parks in the handoff state after its first token,
and `export_handoff` / `adopt_handoff` / `release_handoff` move its blocks
into a decode replica's pool (`kv_cache.transplant_blocks`); `cancel`,
`drain_queued`, `active_uids` and `has_output` serve TTL, failover and
hedging. `attach_observability` shares the pool's request tracer and
flight recorder. Every stamp (TTFT, TPOT, deadlines) reads the injected
clock (`set_clock`), in the reference's order of reads.

The memory ledger (`telemetry.memscope`, `telemetry/memscope.py`): a
pre-flight plan runs BEFORE the pool is allocated (the pool's bytes from a
`meta`-device pool), so a predicted OOM warns or refuses ahead of the
allocation; `self.memscope` (a `ServingMemScope`) publishes the `mem/*`
gauges each telemetry step, `stats()["memory"]` is its snapshot, and an
allocator failure inside `step()` dumps the ledger before it re-raises.
"""

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.audit import (PoolAuditor,
                                                 PoolCorruptionError)
from deepspeed_tpu_torch.inference.kv_cache import (BlockAllocator,
                                                    TRASH_BLOCK,
                                                    blocks_needed,
                                                    max_written_pos,
                                                    transplant_blocks)
from deepspeed_tpu_torch.inference.spec_decode import (accept_greedy,
                                                       make_drafter)
from deepspeed_tpu_torch.models.gpt import as_dtype
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.utils.logging import log_dist


class InadmissibleRequestError(ValueError):
    """The request can NEVER be admitted by this engine — prompt plus budget
    exceed `max_context`, or it needs more KV blocks than the whole pool
    holds. Raised at submit() so an impossible request fails fast instead of
    wedging the FIFO head forever; the serving router catches it per
    replica to find one whose limits fit."""


@dataclasses.dataclass
class Request:
    """One generation request. `eos_token_id=None` falls back to the engine
    / model default; `stop_on_eos=False` disables early stop.
    `deadline_ms` is a hard end-to-end budget from submission, enforced
    past admission: a request still generating when it runs out retires at
    the next scheduler sync with ``finish_reason="deadline"`` (its tokens
    so far are kept). `priority` orders the degradation ladder's shedding
    (queued requests below the configured threshold go first); it never
    changes FIFO order."""
    uid: Any
    tokens: Sequence[int]
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    stop_on_eos: bool = True
    deadline_ms: Optional[float] = None
    priority: int = 0


@dataclasses.dataclass
class CompletedRequest:
    uid: Any
    prompt_len: int
    tokens: np.ndarray        # generated tokens; the EOS (if emitted) is kept
    finish_reason: str        # "eos" | "length" | "cancelled" (cancel(),
                              # router TTL or shedding) | "deadline"
    cached_prefix_tokens: int = 0  # prompt tokens whose K/V came from the
                              # prefix cache (0 when caching is off/missed)
    timing: Optional[Dict[str, float]] = None  # telemetry only: monotonic
                              # arrival/admit/first_token/finish stamps
                              # (None when telemetry is disabled)


_FREE, _PREFILL, _DECODE, _HANDOFF = 0, 1, 2, 3


class _Slot:
    __slots__ = ("idx", "state", "uid", "prompt", "prompt_len", "padded_len",
                 "max_new", "eos", "blocks", "cursor", "pos", "emitted",
                 "hashes", "reg", "cached", "prefill_only", "deadline",
                 "t_arrive", "t_admit", "t_first", "t_prev", "trace")

    def __init__(self, idx):
        self.idx = idx
        self.reset()

    def reset(self):
        self.state = _FREE
        self.uid = self.prompt = None
        self.prompt_len = self.padded_len = self.max_new = 0
        self.eos = None
        self.blocks = []
        self.cursor = self.pos = 0
        self.emitted = []
        self.hashes = None      # prefix-cache hash chain (full prompt blocks)
        self.reg = 0            # blocks [0, reg) registered or cached
        self.cached = 0         # blocks mapped from the cache at admission
        self.prefill_only = False  # park in _HANDOFF after the last chunk
        self.deadline = None    # absolute hard deadline (engine clock)
        self.t_arrive = self.t_admit = self.t_first = None  # telemetry stamps
        self.t_prev = None      # last emission sync (TPOT interpolation anchor)
        self.trace = None       # TraceContext (None unless tracing is on)


class ServingEngine:
    """Continuous-batching server on top of an `InferenceEngine` whose model
    spec carries the paged contract.

    Usage::

        serving = engine.serving(max_slots=8, max_context=2048)
        results = serving.run([Request(uid=0, tokens=prompt)])

    `clock` (default `time.monotonic`) stamps request timing; tests inject
    one to pin TTFT / TPOT. `draft_spec` is the draft model of
    `spec_decode={"drafter": "model"}`.
    """

    def __init__(self, engine, draft_spec=None, clock=None, **overrides):
        spec = engine.model_spec
        # streamed (offloaded-weights) mode: a LayeredModelSpec served
        # through a ZeroInferenceEngine walks one per-layer function over
        # the paged pool, its weights fed by the engine's streamer
        self.streamed = getattr(spec, "layer_paged_fn", None) is not None \
            and getattr(spec, "prefill_paged_fn", None) is None
        if self.streamed:
            missing = [n for n in ("layer_paged_fn", "init_paged_pool",
                                   "embed_fn", "final_fn")
                       if getattr(spec, n, None) is None]
            if missing:
                raise ValueError(
                    f"layered model spec '{spec.name}' has no streamed "
                    f"paged contract (missing {missing}); build it with "
                    f"make_gpt_layered_model")
            self._prefill_paged, self._decode_paged = \
                self._streamed_paged_fns(engine)
        else:
            missing = [n for n in ("prefill_paged_fn", "decode_paged_fn",
                                   "init_paged_pool")
                       if getattr(spec, n, None) is None]
            if missing:
                raise ValueError(
                    f"model spec '{spec.name}' has no paged serving contract "
                    f"(missing {missing}); build it with make_gpt_decode_model "
                    f"or serve through generate()")
            self._prefill_paged = spec.prefill_paged_fn
            self._decode_paged = spec.decode_paged_fn
        self.engine = engine
        self.config = engine.config
        # the ServingConfig's __post_init__ validates (and converts dict
        # overrides of) the nested blocks — unported features raise here
        scfg = dataclasses.replace(engine.config.serving, **overrides)
        self.serving_config = scfg

        # quantized serving. Weight-only quantization runs first: it
        # replaces the engine's resident params, which every step reads
        qcfg = scfg.quantization
        weights = str(qcfg.weights or "off")
        if weights not in ("off", "int8", "int4"):
            raise ValueError(
                f"unknown serving.quantization.weights {weights!r} "
                f"(expected 'off', 'int8' or 'int4')")
        self.weight_quant = weights
        self.weight_quant_stats = None
        if weights != "off":
            self.weight_quant_stats = engine.enable_weight_quant(
                bits=8 if weights == "int8" else 4,
                group_size=int(qcfg.weight_group_size))
        # the pool's dtype: the quantization block wins, else the engine's
        # kv_cache_dtype. int8 is the one integer layout (payload + scales,
        # quantized writes): any other integer dtype would truncate float
        # K/V through the fp write's cast, so it is refused
        kvd = str(qcfg.kv_cache_dtype or "") or str(engine.config.kv_cache_dtype)
        kvd = type(engine.config)._LEGACY_DTYPES.get(kvd, kvd)
        if kvd != "int8":
            try:
                kv_dtype = as_dtype(kvd)
            except ValueError:
                raise ValueError(
                    f"unsupported KV-cache dtype {kvd!r}: expected a float "
                    f"dtype or 'int8' (the quantized paged pool — "
                    f"serving.quantization.kv_cache_dtype)") from None
            if kv_dtype != engine.dtype:
                raise NotImplementedError(
                    f"KV-cache dtype {kvd} != the engine dtype "
                    f"{engine.dtype}: the port keeps K/V in the compute "
                    f"dtype (or int8)")
        self.kv_cache_dtype = kvd
        self.kv_quant = kvd == "int8"
        self.kv_group_size = int(qcfg.kv_group_size or 0)

        bs = int(self.config.kv_block_size or 0)
        if bs <= 0:
            raise ValueError("serving needs kv_block_size > 0 (the paged "
                             "pool's physical block unit)")
        self.block_size = bs
        self.max_context = int(scfg.max_context or self.config.max_out_tokens)
        if spec.max_positions is not None \
                and self.max_context > spec.max_positions:
            raise ValueError(
                f"max_context {self.max_context} exceeds the model's learned "
                f"position table ({spec.max_positions})")
        self.nb = -(-self.max_context // bs)       # block-table width
        self.max_slots = int(scfg.max_slots)
        self.chunk = int(scfg.prefill_chunk or bs)
        self.prefill_budget = max(1, int(scfg.prefill_chunks_per_step))
        self.window = max(1, int(scfg.decode_steps_per_sync))
        # speculative decoding: the verify step replaces the decode step
        # (and its window) when a drafter is configured
        self.spec_on = str(scfg.spec_decode.drafter or "off") != "off"
        if self.streamed:
            # every decode token already walks the host link once; a verify
            # chunk or a window of several tokens per sync is refused, not
            # silently degraded
            if self.spec_on:
                raise ValueError(
                    "speculative decoding is a resident-engine feature: the "
                    "streamed (offloaded-weights) serving mode walks one "
                    "jitted per-layer program per token and has no verify "
                    "contract — drop spec_decode, or serve resident")
            if self.window != 1:
                raise ValueError(
                    f"decode_steps_per_sync={self.window} needs the whole "
                    f"stack resident inside one jitted scan; the streamed "
                    f"(offloaded-weights) mode streams layers through HBM "
                    f"per token — set decode_steps_per_sync=1")
        self.draft_k = int(scfg.spec_decode.draft_k) if self.spec_on else 0
        if self.spec_on and spec.verify_paged_fn is None:
            raise ValueError(
                f"model spec '{spec.name}' has no verify_paged_fn — "
                f"speculative decoding needs the k-token paged verify "
                f"contract (make_gpt_decode_model provides it)")
        num_blocks = int(scfg.num_kv_blocks or (self.max_slots * self.nb + 1))

        # memscope pre-flight BEFORE the pool allocation below: the plan is
        # shape arithmetic over a meta-device pool (no device memory), so a
        # predicted-OOM configuration warns or refuses ahead of the
        # allocation that would fail on the card
        tcfg = getattr(self.config, "telemetry", None)
        self._memscope_on = bool(getattr(tcfg, "enabled", False) and
                                 getattr(tcfg, "memscope", False))
        self._preflight_plan = None
        if self._memscope_on:
            from deepspeed_tpu_torch.telemetry import memscope as _ms
            mode = str(getattr(tcfg, "memscope_preflight", "warn"))
            if mode != "off":
                cap = int(getattr(tcfg, "memscope_capacity_bytes", 0) or 0)
                if not cap and engine.device.type == "cuda":
                    cap = int(_ms.device_memory_stats(engine.device).get(
                        "bytes_limit", 0))
                plan = _ms.plan_serving_prealloc(
                    spec, num_kv_blocks=num_blocks, kv_block_size=bs,
                    kv_cache_dtype=torch.int8 if self.kv_quant
                    else engine.dtype,
                    kv_group_size=self.kv_group_size,
                    params=engine.params,
                    draft_spec=draft_spec
                    if scfg.spec_decode.drafter == "model" else None,
                    param_dtype=engine.dtype, capacity_bytes=cap)
                self._preflight_plan = _ms.preflight_check(
                    plan, refuse=(mode == "refuse"))

        if self.kv_quant:
            # the quantized-pool contract: the 4-argument form, and a pool
            # that carries k_scale / v_scale
            try:
                pool = spec.init_paged_pool(num_blocks, bs, torch.int8,
                                            self.kv_group_size,
                                            device=engine.device)
            except TypeError as e:
                raise ValueError(
                    f"model spec '{spec.name}' init_paged_pool does not "
                    f"accept the quantized form (num_blocks, block_size, "
                    f"dtype, kv_group_size, device=...) — it does not "
                    f"implement the quantized-pool contract "
                    f"(init_paged_kv_pool in models/gpt.py is the "
                    f"reference): {e}") from e
            if not (isinstance(pool, dict) and "k_scale" in pool
                    and "v_scale" in pool):
                raise ValueError(
                    f"model spec '{spec.name}' init_paged_pool returned no "
                    f"k_scale/v_scale leaves for dtype int8 — it does not "
                    f"implement the quantized-pool contract "
                    f"(init_paged_kv_pool in models/gpt.py is the reference)")
        else:
            pool = spec.init_paged_pool(num_blocks, bs, engine.dtype,
                                        device=engine.device)
        self.pool = pool
        self.allocator = BlockAllocator(
            num_blocks, policy=str(scfg.prefix_cache_policy or "lru"))
        self.prefix_cache = None
        if scfg.enable_prefix_caching:
            from deepspeed_tpu_torch.inference.prefix_cache import PrefixCache
            self.prefix_cache = PrefixCache(
                self.allocator, bs,
                fingerprint=spec.cache_fingerprint or spec.name)
        self.tables = np.full((self.max_slots, self.nb), TRASH_BLOCK, np.int32)
        self.slots = [_Slot(i) for i in range(self.max_slots)]
        self.queue = collections.deque()
        self._generator = None if self.config.greedy \
            else engine.make_generator(0)

        # telemetry: TTFT/TPOT/queue-wait/e2e histograms + queue/slot/pool
        # gauges + per-phase spans. Disabled by default — then every record
        # site below is a single attribute check and nothing is written
        self.telemetry = Telemetry(getattr(self.config, "telemetry", None),
                                   subsystem="serving")
        if self.telemetry.enabled and self.spec_on:
            # acceptance rates lie in [0, 1]: linear buckets, not the
            # default log-scale ms ones
            self.telemetry.registry.histogram(
                "serving/spec_accept_rate",
                bounds=[i / 20 for i in range(1, 21)])
        # the request tracer and flight recorder: the engine's own (from
        # its telemetry config) until a router injects the pool's shared
        # ones through attach_observability
        self.tracer = self.telemetry.tracer
        self.flightrec = self.telemetry.flightrec
        self.trace_tid = 0
        if self.streamed and self.telemetry.enabled:
            # the staging pool's offload/* metrics land in this registry
            engine.streamer.telemetry = self.telemetry
            engine.store.telemetry = self.telemetry
        self._clock = clock if clock is not None else time.monotonic

        # the drafter after the pool and allocator: the draft-model drafter
        # mirrors the pool's geometry and shares the block tables
        if draft_spec is not None and scfg.spec_decode.drafter != "model":
            raise ValueError(
                f"draft_spec was passed but spec_decode.drafter is "
                f"{scfg.spec_decode.drafter!r} — only the 'model' drafter "
                f"consumes it (did you mean spec_decode="
                f"{{'drafter': 'model', ...}}?)")
        self.drafter = make_drafter(self, scfg.spec_decode,
                                    draft_spec=draft_spec) \
            if self.spec_on else None

        # the memory ledger, after the drafter so the draft mirror is on
        # it; the pre-flight plan above becomes its last_plan (the OOM
        # dump's "was this foreseeable" base). Off: no object, no gauges
        self.memscope = None
        if self._memscope_on:
            from deepspeed_tpu_torch.telemetry.memscope import \
                ServingMemScope
            self.memscope = ServingMemScope(self)
            self.memscope.last_plan = self._preflight_plan

        # the pool auditor: host-side reads only, every `audit_interval`
        # syncs, on demand and at close()
        self.audit_interval = int(scfg.audit_interval or 0)
        self.audit_action = str(scfg.audit_action or "repair")
        if self.audit_action not in ("repair", "raise"):
            raise ValueError(f"unknown audit_action {self.audit_action!r} "
                             f"(expected 'repair' or 'raise')")
        self._auditor = PoolAuditor(self)
        self.audits_run = 0
        self.audit_violations_total = 0
        self.audit_repairs = 0

        # the degradation ladder: disabled, no controller is built
        self.pressure = None
        if scfg.degradation.enabled:
            from deepspeed_tpu_torch.serving.degradation import \
                PressureController
            self.pressure = PressureController(self, scfg.degradation)

        self.steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_chunks_skipped = 0     # chunks the prefix cache elided
        self.prefix_hit_blocks = 0
        self.prefix_hit_tokens = 0
        self.tokens_generated = 0
        self.peak_active = 0
        self.cancelled = 0
        self.deadline_cancelled = 0         # requests retired "deadline"
        self.degradation_sheds = 0          # queued requests the ladder shed
        self.handoffs_out = 0               # slots exported to a decode engine
        self.handoffs_in = 0                # slots adopted from a prefill one
        self._deadlines = False             # a live request has a deadline
        self.verify_calls = 0               # spec decode: verify steps
        self.verify_slot_steps = 0          # slot participations in them
        self.drafted_tokens = 0             # real proposals scored
        self.accepted_tokens = 0            # drafts equal to the target's
        self.spec_emitted_tokens = 0        # tokens emitted by verify steps

        pool_mb = sum(t.numel() * t.element_size()
                      for t in self.pool.values()) / 2**20
        log_dist(f"serving engine: {spec.name} slots={self.max_slots} "
                 f"blocks={num_blocks}x{bs} ({pool_mb:.0f} MB pool, "
                 f"kv={self.kv_cache_dtype}, weights={self.weight_quant}) "
                 f"table_width={self.nb} prefill_chunk={self.chunk}",
                 ranks=[0])

    # ------------------------------------------------------------------
    # the two step shapes
    # ------------------------------------------------------------------

    @staticmethod
    def _streamed_paged_fns(engine):
        """The paged prefill and decode of the streamed mode, with the
        resident contract's signatures: embed, then each layer's paged
        function on the streamer's layer (layer i computes while the next
        ones upload), then the head."""
        spec, streamer = engine.model_spec, engine.streamer
        L = engine.store.num_layers

        def walk(x, pool, tables, positions):
            for i in range(L):
                x, pool = spec.layer_paged_fn(streamer.layer(i), x, i, pool,
                                              tables, positions)
            return x, pool

        def prefill(params, tokens, start_pos, last_idx, pool, tables):
            B, C = tokens.shape
            positions = start_pos[:, None] + torch.arange(
                C, device=tokens.device)[None]
            x, pool = walk(spec.embed_fn(params, tokens, positions), pool,
                           tables, positions)
            last = x[torch.arange(B, device=x.device), last_idx][:, None]
            return spec.final_fn(params, last)[:, 0], pool

        def decode(params, token, pos, pool, tables):
            positions = pos[:, None]
            x, pool = walk(spec.embed_fn(params, token[:, None], positions),
                           pool, tables, positions)
            return spec.final_fn(params, x)[:, 0], pool

        return prefill, decode

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(a, dtype=dtype, device=self.engine.device)

    def _prefill_step(self, chunk, start, last, table):
        """One [1, chunk] prompt slice; returns the token sampled from the
        logits at `last` (meaningful on the prompt's final chunk only)."""
        logits, self.pool = self._prefill_paged(
            self.engine.params, self._tensor(chunk, torch.long),
            self._tensor([start], torch.long), self._tensor([last], torch.long),
            self.pool, self._tensor(table))
        return self.engine._sample(logits, self._generator)

    def _decode_step(self, tok, pos, tables, window):
        """`window` tokens for every slot: returns [S, window] successors of
        `tok`, writing each input token's k/v along the way. With window 1
        it is the 1-step decode the degraded paths run (the spec-disabled
        fallback, whose blocks carry a k-draft overhang and no window
        tail, and the ladder's window-1 rung)."""
        params = self.engine.params
        tok = self._tensor(tok)
        pos = self._tensor(pos, torch.long)
        tables = self._tensor(tables)
        out = []
        for _ in range(window):
            logits, self.pool = self._decode_paged(params, tok, pos,
                                                   self.pool, tables)
            tok = self.engine._sample(logits, self._generator)
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1).cpu().numpy()

    def _verify_step(self, toks, pos, tables):
        """Score [S, k+1] tokens at positions pos..pos+k in one call, all
        their k/v written through the tables; returns the sampled token of
        every position [S, k+1] on the host (the step's one read). Under
        greedy sampling that is the argmax, the exact-match target."""
        logits, self.pool = self.engine.model_spec.verify_paged_fn(
            self.engine.params, self._tensor(toks), self._tensor(pos,
                                                                 torch.long),
            self.pool, self._tensor(tables))
        S, K1, V = logits.shape
        tgt = self.engine._sample(logits.reshape(S * K1, V), self._generator)
        return tgt.reshape(S, K1).cpu().numpy()

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------

    def set_clock(self, clock):
        """Replace the clock that stamps request timing and sweeps
        deadlines. The router injects its own into every replica (again
        after a restart), so TTL, TTFT stamps, deadlines and its watchdog
        and hedging timers read one time source."""
        self._clock = clock

    def attach_observability(self, tracer=None, flightrec=None, tid=None):
        """Router injection point: share the pool's tracer / flight
        recorder (every replica's spans in one trace file and one black
        box) and take this engine's Perfetto track id."""
        if tracer is not None:
            self.tracer = tracer
        if flightrec is not None:
            self.flightrec = flightrec
        if tid is not None:
            self.trace_tid = int(tid)

    def check_admissible(self, prompt_len: int, max_new: int,
                         prefill_only: bool = False, uid: Any = "?",
                         padded_prompt: int = None) -> int:
        """Raise `InadmissibleRequestError` when the request can NEVER fit
        this engine (max_context, whole-pool block budget), else return the
        blocks it will occupy. A `prefill_only` request never decodes here,
        so only its padded prompt counts. `padded_prompt` overrides this
        engine's chunk-grid padding: a handoff target adopts a slot padded
        on the prefill replica's grid."""
        prompt_len, max_new = int(prompt_len), int(max_new)
        padded = (int(padded_prompt) if padded_prompt else
                  -(-prompt_len // self.chunk) * self.chunk)
        if prompt_len < 1:
            raise InadmissibleRequestError(f"request {uid}: empty prompt")
        if max_new < 1:
            raise InadmissibleRequestError(
                f"request {uid}: max_new_tokens < 1")
        eff_new = 1 if prefill_only else max_new
        eff_window = 1 if prefill_only else self.window
        # a verify writes its whole k-draft overhang, which replaces the
        # window's rounding; a prefill-only slot never verifies here
        eff_spec = 0 if prefill_only else self.draft_k
        need = blocks_needed(prompt_len, padded, eff_new, self.block_size,
                             window=eff_window, spec_k=eff_spec)
        if max_written_pos(prompt_len, padded, eff_new, eff_window,
                           eff_spec) >= self.max_context:
            raise InadmissibleRequestError(
                f"request {uid}: prompt {prompt_len} + max_new {max_new} "
                f"(window {eff_window}, draft_k {eff_spec}) exceeds "
                f"max_context {self.max_context} (raise "
                f"serving.max_context)")
        if need > self.allocator.capacity:
            raise InadmissibleRequestError(
                f"request {uid}: needs {need} KV blocks, pool has "
                f"{self.allocator.capacity} (raise serving.num_kv_blocks)")
        return need

    def submit(self, request: Request, prefill_only: bool = False,
               hashes: Optional[List[bytes]] = None, trace=None,
               deadline_at: Optional[float] = None):
        """Queue a request. Raises `InadmissibleRequestError` if it can
        never be admitted; one that merely doesn't fit *right now* waits
        in the queue (admission backpressure).

        `prefill_only=True` is the disaggregated entry: the slot prefills,
        samples its first token and parks for `export_handoff` instead of
        decoding. `hashes` hands in the router's precomputed chain. `trace`
        carries the router's `TraceContext` (a standalone engine with
        tracing on mints its own). `deadline_at` pins the hard deadline
        absolutely on this engine's clock — the router passes the original
        one through every re-dispatch; without it `request.deadline_ms`
        anchors at arrival here."""
        prompt = np.asarray(request.tokens, np.int32).reshape(-1)
        prompt_len = int(prompt.shape[0])
        padded = -(-prompt_len // self.chunk) * self.chunk
        need = self.check_admissible(prompt_len, request.max_new_tokens,
                                     prefill_only=prefill_only,
                                     uid=request.uid)
        # hashed once; admission re-matches the chain every step while the
        # request waits (the cache's contents change between steps)
        if self.prefix_cache is None:
            hashes = None
        elif hashes is None:
            hashes = self.prefix_cache.hash_chain(prompt)
        t_arrive = self._clock()
        if deadline_at is None and request.deadline_ms is not None:
            deadline_at = t_arrive + float(request.deadline_ms) / 1e3
        if deadline_at is not None:
            self._deadlines = True
        if self.tracer.enabled:
            if trace is None:
                # no router above: this engine owns the trace end to end
                trace = self.tracer.start(request.uid, t0=t_arrive,
                                          owner="engine")
            self.tracer.event(trace, "submit", t_arrive, tid=self.trace_tid,
                              attrs={"prompt_len": prompt_len,
                                     "max_new": int(request.max_new_tokens)})
        self.queue.append((request, prompt, prompt_len, padded, need, hashes,
                           t_arrive, prefill_only, trace, deadline_at))

    def _resolve_eos(self, req: Request):
        if not req.stop_on_eos:
            return None
        eos = req.eos_token_id
        if eos is None:
            eos = self.config.eos_token_id
        if eos is None:
            eos = self.engine.model_spec.eos_token_id
        return eos

    def _admit(self, finished: List[CompletedRequest]):
        free = [s for s in self.slots if s.state == _FREE]
        while self.queue and free:
            (req, prompt, prompt_len, padded, need, hashes,
             t_arrive, prefill_only, trace, deadline_at) = self.queue[0]
            if deadline_at is not None and self._clock() >= deadline_at:
                # expired in the queue: no prefill for a dead request
                self.queue.popleft()
                finished.append(self._expire_queued(req.uid, prompt_len))
                continue
            hit = []
            if hashes:
                # longest-prefix match, capped so the final prompt token is
                # always computed (its logits give the first token), then
                # cut to whole chunks: prefill chunks start on the j*chunk
                # grid, so a partial-chunk hit saves nothing and no chunk
                # ever writes a shared block. incref BEFORE alloc: a hit
                # block may sit on the reclaimable list, and this alloc's
                # eviction must not recycle it
                limit = (prompt_len - 1) // self.block_size
                hit = self.prefix_cache.match(hashes[:limit])
                m = len(hit)
                while m and (m * self.block_size) % self.chunk:
                    m -= 1
                hit = hit[:m]
                for b in hit:
                    self.allocator.incref(b)
            ev0 = self.allocator.evictions
            blocks = self.allocator.alloc(need - len(hit))
            if blocks is None:
                if self.flightrec.enabled:
                    self.flightrec.record(
                        "backpressure", uid=req.uid, need=need - len(hit),
                        available=self.allocator.available,
                        queued=len(self.queue))
                # pool exhausted: FIFO backpressure — the head waits for
                # retirements (no reordering: small requests must not
                # starve a big one). The tentative hit is released tail
                # first, as _retire does
                if hit:
                    self.allocator.free(hit[::-1])
                break
            blocks = hit + blocks
            self.queue.popleft()
            slot = free.pop()
            slot.state = _PREFILL
            slot.uid = req.uid
            slot.prompt = prompt
            slot.prompt_len = prompt_len
            slot.padded_len = padded
            slot.max_new = int(req.max_new_tokens)
            slot.eos = self._resolve_eos(req)
            slot.blocks = blocks
            # prefill resumes at the cached boundary, on the chunk grid
            slot.cursor = len(hit) * self.block_size
            slot.hashes = hashes
            slot.reg = slot.cached = len(hit)
            slot.pos = prompt_len
            slot.emitted = []
            slot.prefill_only = prefill_only
            slot.deadline = deadline_at
            slot.t_arrive = t_arrive
            if self.telemetry.enabled:
                slot.t_admit = self._clock()
                self.telemetry.observe("serving/queue_wait_ms",
                                       (slot.t_admit - t_arrive) * 1e3)
            slot.trace = trace
            if self.tracer.enabled and trace is not None:
                # the queue-wait span and an admit mark; flow_end lands the
                # router's dispatch arrow on this replica's track
                t_adm = slot.t_admit if slot.t_admit is not None \
                    else self._clock()
                self.tracer.flow_end(trace, t_adm, tid=self.trace_tid)
                self.tracer.record(trace, "queued", t_arrive,
                                   max(0.0, t_adm - t_arrive),
                                   tid=self.trace_tid)
                self.tracer.event(trace, "admit", t_adm, tid=self.trace_tid,
                                  attrs={"slot": slot.idx,
                                         "blocks": len(blocks),
                                         "cached_blocks": len(hit)})
            if self.flightrec.enabled:
                self.flightrec.record("admit", uid=req.uid, slot=slot.idx,
                                      blocks=len(blocks),
                                      cached_blocks=len(hit),
                                      queued=len(self.queue))
                if self.allocator.evictions > ev0:
                    self.flightrec.record(
                        "eviction", uid=req.uid,
                        evicted=self.allocator.evictions - ev0)
            self.tables[slot.idx, :] = TRASH_BLOCK
            self.tables[slot.idx, :len(blocks)] = blocks
            if hit:
                self.prefix_hit_blocks += len(hit)
                self.prefix_hit_tokens += len(hit) * self.block_size
                self.prefill_chunks_skipped += slot.cursor // self.chunk

    def _retire(self, slot: _Slot, reason: str) -> CompletedRequest:
        # blocks return to the pool the step the sequence finishes — a
        # decref: shared blocks stay live until their last reader retires,
        # and registered ones park on the reclaimable list. Freed in
        # reverse so a chain's tail parks oldest and demand eviction trims
        # chains tail first (match stops at the first unregistered hash)
        self.allocator.free(slot.blocks[::-1])
        self.tables[slot.idx, :] = TRASH_BLOCK
        timing = None
        if self.telemetry.enabled and slot.t_admit is not None:
            t_finish = self._clock()
            self.telemetry.observe("serving/e2e_ms",
                                   (t_finish - slot.t_arrive) * 1e3)
            # TPOT is recorded per emission burst in _observe_tpot, not as a
            # per-request mean here
            timing = {"arrival": slot.t_arrive, "admit": slot.t_admit,
                      "first_token": slot.t_first, "finish": t_finish}
        if self.tracer.enabled and slot.trace is not None:
            t_end = self._clock()
            self.tracer.event(slot.trace, "retire", t_end,
                              tid=self.trace_tid,
                              attrs={"reason": reason,
                                     "tokens": len(slot.emitted)})
            if slot.trace.owner == "engine":
                # no router above: this engine closes the root span
                self.tracer.finish(slot.trace, t_end, tid=self.trace_tid,
                                   attrs={"reason": reason})
        if self.flightrec.enabled:
            self.flightrec.record("retire", uid=slot.uid, reason=reason,
                                  tokens=len(slot.emitted),
                                  freed_blocks=len(slot.blocks))
        done = CompletedRequest(uid=slot.uid, prompt_len=slot.prompt_len,
                                tokens=np.asarray(slot.emitted, np.int32),
                                finish_reason=reason,
                                cached_prefix_tokens=slot.cached
                                * self.block_size, timing=timing)
        slot.reset()
        return done

    def _emit(self, slot: _Slot, tok: int, finished: List[CompletedRequest]):
        slot.emitted.append(int(tok))
        self.tokens_generated += 1
        if self.telemetry.enabled and len(slot.emitted) == 1 \
                and slot.t_arrive is not None:
            slot.t_first = slot.t_prev = self._clock()
            self.telemetry.observe("serving/ttft_ms",
                                   (slot.t_first - slot.t_arrive) * 1e3)
        if slot.eos is not None and int(tok) == slot.eos:
            finished.append(self._retire(slot, "eos"))
        elif len(slot.emitted) >= slot.max_new:
            finished.append(self._retire(slot, "length"))

    def _observe_tpot(self, slot, anchor, j):
        """Per-token TPOT with intra-burst interpolation: a decode sync
        that emits `j` tokens for a slot since `anchor` (the previous
        emission sync) spreads the interval evenly over them — j samples of
        dt/j each — so `serving/tpot_ms` stays honest whether a step emits
        one token or a K-token decode window."""
        if not self.telemetry.enabled or anchor is None or j <= 0:
            return
        t_now = self._clock()
        per_tok = (t_now - anchor) / j * 1e3
        for _ in range(j):
            self.telemetry.observe("serving/tpot_ms", per_tok)
        if slot.state != _FREE:            # retired slots were reset already
            slot.t_prev = t_now

    def _expire_queued(self, uid, prompt_len) -> CompletedRequest:
        """Complete a queued request whose hard deadline passed before it
        ever touched a slot."""
        self.deadline_cancelled += 1
        self.telemetry.inc("serving/deadline_cancelled")
        if self.flightrec.enabled:
            self.flightrec.record("deadline", uid=uid, queued=True)
        return CompletedRequest(uid=uid, prompt_len=prompt_len,
                                tokens=np.zeros((0,), np.int32),
                                finish_reason="deadline")

    def _sweep_deadlines(self, finished: List[CompletedRequest]):
        """Hard deadlines at the sync point: an active slot (generating or
        parked for handoff) past its budget retires "deadline", blocks
        freed the same call; queued requests past theirs complete without a
        slot. Traffic without deadlines never pays the scan."""
        if not self._deadlines:
            return
        now = self._clock()
        for slot in self.slots:
            if slot.state != _FREE and slot.deadline is not None \
                    and now >= slot.deadline:
                self.deadline_cancelled += 1
                self.telemetry.inc("serving/deadline_cancelled")
                if self.flightrec.enabled:
                    self.flightrec.record("deadline", uid=slot.uid,
                                          tokens=len(slot.emitted))
                finished.append(self._retire(slot, "deadline"))
        if any(rec[9] is not None for rec in self.queue):
            keep = collections.deque()
            for rec in self.queue:
                if rec[9] is not None and now >= rec[9]:
                    finished.append(self._expire_queued(rec[0].uid, rec[2]))
                else:
                    keep.append(rec)
            self.queue = keep

    def cancel(self, uid, queued_only: bool = False,
               reason: str = "cancelled") -> Optional[CompletedRequest]:
        """Withdraw a request wherever it lives: a queued one never touches
        a slot, an active one retires now (blocks freed the same call).
        Returns its CompletedRequest (``finish_reason=reason``, tokens so
        far), or None for an unknown uid — or one still generating under
        `queued_only=True` (the router's TTL mode). A slot parked for
        handoff is cancelled under `queued_only`: it holds blocks on this
        pool while it waits for a decode replica."""
        for i, rec in enumerate(self.queue):
            if rec[0].uid == uid:
                del self.queue[i]
                self.cancelled += 1
                if self.flightrec.enabled:
                    self.flightrec.record("cancel", uid=uid, queued=True,
                                          reason=reason)
                return CompletedRequest(uid=uid, prompt_len=rec[2],
                                        tokens=np.zeros((0,), np.int32),
                                        finish_reason=reason)
        for slot in self.slots:
            if slot.state == _FREE or slot.uid != uid:
                continue
            if queued_only and slot.state != _HANDOFF:
                return None
            self.cancelled += 1
            return self._retire(slot, reason)
        return None

    def drain_queued(self) -> List[Request]:
        """Extract every queued request, emptying the queue — the router's
        failover path re-submits them elsewhere verbatim (they never
        touched this pool)."""
        out = [rec[0] for rec in self.queue]
        self.queue.clear()
        return out

    def active_uids(self) -> List[Any]:
        """Uids occupying slots (prefilling, decoding or parked)."""
        return [s.uid for s in self.slots if s.state != _FREE]

    def has_output(self, uid) -> bool:
        """True once the request has emitted its first token here — the
        router's hedging probe."""
        for s in self.slots:
            if s.state != _FREE and s.uid == uid:
                return len(s.emitted) > 0
        return False

    def shed_queued_below_priority(self, min_priority: int
                                   ) -> List[CompletedRequest]:
        """The ladder's top rung: complete (reason "cancelled") every QUEUED
        request whose priority is strictly below `min_priority`. Active
        slots are never shed."""
        out: List[CompletedRequest] = []
        keep = collections.deque()
        for rec in self.queue:
            req = rec[0]
            if int(getattr(req, "priority", 0)) < min_priority:
                self.cancelled += 1
                self.degradation_sheds += 1
                self.telemetry.inc("serving/degradation_sheds")
                if self.flightrec.enabled:
                    self.flightrec.record("degrade_shed", uid=req.uid,
                                          priority=int(req.priority))
                out.append(CompletedRequest(uid=req.uid, prompt_len=rec[2],
                                            tokens=np.zeros((0,), np.int32),
                                            finish_reason="cancelled"))
            else:
                keep.append(rec)
        self.queue = keep
        return out

    # ------------------------------------------------------------------
    # pool invariant auditing (inference/audit.py)
    # ------------------------------------------------------------------

    def audit_state(self) -> Dict[str, Any]:
        """Portable JSON snapshot of the pool bookkeeping (what
        `audit.audit_main` reads)."""
        return self._auditor.snapshot()

    def audit(self, repair: bool = False):
        """Run the pool auditor now. On violations the flight recorder gets
        the report and dumps, then — with
        `repair=True` — the free list, refcounts and reclaimable LRU are
        rebuilt from the slot tables and audited again; a repair that
        cannot reach a clean state raises `PoolCorruptionError`. Returns
        the pre-repair `AuditReport`."""
        report = self._auditor.audit()
        self.audits_run += 1
        if report.ok:
            return report
        self.audit_violations_total += len(report.violations)
        self.telemetry.inc("serving/audit_violations", len(report.violations))
        if self.flightrec.enabled:
            self.flightrec.record("audit_violation",
                                  violations=len(report.violations),
                                  by_kind=report.by_kind())
            try:
                stats = self.stats()
            except Exception as e:                    # a corrupt pool may
                stats = {"error": str(e)}             # break stats() itself
            self.flightrec.dump(
                f"pool audit failed: {report.summary()}",
                state={"audit": report.to_dict(),
                       "audit_state": self._auditor.snapshot(),
                       "stats": stats})
        if repair:
            summary = self._auditor.repair()
            self.audit_repairs += 1
            self.telemetry.inc("serving/audit_repairs")
            if self.flightrec.enabled:
                self.flightrec.record("audit_repair", **{
                    k: summary[k] for k in ("violations_before",
                                            "violations_after", "clean")})
            log_dist(f"serving audit: repaired {report.summary()} -> "
                     f"{'clean' if summary['clean'] else 'STILL DIRTY'}",
                     ranks=[0])
            if not summary["clean"]:
                raise PoolCorruptionError(report)
        return report

    def _scheduled_audit(self):
        """The every-N-syncs audit: repair in place, or raise, per
        `serving.audit_action`."""
        report = self.audit(repair=(self.audit_action == "repair"))
        if not report.ok and self.audit_action == "raise":
            raise PoolCorruptionError(report)

    # ------------------------------------------------------------------
    # router surface: affinity scoring
    # ------------------------------------------------------------------

    def hash_chain(self, prompt) -> Optional[List[bytes]]:
        """The prompt's chained block hashes (None when caching is off)."""
        if self.prefix_cache is None:
            return None
        return self.prefix_cache.hash_chain(
            np.asarray(prompt, np.int32).reshape(-1))

    def prefix_affinity(self, hashes) -> int:
        """Longest registered prefix (in blocks) this engine holds for a
        hash chain; read-only. 0 when caching is off."""
        if self.prefix_cache is None or not hashes:
            return 0
        return self.prefix_cache.match_len(hashes)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def has_free_slot(self) -> bool:
        return any(s.state == _FREE for s in self.slots)

    # ------------------------------------------------------------------
    # disaggregated prefill/decode: block handoff between engines
    # ------------------------------------------------------------------

    def handoff_ready(self) -> List[Any]:
        """Uids of prefill-only slots whose prefill finished (full prompt
        K/V written, first token emitted): ready for `export_handoff`."""
        return [s.uid for s in self.slots if s.state == _HANDOFF]

    def export_handoff(self, uid) -> Dict[str, Any]:
        """Snapshot a parked slot for transplant. Its blocks stay owned by
        this engine (refcounts untouched) until `release_handoff`: the
        copy completes before the source can be reclaimed."""
        slot = self._handoff_slot(uid)
        # the blocks the prefill cursor wrote: the padded prompt only
        n_used = (slot.padded_len - 1) // self.block_size + 1
        return {"uid": slot.uid, "prompt": slot.prompt,
                "prompt_len": slot.prompt_len, "padded_len": slot.padded_len,
                "max_new": slot.max_new, "eos": slot.eos,
                "emitted": list(slot.emitted), "pos": slot.pos,
                "blocks": list(slot.blocks[:n_used]),
                "cached": slot.cached, "t_arrive": slot.t_arrive,
                "t_admit": slot.t_admit, "t_first": slot.t_first,
                "trace": slot.trace}

    def adopt_handoff(self, state: Dict[str, Any], src_pool) -> bool:
        """Adopt a prefilled slot exported by another engine: allocate its
        whole-lifetime blocks here, copy the prompt's K/V blocks out of
        `src_pool` into them (`transplant_blocks`, in place on this pool)
        and seed a decoding slot that continues from the first token.
        Returns False when no slot or blocks are free right now (the router
        retries; the source still holds its blocks); raises
        `InadmissibleRequestError` when the request can never fit here."""
        need = blocks_needed(state["prompt_len"], state["padded_len"],
                             state["max_new"], self.block_size,
                             window=self.window, spec_k=self.draft_k)
        if max_written_pos(state["prompt_len"], state["padded_len"],
                           state["max_new"], self.window,
                           self.draft_k) >= self.max_context:
            raise InadmissibleRequestError(
                f"request {state['uid']}: handoff target max_context "
                f"{self.max_context} too small (prompt {state['prompt_len']}"
                f" + max_new {state['max_new']}, window {self.window})")
        if need > self.allocator.capacity:
            raise InadmissibleRequestError(
                f"request {state['uid']}: handoff needs {need} KV blocks, "
                f"decode pool has {self.allocator.capacity}")
        free = [s for s in self.slots if s.state == _FREE]
        if not free:
            return False
        blocks = self.allocator.alloc(need)
        if blocks is None:
            return False
        n_src = len(state["blocks"])
        try:
            self.pool = transplant_blocks(src_pool, state["blocks"],
                                          self.pool, blocks[:n_src],
                                          pad_to=self.nb)
        except Exception:
            self.allocator.free(blocks)    # don't leak the reservation
            raise
        slot = free[-1]
        slot.state = _DECODE
        slot.uid = state["uid"]
        slot.prompt = state["prompt"]
        slot.prompt_len = state["prompt_len"]
        slot.padded_len = state["padded_len"]
        slot.max_new = state["max_new"]
        slot.eos = state["eos"]
        slot.blocks = blocks
        slot.cursor = state["padded_len"]
        slot.pos = state["pos"]
        slot.emitted = list(state["emitted"])
        slot.hashes = None          # adopted blocks stay private: this pool
        slot.reg = 0                # never registers them (the prefill
        slot.cached = state["cached"]  # replica's cache owns the prefix)
        # the prefill replica's stamps: TTFT / TPOT measure from the real
        # first token, not from adoption
        slot.t_arrive = state["t_arrive"]
        slot.t_admit = state.get("t_admit")
        slot.t_first = state.get("t_first")
        slot.t_prev = slot.t_first
        slot.trace = state.get("trace")    # decode spans continue the trace
        self.tables[slot.idx, :] = TRASH_BLOCK
        self.tables[slot.idx, :len(blocks)] = blocks
        self.handoffs_in += 1
        return True

    def release_handoff(self, uid):
        """Free the source side of a completed transplant: decref the
        slot's blocks (registered prefix blocks park reclaimable and stay
        matchable for affinity) and recycle the slot."""
        slot = self._handoff_slot(uid)
        self.allocator.free(slot.blocks[::-1])
        self.tables[slot.idx, :] = TRASH_BLOCK
        slot.reset()
        self.handoffs_out += 1

    def _handoff_slot(self, uid) -> _Slot:
        for s in self.slots:
            if s.state == _HANDOFF and s.uid == uid:
                return s
        raise KeyError(f"no handoff-ready slot for request {uid!r}")

    # ------------------------------------------------------------------
    # speculative decoding: draft -> one verify -> accept and rewind
    # ------------------------------------------------------------------

    def _verify_decode(self, dec, tok, pos, tables, finished):
        """Draft + verify in place of the decode step: each slot emits its
        longest agreeing prefix plus the bonus token from the first
        disagreeing row — 1..k+1 tokens a model step. The cursor moves
        past the emitted tokens only; the rejected drafts' k/v lies past it
        and is overwritten by the next verify, never read."""
        tr_on = self.tracer.enabled
        with self.telemetry.span("serving/draft", tid=self.trace_tid):
            drafts, dlens = self.drafter.propose(dec, tok, pos, tables)
        if self.pressure is not None and self.pressure.draft_cap is not None:
            # ladder rung 1: cap the ACCEPTED draft length only; the verify
            # keeps its [S, k+1] shape and the capped drafts score as
            # padding past the cursor
            dlens = np.minimum(dlens, self.pressure.draft_cap)
        toks = np.concatenate([tok[:, None], drafts], axis=1)
        t0 = self._clock() if tr_on else 0.0
        with self.telemetry.span("serving/verify", tid=self.trace_tid):
            tgt = self._verify_step(toks, pos, tables)      # [S, k+1]
        t1 = self._clock() if tr_on else 0.0
        self.verify_calls += 1
        self.decode_steps += 1
        for s in dec:
            dlen = int(dlens[s.idx])
            ctx, uid = s.trace, s.uid         # _retire resets the slot
            n, emitted = accept_greedy(drafts[s.idx], tgt[s.idx], dlen)
            s.pos += n + 1
            self.verify_slot_steps += 1
            self.drafted_tokens += dlen
            self.accepted_tokens += n
            if self.telemetry.enabled:
                if dlen:
                    self.telemetry.observe("serving/spec_accept_rate",
                                           n / dlen)
                self.telemetry.inc("serving/spec_accepted_tokens", n)
                self.telemetry.inc("serving/spec_drafted_tokens", dlen)
            anchor, j = s.t_prev, 0
            for t in emitted:
                # an EOS inside the accepted drafts retires the slot here;
                # the rest of the burst is discarded like a window's tail
                self._emit(s, t, finished)
                j += 1
                if s.state == _FREE:
                    break
            self.spec_emitted_tokens += j
            self._observe_tpot(s, anchor, j)
            if tr_on and ctx is not None:
                self.tracer.record(ctx, "verify", t0, t1 - t0,
                                   tid=self.trace_tid,
                                   attrs={"drafted": dlen, "accepted": n,
                                          "emitted": j})
            if self.flightrec.enabled and n < dlen:
                # the cursor rewound past dlen - n rejected drafts
                self.flightrec.record("rollback", uid=uid,
                                      rejected=dlen - n, accepted=n)
        self.telemetry.inc("serving/spec_verify_steps")

    # ------------------------------------------------------------------
    # the engine step: admit -> prefill chunk(s) -> decode all slots
    # ------------------------------------------------------------------

    def step(self) -> List[CompletedRequest]:
        """One scheduler iteration. Returns the requests that finished.

        The try/except is the OOM-forensics boundary: an allocator failure
        escaping the step dumps the memory ledger, the planner delta and
        the flight-recorder ring (memscope on) before it re-raises."""
        ms = self.memscope
        if ms is None:
            return self._step_impl()
        try:
            ms.begin_step()
            out = self._step_impl()
            ms.end_step()
            return out
        except Exception as e:
            ms.on_step_error(e)
            raise

    @torch.inference_mode()
    def _step_impl(self) -> List[CompletedRequest]:
        finished: List[CompletedRequest] = []
        self.steps += 1
        with self.telemetry.span("serving/admit", tid=self.trace_tid):
            self._admit(finished)

        # chunked prefill, bounded per step so arriving prompts cannot stall
        # the running batch for more than prefill_budget chunk-times
        budget = self.prefill_budget
        for slot in self.slots:
            if budget <= 0:
                break
            while slot.state == _PREFILL and budget > 0:
                start = slot.cursor
                chunk = np.zeros((1, self.chunk), np.int32)
                seg = slot.prompt[start:start + self.chunk]
                chunk[0, :len(seg)] = seg
                final = start + self.chunk >= slot.padded_len
                last = (slot.prompt_len - 1 - start) if final \
                    else self.chunk - 1
                tr_on = self.tracer.enabled and slot.trace is not None
                t0 = self._clock() if tr_on else 0.0
                with self.telemetry.span("serving/prefill_chunk",
                                         tid=self.trace_tid):
                    tok = self._prefill_step(chunk, start, last,
                                             self.tables[slot.idx][None])
                if tr_on:
                    t1 = self._clock()
                    self.tracer.record(slot.trace, "prefill_chunk", t0,
                                       t1 - t0, tid=self.trace_tid,
                                       attrs={"start": start,
                                              "chunk": self.chunk})
                if self.drafter is not None:
                    # a stateful drafter shadows the chunk into its own pool
                    # through the same table
                    self.drafter.prefill_chunk(
                        slot, chunk, np.asarray([start]),
                        np.asarray([last]), self.tables[slot.idx][None])
                slot.cursor = start + self.chunk
                budget -= 1
                self.prefill_chunks += 1
                if self.prefix_cache is not None and slot.hashes:
                    # register the full blocks below prompt_len the cursor
                    # has passed — only now does their content exist, and
                    # the padded tail and decode-written blocks stay
                    # private, so shared blocks are never written again
                    hi = min(slot.cursor, slot.prompt_len) // self.block_size
                    for i in range(slot.reg, hi):
                        self.prefix_cache.register(slot.hashes[i],
                                                   slot.blocks[i])
                    slot.reg = max(slot.reg, hi)
                if final:
                    # a prefill-only slot parks for handoff instead of
                    # decoding (_emit may still retire it on an EOS or
                    # max_new 1: a normal completion from this engine)
                    slot.state = _HANDOFF if slot.prefill_only else _DECODE
                    # the first token's read: TTFT is stamped after it
                    self._emit(slot, int(tok[0]), finished)

        # decode: ONE call shape for every slot; non-decoding slots ride
        # along against the trash block. A slot finishing mid-window
        # discards the window's tail (written to its own blocks, which
        # blocks_needed sized for).
        dec = [s for s in self.slots if s.state == _DECODE]
        if dec:
            self.peak_active = max(self.peak_active, len(dec))
            tok = np.zeros((self.max_slots,), np.int32)
            pos = np.zeros((self.max_slots,), np.int32)
            tables = np.full_like(self.tables, TRASH_BLOCK)
            for s in dec:
                tok[s.idx] = s.emitted[-1]
                pos[s.idx] = s.pos
                tables[s.idx] = self.tables[s.idx]
            spec_active = self.spec_on and not (
                self.pressure is not None and self.pressure.spec_disabled)
            if spec_active:
                self._verify_decode(dec, tok, pos, tables, finished)
            else:
                # the degraded paths run the 1-step decode: spec-disabled
                # blocks were sized for the draft overhang, not a window
                # tail, and the ladder's window rung wants finer turnover
                win = 1 if self.spec_on or (
                    self.pressure is not None
                    and self.pressure.force_window_1) else self.window
                tr_on = self.tracer.enabled
                t0 = self._clock() if tr_on else 0.0
                with self.telemetry.span("serving/decode_window",
                                         tid=self.trace_tid):
                    # returns on the host: the window's one device read
                    nxt = self._decode_step(tok, pos, tables, win)
                t1 = self._clock() if tr_on else 0.0
                self.decode_steps += 1
                for s in dec:
                    s.pos += win
                    ctx = s.trace             # _retire resets the slot
                    anchor, j = s.t_prev, 0
                    for t in nxt[s.idx]:
                        self._emit(s, int(t), finished)
                        j += 1
                        if s.state == _FREE:            # retired mid-window
                            break
                    self._observe_tpot(s, anchor, j)
                    if tr_on and ctx is not None:
                        self.tracer.record(ctx, "decode_window", t0, t1 - t0,
                                           tid=self.trace_tid,
                                           attrs={"emitted": j})

        # sync-point housekeeping on host state: hard deadlines, the
        # ladder, then the scheduled audit
        self._sweep_deadlines(finished)
        if self.pressure is not None:
            self.pressure.update(finished)
        if self.audit_interval and self.steps % self.audit_interval == 0:
            self._scheduled_audit()

        if self.telemetry.enabled:
            self.telemetry.set_gauge("serving/queue_depth", len(self.queue))
            self.telemetry.set_gauge("serving/active_slots", self.num_active)
            self.telemetry.set_gauge("serving/free_blocks",
                                     self.allocator.available)
            if self.memscope is not None:
                self.memscope.publish()     # the mem/* ledger gauges
            self.telemetry.maybe_export(self.steps)
        return finished

    @property
    def num_active(self):
        return sum(1 for s in self.slots if s.state != _FREE)

    def run(self, requests: Sequence[Request]) -> Dict[Any, CompletedRequest]:
        """Submit a batch of requests and drain the engine."""
        for r in requests:
            self.submit(r)
        out: Dict[Any, CompletedRequest] = {}
        while self.queue or self.num_active:
            before = (self.prefill_chunks, self.decode_steps, len(self.queue))
            for done in self.step():
                out[done.uid] = done
            if (self.prefill_chunks, self.decode_steps,
                    len(self.queue)) == before:
                raise RuntimeError(
                    f"serving scheduler made no progress: queue="
                    f"{len(self.queue)} active={self.num_active} "
                    f"free_blocks={self.allocator.num_free}")
        # drained: flush the tail of the trace into the exporters (a run
        # shorter than export_interval would otherwise leave no files)
        if self.telemetry.enabled:
            self.telemetry.export(self.steps)
        return out

    def close(self):
        """Engine shutdown: one final audit, then the telemetry's final
        export with its files closed. Returns the final `AuditReport`."""
        report = self.audit(repair=(self.audit_action == "repair"))
        self.telemetry.close()
        return report

    def compile_stats(self) -> Dict[str, int]:
        """The reference counts compiled step programs here; the port
        compiles none (its steps are eager torch over ctypes kernels), so
        the map is empty."""
        return {}

    def stats(self) -> Dict[str, Any]:
        out = {"steps": self.steps, "decode_steps": self.decode_steps,
               "prefill_chunks": self.prefill_chunks,
               "tokens_generated": self.tokens_generated,
               "peak_active": self.peak_active,
               "cancelled": self.cancelled,
               "deadline_cancelled": self.deadline_cancelled,
               "handoffs_in": self.handoffs_in,
               "handoffs_out": self.handoffs_out,
               "queued": len(self.queue), "active": self.num_active,
               "free_blocks": self.allocator.num_free,
               "reclaimable_blocks": self.allocator.num_reclaimable,
               "available_blocks": self.allocator.available,
               "compiles": self.compile_stats()}
        if self.spec_on:
            out["spec_decode"] = {
                "drafter": self.drafter.name,
                "draft_k": self.draft_k,
                "verify_steps": self.verify_calls,
                "drafted_tokens": self.drafted_tokens,
                "accepted_tokens": self.accepted_tokens,
                "emitted_tokens": self.spec_emitted_tokens,
                # the drafter's hit rate, and tokens a sequence a model
                # step (1.0: spec decode bought nothing; k+1 the ceiling)
                "acceptance_rate": (self.accepted_tokens /
                                    max(1, self.drafted_tokens)),
                "accepted_tokens_per_step": (self.spec_emitted_tokens /
                                             max(1, self.verify_slot_steps))}
        if self.kv_quant or self.weight_quant != "off":
            q = {"kv_cache_dtype": self.kv_cache_dtype,
                 "weights": self.weight_quant}
            if self.kv_quant:
                g = self.pool["k_scale"].shape[-1]
                q["kv_group_size"] = int(self.pool["k"].shape[-1] // g)
            if self.weight_quant_stats is not None:
                # bytes before / after (payload + scales) over the whole tree
                q["weight_quant"] = dict(self.weight_quant_stats)
            out["quantization"] = q
        if self.audits_run:
            out["audit"] = {"runs": self.audits_run,
                            "violations": self.audit_violations_total,
                            "repairs": self.audit_repairs}
        if self.pressure is not None:
            out["degradation"] = self.pressure.stats()
        if self.prefix_cache is not None:
            out["prefix_cache"] = {
                "hit_blocks": self.prefix_hit_blocks,
                "hit_tokens": self.prefix_hit_tokens,
                "prefill_chunks_skipped": self.prefill_chunks_skipped,
                "cached_blocks": self.prefix_cache.num_cached,
                "evictions": self.allocator.evictions}
        if self.streamed:
            # the staging pool's overlap counters, with telemetry off too
            from deepspeed_tpu_torch.inference.zero_inference import \
                tree_bytes
            eng = self.engine
            out["offload"] = {
                "staging": eng.streamer.stats(),
                "layer_bytes": eng.store.layer_bytes,
                "host_param_bytes": eng.store.host_bytes,
                "staged_peak_bytes": eng.peak_param_hbm_bytes,
                "resident_param_bytes": tree_bytes(eng.params)}
        if self.memscope is not None:
            out["memory"] = self.memscope.snapshot()
        if self.telemetry.enabled:
            out["latency"] = self.latency_snapshot()
        return out

    def latency_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-request latency histogram snapshots (ttft_ms / tpot_ms /
        queue_wait_ms / e2e_ms -> count/mean/p50/p90/p99/min/max). Empty
        when telemetry is disabled."""
        if not self.telemetry.enabled:
            return {}
        snap = self.telemetry.registry.snapshot()
        return {name.split("/", 1)[1]: m for name, m in snap.items()
                if m.get("type") == "histogram" and name.startswith("serving/")}

    def write_monitor_events(self, monitor):
        """Serving cache and pool readings through the experiment monitor
        (best effort): Serving/prefix_hit_tokens, Serving/prefix_evictions
        and Serving/pool_free_blocks, stepped by the scheduler iteration."""
        from deepspeed_tpu_torch.monitor.monitor import write_serving_events
        write_serving_events(monitor, [
            ("Serving/prefix_hit_tokens", self.prefix_hit_tokens, self.steps),
            ("Serving/prefix_evictions", self.allocator.evictions,
             self.steps),
            ("Serving/pool_free_blocks", self.allocator.available,
             self.steps),
        ])
