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

Prefix caching, speculative decoding, disaggregated handoff, auditing,
degradation and request tracing are later slices of the port.
"""

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.kv_cache import (BlockAllocator,
                                                    TRASH_BLOCK,
                                                    blocks_needed,
                                                    max_written_pos)
from deepspeed_tpu_torch.models.gpt import as_dtype
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.utils.logging import log_dist


class InadmissibleRequestError(ValueError):
    """The request can NEVER be admitted by this engine — prompt plus budget
    exceed `max_context`, or it needs more KV blocks than the whole pool
    holds. Raised at submit() so an impossible request fails fast instead of
    wedging the FIFO head forever."""


@dataclasses.dataclass
class Request:
    """One generation request. `eos_token_id=None` falls back to the engine
    / model default; `stop_on_eos=False` disables early stop."""
    uid: Any
    tokens: Sequence[int]
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    stop_on_eos: bool = True


@dataclasses.dataclass
class CompletedRequest:
    uid: Any
    prompt_len: int
    tokens: np.ndarray        # generated tokens; the EOS (if emitted) is kept
    finish_reason: str        # "eos" | "length" | "cancelled"
    timing: Optional[Dict[str, float]] = None  # telemetry only: monotonic
                              # arrival/admit/first_token/finish stamps
                              # (None when telemetry is disabled)


_FREE, _PREFILL, _DECODE = 0, 1, 2


class _Slot:
    __slots__ = ("idx", "state", "uid", "prompt", "prompt_len", "padded_len",
                 "max_new", "eos", "blocks", "cursor", "pos", "emitted",
                 "t_arrive", "t_admit", "t_first", "t_prev")

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
        self.t_arrive = self.t_admit = self.t_first = None  # telemetry stamps
        self.t_prev = None      # last emission sync (TPOT interpolation anchor)


class ServingEngine:
    """Continuous-batching server on top of an `InferenceEngine` whose model
    spec carries the paged contract.

    Usage::

        serving = engine.serving(max_slots=8, max_context=2048)
        results = serving.run([Request(uid=0, tokens=prompt)])

    `clock` (default `time.monotonic`) stamps request timing; tests inject
    one to pin TTFT / TPOT.
    """

    def __init__(self, engine, clock=None, **overrides):
        spec = engine.model_spec
        missing = [n for n in ("prefill_paged_fn", "decode_paged_fn",
                               "init_paged_pool")
                   if getattr(spec, n, None) is None]
        if missing:
            raise ValueError(
                f"model spec '{spec.name}' has no paged serving contract "
                f"(missing {missing}); build it with make_gpt_decode_model or "
                f"serve through generate()")
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
        num_blocks = int(scfg.num_kv_blocks or (self.max_slots * self.nb + 1))

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
        self.allocator = BlockAllocator(num_blocks)
        self.tables = np.full((self.max_slots, self.nb), TRASH_BLOCK, np.int32)
        self.slots = [_Slot(i) for i in range(self.max_slots)]
        self.queue = collections.deque()
        self._generator = None if self.config.greedy \
            else engine.make_generator(0)

        self.steps = 0
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.tokens_generated = 0
        self.peak_active = 0
        self.cancelled = 0

        # telemetry: TTFT/TPOT/queue-wait/e2e histograms + queue/slot/pool
        # gauges + per-phase spans. Disabled by default — then every record
        # site below is a single attribute check and nothing is written
        self.telemetry = Telemetry(getattr(self.config, "telemetry", None),
                                   subsystem="serving")
        self._clock = clock if clock is not None else time.monotonic

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

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(a, dtype=dtype, device=self.engine.device)

    def _prefill_step(self, chunk, start, last, table):
        """One [1, chunk] prompt slice; returns the token sampled from the
        logits at `last` (meaningful on the prompt's final chunk only)."""
        logits, self.pool = self.engine.model_spec.prefill_paged_fn(
            self.engine.params, self._tensor(chunk, torch.long),
            self._tensor([start], torch.long), self._tensor([last], torch.long),
            self.pool, self._tensor(table))
        return self.engine._sample(logits, self._generator)

    def _decode_step(self, tok, pos, tables, window):
        """`window` tokens for every slot: returns [S, window] successors of
        `tok`, writing each input token's k/v along the way."""
        spec, params = self.engine.model_spec, self.engine.params
        tok = self._tensor(tok)
        pos = self._tensor(pos, torch.long)
        tables = self._tensor(tables)
        out = []
        for _ in range(window):
            logits, self.pool = spec.decode_paged_fn(params, tok, pos,
                                                     self.pool, tables)
            tok = self.engine._sample(logits, self._generator)
            out.append(tok)
            pos = pos + 1
        return torch.stack(out, dim=1).cpu().numpy()

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------

    def set_clock(self, clock):
        """Replace the clock that stamps request timing."""
        self._clock = clock

    def check_admissible(self, prompt_len: int, max_new: int,
                         uid: Any = "?") -> int:
        """Raise `InadmissibleRequestError` when the request can NEVER fit
        this engine (max_context, whole-pool block budget), else return the
        blocks it will occupy."""
        prompt_len, max_new = int(prompt_len), int(max_new)
        padded = -(-prompt_len // self.chunk) * self.chunk
        if prompt_len < 1:
            raise InadmissibleRequestError(f"request {uid}: empty prompt")
        if max_new < 1:
            raise InadmissibleRequestError(
                f"request {uid}: max_new_tokens < 1")
        if max_written_pos(prompt_len, padded, max_new,
                           self.window) >= self.max_context:
            raise InadmissibleRequestError(
                f"request {uid}: prompt {prompt_len} + max_new {max_new} "
                f"(window {self.window}) exceeds max_context "
                f"{self.max_context} (raise serving.max_context)")
        need = blocks_needed(prompt_len, padded, max_new, self.block_size,
                             window=self.window)
        if need > self.allocator.capacity:
            raise InadmissibleRequestError(
                f"request {uid}: needs {need} KV blocks, pool has "
                f"{self.allocator.capacity} (raise serving.num_kv_blocks)")
        return need

    def submit(self, request: Request):
        """Queue a request. Raises `InadmissibleRequestError` if it can
        never be admitted; one that merely doesn't fit *right now* waits
        in the queue (admission backpressure)."""
        prompt = np.asarray(request.tokens, np.int32).reshape(-1)
        prompt_len = int(prompt.shape[0])
        need = self.check_admissible(prompt_len, request.max_new_tokens,
                                     uid=request.uid)
        padded = -(-prompt_len // self.chunk) * self.chunk
        t_arrive = self._clock() if self.telemetry.enabled else None
        self.queue.append((request, prompt, prompt_len, padded, need,
                           t_arrive))

    def _resolve_eos(self, req: Request):
        if not req.stop_on_eos:
            return None
        eos = req.eos_token_id
        if eos is None:
            eos = self.config.eos_token_id
        if eos is None:
            eos = self.engine.model_spec.eos_token_id
        return eos

    def _admit(self):
        free = [s for s in self.slots if s.state == _FREE]
        while self.queue and free:
            req, prompt, prompt_len, padded, need, t_arrive = self.queue[0]
            blocks = self.allocator.alloc(need)
            if blocks is None:
                # pool exhausted: FIFO backpressure — the head waits for
                # retirements (no reordering: small requests must not
                # starve a big one)
                break
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
            slot.cursor = 0
            slot.pos = prompt_len
            slot.emitted = []
            slot.t_arrive = t_arrive
            if self.telemetry.enabled:
                slot.t_admit = self._clock()
                self.telemetry.observe("serving/queue_wait_ms",
                                       (slot.t_admit - t_arrive) * 1e3)
            self.tables[slot.idx, :] = TRASH_BLOCK
            self.tables[slot.idx, :len(blocks)] = blocks

    def _retire(self, slot: _Slot, reason: str) -> CompletedRequest:
        # blocks return to the pool the step the sequence finishes
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
        done = CompletedRequest(uid=slot.uid, prompt_len=slot.prompt_len,
                                tokens=np.asarray(slot.emitted, np.int32),
                                finish_reason=reason, timing=timing)
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

    def cancel(self, uid) -> Optional[CompletedRequest]:
        """Withdraw a request wherever it lives: a queued one never touches
        a slot, an active one retires now (blocks freed the same call).
        Returns its CompletedRequest (reason "cancelled", tokens so far),
        or None for an unknown uid."""
        for i, rec in enumerate(self.queue):
            if rec[0].uid == uid:
                del self.queue[i]
                self.cancelled += 1
                return CompletedRequest(uid=uid, prompt_len=rec[2],
                                        tokens=np.zeros((0,), np.int32),
                                        finish_reason="cancelled")
        for slot in self.slots:
            if slot.state != _FREE and slot.uid == uid:
                self.cancelled += 1
                return self._retire(slot, "cancelled")
        return None

    # ------------------------------------------------------------------
    # the engine step: admit -> prefill chunk(s) -> decode all slots
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def step(self) -> List[CompletedRequest]:
        """One scheduler iteration. Returns the requests that finished."""
        finished: List[CompletedRequest] = []
        self.steps += 1
        with self.telemetry.span("serving/admit"):
            self._admit()

        # chunked prefill, bounded per step so arriving prompts cannot stall
        # the running batch for more than prefill_budget chunk-times
        budget = self.prefill_budget
        for slot in self.slots:
            while slot.state == _PREFILL and budget > 0:
                start = slot.cursor
                chunk = np.zeros((1, self.chunk), np.int32)
                seg = slot.prompt[start:start + self.chunk]
                chunk[0, :len(seg)] = seg
                final = start + self.chunk >= slot.padded_len
                last = (slot.prompt_len - 1 - start) if final \
                    else self.chunk - 1
                with self.telemetry.span("serving/prefill_chunk"):
                    tok = self._prefill_step(chunk, start, last,
                                             self.tables[slot.idx][None])
                slot.cursor = start + self.chunk
                budget -= 1
                self.prefill_chunks += 1
                if final:
                    slot.state = _DECODE
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
            with self.telemetry.span("serving/decode_window"):
                # returns on the host: the window's one device read
                nxt = self._decode_step(tok, pos, tables, self.window)
            self.decode_steps += 1
            for s in dec:
                s.pos += self.window
                anchor, j = s.t_prev, 0
                for t in nxt[s.idx]:
                    self._emit(s, int(t), finished)
                    j += 1
                    if s.state == _FREE:            # retired mid-window
                        break
                self._observe_tpot(s, anchor, j)

        if self.telemetry.enabled:
            self.telemetry.set_gauge("serving/queue_depth", len(self.queue))
            self.telemetry.set_gauge("serving/active_slots", self.num_active)
            self.telemetry.set_gauge("serving/free_blocks",
                                     self.allocator.num_free)
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
        """Engine shutdown: the telemetry's final export, and its files
        closed."""
        self.telemetry.close()

    def stats(self) -> Dict[str, Any]:
        out = {"steps": self.steps, "decode_steps": self.decode_steps,
               "prefill_chunks": self.prefill_chunks,
               "tokens_generated": self.tokens_generated,
               "peak_active": self.peak_active,
               "cancelled": self.cancelled,
               "queued": len(self.queue), "active": self.num_active,
               "free_blocks": self.allocator.num_free}
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
