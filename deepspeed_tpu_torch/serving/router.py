"""ServingRouter: prefix-affinity routing, backpressure admission, failover
(counterpart of `deepspeed_tpu/serving/router.py`: the same decisions, in
the same order of clock reads, so counters and simulated times match).

One `ServingEngine` is iteration-level scheduling on one device; this
router is the layer above — it owns N engine replicas behind `ReplicaHandle`
and decides, per request, WHERE to run it:

  * **affinity** — the prefix cache made KV blocks content-addressed
    (chained block hashes seeded with the model's `cache_fingerprint`).
    That chain is exactly a routing key: hash the prompt once, probe each
    replica's cache read-only (`PrefixCache.match_len`), and prefer the
    replica that already HOLDS the longest registered prefix — a shared
    system prompt then prefills once per POOL, not once per replica;
  * **load** — queue depth, active slots and free+reclaimable blocks (the
    same quantities the serving gauges export) push back: a saturated replica
    loses to a cold one even against affinity (a counted "load spill");
  * **health** — a replica whose step() throws (or that an operator kills)
    is quarantined: its queued-but-unstarted requests are extracted and
    its in-flight ones re-submitted from scratch elsewhere (greedy decoding
    makes the rerun token-identical), and restarts are paced by the shared
    `elasticity/restart_policy.py` budget.

Admission is backpressure-aware end to end: the router's own queue is
BOUNDED (`max_pending`) with a shed-or-block policy, each request may carry
a TTL that cancels it if still queued past deadline (built on
`ServingEngine.cancel`), and dispatch into a replica defers while that
replica's queue is deep — the request waits at the router where TTL and
failover can still reach it cheaply.

Disaggregated prefill/decode rides the same pool: replicas tagged
`role="prefill"` run chunked prefill only; when a slot's prefill finishes,
the router transplants its KV blocks into a `role="decode"`/`"mixed"`
replica (`kv_cache.transplant_blocks` — a block-indexed gather) and decode
continues there, so a long arriving prompt never stalls decode TPOT.

Scoring formula (policy "affinity"):

    score(r) = affinity_blocks(r) * affinity_weight
               - (queue_depth(r) + active_slots(r)) * load_penalty
               - block_penalty * [blocks_needed > available_blocks(r)]

highest score wins; ties break toward the replica with the least pending
work, then rotation order. `affinity_hits` counts dispatches whose winner
held a non-zero prefix; `load_spills` counts dispatches where some OTHER
replica held a strictly longer prefix but lost on load/saturation.

Self-healing extends health beyond "step() threw":

  * **hung-replica watchdog** — each replica's step() is timed against
    `step_deadline_ms` on the router's (injectable) clock; a replica over
    the deadline `step_strike_budget` times IN A ROW is health-probed and,
    if the probe fails, quarantined through the exact failover path an
    exception takes — hangs and crashes converge on one recovery flow;
  * **hard deadlines** — `Request.deadline_ms` anchors an ABSOLUTE
    deadline at router submit that survives every re-dispatch (failover
    rerun, hedge duplicate): the engine enforces it past admission at
    every scheduler sync (`finish_reason="deadline"`), and the router
    expires requests still in its own queue;
  * **hedged dispatch** — a dispatched request with no first token after
    `hedge_after_ms` gets a speculative duplicate on another replica with
    capacity; first completion wins, the loser is cancelled, completion
    de-dup rides the same `_done` bookkeeping failover re-routes use;
  * **one clock** — the router's clock is injected into every replica
    (`set_clock`, re-applied after restarts), so TTL, TTFT/TPOT stamps,
    deadlines, the watchdog, and hedging share one deterministic time
    source under test.

The pool's `mem/*` gauges aggregate the replicas' `memory_snapshot()`s
(their memscope ledgers, `telemetry.memscope`); a replica without one
answers None, and with none at all the gauges stay unset.
"""

import collections
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.elasticity.restart_policy import (RestartBudget,
                                                           RestartPolicy)
from deepspeed_tpu_torch.inference.scheduler import (CompletedRequest,
                                                     InadmissibleRequestError,
                                                     Request, ServingEngine)
from deepspeed_tpu_torch.serving.replica import (InProcessReplica,
                                                 ReplicaHandle,
                                                 ReplicaUnavailableError)
from deepspeed_tpu_torch.telemetry import Telemetry, TraceContext, merge_snapshots
from deepspeed_tpu_torch.utils.logging import log_dist, logger


@dataclasses.dataclass
class RouterConfig:
    """Router policy knobs (replica-pool shape lives on the replicas)."""
    max_pending: int = 256        # bounded ROUTER queue (dispatched requests
                                  # don't count — each replica's own FIFO
                                  # carries those)
    admission_policy: str = "block"  # queue full: "block" drives the pool
                                  # until room frees; "shed" completes the
                                  # newcomer immediately with reason
                                  # "cancelled" (counted as `shed`)
    default_ttl_s: Optional[float] = None  # per-request deadline while
                                  # QUEUED (router queue or replica queue);
                                  # never kills a generating request
    routing_policy: str = "affinity"  # "affinity" (scored) | "round_robin"
    affinity_weight: float = 4.0  # score per matched prefix BLOCK
    load_penalty: float = 1.0     # score per queued/active request
    block_penalty: float = 8.0    # flat penalty when the replica cannot
                                  # allocate the request's blocks right now
    max_replica_queue: int = 8    # dispatch defers while the target's queue
                                  # is this deep (router-side backpressure)
    max_replica_restarts: int = 1  # per-replica quarantine restart budget
    restart_backoff_s: float = 0.0  # base backoff before a replica restart
    restart_backoff_factor: float = 2.0
    restart_max_backoff_s: float = 60.0
    step_deadline_ms: Optional[float] = None  # hung-replica watchdog: a
                                  # replica step() over this budget (router
                                  # clock) is a STRIKE; None disables the
                                  # watchdog entirely
    step_strike_budget: int = 3   # consecutive strikes before the health
                                  # probe; probe False => quarantine (slow-
                                  # but-alive resets the strike count)
    hedge_after_ms: Optional[float] = None  # dispatched request with no
                                  # first token after this long gets a
                                  # speculative duplicate on another
                                  # replica with capacity (first completion
                                  # wins, loser cancelled); None disables.
                                  # MIXED pools only — a disaggregated
                                  # pool ignores it (one handoff home per
                                  # uid; see _maybe_hedge)


class ReplicaHungError(RuntimeError):
    """The watchdog gave up on a replica: `step_strike_budget` consecutive
    over-deadline steps AND a failed health probe. Used as the quarantine
    reason so hangs ride the same failover path exceptions take."""


@dataclasses.dataclass
class _Pending:
    """Router-side record of one live (incomplete) request."""
    request: Request
    prompt_len: int
    hashes: Optional[List[bytes]]
    t_submit: float
    deadline: Optional[float]       # TTL: queued-only cancellation
    replica: Optional[str] = None   # None while queued at the router
    trace: Any = None               # TraceContext; the router owns the root
                                    # span and closes it at completion
    deadline_at: Optional[float] = None  # HARD deadline (absolute, router
                                    # clock): anchored once at submit and
                                    # passed through every re-dispatch, so
                                    # failover/hedging never extend it
    t_dispatch: Optional[float] = None   # last dispatch time (hedge timer)
    hedge_replica: Optional[str] = None  # speculative duplicate's replica


class ServingRouter:
    """A pool of serving-engine replicas behind one submit/step/run front.

    Build it from live engines (each wrapped into an `InProcessReplica`),
    handles, or factories::

        router = ServingRouter(replicas=[engine.serving(), engine.serving()],
                               default_ttl_s=30)   # RouterConfig kwargs
        router.submit(Request(uid=0, tokens=prompt, max_new_tokens=64))
        while router.in_flight:
            for done in router.step():
                ...
        # or batch-style: results = router.run(requests)  # {uid: Completed}

    Replicas must serve the SAME model (enforced via `cache_fingerprint`
    when prefix caching is on — affinity across different models would
    transplant wrong KV) and share `kv_block_size` when disaggregated.
    """

    def __init__(self, replicas: Sequence = (), config: RouterConfig = None,
                 telemetry_config=None, clock: Callable[[], float] = None,
                 **overrides):
        if config is None:
            config = RouterConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        assert config.admission_policy in ("block", "shed"), \
            f"unknown admission_policy {config.admission_policy!r}"
        assert config.routing_policy in ("affinity", "round_robin"), \
            f"unknown routing_policy {config.routing_policy!r}"
        self._clock = clock if clock is not None else time.monotonic
        # an EXPLICITLY injected clock propagates to every replica
        # (set_clock, re-applied after restarts) so the whole pool — TTL,
        # engine TTFT/TPOT stamps, deadlines, watchdog, hedging — reads one
        # time source; without injection both layers already default to
        # time.monotonic, so there is nothing to unify
        self._clock_injected = clock is not None
        self.replicas: Dict[str, ReplicaHandle] = {}
        self._quarantined: Dict[str, float] = {}   # rid -> earliest restart
        self._dead: set = set()                    # budget exhausted
        self._draining: set = set()                # graceful scale-down: no
                                                   # new admission, active
                                                   # slots run to completion
        self._budgets: Dict[str, RestartBudget] = {}
        self._restart_policy = RestartPolicy(
            max_restarts=config.max_replica_restarts,
            base_backoff_s=config.restart_backoff_s,
            backoff_factor=config.restart_backoff_factor,
            max_backoff_s=config.restart_max_backoff_s,
            jitter=0.0)

        self.queue = collections.deque()           # uids waiting at the router
        self._pending: Dict[Any, _Pending] = {}    # every incomplete uid
        self._done: set = set()
        self._finished_buf: List[CompletedRequest] = []
        self._rr = 0                               # rotation cursor
        # anticipated affinity: hash chains DISPATCHED to a replica, before
        # its prefill has registered the blocks. Without this, a whole wave
        # of shared-prefix requests arriving in one step would scatter (no
        # replica holds the prefix *yet*), and every replica would prefill
        # the prefix once. Bounded LRU per replica; a stale entry (evicted
        # at the replica) only costs a suboptimal route, never correctness.
        self._anticipated: Dict[str, collections.OrderedDict] = {}
        self._anticipated_cap = 4096
        self.steps = 0
        self.counters = {k: 0 for k in (
            "submitted", "completed", "affinity_hits", "load_spills",
            "reroutes", "ttl_cancelled", "shed", "replica_failures",
            "replica_restarts", "handoffs", "watchdog_strikes",
            "watchdog_quarantines", "hedges", "hedge_wins",
            "deadline_cancelled", "drains", "removed")}
        self._strikes: Dict[str, int] = {}  # consecutive over-deadline steps
        self._hedged: set = set()           # uids ever hedge-dispatched (the
                                            # expected-duplicate allowlist)
        # rid -> router-level TTFT ms, a bounded sliding window (the full
        # distribution lives in the telemetry histogram; this stays O(1))
        self._ttft: Dict[str, collections.deque] = {}
        self._ttft_window = 2048

        self.telemetry = Telemetry(telemetry_config, subsystem="router")
        # POOL-shared request tracing + flight recorder (telemetry.tracing /
        # telemetry.flight_recorder flags): the router owns both and injects
        # them into every replica, so a request that crosses replicas —
        # dispatch, failover re-route, KV handoff — still lands every span
        # in ONE file under ONE trace id, with one Perfetto track per
        # replica (tid 0 = the router itself).
        self.tracer = self.telemetry.tracer
        self.flightrec = self.telemetry.flightrec
        self._tids: Dict[str, int] = {}
        if self.tracer.enabled:
            self.tracer.name_process("dstpu serving pool")
            self.tracer.name_track(0, "router")
        # the pod observability plane (pull side): per-replica spool
        # cursors (advanced only after a successful ingest, so a retried
        # pull can never double-count), the latest registry snapshot per
        # replica (REPLACED on every pull, never accumulated — same
        # reason), remote->local span-id remaps for re-parenting, and the
        # wire facts (spool path, pid) the post-mortem drain needs once
        # the process is gone
        self._obs_cursors: Dict[str, int] = {}
        self._obs_metrics: Dict[str, Dict[str, Any]] = {}
        self._obs_remap: Dict[str, Dict[int, int]] = {}
        self._obs_info: Dict[str, Dict[str, Any]] = {}
        # uid -> TraceContext, kept PAST completion (bounded LRU): remote
        # spans arrive on the pull cadence, possibly after _complete
        # already closed the root — re-parenting must still find the
        # router's trace id for them
        self._trace_index: collections.OrderedDict = collections.OrderedDict()
        self._trace_index_cap = 4096

        for r in replicas:
            self.add_replica(r)

    # ------------------------------------------------------------------
    # pool assembly
    # ------------------------------------------------------------------

    def add_replica(self, replica, role: str = None,
                    replica_id: str = None, factory=None) -> ReplicaHandle:
        """Add a replica: a `ReplicaHandle`, a live `ServingEngine` (wrapped
        into an `InProcessReplica`), or a zero-arg factory returning one.
        `factory` doubles as the restart recipe after a quarantine. `role`
        (default "mixed") overrides an existing handle's role too when
        given explicitly."""
        if isinstance(replica, ReplicaHandle):
            handle = replica
            if replica_id is not None:
                handle.replica_id = str(replica_id)
            if role is not None:
                assert role in ("mixed", "prefill", "decode"), \
                    f"unknown replica role {role!r}"
                handle.role = role
        else:
            rid = replica_id if replica_id is not None \
                else f"r{len(self.replicas)}"
            if isinstance(replica, ServingEngine):
                handle = InProcessReplica(engine=replica, factory=factory,
                                          replica_id=rid,
                                          role=role or "mixed")
            elif callable(replica):
                handle = InProcessReplica(factory=replica, replica_id=rid,
                                          role=role or "mixed")
            else:
                raise TypeError(f"cannot build a replica from {replica!r}")
        rid = handle.replica_id
        if rid in self.replicas:
            raise ValueError(f"duplicate replica id {rid!r}")
        self._check_pool_compat(handle)
        self.replicas[rid] = handle
        self._budgets[rid] = RestartBudget(self._restart_policy)
        self._ttft[rid] = collections.deque(maxlen=self._ttft_window)
        self._anticipated[rid] = collections.OrderedDict()
        self._tids[rid] = len(self.replicas)       # tid 0 is the router's
        self._strikes[rid] = 0
        if self._clock_injected:
            handle.set_clock(self._clock)
        self._attach_observability(rid)
        log_dist(f"serving router: +replica {rid} role={handle.role} "
                 f"(pool: {len(self.replicas)})", ranks=[0])
        return handle

    def _attach_observability(self, rid):
        """Inject the pool's tracer/flight recorder into one replica (also
        re-run after a restart — the rebuilt engine starts detached). An
        in-process replica takes the objects directly; a RemoteReplica
        instead probes its server's spool so the router can pull spans
        home over the wire. Either way the pull cursor resets: a fresh
        engine/process starts a fresh spool cursor space."""
        if not (self.tracer.enabled or self.flightrec.enabled):
            return
        self.replicas[rid].attach_observability(
            tracer=self.tracer if self.tracer.enabled else None,
            flightrec=self.flightrec if self.flightrec.enabled else None,
            tid=self._tids[rid])
        self._obs_cursors[rid] = 0
        self._obs_remap[rid] = {}
        if self.tracer.enabled:
            self.tracer.name_track(self._tids[rid], f"replica {rid}")

    def _check_pool_compat(self, handle):
        """Same model (cache fingerprint) across the pool, same block size
        when blocks can move between pools (disaggregated handoff), same
        serving-effective KV dtype and int8 scale group. Runs at EVERY
        join — router construction AND runtime add (autoscaler scale-up) —
        over `compat_descriptor()`, so in-process and remote replicas gate
        identically: a divergent replica is refused here with a clear
        error, never mid-request at its first transplant. A replica whose
        descriptor is None (unknown backend) is admitted ungated; one that
        cannot answer at all is refused — joining a dead replica is
        always a mistake."""
        try:
            mine = handle.compat_descriptor()
        except ReplicaUnavailableError as e:
            raise ValueError(
                f"replica {handle.replica_id} is unreachable at join time "
                f"({e}); refusing to add it to the pool") from None
        if mine is None or not self.replicas:
            return
        ref = ref_rid = None
        for rid, other in self.replicas.items():
            if rid in self._dead or rid in self._quarantined:
                continue
            try:
                ref = other.compat_descriptor()
            except ReplicaUnavailableError:
                continue
            if ref is not None:
                ref_rid = rid
                break
        if ref is None:
            return
        if mine["fingerprint"] != ref["fingerprint"]:
            raise ValueError(
                f"replica {handle.replica_id} serves a different model "
                f"({mine['fingerprint']!r} vs {ref_rid}'s "
                f"{ref['fingerprint']!r}): affinity routing and KV handoff "
                f"require one model per pool")
        if mine["kv_block_size"] != ref["kv_block_size"]:
            raise ValueError(
                f"replica {handle.replica_id}: kv_block_size "
                f"{mine['kv_block_size']} != pool's {ref['kv_block_size']} "
                f"(blocks must transplant 1:1)")
        # serving-EFFECTIVE pool dtype (ServingConfig.quantization may pick
        # int8 over the engine-level kv_cache_dtype), plus the scale group:
        # an int8 pool next to a bf16 one — or two int8 pools with different
        # kv_group_size — would fail mid-request at the first handoff's
        # transplant instead of here at join time
        if mine["kv_cache_dtype"] != ref["kv_cache_dtype"]:
            raise ValueError(
                f"replica {handle.replica_id}: kv_cache_dtype "
                f"{mine['kv_cache_dtype']} != pool's "
                f"{ref['kv_cache_dtype']} (transplanted blocks must be "
                f"byte-identical)")
        if mine["kv_cache_dtype"] == "int8" \
                and mine["kv_group_size"] != ref["kv_group_size"]:
            raise ValueError(
                f"replica {handle.replica_id}: kv_group_size "
                f"{mine['kv_group_size']} != pool's {ref['kv_group_size']} "
                f"(int8 scale leaves must transplant 1:1)")

    @property
    def disaggregated(self) -> bool:
        return any(r.role == "prefill" for r in self.replicas.values())

    def _healthy(self, roles=None,
                 include_draining: bool = False) -> List[ReplicaHandle]:
        out = []
        for rid, r in self.replicas.items():
            if rid in self._quarantined or rid in self._dead:
                continue
            if rid in self._draining and not include_draining:
                continue
            if roles is not None and r.role not in roles:
                continue
            out.append(r)
        return out

    # ------------------------------------------------------------------
    # graceful drain / removal (the autoscaler's scale-down path)
    # ------------------------------------------------------------------

    def drain_replica(self, rid):
        """Begin a graceful drain: the replica stops receiving NEW work
        (dispatch, hedges, handoff targets all skip it) and its queued-but-
        unstarted requests move back to the router queue; active slots keep
        stepping to completion. `remove_replica` reaps it once idle — the
        autoscaler polls for that. A drain never loses a token: requeued
        requests re-dispatch from scratch (greedy rerun = identical), and
        running ones finish where they are."""
        if rid not in self.replicas:
            raise KeyError(f"unknown replica {rid!r}")
        if rid in self._draining or rid in self._dead:
            return
        if rid in self._quarantined:
            return          # already failed: quarantine owns its requests
        self._draining.add(rid)
        self._count("drains")
        requeue = []
        try:
            for req in self.replicas[rid].drain_queued():
                rec = self._pending.get(req.uid)
                if rec is not None and rec.replica == rid:
                    rec.replica = None
                    rec.t_dispatch = None
                    requeue.append(req.uid)
        except ReplicaUnavailableError as e:
            self._draining.discard(rid)
            self._quarantine(rid, e)
            return
        self.queue.extendleft(reversed(requeue))
        if requeue:
            self._count("reroutes", len(requeue))
        self._anticipated[rid].clear()
        log_dist(f"router: draining replica {rid} "
                 f"(requeued {len(requeue)})", ranks=[0])
        if self.flightrec.enabled:
            self.flightrec.record("drain", replica=rid,
                                  requeued=len(requeue))

    def replica_idle(self, rid) -> bool:
        """True when a replica owns no work at all — the reap condition."""
        rep = self.replicas[rid]
        if rid in self._dead:
            return True
        try:
            return rep.queue_depth == 0 and rep.num_active == 0 \
                and not any(rec.replica == rid or rec.hedge_replica == rid
                            for rec in self._pending.values())
        except ReplicaUnavailableError as e:
            self._quarantine(rid, e)
            return False

    def remove_replica(self, rid, close: bool = True) -> ReplicaHandle:
        """Reap a drained (or dead) replica from the pool. Refuses while it
        still owns work — call `drain_replica` first and poll
        `replica_idle`. With `close=True` the handle's resources are
        released (engine close / remote shutdown + process reap)."""
        if rid not in self.replicas:
            raise KeyError(f"unknown replica {rid!r}")
        if rid not in self._dead and not self.replica_idle(rid):
            raise RuntimeError(
                f"replica {rid} still owns work — drain it first")
        rep = self.replicas.pop(rid)
        for store in (self._budgets, self._ttft, self._anticipated,
                      self._strikes, self._quarantined, self._obs_cursors,
                      self._obs_metrics, self._obs_remap, self._obs_info):
            store.pop(rid, None)
        self._draining.discard(rid)
        self._dead.discard(rid)
        self._count("removed")
        log_dist(f"router: -replica {rid} (pool: {len(self.replicas)})",
                 ranks=[0])
        if self.flightrec.enabled:
            self.flightrec.record("remove_replica", replica=rid)
        if close:
            try:
                rep.close()
            except Exception as e:
                logger.warning(f"router: closing removed replica {rid} "
                               f"failed: {e}")
        return rep

    def _entry_roles(self):
        """Roles new requests dispatch to."""
        return ("prefill",) if self.disaggregated else ("mixed",)

    def _decode_roles(self):
        return ("decode", "mixed")

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def submit(self, request: Request,
               ttl_s: Optional[float] = None) -> Optional[CompletedRequest]:
        """Admit a request into the pool. Returns None when accepted; under
        admission_policy="shed" with a full router queue, returns the shed
        `CompletedRequest` (reason "cancelled") instead. Raises
        `InadmissibleRequestError` when NO replica's limits can ever fit
        the request."""
        if request.uid in self._pending or request.uid in self._done:
            raise ValueError(f"duplicate request uid {request.uid!r}")
        prompt_len = int(np.asarray(request.tokens).reshape(-1).shape[0])
        self._validate(request, prompt_len)
        now = self._clock()
        if len(self.queue) >= self.config.max_pending:
            if self.config.admission_policy == "shed":
                self._count("shed")
                if self.flightrec.enabled:
                    self.flightrec.record("shed", uid=request.uid,
                                          queued=len(self.queue))
                done = CompletedRequest(uid=request.uid,
                                        prompt_len=prompt_len,
                                        tokens=np.zeros((0,), np.int32),
                                        finish_reason="cancelled")
                self._done.add(request.uid)
                return done
            # "block": drive the pool until the queue drains below the cap;
            # finished requests land in the buffer the next step() returns
            while len(self.queue) >= self.config.max_pending:
                before = self._progress_mark()
                self._finished_buf.extend(self._step_inner())
                if self._progress_mark() == before:
                    self._await_restart_or_raise(
                        "router admission blocked with no possible progress "
                        f"(queue={len(self.queue)}, live replicas="
                        f"{len(self._healthy())})")
                    continue
        ttl = ttl_s if ttl_s is not None else self.config.default_ttl_s
        hashes = None
        for rep in self._healthy(self._entry_roles()):
            try:
                hashes = rep.hash_chain(request.tokens)
                break
            except ReplicaUnavailableError as e:
                self._quarantine(rep.replica_id, e)
        trace = None
        if self.tracer.enabled:
            # the router owns the trace: root span = submit -> completion,
            # closed in _complete (a failover in between stays inside it)
            trace = self.tracer.start(request.uid, t0=now, owner="router")
            # indexed past completion: remote replica spans arrive on the
            # pull cadence and must re-parent under this trace id even
            # after the root closed
            self._trace_index[request.uid] = trace
            while len(self._trace_index) > self._trace_index_cap:
                self._trace_index.popitem(last=False)
        self._pending[request.uid] = _Pending(
            request=request, prompt_len=prompt_len, hashes=hashes,
            t_submit=now, deadline=(now + ttl) if ttl is not None else None,
            trace=trace,
            # the HARD deadline anchors here, once: every re-dispatch
            # (failover rerun, hedge duplicate) passes the same absolute
            # value down, so recovery never silently extends the budget
            deadline_at=(now + float(request.deadline_ms) / 1e3)
            if request.deadline_ms is not None else None)
        self.queue.append(request.uid)
        self._count("submitted")
        return None

    def _validate(self, request, prompt_len):
        """At least one replica on each leg must be able to EVER fit the
        request; otherwise fail fast at the router instead of wedging.
        The decode leg is checked against the WORST-CASE prefill-side
        padding: a handoff target adopts a slot padded on the prefill
        replica's chunk grid, so validating it against its own (possibly
        finer) grid would admit requests no target can ever adopt."""
        legs = [(self._entry_roles(), self.disaggregated, None)]
        if self.disaggregated:
            chunks = [r.prefill_chunk for r in self._healthy(("prefill",))]
            padded = max(-(-prompt_len // c) * c for c in chunks) \
                if chunks else None
            legs.append((self._decode_roles(), False, padded))
        for roles, prefill_only, padded in legs:
            reps = self._healthy(roles)
            if not reps:
                raise RuntimeError(
                    f"router has no healthy replica for roles {roles} "
                    f"(pool={list(self.replicas)}, dead={sorted(self._dead)})")
            last_err = None
            answered = False
            for rep in reps:
                try:
                    rep.check_admissible(prompt_len, request.max_new_tokens,
                                         prefill_only=prefill_only,
                                         uid=request.uid,
                                         padded_prompt=padded)
                    last_err = None
                    answered = True
                    break
                except InadmissibleRequestError as e:
                    last_err = e
                    answered = True
                except ReplicaUnavailableError as e:
                    self._quarantine(rep.replica_id, e)
            if last_err is not None:
                raise last_err
            if not answered:
                raise RuntimeError(
                    f"router has no reachable replica for roles {roles} "
                    f"(pool={list(self.replicas)}, "
                    f"dead={sorted(self._dead)})")

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def _affinity(self, rep: ReplicaHandle, hashes) -> int:
        """Blocks of the chain this replica already holds OR was already
        asked to build: max of the replica's registered prefix (read-only
        cache probe) and the router's anticipated chain for it."""
        if not hashes:
            return 0
        registered = rep.affinity(hashes)
        seen = self._anticipated[rep.replica_id]
        anticipated = 0
        for h in hashes:
            if h not in seen:
                break
            anticipated += 1
        return max(registered, anticipated)

    def _note_dispatch(self, rid, hashes):
        if not hashes:
            return
        seen = self._anticipated[rid]
        for h in hashes:
            if h in seen:
                seen.move_to_end(h)
            else:
                seen[h] = None
        while len(seen) > self._anticipated_cap:
            seen.popitem(last=False)

    def _choose(self, rec: _Pending):
        """Pick a dispatch target for a queued request, or None when every
        eligible replica is saturated (the request waits at the router).
        Returns (handle, affinity_blocks, score, spilled)."""
        cfg = self.config
        eligible = self._healthy(self._entry_roles())
        if not eligible:
            return None, 0, 0.0, False
        max_q = max(1, cfg.max_replica_queue)
        scored = []       # (handle, affinity, score, pending, saturated)
        for rep in eligible:
            try:
                need = rep.check_admissible(
                    rec.prompt_len, rec.request.max_new_tokens,
                    prefill_only=self.disaggregated, uid=rec.request.uid)
                aff = self._affinity(rep, rec.hashes)
                pending = rep.queue_depth + rep.num_active
                score = (aff * cfg.affinity_weight
                         - pending * cfg.load_penalty
                         - (cfg.block_penalty
                            if need > rep.available_blocks else 0))
                saturated = rep.queue_depth >= max_q
            except InadmissibleRequestError:
                continue
            except ReplicaUnavailableError as e:
                self._quarantine(rep.replica_id, e)
                continue
            scored.append((rep, aff, score, pending, saturated))
        if not scored:
            return None, 0, 0.0, False
        open_ = [s for s in scored if not s[4]]
        if not open_:
            return None, 0, 0.0, False
        if cfg.routing_policy == "round_robin":
            chosen = open_[self._rr % len(open_)]
            self._rr += 1
        else:
            order = {id(s): i for i, s in enumerate(open_)}
            chosen = min(open_, key=lambda s: (-s[2], s[3],
                                               (order[id(s)] - self._rr)
                                               % len(open_)))
            self._rr += 1
        best_aff = max(s[1] for s in scored)
        return chosen[0], chosen[1], chosen[2], chosen[1] < best_aff

    def _dispatch(self):
        """Drain the router queue head-first into replicas. Strict FIFO:
        the head not fitting anywhere right now keeps everything behind it
        queued (same no-starvation rule as the engine's own admission)."""
        while self.queue:
            uid = self.queue[0]
            rec = self._pending[uid]
            rep, aff, score, spilled = self._choose(rec)
            if rep is None:
                break
            self.queue.popleft()
            if self.tracer.enabled and rec.trace is not None:
                # dispatch is a zero-duration span (not an instant event)
                # so replica-side spans can NEST under it — a failover's
                # second dispatch then reads as a sibling subtree, not
                # interleaved with the first attempt. flow_begin opens the
                # Perfetto arrow the replica's admit closes on ITS track.
                t = self._clock()
                sid = self.tracer.record(
                    rec.trace, "dispatch", t, 0.0, tid=0,
                    parent=rec.trace.root_id,
                    attrs={"replica": rep.replica_id, "affinity": int(aff),
                           "score": round(float(score), 3)})
                rec.trace.parent_id = sid
                self.tracer.flow_begin(rec.trace, t, tid=0)
            if self.flightrec.enabled:
                self.flightrec.record(
                    "dispatch", uid=uid, replica=rep.replica_id,
                    affinity=int(aff), score=round(float(score), 3),
                    spilled=bool(spilled))
            try:
                rep.submit(rec.request, prefill_only=self.disaggregated,
                           hashes=rec.hashes, trace=rec.trace,
                           deadline_at=rec.deadline_at)
            except ReplicaUnavailableError as e:
                # died between scoring and submit: back to the queue head
                # (rec.replica is still None, so the quarantine sweep
                # doesn't double-requeue it), then re-choose
                self.queue.appendleft(uid)
                self._quarantine(rep.replica_id, e)
                continue
            rec.replica = rep.replica_id
            rec.t_dispatch = self._clock()
            self._note_dispatch(rep.replica_id, rec.hashes)
            if self.config.routing_policy == "affinity":
                if aff > 0:
                    self._count("affinity_hits")
                if spilled:
                    self._count("load_spills")

    # ------------------------------------------------------------------
    # TTL + completion + failover
    # ------------------------------------------------------------------

    def _sweep_ttl(self, now, finished):
        # hard deadlines first: a request still in the ROUTER queue past
        # its absolute budget completes with reason "deadline" (dispatched
        # requests are the engine's job — its sync-point sweep retires
        # them, and the completion flows back through step())
        dead = [uid for uid, rec in self._pending.items()
                if rec.deadline_at is not None and now >= rec.deadline_at
                and rec.replica is None]
        for uid in dead:
            rec = self._pending[uid]
            self.queue.remove(uid)
            self._count("deadline_cancelled")
            if self.flightrec.enabled:
                self.flightrec.record("deadline", uid=uid, queued=True)
            self._complete(CompletedRequest(
                uid=uid, prompt_len=rec.prompt_len,
                tokens=np.zeros((0,), np.int32),
                finish_reason="deadline"), finished)
        expired = [uid for uid, rec in self._pending.items()
                   if rec.deadline is not None and now >= rec.deadline
                   # a hedged request is by definition dispatched twice and
                   # possibly generating on either copy — TTL (queued-only
                   # semantics) leaves it to completion or its hard deadline
                   and rec.hedge_replica is None]
        for uid in expired:
            rec = self._pending.get(uid)
            if rec is None:                       # deadline-swept above
                continue
            if rec.replica is None:
                self.queue.remove(uid)
                done = CompletedRequest(uid=uid, prompt_len=rec.prompt_len,
                                        tokens=np.zeros((0,), np.int32),
                                        finish_reason="cancelled")
            else:
                # only queued-but-unstarted dies; a generating request runs
                # on (a slot PARKED for handoff counts as cancellable — it
                # holds exported blocks, see ServingEngine.cancel)
                try:
                    done = self.replicas[rec.replica].cancel(uid,
                                                             queued_only=True)
                except ReplicaUnavailableError as e:
                    # the replica died with the request on it: quarantine
                    # re-owns everything it held (this uid included)
                    self._quarantine(rec.replica, e)
                    continue
                if done is None:
                    continue
            self._count("ttl_cancelled")
            if self.flightrec.enabled:
                self.flightrec.record("ttl_cancel", uid=uid,
                                      replica=rec.replica or "")
            self._complete(done, finished)

    def _complete(self, done: CompletedRequest, finished, rid=None):
        if done.uid in self._done:
            if done.uid not in self._hedged:
                # a hedge loser finishing in the same router step as the
                # winner is the EXPECTED duplicate; anything else is a bug
                # worth a line in the log
                logger.warning(f"router: dropping duplicate completion for "
                               f"{done.uid!r}")
            return
        rec = self._pending.pop(done.uid, None)
        self._done.add(done.uid)
        self._count("completed")
        if rec is not None and rec.hedge_replica is not None:
            # first completion wins: cancel the other copy wherever it is
            # (it may be generating — full cancel, not queued_only), and
            # credit the hedge when the duplicate beat the primary
            winner = rid
            if winner == rec.hedge_replica:
                self._count("hedge_wins")
            for other in {rec.replica, rec.hedge_replica} - {winner}:
                if other in self.replicas and other not in self._dead \
                        and other not in self._quarantined:
                    try:
                        self.replicas[other].cancel(done.uid)
                    except Exception:
                        pass          # a dying loser gets quarantined later
            if self.flightrec.enabled:
                self.flightrec.record("hedge_resolved", uid=done.uid,
                                      winner=str(winner),
                                      won=winner == rec.hedge_replica)
        if rec is not None and rec.trace is not None:
            # close the root (whole-request e2e, router queue included)
            self.tracer.finish(rec.trace, self._clock(), tid=0,
                               attrs={"reason": done.finish_reason,
                                      "replica": rec.replica or ""})
        if rec is not None and rec.replica is not None:
            if done.timing and done.timing.get("first_token"):
                # ROUTER-level TTFT: first token relative to router arrival
                # (engine TTFT + router queue wait), tagged by replica
                ttft_ms = (done.timing["first_token"] - rec.t_submit) * 1e3
                self._ttft[rec.replica].append(ttft_ms)
                self.telemetry.observe(
                    f"router/replica/{rec.replica}/ttft_ms", ttft_ms)
        finished.append(done)

    def _quarantine(self, rid, reason):
        """Replica failed (step raised, or an operator killed it): pull its
        queued requests out, re-route EVERYTHING incomplete it owned (an
        in-flight request restarts from scratch — greedy decode makes the
        rerun token-identical), and schedule a restart if the budget
        allows."""
        if rid in self._quarantined or rid in self._dead:
            return          # already converged (several probes can trip on
                            # the same dead replica within one router step)
        rep = self.replicas[rid]
        self._count("replica_failures")
        self._draining.discard(rid)     # a dying drain becomes a plain crash
        logger.warning(f"router: quarantining replica {rid} ({reason!r})")
        try:
            rep.drain_queued()          # engine queue state is re-owned here
        except Exception:
            pass                        # a truly dead backend may not answer
        requeue = []
        for uid, rec in self._pending.items():
            if rec.hedge_replica == rid:
                rec.hedge_replica = None       # the duplicate died with it
            elif rec.replica == rid and rec.hedge_replica is not None:
                # the primary died but its hedge is alive and already
                # running the same request — promote it instead of a
                # from-scratch rerun
                rec.replica, rec.hedge_replica = rec.hedge_replica, None
            elif rec.replica == rid:
                requeue.append(uid)
        t = self._clock()
        for uid in requeue:
            rec = self._pending[uid]
            rec.replica = None
            rec.t_dispatch = None
            if self.tracer.enabled and rec.trace is not None:
                # a dispatch arrow the dead replica never admitted would
                # dangle as an orphan "s" event — terminate it at the
                # reroute mark on the router track instead (no-op when
                # admission already consumed it)
                self.tracer.flow_end(rec.trace, t, tid=0)
                # re-parent future spans back under the root: the NEXT
                # dispatch opens a fresh subtree, and this mark is the
                # visible seam between the two attempts — ONE trace id
                # throughout, which is the failover-continuity contract
                rec.trace.parent_id = rec.trace.root_id
                self.tracer.event(rec.trace, "reroute", t, tid=0,
                                  attrs={"from": rid,
                                         "reason": str(reason)[:120]})
        self.queue.extendleft(reversed(requeue))
        self._count("reroutes", len(requeue))
        self._anticipated[rid].clear()   # its pool (and cache) is gone
        self._strikes[rid] = 0           # the watchdog starts fresh post-restart
        budget = self._budgets[rid]
        if rep.can_restart and budget.consume("crash"):
            self._quarantined[rid] = self._clock() + budget.next_delay()
        else:
            self._dead.add(rid)
            logger.error(f"router: replica {rid} is out of restart budget; "
                         f"pool shrinks to {len(self._healthy())}")
        # drain the dying replica's last observability spool BEFORE the
        # dump so its final spans/flight events make it into the black box
        # (over the wire if the server still answers; from its on-disk
        # spool file when the process is already gone)
        postmortem = self._postmortem_drain(rid)
        if self.flightrec.enabled:
            # the black-box moment this whole subsystem exists for: the
            # quarantine event joins the ring, then the ring + a full
            # router/replica state snapshot hit disk
            self.flightrec.record("quarantine", replica=rid,
                                  reason=str(reason)[:200],
                                  requeued=len(requeue),
                                  dead=rid in self._dead)
            state = self._failure_snapshot()
            if postmortem is not None and isinstance(state, dict):
                state["postmortem"] = postmortem
            self.flightrec.dump(f"replica {rid} failed: {reason}",
                                state=state)

    def _failure_snapshot(self):
        """stats() guarded for the dump path — a half-dead pool must still
        produce a black box, even if some replica's stats() throws."""
        try:
            return self.stats()
        except Exception as e:
            return {"error": f"stats() failed during dump: {e}"}

    def _maybe_restart(self, now):
        for rid, t in list(self._quarantined.items()):
            if now < t:
                continue
            del self._quarantined[rid]
            try:
                self.replicas[rid].restart()
                self._count("replica_restarts")
                # a rebuilt engine starts detached from the pool's
                # tracer/recorder (and from its Perfetto track) AND from
                # the pool clock — re-inject both
                if self._clock_injected:
                    self.replicas[rid].set_clock(self._clock)
                self._attach_observability(rid)
                if self.flightrec.enabled:
                    self.flightrec.record(
                        "restart", replica=rid,
                        nth=self._budgets[rid].restarts)
                log_dist(f"router: replica {rid} restarted "
                         f"(#{self._budgets[rid].restarts})", ranks=[0])
            except Exception as e:
                self._quarantine(rid, e)

    def kill_replica(self, rid):
        """Operator/test hook: fail a replica NOW (fault injection, drain
        for maintenance). Everything it owned re-routes; restart follows
        the per-replica budget like any crash."""
        if rid not in self.replicas:
            raise KeyError(f"unknown replica {rid!r}")
        if rid in self._dead or rid in self._quarantined:
            return
        self._quarantine(rid, "killed")

    # ------------------------------------------------------------------
    # hung-replica watchdog + hedged dispatch
    # ------------------------------------------------------------------

    def _watchdog_check(self, rid, rep, t0):
        """Per-step() deadline with a strike budget: one slow step is
        noise, `step_strike_budget` IN A ROW earns a health probe, and a
        failed probe converges on the same quarantine/drain/reroute path
        an exception takes. A fast step resets the count — 'slow' and
        'dead' stay distinguishable."""
        if self.config.step_deadline_ms is None:
            return
        dt_ms = (self._clock() - t0) * 1e3
        if dt_ms <= self.config.step_deadline_ms:
            self._strikes[rid] = 0
            return
        self._strikes[rid] += 1
        self._count("watchdog_strikes")
        if self.flightrec.enabled:
            self.flightrec.record("watchdog_strike", replica=rid,
                                  step_ms=round(dt_ms, 3),
                                  strikes=self._strikes[rid])
        if self._strikes[rid] < max(1, self.config.step_strike_budget):
            return
        alive = False
        try:
            alive = bool(rep.health_probe())
        except Exception:
            pass
        if alive:
            self._strikes[rid] = 0      # slow but answering: keep serving
            return
        self._count("watchdog_quarantines")
        self._quarantine(rid, ReplicaHungError(
            f"replica {rid}: {self._strikes[rid]} consecutive steps over "
            f"{self.config.step_deadline_ms}ms and health probe failed"))

    def _hedge_target(self, rec):
        """A healthy entry replica (≠ primary) with room to take the
        duplicate right now — free slot or shallow queue, and the request
        admissible there."""
        for rep in self._healthy(self._entry_roles()):
            if rep.replica_id == rec.replica:
                continue
            try:
                if not (rep.has_free_slot
                        or rep.queue_depth < self.config.max_replica_queue):
                    continue
                rep.check_admissible(rec.prompt_len,
                                     rec.request.max_new_tokens,
                                     prefill_only=self.disaggregated,
                                     uid=rec.request.uid)
            except InadmissibleRequestError:
                continue
            except ReplicaUnavailableError as e:
                self._quarantine(rep.replica_id, e)
                continue
            return rep
        return None

    def _maybe_hedge(self, now):
        """Deadline-aware hedged retries: a dispatched request with no
        first token after `hedge_after_ms` gets ONE speculative duplicate
        on another replica with capacity. First completion wins
        (`_complete` cancels the loser and de-dups); the duplicate carries
        the same absolute hard deadline, so hedging never extends a
        budget. The duplicate carries no router trace context — the
        primary owns the request's root span tree (with tracing on, the
        hedge replica records it as a separate engine-owned trace).

        MIXED pools only: in a disaggregated pool a hedged request would
        park TWO prefill-complete copies in _HANDOFF, and the handoff
        bookkeeping tracks one decode home per uid — the second transplant
        would clobber it and strand the loser's slot for the whole
        generation. Hung prefill replicas there are the watchdog's job."""
        if self.disaggregated:
            return
        wait = float(self.config.hedge_after_ms) / 1e3
        for uid, rec in list(self._pending.items()):
            if (rec.replica is None or rec.hedge_replica is not None
                    or rec.t_dispatch is None
                    or now - rec.t_dispatch < wait):
                continue
            primary = self.replicas.get(rec.replica)
            if primary is None:
                continue
            try:
                if primary.has_output(uid):
                    continue            # first token arrived: no hedge
            except Exception:
                pass                    # unanswerable primary: hedge away
            rep = self._hedge_target(rec)
            if rep is None:
                continue
            try:
                rep.submit(rec.request, prefill_only=self.disaggregated,
                           hashes=rec.hashes, trace=None,
                           deadline_at=rec.deadline_at)
            except ReplicaUnavailableError as e:
                self._quarantine(rep.replica_id, e)
                continue
            rec.hedge_replica = rep.replica_id
            self._hedged.add(uid)
            self._note_dispatch(rep.replica_id, rec.hashes)
            self._count("hedges")
            if self.flightrec.enabled:
                self.flightrec.record(
                    "hedge", uid=uid, primary=rec.replica,
                    hedge=rep.replica_id,
                    waited_ms=round((now - rec.t_dispatch) * 1e3, 3))

    # ------------------------------------------------------------------
    # disaggregated handoff
    # ------------------------------------------------------------------

    def _do_handoffs(self):
        """Move prefill-complete slots into decode replicas: allocate at the
        target, transplant the blocks, release the source. A target without
        room right now leaves the slot parked (prefill-side backpressure)."""
        targets = self._healthy(self._decode_roles())
        # a DRAINING prefill replica still unloads its parked slots (that
        # is what draining means); a draining decode replica takes no more
        for prep in self._healthy(("prefill",), include_draining=True):
            for uid in prep.handoff_ready():
                rec = self._pending.get(uid)
                if rec is None:        # cancelled while parked
                    prep.release_handoff(uid)
                    continue
                cands = sorted(targets, key=lambda r: (not r.has_free_slot,
                                                       r.queue_depth +
                                                       r.num_active))
                state = prep.export_handoff(uid)
                for drep in cands:
                    try:
                        ok = drep.receive_handoff(state, prep.pool)
                    except InadmissibleRequestError:
                        # THIS target can never fit it; submit-time
                        # validation guarantees some decode replica can
                        continue
                    if ok:
                        prep.release_handoff(uid)
                        rec.replica = drep.replica_id
                        self._count("handoffs")
                        if self.tracer.enabled and rec.trace is not None:
                            # one flow arrow prefill-track -> decode-track:
                            # the transplant renders as a connected hop
                            t = self._clock()
                            src = self._tids.get(prep.replica_id, 0)
                            dst = self._tids.get(drep.replica_id, 0)
                            self.tracer.flow_begin(rec.trace, t, tid=src)
                            sid = self.tracer.record(
                                rec.trace, "kv_handoff", t, 0.0, tid=0,
                                parent=rec.trace.root_id,
                                attrs={"from": prep.replica_id,
                                       "to": drep.replica_id})
                            rec.trace.parent_id = sid
                            self.tracer.flow_end(rec.trace, t, tid=dst)
                        if self.flightrec.enabled:
                            self.flightrec.record(
                                "handoff", uid=uid, src=prep.replica_id,
                                dst=drep.replica_id)
                        break

    # ------------------------------------------------------------------
    # the router step
    # ------------------------------------------------------------------

    def _step_inner(self) -> List[CompletedRequest]:
        finished: List[CompletedRequest] = []
        now = self._clock()
        self.steps += 1
        self._sweep_ttl(now, finished)
        self._maybe_restart(now)
        self._dispatch()
        for rid in list(self.replicas):
            if rid in self._quarantined or rid in self._dead:
                continue
            rep = self.replicas[rid]
            t0 = self._clock()
            try:
                for done in rep.step():
                    self._complete(done, finished, rid=rid)
            except Exception as e:
                self._quarantine(rid, e)
                continue
            self._watchdog_check(rid, rep, t0)
        if self.config.hedge_after_ms is not None:
            self._maybe_hedge(self._clock())
        if self.disaggregated:
            self._do_handoffs()
        if self.telemetry.enabled:
            self.telemetry.set_gauge("router/queue_depth", len(self.queue))
            self.telemetry.set_gauge("router/in_flight", len(self._pending))
            self.telemetry.set_gauge("router/live_replicas",
                                     len(self._healthy()))
            mem = self.memory_snapshot()
            if mem:
                # pool-aggregate memory ledger (replicas with a memory
                # ledger): total attributed device memory across live
                # replicas, and the TIGHTEST per-replica headroom — the
                # pool is as close to OOM as its fullest member
                self.telemetry.set_gauge("mem/pool_attributed_bytes",
                                         mem["attributed_bytes"])
                if mem.get("headroom_frac") is not None:
                    self.telemetry.set_gauge("mem/pool_headroom_frac",
                                             mem["headroom_frac"])
            # observability pulls piggyback on the export cadence: one
            # pull per replica per export_interval steps, so the wire
            # cost scales with the export rate the operator already chose
            interval = max(1, int(getattr(self.telemetry.config,
                                          "export_interval", 1)))
            if self.steps % interval == 0:
                self._observability_pull_all()
            self.telemetry.maybe_export(self.steps)
        return finished

    def step(self) -> List[CompletedRequest]:
        """One router iteration: TTL sweep -> restarts -> dispatch -> step
        every live replica -> handoffs. Returns every request that finished
        since the last call (including ones finished inside a blocking
        submit)."""
        out = self._finished_buf
        self._finished_buf = []
        out.extend(self._step_inner())
        return out

    @property
    def in_flight(self) -> int:
        """Incomplete requests anywhere in the pool (router queue +
        dispatched)."""
        return len(self._pending)

    def _await_restart_or_raise(self, msg):
        """Stalled with recovery still possible — a replica restart pending
        backoff, or a dispatched-but-silent request whose hedge window has
        not expired yet (a hung primary makes no progress while the hedge
        timer runs) — sleep until the clock reaches it. An INJECTED clock
        that never advances would spin forever here, so a non-moving clock
        raises instead of hanging."""
        if not (self._quarantined or self._hedge_may_fire()):
            raise RuntimeError(msg)
        t0 = self._clock()
        time.sleep(0.005)
        if self._clock() <= t0:
            raise RuntimeError(
                msg + " (a replica restart or hedge is scheduled but the "
                "injected clock never advances — advance it or use "
                "backoff 0)")

    def _hedge_may_fire(self):
        """True while some dispatched request could still earn a hedge —
        the watchdog-off recovery path: the pool looks stalled until
        `hedge_after_ms` elapses, but it is WAITING, not wedged."""
        if self.config.hedge_after_ms is None or self.disaggregated:
            return False                 # _maybe_hedge's mixed-pool gate
        return any(rec.replica is not None and rec.hedge_replica is None
                   for rec in self._pending.values())

    def _progress_mark(self):
        live = self._healthy(include_draining=True)
        work = 0
        for r in live:
            try:
                work += r.progress()
            except ReplicaUnavailableError:
                pass        # its death registers as a quarantine next step
        # hedges count as progress: the launch itself changes no queue or
        # token counter until the target's next admission, and run() must
        # not mistake that one-step gap for a wedged pool
        return (len(self.queue), len(self._pending), len(self._done), work,
                len(live), len(self._quarantined), self.counters["hedges"])

    def run(self, requests: Sequence[Request],
            ttl_s: Optional[float] = None) -> Dict[Any, CompletedRequest]:
        """Submit a batch and drain the pool. Shed/TTL-cancelled requests
        appear in the result with ``finish_reason="cancelled"``."""
        out: Dict[Any, CompletedRequest] = {}
        for r in requests:
            shed = self.submit(r, ttl_s=ttl_s)
            if shed is not None:
                out[shed.uid] = shed
        while self.in_flight or self._finished_buf:
            before = self._progress_mark()
            for done in self.step():
                out[done.uid] = done
            if self._progress_mark() == before:
                self._await_restart_or_raise(
                    f"router made no progress: queue={len(self.queue)} "
                    f"in_flight={self.in_flight} "
                    f"live={len(self._healthy())} dead={sorted(self._dead)}")
        if self.telemetry.enabled:
            self.telemetry.export(self.steps)
        return out

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def _count(self, name, n=1):
        self.counters[name] += n
        self.telemetry.inc(f"router/{name}", n)

    # ---- the pod observability plane (pull side) ----------------------

    def _observability_pull_all(self):
        """Pull every live replica's observability state (piggybacks on
        the telemetry export cadence in `_step_inner`; `observability_
        snapshot(refresh=True)` calls it on demand)."""
        for rid, rep in list(self.replicas.items()):
            if rid in self._dead or rid in self._quarantined:
                continue
            self._observability_pull_one(rid, rep)

    def _observability_pull_one(self, rid, rep):
        cursor = self._obs_cursors.get(rid, 0)
        try:
            reply = rep.observability_pull(cursor=cursor)
        except ReplicaUnavailableError:
            return      # liveness owns the death; the post-mortem drain
                        # recovers the spool tail at quarantine time
        except Exception as e:
            logger.warning(f"router: observability pull from {rid} "
                           f"failed: {e}")
            return
        if not reply or not reply.get("enabled"):
            return
        spans, events = self._ingest_items(rid, reply.get("items") or ())
        # cursor advances ONLY here, after a successful ingest — a pull
        # lost on the wire (and transparently retried: the verb is
        # idempotent) or one that raised above re-asks from the same
        # cursor and the spool answers with identical items
        self._obs_cursors[rid] = int(reply.get("cursor", cursor))
        metrics = reply.get("metrics")
        if metrics is not None:
            # REPLACE, never accumulate: the reply carries the replica's
            # full registry snapshot, so re-pulls cannot double-count
            self._obs_metrics[rid] = metrics
        info = self._obs_info.setdefault(rid, {})
        for key in ("spool_path", "pid"):
            if reply.get(key) is not None:
                info[key] = reply[key]
        info["dropped"] = int(reply.get("dropped", 0))
        if self.telemetry.enabled:
            self.telemetry.inc("obs/pulls")
            if spans:
                self.telemetry.inc("obs/pull_spans", spans)
            if events:
                self.telemetry.inc("obs/pull_events", events)
            if "pid" in reply:      # a wire pull (in-process pulls are free)
                self.telemetry.inc("obs/pull_bytes",
                                   len(json.dumps(reply, default=str)))

    def _ingest_items(self, rid, items):
        spans = events = 0
        for it in items:
            kind = it.get("kind")
            rec = it.get("rec") or {}
            if kind == "span":
                self._import_span(rid, rec)
                spans += 1
            elif kind == "flight":
                self._import_flight(rid, rec)
                events += 1
        return spans, events

    def _import_span(self, rid, rec):
        """Re-parent one remote span into the pool trace: the replica's
        span/parent ids map onto fresh router-tracer ids (consistent
        across pulls), its engine-owned root re-parents under the router's
        root for the same uid, and the span lands on the replica's named
        Perfetto track. Timestamps cross untranslated — every process on
        the host reads the same CLOCK_MONOTONIC (the tracer's documented
        clock domain)."""
        if not self.tracer.enabled:
            return
        tracer = self.tracer
        tid = self._tids.get(rid, 0)
        ctx = self._trace_index.get(rec.get("uid"))
        remap = self._obs_remap.setdefault(rid, {})

        def local_id(remote_id):
            sid = remap.get(remote_id)
            if sid is None:
                sid = next(tracer._ids)
                remap[remote_id] = sid
            return sid

        sid = local_id(rec.get("span"))
        remote_parent = rec.get("parent", 0)
        if remote_parent == 0:
            # the remote engine's root span ("request" on its side)
            # becomes a child of the router's root — ONE trace id from
            # dispatch to completion
            parent = ctx.root_id if ctx is not None else 0
        else:
            parent = local_id(remote_parent)
        if ctx is not None and ctx.flow_id is not None:
            # the dispatch arrow the router opened was never consumed
            # in-process (the replica is remote): close it at the first
            # span arriving on the replica's track
            tracer.flow_end(ctx, rec.get("ts", 0.0), tid=tid)
        shim = ctx if ctx is not None else TraceContext(
            trace_id=f"{rid}:{rec.get('trace')}", root_id=sid,
            uid=rec.get("uid"))
        tracer.record(shim, rec.get("name", "?"), rec.get("ts", 0.0),
                      rec.get("dur", 0.0), tid=tid,
                      attrs=dict(rec.get("attrs") or {}, src=rid),
                      parent=parent, span_id=sid)

    def _import_flight(self, rid, ev):
        """Land one remote flight event in the pool ring, wrapped (kind
        "remote", original event nested) so remote and router field names
        can never collide."""
        if self.flightrec.enabled:
            self.flightrec.record("remote", src=rid, event=dict(ev))

    def _postmortem_drain(self, rid) -> Optional[Dict[str, Any]]:
        """Recover a dying replica's final spool for the quarantine dump:
        a last wire pull while the server still answers, else a direct
        read of its on-disk spool file (the `kill -9` path — the file
        survives the process). Recovered spans join the pool trace;
        recovered flight events ride in the returned summary, which the
        dump embeds as `state["postmortem"]`."""
        if not (self.tracer.enabled or self.flightrec.enabled):
            return None
        rep = self.replicas.get(rid)
        if rep is None:
            return None
        cursor = self._obs_cursors.get(rid, 0)
        items, source = None, None
        try:
            reply = rep.observability_pull(cursor=cursor)
            if reply and reply.get("enabled"):
                items = reply.get("items") or []
                source = "wire"
                if reply.get("metrics") is not None:
                    self._obs_metrics[rid] = reply["metrics"]
        except Exception:
            items = None
        if items is None:
            info = self._obs_info.get(rid, {})
            path = info.get("spool_path") \
                or getattr(rep, "obs_spool_path", None)
            if path:
                from deepspeed_tpu_torch.serving.observability import \
                    read_spool_file
                items = read_spool_file(path, after_cursor=cursor)
                source = "spool_file"
        if not items:
            return None
        spans, events = self._ingest_items(rid, items)
        self._obs_cursors[rid] = max(
            [cursor] + [int(it.get("cursor", 0)) for it in items])
        if self.telemetry.enabled:
            self.telemetry.inc("obs/postmortem_recovered", len(items))
        return {"replica": rid, "source": source,
                "spans": spans,
                "flight_events": [it.get("rec") for it in items
                                  if it.get("kind") == "flight"]}

    def pool_latency(self, merged=None) -> Dict[str, Dict[str, float]]:
        """Pool-level latency percentiles from MERGED per-replica
        histograms — exact (bucket-wise merge over identical log-scale
        buckets), unlike any aggregation of per-replica percentiles.
        This is the pool-level latency source; `replica_ttft` stays
        per-replica."""
        if merged is None:
            merged = self.pool_metrics()
        out = {}
        for name in ("serving/ttft_ms", "serving/tpot_ms",
                     "serving/queue_wait_ms", "serving/e2e_ms"):
            snap = merged.get(name)
            if snap and snap.get("type") == "histogram":
                out[name] = {k: snap[k] for k in
                             ("count", "mean", "p50", "p90", "p99")}
        return out

    def pool_metrics(self) -> Dict[str, Any]:
        """The merged pool snapshot over the most recently pulled
        per-replica registries (counters summed, gauges per-source,
        histograms bucket-merged)."""
        per = {rid: snap for rid, snap in self._obs_metrics.items()
               if rid in self.replicas}
        return merge_snapshots(per) if per else {}

    def observability_snapshot(self, refresh: bool = True) -> Dict[str, Any]:
        """The one pool-level view (what the reference's top CLI renders): merged metric
        snapshot + pool latency percentiles, per-replica health/load/
        degradation/headroom, router counters, and the recent flight
        events. `refresh=False` serves the cached state from the last
        pull cadence instead of issuing fresh pulls."""
        if refresh:
            self._observability_pull_all()
        merged = self.pool_metrics()
        replicas: Dict[str, Any] = {}
        for rid, rep in self.replicas.items():
            health = ("dead" if rid in self._dead else
                      "quarantined" if rid in self._quarantined else
                      "draining" if rid in self._draining else "up")
            entry: Dict[str, Any] = {"role": rep.role, "health": health,
                                     "restarts": self._budgets[rid].restarts}
            if health in ("up", "draining"):
                try:
                    entry.update(queue=rep.queue_depth,
                                 active=rep.num_active,
                                 available_blocks=rep.available_blocks,
                                 has_free_slot=rep.has_free_slot)
                except ReplicaUnavailableError as e:
                    entry["health"] = "unreachable"
                    entry["error"] = str(e)[:200]
            snap = self._obs_metrics.get(rid) or {}
            for label, metric in (("degradation_level",
                                   "serving/degradation_level"),
                                  ("headroom_frac", "mem/headroom_frac")):
                g = snap.get(metric)
                if g is not None:
                    entry[label] = g.get("value")
            if rid in self._obs_info:
                entry["obs"] = dict(self._obs_info[rid])
            replicas[rid] = entry
        return {"steps": self.steps,
                "queue_depth": len(self.queue),
                "in_flight": len(self._pending),
                "live_replicas": len(self._healthy()),
                "counters": dict(self.counters),
                "pool_latency": self.pool_latency(merged),
                "pool_metrics": merged,
                "replicas": replicas,
                "flight_events": self.flightrec.events()[-32:]
                if self.flightrec.enabled else []}

    @staticmethod
    def _percentile(values, q):
        if not values:
            return None
        v = sorted(values)
        return float(v[min(len(v) - 1, int(q * len(v)))])

    def replica_ttft(self, rid) -> Dict[str, float]:
        """Router-level TTFT percentiles for ONE replica (ms), over the
        last `_ttft_window` completions. Populated only when the replicas
        run with telemetry enabled (the engine stamps first-token times).

        .. deprecated:: as a pool-level latency source. A single
           replica's p99 is not the pool's p99 — and no combination of
           per-replica percentiles is. Read `stats()["pool_latency"]`
           (or `pool_latency()`) instead: exact percentiles over the
           bucket-wise-merged pool histograms."""
        v = list(self._ttft.get(rid, ()))
        return {"count": len(v),
                "p50": self._percentile(v, 0.50),
                "p99": self._percentile(v, 0.99)}

    def memory_snapshot(self) -> Dict[str, Any]:
        """Aggregate the live replicas' device-memory ledgers:
        replica-owned byte categories (params, pools, temps) summed across
        the pool, headroom as the MINIMUM per-replica fraction (the
        binding constraint), and allocator-global watermarks
        (bytes_in_use/peak/capacity/unattributed) as the MAX — in-process
        replicas all read the same device allocator, so summing those
        would multiply one device by the replica count. Per-replica
        detail under "replicas". {} when no replica runs with
        `telemetry.memscope`."""
        per: Dict[str, Dict[str, Any]] = {}
        for rid, rep in self.replicas.items():
            if rid in self._dead or rid in self._quarantined:
                continue
            try:
                snap = rep.memory_snapshot()
            except Exception:
                snap = None
            if snap:
                per[rid] = snap
        if not per:
            return {}
        device_global = {"bytes_in_use", "peak_bytes", "capacity_bytes",
                         "unattributed_bytes"}
        out: Dict[str, Any] = {"replicas": per}
        for snap in per.values():
            for k, v in snap.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                if k == "headroom_frac":
                    cur = out.get(k)
                    out[k] = v if cur is None else min(cur, v)
                elif k in device_global:
                    out[k] = max(out.get(k, 0), v)
                else:
                    out[k] = out.get(k, 0) + v
        return out

    def stats(self) -> Dict[str, Any]:
        """RouterStats: routing-decision counters, queue depth, and a
        per-replica block (role/health/load/TTFT + the engine's own
        stats())."""
        reps = {}
        for rid, rep in self.replicas.items():
            health = ("dead" if rid in self._dead else
                      "quarantined" if rid in self._quarantined else
                      "draining" if rid in self._draining else "up")
            entry = {"role": rep.role, "health": health,
                     "restarts": self._budgets[rid].restarts,
                     "ttft_ms": self.replica_ttft(rid)}
            if health in ("up", "draining"):
                try:
                    entry.update(queue=rep.queue_depth,
                                 active=rep.num_active,
                                 available_blocks=rep.available_blocks,
                                 engine=rep.stats())
                except ReplicaUnavailableError as e:
                    # stats() must never crash on a half-dead pool — the
                    # flight-recorder dump path depends on it
                    entry["health"] = "unreachable"
                    entry["error"] = str(e)[:200]
            reps[rid] = entry
        out = {"steps": self.steps, "queue_depth": len(self.queue),
               "in_flight": len(self._pending),
               "counters": dict(self.counters),
               "disaggregated": self.disaggregated,
               "replicas": reps}
        # pool-level latency from MERGED histograms (cached pulls — no
        # wire traffic here: stats() runs inside failure paths); {} until
        # the first pull cadence fires or when replicas run telemetry-off
        pool = self.pool_latency()
        if pool:
            out["pool_latency"] = pool
        mem = self.memory_snapshot()
        if mem:
            out["memory"] = mem
        return out

    def audit_pool(self, repair: bool = False) -> Dict[str, Any]:
        """Run the KV-pool invariant auditor on every LIVE replica (the
        chaos soak's final check, and an operator probe between waves).
        Returns rid -> `AuditReport`; replicas with no in-process pool to
        audit (remote backends) are skipped. With `repair=True` a dirty
        pool is rebuilt from its slot tables in place; a replica whose
        repair cannot reach a clean state raises through the caller —
        quarantine it with `kill_replica` if serving must continue."""
        out: Dict[str, Any] = {}
        for rep in self._healthy():
            report = rep.audit(repair=repair)
            if report is not None:
                out[rep.replica_id] = report
        return out

    def dump_flight_recorder(self, reason="operator dump"):
        """Write the black box NOW (operator/test hook). For out-of-band
        dumps wire `router.flightrec.install_signal_handler(
        state_fn=router.stats)` and send SIGUSR2."""
        return self.flightrec.dump(reason, state=self._failure_snapshot())

    def total_prefill_chunks(self) -> int:
        """Prefill chunks executed across live replicas — the quantity
        affinity routing minimizes on shared-prefix traffic."""
        total = 0
        for r in self._healthy(include_draining=True):
            try:
                total += r.stats()["prefill_chunks"]
            except ReplicaUnavailableError:
                pass
        return total
