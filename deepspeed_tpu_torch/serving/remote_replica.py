"""RemoteReplica: a `ReplicaHandle` whose engine lives in another process
(counterpart of `deepspeed_tpu/serving/remote_replica.py`).

The router drives this handle exactly like an `InProcessReplica` — every
protocol verb becomes one RPC over `serving/transport.py`. The pieces:

  * **ReplicaProcess** — spawns `python -m deepspeed_tpu_torch.serving.
    replica_server` with an engine factory (`module:function` + JSON
    kwargs), waits for its ready-file (host/port of the bound listener),
    and owns the OS-process lifecycle (poll/terminate/kill/wait). It is
    also the restart recipe: `RemoteReplica.restart()` respawns the
    process under the router's existing `elasticity/restart_policy` budget;
  * **HeartbeatMonitor** — a push-stream liveness watch: the server sends a
    beat every `heartbeat_interval_s`; the monitor drains them without
    blocking and declares the replica dead after `heartbeat_miss_budget`
    beat-less intervals or an EOF (the instant a killed process's socket
    closes). Clock AND beat source are injectable, so the miss budget is
    unit-testable with zero real waiting;
  * **RemoteReplica** — the handle. Idempotent verbs (pure reads: stats,
    signals, affinity, admissibility...) retry transient transport errors
    under a bounded backoff+jitter policy; non-idempotent verbs (submit,
    step, cancel, drain_queued) are at-most-once — a lost reply surfaces
    as `ReplicaUnavailableError` and the router's quarantine/failover path
    owns recovery (re-route + greedy rerun = exactly-once completion).

Clock protocol (the `set_clock` boundary): a Python callable cannot cross a
process boundary, so a remote replica KEEPS ITS OWN monotonic clock and the
router's clock never leaves the router. `set_clock` here only swaps the
handle's LOCAL clock — the one used to convert the router's absolute
`deadline_at` into a remaining-seconds budget at submit time; the server
re-anchors that budget onto its own clock. Router-side TTL, watchdog and
hedge math were always router-clocked and are unaffected. The one thing
this gives up is deterministic time-travel INSIDE a remote engine (its
TTFT stamps are its own); deadlines, TTLs and liveness all stay exact.
"""

import dataclasses
import json
import os
import select
import socket
import subprocess
import sys
import time
from typing import Any, Callable, Dict, Optional

from deepspeed_tpu_torch.inference.scheduler import InadmissibleRequestError
from deepspeed_tpu_torch.serving.replica import ReplicaHandle, ReplicaUnavailableError
from deepspeed_tpu_torch.serving.transport import (MAGIC, RetryPolicy,
                                                   RpcClient, RemoteCallError,
                                                   TransportError,
                                                   call_with_retry, send_frame)
from deepspeed_tpu_torch.utils.logging import logger


class ReplicaDeadError(ReplicaUnavailableError):
    """Liveness said dead BEFORE a verb was issued: the OS process exited,
    or the heartbeat budget ran out. Raised from step() so the router's
    quarantine path fires without ever blocking on a step timeout."""


@dataclasses.dataclass
class RemoteConfig:
    """Knobs for one remote replica (the reference's fields and
    defaults)."""
    connect_timeout_s: float = 5.0
    call_timeout_s: float = 10.0       # cheap verbs (signals, stats, cancel)
    submit_timeout_s: float = 30.0     # submit ships the whole prompt
    step_timeout_s: float = 300.0      # a first step may build kernels; the
                                       # heartbeat, not this, detects death
    ready_timeout_s: float = 120.0     # process spawn -> ready-file
    # retry policy: IDEMPOTENT verbs only
    max_retries: int = 2
    base_backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.25
    # heartbeat liveness
    heartbeat_interval_s: float = 0.5
    heartbeat_miss_budget: int = 4     # beat-less intervals before "dead"

    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy(max_retries=self.max_retries,
                           base_backoff_s=self.base_backoff_s,
                           backoff_factor=self.backoff_factor,
                           max_backoff_s=self.max_backoff_s,
                           jitter=self.jitter)


# ----------------------------------------------------------------------
# heartbeat liveness
# ----------------------------------------------------------------------

class SocketBeatSource:
    """Drains beat frames from a server heartbeat connection without ever
    blocking: `drain()` returns (new_beats, eof). Frames are counted, not
    decoded — a beat's only information is that it arrived."""

    _HDR = 8   # MAGIC(4) + length(4)

    def __init__(self, host: str, port: int, connect_timeout_s: float = 5.0):
        try:
            self._sock = socket.create_connection(
                (host, port), timeout=connect_timeout_s)
            send_frame(self._sock, {"hello": "heartbeat"})
        except (OSError, TransportError) as e:
            raise ReplicaUnavailableError(
                f"heartbeat connect to {host}:{port} failed: {e}") from None
        self._sock.setblocking(False)
        self._buf = b""
        self._eof = False

    def drain(self):
        if self._eof:
            return 0, True
        while True:
            try:
                r, _, _ = select.select([self._sock], [], [], 0)
            except (OSError, ValueError):
                self._eof = True
                break
            if not r:
                break
            try:
                chunk = self._sock.recv(1 << 16)
            except BlockingIOError:
                break
            except OSError:
                self._eof = True
                break
            if not chunk:
                self._eof = True
                break
            self._buf += chunk
        beats = 0
        while len(self._buf) >= self._HDR:
            if self._buf[:4] != MAGIC:      # desynced: trust EOF/miss instead
                self._eof = True
                self._buf = b""
                break
            length = int.from_bytes(self._buf[4:8], "big")
            if len(self._buf) < self._HDR + length:
                break
            self._buf = self._buf[self._HDR + length:]
            beats += 1
        return beats, self._eof

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class HeartbeatMonitor:
    """Miss-budget liveness over a beat source. `check()` is O(1) and
    non-blocking — call it as often as you like (the router does, before
    every step dispatch). Both the clock and the source are injectable:
    tests drive `check()` through a fake clock + scripted beats and prove
    the budget math without one real sleep."""

    def __init__(self, source, interval_s: float, miss_budget: int,
                 clock: Callable[[], float] = None):
        self._source = source
        self.interval_s = float(interval_s)
        self.miss_budget = int(miss_budget)
        self._clock = clock if clock is not None else time.monotonic
        self._last_beat_t = self._clock()   # grace: spawn counts as a beat
        self.beats = 0
        self.dead_reason: Optional[str] = None

    @property
    def alive(self) -> bool:
        return self.dead_reason is None

    def missed_intervals(self) -> float:
        return (self._clock() - self._last_beat_t) / self.interval_s

    def check(self) -> bool:
        """True = alive. Once dead, stays dead (a restart builds a fresh
        monitor)."""
        if self.dead_reason is not None:
            return False
        beats, eof = self._source.drain()
        if beats:
            self.beats += beats
            self._last_beat_t = self._clock()
        if eof:
            # the socket closed: for a replica process this is the moment
            # the OS reaped it — no need to wait out the miss budget
            self.dead_reason = "heartbeat connection closed (EOF)"
            return False
        missed = self.missed_intervals()
        if missed > self.miss_budget:
            self.dead_reason = (f"no heartbeat for {missed:.1f} intervals "
                                f"(budget {self.miss_budget})")
            return False
        return True

    def close(self):
        self._source.close()


# ----------------------------------------------------------------------
# the replica OS process
# ----------------------------------------------------------------------

class ReplicaProcess:
    """One replica-server OS process: spawn, readiness, lifecycle.

    The server binds an ephemeral port and writes ``host port`` to
    `ready_file` once listening (AFTER the engine is built — readiness
    means "serving", not "booting"). `env` entries override the parent's.
    The child builds its engine on the card unless the factory's kwargs
    ask for the CPU (`{"device": "cpu"}`, what the CPU tests pass)."""

    def __init__(self, factory: str, factory_kwargs: Dict[str, Any] = None,
                 heartbeat_interval_s: float = 0.5, ready_file: str = None,
                 env: Dict[str, str] = None, replica_id: str = "r?",
                 clock: Callable[[], float] = None):
        self.factory = factory
        self.factory_kwargs = dict(factory_kwargs or {})
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.replica_id = replica_id
        self._env_overrides = dict(env or {})
        self._clock = clock if clock is not None else time.monotonic
        if ready_file is None:
            import tempfile
            fd, ready_file = tempfile.mkstemp(prefix="dstpu_replica_",
                                              suffix=".ready")
            os.close(fd)
            os.unlink(ready_file)
        self.ready_file = ready_file
        self.proc: Optional[subprocess.Popen] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None

    def spawn(self):
        if os.path.exists(self.ready_file):
            os.unlink(self.ready_file)
        env = dict(os.environ)
        # the child must import deepspeed_tpu_torch from the same tree the
        # parent runs, wherever the parent found it
        import deepspeed_tpu_torch as _pkg
        tree = os.path.dirname(os.path.dirname(os.path.abspath(_pkg.__file__)))
        env["PYTHONPATH"] = tree + os.pathsep + env.get("PYTHONPATH", "")
        env.update(self._env_overrides)
        cmd = [sys.executable, "-m", "deepspeed_tpu_torch.serving.replica_server",
               "--factory", self.factory,
               "--kwargs", json.dumps(self.factory_kwargs),
               "--port", "0",
               "--heartbeat-interval", str(self.heartbeat_interval_s),
               "--ready-file", self.ready_file]
        self.proc = subprocess.Popen(cmd, env=env)
        return self

    def wait_ready(self, timeout_s: float = 120.0):
        """Poll for the ready-file (real wall time: a subprocess boots on
        the OS clock, no injected clock can speed it up)."""
        deadline = self._clock() + timeout_s
        while self._clock() < deadline:
            if self.proc.poll() is not None:
                raise ReplicaUnavailableError(
                    f"replica {self.replica_id} process exited rc="
                    f"{self.proc.returncode} before becoming ready")
            if os.path.exists(self.ready_file):
                text = open(self.ready_file).read().strip()
                if text:
                    host, port = text.split()
                    self.host, self.port = host, int(port)
                    return self.host, self.port
            time.sleep(0.05)
        raise ReplicaUnavailableError(
            f"replica {self.replica_id} not ready after {timeout_s}s")

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def poll(self):
        return self.proc.poll() if self.proc is not None else -1

    def terminate(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()

    def wait(self, timeout_s: float = 10.0):
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=timeout_s)
        if os.path.exists(self.ready_file):
            try:
                os.unlink(self.ready_file)
            except OSError:
                pass


# ----------------------------------------------------------------------
# the handle
# ----------------------------------------------------------------------

# verbs safe to re-ask after a lost reply: pure reads, no server-side state
# (observability_pull qualifies because a pull never consumes spool items —
# the same cursor always answers with the same data, so a retried pull is
# byte-identical and can never double-count)
_IDEMPOTENT = frozenset({
    "ping", "signals", "affinity", "hash_chain", "check_admissible",
    "has_output", "audit_state", "memory_snapshot", "stats",
    "compile_stats", "compat", "progress", "observability_pull"})


class RemoteReplica(ReplicaHandle):
    """The router-facing proxy for a process-separated replica.

    Build it around a `ReplicaProcess` (spawned + ready) for the full
    lifecycle (heartbeat, restart-respawn), or from a bare host/port for an
    externally managed server (no restart, heartbeat optional)::

        proc = ReplicaProcess(factory="mypkg.engines:make", ...).spawn()
        proc.wait_ready()
        rep = RemoteReplica(process=proc, replica_id="r0")
        router.add_replica(rep)

    Load-signal reads are batched: the five routing properties + progress
    ride ONE cached "signals" RPC, invalidated by any state-changing verb —
    the router's scoring loop costs one round trip per replica per step,
    not five."""

    def __init__(self, process: ReplicaProcess = None, host: str = None,
                 port: int = None, replica_id: str = "r0",
                 role: str = "mixed", config: RemoteConfig = None,
                 clock: Callable[[], float] = None,
                 sleep: Callable[[float], None] = None,
                 rng: Callable[[], float] = None,
                 heartbeat: bool = True):
        assert role in ("mixed", "prefill", "decode"), \
            f"unknown replica role {role!r}"
        if process is None and (host is None or port is None):
            raise ValueError("RemoteReplica needs a ReplicaProcess or a "
                             "host+port")
        self.replica_id = str(replica_id)
        self.role = role
        self.config = config or RemoteConfig()
        self.process = process
        self._host = host if host is not None else process.host
        self._port = port if port is not None else process.port
        if self._host is None or self._port is None:
            raise ValueError("replica process has no address — call "
                             "spawn() + wait_ready() first")
        # see module docstring: this clock is LOCAL (deadline translation);
        # it never crosses the wire
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep     # None -> call_with_retry's default
        self._rng = rng
        self._heartbeat_enabled = heartbeat
        self._client: Optional[RpcClient] = None
        self._monitor: Optional[HeartbeatMonitor] = None
        self._signals_cache: Optional[Dict[str, Any]] = None
        self._closed = False
        self.transport_counters = {"calls": 0, "retries": 0, "errors": 0}
        if heartbeat:
            self._monitor = self._build_monitor()

    # -- wiring ----------------------------------------------------------

    def _build_monitor(self) -> HeartbeatMonitor:
        src = SocketBeatSource(self._host, self._port,
                               self.config.connect_timeout_s)
        return HeartbeatMonitor(src, self.config.heartbeat_interval_s,
                                self.config.heartbeat_miss_budget,
                                clock=self._clock)

    def _rpc(self) -> RpcClient:
        if self._client is None:
            self._client = RpcClient(
                self._host, self._port,
                connect_timeout_s=self.config.connect_timeout_s,
                default_timeout_s=self.config.call_timeout_s)
        return self._client

    def _call(self, verb: str, payload: Dict[str, Any] = None,
              timeout_s: float = None) -> Any:
        """One verb over the wire; transient failures retried only for
        idempotent verbs. `RemoteCallError` carrying the engine's own
        `InadmissibleRequestError` is translated back so the router's
        routing/validation `except` clauses keep working unmodified."""
        if self._closed:
            raise ReplicaUnavailableError(
                f"replica {self.replica_id} is closed")
        self._raise_if_declared_dead()
        idem = verb in _IDEMPOTENT
        if verb not in _IDEMPOTENT:
            self._signals_cache = None
        self.transport_counters["calls"] += 1

        def attempt():
            return self._rpc().call(verb, payload, timeout_s=timeout_s)

        def on_retry(n, _e):
            self.transport_counters["retries"] += 1

        try:
            return call_with_retry(attempt, idempotent=idem,
                                   policy=self.config.retry_policy(),
                                   sleep=self._sleep, rng=self._rng,
                                   on_retry=on_retry)
        except TransportError:
            self.transport_counters["errors"] += 1
            raise
        except RemoteCallError as e:
            if e.err_type == "InadmissibleRequestError":
                raise InadmissibleRequestError(e.remote_message) from None
            raise

    def _raise_if_declared_dead(self):
        """Fail fast on a replica already known dead: its process exited,
        or its heartbeat budget ran out (sticky). The reference sends the
        quarantine's drain and post-mortem pull to such a replica anyway,
        and a stopped (not killed) process then costs each call its whole
        timeout; here they raise at once and the post-mortem reads the
        spool file, as after a kill."""
        if self.process is not None and self.process.poll() is not None:
            raise ReplicaDeadError(
                f"replica {self.replica_id} process exited rc="
                f"{self.process.poll()}")
        if self._monitor is not None and \
                self._monitor.dead_reason is not None:
            raise ReplicaDeadError(
                f"replica {self.replica_id}: {self._monitor.dead_reason}")

    def _ensure_alive(self):
        """Cheap pre-flight before expensive verbs: OS process state first,
        then the heartbeat budget — a killed or wedged process is declared
        dead HERE, in O(1), instead of burning a step timeout."""
        if self.process is not None and self.process.poll() is not None:
            raise ReplicaDeadError(
                f"replica {self.replica_id} process exited rc="
                f"{self.process.poll()}")
        if self._monitor is not None and not self._monitor.check():
            raise ReplicaDeadError(
                f"replica {self.replica_id}: {self._monitor.dead_reason}")

    def heartbeat_alive(self) -> bool:
        """Non-raising liveness read (the pool CLI's status column)."""
        try:
            self._ensure_alive()
            return True
        except ReplicaUnavailableError:
            return False

    # -- request lifecycle ------------------------------------------------

    def submit(self, request, prefill_only=False, hashes=None, trace=None,
               deadline_at=None):
        # trace is dropped at the boundary: a span context cannot cross a
        # process boundary. The remote engine records its own side; the
        # router pulls those spans home over `observability_pull` and
        # re-parents them under its trace id (attach_observability below)
        deadline_in_s = None
        if deadline_at is not None:
            # absolute (router clock) -> remaining budget -> the server
            # re-anchors on ITS clock; the budget, not the clock, crosses
            deadline_in_s = max(0.0, float(deadline_at) - self._clock())
        self._call("submit", {
            "request": request, "prefill_only": bool(prefill_only),
            "hashes": list(hashes) if hashes else None,
            "deadline_in_s": deadline_in_s,
        }, timeout_s=self.config.submit_timeout_s)

    def step(self):
        self._ensure_alive()
        return self._call("step", {}, timeout_s=self.config.step_timeout_s)

    def cancel(self, uid, queued_only=False):
        return self._call("cancel", {"uid": uid,
                                     "queued_only": bool(queued_only)})

    def drain_queued(self):
        return self._call("drain_queued", {})

    # -- routing signals --------------------------------------------------

    def _signals(self) -> Dict[str, Any]:
        if self._signals_cache is None:
            self._signals_cache = self._call("signals", {})
        return self._signals_cache

    def check_admissible(self, prompt_len, max_new, prefill_only=False,
                         uid="?", padded_prompt=None):
        return self._call("check_admissible", {
            "prompt_len": int(prompt_len), "max_new": int(max_new),
            "prefill_only": bool(prefill_only), "uid": uid,
            "padded_prompt": padded_prompt})

    def progress(self):
        return int(self._signals()["progress"])

    @property
    def prefill_chunk(self):
        return int(self._signals()["prefill_chunk"])

    def affinity(self, hashes):
        if not hashes:
            return 0
        return int(self._call("affinity", {"hashes": list(hashes)}))

    def hash_chain(self, prompt):
        out = self._call("hash_chain", {"prompt": prompt})
        return None if out is None else [bytes(h) for h in out]

    @property
    def queue_depth(self):
        return int(self._signals()["queue_depth"])

    @property
    def num_active(self):
        return int(self._signals()["num_active"])

    @property
    def available_blocks(self):
        return int(self._signals()["available_blocks"])

    @property
    def has_free_slot(self):
        return bool(self._signals()["has_free_slot"])

    # -- disaggregated handoff -------------------------------------------
    # KV blocks are device buffers; shipping them between processes is not
    # supported, as in the reference. A remote replica therefore serves
    # role="mixed" only — the router never calls these outside
    # disaggregated pools.

    def handoff_ready(self):
        return []

    def export_handoff(self, uid):
        raise NotImplementedError(
            "cross-process KV handoff is not supported yet — remote "
            "replicas serve role='mixed'")

    def receive_handoff(self, state, src_pool):
        raise NotImplementedError(
            "cross-process KV handoff is not supported yet — remote "
            "replicas serve role='mixed'")

    def release_handoff(self, uid):
        raise NotImplementedError(
            "cross-process KV handoff is not supported yet")

    # -- observability ----------------------------------------------------

    def attach_observability(self, tracer=None, flightrec=None, tid=None):
        """The wire version of tracer sharing: the objects stay router-side
        (a tracer cannot cross a process boundary) — instead this probes
        the replica server's observability plane (`observability_pull` at
        cursor 0) and caches its spool path + pid so the router can pull
        spans/flight events home on its sync cadence and drain the on-disk
        spool post-mortem. Warns loudly — once per handle — when the
        router wants traces but the remote process recorded none (its
        engine config must enable telemetry tracing/flight_recorder too),
        so a silently dark replica is never mistaken for a healthy one."""
        self.obs_spool_path: Optional[str] = None
        self.obs_pid: Optional[int] = None
        self._obs_enabled = False
        if tracer is None and flightrec is None:
            return
        try:
            probe = self.observability_pull(cursor=0)
        except (ReplicaUnavailableError, RemoteCallError):
            probe = None
        if not (probe or {}).get("enabled"):
            if not getattr(self, "_obs_warned", False):
                self._obs_warned = True
                logger.warning(
                    f"replica {self.replica_id}: router observability is on "
                    f"but the remote process ships nothing back — its spans "
                    f"and flight events will NOT appear in the pool trace. "
                    f"Enable telemetry tracing/flight_recorder in the remote "
                    f"engine's config (the replica server spools them for "
                    f"the router automatically).")
            return
        self._obs_enabled = True
        self.obs_spool_path = probe.get("spool_path")
        self.obs_pid = probe.get("pid")

    def observability_pull(self, cursor=0):
        return self._call("observability_pull", {"cursor": int(cursor)})

    def set_clock(self, clock):
        # LOCAL swap only (deadline translation); never forwarded — see
        # the module docstring for the full clock protocol
        self._clock = clock
        if self._monitor is not None:
            self._monitor._clock = clock

    # -- health -----------------------------------------------------------

    def restart(self):
        """Respawn the replica process (the router calls this under its
        restart budget). Externally managed replicas (no ReplicaProcess)
        cannot restart — `can_restart` already said so."""
        if self.process is None:
            raise RuntimeError(
                f"replica {self.replica_id}: externally managed, no spawn "
                f"recipe to restart from")
        self.close_transport()
        self.process.kill()
        self.process.wait()
        self.process.spawn()
        self.process.wait_ready(self.config.ready_timeout_s)
        self._host, self._port = self.process.host, self.process.port
        self._closed = False
        if self._heartbeat_enabled:
            self._monitor = self._build_monitor()
        logger.info(f"remote replica {self.replica_id} respawned "
                    f"(pid {self.process.pid} @ {self._host}:{self._port})")

    @property
    def can_restart(self):
        return self.process is not None

    def health_probe(self):
        try:
            return bool(self._call("ping", {}, timeout_s=min(
                2.0, self.config.call_timeout_s)))
        except (ReplicaUnavailableError, RemoteCallError):
            return False

    def has_output(self, uid):
        return bool(self._call("has_output", {"uid": uid}))

    def audit_state(self):
        return self._call("audit_state", {})

    def memory_snapshot(self):
        return self._call("memory_snapshot", {})

    def compat_descriptor(self):
        return self._call("compat", {})

    def transport_stats(self) -> Dict[str, Any]:
        out = dict(self.transport_counters)
        if self._monitor is not None:
            out["heartbeats"] = self._monitor.beats
            out["heartbeat_alive"] = self._monitor.alive
            if self._monitor.dead_reason:
                out["heartbeat_dead_reason"] = self._monitor.dead_reason
        if self.process is not None:
            out["pid"] = self.process.pid
        return out

    def stats(self):
        out = self._call("stats", {})
        out["transport"] = self.transport_stats()
        return out

    def compile_stats(self):
        return self._call("compile_stats", {})

    # -- teardown ---------------------------------------------------------

    def close_transport(self):
        if self._client is not None:
            self._client.close()
            self._client = None
        if self._monitor is not None:
            self._monitor.close()
            self._monitor = None
        self._signals_cache = None

    def close(self):
        """Graceful teardown: ask the server to shut down (it closes its
        engine — final audit + telemetry flush — before exiting), then reap
        the process. Idempotent; safe on an already-dead replica."""
        if self._closed:
            return
        self._closed = True
        try:
            self._rpc().call("shutdown", {}, timeout_s=min(
                10.0, self.config.step_timeout_s))
        except (ReplicaUnavailableError, RemoteCallError, OSError):
            pass
        self.close_transport()
        if self.process is not None:
            self.process.terminate()
            self.process.wait()
