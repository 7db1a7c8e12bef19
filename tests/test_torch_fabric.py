"""The port's multi-process serving fabric held to the JAX package's: the
wire frames (byte-equal for the same objects, each package decoding the
other's), bounded retries, the heartbeat monitor, the bare RPC server, a
transport-backed replica of the port's tiny engine driven by the router
(tokens equal to `tiny_oracle`, the port's and JAX's), the join-time pool
compatibility gate, the observability spool, and one subprocess soak: two
replica-server processes on the CPU, one SIGKILLed mid-trace, every request
completed exactly once."""

import signal
import socket
import time

import numpy as np
import pytest

from deepspeed_tpu.inference import scheduler as jsch
from deepspeed_tpu.serving import transport as jtr
from deepspeed_tpu.testing import fabric as jfabric
from deepspeed_tpu_torch.config.core import TelemetryConfig
from deepspeed_tpu_torch.inference.scheduler import (CompletedRequest,
                                                     InadmissibleRequestError,
                                                     Request)
from deepspeed_tpu_torch.serving import (RemoteConfig, RemoteReplica,
                                         ReplicaHandle, ReplicaProcess,
                                         ReplicaUnavailableError,
                                         ServingRouter)
from deepspeed_tpu_torch.serving.observability import (ObservabilitySpool,
                                                       read_spool_file)
from deepspeed_tpu_torch.serving.remote_replica import HeartbeatMonitor
from deepspeed_tpu_torch.serving.replica_server import ReplicaServerApp
from deepspeed_tpu_torch.serving.transport import (FrameError,
                                                   RemoteCallError,
                                                   RetryPolicy, RpcClient,
                                                   RpcServer,
                                                   TransportClosed,
                                                   TransportTimeout,
                                                   call_with_retry,
                                                   decode_frame,
                                                   encode_frame)
from deepspeed_tpu_torch.telemetry import Telemetry
from deepspeed_tpu_torch.testing import fabric as tfabric
from deepspeed_tpu_torch.testing.chaos import ChaosClock, kill_replica_process
from tests.torch_serving_twins import reset_mesh

FACTORY = "deepspeed_tpu_torch.testing.fabric:tiny_serving_engine"
BS = tfabric.BS


# ----------------------------------------------------------------------
# wire codec: byte-equal to the reference's
# ----------------------------------------------------------------------


def _messages(sch):
    req = sch.Request(uid="u-1", tokens=np.arange(37, dtype=np.int32),
                      max_new_tokens=9, eos_token_id=5, stop_on_eos=False,
                      deadline_ms=125.0, priority=2)
    done = sch.CompletedRequest(uid="u-1", prompt_len=37,
                                tokens=np.array([3, 1, 4], np.int32),
                                finish_reason="deadline",
                                cached_prefix_tokens=16,
                                timing={"first_token": 1.25, "finish": 2.5})
    return [
        {"verb": "submit",
         "payload": {"request": req, "hashes": [b"\x00\xffhash", b"h2"],
                     "done": [done], "deadline_in_s": 0.125, "none": None,
                     "nested": {"a": [1, 2.5, "s", True]}}},
        {"ok": True, "result": [done, done]},
        {"n": np.int64(7), "f": np.float32(1.5),
         "m": np.arange(6, dtype=np.float32).reshape(2, 3)},
        {"verb": "step", "payload": {}},
    ]


@pytest.mark.parametrize("i", range(4))
def test_frames_byte_equal_to_jax_and_decoded_by_either(i):
    tmsg, jmsg = _messages(__import__(
        "deepspeed_tpu_torch.inference.scheduler",
        fromlist=["Request"])), _messages(jsch)
    tframe, jframe = encode_frame(tmsg[i]), jtr.encode_frame(jmsg[i])
    assert tframe == jframe
    # the port decodes the reference's frame into the port's dataclasses,
    # and the other way round; re-encoding gives the same bytes
    tdec, jdec = decode_frame(jframe), jtr.decode_frame(tframe)
    assert encode_frame(tdec) == tframe and jtr.encode_frame(jdec) == jframe
    if i == 0:
        r = tdec["payload"]["request"]
        assert isinstance(r, Request) and r.deadline_ms == 125.0
        assert isinstance(tdec["payload"]["done"][0], CompletedRequest)
        assert isinstance(jdec["payload"]["request"], jsch.Request)
        assert tdec["payload"]["hashes"] == [b"\x00\xffhash", b"h2"]


def test_codec_truncated_and_garbage_frames():
    buf = encode_frame({"verb": "step", "payload": {}})
    with pytest.raises(FrameError, match="truncated"):
        decode_frame(buf[:-3])
    with pytest.raises(FrameError, match="truncated"):
        decode_frame(buf[:6])
    with pytest.raises(FrameError, match="garbage"):
        decode_frame(b"NOPE" + buf[4:])
    with pytest.raises(FrameError, match="garbage"):
        decode_frame(buf[:4] + (1 << 31).to_bytes(4, "big") + buf[8:])
    with pytest.raises(FrameError, match="garbage"):
        decode_frame(buf[:8] + b"\x00" * (len(buf) - 8))


# ----------------------------------------------------------------------
# retries (injected sleep + rng: no real waiting)
# ----------------------------------------------------------------------


def _policy(**kw):
    base = dict(max_retries=3, base_backoff_s=0.1, backoff_factor=2.0,
                max_backoff_s=10.0, jitter=0.0)
    base.update(kw)
    return RetryPolicy(**base)


@pytest.mark.parametrize("case", ["exhaust", "mid_budget", "jitter"])
def test_retry_schedule_equals_jax(case):
    def run(tr):
        calls, sleeps = [], []
        pol = dict(exhaust={}, mid_budget=dict(max_retries=5,
                                               max_backoff_s=0.15),
                   jitter=dict(max_retries=1, jitter=0.5))[case]
        base = dict(max_retries=3, base_backoff_s=0.1, backoff_factor=2.0,
                    max_backoff_s=10.0, jitter=0.0)
        base.update(pol)

        def flaky():
            calls.append(1)
            if case == "mid_budget" and len(calls) > 2:
                return "ok"
            raise tr.TransportTimeout("injected")

        try:
            out = tr.call_with_retry(flaky, idempotent=True,
                                     policy=tr.RetryPolicy(**base),
                                     sleep=sleeps.append,
                                     rng=lambda: 1.0 if case == "jitter"
                                     else 0.0)
        except tr.TransportTimeout:
            out = "raised"
        return out, len(calls), sleeps

    import deepspeed_tpu_torch.serving.transport as ttr
    out = run(ttr)
    assert out == run(jtr)
    assert out == {"exhaust": ("raised", 4, pytest.approx([0.1, 0.2, 0.4])),
                   "mid_budget": ("ok", 3, pytest.approx([0.1, 0.15])),
                   "jitter": ("raised", 2,
                              pytest.approx([0.15]))}[case]


def test_non_idempotent_and_remote_errors_never_retry():
    calls = []

    def closed():
        calls.append(1)
        raise TransportClosed("injected")

    with pytest.raises(TransportClosed):
        call_with_retry(closed, idempotent=False, policy=_policy(),
                        sleep=lambda s: pytest.fail("slept"),
                        rng=lambda: 0.0)

    def remote():
        calls.append(1)
        raise RemoteCallError("step", "ValueError", "engine-side bug")

    with pytest.raises(RemoteCallError):
        call_with_retry(remote, idempotent=True, policy=_policy(),
                        sleep=lambda s: None, rng=lambda: 0.0)
    assert len(calls) == 2


# ----------------------------------------------------------------------
# heartbeat liveness (injected clock + scripted beats)
# ----------------------------------------------------------------------


class _ScriptedBeats:
    def __init__(self, script=()):
        self.script = list(script)
        self.closed = False

    def drain(self):
        return self.script.pop(0) if self.script else (0, False)

    def close(self):
        self.closed = True


def test_heartbeat_miss_budget_eof_and_close():
    clk = ChaosClock()
    src = _ScriptedBeats()
    mon = HeartbeatMonitor(src, interval_s=1.0, miss_budget=3, clock=clk)
    src.script = [(1, False)]
    assert mon.check() and mon.beats == 1
    clk.advance(2.5)
    assert mon.check()
    src.script = [(2, False)]
    assert mon.check() and mon.beats == 3
    clk.advance(3.5)
    assert not mon.check() and "no heartbeat" in mon.dead_reason
    src.script = [(5, False)]
    assert not mon.check()                  # dead is sticky
    eof = HeartbeatMonitor(_ScriptedBeats([(0, True)]), interval_s=1.0,
                           miss_budget=100, clock=ChaosClock())
    assert not eof.check() and "EOF" in eof.dead_reason
    mon.close()
    assert src.closed


def test_declared_dead_replica_fails_fast_without_the_wire(echo_server):
    """A divergence from the reference: once the heartbeat budget declared
    a replica dead, every verb (the quarantine's drain, the post-mortem
    pull) raises at once instead of waiting out its call timeout on a
    stopped process."""
    from deepspeed_tpu_torch.serving.remote_replica import ReplicaDeadError
    rep = RemoteReplica(host=echo_server.host, port=echo_server.port,
                        replica_id="stopped", heartbeat=False,
                        config=RemoteConfig(call_timeout_s=30.0))
    rep._monitor = HeartbeatMonitor(_ScriptedBeats([(0, True)]),
                                    interval_s=1.0, miss_budget=4,
                                    clock=ChaosClock())
    assert not rep._monitor.check()
    calls = rep.transport_counters["calls"]
    t0 = time.monotonic()
    for verb in (rep.drain_queued, lambda: rep.observability_pull(0)):
        with pytest.raises(ReplicaDeadError, match="EOF"):
            verb()
    assert time.monotonic() - t0 < 1.0
    assert rep.transport_counters["calls"] == calls   # nothing was sent
    rep.close_transport()


# ----------------------------------------------------------------------
# bare RpcServer / RpcClient
# ----------------------------------------------------------------------


@pytest.fixture()
def echo_server():
    srv = RpcServer({
        "echo": lambda p: p,
        "boom": lambda p: (_ for _ in ()).throw(ValueError("server-side")),
        "slow": lambda p: time.sleep(p.get("s", 0.3)) or "late",
    }, heartbeat_interval_s=0.05)
    srv.serve_in_thread()
    yield srv
    srv.shutdown()


def test_rpc_round_trip_errors_timeouts_and_garbage(echo_server):
    c = RpcClient(echo_server.host, echo_server.port)
    assert c.call("echo", {"x": [1, 2], "b": b"\x01"}) == {"x": [1, 2],
                                                           "b": b"\x01"}
    with pytest.raises(RemoteCallError) as ei:
        c.call("boom", {})
    assert ei.value.err_type == "ValueError"
    with pytest.raises(RemoteCallError) as ei:
        c.call("no_such_verb", {})
    assert ei.value.err_type == "KeyError"
    with pytest.raises(TransportTimeout):
        c.call("slow", {"s": 0.5}, timeout_s=0.05)
    assert c._sock is None                   # the poisoned stream dropped
    assert c.call("echo", {"ok": 1}) == {"ok": 1}
    with socket.create_connection((echo_server.host,
                                   echo_server.port)) as s:
        s.sendall(b"GET / HTTP/1.1\r\n\r\n")
    assert c.call("echo", {"still": "serving"}) == {"still": "serving"}
    c.close()
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    with pytest.raises(TransportClosed):
        RpcClient("127.0.0.1", port, connect_timeout_s=0.5).call("echo", {})
    assert isinstance(TransportClosed("x"), ReplicaUnavailableError)


# ----------------------------------------------------------------------
# a transport-backed replica of the port's tiny engine (in-thread server)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def inf_engine():
    return tfabric.tiny_serving_engine(device="cpu").engine


def _prompts(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 200, (int(rng.integers(4, 24)),))
            .astype(np.int32) for _ in range(n)]


@pytest.fixture()
def remote_rep(inf_engine):
    app = ReplicaServerApp(inf_engine.serving(
        max_slots=2, max_context=96, prefill_chunk=BS,
        enable_prefix_caching=True), heartbeat_interval_s=0.1)
    app.server.serve_in_thread()
    rep = RemoteReplica(host=app.server.host, port=app.server.port,
                        replica_id="rem0",
                        config=RemoteConfig(heartbeat_interval_s=0.1,
                                            step_timeout_s=60.0))
    yield rep
    rep.close_transport()
    app.server.shutdown()


def test_remote_replica_token_parity_with_both_oracles(remote_rep):
    prompts = _prompts(5)
    router = ServingRouter(replicas=[remote_rep])
    done = router.run([Request(uid=i, tokens=p, max_new_tokens=6,
                               stop_on_eos=False)
                       for i, p in enumerate(prompts)])
    refs = tfabric.tiny_oracle(prompts, [6] * 5, device="cpu")
    reset_mesh()
    jrefs = jfabric.tiny_oracle(prompts, [6] * 5)
    for i in range(5):
        assert done[i].finish_reason == "length"
        assert np.array_equal(done[i].tokens, refs[i]), i
        assert np.array_equal(refs[i], np.asarray(jrefs[i])), i
    assert remote_rep.stats()["device"] == {"type": "cpu", "name": "cpu"}
    assert remote_rep.compile_stats() == {}
    assert remote_rep.memory_snapshot() is None


def test_remote_signals_compat_inadmissible_and_deadlines(remote_rep):
    assert remote_rep.queue_depth == 0 and remote_rep.num_active == 0
    assert remote_rep.has_free_slot and remote_rep.available_blocks > 0
    assert remote_rep.prefill_chunk == BS
    desc = remote_rep.compat_descriptor()
    assert desc["kv_block_size"] == BS and desc["kv_cache_dtype"] == "float32"
    with pytest.raises(InadmissibleRequestError):
        remote_rep.check_admissible(10_000, 64)
    hashes = remote_rep.hash_chain(np.arange(2 * BS, dtype=np.int32))
    assert hashes and all(isinstance(h, bytes) for h in hashes)
    assert remote_rep.affinity(hashes) == 0
    # the router's absolute deadline crosses as a remaining budget and is
    # re-anchored on the server's clock
    clk = ChaosClock(start=1000.0)
    remote_rep.set_clock(clk)
    prompt = np.arange(8, dtype=np.int32)
    remote_rep.submit(Request(uid="dl0", tokens=prompt, max_new_tokens=32,
                              stop_on_eos=False), deadline_at=1000.002)
    remote_rep.submit(Request(uid="dl1", tokens=prompt, max_new_tokens=4,
                              stop_on_eos=False), deadline_at=1060.0)
    done = {}
    for _ in range(200):
        for d in remote_rep.step():
            done[d.uid] = d
        if len(done) == 2:
            break
    assert done["dl0"].finish_reason == "deadline"
    assert done["dl1"].finish_reason == "length"
    with pytest.raises(NotImplementedError, match="cross-process"):
        remote_rep.export_handoff("dl1")


class _FakeCompat(ReplicaHandle):
    def __init__(self, rid, desc=None, unreachable=False):
        self.replica_id = rid
        self._desc = desc
        self._unreachable = unreachable

    def compat_descriptor(self):
        if self._unreachable:
            raise ReplicaUnavailableError("injected: host down")
        return self._desc


_DESC = {"fingerprint": "modelA", "kv_block_size": 16,
         "kv_cache_dtype": "float32", "kv_group_size": 0}


def test_pool_compat_gates_runtime_joins():
    router = ServingRouter(replicas=[_FakeCompat("a", dict(_DESC))])
    with pytest.raises(ValueError, match="different model"):
        router.add_replica(_FakeCompat("b", dict(_DESC,
                                                 fingerprint="modelB")))
    with pytest.raises(ValueError, match="kv_block_size"):
        router.add_replica(_FakeCompat("c", dict(_DESC, kv_block_size=32)))
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        router.add_replica(_FakeCompat("d", dict(_DESC,
                                                 kv_cache_dtype="int8")))
    router2 = ServingRouter(replicas=[_FakeCompat(
        "a", dict(_DESC, kv_cache_dtype="int8", kv_group_size=32))])
    with pytest.raises(ValueError, match="kv_group_size"):
        router2.add_replica(_FakeCompat(
            "e", dict(_DESC, kv_cache_dtype="int8", kv_group_size=64)))
    router2.add_replica(_FakeCompat(
        "b", dict(_DESC, kv_cache_dtype="int8", kv_group_size=32)))
    with pytest.raises(ValueError, match="unreachable at join"):
        router.add_replica(_FakeCompat("f", unreachable=True))
    assert list(router.replicas) == ["a"]


# ----------------------------------------------------------------------
# the observability spool
# ----------------------------------------------------------------------


def test_obs_spool_cursor_idempotence_overflow_and_file(tmp_path):
    tel = Telemetry(TelemetryConfig(enabled=True, prometheus=False,
                                    jsonl=False, output_path=str(tmp_path)),
                    subsystem="spooltest")
    path = tmp_path / "spooltest.obs.spool.jsonl"
    spool = ObservabilitySpool(path=path, capacity=4, telemetry=tel)
    for i in range(10):
        spool.append("span", {"span": i, "name": f"s{i}"})
    out = spool.pull(0)
    assert out["cursor"] == 10 and out["dropped"] == 6
    assert [it["cursor"] for it in out["items"]] == [7, 8, 9, 10]
    assert spool.pull(0) == out
    assert [it["cursor"] for it in spool.pull(8)["items"]] == [9, 10]
    assert tel.registry.snapshot()["obs/spool_dropped"]["value"] == 6
    assert [it["cursor"] for it in read_spool_file(path)] == \
        list(range(1, 11))
    assert read_spool_file(path, after_cursor=8)[0]["cursor"] == 9
    with open(path, "a") as f:
        f.write('{"cursor": 99, "kind": "span"')
    assert [it["cursor"] for it in read_spool_file(path)][-1] == 10
    for i in range(10, 40):
        spool.append("flight", {"seq": i})
    disk = read_spool_file(path)
    assert disk[-1]["cursor"] == 40
    assert len(disk) <= 4 * spool.capacity + 1
    tel.close()


# ----------------------------------------------------------------------
# the one subprocess test: SIGKILL a replica process mid-trace
# ----------------------------------------------------------------------


def test_kill9_two_cpu_processes_exactly_once_and_parity():
    """Two replica-server processes of the port's tiny engine on the CPU
    (`device="cpu"` through `--kwargs`); one is SIGKILLed while it owns
    work. Every request completes exactly once with the oracle's tokens,
    detection comes from the wire (EOF / heartbeat) well inside the 300 s
    step timeout, and the budget respawns the victim."""
    cfg = RemoteConfig(heartbeat_interval_s=0.2, heartbeat_miss_budget=4,
                       step_timeout_s=300.0)
    procs = [ReplicaProcess(factory=FACTORY,
                            factory_kwargs={"device": "cpu"},
                            heartbeat_interval_s=0.2,
                            replica_id=f"r{i}").spawn() for i in range(2)]
    handles = []
    try:
        for i, p in enumerate(procs):
            p.wait_ready(120)
            handles.append(RemoteReplica(process=p, replica_id=f"r{i}",
                                         config=cfg))
        assert all(h.stats()["device"]["type"] == "cpu" for h in handles)
        router = ServingRouter(replicas=handles, max_replica_restarts=1,
                               restart_backoff_s=0.0)
        prompts = _prompts(8, seed=11)
        for i, p in enumerate(prompts):
            router.submit(Request(uid=i, tokens=p, max_new_tokens=6,
                                  stop_on_eos=False))
        out, counts, killed, t_kill, t_detect = {}, {}, False, None, None
        t0 = time.monotonic()
        while router.in_flight or router._finished_buf:
            assert time.monotonic() - t0 < 120, "soak wedged"
            for d in router.step():
                out[d.uid] = d
                counts[d.uid] = counts.get(d.uid, 0) + 1
            if not killed and any(rec.replica == "r0"
                                  for rec in router._pending.values()):
                kill_replica_process(handles[0], signal.SIGKILL)
                t_kill, killed = time.monotonic(), True
            if killed and t_detect is None \
                    and router.counters["replica_failures"] >= 1:
                t_detect = time.monotonic()
        assert killed
        assert sorted(out) == list(range(8)) and set(counts.values()) == {1}
        assert router.counters["replica_failures"] == 1
        assert router.counters["reroutes"] >= 1
        assert router.counters["replica_restarts"] == 1
        assert t_detect is not None and t_detect - t_kill < 30.0
        refs = tfabric.tiny_oracle(prompts, [6] * 8, device="cpu")
        for i in range(8):
            assert out[i].finish_reason == "length"
            assert np.array_equal(out[i].tokens, refs[i]), i
        assert router.stats()["replicas"]["r0"]["health"] == "up"
    finally:
        for h in handles:
            h.close()
        for p in procs:
            p.kill()
            p.wait()
