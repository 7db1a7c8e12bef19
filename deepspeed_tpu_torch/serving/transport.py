"""Stdlib-only RPC transport for process-separated serving replicas
(counterpart of `deepspeed_tpu/serving/transport.py`: the same frames, byte
for byte, so either package decodes the other's).

The router speaks `ReplicaHandle` (serving/replica.py); everything an
in-process replica answers from attribute reads, a remote one must answer
over a wire. This module is that wire, built from nothing but the standard
library so a replica process needs no dependency the engine itself doesn't:

  * **frames** — every message is `MAGIC(4) | length(4, big-endian) | body`,
    body = JSON with tagged extension objects for the payloads JSON cannot
    carry natively: numpy arrays (token prompts, completions), raw bytes
    (prefix-cache hash chains), and the `Request`/`CompletedRequest`
    dataclasses. A frame that ends early decodes to a "truncated" error and
    one that starts with the wrong magic to a "garbage" error — the codec
    never guesses at a desynced stream;
  * **RpcClient** — one socket, one in-flight call (the router is
    single-threaded by design), per-call timeouts via `settimeout`. A
    timeout poisons the connection (the reply may still arrive later and
    desync the stream), so the client closes and reconnects lazily;
  * **retry** — `call_with_retry` wraps transient transport failures in
    bounded retries with exponential backoff + jitter, for IDEMPOTENT verbs
    only: a lost `stats` reply is safely re-asked, a lost `submit` reply is
    not (the server may have enqueued it) — non-idempotent verbs surface
    the first failure to the caller, whose failover path (router
    quarantine) already handles at-most-once delivery;
  * **RpcServer** — the replica process side: accepts connections whose
    first frame declares a role (`rpc` request/reply loop, or `heartbeat`,
    a push-only stream of beat frames from a dedicated thread). Heartbeats
    prove the PROCESS is alive — they keep flowing while the engine is busy
    inside a long step, and stop the instant the process is killed (the
    socket EOFs) or the OS stops scheduling it. A live process with a
    wedged engine is the hung-replica watchdog's job, not the heartbeat's.

Every duration knob is data, not a clock read: the transport itself never
calls the wall clock (timeouts ride `socket.settimeout`; retry sleeps are
injectable) so the layers above keep the chaos-testable injected-clock
discipline.
"""

import dataclasses
import json
import random
import socket
import struct
import threading
import time
from base64 import b64decode, b64encode
from typing import Any, Callable, Dict, Optional

import numpy as np

from deepspeed_tpu_torch.serving.replica import ReplicaUnavailableError

MAGIC = b"DSFB"                  # DeepSpeed-tpu Serving FaBric
_HEADER = struct.Struct(">4sI")
MAX_FRAME_BYTES = 256 * 1024 * 1024   # one frame must fit a prompt + pool
                                      # snapshot, not a checkpoint


class TransportError(ReplicaUnavailableError):
    """Base for every wire failure. Subclasses `ReplicaUnavailableError` so
    the router treats any of these like a replica it cannot reach —
    quarantine + reroute, never a crash of the routing loop."""


class FrameError(TransportError):
    """The byte stream is not a valid frame: truncated mid-frame, wrong
    magic (garbage / protocol mismatch), or an absurd declared length."""


class TransportTimeout(TransportError):
    """The per-call deadline expired waiting on the socket."""


class TransportClosed(TransportError):
    """The peer hung up (EOF / reset) — for a replica process, usually the
    moment it died."""


class RemoteCallError(RuntimeError):
    """The VERB ran remotely and raised: the server caught the exception
    and shipped `{type, message}` home. Deliberately NOT a TransportError —
    the wire worked; the caller decides what the remote failure means."""

    def __init__(self, verb: str, err_type: str, message: str):
        super().__init__(f"remote {verb} raised {err_type}: {message}")
        self.verb = verb
        self.err_type = err_type
        self.remote_message = message


# ----------------------------------------------------------------------
# codec: JSON + tagged extensions
# ----------------------------------------------------------------------

def _pack(obj):
    """Recursively rewrite payloads into JSON-safe tagged forms."""
    # the dataclasses' module is imported lazily (in _unpack): the codec
    # stays usable without the scheduler until a dataclass shows up
    if isinstance(obj, np.ndarray):
        return {"__nd__": [str(obj.dtype), list(obj.shape),
                           b64encode(np.ascontiguousarray(obj).tobytes())
                           .decode("ascii")]}
    if isinstance(obj, (bytes, bytearray)):
        return {"__by__": b64encode(bytes(obj)).decode("ascii")}
    if isinstance(obj, np.generic):
        return obj.item()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        tag = {"Request": "__req__", "CompletedRequest": "__done__"}.get(
            type(obj).__name__)
        if tag is None:
            raise TypeError(f"codec cannot ship dataclass "
                            f"{type(obj).__name__} (add a tag for it)")
        return {tag: {f.name: _pack(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {str(k): _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pack(v) for v in obj]
    return obj


def _unpack(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj and len(obj) == 1:
            dtype, shape, data = obj["__nd__"]
            return np.frombuffer(b64decode(data),
                                 dtype=np.dtype(dtype)).reshape(shape).copy()
        if "__by__" in obj and len(obj) == 1:
            return b64decode(obj["__by__"])
        if "__req__" in obj and len(obj) == 1:
            from deepspeed_tpu_torch.inference.scheduler import Request
            return Request(**{k: _unpack(v)
                              for k, v in obj["__req__"].items()})
        if "__done__" in obj and len(obj) == 1:
            from deepspeed_tpu_torch.inference.scheduler import CompletedRequest
            return CompletedRequest(**{k: _unpack(v)
                                       for k, v in obj["__done__"].items()})
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v) for v in obj]
    return obj


def encode_frame(obj: Any) -> bytes:
    body = json.dumps(_pack(obj), separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise FrameError(f"frame body {len(body)}B exceeds the "
                         f"{MAX_FRAME_BYTES}B cap")
    return _HEADER.pack(MAGIC, len(body)) + body


def decode_frame(buf: bytes) -> Any:
    """Decode ONE complete frame from `buf` (exact size — the socket layer
    already read the header and body). Raises `FrameError` on garbage."""
    if len(buf) < _HEADER.size:
        raise FrameError(f"truncated frame: {len(buf)}B is shorter than "
                         f"the {_HEADER.size}B header")
    magic, length = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise FrameError(f"garbage frame: bad magic {magic!r} "
                         f"(expected {MAGIC!r})")
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"garbage frame: declared length {length}B "
                         f"exceeds the {MAX_FRAME_BYTES}B cap")
    body = buf[_HEADER.size:]
    if len(body) != length:
        raise FrameError(f"truncated frame: header declares {length}B, "
                         f"got {len(body)}B")
    try:
        return _unpack(json.loads(body.decode("utf-8")))
    except (ValueError, UnicodeDecodeError) as e:
        raise FrameError(f"garbage frame body: {e}") from None


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except socket.timeout:
            raise TransportTimeout(
                f"timed out mid-frame ({got}/{n}B)") from None
        except OSError as e:
            raise TransportClosed(f"socket error mid-frame: {e}") from None
        if not chunk:
            if got == 0:
                raise TransportClosed("peer closed the connection")
            raise FrameError(f"truncated frame: peer closed after "
                             f"{got}/{n}B")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_frame(sock: socket.socket, obj: Any):
    try:
        sock.sendall(encode_frame(obj))
    except socket.timeout:
        raise TransportTimeout("timed out sending frame") from None
    except OSError as e:
        raise TransportClosed(f"send failed: {e}") from None


def recv_frame(sock: socket.socket) -> Any:
    header = _recv_exact(sock, _HEADER.size)
    magic, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameError(f"garbage frame: bad magic {magic!r} "
                         f"(expected {MAGIC!r})")
    if length > MAX_FRAME_BYTES:
        raise FrameError(f"garbage frame: declared length {length}B "
                         f"exceeds the {MAX_FRAME_BYTES}B cap")
    return decode_frame(header + _recv_exact(sock, length))


# ----------------------------------------------------------------------
# retry policy (idempotent verbs only)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries for transient transport failures. Backoff before
    attempt #n (n>=1 retries) is ``min(base * factor**(n-1), max)`` scaled
    by ``1 + jitter*U[0,1)`` — the same shape `elasticity/restart_policy`
    uses, scaled down to RPC cadence."""
    max_retries: int = 2
    base_backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.25

    def delay(self, attempt: int, rng: Callable[[], float]) -> float:
        if self.base_backoff_s <= 0:
            return 0.0
        d = min(self.base_backoff_s *
                (self.backoff_factor ** max(attempt - 1, 0)),
                self.max_backoff_s)
        return d * (1.0 + self.jitter * rng())


def call_with_retry(fn: Callable[[], Any], idempotent: bool,
                    policy: RetryPolicy, sleep: Callable[[float], None] = None,
                    rng: Callable[[], float] = None,
                    on_retry: Callable[[int, Exception], None] = None) -> Any:
    """Run `fn`, retrying `TransportError`s up to `policy.max_retries`
    times — but only when `idempotent`: a verb whose side effect may have
    landed before the reply was lost must fail loudly instead (at-most-once;
    the router's quarantine path owns recovery). `sleep`/`rng` are
    injectable so the retry schedule is unit-testable without real waits."""
    sleep = sleep if sleep is not None else time.sleep
    rng = rng if rng is not None else random.random
    attempt = 0
    while True:
        try:
            return fn()
        except TransportError:
            attempt += 1
            if not idempotent or attempt > policy.max_retries:
                raise
            if on_retry is not None:
                on_retry(attempt, None)
            sleep(policy.delay(attempt, rng))


# ----------------------------------------------------------------------
# client
# ----------------------------------------------------------------------

class RpcClient:
    """One request/reply connection to a replica server.

    Lazy-connects on first call and reconnects after any failure (a timed-
    out call poisons the stream: the stale reply could otherwise be read as
    the answer to the NEXT verb). Not thread-safe by design — the router
    drives each replica from one thread; a second observer (the pool CLI)
    opens its own client."""

    def __init__(self, host: str, port: int, connect_timeout_s: float = 5.0,
                 default_timeout_s: float = 30.0):
        self.host = host
        self.port = int(port)
        self.connect_timeout_s = float(connect_timeout_s)
        self.default_timeout_s = float(default_timeout_s)
        self._sock: Optional[socket.socket] = None

    def _connect(self) -> socket.socket:
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.connect_timeout_s)
        except socket.timeout:
            raise TransportTimeout(
                f"connect to {self.host}:{self.port} timed out") from None
        except OSError as e:
            raise TransportClosed(
                f"connect to {self.host}:{self.port} failed: {e}") from None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            send_frame(sock, {"hello": "rpc"})
        except TransportError:
            sock.close()
            raise
        return sock

    def call(self, verb: str, payload: Optional[Dict[str, Any]] = None,
             timeout_s: Optional[float] = None) -> Any:
        if self._sock is None:
            self._sock = self._connect()
        sock = self._sock
        sock.settimeout(timeout_s if timeout_s is not None
                        else self.default_timeout_s)
        try:
            send_frame(sock, {"verb": verb, "payload": payload or {}})
            reply = recv_frame(sock)
        except TransportError:
            self.close()                 # the stream is desynced: reconnect
            raise
        if not isinstance(reply, dict) or ("ok" not in reply
                                           and "err" not in reply):
            self.close()
            raise FrameError(f"malformed reply to {verb!r}: {reply!r}")
        if "err" in reply:
            err = reply["err"]
            raise RemoteCallError(verb, err.get("type", "Exception"),
                                  err.get("message", ""))
        return reply["ok"]

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


# ----------------------------------------------------------------------
# server (the replica-process side)
# ----------------------------------------------------------------------

class RpcServer:
    """Serve one `ServingEngine` over the fabric wire.

    `verbs` maps verb name -> callable(payload_dict) -> result. A verb that
    raises ships `{type, message}` home as an error reply (the client
    re-raises `RemoteCallError`); transport failures on one connection
    never take the server down. Engine access is serialized by one lock so
    an observer connection (pool CLI `--status`) can read stats while the
    router drives steps.

    Heartbeat connections get a dedicated sender thread pushing
    ``{"beat": n, "interval_s": i}`` every `heartbeat_interval_s`,
    independent of the engine lock — the beat stream answers "is the
    process alive", nothing more."""

    def __init__(self, verbs: Dict[str, Callable[[Dict[str, Any]], Any]],
                 host: str = "127.0.0.1", port: int = 0,
                 heartbeat_interval_s: float = 0.5):
        self.verbs = verbs
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self.host, self.port = self._listener.getsockname()[:2]
        self._threads = []

    def serve_forever(self):
        """Accept loop; returns after `shutdown()` (e.g. from the "shutdown"
        verb handler). Each connection runs in its own thread."""
        self._listener.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._listener.close()

    def serve_in_thread(self) -> threading.Thread:
        """Test/CLI convenience: run the accept loop in a daemon thread."""
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._stop.set()

    def _handle(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            hello = recv_frame(conn)
        except TransportError:
            conn.close()
            return
        role = hello.get("hello") if isinstance(hello, dict) else None
        if role == "heartbeat":
            self._heartbeat_loop(conn)
        elif role == "rpc":
            self._rpc_loop(conn)
        else:
            try:
                send_frame(conn, {"err": {"type": "FrameError",
                                          "message": f"bad hello {hello!r}"}})
            except TransportError:
                pass
            conn.close()

    def _heartbeat_loop(self, conn: socket.socket):
        n = 0
        while not self._stop.is_set():
            try:
                send_frame(conn, {"beat": n,
                                  "interval_s": self.heartbeat_interval_s})
            except TransportError:
                break                    # monitor went away; that's its call
            n += 1
            if self._stop.wait(self.heartbeat_interval_s):
                break
        conn.close()

    def _rpc_loop(self, conn: socket.socket):
        while not self._stop.is_set():
            try:
                msg = recv_frame(conn)
            except TransportError:
                break
            verb = msg.get("verb") if isinstance(msg, dict) else None
            fn = self.verbs.get(verb)
            if fn is None:
                reply = {"err": {"type": "KeyError",
                                 "message": f"unknown verb {verb!r}"}}
            else:
                try:
                    with self._lock:
                        reply = {"ok": fn(msg.get("payload") or {})}
                except Exception as e:   # ship EVERY verb failure home
                    reply = {"err": {"type": type(e).__name__,
                                     "message": str(e)[:2000]}}
            try:
                send_frame(conn, reply)
            except TransportError:
                break
            if verb == "shutdown":
                self._stop.set()
        conn.close()
