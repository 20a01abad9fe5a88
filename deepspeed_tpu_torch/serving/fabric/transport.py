"""Length-prefixed socket RPC transport for the serving fabric.

Counterpart of ``deepspeed_tpu/serving/fabric/transport.py``: the same
frames, threads and lock ranks. Frame bodies are read into a
``bytearray``, so the codec's buffers decode as writable views over it.
No transport thread touches CUDA.

One TCP connection per (frontend, replica server) pair carries three
message shapes, every one a codec frame (fabric/codec.py) behind a
``u32`` length prefix:

- **calls** ``{"t": "call", "id", "m", "p"}`` answered by
  ``{"t": "resp", "id", "p"}`` or ``{"t": "err", "id", "error"}`` —
  multiplexed: many calls may be in flight, matched by id;
- **notifies** ``{"t": "ev", ...}`` — one-way, both directions (token
  streams, status updates, cancellation);
- **heartbeats** ``{"t": "ping", "ts"}`` / ``{"t": "pong", "echo",
  "peer_ts"}`` — liveness, plus a peer clock-offset estimate from the
  round-trip (``clock_offset_s``; the fields are optional so legacy
  bare pings interoperate). *Any* received frame refreshes the
  peer-liveness clock; an idle, healthy connection stays alive on
  pings alone.

Threading model (docs/CONCURRENCY.md): a writer thread owns the socket's
send side and drains a plain ``queue.Queue`` outbox — no ranked lock is
ever held across socket I/O — and a reader thread owns the receive side,
resolving call responses under the ``serving.fabric.transport`` lock and
dispatching events with **no** lock held (handlers take their own,
higher-level locks). Connection death is a single idempotent
transition: pending calls fail with :class:`ConnectionLost`, the
``on_close`` hook fires exactly once, and ``alive`` goes false — the
caller (RemoteHandle) maps that to a DEAD replica.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ...utils.locks import RankedLock
from ...utils.logging import logger
from . import chaos as _chaos
from .chaos import ChaosKill
from .codec import (CodecError, FrameCorrupt, FrameTooLarge,  # noqa: F401
                    decode_frame, encode_frame)

_LEN_FMT = ">I"
_LEN_SIZE = struct.calcsize(_LEN_FMT)

#: how many heartbeat intervals may pass without ANY received frame
#: before the peer is presumed dead
STALE_HEARTBEATS = 3.0

#: floor on the staleness window regardless of heartbeat cadence: a
#: healthy peer's event loop legitimately pauses for SECONDS while it
#: builds a kernel at first use (the wedge-timeout lesson, docs/
#: SERVING.md), and reading that as death would kill replicas exactly
#: when they warm up. A *closed* socket is detected instantly by the
#: reader thread regardless — staleness only backstops silent half-open
#: connections (network partitions, frozen hosts), where seconds of
#: extra latency are the right trade.
STALE_FLOOR_S = 10.0

#: clock-offset samples older than this are replaced by the next pong
#: even at a worse RTT — monotonic clocks don't jump, but a one-shot
#: minimum-RTT sample from hours ago shouldn't pin the estimate forever
CLOCK_OFFSET_MAX_AGE_S = 60.0


class FabricError(Exception):
    """Base of the transport-level failure surface."""


class RPCTimeout(FabricError):
    """A call's deadline passed with no response (the connection may
    still be alive — slow peer vs dead peer is the caller's policy)."""


class ConnectionLost(FabricError):
    """The connection died (socket error, EOF, protocol violation, or
    explicit close) — a dead connection is a dead replica."""


def parse_address(addr: str) -> Tuple[str, int]:
    """``host:port`` -> tuple; the one address syntax fabric accepts."""
    host, sep, port = addr.rpartition(":")
    if not sep or not host:
        raise ValueError(f"fabric address {addr!r} is not host:port")
    return host, int(port)


def _routable_ip() -> str:
    """This host's routable IP: the first non-loopback IPv4 address of
    ``hostname -I``, else what the resolver gives for the host name
    (single-host setups, where loopback is fine). The JAX package's
    ``comm.comm._routable_ip`` also asks the kernel which interface would
    route to an outside address; the port does not."""
    import subprocess

    try:
        out = subprocess.run(["hostname", "-I"], capture_output=True,
                             text=True, timeout=5)
        for ip in out.stdout.split():
            if not ip.startswith("127.") and ":" not in ip:
                return ip
    except (OSError, subprocess.SubprocessError):
        pass
    return socket.gethostbyname(socket.gethostname())


def advertised_address(listen_host: str, port: int) -> str:
    """The address peers should dial for a server bound to
    ``listen_host:port``. Wildcard/loopback binds advertise the host's
    routable IP (:func:`_routable_ip`): a multi-host fleet rendezvousing
    on 127.0.0.1 would connect every frontend to its own loopback."""
    if listen_host in ("", "0.0.0.0", "::", "localhost") \
            or listen_host.startswith("127."):
        return f"{_routable_ip()}:{port}"
    return f"{listen_host}:{port}"


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytearray]:
    """n bytes or None on clean EOF; raises OSError on socket failure."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            return None
        got += k
    return buf


def recv_frame(sock: socket.socket,
               max_frame_bytes: int = 0) -> Optional[bytearray]:
    """One length-prefixed frame body, None on clean EOF. An announced
    length over ``max_frame_bytes`` raises :class:`FrameTooLarge`
    BEFORE any allocation — an oversized (or garbage-length) frame must
    be refused, not buffered."""
    head = _recv_exact(sock, _LEN_SIZE)
    if head is None:
        return None
    (length,) = struct.unpack(_LEN_FMT, head)
    if max_frame_bytes and length > max_frame_bytes:
        raise FrameTooLarge(length, max_frame_bytes)
    body = _recv_exact(sock, length)
    if body is None:
        raise ConnectionLost("EOF inside a fabric frame")
    return body


def send_frame(sock: socket.socket, body: bytes) -> None:
    sock.sendall(struct.pack(_LEN_FMT, len(body)) + body)


class Connection:
    """One framed, multiplexed fabric connection (either side)."""

    # lock discipline (docs/CONCURRENCY.md): the pending-call table and
    # id counter move under the transport lock; the dead flag is
    # writes-only guarded (its readers — alive checks on hot paths —
    # take lock-free last-write-wins snapshots by design). Socket I/O
    # NEVER happens under the lock: sends ride the writer thread's
    # outbox queue, receives live on the reader thread.
    _GUARDED_BY = {
        "_pending": "_lock",
        "_next_id": "_lock",
        "_dead": "_lock:writes",
    }

    def __init__(self, sock: socket.socket, *, max_frame_bytes: int = 0,
                 heartbeat_s: float = 0.0,
                 on_event: Optional[Callable[[dict], None]] = None,
                 on_close: Optional[Callable[[str], None]] = None,
                 on_corrupt: Optional[Callable[[], None]] = None,
                 name: str = "fabric"):
        self.name = name
        self.max_frame_bytes = int(max_frame_bytes)
        # SEND bound, negotiated down to the peer's receive bound in the
        # hello exchange (0 = use max_frame_bytes). Catching an
        # oversized payload at ENCODE keeps the typed degrade path
        # (drop to re-prefill); a receiver-side FrameTooLarge kills the
        # whole connection, which after negotiation only a
        # non-conforming peer can trigger.
        self.send_max_bytes = 0
        # CRC frame sealing (docs/SERVING.md "Fleet fault tolerance"),
        # hello-negotiated per direction: crc_tx seals outgoing frames
        # (codec v2 trailer), crc_rx records that the PEER seals — which
        # widens undecodable-frame handling on this link from
        # connection-death to the single-frame corrupt refusal (framing
        # survives bit damage because the trailer proves it). Both stay
        # False against old peers: the unsealed wire shape byte for byte.
        self.crc_tx = False
        self.crc_rx = False
        #: frames refused by the corrupt-frame path (reader-confined)
        self.frames_corrupt = 0
        self.heartbeat_s = float(heartbeat_s)
        self._sock = sock
        self._on_event = on_event
        self._on_close = on_close
        self._on_corrupt = on_corrupt
        # network chaos shim (fabric/chaos.py): None unless an installed
        # injector schedule matches this connection's name — the
        # historical branch-free path when chaos is off (asserted)
        self._chaos = _chaos.attach(name)
        self._lock = RankedLock("serving.fabric.transport")
        self._pending: Dict[int, dict] = {}
        self._next_id = 0
        self._dead = False
        self._close_reason = ""
        self._last_rx = time.monotonic()
        # (offset_s, rtt_s, t_sampled): remote-minus-local monotonic
        # clock estimate from heartbeat round-trips. Written only by the
        # reader thread, read lock-free elsewhere (the _last_rx idiom) —
        # a single-tuple swap is atomic under the GIL.
        self._clk = (0.0, float("inf"), 0.0)
        self._outbox: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"{name}-reader")
        self._writer = threading.Thread(target=self._write_loop, daemon=True,
                                        name=f"{name}-writer")
        self._beater = None
        if self.heartbeat_s > 0:
            self._beater = threading.Thread(target=self._beat_loop,
                                            daemon=True,
                                            name=f"{name}-heartbeat")

    def start(self) -> None:
        self._reader.start()
        self._writer.start()
        if self._beater is not None:
            self._beater.start()

    # ------------------------------------------------------------ liveness
    @property
    def alive(self) -> bool:
        """False once the socket died OR the peer went silent past the
        stale window (``max(STALE_FLOOR_S, STALE_HEARTBEATS ×
        heartbeat_s)`` — the floor keeps routine kernel-build pauses from
        reading as death). Any received frame — response, event, ping,
        pong — counts as liveness."""
        if self._dead:
            return False
        if self.heartbeat_s > 0:
            stale = max(STALE_FLOOR_S, STALE_HEARTBEATS * self.heartbeat_s)
            if time.monotonic() - self._last_rx > stale:
                return False
        return True

    @property
    def rx_idle_s(self) -> float:
        """Seconds since a frame ACTUALLY arrived (chaos-discarded
        frames never refresh this) — the federation seat-lease sweep's
        staleness input."""
        return time.monotonic() - self._last_rx

    @property
    def close_reason(self) -> str:
        return self._close_reason

    @property
    def clock_offset_s(self) -> float:
        """Best-estimate PEER-minus-LOCAL monotonic clock offset, from
        timestamped heartbeat round-trips (``peer_ts - (t0+t3)/2`` —
        NTP's symmetric-delay assumption, good to ~RTT/2). 0.0 until the
        first timestamped pong (an old peer never sends one). Remote
        span timestamps rebase as ``t_local = t_remote - offset``."""
        return self._clk[0]

    @property
    def clock_offset_rtt_s(self) -> Optional[float]:
        """RTT of the sample behind :attr:`clock_offset_s` (its error
        bound), or None before the first timestamped pong."""
        rtt = self._clk[1]
        return None if rtt == float("inf") else rtt

    # ------------------------------------------------------------- sending
    def send(self, msg: dict) -> None:
        """One-way notify. Raises :class:`FrameTooLarge` synchronously
        when the encoded message breaks the frame bound (the caller
        degrades — e.g. drops a KV payload to the re-prefill fallback);
        raises :class:`ConnectionLost` on a dead connection."""
        if self._dead:
            raise ConnectionLost(self._close_reason or "connection closed")
        self._outbox.put(encode_frame(
            msg, self.send_max_bytes or self.max_frame_bytes,
            crc=self.crc_tx))

    def call(self, method: str, payload: Optional[dict] = None,
             timeout_s: float = 30.0) -> Any:
        """Request/response with deadline. Raises :class:`RPCTimeout`
        after ``timeout_s`` with no answer, :class:`ConnectionLost` if
        the connection dies first, and re-raises a remote error surface
        as :class:`FabricError`."""
        slot = {"done": threading.Event(), "resp": None, "error": None}
        with self._lock:
            if self._dead:
                raise ConnectionLost(self._close_reason
                                     or "connection closed")
            self._next_id += 1
            call_id = self._next_id
            self._pending[call_id] = slot
        try:
            self.send({"t": "call", "id": call_id, "m": method,
                       "p": payload or {}})
        except FabricError:
            with self._lock:
                self._pending.pop(call_id, None)
            raise
        if not slot["done"].wait(timeout_s):
            with self._lock:
                self._pending.pop(call_id, None)
            raise RPCTimeout(f"{self.name}: {method} timed out "
                             f"after {timeout_s}s")
        if slot["error"] is not None:
            err = slot["error"]
            if isinstance(err, FabricError):
                raise err
            raise FabricError(f"{method} failed remotely: {err}")
        return slot["resp"]

    def respond(self, call_id: int, payload: Any = None,
                error: Optional[str] = None) -> None:
        """Server-side answer to a received call."""
        if error is not None:
            self.send({"t": "err", "id": call_id, "error": str(error)})
        else:
            self.send({"t": "resp", "id": call_id, "p": payload})

    # --------------------------------------------------------------- loops
    def _write_loop(self) -> None:
        while True:
            body = self._outbox.get()
            if body is None:
                return
            try:
                if self._chaos is not None:
                    self._chaos.send(self._sock, body)
                else:
                    send_frame(self._sock, body)
            except ChaosKill as e:
                self._die(f"chaos: {e}")
                return
            except OSError as e:
                self._die(f"send failed: {e!r}")
                return

    def _read_loop(self) -> None:
        while not self._dead:
            try:
                body = recv_frame(self._sock, self.max_frame_bytes)
            except (OSError, CodecError, ConnectionLost) as e:
                self._die(f"recv failed: {e!r}")
                return
            if body is None:
                self._die("peer closed")
                return
            if self._chaos is not None:
                try:
                    bodies = self._chaos.recv(body)
                except ChaosKill as e:
                    self._die(f"chaos: {e}")
                    return
                if not bodies:
                    # blackholed/partitioned frame: as far as this
                    # endpoint knows it never arrived — liveness is NOT
                    # refreshed, so the staleness detector sees the
                    # half-open link exactly like a silent peer
                    continue
            else:
                bodies = (body,)
            self._last_rx = time.monotonic()
            for body in bodies:
                if not self._handle_body(body):
                    return

    def _handle_body(self, body: bytes) -> bool:
        """Decode and dispatch one frame body; False when the connection
        died (the reader loop must exit)."""
        try:
            msg = decode_frame(body)
            if not isinstance(msg, dict):
                raise CodecError(f"fabric message is a "
                                 f"{type(msg).__name__}, not an "
                                 "object")
        except FrameCorrupt as e:
            self._refuse_corrupt(repr(e))
            return True
        except CodecError as e:
            if self.crc_rx:
                # the peer seals every frame on this link, so an
                # unparsable one is bit damage (a flip inside the header
                # JSON breaks parsing before the trailer check can vouch
                # for it) — same single-frame refusal, connection intact
                self._refuse_corrupt(repr(e))
                return True
            # a frame this end cannot parse means the two sides no
            # longer speak the same protocol — kill the connection
            # (typed, logged), never limp on with garbage
            self._die(f"undecodable frame: {e!r}")
            return False
        except Exception as e:  # pragma: no cover - last resort
            # the codec's contract is typed errors only, but a
            # surprise here must still take the dead-connection
            # transition, never silently lose the reader thread
            self._die(f"frame decode crashed: {e!r}")
            return False
        self._handle(msg)
        return True

    def _refuse_corrupt(self, detail: str) -> None:
        """Partition-tolerant refusal (docs/SERVING.md "Fleet fault
        tolerance"): drop ONE damaged frame — typed, counted — and keep
        the connection. The lost frame is owned by its higher layer
        (call timeout, next status tick, failover); killing the link
        would fail every in-flight stream on it."""
        self.frames_corrupt += 1
        logger.warning(f"{self.name}: corrupt frame refused ({detail})")
        if self._on_corrupt is not None:
            try:
                self._on_corrupt()
            except Exception:   # pragma: no cover - defensive
                pass

    def _handle(self, msg: dict) -> None:
        kind = msg.get("t")
        if kind == "ping":
            # echo the sender's timestamp plus our own clock so the
            # pinger can estimate our clock offset; a bare legacy ping
            # gets a bare pong (optional-field compat, codec.py)
            pong = {"t": "pong"}
            ts = msg.get("ts")
            if isinstance(ts, (int, float)):
                pong["echo"] = ts
                pong["peer_ts"] = time.monotonic()
            try:
                self.send(pong)
            except FabricError:
                pass
            return
        if kind == "pong":
            echo, peer_ts = msg.get("echo"), msg.get("peer_ts")
            if isinstance(echo, (int, float)) \
                    and isinstance(peer_ts, (int, float)):
                t3 = time.monotonic()
                rtt = max(0.0, t3 - float(echo))
                off = float(peer_ts) - (float(echo) + t3) / 2.0
                _, best_rtt, best_t = self._clk
                # keep the tightest-RTT sample (smallest error bound),
                # but age it out so the estimate tracks slow drift
                if rtt <= best_rtt or t3 - best_t > CLOCK_OFFSET_MAX_AGE_S:
                    self._clk = (off, rtt, t3)
            return
        if kind in ("resp", "err"):
            with self._lock:
                slot = self._pending.pop(msg.get("id"), None)
            if slot is not None:
                if kind == "err":
                    slot["error"] = msg.get("error", "unknown remote error")
                else:
                    slot["resp"] = msg.get("p")
                slot["done"].set()
            return
        # calls and events dispatch with NO transport lock held — the
        # handler is free to take its own (higher-ranked) locks
        if self._on_event is not None:
            try:
                self._on_event(msg)
            except Exception as e:  # pragma: no cover - defensive
                logger.error(f"{self.name}: event handler failed: {e!r}")

    def _beat_loop(self) -> None:
        while not self._dead:
            time.sleep(self.heartbeat_s)
            if self._dead:
                return
            try:
                self.send({"t": "ping", "ts": time.monotonic()})
            except FabricError:
                return

    # ------------------------------------------------------------ teardown
    def _die(self, reason: str) -> None:
        with self._lock:
            if self._dead:
                return
            self._dead = True
            self._close_reason = reason
            pending = list(self._pending.values())
            self._pending.clear()
        for slot in pending:
            slot["error"] = ConnectionLost(reason)
            slot["done"].set()
        self._outbox.put(None)              # writer exits
        try:
            # shutdown, not just close: close() defers the real fd close
            # while our own reader is blocked in recv on it, so the peer
            # would never see FIN — a self-initiated death must be
            # promptly visible on the other end
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        cb = self._on_close
        if cb is not None:
            try:
                cb(reason)
            except Exception as e:  # pragma: no cover - defensive
                logger.error(f"{self.name}: on_close failed: {e!r}")

    def close(self, reason: str = "closed") -> None:
        self._die(reason)


#: per-process cap on CONCURRENT dial() connect attempts — the other
#: half of reconnect-storm protection (full-jitter backoff spreads the
#: attempts in time, this bounds them in flight): a frontend holding
#: many handles to one restarted peer queues its re-dials here instead
#: of stampeding the listener's accept backlog.
DIAL_MAX_CONCURRENT = 8
_dial_gate = threading.BoundedSemaphore(DIAL_MAX_CONCURRENT)


def set_dial_concurrency(n: int) -> None:
    """Resize the process-wide dial gate (ops tuning / tests). Attempts
    already waiting on the old gate finish under it."""
    global DIAL_MAX_CONCURRENT, _dial_gate
    DIAL_MAX_CONCURRENT = max(1, int(n))
    _dial_gate = threading.BoundedSemaphore(DIAL_MAX_CONCURRENT)


def dial(address: str, *, timeout_s: float = 5.0,
         **conn_kwargs) -> Connection:
    """Connect to a replica server and start the connection threads.
    The TCP connect itself runs under the process-wide dial gate
    (``DIAL_MAX_CONCURRENT``); the connection, once up, is not."""
    host, port = parse_address(address)
    gate = _dial_gate
    with gate:
        sock = socket.create_connection((host, port), timeout=timeout_s)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    conn = Connection(sock, **conn_kwargs)
    conn.start()
    return conn
