"""Deterministic NETWORK fault injection for the serving fabric.

``serving/faults.py`` turns replica chaos (crash/wedge/put
errors) into seeded, tier-1-testable drills. This module is the same
harness one layer down, at the wire: a seeded schedule of per-link
network faults installed BETWEEN :class:`~deepspeed_tpu_torch.serving.fabric.
transport.Connection` and its socket. The shim interposes on frame
send/recv only — it never changes socket I/O semantics, so everything
the transport already guarantees (framing, heartbeat liveness, typed
death) is exercised, not re-implemented.

Fault kinds (``chaos:`` config block, docs/CONFIG.md):

- ``latency``    — fixed + seeded-jitter delay per frame
  (``delay_s`` / ``jitter_s``)
- ``throttle``   — bandwidth cap: frames slow-drip onto the socket at
  ``bytes_per_s`` (chunked writes with proportional sleeps)
- ``drop_conn``  — kill the connection at frame ``at_frame``;
  ``partial_bytes >= 0`` first writes the length prefix plus that many
  body bytes, leaving the peer a PARTIAL frame (its reader dies with
  the typed "EOF inside a fabric frame" ConnectionLost)
- ``blackhole``  — half-open link: rx frames silently discarded while
  tx succeeds (the default ``dir: rx``); liveness is NOT refreshed for
  a discarded frame, so the staleness detector sees exactly what a
  silent peer looks like
- ``partition``  — blackhole sugar with ``dir: both`` default: a full
  partition between the named endpoints; ``dir: tx``/``rx`` makes it
  asymmetric (one direction flows, the other is dark)
- ``duplicate``  — a frame is delivered/sent twice (one-way dup)
- ``reorder``    — a frame is held and released AFTER its successor
  (one-way reordering; at most one frame held per direction)
- ``corrupt``    — flip ``flip_bits`` seeded bit(s) in the frame body
  (``where: payload`` targets the bytes after the codec header —
  buffer/trailer region; ``where: header`` targets the header JSON)

Schedule entries mirror ``faults:``::

    {"kind": "blackhole", "link": "fabric-r1", "dir": "both",
     "at_frame": 10, "duration_s": 12.0, "count": 0}

``link`` is an fnmatch pattern over :class:`Connection` names
("fabric-r0", "fabric-server-2", "federation-peer-*", ...); ``dir``
defaults per kind; ``at_frame`` arms the event once the link's
per-direction frame counter reaches it (``at_frame_range: [lo, hi]``
draws the index from the injector's seeded rng); ``duration_s`` bounds
the active window from the first hit; ``count`` caps total hits
(0 = every frame while active). ``fired_log`` is the assertion ledger,
exactly like the engine injector's.

Determinism: per-direction frame counters are connection-local and the
per-event rng is seeded from ``(seed, event index)``, so a fixed
schedule against a fixed traffic pattern replays identically. Event
hit-state (fired counts, window anchors) is shared across reconnects of
a link — a ``drop_conn`` with ``count: 1`` kills the link once, not on
every supervisor re-dial.

Installation is process-global (:func:`install` / :func:`uninstall`,
driven by ``ChaosConfig.build_injector()`` at frontend construction):
``Connection.__init__`` asks :func:`attach` for a shim. Disabled — or
no schedule entry matching the link — returns ``None`` and the
transport takes its historical branch-free path: zero interposition,
byte-for-byte the unsealed transport (asserted in the fabric tests).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import struct
import threading
import time
from typing import List, Optional, Sequence

from ...utils.locks import RankedLock

KINDS = ("latency", "throttle", "drop_conn", "blackhole", "partition",
         "duplicate", "reorder", "corrupt")

#: kind -> default interposition direction ("tx" = this endpoint's
#: outgoing frames, "rx" = incoming). blackhole defaults rx (half-open:
#: the classic gray failure), partition defaults both (full split).
_DEFAULT_DIR = {"latency": "tx", "throttle": "tx", "drop_conn": "tx",
                "blackhole": "rx", "partition": "both",
                "duplicate": "rx", "reorder": "rx", "corrupt": "tx"}

_LEN_FMT = ">I"


class ChaosKill(Exception):
    """A scheduled ``drop_conn`` fired: the transport must die NOW (it
    routes this into its ordinary ``_die`` path — chaos produces the
    same typed deaths real networks do)."""


@dataclasses.dataclass
class ChaosEvent:
    """One scheduled network fault (see module docstring for kinds and
    window semantics). Hit-state (``fired``, ``first_hit_t``) is shared
    across every link the pattern matches and across reconnects, under
    the injector lock."""

    kind: str
    link: str = "*"
    dir: str = ""                   # "" = kind default (tx/rx/both)
    at_frame: int = 0
    duration_s: float = 0.0         # active window from first hit (0 = open)
    count: int = 0                  # total hits (0 = unlimited while active)
    delay_s: float = 0.0            # latency: fixed component
    jitter_s: float = 0.0           # latency: seeded uniform extra
    bytes_per_s: float = 0.0        # throttle: drip rate
    partial_bytes: int = -1         # drop_conn: body bytes sent before death
    where: str = "payload"          # corrupt: "payload" | "header"
    flip_bits: int = 1              # corrupt: bits flipped per frame
    fired: int = 0
    first_hit_t: Optional[float] = None
    rng: Optional[random.Random] = None

    def _matches(self, index: int, now: float) -> bool:
        """Pure activity check (no side effects); caller holds the
        injector lock and records the hit."""
        if index < self.at_frame:
            return False
        if self.first_hit_t is not None and self.duration_s > 0.0 \
                and now - self.first_hit_t > self.duration_s:
            return False
        if self.count and self.fired >= self.count:
            return False
        return True


class NetworkFaultInjector:
    """Seeded, scheduled network faults behind the fabric transport.

    Thread model: ``send``/``recv`` shim hooks run on each connection's
    writer/reader thread; per-link frame counters are thread-confined to
    those threads. The shared schedule hit-state, the seeded rngs and
    the ``fired_log`` ledger move under the injector lock — sleeps and
    socket writes always happen OUTSIDE it.
    """

    # lock discipline (docs/CONCURRENCY.md): the fired ledger and the
    # events' shared hit-state are appended from every chaotic link's
    # reader/writer threads
    _GUARDED_BY = {"fired_log": "_lock"}

    def __init__(self, schedule: Sequence[dict], seed: int = 0):
        self.seed = int(seed)
        rng = random.Random(self.seed)
        self.events: List[ChaosEvent] = []
        for i, entry in enumerate(schedule):
            e = dict(entry)
            rng_range = e.pop("at_frame_range", None)
            if rng_range is not None:
                lo, hi = int(rng_range[0]), int(rng_range[1])
                e["at_frame"] = rng.randint(lo, hi)
            kind = e.get("kind")
            if kind not in KINDS:
                raise ValueError(f"chaos schedule entry {i}: unknown kind "
                                 f"{kind!r} (known: {KINDS})")
            ev = ChaosEvent(**e)
            if not ev.dir:
                ev.dir = _DEFAULT_DIR[ev.kind]
            if ev.dir not in ("tx", "rx", "both"):
                raise ValueError(f"chaos schedule entry {i}: dir must be "
                                 f"tx/rx/both, got {ev.dir!r}")
            if ev.where not in ("payload", "header"):
                raise ValueError(f"chaos schedule entry {i}: where must "
                                 f"be payload/header, got {ev.where!r}")
            # per-event rng: seeded from (seed, index) so one event's
            # draws (jitter, corrupt offsets) never perturb another's
            ev.rng = random.Random((self.seed << 16) ^ i)
            self.events.append(ev)
        self._lock = RankedLock("serving.fabric.chaos")
        #: (kind, link, dir, frame_index, t_monotonic) per hit — the
        #: drills' assertion ledger
        self.fired_log: List[tuple] = []

    # ------------------------------------------------------------- attach
    def attach(self, link_name: str) -> Optional["ChaosLink"]:
        """The per-connection shim for ``link_name``, or ``None`` when no
        schedule entry matches it (zero interposition — the transport
        keeps its historical path)."""
        events = [ev for ev in self.events
                  if fnmatch.fnmatch(link_name, ev.link)]
        if not events:
            return None
        return ChaosLink(self, link_name, events)

    # ------------------------------------------------------------ queries
    def fired(self, kind: Optional[str] = None,
              link: Optional[str] = None) -> List[tuple]:
        with self._lock:
            return [f for f in self.fired_log
                    if (kind is None or f[0] == kind)
                    and (link is None or f[1] == link)]

    # ----------------------------------------------------- link callbacks
    def _take(self, events, link_name: str, direction: str,
              index: int, now: float) -> List[ChaosEvent]:
        """Active events for one frame; records the hits in the ledger."""
        with self._lock:
            hits = []
            for ev in events:
                if ev.dir != direction and ev.dir != "both":
                    continue
                if not ev._matches(index, now):
                    continue
                if ev.first_hit_t is None:
                    ev.first_hit_t = now
                ev.fired += 1
                hits.append(ev)
                self.fired_log.append((ev.kind, link_name, direction,
                                       index, now))
            return hits

    def _draw(self, ev: ChaosEvent) -> float:
        with self._lock:
            return ev.rng.random()

    def _draw_int(self, ev: ChaosEvent, n: int) -> int:
        with self._lock:
            return ev.rng.randrange(n)


class ChaosLink:
    """One connection's shim: ``send`` replaces ``transport.send_frame``
    on the writer thread, ``recv`` filters each received frame body on
    the reader thread (returning 0, 1 or 2 bodies to deliver). Frame
    counters and the reorder hold-slots are confined to those threads —
    only the injector's shared state takes a lock."""

    def __init__(self, injector: NetworkFaultInjector, name: str,
                 events: List[ChaosEvent]):
        self._inj = injector
        self.name = name
        self._events = events
        self._tx_frames = 0
        self._rx_frames = 0
        self._held_tx: Optional[bytes] = None
        self._held_rx: Optional[bytes] = None

    # ----------------------------------------------------------------- tx
    def send(self, sock, body: bytes) -> None:
        """Interposed ``send_frame``: applies the scheduled tx faults,
        then frames onto the socket. Raises :class:`ChaosKill` for
        ``drop_conn`` (after the optional partial write) and lets real
        ``OSError`` out exactly like the uninstrumented path."""
        index = self._tx_frames
        self._tx_frames += 1
        now = time.monotonic()
        hits = self._inj._take(self._events, self.name, "tx", index, now)
        delay, bps = 0.0, 0.0
        dup = reorder = discard = False
        kill = None
        for ev in hits:
            k = ev.kind
            if k == "latency":
                delay += ev.delay_s + (self._inj._draw(ev) * ev.jitter_s
                                       if ev.jitter_s else 0.0)
            elif k == "throttle":
                bps = ev.bytes_per_s if not bps else min(bps,
                                                         ev.bytes_per_s)
            elif k in ("blackhole", "partition"):
                discard = True
            elif k == "duplicate":
                dup = True
            elif k == "reorder":
                reorder = True
            elif k == "corrupt":
                body = self._corrupt(ev, body)
            elif k == "drop_conn":
                kill = ev
        if delay > 0.0:
            time.sleep(delay)
        if kill is not None:
            if kill.partial_bytes >= 0:
                # leave the peer a PARTIAL frame: length prefix promises
                # more bytes than ever arrive, so its reader dies with
                # the typed mid-frame ConnectionLost
                try:
                    sock.sendall(struct.pack(_LEN_FMT, len(body))
                                 + body[:kill.partial_bytes])
                except OSError:
                    pass
            raise ChaosKill(f"drop_conn at tx frame {index}")
        if discard:
            return                  # half-open: the peer never sees it
        frames = [body]
        if dup:
            frames.append(body)
        if reorder and self._held_tx is None and not dup:
            self._held_tx = body
            return
        held, self._held_tx = self._held_tx, None
        if held is not None:
            frames.append(held)     # the current frame overtakes it
        for f in frames:
            self._send_raw(sock, f, bps)

    def _send_raw(self, sock, body: bytes, bps: float) -> None:
        data = struct.pack(_LEN_FMT, len(body)) + body
        if bps <= 0.0:
            sock.sendall(data)
            return
        # slow-drip: ~50ms of budget per chunk, sleeping each chunk's
        # wire time, so total transfer time approximates len/bps without
        # one long stall (heartbeats interleave on the SOCKET as usual —
        # this models a thin pipe, not a dead one)
        chunk = max(256, int(bps * 0.05))
        for off in range(0, len(data), chunk):
            piece = data[off:off + chunk]
            sock.sendall(piece)
            time.sleep(len(piece) / bps)

    # ----------------------------------------------------------------- rx
    def recv(self, body: bytes) -> List[bytes]:
        """Interposed receive filter: the frame bodies to actually
        deliver (empty = silently discarded; the caller must then NOT
        refresh liveness). Raises :class:`ChaosKill` for an rx-scheduled
        ``drop_conn``."""
        index = self._rx_frames
        self._rx_frames += 1
        now = time.monotonic()
        hits = self._inj._take(self._events, self.name, "rx", index, now)
        delay, bps = 0.0, 0.0
        dup = reorder = discard = False
        for ev in hits:
            k = ev.kind
            if k == "latency":
                delay += ev.delay_s + (self._inj._draw(ev) * ev.jitter_s
                                       if ev.jitter_s else 0.0)
            elif k == "throttle":
                bps = ev.bytes_per_s if not bps else min(bps,
                                                         ev.bytes_per_s)
            elif k in ("blackhole", "partition"):
                discard = True
            elif k == "duplicate":
                dup = True
            elif k == "reorder":
                reorder = True
            elif k == "corrupt":
                body = self._corrupt(ev, body)
            elif k == "drop_conn":
                raise ChaosKill(f"drop_conn at rx frame {index}")
        if delay > 0.0:
            time.sleep(delay)
        if bps > 0.0:
            time.sleep(len(body) / bps)
        if discard:
            return []
        out = [body]
        if dup:
            out.append(body)
        if reorder and self._held_rx is None and not dup:
            self._held_rx = body
            return []
        held, self._held_rx = self._held_rx, None
        if held is not None:
            out.append(held)
        return out

    # ------------------------------------------------------------ corrupt
    def _corrupt(self, ev: ChaosEvent, body: bytes) -> bytes:
        """Flip seeded bit(s) inside the frame body. ``where: payload``
        targets the bytes AFTER the codec header (buffer data and, on
        CRC-sealed frames, the trailer); ``where: header`` targets the
        header JSON. Falls back to the whole body when the chosen region
        is empty (a JSON-only frame has no payload bytes)."""
        b = bytearray(body)
        if not b:
            return body
        lo, hi = 0, len(b)
        if len(b) >= 5:
            (hlen,) = struct.unpack(_LEN_FMT, bytes(b[:4]))
            hdr_end = min(len(b), 4 + hlen)
            if ev.where == "header":
                lo, hi = 4, hdr_end
            elif hdr_end < len(b):
                lo, hi = hdr_end, len(b)
        if hi <= lo:
            lo, hi = 0, len(b)
        for _ in range(max(1, ev.flip_bits)):
            pos = lo + self._inj._draw_int(ev, hi - lo)
            b[pos] ^= 1 << self._inj._draw_int(ev, 8)
        return bytes(b)


# --------------------------------------------------------------- install
#: process-global injector (None = chaos off everywhere). Installed by
#: the frontend from ``ChaosConfig.build_injector()``; Connection asks
#: attach() at construction. Last install wins — one chaotic frontend
#: per process, exactly like the engine injector's scope.
_INSTALLED: Optional[NetworkFaultInjector] = None
_INSTALL_LOCK = threading.Lock()


def install(injector: NetworkFaultInjector) -> NetworkFaultInjector:
    global _INSTALLED
    with _INSTALL_LOCK:
        _INSTALLED = injector
    return injector


def uninstall() -> None:
    global _INSTALLED
    with _INSTALL_LOCK:
        _INSTALLED = None


def installed() -> Optional[NetworkFaultInjector]:
    return _INSTALLED


def attach(link_name: str) -> Optional[ChaosLink]:
    """The shim for a new connection named ``link_name`` — ``None``
    (zero interposition) unless an installed schedule matches it."""
    inj = _INSTALLED
    return None if inj is None else inj.attach(link_name)
