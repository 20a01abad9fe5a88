"""Frontend federation (docs/SERVING.md "Frontend federation").

Two-tier serving fleet: a :class:`~deepspeed_tpu_torch.serving.frontend.
ServingFrontend` with ``fabric.federation.enabled`` runs a
:class:`FederationServer` on ``fabric.listen`` that EXPORTS a
configurable slice of its local replica pool to peer frontends, while
``fabric.federation.peers`` adopts remote frontends' exported replicas
as routable members of the local router — :class:`FederatedHandle`, a
:class:`~deepspeed_tpu_torch.serving.fabric.remote.RemoteHandle` subclass, so
the shared pool rides the existing transport/codec/mirroring machinery
unchanged.

Topology rules, enforced here:

- **hello role "frontend"**: the federation listener speaks only to
  frontends (identity + monotonic epoch in the hello). A frontend that
  dials its own listener is refused typed (``self_peering:``); a hello
  whose epoch is older than the newest seen for that frontend identity
  is refused typed (``stale_epoch:``) and a newer epoch supersedes the
  older connections — a restarted frontend can never be shadowed by its
  zombie predecessor.
- **no transitive re-export**: only LOCAL (non-remote) replicas are
  exported, so adopted capacity can never bounce through a third
  frontend — routing loops are impossible by construction, not by
  TTL.
- **exporter keeps ownership**: a federated assign lands directly on
  the exporting frontend's local replica (sharing its seats with local
  traffic — the server re-checks ``accepting``/``has_capacity`` and the
  adopter additionally honors the status stream's ``active_total``),
  and every exporter-side failure hands the request BACK to the
  adopting frontend as an ordered ``failover``/``evacuated`` marker —
  never into the exporter's own admission queue. The adopting frontend
  then requeues through its resume path: greedy byte-lossless.

``federation`` absent/disabled is byte-for-byte the historical stack:
no identity derived, no listener bound, no peers dialed.
"""

from __future__ import annotations

import itertools
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Set

from ...utils.locks import RankedLock
from ...utils.logging import logger
from ..replica import ReplicaState
from ..request import DoneEvent, FinishReason, RequestState
from .codec import (CODEC_VERSION, COMPAT_CODEC_VERSIONS, FrameTooLarge,
                    payload_chunks, payload_from_chunks, request_from_wire)
from .remote import RemoteHandle
from .server import (JOURNAL_EVENTS_PER_STATUS, STATUS_INTERVAL_S,
                     DigestStream)
from .transport import (STALE_FLOOR_S, STALE_HEARTBEATS, Connection,
                        FabricError, dial, parse_address)

#: typed hello-refusal markers a retry can never fix — the connect
#: backoff re-raises instead of burning its breaker on them
PEERING_MARKERS = ("self_peering:", "stale_epoch:", "export_unknown:",
                   "federation_role:")

#: per-process frontend-instance counter: two frontends in ONE process
#: (the in-process test/bench topology) must still derive distinct
#: identities, or they would refuse each other as self-peering
_INSTANCE_SEQ = itertools.count(1)


def derive_frontend_id() -> str:
    """Default frontend identity when ``federation.frontend_id`` is
    empty: host + pid + per-process instance counter — unique across a
    fleet of real deployments AND across in-process test topologies."""
    return f"{socket.gethostname()}:{os.getpid()}:{next(_INSTANCE_SEQ)}"


def derive_epoch() -> int:
    """Monotonic-across-restarts epoch for one frontend identity:
    wall-clock milliseconds. A restarted frontend (same configured
    ``frontend_id``) presents a strictly larger epoch, which is what
    lets peers refuse its zombie predecessor."""
    return int(time.time() * 1000)


class FederationRefused(ValueError):
    """A peer frontend refused the hello for a PERMANENT reason
    (self-peering, stale epoch, unknown export) — a configuration or
    topology bug, surfaced loudly instead of retried."""


class _ExportRef:
    """Engine-factory sentinel for a federated slot (the ``_PeerRef``
    idiom one tier up): the supervisor's restart path re-dials the SAME
    export on the SAME peer — the exporter owns the replica; a restart
    here only rebuilds the adopter-side mirror."""

    def __init__(self, address: str, export: dict, peer: "FederationPeer"):
        self.address = address
        self.export = dict(export)
        self.peer = peer


class FederatedHandle(RemoteHandle):
    """An exported peer replica, adopted into the local router.

    Inherits the whole RemoteHandle mirroring contract (ordered event
    stream, phase-split load accounting, dead-connection-is-dead-replica
    failover); adds the federation hello (frontend identity + epoch +
    export binding), per-peer capacity accounting, and the
    ``requests_federated`` / ``peer_rpc_s`` observability.
    """

    #: frontend/autoscaler probe: federated capacity is BORROWED — the
    #: exporting frontend owns the replica, so the local autoscaler
    #: must never pick it as a shrink victim (is_remote stays True:
    #: shrinking-by-disconnect semantics still apply if removed
    #: explicitly)
    is_federated = True

    _PERMANENT_HELLO_MARKERS = PEERING_MARKERS

    def __init__(self, replica_id: int, address: str, fabric_config, *,
                 export: dict, frontend_id: str, epoch: int,
                 peer: Optional["FederationPeer"] = None, **kwargs):
        super().__init__(replica_id, address, fabric_config,
                         role=str(export.get("role", "mixed")),
                         model_id=str(export.get("model_id", "default")),
                         **kwargs)
        self._export = int(export["export"])
        self._frontend_id = str(frontend_id)
        self._epoch = int(epoch)
        self._peer = peer
        # exporter-side TOTAL seat usage of the shared replica (its own
        # local traffic + every adopter's), from the status stream —
        # last-write-wins publication like the occupancy snapshots
        self._last_active_total = 0

    # ------------------------------------------------------------- hello
    def _hello_payload(self, reset: bool) -> dict:
        p = super()._hello_payload(reset)
        # the federation listener speaks hello role "frontend": identity
        # + epoch gate peering (self/stale refusals), "export" binds
        # this connection to one exported replica. ``reset`` rides along
        # but the server ignores it — the EXPORTER owns the engine; a
        # supervisor restart here rebuilds only this mirror.
        p["role"] = "frontend"
        p["frontend_id"] = self._frontend_id
        p["epoch"] = self._epoch
        p["export"] = self._export
        return p

    # --------------------------------------------------------------- rpc
    def _call(self, method: str, payload: Optional[dict] = None,
              timeout_s: Optional[float] = None):
        t0 = time.monotonic()
        try:
            return super()._call(method, payload, timeout_s)
        finally:
            if self.metrics is not None:
                self.metrics.histogram("peer_rpc_s").observe(
                    time.monotonic() - t0)

    # ------------------------------------------------------------ routing
    @property
    def has_capacity(self) -> bool:
        # advisory, like every router capacity probe (the exporter
        # re-checks at assign): respect the exporter's TOTAL seat usage
        # of the shared replica, and the per-peer inflight cap across
        # every mirror adopted from this peer
        seats = self.engine.config.max_ragged_sequence_count
        if self._last_active_total >= seats:
            return False
        peer = self._peer
        if peer is not None:
            cap = int(getattr(self.fabric.federation, "peer_max_inflight",
                              0) or 0)
            if cap and peer.inflight() >= cap:
                return False
        return self.active_count < seats

    def assign(self, req) -> bool:
        ok = super().assign(req)
        if ok and self.metrics is not None:
            self.metrics.counter("requests_federated").inc()
        return ok

    # ------------------------------------------------------------- events
    def _ev_status(self, msg: dict) -> None:
        super()._ev_status(msg)
        total = msg.get("active_total")
        if total is not None:
            self._last_active_total = int(total)


class FederationPeer:
    """The bootstrap connection to one peer frontend: the discovery
    hello (identity exchange + the peer's export list) plus a held-open
    heartbeated connection whose close is the peer's ``peer_lost``
    signal server-side. Also the per-peer capacity ledger: ``inflight``
    sums the mirrors of every handle adopted from this peer (racy
    snapshot by design — it feeds an advisory capacity probe)."""

    def __init__(self, address: str, fabric_config, *, frontend_id: str,
                 epoch: int):
        self.address = str(address)
        self.fabric = fabric_config
        self.frontend_id = str(frontend_id)
        self.epoch = int(epoch)
        self.peer_id: Optional[str] = None
        self.peer_epoch: Optional[int] = None
        self.exports: List[dict] = []
        self._handles: Dict[int, FederatedHandle] = {}
        self._conn: Optional[Connection] = None

    def connect(self) -> None:
        """Dial the peer's federation listener and run the bootstrap
        hello. Typed peering refusals raise :class:`FederationRefused`
        (permanent — a config/topology bug); transport failures raise
        through for the caller's skip-and-log policy (edge frontends
        boot independently; a dead peer must not brick boot)."""
        fab = self.fabric
        conn = dial(self.address, timeout_s=fab.rpc_timeout_s,
                    max_frame_bytes=fab.max_frame_bytes,
                    heartbeat_s=fab.heartbeat_s,
                    name=f"federation-peer-{self.address}")
        try:
            info = conn.call("hello", {
                "codec_version": CODEC_VERSION,
                "role": "frontend",
                "frontend_id": self.frontend_id,
                "epoch": self.epoch,
                "crc_frames": bool(getattr(fab, "frame_crc", True)),
                "max_frame_bytes": int(fab.max_frame_bytes)},
                timeout_s=fab.rpc_timeout_s)
        except FabricError as e:
            conn.close(f"federation hello failed: {e!r}")
            if any(m in str(e) for m in PEERING_MARKERS) \
                    or "version_mismatch:" in str(e):
                raise FederationRefused(str(e)) from e
            raise
        if info.get("crc_frames") and getattr(fab, "frame_crc", True):
            conn.crc_tx = True
            conn.crc_rx = True
        self._conn = conn
        self.peer_id = info.get("frontend_id")
        self.peer_epoch = info.get("epoch")
        self.exports = list(info.get("exports") or [])

    @property
    def alive(self) -> bool:
        conn = self._conn
        return conn is not None and conn.alive

    def register(self, handle: FederatedHandle) -> None:
        self._handles[handle.replica_id] = handle

    def inflight(self) -> int:
        return sum(h.active_count for h in list(self._handles.values()))

    def close(self, reason: str = "frontend shutdown") -> None:
        conn = self._conn
        if conn is not None:
            conn.close(reason)


class _Channel:
    """Per-connection server state. The request table and staged-chunk
    accumulator are hit from this connection's transport reader, the
    per-request pump threads and the exporter's replica worker (via the
    frontend hand-back hooks) — each channel owns its lock; channel
    locks and the server's peer-table lock share the federation rank
    and are NEVER nested."""

    _GUARDED_BY = {"reqs": "_lock", "stage_rx": "_lock"}

    def __init__(self):
        self.conn: Optional[Connection] = None
        self.kind: Optional[str] = None          # "boot" | "export"
        self.peer_id: Optional[str] = None
        self.epoch = 0
        self.export_rid: Optional[int] = None
        self.deltas = False
        self.digest = DigestStream()
        self._lock = RankedLock("serving.fabric.federation")
        self.reqs: Dict[int, object] = {}
        self.stage_rx: Dict[int, list] = {}
        # journal forwarding cursor (docs/OBSERVABILITY.md "Fleet
        # observability"): touched only by the server's status thread;
        # starts at 0 so a fresh channel replays the exporter's ring —
        # the adopter's FleetJournal dedupes by per-source seq
        self.journal_fwd_seq = 0
        # partition edge-detector (status thread only): peer_partition
        # is journaled once per silence episode, not once per sweep tick
        self.partition_journaled = False


class FederationServer:
    """The exporter side: accepts peer-frontend connections on
    ``fabric.listen`` and serves a slice of the LOCAL replica pool over
    the existing transport/codec.

    Unlike :class:`~deepspeed_tpu_torch.serving.fabric.server.ReplicaServer`
    (one engine, one frontend, newest-connection-wins) this server is
    multi-connection — one bootstrap channel per peer plus one export
    channel per adopted replica — and hosts no replica of its own: an
    export channel resolves the CURRENT local handle for its replica id
    at every assign, so the exporter's supervisor restarting the
    underlying replica transparently re-points the export."""

    # lock discipline (docs/CONCURRENCY.md): peer epoch/liveness tables
    # and the channel list are hit from every connection's reader thread
    # and the status/accept threads; per-request state lives on each
    # channel under ITS lock (same rank, never nested with this one)
    _GUARDED_BY = {"_channels": "_lock", "_peer_epochs": "_lock",
                   "_peers_live": "_lock"}

    def __init__(self, frontend, *, listen: str, frontend_id: str,
                 epoch: int):
        fab = frontend.config.fabric
        self.frontend = frontend
        self.frontend_id = str(frontend_id)
        self.epoch = int(epoch)
        self.journal = frontend.journal
        self.heartbeat_s = float(fab.heartbeat_s)
        self.max_frame_bytes = int(fab.max_frame_bytes)
        self._fed = fab.federation
        self._lock = RankedLock("serving.fabric.federation")
        self._channels: List[_Channel] = []
        self._peer_epochs: Dict[str, int] = {}
        self._peers_live: Dict[str, int] = {}
        self._stop = threading.Event()
        host, port = parse_address(listen)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.listen_host = host
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"federation-server-{self.port}")
        self._status_thread = threading.Thread(
            target=self._status_loop, daemon=True,
            name=f"federation-status-{self.port}")

    @property
    def address(self) -> str:
        return f"{self.listen_host}:{self.port}"

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self._accept_thread.start()
        self._status_thread.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            channels = list(self._channels)
        for ch in channels:
            conn = ch.conn
            if conn is not None:
                conn.close("federation server stopped")

    def live_peer_ids(self) -> Set[str]:
        with self._lock:
            return set(self._peers_live)

    # -------------------------------------------------------------- accept
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return                      # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            ch = _Channel()
            conn = Connection(
                sock, max_frame_bytes=self.max_frame_bytes,
                heartbeat_s=self.heartbeat_s,
                on_event=lambda msg, ch=ch: self._on_msg(msg, ch),
                on_close=lambda reason, ch=ch: self._on_channel_close(
                    ch, reason),
                name=f"federation-server-{self.port}")
            ch.conn = conn
            with self._lock:
                self._channels.append(ch)
            conn.start()
            logger.info(f"federation server {self.frontend_id}: peer "
                        f"connection from {addr}")

    def _on_channel_close(self, ch: _Channel, reason: str) -> None:
        """A peer connection died: cancel the channel's in-flight
        mirrors (their KV frees; the ADOPTING frontend's transport-loss
        path already failed them over to its other members) and, for a
        bootstrap channel, settle the peer's liveness books."""
        with ch._lock:
            reqs = list(ch.reqs.values())
            ch.reqs.clear()
            ch.stage_rx.clear()
        for req in reqs:
            req.cancel_requested.set()
        lost = None
        with self._lock:
            try:
                self._channels.remove(ch)
            except ValueError:
                pass
            if ch.kind == "boot" and ch.peer_id:
                n = self._peers_live.get(ch.peer_id, 0) - 1
                if n <= 0:
                    self._peers_live.pop(ch.peer_id, None)
                else:
                    self._peers_live[ch.peer_id] = n
                lost = ch.peer_id
        if lost is not None:
            try:
                self.journal.emit("peer_lost", peer=lost, reason=reason)
            except Exception:       # journal must never kill serving
                pass

    # ------------------------------------------------------------ messages
    def _on_msg(self, msg: dict, ch: _Channel) -> None:
        if msg.get("t") == "call":
            self._on_call(msg, ch)
            return
        ev = msg.get("ev")
        if ev == "stage_chunk":
            with ch._lock:
                ch.stage_rx.setdefault(int(msg["uid"]), []).append(
                    {"slabs": msg["slabs"]})
        elif ev == "stage_abort":
            with ch._lock:
                ch.stage_rx.pop(int(msg["uid"]), None)
        elif ev == "cancel":
            with ch._lock:
                req = ch.reqs.get(int(msg["uid"]))
            if req is not None:
                req.cancel_requested.set()
        # "drain"/"stop" are deliberately ignored: the adopter draining
        # ITS handle must not drain the exporter's shared replica (the
        # exporter's own traffic lives there); a stop's connection close
        # already cancels this channel's mirrors

    def _on_call(self, msg: dict, ch: _Channel) -> None:
        call_id = msg.get("id")
        method = msg.get("m")
        conn = ch.conn
        try:
            handler = {"hello": self._rpc_hello,
                       "assign": self._rpc_assign,
                       "probe": self._rpc_probe,
                       "evacuate": self._rpc_evacuate}.get(method)
            if handler is None:
                conn.respond(call_id, error=f"unknown method {method!r}")
                return
            conn.respond(call_id, handler(msg.get("p") or {}, ch))
        except FabricError:
            raise
        except Exception as e:
            logger.error(f"federation server {self.frontend_id}: "
                         f"{method} failed: {e!r}")
            try:
                conn.respond(call_id, error=repr(e))
            except FabricError:
                pass

    # --------------------------------------------------------------- hello
    def _exports(self) -> List[dict]:
        """The exported slice of the local pool: accepting LOCAL
        replicas (never a remote/federated member — transitive
        re-export would permit routing loops), capped by
        ``export_max_replicas`` (0 = all)."""
        router = getattr(self.frontend, "router", None)
        if router is None:
            return []               # exporter still booting
        cap = int(self._fed.export_max_replicas or 0)
        out: List[dict] = []
        for h in router.replicas:
            if getattr(h, "is_remote", False) or not h.accepting:
                continue
            eng = h.engine
            out.append({
                "export": int(h.replica_id),
                "role": getattr(h, "role", "mixed"),
                "model_id": getattr(h, "model_id", "default"),
                "max_seq_len": int(eng.model.cfg.max_seq_len),
                "max_seats": int(eng.config.max_ragged_sequence_count),
                "kv_block_size": int(eng.config.kv_block_size)})
            if cap and len(out) >= cap:
                break
        return out

    def _local_handle(self, rid: Optional[int]):
        router = getattr(self.frontend, "router", None)
        if router is None or rid is None:
            return None
        for h in router.replicas:
            if h.replica_id == rid and not getattr(h, "is_remote", False):
                return h
        return None

    def _rpc_probe(self, p: dict, ch: _Channel) -> dict:
        """Quarantine liveness/latency probe on an adopted export: the
        caller measures the round-trip; answer immediately."""
        rep = self._local_handle(ch.export_rid)
        return {"replica_id": ch.export_rid,
                "state": rep.state.value if rep is not None else None}

    def _rpc_hello(self, p: dict, ch: _Channel) -> dict:
        if int(p.get("codec_version", -1)) not in COMPAT_CODEC_VERSIONS:
            raise ValueError(
                f"version_mismatch: server codec v{CODEC_VERSION}, "
                f"client v{p.get('codec_version')!r}")
        fid = str(p.get("frontend_id") or "")
        if str(p.get("role")) != "frontend" or not fid:
            raise ValueError(
                "federation_role: this listener speaks hello role "
                "'frontend' only (replica traffic belongs on a replica "
                "server)")
        if fid == self.frontend_id:
            raise ValueError(
                f"self_peering: frontend {fid!r} dialed its own "
                "federation listener — remove it from "
                "fabric.federation.peers")
        epoch = int(p.get("epoch", 0))
        with self._lock:
            known = self._peer_epochs.get(fid)
            if known is not None and epoch < known:
                raise ValueError(
                    f"stale_epoch: frontend {fid!r} presented epoch "
                    f"{epoch} < live epoch {known} — a restarted peer "
                    "supersedes its predecessor, never the reverse")
            self._peer_epochs[fid] = max(epoch, known or 0)
            superseded = [c for c in self._channels
                          if c.peer_id == fid and c.epoch < epoch]
        for old in superseded:
            conn = old.conn
            if conn is not None:
                conn.close("superseded by a newer peer epoch")
        client_bound = int(p.get("max_frame_bytes", 0) or 0)
        if client_bound:
            ch.conn.send_max_bytes = (
                min(self.max_frame_bytes, client_bound)
                if self.max_frame_bytes else client_bound)
        # CRC sealing, client-driven like the replica-server hello
        crc = bool(p.get("crc_frames", False))
        if crc:
            ch.conn.crc_tx = True
            ch.conn.crc_rx = True
        ch.peer_id = fid
        ch.epoch = epoch
        ch.deltas = bool(p.get("digest_deltas", False))
        if "export" not in p:
            # bootstrap hello: identity exchange + export discovery; the
            # held-open connection is the peer-liveness signal
            ch.kind = "boot"
            with self._lock:
                self._peers_live[fid] = self._peers_live.get(fid, 0) + 1
            try:
                self.journal.emit("peer_connected", peer=fid, epoch=epoch)
            except Exception:
                pass
            return {"frontend_id": self.frontend_id, "epoch": self.epoch,
                    "codec_version": CODEC_VERSION, "pid": os.getpid(),
                    "crc_frames": crc,
                    "max_frame_bytes": int(self.max_frame_bytes),
                    "exports": self._exports()}
        rid = int(p["export"])
        h = self._local_handle(rid)
        if h is None:
            raise ValueError(
                f"export_unknown: replica {rid} is not an exported "
                "local replica of this frontend")
        ch.kind = "export"
        ch.export_rid = rid
        try:
            self.journal.emit("replica_exported", replica=rid, peer=fid)
        except Exception:
            pass
        eng = h.engine
        return {"replica_id": rid, "role": getattr(h, "role", "mixed"),
                "codec_version": CODEC_VERSION, "pid": os.getpid(),
                "model_id": getattr(h, "model_id", "default"),
                "crc_frames": crc,
                "max_frame_bytes": int(self.max_frame_bytes),
                "max_seq_len": int(eng.model.cfg.max_seq_len),
                "max_seats": int(eng.config.max_ragged_sequence_count),
                "kv_block_size": int(eng.config.kv_block_size)}

    # --------------------------------------------------------------- assign
    def _rpc_assign(self, p: dict, ch: _Channel) -> bool:
        rep = self._local_handle(ch.export_rid)
        if rep is None:
            return False            # export vanished: adopter repicks
        # Replica.assign gates only on accepting (the local router
        # checks has_capacity first) — re-check BOTH here so federated
        # work can never oversubscribe the shared replica past what
        # local traffic already claimed
        if not (rep.accepting and rep.has_capacity):
            return False
        req = request_from_wire(p["req"])
        with ch._lock:
            chunks = ch.stage_rx.pop(req.uid, [])
        req.staged_kv = payload_from_chunks(p.get("staged_meta"), chunks)
        # mirror marker, consulted by the exporting frontend's
        # _failover/_evacuate_handback hooks: every exporter-side
        # failure routes BACK over this channel (the adopter owns the
        # stream and the retry budget), never into the exporter's own
        # admission queue
        req._federated = True
        req._federation_channel = ch
        with ch._lock:
            ch.reqs[req.uid] = req
        ok = bool(rep.assign(req))
        if ok:
            threading.Thread(target=self._pump, args=(req, ch),
                             daemon=True,
                             name=f"federation-pump-{req.uid}").start()
        else:
            with ch._lock:
                ch.reqs.pop(req.uid, None)
        return ok

    def _rpc_evacuate(self, p: dict, ch: _Channel) -> bool:
        """Adopter-driven evacuation of ITS mirrors only: cancel each
        one on the shared replica (the exporter's own traffic is
        untouched — this is what makes evacuate safe on shared
        capacity); the pump turns a cancel that actually landed into an
        ``evacuated`` marker, so the adopter requeues instead of
        finishing CANCELLED."""
        with ch._lock:
            reqs = list(ch.reqs.values())
        for req in reqs:
            req._federation_evacuate = True
            req.cancel_requested.set()
        return True

    # ------------------------------------------------------------ handbacks
    def detach_failover(self, req) -> bool:
        """Exporter-side replica death for a federated mirror (called
        from the exporting frontend's ``_failover`` hook, on whatever
        thread the replica failed on): mark the request so its pump
        sends an ordered ``failover`` marker after the trailing tokens,
        then settle it locally — the real stream and the retry budget
        live on the ADOPTING frontend."""
        req._fabric_failover = True
        req.finish(RequestState.FAILED, FinishReason.ERROR)
        return True

    def return_evacuated(self, req, payload) -> None:
        """Exporter-side spontaneous evacuation (its autoscaler
        shrinking/re-roling the shared replica) for a federated mirror:
        stream the exported KV back to the adopter and send the
        ``evacuated`` marker — the adopter's hand-back requeues with
        the staged payload (or re-prefills on meta None), lossless
        either way."""
        ch = getattr(req, "_federation_channel", None)
        if ch is None:
            return
        req._fabric_detached = True
        meta = self._send_payload(ch, req.uid, payload)
        self._ch_send(ch, {"t": "ev", "ev": "evacuated", "uid": req.uid,
                           "meta": meta})
        with ch._lock:
            ch.reqs.pop(req.uid, None)
        req.finish(RequestState.REJECTED, "draining")

    # ------------------------------------------------------------- pumping
    def _ch_send(self, ch: _Channel, msg: dict) -> None:
        conn = ch.conn
        if conn is None:
            return
        try:
            conn.send(msg)
        except FabricError:
            pass

    def _send_payload(self, ch: _Channel, uid: int,
                      payload) -> Optional[dict]:
        meta, chunks = payload_chunks(payload)
        if meta is None:
            return None
        conn = ch.conn
        if conn is None:
            return None
        try:
            for c in chunks:
                conn.send({"t": "ev", "ev": "payload_chunk", "uid": uid,
                           "slabs": c["slabs"]})
        except FrameTooLarge:
            self._ch_send(ch, {"t": "ev", "ev": "payload_abort",
                               "uid": uid})
            return None
        except FabricError:
            return None
        return meta

    def _pump(self, req, ch: _Channel) -> None:
        """Per-request event pump (the ReplicaServer discipline): the
        request's queue is the ordering authority — tokens first, then
        exactly one terminal marker."""
        while True:
            ev = req._events.get()
            if isinstance(ev, DoneEvent):
                break
            self._ch_send(ch, {"t": "ev", "ev": "token", "uid": req.uid,
                               "token": ev.token})
        with ch._lock:
            ch.reqs.pop(req.uid, None)
        if getattr(req, "_fabric_failover", False):
            self._ch_send(ch, {"t": "ev", "ev": "failover",
                               "uid": req.uid})
            return
        if getattr(req, "_fabric_detached", False):
            return                  # return_evacuated sent its marker
        if getattr(req, "_federation_evacuate", False) \
                and req.finish_reason == FinishReason.CANCELLED:
            # the evacuate RPC's cancel landed: hand the request back
            # for requeue (meta None = re-prefill resume) instead of
            # finishing it CANCELLED on the adopter. A request the
            # cancel LOST to a genuine finish falls through to the
            # honest finish marker below.
            self._ch_send(ch, {"t": "ev", "ev": "evacuated",
                               "uid": req.uid, "meta": None})
            return
        self._ch_send(ch, {"t": "ev", "ev": "finish", "uid": req.uid,
                           "reason": req.finish_reason,
                           "state": req.state.value})

    # --------------------------------------------------------------- leases
    def _sweep_leases(self, exports: List[_Channel],
                      boots: List[_Channel]) -> None:
        """Partition-tolerant seat leases (docs/SERVING.md "Frontend
        federation"): borrowed capacity must come HOME when the adopter
        can no longer be reached — its mirrors are already failing over
        on its side of the partition, so seats it holds here serve
        nobody. An export channel silent past ``lease_timeout_s``
        (chaos-discarded frames never count as received) expires: the
        close cancels this channel's mirrors, their KV frees, and local
        traffic gets the seats back. Heal = the adopter re-adopts over
        fresh channels under its epoch; the per-source journal seq keeps
        the fleet's event view exactly-once across the replay."""
        lease_s = float(getattr(self._fed, "lease_timeout_s", 0.0) or 0.0)
        stale_s = (max(STALE_FLOOR_S, STALE_HEARTBEATS * self.heartbeat_s)
                   if self.heartbeat_s > 0 else 0.0)
        for ch in boots:
            conn = ch.conn
            if conn is None or stale_s <= 0:
                continue
            idle = conn.rx_idle_s
            if idle > stale_s and not ch.partition_journaled:
                ch.partition_journaled = True
                try:
                    self.journal.emit("peer_partition", peer=ch.peer_id,
                                      idle_s=round(idle, 3))
                except Exception:   # journal must never kill serving
                    pass
            elif idle <= stale_s:
                ch.partition_journaled = False
        if lease_s <= 0:
            return
        for ch in exports:
            conn = ch.conn
            if conn is None or conn.rx_idle_s <= lease_s:
                continue
            try:
                self.journal.emit("lease_expired", peer=ch.peer_id,
                                  replica=ch.export_rid,
                                  idle_s=round(conn.rx_idle_s, 3))
            except Exception:
                pass
            m = getattr(self.frontend, "metrics", None)
            if m is not None:
                m.counter("federation_leases_expired").inc()
            logger.warning(
                f"federation server {self.frontend_id}: seat lease on "
                f"replica {ch.export_rid} to peer {ch.peer_id!r} expired "
                f"after {conn.rx_idle_s:.1f}s of silence")
            conn.close("federation lease expired")

    # -------------------------------------------------------------- status
    def _status_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(STATUS_INTERVAL_S)
            with self._lock:
                exports = [c for c in self._channels
                           if c.kind == "export"]
                boots = [c for c in self._channels if c.kind == "boot"]
            self._sweep_leases(exports, boots)
            for ch in exports:
                conn = ch.conn
                if conn is None or not conn.alive:
                    continue
                rep = self._local_handle(ch.export_rid)
                if rep is None:
                    continue
                try:
                    eng = rep.engine
                    ev = {
                        "t": "ev", "ev": "status",
                        "state": rep.state.value,
                        "thread_alive": rep.thread.is_alive(),
                        "occupancy": eng.occupancy(),
                        "param_stats": eng.param_stats(),
                        "tier_stats": eng.tier_stats(),
                        # deliberately NO counters: the exporter's
                        # registry is fleet-wide; forwarding it per
                        # export channel would double-count engine
                        # stats the exporter already publishes
                        "counters": {},
                        # TOTAL seat usage of the shared replica (local
                        # + every adopter) — the adopter's capacity
                        # probe honors it
                        "active_total": int(rep.active_count)}
                    aff = getattr(self.frontend.config, "affinity", None)
                    if aff is not None and aff.enabled:
                        fn = getattr(rep, "prefix_digest", None)
                        if fn is not None:
                            ch.digest.stamp(ev,
                                            fn(aff.digest_max_entries),
                                            ch.deltas)
                    # fleet observability: federation peers forward the
                    # exporting frontend's journal the same way replica
                    # servers do (OPTIONAL status field, bounded per
                    # frame, per-channel cursor). Channels to one peer
                    # each replay independently — the adopter's
                    # FleetJournal dedupes by per-source seq, so the
                    # fleet view stays exactly-once. Spans are NOT
                    # forwarded here: the exporter publishes its own
                    # traces; only the shared-replica server side owns
                    # cross-process request spans.
                    jev = self.journal.events(
                        since_seq=ch.journal_fwd_seq)[
                            :JOURNAL_EVENTS_PER_STATUS]
                    if jev:
                        ev["journal"] = {
                            "source": f"frontend-{self.frontend_id}",
                            "events": jev}
                        ch.journal_fwd_seq = int(jev[-1]["seq"])
                    self._ch_send(ch, ev)
                except Exception as e:  # pragma: no cover - defensive
                    logger.error(f"federation server {self.frontend_id}: "
                                 f"status tick failed: {e!r}")
