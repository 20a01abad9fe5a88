"""Replica server: one engine behind the fabric RPC.

Counterpart of ``deepspeed_tpu/serving/fabric/server.py``.
``python -m deepspeed_tpu_torch.scripts.serve_replica`` runs this in its
own process (its own CUDA context and default stream, its own GIL); tests
may also run it on a thread for fast in-process transport coverage. The
server hosts a **plain**
:class:`~deepspeed_tpu_torch.serving.replica.Replica` — the same Dynamic
SplitFuse worker the in-process stack runs, so every engine-level
feature (prefix cache, speculation, kv/weight quant, tiering,
reservation admission, preemption) works unmodified behind the wire.

Threads and the card: the replica's worker runs the engine under
``torch.no_grad()`` (the port's replica loop); an engine build or reset
that a ``hello`` asks for runs on a short-lived build thread under
``torch.no_grad()`` as well, so the transport's reader, writer and
heartbeat threads, the pumps and the status loop never launch work on the
card (the status loop reads host-side counters only).

Protocol (all frames via fabric/codec.py):

- client calls: ``hello`` (codec-version check, role assignment,
  optional fresh-engine ``reset`` — the supervisor-restart path),
  ``assign`` (wire request + optional staged-KV meta; chunk frames
  stream ahead as ``stage_chunk`` events), ``evacuate``;
- client events: ``cancel``, ``drain``, ``stop``, ``stage_chunk``,
  ``stage_abort``;
- server events: ``token``, ``finish``, ``failover``, ``handoff`` (+
  ``payload_chunk`` stream), ``evacuated`` (+ chunks), ``status``
  (~4/s: replica state, occupancy, forwarded engine counters).

Ordering: one pump thread per request drains the request's event queue
in order, so a ``failover``/``handoff`` marker can never overtake that
request's trailing tokens. A client disconnect cancels the in-flight
requests (their KV frees; the *frontend* already failed them over via
its transport-loss path) and the server waits for the next connection —
a frontend restart re-adopts a running server without restarting it.
"""

from __future__ import annotations

import gc
import os
import socket
import threading
import time
from typing import Callable, Dict, Optional

import torch

from ...telemetry.journal import OpsJournal
from ...telemetry.tracer import NOOP_TRACER
from ...utils.locks import RankedLock
from ...utils.logging import logger
from ..metrics import serving_metrics
from ..replica import Replica, ReplicaState
from ..request import FinishReason, RequestState, DoneEvent
from .codec import (CODEC_VERSION, COMPAT_CODEC_VERSIONS, FrameTooLarge,
                    payload_chunks, payload_from_chunks, request_from_wire)
from .remote import DUMP_MAX_BYTES, RemoteHandle
from .transport import Connection, FabricError, parse_address

#: status cadence — also the server->client liveness signal, so it must
#: undercut the client's stale window (STALE_HEARTBEATS x heartbeat_s)
STATUS_INTERVAL_S = 0.25

#: telemetry forwarding bounds per status frame (docs/OBSERVABILITY.md
#: "Fleet observability"): the status stream is the liveness signal —
#: it must stay small and regular, so span/journal deltas are capped and
#: the remainder rides the next tick
SPANS_PER_STATUS = 256
JOURNAL_EVENTS_PER_STATUS = 64


class DigestStream:
    """Per-connection prefix-digest DELTA encoder for the status stream
    (docs/SERVING.md "Fleet KV locality"): the first frame of a
    connection carries the full ``prefix_digest`` snapshot (+
    ``digest_epoch`` 0), later frames carry only ``digest_add`` /
    ``digest_del`` entries under a monotonic epoch — wire bytes scale
    with cache CHURN instead of ``digest_max_entries``. A tick with no
    churn sends nothing (absence already means "nothing new" on this
    stream). Clients that did not advertise ``digest_deltas`` in the
    hello get the historical full snapshot every tick — the full-snapshot
    wire shape, byte for byte — and old peers that keep SENDING full
    snapshots still decode client-side (the optional-field idiom: a
    ``prefix_digest`` field always replaces outright)."""

    def __init__(self):
        self._last = None
        self._epoch = 0

    def reset(self) -> None:
        """New connection / hello: the next frame is a full snapshot."""
        self._last = None
        self._epoch = 0

    def stamp(self, ev: dict, digest, deltas: bool) -> None:
        cur = set(int(h) for h in digest)
        if not deltas:
            ev["prefix_digest"] = sorted(cur)
            return
        if self._last is None:
            self._epoch = 0
            ev["prefix_digest"] = sorted(cur)
            ev["digest_epoch"] = 0
            self._last = cur
            return
        add, dele = cur - self._last, self._last - cur
        if not add and not dele:
            return
        self._epoch += 1
        ev["digest_epoch"] = self._epoch
        if add:
            ev["digest_add"] = sorted(add)
        if dele:
            ev["digest_del"] = sorted(dele)
        self._last = cur


class ReplicaServer:
    # lock discipline (docs/CONCURRENCY.md): the request table and the
    # staged-chunk accumulator are hit from the transport reader thread
    # (assign/cancel/chunk events), per-request pump threads (detach on
    # finish) and the replica worker (via callbacks).
    _GUARDED_BY = {"_reqs": "_lock", "_stage_rx": "_lock"}

    def __init__(self, engine_factory, config=None,
                 listen: str = "127.0.0.1:0", replica_id: int = 0,
                 heartbeat_s: float = 1.0, max_frame_bytes: int = 0,
                 model_id: str = "default"):
        from ..config import ServingConfig

        self.engine_factory = engine_factory
        self.config = config or ServingConfig()
        self.model_id = str(model_id)
        fab = getattr(self.config, "fabric", None)
        self.heartbeat_s = float(heartbeat_s)
        self.max_frame_bytes = int(max_frame_bytes
                                   or (fab.max_frame_bytes
                                       if fab is not None else 0))
        self.replica_id = int(replica_id)
        self._lock = RankedLock("serving.fabric.server")
        self._reqs: Dict[int, object] = {}
        self._stage_rx: Dict[int, list] = {}
        self._conn: Optional[Connection] = None
        # digest-delta stream state for the (single) frontend
        # connection: reset at every hello, so each connection starts
        # with a full snapshot (touched by the hello handler and the
        # status thread only — the races are benign last-write-wins)
        self._digest = DigestStream()
        self._digest_deltas = False
        self._engine = None
        self.replica: Optional[Replica] = None
        self._role = "mixed"
        # server-private registry: the replica records into it and the
        # status loop forwards the engine-level counters as deltas
        self.registry = serving_metrics()
        # fleet observability (docs/OBSERVABILITY.md "Fleet
        # observability"): the server's own journal is ALWAYS on (events
        # are rare and tiny; they forward on the status stream tagged
        # with this source), while the tracer follows the server's
        # telemetry config — or the frontend's, via the hello's
        # telemetry flag (_maybe_enable_telemetry)
        self.source = f"replica-{self.replica_id}@{socket.gethostname()}"
        self.journal = OpsJournal(source=self.source)
        tel = getattr(self.config, "telemetry", None)
        self.tracer = tel.build_tracer() if tel is not None else NOOP_TRACER
        self.recorder = (tel.build_recorder(
            self.tracer, self.registry, role=f"replica-{self.replica_id}")
            if tel is not None else None)
        # per-connection forwarding cursors (hello resets them: a new
        # frontend gets the journal ring replayed — the client dedupes
        # by seq — but NOT stale spans from before it connected)
        self._span_cursor = 0
        self._journal_fwd_seq = 0
        self._stop = threading.Event()
        host, port = parse_address(listen)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self.listen_host = host
        self.port = self._sock.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"fabric-server-{self.replica_id}")
        self._status_thread = threading.Thread(
            target=self._status_loop, daemon=True,
            name=f"fabric-status-{self.replica_id}")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self._accept_thread.start()
        self._status_thread.start()

    def serve_forever(self) -> None:
        self.start()
        while not self._stop.is_set():
            time.sleep(0.2)

    def stop(self) -> None:
        self._stop.set()
        conn = self._conn
        if conn is not None:
            conn.close("server stopped")
        try:
            self._sock.close()
        except OSError:
            pass
        if self.replica is not None:
            self.replica.stop(timeout=2.0)

    # -------------------------------------------------------------- accept
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return                      # listener closed
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            old = self._conn
            if old is not None:
                # newest frontend wins (a supervisor-rebuilt handle dials
                # before the displaced one is stopped)
                old.close("superseded by a new frontend connection")
            # each handler is bound to ITS connection: a superseded
            # connection's reader may still drain already-received calls
            # after self._conn moved on, and answering those on the NEW
            # connection could resolve the new frontend's pending calls
            # by id collision
            holder = {}
            conn = Connection(
                sock, max_frame_bytes=self.max_frame_bytes,
                heartbeat_s=self.heartbeat_s,
                on_event=lambda msg: self._on_msg(msg, holder["conn"]),
                on_close=self._on_conn_close,
                on_corrupt=self._on_frame_corrupt,
                name=f"fabric-server-{self.replica_id}")
            holder["conn"] = conn
            self._conn = conn
            conn.start()
            logger.info(f"fabric replica server {self.replica_id}: "
                        f"frontend connected from {addr}")

    def _on_frame_corrupt(self) -> None:
        """Transport reader hook: a sealed frame failed its CRC and was
        refused. Counts server-side; the frontend mirrors it via the
        forwarded-counter stream (``rpc_frames_corrupt``)."""
        self.registry.counter("rpc_frames_corrupt").inc()

    def _on_conn_close(self, reason: str) -> None:
        """Frontend gone: cancel in-flight work so its KV frees (the
        frontend's transport-loss path already failed the requests over)
        and wait for the next connection."""
        with self._lock:
            reqs = list(self._reqs.values())
            self._stage_rx.clear()
        for req in reqs:
            req.cancel_requested.set()

    # ------------------------------------------------------------- replica
    @staticmethod
    def _off_transport(fn: Callable[[], None]) -> None:
        """Run ``fn`` on a build thread under ``torch.no_grad()`` and
        wait for it (re-raising its exception): engine builds launch work
        on the card, which no transport thread may do."""
        err = []

        def run():
            try:
                with torch.no_grad():
                    fn()
            except BaseException as e:      # re-raised on the caller
                err.append(e)

        t = threading.Thread(target=run, daemon=True, name="fabric-build")
        t.start()
        t.join()
        if err:
            raise err[0]

    def _build_replica(self, role: str, fresh_engine: bool) -> None:
        self._off_transport(lambda: self._build_replica_now(role,
                                                            fresh_engine))

    def _build_replica_now(self, role: str, fresh_engine: bool) -> None:
        from ..frontend import apply_engine_serving_config

        old = self.replica
        if old is not None:
            old.stop(timeout=1.0)
        if self._engine is None or fresh_engine \
                or (old is not None and old.thread.is_alive()):
            # a wedged worker owns the old engine — only a fresh one is
            # safe (the supervisor's restart rule, applied server-side)
            if old is None or not old.thread.is_alive():
                # the port's addition: a stopped replica and its engine go
                # before the new engine is built, so a reset never holds
                # two weight trees on the card at once
                self.replica = old = self._engine = None
                gc.collect()
            self._engine = self.engine_factory()
            apply_engine_serving_config(self._engine, self.config)
        else:
            for uid in list(self._engine.state_manager.tracked_sequences):
                self._engine.flush(uid)
        cfg = self.config
        spec = cfg.speculative if cfg.speculative.enabled else None
        dis = cfg.disaggregation if cfg.disaggregation.enabled else None
        self._role = role
        self.replica = Replica(
            self.replica_id, self._engine, self.registry,
            wedge_timeout_s=cfg.wedge_timeout_s, speculative=spec,
            faults=cfg.faults.build_injector(),
            on_failover=self._on_replica_failover, role=role,
            decode_reserve_tokens=(dis.decode_reserve_tokens
                                   if dis is not None else 0),
            on_handoff=(self._on_replica_handoff if role == "prefill"
                        else None),
            tracer=self.tracer, recorder=self.recorder,
            journal=self.journal)
        self.replica.start()

    def _maybe_enable_telemetry(self, want: bool) -> bool:
        """Hello-time telemetry upgrade: a tracing frontend lights up a
        server that booted without its own ``telemetry:`` block (the
        propagated spans have to come from somewhere). One-way — a
        later non-tracing frontend doesn't darken an enabled server —
        and a no-op (so byte-parity with the pre-observability stack
        holds) when neither side asked. Returns True when the tracer
        changed, which forces a replica rebuild to rebind it."""
        if not want or self.tracer.enabled:
            return False
        from ...telemetry.config import TelemetryConfig

        tel = getattr(self.config, "telemetry", None) or TelemetryConfig()
        tel = type(tel)(**dict(tel.to_dict(), enabled=True))
        self.tracer = tel.build_tracer()
        self.recorder = tel.build_recorder(
            self.tracer, self.registry, role=f"replica-{self.replica_id}")
        return True

    def _on_replica_failover(self, req) -> bool:
        """Replica-death hand-back: mark the request so its pump sends
        an ordered ``failover`` marker after the trailing tokens, then
        settle it locally (the real stream lives client-side)."""
        req._fabric_failover = True
        req.finish(RequestState.FAILED, FinishReason.ERROR)
        return True

    def _on_replica_handoff(self, req, sreq, engine, replica_id) -> None:
        """Prefill-role completion: export (chunked per the handoff
        config) runs HERE — the KV is in this process, and this is its
        worker thread — and the payload crosses the wire as host tensors;
        the frontend stages and re-queues it. An export that raises
        ``ValueError`` or ``RuntimeError`` degrades to the frontend's
        re-prefill fallback (as the port frontend's local handoff does);
        any other exception reaches the worker, which dies."""
        cfg = self.config.disaggregation
        payload = None
        try:
            payload = engine.export_sequence(
                req.uid, chunk_blocks=(cfg.handoff.chunk_blocks
                                       if cfg.enabled else 0))
        except (ValueError, RuntimeError) as e:
            logger.warning(f"fabric replica server {self.replica_id}: KV "
                           f"export for request {req.uid} failed ({e!r})")
        finally:
            engine.flush(req.uid)
        if payload is not None:
            payload["last_logits"] = sreq.last_logits
        req._fabric_handoff_payload = payload
        req.finish(RequestState.FINISHED, "prefilled")

    # ------------------------------------------------------------ messages
    def _on_msg(self, msg: dict, conn: Connection) -> None:
        if msg.get("t") == "call":
            self._on_call(msg, conn)
            return
        ev = msg.get("ev")
        if ev == "stage_chunk":
            with self._lock:
                self._stage_rx.setdefault(int(msg["uid"]), []).append(
                    {"slabs": msg["slabs"]})
        elif ev == "stage_abort":
            with self._lock:
                self._stage_rx.pop(int(msg["uid"]), None)
        elif ev == "cancel":
            with self._lock:
                req = self._reqs.get(int(msg["uid"]))
            if req is not None:
                req.cancel_requested.set()
        elif ev == "drain":
            if self.replica is not None:
                self.replica.drain()
        elif ev == "stop":
            if self.replica is not None:
                self.replica.stop(timeout=1.0)

    def _on_call(self, msg: dict, conn: Connection) -> None:
        call_id = msg.get("id")
        method = msg.get("m")
        try:
            handler = {"hello": self._rpc_hello,
                       "assign": self._rpc_assign,
                       "evacuate": self._rpc_evacuate,
                       "probe": self._rpc_probe,
                       "dump": self._rpc_dump}.get(method)
            if handler is None:
                conn.respond(call_id, error=f"unknown method {method!r}")
                return
            conn.respond(call_id, handler(msg.get("p") or {}, conn))
        except FabricError:
            raise
        except Exception as e:
            logger.error(f"fabric replica server {self.replica_id}: "
                         f"{method} failed: {e!r}")
            try:
                conn.respond(call_id, error=repr(e))
            except FabricError:
                pass

    def _rpc_probe(self, p: dict, conn: Connection) -> dict:
        """Quarantine liveness/latency probe: answer as cheaply as
        possible — the CALLER measures the round-trip; all this end owes
        it is an immediate reply."""
        return {"replica_id": self.replica_id,
                "state": (self.replica.state.value
                          if self.replica is not None else None)}

    def _rpc_hello(self, p: dict, conn: Connection) -> dict:
        if int(p.get("codec_version", -1)) not in COMPAT_CODEC_VERSIONS:
            # typed refusal, matched by RemoteHandle.connect: a peer from
            # an incompatible codec generation must never be half-spoken
            # to (v1 and v2 interoperate: v2 only seals after BOTH ends
            # advertise, so a v1 peer simply never sees a trailer)
            raise ValueError(
                f"version_mismatch: server codec v{CODEC_VERSION}, "
                f"client v{p.get('codec_version')!r}")
        # frame-bound negotiation (both directions): this server never
        # sends more than the client's receive bound, and tells the
        # client its own so oversized payloads die at encode — typed,
        # degrading one payload — instead of at the peer's reader,
        # killing the connection
        client_bound = int(p.get("max_frame_bytes", 0) or 0)
        if client_bound:
            conn.send_max_bytes = (min(self.max_frame_bytes, client_bound)
                                   if self.max_frame_bytes
                                   else client_bound)
        # CRC sealing is client-driven: a client that advertised
        # ``crc_frames`` gets sealed frames both ways (the reply echoes
        # the flag so it flips its own direction on); one that didn't —
        # every pre-v2 peer — keeps the historical wire shape
        crc = bool(p.get("crc_frames", False))
        if crc:
            conn.crc_tx = True
            conn.crc_rx = True
        # digest deltas are OPT-IN per connection: a client that never
        # advertised keeps getting the full-snapshot wire shape
        self._digest_deltas = bool(p.get("digest_deltas", False))
        self._digest.reset()
        tel_changed = self._maybe_enable_telemetry(
            bool(p.get("telemetry", False)))
        # forwarding cursors restart with the connection: the journal
        # ring replays (the client dedupes by per-source seq), spans
        # start from now
        self._span_cursor = self.tracer.completed_total
        self._journal_fwd_seq = 0
        role = str(p.get("role", "mixed"))
        reset = bool(p.get("reset", False))
        if (self.replica is None or reset or self._role != role
                or tel_changed
                or self.replica.state in (ReplicaState.DEAD,
                                          ReplicaState.STOPPED)):
            self._build_replica(role, fresh_engine=reset)
        # fleet-visible connection record: rides the status stream into
        # the frontend's FleetJournal, so every server process has at
        # least one journaled event tagged with its source
        try:
            self.journal.emit("server_hello", replica=self.replica_id,
                              role=self._role, reset=reset)
        except Exception:           # journal must never kill serving
            pass
        eng = self._engine
        return {"replica_id": self.replica_id, "role": self._role,
                "codec_version": CODEC_VERSION, "pid": os.getpid(),
                "model_id": self.model_id, "source": self.source,
                "telemetry": self.tracer.enabled,
                "crc_frames": crc,
                "max_frame_bytes": int(self.max_frame_bytes),
                "max_seq_len": int(eng.model.cfg.max_seq_len),
                "max_seats": int(eng.config.max_ragged_sequence_count),
                "kv_block_size": int(eng.config.kv_block_size)}

    def _rpc_assign(self, p: dict, conn: Connection) -> bool:
        if self.replica is None:
            raise RuntimeError("assign before hello")
        req = request_from_wire(p["req"])
        if req.trace_id is not None and self.tracer.enabled:
            # propagated trace context: the server-side root span joins
            # the frontend's req-<uid> chain. remote_parent_id is the
            # FRONTEND-local id of the rpc span that carried this assign
            # — fleet.ingest_remote_spans re-parents on it verbatim,
            # which is what stitches the cross-process edge.
            attrs = {"replica": self.replica_id, "role": self._role,
                     "pid": os.getpid(), "uid": req.uid}
            parent = p.get("trace_parent")
            if parent is not None:
                attrs["remote_parent_id"] = int(parent)
            req.spans = {"request": self.tracer.begin(
                "server", trace_id=req.trace_id, attrs=attrs)}
        with self._lock:
            chunks = self._stage_rx.pop(req.uid, [])
        req.staged_kv = payload_from_chunks(p.get("staged_meta"), chunks)
        with self._lock:
            self._reqs[req.uid] = req
        ok = self.replica.assign(req)
        if ok:
            threading.Thread(target=self._pump, args=(req,), daemon=True,
                             name=f"fabric-pump-{req.uid}").start()
        else:
            with self._lock:
                self._reqs.pop(req.uid, None)
            if req.spans:
                req.spans["request"].set("refused", True)
                req.end_span("request")
        return ok

    def _rpc_evacuate(self, p: dict, conn: Connection) -> bool:
        if self.replica is None:
            return False
        self.replica.request_evacuation(self._evac_handback)
        return True

    def _rpc_dump(self, p: dict, conn: Connection) -> dict:
        """Bounded flight-record pull (the frontend's fleet
        ``debug_dump``). The record is trimmed OLDEST-FIRST — spans,
        then metric snapshots — until its JSON fits the client's byte
        bound: a partial recent record beats a dead connection from an
        oversized frame."""
        max_bytes = int(p.get("max_bytes", DUMP_MAX_BYTES)
                        or DUMP_MAX_BYTES)
        out = {"source": self.source, "role": self._role,
               "pid": os.getpid(), "record": None, "trimmed": 0}
        if self.recorder is None:
            return out
        rec = self.recorder.record()
        import json as _json
        while True:
            size = len(_json.dumps(rec, default=str))
            if size <= max_bytes:
                break
            spans, snaps = rec.get("spans") or [], \
                rec.get("metric_snapshots") or []
            if spans:
                drop = max(1, len(spans) // 2)
                rec["spans"] = spans[drop:]
            elif snaps:
                drop = max(1, len(snaps) // 2)
                rec["metric_snapshots"] = snaps[drop:]
            else:
                return out          # irreducibly oversized: send nothing
            out["trimmed"] += drop
        out["record"] = rec
        return out

    def _evac_handback(self, req, payload, replica_id: int) -> None:
        """Runs on the replica worker thread: stream the exported KV (if
        any) back to the frontend, chunk by chunk. NOTE trailing tokens
        may still sit in the request's pump queue; a mirror that missed
        some sees a seen_tokens mismatch at import and falls back to
        re-prefill — lossless either way (import failure is atomic)."""
        req._fabric_detached = True
        meta = self._send_payload(req.uid, payload)
        self._send_event({"t": "ev", "ev": "evacuated", "uid": req.uid,
                          "meta": meta})
        with self._lock:
            self._reqs.pop(req.uid, None)
        req.finish(RequestState.REJECTED, "draining")

    # ------------------------------------------------------------- pumping
    def _send_event(self, msg: dict) -> None:
        conn = self._conn
        if conn is None:
            return
        try:
            conn.send(msg)
        except FabricError:
            pass

    def _send_payload(self, uid: int, payload) -> Optional[dict]:
        """Stream a KV payload as chunk frames; returns the meta dict to
        stamp on the final event, or None when there is no payload OR a
        chunk broke the frame bound (the client degrades to
        re-prefill)."""
        meta, chunks = payload_chunks(payload)
        if meta is None:
            return None
        conn = self._conn
        if conn is None:
            return None
        try:
            for c in chunks:
                conn.send({"t": "ev", "ev": "payload_chunk", "uid": uid,
                           "slabs": c["slabs"]})
        except FrameTooLarge:
            self._send_event({"t": "ev", "ev": "payload_abort", "uid": uid})
            return None
        except FabricError:
            return None
        return meta

    def _pump(self, req) -> None:
        """Per-request event pump: the request's queue is the ordering
        authority — tokens first, then exactly one terminal marker
        (finish / failover / handoff)."""
        while True:
            ev = req._events.get()
            if isinstance(ev, DoneEvent):
                break
            self._send_event({"t": "ev", "ev": "token", "uid": req.uid,
                              "token": ev.token})
        with self._lock:
            self._reqs.pop(req.uid, None)
        if getattr(req, "_fabric_failover", False):
            self._send_event({"t": "ev", "ev": "failover", "uid": req.uid})
            return
        payload = getattr(req, "_fabric_handoff_payload", None)
        if req.finish_reason == "prefilled":
            meta = self._send_payload(req.uid, payload)
            self._send_event({"t": "ev", "ev": "handoff", "uid": req.uid,
                              "meta": meta})
            return
        if getattr(req, "_fabric_detached", False):
            return                  # evacuation sent its own marker
        self._send_event({"t": "ev", "ev": "finish", "uid": req.uid,
                          "reason": req.finish_reason,
                          "state": req.state.value})

    # -------------------------------------------------------------- status
    def _status_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(STATUS_INTERVAL_S)
            rep, conn = self.replica, self._conn
            if rep is None or conn is None or not conn.alive:
                continue
            try:
                rep.check_health()
                snap = self.registry.snapshot()
                counters = {n: float(snap.get(n, 0.0))
                            for n in RemoteHandle._FORWARDED_COUNTERS}
                eng = self._engine
                ev = {
                    "t": "ev", "ev": "status",
                    "state": rep.state.value,
                    "thread_alive": rep.thread.is_alive(),
                    "occupancy": eng.occupancy(),
                    "param_stats": eng.param_stats(),
                    "tier_stats": eng.tier_stats(),
                    "counters": counters}
                # fleet KV locality (docs/SERVING.md "Fleet KV
                # locality"): the prefix digest rides the status stream
                # as OPTIONAL fields — extra dict fields are
                # backward-compatible on the wire, and a frontend never
                # requires one (a digest-less peer is cache-blind).
                # Clients that advertised digest_deltas in the hello
                # get add/evict deltas after the first full snapshot.
                aff = getattr(self.config, "affinity", None)
                if aff is not None and aff.enabled:
                    fn = getattr(eng, "prefix_digest", None)
                    if fn is not None:
                        self._digest.stamp(ev, fn(aff.digest_max_entries),
                                           self._digest_deltas)
                # fleet observability (docs/OBSERVABILITY.md "Fleet
                # observability"): completed spans and journal events
                # delta-forward as OPTIONAL status fields (the digest
                # idiom — no new RPC, old frontends ignore them, absent
                # fields cost zero bytes). Bounded per frame; leftovers
                # ride the next tick.
                if self.tracer.enabled:
                    spans, self._span_cursor = self.tracer.drain_completed(
                        self._span_cursor, limit=SPANS_PER_STATUS)
                    if spans:
                        ev["spans"] = spans
                jev = self.journal.events(
                    since_seq=self._journal_fwd_seq)[
                        :JOURNAL_EVENTS_PER_STATUS]
                if jev:
                    ev["journal"] = {"source": self.journal.source,
                                     "events": jev}
                    self._journal_fwd_seq = int(jev[-1]["seq"])
                self._send_event(ev)
            except Exception as e:  # pragma: no cover - defensive
                logger.error(f"fabric replica server {self.replica_id}: "
                             f"status tick failed: {e!r}")
