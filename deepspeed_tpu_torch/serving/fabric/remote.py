"""RemoteHandle — the EngineHandle over a replica server process.

Presents the exact surface the router/supervisor/frontend speak
(``fabric/handle.py``: assign, drain, evacuate, stop, check_health, the
load split, ``engine``/``thread`` facades) while the actual worker — a
plain :class:`~deepspeed_tpu_torch.serving.replica.Replica` over a (possibly
TP-sharded) engine — runs in a server process (fabric/server.py) behind
the RPC transport.

Mirroring contract: the handle keeps a client-side image of every
in-flight request (the real ``ServingRequest`` with its stream) and the
same phase-split load accounting as Replica, fed by the server's ordered
event stream (token → finish/failover/handoff per uid, in order, on one
TCP connection). Tokens the server emitted but the connection lost are
NOT a correctness problem: failover resumes from prompt + *delivered*
tokens, and greedy decoding regenerates the lost suffix byte-identically
— the same argument that makes thread-death failover lossless makes
transport-loss failover lossless.

**A dead connection is a dead replica**: ``check_health`` maps transport
loss (or a stale heartbeat window) to ``ReplicaState.DEAD``, fails the
mirrored in-flight requests through the failover path (requeue +
resume elsewhere), and lets the supervisor's restart machinery
re-dial/reset the server — ``replica_disconnected`` /
``replica_reconnected`` land in the ops journal, ``handle_disconnects``
counts, and per-call ``rpc_call_s`` / ``rpc_inflight`` / ``rpc_retries``
carry the transport's health (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional

from ...telemetry.fleet import ingest_remote_spans, source_id_offset
from ...utils.locks import RankedLock
from ...utils.logging import logger
from ...utils.restart import RestartPolicy
from ..replica import ReplicaState
from ..request import FinishReason, RequestState, ServingRequest
from .codec import CODEC_VERSION, FrameTooLarge, ModelMismatch, \
    payload_chunks, payload_from_chunks, request_to_wire
from .transport import ConnectionLost, FabricError, RPCTimeout, dial

#: default byte bound for the ``dump`` RPC response (well under the
#: 64 MiB frame ceiling; callers may lower it per pull)
DUMP_MAX_BYTES = 4 * 1024 * 1024

class _ModelCfgFacade:
    def __init__(self, max_seq_len: int):
        self.max_seq_len = int(max_seq_len)


class _ModelFacade:
    def __init__(self, max_seq_len: int):
        self.cfg = _ModelCfgFacade(max_seq_len)


class _EngineCfgFacade:
    def __init__(self, max_ragged_sequence_count: int, kv_block_size: int):
        self.max_ragged_sequence_count = int(max_ragged_sequence_count)
        self.kv_block_size = int(kv_block_size)


class _EngineFacade:
    """What the frontend reads off ``handle.engine``: static shape from
    the hello exchange, occupancy/param/tier snapshots from the latest
    status event. No RPC happens here — facade reads are hot-path."""

    def __init__(self, handle: "RemoteHandle", info: dict):
        self._h = handle
        self.model = _ModelFacade(info["max_seq_len"])
        self.config = _EngineCfgFacade(info["max_seats"],
                                       info.get("kv_block_size", 16))

    def occupancy(self) -> dict:
        return dict(self._h._last_occupancy)

    def param_stats(self) -> dict:
        return dict(self._h._last_param_stats)

    def tier_stats(self) -> dict:
        return dict(self._h._last_tier_stats)


class _ThreadFacade:
    """Stands in for ``Replica.thread``: "alive" means the server-side
    worker is still running AND reachable — what drain/removal waits
    on. A lost connection reads as not-alive (nothing left to wait
    for; the requests already failed over)."""

    def __init__(self, handle: "RemoteHandle"):
        self._h = handle

    def is_alive(self) -> bool:
        h = self._h
        conn = h._conn
        return (conn is not None and conn.alive
                and h._server_thread_alive
                and h.state not in (ReplicaState.STOPPED,))

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        while self.is_alive():
            if deadline is not None and time.monotonic() >= deadline:
                return
            time.sleep(0.005)


class RemoteHandle:
    # lock discipline (docs/CONCURRENCY.md): the mirrored request table
    # and the phase-split load accounting are hit from the router's
    # dispatch thread (assign), the transport reader thread (token/
    # finish/failover events) and the supervisor (check_health) — the
    # Replica discipline, with the transport standing in for the worker
    # thread. Frontend callbacks (failover/handoff requeue) always run
    # with this lock RELEASED — they take lower-ranked queue/stager
    # locks.
    _GUARDED_BY = {
        "_outstanding": "_lock",
        "_out_prefill": "_lock",
        "_out_decode": "_lock",
        "_failed_uids": "_lock",
        "_active": "_lock",
        "_q_samples": "_lock",
        "_q_history": "_lock",
    }

    #: autoscaler/frontend probe: remote capacity is owned by its server
    #: process (shrinking it drops the connection, not the chips)
    is_remote = True

    #: hello-refusal markers that are PERMANENT for this peer pair —
    #: retrying the connect cannot fix them, so the backoff loop
    #: re-raises the typed error verbatim instead of burning the
    #: breaker. Subclasses extend (federation adds its peering
    #: refusals).
    _PERMANENT_HELLO_MARKERS: tuple = ()

    #: server-private engine/scheduler counters forwarded into the fleet
    #: registry as deltas (the Replica._publish_prefix_stats idiom
    #: across the process boundary). Deliberately excludes the
    #: request-lifecycle counters (requests_completed, tokens_generated,
    #: ttft/tpot...) — the handle mirrors those client-side from the
    #: event stream, where the numbers include RPC latency (the honest
    #: fleet-level view).
    _FORWARDED_COUNTERS = (
        "prefix_blocks_hit", "prefix_blocks_missed",
        "prefix_blocks_evicted", "prefix_tokens_saved",
        "spec_tokens_proposed", "spec_tokens_accepted",
        "spec_tokens_emitted", "spec_decode_forwards",
        "kv_tier_blocks_spilled", "kv_tier_blocks_restored",
        "kv_tier_blocks_dropped",
        "sequences_preempted", "sequences_resumed",
        "handoffs_completed", "handoff_fallbacks",
        # corrupt frames the SERVER refused on this pair's connection —
        # the client-side refusals land in the frontend registry
        # directly via the transport's on_corrupt hook
        "rpc_frames_corrupt",
    )

    def __init__(self, replica_id: int, address: str, fabric_config, *,
                 role: str = "mixed", metrics=None, tracer=None,
                 recorder=None, journal=None, fleet=None,
                 on_failover: Optional[Callable] = None,
                 on_handoff: Optional[Callable] = None,
                 model_id: str = "default"):
        from ...telemetry import NOOP_TRACER

        self.replica_id = replica_id
        self.address = address
        self.fabric = fabric_config
        self.role = role
        # multi-model serving (docs/SERVING.md "Multi-model &
        # multi-tenant serving"): the model pool this peer is adopted
        # into; the hello exchange verifies the server really hosts it
        self.model_id = str(model_id)
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.recorder = recorder
        self.journal = journal
        # fleet observability (docs/OBSERVABILITY.md "Fleet
        # observability"): the frontend's FleetJournal, fed by the
        # journal batches the server's status stream carries; None in a
        # bare handle (events are then dropped, never an error)
        self.fleet = fleet
        # remote span ids land in this handle's private id range; the
        # hello fills in the server's identity for source/pid stamping
        self._span_offset = source_id_offset(int(replica_id))
        self._source = f"replica-{replica_id}@{address}"
        self._server_pid: Optional[int] = None
        # last-write-wins publications from the transport reader (the
        # _last_occupancy idiom): status recency + rpc accounting for
        # the fleet ops surface
        self._last_status_t = 0.0
        self._rpc_calls = 0
        self._rpc_time_s = 0.0
        self._on_failover = on_failover
        # (req, payload, replica_id) — the frontend's remote-handoff
        # staging entry point (export already ran server-side)
        self._on_handoff = on_handoff
        self._evac_handback: Optional[Callable] = None
        self.state = ReplicaState.HEALTHY
        self._lock = RankedLock("serving.fabric.remote")
        self._active: Dict[int, ServingRequest] = {}
        self._failed_uids: set = set()
        self._outstanding = 0
        self._out_prefill = 0
        self._out_decode = 0
        self._conn = None
        self._connected_once = False
        self._server_thread_alive = True
        self._last_occupancy: dict = {}
        self._last_param_stats: dict = {}
        self._last_tier_stats: dict = {}
        # last digest the server's status stream carried (docs/SERVING.md
        # "Fleet KV locality") — last-write-wins publication from the
        # transport reader, like the snapshots above; empty until a
        # digest-bearing status arrives (a digest-less peer stays
        # cache-blind forever, which is correct, never an error)
        self._last_prefix_digest: frozenset = frozenset()
        # digest-DELTA stream state (the wire thinning): the
        # server numbers delta frames with a monotonic epoch per
        # connection; None until a numbered full snapshot arrives (an
        # old server never numbers, so deltas never apply — it keeps
        # sending full snapshots anyway)
        self._digest_epoch: Optional[int] = None
        self._counters_last: Dict[str, float] = {}
        self._rx_chunks: Dict[int, list] = {}
        self._dead_reason: Optional[str] = None
        # connect retry/backoff rides the shared supervisor discipline
        # (utils/restart.py): capped exponential backoff with seeded
        # jitter; the breaker tripping means give up this connect —
        # the SUPERVISOR owns longer-horizon restart policy
        self._restart = RestartPolicy(
            backoff_s=0.05, backoff_max_s=1.0, jitter=0.2,
            max_failures_in_window=6, window_s=60.0,
            rng=random.Random(1000 + replica_id), full_jitter=True)
        # gray-failure quarantine (docs/SERVING.md "Fleet fault
        # tolerance"): rolling slow/deadline-miss scoring over the
        # rpc_call_s samples already taken in _call. None/disabled =
        # zero overhead beyond one attribute test per RPC.
        self._qcfg = getattr(fabric_config, "quarantine", None)
        if self._qcfg is not None and not getattr(self._qcfg, "enabled",
                                                  False):
            self._qcfg = None
        win = int(getattr(self._qcfg, "window", 32) or 32)
        self._q_samples: "deque[int]" = deque(maxlen=max(1, win))
        self._q_history: "deque[float]" = deque()
        self._q_since = 0.0                 # entered QUARANTINED at
        self._q_probe_next = 0.0
        self._q_probe_backoff = 0.0
        self._q_probing = False             # one probe thread at a time
        self.thread = _ThreadFacade(self)
        self.engine = None                  # _EngineFacade after connect

    # ------------------------------------------------------------ connect
    def _hello_payload(self, reset: bool) -> dict:
        """The hello frame; subclasses extend (federation adds frontend
        identity + export binding). ``digest_deltas`` advertises the
        digest-delta decode capability on the status stream — the
        optional-field idiom: old servers ignore the flag, and an old
        CLIENT never sets it, so a new server keeps sending it full
        snapshots."""
        return {
            "codec_version": CODEC_VERSION,
            "replica_id": self.replica_id,
            "role": self.role,
            "model_id": self.model_id,
            "max_frame_bytes": int(self.fabric.max_frame_bytes),
            "digest_deltas": True,
            # a tracing frontend asks the server to trace too (the
            # propagated req-<uid> chains need server-side spans); old
            # servers ignore the flag, a non-tracing frontend never
            # sets it — the byte-parity story stays intact
            "telemetry": bool(self.tracer.enabled),
            # CRC frame sealing (codec v2): advertise decode capability;
            # a server that also speaks v2 echoes the flag back and both
            # directions seal. Old servers ignore it, and frame_crc
            # False pins the unsealed wire shape byte for byte.
            "crc_frames": bool(getattr(self.fabric, "frame_crc", True)),
            "reset": bool(reset)}

    def connect(self, reset: bool = False) -> None:
        """Dial the replica server and run the hello exchange (codec
        version check, role assignment, optional fresh-engine reset —
        the supervisor-restart path). Retries with backoff+jitter via
        the shared RestartPolicy; raises :class:`ConnectionLost` once
        the policy's breaker trips."""
        last_err: Optional[Exception] = None
        while True:
            try:
                self._conn = dial(
                    self.address,
                    timeout_s=self.fabric.rpc_timeout_s,
                    max_frame_bytes=self.fabric.max_frame_bytes,
                    heartbeat_s=self.fabric.heartbeat_s,
                    on_event=self._on_event,
                    on_corrupt=self._on_frame_corrupt,
                    name=f"fabric-r{self.replica_id}")
                info = self._call("hello", self._hello_payload(reset))
                # model identity check (docs/SERVING.md "Multi-model &
                # multi-tenant serving"): adopting a peer that hosts a
                # different model would silently misroute every request
                # of this pool — refuse typed, like a codec mismatch.
                # Older servers don't report one; trust the spec then.
                srv_model = info.get("model_id")
                if srv_model is not None and srv_model != self.model_id:
                    self._conn.close("model mismatch")
                    self._conn = None
                    raise ModelMismatch(
                        f"fabric replica {self.replica_id}: peer at "
                        f"{self.address} hosts model {srv_model!r}, "
                        f"expected {self.model_id!r}")
                # frame-bound negotiation: never SEND more than the peer
                # can receive — an oversized payload must die at encode
                # (typed, degrades to re-prefill), not kill the peer's
                # reader and the whole connection with it
                srv_bound = int(info.get("max_frame_bytes", 0) or 0)
                if srv_bound:
                    mine = int(self.fabric.max_frame_bytes)
                    self._conn.send_max_bytes = (min(mine, srv_bound)
                                                 if mine else srv_bound)
                # CRC negotiation: the server echoes ``crc_frames`` only
                # when BOTH ends advertised — from here every frame each
                # way carries the v2 trailer, and bit damage on this
                # link is a typed single-frame refusal, not a
                # connection-killing CodecError
                if info.get("crc_frames") and getattr(
                        self.fabric, "frame_crc", True):
                    self._conn.crc_tx = True
                    self._conn.crc_rx = True
                break
            except (OSError, FabricError) as e:
                last_err = e
                if self._conn is not None:
                    self._conn.close(f"connect failed: {e!r}")
                    self._conn = None
                if "version_mismatch:" in str(e):
                    # the server's hello refusal (fabric/server.py emits
                    # the "version_mismatch:" marker): a codec-generation
                    # gap is permanent for this pair of binaries —
                    # retrying cannot fix it. The remote text names both
                    # versions; preserve it verbatim.
                    from .codec import VersionMismatch

                    raise VersionMismatch(detail=str(e))
                if any(m in str(e) for m in self._PERMANENT_HELLO_MARKERS):
                    raise
                _, backoff = self._restart.record_failure(time.monotonic())
                if backoff is None:
                    raise ConnectionLost(
                        f"fabric replica {self.replica_id}: could not "
                        f"connect to {self.address}: {last_err!r}")
                if self.metrics is not None:
                    self.metrics.counter("rpc_retries").inc()
                time.sleep(backoff)
        self.engine = _EngineFacade(self, info)
        self._server_thread_alive = True
        self._digest_epoch = None   # fresh stream: next digest is full
        # server identity for span/journal source tagging (older servers
        # report neither; the address-based fallback stays)
        pid = info.get("pid")
        self._server_pid = int(pid) if pid is not None else None
        src = info.get("source")
        if src:
            self._source = str(src)
        # a reset connect is the supervisor-restart path: this handle is
        # fresh, but the PEER is being re-attached after a disconnect —
        # journal the recovery half of replica_disconnected
        if (reset or self._connected_once) and self.journal is not None:
            try:
                self.journal.emit("replica_reconnected",
                                  replica=self.replica_id)
            except Exception:       # journal must never kill serving
                pass
        self._connected_once = True

    def start(self) -> None:
        """Router lifecycle hook; the connection already runs (dialed at
        construction by the frontend), so this is a liveness assert, not
        a thread start."""
        if self._conn is None:
            self.connect()

    # --------------------------------------------------------------- rpc
    def _call(self, method: str, payload: Optional[dict] = None,
              timeout_s: Optional[float] = None):
        """One timed, gauged RPC call (rpc_call_s / rpc_inflight)."""
        conn = self._conn
        if conn is None:
            raise ConnectionLost("not connected")
        t0 = time.monotonic()
        if self.metrics is not None:
            self.metrics.gauge("rpc_inflight").inc()
        miss = False
        try:
            return conn.call(method, payload,
                             timeout_s=(timeout_s if timeout_s is not None
                                        else self.fabric.rpc_timeout_s))
        except RPCTimeout:
            miss = True                     # deadline miss = slow sample
            raise
        finally:
            dt = time.monotonic() - t0
            self._rpc_calls += 1
            self._rpc_time_s += dt
            if self.metrics is not None:
                self.metrics.gauge("rpc_inflight").dec()
                self.metrics.histogram("rpc_call_s").observe(dt)
            if self._qcfg is not None:
                self._q_observe(dt, miss)

    def _notify(self, msg: dict) -> bool:
        conn = self._conn
        if conn is None:
            return False
        try:
            conn.send(msg)
            return True
        except FabricError:
            return False

    def _on_frame_corrupt(self) -> None:
        """Transport reader hook: one sealed frame failed its CRC and
        was refused (connection intact)."""
        if self.metrics is not None:
            self.metrics.counter("rpc_frames_corrupt").inc()

    # --------------------------------------------------------- quarantine
    # Gray failure: a replica that ANSWERS — so the liveness machinery
    # sees nothing — but too slowly to be worth routing to. The scoring
    # rides the rpc_call_s samples _call already takes: a sample is bad
    # when it exceeded ``rpc_slow_s`` or missed its deadline outright,
    # and when ``slow_fraction`` of the last ``window`` samples are bad
    # the handle leaves the routable set (QUARANTINED: accepting False,
    # in-flight streams keep running). Probe RPCs on exponential backoff
    # re-admit it; re-quarantining ``escalate_quarantines`` times inside
    # ``escalate_window_s`` stops giving benefit of the doubt and takes
    # the ordinary DEAD/failover path.

    def _q_observe(self, dt: float, miss: bool) -> None:
        q = self._qcfg
        if q is None:
            return
        fire = False
        n = 0
        with self._lock:
            self._q_samples.append(
                1 if (miss or dt >= q.rpc_slow_s) else 0)
            n = len(self._q_samples)
            if (self.state == ReplicaState.HEALTHY
                    and n >= max(1, q.min_samples)):
                frac = sum(self._q_samples) / n
                fire = frac >= q.slow_fraction
        if fire:
            self._quarantine(f"slow RPCs: >= {q.slow_fraction:.0%} of "
                             f"last {n} calls over {q.rpc_slow_s}s")

    def _quarantine(self, reason: str) -> None:
        q = self._qcfg
        now = time.monotonic()
        with self._lock:
            if self.state != ReplicaState.HEALTHY:
                return
            self._q_history.append(now)
            while self._q_history and \
                    now - self._q_history[0] > q.escalate_window_s:
                self._q_history.popleft()
            n_hist = len(self._q_history)
            escalate = n_hist >= max(1, q.escalate_quarantines)
            if not escalate:
                self.state = ReplicaState.QUARANTINED
                self._q_since = now
                self._q_probe_backoff = q.probe_backoff_s
                self._q_probe_next = now + self._q_probe_backoff
                self._q_samples.clear()
        if escalate:
            # benefit of the doubt exhausted: repeated gray failure is
            # failure — DEAD fails the mirrored streams over (failover path)
            # and the supervisor owns recovery
            self._mark_dead(f"quarantine escalation "
                            f"({n_hist} quarantines in "
                            f"{q.escalate_window_s}s): {reason}")
            return
        logger.warning(f"fabric replica {self.replica_id} QUARANTINED: "
                       f"{reason}")
        if self.journal is not None:
            try:
                self.journal.emit("replica_quarantined",
                                  replica=self.replica_id, reason=reason)
            except Exception:       # journal must never kill serving
                pass

    def _maybe_probe(self, now: float) -> None:
        """check_health tick while QUARANTINED: launch at most one probe
        RPC at a time, off-thread (the health sweep must never block on
        a slow peer — that is the failure being probed)."""
        with self._lock:
            if (self.state != ReplicaState.QUARANTINED
                    or self._q_probing or now < self._q_probe_next):
                return
            self._q_probing = True
        threading.Thread(target=self._probe_once, daemon=True,
                         name=f"fabric-r{self.replica_id}-probe").start()

    def _probe_once(self) -> None:
        q = self._qcfg
        t0 = time.monotonic()
        try:
            try:
                self._call("probe", {}, timeout_s=max(q.rpc_slow_s, 0.05))
                ok = True
            except (RPCTimeout, ConnectionLost):
                ok = False
            except FabricError:
                # an ERROR RESPONSE is still a fast round-trip — a peer
                # that predates the probe method refuses quickly, and
                # latency is what is on trial here, not the method table
                ok = time.monotonic() - t0 < q.rpc_slow_s
            if ok:
                self._readmit()
            else:
                with self._lock:
                    self._q_probe_backoff = min(
                        self._q_probe_backoff * 2.0, q.probe_backoff_max_s)
                    self._q_probe_next = time.monotonic() \
                        + self._q_probe_backoff
        finally:
            with self._lock:
                self._q_probing = False

    def _readmit(self) -> None:
        with self._lock:
            if self.state != ReplicaState.QUARANTINED:
                return
            self.state = ReplicaState.HEALTHY
            held_s = time.monotonic() - self._q_since
            self._q_samples.clear()
        logger.info(f"fabric replica {self.replica_id} re-admitted after "
                    f"{held_s:.2f}s in quarantine")
        if self.journal is not None:
            try:
                self.journal.emit("replica_readmitted",
                                  replica=self.replica_id,
                                  quarantined_s=round(held_s, 3))
            except Exception:
                pass

    # ------------------------------------------------------------ routing
    @property
    def outstanding_tokens(self) -> int:
        with self._lock:
            return self._outstanding

    @property
    def outstanding_prefill_tokens(self) -> int:
        with self._lock:
            return self._out_prefill

    @property
    def outstanding_decode_tokens(self) -> int:
        with self._lock:
            return self._out_decode

    def prefix_digest(self, max_entries: int = 512) -> frozenset:
        """The last prefix digest this peer's status stream carried
        (docs/SERVING.md "Fleet KV locality") — already bounded by the
        SERVER's ``affinity.digest_max_entries``, so ``max_entries`` is
        accepted only for signature parity with the local Replica.
        Empty for a digest-less (pre-affinity) peer: cache-blind, never
        an error."""
        return self._last_prefix_digest

    @property
    def accepting(self) -> bool:
        return self.state == ReplicaState.HEALTHY

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    @property
    def has_capacity(self) -> bool:
        return self.active_count < self.engine.config.max_ragged_sequence_count

    def _charge_locked(self, req: ServingRequest, staged: bool) -> None:
        pre = 0 if staged else len(req.resume_prompt())
        req._charged_prefill = pre
        self._out_prefill += pre
        self._out_decode += req.remaining_new_tokens

    def _discharge_locked(self, req: ServingRequest) -> None:
        self._out_prefill = max(0, self._out_prefill - req._charged_prefill)
        req._charged_prefill = 0
        self._out_decode = max(0, self._out_decode
                               - req.remaining_new_tokens)

    def assign(self, req: ServingRequest) -> bool:
        """Router hand-off across the wire. The staged-KV payload (if
        any) streams ahead as per-chunk frames; a payload that breaks
        the frame bound is dropped to the re-prefill fallback (lossless)
        rather than refused. False when the replica cannot take work —
        including any transport failure (the router repicks)."""
        if not self.accepting:
            return False
        payload = req.take_staged()
        staged_meta, chunks = payload_chunks(payload)
        with self._lock:
            self._failed_uids.discard(req.uid)
            self._active[req.uid] = req
            self._outstanding += req.outstanding_tokens
            self._charge_locked(req, staged_meta is not None)
        req.replica_id = self.replica_id
        req._fabric_staged = staged_meta is not None \
            and not (payload or {}).get("evacuated")
        if req.spans is not None:
            req.end_span("route")
            req.begin_span(self.tracer, "admit",
                           attrs={"replica": self.replica_id})
            req.begin_span(self.tracer, "rpc",
                           attrs={"replica": self.replica_id,
                                  "addr": self.address})
        try:
            for i, c in enumerate(chunks):
                try:
                    self._conn.send({"t": "ev", "ev": "stage_chunk",
                                     "uid": req.uid, "i": i,
                                     "n": len(chunks), "slabs": c["slabs"]})
                except FrameTooLarge:
                    # payload over the wire bound: recompute fallback —
                    # the server re-prefills resume_prompt() instead
                    self._conn.send({"t": "ev", "ev": "stage_abort",
                                     "uid": req.uid})
                    staged_meta = None
                    req._fabric_staged = False
                    if self.metrics is not None:
                        self.metrics.counter("handoff_fallbacks").inc()
                    if self.journal is not None:
                        self.journal.emit("handoff_fallback", uid=req.uid,
                                          where="wire",
                                          replica=self.replica_id)
                    with self._lock:
                        # re-charge the real prefill load (the staged
                        # charge was 0)
                        req._charged_prefill = len(req.resume_prompt())
                        self._out_prefill += req._charged_prefill
                    break
            rpc_span = req.spans.get("rpc") if req.spans is not None \
                else None
            ok = bool(self._call("assign", {
                "req": request_to_wire(req),
                "staged_meta": staged_meta,
                "trace": req.trace_id is not None,
                # the frontend-local id the server's root span parents
                # onto (docs/OBSERVABILITY.md "Fleet observability") —
                # optional field, old servers ignore it
                "trace_parent": (rpc_span.span_id
                                 if rpc_span is not None else None)}))
            rpc_failed = False
        except FabricError as e:
            logger.warning(f"fabric replica {self.replica_id}: assign of "
                           f"request {req.uid} failed ({e!r})")
            ok = False
            rpc_failed = True
        if not ok:
            with self._lock:
                self._active.pop(req.uid, None)
                self._outstanding = max(0, self._outstanding
                                        - req.outstanding_tokens)
                self._discharge_locked(req)
            req.replica_id = None
            req.end_span("rpc")
            req.end_span("admit")   # re-opened by the next assign
            if staged_meta is not None or payload is not None:
                # the staged payload was consumed (its slot freed) and
                # cannot be re-staged — keep the request decode-phase so
                # the router can't bounce it through another prefill
                # (recompute on a decode-capable replica, lossless)
                req.no_prefill = True
            if rpc_failed:
                # an assign whose RPC FAILED (timeout, send error) is
                # ambiguous: the server may have adopted the request and
                # be streaming it. Requeueing while this handle stays
                # HEALTHY could re-run the same uid — duplicate tokens,
                # broken at-most-once. Ambiguity = replica failure: the
                # DEAD transition closes the connection, the server's
                # disconnect path cancels any ghost, and the supervisor
                # reconnects with a clean reset.
                self._mark_dead("assign RPC failed (ambiguous adoption)")
            return False
        if req.cancel_requested.is_set():
            # close the cancel-vs-dispatch race: a cancel() that ran
            # while this assign was in flight saw replica_id None and
            # could not notify the peer — the wire request carries no
            # cancel bit, so the flag must be re-sent from here (local
            # replicas share the request OBJECT and poll the flag; a
            # server-side mirror does not)
            self.notify_cancel(req)
        return True

    def notify_cancel(self, req: ServingRequest) -> None:
        """Frontend cancel plumbing: the server replica polls ITS
        request's cancel flag, so the flag must cross the wire."""
        self._notify({"t": "ev", "ev": "cancel", "uid": req.uid})

    # ------------------------------------------------------------- events
    def _on_event(self, msg: dict) -> None:
        ev = msg.get("ev")
        if ev == "token":
            self._ev_token(msg)
        elif ev == "finish":
            self._ev_finish(msg)
        elif ev == "failover":
            self._ev_failover(msg)
        elif ev == "payload_chunk":
            self._rx_chunks.setdefault(int(msg["uid"]), []).append(
                {"slabs": msg["slabs"]})
        elif ev == "payload_abort":
            # the server hit the frame bound mid-payload: drop what
            # accumulated now (the terminal handoff/evacuated event
            # carries meta=None and takes the re-prefill fallback)
            self._rx_chunks.pop(int(msg["uid"]), None)
        elif ev == "handoff":
            self._ev_handoff(msg)
        elif ev == "evacuated":
            self._ev_evacuated(msg)
        elif ev == "status":
            self._ev_status(msg)

    def _first_evidence(self, req: ServingRequest) -> None:
        """First server event for a request closes its transport span
        and the admit stage (the server-side scheduler owns
        prefill/decode stages on its own tracer)."""
        req.end_span("admit")
        req.end_span("rpc")

    def _ev_token(self, msg: dict) -> None:
        uid, token = int(msg["uid"]), int(msg["token"])
        with self._lock:
            if uid in self._failed_uids:
                return
            req = self._active.get(uid)
            if req is None:
                return
            prev_t = req.last_token_t
            req.push_token(token)
            self._outstanding = max(0, self._outstanding - 1)
            if req._charged_prefill:
                self._out_prefill = max(0, self._out_prefill
                                        - req._charged_prefill)
                req._charged_prefill = 0
            self._out_decode = max(0, self._out_decode - 1)
        if prev_t is None:
            self._first_evidence(req)
        if self.metrics is not None:
            self.metrics.counter("tokens_generated").inc()
            if prev_t is None:
                dt = req.first_token_t - req.arrival_t
                self.metrics.histogram("ttft_s").observe(dt)
                self.metrics.histogram(
                    f"ttft_s_class_{req.request_class}").observe(dt)
                if req.tenant != "default":
                    self.metrics.histogram(
                        f"ttft_s_tenant_{req.tenant}").observe(dt)
                if getattr(req, "_fabric_staged", False) \
                        and req.handoff_t is not None:
                    # staging -> first decoded token: the import ran
                    # server-side, so first-token arrival is the
                    # client-visible end of the handoff
                    self.metrics.histogram("handoff_s").observe(
                        time.monotonic() - req.handoff_t)
            else:
                dt = req.last_token_t - prev_t
                self.metrics.histogram("tpot_s").observe(dt)
                self.metrics.histogram(
                    f"tpot_s_class_{req.request_class}").observe(dt)
                if req.tenant != "default":
                    self.metrics.histogram(
                        f"tpot_s_tenant_{req.tenant}").observe(dt)

    def _detach(self, uid: int) -> Optional[ServingRequest]:
        """Pop a mirrored request and settle its load accounting; None
        when a failure path already took it."""
        with self._lock:
            if uid in self._failed_uids:
                return None
            req = self._active.pop(uid, None)
            if req is None:
                return None
            self._outstanding = max(0, self._outstanding
                                    - req.outstanding_tokens)
            self._discharge_locked(req)
            return req

    def _ev_finish(self, msg: dict) -> None:
        req = self._detach(int(msg["uid"]))
        if req is None:
            return
        self._first_evidence(req)
        reason = msg.get("reason", FinishReason.ERROR)
        if reason == FinishReason.CANCELLED:
            req.finish(RequestState.CANCELLED, reason)
            if self.metrics is not None:
                self.metrics.counter("requests_cancelled").inc()
            return
        if reason == FinishReason.DEADLINE:
            req.finish(RequestState.EXPIRED, reason)
            if self.metrics is not None:
                self.metrics.counter("requests_expired").inc()
            return
        if reason == FinishReason.ERROR:
            self._fail_request(req, FinishReason.ERROR, RequestState.FAILED,
                               already_detached=True)
            return
        req.finish(RequestState.FINISHED, reason)
        if self.metrics is not None:
            self.metrics.counter("requests_completed").inc()
            self.metrics.histogram("e2e_latency_s").observe(
                time.monotonic() - req.arrival_t)

    def _ev_failover(self, msg: dict) -> None:
        """Server-side replica death/fault: the stream resumes elsewhere
        from the tokens the client actually mirrored (any token the
        server emitted past that is regenerated identically — greedy)."""
        uid = int(msg["uid"])
        with self._lock:
            req = self._active.pop(uid, None) if uid not in \
                self._failed_uids else None
            if req is not None:
                self._failed_uids.add(uid)
                self._outstanding = max(0, self._outstanding
                                        - req.outstanding_tokens)
                self._discharge_locked(req)
        if req is None:
            return
        self._first_evidence(req)
        self._finish_failed(req)

    def _ev_handoff(self, msg: dict) -> None:
        """Remote prefill completion: the export ran server-side; stage
        the payload client-side and requeue for a decode-capable
        replica (meta None = server export failed → same recompute
        fallback path)."""
        uid = int(msg["uid"])
        chunks = self._rx_chunks.pop(uid, [])
        payload = payload_from_chunks(msg.get("meta"), chunks)
        req = self._detach(uid)
        if req is None:
            return
        self._first_evidence(req)
        if self._on_handoff is not None:
            self._on_handoff(req, payload, self.replica_id)
            return
        req.finish(RequestState.FAILED, FinishReason.ERROR)
        if self.metrics is not None:
            self.metrics.counter("requests_failed").inc()

    def _ev_evacuated(self, msg: dict) -> None:
        uid = int(msg["uid"])
        chunks = self._rx_chunks.pop(uid, [])
        payload = payload_from_chunks(msg.get("meta"), chunks)
        with self._lock:
            if uid in self._failed_uids:
                return
            self._failed_uids.add(uid)
            req = self._active.pop(uid, None)
            if req is not None:
                self._outstanding = max(0, self._outstanding
                                        - req.outstanding_tokens)
                self._discharge_locked(req)
        if req is None:
            return
        cb = self._evac_handback
        if cb is not None:
            cb(req, payload, self.replica_id)

    def _ev_status(self, msg: dict) -> None:
        # prune the failed-uid gate on every status frame: a uid enters
        # the set via a failover/evacuated MARKER (nothing follows it
        # for that uid on this ordered stream — the pump sends the
        # marker last) or via _mark_dead (the stream itself is gone), so
        # by the time a later status frame arrives no suppressed-late
        # event can still be in flight. Without this the set grows for
        # the handle's whole life under evacuation/restart churn.
        with self._lock:
            if self._failed_uids and self.state in (
                    ReplicaState.HEALTHY, ReplicaState.DRAINING,
                    ReplicaState.QUARANTINED):
                self._failed_uids.clear()
        self._server_thread_alive = bool(msg.get("thread_alive", True))
        self._last_occupancy = msg.get("occupancy") or {}
        self._last_param_stats = msg.get("param_stats") or {}
        self._last_tier_stats = msg.get("tier_stats") or {}
        # OPTIONAL fields: only servers with affinity enabled send them;
        # a frame without any keeps the previous digest (absence means
        # "nothing new", not "cache emptied"). Two wire shapes decode:
        # a full ``prefix_digest`` snapshot (every pre-delta peer, plus
        # the first frame of a delta stream) always replaces outright,
        # and ``digest_add``/``digest_del`` under a monotonic
        # ``digest_epoch`` apply on top of the last numbered snapshot.
        digest = msg.get("prefix_digest")
        if digest is not None:
            self._last_prefix_digest = frozenset(int(h) for h in digest)
            ep = msg.get("digest_epoch")
            self._digest_epoch = int(ep) if ep is not None else None
        else:
            add, dele = msg.get("digest_add"), msg.get("digest_del")
            if add is not None or dele is not None:
                ep = msg.get("digest_epoch")
                if self._digest_epoch is not None and ep is not None \
                        and int(ep) == self._digest_epoch + 1:
                    cur = set(self._last_prefix_digest)
                    cur.difference_update(int(h) for h in (dele or ()))
                    cur.update(int(h) for h in (add or ()))
                    self._last_prefix_digest = frozenset(cur)
                    self._digest_epoch = int(ep)
                else:
                    # out-of-sequence delta — impossible on one ordered
                    # TCP stream, so purely defensive: drop to
                    # cache-blind (advisory signal; routing stays
                    # correct) and resync the epoch so later deltas
                    # rebuild partial warmth
                    self._last_prefix_digest = frozenset()
                    self._digest_epoch = int(ep) if ep is not None else None
        counters = msg.get("counters") or {}
        if self.metrics is not None:
            for name in self._FORWARDED_COUNTERS:
                v = float(counters.get(name, 0.0))
                last = self._counters_last.get(name, 0.0)
                if v < last:
                    last = 0.0          # server engine reset: new epoch
                if v > last:
                    self.metrics.counter(name).inc(v - last)
                self._counters_last[name] = v
        # fleet observability (docs/OBSERVABILITY.md "Fleet
        # observability"): the status stream's OPTIONAL span/journal
        # deltas. Spans rebase onto the local clock via the transport's
        # heartbeat offset and shift into this handle's id range;
        # journal batches land in the frontend's FleetJournal, which
        # dedupes by per-source seq (exactly-once across reconnect
        # replays).
        spans = msg.get("spans")
        if spans and self.tracer.enabled:
            conn = self._conn
            n = ingest_remote_spans(
                self.tracer, spans, offset=self._span_offset,
                clock_offset_s=(conn.clock_offset_s
                                if conn is not None else 0.0),
                source=self._source, pid=self._server_pid)
            if n and self.metrics is not None:
                self.metrics.counter("spans_forwarded").inc(n)
        j = msg.get("journal")
        if j and self.fleet is not None:
            accepted, dropped = self.fleet.ingest(
                str(j.get("source") or self._source),
                j.get("events") or ())
            if self.metrics is not None:
                if accepted:
                    self.metrics.counter(
                        "journal_events_forwarded").inc(accepted)
                if dropped:
                    self.metrics.counter(
                        "journal_events_dropped").inc(dropped)
        self._last_status_t = time.monotonic()
        srv_state = msg.get("state")
        if srv_state == ReplicaState.DEAD.value:
            self._mark_dead("server replica died")
        elif srv_state == ReplicaState.DRAINING.value \
                and self.state == ReplicaState.HEALTHY:
            self.state = ReplicaState.DRAINING
        elif srv_state == ReplicaState.STOPPED.value \
                and self.state not in (ReplicaState.DEAD,):
            self._server_thread_alive = False

    # ------------------------------------------------------------- failure
    def _fail_request(self, req: ServingRequest, reason: str,
                      state: RequestState,
                      already_detached: bool = False) -> None:
        if not already_detached:
            with self._lock:
                if req.uid in self._failed_uids:
                    return
                self._failed_uids.add(req.uid)
                self._active.pop(req.uid, None)
                self._outstanding = max(0, self._outstanding
                                        - req.outstanding_tokens)
                self._discharge_locked(req)
        if reason == FinishReason.ERROR:
            self._finish_failed(req)
            return
        req.finish(state, reason)
        if self.metrics is not None:
            key = {FinishReason.DEADLINE: "requests_expired",
                   FinishReason.CANCELLED: "requests_cancelled"}.get(
                       reason, "requests_failed")
            self.metrics.counter(key).inc()

    def _finish_failed(self, req: ServingRequest) -> None:
        """Error-terminal unless the frontend failover path takes it."""
        if self._on_failover is not None and self._on_failover(req):
            return
        req.finish(RequestState.FAILED, FinishReason.ERROR)
        if self.metrics is not None:
            self.metrics.counter("requests_failed").inc()

    def _mark_dead(self, reason: str) -> None:
        """A dead connection is a dead replica: one DEAD transition, the
        mirrored in-flight requests fail over exactly as on thread
        death, the journal records the disconnect, and the supervisor's
        normal restart path (fresh handle + server reset) takes over."""
        with self._lock:
            if self.state in (ReplicaState.DEAD, ReplicaState.STOPPED):
                return
            self.state = ReplicaState.DEAD
            self._dead_reason = reason
        logger.warning(f"fabric replica {self.replica_id} DEAD: {reason}")
        if self.metrics is not None:
            self.metrics.counter("handle_disconnects").inc()
        if self.journal is not None:
            try:
                self.journal.emit("replica_disconnected",
                                  replica=self.replica_id, reason=reason)
            except Exception:
                pass
        if self.recorder is not None:
            try:
                self.recorder.on_error(f"replica-{self.replica_id}",
                                       ConnectionLost(reason))
            except Exception:
                pass
        with self._lock:
            active = list(self._active.values())
        for req in active:
            self._fail_request(req, FinishReason.ERROR, RequestState.FAILED)
        conn = self._conn
        if conn is not None:
            conn.close(reason)

    def check_health(self, now: Optional[float] = None) -> ReplicaState:
        if self.state in (ReplicaState.DEAD, ReplicaState.STOPPED):
            return self.state
        conn = self._conn
        if conn is None or not conn.alive:
            self._mark_dead(conn.close_reason if conn is not None
                            and conn.close_reason else "transport lost")
        elif self.state == ReplicaState.QUARANTINED:
            # a quarantined replica is still CONNECTED (that's what makes
            # the failure gray) — the health sweep is where its probe
            # clock ticks
            self._maybe_probe(time.monotonic() if now is None else now)
        return self.state

    # -------------------------------------------------------- observability
    def pull_dump(self, max_bytes: int = DUMP_MAX_BYTES) -> Optional[dict]:
        """Pull the server's bounded flight record over the ``dump`` RPC
        (``{"source", "role", "pid", "record", "trimmed"}``); None when
        the call fails or the peer predates the method — a fleet dump
        degrades to fewer processes, never to an error."""
        try:
            out = self._call("dump", {"max_bytes": int(max_bytes)})
            return out if isinstance(out, dict) else None
        except FabricError as e:
            logger.warning(f"fabric replica {self.replica_id}: dump RPC "
                           f"failed ({e!r})")
            return None

    def ops_status(self, now: Optional[float] = None) -> dict:
        """One health_report() row for this remote: connection health,
        rpc latency, clock offset, status recency, forwarded occupancy
        (docs/OBSERVABILITY.md "Fleet observability")."""
        now = time.monotonic() if now is None else now
        conn = self._conn
        return {
            "replica": int(self.replica_id), "address": self.address,
            "role": self.role, "state": self.state.value,
            "source": self._source, "pid": self._server_pid,
            "connected": bool(conn is not None and conn.alive),
            "clock_offset_s": (conn.clock_offset_s
                               if conn is not None else 0.0),
            "clock_offset_rtt_s": (conn.clock_offset_rtt_s
                                   if conn is not None else None),
            "last_status_age_s": (now - self._last_status_t
                                  if self._last_status_t else None),
            "rpc_calls": int(self._rpc_calls),
            "rpc_avg_s": (self._rpc_time_s / self._rpc_calls
                          if self._rpc_calls else 0.0),
            "active": self.active_count,
            "occupancy": dict(self._last_occupancy),
        }

    # ----------------------------------------------------------- lifecycle
    def drain(self) -> None:
        if self.state == ReplicaState.HEALTHY:
            self.state = ReplicaState.DRAINING
            self._notify({"t": "ev", "ev": "drain"})

    def request_evacuation(self, handback: Callable) -> None:
        """Fast drain for removal/re-role: the server exports each
        resident sequence (staged-KV where possible) and streams it
        back; every hand-back runs through ``handback`` on the
        transport reader thread — the same re-queue path as local
        evacuation."""
        self.drain()
        self._evac_handback = handback
        try:
            self._call("evacuate", {})
        except FabricError as e:
            logger.warning(f"fabric replica {self.replica_id}: evacuate "
                           f"RPC failed ({e!r}); transport-loss failover "
                           "will reclaim the requests")
            self.check_health()

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._notify({"t": "ev", "ev": "stop"})
        if self.state != ReplicaState.DEAD:
            self.state = ReplicaState.STOPPED
        conn = self._conn
        if conn is not None:
            conn.close("handle stopped")
        with self._lock:
            active = list(self._active.values())
        for req in active:
            self._fail_request(req, FinishReason.ERROR, RequestState.FAILED)
