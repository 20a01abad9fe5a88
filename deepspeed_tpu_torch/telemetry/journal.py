"""Unified ops event journal: one bounded, schema-validated stream.

Before this module every operationally-significant event logged to its
own corner: supervisor restarts to the Python logger, brownout flips to
a gauge, handoff fallbacks to a counter, anomaly rollbacks to a training
stats dict. Reconstructing "what happened to the fleet between 14:02 and
14:05" meant grepping four surfaces with four formats. The journal is
the single answer: every lifecycle event — serving (replica restarts and
parks, brownout transitions, KV handoffs and their fallbacks, request
failovers, alert transitions) and training (restarts, parks, preemption
saves, anomaly rollbacks, checkpoint publications, wedges) — lands in
one in-memory ring of schema-validated records, queryable through
``ServingFrontend.health_report()`` / ``TrainingSupervisor.
health_report()`` and dumpable as JSONL.

Design rules:

- **Bounded.** A deque of ``capacity`` events; an optional streaming
  JSONL sink is byte-capped (``max_file_bytes``) — a crash-looping fleet
  must not fill the disk with its own obituary.
- **Schema-validated at emit.** ``EVENT_SCHEMAS`` names each kind's
  required detail fields; an unknown kind or a missing field raises
  immediately (call sites are framework code — a schema violation is a
  bug to catch in tests, not a condition to tolerate). Extra fields are
  allowed; every value must be JSON-serializable.
- **Ordered.** ``seq`` increments under the lock and ``t`` is the host
  monotonic clock, so events sort identically by either; consumers and
  the chaos suite assert monotonic timestamps.
- **Passive.** Emitting never blocks on I/O beyond the optional
  append-only sink and never mutates the systems it describes.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..utils.locks import RankedLock
from ..utils.logging import logger

#: kind -> required detail-field names. Extra fields are welcome (they
#: make events MORE diagnosable); missing required ones are a bug.
EVENT_SCHEMAS: Dict[str, frozenset] = {
    # ------------------------------------------------------------ serving
    # supervisor replaced a DEAD replica (docs/SERVING.md "Fault
    # tolerance"); recovery_s = death -> replacement serving
    "replica_restart": frozenset({"replica", "attempt", "recovery_s"}),
    # circuit breaker gave up on a replica slot
    "replica_parked": frozenset({"replica", "crashes_in_window"}),
    # a dead replica's request re-enqueued (stream resumes elsewhere)
    "request_failover": frozenset({"uid", "attempt"}),
    # admission queue entered/left degraded-capacity shedding
    "brownout_enter": frozenset({"healthy_fraction"}),
    "brownout_exit": frozenset({"healthy_fraction"}),
    # disaggregated serving (docs/SERVING.md "Disaggregated serving"):
    # a finished prompt's KV staged for a decode-role replica, or the
    # handoff degraded to re-prefill ("where": export/staging_full/import)
    "handoff_staged": frozenset({"uid", "from_replica"}),
    "handoff_fallback": frozenset({"uid", "where"}),
    # SLO burn-rate alerting (docs/OBSERVABILITY.md "SLOs and burn-rate
    # alerts"): rule transitions of the AlertEngine state machine
    "alert_firing": frozenset({"alert", "request_class", "slo_kind",
                               "burn_fast", "burn_slow"}),
    "alert_resolved": frozenset({"alert", "firing_s"}),
    # tiered KV memory (docs/SERVING.md "KV tiering"): the fleet's
    # prefix-cache spill tier churned since the last ~1s look — deltas
    # of blocks spilled/restored/dropped plus current host residency
    "kv_tier_pressure": frozenset({"spilled", "restored", "dropped",
                                   "host_bytes"}),
    # admission overhaul (docs/SERVING.md "Admission and preemption"):
    # the scheduler spilled a running sequence's KV to the tier to make
    # room — blocks freed, the replica it happened on
    "sequence_preempted": frozenset({"uid", "blocks", "replica"}),
    # elastic autoscaling (docs/SERVING.md "Elastic autoscaling"): the
    # FleetController grew/shrank the pool (replica added/removed, the
    # resulting fleet size, and why), flipped a replica's role, or
    # toggled proactive brownout from slow-window budget burn. Each
    # fires exactly once per completed controller action — the churn
    # suite cross-checks against the controller's decision log.
    "scale_up": frozenset({"replica", "fleet_size", "reason"}),
    "scale_down": frozenset({"replica", "fleet_size", "reason"}),
    "replica_reroled": frozenset({"replica", "from_role", "to_role"}),
    "brownout_proactive": frozenset({"active", "fraction"}),
    # fleet KV locality (docs/SERVING.md "Fleet KV locality"): the grow
    # path warmed a new replica's prefix cache from a donor's exported
    # blocks before rotation — how many blocks landed, whose cache they
    # came from, and how long the warm-up took
    "replica_warmup": frozenset({"replica", "blocks", "source",
                                 "warmup_s"}),
    # serving fabric (docs/SERVING.md "Multi-host serving"): a remote
    # replica handle lost its transport (the handle went DEAD and its
    # in-flight requests failed over) / a rebuilt handle re-attached to
    # its replica server (supervisor restart or reconnect)
    "replica_disconnected": frozenset({"replica", "reason"}),
    "replica_reconnected": frozenset({"replica"}),
    # gray-failure quarantine (docs/SERVING.md "Fleet fault tolerance"):
    # a remote replica left the routable set for slow RPCs / deadline
    # misses (in-flight streams continue) / a probe RPC re-admitted it
    # after this long in quarantine
    "replica_quarantined": frozenset({"replica", "reason"}),
    "replica_readmitted": frozenset({"replica", "quarantined_s"}),
    # frontend federation (docs/SERVING.md "Frontend federation"): a
    # peer frontend's hello was accepted / a peer connection died (its
    # federated in-flight work fails over on the ADOPTING side) / one
    # local replica was bound to a peer's export channel
    "peer_connected": frozenset({"peer", "epoch"}),
    "peer_lost": frozenset({"peer", "reason"}),
    "replica_exported": frozenset({"replica", "peer"}),
    # partition tolerance (docs/SERVING.md "Frontend federation"): a
    # peer's bootstrap channel went silent past the staleness window
    # (once per silence episode) / an export channel's seat lease
    # expired — the exporter cancelled its mirrors and took the
    # borrowed seats back
    "peer_partition": frozenset({"peer", "idle_s"}),
    "lease_expired": frozenset({"peer", "replica", "idle_s"}),
    # fleet observability (docs/OBSERVABILITY.md "Fleet observability"):
    # the frontend's scrape endpoint came up (where operators should
    # point fleetctl/Prometheus), and a fleet-wide debug dump completed
    # (how many processes contributed, where the files landed)
    "obs_listen": frozenset({"address"}),
    "fleet_dump": frozenset({"sources", "dir"}),
    # a replica server accepted a frontend hello (emitted SERVER-side;
    # reaches the frontend's FleetJournal over the status stream, so
    # every server process contributes at least one sourced event)
    "server_hello": frozenset({"replica", "role", "reset"}),
    # multi-tenant serving (docs/SERVING.md "Multi-model & multi-tenant
    # serving"): a tenant crossed into throttled state — its sliding-
    # window dispatch rate exceeded token_rate, or a KV budget refusal
    # ("reason": token_rate/kv_budget). Fires on the edge, not per
    # refused request; the tenant_over_quota_<tenant> gauge tracks state.
    "tenant_throttled": frozenset({"tenant", "reason"}),
    # ----------------------------------------------------------- training
    # supervised restart (docs/TRAINING.md "Fault tolerance")
    "train_restart": frozenset({"reason", "attempt", "steps_lost",
                                "resumed_step"}),
    "train_parked": frozenset({"failures"}),
    # SIGTERM urgent checkpoint inside the grace window
    "train_preempt_save": frozenset({"step", "save_s"}),
    # K consecutive anomalies rolled the run back to the last good state
    "train_anomaly_rollback": frozenset({"step", "resumed_step"}),
    # a checkpoint became 'latest' (periodic or urgent)
    "checkpoint_saved": frozenset({"step", "urgent"}),
    # watchdog abandoned a wedged step
    "train_wedge": frozenset({"step"}),
}


def validate_event(event: dict) -> List[str]:
    """Problems with one journal record (empty list = valid)."""
    problems = []
    for field in ("seq", "t", "wall_time", "source", "kind", "detail"):
        if field not in event:
            problems.append(f"missing field {field!r}")
    kind = event.get("kind")
    if kind is not None and kind not in EVENT_SCHEMAS:
        problems.append(f"unknown kind {kind!r}")
    detail = event.get("detail")
    if not isinstance(detail, dict):
        problems.append("detail: not an object")
    elif kind in EVENT_SCHEMAS:
        for req in sorted(EVENT_SCHEMAS[kind] - set(detail)):
            problems.append(f"{kind}: missing detail field {req!r}")
    return problems


def validate_events(events: Sequence[dict]) -> List[str]:
    """Schema + ordering problems across a whole event list (empty =
    valid): per-event schema, strictly-increasing seq, non-decreasing
    monotonic timestamps. The chaos suite and the bench ``slo`` phase
    run this over live journals."""
    problems = []
    prev_seq, prev_t = None, None
    for ev in events:
        for p in validate_event(ev):
            problems.append(f"seq={ev.get('seq')}: {p}")
        seq, t = ev.get("seq"), ev.get("t")
        if prev_seq is not None and isinstance(seq, int) and seq <= prev_seq:
            problems.append(f"seq={seq}: not increasing after {prev_seq}")
        if prev_t is not None and isinstance(t, (int, float)) and t < prev_t:
            problems.append(f"seq={seq}: timestamp went backwards")
        prev_seq = seq if isinstance(seq, int) else prev_seq
        prev_t = t if isinstance(t, (int, float)) else prev_t
    return problems


class OpsJournal:
    # lock discipline (docs/CONCURRENCY.md): ring, seq counter and sink
    # accounting move together under one lock — seq order in the ring
    # and in the JSONL sink must agree (see emit). The sink write under
    # the lock is a BASELINED blocking-while-locked exception: it is the
    # documented durability contract, bounded to one line per event.
    _GUARDED_BY = {
        "_ring": "_lock",
        "_seq": "_lock",
        "_emitted": "_lock",
        "_file_bytes": "_lock",
        "_file_capped": "_lock",
    }

    def __init__(self, capacity: int = 512, source: str = "serving",
                 path: Optional[str] = None,
                 max_file_bytes: int = 8 * 1024 * 1024,
                 clock=time.monotonic):
        self.source = str(source)
        self.capacity = max(1, int(capacity))
        self.path = path
        self.max_file_bytes = int(max_file_bytes)
        self.clock = clock
        self._lock = RankedLock("telemetry.journal")
        self._ring: "deque[dict]" = deque(maxlen=self.capacity)
        self._seq = 0
        self._emitted = 0                   # total ever (ring evicts)
        self._file_bytes = 0
        self._file_capped = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def total_emitted(self) -> int:
        with self._lock:
            return self._emitted

    # ------------------------------------------------------------- emitting
    def emit(self, kind: str, **detail) -> dict:
        """Append one validated event; returns the record. Raises
        ``ValueError`` on an unknown kind, a missing required field, or a
        non-JSON-serializable detail value — schema violations are bugs
        in framework call sites, caught by the test suite, never silent
        garbage in the stream."""
        if kind not in EVENT_SCHEMAS:
            raise ValueError(f"unknown journal event kind {kind!r} "
                             f"(known: {sorted(EVENT_SCHEMAS)})")
        missing = EVENT_SCHEMAS[kind] - set(detail)
        if missing:
            raise ValueError(f"journal event {kind!r} missing required "
                             f"detail fields {sorted(missing)}")
        try:
            line_detail = json.dumps(detail, sort_keys=True)
        except (TypeError, ValueError) as e:
            raise ValueError(f"journal event {kind!r} detail is not "
                             f"JSON-serializable: {e}") from None
        # ring append AND sink append happen under ONE lock hold: two
        # emitting threads (router tick vs supervisor) must not be able
        # to write their JSONL lines out of seq order — the durable
        # record has to pass validate_events during exactly the
        # multi-threaded incidents it exists to capture. Journal traffic
        # is a handful of events per incident, so serialized I/O is noise.
        with self._lock:
            self._seq += 1
            self._emitted += 1
            event = {"seq": self._seq, "t": self.clock(),
                     "wall_time": time.time(), "source": self.source,
                     "kind": kind, "detail": detail}
            self._ring.append(event)
            self._append_file_locked(event, line_detail)
        return event

    def _append_file_locked(self, event: dict, line_detail: str) -> None:
        """Append one line to the optional JSONL sink; caller holds the
        lock. Byte-capped and failure-capped — the journal must never
        kill (or fill the disk of) its host."""
        if self.path is None or self._file_capped:
            return
        line = json.dumps({**{k: event[k] for k in
                              ("seq", "t", "wall_time", "source", "kind")},
                           "detail": json.loads(line_detail)},
                          sort_keys=True) + "\n"
        if self._file_bytes + len(line) > self.max_file_bytes:
            self._file_capped = True
            logger.warning(
                f"ops journal sink {self.path} reached its "
                f"{self.max_file_bytes}-byte cap; further events stay "
                "in-memory only (dump() still writes the ring)")
            return
        try:
            with open(self.path, "a") as fh:
                fh.write(line)
            self._file_bytes += len(line)
        except OSError as e:
            self._file_capped = True
            logger.warning(f"ops journal sink {self.path} failed "
                           f"({e!r}); further events stay in-memory only")

    # ------------------------------------------------------------- querying
    def events(self, kinds: Optional[Sequence[str]] = None,
               since_seq: int = 0,
               limit: Optional[int] = None) -> List[dict]:
        """Events currently in the ring (oldest first), optionally
        filtered by kind / sequence number, truncated to the LAST
        ``limit`` matches (the recent past is the interesting part)."""
        with self._lock:
            out = [ev for ev in self._ring if ev["seq"] > since_seq]
        if kinds is not None:
            want = set(kinds)
            out = [ev for ev in out if ev["kind"] in want]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def count(self, kind: str) -> int:
        with self._lock:
            return sum(1 for ev in self._ring if ev["kind"] == kind)

    # ------------------------------------------------------------ rendering
    def dump(self, path: str) -> int:
        """Write the current ring as JSONL; returns the event count."""
        events = self.events()
        with open(path, "w") as fh:
            for ev in events:
                fh.write(json.dumps(ev, sort_keys=True, default=str) + "\n")
        return len(events)

    def render_text(self, limit: int = 20) -> str:
        """Human-readable tail — the ``health_report()`` text block."""
        lines = []
        for ev in self.events(limit=limit):
            detail = " ".join(f"{k}={ev['detail'][k]}"
                              for k in sorted(ev["detail"]))
            lines.append(f"[{ev['t']:12.3f}] {ev['source']:8s} "
                         f"{ev['kind']:22s} {detail}")
        return "\n".join(lines)
