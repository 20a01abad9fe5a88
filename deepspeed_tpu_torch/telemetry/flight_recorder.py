"""Flight recorder: a crash-dump surface over the tracer's span ring.

Serving incidents are diagnosed after the fact — "why did TTFT spike at
14:03?", "what was in flight when replica 2 died?" — so the recorder
keeps the *recent past* resident (the tracer's bounded span ring plus a
small ring of metric-registry snapshots) and writes it out on demand
(:meth:`ServingFrontend.debug_dump`), and automatically on unhandled
scheduler/replica errors. Two formats per dump: the raw JSON record
(machine-greppable) and Chrome ``trace_event`` JSON loadable in
``chrome://tracing`` / Perfetto (docs/OBSERVABILITY.md walks through
opening one).

Error dumps are rate-limited (a dying fleet must not fill the disk) and
the dump path itself is exception-proof — telemetry must never turn a
degraded service into a dead one.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..utils.locks import RankedLock
from ..utils.logging import logger
from .tracer import Tracer, chrome_trace


class FlightRecorder:
    # lock discipline (docs/CONCURRENCY.md): snapshot ring, dump
    # sequence and the rate-limiter window are shared between the
    # router tick, replica death paths and on-demand dumps.
    # ``_providers`` is append-at-wiring-time, read-only afterwards.
    _GUARDED_BY = {
        "_snapshots": "_lock",
        "_last_snapshot_t": "_lock",
        "_dump_seq": "_lock",
        "_error_dump_times": "_lock",
    }

    def __init__(self, tracer: Tracer, max_snapshots: int = 32,
                 dump_dir: Optional[str] = None, max_error_dumps: int = 3,
                 error_dump_window_s: float = 3600.0,
                 role: str = "frontend"):
        self.tracer = tracer
        self.dump_dir = dump_dir
        # dump filenames are stamped <seq>_<reason>_<role>_<pid>: a
        # subprocess replica fleet shares one dump dir (the kv_tier
        # kvtier_<pid> precedent), and per-process seq counters alone
        # would collide
        self.role = str(role)
        # error dumps are limited to max_error_dumps per sliding window
        # (NOT per lifetime — a long-running service must still capture
        # next week's incident after this week's burned a few slots)
        self.max_error_dumps = int(max_error_dumps)
        self.error_dump_window_s = float(error_dump_window_s)
        self._providers: List[tuple] = []       # (name, fn() -> dict)
        self._snapshots: "deque[Dict[str, Any]]" = deque(maxlen=max_snapshots)
        self._lock = RankedLock("telemetry.recorder")
        self._last_snapshot_t = 0.0
        self._dump_seq = 0
        self._error_dump_times: "deque[float]" = deque()
        if dump_dir:
            self._sweep_stale_dumps(dump_dir)

    @staticmethod
    def _sweep_stale_dumps(dump_dir: str) -> int:
        """Delete dump files whose owning pid (the trailing filename
        token) is dead — a bench/test fleet's previous run must not leave
        its obituaries to be mistaken for this run's. Files of LIVE
        processes (including this one) and unparseable names are never
        touched; any OS error ends the sweep silently (telemetry must
        never kill its host over housekeeping)."""
        swept = 0
        try:
            names = os.listdir(dump_dir)
        except OSError:
            return 0
        for name in names:
            if not (name.startswith("flightrec_")
                    or name.startswith("trace_")) \
                    or not name.endswith(".json"):
                continue
            stem = name[:-len(".json")]
            pid_s = stem.rsplit("_", 1)[-1]
            if not pid_s.isdigit() or int(pid_s) == os.getpid():
                continue
            try:
                os.kill(int(pid_s), 0)
            except ProcessLookupError:
                try:
                    os.remove(os.path.join(dump_dir, name))
                    swept += 1
                except OSError:
                    return swept
            except OSError:
                pass                        # alive or not ours: keep
        return swept

    def add_metrics_provider(self, name: str,
                             fn: Callable[[], dict]) -> None:
        """Register a snapshot source (e.g. ``MetricsRegistry.snapshot``);
        called at snapshot time, guarded — a raising provider is skipped."""
        self._providers.append((name, fn))

    # ------------------------------------------------------------ snapshots
    def snapshot_metrics(self) -> None:
        snap: Dict[str, Any] = {"t": self.tracer.clock(),
                                "wall_time": time.time()}
        for name, fn in self._providers:
            try:
                snap[name] = fn()
            except Exception as e:
                snap[name] = {"error": repr(e)}
        with self._lock:
            self._snapshots.append(snap)
            self._last_snapshot_t = snap["t"]

    def maybe_snapshot(self, interval_s: float = 1.0) -> None:
        """Periodic-snapshot hook for polling loops (the serving router
        calls this each iteration); cheap no-op when disabled or within
        the interval. The cadence check CLAIMS the watermark in the
        same locked section it reads it (concurrency lint,
        guarded-field): the router tick and the supervisor's
        restart-dump path race here, and a check-then-snapshot that
        isn't atomic lets both pass the interval test and snapshot back
        to back."""
        if not self.tracer.enabled:
            return
        now = self.tracer.clock()
        with self._lock:
            if now - self._last_snapshot_t < interval_s:
                return
            self._last_snapshot_t = now       # claim: the loser skips
        self.snapshot_metrics()

    # ---------------------------------------------------------------- dumps
    def record(self) -> Dict[str, Any]:
        """The in-memory flight record: recent spans (open ones included)
        + metric snapshots + provenance."""
        with self._lock:
            snapshots = list(self._snapshots)
        return {
            "format": "deepspeed_tpu.flight_recorder.v1",
            "wall_time": time.time(),
            "monotonic_time": self.tracer.clock(),
            "telemetry_enabled": self.tracer.enabled,
            "spans": self.tracer.export(include_open=True),
            "metric_snapshots": snapshots,
        }

    def _resolve_dir(self, dump_dir: Optional[str]) -> str:
        d = dump_dir or self.dump_dir or os.path.join(
            tempfile.gettempdir(), "deepspeed_tpu_telemetry")
        os.makedirs(d, exist_ok=True)
        return d

    def dump(self, dump_dir: Optional[str] = None,
             reason: str = "on_demand") -> Dict[str, str]:
        """Write the flight record as ``flightrec_*.json`` (raw) and
        ``trace_*.json`` (Chrome trace). Returns the two paths."""
        d = self._resolve_dir(dump_dir)
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        tag = f"{seq:03d}_{reason}_{self.role}_{os.getpid()}"
        record = self.record()
        record["reason"] = reason
        raw_path = os.path.join(d, f"flightrec_{tag}.json")
        with open(raw_path, "w") as fh:
            json.dump(record, fh, indent=1, default=str)
        trace_path = os.path.join(d, f"trace_{tag}.json")
        with open(trace_path, "w") as fh:
            json.dump(chrome_trace(record["spans"],
                                   meta={"reason": reason,
                                         "wall_time": record["wall_time"]}),
                      fh, default=str)
        return {"json": raw_path, "chrome_trace": trace_path}

    def _acquire_dump_slot(self) -> bool:
        """One shared sliding-window budget for every automatic dump
        trigger (errors AND alert firings — an alert storm must not fill
        the disk any more than a crash loop may): True when a dump may
        proceed, False when the window's ``max_error_dumps`` are spent."""
        now = self.tracer.clock()
        with self._lock:
            while self._error_dump_times and \
                    now - self._error_dump_times[0] > self.error_dump_window_s:
                self._error_dump_times.popleft()
            if len(self._error_dump_times) >= self.max_error_dumps:
                return False
            self._error_dump_times.append(now)
        return True

    def _auto_dump(self, reason: str, what: str) -> Optional[Dict[str, str]]:
        """Shared body of every automatic dump trigger: telemetry gate,
        sliding rate-limit slot, snapshot + dump, never raises. ``what``
        is the human log phrasing; ``reason`` lands in the filenames."""
        if not self.tracer.enabled:
            return None
        if not self._acquire_dump_slot():
            return None
        try:
            self.snapshot_metrics()
            paths = self.dump(reason=reason)
            logger.warning(f"telemetry: flight-recorder dump for {what} "
                           f"-> {paths['json']}")
            return paths
        except Exception as dump_exc:  # pragma: no cover - defensive
            logger.warning(f"telemetry: flight-recorder dump failed: "
                           f"{dump_exc!r}")
            return None

    def on_error(self, where: str, exc: BaseException) -> Optional[Dict[str, str]]:
        """Crash hook for replica/scheduler error paths: best-effort dump,
        rate-limited to ``max_error_dumps`` per ``error_dump_window_s``
        (a dying fleet must not fill the disk, but a long-lived service
        keeps capturing later incidents), never raises (the caller is
        already handling a fault)."""
        return self._auto_dump(
            f"error_{where}",
            f"error in {where} ({type(exc).__name__}: {exc})")

    def on_event(self, reason: str) -> Optional[Dict[str, str]]:
        """Automatic dump for a non-error incident (a burn-rate alert
        firing — telemetry/slo.py): same telemetry gate, same sliding
        rate limiter as error dumps, never raises."""
        return self._auto_dump(reason, reason)
