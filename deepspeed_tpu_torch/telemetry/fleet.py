"""Fleet observability plane: the frontend-side aggregation half of
cross-process telemetry (docs/OBSERVABILITY.md "Fleet observability").

The serving fabric and frontend federation make the serving fleet
multi-process; this module is where the per-process telemetry streams
those processes forward (fabric/remote.py ``_ev_status``) land and
become one pane of glass:

- :func:`ingest_remote_spans` rebases remote span dicts onto the local
  monotonic clock (the transport's heartbeat-derived offset), offsets
  their span ids into a per-source id range (two processes both count
  span ids from 1), and re-parents the cross-process edge via the
  ``remote_parent_id`` attr the replica server stamped on its root span
  — after which the local tracer holds ONE gap-free ``req-<uid>`` chain.
- :class:`FleetJournal` holds schema-validated remote journal events in
  bounded per-source rings next to the local :class:`OpsJournal`,
  exactly-once per source (seq-deduped), merged on read.
- :func:`fleet_chrome_trace` renders a merged span set with
  process→pid and replica→tid mapping, so a fleet trace opens in
  Perfetto as one timeline with a named track per process.
- :class:`ObsEndpoint` is the stdlib ``http.server`` scrape surface
  (``/metrics``, ``/health``, ``/trace``, ``/dump``) that
  ``scripts/fleetctl.py`` and Prometheus talk to.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils.locks import RankedLock
from ..utils.logging import logger
from .journal import OpsJournal, validate_event

#: span-id range width per forwarding source: remote span ids (each
#: process counts from 1) are offset by ``(index + 1) << SOURCE_ID_BITS``
#: so merged chains never alias. 2^32 spans per process outlives any
#: bounded ring by orders of magnitude.
SOURCE_ID_BITS = 32


def source_id_offset(index: int) -> int:
    """The span-id offset for forwarding source ``index`` (0-based);
    the frontend's own spans occupy range 0."""
    return (int(index) + 1) << SOURCE_ID_BITS


def ingest_remote_spans(tracer, spans: Sequence[Dict[str, Any]], *,
                        offset: int, clock_offset_s: float,
                        source: str, pid: Optional[int] = None) -> int:
    """Adopt forwarded span dicts into ``tracer``: ids shifted by
    ``offset``, timestamps rebased by ``clock_offset_s`` (remote
    monotonic minus local monotonic — the transport's heartbeat
    estimate), and ``source``/``pid`` stamped into attrs for the
    chrome-trace pid mapping. A span whose attrs carry
    ``remote_parent_id`` parents onto that FRONTEND-local span id
    verbatim (the cross-process edge); any other parent id is a
    remote-local id and shifts with the span. Returns spans adopted."""
    n = 0
    for d in spans:
        if not isinstance(d, dict):
            continue
        e = dict(d)
        attrs = dict(e.get("attrs") or {})
        e["span_id"] = int(e.get("span_id") or 0) + offset
        rp = attrs.get("remote_parent_id")
        if rp is not None:
            e["parent_id"] = int(rp)
        elif e.get("parent_id") is not None:
            e["parent_id"] = int(e["parent_id"]) + offset
        try:
            e["t_start"] = float(e["t_start"]) - clock_offset_s
        except (KeyError, TypeError, ValueError):
            continue
        if e.get("t_end") is not None:
            e["t_end"] = float(e["t_end"]) - clock_offset_s
        attrs.setdefault("source", source)
        if pid is not None:
            attrs.setdefault("pid", int(pid))
        e["attrs"] = attrs
        tracer.ingest(e)
        n += 1
    return n


class FleetJournal:
    """The local :class:`OpsJournal` plus bounded per-source rings of
    REMOTE journal events, exactly-once per source.

    Remote events arrive on the fabric status stream already carrying
    their origin's ``seq``/``source`` stamps; ingest validates each
    against :data:`EVENT_SCHEMAS` (a remote peer speaking an unknown
    kind is dropped and counted, never trusted into the merged view) and
    dedupes by per-source high-water seq — a reconnect replaying the
    tail of a journal delivers each event once."""

    # lock discipline (docs/CONCURRENCY.md): per-source rings and seq
    # watermarks move together under one lock; the wrapped local journal
    # has its own (higher-ranked) lock and is never called while ours is
    # held.
    _GUARDED_BY = {
        "_remote": "_lock",
        "_last_seq": "_lock",
        "_dropped": "_lock",
        "_duplicates": "_lock",
    }

    def __init__(self, local: OpsJournal, capacity_per_source: int = 512):
        self.local = local
        self.capacity_per_source = max(1, int(capacity_per_source))
        self._lock = RankedLock("telemetry.fleet")
        self._remote: Dict[str, deque] = {}
        self._last_seq: Dict[str, int] = {}
        self._dropped: Dict[str, int] = {}
        self._duplicates: Dict[str, int] = {}

    # ------------------------------------------------------------- ingest
    def ingest(self, source: str,
               events: Iterable[dict]) -> Tuple[int, int]:
        """Adopt a batch of remote events from ``source`` (oldest
        first). Returns ``(accepted, dropped)`` — duplicates (seq at or
        below the source's high-water mark, e.g. a reconnect replay) are
        neither, they are silently skipped and counted separately."""
        accepted = dropped = 0
        for ev in events:
            problems = validate_event(ev) if isinstance(ev, dict) else \
                ["not an object"]
            with self._lock:
                ring = self._remote.get(source)
                if ring is None:
                    ring = self._remote[source] = deque(
                        maxlen=self.capacity_per_source)
                if problems:
                    self._dropped[source] = \
                        self._dropped.get(source, 0) + 1
                    dropped += 1
                    continue
                seq = int(ev["seq"])
                if seq <= self._last_seq.get(source, 0):
                    self._duplicates[source] = \
                        self._duplicates.get(source, 0) + 1
                    continue
                self._last_seq[source] = seq
                ring.append(dict(ev))
                accepted += 1
        if dropped:
            logger.warning(f"fleet journal: dropped {dropped} "
                           f"schema-invalid event(s) from {source!r}")
        return accepted, dropped

    def last_seq(self, source: str) -> int:
        with self._lock:
            return self._last_seq.get(source, 0)

    # ------------------------------------------------------------ reading
    def events(self, kinds: Optional[Sequence[str]] = None,
               limit: Optional[int] = None,
               sources: Optional[Sequence[str]] = None) -> List[dict]:
        """Merged view (local + every remote source), ordered by wall
        time — the one clock every process shares well enough for a
        human-readable incident timeline. Per-source seq order is
        preserved by the stable sort (wall-time ties keep arrival
        order)."""
        out = [] if (sources is not None and
                     self.local.source not in sources) \
            else list(self.local.events(kinds=kinds))
        with self._lock:
            for src, ring in self._remote.items():
                if sources is not None and src not in sources:
                    continue
                out.extend(ev for ev in ring
                           if kinds is None or ev["kind"] in kinds)
        out.sort(key=lambda ev: ev.get("wall_time", 0.0))
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def sources(self) -> Dict[str, Dict[str, int]]:
        """Per-source ingest accounting (the fleet ops surface's
        "who is reporting" table); the local journal appears under its
        own source name."""
        out = {self.local.source: {
            "events": len(self.local), "last_seq": self.local.total_emitted,
            "dropped": 0, "duplicates": 0, "remote": 0}}
        with self._lock:
            for src, ring in self._remote.items():
                out[src] = {"events": len(ring),
                            "last_seq": self._last_seq.get(src, 0),
                            "dropped": self._dropped.get(src, 0),
                            "duplicates": self._duplicates.get(src, 0),
                            "remote": 1}
        return out

    def count(self, kind: str) -> int:
        n = self.local.count(kind)
        with self._lock:
            for ring in self._remote.values():
                n += sum(1 for ev in ring if ev["kind"] == kind)
        return n


# ------------------------------------------------------------ chrome trace

def fleet_chrome_trace(spans: Sequence[Dict[str, Any]],
                       meta: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """Merged-fleet Chrome trace: one pid per PROCESS (the ``source``
    attr :func:`ingest_remote_spans` stamped; frontend-local spans land
    in pid 1, "frontend"), one tid per replica/track within it (the
    ``replica`` attr where present, else the span's thread). Named via
    ``process_name``/``thread_name`` metadata events, so Perfetto shows
    `frontend` / `replica-0@host` tracks on one shared timeline — the
    ingest-time clock rebase is what makes the x-axis honest."""
    procs: Dict[str, int] = {}
    tids: Dict[Tuple[str, Any], int] = {}
    events: List[Dict[str, Any]] = []

    def _pid(src: str) -> int:
        pid = procs.get(src)
        if pid is None:
            pid = procs[src] = len(procs) + 1
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": src}})
        return pid

    for s in spans:
        attrs = dict(s.get("attrs") or {})
        src = str(attrs.get("source", "frontend"))
        pid = _pid(src)
        track = attrs.get("replica")
        track_key = (src, track if track is not None
                     else f"trace:{s.get('trace_id')}")
        tid = tids.get(track_key)
        if tid is None:
            tid = tids[track_key] = \
                sum(1 for k in tids if k[0] == src) + 1
            name = (f"replica-{track}" if track is not None
                    else str(s.get("trace_id") or "untraced"))
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        args = attrs
        args["span_id"] = s.get("span_id")
        if s.get("parent_id") is not None:
            args["parent_id"] = s["parent_id"]
        if s.get("trace_id"):
            args["trace_id"] = s["trace_id"]
        ev = {"name": s["name"], "cat": "telemetry",
              "ts": float(s["t_start"]) * 1e6, "pid": pid, "tid": tid,
              "args": args}
        if s.get("t_end") is not None:
            ev["ph"] = "X"
            ev["dur"] = max(0.0, (s["t_end"] - s["t_start"]) * 1e6)
        else:
            ev["ph"] = "B"
        events.append(ev)
    out = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        out["otherData"] = dict(meta)
    return out


# ------------------------------------------------------------ ops endpoint

class ObsEndpoint:
    """Stdlib HTTP scrape surface over a :class:`ServingFrontend`
    (duck-typed — anything with ``render_prometheus`` / ``health_report``
    / ``tracer`` / ``debug_dump`` works):

    - ``GET /metrics`` — Prometheus text exposition
    - ``GET /health``  — ``health_report()`` JSON
    - ``GET /trace``   — recent merged fleet Chrome trace JSON
    - ``GET /dump``    — trigger ``debug_dump()``, return the paths

    One daemon thread per request (``ThreadingHTTPServer``); handlers
    hold NO framework lock themselves — every route reads through the
    frontend's public snapshot surfaces. Never on unless the
    ``observability:`` config block says so."""

    def __init__(self, frontend, listen: str = "127.0.0.1:0"):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        host, _, port = listen.rpartition(":")
        if not host:
            raise ValueError(f"observability listen {listen!r} "
                             "is not host:port")
        endpoint = self
        self.frontend = frontend

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # quiet: the journal is the log
                pass

            def do_GET(self):
                try:
                    endpoint._route(self)
                except BrokenPipeError:      # scraper went away mid-write
                    pass
                except Exception as e:  # pragma: no cover - defensive
                    logger.error(f"obs endpoint: {self.path} failed: {e!r}")
                    try:
                        self.send_error(500, explain=str(e))
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="obs-endpoint", daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def _route(self, handler) -> None:
        fe = self.frontend
        path = handler.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            fe.metrics.counter("obs_requests").inc()
        except Exception:
            pass
        if path == "/metrics":
            body = fe.render_prometheus().encode()
            ctype = "text/plain; version=0.0.4"
        elif path == "/health":
            body = json.dumps(fe.health_report(), default=str,
                              sort_keys=True).encode()
            ctype = "application/json"
        elif path == "/trace":
            trace = fleet_chrome_trace(
                fe.tracer.export(include_open=True),
                meta={"endpoint": self.address})
            body = json.dumps(trace, default=str).encode()
            ctype = "application/json"
        elif path == "/dump":
            body = json.dumps(fe.debug_dump(), default=str,
                              sort_keys=True).encode()
            ctype = "application/json"
        else:
            handler.send_error(404)
            return
        handler.send_response(200)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
