"""Low-overhead tracing core: monotonic-clock spans in a bounded ring.

Counterpart of ``deepspeed_tpu/telemetry/tracer.py``. One :class:`Tracer`
serves every telemetry consumer; in the port so far that is the v2
scheduler (per-request ``prefill``/``decode`` spans and per-put ``forward``
and ``spec_verify`` spans). Design constraints, in priority order:

- **Disabled costs nothing.** ``Tracer(enabled=False).span(...)`` returns
  one shared no-op singleton — no allocation, no lock, no clock read on the
  hot path. Call sites guard attribute-dict construction on
  ``tracer.enabled``.
- **Bounded memory.** Completed spans land in a ``deque(maxlen=...)``
  ring. Open spans are tracked separately (a dump shows what was in
  flight) with a hard cap against leaks from error paths that never
  ``end()``.
- **Explicit trace ids.** A trace is any string key (``req-17``,
  ``replica-0``); spans carry it verbatim. Parenting within a thread is
  automatic for context-manager spans (a thread-local stack); cross-thread
  chains pass ``parent=`` through :meth:`Tracer.begin`.

Timestamps are ``time.monotonic()`` seconds; :func:`chrome_trace` turns a
span list into Chrome ``trace_event`` JSON (chrome://tracing, Perfetto),
one named track per trace id. With ``xla_annotations=True`` (the JAX
package's keyword, so one config drives both) a context-manager span also
opens ``torch.profiler.record_function(name)``, so host spans line up with
the device kernels in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..utils.locks import RankedLock


class _NoopSpan:
    """Shared do-nothing span returned by a disabled tracer. One instance
    for the whole process — identity is the allocation-free guarantee."""

    __slots__ = ()

    def set(self, key: str, value: Any = None) -> "_NoopSpan":
        return self

    def end(self) -> None:
        return None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed interval: ``[t_start, t_end]`` on the monotonic clock,
    a ``trace_id`` naming the chain it belongs to, an optional parent
    span id, and a free-form ``attrs`` dict. ``end()`` is idempotent —
    stage code and terminal cleanup may both call it; the first wins."""

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "t_start", "t_end", "attrs", "tid", "_xla_ctx")

    def __init__(self, tracer: "Tracer", name: str, trace_id: Optional[str],
                 parent_id: Optional[int], attrs: Optional[dict] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(tracer._ids)
        self.parent_id = parent_id
        self.attrs = dict(attrs) if attrs else {}
        self.tid = threading.get_ident()
        self._xla_ctx = None
        self.t_end: Optional[float] = None
        self.t_start = tracer.clock()          # last: exclude setup time
        tracer._note_open(self)

    def set(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def end(self) -> None:
        if self.t_end is not None:
            return
        self.t_end = self.tracer.clock()
        self.tracer._record(self)

    # -- context-manager form: auto-parents off the thread-local stack and
    # (optionally) opens a torch.profiler range of the span's name
    def __enter__(self) -> "Span":
        self.tracer._push(self)
        if self.tracer.xla_annotations:
            try:
                from torch.profiler import record_function

                self._xla_ctx = record_function(self.name)
                self._xla_ctx.__enter__()
            except Exception:
                self._xla_ctx = None
        return self

    def __exit__(self, *exc) -> bool:
        if self._xla_ctx is not None:
            try:
                self._xla_ctx.__exit__(*exc)
            finally:
                self._xla_ctx = None
        self.tracer._pop(self)
        self.end()
        return False

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "t_start": self.t_start, "t_end": self.t_end,
                "tid": self.tid, "attrs": dict(self.attrs)}


class Tracer:
    """Thread-safe span factory + bounded completed-span ring.

    ``span(...)`` is the context-manager form (auto-parented within the
    thread); ``begin(...)`` returns a span the caller must ``end()`` —
    the form for intervals that start and finish on different threads.
    Both return :data:`NOOP_SPAN` when disabled.

    ``xla_annotations`` (named as in the JAX package) mirrors every
    context-manager span into ``torch.profiler.record_function``."""

    # lock discipline: the span rings are written from every instrumented
    # thread; the thread-local nesting stack needs no lock by construction
    _GUARDED_BY = {"_spans": "_lock", "_open": "_lock",
                   "_completed_total": "_lock"}

    def __init__(self, enabled: bool = True, max_spans: int = 8192,
                 clock=time.monotonic, xla_annotations: bool = False):
        self.enabled = bool(enabled)
        self.clock = clock
        self.xla_annotations = bool(xla_annotations)
        self.max_spans = int(max_spans)
        self._spans: "deque[Span]" = deque(maxlen=self.max_spans)
        # open (started, un-ended) spans, so crash dumps show in-flight
        # work; insertion-ordered for the leak cap below
        self._open: Dict[int, Span] = {}
        self._lock = RankedLock("telemetry.tracer")
        self._ids = itertools.count(1)
        # monotone count of spans EVER completed (the ring forgets, this
        # doesn't) — the cursor base for drain_completed()
        self._completed_total = 0
        self._local = threading.local()

    # ------------------------------------------------------------- creation
    def span(self, name: str, trace_id: Optional[str] = None,
             parent: Optional[Span] = None, attrs: Optional[dict] = None):
        """Context-manager span. Parent defaults to the innermost span()
        currently entered on this thread (nesting)."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            parent = self.current()
        if parent is not None and trace_id is None:
            trace_id = parent.trace_id
        return Span(self, name, trace_id,
                    parent.span_id if parent is not None else None, attrs)

    def begin(self, name: str, trace_id: Optional[str] = None,
              parent: Optional[Span] = None, attrs: Optional[dict] = None):
        """Explicitly-ended span (cross-thread chains); never stacked."""
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, trace_id,
                    parent.span_id if parent is not None else None, attrs)

    def current(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    # ------------------------------------------------------------ internals
    def _push(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)

    def _pop(self, span: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:       # mis-nested exit: best effort
            stack.remove(span)

    def _note_open(self, span: Span) -> None:
        with self._lock:
            self._open[span.span_id] = span
            # leak cap: error paths may abandon spans without end(); keep
            # at most max_spans of them (oldest dropped, they were likely
            # abandoned long ago)
            while len(self._open) > self.max_spans:
                self._open.pop(next(iter(self._open)))

    def _record(self, span: Span) -> None:
        with self._lock:
            self._open.pop(span.span_id, None)
            self._spans.append(span)
            self._completed_total += 1

    # -------------------------------------------------------------- reading
    def export(self, include_open: bool = True) -> List[Dict[str, Any]]:
        """Snapshot of recorded spans (oldest first), plus — by default —
        currently-open spans with ``t_end=None`` and ``attrs["open"]``
        set, so dumps taken mid-flight (or on a crash) show what was
        running."""
        with self._lock:
            done = [s.to_dict() for s in self._spans]
            open_ = [s.to_dict() for s in self._open.values()] \
                if include_open else []
        for d in open_:
            d["attrs"]["open"] = True
        return done + open_

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._open.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    # --------------------------------------------- cross-process forwarding
    @property
    def completed_total(self) -> int:
        """Monotone count of spans ever completed — pass it as the
        cursor to :meth:`drain_completed` to skip existing history."""
        with self._lock:
            return self._completed_total

    def drain_completed(self, cursor: int,
                        limit: int = 256) -> Tuple[List[Dict[str, Any]],
                                                   int]:
        """Completed spans recorded after ``cursor`` (a value this method
        previously returned; start at 0), oldest first, at most ``limit``
        per call (a delta feed for another process). Spans that
        aged out of the ring before being drained are silently lost (the
        ring is the retention policy; forwarding rides it, it does not
        extend it). Returns ``(span_dicts, new_cursor)``."""
        with self._lock:
            total = self._completed_total
            pending = total - int(cursor)
            if pending <= 0:
                return [], total
            avail = min(pending, len(self._spans))
            take = min(avail, int(limit))
            start = len(self._spans) - avail
            out = [self._spans[i].to_dict()
                   for i in range(start, start + take)]
            return out, total - (avail - take)

    def ingest(self, d: Dict[str, Any]) -> None:
        """Adopt one remote span dict (a :meth:`Span.to_dict` shipped
        from another process) into the completed ring verbatim — no id
        allocation, no clock read; the caller owns id-collision avoidance
        and clock alignment (timestamps must already be rebased to this
        process's monotonic clock). No-op when disabled."""
        if not self.enabled:
            return
        s = Span.__new__(Span)
        s.tracer = self
        s.name = str(d.get("name", "remote"))
        s.trace_id = d.get("trace_id")
        s.span_id = int(d.get("span_id") or 0)
        s.parent_id = d.get("parent_id")
        s.t_start = float(d.get("t_start") or 0.0)
        s.t_end = d.get("t_end")
        s.attrs = dict(d.get("attrs") or {})
        s.tid = int(d.get("tid") or 0)
        s._xla_ctx = None
        with self._lock:
            self._spans.append(s)
            self._completed_total += 1


#: Process-wide disabled tracer: the default everywhere a tracer is
#: optional, so un-configured call sites pay only an attribute check.
NOOP_TRACER = Tracer(enabled=False, max_spans=1)


# --------------------------------------------------------------- chrome trace

def chrome_trace(spans: Sequence[Dict[str, Any]],
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Render exported span dicts as Chrome ``trace_event`` JSON
    (the object form — ``chrome://tracing`` and Perfetto both load it).

    Each distinct ``trace_id`` becomes a pid with a ``process_name``
    metadata event, so requests and replicas render as separate named
    tracks; span attrs land in ``args``. Open spans (no ``t_end``) are
    emitted as ``B`` (begin-only) events — Perfetto shows them as
    unterminated slices, which is exactly what an in-flight crash dump
    means."""
    pids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for s in spans:
        tid_key = s.get("trace_id") or "untraced"
        if tid_key not in pids:
            pid = len(pids) + 1
            pids[tid_key] = pid
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": tid_key}})
    for s in spans:
        pid = pids[s.get("trace_id") or "untraced"]
        args = dict(s.get("attrs") or {})
        args["span_id"] = s.get("span_id")
        if s.get("parent_id") is not None:
            args["parent_id"] = s["parent_id"]
        ev = {"name": s["name"], "cat": "telemetry",
              "ts": float(s["t_start"]) * 1e6,
              "pid": pid, "tid": int(s.get("tid") or 0), "args": args}
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


def validate_chrome_trace(obj: Any) -> List[str]:
    """Structural check of a Chrome-trace object (or its JSON string):
    returns a list of problems, empty when the trace is loadable."""
    problems: List[str] = []
    if isinstance(obj, (str, bytes)):
        try:
            obj = json.loads(obj)
        except Exception as e:
            return [f"not valid JSON: {e}"]
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["missing 'traceEvents' list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev.get("name"):
            problems.append(f"{where}: missing 'name'")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "M", "i", "I", "C"):
            problems.append(f"{where}: bad phase {ph!r}")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"{where}: '{key}' must be an int")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                problems.append(f"{where}: 'ts' must be a number")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: 'X' event needs dur >= 0")
    return problems


def trace_coverage(spans: Iterable[Dict[str, Any]], t0: float,
                   t1: float) -> float:
    """Fraction of the window ``[t0, t1]`` covered by the union of the
    given spans' intervals (open spans count up to ``t1``): how much of a
    request's measured TTFT its span chain accounts for."""
    if t1 <= t0:
        return 1.0
    ivals: List[Tuple[float, float]] = []
    for s in spans:
        a = max(float(s["t_start"]), t0)
        b = min(float(s["t_end"]) if s.get("t_end") is not None else t1, t1)
        if b > a:
            ivals.append((a, b))
    if not ivals:
        return 0.0
    ivals.sort()
    covered = 0.0
    cur_a, cur_b = ivals[0]
    for a, b in ivals[1:]:
        if a > cur_b:
            covered += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    covered += cur_b - cur_a
    return covered / (t1 - t0)
