"""Sliding-window metrics over a cumulative :class:`MetricsRegistry`.

Every histogram and counter in the serving registry is cumulative since
boot — the right surface for Prometheus (rates and windows are the
*scraper's* job) but useless for in-process questions a production
operator actually pages on: "p95 interactive TTFT over the last minute",
"shed rate over the last five". This module adds the windowed view
WITHOUT touching the cumulative surface: a ring of interval snapshots
(``bucket_s`` apart, ``history_s`` deep) of the registry's raw counter
values and histogram bucket counts, and window queries computed as
*deltas* between the newest snapshot and the one at the window's start.

Quantiles don't subtract; bucket counts do — so the windowed percentile
is exact bucket math (the same interpolation as the cumulative
:meth:`Histogram.percentile`, via the shared
:meth:`Histogram.percentile_from`), not an approximation layered on
summaries. Correctness leans on :meth:`Histogram.buckets_snapshot`
being one atomic read: per-bucket deltas between two snapshots are
non-negative and internally consistent even with ``observe`` racing
(regression-tested with racing threads). Deltas are additionally
clamped at zero so a histogram re-declared with ``reset=True``
mid-flight degrades to "window restarts here" instead of negative
counts.

Ticks come from the serving router's ~1/s loop (the same place the
flight recorder snapshots metrics); anything may also call
:meth:`tick` directly (tests, the bench ``slo`` phase). The whole layer
is passive — nothing here mutates the registry.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

from ..utils.locks import RankedLock


def _percentile_from(bounds, counts, q):
    """The shared bucket interpolation (lazy import: serving.metrics is
    stdlib-only but its package __init__ pulls in the whole serving
    stack, which itself imports telemetry — resolving at call time keeps
    the module import order unconstrained)."""
    from ..serving.metrics import Histogram

    return Histogram.percentile_from(bounds, counts, q)


def _fraction_over_from(bounds, counts, threshold):
    """Shared bucket-boundary convention for "fraction over threshold"
    (same lazy-import rationale as :func:`_percentile_from`)."""
    from ..serving.metrics import Histogram

    return Histogram.fraction_over_from(bounds, counts, threshold)


class WindowedMetrics:
    # lock discipline (docs/CONCURRENCY.md): uncoordinated tickers (the
    # router loop + every health_report caller) mutate the ring
    _GUARDED_BY = {"_ring": "_lock"}

    def __init__(self, registry, bucket_s: float = 1.0,
                 history_s: float = 900.0,
                 clock=time.monotonic):
        self.registry = registry
        self.bucket_s = max(0.05, float(bucket_s))
        self.max_snapshots = max(2, int(float(history_s) / self.bucket_s))
        self.clock = clock
        self._lock = RankedLock("telemetry.windowed")
        # ring of {"t": monotonic, "counters": {...}, "hists": {...}}
        # snapshots; each snapshot is immutable after append
        self._ring: List[dict] = []

    # ------------------------------------------------------------- ticking
    def tick(self, now: Optional[float] = None) -> None:
        """Capture one snapshot, safe to call at ANY rate. Two rules
        keep the ring healthy under uncoordinated tickers (the router
        loop plus every ``health_report()`` caller):

        - **Out-of-order snapshots are dropped**: concurrent tickers can
          capture t1 < t2 yet race to append t2 first; appending t1
          after would make the "newest" snapshot older (and staler) than
          its predecessor, and window math would read a busy second as
          empty.
        - **Faster-than-cadence ticks refresh the head instead of
          appending**: the ring is count-bounded, so a dashboard polling
          at a few Hz would otherwise evict old snapshots until the
          "slow" window silently shrank to seconds. Replacing the head
          keeps reports up-to-the-moment while persistent entries stay
          ~``bucket_s`` apart (worst case every other entry, so the ring
          always covers at least ``history_s/2``)."""
        now = now if now is not None else self.clock()
        raw = self.registry.raw_snapshot()
        snap = {"t": now, "counters": raw["counters"], "hists": raw["hists"]}
        with self._lock:
            if self._ring and now <= self._ring[-1]["t"]:
                return
            if len(self._ring) >= 2 and \
                    now - self._ring[-2]["t"] < self.bucket_s:
                self._ring[-1] = snap
                return
            self._ring.append(snap)
            if len(self._ring) > self.max_snapshots:
                del self._ring[:len(self._ring) - self.max_snapshots]

    def maybe_tick(self, now: Optional[float] = None) -> None:
        """Cadence-gated tick for polling loops: cheap no-op while the
        last snapshot is younger than ``bucket_s``."""
        now = now if now is not None else self.clock()
        with self._lock:
            last = self._ring[-1]["t"] if self._ring else None
        if last is None or now - last >= self.bucket_s:
            self.tick(now)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------ windows
    def _window_pair(self, window_s: float):
        """(baseline, newest) snapshots spanning AT MOST ``window_s``:
        newest is the latest snapshot, baseline the oldest one still
        inside the window (t >= newest.t - window_s). Under-spanning is
        the contract an alerting consumer needs — a window NEVER
        includes observations older than asked for, so stale incidents
        age out on schedule even when tick cadence was irregular. Early
        in life (ring younger than the window) it degrades to "since
        start of history". None when fewer than two snapshots exist OR
        when no snapshot besides the newest lies inside the window
        (ticks stalled longer than the window): that is *no data*, and
        answering from an older baseline would smuggle the stale
        incident back into the window — the exact staleness this
        contract precludes. Consequence: ``window_s`` below the tick
        cadence (``bucket_s``) always reads as no data."""
        with self._lock:
            ring = list(self._ring)
        if len(ring) < 2:
            return None
        newest = ring[-1]
        cutoff = newest["t"] - float(window_s)
        base = next((snap for snap in ring[:-1] if snap["t"] >= cutoff),
                    None)
        if base is None:
            return None
        return base, newest

    @staticmethod
    def _hist_delta(base_h, new_h):
        """Non-negative per-bucket delta between two bucket snapshots
        (``(bounds, counts, sum, count)``). A missing/reset baseline
        contributes zero — the delta becomes the newest counts whole."""
        bounds, counts, total_sum, total = new_h
        if base_h is None or base_h[0] != bounds:
            return bounds, list(counts), float(total_sum), int(total)
        d_counts = [max(0, a - b) for a, b in zip(counts, base_h[1])]
        return (bounds, d_counts,
                max(0.0, float(total_sum) - float(base_h[2])),
                max(0, int(total) - int(base_h[3])))

    def window_hist(self, name: str, window_s: float):
        """Delta bucket snapshot ``(bounds, counts, sum, count)`` of
        histogram ``name`` over the window, or None (unknown name / not
        enough history)."""
        pair = self._window_pair(window_s)
        if pair is None:
            return None
        base, newest = pair
        new_h = newest["hists"].get(name)
        if new_h is None:
            return None
        return self._hist_delta(base["hists"].get(name), new_h)

    def window_percentile(self, name: str, q: float,
                          window_s: float) -> Optional[float]:
        """q-th percentile of histogram ``name`` over the last
        ``window_s`` seconds (bucket resolution, same interpolation as
        the cumulative estimate). None when the window holds no
        observations — distinguishable from a genuine 0.0."""
        d = self.window_hist(name, window_s)
        if d is None or d[3] == 0:
            return None
        bounds, counts, _, _ = d
        return _percentile_from(bounds, counts, q)

    def window_count(self, name: str, window_s: float) -> int:
        """Histogram observations recorded inside the window."""
        d = self.window_hist(name, window_s)
        return 0 if d is None else d[3]

    def window_mean(self, name: str, window_s: float) -> Optional[float]:
        d = self.window_hist(name, window_s)
        if d is None or d[3] == 0:
            return None
        return d[2] / d[3]

    def window_fraction_over(self, name: str, threshold: float,
                             window_s: float) -> Optional[float]:
        """Fraction of the window's observations ABOVE ``threshold`` —
        the raw material of latency burn rates (an SLO "p95 ≤ T" means
        at most 5% of requests may exceed T). Bucket-grid resolution via
        the shared :meth:`Histogram.fraction_over_from` convention, so
        pick SLO thresholds on (or near) bucket bounds. None with no
        observations in the window."""
        d = self.window_hist(name, window_s)
        if d is None or d[3] == 0:
            return None
        bounds, counts, _, _ = d
        return _fraction_over_from(bounds, counts, threshold)

    @staticmethod
    def _delta_from_pair(pair, name: str) -> float:
        base, newest = pair
        now_v = newest["counters"].get(name, 0.0)
        base_v = base["counters"].get(name, 0.0)
        return max(0.0, float(now_v) - float(base_v))

    def window_delta(self, name: str, window_s: float) -> float:
        """Counter increase over the window (clamped non-negative)."""
        pair = self._window_pair(window_s)
        if pair is None:
            return 0.0
        return self._delta_from_pair(pair, name)

    def window_deltas(self, names: Sequence[str],
                      window_s: float) -> Optional[Dict[str, float]]:
        """Several counters' increases from ONE (baseline, newest) pair —
        the atomic read a ratio needs (shed/submitted burn rates must
        not mix numerator and denominator from different windows when a
        tick lands between two separate queries). None without enough
        history."""
        pair = self._window_pair(window_s)
        if pair is None:
            return None
        return {n: self._delta_from_pair(pair, n) for n in names}

    def window_rate(self, name: str, window_s: float) -> Optional[float]:
        """Counter rate (per second) over the window — delta divided by
        the *actual* covered span (snapshot cadence jitters; dividing by
        the nominal window would bias the rate). Delta and span come
        from the SAME snapshot pair. None without history."""
        pair = self._window_pair(window_s)
        if pair is None:
            return None
        base, newest = pair
        span = newest["t"] - base["t"]
        if span <= 0:
            return None
        return self._delta_from_pair(pair, name) / span

    # ------------------------------------------------------------ summary
    def summary(self, names: Sequence[str], window_s: float,
                qs: Sequence[float] = (50, 95, 99)) -> Dict[str, dict]:
        """Windowed percentile/count/mean per histogram name — the
        ``health_report()`` building block."""
        out: Dict[str, dict] = {}
        for name in names:
            d = self.window_hist(name, window_s)
            if d is None:
                out[name] = {"count": 0}
                continue
            bounds, counts, total_sum, total = d
            entry = {"count": total,
                     "mean": (total_sum / total) if total else 0.0}
            for q in qs:
                entry[f"p{int(q)}"] = (
                    _percentile_from(bounds, counts, q)
                    if total else 0.0)
            out[name] = entry
        return out
