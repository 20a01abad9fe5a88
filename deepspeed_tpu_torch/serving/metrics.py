"""Serving metrics: counters, gauges, fixed-bucket histograms.

The serving layer's telemetry lives in one thread-safe registry so the
router/replica/queue code records blindly and every consumer — the
``monitor/`` backends (TensorBoard / W&B / CSV), ``bench.py``'s serving
phase, tests — reads the same numbers. Histograms use fixed upper-bound
buckets (Prometheus-style) so percentile estimates are mergeable and
allocation-free on the hot path; ``percentile`` interpolates linearly
within the winning bucket.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

Event = Tuple[str, float, int]

# Default latency buckets (seconds): 1 ms .. ~2 min, roughly ×2 per step.
DEFAULT_LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                           0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
# Queue-depth style buckets (counts).
DEFAULT_DEPTH_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                         256.0, 512.0, 1024.0)
# Lock-hold buckets (seconds): healthy holds are microseconds; the tail
# is what the RankedLock debug mode (docs/CONCURRENCY.md) pages on.
LOCK_HOLD_BUCKETS = (1e-6, 1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05,
                     0.1, 0.5, 1.0, 5.0, 30.0)


class Counter:
    """Monotonic counter."""

    # series locks stay plain threading.Lock (the observe hot path);
    # the rank hint ties them into the concurrency lint's order graph
    _LOCK_RANKS = {"_lock": "serving.metrics.series"}
    # value reads are lock-free by design: a float read is atomic under
    # the GIL and monotonic publication tolerates staleness
    _GUARDED_BY = {"_value": "_lock:writes"}

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    _LOCK_RANKS = {"_lock": "serving.metrics.series"}
    _GUARDED_BY = {"_value": "_lock:writes"}

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative counts per upper bound + +Inf)."""

    _LOCK_RANKS = {"_lock": "serving.metrics.series"}
    # bucket counts must be read under the lock (buckets_snapshot is the
    # sanctioned reader); sum/count properties are lock-free snapshots
    _GUARDED_BY = {"_counts": "_lock", "_sum": "_lock:writes",
                   "_count": "_lock:writes"}

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.bounds = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.bounds) + 1)   # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        while i < len(self.bounds) and v > self.bounds[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @staticmethod
    def percentile_from(bounds: Sequence[float], counts: Sequence[int],
                        q: float) -> float:
        """q-th percentile (q in [0, 100]) from per-bucket counts —
        the shared interpolation used by the cumulative :meth:`percentile`
        AND the windowed delta math (telemetry/windowed.py), so a sliding
        window and the since-boot estimate can never disagree in
        *method*, only in *data*. Linear interpolation inside the winning
        bucket; over-range samples land in the +Inf overflow bucket,
        which has no finite upper bound to interpolate toward — the
        estimate CLAMPS to the largest finite bucket bound (a documented
        floor) instead of reporting +Inf/garbage; size the bucket list so
        real tails stay inside it."""
        total = sum(counts)
        if total == 0 or not bounds:
            return 0.0
        rank = max(1.0, math.ceil(q / 100.0 * total))
        seen = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= rank:
                if i >= len(bounds):            # overflow: clamp, never Inf
                    return bounds[-1]
                lo = bounds[i - 1] if i > 0 else 0.0
                hi = bounds[i]
                frac = (rank - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return bounds[-1]

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile over the cumulative (since-boot)
        counts; see :meth:`percentile_from` for the interpolation and
        over-range clamping contract."""
        bounds, counts, _, _ = self.buckets_snapshot()
        return self.percentile_from(bounds, counts, q)

    @staticmethod
    def fraction_over_from(bounds: Sequence[float], counts: Sequence[int],
                           threshold: float) -> float:
        """Fraction of the counted observations ABOVE ``threshold`` —
        shared by the windowed burn rates (telemetry/windowed.py) and
        the cumulative error-budget ledger (telemetry/slo.py), so the
        two can never disagree on the bucket-boundary convention.
        Resolution is the bucket grid: the threshold maps to the
        smallest bound >= it (observations inside that bucket count as
        compliant); beyond the largest finite bound only the +Inf
        overflow bucket counts as over. 0.0 on an empty snapshot."""
        total = sum(counts)
        if total == 0:
            return 0.0
        under = 0
        for i, b in enumerate(bounds):
            under += counts[i]
            if b >= threshold:
                break
        return max(0, total - under) / total

    def buckets_snapshot(self) -> Tuple[Tuple[float, ...], List[int],
                                        float, int]:
        """Consistent (bounds, per-bucket counts incl. the +Inf overflow,
        sum, count) — ONE atomic read under the observe lock, so counts,
        sum and count always describe the same set of observations. This
        is the only sanctioned way to read the histogram for delta math:
        two snapshots taken around concurrent ``observe`` calls yield
        per-bucket / count / sum deltas that are each non-negative and
        mutually consistent (count delta == sum of bucket deltas) — the
        property telemetry/windowed.py's sliding windows are built on."""
        with self._lock:
            return self.bounds, list(self._counts), self._sum, self._count

    def snapshot(self) -> Dict[str, float]:
        """Summary stats computed from ONE consistent bucket snapshot
        (count/sum/mean and every percentile describe the same set of
        observations even while other threads observe concurrently)."""
        bounds, counts, total_sum, total = self.buckets_snapshot()
        return {"count": float(total), "sum": total_sum,
                "mean": total_sum / total if total else 0.0,
                "p50": self.percentile_from(bounds, counts, 50),
                "p95": self.percentile_from(bounds, counts, 95),
                "p99": self.percentile_from(bounds, counts, 99)}


class MetricsRegistry:
    """Named metric store with monitor/ fan-out.

    ``events(step)`` flattens everything into the ``(tag, value, step)``
    tuples the ``monitor/`` backends consume;
    ``publish(monitor, step)`` writes them through any object with the
    ``write_events`` API (e.g. ``MonitorMaster``)."""

    _LOCK_RANKS = {"_lock": "serving.metrics.registry"}
    _GUARDED_BY = {"_counters": "_lock", "_gauges": "_lock",
                   "_histograms": "_lock"}

    def __init__(self, prefix: str = "serving"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter()
            return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge()
            return self._gauges[name]

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  reset: bool = False) -> Histogram:
        """``reset=True`` replaces an existing histogram (fresh counts)
        with the given buckets — buckets cannot change under recorded
        observations, so re-declaring with different buckets without
        ``reset`` keeps the original."""
        with self._lock:
            if reset or name not in self._histograms:
                self._histograms[name] = Histogram(
                    buckets or DEFAULT_LATENCY_BUCKETS)
            return self._histograms[name]

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        out: Dict[str, object] = {}
        for name, c in counters.items():
            out[name] = c.value
        for name, g in gauges.items():
            out[name] = g.value
        for name, h in hists.items():
            out[name] = h.snapshot()
        return out

    def raw_snapshot(self) -> Dict[str, object]:
        """The delta-math view (telemetry/windowed.py): counter/gauge
        values plus each histogram's consistent
        ``(bounds, counts, sum, count)`` bucket snapshot — percentile
        summaries would be useless for windowing (quantiles don't
        subtract; bucket counts do)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in counters.items()},
            "gauges": {n: g.value for n, g in gauges.items()},
            "hists": {n: h.buckets_snapshot() for n, h in hists.items()},
        }

    def names(self) -> Dict[str, Tuple[str, ...]]:
        """Declared metric names by kind — the audit surface
        (tests compare this against docs/OBSERVABILITY.md's metric-name
        reference table, both directions)."""
        with self._lock:
            return {"counters": tuple(sorted(self._counters)),
                    "gauges": tuple(sorted(self._gauges)),
                    "histograms": tuple(sorted(self._histograms))}

    def events(self, step: int) -> List[Event]:
        evs: List[Event] = []
        p = self.prefix + "/" if self.prefix else ""
        for name, value in self.snapshot().items():
            if isinstance(value, dict):
                for stat, v in value.items():
                    evs.append((f"{p}{name}/{stat}", float(v), step))
            else:
                evs.append((f"{p}{name}", float(value), step))
        return evs

    def publish(self, monitor, step: int = 0) -> None:
        monitor.write_events(self.events(step))

    # ---------------------------------------------------------- prometheus
    @staticmethod
    def _prom_name(name: str) -> str:
        return re.sub(r"[^a-zA-Z0-9_:]", "_", name)

    @staticmethod
    def _prom_num(v: float) -> str:
        v = float(v)
        if v == math.inf:
            return "+Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the whole
        registry: counters and gauges as single samples, histograms as
        cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count`` —
        what a /metrics endpoint (or a textfile collector) serves so the
        serving numbers land in existing dashboards
        (docs/OBSERVABILITY.md "Prometheus names")."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        p = self._prom_name(self.prefix + "_" if self.prefix else "")
        lines: List[str] = []
        for name, c in sorted(counters.items()):
            m = p + self._prom_name(name)
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m} {self._prom_num(c.value)}")
        for name, g in sorted(gauges.items()):
            m = p + self._prom_name(name)
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m} {self._prom_num(g.value)}")
        for name, h in sorted(hists.items()):
            m = p + self._prom_name(name)
            bounds, counts, total_sum, total_count = h.buckets_snapshot()
            lines.append(f"# TYPE {m} histogram")
            cum = 0
            for bound, cnt in zip(bounds, counts):
                cum += cnt
                lines.append(
                    f'{m}_bucket{{le="{self._prom_num(bound)}"}} {cum}')
            cum += counts[-1] if len(counts) > len(bounds) else 0
            lines.append(f'{m}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{m}_sum {self._prom_num(total_sum)}")
            lines.append(f"{m}_count {total_count}")
        return "\n".join(lines) + "\n"


#: request classes every fresh registry declares series for;
#: ``serving_metrics(classes=...)`` extends the set from the config so
#: custom classes ALSO expose zero-valued series before first traffic
STOCK_CLASSES = ("interactive", "batch")


def serving_metrics(classes: Sequence[str] = STOCK_CLASSES,
                    tenants: Sequence[str] = ()) -> MetricsRegistry:
    """Registry pre-declaring the serving layer's metric names, so
    dashboards and ``bench.py`` see zeros (not absences) before traffic.
    ``classes`` extends the per-class series (``ttft_s_class_<cls>``,
    ``requests_shed_class_<cls>``, …) beyond the stock
    interactive/batch pair — ``ServingFrontend`` passes the configured
    ``classes:`` map, so ``render_prometheus()`` exposes every class's
    zero-valued series at boot (an absent series is indistinguishable
    from a broken exporter; a zero one isn't). ``tenants`` does the same
    for the per-tenant series (docs/SERVING.md "Multi-model &
    multi-tenant serving"); the default empty tuple declares none —
    tenancy-off registries carry zero per-tenant overhead."""
    reg = MetricsRegistry("serving")
    all_classes = list(dict.fromkeys(list(STOCK_CLASSES) + list(classes)))
    for c in ("requests_submitted", "requests_admitted", "requests_shed",
              "requests_expired", "requests_completed", "requests_cancelled",
              "requests_failed", "tokens_generated",
              # prefix-cache KV reuse (engine-side counters, replicated up
              # by each Replica — docs/SERVING.md "Prefix caching")
              "prefix_blocks_hit", "prefix_blocks_missed",
              "prefix_blocks_evicted", "prefix_tokens_saved",
              # speculative decoding (scheduler-side counters, delta-
              # published per Replica — docs/SERVING.md "Speculative
              # decoding"); acceptance rate = accepted/proposed,
              # tokens-per-forward = emitted/decode_forwards
              "spec_tokens_proposed", "spec_tokens_accepted",
              "spec_tokens_emitted", "spec_decode_forwards",
              # fault tolerance (docs/SERVING.md "Fault tolerance"):
              # failover = a dead replica's request re-enqueued (stream
              # resumed elsewhere); restarts = supervisor replaced a DEAD
              # replica; brownout = shed by the degraded-capacity queue
              "requests_failed_over", "replica_restarts",
              "requests_shed_brownout",
              # disaggregated serving (docs/SERVING.md "Disaggregated
              # serving"): started = prompts exported+staged by
              # prefill-role replicas; completed = imports that resumed
              # on a decode-role replica; fallbacks = handoffs that
              # degraded to re-prefill (export/import failure or a full
              # staging buffer)
              "handoffs_started", "handoffs_completed",
              "handoff_fallbacks",
              # tiered KV memory (docs/SERVING.md "KV tiering"):
              # spilled = evicted prefix blocks copied into the host
              # tier; restored = tier hits scattered back into device
              # pools on a prefix match; dropped = blocks that fell out
              # of the tier entirely (byte bounds / corrupt disk entry)
              "kv_tier_blocks_spilled", "kv_tier_blocks_restored",
              "kv_tier_blocks_dropped",
              # admission overhaul (docs/SERVING.md "Admission and
              # preemption"): sequences spilled to the KV tier under
              # reservation pressure / brought back; sheds that happened
              # while the fleet was under preemption pressure (counted
              # separately from brownout sheds)
              "sequences_preempted", "sequences_resumed",
              "requests_shed_preempt_pressure",
              # elastic autoscaling (docs/SERVING.md "Elastic
              # autoscaling"): requests handed off a draining replica
              # during removal/re-role (staged-KV or re-prefill resume,
              # both lossless under greedy decoding)
              "requests_evacuated",
              # serving fabric (docs/SERVING.md "Multi-host serving"):
              # retries = reconnect/backoff attempts against replica
              # servers; disconnects = transport losses that turned a
              # remote handle DEAD (each one fires the failover path)
              "rpc_retries", "handle_disconnects",
              # fleet fault tolerance (docs/SERVING.md "Fleet fault
              # tolerance"): sealed (CRC v2) frames refused for bit
              # damage — each one is a single-frame drop, never a
              # connection loss; federation seat leases the exporter
              # expired because the adopter went silent past
              # lease_timeout_s (the borrowed seats returned home)
              "rpc_frames_corrupt", "federation_leases_expired",
              # fleet KV locality (docs/SERVING.md "Fleet KV locality"):
              # hits = picks the affinity credit steered to a warm
              # replica; misses = hashable prompts no replica (or only
              # a share-capped one) held; fleet tokens-saved = predicted
              # prefill tokens the winning credits covered
              "router_affinity_hits", "router_affinity_misses",
              "prefix_tokens_saved_fleet",
              # frontend federation (docs/SERVING.md "Frontend
              # federation"): requests this frontend assigned onto a
              # peer's exported replica
              "requests_federated",
              # fleet observability (docs/OBSERVABILITY.md "Fleet
              # observability"): remote spans ingested off the status
              # stream; journal events accepted into / dropped by the
              # FleetJournal (schema-invalid only — per-source seq
              # duplicates are deduped, not dropped); HTTP requests the
              # ObsEndpoint served
              "spans_forwarded", "journal_events_forwarded",
              "journal_events_dropped", "obs_requests"):
        reg.counter(c)
    for g in ("queue_depth", "replicas_healthy", "outstanding_tokens",
              # phase-split router load + KV handoff staging occupancy +
              # per-role KV pool split (docs/SERVING.md "Disaggregated
              # serving")
              "outstanding_prefill_tokens", "outstanding_decode_tokens",
              "handoff_staged",
              "kv_blocks_in_use_role_prefill",
              "kv_blocks_in_use_role_decode",
              "kv_blocks_in_use_role_mixed",
              # replicas_parked: circuit-broken slots (no more restarts);
              # capacity_alarm: 1 while any slot is parked — page on it;
              # brownout_active: 1 while the admission queue is shedding
              # lowest-urgency work under degraded capacity
              "replicas_parked", "capacity_alarm", "brownout_active",
              # gray-failure quarantine (docs/SERVING.md "Fleet fault
              # tolerance"): remote replicas currently QUARANTINED —
              # connected but too slow to route to; probes re-admit
              "replicas_quarantined",
              # SLO burn-rate alerting (docs/OBSERVABILITY.md "SLOs and
              # burn-rate alerts"): number of alert rules currently
              # firing; per-rule alert_firing_<rule> gauges are declared
              # by the AlertEngine from the configured rules
              "alerts_firing",
              # KV-pool occupancy summed over the fleet from
              # ``engine.occupancy()`` (docs/SERVING.md "KV
              # quantization"): bytes shrink ~2x per block under kv_quant
              "kv_blocks_in_use", "kv_bytes_in_use",
              # tiered KV memory residency, fleet-summed from the same
              # occupancy snapshot (docs/SERVING.md "KV tiering")
              "kv_blocks_host_tier", "kv_blocks_disk_tier",
              "kv_tier_bytes_host", "kv_tier_bytes_disk",
              # resident model-weight bytes, fleet-summed from
              # ``engine.param_stats()`` (docs/SERVING.md "Weight
              # quantization"): total drops ~3.9x per replica under
              # int8/fp8 weight serving; quantized = the converted share
              "param_bytes_total", "param_bytes_quantized",
              # admission overhaul (docs/SERVING.md "Admission and
              # preemption"): blocks the pending reservation head is
              # short of; device-block footprint of parked sequences
              "queue_wait_blocks", "preempted_resident_blocks",
              # elastic autoscaling (docs/SERVING.md "Elastic
              # autoscaling"): the fleet size the controller wants
              # (static fleets pin it to the boot size), the accepting
              # replica count per role — fleet shape pre-traffic — and
              # the proactive (budget-burn-driven) brownout flag
              "replicas_target", "replicas_role_prefill",
              "replicas_role_decode", "replicas_role_mixed",
              "brownout_proactive_active",
              # serving fabric: RPC calls currently awaiting a replica
              # server's response (docs/SERVING.md "Multi-host serving")
              "rpc_inflight",
              # fleet KV locality (docs/SERVING.md "Fleet KV locality"):
              # replicas currently inside the grow path's prefix-cache
              # warm-up; the trend-projected queue depth the predictive
              # autoscaler acts on (0 until the window has history)
              "replicas_warming", "predicted_load",
              # frontend federation (docs/SERVING.md "Frontend
              # federation"): live peer frontends — connected peers on
              # the exporting side, peers with >= 1 live adopted
              # export on the adopting side
              "federation_peers",
              # fleet observability (docs/OBSERVABILITY.md "Fleet
              # observability"): distinct remote journal sources the
              # FleetJournal currently holds events from
              "fleet_telemetry_sources"):
        reg.gauge(g)
    for h in ("ttft_s", "tpot_s", "queue_wait_s", "e2e_latency_s",
              # staging→import handoff time (docs/SERVING.md
              # "Disaggregated serving")
              "handoff_s",
              # host→device restore-batch dispatch time, one sample per
              # contiguous restored run (docs/SERVING.md "KV tiering")
              "kv_tier_restore_s",
              # preemption spill (export → tier) / resume (import →
              # running) wall time, one sample per preempted sequence
              # (docs/SERVING.md "Admission and preemption")
              "preempt_spill_s", "preempt_resume_s",
              # serving fabric: per-RPC wall time (hello/assign/
              # evacuate), the transport-overhead signal the bench
              # fabric phase stamps (docs/SERVING.md "Multi-host
              # serving")
              "rpc_call_s",
              # grow-path prefix-cache warm-up wall time, one sample per
              # grown replica (docs/SERVING.md "Fleet KV locality")
              "replica_warmup_s",
              # frontend federation: per-RPC wall time against peer
              # frontends (hello/assign/evacuate over an export
              # channel) — the cross-frontend transport-overhead signal
              "peer_rpc_s"):
        reg.histogram(h, DEFAULT_LATENCY_BUCKETS)
    # RankedLock debug-mode hold times (docs/CONCURRENCY.md): zero
    # samples unless enable_lock_debug() attached this registry
    reg.histogram("lock_hold_s", LOCK_HOLD_BUCKETS)
    # per-class series (docs/SERVING.md "Disaggregated serving",
    # docs/OBSERVABILITY.md "SLOs and burn-rate alerts"): latency splits,
    # queue depth, submit/shed counters — the SLO engine's raw material
    for cls in all_classes:
        reg.counter(f"requests_submitted_class_{cls}")
        reg.counter(f"requests_shed_class_{cls}")
        reg.gauge(f"queue_depth_class_{cls}")
        reg.histogram(f"ttft_s_class_{cls}", DEFAULT_LATENCY_BUCKETS)
        reg.histogram(f"tpot_s_class_{cls}", DEFAULT_LATENCY_BUCKETS)
    # per-tenant series (docs/SERVING.md "Multi-model & multi-tenant
    # serving"): submit/shed counters, latency splits, and the current
    # quota-throttle flag — the per-tenant SLO engine's raw material
    for t in dict.fromkeys(tenants):
        reg.counter(f"requests_submitted_tenant_{t}")
        reg.counter(f"requests_shed_tenant_{t}")
        reg.gauge(f"tenant_over_quota_{t}")
        reg.histogram(f"ttft_s_tenant_{t}", DEFAULT_LATENCY_BUCKETS)
        reg.histogram(f"tpot_s_tenant_{t}", DEFAULT_LATENCY_BUCKETS)
    reg.histogram("queue_depth_hist", DEFAULT_DEPTH_BUCKETS)
    return reg
