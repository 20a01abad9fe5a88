"""Per-class SLO tracking and multi-window burn-rate alerting.

The serving stack's per-class SLO *policies* (priorities, deadlines,
class-ordered brownout) live in ``serving/config.py``; this module makes
SLO *attainment* measurable and pageable (docs/OBSERVABILITY.md "SLOs
and burn-rate alerts"). The model is the SRE-workbook one:

- An **SLO target** per request class: ``ttft_p95_ms`` / ``tpot_p95_ms``
  (latency: at most 5% of observations may exceed the threshold — the
  p95 contract stated as an error budget of 0.05) and ``availability``
  (at most ``1 - availability`` of submitted requests may be shed).
- **Burn rate** over a window = (bad fraction in the window) / (error
  budget). Burn 1.0 spends the budget exactly at the sustainable pace;
  burn 20 exhausts a 30-day budget in ~1.5 days.
- **Multi-window rules**: an alert fires only when BOTH a fast window
  and a slow window burn above the threshold — the fast window gives
  low detection latency, the slow window keeps a single straggler
  request from paging anyone; the rule resolves as soon as the fast
  window clears (recovery detection rides the short window).

The engine is evaluated on the serving router's ~1/s tick against the
:class:`~.windowed.WindowedMetrics` ring — cumulative metrics are
untouched; the window deltas ARE the measurement. Each rule runs a
firing→resolved state machine: transitions land in the ops journal
(telemetry/journal.py), flip the ``alerts_firing`` /
``alert_firing_<rule>`` gauges, and a NEW firing triggers a
flight-recorder dump through the same rate limiter as error dumps (an
alert storm must not fill the disk any more than a crash loop may).

Everything here is passive and default-off: with no ``slo:`` block the
engine is never constructed and the serving stack is byte-for-byte the
pre-SLO build.
"""

from __future__ import annotations

import dataclasses
from dataclasses import field
import threading
import time
from typing import Dict, List, Optional

from ..runtime.config_utils import DSConfigModel
from ..utils.locks import RankedLock
from ..utils.logging import logger

#: error budget implied by a pXX latency target: p95 ⇒ 5% may exceed
LATENCY_BUDGET = 0.05


@dataclasses.dataclass(init=False, eq=False, repr=False)
class SLOClassTarget(DSConfigModel):
    """One request class's SLO targets (``slo.classes.<cls>``). Unset
    targets generate no rules — declare only what you can stand behind."""

    # windowed p95 TTFT/TPOT must stay at or under these (milliseconds);
    # pick values on (or near) the registry's histogram bucket bounds —
    # windowed fractions resolve at bucket granularity
    ttft_p95_ms: Optional[float] = None
    tpot_p95_ms: Optional[float] = None
    # fraction of submitted requests that must NOT be shed
    # (0.999 = an error budget of 0.1%)
    availability: Optional[float] = None


@dataclasses.dataclass(init=False, eq=False, repr=False)
class SLOConfig(DSConfigModel):
    """``slo: {...}`` block on :class:`ServingConfig`
    (docs/CONFIG.md, docs/OBSERVABILITY.md "SLOs and burn-rate
    alerts"). ``enabled: false`` (the default) builds no alert engine —
    byte-for-byte historical behavior; windowed metrics and the ops
    journal exist regardless (they are passive)."""

    enabled: bool = False
    # class name -> targets; classes with no entry are unmonitored
    classes: Dict[str, SLOClassTarget] = field(default_factory=dict)
    # tenant name -> targets (docs/SERVING.md "Multi-model &
    # multi-tenant serving"): same shape, evaluated over the per-tenant
    # series (``ttft_s_tenant_<t>``, shed/submitted tenant counters) —
    # a tenant's burn is measured against ITS traffic only, so one
    # tenant's flood spending another's error budget is impossible by
    # construction. Tenants with no entry are unmonitored.
    tenants: Dict[str, SLOClassTarget] = field(default_factory=dict)
    # burn-rate windows: fire on fast AND slow breach, resolve when the
    # fast window clears. Production-shaped defaults; the CPU bench and
    # the chaos suite shrink them to seconds.
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    # burn-rate threshold in error-budget multiples (1.0 = spending the
    # budget exactly at the sustainable pace)
    burn_rate_threshold: float = 4.0
    # a window with fewer observations than this cannot breach — one
    # slow request in an idle fleet is not an incident
    min_window_count: int = 3
    # evaluation cadence on the router tick, and the windowed-metrics
    # ring geometry (snapshot interval x history depth)
    eval_interval_s: float = 1.0
    window_bucket_s: float = 1.0
    window_history_s: float = 900.0
    # ops journal geometry (the journal itself is always on — it is a
    # bounded in-memory ring; the optional path streams JSONL, byte-capped)
    journal_capacity: int = 512
    journal_path: Optional[str] = None
    # write a flight-recorder dump on each NEW firing (telemetry-gated
    # and rate-limited like error dumps)
    dump_on_alert: bool = True


@dataclasses.dataclass
class AlertRule:
    """One derived burn-rate rule: (class-or-tenant, kind) -> thresholds."""

    name: str                   # e.g. "slo_ttft_interactive"
    request_class: str          # class name (or tenant name, scope="tenant")
    kind: str                   # "ttft" | "tpot" | "availability"
    metric: str                 # histogram or counter name observed
    threshold_s: Optional[float]  # latency rules: the target in seconds
    budget: float               # error budget (0.05 for p95 latency)
    # availability rules: the submitted-counter the shed count is a
    # fraction OF — per-class and per-tenant rules differ only here
    denominator: Optional[str] = None
    scope: str = "class"        # "class" | "tenant"


@dataclasses.dataclass
class AlertState:
    rule: AlertRule
    firing: bool = False
    fired_t: Optional[float] = None
    resolved_t: Optional[float] = None
    fire_count: int = 0
    burn_fast: float = 0.0
    burn_slow: float = 0.0


class AlertEngine:
    # lock discipline (docs/CONCURRENCY.md): rule states are read by
    # health_report/fleet_signals threads while evaluate mutates.
    # ``_last_eval`` stays unguarded: single evaluator by construction
    # (the router tick), and a stale read only double-evaluates.
    _GUARDED_BY = {"_states": "_lock"}

    def __init__(self, config: SLOConfig, windowed, metrics=None,
                 journal=None, recorder=None, clock=time.monotonic):
        self.config = config
        self.windowed = windowed
        self.metrics = metrics
        self.journal = journal
        self.recorder = recorder
        self.clock = clock
        self._lock = RankedLock("telemetry.slo")
        self._last_eval = 0.0
        self.rules: List[AlertRule] = []
        for cls, target in sorted(config.classes.items()):
            if target.ttft_p95_ms is not None:
                self.rules.append(AlertRule(
                    f"slo_ttft_{cls}", cls, "ttft", f"ttft_s_class_{cls}",
                    target.ttft_p95_ms / 1e3, LATENCY_BUDGET))
            if target.tpot_p95_ms is not None:
                self.rules.append(AlertRule(
                    f"slo_tpot_{cls}", cls, "tpot", f"tpot_s_class_{cls}",
                    target.tpot_p95_ms / 1e3, LATENCY_BUDGET))
            if target.availability is not None:
                self.rules.append(AlertRule(
                    f"slo_availability_{cls}", cls, "availability",
                    f"requests_shed_class_{cls}", None,
                    max(1e-9, 1.0 - target.availability),
                    denominator=f"requests_submitted_class_{cls}"))
        # per-tenant rules (docs/SERVING.md "Multi-model & multi-tenant
        # serving"): same machinery over the per-tenant series, with the
        # tenant's own submitted counter as the availability denominator
        for tenant, target in sorted(config.tenants.items()):
            if target.ttft_p95_ms is not None:
                self.rules.append(AlertRule(
                    f"slo_ttft_tenant_{tenant}", tenant, "ttft",
                    f"ttft_s_tenant_{tenant}",
                    target.ttft_p95_ms / 1e3, LATENCY_BUDGET,
                    scope="tenant"))
            if target.tpot_p95_ms is not None:
                self.rules.append(AlertRule(
                    f"slo_tpot_tenant_{tenant}", tenant, "tpot",
                    f"tpot_s_tenant_{tenant}",
                    target.tpot_p95_ms / 1e3, LATENCY_BUDGET,
                    scope="tenant"))
            if target.availability is not None:
                self.rules.append(AlertRule(
                    f"slo_availability_tenant_{tenant}", tenant,
                    "availability", f"requests_shed_tenant_{tenant}", None,
                    max(1e-9, 1.0 - target.availability),
                    denominator=f"requests_submitted_tenant_{tenant}",
                    scope="tenant"))
        self._states: Dict[str, AlertState] = {
            r.name: AlertState(r) for r in self.rules}
        # pre-declare per-rule gauges so the zero-valued series exist
        # before any alert ever fires (satellite rule: an absent series
        # is indistinguishable from a broken exporter)
        if self.metrics is not None:
            self.metrics.gauge("alerts_firing").set(0.0)
            for r in self.rules:
                self.metrics.gauge(f"alert_firing_{r.name}").set(0.0)

    # ------------------------------------------------------------- queries
    def firing(self) -> List[str]:
        with self._lock:
            return [n for n, s in self._states.items() if s.firing]

    def status(self) -> Dict[str, dict]:
        """Per-rule view for ``health_report()``: state, last burn rates,
        cumulative error-budget spend since boot."""
        out: Dict[str, dict] = {}
        with self._lock:
            states = {n: dataclasses.replace(s) for n, s in
                      self._states.items()}
        for name, s in states.items():
            out[name] = {
                "class": s.rule.request_class,
                "scope": s.rule.scope,
                "kind": s.rule.kind,
                "firing": s.firing,
                "fire_count": s.fire_count,
                "burn_fast": round(s.burn_fast, 3),
                "burn_slow": round(s.burn_slow, 3),
                "budget_spent_frac": round(
                    self._cumulative_bad_frac(s.rule) / s.rule.budget, 3),
            }
            if s.rule.threshold_s is not None:
                out[name]["target_ms"] = s.rule.threshold_s * 1e3
        return out

    # ---------------------------------------------------------- burn rates
    def _burn(self, rule: AlertRule,
              window_s: float) -> Optional[float]:
        """Burn rate over the window: bad fraction / budget. None when
        the window holds fewer than ``min_window_count`` observations —
        *no evidence*, which is different from burn 0: an empty window
        neither fires an alert (one straggler in an idle fleet is not an
        incident) nor resolves one (absence of traffic is not evidence
        of recovery — that asymmetry is what keeps a firing alert from
        flapping when the incident itself makes traffic sparse). Count
        and fraction derive from ONE atomic window read (a tick landing
        between two separate queries must not mix numerator and
        denominator from different windows)."""
        min_count = max(1, self.config.min_window_count)
        if rule.kind in ("ttft", "tpot"):
            d = self.windowed.window_hist(rule.metric, window_s)
            if d is None or d[3] < min_count:
                return None
            bounds, counts, _, _ = d
            from ..serving.metrics import Histogram

            frac = Histogram.fraction_over_from(bounds, counts,
                                                rule.threshold_s)
            return frac / rule.budget
        # availability: shed / submitted, both from one snapshot pair;
        # the denominator is scope-specific (per-class or per-tenant)
        submitted_name = (rule.denominator
                          or f"requests_submitted_class_{rule.request_class}")
        deltas = self.windowed.window_deltas((submitted_name, rule.metric),
                                             window_s)
        if deltas is None or deltas[submitted_name] < min_count:
            return None
        frac = min(1.0, deltas[rule.metric] / deltas[submitted_name])
        return frac / rule.budget

    def _cumulative_bad_frac(self, rule: AlertRule) -> float:
        """Since-boot bad fraction from the CUMULATIVE registry — the
        error-budget ledger (how much of the budget this process already
        spent), independent of window history. Same bucket-boundary
        convention as the windowed burn rates
        (:meth:`Histogram.fraction_over_from`)."""
        if self.metrics is None:
            return 0.0
        if rule.kind in ("ttft", "tpot"):
            from ..serving.metrics import Histogram

            bounds, counts, _, total = \
                self.metrics.histogram(rule.metric).buckets_snapshot()
            if total == 0:
                return 0.0
            return Histogram.fraction_over_from(bounds, counts,
                                                rule.threshold_s)
        submitted = self.metrics.counter(
            rule.denominator
            or f"requests_submitted_class_{rule.request_class}").value
        if submitted <= 0:
            return 0.0
        return min(1.0, self.metrics.counter(rule.metric).value / submitted)

    # ----------------------------------------------------------- evaluation
    def maybe_evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Cadence-gated :meth:`evaluate` for the router tick."""
        now = now if now is not None else self.clock()
        if now - self._last_eval < self.config.eval_interval_s:
            return []
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Run every rule's state machine once; returns the transitions
        (``{"alert", "transition": "firing"|"resolved", ...}``)."""
        now = now if now is not None else self.clock()
        self._last_eval = now
        thr = self.config.burn_rate_threshold
        transitions: List[dict] = []
        for rule in self.rules:
            fast = self._burn(rule, self.config.fast_window_s)
            slow = self._burn(rule, self.config.slow_window_s)
            with self._lock:
                s = self._states[rule.name]
                s.burn_fast = fast if fast is not None else 0.0
                s.burn_slow = slow if slow is not None else 0.0
                if not s.firing:
                    # firing needs positive evidence in BOTH windows
                    if (fast is not None and slow is not None
                            and fast > thr and slow > thr):
                        s.firing = True
                        s.fired_t = now
                        s.fire_count += 1
                        transitions.append({"alert": rule.name,
                                            "transition": "firing",
                                            "burn_fast": fast,
                                            "burn_slow": slow})
                elif fast is not None and fast <= thr:
                    # resolution ALSO needs evidence: a populated fast
                    # window burning at/below threshold (recovery
                    # detection rides the short window; a data-less
                    # window keeps the alert up rather than flapping it)
                    s.firing = False
                    s.resolved_t = now
                    transitions.append({
                        "alert": rule.name, "transition": "resolved",
                        "firing_s": (now - s.fired_t
                                     if s.fired_t is not None else 0.0)})
        if self.metrics is not None and self.rules:
            self.metrics.gauge("alerts_firing").set(len(self.firing()))
        for tr in transitions:
            self._on_transition(tr)
        return transitions

    def _on_transition(self, tr: dict) -> None:
        rule = next(r for r in self.rules if r.name == tr["alert"])
        if tr["transition"] == "firing":
            logger.warning(
                f"SLO alert FIRING: {rule.name} (class "
                f"{rule.request_class}, {rule.kind}) burn "
                f"fast={tr['burn_fast']:.1f} slow={tr['burn_slow']:.1f} "
                f"(threshold {self.config.burn_rate_threshold})")
            if self.metrics is not None:
                self.metrics.gauge(f"alert_firing_{rule.name}").set(1.0)
            if self.journal is not None:
                self.journal.emit("alert_firing", alert=rule.name,
                                  request_class=rule.request_class,
                                  slo_kind=rule.kind,
                                  burn_fast=round(tr["burn_fast"], 3),
                                  burn_slow=round(tr["burn_slow"], 3))
            if self.recorder is not None and self.config.dump_on_alert:
                # same limiter as error dumps: an alert storm must not
                # fill the disk; telemetry-off recorders no-op inside
                self.recorder.on_event(f"alert_{rule.name}")
        else:
            logger.warning(f"SLO alert resolved: {rule.name} after "
                           f"{tr['firing_s']:.1f}s")
            if self.metrics is not None:
                self.metrics.gauge(f"alert_firing_{rule.name}").set(0.0)
            if self.journal is not None:
                self.journal.emit("alert_resolved", alert=rule.name,
                                  firing_s=round(tr["firing_s"], 3))
