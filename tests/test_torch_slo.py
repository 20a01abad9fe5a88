"""Port parity: the rest of ``deepspeed_tpu_torch/telemetry`` against the JAX
package's ``deepspeed_tpu/telemetry`` on the CPU, with no model.

Each case body runs over each package's modules on the same inputs (a fake
clock where time matters) and returns what it observed; the port must
observe what the JAX package does, and the body's asserts hold for both.
The cases mirror ``tests/test_slo_observability.py`` (histogram consistency
under races, the windowed-metrics ring, the ops journal and its JSONL sink,
the burn-rate alert state machine, registry pre-declaration),
``tests/test_telemetry.py:165-275`` (coverage, the flight recorder and its
rate limit, the config builders, Prometheus text) and the fleet journal's
ingest and the span re-basing of ``telemetry/fleet.py``.
"""

import json
import os
import tempfile
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import deepspeed_tpu.serving.metrics as j_metrics
import deepspeed_tpu.telemetry as j_tel
import deepspeed_tpu.telemetry.fleet as j_fleet
import deepspeed_tpu_torch.serving.metrics as t_metrics
import deepspeed_tpu_torch.telemetry as t_tel
import deepspeed_tpu_torch.telemetry.fleet as t_fleet

JAX = SimpleNamespace(M=j_metrics, T=j_tel, F=j_fleet)
PORT = SimpleNamespace(M=t_metrics, T=t_tel, F=t_fleet)
TIME_KEYS = ("t", "wall_time", "t_start", "t_end", "tid", "ts")


def both(case):
    """A test that runs ``case`` over each package and holds the port's
    observation to the JAX package's."""
    def test():
        ref = case(JAX)
        got = case(PORT)
        assert got == ref
    test.__name__ = case.__name__
    test.__doc__ = case.__doc__
    return test


def _timeless(events):
    return [{k: v for k, v in e.items() if k not in TIME_KEYS}
            for e in events]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ------------------------------------------------- histogram consistency
@both
def test_racing_observes_never_negative_deltas(ns):
    h = ns.M.Histogram((0.1, 1.0, 10.0))
    stop = threading.Event()

    def pound():
        while not stop.is_set():
            h.observe(0.05)
            h.observe(5.0)

    threads = [threading.Thread(target=pound) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        prev = h.buckets_snapshot()
        for _ in range(100):
            cur = h.buckets_snapshot()
            d_counts = [a - b for a, b in zip(cur[1], prev[1])]
            assert all(d >= 0 for d in d_counts), d_counts
            d_count = cur[3] - prev[3]
            assert d_count == sum(d_counts)
            assert cur[2] - prev[2] == pytest.approx(
                d_counts[0] * 0.05 + d_counts[2] * 5.0)
            prev = cur
    finally:
        stop.set()
        for t in threads:
            t.join()
    return len(prev[1])


@both
def test_snapshot_internally_consistent_under_races(ns):
    h = ns.M.Histogram((0.1, 1.0))
    stop = threading.Event()

    def pound():
        while not stop.is_set():
            h.observe(0.05)

    t = threading.Thread(target=pound)
    t.start()
    try:
        for _ in range(100):
            s = h.snapshot()
            if s["count"]:
                assert s["sum"] == pytest.approx(s["count"] * 0.05)
                assert s["mean"] == pytest.approx(0.05)
    finally:
        stop.set()
        t.join()
    return sorted(s)


@both
def test_percentile_from_matches_cumulative(ns):
    h = ns.M.Histogram(ns.M.DEFAULT_LATENCY_BUCKETS)
    rng = np.random.default_rng(0)
    for v in rng.uniform(0.001, 5.0, size=500):
        h.observe(float(v))
    bounds, counts, _, _ = h.buckets_snapshot()
    out = []
    for q in (50, 90, 95, 99):
        p = h.percentile(q)
        assert p == ns.M.Histogram.percentile_from(bounds, counts, q)
        out.append(p)
    return out


@both
def test_percentile_clamps_to_largest_finite_bound(ns):
    h = ns.M.Histogram(buckets=(0.1, 1.0))
    for _ in range(10):
        h.observe(50.0)
    out = [h.percentile(q) for q in (1, 50, 99, 100)]
    assert all(np.isfinite(p) and p == 1.0 for p in out)
    assert ns.M.Histogram(buckets=()).percentile(50) == 0.0
    return out


@both
def test_render_prometheus_counters_gauges(ns):
    reg = ns.M.MetricsRegistry("serving")
    reg.counter("requests_completed").inc(3)
    reg.gauge("queue_depth").set(5)
    text = reg.render_prometheus()
    lines = text.splitlines()
    assert "# TYPE serving_requests_completed counter" in lines
    assert "serving_requests_completed 3" in lines
    assert "serving_queue_depth 5" in lines
    assert text.endswith("\n")
    return text


@both
def test_render_prometheus_histogram_buckets(ns):
    reg = ns.M.MetricsRegistry("serving")
    h = reg.histogram("lat_s", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 99.0):
        h.observe(v)
    lines = reg.render_prometheus().splitlines()
    assert 'serving_lat_s_bucket{le="0.1"} 1' in lines
    assert 'serving_lat_s_bucket{le="+Inf"} 5' in lines
    assert "serving_lat_s_count 5" in lines
    return lines


# ---------------------------------------------------- windowed metrics
def _windowed(ns):
    reg = ns.M.MetricsRegistry("serving")
    clock = FakeClock()
    w = ns.T.WindowedMetrics(reg, bucket_s=1.0, history_s=60.0, clock=clock)
    return reg, w, clock


@both
def test_window_percentile_sees_only_the_window(ns):
    reg, w, clock = _windowed(ns)
    h = reg.histogram("ttft_s", ns.M.DEFAULT_LATENCY_BUCKETS)
    w.tick()
    for _ in range(20):
        h.observe(0.01)
    clock.t = 10.0
    w.tick()
    for _ in range(20):
        h.observe(0.4)
    clock.t = 12.0
    w.tick()
    out = (w.window_percentile("ttft_s", 95, 3.0),
           w.window_percentile("ttft_s", 50, 100.0),
           w.window_count("ttft_s", 3.0), w.window_count("ttft_s", 100.0))
    assert out[0] > 0.25 and out[1] < 0.1 and out[2:] == (20, 40)
    return out


@both
def test_window_agrees_with_cumulative_over_full_history(ns):
    reg, w, clock = _windowed(ns)
    h = reg.histogram("ttft_s", ns.M.DEFAULT_LATENCY_BUCKETS)
    w.tick()
    rng = np.random.default_rng(1)
    for v in rng.uniform(0.001, 2.0, size=300):
        h.observe(float(v))
    clock.t = 5.0
    w.tick()
    out = []
    for q in (50, 95, 99):
        assert w.window_percentile("ttft_s", q, 1e9) == h.percentile(q)
        out.append(h.percentile(q))
    return out


@both
def test_window_rate_and_delta(ns):
    reg, w, clock = _windowed(ns)
    c = reg.counter("tokens_generated")
    w.tick()
    c.inc(100)
    clock.t = 4.0
    w.tick()
    assert w.window_delta("tokens_generated", 10.0) == 100
    assert w.window_rate("tokens_generated", 10.0) == pytest.approx(25.0)
    return (w.window_delta("tokens_generated", 10.0),
            w.window_rate("tokens_generated", 10.0))


@both
def test_fraction_over_threshold(ns):
    reg, w, clock = _windowed(ns)
    h = reg.histogram("ttft_s", ns.M.DEFAULT_LATENCY_BUCKETS)
    w.tick()
    for _ in range(30):
        h.observe(0.01)
    for _ in range(10):
        h.observe(0.4)
    clock.t = 1.0
    w.tick()
    out = (w.window_fraction_over("ttft_s", 0.1, 10.0),
           w.window_fraction_over("ttft_s", 1e6, 10.0))
    assert out[0] == pytest.approx(0.25) and out[1] == 0.0
    return out


@both
def test_no_data_reads_none_not_zero(ns):
    reg, w, clock = _windowed(ns)
    reg.histogram("ttft_s", ns.M.DEFAULT_LATENCY_BUCKETS)
    first = w.window_percentile("ttft_s", 95, 10.0)
    w.tick()
    clock.t = 1.0
    w.tick()
    out = (first, w.window_percentile("ttft_s", 95, 10.0),
           w.window_fraction_over("ttft_s", 0.1, 10.0))
    assert out == (None, None, None)
    return out


@both
def test_reset_histogram_clamps_never_negative(ns):
    reg, w, clock = _windowed(ns)
    h = reg.histogram("ttft_s", ns.M.DEFAULT_LATENCY_BUCKETS)
    for _ in range(50):
        h.observe(0.01)
    w.tick()
    h2 = reg.histogram("ttft_s", ns.M.DEFAULT_LATENCY_BUCKETS, reset=True)
    h2.observe(0.01)
    clock.t = 1.0
    w.tick()
    d = w.window_hist("ttft_s", 10.0)
    assert d[3] >= 0 and all(c >= 0 for c in d[1]) and d[2] >= 0.0
    return d


@both
def test_stalled_ticks_read_no_data_not_stale(ns):
    reg, w, clock = _windowed(ns)
    h = reg.histogram("ttft_s", ns.M.DEFAULT_LATENCY_BUCKETS)
    w.tick()
    for _ in range(10):
        h.observe(0.5)
    clock.t = 1.0
    w.tick()
    clock.t = 50.0
    w.tick()
    assert w.window_hist("ttft_s", 2.0) is None
    assert w.window_percentile("ttft_s", 95, 2.0) is None
    assert w.window_count("ttft_s", 1e9) == 10
    return w.window_count("ttft_s", 1e9)


@both
def test_ring_is_bounded(ns):
    reg, w, clock = _windowed(ns)
    for i in range(500):
        clock.t = float(i)
        w.tick()
    assert len(w) <= w.max_snapshots
    return len(w), w.max_snapshots


@both
def test_fast_tickers_refresh_head_not_history(ns):
    reg, w, clock = _windowed(ns)
    h = reg.histogram("ttft_s", ns.M.DEFAULT_LATENCY_BUCKETS)
    w.tick()
    for i in range(1, 600):
        clock.t = i * 0.1
        if i == 595:
            h.observe(0.01)
        w.tick()
    assert len(w) <= 125
    assert w.window_count("ttft_s", 1e9) == 1
    assert w.window_count("ttft_s", 1.0) == 1
    return len(w)


@both
def test_out_of_order_tick_dropped(ns):
    reg, w, clock = _windowed(ns)
    w.tick(5.0)
    w.tick(8.0)
    w.tick(6.0)
    pair = w._window_pair(100.0)
    assert pair[1]["t"] == 8.0 and len(w) == 2
    return pair[1]["t"], len(w)


@both
def test_window_summary(ns):
    reg, w, clock = _windowed(ns)
    h = reg.histogram("ttft_s", ns.M.DEFAULT_LATENCY_BUCKETS)
    w.tick()
    for v in (0.01, 0.02, 0.3, 0.9):
        h.observe(v)
    clock.t = 2.0
    w.tick()
    return w.summary(["ttft_s", "tpot_s"], 10.0)


# ------------------------------------------------------------ journal
@both
def test_emit_and_validate(ns):
    j = ns.T.OpsJournal(capacity=16)
    j.emit("replica_restart", replica=0, attempt=1, recovery_s=0.5)
    j.emit("brownout_enter", healthy_fraction=0.4)
    assert ns.T.validate_events(j.events()) == []
    return _timeless(j.events())


@both
def test_journal_rejects_bad_events(ns):
    msgs = []
    for kind, detail in (("meteor_strike", {"where": "everywhere"}),
                         ("replica_restart", {"replica": 0}),
                         ("brownout_enter", {"healthy_fraction": object()})):
        with pytest.raises(ValueError) as ei:
            ns.T.OpsJournal().emit(kind, **detail)
        msgs.append(str(ei.value).split(":")[0])
    return msgs


@both
def test_bounded_capacity_and_total(ns):
    j = ns.T.OpsJournal(capacity=5)
    for i in range(20):
        j.emit("train_wedge", step=i)
    assert len(j) == 5 and j.total_emitted == 20
    return [e["detail"]["step"] for e in j.events()]


@both
def test_seq_monotonic_filtering_and_count(ns):
    j = ns.T.OpsJournal(capacity=64)
    for i in range(30):
        j.emit("checkpoint_saved", step=i, urgent=False)
    j.emit("train_wedge", step=1)
    j.emit("train_wedge", step=2)
    evs = j.events()
    assert ns.T.validate_events(evs) == []
    seqs = [e["seq"] for e in evs]
    assert seqs == sorted(seqs)
    return (j.count("train_wedge"), len(j.events(kinds=("train_wedge",))),
            len(j.events(limit=1)), seqs)


@both
def test_validate_event_problems(ns):
    good = ns.T.OpsJournal().emit("train_wedge", step=3)
    bad = [dict(good, kind="nope"), {k: v for k, v in good.items()
                                     if k != "seq"},
           dict(good, detail={})]
    return [ns.T.validate_event(e) for e in [good] + bad]


@both
def test_jsonl_sink_is_byte_capped(ns):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "journal.jsonl")
        j = ns.T.OpsJournal(capacity=1000, path=path, max_file_bytes=600)
        for i in range(50):
            j.emit("train_wedge", step=i)
        assert os.path.getsize(path) <= 600
        assert len(j) == 50
        lines = [json.loads(line) for line in open(path)]
    return _timeless(lines)


@both
def test_jsonl_sink_seq_ordered_under_concurrent_emits(ns):
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "j.jsonl")
        j = ns.T.OpsJournal(capacity=4096, path=path, max_file_bytes=10**7)

        def emit_many():
            for _ in range(200):
                j.emit("train_wedge", step=1)

        threads = [threading.Thread(target=emit_many) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        lines = [json.loads(line) for line in open(path)]
    seqs = [line["seq"] for line in lines]
    assert seqs == list(range(1, 801))
    assert ns.T.validate_events(lines) == []
    return len(lines)


@both
def test_dump_and_render_text(ns):
    j = ns.T.OpsJournal()
    j.emit("brownout_enter", healthy_fraction=0.3)
    j.emit("replica_parked", replica=3, crashes_in_window=5)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "dump.jsonl")
        n = j.dump(path)
        kinds = [json.loads(line)["kind"] for line in open(path)]
    text = j.render_text()
    assert "replica_parked" in text and "replica=3" in text
    # the rendered line starts with the event's clock reading
    return n, kinds, [line.split("]", 1)[1] for line in text.splitlines()]


# ------------------------------------------------------- fleet journal
@both
def test_fleet_journal_ingest_dedups_and_merges(ns):
    local = ns.T.OpsJournal(source="serving")
    fleet = ns.F.FleetJournal(local, capacity_per_source=4)
    local.emit("train_wedge", step=0)
    remote = ns.T.OpsJournal(source="replica-1")
    evs = [remote.emit("train_wedge", step=i) for i in range(6)]
    got = [fleet.ingest("r1", evs[:3]), fleet.ingest("r1", evs),
           fleet.ingest("r1", [{"kind": "garbage"}])]
    return (got, fleet.last_seq("r1"), fleet.sources(),
            fleet.count("train_wedge"), _timeless(fleet.events()))


@both
def test_ingest_remote_spans_rebases_and_reparents(ns):
    tr = ns.T.Tracer()
    root = tr.begin("rpc", trace_id="req-1")
    root.end()
    spans = [{"span_id": 1, "parent_id": None, "name": "server",
              "trace_id": "req-1", "t_start": 10.0, "t_end": 12.0,
              "attrs": {"remote_parent_id": root.span_id}},
             {"span_id": 2, "parent_id": 1, "name": "prefill",
              "trace_id": "req-1", "t_start": 10.5, "t_end": 11.0,
              "attrs": {}},
             {"span_id": 3, "name": "broken"}]
    n = ns.F.ingest_remote_spans(tr, spans, offset=ns.F.source_id_offset(0),
                                 clock_offset_s=5.0, source="r1", pid=7)
    out = [(s["name"], s["span_id"], s["parent_id"], s["t_start"],
            s["t_end"], s["attrs"].get("source")) for s in tr.export()
           if s["name"] != "rpc"]
    chrome = ns.F.fleet_chrome_trace(tr.export())
    assert ns.T.validate_chrome_trace(chrome) == []
    return n, sorted(out)


# --------------------------------------------------------- alert engine
def _alerts(ns, classes=None, recorder=None, **over):
    reg = ns.M.serving_metrics()
    clock = FakeClock()
    cfg = ns.T.SLOConfig(enabled=True,
                         classes=classes or {"interactive":
                                             {"ttft_p95_ms": 100.0}},
                         fast_window_s=2.0, slow_window_s=6.0,
                         burn_rate_threshold=4.0, min_window_count=2,
                         eval_interval_s=0.0, **over)
    w = ns.T.WindowedMetrics(reg, bucket_s=1.0, history_s=120.0, clock=clock)
    j = ns.T.OpsJournal()
    eng = ns.T.AlertEngine(cfg, w, metrics=reg, journal=j, recorder=recorder,
                           clock=clock)
    return reg, w, j, eng, clock


def _transitions(trs):
    return [{k: v for k, v in t.items() if k not in TIME_KEYS} for t in trs]


@both
def test_rules_built_and_gauges_predeclared(ns):
    reg, _, _, eng, _ = _alerts(ns, classes={
        "interactive": {"ttft_p95_ms": 100.0, "tpot_p95_ms": 20.0,
                        "availability": 0.999}})
    names = {r.name for r in eng.rules}
    assert names == {"slo_ttft_interactive", "slo_tpot_interactive",
                     "slo_availability_interactive"}
    gauges = reg.names()["gauges"]
    assert "alerts_firing" in gauges
    assert all(f"alert_firing_{n}" in gauges for n in names)
    return sorted((r.name, r.kind, r.metric, r.threshold_s, r.budget,
                   r.denominator) for r in eng.rules)


@both
def test_fires_on_both_windows_then_resolves_on_evidence(ns):
    reg, w, j, eng, clock = _alerts(ns)
    h = reg.histogram("ttft_s_class_interactive")
    w.tick()
    assert eng.evaluate(0.0) == []
    for _ in range(10):
        h.observe(0.5)
    clock.t = 1.0
    w.tick()
    fired = _transitions(eng.evaluate(1.0))
    assert [t["transition"] for t in fired] == ["firing"]
    assert reg.gauge("alerts_firing").value == 1.0
    for t_new in (2.0, 3.0, 4.0):
        clock.t = t_new
        for _ in range(10):
            h.observe(0.001)
        w.tick()
    resolved = _transitions(eng.evaluate(4.0))
    assert [t["transition"] for t in resolved] == ["resolved"]
    assert eng.firing() == []
    assert ns.T.validate_events(j.events()) == []
    return fired, resolved, _timeless(j.events())


@both
def test_no_evidence_neither_fires_nor_resolves(ns):
    reg, w, j, eng, clock = _alerts(ns)
    h = reg.histogram("ttft_s_class_interactive")
    w.tick()
    h.observe(9.0)
    clock.t = 1.0
    w.tick()
    assert eng.evaluate(1.0) == []
    for _ in range(10):
        h.observe(9.0)
    clock.t = 2.0
    w.tick()
    assert [t["transition"] for t in eng.evaluate(2.0)] == ["firing"]
    for t_new in (5.0, 9.0, 20.0):
        clock.t = t_new
        w.tick()
        assert eng.evaluate(t_new) == []
    assert eng.firing() == ["slo_ttft_interactive"]
    return eng.firing()


@both
def test_slow_window_guards_against_blips(ns):
    reg, w, j, eng, clock = _alerts(ns)
    h = reg.histogram("ttft_s_class_interactive")
    w.tick()
    for t_new in (1.0, 2.0, 3.0, 4.0):
        clock.t = t_new
        for _ in range(50):
            h.observe(0.001)
        w.tick()
    for _ in range(30):
        h.observe(0.5)
    clock.t = 5.0
    w.tick()
    trs = eng.evaluate(5.0)
    st = eng.status()["slo_ttft_interactive"]
    assert st["burn_fast"] > 4.0 and st["burn_slow"] < 4.0
    assert trs == [] and eng.firing() == []
    return st["burn_fast"], st["burn_slow"]


@both
def test_availability_rule(ns):
    reg, w, j, eng, clock = _alerts(ns, classes={
        "batch": {"availability": 0.99}})
    sub = reg.counter("requests_submitted_class_batch")
    shed = reg.counter("requests_shed_class_batch")
    w.tick()
    sub.inc(20)
    shed.inc(10)
    clock.t = 1.0
    w.tick()
    trs = _transitions(eng.evaluate(1.0))
    assert [t["transition"] for t in trs] == ["firing"]
    assert eng.firing() == ["slo_availability_batch"]
    return trs


@both
def test_status_reports_budget_spend(ns):
    reg, w, j, eng, clock = _alerts(ns)
    h = reg.histogram("ttft_s_class_interactive")
    for _ in range(95):
        h.observe(0.001)
    for _ in range(5):
        h.observe(0.5)
    st = eng.status()["slo_ttft_interactive"]
    assert st["budget_spent_frac"] == pytest.approx(1.0)
    assert st["target_ms"] == 100.0
    return {k: v for k, v in st.items() if k not in TIME_KEYS
            and not k.endswith("_t")}


@both
def test_new_firing_dumps_flight_recorder_rate_limited(ns):
    with tempfile.TemporaryDirectory() as d:
        tracer = ns.T.Tracer(enabled=True)
        rec = ns.T.FlightRecorder(tracer, dump_dir=d, max_error_dumps=1,
                                  error_dump_window_s=3600.0)
        reg, w, j, eng, clock = _alerts(ns, recorder=rec)
        h = reg.histogram("ttft_s_class_interactive")
        w.tick()

        def breach_then_recover(t0):
            clock.t = t0 - 1.0
            w.tick()
            clock.t = t0
            for _ in range(10):
                h.observe(0.5)
            w.tick()
            eng.evaluate(clock.t)
            for dt in (2.0, 4.0):
                clock.t = t0 + dt
                for _ in range(10):
                    h.observe(0.001)
                w.tick()
            eng.evaluate(clock.t)

        breach_then_recover(1.0)
        breach_then_recover(10.0)
        dumps = [f for f in os.listdir(d) if f.startswith("flightrec_")]
    assert eng.status()["slo_ttft_interactive"]["fire_count"] == 2
    assert len(dumps) == 1 and "alert_slo_ttft_interactive" in dumps[0]
    return eng.status()["slo_ttft_interactive"]["fire_count"], len(dumps)


@both
def test_tenant_rules(ns):
    """Per-tenant targets make per-tenant rules over the tenant series."""
    reg, w, j, eng, clock = _alerts(ns, tenants={
        "acme": {"ttft_p95_ms": 50.0, "availability": 0.9}})
    return sorted((r.name, r.scope, r.metric, r.denominator)
                  for r in eng.rules)


# ---------------------------------------------- registry pre-declaration
@both
def test_custom_classes_expose_zero_series_before_traffic(ns):
    reg = ns.M.serving_metrics(["interactive", "batch", "bulk_eval"])
    text = reg.render_prometheus()
    assert "serving_ttft_s_class_bulk_eval_count 0" in text
    assert "serving_requests_shed_class_bulk_eval 0" in text
    return text


@both
def test_stock_registry_has_alerts_firing(ns):
    names = ns.M.serving_metrics().names()
    assert "alerts_firing" in names["gauges"]
    return names


# --------------------------------------------------------- flight recorder
@both
def test_trace_coverage(ns):
    def mk(a, b):
        return {"t_start": a, "t_end": b}
    out = [ns.T.trace_coverage([mk(0, 1)], 0, 1),
           ns.T.trace_coverage([mk(0, 0.6), mk(0.4, 1.0)], 0, 1),
           ns.T.trace_coverage([mk(0, 0.25), mk(0.75, 1.0)], 0, 1),
           ns.T.trace_coverage([{"t_start": 0.5, "t_end": None}], 0, 1),
           ns.T.trace_coverage([], 0, 1)]
    assert out == pytest.approx([1.0, 1.0, 0.5, 0.5, 0.0])
    return out


@both
def test_flight_recorder_dump_and_snapshots(ns):
    with tempfile.TemporaryDirectory() as d:
        tr = ns.T.Tracer()
        rec = ns.T.FlightRecorder(tr, max_snapshots=3, dump_dir=d)
        rec.add_metrics_provider("m", lambda: {"v": 7})
        rec.add_metrics_provider("boom", lambda: 1 / 0)
        for _ in range(5):
            rec.snapshot_metrics()
        with tr.span("work", trace_id="t"):
            pass
        paths = rec.dump(reason="unit")
        record = json.load(open(paths["json"]))
        chrome = json.load(open(paths["chrome_trace"]))
    assert record["format"].startswith("deepspeed_tpu.flight_recorder")
    assert len(record["metric_snapshots"]) == 3
    assert record["metric_snapshots"][0]["m"] == {"v": 7}
    assert "error" in record["metric_snapshots"][0]["boom"]
    assert [s["name"] for s in record["spans"]] == ["work"]
    assert ns.T.validate_chrome_trace(chrome) == []
    return (record["format"], record["reason"],
            [s["name"] for s in record["spans"]],
            sorted(os.path.basename(p)[:12] for p in paths.values()))


@both
def test_flight_recorder_on_error_rate_limited(ns):
    with tempfile.TemporaryDirectory() as d:
        clock = [100.0]
        tr = ns.T.Tracer(clock=lambda: clock[0])
        rec = ns.T.FlightRecorder(tr, dump_dir=d, max_error_dumps=2,
                                  error_dump_window_s=60.0)
        outs = [rec.on_error("replica-0", RuntimeError(f"e{i}")) is not None
                for i in range(4)]
        clock[0] += 61.0
        later = rec.on_error("replica-0", RuntimeError("later")) is not None
        off = ns.T.FlightRecorder(ns.T.NOOP_TRACER, dump_dir=d).on_error(
            "x", RuntimeError())
    assert outs == [True, True, False, False] and later and off is None
    return outs, later


@both
def test_telemetry_config_builders(ns):
    tc = ns.T.TelemetryConfig()
    assert tc.build_tracer() is ns.T.NOOP_TRACER
    tc_on = ns.T.TelemetryConfig(enabled=True, max_spans=16,
                                 xla_annotations=True)
    tr = tc_on.build_tracer()
    assert tr.enabled and tr.max_spans == 16 and tr.xla_annotations
    rec = tc_on.build_recorder(tr, metrics=ns.M.serving_metrics())
    assert isinstance(rec, ns.T.FlightRecorder)
    rec.snapshot_metrics()
    return tc.to_dict(), tc_on.to_dict()


@both
def test_slo_config_parses_as_jax(ns):
    cfg = ns.T.SLOConfig(enabled=True, classes={
        "interactive": {"ttft_p95_ms": 250, "availability": 0.999}},
        tenants={"a": {"tpot_p95_ms": 30}}, journal_capacity=64)
    return cfg.to_dict()
