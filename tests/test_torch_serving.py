"""Port parity: the host logic of ``deepspeed_tpu_torch/serving`` against the
JAX package's ``deepspeed_tpu/serving`` on the CPU, with no model.

Every case body runs twice, once over each package's modules, on the same
inputs, and returns what it observed (orders as positions, counters,
states, snapshots); the port must observe what the JAX package does, and
the asserts inside the body hold for both. The cases mirror
``tests/test_serving.py`` (metrics, the admission queue, the router and the
replica with engine stand-ins), the injector, brownout and restart-policy
cases of ``tests/test_fault_tolerance.py``, and the accept and reject cases
of every config validator. Also here: the kernel wrappers' launch counters
stay exact when threads bump them at once.
"""

import random
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import deepspeed_tpu.inference.v2.scheduling_utils as j_sched_utils
import deepspeed_tpu.runtime.config as j_rconfig
import deepspeed_tpu.serving as j_serving
import deepspeed_tpu.serving.metrics as j_metrics
import deepspeed_tpu.serving.replica as j_replica
import deepspeed_tpu.serving.router as j_router
import deepspeed_tpu.utils.restart as j_restart
import deepspeed_tpu_torch.inference.v2.scheduling_utils as t_sched_utils
import deepspeed_tpu_torch.runtime.config as t_rconfig
import deepspeed_tpu_torch.serving as t_serving
import deepspeed_tpu_torch.serving.metrics as t_metrics
import deepspeed_tpu_torch.serving.replica as t_replica
import deepspeed_tpu_torch.serving.router as t_router
import deepspeed_tpu_torch.utils.restart as t_restart
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import quantizer as qz
import torch_cpu  # noqa: F401  (one torch thread: see the module)

JAX = SimpleNamespace(
    S=j_serving, M=j_metrics, Replica=j_replica.Replica,
    ReplicaState=j_replica.ReplicaState, Router=j_router.ReplicaRouter,
    load_config=j_rconfig.load_config,
    Success=j_sched_utils.SchedulingResult.Success,
    RestartPolicy=j_restart.RestartPolicy,
    logits=lambda n: np.zeros((n, 8), dtype=np.float32))
PORT = SimpleNamespace(
    S=t_serving, M=t_metrics, Replica=t_replica.Replica,
    ReplicaState=t_replica.ReplicaState, Router=t_router.ReplicaRouter,
    load_config=t_rconfig.load_config,
    Success=t_sched_utils.SchedulingResult.Success,
    RestartPolicy=t_restart.RestartPolicy,
    logits=lambda n: torch.zeros(n, 8))


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


def _req(ns, priority=None, deadline_s=None, prompt_len=4, max_new=4):
    pr = ns.S.Priority.NORMAL if priority is None else priority
    return ns.S.ServingRequest([1] * prompt_len, max_new, pr, deadline_s,
                               None)



# ------------------------------------------------------------------ metrics
@both
def test_counter_gauge(ns):
    c = ns.M.Counter()
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    g = ns.M.Gauge()
    g.set(7)
    g.dec(3)
    assert g.value == 4.0
    return c.value, g.value


@both
def test_histogram_percentiles(ns):
    h = ns.M.Histogram(buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.5, 1.5, 3.0, 7.0):
        h.observe(v)
    assert h.count == 5
    assert h.sum == pytest.approx(13.5)
    assert 1.0 <= h.percentile(50) <= 2.0
    assert 4.0 <= h.percentile(99) <= 8.0
    assert h.percentile(0) <= 1.0
    return [h.percentile(q) for q in (0, 10, 50, 90, 95, 99, 100)], h.mean


@both
def test_histogram_overflow_bucket(ns):
    h = ns.M.Histogram(buckets=(1.0, 2.0))
    h.observe(100.0)
    assert h.percentile(50) == 2.0
    assert h.mean == pytest.approx(100.0)
    return h.percentile(50), h.snapshot()


@both
def test_registry_snapshot_and_events(ns):
    reg = ns.M.MetricsRegistry("serving")
    reg.counter("requests_completed").inc(3)
    reg.gauge("queue_depth").set(5)
    reg.histogram("ttft_s").observe(0.02)
    snap = reg.snapshot()
    assert snap["requests_completed"] == 3
    assert snap["queue_depth"] == 5
    assert snap["ttft_s"]["count"] == 1
    tags = {t for t, _, _ in reg.events(step=7)}
    assert "serving/requests_completed" in tags
    assert "serving/ttft_s/p95" in tags
    assert all(s == 7 for _, _, s in reg.events(step=7))
    return snap, sorted(reg.events(step=7))


@both
def test_registry_publish_to_any_monitor(ns):
    """``publish`` hands the events to any object with ``write_events``
    (the JAX package's ``monitor/`` backends are such objects)."""
    class Monitor:
        def __init__(self):
            self.events = []

        def write_events(self, events):
            self.events.extend(events)

    reg = ns.M.serving_metrics()
    reg.counter("requests_completed").inc(2)
    mon = Monitor()
    reg.publish(mon, step=1)
    by_tag = {t: v for t, v, _ in mon.events}
    assert by_tag["serving/requests_completed"] == 2.0
    return sorted(mon.events)


@both
def test_predeclared_serving_metrics(ns):
    reg = ns.M.serving_metrics(["interactive", "batch", "custom"])
    snap = reg.snapshot()
    assert snap["requests_shed"] == 0.0
    assert snap["ttft_s"]["count"] == 0.0
    return snap


@both
def test_render_prometheus_text(ns):
    reg = ns.M.serving_metrics()
    reg.counter("requests_completed").inc(4)
    reg.gauge("queue_depth").set(2)
    for v in (0.01, 0.2, 3.0):
        reg.histogram("ttft_s").observe(v)
    text = reg.render_prometheus()
    assert "requests_completed" in text and "ttft_s_bucket" in text
    return text


# ------------------------------------------------------------------- queue
@both
def test_queue_sheds_when_full(ns):
    reg = ns.M.serving_metrics()
    q = ns.S.AdmissionQueue(max_depth=2, metrics=reg)
    q.offer(_req(ns))
    q.offer(_req(ns))
    with pytest.raises(ns.S.Rejected) as ei:
        q.offer(_req(ns))
    assert ei.value.reason == "overloaded"
    assert reg.snapshot()["requests_shed"] == 1
    assert len(q) == 2
    return reg.snapshot()["requests_shed"], len(q)


@both
def test_queue_shed_request_gets_terminal_state(ns):
    q = ns.S.AdmissionQueue(max_depth=1)
    q.offer(_req(ns))
    shed = _req(ns)
    with pytest.raises(ns.S.Rejected):
        q.offer(shed)
    assert shed.state == ns.S.RequestState.REJECTED
    assert shed.wait(0)
    return shed.state.value, shed.finish_reason


@both
def test_queue_priority_then_deadline_order(ns):
    P = ns.S.Priority
    q = ns.S.AdmissionQueue(max_depth=10)
    low = _req(ns, priority=P.LOW)
    high = _req(ns, priority=P.HIGH)
    tight = _req(ns, priority=P.NORMAL, deadline_s=10.0)
    loose = _req(ns, priority=P.NORMAL, deadline_s=60.0)
    none = _req(ns, priority=P.NORMAL, deadline_s=None)
    offered = [none, low, loose, tight, high]
    for r in offered:
        q.offer(r)
    order = [offered.index(q.pop(timeout=0.1)) for _ in range(5)]
    assert order == [4, 3, 2, 0, 1]
    return order


@both
def test_queue_expires_stale_requests_at_pop(ns):
    reg = ns.M.serving_metrics()
    q = ns.S.AdmissionQueue(max_depth=10, metrics=reg)
    stale = _req(ns, deadline_s=0.01)
    fresh = _req(ns, deadline_s=60.0)
    q.offer(stale)
    q.offer(fresh)
    time.sleep(0.03)
    got = q.pop(timeout=0.5)
    assert got is fresh
    assert stale.state == ns.S.RequestState.EXPIRED
    assert stale.finish_reason == ns.S.FinishReason.DEADLINE
    return stale.state.value, reg.snapshot()["requests_expired"]


@both
def test_queue_pop_skips_cancelled(ns):
    q = ns.S.AdmissionQueue(max_depth=10)
    a, b = _req(ns), _req(ns)
    q.offer(a)
    q.offer(b)
    a.cancel_requested.set()
    assert q.pop(timeout=0.5) is b
    assert a.state == ns.S.RequestState.CANCELLED
    return a.state.value, a.finish_reason


@both
def test_queue_pop_blocks_until_offer(ns):
    q = ns.S.AdmissionQueue(max_depth=4)
    got = []
    t = threading.Thread(target=lambda: got.append(q.pop(timeout=5.0)))
    t.start()
    time.sleep(0.02)
    r = _req(ns)
    q.offer(r)
    t.join(5.0)
    assert got and got[0] is r
    return len(got)


@both
def test_queue_close_drains(ns):
    q = ns.S.AdmissionQueue(max_depth=4)
    r = _req(ns)
    q.offer(r)
    left = q.close()
    assert left == [r]
    with pytest.raises(ns.S.Rejected) as ei:
        q.offer(_req(ns))
    assert ei.value.reason == "draining"
    assert q.pop(timeout=0.05) is None
    return ei.value.reason


@both
def test_queue_wait_histogram_populated(ns):
    reg = ns.M.serving_metrics()
    q = ns.S.AdmissionQueue(max_depth=4, metrics=reg)
    q.offer(_req(ns))
    q.pop(timeout=0.5)
    assert reg.snapshot()["queue_wait_s"]["count"] == 1
    return reg.snapshot()["queue_wait_s"]["count"]


@both
def test_queue_blocking_offer_waits_for_room(ns):
    reg = ns.M.serving_metrics()
    q = ns.S.AdmissionQueue(max_depth=1, metrics=reg)
    first = _req(ns)
    q.offer(first)
    blocked = _req(ns)
    done = threading.Event()

    def offerer():
        q.offer(blocked, block=True, timeout=5.0)
        done.set()

    t = threading.Thread(target=offerer)
    t.start()
    time.sleep(0.03)
    assert not done.is_set()
    assert q.pop(timeout=1.0) is first
    assert done.wait(5.0)
    t.join(5.0)
    assert q.pop(timeout=1.0) is blocked
    assert blocked.state != ns.S.RequestState.REJECTED
    return reg.snapshot()["requests_shed"]


@both
def test_queue_blocking_offer_timeout_sheds_once(ns):
    q = ns.S.AdmissionQueue(max_depth=1)
    q.offer(_req(ns))
    late = _req(ns)
    with pytest.raises(ns.S.Rejected) as ei:
        q.offer(late, block=True, timeout=0.03)
    assert ei.value.reason == "overloaded"
    assert late.state == ns.S.RequestState.REJECTED
    return ei.value.reason, late.state.value


@both
def test_custom_ttft_buckets_take_effect(ns):
    reg = ns.M.serving_metrics()
    h = reg.histogram("ttft_s", (0.5, 1.0), reset=True)
    assert h.bounds == (0.5, 1.0)
    assert reg.histogram("ttft_s") is h
    return h.bounds


@both
def test_queue_remove_frees_slot(ns):
    q = ns.S.AdmissionQueue(max_depth=2)
    a, b = _req(ns), _req(ns)
    q.offer(a)
    q.offer(b)
    assert q.remove(a) is True
    assert q.remove(a) is False
    assert len(q) == 1
    q.offer(_req(ns))
    assert q.pop(timeout=0.5) is b
    return len(q)


@both
def test_pop_sweeps_expired_entries_anywhere_in_heap(ns):
    P = ns.S.Priority
    reg = ns.M.serving_metrics()
    q = ns.S.AdmissionQueue(max_depth=10, metrics=reg)
    buried = _req(ns, priority=P.LOW, deadline_s=0.01)
    tops = [_req(ns, priority=P.HIGH, deadline_s=60.0) for _ in range(3)]
    q.offer(buried)
    for r in tops:
        q.offer(r)
    time.sleep(0.03)
    assert q.pop(timeout=0.5) is tops[0]
    assert buried.state == ns.S.RequestState.EXPIRED
    assert buried.wait(0)
    assert len(q) == 2
    return len(q), reg.snapshot()["requests_expired"]


@both
def test_queue_class_and_shed_rank_counters(ns):
    """Per-class queue gauges and the class-labelled shed counters."""
    reg = ns.M.serving_metrics(["interactive", "batch"])
    q = ns.S.AdmissionQueue(max_depth=2, metrics=reg)
    mk = ns.S.ServingRequest
    a = mk([1] * 4, 4, 1, None, None, request_class="batch", shed_rank=1)
    b = mk([1] * 4, 4, 1, None, None, request_class="interactive")
    q.offer(a)
    q.offer(b)
    with pytest.raises(ns.S.Rejected):
        q.offer(mk([1] * 4, 4, 1, None, None, request_class="batch",
                   shed_rank=1))
    snap = reg.snapshot()
    return {k: v for k, v in snap.items()
            if k.startswith(("queue_depth", "requests_shed"))}


# ---------------------------------------------------------------- brownout
@both
def test_brownout_sheds_lowest_urgency_queued_work(ns):
    P, RS = ns.S.Priority, ns.S.RequestState
    reg = ns.M.serving_metrics()
    q = ns.S.AdmissionQueue(max_depth=4, metrics=reg, brownout_threshold=0.5)
    highs = [ns.S.ServingRequest([1] * 4, 4, P.HIGH, 60.0, None)
             for _ in range(2)]
    lows = [ns.S.ServingRequest([1] * 4, 4, P.LOW, None, None)
            for _ in range(2)]
    for r in highs + lows:
        q.offer(r)
    q.set_healthy_fraction(0.4)
    assert len(q) == 2
    assert all(r.state == RS.REJECTED for r in lows)
    assert all(r.finish_reason == ns.S.FinishReason.BROWNOUT for r in lows)
    assert all(r.state == RS.QUEUED for r in highs)
    snap = reg.snapshot()
    q.set_healthy_fraction(1.0)
    assert reg.snapshot()["brownout_active"] == 0.0
    q.offer(ns.S.ServingRequest([1] * 4, 4, P.LOW, None, None))
    assert len(q) == 3
    return snap["requests_shed_brownout"], snap["brownout_active"], len(q)


@both
def test_brownout_offer_displaces_less_urgent_or_sheds_incoming(ns):
    P, RS = ns.S.Priority, ns.S.RequestState
    mk = ns.S.ServingRequest
    q = ns.S.AdmissionQueue(max_depth=4, metrics=ns.M.serving_metrics(),
                            brownout_threshold=0.6)
    q.set_healthy_fraction(0.5)
    low = mk([1] * 4, 4, P.LOW, None, None)
    q.offer(low)
    q.offer(mk([1] * 4, 4, P.NORMAL, 60.0, None))
    q.offer(mk([1] * 4, 4, P.HIGH, 10.0, None))
    assert low.state == RS.REJECTED and len(q) == 2
    with pytest.raises(ns.S.Rejected) as ei:
        q.offer(mk([1] * 4, 4, P.LOW, None, None))
    assert ei.value.reason == ns.S.FinishReason.BROWNOUT
    assert q.requeue(mk([1] * 4, 4, P.LOW, None, None)) is True
    assert len(q) == 3
    return low.finish_reason, ei.value.reason, len(q)


@both
def test_brownout_never_evicts_failover_requeued_work(ns):
    P, RS = ns.S.Priority, ns.S.RequestState
    mk = ns.S.ServingRequest
    q = ns.S.AdmissionQueue(max_depth=4, metrics=ns.M.serving_metrics(),
                            brownout_threshold=0.6)
    retried = [mk([1] * 4, 4, P.LOW, None, None) for _ in range(2)]
    for r in retried:
        r.attempts = 2
        assert q.requeue(r)
    fresh = mk([1] * 4, 4, P.LOW, None, None)
    q.offer(fresh)
    q.set_healthy_fraction(0.5)
    assert fresh.state == RS.REJECTED
    assert all(r.state == RS.QUEUED for r in retried)
    q.offer(mk([1] * 4, 4, P.HIGH, 10.0, None))
    assert all(r.state == RS.QUEUED for r in retried)
    assert len(q) == 3
    return fresh.finish_reason, len(q)


# ------------------------------------------------------- router and replica
class _FakeEngine:
    """Engine stand-in: enough surface for Replica/scheduler to exist."""

    class _Cfg:
        max_ragged_batch_size = 64
        max_ragged_sequence_count = 4
        max_chunk_tokens = 16

    class _MCfg:
        max_seq_len = 128

    class _Model:
        cfg = None

    def __init__(self, ns=None):
        self.ns = ns
        self.config = self._Cfg()
        self.model = self._Model()
        self.model.cfg = self._MCfg()
        self.flushed = []

    def flush(self, uid):
        self.flushed.append(uid)


class _CompletingFakeEngine(_FakeEngine):
    """Constant logits, every chunk schedulable: the worker loop runs end
    to end without a model."""

    def can_schedule(self, uids, lengths):
        return self.ns.Success

    def put(self, uids, chunks, **kw):
        return self.ns.logits(len(uids))

    def match_prefix(self, uid, prompt_tokens):
        return 0


def _router(ns, n=2):
    reg = ns.M.serving_metrics()
    q = ns.S.AdmissionQueue(max_depth=16, metrics=reg)
    reps = [ns.Replica(i, _FakeEngine(ns), reg) for i in range(n)]
    return ns.Router(reps, q, reg), reps, q, reg


@both
def test_router_picks_least_outstanding_tokens(ns):
    router, (r0, r1), _, _ = _router(ns)
    r0.assign(_req(ns, prompt_len=100, max_new=50))
    first = router.pick() is r1
    r1.assign(_req(ns, prompt_len=100, max_new=100))
    second = router.pick() is r0
    assert first and second
    return r0.outstanding_tokens, r1.outstanding_tokens


@both
def test_router_skips_draining_and_dead(ns):
    router, (r0, r1), _, reg = _router(ns)
    r0.drain()
    assert router.pick() is r1
    r1.state = ns.ReplicaState.DEAD
    assert router.pick() is None
    assert reg.snapshot()["replicas_healthy"] == 0
    return reg.snapshot()["replicas_healthy"]


@both
def test_router_fails_fast_with_no_replicas(ns):
    router, reps, q, reg = _router(ns)
    for r in reps:
        r.state = ns.ReplicaState.DEAD
    req = _req(ns)
    router._dispatch(req)
    assert req.state == ns.S.RequestState.FAILED
    assert req.wait(0)
    return req.finish_reason, reg.snapshot()["requests_failed"]


@both
def test_replica_wedge_detection(ns):
    r = ns.Replica(0, _FakeEngine(ns), wedge_timeout_s=0.01)
    r._steps_done = 1
    r._busy_since = time.monotonic() - 1.0
    r.last_progress_t = time.monotonic() - 1.0
    dead = r.check_health()
    r2 = ns.Replica(1, _FakeEngine(ns), wedge_timeout_s=0.01)
    r2.last_progress_t = time.monotonic() - 1.0
    idle = r2.check_health()
    r3 = ns.Replica(2, _FakeEngine(ns), wedge_timeout_s=0.01)
    r3._busy_since = time.monotonic() - 1.0
    r3.last_progress_t = time.monotonic() - 1.0
    cold = r3.check_health()
    assert dead == ns.ReplicaState.DEAD
    assert idle == cold == ns.ReplicaState.HEALTHY
    return dead.value, idle.value, cold.value


@both
def test_replica_engine_fault_fails_requests_terminally(ns):
    class ExplodingEngine(_FakeEngine):
        def can_schedule(self, uids, lengths):
            raise RuntimeError("device wedged")

        def put(self, uids, tokens, **kw):
            raise RuntimeError("device wedged")

    reg = ns.M.serving_metrics()
    r = ns.Replica(0, ExplodingEngine(ns), reg)
    req = _req(ns)
    assert r.assign(req)
    r.start()
    assert req.wait(10)
    r.stop(1.0)
    assert req.state == ns.S.RequestState.FAILED
    assert r.state == ns.ReplicaState.DEAD
    return req.finish_reason, r.state.value, reg.snapshot()["requests_failed"]


@both
def test_wedged_replica_fails_inflight_requests(ns):
    reg = ns.M.serving_metrics()
    r = ns.Replica(0, _FakeEngine(ns), reg, wedge_timeout_s=0.01)
    req = _req(ns)
    r._steps_done = 1
    r._active[req.uid] = req
    r._busy_since = time.monotonic() - 1.0
    r.last_progress_t = time.monotonic() - 1.0
    assert r.check_health() == ns.ReplicaState.DEAD
    assert req.wait(1.0)
    assert req.state == ns.S.RequestState.FAILED
    return req.state.value, reg.snapshot()["requests_failed"]


@both
def test_check_health_on_draining_replica(ns):
    r = ns.Replica(0, _FakeEngine(ns), wedge_timeout_s=0.01)
    r.drain()
    draining = r.check_health()
    r._steps_done = 1
    r._busy_since = time.monotonic() - 1.0
    r.last_progress_t = time.monotonic() - 1.0
    dead = r.check_health()
    assert draining == ns.ReplicaState.DRAINING
    assert dead == ns.ReplicaState.DEAD
    return draining.value, dead.value


@both
def test_assign_racing_drain(ns):
    reg = ns.M.serving_metrics()
    r = ns.Replica(0, _CompletingFakeEngine(ns), reg)
    won = _req(ns, prompt_len=3, max_new=2)
    assert r.assign(won) is True
    r.drain()
    lost = _req(ns)
    assert r.assign(lost) is False
    assert lost.state == ns.S.RequestState.QUEUED
    r.start()
    assert won.wait(10)
    r.thread.join(10)
    r.stop(1.0)
    assert won.state == ns.S.RequestState.FINISHED
    assert r.state == ns.ReplicaState.STOPPED
    return won.state.value, won.generated_tokens, r.state.value


@both
def test_double_stop_idempotent(ns):
    r = ns.Replica(0, _CompletingFakeEngine(ns), ns.M.serving_metrics())
    r.start()
    r.stop(2.0)
    first = r.state
    r.stop(2.0)
    assert first == r.state == ns.ReplicaState.STOPPED
    assert not r.thread.is_alive()
    return r.state.value


@both
def test_replica_streams_and_counts_tokens(ns):
    """A completing replica streams every token with contiguous indexes
    and publishes TTFT/TPOT and the completion counter."""
    reg = ns.M.serving_metrics()
    r = ns.Replica(0, _CompletingFakeEngine(ns), reg)
    reqs = [_req(ns, prompt_len=3 + i, max_new=3) for i in range(3)]
    for q in reqs:
        assert r.assign(q)
    r.start()
    for q in reqs:
        assert q.wait(10)
    r.stop(1.0)
    snap = reg.snapshot()
    streams = [[ev.index for ev in ns.S.RequestHandle(q, None).drain()]
               for q in reqs]
    return (streams, snap["requests_completed"], snap["tokens_generated"],
            snap["ttft_s"]["count"], snap["tpot_s"]["count"])


# --------------------------------------------------------------- injector
@both
def test_injector_schedule_fires_deterministically(ns):
    inj = ns.S.FaultInjector([
        {"kind": "crash", "replica": 0, "at_step": 2},
        {"kind": "wedge", "replica": 1, "at_step": 0, "duration_s": 0.0,
         "count": 2}])
    inj.on_step(0, 0)
    inj.on_step(0, 1)
    with pytest.raises(ns.S.InjectedFault):
        inj.on_step(0, 2)
    inj.on_step(0, 3)
    inj.on_step(1, 0)
    inj.on_step(1, 1)
    inj.on_step(1, 2)
    fired = [(k, r, i) for k, r, i, _ in inj.fired_events()]
    assert fired == [("crash", 0, 2), ("wedge", 1, 0), ("wedge", 1, 1)]
    return fired


@both
def test_injector_seeded_step_range_is_reproducible(ns):
    sched = [{"kind": "crash", "replica": 0, "at_step_range": [2, 40]}]
    draws = [ns.S.FaultInjector(sched, seed=s).events[0].at_step
             for s in range(20)]
    assert all(2 <= d <= 40 for d in draws)
    assert len(set(draws)) > 1
    return draws


@both
def test_injector_count_zero_fires_every_time(ns):
    inj = ns.S.FaultInjector([{"kind": "crash", "replica": 0, "at_step": 1,
                               "count": 0}])
    for step in (1, 2, 5):
        with pytest.raises(ns.S.InjectedFault):
            inj.on_step(0, step)
    return len(inj.fired_events())


@both
def test_injector_rejects_malformed_events(ns):
    msgs = []
    for bad in ({"kind": "meteor", "replica": 0, "at_step": 0},
                {"kind": "crash", "replica": 0},
                {"kind": "put_error", "replica": 0}):
        with pytest.raises(ValueError) as ei:
            ns.S.FaultInjector([bad])
        msgs.append(str(ei.value))
    return msgs


@both
def test_engine_proxy_injects_only_put_faults(ns):
    class Eng:
        config = "cfg-sentinel"

        def put(self, uids, chunks):
            return ("ok", uids)

    inj = ns.S.FaultInjector([
        {"kind": "put_error", "replica": 0, "at_put": 1},
        {"kind": "slow_forward", "replica": 1, "at_put": 0,
         "duration_s": 0.02}])
    wrapped = inj.wrap_engine(Eng(), 0)
    assert inj.wrap_engine(Eng(), 5).__class__ is Eng
    assert wrapped.config == "cfg-sentinel"
    out = [wrapped.put([1], [[2]])]
    with pytest.raises(ns.S.InjectedFault):
        wrapped.put([1], [[2]])
    out.append(wrapped.put([1], [[2]]))
    slow = inj.wrap_engine(Eng(), 1)
    t0 = time.monotonic()
    slow.put([1], [[2]])
    assert time.monotonic() - t0 >= 0.02
    return out, [(k, r, i) for k, r, i, _ in inj.fired_events()]


# ----------------------------------------------------------- restart policy
@both
def test_restart_policy_backoff_and_breaker(ns):
    """Seeded jittered exponential backoff and the windowed circuit
    breaker give the same decisions on the same clock."""
    pol = ns.RestartPolicy(0.5, 4.0, 0.2, 3, 10.0, random.Random(7))
    out = [pol.record_failure(t) for t in (0.0, 1.0, 2.0, 3.0, 20.0, 20.5)]
    assert out[2][1] is None                  # third in the window trips
    return out, pol.count(), pol.last_failure_time()


@both
def test_restart_policy_no_jitter_is_exact(ns):
    pol = ns.RestartPolicy(0.25, 1.0, 0.0, 10, 60.0, random.Random(0))
    out = [pol.record_failure(float(t)) for t in range(6)]
    assert [b for _, b in out] == [0.25, 0.5, 1.0, 1.0, 1.0, 1.0]
    full = ns.RestartPolicy(1.0, 8.0, 0.0, 10, 60.0, random.Random(3),
                            full_jitter=True)
    return out, [full.record_failure(float(t)) for t in range(5)]


# ------------------------------------------------------------------ configs
CONFIG_OK = {
    "defaults": {},
    "classes-merge": {"classes": {"gold": {"priority": 0, "shed_rank": 0}}},
    "tenants-merge": {"tenants": {"a": {"weight": 2.0, "token_rate": 10}}},
    "models": {"models": {"m": {"model": {"vocab_size": 8}, "replicas": 2}},
               "default_model": "m"},
    "admission": {"admission": {"reservation": True,
                                "preemption": {"enabled": True}}},
    "autoscaler": {"autoscaler": {"enabled": True, "min_replicas": 2,
                                  "max_replicas": 2}},
    "affinity": {"affinity": {"enabled": True, "max_share": 1.0}},
    "fabric": {"fabric": {"enabled": True, "peers": ["h:1"],
                          "federation": {"enabled": True,
                                         "peers": ["h:2"]}}},
    "quarantine": {"fabric": {"quarantine": {"enabled": True}}},
    "telemetry-slo": {"telemetry": {"enabled": True, "max_spans": 16},
                      "slo": {"enabled": True, "classes": {
                          "interactive": {"ttft_p95_ms": 250}}}},
    "faults": {"faults": {"enabled": True, "schedule": [
        {"kind": "crash", "replica": 0, "at_step": 3}]}},
}

CONFIG_BAD = {
    "preemption-without-reservation": {"admission": {
        "preemption": {"enabled": True}}},
    "autoscaler-min-0": {"autoscaler": {"min_replicas": 0}},
    "autoscaler-max-below-min": {"autoscaler": {"min_replicas": 3,
                                                "max_replicas": 2}},
    "autoscaler-brownout-0": {"autoscaler": {"brownout_fraction": 0.0}},
    "autoscaler-ticks": {"autoscaler": {"up_stable_ticks": 0}},
    "affinity-digest": {"affinity": {"digest_max_entries": 0}},
    "affinity-share": {"affinity": {"max_share": 1.5}},
    "affinity-window": {"affinity": {"share_window": 0}},
    "affinity-credit": {"affinity": {"credit_weight": -1.0}},
    "affinity-warmup": {"affinity": {"warmup_max_blocks": -1}},
    "affinity-interval": {"affinity": {"refresh_interval_s": 0.0}},
    "federation-lease": {"fabric": {"federation": {"lease_timeout_s": -1}}},
    "federation-peer": {"fabric": {"enabled": True, "federation": {
        "enabled": True, "peers": ["nohostport"]}}},
    "federation-export": {"fabric": {"enabled": True, "federation": {
        "enabled": True, "export_max_replicas": -1}}},
    "federation-inflight": {"fabric": {"enabled": True, "federation": {
        "enabled": True, "peer_max_inflight": -1}}},
    "federation-needs-fabric": {"fabric": {"federation": {"enabled": True}}},
    "quarantine-slow": {"fabric": {"quarantine": {"enabled": True,
                                                  "rpc_slow_s": 0}}},
    "quarantine-window": {"fabric": {"quarantine": {"enabled": True,
                                                    "window": 0}}},
    "quarantine-fraction": {"fabric": {"quarantine": {
        "enabled": True, "slow_fraction": 0.0}}},
    "quarantine-backoff": {"fabric": {"quarantine": {
        "enabled": True, "probe_backoff_s": 2.0,
        "probe_backoff_max_s": 1.0}}},
    "quarantine-escalate": {"fabric": {"quarantine": {
        "enabled": True, "escalate_quarantines": 0}}},
    "fabric-heartbeat": {"fabric": {"enabled": True, "heartbeat_s": 0}},
    "fabric-rpc": {"fabric": {"enabled": True, "rpc_timeout_s": 0}},
    "fabric-frame": {"fabric": {"enabled": True, "max_frame_bytes": 1024}},
    "fabric-peer": {"fabric": {"enabled": True, "peers": ["x"]}},
    "model-replicas": {"models": {"m": {"replicas": -1}}},
    "model-empty": {"models": {"m": {"replicas": 0}}},
    "model-min": {"models": {"m": {"min_replicas": 0}}},
    "model-max-below-min": {"models": {"m": {"min_replicas": 3,
                                             "max_replicas": 2}}},
    "model-peer": {"models": {"m": {"peers": ["x"]}}},
    "tenant-weight": {"tenants": {"a": {"weight": 0}}},
    "tenant-rate": {"tenants": {"a": {"token_rate": -1}}},
    "tenant-budget": {"tenants": {"a": {"kv_block_budget": -1}}},
    "default-model": {"models": {"m": {"model": {"vocab_size": 8}}},
                      "default_model": "other"},
    "wrong-type": {"max_queue_depth": "many"},
}


@pytest.mark.parametrize("name", list(CONFIG_OK))
def test_serving_config_accepts_as_jax(name):
    block = CONFIG_OK[name]
    ref = j_serving.ServingConfig(**block)
    got = t_serving.ServingConfig(**block)
    assert got.to_dict() == ref.model_dump()


@pytest.mark.parametrize("name", list(CONFIG_BAD))
def test_serving_config_rejects_as_jax(name):
    block = CONFIG_BAD[name]
    with pytest.raises(ValueError):
        j_serving.ServingConfig(**block)
    with pytest.raises(ValueError):
        t_serving.ServingConfig(**block)


@both
def test_serving_config_in_runtime_config(ns):
    cfg = ns.load_config({"serving": {"max_queue_depth": 7,
                                      "num_replicas": 3,
                                      "default_deadline_ms": 250.0}})
    assert cfg.serving.max_queue_depth == 7
    assert cfg.serving.num_replicas == 3
    assert ns.load_config({}).serving.shed_policy == "reject"
    return cfg.serving.to_dict()


@both
def test_fault_tolerance_config_in_runtime_config(ns):
    cfg = ns.load_config({"serving": {
        "fault_tolerance": {"enabled": True, "max_retries": 5,
                            "brownout_threshold": 0.5},
        "faults": {"enabled": True, "seed": 7, "schedule": [
            {"kind": "crash", "replica": 0, "at_step": 3}]}}})
    ft = cfg.serving.fault_tolerance
    assert ft.enabled and ft.max_retries == 5
    inj = cfg.serving.faults.build_injector()
    assert inj is not None and inj.events[0].at_step == 3
    dflt = ns.load_config({}).serving
    assert dflt.faults.build_injector() is None
    return ft.to_dict(), inj.events[0].at_step


@both
def test_flat_serving_aliases_in_runtime_config(ns):
    """The flat blocks (``prefix_cache``, ``kv_quant``, ``weight_quant``,
    ``kv_tier``, ``admission``, ``speculative``) and ``telemetry`` are
    typed on the training config, as in the JAX package."""
    cfg = ns.load_config({
        "prefix_cache": {"enabled": True, "max_cached_blocks": 9},
        "kv_quant": {"enabled": True, "dtype": "fp8_e4m3"},
        "weight_quant": {"enabled": True, "block": 64},
        "kv_tier": {"enabled": True, "host_max_bytes": 1024},
        "admission": {"reservation": True},
        "speculative": {"enabled": True, "max_draft_tokens": 3},
        "telemetry": {"enabled": True, "max_spans": 32}})
    return [getattr(cfg, k).to_dict() for k in (
        "prefix_cache", "kv_quant", "weight_quant", "kv_tier", "admission",
        "speculative", "telemetry")]


@both
def test_engine_blocks_stamp_engine_config(ns):
    """Each engine block's ``apply`` stamps the same fields."""
    class EngineConfig:
        pass

    cfg = ns.S.ServingConfig(
        prefix_cache={"enabled": True, "max_cached_blocks": 4},
        kv_quant={"enabled": True}, weight_quant={"enabled": True},
        kv_tier={"enabled": True, "disk_path": "/x", "disk_max_bytes": 8},
        admission={"reservation": True, "oversubscription_factor": 1.5})
    out = EngineConfig()
    for block in (cfg.prefix_cache, cfg.kv_quant, cfg.weight_quant,
                  cfg.kv_tier, cfg.admission):
        block.apply(out)
    return sorted(vars(out).items())


# ------------------------------------------------- launch counts, threads
def _bump_in_threads(fn, threads=4, each=4000):
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)             # switch threads as often as
    try:                                    # the interpreter allows
        ts = [threading.Thread(target=lambda: [fn() for _ in range(each)])
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        sys.setswitchinterval(prev)
    return threads * each


def test_launch_counters_exact_under_threads():
    """Each wrapper's count moves only through its locked helper, so
    launches made by replica threads at once all count."""
    pa.launches = 0
    want = _bump_in_threads(pa._count_launch)
    assert pa.launches == want
    for mod, keys in ((fa, fa.launches), (qz, qz.launches)):
        for key in list(keys):
            mod.launches[key] = 0
            want = _bump_in_threads(lambda: mod._count_launch(key),
                                    threads=2, each=2000)
            assert mod.launches[key] == want, key
            mod.launches[key] = 0
    pa.launches = 0


def test_plain_paths_in_threads_count_no_launch():
    """Two threads on the plain (CPU) paths at once: outputs equal one
    thread's, and no launch is counted (only a kernel launch counts)."""
    pa.launches = 0
    for k in qz.launches:
        qz.launches[k] = 0
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, generator=g)
    w = torch.randn(64, 32, generator=g)
    q, s = qz.quantize_blockwise(w, block=32)
    want = qz.quantized_matmul(x, q, s, block=32)
    outs = []

    def run():
        for _ in range(20):
            outs.append(qz.quantized_matmul(x, q, s, block=32))

    ts = [threading.Thread(target=run) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(outs) == 40
    assert all(torch.equal(o, want) for o in outs)
    assert pa.launches == 0 and all(v == 0 for v in qz.launches.values())


# ----------------------------------------------------------- import hygiene
def test_serving_modules_import_no_jax_no_pydantic():
    """The serving stack (tenancy, affinity and the autoscaler included),
    telemetry and the concurrency lint import neither jax nor pydantic nor
    the JAX package, and a frontend over a CPU engine serves with no
    CUDA."""
    import subprocess
    from pathlib import Path

    code = (
        "import sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import deepspeed_tpu_torch.serving as S\n"
        "import deepspeed_tpu_torch.serving.frontend\n"
        "import deepspeed_tpu_torch.serving.supervisor\n"
        "import deepspeed_tpu_torch.telemetry.fleet\n"
        "import deepspeed_tpu_torch.utils.restart\n"
        "import deepspeed_tpu_torch.serving.tenancy\n"
        "import deepspeed_tpu_torch.serving.affinity\n"
        "import deepspeed_tpu_torch.serving.autoscaler\n"
        "import deepspeed_tpu_torch.analysis.__main__\n"
        "from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,\n"
        "    RaggedInferenceEngineConfig)\n"
        "from deepspeed_tpu_torch.models.transformer import (CausalLM,\n"
        "    TransformerConfig)\n"
        "cfg = TransformerConfig(vocab_size=64, hidden_size=32,\n"
        "    intermediate_size=64, num_layers=1, num_heads=2, max_seq_len=64)\n"
        "eng = InferenceEngineV2(CausalLM(cfg), config=\n"
        "    RaggedInferenceEngineConfig(kv_blocks=16, kv_block_size=8),\n"
        "    device='cpu')\n"
        "fe = S.ServingFrontend([eng], S.ServingConfig(telemetry={\n"
        "    'enabled': True}, fault_tolerance={'enabled': True}))\n"
        "h = fe.submit([1, 2, 3], max_new_tokens=3)\n"
        "assert fe.wait_all([h], timeout=60)\n"
        "assert len(list(h.drain())) == 3\n"
        "fe.shutdown()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pydantic', 'deepspeed_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert 'deepspeed_tpu_torch.ops._build' not in sys.modules\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(Path(__file__).resolve()
                                            .parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "clean"
