"""Port parity: ``deepspeed_tpu_torch``'s ``ServingFrontend`` over tiny CPU
engines, against the JAX package's greedy streams.

The model of ``tests/test_serving_load.py`` (vocab 128, hidden 64, 2
layers, blocks of 8) with the JAX ``init(PRNGKey(0))`` weights x3, handed
to the port through ``params_from_numpy``. Every completed stream,
failed-over ones included, must equal the JAX engine's greedy stream for
its prompt byte for byte (one module-scoped JAX engine computes them once).
Shed, completed, expired, cancelled and failed counts add up to submitted,
and after ``shutdown`` every block of every replica is free.

The cases mirror ``tests/test_serving_load.py`` (13), the end-to-end cases
of ``tests/test_fault_tolerance.py`` (crash, wedge, put error, circuit
breaker, retry bound, all parked, brownout wiring), the frontend cases of
``tests/test_telemetry.py:427-589``, ``tests/test_kv_tier.py`` (:334,
:641, :672, :711, :752, :763), ``tests/test_preemption.py`` and
``tests/test_spec_decode.py``; plus dynamic membership with evacuation,
the ``ServingConfig`` mounts of the prefix cache, KV quant and weight
quant, one JAX-written universal checkpoint served through both packages'
``engine_from_model_spec``, the device rule, and the raise of every block
whose feature the port does not run yet.
"""

import json
import os
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.serving as jserving
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.testing import \
    greedy_generate as j_greedy_generate
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.runtime.checkpointing import _save_tree
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.spec import (DraftModelProposer,
                                                   NGramProposer)
from deepspeed_tpu_torch.inference.v2.testing import (assert_greedy_parity,
                                                      greedy_generate)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
from deepspeed_tpu_torch.serving import (FinishReason, KVTierConfig,
                                         Priority, Rejected, Replica,
                                         ReplicaState, RequestState,
                                         ServingConfig, ServingFrontend,
                                         SpeculativeConfig)
from deepspeed_tpu_torch.serving.frontend import engine_from_model_spec
from deepspeed_tpu_torch.telemetry import (OpsJournal, trace_coverage,
                                           validate_chrome_trace,
                                           validate_events)

VOCAB = 128
BS = 8
ORACLE_NEW = 16          # tokens the JAX reference generates per prompt


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny CPU ops run on one thread here: beside other test
    workers, torch's default of a thread per core oversubscribes the
    machine and every small op waits on the others."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(mod, **kw):
    return mod.TransformerConfig(vocab_size=VOCAB, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=2, max_seq_len=128, norm="rmsnorm",
                                 activation="silu", position="rope", **kw)


@pytest.fixture(scope="module")
def weights1():
    """The JAX ``init(PRNGKey(0))`` weights as they are: greedy decoding of
    a repeated motif settles into the loop, so n-gram drafts are
    accepted."""
    jp = jtf.CausalLM(_cfg(jtf)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def weights(weights1):
    """x3: streams vary from prompt to prompt."""
    return jax.tree.map(lambda a: a * (3 if a.ndim >= 2 else 1), weights1)


@pytest.fixture(scope="module")
def params(weights):
    return params_from_numpy(weights, device="cpu")


@pytest.fixture(scope="module")
def params1(weights1):
    return params_from_numpy(weights1, device="cpu")


class Oracle:
    """The JAX engine's greedy streams, ``ORACLE_NEW`` tokens a prompt,
    computed once per prompt (batched) and cut to each request's budget."""

    def __init__(self, weights):
        self.engine = JEngine(
            jtf.CausalLM(_cfg(jtf)), params=weights,
            config=JConfig(max_ragged_batch_size=256,
                           max_ragged_sequence_count=16,
                           max_chunk_tokens=32, kv_blocks=512,
                           kv_block_size=BS, max_tracked_sequences=64))
        self.cache = {}
        self.uid = 0

    def __call__(self, prompts, n):
        assert n <= ORACLE_NEW
        todo = list({tuple(p) for p in prompts} - set(self.cache))
        if todo:
            out = j_greedy_generate(self.engine, [list(p) for p in todo],
                                    uid_base=self.uid,
                                    max_new_tokens=ORACLE_NEW,
                                    sequential=False)
            self.uid += len(todo)
            self.cache.update(zip(todo, out))
        return [self.cache[tuple(p)][:n] for p in prompts]


@pytest.fixture(scope="module")
def oracle(weights):
    return Oracle(weights)


@pytest.fixture(scope="module")
def oracle1(weights1):
    return Oracle(weights1)


def tiny_engine(params, kv_blocks=64, max_seqs=4, prefix=False, **kw):
    vcfg = RaggedInferenceEngineConfig(
        max_ragged_batch_size=128, max_ragged_sequence_count=max_seqs,
        max_chunk_tokens=32, kv_blocks=kv_blocks, kv_block_size=BS,
        max_tracked_sequences=64, enable_prefix_cache=prefix, **kw)
    return InferenceEngineV2(ttf.CausalLM(_cfg(ttf)), params=params,
                             config=vcfg, device="cpu")


def prompts(n, seed, lo=8, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(k)).tolist()
            for k in rng.integers(lo, hi, size=n)]


def tokens(handles):
    return [[ev.token for ev in h.drain()] for h in handles]


def ft_config(**over):
    """Fast-recovery fault-tolerance block (the JAX tests' settings)."""
    ft = {"enabled": True, "max_retries": 3, "restart_backoff_s": 0.05,
          "restart_backoff_max_s": 0.2, "supervisor_poll_s": 0.02,
          "restart_window_s": 60.0, "max_restarts_in_window": 5}
    ft.update(over)
    return ft


def wait_metric(fe, name, value, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fe.metrics_snapshot().get(name, 0) >= value:
            return True
        time.sleep(0.02)
    return False


def wait_free(engine, timeout=10.0):
    deadline = time.monotonic() + timeout
    while engine.free_blocks != engine.config.kv_blocks \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    return engine.free_blocks == engine.config.kv_blocks


def balanced(snap):
    """Every submitted request ended one way: the counts add up."""
    ends = sum(snap.get(k, 0.0) for k in (
        "requests_completed", "requests_shed", "requests_expired",
        "requests_cancelled", "requests_failed"))
    return ends == snap["requests_submitted"]


def shut(fe):
    """Shut down and check that every replica's pool is whole again (the
    prefix cache's own references aside)."""
    fe.shutdown(drain=False, timeout=5)
    for rep in fe.router.replicas:
        occ = rep.engine.occupancy()
        assert occ["available_blocks"] == occ["total_blocks"], occ


@pytest.fixture
def frontend(params):
    fe = ServingFrontend([tiny_engine(params)],
                         ServingConfig(max_queue_depth=8))
    yield fe
    shut(fe)


# ----------------------------------------------------------- serving load
def test_requests_complete_and_stream(frontend, oracle):
    ps = prompts(3, 0)
    handles = [frontend.submit(p, max_new_tokens=6) for p in ps]
    assert frontend.wait_all(handles, timeout=120)
    assert all(h.state == RequestState.FINISHED for h in handles)
    assert all(h.finish_reason == "length" for h in handles)
    assert_greedy_parity(oracle(ps, 6), tokens(handles), "frontend")


def test_streaming_iterator_terminates(frontend, oracle):
    p = prompts(1, 1)[0]
    h = frontend.submit(p, max_new_tokens=5)
    evs = list(h.stream(timeout=120))
    assert [ev.index for ev in evs] == list(range(5))
    assert [ev.token for ev in evs] == oracle([p], 5)[0]
    assert h.state == RequestState.FINISHED


def test_overcapacity_burst_sheds_and_admitted_complete(frontend, oracle):
    ps = prompts(40, 2)
    handles, admitted, rejected = [], [], 0
    for p in ps:
        try:
            handles.append(frontend.submit(p, max_new_tokens=4))
            admitted.append(p)
        except Rejected as e:
            assert e.reason == "overloaded"
            rejected += 1
    assert rejected > 0
    assert len(frontend.admission) <= frontend.config.max_queue_depth
    assert frontend.wait_all(handles, timeout=300)
    snap = frontend.metrics_snapshot()
    assert snap["requests_shed"] == rejected
    assert snap["requests_completed"] == len(handles)
    assert snap["shed_rate"] == pytest.approx(rejected / 40)
    assert snap["ttft_s"]["count"] == len(handles)
    assert snap["ttft_s"]["p95"] >= snap["ttft_s"]["p50"] > 0
    assert snap["queue_wait_s"]["count"] >= len(handles)
    assert balanced(snap)
    assert_greedy_parity(oracle(admitted, 4), tokens(handles), "burst")


def test_mixed_priorities_order_under_backlog(params, oracle):
    fe = ServingFrontend([tiny_engine(params)],
                         ServingConfig(max_queue_depth=32))
    try:
        ps = prompts(11, 3)
        lows = [fe.submit(p, max_new_tokens=8, priority=Priority.LOW)
                for p in ps[:8]]
        highs = [fe.submit(p, max_new_tokens=8, priority=Priority.HIGH)
                 for p in ps[8:]]
        assert fe.wait_all(lows + highs, timeout=300)
        first_high = min(h._req.first_token_t for h in highs)
        last_low = max(h._req.first_token_t for h in lows)
        assert first_high < last_low
        assert_greedy_parity(oracle(ps, 8), tokens(lows + highs),
                             "priorities")
    finally:
        shut(fe)


def test_cancel_frees_kv_blocks(frontend):
    engine = frontend.router.replicas[0].engine
    free0 = engine.free_blocks
    h = frontend.submit(prompts(1, 4, lo=30, hi=32)[0], max_new_tokens=90)
    deadline = time.monotonic() + 60
    while engine.free_blocks == free0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert engine.free_blocks < free0
    h.cancel()
    assert h._req.wait(60)
    assert h.state == RequestState.CANCELLED
    assert h.finish_reason == "cancelled"
    assert wait_free(engine)
    assert frontend.metrics_snapshot()["requests_cancelled"] == 1


def test_deadline_expiry_accounting(frontend):
    h = frontend.submit(prompts(1, 5, lo=30, hi=32)[0], max_new_tokens=90,
                        deadline_ms=120.0)
    assert h._req.wait(60)
    assert h.state == RequestState.EXPIRED
    assert h.finish_reason == "deadline"
    snap = frontend.metrics_snapshot()
    assert snap["requests_expired"] == 1 and balanced(snap)
    assert wait_free(frontend.router.replicas[0].engine)


def test_two_replicas_share_load(params, oracle):
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)],
                         ServingConfig(max_queue_depth=32))
    try:
        ps = prompts(8, 6)
        handles = [fe.submit(p, max_new_tokens=4) for p in ps]
        assert fe.wait_all(handles, timeout=300)
        assert {h._req.replica_id for h in handles} == {0, 1}
        assert_greedy_parity(oracle(ps, 4), tokens(handles), "2 replicas")
    finally:
        shut(fe)


def test_dead_replica_degrades_not_fails(params, oracle):
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)],
                         ServingConfig(max_queue_depth=32))
    try:
        fe.router.replicas[0].state = ReplicaState.DEAD
        ps = prompts(4, 7)
        handles = [fe.submit(p, max_new_tokens=3) for p in ps]
        assert fe.wait_all(handles, timeout=300)
        assert all(h.state == RequestState.FINISHED for h in handles)
        assert all(h._req.replica_id == 1 for h in handles)
        assert fe.metrics_snapshot()["replicas_healthy"] == 1
        assert_greedy_parity(oracle(ps, 3), tokens(handles), "survivor")
    finally:
        shut(fe)


def test_shutdown_drain_completes_inflight(params, oracle):
    fe = ServingFrontend([tiny_engine(params)],
                         ServingConfig(max_queue_depth=8))
    ps = prompts(2, 8)
    handles = [fe.submit(p, max_new_tokens=3) for p in ps]
    fe.shutdown(drain=True, timeout=120)
    assert all(h.state == RequestState.FINISHED for h in handles)
    assert_greedy_parity(oracle(ps, 3), tokens(handles), "drain")
    with pytest.raises(Rejected) as ei:
        fe.submit(ps[0])
    assert ei.value.reason == "draining"
    assert wait_free(fe.router.replicas[0].engine)


def test_bench_frontend_metrics_shape(params):
    fe = ServingFrontend([tiny_engine(params)],
                         ServingConfig(max_queue_depth=4))
    try:
        handles = []
        for p in prompts(10, 9):
            try:
                handles.append(fe.submit(p, max_new_tokens=2))
            except Rejected:
                pass
        assert fe.wait_all(handles, timeout=300)
        snap = fe.metrics_snapshot()
        for key in ("requests_submitted", "requests_completed",
                    "requests_shed", "tokens_generated", "shed_rate"):
            assert key in snap
        assert {"p50", "p95", "count"} <= set(snap["ttft_s"])
        assert balanced(snap)
    finally:
        shut(fe)


def test_cancel_queued_request_frees_depth_slot(params):
    fe = ServingFrontend([tiny_engine(params)],
                         ServingConfig(max_queue_depth=8))
    try:
        busy = [fe.submit(p, max_new_tokens=40)
                for p in prompts(4, 10, lo=24, hi=32)]
        deadline = time.monotonic() + 30
        while len(fe.admission) and time.monotonic() < deadline:
            time.sleep(0.005)
        queued = [fe.submit(p, max_new_tokens=2) for p in prompts(2, 11)]
        depth = len(fe.admission)
        assert depth >= 1
        victim = queued[0]
        victim.cancel()
        assert victim._req.wait(1.0)
        assert victim.state == RequestState.CANCELLED
        assert len(fe.admission) == depth - 1
        assert fe.wait_all(busy + queued[1:], timeout=300)
    finally:
        shut(fe)


def test_forced_shutdown_terminates_inflight(params):
    fe = ServingFrontend([tiny_engine(params)],
                         ServingConfig(max_queue_depth=8))
    handles = [fe.submit(p, max_new_tokens=60)
               for p in prompts(6, 12, lo=24, hi=32)]
    shut(fe)
    assert fe.wait_all(handles, timeout=30)
    assert all(h.state not in (RequestState.QUEUED, RequestState.RUNNING)
               for h in handles)
    assert balanced(fe.metrics_snapshot())


def test_from_engine_factory_and_default_priority(params, oracle):
    fe = ServingFrontend.from_engine_factory(
        lambda i: tiny_engine(params),
        ServingConfig(num_replicas=2, default_priority=Priority.HIGH,
                      max_queue_depth=8))
    try:
        assert len(fe.router.replicas) == 2
        p = prompts(1, 13)[0]
        h = fe.submit(p, max_new_tokens=2)
        assert h._req.priority == Priority.HIGH
        assert fe.wait_all([h], timeout=120)
        assert tokens([h]) == oracle([p], 2)
    finally:
        shut(fe)


# -------------------------------------------------------- fault tolerance
def test_crash_failover_resumes_stream_losslessly(params, oracle):
    ps = prompts(3, 21)
    scfg = ServingConfig(
        max_queue_depth=32, fault_tolerance=ft_config(),
        faults={"enabled": True, "schedule": [
            {"kind": "crash", "replica": 0, "at_step": 3}]})
    fe = ServingFrontend([tiny_engine(params)], scfg,
                         engine_factory=lambda i: tiny_engine(params))
    try:
        hs = [fe.submit(p, max_new_tokens=6) for p in ps]
        assert fe.wait_all(hs, timeout=300)
        assert all(h.state == RequestState.FINISHED for h in hs)
        got = []
        for h in hs:
            evs = list(h.drain())
            assert [ev.index for ev in evs] == list(range(len(evs)))
            got.append([ev.token for ev in evs])
        assert_greedy_parity(oracle(ps, 6), got, "failover")
        assert any(h.attempts > 1 for h in hs)
        snap = fe.metrics_snapshot()
        assert snap["requests_failed_over"] >= 1
        assert snap["replica_restarts"] == 1
        assert snap["requests_failed"] == 0 and balanced(snap)
        assert fe.supervisor.restart_log[0]["recovery_s"] > 0
        fired = fe.injector.fired_events()
        assert [(k, r, i) for k, r, i, _ in fired] == [("crash", 0, 3)]
    finally:
        shut(fe)


def test_chaos_kill_one_of_two_replicas_mid_burst(params, oracle, tmp_path):
    ps = prompts(8, 22)
    scfg = ServingConfig(
        max_queue_depth=32, fault_tolerance=ft_config(),
        telemetry={"enabled": True, "dump_dir": str(tmp_path)},
        faults={"enabled": True, "schedule": [
            {"kind": "crash", "replica": 0, "at_step": 3}]})
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)], scfg,
                         engine_factory=lambda i: tiny_engine(params))
    try:
        hs = [fe.submit(p, max_new_tokens=6) for p in ps]
        assert fe.wait_all(hs, timeout=300)
        assert all(h.state == RequestState.FINISHED for h in hs)
        assert_greedy_parity(oracle(ps, 6), tokens(hs), "chaos")
        snap = fe.metrics_snapshot()
        assert snap["replica_restarts"] >= 1
        assert snap["requests_failed"] == 0
        assert snap["replicas_parked"] == 0
        dumps = list(tmp_path.glob("flightrec_*.json"))
        assert any("restart" in p.name or "error" in p.name for p in dumps)
        assert validate_events(fe.journal.events()) == []
    finally:
        shut(fe)


def test_put_error_injection_takes_engine_fault_path(params, oracle):
    ps = prompts(2, 23)
    scfg = ServingConfig(
        max_queue_depth=16, fault_tolerance=ft_config(),
        faults={"enabled": True, "schedule": [
            {"kind": "put_error", "replica": 0, "at_put": 2}]})
    fe = ServingFrontend([tiny_engine(params)], scfg,
                         engine_factory=lambda i: tiny_engine(params))
    try:
        hs = [fe.submit(p, max_new_tokens=4) for p in ps]
        assert fe.wait_all(hs, timeout=300)
        assert_greedy_parity(oracle(ps, 4), tokens(hs), "put error")
        assert fe.metrics_snapshot()["replica_restarts"] == 1
    finally:
        shut(fe)


def test_circuit_breaker_parks_repeatedly_crashing_replica(params):
    scfg = ServingConfig(
        max_queue_depth=32,
        fault_tolerance=ft_config(max_restarts_in_window=2, max_retries=5),
        faults={"enabled": True, "schedule": [
            {"kind": "crash", "replica": 0, "at_step": 0, "count": 0}]})
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)], scfg,
                         engine_factory=lambda i: tiny_engine(params))
    try:
        hs = [fe.submit(p, max_new_tokens=4) for p in prompts(4, 24)]
        assert fe.wait_all(hs, timeout=300)
        assert all(h.state == RequestState.FINISHED for h in hs)
        assert wait_metric(fe, "replica_restarts", 1)
        late = [fe.submit(p, max_new_tokens=4) for p in prompts(4, 25)]
        assert fe.wait_all(late, timeout=300)
        assert all(h.state == RequestState.FINISHED for h in late)
        assert wait_metric(fe, "replicas_parked", 1)
        snap = fe.metrics_snapshot()
        assert snap["capacity_alarm"] == 1.0
        assert snap["replica_restarts"] == 1
        tail = [fe.submit(p, max_new_tokens=4) for p in prompts(3, 26)]
        assert fe.wait_all(tail, timeout=300)
        assert all(h.state == RequestState.FINISHED for h in tail)
        assert all(h._req.replica_id == 1 for h in tail)
    finally:
        fe.shutdown(drain=False, timeout=5)


def test_failover_bounded_by_max_retries(params):
    scfg = ServingConfig(
        max_queue_depth=16,
        fault_tolerance=ft_config(max_retries=1, max_restarts_in_window=10),
        faults={"enabled": True, "schedule": [
            {"kind": "crash", "replica": 0, "at_step": 0, "count": 0}]})
    fe = ServingFrontend([tiny_engine(params)], scfg,
                         engine_factory=lambda i: tiny_engine(params))
    try:
        h = fe.submit(prompts(1, 27)[0], max_new_tokens=4)
        assert h._req.wait(120)
        assert h.state == RequestState.FAILED
        assert h.finish_reason == FinishReason.ERROR
        assert h.attempts == 2
        assert fe.metrics_snapshot()["requests_failed_over"] == 1
    finally:
        fe.shutdown(drain=False, timeout=5)


def test_all_parked_fails_queued_and_new_requests_fast(params):
    scfg = ServingConfig(
        max_queue_depth=16,
        fault_tolerance=ft_config(max_restarts_in_window=1, max_retries=5),
        faults={"enabled": True, "schedule": [
            {"kind": "crash", "replica": 0, "at_step": 0, "count": 0}]})
    fe = ServingFrontend([tiny_engine(params)], scfg,
                         engine_factory=lambda i: tiny_engine(params))
    try:
        hs = [fe.submit(p, max_new_tokens=4) for p in prompts(3, 28)]
        assert fe.wait_all(hs, timeout=120)
        assert all(h.state == RequestState.FAILED for h in hs)
        assert all(h.finish_reason == FinishReason.NO_REPLICAS for h in hs)
        assert wait_metric(fe, "replicas_parked", 1)
        h = fe.submit(prompts(1, 29)[0], max_new_tokens=4)
        assert h._req.wait(60)
        assert h.finish_reason == FinishReason.NO_REPLICAS
    finally:
        fe.shutdown(drain=False, timeout=5)


def test_wedge_recovers_on_fresh_engine(params, oracle):
    ps = prompts(2, 30)
    scfg = ServingConfig(
        max_queue_depth=16, wedge_timeout_s=2.5,
        fault_tolerance=ft_config(),
        faults={"enabled": True, "schedule": [
            {"kind": "wedge", "replica": 0, "at_step": 1,
             "duration_s": 6.0}]})
    fe = ServingFrontend([tiny_engine(params)], scfg,
                         engine_factory=lambda i: tiny_engine(params))
    try:
        hs = [fe.submit(p, max_new_tokens=4) for p in ps]
        assert fe.wait_all(hs, timeout=300)
        assert all(h.state == RequestState.FINISHED for h in hs)
        assert_greedy_parity(oracle(ps, 4), tokens(hs), "wedge")
        assert fe.metrics_snapshot()["replica_restarts"] >= 1
    finally:
        fe.shutdown(drain=False, timeout=1)


def test_wedge_without_engine_factory_parks_slot(params):
    scfg = ServingConfig(
        max_queue_depth=16, wedge_timeout_s=0.2,
        fault_tolerance=ft_config(max_retries=1),
        faults={"enabled": True, "schedule": [
            {"kind": "wedge", "replica": 0, "at_step": 1,
             "duration_s": 8.0}]})
    fe = ServingFrontend([tiny_engine(params)], scfg)
    try:
        h = fe.submit(prompts(1, 31)[0], max_new_tokens=4)
        assert h._req.wait(120)
        assert h.state == RequestState.FAILED
        assert wait_metric(fe, "replicas_parked", 1, timeout=30)
        assert fe.metrics_snapshot()["replica_restarts"] == 0
    finally:
        fe.shutdown(drain=False, timeout=1)


def test_faults_disabled_is_byte_identical_and_unhooked(params, oracle):
    eng = tiny_engine(params)
    fe = ServingFrontend([eng], ServingConfig(max_queue_depth=16))
    try:
        assert fe.injector is None and fe.supervisor is None
        assert fe.router.replicas[0].engine is eng
        assert fe.router.replicas[0]._on_failover is None
        ps = prompts(2, 32)
        hs = [fe.submit(p, max_new_tokens=4) for p in ps]
        assert fe.wait_all(hs, timeout=300)
        assert_greedy_parity(oracle(ps, 4), tokens(hs), "no faults")
    finally:
        shut(fe)


def test_brownout_wired_from_fault_tolerance_config(params):
    fe = ServingFrontend([tiny_engine(params)], ServingConfig(
        max_queue_depth=8, fault_tolerance=ft_config(brownout_threshold=0.5)))
    try:
        assert fe.admission.brownout_threshold == 0.5
    finally:
        shut(fe)
    fe2 = ServingFrontend([tiny_engine(params)], ServingConfig(
        max_queue_depth=8,
        fault_tolerance={"enabled": False, "brownout_threshold": 0.5}))
    try:
        assert fe2.admission.brownout_threshold == 0.0
    finally:
        shut(fe2)


# ------------------------------------------------------ dynamic membership
def test_remove_replica_evacuates_and_add_replica_serves(params, oracle):
    """Removing a replica hands its resident requests back with their KV
    staged (or re-prefilled); they finish elsewhere with the same streams.
    A grown replica gets a fresh id and serves."""
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)],
                         ServingConfig(max_queue_depth=32),
                         engine_factory=lambda i: tiny_engine(params))
    try:
        ps = prompts(6, 33)
        hs = [fe.submit(p, max_new_tokens=12) for p in ps]
        deadline = time.monotonic() + 30
        while not any(h._req.replica_id == 0 and h._req.generated_tokens
                      for h in hs) and time.monotonic() < deadline:
            time.sleep(0.002)
        assert fe.remove_replica(0)
        assert [r.replica_id for r in fe.router.replicas] == [1]
        with pytest.raises(ValueError, match="last replica"):
            fe.remove_replica(1)
        assert fe.wait_all(hs, timeout=300)
        assert_greedy_parity(oracle(ps, 12), tokens(hs), "evacuation")
        snap = fe.metrics_snapshot()
        assert snap["requests_evacuated"] >= 1 and balanced(snap)
        rid = fe.add_replica()
        assert rid == 2
        with pytest.raises(ValueError, match="disaggregation"):
            fe.add_replica(role="prefill")
        fe.router.replicas[0].drain()
        p = prompts(1, 34)[0]
        h = fe.submit(p, max_new_tokens=3)
        assert fe.wait_all([h], timeout=120)
        assert h._req.replica_id == 2
        assert tokens([h]) == oracle([p], 3)
    finally:
        shut(fe)


# --------------------------------------------------------------- telemetry
def _stage_spans(spans, trace_id):
    return {s["name"]: s for s in spans if s["trace_id"] == trace_id}


def test_e2e_request_span_chain(params1, oracle1):
    eng = tiny_engine(params1, prefix=True)
    fe = ServingFrontend([eng], ServingConfig(
        max_queue_depth=8,
        speculative={"enabled": True, "mode": "ngram", "ngram_max": 3,
                     "max_draft_tokens": 3},
        telemetry={"enabled": True}))
    try:
        rng = np.random.default_rng(0)
        prompt = rng.integers(0, VOCAB, size=8).tolist() * 4
        h1 = fe.submit(prompt, max_new_tokens=6)
        assert fe.wait_all([h1], timeout=120)
        h2 = fe.submit(prompt, max_new_tokens=6)
        assert fe.wait_all([h2], timeout=120)
        spans = fe.tracer.export()
        order = ["queue", "route", "admit", "prefill", "decode"]
        for h in (h1, h2):
            req = h._req
            chain = _stage_spans(spans, req.trace_id)
            assert {"request", *order} <= set(chain)
            for a, b in zip(order, order[1:]):
                assert chain[a]["t_start"] <= chain[b]["t_start"] + 1e-9
                assert chain[a]["t_end"] <= chain[b]["t_end"] + 1e-9
            root = chain["request"]
            assert root["attrs"]["state"] == "finished"
            assert root["attrs"]["finish_reason"] == "length"
            assert root["attrs"]["generated"] == 6
            cov = trace_coverage([chain[n] for n in order[:-1]],
                                 req.arrival_t, req.first_token_t)
            assert cov >= 0.95
            assert chain["decode"]["attrs"].get("spec_proposed", 0) > 0
        c1 = _stage_spans(spans, h1._req.trace_id)["prefill"]["attrs"]
        c2 = _stage_spans(spans, h2._req.trace_id)["prefill"]["attrs"]
        assert c1["prefix_matched_tokens"] == 0
        assert c2["prefix_matched_tokens"] > 0
        fwd = [s for s in spans if s["trace_id"] == "replica-0"
               and s["name"] == "forward"]
        assert fwd and all(s["attrs"]["n_seqs"] >= 1 for s in fwd)
        assert any(s["name"] == "spec_verify" for s in spans
                   if s["trace_id"] == "replica-0")
        assert tokens([h1, h2]) == oracle1([prompt, prompt], 6)
    finally:
        shut(fe)


def test_serving_telemetry_off_records_nothing(frontend):
    h = frontend.submit(prompts(1, 40)[0], max_new_tokens=3)
    assert frontend.wait_all([h], timeout=120)
    assert not frontend.tracer.enabled
    assert frontend.tracer.export() == []
    assert h._req.spans is None and h._req.trace_id is None


def test_frontend_debug_dump_and_prometheus(params, tmp_path):
    fe = ServingFrontend([tiny_engine(params)], ServingConfig(
        max_queue_depth=8,
        telemetry={"enabled": True, "dump_dir": str(tmp_path)},
        slo={"enabled": True, "classes": {
            "interactive": {"ttft_p95_ms": 250.0}}}))
    try:
        h = fe.submit(prompts(1, 41)[0], max_new_tokens=3)
        assert fe.wait_all([h], timeout=120)
        paths = fe.debug_dump()
        record = json.load(open(paths["json"]))
        assert record["reason"] == "debug"
        assert any(s["name"] == "request" for s in record["spans"])
        snap = record["metric_snapshots"][-1]["serving"]
        assert snap["requests_completed"] == 1
        assert validate_chrome_trace(
            json.load(open(paths["chrome_trace"]))) == []
        lines = fe.render_prometheus().splitlines()
        assert "serving_requests_completed 1" in lines
        assert 'serving_ttft_s_bucket{le="+Inf"} 1' in lines
        rep = fe.health_report()
        assert rep["counters"]["requests_completed"] == 1
        assert set(rep["slo"]) == {"slo_ttft_interactive"}
        assert rep["remotes"] == [] and rep["federation"] is None
        text = fe.health_report_text()
        assert "== serving health ==" in text and "completed=1" in text
    finally:
        shut(fe)


def test_replica_error_writes_flight_record(params, tmp_path):
    eng = tiny_engine(params)
    fe = ServingFrontend([eng], ServingConfig(
        max_queue_depth=8,
        telemetry={"enabled": True, "dump_dir": str(tmp_path)}))
    try:
        def boom(*a, **k):
            raise RuntimeError("engine exploded")

        eng.put = boom
        h = fe.submit(prompts(1, 42)[0], max_new_tokens=3)
        assert h._req.wait(60)
        assert h._req.state.value == "failed"
        deadline = time.monotonic() + 30
        dumps = []
        while not dumps and time.monotonic() < deadline:
            dumps = list(tmp_path.glob("flightrec_*_error_replica-0_*.json"))
            time.sleep(0.02)
        assert dumps
        record = json.load(open(dumps[0]))
        assert record["reason"] == "error_replica-0"
        assert any(s["trace_id"] == h._req.trace_id for s in record["spans"])
    finally:
        fe.shutdown(drain=False, timeout=5)


def test_observability_endpoint_serves_metrics_and_health(params):
    import urllib.request

    fe = ServingFrontend([tiny_engine(params)], ServingConfig(
        max_queue_depth=8, observability={"enabled": True}))
    try:
        h = fe.submit(prompts(1, 43)[0], max_new_tokens=2)
        assert fe.wait_all([h], timeout=120)
        base = f"http://{fe.observability_address}"
        text = urllib.request.urlopen(base + "/metrics", timeout=10).read()
        assert b"serving_requests_completed 1" in text
        health = json.loads(urllib.request.urlopen(base + "/health",
                                                   timeout=10).read())
        assert health["counters"]["requests_completed"] == 1
        assert fe.journal.count("obs_listen") == 1
    finally:
        shut(fe)


# ----------------------------------------------------------------- KV tier
def shared_prefix_reqs(rng, k_prompts=4, n_req=12, sys_len=32, tail=6):
    sys_prompts = [rng.integers(0, VOCAB, size=sys_len).tolist()
                   for _ in range(k_prompts)]
    return [sys_prompts[i % k_prompts]
            + rng.integers(0, VOCAB, size=tail).tolist()
            for i in range(n_req)]


def tier_config(**kv_tier):
    return ServingConfig(max_queue_depth=64, prefix_cache={"enabled": True},
                         kv_tier=(kv_tier or {"enabled": True}),
                         admission={"reservation": True})


def test_tier_pressure_baseline_survives_transient_stats_failure():
    class Eng:
        def __init__(self):
            self.s = {"spilled": 0, "restored": 0, "dropped": 0,
                      "host_bytes": 0}
            self.fail = False

        def tier_stats(self):
            if self.fail:
                raise RuntimeError("transient")
            return dict(self.s)

    e1, e2 = Eng(), Eng()
    fe = SimpleNamespace(
        router=SimpleNamespace(replicas=[
            SimpleNamespace(replica_id=0, engine=e1),
            SimpleNamespace(replica_id=1, engine=e2)]),
        journal=OpsJournal(source="serving"),
        _tier_last={}, _tier_journal_t=-10.0)
    tick = ServingFrontend._maybe_journal_tier_pressure
    e1.s["spilled"] = 10
    tick(fe)
    fe._tier_journal_t = -10.0
    e1.fail = True
    e2.s["spilled"] = 5
    tick(fe)
    fe._tier_journal_t = -10.0
    e1.fail = False
    tick(fe)
    evs = fe.journal.events(kinds=("kv_tier_pressure",))
    assert [e["detail"]["spilled"] for e in evs] == [10, 5]


def test_frontend_applies_tier_and_publishes_metrics(params, oracle):
    rng = np.random.default_rng(16)
    reqs = shared_prefix_reqs(rng)
    eng = tiny_engine(params, kv_blocks=14)
    fe = ServingFrontend([eng], tier_config())
    try:
        assert eng.state_manager.kv_tier_enabled
        handles = [fe.submit(p, max_new_tokens=4) for p in reqs]
        assert fe.wait_all(handles, timeout=120)
        snap = fe.metrics_snapshot()
        assert snap["kv_tier_blocks_spilled"] > 0
        assert snap["kv_tier_blocks_restored"] > 0
        assert snap["kv_blocks_host_tier"] > 0
        assert snap["kv_tier_bytes_host"] > 0
        assert snap["kv_tier_restore_s"]["count"] > 0
        fe._tier_journal_t = -10.0
        fe._maybe_journal_tier_pressure()
        ev = fe.journal.events(kinds=("kv_tier_pressure",))[-1]
        assert ev["detail"]["spilled"] > 0
        rep = fe.health_report(window_s=60.0)
        assert rep["occupancy"]["kv_blocks_host_tier"] > 0
        assert "kv_tier_restore_s" in rep["window"]
        assert_greedy_parity(oracle(reqs, 4), tokens(handles), "kv tier")
    finally:
        shut(fe)


def test_restore_races_cancel_and_deadline(params):
    rng = np.random.default_rng(17)
    reqs = shared_prefix_reqs(rng, n_req=10)
    eng = tiny_engine(params, kv_blocks=24)
    fe = ServingFrontend([eng], tier_config())
    try:
        warm = [fe.submit(p, max_new_tokens=3) for p in reqs]
        assert fe.wait_all(warm, timeout=120)
        handles = []
        for i, p in enumerate(reqs):
            h = fe.submit(p, max_new_tokens=40,
                          deadline_ms=1.0 if i % 3 == 2 else None)
            handles.append(h)
            if i % 3 == 0:
                fe.cancel(h)
        assert fe.wait_all(handles, timeout=120)
        assert balanced(fe.metrics_snapshot())
    finally:
        shut(fe)


def test_restore_survives_replica_death(params, oracle):
    rng = np.random.default_rng(18)
    reqs = shared_prefix_reqs(rng, n_req=8)

    def factory(i):
        return tiny_engine(params, kv_blocks=14, max_seqs=2)

    scfg = ServingConfig(
        max_queue_depth=64, prefix_cache={"enabled": True},
        kv_tier={"enabled": True},
        fault_tolerance={"enabled": True, "max_retries": 3,
                         "restart_backoff_s": 0.05,
                         "supervisor_poll_s": 0.02},
        faults={"enabled": True, "schedule": [
            {"kind": "crash", "replica": 0, "at_step": 4}]})
    fe = ServingFrontend([factory(0)], scfg, engine_factory=factory)
    try:
        handles = [fe.submit(p, max_new_tokens=5) for p in reqs]
        assert fe.wait_all(handles, timeout=180)
        assert all(h.state == RequestState.FINISHED for h in handles)
        assert fe.metrics_snapshot()["replica_restarts"] == 1
        assert_greedy_parity(oracle(reqs, 5), tokens(handles),
                             "tier + failover")
    finally:
        shut(fe)


def test_kv_tier_config_apply():
    kt = KVTierConfig(enabled=True, host_max_bytes=123, disk_path="/x",
                      disk_max_bytes=456)
    vcfg = RaggedInferenceEngineConfig()
    kt.apply(vcfg)
    assert (vcfg.kv_tier_enabled, vcfg.kv_tier_host_bytes,
            vcfg.kv_tier_disk_path, vcfg.kv_tier_disk_bytes) == \
        (True, 123, "/x", 456)


def test_ds_config_mounts_kv_tier():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedTpuConfig

    c = DeepSpeedTpuConfig(**{"train_micro_batch_size_per_gpu": 1,
                              "kv_tier": {"enabled": True,
                                          "host_max_bytes": 99},
                              "serving": {"kv_tier": {"enabled": True}}})
    assert c.kv_tier.enabled and c.kv_tier.host_max_bytes == 99
    assert c.serving.kv_tier.enabled


# -------------------------------------------------------------- preemption
def test_disabled_admission_byte_parity(params, oracle):
    reqs = prompts(6, 50, lo=24, hi=25)

    def run(extra):
        fe = ServingFrontend([tiny_engine(params)],
                             ServingConfig(max_queue_depth=64, **extra))
        try:
            hs = [fe.submit(p, max_new_tokens=4) for p in reqs]
            assert fe.wait_all(hs, timeout=240)
            return tokens(hs)
        finally:
            shut(fe)

    absent = run({})
    disabled = run({"admission": {"reservation": False,
                                  "preemption": {"enabled": False}}})
    assert disabled == absent
    assert_greedy_parity(oracle(reqs, 4), absent, "admission off")


def test_queue_counts_preempt_pressure_sheds():
    from deepspeed_tpu_torch.serving import (AdmissionQueue, ServingRequest,
                                             serving_metrics)

    def req():
        return ServingRequest([1, 2], 4, 1, None, None)

    m = serving_metrics()
    q = AdmissionQueue(1, m)
    q.offer(req())
    counts = []
    for pressure in (False, True, False):
        q.set_preempt_pressure(pressure)
        with pytest.raises(Rejected):
            q.offer(req())
        counts.append(m.counter("requests_shed_preempt_pressure").value)
    assert counts == [0, 1, 1]


def test_frontend_publishes_preempt_metrics_and_journal(params, oracle):
    rng = np.random.default_rng(12)

    def factory(i):
        return tiny_engine(params, kv_blocks=14, max_seqs=8)

    cfg = ServingConfig(
        max_queue_depth=64, prefix_cache={"enabled": True},
        kv_tier={"enabled": True},
        admission={"reservation": True, "oversubscription_factor": 3.0,
                   "preemption": {"enabled": True}})
    fe = ServingFrontend.from_engine_factory(factory, cfg)
    try:
        batch_p = [rng.integers(0, VOCAB, size=60).tolist() for _ in range(4)]
        hb = [fe.submit(p, max_new_tokens=24, request_class="batch")
              for p in batch_p]
        deadline = time.monotonic() + 30
        while sum(len(h._req.generated_tokens) for h in hb) < 4 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        inter_p = [rng.integers(0, VOCAB, size=60).tolist()
                   for _ in range(8)]
        hi = [fe.submit(p, max_new_tokens=4, request_class="interactive")
              for p in inter_p]
        assert fe.wait_all(hb + hi, timeout=240)
        snap = fe.metrics_snapshot()
        assert snap["sequences_preempted"] > 0
        assert snap["sequences_resumed"] > 0
        assert snap["preempt_spill_s"]["count"] > 0
        assert snap["preempt_resume_s"]["count"] > 0
        evs = fe.journal.events(kinds=("sequence_preempted",))
        assert evs and evs[0]["detail"]["blocks"] > 0
        assert not validate_events(fe.journal.events())
        rep = fe.health_report()
        assert rep["counters"]["sequences_preempted"] > 0
        assert "preempted_resident_blocks" in rep["occupancy"]
        got = tokens(hb + hi)
        ref = oracle(batch_p, 16) + oracle(inter_p, 4)
        assert_greedy_parity(ref, [g[:16] for g in got[:4]] + got[4:],
                             "preemption")
    finally:
        shut(fe)


def test_preemption_requires_reservation(params):
    with pytest.raises(ValueError):
        ServingConfig(admission={"reservation": False,
                                 "preemption": {"enabled": True}})
    with pytest.raises(ValueError):
        tiny_engine(params).configure_admission(False,
                                                preemption_enabled=True)


def test_config_wiring():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedTpuConfig

    sc = ServingConfig(admission={"reservation": True,
                                  "oversubscription_factor": 2.5,
                                  "preemption": {"enabled": True,
                                                 "victim_policy":
                                                     "most_blocks",
                                                 "max_preemptions_per_seq":
                                                     3}})
    assert sc.admission.active
    ecfg = RaggedInferenceEngineConfig()
    sc.admission.apply(ecfg)
    assert (ecfg.admission_reservation,
            ecfg.admission_oversubscription_factor,
            ecfg.admission_preemption_enabled, ecfg.admission_victim_policy,
            ecfg.admission_max_preemptions_per_seq) == \
        (True, 2.5, True, "most_blocks", 3)
    ds = DeepSpeedTpuConfig(**{
        "train_micro_batch_size_per_gpu": 1,
        "admission": {"reservation": True},
        "serving": {"admission": {"reservation": True,
                                  "preemption": {"enabled": True}}}})
    assert ds.admission.reservation
    assert ds.serving.admission.preemption.enabled


# ------------------------------------------------------ speculative decoding
def repetitive_prompts(rng, n=3, motif_len=5, reps=4, tail=3):
    return [rng.integers(0, VOCAB, size=motif_len).tolist() * reps
            + rng.integers(0, VOCAB, size=tail).tolist() for _ in range(n)]


def test_custom_sampler_disables_speculation(params):
    class TrapSpec(SpeculativeConfig):
        def build_proposer(self, draft_engine_factory=None):
            raise AssertionError("proposer built despite custom sample_fn")

    rep = Replica(0, tiny_engine(params),
                  sample_fn=lambda logits: int(np.argmax(logits)),
                  speculative=TrapSpec(enabled=True))
    assert not rep.scheduler.spec_enabled


def test_serving_config_enables_speculation(params1, oracle1):
    prompt = repetitive_prompts(np.random.default_rng(2), n=1)[0]
    cfg = ServingConfig(max_queue_depth=8,
                        speculative=SpeculativeConfig(enabled=True,
                                                      mode="ngram",
                                                      max_draft_tokens=4))
    fe = ServingFrontend([tiny_engine(params1)], cfg)
    try:
        replica = fe.router.replicas[0]
        assert replica.scheduler.spec_enabled
        assert isinstance(replica.scheduler.proposer, NGramProposer)
        h = fe.submit(prompt, max_new_tokens=10)
        assert h._req.wait(60)
        assert [ev.token for ev in h.stream(timeout=10)] == \
            oracle1([prompt], 10)[0]
        snap = fe.metrics_snapshot()
        assert snap["spec_tokens_proposed"] > 0
        assert snap["spec_tokens_emitted"] > snap["spec_decode_forwards"]
    finally:
        shut(fe)


def test_deadline_expiry_mid_speculation(params1):
    prompt = repetitive_prompts(np.random.default_rng(4), n=1)[0]
    engine = tiny_engine(params1)
    # the port's CPU puts take a few ms; slow each by 10 ms so the 150 ms
    # deadline lands mid-stream, as it does on the JAX engine
    fe = ServingFrontend([engine], ServingConfig(
        max_queue_depth=8,
        speculative=SpeculativeConfig(enabled=True, max_draft_tokens=4),
        faults={"enabled": True, "schedule": [
            {"kind": "slow_forward", "replica": 0, "at_put": 0,
             "duration_s": 0.01, "count": 0}]}))
    try:
        doomed = fe.submit(prompt, max_new_tokens=100, deadline_ms=150.0)
        ok = fe.submit(prompt, max_new_tokens=6)
        assert doomed._req.wait(60) and ok._req.wait(60)
        assert doomed.state == RequestState.EXPIRED
        assert ok.state == RequestState.FINISHED
        assert wait_free(engine)
        assert fe.metrics_snapshot()["requests_expired"] == 1
    finally:
        shut(fe)


def test_speculative_config_build_proposer(params):
    assert SpeculativeConfig().build_proposer() is None
    p = SpeculativeConfig(enabled=True, ngram_max=5).build_proposer()
    assert isinstance(p, NGramProposer) and p.ngram_max == 5
    dm = SpeculativeConfig(enabled=True, mode="draft_model").build_proposer(
        draft_engine_factory=lambda: tiny_engine(params))
    assert isinstance(dm, DraftModelProposer)
    with pytest.raises(ValueError, match="draft_model"):
        SpeculativeConfig(enabled=True, mode="draft_model").build_proposer()
    with pytest.raises(ValueError, match="unknown speculative.mode"):
        SpeculativeConfig(enabled=True, mode="magic").build_proposer()


# ---------------------------------------------------- engine-block mounts
def test_engine_blocks_mount_through_serving_config(params):
    """``weight_quant`` (int8), ``kv_quant`` (int8), the prefix cache and
    reservation admission through ``ServingConfig``: the replica's engine
    is configured as by hand, and its streams equal the hand-configured
    engine's."""
    rng = np.random.default_rng(60)
    sys_prompt = rng.integers(0, VOCAB, size=32).tolist()
    ps = [sys_prompt + rng.integers(0, VOCAB, size=6).tolist()
          for _ in range(4)]
    by_hand = tiny_engine(params)
    by_hand.configure_weight_quant(True, dtype="int8", block=32)
    by_hand.configure_kv_quant(True, "int8", "block")
    by_hand.configure_prefix_cache(True, None)
    by_hand.configure_admission(True)
    ref = greedy_generate(by_hand, ps, max_new_tokens=6)
    eng = tiny_engine(params)
    fe = ServingFrontend([eng], ServingConfig(
        max_queue_depth=16, weight_quant={"enabled": True, "block": 32},
        kv_quant={"enabled": True}, prefix_cache={"enabled": True},
        admission={"reservation": True}))
    try:
        assert eng.config.weight_quant_enabled
        assert eng.state_manager.kv_quant
        assert eng.state_manager.prefix_cache_enabled
        assert eng.config.admission_reservation
        hs = []
        for p in ps:
            hs.append(fe.submit(p, max_new_tokens=6))
            assert fe.wait_all(hs[-1:], timeout=120)
        assert_greedy_parity(ref, tokens(hs), "config mounts")
        snap = fe.metrics_snapshot()
        assert snap["prefix_tokens_saved"] > 0
        assert snap["param_bytes_quantized"] > 0
    finally:
        shut(fe)


def test_missing_engine_hook_raises_at_build(params):
    """An enabled block whose ``configure_*`` hook the engine lacks fails
    the frontend build (the JAX frontend skips it)."""
    class NoTier:
        def __init__(self, eng):
            self._eng = eng

        def __getattr__(self, name):
            if name == "configure_kv_tier":
                raise AttributeError(name)
            return getattr(self._eng, name)

    with pytest.raises(AttributeError, match="configure_kv_tier"):
        ServingFrontend([NoTier(tiny_engine(params))], tier_config())


# ------------------------------------------------- cross-package checkpoint
@pytest.fixture(scope="module")
def jax_checkpoint(weights, tmp_path_factory):
    save_dir = str(tmp_path_factory.mktemp("serve_ckpt"))
    tag_dir = os.path.join(save_dir, "t0")
    index = _save_tree(weights, os.path.join(tag_dir, "params"))
    with open(os.path.join(tag_dir, "manifest.json"), "w") as fh:
        json.dump({"tag": "t0", "params_index": index}, fh)
    with open(os.path.join(save_dir, "latest"), "w") as fh:
        fh.write("t0")
    return save_dir


def test_model_spec_checkpoint_serves_same_streams(jax_checkpoint, oracle):
    """One ``models:`` spec naming a JAX-written universal checkpoint: both
    packages' frontends build their pool through ``engine_from_model_spec``
    and serve the same streams."""
    spec = {"model": dict(vocab_size=VOCAB, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=2,
                          max_seq_len=128, norm="rmsnorm", activation="silu",
                          position="rope"),
            "engine": dict(max_ragged_batch_size=128,
                           max_ragged_sequence_count=4, max_chunk_tokens=32,
                           kv_blocks=64, kv_block_size=BS),
            "checkpoint": jax_checkpoint, "replicas": 1}
    ps = prompts(4, 70)
    out = {}
    for name, mod, kw in (("jax", jserving, {}),
                          ("port", None, {"device": "cpu"})):
        if mod is None:
            fe = ServingFrontend([], ServingConfig(
                max_queue_depth=16, models={"m": spec}), **kw)
        else:
            fe = mod.ServingFrontend([], mod.ServingConfig(
                max_queue_depth=16, models={"m": spec}))
        try:
            hs = [fe.submit(p, max_new_tokens=6) for p in ps]
            assert fe.wait_all(hs, timeout=300)
            out[name] = tokens(hs)
            assert fe.router.replicas[0].model_id == "m"
        finally:
            fe.shutdown(drain=False, timeout=5)
    assert_greedy_parity(out["jax"], out["port"], "model spec checkpoint")
    assert_greedy_parity(oracle(ps, 6), out["port"], "checkpoint weights")


def test_model_spec_seeded_weights_repeat(params):
    """A spec without a checkpoint draws weights from a torch generator
    seeded with ``seed``: the same seed gives the same weights."""
    from deepspeed_tpu_torch.serving.config import ModelSpec

    spec = ModelSpec(model=dict(vocab_size=VOCAB, hidden_size=32,
                                intermediate_size=64, num_layers=1,
                                num_heads=2, max_seq_len=64),
                     engine=dict(kv_blocks=16, kv_block_size=BS), seed=5)
    a, b = (engine_from_model_spec(spec, device="cpu") for _ in range(2))
    assert torch.equal(a.params["embed"]["wte"], b.params["embed"]["wte"])
    c = engine_from_model_spec(ModelSpec(**dict(spec.to_dict(), seed=6)),
                               device="cpu")
    assert not torch.equal(a.params["embed"]["wte"], c.params["embed"]["wte"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA present")
def test_no_cuda_and_no_device_raises(params):
    """Without CUDA, a pool the frontend builds itself needs an explicit
    ``device="cpu"``; caller-built CPU engines serve as they are."""
    spec = {"model": dict(vocab_size=VOCAB, hidden_size=32,
                          intermediate_size=64, num_layers=1, num_heads=2,
                          max_seq_len=64), "engine": {"kv_blocks": 16}}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingFrontend([], ServingConfig(models={"m": spec}))
    fe = ServingFrontend([tiny_engine(params)], ServingConfig())
    shut(fe)


# ------------------------------------------------------------ not ported
NOT_PORTED = {
    "tenants": ({"tenants": {"a": {"weight": 2.0}}}, "item 10b"),
    "affinity": ({"affinity": {"enabled": True}}, "item 10b"),
    "autoscaler": ({"autoscaler": {"enabled": True}}, "item 10b"),
    "disaggregation": ({"disaggregation": {
        "enabled": True, "roles": ["prefill", "decode"]}}, "item 10b"),
    "fabric": ({"fabric": {"enabled": True, "peers": ["127.0.0.1:1"]}},
               "item 11"),
    "federation": ({"fabric": {"enabled": True, "federation": {
        "enabled": True}}}, "item 11"),
    "model-peers": ({"models": {"m": {"model": {"vocab_size": 8},
                                      "peers": ["127.0.0.1:1"]}}},
                    "item 11"),
    "chaos": ({"chaos": {"enabled": True}}, "item 11"),
}


@pytest.mark.parametrize("name", list(NOT_PORTED))
def test_unported_block_raises(params, name):
    block, item = NOT_PORTED[name]
    cfg = ServingConfig(**block)            # parses, as in the JAX package
    with pytest.raises(NotImplementedError, match=item):
        ServingFrontend([tiny_engine(params)], cfg)
    with pytest.raises(NotImplementedError, match=item):
        ServingFrontend.from_engine_factory(lambda i: tiny_engine(params),
                                            cfg)


def test_unported_names_and_methods_raise(params):
    import deepspeed_tpu_torch.serving as tserving

    for name, item in (("FleetController", "item 10b"),
                       ("RemoteHandle", "item 11"),
                       ("LocalHandle", "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            getattr(tserving, name)
    fe = ServingFrontend([tiny_engine(params)], ServingConfig())
    try:
        with pytest.raises(NotImplementedError, match="item 10b"):
            fe.set_replica_role(0, "decode")
        with pytest.raises(NotImplementedError, match="item 10b"):
            fe.fleet_signals()
        with pytest.raises(NotImplementedError, match="item 11"):
            fe.federation_address
    finally:
        shut(fe)
