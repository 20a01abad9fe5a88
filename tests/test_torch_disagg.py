"""Port parity: disaggregated prefill/decode serving in
``deepspeed_tpu_torch``'s ``ServingFrontend`` against the JAX package's.

The model of ``tests/test_disagg.py`` (vocab 128, hidden 64, 2 layers,
blocks of 8) with the JAX ``init(PRNGKey(0))`` weights x3, handed to the
port through ``params_from_numpy``. Streams are compared exactly: every
completed stream must equal the JAX engine's greedy stream for its prompt
byte for byte (a module-scoped JAX engine computes them once: the mixed
stack's streams), and the JAX disaggregated frontend's streams for the same
prompts. Handoff counters are compared exactly with the JAX frontend's.

The cases mirror the frontend cases of ``tests/test_disagg.py:237-404``
(handoffs, the prefix cache and int8 KV through a handoff, the staging-full
fallback, the disabled block, cancel and deadline racing the handoff, a
prefill replica's death, role validation with the JAX messages) and add the
port's own: an export that raises ``RuntimeError`` falls back to
re-prefill, one that raises anything else kills the replica; role-aware
``add_replica``/``remove_replica``/``set_replica_role``; the per-role
gauges; evacuation riding the handoff stager.
"""

import time

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
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
from deepspeed_tpu_torch.serving import (RequestState, ServingConfig,
                                         ServingFrontend)
import torch_cpu  # noqa: F401  (one torch thread: see the module)

VOCAB = 128
BS = 8
ORACLE_NEW = 8
ENGINE = dict(max_ragged_batch_size=128, max_ragged_sequence_count=4,
              max_chunk_tokens=32, kv_blocks=64, kv_block_size=BS,
              max_tracked_sequences=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(mod):
    return mod.TransformerConfig(vocab_size=VOCAB, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=2, max_seq_len=128, norm="rmsnorm",
                                 activation="silu", position="rope")


@pytest.fixture(scope="module")
def weights():
    jp = jtf.CausalLM(_cfg(jtf)).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a) * (3 if a.ndim >= 2 else 1),
                        jp)


@pytest.fixture(scope="module")
def params(weights):
    return params_from_numpy(weights, device="cpu")


@pytest.fixture(scope="module")
def jmodel():
    return jtf.CausalLM(_cfg(jtf))


@pytest.fixture(scope="module")
def oracle(weights, jmodel):
    """The JAX engine's greedy streams (the mixed stack's), computed once
    per prompt and cut to each request's budget."""
    engine = JEngine(jmodel, params=weights,
                     config=JConfig(**dict(ENGINE, kv_blocks=512,
                                           max_ragged_sequence_count=16,
                                           max_tracked_sequences=64)))
    cache = {}

    def run(ps, n):
        todo = list({tuple(p) for p in ps} - set(cache))
        if todo:
            out = j_greedy_generate(engine, [list(p) for p in todo],
                                    uid_base=len(cache),
                                    max_new_tokens=ORACLE_NEW,
                                    sequential=False)
            cache.update(zip(todo, out))
        return [cache[tuple(p)][:n] for p in ps]
    return run


def tiny_engine(params, **over):
    return InferenceEngineV2(ttf.CausalLM(_cfg(ttf)), params=params,
                             config=RaggedInferenceEngineConfig(
                                 **dict(ENGINE, **over)), device="cpu")


def prompts(n, seed, lo=8, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(k)).tolist()
            for k in rng.integers(lo, hi, size=n)]


def tokens(handles):
    return [[ev.token for ev in h.drain()] for h in handles]


def disagg(roles, mod=None, **over):
    """A disaggregation config (the port's, or ``mod``'s)."""
    dis = {"enabled": True, "roles": roles, "decode_reserve_tokens": 8}
    dis.update(over)
    cls = mod.ServingConfig if mod is not None else ServingConfig
    return cls(max_queue_depth=64, disaggregation=dis)


def jax_engines(n, weights, jmodel):
    return [JEngine(jmodel, params=weights, config=JConfig(**ENGINE))
            for _ in range(n)]


def shut(fe):
    fe.shutdown(drain=False, timeout=5)
    for rep in fe.router.replicas:
        occ = rep.engine.occupancy()
        assert occ["available_blocks"] == occ["total_blocks"], occ


def wait_staged_empty(fe, timeout=30.0):
    deadline = time.monotonic() + timeout
    while len(fe._stager) and time.monotonic() < deadline:
        time.sleep(0.01)
    return len(fe._stager) == 0


HANDOFF_KEYS = ("handoffs_started", "handoffs_completed", "handoff_fallbacks",
                "requests_completed", "requests_failed")


# ------------------------------------------------------------ end to end
def test_disagg_streams_equal_jax_disagg_and_mixed(params, weights, jmodel,
                                                   oracle):
    """Two replicas, prefill and decode: each request hands off once, and
    the streams equal the JAX disaggregated frontend's and the mixed
    stack's; the counters equal the JAX frontend's."""
    ps = prompts(5, 9)
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)],
                         disagg(["prefill", "decode"]))
    try:
        assert [r.role for r in fe.router.replicas] == ["prefill", "decode"]
        assert fe.router.replicas[0].scheduler.prefill_only
        assert fe.router.replicas[1].scheduler.decode_reserve_tokens == 8
        hs = [fe.submit(p, max_new_tokens=6) for p in ps]
        assert fe.wait_all(hs, timeout=120)
        assert all(h.state == RequestState.FINISHED for h in hs)
        got = tokens(hs)
        snap = fe.metrics_snapshot()
        assert snap["handoff_s"]["count"] == len(ps)
        assert wait_staged_empty(fe)
        assert all(h._req.handoffs == 1 for h in hs)
    finally:
        shut(fe)
    jfe = jserving.ServingFrontend(jax_engines(2, weights, jmodel),
                                   disagg(["prefill", "decode"],
                                          mod=jserving))
    try:
        jhs = [jfe.submit(p, max_new_tokens=6) for p in ps]
        assert jfe.wait_all(jhs, timeout=300)
        jgot = tokens(jhs)
        jsnap = jfe.metrics_snapshot()
    finally:
        jfe.shutdown(drain=False, timeout=5)
    assert got == jgot == oracle(ps, 6)
    assert {k: snap[k] for k in HANDOFF_KEYS} \
        == {k: jsnap[k] for k in HANDOFF_KEYS} \
        == {"handoffs_started": 5, "handoffs_completed": 5,
            "handoff_fallbacks": 0, "requests_completed": 5,
            "requests_failed": 0}


def test_disagg_with_prefix_cache_and_int8_kv_equals_jax(params, weights,
                                                         jmodel):
    """A shared prompt three times, the prefix cache and int8 KV on: the
    handoff carries int8 slabs with their scale planes, and the streams
    and counters equal the JAX disaggregated frontend's."""
    ps = [prompts(1, 10, lo=20, hi=21)[0]] * 3
    cfg_kw = dict(max_queue_depth=64,
                  disaggregation={"enabled": True,
                                  "roles": ["prefill", "decode"],
                                  "decode_reserve_tokens": 8},
                  prefix_cache={"enabled": True},
                  kv_quant={"enabled": True})
    out = {}
    for name in ("port", "jax"):
        if name == "port":
            fe = ServingFrontend([tiny_engine(params), tiny_engine(params)],
                                 ServingConfig(**cfg_kw))
        else:
            fe = jserving.ServingFrontend(jax_engines(2, weights, jmodel),
                                          jserving.ServingConfig(**cfg_kw))
        try:
            hs = [fe.submit(p, max_new_tokens=5) for p in ps]
            assert fe.wait_all(hs, timeout=300)
            snap = fe.metrics_snapshot()
            out[name] = (tokens(hs), {k: snap[k] for k in HANDOFF_KEYS})
            assert fe.router.replicas[1].engine.config.kv_quant_enabled
        finally:
            fe.shutdown(drain=False, timeout=5)
    assert out["port"] == out["jax"]
    assert out["port"][1]["handoffs_completed"] == 3
    assert out["port"][1]["handoff_fallbacks"] == 0


def test_full_staging_buffer_falls_back_to_recompute(params, oracle):
    """One staging slot for four requests: handoffs that find it full
    re-prefill on the decode replica, every fallback is counted, and the
    streams are the mixed stack's."""
    ps = prompts(4, 11)
    fe = ServingFrontend(
        [tiny_engine(params), tiny_engine(params)],
        disagg(["prefill", "decode"],
               handoff={"enabled": True, "max_staged": 1}))
    try:
        hs = [fe.submit(p, max_new_tokens=5) for p in ps]
        assert fe.wait_all(hs, timeout=120)
        assert all(h.state == RequestState.FINISHED for h in hs)
        assert tokens(hs) == oracle(ps, 5)
        snap = fe.metrics_snapshot()
        assert snap["handoffs_completed"] + snap["handoff_fallbacks"] \
            == len(ps)
        assert snap["handoffs_started"] == snap["handoffs_completed"]
        fallbacks = [e for e in fe.journal.events()
                     if e["kind"] == "handoff_fallback"]
        assert len(fallbacks) == snap["handoff_fallbacks"]
        assert all(e["detail"]["where"] == "staging_full" for e in fallbacks)
        assert wait_staged_empty(fe)
    finally:
        shut(fe)


def test_disabled_block_is_the_mixed_stack(params, oracle):
    ps = prompts(4, 12)
    scfg = ServingConfig(max_queue_depth=64, disaggregation={
        "enabled": False, "roles": ["prefill", "decode"],
        "decode_reserve_tokens": 100})
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)], scfg)
    try:
        assert fe._disagg is None and fe._stager is None
        assert fe.router.disaggregation is None
        for r in fe.router.replicas:
            assert r.role == "mixed" and r._on_handoff is None
            assert r.scheduler.prefill_only is False
            assert r.scheduler.decode_reserve_tokens == 0
        hs = [fe.submit(p, max_new_tokens=6) for p in ps]
        assert fe.wait_all(hs, timeout=120)
        assert tokens(hs) == oracle(ps, 6)
        assert fe.metrics_snapshot()["handoffs_started"] == 0
    finally:
        shut(fe)


def test_handoff_races_cancel_and_deadline(params):
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)],
                         disagg(["prefill", "decode"]))
    try:
        h = fe.submit(prompts(1, 13, lo=20, hi=24)[0], max_new_tokens=50)
        h.cancel()
        assert h._req.wait(60), "cancelled request never settled"
        assert h.state in (RequestState.CANCELLED, RequestState.FINISHED)
        h2 = fe.submit(prompts(1, 14, lo=20, hi=24)[0], max_new_tokens=50,
                       deadline_ms=1.0)
        assert h2._req.wait(60), "expired request never settled"
        assert h2.state == RequestState.EXPIRED
        assert wait_staged_empty(fe)
    finally:
        shut(fe)


def test_prefill_replica_death_fails_over(params, oracle):
    """The prefill replica crashes at its first busy step: its requests
    fail over and resume elsewhere with the mixed stack's streams, and the
    supervisor restarts the slot with its prefill role."""
    ps = prompts(3, 15)
    scfg = ServingConfig(
        max_queue_depth=64,
        disaggregation={"enabled": True, "roles": ["prefill", "decode"],
                        "decode_reserve_tokens": 8},
        fault_tolerance={"enabled": True, "max_retries": 3,
                         "restart_backoff_s": 0.05,
                         "supervisor_poll_s": 0.02},
        faults={"enabled": True, "schedule": [
            {"kind": "crash", "replica": 0, "at_step": 0}]})
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)], scfg,
                         engine_factory=lambda i: tiny_engine(params))
    try:
        hs = [fe.submit(p, max_new_tokens=6) for p in ps]
        assert fe.wait_all(hs, timeout=120)
        assert all(h.state == RequestState.FINISHED for h in hs)
        assert tokens(hs) == oracle(ps, 6)
        deadline = time.monotonic() + 60
        while not fe.supervisor.restart_log and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fe.supervisor.restart_log
        assert fe.router.replicas[0].role == "prefill"
        assert fe.router.replicas[0]._on_handoff is not None
    finally:
        shut(fe)


ROLE_CASES = {
    "unknown": (["prefill", "verifier"], {}),
    "count": (["prefill"], {}),
    "no-decode": (["prefill", "prefill"], {}),
    "no-handoff": (["prefill", "decode"], {"handoff": {"enabled": False}}),
}


@pytest.mark.parametrize("case", list(ROLE_CASES))
def test_role_validation_raises_jax_messages(params, weights, jmodel, case):
    roles, over = ROLE_CASES[case]
    with pytest.raises(ValueError) as jerr:
        jserving.ServingFrontend(jax_engines(2, weights, jmodel),
                                 disagg(roles, mod=jserving, **over))
    with pytest.raises(ValueError) as terr:
        ServingFrontend([tiny_engine(params), tiny_engine(params)],
                        disagg(roles, **over))
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------- export faults (port)
def test_export_runtime_error_falls_back_and_other_errors_kill(params,
                                                               oracle):
    """The port catches only ValueError and RuntimeError around the
    export (the JAX frontend catches every exception): a RuntimeError
    counts one fallback with ``where="export"`` and the request
    re-prefills on the decode replica with the same stream; a TypeError
    reaches the prefill replica's worker, which dies."""
    ps = prompts(2, 16)
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)],
                         disagg(["prefill", "decode"]))
    try:
        pre = fe.router.replicas[0].engine
        calls = []

        def failing(uid, chunk_blocks=0):
            calls.append(uid)
            raise RuntimeError("export failed")
        pre.export_sequence = failing
        h = fe.submit(ps[0], max_new_tokens=5)
        assert fe.wait_all([h], timeout=120)
        assert h.state == RequestState.FINISHED
        assert tokens([h]) == oracle(ps[:1], 5)
        snap = fe.metrics_snapshot()
        assert calls and snap["handoff_fallbacks"] == 1
        assert snap["handoffs_started"] == 0
        ev = [e for e in fe.journal.events()
              if e["kind"] == "handoff_fallback"]
        assert [e["detail"]["where"] for e in ev] == ["export"]
        assert pre.occupancy()["available_blocks"] == ENGINE["kv_blocks"]

        def broken(uid, chunk_blocks=0):
            raise TypeError("not a fallback")
        pre.export_sequence = broken
        fe.submit(ps[1], max_new_tokens=5)
        deadline = time.monotonic() + 60
        while fe.router.replicas[0].state.value != "dead" \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fe.router.replicas[0].state.value == "dead"
        assert fe.metrics_snapshot()["handoff_fallbacks"] == 1
    finally:
        fe.shutdown(drain=False, timeout=5)


# ------------------------------------------------- roles and membership
def test_add_remove_and_rerole_replicas(params, oracle):
    """Role-aware membership: ``add_replica`` refuses a prefill role
    without the handoff path and a specialized role without
    disaggregation; a decode replica joins and serves; the last
    decode-capable replica cannot be removed or re-roled to prefill;
    ``set_replica_role`` rebuilds the slot's scheduler in the new shape
    over the same engine."""
    mixed = ServingFrontend([tiny_engine(params)], ServingConfig(),
                            engine_factory=lambda i: tiny_engine(params))
    try:
        with pytest.raises(ValueError, match="disaggregation.enabled"):
            mixed.add_replica("decode")
        with pytest.raises(ValueError, match="disaggregation.enabled"):
            mixed.set_replica_role(0, "decode")
    finally:
        shut(mixed)
    nohand = ServingFrontend(
        [tiny_engine(params)],
        disagg(["decode"], handoff={"enabled": False}),
        engine_factory=lambda i: tiny_engine(params))
    try:
        with pytest.raises(ValueError, match="handoff.enabled"):
            nohand.add_replica("prefill")
        with pytest.raises(ValueError, match="handoff.enabled"):
            nohand.set_replica_role(0, "prefill")
    finally:
        shut(nohand)

    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)],
                         disagg(["prefill", "decode"]),
                         engine_factory=lambda i: tiny_engine(params))
    try:
        with pytest.raises(ValueError, match="decode-capable"):
            fe.remove_replica(1)
        with pytest.raises(ValueError, match="decode-capable"):
            fe.set_replica_role(1, "prefill")
        with pytest.raises(ValueError, match="unknown replica role"):
            fe.add_replica("verifier")
        rid = fe.add_replica("decode")
        assert rid == 2 and fe.router.replica_by_id(2).role == "decode"
        assert fe.remove_replica(1)
        ps = prompts(3, 17)
        hs = [fe.submit(p, max_new_tokens=5) for p in ps]
        assert fe.wait_all(hs, timeout=120)
        assert tokens(hs) == oracle(ps, 5)
        assert {h._req.replica_id for h in hs} == {2}
        eng0 = fe.router.replica_by_id(0).engine
        assert fe.set_replica_role(0, "decode") is True
        assert fe.set_replica_role(0, "decode") is False
        rep0 = fe.router.replica_by_id(0)
        assert rep0.role == "decode" and rep0.engine is eng0
        assert not rep0.scheduler.prefill_only
        assert rep0.scheduler.decode_reserve_tokens == 8
        assert fe._role_of(0) == "decode"
        sig = fe.fleet_signals()
        assert [(r.replica_id, r.role) for r in sig.replicas] \
            == [(0, "decode"), (2, "decode")]
        assert sig.disaggregated and sig.decode_token_cost == 8.0
        snap = fe.metrics_snapshot()
        assert snap["kv_blocks_in_use_role_decode"] == 0
    finally:
        shut(fe)


def test_per_role_gauges_and_health_roles(params):
    fe = ServingFrontend([tiny_engine(params), tiny_engine(params)],
                         disagg(["prefill", "decode"]))
    try:
        hs = [fe.submit(p, max_new_tokens=4) for p in prompts(2, 22)]
        assert fe.wait_all(hs, timeout=120)
        snap = fe.metrics_snapshot()
        assert "kv_blocks_in_use_role_prefill" in snap
        assert "kv_blocks_in_use_role_decode" in snap
        rep = fe.health_report()
        assert [r["role"] for r in rep["replicas"]] == ["prefill", "decode"]
        assert rep["counters"]["handoffs_completed"] == 2
        assert "0:healthy(prefill) 1:healthy(decode)" \
            in fe.health_report_text()
    finally:
        shut(fe)


def test_evacuation_rides_the_handoff_stager(params, oracle):
    """With a handoff stager, a removal's evacuated KV is staged in the
    same bounded buffer (no second stager) and the moved requests keep
    the mixed stack's streams; evacuated imports stay out of the handoff
    counters."""
    ps = prompts(3, 18, lo=20, hi=24)
    fe = ServingFrontend(
        [tiny_engine(params), tiny_engine(params), tiny_engine(params)],
        disagg(["prefill", "decode", "decode"]),
        engine_factory=lambda i: tiny_engine(params))
    try:
        assert fe._evacuation_stager() is fe._stager
        hs = [fe.submit(p, max_new_tokens=8) for p in ps]
        deadline = time.monotonic() + 60
        while fe.metrics_snapshot()["handoffs_completed"] < 1 \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        busy = next((r.replica_id for r in fe.router.replicas
                     if r.role == "decode" and r.outstanding_tokens > 0), 1)
        assert fe.remove_replica(busy)
        assert fe.wait_all(hs, timeout=120)
        assert tokens(hs) == oracle(ps, 8)
        snap = fe.metrics_snapshot()
        assert snap["handoffs_completed"] == snap["handoffs_started"] == 3
        assert fe._evac_stager is None
    finally:
        shut(fe)
