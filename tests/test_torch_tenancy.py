"""Port parity: multi-tenant fair share and quotas
(``deepspeed_tpu_torch/serving/tenancy.py``) against the JAX package's.

Host-logic cases run twice, once over each package's modules, on the same
inputs and an injected clock, and return what they observed (virtual
service, drain keys, throttle states and journal events, KV books,
``snapshot()``, pop orders as tenant sequences); the port must observe
exactly what the JAX package does (floats compared with ``==``: the same
Python arithmetic in the same order). They mirror ``tests/test_tenancy.py``
(the ledger's fair share, token-rate quota and KV budget; the admission
queue's fair ordering and victim order).

Frontend cases serve the model of ``tests/test_torch_serving_load.py``
(vocab 128, hidden 64, 2 layers; the JAX ``init(PRNGKey(0))`` weights x3)
on the CPU: each stream equals the JAX engine's greedy stream byte for
byte, a light tenant overtakes a flood in both packages (a serial engine),
and the tenant books and per-tenant counters after it equal the JAX
frontend's.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.serving as j_serving
import deepspeed_tpu.serving.config as j_config
import deepspeed_tpu.serving.tenancy as j_tenancy
import deepspeed_tpu_torch.serving as t_serving
import deepspeed_tpu_torch.serving.config as t_config
import deepspeed_tpu_torch.serving.tenancy as t_tenancy
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
import torch_cpu  # noqa: F401  (one torch thread: see the module)

JAX = SimpleNamespace(S=j_serving, C=j_config, T=j_tenancy)
PORT = SimpleNamespace(S=t_serving, C=t_config, T=t_tenancy)


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


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


class Journal:
    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append((kind, fields))


class FakeReplica:
    """Just enough surface for the ledger's KV budget math."""

    def __init__(self, replica_id=0, block_size=8):
        self.replica_id = replica_id
        self.engine = SimpleNamespace(
            config=SimpleNamespace(kv_block_size=block_size))


def req(ns, plen=8, max_new=4, tenant="default", request_class="interactive",
        shed_rank=0):
    return ns.S.ServingRequest([1] * plen, max_new, 1, None, None,
                               request_class=request_class,
                               shed_rank=shed_rank, tenant=tenant)


def ledger(ns, policies, clock=None, journal=None, metrics=None):
    pols = {name: ns.C.TenantPolicy(**kw) for name, kw in policies.items()}
    pols.setdefault("default", ns.C.TenantPolicy())
    return ns.T.TenantLedger(pols, metrics=metrics, journal=journal,
                             window_s=10.0, clock=clock or Clock())


def drain(q, led=None):
    """Pop-and-charge loop, the router's dispatch contract."""
    out = []
    while len(q):
        r = q.pop(timeout=0.1)
        if r is None:
            break
        if led is not None:
            led.charge(r)
        out.append(r)
    return out


# ------------------------------------------------------------ the ledger
@both
def test_fair_share_weights_floor_and_names(ns):
    led = ledger(ns, {"a": {"weight": 1.0}, "b": {"weight": 4.0}})
    led.charge(req(ns, 12, 4, "a"))
    led.charge(req(ns, 12, 4, "b"))
    keys = [led.drain_key("a"), led.drain_key("b")]
    assert keys[1] < keys[0]
    solo = ledger(ns, {"a": {}, "b": {}})
    for _ in range(6):
        solo.charge(req(ns, 8, 4, "a"))
    assert solo.drain_key("b") < solo.drain_key("a")
    bounded = ledger(ns, {"a": {}, "b": {}})
    for _ in range(50):
        for t in ("a", "b", "default"):
            bounded.charge(req(ns, tenant=t))
    return (keys, solo.drain_key("a"), solo.drain_key("b"),
            [bounded.drain_key(t) for t in ("a", "b", "default")],
            led.known("a"), led.known("ghost"), led.tenant_names,
            led.snapshot())


@both
def test_token_rate_edges_journal_and_gauge(ns):
    clk, jr = Clock(), Journal()
    m = ns.S.serving_metrics(("interactive", "batch"),
                             tenants=("a", "default"))
    led = ledger(ns, {"a": {"token_rate": 2.0}, "b": {}}, clk, jr, m)
    seen = []
    for _ in range(3):
        led.charge(req(ns, 8, 4, "a"))
        seen.append((led.over_quota("a"),
                     m.snapshot()["tenant_over_quota_a"]))
    clk.t += 11.0
    led.reconcile()
    seen.append((led.over_quota("a"), m.snapshot()["tenant_over_quota_a"]))
    for _ in range(3):
        led.charge(req(ns, 8, 4, "a"))
    for _ in range(100):
        led.charge(req(ns, 32, 32, "b"))
    return (seen, jr.events, led.over_quota("b"),
            led.victim_rank(req(ns, tenant="a")),
            led.victim_rank(req(ns, tenant="b")), led.snapshot())


@both
def test_kv_budget_admit_charge_release_reconcile(ns):
    led = ledger(ns, {"a": {"kv_block_budget": 4}, "u": {}})
    rep0, rep1 = FakeReplica(0), FakeReplica(1)
    r1, r2 = req(ns, 17, 6, "a"), req(ns, 17, 6, "a")
    out = [ns.T.kv_blocks_for(r1, 8), ns.T.kv_blocks_for(r1, 16)]
    out.append(led.admits_kv(r1, rep0))
    led.charge_kv(r1, rep0)
    out += [led.admits_kv(r2, rep0), led.snapshot()["a"]["throttled"]]
    led.release_kv(r1.uid)
    out += [led.admits_kv(r2, rep0), led.snapshot()["a"]["throttled"]]
    led.charge_kv(r2, rep0)
    led.charge_kv(r2, rep1)          # a failover re-dispatch refunds rep0
    out.append(led.snapshot()["a"]["kv_blocks_used"])
    led.reconcile()
    out.append(led.snapshot()["a"]["kv_blocks_used"])
    r2.finish(ns.S.RequestState.FINISHED, ns.S.FinishReason.LENGTH)
    led.reconcile()
    out.append(led.snapshot()["a"]["kv_blocks_used"])
    ru = req(ns, tenant="u")
    out.append(led.admits_kv(ru, rep0))
    led.charge_kv(ru, rep0)
    out.append(led.snapshot())
    return out


# ------------------------------------------------ the queue over a ledger
@both
def test_queue_fair_pop_quota_and_fifo(ns):
    led = ledger(ns, {"a": {"weight": 1.0}, "b": {"weight": 4.0}})
    q = ns.S.AdmissionQueue(64, tenancy=led)
    for r in [req(ns, tenant="a") for _ in range(6)] \
            + [req(ns, tenant="b") for _ in range(2)]:
        q.offer(r)
    fair = [r.tenant for r in drain(q, led)]
    assert fair.index("b") == 1
    off = ns.S.AdmissionQueue(64)
    reqs = [req(ns, tenant="a") for _ in range(4)] \
        + [req(ns, tenant="b") for _ in range(2)]
    for r in reqs:
        off.offer(r)
    fifo = [r.uid for r in drain(off)] == [r.uid for r in reqs]
    over = ledger(ns, {"a": {"token_rate": 1.0}, "b": {}})
    for _ in range(5):
        over.charge(req(ns, 8, 4, "a"))
    q2 = ns.S.AdmissionQueue(64, tenancy=over)
    for r in [req(ns, tenant="a") for _ in range(2)] \
            + [req(ns, tenant="b") for _ in range(2)]:
        q2.offer(r)
    quota = [r.tenant for r in drain(q2, over)]
    va = q2._victim_key(req(ns, tenant="a"))
    vb = q2._victim_key(req(ns, tenant="b", request_class="batch",
                            shed_rank=1))
    return fair, fifo, quota, va > vb, over.snapshot()


@both
def test_per_tenant_shed_counter(ns):
    m = ns.S.serving_metrics(("interactive", "batch"),
                             tenants=("a", "default"))
    q = ns.S.AdmissionQueue(1, metrics=m, tenancy=ledger(ns, {"a": {}}))
    q.offer(req(ns, tenant="a"))
    with pytest.raises(ns.S.Rejected):
        q.offer(req(ns, tenant="a"))
    snap = m.snapshot()
    return snap["requests_shed_tenant_a"], snap["requests_shed"]


# ------------------------------------------------------------- frontend
VOCAB = 128
ENGINE = dict(max_ragged_batch_size=128, max_ragged_sequence_count=4,
              max_chunk_tokens=32, kv_blocks=64, kv_block_size=8,
              max_tracked_sequences=32)
TEN = {"alpha": {"weight": 1.0}, "bravo": {"weight": 4.0}}


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


def tiny_engine(params, **over):
    return InferenceEngineV2(ttf.CausalLM(_cfg(ttf)), params=params,
                             config=RaggedInferenceEngineConfig(
                                 **dict(ENGINE, **over)), device="cpu")


def tokens(handles):
    return [[ev.token for ev in h.drain()] for h in handles]


def test_unknown_tenant_refused_and_tenancy_off_namespace(params):
    fe = t_serving.ServingFrontend([tiny_engine(params)],
                                   t_serving.ServingConfig(tenants=TEN))
    try:
        assert fe._tenancy is not None
        assert fe.admission._tenancy is fe.router.tenancy is fe._tenancy
        with pytest.raises(ValueError, match="unknown tenant 'ghost'"):
            fe.submit([1] * 8, max_new_tokens=2, tenant="ghost")
        snap = fe.metrics.snapshot()
        assert snap["requests_submitted"] == 0.0
        assert snap["requests_shed"] == 0.0
    finally:
        fe.shutdown(drain=False, timeout=5)
    off = t_serving.ServingFrontend([tiny_engine(params)],
                                    t_serving.ServingConfig())
    try:
        h = off.submit([1, 2, 3, 4], max_new_tokens=3, tenant="anyone")
        assert off.wait_all([h], timeout=60)
        assert h._req.tenant == "default"
        assert not [k for k in off.metrics.snapshot() if "tenant" in k]
        assert off.health_report()["tenants"] is None
    finally:
        off.shutdown(drain=False, timeout=5)


def test_flood_overtaken_and_books_equal_jax(params, weights):
    """A serial engine (one sequence at a time) makes dispatch order equal
    queue order. Tenant alpha floods six requests, then bravo (weight 4)
    sends two: with the ledger, bravo overtakes the flood in both packages
    (both of its requests among the first four dispatched), the tenant
    books and per-tenant counters equal the JAX frontend's, and every
    stream equals the JAX engine's greedy stream."""
    rng = np.random.default_rng(3)
    flood = [rng.integers(0, VOCAB, 8).tolist() for _ in range(6)]
    inter = [rng.integers(0, VOCAB, 8).tolist() for _ in range(2)]
    jmodel = jtf.CausalLM(_cfg(jtf))
    out = {}
    for name, mod in (("jax", j_serving), ("port", t_serving)):
        eng = (JEngine(jmodel, params=weights,
                       config=JConfig(**dict(ENGINE,
                                             max_ragged_sequence_count=1)))
               if mod is j_serving
               else tiny_engine(params, max_ragged_sequence_count=1))
        fe = mod.ServingFrontend([eng], mod.ServingConfig(
            max_queue_depth=64, tenants=TEN))
        try:
            hs = [fe.submit(p, max_new_tokens=2, tenant="alpha")
                  for p in flood]
            hs += [fe.submit(p, max_new_tokens=2, tenant="bravo")
                   for p in inter]
            assert fe.wait_all(hs, timeout=300)
            ranked = sorted(range(len(hs)),
                            key=lambda i: hs[i]._req.admitted_t)
            assert max(ranked.index(6), ranked.index(7)) <= 3, ranked
            snap = fe.metrics.snapshot()
            books = fe.health_report()["tenants"]
            out[name] = {
                "streams": tokens(hs),
                "counters": {k: snap[k] for k in snap
                             if "tenant" in k and not isinstance(snap[k],
                                                                 dict)},
                "books": {t: {k: v for k, v in b.items()
                              if k != "throttled"}
                          for t, b in books.items()}}
            text = fe.health_report_text()
            assert "tenant bravo: w=4" in text
        finally:
            fe.shutdown(drain=False, timeout=5)
    assert out["port"] == out["jax"]
    assert out["port"]["books"]["bravo"]["window_tokens"] == 20.0


def test_kv_budget_routes_around_a_full_replica(params):
    """With a KV budget of 3 blocks a replica, two 17 + 6 token requests
    (3 blocks each) of one tenant dispatched together land on different
    replicas (each replica fits one), and the books clear after."""
    fe = t_serving.ServingFrontend(
        [tiny_engine(params), tiny_engine(params)],
        t_serving.ServingConfig(
            max_queue_depth=16,
            tenants={"a": {"kv_block_budget": 3}}))
    try:
        rng = np.random.default_rng(4)
        hs = [fe.submit(rng.integers(0, VOCAB, 17).tolist(),
                        max_new_tokens=6, tenant="a") for _ in range(2)]
        assert fe.wait_all(hs, timeout=60)
        assert {h._req.replica_id for h in hs} == {0, 1}
        fe.router.tenancy.reconcile()
        assert fe.health_report()["tenants"]["a"]["kv_blocks_used"] == {}
    finally:
        fe.shutdown(drain=False, timeout=5)
