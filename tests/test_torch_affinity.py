"""Port parity: prefix-affinity routing and warm-up
(``deepspeed_tpu_torch/serving/affinity.py``) against the JAX package's.

``chain_hashes`` must give exactly the keys both packages' prefix indexes
hold (``DSStateManager.record_tokens``): checked on served prompts against
each engine's digest, and the two engines' digests against each other
after the same traffic. ``AffinityState.choose`` and the router's pick run
over each package's modules on the same fake replicas and return their
picks and tallies, which must be equal (the cases of
``tests/test_affinity.py``: steering, fallbacks, the leading-run rule, the
load overruling a small credit, the share cap, sick replicas).

Frontend cases serve the model of ``tests/test_torch_serving_load.py``
(vocab 128, hidden 64, 2 layers; the JAX ``init(PRNGKey(0))`` weights x3)
with the prefix cache on: every stream equals the JAX engine's greedy
stream byte for byte, affinity on accrues hits, and ``add_replica`` warms
the new replica from the fleet so that its first shared-prefix request
matches the warmed blocks.
"""

import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.serving as j_serving
import deepspeed_tpu.serving.affinity as j_affinity
import deepspeed_tpu.serving.config as j_config
import deepspeed_tpu.serving.replica as j_replica
import deepspeed_tpu.serving.router as j_router
import deepspeed_tpu_torch.serving as t_serving
import deepspeed_tpu_torch.serving.affinity as t_affinity
import deepspeed_tpu_torch.serving.config as t_config
import deepspeed_tpu_torch.serving.replica as t_replica
import deepspeed_tpu_torch.serving.router as t_router
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.testing import \
    greedy_generate as j_greedy_generate
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.testing import greedy_generate
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
import torch_cpu  # noqa: F401  (one torch thread: see the module)

VOCAB = 128
BS = 8
ENGINE = dict(max_ragged_batch_size=128, max_ragged_sequence_count=4,
              max_chunk_tokens=32, kv_blocks=64, kv_block_size=BS,
              max_tracked_sequences=32, enable_prefix_cache=True)

JAX = SimpleNamespace(S=j_serving, A=j_affinity, C=j_config,
                      State=j_replica.ReplicaState, Router=j_router)
PORT = SimpleNamespace(S=t_serving, A=t_affinity, C=t_config,
                       State=t_replica.ReplicaState, Router=t_router)


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


# ------------------------------------------------------------- scoring
def rep(rid, load=0):
    return SimpleNamespace(replica_id=rid, outstanding_tokens=load)


def cost(r):
    return (r.outstanding_tokens, r.replica_id)


def aff(ns, **over):
    base = dict(enabled=True, share_window=8, max_share=0.5,
                refresh_interval_s=1e-9)
    base.update(over)
    return ns.A.AffinityState(ns.C.AffinityConfig(**base))


def sreq(ns, toks):
    return ns.S.ServingRequest(list(toks), max_new_tokens=4, priority=1,
                               deadline_s=None, eos_token_id=None)


@both
def test_chain_hashes_shapes(ns):
    return [ns.A.chain_hashes(list(range(n)), bs)
            for n, bs in ((0, 8), (8, 8), (16, 8), (17, 8), (33, 8),
                          (40, 16), (65, 16))]


@both
def test_choose_steers_and_falls_back(ns):
    p = list(range(24))
    hashes = ns.A.chain_hashes(p, BS)
    out = []
    a = aff(ns)
    a._digests = {1: frozenset(hashes)}
    out.append(a.choose(sreq(ns, p), [rep(0), rep(1)], cost, BS).replica_id)
    out.append(a.stats())
    b = aff(ns)
    out.append(b.choose(sreq(ns, p), [rep(0), rep(1)], cost, BS))
    b._digests = {0: frozenset([1, 2, 3])}
    out.append(b.choose(sreq(ns, range(BS)), [rep(0)], cost, BS))
    out.append(b.stats())
    c = aff(ns)
    p33 = list(range(33))
    c._digests = {1: frozenset(ns.A.chain_hashes(p33, BS)[1:])}
    out.append(c.choose(sreq(ns, p33), [rep(0), rep(1)], cost, BS))
    d = aff(ns)
    p12 = list(range(12))
    d._digests = {1: frozenset(ns.A.chain_hashes(p12, BS))}
    out.append(d.choose(sreq(ns, p12), [rep(0, 0), rep(1, 1000)], cost,
                        BS).replica_id)
    out.append(d.stats())
    out.append(d.choose(sreq(ns, p12), [rep(0, 0), rep(1, 1000)], cost, BS,
                        prefill_token_cost=200.0).replica_id)
    return out


@both
def test_share_cap_diverts_to_second_warmest(ns):
    a = aff(ns, share_window=8, max_share=0.5)
    p = list(range(24))
    hashes = ns.A.chain_hashes(p, BS)
    a._digests = {1: frozenset(hashes), 2: frozenset(hashes[:1])}
    reps = [rep(0), rep(1), rep(2)]
    picks = [a.choose(sreq(ns, p), reps, cost, BS).replica_id
             for _ in range(10)]
    assert picks[:4] == [1, 1, 1, 1]
    return picks, a.share_counts(), a.stats()


@both
def test_refresh_tolerates_sick_replicas(ns):
    a = aff(ns)

    class Sick:
        replica_id = 0

        def prefix_digest(self, n):
            raise RuntimeError("transport down")

    warm = SimpleNamespace(replica_id=1,
                           prefix_digest=lambda n: frozenset([7, 8]))
    bare = SimpleNamespace(replica_id=2)
    a.refresh([Sick(), warm, bare], now=1.0)
    return [a.digest_of(i) for i in range(3)]


class FakeReplica:
    """Enough surface for ``ReplicaRouter.pick``."""

    def __init__(self, ns, rid, load=0, digest=()):
        self.replica_id = rid
        self.model_id = "default"
        self.role = "mixed"
        self.engine = SimpleNamespace(
            config=SimpleNamespace(kv_block_size=BS))
        self.state = ns.State.HEALTHY
        self._healthy = ns.State.HEALTHY
        self.outstanding_tokens = load
        self.outstanding_prefill_tokens = load
        self.outstanding_decode_tokens = 0
        self.accepting = True
        self.has_capacity = True
        self._digest = frozenset(digest)

    def check_health(self):
        return self._healthy

    def prefix_digest(self, max_entries=512):
        return self._digest


@both
def test_router_pick_with_and_without_affinity(ns):
    p = list(range(24))
    warm = ns.A.chain_hashes(p, BS)
    out = []
    reps = [FakeReplica(ns, 0, load=10, digest=warm),
            FakeReplica(ns, 1, load=0)]
    plain = ns.Router.ReplicaRouter(reps, ns.S.AdmissionQueue(64))
    out.append(plain.pick(sreq(ns, p)).replica_id)
    reps = [FakeReplica(ns, 0, load=5),
            FakeReplica(ns, 1, load=5, digest=warm)]
    a = aff(ns)
    a.refresh(reps, now=1.0)
    router = ns.Router.ReplicaRouter(reps, ns.S.AdmissionQueue(64),
                                     affinity=a)
    out.append(router.pick(sreq(ns, p)).replica_id)
    out.append(router.pick(sreq(ns, range(4))).replica_id)
    out.append(router.pick().replica_id)
    out.append(a.stats())
    return out


# ------------------------------------------------------------- engines
@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(mod):
    return mod.TransformerConfig(vocab_size=VOCAB, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=2, max_seq_len=256, norm="rmsnorm",
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
def jax_engine(weights):
    return JEngine(jtf.CausalLM(_cfg(jtf)), params=weights,
                   config=JConfig(**ENGINE))


def tiny_engine(params, **over):
    return InferenceEngineV2(ttf.CausalLM(_cfg(ttf)), params=params,
                             config=RaggedInferenceEngineConfig(
                                 **dict(ENGINE, **over)), device="cpu")


def shared_prompts(n, seed, shared_len=24, tail=6):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, VOCAB, size=shared_len).tolist()
    return [shared + rng.integers(0, VOCAB, size=tail).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def reference(jax_engine):
    """JAX greedy streams (8 tokens) of the frontend cases' prompts, from
    one JAX engine, computed once."""
    ps = sum((shared_prompts(n, s) for n, s in ((3, 5), (8, 6), (6, 7))),
             [])
    out = j_greedy_generate(jax_engine, ps, uid_base=5000, max_new_tokens=8,
                            sequential=False)
    table = dict(zip(map(tuple, ps), out))
    return lambda qs, n: [table[tuple(q)][:n] for q in qs]


def test_chain_hashes_are_both_index_keys(params, jax_engine):
    """The same prompts through a port engine and a JAX engine (prefix
    cache on, one at a time): ``chain_hashes`` of each prompt is a subset
    of both digests, both digests are equal (MRU first), and the port's
    index keys hash to exactly the chain of its recorded prompts."""
    rng = np.random.default_rng(1)
    ps = [list(range(30)), rng.integers(0, VOCAB, 33).tolist(),
          rng.integers(0, VOCAB, 17).tolist(), list(range(16))]
    eng = tiny_engine(params)
    greedy_generate(eng, ps, max_new_tokens=4, uid_base=100)
    j_greedy_generate(jax_engine, ps, max_new_tokens=4, uid_base=100)
    digest, jdigest = eng.prefix_digest(), jax_engine.prefix_digest()
    assert digest == jdigest
    for p in ps:
        want = t_affinity.chain_hashes(p, BS)
        assert want == j_affinity.chain_hashes(p, BS)
        assert set(want) <= set(digest)
    keys = {hash(k) for k in eng.state_manager._index}
    assert keys == set(digest)


def test_warmup_round_trip_preserves_streams(params, reference):
    """A replica warmed from a donor's exported blocks reports the donor's
    chain hashes, takes prefix hits on the donor's traffic, and gives the
    JAX engine's greedy streams; a second import dedups to 0 and a
    cache-off engine imports nothing."""
    ps = shared_prompts(3, 5)
    donor = tiny_engine(params)
    ref = greedy_generate(donor, ps, max_new_tokens=5)
    assert ref == reference(ps, 5)
    entries = donor.export_prefix_blocks(max_blocks=32)
    assert entries
    warmed = tiny_engine(params)
    assert warmed.prefix_digest() == []
    assert warmed.import_prefix_blocks(entries) == len(entries)
    assert set(warmed.prefix_digest()) >= {hash(k) for k, _ in entries}
    got = greedy_generate(warmed, ps, max_new_tokens=5, uid_base=100)
    assert got == ref
    assert warmed.prefix_stats()["tokens_saved"] > 0
    assert warmed.import_prefix_blocks(entries) == 0
    cold = tiny_engine(params, enable_prefix_cache=False)
    assert cold.import_prefix_blocks(entries) == 0


# ------------------------------------------------------------- frontend
def serving_cfg(enabled=True, **over):
    a = dict(enabled=enabled, refresh_interval_s=0.05, warmup_enabled=True,
             warmup_max_blocks=16)
    a.update(over)
    return t_serving.ServingConfig(num_replicas=2, max_queue_depth=64,
                                   affinity=a)


def run(fe, ps, n=8):
    hs = [fe.submit(p, max_new_tokens=n) for p in ps]
    assert fe.wait_all(hs, timeout=120), [h.state for h in hs]
    return [[ev.token for ev in h.drain()] for h in hs]


def test_disabled_builds_none_of_it(params, reference):
    fe = t_serving.ServingFrontend.from_engine_factory(
        lambda i: tiny_engine(params), serving_cfg(enabled=False))
    try:
        assert fe._affinity is None and fe.router.affinity is None
        assert fe.fleet_signals().predicted_queue_depth is None
        ps = shared_prompts(3, 5)
        assert run(fe, ps) == reference(ps, 8)
        assert fe.metrics.snapshot().get("router_affinity_hits", 0) == 0
        fe.add_replica()
        assert not [e for e in fe.journal.events()
                    if e["kind"] == "replica_warmup"]
    finally:
        fe.shutdown(drain=False, timeout=5)


def test_enabled_hits_keep_streams(params, reference):
    """Affinity changes placement, never tokens: the streams are the JAX
    engine's on both passes, and the second pass over refreshed digests
    accrues hits counted in the registry; the share cap holds."""
    ps = shared_prompts(8, 6)
    fe = t_serving.ServingFrontend.from_engine_factory(
        lambda i: tiny_engine(params), serving_cfg())
    try:
        assert fe.router.affinity is fe._affinity is not None
        assert run(fe, ps) == reference(ps, 8)
        deadline = time.monotonic() + 30     # a router tick refreshes
        while not all(fe._affinity.digest_of(r.replica_id)
                      for r in fe.router.replicas) \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert run(fe, ps) == reference(ps, 8)
        st = fe._affinity.stats()
        assert st["hits"] > 0 and st["tokens_saved"] > 0, st
        snap = fe.metrics.snapshot()
        assert snap["router_affinity_hits"] == st["hits"]
        assert snap["prefix_tokens_saved_fleet"] == st["tokens_saved"]
        cap = fe.config.affinity.max_share * fe._affinity._recent.maxlen
        assert all(c <= cap for c in fe._affinity.share_counts().values())
        # a snapshot a bucket later gives the window a rate
        fe.windowed.tick(time.monotonic() + fe.windowed.bucket_s)
        sig = fe.fleet_signals()
        assert sig.predicted_queue_depth is not None
        assert sig.predicted_queue_depth >= 0
        assert snap["predicted_load"] == 0.0
        assert fe.metrics.snapshot()["predicted_load"] \
            == sig.predicted_queue_depth
    finally:
        fe.shutdown(drain=False, timeout=5)


def test_add_replica_warms_and_first_request_matches(params, reference):
    """After shared-prefix traffic, ``add_replica()`` warms the new replica
    from the fleet (a ``replica_warmup`` event with blocks > 0, balanced
    warming gauge); with the old replicas removed, the new replica's first
    shared-prefix request matches the warmed blocks and keeps the JAX
    stream. With warm-up off the grown replica starts cold."""
    ps = shared_prompts(6, 7)
    fe = t_serving.ServingFrontend.from_engine_factory(
        lambda i: tiny_engine(params), serving_cfg())
    try:
        assert run(fe, ps[:4]) == reference(ps[:4], 8)
        rid = fe.add_replica()
        evs = [e for e in fe.journal.events()
               if e["kind"] == "replica_warmup"]
        assert [e["detail"]["replica"] for e in evs] == [rid]
        assert evs[0]["detail"]["blocks"] > 0
        assert evs[0]["detail"]["source"]
        new = fe.router.replica_by_id(rid)
        assert len(new.prefix_digest()) > 0
        snap = fe.metrics.snapshot()
        assert snap["replica_warmup_s"]["count"] == 1
        assert snap["replicas_warming"] == 0
        fe.remove_replica(0)
        fe.remove_replica(1)
        assert run(fe, ps[4:5]) == reference(ps[4:5], 8)
        stats = new.engine.prefix_stats()
        assert stats["hits"] >= 3 and stats["tokens_saved"] >= 24, stats
    finally:
        fe.shutdown(drain=False, timeout=5)
    off = t_serving.ServingFrontend.from_engine_factory(
        lambda i: tiny_engine(params), serving_cfg(warmup_enabled=False))
    try:
        run(off, ps[:4])
        rid = off.add_replica()
        assert not [e for e in off.journal.events()
                    if e["kind"] == "replica_warmup"]
        assert off.router.replica_by_id(rid).prefix_digest() == frozenset()
    finally:
        off.shutdown(drain=False, timeout=5)


def test_warmup_export_error_starts_cold(params, reference):
    """A donor export raising ``RuntimeError`` leaves the grown replica
    cold (no journal event) and the grow succeeds; a ``TypeError`` fails
    the grow and leaves the fleet as it was (the JAX frontend swallows
    both)."""
    ps = shared_prompts(3, 5)
    fe = t_serving.ServingFrontend.from_engine_factory(
        lambda i: tiny_engine(params), serving_cfg())
    try:
        run(fe, ps)
        for r in fe.router.replicas:
            def failing(n, _e=RuntimeError):
                raise _e("export failed")
            r.engine.export_prefix_blocks = failing
        rid = fe.add_replica()
        assert fe.router.replica_by_id(rid).prefix_digest() == frozenset()
        assert not [e for e in fe.journal.events()
                    if e["kind"] == "replica_warmup"]
        for r in fe.router.replicas:
            def broken(n):
                raise TypeError("not a fallback")
            r.engine.export_prefix_blocks = broken
        n = len(fe.router.replicas)
        with pytest.raises(TypeError):
            fe.add_replica()
        assert len(fe.router.replicas) == n
        assert fe.metrics.snapshot()["replicas_warming"] == 0
    finally:
        fe.shutdown(drain=False, timeout=5)
