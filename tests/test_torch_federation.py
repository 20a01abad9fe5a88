"""Port parity: frontend federation of ``deepspeed_tpu_torch``
(``serving/fabric/federation.py``) against the JAX package, twin of
``tests/test_federation.py``.

Two-tier serving fleet: a frontend with ``fabric.federation.enabled``
exports a slice of its LOCAL replica pool on ``fabric.listen`` while
adopting peer frontends' exports as routable federated members. Covers the
topology edges (self-peering refusal, wrong hello role, stale-epoch
rejection with newer-epoch supersession, no transitive re-export), the
shared pool (greedy parity through an adopter with and without local
engines, per-peer capacity accounting), cross-frontend failover (the
exporting frontend torn down mid-burst), local evacuation onto a peer,
removal of a federated member, and ``federation`` disabled being the
single-frontend fabric stack. Frontends run in this process over port
engines on the CPU with the JAX ``init(PRNGKey(0))`` weights; every stream
must equal the JAX engine's.
"""

import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.engine_v2 import (
    InferenceEngineV2, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.serving import ServingConfig, ServingFrontend
from deepspeed_tpu_torch.serving.fabric.federation import (FederatedHandle,
                                                           FederationPeer,
                                                           FederationRefused,
                                                           derive_frontend_id)
from deepspeed_tpu_torch.serving.fabric.transport import FabricError, dial

import jax

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.testing import \
    greedy_generate as j_greedy_generate
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
import torch_cpu  # noqa: F401  (one torch thread: see the module)

VOCAB = 128
MODEL_KW = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=2, max_seq_len=256, norm="rmsnorm",
                activation="silu", position="rope")
ENGINE_KW = dict(max_ragged_batch_size=128, max_ragged_sequence_count=4,
                 max_chunk_tokens=32, kv_blocks=64, kv_block_size=8,
                 max_tracked_sequences=32)
SEED = 0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny CPU ops run on one thread here: beside other test
    workers, torch's default of a thread per core oversubscribes the
    machine."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _key(model_kw, seed):
    return tuple(sorted(model_kw.items())), seed


_weights = {}
_params = {}
_oracles = {}


def jax_weights(model_kw=MODEL_KW, seed=SEED):
    """The JAX package's ``init(PRNGKey(seed))`` weights, as numpy."""
    key = _key(model_kw, seed)
    if key not in _weights:
        jp = jtf.CausalLM(jtf.TransformerConfig(**model_kw)).init(
            jax.random.PRNGKey(seed))
        _weights[key] = jax.tree.map(np.asarray, jp)
    return _weights[key]


def tiny_engine(i=0, model_kw=MODEL_KW, seed=SEED, **cfg_over):
    """Fresh port engine on the CPU over the JAX weights (one shared
    tensor tree a model), so its streams are the JAX engine's."""
    key = _key(model_kw, seed)
    if key not in _params:
        _params[key] = params_from_numpy(jax_weights(model_kw, seed),
                                         device="cpu")
    base = dict(ENGINE_KW)
    base.update(cfg_over)
    return InferenceEngineV2(ttf.CausalLM(ttf.TransformerConfig(**model_kw)),
                             params=_params[key],
                             config=RaggedInferenceEngineConfig(**base),
                             device="cpu")


def local_reference(ps, max_new, n_replicas=1, kv_quant=None,
                    model_kw=MODEL_KW, seed=SEED):
    """The JAX engine's greedy streams for ``ps`` (``max_new`` tokens
    each; ``kv_quant`` its KV dtype), one engine a configuration."""
    key = (kv_quant,) + _key(model_kw, seed)
    if key not in _oracles:
        over = ({} if kv_quant is None
                else {"kv_quant_enabled": True, "kv_quant_dtype": kv_quant})
        _oracles[key] = [JEngine(
            jtf.CausalLM(jtf.TransformerConfig(**model_kw)),
            params=jax_weights(model_kw, seed),
            config=JConfig(max_ragged_batch_size=256,
                           max_ragged_sequence_count=16,
                           max_chunk_tokens=32, kv_blocks=512,
                           kv_block_size=8, max_tracked_sequences=64,
                           **over)), 0]
    eng = _oracles[key]
    out = j_greedy_generate(eng[0], [list(p) for p in ps], uid_base=eng[1],
                            max_new_tokens=max_new, sequential=False)
    eng[1] += len(ps)
    return [list(o) for o in out]


def prompts(n, seed, lo=8, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(length)).tolist()
            for length in rng.integers(lo, hi, size=n)]


def run_fleet(fe, ps, max_new, timeout=300):
    hs = [fe.submit(p, max_new_tokens=max_new) for p in ps]
    assert fe.wait_all(hs, timeout=timeout), [h.state for h in hs]
    return [[ev.token for ev in h.drain()] for h in hs]


def fed_cfg(peers=(), heartbeat_s=0.3, federation_extra=None, **extra):
    fed = {"enabled": True, "peers": list(peers)}
    fed.update(federation_extra or {})
    return ServingConfig(
        max_queue_depth=64,
        fabric={"enabled": True, "listen": "127.0.0.1:0",
                "heartbeat_s": heartbeat_s, "rpc_timeout_s": 60.0,
                "federation": fed},
        **extra)


def federated_rid(fe):
    return next(r.replica_id for r in fe.router.replicas
                if getattr(r, "is_federated", False))


# ======================================================== peering edges
class TestPeeringEdges:
    def test_self_peering_refused_typed(self):
        fe = ServingFrontend([tiny_engine(0)], fed_cfg())
        try:
            peer = FederationPeer(fe.federation_address, fe.config.fabric,
                                  frontend_id=fe._federation_id,
                                  epoch=fe._federation_epoch + 5)
            with pytest.raises(FederationRefused, match="self_peering"):
                peer.connect()
        finally:
            fe.shutdown(drain=False, timeout=5)

    def test_replica_role_hello_refused(self):
        """The federation listener speaks hello role 'frontend' only —
        a replica-shaped hello (e.g. a misconfigured fabric.peers entry
        pointing at a federation listener) is refused typed."""
        fe = ServingFrontend([tiny_engine(0)], fed_cfg())
        try:
            conn = dial(fe.federation_address, timeout_s=10.0,
                        max_frame_bytes=1 << 20, heartbeat_s=0.3,
                        name="test-bad-role")
            try:
                from deepspeed_tpu_torch.serving.fabric.codec import CODEC_VERSION
                with pytest.raises(FabricError, match="federation_role:"):
                    conn.call("hello", {"codec_version": CODEC_VERSION,
                                        "replica_id": 0, "role": "mixed",
                                        "model_id": "default"},
                              timeout_s=10.0)
            finally:
                conn.close("test done")
        finally:
            fe.shutdown(drain=False, timeout=5)

    def test_stale_epoch_rejected_newer_supersedes(self):
        fe = ServingFrontend([tiny_engine(0)], fed_cfg())
        try:
            fab = fe.config.fabric
            addr = fe.federation_address
            first = FederationPeer(addr, fab, frontend_id="edge-X",
                                   epoch=100)
            first.connect()
            assert first.peer_id == fe._federation_id
            assert len(first.exports) == 1

            stale = FederationPeer(addr, fab, frontend_id="edge-X",
                                   epoch=50)
            with pytest.raises(FederationRefused, match="stale_epoch"):
                stale.connect()
            assert first.alive, "a refused zombie must not hurt the live peer"

            newer = FederationPeer(addr, fab, frontend_id="edge-X",
                                   epoch=200)
            newer.connect()
            deadline = time.monotonic() + 10
            while first.alive and time.monotonic() < deadline:
                time.sleep(0.05)
            assert not first.alive, \
                "a newer epoch must supersede the old connection"
            assert newer.alive
            newer.close()
            first.close()
        finally:
            fe.shutdown(drain=False, timeout=5)

    def test_no_transitive_reexport(self):
        """Adopted capacity is never re-exported: a frontend that itself
        adopted a peer's replica exports only its OWN locals — routing
        loops are impossible by construction."""
        fe_a = ServingFrontend([tiny_engine(0)], fed_cfg())
        fe_b = None
        try:
            fe_b = ServingFrontend([tiny_engine(1)],
                                   fed_cfg(peers=[fe_a.federation_address]))
            assert sum(1 for r in fe_b.router.replicas
                       if getattr(r, "is_federated", False)) == 1
            probe = FederationPeer(fe_b.federation_address,
                                   fe_b.config.fabric,
                                   frontend_id=derive_frontend_id(),
                                   epoch=1)
            probe.connect()
            assert len(probe.exports) == 1, \
                "B must export only its local replica, not A's"
            assert probe.exports[0]["export"] == 0
            probe.close()
        finally:
            if fe_b is not None:
                fe_b.shutdown(drain=False, timeout=5)
            fe_a.shutdown(drain=False, timeout=5)


# ========================================================== shared pool
class TestSharedPool:
    def test_two_frontend_parity_and_observability(self):
        ps = prompts(6, 31)
        ref = local_reference(ps, 8)
        fe_exp = ServingFrontend([tiny_engine(0)], fed_cfg())
        fe_adp = None
        try:
            fe_adp = ServingFrontend(
                [tiny_engine(1)], fed_cfg(peers=[fe_exp.federation_address]))
            got = run_fleet(fe_adp, ps, 8)
            assert got == ref, "federated pool broke greedy parity"
            snap = fe_adp.metrics_snapshot()
            assert snap["requests_federated"] >= 1
            kinds = [e["kind"] for e in fe_exp.journal.events()]
            assert "peer_connected" in kinds
            assert "replica_exported" in kinds
            # the ~1/s observability tick publishes the deduped peer
            # count on BOTH sides (adopter: dialed; exporter: adopted-by)
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if (fe_adp.metrics_snapshot().get("federation_peers")
                        == 1.0
                        and fe_exp.metrics_snapshot()
                        .get("federation_peers") == 1.0):
                    break
                time.sleep(0.1)
            assert fe_adp.metrics_snapshot()["federation_peers"] == 1.0
            assert fe_exp.metrics_snapshot()["federation_peers"] == 1.0
        finally:
            if fe_adp is not None:
                fe_adp.shutdown(drain=False, timeout=5)
            fe_exp.shutdown(drain=False, timeout=5)

    def test_adopter_without_local_engines(self):
        """An edge frontend with NO local chips serves entirely off the
        shared pool — and the status stream's ``active_total`` reaches
        its capacity probe."""
        ps = prompts(3, 32, lo=8, hi=12)
        ref = local_reference(ps, 40)
        # the port's CPU engine decodes 40 tokens faster than one status
        # tick (0.25 s): pace the exporter's puts so the streams are still
        # running when a tick reports the seats they hold
        engine = tiny_engine(0)
        put = engine.put

        def paced_put(*a, **kw):
            time.sleep(0.01)
            return put(*a, **kw)

        engine.put = paced_put
        fe_exp = ServingFrontend([engine], fed_cfg())
        fe_adp = None
        try:
            fe_adp = ServingFrontend(
                [], fed_cfg(peers=[fe_exp.federation_address]))
            handle = fe_adp.router.replica_by_id(federated_rid(fe_adp))
            hs = [fe_adp.submit(p, max_new_tokens=40) for p in ps]
            deadline = time.monotonic() + 60
            seen_total = 0
            while time.monotonic() < deadline and seen_total == 0:
                seen_total = handle._last_active_total
                time.sleep(0.01)
            assert fe_adp.wait_all(hs, timeout=120), [h.state for h in hs]
            got = [[ev.token for ev in h.drain()] for h in hs]
            assert got == ref
            assert seen_total >= 1, \
                "status stream never published the exporter's seat usage"
        finally:
            if fe_adp is not None:
                fe_adp.shutdown(drain=False, timeout=5)
            fe_exp.shutdown(drain=False, timeout=5)

    def test_capacity_accounting(self):
        """The adopter's capacity probe honors the exporter's TOTAL seat
        usage (shared with its local traffic) and the per-peer inflight
        cap."""
        fe_exp = ServingFrontend([tiny_engine(0)], fed_cfg())
        fe_adp = None
        try:
            fe_adp = ServingFrontend(
                [], fed_cfg(peers=[fe_exp.federation_address],
                            federation_extra={"peer_max_inflight": 2}))
            handle = fe_adp.router.replica_by_id(federated_rid(fe_adp))
            assert isinstance(handle, FederatedHandle)
            seats = handle.engine.config.max_ragged_sequence_count
            assert handle.has_capacity
            handle._last_active_total = seats
            assert not handle.has_capacity, \
                "exporter-side saturation must gate the adopter's probe"
            handle._last_active_total = 0
            assert handle.has_capacity

            class _BusyPeer:
                def inflight(self):
                    return 2
            real_peer = handle._peer
            handle._peer = _BusyPeer()
            assert not handle.has_capacity, \
                "peer_max_inflight must cap every mirror from one peer"
            handle._peer = real_peer
            assert handle.has_capacity
        finally:
            if fe_adp is not None:
                fe_adp.shutdown(drain=False, timeout=5)
            fe_exp.shutdown(drain=False, timeout=5)


# ============================================== cross-frontend failover
class TestCrossFrontendFailover:
    def test_exporter_torn_down_mid_burst(self):
        """The exporting frontend goes away mid-decode (its listener and
        every federation connection close): each in-flight federated
        stream fails over to the adopter's local replica and resumes
        byte-losslessly."""
        ps = prompts(4, 33, lo=8, hi=12)
        ref = local_reference(ps, 96)
        fe_exp = ServingFrontend([tiny_engine(0)], fed_cfg())
        fe = None
        try:
            fe = ServingFrontend(
                [tiny_engine(1)],
                fed_cfg(peers=[fe_exp.federation_address],
                        fault_tolerance={"enabled": True, "max_retries": 3,
                                         "restart_backoff_s": 0.1}))
            fed_rid = federated_rid(fe)
            hs = [fe.submit(p, max_new_tokens=96) for p in ps]
            deadline = time.monotonic() + 90
            live = False
            while time.monotonic() < deadline and not live:
                live = any(h._req.replica_id == fed_rid
                           and h._req.n_generated >= 2 for h in hs)
                time.sleep(0.002)
            assert live, "no stream ever ran on the federated replica"
            fe_exp.shutdown(drain=False, timeout=5)
            assert fe.wait_all(hs, timeout=180), [h.state for h in hs]
            got = [[ev.token for ev in h.drain()] for h in hs]
            snap = fe.metrics_snapshot()
        finally:
            if fe is not None:
                fe.shutdown(drain=False, timeout=5)
            fe_exp.shutdown(drain=False, timeout=5)
        assert got == ref, "cross-frontend failover broke byte parity"
        assert snap["requests_failed_over"] >= 1


# =========================================================== evacuation
class TestFederatedEvacuation:
    def test_local_drain_onto_peer(self):
        """Removing the adopter's local replica drains its in-flight
        streams onto the PEER's exported replica — the autoscaler's
        drain-onto-peers shutdown path, byte-lossless."""
        ps = prompts(2, 34, lo=8, hi=12)
        ref = local_reference(ps, 96)
        fe_exp = ServingFrontend([tiny_engine(0)], fed_cfg())
        fe_adp = None
        try:
            fe_adp = ServingFrontend(
                [tiny_engine(1)],
                fed_cfg(peers=[fe_exp.federation_address],
                        fault_tolerance={"enabled": True,
                                         "max_retries": 3}))
            local_rid = next(r.replica_id for r in fe_adp.router.replicas
                             if not getattr(r, "is_remote", False))
            hs = [fe_adp.submit(p, max_new_tokens=96) for p in ps]
            deadline = time.monotonic() + 60
            live = False
            while time.monotonic() < deadline and not live:
                live = any(h._req.replica_id == local_rid
                           and h._req.n_generated >= 2 for h in hs)
                time.sleep(0.002)
            assert live, "no stream ever ran on the local replica"
            assert fe_adp.remove_replica(local_rid, timeout_s=30.0)
            assert fe_adp.wait_all(hs, timeout=120), [h.state for h in hs]
            got = [[ev.token for ev in h.drain()] for h in hs]
            snap = fe_adp.metrics_snapshot()
        finally:
            if fe_adp is not None:
                fe_adp.shutdown(drain=False, timeout=5)
            fe_exp.shutdown(drain=False, timeout=5)
        assert got == ref, "drain-onto-peer broke byte parity"
        assert snap["requests_evacuated"] >= 1

    def test_remove_federated_member_requeues_mirrors(self):
        """Removing a FEDERATED member evacuates only the adopter's
        mirrors (the exporter's shared replica keeps serving its own
        traffic) and the mirrors resume locally, byte-lossless."""
        ps = prompts(2, 35, lo=8, hi=12)
        ref = local_reference(ps, 96)
        fe_exp = ServingFrontend([tiny_engine(0)], fed_cfg())
        fe_adp = None
        try:
            fe_adp = ServingFrontend(
                [tiny_engine(1)],
                fed_cfg(peers=[fe_exp.federation_address],
                        fault_tolerance={"enabled": True,
                                         "max_retries": 3}))
            fed_rid = federated_rid(fe_adp)
            hs = [fe_adp.submit(p, max_new_tokens=96) for p in ps]
            deadline = time.monotonic() + 60
            live = False
            while time.monotonic() < deadline and not live:
                live = any(h._req.replica_id == fed_rid
                           and h._req.n_generated >= 2 for h in hs)
                time.sleep(0.002)
            assert live, "no stream ever ran on the federated replica"
            # the exporter's shared replica keeps running, so the drain
            # wait (on its worker's exit) always runs to its timeout, in
            # both packages: a short one keeps the test short
            assert fe_adp.remove_replica(fed_rid, timeout_s=2.0)
            assert fe_adp.wait_all(hs, timeout=120), [h.state for h in hs]
            got = [[ev.token for ev in h.drain()] for h in hs]
        finally:
            if fe_adp is not None:
                fe_adp.shutdown(drain=False, timeout=5)
            fe_exp.shutdown(drain=False, timeout=5)
        assert got == ref, "federated-member removal broke byte parity"


# ====================================================== disabled parity
class TestDisabledParity:
    def test_disabled_is_single_frontend_stack(self):
        """``federation`` absent = byte-for-byte the historical fabric
        stack: no identity, no listener, no federation observability."""
        ps = prompts(6, 36)
        plain = ServingFrontend([tiny_engine(0)],
                                ServingConfig(max_queue_depth=64))
        try:
            ref = run_fleet(plain, ps, 8)
        finally:
            plain.shutdown(drain=False, timeout=5)

        fe = ServingFrontend(
            [tiny_engine(1)],
            ServingConfig(max_queue_depth=64, fabric={"enabled": True}))
        try:
            assert fe._federation is None
            assert fe._federation_server is None
            assert fe.federation_address is None
            assert fe._federation_peers == []
            got = run_fleet(fe, ps, 8)
            snap = fe.metrics_snapshot()
            kinds = {e["kind"] for e in fe.journal.events()}
        finally:
            fe.shutdown(drain=False, timeout=5)
        assert got == ref, "disabled federation changed tokens"
        assert snap.get("requests_federated", 0) == 0
        assert not kinds & {"peer_connected", "peer_lost",
                            "replica_exported"}
