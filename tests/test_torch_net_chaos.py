"""Port parity: fleet chaos engineering of ``deepspeed_tpu_torch``
(``serving/fabric/chaos.py`` and what it drills), twin of
``tests/test_net_chaos.py``, plus the twin of
``tests/test_fleet_obs.py::TestFabricTracePropagation``.

The network fault injector as a unit (seeded determinism, the fired
ledger, link matching, every fault pipeline), gray-failure quarantine
(rolling RPC-latency scoring, probe re-admission, escalation) and its
composition with the autoscaler, affinity routing and federation,
reconnect-storm protection (full-jitter backoff, the dial-concurrency
gate), CRC frame-sealing negotiation, partition-tolerant federation seat
leases, the ``chaos`` config block, and cross-process trace propagation
(server spans stitched into the frontend's chains, forwarded journals,
forwarded counters monotonic across a replica swap). Servers and
frontends run in this process over port engines on the CPU with the JAX
``init(PRNGKey(0))`` weights; every stream must equal the JAX engine's.
"""

import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.engine_v2 import (
    InferenceEngineV2, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.serving import (RequestState, ServingConfig,
                                         ServingFrontend)
from deepspeed_tpu_torch.serving.fabric import chaos as fchaos
from deepspeed_tpu_torch.serving.fabric import codec as fcodec
from deepspeed_tpu_torch.serving.fabric import federation as ffederation
from deepspeed_tpu_torch.serving.fabric import transport as ftransport
from deepspeed_tpu_torch.serving.fabric.chaos import (ChaosKill,
                                                      NetworkFaultInjector)
from deepspeed_tpu_torch.serving.fabric.server import ReplicaServer
from deepspeed_tpu_torch.serving.replica import ReplicaState
from deepspeed_tpu_torch.telemetry import validate_chrome_trace
from deepspeed_tpu_torch.telemetry.fleet import fleet_chrome_trace
from deepspeed_tpu_torch.utils.restart import RestartPolicy

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


class _Servers:
    def __init__(self, n, server_config=None, heartbeat_s=0.3, **eng_over):
        self.servers = [
            ReplicaServer(lambda i=i: tiny_engine(i, **eng_over),
                          server_config or ServingConfig(),
                          listen="127.0.0.1:0", replica_id=i,
                          heartbeat_s=heartbeat_s)
            for i in range(n)]
        for s in self.servers:
            s.start()
        self.peers = [f"127.0.0.1:{s.port}" for s in self.servers]

    def stop(self):
        for s in self.servers:
            s.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def fabric_cfg(peers, heartbeat_s=0.3, fabric_extra=None, **extra):
    fab = {"enabled": True, "peers": list(peers),
           "heartbeat_s": heartbeat_s, "rpc_timeout_s": 60.0}
    fab.update(fabric_extra or {})
    return ServingConfig(max_queue_depth=64, fabric=fab, **extra)


QUAR = {"enabled": True, "rpc_slow_s": 0.5, "window": 8,
        "min_samples": 4, "slow_fraction": 0.75,
        "probe_backoff_s": 30.0, "probe_backoff_max_s": 60.0,
        "escalate_quarantines": 10, "escalate_window_s": 120.0}


def fed_cfg(peers=(), heartbeat_s=0.2, federation_extra=None,
            fabric_extra=None, **extra):
    fed = {"enabled": True, "peers": list(peers)}
    fed.update(federation_extra or {})
    fab = {"enabled": True, "listen": "127.0.0.1:0",
           "heartbeat_s": heartbeat_s, "rpc_timeout_s": 60.0,
           "federation": fed}
    fab.update(fabric_extra or {})
    return ServingConfig(max_queue_depth=64, fabric=fab, **extra)


class _FakeSock:
    """Collects sendall bytes — enough socket for ChaosLink.send."""

    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


# =========================================================== injector unit
class TestInjectorUnit:
    def test_unknown_kind_and_bad_fields_refused(self):
        with pytest.raises(ValueError, match="unknown kind"):
            NetworkFaultInjector([{"kind": "gremlin"}])
        with pytest.raises(ValueError, match="dir"):
            NetworkFaultInjector([{"kind": "latency", "dir": "sideways"}])
        with pytest.raises(ValueError, match="where"):
            NetworkFaultInjector([{"kind": "corrupt",
                                   "where": "trailer"}])

    def test_attach_link_matching(self):
        inj = NetworkFaultInjector(
            [{"kind": "latency", "link": "fabric-r0", "delay_s": 0.01},
             {"kind": "corrupt", "link": "federation-*"}])
        assert inj.attach("fabric-r0") is not None
        assert inj.attach("fabric-r1") is None
        assert inj.attach("federation-peer-x") is not None
        assert inj.attach("unrelated") is None
        # module-level attach with nothing installed: zero interposition
        assert fchaos.installed() is None
        assert fchaos.attach("fabric-r0") is None

    def test_at_frame_range_draw_is_seeded(self):
        sched = [{"kind": "drop_conn", "at_frame_range": [10, 500]}]
        a = NetworkFaultInjector(sched, seed=7)
        b = NetworkFaultInjector(sched, seed=7)
        assert a.events[0].at_frame == b.events[0].at_frame
        assert 10 <= a.events[0].at_frame <= 500

    def test_blackhole_count_cap_and_ledger(self):
        inj = NetworkFaultInjector(
            [{"kind": "blackhole", "link": "l", "dir": "rx",
              "count": 2}])
        link = inj.attach("l")
        assert link.recv(b"one") == []
        assert link.recv(b"two") == []
        assert link.recv(b"three") == [b"three"]   # count exhausted
        hits = inj.fired("blackhole", "l")
        assert [h[3] for h in hits] == [0, 1]      # frame indices
        assert all(h[2] == "rx" for h in hits)

    def test_at_frame_arms_late(self):
        inj = NetworkFaultInjector(
            [{"kind": "blackhole", "link": "l", "dir": "rx",
              "at_frame": 2}])
        link = inj.attach("l")
        assert link.recv(b"a") == [b"a"]
        assert link.recv(b"b") == [b"b"]
        assert link.recv(b"c") == []               # frame 2 onward

    def test_duplicate_and_reorder_one_way(self):
        inj = NetworkFaultInjector(
            [{"kind": "duplicate", "link": "dup", "dir": "rx",
              "count": 1}])
        link = inj.attach("dup")
        assert link.recv(b"x") == [b"x", b"x"]
        assert link.recv(b"y") == [b"y"]
        inj2 = NetworkFaultInjector(
            [{"kind": "reorder", "link": "ro", "dir": "rx",
              "count": 1}])
        ro = inj2.attach("ro")
        assert ro.recv(b"first") == []             # held
        assert ro.recv(b"second") == [b"second", b"first"]

    def test_corrupt_is_seeded_deterministic(self):
        body = fcodec.encode_frame({"t": "ev",
                                    "a": np.arange(32, dtype=np.int8)})
        outs = []
        for _ in range(2):
            inj = NetworkFaultInjector(
                [{"kind": "corrupt", "link": "c", "dir": "rx"}], seed=3)
            outs.append(inj.attach("c").recv(bytes(body))[0])
        assert outs[0] == outs[1], "same seed must corrupt identically"
        assert outs[0] != body

    def test_drop_conn_paths(self):
        inj = NetworkFaultInjector(
            [{"kind": "drop_conn", "link": "k", "dir": "rx",
              "at_frame": 0}])
        with pytest.raises(ChaosKill):
            inj.attach("k").recv(b"x")
        inj2 = NetworkFaultInjector(
            [{"kind": "drop_conn", "link": "k", "dir": "tx",
              "partial_bytes": 2}])
        sock = _FakeSock()
        with pytest.raises(ChaosKill):
            inj2.attach("k").send(sock, b"abcdef")
        # length prefix promises 6 bytes, only 2 ever arrive
        assert sock.data == b"\x00\x00\x00\x06ab"

    def test_hit_state_shared_across_reconnects(self):
        """A count-capped event must not re-fire on every re-dial of
        the link — hit-state lives on the injector, not the shim."""
        inj = NetworkFaultInjector(
            [{"kind": "blackhole", "link": "l", "dir": "rx",
              "count": 1}])
        first = inj.attach("l")
        assert first.recv(b"a") == []
        second = inj.attach("l")                   # "reconnect"
        assert second.recv(b"b") == [b"b"]


# ========================================================= reconnect storm
class TestReconnectStorm:
    def test_full_jitter_spreads_over_whole_interval(self):
        pol = RestartPolicy(backoff_s=1.0, backoff_max_s=8.0, jitter=0.2,
                            max_failures_in_window=100, window_s=1e6,
                            rng=random.Random(42), full_jitter=True)
        ref = random.Random(42)
        t = 0.0
        for n in range(1, 8):
            _, backoff = pol.record_failure(t)
            raw = min(1.0 * (2 ** (n - 1)), 8.0)
            assert backoff == raw * ref.random()
            assert 0.0 <= backoff <= raw
            t += 10.0

    def test_proportional_jitter_unchanged_by_default(self):
        pol = RestartPolicy(backoff_s=1.0, backoff_max_s=8.0, jitter=0.2,
                            max_failures_in_window=100, window_s=1e6,
                            rng=random.Random(42))
        ref = random.Random(42)
        _, backoff = pol.record_failure(0.0)
        assert backoff == 1.0 * (1.0 + 0.2 * ref.random())
        assert 1.0 <= backoff <= 1.2

    def test_full_jitter_is_seeded_deterministic(self):
        mk = lambda: RestartPolicy(0.5, 30.0, 0.2, 100, 1e6,
                                   random.Random(7), full_jitter=True)
        a, b = mk(), mk()
        seq_a = [a.record_failure(float(i))[1] for i in range(6)]
        seq_b = [b.record_failure(float(i))[1] for i in range(6)]
        assert seq_a == seq_b

    def test_remote_handle_uses_full_jitter(self):
        from deepspeed_tpu_torch.serving.fabric.remote import RemoteHandle

        cfg = fabric_cfg(["127.0.0.1:1"]).fabric
        h = RemoteHandle(0, "127.0.0.1:1", cfg)
        assert h._restart.full_jitter, \
            "fabric re-dials must use full-jitter backoff"

    def test_dial_gate_caps_concurrency(self, monkeypatch):
        active, peak = [0], [0]
        lk = threading.Lock()
        held = []
        lst = socket.socket()
        lst.bind(("127.0.0.1", 0))
        lst.listen(16)
        port = lst.getsockname()[1]
        real_create = socket.create_connection

        def drain_accepts():
            while True:
                try:
                    held.append(lst.accept()[0])
                except OSError:
                    return

        acceptor = threading.Thread(target=drain_accepts, daemon=True)
        acceptor.start()

        def fake_create_connection(addr, timeout=None):
            with lk:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.15)
            with lk:
                active[0] -= 1
            return real_create(("127.0.0.1", port), timeout=timeout)

        monkeypatch.setattr(ftransport.socket, "create_connection",
                            fake_create_connection)
        old = ftransport.DIAL_MAX_CONCURRENT
        ftransport.set_dial_concurrency(2)
        conns = []
        try:
            def one():
                conns.append(ftransport.dial("127.0.0.1:1"))

            threads = [threading.Thread(target=one) for _ in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert peak[0] == 2, \
                f"dial gate leaked: {peak[0]} concurrent connects"
            assert len(conns) == 6
        finally:
            ftransport.set_dial_concurrency(old)
            for c in conns:
                c.close()
            lst.close()
            acceptor.join(timeout=5)
            for s in held:
                s.close()


# ========================================================= CRC negotiation
class TestCrcNegotiation:
    def test_crc_on_by_default_with_parity(self):
        ps = prompts(3, 50)
        ref = local_reference(ps, 5)
        with _Servers(1) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers))
            try:
                h = fe.router.replicas[0]
                assert h._conn.crc_tx and h._conn.crc_rx, \
                    "frame CRC must negotiate on between new peers"
                got = run_fleet(fe, ps, 5)
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got == ref, "CRC sealing broke greedy byte-parity"

    def test_frame_crc_false_is_v1_wire(self):
        ps = prompts(3, 51)
        ref = local_reference(ps, 5)
        with _Servers(1) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers, fabric_extra={"frame_crc": False}))
            try:
                h = fe.router.replicas[0]
                assert not h._conn.crc_tx and not h._conn.crc_rx, \
                    "frame_crc: false must never advertise sealing"
                got = run_fleet(fe, ps, 5)
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got == ref


# ============================================================== quarantine
class TestQuarantine:
    def test_slow_rpcs_fire_quarantine_then_probe_readmits(self):
        with _Servers(1, heartbeat_s=0.2) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers, heartbeat_s=0.2,
                fabric_extra={"quarantine": dict(QUAR,
                                                 probe_backoff_s=0.2,
                                                 probe_backoff_max_s=1.0)}))
            try:
                h = fe.router.replicas[0]
                assert h._qcfg is not None
                for _ in range(4):
                    h._q_observe(1.0, False)       # 4/4 slow ≥ 75%
                assert h.state == ReplicaState.QUARANTINED
                assert not h.accepting
                assert fe.journal.count("replica_quarantined") == 1
                # the gauge reflects it on the next router tick
                deadline = time.monotonic() + 10
                while fe.metrics_snapshot().get(
                        "replicas_quarantined", 0) != 1 \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
                assert fe.metrics_snapshot()["replicas_quarantined"] == 1
                # the server answers probes fast → re-admission
                deadline = time.monotonic() + 30
                while h.state == ReplicaState.QUARANTINED \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
                assert h.state == ReplicaState.HEALTHY, \
                    "probe never re-admitted a healthy peer"
                assert fe.journal.count("replica_readmitted") == 1
                ev = fe.journal.events(kinds=("replica_readmitted",))[0]
                assert ev["detail"]["quarantined_s"] >= 0.0
                # and it serves again, byte-exact
                ps = prompts(2, 52)
                assert run_fleet(fe, ps, 4) == local_reference(ps, 4)
            finally:
                fe.shutdown(drain=False, timeout=5)

    def test_repeated_quarantine_escalates_to_dead(self):
        with _Servers(1, heartbeat_s=0.2) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers, heartbeat_s=0.2,
                fabric_extra={"quarantine": dict(
                    QUAR, escalate_quarantines=2)}))
            try:
                h = fe.router.replicas[0]
                h._quarantine("test gray failure")
                assert h.state == ReplicaState.QUARANTINED
                h._readmit()
                assert h.state == ReplicaState.HEALTHY
                h._quarantine("test gray failure again")
                assert h.state == ReplicaState.DEAD, \
                    "2nd quarantine in the window must escalate"
                assert fe.journal.count("replica_quarantined") == 1
            finally:
                fe.shutdown(drain=False, timeout=5)

    def test_min_samples_and_fast_rpcs_never_fire(self):
        with _Servers(1) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers, fabric_extra={"quarantine": QUAR}))
            try:
                h = fe.router.replicas[0]
                # the connect's hello RPC is timed into the window too, and
                # on a loaded CPU it can exceed rpc_slow_s (it builds the
                # server's engine): start the window from this test's own
                # samples
                with h._lock:
                    h._q_samples.clear()
                # 2 slow samples can never satisfy slow_fraction=0.75
                # even when live status RPCs pad the window with fast
                # samples (min_samples=4 → best case 2/4 = 50%)
                for _ in range(2):
                    h._q_observe(1.0, False)
                assert h.state == ReplicaState.HEALTHY
                for _ in range(20):                # fast calls
                    h._q_observe(0.001, False)
                assert h.state == ReplicaState.HEALTHY
            finally:
                fe.shutdown(drain=False, timeout=5)

    def test_router_holds_not_fails_on_quarantined_capacity(self):
        """A QUARANTINED replica is sick, not gone: with no other
        capacity for the model, fresh work WAITS for re-admission
        instead of failing undispatchable."""
        with _Servers(1) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers, fabric_extra={"quarantine": QUAR}))
            try:
                h = fe.router.replicas[0]
                h._quarantine("test hold")
                assert h.state == ReplicaState.QUARANTINED
                hs = [fe.submit(p, max_new_tokens=4)
                      for p in prompts(2, 53)]
                time.sleep(1.0)
                assert all(x.state == RequestState.QUEUED for x in hs), \
                    [x.state for x in hs]
                h._readmit()
                assert fe.wait_all(hs, timeout=60), [x.state for x in hs]
            finally:
                fe.shutdown(drain=False, timeout=5)

    def test_quarantine_disabled_is_inert(self):
        with _Servers(1) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers))
            try:
                h = fe.router.replicas[0]
                assert h._qcfg is None
                for _ in range(50):
                    h._q_observe(10.0, True)
                assert h.state == ReplicaState.HEALTHY
            finally:
                fe.shutdown(drain=False, timeout=5)


# ================================================== quarantine composition
class TestQuarantineComposition:
    def test_autoscaler_never_shrinks_quarantined_victim(self):
        """A quarantined replica holding streams is invisible to the
        shrink pick — it is not accepting, and victims come only from
        accepting replicas."""
        from deepspeed_tpu_torch.serving.autoscaler import FleetController

        with _Servers(2) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers, fabric_extra={"quarantine": QUAR}))
            try:
                victim = fe.router.replicas[0]
                victim._quarantine("test")
                signals = fe.fleet_signals()
                info = {r.replica_id: r for r in signals.replicas}
                assert not info[victim.replica_id].accepting
                assert not info[victim.replica_id].parked
                ctl = FleetController.__new__(FleetController)
                chosen = ctl._shrink_victim(signals)
                assert chosen != victim.replica_id
            finally:
                fe.shutdown(drain=False, timeout=5)

    def test_affinity_digest_from_quarantined_earns_no_steering(self):
        """rid0 holds the whole prompt's digest; while QUARANTINED its
        digest must not pull the request — it routes to the digest-less
        healthy replica instead."""
        from deepspeed_tpu_torch.serving.affinity import chain_hashes

        p = prompts(1, 54, lo=32, hi=33)[0]
        with _Servers(2) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers,
                fabric_extra={"quarantine": QUAR},
                affinity={"enabled": True, "refresh_interval_s": 1e6}))
            try:
                r0, r1 = fe.router.replicas
                fe._affinity._digests = {
                    r0.replica_id: frozenset(chain_hashes(
                        p, ENGINE_KW["kv_block_size"]))}
                h = fe.submit(p, max_new_tokens=4)
                assert fe.wait_all([h], timeout=60)
                assert h._req.replica_id == r0.replica_id, \
                    "sanity: affinity should steer to the digest holder"
                r0._quarantine("test")
                h2 = fe.submit(p, max_new_tokens=4)
                assert fe.wait_all([h2], timeout=60)
                assert h2._req.replica_id == r1.replica_id, \
                    "a quarantined replica's digest still earned steering"
            finally:
                fe.shutdown(drain=False, timeout=5)

    def test_quarantined_federated_member_takes_no_fresh_work(self):
        """Fresh work stays local while the federated member is
        quarantined (its seats on the exporter serve nobody new), and
        re-admission restores it."""
        fe_a = ServingFrontend(
            [tiny_engine(0)], fed_cfg(fabric_extra={"quarantine": QUAR}))
        fe_b = None
        try:
            fe_b = ServingFrontend(
                [tiny_engine(1)],
                fed_cfg(peers=[fe_a.federation_address],
                        fabric_extra={"quarantine": QUAR}))
            fed = next(r for r in fe_b.router.replicas
                       if getattr(r, "is_federated", False))
            assert fed._qcfg is not None
            fed._quarantine("test gray peer")
            assert fed.state == ReplicaState.QUARANTINED
            before = fe_b.metrics_snapshot().get("requests_federated", 0)
            ps = prompts(4, 55)
            got = run_fleet(fe_b, ps, 4)
            after = fe_b.metrics_snapshot().get("requests_federated", 0)
            assert after == before, \
                "fresh work crossed to a quarantined federated member"
            assert got == local_reference(ps, 4)
            fed._readmit()
            assert fed.accepting
        finally:
            if fe_b is not None:
                fe_b.shutdown(drain=False, timeout=5)
            fe_a.shutdown(drain=False, timeout=5)


# ======================================================== federation lease
class TestFederationLease:
    def test_partition_expires_lease_and_heals_exactly_once(
            self, monkeypatch):
        """Silence the adopter→exporter direction (asymmetric
        partition): the exporter journals ``peer_partition`` once,
        expires the seat lease (``lease_expired`` +
        ``federation_leases_expired``), and closes the export channel —
        whereupon the adopter's supervisor re-adopts over fresh
        channels exactly once."""
        monkeypatch.setattr(ffederation, "STALE_FLOOR_S", 0.5)
        fe_a = ServingFrontend(
            [tiny_engine(0)],
            fed_cfg(heartbeat_s=0.2,
                    federation_extra={"lease_timeout_s": 1.0}))
        fe_b = None
        muted = []
        try:
            fe_b = ServingFrontend(
                [tiny_engine(1)],
                fed_cfg(peers=[fe_a.federation_address], heartbeat_s=0.2,
                        fault_tolerance={"enabled": True,
                                         "max_retries": 3,
                                         "restart_backoff_s": 0.1,
                                         "max_restarts_in_window": 50}))
            assert any(getattr(r, "is_federated", False)
                       for r in fe_b.router.replicas)
            exported_before = fe_a.journal.count("replica_exported")
            assert exported_before >= 1

            # partition: drop every frame crossing the link (sends
            # become no-ops on both sides' current connections; the
            # supervisor's RE-DIAL builds fresh, unmuted connections —
            # that IS the heal)
            conns = []
            srv = fe_a._federation_server
            with srv._lock:
                conns += [c.conn for c in srv._channels
                          if c.conn is not None]
            for peer in fe_b._federation_peers:
                if peer._conn is not None:
                    conns.append(peer._conn)
            for r in fe_b.router.replicas:
                if getattr(r, "is_federated", False) \
                        and r._conn is not None:
                    conns.append(r._conn)
            for c in conns:
                muted.append((c, c.send))
                c.send = lambda msg: None

            deadline = time.monotonic() + 30
            while (fe_a.journal.count("lease_expired") < 1
                   or fe_a.journal.count("peer_partition") < 1) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            assert fe_a.journal.count("peer_partition") >= 1, \
                "silent boot channel never journaled the partition"
            assert fe_a.journal.count("lease_expired") == 1
            assert fe_a.metrics_snapshot()[
                "federation_leases_expired"] == 1
            ev = fe_a.journal.events(kinds=("lease_expired",))[0]
            assert ev["detail"]["idle_s"] > 1.0

            # heal: the adopter re-dials and the exporter re-binds the
            # replica to a fresh export channel — exactly once
            deadline = time.monotonic() + 30
            while fe_a.journal.count("replica_exported") \
                    < exported_before + 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            assert fe_a.journal.count("replica_exported") \
                == exported_before + 1, "re-adoption never happened"
            time.sleep(1.5)         # settle: no duplicate re-adoption
            assert fe_a.journal.count("replica_exported") \
                == exported_before + 1, "re-adoption was not exactly-once"
            assert fe_a.journal.count("lease_expired") == 1, \
                "a healed link kept expiring leases"

            # un-mute survivors and prove the pool serves
            for c, orig in muted:
                c.send = orig
            muted = []
            deadline = time.monotonic() + 30
            while not any(getattr(r, "is_federated", False)
                          and r.accepting
                          for r in fe_b.router.replicas) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            ps = prompts(3, 56)
            assert run_fleet(fe_b, ps, 4) == local_reference(ps, 4)
        finally:
            for c, orig in muted:
                c.send = orig
            if fe_b is not None:
                fe_b.shutdown(drain=False, timeout=5)
            fe_a.shutdown(drain=False, timeout=5)


# ======================================================= chaos via config
class TestChaosConfig:
    def test_schedule_through_config_with_parity_and_uninstall(self):
        ps = prompts(3, 57)
        ref = local_reference(ps, 5)
        with _Servers(1) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers,
                chaos={"enabled": True, "seed": 1, "schedule": [
                    {"kind": "latency", "link": "fabric-r*",
                     "delay_s": 0.01, "jitter_s": 0.01,
                     "duration_s": 30.0}]}))
            try:
                assert fchaos.installed() is fe.net_chaos
                h = fe.router.replicas[0]
                assert h._conn._chaos is not None
                got = run_fleet(fe, ps, 5)
                assert fe.net_chaos.fired("latency"), \
                    "scheduled latency never fired"
            finally:
                fe.shutdown(drain=False, timeout=5)
            assert fchaos.installed() is None, \
                "shutdown must uninstall the frontend's own injector"
        assert got == ref, "latency chaos broke greedy byte-parity"

    def test_disabled_chaos_builds_nothing(self):
        cfg = ServingConfig()
        assert cfg.chaos.build_injector() is None
        fe = ServingFrontend([tiny_engine()], cfg)
        try:
            assert fe.net_chaos is None
            assert fchaos.installed() is None
        finally:
            fe.shutdown(drain=False, timeout=5)


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# ================================================ trace propagation
class TestFabricTracePropagation:
    def test_cross_process_chain_stitches(self):
        with _Servers(2) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers, telemetry={"enabled": True}))
            try:
                ps = prompts(4, 11)
                run_fleet(fe, ps, 4)
                # span/journal deltas ride the ~1s status stream
                assert _wait(lambda: fe.metrics_snapshot()
                             ["spans_forwarded"] > 0), \
                    "no spans ever forwarded on the status stream"
                assert _wait(lambda: sum(
                    v.get("remote", 0)
                    for v in fe.fleet.sources().values()) >= 2), \
                    "journal never heard from both servers"
                # a server's root span ends with its request, and the
                # status tick that forwards it can come after the first
                # forwarded batch (the port's CPU engine finishes these
                # requests inside one 0.25 s tick): wait for one a request
                _wait(lambda: sum(s["name"] == "server"
                                  for s in fe.tracer.export()) >= len(ps))
                spans = fe.tracer.export()
                servers = [s for s in spans if s["name"] == "server"]
                assert servers, "no server-side spans in the merged set"
                ids = {s["span_id"] for s in spans}
                for s in servers:
                    assert str(s["trace_id"]).startswith("req-")
                    assert s["parent_id"] in ids, \
                        "cross-process edge failed to stitch"
                    assert "replica-" in s["attrs"]["source"]
                # every remote source's books balance: exactly-once
                books = fe.fleet.sources()
                remote = {k: v for k, v in books.items() if v["remote"]}
                assert len(remote) == 2
                for book in remote.values():
                    assert book["events"] == book["last_seq"]
                    assert book["dropped"] == 0
                report = fe.health_report()
                assert len(report["remotes"]) == 2
                for r in report["remotes"]:
                    assert r["connected"]
                    assert isinstance(r["clock_offset_s"], float)
                assert validate_chrome_trace(
                    fleet_chrome_trace(spans)) == []
            finally:
                fe.shutdown(drain=False, timeout=5)

    def test_counter_reset_detection_across_replica_swap(self):
        """Satellite: forwarded engine counters must stay monotonic
        through a supervisor replica swap (transport loss -> re-dial ->
        server-side engine reset restarts the server's cumulative
        counters from zero) — the frontend's cumulative view never goes
        backwards and the windowed deltas spanning the swap never go
        negative."""
        from deepspeed_tpu_torch.serving.fabric.remote import RemoteHandle

        rng = np.random.default_rng(3)
        head = rng.integers(0, VOCAB, size=16).tolist()
        mk = lambda seed: [head + rng.integers(0, VOCAB, size=6).tolist()
                           for _ in range(3)]
        # the SERVER owns its engine's config: prefix caching must be
        # enabled there for hits to exist server-side at all
        srv_cfg = ServingConfig(prefix_cache={"enabled": True})
        with _Servers(1, server_config=srv_cfg, heartbeat_s=0.2) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers, heartbeat_s=0.2,
                fault_tolerance={"enabled": True, "max_retries": 3,
                                 "restart_backoff_s": 0.05,
                                 "max_restarts_in_window": 10}))
            watched = RemoteHandle._FORWARDED_COUNTERS
            try:
                run_fleet(fe, mk(1), 4)   # first wave primes the cache
                run_fleet(fe, mk(1), 4)   # second wave hits the head
                assert _wait(lambda: fe.metrics_snapshot()
                             ["prefix_blocks_hit"] > 0), \
                    "shared-prefix traffic never forwarded a hit counter"
                fe.windowed.tick()
                before = fe.metrics_snapshot()
                # sever the transport: the supervisor re-dials with a
                # server-side reset — a FRESH engine whose cumulative
                # counters restart from zero
                handle = next(r for r in fe.router.replicas
                              if isinstance(r, RemoteHandle))
                handle._conn.close("injected transport loss")
                assert _wait(lambda: fe.journal.count(
                    "replica_reconnected") > 0), "supervisor never re-dialed"
                run_fleet(fe, mk(2), 4)
                assert _wait(lambda: fe.metrics_snapshot()
                             ["prefix_blocks_hit"]
                             > before["prefix_blocks_hit"]), \
                    "post-swap traffic never moved the forwarded counter"
                fe.windowed.tick()
                after = fe.metrics_snapshot()
                for name in watched:
                    assert after.get(name, 0.0) >= before.get(name, 0.0), \
                        f"{name} went backwards across the replica swap"
                    delta = fe.windowed.window_delta(name, 3600.0)
                    assert delta >= 0.0, \
                        f"{name} produced a negative windowed delta"
                # the reset-detection branch itself: a status frame whose
                # counters are BELOW the high-water mark (server engine
                # reset) re-bases instead of subtracting into a phantom
                new_handle = next(r for r in fe.router.replicas
                                  if isinstance(r, RemoteHandle))
                base = fe.metrics_snapshot()["prefix_blocks_hit"]
                new_handle._counters_last["prefix_blocks_hit"] = 10 ** 9
                new_handle._ev_status(
                    {"counters": {"prefix_blocks_hit": 2.0}})
                got = fe.metrics_snapshot()["prefix_blocks_hit"]
                assert got == pytest.approx(base + 2.0), \
                    "reset epoch was not re-based from zero"
            finally:
                fe.shutdown(drain=False, timeout=5)
