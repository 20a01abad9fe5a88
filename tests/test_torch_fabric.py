"""Port parity: the cross-process serving fabric of ``deepspeed_tpu_torch``
(``serving/fabric/``) against the JAX package, twin of
``tests/test_fabric.py``.

Replica servers run on threads here (full codec, framing and multiplexing
over real TCP sockets, no subprocess start-up), over port engines on the
CPU that hold the JAX package's ``init(PRNGKey(0))`` weights through
``params_from_numpy``; every greedy stream must equal the JAX engine's for
its prompt byte for byte. Covered: the handle protocol, chunked KV
export/import, the typed wire refusals, remote parity (plain decode,
cancel across the wire, mixed local and remote fleets, prefix cache,
speculation, preemption), cross-process disaggregated handoff (fp32, int8
and fp8 KV pools), transport-loss failover and reconnect, remote
evacuation, a mixed-model fleet, the prefix-digest status stream and its
deltas, and the transport's chaos edges. One subprocess test runs
``python -m deepspeed_tpu_torch.scripts.serve_replica --device cpu`` over
a universal checkpoint the JAX package saved; the launch script's mesh and
device refusals run in-process.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.v2.engine_v2 import (
    InferenceEngineV2, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.serving import (RequestState, ServingConfig,
                                         ServingFrontend, ServingRequest)
from deepspeed_tpu_torch.serving.fabric import codec as fcodec
from deepspeed_tpu_torch.serving.fabric import transport as ftransport
from deepspeed_tpu_torch.serving.fabric.handle import (HANDLE_SURFACE,
                                                       LocalHandle)
from deepspeed_tpu_torch.serving.fabric.server import ReplicaServer
import torch_cpu  # noqa: F401  (one torch thread: see the module)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import jax

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.testing import \
    greedy_generate as j_greedy_generate
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy

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


def run_fleet(fe, ps, max_new, timeout=300, request_class=None):
    kw = {"request_class": request_class} if request_class else {}
    hs = [fe.submit(p, max_new_tokens=max_new, **kw) for p in ps]
    assert fe.wait_all(hs, timeout=timeout), [h.state for h in hs]
    return [[ev.token for ev in h.drain()] for h in hs]


class _Servers:
    """N threaded replica servers over real TCP sockets (full codec +
    framing + multiplexing, no subprocess startup cost)."""

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


def fabric_cfg(peers, heartbeat_s=0.3, **extra):
    return ServingConfig(
        max_queue_depth=64,
        fabric={"enabled": True, "peers": list(peers),
                "heartbeat_s": heartbeat_s, "rpc_timeout_s": 60.0},
        **extra)


# ======================================================= handle protocol
class TestHandleProtocol:
    def test_local_handle_adds_nothing(self):
        """LocalHandle must stay an EMPTY subclass: any override would
        fork the fabric's local path from the plain-Replica disabled
        path."""
        allowed = {"__module__", "__qualname__", "__doc__", "__slots__",
                   "__firstlineno__", "__static_attributes__"}
        extra = set(LocalHandle.__dict__) - allowed
        assert not extra, f"LocalHandle overrides {sorted(extra)}"

    def test_replica_and_remote_provide_the_surface(self):
        fe = ServingFrontend([tiny_engine()],
                             ServingConfig(max_queue_depth=8))
        try:
            rep = fe.router.replicas[0]
            missing = [n for n in HANDLE_SURFACE if not hasattr(rep, n)]
            assert not missing, f"Replica lacks {missing}"
        finally:
            fe.shutdown(drain=False, timeout=5)
        with _Servers(1) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers))
            try:
                rh = fe.router.replicas[0]
                assert getattr(rh, "is_remote", False)
                missing = [n for n in HANDLE_SURFACE
                           if not hasattr(rh, n)]
                assert not missing, f"RemoteHandle lacks {missing}"
                assert rh.engine.model.cfg.max_seq_len \
                    == MODEL_KW["max_seq_len"]
            finally:
                fe.shutdown(drain=False, timeout=5)


# ==================================================== chunked export/import
class TestChunkedExport:
    @pytest.mark.parametrize("quant", [None, "int8"])
    def test_chunked_export_import_byte_parity(self, quant):
        over = ({} if quant is None
                else {"kv_quant_enabled": True, "kv_quant_dtype": quant})
        from deepspeed_tpu_torch.inference.v2.scheduler import (
            ContinuousBatchingScheduler)

        src = tiny_engine(**over)
        sched = ContinuousBatchingScheduler(src, prefill_only=True)
        prompt = prompts(1, 7, lo=30, hi=31)[0]     # several blocks
        sched.submit(1, prompt, max_new_tokens=2)
        sched.run_to_completion()
        whole = src.export_sequence(1)
        chunked = src.export_sequence(1, chunk_blocks=1)
        assert chunked["chunk_blocks"] == 1
        assert len(chunked["chunks"]) == whole["n_blocks"]
        # chunk content == the whole-slab content, byte for byte
        for name, slab in whole["slabs"].items():
            glued = np.concatenate(
                [np.asarray(c[name]) for c in chunked["chunks"]], axis=1)
            assert glued.tobytes() == np.asarray(slab).tobytes(), name
        # chunked import reproduces the pool content exactly
        tokens = prompt[:whole["seen_tokens"]]
        dst_a = tiny_engine(**over)
        dst_a.import_sequence(5, whole, tokens=tokens)
        dst_b = tiny_engine(**over)
        dst_b.import_sequence(5, chunked, tokens=tokens)
        for name in dst_a.state_manager.kv_cache:
            a = np.asarray(dst_a.state_manager.kv_cache[name])
            b = np.asarray(dst_b.state_manager.kv_cache[name])
            assert a.tobytes() == b.tobytes(), name

    def test_chunk_count_mismatch_refused(self):
        src = tiny_engine()
        from deepspeed_tpu_torch.inference.v2.scheduler import (
            ContinuousBatchingScheduler)

        sched = ContinuousBatchingScheduler(src, prefill_only=True)
        prompt = prompts(1, 8, lo=20, hi=21)[0]
        sched.submit(1, prompt, max_new_tokens=2)
        sched.run_to_completion()
        payload = src.export_sequence(1, chunk_blocks=1)
        payload["chunks"] = payload["chunks"][:-1]      # drop a chunk
        dst = tiny_engine()
        tokens = prompt[:payload["seen_tokens"]]
        with pytest.raises(ValueError, match="chunks cover"):
            dst.import_sequence(5, payload, tokens=tokens)
        assert not dst.state_manager.tracked_sequences


# ============================================================ wire refusal
class TestWireRefusal:
    def test_hello_version_mismatch_is_typed_and_non_fatal(self):
        with _Servers(1) as srv:
            conn = ftransport.dial(srv.peers[0], heartbeat_s=0.0)
            try:
                with pytest.raises(ftransport.FabricError,
                                   match="version_mismatch"):
                    conn.call("hello", {"codec_version": 99,
                                        "role": "mixed"}, timeout_s=30)
                # the server survived the refusal: a correct hello on
                # the same connection succeeds
                info = conn.call("hello",
                                 {"codec_version": fcodec.CODEC_VERSION,
                                  "role": "mixed"}, timeout_s=120)
                assert info["max_seats"] \
                    == ENGINE_KW["max_ragged_sequence_count"]
            finally:
                conn.close()

    def test_remote_handle_does_not_retry_version_mismatch(self,
                                                           monkeypatch):
        from deepspeed_tpu_torch.serving.fabric import remote as fremote

        monkeypatch.setattr(fcodec, "CODEC_VERSION", 99)
        monkeypatch.setattr(fremote, "CODEC_VERSION", 99)
        with _Servers(1) as srv:
            cfg = fabric_cfg(srv.peers)
            t0 = time.monotonic()
            with pytest.raises(fcodec.VersionMismatch):
                fremote.RemoteHandle(0, srv.peers[0],
                                     cfg.fabric).connect()
            assert time.monotonic() - t0 < 10, \
                "version mismatch burned the whole retry budget"


# ========================================================== remote parity
class TestRemoteParity:
    def test_disabled_fabric_is_byte_identical(self):
        ps = prompts(4, 11)
        ref = local_reference(ps, 6)
        fe = ServingFrontend([tiny_engine()], ServingConfig(
            max_queue_depth=64, fabric={"enabled": False}))
        try:
            got = run_fleet(fe, ps, 6)
            from deepspeed_tpu_torch.serving.replica import Replica

            assert type(fe.router.replicas[0]) is Replica
        finally:
            fe.shutdown(drain=False, timeout=5)
        assert got == ref, "fabric.enabled=false diverged from the " \
                           "in-process stack"

    def test_plain_decode_parity(self):
        ps = prompts(6, 12)
        ref = local_reference(ps, 6)
        with _Servers(2) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers))
            try:
                got = run_fleet(fe, ps, 6)
                snap = fe.metrics_snapshot()
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got == ref, "remote handles broke greedy byte-parity"
        assert snap["requests_completed"] == len(ps)
        assert snap["rpc_call_s"]["count"] >= len(ps)    # assigns timed
        assert snap["tokens_generated"] == sum(len(g) for g in got)

    def test_custom_sample_fn_refused_with_peers(self):
        """A sampler callable cannot cross the process boundary — a
        fleet that would sample differently per replica must be refused
        at construction, not discovered in production."""
        with _Servers(1) as srv:
            with pytest.raises(ValueError, match="sample_fn"):
                ServingFrontend([tiny_engine()], fabric_cfg(srv.peers),
                                sample_fn=lambda logits: 0)

    def test_cancel_crosses_the_wire(self):
        """RequestHandle.cancel on a remotely-running request must reach
        the server (the flag lives on a mirror, not a shared object) and
        terminate the stream CANCELLED."""
        with _Servers(1) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers))
            try:
                h = fe.submit(prompts(1, 24)[0], max_new_tokens=200)
                deadline = time.monotonic() + 60
                while h._req.n_generated < 2 \
                        and time.monotonic() < deadline:
                    time.sleep(0.002)
                assert h._req.n_generated >= 2, "stream never started"
                h.cancel()
                assert h._req.wait(30), "cancel never terminated the " \
                                        "remote stream"
                assert h.state == RequestState.CANCELLED
                # the server replica freed the sequence: it accepts a
                # full-budget follow-up immediately
                got = run_fleet(fe, prompts(1, 25), 4)
                assert got == local_reference(prompts(1, 25), 4)
            finally:
                fe.shutdown(drain=False, timeout=5)

    def test_mixed_local_and_remote_fleet(self):
        ps = prompts(6, 13)
        ref = local_reference(ps, 5)
        with _Servers(1) as srv:
            fe = ServingFrontend([tiny_engine()], fabric_cfg(srv.peers))
            try:
                assert len(fe.router.replicas) == 2
                got = run_fleet(fe, ps, 5)
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got == ref

    def test_prefix_cache_parity_and_forwarded_counters(self):
        sys_prompt = prompts(1, 14, lo=40, hi=41)[0]
        ps = [sys_prompt + p for p in prompts(4, 15, lo=4, hi=8)]
        ref = local_reference(ps, 4)
        server_cfg = ServingConfig(
            prefix_cache={"enabled": True, "max_cached_blocks": 0})
        with _Servers(1, server_config=server_cfg) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers))
            try:
                # sequential: the first request's blocks must register
                # in the server's prefix index before the repeats match
                got = []
                for p in ps:
                    got.extend(run_fleet(fe, [p], 4))
                # forwarded engine counters need a status tick
                deadline = time.monotonic() + 10
                snap = fe.metrics_snapshot()
                while snap["prefix_blocks_hit"] == 0 \
                        and time.monotonic() < deadline:
                    time.sleep(0.1)
                    snap = fe.metrics_snapshot()
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got == ref, "remote prefix cache broke parity"
        assert snap["prefix_blocks_hit"] > 0, \
            "server-side prefix counters never forwarded"

    def test_speculative_parity(self):
        ps = [p * 3 for p in prompts(4, 16, lo=6, hi=10)]  # ngram food
        ref = local_reference(ps, 8)
        server_cfg = ServingConfig(
            speculative={"enabled": True, "mode": "ngram",
                         "max_draft_tokens": 4})
        with _Servers(1, server_config=server_cfg) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers))
            try:
                got = run_fleet(fe, ps, 8)
                deadline = time.monotonic() + 10
                snap = fe.metrics_snapshot()
                while snap["spec_tokens_proposed"] == 0 \
                        and time.monotonic() < deadline:
                    time.sleep(0.1)
                    snap = fe.metrics_snapshot()
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got == ref, "remote speculation broke greedy parity"
        assert snap["spec_tokens_proposed"] > 0

    def test_preempt_resume_parity(self):
        """Overload a small remote KV pool under reservation admission +
        preemption (batch victims yield to interactive work): sequences
        spill/resume server-side and the streams stay byte-identical to
        an uncontended local reference."""
        ps_batch = prompts(4, 17, lo=60, hi=61)
        ps_int = prompts(8, 27, lo=60, hi=61)
        ref_batch = local_reference(ps_batch, 24)
        ref_int = local_reference(ps_int, 4)
        server_cfg = ServingConfig(
            prefix_cache={"enabled": True}, kv_tier={"enabled": True},
            admission={"reservation": True,
                       "oversubscription_factor": 3.0,
                       "preemption": {"enabled": True}})
        with _Servers(1, server_config=server_cfg, kv_blocks=14,
                      max_ragged_sequence_count=8) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers))
            try:
                bh = [fe.submit(p, max_new_tokens=24,
                                request_class="batch") for p in ps_batch]
                # the port's CPU engine decodes a batch stream in a tenth
                # of a second: the interactive wave lands as soon as batch
                # work holds the pool
                deadline = time.monotonic() + 60
                while not any(h._req.n_generated for h in bh) \
                        and time.monotonic() < deadline:
                    time.sleep(0.001)
                ih = [fe.submit(p, max_new_tokens=4,
                                request_class="interactive")
                      for p in ps_int]
                assert fe.wait_all(bh + ih, timeout=300), \
                    [h.state for h in bh + ih]
                got_batch = [[ev.token for ev in h.drain()] for h in bh]
                got_int = [[ev.token for ev in h.drain()] for h in ih]
                deadline = time.monotonic() + 10
                snap = fe.metrics_snapshot()
                while snap["sequences_preempted"] == 0 \
                        and time.monotonic() < deadline:
                    time.sleep(0.1)
                    snap = fe.metrics_snapshot()
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got_batch == ref_batch and got_int == ref_int, \
            "remote preempt/resume broke parity"
        assert snap["sequences_preempted"] > 0, \
            "pool sized to preempt never preempted — parity vacuous"
        assert snap["sequences_resumed"] > 0


# ==================================================== cross-process handoff
class TestCrossProcessHandoff:
    @pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
    def test_disagg_handoff_parity(self, quant):
        ps = prompts(4, 18, lo=12, hi=20)
        ref = local_reference(ps, 5, kv_quant=quant)
        disagg = {"enabled": True, "roles": ["prefill", "decode"],
                  "handoff": {"enabled": True, "max_staged": 8,
                              "chunk_blocks": 1}}
        server_cfg = ServingConfig(
            disaggregation=disagg,
            kv_quant=({"enabled": True, "dtype": quant}
                      if quant else {"enabled": False}))
        with _Servers(2, server_config=server_cfg) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers,
                                                disaggregation=disagg))
            try:
                got = run_fleet(fe, ps, 5, timeout=300)
                # the decode server's import count is a forwarded counter:
                # it rides the next status tick
                deadline = time.monotonic() + 10
                snap = fe.metrics_snapshot()
                while snap["handoffs_completed"] == 0 \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
                    snap = fe.metrics_snapshot()
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert snap["handoffs_started"] > 0, "no handoffs staged"
        assert snap["handoff_fallbacks"] == 0
        assert snap["handoffs_completed"] > 0, \
            "no cross-process handoff completed — parity vacuous"
        assert got == ref, \
            f"cross-process KV handoff (quant={quant}) broke parity"

    def test_asymmetric_frame_bounds_degrade_not_disconnect(self):
        """Sender and receiver bounds are negotiated in hello: a KV
        payload over the peer's receive bound must die at ENCODE (typed
        → re-prefill fallback), never at the peer's reader (which would
        kill the connection and loop the request through failover)."""
        ps = prompts(3, 26, lo=60, hi=61)       # ~8 blocks of KV each
        ref = local_reference(ps, 4)
        disagg = {"enabled": True, "roles": ["prefill", "decode"],
                  "handoff": {"enabled": True, "max_staged": 8}}
        server_cfg = ServingConfig(
            disaggregation=disagg,
            # tiny RECEIVE bound: a whole-prompt staged payload cannot
            # fit one frame (the RPC envelopes still do)
            fabric={"max_frame_bytes": 1 << 16})
        with _Servers(2, server_config=server_cfg) as srv:
            fe = ServingFrontend([], fabric_cfg(srv.peers,
                                                disaggregation=disagg))
            try:
                got = run_fleet(fe, ps, 4, timeout=300)
                snap = fe.metrics_snapshot()
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got == ref, "frame-bound degrade broke parity"
        assert snap["handoff_fallbacks"] > 0, \
            "payloads fit the tiny bound — degrade path untested"
        assert snap["handle_disconnects"] == 0, \
            "an oversized payload killed a connection"

    def test_assign_rpc_failure_is_replica_failure(self, monkeypatch):
        """A failed/timed-out assign RPC is AMBIGUOUS (the server may
        have adopted the request) — the handle must go DEAD so the
        server-side ghost is cancelled on disconnect, never requeue into
        a possible duplicate execution."""
        from deepspeed_tpu_torch.serving.fabric.transport import RPCTimeout

        ps = prompts(2, 28)
        ref = local_reference(ps, 4)
        srv = _Servers(2)
        fe = ServingFrontend([], fabric_cfg(
            srv.peers,
            fault_tolerance={"enabled": True, "max_retries": 3,
                             "restart_backoff_s": 0.05}))
        try:
            victim = fe.router.replicas[0]
            real_call = victim._call

            def flaky_call(method, payload=None, timeout_s=None,
                           _first=[True]):
                if method == "assign" and _first[0]:
                    _first[0] = False
                    raise RPCTimeout("injected assign timeout")
                return real_call(method, payload, timeout_s=timeout_s)

            monkeypatch.setattr(victim, "_call", flaky_call)
            got = run_fleet(fe, ps, 4, timeout=120)
            snap = fe.metrics_snapshot()
            from deepspeed_tpu_torch.serving.replica import ReplicaState

            assert victim.state == ReplicaState.DEAD
            assert snap["handle_disconnects"] >= 1
        finally:
            fe.shutdown(drain=False, timeout=5)
            srv.stop()
        assert got == ref, "assign-failure handling broke parity"

    def test_streamed_chunked_handoff_local_parity(self):
        """The chunked staging path for LOCAL handles: chunk_blocks=1
        must stream per-block and stay byte-lossless."""
        ps = prompts(4, 19, lo=16, hi=24)
        ref = local_reference(ps, 5)
        disagg = {"enabled": True, "roles": ["prefill", "decode"],
                  "decode_reserve_tokens": 8,
                  "handoff": {"enabled": True, "max_staged": 8,
                              "chunk_blocks": 1}}
        fe = ServingFrontend([tiny_engine(0), tiny_engine(1)],
                             ServingConfig(max_queue_depth=64,
                                           disaggregation=disagg))
        try:
            got = run_fleet(fe, ps, 5, timeout=300)
            snap = fe.metrics_snapshot()
        finally:
            fe.shutdown(drain=False, timeout=5)
        assert snap["handoffs_completed"] > 0
        assert got == ref, "chunked local handoff broke parity"


# ============================================================== failover
class TestTransportLossFailover:
    def test_kill_server_mid_stream_resumes_losslessly(self):
        ps = prompts(2, 20, lo=8, hi=12)
        ref = local_reference(ps, 96)
        srv = _Servers(2)
        fe = ServingFrontend([], fabric_cfg(
            srv.peers,
            fault_tolerance={"enabled": True, "max_retries": 3,
                             "restart_backoff_s": 0.1}))
        try:
            hs = [fe.submit(p, max_new_tokens=96) for p in ps]
            deadline = time.monotonic() + 60
            victim = None
            while time.monotonic() < deadline and victim is None:
                for h in hs:
                    # a long stream is live on this replica: kill its
                    # server NOW, mid-decode
                    if h._req.n_generated >= 2 \
                            and h._req.replica_id is not None:
                        victim = h._req.replica_id
                        break
                else:
                    time.sleep(0.002)
            assert victim is not None, "no stream ever started"
            srv.servers[victim].stop()
            assert fe.wait_all(hs, timeout=120), [h.state for h in hs]
            got = [[ev.token for ev in h.drain()] for h in hs]
            # detection rides the router health sweep — give it a beat
            deadline = time.monotonic() + 15
            snap = fe.metrics_snapshot()
            while snap["handle_disconnects"] == 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
                snap = fe.metrics_snapshot()
            kinds = [e["kind"] for e in fe.journal.events()]
        finally:
            fe.shutdown(drain=False, timeout=5)
            srv.stop()
        assert got == ref, "transport-loss failover broke byte parity"
        assert snap["handle_disconnects"] >= 1
        assert "replica_disconnected" in kinds
        # the victim's in-flight requests failed over (stream spliced)
        assert snap["requests_failed_over"] >= 1
        assert any(h.attempts > 1 for h in hs)

    def test_supervisor_reconnects_after_server_returns(self):
        """DEAD handle → supervisor restart → fresh handle + server-side
        reset: the slot serves again and the journal records the
        reconnect."""
        srv = _Servers(1, heartbeat_s=0.2)
        fe = ServingFrontend([tiny_engine()], fabric_cfg(
            srv.peers, heartbeat_s=0.2,
            fault_tolerance={"enabled": True, "max_retries": 3,
                             "restart_backoff_s": 0.05,
                             "max_restarts_in_window": 10}))
        try:
            # sever the handle's transport (server stays up): the handle
            # goes DEAD and the supervisor re-dials the same server
            handle = fe.router.replica_by_id(1)
            handle._conn.close("injected transport loss")
            deadline = time.monotonic() + 30
            reconnected = False
            while time.monotonic() < deadline and not reconnected:
                reconnected = fe.journal.count("replica_reconnected") > 0
                time.sleep(0.05)
            assert reconnected, "supervisor never re-attached the peer"
            ps = prompts(2, 21)
            got = run_fleet(fe, ps, 4)
            assert got == local_reference(ps, 4)
        finally:
            fe.shutdown(drain=False, timeout=5)
            srv.stop()


# ============================================================ evacuation
class TestRemoteEvacuation:
    def test_remove_remote_replica_mid_stream(self):
        ps = prompts(2, 22, lo=8, hi=12)
        ref = local_reference(ps, 96)
        srv = _Servers(2)
        fe = ServingFrontend([], fabric_cfg(
            srv.peers,
            fault_tolerance={"enabled": True, "max_retries": 3}))
        try:
            hs = [fe.submit(p, max_new_tokens=96) for p in ps]
            deadline = time.monotonic() + 60
            victim = None
            while time.monotonic() < deadline and victim is None:
                for h in hs:
                    if h._req.n_generated >= 2 \
                            and h._req.replica_id is not None:
                        victim = h._req.replica_id
                        break
                else:
                    time.sleep(0.002)
            assert victim is not None, "no stream ever started"
            fe.remove_replica(victim, timeout_s=30.0)
            assert fe.wait_all(hs, timeout=120), [h.state for h in hs]
            got = [[ev.token for ev in h.drain()] for h in hs]
            snap = fe.metrics_snapshot()
        finally:
            fe.shutdown(drain=False, timeout=5)
            srv.stop()
        assert got == ref, "remote evacuation broke byte parity"
        assert snap["requests_evacuated"] >= 1
        assert len(fe.router.replicas) == 1


# ==================================================== mixed-model fleet
class TestMixedModelFleet:
    """One frontend, two model families (docs/SERVING.md "Multi-model &
    multi-tenant serving"): a ``models:`` registry builds heterogeneous
    replica pools — here fam_a served ONLY by a replica server and fam_b
    by a local engine plus a second server (each server advertises its
    ``model_id``) — and the router keys every dispatch on the request's
    model_id. Misroute is shown impossible structurally (every completed
    request ran on a replica of its own pool) and each pool's streams equal
    the JAX engine's over that family's weights."""

    FAM_B_MODEL = dict(MODEL_KW, hidden_size=48, intermediate_size=96)
    FAM_B_SEED = 7

    def test_two_families_one_frontend_parity_and_routing(self):
        fam_b = dict(model_kw=self.FAM_B_MODEL, seed=self.FAM_B_SEED)
        servers = [
            ReplicaServer(lambda: tiny_engine(0), ServingConfig(),
                          listen="127.0.0.1:0", replica_id=0,
                          heartbeat_s=0.3, model_id="fam_a"),
            ReplicaServer(lambda: tiny_engine(1, **fam_b), ServingConfig(),
                          listen="127.0.0.1:0", replica_id=1,
                          heartbeat_s=0.3, model_id="fam_b")]
        for srv in servers:
            srv.start()
        try:
            addr_a, addr_b = (f"127.0.0.1:{srv.port}" for srv in servers)
            ps = {m: prompts(3, seed) for m, seed in
                  (("fam_a", 31), ("fam_b", 32))}
            ref = {"fam_a": local_reference(ps["fam_a"], 5),
                   "fam_b": local_reference(ps["fam_b"], 5, **fam_b)}
            fe = ServingFrontend([], ServingConfig(
                max_queue_depth=64,
                fabric={"enabled": True, "peers": [],
                        "heartbeat_s": 1.0, "rpc_timeout_s": 60.0},
                models={
                    "fam_a": {"model": MODEL_KW, "engine": ENGINE_KW,
                              "seed": SEED, "replicas": 0,
                              "peers": [addr_a]},
                    "fam_b": {"model": self.FAM_B_MODEL,
                              "engine": ENGINE_KW,
                              "seed": self.FAM_B_SEED, "replicas": 1,
                              "peers": [addr_b]},
                }), model_engine_factories={
                    "fam_b": lambda: tiny_engine(2, **fam_b)},
                device="cpu")
            try:
                by_id = {r.replica_id: getattr(r, "model_id", "default")
                         for r in fe.router.replicas}
                assert sorted(by_id.values()) == \
                    ["fam_a", "fam_b", "fam_b"], by_id
                hs = {m: [fe.submit(p, max_new_tokens=5, model=m)
                          for p in ps[m]] for m in ("fam_a", "fam_b")}
                assert fe.wait_all(hs["fam_a"] + hs["fam_b"],
                                   timeout=300), \
                    [h.state for m in hs for h in hs[m]]
                for m, handles in hs.items():
                    # structural misroute impossibility: every request
                    # ran on a replica of ITS model's pool
                    for h in handles:
                        assert by_id[h._req.replica_id] == m, \
                            f"{m} request served by " \
                            f"{by_id[h._req.replica_id]} replica"
                    got = [[ev.token for ev in h.drain()]
                           for h in handles]
                    assert got == ref[m], \
                        f"{m} greedy parity vs the JAX engine broke"
                report = fe.health_report()
                assert sorted(r["model"] for r in report["replicas"]) \
                    == ["fam_a", "fam_b", "fam_b"]
            finally:
                fe.shutdown(drain=False, timeout=5)
        finally:
            for srv in servers:
                srv.stop()

    def test_peer_hosting_wrong_model_refused(self):
        """Adopting a peer into a pool whose model it does not host is
        a config error, refused typed at the hello — NOT retried (the
        mismatch is permanent) and never silently misrouted."""
        with _Servers(1) as srv:        # advertises model_id "default"
            with pytest.raises(fcodec.ModelMismatch, match="hosts model"):
                ServingFrontend([], ServingConfig(
                    max_queue_depth=64,
                    fabric={"enabled": True, "peers": [],
                            "heartbeat_s": 0.3, "rpc_timeout_s": 30.0},
                    models={"fam_a": {"model": MODEL_KW,
                                      "engine": ENGINE_KW,
                                      "replicas": 0,
                                      "peers": srv.peers}}))


# ========================================= fleet KV locality digests
class TestFabricPrefixDigest:
    """The prefix digest (docs/SERVING.md "Fleet KV locality")
    rides the status stream as an OPTIONAL field. A peer that sends one
    participates in affinity routing; a peer that never does is
    cache-blind — zero credit, never refused."""

    def test_status_digest_codec_roundtrip(self):
        ev = {"t": "ev", "ev": "status", "state": "healthy",
              "counters": {},
              "prefix_digest": [0, 12345, -(2 ** 63), 2 ** 63 - 1]}
        back = fcodec.decode_frame(fcodec.encode_frame(ev))
        assert back["prefix_digest"] == ev["prefix_digest"]

    def test_status_without_digest_decodes_to_absent(self):
        # the historical status event: no digest field at all — the
        # consumer must read absence (None), not an empty list
        ev = {"t": "ev", "ev": "status", "state": "healthy",
              "counters": {}}
        back = fcodec.decode_frame(fcodec.encode_frame(ev))
        assert "prefix_digest" not in back
        assert back.get("prefix_digest") is None

    def test_digestless_peer_is_cache_blind_not_refused(self):
        """Server with affinity off (the historical server): its status
        events carry no digest. An affinity-enabled frontend must adopt
        it, route to it, and score it at zero credit — degraded, never
        an error."""
        sys_prompt = prompts(1, 31, lo=40, hi=41)[0]
        ps = [sys_prompt + p for p in prompts(4, 32, lo=4, hi=8)]
        ref = local_reference(ps, 4)
        with _Servers(1) as srv:        # server affinity: disabled
            fe = ServingFrontend([], fabric_cfg(
                srv.peers,
                affinity={"enabled": True, "refresh_interval_s": 0.05}))
            try:
                got = []
                for p in ps:
                    got.extend(run_fleet(fe, [p], 4))
                time.sleep(0.5)          # status ticks + digest refresh
                remote = fe.router.replicas[0]
                assert remote.prefix_digest() == frozenset()
                assert fe._affinity.digest_of(
                    remote.replica_id) == frozenset()
                st = fe._affinity.stats()
                assert st["hits"] == 0 and st["tokens_saved"] == 0
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got == ref, "digest-less peer broke greedy parity"

    def test_peer_digest_earns_affinity_credit(self):
        """A server with affinity + prefix cache on: its digest must
        arrive via the status stream (no RPC exists to fetch it) and earn
        affinity credit for shared-prefix repeats — with greedy parity
        intact."""
        scfg = ServingConfig(prefix_cache={"enabled": True},
                             affinity={"enabled": True,
                                       "refresh_interval_s": 0.05})
        with _Servers(1, server_config=scfg) as srv:
            sys_prompt = prompts(1, 33, lo=40, hi=41)[0]
            ps = [sys_prompt + p for p in prompts(4, 34, lo=4, hi=8)]
            ref = local_reference(ps, 4)
            fe = ServingFrontend([], fabric_cfg(
                srv.peers, heartbeat_s=1.0,
                affinity={"enabled": True, "refresh_interval_s": 0.05}))
            try:
                got = []
                for p in ps:             # warm the remote prefix index
                    got.extend(run_fleet(fe, [p], 4))
                remote = fe.router.replicas[0]
                aff = fe._affinity
                deadline = time.monotonic() + 15
                while not aff.digest_of(remote.replica_id) \
                        and time.monotonic() < deadline:
                    time.sleep(0.1)
                assert aff.digest_of(remote.replica_id), \
                    "peer digest never arrived on the status stream"
                # shared-prefix repeats: the remote digest must now win
                # affinity credit in pick()
                for p in ps:
                    got2 = run_fleet(fe, [p], 4)
                    assert got2 == [ref[ps.index(p)]]
                st = aff.stats()
                assert st["hits"] > 0 and st["tokens_saved"] > 0, st
            finally:
                fe.shutdown(drain=False, timeout=5)
        assert got == ref, "affinity peer broke greedy parity"


# ================================================ digest delta stream
class TestDigestDeltas:
    """The status stream sends digest add/evict DELTAS under a
    monotonic epoch instead of a full snapshot every tick (full snapshot
    on connect/reset) — wire bytes scale with cache churn, not
    ``digest_max_entries``. Back-compat both ways, the
    optional-field idiom: an old SERVER keeps sending full snapshots
    (always decoded, replace outright); an old CLIENT never advertises
    ``digest_deltas`` and keeps receiving full snapshots."""

    def _handle(self):
        from deepspeed_tpu_torch.serving.fabric.remote import RemoteHandle

        return RemoteHandle(1, "127.0.0.1:1",
                            fabric_cfg([]).fabric)

    @staticmethod
    def _status(**fields):
        ev = {"t": "ev", "ev": "status", "state": "healthy",
              "thread_alive": True, "occupancy": {}, "param_stats": {},
              "tier_stats": {}, "counters": {}}
        ev.update(fields)
        return ev

    def test_stream_encoder_full_then_deltas(self):
        from deepspeed_tpu_torch.serving.fabric.server import DigestStream

        ds = DigestStream()
        ev = {}
        ds.stamp(ev, {3, 1, 2}, deltas=True)
        assert ev == {"prefix_digest": [1, 2, 3], "digest_epoch": 0}
        ev = {}
        ds.stamp(ev, {3, 1, 2}, deltas=True)
        assert ev == {}, "no churn must send nothing"
        ev = {}
        ds.stamp(ev, {2, 3, 4, 5}, deltas=True)
        assert ev == {"digest_epoch": 1, "digest_add": [4, 5],
                      "digest_del": [1]}
        ds.reset()
        ev = {}
        ds.stamp(ev, {7}, deltas=True)
        assert ev == {"prefix_digest": [7], "digest_epoch": 0}, \
            "reset must restart with a full snapshot"

    def test_stream_encoder_non_opted_client_gets_full_snapshots(self):
        from deepspeed_tpu_torch.serving.fabric.server import DigestStream

        ds = DigestStream()
        for digest in ({1, 2}, {1, 2}, {2, 3}):
            ev = {}
            ds.stamp(ev, digest, deltas=False)
            assert ev == {"prefix_digest": sorted(digest)}, \
                "a non-opted client must get a full snapshot every tick"

    def test_client_applies_deltas_in_sequence(self):
        h = self._handle()
        h._ev_status(self._status(prefix_digest=[1, 2, 3],
                                  digest_epoch=0))
        assert h.prefix_digest() == frozenset({1, 2, 3})
        h._ev_status(self._status(digest_epoch=1, digest_add=[4],
                                  digest_del=[1]))
        assert h.prefix_digest() == frozenset({2, 3, 4})
        h._ev_status(self._status())        # digest-less tick: keep
        assert h.prefix_digest() == frozenset({2, 3, 4})
        h._ev_status(self._status(digest_epoch=2, digest_del=[2]))
        assert h.prefix_digest() == frozenset({3, 4})

    def test_client_drops_to_blind_on_sequence_gap(self):
        h = self._handle()
        h._ev_status(self._status(prefix_digest=[1, 2], digest_epoch=0))
        h._ev_status(self._status(digest_epoch=5, digest_add=[9]))
        assert h.prefix_digest() == frozenset(), \
            "an out-of-sequence delta must drop to cache-blind"
        # the epoch resynced: the NEXT in-sequence delta rebuilds warmth
        h._ev_status(self._status(digest_epoch=6, digest_add=[9]))
        assert h.prefix_digest() == frozenset({9})

    def test_old_server_full_snapshots_still_decode(self):
        """An old peer never numbers its frames: every full snapshot
        replaces outright, and a delta can never (mis)apply."""
        h = self._handle()
        h._ev_status(self._status(prefix_digest=[1, 2]))    # no epoch
        assert h.prefix_digest() == frozenset({1, 2})
        assert h._digest_epoch is None
        h._ev_status(self._status(prefix_digest=[3]))
        assert h.prefix_digest() == frozenset({3})

    def test_new_client_hello_advertises_deltas(self):
        assert self._handle()._hello_payload(False)["digest_deltas"] \
            is True

    def test_end_to_end_deltas_over_real_server(self):
        """Live ReplicaServer + RemoteHandle with affinity on: the
        digest arrives (via the delta stream — the handle advertises
        ``digest_deltas``) and matches what a full snapshot would say."""
        scfg = ServingConfig(prefix_cache={"enabled": True},
                             affinity={"enabled": True,
                                       "refresh_interval_s": 0.05})
        with _Servers(1, server_config=scfg) as srv:
            fe = ServingFrontend([], fabric_cfg(
                srv.peers,
                affinity={"enabled": True, "refresh_interval_s": 0.05}))
            try:
                sys_prompt = prompts(1, 41, lo=40, hi=41)[0]
                ps = [sys_prompt + p for p in prompts(3, 42, lo=4, hi=8)]
                for p in ps:
                    run_fleet(fe, [p], 4)
                remote = fe.router.replicas[0]
                deadline = time.monotonic() + 15
                while not remote.prefix_digest() \
                        and time.monotonic() < deadline:
                    time.sleep(0.1)
                assert remote.prefix_digest(), \
                    "digest never arrived over the delta stream"
                assert remote._digest_epoch is not None, \
                    "a delta-advertising client must get numbered frames"
                want = srv.servers[0].replica.prefix_digest(
                    scfg.affinity.digest_max_entries)
                deadline = time.monotonic() + 10
                while remote.prefix_digest() != want \
                        and time.monotonic() < deadline:
                    time.sleep(0.1)
                assert remote.prefix_digest() == want, \
                    "delta-reassembled digest diverged from the source"
            finally:
                fe.shutdown(drain=False, timeout=5)


# ================================================= transport chaos edges
class TestTransportChaosEdges:
    """The wire's nastiest edges, driven deterministically by
    the fabric chaos injector (serving/fabric/chaos.py) instead of
    hand-rolled socket torture. Every failure must stay TYPED — the
    transport's existing guarantees are exercised, never widened."""

    @staticmethod
    def _pair(name_a="chaos-a", name_b="chaos-b", **kw):
        sa, sb = socket.socketpair()
        a = ftransport.Connection(sa, name=name_a, **kw)
        b = ftransport.Connection(sb, name=name_b, **kw)
        a.start()
        b.start()
        return a, b

    def test_chaos_disabled_is_zero_interposition(self):
        from deepspeed_tpu_torch.serving.fabric import chaos as fchaos

        assert fchaos.installed() is None
        a, b = self._pair()
        try:
            # no injector → the historical branch-free path
            assert a._chaos is None and b._chaos is None
        finally:
            a.close()
            b.close()
        # installed but non-matching schedule → still zero interposition
        inj = fchaos.install(fchaos.NetworkFaultInjector(
            [{"kind": "latency", "link": "some-other-link",
              "delay_s": 1.0}]))
        try:
            a, b = self._pair()
            try:
                assert a._chaos is None and b._chaos is None
            finally:
                a.close()
                b.close()
            assert inj.fired() == []
        finally:
            fchaos.uninstall()
        # and the default encode is the v1 wire, byte for byte: sealing
        # a frame elsewhere must not perturb the unsealed path
        obj = {"t": "ev", "x": 1, "a": np.arange(8, dtype=np.int32)}
        plain = fcodec.encode_frame(obj)
        sealed = fcodec.encode_frame(obj, crc=True)
        assert fcodec.encode_frame(obj) == plain
        assert sealed != plain and len(sealed) > len(plain)

    def test_half_open_blackhole_hits_staleness_not_socket(self,
                                                           monkeypatch):
        """The classic gray failure: rx silently discarded, tx fine,
        socket open. Only the staleness detector may call it — and the
        OTHER side (whose rx still flows) must stay alive."""
        from deepspeed_tpu_torch.serving.fabric import chaos as fchaos

        monkeypatch.setattr(ftransport, "STALE_FLOOR_S", 0.6)
        fchaos.install(fchaos.NetworkFaultInjector(
            [{"kind": "blackhole", "link": "half-open-a", "dir": "rx"}]))
        try:
            a, b = self._pair("half-open-a", "half-open-b",
                              heartbeat_s=0.1)
            try:
                deadline = time.monotonic() + 10
                while a.alive and time.monotonic() < deadline:
                    time.sleep(0.05)
                assert not a.alive, \
                    "blackholed rx never tripped the staleness detector"
                # half-open: a's SOCKET never died — staleness, not EOF
                assert not a._dead
                # asymmetric: b still receives a's pings → b stays alive
                assert b.alive
                assert fchaos.installed().fired("blackhole",
                                                "half-open-a")
            finally:
                a.close()
                b.close()
        finally:
            fchaos.uninstall()

    def test_partial_frame_at_connection_death_is_typed(self):
        """drop_conn with partial_bytes leaves the peer a length prefix
        promising more bytes than ever arrive: its reader must die with
        the typed mid-frame ConnectionLost, never hang or misparse."""
        from deepspeed_tpu_torch.serving.fabric import chaos as fchaos

        fchaos.install(fchaos.NetworkFaultInjector(
            [{"kind": "drop_conn", "link": "partial-a", "at_frame": 1,
              "partial_bytes": 3, "count": 1}]))
        try:
            got = []
            done = threading.Event()
            sa, sb = socket.socketpair()
            a = ftransport.Connection(sa, name="partial-a")

            def on_ev(m):
                got.append(m.get("k"))

            b = ftransport.Connection(
                sb, name="partial-b", on_event=on_ev,
                on_close=lambda reason: done.set())
            a.start()
            b.start()
            try:
                a.send({"t": "ev", "k": 0})     # frame 0 flows
                a.send({"t": "ev", "k": 1})     # frame 1: partial + kill
                assert done.wait(10), "peer reader never died"
                assert "EOF inside a fabric frame" in b.close_reason
                assert "chaos" in a.close_reason
                assert got == [0]
            finally:
                a.close()
                b.close()
        finally:
            fchaos.uninstall()

    def test_oversized_and_garbage_header_mid_stream(self):
        """A garbage length prefix over the bound is refused BEFORE
        allocation (FrameTooLarge kills the connection); an in-bound
        but undecodable body on an UNSEALED link is protocol divergence
        (typed death, never limping on)."""
        # oversized announced length
        sa, sb = socket.socketpair()
        dead = threading.Event()
        b = ftransport.Connection(sb, name="garbage-b",
                                  max_frame_bytes=4096,
                                  on_close=lambda r: dead.set())
        b.start()
        try:
            sa.sendall(ftransport.struct.pack(">I", 1 << 30))
            assert dead.wait(10)
            assert "FrameTooLarge" in b.close_reason
        finally:
            b.close()
            sa.close()
        # garbage body after a GOOD frame (mid-stream, not a bad dial)
        sa, sb = socket.socketpair()
        got = []
        dead = threading.Event()
        b = ftransport.Connection(sb, name="garbage-c",
                                  max_frame_bytes=4096,
                                  on_event=lambda m: got.append(m["k"]),
                                  on_close=lambda r: dead.set())
        b.start()
        try:
            good = fcodec.encode_frame({"t": "ev", "k": 7})
            sa.sendall(ftransport.struct.pack(">I", len(good)) + good)
            junk = b"\x00\x00\x00\x08not-json"
            sa.sendall(junk)
            assert dead.wait(10)
            assert "undecodable frame" in b.close_reason
            assert got == [7]
        finally:
            b.close()
            sa.close()

    def test_heartbeat_survives_throttled_link(self, monkeypatch):
        """A thin pipe is not a dead pipe: with the drip rate still
        letting ~heartbeat-sized frames through under the staleness
        window, both ends must stay alive for the whole throttle."""
        from deepspeed_tpu_torch.serving.fabric import chaos as fchaos

        monkeypatch.setattr(ftransport, "STALE_FLOOR_S", 1.0)
        fchaos.install(fchaos.NetworkFaultInjector(
            [{"kind": "throttle", "link": "thin-*", "dir": "tx",
              "bytes_per_s": 2048.0}]))
        try:
            a, b = self._pair("thin-a", "thin-b", heartbeat_s=0.2)
            try:
                deadline = time.monotonic() + 2.0
                while time.monotonic() < deadline:
                    assert a.alive and b.alive, \
                        "throttled-but-flowing link read as dead"
                    time.sleep(0.1)
                assert fchaos.installed().fired("throttle")
            finally:
                a.close()
                b.close()
        finally:
            fchaos.uninstall()

    def test_crc_corrupt_frame_is_single_refusal_not_death(self):
        """Partition tolerance on a sealed link: one flipped bit =
        one refused frame (typed, counted, on_corrupt fires) — the
        connection and every other frame on it survive."""
        from deepspeed_tpu_torch.serving.fabric import chaos as fchaos

        fchaos.install(fchaos.NetworkFaultInjector(
            [{"kind": "corrupt", "link": "crc-a", "dir": "tx",
              "at_frame": 1, "count": 1, "where": "payload"}]))
        try:
            got = []
            corrupt_cb = []
            sa, sb = socket.socketpair()
            a = ftransport.Connection(sa, name="crc-a")
            b = ftransport.Connection(
                sb, name="crc-b",
                on_event=lambda m: got.append(m.get("k")),
                on_corrupt=lambda: corrupt_cb.append(1))
            a.crc_tx = True
            b.crc_rx = True
            a.start()
            b.start()
            try:
                payload = np.arange(64, dtype=np.int32)
                for k in range(3):
                    a.send({"t": "ev", "k": k, "buf": payload})
                deadline = time.monotonic() + 10
                while len(got) < 2 and time.monotonic() < deadline:
                    time.sleep(0.02)
                assert got == [0, 2], got
                assert b.frames_corrupt == 1
                assert corrupt_cb == [1]
                assert b.alive and not b._dead, \
                    "a single corrupt frame killed a sealed connection"
            finally:
                a.close()
                b.close()
        finally:
            fchaos.uninstall()


# =========================================================== launch script
def _write_spec(tmp_path, **spec):
    base = {"model": MODEL_KW, "engine": ENGINE_KW, "seed": SEED,
            "serving": {}}
    base.update(spec)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(base))
    return str(path)


class TestServeReplicaScript:
    def test_subprocess_server_serves_jax_checkpoint(self, tmp_path):
        """The real thing: ``python -m deepspeed_tpu_torch.scripts.
        serve_replica --device cpu`` in its own process loads a universal
        checkpoint the JAX package saved and, adopted as a RemoteHandle,
        serves the JAX engine's greedy streams; on SIGTERM it stops cleanly
        and prints its kernel-launch line (the plain versions run here, so
        every count is 0) with the puts it ran."""
        import signal

        from deepspeed_tpu.runtime.checkpointing import _save_tree

        ckpt = tmp_path / "ckpt"
        tag_dir = ckpt / "t0"
        index = _save_tree(jax_weights(), str(tag_dir / "params"))
        (tag_dir / "manifest.json").write_text(
            json.dumps({"tag": "t0", "params_index": index}))
        (ckpt / "latest").write_text("t0")
        spec = _write_spec(tmp_path, checkpoint=str(ckpt), seed=123)
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.scripts.serve_replica",
             "--spec", spec, "--listen", "127.0.0.1:0", "--loopback-ok",
             "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=_REPO, env=dict(os.environ, PYTHONPATH=_REPO,
                                OMP_NUM_THREADS="1"))
        try:
            # the port's logger writes to stdout too: the tag line follows
            # the checkpoint load's
            for _ in range(20):
                line = proc.stdout.readline()
                if not line or line.startswith("FABRIC_LISTENING "):
                    break
            assert line.startswith("FABRIC_LISTENING 127.0.0.1:"), \
                (line, proc.stderr.read() if proc.poll() is not None
                 else "")
            ps = prompts(4, 23)
            ref = local_reference(ps, 5)
            fe = ServingFrontend([], fabric_cfg([line.split()[1]],
                                                heartbeat_s=1.0))
            try:
                got = run_fleet(fe, ps, 5, timeout=120)
            finally:
                fe.shutdown(drain=False, timeout=5)
            assert got == ref, "subprocess replica broke greedy parity"
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=30)
            assert proc.returncode == 0
            tag = [ln for ln in out.splitlines()
                   if ln.startswith("FABRIC_KERNELS ")]
            assert len(tag) == 1, out
            counts = json.loads(tag[0].split(" ", 1)[1])
            assert counts["puts"] > 0
            assert {k: v for k, v in counts.items() if k != "puts"} == {
                "paged_attention": 0, "quantize": 0,
                "quantized_matmul": 0, "dequantize": 0}
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

    def test_spec_dtype_by_name(self):
        """A JSON spec names the model's dtype: seeded weights of a 16-bit
        model are stored in it (the same draw in every process), an fp32
        model's in fp32, and a name that is no torch dtype is refused."""
        from deepspeed_tpu_torch.serving.config import ModelSpec
        from deepspeed_tpu_torch.serving.frontend import model_from_spec

        small = dict(MODEL_KW, num_layers=1)
        for name, want in (("bfloat16", torch.bfloat16),
                           ("float32", torch.float32)):
            spec = ModelSpec(model=dict(small, dtype=name), seed=3)
            model, params, _ = model_from_spec(spec, device="cpu")
            again = model_from_spec(spec, device="cpu")[1]
            assert model.cfg.dtype == want
            assert params["embed"]["wte"].dtype == want
            assert torch.equal(params["embed"]["wte"], again["embed"]["wte"])
        with pytest.raises(ValueError, match="not a torch dtype"):
            model_from_spec(ModelSpec(model=dict(small, dtype="bfloat17")),
                            device="cpu")

    def test_mesh_spec_refused_naming_item_14(self, tmp_path, capsys):
        from deepspeed_tpu_torch.scripts import serve_replica

        spec = _write_spec(tmp_path, mesh={"tensor": 2})
        assert serve_replica.main(["--spec", spec, "--device", "cpu"]) == 2
        assert "queue 1 item 14" in capsys.readouterr().err

    @pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA present")
    def test_no_cuda_without_device_cpu_exits_nonzero(self, tmp_path,
                                                      capsys):
        from deepspeed_tpu_torch.scripts import serve_frontend, serve_replica

        spec = _write_spec(tmp_path)
        assert serve_replica.main(["--spec", spec]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
        assert serve_frontend.main(["--spec", spec]) == 1
        assert "CUDA is not available" in capsys.readouterr().err
