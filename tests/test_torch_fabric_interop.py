"""Port parity across the wire: a JAX-package process and a
``deepspeed_tpu_torch`` process speak one fabric protocol.

A JAX ``ServingFrontend`` adopts a port ``ReplicaServer``, and a port
frontend adopts a JAX server; a disaggregated fleet hands a finished
prompt's KV from a JAX prefill server to a port decode server (chunked,
fp32 and int8 KV pools with their scale planes) behind a JAX frontend. Servers run on threads over real TCP sockets; both packages'
engines hold the JAX ``init(PRNGKey(0))`` weights (the port's through
``params_from_numpy``). Every greedy stream must equal the JAX engine's
byte for byte, and no handoff may fall back to re-prefill.
"""

import time

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.testing import \
    greedy_generate as j_greedy_generate
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.serving import ServingConfig as JServingConfig
from deepspeed_tpu.serving import ServingFrontend as JFrontend
from deepspeed_tpu.serving.fabric.server import ReplicaServer as JServer
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
from deepspeed_tpu_torch.serving import ServingConfig as TServingConfig
from deepspeed_tpu_torch.serving import ServingFrontend as TFrontend
from deepspeed_tpu_torch.serving.fabric.server import ReplicaServer as TServer
import torch_cpu  # noqa: F401  (one torch thread: see the module)

VOCAB = 128
MODEL_KW = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=2, max_seq_len=256, norm="rmsnorm",
                activation="silu", position="rope")
ENGINE_KW = dict(max_ragged_batch_size=128, max_ragged_sequence_count=4,
                 max_chunk_tokens=32, kv_blocks=64, kv_block_size=8,
                 max_tracked_sequences=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    jp = jtf.CausalLM(jtf.TransformerConfig(**MODEL_KW)).init(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def engines(weights):
    """Engine factories of both packages over the same weights."""
    tparams = params_from_numpy(weights, device="cpu")
    jmodel = jtf.CausalLM(jtf.TransformerConfig(**MODEL_KW))

    def jax_engine(**over):
        return JEngine(jmodel, params=weights,
                       config=JConfig(**dict(ENGINE_KW, **over)))

    def port_engine(**over):
        return InferenceEngineV2(
            ttf.CausalLM(ttf.TransformerConfig(**MODEL_KW)), params=tparams,
            config=RaggedInferenceEngineConfig(**dict(ENGINE_KW, **over)),
            device="cpu")

    return {"jax": jax_engine, "port": port_engine}


_refs = {}


def reference(engines, ps, max_new, kv_quant=None):
    """The JAX engine's greedy streams (one engine a KV dtype)."""
    if kv_quant not in _refs:
        over = ({} if kv_quant is None
                else {"kv_quant_enabled": True, "kv_quant_dtype": kv_quant})
        _refs[kv_quant] = [engines["jax"](**over), 0]
    ref = _refs[kv_quant]
    out = j_greedy_generate(ref[0], ps, uid_base=ref[1],
                            max_new_tokens=max_new, sequential=False)
    ref[1] += len(ps)
    return [list(o) for o in out]


def prompts(n, seed, lo=8, hi=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(k)).tolist()
            for k in rng.integers(lo, hi, size=n)]


def fabric(peers, **extra):
    return dict(max_queue_depth=64,
                fabric={"enabled": True, "peers": list(peers),
                        "heartbeat_s": 0.3, "rpc_timeout_s": 60.0},
                **extra)


SERVERS = {"jax": (JServer, JServingConfig), "port": (TServer, TServingConfig)}
FRONTENDS = {"jax": (JFrontend, JServingConfig),
             "port": (TFrontend, TServingConfig)}


def serve(front, servers, engines, ps, max_new, server_cfg=None,
          **fe_extra):
    """Start one threaded server a ``(package, engine kwargs)`` entry,
    adopt them all behind a ``front`` frontend, serve ``ps``; returns the
    streams and the frontend's metrics after the forwarded counters
    settled."""
    started = []
    try:
        for i, (pkg, over) in enumerate(servers):
            cls, cfg = SERVERS[pkg]
            srv = cls(lambda pkg=pkg, over=over: engines[pkg](**over),
                      cfg(**(server_cfg or {})), listen="127.0.0.1:0",
                      replica_id=i, heartbeat_s=0.3)
            srv.start()
            started.append(srv)
        fcls, fcfg = FRONTENDS[front]
        fe = fcls([], fcfg(**fabric([f"127.0.0.1:{s.port}"
                                     for s in started], **fe_extra)))
        try:
            assert all(getattr(r, "is_remote", False)
                       for r in fe.router.replicas)
            hs = [fe.submit(p, max_new_tokens=max_new) for p in ps]
            assert fe.wait_all(hs, timeout=120), [h.state for h in hs]
            got = [[ev.token for ev in h.drain()] for h in hs]
            snap = fe.metrics_snapshot()
            deadline = time.monotonic() + 10
            while snap.get("handoffs_started", 0) \
                    > snap.get("handoffs_completed", 0) \
                    + snap.get("handoff_fallbacks", 0) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)      # the import count rides a status tick
                snap = fe.metrics_snapshot()
        finally:
            fe.shutdown(drain=False, timeout=5)
    finally:
        for srv in started:
            srv.stop()
    return got, snap


@pytest.mark.parametrize("front,server", [("jax", "port"), ("port", "jax")])
def test_frontend_adopts_other_package_server(engines, front, server):
    """A frontend of one package serves through a replica server of the
    other: the hello, assign, token, finish and status frames all cross,
    and the streams are the JAX engine's."""
    ps = prompts(4, 51)
    got, snap = serve(front, [(server, {})], engines, ps, 6)
    assert got == reference(engines, ps, 6)
    assert snap["requests_completed"] == len(ps)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_cross_package_kv_handoff(engines, kv):
    """Disaggregated serving behind a JAX frontend with a JAX prefill
    server and a port decode server: each prompt's KV
    (chunked a block a frame; int8 codes with their fp32 scale planes)
    crosses the wire between packages and the decode server resumes the
    JAX engine's stream; no handoff falls back."""
    ps = prompts(4, 52, lo=12, hi=28)
    disagg = {"enabled": True, "roles": ["prefill", "decode"],
              "handoff": {"enabled": True, "max_staged": 8,
                          "chunk_blocks": 1}}
    over = ({} if kv is None
            else {"kv_quant_enabled": True, "kv_quant_dtype": kv})
    got, snap = serve("jax", [("jax", over), ("port", over)], engines, ps,
                      5, server_cfg={"disaggregation": disagg},
                      disaggregation=disagg)
    assert snap["handoffs_started"] == len(ps)
    assert snap["handoffs_completed"] == len(ps)
    assert snap["handoff_fallbacks"] == 0
    assert got == reference(engines, ps, 5, kv_quant=kv)
