"""Port parity: quantized serving (int8/fp8 weights and KV) through
``deepspeed_tpu_torch``'s ``InferenceEngineV2`` and the Dynamic SplitFuse
scheduler against the JAX engine on the CPU.

Weights are the JAX ``init(PRNGKey(0))`` x4 of ``tests/test_torch_engine.py``
(so the streams are not one repeated token). On fp32 ``TINY_TEST`` for
weight-only int8, KV-only int8, int8/int8 and fp8/fp8, and on an untied
variant, whose ``lm_head`` quantizes too, for the two weight codes (int8
weights, fp8 weights with fp8 KV; its KV path is the tied model's, and each
case costs seconds of JAX compilation):

- greedy streams, sequential and concurrent, must be byte-identical to the
  JAX engine's;
- after the run the KV scale planes agree to rtol 1e-5 and the pool codes
  are at most one code apart and identical in at least 99.9% of elements:
  the K/V that reach the writer come from fp32 matmuls summed in another
  order, and a last-ulp difference can move a value across a rounding
  boundary of the quantizer;
- every block comes back, and the occupancy's bytes per block is the
  quantized formula.

The ``configure_kv_quant``/``configure_weight_quant`` guards mirror the JAX
package's (``tests/test_kv_quant.py``, ``tests/test_weight_quant.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2 import kv_quant as JK
from deepspeed_tpu.inference.v2.testing import greedy_generate as j_greedy
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.testing import (assert_greedy_parity,
                                                      greedy_generate)
from deepspeed_tpu_torch.inference.v2.weight_quant import is_quantized
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy

ENGINE_KW = dict(kv_blocks=48, kv_block_size=16, max_chunk_tokens=16,
                 max_ragged_batch_size=40, max_ragged_sequence_count=4)
PROMPT_LENS = (5, 40, 17, 33, 3)
NEW_TOKENS = 10
QUANT = {
    "w-int8": dict(weight_quant_enabled=True),
    "kv-int8": dict(kv_quant_enabled=True),
    "int8-int8": dict(weight_quant_enabled=True, kv_quant_enabled=True),
    "fp8-fp8": dict(weight_quant_enabled=True, kv_quant_enabled=True,
                    weight_quant_dtype="fp8_e4m3",
                    kv_quant_dtype="fp8_e4m3"),
}
MODELS = {"tiny": {}, "untied": {"tie_embeddings": False}}


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, extra in MODELS.items():
        jcfg = dataclasses.replace(jtf.TINY_TEST, **extra)
        jp = jtf.CausalLM(jcfg).init(jax.random.PRNGKey(0))
        out[name] = jax.tree.map(
            lambda a: np.asarray(a) * (4 if a.ndim >= 2 else 1), jp)
    return out


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


def _port_engine(weights, model="tiny", **quant):
    cfg = dataclasses.replace(ttf.TINY_TEST, **MODELS[model])
    return InferenceEngineV2(ttf.CausalLM(cfg),
                             params_from_numpy(weights[model], device="cpu"),
                             RaggedInferenceEngineConfig(**ENGINE_KW, **quant),
                             device="cpu")


def _ordered_codes(pool):
    """Pool codes as integers ordered like their values: int8 as is,
    e4m3 bytes as sign-magnitude (adjacent values differ by one)."""
    if isinstance(pool, torch.Tensor):
        b = pool.view(torch.uint8).numpy() if pool.dtype != torch.int8 \
            else pool.numpy().view(np.uint8)
        fp8 = pool.dtype == torch.float8_e4m3fn
    else:
        b = np.asarray(pool).view(np.uint8)
        fp8 = np.asarray(pool).dtype.name == "float8_e4m3fn"
    if not fp8:
        return b.view(np.int8).astype(np.int32)
    mag = (b & 0x7F).astype(np.int32)
    return np.where(b & 0x80, -mag, mag)


CASES = [(m, q) for m in MODELS for q in QUANT
         if m == "tiny" or q in ("w-int8", "fp8-fp8")]


@pytest.mark.parametrize("model,quant", CASES)
def test_quantized_greedy_streams_match_jax(weights, model, quant):
    qkw = QUANT[quant]
    jcfg = dataclasses.replace(jtf.TINY_TEST, **MODELS[model])
    jeng = JEngine(jtf.CausalLM(jcfg),
                   jax.tree.map(jax.numpy.asarray, weights[model]),
                   JConfig(**ENGINE_KW, **qkw))
    eng = _port_engine(weights, model, **qkw)
    if qkw.get("weight_quant_enabled"):
        assert is_quantized(eng.params["layers"]["w_in"])
        assert is_quantized(eng.params["lm_head"]["w"]) \
            if model == "untied" else "lm_head" not in eng.params
    for sequential, base in ((True, 0), (False, 100)):
        ref = j_greedy(jeng, _prompts(), max_new_tokens=NEW_TOKENS,
                       sequential=sequential, uid_base=base)
        assert len({tuple(s) for s in ref}) == len(ref)   # not degenerate
        got = greedy_generate(eng, _prompts(), max_new_tokens=NEW_TOKENS,
                              sequential=sequential, uid_base=base)
        assert_greedy_parity(ref, got, f"the torch port ({model}, {quant})")
        if sequential and qkw.get("kv_quant_enabled"):
            jc, tc = jeng.state_manager.kv_cache, eng.state_manager.kv_cache
            for s in ("k_scale", "v_scale"):
                np.testing.assert_allclose(tc[s].numpy(), np.asarray(jc[s]),
                                           rtol=1e-5, atol=0, err_msg=s)
            for p in ("k", "v"):
                d = np.abs(_ordered_codes(tc[p]) - _ordered_codes(jc[p]))
                assert d.max() <= 1, (p, d.max())
                assert (d == 0).mean() >= 0.999, (p, (d == 0).mean())
    assert eng.free_blocks == ENGINE_KW["kv_blocks"]
    assert eng.state_manager.tracked_sequences == []
    occ = eng.occupancy()
    assert occ["bytes_per_block"] == jeng.occupancy()["bytes_per_block"]
    if qkw.get("kv_quant_enabled"):
        # 1-byte K and V slabs plus two f32 scales per (layer, kv head)
        assert occ["bytes_per_block"] == (2 * 2 * 2 * 16 * 16 * 1
                                          + 2 * 2 * 2 * 4)
        assert occ["bytes_per_block"] == JK.kv_bytes_per_block(
            jcfg, 16, True)


def test_configure_kv_quant_toggle_and_guard(weights):
    eng = _port_engine(weights)
    eng.configure_kv_quant(True)
    assert eng.state_manager.kv_quant
    assert eng.state_manager.kv_cache["k"].dtype == torch.int8
    eng.put([1], [_prompts()[1][:10]])
    with pytest.raises(RuntimeError, match="tracked"):
        eng.configure_kv_quant(False)
    eng.configure_kv_quant(True)        # unchanged: a no-op, legal
    eng.flush(1)
    eng.configure_kv_quant(False)
    assert set(eng.state_manager.kv_cache) == {"k", "v"}
    with pytest.raises(ValueError, match="dtype"):
        eng.configure_kv_quant(True, dtype="fp8")
    assert not eng.config.kv_quant_enabled
    eng.configure_kv_quant(True, dtype="fp8_e4m3")
    assert eng.state_manager.kv_cache["k"].dtype == torch.float8_e4m3fn
    assert eng.state_manager.kv_quant_dtype == "fp8_e4m3"
    with pytest.raises(ValueError, match="dtype"):
        _port_engine(weights, kv_quant_enabled=True, kv_quant_dtype="int4")


def test_configure_weight_quant_guards(weights):
    eng = _port_engine(weights)
    eng.put([1], [_prompts()[1][:10]])
    with pytest.raises(RuntimeError, match="tracked"):
        eng.configure_weight_quant(True)
    eng.flush(1)
    eng.configure_weight_quant(True)
    assert eng.config.weight_quant_enabled
    assert is_quantized(eng.params["layers"]["wq"])
    eng.configure_weight_quant(True)    # same representation: a no-op
    with pytest.raises(RuntimeError, match="already quantized"):
        eng.configure_weight_quant(False)
    with pytest.raises(RuntimeError, match="already quantized"):
        eng.configure_weight_quant(True, dtype="fp8_e4m3")
    eng2 = _port_engine(weights)
    with pytest.raises(ValueError, match="dtype"):
        eng2.configure_weight_quant(True, dtype="int3")
    assert not eng2.config.weight_quant_enabled


def test_param_stats_shape(weights):
    off = _port_engine(weights, "untied")
    on = _port_engine(weights, "untied", weight_quant_enabled=True)
    s_off, s_on = off.param_stats(), on.param_stats()
    assert s_off["param_bytes_quantized"] == 0
    assert s_on["param_bytes_quantized"] > 0
    assert s_on["param_bytes_total"] < s_off["param_bytes_total"]
    assert s_on["weight_quant_dtype"] == "int8"
    assert s_on["params_quantized"] == 8        # 7 layer leaves + lm_head
