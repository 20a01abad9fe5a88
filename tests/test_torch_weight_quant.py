"""Port parity: ``deepspeed_tpu_torch.inference.v2.weight_quant`` against the
JAX package's ``weight_quant.py`` on the CPU, and the exchange of quantized
trees through ``params_from_numpy``.

Weights come from the JAX ``CausalLM.init(PRNGKey(0))`` as numpy. Every
comparison is exact: quantization is bit-identical to ``_quantize_xla``
(``tests/test_torch_quantizer.py``), so the payloads must match byte for
byte and the scales bit for bit, and the byte accounting is integer
arithmetic on the same shapes and dtypes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import weight_quant as JW
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import weight_quant as TW
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy

UNTIED = dict(tie_embeddings=False)


def _cfgs(untied):
    extra = UNTIED if untied else {}
    return (dataclasses.replace(jtf.TINY_TEST, **extra),
            dataclasses.replace(ttf.TINY_TEST, **extra))


@pytest.fixture(scope="module", params=[False, True], ids=["tied", "untied"])
def trees(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jtf.CausalLM(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jax.tree.map(np.asarray, jp)


def _bytes(a):
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _assert_same_tree(jt, tt):
    assert isinstance(tt, dict) == isinstance(jt, dict)
    if isinstance(jt, dict):
        assert set(jt) == set(tt)
        for k in jt:
            _assert_same_tree(jt[k], tt[k])
        return
    jt = np.asarray(jt)
    assert tuple(tt.shape) == jt.shape
    assert tt.element_size() == jt.dtype.itemsize
    np.testing.assert_array_equal(_bytes(tt), _bytes(jt))


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_quantize_weights_matches_jax(trees, dtype):
    jcfg, tcfg, np_params = trees
    jq, jstats = JW.quantize_weights(jcfg, jax.tree.map(jnp.asarray,
                                                        np_params),
                                     dtype=dtype)
    tq, tstats = TW.quantize_weights(tcfg, params_from_numpy(np_params,
                                                             device="cpu"),
                                     dtype=dtype)
    _assert_same_tree(jq, tq)
    for name in TW.QUANTIZABLE_LAYER_LEAVES:
        node = tq["layers"][name]
        assert TW.is_quantized(node)
        assert node["qw"].dtype == (torch.int8 if dtype == "int8"
                                    else torch.float8_e4m3fn)
        assert node["qs"].dtype == torch.float32
    assert ("lm_head" in tq) == (not tcfg.tie_embeddings)
    if "lm_head" in tq:
        assert TW.is_quantized(tq["lm_head"]["w"])
    assert not TW.is_quantized(tq["embed"]["wte"])
    assert tstats == jstats


def test_param_stats_match_jax(trees):
    jcfg, tcfg, np_params = trees
    tp = params_from_numpy(np_params, device="cpu")
    assert TW.param_stats(tp) == JW.param_stats(
        jax.tree.map(jnp.asarray, np_params))
    tq, stats = TW.quantize_weights(tcfg, tp, block=32)
    jq, jstats = JW.quantize_weights(jcfg, jax.tree.map(jnp.asarray,
                                                        np_params), block=32)
    assert stats == jstats == JW.param_stats(jq, "int8", 32)
    assert stats["param_bytes_total"] < TW.param_stats(tp)["param_bytes_total"]


def test_skip_lists_match_jax(trees):
    jcfg, tcfg, np_params = trees
    skip = ["wq", "w_out", "lm_head"]
    jq, _ = JW.quantize_weights(jcfg, jax.tree.map(jnp.asarray, np_params),
                                skip=skip)
    tp = params_from_numpy(np_params, device="cpu")
    tq, stats = TW.quantize_weights(tcfg, tp, skip=skip)
    _assert_same_tree(jq, tq)
    assert tq["layers"]["wq"] is tp["layers"]["wq"]     # the same object
    assert not TW.is_quantized(tq["layers"]["w_out"])
    assert TW.is_quantized(tq["layers"]["wk"])
    assert stats["params_quantized"] == 5
    assert TW.DEFAULT_SKIP == JW.DEFAULT_SKIP
    assert TW.QUANTIZABLE_LAYER_LEAVES == JW.QUANTIZABLE_LAYER_LEAVES


def test_validation_errors():
    for bad in [dict(dtype="int3"), dict(dtype="fp8"), dict(block=0)]:
        kw = {"dtype": "int8", "block": 128, **bad}
        with pytest.raises(ValueError):
            TW.validate_weight_quant(kw["dtype"], kw["block"])
        with pytest.raises(ValueError):
            JW.validate_weight_quant(kw["dtype"], kw["block"])
    TW.validate_weight_quant("fp8_e4m3", 1)
    with pytest.raises(NotImplementedError, match="queue 1 item 14"):
        TW.quantize_weights(ttf.TINY_TEST, ttf.CausalLM(ttf.TINY_TEST).init(
            device="cpu"), tp=2)


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_params_from_numpy_carries_quantized_tree(trees, dtype):
    """A JAX-quantized tree crosses bit for bit; ``dtype=`` casts the dense
    floating leaves and never a member of a ``{"qw", "qs"}`` node."""
    jcfg, _, np_params = trees
    jq, _ = JW.quantize_weights(jcfg, jax.tree.map(jnp.asarray, np_params),
                                dtype=dtype)
    np_q = jax.tree.map(np.asarray, jq)
    tq = params_from_numpy(np_q, device="cpu")
    _assert_same_tree(jq, tq)
    want = torch.int8 if dtype == "int8" else torch.float8_e4m3fn
    assert tq["layers"]["wq"]["qw"].dtype == want
    cast = params_from_numpy(np_q, device="cpu", dtype=torch.bfloat16)
    for name in TW.QUANTIZABLE_LAYER_LEAVES:
        node = cast["layers"][name]
        assert node["qw"].dtype == want and node["qs"].dtype == torch.float32
        np.testing.assert_array_equal(_bytes(node["qw"]),
                                      _bytes(jq["layers"][name]["qw"]))
        np.testing.assert_array_equal(node["qs"].numpy(),
                                      np.asarray(jq["layers"][name]["qs"]))
    assert cast["embed"]["wte"].dtype == torch.bfloat16
