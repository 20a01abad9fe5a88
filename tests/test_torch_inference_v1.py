"""Port parity: v1 inference of ``deepspeed_tpu_torch`` (``init_inference``
-> ``InferenceEngine.forward``/``generate``, with ZeRO-Inference int8/int4
weight-only quantization) against the JAX package on the CPU.

Weights come from the JAX ``CausalLM.init`` and reach the port as numpy:
as drawn (std 0.02) where logits and caches are compared, x4 for leaves of
two dims or more where greedy streams are (so that they are not one
repeated token). The models are fp32, and so is the arithmetic on both
sides.

- ``quantize_param_tree``: the same leaves become QuantTensors, with codes
  and scales bit for bit the JAX package's at bits 8 and 4 (packed int4 as
  bytes), and ``tree_nbytes`` is equal. Dequantization, whole and by row
  gather, is bit for bit too (one fp32 product an element on both sides).
- ``prefill``/``decode_step`` (contiguous cache) and ``prefill_paged``/
  ``decode_step_paged`` (pool cache): logits and caches to atol 1e-5 (fp32
  sums in other orders) on TINY_TEST and on an ALiBi (BLOOM-like), a
  learned-position (GPT-2-like) and a sliding-window (Mistral-like)
  variant, with and without quantization; and once with
  ``quantize_param_tree(..., min_size=64)``, so that the ``[L, H]`` norm
  stacks are QuantTensors as they are at full width.
- ``generate``: greedy streams byte-identical to the JAX engine's for quant
  off, 8 and 4 bits, ragged prompts, ``eos_token_id`` (int and list),
  ``pad_token_id`` and ``prompt_len``; ``forward`` logits on a quantized
  tree to atol 1e-5.
- Sampled streams (``jax.random`` cannot be reproduced) are held to their
  contract: each token in the step's top-k set, one seed one stream.
- The config surface (``tp`` alias, unported keys raise), the weight
  exchange of QuantTensor trees both ways, and import hygiene.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import quantization as jquant
from deepspeed_tpu.inference.config import InferenceConfig as JConfig
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import topology as topo
from deepspeed_tpu_torch.inference import quantization as tquant
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import (params_from_numpy,
                                                params_to_numpy)

ATOL = 1e-5

VARIANTS = {
    "tiny": {},
    "alibi": dict(position="alibi", norm="layernorm", activation="gelu",
                  use_bias=True, embedding_layernorm=True),
    "learned": dict(position="learned", norm="layernorm",
                    activation="gelu_exact", use_bias=True),
    "window": dict(sliding_window=6, tie_embeddings=False),
}


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jtf.TINY_TEST, **kw),
            dataclasses.replace(ttf.TINY_TEST, **kw))


_WEIGHTS = {}


def _weights(variant, scale=4):
    """The JAX init of a variant as numpy, ``scale`` times for leaves of
    two dims or more (cached: each variant is drawn once)."""
    if variant not in _WEIGHTS:
        jcfg, _ = _cfgs(variant)
        _WEIGHTS[variant] = jax.tree.map(
            np.asarray, jtf.CausalLM(jcfg).init(jax.random.PRNGKey(0)))
    return jax.tree.map(lambda a: a * (scale if a.ndim >= 2 else 1),
                        _WEIGHTS[variant])


def _is_jq(x):
    return isinstance(x, jquant.QuantTensor)


def _trees(variant, bits=None, min_size=4096):
    """(JAX params, port params) for a variant as drawn, quantized in each
    package with its own quantize_param_tree when ``bits`` is given."""
    w = _weights(variant, scale=1)
    jp = jax.tree.map(jnp.asarray, w)
    tp = params_from_numpy(w, device="cpu")
    if bits:
        jp = jquant.quantize_param_tree(jp, bits=bits, min_size=min_size)
        tp = tquant.quantize_param_tree(tp, bits=bits, min_size=min_size)
    return jp, tp


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _bytes(a):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.view(np.uint8)


# ------------------------------------------------------------- quantization

@pytest.mark.parametrize("min_size", [4096, 64])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_param_tree_bit_identical(bits, min_size):
    jp, tp = _trees("alibi", bits, min_size)
    jflat = {".".join(p.key for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jp, is_leaf=_is_jq)[0]}
    tflat = _flat(tp)
    assert set(jflat) == set(tflat)
    n_quant = 0
    for name, jl in jflat.items():
        tl = tflat[name]
        assert _is_jq(jl) == isinstance(tl, tquant.QuantTensor), name
        if not _is_jq(jl):
            np.testing.assert_array_equal(_np(tl), _np(jl))
            continue
        n_quant += 1
        assert (tl.block, tl.bits, tl.packed) == (jl.block, jl.bits,
                                                  jl.packed), name
        assert tl.shape == tuple(jl.shape) and tl.ndim == jl.ndim
        np.testing.assert_array_equal(_bytes(tl.q), _bytes(jl.q), err_msg=name)
        np.testing.assert_array_equal(tl.scales.numpy(), np.asarray(jl.scales))
        assert tl.nbytes == jl.nbytes
    # min_size 64 quantizes the [L, H] norm and bias stacks too
    assert isinstance(tp["layers"]["attn_norm_w"], tquant.QuantTensor) \
        == (min_size == 64)
    assert not isinstance(tp["final_norm"]["w"], tquant.QuantTensor)
    assert n_quant >= (7 if min_size == 4096 else 15)
    assert tquant.tree_nbytes(tp) == jquant.tree_nbytes(jp)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_tensor_surface_matches_jax(bits):
    jp, tp = _trees("tiny", bits)
    jw, tw = jp["embed"]["wte"], tp["embed"]["wte"]
    assert tw.shape == tuple(jw.shape) and tw.dtype == torch.float32
    assert tw.packed == (bits == 4)
    for dtype in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            _np(tw.dequantize(getattr(torch, dtype))),
            _np(jw.dequantize(jnp.dtype(dtype))))
    idx = np.array([[3, 0, 255], [7, 7, 1]])
    np.testing.assert_array_equal(_np(tw[torch.as_tensor(idx)]),
                                  _np(jw[jnp.asarray(idx)]))
    layers = tp["layers"]["wq"].unbind(0)
    assert len(layers) == ttf.TINY_TEST.num_layers
    for i, lq in enumerate(layers):
        assert (lq.block, lq.bits, lq.packed, lq.out_dtype) == (
            tw.block, bits, bits == 4, torch.float32)
        np.testing.assert_array_equal(
            _np(lq.dequantize()),
            _np(jp["layers"]["wq"].dequantize())[i])


# ------------------------------------------------------ model-level parity

def _prompt(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _close(got, ref, what):
    np.testing.assert_allclose(_np(got), _np(ref), atol=ATOL, rtol=0,
                               err_msg=what)


CACHE_CASES = [(v, None, 4096) for v in VARIANTS] + [
    ("tiny", 8, 4096), ("alibi", 4, 4096), ("window", 8, 64)]


@pytest.mark.parametrize("variant,bits,min_size", CACHE_CASES)
def test_prefill_and_decode_match_jax(variant, bits, min_size):
    """Contiguous and paged caches: logits and the caches themselves."""
    jcfg, tcfg = _cfgs(variant)
    jm, tm = jtf.CausalLM(jcfg), ttf.CausalLM(tcfg)
    jp, tp = _trees(variant, bits, min_size)
    B, T, max_len = 2, 9, 16
    toks = _prompt(jcfg, B, T, seed=len(variant))

    jc = jm.init_cache(B, max_len)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    tc = tm.init_cache(B, max_len, device="cpu")
    tl, tc = tm.prefill(tp, torch.as_tensor(toks), tc)
    _close(tl, jl, "prefill logits")
    for pos in range(T, T + 3):
        nxt = np.array(jnp.argmax(jl[:, -1] if jl.ndim == 3 else jl,
                                    axis=-1), np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), pos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt), pos)
        _close(tl, jl, f"decode logits at {pos}")
    _close(tc["k"], jc["k"], "k cache")
    _close(tc["v"], jc["v"], "v cache")

    plen = np.array([T, 5], np.int32)
    jc, jt = jm.init_paged_cache(B, max_len, 4)
    tc, tt = tm.init_paged_cache(B, max_len, 4, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jl, jc = jm.prefill_paged(jp, jnp.asarray(toks), jnp.asarray(plen), jc,
                              jt)
    tl, tc = tm.prefill_paged(tp, torch.as_tensor(toks),
                              torch.as_tensor(plen), tc, tt)
    _close(tl, jl, "paged prefill logits")
    nxt = np.array(jnp.argmax(jl[np.arange(B), plen - 1], axis=-1),
                     np.int32)
    for i in range(3):
        pos = plen + i
        jl, jc = jm.decode_step_paged(jp, jc, jt, jnp.asarray(nxt),
                                      jnp.asarray(pos))
        tl, tc = tm.decode_step_paged(tp, tc, tt, torch.from_numpy(nxt),
                                      torch.as_tensor(pos))
        _close(tl, jl, f"paged decode logits, step {i}")
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    _close(tc["k"], jc["k"], "k pool")
    _close(tc["v"], jc["v"], "v pool")


@pytest.mark.parametrize("bits", [8, 4])
def test_apply_on_quantized_tree_matches_jax(bits):
    jcfg, tcfg = _cfgs("learned")
    jp, tp = _trees("learned", bits, 64)
    toks = _prompt(jcfg, 2, 7, seed=3)
    _close(ttf.CausalLM(tcfg).apply(tp, torch.as_tensor(toks)),
           jtf.CausalLM(jcfg).apply(jp, jnp.asarray(toks)), "apply logits")


# ------------------------------------------------------------- the engine

def _engines(variant, config, params=None):
    jcfg, tcfg = _cfgs(variant)
    w = _weights(variant) if params is None else params
    topo.reset_topology()
    je = deepspeed_tpu.init_inference(jtf.CausalLM(jcfg), config=dict(config),
                                      params=jax.tree.map(jnp.asarray, w))
    te = deepspeed_tpu_torch.init_inference(ttf.CausalLM(tcfg),
                                            config=dict(config), params=w,
                                            device="cpu")
    return je, te


def _ragged(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]


GEN_CASES = [
    # variant, quant bits, generate kwargs
    ("tiny", None, {}),
    ("tiny", 8, {}),
    ("tiny", 4, {}),
    ("window", 8, {"eos_token_id": None}),
    ("tiny", None, {"eos_token_id": "first"}),
    ("tiny", 8, {"eos_token_id": "list", "pad_token_id": 99}),
    ("alibi", 4, {"pad_token_id": 7}),
]


@pytest.mark.parametrize("variant,bits,kw", GEN_CASES)
def test_generate_greedy_byte_identical(variant, bits, kw):
    config = {"dtype": "fp32"}
    if bits:
        config["quant"] = {"enabled": True, "bits": bits}
    je, te = _engines(variant, config)
    assert isinstance(te.params["layers"]["wq"], tquant.QuantTensor) \
        == bool(bits)
    jcfg, _ = _cfgs(variant)
    prompts = _ragged(jcfg, (3, 11, 6), seed=len(variant))
    kw = dict(kw)
    if kw.get("eos_token_id") in ("first", "list"):
        # an EOS that the plain run emits early, so that pad follows it
        free = np.asarray(je.generate(prompts, max_new_tokens=8))
        tok = int(free[1, 11 + 2])
        kw["eos_token_id"] = tok if kw["eos_token_id"] == "first" \
            else [int(free[0, 3 + 1]), tok]
    ref = np.asarray(je.generate(prompts, max_new_tokens=8, **kw))
    got = te.generate(prompts, max_new_tokens=8, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    if "eos_token_id" in kw and kw["eos_token_id"] is not None:
        pad = kw.get("pad_token_id", 0)
        assert (got.numpy()[1, 11 + 3:] == pad).all()
    topo.reset_topology()


def test_generate_prompt_len_and_quantized_norm_stacks():
    """A padded [B, T] array with ``prompt_len``, on a tree quantized with
    min_size=64 (the [L, H] norm stacks are QuantTensors, as at full
    width): the same stream as the JAX engine's."""
    config = {"dtype": "fp32"}
    je, te = _engines("tiny", config)
    je.params = jquant.quantize_param_tree(je.params, bits=8, min_size=64)
    te.params = tquant.quantize_param_tree(te.params, bits=8, min_size=64)
    assert isinstance(te.params["layers"]["mlp_norm_w"], tquant.QuantTensor)
    toks = _prompt(jtf.TINY_TEST, 3, 10, seed=9)
    plen = np.array([10, 4, 7], np.int32)
    ref = np.asarray(je.generate(jnp.asarray(toks), max_new_tokens=6,
                                 prompt_len=plen, pad_token_id=3))
    got = te.generate(toks, max_new_tokens=6, prompt_len=plen,
                      pad_token_id=3)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(_np(te.forward(toks[:1])),
                               _np(je.forward(jnp.asarray(toks[:1]))),
                               atol=ATOL, rtol=0)
    topo.reset_topology()


@pytest.mark.parametrize("bits", [None, 8])
def test_forward_matches_jax(bits):
    config = {"dtype": "fp32"}
    if bits:
        config["quant"] = {"enabled": True, "bits": bits}
    je, te = _engines("window", config)
    toks = _prompt(jtf.TINY_TEST, 2, 12, seed=4)
    _close(te(toks), je(jnp.asarray(toks)), "forward logits")
    topo.reset_topology()


def test_generate_validation_and_clamp(caplog):
    te = deepspeed_tpu_torch.init_inference(
        ttf.CausalLM(ttf.TINY_TEST), config={"dtype": "fp32"},
        params=_weights("tiny"), device="cpu")
    toks = _prompt(jtf.TINY_TEST, 2, 5)
    with pytest.raises(ValueError, match="prompt_len"):
        te.generate(toks, prompt_len=[5, 0])
    with pytest.raises(ValueError, match="prompt_len"):
        te.generate(toks, prompt_len=[5])
    ctx = ttf.TINY_TEST.max_seq_len
    with pytest.raises(ValueError, match="max_seq_len"):
        te.generate(np.zeros((1, ctx), np.int32))
    out = te.generate(np.ones((1, ctx - 3), np.int32), max_new_tokens=10)
    assert tuple(out.shape) == (1, ctx)         # clamped to 3 new tokens


def test_sampling_contract():
    """temperature > 0: every token lies in the top-k set of its step's
    logits; one generator seed gives one stream."""
    te = deepspeed_tpu_torch.init_inference(
        ttf.CausalLM(ttf.TINY_TEST), config={"dtype": "fp32"},
        params=_weights("tiny"), device="cpu")
    seen = []
    sample = te._sample

    def recording(logits, gen, temperature, top_k):
        out = sample(logits, gen, temperature, top_k)
        seen.append((logits.clone(), out.clone()))
        return out

    te._sample = recording
    prompts = _ragged(jtf.TINY_TEST, (4, 9), seed=5)
    a = te.generate(prompts, max_new_tokens=12, temperature=1.5, top_k=5,
                    rng=11)
    assert len(seen) == 12
    for logits, tok in seen:
        top = torch.topk(logits, 5, dim=-1).indices
        assert (top == tok.long()[:, None]).any(dim=-1).all()
    te._sample = sample
    b = te.generate(prompts, max_new_tokens=12, temperature=1.5, top_k=5,
                    rng=torch.Generator().manual_seed(11))
    c = te.generate(prompts, max_new_tokens=12, temperature=1.5, top_k=5,
                    rng=12)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), c.numpy())
    greedy = te.generate(prompts, max_new_tokens=12)
    assert not np.array_equal(a.numpy(), greedy.numpy())


def test_default_params_and_model_by_name():
    """``params=None`` draws fp32 weights from a generator seeded 0; a
    model given by name resolves through ``models.MODEL_CONFIGS``."""
    from deepspeed_tpu_torch.models import MODEL_CONFIGS, build_model

    e1 = deepspeed_tpu_torch.init_inference("tiny", dtype="fp32",
                                            device="cpu")
    e2 = InferenceEngine(build_model("tiny"), config={"dtype": "fp32"},
                         device="cpu")
    assert e1.module.cfg == MODEL_CONFIGS["tiny"]
    for a, b in zip(_flat(e1.params).values(), _flat(e2.params).values()):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    # the compute dtype follows the config (bf16 by default)
    e3 = deepspeed_tpu_torch.init_inference("tiny", device="cpu")
    assert e3.module.cfg.dtype == torch.bfloat16
    assert e3.params["layers"]["wq"].dtype == torch.float32
    assert e3.forward([[1, 2, 3]]).dtype == torch.bfloat16


# ------------------------------------------------- config and the surface

def test_config_surface_matches_jax():
    assert InferenceConfig().to_dict() == JConfig().model_dump()
    for key in ("tp", "tensor_parallel"):
        c = InferenceConfig(**{key: {"tp_size": 1, "enabled": False}})
        assert c.tensor_parallel.tp_size == 1 \
            and c.tensor_parallel.enabled is False
        j = JConfig(**{key: {"tp_size": 1, "enabled": False}})
        assert c.to_dict() == j.model_dump()
    c = InferenceConfig(quant={"enabled": True, "bits": 4},
                        replace_with_kernel_inject=True,
                        enable_cuda_graph=True, unknown_key=3)
    assert c.quant.bits == 4 and c.unknown_key == 3


@pytest.mark.parametrize("config", [
    {"tp": {"tp_size": 2}}, {"tensor_parallel": {"tp_size": 4}},
    {"checkpoint": "/nowhere"}, {"ep_size": 2}, {"moe": {"enabled": True}},
    {"save_mp_checkpoint_path": "/nowhere"}])
def test_unported_config_keys_raise(config):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_inference("tiny", config=config,
                                           device="cpu")


def test_unported_surfaces_raise():
    te = deepspeed_tpu_torch.init_inference("tiny", device="cpu")
    for call in (lambda: te.encode([[1]]), lambda: te.mlm([[1]]),
                 lambda: te.classify([[1]]),
                 lambda: te.load_checkpoint("/nowhere"),
                 te.profile_model_time):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_inference("tiny", mesh=object(),
                                           device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.init_inference(None, device="cpu")


def test_entry_point_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference("tiny")


# -------------------------------------------------------- weight exchange

@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tree_crosses_both_ways(bits):
    jp = jquant.quantize_param_tree(
        jax.tree.map(jnp.asarray, _weights("tiny")), bits=bits, min_size=64)
    as_np = jax.tree.map(np.asarray, jp)        # QuantTensor nodes kept
    tp = params_from_numpy(as_np, device="cpu")
    tq = tp["layers"]["attn_norm_w"]
    assert isinstance(tq, tquant.QuantTensor) and tq.out_dtype == torch.float32
    back = params_to_numpy(tp)
    bq = back["embed"]["wte"]
    assert isinstance(bq, tquant.QuantTensor) and bq.out_dtype == "float32"
    jq2 = jquant.QuantTensor(jnp.asarray(bq.q), jnp.asarray(bq.scales),
                             bq.block, bq.bits, bq.packed,
                             jnp.dtype(bq.out_dtype))
    orig = jp["embed"]["wte"]
    np.testing.assert_array_equal(_bytes(jq2.q), _bytes(orig.q))
    np.testing.assert_array_equal(np.asarray(jq2.scales),
                                  np.asarray(orig.scales))
    assert (jq2.block, jq2.bits, jq2.packed) == (orig.block, orig.bits,
                                                 orig.packed)
    np.testing.assert_array_equal(_np(jq2.dequantize()),
                                  _np(tp["embed"]["wte"].dequantize()))
    # a bf16 source keeps its out_dtype by name
    bf = tquant.quantize_array(torch.ones(4, 64, dtype=torch.bfloat16), bits)
    assert params_to_numpy({"w": bf})["w"].out_dtype == "bfloat16"
    assert params_from_numpy(params_to_numpy({"w": bf}),
                             device="cpu")["w"].out_dtype == torch.bfloat16


# ---------------------------------------------------------- import hygiene

def test_inference_modules_import_no_jax():
    code = (
        "import sys\n"
        "import deepspeed_tpu_torch\n"
        "import deepspeed_tpu_torch.inference\n"
        "import deepspeed_tpu_torch.inference.engine\n"
        "import deepspeed_tpu_torch.inference.config\n"
        "import deepspeed_tpu_torch.inference.quantization\n"
        "import deepspeed_tpu_torch.models\n"
        "import deepspeed_tpu_torch.models.weights\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pydantic', 'deepspeed_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "assert 'deepspeed_tpu_torch.ops._build' not in sys.modules\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(Path(__file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
