"""HF checkpoint import in the port (``deepspeed_tpu_torch/models/
convert.py``) against the JAX package's (``deepspeed_tpu/models/
convert.py``) and the ``transformers`` torch forward, on the CPU.

Tiny HF checkpoints of the ten decoder families and the JAX twins'
variants (``tests/test_convert.py``, ``tests/test_convert_families.py``)
are built once with ``save_pretrained``, in safetensors and in
``pytorch_model.bin`` form. Held here:

- every leaf of the port's load bit-equal to the JAX load, at fp32 and
  bf16, over a pairwise grid of variant x format x dtype;
- the port's safetensors reader byte for byte against the ``safetensors``
  library for every dtype torch has (whole, dim-0 and dim-1 slices, single
  and index-sharded), the ``.bin`` reader against ``torch.load``, and the
  byte counter of a dim-0 slice;
- ``config_from_hf`` field for field, and every refusal's type and text;
- logits against ``transformers`` at the JAX twins' tolerances;
- greedy streams of the v1 and v2 engines against the JAX engines' (and
  HF ``generate``) on the twins' window, GPT-J, Phi, Qwen2 and EOS cases;
- the entry points (``init_inference`` and ``InferenceEngineV2`` from a
  checkpoint, ``from_pretrained`` overrides, ``model_from_checkpoint``),
  the missing-leaf and shape-mismatch raises, an explicit ``model_type``
  without ``config.json``, and a rank's blocks under tensor = 2.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.v2.engine_v2 import \
    InferenceEngineV2 as JEngineV2
from deepspeed_tpu.inference.v2.engine_v2 import \
    RaggedInferenceEngineConfig as JRaggedConfig
from deepspeed_tpu.models import convert as jconv
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu_torch.inference.quantization import (QuantTensor,
                                                        quantize_param_blocks,
                                                        quantized_cut)
from deepspeed_tpu_torch.inference.v2.engine_v2 import (
    InferenceEngineV2, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models import convert as tconv
from deepspeed_tpu_torch.models.weights import params_to_numpy
from deepspeed_tpu_torch.parallel.sharding import (ZeroShardingPlan,
                                                   place_blocks)
from deepspeed_tpu_torch.parallel.topology import MeshTopology
import torch_cpu  # noqa: F401  (one torch thread: see the module)

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")


# ------------------------------------------------------- tiny HF checkpoints

def _fill_1d(hf, lo=-0.3, hi=0.3):
    """Nonzero 1-D params (biases, norms), so every bias path is held."""
    with torch.no_grad():
        for p in hf.parameters():
            if p.ndim == 1:
                p.uniform_(lo, hi)


def _hf(name):
    """(model class, config) of a variant, as the JAX twins build them."""
    T = transformers
    common = dict(max_position_embeddings=64)
    if name == "llama":
        return T.LlamaForCausalLM, T.LlamaConfig(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rms_norm_eps=1e-5,
            tie_word_embeddings=False, rope_theta=10000.0, **common)
    if name == "llama_bias":
        return T.LlamaForCausalLM, T.LlamaConfig(
            vocab_size=120, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, attention_bias=True,
            tie_word_embeddings=False, **common)
    if name == "mistral_swa":
        return T.MistralForCausalLM, T.MistralConfig(
            vocab_size=120, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, sliding_window=8,
            tie_word_embeddings=False, attn_implementation="eager", **common)
    if name in ("qwen2", "qwen2_uniform", "qwen2_mixed"):
        kw = {}
        if name == "qwen2_uniform":
            kw = dict(use_sliding_window=True, sliding_window=8,
                      max_window_layers=0)
        if name == "qwen2_mixed":
            kw = dict(use_sliding_window=True, sliding_window=8,
                      max_window_layers=2, num_hidden_layers=4)
        base = dict(vocab_size=120, hidden_size=32, intermediate_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, tie_word_embeddings=False,
                    attn_implementation="eager", **common)
        base.update(kw)
        return T.Qwen2ForCausalLM, T.Qwen2Config(**base)
    if name in ("stablelm_par", "stablelm_seq"):
        return T.StableLmForCausalLM, T.StableLmConfig(
            vocab_size=130, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, partial_rotary_factor=0.25,
            use_qkv_bias=True, use_parallel_residual=name.endswith("par"),
            tie_word_embeddings=False, **common)
    if name == "gpt2":
        return T.GPT2LMHeadModel, T.GPT2Config(
            vocab_size=96, n_embd=32, n_layer=2, n_head=4, n_positions=64)
    if name == "gptneo":
        return T.GPTNeoForCausalLM, T.GPTNeoConfig(
            vocab_size=130, hidden_size=32, num_layers=4,
            attention_types=[[["global", "local"], 2]], num_heads=4,
            intermediate_size=64, window_size=8, embed_dropout=0.0,
            attention_dropout=0.0, resid_dropout=0.0, **common)
    if name in ("opt", "opt_untied"):
        return T.OPTForCausalLM, T.OPTConfig(
            vocab_size=100, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
            num_attention_heads=4, do_layer_norm_before=True,
            activation_function="relu", word_embed_proj_dim=32,
            tie_word_embeddings=name == "opt", **common)
    if name in ("neox_par", "neox_seq"):
        return T.GPTNeoXForCausalLM, T.GPTNeoXConfig(
            vocab_size=110, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, rotary_pct=0.5,
            use_parallel_residual=name.endswith("par"), **common)
    if name == "gptj":
        return T.GPTJForCausalLM, T.GPTJConfig(
            vocab_size=160, n_embd=32, n_inner=64, n_layer=2, n_head=4,
            n_positions=64, rotary_dim=4, tie_word_embeddings=False)
    if name == "phi":
        return T.PhiForCausalLM, T.PhiConfig(
            vocab_size=140, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, partial_rotary_factor=0.5,
            tie_word_embeddings=False, **common)
    if name == "bloom":
        return T.BloomForCausalLM, T.BloomConfig(
            vocab_size=130, hidden_size=32, n_layer=2, n_head=4)
    if name in ("falcon_old", "falcon_new", "falcon_rw"):
        kw = dict(vocab_size=105, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, **common)
        if name == "falcon_old":
            kw.update(bias=False, parallel_attn=True, alibi=False,
                      new_decoder_architecture=False, multi_query=True)
        elif name == "falcon_new":
            kw.update(bias=False, parallel_attn=True, alibi=False,
                      new_decoder_architecture=True, num_kv_heads=2)
        else:
            kw.update(vocab_size=95, bias=True, alibi=True,
                      parallel_attn=False, multi_query=False,
                      new_decoder_architecture=False)
        return T.FalconForCausalLM, T.FalconConfig(**kw)
    raise KeyError(name)


VARIANTS = ["llama", "llama_bias", "mistral_swa", "qwen2", "qwen2_uniform",
            "qwen2_mixed", "stablelm_par", "stablelm_seq", "gpt2", "gptneo",
            "opt", "opt_untied", "neox_par", "neox_seq", "gptj", "phi",
            "bloom", "falcon_old", "falcon_new", "falcon_rw"]
# variants whose windows the logits test must cross
WINDOWED = {"mistral_swa", "qwen2_uniform", "qwen2_mixed", "gptneo"}


class _Ckpts:
    """Each variant built and saved once: ``path(name, fmt)``, ``hf(name)``.
    The ``bin`` form of ``llama`` is index-sharded."""

    def __init__(self, root):
        self.root, self._hf, self._dirs = root, {}, {}

    def hf(self, name):
        if name not in self._hf:
            cls, cfg = _hf(name)
            torch.manual_seed(VARIANTS.index(name))
            model = cls(cfg).eval()
            if name == "opt_untied":    # untie for real
                model.lm_head.weight = torch.nn.Parameter(
                    torch.randn_like(model.lm_head.weight) * 0.1)
            _fill_1d(model)
            self._hf[name] = model
        return self._hf[name]

    def path(self, name, fmt="st"):
        key = (name, fmt)
        if key not in self._dirs:
            d = os.path.join(self.root, f"{name}_{fmt}")
            kw = {"safe_serialization": fmt == "st"}
            if fmt == "bin" and name == "llama":
                kw["max_shard_size"] = "40KB"
            self.hf(name).save_pretrained(d, **kw)
            self._dirs[key] = d
        return self._dirs[key]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return _Ckpts(str(tmp_path_factory.mktemp("hf")))


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(torch.as_tensor(tokens)).logits.float().numpy()


def _hf_config(path):
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


# ------------------------------------------------------- leaf for leaf

def _np(x):
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


# a pairwise grid of variant x format x dtype: every variant in both
# formats and both dtypes, and every format x dtype pair many times
LEAF_CASES = [(v, fmt, dt) for i, v in enumerate(VARIANTS)
              for fmt, dt in ((("st", "fp32"), ("bin", "bf16")) if i % 2 == 0
                              else (("st", "bf16"), ("bin", "fp32")))]
_DT = {"fp32": (torch.float32, jnp.float32),
       "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("variant,fmt,dt", LEAF_CASES)
def test_leaves_bit_equal_to_jax(ckpts, variant, fmt, dt):
    path = ckpts.path(variant, fmt)
    tdt, jdt = _DT[dt]
    _, tp = tconv.load_hf_checkpoint(path, param_dtype=tdt, device="cpu")
    _, jp = jconv.load_hf_checkpoint(path, param_dtype=jdt)
    t, j = _flat(params_to_numpy(tp)), _flat(jax.tree.map(_np, jp))
    assert sorted(t) == sorted(j)
    for k in t:
        assert _flat(tp)[k].dtype == tdt, k
        assert t[k].shape == j[k].shape, k
        assert np.array_equal(t[k].view(np.uint32), j[k].view(np.uint32)), k


# ------------------------------------------------------------- readers

ST_DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16,
             torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
             torch.bool, torch.float8_e4m3fn, torch.float8_e5m2]


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 50
    if dtype == torch.bool:
        return x > 0
    return x.to(dtype)


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _lib_tensors(tmp_path):
    """One tensor a dtype (and a scalar and an empty one) written by the
    safetensors library into one file, and split over two with an index."""
    from safetensors.torch import save_file

    tensors = {f"t{i}": _tensor(dt, (5, 3, 4), i)
               for i, dt in enumerate(ST_DTYPES)}
    tensors["scalar"] = torch.tensor(2.5, dtype=torch.float32)
    tensors["empty"] = torch.zeros((0, 3), dtype=torch.bfloat16)
    one = tmp_path / "one"
    one.mkdir()
    save_file(tensors, str(one / "model.safetensors"),
              metadata={"format": "pt"})
    two = tmp_path / "two"
    two.mkdir()
    names = sorted(tensors)
    wmap = {}
    for part, fname in enumerate(("a.safetensors", "b.safetensors")):
        sub = {n: tensors[n] for n in names[part::2]}
        save_file(sub, str(two / fname))
        wmap.update({n: fname for n in sub})
    (two / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": wmap}))
    return tensors, one, two


READ_INDEX = [None, (slice(1, 4),), (slice(None), slice(1, 3)),
              (slice(2, 5), slice(0, 2), slice(1, 4))]


def test_safetensors_reader_matches_library(tmp_path):
    from safetensors import safe_open

    tensors, one, two = _lib_tensors(tmp_path)
    for d in (one, two):
        rd = tconv.SafetensorsReader(str(d))
        assert sorted(rd.names()) == sorted(tensors)
        files = {n: os.path.join(d, f) for n, f in json.loads(
            (d / "model.safetensors.index.json").read_text())[
                "weight_map"].items()} if d == two else \
            {n: str(d / "model.safetensors") for n in tensors}
        for name, want in tensors.items():
            assert rd.shape(name) == tuple(want.shape)
            with safe_open(files[name], framework="pt") as f:
                for index in READ_INDEX:
                    if index is not None and len(index) > want.dim():
                        continue
                    lib = (f.get_tensor(name) if index is None
                           else f.get_slice(name)[index])
                    got = rd.read(name, index)
                    assert got.dtype == want.dtype, name
                    assert tuple(got.shape) == tuple(lib.shape), name
                    assert torch.equal(_bytes(got), _bytes(lib)), \
                        (name, index)
        rd.close()
    # a dim-0 slice reads only its rows' bytes
    rd = tconv.SafetensorsReader(str(one))
    rd.read("t1", (slice(1, 4), slice(0, 2)))
    assert rd.bytes_read == 3 * 3 * 4 * 4
    assert rd.bytes_by_name == {"t1": 3 * 3 * 4 * 4}


def test_bin_reader_matches_torch_load(tmp_path):
    tensors = {f"t{i}": _tensor(dt, (5, 3, 4), i)
               for i, dt in enumerate(ST_DTYPES)}
    one = tmp_path / "one"
    one.mkdir()
    torch.save(tensors, one / "pytorch_model.bin")
    two = tmp_path / "two"
    two.mkdir()
    names = sorted(tensors)
    wmap = {}
    for part in range(2):
        fname = f"pytorch_model-0000{part + 1}-of-00002.bin"
        torch.save({n: tensors[n] for n in names[part::2]}, two / fname)
        wmap.update({n: fname for n in names[part::2]})
    (two / "pytorch_model.bin.index.json").write_text(
        json.dumps({"weight_map": wmap}))
    for d in (one, two):
        rd = tconv.open_checkpoint(str(d))
        assert isinstance(rd, tconv.TorchShardReader)
        assert sorted(rd.names()) == names
        for name, want in tensors.items():
            for index in READ_INDEX:
                ref = want if index is None else want[index]
                got = rd.read(name, index)
                assert got.dtype == want.dtype
                assert torch.equal(_bytes(got), _bytes(ref)), (name, index)
    rd = tconv.TorchShardReader(str(one))
    rd.read("t1", (slice(1, 4),))
    assert rd.bytes_read == 3 * 3 * 4 * 4


def test_reader_reads_hf_files_as_the_library(ckpts):
    from safetensors import safe_open

    path = ckpts.path("falcon_new", "st")
    rd = tconv.open_checkpoint(path)
    with safe_open(os.path.join(path, "model.safetensors"),
                   framework="pt") as f:
        assert sorted(rd.names()) == sorted(f.keys())
        for name in f.keys():
            assert torch.equal(rd.read(name), f.get_tensor(name)), name
    with pytest.raises(KeyError, match="not in the checkpoint"):
        rd.read("no.such.tensor")


# -------------------------------------------------------------- configs

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _same_config(t, j):
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    assert _JDT[td.pop("dtype")] == jd.pop("dtype")
    assert td == jd


@pytest.mark.parametrize("variant", VARIANTS)
def test_config_from_hf_matches_jax(ckpts, variant):
    hf = _hf_config(ckpts.path(variant))
    _same_config(tconv.config_from_hf(hf), jconv.config_from_hf(hf))
    assert tconv.config_from_hf(hf).dtype == torch.bfloat16
    _same_config(tconv.config_from_hf(hf, dtype=torch.float32),
                 jconv.config_from_hf(hf, dtype=jnp.float32))


REFUSALS = [
    ("config_from_hf", {"model_type": "stablelm", "qk_layernorm": True}),
    ("config_from_hf", {"model_type": "phi", "qk_layernorm": True}),
    ("config_from_hf", {"model_type": "opt", "do_layer_norm_before": False}),
    ("config_from_hf", {"model_type": "opt", "hidden_size": 32,
                        "word_embed_proj_dim": 16}),
    ("config_from_hf", {"model_type": "mamba"}),
    ("config_from_hf", {}),
    ("encoder_config_from_hf", {"model_type": "llama"}),
    ("encoder_config_from_hf", {"model_type": "bert", "hidden_act": "tanh"}),
    ("_encoder_prefix_and_heads", {}),
]


@pytest.mark.parametrize("fn,hf", REFUSALS)
def test_refusals_match_jax(fn, hf):
    with pytest.raises(Exception) as te:
        getattr(tconv, fn)(hf)
    with pytest.raises(Exception) as je:
        getattr(jconv, fn)(hf)
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)


# -------------------------------------------------------------- logits

@pytest.mark.parametrize("variant", VARIANTS)
def test_logits_match_transformers(ckpts, variant):
    path = ckpts.path(variant)
    model, params = tconv.from_pretrained(path, dtype=torch.float32,
                                          attention_impl="reference",
                                          device="cpu")
    vocab = model.cfg.vocab_size
    seq = 20 if variant in WINDOWED else 12
    tokens = np.random.default_rng(0).integers(0, vocab, size=(2, seq))
    with torch.no_grad():
        ours = model.apply(params, torch.as_tensor(tokens)).numpy()
    tol = 3e-4 if variant in ("llama", "gpt2") else 4e-4
    np.testing.assert_allclose(ours, _hf_logits(ckpts.hf(variant), tokens),
                               atol=tol, rtol=tol)


# ---------------------------------------------------- greedy streams

def _pair(path):
    """The port's and the JAX package's fp32 model and params of one
    checkpoint (the twins' ``from_pretrained(dtype=fp32,
    attention_impl="reference")``)."""
    tm, tp = tconv.from_pretrained(path, dtype=torch.float32,
                                   attention_impl="reference", device="cpu")
    jm, jp = jconv.from_pretrained(path, dtype=jnp.float32,
                                   attention_impl="reference")
    return (tm, tp), (jm, jp)


V1_CASES = [
    # variant, prompt seed, shape, new tokens, eos
    ("mistral_swa", 3, (2, 12), 8, None),
    ("gptj", 9, (2, 10), 8, None),
    ("phi", 11, (2, 9), 7, None),
    ("qwen2_mixed", 21, (2, 12), 8, None),
    ("phi", 0, (1, 8), 6, 2),
]


@pytest.mark.parametrize("variant,seed,shape,new,eos", V1_CASES)
def test_v1_generate_matches_jax_engine(ckpts, variant, seed, shape, new,
                                        eos):
    (tm, tp), (jm, jp) = _pair(ckpts.path(variant))
    cfg = {"dtype": "fp32"}
    te = deepspeed_tpu_torch.init_inference(tm, config=cfg, params=tp,
                                            device="cpu")
    jtopo.reset_topology()
    je = deepspeed_tpu.init_inference(jm, config=dict(cfg), params=jp)
    jtopo.reset_topology()
    prompt = np.random.default_rng(seed).integers(0, tm.cfg.vocab_size,
                                                  size=shape)
    kw = {} if eos is None else {"eos_token_id": eos}
    ours = te.generate(torch.as_tensor(prompt, dtype=torch.int32),
                       max_new_tokens=new, **kw).numpy()
    jax_out = np.asarray(je.generate(jnp.asarray(prompt, jnp.int32),
                                     max_new_tokens=new, **kw))
    np.testing.assert_array_equal(ours, jax_out)
    with torch.no_grad():
        theirs = ckpts.hf(variant).generate(
            torch.as_tensor(prompt), max_new_tokens=new, do_sample=False,
            eos_token_id=eos, pad_token_id=0).numpy()
    # HF stops at the longest finished row; the rest of ours is pad
    np.testing.assert_array_equal(ours[:, :theirs.shape[1]], theirs)
    assert (ours[:, theirs.shape[1]:] == 0).all()
    if eos is not None:
        assert eos in ours[0].tolist(), "the EOS itself is emitted"


@pytest.mark.parametrize("variant,seed,steps", [("mistral_swa", 5, 5),
                                                ("qwen2_mixed", 7, 4)])
def test_v2_put_matches_jax_engine(ckpts, variant, seed, steps):
    (tm, tp), (jm, jp) = _pair(ckpts.path(variant))
    kw = dict(max_ragged_sequence_count=4, max_chunk_tokens=32,
              kv_blocks=64, kv_block_size=4)
    te = InferenceEngineV2(tm, params=tp,
                           config=RaggedInferenceEngineConfig(**kw),
                           device="cpu")
    je = JEngineV2(jm, params=jp, config=JRaggedConfig(**kw))
    seq = np.random.default_rng(seed).integers(0, tm.cfg.vocab_size,
                                               20).tolist()   # 20 > window
    streams = {"port": list(seq), "jax": list(seq)}
    feed = {"port": list(seq), "jax": list(seq)}
    for step in range(steps):
        t_logits = te.put([1], [feed["port"]])[0].numpy()
        j_logits = np.asarray(je.put([1], [feed["jax"]])[0])
        ref = _hf_logits(ckpts.hf(variant),
                         np.asarray([streams["port"]]))[0, -1]
        np.testing.assert_allclose(t_logits, ref, atol=4e-4, rtol=4e-4,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(t_logits, j_logits, atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {step}")
        for who, lg in (("port", t_logits), ("jax", j_logits)):
            nxt = int(np.argmax(lg))
            streams[who].append(nxt)
            feed[who] = [nxt]
    assert streams["port"] == streams["jax"]


# ----------------------------------------------------------- entry points

def test_init_inference_infers_the_model(ckpts):
    path = ckpts.path("llama")
    engine = deepspeed_tpu_torch.init_inference(
        None, config={"checkpoint": path, "dtype": "fp32"}, device="cpu")
    assert isinstance(engine.module, CausalLM)
    _same_config(engine.module.cfg,
                 jconv.config_from_hf(_hf_config(path), dtype=jnp.float32))
    assert engine.params["layers"]["wq"].dtype == torch.float32
    tokens = np.random.default_rng(2).integers(0, 128, size=(1, 8))
    theirs = _hf_logits(ckpts.hf("llama"), tokens)
    np.testing.assert_allclose(engine.forward(tokens).numpy(), theirs,
                               atol=3e-4, rtol=3e-4)
    out = engine.generate(tokens, max_new_tokens=1).numpy()
    assert out[0, -1] == theirs[0, -1].argmax()
    # a given model with a checkpoint: the params are read at the serving
    # dtype (bf16 by default), as the JAX engine stores them
    bf = deepspeed_tpu_torch.init_inference(
        CausalLM(tconv.config_from_hf(_hf_config(path))),
        config={"checkpoint": path}, device="cpu")
    assert bf.params["layers"]["wq"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="needs a model or an HF"):
        deepspeed_tpu_torch.init_inference(None, device="cpu")


@pytest.mark.parametrize("with_model", [True, False])
def test_v2_engine_checkpoint_path(ckpts, with_model):
    path = ckpts.path("llama")
    cfg = tconv.config_from_hf(_hf_config(path), dtype=torch.float32)
    engine = InferenceEngineV2(CausalLM(cfg) if with_model else None,
                               checkpoint_path=path, device="cpu")
    assert engine.params["embed"]["wte"].dtype == \
        (torch.float32 if with_model else torch.bfloat16)
    prompt = np.random.default_rng(3).integers(0, 128, size=(9,)).tolist()
    logits = engine.put([7], [prompt])[0].float().numpy()
    theirs = _hf_logits(ckpts.hf("llama"), np.asarray([prompt]))[0, -1]
    tol = 3e-4 if with_model else 0.15
    np.testing.assert_allclose(logits, theirs, atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="needs a model or checkpoint_path"):
        InferenceEngineV2(None, device="cpu")


def test_from_pretrained_overrides_and_model_from_checkpoint(ckpts,
                                                             tmp_path):
    path = ckpts.path("gpt2", "bin")
    model, params = tconv.from_pretrained(path, dtype=torch.float32,
                                          attention_impl="reference",
                                          device="cpu")
    jm, _ = jconv.from_pretrained(path, dtype=jnp.float32,
                                  attention_impl="reference")
    _same_config(model.cfg, jm.cfg)
    assert model.cfg.attention_impl == "reference"
    assert params["embed"]["wpe"].dtype == torch.float32
    m = tconv.model_from_checkpoint(path)
    _same_config(m.cfg, jconv.model_from_checkpoint(path).cfg)
    assert tconv.model_from_checkpoint(path, dtype=torch.float16).cfg.dtype \
        == torch.float16
    with pytest.raises(ValueError) as te:
        tconv.model_from_checkpoint(str(tmp_path))
    with pytest.raises(ValueError) as je:
        jconv.model_from_checkpoint(str(tmp_path))
    assert str(te.value) == str(je.value)
    assert tconv.is_hf_checkpoint(path) and \
        not tconv.is_hf_checkpoint(str(tmp_path))


def test_models_given_by_name():
    """``initialize`` and its ZeRO-Infinity route build a registered model
    by name (``models.build_model``), as the JAX package's do: the
    streaming engine then refuses the tied ``tiny`` model as it refuses
    any tied model (a name left unbuilt would have no ``cfg``)."""
    from deepspeed_tpu_torch.models import TINY_TEST

    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
           "zero_optimization": {"stage": 3,
                                 "offload_param": {"device": "cpu"}}}
    with pytest.raises(ValueError, match="requires tie_embeddings=False"):
        deepspeed_tpu_torch.initialize(model="tiny", config=cfg,
                                       device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model="tiny", config={"train_batch_size": 2}, device="cpu")
    assert dataclasses.replace(engine.module.cfg, dtype=TINY_TEST.dtype) \
        == TINY_TEST
    if not torch.cuda.is_available():
        # the port's device rule: no CUDA and no explicit device raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tconv.load_hf_checkpoint("/nonexistent", model=CausalLM(
                TINY_TEST), model_type="llama")


def test_missing_leaf_and_shape_mismatch_raise(ckpts):
    path = ckpts.path("llama")
    cfg = tconv.config_from_hf(_hf_config(path))
    # a leaf the llama family never maps: the JAX message, word for word
    extra = dataclasses.replace(cfg, lm_head_bias=True)
    with pytest.raises(ValueError) as te:
        tconv.load_hf_checkpoint(path, model=CausalLM(extra), device="cpu")
    from deepspeed_tpu.models.transformer import CausalLM as JCausalLM
    with pytest.raises(ValueError) as je:
        jconv.load_hf_checkpoint(path, model=JCausalLM(dataclasses.replace(
            jconv.config_from_hf(_hf_config(path)), lm_head_bias=True)))
    assert str(te.value) == str(je.value)
    assert "['lm_head']['b']" in str(te.value)
    # a model wider than the checkpoint: the leaf is named
    wide = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + 8)
    with pytest.raises(ValueError,
                       match=r"shape mismatch at \['embed'\]\['wte'\]"):
        tconv.load_hf_checkpoint(path, model=CausalLM(wide), device="cpu")
    with pytest.raises(ValueError, match=r"shape mismatch at "
                                         r"\['layers'\]\['w_in'\]"):
        tconv.load_hf_checkpoint(path, model=CausalLM(dataclasses.replace(
            cfg, intermediate_size=48)), device="cpu")


def test_explicit_model_type_without_config_json(ckpts, tmp_path):
    path = ckpts.path("llama")
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(os.path.join(path, "model.safetensors"), bare)
    model = CausalLM(tconv.config_from_hf(_hf_config(path)))
    with pytest.raises(ValueError) as te:
        tconv.load_hf_checkpoint(str(bare), model=model, device="cpu")
    with pytest.raises(ValueError) as je:
        jconv.load_hf_checkpoint(str(bare), model=jconv.model_from_checkpoint(
            path))
    assert str(te.value) == str(je.value)
    assert "pass model_type=" in str(te.value)
    _, got = tconv.load_hf_checkpoint(str(bare), model=model,
                                      model_type="llama", device="cpu")
    _, want = tconv.load_hf_checkpoint(path, model=model, device="cpu")
    for k, v in _flat(want).items():
        assert torch.equal(_flat(got)[k], v), k


# ------------------------------------------------------------ rank blocks

def test_rank_blocks_read_only_their_rows(ckpts):
    path = ckpts.path("llama")
    model = CausalLM(tconv.config_from_hf(_hf_config(path),
                                          dtype=torch.float32))
    t = MeshTopology.build(world_size=2, tensor=2)
    whole_rd = tconv.open_checkpoint(path)
    _, whole = tconv.load_hf_checkpoint(path, model=model, device="cpu",
                                        reader=whole_rd)
    specs = ZeroShardingPlan(t, 0, model.param_specs()).params(whole)
    q0 = "model.layers.0.self_attn.q_proj.weight"     # column-parallel
    o0 = "model.layers.0.self_attn.o_proj.weight"     # row-parallel
    for rank in range(2):
        rd = tconv.open_checkpoint(path)
        _, blocks = tconv.load_hf_checkpoint(path, model=model, device="cpu",
                                             topology=t, rank=rank, reader=rd)
        want = place_blocks(whole, specs, t, rank, "cpu")
        for k, v in _flat(want).items():
            assert torch.equal(_flat(blocks)[k], v), (rank, k)
        # leaves cut along the source's dim 0 read half their rows;
        # row-parallel ones (cut along dim 1) read them all
        assert rd.bytes_by_name[q0] * 2 == whole_rd.bytes_by_name[q0]
        up0 = "model.layers.0.mlp.up_proj.weight"
        assert rd.bytes_by_name[up0] * 2 == whole_rd.bytes_by_name[up0]
        assert rd.bytes_by_name[o0] == whole_rd.bytes_by_name[o0]
        assert rd.bytes_read < whole_rd.bytes_read
        # v1's quantized cut: the widened column span, quantized as
        # quantize_param_blocks quantizes the whole leaf's block
        _, qblocks = tconv.load_hf_checkpoint(
            path, model=model, device="cpu", topology=t, rank=rank,
            cut=lambda read, shape, sl: quantized_cut(read, shape, sl))
        qwant = quantize_param_blocks(whole, specs, t, rank, "cpu")
        nq = 0
        for k, v in _flat(qwant).items():
            g = _flat(qblocks)[k]
            if isinstance(v, QuantTensor):
                nq += 1
                assert torch.equal(g.q, v.q) and torch.equal(g.scales,
                                                             v.scales)
                assert (g.block, g.cols) == (v.block, v.cols), k
            else:
                assert torch.equal(g, v), k
        assert nq > 0
