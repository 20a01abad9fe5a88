"""Port parity: the transformer primitives of ``deepspeed_tpu_torch`` against
``deepspeed_tpu.models.transformer`` on the CPU.

Inputs are numpy draws with a fixed seed handed to both packages; weights
come from the JAX ``CausalLM.init(PRNGKey(seed))`` through
``params_from_numpy``. Float32 throughout: elementwise ops agree to
atol = rtol = 1e-6; paths with matmuls to atol 1e-4, rtol 1e-5 (the two
BLAS libraries sum in different orders; outputs reach |y| ~ 10, where fp32
rounding over a 128-term sum is ~1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy

EW = dict(atol=1e-6, rtol=1e-6)
MM = dict(atol=1e-4, rtol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    r = _rng(1)
    x, w, b = (r.standard_normal(s).astype(np.float32)
               for s in ((3, 5, 32), (32,), (32,)))
    ref = jtf._norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), kind, 1e-5)
    out = ttf._norm(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), kind, 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EW)


def test_rope_table():
    cos_j, sin_j = jtf.rope_table(64, 16, 10000.0)
    cos_t, sin_t = ttf.rope_table(64, 16, 10000.0)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **EW)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **EW)


@pytest.mark.parametrize("interleaved,rot,per_seq", [
    (False, 16, False),     # rotate-half, full rotary, shared positions
    (False, 16, True),      # rotate-half, per-sequence positions (ragged)
    (True, 16, True),       # GPT-J interleaved pairs
    (False, 4, True),       # partial rotary (NeoX rotary_pct = 0.25)
    (True, 4, False),       # GPT-J partial rotary
])
def test_apply_rope(interleaved, rot, per_seq):
    r = _rng(2)
    x = r.standard_normal((2, 5, 3, 16)).astype(np.float32)
    cos, sin = jtf.rope_table(32, rot, 10000.0)
    if per_seq:
        pos = np.asarray([[0, 1, 2, 3, 4], [9, 10, 11, 12, 13]])
        cos, sin = cos[pos], sin[pos]
    else:
        cos, sin = cos[:5], sin[:5]
    ref = jtf.apply_rope(jnp.asarray(x), cos, sin, interleaved)
    out = ttf.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(cos)),
                         torch.from_numpy(np.array(sin)), interleaved)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **EW)


@pytest.mark.parametrize("heads", [8, 12, 16])
def test_alibi_slopes(heads):
    np.testing.assert_allclose(ttf.alibi_slopes(heads).numpy(),
                               np.asarray(jtf.alibi_slopes(heads)), **EW)


def _layer(cfg, seed=0):
    jm = jtf.CausalLM(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    # weights x4 so the activations leave their near-linear range
    jp = jax.tree.map(lambda a: a * 4 if a.ndim >= 2 else a, jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    tlp = {k: v[0] for k, v in tp["layers"].items()}
    tcfg = ttf.TransformerConfig(**{**dataclasses.asdict(cfg),
                                    "dtype": torch.float32})
    return jm, ttf.CausalLM(tcfg), jlp, tlp


@pytest.mark.parametrize("activation,mlp_bias", [
    ("silu", False), ("silu", True), ("gelu", True), ("gelu_exact", False),
    ("relu", True)])
def test_mlp_activations(activation, mlp_bias):
    cfg = dataclasses.replace(jtf.TINY_TEST, activation=activation,
                              mlp_bias=mlp_bias)
    jm, tm, jlp, tlp = _layer(cfg)
    x = _rng(3).standard_normal((2, 3, cfg.hidden_size)).astype(np.float32)
    ref, _ = jm._mlp_body(jnp.asarray(x), jlp, None, True)
    out = tm._mlp_body(torch.from_numpy(x), tlp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MM)


@pytest.mark.parametrize("variant", ["sequential", "parallel", "shared_ln"])
def test_attn_mlp_merge(variant):
    kw = {"sequential": {}, "parallel": {"parallel_residual": True},
          "shared_ln": {"parallel_residual": True, "shared_layernorm": True,
                        "norm": "layernorm", "activation": "gelu"}}[variant]
    cfg = dataclasses.replace(jtf.TINY_TEST, **kw)
    jm, tm, jlp, tlp = _layer(cfg)
    r = _rng(4)
    x, a, h1 = (r.standard_normal((2, 3, cfg.hidden_size)).astype(np.float32)
                for _ in range(3))
    ref = jm._attn_mlp_merge(jnp.asarray(x), jnp.asarray(a), jlp,
                             jnp.asarray(h1))
    out = tm._attn_mlp_merge(torch.from_numpy(x), torch.from_numpy(a), tlp,
                             torch.from_numpy(h1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **MM)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["TINY_TEST", "GPT2_125M", "GPTJ_6B",
                                  "PYTHIA_1B4", "BLOOM_560M", "MISTRAL_7B"])
def test_init_layout_matches_jax(name):
    """Same tree, leaf for leaf (shapes taken abstractly from JAX; the
    port's init runs at a cut depth and width where the config is large)."""
    jcfg = getattr(jtf, name)
    small = dict(num_layers=2, hidden_size=64, intermediate_size=96,
                 vocab_size=128, max_seq_len=64,
                 num_heads=4, num_kv_heads=(2 if jcfg.num_kv_heads else None))
    jcfg = dataclasses.replace(jcfg, **small)
    tcfg = dataclasses.replace(getattr(ttf, name), **small)
    ref = jax.eval_shape(lambda: jtf.CausalLM(jcfg).init(
        jax.random.PRNGKey(0)))
    out = ttf.CausalLM(tcfg).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    assert _shapes(out) == _shapes(ref)


def test_presets_match_jax():
    for name in ("LLAMA2_7B", "LLAMA2_70B", "MISTRAL_7B", "QWEN2_7B",
                 "OPT_1B3", "GPTJ_6B", "PHI_2", "PYTHIA_1B4", "BLOOM_560M",
                 "FALCON_7B", "TINY_TEST", "GPT2_125M"):
        j, t = dataclasses.asdict(getattr(jtf, name)), \
            dataclasses.asdict(getattr(ttf, name))
        jd, td = j.pop("dtype"), t.pop("dtype")
        assert j == t, name
        assert str(jnp.dtype(jd)) == str(td).replace("torch.", ""), name
    m = ttf.MISTRAL_7B
    assert (m.head_dim, m.kv_heads, m.rot_dim, m.window_segments()) == \
        (128, 8, 128, ((0, 32, 4096),))


def test_init_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.CausalLM(ttf.TINY_TEST).init()
