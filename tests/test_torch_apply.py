"""Port parity: ``CausalLM.apply`` and ``CausalLM.loss`` of
``deepspeed_tpu_torch`` against the JAX package's on the CPU.

Weights come from the JAX ``CausalLM.init(PRNGKey(0))`` through
``params_from_numpy``; tokens are fixed numpy arrays. The configs are the
ones ``tests/test_torch_paged_model.py`` uses (GPT-2, BLOOM with ALiBi, NeoX
partial rotary, GPT-J shared layernorm, a Mistral window, mixed windows), at
2 layers and width 64, with ``use_flash_attention`` on: the port then runs
its attention through the ``flash_attention`` autograd Function (plain
versions on the CPU), the JAX side through ``flash_attention``'s XLA path.
Float32; logits and losses agree to atol = rtol = 1e-4 (matmul chains summed
in different orders by two BLAS libraries), gradients to 1e-4 of the
largest gradient of their leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.ops import flash_attention as tfa
import torch_cpu  # noqa: F401  (one torch thread: see the module)

SMALL = dict(num_layers=2, hidden_size=64, intermediate_size=96,
             vocab_size=256, max_seq_len=64, num_heads=4)
CONFIGS = {
    "tiny": (jtf.TINY_TEST, {}),
    "gpt2": (jtf.GPT2_125M, {}),
    "bloom": (jtf.BLOOM_560M, {}),
    "neox": (jtf.PYTHIA_1B4, {}),
    "gptj": (jtf.GPTJ_6B, {}),
    "mistral-window": (jtf.MISTRAL_7B, {"num_kv_heads": 2,
                                        "sliding_window": 6}),
    "mixed-window": (jtf.TINY_TEST, {"sliding_window": (None, 5)}),
    "reference-impl": (jtf.TINY_TEST, {"attention_impl": "reference"}),
    "attn-scale": (jtf.TINY_TEST, {"attn_scale": 0.5}),
}


def _models(name, **more):
    base, extra = CONFIGS[name]
    jcfg = dataclasses.replace(base, **SMALL, **extra, **more,
                               dtype=jnp.float32)
    tcfg = ttf.TransformerConfig(**{**dataclasses.asdict(jcfg),
                                    "dtype": torch.float32})
    jm = jtf.CausalLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, ttf.CausalLM(tcfg), tp


def _tokens(B=2, T=19, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_logits_match_jax(name):
    jm, jp, tm, tp = _models(name)
    tokens = _tokens()
    want = np.asarray(jm.apply(jp, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tm.apply(tp, torch.from_numpy(tokens))
    assert got.shape == (2, 19, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_apply_positions_and_return_aux_match_jax():
    positions = np.asarray([[3, 4, 5, 6, 7, 20, 21]], np.int32)
    for name in ("tiny", "gpt2"):
        jm, jp, tm, tp = _models(name)
        tokens = _tokens(1, 7, seed=3)
        want, jaux = jm.apply(jp, jnp.asarray(tokens),
                              positions=jnp.asarray(positions),
                              return_aux=True)
        with torch.no_grad():
            got, aux = tm.apply(tp, torch.from_numpy(tokens),
                                positions=torch.from_numpy(positions),
                                return_aux=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        assert float(aux) == float(jaux) == 0.0


BATCHES = {
    "shifted": lambda t: {"input_ids": t},
    "labels": lambda t: {"input_ids": t[:, :-1], "labels": t[:, 1:]},
    "loss-mask": lambda t: {
        "input_ids": t[:, :-1], "labels": t[:, 1:],
        "loss_mask": (np.arange(t.shape[1] - 1)[None, :] % 3 != 0).astype(
            np.float32) * np.ones((t.shape[0], 1), np.float32)},
}


@pytest.mark.parametrize("form", list(BATCHES))
@pytest.mark.parametrize("name", ["tiny", "bloom", "mistral-window"])
def test_loss_matches_jax(name, form):
    jm, jp, tm, tp = _models(name)
    batch = BATCHES[form](_tokens(seed=1))
    want = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, atol=1e-4, rtol=1e-4)


def _torch_grads(tm, tp, batch):
    leaves = jax.tree.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), jax.tree.map(lambda p: p.grad.numpy(), tp)


@pytest.mark.parametrize("name", ["tiny", "mixed-window", "gptj"])
def test_loss_gradients_match_jax_grad_for_every_leaf(name):
    jm, jp, tm, tp = _models(name)
    batch = {"input_ids": _tokens(seed=2)}
    jl, jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"input_ids": jnp.asarray(batch["input_ids"])})
    )(jp)
    before = dict(tfa.launches)
    tl, tg = _torch_grads(tm, tp, batch)
    assert tfa.launches == before       # CPU tensors: the plain versions
    np.testing.assert_allclose(tl, float(jl), atol=1e-4, rtol=1e-4)
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tg)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, g), (_, t) in zip(flat_j, flat_t):
        g = np.asarray(g)
        assert t.shape == g.shape and t.dtype == np.float32
        tol = 1e-4 * max(float(np.abs(g).max()), 1e-3)
        np.testing.assert_allclose(t, g, atol=tol, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_on_equals_off():
    _, _, tm, tp = _models("tiny")
    _, _, tm_remat, _ = _models("tiny", remat=True)
    batch = {"input_ids": _tokens(seed=4)}
    l0, g0 = _torch_grads(tm, tp, batch)
    g0 = jax.tree.map(np.copy, g0)
    l1, g1 = _torch_grads(tm_remat, tp, batch)
    assert l0 == l1
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_array_equal(a, b)


def test_bf16_compute_gives_fp32_gradients_on_fp32_leaves():
    """The cast to the compute type is part of the graph (``_linear``), so
    master weights stay fp32 and receive fp32 gradients."""
    _, _, tm, tp = _models("tiny")
    tm = ttf.CausalLM(dataclasses.replace(tm.cfg, dtype=torch.bfloat16))
    loss, grads = _torch_grads(tm, tp, {"input_ids": _tokens(seed=5)})
    assert np.isfinite(loss)
    for g in jax.tree.leaves(grads):
        assert g.dtype == np.float32 and np.isfinite(g).all()


def test_not_ported_attention_choices_raise():
    """``sparse`` raises (item 17). ``ring`` raised until the sequence axis
    was ported (item 14e): on one device it is the dense local attention,
    as in the JAX ``_attention``, so it gives the JAX logits (ring over a
    sequence axis: tests/test_torch_sequence.py)."""
    _, _, tm, tp = _models("tiny", attention_impl="sparse")
    with pytest.raises(NotImplementedError, match="sparse"):
        tm.apply(tp, torch.from_numpy(_tokens()))
    jm, jp, tm, tp = _models("tiny", attention_impl="ring")
    with torch.no_grad():
        got = tm.apply(tp, torch.from_numpy(_tokens()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(
        jp, jnp.asarray(_tokens()))), atol=1e-4, rtol=1e-4)
    _, _, tm, tp = _models("tiny", dropout=0.1)
    with pytest.raises(NotImplementedError, match="dropout"):
        tm.loss(tp, {"input_ids": torch.from_numpy(_tokens())}, rng=1)
    # deterministic apply with dropout configured is the plain forward
    with torch.no_grad():
        tm.apply(tp, torch.from_numpy(_tokens()))


def test_params_to_numpy_round_trip():
    _, jp, _, tp = _models("tiny")
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
