"""Port parity: activation checkpointing of ``deepspeed_tpu_torch``
(``runtime/activation_checkpointing.py`` and ``CausalLM``'s ``remat`` /
``remat_policy``), twin of ``tests/test_activation_checkpointing.py``.

Under every policy the checkpointed function's value and gradients equal
the plain function's bit for bit (the same float32 operations, recomputed)
and the JAX ``checkpoint``'s to 1e-6; ``dots_saveable`` keeps the matrix
products, so its backward dispatches fewer of them than
``nothing_saveable``'s; dropout masks replay under recomputation; an
unknown policy raises. ``CausalLM`` at ``TINY_TEST`` widths with ``remat``
and each ``remat_policy`` gives the gradients of the model without remat
bit for bit and those of the JAX model within the tolerance of
``tests/test_torch_transformer.py`` for paths with matmuls (atol 1e-4,
rtol 1e-5). The ``activation_checkpointing`` config block is accepted and
recorded as the JAX package records it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.runtime import activation_checkpointing as jac
from deepspeed_tpu.runtime.config import DeepSpeedTpuConfig as JConfig
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.runtime.config import load_config
import torch_cpu  # noqa: F401  (one torch thread: see the module)

POLICIES = [None, "dots_saveable", "nothing_saveable"]
# tests/test_torch_transformer.py's tolerance for paths with matmuls
MM = dict(atol=1e-4, rtol=1e-5)


def _wx():
    w = np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32)
    return w, x


def f_torch(w, x):
    h = torch.tanh(x @ w)
    return torch.sum(h @ w.t())


def f_jax(w, x):
    h = jnp.tanh(x @ w)
    return jnp.sum(h @ w.T)


class CountMM(TorchDispatchMode):
    """Counts the matrix products that reach the dispatcher."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                    torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _value_grad(fn, w_np, x_np):
    w = torch.from_numpy(w_np).requires_grad_(True)
    x = torch.from_numpy(x_np)
    out = fn(w, x)
    counter = CountMM()
    with counter:
        out.backward()
    return out.detach(), w.grad, counter.n


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpoint_matches_plain_and_jax(policy):
    w, x = _wx()
    plain_v, plain_g, _ = _value_grad(f_torch, w, x)
    v, g, _ = _value_grad(
        lambda w, x: ac.checkpoint(f_torch, w, x, policy=policy), w, x)
    assert torch.equal(v, plain_v) and torch.equal(g, plain_g)
    jv, jg = jax.value_and_grad(
        lambda w: jac.checkpoint(f_jax, w, jnp.asarray(x), policy=policy))(
            jnp.asarray(w))
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


def test_dots_saveable_keeps_the_matrix_products():
    w, x = _wx()
    counts = {p: _value_grad(
        lambda w, x: ac.checkpoint(f_torch, w, x, policy=p), w, x)[2]
        for p in POLICIES}
    plain = _value_grad(f_torch, w, x)[2]
    # the recomputation runs the forward product that the backward needs
    # (x @ w, through tanh's backward) once more; dots_saveable kept it
    assert counts[None] == counts["nothing_saveable"] == plain + 1
    assert counts["dots_saveable"] == plain


@pytest.mark.parametrize("policy", POLICIES)
def test_dropout_masks_replay_under_recompute(policy):
    w = torch.ones(8, 8)

    def f(w):
        return torch.sum(torch.nn.functional.dropout(w @ w, 0.5))

    def value_grad(fn):
        ww = w.clone().requires_grad_(True)
        torch.manual_seed(0)
        out = fn(ww)
        out.backward()
        return out.detach(), ww.grad

    v, g = value_grad(lambda w: ac.checkpoint(f, w, policy=policy))
    pv, pg = value_grad(f)
    assert torch.equal(v, pv) and torch.equal(g, pg)


def test_unknown_policy_raises():
    w, x = _wx()
    with pytest.raises(ValueError, match="unknown remat policy"):
        ac.checkpoint(f_torch, torch.from_numpy(w), torch.from_numpy(x),
                      policy="everything_saveable")
    with pytest.raises(ValueError, match="unknown remat policy"):
        jac.checkpoint(f_jax, jnp.asarray(w), jnp.asarray(x),
                       policy="everything_saveable")
    model = ttf.CausalLM(dataclasses.replace(
        ttf.TINY_TEST, remat=True, remat_policy="everything_saveable"))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="unknown remat policy"):
        model.loss(params, {"input_ids": torch.zeros(1, 5, dtype=torch.long)})


def test_configure_and_probes():
    saved = dict(ac._config)
    try:
        ac.configure(partition_activations=True, num_checkpoints=4)
        assert ac._config["partition_activations"] is True
        assert ac._config["num_checkpoints"] == 4
        ac.partition_activations_in_checkpoint(False)
        assert ac._config["partition_activations"] is False
        cfg = load_config(
            {"activation_checkpointing": {"cpu_checkpointing": True,
                                          "number_checkpoints": 2}})
        ac.configure(deepspeed_config=cfg)
        assert ac._config["cpu_checkpointing"] is True
        assert ac._config["num_checkpoints"] == 2
        assert ac.is_configured()
        out = ac.CheckpointFunction.apply(lambda x: x * 2, torch.ones(3))
        assert torch.equal(out, torch.full((3,), 2.0))
        assert ac.get_rng_tracker() is None
        assert ac.model_parallel_cuda_manual_seed(1234) is None
    finally:
        ac._config.clear()
        ac._config.update(saved)


def _grads(model, params, tokens):
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss = model.loss(params, {"input_ids": torch.from_numpy(tokens)})
    loss.backward()
    return loss.detach(), [p.grad.clone() for p in tree_leaves(params)]


@pytest.mark.parametrize("policy", POLICIES)
def test_causal_lm_remat_policies(policy):
    jcfg = dataclasses.replace(jtf.TINY_TEST, remat=True, remat_policy=policy)
    jm = jtf.CausalLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(2).integers(0, 256, (2, 19)).astype(
        np.int32)
    jl, jg = jax.value_and_grad(
        lambda p: jm.loss(p, {"input_ids": jnp.asarray(tokens)}))(jp)
    tcfg = dataclasses.replace(ttf.TINY_TEST, remat=True, remat_policy=policy)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    loss, grads = _grads(ttf.CausalLM(tcfg), tp, tokens)
    plain_loss, plain_grads = _grads(ttf.CausalLM(ttf.TINY_TEST), tp, tokens)
    assert torch.equal(loss, plain_loss)
    for a, b in zip(grads, plain_grads, strict=True):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(loss), float(jl), **MM)
    for g, t in zip(jax.tree.leaves(jg), grads, strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(g), **MM)


def test_config_block_is_accepted_and_recorded():
    block = {"partition_activations": True, "cpu_checkpointing": True,
             "contiguous_memory_optimization": True,
             "number_checkpoints": 4, "synchronize_checkpoint_boundary": True,
             "profile": True}
    eng = deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(ttf.TINY_TEST),
        config={"train_batch_size": 2, "activation_checkpointing": block},
        device="cpu")[0]
    assert eng.config.activation_checkpointing.to_dict() == \
        JConfig(activation_checkpointing=block).activation_checkpointing \
        .model_dump()
    tokens = np.random.default_rng(3).integers(0, 256, (2, 9))
    assert np.isfinite(float(eng.train_batch(iter([{"input_ids": tokens}]))))
