"""Port parity: MoE (``deepspeed_tpu_torch/moe/`` and the MoE paths of
``CausalLM``, the v1 and v2 engines and the training engine) against the
JAX package on the CPU, at ``TINY_TEST`` widths with 4 experts, fp32.

Tolerances:

- gating: ``combine`` and ``l_aux`` to 1e-6 (the same fp32 softmax, cumsum
  and products; 6e-8 seen), ``dispatch`` and ``exp_counts`` exactly;
- experts, dispatch/combine, dropless and the ``MoE`` layer: outputs to
  1e-5 and gradients to 1e-5 (fp32 products summed in another order);
- ``CausalLM``: logits to 1e-5, the aux loss to 1e-6 relative, and every
  gradient leaf of ``loss`` to 1e-6 (5.9e-8 seen);
- v1 and v2 greedy streams byte for byte; the training engine's losses and
  grad norms to 1e-5 and its final params to 1e-5.

Top-2 training is held to its contract, not to the JAX engine's
trajectory: the JAX engine always hands the gates a step rng, and its
``jax.random.gumbel`` draws cannot be reproduced in torch (ROADMAP queue 3).
So top-2 gating is held with a shared noise tensor, ``loss`` with
``rng=None`` and its gradients equal JAX's, and a top-2 engine's losses
fall. The multi-rank cases (``data`` x ``expert``) are in
``tests/test_torch_zero.py``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.testing import greedy_generate as j_greedy
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.moe import grouped as jgr
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe.layer import MoE as JMoE
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu_torch.inference.quantization import QuantTensor
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.testing import (assert_greedy_parity,
                                                      greedy_generate)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.moe import grouped as tgr
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.moe.layer import MoE as TMoE
import torch_cpu  # noqa: F401  (one torch thread: see the module)

E = 4


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _cfgs(**kw):
    kw = {"moe_num_experts": E, **kw}
    return (dataclasses.replace(jtf.TINY_TEST, **kw),
            dataclasses.replace(ttf.TINY_TEST, **kw))


# ------------------------------------------------------------------ gating

GATES = {
    # name: (k, capacity factor, min capacity, tokens, noise)
    "top1": (1, 2.0, 4, 32, False),
    "top1-drop": (1, 0.5, 4, 32, False),
    "top1-rsample": (1, 1.0, 4, 32, True),
    "top2-noise": (2, 1.0, 4, 32, True),
    "top2-drop": (2, 0.25, 4, 32, False),
    "min-capacity": (1, 0.01, 3, 8, False),
}


@pytest.mark.parametrize("name", list(GATES))
def test_gating_matches_jax(name):
    k, cf, min_cap, S, noisy = GATES[name]
    rng = np.random.default_rng(len(name))
    logits = rng.normal(size=(S, E)).astype(np.float32)
    if name == "min-capacity":
        logits[:, 0] += 2.0     # expert 0 takes more than its 3 slots
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.gumbel(key, logits.shape)) if noisy \
        else None
    if k == 1:
        ref = jsm.top1gating(jnp.asarray(logits), cf, min_cap,
                             rng=key if noisy else None,
                             noisy_gate_policy="RSample" if noisy else None)
        got = tsm.top1gating(_t(logits), cf, min_cap,
                             noise=None if noise is None else _t(noise),
                             noisy_gate_policy="RSample" if noisy else None)
    else:
        ref = jsm.top2gating(jnp.asarray(logits), cf, min_cap,
                             rng=key if noisy else None)
        got = tsm.top2gating(_t(logits), cf, min_cap,
                             noise=None if noise is None else _t(noise))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    np.testing.assert_allclose(_np(got[1]), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_array_equal(_np(got[2]), np.asarray(ref[2]))
    np.testing.assert_array_equal(_np(got[3]), np.asarray(ref[3]))
    C = got[1].shape[-1]
    assert C == jsm._capacity(S, E, cf * k, min_cap) == tsm._capacity(
        S, E, cf * k, min_cap)
    routed = int(_np(got[2]).sum())
    if "drop" in name or name == "min-capacity":
        assert routed < k * S            # a token over capacity is dropped
    elif name == "top1":
        assert routed == S


# ------------------------------------------------- experts and dispatch

@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_expert_mlp_and_dispatch_combine_match_jax(activation):
    rng = np.random.default_rng(1)
    S, M, F = 24, 8, 16
    x = rng.normal(size=(S, M)).astype(np.float32)
    w = {n: (rng.normal(size=s) * 0.3).astype(np.float32)
         for n, s in (("w_in", (E, M, F)), ("w_out", (E, F, M)),
                      ("w_gate", (E, M, F)))}
    wg = None if activation != "silu" else w["w_gate"]
    ein = rng.normal(size=(E, 5, M)).astype(np.float32)
    ref = jsm.expert_mlp(jnp.asarray(ein), w["w_in"], w["w_out"], wg,
                         activation)
    got = tsm.expert_mlp(_t(ein), _t(w["w_in"]), _t(w["w_out"]),
                         None if wg is None else _t(wg), activation)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)
    _, combine, dispatch, _ = jsm.top2gating(
        jnp.asarray(rng.normal(size=(S, E)).astype(np.float32)), 1.0, 4)

    def fn(pkg, wt):
        return lambda e: pkg.expert_mlp(e, wt["w_in"], wt["w_out"],
                                        wt["w_gate"] if wg is not None
                                        else None, activation)
    ref = jsm.moe_dispatch_combine(jnp.asarray(x), combine, dispatch,
                                   fn(jsm, w))
    got = tsm.moe_dispatch_combine(_t(x), _t(combine), _t(dispatch),
                                   fn(tsm, {k: _t(v) for k, v in w.items()}))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu",
                                        "gelu_exact"])
def test_dropless_matches_jax(activation):
    """Outputs, aux and gradients; one expert gets no token (an empty
    group), as the JAX package's imbalance test has it."""
    rng = np.random.default_rng(2)
    N, H, M = 20, 8, 16
    tokens = rng.normal(size=(N, H)).astype(np.float32)
    logits = rng.normal(size=(N, E)).astype(np.float32)
    logits[:, 3] -= 10.0
    w = [(rng.normal(size=s) * 0.3).astype(np.float32)
         for s in ((E, H, M), (E, M, H), (E, H, M))]
    wg = w[2] if activation == "silu" else None

    def jfn(t, lg, a, b, g):
        out, aux = jgr.dropless_moe_mlp(t, lg, a, b, g, activation)
        return jnp.sum(out * jnp.arange(H)) + aux, (out, aux)
    (_, (jout, jaux)), jg = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(tokens), jnp.asarray(logits), w[0], w[1], wg)
    ts = [_t(a).requires_grad_(True) for a in (tokens, logits, w[0], w[1])]
    out, aux = tgr.dropless_moe_mlp(*ts, None if wg is None else _t(wg),
                                    activation)
    (torch.sum(out * torch.arange(H)) + aux).backward()
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    for a, b in zip(ts, jg):
        np.testing.assert_allclose(_np(a.grad), np.asarray(b), atol=1e-5)


def test_moe_layer_forward_backward_match_jax():
    jl = JMoE(8, 16, E, k=2, capacity_factor=1.0, activation="silu")
    tl = TMoE(8, 16, E, k=2, capacity_factor=1.0, activation="silu")
    jp = jl.init(jax.random.PRNGKey(3))
    x = np.random.default_rng(3).normal(size=(2, 6, 8)).astype(np.float32)

    def jfn(p, x):
        y, aux, _ = jl.apply(p, x, rng=None)
        return jnp.sum(y ** 2) + aux, (y, aux)
    (_, (jy, jaux)), jg = jax.value_and_grad(jfn, argnums=(0, 1),
                                             has_aux=True)(jp, jnp.asarray(x))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    y, aux, counts = tl.apply(tp, tx, noise=None)
    (torch.sum(y ** 2) + aux).backward()
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    assert int(counts.sum()) == 2 * 12
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jg[1]), atol=1e-5)
    for (path, g) in jax.tree_util.tree_flatten_with_path(jg[0])[0]:
        node = tp
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(_np(node.grad), np.asarray(g), atol=1e-5,
                                   err_msg=str(path))
    assert set(tl.param_specs()) == set(jl.param_specs())


# ---------------------------------------------------------------- CausalLM

MODELS = {"top1": {"moe_top_k": 1, "moe_capacity_factor": 0.5},
          "top2": {"moe_top_k": 2},
          "dropless": {"moe_dropless": True, "activation": "gelu"}}


@pytest.mark.parametrize("name", list(MODELS))
def test_causal_lm_logits_aux_and_grads_match_jax(name):
    jcfg, tcfg = _cfgs(**MODELS[name])
    jm, tm = jtf.CausalLM(jcfg), ttf.CausalLM(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, jp)) == \
        jax.tree.structure(params_to_numpy(tm.init(device="cpu")))
    toks = np.random.default_rng(0).integers(0, 256, (2, 17)).astype(np.int32)
    jl, ja = jm.apply(jp, jnp.asarray(toks[:, :-1]), return_aux=True)
    tl, ta = tm.apply(tp, _t(toks[:, :-1]).long(), return_aux=True)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert float(ta) > 0
    jloss, jg = jax.value_and_grad(jm.loss)(jp, {"input_ids":
                                                 jnp.asarray(toks)})
    for leaf in jax.tree.leaves(tp):
        leaf.requires_grad_(True)
    loss = tm.loss(tp, {"input_ids": _t(toks).long()})
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    for (path, g) in jax.tree_util.tree_flatten_with_path(jg)[0]:
        node = tp
        for p in path:
            node = node[p.key]
        got = np.zeros_like(np.asarray(g)) if node.grad is None \
            else _np(node.grad)
        np.testing.assert_allclose(got, np.asarray(g), atol=1e-6,
                                   err_msg=str(path))


def test_top2_noise_is_drawn_from_the_generator():
    """The deliberate divergence of top-2 training: with a generator and
    ``deterministic`` off the gates read torch's own Gumbel draws (one
    seed, one result), which differ from the noiseless forward; JAX's
    draws are ``jax.random``'s (ROADMAP queue 3)."""
    _, tcfg = _cfgs(moe_top_k=2)
    tm = ttf.CausalLM(tcfg)
    tp = tm.init(device="cpu")
    toks = torch.arange(32).reshape(2, 16)
    quiet = tm.apply(tp, toks, return_aux=True)
    a = tm.apply(tp, toks, rng=torch.Generator().manual_seed(1),
                 deterministic=False, return_aux=True)
    b = tm.apply(tp, toks, rng=torch.Generator().manual_seed(1),
                 deterministic=False, return_aux=True)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], quiet[0])
    assert bool(torch.isfinite(a[1]))


def test_dropless_rejects_top2_as_jax_does():
    _, tcfg = _cfgs(moe_top_k=2, moe_dropless=True)
    tm = ttf.CausalLM(tcfg)
    with pytest.raises(ValueError, match="top-1"):
        tm.apply(tm.init(device="cpu"), torch.zeros((1, 3), dtype=torch.long))


# ------------------------------------------------------------ the engines

ENGINE_KW = dict(kv_blocks=48, kv_block_size=16, max_chunk_tokens=16,
                 max_ragged_batch_size=40, max_ragged_sequence_count=4)
PROMPT_LENS = (5, 40, 17, 33, 3)
SERVE = {
    # capacity 0.5 at top-2: a put's tokens overflow their experts
    "top2-drop": ({"moe_top_k": 2, "moe_capacity_factor": 0.5}, {}),
    "kv-int8": ({"moe_top_k": 2}, {"kv_quant_enabled": True}),
    "w-int8": ({"moe_top_k": 1}, {"weight_quant_enabled": True}),
    "dropless": ({"moe_dropless": True}, {}),
}


def _weights(jcfg):
    jp = jtf.CausalLM(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a) * (4 if a.ndim >= 2 else 1),
                        jp)


@pytest.mark.parametrize("name", list(SERVE))
def test_v2_greedy_streams_match_jax(name):
    model_kw, qkw = SERVE[name]
    jcfg, tcfg = _cfgs(**model_kw)
    w = _weights(jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]
    jeng = JEngine(jtf.CausalLM(jcfg), jax.tree.map(jnp.asarray, w),
                   JConfig(**ENGINE_KW, **qkw))
    ref = j_greedy(jeng, prompts, max_new_tokens=10, sequential=False)
    assert len({tuple(s) for s in ref}) == len(ref)   # not degenerate
    eng = InferenceEngineV2(ttf.CausalLM(tcfg), params_from_numpy(w, "cpu"),
                            RaggedInferenceEngineConfig(**ENGINE_KW, **qkw),
                            device="cpu")
    if qkw.get("weight_quant_enabled"):
        # the expert stacks stay dense, as in the JAX package
        assert torch.is_tensor(eng.params["layers"]["w_in"])
        assert isinstance(eng.params["layers"]["wq"], dict)
    got = greedy_generate(eng, prompts, max_new_tokens=10, sequential=False)
    assert_greedy_parity(ref, got, "the torch port")
    assert eng.free_blocks == ENGINE_KW["kv_blocks"]
    if name == "top2-drop":
        # the first put's 4 x 16 bucket overflows: tokens are dropped
        x = torch.randn(4 * 16, tcfg.hidden_size)
        logits = x @ params_from_numpy(w, "cpu")["layers"]["router_wg"][0]
        assert int(tsm.top2gating(logits, 0.5, 4)[2].sum()) < 2 * 64


def test_padding_rows_take_capacity():
    """Padding rows of a put route and take capacity slots (the JAX
    semantics, held above), so the paged attention must give them the
    reference's output: they attend the context, in both plain versions,
    the Pallas kernel and the port's CUDA kernels
    (``test_torch_paged_attention.py::test_every_row_matches_jax``). A
    paged attention that zeroed them would move the streams: with the
    plain attention's padding rows zeroed, a top-1 put at capacity factor
    0.5 drops other tokens and the streams move; at a capacity factor of E
    no token can drop, and they do not."""
    from deepspeed_tpu_torch.inference.v2 import paged_model

    real = paged_model.paged_attention

    def zeroed(q, kc, vc, tables, start, ntok, **kw):
        o = real(q, kc, vc, tables, start, ntok, **kw)
        keep = torch.arange(q.shape[1])[None, :] < ntok.long()[:, None]
        return o * keep[:, :, None, None].to(o.dtype)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]
    moved = {}
    for cf in (0.5, float(E)):
        _, tcfg = _cfgs(moe_top_k=1, moe_capacity_factor=cf)
        model = ttf.CausalLM(tcfg)
        params = model.init(torch.Generator().manual_seed(3), device="cpu")
        params = {g: {k: v * 4 if v.dim() >= 2 else v for k, v in sub.items()}
                  for g, sub in params.items()}
        streams = []
        for attn in (real, zeroed):
            paged_model.paged_attention = attn
            try:
                eng = InferenceEngineV2(
                    model, params, RaggedInferenceEngineConfig(**ENGINE_KW),
                    device="cpu")
                streams.append(greedy_generate(eng, prompts,
                                               max_new_tokens=10,
                                               sequential=False))
            finally:
                paged_model.paged_attention = real
        moved[cf] = streams[0] != streams[1]
    assert moved == {0.5: True, float(E): False}


def test_v1_int8_generate_matches_jax():
    """v1 int8 quantizes the stacked expert leaves too (JAX
    ``quantize_param_tree``); greedy streams byte for byte."""
    jcfg, tcfg = _cfgs(moe_top_k=2)
    w = _weights(jcfg)
    config = {"dtype": "fp32", "quant": {"enabled": True, "bits": 8}}
    jtopo.reset_topology()
    je = deepspeed_tpu.init_inference(jtf.CausalLM(jcfg), config=dict(config),
                                      params=jax.tree.map(jnp.asarray, w))
    te = deepspeed_tpu_torch.init_inference(ttf.CausalLM(tcfg),
                                            config=dict(config), params=w,
                                            device="cpu")
    assert isinstance(te.params["layers"]["w_in"], QuantTensor)
    assert te.params["layers"]["w_in"].shape == (2, E, 64, 128)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, n).tolist() for n in (3, 11, 6)]
    ref = np.asarray(je.generate(prompts, max_new_tokens=8))
    got = te.generate(prompts, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), ref)
    jtopo.reset_topology()


TRAIN = {"top1-drop-s2": {"moe_top_k": 1, "moe_capacity_factor": 0.5},
         "dropless-s2": {"moe_dropless": True}}
BASE = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0, "zero_optimization": {"stage": 2},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                                  "weight_decay": 0.01}},
        "steps_per_print": 1000}


def _data(n=16, T=17, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 256, (n, T)).astype(np.int32)}


@pytest.mark.parametrize("name", list(TRAIN))
def test_one_device_trajectory_matches_jax_engine(name):
    """Top-1 (the JAX gate reads no noise without RSample) and dropless
    under ZeRO-2 on one device: the JAX engine's trajectory."""
    jcfg, tcfg = _cfgs(**TRAIN[name])
    jtopo.reset_topology()
    je, *_ = deepspeed_tpu.initialize(
        model=jtf.CausalLM(jcfg), config=json.loads(json.dumps(BASE)),
        training_data=_data(),
        mesh=jtopo.MeshTopology.build(devices=jax.devices()[:1]))
    te, *_ = deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(tcfg), config=json.loads(json.dumps(BASE)),
        training_data=_data(),
        model_parameters=jax.tree.map(np.asarray, je.state.params),
        device="cpu")
    for _ in range(4):
        np.testing.assert_allclose(float(te.train_batch()),
                                   float(je.train_batch()), rtol=1e-5)
        np.testing.assert_allclose(te.get_global_grad_norm(),
                                   je.get_global_grad_norm(), rtol=1e-5)
    pj = jax.tree.map(np.asarray, je.state.params)
    pt = params_to_numpy(te.state.params)
    for a, b in zip(jax.tree.leaves(pj), jax.tree.leaves(pt)):
        np.testing.assert_allclose(b, a, atol=1e-5)
    jtopo.reset_topology()


def test_top2_engine_losses_fall():
    _, tcfg = _cfgs(moe_top_k=2)
    te, *_ = deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(tcfg), config=json.loads(json.dumps(BASE)),
        training_data=_data(), device="cpu")
    losses = [float(te.train_batch()) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
