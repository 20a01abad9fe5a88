"""Port parity: tensor parallelism in ``deepspeed_tpu_torch`` over 2 gloo
ranks (``tensor`` = 2), against the JAX package's tensor-parallel engines
on a mesh of two CPU devices, fp32.

One module-scoped 2-rank world (``torch_ranks.RankPool``); the 4-rank
``tensor`` x ``fsdp`` training and checkpoint cases run in
``test_torch_zero.py``'s world. Each rank builds the same engine from the
JAX ``init`` params (an ``.npz`` the test writes) and is called with the
same arguments (SPMD); it holds its blocks of the weights and its kv heads
of the pools. Tolerances, each with its reason:

- v2 ``put`` logits, prefill and 3 decode steps, dense, int8/fp8 weights
  and int8 KV: 2e-5 absolute and relative, the JAX twins'
  (``tests/test_inference.py:273``, ``test_weight_quant.py:297``,
  ``test_kv_quant.py:412``): the row-parallel sums run in another order;
  the two ranks' logits are bit-equal (one gloo sum, the same bits on both);
- a rank's weight codes and scales, and its v1 QuantTensor codes, scales
  and column span: bit-equal to the JAX package's whole-leaf ones, sliced;
- export payloads: bit-equal to the JAX engine's whole-head payload of the
  same sequence at the quantized pools (int8 codes and scales are exact
  over the sum order's noise), within 2e-5 at fp32;
- v1 ``generate``: greedy streams byte-identical to the JAX TP engine's
  (fp32, dense, int8 and int4 weights; a width where int4/int8 groups
  straddle a rank's columns); sampled streams equal on both ranks;
- training on ``tensor`` = 2: losses to 1e-5 relative, param and moment
  blocks to the tolerances of ``test_torch_zero.py``.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.inference.v2.engine_v2 import \
    InferenceEngineV2 as JEngineV2
from deepspeed_tpu.inference.v2.engine_v2 import \
    RaggedInferenceEngineConfig as JConfigV2
from deepspeed_tpu.inference.v2 import weight_quant as JW
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import sharding as jsh
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu_torch.inference.v2 import weight_quant as TW
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.parallel import sharding as tsh
from deepspeed_tpu_torch.parallel import topology as ttopo

import torch_rank_cases as cases
from test_torch_zero import (BASE, STEPS, TOL, _check_blocks, _inputs,
                             _jax_engine, _jax_train)
from torch_ranks import RankPool
import torch_cpu  # noqa: F401  (one torch thread: see the module)

TP_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def pool():
    with RankPool(2) as p:
        yield p


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        key = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], key + "."))
        else:
            out[key] = tree[k]
    return out


def _params(tmp, overrides, seed=0):
    """The JAX ``init`` params of TINY_TEST with ``overrides`` as an .npz
    the ranks read, and the JAX model."""
    model = jtf.CausalLM(dataclasses.replace(jtf.TINY_TEST, **overrides))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    path = os.path.join(tmp, "params.npz")
    np.savez(path, **_flat(params))
    return model, params, path


def _jax_tp_mesh(**sizes):
    jtopo.reset_topology()
    n = int(np.prod(list(sizes.values())))
    return jtopo.MeshTopology.build(devices=jax.devices()[:n], **sizes)


# ------------------------------------------------------------- v2 serving

V2_BASE = dict(max_ragged_batch_size=256, max_ragged_sequence_count=4,
               max_chunk_tokens=16, kv_blocks=64, kv_block_size=4,
               max_tracked_sequences=16)
# name: (model overrides, config)
V2_CASES = {
    "dense": ({}, {}),
    "w-int8-kv-int8-untied": ({"tie_embeddings": False},
                              {"weight_quant_enabled": True,
                               "kv_quant_enabled": True}),
    "w-fp8-b16-alibi": ({"position": "alibi", "tie_embeddings": False},
                        {"weight_quant_enabled": True,
                         "weight_quant_dtype": "fp8_e4m3",
                         "weight_quant_block": 16}),
}


@pytest.mark.parametrize("name", list(V2_CASES))
def test_v2_put_matches_jax_tp_engine(name, pool, tmp_path):
    """``InferenceEngineV2(..., mesh={"tensor": 2})`` on 2 ranks against
    the JAX engine on a tensor = 2 mesh: every put's logits (2e-5), equal
    bits on both ranks; pools of KH/2 kv heads; quantized blocks equal to
    the JAX codes and scales sliced; the export payload equal to the JAX
    engine's, and an import of it decoding as the original."""
    overrides, extra = V2_CASES[name]
    model, params, path = _params(str(tmp_path), overrides)
    cfg = dict(V2_BASE, **extra)
    je = JEngineV2(model, params=jax.tree.map(jnp.asarray, params),
                   config=JConfigV2(**cfg), mesh=_jax_tp_mesh(tensor=2))
    rng = np.random.default_rng(17)
    V = model.cfg.vocab_size
    prompts = {1: rng.integers(0, V, 7).tolist(),
               2: rng.integers(0, V, 12).tolist()}
    steps = [[[int(rng.integers(0, V))] for _ in prompts] for _ in range(3)]
    res = pool.run(cases.tp_v2_run, path, overrides, cfg, prompts, steps)
    want = [np.asarray(je.put([u], [p])) for u, p in prompts.items()]
    want += [np.asarray(je.put(list(prompts), s)) for s in steps]
    for r, out in enumerate(res):
        got = out["prefill"] + out["decode"]
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a, b, **TP_TOL,
                                       err_msg=f"rank {r} put {i}")
            np.testing.assert_array_equal(
                a, (res[0]["prefill"] + res[0]["decode"])[i])
        kh = model.cfg.kv_heads // 2
        assert out["pool"][2] == kh
        assert out["import_equal"]
    # the export: the JAX engine's whole-head payload of uid 1
    jp = je.export_sequence(1)["slabs"]
    for r, out in enumerate(res):
        assert set(out["payload"]) == set(jp)
        for k, v in out["payload"].items():
            jv = np.asarray(jp[k])
            if v.dtype == np.float32 and jv.dtype == np.float32:
                np.testing.assert_allclose(v, jv, **TP_TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(v, jv.view(v.dtype), err_msg=k)
    # quantized blocks: the JAX placed arrays' shards, bit for bit
    for name_, node in je.params["layers"].items():
        if not JW.is_quantized(node):
            continue
        for member, idx in (("qw", 0), ("qs", 1)):
            shards = {s.device.id: np.asarray(s.data)
                      for s in node[member].addressable_shards}
            for r, out in enumerate(res):
                got = out["quant"][name_][idx]
                np.testing.assert_array_equal(
                    got, shards[r].view(got.dtype),
                    err_msg=f"rank {r} {name_}.{member}")
    jtopo.reset_topology()


def test_v2_refusals_name_item_14(pool):
    """Over a tensor mesh the KV tier and the draft-model proposer are
    refused naming item 14b-ii; a mesh of another type still raises; MoE
    serving over a tensor or an expert axis raises naming 14d-ii."""
    for out in pool.run(cases.tp_v2_refusals):
        for key in ("tier", "tier-later", "draft", "draft-target"):
            assert "item 14b-ii" in out[key], (key, out[key])
        assert "item 14" in out["mesh"]
        for key in ("moe-tensor", "moe-expert", "moe-v1-expert"):
            assert "item 14d-ii" in out[key], (key, out[key])


# ------------------------------------------------------------------- v1

# a width at which int8/int4 groups straddle a rank's columns: w_in's 384
# columns quantize in groups of 128, a rank holds 192 of them (and wq's
# one group of 64 covers both ranks' 32)
V1_WIDE = {"intermediate_size": 384}
V1_CASES = {
    "dense-alibi": ({"position": "alibi"}, None),
    "int8-straddle": (V1_WIDE, 8),
    "int4-straddle": (V1_WIDE, 4),
}


def _rank_span(shape, spec, rank):
    t = ttopo.MeshTopology.build(world_size=2, tensor=2)
    return tsh.local_slice(shape, spec, t, rank)


@pytest.mark.parametrize("name", list(V1_CASES))
def test_v1_generate_matches_jax_tp_engine(name, pool, tmp_path):
    """``init_inference(..., tensor_parallel={"tp_size": 2})`` on 2 ranks
    against the JAX v1 engine on a tensor = 2 mesh: greedy streams byte
    for byte (fp32; ragged prompts), the sampled stream equal on both
    ranks, and each rank's QuantTensor codes, scales and column span the
    JAX whole-leaf QuantTensor's, sliced."""
    overrides, bits = V1_CASES[name]
    model, params, path = _params(str(tmp_path), overrides)
    config = {"dtype": "fp32"}
    if bits:
        config["quant"] = {"enabled": True, "bits": bits}
    je = deepspeed_tpu.init_inference(
        model, config=dict(config), params=jax.tree.map(jnp.asarray, params),
        mesh=_jax_tp_mesh(tensor=2))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab_size, n).tolist()
               for n in (3, 11, 6)]
    res = pool.run(cases.tp_v1_run, path, overrides,
                   dict(config, tensor_parallel={"tp_size": 2}), prompts, 8)
    ref = np.asarray(je.generate(prompts, max_new_tokens=8))
    for out in res:
        np.testing.assert_array_equal(out["greedy"], ref)
        np.testing.assert_array_equal(out["sampled"], res[0]["sampled"])
    if not bits:
        jtopo.reset_topology()
        return
    specs = tsh.ZeroShardingPlan(
        ttopo.MeshTopology.build(world_size=2, tensor=2), 0,
        ttf.CausalLM(dataclasses.replace(ttf.TINY_TEST, **overrides))
        .param_specs()).params(params)
    straddled = 0
    for grp, sub in je.params.items():
        for leaf_name, jq in sub.items():
            key = f"{grp}.{leaf_name}"
            whole = tuple(params[grp][leaf_name].shape)
            for r, out in enumerate(res):
                got = out["quant"][key]
                span = _rank_span(whole, specs[grp][leaf_name], r)
                if not hasattr(jq, "scales"):
                    assert got == tuple(d.stop - d.start for d in span)
                    continue
                q, s, cols, packed, shape = got
                lo, hi = span[-1].start, span[-1].stop
                a = lo - (cols[0] if cols else 0)
                width = q.shape[-1] * (2 if packed else 1)
                straddled += cols is not None
                assert shape == tuple(d.stop - d.start for d in span)
                jqv = np.asarray(jq.q)
                rows = span[:-1]
                if packed:
                    assert jq.packed and a % 2 == 0
                    want_q = jqv[rows + (slice(a // 2, (a + width) // 2),)]
                else:
                    want_q = jqv[rows + (slice(a, a + width),)]
                np.testing.assert_array_equal(q, want_q, err_msg=key)
                np.testing.assert_array_equal(
                    s, np.asarray(jq.scales)[rows + (slice(
                        a // jq.block, (a + width) // jq.block),)],
                    err_msg=key)
    assert straddled
    jtopo.reset_topology()


# ------------------------------------------------------------- training

def test_train_tensor2_matches_jax_engine(pool, tmp_path):
    """Training on ``tensor`` = 2, gradient accumulation 2 and clipping:
    both ranks read the same rows, and their losses and param and moment
    blocks match the JAX engine on a tensor = 2 mesh (tolerances of
    ``test_torch_zero.py``)."""
    cfg = {**BASE, "gradient_accumulation_steps": 2,
           "gradient_clipping": 0.05, "zero_optimization": {"stage": 0}}
    je = _jax_engine(cfg, 1, 1, tensor=2)
    params, bpath, batches = _inputs(str(tmp_path), je, cfg, 1)
    res = pool.run(cases.zero_run, json.dumps(cfg), {"tensor": 2}, params,
                   bpath, STEPS)
    jl = _jax_train(je, batches, 2, STEPS)
    for out in res:
        np.testing.assert_allclose(out["losses"], jl, rtol=TOL["fp32"]["loss"])
    _check_blocks(je, res, TOL["fp32"])
    jtopo.reset_topology()


def test_train_loader_and_lamb_over_tensor(pool):
    """Tensor peers read the same micro batches (the loader's share is the
    data-parallel index); over data = 2 the two ranks read disjoint ones.
    LAMB is refused once a leaf is tensor-sharded (its trust ratio takes
    whole-leaf norms), naming item 14."""
    same = pool.run(cases.tp_train_loader, {"tensor": 2})
    np.testing.assert_array_equal(same[0], same[1])
    apart = pool.run(cases.tp_train_loader, {"data": 2})
    assert not np.intersect1d(apart[0][0], apart[1][0]).size
    for msg in pool.run(cases.tp_lamb_refused):
        assert "LAMB" in msg and "item 14" in msg


# ------------------------------------------------------ plan and refusals

@pytest.mark.parametrize("sizes", [{"tensor": 2}, {"fsdp": 2, "tensor": 2},
                                   {"data": 2, "tensor": 2}])
@pytest.mark.parametrize("stage", [0, 3])
def test_plan_specs_and_blocks_match_jax(sizes, stage):
    """Every leaf's spec and block of the port's plan (and of its
    ``expand_spec_tree`` over a quantized tree) equal the JAX plan's on
    meshes with ``tensor``: alone, with ``fsdp`` and with ``data``;
    including the rule that drops a tensor entry that does not divide
    (an MLP width of 129, odd vocab)."""
    jcfg = dataclasses.replace(jtf.TINY_TEST, intermediate_size=129,
                               vocab_size=255, tie_embeddings=False)
    tcfg = dataclasses.replace(ttf.TINY_TEST, intermediate_size=129,
                               vocab_size=255, tie_embeddings=False)
    n = int(np.prod(list(sizes.values())))
    jt = _jax_tp_mesh(**sizes)
    tt = ttopo.MeshTopology.build(world_size=n, **sizes)
    shapes = jax.eval_shape(jtf.CausalLM(jcfg).init, jax.random.PRNGKey(0))
    jq, _ = JW.quantize_weights(jcfg, jax.tree.map(
        lambda s: jnp.zeros(s.shape, s.dtype), shapes), tp=2)
    tq = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), jq,
                      is_leaf=lambda x: hasattr(x, "shape"))
    for tree, jspecs, tspecs in (
            (shapes, jtf.CausalLM(jcfg).param_specs(),
             ttf.CausalLM(tcfg).param_specs()),
            (jq, JW.expand_spec_tree(jtf.CausalLM(jcfg).param_specs(), jq),
             TW.expand_spec_tree(ttf.CausalLM(tcfg).param_specs(), tq))):
        jplan = jsh.ZeroShardingPlan(jt, stage, jspecs).params(tree)
        tplan = tsh.ZeroShardingPlan(tt, stage, tspecs).params(
            jax.tree.map(lambda a: tuple(a.shape), tree))
        jflat, tflat = _flat(jplan), _flat(tplan)
        assert set(jflat) == set(tflat)
        for key, js in jflat.items():
            ts = tflat[key]
            assert ts == tuple(js.spec) + (None,) * (len(ts) - len(js.spec)),\
                key
            arr = _flat(tree)[key]
            shard = js.shard_shape(tuple(arr.shape))
            assert tsh.block_shape(tuple(arr.shape), ts, tt) == shard, key
    jtopo.reset_topology()


def test_heads_that_do_not_divide_raise():
    """Heads are the unit of the split: a tensor degree that does not
    divide ``num_heads`` or ``kv_heads`` raises ``ValueError`` naming both
    (the JAX serving path refuses the same)."""
    for over in ({"num_heads": 3, "num_kv_heads": 3, "hidden_size": 48},
                 {"num_kv_heads": 1}):
        cfg = dataclasses.replace(ttf.TINY_TEST, **over)
        with pytest.raises(ValueError, match="divisible by the tensor axis"):
            ttf.CausalLM(cfg, tp=2)
