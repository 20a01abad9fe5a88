"""Port parity: ``CausalLM.param_specs`` and the ZeRO sharding plan of
``deepspeed_tpu_torch`` against the JAX package, without processes.

For every leaf of two tiny models (``TINY_TEST``: RMSNorm, SwiGLU, RoPE,
tied; and a GPT-2-like one: LayerNorm, biases everywhere, learned
positions, untied head with a bias), the port's logical spec equals the
JAX one, and for the params, grads and moment plans of stages 0-3, hpZ and
a MiCS-shaped mesh on meshes (2, 2), (1, 4) and (4, 1) (data, fsdp):
every leaf's mesh spec equals the JAX ``PartitionSpec`` entry for entry,
and rank r's ``local_slice`` is the index JAX device r holds
(``NamedSharding.devices_indices_map``). On tensor x data and tensor x
fsdp meshes ``place_blocks`` cuts rank r JAX device r's shard of each leaf.
"""

import jax
import numpy as np
import pytest

from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import sharding as jsh
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
from deepspeed_tpu_torch.parallel import sharding as tsh
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime.checkpointing import param_template
import torch_cpu  # noqa: F401  (one torch thread: see the module)

GPT_LIKE = dict(vocab_size=96, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=4, max_seq_len=24, norm="layernorm",
                activation="gelu", position="learned", use_bias=True,
                tie_embeddings=False, lm_head_bias=True,
                embedding_layernorm=True)
MODELS = {"tiny": ({}, "TINY_TEST"), "gpt_like": (GPT_LIKE, None)}

# (plan, zero stage, hpz, mesh sizes (data, fsdp)); MiCS with k = 2 is
# stage 3 on the mesh the engine reshapes to (data -1, fsdp 2)
CASES = [
    ("s0", 0, False, (2, 2)), ("s1", 1, False, (2, 2)),
    ("s2", 2, False, (1, 4)), ("s3", 3, False, (2, 2)),
    ("s3", 3, False, (1, 4)), ("s3", 3, False, (4, 1)),
    ("s1", 1, False, (4, 1)), ("s2", 2, False, (2, 2)),
    ("hpz", 3, True, (2, 2)), ("hpz-s1", 1, True, (2, 2)),
    ("mics", 3, False, (2, 2)),
]


def _models(name):
    over, preset = MODELS[name]
    if preset:
        return (jtf.CausalLM(getattr(jtf, preset)),
                ttf.CausalLM(getattr(ttf, preset)))
    return (jtf.CausalLM(jtf.TransformerConfig(**over)),
            ttf.CausalLM(ttf.TransformerConfig(**over)))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("model", list(MODELS))
def test_param_specs_match_jax(model):
    jm, tm = _models(model)
    js, ts = jm.param_specs(), tm.param_specs()
    jpaths = [p for p, _ in _leaves(js)]
    assert [p for p, _ in _leaves(ts)] == jpaths
    for path, spec in _leaves(ts):
        assert isinstance(spec, tsh.ParamSpec)
        assert tuple(spec) == tuple(_get(js, path))
    # the spec tree mirrors the param tree
    shapes = param_template(tm)
    assert [p for p, _ in _leaves(shapes)] == jpaths


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("name,stage,hpz,mesh", CASES,
                         ids=[f"{c[0]}-{c[3][0]}x{c[3][1]}" for c in CASES])
def test_plan_blocks_match_jax_devices(model, name, stage, hpz, mesh):
    jm, tm = _models(model)
    data, fsdp = mesh
    jt = jtopo.MeshTopology.build(devices=jax.devices()[:4], data=data,
                                  fsdp=fsdp)
    tt = ttopo.MeshTopology.build(world_size=4, data=data, fsdp=fsdp)
    jplan = jsh.ZeroShardingPlan(jt, stage, jm.param_specs(), hpz=hpz)
    tplan = tsh.ZeroShardingPlan(tt, stage, tm.param_specs(), hpz=hpz)
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tshapes = param_template(tm)
    moments = ("m", "v")
    pairs = [(jplan.params(jshapes), tplan.params(tshapes)),
             (jplan.grads(jshapes), tplan.grads(tshapes))]
    jo = jplan.opt_state({k: jshapes for k in moments})
    to = tplan.opt_state({k: tshapes for k in moments})
    pairs += [(jo[k], to[k]) for k in moments]
    sharded = 0
    for jtree, ttree in pairs:
        for path, tspec in _leaves(ttree):
            jsharding = _get(jtree, path)
            shape = tuple(_get(tshapes, path).shape)
            assert tspec == tuple(jsharding.spec), (name, path)
            dev_index = jsharding.devices_indices_map(shape)
            for dev, index in dev_index.items():
                want = tuple(sl.indices(d)[:2] for sl, d in zip(index, shape))
                got = tsh.local_slice(shape, tspec, tt, dev.id)
                assert tuple((s.start, s.stop) for s in got) == want
            sharded += tsh.is_sharded(tspec, tt)
            # the first holder of each block is JAX's replica 0
            holders = {}
            for r in range(4):
                key = tuple((s.start, s.stop) for s in
                            tsh.local_slice(shape, tspec, tt, r))
                holders.setdefault(key, []).append(r)
            for ranks in holders.values():
                assert [r for r in ranks
                        if tsh.is_replica_zero(tspec, tt, r)] == [ranks[0]]
    # ZeRO shards over fsdp (and data under hpZ) only
    assert (sharded > 0) == (stage > 0 and (fsdp > 1 or hpz))
    assert tplan.batch() == (jtopo.BATCH_AXES,)
    assert tuple(jplan.batch().spec) == tplan.batch()
    assert tplan.replicated() == tuple(jplan.replicated().spec)


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("stage,mesh", [(0, dict(data=2, tensor=2)),
                                        (3, dict(fsdp=2, tensor=2))],
                         ids=["s0-d2t2", "s3-f2t2"])
def test_place_blocks_are_the_jax_shards(model, stage, mesh):
    """``place_blocks`` gives rank r, for every leaf, JAX device r's shard
    of the placed fp32 tree, bit for bit, as a contiguous tensor."""
    jm, tm = _models(model)
    jt = jtopo.MeshTopology.build(devices=jax.devices()[:4], **mesh)
    tt = ttopo.MeshTopology.build(world_size=4, **mesh)
    jparams = jm.init(jax.random.PRNGKey(0))
    placed = jax.device_put(jparams, jsh.ZeroShardingPlan(
        jt, stage, jm.param_specs()).params(jparams))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tspecs = tsh.ZeroShardingPlan(tt, stage, tm.param_specs()).params(tparams)
    for r in range(4):
        blocks = tsh.place_blocks(tparams, tspecs, tt, r, "cpu")
        for path, blk in _leaves(blocks):
            shard = next(s for s in _get(placed, path).addressable_shards
                         if s.device.id == r)
            assert blk.is_contiguous(), path
            np.testing.assert_array_equal(blk.numpy(), np.asarray(shard.data))


def test_shard_spec_for_fallback_and_rules():
    """The fsdp fallback (no ``embed`` dim divides: the largest that does),
    a hpZ group, and a tensor rule that does not divide (dropped)."""
    tt = ttopo.MeshTopology.build(world_size=4, data=2, fsdp=2)
    jt = jtopo.MeshTopology.build(devices=jax.devices()[:4], data=2, fsdp=2)
    for shape, logical, stage, force, axes in [
            ((6, 8, 3), ("layers", "embed", "mlp"), 3, False, ("fsdp",)),
            ((5, 7), ("embed", None), 3, False, ("fsdp",)),
            ((3, 8), (None, "heads"), 1, True, ("fsdp", "data")),
            ((4, 6), None, 2, True, ("fsdp",))]:
        got = tsh.shard_spec_for(shape, logical, tt, stage, force_fsdp=force,
                                 fsdp_axes=axes)
        want = jsh.shard_spec_for(shape, logical, jt.mesh, stage,
                                  force_fsdp=force, fsdp_axes=axes)
        assert got == tuple(want)
    assert tsh.block_shape((8, 6), (("fsdp", "data"), None), tt) == (2, 6)


@pytest.mark.parametrize("block,item", [
    ({"pipeline": {"stages": 2}}, "builds"),
    ({"mesh": {"pipe": 2}}, "ValueError as JAX"),
    ({"mesh": {"sequence": 2}}, "ValueError as JAX"),
    ({"pipeline": {"micro_batches": 2}}, "builds"),
    ({"optimizer": {"type": "OneBitAdam", "params": {}}}, "item 14"),
    ({"sparse_gradients": True}, "queue 3"),
    ({"communication_data_type": "fp16"}, "queue 3")])
def test_axes_beyond_the_spine_still_raise(block, item):
    """The 1-bit optimizers raise naming item 14 (the tensor axis runs:
    ``test_torch_tensor_parallel.py``; the expert axis:
    ``test_torch_zero.py``'s MoE cases; the pipe and sequence axes:
    ``test_torch_pipeline.py``, ``test_torch_sequence.py``); the two keys
    the JAX package declares and never reads raise naming queue 3. The
    item 14e blocks, which raised until the pipe and sequence axes were
    ported, now build in a one-process world (a ``pipeline`` block), or
    raise the JAX topology's own ``ValueError`` (a pipe or sequence axis of
    2 over one device: no data axis can be inferred)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu.runtime.config import MeshConfig

    def build():
        return deepspeed_tpu_torch.initialize(
            model=ttf.CausalLM(ttf.TINY_TEST), device="cpu",
            config={"train_batch_size": 2, **block})

    if item == "builds":
        engine = build()[0]
        assert engine.module.pp == 1 and engine.module.sp == 1
        assert engine.module.cfg.pipeline_microbatches == \
            block["pipeline"].get("micro_batches", 0)
        return
    if item == "ValueError as JAX":
        with pytest.raises(ValueError) as te:
            build()
        with pytest.raises(ValueError) as je:
            jtopo.MeshTopology.build(MeshConfig(**block["mesh"]),
                                     devices=jax.devices()[:1])
        assert str(te.value) == str(je.value)
        return
    with pytest.raises(NotImplementedError, match=item):
        build()
