"""Port parity: pipeline parallelism of ``deepspeed_tpu_torch`` — the
host-level API (``runtime/pipe``: topology, schedules, partitioning, the
host-driven ``PipelineEngine``) and the SPMD pipeline over the ``pipe``
axis (``parallel/pipeline.py``, ``CausalLM(cfg, pp=...)``, the training
engine) over 4 gloo ranks — against the JAX package (the twins of
``tests/test_pipeline.py`` and ``tests/test_pipe_executor.py``).

One module-scoped 4-rank world of its own (``torch_ranks.RankPool``); the
JAX references run in this process on the conftest's 8 host devices.
Inputs are numpy draws from fixed seeds, weights cross from the JAX
``init`` (the executor's from the JAX executor's own params). Models are
``TINY_TEST`` with ``num_kv_heads=4`` in fp32. Tolerances: outputs 2e-5 and
gradients rtol 2e-4 / atol 2e-5 (``test_pipeline.py``'s), losses rtol
1e-4; the engines' losses 1e-5 and param blocks 1e-4 (as
``test_torch_zero.py``'s fp32 engines); the executors' params 1e-5 / 1e-6
(``test_pipe_executor.py``'s).

The port's pipeline computes only each stage's live ticks (the JAX program
computes the fill and drain ticks and masks them), so a rank launches the
attention kernels M x L/P times a forward; ``chip_smoke.py`` asserts that
count on the card, where the kernels count their launches.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.runtime import pipe as jpipe
from deepspeed_tpu.runtime.pipe.module import \
    partition_balanced as jpartition
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.runtime import pipe as tpipe
from deepspeed_tpu_torch.runtime.pipe.module import \
    partition_balanced as tpartition

import torch_seq_pipe_cases as cases
from torch_ranks import RankPool
import torch_cpu  # noqa: F401  (one torch thread: see the module)

CFG = dataclasses.replace(jtf.TINY_TEST, num_kv_heads=4)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as p:
        yield p


def _mesh(**axes):
    jtopo.reset_topology()
    n = int(np.prod(list(axes.values())))
    t = jtopo.MeshTopology.build(devices=jax.devices()[:n], **axes)
    jtopo.set_topology(t)
    return t


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        key = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], key + "."))
        else:
            out[key] = np.asarray(tree[k])
    return out


# ---------------------------------------------------------------- topology

def test_process_topology_rank_mapping():
    for mod in (jpipe, tpipe):
        t = mod.ProcessTopology(axes=["pipe", "data"], dims=[2, 4])
        assert t.world_size() == 8
        assert t.get_rank(pipe=0, data=0) == 0
        assert t.get_rank(pipe=0, data=3) == 3
        assert t.get_rank(pipe=1, data=0) == 4
        assert tuple(t.get_coord(5)) == (1, 1)
    j = jpipe.ProcessTopology(axes=["pipe", "data"], dims=[2, 4])
    p = tpipe.ProcessTopology(axes=["pipe", "data"], dims=[2, 4])
    assert str(p) == str(j)
    assert [p.get_axis_list("data", i) for i in range(4)] == \
        [j.get_axis_list("data", i) for i in range(4)]


def test_axis_comm_lists():
    j = jpipe.PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    p = tpipe.PipeModelDataParallelTopology(num_pp=2, num_mp=2, num_dp=2)
    for axis in ("pipe", "data", "model", "missing"):
        assert p.get_axis_comm_lists(axis) == j.get_axis_comm_lists(axis)
    assert p.filter_match(pipe=0) == j.filter_match(pipe=0) == [0, 1, 2, 3]
    assert len(p.get_axis_comm_lists("pipe")) == 4


def test_rank_repr():
    for num_dp in (1, 2):
        j = jpipe.PipeModelDataParallelTopology(num_pp=2, num_mp=2,
                                                num_dp=num_dp)
        p = tpipe.PipeModelDataParallelTopology(num_pp=2, num_mp=2,
                                                num_dp=num_dp)
        for r in range(p.world_size()):
            assert p.get_rank_repr(r) == j.get_rank_repr(r)
            assert p.get_rank_repr(r, omit_axes=()) == \
                j.get_rank_repr(r, omit_axes=())
    r = p.get_rank_repr(p.get_rank(pipe=1, data=0, model=1))
    assert "pipe_01" in r and "model_01" in r


# ---------------------------------------------------------------- schedules

GRID = [(M, S, sid) for M, S in ((1, 1), (2, 2), (4, 2), (6, 2), (3, 3),
                                 (6, 4), (8, 4))
        for sid in range(S)]


@pytest.mark.parametrize("kind", ["TrainSchedule", "InferenceSchedule"])
def test_schedules_equal_the_jax_streams(kind):
    """Every step's instruction list, element for element, over a grid of
    micro-batch, stage and stage-id counts."""
    for M, S, sid in GRID:
        j = getattr(jpipe, kind)(micro_batches=M, stages=S, stage_id=sid)
        p = getattr(tpipe, kind)(micro_batches=M, stages=S, stage_id=sid)
        js, ps = j.steps(), p.steps()
        assert [[repr(c) for c in step] for step in ps] == \
            [[repr(c) for c in step] for step in js], (kind, M, S, sid)
        assert p.num_pipe_buffers == j.num_pipe_buffers
        assert [type(c).__name__ for step in ps for c in step] == \
            [type(c).__name__ for step in js for c in step]


@pytest.mark.parametrize("stages,stage_id", [(2, 0), (2, 1), (4, 2)])
def test_train_schedule_1f1b_counts(stages, stage_id):
    M = 6
    steps = tpipe.TrainSchedule(micro_batches=M, stages=stages,
                                stage_id=stage_id).steps()
    flat = [c for cmds in steps for c in cmds]
    assert sum(isinstance(c, tpipe.ForwardPass) for c in flat) == M
    assert sum(isinstance(c, tpipe.BackwardPass) for c in flat) == M
    assert sum(isinstance(c, tpipe.OptimizerStep) for c in flat) == 1


# ------------------------------------------------------------- partitioning

@pytest.mark.parametrize("weights,parts", [
    ([1.0] * 8, 4), ([10.0, 1.0, 1.0, 1.0], 2), ([3.0, 1.0, 4.0, 1.0, 5.0,
                                                  9.0, 2.0, 6.0], 3),
    ([1.0, 2.0], 4)])
def test_partition_balanced_matches_jax(weights, parts):
    assert tpartition(weights, parts) == jpartition(weights, parts)


def test_pipeline_module_stage_assignment():
    class Dummy:
        def __init__(self, n):
            self.n = n

        def num_params(self):
            return self.n

    for method in ("parameters", "uniform", "type:dummy"):
        pms = [mod.PipelineModule(
            [mod.LayerSpec(Dummy, 100), mod.LayerSpec(Dummy, 1),
             mod.LayerSpec(Dummy, 1), mod.LayerSpec(Dummy, 100)],
            num_stages=2, partition_method=method) for mod in (jpipe, tpipe)]
        assert pms[1].parts == pms[0].parts
        assert [pms[1].stage_owner(i) for i in range(4)] == \
            [pms[0].stage_owner(i) for i in range(4)]
    assert pms[1].stage_owner(0) == 0 and pms[1].stage_owner(3) == 1


@pytest.mark.parametrize("axes", [{"pipe": 2, "tensor": 2},
                                  {"pipe": 2, "data": 2},
                                  {"sequence": 2, "data": 2}])
def test_plan_maps_layers_to_pipe_as_jax(axes):
    """The training plan's specs of every leaf equal the JAX plan's on the
    same mesh (the stacked ``layers`` dim over ``pipe``); the serving
    engines' rules keep every layer on every rank and shard the tensor
    axis alone."""
    from deepspeed_tpu.parallel import sharding as jsh
    from deepspeed_tpu_torch.parallel import sharding as tsh
    from deepspeed_tpu_torch.parallel import topology as ttopo

    tt = ttopo.MeshTopology.build(world_size=4, **axes)
    jt = jtopo.MeshTopology.build(devices=jax.devices()[:4], **axes)
    model = ttf.CausalLM(ttf.TINY_TEST)
    shapes = jax.tree.map(lambda t: tuple(t.shape),
                          model.init(torch.Generator(), device="meta"))
    specs = _flat_specs(model.param_specs())
    for stage in (0, 1, 3):
        got = _flat_specs(tsh.ZeroShardingPlan(
            tt, stage, model.param_specs()).params(shapes))
        for key, shape in _flat_specs(shapes).items():
            want = jsh.shard_spec_for(shape, specs[key], jt.mesh, stage)
            assert got[key] == tuple(want), (key, stage)
    serving = _flat_specs(tsh.ZeroShardingPlan(
        tt, 0, model.param_specs(), rules=tsh.SERVING_RULES).params(shapes))
    for key, spec in serving.items():
        assert "pipe" not in spec and "sequence" not in spec, key
    assert serving["layers.wq"] == (
        (None, None, "tensor") if axes.get("tensor") else (None,) * 3)


def _flat_specs(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat_specs(tree[k], f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


# ---------------------------------------------------------- SPMD execution

def test_spmd_pipeline_matches_sequential_and_jax(pool):
    """``pipelined_layer_apply`` over pipe = 4 (4 micro-batches) and over
    pipe = 2 with the gradient of sum(out ** 2), against the plain loop
    (as the JAX pipeline is held) and ``jax.grad``."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(8, 16, 16)) * 0.1).astype(np.float32)
    x = rng.normal(size=(4, 8, 16)).astype(np.float32)
    res = pool.run(cases.pipelined_apply_cases, w, x,
                   [("pipe4", 4, 4, False), ("pipe2-grads", 2, 2, True)])

    def seq(w):
        y = jnp.asarray(x)
        for i in range(8):
            y = jnp.tanh(y @ w[i])
        return y

    want = np.asarray(seq(jnp.asarray(w)))
    dw = np.asarray(jax.grad(lambda w: jnp.sum(seq(w) ** 2))(jnp.asarray(w)))
    for r in res:
        np.testing.assert_allclose(r["pipe4"]["out"], want, **OUT_TOL)
        np.testing.assert_allclose(r["pipe2-grads"]["out"], want, **OUT_TOL)
        np.testing.assert_allclose(r["pipe2-grads"]["dw"], dw, **GRAD_TOL)
        assert r["pipe4"]["aux"] == 0.0


@pytest.fixture(scope="module")
def model_inputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipe_model"))
    out = {}
    for name, over in (("dense", {}), ("moe", {"moe_num_experts": 4,
                                               "moe_capacity_factor": 2.0})):
        params = jtf.CausalLM(dataclasses.replace(CFG, **over)).init(
            jax.random.PRNGKey(0))
        path = os.path.join(tmp, f"{name}.npz")
        np.savez(path, **_flat(jax.tree.map(np.asarray, params)))
        out[name] = (params, path)
    out["batch"] = np.random.default_rng(0).integers(
        0, CFG.vocab_size, size=(4, 33)).astype(np.int64)
    return out


@pytest.fixture(scope="module")
def pipe_model(pool, model_inputs):
    batch = model_inputs["batch"]
    dense = pool.run(cases.pipe_loss_cases, model_inputs["dense"][1], batch,
                     [("loss", {"num_kv_heads": 4,
                                "pipeline_microbatches": 2}, "loss")])
    moe = pool.run(cases.pipe_loss_cases, model_inputs["moe"][1],
                   batch[:, :32],
                   [("aux", {"num_kv_heads": 4, "moe_num_experts": 4,
                             "moe_capacity_factor": 2.0,
                             "pipeline_microbatches": 2}, "aux")])
    return [dict(d, **m) for d, m in zip(dense, moe)]


def test_pipeline_loss_and_grads_match_jax(pipe_model, model_inputs):
    """``CausalLM(cfg, pp=2).loss`` on each stage's layer block equals the
    JAX unpipelined loss (which the JAX pipelined loss is held to); the
    layers' gradient blocks, gathered over the stages, and the other
    leaves' gradients, summed over them, equal ``jax.grad``: the embedding
    and the head each count once."""
    params, _ = model_inputs["dense"]
    model = jtf.CausalLM(dataclasses.replace(CFG,
                                             attention_impl="reference"))
    jb = {"input_ids": jnp.asarray(model_inputs["batch"])}
    _mesh(data=1)
    dense, grads = jax.jit(jax.value_and_grad(model.loss))(params, jb)
    jtopo.reset_topology()
    want = _flat(jax.tree.map(np.asarray, grads))
    for r, res in enumerate(pipe_model):
        got = res["loss"]
        np.testing.assert_allclose(got["loss"], float(dense), rtol=1e-4,
                                   err_msg=f"rank {r}")
        assert set(got["grads"]) == set(want)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want[k], **GRAD_TOL,
                                       err_msg=f"rank {r} {k}")


def test_pipeline_moe_aux_loss_matches_jax(pipe_model, model_inputs):
    """The MoE aux loss flows out of the pipelined path (nonzero) and equals
    the JAX pipelined aux (each micro-batch gated alone, averaged), and the
    logits equal JAX's."""
    params, _ = model_inputs["moe"]
    model = jtf.CausalLM(dataclasses.replace(
        CFG, moe_num_experts=4, moe_capacity_factor=2.0,
        pipeline_microbatches=2))
    tokens = jnp.asarray(model_inputs["batch"][:, :32])
    _mesh(pipe=2, data=2)
    logits, aux = jax.jit(lambda p, t: model.apply(p, t, return_aux=True))(
        params, tokens)
    jtopo.reset_topology()
    assert float(aux) > 0
    for res in pipe_model:
        np.testing.assert_allclose(res["aux"]["aux"], float(aux), rtol=1e-5)
        np.testing.assert_allclose(res["aux"]["logits"], np.asarray(logits),
                                   **OUT_TOL)


def test_refusals_keep_the_jax_messages(pool, model_inputs):
    """Per-layer window segments under a pipe axis and dropless MoE with
    expert parallelism under a pipe axis raise ``NotImplementedError`` with
    the JAX package's messages."""
    got = pool.run(cases.pipe_refusals, model_inputs["dense"][1])
    tokens = jnp.zeros((2, 8), jnp.int32)
    want = {}

    def refusal(cfg):
        # traced abstractly: the JAX refusals are raised while tracing
        model = jtf.CausalLM(cfg)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        with pytest.raises(NotImplementedError) as e:
            jax.eval_shape(lambda p: model.apply(p, tokens), shapes)
        return str(e.value)

    _mesh(pipe=2, data=2)
    want["windows"] = refusal(dataclasses.replace(CFG, sliding_window=(4, 0)))
    _mesh(pipe=2, expert=2, data=1)
    want["dropless"] = refusal(dataclasses.replace(
        CFG, moe_num_experts=2, moe_dropless=True))
    jtopo.reset_topology()
    for r in got:
        assert r == want


# ------------------------------------------------------------- the engine

ENGINE = {"train_micro_batch_size_per_gpu": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 2e-3,
                                                    "weight_decay": 0.01}},
          "zero_optimization": {"stage": 1}, "gradient_clipping": 0.05,
          "pipeline": {"stages": 2, "micro_batches": 2},
          "steps_per_print": 1000}


ONE = {k: v for k, v in ENGINE.items() if k != "pipeline"} \
    | {"train_micro_batch_size_per_gpu": 4}


@pytest.fixture(scope="module")
def engines(pool, tmp_path_factory):
    """(data 2, pipe 2) at ZeRO 1 with 2 pipeline micro-batches: the port
    ranks train 2 steps, save, train a third. The reference is the JAX
    engine on one device over the same global batches (which the JAX
    package's pipelined engine is held to, ``tests/test_pipeline.py``); a
    one-process port engine also trains them and saves after 2."""
    tmp = str(tmp_path_factory.mktemp("pipe_engine"))
    je, *_ = deepspeed_tpu.initialize(model=jtf.CausalLM(CFG), config=ONE,
                                      mesh=_mesh(data=1))
    params = os.path.join(tmp, "params.npz")
    np.savez(params, **_flat(jax.tree.map(np.asarray, je.state.params)))
    batches = np.repeat(np.random.default_rng(2).integers(
        0, CFG.vocab_size, (1, 4, 17)).astype(np.int32), 3, axis=0)
    bpath = os.path.join(tmp, "batches.npy")
    np.save(bpath, batches)
    cfg = dict(ENGINE, _model={"num_kv_heads": 4})
    port_dir = os.path.join(tmp, "port")
    res = pool.run(cases.engine_run, json.dumps(cfg), {"data": 2, "pipe": 2},
                   params, bpath, 3, save_dir=port_dir, save_after=2)
    jl = [float(je.train_batch(iter([{"input_ids": b}]))) for b in batches]
    jp = _flat(jax.tree.map(np.asarray, je.state.params))
    # the JAX loader reads the port's pipe-sharded save; step 3 again
    je.load_checkpoint(port_dir)
    resumed = float(je.train_batch(iter([{"input_ids": batches[2]}])))
    jtopo.reset_topology()
    one, *_ = deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(dataclasses.replace(ttf.TINY_TEST,
                                               num_kv_heads=4)),
        config=ONE, model_parameters=cases._tree(params), device="cpu")
    one_dir = os.path.join(tmp, "one")
    ol = []
    for s, b in enumerate(batches):
        ol.append(float(one.train_batch(iter([{"input_ids": b}]))))
        if s == 1:
            one.save_checkpoint(one_dir, tag="ckpt")
    return {"res": res, "jax_losses": jl, "jax_params": jp,
            "jax_resumed": resumed, "params": params, "bpath": bpath,
            "batches": batches, "port_dir": port_dir, "one_losses": ol,
            "one_dir": one_dir, "cfg": cfg}


def test_engine_matches_jax_engine_on_pipe_mesh(engines):
    """Every rank's losses equal the JAX engine's over the same global
    batches, and its param blocks (its stage's layers, the whole other
    leaves) equal the JAX params' blocks; each rank holds half the
    layers."""
    for r, out in enumerate(engines["res"]):
        np.testing.assert_allclose(out["losses"], engines["jax_losses"],
                                   rtol=1e-5, err_msg=f"rank {r}")
        stage = r // 2          # rank = pipe x 2 + data
        for k, blk in out["params"].items():
            want = engines["jax_params"][k]
            if k.startswith("layers."):
                want = want[stage:stage + 1]
            np.testing.assert_allclose(blk, want, rtol=0, atol=1e-4,
                                       err_msg=f"rank {r} {k}")
        assert out["params"]["layers.wq"].shape[0] == 1
    np.testing.assert_allclose(engines["one_losses"], engines["jax_losses"],
                               rtol=1e-5)
    assert engines["jax_losses"][-1] < engines["jax_losses"][0]


def test_pipe_sharded_save_matches_jax_layout(engines):
    """The pipe = 2 save writes each stage's layer blocks as the JAX
    package's shard files, and the JAX loader reads them into the step-3
    loss of the port's unbroken run."""
    files = engines["res"][0]["files"]
    wq = [f for f in files if f.startswith("layers.wq.")]
    assert len(wq) == 2 and all(".shard_" in f for f in wq)
    blocks = [np.load(os.path.join(engines["port_dir"], "ckpt", "params", f))
              for f in wq]
    assert [b.shape for b in blocks] == [(1, 64, 64)] * 2
    np.testing.assert_allclose(engines["jax_resumed"],
                               engines["res"][0]["losses"][2], rtol=1e-5)


@pytest.mark.parametrize("direction", ["pipe-to-one", "one-to-pipe"])
def test_resume_across_meshes(direction, engines, pool):
    """A pipe = 2 save resumes in one process, and a one-process save
    resumes at pipe = 2, on the writer's curve."""
    if direction == "pipe-to-one":
        one, *_ = deepspeed_tpu_torch.initialize(
            model=ttf.CausalLM(dataclasses.replace(ttf.TINY_TEST,
                                                   num_kv_heads=4)),
            config=ONE, device="cpu")
        one.load_checkpoint(engines["port_dir"])
        got = [float(one.train_batch(iter([{"input_ids":
                                            engines["batches"][2]}])))]
        want = engines["res"][0]["losses"][2]
    else:
        res = pool.run(cases.engine_run, json.dumps(engines["cfg"]),
                       {"data": 2, "pipe": 2}, engines["params"],
                       engines["bpath"], 1, load_dir=engines["one_dir"],
                       first=2)
        got = [out["losses"][0] for out in res]
        want = engines["one_losses"][2]
    np.testing.assert_allclose(got, [want] * len(got), rtol=1e-5)


# ------------------------------------------ the host-driven PipelineEngine

class JLinear:
    def __init__(self, out_dim, act=True):
        self.out_dim, self.act = out_dim, act

    def init(self, rng, x):
        k1, _ = jax.random.split(rng)
        return {"w": 0.3 * jax.random.normal(k1, (x.shape[-1], self.out_dim)),
                "b": jnp.zeros((self.out_dim,))}

    def apply(self, p, x):
        y = x @ p["w"] + p["b"]
        return jnp.tanh(y) if self.act else y


class JEmbed:
    def __init__(self, vocab, dim):
        self.vocab, self.dim = vocab, dim

    def init(self, rng, x):
        return {"e": 0.3 * jax.random.normal(rng, (self.vocab, self.dim))}

    def apply(self, p, x):
        return p["e"][x]


class JUnembed(JEmbed):
    def apply(self, p, x):
        return x @ p["e"].T


class TLinear:
    """The port's twin of the JAX test layer (``init`` draws from a
    ``torch.Generator``)."""

    def __init__(self, out_dim, act=True):
        self.out_dim, self.act = out_dim, act

    def init(self, rng, x):
        return {"w": 0.3 * torch.randn(x.shape[-1], self.out_dim,
                                       generator=rng),
                "b": torch.zeros(self.out_dim)}

    def apply(self, p, x):
        y = x @ p["w"] + p["b"]
        return torch.tanh(y) if self.act else y


class TEmbed:
    def __init__(self, vocab, dim):
        self.vocab, self.dim = vocab, dim

    def init(self, rng, x):
        return {"e": 0.3 * torch.randn(self.vocab, self.dim, generator=rng)}

    def apply(self, p, x):
        return p["e"][x.long()]


class TUnembed(TEmbed):
    def apply(self, p, x):
        return x @ p["e"].t()


def jmse(out, y):
    return jnp.mean((out - y) ** 2)


def tmse(out, y):
    return torch.mean((out - y) ** 2)


def jce(logits, y):
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, y[..., None], axis=-1))


def tce(logits, y):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, y.long()[..., None]))


def _executors(specs, stages, loss, micro, opt, opt_params, seed, x0):
    """The JAX executor (initialized on ``x0``) and the port's, started from
    its params."""
    jmod = jpipe.PipelineModule([s[0] for s in specs], num_stages=stages,
                                partition_method="uniform")
    tmod = tpipe.PipelineModule([s[1] for s in specs], num_stages=stages,
                                partition_method="uniform")
    je = jpipe.PipelineEngine(jmod, loss[0], num_micro_batches=micro,
                              optimizer=opt, optimizer_params=opt_params,
                              seed=seed)
    je._lazy_init(jnp.asarray(x0))
    given = [[jax.tree.map(np.asarray, p) for p in sp] for sp in je.params]
    te = tpipe.PipelineEngine(tmod, loss[1], num_micro_batches=micro,
                              optimizer=opt, optimizer_params=opt_params,
                              seed=seed, params=given, device="cpu")
    return je, te


def _micro_iter(xs, ys, torch_side):
    if torch_side:
        return iter([(torch.as_tensor(np.asarray(x)),
                      torch.as_tensor(np.asarray(y))) for x, y in zip(xs, ys)])
    return iter(list(zip(xs, ys)))


def _params_close(te, je, rtol=1e-5, atol=1e-6):
    for sp_t, sp_j in zip(te.params, je.params):
        for pt, pj in zip(sp_t, sp_j):
            for k in pj:
                np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                           rtol=rtol, atol=atol)


def test_1f1b_matches_jax_executor_and_sequential_training():
    """3 SGD steps through the 4-stage 1F1B executor equal the same layers
    trained unpipelined, and the JAX executor's from the same params,
    in its first step."""
    specs = [(jpipe.LayerSpec(JLinear, 8), tpipe.LayerSpec(TLinear, 8)),
             (jpipe.LayerSpec(JLinear, 8), tpipe.LayerSpec(TLinear, 8)),
             (jpipe.LayerSpec(JLinear, 8), tpipe.LayerSpec(TLinear, 8)),
             (jpipe.LayerSpec(JLinear, 4, act=False),
              tpipe.LayerSpec(TLinear, 4, act=False))]
    rng = np.random.default_rng(0)
    data = [(rng.normal(size=(2, 8)).astype(np.float32),
             rng.normal(size=(2, 4)).astype(np.float32)) for _ in range(12)]
    je, te = _executors(specs, 4, (jmse, tmse), 4, "sgd", {"lr": 0.1}, 0,
                        data[0][0])
    start = [[dict(p) for p in sp] for sp in je.params]
    for step in range(3):
        xs, ys = zip(*data[step * 4:(step + 1) * 4])
        tl = te.train_batch(_micro_iter(xs, ys, True))
        if step < 1:        # the JAX executor's first step
            jl = je.train_batch(_micro_iter(xs, ys, False))
            np.testing.assert_allclose(tl, jl, rtol=1e-5)
            _params_close(te, je)
    # the unpipelined reference (the JAX test's, in torch): the same layers
    # from the same params, each micro-batch's gradient of 1/M of its loss
    # summed, SGD
    layers = [lyr for sl in te._stage_layers for lyr in sl]
    flat = [{k: torch.tensor(np.asarray(v)) for k, v in p.items()}
            for sp in start for p in sp]
    for step in range(3):
        leaves = [v.requires_grad_(True) for p in flat for v in p.values()]
        for x, y in data[step * 4:(step + 1) * 4]:
            h = torch.as_tensor(x)
            for layer, p in zip(layers, flat):
                h = layer.apply(p, h)
            (tmse(h, torch.as_tensor(y)) / 4).backward()
        with torch.no_grad():
            flat = [{k: v - 0.1 * v.grad for k, v in p.items()}
                    for p in flat]
        del leaves
    for pt, pr in zip([p for sp in te.params for p in sp], flat):
        for k in pr:
            np.testing.assert_allclose(pt[k].numpy(), pr[k].numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_tied_embedding_grads_reduced():
    """A tied embed/unembed over 3 stages: after a step both sites hold the
    same tensor, equal to the JAX executor's (the sum of both sites'
    gradients)."""
    V, H = 12, 6
    specs = [(jpipe.TiedLayerSpec("emb", JEmbed, V, H),
              tpipe.TiedLayerSpec("emb", TEmbed, V, H)),
             (jpipe.LayerSpec(JLinear, H), tpipe.LayerSpec(TLinear, H)),
             (jpipe.TiedLayerSpec("emb", JUnembed, V, H),
              tpipe.TiedLayerSpec("emb", TUnembed, V, H))]
    rng = np.random.default_rng(1)
    data = [(rng.integers(0, V, size=(3, 5)), rng.integers(0, V, size=(3, 5)))
            for _ in range(4)]
    je, te = _executors(specs, 3, (jce, tce), 2, "sgd", {"lr": 0.05}, 1,
                        data[0][0])
    xs, ys = zip(*data[:2])
    jl = je.train_batch(_micro_iter(xs, ys, False))
    tl = te.train_batch(_micro_iter(xs, ys, True))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert te.params[0][0]["e"] is te.params[2][0]["e"]
    _params_close(te, je)


def test_inference_schedule_matches_direct():
    specs = [(jpipe.LayerSpec(JLinear, 8), tpipe.LayerSpec(TLinear, 8)),
             (jpipe.LayerSpec(JLinear, 8), tpipe.LayerSpec(TLinear, 8)),
             (jpipe.LayerSpec(JLinear, 4, act=False),
              tpipe.LayerSpec(TLinear, 4, act=False))]
    x = np.random.default_rng(2).normal(size=(2, 8)).astype(np.float32)
    je, te = _executors(specs, 3, (jmse, tmse), 2, "sgd", None, 2, x)
    out = te.eval_batch(torch.as_tensor(x))
    direct = torch.as_tensor(x)
    for sid in range(3):
        direct = te._stage_apply(sid, te.params[sid], direct)
    np.testing.assert_allclose(out.numpy(), direct.numpy(), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(je.eval_batch(
        jnp.asarray(x))), rtol=1e-5, atol=1e-6)


def test_loss_decreases_over_steps():
    specs = [(jpipe.LayerSpec(JLinear, 16), tpipe.LayerSpec(TLinear, 16)),
             (jpipe.LayerSpec(JLinear, 4, act=False),
              tpipe.LayerSpec(TLinear, 4, act=False))]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    y = rng.normal(size=(4, 4)).astype(np.float32)
    je, te = _executors(specs, 2, (jmse, tmse), 2, "adam", {"lr": 1e-2}, 3,
                        x)
    tl = [te.train_batch(_micro_iter([x, x], [y, y], True))
          for _ in range(10)]
    # the JAX executor's first steps (the port's start from its params)
    jl = je.train_batch(_micro_iter([x, x], [y, y], False))
    np.testing.assert_allclose(tl[0], jl, rtol=1e-5)
    assert tl[-1] < tl[0]
