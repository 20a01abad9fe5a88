"""Port parity: ZeRO stages 0-3, MiCS, hpZ, ZeRO++ and sharded
checkpoints of ``deepspeed_tpu_torch`` over 4 gloo ranks, against the JAX
engine on a mesh of four CPU devices.

One module-scoped 4-rank world (``torch_ranks.RankPool``). Each case writes
the JAX engine's starting params and the global batches as ``.npz``/
``.npy`` files; every rank builds the port engine from them
(``model_parameters``) on the same mesh and trains on its own rows of each
global micro batch (the rows JAX's batch sharding gives device r). Then:

- losses agree to 1e-5 relative (fp32 on both sides, the sums in another
  order: 1e-7 seen); moment blocks to 1e-6 (m) and 1e-9 (v) absolute, a
  hundredth of their largest values' last-bit noise times ten; param
  blocks to 1e-4 absolute: Adam divides by sqrt(v), so an element whose
  gradient nearly cancels across ranks moves by a few hundredths of a step
  (lr 2e-3) when its sum rounds another way (6e-5 seen);
- qwZ alone gathers the same int8 codes as the JAX engine and keeps those
  tolerances. Under qgZ the JAX engine quantizes the gradient after XLA
  has summed it (the custom_vjp's cotangent is the replicated total),
  where the port quantizes each rank's partial before the all-to-all, as
  the reference's all_to_all_quant_reduce does; the two reduced gradients
  differ by up to one int8 step of a block (0.6% of its largest value), so
  that case holds losses to 5e-4 relative, moments to 1e-3 (m) and 1e-6
  (v) and params to 1e-2 absolute (five Adam steps of lr);
- at stage 3 each sharded leaf is gathered once a forward and once more
  for the backward (a gathered weight is freed after its use);
- a stage-3 save by 4 port ranks writes the JAX engine's file set on that
  mesh, gathers nothing, and resumes in the JAX engine on another mesh
  (fsdp 2 → 4), as a JAX save resumes in the port on it, on the writer's
  curve (1e-5); ``zero_to_fp32`` of both packages reads the port's shards
  alike;
- over ``tensor`` x ``fsdp`` (stages 0, 2 and 3) the moments are held to
  1e-5 (m) and 1e-8 (v): the JAX package's own tensor-parallel and
  unsharded engines differ by 4.0e-6 and 4.3e-9 on the same data (``TOL``);
  a (fsdp 2, tensor 2) save resumes on pure data parallelism in the other
  package on the writer's curve, the twin of
  ``tests/test_checkpoint_sharded.py:261``;
- MoE over ``data`` x ``expert`` (4 experts, 2 a rank) keeps the fp32
  tolerances: top-1 at capacity factor 0.5, where tokens drop (so each
  rank's capacity and queue positions must be the global batch's), and
  dropless; a (data 2, expert 2) save resumes on pure data parallelism in
  the other package on the writer's curve, and ``zero_to_fp32`` of both
  packages merges its expert shards alike.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.utils import zero_to_fp32 as jz2f
from deepspeed_tpu_torch.utils import zero_to_fp32 as tz2f

import torch_rank_cases as cases
from torch_ranks import RankPool
import torch_cpu  # noqa: F401  (one torch thread: see the module)

STEPS = 3
T = 17
BASE = {"train_micro_batch_size_per_gpu": 1,
        "optimizer": {"type": "AdamW", "params": {"lr": 2e-3,
                                                  "weight_decay": 0.01}},
        "steps_per_print": 1000}


MOE = {"top1-drop": {"moe_num_experts": 4, "moe_top_k": 1,
                     "moe_capacity_factor": 0.5},
       "dropless": {"moe_num_experts": 4, "moe_dropless": True}}


def _cfg(stage, gas=1, clip=0.0, **zero):
    return {**BASE, "gradient_accumulation_steps": gas,
            "gradient_clipping": clip,
            "zero_optimization": {"stage": stage, **zero}}


# name: (config, (data, fsdp[, tensor]), port mesh: the dict given to
# initialize, or None for the engine's own mesh)
CASES = {
    "s0-2x2": (_cfg(0), (2, 2), {"data": 2, "fsdp": 2}),
    "s1-2x2-gas2-clip": (_cfg(1, gas=2, clip=0.05), (2, 2),
                         {"data": 2, "fsdp": 2}),
    "s2-2x2": (_cfg(2), (2, 2), {"data": 2, "fsdp": 2}),
    "s3-2x2-gas2": (_cfg(3, gas=2), (2, 2), {"data": 2, "fsdp": 2}),
    "s3-1x4-clip": (_cfg(3, clip=0.05), (1, 4), {"data": 1, "fsdp": 4}),
    "mics-k2": (_cfg(3, mics_shard_size=2), (2, 2), None),
    "hpz-2": (_cfg(3, zero_hpz_partition_size=2), (2, 2),
              {"data": 2, "fsdp": 2}),
    "qwz": (_cfg(3, zero_quantized_weights=True), (2, 2),
            {"data": 2, "fsdp": 2}),
    "qwz-qgz": (_cfg(3, zero_quantized_weights=True,
                     zero_quantized_gradients=True), (1, 4),
                {"data": 1, "fsdp": 4}),
    # tensor parallelism over fsdp: the stage-2 reduce-scatter and the
    # stage-3 gather run over fsdp and leave the tensor blocks in place
    "s0-f2t2": (_cfg(0), (1, 2, 2), {"fsdp": 2, "tensor": 2}),
    "s2-f2t2-clip": (_cfg(2, clip=0.05), (1, 2, 2),
                     {"fsdp": 2, "tensor": 2}),
    "s3-f2t2-gas2": (_cfg(3, gas=2), (1, 2, 2), {"fsdp": 2, "tensor": 2}),
    # MoE over data x expert (4 experts, 2 a rank): top-1 at capacity
    # factor 0.5, where tokens drop and the routing statistics must be the
    # global batch's, and dropless
    "moe-d2e2-top1-drop-s2": (
        dict(_cfg(2, clip=0.05), _moe=MOE["top1-drop"]), (2, 1, 1, 2),
        {"data": 2, "expert": 2}),
    "moe-d2e2-dropless-s1-gas2": (
        dict(_cfg(1, gas=2), _moe=MOE["dropless"]), (2, 1, 1, 2),
        {"data": 2, "expert": 2}),
}


@pytest.fixture(scope="module")
def pool():
    with RankPool(4) as p:
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


def _jax_engine(cfg, data, fsdp, tensor=1, expert=1):
    jtopo.reset_topology()
    mesh = jtopo.MeshTopology.build(
        devices=jax.devices()[:data * fsdp * tensor * expert], data=data,
        fsdp=fsdp, tensor=tensor, expert=expert)
    cfg = json.loads(json.dumps(cfg))
    model = jtf.CausalLM(dataclasses.replace(jtf.TINY_TEST,
                                             **cfg.pop("_moe", {})))
    je, *_ = deepspeed_tpu.initialize(model=model, config=cfg, mesh=mesh)
    return je


def _inputs(tmp, je, cfg, dp, seed=0):
    """The JAX engine's starting params and the global micro batches, as
    files the ranks read."""
    params = os.path.join(tmp, "params.npz")
    np.savez(params, **_flat(jax.tree.map(np.asarray, je.state.params)))
    gas = cfg["gradient_accumulation_steps"]
    batches = np.random.default_rng(seed).integers(
        0, jtf.TINY_TEST.vocab_size, (STEPS * gas, dp, T)).astype(np.int32)
    path = os.path.join(tmp, "batches.npy")
    np.save(path, batches)
    return params, path, batches


def _jax_train(je, batches, gas, steps, first=0):
    out = []
    for s in range(first, first + steps):
        it = iter({"input_ids": batches[s * gas + i]} for i in range(gas))
        out.append(float(je.train_batch(it)))
    return out


def _shards(tree):
    """{dotted key: {device id: shard}} of a tree of jax Arrays."""
    return {k: {s.device.id: np.asarray(s.data)
                for s in v.addressable_shards}
            for k, v in _flat(tree).items()}


TOL = {"fp32": {"loss": 1e-5, "params": 1e-4, "m": 1e-6, "v": 1e-9},
       "qgz": {"loss": 5e-4, "params": 1e-2, "m": 1e-3, "v": 1e-6},
       # over tensor x fsdp: the JAX package's own tensor-parallel engine
       # and its unsharded one differ by 4.0e-6 (m) and 4.3e-9 (v) on the
       # same data (Adam's normalized step turns the row-parallel sums'
       # other order into param differences, which the next gradients
       # read); the port is held to its TP engine within 2.4e-6 and 2.5e-9
       "tp": {"loss": 1e-5, "params": 1e-4, "m": 1e-5, "v": 1e-8}}


def _check_blocks(je, res, tol):
    jp = _shards(je.state.params)
    jm = {f"{mk}.{k}": v for mk, tree in je.state.opt_state.moments.items()
          for k, v in _shards(tree).items()}
    for r, out in enumerate(res):
        assert set(out["params"]) == set(jp)
        for key, blk in out["params"].items():
            np.testing.assert_allclose(blk, jp[key][r], rtol=0,
                                       atol=tol["params"],
                                       err_msg=f"rank {r} param {key}")
        assert set(out["moments"]) == set(jm)
        for key, blk in out["moments"].items():
            np.testing.assert_allclose(blk, jm[key][r], rtol=0,
                                       atol=tol[key.split(".")[0]],
                                       err_msg=f"rank {r} moment {key}")


def _check_gathers(res, cfg):
    """Every micro step gathers each sharded leaf once in the forward and
    once more in the backward (the re-gather of a freed weight): TINY_TEST
    shards all 9 leaves of each of its 2 layers and 2 of its global leaves
    (``wte`` and the final norm). On the card each gather of a quantized
    run is one quantize and one dequantize launch (``chip_smoke.py``)."""
    micro = STEPS * cfg["gradient_accumulation_steps"]
    for out in res:
        assert out["gathers"] == [(9 * 2 * micro, 9 * 2 * micro),
                                  (2 * micro, 2 * micro)]


@pytest.mark.parametrize("name", list(CASES))
def test_stage_matches_jax_engine(name, pool, tmp_path):
    cfg, dims, mesh = CASES[name]
    je = _jax_engine(cfg, *dims)
    params, bpath, batches = _inputs(str(tmp_path), je, cfg,
                                     dims[0] * dims[1])
    if "_moe" in cfg:
        assert je.state.params["layers"]["w_in"].sharding.spec[1] == "expert"
    res = pool.run(cases.zero_run, json.dumps(cfg), mesh, params, bpath,
                   STEPS)
    jl = _jax_train(je, batches, cfg["gradient_accumulation_steps"], STEPS)
    tol = TOL["qgz" if "qgz" in name else "tp" if "t2" in name
              else "fp32"]
    for out in res:
        np.testing.assert_allclose(out["losses"], jl, rtol=tol["loss"])
    _check_blocks(je, res, tol)
    stage = cfg["zero_optimization"]["stage"]
    if stage == 3:
        _check_gathers(res, cfg)
    else:
        assert all(out["gathers"] == [] for out in res)


@pytest.fixture(scope="module")
def saved(pool, tmp_path_factory):
    """Stage 3 on (2, 2): the port ranks and the JAX engine each train 2
    steps, save, and train a third."""
    tmp = str(tmp_path_factory.mktemp("zero_ckpt"))
    cfg, (data, fsdp), mesh = _cfg(3), (2, 2), {"data": 2, "fsdp": 2}
    je = _jax_engine(cfg, data, fsdp)
    params, bpath, batches = _inputs(tmp, je, cfg, 4, seed=5)
    port_dir, jax_dir = os.path.join(tmp, "port"), os.path.join(tmp, "jax")
    res = pool.run(cases.zero_run, json.dumps(cfg), mesh, params, bpath,
                   STEPS, save_dir=port_dir, save_after=2)
    jl = _jax_train(je, batches, 1, 2)
    je.save_checkpoint(jax_dir, tag="ckpt")
    jl += _jax_train(je, batches, 1, 1, first=2)
    return {"cfg": cfg, "params": params, "bpath": bpath, "batches": batches,
            "res": res, "jax_losses": jl, "port_dir": port_dir,
            "jax_dir": jax_dir}


def test_shard_files_match_jax_engine(saved):
    for sub in ("params", "opt"):
        port = sorted(os.listdir(os.path.join(saved["port_dir"], "ckpt",
                                              sub)))
        jax_ = sorted(os.listdir(os.path.join(saved["jax_dir"], "ckpt",
                                              sub)))
        assert port == jax_ and any(".shard_" in f for f in port)
        for f in port:
            a = np.load(os.path.join(saved["port_dir"], "ckpt", sub, f))
            b = np.load(os.path.join(saved["jax_dir"], "ckpt", sub, f))
            assert a.shape == b.shape
            tol = TOL["fp32"]["params" if sub == "params" else f[0]]
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f)
    pm = json.load(open(os.path.join(saved["port_dir"], "ckpt",
                                     "manifest.json")))
    jm = json.load(open(os.path.join(saved["jax_dir"], "ckpt",
                                     "manifest.json")))
    for key in ("params_index", "opt_index", "global_step", "opt_step"):
        assert pm[key] == jm[key]
    assert open(os.path.join(saved["port_dir"], "latest")).read() == "ckpt"
    for out in saved["res"]:
        np.testing.assert_allclose(out["losses"], saved["jax_losses"],
                                   rtol=1e-5)


def test_save_never_gathers_a_leaf(saved):
    assert [out["save_gathers"] for out in saved["res"]] == [0] * 4
    # a sharded leaf's files are blocks: each holds half of the leaf
    wq = [f for f in saved["res"][0]["files"] if f.startswith("layers.wq.")]
    assert len(wq) == 2
    blocks = [np.load(os.path.join(saved["port_dir"], "ckpt", "params", f))
              for f in wq]
    assert [b.shape for b in blocks] == [(2, 32, 64)] * 2


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_resume_across_packages_and_meshes(direction, saved, pool):
    """A stage-3 checkpoint written on (data 2, fsdp 2) resumes on
    (data 1, fsdp 4) in the other package; its third step's loss is the
    writer's unbroken run's."""
    cfg = saved["cfg"]
    if direction == "jax-to-port":
        res = pool.run(cases.zero_run, json.dumps(cfg),
                       {"data": 1, "fsdp": 4}, saved["params"],
                       saved["bpath"], 1, load_dir=saved["jax_dir"],
                       first=2)
        got = [out["losses"][0] for out in res]
        want = saved["jax_losses"][2]
    else:
        je = _jax_engine(cfg, 1, 4)
        je.load_checkpoint(saved["port_dir"])
        got = _jax_train(je, saved["batches"], 1, 1, first=2)
        want = saved["res"][0]["losses"][2]
    np.testing.assert_allclose(got, [want] * len(got), rtol=1e-5)


def test_zero_to_fp32_reads_port_shards(saved):
    port = tz2f.get_fp32_state_dict_from_zero_checkpoint(saved["port_dir"])
    jax_ = jz2f.get_fp32_state_dict_from_zero_checkpoint(saved["port_dir"])
    own = jz2f.get_fp32_state_dict_from_zero_checkpoint(saved["jax_dir"])
    assert set(port) == set(jax_) == set(own)
    for k in port:
        np.testing.assert_array_equal(port[k], jax_[k])
        np.testing.assert_allclose(port[k], own[k], rtol=0,
                                   atol=TOL["fp32"]["params"])


def test_mesh_refusals_name_item_14(pool):
    """On a mesh the port still refuses ZeRO-Offload (per-rank host shards,
    14c) and LAMB over sharded moments, naming item 14."""
    for out in pool.run(cases.refusals):
        assert "item 14" in out["offload"] and "Offload" in out["offload"]
        assert "item 14" in out["lamb"] and "LAMB" in out["lamb"]


@pytest.fixture(scope="module")
def saved_tp(pool, tmp_path_factory):
    """Stage 3 on (fsdp 2, tensor 2), 2 rows a rank (4 a global micro
    batch): the port ranks and the JAX engine each train 2 steps, save,
    and train a third."""
    tmp = str(tmp_path_factory.mktemp("zero_tp_ckpt"))
    cfg = dict(_cfg(3), train_micro_batch_size_per_gpu=2)
    je = _jax_engine(cfg, 1, 2, tensor=2)
    params, bpath, batches = _inputs(tmp, je, cfg, 4, seed=6)
    port_dir, jax_dir = os.path.join(tmp, "port"), os.path.join(tmp, "jax")
    res = pool.run(cases.zero_run, json.dumps(cfg),
                   {"fsdp": 2, "tensor": 2}, params, bpath, STEPS,
                   save_dir=port_dir, save_after=2)
    jl = _jax_train(je, batches, 1, 2)
    je.save_checkpoint(jax_dir, tag="ckpt")
    jl += _jax_train(je, batches, 1, 1, first=2)
    return {"params": params, "bpath": bpath, "batches": batches,
            "res": res, "jax_losses": jl, "port_dir": port_dir,
            "jax_dir": jax_dir}


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_tensor_sharded_resume_on_pure_dp(direction, saved_tp, pool):
    """A checkpoint written on (fsdp 2, tensor 2) resumes on pure data
    parallelism (data 4, 1 row a rank: the same 4-row global batch) in the
    other package, on the writer's curve (1e-5): the twin of
    ``tests/test_checkpoint_sharded.py:261``. The port's shard files are
    the JAX engine's, and ``zero_to_fp32`` of both packages merges the
    tensor blocks alike."""
    cfg = _cfg(3)
    res = saved_tp["res"]
    for out in res:
        np.testing.assert_allclose(out["losses"], saved_tp["jax_losses"],
                                   rtol=1e-5)
    if direction == "jax-to-port":
        got = [out["losses"][0] for out in pool.run(
            cases.zero_run, json.dumps(cfg), {"data": 4}, saved_tp["params"],
            saved_tp["bpath"], 1, load_dir=saved_tp["jax_dir"], first=2)]
        want = saved_tp["jax_losses"][2]
    else:
        je = _jax_engine(cfg, 4, 1)
        je.load_checkpoint(saved_tp["port_dir"])
        got = _jax_train(je, saved_tp["batches"], 1, 1, first=2)
        want = res[0]["losses"][2]
        files = sorted(os.listdir(os.path.join(saved_tp["port_dir"], "ckpt",
                                               "params")))
        assert files == sorted(os.listdir(os.path.join(
            saved_tp["jax_dir"], "ckpt", "params")))
        port = tz2f.get_fp32_state_dict_from_zero_checkpoint(
            saved_tp["port_dir"])
        jax_ = jz2f.get_fp32_state_dict_from_zero_checkpoint(
            saved_tp["port_dir"])
        own = jz2f.get_fp32_state_dict_from_zero_checkpoint(
            saved_tp["jax_dir"])
        for k in own:
            np.testing.assert_array_equal(port[k], jax_[k])
            np.testing.assert_allclose(port[k], own[k], rtol=0,
                                       atol=TOL["fp32"]["params"])
    np.testing.assert_allclose(got, [want] * len(got), rtol=1e-5)


@pytest.fixture(scope="module")
def saved_moe(pool, tmp_path_factory):
    """Top-1 MoE at capacity factor 0.5 on (data 2, expert 2), ZeRO-2, 2
    rows a rank (4 a global micro batch): the port ranks and the JAX engine
    each train 2 steps, save, and train a third."""
    tmp = str(tmp_path_factory.mktemp("zero_moe_ckpt"))
    cfg = dict(_cfg(2), train_micro_batch_size_per_gpu=2,
               _moe=MOE["top1-drop"])
    je = _jax_engine(cfg, 2, 1, expert=2)
    params, bpath, batches = _inputs(tmp, je, cfg, 4, seed=7)
    port_dir, jax_dir = os.path.join(tmp, "port"), os.path.join(tmp, "jax")
    res = pool.run(cases.zero_run, json.dumps(cfg), {"data": 2, "expert": 2},
                   params, bpath, STEPS, save_dir=port_dir, save_after=2)
    jl = _jax_train(je, batches, 1, 2)
    je.save_checkpoint(jax_dir, tag="ckpt")
    jl += _jax_train(je, batches, 1, 1, first=2)
    return {"params": params, "bpath": bpath, "batches": batches,
            "res": res, "jax_losses": jl, "port_dir": port_dir,
            "jax_dir": jax_dir}


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_expert_sharded_resume_on_pure_dp(direction, saved_moe, pool):
    """A checkpoint written on (data 2, expert 2) resumes on pure data
    parallelism (data 4, 1 row a rank: the same global batch, routed over
    the same global statistics) in the other package, on the writer's
    curve (1e-5). The expert leaves are saved as the JAX engine's shard
    files, and ``zero_to_fp32`` of both packages merges them alike."""
    cfg = dict(_cfg(2), _moe=MOE["top1-drop"])
    res = saved_moe["res"]
    for out in res:
        np.testing.assert_allclose(out["losses"], saved_moe["jax_losses"],
                                   rtol=1e-5)
    files = sorted(os.listdir(os.path.join(saved_moe["port_dir"], "ckpt",
                                           "params")))
    assert files == sorted(os.listdir(os.path.join(
        saved_moe["jax_dir"], "ckpt", "params")))
    assert "layers.w_in.shard_0-2-0-0.npy" in files
    if direction == "jax-to-port":
        got = [out["losses"][0] for out in pool.run(
            cases.zero_run, json.dumps(cfg), {"data": 4},
            saved_moe["params"], saved_moe["bpath"], 1,
            load_dir=saved_moe["jax_dir"], first=2)]
        want = saved_moe["jax_losses"][2]
    else:
        je = _jax_engine(cfg, 4, 1)
        je.load_checkpoint(saved_moe["port_dir"])
        got = _jax_train(je, saved_moe["batches"], 1, 1, first=2)
        want = res[0]["losses"][2]
        port = tz2f.get_fp32_state_dict_from_zero_checkpoint(
            saved_moe["port_dir"])
        jax_ = jz2f.get_fp32_state_dict_from_zero_checkpoint(
            saved_moe["port_dir"])
        own = jz2f.get_fp32_state_dict_from_zero_checkpoint(
            saved_moe["jax_dir"])
        assert port["layers.w_in"].shape == (2, 4, 64, 128)
        for k in own:
            np.testing.assert_array_equal(port[k], jax_[k])
            np.testing.assert_allclose(port[k], own[k], rtol=0,
                                       atol=TOL["fp32"]["params"])
    np.testing.assert_allclose(got, [want] * len(got), rtol=1e-5)
