"""Port parity: ZeRO-Offload (``runtime/zero_offload.py`` and the engine's
offload branch) against the JAX package's offload engine, on the CPU.

``TINY_TEST`` on both sides; the JAX engine on a one-device mesh (see
``test_torch_train_engine.py``), the port's from the JAX engine's starting
params. Four runs cover ``ratio`` 1.0 and 0.5 against ``cpu`` and ``nvme``
moments, each once, with the accumulation steps, the optimizer and the
clipping varied across them. The offloaded and kept leaf lists are equal;
over 4 steps the losses, grad norms and final masters agree to 1e-5, the
fp32 tolerance of ``test_torch_train_engine.py``; the device params equal
the host masters bit for bit after each copy-back. Then an fp16 overflow
step, the host lr's source, and offload checkpoints across the packages
(and the JAX package's NVMe save, which writes no moments). The last test
holds the whole port and ``chip_smoke.py`` to importing neither ``jax``
nor ``deepspeed_tpu``.
"""

import ast
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import topology as topo
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.runtime import engine as tengine
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
import torch_cpu  # noqa: F401  (one torch thread: see the module)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)


def _config(ratio, device, nvme_path, gas=1, opt="AdamW", clip=0.0,
            **extra):
    return {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": gas,
        "gradient_clipping": clip,
        "optimizer": {"type": opt, "params": {"lr": 1e-3,
                                              "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_num_steps": 4, "warmup_max_lr": 1e-3}},
        "zero_optimization": {"stage": 2, "offload_optimizer": {
            "device": device, "ratio": ratio, "nvme_path": str(nvme_path)}},
        "steps_per_print": 1000, **extra}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (2, 33)).astype(np.int32)}
            for _ in range(n)]


def _jax_engine(config):
    topo.reset_topology()
    return deepspeed_tpu.initialize(
        model=jtf.CausalLM(jtf.TINY_TEST), config=json.loads(json.dumps(config)),
        mesh=topo.MeshTopology.build(devices=jax.devices()[:1]))[0]


def _port_engine(config, start=None):
    return deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(ttf.TINY_TEST), config=json.loads(json.dumps(config)),
        model_parameters=start, device="cpu")[0]


def _start(je):
    return jax.tree.map(np.asarray, je.state.params)


def _masters_equal_device(te):
    plan = te._offload_plan
    leaves = tree_leaves(te.state.params)
    return all(np.array_equal(leaves[i].detach().numpy(), plan.masters[i])
               for i in plan.offloaded)


def _train(engine, batches, gas):
    it = iter(batches)
    return [float(engine.train_batch(it)) for _ in range(len(batches) // gas)]


# (ratio, moments, gas, optimizer, clip): ratio x moments each once;
# gas, optimizer and clipping spread over them
GRID = {
    "r1-cpu": (1.0, "cpu", 1, "AdamW", 1.0),
    "r1-nvme": (1.0, "nvme", 2, "Adagrad", 0.0),
    "r05-cpu": (0.5, "cpu", 2, "Lion", 0.5),
    "r05-nvme": (0.5, "nvme", 1, "AdamW", 0.0),
}


@pytest.mark.parametrize("name", list(GRID))
def test_offload_matches_jax_offload_engine(name, tmp_path, monkeypatch):
    ratio, device, gas, opt, clip = GRID[name]
    if name == "r05-nvme":
        # pieces of 1000 elements: every leaf but the norms crosses several
        monkeypatch.setattr(tengine, "PIECE_ELEMS", 1000)
    je = _jax_engine(_config(ratio, device, tmp_path / "j", gas, opt, clip))
    start = _start(je)
    te = _port_engine(_config(ratio, device, tmp_path / "t", gas, opt, clip),
                      start)
    jp, tp = je._offload_plan, te._offload_plan
    assert tp.offloaded == jp.offloaded and tp.kept == jp.kept
    assert (len(tp.kept) > 0) == (ratio < 1.0)
    # the device optimizer's moments cover the kept leaves, keyed str(i)
    for tree in te.state.opt_state.moments.values():
        assert sorted(tree) == sorted(str(i) for i in tp.kept)
    batches = _batches(4 * gas)
    it_j, it_t = iter(batches), iter(batches)
    for _ in range(4):
        np.testing.assert_allclose(float(te.train_batch(it_t)),
                                   float(je.train_batch(it_j)), **TOL)
        np.testing.assert_allclose(te.get_global_grad_norm(),
                                   je.get_global_grad_norm(), **TOL)
        assert te.get_lr() == je.get_lr()
        assert _masters_equal_device(te)
    assert int(te.state.opt_state.step) == int(je.state.opt_state.step) == 4
    for i in jp.offloaded:
        np.testing.assert_allclose(tp.masters[i], jp.masters[i], **TOL)
    jl = jax.tree.leaves(jax.tree.map(np.asarray, je.state.params))
    for i in jp.kept:
        np.testing.assert_allclose(tree_leaves(te.state.params)[i].detach(),
                                   jl[i], **TOL)
    assert all(float(g.abs().max()) == 0.0
               for g in tree_leaves(te.state.grad_acc))
    if device == "nvme":
        assert any(f.endswith(".swp") for f in os.listdir(tmp_path / "t"))
    if name == "r1-nvme":
        # the JAX package writes no moments under NVMe, so a fresh port
        # engine resumes its masters and restarts Adam's moments
        je.save_checkpoint(str(tmp_path / "ckpt"))
        files = os.listdir(tmp_path / "ckpt" / "global_step4" / "offload")
        assert files and not [f for f in files if f.startswith("state_")]
        fresh = _port_engine(_config(ratio, device, tmp_path / "f", gas, opt,
                                     clip))
        fresh.load_checkpoint(str(tmp_path / "ckpt"))
        for i in jp.offloaded:
            np.testing.assert_array_equal(fresh._offload_plan.masters[i],
                                          jp.masters[i])
            assert all((v == 0).all() for v in
                       fresh._offload_plan.leaf_state(i).values())
        assert _masters_equal_device(fresh)
        fresh.close()
    if name == "r05-nvme":
        # pieces of any size give the same bits (no clipping here)
        monkeypatch.undo()
        whole = _port_engine(_config(ratio, device, tmp_path / "w", gas,
                                     opt, clip), start)
        _train(whole, batches, gas)
        for i in tp.offloaded:
            np.testing.assert_array_equal(whole._offload_plan.masters[i],
                                          tp.masters[i])
    te.close()


def test_overflow_skips_host_step_and_host_lr_follows_device_counter(
        tmp_path):
    """fp16 with a scale of 2^24: the first steps overflow. The masters
    stay as they were on those steps, and the host lr of each applied
    step is the schedule at the device counter (which skipped steps do not
    advance), as in the JAX engine; the host mirror would give another."""
    cfg = _config(0.5, "cpu", tmp_path, clip=1.0, fp16={
        "enabled": True, "initial_scale_power": 24, "loss_scale_window": 2,
        "hysteresis": 1})
    je = _jax_engine(cfg)
    te = _port_engine(cfg, _start(je))
    seen = {"jax": [], "port": []}
    j_update = je._offload_plan.host_update_leaf
    t_update = te._offload_plan.update_piece

    def j_spy(i, g, lr):
        seen["jax"].append(lr)
        return j_update(i, g, lr)

    def t_spy(i, state, lo, g, lr):
        seen["port"].append(lr)
        return t_update(i, state, lo, g, lr)

    je._offload_plan.host_update_leaf = j_spy
    te._offload_plan.update_piece = t_spy
    plan = te._offload_plan
    batches = _batches(6)
    skipped, applied_lrs = 0, []
    for step in range(6):
        before = {i: plan.masters[i].copy() for i in plan.offloaded}
        device_step = int(te.state.global_step)
        n_seen = len(seen["port"])
        je.train_batch(iter(batches[step:step + 1]))
        te.train_batch(iter(batches[step:step + 1]))
        assert (te.loss_scale, te.skipped_steps) == (je.loss_scale,
                                                     je.skipped_steps)
        if te.skipped_steps > skipped:          # an overflow step
            skipped = te.skipped_steps
            assert len(seen["port"]) == n_seen
            assert all(np.array_equal(before[i], plan.masters[i])
                       for i in plan.offloaded)
        else:
            lr = float(te.schedule(device_step))
            assert set(seen["port"][n_seen:]) == {lr}
            applied_lrs.append((lr, float(te.schedule(te.global_steps - 1))))
        assert _masters_equal_device(te)
    assert skipped >= 1
    assert sorted(set(seen["port"])) == sorted(set(seen["jax"]))
    # after an overflow the device counter lags the host mirror
    assert any(dev != mirror for dev, mirror in applied_lrs)


def _moments(plan):
    """Copies of each offloaded leaf's host moments (a JAX plan here keeps
    them in host RAM)."""
    state = getattr(plan, "leaf_state", plan.states.__getitem__)
    return {i: {k: np.array(v, copy=True) for k, v in state(i).items()}
            for i in plan.offloaded}


RESUMES = {
    # writer package and moments -> reader package and moments
    "jax-cpu-to-port-cpu": ("jax", "cpu", "port", "cpu"),
    # the JAX loader reads moments the port wrote under NVMe (the JAX
    # package's own NVMe save writes none: test_offload_matches_jax_offload_
    # engine[r1-nvme])
    "port-nvme-to-jax-cpu": ("port", "nvme", "jax", "cpu"),
}


@pytest.mark.parametrize("name", list(RESUMES))
def test_offload_checkpoint_resumes_across_packages(name, tmp_path):
    w_pkg, w_dev, r_pkg, r_dev = RESUMES[name]
    make = {"jax": _jax_engine, "port": _port_engine}
    writer = make[w_pkg](_config(0.5, w_dev, tmp_path / "w"))
    batches = _batches(4)
    _train(writer, batches[:2], 1)
    writer.save_checkpoint(str(tmp_path / "ckpt"))
    files = os.listdir(tmp_path / "ckpt" / "global_step2" / "offload")
    assert any(f.startswith("state_") for f in files)
    reader = make[r_pkg](_config(0.5, r_dev, tmp_path / "r"))
    reader.load_checkpoint(str(tmp_path / "ckpt"))
    wp, rp = writer._offload_plan, reader._offload_plan
    assert rp.offloaded == wp.offloaded
    for i in wp.offloaded:
        np.testing.assert_array_equal(rp.masters[i], wp.masters[i])
    wm, rm = _moments(wp), _moments(rp)
    for i in wp.offloaded:
        for k in wm[i]:
            np.testing.assert_array_equal(rm[i][k], wm[i][k])
    for a, b in zip(_train(writer, batches[2:], 1),
                    _train(reader, batches[2:], 1)):
        np.testing.assert_allclose(b, a, **TOL)
    for i in wp.offloaded:
        np.testing.assert_allclose(rp.masters[i], wp.masters[i], **TOL)


def test_port_and_smoke_import_neither_jax_nor_the_jax_package():
    """No module of the port and not ``chip_smoke.py`` names ``jax`` or
    ``deepspeed_tpu`` in an import (``test_torch_train_engine.py``'s
    subprocess imports them, the smoke too, and finds neither loaded)."""
    files = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [f"{f.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu")]
    assert not bad, bad
