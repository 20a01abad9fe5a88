"""Port parity: the training path of ``deepspeed_tpu_torch``
(``initialize`` → ``train_batch``) against the JAX engine on the CPU.

``TINY_TEST`` on both sides. The JAX engine is built on a one-device mesh
(the port's engine is single-device), its starting params are read from
``engine.state.params`` and handed to the port through ``model_parameters``,
and both loaders draw the same batches from the same seed. Six
``train_batch`` calls: fp32 losses, grad norms and final params agree to
1e-5 (the same fp32 program through two BLAS libraries), the lr exactly as
floats; bf16 losses to 2e-2 (bf16 rounds at other places in the two
frameworks); under fp16 with a dynamic scale the ``loss_scale`` and
``skipped_steps`` sequences are equal step for step.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import topology as topo
from deepspeed_tpu.runtime.dataloader import \
    DeepSpeedTpuDataLoader as JaxLoader
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_to_numpy
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedTpuDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.engine import DeepSpeedTpuEngine
import torch_cpu  # noqa: F401  (one torch thread: see the module)

BASE = {
    "train_micro_batch_size_per_gpu": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                              "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 4,
                                                 "warmup_max_lr": 1e-3}},
    "steps_per_print": 1000,
}


def _data(n=16, T=33, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 256, (n, T)).astype(np.int32)}


def _engines(config, data=None):
    """(JAX engine on one device, port engine on the CPU) from the same
    starting params and the same data."""
    data = _data() if data is None else data
    topo.reset_topology()
    je, *_ = deepspeed_tpu.initialize(
        model=jtf.CausalLM(jtf.TINY_TEST), config=json.loads(json.dumps(config)),
        training_data=data,
        mesh=topo.MeshTopology.build(devices=jax.devices()[:1]))
    start = jax.tree.map(np.asarray, je.state.params)
    te, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(ttf.TINY_TEST), config=json.loads(json.dumps(config)),
        training_data=data, model_parameters=start, device="cpu")
    assert opt is te.optimizer and loader is te.training_dataloader
    assert sched is te.lr_scheduler
    return je, te


def _param_diff(je, te):
    pj = jax.tree.map(np.asarray, je.state.params)
    pt = params_to_numpy(te.state.params)
    assert jax.tree.structure(pj) == jax.tree.structure(pt)
    return max(float(np.abs(a - b).max())
               for a, b in zip(jax.tree.leaves(pj), jax.tree.leaves(pt)))


FP32_RUNS = {
    "gas1-clip": {"gradient_accumulation_steps": 1, "gradient_clipping": 1.0},
    "gas2-clip": {"gradient_accumulation_steps": 2, "gradient_clipping": 0.5},
    "gas2-noclip": {"gradient_accumulation_steps": 2},
    "gas2-prescale-lamb": {
        "gradient_accumulation_steps": 2, "prescale_gradients": True,
        "gradient_clipping": 1.0,
        "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}},
        "scheduler": {"type": "WarmupDecayLR", "params": {
            "total_num_steps": 8, "warmup_num_steps": 2,
            "warmup_max_lr": 1e-3}}},
}


@pytest.mark.parametrize("name", list(FP32_RUNS))
def test_fp32_trajectory_matches_jax_engine(name):
    je, te = _engines({**BASE, **FP32_RUNS[name]})
    assert te.train_batch_size() == je.train_batch_size()
    for step in range(6):
        jl, tl = je.train_batch(), te.train_batch()
        assert tl.dim() == 0 and not tl.requires_grad
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(te.get_global_grad_norm(),
                                   je.get_global_grad_norm(), atol=1e-5,
                                   rtol=1e-5)
        assert te.get_lr() == je.get_lr()
        assert te.lr_scheduler.get_lr() == je.lr_scheduler.get_lr()
    assert te.global_steps == je.global_steps == 6
    assert int(te.state.global_step) == int(je.state.global_step) == 6
    assert te.skipped_steps == je.skipped_steps == 0
    assert int(te.state.opt_state.step) == int(je.state.opt_state.step) == 6
    assert _param_diff(je, te) <= 1e-5
    # the accumulator is zeroed at the boundary
    assert all(float(g.abs().max()) == 0.0
               for g in jax.tree.leaves(te.state.grad_acc))


def test_bf16_trajectory_matches_jax_engine():
    je, te = _engines({**BASE, "gradient_accumulation_steps": 2,
                       "gradient_clipping": 1.0, "bf16": {"enabled": True}})
    assert te.module.cfg.dtype == torch.bfloat16
    for p in jax.tree.leaves(te.state.params):
        assert p.dtype == torch.float32         # fp32 master weights
    for step in range(6):
        np.testing.assert_allclose(float(te.train_batch()),
                                   float(je.train_batch()), atol=2e-2,
                                   rtol=2e-2)
    assert te.skipped_steps == 0 and te.loss_scale == 1.0


def test_fp16_dynamic_loss_scale_sequence_matches_jax_engine():
    """A small ``initial_scale_power`` headroom and a window of 2: the first
    steps overflow and halve the scale, later ones grow it again."""
    je, te = _engines({**BASE, "gradient_accumulation_steps": 1,
                       "gradient_clipping": 1.0,
                       "fp16": {"enabled": True, "initial_scale_power": 24,
                                "loss_scale_window": 2, "hysteresis": 1}})
    seq_j, seq_t = [], []
    for step in range(12):
        je.train_batch()
        te.train_batch()
        seq_j.append((je.loss_scale, je.skipped_steps,
                      int(je.state.global_step)))
        seq_t.append((te.loss_scale, te.skipped_steps,
                      int(te.state.global_step)))
    assert seq_t == seq_j
    scales = [s for s, _, _ in seq_t]
    assert any(b < a for a, b in zip(scales, scales[1:])), scales   # overflow
    assert any(b > a for a, b in zip(scales, scales[1:])), scales   # growth
    assert 0 < te.skipped_steps < 12
    # the host mirror counts boundaries, the device counter real steps
    assert te.global_steps == 12
    assert int(te.state.global_step) == 12 - te.skipped_steps
    assert te.get_lr() == je.get_lr()
    assert _param_diff(je, te) <= 1e-3


def test_fp16_hysteresis_and_static_scale():
    je, te = _engines({**BASE, "fp16": {"enabled": True,
                                        "initial_scale_power": 30,
                                        "hysteresis": 2}})
    seq = []
    for _ in range(4):
        je.train_batch()
        te.train_batch()
        assert te.loss_scale == je.loss_scale
        assert int(te.state.scale_state.hysteresis) == int(
            je.state.scale_state.hysteresis)
        seq.append(te.loss_scale)
    assert seq[0] == 2.0 ** 30 and seq[1] == 2.0 ** 29   # one free overflow
    _, static = _engines({**BASE, "fp16": {"enabled": True,
                                           "loss_scale": 128.0}})
    static.train_batch()
    assert static.loss_scale == 128.0 and not static.dynamic_loss_scale


def test_forward_backward_step_and_eval_batch():
    je, te = _engines({**BASE, "gradient_accumulation_steps": 2})
    batches = [{"input_ids": _data(2, 17, seed=s)["input_ids"]}
               for s in (1, 2)]
    before = params_to_numpy(te.state.params)
    loss = te(batches[0])
    np.testing.assert_allclose(float(loss), float(je(batches[0])), atol=1e-5)
    te.backward(loss)
    je.backward()
    assert not te.is_gradient_accumulation_boundary()
    assert te.step() is None                 # not at a boundary: nothing
    for a, b in zip(jax.tree.leaves(before),
                    jax.tree.leaves(params_to_numpy(te.state.params))):
        np.testing.assert_array_equal(a, b)
    te.backward(te.forward(batches[1]))
    je.backward(je.forward(batches[1]))
    assert te.is_gradient_accumulation_boundary()
    tm, jm = te.step(), je.step()
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               atol=1e-5, rtol=1e-5)
    assert not bool(tm["overflow"]) and float(tm["loss_scale"]) == 1.0
    assert _param_diff(je, te) <= 1e-5
    held_out = (_data(2, 17, seed=9)["input_ids"][:, :-1],
                _data(2, 17, seed=9)["input_ids"][:, 1:])
    np.testing.assert_allclose(float(te.eval_batch(held_out)),
                               float(je.eval_batch(held_out)), atol=1e-5)
    assert all(float(g.abs().max()) == 0.0      # eval leaves no gradient
               for g in jax.tree.leaves(te.state.grad_acc))
    # an explicit iterator instead of the engine's loader
    np.testing.assert_allclose(float(te.train_batch(iter(batches))),
                               float(je.train_batch(iter(batches))),
                               atol=1e-5)


def _port_engine(config, **kw):
    return deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(ttf.TINY_TEST), config=config, device="cpu",
        **kw)[0]


def test_default_init_is_seeded_and_model_parameters_are_copied():
    cfg = {"train_batch_size": 2, "seed": 7}
    a, b = _port_engine(dict(cfg)), _port_engine(dict(cfg))
    c = _port_engine({**cfg, "seed": 8})
    la, lb, lc = (jax.tree.leaves(params_to_numpy(e.state.params))
                  for e in (a, b, c))
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    assert any(not np.array_equal(x, y) for x, y in zip(la, lc))
    assert isinstance(a.optimizer, deepspeed_tpu_torch.ops.optimizers.FusedAdam)
    # a starting tree of tensors is copied, not adopted
    start = ttf.CausalLM(ttf.TINY_TEST).init(
        torch.Generator().manual_seed(1), device="cpu")
    d = _port_engine(dict(cfg), model_parameters=start)
    d.train_batch(iter([_data(2, 9)]))
    assert not torch.equal(d.state.params["embed"]["wte"],
                           start["embed"]["wte"])
    assert not start["embed"]["wte"].requires_grad


def test_initialize_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        deepspeed_tpu_torch.initialize(model=ttf.CausalLM(ttf.TINY_TEST),
                                       config={"train_batch_size": 2})


def test_check_numerics_names_the_poisoned_leaf():
    eng = _port_engine({"train_batch_size": 2, "check_numerics": True})
    with torch.no_grad():
        eng.state.params["final_norm"]["w"][0] = float("nan")
    with pytest.raises(FloatingPointError, match="final_norm.w"):
        eng.train_batch(iter([_data(2, 9)]))


# ------------------------------------------------------------------ config

BATCH_TRIPLES = [
    ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 4}, (8, 2, 4)),
    ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2}, (8, 2, 4)),
    ({"train_batch_size": 8, "gradient_accumulation_steps": 2}, (8, 4, 2)),
    ({"train_micro_batch_size_per_gpu": 3,
      "gradient_accumulation_steps": 2}, (6, 3, 2)),
    ({"train_micro_batch_size_per_gpu": 3}, (3, 3, 1)),
    ({"train_batch_size": 5}, (5, 5, 1)),
    ({"train_batch_size": "auto", "train_micro_batch_size_per_gpu": 4},
     (4, 4, 1)),
]


@pytest.mark.parametrize("given,want", BATCH_TRIPLES)
def test_batch_size_resolution_matches_jax(given, want):
    from deepspeed_tpu.runtime import config as jconfig

    tc, jc = tconfig.load_config(dict(given)), jconfig.load_config(dict(given))
    tc.resolve_batch_sizes(1)
    jc.resolve_batch_sizes(1)
    got = (tc.train_batch_size, tc.train_micro_batch_size_per_gpu,
           tc.gradient_accumulation_steps)
    assert got == want == (jc.train_batch_size,
                           jc.train_micro_batch_size_per_gpu,
                           jc.gradient_accumulation_steps)


@pytest.mark.parametrize("given", [
    {}, {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3,
         "gradient_accumulation_steps": 2},
    {"train_batch_size": 0}, {"gradient_accumulation_steps": 2}])
def test_batch_size_errors(given):
    with pytest.raises(tconfig.DeepSpeedConfigError):
        tconfig.load_config(dict(given)).resolve_batch_sizes(1)


def _leaf_items(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_config_defaults_equal_the_jax_package():
    """Every field the two configs share has the same default, the typed
    serving, telemetry and resilience blocks included; the mounted
    ``ResilienceConfig`` is compared field by field."""
    from deepspeed_tpu.runtime import config as jconfig

    jd = jconfig.DeepSpeedTpuConfig().model_dump(mode="json")
    td = tconfig.DeepSpeedTpuConfig().to_dict()
    assert set(td) == set(jd)
    assert dict(_leaf_items(td)) == dict(_leaf_items(jd))
    jr = jconfig.DeepSpeedTpuConfig().resilience
    tr = tconfig.DeepSpeedTpuConfig().resilience
    assert set(type(jr).model_fields) == set(tr.to_dict())
    for name in type(jr).model_fields:
        want, got = getattr(jr, name), getattr(tr, name)
        if name == "faults":
            want, got = want.model_dump(), got.to_dict()
        assert got == want, name


def test_config_unknown_keys_none_and_types(tmp_path):
    cfg = tconfig.load_config({
        "train_batch_size": 4, "some_future_key": {"a": 1},
        "gradient_clipping": None, "steps_per_print": None,
        "fp16": {"enabled": True, "hysteresis": None, "vendor_knob": 3},
        "optimizer": {"type": "Lion", "params": {"lr": 1e-4}},
        "zero_optimization": None})
    assert cfg.some_future_key == {"a": 1}             # kept, as extra="allow"
    assert cfg.fp16.vendor_knob == 3
    assert cfg.gradient_clipping == 0.0 and cfg.steps_per_print == 10
    assert cfg.fp16.hysteresis == 2 and cfg.zero_optimization.stage == 0
    assert cfg.optimizer.type == "Lion" and cfg.scheduler is None
    assert cfg.precision == tconfig.DtypeEnum.fp16
    assert "some_future_key" in cfg.model_fields_set
    assert cfg.to_dict()["fp16"]["vendor_knob"] == 3
    assert tconfig.load_config(cfg) is cfg
    assert tconfig.load_config(None).seed == 1234
    with pytest.raises(ValueError):
        tconfig.load_config({"fp16": {"enabled": "maybe"}})
    with pytest.raises(ValueError):
        tconfig.load_config({"steps_per_print": "often"})
    with pytest.raises(ValueError):
        cfg.seed = "x"                                  # validated on assignment
    with pytest.raises(tconfig.DeepSpeedConfigError):
        tconfig.load_config(3)
    legacy = tconfig.load_config({"zero_optimization": {"cpu_offload": True}})
    assert legacy.zero_optimization.offload_optimizer.device == \
        tconfig.OffloadDeviceEnum.cpu
    path = tmp_path / "ds.json"
    path.write_text('{"train_batch_size": 4, "bf16": {"enabled": true}}')
    assert tconfig.load_config(str(path)).bf16.enabled
    path.write_text('{"train_batch_size": 4, "train_batch_size": 8}')
    with pytest.raises(ValueError, match="Duplicate keys"):
        tconfig.load_config(str(path))


NOT_PORTED = {
    "onebit": ({"optimizer": {"type": "OneBitAdam", "params": {}}},
               "item 14"),
    "curriculum": ({"curriculum_learning": {"enabled": True}}, "item 17"),
    "compression": ({"compression_training": {"weight_quantization": {}}},
                    "item 17"),
    "elasticity": ({"elasticity": {"enabled": True}}, "item 17"),
    "monitor": ({"csv_monitor": {"enabled": True}}, "item 17"),
    "flops-profiler": ({"flops_profiler": {"enabled": True}}, "item 17"),
    "hybrid-engine": ({"hybrid_engine": {"enabled": True}}, "item 17"),
}

# blocks that raised naming item 14 before the distributed spine was
# ported: in a one-process world they now raise the JAX engine's own
# ValueError on a one-device mesh (the mesh case: the JAX topology's, no
# data axis can be inferred from one device)
RAISE_AS_JAX = {
    "mics": {"zero_optimization": {"mics_shard_size": 2}},
    "hpz": {"zero_optimization": {"zero_hpz_partition_size": 2}},
    "zeropp": {"zero_optimization": {"zero_quantized_weights": True}},
    "mesh": {"mesh": {"fsdp": 2}},
}


def _raises_as_jax(block):
    cfg = {"train_batch_size": 2, **block}
    with pytest.raises(ValueError) as te:
        _port_engine(json.loads(json.dumps(cfg)))
    topo.reset_topology()
    with pytest.raises(ValueError) as je:
        if "mesh" in block:
            topo.MeshTopology.build(
                deepspeed_tpu.runtime.config.MeshConfig(**block["mesh"]),
                devices=jax.devices()[:1])
        else:
            deepspeed_tpu.initialize(
                model=jtf.CausalLM(jtf.TINY_TEST), config=cfg,
                mesh=topo.MeshTopology.build(devices=jax.devices()[:1]))
    assert str(te.value) == str(je.value)


# blocks that parsed into a raise before the serving stack, the rest of
# telemetry and the training state were ported; they now parse into their
# typed blocks, equal to the JAX package's
PORTED_BLOCKS = {
    "telemetry": {"telemetry": {"enabled": True}},
    "serving": {"serving": {"prefix_cache": {"enabled": True}}},
    "activation-checkpointing": {"activation_checkpointing": {
        "partition_activations": True}},
    "resilience": {"resilience": {"enabled": True}},
}


# blocks that raised naming item 15 (and the ZeRO stage, item 14) before
# offload was ported: on one device they now build and train
NOW_RUN = {
    "zero-stage": {"zero_optimization": {"stage": 2}},
    # raised naming item 14 until the pipeline was ported (item 14e): the
    # JAX engine ignores pipeline.stages without a pipe axis
    "pipeline": {"pipeline": {"stages": 2}},
    "offload-optimizer": {"zero_optimization": {
        "offload_optimizer": {"device": "cpu"}}},
    "offload-param": {"zero_optimization": {
        "stage": 3, "offload_param": {"device": "nvme"}}},
}


def _now_runs(name, block, tmp_path):
    cfg = {**BASE, "train_batch_size": 2, **block}
    if name == "offload-param":
        cfg["zero_optimization"]["offload_param"]["nvme_path"] = str(tmp_path)
        model = ttf.CausalLM(dataclasses.replace(ttf.TINY_TEST,
                                                 tie_embeddings=False))
        eng, *rest = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                    device="cpu")
        from deepspeed_tpu_torch.runtime.zero_infinity import \
            ZeroInfinityEngine
        assert isinstance(eng, ZeroInfinityEngine) and rest == [None] * 3
        batch = {"input_ids": _data(2)["input_ids"]}
        losses = [eng.train_batch(dict(batch)) for _ in range(3)]
        eng.close()
        assert losses[-1] < losses[0]
    else:
        eng = _port_engine(cfg, training_data=_data())
        start = params_to_numpy(eng.state.params)
        losses = [float(eng.train_batch()) for _ in range(3)]
        assert not all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(start),
            jax.tree.leaves(params_to_numpy(eng.state.params))))
        if name in ("zero-stage", "pipeline"):
            # ZeRO stage 2 on one device shards nothing, and a pipeline
            # block without a pipe axis runs no pipeline: stage 0's bits
            ref = _port_engine({**BASE, "train_batch_size": 2},
                               training_data=_data())
            assert losses == [float(ref.train_batch()) for _ in range(3)]
            assert all(torch.equal(a, b) for a, b in zip(
                jax.tree.leaves(eng.state.params),
                jax.tree.leaves(ref.state.params)))
            assert eng.zero_optimization_stage() == (
                2 if name == "zero-stage" else 0)
        else:
            assert eng._offload_plan is not None
            assert eng._offload_plan.offloaded
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("name", list(RAISE_AS_JAX) + list(NOT_PORTED)
                         + list(PORTED_BLOCKS) + list(NOW_RUN))
def test_not_ported_block_raises(name, tmp_path):
    if name in RAISE_AS_JAX:
        _raises_as_jax(RAISE_AS_JAX[name])
        return
    if name in NOW_RUN:
        _now_runs(name, NOW_RUN[name], tmp_path)
        return
    if name in PORTED_BLOCKS:
        block = PORTED_BLOCKS[name]
        eng = _port_engine({"train_batch_size": 2, **block})
        ref = deepspeed_tpu.runtime.config.DeepSpeedTpuConfig(**block)
        key = next(iter(block))
        assert getattr(eng.config, key).to_dict() == \
            getattr(ref, key).model_dump()
        return
    block, item = NOT_PORTED[name]
    with pytest.raises(NotImplementedError, match=item):
        _port_engine({"train_batch_size": 2, **block})


def _timeless_spans(spans):
    return [{k: v for k, v in s.items() if k not in ("t_start", "t_end",
                                                      "tid")}
            for s in spans]


def test_telemetry_step_spans_match_jax_engine():
    """An enabled ``telemetry`` block records ``fwd_bwd`` spans a micro
    step and ``optimizer_step`` spans a global step on the ``"train"``
    trace, as the JAX engine does (names, ids, parents and attributes;
    times left out), and leaves the losses as they are untraced."""
    cfg = {**BASE, "gradient_accumulation_steps": 2,
           "gradient_clipping": 1.0, "telemetry": {"enabled": True}}
    je, te = _engines(cfg)
    plain = _engines({**BASE, "gradient_accumulation_steps": 2,
                      "gradient_clipping": 1.0})[1]
    assert te.tracer.enabled and not plain.tracer.enabled
    for _ in range(3):
        jl, tl, pl = je.train_batch(), te.train_batch(), plain.train_batch()
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5,
                                   rtol=1e-5)
        assert float(tl) == float(pl)
    spans = te.tracer.export()
    assert _timeless_spans(spans) == _timeless_spans(je.tracer.export())
    names = [s["name"] for s in spans]
    assert names.count("fwd_bwd") == 6 and names.count("optimizer_step") == 3
    assert {s["trace_id"] for s in spans} == {"train"}
    assert all(s["t_end"] >= s["t_start"] for s in spans)
    assert plain.tracer.export() == []


def test_not_ported_engine_surfaces_raise(tmp_path):
    model = ttf.CausalLM(ttf.TINY_TEST)
    with pytest.raises(NotImplementedError, match="item 14"):
        DeepSpeedTpuEngine(model=model, config={"train_batch_size": 2},
                           mesh=object(), device="cpu")
    # a model given by name builds through models.build_model
    eng_named, *_ = deepspeed_tpu_torch.initialize(
        model="tiny", device="cpu", config={"train_batch_size": 2})
    assert dataclasses.replace(eng_named.module.cfg,
                               dtype=ttf.TINY_TEST.dtype) == ttf.TINY_TEST
    loss = eng_named.train_batch(iter([{"input_ids": torch.zeros(
        (2, 5), dtype=torch.int64)}]))
    assert bool(torch.isfinite(loss))
    # MoE trains (tests/test_torch_moe.py), with a pipeline block too (it
    # raised naming item 14e until the pipeline was ported; pipelined MoE
    # over a pipe axis: tests/test_torch_pipeline.py); MoE under
    # ZeRO-Infinity streaming still raises, naming its item
    moe = ttf.CausalLM(dataclasses.replace(ttf.TINY_TEST, moe_num_experts=2))
    eng_moe, *_ = deepspeed_tpu_torch.initialize(
        model=moe, device="cpu", config={"train_batch_size": 2})
    loss = eng_moe.train_batch(iter([{"input_ids": torch.zeros(
        (2, 5), dtype=torch.int64)}]))
    assert bool(torch.isfinite(loss))
    eng_pipe, *_ = deepspeed_tpu_torch.initialize(
        model=moe, device="cpu", config={"train_batch_size": 2,
                                         "pipeline": {"stages": 2}})
    loss = eng_pipe.train_batch(iter([{"input_ids": torch.zeros(
        (2, 5), dtype=torch.int64)}]))
    assert bool(torch.isfinite(loss))
    with pytest.raises(NotImplementedError, match="MoE.*item 14d-ii"):
        deepspeed_tpu_torch.initialize(
            model=moe, device="cpu", config={
                "train_batch_size": 2, "zero_optimization": {
                    "stage": 3, "offload_param": {"device": "cpu"}}})
    eng = _port_engine({"train_batch_size": 2})
    # checkpoints are ported: a directory without 'latest' loads nothing,
    # and a save writes the tag and commits it
    assert eng.load_checkpoint(str(tmp_path)) == (None, {})
    assert eng.save_checkpoint(str(tmp_path)) == str(tmp_path / "global_step0")
    assert (tmp_path / "latest").read_text() == "global_step0"
    with pytest.raises(ValueError, match="training_data"):
        eng.train_batch()


# -------------------------------------------------------------- dataloader

@pytest.mark.parametrize("seed", [0, 1234])
def test_dataloader_order_matches_jax(seed):
    data = _data(23, 5, seed=3)
    jl = JaxLoader(data, 4, seed=seed)
    tl = DeepSpeedTpuDataLoader(data, 4, seed=seed)
    assert len(tl) == len(jl) == 5
    for epoch in range(2):                      # a new order each epoch
        for a, b in zip(jl, tl, strict=True):
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    assert tl.epoch == jl.epoch == 2
    keep = DeepSpeedTpuDataLoader(data, 4, seed=seed, shuffle=False,
                                  drop_last=False)
    sizes = [b["input_ids"].shape[0] for b in keep]
    assert sizes == [4, 4, 4, 4, 4, 3]


def test_dataloader_resumes_through_state_dict():
    data = _data(20, 5, seed=4)
    full = RepeatingLoader(DeepSpeedTpuDataLoader(data, 4, seed=5))
    stream = [next(full)["input_ids"] for _ in range(12)]
    first = RepeatingLoader(DeepSpeedTpuDataLoader(data, 4, seed=5))
    for _ in range(7):                          # into the second epoch
        next(first)
    sd = first.state_dict()
    assert sd["epoch"] == 1 and sd["batches_yielded"] == 2
    resumed = RepeatingLoader(DeepSpeedTpuDataLoader(data, 4, seed=5))
    resumed.load_state_dict(sd)
    for want in stream[7:]:
        np.testing.assert_array_equal(next(resumed)["input_ids"], want)
    other = DeepSpeedTpuDataLoader(data, 4, seed=6)
    with pytest.raises(ValueError, match="seed"):
        other.load_state_dict(sd)
    with pytest.raises(NotImplementedError):
        RepeatingLoader([1, 2]).state_dict()
    # tuple and array examples collate as the JAX loader's
    pairs = [(np.full(3, i), np.full(3, -i)) for i in range(8)]
    x, y = next(iter(DeepSpeedTpuDataLoader(pairs, 4, shuffle=False)))
    assert x.shape == y.shape == (4, 3) and (x == -y).all()


# ----------------------------------------------------------- import hygiene

def test_training_modules_import_no_jax_no_pydantic():
    code = (
        "import sys\n"
        "import deepspeed_tpu_torch.runtime.engine\n"
        "import deepspeed_tpu_torch.runtime.config\n"
        "import deepspeed_tpu_torch.runtime.lr_schedules\n"
        "import deepspeed_tpu_torch.runtime.dataloader\n"
        "import deepspeed_tpu_torch.ops.flash_attention\n"
        "import deepspeed_tpu_torch.ops.optimizers\n"
        "import deepspeed_tpu_torch.utils.timer\n"
        "import deepspeed_tpu_torch.runtime.checkpointing\n"
        "import deepspeed_tpu_torch.runtime.resilience\n"
        "import deepspeed_tpu_torch.runtime.activation_checkpointing\n"
        "import deepspeed_tpu_torch.utils.zero_to_fp32\n"
        "import deepspeed_tpu_torch.runtime.zero_offload\n"
        "import deepspeed_tpu_torch.runtime.zero_infinity\n"
        "import deepspeed_tpu_torch.ops.cpu_adam\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pydantic', 'deepspeed_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
