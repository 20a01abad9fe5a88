"""Port parity: ZeRO-Infinity parameter streaming
(``runtime/zero_infinity.py``) against the JAX package's streaming engine,
on the CPU.

``TINY_TEST`` at 5 layers, untied, in uneven layer groups (2 + 2 + 1 and
3 + 2). The initial store is drawn with numpy from the config seed on both
sides, so it must be bit-identical, key for key. Over a few steps (one of
them through an iterator with 2 accumulation steps, on NVMe files) the
streamed losses agree to 1e-5, the store's counters (reads, writes, bytes
read) are equal, and so are the expected bytes a step; the first streamed
loss equals the port's whole-model ``CausalLM.loss`` on the gathered
params to 1e-5. The engines' errors and ``initialize``'s routing match the
JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import topology as topo
from deepspeed_tpu.runtime.config import load_config as jload
from deepspeed_tpu.runtime.zero_infinity import ZeroInfinityEngine as JaxZI
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
from deepspeed_tpu_torch.runtime.config import load_config as tload
from deepspeed_tpu_torch.runtime.zero_infinity import ZeroInfinityEngine
import torch_cpu  # noqa: F401  (one torch thread: see the module)

SHAPE = dict(num_layers=5, tie_embeddings=False, num_kv_heads=4)
JCFG = dataclasses.replace(jtf.TINY_TEST, **SHAPE)
TCFG = dataclasses.replace(ttf.TINY_TEST, **SHAPE)
TOL = dict(atol=1e-5, rtol=1e-5)


def _config(device, path, gas=1, **extra):
    return {"train_micro_batch_size_per_gpu": 4,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
            "zero_optimization": {"stage": 3, "offload_param": {
                "device": device, "nvme_path": str(path)}},
            "steps_per_print": 10 ** 9, **extra}


def _engines(tmp_path, device, group_layers, gas=1, jcfg=JCFG, tcfg=TCFG):
    topo.reset_topology()
    je = JaxZI(jtf.CausalLM(jcfg), jload(_config(device, tmp_path / "j", gas)),
               group_layers=group_layers)
    te = ZeroInfinityEngine(ttf.CausalLM(tcfg),
                            tload(_config(device, tmp_path / "t", gas)),
                            group_layers=group_layers, device="cpu")
    return je, te


def _batches(n):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, 256, (4, 33)).astype(np.int64)}
            for _ in range(n)]


def _counters(engine):
    s = engine.store
    return (s.reads, s.writes, s.bytes_read)


def _store_arrays(engine):
    """Every param, moment and accumulator array of the store, by key
    (through ``get`` for files, so each engine's counters move alike)."""
    s = engine.store
    if s.swapper is None:
        return dict(s._mem)
    return {k: np.array(s.get(k), copy=True) for k in sorted(s._shapes)}


# (moments, group size, accumulation steps, steps)
RUNS = {"cpu-g2": ("cpu", 2, 1, 3), "nvme-g3-gas2": ("nvme", 3, 2, 2)}


@pytest.mark.parametrize("name", list(RUNS))
def test_streaming_matches_jax_engine(name, tmp_path):
    device, g, gas, steps = RUNS[name]
    je, te = _engines(tmp_path, device, g, gas)
    assert [(s.start, s.stop) for s in te.groups] == \
        [(s.start, s.stop) for s in je.groups]
    assert te.groups[-1].stop - te.groups[-1].start < g       # uneven
    j0, t0 = _store_arrays(je), _store_arrays(te)
    assert sorted(t0) == sorted(j0)
    for k in j0:
        np.testing.assert_array_equal(t0[k], j0[k], err_msg=k)
    # the port's whole-model loss on the gathered params
    batches = _batches(steps * gas)
    params = params_from_numpy(te.gather_params(), "cpu")
    model = ttf.CausalLM(TCFG)
    with torch.no_grad():
        whole = np.mean([float(model.loss(params, {
            "input_ids": torch.as_tensor(b["input_ids"])}))
            for b in batches[:gas]])
    je.gather_edges()               # the reads gather_params made
    for k in te._layer_keys:
        for gi in range(len(je.groups)):
            je.store.get(f"layers.{k}.g{gi}")
    assert _counters(te) == _counters(je)
    its = iter(batches), iter(batches)
    for step in range(steps):
        if gas == 1:
            jl = je.train_batch(dict(batches[step]))
            tl = te.train_batch(dict(batches[step]))
        else:
            jl, tl = je.train_batch(its[0]), te.train_batch(its[1])
        np.testing.assert_allclose(tl, jl, **TOL)
        if step == 0:
            np.testing.assert_allclose(tl, whole, **TOL)
        assert _counters(te) == _counters(je)
    jr, tr = je.streaming_report(), te.streaming_report()
    assert {k: tr[k] for k in jr} == jr
    assert tr["bytes_read_per_step"] >= tr["expected_bytes_per_step"]
    assert te.get_lr() == je.get_lr() and te.global_steps == steps
    # the masters and moments after the steps: Adam's normalized step
    # turns an element whose gradient is near zero, and rounds apart, into
    # an lr-sized gap, so each store array is held by its mean gap
    j1, t1 = _store_arrays(je), _store_arrays(te)
    for k in j1:
        if not k.startswith("acc."):
            assert np.abs(t1[k] - j1[k]).mean() <= 1e-6, k
    je.close()
    te.close()


ERRORS = {
    "tied": (dict(tie_embeddings=True), None, ValueError),
    "mixed-window": (dict(sliding_window=(0, 8, 0, 8, 0)), None, ValueError),
    "lm-head-bias": (dict(lm_head_bias=True), None, ValueError),
    "embed-layernorm": (dict(embedding_layernorm=True), None, ValueError),
    "gas-without-iterator": ({}, "dict", TypeError),
    "not-an-iterator": ({}, "list", TypeError),
    "exhausted-iterator": ({}, "short", ValueError),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_streaming_errors_match_jax(name, tmp_path):
    over, feed, err = ERRORS[name]
    jcfg = dataclasses.replace(JCFG, **over)
    tcfg = dataclasses.replace(TCFG, **over)
    if feed is None:
        with pytest.raises(err):
            JaxZI(jtf.CausalLM(jcfg), jload(_config("cpu", tmp_path)))
        with pytest.raises(err):
            ZeroInfinityEngine(ttf.CausalLM(tcfg),
                               tload(_config("cpu", tmp_path)), device="cpu")
        return
    je, te = _engines(tmp_path, "cpu", 2, gas=2, jcfg=jcfg, tcfg=tcfg)
    batch = _batches(1)[0]
    arg = {"dict": lambda: dict(batch), "list": lambda: [batch, batch],
           "short": lambda: iter([batch])}[feed]
    before = _store_arrays(te)
    for engine in (je, te):
        with pytest.raises(err):
            engine.train_batch(arg())
    after = _store_arrays(te)           # nothing changed before the raise
    assert all(np.array_equal(before[k], after[k]) for k in before)
    assert te.opt_step == je.opt_step == 0
    je.close()
    te.close()


def test_streaming_refuses_a_mesh(tmp_path):
    cfg = tload(_config("cpu", tmp_path))
    with pytest.raises(NotImplementedError, match="item 14"):
        ZeroInfinityEngine(ttf.CausalLM(TCFG), cfg, mesh=object(),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        ZeroInfinityEngine(ttf.CausalLM(TCFG),
                           tload(_config("cpu", tmp_path, mesh={"fsdp": 2})),
                           device="cpu")


def test_initialize_routes_offload_param_to_streaming(tmp_path):
    # the entry points run on cuda unless asked for the CPU: here, with no
    # card, both offload engines raise before any work
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            deepspeed_tpu_torch.initialize(model=ttf.CausalLM(TCFG),
                                           config=_config("cpu", tmp_path))
        with pytest.raises(RuntimeError, match="CUDA"):
            deepspeed_tpu_torch.initialize(
                model=ttf.CausalLM(TCFG), config={
                    "train_batch_size": 2, "zero_optimization": {
                        "stage": 2, "offload_optimizer": {"device": "cpu"}}})
    for device in ("cpu", "nvme"):
        out = deepspeed_tpu_torch.initialize(
            model=ttf.CausalLM(TCFG), config=_config(device, tmp_path / device),
            device="cpu")
        assert isinstance(out[0], ZeroInfinityEngine)
        assert out[1:] == (None, None, None)
        assert out[0].device.type == "cpu"
        assert out[0].store.device == device
        out[0].close()
    bad = {
        "hybrid": (dict(hybrid_engine={"enabled": True}), {}),
        "stage": (dict(zero_optimization={"stage": 2, "offload_param": {
            "device": "cpu"}}), {}),
        "args": ({}, {"training_data": _batches(2)}),
    }
    for extra, kw in bad.values():
        cfg = {**_config("cpu", tmp_path), **extra}
        topo.reset_topology()
        with pytest.raises(ValueError):
            deepspeed_tpu.initialize(model=jtf.CausalLM(JCFG), config=cfg,
                                     **kw)
        with pytest.raises(ValueError):
            deepspeed_tpu_torch.initialize(model=ttf.CausalLM(TCFG),
                                           config=cfg, device="cpu", **kw)
