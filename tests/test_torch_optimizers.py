"""Port parity: ``deepspeed_tpu_torch.ops.optimizers`` and
``runtime.lr_schedules`` against the JAX package's on the CPU.

The same params and gradients, made from a seed with numpy, take three steps
through each optimizer in both packages; params and every moment must agree
to 1e-6 (the same fp32 formulas in the same order; the two libraries may
fuse or order a product differently). Each lr schedule is read at steps 0,
1, the end of its warm-up and beyond, as a Python number and as a 0-d
tensor, and agrees to 1e-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu_torch.models.weights import (params_from_numpy,
                                                params_to_numpy,
                                                train_state_from_numpy,
                                                train_state_to_numpy)
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import lr_schedules as tlr

OPTIMIZERS = {
    "adam-l2": ("Adam", {"lr": 1e-2, "weight_decay": 0.1,
                         "adam_w_mode": False}),
    "adamw": ("AdamW", {"lr": 1e-2, "weight_decay": 0.1,
                        "betas": (0.8, 0.95)}),
    "adam-no-bias-correction": ("FusedAdam", {"lr": 1e-2,
                                              "bias_correction": False}),
    "lamb": ("Lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    "lion": ("Lion", {"lr": 1e-3, "weight_decay": 0.1}),
    "sgd": ("SGD", {"lr": 1e-1, "weight_decay": 0.01}),
    "sgd-nesterov": ("sgd", {"lr": 1e-1, "momentum": 0.9, "nesterov": True}),
    "adagrad": ("Adagrad", {"lr": 1e-1, "weight_decay": 0.01}),
}


def _tree(seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": {"wte": mk(7, 5)},
            "layers": {"w": mk(2, 5, 3), "b": mk(2, 3), "zero": np.zeros(
                (4,), np.float32)}}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_steps_match_jax(name):
    kind, kwargs = OPTIMIZERS[name]
    jo = jopt.build_optimizer(kind, dict(kwargs))
    to = topt.build_optimizer(kind, dict(kwargs))
    assert type(to).__name__ == type(jo).__name__
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, device="cpu")
    js, ts = jo.init(jp), to.init(tp)
    assert sorted(ts.moments) == sorted(js.moments)
    for step in range(3):
        grads = _tree(10 + step)
        lr = np.float32(kwargs["lr"] * (1 + step))
        jp, js = jo.step(jp, jax.tree.map(jnp.asarray, grads), js, lr)
        tp_new, ts = to.step(tp, params_from_numpy(grads, device="cpu"), ts,
                             torch.tensor(lr))
        assert tp_new is not tp     # functional: the inputs are untouched
        tp = tp_new
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                        jax.tree.leaves(jp)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-6)
        for a, b in zip(jax.tree.leaves(params_to_numpy(ts.moments)),
                        jax.tree.leaves(js.moments)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-6)


def test_build_optimizer_keys_and_errors():
    assert isinstance(topt.build_optimizer("Fused_Adam"), topt.FusedAdam)
    assert topt.build_optimizer("AdamW", {"adam_w_mode": False}).adam_w_mode
    assert isinstance(topt.build_optimizer("fusedlamb", {"torch_adam": True}),
                      topt.Lamb)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        topt.build_optimizer("adafactor")
    with pytest.raises(ValueError, match="amsgrad"):
        topt.build_optimizer("adam", {"amsgrad": True})
    for key in ("OneBitAdam", "ZeroOneAdam", "onebit_lamb"):
        with pytest.raises(NotImplementedError, match="queue 1 item 14"):
            topt.build_optimizer(key)


def test_tree_leaves_order_is_jax_tree_leaves_order():
    tree = _tree(1)
    for a, b in zip(topt.tree_leaves(tree), jax.tree.leaves(tree)):
        assert a is b


def test_train_state_crosses_as_numpy_both_ways():
    """An ``OptimizerState`` and a ``ScaleState`` of the JAX package become
    the port's, and the port's go back to numpy unchanged."""
    from deepspeed_tpu.runtime.engine import ScaleState as JScale

    jo = jopt.FusedAdam(lr=1e-2)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    _, js = jo.step(jp, jax.tree.map(jnp.asarray, _tree(1)), jo.init(jp),
                    1e-2)
    jss = JScale(scale=jnp.asarray(2.0 ** 12, jnp.float32),
                 good_steps=jnp.asarray(3, jnp.int32),
                 hysteresis=jnp.asarray(2, jnp.int32))
    as_np = train_state_to_numpy(js, jss)
    ts, tss = train_state_from_numpy(as_np, device="cpu")
    assert int(ts.step) == 1 and ts.step.dtype == torch.int32
    assert float(tss.scale) == 4096.0 and int(tss.good_steps) == 3
    assert int(tss.hysteresis) == 2 and tss.scale.dtype == torch.float32
    back = train_state_to_numpy(ts, tss)
    for a, b in zip(jax.tree.leaves(as_np), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    # the port's optimizer continues from the carried state as JAX does
    to = topt.FusedAdam(lr=1e-2)
    g = _tree(2)
    jp2, _ = jo.step(jp, jax.tree.map(jnp.asarray, g), js, 1e-2)
    tp2, _ = to.step(params_from_numpy(_tree(0), device="cpu"),
                     params_from_numpy(g, device="cpu"), ts, 1e-2)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp2)),
                    jax.tree.leaves(jp2)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=1e-6)


SCHEDULES = {
    "WarmupLR-log": ("WarmupLR", {"warmup_min_lr": 1e-5,
                                  "warmup_max_lr": 1e-3,
                                  "warmup_num_steps": 10}),
    "WarmupLR-linear": ("WarmupLR", {"warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 10,
                                     "warmup_type": "linear"}),
    "WarmupDecayLR": ("WarmupDecayLR", {"total_num_steps": 40,
                                        "warmup_min_lr": 1e-5,
                                        "warmup_max_lr": 1e-3,
                                        "warmup_num_steps": 10}),
    "WarmupCosineLR": ("WarmupCosineLR", {"total_num_steps": 40,
                                          "warmup_min_ratio": 0.1,
                                          "warmup_num_steps": 10,
                                          "lr": 2e-3}),
    "OneCycle": ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3,
                              "cycle_first_step_size": 10,
                              "decay_step_size": 5, "decay_lr_rate": 0.5}),
    "OneCycle-no-decay": ("one_cycle", {"cycle_min_lr": 1e-4,
                                        "cycle_max_lr": 1e-3,
                                        "cycle_first_step_size": 10,
                                        "cycle_second_step_size": 4}),
    "LRRangeTest": ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                                    "lr_range_test_step_size": 10,
                                    "lr_range_test_step_rate": 2.0}),
    "LRRangeTest-staircase": ("LRRangeTest", {
        "lr_range_test_step_size": 10, "lr_range_test_staircase": True}),
    "constant": ("constant", {"lr": 3e-4}),
    "fallback": (None, None),
}
STEPS = (0, 1, 5, 9, 10, 11, 14, 20, 39, 40, 41, 100)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    kind, params = SCHEDULES[name]
    js = jlr.build_schedule(kind, params, fallback_lr=7e-4)
    ts = tlr.build_schedule(kind, params, fallback_lr=7e-4)
    for step in STEPS:
        want = float(js(step))
        got = ts(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-7, atol=1e-12)
        on_dev = ts(torch.tensor(step, dtype=torch.int32))
        assert on_dev.dtype == torch.float32 and on_dev.dim() == 0
        np.testing.assert_allclose(float(on_dev), want, rtol=1e-7,
                                   atol=1e-12)


def test_schedule_errors_and_shim():
    with pytest.raises(ValueError, match="Unknown scheduler"):
        tlr.build_schedule("Exponential")
    sched = tlr.build_schedule("WarmupLR", {"warmup_max_lr": 1e-3,
                                            "warmup_num_steps": 10})
    shim = tlr.LRSchedulerShim(sched)
    assert shim.get_lr() == [0.0]
    shim.step()
    shim.step(2)
    assert shim.state_dict() == {"last_step": 3}
    assert shim.get_last_lr() == [float(sched(3))]
    shim.load_state_dict({"last_step": 10})
    np.testing.assert_allclose(shim.get_lr()[0], 1e-3, rtol=1e-6)
    # with a step source the host mirror is not consulted
    sourced = tlr.LRSchedulerShim(sched, step_source=lambda: 10)
    sourced.step(5)
    np.testing.assert_allclose(sourced.get_lr()[0], 1e-3, rtol=1e-6)
    assert sourced.state_dict() == {"last_step": 10}
