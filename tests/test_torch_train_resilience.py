"""Port parity: the training supervisor of ``deepspeed_tpu_torch``
(``runtime/resilience.py``), twin of ``tests/test_train_resilience.py``.

``TINY_TEST`` port engines on the CPU, one device. A seeded fault injector
crashes, preempts (SIGTERM), wedges and poisons supervised runs at
scripted steps; each case holds the recovery to the contract the JAX suite
holds its engine to: an interrupted and resumed run reproduces the
unbroken loss curve and final params bit for bit, rollbacks and parks are
counted as they happen, and the journal records each event. One case runs
the JAX supervisor and the port's over the same start params and faults:
their loss curves agree within 1e-5 (fp32 through two BLAS libraries).
"""

import os
import threading
import time
from collections import deque

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu.parallel import topology as topo
from deepspeed_tpu.runtime import resilience as jres
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime.config import DeepSpeedTpuConfig
from deepspeed_tpu_torch.runtime.resilience import (InjectedTrainFault,
                                                    ResilienceConfig,
                                                    StepWatchdog,
                                                    TrainFaultInjector,
                                                    TrainingSupervisor)
import torch_cpu  # noqa: F401  (one torch thread: see the module)

N_STEPS = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_data(n=64, seq=32, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, size=(n, seq + 1),
                                      dtype=np.int64)}


def make_config(save_dir, faults=None, **res_over):
    res = {"enabled": True, "save_dir": str(save_dir),
           "save_interval_steps": 2, "restart_backoff_s": 0.01,
           "restart_backoff_jitter": 0.0, "watchdog_enabled": False,
           "faults": faults or {"enabled": False}}
    res.update(res_over)
    return {
        "train_micro_batch_size_per_gpu": 4,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 5}},
        "steps_per_print": 10**9,
        "resilience": res,
    }


def build_engine(save_dir, faults=None, data=None, params=None, **res_over):
    return deepspeed_tpu_torch.initialize(
        model=ttf.CausalLM(ttf.TINY_TEST),
        config=make_config(save_dir, faults, **res_over),
        training_data=data if data is not None else tiny_data(),
        model_parameters=params, device="cpu")[0]


def faults(*schedule):
    return {"enabled": True, "schedule": list(schedule)}


def params_of(engine):
    return [t.detach().clone() for t in tree_leaves(engine.state.params)]


def assert_same_params(a, b):
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)


def kinds(sup):
    return [e["kind"] for e in sup.journal.events()]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The unbroken supervised run: per-step losses and final params."""
    engine = build_engine(tmp_path_factory.mktemp("ref"))
    sup = TrainingSupervisor(engine=engine)
    r = sup.run(N_STEPS)
    assert r["status"] == "completed" and r["completed_steps"] == N_STEPS
    return {"losses": sup.losses_by_step(), "params": params_of(engine)}


# ------------------------------------------------------------- injector units
class TestInjector:
    def test_schedule_validation(self):
        with pytest.raises(ValueError, match="unknown train fault kind"):
            TrainFaultInjector([{"kind": "meteor", "at_step": 1}])
        with pytest.raises(ValueError, match="needs at_step"):
            TrainFaultInjector([{"kind": "crash"}])

    def test_crash_raises_and_counts(self):
        inj = TrainFaultInjector([{"kind": "crash", "at_step": 3}])
        assert inj.on_step(2) == []
        with pytest.raises(InjectedTrainFault):
            inj.on_step(3)
        assert inj.on_step(4) == []
        assert [e[:2] for e in inj.fired_events()] == [("crash", 3)]

    def test_seeded_step_range_equals_the_jax_draw(self):
        spec = [{"kind": "crash", "at_step_range": [10, 100]}]
        for seed in (7, 8):
            a = TrainFaultInjector(spec, seed=seed)
            assert a.events[0].at_step == \
                jres.TrainFaultInjector(spec, seed=seed).events[0].at_step
            assert 10 <= a.events[0].at_step <= 100

    def test_coscheduled_events_survive_a_crash(self):
        inj = TrainFaultInjector([{"kind": "sigterm", "at_step": 5},
                                  {"kind": "crash", "at_step": 5}])
        seen = []
        with pytest.raises(InjectedTrainFault):
            inj.on_step(5, handler=lambda ev: seen.append(ev.kind))
        assert seen == ["sigterm"]

    def test_count_zero_fires_every_time(self):
        inj = TrainFaultInjector([{"kind": "nan_grads", "at_step": 2,
                                   "count": 0}])
        for step in (2, 3, 4):
            assert [e.kind for e in inj.on_step(step)] == ["nan_grads"]

    def test_disabled_config_builds_nothing(self):
        cfg = ResilienceConfig(faults={"enabled": False, "schedule": [
            {"kind": "crash", "at_step": 1}]})
        assert cfg.faults.build_injector() is None


# ------------------------------------------------------------ watchdog units
class TestWatchdog:
    def test_thresholds(self):
        wd = StepWatchdog(step_timeout_s=0.0, factor=10.0, min_samples=3)
        assert wd.timeout_s() is None
        for dt in (0.01, 0.02, 0.03):
            wd.step_end(dt)
        assert wd.timeout_s() == pytest.approx(0.2)
        floor = StepWatchdog(step_timeout_s=0.5, factor=10.0, min_samples=3)
        assert floor.timeout_s() == 0.5
        for dt in (0.1, 0.1, 0.1):
            floor.step_end(dt)
        assert floor.timeout_s() == pytest.approx(1.0)
        high = StepWatchdog(step_timeout_s=5.0, factor=10.0, min_samples=3)
        for dt in (0.1, 0.1, 0.1):
            high.step_end(dt)
        assert high.timeout_s() == 5.0

    def test_detects_a_wedge_and_not_completed_steps(self):
        wd = StepWatchdog(poll_s=0.01, step_timeout_s=0.05)
        ok = StepWatchdog(poll_s=0.01, step_timeout_s=0.05)
        wd.start()
        ok.start()
        try:
            wd.step_begin()
            for _ in range(5):
                ok.step_begin()
                ok.step_end(0.001)
            assert wd.wedged.wait(2.0), "watchdog missed the wedged step"
            time.sleep(0.1)
            assert not ok.wedged.is_set()
        finally:
            wd.stop()
            ok.stop()
        assert not wd.thread.is_alive() and not ok.thread.is_alive()


# ----------------------------------------------------------- resume parity
class TestResumeParity:
    def test_crash_auto_resume_bit_parity(self, tmp_path, reference):
        engine = build_engine(tmp_path, faults(
            {"kind": "crash", "at_step": 5}))
        sup = TrainingSupervisor(engine=engine)
        r = sup.run(N_STEPS)
        assert r["status"] == "completed" and r["train_restarts"] == 1
        assert r["steps_lost"] == 1
        assert r["restart_log"][0]["resumed_step"] == 4
        assert sup.losses_by_step() == reference["losses"]
        assert_same_params(reference["params"], params_of(engine))
        assert kinds(sup).count("checkpoint_saved") == 4   # steps 2, 4, 6, 8
        assert "train_restart" in kinds(sup)
        assert "restarts=1" in sup.health_report_text()

    @pytest.mark.parametrize("same_supervisor", [False, True])
    def test_sigterm_urgent_save_then_resume(self, tmp_path, reference,
                                             same_supervisor):
        """Preempted at the notice with an urgent save inside the grace
        window; run() again (the same supervisor, or a new engine and
        supervisor over the same save_dir) resumes with no step lost."""
        engine = build_engine(tmp_path, faults(
            {"kind": "sigterm", "at_step": 5}))
        sup = TrainingSupervisor(engine=engine)
        r = sup.run(N_STEPS)
        assert r["status"] == "preempted" and r["completed_steps"] == 5
        assert r["preemptions"] == 1
        assert 0 < r["urgent_save_s"] < sup.config.preempt_grace_s
        assert (tmp_path / "latest").read_text().strip() == "global_step5"
        assert "train_preempt_save" in kinds(sup)
        if same_supervisor:
            sup2, engine2 = sup, engine
        else:
            engine2 = build_engine(tmp_path)
            sup2 = TrainingSupervisor(engine=engine2)
        r2 = sup2.run(N_STEPS)
        assert r2["status"] == "completed" and r2["completed_steps"] == N_STEPS
        merged = dict(sup.losses_by_step())
        merged.update(sup2.losses_by_step())
        assert merged == reference["losses"]
        assert_same_params(reference["params"], params_of(engine2))

    def test_real_sigterm_signal_path(self, tmp_path):
        assert threading.current_thread() is threading.main_thread()
        engine = build_engine(tmp_path, faults(
            {"kind": "sigterm", "at_step": 3}))
        sup = TrainingSupervisor(engine=engine)
        r = sup.run(N_STEPS)
        assert sup._signal_installed is False      # handler restored
        assert r["status"] == "preempted" and r["completed_steps"] == 3
        assert [e[0] for e in sup.injector.fired_events()] == ["sigterm"]

    def test_mid_epoch_dataloader_resume(self, tmp_path):
        data = tiny_data(n=56, seq=32)      # 7 batches an epoch at gas 2
        e_ref = build_engine(tmp_path / "ref", data=data)
        sup_ref = TrainingSupervisor(engine=e_ref)
        sup_ref.run(N_STEPS)
        engine = build_engine(tmp_path / "chaos", faults(
            {"kind": "crash", "at_step": 5}), data=data)
        sup = TrainingSupervisor(engine=engine)
        assert sup.run(N_STEPS)["status"] == "completed"
        st = engine.training_dataloader.state_dict()
        assert 0 < st["batches_yielded"] < 14
        assert sup.losses_by_step() == sup_ref.losses_by_step()
        assert_same_params(params_of(e_ref), params_of(engine))

    def test_crash_after_skipped_step_keeps_parity(self, tmp_path):
        skip = {"kind": "nan_grads", "at_step": 3, "count": 1}
        e_ref = build_engine(tmp_path / "ref", faults(dict(skip)),
                             max_consecutive_anomalies=5)
        sup_ref = TrainingSupervisor(engine=e_ref)
        r_ref = sup_ref.run(N_STEPS)
        assert r_ref["status"] == "completed" and r_ref["train_restarts"] == 0
        assert e_ref.skipped_steps == 1
        engine = build_engine(tmp_path / "chaos", faults(
            dict(skip), {"kind": "crash", "at_step": 6}),
            max_consecutive_anomalies=5)
        sup = TrainingSupervisor(engine=engine)
        r = sup.run(N_STEPS)
        assert r["status"] == "completed" and r["train_restarts"] == 1
        assert r["restart_log"][0]["resumed_step"] == 6
        assert sup.losses_by_step() == sup_ref.losses_by_step()
        assert_same_params(params_of(e_ref), params_of(engine))

    def test_injectors_off_is_the_plain_loop(self, tmp_path, reference):
        engine = build_engine(tmp_path)
        plain = {}
        while engine.global_steps < N_STEPS:
            loss = float(engine.train_batch())
            plain[engine.global_steps] = loss
        assert plain == reference["losses"]
        assert_same_params(reference["params"], params_of(engine))

    def test_port_supervisor_follows_the_jax_supervisor(self, tmp_path):
        """The same start params, data and crash through both packages'
        supervisors (one device, stage 0): equal restart logs, loss curves
        within 1e-5."""
        fault = faults({"kind": "crash", "at_step": 5})
        topo.reset_topology()
        je, *_ = deepspeed_tpu.initialize(
            model=jtf.CausalLM(jtf.TINY_TEST),
            config=make_config(tmp_path / "jax", fault),
            training_data=tiny_data(),
            mesh=topo.MeshTopology.build(devices=jax.devices()[:1]))
        start = jax.tree.map(np.asarray, je.state.params)
        jsup = jres.TrainingSupervisor(engine=je)
        jr = jsup.run(N_STEPS)
        te = build_engine(tmp_path / "port", fault, params=start)
        tsup = TrainingSupervisor(engine=te)
        tr = tsup.run(N_STEPS)
        assert tr["status"] == jr["status"] == "completed"
        for key in ("reason", "from_step", "resumed_step", "steps_lost"):
            assert tr["restart_log"][0][key] == jr["restart_log"][0][key]
        jl, tl = jsup.losses_by_step(), tsup.losses_by_step()
        assert list(tl) == list(jl)
        np.testing.assert_allclose(list(tl.values()), list(jl.values()),
                                   atol=1e-5, rtol=1e-5)
        assert kinds(tsup) == kinds(jsup)


# -------------------------------------------------------- watchdog + wedge
def _wedge_engine(save_dir, at_step):
    return build_engine(
        save_dir, faults({"kind": "slow_step", "at_step": at_step,
                          "duration_s": 2.5}),
        watchdog_enabled=True, step_timeout_s=1.0, watchdog_factor=8.0,
        watchdog_min_steps=3, watchdog_poll_s=0.05)


def _join_abandoned_workers():
    """The wedged worker wakes after its slow step, finds itself
    superseded and exits: wait for it, so no training thread outlives the
    test."""
    for t in threading.enumerate():
        if t.name == "train-supervised-loop":
            t.join(10.0)
            assert not t.is_alive()


class TestWedgeRecovery:
    def test_watchdog_detects_wedge_dumps_and_restarts(self, tmp_path,
                                                       reference):
        sup = TrainingSupervisor(
            engine_factory=lambda: _wedge_engine(tmp_path, 5))
        first = sup.engine
        r = sup.run(N_STEPS)
        assert r["status"] == "completed"
        assert r["wedges"] == 1 and r["train_restarts"] == 1
        assert r["restart_log"][0]["reason"] == "wedge"
        assert r["restart_log"][0]["resumed_step"] == 4
        assert sup.engine is not first
        assert r["dump_paths"], "a wedge dumps the flight recorder"
        for paths in r["dump_paths"]:
            assert os.path.exists(paths["json"])
            assert os.path.exists(paths["chrome_trace"])
        assert "train_wedge" in kinds(sup)
        assert sup.losses_by_step() == reference["losses"]
        _join_abandoned_workers()

    def test_wedge_without_factory_parks(self, tmp_path):
        sup = TrainingSupervisor(engine=_wedge_engine(tmp_path, 3))
        r = sup.run(N_STEPS)
        assert r["status"] == "parked" and r["parked"] and r["wedges"] == 1
        assert kinds(sup)[-1] == "train_parked"
        _join_abandoned_workers()


# ------------------------------------------------------- anomaly rollback
class TestAnomalyRollback:
    def test_nan_grads_skip_then_rollback(self, tmp_path):
        engine = build_engine(tmp_path, faults(
            {"kind": "nan_grads", "at_step": 4, "count": 3}),
            max_consecutive_anomalies=2)
        sup = TrainingSupervisor(engine=engine)
        r = sup.run(N_STEPS)
        assert r["status"] == "completed"
        assert r["anomaly_rollbacks"] == 1 and r["train_restarts"] == 1
        assert sup.engine.skipped_steps >= 1
        assert np.isfinite(sup.losses_by_step()[N_STEPS])
        for leaf in params_of(sup.engine):
            assert torch.isfinite(leaf).all()
        assert "train_anomaly_rollback" in kinds(sup)

    def test_rollback_reproduces_the_unbroken_curve(self, tmp_path,
                                                    reference):
        """A storm exactly as long as the limit: the rollback replays the
        poisoned steps clean, so the curve and final params are the
        unbroken run's bit for bit."""
        engine = build_engine(tmp_path, faults(
            {"kind": "nan_grads", "at_step": 4, "count": 3}),
            max_consecutive_anomalies=3)
        sup = TrainingSupervisor(engine=engine)
        r = sup.run(N_STEPS)
        assert r["status"] == "completed" and r["anomaly_rollbacks"] == 1
        assert r["restart_log"][0]["resumed_step"] == 4
        assert sup.losses_by_step() == reference["losses"]
        assert_same_params(reference["params"], params_of(engine))

    def test_single_anomaly_does_not_roll_back(self, tmp_path):
        engine = build_engine(tmp_path, faults(
            {"kind": "nan_grads", "at_step": 4, "count": 1}),
            max_consecutive_anomalies=3)
        r = TrainingSupervisor(engine=engine).run(N_STEPS)
        assert r["status"] == "completed"
        assert r["anomaly_rollbacks"] == 0 and r["train_restarts"] == 0
        assert engine.skipped_steps == 1

    def test_parked_anomaly_storm_counts_no_rollback(self, tmp_path):
        engine = build_engine(tmp_path, faults(
            {"kind": "nan_grads", "at_step": 0, "count": 0}),
            max_consecutive_anomalies=2, save_interval_steps=0)
        r = TrainingSupervisor(engine=engine).run(N_STEPS)
        assert r["status"] == "parked"
        assert r["anomaly_rollbacks"] == 0 and r["train_restarts"] == 0

    def test_preempt_mid_streak_skips_urgent_save(self, tmp_path):
        engine = build_engine(tmp_path, faults(
            {"kind": "nan_grads", "at_step": 4, "count": 1},
            {"kind": "sigterm", "at_step": 5}),
            max_consecutive_anomalies=5)
        r = TrainingSupervisor(engine=engine).run(N_STEPS)
        assert r["status"] == "preempted" and r["preemptions"] == 1
        assert r["urgent_save_s"] is None
        assert not (tmp_path / "global_step5").exists()
        assert (tmp_path / "latest").read_text().strip() == "global_step4"

    def test_loss_spike_detection(self):
        cfg = ResilienceConfig(enabled=True, save_dir="/unused",
                               loss_spike_factor=5.0)
        sup = TrainingSupervisor.__new__(TrainingSupervisor)
        sup.config = cfg

        class FakeEngine:
            _last_metrics = {"overflow": torch.tensor(False)}

        good = deque([2.0, 2.1, 1.9], maxlen=10)
        assert not sup._is_anomaly(FakeEngine(), 2.5, good)
        assert sup._is_anomaly(FakeEngine(), 50.0, good)
        assert sup._is_anomaly(FakeEngine(), float("nan"), good)
        FakeEngine._last_metrics = {"overflow": torch.tensor(True)}
        assert sup._is_anomaly(FakeEngine(), 2.0, good)


# --------------------------------------------------------- circuit breaker
class TestCircuitBreaker:
    def test_persistent_crash_parks(self, tmp_path):
        sup = TrainingSupervisor(engine_factory=lambda: build_engine(
            tmp_path, faults({"kind": "crash", "at_step": 2, "count": 0}),
            max_restarts_in_window=3))
        r = sup.run(N_STEPS)
        assert r["status"] == "parked" and r["parked"]
        assert r["train_restarts"] == 2

    def test_crash_before_any_checkpoint_needs_factory(self, tmp_path):
        engine = build_engine(tmp_path, faults(
            {"kind": "crash", "at_step": 1}), save_interval_steps=0)
        r = TrainingSupervisor(engine=engine).run(N_STEPS)
        assert r["status"] == "parked"


# ----------------------------------------------------------- config surface
class TestConfigSurface:
    def test_block_mounts_and_equals_the_jax_block(self):
        from deepspeed_tpu.runtime.config import \
            DeepSpeedTpuConfig as JConfig

        block = {"enabled": True, "save_dir": "/ckpt",
                 "save_interval_steps": 50,
                 "faults": {"enabled": True, "seed": 3, "schedule": [
                     {"kind": "sigterm", "at_step": 100}]}}
        cfg = DeepSpeedTpuConfig(resilience=block)
        assert isinstance(cfg.resilience, ResilienceConfig)
        assert cfg.resilience.enabled and cfg.resilience.save_dir == "/ckpt"
        assert cfg.resilience.faults.build_injector().events[0].kind == \
            "sigterm"
        assert cfg.resilience.to_dict() == \
            JConfig(resilience=block).resilience.model_dump()
        assert not DeepSpeedTpuConfig().resilience.enabled
        with pytest.raises(ValueError):
            DeepSpeedTpuConfig(resilience={"save_interval_steps": "often"})

    def test_disabled_supervisor_refuses_to_run(self, tmp_path):
        engine = build_engine(tmp_path)
        engine.config.resilience.enabled = False
        sup = TrainingSupervisor(engine=engine,
                                 config=engine.config.resilience,
                                 save_dir=str(tmp_path))
        with pytest.raises(ValueError, match="resilience.enabled"):
            sup.run(2)

    def test_supervisor_requires_save_dir(self, tmp_path):
        engine = build_engine(tmp_path)
        engine.config.resilience.save_dir = None
        with pytest.raises(ValueError, match="save_dir"):
            TrainingSupervisor(engine=engine)


# ------------------------------------------- LR + ScaleState resume exactness
class TestScheduleAndScaleResume:
    def test_warmup_lr_continues_without_rewarmup(self, tmp_path):
        engine = build_engine(tmp_path, faults(
            {"kind": "crash", "at_step": 5}))
        assert TrainingSupervisor(engine=engine).run(N_STEPS)["status"] \
            == "completed"
        ref = build_engine(tmp_path / "ref2")
        assert TrainingSupervisor(engine=ref).run(N_STEPS)["status"] \
            == "completed"
        assert engine.get_lr() == ref.get_lr()
        assert engine.lr_scheduler.state_dict() == ref.lr_scheduler.state_dict()

    def test_fp16_scale_state_continues_under_the_supervisor(self, tmp_path):
        """A crash under fp16 with a dynamic scale: the restored scale
        window continues, and the curve equals the unbroken run's."""
        def eng(d, fault=None):
            cfg = make_config(d, fault)
            cfg["fp16"] = {"enabled": True, "initial_scale_power": 8,
                           "loss_scale_window": 4}
            return deepspeed_tpu_torch.initialize(
                model=ttf.CausalLM(ttf.TINY_TEST), config=cfg,
                training_data=tiny_data(), device="cpu")[0]

        ref = eng(tmp_path / "ref")
        sup_ref = TrainingSupervisor(engine=ref)
        sup_ref.run(N_STEPS)
        engine = eng(tmp_path / "chaos", faults(
            {"kind": "crash", "at_step": 7}))
        sup = TrainingSupervisor(engine=engine)
        assert sup.run(N_STEPS)["train_restarts"] == 1
        assert sup.losses_by_step() == sup_ref.losses_by_step()
        assert engine.loss_scale == ref.loss_scale
        assert int(engine.state.scale_state.good_steps) == \
            int(ref.state.scale_state.good_steps)
