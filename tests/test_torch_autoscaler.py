"""Port parity: the elastic autoscaler
(``deepspeed_tpu_torch/serving/autoscaler.py``) against the JAX package's.

Policy cases drive a ``FleetController`` of each package with the same
fake clock and the same fake fleet (the fakes of ``tests/test_autoscaler.py``)
through the same scripted ticks; each case returns the controller's
``decision_log`` (fake-clock times included), the fleet's actuation record,
``stats()`` and the journal's events (kind and detail), and the port's must
equal the JAX package's exactly. The scripts cover the cases of
``tests/test_autoscaler.py`` and ``tests/test_affinity.py``'s predictive
ones: hysteresis and cooldowns, the min/max clamps and repairs, parked
slots, the decode-capability floors, the phase-weighted grow role, re-role
streaks and flap suppression, proactive brownout, predictive grows and
per-model pool bounds; and the actuation worker thread.

Live cases serve the model of ``tests/test_torch_serving_load.py`` (vocab
128, hidden 64, 2 layers; the JAX ``init(PRNGKey(0))`` weights x3) on the
CPU: an elastic frontend grows under a burst and shrinks when idle with
its journal equal to its decision log and every stream equal to the JAX
engine's greedy stream; ``fleet_signals`` of an idle role-split fleet
equals the JAX frontend's.
"""

import dataclasses
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu.serving as j_serving
import deepspeed_tpu.serving.autoscaler as j_autoscaler
import deepspeed_tpu.telemetry as j_telemetry
import deepspeed_tpu_torch.serving as t_serving
import deepspeed_tpu_torch.serving.autoscaler as t_autoscaler
import deepspeed_tpu_torch.telemetry as t_telemetry
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2.testing import \
    greedy_generate as j_greedy_generate
from deepspeed_tpu.models import transformer as jtf
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.models import transformer as ttf
from deepspeed_tpu_torch.models.weights import params_from_numpy
import torch_cpu  # noqa: F401  (one torch thread: see the module)

JAX = SimpleNamespace(S=j_serving, A=j_autoscaler, T=j_telemetry)
PORT = SimpleNamespace(S=t_serving, A=t_autoscaler, T=t_telemetry)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


class FakeFleet:
    """The actuation surface the controller drives (``FleetSignals`` over
    a dict of replicas), recording every action."""

    def __init__(self, ns, replicas, disaggregated=False, prefill_cost=1.0,
                 decode_cost=8.0, model_bounds=()):
        self.ns = ns
        self.replicas = {rid: dict(spec) for rid, spec in replicas.items()}
        self.next_id = max(replicas) + 1 if replicas else 0
        self.disaggregated = disaggregated
        self.prefill_cost, self.decode_cost = prefill_cost, decode_cost
        self.model_bounds = tuple(model_bounds)
        self.queue_depth = 0
        self.predicted = None
        self.burn_slow = 0.0
        self.brownout = None
        self.actions = []
        self.grad_on_actuation = []

    @staticmethod
    def rep(role="mixed", accepting=True, parked=False, pre=0, dec=0,
            model="default"):
        return dict(role=role, accepting=accepting, parked=parked, pre=pre,
                    dec=dec, model=model)

    def fleet_signals(self):
        infos = tuple(
            self.ns.A.ReplicaInfo(rid, r["role"], r["accepting"],
                                  r["parked"], r["pre"], r["dec"],
                                  model_id=r["model"])
            for rid, r in sorted(self.replicas.items()))
        return self.ns.A.FleetSignals(
            queue_depth=self.queue_depth, replicas=infos,
            burn_slow_max=self.burn_slow,
            prefill_token_cost=self.prefill_cost,
            decode_token_cost=self.decode_cost,
            disaggregated=self.disaggregated,
            model_bounds=self.model_bounds,
            predicted_queue_depth=self.predicted)

    def add_replica(self, role, model_id=None):
        self.grad_on_actuation.append(torch.is_grad_enabled())
        rid = self.next_id
        self.next_id += 1
        self.replicas[rid] = self.rep(role=role, model=model_id or "default")
        self.actions.append(("add", rid, role, model_id))
        return rid

    def remove_replica(self, rid, reason="scale_down"):
        del self.replicas[rid]
        self.actions.append(("remove", rid, reason))
        return True

    def set_replica_role(self, rid, role):
        self.actions.append(("rerole", rid, self.replicas[rid]["role"], role))
        self.replicas[rid]["role"] = role
        return True

    def set_proactive_brownout(self, frac):
        self.brownout = frac
        self.actions.append(("brownout", frac))


def controller(ns, fleet, clock, journal=None, async_actions=False, **cfg):
    base = dict(enabled=True, min_replicas=1, max_replicas=4,
                scale_up_queue_per_replica=4.0,
                scale_down_queue_per_replica=0.25,
                scale_down_tokens_per_replica=8.0,
                up_stable_ticks=2, down_stable_ticks=3,
                scale_up_cooldown_s=5.0, scale_down_cooldown_s=10.0,
                tick_interval_s=1.0, rerole_ratio=4.0,
                rerole_stable_ticks=3, rerole_cooldown_s=10.0,
                brownout_burn_threshold=2.0, brownout_fraction=0.5)
    base.update(cfg)
    return ns.A.FleetController(ns.S.AutoscalerConfig(**base), fleet,
                                clock=clock, journal=journal,
                                async_actions=async_actions)


def observe(ctl, fleet, journal):
    return {"log": list(ctl.decision_log), "actions": fleet.actions,
            "replicas": sorted(fleet.replicas), "brownout": fleet.brownout,
            "stats": ctl.stats(),
            "journal": [(e["kind"], e["detail"]) for e in journal.events()]}


def ticks(ctl, clock, n, dt=1.0):
    for _ in range(n):
        ctl.tick(clock.advance(dt))


# ---------------------------------------------------------------- scripts
def s_up_stable_then_cooldown(ns, fleet, clock, journal):
    fleet.replicas = {0: FakeFleet.rep()}
    fleet.next_id = 1
    ctl = controller(ns, fleet, clock, journal)
    fleet.queue_depth = 50
    ctl.tick(clock.t)
    ticks(ctl, clock, 6)
    return ctl


def s_calm_tick_resets(ns, fleet, clock, journal):
    ctl = controller(ns, fleet, clock, journal, up_stable_ticks=3)
    for q in (50, 50, 0, 50, 50, 50):
        fleet.queue_depth = q
        ctl.tick(clock.advance(1.0))
    return ctl


def s_max_clamp(ns, fleet, clock, journal):
    fleet.replicas = {i: FakeFleet.rep() for i in range(3)}
    fleet.next_id = 3
    ctl = controller(ns, fleet, clock, journal, max_replicas=3,
                     up_stable_ticks=1, scale_up_cooldown_s=0.0)
    fleet.queue_depth = 500
    ticks(ctl, clock, 10)
    return ctl


def s_down_to_min(ns, fleet, clock, journal):
    fleet.replicas = {i: FakeFleet.rep() for i in range(3)}
    fleet.next_id = 3
    ctl = controller(ns, fleet, clock, journal, down_stable_ticks=3,
                     scale_down_cooldown_s=4.0)
    ticks(ctl, clock, 30)
    return ctl


def s_below_min(ns, fleet, clock, journal):
    ctl = controller(ns, fleet, clock, journal, min_replicas=2)
    ctl.tick(clock.t)
    return ctl


def s_shrink_prefers_parked(ns, fleet, clock, journal):
    fleet.replicas = {0: FakeFleet.rep(),
                      1: FakeFleet.rep(accepting=False, parked=True),
                      2: FakeFleet.rep(dec=5)}
    fleet.next_id = 3
    ctl = controller(ns, fleet, clock, journal, down_stable_ticks=1,
                     scale_down_cooldown_s=0.0,
                     scale_down_tokens_per_replica=100.0)
    ticks(ctl, clock, 3)
    return ctl


def s_shrink_skips_last_decode(ns, fleet, clock, journal):
    fleet.replicas = {0: FakeFleet.rep(role="prefill", pre=3),
                      1: FakeFleet.rep(role="decode"),
                      2: FakeFleet.rep(role="prefill", pre=9)}
    fleet.next_id = 3
    fleet.disaggregated = True
    ctl = controller(ns, fleet, clock, journal, down_stable_ticks=1,
                     scale_down_cooldown_s=0.0,
                     scale_down_queue_per_replica=100.0,
                     scale_down_tokens_per_replica=100.0)
    ticks(ctl, clock, 4)
    return ctl


def s_evict_parked_then_grow(ns, fleet, clock, journal):
    fleet.replicas = {0: FakeFleet.rep(accepting=False, parked=True),
                      1: FakeFleet.rep(), 2: FakeFleet.rep()}
    fleet.next_id = 3
    ctl = controller(ns, fleet, clock, journal, max_replicas=3,
                     up_stable_ticks=1, scale_up_cooldown_s=1.0)
    fleet.queue_depth = 100
    ticks(ctl, clock, 3)
    return ctl


def s_grow_role_follows_phase(ns, fleet, clock, journal):
    fleet.replicas = {0: FakeFleet.rep(role="prefill", pre=100),
                      1: FakeFleet.rep(role="decode", dec=1)}
    fleet.next_id = 2
    fleet.disaggregated = True
    ctl = controller(ns, fleet, clock, journal, up_stable_ticks=1,
                     scale_up_cooldown_s=0.0)
    fleet.queue_depth = 100
    ticks(ctl, clock, 2)
    fleet.replicas[0]["pre"] = 0
    fleet.replicas[1]["dec"] = 500
    ticks(ctl, clock, 1)
    return ctl


def _rerole_fleet(fleet, pre, dec, n_decode=2):
    fleet.replicas = {0: FakeFleet.rep(role="prefill", pre=pre)}
    for i in range(n_decode):
        fleet.replicas[1 + i] = FakeFleet.rep(role="decode", dec=dec)
    fleet.next_id = 1 + n_decode
    fleet.disaggregated = True
    fleet.decode_cost = 1.0


def s_rerole_once_then_cooldown(ns, fleet, clock, journal):
    _rerole_fleet(fleet, 100, 1)
    ctl = controller(ns, fleet, clock, journal,
                     scale_up_queue_per_replica=1e9)
    ticks(ctl, clock, 11)
    return ctl


def s_rerole_oscillating(ns, fleet, clock, journal):
    _rerole_fleet(fleet, 100, 1)
    ctl = controller(ns, fleet, clock, journal, rerole_stable_ticks=2,
                     rerole_cooldown_s=0.0, scale_up_queue_per_replica=1e9)
    for i in range(12):
        pre, dec = (100, 1) if i % 2 == 0 else (1, 100)
        fleet.replicas[0].update(pre=pre, dec=0)
        for rid in (1, 2):
            fleet.replicas[rid].update(dec=dec, pre=0)
        ctl.tick(clock.advance(1.0))
    return ctl


def s_rerole_never_strands(ns, fleet, clock, journal):
    _rerole_fleet(fleet, 100, 1, n_decode=1)
    ctl = controller(ns, fleet, clock, journal, rerole_stable_ticks=1,
                     rerole_cooldown_s=0.0, scale_up_queue_per_replica=1e9)
    ticks(ctl, clock, 5)
    return ctl


def s_brownout_hysteresis(ns, fleet, clock, journal):
    ctl = controller(ns, fleet, clock, journal)
    for burn in (1.9, 2.1, 1.5, 0.9, 2.5):
        fleet.burn_slow = burn
        ctl.tick(clock.advance(1.0))
    return ctl


def s_predictive_grows_early(ns, fleet, clock, journal):
    ctl = controller(ns, fleet, clock, journal, up_stable_ticks=2,
                     scale_up_cooldown_s=0.0, max_replicas=3)
    for q, pred in ((1, 2.0), (1, 9.0), (1, 9.0), (6, None), (6, None),
                    (0, 50.0), (0, 0.0), (0, 0.0), (0, 0.0)):
        fleet.queue_depth, fleet.predicted = q, pred
        ctl.tick(clock.advance(1.0))
    return ctl


def s_model_pool_bounds(ns, fleet, clock, journal):
    fleet.replicas = {0: FakeFleet.rep(model="a"),
                      1: FakeFleet.rep(model="b", dec=40),
                      2: FakeFleet.rep(model="b"),
                      3: FakeFleet.rep(model="b")}
    fleet.next_id = 4
    fleet.model_bounds = (("a", 2, 3), ("b", 1, 2))
    ctl = controller(ns, fleet, clock, journal, max_replicas=6,
                     up_stable_ticks=1, scale_up_cooldown_s=0.0,
                     scale_down_cooldown_s=0.0)
    ticks(ctl, clock, 3)
    fleet.queue_depth = 100
    ticks(ctl, clock, 2)
    return ctl


SCRIPTS = {f.__name__[2:]: f for f in (
    s_up_stable_then_cooldown, s_calm_tick_resets, s_max_clamp,
    s_down_to_min, s_below_min, s_shrink_prefers_parked,
    s_shrink_skips_last_decode, s_evict_parked_then_grow,
    s_grow_role_follows_phase, s_rerole_once_then_cooldown,
    s_rerole_oscillating, s_rerole_never_strands, s_brownout_hysteresis,
    s_predictive_grows_early, s_model_pool_bounds)}


def run_script(ns, script):
    clock = FakeClock()
    fleet = FakeFleet(ns, {0: FakeFleet.rep()})
    journal = ns.T.OpsJournal(capacity=256)
    ctl = script(ns, fleet, clock, journal)
    assert ns.T.validate_events(journal.events()) == []
    return observe(ctl, fleet, journal)


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_policy_matches_jax(name):
    ref = run_script(JAX, SCRIPTS[name])
    got = run_script(PORT, SCRIPTS[name])
    assert got == ref
    # journal and decision log agree, one event per completed action
    assert [(d["action"]) for d in got["log"]] \
        == [k for k, _ in got["journal"]]


def test_policy_scripts_take_their_actions():
    """The scripts are not vacuous: each kind of decision appears."""
    kinds = set()
    reasons = set()
    for script in SCRIPTS.values():
        obs = run_script(PORT, script)
        kinds |= {d["action"] for d in obs["log"]}
        reasons |= {d.get("reason") for d in obs["log"]}
    assert kinds == {"scale_up", "scale_down", "replica_reroled",
                     "brownout_proactive"}
    assert {"queue_pressure", "predicted_pressure", "below_min", "idle",
            "evict_parked", "pool_below_min", "pool_above_max"} <= reasons


def test_actuation_thread_matches_sync_and_has_grad_off():
    """With ``async_actions`` (the frontend's mode) the actions run on the
    controller's own thread: waiting for each to finish before the next
    tick gives the synchronous decision log, in both packages, and the
    port's worker builds with grad mode off (it is per thread)."""
    out = {}
    for name, ns in (("jax", JAX), ("port", PORT)):
        clock = FakeClock()
        fleet = FakeFleet(ns, {0: FakeFleet.rep()})
        ctl = controller(ns, fleet, clock, async_actions=True,
                         up_stable_ticks=1, scale_up_cooldown_s=0.0,
                         max_replicas=3)
        try:
            assert ctl.thread.name == "serving-autoscaler"
            fleet.queue_depth = 50
            for _ in range(4):
                ctl.tick(clock.advance(1.0))
                deadline = time.monotonic() + 10
                while ctl._action_pending.is_set() \
                        and time.monotonic() < deadline:
                    time.sleep(0.001)
        finally:
            ctl.stop()
        assert not ctl.thread.is_alive()
        out[name] = (list(ctl.decision_log), fleet.actions)
        if ns is PORT:
            assert torch.is_grad_enabled()
            assert fleet.grad_on_actuation == [False, False]
    assert out["port"] == out["jax"]
    assert len(out["port"][1]) == 2


def test_config_validation_messages():
    for kw in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2},
               {"brownout_fraction": 0.0}):
        with pytest.raises(Exception) as jerr:
            j_serving.AutoscalerConfig(**kw)
        with pytest.raises(ValueError) as terr:
            t_serving.AutoscalerConfig(**kw)
        assert next(iter(kw)) in str(terr.value)
        assert next(iter(kw)) in str(jerr.value)
    assert tuple(t_autoscaler._DECODE_CAPABLE) == ("decode", "mixed")


# ------------------------------------------------------------ live stack
VOCAB = 128
ENGINE = dict(max_ragged_batch_size=128, max_ragged_sequence_count=2,
              max_chunk_tokens=32, kv_blocks=64, kv_block_size=8,
              max_tracked_sequences=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(mod):
    return mod.TransformerConfig(vocab_size=VOCAB, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=2, max_seq_len=128, norm="rmsnorm",
                                 activation="silu", position="rope")


@pytest.fixture(scope="module")
def weights():
    jp = jtf.CausalLM(_cfg(jtf)).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.asarray(a) * (3 if a.ndim >= 2 else 1),
                        jp)


@pytest.fixture(scope="module")
def params(weights):
    return params_from_numpy(weights, device="cpu")


def tiny_engine(params, **over):
    return InferenceEngineV2(ttf.CausalLM(_cfg(ttf)), params=params,
                             config=RaggedInferenceEngineConfig(
                                 **dict(ENGINE, **over)), device="cpu")


def prompts(n, seed, lo=8, hi=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(k)).tolist()
            for k in rng.integers(lo, hi, size=n)]


def test_elastic_frontend_scales_with_journal_parity(params, weights):
    """A one-replica fleet under a burst grows; idle, it shrinks back to
    min. The journal's scale events equal the decision log, the health
    report carries the controller's books, and every stream equals the
    JAX engine's greedy stream."""
    scfg = t_serving.ServingConfig(
        max_queue_depth=256,
        autoscaler={"enabled": True, "min_replicas": 1, "max_replicas": 3,
                    "scale_up_queue_per_replica": 2.0,
                    "scale_down_queue_per_replica": 0.25,
                    "scale_down_tokens_per_replica": 1.0,
                    "up_stable_ticks": 1, "down_stable_ticks": 2,
                    "scale_up_cooldown_s": 0.1, "scale_down_cooldown_s": 0.2,
                    "tick_interval_s": 0.05})
    ps = prompts(24, 17)
    fe = t_serving.ServingFrontend(
        [tiny_engine(params)], scfg,
        engine_factory=lambda i: tiny_engine(params))
    try:
        assert fe.autoscaler.maybe_tick in fe.router.tick_hooks
        hs = [fe.submit(p, max_new_tokens=16) for p in ps]
        assert fe.wait_all(hs, timeout=120)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            st = fe.autoscaler.stats()
            if st["scale_ups"] >= 1 and len(fe.router.replicas) == 1:
                break
            time.sleep(0.05)
        st = fe.autoscaler.stats()
        assert st["scale_ups"] >= 1 and st["scale_downs"] >= 1, st
        assert len(fe.router.replicas) == 1 and st["peak_replicas"] >= 2
        assert st["replica_seconds"] > 0
        log = [d for d in fe.autoscaler.decision_log
               if d["action"] in ("scale_up", "scale_down")]
        evs = fe.journal.events(kinds=("scale_up", "scale_down"))
        assert [(e["kind"], e["detail"]["replica"]) for e in evs] \
            == [(d["action"], d["replica"]) for d in log]
        assert t_telemetry.validate_events(fe.journal.events()) == []
        snap = fe.metrics_snapshot()
        assert snap["requests_completed"] == 24
        assert snap["requests_failed"] == 0
        rep = fe.health_report()
        assert rep["autoscaler"]["scale_ups"] >= 1
        assert rep["autoscaler"]["replicas_target"] == 1.0
        assert "autoscaler: target=1" in fe.health_report_text()
        got = [[ev.token for ev in h.drain()] for h in hs]
    finally:
        fe.shutdown(drain=False, timeout=5)
    assert not fe.autoscaler.thread.is_alive()
    jeng = JEngine(jtf.CausalLM(_cfg(jtf)), params=weights,
                   config=JConfig(**dict(ENGINE, max_ragged_sequence_count=16,
                                         kv_blocks=512)))
    assert got == j_greedy_generate(jeng, ps, max_new_tokens=16,
                                    sequential=False)


def test_fleet_signals_and_errors_equal_jax(params, weights):
    """An idle role-split fleet with the autoscaler on: ``fleet_signals``
    equals the JAX frontend's field for field, ``set_proactive_brownout``
    moves the queue's fraction, and an autoscaler without an engine
    factory is refused with the JAX message."""
    jmodel = jtf.CausalLM(_cfg(jtf))

    def jeng(i=0):
        return JEngine(jmodel, params=weights, config=JConfig(**ENGINE))

    def teng(i=0):
        return tiny_engine(params)
    scfg = dict(max_queue_depth=16,
                disaggregation={"enabled": True,
                                "roles": ["prefill", "decode"]},
                autoscaler={"enabled": True, "min_replicas": 2,
                            "max_replicas": 3, "tick_interval_s": 60.0})
    out = {}
    for name, mod, fac in (("jax", j_serving, jeng),
                           ("port", t_serving, teng)):
        with pytest.raises(ValueError) as err:
            mod.ServingFrontend([fac()], mod.ServingConfig(
                autoscaler={"enabled": True}))
        fe = mod.ServingFrontend([fac(), fac()], mod.ServingConfig(**scfg),
                                 engine_factory=fac)
        try:
            sig = fe.fleet_signals()
            fe.set_proactive_brownout(0.5)
            frac = fe.admission._proactive_frac
            fe.set_proactive_brownout(None)
            out[name] = (str(err.value),
                         dataclasses.asdict(sig), frac,
                         fe.admission._proactive_frac,
                         sorted(fe.health_report()["autoscaler"]),
                         fe.router.role_census())
        finally:
            fe.shutdown(drain=False, timeout=5)
    assert out["port"] == out["jax"]
    assert out["port"][2] == 0.5


def test_autoscaler_grow_under_disaggregation(params):
    """Under disaggregation a backlog grows the fleet by a specialized
    replica (the phase whose weighted load dominates at the decision),
    built on the controller's thread with grad mode off; it joins with
    that role and the fleet serves every request."""
    scfg = t_serving.ServingConfig(
        max_queue_depth=256,
        disaggregation={"enabled": True, "roles": ["prefill", "decode"]},
        autoscaler={"enabled": True, "min_replicas": 2, "max_replicas": 3,
                    "scale_up_queue_per_replica": 1.0,
                    "up_stable_ticks": 1, "down_stable_ticks": 1000,
                    "scale_up_cooldown_s": 0.0, "rerole_ratio": 0.0,
                    "tick_interval_s": 0.02})
    built = []

    def factory(i):
        built.append((threading.current_thread().name,
                      torch.is_grad_enabled()))
        return tiny_engine(params)
    fe = t_serving.ServingFrontend([tiny_engine(params), tiny_engine(params)],
                                   scfg, engine_factory=factory)
    try:
        hs = [fe.submit(p, max_new_tokens=4)
              for p in prompts(24, 18, lo=40, hi=60)]
        assert fe.wait_all(hs, timeout=120)
        ups = [d for d in fe.autoscaler.decision_log
               if d["action"] == "scale_up"]
        assert ups and ups[0]["role"] in ("prefill", "decode"), list(
            fe.autoscaler.decision_log)
        assert built[0] == ("serving-autoscaler", False)
        assert fe.router.role_census()[ups[0]["role"]] == 2
        assert fe.router.replica_by_id(2).role == ups[0]["role"]
        assert fe.metrics_snapshot()["requests_failed"] == 0
    finally:
        fe.shutdown(drain=False, timeout=5)
