"""Preemption-safe self-healing training: supervisor, watchdog, rollback.

Counterpart of ``deepspeed_tpu/runtime/resilience.py``, with the same
config keys, fault kinds, journal events and restart discipline:

- :class:`TrainingSupervisor` wraps the train loop. SIGTERM (the cloud
  preemption notice) triggers an urgent, bounded-time checkpoint save
  inside the grace window; a crash, a wedged step or an anomaly storm
  triggers a restart from ``latest`` with exponential backoff, seeded
  jitter and a circuit breaker (``utils/restart.py``, shared with the
  serving supervisor). Resume is deterministic: the fp32 masters and
  moments, the LR schedule, the loss-scale state, the counters and the
  data loader's position are restored, so an interrupted and resumed run
  reproduces the uninterrupted loss curve bit for bit.
- :class:`StepWatchdog`: a host thread with a rolling-median step-time
  baseline. A wedged step (a stuck device call) is detected, the flight
  recorder is dumped, and the supervisor restarts from ``latest`` on a
  fresh engine instead of hanging.
- Anomaly guards build on the engine's overflow gate (its update skips any
  step whose gradient norm is not finite, in every precision): the
  supervisor counts consecutive non-finite or loss-spike steps and after K
  in a row rolls back to the last good checkpoint.
- :class:`TrainFaultInjector`: a seeded, scripted schedule of training
  faults (``crash``/``sigterm``/``nan_grads``/``slow_step`` at exact
  steps). Disabled, it installs no hook anywhere.

The step loop runs on a worker thread. Autograd's grad mode is a
per-thread setting, so the worker turns it on itself. Everything defaults
off: with no ``resilience`` block, and no supervisor constructed, training
is unchanged.
"""

from __future__ import annotations

import dataclasses
import math
import os
import random
import signal
import statistics
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..ops.optimizers import tree_leaves
from ..utils.locks import RankedLock
from ..utils.logging import logger
from ..utils.restart import RestartPolicy
from .config_utils import DSConfigModel

# --------------------------------------------------------------------- config

TRAIN_FAULT_KINDS = ("crash", "sigterm", "nan_grads", "slow_step")


@dataclass(init=False, eq=False, repr=False)
class TrainFaultsConfig(DSConfigModel):
    """``resilience.faults: {...}``, test only: a seeded schedule of
    crashes, preemption signals, NaN gradient storms and wedged steps.
    Entries: ``{"kind": ..., "at_step": k | "at_step_range": [lo, hi],
    "duration_s": t (slow_step), "count": c (firings; 0 = every time)}``.
    Disabled, no hook is installed."""

    enabled: bool = False
    seed: int = 0
    schedule: List[Dict[str, Any]] = field(default_factory=list)

    def build_injector(self) -> Optional["TrainFaultInjector"]:
        if not self.enabled:
            return None
        return TrainFaultInjector(self.schedule, seed=self.seed)


@dataclass(init=False, eq=False, repr=False)
class ResilienceConfig(DSConfigModel):
    """``resilience: {...}`` on ``DeepSpeedTpuConfig``. Read by
    :class:`TrainingSupervisor`; the block changes nothing by itself
    (constructing the supervisor is the opt-in), and with ``enabled:
    false`` the supervisor refuses to run."""

    enabled: bool = False
    # checkpoint root; 'latest' inside it is the auto-resume anchor
    save_dir: Optional[str] = None
    # periodic checkpoint cadence in optimizer steps (0 = only urgent or
    # caller-driven saves); skipped while an anomaly streak is open, so
    # 'latest' always names a last good state
    save_interval_steps: int = 0
    # preemption: a SIGTERM handler (main thread only) and an urgent
    # synchronous save inside this grace window
    handle_sigterm: bool = True
    preempt_grace_s: float = 30.0
    # restart backoff and circuit breaker: base * 2^(failures - 1), capped,
    # with seeded jitter; max_restarts_in_window failures inside
    # restart_window_s park the run
    restart_backoff_s: float = 0.5
    restart_backoff_max_s: float = 30.0
    restart_backoff_jitter: float = 0.2
    seed: int = 0
    max_restarts_in_window: int = 3
    restart_window_s: float = 3600.0
    # step watchdog: a step outrunning max(step_timeout_s, watchdog_factor
    # x rolling median) is wedged; with step_timeout_s == 0 the median arms
    # after watchdog_min_steps steps. Wedge recovery needs an
    # engine_factory: the stuck thread owns the old engine.
    watchdog_enabled: bool = True
    step_timeout_s: float = 0.0
    watchdog_factor: float = 10.0
    watchdog_min_steps: int = 5
    watchdog_poll_s: float = 0.5
    # anomaly guards: a step is anomalous when the update skipped on a
    # non-finite gradient norm, the loss is not finite, or the loss exceeds
    # loss_spike_factor x the median of the last loss_window good losses
    # (0 turns the spike check off); K in a row roll back
    anomaly_detection: bool = True
    loss_spike_factor: float = 10.0
    loss_window: int = 20
    max_consecutive_anomalies: int = 3
    faults: TrainFaultsConfig = field(default_factory=TrainFaultsConfig)


# ------------------------------------------------------------ fault injection


class InjectedTrainFault(RuntimeError):
    """The scripted training failure: a plain RuntimeError on purpose, so
    the supervisor treats it exactly like a real crash."""


@dataclasses.dataclass
class TrainFaultEvent:
    kind: str                       # one of TRAIN_FAULT_KINDS
    at_step: Optional[int] = None   # optimizer-step index
    duration_s: float = 0.0         # slow_step wedge length
    count: int = 1                  # firings allowed; 0 = every time
    error: str = "injected train fault"
    fired: int = 0

    def _matches(self, step: int) -> bool:
        if self.at_step is None:
            return False
        if self.count != 0 and self.fired >= self.count:
            return False
        return step >= self.at_step


class TrainFaultInjector:
    """Seeded, scripted schedule of :class:`TrainFaultEvent`.

    ``on_step(step)`` runs once per optimizer step, before the step:
    ``crash`` raises :class:`InjectedTrainFault`, ``slow_step`` sleeps (the
    stuck device call the watchdog detects), and ``sigterm``/``nan_grads``
    go to the caller's handler (the supervisor delivers the signal or
    poisons the gradient accumulator). ``at_step_range: [lo, hi]`` draws
    the step from the seeded RNG at construction."""

    # ``events`` is immutable after construction; the firing ledger is
    # written from more than one thread
    _GUARDED_BY = {"fired_log": "_lock"}

    def __init__(self, schedule: List[Dict[str, Any]], seed: int = 0):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.events: List[TrainFaultEvent] = []
        for raw in schedule:
            e = dict(raw)
            rng_range = e.pop("at_step_range", None)
            ev = TrainFaultEvent(**e)
            if rng_range is not None:
                ev.at_step = self.rng.randint(int(rng_range[0]),
                                              int(rng_range[1]))
            if ev.kind not in TRAIN_FAULT_KINDS:
                raise ValueError(f"unknown train fault kind {ev.kind!r} "
                                 f"(expected one of {TRAIN_FAULT_KINDS})")
            if ev.at_step is None:
                raise ValueError(f"{ev.kind} fault needs at_step "
                                 "(or at_step_range)")
            self.events.append(ev)
        self._lock = RankedLock("train.faults")
        self.fired_log: List[tuple] = []   # (kind, step, monotonic t)

    def _take(self, step: int) -> List[TrainFaultEvent]:
        with self._lock:
            hits = [ev for ev in self.events if ev._matches(step)]
            for ev in hits:
                ev.fired += 1
                self.fired_log.append((ev.kind, step, time.monotonic()))
        return hits

    def fired_events(self) -> List[tuple]:
        with self._lock:
            return list(self.fired_log)

    def on_step(self, step: int,
                handler: Optional[Callable[[TrainFaultEvent], None]] = None
                ) -> List[TrainFaultEvent]:
        """Pre-step hook. Sleeps wedges itself; ``sigterm``/``nan_grads``
        events go through ``handler`` (or the returned list when none is
        given); a ``crash`` raises last, after every co-scheduled event was
        delivered, since all taken events count as fired."""
        out = []
        crash: Optional[TrainFaultEvent] = None
        for ev in self._take(step):
            if ev.kind == "slow_step":
                time.sleep(ev.duration_s)
            elif ev.kind == "crash":
                crash = ev
            elif handler is not None:
                handler(ev)
            else:
                out.append(ev)
        if crash is not None:
            raise InjectedTrainFault(
                f"{crash.error} (crash at step {step})")
        return out


# ----------------------------------------------------------------- watchdog


class StepWatchdog:
    """Host-side wedged-step detector.

    The stepping thread brackets each optimizer step with
    :meth:`step_begin`/:meth:`step_end`; this thread polls and declares a
    wedge when the step in flight outruns ``max(step_timeout_s, factor x
    rolling median step time)``. With ``step_timeout_s == 0`` the median
    arms only after ``min_samples`` completed steps. The watchdog only
    detects (sets :attr:`wedged`, calls ``on_wedge`` once); recovery is the
    supervisor's, since nothing can interrupt the stuck device call."""

    # the duration ring is the only cross-thread structure; the step
    # bracket (``_step_started``) has a single writer
    _GUARDED_BY = {"_durations": "_dur_lock"}

    def __init__(self, poll_s: float = 0.5, step_timeout_s: float = 0.0,
                 factor: float = 10.0, min_samples: int = 5,
                 on_wedge: Optional[Callable[[float], None]] = None,
                 history: int = 64):
        self.poll_s = float(poll_s)
        self.step_timeout_s = float(step_timeout_s)
        self.factor = float(factor)
        self.min_samples = int(min_samples)
        self.on_wedge = on_wedge
        self._durations: "deque[float]" = deque(maxlen=history)
        # the stepping thread appends while this thread takes the median:
        # an unguarded sort over a changing deque raises and would kill
        # the watchdog silently
        self._dur_lock = RankedLock("train.watchdog.durations")
        self._step_started: Optional[float] = None
        self.wedged = threading.Event()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="train-step-watchdog")

    # hooks for the stepping thread ------------------------------------
    def step_begin(self) -> None:
        self._step_started = time.monotonic()

    def step_end(self, duration_s: float) -> None:
        self._step_started = None
        with self._dur_lock:
            self._durations.append(float(duration_s))

    def step_abort(self) -> None:
        """Close the bracket without a sample (a step cut short by a
        preemption notice is no latency sample)."""
        self._step_started = None

    # ------------------------------------------------------------------
    def timeout_s(self) -> Optional[float]:
        """The wedge threshold, ``max(step_timeout_s, factor x rolling
        median)``: the fixed floor alone before the median arms, and None
        (unarmed) with no floor before ``min_samples`` steps."""
        with self._dur_lock:
            samples = list(self._durations)
        auto = (self.factor * statistics.median(samples)
                if len(samples) >= max(1, self.min_samples) else None)
        if self.step_timeout_s > 0:
            return self.step_timeout_s if auto is None \
                else max(self.step_timeout_s, auto)
        return auto

    def start(self) -> None:
        self.thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self.thread.is_alive():
            self.thread.join(timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                started = self._step_started
                limit = self.timeout_s()
            except Exception:  # pragma: no cover - the watchdog must not
                self._stop.wait(self.poll_s)  # die of its own bug
                continue
            if started is not None and limit is not None:
                stuck_for = time.monotonic() - started
                if stuck_for > limit:
                    self.wedged.set()
                    logger.error(
                        f"train watchdog: step wedged for "
                        f"{stuck_for:.2f}s (limit {limit:.2f}s)")
                    if self.on_wedge is not None:
                        try:
                            self.on_wedge(stuck_for)
                        except Exception:  # pragma: no cover - defensive
                            pass
                    return          # one detection per watchdog
            self._stop.wait(self.poll_s)


# --------------------------------------------------------------- supervisor


class TrainingSupervisor:
    """Self-healing wrapper around ``engine.train_batch()``.

    ``run(num_steps)`` drives the engine to ``num_steps`` optimizer steps,
    resuming from ``latest`` in ``save_dir`` first (so calling ``run``
    again after a preemption, or in a restarted process, is the resume
    path). The step loop runs on a worker thread so that the supervisor can
    abandon a wedged step; crashes, wedges and anomaly storms restart from
    ``latest`` with backoff and a circuit breaker. Returns a status dict
    (``status`` ``completed``/``preempted``/``parked`` and the counters).

    The engine must own its batch stream (``initialize(...,
    training_data=...)``). ``engine_factory``, when given, builds an
    equivalent engine: wedge recovery needs it (the stuck thread owns the
    old engine), and so does a restart before any checkpoint exists."""

    def __init__(self, engine=None, engine_factory: Optional[Callable] = None,
                 config: Optional[ResilienceConfig] = None,
                 save_dir: Optional[str] = None, journal=None):
        if engine is None and engine_factory is None:
            raise ValueError("TrainingSupervisor needs an engine or an "
                             "engine_factory")
        self.engine_factory = engine_factory
        self._engine = engine if engine is not None else engine_factory()
        if config is None:
            config = self._engine.config.resilience
        elif isinstance(config, dict):
            config = ResilienceConfig(**config)
        self.config = config
        self.save_dir = save_dir or self.config.save_dir
        if not self.save_dir:
            raise ValueError("resilience needs a save_dir (config "
                             "resilience.save_dir or the save_dir argument)")
        self.injector = self.config.faults.build_injector()
        # restarts, parks, preemption saves, rollbacks, checkpoint
        # publications and wedges land in the ops journal the serving stack
        # writes, so a host that trains and serves has one timeline
        if journal is None:
            from ..telemetry.journal import OpsJournal

            journal = OpsJournal(capacity=512, source="training")
        self.journal = journal
        self.rng = random.Random(self.config.seed)
        self.stats: Dict[str, Any] = {
            "train_restarts": 0, "steps_lost": 0, "anomaly_rollbacks": 0,
            "preemptions": 0, "wedges": 0, "urgent_save_s": None,
            "parked": False}
        # (global_step, loss) per completed step; a restart appends the
        # replayed steps again, and losses_by_step() keeps the last write
        self.loss_log: List[tuple] = []
        self.restart_log: List[dict] = []
        self.dump_paths: List[dict] = []
        self._gen = 0                       # attempt generation token
        self._preempt = threading.Event()
        self._restart_policy = RestartPolicy(
            self.config.restart_backoff_s, self.config.restart_backoff_max_s,
            self.config.restart_backoff_jitter,
            self.config.max_restarts_in_window, self.config.restart_window_s,
            self.rng)
        # the live attempt's consecutive-anomaly count, mirrored out of the
        # worker so that the preemption path never publishes an anomalous
        # state as 'latest'
        self._anomaly_streak = 0
        self._signal_installed = False
        self._prev_handler = None
        self._recorder = None

    # ------------------------------------------------------------ properties
    @property
    def engine(self):
        return self._engine

    def losses_by_step(self) -> Dict[int, float]:
        """Per-step losses, replayed steps collapsed (last write wins): the
        resume-parity comparison surface."""
        return {step: loss for step, loss in self.loss_log}

    # ------------------------------------------------------------------ run
    def run(self, num_steps: int) -> Dict[str, Any]:
        cfg = self.config
        if not cfg.enabled:
            raise ValueError("resilience.enabled is false; enable it (or "
                             "drive engine.train_batch yourself) — a "
                             "disabled supervisor supervising would be a lie")
        self._install_sigterm()
        # a preemption honoured by an earlier run() must not stop this one:
        # calling run() again is the resume path
        self._preempt.clear()
        try:
            self._restore_latest()
            while True:
                if self.stats["parked"]:
                    return self._status("parked")
                if self._preempt.is_set():
                    # preempted outside a clean step boundary (during the
                    # restart backoff): 'latest' holds the last checkpoint
                    return self._status("preempted")
                box = self._attempt(num_steps)
                outcome = box["outcome"]
                if outcome == "completed":
                    return self._status("completed")
                if outcome == "preempted":
                    if self._anomaly_streak > 0:
                        # 'latest' must keep naming the last good state
                        self.stats["preemptions"] += 1
                        logger.warning(
                            f"preempted with {self._anomaly_streak} "
                            "consecutive anomalies open: skipping the "
                            "urgent save — resume falls back to the last "
                            "good checkpoint")
                    else:
                        self._urgent_save()
                    return self._status("preempted")
                if not self._handle_failure(outcome, box):
                    return self._status("parked")
        finally:
            self._restore_sigterm()

    # -------------------------------------------------------------- attempt
    def _attempt(self, num_steps: int) -> Dict[str, Any]:
        cfg = self.config
        gen = self._gen
        engine = self._engine
        box: Dict[str, Any] = {"outcome": None, "error": None,
                               "step_at_exit": None}
        watchdog = None
        if cfg.watchdog_enabled:
            watchdog = StepWatchdog(
                poll_s=cfg.watchdog_poll_s,
                step_timeout_s=cfg.step_timeout_s,
                factor=cfg.watchdog_factor,
                min_samples=cfg.watchdog_min_steps)
            watchdog.start()

        def loop():
            consecutive = 0
            self._anomaly_streak = 0        # fresh attempt, fresh streak
            good_losses: "deque[float]" = deque(maxlen=max(1, cfg.loss_window))
            try:
                # grad mode is per thread: this one trains
                with torch.enable_grad():
                    while engine.global_steps < num_steps:
                        if self._gen != gen:
                            box["outcome"] = "superseded"
                            return
                        if self._preempt.is_set():
                            box["outcome"] = "preempted"
                            box["step_at_exit"] = engine.global_steps
                            return
                        step = engine.global_steps
                        # the injector runs inside the watchdog bracket: a
                        # slow_step models a wedged device call
                        if watchdog is not None:
                            watchdog.step_begin()
                        t0 = time.monotonic()
                        if self.injector is not None:
                            def handle(ev):
                                if ev.kind == "sigterm":
                                    self._deliver_sigterm()
                                elif ev.kind == "nan_grads":
                                    self._poison_grads(engine)

                            self.injector.on_step(step, handler=handle)
                            if self._preempt.is_set():
                                if watchdog is not None:
                                    watchdog.step_abort()
                                continue    # exit at the loop top
                        loss = float(engine.train_batch())
                        if watchdog is not None:
                            watchdog.step_end(time.monotonic() - t0)
                        if self._gen != gen:
                            box["outcome"] = "superseded"
                            return
                        self.loss_log.append((engine.global_steps, loss))
                        if self._is_anomaly(engine, loss, good_losses):
                            consecutive += 1
                            self._anomaly_streak = consecutive
                            if consecutive >= max(
                                    1, cfg.max_consecutive_anomalies):
                                box["outcome"] = "anomaly"
                                box["step_at_exit"] = engine.global_steps
                                return
                        else:
                            consecutive = 0
                            self._anomaly_streak = 0
                            good_losses.append(loss)
                            if cfg.save_interval_steps > 0 and \
                                    engine.global_steps \
                                    % cfg.save_interval_steps == 0:
                                self._save(engine)
                box["outcome"] = "completed"
                box["step_at_exit"] = engine.global_steps
            except BaseException as e:  # noqa: BLE001 — the crash path
                box["outcome"] = "crash"
                box["error"] = e
                box["step_at_exit"] = engine.global_steps

        worker = threading.Thread(target=loop, daemon=True,
                                  name="train-supervised-loop")
        worker.start()
        try:
            while worker.is_alive():
                worker.join(0.05)
                if watchdog is not None and watchdog.wedged.is_set() \
                        and worker.is_alive():
                    # abandon the stuck worker: it owns the engine until
                    # its device call returns, so bump the generation (it
                    # exits at its next loop-top check) and recover on a
                    # fresh engine. A fresh dict: the worker still holds
                    # `box` and may write to it.
                    self._gen += 1
                    self.stats["wedges"] += 1
                    self.journal.emit("train_wedge",
                                      step=int(engine.global_steps))
                    self._dump_flight_recorder(engine, "train_wedge")
                    return {"outcome": "wedge", "error": None,
                            "step_at_exit": engine.global_steps}
        finally:
            if watchdog is not None:
                watchdog.stop()
        return box

    # ------------------------------------------------------------- anomalies
    def _is_anomaly(self, engine, loss: float,
                    good_losses: "deque[float]") -> bool:
        cfg = self.config
        if not cfg.anomaly_detection:
            return False
        if not math.isfinite(loss):
            return True
        m = getattr(engine, "_last_metrics", None)
        if m is not None and bool(m.get("overflow", False)):
            # the update skipped this step on a non-finite gradient norm:
            # one skip is the bounded step-skip, K in a row roll back
            return True
        if cfg.loss_spike_factor > 0 and len(good_losses) >= 3:
            med = statistics.median(good_losses)
            if med > 0 and loss > cfg.loss_spike_factor * med:
                return True
        return False

    @staticmethod
    @torch.no_grad()
    def _poison_grads(engine) -> None:
        """nan_grads: poison the gradient accumulator (each master leaf's
        ``.grad``, in place) so that this step's update sees a non-finite
        norm."""
        for acc in tree_leaves(engine.state.grad_acc):
            acc.mul_(float("nan"))

    # ----------------------------------------------------------- checkpoints
    def _client_state(self, engine) -> Dict[str, Any]:
        cs: Dict[str, Any] = {"resilience": {"format": 1}}
        loader = getattr(engine, "training_dataloader", None)
        if loader is not None and hasattr(loader, "state_dict"):
            try:
                cs["dataloader"] = loader.state_dict()
            except NotImplementedError:
                pass        # sampler and iterable sources own their position
        return cs

    def _save(self, engine, urgent: bool = False) -> None:
        engine.save_checkpoint(self.save_dir,
                               client_state=self._client_state(engine),
                               urgent=urgent)
        # journaled after the save returns: the event records a checkpoint
        # that was published ('latest' swapped)
        self.journal.emit("checkpoint_saved",
                          step=int(engine.global_steps), urgent=urgent)

    @torch.no_grad()
    def _restore_latest(self) -> bool:
        """Load ``latest`` (if any) into the current engine and restore the
        data loader's position; True when a checkpoint was loaded. The
        gradient accumulator is zeroed: a crash mid-accumulation leaves
        partial sums the checkpoint knows nothing of."""
        engine = self._engine
        path, cs = engine.load_checkpoint(self.save_dir)
        if path is None:
            return False
        for acc in tree_leaves(engine.state.grad_acc):
            acc.zero_()
        loader = getattr(engine, "training_dataloader", None)
        dl_state = (cs or {}).get("dataloader")
        if loader is not None and dl_state is not None \
                and hasattr(loader, "load_state_dict"):
            loader.load_state_dict(dl_state)
            engine.reset_data_iterator()
        elif loader is not None:
            # no data position in the checkpoint (the source is not
            # resumable): replayed steps may see other batches, which voids
            # the bit-for-bit resume contract, so say so
            logger.warning(
                "resume: checkpoint has no dataloader position (source "
                "is not resumable) — replayed steps may train on "
                "different batches; resume is NOT byte-for-byte for "
                "this data source")
        return True

    def _urgent_save(self) -> None:
        """The SIGTERM grace-window save: joins any in-flight async write,
        completes synchronously, and records its wall time against the
        grace budget."""
        cfg = self.config
        engine = self._engine
        span = engine.tracer.begin("train_preempt_save", trace_id="train",
                                   attrs={"global_step": engine.global_steps})
        t0 = time.monotonic()
        try:
            self._save(engine, urgent=True)
        finally:
            span.end()
        dt = getattr(engine, "last_urgent_save_s", None)
        dt = float(dt) if dt is not None else time.monotonic() - t0
        self.stats["urgent_save_s"] = dt
        self.stats["preemptions"] += 1
        self.journal.emit("train_preempt_save",
                          step=int(engine.global_steps),
                          save_s=round(dt, 4),
                          within_grace=dt <= cfg.preempt_grace_s)
        if dt > cfg.preempt_grace_s:
            logger.error(f"urgent checkpoint took {dt:.2f}s — exceeds the "
                         f"{cfg.preempt_grace_s:.0f}s preemption grace "
                         "window; shrink the model state per host or raise "
                         "the grace budget")
        else:
            logger.info(f"urgent checkpoint saved in {dt:.2f}s "
                        f"(grace {cfg.preempt_grace_s:.0f}s)")

    # --------------------------------------------------------------- failure
    def _handle_failure(self, reason: str, box: Dict[str, Any]) -> bool:
        """Backoff (seeded jitter), circuit breaker, engine replacement,
        restore from ``latest``. False when the run parks."""
        cfg = self.config
        now = time.monotonic()
        err = box.get("error")
        logger.warning(f"train supervisor: {reason} at step "
                       f"{box.get('step_at_exit')}"
                       + (f" ({type(err).__name__}: {err})" if err else ""))
        n, backoff = self._restart_policy.record_failure(now)
        if backoff is None:             # circuit breaker tripped
            self.stats["parked"] = True
            self.journal.emit("train_parked", failures=n,
                              reason="circuit_breaker")
            logger.error(f"train supervisor PARKED after {n} failures in "
                         f"{cfg.restart_window_s:.0f}s window — not "
                         "restarting a run that keeps dying")
            return False
        needs_fresh_engine = reason == "wedge"
        has_checkpoint = os.path.exists(os.path.join(self.save_dir, "latest"))
        if (needs_fresh_engine or not has_checkpoint) \
                and self.engine_factory is None:
            # a wedged thread owns the old engine, and with no checkpoint a
            # restart must rebuild the initial state: both need the factory
            self.stats["parked"] = True
            self.journal.emit("train_parked", failures=n,
                              reason="no_engine_factory")
            logger.error(
                "train supervisor PARKED: recovery needs an engine_factory "
                f"({'wedged step' if needs_fresh_engine else 'no checkpoint yet'})")
            return False
        logger.warning(f"train supervisor: restart {n} in {backoff:.2f}s")
        if self._preempt.wait(backoff):
            return True                 # run() reports the preemption
        t0 = time.monotonic()
        if needs_fresh_engine or not has_checkpoint:
            self._engine = self.engine_factory()
        restored = self._restore_latest()
        step_at_exit = int(box.get("step_at_exit") or 0)
        steps_lost = max(0, step_at_exit - self._engine.global_steps)
        self.stats["train_restarts"] += 1
        self.stats["steps_lost"] += steps_lost
        if reason == "anomaly":
            # counted after the restore: a parked storm rolled nothing back
            self.stats["anomaly_rollbacks"] += 1
            self.journal.emit("train_anomaly_rollback",
                              step=step_at_exit,
                              resumed_step=int(self._engine.global_steps))
        recovery_s = time.monotonic() - t0
        self.journal.emit("train_restart", reason=reason, attempt=n,
                          steps_lost=steps_lost,
                          resumed_step=int(self._engine.global_steps),
                          recovery_s=round(recovery_s, 4))
        self.restart_log.append({
            "reason": reason, "attempt": n,
            "from_step": step_at_exit,
            "resumed_step": int(self._engine.global_steps),
            "steps_lost": steps_lost, "restored": restored,
            "backoff_s": backoff, "recovery_s": recovery_s})
        self._engine.tracer.begin(
            "train_restart", trace_id="train",
            attrs={"reason": reason, "attempt": n,
                   "steps_lost": steps_lost,
                   "resumed_step": int(self._engine.global_steps)}).end()
        if reason != "wedge" and self._engine.tracer.enabled:
            # wedges dumped before the restart; crash and anomaly restarts
            # dump under telemetry only, as serving restarts do
            self._dump_flight_recorder(self._engine, f"train_{reason}")
        logger.warning(
            f"train supervisor: restarted from step "
            f"{self._engine.global_steps} ({reason}; {steps_lost} steps "
            f"lost; {recovery_s:.2f}s)")
        return True

    # ------------------------------------------------------------- telemetry
    def _dump_flight_recorder(self, engine, reason: str) -> None:
        """Post-incident record: the spans in flight at the wedge or crash
        and the registered metrics providers. Never raises."""
        try:
            from ..telemetry.flight_recorder import FlightRecorder

            if self._recorder is None or self._recorder.tracer is not engine.tracer:
                self._recorder = FlightRecorder(engine.tracer)
            self._recorder.snapshot_metrics()
            self.dump_paths.append(self._recorder.dump(reason=reason))
        except Exception as e:  # pragma: no cover - defensive
            logger.warning(f"train flight-recorder dump failed: {e!r}")

    # --------------------------------------------------------------- signals
    def _install_sigterm(self) -> None:
        if not self.config.handle_sigterm:
            return
        if threading.current_thread() is not threading.main_thread():
            return
        try:
            self._prev_handler = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
            self._signal_installed = True
        except (ValueError, OSError):   # non-main interpreter contexts
            self._signal_installed = False

    def _restore_sigterm(self) -> None:
        if self._signal_installed:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler
                              if self._prev_handler is not None
                              else signal.SIG_DFL)
            except (ValueError, OSError):  # pragma: no cover - defensive
                pass
            self._signal_installed = False

    def _on_sigterm(self, signum, frame) -> None:
        # a signal handler only sets the flag; the step loop acts on it
        self._preempt.set()

    def _deliver_sigterm(self) -> None:
        """Injected preemption: a real SIGTERM through the installed
        handler when there is one, else the flag directly. Waits for the
        flag so that the worker exits before another step."""
        if self._signal_installed:
            signal.raise_signal(signal.SIGTERM)
        else:
            self._preempt.set()
        self._preempt.wait(5.0)

    # --------------------------------------------------------- health report
    def health_report(self, recent_events: int = 20) -> Dict[str, Any]:
        """Progress, the resilience counters, the restart log's tail, the
        open anomaly streak and the recent journal events in one dict."""
        return {
            "wall_time": time.time(),
            "global_step": int(self._engine.global_steps),
            "parked": bool(self.stats["parked"]),
            "preempt_pending": self._preempt.is_set(),
            "anomaly_streak": int(self._anomaly_streak),
            "counters": {k: self.stats[k] for k in
                         ("train_restarts", "steps_lost",
                          "anomaly_rollbacks", "preemptions", "wedges")},
            "urgent_save_s": self.stats["urgent_save_s"],
            "restart_log": list(self.restart_log[-5:]),
            "events": self.journal.events(limit=recent_events),
        }

    def health_report_text(self, recent_events: int = 10) -> str:
        """The training health report rendered for a terminal."""
        r = self.health_report(recent_events=recent_events)
        c = r["counters"]
        lines = [
            "== training health ==",
            f"step={r['global_step']}"
            + ("  PARKED" if r["parked"] else "")
            + ("  PREEMPT-PENDING" if r["preempt_pending"] else "")
            + (f"  anomaly_streak={r['anomaly_streak']}"
               if r["anomaly_streak"] else ""),
            f"restarts={c['train_restarts']} steps_lost={c['steps_lost']} "
            f"rollbacks={c['anomaly_rollbacks']} "
            f"preemptions={c['preemptions']} wedges={c['wedges']}",
        ]
        if r["events"]:
            lines.append("recent events:")
            lines.append(self.journal.render_text(limit=recent_events))
        return "\n".join(lines)

    # ---------------------------------------------------------------- status
    def _status(self, status: str) -> Dict[str, Any]:
        out = {"status": status,
               "completed_steps": int(self._engine.global_steps),
               "restarts": len(self.restart_log),
               "restart_log": list(self.restart_log),
               "dump_paths": list(self.dump_paths)}
        out.update(self.stats)
        return out

