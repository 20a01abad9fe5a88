"""Deterministic fault-injection harness for the serving stack.

Production fault tolerance that is only exercised by production faults is
untested fault tolerance. This module makes failure *schedulable*: a
seeded :class:`FaultInjector` fires scripted faults at exact points in a
replica's life — crash at scheduler-step k, wedge (block the worker loop)
for t seconds, ``engine.put`` raising, slow-forward latency — so the
chaos suite (tests/test_fault_tolerance.py) and ``bench.py``'s chaos
phase replay the same failure story every run.

Wiring is test-only and zero-cost when off: the ``faults:`` config block
(docs/CONFIG.md) builds the injector; :class:`Replica` consults
``on_step`` once per work iteration and wraps its engine in
:class:`_FaultyEnginePut` *only* when a put-level fault targets that
replica. ``faults.enabled: false`` (the default) installs nothing —
byte-for-byte the uninstrumented serving stack.

Step indices count *scheduler steps* (work actually done), not idle loop
spins, so a schedule is deterministic given deterministic traffic; a
restarted replica's fresh scheduler counts from 0 again, which is what
lets ``count: 0`` ("every time") model a persistently-crashing replica
for circuit-breaker tests.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Dict, List, Optional

from ..utils.locks import RankedLock

KINDS = ("crash", "wedge", "put_error", "slow_forward")
_STEP_KINDS = ("crash", "wedge")
_PUT_KINDS = ("put_error", "slow_forward")


class InjectedFault(RuntimeError):
    """The scripted failure. Deliberately a plain RuntimeError subclass:
    the serving stack must treat it exactly like a real engine fault
    (no special-casing — that would test the injector, not the
    recovery)."""


@dataclasses.dataclass
class FaultEvent:
    kind: str                       # one of KINDS
    replica: int                    # target replica id
    at_step: Optional[int] = None   # scheduler-step index (crash/wedge)
    at_put: Optional[int] = None    # engine.put call index (put faults)
    duration_s: float = 0.0         # wedge sleep / slow_forward latency
    count: int = 1                  # firings allowed; 0 = every time
    error: str = "injected fault"
    fired: int = 0

    def _matches(self, index: int, attr: str) -> bool:
        at = getattr(self, attr)
        if at is None:
            return False
        if self.count != 0 and self.fired >= self.count:
            return False
        return index >= at


class FaultInjector:
    """Seeded, thread-safe schedule of :class:`FaultEvent`.

    ``at_step_range: [lo, hi]`` entries draw their step from the seeded
    RNG at construction — a *seeded schedule*: different seeds explore
    different failure points, the same seed replays exactly."""

    # ``events`` is immutable after construction (schedule built in
    # __init__); only the firing ledger is multi-writer
    _GUARDED_BY = {"fired_log": "_lock"}

    def __init__(self, schedule: List[Dict[str, Any]], seed: int = 0):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self.events: List[FaultEvent] = []
        for raw in schedule:
            e = dict(raw)
            rng_range = e.pop("at_step_range", None)
            ev = FaultEvent(**e)
            if rng_range is not None:
                ev.at_step = self.rng.randint(int(rng_range[0]),
                                              int(rng_range[1]))
            if ev.kind not in KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r} "
                                 f"(expected one of {KINDS})")
            if ev.kind in _STEP_KINDS and ev.at_step is None:
                raise ValueError(f"{ev.kind} fault needs at_step "
                                 "(or at_step_range)")
            if ev.kind in _PUT_KINDS and ev.at_put is None:
                raise ValueError(f"{ev.kind} fault needs at_put")
            self.events.append(ev)
        self._lock = RankedLock("serving.faults")
        # (kind, replica, index, monotonic t) per firing — what the chaos
        # tests and the bench chaos phase assert against / report
        self.fired_log: List[tuple] = []

    # ----------------------------------------------------------- matching
    def _take(self, kinds, replica_id: int, index: int,
              attr: str) -> List[FaultEvent]:
        with self._lock:
            hits = [ev for ev in self.events
                    if ev.kind in kinds and ev.replica == replica_id
                    and ev._matches(index, attr)]
            for ev in hits:
                ev.fired += 1
                self.fired_log.append((ev.kind, replica_id, index,
                                       time.monotonic()))
        return hits

    def fired_events(self) -> List[tuple]:
        with self._lock:
            return list(self.fired_log)

    # -------------------------------------------------------------- hooks
    def on_step(self, replica_id: int, step_index: int) -> None:
        """Replica-loop hook, called once per work iteration *before*
        ``scheduler.step``. Wedges sleep here (the loop blocks — exactly
        the stuck-device-call shape the wedge watchdog detects); a crash
        raises :class:`InjectedFault` into the loop's normal engine-fault
        path."""
        for ev in self._take(_STEP_KINDS, replica_id, step_index, "at_step"):
            if ev.kind == "wedge":
                time.sleep(ev.duration_s)
            else:
                raise InjectedFault(
                    f"{ev.error} (crash: replica {replica_id} "
                    f"step {step_index})")

    def on_put(self, replica_id: int, put_index: int) -> None:
        """Engine-proxy hook, called per ``engine.put``."""
        for ev in self._take(_PUT_KINDS, replica_id, put_index, "at_put"):
            if ev.kind == "slow_forward":
                time.sleep(ev.duration_s)
            else:
                raise InjectedFault(
                    f"{ev.error} (put_error: replica {replica_id} "
                    f"put {put_index})")

    def wrap_engine(self, engine, replica_id: int):
        """Proxy ``engine`` when a put-level fault targets this replica;
        otherwise return it untouched (no proxy on unfaulted replicas —
        injection must not perturb what it doesn't target)."""
        if any(ev.kind in _PUT_KINDS and ev.replica == replica_id
               for ev in self.events):
            return _FaultyEnginePut(engine, self, replica_id)
        return engine


class _FaultyEnginePut:
    """Duck-typed engine proxy: ``put`` consults the injector first,
    everything else delegates. The wrapped engine stays reachable as
    ``_ft_inner`` (the supervisor unwraps before re-wrapping a salvaged
    engine, so restarts never stack proxies)."""

    def __init__(self, inner, injector: FaultInjector, replica_id: int):
        self._ft_inner = inner
        self._ft_injector = injector
        self._ft_replica = replica_id
        self._ft_puts = 0

    def put(self, *args, **kwargs):
        n = self._ft_puts
        self._ft_puts += 1
        self._ft_injector.on_put(self._ft_replica, n)
        return self._ft_inner.put(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_ft_inner"), name)
