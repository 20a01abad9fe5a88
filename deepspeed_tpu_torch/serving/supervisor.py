"""Replica supervision: restart DEAD replicas instead of shrinking forever.

Before this layer, failure was visible but permanent: the wedge watchdog
and the engine-fault path mark a replica DEAD and the router routes
around the corpse — one exception per replica and the fleet is gone. The
supervisor closes the loop (docs/SERVING.md "Fault tolerance"): a
monitor thread notices DEAD replicas, schedules a restart with
exponential backoff + deterministic seeded jitter, builds a *fresh*
engine + Replica via the frontend's factories, and swaps it into the
router's slot. A circuit breaker bounds the blast radius: N crashes
inside a sliding window *parks* the slot — no more restarts, the
``capacity_alarm`` gauge goes up, and the remaining fleet (plus the
admission queue's brownout mode) absorbs what it can.

Restart safety rules:

- A replica whose worker thread is still alive (wedged inside a device
  call) can only be restarted onto a **fresh** engine — the stuck thread
  owns the old one. Without an ``engine_factory`` the slot is parked
  rather than risk two threads driving one engine.
- A replica whose thread exited (clean crash) may reuse its engine when
  no factory exists; leftover sequences are flushed best-effort first so
  the KV pool doesn't leak across the restart.
- The dead replica's requests were already handed back through the
  failover path before the restart (Replica fails/failovers them the
  moment it goes DEAD); the supervisor only restores *capacity*.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, List, Optional

from ..utils.locks import RankedLock
from ..utils.logging import logger
from ..utils.restart import RestartPolicy
from .config import FaultToleranceConfig
from .replica import ReplicaState


class _Slot:
    """Supervision state for one replica id in the router. Ids are the
    stable identity (dynamic membership means list positions shift —
    docs/SERVING.md "Elastic autoscaling"); ``retired`` marks a slot the
    autoscaler removed, so a restart build already in flight knows to
    drop its replacement instead of resurrecting removed capacity."""

    def __init__(self, replica_id: int, policy: RestartPolicy):
        self.replica_id = replica_id
        self.policy = policy            # shared backoff/breaker discipline
        self.restart_at: Optional[float] = None
        self.backoff_s = 0.0
        self.restarting = False
        self.parked = False
        self.retired = False


class ReplicaSupervisor:
    # lock discipline (docs/CONCURRENCY.md): the slot table and the
    # restart ledger are shared between the supervisor loop, the
    # autoscaler's retire path and the frontend's membership admin.
    _GUARDED_BY = {"_slots": "_lock", "restart_log": "_lock"}

    def __init__(self, router, replica_factory: Callable,
                 engine_factory: Optional[Callable],
                 config: Optional[FaultToleranceConfig] = None,
                 metrics=None, tracer=None, recorder=None, journal=None):
        from ..telemetry import NOOP_TRACER

        self.router = router
        self.replica_factory = replica_factory   # (replica_id, engine) -> Replica
        self.engine_factory = engine_factory     # (replica_id) -> engine, or None
        self.config = config or FaultToleranceConfig(enabled=True)
        self.metrics = metrics
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.recorder = recorder
        # ops journal (telemetry/journal.py): restart/park transitions
        # become durable queryable events, not just log lines
        self.journal = journal
        self.rng = random.Random(self.config.seed)
        # slots keyed by replica id (stable under dynamic membership);
        # register_slot/retire_slot keep this in step with the router
        self._slots: dict = {
            r.replica_id: _Slot(r.replica_id, self._new_policy())
            for r in router.replicas}
        self._lock = RankedLock("serving.supervisor")
        # per-restart records: {"replica", "t_dead", "t_restarted",
        # "backoff_s", "attempt"} — the bench chaos phase's
        # recovery_time_s = t_restarted - t_dead
        self.restart_log: List[dict] = []
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="serving-supervisor")

    def start(self) -> None:
        self.thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self.thread.is_alive():
            self.thread.join(timeout)

    def _new_policy(self) -> RestartPolicy:
        cfg = self.config
        return RestartPolicy(
            cfg.restart_backoff_s, cfg.restart_backoff_max_s,
            cfg.restart_backoff_jitter, cfg.max_restarts_in_window,
            cfg.restart_window_s, self.rng)

    # ---------------------------------------------------------- membership
    def register_slot(self, replica_id: int) -> None:
        """Supervise a replica the autoscaler just added (fresh backoff/
        breaker state — a new slot inherits no other slot's crash
        history)."""
        with self._lock:
            if replica_id in self._slots:
                raise ValueError(f"slot {replica_id} already supervised")
            self._slots[replica_id] = _Slot(replica_id, self._new_policy())

    def retire_slot(self, replica_id: int) -> bool:
        """Stop supervising a replica the autoscaler is removing. Any
        pending restart is cancelled (restart_at cleared) and a restart
        BUILD already in flight is poisoned via ``slot.retired`` — its
        replacement is dropped before install, so a restart can never
        race a removal into a leaked live replica (the
        shutdown-race guard extended to per-slot retirement). Recomputes
        the parked gauges: a retired parked slot stops counting."""
        with self._lock:
            slot = self._slots.pop(replica_id, None)
            if slot is None:
                return False
            slot.retired = True
            slot.restart_at = None
            self._refresh_parked_locked()
        return True

    def _refresh_parked_locked(self) -> None:
        if self.metrics is None:
            return
        parked = sum(1 for s in self._slots.values() if s.parked)
        self.metrics.gauge("replicas_parked").set(parked)
        self.metrics.gauge("capacity_alarm").set(1.0 if parked else 0.0)

    # ------------------------------------------------------------- queries
    def recovery_pending(self) -> bool:
        """True while ANY dead capacity is expected back (a restart is
        scheduled, in flight, or a fresh DEAD not yet ticked). The router
        consults this before failing work with "no_replicas": a
        recoverable fleet holds requests instead of bouncing them."""
        with self._lock:
            for slot in self._slots.values():
                if slot.parked:
                    continue
                if slot.restart_at is not None or slot.restarting:
                    return True
                replica = self.router.replica_by_id(slot.replica_id)
                if replica is not None and \
                        replica.state == ReplicaState.DEAD:
                    return True
        return False

    def parked_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots.values() if s.parked)

    def parked_ids(self) -> List[int]:
        """Replica ids of circuit-broken slots — the autoscaler's
        preferred shrink victims (docs/SERVING.md "Elastic
        autoscaling")."""
        with self._lock:
            return sorted(s.replica_id for s in self._slots.values()
                          if s.parked)

    # ---------------------------------------------------------------- loop
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # pragma: no cover - defensive
                # supervision must never die of its own bug: a broken
                # tick this round is retried next round
                logger.error(f"serving supervisor tick failed: {e!r}")
            self._stop.wait(self.config.supervisor_poll_s)

    def tick(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.monotonic()
        with self._lock:
            slots = list(self._slots.values())
        for slot in slots:
            replica = self.router.replica_by_id(slot.replica_id)
            if replica is None or slot.retired:
                continue            # retired mid-tick: nothing to do
            state = replica.check_health(now)
            if slot.parked or state != ReplicaState.DEAD:
                continue
            if slot.restarting:
                continue
            if slot.restart_at is None:
                self._on_crash(slot, now)
            elif now >= slot.restart_at:
                self._restart(slot, now)

    # ------------------------------------------------------------- crashes
    def _on_crash(self, slot: _Slot, now: float) -> None:
        with self._lock:
            n, backoff = slot.policy.record_failure(now)
            if backoff is None:         # circuit breaker tripped
                self._park_locked(slot, n)
                return
            slot.restart_at = now + backoff
            slot.backoff_s = backoff
        logger.warning(f"serving replica {slot.replica_id} dead (crash "
                       f"{n} in window); restart in {backoff:.2f}s")

    def _park_locked(self, slot: _Slot, n_crashes: int) -> None:
        """Circuit breaker: stop restarting a slot that keeps dying —
        restart loops burn engine builds and requeue storms without adding
        capacity. Raises the capacity alarm; operators un-park by fixing
        the cause and restarting the frontend."""
        slot.parked = True
        slot.restart_at = None
        parked = sum(1 for s in self._slots.values() if s.parked)
        logger.error(f"serving replica {slot.replica_id} PARKED after "
                     f"{n_crashes} crashes in "
                     f"{self.config.restart_window_s:.0f}s window "
                     f"({parked}/{len(self._slots)} slots parked)")
        if self.metrics is not None:
            self.metrics.gauge("replicas_parked").set(parked)
            self.metrics.gauge("capacity_alarm").set(1.0)
        if self.journal is not None:
            self.journal.emit("replica_parked", replica=slot.replica_id,
                              crashes_in_window=n_crashes,
                              parked_total=parked)
        if self.tracer.enabled:
            self.tracer.begin("replica_parked",
                              trace_id=f"replica-{slot.replica_id}",
                              attrs={"crashes_in_window": n_crashes}).end()

    # ------------------------------------------------------------- restart
    def _salvage_engine(self, old_replica):
        """Engine for the restart when no factory exists: reuse the dead
        replica's engine only if its worker thread has exited (a thread
        still stuck in a device call owns the engine — returns None, the
        slot parks). Unwraps any fault-injection proxy (the factory path
        re-wraps) and flushes leftover sequences so KV blocks return."""
        if old_replica.thread.is_alive():
            return None
        sched = getattr(old_replica, "scheduler", None)
        if sched is None:
            # remote handle (docs/SERVING.md "Multi-host serving"):
            # there is no in-process engine to salvage — peer slots
            # normally restart through the frontend's _PeerRef engine
            # source; reaching here means no factory at all, so park
            return None
        engine = getattr(old_replica.engine, "_ft_inner", old_replica.engine)
        for uid in list(sched.running) + [r.uid for r in sched.pending]:
            try:
                engine.flush(uid)
            except Exception:
                pass
        return engine

    def _restart(self, slot: _Slot, now: float) -> None:
        if self._stop.is_set():
            return
        with self._lock:
            slot.restarting = True
            slot.restart_at = None
        rid = slot.replica_id
        old = self.router.replica_by_id(rid)
        if old is None:
            with self._lock:
                slot.restarting = False
            return                  # slot removed between tick and here
        t_dead = slot.policy.last_failure_time()
        t_dead = t_dead if t_dead is not None else now
        try:
            if self.recorder is not None and self.tracer.enabled:
                # dump the evidence (spans in flight at death, metric
                # history) BEFORE the slot's story is overwritten by the
                # replacement — the post-incident record
                try:
                    self.recorder.snapshot_metrics()
                    self.recorder.dump(
                        reason=f"restart_replica-{rid}")
                except Exception:  # pragma: no cover - defensive
                    pass
            engine = None
            if self.engine_factory is not None:
                # a factory may decline a specific slot with None (the
                # frontend's fabric engine source does this for local
                # slots when the caller passed no factory) — that slot
                # falls through to the historical salvage path
                engine = self.engine_factory(rid)
            fresh = engine is not None
            if engine is None:
                engine = self._salvage_engine(old)
            if engine is None:
                with self._lock:
                    self._park_locked(slot, slot.policy.count())
                return
            attempt = slot.policy.count()
            span = self.tracer.begin(
                "replica_restart", trace_id=f"replica-{rid}",
                attrs={"attempt": attempt,
                       "backoff_s": round(getattr(slot, "backoff_s", 0.0), 4),
                       "fresh_engine": fresh}) \
                if self.tracer.enabled else None
            replacement = self.replica_factory(rid, engine)
            if self._stop.is_set() or slot.retired:
                # shutdown OR slot retirement raced the (possibly long)
                # engine build: installing + starting now
                # would leak a live worker past ServingFrontend.shutdown
                # / resurrect capacity the autoscaler removed — drop the
                # replacement instead (it was never started)
                if span is not None:
                    span.end()
                return
            displaced = self.router.replace_replica(rid, replacement)
            if displaced is None:
                # membership changed underneath us (slot removed): the
                # replacement has no seat — drop it, never start it
                if span is not None:
                    span.end()
                return
            # stop what the swap actually displaced (a concurrent swap
            # could have changed the slot since ``old`` was looked up),
            # and the looked-up corpse too if they differ
            displaced.stop(timeout=0.0)
            if displaced is not old:
                old.stop(timeout=0.0)
            if span is not None:
                span.end()
            t_up = time.monotonic()
            with self._lock:
                self.restart_log.append({
                    "replica": rid, "t_dead": t_dead,
                    "t_restarted": t_up,
                    "recovery_s": t_up - t_dead,
                    "backoff_s": getattr(slot, "backoff_s", 0.0),
                    "attempt": attempt})
            if self.metrics is not None:
                self.metrics.counter("replica_restarts").inc()
            if self.journal is not None:
                self.journal.emit(
                    "replica_restart", replica=rid, attempt=attempt,
                    recovery_s=round(t_up - t_dead, 4),
                    backoff_s=round(getattr(slot, "backoff_s", 0.0), 4),
                    fresh_engine=fresh)
            logger.warning(f"serving replica {rid} restarted "
                           f"(attempt {attempt}, "
                           f"{t_up - t_dead:.2f}s after death)")
        except Exception as e:
            # a failed restart (engine build blew up) counts as a crash:
            # backoff again or trip the breaker — never busy-loop
            logger.error(f"serving replica {rid} restart failed: "
                         f"{e!r}")
            self._on_crash(slot, time.monotonic())
        finally:
            with self._lock:
                slot.restarting = False
