"""Replica router: admission queue → least-loaded healthy replica handle.

The router speaks to engine *handles* (fabric/handle.py
``HANDLE_SURFACE``), never to engines or threads: an entry of
``self.replicas`` is an in-process :class:`Replica`/``LocalHandle`` or a
cross-process :class:`~deepspeed_tpu_torch.serving.fabric.remote.RemoteHandle`
— selection, health sweeps, drain and membership mutations are identical
either way (docs/SERVING.md "Multi-host serving").

A dispatcher thread pops the highest-urgency request from the
:class:`AdmissionQueue` and assigns it to the *accepting* replica with the
fewest outstanding tokens (prompt backlog + remaining generation budget) —
the load signal that tracks actual engine work, unlike request counts,
under mixed prompt lengths. Each dispatch also runs the wedge check: a
replica that stopped making progress is marked DEAD and simply drops out
of the candidate set, so the service degrades to the surviving capacity
instead of queueing behind a stuck device call. With *no* healthy replica
the router fails requests fast with reason "no_replicas" rather than
letting streams hang — unless a supervisor reports recovery pending
(docs/SERVING.md "Fault tolerance"), in which case requests are *held*
for the restarting capacity (deadline-aware) instead of bounced off a
transiently-empty fleet. The health sweep also feeds the healthy-capacity
fraction to the admission queue's brownout mode.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from ..utils.locks import RankedLock
from ..utils.logging import logger
from .metrics import MetricsRegistry
from .queue import AdmissionQueue
from .replica import Replica, ReplicaState
from .request import FinishReason, RequestState, ServingRequest


#: replica roles able to run each phase of a request (docs/SERVING.md
#: "Disaggregated serving"): decode-role replicas CAN prefill (their
#: scheduler merely reserves decode budget), so they are the spillover
#: for prefill-phase work when no prefill-capable replica accepts;
#: prefill-role replicas can never decode, so decode-phase work (a
#: staged KV handoff, or a recompute fallback) must land decode-capable.
PREFILL_CAPABLE = ("prefill", "mixed")
DECODE_CAPABLE = ("decode", "mixed")


class ReplicaRouter:
    # lock discipline (docs/CONCURRENCY.md): the replica list is the
    # rebind-under-lock / lock-free-snapshot-read publication pattern —
    # every structural WRITE holds the membership lock; readers take
    # ``self.replicas`` as an immutable snapshot (writes-only mode).
    _GUARDED_BY = {"replicas": "_membership_lock:writes"}

    def __init__(self, replicas: List[Replica], admission: AdmissionQueue,
                 metrics: Optional[MetricsRegistry] = None,
                 poll_interval_s: float = 0.05,
                 tracer=None, recorder=None, disaggregation=None,
                 tick_hooks=None, tenancy=None, affinity=None):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        from ..telemetry import NOOP_TRACER

        # AffinityState when fleet KV locality is on (docs/SERVING.md
        # "Fleet KV locality"): pick(req) scores prefix-digest overlap
        # into the cost as a prefill-token credit; digests refresh on
        # the router tick. None = the cache-blind pick, byte for byte.
        self.affinity = affinity
        # DisaggregationConfig when the pool is role-split (docs/
        # SERVING.md "Disaggregated serving"): selection becomes
        # phase-aware and the load signal becomes the weighted
        # prefill-cost vs decode-cost model. None = the historical
        # unweighted least-outstanding-tokens router, byte for byte.
        self.disaggregation = disaggregation
        # TenantLedger when tenancy is on (docs/SERVING.md "Multi-model
        # & multi-tenant serving"): dispatches charge fair-share service
        # and KV budgets; selection filters replicas where the tenant's
        # KV budget is exhausted. None = no per-dispatch accounting.
        self.tenancy = tenancy
        self.replicas = list(replicas)
        # dynamic membership (docs/SERVING.md "Elastic autoscaling"):
        # every structural mutation of ``self.replicas`` — add, remove,
        # restart swap — happens under this lock and rebinds/writes the
        # list atomically, so lock-free readers (the dispatch loop, the
        # health sweep, health_report) always see a consistent fleet
        self._membership_lock = RankedLock("serving.router.membership",
                                           reentrant=True)
        self.admission = admission
        self.metrics = metrics
        # request tracing + periodic flight-recorder metric snapshots
        # (docs/OBSERVABILITY.md); both default to no-ops
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.recorder = recorder
        # ~1/s observability hooks run every loop iteration alongside the
        # flight-recorder snapshot: windowed-metrics ticks and SLO alert
        # evaluation (docs/OBSERVABILITY.md "SLOs and burn-rate alerts").
        # Each hook is cadence-gated internally and exception-isolated
        # here — observability must never kill the dispatcher.
        self.tick_hooks = list(tick_hooks) if tick_hooks else []
        self.poll_interval_s = poll_interval_s
        # attached by the frontend when fault_tolerance is enabled; the
        # supervisor swaps restarted replicas in via replace_replica
        self.supervisor = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="serving-router")

    def start(self) -> None:
        for r in self.replicas:
            r.start()
        self.thread.start()

    # ------------------------------------------------------------ selection
    def healthy_replicas(self) -> List[Replica]:
        # one membership snapshot for the whole sweep: counts, gauges
        # and the brownout fraction must describe the same fleet even
        # while the autoscaler mutates membership concurrently
        reps = self.replicas
        out = []
        for r in reps:
            if r.check_health() == ReplicaState.HEALTHY:
                out.append(r)
        if self.metrics is not None:
            live = [r for r in reps
                    if r.state not in (ReplicaState.DEAD,
                                       ReplicaState.STOPPED)]
            self.metrics.gauge("replicas_healthy").set(len(out))
            self.metrics.gauge("replicas_quarantined").set(
                sum(1 for r in reps
                    if r.state == ReplicaState.QUARANTINED))
            self.metrics.gauge("outstanding_tokens").set(
                sum(r.outstanding_tokens for r in live))
            self.metrics.gauge("outstanding_prefill_tokens").set(
                sum(r.outstanding_prefill_tokens for r in live))
            self.metrics.gauge("outstanding_decode_tokens").set(
                sum(r.outstanding_decode_tokens for r in live))
            # fleet-shape gauges (docs/SERVING.md "Elastic
            # autoscaling"): accepting replicas per role, refreshed on
            # the same sweep — and from the same membership snapshot —
            # that feeds replicas_healthy
            for role, n in self.role_census(reps).items():
                self.metrics.gauge(f"replicas_role_{role}").set(n)
        # brownout feed: the queue shrinks and sheds lowest-urgency work
        # when this fraction drops below its threshold (no-op otherwise)
        self.admission.set_healthy_fraction(len(out) / max(1, len(reps)))
        return out

    @staticmethod
    def _needs_decode_role(req) -> bool:
        """Decode-phase work: a staged KV handoff (the prefill already
        ran elsewhere) or a recompute fallback that must not loop
        through another prefill-only replica."""
        return req.staged_kv is not None or req.no_prefill

    def _cost(self, r: Replica):
        """Replica load for selection. Disaggregated: the weighted
        prefill-remaining vs decode-remaining model — a pending
        2000-token prefill is a handful of chunked forwards while 2000
        owed decode tokens are 2000 forwards, so weighing them equally
        (the historical signal) herds latency-critical work onto
        prefill-loaded replicas. Disabled: the historical unweighted
        sum, byte for byte."""
        dis = self.disaggregation
        if dis is None:
            return (r.outstanding_tokens, r.replica_id)
        return (r.outstanding_prefill_tokens * dis.prefill_token_cost
                + r.outstanding_decode_tokens * dis.decode_token_cost,
                r.replica_id)

    @staticmethod
    def _model_of(r) -> str:
        return getattr(r, "model_id", "default")

    def pick(self, req=None) -> Optional[Replica]:
        """Least-loaded over accepting replicas with a free concurrency
        slot. Heterogeneous fleets (docs/SERVING.md "Multi-model &
        multi-tenant serving") first pin the candidate set to the
        request's model pool — a request can never land on a replica of
        a different model — and tenancy filters out replicas where the
        tenant's KV block budget is exhausted. Role-split pools
        (docs/SERVING.md "Disaggregated serving") also filter by the
        request's phase: decode-phase work only lands decode-capable;
        prefill-phase work prefers prefill-capable and spills to
        decode-role replicas only when no prefill-capable replica is
        accepting at all (they run the request end to end —
        availability beats specialization)."""
        candidates = [r for r in self.healthy_replicas()
                      if r.accepting and r.has_capacity]
        if req is not None:
            candidates = [r for r in candidates
                          if self._model_of(r) == req.model_id]
            if self.tenancy is not None:
                candidates = [r for r in candidates
                              if self.tenancy.admits_kv(req, r)]
        if self.disaggregation is not None and req is not None:
            if self._needs_decode_role(req):
                candidates = [r for r in candidates
                              if r.role in DECODE_CAPABLE]
            else:
                preferred = [r for r in candidates
                             if r.role in PREFILL_CAPABLE]
                if preferred or any(r.accepting and r.role in PREFILL_CAPABLE
                                    and self._model_of(r) == req.model_id
                                    for r in self.replicas):
                    # prefill-capable capacity exists (maybe busy): wait
                    # for it rather than full-running on a decode replica
                    candidates = preferred
        if not candidates:
            return None
        aff = self.affinity
        if aff is not None and req is not None:
            # fleet KV locality (docs/SERVING.md "Fleet KV locality"):
            # the request's block chain is hashed ONCE here, overlap
            # credits are memoized per candidate inside choose(), and
            # None (no hashable prefix / no warm replica) falls through
            # to the cache-blind selection below. The _loop free-slot
            # probe passes req=None and never enters this branch.
            choice = aff.choose(
                req, candidates, self._cost,
                self._kv_block_size(candidates),
                (self.disaggregation.prefill_token_cost
                 if self.disaggregation is not None else 1.0))
            if choice is not None:
                return choice
        return min(candidates, key=self._cost)

    @staticmethod
    def _kv_block_size(candidates) -> int:
        """The fleet's KV block size for chain hashing, from the first
        candidate that exposes one (remote handles mirror it from the
        hello exchange). Fleets are block-size-homogeneous — a mixed
        fleet would already break prefix handoff and tier restore."""
        for r in candidates:
            bs = getattr(getattr(r, "engine", None), "config", None)
            bs = getattr(bs, "kv_block_size", None)
            if bs:
                return int(bs)
        return 16

    def _any_accepting(self) -> bool:
        return any(r.accepting for r in self.replicas)

    def _any_accepting_for(self, req) -> bool:
        """Phase- and model-aware liveness: a request is only
        dispatchable to accepting replicas of ITS model pool, and
        decode-phase work only to decode-capable ones — a fleet where
        just prefill-role slots (or only other models' pools) survive
        cannot finish it."""
        pool = [r for r in self.replicas
                if self._model_of(r) == req.model_id]
        if self.disaggregation is None or not self._needs_decode_role(req):
            return any(r.accepting for r in pool)
        return any(r.accepting and r.role in DECODE_CAPABLE for r in pool)

    def _any_quarantined_for(self, req) -> bool:
        """Gray-failure hold signal: quarantined capacity is EXPECTED
        back (probe re-admission on backoff, docs/SERVING.md "Fleet
        fault tolerance") — a fleet whose only capacity for this request
        is quarantined should hold the request like a supervised
        restart, not bounce it with "no_replicas"."""
        return any(r.state == ReplicaState.QUARANTINED
                   and self._model_of(r) == req.model_id
                   for r in self.replicas)

    def _dispatchable_filter(self):
        """Pop-time predicate for the admission queue (None for the
        historical homogeneous single-role tenancy-off fleet = the
        historical pop). Snapshot which model pools / phases currently
        have a free slot, so the single dispatcher thread never pops a
        request it cannot place — a staged decode request (or a request
        for a saturated model pool, or a KV-budget-exhausted tenant) at
        the head of the queue must not head-of-line-block work that
        other idle replicas could take. Capacity can shift between
        snapshot and dispatch; _dispatch's poll loop absorbs that rare
        race."""
        reps = self.replicas
        multi_model = len({self._model_of(r) for r in reps}) > 1
        if self.disaggregation is None and not multi_model \
                and self.tenancy is None:
            return None
        free = [r for r in reps
                if r.accepting and r.has_capacity
                and r.state == ReplicaState.HEALTHY]

        def accept(req):
            pool = [r for r in free if self._model_of(r) == req.model_id]
            if self.tenancy is not None:
                pool = [r for r in pool
                        if self.tenancy.admits_kv(req, r)]
            if self.disaggregation is None:
                return bool(pool)
            if self._needs_decode_role(req):
                return any(r.role in DECODE_CAPABLE for r in pool)
            if any(r.role in PREFILL_CAPABLE for r in pool):
                return True
            # spillover: no prefill-capable replica of this model
            # accepting at all → a free decode-capable one runs the
            # request end to end
            prefill_accepting = any(
                r.accepting and r.role in PREFILL_CAPABLE
                and self._model_of(r) == req.model_id for r in reps)
            return (not prefill_accepting
                    and any(r.role in DECODE_CAPABLE for r in pool))
        return accept

    def role_census(self, replicas=None) -> dict:
        """Accepting-replica count per role — the fleet-shape answer the
        autoscaler and the ``replicas_role_{prefill,decode,mixed}``
        gauges read (docs/SERVING.md "Elastic autoscaling"). Every role
        key is always present (zero-valued when empty) so dashboards
        see the fleet shape before traffic. ``replicas`` lets the
        health sweep pass its own membership snapshot so all its gauges
        describe the same fleet."""
        census = {"prefill": 0, "decode": 0, "mixed": 0}
        for r in (self.replicas if replicas is None else replicas):
            if r.accepting:
                role = getattr(r, "role", "mixed")
                census[role] = census.get(role, 0) + 1
        return census

    def drain_replica(self, replica_id: int) -> None:
        for r in self.replicas:
            if r.replica_id == replica_id:
                r.drain()
                return
        raise KeyError(f"no replica {replica_id}")

    # ----------------------------------------------------------- membership
    def replica_by_id(self, replica_id: int) -> Optional[Replica]:
        for r in self.replicas:
            if r.replica_id == replica_id:
                return r
        return None

    def add_replica(self, replica: Replica) -> None:
        """Grow the fleet by one (docs/SERVING.md "Elastic
        autoscaling"): atomic list rebind + start. Replica ids must be
        unique — the frontend allocates them monotonically."""
        with self._membership_lock:
            if self.replica_by_id(replica.replica_id) is not None:
                raise ValueError(f"replica id {replica.replica_id} "
                                 "already in the fleet")
            self.replicas = self.replicas + [replica]
        replica.start()

    def remove_replica(self, replica_id: int) -> Replica:
        """Shrink the fleet by one: atomic list rebind; the caller owns
        draining/evacuating/stopping the removed replica. Refuses to
        empty the fleet — all-replicas-removed is impossible by
        construction (the ``ReplicaRouter needs at least one replica``
        invariant holds for the fleet's whole life, not just boot)."""
        with self._membership_lock:
            reps = list(self.replicas)
            for i, r in enumerate(reps):
                if r.replica_id == replica_id:
                    if len(reps) == 1:
                        raise ValueError(
                            "cannot remove the last replica — the fleet "
                            "must keep at least one")
                    del reps[i]
                    self.replicas = reps
                    return r
        raise KeyError(f"no replica {replica_id}")

    def replace_replica(self, replica_id: int,
                        replacement: Replica) -> Optional[Replica]:
        """Supervisor restart / re-role hand-off: swap the replica with
        ``replica_id`` and start the replacement. The slot assignment is
        atomic (list item write under the membership lock); in-flight
        iterations over ``self.replicas`` see either the corpse (not
        accepting) or the replacement. Returns the DISPLACED replica —
        the caller must stop THAT instance, not a stale reference (a
        concurrent restart may have swapped the slot since the caller
        looked) — or ``None`` when the id is no longer a member (the
        slot was retired mid-restart), in which case the caller must
        DROP the replacement, never start it."""
        with self._membership_lock:
            for i, r in enumerate(self.replicas):
                if r.replica_id == replica_id:
                    self.replicas[i] = replacement
                    replacement.start()
                    return r
        return None

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, req: ServingRequest) -> None:
        # trace stage: routing (replica selection + any wait for a free
        # slot); ended by Replica.assign, or by req.finish on failure
        req.begin_span(self.tracer, "route")
        while not self._stop.is_set():
            if not self._any_accepting_for(req):
                sup = self.supervisor
                if (sup is None or not sup.recovery_pending()) \
                        and not self._any_quarantined_for(req):
                    logger.warning(f"serving request {req.uid}: no healthy "
                                   "replica; failing fast")
                    if self.metrics is not None:
                        self.metrics.counter("requests_failed").inc()
                    req.finish(RequestState.FAILED, FinishReason.NO_REPLICAS)
                    return
                # supervised restart (or probe re-admission of a
                # quarantined replica) in flight: capacity is coming
                # back — hold the request (deadline still enforced
                # below)
            if req.expired():
                if self.metrics is not None:
                    self.metrics.counter("requests_expired").inc()
                req.finish(RequestState.EXPIRED, FinishReason.DEADLINE)
                return
            replica = self.pick(req)
            if replica is not None and replica.assign(req):
                if self.tenancy is not None:
                    # account the dispatch: fair-share service + the
                    # token-rate window, and the KV block charge against
                    # this tenant's budget on the chosen replica
                    self.tenancy.charge(req)
                    self.tenancy.charge_kv(req, replica)
                return
            # healthy fleet but every slot busy (or lost a drain race):
            # capacity frees as sequences finish — wait, don't fail
            self._stop.wait(self.poll_interval_s)
        # stopped while holding an unassigned request: it is no longer in
        # the admission queue, so it MUST be finished here or its stream
        # would hang past shutdown
        if self.metrics is not None:
            self.metrics.counter("requests_shed").inc()
        req.finish(RequestState.REJECTED, "draining")

    def _fail_undispatchable(self) -> None:
        """Supervised fleets only: once every slot is parked or stopped
        (nothing is coming back), queued work is failed fast with
        "no_replicas" instead of waiting out its deadline. Unsupervised
        fleets keep the legacy behavior (work waits; deadlines sweep)."""
        sup = self.supervisor
        if sup is None or self._any_accepting() or sup.recovery_pending() \
                or any(r.state == ReplicaState.QUARANTINED
                       for r in self.replicas):
            return
        while True:
            req = self.admission.pop(timeout=0)
            if req is None:
                return
            if self.metrics is not None:
                self.metrics.counter("requests_failed").inc()
            req.finish(RequestState.FAILED, FinishReason.NO_REPLICAS)

    def _tick(self) -> None:
        if self.tenancy is not None:
            # release KV charges of finished requests + age the
            # token-rate windows (quota clears even with zero traffic)
            self.tenancy.reconcile()
        if self.affinity is not None:
            # refresh the fleet's prefix digests (cadence-gated
            # internally; remote handles answer from their last status
            # frame, so this never blocks on the wire)
            try:
                self.affinity.refresh(self.replicas)
            except Exception as e:  # pragma: no cover - defensive
                logger.error(f"affinity digest refresh failed: {e!r}")
        if self.recorder is not None:
            self.recorder.maybe_snapshot()
        for hook in self.tick_hooks:
            try:
                hook()
            except Exception as e:  # pragma: no cover - defensive
                logger.error(f"serving router tick hook failed: {e!r}")

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._tick()
            if self.pick() is None:
                # no free slot anywhere: leave the backlog in the
                # admission queue (priority/deadline order) rather than
                # FIFO-ing it into replica inboxes
                self.healthy_replicas()   # keep health/gauges fresh
                self._fail_undispatchable()
                self._stop.wait(self.poll_interval_s)
                continue
            req = self.admission.pop(timeout=self.poll_interval_s,
                                     accept=self._dispatchable_filter())
            if req is None:
                self.healthy_replicas()   # keep health/gauges fresh when idle
                continue
            self._dispatch(req)

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop dispatching; optionally let replicas finish in-flight work.
        The drain path must NOT set the replica stop flag first — the
        worker exits on its own once DRAINING and idle; stop() afterwards
        is the backstop for replicas that didn't finish in time."""
        if self.supervisor is not None:
            # no restarts during shutdown (a swap racing the drain loop
            # below would resurrect capacity we are tearing down)
            self.supervisor.stop()
        self._stop.set()
        if self.thread.is_alive():
            self.thread.join(timeout)
        if drain:
            deadline = time.monotonic() + timeout
            for r in self.replicas:
                r.drain()
            for r in self.replicas:
                if r.thread.is_alive():
                    r.thread.join(max(0.0, deadline - time.monotonic()))
        for r in self.replicas:
            r.stop(1.0)
