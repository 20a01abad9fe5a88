"""SLO-aware admission: bounded priority/deadline queue with load shedding.

The queue is the backpressure point of the serving layer: it admits at most
``max_depth`` requests, orders them by (priority, earliest deadline, FIFO),
and *sheds* instead of growing — a full queue raises
:class:`~deepspeed_tpu_torch.serving.request.Rejected` at submit time so callers
see an immediate, typed "overloaded" rather than an unbounded TTFT tail.
Requests whose deadline passes while still queued are swept at pop time
(the WHOLE heap, not just the top — doomed work deep in the backlog never
reaches a replica) and finished with reason "deadline" so their streams
terminate.

Two fault-tolerance hooks (docs/SERVING.md "Fault tolerance"):
:meth:`requeue` re-admits a request whose replica died — exempt from the
depth bound, admitted work is conserved rather than shed — and *brownout*
mode shrinks the effective depth when the router reports degraded healthy
capacity, shedding the lowest-urgency queued work (reason "brownout")
instead of letting the whole backlog time out on a half-sized fleet.
"""

from __future__ import annotations

import heapq
import math
import time
from typing import List, Optional

from ..utils.locks import RankedCondition
from .metrics import MetricsRegistry
from .request import Rejected, RequestState, ServingRequest, FinishReason


class AdmissionQueue:
    # lock discipline (docs/CONCURRENCY.md): every queue structure and
    # every brownout/pressure input moves under the admission condition.
    # ``_preempt_pressure`` is writes-only guarded: the reader side is a
    # last-write-wins advisory label on shed accounting (a stale read
    # mislabels one shed; a torn structure would corrupt the heap).
    _GUARDED_BY = {
        "_heap": "_lock",
        "_class_depth": "_lock",
        "_earliest_deadline": "_lock",
        "_closed": "_lock",
        "_brownout": "_lock",
        "_healthy_frac": "_lock",
        "_proactive_frac": "_lock",
        "_preempt_pressure": "_lock:writes",
    }

    def __init__(self, max_depth: int, metrics: Optional[MetricsRegistry] = None,
                 brownout_threshold: float = 0.0, journal=None,
                 tenancy=None):
        self.max_depth = int(max_depth)
        self.metrics = metrics
        # tenancy ledger (serving/tenancy.py, docs/SERVING.md
        # "Multi-model & multi-tenant serving"): set-once reference,
        # internally locked at rank 65 — acquirable while holding this
        # queue's condition (rank 60). None = tenancy off: every pop is
        # the historical class-ordered heap byte for byte.
        self._tenancy = tenancy
        # ops journal (telemetry/journal.py): brownout enter/exit
        # transitions are fleet-lifecycle events worth a durable record,
        # not just a gauge flip
        self.journal = journal
        # healthy-capacity fraction below this activates brownout
        # (0 = brownout disabled, the historical behavior)
        self.brownout_threshold = float(brownout_threshold)
        self._healthy_frac = 1.0
        # proactive brownout feed (docs/SERVING.md "Elastic
        # autoscaling"): the autoscaler degrades this fraction on
        # slow-window budget burn BEFORE the fast+slow alert fires; the
        # effective capacity fraction is min(healthy, proactive). 1.0 =
        # inactive — the historical behavior byte for byte.
        self._proactive_frac = 1.0
        self._brownout = False
        # preemption pressure (docs/SERVING.md "Admission and
        # preemption"): set by the frontend's observability tick while
        # any replica scheduler reports a reservation shortfall or
        # parked (preempted) sequences. Overload sheds during such a
        # window count ``requests_shed_preempt_pressure`` too — "we
        # shed because the KV pool is oversubscribed" is a different
        # incident than "we shed because replicas died" (brownout).
        self._preempt_pressure = False
        self._lock = RankedCondition("serving.queue")
        self._heap: List[tuple] = []      # (order_key, ServingRequest)
        # per-request-class depth (docs/SERVING.md "Disaggregated
        # serving"): published as queue_depth_class_<cls> gauges; shed
        # events count per class too (requests_shed_class_<cls>)
        self._class_depth: dict = {}
        # earliest deadline among queued entries: the expired sweep only
        # scans the heap once this watermark has actually passed, so the
        # per-pop cost stays O(log n) on deadline-free / fresh traffic
        self._earliest_deadline = float("inf")
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def _note_depth(self) -> None:
        if self.metrics is not None:
            depth = len(self._heap)
            self.metrics.gauge("queue_depth").set(depth)
            self.metrics.histogram("queue_depth_hist").observe(depth)
            for cls, n in self._class_depth.items():
                self.metrics.gauge(f"queue_depth_class_{cls}").set(n)

    def _dec_class(self, req: ServingRequest) -> None:
        """One request left the heap (any path); caller holds the lock
        and calls _note_depth afterwards."""
        cls = req.request_class
        n = self._class_depth.get(cls, 0) - 1
        self._class_depth[cls] = max(0, n)

    def _count_shed(self, req: ServingRequest, reason: str) -> None:
        if self.metrics is None:
            return
        self.metrics.counter("requests_shed").inc()
        self.metrics.counter(
            f"requests_shed_class_{req.request_class}").inc()
        if self._tenancy is not None:
            # per-tenant shed series exist only for configured tenants
            # (pre-declared by serving_metrics) — tenancy off keeps the
            # snapshot byte-identical to the historical registry
            self.metrics.counter(
                f"requests_shed_tenant_{req.tenant}").inc()
        if reason == FinishReason.BROWNOUT:
            self.metrics.counter("requests_shed_brownout").inc()
        elif reason == "overloaded" and self._preempt_pressure:
            # only genuine overload sheds: a shutdown "draining" sweep
            # during a pressure window is not an oversubscription signal
            self.metrics.counter("requests_shed_preempt_pressure").inc()

    def set_preempt_pressure(self, active: bool) -> None:
        """Frontend tick hook: preemption/reservation pressure somewhere
        in the fleet. Labels subsequent overload sheds (no effect on
        admission itself — reservation pressure is resolved by the
        schedulers, not by shrinking the queue). The write takes the
        lock (concurrency lint, guarded-field): the tick thread races
        shedding pops, and the write side of a guarded flag is where
        the ordering with those sheds is pinned down."""
        with self._lock:
            self._preempt_pressure = bool(active)

    def offer(self, req: ServingRequest, block: bool = False,
              timeout: Optional[float] = None) -> None:
        """Admit or shed. Raises Rejected("overloaded") when full,
        Rejected("draining") after close(). ``block=True`` (the
        ``shed_policy: "block"`` path) waits for room instead of shedding
        — the request is only finished once, on a genuine rejection."""
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        with self._lock:
            while True:
                if self._closed:
                    self._shed(req, "draining")
                if len(self._heap) < self._effective_depth():
                    break
                if self._brownout:
                    # degraded capacity: make room by evicting the least
                    # urgent queued request IF the incoming one outranks
                    # it — otherwise the incoming request is the least
                    # urgent work and is the one shed
                    if self._evict_worst_for(req):
                        break
                    self._shed(req, FinishReason.BROWNOUT)
                if not block:
                    self._shed(req, "overloaded")
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    self._shed(req, "overloaded")
                self._lock.wait(wait if wait is not None else 0.05)
            self._push_locked(req)
        if self.metrics is not None:
            self.metrics.counter("requests_admitted").inc()

    def _push_locked(self, req: ServingRequest) -> None:
        heapq.heappush(self._heap, (req.order_key, req))
        self._class_depth[req.request_class] = \
            self._class_depth.get(req.request_class, 0) + 1
        if req.deadline_t is not None:
            self._earliest_deadline = min(self._earliest_deadline,
                                          req.deadline_t)
        self._note_depth()
        self._lock.notify()

    def requeue(self, req: ServingRequest) -> bool:
        """Re-admit a request whose replica died (transparent failover).
        Exempt from the depth bound — the request was already admitted
        once, and conserving admitted work must not depend on queue
        headroom at the moment of the crash. False when the queue is
        closed (shutdown) — the caller fails the request terminally."""
        with self._lock:
            if self._closed:
                return False
            self._push_locked(req)
        return True

    def _shed(self, req: ServingRequest, reason: str) -> None:
        self._count_shed(req, reason)
        req.finish(RequestState.REJECTED, reason)
        raise Rejected(reason, f"queue depth {len(self._heap)}"
                               f"/{self.max_depth}")

    # ------------------------------------------------------------ brownout
    def _effective_frac(self) -> float:
        """Capacity fraction the brownout math runs on: the router's
        healthy fraction degraded further by any proactive
        (budget-burn-driven) fraction the autoscaler feeds."""
        return min(self._healthy_frac, self._proactive_frac)

    def _effective_depth(self) -> int:
        """Depth bound under the current health: full ``max_depth`` in
        normal operation, shrunk proportionally to the effective
        capacity fraction during brownout (a half-dead fleet gets half
        the backlog, so queue-wait stays bounded instead of doubling)."""
        if not self._brownout:
            return self.max_depth
        return max(1, int(math.ceil(self.max_depth
                                    * self._effective_frac())))

    def set_proactive_fraction(self, frac: Optional[float]) -> None:
        """Autoscaler feed (docs/SERVING.md "Elastic autoscaling"): a
        degraded capacity fraction derived from slow-window error-budget
        burn, applied BEFORE the fast+slow alert would fire. Combined
        with the router's healthy fraction by min(); proactive brownout
        is active whenever this fraction is below 1.0, regardless of
        ``brownout_threshold`` (which gates only the replica-death
        path). ``None`` or 1.0 deactivates."""
        frac = 1.0 if frac is None else max(0.0, min(1.0, float(frac)))
        with self._lock:
            if frac == self._proactive_frac:
                return
            self._proactive_frac = frac
            healthy = self._healthy_frac
        self.set_healthy_fraction(healthy, _force=True)

    def set_healthy_fraction(self, frac: float, _force: bool = False) -> None:
        """Router health sweep reports healthy/total replica capacity.
        Below ``brownout_threshold`` — or whenever a proactive fraction
        below 1.0 is fed — the queue enters brownout: the depth bound
        shrinks and already-queued lowest-urgency work is shed with
        reason "brownout" — graceful degradation sacrifices the least
        important work explicitly instead of timing everything out.

        Every read of the brownout inputs happens under the lock
        (concurrency lint, guarded-field): the early-exit check used to
        read ``_proactive_frac`` lock-free and the journal line below
        used to re-read ``_healthy_frac`` after release — a concurrent
        ``set_proactive_fraction`` could journal a transition with a
        fraction that never caused it."""
        shed: List[ServingRequest] = []
        transition = None
        with self._lock:
            if self.brownout_threshold <= 0.0 and not _force \
                    and self._proactive_frac >= 1.0:
                return
            self._healthy_frac = max(0.0, min(1.0, float(frac)))
            healthy_now = self._healthy_frac
            was = self._brownout
            self._brownout = (
                (self.brownout_threshold > 0.0
                 and self._effective_frac() < self.brownout_threshold)
                or self._proactive_frac < 1.0)
            if was != self._brownout:
                transition = self._brownout
                if self.metrics is not None:
                    self.metrics.gauge("brownout_active").set(
                        1.0 if self._brownout else 0.0)
            if self._brownout:
                eff = self._effective_depth()
                while len(self._heap) > eff:
                    worst_i = self._worst_sheddable_index()
                    if worst_i is None:
                        break             # only retried work left: keep it
                    shed.append(self._pop_index_locked(worst_i))
                if shed:
                    self._note_depth()
        if transition is not None and self.journal is not None:
            self.journal.emit(
                "brownout_enter" if transition else "brownout_exit",
                healthy_fraction=round(healthy_now, 4),
                shed_now=len(shed))
        for req in shed:
            self._count_shed(req, FinishReason.BROWNOUT)
            req.finish(RequestState.REJECTED, FinishReason.BROWNOUT)

    def _victim_key(self, r: ServingRequest) -> tuple:
        """Brownout/preemption victim order. With tenancy enabled the
        leading component is whether the request's tenant is over quota
        (over-quota tenants shed FIRST — docs/SERVING.md "Multi-model &
        multi-tenant serving"); the rest is the historical ``shed_key``
        (class shed rank, then lowest urgency). Tenancy off prepends a
        constant 0, so the ordering is byte-identical."""
        over = (self._tenancy.victim_rank(r)
                if self._tenancy is not None else 0)
        return (over,) + tuple(r.shed_key)

    def _worst_sheddable_index(self) -> Optional[int]:
        """Index of the entry brownout sheds first: max victim key —
        over-quota tenants first (tenancy only), then highest class shed
        rank (batch before interactive, regardless of priority —
        docs/SERVING.md "Disaggregated serving"), then lowest urgency
        within the class (max order_key: lowest priority, then
        longest/absent deadline). Failover-requeued requests
        (attempts > 1) are never victims — they already streamed on a
        replica that died, and conserving admitted work is the failover
        contract — and neither are staged KV-handoff requests (their
        prefill work is done and paid for). Caller holds the lock."""
        best = None
        best_key = None
        for j, (_, r) in enumerate(self._heap):
            if r.attempts > 1 or r.staged_kv is not None:
                continue
            key = self._victim_key(r)
            if best is None or key > best_key:
                best, best_key = j, key
        return best

    def _pop_index_locked(self, i: int) -> ServingRequest:
        _, req = self._heap[i]
        self._heap[i] = self._heap[-1]
        self._heap.pop()
        heapq.heapify(self._heap)
        self._dec_class(req)
        return req

    def _evict_worst_for(self, req: ServingRequest) -> bool:
        """Brownout room-making: evict the least urgent sheddable queued
        request if ``req`` outranks it (class shed rank first, then
        urgency). Caller holds the lock."""
        worst_i = self._worst_sheddable_index()
        if worst_i is None:
            # over-depth purely with retried work: admit rather than
            # touch it (requeue is depth-exempt for the same reason)
            return True
        if self._victim_key(req) >= self._victim_key(self._heap[worst_i][1]):
            return False
        victim = self._pop_index_locked(worst_i)
        self._count_shed(victim, FinishReason.BROWNOUT)
        victim.finish(RequestState.REJECTED, FinishReason.BROWNOUT)
        return True

    def _sweep_expired_locked(self, now: float) -> None:
        """Fail every deadline-expired request anywhere in the heap —
        not just at the top. An expired LOW request buried under fresher
        HIGH traffic would otherwise occupy a depth slot (and eventually
        a replica's admit path) long after it became doomed. Guarded by
        the earliest-deadline watermark, so the O(n) scan only runs when
        some queued deadline has actually passed. Caller holds the
        lock."""
        if now <= self._earliest_deadline:
            return
        keep, expired, cancelled = [], [], []
        for entry in self._heap:
            if not entry[1].expired(now):
                keep.append(entry)
            elif entry[1].cancel_requested.is_set():
                # swept too (cancel takes precedence over deadline, as
                # at pop) — left in the heap it would pin the watermark
                # in the past and force this scan on every pop
                cancelled.append(entry)
            else:
                expired.append(entry)
        self._earliest_deadline = min(
            (r.deadline_t for _, r in keep if r.deadline_t is not None),
            default=float("inf"))
        if not expired and not cancelled:
            return
        self._heap = keep
        heapq.heapify(self._heap)
        for _, req in expired + cancelled:
            self._dec_class(req)
        self._note_depth()
        self._lock.notify_all()           # room freed: wake blocked offers
        for _, req in expired:
            req.finish(RequestState.EXPIRED, FinishReason.DEADLINE)
            if self.metrics is not None:
                self.metrics.counter("requests_expired").inc()
        for _, req in cancelled:
            req.finish(RequestState.CANCELLED, FinishReason.CANCELLED)
            if self.metrics is not None:
                self.metrics.counter("requests_cancelled").inc()

    def _pop_best_locked(self, accept) -> Optional[ServingRequest]:
        """Remove and return the highest-urgency entry ``accept``
        (callable or None) allows, or None when nothing qualifies.
        ``accept=None`` is the historical heappop, byte for byte; with a
        predicate the scan is O(n) over the bounded heap — the
        disaggregated router's dispatchability filter (docs/SERVING.md
        "Disaggregated serving"), which keeps a request no replica can
        currently run from head-of-line-blocking work that idle replicas
        of the other role could take. Caller holds the lock."""
        if self._tenancy is not None:
            return self._pop_fair_locked(accept)
        if accept is None:
            if not self._heap:
                return None
            _, req = heapq.heappop(self._heap)
        else:
            best = None
            for j, (key, r) in enumerate(self._heap):
                if (best is None or key < self._heap[best][0]) and accept(r):
                    best = j
            if best is None:
                return None
            return self._pop_index_locked(best)
        self._dec_class(req)
        return req

    def _pop_fair_locked(self, accept) -> Optional[ServingRequest]:
        """Deficit-weighted-fair pop (docs/SERVING.md "Multi-model &
        multi-tenant serving"): among tenants with acceptable queued
        work, drain the one with the best ledger key — in-quota tenants
        before over-quota ones (work-conserving: an over-quota tenant
        still drains when nobody else has work), then least
        weight-normalized virtual service, then the tenant's own best
        (priority, deadline, FIFO) entry as the tie-break. Within the
        chosen tenant, the class machinery orders exactly as before.
        O(n) over the bounded heap, like the accept path. Caller holds
        the lock; the ledger's rank-65 lock nests inside."""
        best_per_tenant: dict = {}       # tenant -> (order_key, index)
        for j, (key, r) in enumerate(self._heap):
            if accept is not None and not accept(r):
                continue
            cur = best_per_tenant.get(r.tenant)
            if cur is None or key < cur[0]:
                best_per_tenant[r.tenant] = (key, j)
        if not best_per_tenant:
            return None
        tenant = min(
            best_per_tenant,
            key=lambda t: (self._tenancy.drain_key(t)
                           + tuple(best_per_tenant[t][0])))
        return self._pop_index_locked(best_per_tenant[tenant][1])

    def pop(self, timeout: Optional[float] = None,
            accept=None) -> Optional[ServingRequest]:
        """Highest-urgency admitted request, skipping (and expiring) any
        whose deadline already passed. None on timeout / closed-and-empty.
        ``accept(req) -> bool`` restricts the pop to currently
        dispatchable requests (rejected entries stay queued, urgency
        order intact); None = pop anything, the historical behavior."""
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        with self._lock:
            while True:
                now = time.monotonic()
                self._sweep_expired_locked(now)
                while self._heap:
                    req = self._pop_best_locked(accept)
                    if req is None:
                        break         # nothing dispatchable: wait below
                    self._lock.notify_all()   # room freed: wake blocked offers
                    if req.cancel_requested.is_set():
                        self._note_depth()
                        req.finish(RequestState.CANCELLED,
                                   FinishReason.CANCELLED)
                        if self.metrics is not None:
                            self.metrics.counter("requests_cancelled").inc()
                        continue
                    if req.expired(now):
                        self._note_depth()
                        req.finish(RequestState.EXPIRED,
                                   FinishReason.DEADLINE)
                        if self.metrics is not None:
                            self.metrics.counter("requests_expired").inc()
                        continue
                    self._note_depth()
                    req.admitted_t = now
                    # request trace: the queue stage ends here (expired/
                    # cancelled pops close their spans via req.finish)
                    req.end_span("queue")
                    if self.metrics is not None:
                        self.metrics.histogram("queue_wait_s").observe(
                            now - req.arrival_t)
                    return req
                if self._closed:
                    return None
                wait = None if deadline is None else deadline - now
                if wait is not None and wait <= 0:
                    return None
                if not self._lock.wait(wait):
                    return None

    def remove(self, req: ServingRequest) -> bool:
        """Take a specific request back out (eager cancel while queued):
        frees its depth slot immediately instead of waiting for it to
        reach the heap top. False if it already left the queue."""
        with self._lock:
            for i, (_, r) in enumerate(self._heap):
                if r is req:
                    self._pop_index_locked(i)
                    self._note_depth()
                    self._lock.notify_all()
                    return True
        return False

    def close(self) -> List[ServingRequest]:
        """Stop admitting; returns (and removes) everything still queued so
        the caller can fail or drain it."""
        with self._lock:
            self._closed = True
            out = [req for _, req in self._heap]
            self._heap.clear()
            self._class_depth = {cls: 0 for cls in self._class_depth}
            self._note_depth()
            self._lock.notify_all()
        return out
