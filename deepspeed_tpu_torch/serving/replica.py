"""One serving replica: a worker thread driving an InferenceEngineV2.

Counterpart of ``deepspeed_tpu/serving/replica.py``. Grad mode is per
thread in PyTorch, so the worker loop runs under ``torch.no_grad()``: a
replica thread does not inherit its caller's mode, and no forward it runs
builds an autograd graph.

Thread-per-replica mirrors how ``bench.py``'s serving phase drives the
engine: each replica owns a :class:`ContinuousBatchingScheduler` (Dynamic
SplitFuse) over its engine and a lock-free inbox the router assigns into.
The loop per iteration: drain the inbox into the scheduler, enforce
cancellations and deadlines (both free KV blocks *immediately* via
``scheduler.cancel`` → ``engine.flush``), then run one scheduler step,
streaming every sampled token to its request.

Health is a state machine the router consults before assigning:
``HEALTHY`` → ``DRAINING`` (finishes what it has, accepts nothing new) →
``STOPPED``; an engine exception or a step that exceeds
``wedge_timeout_s`` moves the replica to ``DEAD`` and fails its in-flight
requests, so one wedged replica degrades capacity instead of the service.

With fault tolerance enabled (docs/SERVING.md "Fault tolerance") death is
no longer terminal for the *requests*: an ``on_failover`` callback hands
each in-flight/queued request back to the frontend, which re-enqueues it
to resume on another replica from prompt + delivered tokens; the
:class:`~deepspeed_tpu_torch.serving.supervisor.ReplicaSupervisor` then
replaces the dead replica itself. A ``faults`` injector (test-only)
hooks the loop at the step boundary and the engine at the put boundary
to make those deaths schedulable.
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from typing import Callable, Dict, Optional

import torch

from ..inference.v2.scheduler import ContinuousBatchingScheduler
from ..utils.locks import RankedLock
from ..utils.logging import logger
from .metrics import MetricsRegistry
from .request import FinishReason, RequestState, ServingRequest


class ReplicaState(enum.Enum):
    HEALTHY = "healthy"
    DRAINING = "draining"
    # Gray failure: the replica answers RPCs but too slowly (or misses
    # deadlines) — the router stops handing it fresh work while in-flight
    # streams run to completion, and probe RPCs on backoff re-admit it.
    # Only remote handles enter this state; local replicas never do.
    QUARANTINED = "quarantined"
    DEAD = "dead"
    STOPPED = "stopped"


class Replica:
    # lock discipline (docs/CONCURRENCY.md): the load split and the
    # failure-detach gate are multi-writer (worker loop, router
    # dispatch, supervisor, admin drain) and must only move under the
    # replica lock. ``_active`` is deliberately NOT guarded: writes are
    # worker-thread-confined and the cross-thread readers (check_health,
    # stop) take racy snapshots settled by the ``_failed_uids`` gate.
    _GUARDED_BY = {
        "_outstanding": "_lock",
        "_out_prefill": "_lock",
        "_out_decode": "_lock",
        "_failed_uids": "_lock",
    }

    def __init__(self, replica_id: int, engine,
                 metrics: Optional[MetricsRegistry] = None,
                 sample_fn: Optional[Callable] = None,
                 wedge_timeout_s: float = 300.0,
                 idle_wait_s: float = 0.005,
                 speculative=None, tracer=None, recorder=None,
                 faults=None, on_failover: Optional[Callable] = None,
                 role: str = "mixed", decode_reserve_tokens: int = 0,
                 on_handoff: Optional[Callable] = None, journal=None,
                 model_id: str = "default"):
        from ..telemetry import NOOP_TRACER

        self.replica_id = replica_id
        # multi-model serving (docs/SERVING.md "Multi-model &
        # multi-tenant serving"): which model pool this replica belongs
        # to — the router only routes a request onto replicas of its
        # model. "default" is the historical single-model fleet.
        self.model_id = str(model_id)
        # ops journal (telemetry/journal.py): import-side handoff
        # fallbacks are fleet-lifecycle events (the export side journals
        # in the frontend)
        self.journal = journal
        # disaggregated serving role (docs/SERVING.md "Disaggregated
        # serving"): "prefill" runs prompt-chunk-only steps and hands
        # each finished prompt's KV to ``on_handoff``; "decode" reserves
        # part of every step's token budget for decode rows; "mixed"
        # (the default) is the historical do-everything replica.
        self.role = role
        self._on_handoff = on_handoff
        # fault injection (test-only, serving/faults.py): the engine is
        # proxied ONLY when a put-level fault targets this replica; the
        # step hook below fires crash/wedge events. None = no hooks.
        self._faults = faults
        if faults is not None:
            engine = faults.wrap_engine(engine, replica_id)
        # transparent failover (docs/SERVING.md "Fault tolerance"): on
        # replica death the frontend re-enqueues this replica's requests
        # instead of failing them; None = historical fail-terminal path
        self._on_failover = on_failover
        self.engine = engine
        self.metrics = metrics
        # telemetry (docs/OBSERVABILITY.md): request-trace stage spans +
        # per-forward spans (via the scheduler) and a flight-recorder
        # dump when this replica dies; both default to no-ops
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.recorder = recorder
        # speculative decoding (docs/SERVING.md): each replica builds its
        # OWN proposer — draft state (n-gram none, draft-model KV) is tied
        # to this replica's sequences. A custom sampler makes the
        # scheduler drop any proposer (lossless needs greedy), so don't
        # pay proposer construction — draft-model mode loads a whole
        # checkpoint — for something that would be discarded.
        if (speculative is not None and speculative.enabled
                and sample_fn is not None):
            # surfaced here because the scheduler never sees the config —
            # otherwise spec_tokens_* flatline with nothing in the logs
            logger.warning(
                f"serving replica {replica_id}: speculative decoding "
                "configured but a custom sample_fn is set — speculation "
                "disabled (lossless verification requires greedy sampling)")
        # a prefill-role replica never decodes, so a draft proposer
        # would be dead weight (draft-model mode loads a checkpoint)
        proposer = (speculative.build_proposer()
                    if speculative is not None and sample_fn is None
                    and role != "prefill"
                    else None)
        max_drafts = (speculative.max_draft_tokens
                      if speculative is not None else 4)
        self.scheduler = ContinuousBatchingScheduler(
            engine, sample_fn, proposer=proposer,
            max_draft_tokens=max_drafts, tracer=self.tracer,
            trace_label=f"replica-{replica_id}",
            prefill_only=role == "prefill",
            decode_reserve_tokens=(decode_reserve_tokens
                                   if role == "decode" else 0))
        self.wedge_timeout_s = wedge_timeout_s
        self.idle_wait_s = idle_wait_s
        self.state = ReplicaState.HEALTHY
        self._inbox: "queue.Queue[ServingRequest]" = queue.Queue()
        self._active: Dict[int, ServingRequest] = {}
        # uids already detached by a failure path — the worker loop, the
        # router's wedge check and the supervisor can all race to fail
        # the same request; exactly one may fail over / finish it (a
        # double requeue would split one stream across two replicas)
        self._failed_uids: set = set()
        self._lock = RankedLock("serving.replica")
        self._outstanding = 0             # token-weighted load estimate
        # phase-split load (docs/SERVING.md "Disaggregated serving"):
        # prefill tokens still to process vs decode tokens still owed.
        # The disaggregated router weighs these separately (a pending
        # 2000-token prefill is a few chunked forwards; 2000 owed decode
        # tokens are 2000 forwards); the legacy ``_outstanding`` above
        # is kept untouched so the disabled path routes byte-for-byte
        # as before.
        self._out_prefill = 0
        self._out_decode = 0
        self._stop = threading.Event()
        # elastic autoscaling (docs/SERVING.md "Elastic autoscaling"):
        # set by request_evacuation() — the worker loop hands every
        # resident request back through this callback (staged KV where
        # exportable) so a draining replica can be removed/re-roled
        # without waiting out its in-flight decodes
        self._evacuate_cb: Optional[Callable] = None
        # monotonic time of the last completed loop iteration; a worker
        # stuck inside engine.put stops updating it — that's the wedge
        # signal check_health() reads (a blocked thread can't self-report)
        self.last_progress_t = time.monotonic()
        self._busy_since: Optional[float] = None
        self._steps_done = 0
        # last engine prefix-cache / scheduler spec snapshots, for
        # delta-publishing the monotonic registry counters (summable
        # across replicas)
        self._prefix_last: Dict[str, int] = {}
        self._spec_last: Dict[str, int] = {}
        self._tier_last: Dict[str, int] = {}
        self._preempt_last: Dict[str, int] = {}
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name=f"serving-replica-{replica_id}")

    def start(self) -> None:
        self.thread.start()

    # ------------------------------------------------------------- routing
    @property
    def outstanding_tokens(self) -> int:
        with self._lock:
            return self._outstanding

    @property
    def outstanding_prefill_tokens(self) -> int:
        with self._lock:
            return self._out_prefill

    @property
    def outstanding_decode_tokens(self) -> int:
        with self._lock:
            return self._out_decode

    def _charge_locked(self, req: ServingRequest) -> None:
        """Add a request's phase-split load; caller holds the lock. A
        staged KV-handoff request costs no prefill (the import replaces
        it); everything else re-prefills its resume prompt."""
        pre = 0 if req.staged_kv is not None else len(req.resume_prompt())
        req._charged_prefill = pre
        self._out_prefill += pre
        self._out_decode += req.remaining_new_tokens

    def _discharge_locked(self, req: ServingRequest) -> None:
        """Remove whatever phase-split load the request still holds;
        caller holds the lock."""
        self._out_prefill = max(0, self._out_prefill - req._charged_prefill)
        req._charged_prefill = 0
        self._out_decode = max(0, self._out_decode
                               - req.remaining_new_tokens)

    def prefix_digest(self, max_entries: int = 512):
        """Bounded chain-hash digest of this replica's cached prefix
        content — the router's affinity input (docs/SERVING.md "Fleet
        KV locality"). Feature-detected like ``_publish_prefix_stats``:
        an engine without a prefix cache (or a sick one) is simply
        cache-blind, never an error."""
        fn = getattr(self.engine, "prefix_digest", None)
        if fn is None:
            return frozenset()
        try:
            return frozenset(fn(max_entries))
        except Exception:
            return frozenset()

    @property
    def accepting(self) -> bool:
        return self.state == ReplicaState.HEALTHY

    @property
    def active_count(self) -> int:
        return len(self._active) + self._inbox.qsize()

    @property
    def has_capacity(self) -> bool:
        """Concurrency slots left (engine's max ragged sequence count).
        The router only assigns into free slots — backlog beyond them
        stays in the admission queue where priority/deadline order rules,
        instead of FIFO-ing through an unbounded inbox."""
        return self.active_count < self.engine.config.max_ragged_sequence_count

    def assign(self, req: ServingRequest) -> bool:
        """Router hand-off; False if the replica can no longer take work."""
        if not self.accepting:
            return False
        with self._lock:
            self._outstanding += req.outstanding_tokens
            self._charge_locked(req)
        req.replica_id = self.replica_id
        # trace stages: routing ends at the hand-off; "admit" covers the
        # inbox wait until the worker loop submits to the scheduler
        if req.spans is not None:
            req.end_span("route")
            req.begin_span(self.tracer, "admit",
                           attrs={"replica": self.replica_id})
        self._inbox.put(req)
        return True

    def drain(self) -> None:
        """Stop accepting; in-flight requests run to completion."""
        if self.state == ReplicaState.HEALTHY:
            self.state = ReplicaState.DRAINING

    def request_evacuation(self, handback: Callable) -> None:
        """Fast drain for removal/re-role (docs/SERVING.md "Elastic
        autoscaling"): stop accepting AND hand every resident request
        back through ``handback(req, payload, replica_id)`` on the next
        worker iteration instead of waiting for its decode to finish.
        ``payload`` is a staged-KV export (resume-by-import on the
        destination) for fully-prefilled sequences, ``None`` otherwise
        (the destination re-prefills prompt + delivered tokens —
        lossless under greedy decoding either way). Runs ON the worker
        thread: engine access stays race-free, and once everything is
        handed back the DRAINING loop exits on its own."""
        self.drain()
        self._evacuate_cb = handback

    def _do_evacuate(self) -> None:
        """Worker-thread evacuation pass (see request_evacuation)."""
        cb = self._evacuate_cb
        for uid, req in list(self._active.items()):
            with self._lock:
                if uid in self._failed_uids:
                    continue        # a failure path already took it
                self._failed_uids.add(uid)
                self._outstanding = max(0, self._outstanding
                                        - req.outstanding_tokens)
                self._discharge_locked(req)
            self._active.pop(uid, None)
            payload = None
            try:
                payload = self.scheduler.evacuate(uid)
            except Exception as e:  # pragma: no cover - defensive
                logger.warning(f"serving replica {self.replica_id}: "
                               f"evacuation of request {uid} failed "
                               f"({e!r}); re-prefilling elsewhere")
            cb(req, payload, self.replica_id)

    def stop(self, timeout: Optional[float] = 5.0) -> None:
        self._stop.set()
        if self.thread.is_alive():
            self.thread.join(timeout)
        if self.state != ReplicaState.DEAD:
            self.state = ReplicaState.STOPPED
        if self.thread.is_alive():
            # the worker is stuck in a device call and will never run its
            # own exit cleanup — fail its requests from here so no stream
            # outlives the shutdown (detaching makes the stuck thread's
            # late callbacks no-op)
            for req in list(self._active.values()):
                self._fail_request(req, FinishReason.ERROR,
                                   RequestState.FAILED)
            self._reject_inbox()

    def check_health(self, now: Optional[float] = None) -> ReplicaState:
        """Router-side wedge detection: a replica that has had work for
        longer than wedge_timeout_s without completing an iteration is
        marked DEAD (its thread may be stuck in a device call forever —
        routing around it is the graceful degradation). The FIRST step is
        exempt: a cold engine may spend minutes building its kernels
        (``nvcc`` at first use), which is indistinguishable from a wedge
        from out here — killing the fleet during warm-up would brick the
        service. A later step can ALSO meet a first use (a route or
        dtype not built yet), so ``wedge_timeout_s`` must be sized above
        the worst-case single build, not above a decode step — hence the
        conservative 300s default (docs/SERVING.md)."""
        if self.state in (ReplicaState.DEAD, ReplicaState.STOPPED):
            return self.state
        now = now if now is not None else time.monotonic()
        busy = self._busy_since
        if (busy is not None and self._steps_done > 0
                and now - max(busy, self.last_progress_t) > self.wedge_timeout_s):
            with self._lock:
                # router loop and supervisor both run this check — only
                # one may perform the DEAD transition (and the failover
                # hand-off below); the loser just reads the state
                if self.state in (ReplicaState.DEAD, ReplicaState.STOPPED):
                    return self.state
                self.state = ReplicaState.DEAD
            logger.warning(f"serving replica {self.replica_id} wedged "
                           f"(>{self.wedge_timeout_s}s without progress); "
                           "marking DEAD")
            # the worker thread is stuck inside a device call and cannot
            # fail its own requests — do it from here so no stream hangs.
            # Detached entries make the thread's late callbacks no-op if
            # the call ever returns.
            for req in list(self._active.values()):
                self._fail_request(req, FinishReason.ERROR,
                                   RequestState.FAILED)
            self._reject_inbox()
        return self.state

    # ---------------------------------------------------------- worker loop
    def _fail_request(self, req: ServingRequest, reason: str,
                      state: RequestState) -> None:
        with self._lock:
            if req.uid in self._failed_uids:
                return            # another failure path already took it
            self._failed_uids.add(req.uid)
            self._outstanding = max(0, self._outstanding
                                    - req.outstanding_tokens)
            self._discharge_locked(req)
        self._active.pop(req.uid, None)
        if (reason == FinishReason.ERROR and self._on_failover is not None
                and self._on_failover(req)):
            # handed back to the frontend: requeued (stream stays open,
            # resumes on another replica) or completed there — either
            # way not terminal-failed here. requests_failed_over is
            # counted by the frontend.
            return
        req.finish(state, reason)
        if self.metrics is not None:
            key = {FinishReason.DEADLINE: "requests_expired",
                   FinishReason.CANCELLED: "requests_cancelled"}.get(
                       reason, "requests_failed")
            self.metrics.counter(key).inc()

    def _admit_inbox(self) -> None:
        while True:
            try:
                req = self._inbox.get_nowait()
            except queue.Empty:
                return
            if req.cancel_requested.is_set():
                self._fail_request(req, FinishReason.CANCELLED,
                                   RequestState.CANCELLED)
                continue
            if req.expired():
                self._fail_request(req, FinishReason.DEADLINE,
                                   RequestState.EXPIRED)
                continue
            req.state = RequestState.RUNNING
            self._active[req.uid] = req
            req.end_span("admit")
            # KV handoff import (docs/SERVING.md "Disaggregated
            # serving"): a staged request's prompt KV was exported by a
            # prefill-role replica — adopt the blocks and resume at the
            # first decode token. Evacuated requests (docs/SERVING.md
            # "Elastic autoscaling") ride the same path with their KV
            # covering prompt + delivered tokens, hence resume_prompt()
            # below (identical to prompt_tokens for a fresh handoff).
            # Any import failure (representation mismatch, KV pressure,
            # engine fault) degrades to the recompute path below:
            # re-prefill instead of crash.
            payload = req.take_staged()
            if payload is not None:
                resume = req.resume_prompt()
                try:
                    # reservation admission without preemption cannot
                    # repair an import over-commitment later, so the
                    # headroom is enforced HERE: a staged handoff that
                    # would strand already-admitted sequences degrades
                    # to the recompute path (which re-enters reservation
                    # admission properly) instead of importing into a
                    # wedge (docs/SERVING.md "Admission and preemption")
                    ecfg = getattr(self.engine, "config", None)
                    if (ecfg is not None
                            and getattr(ecfg, "admission_reservation", False)
                            and not getattr(ecfg,
                                            "admission_preemption_enabled",
                                            False)):
                        bs = ecfg.kv_block_size
                        total = -(-(len(resume)
                                    + req.remaining_new_tokens) // bs)
                        if total > self.engine.reservation_headroom():
                            raise RuntimeError(
                                f"KV import of {total} blocks exceeds "
                                "reservation headroom "
                                f"({self.engine.reservation_headroom()})")
                    self.engine.import_sequence(req.uid, payload,
                                                tokens=resume)
                except Exception as e:
                    logger.warning(
                        f"serving replica {self.replica_id}: KV handoff "
                        f"import for request {req.uid} failed ({e!r}); "
                        "falling back to re-prefill")
                    if self.metrics is not None:
                        self.metrics.counter("handoff_fallbacks").inc()
                    if self.journal is not None:
                        self.journal.emit("handoff_fallback", uid=req.uid,
                                          where="import",
                                          replica=self.replica_id)
                    payload = None
                    with self._lock:
                        # the assign-time charge was 0 (staged = no
                        # prefill expected); the recompute path DOES
                        # prefill the whole prompt here — re-charge so
                        # the weighted router cost sees the real load
                        req._charged_prefill = len(req.resume_prompt())
                        self._out_prefill += req._charged_prefill
            req.end_span("handoff")
            if payload is not None:
                req.handoffs += 1
                # evacuation-staged imports (docs/SERVING.md "Elastic
                # autoscaling") stay out of the disagg handoff counters:
                # the journal's handoff_staged events must keep matching
                # handoffs_started exactly (tests/test_journal.py)
                if self.metrics is not None \
                        and not payload.get("evacuated"):
                    self.metrics.counter("handoffs_completed").inc()
                    if req.handoff_t is not None:
                        self.metrics.histogram("handoff_s").observe(
                            time.monotonic() - req.handoff_t)
                self.scheduler.submit_prefilled(
                    req.uid, resume, payload["last_logits"],
                    req.remaining_new_tokens, req.eos_token_id,
                    on_token=self._on_token, on_finish=self._on_finish,
                    trace_id=req.trace_id, shed_rank=req.shed_rank)
                continue
            # resume semantics (a retried request re-prefills prompt +
            # already-delivered tokens and owes only the remaining
            # budget); for a first attempt these are exactly the
            # original prompt and max_new_tokens
            self.scheduler.submit(
                req.uid, req.resume_prompt(), req.remaining_new_tokens,
                req.eos_token_id,
                on_token=self._on_token, on_finish=self._on_finish,
                trace_id=req.trace_id, shed_rank=req.shed_rank)

    def _on_token(self, uid: int, token: int) -> None:
        # delivery is serialized with _fail_request under the replica
        # lock: a failure path first marks the uid failed (same lock),
        # so either this push completes BEFORE the mark — the token is
        # in generated_tokens when the failover computes resume_prompt —
        # or the uid is already marked and the late callback no-ops.
        # Without this ordering a wedged worker waking mid-step could
        # emit a duplicate of a token the retry re-generates.
        with self._lock:
            if uid in self._failed_uids:
                return
            req = self._active.get(uid)
            if req is None:
                return
            prev_t = req.last_token_t
            req.push_token(token)
            self._outstanding = max(0, self._outstanding - 1)
            if req._charged_prefill:
                # first token of this assignment: the prefill is done
                self._out_prefill = max(0, self._out_prefill
                                        - req._charged_prefill)
                req._charged_prefill = 0
            self._out_decode = max(0, self._out_decode - 1)
        if self.metrics is not None:
            self.metrics.counter("tokens_generated").inc()
            if prev_t is None:      # first token of this request
                dt = req.first_token_t - req.arrival_t
                self.metrics.histogram("ttft_s").observe(dt)
                self.metrics.histogram(
                    f"ttft_s_class_{req.request_class}").observe(dt)
                if req.tenant != "default":
                    self.metrics.histogram(
                        f"ttft_s_tenant_{req.tenant}").observe(dt)
            else:
                dt = req.last_token_t - prev_t
                self.metrics.histogram("tpot_s").observe(dt)
                self.metrics.histogram(
                    f"tpot_s_class_{req.request_class}").observe(dt)
                if req.tenant != "default":
                    self.metrics.histogram(
                        f"tpot_s_tenant_{req.tenant}").observe(dt)

    def _on_finish(self, sreq, reason: str) -> None:
        with self._lock:
            if sreq.uid in self._failed_uids:
                return    # already failed over / failed by a death path
            req = self._active.pop(sreq.uid, None)
            if req is None:
                return
            self._outstanding = max(0, self._outstanding
                                    - req.outstanding_tokens)
            self._discharge_locked(req)
        if reason == "prefilled":
            # prefill-role completion (docs/SERVING.md "Disaggregated
            # serving"): the prompt's KV is resident in this engine —
            # hand the request to the frontend, which exports/stages the
            # blocks, flushes them here, and re-queues the request for a
            # decode-role replica. Runs on the worker thread, so the
            # engine access is race-free.
            if self._on_handoff is not None:
                self._on_handoff(req, sreq, self.engine, self.replica_id)
                return
            # defensive: a prefill-only scheduler with no handoff sink
            # is a config error the frontend should have rejected — free
            # the KV and fail the request rather than hang its stream
            try:
                self.engine.flush(req.uid)
            except Exception:
                pass
            req.finish(RequestState.FAILED, FinishReason.ERROR)
            if self.metrics is not None:
                self.metrics.counter("requests_failed").inc()
            return
        if reason == FinishReason.CANCELLED:
            req.finish(RequestState.CANCELLED, reason)
            if self.metrics is not None:
                self.metrics.counter("requests_cancelled").inc()
            return
        req.finish(RequestState.FINISHED, reason)
        if self.metrics is not None:
            self.metrics.counter("requests_completed").inc()
            self.metrics.histogram("e2e_latency_s").observe(
                time.monotonic() - req.arrival_t)

    _PREFIX_COUNTERS = (("hits", "prefix_blocks_hit"),
                        ("misses", "prefix_blocks_missed"),
                        ("evictions", "prefix_blocks_evicted"),
                        ("tokens_saved", "prefix_tokens_saved"))
    _SPEC_COUNTERS = (("proposed", "spec_tokens_proposed"),
                      ("accepted", "spec_tokens_accepted"),
                      ("emitted", "spec_tokens_emitted"),
                      ("decode_rows", "spec_decode_forwards"))
    _TIER_COUNTERS = (("spilled", "kv_tier_blocks_spilled"),
                      ("restored", "kv_tier_blocks_restored"),
                      ("dropped", "kv_tier_blocks_dropped"))
    _PREEMPT_COUNTERS = (("preempted", "sequences_preempted"),
                         ("resumed", "sequences_resumed"))

    def _publish_prefix_stats(self) -> None:
        """Forward the engine's monotonic prefix-cache counters (and the
        scheduler's speculative-decoding counters) into the registry as
        deltas (so multi-replica numbers sum correctly). Acceptance rate =
        spec_tokens_accepted / spec_tokens_proposed; tokens-per-forward =
        spec_tokens_emitted / spec_decode_forwards."""
        if self.metrics is None:
            return
        stats_fn = getattr(self.engine, "prefix_stats", None)
        if stats_fn is not None:
            stats = stats_fn()
            for key, name in self._PREFIX_COUNTERS:
                delta = stats.get(key, 0) - self._prefix_last.get(key, 0)
                if delta:
                    self.metrics.counter(name).inc(delta)
            self._prefix_last = stats
        # published with or without a proposer: plain decode rows count
        # one forward / one emitted token, so emitted/decode_forwards
        # reads 1.0 for a spec-off replica (and fleet-wide ratios keep an
        # honest denominator in mixed fleets)
        sstats = self.scheduler.spec_stats()
        for key, name in self._SPEC_COUNTERS:
            delta = sstats.get(key, 0) - self._spec_last.get(key, 0)
            if delta:
                self.metrics.counter(name).inc(delta)
        self._spec_last = sstats
        # tiered KV memory (docs/SERVING.md "KV tiering"): spill/restore
        # counters as deltas, per-block restore times into the histogram
        tier_fn = getattr(self.engine, "tier_stats", None)
        if tier_fn is not None:
            tstats = tier_fn()
            for key, name in self._TIER_COUNTERS:
                delta = tstats.get(key, 0) - self._tier_last.get(key, 0)
                if delta > 0:
                    self.metrics.counter(name).inc(delta)
            self._tier_last = tstats
        drain = getattr(self.engine, "drain_restore_times", None)
        if drain is not None:
            for dt in drain():
                self.metrics.histogram("kv_tier_restore_s").observe(dt)
        # admission overhaul (docs/SERVING.md "Admission and
        # preemption"): preempt/resume counters as deltas, spill/resume
        # wall times into their histograms, and one ops-journal
        # ``sequence_preempted`` event per spill
        pstats = self.scheduler.preempt_stats()
        for key, name in self._PREEMPT_COUNTERS:
            delta = pstats.get(key, 0) - self._preempt_last.get(key, 0)
            if delta > 0:
                self.metrics.counter(name).inc(delta)
        self._preempt_last = pstats
        spills, resumes = self.scheduler.drain_preempt_times()
        for dt in spills:
            self.metrics.histogram("preempt_spill_s").observe(dt)
        for dt in resumes:
            self.metrics.histogram("preempt_resume_s").observe(dt)
        if self.journal is not None:
            for ev in self.scheduler.drain_preempt_events():
                try:
                    self.journal.emit("sequence_preempted", uid=ev["uid"],
                                      blocks=ev["blocks"],
                                      replica=self.replica_id)
                except Exception:   # journal sink must not kill serving
                    pass

    def _enforce_slo(self) -> None:
        """Cancel/expire active requests; scheduler.cancel frees their KV
        blocks in the same iteration (no decode steps are wasted on them).
        The request is detached from ``_active`` first so the scheduler's
        on_finish("cancelled") no-ops and the terminal state carries the
        real cause (deadline vs explicit cancel)."""
        now = time.monotonic()
        for uid, req in list(self._active.items()):
            cancelled = req.cancel_requested.is_set()
            if not cancelled and not req.expired(now):
                continue
            del self._active[uid]
            self.scheduler.cancel(uid)
            if cancelled:
                self._fail_request(req, FinishReason.CANCELLED,
                                   RequestState.CANCELLED)
            else:
                self._fail_request(req, FinishReason.DEADLINE,
                                   RequestState.EXPIRED)

    def _loop(self) -> None:
        # grad mode is thread-local: this thread starts with grad on
        with torch.no_grad():
            self._run()

    def _run(self) -> None:
        while not self._stop.is_set() and self.state != ReplicaState.DEAD:
            try:
                self._admit_inbox()
                self._enforce_slo()
                if self._evacuate_cb is not None:
                    self._do_evacuate()
                if self.scheduler.has_work:
                    self._busy_since = self._busy_since or time.monotonic()
                    if self._faults is not None:
                        # crash raises into the except below (the real
                        # engine-fault path); wedge blocks right here
                        # (the shape the wedge watchdog detects)
                        self._faults.on_step(self.replica_id,
                                             self._steps_done)
                    self.scheduler.step()
                    self._steps_done += 1
                    self._publish_prefix_stats()
                    # routine-failure uids (cancel/deadline) can emit no
                    # further scheduler callbacks once the step that
                    # detached them completed — prune so the set doesn't
                    # grow for the life of a healthy replica. Death-path
                    # entries never reach here: the DEAD transition
                    # happens under this lock before any are added.
                    with self._lock:
                        if self._failed_uids and self.state in (
                                ReplicaState.HEALTHY,
                                ReplicaState.DRAINING):
                            self._failed_uids.clear()
                else:
                    self._busy_since = None
                    if self.state == ReplicaState.DRAINING:
                        break
                    self._stop.wait(self.idle_wait_s)
                self.last_progress_t = time.monotonic()
            except Exception as e:  # engine/scheduler fault → DEAD replica
                logger.error(f"serving replica {self.replica_id} died: {e!r}")
                if self.recorder is not None:
                    # flight-recorder dump while the evidence (recent
                    # spans, in-flight work, metric snapshots) is hot
                    self.recorder.on_error(f"replica-{self.replica_id}", e)
                self.state = ReplicaState.DEAD
                for req in list(self._active.values()):
                    self._fail_request(req, FinishReason.ERROR,
                                       RequestState.FAILED)
                self._reject_inbox()
                return
        if self.state != ReplicaState.DEAD:
            self.state = ReplicaState.STOPPED
        # a forced stop (stop() without drain, or drain timeout) exits with
        # work still active — those requests must terminate too, and (the
        # port's addition; the JAX worker leaves them) their KV blocks go
        # back to the pool from this thread, so an engine outlives its
        # frontend whole. Failing first detaches the uid, so the cancel's
        # on_finish callback no-ops.
        for uid, req in list(self._active.items()):
            self._fail_request(req, FinishReason.ERROR, RequestState.FAILED)
            self.scheduler.cancel(uid)
        self._reject_inbox()

    def _reject_inbox(self) -> None:
        """Fail anything that raced into the inbox after the loop decided
        to exit — a terminal state for every assigned request is part of
        the streaming contract (no stream may hang forever)."""
        while True:
            try:
                req = self._inbox.get_nowait()
            except queue.Empty:
                return
            self._fail_request(req, FinishReason.ERROR, RequestState.FAILED)
