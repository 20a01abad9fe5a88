"""Typed request surface of the serving frontend.

A submitted request carries its QoS contract — priority, deadline,
max_new_tokens — and returns a :class:`RequestHandle` whose stream side is
a thread-safe iterator of :class:`TokenEvent` terminated by one
:class:`DoneEvent`. Overload is an *explicit* outcome: a frontend that
cannot take the request raises :class:`Rejected` with a machine-readable
reason instead of queueing unboundedly (the SLO contract — bounded latency
or a fast no).
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import time
from typing import Iterator, List, Optional, Union

from ..utils.locks import RankedLock


class Priority(enum.IntEnum):
    """Lower value = served first (heap order)."""
    HIGH = 0
    NORMAL = 1
    LOW = 2


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    REJECTED = "rejected"     # shed at admission (overloaded/draining)
    EXPIRED = "expired"       # deadline passed before completion
    FAILED = "failed"         # replica died / engine error


class FinishReason:
    EOS = "eos"
    LENGTH = "length"
    CANCELLED = "cancelled"
    DEADLINE = "deadline"
    ERROR = "error"            # engine fault / replica died mid-request
    NO_REPLICAS = "no_replicas"   # nothing healthy to dispatch to
    BROWNOUT = "brownout"      # shed by the degraded-capacity queue


class Rejected(Exception):
    """Load-shed signal: the request was NOT admitted. ``reason`` is one of
    "overloaded" (queue full), "draining" (frontend shutting down),
    "too_long" (prompt cannot ever fit)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"request rejected: {reason}"
                         + (f" ({detail})" if detail else ""))


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    uid: int
    token: int
    index: int            # 0-based position in the generated sequence
    t: float              # monotonic emission time


@dataclasses.dataclass(frozen=True)
class DoneEvent:
    uid: int
    reason: str           # a FinishReason value
    t: float


StreamEvent = Union[TokenEvent, DoneEvent]


class ServingRequest:
    """Internal per-request record; user code holds the RequestHandle."""

    _seq_lock = RankedLock("serving.request.seq")
    _seq = 0

    def __init__(self, prompt_tokens: List[int], max_new_tokens: int,
                 priority: int, deadline_s: Optional[float],
                 eos_token_id: Optional[int], *,
                 request_class: str = "interactive", shed_rank: int = 0,
                 tenant: str = "default", model_id: str = "default"):
        with ServingRequest._seq_lock:
            ServingRequest._seq += 1
            self.uid = ServingRequest._seq
        self.prompt_tokens = list(prompt_tokens)
        self.max_new_tokens = int(max_new_tokens)
        self.priority = int(priority)
        # request class (docs/SERVING.md "Disaggregated serving"):
        # labels per-class metrics and orders brownout victim selection
        # (higher shed_rank sheds first — batch before interactive)
        self.request_class = str(request_class)
        self.shed_rank = int(shed_rank)
        # multi-tenant / multi-model serving (docs/SERVING.md
        # "Multi-model & multi-tenant serving"): the tenant labels
        # fair-share accounting and per-tenant metrics; model_id pins
        # routing to that model's replica pool. Both default to
        # "default" — single-model, tenancy-off traffic never names them.
        self.tenant = str(tenant)
        self.model_id = str(model_id)
        self.eos_token_id = eos_token_id
        self.arrival_t = time.monotonic()
        # absolute monotonic deadline; None = no SLO
        self.deadline_t = (self.arrival_t + deadline_s
                           if deadline_s is not None else None)
        self.admitted_t: Optional[float] = None   # popped from the queue
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.finished_t: Optional[float] = None
        self.state = RequestState.QUEUED
        self.finish_reason: Optional[str] = None
        self.cancel_requested = threading.Event()
        self.replica_id: Optional[int] = None
        self.n_generated = 0
        # fault tolerance (docs/SERVING.md "Fault tolerance"): delivered
        # tokens are kept so a replica death can resume the request on
        # another replica from prompt + generated-so-far (lossless under
        # greedy decoding); ``attempts`` counts replica assignments
        self.generated_tokens: List[int] = []
        self.attempts = 1
        # disaggregated serving (docs/SERVING.md "Disaggregated
        # serving"): a prefill-role replica stages the finished prompt's
        # exported KV here for the decode-role replica to import;
        # ``_staged_release`` frees the staging-buffer slot (idempotent,
        # called from take_staged AND finish so a cancelled/expired/shed
        # staged request can never pin the buffer). ``no_prefill`` marks
        # a request whose handoff fell back to recompute: it must run
        # its full path on a decode-capable replica (a prefill-only
        # replica would just hand it off again). ``handoffs`` counts
        # completed prefill→decode transfers for the trace.
        self.staged_kv: Optional[dict] = None
        self._staged_release = None
        self.no_prefill = False
        self.handoff_t: Optional[float] = None
        self.handoffs = 0
        # per-attempt prefill charge the owning replica's load split
        # accounting holds (serving/replica.py)
        self._charged_prefill = 0
        self._events: "queue.Queue[StreamEvent]" = queue.Queue()
        self._done = threading.Event()
        # telemetry (docs/OBSERVABILITY.md): the frontend sets both when
        # its tracer is enabled; None otherwise so disabled telemetry
        # allocates nothing per request
        self.trace_id: Optional[str] = None
        self.spans: Optional[dict] = None

    # ------------------------------------------------------------- ordering
    @property
    def order_key(self):
        """Admission order: priority class first, then earliest deadline
        (requests without a deadline sort after all deadlined peers of the
        same priority), then FIFO by uid."""
        dl = self.deadline_t if self.deadline_t is not None else float("inf")
        return (self.priority, dl, self.uid)

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline_t is None:
            return False
        return (now if now is not None else time.monotonic()) > self.deadline_t

    @property
    def outstanding_tokens(self) -> int:
        """Work remaining: unprocessed prompt + undelivered generation
        budget (the router's least-outstanding-tokens load signal)."""
        return max(0, len(self.prompt_tokens) + self.max_new_tokens
                   - self.n_generated)

    @property
    def shed_key(self):
        """Brownout victim order (docs/SERVING.md "Disaggregated
        serving"): class shed rank FIRST (batch sheds before interactive
        regardless of priority), then lowest urgency within the class —
        the maximum over queued sheddable entries is the victim."""
        return (self.shed_rank,) + tuple(self.order_key)

    def take_staged(self) -> Optional[dict]:
        """Consume the staged KV handoff payload (one-shot): returns it
        and frees the staging-buffer slot. None when nothing is staged —
        the caller takes the re-prefill path."""
        payload, self.staged_kv = self.staged_kv, None
        self._release_staged()
        return payload

    def _release_staged(self) -> None:
        self.staged_kv = None
        rel, self._staged_release = self._staged_release, None
        if rel is not None:
            rel()

    # --------------------------------------------------------- failover
    @property
    def remaining_new_tokens(self) -> int:
        """Generation budget still owed to the stream (resume semantics:
        tokens already delivered are never re-generated)."""
        return max(0, self.max_new_tokens - self.n_generated)

    def resume_prompt(self) -> List[int]:
        """The prefix a retry must prefill: original prompt + every token
        already delivered. Greedy decoding of this prefix continues the
        stream byte-identically, so failover is lossless (and composes
        with the prefix cache — the re-prefill hits the shared index)."""
        return self.prompt_tokens + self.generated_tokens

    # ------------------------------------------------------------ telemetry
    def begin_span(self, tracer, name: str, attrs: Optional[dict] = None):
        """Open the next stage span of this request's trace (no-op when
        telemetry was off at submit). Parented under the root ``request``
        span; stages end their predecessor explicitly, and ``finish``
        closes whatever stage the request died in (``end`` is
        idempotent)."""
        if self.spans is None:
            return None
        sp = tracer.begin(name, trace_id=self.trace_id,
                          parent=self.spans.get("request"), attrs=attrs)
        self.spans[name] = sp
        return sp

    def end_span(self, name: str) -> None:
        sp = self.spans.get(name) if self.spans is not None else None
        if sp is not None:
            sp.end()

    # ------------------------------------------------------------ streaming
    def push_token(self, token: int) -> None:
        now = time.monotonic()
        if self.first_token_t is None:
            self.first_token_t = now
        self.last_token_t = now
        self._events.put(TokenEvent(self.uid, int(token),
                                    self.n_generated, now))
        self.generated_tokens.append(int(token))
        self.n_generated += 1

    def finish(self, state: RequestState, reason: str) -> None:
        if self._done.is_set():
            return
        # a terminal request can never consume its staged KV handoff —
        # drop the payload and free the staging slot
        self._release_staged()
        self.state = state
        self.finish_reason = reason
        self.finished_t = time.monotonic()
        if self.spans is not None:
            # terminal close-out: stamp the outcome on the root span and
            # end every stage still open (whichever stage the request
            # died in — end() is idempotent for stages already closed)
            root = self.spans.get("request")
            if root is not None:
                root.set("state", state.value).set("finish_reason", reason)
                root.set("generated", self.n_generated)
                root.set("attempts", self.attempts)
                if self.handoffs:
                    root.set("handoffs", self.handoffs)
            for sp in self.spans.values():
                sp.end()
        self._events.put(DoneEvent(self.uid, reason, self.finished_t))
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        """True once the request reached a terminal state (the tenancy
        ledger's reconcile predicate for releasing KV charges)."""
        return self._done.is_set()


class RequestHandle:
    """User-facing view: stream tokens, wait for the result, cancel."""

    def __init__(self, req: ServingRequest, frontend):
        self._req = req
        self._frontend = frontend

    @property
    def uid(self) -> int:
        return self._req.uid

    @property
    def state(self) -> RequestState:
        return self._req.state

    @property
    def finish_reason(self) -> Optional[str]:
        return self._req.finish_reason

    @property
    def attempts(self) -> int:
        """Replica assignments this request took (1 = no failover; >1 =
        the stream was spliced across replica deaths transparently)."""
        return self._req.attempts

    def cancel(self) -> None:
        self._frontend.cancel(self)

    def stream(self, timeout: Optional[float] = None) -> Iterator[TokenEvent]:
        """Yield TokenEvents as they arrive; returns on the DoneEvent.
        ``timeout`` bounds the wait for EACH event (raises queue.Empty)."""
        while True:
            ev = self._req._events.get(timeout=timeout)
            if isinstance(ev, DoneEvent):
                return
            yield ev

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until terminal; returns the generated tokens."""
        if not self._req.wait(timeout):
            raise TimeoutError(f"request {self.uid} not finished "
                               f"within {timeout}s")
        return [ev.token for ev in self.drain()]

    def drain(self) -> List[TokenEvent]:
        """Non-blocking: all TokenEvents buffered so far."""
        out = []
        while True:
            try:
                ev = self._req._events.get_nowait()
            except queue.Empty:
                return out
            if isinstance(ev, DoneEvent):
                # keep terminal visible to later drains/streams
                self._req._events.put(ev)
                return out
            out.append(ev)
