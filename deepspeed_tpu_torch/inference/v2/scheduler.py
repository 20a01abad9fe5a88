"""Continuous-batching serving loop with Dynamic SplitFuse scheduling.

Counterpart of ``deepspeed_tpu/inference/v2/scheduler.py`` (the loop the
reference keeps in DeepSpeed-MII): requests enter a queue; each step packs
(a) one decode token for every running sequence and (b) prompt *chunks*
from prefilling and pending requests, splitting long prompts so every
forward has a near-constant token count.

The features of the JAX scheduler, with its decisions step for step:

- prefix matching of every prompt candidate before admission (the engine's
  prefix cache; a no-op with it off);
- speculative decoding (``proposer``): a decode row carries ``[token,
  draft_1..draft_K]``, the forward returns the row's last W logits
  (``verify_width``, W the step's widest row bucketed to a power of two),
  ``verify_greedy`` accepts the longest agreeing prefix, and rejected
  tokens are trimmed before the accepted ones are committed to the prefix
  index;
- reservation admission (``admission_reservation`` on the engine config):
  a request reserves its whole projected KV need before its first chunk;
  with ``admission_preemption_enabled``, strictly less urgent sequences
  (higher ``shed_rank``) are exported to the host, freed and later
  re-imported, or re-prefilled if their payload is gone;
- ``submit_prefilled`` (a sequence whose KV was imported), ``cancel``,
  ``evacuate``, the ``prefill_only`` and ``decode_reserve_tokens`` roles,
  and the stats and drain methods;
- telemetry (``tracer``, ``telemetry/tracer.py``): a request submitted with
  a ``trace_id`` carries a ``prefill`` span from submission to its first
  token (with the prefix-cache and KV-tier outcome as attributes) and a
  ``decode`` span to its end; each put is a ``forward`` span under
  ``trace_label``, and the host verify of a speculative put a
  ``spec_verify`` span. With no tracer the loop uses ``NOOP_TRACER`` and
  allocates nothing for it.

A proposer's exception is not swallowed here, unlike the JAX loop, which
degrades it to "no drafts": a draft model runs its own engine on the
card, and a kernel's failure there must not pass silently.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from ...telemetry import NOOP_TRACER
from ...utils.logging import logger
from .engine_v2 import InferenceEngineV2
from .scheduling_utils import SchedulingResult
from .spec import DraftModelProposer, DraftProposer, verify_greedy


@dataclasses.dataclass
class Request:
    uid: int
    prompt_tokens: List[int]
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    # serving hooks: per-token delivery and a terminal notification with a
    # finish reason ("eos" | "length" | "cancelled" | "prefilled")
    on_token: Optional[Callable[[int, int], None]] = None
    on_finish: Optional[Callable[["Request", str], None]] = None
    # admission: shed_rank orders preemption victims (higher = less urgent,
    # preempted first); preempt_count caps how often one sequence may be
    # spilled; total_blocks is the reservation recorded at admission
    shed_rank: int = 0
    preempt_count: int = 0
    total_blocks: int = 0
    # state
    prompt_fed: int = 0
    prefix_matched: int = -1     # tokens served from the prefix cache
    #                              (-1 = lookup not yet performed)
    generated: List[int] = dataclasses.field(default_factory=list)
    last_logits: Optional[np.ndarray] = None
    done: bool = False
    finish_reason: Optional[str] = None
    # telemetry: set by submit() when the tracer is enabled and a trace id
    # was given; the open prefill/decode stage spans
    trace_id: Optional[str] = None
    spans: Optional[Dict[str, object]] = None

    @property
    def prompt_remaining(self) -> int:
        return len(self.prompt_tokens) - self.prompt_fed


def _host(logits) -> np.ndarray:
    """Logits on the host in fp32 (``np.asarray`` of a bf16 CUDA tensor
    fails)."""
    return logits.float().cpu().numpy()


class ContinuousBatchingScheduler:
    def __init__(self, engine: InferenceEngineV2,
                 sample_fn: Optional[Callable] = None,
                 proposer: Optional[DraftProposer] = None,
                 max_draft_tokens: int = 4,
                 tracer=None, trace_label: str = "scheduler",
                 prefill_only: bool = False,
                 decode_reserve_tokens: int = 0):
        self.engine = engine
        # disaggregated roles: a prefill-only scheduler finishes a request
        # whose prompt completes with reason "prefilled" and leaves its KV
        # resident for export; a decode-role scheduler holds part of each
        # step's budget back from prompt chunks
        self.prefill_only = bool(prefill_only)
        self.decode_reserve_tokens = int(decode_reserve_tokens)
        # per-put spans under ``trace_label``'s trace and per-request stage
        # spans; the NOOP tracer costs one ``enabled`` check a step
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.trace_label = trace_label
        self.pending: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.finished: Dict[int, Request] = {}
        self.sample_fn = sample_fn or (lambda logits: int(np.argmax(logits)))
        self._budget = engine.config.max_ragged_batch_size
        self._max_seqs = engine.config.max_ragged_sequence_count
        self._chunk = engine.config.max_chunk_tokens
        # speculative decoding is lossless only under greedy sampling: a
        # custom sample_fn turns the proposer off
        self.max_draft_tokens = max_draft_tokens
        self.proposer = proposer
        if getattr(engine, "tp", 1) > 1 \
                and isinstance(proposer, DraftModelProposer):
            from ... import not_ported

            raise not_ported("a draft-model proposer for a tensor-parallel "
                             "engine", "queue 1 item 14b-ii")
        if proposer is not None and sample_fn is not None:
            logger.warning(
                "speculative decoding requires greedy sampling; custom "
                "sample_fn given — proposer disabled for this scheduler")
            self.proposer = None
        self._spec_stats = {"proposed": 0, "accepted": 0, "emitted": 0,
                            "decode_rows": 0}
        # admission, read from the engine config (all-default = the
        # chunk-by-chunk admission)
        ecfg = engine.config
        self.reservation = bool(getattr(ecfg, "admission_reservation",
                                        False))
        self.oversubscription_factor = float(getattr(
            ecfg, "admission_oversubscription_factor", 1.0))
        self.preempt_enabled = bool(getattr(
            ecfg, "admission_preemption_enabled", False))
        self.victim_policy = str(getattr(
            ecfg, "admission_victim_policy", "lowest_class"))
        self.max_preemptions_per_seq = int(getattr(
            ecfg, "admission_max_preemptions_per_seq", 2))
        # parked (preempted) sequences in preemption order: uid -> {"req",
        # "tokens", "stashed", "last_logits", "fed", "n_blocks",
        # "total_blocks"}
        self.preempted: "OrderedDict[int, dict]" = OrderedDict()
        self._preempt_stats = {"preempted": 0, "resumed": 0}
        self._parked_blocks = 0           # device blocks parked seqs held
        self._last_shortfall = 0          # blocks the pending head is short
        self._preempt_events: List[dict] = []
        self._spill_times: List[float] = []
        self._resume_times: List[float] = []

    @property
    def spec_enabled(self) -> bool:
        return self.proposer is not None

    def spec_stats(self) -> Dict[str, int]:
        """Monotonic counters: ``proposed`` drafts that reached
        verification, ``accepted`` drafts delivered, ``emitted`` decode
        tokens and ``decode_rows`` (row-forwards; each would have emitted
        one token without speculation)."""
        return dict(self._spec_stats)

    def submit(self, uid: int, prompt_tokens: List[int],
               max_new_tokens: int = 64, eos_token_id: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               on_finish: Optional[Callable[[Request, str], None]] = None,
               trace_id: Optional[str] = None, shed_rank: int = 0):
        req = Request(uid, list(prompt_tokens), max_new_tokens,
                      eos_token_id, on_token, on_finish,
                      shed_rank=int(shed_rank))
        if trace_id is not None and self.tracer.enabled:
            # the prefill stage starts at submission: a wait for a packing
            # slot is prefill time from the request's point of view
            req.trace_id = trace_id
            req.spans = {"prefill": self.tracer.begin(
                "prefill", trace_id=trace_id,
                attrs={"prompt_tokens": len(req.prompt_tokens)})}
        self.pending.append(req)

    def submit_prefilled(self, uid: int, prompt_tokens: List[int],
                         last_logits, max_new_tokens: int = 64,
                         eos_token_id: Optional[int] = None,
                         on_token: Optional[Callable[[int, int], None]] = None,
                         on_finish: Optional[Callable[["Request", str],
                                                      None]] = None,
                         trace_id: Optional[str] = None,
                         shed_rank: int = 0) -> Request:
        """Resume a sequence whose prompt KV was imported
        (``engine.import_sequence`` ran first): it enters ``running`` with
        the prompt fed and the source's last logits, so its first decode
        step samples the token the source would have."""
        req = Request(uid, list(prompt_tokens), max_new_tokens,
                      eos_token_id, on_token, on_finish,
                      shed_rank=int(shed_rank))
        req.prompt_fed = len(req.prompt_tokens)
        req.prefix_matched = 0       # no lookup: the KV arrived whole
        req.last_logits = np.asarray(last_logits)
        if self.reservation:
            # the blocks are already resident: record the reservation even
            # on a shortfall (the preemption pass repairs it)
            req.total_blocks = self._total_blocks(req)
            if not self.engine.try_reserve(uid, req.total_blocks):
                self.engine.force_reserve(uid, req.total_blocks)
        if trace_id is not None and self.tracer.enabled:
            # no prefill stage here; the decode span opens at the first token
            req.trace_id = trace_id
            req.spans = {}
        self.running[uid] = req
        return req

    def _take(self, uid: int) -> Optional[Request]:
        """Remove a request from running, parked or pending; None if none."""
        req = self.running.pop(uid, None)
        if req is None:
            entry = self.preempted.pop(uid, None)
            if entry is not None:
                req = entry["req"]
                self._parked_blocks -= entry["n_blocks"]
                self.engine.preempt_discard(uid)
        if req is None:
            for r in self.pending:
                if r.uid == uid:
                    req = r
                    self.pending.remove(r)
                    break
        return req

    def cancel(self, uid: int) -> bool:
        """Abort a request wherever it is and free its KV blocks now.
        Returns False for unknown or finished uids."""
        req = self._take(uid)
        if req is None or req.done:
            return False
        self.engine.flush(uid)
        if self.proposer is not None:
            self.proposer.release(uid)
        self._end_request_spans(req, "cancelled")
        req.done = True
        req.finish_reason = "cancelled"
        self.finished[uid] = req
        if req.on_finish is not None:
            req.on_finish(req, "cancelled")
        return True

    def evacuate(self, uid: int) -> Optional[Dict[str, object]]:
        """Detach a sequence for migration to another engine without
        settling it (no ``done`` mark, no ``on_finish``): it leaves this
        scheduler and its blocks are freed. A fully prefilled running
        sequence's KV is exported and returned (with ``last_logits``) for
        the destination to import; anything else — pending, mid-prefill,
        parked (its stash is dropped), or an export that fails — returns
        ``None`` and is re-prefilled there. ``None`` also for unknown or
        finished uids."""
        payload = None
        req = self.running.pop(uid, None)
        if req is not None:
            if (req.prompt_remaining == 0 and not req.done
                    and req.last_logits is not None):
                try:
                    payload = self.engine.export_sequence(uid)
                except Exception as e:
                    logger.warning(f"evacuation KV export for sequence "
                                   f"{uid} failed ({e!r}); falling back "
                                   "to re-prefill")
                    payload = None
                if payload is not None:
                    payload["last_logits"] = req.last_logits
        else:
            req = self._take(uid)
        if req is None or req.done:
            return None
        try:
            self.engine.flush(uid)     # frees blocks + releases reservation
        except Exception as e:
            logger.warning(f"evacuation flush of sequence {uid} failed "
                           f"({e!r})")
        if self.proposer is not None:
            self.proposer.release(uid)
        self._end_request_spans(req, "evacuated")
        return payload

    @property
    def has_work(self) -> bool:
        return bool(self.pending or self.running or self.preempted)

    def _pack(self):
        """Dynamic SplitFuse packing: decodes first, then prompt chunks.

        Pure planning — no request state is mutated here (so a failed
        forward can be retried); admission is checked incrementally,
        deferring what doesn't fit. Prompt candidates are prefix-matched
        before any admission check: a match pins shared blocks, which moves
        them out of the evictable count admission reads."""
        uids: List[int] = []
        chunks: List[List[int]] = []
        plan: List[tuple] = []        # (req, chunk, is_decode)
        budget = self._budget

        if self.reservation:
            self._maybe_restore_headroom()
            self._resume_preempted()
            new_candidates = self._admit_pending_reserved()
        else:
            new_candidates = []
            while (self.pending
                   and len(self.running) + len(new_candidates) < self._max_seqs):
                new_candidates.append(self.pending.popleft())
        candidates: List[Request] = [r for r in self.running.values()
                                     if r.prompt_remaining > 0]
        for req in candidates + new_candidates:
            self._match_prefix_for(req)

        def admit(req, chunk) -> bool:
            ok = self.engine.can_schedule(
                uids + [req.uid], [len(c) for c in chunks] + [len(chunk)])
            if ok != SchedulingResult.Success:
                return False
            uids.append(req.uid)
            chunks.append(chunk)
            return True

        # (a) one token for every running (decode) sequence that fits, plus
        # up to max_draft_tokens drafts when speculating
        for uid, req in list(self.running.items()):
            if self.prefill_only:
                break     # prefill-role: decode rows never pack here
            if req.prompt_remaining > 0 or budget <= 0:
                continue  # still prefilling (below) / out of budget (defer)
            tok = self.sample_fn(req.last_logits)
            chunk = [tok]
            if self.proposer is not None:
                k = min(self.max_draft_tokens, budget - 1, self._chunk - 1,
                        req.max_new_tokens - len(req.generated) - 1)
                if k > 0:
                    drafts = self._propose(req, tok, k)
                    if drafts:
                        chunk = [tok] + [int(d) for d in drafts[:k]]
            if admit(req, chunk):
                plan.append((req, chunk, True))
                budget -= len(chunk)
            elif len(chunk) > 1 and admit(req, [tok]):
                # the speculative chunk did not fit: plain decode instead
                plan.append((req, [tok], True))
                budget -= 1
        # (b) prompt chunks: running-but-prefilling first, then pending; a
        # decode-role scheduler holds back the unused part of its decode
        # reservation (at least one prompt token can always go)
        reserve = 0
        if self.decode_reserve_tokens > 0:
            decode_used = self._budget - budget
            reserve = max(0, self.decode_reserve_tokens - decode_used)
            reserve = min(reserve, max(0, budget - 1))
        prompt_budget = budget - reserve
        for req in candidates + new_candidates:
            scheduled = False
            if prompt_budget > 0 and len(uids) < self._max_seqs:
                take = min(req.prompt_remaining, prompt_budget, self._chunk)
                chunk = req.prompt_tokens[req.prompt_fed:req.prompt_fed + take]
                if admit(req, chunk):
                    plan.append((req, chunk, False))
                    budget -= take
                    prompt_budget -= take
                    scheduled = True
            if not scheduled and req.uid not in self.running:
                self.pending.appendleft(req)   # new request deferred
        return uids, chunks, plan

    def _match_prefix_for(self, req: Request) -> None:
        """One-time prefix-cache lookup for a candidate; matched blocks stay
        shared across deferral until finish or cancel flushes. A traced
        request's prefill span gets the matched tokens and how many of its
        blocks came back from the KV tier."""
        if req.prefix_matched >= 0:
            return
        # the tier's counters are read only when tracing
        tier_fn = self.engine.tier_stats if req.spans is not None else None
        restored0 = tier_fn()["restored"] if tier_fn else 0
        req.prefix_matched = self.engine.match_prefix(req.uid,
                                                      req.prompt_tokens)
        if req.prefix_matched > 0:
            req.prompt_fed = req.prefix_matched
        if req.spans is not None:
            req.spans["prefill"].set("prefix_matched_tokens",
                                     req.prefix_matched)
            if tier_fn:
                req.spans["prefill"].set(
                    "kv_tier_restored_blocks",
                    tier_fn()["restored"] - restored0)

    # ------------------------------- reservation admission + preemption
    def _total_blocks(self, req: Request) -> int:
        """A request's total projected KV blocks: prompt plus the generation
        budget still owed, clamped to the pool (a request the pool can never
        hold whole is admitted best-effort)."""
        bs = self.engine.config.kv_block_size
        total = (len(req.prompt_tokens)
                 + max(0, req.max_new_tokens - len(req.generated)))
        return min(-(-total // bs), self.engine.config.kv_blocks)

    def _admit_pending_reserved(self) -> List[Request]:
        """Pull pending requests under total-block reservation: FIFO within
        an urgency class, but a blocked head does not hold back strictly
        more urgent work behind it."""
        out: List[Request] = []
        self._last_shortfall = 0
        blocked_rank: Optional[int] = None    # most urgent rank blocked
        i = 0
        while (i < len(self.pending)
               and len(self.running) + len(out) < self._max_seqs):
            req = self.pending[i]
            if blocked_rank is not None and req.shed_rank >= blocked_rank:
                i += 1
                continue
            if self._try_admit(req):
                del self.pending[i]
                out.append(req)
            else:
                blocked_rank = (req.shed_rank if blocked_rank is None
                                else min(blocked_rank, req.shed_rank))
                i += 1
        return out

    def _try_admit(self, req: Request) -> bool:
        """Prefix-match (cached blocks credit the need), then reserve the
        total; on a shortfall preempt less urgent victims if enabled. A
        request that still cannot reserve is rolled back and waits."""
        total = self._total_blocks(req)
        self._match_prefix_for(req)
        if self.engine.try_reserve(req.uid, total):
            req.total_blocks = total
            return True
        if self.preempt_enabled and self._preempt_for(req, total):
            if self.engine.try_reserve(req.uid, total):
                req.total_blocks = total
                return True
        # the waiting sequence keeps nothing; the match re-runs next time
        self.engine.flush(req.uid)
        req.prefix_matched = -1
        req.prompt_fed = 0
        self._last_shortfall = max(
            self._last_shortfall,
            total - max(0, self.engine.reservation_headroom()))
        return False

    def _victim_order(self, req: Request, blocks: int):
        """Sort key, largest preempted first. ``lowest_class`` (default):
        least urgent class, then most blocks, then least progress;
        ``most_blocks`` and ``least_progress`` reorder the tie-breakers."""
        progress = req.prompt_fed + len(req.generated)
        if self.victim_policy == "most_blocks":
            return (blocks, req.shed_rank, -progress)
        if self.victim_policy == "least_progress":
            return (-progress, req.shed_rank, blocks)
        return (req.shed_rank, blocks, -progress)

    def _eligible_victims(self, min_rank: Optional[int] = None) -> List[tuple]:
        """(req, freeable blocks) candidates, best victim first: strictly
        less urgent than ``min_rank`` when given, under the per-sequence
        preemption cap, with blocks a flush would really free."""
        out = []
        for uid, req in self.running.items():
            if req.preempt_count >= self.max_preemptions_per_seq:
                continue
            if min_rank is not None and req.shed_rank <= min_rank:
                continue
            blocks = self.engine.freeable_blocks_of(uid)
            if blocks <= 0:
                continue
            out.append((req, blocks))
        out.sort(key=lambda t: self._victim_order(*t), reverse=True)
        return out

    def _preempt_for(self, req: Request, total: int) -> bool:
        """Spill less urgent victims until ``req`` can reserve, within the
        cap ``oversubscription_factor x kv_blocks`` on resident plus parked
        reservations. False, touching nothing, when the victims cannot
        cover the shortfall."""
        committed = (self.engine.reserved_total_blocks()
                     + sum(e["total_blocks"] for e in self.preempted.values()))
        cap = self.oversubscription_factor * self.engine.config.kv_blocks
        if committed + total > cap:
            return False
        victims = self._eligible_victims(min_rank=req.shed_rank)
        have = self.engine.query(req.uid)[1]     # prefix-matched credit
        shortfall = (max(0, total - have)
                     - max(0, self.engine.reservation_headroom()))
        freeable = sum(b for _, b in victims)
        if freeable < shortfall:
            return False
        freed = 0
        for victim, blocks in victims:
            if freed >= shortfall:
                break
            self._preempt(victim)
            freed += blocks
        return True

    def _maybe_restore_headroom(self) -> None:
        """Repair a negative headroom (a ``force_reserve`` of an import) by
        spilling victims of any class."""
        if not self.preempt_enabled:
            return
        while self.engine.reservation_headroom() < 0:
            victims = self._eligible_victims()
            if not victims:
                return
            self._preempt(victims[0][0])

    def _preempt(self, req: Request) -> int:
        """Spill one running sequence: export its KV (slabs and scale
        planes) into the engine's host store, free its blocks and park it.
        Returns the blocks its export held."""
        t0 = time.perf_counter()
        uid = req.uid
        payload = self.engine.export_sequence(uid)
        n_blocks = int(payload["n_blocks"]) if payload else 0
        if payload is not None:
            self.engine.preempt_stash(uid, payload)
        # the tokens the exported KV encodes, replayed into the prefix
        # index at import
        tokens = req.prompt_tokens[:req.prompt_fed] + list(req.generated)
        self.engine.flush(uid)        # frees blocks + releases reservation
        self.running.pop(uid, None)
        if self.proposer is not None:
            self.proposer.release(uid)
        req.preempt_count += 1
        self.preempted[uid] = {
            "req": req, "tokens": tokens, "stashed": payload is not None,
            "last_logits": req.last_logits, "fed": req.prompt_fed,
            "n_blocks": n_blocks,
            "total_blocks": req.total_blocks or self._total_blocks(req)}
        self._parked_blocks += n_blocks
        self._preempt_stats["preempted"] += 1
        self._preempt_events.append({"uid": uid, "blocks": n_blocks})
        self._spill_times.append(time.perf_counter() - t0)
        if len(self._spill_times) > 4096:        # bounded when undrained
            del self._spill_times[:2048]
        return n_blocks

    def _resume_preempted(self) -> None:
        """Bring parked sequences back, oldest first, while a seat and the
        whole reservation's headroom exist. The payload imports bit for
        bit; a payload that is gone (or refused) degrades to a greedy
        re-prefill of prompt + delivered tokens."""
        for uid in list(self.preempted):
            if len(self.running) >= self._max_seqs:
                return
            entry = self.preempted[uid]
            total = entry["total_blocks"]
            if total > self.engine.reservation_headroom():
                return
            t0 = time.perf_counter()
            req: Request = entry["req"]
            payload = (self.engine.preempt_restore_payload(uid)
                       if entry["stashed"] else None)
            if payload is not None:
                try:
                    self.engine.import_sequence(uid, payload,
                                                tokens=entry["tokens"])
                except (ValueError, RuntimeError) as e:
                    logger.warning(
                        f"preemption resume import for sequence {uid} "
                        f"failed ({e!r}); re-prefilling")
                    payload = None
            if payload is not None:
                req.prompt_fed = entry["fed"]
                req.last_logits = entry["last_logits"]
            else:
                # re-prefill everything the KV held: the delivered tokens
                # fold into the prompt, ``generated`` keeps the budget
                req.prompt_tokens = list(entry["tokens"]) + \
                    req.prompt_tokens[entry["fed"]:]
                req.prompt_fed = 0
                req.prefix_matched = -1
                req.last_logits = None
            self.engine.force_reserve(uid, total)
            req.total_blocks = total
            del self.preempted[uid]
            self._parked_blocks -= entry["n_blocks"]
            self.running[uid] = req
            self._preempt_stats["resumed"] += 1
            self._resume_times.append(time.perf_counter() - t0)
            if len(self._resume_times) > 4096:
                del self._resume_times[:2048]

    # ------------------------------------------------- preemption counters
    def preempt_stats(self) -> Dict[str, int]:
        """Monotonic counters: sequences ``preempted`` and ``resumed``."""
        return dict(self._preempt_stats)

    def preempted_resident_blocks(self) -> int:
        """Device blocks the parked sequences held when spilled."""
        return self._parked_blocks

    def reserve_shortfall_blocks(self) -> int:
        """Blocks the pending head was short of reserving at the last
        packing pass (0 with reservation off or nothing waiting)."""
        return self._last_shortfall

    def drain_preempt_times(self):
        """(spill wall times, resume wall times) since the last drain."""
        spills, self._spill_times = self._spill_times, []
        resumes, self._resume_times = self._resume_times, []
        return spills, resumes

    def drain_preempt_events(self) -> List[dict]:
        """One record per preemption since the last drain."""
        out, self._preempt_events = self._preempt_events, []
        return out

    def _propose(self, req: Request, tok: int, k: int) -> List[int]:
        """The proposer's drafts; one with a bounded lookback
        (``context_window``) gets only that tail of the context."""
        win = getattr(self.proposer, "context_window", None)
        if win is None:
            ctx = req.prompt_tokens + req.generated + [tok]
        else:
            need = max(win - 1, 0)
            gen = req.generated
            if len(gen) >= need:
                ctx = gen[len(gen) - need:] + [tok]
            else:
                ctx = (req.prompt_tokens[max(0, len(req.prompt_tokens)
                                             - (need - len(gen))):]
                       + gen + [tok])
        return self.proposer.propose(req.uid, ctx, k)

    # ----------------------------------------------------------- telemetry
    def _note_first_token(self, req: Request) -> None:
        """At a traced request's first token the prefill span ends (the
        TTFT endpoint) and the decode span opens."""
        if req.spans is None:
            return
        sp = req.spans.pop("prefill", None)
        if sp is not None:
            sp.end()
        req.spans["decode"] = self.tracer.begin("decode",
                                                trace_id=req.trace_id)

    def _end_request_spans(self, req: Request, reason: str) -> None:
        if req.spans is None:
            return
        dec = req.spans.get("decode")
        if dec is not None:
            dec.set("generated", len(req.generated))
            dec.set("finish_reason", reason)
        for sp in req.spans.values():
            sp.end()
        req.spans = None

    def _finish(self, req: Request, reason: str, flush: bool) -> None:
        self._end_request_spans(req, reason)
        req.done = True
        req.finish_reason = reason
        self.finished[req.uid] = req
        self.running.pop(req.uid, None)
        if flush:
            self.engine.flush(req.uid)
        if self.proposer is not None:
            self.proposer.release(req.uid)
        if req.on_finish is not None:
            req.on_finish(req, reason)

    def step(self) -> List[int]:
        """One engine forward; returns uids of requests finished this step."""
        uids, chunks, plan = self._pack()
        if not uids:
            return []
        # the widest speculative decode row; a step without drafts takes
        # the plain path
        spec_w = max((len(c) for _, c, d in plan if d and len(c) > 1),
                     default=0)
        spec = self.proposer is not None and spec_w > 0
        # the put's span brackets the forward and the logits' copy to host
        traced = self.tracer.enabled
        fspan = self.tracer.begin(
            "forward", trace_id=self.trace_label,
            attrs={"n_seqs": len(uids),
                   "n_tokens": int(sum(len(c) for c in chunks))}) \
            if traced else None
        vspan = None
        if spec:
            W = self.engine.batch._bucket(spec_w, self._chunk)
            if traced:
                fspan.set("verify_width", W)
            # the prefix chain is committed per row below, once rejected
            # drafts are trimmed
            logits = _host(self.engine.put(uids, chunks, verify_width=W,
                                           defer_commit=True))
            # the host verify, trim and commit of this step
            vspan = self.tracer.begin("spec_verify",
                                      trace_id=self.trace_label,
                                      attrs={"verify_width": W}) \
                if traced else None
        else:
            logits = _host(self.engine.put(uids, chunks))
        if traced:
            fspan.end()
        done_now = []
        # commit state only after the forward succeeded
        for i, (req, chunk, is_decode) in enumerate(plan):
            if not spec:
                req.last_logits = logits[i]
                if is_decode:
                    if not req.generated:
                        self._note_first_token(req)
                    self._emit(req, chunk[0])
                    self._spec_stats["decode_rows"] += 1
                else:
                    req.prompt_fed += len(chunk)
                    self.running[req.uid] = req
            elif is_decode:
                # row i's valid positions are its last len(chunk) slots
                self._apply_verified(req, chunk,
                                     logits[i, logits.shape[1] - len(chunk):])
            else:
                req.last_logits = logits[i, -1]   # slot W-1 = last valid
                self.engine.commit_tokens(req.uid, chunk)
                req.prompt_fed += len(chunk)
                self.running[req.uid] = req
            if req.prompt_remaining > 0:
                continue  # mid-prefill: sample only once the prompt is done
            if self.prefill_only:
                # the KV stays resident for the handoff export
                self._finish(req, "prefilled", flush=False)
                done_now.append(req.uid)
                continue
            ended = (req.eos_token_id is not None and req.generated
                     and req.generated[-1] == req.eos_token_id)
            if len(req.generated) >= req.max_new_tokens or ended:
                self._finish(req, "eos" if ended else "length", flush=True)
                done_now.append(req.uid)
        if vspan is not None:
            vspan.end()
        return done_now

    def _emit(self, req: Request, token: int) -> None:
        req.generated.append(token)
        self._spec_stats["emitted"] += 1
        if req.on_token is not None:
            req.on_token(req.uid, token)

    def _apply_verified(self, req: Request, chunk: List[int],
                        rows: np.ndarray) -> None:
        """Accept the longest agreeing draft prefix, trim the rejected tail
        from the KV cache, commit the surviving tokens to the prefix chain,
        and emit them (stopping at EOS, where plain greedy decoding would
        stop)."""
        emitted, last = verify_greedy(chunk, rows)
        if req.eos_token_id is not None and req.eos_token_id in emitted:
            cut = emitted.index(req.eos_token_id) + 1
            emitted, last = emitted[:cut], cut - 1
        rejected = len(chunk) - len(emitted)
        if rejected:
            self.engine.trim_sequence(req.uid, rejected)
        self.engine.commit_tokens(req.uid, emitted)
        req.last_logits = rows[last]
        self._spec_stats["decode_rows"] += 1
        self._spec_stats["proposed"] += len(chunk) - 1
        self._spec_stats["accepted"] += len(emitted) - 1
        if not req.generated and emitted:
            self._note_first_token(req)
        if req.spans is not None:
            # this request's speculation outcome, on its decode span
            dec = req.spans.get("decode")
            if dec is not None:
                a = dec.attrs
                a["spec_proposed"] = a.get("spec_proposed", 0) + len(chunk) - 1
                a["spec_accepted"] = a.get("spec_accepted", 0) + len(emitted) - 1
        for t in emitted:
            self._emit(req, t)

    def run_to_completion(self, max_steps: int = 10000) -> Dict[int, Request]:
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
