"""Continuous-batching serving loop with Dynamic SplitFuse scheduling.

Counterpart of ``deepspeed_tpu/inference/v2/scheduler.py`` (the loop the
reference keeps in DeepSpeed-MII): requests enter a queue; each step packs
(a) one decode token for every running sequence and (b) prompt *chunks*
from prefilling and pending requests, splitting long prompts so every
forward has a near-constant token count.

This slice ports the greedy path with chunk-by-chunk admission.
Speculative decoding, preemption/reservation admission, the disaggregated
roles, cancellation, the per-token hooks and the tracer wait for later
slices (ROADMAP queue 1 items 9-10).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from .engine_v2 import InferenceEngineV2
from .scheduling_utils import SchedulingResult


@dataclasses.dataclass
class Request:
    uid: int
    prompt_tokens: List[int]
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    # state
    prompt_fed: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    last_logits: Optional[np.ndarray] = None
    done: bool = False
    finish_reason: Optional[str] = None

    @property
    def prompt_remaining(self) -> int:
        return len(self.prompt_tokens) - self.prompt_fed


class ContinuousBatchingScheduler:
    def __init__(self, engine: InferenceEngineV2,
                 sample_fn: Optional[Callable] = None):
        self.engine = engine
        self.pending: Deque[Request] = deque()
        self.running: Dict[int, Request] = {}
        self.finished: Dict[int, Request] = {}
        self.sample_fn = sample_fn or (lambda logits: int(np.argmax(logits)))
        self._budget = engine.config.max_ragged_batch_size
        self._max_seqs = engine.config.max_ragged_sequence_count
        self._chunk = engine.config.max_chunk_tokens

    def submit(self, uid: int, prompt_tokens: List[int],
               max_new_tokens: int = 64, eos_token_id: Optional[int] = None):
        self.pending.append(Request(uid, list(prompt_tokens), max_new_tokens,
                                    eos_token_id))

    @property
    def has_work(self) -> bool:
        return bool(self.pending or self.running)

    def _pack(self):
        """Dynamic SplitFuse packing: decodes first, then prompt chunks.

        Pure planning — no request state is mutated here (so a failed
        forward can be retried); admission is checked incrementally for
        decodes and prompt chunks, deferring what doesn't fit."""
        uids: List[int] = []
        chunks: List[List[int]] = []
        plan: List[tuple] = []        # (req, chunk, is_decode)
        budget = self._budget

        new_candidates = []
        while (self.pending
               and len(self.running) + len(new_candidates) < self._max_seqs):
            new_candidates.append(self.pending.popleft())
        candidates: List[Request] = [r for r in self.running.values()
                                     if r.prompt_remaining > 0]

        def admit(req, chunk) -> bool:
            ok = self.engine.can_schedule(
                uids + [req.uid], [len(c) for c in chunks] + [len(chunk)])
            if ok != SchedulingResult.Success:
                return False
            uids.append(req.uid)
            chunks.append(chunk)
            return True

        # (a) one token for every running (decode) sequence that fits
        for uid, req in list(self.running.items()):
            if req.prompt_remaining > 0 or budget <= 0:
                continue  # still prefilling (below) / out of budget (defer)
            chunk = [self.sample_fn(req.last_logits)]
            if admit(req, chunk):
                plan.append((req, chunk, True))
                budget -= 1
        # (b) prompt chunks: running-but-prefilling first, then pending
        for req in candidates + new_candidates:
            scheduled = False
            if budget > 0 and len(uids) < self._max_seqs:
                take = min(req.prompt_remaining, budget, self._chunk)
                chunk = req.prompt_tokens[req.prompt_fed:req.prompt_fed + take]
                if admit(req, chunk):
                    plan.append((req, chunk, False))
                    budget -= take
                    scheduled = True
            if not scheduled and req.uid not in self.running:
                self.pending.appendleft(req)   # new request deferred
        return uids, chunks, plan

    def step(self) -> List[int]:
        """One engine forward; returns uids of requests finished this step."""
        uids, chunks, plan = self._pack()
        if not uids:
            return []
        # np.asarray of a bf16 CUDA tensor fails: go through fp32 on the host
        logits = self.engine.put(uids, chunks).float().cpu().numpy()
        done_now = []
        # commit state only after the forward succeeded
        for i, (req, chunk, is_decode) in enumerate(plan):
            req.last_logits = logits[i]
            if is_decode:
                req.generated.append(chunk[0])
            else:
                req.prompt_fed += len(chunk)
                self.running[req.uid] = req
            if req.prompt_remaining > 0:
                continue  # mid-prefill: sample only once the prompt is done
            ended = (req.eos_token_id is not None and req.generated
                     and req.generated[-1] == req.eos_token_id)
            if len(req.generated) >= req.max_new_tokens or ended:
                req.done = True
                req.finish_reason = "eos" if ended else "length"
                self.finished[req.uid] = req
                self.running.pop(req.uid, None)
                self.engine.flush(req.uid)
                done_now.append(req.uid)
        return done_now

    def run_to_completion(self, max_steps: int = 10000) -> Dict[int, Request]:
        steps = 0
        while self.has_work and steps < max_steps:
            self.step()
            steps += 1
        return self.finished
