"""Draft proposers for speculative decoding (counterpart of
``deepspeed_tpu/inference/v2/spec/proposer.py``).

- :class:`NGramProposer`: prompt-lookup self-drafting — match the current
  suffix n-gram against an earlier occurrence in the sequence's own history
  and propose what followed it. No second model, no device work.
- :class:`DraftModelProposer`: a small same-family model runs greedily K
  steps ahead on its own port :class:`InferenceEngineV2`; rejected drafts
  roll back through the same ``trim_sequence``.

Proposers are advisory: any (possibly empty) token list is correct, since
verification never trusts them. The scheduler calls :meth:`release` when a
sequence finishes or is cancelled.
"""

from __future__ import annotations

from typing import Dict, List, Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class DraftProposer(Protocol):
    def propose(self, uid: int, context: Sequence[int],
                k: int) -> List[int]:
        """Up to ``k`` draft tokens predicted to follow ``context`` (the
        sequence's token history including the just-sampled token). Fewer,
        or none, is always legal."""
        ...

    def release(self, uid: int) -> None:
        """Drop any per-sequence state."""
        ...


class NGramProposer:
    """Prompt-lookup decoding (self-speculation).

    Finds the longest suffix of the context (``ngram_min..ngram_max``
    tokens) that also occurs earlier and proposes the tokens that followed
    it. Longer suffixes win; within a length, the occurrence with the
    longest continuation (up to ``k``), most recent on ties.
    ``max_history`` bounds the scan."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1,
                 max_history: int = 4096):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(f"need 1 <= ngram_min <= ngram_max, got "
                             f"{ngram_min}..{ngram_max}")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self.max_history = max_history

    @property
    def context_window(self):
        """Lookback bound: the scheduler passes only this many trailing
        context tokens."""
        return self.max_history

    def propose(self, uid: int, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context[-self.max_history:])
        L = len(ctx)
        if k <= 0 or L < self.ngram_min + 1:
            return []
        # one backward pass: at each earlier occurrence of the last token,
        # extend the suffix match leftward
        last = ctx[-1]
        n_cap = min(self.ngram_max, L - 1)
        best_n, best_cont = 0, []
        for j in range(L - 2, -1, -1):
            if ctx[j] != last:
                continue
            n = 1
            while n < n_cap and n <= j and ctx[j - n] == ctx[L - 1 - n]:
                n += 1
            if n < self.ngram_min:
                continue
            cont = ctx[j + 1:j + 1 + k]
            if n > best_n or (n == best_n and len(cont) > len(best_cont)):
                best_n, best_cont = n, cont
            if best_n == n_cap and len(best_cont) >= k:
                break                         # nothing can beat this
        return best_cont

    def release(self, uid: int) -> None:  # stateless
        pass


def _host(logits) -> np.ndarray:
    """A logits tensor as fp32 numpy (``np.asarray`` of a bf16 CUDA tensor
    fails)."""
    return logits.float().cpu().numpy()


class DraftModelProposer:
    """Greedy K-step lookahead with a small draft model on its own engine.

    Each call trims the draft engine's KV back to the longest common prefix
    of what it fed and the target's context (where the previous round's
    rejected drafts roll back), feeds the missing context tokens and decodes
    ``k`` tokens greedily: k single-token draft puts per decode row. Every
    draft put defers the prefix-cache chain (``defer_commit``), so a draft
    engine with the cache on never indexes a block a trim could cut."""

    # needs the full context from position 0 (the mirror diffs against it)
    context_window = None

    def __init__(self, engine):
        if getattr(engine, "tp", 1) > 1:
            from .... import not_ported

            raise not_ported("a draft model on a tensor-parallel engine",
                             "queue 1 item 14b-ii")
        self.engine = engine
        self._fed: Dict[int, List[int]] = {}      # uid -> tokens in draft KV
        self._last: Dict[int, np.ndarray] = {}    # uid -> last logits row

    def propose(self, uid: int, context: Sequence[int], k: int) -> List[int]:
        ctx = list(context)
        if k <= 0 or not ctx:
            return []
        # roll rejected drafts back first, even when no proposal follows
        fed = self._fed.setdefault(uid, [])
        p = 0
        while p < len(fed) and p < len(ctx) and fed[p] == ctx[p]:
            p += 1
        if p < len(fed):
            self.engine.trim_sequence(uid, len(fed) - p)
            del fed[p:]
        if len(ctx) + k > self.engine.model.cfg.max_seq_len:
            return []
        chunk_cap = self.engine.config.max_chunk_tokens
        pos = len(fed)
        while pos < len(ctx):
            take = min(chunk_cap, len(ctx) - pos)
            self._last[uid] = _host(self.engine.put(
                [uid], [ctx[pos:pos + take]], defer_commit=True))[0]
            fed.extend(ctx[pos:pos + take])
            pos += take
        if uid not in self._last:                 # ctx fully cached, no
            return []                             # logits to draft from
        drafts: List[int] = []
        for _ in range(k):
            t = int(np.argmax(self._last[uid]))
            drafts.append(t)
            self._last[uid] = _host(self.engine.put(
                [uid], [[t]], defer_commit=True))[0]
            fed.append(t)
        return drafts

    def release(self, uid: int) -> None:
        self._fed.pop(uid, None)
        self._last.pop(uid, None)
        if self.engine.state_manager.get_sequence(uid) is not None:
            self.engine.flush(uid)
