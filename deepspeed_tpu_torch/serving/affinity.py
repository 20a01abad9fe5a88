"""Fleet-wide KV locality: prefix-affinity scoring for the router.

Counterpart of ``deepspeed_tpu/serving/affinity.py``: :func:`chain_hashes`
gives exactly the keys the port's ``DSStateManager`` indexes
(``inference/v2/ragged/manager.py``), which are the JAX package's keys.

The per-replica prefix cache (docs/SERVING.md "Prefix caching") and the
tiered KV store make each engine excellent at reusing KV — but routing
was cache-BLIND: ``ReplicaRouter._cost`` is pure outstanding-token
load, so two requests sharing a 4k system prompt could land on
different replicas and each pay full prefill. This module makes KV
placement a fleet-level concern (docs/SERVING.md "Fleet KV locality"):

- :func:`chain_hashes` computes a request's block-chain hashes ONCE per
  ``pick(req)`` — the same ``(parent_hash, block_tokens)`` chain
  ``DSStateManager.match_prefix`` walks, computable from the prompt
  alone, so the router can predict a replica's cache hits without
  touching any engine.
- :class:`AffinityState` holds the fleet's prefix digests (bounded
  chain-hash sets; local replicas polled on the router's ~1/s tick,
  remote ones ride the fabric ``status`` stream) and scores digest
  overlap into the pick as a prefill-token credit, with a per-replica
  affinity-share cap so shared-prefix traffic herds to warm replicas
  WITHOUT re-creating the hot-replica pile-up the split cost model
  fixed.

Disabled (``affinity.enabled: false``, the default) builds none of
this — the router's pick path is byte-for-byte the historical
least-outstanding-tokens selection.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from ..utils.locks import RankedLock


def chain_hashes(prompt_tokens: Sequence[int], block_size: int) -> List[int]:
    """The prompt's block-chain hashes, exactly as
    ``DSStateManager.match_prefix`` / ``record_tokens`` compute them:
    entry ``i`` is the hash a replica's prefix index holds for the
    prompt's ``i``-th full block. Capped at ``len(prompt) - 1`` like the
    match walk (at least one token is always left to prefill)."""
    limit = len(prompt_tokens) - 1
    out: List[int] = []
    h = 0
    n = 0
    while n + block_size <= limit:
        key = (h, tuple(int(t) for t in prompt_tokens[n:n + block_size]))
        h = hash(key)
        out.append(h)
        n += block_size
    return out


class AffinityState:
    """Fleet prefix-digest table + affinity-aware pick scoring.

    The router owns one instance (``affinity:`` block enabled) and calls
    :meth:`refresh` from its ~1/s tick and :meth:`choose` from
    ``pick(req)``. Digests are *advisory*: a replica with no digest
    (feature-less engine, digest-less fabric peer) simply earns zero
    credit — cache-blind, never refused.
    """

    # lock discipline (docs/CONCURRENCY.md): the digest table is
    # REPLACED (publication) by the router tick / status consumers and
    # read by the pick path; the share window and hit/miss tallies are
    # mutated per pick from the dispatch thread and read by tests/bench.
    _GUARDED_BY = {"_digests": "_lock:writes", "_recent": "_lock",
                   "_stats": "_lock"}

    def __init__(self, cfg, metrics=None):
        self.cfg = cfg
        self.metrics = metrics
        self._lock = RankedLock("serving.affinity")
        self._digests: Dict[int, frozenset] = {}
        # recent affinity-steered winners (replica ids): the share cap's
        # evidence window — a replica already holding >= max_share of it
        # gets its credit zeroed for the pick, so warm herding can never
        # re-create the hot-replica pile-up
        self._recent: deque = deque(maxlen=max(1, int(cfg.share_window)))
        self._stats = {"hits": 0, "misses": 0, "tokens_saved": 0}
        self._refresh_t = 0.0

    # ------------------------------------------------------------- digests
    def refresh(self, replicas, now: Optional[float] = None) -> None:
        """Cadence-gated digest sweep (router tick): ask every replica
        that can answer for its current digest. Local replicas read
        their engine's prefix index + tier keys; remote handles return
        the last digest their server's status stream carried. A replica
        that cannot answer keeps no entry (zero credit)."""
        now = time.monotonic() if now is None else now
        if now - self._refresh_t < self.cfg.refresh_interval_s:
            return
        self._refresh_t = now
        fresh: Dict[int, frozenset] = {}
        for r in replicas:
            fn = getattr(r, "prefix_digest", None)
            if fn is None:
                continue
            try:
                digest = frozenset(fn(self.cfg.digest_max_entries))
            except Exception:
                continue            # a sick replica is cache-blind, not fatal
            if digest:
                fresh[r.replica_id] = digest
        with self._lock:
            self._digests = fresh

    def digest_of(self, replica_id: int) -> frozenset:
        return self._digests.get(replica_id, frozenset())

    # ---------------------------------------------------------------- pick
    def choose(self, req, candidates, cost_fn, block_size: int,
               prefill_token_cost: float = 1.0):
        """Affinity-aware selection among ``candidates``, or ``None`` to
        fall back to the caller's plain ``min(candidates, key=cost_fn)``
        (no hashable prefix, or no replica holds any of it). Hashes the
        request's block chain ONCE and memoizes per-candidate overlap
        credits for the pick; the winning credit is the predicted
        prefill tokens saved, subtracted from the load term of
        ``cost_fn`` weighted by ``credit_weight``."""
        hashes = chain_hashes(req.prompt_tokens, block_size)
        if not hashes:
            return None
        digests = self._digests        # lock-free published snapshot
        weight = self.cfg.credit_weight * prefill_token_cost
        credits: Dict[int, int] = {}
        any_credit = False
        for r in candidates:
            digest = digests.get(r.replica_id)
            if not digest:
                credits[r.replica_id] = 0
                continue
            # leading-run overlap, like the match walk: reuse stops at
            # the first missing block, so trailing hits earn nothing
            blocks = 0
            for h in hashes:
                if h not in digest:
                    break
                blocks += 1
            tokens = blocks * block_size
            credits[r.replica_id] = tokens
            any_credit = any_credit or tokens > 0
        if not any_credit:
            with self._lock:
                self._stats["misses"] += 1
            if self.metrics is not None:
                self.metrics.counter("router_affinity_misses").inc()
            return None
        with self._lock:
            capped = {rid for rid in credits
                      if self._share_exceeded_locked(rid)}
        best = min(
            candidates,
            key=lambda r: (cost_fn(r)[0]
                           - (0 if r.replica_id in capped
                              else credits[r.replica_id]) * weight,
                           r.replica_id))
        won = credits.get(best.replica_id, 0)
        if won <= 0 or best.replica_id in capped:
            # affinity knew something but the load term (or the share
            # cap) overruled it — an affinity miss from the fleet's view
            with self._lock:
                self._stats["misses"] += 1
            if self.metrics is not None:
                self.metrics.counter("router_affinity_misses").inc()
            return best
        with self._lock:
            self._recent.append(best.replica_id)
            self._stats["hits"] += 1
            self._stats["tokens_saved"] += won
        if self.metrics is not None:
            self.metrics.counter("router_affinity_hits").inc()
            self.metrics.counter("prefix_tokens_saved_fleet").inc(won)
        return best

    def _share_exceeded_locked(self, replica_id: int) -> bool:
        """True when the replica already owns >= ``max_share`` of the
        share window's CAPACITY — an absolute bound, so a near-empty
        window (boot, quiet fleet) never caps anyone."""
        cap = self.cfg.max_share * self._recent.maxlen
        return sum(1 for rid in self._recent if rid == replica_id) >= cap

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def share_counts(self) -> Dict[int, int]:
        """Per-replica counts over the current share window (bench/test
        surface for the cap assertion)."""
        with self._lock:
            out: Dict[int, int] = {}
            for rid in self._recent:
                out[rid] = out.get(rid, 0) + 1
            return out
