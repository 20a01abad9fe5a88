"""Multi-tenant fair share + quotas (docs/SERVING.md "Multi-model &
multi-tenant serving").

Counterpart of ``deepspeed_tpu/serving/tenancy.py`` (pure Python over
``utils/locks.RankedLock``, unchanged: the same books, lock name and rank).

A non-empty ``tenants: {...}`` map on :class:`ServingConfig` builds one
:class:`TenantLedger` per frontend. It is the single accounting point
for three enforcement mechanisms:

- **Deficit-weighted-fair ordering.** Each dispatched request charges
  ``(prompt + max_new_tokens) / weight`` of virtual service to its
  tenant; the admission queue drains the tenant with the LEAST virtual
  service first (then class/priority/FIFO within the tenant), so a
  weight-2 tenant sustains twice a weight-1 tenant's token throughput
  under contention and a batch flood from one tenant cannot starve
  another's interactive traffic. Service counters are re-floored to
  zero after every charge, so an idle tenant returns to parity instead
  of banking unbounded credit.

- **Token-rate quota.** Dispatched tokens also feed a sliding-window
  rate per tenant. A tenant over its ``token_rate`` is *deprioritized*,
  not blocked: it drains only when no in-quota tenant has work
  (work-conserving), and it moves to the FRONT of the brownout/
  preemption victim order — ``(tenant over-quota, shed_rank,
  order_key)``.

- **Per-engine KV block budget.** Before dispatch the router asks the
  ledger whether the request's projected KV need (resume prompt +
  remaining generation, in engine blocks — the same total-block math as
  the reservation ledger, docs/SERVING.md "Admission and preemption")
  fits the tenant's ``kv_block_budget`` on that replica's engine; a
  replica where it does not is simply not a routing candidate. Charges
  are released when the request reaches a terminal state (reconciled on
  the router tick, so no finish-path hook is needed on replicas).

Quota transitions are observable: the ``tenant_throttled`` journal
event fires on each not-throttled -> throttled edge and the
``tenant_over_quota_<tenant>`` gauge tracks the current state.

Lock discipline (docs/CONCURRENCY.md): all mutable state sits under one
``serving.tenancy`` RankedLock, ranked ABOVE the admission queue's
condition (the queue consults the ledger while holding its own lock)
and below the per-replica locks (the ledger never calls into replicas).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

from ..utils.locks import RankedLock


def kv_blocks_for(req, kv_block_size: int) -> int:
    """Projected KV footprint of ``req`` in engine blocks: the resume
    prompt (original prompt + tokens already delivered) plus the
    generation budget still owed — the same whole-sequence projection
    the reservation ledger admits on."""
    total = len(req.resume_prompt()) + req.remaining_new_tokens
    return -(-total // max(1, int(kv_block_size)))


class TenantLedger:
    """Per-tenant fair-share service, token-rate, and KV-budget books.

    Thread-safe; every method may be called from the submit path, the
    router's dispatch thread (including under the admission queue's
    condition — rank 65 > rank 60), or the router tick."""

    _GUARDED_BY = {
        "_service": "_lock",
        "_window": "_lock",
        "_window_sum": "_lock",
        "_throttled": "_lock",
        "_kv_used": "_lock",
        "_kv_charges": "_lock",
    }

    def __init__(self, policies: Dict[str, object], *, metrics=None,
                 journal=None, window_s: float = 10.0,
                 clock=time.monotonic):
        # policy map is read-only after construction (pydantic models)
        self._policies = dict(policies)
        self.metrics = metrics
        self.journal = journal
        self.window_s = float(window_s)
        self._clock = clock
        self._lock = RankedLock("serving.tenancy")
        # weight-normalized virtual service per tenant (DWF order key)
        self._service: Dict[str, float] = {}
        # sliding token-rate window: per-tenant deque of (t, tokens)
        # with a running sum so refresh is O(expired entries)
        self._window: Dict[str, deque] = {}
        self._window_sum: Dict[str, float] = {}
        # current throttle reason per tenant (None = in quota); edges
        # emit tenant_throttled + flip the over-quota gauge
        self._throttled: Dict[str, Optional[str]] = {}
        # KV budget books: blocks resident per (tenant, replica_id) and
        # the per-request charges backing them (released on reconcile)
        self._kv_used: Dict[tuple, int] = {}
        self._kv_charges: Dict[int, tuple] = {}

    # ------------------------------------------------------------- policy
    def known(self, tenant: str) -> bool:
        return tenant in self._policies

    @property
    def tenant_names(self):
        return sorted(self._policies)

    def _weight(self, tenant: str) -> float:
        pol = self._policies.get(tenant)
        return float(getattr(pol, "weight", 1.0)) if pol is not None else 1.0

    def _token_rate(self, tenant: str) -> float:
        pol = self._policies.get(tenant)
        return float(getattr(pol, "token_rate", 0.0)) \
            if pol is not None else 0.0

    def _kv_budget(self, tenant: str) -> int:
        pol = self._policies.get(tenant)
        return int(getattr(pol, "kv_block_budget", 0)) \
            if pol is not None else 0

    # -------------------------------------------------------- fair share
    def charge(self, req, now: Optional[float] = None) -> None:
        """Account one dispatched request: virtual service (tokens over
        weight) + the token-rate window. Called by the router when the
        request leaves the queue for a replica."""
        now = self._clock() if now is None else now
        tokens = len(req.prompt_tokens) + req.max_new_tokens
        tenant = req.tenant
        with self._lock:
            self._service[tenant] = (self._service.get(tenant, 0.0)
                                     + tokens / self._weight(tenant))
            # re-floor so counters stay bounded once EVERY tenant has
            # positive service. The floor ranges over all known tenants
            # (idle/never-charged = 0), NOT just charged ones — floored
            # over charged tenants only, a lone flooding tenant would be
            # re-zeroed to parity on every charge and the fair pop would
            # degrade to FIFO until its victim's first dispatch, which
            # is exactly the starvation DWF exists to prevent
            names = set(self._policies) | set(self._service)
            floor = min(self._service.get(t, 0.0) for t in names)
            if floor > 0.0:
                for k in self._service:
                    self._service[k] -= floor
            dq = self._window.setdefault(tenant, deque())
            dq.append((now, float(tokens)))
            self._window_sum[tenant] = (self._window_sum.get(tenant, 0.0)
                                        + tokens)
            self._refresh_quota_locked(now)

    def drain_key(self, tenant: str, now: Optional[float] = None):
        """The queue's cross-tenant order key: in-quota tenants first,
        then least weight-normalized service. Strictly increasing in
        how much a tenant has recently consumed."""
        now = self._clock() if now is None else now
        with self._lock:
            self._refresh_quota_locked(now)
            over = 1 if self._throttled.get(tenant) == "token_rate" else 0
            return (over, self._service.get(tenant, 0.0))

    def over_quota(self, tenant: str, now: Optional[float] = None) -> bool:
        """True while the tenant's sliding-window dispatch rate exceeds
        its token_rate quota (always False for unlimited tenants)."""
        return self.drain_key(tenant, now)[0] == 1

    def victim_rank(self, req) -> int:
        """Leading component of the brownout/preemption victim order:
        over-quota tenants shed before in-quota ones."""
        return 1 if self.over_quota(req.tenant) else 0

    def _refresh_quota_locked(self, now: float) -> None:
        cutoff = now - self.window_s
        for tenant, dq in self._window.items():
            while dq and dq[0][0] < cutoff:
                _, tok = dq.popleft()
                self._window_sum[tenant] = self._window_sum.get(
                    tenant, 0.0) - tok
            rate_cap = self._token_rate(tenant)
            over = (rate_cap > 0.0
                    and self._window_sum.get(tenant, 0.0)
                    > rate_cap * self.window_s)
            was = self._throttled.get(tenant)
            if over and was != "token_rate":
                self._set_throttled_locked(tenant, "token_rate")
            elif not over and was == "token_rate":
                self._set_throttled_locked(tenant, None)

    def _set_throttled_locked(self, tenant: str, reason: Optional[str]):
        prev = self._throttled.get(tenant)
        self._throttled[tenant] = reason
        if self.metrics is not None:
            self.metrics.gauge(f"tenant_over_quota_{tenant}").set(
                0.0 if reason is None else 1.0)
        if reason is not None and prev is None and self.journal is not None:
            self.journal.emit("tenant_throttled", tenant=tenant,
                              reason=reason)

    # --------------------------------------------------------- KV budget
    def admits_kv(self, req, replica) -> bool:
        """Routing filter: does this tenant's KV budget on ``replica``'s
        engine fit the request's projected block need? Unlimited
        (budget 0) tenants and unknown engines always admit."""
        budget = self._kv_budget(req.tenant)
        if budget <= 0:
            return True
        cfg = getattr(getattr(replica, "engine", None), "config", None)
        if cfg is None:
            return True
        need = kv_blocks_for(req, getattr(cfg, "kv_block_size", 16))
        with self._lock:
            used = self._kv_used.get((req.tenant, replica.replica_id), 0)
            ok = used + need <= budget
            if not ok and self._throttled.get(req.tenant) is None:
                self._set_throttled_locked(req.tenant, "kv_budget")
            return ok

    def charge_kv(self, req, replica) -> None:
        """Record the dispatched request's block charge against its
        tenant's budget on that replica (idempotent per uid; no-op for
        unlimited tenants)."""
        if self._kv_budget(req.tenant) <= 0:
            return
        cfg = getattr(getattr(replica, "engine", None), "config", None)
        if cfg is None:
            return
        need = kv_blocks_for(req, getattr(cfg, "kv_block_size", 16))
        key = (req.tenant, replica.replica_id)
        with self._lock:
            old = self._kv_charges.pop(req.uid, None)
            if old is not None:                 # failover re-dispatch
                okey, oblocks, _ = old
                self._kv_used[okey] = max(
                    0, self._kv_used.get(okey, 0) - oblocks)
            self._kv_charges[req.uid] = (key, need, req)
            self._kv_used[key] = self._kv_used.get(key, 0) + need

    def release_kv(self, uid: int) -> None:
        with self._lock:
            self._release_kv_locked(uid)

    def _release_kv_locked(self, uid: int) -> None:
        entry = self._kv_charges.pop(uid, None)
        if entry is None:
            return
        key, blocks, _ = entry
        self._kv_used[key] = max(0, self._kv_used.get(key, 0) - blocks)
        tenant = key[0]
        if self._throttled.get(tenant) == "kv_budget":
            self._set_throttled_locked(tenant, None)

    def reconcile(self, now: Optional[float] = None) -> None:
        """Router-tick sweep: release KV charges whose request reached a
        terminal state and age the token-rate windows (so quota clears
        even with zero traffic)."""
        now = self._clock() if now is None else now
        with self._lock:
            for uid in [u for u, (_, _, req) in self._kv_charges.items()
                        if req.done]:
                self._release_kv_locked(uid)
            self._refresh_quota_locked(now)

    # ------------------------------------------------------ observability
    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant books for ``health_report()``."""
        with self._lock:
            out = {}
            for tenant in sorted(self._policies):
                kv = {rid: blocks for (t, rid), blocks
                      in sorted(self._kv_used.items())
                      if t == tenant and blocks > 0}
                out[tenant] = {
                    "weight": self._weight(tenant),
                    "token_rate": self._token_rate(tenant),
                    "kv_block_budget": self._kv_budget(tenant),
                    "service": self._service.get(tenant, 0.0),
                    "window_tokens": self._window_sum.get(tenant, 0.0),
                    "throttled": self._throttled.get(tenant),
                    "kv_blocks_used": kv,
                }
            return out
