"""SLO-driven elastic fleet autoscaling: observability → actuation.

Counterpart of ``deepspeed_tpu/serving/autoscaler.py``. Grad mode is per
thread in PyTorch, so the actuation worker runs under ``torch.no_grad()``
like the replica loop: an engine it builds (a grow, or a fresh engine for
a wedged re-role) allocates its KV pool without building a graph.

Every input signal for elasticity already existed — windowed burn rates
and per-class SLO status (telemetry/slo.py), per-role occupancy and
outstanding-token gauges (serving/router.py), a supervisor that can
park/restart slots (serving/supervisor.py) — but nothing *acted* on
them: the fleet was a fixed ``num_replicas`` set at construction. The
:class:`FleetController` closes the loop (docs/SERVING.md "Elastic
autoscaling"). It rides the router's ~1/s tick (the ``tick_hooks``
idiom) and drives three actuators through the frontend:

1. **Grow/shrink** the replica pool between ``min_replicas`` and
   ``max_replicas`` from the stored ``engine_factory``, with
   per-direction cooldowns and consecutive-tick hysteresis so the pool
   never flaps. Shrink prefers PARKED (circuit-broken) slots — removing
   a corpse costs nothing — then the least-loaded replica; a draining
   replica's resident sequences are *evacuated* (KV export + staged
   re-import elsewhere, the preemption spill's representation) instead of
   waited out, so drain is cheap.
2. **Re-role** prefill↔decode as the traffic mix shifts, decided from
   the weighted phase-load imbalance (the disaggregation cost model
   applied to ``outstanding_prefill/decode_tokens``), with its own
   cooldown + stable-tick flap suppression.
3. **Proactive brownout**: on slow-window error-budget burn the
   admission queue's effective capacity is degraded *before* the
   fast+slow alert would fire (``AdmissionQueue.set_proactive_fraction``)
   — shed the least-urgent work early rather than breach the SLO.

Decisions are synchronous and deterministic (``tick(now)`` with an
injectable clock and a pluggable ``fleet`` actuation surface — the
policy tests drive it with a fake clock and a fake fleet); *actuation*
runs on the controller's own worker thread by default, because growing
a replica builds an engine and shrinking one
waits out an evacuation — neither may stall the router's dispatch loop.
One action is in flight at a time: a new decision is not taken while
the previous one executes, which is itself a flap damper.

Every completed action lands exactly once in the ``decision_log`` AND
the ops journal (``scale_up`` / ``scale_down`` / ``replica_reroled`` /
``brownout_proactive``), and moves the ``replicas_target`` gauge — the
dashboard's record of what the controller *wants* vs what
``replicas_healthy`` says it has. The controller also keeps the
``replica_seconds`` ledger (fleet-size integral over time) — the
card-seconds-per-SLO-attained cost metric the bench ``autoscale`` phase
reports against a static fleet (PAPERS.md: arxiv 2605.25645).

Disabled (``autoscaler.enabled: false``, the default) no controller is
built anywhere — the static-fleet stack byte for byte.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from collections import deque
from typing import Optional, Tuple

import torch

from ..utils.locks import RankedLock
from ..utils.logging import logger
from .config import AutoscalerConfig

#: role sets shared with the router (import-cycle-free copies; the
#: router's are the authority — tests assert they agree)
_DECODE_CAPABLE = ("decode", "mixed")


@dataclasses.dataclass(frozen=True)
class ReplicaInfo:
    """One replica's view in a :class:`FleetSignals` snapshot."""

    replica_id: int
    role: str
    accepting: bool
    parked: bool
    outstanding_prefill_tokens: float
    outstanding_decode_tokens: float
    # fabric peer (docs/SERVING.md "Multi-host serving"): remote
    # capacity is owned by its server process — shrinking it only drops
    # the connection, the chips stay allocated — so local replicas are
    # preferred shrink victims at equal load
    remote: bool = False
    # named model pool (docs/SERVING.md "Multi-model & multi-tenant
    # serving"); "default" on homogeneous fleets
    model_id: str = "default"
    # federated export adopted from a peer frontend (docs/SERVING.md
    # "Frontend federation"): borrowed capacity whose lifecycle the
    # exporting frontend owns — never a shrink victim here
    federated: bool = False

    @property
    def outstanding(self) -> float:
        return (self.outstanding_prefill_tokens
                + self.outstanding_decode_tokens)


@dataclasses.dataclass(frozen=True)
class FleetSignals:
    """One consistent reading of every elasticity input, taken by
    ``ServingFrontend.fleet_signals()`` (or a test fake)."""

    queue_depth: float
    replicas: Tuple[ReplicaInfo, ...]
    # max slow-window burn rate over every SLO rule (0 with no alerts
    # engine / no rules / empty windows) — the proactive-brownout input
    burn_slow_max: float = 0.0
    # the disaggregation cost model for re-role imbalance (1.0/1.0 when
    # the fleet is not role-split)
    prefill_token_cost: float = 1.0
    decode_token_cost: float = 1.0
    disaggregated: bool = False
    # per-model pool bounds as (model, min, max) rows — already
    # resolved against the global min/max by the frontend (a ModelSpec
    # leaves either end None to inherit). Empty on homogeneous fleets;
    # growth then targets the caller engine_factory (model=None).
    model_bounds: Tuple[Tuple[str, int, int], ...] = ()
    # trend-projected queue depth (docs/SERVING.md "Fleet KV locality"):
    # queue_depth plus the windowed submit-minus-completion rate times
    # the prediction horizon. None = no prediction (affinity off,
    # predictive off, or the window has no history yet) — the
    # pure-watermark decisions byte for byte.
    predicted_queue_depth: Optional[float] = None


class FleetController:
    """See the module docstring. ``fleet`` is the actuation surface —
    ``ServingFrontend`` in production, a fake in the policy tests::

        fleet_signals() -> FleetSignals
        add_replica(role) -> replica_id
        remove_replica(replica_id, reason=...) -> bool
        set_replica_role(replica_id, role) -> bool
        set_proactive_brownout(fraction | None) -> None
    """

    # lock discipline (docs/CONCURRENCY.md): the decision ledger and the
    # replica-seconds accounting are shared between the router-tick
    # thread and stats()/health_report() readers. The hysteresis streaks
    # and cooldown anchors are deliberately unguarded: tick-thread-
    # confined (one decision round at a time by construction).
    _GUARDED_BY = {
        "decision_log": "_lock",
        "_action_counts": "_lock",
        "_replica_seconds": "_lock",
        "_peak_replicas": "_lock",
        "_last_wall": "_lock",
    }

    def __init__(self, config: AutoscalerConfig, fleet,
                 metrics=None, journal=None, clock=time.monotonic,
                 async_actions: bool = True):
        self.config = config
        self.fleet = fleet
        self.metrics = metrics
        self.journal = journal
        self.clock = clock
        self._lock = RankedLock("serving.autoscaler")
        # completed actions, exactly one entry per journal event — the
        # churn suite cross-checks the two (tests/test_journal.py).
        # Bounded like the journal ring (a long-lived elastic fleet
        # scales forever); the running tallies live in _action_counts
        # so stats() stays O(1) regardless of history length.
        self.decision_log: "deque[dict]" = deque(maxlen=4096)
        self._action_counts = {"scale_ups": 0, "scale_downs": 0,
                               "reroles": 0, "brownouts": 0}
        self._last_tick_t: Optional[float] = None
        self._last_wall: Optional[float] = None
        self._replica_seconds = 0.0
        self._peak_replicas = 0
        # hysteresis streaks + per-direction cooldown anchors
        self._up_streak = 0
        self._down_streak = 0
        # whether the CURRENT tick's up condition held only through the
        # trend projection (docs/SERVING.md "Fleet KV locality") — the
        # deciding tick labels its grow "predicted_pressure"
        self._up_predicted = False
        self._rerole_streak = 0          # signed: +prefill-starved, -decode
        self._last_scale_t: Optional[float] = None
        self._last_rerole_t: Optional[float] = None
        self._brownout_on = False
        # one action in flight at a time; decisions pause while it runs
        self._action_pending = threading.Event()
        self._stopped = threading.Event()
        self._async = bool(async_actions)
        self._actions: "_queue.Queue" = _queue.Queue()
        self.thread: Optional[threading.Thread] = None
        if self._async:
            self.thread = threading.Thread(target=self._worker,
                                           daemon=True,
                                           name="serving-autoscaler")
            self.thread.start()

    # ---------------------------------------------------------------- stats
    def replica_seconds(self) -> float:
        """Fleet-size integral over time (parked corpses excluded) —
        the replica-seconds cost ledger the bench ``autoscale`` phase
        compares against ``static_replicas * wall``."""
        with self._lock:
            return self._replica_seconds

    def stats(self) -> dict:
        with self._lock:
            return dict(self._action_counts,
                        replica_seconds=self._replica_seconds,
                        peak_replicas=self._peak_replicas)

    # ----------------------------------------------------------------- tick
    def maybe_tick(self, now: Optional[float] = None) -> None:
        """Cadence-gated :meth:`tick` for the router's tick_hooks."""
        now = now if now is not None else self.clock()
        if (self._last_tick_t is not None
                and now - self._last_tick_t < self.config.tick_interval_s):
            return
        self.tick(now)

    def tick(self, now: Optional[float] = None) -> None:
        """One decision round: read signals, account replica-seconds,
        update proactive brownout, and (unless an action is already in
        flight) decide at most ONE membership/role action."""
        if self._stopped.is_set():
            return
        now = now if now is not None else self.clock()
        self._last_tick_t = now
        try:
            signals = self.fleet.fleet_signals()
        except Exception as e:  # pragma: no cover - defensive
            logger.error(f"autoscaler signal read failed: {e!r}")
            return
        live = sum(1 for r in signals.replicas if not r.parked)
        with self._lock:
            if self._last_wall is not None:
                self._replica_seconds += live * max(0.0,
                                                    now - self._last_wall)
            self._last_wall = now
            self._peak_replicas = max(self._peak_replicas, live)
        self._update_brownout(signals, now)
        if self._action_pending.is_set():
            return
        action = self._decide(signals, now)
        if action is not None:
            self._action_pending.set()
            if self._async:
                self._actions.put((action, now))
            else:
                try:
                    self._run_action(action, now)
                finally:
                    self._action_pending.clear()

    # ------------------------------------------------------------- decisions
    def _weighted_loads(self, signals: FleetSignals) -> Tuple[float, float]:
        pre = sum(r.outstanding_prefill_tokens for r in signals.replicas
                  if not r.parked) * signals.prefill_token_cost
        dec = sum(r.outstanding_decode_tokens for r in signals.replicas
                  if not r.parked) * signals.decode_token_cost
        return pre, dec

    def _decide(self, signals: FleetSignals, now: float) -> Optional[tuple]:
        cfg = self.config
        n_total = len(signals.replicas)
        accepting = [r for r in signals.replicas if r.accepting]
        n_acc = max(1, len(accepting))
        q_per = signals.queue_depth / n_acc
        tokens_per = sum(r.outstanding for r in accepting) / n_acc
        up_cond = q_per > cfg.scale_up_queue_per_replica
        # predictive scaling (docs/SERVING.md "Fleet KV locality"): the
        # trend-projected queue depth may only ADD a grow trigger —
        # capacity arrives before the watermark trips — while shrink
        # stays on the actual signals (shedding real capacity on a
        # forecast would be flap fuel). None = watermark byte for byte.
        q_pred = signals.predicted_queue_depth
        self._up_predicted = (not up_cond and q_pred is not None
                              and q_pred / n_acc
                              > cfg.scale_up_queue_per_replica)
        up_cond = up_cond or self._up_predicted
        down_cond = (not up_cond
                     and q_per <= cfg.scale_down_queue_per_replica
                     and tokens_per <= cfg.scale_down_tokens_per_replica)
        self._up_streak = self._up_streak + 1 if up_cond else 0
        self._down_streak = self._down_streak + 1 if down_cond else 0

        # bound repair outranks the watermark policy: a fleet outside
        # [min, max] (mis-sized at boot, or bounds tightened) moves back
        # inside at one step per cooldown regardless of load
        if n_total < cfg.min_replicas \
                and self._cooled(now, cfg.scale_up_cooldown_s):
            return ("scale_up", self._grow_role(signals), "below_min",
                    self._grow_model(signals))
        if n_total > cfg.max_replicas \
                and self._cooled(now, cfg.scale_down_cooldown_s):
            victim = self._shrink_victim(signals)
            if victim is not None:
                return ("scale_down", victim, "above_max")

        # per-model pool repair (docs/SERVING.md "Multi-model &
        # multi-tenant serving"): each named pool obeys its own
        # resolved [min, max], one step per cooldown, same priority
        # order as the global bounds — below-min first (capacity debt
        # beats capacity excess)
        counts = self._pool_counts(signals)
        for model, mn, mx in signals.model_bounds:
            live = counts.get(model, 0)
            if live < mn and self._cooled(now, cfg.scale_up_cooldown_s):
                return ("scale_up", self._grow_role(signals),
                        "pool_below_min", model)
            if live > mx and self._cooled(now, cfg.scale_down_cooldown_s):
                victim = self._shrink_victim(signals, pool=model)
                if victim is not None:
                    return ("scale_down", victim, "pool_above_max")

        if self._up_streak >= cfg.up_stable_ticks \
                and self._cooled(now, cfg.scale_up_cooldown_s):
            if n_total < cfg.max_replicas:
                return ("scale_up", self._grow_role(signals),
                        ("predicted_pressure" if self._up_predicted
                         else "queue_pressure"),
                        self._grow_model(signals))
            # at max with a parked corpse aboard: evict the corpse so
            # the NEXT round can grow live capacity — otherwise a
            # sustained burst (down_cond never holds under load) would
            # pin the fleet below max forever with a zero-cost seat
            # occupied
            parked = [r for r in signals.replicas
                      if r.parked and not r.federated]
            if parked:
                victim = min(parked,
                             key=lambda r: r.replica_id).replica_id
                return ("scale_down", victim, "evict_parked")
        if (self._down_streak >= cfg.down_stable_ticks
                and n_total > cfg.min_replicas
                and self._cooled(now, cfg.scale_down_cooldown_s)):
            victim = self._shrink_victim(signals)
            if victim is not None:
                return ("scale_down", victim, "idle")
        return self._decide_rerole(signals, now)

    def _cooled(self, now: float, cooldown_s: float) -> bool:
        return (self._last_scale_t is None
                or now - self._last_scale_t >= cooldown_s)

    def _grow_role(self, signals: FleetSignals) -> str:
        """Role for a new replica: the phase whose weighted load
        dominates, on role-split fleets; "mixed" otherwise (and as the
        safe fallback when the frontend rejects a specialized role)."""
        if not signals.disaggregated:
            return "mixed"
        pre, dec = self._weighted_loads(signals)
        return "prefill" if pre > dec else "decode"

    @staticmethod
    def _pool_counts(signals: FleetSignals) -> dict:
        """Live (non-parked) replica count per model pool."""
        counts: dict = {}
        for r in signals.replicas:
            if not r.parked:
                counts[r.model_id] = counts.get(r.model_id, 0) + 1
        return counts

    def _grow_model(self, signals: FleetSignals) -> Optional[str]:
        """Model pool a queue-pressure grow should target: the pool
        with the highest outstanding tokens per accepting replica among
        pools below their max. ``None`` on homogeneous fleets — the
        frontend then grows from the caller ``engine_factory``."""
        if not signals.model_bounds:
            return None
        counts = self._pool_counts(signals)
        best, best_load = None, -1.0
        for model, _mn, mx in signals.model_bounds:
            live = counts.get(model, 0)
            if live >= mx:
                continue
            acc = [r for r in signals.replicas
                   if r.accepting and r.model_id == model]
            load = (sum(r.outstanding for r in acc) / len(acc)
                    if acc else float("inf"))   # empty pool: grow first
            if load > best_load:
                best, best_load = model, load
        return best

    def _shrink_victim(self, signals: FleetSignals,
                       pool: Optional[str] = None) -> Optional[int]:
        """Replica id to remove: PARKED slots first (a circuit-broken
        corpse frees a seat at zero capacity cost), then the
        least-loaded accepting replica whose removal keeps at least one
        accepting decode-capable replica (role-split fleets) and never
        drains a model pool below its resolved min (or to zero) —
        ``pool`` restricts the search to one model's replicas."""
        pool_min = {m: mn for m, mn, _mx in signals.model_bounds}
        counts = self._pool_counts(signals)
        parked = [r for r in signals.replicas if r.parked
                  and not r.federated
                  and (pool is None or r.model_id == pool)]
        if parked:
            return min(parked, key=lambda r: r.replica_id).replica_id
        accepting = [r for r in signals.replicas if r.accepting]
        if len(accepting) <= 1:
            return None         # never remove the last accepting replica
        candidates = []
        for r in accepting:
            if r.federated:
                continue        # the exporting frontend owns its lifecycle
            if pool is not None and r.model_id != pool:
                continue
            floor = pool_min.get(r.model_id)
            if floor is not None and pool is None \
                    and counts.get(r.model_id, 0) <= max(1, floor):
                continue        # pool at its min (or last member) stays
            if signals.disaggregated and r.role in _DECODE_CAPABLE:
                others_decode = sum(1 for o in accepting
                                    if o is not r
                                    and o.role in _DECODE_CAPABLE)
                if others_decode == 0:
                    continue    # the last decode-capable replica stays
            candidates.append(r)
        if not candidates:
            return None
        # least loaded first, preferring LOCAL capacity at equal load
        # (removing a fabric peer only drops the connection — its
        # server process keeps the chips); ties broken toward the
        # NEWEST replica (highest id) — the most recently added
        # capacity goes first, which keeps long-lived replicas' warm
        # caches around
        best = min(candidates,
                   key=lambda r: (r.outstanding, r.remote, -r.replica_id))
        return best.replica_id

    def _decide_rerole(self, signals: FleetSignals,
                       now: float) -> Optional[tuple]:
        cfg = self.config
        if not signals.disaggregated or cfg.rerole_ratio <= 0:
            self._rerole_streak = 0
            return None
        pre, dec = self._weighted_loads(signals)
        eps = 1e-9
        if pre > cfg.rerole_ratio * (dec + eps) and pre > 0:
            want = 1                          # prefill-starved
        elif dec > cfg.rerole_ratio * (pre + eps) and dec > 0:
            want = -1                         # decode-starved
        else:
            want = 0
        if want == 0 or (self._rerole_streak != 0
                         and (want > 0) != (self._rerole_streak > 0)):
            # imbalance vanished or FLIPPED direction: restart the
            # streak — an oscillating mix must never flap a replica
            # back and forth
            self._rerole_streak = want
            return None
        self._rerole_streak += want
        if abs(self._rerole_streak) < cfg.rerole_stable_ticks:
            return None
        if (self._last_rerole_t is not None
                and now - self._last_rerole_t < cfg.rerole_cooldown_s):
            return None
        accepting = [r for r in signals.replicas if r.accepting]
        if want > 0:
            # decode → prefill: keep at least one decode-capable
            donors = [r for r in accepting if r.role == "decode"
                      and sum(1 for o in accepting if o is not r
                              and o.role in _DECODE_CAPABLE) >= 1]
            to_role = "prefill"
        else:
            donors = [r for r in accepting if r.role == "prefill"]
            to_role = "decode"
        if not donors:
            return None
        victim = min(donors, key=lambda r: (r.outstanding, -r.replica_id))
        return ("rerole", victim.replica_id, victim.role, to_role)

    # ------------------------------------------------------------- brownout
    def _update_brownout(self, signals: FleetSignals, now: float) -> None:
        """Proactive brownout actuator (inline — it is a cheap queue
        flag, not an engine build): activate when the worst slow-window
        burn reaches ``brownout_burn_threshold``; deactivate with 2x
        hysteresis once it halves (a recovering fleet must not flap the
        queue bound)."""
        thr = self.config.brownout_burn_threshold
        if thr <= 0:
            return
        burn = signals.burn_slow_max
        if not self._brownout_on and burn >= thr:
            self._brownout_on = True
            try:
                self.fleet.set_proactive_brownout(
                    self.config.brownout_fraction)
            except Exception as e:  # pragma: no cover - defensive
                logger.error(f"autoscaler brownout actuation failed: {e!r}")
                self._brownout_on = False
                return
            self._record("brownout_proactive", now, active=True,
                         fraction=self.config.brownout_fraction,
                         burn_slow=round(burn, 3))
            if self.metrics is not None:
                self.metrics.gauge("brownout_proactive_active").set(1.0)
            logger.warning(
                f"autoscaler: PROACTIVE brownout on (slow burn "
                f"{burn:.2f} >= {thr}); queue capacity fraction -> "
                f"{self.config.brownout_fraction}")
        elif self._brownout_on and burn < thr * 0.5:
            self._brownout_on = False
            try:
                self.fleet.set_proactive_brownout(None)
            except Exception as e:  # pragma: no cover - defensive
                logger.error(f"autoscaler brownout actuation failed: {e!r}")
                self._brownout_on = True
                return
            self._record("brownout_proactive", now, active=False,
                         fraction=1.0, burn_slow=round(burn, 3))
            if self.metrics is not None:
                self.metrics.gauge("brownout_proactive_active").set(0.0)
            logger.warning("autoscaler: proactive brownout off "
                           f"(slow burn {burn:.2f})")

    # ------------------------------------------------------------- actuation
    @torch.no_grad()          # grad mode is per thread: this one starts on
    def _worker(self) -> None:
        while True:
            item = self._actions.get()
            if item is None:
                return
            action, t_decided = item
            try:
                self._run_action(action, t_decided)
            except Exception as e:  # pragma: no cover - defensive
                logger.error(f"autoscaler action {action[0]} failed: {e!r}")
            finally:
                self._action_pending.clear()

    _COUNT_KEYS = {"scale_up": "scale_ups", "scale_down": "scale_downs",
                   "replica_reroled": "reroles"}

    def _record(self, action: str, now: float, **detail) -> None:
        """Exactly-once bookkeeping for one COMPLETED action: decision
        log entry + running tally + journal event + (for scale actions)
        gauges. The records are written together so they can never
        disagree."""
        with self._lock:
            self.decision_log.append({"action": action, "t": now, **detail})
            key = self._COUNT_KEYS.get(action)
            if key is not None:
                self._action_counts[key] += 1
            elif action == "brownout_proactive" and detail.get("active"):
                self._action_counts["brownouts"] += 1
        if self.journal is not None:
            try:
                self.journal.emit(action, **detail)
            except Exception as e:  # pragma: no cover - defensive
                logger.error(f"autoscaler journal emit failed: {e!r}")

    def _run_action(self, action: tuple, t_decided: float) -> None:
        kind = action[0]
        now = self.clock()
        if kind == "scale_up":
            _, role, reason, model = (action if len(action) == 4
                                      else action + (None,))

            def _add(r):
                # model=None keeps the legacy add_replica(role) call so
                # fake fleets in the policy tests stay signature-exact
                return (self.fleet.add_replica(r, model_id=model)
                        if model is not None else self.fleet.add_replica(r))
            try:
                rid = _add(role)
            except Exception as e:
                if role != "mixed":
                    # specialized growth rejected (e.g. handoff off):
                    # a mixed replica is always legal capacity
                    logger.warning(f"autoscaler: add_replica({role!r}) "
                                   f"failed ({e!r}); retrying as mixed")
                    role = "mixed"
                    rid = _add(role)
                else:
                    raise
            self._last_scale_t = now
            self._up_streak = self._down_streak = 0
            n = self._fleet_size()
            detail = dict(replica=rid, fleet_size=n,
                          reason=reason, role=role)
            if model is not None:
                detail["model"] = model
            self._record("scale_up", now, **detail)
            self._set_target(n)
            logger.warning(f"autoscaler: scale UP -> {n} replicas "
                           f"(replica {rid}, role {role}, {reason})")
        elif kind == "scale_down":
            _, rid, reason = action
            try:
                ok = self.fleet.remove_replica(rid, reason=reason)
            except Exception as e:
                logger.warning(f"autoscaler: remove_replica({rid}) "
                               f"refused ({e!r})")
                return
            if not ok:
                return
            self._last_scale_t = now
            self._up_streak = self._down_streak = 0
            n = self._fleet_size()
            self._record("scale_down", now, replica=rid, fleet_size=n,
                         reason=reason)
            self._set_target(n)
            logger.warning(f"autoscaler: scale DOWN -> {n} replicas "
                           f"(removed replica {rid}, {reason})")
        elif kind == "rerole":
            _, rid, from_role, to_role = action
            try:
                ok = self.fleet.set_replica_role(rid, to_role)
            except Exception as e:
                logger.warning(f"autoscaler: re-role of replica {rid} "
                               f"{from_role}->{to_role} refused ({e!r})")
                self._rerole_streak = 0
                return
            if not ok:
                return
            self._last_rerole_t = now
            self._rerole_streak = 0
            self._record("replica_reroled", now, replica=rid,
                         from_role=from_role, to_role=to_role)
            logger.warning(f"autoscaler: re-roled replica {rid} "
                           f"{from_role} -> {to_role}")

    def _fleet_size(self) -> int:
        try:
            return len(self.fleet.fleet_signals().replicas)
        except Exception:  # pragma: no cover - defensive
            return 0

    def _set_target(self, n: int) -> None:
        if self.metrics is not None:
            self.metrics.gauge("replicas_target").set(n)

    # ------------------------------------------------------------- lifecycle
    def stop(self, timeout: float = 5.0) -> None:
        """Stop deciding and drain the action worker. Called by
        ``ServingFrontend.shutdown`` BEFORE the router stops, so no
        membership change can race the teardown."""
        self._stopped.set()
        if self.thread is not None and self.thread.is_alive():
            self._actions.put(None)
            self.thread.join(timeout)
