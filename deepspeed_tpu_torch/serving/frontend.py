"""ServingFrontend — the production request surface over InferenceEngineV2.

Counterpart of ``deepspeed_tpu/serving/frontend.py``: the in-process
serving stack::

    submit()/stream()/cancel()
        └─ AdmissionQueue   (bounded; sheds with Rejected("overloaded"))
             └─ ReplicaRouter (least-outstanding-tokens, health/drain)
                  └─ Replica × N (thread-per-replica Dynamic SplitFuse
                       loops over InferenceEngineV2; streaming delivery,
                       cancel → immediate KV free)

with the supervisor (restart, failover, brownout, circuit breaker), the
test-only fault injector, dynamic membership with evacuation, and the
telemetry surface: one :class:`MetricsRegistry` (TTFT/TPOT/queue
histograms, shed/cancel/complete counters) that fans out through any
``monitor/``-style backend via :meth:`publish_metrics`, the ops journal,
windowed metrics, SLO burn-rate alerts, the flight recorder and the health
report.

Replicas may share one card: each runs its own thread, KV pools and
scheduler over its own engine (engines may share weight tensors). What the
port does not run yet raises ``NotImplementedError`` naming its ROADMAP
item when its config block is enabled: multi-tenancy, prefix affinity, the
autoscaler and disaggregated prefill/decode (item 10b), the cross-process
fabric, federation and network chaos (item 11).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import not_ported, resolve_device
from ..telemetry import FlightRecorder  # noqa: F401  (re-export surface)
from ..telemetry.fleet import FleetJournal
from ..telemetry.journal import OpsJournal
from ..telemetry.slo import AlertEngine
from ..telemetry.windowed import WindowedMetrics
from ..utils.locks import RankedLock
from .config import ServingConfig
from .metrics import MetricsRegistry, serving_metrics
from .queue import AdmissionQueue
from .replica import Replica
from .request import (FinishReason, Rejected, RequestHandle,
                      RequestState, ServingRequest)
from .router import ReplicaRouter

_ITEM_10B = "queue 1 item 10b"
_ITEM_11 = "queue 1 item 11"


def refuse_unported(config: ServingConfig) -> None:
    """Raise for the first enabled block whose feature the port does not
    run yet. Every block parses (one config file drives both packages);
    enabling one of these is refused here, never ignored."""
    checks = [
        (bool(config.tenants), "the tenants block (multi-tenant fair share "
         "and quotas, serving/tenancy.py)", _ITEM_10B),
        (config.affinity.enabled, "the affinity block (prefix-affinity "
         "routing and warm-up, serving/affinity.py)", _ITEM_10B),
        (config.autoscaler.enabled, "the autoscaler block "
         "(serving/autoscaler.py)", _ITEM_10B),
        (config.disaggregation.enabled, "the disaggregation block "
         "(prefill/decode roles and KV handoff)", _ITEM_10B),
        (config.fabric.enabled or config.fabric.federation.enabled,
         "the fabric block (cross-process replicas and federation, "
         "serving/fabric/)", _ITEM_11),
        (any(spec.peers for spec in config.models.values()),
         "models.<name>.peers (replicas behind the serving fabric)",
         _ITEM_11),
        (config.chaos.enabled, "the chaos block (network fault injection, "
         "serving/fabric/chaos.py)", _ITEM_11),
    ]
    for on, what, item in checks:
        if on:
            raise not_ported(what, item)


def apply_engine_serving_config(engine, config: ServingConfig) -> None:
    """Stamp the engine-level serving blocks (weight_quant → kv_quant →
    prefix_cache → kv_tier → admission, in dependency order) onto a built
    engine — the one configuration path of every replica build site
    (boot, supervisor restart, ``add_replica``). Each enabled block calls
    its ``configure_*`` method directly, so a missing or failing one
    raises at build instead of serving without the feature."""
    if config.weight_quant.enabled:
        # FIRST and BEFORE any traffic: quantizing is lossy and only legal
        # with no tracked sequences (true on every build path)
        wq = config.weight_quant
        engine.configure_weight_quant(True, dtype=wq.dtype, block=wq.block,
                                      skip=list(wq.skip))
    if config.kv_quant.enabled:
        # re-allocates the pools — only legal with no tracked sequences
        engine.configure_kv_quant(True, config.kv_quant.dtype,
                                  config.kv_quant.scale_granularity)
    if config.prefix_cache.enabled:
        # safe on a built engine: matching simply starts now
        engine.configure_prefix_cache(
            True, config.prefix_cache.max_cached_blocks or None)
    if config.kv_tier.enabled:
        # AFTER the prefix cache (the tier requires it)
        kt = config.kv_tier
        engine.configure_kv_tier(True, host_bytes=kt.host_max_bytes,
                                 disk_path=kt.disk_path,
                                 disk_bytes=kt.disk_max_bytes)
    if config.admission.active:
        # stamped BEFORE the replica builds its scheduler (schedulers read
        # the engine config at construction)
        adm = config.admission
        engine.configure_admission(
            adm.reservation,
            oversubscription_factor=adm.oversubscription_factor,
            preemption_enabled=adm.preemption.enabled,
            victim_policy=adm.preemption.victim_policy,
            max_preemptions_per_seq=adm.preemption.max_preemptions_per_seq)


def engine_from_model_spec(spec, device=None):
    """Build one InferenceEngineV2 from a
    :class:`~deepspeed_tpu_torch.serving.config.ModelSpec` (``{model,
    engine, seed, checkpoint}``) on ``device`` (``cuda`` unless ``"cpu"``
    is passed). A spec with a checkpoint loads the universal checkpoint
    (``runtime/checkpointing.py``), so a JAX-written checkpoint serves the
    same weights in both packages. A spec without one draws weights from
    ``torch.Generator(device).manual_seed(seed)``: one seed gives one set
    of weights across the port's replicas and restarts, but not the JAX
    package's weights (torch cannot reproduce ``jax.random``)."""
    from ..inference.v2.engine_v2 import (InferenceEngineV2,
                                          RaggedInferenceEngineConfig)
    from ..models.transformer import CausalLM, TransformerConfig

    dev = resolve_device(device)
    model = CausalLM(TransformerConfig(**dict(spec.model)))
    if spec.checkpoint:
        from ..runtime.checkpointing import load_params_for_model

        params = load_params_for_model(model, spec.checkpoint, device=dev)
    else:
        params = model.init(
            torch.Generator(device=dev).manual_seed(int(spec.seed)),
            device=dev)
    return InferenceEngineV2(
        model, params=params,
        config=RaggedInferenceEngineConfig(**dict(spec.engine)), device=dev)


class ServingFrontend:
    # lock discipline (docs/CONCURRENCY.md): membership admin state is
    # written under the fleet lock. ``_closed`` and ``_replica_models``
    # are writes-only guarded — their readers (submit's fast-path check,
    # the supervisor's restart-time model lookup) take lock-free
    # last-write-wins snapshots by design.
    _GUARDED_BY = {
        "_closed": "_fleet_lock:writes",
        "_next_replica_id": "_fleet_lock",
        "_replica_models": "_fleet_lock:writes",
    }

    def __init__(self, engines: Sequence, config: Optional[ServingConfig] = None,
                 sample_fn: Optional[Callable] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 engine_factory: Optional[Callable[[int], object]] = None,
                 model_engine_factories: Optional[Dict[str, Callable]] = None,
                 device=None):
        """``engines``: one InferenceEngineV2 per replica (the caller owns
        model/param placement; replicas never share an engine — each owns
        its KV pool and scheduler, though engines may share weight
        tensors). ``engine_factory(replica_id)``, when given, is how the
        supervisor builds FRESH engines for restarted replicas
        (docs/SERVING.md "Fault tolerance"); without it a restart reuses
        the dead replica's engine when that is safe. ``device`` is where
        the engines of a ``models:`` registry are built (``cuda`` unless
        ``"cpu"`` is passed); caller-built engines keep their own."""
        self.config = config or ServingConfig()
        refuse_unported(self.config)
        self._device = device
        # multi-model registry (docs/SERVING.md "Multi-model & multi-tenant
        # serving"): named ModelSpecs add replica pools — local engines
        # built from each spec (or a caller-supplied
        # ``model_engine_factories[name]``, which wins). Empty = the
        # single-pool stack, every replica model_id "default".
        self._models = dict(self.config.models)
        self._default_model = self.config.resolve_default_model()
        if not engines and not self._models:
            raise ValueError("ServingFrontend needs at least one engine "
                             "(or a models: registry)")
        # the registry pre-declares every per-class series for the
        # CONFIGURED classes, so custom classes expose zero-valued
        # Prometheus series before first traffic too
        self.metrics = metrics or serving_metrics(
            sorted(self.config.classes), tenants=sorted(self.config.tenants))
        # telemetry (docs/OBSERVABILITY.md): one tracer for the whole
        # frontend — request stage spans begin here at submit, the
        # router/replicas/scheduler continue the chain — plus a flight
        # recorder over it. Both are no-ops when ``telemetry.enabled`` is
        # false; debug_dump() still works (metrics only, no spans).
        self.tracer = self.config.telemetry.build_tracer()
        self.recorder = self.config.telemetry.build_recorder(
            self.tracer, metrics=self.metrics)
        # SLO observability (docs/OBSERVABILITY.md "SLOs and burn-rate
        # alerts"). The journal and the windowed-metrics ring are always
        # on: both are passive bounded buffers that never touch the
        # request hot path — the windowed ring is fed by the router's
        # ~1/s tick. The AlertEngine exists only under ``slo.enabled``.
        slo = self.config.slo
        self.journal = OpsJournal(capacity=slo.journal_capacity,
                                  source="serving",
                                  path=slo.journal_path)
        # per-source rings for remote journal batches; holds nothing on an
        # in-process fleet, but the health report reads it either way
        self.fleet = FleetJournal(self.journal)
        self.windowed = WindowedMetrics(self.metrics,
                                        bucket_s=slo.window_bucket_s,
                                        history_s=slo.window_history_s)
        # KV-tier pressure journaling state: per-replica-slot counter
        # baselines as of the last EMITTED event + the ~1/s cadence gate —
        # must exist before the router tick can fire
        self._tier_journal_t = 0.0
        self._tier_last: dict = {}
        self.alerts = None
        if slo.enabled:
            self.alerts = AlertEngine(slo, self.windowed,
                                      metrics=self.metrics,
                                      journal=self.journal,
                                      recorder=self.recorder)
        if self.config.ttft_buckets_s:
            self.metrics.histogram("ttft_s", self.config.ttft_buckets_s,
                                   reset=True)
        ft = self.config.fault_tolerance
        self.admission = AdmissionQueue(
            self.config.max_queue_depth, self.metrics,
            brownout_threshold=(ft.brownout_threshold if ft.enabled
                                else 0.0),
            journal=self.journal)
        # dynamic membership: replica ids are allocated monotonically and
        # never reused; the fleet lock serializes membership mutations
        self._engine_factory = engine_factory
        # rid -> model_id for every slot outside the unnamed-default pool
        # (absent = "default"); with a models: registry the caller's plain
        # engines serve the default model's pool. Ids: caller engines,
        # then each named pool in sorted-name order.
        self._replica_models: Dict[int, str] = {}
        if self._models:
            for rid in range(len(engines)):
                self._replica_models[rid] = self._default_model
        next_rid = len(engines)
        self._model_factories: Dict[str, Callable] = {}
        model_locals = []                       # (rid, model name)
        for name in sorted(self._models):
            spec = self._models[name]
            fac = (model_engine_factories or {}).get(name)
            if fac is None:
                if not spec.model:
                    raise ValueError(
                        f"models.{name} has no model kwargs and no "
                        f"model_engine_factories[{name!r}] entry — "
                        f"nothing to build its pool from")

                def fac(spec=spec):
                    return engine_from_model_spec(spec, device=self._device)
            self._model_factories[name] = fac
            for _ in range(spec.replicas):
                model_locals.append((next_rid, name))
                self._replica_models[next_rid] = name
                next_rid += 1
        self._next_replica_id = next_rid
        self._fleet_lock = RankedLock("serving.frontend.fleet")
        # evacuated KV rides a bounded host-RAM staging budget (built
        # lazily) — a removal of a fully-loaded replica must not balloon
        # host RAM; over-budget payloads drop to re-prefill
        self._evac_stager = None
        # speculative decoding is applied per replica: each Replica builds
        # its own proposer from the block (draft state is per-engine)
        self._sample_fn = sample_fn
        self._spec = (self.config.speculative
                      if self.config.speculative.enabled else None)
        self._replica_recorder = (self.recorder
                                  if self.config.telemetry.dump_on_error
                                  else None)
        # deterministic fault injection (test-only; serving/faults.py) —
        # None when the ``faults:`` block is off: no hooks, no proxies
        self.injector = self.config.faults.build_injector()
        replicas = [self._build_replica(i, eng)
                    for i, eng in enumerate(engines)]
        replicas += [self._build_replica(rid, self._model_factories[name]())
                     for rid, name in model_locals]
        # ~1/s observability tick on the router loop: windowed-metrics
        # snapshots always; SLO alert evaluation when enabled
        self.router = ReplicaRouter(replicas, self.admission, self.metrics,
                                    tracer=self.tracer,
                                    recorder=self.recorder,
                                    tick_hooks=[self._observability_tick])
        self.supervisor = None
        if ft.enabled:
            from .supervisor import ReplicaSupervisor

            # named-model slots restart from their pool's factory, the
            # rest from the caller's (None: the supervisor's salvage path)
            self.supervisor = ReplicaSupervisor(
                self.router, self._build_replica,
                (self._engine_source if self._model_factories
                 else engine_factory),
                config=ft, metrics=self.metrics, tracer=self.tracer,
                recorder=self.recorder, journal=self.journal)
            self.router.supervisor = self.supervisor
        self.metrics.gauge("replicas_target").set(len(replicas))
        self._closed = False
        self.router.start()
        if self.supervisor is not None:
            self.supervisor.start()
        # fleet ops surface (docs/OBSERVABILITY.md "Fleet observability"):
        # the scrape endpoint binds LAST — its routes read the live
        # frontend, so nothing may be reachable before the router runs.
        self._obs_endpoint = None
        obs = self.config.observability
        if obs.enabled:
            from ..telemetry.fleet import ObsEndpoint

            self._obs_endpoint = ObsEndpoint(self, listen=obs.listen)
            self.journal.emit("obs_listen",
                              address=self._obs_endpoint.address)

    def _engine_source(self, replica_id: int):
        """Supervisor-facing engine factory when model pools exist:
        named-model slots resolve to that model's factory (a restarted
        pool member must host ITS model), default slots to the caller's
        factory — or ``None`` when there is none, which tells the
        supervisor to take its salvage-engine path."""
        fac = self._model_factories.get(
            self._replica_models.get(replica_id, "default"))
        if fac is not None:
            return fac()
        if self._engine_factory is None:
            return None
        return self._engine_factory(replica_id)

    def _build_replica(self, replica_id: int, engine) -> Replica:
        """One replica over ``engine`` with this frontend's full wiring —
        the constructor path AND the supervisor's restart path, so a
        restarted replica is indistinguishable from a first-boot one
        (engine blocks applied, proposer built, telemetry attached)."""
        apply_engine_serving_config(engine, self.config)
        ft = self.config.fault_tolerance
        return Replica(replica_id, engine, self.metrics, self._sample_fn,
                       wedge_timeout_s=self.config.wedge_timeout_s,
                       speculative=self._spec, tracer=self.tracer,
                       recorder=self._replica_recorder,
                       faults=self.injector,
                       on_failover=self._failover if ft.enabled else None,
                       model_id=self._replica_models.get(replica_id,
                                                         "default"),
                       journal=self.journal)

    @property
    def federation_address(self) -> Optional[str]:
        """The federation listener (the serving fabric, not ported)."""
        raise not_ported("frontend federation (serving/fabric/)", _ITEM_11)

    @classmethod
    def from_engine_factory(cls, engine_factory: Callable[[int], object],
                            config: Optional[ServingConfig] = None,
                            **kwargs) -> "ServingFrontend":
        """Build the replica fleet from the config:
        ``engine_factory(replica_id)`` is called ``config.num_replicas``
        times (the config-driven path for the ``serving: {...}`` block)."""
        config = config or ServingConfig()
        refuse_unported(config)
        engines = [engine_factory(i)
                   for i in range(max(1, config.num_replicas))]
        # the factory doubles as the supervisor's fresh-engine source for
        # restarted replicas (unless the caller passed its own)
        kwargs.setdefault("engine_factory", engine_factory)
        return cls(engines, config, **kwargs)

    # ---------------------------------------------------------------- submit
    def submit(self, prompt_tokens: List[int],
               max_new_tokens: Optional[int] = None,
               priority: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               eos_token_id: Optional[int] = None,
               request_class: Optional[str] = None,
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> RequestHandle:
        """Admit a request. Raises :class:`Rejected` when shed (full queue,
        draining frontend, or a prompt no replica could ever schedule).
        ``priority``/``deadline_ms``/``max_new_tokens`` default from the
        config (``default_priority`` etc.). ``request_class`` selects an
        entry of ``config.classes`` (default ``config.default_class``):
        its policy fills priority/deadline when the caller passes
        neither, labels the per-class TTFT/TPOT/queue metrics, and
        orders brownout shedding. ``model`` selects an entry of
        ``config.models`` (default ``config.resolve_default_model()``) —
        the request only routes to replicas of that pool. ``tenant`` is
        accepted so call sites are portable, and normalized to
        ``"default"`` (multi-tenancy is not ported)."""
        cfg = self.config
        cls = request_class if request_class is not None else cfg.default_class
        policy = cfg.classes.get(cls)
        if policy is None:
            # caller bug, not traffic: reject BEFORE requests_submitted
            # so the submitted/admitted/shed balance stays honest
            raise ValueError(f"unknown request class {cls!r} "
                             f"(configured: {sorted(cfg.classes)})")
        # an unknown model is a caller bug too, refused before any
        # counter moves for the same reason
        model_id = model if model is not None else self._default_model
        known_models = set(self._models) if self._models else {"default"}
        if model_id not in known_models:
            raise ValueError(f"unknown model {model_id!r} "
                             f"(configured: {sorted(known_models)})")
        self.metrics.counter("requests_submitted").inc()
        # per-class submit counter: the denominator of the SLO engine's
        # windowed availability burn rate
        self.metrics.counter(f"requests_submitted_class_{cls}").inc()
        if self._closed:
            self.metrics.counter("requests_shed").inc()
            self.metrics.counter(f"requests_shed_class_{cls}").inc()
            raise Rejected("draining", "frontend is shut down")
        if priority is None:
            priority = (policy.priority if policy.priority is not None
                        else cfg.default_priority)
        if deadline_ms is None:
            deadline_ms = (policy.deadline_ms
                           if policy.deadline_ms is not None
                           else cfg.default_deadline_ms)
        req = ServingRequest(
            prompt_tokens,
            max_new_tokens if max_new_tokens is not None
            else cfg.default_max_new_tokens,
            priority, deadline_ms / 1e3 if deadline_ms is not None else None,
            eos_token_id,
            request_class=cls, shed_rank=policy.shed_rank,
            tenant="default", model_id=model_id)
        if self.tracer.enabled:
            # root of this request's trace + the first stage (queue wait).
            # Rejection paths below close both via req.finish.
            req.trace_id = f"req-{req.uid}"
            req.spans = {"request": self.tracer.begin(
                "request", trace_id=req.trace_id,
                attrs={"uid": req.uid,
                       "prompt_tokens": len(req.prompt_tokens),
                       "max_new_tokens": req.max_new_tokens,
                       "priority": req.priority,
                       "class": req.request_class})}
            req.begin_span(self.tracer, "queue")
        # length bound over the request's OWN pool: pools may have
        # different max_seq_len
        pool_lens = [r.engine.model.cfg.max_seq_len
                     for r in self.router.replicas
                     if getattr(r, "model_id", "default") == req.model_id]
        max_len = min(pool_lens) if pool_lens else 0
        if len(req.prompt_tokens) + req.max_new_tokens > max_len:
            self.metrics.counter("requests_shed").inc()
            self.metrics.counter(f"requests_shed_class_{cls}").inc()
            req.finish(RequestState.REJECTED, "too_long")
            raise Rejected("too_long",
                           f"{len(req.prompt_tokens)}+{req.max_new_tokens} "
                           f"tokens > max_seq_len {max_len}")
        self.admission.offer(req, block=cfg.shed_policy == "block")
        return RequestHandle(req, self)

    # ----------------------------------------------------------- failover
    def _failover(self, req: ServingRequest) -> bool:
        """Replica-death hand-back (docs/SERVING.md "Fault tolerance").
        Returns True when the request was handled here — re-enqueued for
        another attempt (the stream stays open and resumes on a healthy
        replica from prompt + delivered tokens, lossless under greedy
        decoding) or completed because nothing more was owed. False →
        the caller fails it terminally (retries exhausted, deadline
        passed, cancellation, or shutdown)."""
        ft = self.config.fault_tolerance
        if self._closed or req.cancel_requested.is_set() or req.expired():
            return False
        if req.attempts > ft.max_retries:
            return False          # attempts = 1 + retries already taken
        ended_eos = (req.eos_token_id is not None and req.generated_tokens
                     and req.generated_tokens[-1] == req.eos_token_id)
        if req.remaining_new_tokens <= 0 or ended_eos:
            # the crash raced the finish: every owed token was delivered
            # (budget exhausted, or the EOS token itself already reached
            # the stream — resuming would generate past EOS)
            req.finish(RequestState.FINISHED,
                       FinishReason.EOS if ended_eos else FinishReason.LENGTH)
            self.metrics.counter("requests_completed").inc()
            return True
        req.attempts += 1
        req.state = RequestState.QUEUED
        req.replica_id = None
        if req.spans is not None:
            root = req.spans.get("request")
            if root is not None:
                root.set("attempts", req.attempts)
            # the span chain re-enters the queue stage; the attempt
            # number distinguishes the retry's stages in the trace
            req.begin_span(self.tracer, "queue",
                           attrs={"attempt": req.attempts})
        if not self.admission.requeue(req):
            return False          # queue closed mid-failover: shutdown
        self.metrics.counter("requests_failed_over").inc()
        self.journal.emit("request_failover", uid=req.uid,
                          attempt=req.attempts)
        return True

    # ------------------------------------------------- dynamic membership
    def add_replica(self, role: str = "mixed",
                    model_id: Optional[str] = None) -> int:
        """Grow the fleet by one replica built from the stored
        ``engine_factory`` — or, with ``model_id``, from that model
        pool's factory, so a grown pool member hosts the right model.
        Returns the new replica id (monotonic, never reused). Only the
        ``"mixed"`` role exists without disaggregation."""
        fac = (self._model_factories.get(model_id)
               if model_id is not None else None)
        if model_id is not None and fac is None:
            raise ValueError(f"unknown model {model_id!r} (configured: "
                             f"{sorted(self._model_factories)})")
        if self._engine_factory is None and fac is None:
            raise RuntimeError("add_replica requires an engine_factory")
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"unknown replica role {role!r} "
                             "(expected prefill/decode/mixed)")
        if role != "mixed":
            raise ValueError(f"role {role!r} requires "
                             "disaggregation.enabled — a single-role "
                             "fleet routes every replica as mixed")
        with self._fleet_lock:
            if self._closed:
                raise RuntimeError("frontend is shut down")
            rid = self._next_replica_id
            self._next_replica_id += 1
            if model_id is not None:
                self._replica_models[rid] = model_id
            try:
                engine = (fac() if fac is not None
                          else self._engine_factory(rid))
                replica = self._build_replica(rid, engine)
                self.router.add_replica(replica)
            except Exception:
                self._replica_models.pop(rid, None)
                raise
            if self.supervisor is not None:
                self.supervisor.register_slot(rid)
        return rid

    def remove_replica(self, replica_id: int, reason: str = "scale_down",
                       timeout_s: float = 30.0) -> bool:
        """Shrink the fleet by one. Order matters for safety: the
        supervisor slot is retired FIRST (a pending restart is cancelled;
        one already building drops its replacement — no resurrection
        race), then the replica drains WITH evacuation — resident
        sequences are handed back with their KV staged for re-import
        elsewhere (or re-prefilled from prompt + delivered tokens),
        lossless under greedy decoding either way — and only then is it
        unlinked and stopped. Refuses to remove the last (or last
        accepting) replica: all-replicas-removed is impossible by
        construction."""
        with self._fleet_lock:
            if self._closed:
                raise RuntimeError("frontend is shut down")
            target = self.router.replica_by_id(replica_id)
            if target is None:
                raise KeyError(f"no replica {replica_id}")
            others = [r for r in self.router.replicas if r is not target]
            if not others:
                raise ValueError("cannot remove the last replica")
            if self._models:
                mid = getattr(target, "model_id", "default")
                if not any(getattr(r, "model_id", "default") == mid
                           for r in others):
                    raise ValueError("cannot remove the last replica of "
                                     f"model {mid!r}")
            if target.accepting and not any(r.accepting for r in others):
                raise ValueError("cannot remove the last accepting "
                                 "replica")
            if self.supervisor is not None:
                self.supervisor.retire_slot(replica_id)
            self._drain_out(target, timeout_s)
            # stop what the unlink actually removed: a supervisor restart
            # that squeaked past the retired check may have swapped a
            # STARTED replacement into the slot since the lookup above
            removed = self.router.remove_replica(replica_id)
            removed.stop(timeout=1.0)
            if removed is not target:
                target.stop(timeout=1.0)
            self._replica_models.pop(replica_id, None)
        return True

    def set_replica_role(self, replica_id: int, role: str,
                         timeout_s: float = 30.0) -> bool:
        """Re-role a replica (disaggregated serving, not ported)."""
        raise not_ported("set_replica_role (disaggregated prefill/decode "
                         "serving)", _ITEM_10B)

    def _drain_out(self, replica, timeout_s: float) -> None:
        """Evacuate + wait for a replica's worker to exit (no-op for a
        DEAD/STOPPED replica — its requests already failed over)."""
        from .replica import ReplicaState

        if replica.state in (ReplicaState.DEAD, ReplicaState.STOPPED):
            return
        replica.request_evacuation(self._evacuate_handback)
        deadline = time.monotonic() + max(0.0, timeout_s)
        while replica.thread.is_alive() \
                and time.monotonic() < deadline:
            time.sleep(0.005)

    def _evacuate_handback(self, req: ServingRequest, payload,
                           replica_id: int) -> None:
        """Evacuation hand-back (runs on the draining replica's worker
        thread): re-queue the request — with its exported KV staged for
        import on the destination when available, marked so the import
        side keeps it out of the disagg handoff counters — or settle it
        if cancel/deadline/shutdown already claimed it."""
        if (self._closed or req.cancel_requested.is_set()
                or req.expired()):
            if req.cancel_requested.is_set():
                req.finish(RequestState.CANCELLED, FinishReason.CANCELLED)
                self.metrics.counter("requests_cancelled").inc()
            elif req.expired():
                req.finish(RequestState.EXPIRED, FinishReason.DEADLINE)
                self.metrics.counter("requests_expired").inc()
            else:
                req.finish(RequestState.REJECTED, "draining")
                self.metrics.counter("requests_shed").inc()
            return
        if payload is not None:
            payload["evacuated"] = True
            if self._evacuation_stager().try_stage(req, payload):
                req.handoff_t = time.monotonic()
            # else: staging budget full — the payload is dropped and
            # the request re-prefills (recompute fallback, still
            # lossless), exactly the disagg handoff degradation
        self.metrics.counter("requests_evacuated").inc()
        if req.spans is not None:
            req.begin_span(self.tracer, "queue",
                           attrs={"evacuated_from": replica_id})
        req.state = RequestState.QUEUED
        req.replica_id = None
        if not self.admission.requeue(req):
            # queue closed mid-evacuation: shutdown — terminal
            req.finish(RequestState.REJECTED, "draining")
            self.metrics.counter("requests_shed").inc()

    def _evacuation_stager(self):
        """Staging budget for evacuated KV: a lazily-built stager with
        ``disaggregation.handoff.max_staged`` entries."""
        if self._evac_stager is None:
            from .handoff import HandoffStager

            self._evac_stager = HandoffStager(
                self.config.disaggregation.handoff.max_staged,
                self.metrics)
        return self._evac_stager

    def fleet_signals(self):
        """The autoscaler's signal snapshot (not ported)."""
        raise not_ported("the elastic autoscaler (serving/autoscaler.py)",
                         _ITEM_10B)

    def set_proactive_brownout(self, fraction: Optional[float]) -> None:
        """The autoscaler's brownout actuator (not ported)."""
        raise not_ported("the elastic autoscaler (serving/autoscaler.py)",
                         _ITEM_10B)

    # ---------------------------------------------------------- lifecycle
    def stream(self, handle: RequestHandle, timeout: Optional[float] = None):
        return handle.stream(timeout=timeout)

    def cancel(self, handle: RequestHandle) -> None:
        """Request cancellation. A still-queued request is removed from
        the admission queue immediately (freeing its depth slot for new
        traffic); a dispatched one is cancelled by its replica between
        scheduler steps, which frees its KV blocks promptly."""
        req = handle._req
        req.cancel_requested.set()
        if self.admission.remove(req):
            req.finish(RequestState.CANCELLED, FinishReason.CANCELLED)
            self.metrics.counter("requests_cancelled").inc()
            return

    def wait_all(self, handles: Sequence[RequestHandle],
                 timeout: Optional[float] = None) -> bool:
        deadline = (time.monotonic() + timeout) if timeout is not None else None
        for h in handles:
            left = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            if not h._req.wait(left):
                return False
        return True

    # ------------------------------------------------------------- metrics
    def _observability_tick(self) -> None:
        """Router-tick hook (~1/s): feed the windowed-metrics ring and,
        with ``slo.enabled``, run the burn-rate alert state machines.
        Both are cadence-gated internally; the router exception-isolates
        the call."""
        self.windowed.maybe_tick()
        if self.alerts is not None:
            self.alerts.maybe_evaluate()
        self._maybe_journal_tier_pressure()
        self._refresh_admission_gauges()
        # distinct remote journal sources currently held (0 on an
        # in-process fleet — the gauge exists either way)
        self.metrics.gauge("fleet_telemetry_sources").set(
            len(self.fleet.sources()))

    def _refresh_admission_gauges(self) -> None:
        """Sum the fleet's reservation shortfall and parked-sequence
        footprint into the ``queue_wait_blocks`` /
        ``preempted_resident_blocks`` gauges, and feed the queue's
        preempt-pressure flag (labels overload sheds; docs/SERVING.md
        "Admission and preemption"). Cheap no-ops — both reads are
        plain ints — when admission is off."""
        shortfall = parked = 0
        for rep in self.router.replicas:
            sched = getattr(rep, "scheduler", None)
            if sched is None:
                continue
            fn = getattr(sched, "reserve_shortfall_blocks", None)
            if fn is not None:
                shortfall += fn()
            fn = getattr(sched, "preempted_resident_blocks", None)
            if fn is not None:
                parked += fn()
        self.metrics.gauge("queue_wait_blocks").set(shortfall)
        self.metrics.gauge("preempted_resident_blocks").set(parked)
        self.admission.set_preempt_pressure(shortfall > 0 or parked > 0)

    def _maybe_journal_tier_pressure(self) -> None:
        """Journal a ``kv_tier_pressure`` event when the fleet's KV tier
        churned since the last EMITTED event (spills or drops — the
        signals that the device pool is too small for the working set
        and, on drops, that the tier itself is too). Cadence-gated to
        ~1/s; silent while the tier is idle or absent.

        Deltas are per replica SLOT against the slot's last-emitted
        baseline, with Prometheus-style reset detection (a counter
        below its baseline means the supervisor swapped in a fresh
        engine — baseline drops to zero, not negative deltas), and the
        baselines advance only when an event is emitted — restores that
        happen in quiet windows are carried into the next event instead
        of being silently absorbed."""
        now = time.monotonic()
        if now - self._tier_journal_t < 1.0:
            return
        self._tier_journal_t = now
        deltas = {"spilled": 0, "restored": 0, "dropped": 0}
        host_bytes = 0
        current: dict = {}
        found = False
        for rep in self.router.replicas:
            fn = getattr(getattr(rep, "engine", None), "tier_stats", None)
            if fn is None:
                continue
            try:
                t = fn()
            except Exception:
                continue
            found = True
            slot = getattr(rep, "replica_id", id(rep))
            base = self._tier_last.get(slot)
            if base is None or any(t.get(k, 0) < base[k] for k in deltas):
                base = {k: 0 for k in deltas}    # fresh engine: reset
            for k in deltas:
                deltas[k] += t.get(k, 0) - base[k]
            current[slot] = {k: t.get(k, 0) for k in deltas}
            host_bytes += t.get("host_bytes", 0)
        if not found:
            return
        if deltas["spilled"] > 0 or deltas["dropped"] > 0:
            self.journal.emit("kv_tier_pressure",
                              spilled=deltas["spilled"],
                              restored=deltas["restored"],
                              dropped=deltas["dropped"],
                              host_bytes=int(host_bytes))
            # MERGE, don't replace: a slot whose stats read transiently
            # failed this tick must keep its baseline, or its lifetime
            # totals would re-emit as a phantom burst next tick
            self._tier_last.update(current)

    def _refresh_kv_gauges(self) -> None:
        """Sum KV-pool occupancy over the fleet into the
        ``kv_blocks_in_use`` / ``kv_bytes_in_use`` gauges (docs/SERVING.md
        "KV quantization" / OBSERVABILITY.md). One consistent read per
        replica from ``engine.occupancy()`` — the single snapshot that
        replaced the ad-hoc block counts (BlockedAllocator.occupancy)."""
        self._refresh_admission_gauges()
        blocks = total_bytes = 0
        host_blocks = host_bytes = disk_blocks = disk_bytes = 0
        pbytes_total = pbytes_quant = 0
        role_blocks: dict = {}
        found = False
        for rep in self.router.replicas:
            occ_fn = getattr(getattr(rep, "engine", None), "occupancy", None)
            if occ_fn is None:
                continue
            try:
                occ = occ_fn()
            except Exception:
                continue
            found = True
            # resident param bytes (docs/SERVING.md "Weight
            # quantization"): fleet-summed from engine.param_stats(),
            # the replicas-per-host capacity ledger weight quantization
            # moves — zero quantized share on full-precision engines
            stats_fn = getattr(rep.engine, "param_stats", None)
            if stats_fn is not None:
                try:
                    ps = stats_fn()
                    pbytes_total += int(ps.get("param_bytes_total", 0))
                    pbytes_quant += int(ps.get("param_bytes_quantized", 0))
                except Exception:
                    pass
            blocks += occ.get("in_use_blocks", 0)
            total_bytes += occ.get("bytes_in_use", 0)
            # tiered KV residency (docs/SERVING.md "KV tiering"); zero
            # on engines without a tier — same occupancy schema
            host_blocks += occ.get("kv_blocks_host_tier", 0)
            host_bytes += occ.get("kv_bytes_host_tier", 0)
            disk_blocks += occ.get("kv_blocks_disk_tier", 0)
            disk_bytes += occ.get("kv_bytes_disk_tier", 0)
            role = getattr(rep, "role", "mixed")
            role_blocks[role] = (role_blocks.get(role, 0)
                                 + occ.get("in_use_blocks", 0))
        if found:
            self.metrics.gauge("kv_blocks_in_use").set(blocks)
            self.metrics.gauge("kv_bytes_in_use").set(total_bytes)
            self.metrics.gauge("kv_blocks_host_tier").set(host_blocks)
            self.metrics.gauge("kv_blocks_disk_tier").set(disk_blocks)
            self.metrics.gauge("kv_tier_bytes_host").set(host_bytes)
            self.metrics.gauge("kv_tier_bytes_disk").set(disk_bytes)
            self.metrics.gauge("param_bytes_total").set(pbytes_total)
            self.metrics.gauge("param_bytes_quantized").set(pbytes_quant)
            # per-role split (docs/SERVING.md "Disaggregated serving"):
            # handoff pressure — decode pools filling while prefill
            # pools stay light — is visible in flight-recorder metric
            # snapshots via these gauges
            for role, n in role_blocks.items():
                self.metrics.gauge(f"kv_blocks_in_use_role_{role}").set(n)

    def metrics_snapshot(self) -> dict:
        self._refresh_kv_gauges()
        snap = self.metrics.snapshot()
        submitted = snap.get("requests_submitted", 0.0) or 0.0
        snap["shed_rate"] = (snap.get("requests_shed", 0.0) / submitted
                             if submitted else 0.0)
        return snap

    def publish_metrics(self, monitor, step: int = 0) -> None:
        """Fan the registry out through a monitor/ backend (MonitorMaster,
        CSVMonitor, ...)."""
        self._refresh_kv_gauges()
        self.metrics.publish(monitor, step)

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the serving registry — hand this
        to whatever scrapes/serves /metrics (docs/OBSERVABILITY.md)."""
        return self.metrics.render_prometheus()

    @property
    def observability_address(self) -> Optional[str]:
        """``host:port`` of the scrape endpoint (resolved — port 0 in
        the config binds a free port), or ``None`` when
        ``observability:`` is disabled."""
        ep = getattr(self, "_obs_endpoint", None)
        return ep.address if ep is not None else None

    # --------------------------------------------------------- health report
    def health_report(self, window_s: float = 60.0,
                      recent_events: int = 20) -> dict:
        """One queryable fleet-health answer (docs/OBSERVABILITY.md
        "The health report"): SLO status + active alerts, windowed
        latency summaries per class, replica states, queue depths
        (total and per class), KV occupancy, headline counters, and the
        recent ops-journal tail — merged into a single dict. Works with
        every feature off (the SLO block is then ``None`` and the window
        summaries cover whatever history the passive ring holds)."""
        self._refresh_kv_gauges()
        # forced tick: the report reads up-to-the-moment. Safe at any
        # poll rate — faster-than-cadence ticks refresh the ring head
        # instead of appending, so a fast dashboard can't shrink the
        # window history (windowed.tick docstring).
        self.windowed.tick()
        snap = self.metrics.snapshot()
        classes = sorted(self.config.classes)
        tenants = sorted(self.config.tenants)
        hist_names = (["ttft_s", "tpot_s", "queue_wait_s",
                       "kv_tier_restore_s", "preempt_spill_s",
                       "preempt_resume_s"]
                      + [f"ttft_s_class_{c}" for c in classes]
                      + [f"tpot_s_class_{c}" for c in classes]
                      + [f"ttft_s_tenant_{t}" for t in tenants]
                      + [f"tpot_s_tenant_{t}" for t in tenants])
        report = {
            "wall_time": time.time(),
            "replicas": [{"id": r.replica_id, "state": r.state.value,
                          "role": getattr(r, "role", "mixed"),
                          "model": getattr(r, "model_id", "default"),
                          "outstanding_tokens": r.outstanding_tokens}
                         for r in self.router.replicas],
            "replicas_healthy": snap.get("replicas_healthy", 0.0),
            "replicas_parked": snap.get("replicas_parked", 0.0),
            "queue": {
                "depth": snap.get("queue_depth", 0.0),
                "per_class": {c: snap.get(f"queue_depth_class_{c}", 0.0)
                              for c in classes},
                "brownout_active": bool(snap.get("brownout_active", 0.0)),
            },
            "occupancy": {
                "kv_blocks_in_use": snap.get("kv_blocks_in_use", 0.0),
                "kv_bytes_in_use": snap.get("kv_bytes_in_use", 0.0),
                "kv_blocks_host_tier": snap.get("kv_blocks_host_tier", 0.0),
                "kv_tier_bytes_host": snap.get("kv_tier_bytes_host", 0.0),
                "kv_tier_bytes_disk": snap.get("kv_tier_bytes_disk", 0.0),
                "handoff_staged": snap.get("handoff_staged", 0.0),
                "outstanding_tokens": snap.get("outstanding_tokens", 0.0),
                "preempted_resident_blocks": snap.get(
                    "preempted_resident_blocks", 0.0),
                "queue_wait_blocks": snap.get("queue_wait_blocks", 0.0),
            },
            "counters": {k: snap.get(k, 0.0) for k in (
                "requests_submitted", "requests_completed",
                "requests_shed", "requests_expired", "requests_failed",
                "requests_failed_over", "replica_restarts",
                "handoffs_completed", "handoff_fallbacks",
                "sequences_preempted", "sequences_resumed")},
            "window_s": window_s,
            "window": self.windowed.summary(hist_names, window_s),
            "tenants": None,
            "slo": (self.alerts.status() if self.alerts is not None
                    else None),
            "alerts_firing": (self.alerts.firing()
                              if self.alerts is not None else []),
            "autoscaler": None,
            "events": self.journal.events(limit=recent_events),
        }
        # the cross-process sections keep the report's shape; an
        # in-process fleet has no remotes and no federation
        report["remotes"] = []
        report["federation"] = None
        report["fleet_journal"] = self.fleet.sources()
        report["observability_address"] = self.observability_address
        return report

    def health_report_text(self, window_s: float = 60.0,
                           recent_events: int = 10) -> str:
        """The health report rendered for a terminal/incident channel."""
        r = self.health_report(window_s=window_s,
                               recent_events=recent_events)
        lines = [
            "== serving health ==",
            "replicas: " + " ".join(
                f"{rep['id']}:{rep['state']}({rep['role']})"
                for rep in r["replicas"])
            + (f"  [{int(r['replicas_parked'])} parked]"
               if r["replicas_parked"] else ""),
            f"queue: depth={r['queue']['depth']:.0f} "
            + " ".join(f"{c}={d:.0f}"
                       for c, d in sorted(r["queue"]["per_class"].items()))
            + ("  BROWNOUT" if r["queue"]["brownout_active"] else ""),
            f"kv: blocks={r['occupancy']['kv_blocks_in_use']:.0f} "
            f"bytes={r['occupancy']['kv_bytes_in_use']:.0f} "
            f"staged={r['occupancy']['handoff_staged']:.0f}",
        ]
        c = r["counters"]
        lines.append(
            f"requests: submitted={c['requests_submitted']:.0f} "
            f"completed={c['requests_completed']:.0f} "
            f"shed={c['requests_shed']:.0f} "
            f"failed={c['requests_failed']:.0f} "
            f"failed_over={c['requests_failed_over']:.0f}")
        for name, w in sorted(r["window"].items()):
            if w.get("count"):
                lines.append(
                    f"window[{window_s:.0f}s] {name}: n={w['count']} "
                    f"p50={w['p50'] * 1e3:.1f}ms p95={w['p95'] * 1e3:.1f}ms")
        if r["slo"] is not None:
            for name, s in sorted(r["slo"].items()):
                state = "FIRING" if s["firing"] else "ok"
                lines.append(
                    f"slo {name}: {state} burn_fast={s['burn_fast']} "
                    f"burn_slow={s['burn_slow']} "
                    f"budget_spent={s['budget_spent_frac']}")
        if r["events"]:
            lines.append("recent events:")
            lines.append(self.journal.render_text(limit=recent_events))
        return "\n".join(lines)

    # ------------------------------------------------------------ telemetry
    def debug_dump(self, dump_dir: Optional[str] = None) -> dict:
        """On-demand flight-recorder dump (docs/OBSERVABILITY.md): recent
        spans, open ones included, + metric snapshots, as raw JSON and
        Chrome ``trace_event`` JSON. Returns ``{"json": path,
        "chrome_trace": path}``. Works with telemetry disabled too
        (metrics only; the span lists are empty)."""
        self.recorder.snapshot_metrics()
        return self.recorder.dump(dump_dir=dump_dir, reason="debug")

    # ------------------------------------------------------------ shutdown
    def shutdown(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """drain=True: stop admitting, let the queue flow through the
        replicas and in-flight work finish (within ``timeout``); whatever
        remains is failed with "draining". drain=False: fail everything
        still queued and stop."""
        if self._closed:
            return
        # the closed flip happens under the fleet lock: a membership
        # change already in flight (add_replica building an engine on
        # another thread) completes and installs BEFORE the flag
        # flips — its replica is then in the list the teardown below
        # stops — while any later attempt sees _closed and aborts. A
        # post-shutdown install that would leak a live worker is
        # impossible either way.
        with self._fleet_lock:
            if self._closed:
                return
            self._closed = True
        # scrape endpoint first: no HTTP reader may observe (or block
        # on) a half-torn frontend
        if self._obs_endpoint is not None:
            self._obs_endpoint.stop()
        timeout = timeout if timeout is not None else self.config.drain_timeout_s
        deadline = time.monotonic() + timeout
        if drain:
            while len(self.admission) and time.monotonic() < deadline:
                time.sleep(0.01)
        for req in self.admission.close():
            req.finish(RequestState.REJECTED, "draining")
            self.metrics.counter("requests_shed").inc()
        self.router.stop(drain=drain,
                         timeout=max(1.0, deadline - time.monotonic()))
