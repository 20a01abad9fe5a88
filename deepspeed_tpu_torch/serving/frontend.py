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
test-only fault injector, dynamic membership with evacuation, multi-tenant
fair share and quotas (``serving/tenancy.py``), prefix-affinity routing
with warm-up of grown replicas (``serving/affinity.py``), disaggregated
prefill/decode roles with the host-RAM KV handoff, the elastic autoscaler
(``serving/autoscaler.py``), and the telemetry surface: one
:class:`MetricsRegistry` (TTFT/TPOT/queue histograms, shed/cancel/complete
counters) that fans out through any ``monitor/``-style backend via
:meth:`publish_metrics`, the ops journal, windowed metrics, SLO burn-rate
alerts, the flight recorder and the health report.

Replicas may share one card: each runs its own thread, KV pools and
scheduler over its own engine (engines may share weight tensors). A KV
handoff moves through host RAM: the prefill replica's worker copies the
blocks out, the decode replica's worker copies them into its own pool.

Replicas may also live in other processes (the serving fabric,
``serving/fabric/``): ``fabric.peers`` and ``models.<name>.peers`` adopt
replica servers as :class:`~deepspeed_tpu_torch.serving.fabric.remote.
RemoteHandle` members, ``fabric.federation`` exports a slice of this
frontend's pool and adopts peer frontends' exports, and ``chaos`` installs
the network fault injector. A remote handoff's KV crosses the wire in
chunk frames.

Where the JAX frontend swallows every exception of a KV export or a
warm-up, the port catches only ``ValueError`` and ``RuntimeError`` (a CUDA
error is a ``RuntimeError``): anything else is a fault that must not be
served around.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import resolve_device
from ..telemetry import FlightRecorder  # noqa: F401  (re-export surface)
from ..telemetry.fleet import FleetJournal
from ..telemetry.journal import OpsJournal
from ..telemetry.slo import AlertEngine
from ..telemetry.windowed import WindowedMetrics
from ..utils.locks import RankedLock
from ..utils.logging import logger
from .config import ServingConfig
from .metrics import MetricsRegistry, serving_metrics
from .queue import AdmissionQueue
from .replica import Replica
from .request import (FinishReason, Rejected, RequestHandle,
                      RequestState, ServingRequest)
from .router import ReplicaRouter


class _PeerRef:
    """Engine-factory sentinel for a fabric peer slot: the supervisor's
    restart path calls ``engine_factory(rid)`` then
    ``replica_factory(rid, engine)`` — for a remote slot the "engine"
    is the peer address, and the replica factory builds a fresh
    RemoteHandle (dial + server-side engine reset) instead."""

    def __init__(self, address: str):
        self.address = address


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


def model_from_spec(spec, device=None):
    """``(model, params, device)`` for a
    :class:`~deepspeed_tpu_torch.serving.config.ModelSpec` (``{model,
    engine, seed, checkpoint}``) on ``device`` (``cuda`` unless ``"cpu"``
    is passed). A spec with a checkpoint loads the universal checkpoint
    (``runtime/checkpointing.py``), so a JAX-written checkpoint serves the
    same weights in both packages. A spec without one draws weights from
    ``torch.Generator(device).manual_seed(seed)``: one seed gives one set
    of weights across the port's replicas, restarts and replica server
    processes on one device type, but not the JAX package's weights (torch
    cannot reproduce ``jax.random``). A ``dtype`` given by name
    (``"bfloat16"``, as a JSON spec writes it) is the torch dtype of that
    name; seeded weights of a 16-bit model are stored in that dtype (the
    compute casts to it either way), fp32 otherwise."""
    from ..models.transformer import CausalLM, TransformerConfig

    dev = resolve_device(device)
    kw = dict(spec.model)
    if isinstance(kw.get("dtype"), str):
        dt = getattr(torch, kw["dtype"], None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"model dtype {kw['dtype']!r} is not a torch "
                             "dtype")
        kw["dtype"] = dt
    model = CausalLM(TransformerConfig(**kw))
    if spec.checkpoint:
        from ..runtime.checkpointing import load_params_for_model

        params = load_params_for_model(model, spec.checkpoint, device=dev)
    else:
        store = (model.cfg.dtype
                 if model.cfg.dtype in (torch.bfloat16, torch.float16)
                 else None)
        params = model.init(
            torch.Generator(device=dev).manual_seed(int(spec.seed)),
            device=dev, dtype=store)
    return model, params, dev


def engine_from_model_spec(spec, device=None):
    """Build one InferenceEngineV2 from a ModelSpec (weights as
    :func:`model_from_spec` gives them)."""
    from ..inference.v2.engine_v2 import (InferenceEngineV2,
                                          RaggedInferenceEngineConfig)

    model, params, dev = model_from_spec(spec, device)
    return InferenceEngineV2(
        model, params=params,
        config=RaggedInferenceEngineConfig(**dict(spec.engine)), device=dev)


class ServingFrontend:
    # lock discipline (docs/CONCURRENCY.md): membership admin state is
    # written under the fleet lock. ``_closed``, ``_role_overrides``
    # and ``_replica_models`` are writes-only guarded — their readers
    # (submit's fast-path check, the supervisor's restart-time role /
    # model lookup) take lock-free last-write-wins snapshots by design.
    _GUARDED_BY = {
        "_closed": "_fleet_lock:writes",
        "_next_replica_id": "_fleet_lock",
        "_role_overrides": "_fleet_lock:writes",
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
        self._device = device
        # cross-process serving fabric (docs/SERVING.md "Multi-host
        # serving"): peers are replica server processes adopted as
        # RemoteHandle replicas, ids allocated after the local engines.
        # None when disabled — no handles, no transport, the in-process
        # stack as before.
        fab = self.config.fabric
        self._fabric = fab if fab.enabled else None
        peer_addrs = list(fab.peers) if self._fabric is not None else []
        # multi-model registry (docs/SERVING.md "Multi-model & multi-tenant
        # serving"): named ModelSpecs add replica pools — local engines
        # built from each spec (or a caller-supplied
        # ``model_engine_factories[name]``, which wins). Empty = the
        # single-pool stack, every replica model_id "default".
        self._models = dict(self.config.models)
        self._default_model = self.config.resolve_default_model()
        model_peer_count = sum(len(s.peers) for s in self._models.values())
        fed_peer_count = (len(fab.federation.peers)
                          if self._fabric is not None
                          and fab.federation.enabled else 0)
        if not engines and not peer_addrs and not self._models \
                and not fed_peer_count:
            # an edge frontend with NO local engines is a legitimate
            # federation topology: it serves entirely off peers' exports
            raise ValueError("ServingFrontend needs at least one engine "
                             "(or fabric.peers, fabric.federation.peers, "
                             "or a models: registry)")
        if (peer_addrs or model_peer_count or fed_peer_count) \
                and sample_fn is not None:
            # a frontend-level callable cannot cross the wire: remote
            # replicas would silently fall back to greedy sampling while
            # local ones use the custom sampler — same request, different
            # tokens depending on routing. Refuse loudly.
            raise ValueError(
                "fabric.peers is incompatible with a custom sample_fn — "
                "a sampler callable cannot cross the process boundary "
                "(configure sampling in the replica servers' specs "
                "instead)")
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
        # multi-tenant fair share / quotas: one ledger per frontend,
        # consulted by the queue's DWF pop and the router's KV-budget
        # filter. None when no ``tenants:`` block — every path as before.
        self._tenancy = None
        if self.config.tenants:
            from .tenancy import TenantLedger

            self._tenancy = TenantLedger(self.config.tenants,
                                         metrics=self.metrics,
                                         journal=self.journal)
        ft = self.config.fault_tolerance
        self.admission = AdmissionQueue(
            self.config.max_queue_depth, self.metrics,
            brownout_threshold=(ft.brownout_threshold if ft.enabled
                                else 0.0),
            journal=self.journal, tenancy=self._tenancy)
        # dynamic membership: replica ids are allocated monotonically and
        # never reused; the fleet lock serializes membership mutations
        self._engine_factory = engine_factory
        # replica-id layout: caller engines, global fabric peers, then
        # each named model pool (locals before peers) in sorted-name order
        # — ids stay monotonic and are never reused either way
        self._peer_addrs = {len(engines) + i: addr
                            for i, addr in enumerate(peer_addrs)}
        # rid -> model_id for every slot outside the unnamed-default pool
        # (absent = "default"); with a models: registry the caller's plain
        # engines serve the default model's pool
        self._replica_models: Dict[int, str] = {}
        if self._models:
            for rid in range(len(engines) + len(peer_addrs)):
                self._replica_models[rid] = self._default_model
        next_rid = len(engines) + len(peer_addrs)
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
            for addr in spec.peers:
                self._peer_addrs[next_rid] = addr
                self._replica_models[next_rid] = name
                next_rid += 1
        self._next_replica_id = next_rid
        # role overrides (set by add_replica / set_replica_role) win over
        # the static disaggregation.roles list
        self._role_overrides: dict = {}
        self._fleet_lock = RankedLock("serving.frontend.fleet")
        # frontend federation (docs/SERVING.md "Frontend federation"): a
        # two-tier fleet — this frontend EXPORTS a slice of its local pool
        # on fabric.listen and ADOPTS peers' exports as routable members.
        # All None/empty when disabled: no identity derived, no listener
        # bound, no peers dialed. The server starts BEFORE peer adoption so
        # a misconfigured self-peer gets the typed refusal, not a
        # connection error.
        self._federation = None
        self._federation_server = None
        self._federation_peers: list = []
        self._federated_refs: dict = {}
        if self._fabric is not None and fab.federation.enabled:
            from .fabric.federation import (FederationServer, derive_epoch,
                                            derive_frontend_id)

            self._federation = fab.federation
            self._federation_id = (fab.federation.frontend_id
                                   or derive_frontend_id())
            self._federation_epoch = derive_epoch()
            self._federation_server = FederationServer(
                self, listen=fab.listen, frontend_id=self._federation_id,
                epoch=self._federation_epoch)
            self._federation_server.start()
        # evacuated KV rides the same bounded host-RAM staging budget as
        # disagg handoffs (built lazily when no handoff stager exists) —
        # a removal of a fully-loaded replica must not balloon host RAM;
        # over-budget payloads drop to re-prefill
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
        # deterministic NETWORK fault injection (test-only;
        # serving/fabric/chaos.py) — installed process-wide so every
        # connection dialed or accepted from here on interposes its
        # matching schedule; None when the ``chaos:`` block is off: the
        # transport never sees a shim
        self.net_chaos = self.config.chaos.build_injector()
        if self.net_chaos is not None:
            from .fabric import chaos as _net_chaos

            _net_chaos.install(self.net_chaos)
        # disaggregated prefill/decode serving: role-split replicas +
        # host-RAM KV handoff staging. None when disabled — no role
        # enforcement, no handoff hooks, the single-role stack as before.
        dis = self.config.disaggregation
        self._disagg = dis if dis.enabled else None
        self._stager = None
        if self._disagg is not None:
            self._validate_disaggregation(self._next_replica_id)
            if dis.handoff.enabled:
                from .handoff import HandoffStager

                self._stager = HandoffStager(dis.handoff.max_staged,
                                             self.metrics)
        replicas = [self._build_replica(i, eng)
                    for i, eng in enumerate(engines)]
        replicas += [self._build_replica(rid, self._model_factories[name]())
                     for rid, name in model_locals]
        replicas += [self._build_remote(rid, addr)
                     for rid, addr in sorted(self._peer_addrs.items())]
        replicas += self._adopt_federation_peers()
        # prefix-affinity routing state: digests refresh on the router
        # tick, pick(req) scores overlap as a prefill-token credit. None
        # when disabled: the cache-blind pick path.
        self._affinity = None
        if self.config.affinity.enabled:
            from .affinity import AffinityState

            self._affinity = AffinityState(self.config.affinity,
                                           metrics=self.metrics)
        # ~1/s observability tick on the router loop: windowed-metrics
        # snapshots always; SLO alert evaluation when enabled
        self.router = ReplicaRouter(replicas, self.admission, self.metrics,
                                    tracer=self.tracer,
                                    recorder=self.recorder,
                                    disaggregation=self._disagg,
                                    tick_hooks=[self._observability_tick],
                                    tenancy=self._tenancy,
                                    affinity=self._affinity)
        self.supervisor = None
        if ft.enabled:
            from .supervisor import ReplicaSupervisor

            # peer slots restart through _PeerRef sentinels (a fresh
            # handle + server-side engine reset), federated slots through
            # their _ExportRef (re-adoption over the same export),
            # named-model slots from their pool's factory, the rest from
            # the caller's (None: the supervisor's salvage path)
            self.supervisor = ReplicaSupervisor(
                self.router, self._build_replica,
                (self._engine_source
                 if (self._peer_addrs or self._model_factories
                     or self._federated_refs)
                 else engine_factory),
                config=ft, metrics=self.metrics, tracer=self.tracer,
                recorder=self.recorder, journal=self.journal)
            self.router.supervisor = self.supervisor
        self.metrics.gauge("replicas_target").set(len(replicas))
        # elastic autoscaling: the FleetController rides the router tick;
        # its actuation (engine builds, evacuation waits) runs on its own
        # worker thread
        self.autoscaler = None
        asc = self.config.autoscaler
        if asc.enabled:
            if engine_factory is None and not self._model_factories:
                raise ValueError(
                    "autoscaler.enabled requires an engine_factory — a "
                    "fleet with no way to build engines cannot grow "
                    "(use ServingFrontend.from_engine_factory, pass "
                    "engine_factory=, or configure a models: registry "
                    "whose specs are buildable)")
            from .autoscaler import FleetController

            self.autoscaler = FleetController(
                asc, self, metrics=self.metrics, journal=self.journal)
            self.router.tick_hooks.append(self.autoscaler.maybe_tick)
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

    def _validate_disaggregation(self, n_engines: int) -> None:
        """Reject role maps that cannot serve: unknown roles, a role list
        that does not match the fleet, a fleet with no decode-capable
        replica (prefill-only replicas can never emit a token), and
        prefill roles without the handoff path (their finished prompts
        would have nowhere to go)."""
        dis = self.config.disaggregation
        roles = list(dis.roles)
        bad = [r for r in roles if r not in ("prefill", "decode", "mixed")]
        if bad:
            raise ValueError(f"disaggregation.roles has unknown roles "
                             f"{bad} (expected prefill/decode/mixed)")
        if roles and len(roles) != n_engines:
            raise ValueError(
                f"disaggregation.roles lists {len(roles)} roles for "
                f"{n_engines} replicas — one role per replica")
        if roles and not any(r in ("decode", "mixed") for r in roles):
            raise ValueError("disaggregation.roles needs at least one "
                             "decode-capable (decode/mixed) replica")
        if "prefill" in roles and not dis.handoff.enabled:
            raise ValueError("disaggregation with prefill-role replicas "
                             "requires handoff.enabled")

    def _role_of(self, replica_id: int) -> str:
        override = self._role_overrides.get(replica_id)
        if override is not None:
            return override
        if self._disagg is None:
            return "mixed"
        return self._disagg.role_of(replica_id)

    def _engine_source(self, replica_id: int):
        """Supervisor-facing engine factory when fabric peers or model
        pools exist: peer slots resolve to :class:`_PeerRef` sentinels
        (the restart builds a fresh RemoteHandle against the same server),
        federated slots to their export reference, named-model slots to
        that model's factory (a restarted pool member must host ITS
        model), default slots to the caller's factory — or ``None`` when
        there is none, which tells the supervisor to take its
        salvage-engine path."""
        ref = self._federated_refs.get(replica_id)
        if ref is not None:
            # federated slot: restart = a fresh mirror over the SAME export
            # on the SAME peer (the exporter owns the replica)
            return ref
        addr = self._peer_addrs.get(replica_id)
        if addr is not None:
            return _PeerRef(addr)
        fac = self._model_factories.get(
            self._replica_models.get(replica_id, "default"))
        if fac is not None:
            return fac()
        if self._engine_factory is None:
            return None
        return self._engine_factory(replica_id)

    def _build_remote(self, replica_id: int, address: str,
                      reset: bool = False):
        """One RemoteHandle over a fabric peer with this frontend's full
        wiring — the boot path AND the supervisor's restart path
        (``reset=True`` additionally rebuilds the server-side engine, so a
        restarted remote replica is as fresh as a restarted local one).
        The server applies the engine-level config blocks itself
        (``apply_engine_serving_config`` from ITS spec) — the role is the
        one thing the frontend dictates."""
        from .fabric.remote import RemoteHandle

        ft = self.config.fault_tolerance
        handle = RemoteHandle(
            replica_id, address, self.config.fabric,
            role=self._role_of(replica_id), metrics=self.metrics,
            tracer=self.tracer, recorder=self._replica_recorder,
            journal=self.journal, fleet=self.fleet,
            model_id=self._replica_models.get(replica_id, "default"),
            on_failover=self._failover if ft.enabled else None,
            on_handoff=self._handoff_remote)
        handle.connect(reset=reset)
        return handle

    def _adopt_federation_peers(self) -> list:
        """Dial each ``fabric.federation.peers`` frontend, run the
        bootstrap hello (identity exchange + export discovery) and build a
        :class:`FederatedHandle` router member per adopted export. Typed
        peering refusals (self-peering, stale epoch) raise — they are
        config bugs; an unreachable peer is logged and skipped — edge
        frontends boot independently. Exports of models this frontend does
        not serve are skipped: a request can only route to pools its
        submit() validates."""
        fed = self._federation
        if fed is None or not fed.peers:
            return []
        from .fabric.federation import (FederationPeer, FederationRefused,
                                        _ExportRef)
        from .fabric.transport import FabricError

        handles = []
        known = set(self._models) if self._models else {"default"}
        for addr in fed.peers:
            peer = FederationPeer(addr, self.config.fabric,
                                  frontend_id=self._federation_id,
                                  epoch=self._federation_epoch)
            try:
                peer.connect()
            except FederationRefused:
                raise               # config/topology bug: loud
            except (OSError, FabricError) as e:
                logger.warning(f"federation peer {addr} unreachable at "
                               f"boot ({e!r}); continuing without it")
                continue
            self._federation_peers.append(peer)
            for exp in peer.exports:
                mid = str(exp.get("model_id", "default"))
                if mid not in known:
                    logger.warning(
                        f"federation peer {addr} exports replica "
                        f"{exp.get('export')} of unknown model {mid!r}; "
                        "skipping")
                    continue
                with self._fleet_lock:
                    rid = self._next_replica_id
                    self._next_replica_id += 1
                    if self._models:
                        self._replica_models[rid] = mid
                ref = _ExportRef(addr, exp, peer)
                self._federated_refs[rid] = ref
                handles.append(self._build_federated(rid, ref))
        return handles

    def _build_federated(self, replica_id: int, ref, reset: bool = False):
        """One FederatedHandle over a peer frontend's exported replica —
        the boot path AND the supervisor's restart path. The evacuate
        hand-back is ALWAYS wired (unlike plain remotes, where removal sets
        it): the exporter's autoscaler can spontaneously evacuate the
        shared replica, and those hand-backs must land in this frontend's
        requeue path, not drop."""
        from .fabric.federation import FederatedHandle

        ft = self.config.fault_tolerance
        handle = FederatedHandle(
            replica_id, ref.address, self.config.fabric,
            export=ref.export, frontend_id=self._federation_id,
            epoch=self._federation_epoch, peer=ref.peer,
            metrics=self.metrics, tracer=self.tracer,
            recorder=self._replica_recorder, journal=self.journal,
            fleet=self.fleet,
            on_failover=self._failover if ft.enabled else None,
            on_handoff=self._handoff_remote)
        handle._evac_handback = self._evacuate_handback
        handle.connect(reset=reset)
        if ref.peer is not None:
            ref.peer.register(handle)
        return handle

    def _build_replica(self, replica_id: int, engine) -> Replica:
        """One replica over ``engine`` with this frontend's full wiring —
        the constructor path AND the supervisor's restart path, so a
        restarted replica is indistinguishable from a first-boot one
        (engine blocks applied, proposer built, telemetry attached). A
        :class:`_PeerRef` "engine" builds a RemoteHandle instead, an
        export reference a FederatedHandle — the supervisor's restart
        path for fabric slots."""
        if isinstance(engine, _PeerRef):
            return self._build_remote(replica_id, engine.address,
                                      reset=True)
        from .fabric.federation import _ExportRef

        if isinstance(engine, _ExportRef):
            # federated slot restart: fresh mirror, same export (the peer
            # ignores the reset bit — it owns the engine)
            return self._build_federated(replica_id, engine, reset=True)
        apply_engine_serving_config(engine, self.config)
        ft = self.config.fault_tolerance
        role = self._role_of(replica_id)
        cls = Replica
        if self._fabric is not None:
            # fabric fleets name their in-process workers LocalHandle — an
            # EMPTY Replica subclass (fabric/handle.py), so behavior is
            # identical by construction
            from .fabric.handle import LocalHandle

            cls = LocalHandle
        return cls(replica_id, engine, self.metrics, self._sample_fn,
                       wedge_timeout_s=self.config.wedge_timeout_s,
                       speculative=self._spec, tracer=self.tracer,
                       recorder=self._replica_recorder,
                       faults=self.injector,
                       on_failover=self._failover if ft.enabled else None,
                       role=role,
                       model_id=self._replica_models.get(replica_id,
                                                         "default"),
                       decode_reserve_tokens=(
                           self._disagg.decode_reserve_tokens
                           if self._disagg is not None else 0),
                       on_handoff=(self._handoff if role == "prefill"
                                   else None),
                       journal=self.journal)

    @property
    def federation_address(self) -> Optional[str]:
        """host:port of this frontend's federation listener (None when
        federation is disabled) — what peers put in
        ``fabric.federation.peers``."""
        srv = self._federation_server
        return srv.address if srv is not None else None

    @classmethod
    def from_engine_factory(cls, engine_factory: Callable[[int], object],
                            config: Optional[ServingConfig] = None,
                            **kwargs) -> "ServingFrontend":
        """Build the replica fleet from the config:
        ``engine_factory(replica_id)`` is called ``config.num_replicas``
        times (the config-driven path for the ``serving: {...}`` block)."""
        config = config or ServingConfig()
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
        the request only routes to replicas of that pool; ``tenant``
        selects an entry of ``config.tenants`` (default ``"default"``) for
        fair-share / quota accounting. Both default so every call site
        without them behaves as before."""
        cfg = self.config
        cls = request_class if request_class is not None else cfg.default_class
        policy = cfg.classes.get(cls)
        if policy is None:
            # caller bug, not traffic: reject BEFORE requests_submitted
            # so the submitted/admitted/shed balance stays honest
            raise ValueError(f"unknown request class {cls!r} "
                             f"(configured: {sorted(cfg.classes)})")
        # unknown model / tenant are caller bugs too, refused before any
        # counter moves for the same reason
        model_id = model if model is not None else self._default_model
        known_models = set(self._models) if self._models else {"default"}
        if model_id not in known_models:
            raise ValueError(f"unknown model {model_id!r} "
                             f"(configured: {sorted(known_models)})")
        tenant_id = tenant if tenant is not None else "default"
        if self._tenancy is not None and not self._tenancy.known(tenant_id):
            raise ValueError(f"unknown tenant {tenant_id!r} "
                             f"(configured: {self._tenancy.tenant_names})")
        if self._tenancy is None:
            # no tenants: config, no tenant namespace — a named tenant is
            # accepted (call sites stay portable) but normalized to
            # "default", or replicas would mint per-tenant series the
            # registry never declared
            tenant_id = "default"
        self.metrics.counter("requests_submitted").inc()
        # per-class submit counter: the denominator of the SLO engine's
        # windowed availability burn rate; the per-tenant twin is the
        # denominator of the per-tenant availability rule
        self.metrics.counter(f"requests_submitted_class_{cls}").inc()
        if self._tenancy is not None:
            self.metrics.counter(
                f"requests_submitted_tenant_{tenant_id}").inc()
        if self._closed:
            self.metrics.counter("requests_shed").inc()
            self.metrics.counter(f"requests_shed_class_{cls}").inc()
            if self._tenancy is not None:
                self.metrics.counter(
                    f"requests_shed_tenant_{tenant_id}").inc()
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
            tenant=tenant_id, model_id=model_id)
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
            if self._tenancy is not None:
                self.metrics.counter(
                    f"requests_shed_tenant_{tenant_id}").inc()
            req.finish(RequestState.REJECTED, "too_long")
            raise Rejected("too_long",
                           f"{len(req.prompt_tokens)}+{req.max_new_tokens} "
                           f"tokens > max_seq_len {max_len}")
        self.admission.offer(req, block=cfg.shed_policy == "block")
        return RequestHandle(req, self)

    # ------------------------------------------------------------ handoff
    def _handoff(self, req: ServingRequest, sreq, engine,
                 replica_id: int) -> None:
        """Prefill-role completion hand-back. Runs on the prefill
        replica's worker thread (race-free engine access): export the
        finished prompt's KV blocks to host RAM, flush them from the
        source engine, stage the payload on the request, and re-queue it
        for a decode-role replica. An export that raises ``ValueError``
        or ``RuntimeError`` (a CUDA error is one), or a full staging
        buffer, degrades to the recompute fallback — the request
        re-prefills on a decode-capable replica; any other exception
        reaches the replica's worker, which dies. Cancel, deadline, and
        shutdown races settle here before any staging."""
        if (self._closed or req.cancel_requested.is_set()
                or req.expired()):
            engine.flush(req.uid)
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
        payload = None
        try:
            # block-granularity export: chunk_blocks > 0 starts every
            # chunk's host copy before any is read
            payload = engine.export_sequence(
                req.uid, chunk_blocks=self._disagg.handoff.chunk_blocks)
        except (ValueError, RuntimeError) as e:
            logger.warning(f"serving replica {replica_id}: KV export for "
                           f"request {req.uid} failed ({e!r}); falling "
                           "back to re-prefill on a decode-capable replica")
        finally:
            engine.flush(req.uid)
        if payload is not None:
            # last_logits rides the payload: the decode replica samples
            # its first token from the source's final prompt position —
            # the hinge of a lossless handoff
            payload["last_logits"] = sreq.last_logits
        self._stage_handoff(req, payload, replica_id)

    def _handoff_remote(self, req: ServingRequest, payload,
                        replica_id: int) -> None:
        """Remote-prefill completion (docs/SERVING.md "Multi-host
        serving"): the export and flush already ran in the replica server
        process; settle the cancel/deadline/shutdown races here and
        stage/requeue exactly like the local path (``payload`` None =
        server-side export failed or broke the frame bound → the same
        recompute fallback)."""
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
        self._stage_handoff(req, payload, replica_id)

    def _stage_handoff(self, req: ServingRequest, payload,
                       replica_id: int) -> None:
        """Tail of the prefill→decode handoff (local export and remote
        payload alike): stage under the host-RAM budget and requeue for a
        decode-capable replica, or degrade to the recompute fallback."""
        # the "handoff" span covers staging + queue wait + import; it is
        # ended by the decode replica at import (or by req.finish)
        req.begin_span(self.tracer, "handoff",
                       attrs={"from_replica": replica_id,
                              "blocks": (payload or {}).get("n_blocks", 0)})
        if payload is not None and self._stager is not None \
                and self._stager.try_stage(req, payload):
            self.metrics.counter("handoffs_started").inc()
            self.journal.emit("handoff_staged", uid=req.uid,
                              from_replica=replica_id,
                              blocks=payload.get("n_blocks", 0))
            req.handoff_t = time.monotonic()
        else:
            # every degraded handoff counts — export failure AND a full
            # staging buffer — or a fleet whose exports always fail
            # would be indistinguishable from one that never handed off
            self.metrics.counter("handoff_fallbacks").inc()
            self.journal.emit(
                "handoff_fallback", uid=req.uid,
                where=("export" if payload is None else "staging_full"),
                from_replica=replica_id)
            # recompute fallback: must not land on a prefill-only
            # replica (it would just hand off again)
            req.no_prefill = True
        req.state = RequestState.QUEUED
        req.replica_id = None
        if not self.admission.requeue(req):
            # queue closed mid-handoff: shutdown — terminal, slot freed
            req.finish(RequestState.REJECTED, "draining")
            self.metrics.counter("requests_shed").inc()

    # ----------------------------------------------------------- failover
    def _failover(self, req: ServingRequest) -> bool:
        """Replica-death hand-back (docs/SERVING.md "Fault tolerance").
        Returns True when the request was handled here — re-enqueued for
        another attempt (the stream stays open and resumes on a healthy
        replica from prompt + delivered tokens, lossless under greedy
        decoding) or completed because nothing more was owed. False →
        the caller fails it terminally (retries exhausted, deadline
        passed, cancellation, or shutdown)."""
        if getattr(req, "_federated", False) \
                and self._federation_server is not None:
            # federated mirror (docs/SERVING.md "Frontend federation"): the
            # real stream and the retry budget live on the ADOPTING
            # frontend — send the ordered failover marker back over the
            # federation channel instead of requeueing into THIS
            # frontend's admission queue
            return self._federation_server.detach_failover(req)
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
        Returns the new replica id (monotonic, never reused). Specialized
        roles require a role-split fleet: "prefill" additionally requires
        the handoff path (a prefill-only replica with nowhere to send its
        KV could never finish a request). With ``affinity.warmup_enabled``
        the new replica's prefix cache is warmed from the fleet before the
        router can route to it."""
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
        if role != "mixed" and self._disagg is None:
            raise ValueError(f"role {role!r} requires "
                             "disaggregation.enabled — a single-role "
                             "fleet routes every replica as mixed")
        if role == "prefill" and not self._disagg.handoff.enabled:
            raise ValueError("adding a prefill-role replica requires "
                             "handoff.enabled")
        with self._fleet_lock:
            if self._closed:
                raise RuntimeError("frontend is shut down")
            rid = self._next_replica_id
            self._next_replica_id += 1
            self._role_overrides[rid] = role
            if model_id is not None:
                self._replica_models[rid] = model_id
            try:
                engine = (fac() if fac is not None
                          else self._engine_factory(rid))
                replica = self._build_replica(rid, engine)
                # restore-before-rotation: warm the new replica's prefix
                # cache from the fleet BEFORE the router can route to it
                self._warmup_replica(rid, replica)
                self.router.add_replica(replica)
            except Exception:
                self._role_overrides.pop(rid, None)
                self._replica_models.pop(rid, None)
                raise
            if self.supervisor is not None:
                self.supervisor.register_slot(rid)
        return rid

    def _warmup_replica(self, rid: int, replica) -> None:
        """Pre-populate a grown replica's prefix cache with the
        fleet-hottest blocks merged across all accepting donors of its
        model pool: every donor exports its MRU-first blocks device→host,
        the per-donor streams are interleaved by hotness rank (each
        donor's warmest block before any donor's second-warmest),
        deduplicated by chain key, capped at ``warmup_max_blocks``, and
        scattered into the new engine before the router can route to it.
        A ``replica_warmup`` journal event records each warm-up that ran.
        Warm-up can delay a grow by at most ``warmup_timeout_s``; a
        ``ValueError`` or ``RuntimeError`` on the way is logged and the
        replica starts cold (no journal event), any other exception fails
        the grow."""
        aff = self.config.affinity
        if not (aff.enabled and aff.warmup_enabled) \
                or getattr(replica, "is_remote", False):
            return                      # a remote engine lives server-side
        t0 = time.monotonic()
        self.metrics.gauge("replicas_warming").inc()
        try:
            mid = self._replica_models.get(rid, "default")
            donors = []                 # (warmth, replica) — all of them
            for r in self.router.replicas:
                # a remote donor's KV would need a new RPC (its status
                # digest is advisory only)
                if getattr(r, "is_remote", False) or not r.accepting \
                        or getattr(r, "model_id", "default") != mid:
                    continue
                w = len(r.prefix_digest(aff.digest_max_entries))
                if w > 0:
                    donors.append((w, r))
            if not donors:
                return                  # whole fleet cold: nothing to copy
            # warmest donor first so rank ties resolve toward the
            # busiest cache; each donor exports at most the full budget
            # (dedup below may discard shared prefixes)
            donors.sort(key=lambda p: (-p[0], p[1].replica_id))
            exports = []                # (donor_id, MRU-first entries)
            for _, donor in donors:
                if time.monotonic() - t0 > aff.warmup_timeout_s:
                    break               # donors too slow: ship what we have
                got = donor.engine.export_prefix_blocks(
                    aff.warmup_max_blocks)
                if got:
                    exports.append((donor.replica_id, got))
            # merge hottest-first: rank i of every donor before rank i+1
            # of any, first exporter of a duplicate chain key wins
            seen, entries, sources = set(), [], set()
            for i in range(max((len(e) for _, e in exports), default=0)):
                for donor_id, got in exports:
                    if len(entries) >= aff.warmup_max_blocks:
                        break
                    if i < len(got) and got[i][0] not in seen:
                        seen.add(got[i][0])
                        entries.append(got[i])
                        sources.add(donor_id)
                if len(entries) >= aff.warmup_max_blocks:
                    break
            if time.monotonic() - t0 > aff.warmup_timeout_s:
                entries = []            # donors too slow: cold start
            blocks = (replica.engine.import_prefix_blocks(entries)
                      if entries else 0)
            warmup_s = time.monotonic() - t0
            self.metrics.histogram("replica_warmup_s").observe(warmup_s)
            self.journal.emit("replica_warmup", replica=rid,
                              blocks=blocks, source=sorted(sources),
                              warmup_s=warmup_s)
        except (ValueError, RuntimeError) as e:
            logger.error(f"replica {rid} prefix warm-up failed: {e!r}")
        finally:
            self.metrics.gauge("replicas_warming").dec()

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
        accepting, or last accepting decode-capable) replica:
        all-replicas-removed is impossible by construction."""
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
            if target.accepting:
                if not any(r.accepting for r in others):
                    raise ValueError("cannot remove the last accepting "
                                     "replica")
                if self._disagg is not None \
                        and target.role in ("decode", "mixed") \
                        and not any(r.accepting
                                    and r.role in ("decode", "mixed")
                                    for r in others):
                    raise ValueError("cannot remove the last accepting "
                                     "decode-capable replica")
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
            self._role_overrides.pop(replica_id, None)
            self._replica_models.pop(replica_id, None)
        return True

    def set_replica_role(self, replica_id: int, role: str,
                         timeout_s: float = 30.0) -> bool:
        """Re-role one replica prefill<->decode(<->mixed) in place: drain
        WITH evacuation (staged handoff keeps KV portable), rebuild the
        Replica over the same engine (a fresh one only if the worker
        wedged) with the new role's scheduler shape, and swap it into the
        same slot. Supervision is suspended for the slot during the swap
        and re-registered after. False when the replica already has the
        role."""
        if self._disagg is None:
            raise ValueError("set_replica_role requires "
                             "disaggregation.enabled")
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"unknown replica role {role!r}")
        if role == "prefill" and not self._disagg.handoff.enabled:
            raise ValueError("re-roling to prefill requires "
                             "handoff.enabled")
        with self._fleet_lock:
            if self._closed:
                raise RuntimeError("frontend is shut down")
            target = self.router.replica_by_id(replica_id)
            if target is None:
                raise KeyError(f"no replica {replica_id}")
            old_role = target.role
            if old_role == role:
                return False
            if old_role in ("decode", "mixed") and role == "prefill" \
                    and not any(r.accepting
                                and r.role in ("decode", "mixed")
                                for r in self.router.replicas
                                if r is not target):
                raise ValueError("re-role would leave no accepting "
                                 "decode-capable replica")
            suspended = (self.supervisor.retire_slot(replica_id)
                         if self.supervisor is not None else False)
            self._role_overrides[replica_id] = role
            try:
                self._drain_out(target, timeout_s)
                if getattr(target, "is_remote", False):
                    # fabric peer: the engine lives server-side — a fresh
                    # handle re-attaches with the new role (the server
                    # rebuilds its replica on the role change)
                    replacement = self._build_remote(
                        replica_id, self._peer_addrs[replica_id])
                else:
                    if target.thread.is_alive():
                        # wedged mid-drain: the stuck thread owns the old
                        # engine — only a fresh one is safe
                        if self._engine_factory is None:
                            raise RuntimeError(
                                f"replica {replica_id} wedged during "
                                "re-role drain and no engine_factory "
                                "exists")
                        engine = self._engine_factory(replica_id)
                    else:
                        engine = getattr(target.engine, "_ft_inner",
                                         target.engine)
                    replacement = self._build_replica(replica_id, engine)
                displaced = self.router.replace_replica(replica_id,
                                                        replacement)
                # the slot is retired during the swap, so nothing else
                # can have removed it; stop whatever was displaced (and
                # the drained target, if a racing swap displaced it
                # first)
                if displaced is not None:
                    displaced.stop(timeout=1.0)
                if displaced is not target:
                    target.stop(timeout=1.0)
            except Exception:
                self._role_overrides[replica_id] = old_role
                raise
            finally:
                if suspended:
                    self.supervisor.register_slot(replica_id)
        return True

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
        if getattr(req, "_federated", False) \
                and self._federation_server is not None:
            # federated mirror: stream the exported KV back to the
            # adopting frontend (its requeue path stages or re-prefills —
            # lossless either way), never into this one's queue
            self._federation_server.return_evacuated(req, payload)
            return
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
        """Staging budget for evacuated KV: the disagg handoff stager
        when one exists (one shared host-RAM bound + the
        ``handoff_staged`` gauge), else a lazily-built stager with the
        same configured budget."""
        if self._stager is not None:
            return self._stager
        if self._evac_stager is None:
            from .handoff import HandoffStager

            self._evac_stager = HandoffStager(
                self.config.disaggregation.handoff.max_staged,
                self.metrics)
        return self._evac_stager

    def fleet_signals(self):
        """One consistent elasticity-signal snapshot for the
        :class:`~deepspeed_tpu_torch.serving.autoscaler.FleetController`."""
        from .autoscaler import FleetSignals, ReplicaInfo

        parked = (set(self.supervisor.parked_ids())
                  if self.supervisor is not None else set())
        infos = tuple(
            ReplicaInfo(r.replica_id, getattr(r, "role", "mixed"),
                        r.accepting, r.replica_id in parked,
                        r.outstanding_prefill_tokens,
                        r.outstanding_decode_tokens,
                        remote=bool(getattr(r, "is_remote", False)),
                        federated=bool(getattr(r, "is_federated", False)),
                        model_id=getattr(r, "model_id", "default"))
            for r in self.router.replicas)
        burn = 0.0
        if self.alerts is not None:
            for st in self.alerts.status().values():
                burn = max(burn, st["burn_slow"])
        dis = self._disagg
        # per-model pool bounds, a ModelSpec's None ends resolved
        # against the global autoscaler min/max
        asc = self.config.autoscaler
        bounds = tuple(
            (name,
             spec.min_replicas if spec.min_replicas is not None
             else asc.min_replicas,
             spec.max_replicas if spec.max_replicas is not None
             else asc.max_replicas)
            for name, spec in sorted(self._models.items()))
        depth = len(self.admission)
        # predictive scaling: project the queue depth predict_horizon_s
        # ahead from the windowed submit-minus-completion rate.
        # window_rate is None until the ring has history — the controller
        # then runs pure watermarks (and predicted_load stays 0).
        predicted = None
        aff = self.config.affinity
        if aff.enabled and aff.predictive:
            w = aff.predict_window_s
            sub = self.windowed.window_rate("requests_submitted", w)
            if sub is not None:
                done = 0.0
                for name in ("requests_completed", "requests_failed",
                             "requests_shed", "requests_expired",
                             "requests_cancelled"):
                    done += self.windowed.window_rate(name, w) or 0.0
                predicted = (depth + aff.predict_horizon_s
                             * max(0.0, sub - done))
                self.metrics.gauge("predicted_load").set(predicted)
        return FleetSignals(
            queue_depth=depth, replicas=infos,
            burn_slow_max=burn,
            prefill_token_cost=(dis.prefill_token_cost
                                if dis is not None else 1.0),
            decode_token_cost=(dis.decode_token_cost
                               if dis is not None else 1.0),
            disaggregated=dis is not None,
            model_bounds=bounds,
            predicted_queue_depth=predicted)

    def set_proactive_brownout(self, fraction: Optional[float]) -> None:
        """Autoscaler brownout actuator: degrade (or restore, with
        ``None``) the admission queue's effective capacity fraction."""
        self.admission.set_proactive_fraction(fraction)

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
        # cross-process cancel (docs/SERVING.md "Multi-host serving"): a
        # local replica polls the flag between scheduler steps, but a
        # remote replica's worker reads ITS copy of the request — the flag
        # must cross the wire. No-op for local replicas (no notify_cancel
        # attribute).
        rep = (self.router.replica_by_id(req.replica_id)
               if req.replica_id is not None else None)
        notify = getattr(rep, "notify_cancel", None)
        if notify is not None:
            notify(req)

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
        if self._federation is not None:
            # distinct live peer frontends, both directions (adopted FROM +
            # connected TO this exporter) — identity-deduped so mutual
            # peering counts each peer once
            ids = {p.peer_id for p in self._federation_peers
                   if p.alive and p.peer_id}
            if self._federation_server is not None:
                ids |= self._federation_server.live_peer_ids()
            self.metrics.gauge("federation_peers").set(len(ids))
        # distinct remote journal sources currently held (0 on fleets with
        # no remote members — the gauge exists either way)
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
            # per-tenant fair-share/quota books; None = tenancy off
            "tenants": (self._tenancy.snapshot()
                        if self._tenancy is not None else None),
            "slo": (self.alerts.status() if self.alerts is not None
                    else None),
            "alerts_firing": (self.alerts.firing()
                              if self.alerts is not None else []),
            # what the autoscaler wants vs has, its action tally and cost
            # ledger; None on static fleets
            "autoscaler": (dict(self.autoscaler.stats(),
                                replicas_target=snap.get("replicas_target",
                                                         0.0),
                                brownout_proactive=bool(snap.get(
                                    "brownout_proactive_active", 0.0)))
                           if self.autoscaler is not None else None),
            "events": self.journal.events(limit=recent_events),
        }
        # fleet observability (docs/OBSERVABILITY.md "Fleet
        # observability"): per-remote-replica transport/clock/recency
        # status, federation peer books, and the FleetJournal's per-source
        # tallies. All empty/None on a purely local fleet — the report
        # shape is stable either way.
        report["remotes"] = [r.ops_status() for r in self.router.replicas
                             if hasattr(r, "ops_status")]
        fed = None
        if self._federation is not None:
            peers = []
            now = time.monotonic()
            for p in self._federation_peers:
                ages = [now - h._last_status_t
                        for h in p._handles.values() if h._last_status_t]
                peers.append({
                    "address": p.address,
                    "peer_id": p.peer_id,
                    "alive": p.alive,
                    "inflight": p.inflight(),
                    "exports_adopted": sum(
                        1 for rid in self._federated_refs
                        if self._federated_refs[rid].peer is p),
                    "last_status_age_s": min(ages) if ages else None})
            srv = self._federation_server
            fed = {
                "frontend_id": self._federation_id,
                "epoch": self._federation_epoch,
                "listen": srv.address if srv is not None else None,
                "peers": peers,
                "peers_live": sorted(srv.live_peer_ids()
                                     if srv is not None else []),
            }
        report["federation"] = fed
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
        for rem in r.get("remotes") or []:
            age = rem.get("last_status_age_s")
            lines.append(
                f"remote {rem['replica']} ({rem['source']}): "
                + ("up" if rem["connected"] else "DOWN")
                + f" rpc={rem['rpc_calls']}"
                f"@{rem['rpc_avg_s'] * 1e3:.1f}ms "
                f"clk={rem['clock_offset_s'] * 1e3:+.1f}ms "
                f"active={rem['active']} "
                + (f"status_age={age:.1f}s" if age is not None
                   else "status_age=-"))
        if r.get("federation") is not None:
            f = r["federation"]
            lines.append(
                f"federation {f['frontend_id']}: "
                f"peers_connected={len(f['peers_live'])} "
                f"adopted_from={sum(1 for p in f['peers'] if p['alive'])}"
                f"/{len(f['peers'])}")
            for p in f["peers"]:
                age = p.get("last_status_age_s")
                lines.append(
                    f"  peer {p['peer_id'] or p['address']}: "
                    + ("up" if p["alive"] else "DOWN")
                    + f" exports={p['exports_adopted']} "
                    f"seats_in_use={p['inflight']} "
                    + (f"status_age={age:.1f}s" if age is not None
                       else "status_age=-"))
        if r.get("tenants"):
            for name, t in sorted(r["tenants"].items()):
                lines.append(
                    f"tenant {name}: w={t['weight']:g} "
                    f"service={t['service']:.1f} "
                    f"window_tokens={t['window_tokens']:.0f}"
                    + (f"  THROTTLED({t['throttled']})"
                       if t["throttled"] else ""))
        for name, w in sorted(r["window"].items()):
            if w.get("count"):
                lines.append(
                    f"window[{window_s:.0f}s] {name}: n={w['count']} "
                    f"p50={w['p50'] * 1e3:.1f}ms p95={w['p95'] * 1e3:.1f}ms")
        if r["autoscaler"] is not None:
            a = r["autoscaler"]
            lines.append(
                f"autoscaler: target={a['replicas_target']:.0f} "
                f"ups={a['scale_ups']} downs={a['scale_downs']} "
                f"reroles={a['reroles']} "
                f"replica_s={a['replica_seconds']:.1f}"
                + ("  PROACTIVE-BROWNOUT" if a["brownout_proactive"]
                   else ""))
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
        """On-demand FLEET flight-recorder dump (docs/OBSERVABILITY.md
        "Fleet observability"): the local recorder dump (recent spans,
        open ones included, + metric snapshots, as raw JSON and Chrome
        ``trace_event`` JSON) plus one bounded ``dump`` RPC per remote
        replica, each written alongside as ``fleet_<source>_<pid>.json``.
        Returns ``{"json": path, "chrome_trace": path, "remotes": {source:
        path | None}}`` (``remotes`` only with remote members; ``None``
        marks a remote whose dump RPC failed — the local dump never blocks
        on a sick peer). Works with telemetry disabled too (metrics only;
        the span lists are empty)."""
        import json as _json

        self.recorder.snapshot_metrics()
        out = self.recorder.dump(dump_dir=dump_dir, reason="debug")
        d = self.recorder._resolve_dir(dump_dir)
        remotes: Dict[str, Optional[str]] = {}
        for rep in self.router.replicas:
            fn = getattr(rep, "pull_dump", None)
            if fn is None:
                continue
            dump = fn()
            src = (dump or {}).get("source") or getattr(
                rep, "_source", f"replica-{rep.replica_id}")
            if dump is None:
                remotes[str(src)] = None
                continue
            safe = str(src).replace("/", "_").replace(":", "_")
            path = os.path.join(d, f"fleet_{safe}_{dump.get('pid')}.json")
            with open(path, "w") as f:
                _json.dump(dump, f)
            remotes[str(src)] = path
        if remotes:
            out = dict(out, remotes=remotes)
            self.journal.emit("fleet_dump", sources=sorted(remotes), dir=d)
        return out

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
        if self.autoscaler is not None:
            # no membership changes may race the teardown below
            self.autoscaler.stop()
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
        # federation teardown LAST: in-flight federated mirrors on the
        # exported replicas were settled by the router stop above, and
        # closing the bootstrap connections is what signals peer_lost to
        # the adopters
        if self._federation_server is not None:
            self._federation_server.stop()
        for peer in self._federation_peers:
            peer.close()
        if self.net_chaos is not None:
            # uninstall only OUR injector: a test running two frontends
            # must not have the survivor's schedule torn down by the first
            # shutdown
            from .fabric import chaos as _net_chaos

            if _net_chaos.installed() is self.net_chaos:
                _net_chaos.uninstall()
