"""`serving: {...}` sub-config (see docs/CONFIG.md and docs/SERVING.md).

Counterpart of ``deepspeed_tpu/serving/config.py``: every block class with
the same keys, defaults and checks, on the port's pydantic-free
:class:`DSConfigModel` (dataclasses). Each pydantic ``field_validator`` and
``model_validator`` is an ``_after`` hook here that raises ``ValueError``
on the same inputs. Lives here (not runtime/config.py) so the serving layer
can be configured standalone; it is mounted on :class:`DeepSpeedTpuConfig`
as the ``serving`` block. Every block parses, so one config file drives
both packages, and every block's feature runs in the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..runtime.config_utils import DSConfigModel
from ..telemetry.config import TelemetryConfig
from ..telemetry.slo import SLOConfig


@dataclass(init=False, eq=False, repr=False)
class PrefixCacheConfig(DSConfigModel):
    """``prefix_cache: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "Prefix caching"): shared-prefix KV block reuse in the v2 ragged
    engine. Mounted on both :class:`ServingConfig` and
    ``DeepSpeedTpuConfig``."""

    enabled: bool = False
    # cap on hash-indexed blocks (0 = bounded only by the KV pool);
    # unreferenced cached blocks are evicted LRU past this, or whenever
    # an allocation would otherwise fail
    max_cached_blocks: int = 0

    def apply(self, engine_config) -> None:
        """Stamp these settings onto a ``RaggedInferenceEngineConfig``
        (the engine-factory hook for config-driven serving)."""
        engine_config.enable_prefix_cache = self.enabled
        engine_config.prefix_cache_max_blocks = (self.max_cached_blocks
                                                 or None)


@dataclass(init=False, eq=False, repr=False)
class KVQuantConfig(DSConfigModel):
    """``kv_quant: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "KV quantization"): int8 KV-cache quantization in the v2 ragged
    engine — pools stored as symmetric int8 with per-(layer, block,
    kv-head) scale planes, halving HBM bytes per block so a fixed byte
    budget serves ~2x the concurrent sequences. Mounted on both
    :class:`ServingConfig` and ``DeepSpeedTpuConfig``; disabled (the
    default) keeps the bf16/fp32 pools byte for byte."""

    enabled: bool = False
    # quantized representation: "int8" (uniform codes) or
    # "fp8_e4m3" (float8 payload on the reserved dtype surface — same
    # pool/scale machinery and byte cut, floating relative precision;
    # inference/v2/kv_quant.py validates)
    dtype: str = "int8"
    # scale granularity; only "block" (per layer x block x kv-head) is
    # implemented — the granularity low-bit paths need to stay accurate
    # (PAPERS.md: arxiv 2506.17615)
    scale_granularity: str = "block"

    def apply(self, engine_config) -> None:
        """Stamp these settings onto a ``RaggedInferenceEngineConfig``
        (the engine-factory hook for config-driven serving)."""
        engine_config.kv_quant_enabled = self.enabled
        engine_config.kv_quant_dtype = self.dtype
        engine_config.kv_quant_scale_granularity = self.scale_granularity


@dataclass(init=False, eq=False, repr=False)
class WeightQuantConfig(DSConfigModel):
    """``weight_quant: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "Weight quantization"): int8/fp8 *weight* serving for the v2 ragged
    engine — the CausalLM param tree is quantized once at engine build
    (``inference/v2/weight_quant.py``, blockwise f32 scales stored
    alongside), and every matmul runs straight from the quantized tree:
    ~3.9x fewer resident param bytes vs fp32 (more replicas per host)
    and the per-step HBM weight stream cut with it — the lever on
    memory-bound decode. Mounted on both :class:`ServingConfig` and
    ``DeepSpeedTpuConfig``; disabled (the default) keeps the
    full-precision param tree byte for byte."""

    enabled: bool = False
    # quantized representation: "int8" or "fp8_e4m3"
    # (inference/v2/weight_quant.py validates)
    dtype: str = "int8"
    # quant-group width along each weight's output dim (clamped per
    # leaf to the largest divisor of the — per-TP-shard — width)
    block: int = 128
    # leaf/subtree names excluded from quantization. Embeddings and
    # norms never quantize regardless (they are not dense matmuls);
    # listing "lm_head" keeps the unembed full-precision, and any
    # whitelist name ("wq", "w_out", ...) prunes that projection.
    skip: List[str] = field(default_factory=lambda: ["embed", "final_norm"])

    def apply(self, engine_config) -> None:
        """Stamp these settings onto a ``RaggedInferenceEngineConfig``
        (the engine-factory hook for config-driven serving)."""
        engine_config.weight_quant_enabled = self.enabled
        engine_config.weight_quant_dtype = self.dtype
        engine_config.weight_quant_block = self.block
        engine_config.weight_quant_skip = list(self.skip)


@dataclass(init=False, eq=False, repr=False)
class KVTierConfig(DSConfigModel):
    """``kv_tier: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "KV tiering"): host-RAM (and optional disk) spillover for evicted
    prefix-cache KV blocks with async restore on a later prefix match —
    the ZeRO-Infinity memory-tier treatment applied to the serving KV
    cache (PAPERS.md: arxiv 2104.07857, 2101.06840). Requires
    ``prefix_cache.enabled`` (spill/restore ride its eviction/match
    paths). Under ``kv_quant`` the spilled bytes are the int8 slabs +
    scale entries, so spill bandwidth rides the 4x compression. Mounted
    on both :class:`ServingConfig` and ``DeepSpeedTpuConfig``; disabled
    (the default) keeps the drop-on-evict prefix cache byte for byte."""

    enabled: bool = False
    # host-RAM tier byte bound; LRU entries past it demote to the disk
    # tier (when configured) or drop
    host_max_bytes: int = 64 * 1024 * 1024
    # optional disk tier (runtime/swap_tensor AsyncTensorSwapper): one
    # CRC-checked file per spilled block under disk_path, bounded by
    # disk_max_bytes (both must be set for the tier to exist; a corrupt
    # file reads back as a miss — re-prefill, never a crash)
    disk_path: Optional[str] = None
    disk_max_bytes: int = 0

    def apply(self, engine_config) -> None:
        """Stamp these settings onto a ``RaggedInferenceEngineConfig``
        (the engine-factory hook for config-driven serving)."""
        engine_config.kv_tier_enabled = self.enabled
        engine_config.kv_tier_host_bytes = self.host_max_bytes
        engine_config.kv_tier_disk_path = self.disk_path
        engine_config.kv_tier_disk_bytes = self.disk_max_bytes


@dataclass(init=False, eq=False, repr=False)
class PreemptionConfig(DSConfigModel):
    """``admission.preemption`` block (docs/SERVING.md "Admission and
    preemption"): under reservation shortfall the scheduler spills a
    victim sequence's KV through ``export_sequence`` into the
    ``TieredKVStore`` (host RAM when no tier is configured), frees its
    device blocks, and resumes it later via import +
    ``submit_prefilled`` — byte-lossless greedy continuation."""

    enabled: bool = False
    # victim selection: "lowest_class" (lowest urgency class first, then
    # most blocks, then least progress), "most_blocks", "least_progress"
    victim_policy: str = "lowest_class"
    # starvation cap: a sequence spilled this many times becomes immune
    max_preemptions_per_seq: int = 2


@dataclass(init=False, eq=False, repr=False)
class AdmissionConfig(DSConfigModel):
    """``admission: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "Admission and preemption"): total-block reservation admission for
    the v2 scheduler — a sequence's whole projected KV need (prompt +
    max_new_tokens, prefix-cache hits credited) is reserved before its
    first prefill chunk, so N concurrent partial prefills can never
    exhaust the pool with none able to finish (the chunked-admission
    deadlock becomes structurally impossible) — plus preemptive KV
    spill for safe oversubscription. Mounted on both
    :class:`ServingConfig` and ``DeepSpeedTpuConfig``; all-default (the
    default) keeps chunk-by-chunk admission byte for byte."""

    reservation: bool = False
    # total committed blocks (resident reservations + preempted parked
    # sequences) may reach this multiple of the device pool; > 1.0 is
    # what enables preemptive admission — at 1.0 preemption only repairs
    # handoff-import over-commitments
    oversubscription_factor: float = 1.0
    preemption: PreemptionConfig = field(default_factory=PreemptionConfig)

    def _after(self):
        # every preemption entry point lives on the reservation branch
        # of the scheduler's packing pass — accepting this combination
        # would silently serve the old admission with zero preemptions
        if self.preemption.enabled and not self.reservation:
            raise ValueError(
                "admission.preemption.enabled requires "
                "admission.reservation: preemption is triggered by "
                "reservation shortfall (set reservation: true)")
        return self

    @property
    def active(self) -> bool:
        return self.reservation or self.preemption.enabled

    def apply(self, engine_config) -> None:
        """Stamp these settings onto a ``RaggedInferenceEngineConfig``
        (the engine-factory hook for config-driven serving)."""
        engine_config.admission_reservation = self.reservation
        engine_config.admission_oversubscription_factor = \
            self.oversubscription_factor
        engine_config.admission_preemption_enabled = self.preemption.enabled
        engine_config.admission_victim_policy = self.preemption.victim_policy
        engine_config.admission_max_preemptions_per_seq = \
            self.preemption.max_preemptions_per_seq


@dataclass(init=False, eq=False, repr=False)
class SpeculativeConfig(DSConfigModel):
    """``speculative: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "Speculative decoding"): greedy-lossless speculative decoding in the
    v2 ragged engine. Mounted on both :class:`ServingConfig` and
    ``DeepSpeedTpuConfig``; ``ServingFrontend`` applies it per replica
    (each replica gets its own proposer — draft state is per-engine)."""

    enabled: bool = False
    mode: str = "ngram"                 # "ngram" | "draft_model"
    max_draft_tokens: int = 4           # K: drafts verified per forward
    ngram_max: int = 3                  # longest suffix n-gram to look up
    # HF checkpoint path for mode="draft_model" (models/convert.py); the
    # draft must share the target's tokenizer family
    draft_model: Optional[str] = None

    def build_proposer(self, draft_engine_factory=None):
        """Construct the configured proposer (one per replica/scheduler),
        or ``None`` when disabled. ``draft_engine_factory()`` overrides
        checkpoint loading for mode="draft_model" — the programmatic path
        (tests, pre-built draft engines)."""
        if not self.enabled:
            return None
        from ..inference.v2.spec import DraftModelProposer, NGramProposer

        if self.mode == "ngram":
            return NGramProposer(ngram_max=self.ngram_max)
        if self.mode == "draft_model":
            if draft_engine_factory is not None:
                return DraftModelProposer(draft_engine_factory())
            if not self.draft_model:
                raise ValueError(
                    "speculative.mode='draft_model' needs draft_model "
                    "(checkpoint path) or a draft_engine_factory")
            from ..inference.v2.engine_v2 import InferenceEngineV2

            return DraftModelProposer(
                InferenceEngineV2(checkpoint_path=self.draft_model))
        raise ValueError(f"unknown speculative.mode {self.mode!r} "
                         "(expected 'ngram' or 'draft_model')")


@dataclass(init=False, eq=False, repr=False)
class ClassPolicy(DSConfigModel):
    """One entry of the ``classes: {...}`` map (docs/CONFIG.md,
    docs/SERVING.md "Disaggregated serving"): per-request-class SLO
    defaults. ``submit(request_class=...)`` resolves priority/deadline
    from the class when the caller passes neither; ``shed_rank`` orders
    brownout victim selection — HIGHER ranks shed first (batch before
    interactive), ties falling back to (priority, deadline, FIFO)."""

    priority: Optional[int] = None       # None → ServingConfig.default_priority
    deadline_ms: Optional[float] = None  # None → default_deadline_ms
    shed_rank: int = 0


@dataclass(init=False, eq=False, repr=False)
class HandoffConfig(DSConfigModel):
    """``disaggregation.handoff`` block: KV block handoff from
    prefill-role to decode-role replicas through a host-RAM staging
    buffer (serving/handoff.py). Disabled is only legal with no
    prefill-role replicas — a prefill-only replica with nowhere to send
    its KV could never finish a request."""

    enabled: bool = True
    # staged exports held in host RAM at once; a full buffer degrades
    # that handoff to the recompute fallback (the request re-prefills on
    # a decode-capable replica) instead of blocking the prefill replica
    max_staged: int = 8
    # block-granularity streamed handoff (docs/SERVING.md "Multi-host
    # serving"): export payloads carry per-chunk slab groups of this
    # many KV blocks instead of one whole-prompt slab — every chunk's
    # device->host copy is dispatched before any materializes
    # (overlapped copies; the staged payload is host RAM, never pinned
    # HBM), and over the fabric each chunk rides its own wire frame so
    # a long-context transfer overlaps with ongoing decode. 0 (the
    # default) keeps the whole-payload export byte for byte.
    chunk_blocks: int = 0


@dataclass(init=False, eq=False, repr=False)
class DisaggregationConfig(DSConfigModel):
    """``disaggregation: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "Disaggregated serving"): split the replica pool into prefill-heavy
    / decode-heavy / mixed roles with KV handoff between them. Prefill
    replicas run prompt-chunk-only steps and export each finished
    prompt's KV blocks; decode replicas import them and generate, with
    ``decode_reserve_tokens`` of every step's token budget held back
    from prompt chunks so queued prompts can never inflate decode TPOT.
    Disabled (the default) keeps the single-role scheduler and the
    unweighted least-outstanding-tokens router byte for byte."""

    enabled: bool = False
    # per-replica roles ("prefill" | "decode" | "mixed"), indexed by
    # replica id; [] = every replica mixed. When given, the length must
    # match the fleet size and at least one replica must be
    # decode-capable (decode/mixed) — the frontend validates.
    roles: List[str] = field(default_factory=list)
    # decode-role schedulers hold back this many tokens of each step's
    # ragged budget from prompt chunks (size it below
    # max_ragged_batch_size - max_chunk_tokens; progress is guaranteed
    # regardless — at least one prompt token always schedules)
    decode_reserve_tokens: int = 0
    # router cost model: a pending prefill token costs far less wall
    # clock than an owed decode token (one chunked forward vs one
    # forward EACH), so the two are weighted separately — the fix for
    # "2000 prompt tokens == 2000 decode steps" herding interactive
    # traffic onto prefill-loaded replicas
    prefill_token_cost: float = 1.0
    decode_token_cost: float = 8.0
    handoff: HandoffConfig = field(default_factory=HandoffConfig)

    def role_of(self, replica_id: int) -> str:
        if not self.enabled or replica_id >= len(self.roles):
            return "mixed"
        return self.roles[replica_id]


@dataclass(init=False, eq=False, repr=False)
class AutoscalerConfig(DSConfigModel):
    """``autoscaler: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "Elastic autoscaling"): the SLO-driven fleet controller that grows,
    shrinks, and re-roles the replica pool on the router's ~1/s tick.
    Three actuators: (1) grow/shrink between ``min_replicas`` and
    ``max_replicas`` from the frontend's ``engine_factory``, with
    per-direction cooldowns and consecutive-tick hysteresis so the pool
    never flaps; (2) re-role prefill<->decode as the traffic mix shifts
    (role-split fleets only — drain is cheap because staged handoff +
    kv_tier keep KV portable); (3) proactive brownout on slow-window
    error-budget burn BEFORE the fast+slow alert fires. Disabled (the
    default) builds no controller — byte-for-byte the static-fleet
    stack. Enabling requires an ``engine_factory`` (the frontend
    validates at construction: a fleet that cannot build engines cannot
    grow)."""

    enabled: bool = False
    # fleet-size bounds. min_replicas >= 1 by validation: all-replicas-
    # removed is impossible by construction, and the router
    # independently refuses to empty its list.
    min_replicas: int = 1
    max_replicas: int = 4
    # grow when queued work per accepting replica exceeds this for
    # up_stable_ticks consecutive ticks (and the up cooldown passed)
    scale_up_queue_per_replica: float = 4.0
    # shrink when queue depth per accepting replica is at/below this AND
    # outstanding tokens per accepting replica are at/below
    # scale_down_tokens_per_replica, for down_stable_ticks consecutive
    # ticks (and the down cooldown passed)
    scale_down_queue_per_replica: float = 0.25
    scale_down_tokens_per_replica: float = 8.0
    # hysteresis: consecutive qualifying ticks required per direction
    # (scaling down on a single idle tick would flap a bursty fleet)
    up_stable_ticks: int = 2
    down_stable_ticks: int = 5
    # per-direction cooldowns from the LAST membership change in either
    # direction (growth must not immediately un-do a shrink and vice
    # versa); up reacts faster than down by default
    scale_up_cooldown_s: float = 5.0
    scale_down_cooldown_s: float = 30.0
    # decision cadence on the router tick (cadence-gated like the other
    # tick hooks)
    tick_interval_s: float = 1.0
    # re-role (role-split fleets only): flip one replica's role when the
    # weighted phase-load imbalance (prefill vs decode outstanding
    # tokens, weighted by the disaggregation cost model) exceeds
    # rerole_ratio for rerole_stable_ticks consecutive ticks, with its
    # own cooldown — the flap suppressor for oscillating traffic mixes
    rerole_ratio: float = 4.0
    rerole_stable_ticks: int = 5
    rerole_cooldown_s: float = 30.0
    # proactive brownout: when any SLO rule's SLOW-window burn rate
    # reaches brownout_burn_threshold (in error-budget multiples — set
    # it below slo.burn_rate_threshold to act before the alert), feed
    # brownout_fraction into the admission queue's effective capacity;
    # deactivate once the slow burn halves. 0 disables the actuator.
    brownout_burn_threshold: float = 2.0
    brownout_fraction: float = 0.5

    def _after(self):
        if self.min_replicas < 1:
            raise ValueError(
                "autoscaler.min_replicas must be >= 1 — a fleet scaled "
                "to zero replicas could never serve (all-replicas-"
                "removed must be impossible by construction)")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"autoscaler.max_replicas ({self.max_replicas}) must be "
                f">= min_replicas ({self.min_replicas})")
        if not (0.0 < self.brownout_fraction <= 1.0):
            raise ValueError(
                "autoscaler.brownout_fraction must be in (0, 1] — 0 "
                "would shed the whole queue, above 1 does nothing")
        for name in ("up_stable_ticks", "down_stable_ticks",
                     "rerole_stable_ticks"):
            if getattr(self, name) < 1:
                raise ValueError(f"autoscaler.{name} must be >= 1")
        return self


@dataclass(init=False, eq=False, repr=False)
class AffinityConfig(DSConfigModel):
    """``affinity: {...}`` block (docs/CONFIG.md, docs/SERVING.md "Fleet
    KV locality"): fleet-wide KV placement. Four coupled pieces: (1)
    every replica advertises a bounded **prefix digest** (chain hashes
    of its prefix index + host/disk tier contents — local replicas
    polled on the router's ~1/s tick, remote ones on the fabric status
    stream, no new RPC); (2) the router scores digest overlap into the
    pick as a prefill-token **credit** so shared-prefix traffic herds
    to warm replicas, with a per-replica **share cap** so herding can
    never re-create the hot-replica pile-up the split cost model fixed;
    (3) the autoscaler's grow path **warms up** a new replica's prefix
    cache from a donor before it enters the rotation; (4) scaling goes
    **predictive** — the controller grows on the windowed submit-rate
    trend before the watermark trips. Disabled (the default) builds
    none of it: pick path, status stream, grow path and watermark
    decisions are byte-for-byte the historical stack."""

    enabled: bool = False
    # bounded digest size per replica (chain hashes). The digest is
    # advisory: truncation only costs credit accuracy, never correctness
    digest_max_entries: int = 512
    # credit weight: predicted prefill tokens saved are subtracted from
    # the pick's load term times this (and times the disaggregation
    # prefill_token_cost, so credits and loads stay in one currency)
    credit_weight: float = 1.0
    # share cap: a replica already holding >= max_share of the last
    # share_window affinity-steered picks gets zero credit for the pick
    max_share: float = 0.5
    share_window: int = 32
    # local-digest poll cadence on the router tick (remote digests
    # refresh at the fabric status cadence regardless)
    refresh_interval_s: float = 1.0
    # grow-path warm-up: pre-populate a new replica's prefix cache with
    # up to warmup_max_blocks of a donor's hottest blocks before it
    # starts accepting; a warm-up that exceeds the timeout (or fails)
    # degrades to the historical cold start, never fails the grow
    warmup_enabled: bool = True
    warmup_timeout_s: float = 5.0
    warmup_max_blocks: int = 64
    # predictive scaling: project queue depth predict_horizon_s ahead
    # from the submit/completion rate trend over predict_window_s of
    # windowed metrics; the projection can only ADD a grow trigger —
    # shrink stays on the actual watermarks
    predictive: bool = True
    predict_horizon_s: float = 10.0
    predict_window_s: float = 30.0

    def _after(self):
        if self.digest_max_entries < 1:
            raise ValueError("affinity.digest_max_entries must be >= 1")
        if not (0.0 < self.max_share <= 1.0):
            raise ValueError(
                "affinity.max_share must be in (0, 1] — 0 would cap "
                "every replica, above 1 never caps")
        if self.share_window < 1:
            raise ValueError("affinity.share_window must be >= 1")
        if self.credit_weight < 0.0:
            raise ValueError("affinity.credit_weight must be >= 0")
        if self.warmup_max_blocks < 0:
            raise ValueError("affinity.warmup_max_blocks must be >= 0")
        for name in ("refresh_interval_s", "warmup_timeout_s",
                     "predict_horizon_s", "predict_window_s"):
            if getattr(self, name) <= 0.0:
                raise ValueError(f"affinity.{name} must be > 0")
        return self


@dataclass(init=False, eq=False, repr=False)
class FederationConfig(DSConfigModel):
    """``fabric.federation: {...}`` block (docs/CONFIG.md,
    docs/SERVING.md "Frontend federation"): the two-tier serving fleet.
    With ``enabled``, a frontend EXPORTS a slice of its local replica
    pool on ``fabric.listen`` (a :class:`FederationServer`) and ADOPTS
    the exports of every frontend in ``peers`` as routable federated
    replicas — a shared replica pool across edge frontends, with
    cross-frontend failover (peer death = the requeue/resume path,
    lossless under greedy decoding) and evacuation onto peers.
    Disabled (the default) builds none of it — byte for byte the
    single-frontend stack."""

    enabled: bool = False
    # peer FRONTEND federation addresses ("host:port" — each peer's
    # fabric.listen) whose exported replicas this frontend adopts
    peers: List[str] = field(default_factory=list)
    # stable identity for self-peering/loop refusal; "" derives one
    # from host + pid at frontend construction. Two frontends must
    # never share an id — a hello carrying the server's own id is
    # refused ("self_peering"), and a lower epoch for a known id is
    # refused ("stale_epoch") so a restarted frontend's stale twin
    # cannot shadow it.
    frontend_id: str = ""
    # how many local replicas to export to peers (0 = all local
    # replicas; federated/remote members are NEVER re-exported — that
    # is the loop refusal's structural half)
    export_max_replicas: int = 0
    # per-peer cap on in-flight federated requests this frontend may
    # hold against ONE peer (0 = bounded only by the exported
    # replicas' seat counts) — the capacity-accounting knob that keeps
    # an edge frontend from soaking a peer's whole pool
    peer_max_inflight: int = 0
    # partition-tolerant seat leases (docs/SERVING.md "Frontend
    # federation"): an export channel whose adopter has been silent this
    # long has its lease expired — the exporter cancels that channel's
    # mirrored requests and the borrowed seats return to local traffic
    # (the adopter's transport-loss failover already reclaimed the
    # streams on ITS side of the partition). 0 (the default) disables
    # the sweep: leases last as long as the TCP connection.
    lease_timeout_s: float = 0.0

    def _after(self):
        if self.lease_timeout_s < 0:
            raise ValueError(
                "fabric.federation.lease_timeout_s must be >= 0")
        if self.enabled:
            for addr in self.peers:
                host, sep, port = str(addr).rpartition(":")
                if not sep or not host or not port.isdigit():
                    raise ValueError(
                        f"fabric.federation.peers entry {addr!r} is "
                        "not host:port")
            if self.export_max_replicas < 0:
                raise ValueError(
                    "fabric.federation.export_max_replicas must be >= 0")
            if self.peer_max_inflight < 0:
                raise ValueError(
                    "fabric.federation.peer_max_inflight must be >= 0")
        return self


@dataclass(init=False, eq=False, repr=False)
class QuarantineConfig(DSConfigModel):
    """``fabric.quarantine: {...}`` block (docs/CONFIG.md,
    docs/SERVING.md "Fleet fault tolerance"): gray-failure quarantine
    for remote replicas. A handle whose rolling RPC window shows too
    many slow calls or deadline misses leaves the routable set
    (QUARANTINED — in-flight streams continue, no fresh work) and probe
    RPCs on exponential backoff re-admit it once latency recovers;
    repeated quarantines inside ``escalate_window_s`` escalate to the
    ordinary DEAD/failover path. Disabled (the default) never scores:
    byte-for-byte the liveness-only health model."""

    enabled: bool = False
    # an RPC slower than this is a bad sample (deadline misses always
    # are)
    rpc_slow_s: float = 1.0
    # rolling sample window (count) and how many samples must exist
    # before a verdict
    window: int = 32
    min_samples: int = 8
    # fraction of the window that must be bad to quarantine
    slow_fraction: float = 0.5
    # probe cadence while quarantined: exponential from probe_backoff_s
    # up to probe_backoff_max_s; a probe answered under rpc_slow_s
    # re-admits
    probe_backoff_s: float = 0.5
    probe_backoff_max_s: float = 8.0
    # escalation: this many quarantines inside the window = the replica
    # is not gray, it is failing — take the DEAD/failover path
    escalate_quarantines: int = 3
    escalate_window_s: float = 120.0

    def _after(self):
        if self.enabled:
            if self.rpc_slow_s <= 0:
                raise ValueError("fabric.quarantine.rpc_slow_s must be > 0")
            if self.window < 1 or self.min_samples < 1:
                raise ValueError("fabric.quarantine.window and "
                                 "min_samples must be >= 1")
            if not 0.0 < self.slow_fraction <= 1.0:
                raise ValueError("fabric.quarantine.slow_fraction must be "
                                 "in (0, 1]")
            if self.probe_backoff_s <= 0 \
                    or self.probe_backoff_max_s < self.probe_backoff_s:
                raise ValueError(
                    "fabric.quarantine.probe_backoff_s must be > 0 and "
                    "<= probe_backoff_max_s")
            if self.escalate_quarantines < 1 or self.escalate_window_s <= 0:
                raise ValueError(
                    "fabric.quarantine.escalate_quarantines must be >= 1 "
                    "and escalate_window_s > 0")
        return self


@dataclass(init=False, eq=False, repr=False)
class FabricConfig(DSConfigModel):
    """``fabric: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "Multi-host serving"): the cross-process serving fabric. With
    ``enabled`` and a ``peers`` list, the frontend adopts each peer —
    a replica server process (``python -m
    deepspeed_tpu_torch.scripts.serve_replica``) hosting an engine — as a
    :class:`~deepspeed_tpu_torch.serving.fabric.remote.RemoteHandle` replica:
    routing, KV handoff, kv_tier restore, preemption resume and
    autoscaler evacuation all work across the process boundary, and a
    dead connection is handled exactly like a dead replica thread
    (failover + supervisor restart/reconnect). Disabled (the default)
    builds only in-process replicas — byte for byte the single-process
    stack."""

    enabled: bool = False
    # this process's server bind address when IT serves replicas
    # (host:port; port 0 = ephemeral). The ADVERTISED address rides
    # ``comm._routable_ip`` for wildcard/loopback binds — never
    # 127.0.0.1 when a route exists (fabric/transport.advertised_address)
    listen: str = "127.0.0.1:0"
    # replica server addresses ("host:port") this frontend adopts as
    # remote replicas, ids allocated after the local engines
    peers: List[str] = field(default_factory=list)
    # client ping cadence; a peer silent for max(10s, 3 heartbeats) is
    # presumed dead (transport-loss failover fires). The 10s floor
    # keeps a peer stalled in a first-use kernel build from reading as
    # dead — a CLOSED socket is detected instantly regardless
    heartbeat_s: float = 1.0
    # per-RPC deadline (hello/assign/evacuate)
    rpc_timeout_s: float = 30.0
    # hard bound on one wire frame; an oversized KV payload degrades to
    # the re-prefill fallback (typed FrameTooLarge, never a crash)
    max_frame_bytes: int = 64 * 1024 * 1024
    # CRC32 frame sealing (codec v2): advertise ``crc_frames`` in every
    # hello; when BOTH ends advertise, each wire frame carries a CRC32
    # trailer and bit damage becomes a typed single-frame refusal
    # (rpc_frames_corrupt) instead of a connection-killing decode
    # error. False pins the historical v1 wire shape byte for byte
    # (old peers get it either way — sealing is negotiated, never
    # assumed).
    frame_crc: bool = True
    # gray-failure quarantine for remote replicas (docs/SERVING.md
    # "Fleet fault tolerance"). Disabled = liveness-only health.
    quarantine: QuarantineConfig = field(default_factory=QuarantineConfig)
    # frontend federation (docs/SERVING.md "Frontend federation"):
    # export local replicas on ``listen`` / adopt peer frontends'
    # exports. Disabled = the single-frontend fabric, byte for byte.
    federation: FederationConfig = field(default_factory=FederationConfig)

    def _after(self):
        if self.federation.enabled and not self.enabled:
            raise ValueError("fabric.federation.enabled requires "
                             "fabric.enabled — federation rides the "
                             "fabric transport")
        if self.enabled:
            if self.heartbeat_s <= 0:
                raise ValueError("fabric.heartbeat_s must be > 0 — the "
                                 "heartbeat is the transport-loss signal")
            if self.rpc_timeout_s <= 0:
                raise ValueError("fabric.rpc_timeout_s must be > 0")
            if self.max_frame_bytes < 1 << 16:
                raise ValueError("fabric.max_frame_bytes must be at least "
                                 "64 KiB — RPC envelopes must always fit")
            for addr in self.peers:
                host, sep, port = str(addr).rpartition(":")
                if not sep or not host or not port.isdigit():
                    raise ValueError(f"fabric.peers entry {addr!r} is not "
                                     "host:port")
        return self


@dataclass(init=False, eq=False, repr=False)
class FaultToleranceConfig(DSConfigModel):
    """``fault_tolerance: {...}`` block (docs/CONFIG.md, docs/SERVING.md
    "Fault tolerance"): replica supervision (restart DEAD replicas with
    exponential backoff + a circuit breaker), transparent request
    failover (re-enqueue a dead replica's work, resume from prompt +
    delivered tokens — lossless under greedy decoding), and admission
    brownout under degraded capacity. Disabled (the default) keeps the
    historical fail-terminal behavior byte for byte."""

    enabled: bool = False
    # failover: extra replica assignments a request may take after its
    # first (attempts <= max_retries + 1); deadline/cancel always win
    max_retries: int = 2
    # restart backoff: base * 2^(crashes_in_window - 1), capped, with
    # deterministic seeded jitter so a fleet doesn't restart in lockstep
    restart_backoff_s: float = 0.5
    restart_backoff_max_s: float = 30.0
    restart_backoff_jitter: float = 0.2
    seed: int = 0
    # circuit breaker: this many crashes inside the window parks the
    # replica slot — no further restarts, capacity_alarm raised
    max_restarts_in_window: int = 3
    restart_window_s: float = 300.0
    supervisor_poll_s: float = 0.05
    # brownout: healthy-capacity fraction below which the admission
    # queue shrinks and sheds lowest-urgency work first (0 = disabled)
    brownout_threshold: float = 0.0


@dataclass(init=False, eq=False, repr=False)
class ObservabilityConfig(DSConfigModel):
    """``observability: {...}`` fleet ops surface (docs/OBSERVABILITY.md
    "Fleet observability"): a stdlib ``http.server`` scrape endpoint on
    the frontend serving ``/metrics`` (Prometheus text), ``/health``
    (the fleet health report as JSON), ``/trace`` (the merged
    cross-process Chrome trace), and ``/dump`` (the fleet debug dump) —
    the surface ``python -m deepspeed_tpu_torch.scripts.fleetctl`` drives. Disabled (the default)
    binds nothing and builds nothing: byte-for-byte the endpoint-less
    stack."""

    enabled: bool = False
    # host:port to bind; port 0 picks a free port (the frontend
    # publishes the resolved address as ``observability_address`` and
    # journals it as ``obs_listen``)
    listen: str = "127.0.0.1:0"


@dataclass(init=False, eq=False, repr=False)
class FaultsConfig(DSConfigModel):
    """``faults: {...}`` TEST-ONLY deterministic fault injection
    (docs/CONFIG.md, serving/faults.py): a seeded schedule of replica
    crashes, wedges, ``engine.put`` errors, and slow-forward latency,
    driving the chaos suite (tests/test_fault_tolerance.py) and
    ``bench.py``'s chaos phase. Disabled = no engine proxying, no hooks
    — byte-for-byte the uninstrumented serving stack."""

    enabled: bool = False
    seed: int = 0
    # entries: {"kind": "crash"|"wedge"|"put_error"|"slow_forward",
    #           "replica": i, "at_step": k | "at_put": n |
    #           "at_step_range": [lo, hi] (seeded draw),
    #           "duration_s": t, "count": c (0 = every time)}
    schedule: List[Dict[str, Any]] = field(default_factory=list)

    def build_injector(self):
        """The configured :class:`~deepspeed_tpu_torch.serving.faults.
        FaultInjector`, or ``None`` when disabled."""
        if not self.enabled:
            return None
        from .faults import FaultInjector

        return FaultInjector(self.schedule, seed=self.seed)


@dataclass(init=False, eq=False, repr=False)
class ChaosConfig(DSConfigModel):
    """``chaos: {...}`` TEST-ONLY deterministic NETWORK fault injection
    (docs/CONFIG.md, serving/fabric/chaos.py) — the wire-level sibling
    of ``faults:``: a seeded schedule of per-link latency, bandwidth
    throttle, connection drops, blackholes, partitions, duplicate/
    reordered deliveries and frame bit-corruption, interposed between
    the fabric transport and its socket. Drives the net_chaos bench
    phase and the transport edge-case suite. Disabled = the injector is
    never installed: zero interposition, byte-for-byte the
    uninstrumented transport (asserted in tests)."""

    enabled: bool = False
    seed: int = 0
    # entries: {"kind": "latency"|"throttle"|"drop_conn"|"blackhole"|
    #                   "partition"|"duplicate"|"reorder"|"corrupt",
    #           "link": fnmatch pattern over connection names
    #                   (e.g. "fabric-r0", "federation-peer-*"),
    #           "dir": "tx"|"rx"|"both" (per-kind default),
    #           "at_frame": k | "at_frame_range": [lo, hi] (seeded),
    #           "duration_s": t, "count": c (0 = every match),
    #           "delay_s"/"jitter_s", "bytes_per_s", "partial_bytes",
    #           "where": "header"|"payload", "flip_bits": n}
    schedule: List[Dict[str, Any]] = field(default_factory=list)

    def build_injector(self):
        """The configured :class:`~deepspeed_tpu_torch.serving.fabric.chaos.
        NetworkFaultInjector`, or ``None`` when disabled."""
        if not self.enabled:
            return None
        from .fabric.chaos import NetworkFaultInjector

        return NetworkFaultInjector(self.schedule, seed=self.seed)


@dataclass(init=False, eq=False, repr=False)
class ModelSpec(DSConfigModel):
    """One entry of the ``models: {...}`` registry (docs/CONFIG.md,
    docs/SERVING.md "Multi-model & multi-tenant serving"): a named model
    family the frontend serves as its own replica pool. ``model`` /
    ``engine`` / ``seed`` / ``checkpoint`` mirror the
    ``serve_replica`` spec exactly — the same dict describes
    the model whether the pool is built in-process or adopted from a
    replica server, which is what makes cross-process parity testable.
    Programmatic callers (tests) may instead hand the frontend an
    ``engine_factories[name]`` callable, which wins over ``model``."""

    # TransformerConfig / RaggedInferenceEngineConfig kwargs (the
    # serve_replica.py spec shape); {} model means an engine_factories
    # entry MUST be supplied for this name
    model: Dict[str, Any] = field(default_factory=dict)
    engine: Dict[str, Any] = field(default_factory=dict)
    # params = model.init(PRNGKey(seed)) unless checkpoint is given
    seed: int = 0
    # runtime checkpoint dir (runtime/checkpointing.py layout: a tag dir
    # or a save_dir with a ``latest`` pointer); overrides seeded init
    checkpoint: Optional[str] = None
    # local in-process pool size for this model
    replicas: int = 1
    # fabric peer addresses ("host:port") serving THIS model — adopted
    # as RemoteHandle replicas of this pool (fabric.enabled required;
    # the hello exchange verifies the peer really hosts this model_id)
    peers: List[str] = field(default_factory=list)
    # per-pool autoscaler bounds; None inherits the global
    # autoscaler.min_replicas / max_replicas
    min_replicas: Optional[int] = None
    max_replicas: Optional[int] = None

    def _after(self):
        if self.replicas < 0:
            raise ValueError("models.<name>.replicas must be >= 0")
        if self.replicas == 0 and not self.peers:
            raise ValueError(
                "models.<name> needs replicas >= 1 or a peers list — a "
                "pool with no members could never serve its model")
        lo = self.min_replicas
        hi = self.max_replicas
        if lo is not None and lo < 1:
            raise ValueError("models.<name>.min_replicas must be >= 1")
        if lo is not None and hi is not None and hi < lo:
            raise ValueError(
                f"models.<name>.max_replicas ({hi}) must be >= "
                f"min_replicas ({lo})")
        for addr in self.peers:
            host, sep, port = str(addr).rpartition(":")
            if not sep or not host or not port.isdigit():
                raise ValueError(
                    f"models.<name>.peers entry {addr!r} is not host:port")
        return self


@dataclass(init=False, eq=False, repr=False)
class TenantPolicy(DSConfigModel):
    """One entry of the ``tenants: {...}`` map (docs/CONFIG.md,
    docs/SERVING.md "Multi-model & multi-tenant serving"): per-tenant
    fair-share weight and quotas, enforced by
    :class:`~deepspeed_tpu_torch.serving.tenancy.TenantLedger`. A non-empty
    map turns tenancy ON: deficit-weighted-fair ordering across tenants
    in the admission queue, sliding-window token-rate throttling, and a
    per-engine KV block budget riding the reservation ledger. The
    ``default`` tenant is always merged in (the stock-classes idiom), so
    ``submit()`` callers that never name a tenant keep working."""

    # fair-share weight: a tenant with weight 2.0 drains twice the
    # tokens of a weight-1.0 tenant under contention (must be > 0)
    weight: float = 1.0
    # sustained admission rate cap in tokens/s over the sliding window
    # (prompt + max_new_tokens charged at pop); 0 = unlimited. Over-rate
    # tenants are deprioritized (served only when no in-quota tenant has
    # work) and become first-choice brownout/preemption victims.
    token_rate: float = 0.0
    # KV block budget per engine for this tenant's resident requests;
    # 0 = unlimited. Enforced at dispatch via the admission reservation
    # ledger's block math (engine kv_block_size).
    kv_block_budget: int = 0

    def _after(self):
        if self.weight <= 0:
            raise ValueError(
                "tenants.<name>.weight must be > 0 — a zero-weight "
                "tenant would never be scheduled under contention")
        if self.token_rate < 0:
            raise ValueError("tenants.<name>.token_rate must be >= 0")
        if self.kv_block_budget < 0:
            raise ValueError("tenants.<name>.kv_block_budget must be >= 0")
        return self


@dataclass(init=False, eq=False, repr=False)
class ServingConfig(DSConfigModel):
    """Queue bounds, SLO defaults, replica fleet shape, shed policy."""

    enabled: bool = False
    # admission
    max_queue_depth: int = 256          # beyond this, submit() sheds
    shed_policy: str = "reject"         # "reject" | "block" (block = legacy
    #                                     unbounded-latency behavior; submit
    #                                     waits for room instead of shedding)
    default_priority: int = 1           # Priority.NORMAL
    default_deadline_ms: Optional[float] = None   # None = no SLO deadline
    default_max_new_tokens: int = 64
    # request classes (docs/SERVING.md "Disaggregated serving"):
    # submit(request_class=...) resolves per-class priority/deadline
    # defaults and the brownout shed order from here. The stock map:
    # interactive (the default class — ServingConfig defaults, shed
    # last) and batch (Priority.LOW, shed first under brownout). A
    # user-supplied map is MERGED over the stock entries (validator
    # below), so adding a custom class never silently deletes the
    # defaults ``default_class`` points at.
    classes: Dict[str, ClassPolicy] = field(default_factory=lambda: {
        "interactive": ClassPolicy(),
        "batch": ClassPolicy(priority=2, shed_rank=1)})
    default_class: str = "interactive"
    # multi-model registry (docs/SERVING.md "Multi-model & multi-tenant
    # serving"): named model families, each its own replica pool behind
    # ONE frontend/queue/router; the router routes by request model_id.
    # Empty (the default) = the historical single-model fleet byte for
    # byte (every replica and request is model "default").
    models: Dict[str, ModelSpec] = field(default_factory=dict)
    # submit() model when the caller names none; None resolves to
    # "default" with no registry, else the first registered model name
    # in sorted order (deterministic)
    default_model: Optional[str] = None
    # multi-tenant fair share + quotas (serving/tenancy.py): a non-empty
    # map enables deficit-weighted-fair admission ordering across
    # tenants, token-rate throttling, and per-engine KV block budgets.
    # Empty (the default) = tenancy off — the pure class-ordered heap
    # byte for byte. The "default" tenant is merged in whenever the map
    # is non-empty (the stock-classes idiom).
    tenants: Dict[str, TenantPolicy] = field(default_factory=dict)

    def _after(self):
        # the stock classes merge under a user map; a non-empty tenants
        # map always has the "default" tenant
        self.classes.setdefault("interactive", ClassPolicy())
        self.classes.setdefault("batch", ClassPolicy(priority=2, shed_rank=1))
        if self.tenants:
            self.tenants.setdefault("default", TenantPolicy())
        if self.default_model is not None and self.models \
                and self.default_model not in self.models:
            raise ValueError(
                f"serving.default_model {self.default_model!r} is not in "
                f"the models registry {sorted(self.models)}")
        return self

    def resolve_default_model(self) -> str:
        """The model_id ``submit()`` uses when the caller names none."""
        if self.default_model is not None:
            return self.default_model
        return sorted(self.models)[0] if self.models else "default"
    # replicas
    num_replicas: int = 1               # fleet size (from_engine_factory)
    # a busy replica with no completed iteration for this long is DEAD.
    # Must exceed the worst-case first-use kernel build (a route or dtype
    # first met mid-service builds then, not just at warm-up) — see
    # docs/SERVING.md.
    wedge_timeout_s: float = 300.0
    drain_timeout_s: float = 30.0       # shutdown(drain=True) budget
    # metrics
    ttft_buckets_s: List[float] = field(default_factory=list)  # [] = default
    # prefix-cache KV block reuse (engine-level; ``from_engine_factory``
    # callers apply it via ``PrefixCacheConfig.apply``)
    prefix_cache: PrefixCacheConfig = field(default_factory=PrefixCacheConfig)
    # int8/fp8 KV-cache quantization (engine-level; ``ServingFrontend``
    # applies it per replica engine before traffic)
    kv_quant: KVQuantConfig = field(default_factory=KVQuantConfig)
    # int8/fp8 weight serving (engine-level; ``ServingFrontend``
    # applies it per replica engine — first, before any traffic — on
    # every build path: boot, supervisor restart, autoscaler grow)
    weight_quant: WeightQuantConfig = field(default_factory=WeightQuantConfig)
    # tiered KV memory (engine-level; requires prefix_cache.enabled):
    # spill evicted prefix-cache blocks to host RAM/disk, restore on
    # match (docs/SERVING.md "KV tiering")
    kv_tier: KVTierConfig = field(default_factory=KVTierConfig)
    # admission overhaul (scheduler-level; docs/SERVING.md "Admission
    # and preemption"): total-block reservation admission + preemptive
    # KV spill for safe oversubscription; all-default = the historical
    # chunk-by-chunk admission byte for byte
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    # speculative decoding (scheduler-level; applied per replica)
    speculative: SpeculativeConfig = field(default_factory=SpeculativeConfig)
    # unified telemetry: request tracing + flight recorder
    # (docs/OBSERVABILITY.md); disabled = the no-op tracer
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    # SLO observability (docs/OBSERVABILITY.md "SLOs and burn-rate
    # alerts"): per-class SLO targets + multi-window burn-rate alerting
    # evaluated on the router tick. Disabled (the default) builds no
    # alert engine; windowed metrics and the ops journal exist either
    # way (passive, bounded).
    slo: SLOConfig = field(default_factory=SLOConfig)
    # disaggregated prefill/decode serving: role-split replica pool with
    # KV handoff and the weighted router cost model (docs/SERVING.md
    # "Disaggregated serving"); disabled = the single-role stack
    disaggregation: DisaggregationConfig = field(
        default_factory=DisaggregationConfig)
    # replica supervision + request failover + brownout
    # (docs/SERVING.md "Fault tolerance"); disabled = historical behavior
    fault_tolerance: FaultToleranceConfig = field(
        default_factory=FaultToleranceConfig)
    # SLO-driven elastic fleet autoscaling (docs/SERVING.md "Elastic
    # autoscaling"): grow/shrink/re-role the replica pool + proactive
    # brownout; disabled = the static fleet byte for byte
    autoscaler: AutoscalerConfig = field(default_factory=AutoscalerConfig)
    # fleet-wide KV locality (docs/SERVING.md "Fleet KV locality"):
    # prefix-affinity routing + grow-path warm-up + predictive scaling;
    # disabled = cache-blind routing and watermark scaling byte for byte
    affinity: AffinityConfig = field(default_factory=AffinityConfig)
    # cross-process serving fabric (docs/SERVING.md "Multi-host
    # serving"): adopt replica server processes as RemoteHandle
    # replicas; disabled = the in-process stack byte for byte
    fabric: FabricConfig = field(default_factory=FabricConfig)
    # fleet ops surface (docs/OBSERVABILITY.md "Fleet observability"):
    # /metrics, /health, /trace, /dump over stdlib http.server;
    # disabled = no listener, byte-for-byte the endpoint-less stack
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    # test-only deterministic fault injection (chaos suite / bench chaos
    # phase); disabled = no injection hooks anywhere on the hot path
    faults: FaultsConfig = field(default_factory=FaultsConfig)
    # test-only deterministic NETWORK fault injection (net_chaos bench
    # phase / transport edge-case suite); disabled = the injector is
    # never installed — zero transport interposition
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
