"""Request-serving layer over ``inference/v2`` (FastGen-class).

Counterpart of ``deepspeed_tpu/serving`` (docs/SERVING.md): typed
submit/stream/cancel frontend, bounded SLO admission queue with load
shedding, a least-outstanding-tokens replica router with health/drain
states, thread-per-replica workers with a supervisor and deterministic
fault injection, streaming token delivery with prompt KV reclamation on
cancel, disaggregated prefill/decode with KV handoff, multi-tenant fair
share, prefix-affinity routing, the elastic autoscaler, the cross-process
serving fabric (``serving/fabric/``: replica servers, remote handles,
frontend federation, network chaos), and a serving metrics registry.

Light names import eagerly; ``ServingFrontend``/``Replica``/
``ReplicaRouter``/``ReplicaSupervisor``, the autoscaler's and the fabric's
handle/server names load lazily because they pull in the engine stack
(torch).
"""

from ..telemetry.journal import OpsJournal  # noqa: F401
from ..telemetry.slo import (AlertEngine, SLOClassTarget,  # noqa: F401
                             SLOConfig)
from ..telemetry.windowed import WindowedMetrics  # noqa: F401
from .config import (AdmissionConfig, AutoscalerConfig,  # noqa: F401
                     ClassPolicy, DisaggregationConfig, FabricConfig,
                     FaultsConfig,
                     FaultToleranceConfig, HandoffConfig, KVQuantConfig,
                     KVTierConfig, PreemptionConfig, PrefixCacheConfig,
                     ServingConfig, SpeculativeConfig, WeightQuantConfig)
from .faults import FaultInjector, InjectedFault  # noqa: F401
from .handoff import HandoffStager  # noqa: F401
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, serving_metrics)
from .queue import AdmissionQueue  # noqa: F401
from .request import (DoneEvent, FinishReason, Priority,  # noqa: F401
                      Rejected, RequestHandle, RequestState, ServingRequest,
                      TokenEvent)

_LAZY = {
    "FleetController": ("deepspeed_tpu_torch.serving.autoscaler",
                        "FleetController"),
    "FleetSignals": ("deepspeed_tpu_torch.serving.autoscaler",
                     "FleetSignals"),
    "ReplicaInfo": ("deepspeed_tpu_torch.serving.autoscaler", "ReplicaInfo"),
    "ServingFrontend": ("deepspeed_tpu_torch.serving.frontend", "ServingFrontend"),
    "Replica": ("deepspeed_tpu_torch.serving.replica", "Replica"),
    "ReplicaState": ("deepspeed_tpu_torch.serving.replica", "ReplicaState"),
    "ReplicaRouter": ("deepspeed_tpu_torch.serving.router", "ReplicaRouter"),
    "ReplicaSupervisor": ("deepspeed_tpu_torch.serving.supervisor",
                          "ReplicaSupervisor"),
    # cross-process serving fabric (docs/SERVING.md "Multi-host serving")
    "LocalHandle": ("deepspeed_tpu_torch.serving.fabric.handle",
                    "LocalHandle"),
    "RemoteHandle": ("deepspeed_tpu_torch.serving.fabric.remote",
                     "RemoteHandle"),
    "ReplicaServer": ("deepspeed_tpu_torch.serving.fabric.server",
                      "ReplicaServer"),
    "HANDLE_SURFACE": ("deepspeed_tpu_torch.serving.fabric.handle",
                       "HANDLE_SURFACE"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ServingConfig", "PrefixCacheConfig", "KVQuantConfig",
           "WeightQuantConfig", "KVTierConfig", "AdmissionConfig",
           "PreemptionConfig", "AutoscalerConfig", "FleetController",
           "FleetSignals", "ReplicaInfo", "SpeculativeConfig",
           "ClassPolicy", "DisaggregationConfig", "HandoffConfig",
           "HandoffStager", "FaultToleranceConfig", "FaultsConfig",
           "FaultInjector", "InjectedFault", "ReplicaSupervisor",
           "MetricsRegistry", "serving_metrics", "Counter", "Gauge",
           "Histogram", "AdmissionQueue", "Priority", "Rejected",
           "RequestHandle", "RequestState", "ServingRequest", "TokenEvent",
           "DoneEvent", "FinishReason", "ServingFrontend", "Replica",
           "ReplicaState", "ReplicaRouter", "SLOConfig", "SLOClassTarget",
           "AlertEngine", "OpsJournal", "WindowedMetrics", "FabricConfig",
           "LocalHandle", "RemoteHandle", "ReplicaServer", "HANDLE_SURFACE"]
