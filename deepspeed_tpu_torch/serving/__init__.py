"""Request-serving layer over ``inference/v2`` (FastGen-class).

Counterpart of ``deepspeed_tpu/serving`` (docs/SERVING.md): typed
submit/stream/cancel frontend, bounded SLO admission queue with load
shedding, a least-outstanding-tokens replica router with health/drain
states, thread-per-replica workers with a supervisor and deterministic
fault injection, streaming token delivery with prompt KV reclamation on
cancel, and a serving metrics registry.

Light names import eagerly; ``ServingFrontend``/``Replica``/
``ReplicaRouter``/``ReplicaSupervisor`` load lazily because they pull in
the engine stack (torch). The autoscaler and the cross-process fabric are
not ported yet: their names raise ``NotImplementedError`` naming the
ROADMAP item on access.
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
    "ServingFrontend": ("deepspeed_tpu_torch.serving.frontend", "ServingFrontend"),
    "Replica": ("deepspeed_tpu_torch.serving.replica", "Replica"),
    "ReplicaState": ("deepspeed_tpu_torch.serving.replica", "ReplicaState"),
    "ReplicaRouter": ("deepspeed_tpu_torch.serving.router", "ReplicaRouter"),
    "ReplicaSupervisor": ("deepspeed_tpu_torch.serving.supervisor",
                          "ReplicaSupervisor"),
}

# names of the JAX package's serving layer whose modules are not ported
_NOT_PORTED = {
    "FleetController": ("the elastic autoscaler (serving/autoscaler.py)",
                        "queue 1 item 10b"),
    "FleetSignals": ("the elastic autoscaler (serving/autoscaler.py)",
                     "queue 1 item 10b"),
    "ReplicaInfo": ("the elastic autoscaler (serving/autoscaler.py)",
                    "queue 1 item 10b"),
    "LocalHandle": ("the serving fabric (serving/fabric/)", "queue 1 item 11"),
    "RemoteHandle": ("the serving fabric (serving/fabric/)",
                     "queue 1 item 11"),
    "ReplicaServer": ("the serving fabric (serving/fabric/)",
                      "queue 1 item 11"),
    "HANDLE_SURFACE": ("the serving fabric (serving/fabric/)",
                       "queue 1 item 11"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    if name in _NOT_PORTED:
        from .. import not_ported

        raise not_ported(*_NOT_PORTED[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ServingConfig", "PrefixCacheConfig", "KVQuantConfig",
           "WeightQuantConfig", "KVTierConfig", "AdmissionConfig",
           "PreemptionConfig", "AutoscalerConfig", "SpeculativeConfig",
           "ClassPolicy", "DisaggregationConfig", "HandoffConfig",
           "HandoffStager", "FaultToleranceConfig", "FaultsConfig",
           "FaultInjector", "InjectedFault", "ReplicaSupervisor",
           "MetricsRegistry", "serving_metrics", "Counter", "Gauge",
           "Histogram", "AdmissionQueue", "Priority", "Rejected",
           "RequestHandle", "RequestState", "ServingRequest", "TokenEvent",
           "DoneEvent", "FinishReason", "ServingFrontend", "Replica",
           "ReplicaState", "ReplicaRouter", "SLOConfig", "SLOClassTarget",
           "AlertEngine", "OpsJournal", "WindowedMetrics", "FabricConfig"]
