"""Telemetry of the port, counterpart of ``deepspeed_tpu/telemetry``: the
tracing core, the flight recorder, the config block, the ops journal,
windowed metrics and SLO burn-rate alerting (docs/OBSERVABILITY.md).

- **request tracing**: every serving request carries a span chain
  queue→route→admit→prefill→decode→finish (``serving/``,
  ``inference/v2/scheduler.py``);
- **step profiling**: training ``fwd_bwd`` and ``optimizer_step`` spans
  on the ``"train"`` trace (``runtime/engine.py``);
- **flight recorder**: a bounded ring of recent spans and metric
  snapshots, dumped as raw JSON and Chrome ``trace_event`` JSON on demand
  and on replica errors;
- **SLO observability**: sliding-window quantiles and rates over the
  cumulative metrics (``windowed.py``), per-class burn-rate alerting
  (``slo.py``) and the ops event journal (``journal.py``) behind
  ``ServingFrontend.health_report()``.

Pure stdlib apart from the optional ``torch.profiler.record_function``
mirror of the tracer.
"""

from .config import TelemetryConfig  # noqa: F401
from .flight_recorder import FlightRecorder  # noqa: F401
from .tracer import (NOOP_SPAN, NOOP_TRACER, Span, Tracer,  # noqa: F401
                     chrome_trace, trace_coverage, validate_chrome_trace)
from .journal import (EVENT_SCHEMAS, OpsJournal,  # noqa: F401
                      validate_event, validate_events)
from .windowed import WindowedMetrics  # noqa: F401
from .slo import (AlertEngine, AlertRule, SLOClassTarget,  # noqa: F401
                  SLOConfig)

__all__ = ["Tracer", "Span", "NOOP_TRACER", "NOOP_SPAN", "TelemetryConfig",
           "FlightRecorder", "chrome_trace", "validate_chrome_trace",
           "trace_coverage", "OpsJournal", "EVENT_SCHEMAS",
           "validate_event", "validate_events", "WindowedMetrics",
           "AlertEngine", "AlertRule", "SLOClassTarget", "SLOConfig"]
