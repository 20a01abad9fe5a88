"""``telemetry: {...}`` config block (docs/OBSERVABILITY.md, docs/CONFIG.md).

Counterpart of ``deepspeed_tpu/telemetry/config.py``, on the port's
pydantic-free config base. Mounted on both
:class:`~deepspeed_tpu_torch.serving.config.ServingConfig` (request tracing
+ flight recorder) and
:class:`~deepspeed_tpu_torch.runtime.config.DeepSpeedTpuConfig` (training
step spans). Defaults to disabled — the no-op tracer — so nothing pays for
telemetry it didn't ask for.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..runtime.config_utils import DSConfigModel


@dataclass(init=False, eq=False, repr=False)
class TelemetryConfig(DSConfigModel):
    enabled: bool = False
    # completed-span ring capacity (the flight recorder's history window);
    # open spans are capped at the same number
    max_spans: int = 8192
    # metric-registry snapshots kept alongside the spans
    max_metric_snapshots: int = 32
    # write a flight-recorder dump when a replica/scheduler dies, at most
    # max_error_dumps per error_dump_window_s (sliding window)
    dump_on_error: bool = True
    max_error_dumps: int = 3
    error_dump_window_s: float = 3600.0
    # where dumps land (None = <tmpdir>/deepspeed_tpu_telemetry, the
    # JAX package's directory)
    dump_dir: Optional[str] = None
    # mirror context-manager spans into torch.profiler.record_function so
    # host spans line up with the device kernels in one profiler trace
    xla_annotations: bool = False

    def build_tracer(self):
        """The configured tracer — the shared NOOP singleton when
        disabled, so call sites hold one object either way."""
        from .tracer import NOOP_TRACER, Tracer

        if not self.enabled:
            return NOOP_TRACER
        return Tracer(enabled=True, max_spans=self.max_spans,
                      xla_annotations=self.xla_annotations)

    def build_recorder(self, tracer, metrics=None, role="frontend"):
        """Flight recorder over ``tracer``; ``metrics`` (an object with
        ``snapshot()``) is registered as the first snapshot provider.
        ``role`` lands in dump filenames so fleet processes sharing a
        dump dir never collide."""
        from .flight_recorder import FlightRecorder

        rec = FlightRecorder(tracer, max_snapshots=self.max_metric_snapshots,
                             dump_dir=self.dump_dir,
                             max_error_dumps=self.max_error_dumps,
                             error_dump_window_s=self.error_dump_window_s,
                             role=role)
        if metrics is not None:
            rec.add_metrics_provider("serving", metrics.snapshot)
        return rec
