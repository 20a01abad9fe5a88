"""Telemetry of the port: the tracing core (counterpart of the
``deepspeed_tpu/telemetry`` tracer; the flight recorder, metrics windows,
SLO alerts and the ops journal are not ported yet)."""

from .tracer import (NOOP_SPAN, NOOP_TRACER, Span, Tracer,  # noqa: F401
                     chrome_trace, trace_coverage, validate_chrome_trace)

__all__ = ["Tracer", "Span", "NOOP_TRACER", "NOOP_SPAN", "chrome_trace",
           "validate_chrome_trace", "trace_coverage"]
