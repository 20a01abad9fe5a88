"""Wall-clock timer tree and throughput accounting.

Counterpart of ``deepspeed_tpu/utils/timer.py`` (``SynchronizedWallClockTimer``,
``ThroughputTimer``). A timer brackets device work with a ``sync_fn``; the
engine passes ``torch.cuda.synchronize`` when it runs on the card, so the
host wall clock measures real device time.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


class _Timer:
    def __init__(self, name: str, sync_fn=None):
        self.name = name
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0
        self._record: list[float] = []
        # default device-sync, inherited from the owning registry; an
        # explicit start/stop sync_fn overrides per call
        self._sync_fn = sync_fn

    def start(self, sync_fn=None) -> None:
        if self.started:
            return
        sync_fn = sync_fn if sync_fn is not None else self._sync_fn
        if sync_fn is not None:
            sync_fn()
        self._start = time.perf_counter()
        self.started = True

    def stop(self, record: bool = False, sync_fn=None) -> None:
        if not self.started:
            return
        sync_fn = sync_fn if sync_fn is not None else self._sync_fn
        if sync_fn is not None:
            sync_fn()
        delta = time.perf_counter() - self._start
        self._elapsed += delta
        if record:
            self._record.append(delta)
        self.started = False

    def reset(self) -> None:
        self.started = False
        self._elapsed = 0.0

    def elapsed(self, reset: bool = True) -> float:
        """Elapsed seconds since last reset (stops/restarts a running timer)."""
        was_started = self.started
        if was_started:
            self.stop()
        value = self._elapsed
        if reset:
            self.reset()
        if was_started:
            self.start()
        return value

    def mean(self) -> float:
        return (sum(self._record) / len(self._record)) if self._record else 0.0


class SynchronizedWallClockTimer:
    """Named-timer registry, by name."""

    def __init__(self, sync_fn=None):
        self.timers: "OrderedDict[str, _Timer]" = OrderedDict()
        self._sync_fn = sync_fn

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            # timers inherit the registry's device sync so start/stop
            # bracket real device work, not async dispatch
            self.timers[name] = _Timer(name, sync_fn=self._sync_fn)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    def log(self, names: list[str], normalizer: float = 1.0, reset: bool = True, ranks=None) -> dict:
        assert normalizer > 0.0
        means = {}
        for name in names:
            if name in self.timers:
                means[name] = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
        string = "time (ms) | " + " | ".join(f"{k}: {v:.2f}" for k, v in means.items())
        log_dist(string, ranks=ranks or [0])
        return means


class ThroughputTimer:
    """Samples/sec + TFLOPS estimate."""

    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50,
                 monitor_memory: bool = False, logging_fn=None):
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self.initialized = False
        self.global_steps = 0
        self.total_elapsed = 0.0
        self._start = 0.0
        self.flops_per_sample: float | None = None
        # last device-memory reading (bytes), when monitor_memory is on
        self.memory_bytes: int | None = None

    def device_memory_bytes(self) -> int | None:
        """Bytes the caching allocator holds in live tensors on the current
        CUDA device; None without CUDA. Sampled at report steps only."""
        import torch

        if not torch.cuda.is_available():
            return None
        return int(torch.cuda.memory_allocated())

    def start(self) -> None:
        self._start = time.perf_counter()
        self.initialized = True

    def stop(self, global_step: bool = True, report_speed: bool = True) -> None:
        if not self.initialized:
            return
        duration = time.perf_counter() - self._start
        if global_step:
            self.global_steps += 1
            if self.global_steps >= self.start_step:
                self.total_elapsed += duration
            if report_speed and self.steps_per_output and self.global_steps % self.steps_per_output == 0:
                mem = ""
                if self.monitor_memory:
                    self.memory_bytes = self.device_memory_bytes()
                    if self.memory_bytes is not None:
                        mem = (f", device_mem="
                               f"{self.memory_bytes / 2**30:.3f}GiB"
                               " (allocated)")
                self.logging(
                    f"step={self.global_steps}, samples/sec={self.avg_samples_per_sec():.2f}"
                    + (f", TFLOPS={self.tflops():.2f}" if self.flops_per_sample else "")
                    + mem)

    def avg_samples_per_sec(self) -> float:
        steps = max(1, self.global_steps - self.start_step + 1)
        if self.total_elapsed == 0.0:
            return 0.0
        return self.batch_size / (self.total_elapsed / steps)

    def tflops(self) -> float:
        if not self.flops_per_sample:
            return 0.0
        return self.avg_samples_per_sec() * self.flops_per_sample / 1e12


def trim_mean(data: list[float], trim_fraction: float = 0.1) -> float:
    if not data:
        return 0.0
    data = sorted(data)
    k = int(len(data) * trim_fraction)
    trimmed = data[k: len(data) - k] or data
    return sum(trimmed) / len(trimmed)
