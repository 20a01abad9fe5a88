"""Collective-op latency and bandwidth logging.

The port's copy of ``deepspeed_tpu/utils/comms_logging.py``: every
collective issued through :mod:`deepspeed_tpu_torch.comm` can be timed and
its algorithmic and bus bandwidth recorded (the NCCL-tests formulas), with a
summary table on demand. ``CommsLogger`` also counts ``host_staged_bytes``
and ``host_staged_s``: the bytes ``comm`` copied through host memory, and
the seconds of those copies, because the backend (gloo) was given CUDA
tensors.

The JAX module's ``analyze_compiled``/``format_compiled_comms`` read the
collectives out of a compiled XLA program; eager PyTorch compiles no
program, so they have no counterpart here (every collective passes through
``comm`` and is timed there).
"""

from __future__ import annotations

import math
from collections import defaultdict

from .logging import log_dist


def get_msg_size_from_args(*args, **kwargs) -> int:
    """Best-effort message size (bytes) from the first array-like argument."""
    for a in list(args) + list(kwargs.values()):
        if hasattr(a, "nbytes"):
            return int(a.nbytes)
        if hasattr(a, "numel") and hasattr(a, "element_size"):
            return int(a.numel()) * int(a.element_size())
        if hasattr(a, "size") and hasattr(a, "dtype") \
                and hasattr(a.dtype, "itemsize"):
            return int(a.size) * a.dtype.itemsize
    return 0


def calc_bw_log(comm_op: str, size_bytes: int, duration_s: float,
                n: int) -> tuple[float, float]:
    """Algorithmic and bus bandwidth in GB/s (NCCL-tests conventions)."""
    if duration_s <= 0:
        return 0.0, 0.0
    tput = size_bytes / duration_s
    if comm_op in ("all_to_all_single", "all_to_all"):
        busbw = tput * ((n - 1) / n) if n > 0 else tput
    elif comm_op in ("all_gather", "all_gather_into_tensor", "reduce_scatter",
                     "reduce_scatter_tensor"):
        size_bytes = size_bytes * n
        tput = size_bytes / duration_s
        busbw = tput * ((n - 1) / n) if n > 0 else tput
    elif comm_op == "all_reduce":
        busbw = tput * (2 * (n - 1) / n) if n > 0 else tput
    else:  # send/recv/broadcast/...
        busbw = tput
    return tput / 1e9, busbw / 1e9


class CommsLogger:
    """Per-op record of (count, latency, msg size, algbw, busbw) keyed by
    op name then message size."""

    def __init__(self, enabled: bool = False, verbose: bool = False,
                 prof_all: bool = True, debug: bool = False, prof_ops=None):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.debug = debug
        self.prof_ops = prof_ops or []
        self.comms_dict: dict = defaultdict(
            lambda: defaultdict(lambda: [0, [], [], []]))
        self.host_staged_bytes = 0
        self.host_staged_s = 0.0

    def configure(self, config) -> None:
        self.enabled = config.enabled
        self.verbose = config.verbose
        self.prof_all = config.prof_all
        self.debug = config.debug
        self.prof_ops = list(config.prof_ops)

    def reset(self) -> None:
        """Drop every record and the staged-byte count."""
        self.comms_dict.clear()
        self.host_staged_bytes = 0
        self.host_staged_s = 0.0

    def should_profile(self, op_name: str) -> bool:
        if not self.enabled:
            return False
        if self.prof_ops:
            return op_name in self.prof_ops
        return self.prof_all

    def append(self, raw_name: str, record_name: str, latency_s: float,
               msg_size: int, group_size: int) -> None:
        algbw, busbw = calc_bw_log(raw_name, msg_size, latency_s, group_size)
        entry = self.comms_dict[record_name][msg_size]
        entry[0] += 1
        entry[1].append(latency_s * 1000.0)
        entry[2].append(algbw)
        entry[3].append(busbw)
        if self.verbose:
            log_dist(
                f"comm op: {record_name} | time (ms): {latency_s*1000:.2f} | "
                f"msg size: {msg_size} | algbw (Gbps): {algbw*8:.2f} | "
                f"busbw (Gbps): {busbw*8:.2f}", ranks=[0])

    def log_all(self, print_log: bool = True,
                show_straggler: bool = False) -> dict:
        from .timer import trim_mean

        summary: dict = {}
        lines = [f"{'Comm. Op':<20}{'Message Size':<20}{'Count':<10}"
                 f"{'Total Latency(ms)':<20}{'Avg Latency(ms)':<20}"
                 f"{'tput_avg (Gbps)':<20}{'busbw_avg (Gbps)':<20}"]
        for record_name, sizes in self.comms_dict.items():
            lines.append(record_name)
            summary[record_name] = {}
            for size, (count, latencies, algbws, busbws) in sorted(
                    sizes.items()):
                avg_lat = trim_mean(latencies, 0.1)
                avg_alg = trim_mean(algbws, 0.1)
                avg_bus = trim_mean(busbws, 0.1)
                summary[record_name][size] = {
                    "count": count, "total_latency_ms": sum(latencies),
                    "avg_latency_ms": avg_lat, "algbw_gbps": avg_alg * 8,
                    "busbw_gbps": avg_bus * 8,
                }
                lines.append(f"{'':<20}{_fmt_size(size):<20}{count:<10}"
                             f"{sum(latencies):<20.2f}{avg_lat:<20.2f}"
                             f"{avg_alg*8:<20.2f}{avg_bus*8:<20.2f}")
        if print_log:
            log_dist("\n".join(lines), ranks=[0])
        return summary


def _fmt_size(num: int) -> str:
    if num == 0:
        return "0 B"
    units = ["B", "KB", "MB", "GB", "TB"]
    k = min(int(math.log(num, 1024)), len(units) - 1) if num >= 1 else 0
    return f"{num / 1024**k:.2f} {units[k]}"
