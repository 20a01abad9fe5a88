#!/usr/bin/env python3
"""The host beside one CUDA card, as ZeRO-Offload sees it.

    python3 scripts/host_probe.py

Prints the host's memory (``/proc/meminfo``), its cores, the card's name
and power limit, the free disk under ``build/``, and four rates measured
here: copies between the card and pageable and page-locked host memory
(1 GiB each way, 3 times), a 2 GiB numpy write with ``fsync`` and its read
back (from the page cache), one numpy add over 1 GiB arrays, and the time
to touch 4 GiB of fresh zeros. ZeRO-Offload's step moves its gradients
and masters across the first, keeps its moments in the second when they
go to NVMe, and runs its host optimizer at the rate the third bounds.
Needs a card; writes only a temporary directory under ``build/``, which
it removes.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BUILD = Path(__file__).resolve().parents[1] / "build"


def main():
    if not torch.cuda.is_available():
        raise SystemExit("host_probe: CUDA is not available")
    with open("/proc/meminfo") as fh:
        print("meminfo:", " | ".join(fh.read().splitlines()[:3]))
    print("cores:", os.cpu_count(), "affinity", len(os.sched_getaffinity(0)))
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    BUILD.mkdir(exist_ok=True)
    print(f"disk: {shutil.disk_usage(BUILD).free / 1e9:.1f} GB free under "
          f"build/")
    n = 1 << 28                                     # 1 GiB of fp32
    dev = torch.empty(n, device="cuda")
    for pinned in (False, True):
        host = torch.empty(n, pin_memory=pinned)
        host.fill_(1.0)
        for direction in ("to host", "to card"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(3):
                (host.copy_(dev) if direction == "to host"
                 else dev.copy_(host))
            torch.cuda.synchronize()
            rate = 3 * 4 * n / (time.perf_counter() - t) / 1e9
            print(f"copy {direction}, {'page-locked' if pinned else 'pageable'}"
                  f": {rate:.1f} GB/s")
    a = np.ones(n, np.float32)
    b = np.ones_like(a)
    t = time.perf_counter()
    for _ in range(3):
        np.add(a, b, out=a)
    print(f"numpy add (3 streams): "
          f"{3 * 3 * a.nbytes / (time.perf_counter() - t) / 1e9:.1f} GB/s")
    t = time.perf_counter()
    zeros = np.zeros(4 * n, np.float32)
    zeros += 1
    print(f"touch 4 GiB of fresh zeros: {time.perf_counter() - t:.2f} s")
    del zeros
    root = tempfile.mkdtemp(dir=BUILD)
    try:
        arr = np.random.default_rng(0).standard_normal(2 * n,
                                                       dtype=np.float32)
        t = time.perf_counter()
        with open(os.path.join(root, "x"), "wb") as fh:
            arr.tofile(fh)
            fh.flush()
            os.fsync(fh.fileno())
        print(f"write + fsync {arr.nbytes / 2**30:.1f} GiB: "
              f"{arr.nbytes / (time.perf_counter() - t) / 1e9:.2f} GB/s")
        t = time.perf_counter()
        back = np.fromfile(os.path.join(root, "x"), np.float32)
        print(f"read back (page cache): "
              f"{back.nbytes / (time.perf_counter() - t) / 1e9:.2f} GB/s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
