#!/usr/bin/env python3
"""Edited copies of the port's flash attention kernels, on one H100.

    python3 scripts/flash_kernel_edits.py faults     # every planted fault must be refused
    python3 scripts/flash_kernel_edits.py variants   # variants timed against the checkout

Each edit replaces one piece of ``deepspeed_tpu_torch/ops/csrc/
flash_attention.cu`` (text that must occur there exactly once); the edited
copies are written and built with nvcc (the flags of ``_build``) in a
temporary directory, so nothing broken enters the checkout, and are loaded
in place of the checkout's library by swapping ``_build._libs``.

``faults`` runs ``chip_smoke.check_flash`` with each broken copy over every
bf16 case of ``chip_smoke.FLASH_CASES`` that takes the wgmma route and
prints, for each case, whether the check refused it and with what message
(the measure and how many times its limit it missed by); it fails unless
every fault is refused by at least one case. ``variants`` times the
forward, dq (with its delta pre-pass, as the timing phase does) and dkv at
the training shape and at B = 4, T = S = 2048 causal with ``chip_smoke.
time_ms``, checkout and variant in turns: checkout, variant, variant,
checkout.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops import _build  # noqa: E402
from deepspeed_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCE = "flash_attention"

FAULTS = {
    "dq skips each warpgroup's last live K/V tile": [(
        "    if (!wg_live || j0 >= wcol_hi || j0 + kBwdCols <= wcol_lo) continue;",
        "    if (!wg_live || j0 + kBwdCols >= wcol_hi || j0 + kBwdCols <= wcol_lo) "
        "continue;")],
    "dkv skips the last query head of its group": [(
        "  const int n_tiles = G * per_head;",
        "  const int n_tiles = (G - 1) * per_head;")],
}

VARIANTS = {
    "3-stage ring (dq and dkv)": [(
        "constexpr int kBwdStages = 2;", "constexpr int kBwdStages = 3;")],
}


def build_copies(edits: dict, tmp: Path, source: str = SOURCE) -> dict:
    """One library of ``csrc/<source>.cu`` per entry of ``edits``, compiled
    in parallel."""
    nvcc = _build.find_nvcc()
    procs = {}
    for i, (label, pairs) in enumerate(edits.items()):
        src_dir = tmp / f"src{i}"
        src_dir.mkdir()
        for p in _build.CSRC.iterdir():
            if p.suffix in (".cu", ".cuh"):
                (src_dir / p.name).write_text(p.read_text())
        src = src_dir / f"{source}.cu"
        text = src.read_text()
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{label}: {old!r} occurs {text.count(old)} "
                                   "times, not once")
            text = text.replace(old, new)
        src.write_text(text)
        out = tmp / f"lib{i}.so"
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-I",
               str(src_dir), "-o", str(out), str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        out)
    libs = {}
    for label, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{label}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.ds_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ds_cuda_error_string.restype = ctypes.c_char_p
        libs[label] = lib
    return libs


def use(lib, source: str = SOURCE):
    _build._libs[source] = lib


def run_faults(base, libs):
    gen = torch.Generator("cuda").manual_seed(13)
    cases = [c for c in cs.FLASH_CASES + [cs.FLASH_TRAIN_CASE]
             if fa.flash_route(torch.bfloat16, c[6], c[9]) == "wgmma"]
    missed = []
    for label, lib in libs.items():
        use(lib)
        refused = 0
        for case in cases:
            try:
                cs.check_flash(*case, torch.bfloat16, gen)
                print(f"[faults] {label}: {case[0]}: passed", flush=True)
            except AssertionError as e:
                refused += 1
                print(f"[faults] {label}: {case[0]}: REFUSED: {e}", flush=True)
        print(f"[faults] {label}: refused by {refused} of {len(cases)} cases",
              flush=True)
        if not refused:
            missed.append(label)
    use(base)
    if missed:
        raise SystemExit(f"faults not refused: {missed}")


def run_variants(base, libs):
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator("cuda").manual_seed(3)
    mk = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
    for label, B, T, window in (("B=1 T=S=8192 window 4096 (training)", 1,
                                 8192, 4096),
                                ("B=4 T=S=2048 causal", 4, 2048, 4096)):
        q, k, v, do = mk(B, T, 32, 128), mk(B, T, 8, 128), mk(B, T, 8, 128), \
            mk(B, T, 32, 128)
        o, lse = fa.flash_fwd_cuda(q, k, v, True, window)
        delta = fa.flash_delta_cuda(o, do)
        calls = {
            "fwd": lambda: fa.flash_fwd_cuda(q, k, v, True, window),
            "dq": lambda: fa.flash_dq_cuda(q, k, v, do, lse,
                                           fa.flash_delta_cuda(o, do), True,
                                           window),
            "dkv": lambda: fa.flash_dkv_cuda(q, k, v, do, lse, delta, True,
                                             window)}
        for vlabel, lib in libs.items():
            for key, fn in calls.items():
                ms = []
                for which in (base, lib, lib, base):
                    use(which)
                    ms.append(cs.time_ms(fn, flush, iters=5, warmup=1))
                print(f"[variants] {label} {key}: checkout {ms[0]:.4f}, "
                      f"{ms[3]:.4f} | {vlabel} {ms[1]:.4f}, {ms[2]:.4f} ms",
                      flush=True)
        use(base)
        del q, k, v, do, o, lse, delta


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode not in ("faults", "variants"):
        raise SystemExit(__doc__)
    cs.phase_device()
    base = _build.load(SOURCE)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_copies(FAULTS if mode == "faults" else VARIANTS,
                            Path(tmp))
        if mode == "faults":
            run_faults(base, libs)
        else:
            run_variants(base, libs)


if __name__ == "__main__":
    main()
