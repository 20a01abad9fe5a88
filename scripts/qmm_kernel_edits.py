#!/usr/bin/env python3
"""Edited copies of the quantized matmul's decode route, timed on one H100.

    python3 scripts/qmm_kernel_edits.py

Each variant replaces one piece of ``deepspeed_tpu_torch/ops/csrc/
quantized_matmul.cu`` (text that must occur there exactly once), built in a
temporary directory by ``flash_kernel_edits.build_copies`` (nothing enters
the checkout), and is timed against the checkout in turns (checkout,
variant, variant, checkout) with ``chip_smoke.time_ms`` at every decode
projection of MISTRAL_7B at M = 8 with int8 codes, and at K = 64, where a
call is all fixed cost; one PyTorch call on the dequantized bf16 weight is
timed beside them. The variants:

- a ring of 4 or 8 stages (the checkout's has 6);
- no code loads: the weight's copies read nothing (zero-filled), so what is
  left is the conversions, the products, the x and scale copies and the
  fixed cost;
- no products: the MMAs are removed, which leaves the conversions dead
  code, so what is left is the load path and the fixed cost.

The last two compute wrong results on purpose: they say where the time goes.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops import _build  # noqa: E402
from deepspeed_tpu_torch.ops import quantizer as qz  # noqa: E402
from flash_kernel_edits import build_copies, use  # noqa: E402

SOURCE = "quantized_matmul"
STAGES = "constexpr int kDecStages = 6;"
VARIANTS = {
    "4 stages": [(STAGES, "constexpr int kDecStages = 4;")],
    "8 stages": [(STAGES, "constexpr int kDecStages = 8;")],
    "no code loads": [("clive && k0 + crow + 4 * KW * u < kend ? 16 : 0);",
                       "0);")],
    "no products": [(
        "          mma_bf16(acc[4 * h + jj][mt], a, bh[h][mt][0], bh[h][mt][1]);\n"
        "          mma_bf16(acc[4 * h + jj][mt], a, bl[h][mt][0], bl[h][mt][1]);\n",
        "")],
}
SHAPES = [("w_in [4096, 14336]", 4096, 14336), ("w_out [14336, 4096]", 14336, 4096),
          ("wq/wo [4096, 4096]", 4096, 4096), ("wk/wv [4096, 1024]", 4096, 1024),
          ("lm_head [4096, 32000]", 4096, 32000), ("w_in at K = 64", 64, 14336),
          ("wq/wo at K = 64", 64, 4096)]


def main():
    cs.phase_device()
    base = _build.load(SOURCE)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator("cuda").manual_seed(3)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_copies(VARIANTS, Path(tmp), SOURCE)
        for label, K, N in SHAPES:
            q, s = qz.quantize_blockwise(
                torch.randn((K, N), generator=gen, device="cuda") * 0.02,
                block=128)
            x = torch.randn((8, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            w = qz._dequantize_torch(q, s, 128, torch.bfloat16)
            lib_ms = cs.time_ms(lambda: x @ w, flush)
            call = lambda: qz.quantized_matmul_cuda(  # noqa: E731
                x, q, s, 128, torch.bfloat16)
            row = []
            for vlabel, lib in libs.items():
                ms = []
                for which in (base, lib, lib, base):
                    use(which, SOURCE)
                    ms.append(cs.time_ms(call, flush))
                row.append(f"checkout {ms[0]:.4f}, {ms[3]:.4f} | {vlabel} "
                           f"{ms[1]:.4f}, {ms[2]:.4f}")
            use(base, SOURCE)
            print(f"[variants] {label} int8 M=8 (library {lib_ms:.4f} ms): "
                  + "; ".join(row), flush=True)
            del q, s, x, w


if __name__ == "__main__":
    main()
