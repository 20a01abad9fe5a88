#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

    python3 chip_smoke.py            # one NVIDIA H100; exits non-zero on any failure

Phases, each of which raises on failure (nothing is caught):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every kernel of the port with nvcc (sm_90a) from the
             sources in this checkout, one nvcc per source, in parallel.
3. kernel  — hold each kernel against its plain PyTorch version on the card:
             the paged attention (bf16 and fp32, and int8 and fp8 pools:
             decode and prefill chunks, G = 1 and 4, D = 64 and 128,
             negative table entries, padded rows, ALiBi, a window smaller
             than the context) on valid rows; the blockwise quantizer bit
             for bit (bits 8 and 4, fp8, bf16 and fp32 input, ragged tails,
             rows not a multiple of 8, an all-zero group); the quantized
             matmul (int8 and fp8, x bf16 and fp32, M = 1, 8, 37 and 2048
             at the serving widths, ragged last groups).
4. timing  — each kernel at the serving path's shapes beside its bound, its
             plain version and, where there is one, one PyTorch library call.
5. main    — the serving path at full MISTRAL_7B width (32 layers, bf16,
             random weights from a seeded torch.Generator): greedy
             generation of 32 tokens for 8 requests through
             InferenceEngineV2 and the Dynamic SplitFuse scheduler. Checks
             token counts, finite logits, one paged-kernel launch per layer
             and put, that every block comes back, that one prefill and one
             decode step agree with the plain attention, and that small fp32
             models (dense, and int8 and fp8 weights and KV, tied and
             untied) give the same greedy streams on the card as on the CPU.
6. quant   — the same path with int8 weights (block 128) and int8 KV: the
             bf16 tree is quantized at the engine build (8 quantize
             launches) and dropped; 225 quantized-matmul and 32 paged
             launches per put; the steps held against the plain versions;
             then fp8 weights and fp8 KV on three of the prompts.

The last lines are one ``{"kernels": [...]}`` JSON object, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.

``--profile`` adds a torch.profiler trace of two puts of the bf16 and of the
int8 main path (the breakdowns in PERF.md section 5). ``--quick`` stops
after the kernel phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import subprocess
import time

import numpy as np
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import quantizer as qz

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores
# Tolerances of the paged kernel against its plain version, |k - ref| <=
# atol + rtol * |ref| on valid rows. bf16: both write a bf16 output (one
# rounding of 2^-8 relative each) and the plain version also rounds p to
# bf16 before p @ V (another 2^-8 relative), and with quantized pools the
# dequantized K and V to bf16 (the kernel keeps them in fp32); 2e-2 covers
# a few such roundings at |o| <= 1. fp32: both compute in fp32 and differ
# only in summation order over at most a few thousand terms.
TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
# Quantized matmul against its plain version (dequantize in fp32, fp32
# product, one rounding to the output type): both dequantize each weight
# with the same fp32 product and accumulate in fp32 in different orders.
# |k - ref| <= atol * max|ref| + rtol * |ref|. bf16 output: the two fp32
# sums can fall on either side of a bf16 rounding boundary, one bf16 ulp,
# at most 2^-7 relative; fp32 output: summation order over up to 14336
# terms, a few 1e-6 relative of the largest outputs.
QMM_TOL = {torch.bfloat16: (1e-4, 1e-2), torch.float32: (1e-5, 1e-4)}

MAIN_PROMPT_LENS = (17, 64, 129, 250, 333, 511, 700, 4600)
MAIN_NEW_TOKENS = 32
FP8_PROMPT_LENS = (17, 129, 4600)
FP8_NEW_TOKENS = 8


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- device

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# ----------------------------------------------------------------- build

def phase_build():
    t0 = time.perf_counter()
    secs = _build.build()
    wall = time.perf_counter() - t0
    for name, log_text in _build.build_log.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log_text)]
        spills = sum(int(w) for w in
                     re.findall(r"(\d+) bytes spill stores", log_text))
        log(f"[build] {name}: {len(regs)} kernels, at most "
            f"{max(regs, default=0)} registers a thread, {spills} bytes of "
            "spill stores")
    log(f"[build] built {sorted(secs)} in {wall:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in secs.items()})})")
    for name in _build.sources():
        _build.load(name)
    return wall


# ------------------------------------------------------- kernel vs plain

def make_case(seed, ctx_lens, C, H, KH, D, bs, dtype, n_pad=0, spare=8):
    """Random pools and disjoint shuffled block tables. Sequence i's context
    is ctx_lens[i]; its last min(C, ctx) positions are this chunk. n_pad
    padded rows follow (n_tokens = 0, tables all -1), as ragged_wrapper
    emits them. Table entries past each context are -1."""
    rng = np.random.default_rng(seed)
    N = len(ctx_lens) + n_pad
    MB = max(-(-c // bs) for c in ctx_lens) + 1
    NB = sum(-(-c // bs) for c in ctx_lens) + spare
    perm = rng.permutation(NB)
    tables = np.full((N, MB), -1, np.int32)
    start, ntok, pos = np.zeros(N, np.int32), np.zeros(N, np.int32), 0
    for i, ctx in enumerate(ctx_lens):
        nblk = -(-ctx // bs)
        tables[i, :nblk] = perm[pos:pos + nblk]
        pos += nblk
        n = min(C, ctx)
        start[i], ntok[i] = ctx - n, n
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device="cuda")  # noqa: E731
    q = t(rng.standard_normal((N, C, H, D), np.float32), dtype)
    kp = t(rng.standard_normal((NB, KH, bs, D), np.float32), dtype)
    vp = t(rng.standard_normal((NB, KH, bs, D), np.float32), dtype)
    return (q, kp, vp, t(tables, torch.int32), t(start, torch.int32),
            t(ntok, torch.int32))


def quantize_pool(pool, kv_dtype):
    """A pool [NB, KH, bs, D] as codes with one scale per (block, KV head),
    scale = amax / qmax (the KV writer's rule for a fresh block)."""
    qmax = 448.0 if kv_dtype == torch.float8_e4m3fn else 127.0
    x = pool.float()
    scale = (x.abs().amax(dim=(2, 3)) / qmax).clamp(min=1e-8)
    y = x / scale[:, :, None, None]
    if kv_dtype == torch.int8:
        y = torch.round(y)
    return y.clamp(-qmax, qmax).to(kv_dtype).contiguous(), scale.contiguous()


KERNEL_CASES = [
    # name, ctx_lens, C, H, KH, D, bs, dtype, n_pad, alibi, window
    ("decode G=4 D=128", [1, 17, 300, 2000], 1, 32, 8, 128, 16,
     torch.bfloat16, 2, False, 0),
    ("decode G=1 D=64", [5, 33, 64, 700], 1, 8, 8, 64, 16,
     torch.bfloat16, 1, False, 0),
    ("decode G=4 window<ctx", [100, 900, 5000], 1, 32, 8, 128, 16,
     torch.bfloat16, 1, False, 512),
    ("decode alibi G=1", [9, 250, 1025], 1, 16, 16, 64, 16,
     torch.bfloat16, 1, True, 0),
    ("prefill C=64 G=4 D=128", [64, 200, 1000], 64, 32, 8, 128, 16,
     torch.bfloat16, 1, False, 0),
    ("prefill C=64 G=1 D=64 alibi", [40, 64, 333], 64, 8, 8, 64, 16,
     torch.bfloat16, 1, True, 0),
    ("prefill C=256 G=4 D=128 window", [256, 700, 4600], 256, 32, 8, 128, 16,
     torch.bfloat16, 1, False, 4096),
    ("prefill C=256 G=4 window<chunk", [300, 1500], 256, 32, 8, 128, 16,
     torch.bfloat16, 0, False, 100),
    ("fp32 C=5 G=2 bs=12 D=256", [5, 30, 97], 5, 8, 4, 256, 12,
     torch.float32, 1, False, 0),
    ("fp32 decode G=4 alibi window", [3, 77, 400], 1, 16, 4, 64, 8,
     torch.float32, 1, True, 50),
]


def check_paged(name, q, kp, vp, tbl, sp, nt, dtype, kw):
    out = pa.paged_attention(q, kp, vp, tbl, sp, nt, **kw)
    ref = pa.paged_attention(q, kp, vp, tbl, sp, nt, force_reference=True,
                             **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"[kernel] {name}: non-finite output")
    atol, rtol = TOL[dtype]
    err = 0.0
    for i in range(q.shape[0]):
        v = int(nt[i])
        if v == 0:
            # a row with no live block writes zeros (acc / max(l, 1e-30))
            if out[i].abs().max().item() != 0.0:
                raise AssertionError(f"[kernel] {name}: padded row {i} "
                                     "is not zero")
            continue
        o, r = out[i, :v].float(), ref[i, :v].float()
        d = (o - r).abs()
        err = max(err, d.max().item())
        bad = d > atol + rtol * r.abs()
        if bad.any():
            raise AssertionError(
                f"[kernel] {name}: row {i} max |diff| {d.max().item():.3g}"
                f" over atol {atol} + rtol {rtol}·|ref|")
    log(f"[kernel] {name}: ok, max |kernel - plain| = {err:.3g} "
        f"({str(dtype).split('.')[-1]}, atol {atol}, rtol {rtol})")
    return err


def phase_kernel_paged():
    """The paged kernel, bf16/fp32 pools and int8/fp8 pools. Returns the
    max error over the bf16 cases (the serving dtype) of each branch."""
    max_err = {"bf16": 0.0, "quant": 0.0}
    for (name, ctxs, C, H, KH, D, bs, dtype, n_pad, alibi,
         window) in KERNEL_CASES:
        slopes = (torch.tensor([2.0 ** (-8.0 * (i + 1) / H) for i in range(H)],
                               device="cuda") if alibi else None)
        kw = dict(alibi_slopes=slopes, window=window)
        q, kp, vp, tbl, sp, nt = make_case(len(name), ctxs, C, H, KH, D, bs,
                                           dtype, n_pad)
        err = check_paged(name, q, kp, vp, tbl, sp, nt, dtype, kw)
        if dtype == torch.bfloat16:
            max_err["bf16"] = max(max_err["bf16"], err)
        q, kp, vp, tbl, sp, nt = make_case(len(name), ctxs, C, H, KH, D, bs,
                                           torch.float32, n_pad)
        q = q.to(dtype)
        for kvd in (torch.int8, torch.float8_e4m3fn):
            kq, ks = quantize_pool(kp, kvd)
            vq, vs = quantize_pool(vp, kvd)
            err = check_paged(f"{name} {str(kvd).split('.')[-1]} pools", q,
                              kq, vq, tbl, sp, nt, dtype,
                              dict(kw, k_scale=ks, v_scale=vs))
            if dtype == torch.bfloat16:
                max_err["quant"] = max(max_err["quant"], err)
    return max_err


QUANT_CASES = [
    # name, shape, in dtype, bits, q dtype, block, zero group (row, group)
    ("w_in layer bf16 int8", (4096, 14336), torch.bfloat16, 8, "int8", 128,
     (5, 3)),
    ("fp32 int4 ragged tail 1001 rows", (1001, 300), torch.float32, 4,
     "int8", 128, (7, 2)),
    ("bf16 fp8 ragged tail", (37, 200), torch.bfloat16, 8, "fp8_e4m3", 128,
     (0, 1)),
    ("fp32 fp8 3d", (5, 4096, 1024), torch.float32, 8, "fp8_e4m3", 128,
     None),
    ("bf16 int8 block 48", (13, 256), torch.bfloat16, 8, "int8", 48, (12, 5)),
    ("fp32 int8 group > 256", (9, 1000), torch.float32, 8, "int8", 500,
     (3, 1)),
]


def check_quantize(name, x, bits, dtype, block):
    """The kernel against the plain version: codes and scales must be
    bit-identical. Returns max |dequant(kernel) - dequant(plain)|, which is
    then 0."""
    q, s = qz.quantize_blockwise(x, bits=bits, block=block, dtype=dtype)
    rq, rs = qz._quantize_torch(x, bits, block, dtype)
    torch.cuda.synchronize()
    nq = int((q.view(torch.uint8) != rq.view(torch.uint8)).sum())
    ns = int((s != rs).sum())
    err = (qz._dequantize_torch(q, s, block)
           - qz._dequantize_torch(rq, rs, block)).abs().max().item()
    if nq or ns:
        raise AssertionError(f"[kernel] quantize {name}: not bit-identical "
                             f"({nq} codes, {ns} scales differ; max |dequant "
                             f"diff| {err:.3g})")
    log(f"[kernel] quantize {name}: ok, bit-identical ({q.numel()} codes, "
        f"{s.numel()} scales; max |dequant diff| {err:.3g})")
    return err


def phase_kernel_quantize():
    gen = torch.Generator("cuda").manual_seed(11)
    max_err = 0.0
    for name, shape, xdt, bits, dtype, block, zero in QUANT_CASES:
        x = torch.randn(shape, generator=gen, device="cuda") * 3.0
        if zero is not None:
            r, g = zero
            x.reshape(-1, shape[-1])[r, g * block:(g + 1) * block] = 0.0
        max_err = max(max_err, check_quantize(name, x.to(xdt), bits, dtype,
                                              block))
    return max_err


QMM_SHAPES = [(4096, 1024), (4096, 14336), (14336, 4096), (4096, 32000),
              (4096, 4096)]
QMM_CASES = (
    # x dtype, q dtype, M, K, N, block, out dtype
    [(torch.bfloat16, "int8", M, K, N, 128, torch.bfloat16)
     for M in (1, 8, 37, 2048) for K, N in QMM_SHAPES]
    + [(torch.bfloat16, "fp8_e4m3", M, K, N, 128, torch.bfloat16)
       for M in (8, 2048) for K, N in QMM_SHAPES]
    + [(torch.float32, "int8", M, K, N, 128, torch.float32)
       for M in (1, 37) for K, N in QMM_SHAPES[:3:2]]
    + [(torch.float32, "fp8_e4m3", M, 4096, 1024, 128, torch.float32)
       for M in (8, 2048)]
    + [(torch.bfloat16, "int8", 37, 100, 200, 128, torch.bfloat16),
       (torch.float32, "fp8_e4m3", 5, 4160, 4160, 128, torch.float32),
       (torch.bfloat16, "int8", 300, 77, 130, 64, torch.float32),
       (torch.bfloat16, "fp8_e4m3", 8, 4096, 4100, 96, torch.bfloat16),
       (torch.bfloat16, "int8", 3, 300, 130, 50, torch.bfloat16),
       (torch.bfloat16, "int8", 16, 4096, 1024, 128, torch.bfloat16),
       (torch.bfloat16, "fp8_e4m3", 2, 1000, 520, 128, torch.float32),
       (torch.float32, "int8", 1500, 512, 384, 128, torch.float32)])


def check_qmm(x, q, s, block, out_dtype, label):
    out = qz.quantized_matmul(x, q, s, block=block, out_dtype=out_dtype)
    ref = qz._quantized_matmul_torch(x, q, s, block, out_dtype)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"[kernel] qmm {label}: non-finite output")
    atol, rtol = QMM_TOL[out_dtype]
    o, r = out.float(), ref.float()
    scale = r.abs().max().item()
    d = (o - r).abs()
    err = d.max().item()
    if (d > atol * scale + rtol * r.abs()).any():
        raise AssertionError(f"[kernel] qmm {label}: max |diff| {err:.3g} "
                             f"over {atol}·max|ref| ({scale:.3g}) + "
                             f"{rtol}·|ref|")
    return err, scale


def phase_kernel_qmm():
    gen = torch.Generator("cuda").manual_seed(12)
    max_err = 0.0
    for xdt, qdt, M, K, N, block, odt in QMM_CASES:
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        q, s = qz.quantize_blockwise(w, block=block, dtype=qdt)
        x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
        label = (f"x {str(xdt).split('.')[-1]} {qdt} M={M} K={K} N={N} "
                 f"B={block} -> {str(odt).split('.')[-1]}")
        err, scale = check_qmm(x, q, s, block, odt, label)
        if xdt == torch.bfloat16 and odt == torch.bfloat16:
            max_err = max(max_err, err)
        log(f"[kernel] qmm {label}: ok, max |kernel - plain| = {err:.3g} "
            f"(max |ref| {scale:.3g})")
    return max_err


def phase_kernel():
    paged = phase_kernel_paged()
    return {"paged_attention": paged["bf16"],
            "paged_attention_quant": paged["quant"],
            "quantize": phase_kernel_quantize(),
            "quantized_matmul": phase_kernel_qmm()}


# ---------------------------------------------------------------- timing

def time_ms(fn, flush, iters=20, warmup=3):
    """Median CUDA-event time of one call, L2 flushed before each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


def live_spans(start, ntok, C, window):
    """Per row (n, ci) the attended KV positions [lo, hi]; per sequence the
    union of its rows' spans (the K/V the function must read)."""
    rows, seqs = [], []
    for s, n in zip(start, ntok):
        if n == 0:
            continue
        lo_seq = None
        for ci in range(n):
            qp = s + ci
            lo = max(0, qp - window + 1) if window else 0
            rows.append(qp - lo + 1)
            lo_seq = lo if lo_seq is None else min(lo_seq, lo)
        seqs.append(s + n - lo_seq)
    return rows, seqs


def bound(q, kp, tbl, sp, nt, window):
    """Least time the card could take: the larger of the bytes the function
    must move (q read, o written, each live K/V position read once — with
    its block's two scales for a quantized pool — the tables and lengths)
    over HBM bandwidth, and its flops (QK and PV over each row's live
    positions) over the bf16 tensor-core peak (the timed q is bf16)."""
    N, C, H, D = q.shape
    KH, bs = kp.shape[1], kp.shape[2]
    item = q.element_size()
    rows, seqs = live_spans(sp.tolist(), nt.tolist(), C, window)
    kv_bytes = sum(seqs) * KH * D * kp.element_size() * 2
    if kp.element_size() == 1:
        kv_bytes += sum(-(-s // bs) for s in seqs) * KH * 4 * 2
    qo_bytes = 2 * N * C * H * D * item
    meta = tbl.numel() * 4 + 2 * N * 4
    flops = sum(rows) * H * D * 4
    b_ms = (kv_bytes + qo_bytes + meta) / PEAK_BYTES_PER_S * 1e3
    f_ms = flops / PEAK_BF16_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def sdpa_dense(q, kp, vp, tbl, sp, nt, window):
    """The same attention as one PyTorch library call: the context
    pre-gathered dense (outside the timing), GQA heads repeated, a boolean
    mask for context, causality and window. Timed only; never used by the
    port."""
    N, C, H, D = q.shape
    NB, KH, bs, _ = kp.shape
    G = H // KH
    ctx = (sp + nt).long()
    S = int(ctx.max())
    MBu = -(-S // bs)
    t = tbl[:, :MBu].clamp(min=0).long()
    k = kp[t].permute(0, 2, 1, 3, 4).reshape(N, KH, MBu * bs, D)[:, :, :S]
    v = vp[t].permute(0, 2, 1, 3, 4).reshape(N, KH, MBu * bs, D)[:, :, :S]
    k = k.repeat_interleave(G, dim=1).contiguous()
    v = v.repeat_interleave(G, dim=1).contiguous()
    qh = q.permute(0, 2, 1, 3).contiguous()                      # [N, H, C, D]
    kv = torch.arange(S, device=q.device)
    qp = sp.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    keep = (kv[None, None, :] <= qp[:, :, None]) \
        & (kv[None, None, :] < ctx[:, None, None])
    if window:
        keep &= qp[:, :, None] - kv[None, None, :] < window
    mask = keep[:, None]                                         # [N,1,C,S]
    F = torch.nn.functional

    def call():
        return F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)
    return call


def timing_case(label, ctxs, C, window, flush, seed=7, kv_dtype=None):
    q, kp, vp, tbl, sp, nt = make_case(seed, ctxs, C, 32, 8, 128, 16,
                                       torch.bfloat16)
    kw = dict(window=window)
    lib_kp, lib_vp = kp, vp
    if kv_dtype is not None:
        kp, ks = quantize_pool(kp, kv_dtype)
        vp, vs = quantize_pool(vp, kv_dtype)
        kw.update(k_scale=ks, v_scale=vs)
        # the library call reads the dequantized context (made untimed)
        lib_kp = (kp.float() * ks[:, :, None, None]).to(torch.bfloat16)
        lib_vp = (vp.float() * vs[:, :, None, None]).to(torch.bfloat16)
    ms = time_ms(lambda: pa.paged_attention_cuda(q, kp, vp, tbl, sp, nt, **kw),
                 flush)
    plain_ms = time_ms(lambda: pa.paged_attention_torch(q, kp, vp, tbl, sp,
                                                        nt, **kw), flush,
                       iters=5, warmup=1)
    lib_ms = time_ms(sdpa_dense(q, lib_kp, lib_vp, tbl, sp, nt, window), flush)
    b_ms, by = bound(q, kp, tbl, sp, nt, window)
    row = {"case": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": by, "library_ms": lib_ms}
    log(f"[timing] paged_attention {json.dumps(row)}")
    return row


def qmm_timing_case(label, M, K, N, flush, qdt="int8", block=128):
    gen = torch.Generator("cuda").manual_seed(M + N)
    w = (torch.randn((K, N), generator=gen, device="cuda") * 0.02)
    q, s = qz.quantize_blockwise(w, block=block, dtype=qdt)
    w_bf16 = qz._dequantize_torch(q, s, block, torch.bfloat16)
    del w
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    bf = torch.bfloat16
    ms = time_ms(lambda: qz.quantized_matmul_cuda(x, q, s, block, bf), flush)
    plain_ms = time_ms(lambda: qz._quantized_matmul_torch(x, q, s, block, bf),
                       flush, iters=5, warmup=1)
    lib_ms = time_ms(lambda: x @ w_bf16, flush)
    G = -(-N // block)
    nbytes = M * K * 2 + K * N * 1 + K * G * 4 + M * N * 2
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    f_ms = 2.0 * M * N * K / PEAK_BF16_FLOPS * 1e3
    row = {"case": label, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(b_ms, f_ms),
           "bound_by": "bytes" if b_ms >= f_ms else "operations",
           "library_ms": lib_ms}
    log(f"[timing] quantized_matmul {json.dumps(row)}")
    return row


def quantize_timing_case(label, rows, n, flush, block=128):
    gen = torch.Generator("cuda").manual_seed(rows)
    x = torch.empty((rows, n), dtype=torch.bfloat16, device="cuda")
    for i in range(0, rows, 4096):      # drawn in slabs: no fp32 copy of x
        x[i:i + 4096] = torch.randn((min(4096, rows - i), n), generator=gen,
                                    device="cuda") * 0.02
    ms = time_ms(lambda: qz.quantize_cuda(x, 8, block), flush, iters=10)
    # the plain version holds several fp32 copies of x (about 30 GB here)
    plain_ms = time_ms(lambda: qz._quantize_torch(x, 8, block), flush,
                       iters=3, warmup=1)
    elems = rows * n
    nbytes = elems * 2 + elems * 1 + rows * (-(-n // block)) * 4
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    # |x|, the max, the product by 1/scale and the rounding: 4 fp32
    # operations an element on the CUDA cores
    f_ms = 4.0 * elems / PEAK_FP32_FLOPS * 1e3
    row = {"case": label, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(b_ms, f_ms),
           "bound_by": "bytes" if b_ms >= f_ms else "operations",
           "library_ms": None}
    log(f"[timing] quantize {json.dumps(row)}")
    return row


def phase_timing():
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    main_ctx = [n + MAIN_NEW_TOKENS - 1 for n in MAIN_PROMPT_LENS]
    head = ("decode N=8, the main path's 8 contexts at its last step, "
            "window 4096")
    rows = {"paged_attention": timing_case(head, main_ctx, 1, 4096, flush)}
    for N in (8, 32):
        ctxs = [int(c) for c in np.linspace(512, 2048, N)]
        timing_case(f"decode N={N}, contexts 512-2048", ctxs, 1, 4096, flush)
    timing_case("prefill chunk C=256 at positions 3840-4095, window 4096",
                [4096], 256, 4096, flush)
    rows["paged_attention_quant"] = timing_case(
        head + ", int8 pools", main_ctx, 1, 4096, flush,
        kv_dtype=torch.int8)
    timing_case(head + ", fp8 pools", main_ctx, 1, 4096, flush,
                kv_dtype=torch.float8_e4m3fn)
    rows["quantized_matmul"] = qmm_timing_case(
        "w_in [4096, 14336] int8, decode M=8", 8, 4096, 14336, flush)
    qmm_timing_case("w_in [4096, 14336] int8, mixed put M=2048", 2048, 4096,
                    14336, flush)
    qmm_timing_case("lm_head [4096, 32000] int8, M=8", 8, 4096, 32000, flush)
    qmm_timing_case("w_in [4096, 14336] fp8, decode M=8", 8, 4096, 14336,
                    flush, qdt="fp8_e4m3")
    rows["quantize"] = quantize_timing_case(
        "engine build: stacked w_in [32*4096, 14336] bf16 -> int8",
        32 * 4096, 14336, flush)
    del flush
    return rows


# ------------------------------------------------------------ main path

def small_parity():
    """The small-input reference: TINY_TEST-shaped fp32 models (weights
    scaled x4 so greedy streams are not one repeated token) give the same
    greedy streams through the kernels on the card as through the plain
    versions on the CPU — dense, and with int8 and fp8 weights and KV, tied
    and untied (so that lm_head quantizes). On a mismatch the first
    diverging step and its top-2 logit margin on both devices are printed."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.testing import greedy_generate
    from deepspeed_tpu_torch.models.transformer import TINY_TEST, CausalLM

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, TINY_TEST.vocab_size, n).tolist()
               for n in (5, 40, 17, 33, 100)]
    base = dict(kv_blocks=64, max_chunk_tokens=16, max_ragged_batch_size=32)
    quant = {"dense": {},
             "int8/int8": dict(weight_quant_enabled=True,
                               kv_quant_enabled=True),
             "fp8/fp8": dict(weight_quant_enabled=True, kv_quant_enabled=True,
                             weight_quant_dtype="fp8_e4m3",
                             kv_quant_dtype="fp8_e4m3")}
    for tied in (True, False):
        cfg = dataclasses.replace(TINY_TEST, tie_embeddings=tied)
        model = CausalLM(cfg)
        params = model.init(torch.Generator("cpu").manual_seed(3),
                            device="cpu")
        params = {g: {k: v * 4 if v.dim() >= 2 else v for k, v in sub.items()}
                  for g, sub in params.items()}
        for qname, qkw in quant.items():
            if qname == "dense" and not tied:
                continue
            streams, picks = {}, {}
            for dev in ("cpu", "cuda"):
                record = []

                def pick(logits, record=record):
                    top = np.sort(logits)[-2:]
                    record.append((int(np.argmax(logits)),
                                   float(top[1] - top[0])))
                    return record[-1][0]

                eng = InferenceEngineV2(
                    model, params, RaggedInferenceEngineConfig(**base, **qkw),
                    device=dev)
                streams[dev] = greedy_generate(eng, prompts,
                                               max_new_tokens=12,
                                               sequential=False,
                                               sample_fn=pick)
                picks[dev] = record
            label = f"{'tied' if tied else 'untied'} {qname}"
            if streams["cpu"] != streams["cuda"]:
                step = next(i for i, (a, b) in enumerate(
                    zip(picks["cpu"], picks["cuda"])) if a[0] != b[0])
                raise AssertionError(
                    f"[main] small fp32 {label}: greedy streams differ; first "
                    f"at sampling step {step}: cpu picks {picks['cpu'][step]}"
                    f", cuda {picks['cuda'][step]} (token, top-2 margin)")
            margin = min(m for _, m in picks["cuda"])
            log(f"[main] small fp32 {label}: greedy streams on the card equal "
                f"the CPU plain path's ({len(prompts)} requests x 12 tokens; "
                f"smallest top-2 margin {margin:.3g})")


def step_logits(engine, chunks, step, mode):
    """Logits of one prefill step (two sequences, 256 and 200 prompt
    tokens) or of the decode step after it, with the kernels or with every
    op pinned to its plain version (``mode`` "plain"), or with the plain
    version and the attention in fp32 arithmetic (pools upcast per call,
    output rounded once to q's dtype — the exact-softmax yardstick;
    test-only, swapped in here)."""
    plain = pa.paged_attention_torch

    def plain_fp32(q, k_pool, v_pool, *args, **kw):
        return plain(q.float(), k_pool.float(), v_pool.float(), *args,
                     **kw).to(q.dtype)

    pa.FORCE_REFERENCE = qz.FORCE_REFERENCE = mode != "kernel"
    if mode == "plain_fp32":
        pa.paged_attention_torch = plain_fp32
    uids = [20_000, 20_001]
    try:
        out = engine.put(uids, [chunks[0][:256], chunks[1][:200]])
        if step == "decode":
            out = engine.put(uids, [[chunks[0][256]], [chunks[1][200]]])
        return out.float()
    finally:
        pa.FORCE_REFERENCE = qz.FORCE_REFERENCE = False
        pa.paged_attention_torch = plain
        for u in uids:
            engine.flush(u)


def compare_steps(engine, vocab, label):
    """One prefill and one decode step through the kernels against the
    plain versions. The runs differ only in rounding, which 32 layers
    amplify; the check is that the kernels' logits are no further from the
    fp32-arithmetic attention's than the plain bf16 version's are (the plain version rounds p — and dequantized K/V — to
    bf16 before the products; the kernel keeps them in fp32)."""
    rng = np.random.default_rng(99)
    chunks = [rng.integers(0, vocab, 257).tolist(),
              rng.integers(0, vocab, 201).tolist()]
    res = {}
    for step in ("prefill", "decode"):
        k, p, p32 = (step_logits(engine, chunks, step, m)
                     for m in ("kernel", "plain", "plain_fp32"))
        if not torch.isfinite(k).all():
            raise AssertionError(f"[{label}] {step}: non-finite logits")
        d_kp = (k - p).abs().max().item()
        d_k32 = (k - p32).abs().max().item()
        d_p32 = (p - p32).abs().max().item()
        agree = (k.argmax(-1) == p.argmax(-1)).float().mean().item()
        log(f"[{label}] {step} step logits (max |logit| "
            f"{p32.abs().max().item():.4g}): max |kernel - plain| = "
            f"{d_kp:.4g}, max |kernel - fp32 attention| = {d_k32:.4g}, "
            f"max |plain - fp32 attention| = {d_p32:.4g}; argmax agreement "
            f"kernel/plain {agree:.2f}")
        if d_k32 > d_p32:
            raise AssertionError(
                f"[{label}] {step}: the kernels' logits are further from "
                f"fp32 attention ({d_k32:.4g}) than the plain version's "
                f"({d_p32:.4g})")
        res[step] = {"max_dlogit": d_kp, "argmax_agreement": agree}
    return res


def profile_steps(engine, prompts, label, top=8):
    """torch.profiler over two puts of the main path: the long prompt's last
    256-token chunk (its context at 4344-4599) and one decode step of all 8
    requests. Prints each put's wall time, the device's busy share (kernel
    time over wall time), and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    uids = [30_000 + i for i in range(len(prompts))]
    last = len(prompts) - 1
    for u, p in zip(uids, prompts):
        stop = len(p) - 256 if u == uids[last] else len(p)
        for s in range(0, stop, 256):
            engine.put([u], [p[s:min(s + 256, stop)]])
    steps = [("prefill chunk 256 @4344", [uids[last]], [prompts[last][-256:]]),
             ("decode 8 rows", uids, [[p[0]] for p in prompts])]
    for name, us, chunks in steps:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            engine.put(us, chunks)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        # device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in evs) / 1e3
        evs.sort(key=lambda e: -e.self_device_time_total)
        log(f"[profile {label}] {name}: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}%)")
        for e in evs[:top]:
            log(f"[profile {label}]   {e.self_device_time_total / 1e3:8.3f} ms"
                f" x{e.count:<5d} {e.key[:90]}")
    for u in uids:
        engine.flush(u)


def serve(engine, cfg, prompts, new_tokens, label):
    """Greedy generation through the scheduler with every put timed; the
    kernels' launch counts are set to 0 just before and read just after."""
    from deepspeed_tpu_torch.inference.v2.testing import greedy_generate

    puts = []
    real_put = engine.put

    def timed_put(uids, chunks, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_put(uids, chunks, **kw)
        torch.cuda.synchronize()
        puts.append((sum(len(c) for c in chunks),
                     max(len(c) for c in chunks) > 1,
                     time.perf_counter() - t))
        return out

    def checked_argmax(logits):
        if logits.shape != (cfg.vocab_size,) or not np.isfinite(logits).all():
            raise AssertionError(f"[{label}] non-finite or mis-shaped logits")
        return int(np.argmax(logits))

    engine.put = timed_put
    pa.launches = 0
    qz.launches["quantized_matmul"] = 0
    t0 = time.perf_counter()
    try:
        streams = greedy_generate(engine, prompts, max_new_tokens=new_tokens,
                                  sequential=False, sample_fn=checked_argmax)
        torch.cuda.synchronize()
    finally:
        # drop the instance attribute (no engine -> bound method -> engine
        # cycle that would keep a dropped engine's memory alive)
        del engine.put
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.launches,
                "quantized_matmul": qz.launches["quantized_matmul"]}

    if any(len(s) != new_tokens for s in streams):
        raise AssertionError(f"[{label}] stream lengths "
                             f"{[len(s) for s in streams]}")
    if engine.free_blocks != engine.config.kv_blocks:
        raise AssertionError(f"[{label}] {engine.free_blocks} of "
                             f"{engine.config.kv_blocks} blocks free after "
                             "the run")
    pre = [(n, s) for n, is_pre, s in puts if is_pre]
    dec = [(n, s) for n, is_pre, s in puts if not is_pre]
    pre_tps = sum(n for n, _ in pre) / sum(s for _, s in pre)
    dec_tps = sum(n for n, _ in dec) / sum(s for _, s in dec)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{label}] served {len(prompts)} requests (prompts "
        f"{[len(p) for p in prompts]}) x {new_tokens} new tokens in "
        f"{wall:.2f} s: {len(puts)} puts ({len(pre)} with prompt chunks, "
        f"{len(dec)} decode-only), launches {json.dumps(launches)}; free "
        f"blocks back to {engine.config.kv_blocks}")
    log(f"[{label}] prefill puts: {sum(n for n, _ in pre)} tokens in "
        f"{sum(s for _, s in pre):.3f} s = {pre_tps:.1f} tokens/s; "
        f"decode-only puts: {sum(n for n, _ in dec)} tokens in "
        f"{sum(s for _, s in dec):.3f} s = {dec_tps:.1f} tokens/s; "
        f"peak memory {peak:.2f} GB")
    return {"launches": launches, "puts": len(puts), "prefill_tps": pre_tps,
            "decode_tps": dec_tps, "peak_gb": peak}


def run_mistral(label, seed, prompt_lens, new_tokens, quant=None,
                profile_puts=False):
    """Build MISTRAL_7B at full width (bf16, random weights) into an engine
    — with ``quant`` the tree is quantized at the build and then dropped —
    serve the prompts, check the launch counts, and hold one prefill and one
    decode step against the plain versions."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    cfg = MISTRAL_7B
    model = CausalLM(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(seed),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = sum(v.numel() * v.element_size() for sub in params.values()
                 for v in sub.values())
    log(f"[{label}] MISTRAL_7B weights: {nbytes / 1e9:.2f} GB bf16, "
        f"{cfg.num_layers} layers, made in {time.perf_counter() - t0:.1f} s")
    kv_blocks = 1024
    ecfg = RaggedInferenceEngineConfig(kv_block_size=16, max_chunk_tokens=256,
                                       max_ragged_sequence_count=32,
                                       kv_blocks=kv_blocks, **(quant or {}))
    qz.launches["quantize"] = 0
    t0 = time.perf_counter()
    engine = InferenceEngineV2(model, params, ecfg, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    quantize_launches = qz.launches["quantize"]
    res = {"quantize_launches": quantize_launches}
    if quant:
        # serve from the quantized tree only: the peak is quantized serving's
        del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stats = engine.param_stats()
        kv = sum(t.numel() * t.element_size()
                 for t in engine.state_manager.kv_cache.values())
        want = 7 + (0 if cfg.tie_embeddings else 1)   # stacked leaves
        if quantize_launches != want:
            raise AssertionError(f"[{label}] {quantize_launches} quantize "
                                 f"launches at the build, want {want}")
        log(f"[{label}] engine build quantized the tree in {build_s:.2f} s "
            f"({quantize_launches} quantize launches); resident weights "
            f"{stats['param_bytes_total'] / 1e9:.2f} GB "
            f"({stats['param_bytes_quantized'] / 1e9:.2f} GB quantized, "
            f"{stats['params_quantized']} nodes), KV pools and scales "
            f"{kv / 1e9:.3f} GB")
        res.update(weights_gb=stats["param_bytes_total"] / 1e9,
                   kv_gb=kv / 1e9)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in prompt_lens]

    # warm-up (cuBLAS handles, allocator): one short request, flushed
    engine.put([10_000], [prompts[0][:16]])
    engine.flush(10_000)
    torch.cuda.synchronize()

    res.update(serve(engine, cfg, prompts, new_tokens, label))
    puts, launches = res["puts"], res["launches"]
    if launches["paged_attention"] != cfg.num_layers * puts:
        raise AssertionError(f"[{label}] {launches['paged_attention']} paged "
                             f"launches for {puts} puts x {cfg.num_layers} "
                             "layers")
    qmm_per_put = (7 * cfg.num_layers + (0 if cfg.tie_embeddings else 1)
                   if quant else 0)
    if launches["quantized_matmul"] != qmm_per_put * puts:
        raise AssertionError(f"[{label}] {launches['quantized_matmul']} "
                             f"quantized-matmul launches for {puts} puts, "
                             f"want {qmm_per_put} per put")
    res["steps"] = compare_steps(engine, cfg.vocab_size, label)
    if profile_puts:
        profile_steps(engine, prompts, label)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_main(profile_puts=False):
    small_parity()
    return run_mistral("main", 0, MAIN_PROMPT_LENS, MAIN_NEW_TOKENS,
                       profile_puts=profile_puts)


def phase_quant(profile_puts=False):
    int8 = run_mistral("quant int8", 0, MAIN_PROMPT_LENS, MAIN_NEW_TOKENS,
                       quant=dict(weight_quant_enabled=True,
                                  weight_quant_block=128,
                                  kv_quant_enabled=True),
                       profile_puts=profile_puts)
    fp8 = run_mistral("quant fp8", 1, FP8_PROMPT_LENS, FP8_NEW_TOKENS,
                      quant=dict(weight_quant_enabled=True,
                                 weight_quant_dtype="fp8_e4m3",
                                 weight_quant_block=128,
                                 kv_quant_enabled=True,
                                 kv_quant_dtype="fp8_e4m3"))
    return int8, fp8


# ------------------------------------------------------------------ main

KERNEL_SOURCES = {
    "paged_attention": ("paged_attention.cu",
                        "deepspeed_tpu/ops/paged_attention.py:63"),
    "paged_attention_quant": ("paged_attention.cu",
                              "deepspeed_tpu/ops/paged_attention.py:63"),
    "quantize": ("quantize.cu", "deepspeed_tpu/ops/quantizer.py:130"),
    "quantized_matmul": ("quantized_matmul.cu",
                         "deepspeed_tpu/ops/quantizer.py:257"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace two puts of the bf16 and int8 paths")
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel phase (no result lines)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    secs = {}

    def timed(name, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        secs[name] = round(time.perf_counter() - t, 1)
        log(f"[phase] {name}: {secs[name]} s")
        return out

    card = timed("device", phase_device)
    timed("build", phase_build)
    errs = timed("kernel", phase_kernel)
    if args.quick:
        log(f"[done] --quick: {json.dumps(secs)}")
        return
    times = timed("timing", phase_timing)
    main_res = timed("main", phase_main, profile_puts=args.profile)
    int8, fp8 = timed("quant", phase_quant, profile_puts=args.profile)
    log(f"[quant] MISTRAL_7B tokens/s and peak memory, bf16 | int8 weights "
        f"+ int8 KV | fp8 weights + fp8 KV (fewer requests): prefill "
        f"{main_res['prefill_tps']:.1f} | {int8['prefill_tps']:.1f} | "
        f"{fp8['prefill_tps']:.1f}; decode {main_res['decode_tps']:.1f} | "
        f"{int8['decode_tps']:.1f} | {fp8['decode_tps']:.1f}; peak "
        f"{main_res['peak_gb']:.2f} | {int8['peak_gb']:.2f} | "
        f"{fp8['peak_gb']:.2f} GB")

    launches = {"paged_attention": main_res["launches"]["paged_attention"],
                "paged_attention_quant": int8["launches"]["paged_attention"],
                "quantize": int8["quantize_launches"],
                "quantized_matmul": int8["launches"]["quantized_matmul"]}
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["case"]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s {json.dumps(secs)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
