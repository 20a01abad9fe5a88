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
             than the context, a SplitFuse put of one 256-token chunk and
             seven one-token rows, v1 decode's bs = 128 with contiguous
             tables, and the split-KV decode route's edges: spans not a
             multiple of its piece, a window shorter than a piece, one live
             position, 16-row groups; and the serving features' traffic:
             speculative verify rows at C = 4, 5 and 8 whose rows carry
             different draft counts, rows of one put sharing their first 8
             blocks, a first chunk at position 2048, each on the route
             paged_route names; and blocks the KV tier restored from host
             RAM and from disk into other block ids, bf16 and int8 pools,
             whose output must be bit-identical to the original blocks')
             on valid rows, with every row past
             n_tokens zero, each output bit-identical over two runs, bf16
             decode on the split-KV route over every pool type, fp32
             decode on the CUDA-core kernel, and every route of the wrapper
             taken; the blockwise quantizer bit for bit and the same bits
             over two runs (bits 8 and 4, fp8, bf16 and fp32 input, ragged
             tails, rows not a multiple of 8, an all-zero group, the serving
             build's stacked w_in; each case on its asserted route, both
             routes taken); the dequantize kernel bit
             for bit (torch.equal; int8 and unpacked int4 codes at the v1
             widths, gathered embedding rows, a norm row, ragged tails,
             bf16, fp16 and fp32 out) and that it raises on what it does not
             take (fp8 or packed codes, mismatched scales); the quantized
             matmul (int8 and fp8, x bf16 and fp32, M = 1, 8, 16, 37, 2000
             and 2048 at the serving widths, M = 32 and 40 — a verify
             put's rows — on the wgmma route, bf16 and fp32 out, ragged last
             groups, shapes that keep the mma.sync route; every bf16 decode
             case at the serving shapes on the tensor-core decode route and
             bit-identical over two runs, its edges (block 64 and 192, a
             64-column last strip, K slices of unequal length, empty
             ones), an unaligned x on the weight-streaming kernel; every
             route of the wrapper taken, the __global__ function logged);
             the flash
             attention forward, delta, dq and dkv kernels (bf16, fp32 and
             fp16; MHA, GQA, MQA; D = 64, 80, 128, 256; causal with T = S
             and T < S, non-causal, windows, tails, sm_scale, the edges of
             the wgmma kernels' 128-row blocks and 64-row tiles; the train
             phase's own shape, T = S = 8192 with window 4096, the timing
             shape B = 4, T = S = 2048, and the v1 prefill's; the forward,
             dq and dkv each bit-identical over two runs; every case's
             route logged, every bf16 D = 64/128 case on the wgmma
             kernels and every other on the CUDA-core kernels) and the
             autograd Function built on them.
4. timing  — each kernel at its path's shapes beside its bound, its plain
             version and, where there is one, one PyTorch library call
             (the device idles before each timed call, so that the events
             time the kernels and not the wrappers' Python).
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
7. v1      — v1 inference at full MISTRAL_7B width (32 layers, bf16
             compute, random bf16 weights from a seeded generator) through
             init_inference and generate: the main path's 8 prompts as one
             ragged batch, 32 greedy new tokens, with bf16 weights, then
             int8 and int4 weight-only quantization (quantized at the build,
             11 quantize launches, and the dense tree dropped). Checks the
             output's shape and placement, finite logits, the launch counts
             ((1 + 32) x 290 dequantize, 32 flash forward, 32 x 32 paged at
             bs = 128), an EOS run, one prefill and one decode step against
             the plain versions, and that small fp32 v1 engines (quant off,
             8 and 4; tied and untied) give the same greedy streams on the
             card as on the CPU. Traces one decode step of each way.
8. features — the v2 serving features: small fp32 engines give the same
             greedy streams and counters on the card as on the CPU with the
             prefix cache, speculation at K = 3 and 4, and preemption (dense,
             int8 and fp8); then one MISTRAL_7B engine at full width (32
             layers, bf16): the kernels' logits against the plain versions'
             on a verify put and a prefix-hit chunk (the gap the greedy-
             parity rule allows), the prefix cache off, cold and warm over a
             2048-token system prompt (the warm pass matches 8 x 2048
             tokens; every block free after clearing), n-gram and draft-
             model speculation at K = 3 (verify puts on the split-KV route)
             and K = 4 (on the tensor-core prefill route), preemption in a
             400-block pool (every preempted sequence resumes), KV export/
             import byte round trips on bf16, int8 and fp8 pools, preemption
             with int8 KV and speculation with int8 weights + int8 KV; each
             run's streams equal the feature-off run's or diverge only at a
             margin within that gap, with one paged launch per layer and put
             (and 225 quantized-matmul launches with int8 weights); the KV
             tier cell, bf16 and again with int8 weights + int8 KV: 6
             system prompts of 1024 tokens (+ 32) twice a pass, two passes,
             one request at a time, in a 260-block pool with reservation
             admission, the tier off and then on (host RAM of two
             prefixes, 1 GiB of disk through the native aio library):
             restores from both tiers, no corrupt read, every block back;
             a traced pass whose streams equal the untraced one's and whose
             spans cover each request's TTFT, a tier configured off equal
             to none, and an evacuation whose export fails; then a
             universal checkpoint of the model with 2 layers, written with
             numpy (some leaves as shard files), loaded onto the card leaf
             for leaf, and served by v2 and v1 (built from it, and through
             ``load_checkpoint``) with the in-memory tree's streams.
9. serving — the serving stack through ServingFrontend (admission queue,
             router, replica threads, supervisor, fault injection,
             telemetry) at full MISTRAL_7B width (32 layers, bf16, blocks of
             16, chunks of 256, random weights from a seed, one weight tree
             shared by every engine, each engine with its own KV pool):
             a burst of 48 requests at one replica with a queue of 16
             (sheds, and submitted = completed + shed + expired, no
             failure); 16 requests through one replica, two, and two with
             replica 0 crashed at step 4 under fault_tolerance (the only
             death the injected one, its requests failed over and finished,
             the supervisor's restart logged, memory back after the cell);
             int8 weights, int8 KV, the prefix cache and reservation
             admission through ServingConfig with telemetry and an SLO on
             (8 quantize launches at the build, 225 quantized-matmul
             launches a put, prefix tokens saved, each request's span chain
             covering its TTFT, a valid debug-dump trace, the Prometheus
             text and health report, a cancel that frees every block).
             Each run's counts are set to 0 just before it and read after:
             32 paged launches a put; every stream holds to the same
             prompts through a bare scheduler by the greedy-parity rule;
             no replica dies outside the chaos run and no replica's params
             require grad. Prints TTFT, TPOT and tokens/s beside the bare
             scheduler's, recovery_s and two replicas' tokens/s against
             one's.
10. train  — the training path at full MISTRAL_7B width, 8 of its 32 layers
             (fp32 master weights, two moments and an accumulator cost 16
             bytes a parameter), bf16, AdamW with WarmupLR, clipping,
             micro batch 1 x 2 accumulation steps, sequences of 8193 tokens:
             4 optimizer steps through initialize() and train_batch().
             Checks finite losses and grad norms, the first loss against
             its expectation, that the loss falls, the step counters, the
             launch counts (64 each of forward, delta, dq, dkv), one micro
             step against the plain attention, a remat run (forward
             launches double), that a small fp32 engine gives the same
             losses on the card as on the CPU, and one step with the
             telemetry block on (fwd_bwd and optimizer_step spans summing
             to the synchronized step wall within 5%, the loss equal to
             the untraced run's).

The last lines are one ``{"kernels": [...]}`` JSON object, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.

``--profile`` adds a torch.profiler trace of two puts of the bf16 and of the
int8 main path, of a verify put and a prefix-hit put, and of one training
step (the breakdowns in PERF.md section 5). ``--quick`` stops after the kernel phase; ``--only PHASE`` runs one
later phase after it (a short call after an edit; no result lines;
``--only kv_tier`` runs the KV tier cell on its own MISTRAL_7B engine;
``--only serving`` runs the serving phase).
``--compare`` times the kernels at the main path's shapes through their
entry points alone: a copy of this script in an unpacked parent commit
times the parent's kernels on the same inputs (no result lines).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import flash_attention as fa
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

# kernels whose registers and spills the build log reports one by one
REPORTED_KERNELS = (r"decode_split|decode_combine|fwd_wgmma|dq_wgmma|dkv_wgmma"
                    r"|qmm_decode_tc|quantize_vec")


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
        fn = None
        for line in log_text.splitlines():
            if re.search(r"wgmma.*(serializ|performance)", line, re.I):
                log(f"[build] {name}: {line.strip()}")
            m = re.search(r"Function properties for \S*\d([a-z_]+_kernel)I(\w+?)EE",
                          line)
            if m:
                fn = f"{m.group(1)}<{m.group(2)}>"
            m = re.search(r"(\d+) bytes spill stores|Used (\d+) registers",
                          line)
            if m and fn and re.search(REPORTED_KERNELS, fn):
                log(f"[build] {name}: {fn}: {line.strip()[:70]}")
    log(f"[build] built {sorted(secs)} in {wall:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in secs.items()})})")
    for name in _build.sources():
        _build.load(name)
    return wall


# ------------------------------------------------------- kernel vs plain

def make_case(seed, ctx_lens, C, H, KH, D, bs, dtype, n_pad=0, spare=8,
              chunks=None):
    """Random pools and disjoint shuffled block tables. Sequence i's context
    is ctx_lens[i]; its last min(C, ctx) positions (min(chunks[i], ctx) with
    per-sequence chunk lengths) are this chunk. n_pad padded rows follow
    (n_tokens = 0, tables all -1), as ragged_wrapper emits them. Table
    entries past each context are -1."""
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
        n = min(C if chunks is None else chunks[i], ctx)
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


# A SplitFuse put as the ragged wrapper buckets it: one prompt's 256-token
# chunk at positions 3840-4095 and seven sequences that bring one decode
# token each, at contexts of the main path's prompts.
MIXED_CTX = [4096] + [n + 16 for n in MAIN_PROMPT_LENS[:7]]
MIXED_CHUNKS = [256] + [1] * 7

KERNEL_CASES = [
    # name, ctx_lens, C, H, KH, D, bs, dtype, n_pad, alibi, window[, chunks]
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
    ("mixed put C=256 G=4 D=128 window", MIXED_CTX, 256, 32, 8, 128, 16,
     torch.bfloat16, 0, False, 4096, MIXED_CHUNKS),
    ("prefill C=64 G=4 D=64 alibi window", [64, 90, 700], 64, 16, 4, 64, 16,
     torch.bfloat16, 1, True, 300),
    # the split-KV decode route's edges: spans that are not a multiple of
    # its 256-position piece, a window shorter than one piece, a single
    # live position, padded rows (n_tokens = 0) at v1's bs = 128, and
    # 16-row groups (C = 4 at G = 4; C = 2 at G = 8)
    ("decode spans not a multiple of the piece", [255, 257, 777, 1000], 1,
     32, 8, 128, 16, torch.bfloat16, 1, False, 0),
    ("decode window 100 < piece", [50, 257, 3000], 1, 32, 8, 128, 16,
     torch.bfloat16, 1, False, 100),
    ("decode window 1: one live position", [1, 300, 2000], 1, 32, 8, 128,
     16, torch.bfloat16, 1, False, 1),
    ("decode bs=128 padded rows window", [129, 4000, 4700], 1, 32, 8, 128,
     128, torch.bfloat16, 3, False, 4096),
    ("decode C=4 G=4 (16 rows) window", [4, 60, 700, 1500], 4, 32, 8, 128,
     16, torch.bfloat16, 1, False, 600),
    ("decode C=2 G=8 D=64 alibi (16 rows)", [2, 90, 1300], 2, 16, 2, 64, 16,
     torch.bfloat16, 1, True, 0),
    ("fp32 C=5 G=2 bs=12 D=256", [5, 30, 97], 5, 8, 4, 256, 12,
     torch.float32, 1, False, 0),
    ("fp32 decode G=4 alibi window", [3, 77, 400], 1, 16, 4, 64, 8,
     torch.float32, 1, True, 50),
    ("fp32 prefill C=40 G=4 D=128 window", [40, 300, 1000], 40, 32, 8, 128,
     16, torch.float32, 1, False, 256),
]


def paged_route_name(q, kp):
    N, C, H, D = q.shape
    return pa.PAGED_ROUTES[pa.paged_route(C, H, kp.shape[1], D, q.dtype)]


def check_paged(name, q, kp, vp, tbl, sp, nt, dtype, kw, routes=None):
    out = pa.paged_attention(q, kp, vp, tbl, sp, nt, **kw)
    again = pa.paged_attention(q, kp, vp, tbl, sp, nt, **kw)
    ref = pa.paged_attention(q, kp, vp, tbl, sp, nt, force_reference=True,
                             **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"[kernel] {name}: non-finite output")
    if not torch.equal(out, again):
        raise AssertionError(f"[kernel] {name}: two runs of the kernel on "
                             "the same inputs differ")
    atol, rtol = TOL[dtype]
    err = 0.0
    for i in range(q.shape[0]):
        v = int(nt[i])
        # rows past n_tokens (all of a padded sequence's) attend nothing:
        # the kernel writes zeros there (acc / max(l, 1e-30))
        if v < q.shape[1] and out[i, v:].abs().max().item() != 0.0:
            raise AssertionError(f"[kernel] {name}: sequence {i} has a "
                                 f"non-zero row past its {v} tokens")
        if v == 0:
            continue
        o, r = out[i, :v].float(), ref[i, :v].float()
        d = (o - r).abs()
        err = max(err, d.max().item())
        bad = d > atol + rtol * r.abs()
        if bad.any():
            raise AssertionError(
                f"[kernel] {name}: row {i} max |diff| {d.max().item():.3g}"
                f" over atol {atol} + rtol {rtol}·|ref|")
    route = paged_route_name(q, kp)
    if routes is not None:
        routes.add(route)
    log(f"[kernel] {name}: ok, max |kernel - plain| = {err:.3g} "
        f"({str(dtype).split('.')[-1]}, atol {atol}, rtol {rtol}; {route}; "
        "bit-identical twice)")
    return err, route


def v1_decode_case(seed, ctx_lens, bs=128, H=32, KH=8, D=128):
    """What v1 decode gives the paged kernel: one query a sequence (C = 1)
    at position ctx - 1, a pool of ``bs``-slot blocks in which sequence b
    owns the contiguous range [b·NB, (b+1)·NB) (``init_paged_cache``), NB
    covering the longest context."""
    gen = torch.Generator("cuda").manual_seed(seed)
    N, nb = len(ctx_lens), -(-max(ctx_lens) // bs)
    mk = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
    tbl = torch.arange(N * nb, dtype=torch.int32, device="cuda").reshape(N, nb)
    ctx = torch.tensor(ctx_lens, dtype=torch.int32, device="cuda")
    return (mk(N, 1, H, D), mk(N * nb, KH, bs, D), mk(N * nb, KH, bs, D), tbl,
            ctx - 1, torch.ones_like(ctx))


def phase_kernel_paged():
    """The paged kernel, bf16/fp32 pools and int8/fp8 pools, and the v1
    decode shape (bs = 128, contiguous tables). Returns the max error over
    the bf16 cases (the serving dtype) of each branch."""
    max_err = {"bf16": 0.0, "quant": 0.0}
    routes = set()
    decode_routes = {}   # the route each decode (G * C <= 16) case took
    v1_ctx = [n + MAIN_NEW_TOKENS for n in MAIN_PROMPT_LENS]
    name = "v1 decode bs=128 C=1 contiguous tables G=4 window"
    q, kp, vp, tbl, sp, nt = v1_decode_case(5, v1_ctx)
    err, decode_routes[name] = check_paged(name, q, kp, vp, tbl, sp, nt,
                                           torch.bfloat16, dict(window=4096),
                                           routes)
    max_err["bf16"] = max(max_err["bf16"], err)
    for kvd in (torch.int8, torch.float8_e4m3fn):
        kq, ks = quantize_pool(kp, kvd)
        vq, vs = quantize_pool(vp, kvd)
        qname = f"{name} {str(kvd).split('.')[-1]} pools"
        err, decode_routes[qname] = check_paged(
            qname, q, kq, vq, tbl, sp, nt, torch.bfloat16,
            dict(window=4096, k_scale=ks, v_scale=vs), routes)
        max_err["quant"] = max(max_err["quant"], err)
    for (name, ctxs, C, H, KH, D, bs, dtype, n_pad, alibi, window,
         *chunks) in KERNEL_CASES:
        chunks = chunks[0] if chunks else None
        slopes = (torch.tensor([2.0 ** (-8.0 * (i + 1) / H) for i in range(H)],
                               device="cuda") if alibi else None)
        kw = dict(alibi_slopes=slopes, window=window)
        decode = (H // KH) * C <= 16
        q, kp, vp, tbl, sp, nt = make_case(len(name), ctxs, C, H, KH, D, bs,
                                           dtype, n_pad, chunks=chunks)
        err, route = check_paged(name, q, kp, vp, tbl, sp, nt, dtype, kw,
                                 routes)
        if decode:
            decode_routes[name] = route
        if dtype == torch.bfloat16:
            max_err["bf16"] = max(max_err["bf16"], err)
        q, kp, vp, tbl, sp, nt = make_case(len(name), ctxs, C, H, KH, D, bs,
                                           torch.float32, n_pad,
                                           chunks=chunks)
        q = q.to(dtype)
        for kvd in (torch.int8, torch.float8_e4m3fn):
            kq, ks = quantize_pool(kp, kvd)
            vq, vs = quantize_pool(vp, kvd)
            qname = f"{name} {str(kvd).split('.')[-1]} pools"
            err, route = check_paged(qname, q, kq, vq, tbl, sp, nt, dtype,
                                     dict(kw, k_scale=ks, v_scale=vs), routes)
            if decode:
                decode_routes[qname] = route
            if dtype == torch.bfloat16:
                max_err["quant"] = max(max_err["quant"], err)
    for name, route in phase_kernel_features():
        routes.add(route)
    for kind, err in phase_kernel_tier().items():
        key = "bf16" if kind == "bf16" else "quant"
        max_err[key] = max(max_err[key], err)
    if routes != set(pa.PAGED_ROUTES):
        raise AssertionError(f"[kernel] paged cases took routes "
                             f"{sorted(routes)}, not all of {pa.PAGED_ROUTES}")
    # bf16 decode, over every pool type, takes the split-KV walk; fp32
    # decode keeps the CUDA-core kernel a row a warp
    for name, route in decode_routes.items():
        want = pa.PAGED_ROUTES[0 if name.startswith("fp32") else 3]
        if route != want:
            raise AssertionError(f"[kernel] {name}: took {route}, not {want}")
    log(f"[kernel] paged: {len(decode_routes)} decode cases, each on its "
        f"route ({pa.PAGED_ROUTES[3]} for bf16 q, {pa.PAGED_ROUTES[0]} for "
        "fp32)")
    return max_err


# The serving features' traffic (bf16 q, G = 4, D = 128, window 4096, blocks
# of 16): speculative verify rows (K + 1 = 4 and 5 tokens, and the engine's
# power-of-two bucket C = 8 of K = 4) whose rows carry different draft counts
# and start mid-context; two rows of one put that read the same first 8
# blocks (a prefix-cache hit); a first chunk starting at position 2048 (the
# matched length). name, ctx_lens, C, chunks (n_tokens per row), the route
# ``paged_route`` must name, the rows that share their first 8 blocks.
FEATURE_CASES = [
    ("verify C=4 (K=3) mixed drafts", [300, 1000, 2100, 4200], 4,
     [4, 2, 1, 3], "paged_decode_split_kernel", 0),
    ("verify C=5 (K=4) mixed drafts", [301, 999, 2101, 4199], 5,
     [5, 3, 1, 4], "paged_prefill_tc_kernel", 0),
    ("verify C=8 (K=4 bucket) mixed drafts", [512, 777, 2048, 4601], 8,
     [5, 2, 4, 1], "paged_prefill_tc_kernel", 0),
    ("verify C=4 two rows sharing 8 blocks", [700, 900, 200], 4, [4, 4, 1],
     "paged_decode_split_kernel", 2),
    ("prefix hit: first chunk C=256 at 2048, two rows sharing 8 blocks",
     [2304, 2100], 256, [256, 52], "paged_prefill_tc_kernel", 2),
]


def share_first_blocks(tbl, rows, n=8):
    """Rows 1..rows-1 of ``tbl`` read row 0's first n blocks (as prefix-
    cache hits do); the blocks they owned there go unused."""
    tbl = tbl.clone()
    for r in range(1, rows):
        tbl[r, :n] = tbl[0, :n]
    return tbl


def phase_kernel_features():
    """The feature cases on bf16, int8 and fp8 pools, each on its asserted
    route. Returns (name, route) of every case."""
    out = []
    for name, ctxs, C, chunks, want, shared in FEATURE_CASES:
        q, kp, vp, tbl, sp, nt = make_case(len(name) + 100, ctxs, C, 32, 8,
                                           128, 16, torch.float32,
                                           chunks=chunks)
        if shared:
            tbl = share_first_blocks(tbl, shared)
        q = q.to(torch.bfloat16)
        pools = {"bf16": (kp.to(torch.bfloat16), vp.to(torch.bfloat16), {})}
        for kvd in (torch.int8, torch.float8_e4m3fn):
            kq, ks = quantize_pool(kp, kvd)
            vq, vs = quantize_pool(vp, kvd)
            pools[str(kvd).split(".")[-1]] = (kq, vq, dict(k_scale=ks,
                                                         v_scale=vs))
        for pname, (k, v, kw) in pools.items():
            label = f"{name} {pname} pools"
            _, route = check_paged(label, q, k, v, tbl, sp, nt,
                                   torch.bfloat16, dict(kw, window=4096))
            if route != want:
                raise AssertionError(f"[kernel] {label}: took {route}, not "
                                     f"{want}")
            out.append((label, route))
    log(f"[kernel] paged feature cases: {len(out)}, each on its route")
    return out


TIER_CTX = 1024 + 32        # a 64-block system prompt and a 32-token tail


def phase_kernel_tier():
    """The paged kernel over blocks the KV tier restored: a state manager
    at MISTRAL_7B's KV widths (2 layers, blocks of 16) holds a 1056-token
    sequence in random pools (bf16, and int8 codes with their scale
    planes); its 66 full blocks are evicted through the tier — once into
    host RAM, once straight to disk (through the native aio library) — and
    a match of the same tokens restores them into other block ids. The
    kernel's output over the restored table must be bit-identical to its
    output over the original one (the routes sum in a fixed order), for a
    decode row and a 64-token chunk, and within the paged tolerance of the
    plain version. Returns the largest |kernel - plain| by pool type."""
    from deepspeed_tpu_torch.inference.v2.ragged import DSStateManager
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=2)
    H, KH, D, bs = cfg.num_heads, cfg.kv_heads, cfg.head_dim, 16
    n_full = TIER_CTX // bs
    gen = torch.Generator("cuda").manual_seed(17)
    toks = np.random.default_rng(17).integers(0, cfg.vocab_size,
                                              TIER_CTX + 1).tolist()
    errs = {}
    for kind in ("bf16", "int8"):
        for where in ("host", "disk"):
            tmp = tempfile.mkdtemp(prefix="kvtier_kernel_")
            try:
                sm = DSStateManager(
                    cfg, num_blocks=2 * n_full + 8, block_size=bs,
                    dtype=torch.bfloat16, device="cuda",
                    enable_prefix_cache=True, kv_quant=kind == "int8",
                    kv_tier_enabled=True,
                    kv_tier_host_bytes=(1 << 30) if where == "host" else 1,
                    kv_tier_disk_path=tmp, kv_tier_disk_bytes=1 << 30)
                if not sm._tier.has_native:
                    raise AssertionError("[kernel] tier: the disk tier did "
                                         "not load the native aio library")
                for name, pool in sm.kv_cache.items():
                    if pool.dtype == torch.int8:
                        pool.copy_(torch.randint(-127, 128, pool.shape,
                                                 generator=gen, device="cuda",
                                                 dtype=torch.int8))
                    elif name.endswith("scale"):
                        pool.copy_(torch.rand(pool.shape, generator=gen,
                                              device="cuda") * 0.02 + 1e-3)
                    else:
                        pool.copy_(torch.randn(pool.shape, generator=gen,
                                               device="cuda"))
                seq = sm.get_or_create_sequence(1)
                sm.maybe_allocate_kv(seq, TIER_CTX)
                seq.seen_tokens = TIER_CTX
                sm.record_tokens(seq, toks[:TIER_CTX])
                orig = list(seq.kv_blocks[:n_full])
                sm.flush_sequence(1)
                if sm._evict(n_full) != n_full:
                    raise AssertionError("[kernel] tier: eviction")
                matched = sm.match_prefix(2, toks)
                new = list(sm.get_sequence(2).kv_blocks)
                st = sm.tier_stats()
                if (matched != n_full * bs or set(new) & set(orig)
                        or st["restored"] != n_full or st["corrupt"]
                        or (where == "disk") != (st["demoted"] == n_full)):
                    raise AssertionError(f"[kernel] tier {kind} {where}: "
                                         f"matched {matched}, {st}")
                scales = ({} if kind == "bf16" else
                          dict(k_scale=sm.kv_cache["k_scale"][0],
                               v_scale=sm.kv_cache["v_scale"][0]))
                k0, v0 = sm.kv_cache["k"][0], sm.kv_cache["v"][0]
                for C in (1, 64):
                    q = torch.randn((1, C, H, D), generator=gen,
                                    device="cuda").to(torch.bfloat16)
                    sp = torch.tensor([TIER_CTX - C], dtype=torch.int32,
                                      device="cuda")
                    nt = torch.tensor([C], dtype=torch.int32, device="cuda")
                    outs = []
                    for blocks in (orig, new):
                        tbl = torch.tensor([blocks], dtype=torch.int32,
                                           device="cuda")
                        outs.append(pa.paged_attention(
                            q, k0, v0, tbl, sp, nt, window=4096, **scales))
                    if not torch.equal(outs[0], outs[1]):
                        raise AssertionError(
                            f"[kernel] tier {kind} {where} C={C}: the "
                            "output over the restored blocks differs from "
                            "the output over the original ones")
                    label = (f"tier-restored blocks ({where}) {kind} pools "
                             f"C={C} G=4 D=128")
                    err, _ = check_paged(label, q, k0, v0, tbl, sp, nt,
                                         torch.bfloat16,
                                         dict(scales, window=4096))
                    errs[kind] = max(errs.get(kind, 0.0), err)
                sm.flush_sequence(2)
                sm.configure_kv_tier(False)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    log(f"[kernel] paged over tier-restored blocks (host and disk, bf16 and "
        f"int8 pools, {n_full} blocks into other ids): bit-identical to the "
        "original blocks' output")
    return errs


QUANT_CASES = [
    # name, shape, in dtype, bits, q dtype, block, zero group (row, group),
    # the route it must take (an index into qz.QUANT_ROUTES), and the
    # elements by which x starts past a 16-byte boundary
    ("w_in layer bf16 int8", (4096, 14336), torch.bfloat16, 8, "int8", 128,
     (5, 3), 1, 0),
    ("fp32 int4 ragged tail 1001 rows", (1001, 300), torch.float32, 4,
     "int8", 128, (7, 2), 0, 0),
    ("bf16 fp8 ragged tail", (37, 200), torch.bfloat16, 8, "fp8_e4m3", 128,
     (0, 1), 0, 0),
    ("fp32 fp8 3d", (5, 4096, 1024), torch.float32, 8, "fp8_e4m3", 128,
     None, 0, 0),
    ("bf16 int8 block 48", (13, 256), torch.bfloat16, 8, "int8", 48, (12, 5),
     0, 0),
    ("fp32 int8 group > 256", (9, 1000), torch.float32, 8, "int8", 500,
     (3, 1), 0, 0),
    # the 16-byte route's shapes and edges: the serving build's stacked w_in
    # (compared in slabs of rows), fp8 and int4, blocks 8 to 256, a group
    # count that leaves a warp's last task part-empty, a 3-d tensor; then
    # bf16 calls that keep the warp-a-group kernel (block 512, x off a
    # 16-byte boundary)
    ("build: stacked w_in [32*4096, 14336] bf16 int8", (32 * 4096, 14336),
     torch.bfloat16, 8, "int8", 128, (70_000, 100), 1, 0),
    ("w_in layer bf16 fp8", (4096, 14336), torch.bfloat16, 8, "fp8_e4m3",
     128, (9, 111), 1, 0),
    ("bf16 int4 block 64", (1000, 4096), torch.bfloat16, 4, "int8", 64,
     (999, 63), 1, 0),
    ("bf16 int8 block 256, 37 rows", (37, 1024), torch.bfloat16, 8, "int8",
     256, (36, 3), 1, 0),
    ("bf16 fp8 block 16, 111 groups", (37, 48), torch.bfloat16, 8,
     "fp8_e4m3", 16, (2, 2), 1, 0),
    ("bf16 int8 block 32 3d", (3, 5, 96), torch.bfloat16, 8, "int8", 32,
     None, 1, 0),
    ("bf16 int8 block 8", (7, 64), torch.bfloat16, 8, "int8", 8, (6, 7), 1,
     0),
    ("bf16 int8 block 512", (16, 1024), torch.bfloat16, 8, "int8", 512,
     (15, 1), 0, 0),
    ("bf16 int8 x off a 16-byte boundary", (64, 1024), torch.bfloat16, 8,
     "int8", 128, (1, 1), 0, 1),
]


def check_quantize(name, x, bits, dtype, block, slab=8192):
    """The kernel against the plain version: codes and scales must be
    bit-identical (the plain version taken over slabs of ``slab`` rows, so
    that its fp32 copies stay small), and a second launch must give the
    same bits. Returns max |dequant(kernel) - dequant(plain)|, which is
    then 0."""
    q, s = qz.quantize_blockwise(x, bits=bits, block=block, dtype=dtype)
    q2, s2 = qz.quantize_blockwise(x, bits=bits, block=block, dtype=dtype)
    torch.cuda.synchronize()
    if not (torch.equal(q.view(torch.uint8), q2.view(torch.uint8))
            and torch.equal(s, s2)):
        raise AssertionError(f"[kernel] quantize {name}: two runs differ")
    del q2, s2
    n = x.shape[-1]
    xr, qr, sr = x.reshape(-1, n), q.reshape(-1, n), s.reshape(-1, s.shape[-1])
    nq = ns = 0
    err = 0.0
    for r in range(0, xr.shape[0], slab):
        rq, rs = qz._quantize_torch(xr[r:r + slab], bits, block, dtype)
        kq, ks = qr[r:r + slab], sr[r:r + slab]
        nq += int((kq.view(torch.uint8) != rq.view(torch.uint8)).sum())
        ns += int((ks != rs).sum())
        err = max(err, (qz._dequantize_torch(kq, ks, block)
                        - qz._dequantize_torch(rq, rs, block)).abs().max()
                  .item())
    if nq or ns:
        raise AssertionError(f"[kernel] quantize {name}: not bit-identical "
                             f"({nq} codes, {ns} scales differ; max |dequant "
                             f"diff| {err:.3g})")
    log(f"[kernel] quantize {name}: ok, bit-identical, the same over two "
        f"runs ({q.numel()} codes, {s.numel()} scales; max |dequant diff| "
        f"{err:.3g})")
    return err


def phase_kernel_quantize():
    gen = torch.Generator("cuda").manual_seed(11)
    max_err = 0.0
    routes = set()
    for name, shape, xdt, bits, dtype, block, zero, want, off in QUANT_CASES:
        numel = math.prod(shape)
        if numel + off <= 1 << 28:
            x = (torch.randn(numel + off, generator=gen, device="cuda")
                 * 3.0).to(xdt)
        else:                       # drawn in slabs: no fp32 copy of x
            x = torch.empty(numel + off, dtype=xdt, device="cuda")
            for i in range(0, numel + off, 1 << 28):
                m = min(1 << 28, numel + off - i)
                x[i:i + m] = torch.randn(m, generator=gen,
                                         device="cuda") * 3.0
        x = x[off:].view(shape)
        if zero is not None:
            r, g = zero
            x.reshape(-1, shape[-1])[r, g * block:(g + 1) * block] = 0.0
        route = qz.QUANT_ROUTES[qz.quant_route(shape[-1], block, xdt,
                                               x.data_ptr() % 16 == 0)]
        if route != qz.QUANT_ROUTES[want]:
            raise AssertionError(f"[kernel] quantize {name}: took {route}, "
                                 f"not {qz.QUANT_ROUTES[want]}")
        routes.add(route)
        max_err = max(max_err, check_quantize(f"{name} ({route})", x, bits,
                                               dtype, block))
        del x
    if routes != set(qz.QUANT_ROUTES):
        raise AssertionError(f"[kernel] quantize cases took routes "
                             f"{sorted(routes)}, not all of "
                             f"{qz.QUANT_ROUTES}")
    return max_err


# The dequantize kernel against _dequantize_torch, bit for bit (torch.equal):
# both compute one fp32 product an element and round it once to the output
# type. int8 codes from the quantize kernel (bits 4: unpacked codes in
# [-7, 7], what QuantTensor hands the kernel after unpack_int4).
DEQUANT_CASES = [
    # name, shape, bits, block, output dtypes, rows gathered as an index of
    # this shape (None: all)
    ("wq/wo [4096, 4096] int8", (4096, 4096), 8, 128, (torch.bfloat16,),
     None),
    ("wk/wv [4096, 1024] int8", (4096, 1024), 8, 128, (torch.bfloat16,),
     None),
    ("w_in [4096, 14336] int8", (4096, 14336), 8, 128,
     (torch.bfloat16, torch.float16, torch.float32), None),
    ("w_out [14336, 4096] int8", (14336, 4096), 8, 128, (torch.bfloat16,),
     None),
    ("lm_head [4096, 32000] int8", (4096, 32000), 8, 128,
     (torch.bfloat16, torch.float32), None),
    ("wq/wo [4096, 4096] int4 codes", (4096, 4096), 4, 128,
     (torch.bfloat16,), None),
    ("wk/wv [4096, 1024] int4 codes", (4096, 1024), 4, 128,
     (torch.bfloat16,), None),
    ("w_in [4096, 14336] int4 codes", (4096, 14336), 4, 128,
     (torch.bfloat16,), None),
    ("wte [32000, 4096] prefill gather [8, 4600]", (32000, 4096), 8, 128,
     (torch.bfloat16,), (8, 4600)),
    ("wte [32000, 4096] prefill gather [8, 4600] int4", (32000, 4096), 4,
     128, (torch.bfloat16,), (8, 4600)),
    ("wte [32000, 4096] 8-row gather", (32000, 4096), 8, 128,
     (torch.bfloat16, torch.float32), (8,)),
    ("wte [32000, 4096] 3-row gather int4", (32000, 4096), 4, 128,
     (torch.bfloat16, torch.float16), (3,)),
    ("norm row [4096]", (4096,), 8, 128, (torch.float32, torch.bfloat16),
     None),
    ("ragged last group, 37 rows", (37, 1000), 8, 128,
     (torch.bfloat16, torch.float16, torch.float32), None),
    ("3d [3, 5, 300] block 64 int4", (3, 5, 300), 4, 64,
     (torch.float32, torch.float16), None),
]


def phase_kernel_dequantize():
    gen = torch.Generator("cuda").manual_seed(13)
    n_cases, max_err = 0, 0.0
    for name, shape, bits, block, outs, rows in DEQUANT_CASES:
        w = torch.randn(shape, generator=gen, device="cuda") * 0.02
        q, s = qz.quantize_blockwise(w, bits=bits, block=block)
        del w
        if rows is not None:
            idx = torch.randint(0, shape[0], rows, generator=gen,
                                device="cuda")
            q, s = q[idx], s[idx]
        for dt in outs:
            out = qz.dequantize_cuda(q, s, block, dt)
            ref = qz._dequantize_torch(q, s, block, dt)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs().max().item()
            if out.dtype != dt or not torch.equal(out, ref):
                raise AssertionError(
                    f"[kernel] dequantize {name} -> {dt}: not bit-identical "
                    f"({int((out != ref).sum())} of {out.numel()} differ, "
                    f"max |diff| {diff:.3g})")
            max_err = max(max_err, diff)
            n_cases += 1
        log(f"[kernel] dequantize {name} (q {tuple(q.shape)}, scales "
            f"{tuple(s.shape)}) -> {[str(d).split('.')[-1] for d in outs]}: "
            "ok, bit-identical")
    # what the kernel does not take raises on a CUDA tensor
    q, s = qz.quantize_blockwise(torch.randn((8, 256), device="cuda"))
    f8, _ = qz.quantize_blockwise(torch.randn((8, 256), device="cuda"),
                                  dtype="fp8_e4m3")
    refused = [
        ("fp8 codes", lambda: qz.dequantize_blockwise(f8, s), TypeError),
        ("packed int4 (uint8)",
         lambda: qz.dequantize_blockwise(qz.pack_int4(q.clamp(-7, 7)), s,
                                         block=128), TypeError),
        ("mismatched scales", lambda: qz.dequantize_blockwise(
            q, s[:, :1], block=128), ValueError),
        ("fp64 scales", lambda: qz.dequantize_blockwise(q, s.double()),
         TypeError),
        ("float8 output", lambda: qz.dequantize_blockwise(
            q, s, dtype=torch.float8_e4m3fn), TypeError),
    ]
    for what, call, err in refused:
        try:
            call()
        except err:
            continue
        raise AssertionError(f"[kernel] dequantize took {what} on CUDA "
                             "tensors without raising")
    log(f"[kernel] dequantize: {n_cases} cases bit-identical (max |diff| "
        f"{max_err}); raises on {[w for w, _, _ in refused]}")
    return max_err


QMM_SHAPES = [(4096, 1024), (4096, 14336), (14336, 4096), (4096, 32000),
              (4096, 4096)]
QMM_CASES = (
    # x dtype, q dtype, M, K, N, block, out dtype[, elements by which x
    # starts past a 16-byte boundary]
    [(torch.bfloat16, "int8", M, K, N, 128, torch.bfloat16)
     for M in (1, 8, 37, 2048) for K, N in QMM_SHAPES]
    + [(torch.bfloat16, "fp8_e4m3", M, K, N, 128, torch.bfloat16)
       for M in (8, 2048) for K, N in QMM_SHAPES]
    + [(torch.float32, "int8", M, K, N, 128, torch.float32)
       for M in (1, 37) for K, N in QMM_SHAPES[:3:2]]
    + [(torch.float32, "fp8_e4m3", M, 4096, 1024, 128, torch.float32)
       for M in (8, 2048)]
    # the wgmma route's edges: M not a multiple of its 256-row tile, fp32
    # out; then two shapes that keep the mma.sync route (N % 64 != 0, block
    # 48)
    + [(torch.bfloat16, "int8", 2000, 4096, 14336, 128, torch.bfloat16),
       (torch.bfloat16, "fp8_e4m3", 2000, 4096, 1024, 128, torch.bfloat16),
       (torch.bfloat16, "int8", 2048, 4096, 4096, 128, torch.float32),
       (torch.bfloat16, "fp8_e4m3", 2048, 4096, 32000, 128, torch.float32),
       (torch.bfloat16, "int8", 2048, 4096, 4100, 128, torch.bfloat16),
       (torch.bfloat16, "int8", 512, 1024, 1536, 48, torch.bfloat16)]
    + [(torch.bfloat16, "int8", 37, 100, 200, 128, torch.bfloat16),
       (torch.float32, "fp8_e4m3", 5, 4160, 4160, 128, torch.float32),
       (torch.bfloat16, "int8", 300, 77, 130, 64, torch.float32),
       (torch.bfloat16, "fp8_e4m3", 8, 4096, 4100, 96, torch.bfloat16),
       (torch.bfloat16, "int8", 3, 300, 130, 50, torch.bfloat16),
       (torch.bfloat16, "int8", 16, 4096, 1024, 128, torch.bfloat16),
       (torch.bfloat16, "fp8_e4m3", 2, 1000, 520, 128, torch.float32),
       (torch.float32, "int8", 1500, 512, 384, 128, torch.float32)])
# the tensor-core decode route at every serving shape: M = 1, 8 and 16, int8
# and fp8, bf16 and fp32 out (the cases above not repeated); its edges:
# block 64, block 192 (the two 64-column halves of a strip in different
# groups), N = 4160 (a last strip of 64 columns) with K = 4160 (K slices of
# unequal length), K = 64 (most of a cluster's blocks without K rows), M = 5
# and 12; then an unaligned x, which keeps the weight-streaming kernel
QMM_CASES += [c for c in ((torch.bfloat16, qdt, M, K, N, 128, odt)
                          for qdt in ("int8", "fp8_e4m3") for M in (1, 8, 16)
                          for odt in (torch.bfloat16, torch.float32)
                          for K, N in QMM_SHAPES)
              if c not in QMM_CASES]
QMM_CASES += [
    (torch.bfloat16, "int8", 8, 4096, 14336, 64, torch.bfloat16),
    (torch.bfloat16, "fp8_e4m3", 12, 4096, 4224, 192, torch.float32),
    (torch.bfloat16, "int8", 5, 4160, 4160, 64, torch.bfloat16),
    (torch.bfloat16, "int8", 3, 64, 1024, 64, torch.bfloat16),
    (torch.bfloat16, "int8", 8, 4096, 4096, 128, torch.bfloat16, 1)]


# speculative verify puts at the serving shapes: M = 8 rows x 4 tokens and
# 8 x 5, int8 and fp8, on the wgmma route (a partial 128- or 256-row tile)
QMM_VERIFY_CASES = [(torch.bfloat16, qdt, M, K, N, 128, torch.bfloat16)
                    for qdt in ("int8", "fp8_e4m3") for M in (32, 40)
                    for K, N in QMM_SHAPES]
QMM_CASES += QMM_VERIFY_CASES


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
    return err, scale, out


def qmm_route_name(x, q, block):
    K, N = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    aligned = x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    return qz.QMM_ROUTES[qz.qmm_route(x.numel() // K, N, K, block, x.dtype,
                                      aligned, sms)]


def phase_kernel_qmm():
    gen = torch.Generator("cuda").manual_seed(12)
    max_err = 0.0
    routes = set()
    n_decode = 0
    for xdt, qdt, M, K, N, block, odt, *rest in QMM_CASES:
        off = rest[0] if rest else 0
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        q, s = qz.quantize_blockwise(w, block=block, dtype=qdt)
        del w
        x = torch.randn((M * K + off,), generator=gen, device="cuda").to(
            xdt)[off:].view(M, K)
        label = (f"x {str(xdt).split('.')[-1]} {qdt} M={M} K={K} N={N} "
                 f"B={block} -> {str(odt).split('.')[-1]}"
                 + (f", x {off} element off 16 bytes" if off else ""))
        err, scale, out = check_qmm(x, q, s, block, odt, label)
        if xdt == torch.bfloat16 and odt == torch.bfloat16:
            max_err = max(max_err, err)
        route = qmm_route_name(x, q, block)
        routes.add(route)
        # what each decode case must take: the tensor-core route for bf16 x
        # at widths that are multiples of 64, the weight-streaming kernel
        # for an unaligned x
        want = None
        if off:
            want = "qmm_gemv_kernel"
        elif (xdt == torch.bfloat16 and M <= 16 and N % 64 == 0
              and K % 64 == 0 and block % 64 == 0):
            want = "qmm_decode_tc_kernel"
        elif ((xdt, qdt, M, K, N, block, odt) in QMM_VERIFY_CASES
              and not route.startswith("qmm_wgmma_kernel")):
            raise AssertionError(f"[kernel] qmm {label}: took {route}, not "
                                 "the wgmma route")
        if want is not None and route != want:
            raise AssertionError(f"[kernel] qmm {label}: took {route}, not "
                                 f"{want}")
        if route == "qmm_decode_tc_kernel":
            again = qz.quantized_matmul(x, q, s, block=block, out_dtype=odt)
            if not torch.equal(out, again):
                raise AssertionError(f"[kernel] qmm {label}: two runs "
                                     "differ")
            n_decode += 1
        log(f"[kernel] qmm {label}: ok, max |kernel - plain| = {err:.3g} "
            f"(max |ref| {scale:.3g}; {route})")
    if routes != set(qz.QMM_ROUTES):
        raise AssertionError(f"[kernel] qmm cases took routes "
                             f"{sorted(routes)}, not all of {qz.QMM_ROUTES}")
    log(f"[kernel] qmm: {n_decode} cases on qmm_decode_tc_kernel, each "
        "bit-identical over two runs")
    return max_err


# Flash attention (forward, delta, dq, dkv) against the plain versions. For
# bf16 and fp16 inputs the plain versions work in fp32 arithmetic on the same
# values (the inputs cast up), so that what is compared is the kernel's own
# error, not two sets of half-precision roundings. The measure is relative
# to the row: over each row of D values, max |k - ref| <= rel * max |ref| +
# atol, with o, dq [B, T, H, D] and dk, dv [B, S, KH, D]. An absolute limit
# cannot do this: |o| and |dq| fall as 1 / sqrt(columns attended), to a few
# hundredths on the late rows of a long sequence. rel: fp32 differs by
# summation order only; bf16 rounds p, ds and each output once (2^-9
# relative each, the roundings of a row's thousands of terms largely
# cancel), so 4 * 2^-8 is a few roundings; fp16 the same at 2^-11. atol
# covers rows that are zero but for fp32 cancellation (window 1: dp = delta,
# so dq = dk = 0). lse and delta are fp32 sums of exact products of the same
# values in every case: |k - ref| <= STAT_TOL * (1 + |ref|).
FLASH_TOL = {torch.bfloat16: (4 * 2.0 ** -8, 2e-4),
             torch.float16: (4 * 2.0 ** -11, 2e-4),
             torch.float32: (1e-4, 2e-5)}
STAT_TOL = 1e-4
FLASH_CASES = [
    # name, B, T, S, H, KH, D, causal, window, sm_scale
    ("MHA 4/4 D=64 causal", 1, 256, 256, 4, 4, 64, True, 0, None),
    ("GQA 8/2 D=128 causal", 1, 384, 384, 8, 2, 128, True, 0, None),
    ("MQA 8/1 D=128 causal B=2", 2, 200, 200, 8, 1, 128, True, 0, None),
    ("GQA 8/2 D=80 causal", 1, 300, 300, 8, 2, 80, True, 0, None),
    ("GQA 8/2 D=128 causal T<S", 1, 100, 333, 8, 2, 128, True, 0, None),
    ("MHA 4/4 D=64 non-causal T!=S", 2, 150, 260, 4, 4, 64, False, 0, None),
    ("GQA 8/2 D=128 window 1", 1, 256, 256, 8, 2, 128, True, 1, None),
    ("GQA 8/2 D=128 window 64", 1, 512, 512, 8, 2, 128, True, 64, None),
    ("GQA 8/2 D=64 window 64 T<S", 1, 130, 400, 8, 2, 64, True, 64, None),
    ("MQA 8/1 D=64 window > S", 1, 256, 256, 8, 1, 64, True, 1000, None),
    ("GQA 8/2 D=128 T=S=2047", 1, 2047, 2047, 8, 2, 128, True, 0, None),
    ("GQA 8/2 D=128 T=S=2047 window 512", 1, 2047, 2047, 8, 2, 128, True,
     512, None),
    ("MHA 4/4 D=64 T=S=129", 1, 129, 129, 4, 4, 64, True, 0, None),
    ("GQA 8/2 D=128 T=S=129 sm_scale=1", 2, 129, 129, 8, 2, 128, True, 0,
     1.0),
    ("MHA 4/4 D=256 causal", 1, 200, 200, 4, 4, 256, True, 0, None),
    # the edges of the wgmma kernels' 128-row blocks and 64-row tiles: a
    # sequence one short of and one past two blocks with a window across
    # them, T < S with a window across a block of KV rows, dkv's group loop
    # over a single KV head at D = 64, and the timing phase's shape
    ("GQA 8/2 D=128 T=S=255 window 129", 1, 255, 255, 8, 2, 128, True, 129,
     None),
    ("GQA 8/2 D=128 T=S=257 window 129", 1, 257, 257, 8, 2, 128, True, 129,
     None),
    ("GQA 8/2 D=128 window 150 T<S", 1, 200, 450, 8, 2, 128, True, 150,
     None),
    ("MQA 8/1 D=64 causal", 1, 300, 300, 8, 1, 64, True, 0, None),
    ("timing shape B=4 T=S=2048 H=32 KH=8 D=128 causal", 4, 2048, 2048, 32,
     8, 128, True, 0, None),
]
# What every layer of the train phase gives the kernels, in bf16: T =
# TRAIN_SEQ - 1; 128 tiles of 64 rows a head, of which the window leaves
# the first ones dead for the late rows.
FLASH_TRAIN_CASE = ("training shape B=1 T=S=8192 H=32 KH=8 D=128 window 4096",
                    1, 8192, 8192, 32, 8, 128, True, 4096, None)
# What every layer of the v1 phase's prefill gives the forward kernel, in
# bf16: the 8 prompts right-padded to the longest (4600, a 56-row last tile
# of 64); the window bites from row 4096 on. Forward only: v1 runs no
# backward.
FLASH_V1_CASE = ("v1 prefill shape B=8 T=S=4600 H=32 KH=8 D=128 window 4096",
                 8, 4600, 4600, 32, 8, 128, True, 4096, None)
assert FLASH_V1_CASE[1:3] == (len(MAIN_PROMPT_LENS), max(MAIN_PROMPT_LENS))


def close(name, what, got, ref, dtype):
    """Hold ``got`` to ``ref`` by the row-relative measure above (4-d) or by
    STAT_TOL (the [B, H, T] row statistics). Returns (max |diff|, the worst
    row's share of what it is allowed)."""
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"[kernel] flash {name}: non-finite {what}")
    d = (g - r).abs()
    if g.dim() == 4:
        rel, atol = FLASH_TOL[dtype]
        share = (d.amax(-1) / (rel * r.abs().amax(-1) + atol)).max().item()
        limit = f"{rel:.3g} of the row's max |ref| + {atol}"
    else:
        share = (d / (STAT_TOL * (1 + r.abs()))).max().item()
        limit = f"{STAT_TOL} * (1 + |ref|)"
    err = d.max().item()
    if not share <= 1.0:
        raise AssertionError(f"[kernel] flash {name}: {what} max |diff| "
                             f"{err:.3g}, {share:.3g} times the limit "
                             f"({limit})")
    return err, share


def kv_head_part(t, kh, KH):
    """KV head ``kh``'s heads (its own, or its group of query heads) of a
    [B, T, heads, D] or [B, heads, T] tensor, as a view."""
    dim = 2 if t.dim() == 4 else 1
    g = t.shape[dim] // KH
    return t.narrow(dim, kh * g, g)


def flash_against_plain(name, q, k, v, do, causal, window, sm_scale,
                        backward=True):
    """Launch the forward, delta, dq and dkv kernels on these inputs and
    hold o, lse, delta, dq, dk and dv to the plain versions (the backward
    ones fed the forward kernel's o and lse), one KV head's group of query
    heads at a time so that the plain versions' dense fp32 [G, T, S]
    intermediates fit at any shape the card trains on. The forward, dq and
    dkv run twice and must give the same bits. ``backward`` False: the
    forward alone. Returns {kernel: (max |diff|, worst share of the
    limit)}."""
    dtype, KH = q.dtype, k.shape[2]
    args = (causal, window, sm_scale)
    o, lse = fa.flash_fwd_cuda(q, k, v, *args)
    o2, lse2 = fa.flash_fwd_cuda(q, k, v, *args)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"[kernel] flash {name}: two runs of the "
                             "forward on the same inputs differ")
    del o2, lse2
    worst = {"fwd": (0.0, 0.0)}
    if backward:
        delta = fa.flash_delta_cuda(o, do)
        dq = fa.flash_dq_cuda(q, k, v, do, lse, delta, *args)
        dk, dv = fa.flash_dkv_cuda(q, k, v, do, lse, delta, *args)
        dq2 = fa.flash_dq_cuda(q, k, v, do, lse, delta, *args)
        dk2, dv2 = fa.flash_dkv_cuda(q, k, v, do, lse, delta, *args)
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            raise AssertionError(f"[kernel] flash {name}: two runs of dq "
                                 "or dkv on the same inputs differ")
        del dq2, dk2, dv2
        worst.update(dq=(0.0, 0.0), dkv=(0.0, 0.0))

    def hold(key, what, got, ref):
        worst[key] = tuple(map(max, worst[key],
                               close(name, what, got, ref, dtype)))

    for kh in range(KH):
        part = functools.partial(kv_head_part, kh=kh, KH=KH)
        qf, kf, vf, of, dof = (part(t).float() for t in (q, k, v, o, do))
        ro, rlse = fa._attention_torch(qf, kf, vf, *args)
        hold("fwd", "o", part(o), ro)
        hold("fwd", "lse", part(lse), rlse)
        del ro, rlse
        if not backward:
            continue
        hold("dq", "delta", part(delta), (dof * of).sum(-1).permute(0, 2, 1))
        rdq = fa._dq_torch(qf, kf, vf, of, dof, part(lse), *args)
        hold("dq", "dq", part(dq), rdq)
        del rdq
        rdk, rdv = fa._dkv_torch(qf, kf, vf, of, dof, part(lse), *args)
        hold("dkv", "dk", part(dk), rdk)
        hold("dkv", "dv", part(dv), rdv)
        del rdk, rdv
    return worst


def check_flash(name, B, T, S, H, KH, D, causal, window, sm_scale, dtype,
                gen, backward=True, routes=None):
    """One case against the plain versions; its route (``fa.flash_route``,
    the kernels the C entries launched) is logged and, given ``routes``,
    recorded there under (name, dtype)."""
    route = fa.flash_route(dtype, D, sm_scale)
    if routes is not None:
        routes[(name, dtype)] = route
    mk = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device="cuda").to(dtype)
    q, k, v, do = mk(B, T, H, D), mk(B, S, KH, D), mk(B, S, KH, D), \
        mk(B, T, H, D)
    if sm_scale is not None:
        # keep the logits at a few units, as 1 / sqrt(D) would
        q = (q.float() / (sm_scale * math.sqrt(D))).to(dtype)
        do = (do.float() / (sm_scale * math.sqrt(D))).to(dtype)
    worst = flash_against_plain(name, q, k, v, do, causal, window, sm_scale,
                                backward)
    log(f"[kernel] flash {name} {str(dtype).split('.')[-1]} ({route}): ok, "
        f"max |kernel - plain| (share of the limit) " + ", ".join(
            f"{key} {e:.3g} ({sh:.2f})" for key, (e, sh) in worst.items()))
    return worst


def check_flash_autograd(name, B, T, S, H, KH, D, causal, window, sm_scale,
                         gen):
    """The Function's gradients on the card (forward, delta, dq and dkv
    kernels wired through autograd) against autograd through the plain
    forward, fp32."""
    mk = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device="cuda")
    q, k, v, do = mk(B, T, H, D), mk(B, S, KH, D), mk(B, S, KH, D), \
        mk(B, T, H, D)
    grads = {}
    for mode in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if mode == "kernel":
            out = fa.flash_attention(*leaves, causal=causal, window=window,
                                     sm_scale=sm_scale)
        else:
            out, _ = fa._attention_torch(*leaves, causal, window, sm_scale)
        out.backward(do)
        grads[mode] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    errs = [close(name, f"autograd d{n}", g, r, torch.float32)[0]
            for n, g, r in zip("qkv", grads["kernel"], grads["plain"])]
    log(f"[kernel] flash {name}: Function gradients equal autograd through "
        f"the plain forward, max |diff| dq {errs[0]:.3g}, dk {errs[1]:.3g}, "
        f"dv {errs[2]:.3g} (fp32)")


def phase_kernel_flash():
    """Every case against the plain versions; the errors reported for the
    three kernels are those at the shapes of the main paths: the training
    shape, and the v1 prefill's for the forward."""
    gen = torch.Generator("cuda").manual_seed(13)
    n0 = dict(fa.launches)
    routes = {}
    for case in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            check_flash(*case, dtype, gen, routes=routes)
        if case in FLASH_CASES[1::3]:
            check_flash(*case, torch.float16, gen, routes=routes)
    worst = check_flash(*FLASH_TRAIN_CASE, torch.bfloat16, gen,
                        routes=routes)
    max_err = {key: e for key, (e, _) in worst.items()}
    v1 = check_flash(*FLASH_V1_CASE, torch.bfloat16, gen, backward=False,
                     routes=routes)
    # bf16 at D = 64/128 (every case's scale is positive) on the wgmma
    # kernels, fp32, fp16 and other D on the CUDA-core kernels
    cases = {c[0]: c for c in FLASH_CASES + [FLASH_TRAIN_CASE, FLASH_V1_CASE]}
    for (name, dtype), route in routes.items():
        want = "wgmma" if dtype == torch.bfloat16 \
            and cases[name][6] in (64, 128) else "cuda_core"
        if route != want:
            raise AssertionError(f"[kernel] flash {name} {dtype}: took "
                                 f"{route}, not {want}")
    if set(routes.values()) != set(fa.FLASH_ROUTES):
        raise AssertionError(f"[kernel] flash cases took routes "
                             f"{sorted(set(routes.values()))}, not all of "
                             f"{fa.FLASH_ROUTES}")
    log(f"[kernel] flash: {len(routes)} cases, each on its route "
        f"(wgmma for bf16 at D = 64/128, cuda_core for the rest)")
    max_err["fwd"] = max(max_err["fwd"], v1["fwd"][0])
    for case in (FLASH_CASES[1], FLASH_CASES[4], FLASH_CASES[5],
                 FLASH_CASES[7], FLASH_CASES[12]):
        check_flash_autograd(*case, gen)
    # what the kernels do not take raises on a CUDA tensor
    q = torch.zeros((1, 8, 2, 12), device="cuda")
    for bad, exc in (((q, q, q, True), ValueError),            # D % 8
                     ((q.half(), q.half(), q.half(), True), (TypeError,
                                                             ValueError)),
                     ((q[..., :8], q[..., :8], q[..., :8], False, 512, 512,
                       4), ValueError)):          # window without causal
        try:
            fa.flash_attention(*bad)
        except exc:
            continue
        raise AssertionError(f"[kernel] flash: no error for {bad[3:]} on "
                             f"{bad[0].dtype} D={bad[0].shape[-1]}")
    log(f"[kernel] flash: launches in this phase "
        f"{ {k: fa.launches[k] - n0[k] for k in n0} }")
    return max_err


def phase_kernel():
    paged = phase_kernel_paged()
    flash = phase_kernel_flash()
    return {"paged_attention": paged["bf16"],
            "paged_attention_quant": paged["quant"],
            "quantize": phase_kernel_quantize(),
            "quantized_matmul": phase_kernel_qmm(),
            "dequantize": phase_kernel_dequantize(),
            "flash_fwd": flash["fwd"], "flash_dq": flash["dq"],
            "flash_dkv": flash["dkv"]}


# ---------------------------------------------------------------- timing

# device cycles the stream idles before each timed call (about 0.5 ms):
# the host enqueues the call meanwhile, so that the events bracket the
# device's work and not the wrapper's Python time
HOST_LEAD_CYCLES = 1_000_000


def time_ms(fn, flush, iters=20, warmup=3):
    """Median CUDA-event time of one call, L2 flushed before each call. A
    device-side wait (``torch.cuda._sleep``) between the flush and the
    start event lets the host enqueue the call ahead of the device, so a
    call whose kernels take less time than its Python wrapper is timed by
    its kernels (a plain version of many small ops may still be host-bound:
    it is no yardstick of speed)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
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


def bound(q, kp, tbl, sp, nt, window, dup_blocks=0):
    """Least time the card could take: the larger of the bytes the function
    must move (q read, o written, each live K/V position read once — with
    its block's two scales for a quantized pool — the tables and lengths;
    ``dup_blocks`` live blocks that two rows share counted once) over HBM
    bandwidth, and its flops (QK and PV over each row's live positions)
    over the bf16 tensor-core peak (the timed q is bf16)."""
    N, C, H, D = q.shape
    KH, bs = kp.shape[1], kp.shape[2]
    item = q.element_size()
    rows, seqs = live_spans(sp.tolist(), nt.tolist(), C, window)
    kv_bytes = (sum(seqs) - dup_blocks * bs) * KH * D * kp.element_size() * 2
    if kp.element_size() == 1:
        kv_bytes += (sum(-(-s // bs) for s in seqs) - dup_blocks) * KH * 4 * 2
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


def timing_case(label, ctxs, C, window, flush, seed=7, kv_dtype=None,
                chunks=None, shared=0):
    q, kp, vp, tbl, sp, nt = make_case(seed, ctxs, C, 32, 8, 128, 16,
                                       torch.bfloat16, chunks=chunks)
    if shared:
        tbl = share_first_blocks(tbl, shared)
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
    b_ms, by = bound(q, kp, tbl, sp, nt, window,
                     dup_blocks=8 * max(0, shared - 1))
    row = {"case": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": by, "library_ms": lib_ms}
    log(f"[timing] paged_attention {json.dumps(row)} "
        f"({paged_route_name(q, kp)})")
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
    log(f"[timing] quantized_matmul {json.dumps(row)} "
        f"({qmm_route_name(x, q, block)})")
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


def dequant_bytes(elements, groups, out_item):
    """Bytes a dequantization must move: each int8 code read once, each
    f32 scale read once, each output written once."""
    return elements * (1 + out_item) + groups * 4


def dequantize_timing_case(label, rows, n, flush, block=128,
                           dtype=torch.bfloat16):
    gen = torch.Generator("cuda").manual_seed(rows + n)
    q, s = qz.quantize_blockwise(
        torch.randn((rows, n), generator=gen, device="cuda") * 0.02,
        block=block)
    ms = time_ms(lambda: qz.dequantize_cuda(q, s, block, dtype), flush)
    plain_ms = time_ms(lambda: qz._dequantize_torch(q, s, block, dtype),
                       flush, iters=5, warmup=1)
    nbytes = dequant_bytes(q.numel(), s.numel(), dtype.itemsize)
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    # one fp32 product an element on the CUDA cores
    f_ms = q.numel() / PEAK_FP32_FLOPS * 1e3
    row = {"case": label, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(b_ms, f_ms),
           "bound_by": "bytes" if b_ms >= f_ms else "operations",
           "library_ms": None, "bytes": nbytes}
    log(f"[timing] dequantize {json.dumps(row)}")
    return row


def flash_pairs(T, S, causal, window):
    """Attended (row, column) pairs of one head."""
    offs = S - T
    total = 0
    for r in range(T):
        hi = min(S - 1, r + offs) if causal else S - 1
        lo = max(0, r + offs - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_bounds(B, T, S, H, KH, D, causal, window, item):
    """Least times the card could take for forward, dq (with its delta
    pre-pass) and dkv: the larger of the bytes each must move (inputs read
    once, outputs written once) over HBM bandwidth and its flops (2 per
    multiply-add: 2, 3 and 4 products of D over each attended pair) over
    the bf16 tensor-core peak (the timed tensors are bf16)."""
    pairs = flash_pairs(T, S, causal, window) * B * H
    qb, kvb = B * T * H * D * item, B * S * KH * D * item
    stat = B * H * T * 4
    work = {
        "fwd": (2 * qb + 2 * kvb + stat, 4 * D * pairs),
        # q, k, v, o, do, lse read; delta written and read; dq written
        "dq": (4 * qb + 2 * kvb + 3 * stat, 6 * D * pairs),
        # q, k, v, do, lse, delta read; dk, dv written
        "dkv": (2 * qb + 4 * kvb + 2 * stat, 8 * D * pairs),
    }
    out = {}
    for key, (nbytes, flops) in work.items():
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        f_ms = flops / PEAK_BF16_FLOPS * 1e3
        out[key] = (max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations")
    return out


def sdpa_library(q, k, v, causal, window, backward=True):
    """The same attention as one PyTorch library call (timed only; never
    used by the port): heads first, GQA heads repeated (made untimed),
    ``is_causal`` where there is no window and a boolean band mask where
    there is. Returns (forward call, backward call through autograd, or
    None when ``backward`` is False)."""
    H, KH = q.shape[2], k.shape[2]
    T, S = q.shape[1], k.shape[1]
    qh = q.permute(0, 2, 1, 3).contiguous().requires_grad_(backward)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(H // KH, dim=1) \
        .contiguous().requires_grad_(backward)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(H // KH, dim=1) \
        .contiguous().requires_grad_(backward)
    kw = {}
    if window and window < S:
        keep = fa._keep_mask(T, S, causal, window, q.device)
        kw["attn_mask"] = keep
    elif causal:
        if T != S:
            kw["attn_mask"] = fa._keep_mask(T, S, True, 0, q.device)
        else:
            kw["is_causal"] = True
    F = torch.nn.functional

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, **kw)

    if not backward:
        return fwd, None
    out = fwd()
    do = torch.randn_like(out)

    def bwd():
        return torch.autograd.grad(out, (qh, kh, vh), do, retain_graph=True)

    return fwd, bwd


def flash_timing_case(label, B, T, H, KH, D, window, flush, backward=True):
    """Forward, dq (delta pre-pass included) and dkv at one shape, bf16,
    causal, T = S. The plain versions run on the same inputs one KV head's
    group of query heads at a time (their dense [G, T, S] logits of all
    heads at once do not fit at T = 8192); their time is that of all KH
    calls. ``backward`` False: the forward alone."""
    gen = torch.Generator("cuda").manual_seed(T + H)
    mk = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
    q, k, v, do = mk(B, T, H, D), mk(B, T, KH, D), mk(B, T, KH, D), \
        mk(B, T, H, D)
    args = (True, window, None)
    o, lse = fa.flash_fwd_cuda(q, k, v, *args)
    ms = {"fwd": time_ms(lambda: fa.flash_fwd_cuda(q, k, v, *args), flush,
                         iters=5, warmup=1)}
    if backward:
        delta = fa.flash_delta_cuda(o, do)
        ms["dq"] = time_ms(lambda: fa.flash_dq_cuda(
            q, k, v, do, lse, fa.flash_delta_cuda(o, do), *args), flush,
            iters=5, warmup=1)
        ms["dkv"] = time_ms(lambda: fa.flash_dkv_cuda(
            q, k, v, do, lse, delta, *args), flush, iters=5, warmup=1)
    groups = [[kv_head_part(t, kh, KH).contiguous()
               for t in (q, k, v, o, do, lse)] for kh in range(KH)]

    def plain_fwd():
        for pq, pk, pv, _, _, _ in groups:
            fa._attention_torch(pq, pk, pv, *args)

    def plain_dq():
        for g in groups:
            fa._dq_torch(*g, *args)

    def plain_dkv():
        for g in groups:
            fa._dkv_torch(*g, *args)

    plain = {key: time_ms(fn, flush, iters=3, warmup=1)
             for key, fn in (("fwd", plain_fwd), ("dq", plain_dq),
                             ("dkv", plain_dkv)) if key in ms}
    del groups
    lib_fwd, lib_bwd = sdpa_library(q, k, v, True, window, backward)
    lib = {"fwd": time_ms(lib_fwd, flush, iters=5, warmup=1)}
    if backward:
        lib["dq"] = lib["dkv"] = time_ms(lib_bwd, flush, iters=5, warmup=1)
    del lib_fwd, lib_bwd
    bounds = flash_bounds(B, T, T, H, KH, D, True, window, 2)
    rows = {}
    for key in ms:
        note = label + f"; plain version as {KH} calls, one KV head each"
        if key != "fwd":
            note += "; library = autograd through SDPA (dq, dk, dv at once)"
        rows[f"flash_{key}"] = {
            "case": note, "ms": ms[key], "plain_ms": plain[key],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": lib[key]}
        log(f"[timing] flash_{key} {json.dumps(rows[f'flash_{key}'])}")
    return rows


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
    timing_case("mixed put C=256: one chunk at 3840-4095 and 7 decode rows "
                "(n_tokens 1), window 4096", MIXED_CTX, 256, 4096, flush,
                chunks=MIXED_CHUNKS)
    timing_case("mixed put C=256, int8 pools", MIXED_CTX, 256, 4096, flush,
                kv_dtype=torch.int8, chunks=MIXED_CHUNKS)
    for name, ctxs, C, chunks, _, shared in FEATURE_CASES:
        timing_case(name + ", window 4096", ctxs, C, 4096, flush,
                    chunks=chunks, shared=shared)
    timing_case(FEATURE_CASES[0][0] + ", int8 pools", FEATURE_CASES[0][1], 4,
                4096, flush, kv_dtype=torch.int8, chunks=FEATURE_CASES[0][3])
    rows["paged_attention_quant"] = timing_case(
        head + ", int8 pools", main_ctx, 1, 4096, flush,
        kv_dtype=torch.int8)
    timing_case(head + ", fp8 pools", main_ctx, 1, 4096, flush,
                kv_dtype=torch.float8_e4m3fn)
    rows["quantized_matmul"] = qmm_timing_case(
        "w_in [4096, 14336] int8, decode M=8", 8, 4096, 14336, flush)
    for label, K, N in (("wq/wo [4096, 4096]", 4096, 4096),
                        ("wk/wv [4096, 1024]", 4096, 1024),
                        ("w_out [14336, 4096]", 14336, 4096)):
        qmm_timing_case(f"{label} int8, decode M=8", 8, K, N, flush)
    qmm_timing_case("w_in [4096, 14336] int8, mixed put M=2048", 2048, 4096,
                    14336, flush)
    qmm_timing_case("w_in [4096, 14336] fp8, mixed put M=2048", 2048, 4096,
                    14336, flush, qdt="fp8_e4m3")
    qmm_timing_case("wk [4096, 1024] int8, mixed put M=2048", 2048, 4096,
                    1024, flush)
    qmm_timing_case("lm_head [4096, 32000] int8, M=8", 8, 4096, 32000, flush)
    for M in (32, 40, 64):      # verify puts: 8 rows x 4, 5 and 8 tokens
        qmm_timing_case(f"w_in [4096, 14336] int8, verify M={M}", M, 4096,
                        14336, flush)
        qmm_timing_case(f"lm_head [4096, 32000] int8, verify M={M}", M,
                        4096, 32000, flush)
    qmm_timing_case("w_in [4096, 14336] fp8, decode M=8", 8, 4096, 14336,
                    flush, qdt="fp8_e4m3")
    rows["quantize"] = quantize_timing_case(
        "engine build: stacked w_in [32*4096, 14336] bf16 -> int8",
        32 * 4096, 14336, flush)
    rows["dequantize"] = dequantize_timing_case(
        "v1 w_in [4096, 14336] int8 -> bf16", 4096, 14336, flush)
    dequantize_timing_case("v1 lm_head [4096, 32000] int8 -> bf16", 4096,
                           32000, flush)
    dequantize_timing_case("v1 norm row [4096] int8 -> fp32", 1, 4096,
                           flush, dtype=torch.float32)
    gc.collect()
    torch.cuda.empty_cache()
    name, B, T, _, H, KH, D, _, window, _ = FLASH_TRAIN_CASE
    rows.update(flash_timing_case(name + " bf16", B, T, H, KH, D, window,
                                  flush))
    flash_timing_case("B=4 T=S=2048 H=32 KH=8 D=128 window 4096 (no bite) "
                      "bf16", 4, 2048, 32, 8, 128, 4096, flush)
    gc.collect()
    torch.cuda.empty_cache()
    name, B, T, _, H, KH, D, _, window, _ = FLASH_V1_CASE
    flash_timing_case(name + " bf16, forward only", B, T, H, KH, D, window,
                      flush, backward=False)
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_compare():
    """The main path's attention, quantized-matmul (every decode projection
    and the mixed put's) and quantize shapes timed through the wrappers'
    entry points alone (``paged_attention_cuda``,
    ``quantized_matmul_cuda``, ``quantize_cuda``, ``flash_fwd_cuda``,
    ``flash_dq_cuda``, ``flash_dkv_cuda``), which every checkout of
    the port since its training slice has: copied into another checkout
    and run there with ``--compare``, this script times that checkout's
    kernels on the same inputs, so that two commits can be compared in one
    call (parent, change, change, parent)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    main_ctx = [n + MAIN_NEW_TOKENS - 1 for n in MAIN_PROMPT_LENS]
    n32 = [int(c) for c in np.linspace(512, 2048, 32)]
    paged = [("decode N=8, main-path contexts", main_ctx, 1, None, None),
             ("decode N=8, main-path contexts, int8 pools", main_ctx, 1,
              None, torch.int8),
             ("decode N=8, main-path contexts, fp8 pools", main_ctx, 1,
              None, torch.float8_e4m3fn),
             ("decode N=32, contexts 512-2048", n32, 1, None, None),
             ("prefill chunk C=256 at 3840-4095", [4096], 256, None, None),
             ("mixed put C=256", MIXED_CTX, 256, MIXED_CHUNKS, None),
             ("mixed put C=256, int8 pools", MIXED_CTX, 256, MIXED_CHUNKS,
              torch.int8)]
    for label, ctxs, C, chunks, kvd in paged:
        q, kp, vp, tbl, sp, nt = make_case(7, ctxs, C, 32, 8, 128, 16,
                                           torch.bfloat16, chunks=chunks)
        kw = dict(window=4096)
        if kvd is not None:
            kp, ks = quantize_pool(kp, kvd)
            vp, vs = quantize_pool(vp, kvd)
            kw.update(k_scale=ks, v_scale=vs)
        ms = time_ms(lambda: pa.paged_attention_cuda(q, kp, vp, tbl, sp, nt,
                                                     **kw), flush)
        log(f"[compare] paged_attention {label}: {ms:.4f} ms")
    gen = torch.Generator("cuda").manual_seed(3)
    for label, M, K, N, qdt in (("w_in int8 M=8", 8, 4096, 14336, "int8"),
                                ("w_in fp8 M=8", 8, 4096, 14336, "fp8_e4m3"),
                                ("wq/wo int8 M=8", 8, 4096, 4096, "int8"),
                                ("wk/wv int8 M=8", 8, 4096, 1024, "int8"),
                                ("w_out int8 M=8", 8, 14336, 4096, "int8"),
                                ("lm_head int8 M=8", 8, 4096, 32000, "int8"),
                                ("w_in int8 M=2048", 2048, 4096, 14336,
                                 "int8"),
                                ("w_in fp8 M=2048", 2048, 4096, 14336,
                                 "fp8_e4m3"),
                                ("wk int8 M=2048", 2048, 4096, 1024, "int8")):
        q, s = qz.quantize_blockwise(
            torch.randn((K, N), generator=gen, device="cuda") * 0.02,
            block=128, dtype=qdt)
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        ms = time_ms(lambda: qz.quantized_matmul_cuda(x, q, s, 128,
                                                      torch.bfloat16), flush)
        log(f"[compare] quantized_matmul {label}: {ms:.4f} ms")
    del q, s, x
    rows, n = 32 * 4096, 14336          # the serving build's stacked w_in
    x = torch.empty((rows, n), dtype=torch.bfloat16, device="cuda")
    for i in range(0, rows, 4096):
        x[i:i + 4096] = torch.randn((4096, n), generator=gen,
                                    device="cuda") * 0.02
    ms = time_ms(lambda: qz.quantize_cuda(x, 8, 128), flush, iters=10)
    log(f"[compare] quantize [32*4096, 14336] bf16 -> int8: {ms:.4f} ms")
    del x
    mk = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                    device="cuda").to(torch.bfloat16)
    for label, B, T, window, backward in (
            ("B=1 T=S=8192 window 4096 (training)", 1, 8192, 4096, True),
            ("B=4 T=S=2048 causal", 4, 2048, 4096, True),
            ("B=8 T=S=4600 window 4096 (v1 prefill)", 8, 4600, 4096, False)):
        q, k, v = mk(B, T, 32, 128), mk(B, T, 8, 128), mk(B, T, 8, 128)
        ms = time_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, window), flush,
                     iters=5, warmup=1)
        log(f"[compare] flash_fwd {label}: {ms:.4f} ms")
        if backward:
            # as the timing phase times them: dq with its delta pre-pass
            do = mk(B, T, 32, 128)
            o, lse = fa.flash_fwd_cuda(q, k, v, True, window)
            delta = fa.flash_delta_cuda(o, do)
            ms = time_ms(lambda: fa.flash_dq_cuda(
                q, k, v, do, lse, fa.flash_delta_cuda(o, do), True, window),
                flush, iters=5, warmup=1)
            log(f"[compare] flash_dq {label}: {ms:.4f} ms")
            ms = time_ms(lambda: fa.flash_dkv_cuda(
                q, k, v, do, lse, delta, True, window), flush, iters=5,
                warmup=1)
            log(f"[compare] flash_dkv {label}: {ms:.4f} ms")
            del do, o, lse, delta
        del q, k, v


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


@contextlib.contextmanager
def pinned(mode):
    """Run the body with the kernels (``mode`` "kernel"), with every op
    pinned to its plain version ("plain"), or with the plain version and
    the attention in fp32 arithmetic ("plain_fp32": pools upcast per call,
    output rounded once to q's dtype — the exact-softmax yardstick;
    test-only, swapped in here)."""
    plain = pa.paged_attention_torch

    def plain_fp32(q, k_pool, v_pool, *args, **kw):
        return plain(q.float(), k_pool.float(), v_pool.float(), *args,
                     **kw).to(q.dtype)

    pa.FORCE_REFERENCE = qz.FORCE_REFERENCE = mode != "kernel"
    if mode == "plain_fp32":
        pa.paged_attention_torch = plain_fp32
    try:
        yield
    finally:
        pa.FORCE_REFERENCE = qz.FORCE_REFERENCE = False
        pa.paged_attention_torch = plain


def step_logits(engine, chunks, step, mode):
    """Logits of one prefill step (two sequences, 256 and 200 prompt
    tokens) or of the decode step after it, in ``mode`` (``pinned``)."""
    uids = [20_000, 20_001]
    with pinned(mode):
        try:
            out = engine.put(uids, [chunks[0][:256], chunks[1][:200]])
            if step == "decode":
                out = engine.put(uids, [[chunks[0][256]], [chunks[1][200]]])
            return out.float()
        finally:
            for u in uids:
                engine.flush(u)


def compare_steps(get_logits, label, steps=("prefill", "decode")):
    """One prefill and one decode step (or ``steps``) through the kernels
    against the plain versions; ``get_logits(step, mode)`` gives the logits
    of ``step`` in ``mode`` ("kernel", "plain" or "plain_fp32").
    The runs differ only in rounding, which 32 layers amplify; the check is
    that the kernels' logits are no further from the fp32-arithmetic
    attention's than the plain bf16 version's are (the plain version rounds
    p — and dequantized K/V — to bf16 before the products; the kernel keeps
    them in fp32)."""
    res = {}
    for step in steps:
        k, p, p32 = (get_logits(step, m)
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


def device_summary(prof, wall_ms, label, name, top):
    """Log a trace's wall time, the device's busy share (kernel time over
    wall time) and the kernels that took the most device time. Returns the
    busy milliseconds and the device-side events, most time first."""
    from torch.autograd import DeviceType

    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched
    evs = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    log(f"[{label}] {name}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / wall_ms:.1f}%)")
    for e in evs[:top]:
        log(f"[{label}]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<5d} {e.key[:90]}")
    return busy, evs


def profile_steps(engine, prompts, label, top=8):
    """torch.profiler over two puts of the main path: the long prompt's last
    256-token chunk (its context at 4344-4599) and one decode step of all 8
    requests. Prints each put's wall time, the device's busy share (kernel
    time over wall time), and the kernels that took the most device time."""
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
        busy, evs = device_summary(prof, wall, f"profile {label}", name, top)
        # the quantized matmul's kernels and the split-K sum behind the
        # weight-streaming route, all launches of the put together
        share = {k: sum(e.self_device_time_total for e in evs if k in e.key)
                 / 1e3 for k in ("qmm_", "splitk_sum")}
        if share["qmm_"] or share["splitk_sum"]:
            log(f"[profile {label}] {name}: quantized matmul kernels "
                f"{share['qmm_']:.3f} ms, splitk_sum "
                f"{share['splitk_sum']:.3f} ms "
                f"({100 * sum(share.values()) / busy:.1f}% of device time)")
    for u in uids:
        engine.flush(u)


class PutLog:
    """Every put of the attached engines, from whichever thread makes it:
    (tokens, has a prompt chunk, seconds). With ``sync`` each put is
    synchronized and timed; without it (replicas sharing the card, whose
    device-wide syncs would serialize each other) only counted."""

    def __init__(self, sync=True):
        self.puts, self.engines, self.sync = [], [], sync

    def attach(self, engine):
        real = engine.put

        def timed(uids, chunks, **kw):
            if self.sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(uids, chunks, **kw)
            if self.sync:
                torch.cuda.synchronize()
            self.puts.append((sum(len(c) for c in chunks),
                              max(len(c) for c in chunks) > 1,
                              time.perf_counter() - t))
            return out

        engine.put = timed
        self.engines.append(engine)
        return engine

    def close(self):
        # drop the instance attribute (no engine -> bound method -> engine
        # cycle that would keep a dropped engine's memory alive)
        for engine in self.engines:
            del engine.put
        self.engines = []

    def decode_tps(self):
        if not self.sync:
            return float("nan")
        dec = [(n, s) for n, pre, s in self.puts if not pre]
        return sum(n for n, _ in dec) / sum(s for _, s in dec)


def serve(engine, cfg, prompts, new_tokens, label):
    """Greedy generation through the scheduler with every put timed; the
    kernels' launch counts are set to 0 just before and read just after."""
    from deepspeed_tpu_torch.inference.v2.testing import greedy_generate

    def checked_argmax(logits):
        if logits.shape != (cfg.vocab_size,) or not np.isfinite(logits).all():
            raise AssertionError(f"[{label}] non-finite or mis-shaped logits")
        return int(np.argmax(logits))

    put_log = PutLog()
    put_log.attach(engine)
    puts = put_log.puts
    reset_launches()
    t0 = time.perf_counter()
    try:
        streams = greedy_generate(engine, prompts, max_new_tokens=new_tokens,
                                  sequential=False, sample_fn=checked_argmax)
        torch.cuda.synchronize()
    finally:
        put_log.close()
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
    rng = np.random.default_rng(99)
    chunks = [rng.integers(0, cfg.vocab_size, 257).tolist(),
              rng.integers(0, cfg.vocab_size, 201).tolist()]
    res["steps"] = compare_steps(
        functools.partial(step_logits, engine, chunks), label)
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


# ------------------------------------------------------------- features

# The serving features at MISTRAL_7B width, on one bf16 engine built once
# (32 layers, blocks of 16, chunks of 256). The features are switched
# between runs with configure_prefix_cache, configure_admission and
# configure_kv_quant; the pool is re-sized for the preemption runs
# (``set_pool``); the int8 speculative runs quantize the same engine's
# weights in place, last.
FEATURE_KV_BLOCKS = 2048            # 8 x (2048 + 512 + 32) tokens and room
FEATURE_PREFIX = 2048               # shared system prompt, 128 full blocks
FEATURE_NEW_TOKENS = 32
PREFIX_SUFFIXES = {"cold": (70, 90, 200, 260, 310, 390, 470, 500),
                   "warm": (64, 100, 180, 256, 300, 400, 450, 512)}
SPEC_SEGMENT_LENS = (112, 134, 192, 240, 284, 372, 434, 496)
PREEMPT_KV_BLOCKS = 400             # the main prompts need 432 blocks whole
PREEMPT_RANKS = (1, 0, 1, 0, 1, 0, 1, 0)   # two urgency classes


def margin_of(logits):
    top = np.partition(logits, -2)[-2:]
    return float(top[1] - top[0])


def margin_scheduler(engine, **sched_kw):
    """A scheduler that keeps each request's top-2 logit margin at each
    sampled position in ``margins`` (for the greedy-parity rule)."""
    from deepspeed_tpu_torch.inference.v2 import ContinuousBatchingScheduler

    class MarginScheduler(ContinuousBatchingScheduler):
        def _pack(self):
            for uid, req in self.running.items():
                if req.prompt_remaining == 0 and req.last_logits is not None:
                    self.margins.setdefault(uid, {})[len(req.generated)] = \
                        margin_of(req.last_logits)
            return super()._pack()

    sched = MarginScheduler(engine, **sched_kw)
    sched.margins = {}
    return sched


def set_pool(engine, kv_blocks):
    """Re-allocate the engine's KV pools at ``kv_blocks`` (no sequence may
    be tracked): the preemption runs need a pool smaller than the demand."""
    if engine.state_manager.tracked_sequences:
        raise AssertionError("set_pool with sequences tracked")
    engine.config.kv_blocks = kv_blocks
    engine.state_manager = None
    torch.cuda.empty_cache()
    engine.state_manager = engine._build_state_manager()


def feature_run(engine, prompts, label, ranks=None, record_margins=False,
                draft_engine=None, **sched_kw):
    """Serve ``prompts`` (all submitted at once) through a scheduler with
    ``sched_kw``; every put is timed and the route of each of its paged
    launches recorded. The kernels' launch counts are set to 0 just before
    and read just after. Checks stream lengths, one paged launch per layer
    and put, 7 quantized-matmul launches per layer and put plus lm_head's
    (225 at MISTRAL_7B) with quantized weights (else 0), and that every
    block is free or held by the prefix cache alone. ``record_margins``
    keeps each request's top-2 logit margin at each sampled position (for
    the greedy-parity rule); the puts of a ``draft_engine`` (a draft-model
    proposer's) count in the launches."""
    from deepspeed_tpu_torch.inference.v2 import ContinuousBatchingScheduler

    sched = (margin_scheduler(engine, **sched_kw) if record_margins
             else ContinuousBatchingScheduler(engine, **sched_kw))
    sched.margins = {}
    puts, put_routes = [], []
    real_put, real_cuda = engine.put, pa.paged_attention_cuda

    def routed(q, k_pool, *a, **kw):
        put_routes.append(pa.PAGED_ROUTES[pa.paged_route(
            q.shape[1], q.shape[2], k_pool.shape[1], q.shape[3], q.dtype)])
        return real_cuda(q, k_pool, *a, **kw)

    def timed_put(uids, chunks, **kw):
        put_routes.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_put(uids, chunks, **kw)
        torch.cuda.synchronize()
        puts.append({"tokens": sum(len(c) for c in chunks),
                     "max_chunk": max(len(c) for c in chunks),
                     "verify": kw.get("verify_width", 0),
                     "s": time.perf_counter() - t,
                     "routes": set(put_routes)})
        return out

    draft_puts = []
    if draft_engine is not None:
        real_draft_put = draft_engine.put

        def counted_put(*a, **kw):
            draft_puts.append(1)
            return real_draft_put(*a, **kw)
        draft_engine.put = counted_put
    base = 40_000
    engine.put, pa.paged_attention_cuda = timed_put, routed
    pa.launches = 0
    qz.launches["quantized_matmul"] = 0
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(prompts):
            sched.submit(base + i, p, max_new_tokens=FEATURE_NEW_TOKENS,
                         shed_rank=ranks[i] if ranks else 0)
        sched.run_to_completion()
        torch.cuda.synchronize()
    finally:
        del engine.put
        pa.paged_attention_cuda = real_cuda
        if draft_engine is not None:
            del draft_engine.put
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.launches,
                "quantized_matmul": qz.launches["quantized_matmul"]}
    streams = [sched.finished[base + i].generated for i in range(len(prompts))]
    if any(len(s) != FEATURE_NEW_TOKENS for s in streams):
        raise AssertionError(f"[features] {label}: stream lengths "
                             f"{[len(s) for s in streams]}")
    mcfg = engine.model.cfg
    L = mcfg.num_layers
    n_puts = len(puts) + len(draft_puts)
    if launches["paged_attention"] != L * n_puts:
        raise AssertionError(f"[features] {label}: "
                             f"{launches['paged_attention']} paged launches "
                             f"for {n_puts} puts x {L} layers")
    # 7 projections a layer and lm_head (225 at MISTRAL_7B); a draft
    # engine shares the target's (quantized) tree
    want_qmm = ((7 * L + (0 if mcfg.tie_embeddings else 1)) * n_puts
                if engine.config.weight_quant_enabled else 0)
    if launches["quantized_matmul"] != want_qmm:
        raise AssertionError(f"[features] {label}: "
                             f"{launches['quantized_matmul']} quantized-matmul "
                             f"launches, want {want_qmm}")
    occ = engine.occupancy()
    if occ["available_blocks"] != engine.config.kv_blocks:
        raise AssertionError(f"[features] {label}: {occ} after the run")
    log(f"[features] {label}: {len(prompts)} requests x "
        f"{FEATURE_NEW_TOKENS} tokens in {wall:.2f} s, {len(puts)} puts "
        f"({sum(1 for p in puts if p['verify'])} verify"
        + (f"; {len(draft_puts)} draft-engine puts" if draft_puts else "")
        + "), launches "
        f"{json.dumps(launches)}; blocks free {occ['free_blocks']} + cached "
        f"{occ['evictable_blocks']} of {engine.config.kv_blocks}")
    return {"streams": streams, "puts": puts, "launches": launches,
            "sched": sched, "wall": wall,
            "margins": [sched.margins.get(base + i, {})
                        for i in range(len(prompts))]}


def parity_rule(off, on, gap, label):
    """Greedy parity between feature off and on at full width: bf16 batches
    of different composition may round differently, so each request's
    streams must be equal, or at their first differing position the
    feature-off run's top-2 logit margin must be no larger than ``gap``,
    the largest |kernel - plain| logit difference ``compare_steps``
    measured on this engine."""
    diverged = []
    for i, (a, b) in enumerate(zip(off["streams"], on["streams"])):
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        m = off["margins"][i].get(j)
        if m is None or m > gap:
            raise AssertionError(
                f"[features] {label}: request {i} diverges at token {j} "
                f"with a feature-off top-2 margin of {m} > the kernel/plain "
                f"logit gap {gap:.4g}")
        diverged.append((i, j, round(m, 4)))
    log(f"[features] {label}: greedy parity: "
        f"{len(off['streams']) - len(diverged)} of {len(off['streams'])} "
        f"streams equal; diverged (request, token, off-run margin) "
        f"{diverged} within the kernel/plain gap {gap:.4g}")
    return diverged


def feature_step_logits(engine, prompts, step, mode):
    """Logits of one speculative verify put ("verify K=3": two rows of
    K + 1 and K - 1 tokens after 256 and 230 prompt tokens, verify_width
    K + 1) or of one prefix-hit first chunk ("prefix hit": 256 tokens at
    position 2048 after a match of 2048 cached tokens that a donor wrote in
    the same mode), in ``mode`` (``pinned``)."""
    uids, donor = [21_000, 21_001], 21_002
    with pinned(mode):
        try:
            if step.startswith("verify"):
                W = int(step.split("K=")[1]) + 1
                engine.put(uids, [prompts[0][:256], prompts[1][:230]])
                return engine.put(
                    uids, [prompts[0][256:256 + W],
                           prompts[1][230:230 + W - 2]],
                    verify_width=W).float()
            engine.configure_prefix_cache(True)
            fill = prompts[0][:FEATURE_PREFIX + 16]
            for s in range(0, len(fill), 256):
                engine.put([donor], [fill[s:s + 256]])
            engine.flush(donor)
            hit = fill[:FEATURE_PREFIX] + prompts[1][:256]
            matched = engine.match_prefix(uids[0], hit)
            if matched != FEATURE_PREFIX:
                raise AssertionError(f"[features] prefix hit matched "
                                     f"{matched}")
            return engine.put([uids[0]], [hit[FEATURE_PREFIX:]]).float()
        finally:
            for u in uids + [donor]:
                engine.flush(u)
            engine.configure_prefix_cache(False)


def feature_gap(engine, label, steps):
    """compare_steps over the main path's prefill and decode steps and the
    features' ``steps``; returns the largest |kernel - plain| logit gap."""
    rng = np.random.default_rng(99)
    V = engine.model.cfg.vocab_size
    prompts = [rng.integers(0, V, FEATURE_PREFIX + 300).tolist(),
               rng.integers(0, V, 600).tolist()]

    def get_logits(step, mode):
        if step in ("prefill", "decode"):
            return step_logits(engine, prompts, step, mode)
        return feature_step_logits(engine, prompts, step, mode)

    res = compare_steps(get_logits, f"features {label}",
                        steps=("prefill", "decode") + tuple(steps))
    gap = max(r["max_dlogit"] for r in res.values())
    log(f"[features] {label}: kernel/plain logit gap {gap:.4g}")
    return gap


def feature_prefix(engine, gap):
    """8 requests sharing a 2048-token system prompt: cache off, then on
    (a cold pass with other suffixes, then a warm pass)."""
    rng = np.random.default_rng(21)
    V = engine.model.cfg.vocab_size
    sys_p = rng.integers(0, V, FEATURE_PREFIX).tolist()
    sets = {k: [sys_p + rng.integers(0, V, n).tolist() for n in lens]
            for k, lens in PREFIX_SUFFIXES.items()}
    off = feature_run(engine, sets["warm"], "prefix cache off",
                      record_margins=True)
    engine.configure_prefix_cache(True)
    res = {}
    for name in ("cold", "warm"):
        st0 = engine.prefix_stats()
        res[name] = feature_run(engine, sets[name], f"prefix cache {name}")
        st = {k: v - st0[k] for k, v in engine.prefix_stats().items()}
        lookups = st["hits"] + st["misses"]
        res[name]["stats"] = st
        log(f"[features] prefix cache {name} pass: matched "
            f"{st['tokens_saved']} tokens, {st['hits']} block hits of "
            f"{lookups} lookups (hit rate "
            f"{st['hits'] / max(1, lookups):.3f}), {st['queries']} queries")
    if res["warm"]["stats"]["tokens_saved"] < 7 * FEATURE_PREFIX:
        raise AssertionError(f"[features] the warm pass matched "
                             f"{res['warm']['stats']['tokens_saved']} tokens")
    engine.configure_prefix_cache(False)
    if engine.free_blocks != engine.config.kv_blocks:
        raise AssertionError(f"[features] {engine.free_blocks} blocks free "
                             "after clear_prefix_cache")
    log(f"[features] prefix cache cleared: {engine.free_blocks} of "
        f"{engine.config.kv_blocks} blocks free")
    parity_rule(off, res["warm"], gap, "prefix cache (warm) vs off")
    return {k: v["stats"] for k, v in res.items()}


def feature_spec(engine, label, gap):
    """Speculative decoding at K = 3 and 4 with the n-gram proposer and with
    a draft-model proposer over a second engine that shares this one's
    weights (its own pools, the same KV representation), against a plain
    run of the same prompts: a seeded segment, the model's own greedy
    continuation of it (32 tokens, from a first plain run), and the segment
    again (256-1024 tokens).

    Random weights do not continue a repeated text, so the n-gram proposer
    finds few matches here and its drafts are rejected (each one a KV
    rollback); the draft model, the same weights, proposes what the target
    computes, so its drafts are accepted unless the two puts round apart.
    The draft runs must accept drafts on verify puts of width K + 1 on the
    route that width takes; every run is held to the greedy-parity rule."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.spec import (DraftModelProposer,
                                                       NGramProposer)
    from deepspeed_tpu_torch.inference.v2.testing import spec_summary

    rng = np.random.default_rng(33)
    V = engine.model.cfg.vocab_size
    segs = [rng.integers(0, V, n).tolist() for n in SPEC_SEGMENT_LENS]
    cont = feature_run(engine, segs, f"{label} spec prompts")["streams"]
    prompts = [seg + c + seg for seg, c in zip(segs, cont)]
    off = feature_run(engine, prompts, f"{label} spec off",
                      record_margins=True)
    ecfg = engine.config
    deng = InferenceEngineV2(engine.model, engine.params,
                             RaggedInferenceEngineConfig(
                                 kv_block_size=ecfg.kv_block_size,
                                 max_chunk_tokens=ecfg.max_chunk_tokens,
                                 kv_blocks=ecfg.kv_blocks,
                                 kv_quant_enabled=ecfg.kv_quant_enabled,
                                 kv_quant_dtype=ecfg.kv_quant_dtype),
                             device="cuda")
    proposers = {"ngram": NGramProposer,
                 "draft model": lambda: DraftModelProposer(deng)}
    out = {}
    for pname, make in proposers.items():
        for K in (3, 4):
            name = f"{label} spec {pname} K={K}"
            run = feature_run(engine, prompts, name, proposer=make(),
                              max_draft_tokens=K,
                              draft_engine=deng if pname != "ngram" else None)
            st = run["sched"].spec_stats()
            # verify puts of width K + 1 take the route their width gives
            # (K = 3: C = 4, G.C = 16; K = 4: C = 8 after the bucket, G.C
            # = 32), whichever rows they carry
            want = {"paged_decode_split_kernel"} if K == 3 \
                else {"paged_prefill_tc_kernel"}
            full = [p for p in run["puts"]
                    if p["verify"] and p["max_chunk"] == K + 1]
            if any(p["routes"] != want for p in full):
                raise AssertionError(
                    f"[features] {name}: verify puts of width {K + 1} took "
                    f"{[sorted(p['routes']) for p in full]}, want {want}")
            if pname != "ngram" and (not full or st["accepted"] == 0):
                raise AssertionError(f"[features] {name}: {st}, "
                                     f"{len(full)} verify puts of width "
                                     f"{K + 1}")
            dec = [p for p in run["puts"] if p["max_chunk"] <= K + 1]
            summ = spec_summary(st)
            log(f"[features] {name}: proposed {st['proposed']}, accepted "
                f"{st['accepted']} (rate {summ['acceptance_rate']:.3f}), "
                f"emitted {st['emitted']} in {st['decode_rows']} decode "
                f"rows ({summ['tokens_per_forward']:.3f} tokens a row); "
                f"{len(dec)} decode puts for {st['emitted']} tokens "
                f"({len(dec) / st['emitted']:.4f} puts a token; spec off "
                f"{sum(1 for p in off['puts'] if p['max_chunk'] == 1)} "
                f"puts); {len(full)} verify puts of width {K + 1} on "
                f"{sorted(want)}")
            parity_rule(off, run, gap, f"{name} vs off")
            out[f"{pname} K={K}"] = dict(st, puts=len(dec))
    del deng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def feature_preempt(engine, label, gap):
    """The main path's 8 prompts in a pool of 400 blocks with two urgency
    classes, reservation admission and preemption (oversubscription 2),
    against an uncontended run in a pool of 1024."""
    rng = np.random.default_rng(0)
    V = engine.model.cfg.vocab_size
    prompts = [rng.integers(0, V, n).tolist() for n in MAIN_PROMPT_LENS]
    set_pool(engine, 1024)
    off = feature_run(engine, prompts, f"{label} uncontended",
                      record_margins=True)
    set_pool(engine, PREEMPT_KV_BLOCKS)
    engine.configure_admission(True, oversubscription_factor=2.0,
                               preemption_enabled=True)
    try:
        run = feature_run(engine, prompts, f"{label} preemption",
                          ranks=PREEMPT_RANKS)
    finally:
        engine.configure_admission(False)
    st = run["sched"].preempt_stats()
    if st["preempted"] < 1 or st["resumed"] != st["preempted"] \
            or run["sched"].preempted:
        raise AssertionError(f"[features] {label}: {st}")
    if engine.free_blocks != PREEMPT_KV_BLOCKS:
        raise AssertionError(f"[features] {label}: {engine.free_blocks} "
                             f"of {PREEMPT_KV_BLOCKS} blocks free")
    spills, resumes = run["sched"].drain_preempt_times()
    events = run["sched"].drain_preempt_events()
    log(f"[features] {label}: {st['preempted']} preempted, {st['resumed']} "
        f"resumed ({events}); spill {[round(t * 1e3, 2) for t in spills]} "
        f"ms, resume {[round(t * 1e3, 2) for t in resumes]} ms; all "
        f"{len(prompts)} finished, {engine.free_blocks} blocks free")
    parity_rule(off, run, gap, f"{label} preemption vs uncontended")
    set_pool(engine, FEATURE_KV_BLOCKS)
    return st


def raw_bytes(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def feature_kv_roundtrip(engine, label):
    """Export a sequence in mid-decode (1000 prompt tokens and 3 decoded),
    flush it, import it under a new uid at other block ids, and hold a
    re-export (whole and chunked) to the payload byte for byte, slabs and
    scale planes alike."""
    rng = np.random.default_rng(44)
    V = engine.model.cfg.vocab_size
    toks = rng.integers(0, V, 1003).tolist()
    uid = 22_000
    for s in range(0, 1000, 256):
        engine.put([uid], [toks[s:min(s + 256, 1000)]])
    for t in toks[1000:]:
        engine.put([uid], [[t]])
    old = list(engine.state_manager.get_sequence(uid).kv_blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload = engine.export_sequence(uid)
    t_exp = time.perf_counter() - t0
    engine.flush(uid)
    hold = engine.state_manager.allocator.allocate(len(old))
    t0 = time.perf_counter()
    engine.import_sequence(uid + 1, payload, toks)
    torch.cuda.synchronize()
    t_imp = time.perf_counter() - t0
    new = engine.state_manager.get_sequence(uid + 1).kv_blocks
    if set(new) & set(old):
        raise AssertionError(f"[features] {label}: import reused block ids")
    again = engine.export_sequence(uid + 1)
    chunked = engine.export_sequence(uid + 1, chunk_blocks=16)
    nbytes = 0
    for name, t in payload["slabs"].items():
        glued = torch.cat([raw_bytes(c[name]) for c in chunked["chunks"]],
                          dim=1)
        if not (torch.equal(raw_bytes(t), raw_bytes(again["slabs"][name]))
                and torch.equal(raw_bytes(t), glued)):
            raise AssertionError(f"[features] {label}: slab {name} differs "
                                 "after export, import and re-export")
        nbytes += t.numel() * t.element_size()
    engine.flush(uid + 1)
    engine.state_manager.allocator.release(hold)
    if engine.free_blocks != engine.config.kv_blocks:
        raise AssertionError(f"[features] {label}: blocks not returned")
    log(f"[features] {label} KV export/import: {payload['n_blocks']} blocks, "
        f"{sorted(payload['slabs'])}, {nbytes / 1e6:.1f} MB; re-export "
        f"(whole and 16-block chunks) byte-identical; export "
        f"{t_exp * 1e3:.1f} ms, import {t_imp * 1e3:.1f} ms")


def flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# leaves written as shard files split along dim 0 (layers: one a layer)
CKPT_SHARDED = {"embed.wte": 4, "layers.w_in": 2, "layers.wq": 2,
                "lm_head.w": 2}


def feature_checkpoint():
    """A universal checkpoint of MISTRAL_7B at full width with 2 layers
    (fp32 params from a seeded generator), written with numpy — some leaves
    as shard files — then loaded onto the card through
    load_params_for_model and held leaf for leaf; the v2 engine and v1
    generate from it give the streams of the in-memory tree."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.testing import greedy_generate
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM
    from deepspeed_tpu_torch.runtime.checkpointing import \
        load_params_for_model

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=2)
    model = CausalLM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(5),
                        device="cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(here, "build"))
    try:
        pdir = os.path.join(root, "smoke0", "params")
        os.makedirs(pdir)
        index, nbytes = {}, 0
        t0 = time.perf_counter()
        for key, t in flat_leaves(params).items():
            a = t.cpu().numpy()
            nbytes += a.nbytes
            parts = CKPT_SHARDED.get(key, 1)
            if parts == 1:
                np.save(os.path.join(pdir, key + ".npy"), a)
                index[key] = key + ".npy"
                continue
            step = -(-a.shape[0] // parts)
            for s in range(0, a.shape[0], step):
                start = "-".join([str(s)] + ["0"] * (a.ndim - 1))
                np.save(os.path.join(pdir, f"{key}.shard_{start}.npy"),
                        a[s:s + step])
            index[key] = key + ".shard_*"
        with open(os.path.join(root, "smoke0", "manifest.json"), "w") as fh:
            json.dump({"tag": "smoke0", "params_index": index,
                       "format_version": 1}, fh)
        with open(os.path.join(root, "latest"), "w") as fh:
            fh.write("smoke0")
        t_write = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_params_for_model(model, root, device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        src, got = flat_leaves(params), flat_leaves(loaded)
        if set(src) != set(got) or not all(
                got[k].device.type == "cuda" and torch.equal(got[k], src[k])
                for k in src):
            raise AssertionError("[features] checkpoint: loaded leaves differ")
        log(f"[features] checkpoint: {len(src)} leaves, {nbytes / 1e9:.3f} GB "
            f"fp32 ({sorted(CKPT_SHARDED)} as shard files) written in "
            f"{t_write:.2f} s, loaded onto the card in {t_load:.2f} s "
            f"({nbytes / 1e9 / t_load:.2f} GB/s), equal leaf for leaf")
        rng = np.random.default_rng(55)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (300, 1200)]
        ecfg = dict(kv_block_size=16, max_chunk_tokens=256, kv_blocks=256)
        streams = [greedy_generate(
            InferenceEngineV2(model, tree, RaggedInferenceEngineConfig(**ecfg),
                              device="cuda"), prompts, max_new_tokens=16,
            sequential=False) for tree in (loaded, params)]
        if streams[0] != streams[1]:
            raise AssertionError(f"[features] checkpoint: v2 streams differ "
                                 f"{streams}")
        outs = [init_inference(model, config=dict(conf, dtype="bf16"),
                               device="cuda", **kw).generate(
                                   prompts, max_new_tokens=16)
                for conf, kw in (({"checkpoint": root}, {}),
                                 ({}, {"params": params}))]
        te = init_inference(model, config={"dtype": "bf16"}, device="cuda")
        if te.load_checkpoint(os.path.join(root, "smoke0", "params")) != \
                os.path.join(root, "smoke0", "params"):
            raise AssertionError("[features] checkpoint: load_checkpoint's "
                                 "return value")
        outs.append(te.generate(prompts, max_new_tokens=16))
        del te
        if not (torch.equal(outs[0], outs[1]) and torch.equal(outs[2],
                                                              outs[1])):
            raise AssertionError("[features] checkpoint: v1 generate differs")
        log(f"[features] checkpoint: v2 engine, v1 generate from the "
            f"checkpoint and v1 load_checkpoint give the in-memory tree's "
            f"streams (2 requests x 16 "
            f"tokens: {[s[:4] for s in streams[0]]}...)")
        return {"gb": nbytes / 1e9, "write_s": t_write, "load_s": t_load}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The KV tier cell: 6 system prompts of 1024 tokens (64 blocks of 16, 128 MiB
# of bf16 KV each), each followed by a 32-token random tail, 8 new tokens a
# request; two passes of 12 requests (each prompt twice), one at a time. The
# pool holds about half the prefixes' 384 blocks, so prefixes are evicted
# between repeats: tier off re-prefills them, tier on restores them from host
# RAM (two prefixes' blocks: 256 MiB of bf16 KV, half that of int8) or disk.
TIER_PROMPTS = 6
TIER_SYS = 1024
TIER_TAIL = 32
TIER_NEW = 8
TIER_KV_BLOCKS = 64 * 3 + 67 + 1
TIER_HOST_PREFIXES = 2
TIER_DISK_BYTES = 1 << 30


def tier_prompts(vocab):
    rng = np.random.default_rng(77)
    sys_p = [rng.integers(0, vocab, TIER_SYS).tolist()
             for _ in range(TIER_PROMPTS)]
    return [sys_p[i % TIER_PROMPTS] + rng.integers(0, vocab, TIER_TAIL).tolist()
            for i in range(2 * TIER_PROMPTS)]


def instrument_tier(sm):
    """Time the tier's work on the host: each spill of evicted blocks (the
    gather, the copy to the host and the store's puts, demotions included),
    each disk write (a demotion), each get (a disk read, or a host pop), and
    count the disk reads that hit."""
    store = sm._tier
    io = {"spill_s": [], "write_s": [], "read_s": [], "host_get_s": [],
          "disk_hits": 0}
    real_spill, real_demote, real_get = (sm._spill_blocks, store._demote,
                                         store.get)

    def spill(blocks):
        t = time.perf_counter()
        real_spill(blocks)
        io["spill_s"].append(time.perf_counter() - t)

    def demote(key, entry):
        t = time.perf_counter()
        ok = real_demote(key, entry)
        io["write_s"].append(time.perf_counter() - t)
        return ok

    def get(key):
        on_disk = key in store._disk
        t = time.perf_counter()
        out = real_get(key)
        (io["read_s"] if on_disk else io["host_get_s"]).append(
            time.perf_counter() - t)
        io["disk_hits"] += on_disk and out is not None
        return out

    sm._spill_blocks, store._demote, store.get = spill, demote, get
    return io


def tier_run(engine, prompts, label, passes=2, tracer=None):
    """``passes`` passes over ``prompts``, each request submitted alone and
    run to completion, through one scheduler (with ``tracer``). Every put
    and step is timed; the kernels' launch counts are set to 0 just before
    and read just after. Returns the streams, each request's top-2 margins,
    the last pass's TTFT (submission to first token, on the monotonic
    clock) and its prefix-cache counters."""
    sched = margin_scheduler(engine, tracer=tracer, trace_label="replica-0")
    puts, steps = [], []
    real_put, real_step = engine.put, sched.step

    def timed_put(uids, chunks, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_put(uids, chunks, **kw)
        torch.cuda.synchronize()
        puts.append((max(len(c) for c in chunks), time.perf_counter() - t))
        return out

    def timed_step():
        t = time.perf_counter()
        out = real_step()
        steps.append(time.perf_counter() - t)
        return out

    engine.put, sched.step = timed_put, timed_step
    reset_launches()
    t_start = time.perf_counter()
    streams, ttft, t0, first, windows = [], [], {}, {}, {}

    def on_token(uid, tok):
        first.setdefault(uid, time.monotonic())

    try:
        for p in range(passes):
            st0 = engine.prefix_stats()
            for i, pr in enumerate(prompts):
                uid = 50_000 + 1000 * p + i
                t0[uid] = time.monotonic()
                sched.submit(uid, pr, max_new_tokens=TIER_NEW,
                             on_token=on_token, trace_id=f"req-{uid}")
                sched.run_to_completion()
                streams.append(sched.finished[uid].generated)
                windows[f"req-{uid}"] = (t0[uid], first[uid])
                if p == passes - 1:
                    ttft.append(first[uid] - t0[uid])
            pstats = {k: v - st0[k] for k, v in engine.prefix_stats().items()}
        torch.cuda.synchronize()
    finally:
        del engine.put
    wall = time.perf_counter() - t_start
    launches = {"paged_attention": pa.launches,
                "quantized_matmul": qz.launches["quantized_matmul"]}
    mcfg = engine.model.cfg
    L = mcfg.num_layers
    if any(len(s) != TIER_NEW for s in streams):
        raise AssertionError(f"[kv_tier] {label}: stream lengths "
                             f"{[len(s) for s in streams]}")
    if launches["paged_attention"] != L * len(puts):
        raise AssertionError(f"[kv_tier] {label}: {launches} for "
                             f"{len(puts)} puts x {L} layers")
    want_qmm = ((7 * L + (0 if mcfg.tie_embeddings else 1)) * len(puts)
                if engine.config.weight_quant_enabled else 0)
    if launches["quantized_matmul"] != want_qmm:
        raise AssertionError(f"[kv_tier] {label}: {launches}, want "
                             f"{want_qmm} quantized-matmul launches")
    lookups = pstats["hits"] + pstats["misses"]
    n = len(prompts)
    return {"streams": streams, "ttft": ttft, "pstats": pstats,
            "hit_rate": pstats["hits"] / max(1, lookups), "puts": puts,
            "steps": steps, "wall": wall, "launches": launches,
            "windows": windows,
            "margins": [sched.margins.get(50_000 + 1000 * p + i, {})
                        for p in range(passes) for i in range(n)]}


def reset_prefix_cache(engine):
    """Drop the prefix cache's index (and any tier with it), then turn the
    cache back on empty."""
    engine.configure_prefix_cache(False)
    engine.configure_prefix_cache(True)


def feature_kv_tier(engine, label, gap, trace=False):
    """The KV tier cell on ``engine`` (MISTRAL_7B at full width; its weights
    and KV representation as configured): tier off, then tier on (host RAM
    256 MiB, disk 1 GiB in a temporary directory), the same two passes.
    Checks that the tier restored blocks, from host and from disk, with no
    corrupt read, through the native aio library; that the tier-on streams
    obey the greedy-parity rule against the tier-off ones; and that every
    block comes back. With ``trace``: a traced repeat of the first pass
    gives the untraced streams byte for byte with each request's spans
    covering its TTFT, and a tier configured off gives the tier-less
    streams."""
    from deepspeed_tpu_torch.telemetry import Tracer, trace_coverage

    V = engine.model.cfg.vocab_size
    prompts = tier_prompts(V)
    set_pool(engine, TIER_KV_BLOCKS)
    engine.configure_prefix_cache(True)
    engine.configure_admission(True)
    sm = engine.state_manager
    block_bytes = sum(t[:, 0].numel() * t.element_size()
                      for t in sm.kv_cache.values())
    host_bytes = TIER_HOST_PREFIXES * (TIER_SYS // 16) * block_bytes
    tmp = tempfile.mkdtemp(prefix="kvtier_")
    out = {}
    try:
        off = tier_run(engine, prompts, f"{label} tier off")
        reset_prefix_cache(engine)
        engine.configure_kv_tier(True, host_bytes=host_bytes,
                                 disk_path=tmp, disk_bytes=TIER_DISK_BYTES)
        if not engine.state_manager._tier.has_native:
            raise AssertionError(f"[kv_tier] {label}: AsyncTensorSwapper "
                                 "did not load the native aio library")
        io = instrument_tier(engine.state_manager)
        engine.drain_restore_times()
        on = tier_run(engine, prompts, f"{label} tier on")
        st = engine.tier_stats()
        restore_s = engine.drain_restore_times()
        if not (st["restored"] > 0 and st["demoted"] > 0
                and io["disk_hits"] > 0 and st["corrupt"] == 0):
            raise AssertionError(f"[kv_tier] {label}: {st}, disk hits "
                                 f"{io['disk_hits']}")
        parity_rule(off, on, gap, f"kv_tier {label} tier on vs off")
        p50 = {k: float(np.median(r["ttft"])) * 1e3
               for k, r in (("off", off), ("on", on))}
        moved = (st["spilled"] + st["restored"]) * block_bytes
        w_ms = [t * 1e3 for t in io["write_s"]]
        r_ms = [t * 1e3 for t in io["read_s"]]
        log(f"[kv_tier] {label}: pass 2 p50 TTFT tier off {p50['off']:.1f} "
            f"ms, tier on {p50['on']:.1f} ms ({p50['off'] / p50['on']:.2f}x); "
            f"prefix hit rate off {off['hit_rate']:.3f}, on "
            f"{on['hit_rate']:.3f}; tier {json.dumps(st)}")
        log(f"[kv_tier] {label}: {len(restore_s)} restored runs, restore "
            f"median {np.median(restore_s) * 1e3:.2f} ms, max "
            f"{max(restore_s) * 1e3:.2f} ms; {moved / 2**20:.0f} MiB moved "
            f"(spilled + restored, {block_bytes / 2**20:.3f} MiB a block); "
            f"disk write {np.median(w_ms):.3f} ms a block (median of "
            f"{len(w_ms)}), read {np.median(r_ms):.3f} ms a block (median "
            f"of {len(r_ms)}, {io['disk_hits']} disk hits); walls off "
            f"{off['wall']:.1f} s, on {on['wall']:.1f} s")
        log(f"[kv_tier] {label}: host seconds of the tier-on run: restored "
            f"runs {sum(restore_s):.3f} ({len(restore_s)}), spills "
            f"{sum(io['spill_s']):.3f} ({len(io['spill_s'])} evictions, "
            f"{st['spilled']} blocks), of which disk writes "
            f"{sum(io['write_s']):.3f}; disk reads {sum(io['read_s']):.3f}, "
            f"host-tier gets {sum(io['host_get_s']):.4f}; the host tier "
            f"{host_bytes / 2**20:.0f} MiB")
        out = {"ttft_p50_ms": p50, "hit_rate": {"off": off["hit_rate"],
                                                "on": on["hit_rate"]},
               "stats": st, "restore_ms": [t * 1e3 for t in restore_s],
               "spill_s": sum(io["spill_s"]), "restore_s": sum(restore_s),
               "disk_write_ms": float(np.median(w_ms)),
               "disk_read_ms": float(np.median(r_ms)),
               "moved_mib": moved / 2**20}
        if trace:
            engine.configure_kv_tier(False)
            reset_prefix_cache(engine)
            engine.configure_kv_tier(True, host_bytes=host_bytes,
                                     disk_path=tmp,
                                     disk_bytes=TIER_DISK_BYTES)
            tracer = Tracer(max_spans=1 << 16)
            traced = tier_run(engine, prompts, f"{label} traced", passes=1,
                              tracer=tracer)
            n = len(prompts)
            if traced["streams"] != on["streams"][:n]:
                raise AssertionError(f"[kv_tier] {label}: the traced pass's "
                                     "streams differ from the untraced one")
            spans = tracer.export()
            cov = []
            for tid, (a, b) in traced["windows"].items():
                mine = [s for s in spans if s["trace_id"] == tid]
                cov.append(trace_coverage(mine, a, b))
            if min(cov) < 0.95:
                raise AssertionError(f"[kv_tier] {label}: span coverage of "
                                     f"TTFT {min(cov):.3f} < 0.95")
            fwd = [(s["t_end"] - s["t_start"]) * 1e3 for s in spans
                   if s["name"] == "forward" and s["attrs"]["n_tokens"] == 1]
            dec_put = [t * 1e3 for c, t in traced["puts"] if c == 1]
            dec_step = float(np.median(traced["steps"])) * 1e3
            log(f"[kv_tier] {label} traced pass: streams equal the untraced "
                f"pass; spans cover {min(cov):.4f}-{max(cov):.4f} of each "
                f"request's TTFT; decode forward span median "
                f"{np.median(fwd):.2f} ms (of {len(fwd)}) against the decode "
                f"put wall {np.median(dec_put):.2f} ms (synchronized) and "
                f"the step median {dec_step:.2f} ms")
            out["trace"] = {"coverage_min": min(cov),
                            "forward_ms": float(np.median(fwd)),
                            "decode_put_ms": float(np.median(dec_put))}
            engine.configure_kv_tier(False)
            reset_prefix_cache(engine)
            again = tier_run(engine, prompts, f"{label} tier configured off",
                             passes=1)
            if again["streams"] != off["streams"][:n]:
                raise AssertionError(f"[kv_tier] {label}: a tier configured "
                                     "off changed the streams")
            log(f"[kv_tier] {label}: a tier configured off gives the "
                "tier-less streams byte for byte")
            evacuate_failing_export(engine, prompts[0], label)
    finally:
        engine.configure_kv_tier(False)
        engine.configure_prefix_cache(False)
        engine.configure_admission(False)
        shutil.rmtree(tmp, ignore_errors=True)
    if engine.free_blocks != TIER_KV_BLOCKS:
        raise AssertionError(f"[kv_tier] {label}: {engine.free_blocks} of "
                             f"{TIER_KV_BLOCKS} blocks free at the end")
    log(f"[kv_tier] {label}: all {TIER_KV_BLOCKS} blocks free at the end")
    set_pool(engine, FEATURE_KV_BLOCKS)
    return out


def evacuate_failing_export(engine, prompt, label):
    """Evacuate a decoding sequence while its KV export raises: the
    scheduler logs it, returns no payload, and the sequence leaves
    ``running`` with its blocks and reservation freed."""
    from deepspeed_tpu_torch.inference.v2 import ContinuousBatchingScheduler

    sched = ContinuousBatchingScheduler(engine)
    sched.submit(60_000, prompt, max_new_tokens=TIER_NEW)
    while not (60_000 in sched.running
               and sched.running[60_000].generated):
        sched.step()

    def broken_export(uid, chunk_blocks=0):
        raise RuntimeError("export failed")

    engine.export_sequence = broken_export
    try:
        payload = sched.evacuate(60_000)
    finally:
        del engine.export_sequence
    if (payload is not None or sched.has_work
            or engine.state_manager.get_sequence(60_000) is not None
            or engine.reserved_total_blocks() != 0):
        raise AssertionError(f"[kv_tier] {label}: evacuate with a failing "
                             "export left state behind")
    log(f"[kv_tier] {label}: evacuate with a failing export: no payload, "
        "the sequence left running, its blocks and reservation freed")


def phase_kv_tier():
    """The KV tier cell alone (``--only kv_tier``): MISTRAL_7B at full width
    (32 layers, bf16 weights from a seed), bf16 then int8 weights + int8
    KV."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    model = CausalLM(MISTRAL_7B)
    torch.cuda.empty_cache()
    params = model.init(torch.Generator("cuda").manual_seed(7),
                        device="cuda", dtype=torch.bfloat16)
    engine = InferenceEngineV2(
        model, params, RaggedInferenceEngineConfig(
            kv_block_size=16, max_chunk_tokens=256,
            max_ragged_sequence_count=32, kv_blocks=FEATURE_KV_BLOCKS),
        device="cuda")
    del params
    engine.put([10_000], [list(range(16))])       # warm-up
    engine.flush(10_000)
    res = {}
    gap = feature_gap(engine, "bf16", ("prefix hit",))
    res["bf16"] = feature_kv_tier(engine, "bf16", gap, trace=True)
    engine.configure_kv_quant(True, "int8")
    engine.configure_weight_quant(True, "int8", block=128)
    gc.collect()
    torch.cuda.empty_cache()
    gap_q = feature_gap(engine, "int8 weights + int8 KV", ("prefix hit",))
    res["int8"] = feature_kv_tier(engine, "int8 weights + int8 KV", gap_q)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def small_feature_parity():
    """TINY_TEST-shaped fp32 models (weights x3, so that greedy streams vary
    and fall into loops the n-gram proposer drafts) give the same greedy
    streams on the card as on the CPU with each feature on: the prefix cache
    (a cold and a warm pass), speculative decoding at K = 3 and 4, and
    preemption in a pool too small for the demand — each with dense
    weights and fp32 pools, with int8 weights and KV, and with fp8."""
    from deepspeed_tpu_torch.inference.v2 import (ContinuousBatchingScheduler,
                                                  InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.spec import NGramProposer
    from deepspeed_tpu_torch.models.transformer import TINY_TEST, CausalLM

    model = CausalLM(TINY_TEST)
    params = model.init(torch.Generator("cpu").manual_seed(3), device="cpu")
    params = {g: {k: v * 3 if v.dim() >= 2 else v for k, v in sub.items()}
              for g, sub in params.items()}
    rng = np.random.default_rng(4)
    sys_p = rng.integers(0, 256, 37).tolist()
    motif = rng.integers(0, 256, 5).tolist()
    prompts = {"prefix": [sys_p + rng.integers(0, 256, n).tolist()
                          for n in (3, 9, 5, 11)],
               "spec": [motif * 4 + [7, 9], rng.integers(0, 6, 20).tolist(),
                        motif * 3, rng.integers(0, 256, 10).tolist()],
               "preempt": [rng.integers(0, 256, n).tolist()
                           for n in (60, 44, 76, 30)]}
    quant = {"dense": {},
             "int8/int8": dict(weight_quant_enabled=True,
                               kv_quant_enabled=True),
             "fp8/fp8": dict(weight_quant_enabled=True, kv_quant_enabled=True,
                             weight_quant_dtype="fp8_e4m3",
                             kv_quant_dtype="fp8_e4m3")}
    features = {
        "prefix cache": ("prefix", dict(enable_prefix_cache=True), {}, 2),
        "spec K=3": ("spec", {}, {"max_draft_tokens": 3}, 1),
        "spec K=4": ("spec", {}, {"max_draft_tokens": 4}, 1),
        "preemption": ("preempt", dict(
            kv_blocks=14, admission_reservation=True,
            admission_preemption_enabled=True,
            admission_oversubscription_factor=3.0), {}, 1)}
    base = dict(kv_blocks=64, kv_block_size=8, max_chunk_tokens=16,
                max_ragged_batch_size=48)
    for fname, (pkey, ecfg, skw, passes) in features.items():
        for qname, qkw in quant.items():
            streams, stats = {}, {}
            for dev in ("cpu", "cuda"):
                eng = InferenceEngineV2(model, params,
                                        RaggedInferenceEngineConfig(
                                            **dict(base, **ecfg), **qkw),
                                        device=dev)
                out = []
                for p in range(passes):
                    sched = ContinuousBatchingScheduler(
                        eng, proposer=NGramProposer() if skw else None, **skw)
                    for i, pr in enumerate(prompts[pkey]):
                        sched.submit(100 * p + i, pr, max_new_tokens=12,
                                     shed_rank=int(i < 2))
                    fin = sched.run_to_completion()
                    out += [fin[100 * p + i].generated
                            for i in range(len(prompts[pkey]))]
                streams[dev] = out
                stats[dev] = (sched.spec_stats(), sched.preempt_stats(),
                              eng.prefix_stats())
            label = f"small fp32 {fname} {qname}"
            spec, pre, pfx = stats["cuda"]
            if not (spec["accepted"] if "spec" in fname else
                    pre["preempted"] if fname == "preemption" else
                    pfx["tokens_saved"]):
                raise AssertionError(f"[features] {label}: the feature did "
                                     f"not act: {stats['cuda']}")
            if streams["cpu"] != streams["cuda"] or \
                    stats["cpu"] != stats["cuda"]:
                raise AssertionError(f"[features] {label}: the card's "
                                     f"streams or counters differ from the "
                                     f"CPU's: {streams} {stats}")
            log(f"[features] {label}: streams on the card equal the CPU's "
                f"(spec {stats['cuda'][0]}, preemption {stats['cuda'][1]}, "
                f"prefix tokens saved {stats['cuda'][2]['tokens_saved']})")


def profile_feature_puts(engine):
    """torch.profiler over one speculative verify put (8 rows of K + 1 = 4
    tokens after 300-1000 prompt tokens, verify_width 4) and one prefix-hit
    put (a 256-token first chunk at position 2048 after a 2048-token
    match)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(66)
    V = engine.model.cfg.vocab_size
    uids = [23_000 + i for i in range(8)]
    ctx = [rng.integers(0, V, n).tolist()
           for n in (300, 400, 500, 600, 700, 800, 900, 1000)]
    for u, c in zip(uids, ctx):
        for s in range(0, len(c), 256):
            engine.put([u], [c[s:s + 256]])
    engine.configure_prefix_cache(True)
    fill = rng.integers(0, V, FEATURE_PREFIX + 16).tolist()
    for s in range(0, len(fill), 256):
        engine.put([23_100], [fill[s:s + 256]])
    engine.flush(23_100)
    hit = fill[:FEATURE_PREFIX] + rng.integers(0, V, 256).tolist()
    engine.match_prefix(23_101, hit)
    steps = [("verify put: 8 rows x 4 tokens, verify_width 4",
              lambda: engine.put(uids, [rng.integers(0, V, 4).tolist()
                                        for _ in uids], verify_width=4)),
             ("prefix-hit put: 256 tokens at 2048 after a 2048-token match",
              lambda: engine.put([23_101], [hit[FEATURE_PREFIX:]]))]
    try:
        for name, call in steps:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                call()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
            device_summary(prof, wall, "profile features", name, 8)
    finally:
        for u in uids + [23_101]:
            engine.flush(u)
        engine.configure_prefix_cache(False)


def phase_features(profile_puts=False):
    """The features phase: small fp32 card == CPU parity with each feature,
    then MISTRAL_7B at full width (32 layers, bf16): the prefix cache, n-gram
    speculative decoding at K = 3 and 4, reservation admission with
    preemption, KV export/import (bf16, int8 and fp8 pools), preemption
    again with int8 KV, speculative decoding again with int8 weights and
    int8 KV; then the universal checkpoint at full width with 2 layers."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    small_feature_parity()
    cfg = MISTRAL_7B
    log(f"[features] MISTRAL_7B at full width, {cfg.num_layers} layers "
        "(no depth cut), bf16, random weights from a seed")
    model = CausalLM(cfg)
    torch.cuda.empty_cache()
    params = model.init(torch.Generator("cuda").manual_seed(7),
                        device="cuda", dtype=torch.bfloat16)
    engine = InferenceEngineV2(
        model, params, RaggedInferenceEngineConfig(
            kv_block_size=16, max_chunk_tokens=256,
            max_ragged_sequence_count=32, kv_blocks=FEATURE_KV_BLOCKS),
        device="cuda")
    del params
    engine.put([10_000], [list(range(16))])       # warm-up
    engine.flush(10_000)
    res = {}
    gap = feature_gap(engine, "bf16", ("verify K=3", "verify K=4",
                                       "prefix hit"))
    res["prefix"] = feature_prefix(engine, gap)
    res["spec bf16"] = feature_spec(engine, "bf16", gap)
    res["preempt bf16"] = feature_preempt(engine, "bf16", gap)
    if profile_puts:
        profile_feature_puts(engine)
    feature_kv_roundtrip(engine, "bf16 pools")
    res["kv_tier bf16"] = feature_kv_tier(engine, "bf16", gap, trace=True)
    engine.configure_kv_quant(True, "int8")
    gap_kv8 = feature_gap(engine, "bf16 weights + int8 KV", ())
    res["preempt int8 KV"] = feature_preempt(engine, "int8 KV", gap_kv8)
    feature_kv_roundtrip(engine, "int8 pools")
    engine.configure_kv_quant(True, "fp8_e4m3")
    feature_kv_roundtrip(engine, "fp8 pools")
    engine.configure_kv_quant(True, "int8")
    qz.launches["quantize"] = 0
    engine.configure_weight_quant(True, "int8", block=128)
    gc.collect()
    torch.cuda.empty_cache()
    gap_q = feature_gap(engine, "int8 weights + int8 KV",
                        ("verify K=3", "verify K=4"))
    res["spec int8"] = feature_spec(engine, "int8 weights + int8 KV", gap_q)
    res["kv_tier int8"] = feature_kv_tier(engine, "int8 weights + int8 KV",
                                          gap_q)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    res["checkpoint"] = feature_checkpoint()
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------- serving

# The serving stack at MISTRAL_7B width (32 layers, bf16, blocks of 16,
# chunks of 256): ServingFrontend -> admission queue -> router -> replica
# threads, over engines that share one bf16 weight tree (each engine has
# its own KV pools and scheduler).
SERVE_KV_BLOCKS = 1024              # 2 GiB of bf16 KV an engine
SERVE_MAX_SEQS = 8                  # a replica's concurrent sequences
BURST_REQUESTS, BURST_NEW, BURST_QUEUE = 48, 32, 16
BURST_LENGTHS = 16                  # lognormal prompt lengths, cycled
CHAOS_REQUESTS, CHAOS_PROMPT, CHAOS_NEW = 16, 128, 16
CHAOS_CRASH_STEP = 4
CHAOS_KV_BLOCKS = 256               # 16 x 9 blocks and room; 512 MiB
QCFG_REQUESTS, QCFG_SYS, QCFG_TAIL, QCFG_NEW = 8, 1024, 64, 16
KV_BLOCK_BYTES_BF16 = 32 * 2 * 8 * 16 * 128 * 2   # MISTRAL_7B, 2 MiB


def serving_engine(model, params, kv_blocks, put_log=None):
    """One engine over the shared ``params`` (never copied: the tree's
    tensors are the engine's) with its own pool, attached to ``put_log``
    when given, and warmed by one put."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)

    engine = InferenceEngineV2(
        model, params, RaggedInferenceEngineConfig(
            kv_block_size=16, max_chunk_tokens=256,
            max_ragged_sequence_count=SERVE_MAX_SEQS, kv_blocks=kv_blocks),
        device="cuda")
    for mine, shared in zip(tree_tensors(engine.params),
                            tree_tensors(params)):
        if mine.data_ptr() != shared.data_ptr():
            raise AssertionError("[serving] an engine copied the shared "
                                 "weight tensors")
    if put_log is not None:
        put_log.attach(engine)
    engine.put([10_000], [list(range(16))])       # warm-up
    engine.flush(10_000)
    return engine


def watch_deaths(fe):
    """(where, exception type) of every replica death: each one reaches
    the frontend's flight recorder (``dump_on_error``)."""
    if fe._replica_recorder is not fe.recorder:
        raise AssertionError("[serving] replicas report no errors")
    deaths, real = [], fe.recorder.on_error

    def on_error(where, exc):
        deaths.append((where, type(exc).__name__))
        return real(where, exc)

    fe.recorder.on_error = on_error
    return deaths


def latency_stats(first, last, arrival, counts):
    """p50/p95 TTFT and mean TPOT (ms) from per-request timestamps."""
    ttft = [(f - a) * 1e3 for f, a in zip(first, arrival)]
    tpot = [(l - f) * 1e3 / (n - 1)
            for f, l, n in zip(first, last, counts) if n > 1]
    return {"ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p95_ms": float(np.percentile(ttft, 95)),
            "tpot_ms": float(np.mean(tpot))}


def bare_run(engine, prompts, new_tokens, label, first_alone=False):
    """The same prompts through a bare ContinuousBatchingScheduler (all
    submitted at once, or the first alone and then the rest), recording
    each request's top-2 logit margins (the parity rule's "off" run) and
    its token times; the counts are set to 0 just before and read after."""
    sched = margin_scheduler(engine)
    log_ = PutLog()
    log_.attach(engine)
    base, times = 60_000, {}

    def on_token(uid, tok):
        times.setdefault(uid, []).append(time.perf_counter())

    reset_launches()
    t0 = time.perf_counter()
    try:
        waves = ([[0], list(range(1, len(prompts)))] if first_alone
                 else [list(range(len(prompts)))])
        arrival = {}
        for wave in waves:
            for i in wave:
                arrival[base + i] = time.perf_counter()
                sched.submit(base + i, prompts[i], max_new_tokens=new_tokens,
                             on_token=on_token)
            sched.run_to_completion()
        torch.cuda.synchronize()
    finally:
        log_.close()
    wall = time.perf_counter() - t0
    L = engine.model.cfg.num_layers
    if pa.launches != L * len(log_.puts):
        raise AssertionError(f"[serving] {label} bare: {pa.launches} paged "
                             f"launches for {len(log_.puts)} puts")
    uids = [base + i for i in range(len(prompts))]
    streams = [sched.finished[u].generated for u in uids]
    if any(len(s) != new_tokens for s in streams):
        raise AssertionError(f"[serving] {label} bare: stream lengths")
    occ = engine.occupancy()
    if occ["available_blocks"] != engine.config.kv_blocks:
        raise AssertionError(f"[serving] {label} bare: {occ} after the run")
    stats = latency_stats([times[u][0] for u in uids],
                          [times[u][-1] for u in uids],
                          [arrival[u] for u in uids],
                          [len(times[u]) for u in uids])
    stats.update(decode_tps=log_.decode_tps(), puts=len(log_.puts),
                 tokens_per_s=sum(map(len, streams)) / wall, wall_s=wall)
    return {"streams": streams, "stats": stats,
            "margins": [sched.margins.get(u, {}) for u in uids]}


def frontend_stats(handles, log_, wall):
    reqs = [h._req for h in handles]
    stats = latency_stats([r.first_token_t for r in reqs],
                          [r.last_token_t for r in reqs],
                          [r.arrival_t for r in reqs],
                          [len(r.generated_tokens) for r in reqs])
    stats.update(decode_tps=log_.decode_tps(), puts=len(log_.puts),
                 tokens_per_s=sum(len(r.generated_tokens) for r in reqs)
                 / wall, wall_s=wall)
    return stats


def check_replicas(fe, label):
    """No replica's params require grad, and every replica is healthy."""
    for rep in fe.router.replicas:
        if any(t.requires_grad for t in tree_tensors(rep.engine.params)):
            raise AssertionError(f"[serving] {label}: replica "
                                 f"{rep.replica_id} params require grad")
    states = [rep.state.value for rep in fe.router.replicas]
    if any(s != "healthy" for s in states):
        raise AssertionError(f"[serving] {label}: replica states {states}")


def log_compare(label, fe_stats, bare_stats):
    keys = ("ttft_p50_ms", "ttft_p95_ms", "tpot_ms", "decode_tps",
            "tokens_per_s", "puts", "wall_s")
    log(f"[serving] {label}, frontend | bare scheduler: "
        + "; ".join(f"{k} {fe_stats[k]:.2f} | {bare_stats[k]:.2f}"
                    for k in keys))


def serving_burst(model, params):
    """Cell 1: one bf16 replica, queue depth 16, 48 requests submitted at
    once (lognormal lengths around 341, clipped to 64-1024, 32 new tokens,
    priority i % 3, deadline 600 s)."""
    from deepspeed_tpu_torch.serving import (Rejected, RequestState,
                                             ServingConfig, ServingFrontend)

    rng = np.random.default_rng(21)
    V, L = model.cfg.vocab_size, model.cfg.num_layers
    lens = np.clip(np.exp(rng.normal(np.log(1024 / 3), 0.7, BURST_LENGTHS))
                   .astype(int), 64, 1024).tolist()
    prompts = [rng.integers(0, V, lens[i % len(lens)]).tolist()
               for i in range(BURST_REQUESTS)]
    engine = serving_engine(model, params, SERVE_KV_BLOCKS)
    gap = feature_gap(engine, "serving burst", ())
    fe = ServingFrontend([engine], ServingConfig(max_queue_depth=BURST_QUEUE))
    deaths = watch_deaths(fe)
    check_replicas(fe, "burst")
    log_ = PutLog()
    log_.attach(engine)
    handles, shed = {}, 0
    reset_launches()
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(prompts):
            try:
                handles[i] = fe.submit(p, max_new_tokens=BURST_NEW,
                                       priority=i % 3,
                                       deadline_ms=600_000.0)
            except Rejected as e:
                if e.reason != "overloaded":
                    raise
                shed += 1
        done = fe.wait_all(list(handles.values()), timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"paged_attention": pa.launches,
                    "quantized_matmul": qz.launches["quantized_matmul"]}
        snap = fe.metrics_snapshot()
        check_replicas(fe, "burst")
    finally:
        log_.close()
        fe.shutdown(drain=False, timeout=5)
    if not done or any(h.state != RequestState.FINISHED
                       for h in handles.values()):
        raise AssertionError("[serving] burst: not every admitted request "
                             "finished")
    if shed == 0 or snap["requests_shed"] != shed:
        raise AssertionError(f"[serving] burst: {shed} shed, registry "
                             f"{snap['requests_shed']}")
    ends = (snap["requests_completed"] + snap["requests_shed"]
            + snap["requests_expired"])
    if ends != snap["requests_submitted"] or snap["requests_failed"] \
            or deaths:
        raise AssertionError(f"[serving] burst: submitted "
                             f"{snap['requests_submitted']}, ended {ends}, "
                             f"failed {snap['requests_failed']}, deaths "
                             f"{deaths}")
    if launches["paged_attention"] != L * len(log_.puts) \
            or launches["quantized_matmul"]:
        raise AssertionError(f"[serving] burst: launches {launches} for "
                             f"{len(log_.puts)} puts")
    occ = engine.occupancy()
    if occ["available_blocks"] != engine.config.kv_blocks:
        raise AssertionError(f"[serving] burst: {occ} after shutdown")
    idx = sorted(handles)
    on = {"streams": [[ev.token for ev in handles[i].drain()] for i in idx]}
    fe_stats = frontend_stats([handles[i] for i in idx], log_, wall)
    del handles
    bare = bare_run(engine, [prompts[i] for i in idx], BURST_NEW,
                    "burst")
    diverged = parity_rule(bare, on, gap, "serving burst")
    log(f"[serving] burst: {BURST_REQUESTS} submitted, {len(idx)} "
        f"completed, {shed} shed (rate {snap['shed_rate']:.4f}), 0 "
        f"expired, 0 failed, 0 replica deaths; launches "
        f"{json.dumps(launches)} = {L} x {len(log_.puts)} puts; every block "
        "free")
    log_compare("burst", fe_stats, bare["stats"])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"frontend": fe_stats, "bare": bare["stats"],
            "shed_rate": snap["shed_rate"], "completed": len(idx),
            "shed": shed, "diverged": len(diverged), "launches": launches,
            "puts": len(log_.puts)}


def serving_chaos(model, params):
    """Cell 2: 16 requests of 128 tokens, 16 new, through one replica, two,
    and two with replica 0 crashed at step 4 (``fault_tolerance`` on:
    retries 3, backoff 0.05 s, poll 0.02 s; the supervisor restarts it on
    a fresh engine from the same factory)."""
    from deepspeed_tpu_torch.serving import (RequestState, ServingConfig,
                                             ServingFrontend)

    rng = np.random.default_rng(22)
    V, L = model.cfg.vocab_size, model.cfg.num_layers
    prompts = [rng.integers(0, V, CHAOS_PROMPT).tolist()
               for _ in range(CHAOS_REQUESTS)]
    engine = serving_engine(model, params, CHAOS_KV_BLOCKS)
    gap = feature_gap(engine, "serving chaos", ())
    off = bare_run(engine, prompts, CHAOS_NEW, "chaos")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()

    def run(n_replicas, faulted):
        log_ = PutLog(sync=False)

        def factory(i):
            # a restart builds (and warms) its engine mid-run: its puts
            # are logged from the first, as its launches count
            return serving_engine(model, params, CHAOS_KV_BLOCKS, log_)

        scfg = ServingConfig(
            max_queue_depth=64,
            fault_tolerance={"enabled": True, "max_retries": 3,
                             "restart_backoff_s": 0.05,
                             "supervisor_poll_s": 0.02},
            faults=({"enabled": True, "schedule": [
                {"kind": "crash", "replica": 0,
                 "at_step": CHAOS_CRASH_STEP}]} if faulted
                else {"enabled": False}))
        fe = ServingFrontend([factory(i) for i in range(n_replicas)], scfg,
                             engine_factory=factory)
        deaths = watch_deaths(fe)
        check_replicas(fe, "chaos")
        reset_launches()
        log_.puts.clear()                   # the boot engines' warm-ups
        t0 = time.perf_counter()
        try:
            handles = [fe.submit(p, max_new_tokens=CHAOS_NEW)
                       for p in prompts]
            done = fe.wait_all(handles, timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            deadline = time.monotonic() + 60
            while faulted and not fe.supervisor.restart_log \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            deadline = time.monotonic() + 60
            while any(r.state.value != "healthy"
                      for r in fe.router.replicas) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            launches = pa.launches
            snap = fe.metrics_snapshot()
            check_replicas(fe, "chaos")
            restarts = list(fe.supervisor.restart_log)
            fired = [(k, r, i) for k, r, i, _ in
                     (fe.injector.fired_events() if faulted else [])]
        finally:
            log_.close()
            fe.shutdown(drain=False, timeout=5)
        states = [h.state for h in handles]
        attempts = [h.attempts for h in handles]
        streams = [[ev.token for ev in h.drain()] for h in handles]
        stats = frontend_stats(handles, log_, wall)
        del handles, fe
        if not done or any(s != RequestState.FINISHED for s in states):
            raise AssertionError(f"[serving] chaos: states {states}")
        if launches != L * len(log_.puts):
            raise AssertionError(f"[serving] chaos: {launches} paged "
                                 f"launches for {len(log_.puts)} puts")
        return {"streams": streams, "snap": snap, "deaths": deaths,
                "restarts": restarts, "fired": fired, "attempts": attempts,
                "stats": stats}

    one = run(1, False)
    two = run(2, False)
    chaos = run(2, True)
    for name, r in (("one replica", one), ("two replicas", two)):
        if r["deaths"] or r["restarts"] or r["snap"]["requests_failed"] \
                or r["snap"]["requests_failed_over"]:
            raise AssertionError(f"[serving] chaos {name}: deaths "
                                 f"{r['deaths']}, restarts {r['restarts']}")
        parity_rule(off, r, gap, f"serving chaos {name}")
    snap = chaos["snap"]
    retried = [i for i, a in enumerate(chaos["attempts"]) if a > 1]
    if chaos["deaths"] != [("replica-0", "InjectedFault")] \
            or chaos["fired"] != [("crash", 0, CHAOS_CRASH_STEP)] \
            or len(chaos["restarts"]) != 1 or snap["requests_failed"] \
            or snap["requests_failed_over"] < 1 or not retried:
        raise AssertionError(
            f"[serving] chaos: deaths {chaos['deaths']}, fired "
            f"{chaos['fired']}, restarts {chaos['restarts']}, failed "
            f"{snap['requests_failed']}, failed over "
            f"{snap['requests_failed_over']}")
    parity_rule(off, chaos, gap, "serving chaos faulted")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    pool = CHAOS_KV_BLOCKS * KV_BLOCK_BYTES_BF16
    if mem1 - mem0 > pool:
        raise AssertionError(f"[serving] chaos: {mem1 - mem0} bytes still "
                             f"allocated after the cell (one pool is "
                             f"{pool})")
    recovery = chaos["restarts"][0]["recovery_s"]
    ratio = two["stats"]["tokens_per_s"] / one["stats"]["tokens_per_s"]
    log(f"[serving] chaos: the crash of replica 0 at step "
        f"{CHAOS_CRASH_STEP} was the only death (InjectedFault); "
        f"{int(snap['requests_failed_over'])} requests failed over, "
        f"{len(retried)} retried, all finished (retry success 1.0); "
        f"restarted in recovery_s {recovery:.4f}; memory after the cell "
        f"{(mem1 - mem0) / 2**20:+.1f} MiB against before it")
    log(f"[serving] chaos: tokens/s one replica "
        f"{one['stats']['tokens_per_s']:.1f}, two "
        f"{two['stats']['tokens_per_s']:.1f} ({ratio:.2f}x), two with the "
        f"crash {chaos['stats']['tokens_per_s']:.1f}; puts "
        f"{one['stats']['puts']} | {two['stats']['puts']} | "
        f"{chaos['stats']['puts']}; p50 TTFT ms "
        f"{one['stats']['ttft_p50_ms']:.1f} | "
        f"{two['stats']['ttft_p50_ms']:.1f} | "
        f"{chaos['stats']['ttft_p50_ms']:.1f}; TPOT ms "
        f"{one['stats']['tpot_ms']:.2f} | {two['stats']['tpot_ms']:.2f} | "
        f"{chaos['stats']['tpot_ms']:.2f} (puts not synchronized: the "
        f"replicas share the card)")
    return {"recovery_s": recovery, "two_over_one": ratio,
            "failed_over": int(snap["requests_failed_over"]),
            "one": one["stats"], "two": two["stats"],
            "faulted": chaos["stats"], "mem_delta": mem1 - mem0}


def serving_quant_obs(model, params):
    """Cells 3 and 4: one replica with ``weight_quant`` (int8, block 128),
    ``kv_quant`` int8, the prefix cache and reservation admission through
    ``ServingConfig``, and telemetry and an SLO on: 8 requests on a
    1024-token system prompt with 64-token tails, 16 new tokens (the first
    alone, then the rest); then the observability checks and a cancel."""
    from deepspeed_tpu_torch.serving import (RequestState, ServingConfig,
                                             ServingFrontend)
    from deepspeed_tpu_torch.telemetry import (trace_coverage,
                                               validate_chrome_trace)

    rng = np.random.default_rng(23)
    cfg = model.cfg
    V, L = cfg.vocab_size, cfg.num_layers
    system = rng.integers(0, V, QCFG_SYS).tolist()
    prompts = [system + rng.integers(0, V, QCFG_TAIL).tolist()
               for _ in range(QCFG_REQUESTS)]
    blocks = dict(weight_quant={"enabled": True, "dtype": "int8",
                                "block": 128},
                  kv_quant={"enabled": True, "dtype": "int8"},
                  prefix_cache={"enabled": True},
                  admission={"reservation": True})
    scfg = ServingConfig(max_queue_depth=16, **blocks)
    # the engine configured by hand with the calls the config makes
    hand = serving_engine(model, params, SERVE_KV_BLOCKS)
    wq = scfg.weight_quant
    hand.configure_weight_quant(True, dtype=wq.dtype, block=wq.block,
                                skip=list(wq.skip))
    hand.configure_kv_quant(True, "int8", "block")
    gap = feature_gap(hand, "serving int8", ())
    hand.configure_prefix_cache(True, None)
    hand.configure_admission(True)
    off = bare_run(hand, prompts, QCFG_NEW, "int8 config", first_alone=True)
    del hand
    gc.collect()
    torch.cuda.empty_cache()

    dump_dir = tempfile.mkdtemp(prefix="serving_obs_")
    engine = serving_engine(model, params, SERVE_KV_BLOCKS)
    qz.launches["quantize"] = 0
    fe = ServingFrontend([engine], ServingConfig(
        max_queue_depth=16, **blocks,
        telemetry={"enabled": True, "dump_dir": dump_dir},
        slo={"enabled": True, "classes": {
            "interactive": {"ttft_p95_ms": 2000.0}}}))
    quantize_launches = qz.launches["quantize"]
    want_q = 7 + (0 if cfg.tie_embeddings else 1)
    qmm_per_put = 7 * L + (0 if cfg.tie_embeddings else 1)
    try:
        if quantize_launches != want_q or not engine.config.weight_quant_enabled:
            raise AssertionError(f"[serving] int8 config: {quantize_launches} "
                                 f"quantize launches at the build, want "
                                 f"{want_q}")
        deaths = watch_deaths(fe)
        check_replicas(fe, "int8 config")
        log_ = PutLog()
        log_.attach(engine)
        reset_launches()
        t0 = time.perf_counter()
        try:
            handles = [fe.submit(prompts[0], max_new_tokens=QCFG_NEW)]
            done = fe.wait_all(handles, timeout=600)
            handles += [fe.submit(p, max_new_tokens=QCFG_NEW)
                        for p in prompts[1:]]
            done = done and fe.wait_all(handles, timeout=600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"paged_attention": pa.launches,
                        "quantized_matmul": qz.launches["quantized_matmul"]}
        finally:
            log_.close()
        if not done or any(h.state != RequestState.FINISHED for h in handles):
            raise AssertionError("[serving] int8 config: not all finished")
        n_puts = len(log_.puts)
        if launches != {"paged_attention": L * n_puts,
                        "quantized_matmul": qmm_per_put * n_puts}:
            raise AssertionError(f"[serving] int8 config: launches "
                                 f"{launches} for {n_puts} puts")
        snap = fe.metrics_snapshot()
        if snap["prefix_tokens_saved"] <= 0 or snap["requests_failed"] \
                or deaths:
            raise AssertionError(f"[serving] int8 config: prefix tokens "
                                 f"saved {snap['prefix_tokens_saved']}, "
                                 f"failed {snap['requests_failed']}, deaths "
                                 f"{deaths}")
        on = {"streams": [[ev.token for ev in h.drain()] for h in handles]}
        fe_stats = frontend_stats(handles, log_, wall)
        parity_rule(off, on, gap, "serving int8 config")

        # observability: each request's span chain covers its TTFT
        spans = fe.tracer.export()
        covs = []
        for h in handles:
            req = h._req
            chain = {s["name"]: s for s in spans
                     if s["trace_id"] == req.trace_id}
            stages = [chain[n] for n in ("queue", "route", "admit",
                                         "prefill")]
            covs.append(trace_coverage(stages, req.arrival_t,
                                       req.first_token_t))
        if min(covs) < 0.95:
            raise AssertionError(f"[serving] span coverage of TTFT {covs}")
        paths = fe.debug_dump()
        with open(paths["chrome_trace"]) as fh:
            problems = validate_chrome_trace(json.load(fh))
        if problems:
            raise AssertionError(f"[serving] debug dump trace: {problems}")
        prom = fe.render_prometheus()
        text = fe.health_report_text()
        for want in ("serving_requests_completed", "serving_ttft_s_bucket",
                     "serving_prefix_tokens_saved"):
            if want not in prom:
                raise AssertionError(f"[serving] {want} not in /metrics")
        if "requests: submitted=" not in text or "slo " not in text:
            raise AssertionError(f"[serving] health report:\n{text}")
        # a request cancelled mid-stream gets its blocks back at once
        long = fe.submit(system + rng.integers(0, V, QCFG_TAIL).tolist(),
                         max_new_tokens=512)
        deadline = time.monotonic() + 120
        while len(long._req.generated_tokens) < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.002)
        t_cancel = time.perf_counter()
        long.cancel()
        if not long._req.wait(60) or long.state != RequestState.CANCELLED:
            raise AssertionError(f"[serving] cancel: {long.state}")
        deadline = time.monotonic() + 10
        while engine.occupancy()["available_blocks"] \
                != engine.config.kv_blocks and time.monotonic() < deadline:
            time.sleep(0.001)
        cancel_ms = (time.perf_counter() - t_cancel) * 1e3
        occ = engine.occupancy()
        if occ["available_blocks"] != engine.config.kv_blocks:
            raise AssertionError(f"[serving] cancel left {occ}")
        check_replicas(fe, "int8 config")
        if deaths:
            raise AssertionError(f"[serving] int8 config: deaths {deaths}")
    finally:
        fe.shutdown(drain=False, timeout=5)
        shutil.rmtree(dump_dir, ignore_errors=True)
    log(f"[serving] int8 config: {quantize_launches} quantize launches at "
        f"the build, launches {json.dumps(launches)} = ({L}, {qmm_per_put}) "
        f"x {n_puts} puts; prefix tokens saved "
        f"{int(snap['prefix_tokens_saved'])}; span coverage of TTFT "
        f"min {min(covs):.4f}; debug-dump trace valid; /metrics "
        f"{len(prom)} bytes, health report {len(text.splitlines())} lines; "
        f"a cancel mid-stream freed every block in {cancel_ms:.1f} ms")
    log_compare("int8 config", fe_stats, off["stats"])
    del engine, handles, fe
    gc.collect()
    torch.cuda.empty_cache()
    return {"frontend": fe_stats, "bare": off["stats"],
            "quantize_launches": quantize_launches, "launches": launches,
            "puts": n_puts, "coverage_min": min(covs),
            "cancel_ms": cancel_ms,
            "prefix_tokens_saved": snap["prefix_tokens_saved"]}


def phase_serving():
    """The serving phase: ServingFrontend at full MISTRAL_7B width over
    engines that share one bf16 weight tree — the burst cell, the chaos
    cell, and the quantized-through-the-config cell with the observability
    checks."""
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    cfg = MISTRAL_7B
    log(f"[serving] MISTRAL_7B at full width, {cfg.num_layers} layers, "
        "bf16, random weights from a seed, one tree shared by every engine")
    model = CausalLM(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator("cuda").manual_seed(11),
                        device="cuda", dtype=torch.bfloat16)
    res = {}
    t = time.perf_counter()
    res["burst"] = serving_burst(model, params)
    res["burst"]["cell_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["chaos"] = serving_chaos(model, params)
    res["chaos"]["cell_s"] = time.perf_counter() - t
    t = time.perf_counter()
    res["quant"] = serving_quant_obs(model, params)
    res["quant"]["cell_s"] = time.perf_counter() - t
    log("[serving] cell seconds: "
        + ", ".join(f"{k} {v['cell_s']:.1f}" for k, v in res.items()))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ v1 inference

V1_NEW_TOKENS = 32
V1_WAYS = (("v1 bf16", None), ("v1 int8", 8), ("v1 int4", 4))
# dequantize launches of one forward at MISTRAL_7B: per layer wq, wk, wv,
# wo, w_gate, w_in, w_out and the attention and MLP norm stacks (which the
# quantizer's size rule takes at full width), then lm_head and the gathered
# embedding rows
V1_DEQUANT_PER_FORWARD = 9 * 32 + 2
V1_QUANT_LEAVES = 11        # the QuantTensor leaves: the build's quantize launches


def reset_launches():
    pa.launches = 0
    for key in fa.launches:
        fa.launches[key] = 0
    for key in qz.launches:
        qz.launches[key] = 0


def v1_launches():
    return {"dequantize": qz.launches["dequantize"],
            "flash_fwd": fa.launches["fwd"], "paged_attention": pa.launches,
            "quantize": qz.launches["quantize"]}


def v1_small_parity():
    """Small fp32 v1 engines (TINY_TEST, weights x4 so the streams are not
    one repeated token; quant off, int8 and int4; tied and untied) give the
    same greedy streams through the kernels on the card as through the plain
    versions on the CPU."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import TINY_TEST, CausalLM

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, TINY_TEST.vocab_size, n).tolist()
               for n in (5, 40, 17, 33, 100)]
    for tied in (True, False):
        cfg = dataclasses.replace(TINY_TEST, tie_embeddings=tied)
        params = CausalLM(cfg).init(torch.Generator("cpu").manual_seed(4),
                                    device="cpu")
        params = {g: {k: v * 4 if v.dim() >= 2 else v for k, v in sub.items()}
                  for g, sub in params.items()}
        for bits in (None, 8, 4):
            config = {"dtype": "fp32"}
            if bits:
                config["quant"] = {"enabled": True, "bits": bits}
            reset_launches()
            out = {dev: deepspeed_tpu_torch.init_inference(
                       CausalLM(cfg), config=dict(config), params=params,
                       device=dev).generate(prompts, max_new_tokens=12).cpu()
                   for dev in ("cpu", "cuda")}
            n = v1_launches()
            # TINY_TEST's [L, H] norm stacks stay below the size rule: 7
            # matrices a layer, the embedding rows and the unembedding
            want = 13 * (7 * cfg.num_layers + 2) if bits else 0
            if n["dequantize"] != want or n["paged_attention"] \
                    != 12 * cfg.num_layers or n["flash_fwd"] != cfg.num_layers:
                raise AssertionError(f"[v1] small fp32: launches {n}, want "
                                     f"{want} dequantize")
            label = f"{'tied' if tied else 'untied'} {bits or 'fp32'}"
            if not torch.equal(out["cpu"], out["cuda"]):
                bad = (out["cpu"] != out["cuda"]).nonzero()[0].tolist()
                raise AssertionError(f"[v1] small fp32 {label}: greedy streams "
                                     f"differ first at (row, column) {bad}")
            log(f"[v1] small fp32 {label}: greedy streams on the card equal "
                f"the CPU plain path's ({len(prompts)} prompts x 12 tokens; "
                f"launches {json.dumps(n)})")


def v1_step_logits(engine, toks, plen, nxt, step, mode):
    """Logits of one prefill (the real positions) or of the decode step
    after it, with the kernels (``mode`` "kernel"), with every op pinned to
    its plain version ("plain"), or with the plain versions and attention in
    fp32 arithmetic on the same bf16 inputs ("plain_fp32", swapped in here;
    test-only)."""
    plain_flash, plain_paged = fa._attention_torch, pa.paged_attention_torch

    def flash_fp32(q, k, v, *a, **kw):
        o, lse = plain_flash(q.float(), k.float(), v.float(), *a, **kw)
        return o.to(q.dtype), lse

    def paged_fp32(q, kp, vp, *a, **kw):
        return plain_paged(q.float(), kp.float(), vp.float(), *a,
                           **kw).to(q.dtype)

    fa.FORCE_REFERENCE = pa.FORCE_REFERENCE = qz.FORCE_REFERENCE = \
        mode != "kernel"
    if mode == "plain_fp32":
        fa._attention_torch, pa.paged_attention_torch = flash_fp32, paged_fp32
    m = engine.module
    try:
        with torch.no_grad():
            B, T = toks.shape
            cache, tables = m.init_paged_cache(B, T + 1, engine.DECODE_BLOCK)
            logits, cache = m.prefill_paged(engine.params, toks, plen, cache,
                                            tables)
            if step == "prefill":
                return torch.cat([logits[b, :int(plen[b])]
                                  for b in range(B)]).float()
            dec, _ = m.decode_step_paged(engine.params, cache, tables, nxt,
                                         plen)
        return dec.float()
    finally:
        fa.FORCE_REFERENCE = pa.FORCE_REFERENCE = qz.FORCE_REFERENCE = False
        fa._attention_torch, pa.paged_attention_torch = plain_flash, plain_paged


class V1Timer:
    """Wraps a CausalLM's ``prefill_paged`` and ``decode_step_paged`` (as
    instance attributes; ``close`` removes them) to time each call between
    two synchronizations, to keep a device-side flag of finite logits, and
    to trace one decode step with torch.profiler (``profile_step``)."""

    def __init__(self, module, profile_step=None):
        self.module, self.profile_step = module, profile_step
        self.prefill_s, self.decode_s, self.traced_s = [], [], []
        self.finite = torch.ones((), dtype=torch.bool, device="cuda")
        self.trace = None
        real_pre, real_dec = module.prefill_paged, module.decode_step_paged

        def timed(real, secs, step=None):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, cache = real(*a, **kw)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                self.finite &= torch.isfinite(logits).all()
                return logits, cache
            return call

        pre = timed(real_pre, self.prefill_s)
        dec = timed(real_dec, self.decode_s)
        traced = timed(real_dec, self.traced_s)

        def decode(*a, **kw):
            # the traced step's time is kept apart from the decode times
            if len(self.decode_s) != self.profile_step or self.trace:
                return dec(*a, **kw)
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = traced(*a, **kw)
            self.trace = prof
            return out

        module.prefill_paged, module.decode_step_paged = pre, decode

    def close(self):
        del self.module.prefill_paged, self.module.decode_step_paged


def trace_summary(prof, wall_s, label, top=6):
    """Device busy share of a traced decode step, the kernels that took the
    most device time, and the dequantize kernel's device time in it."""
    wall = wall_s * 1e3
    busy, evs = device_summary(prof, wall, label, "traced decode step", top)
    deq = [e for e in evs if "dequantize_kernel" in e.key]
    deq_ms = sum(e.self_device_time_total for e in deq) / 1e3
    deq_n = sum(e.count for e in deq)
    log(f"[{label}] traced decode step: dequantize_kernel {deq_ms:.3f} ms "
        f"x{deq_n}")
    return {"busy_ms": busy, "wall_ms": wall, "dequant_ms": deq_ms,
            "dequant_launches": deq_n}


def v1_dequant_bound(engine, batch):
    """Least time for the dequantization of one decode forward: each
    QuantTensor leaf a forward dequantizes (the embedding: ``batch`` rows)
    moves its int8 codes, its scales and its output once (outputs in the
    compute dtype, norm weights in fp32), at HBM bandwidth."""
    from deepspeed_tpu_torch.inference.quantization import QuantTensor

    p, dt = engine.params, engine.module.cfg.dtype
    nbytes = 0
    for name, leaf in p["layers"].items():
        if isinstance(leaf, QuantTensor):
            item = 4 if name.endswith("norm_w") else dt.itemsize
            n = math.prod(leaf.shape)
            nbytes += dequant_bytes(n, leaf.scales.numel(), item)
    head = p["lm_head"]["w"]
    nbytes += dequant_bytes(math.prod(head.shape), head.scales.numel(),
                            dt.itemsize)
    wte = p["embed"]["wte"]
    nbytes += dequant_bytes(batch * wte.shape[1],
                            batch * wte.scales.shape[1], wte.out_dtype.itemsize)
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def run_v1(label, bits, prompts, eos_run=False):
    """MISTRAL_7B at full width through init_inference -> generate: bf16
    random weights from a seeded generator (quantized at the engine build
    and dropped when ``bits``), the prompts as a ragged list, 32 greedy new
    tokens. Checks the output and the launch counts, holds one prefill and
    one decode step against the plain versions, and measures."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.quantization import tree_nbytes
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    cfg = MISTRAL_7B
    model = CausalLM(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator("cuda").manual_seed(0), device="cuda",
                        dtype=torch.bfloat16)
    config = {"dtype": "bf16"}
    if bits:
        config["quant"] = {"enabled": True, "bits": bits}
    reset_launches()
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(model, config=config,
                                                params=params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_quantize = qz.launches["quantize"]
    del params                  # the engine holds the tree it serves from
    gc.collect()
    torch.cuda.empty_cache()
    weights = tree_nbytes(engine.params)
    if n_quantize != (V1_QUANT_LEAVES if bits else 0):
        raise AssertionError(f"[{label}] {n_quantize} quantize launches at "
                             "the build")
    log(f"[{label}] engine built in {build_s:.2f} s ({n_quantize} quantize "
        f"launches); weights {weights / 1e9:.3f} GB (tree_nbytes)")
    engine.generate([prompts[0][:16]], max_new_tokens=2)     # warm-up

    B, T, new = len(prompts), max(len(p) for p in prompts), V1_NEW_TOKENS
    timer = V1Timer(engine.module, profile_step=new // 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        out = engine.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
    finally:
        timer.close()
    wall = time.perf_counter() - t0
    launches = v1_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if tuple(out.shape) != (B, T + new) or not bool(timer.finite):
        raise AssertionError(f"[{label}] output {tuple(out.shape)}, finite "
                             f"logits {bool(timer.finite)}")
    host = out.cpu().numpy()
    for b, p in enumerate(prompts):
        if not ((host[b, :len(p)] == p).all()
                and (host[b, len(p) + new:] == 0).all()
                and ((0 <= host[b]) & (host[b] < cfg.vocab_size)).all()):
            raise AssertionError(f"[{label}] row {b}: prompt, new tokens or "
                                 "padding out of place")
    want = {"dequantize": (1 + new) * V1_DEQUANT_PER_FORWARD if bits else 0,
            "flash_fwd": cfg.num_layers,
            "paged_attention": new * cfg.num_layers, "quantize": 0}
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, want {want}")
    pre_tokens = sum(len(p) for p in prompts)
    pre_s, dec_s = sum(timer.prefill_s), sum(timer.decode_s)
    res = {"launches": launches, "weights_gb": weights / 1e9, "peak_gb": peak,
           "prefill_tps": pre_tokens / pre_s,
           "decode_tps": B * len(timer.decode_s) / dec_s,
           "prefill_s": pre_s,
           "decode_step_ms": 1e3 * dec_s / len(timer.decode_s),
           "build_s": build_s}
    log(f"[{label}] generate: {B} prompts {[len(p) for p in prompts]} "
        f"(padded to {T}) x {new} new tokens in {wall:.2f} s; launches "
        f"{json.dumps(launches)} (asserted)")
    log(f"[{label}] prefill {pre_tokens} prompt tokens ({B * T} with padding) "
        f"in {pre_s:.3f} s = {res['prefill_tps']:.1f} tokens/s; decode "
        f"{len(timer.decode_s)} untraced steps of {B} in {dec_s:.3f} s "
        f"({res['decode_step_ms']:.2f} ms a step) = "
        f"{res['decode_tps']:.1f} tokens/s; weights "
        f"{weights / 1e9:.3f} GB, peak memory {peak:.2f} GB")
    res["trace"] = trace_summary(timer.trace, timer.traced_s[0], label)
    if bits:
        nbytes, b_ms = v1_dequant_bound(engine, B)
        res["dequant_bound_ms"] = b_ms
        log(f"[{label}] dequantization of one decode forward: "
            f"{res['trace']['dequant_ms']:.3f} ms of dequantize_kernel "
            f"({res['trace']['dequant_launches']} launches) against "
            f"{nbytes / 1e9:.3f} GB moved, bound {b_ms:.3f} ms at 3.35 TB/s")
    if eos_run:
        # the token the first row emits at its fourth step as EOS: that row
        # stops there and pads, the others run on, the same up to their EOS
        eos = int(host[0, len(prompts[0]) + 3])
        again = engine.generate(prompts, max_new_tokens=new,
                                eos_token_id=eos).cpu().numpy()
        for b, p in enumerate(prompts):
            gen_b, again_b = host[b, len(p):len(p) + new], \
                again[b, len(p):len(p) + new]
            hit = np.nonzero(gen_b == eos)[0]
            stop = int(hit[0]) + 1 if len(hit) else new
            if not ((again_b[:stop] == gen_b[:stop]).all()
                    and (again_b[stop:] == 0).all()):
                raise AssertionError(f"[{label}] EOS run, row {b}: "
                                     f"{again_b.tolist()} vs {gen_b.tolist()}")
        log(f"[{label}] EOS run (eos_token_id={eos}): each row equals the "
            "plain run up to its first EOS and is pad after it")
    # one prefill of two prompts (256 and 200 tokens, right-padded) and the
    # decode step after it
    rng = np.random.default_rng(98)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                           dtype=torch.int32, device="cuda")
    plen = torch.tensor([256, 200], dtype=torch.int32, device="cuda")
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, 2),
                          dtype=torch.int32, device="cuda")
    res["steps"] = compare_steps(
        functools.partial(v1_step_logits, engine, toks, plen, nxt), label)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_v1():
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    v1_small_parity()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, MISTRAL_7B.vocab_size, n).tolist()
               for n in MAIN_PROMPT_LENS]
    return {label: run_v1(label, bits, prompts, eos_run=bits is None)
            for label, bits in V1_WAYS}


# ----------------------------------------------------------- training path

TRAIN_LAYERS = 8        # of MISTRAL_7B's 32: 16 bytes a parameter of state
TRAIN_SEQ = 8193        # T = 8192 after the shift: the preset's max_seq_len
assert FLASH_TRAIN_CASE[2] == TRAIN_SEQ - 1
TRAIN_STEPS = 4
TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": 2,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                              "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-5,
                                                 "warmup_max_lr": 1e-4,
                                                 "warmup_num_steps": 2}},
    "gradient_clipping": 1.0,
    "steps_per_print": 1,
    "seed": 0,
}


def tiny_train_parity():
    """A small fp32 TINY_TEST engine gives on the card (through the four
    flash kernels) the loss trajectory it gives on the CPU (through the
    plain versions) to 1e-5: the same fp32 program, summed in other
    orders. Then the same model under fp16 with a dynamic loss scale, on the
    card only: overflows are skipped and the scale comes down until steps
    are taken."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import TINY_TEST, CausalLM

    start = CausalLM(TINY_TEST).init(torch.Generator().manual_seed(5),
                                     device="cpu")
    data = {"input_ids": np.random.default_rng(5).integers(
        0, TINY_TEST.vocab_size, (8, 65)).astype(np.int32)}
    cfg = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=2,
               steps_per_print=100)
    del cfg["bf16"]
    losses = {}
    reset_launches()
    for dev in ("cpu", "cuda"):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=CausalLM(TINY_TEST), config=dict(cfg), training_data=data,
            model_parameters=start, device=dev)
        losses[dev] = [float(engine.train_batch()) for _ in range(6)]
    want = 6 * 2 * TINY_TEST.num_layers
    if any(fa.launches[k] != want for k in fa.launches):
        raise AssertionError(f"[train] tiny fp32: launches {fa.launches}, "
                             f"want {want} each")
    err = max(abs(a - b) for a, b in zip(losses["cpu"], losses["cuda"]))
    if err > 1e-5 or not losses["cuda"][-1] < losses["cuda"][0]:
        raise AssertionError(f"[train] tiny fp32: card {losses['cuda']} vs "
                             f"CPU {losses['cpu']}")
    log(f"[train] tiny fp32 TINY_TEST engine: 6 steps on the card equal the "
        f"CPU's, max |loss diff| {err:.3g} (1e-5 allowed); losses "
        f"{losses['cuda'][0]:.5f} -> {losses['cuda'][-1]:.5f}")
    # fp16 with the dynamic loss scale on the card (float16 q, k, v through
    # the CUDA-core kernels): the first steps overflow and are skipped, the
    # scale halves, later steps are taken
    half = dict(cfg, fp16={"enabled": True, "initial_scale_power": 30,
                           "loss_scale_window": 2, "hysteresis": 1})
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=CausalLM(TINY_TEST), config=half, training_data=data,
        model_parameters=start)
    trace = []
    for _ in range(14):
        loss = float(engine.train_batch())
        trace.append((engine.loss_scale, engine.skipped_steps))
    taken = int(engine.state.global_step)
    if not (np.isfinite(loss) and engine.skipped_steps >= 1 and taken >= 1
            and engine.skipped_steps + taken == 14):
        raise AssertionError(f"[train] tiny fp16: loss {loss}, (scale, "
                             f"skipped) {trace}, {taken} steps taken")
    log(f"[train] tiny fp16 engine on the card: {engine.skipped_steps} of 14 "
        f"steps skipped on overflow, loss scale 2^30 -> "
        f"2^{int(math.log2(engine.loss_scale))}, {taken} steps taken, last "
        f"loss {loss:.5f}")


# A gradient leaf's distance from the fp32-attention run's, as a share of its
# largest entry. With identical attention the two runs would still differ by
# the bf16 roundings of the other operations of 8 layers; the plain bf16
# attention lies 0.047 to 0.049 away on an H100, the kernels 0.030 to 0.033.
MICRO_STEP_TOL = 0.06


def micro_step_check(engine, vocab):
    """One micro step's loss and a few gradient leaves with the kernels
    against the same step with the plain attention pinned, at full width
    and T = 2048 (where the plain version's dense logits of all heads
    fit; the kernels alone are held at T = 8192 in the kernel phase). The
    two differ in bf16 roundings only (the plain forward rounds the logits
    and p to bf16, the kernels keep them in fp32), which 8 layers of
    backward carry into every gradient, so the yardstick is a third run
    whose plain attention works in fp32 arithmetic on the same bf16 q, k, v
    (test-only, swapped in here): the loss with the kernels must agree with
    the plain one to 2e-3, and each gradient leaf must lie within
    MICRO_STEP_TOL of its largest entry of the fp32 attention's and within
    10% of the plain version's."""
    params = engine.state.params
    leaves = {"layers.wq[0]": params["layers"]["wq"],
              "layers.wk[0]": params["layers"]["wk"],
              "layers.w_in[0]": params["layers"]["w_in"],
              "embed.wte": params["embed"]["wte"]}
    tokens = torch.as_tensor(np.random.default_rng(7).integers(
        0, vocab, (1, 2049)), device="cuda")
    plain = (fa._attention_torch, fa._dq_torch, fa._dkv_torch)

    def in_fp32(fn):
        def run(*args):
            dt = args[0].dtype
            up = [a.float() if torch.is_tensor(a) and a.dtype == dt else a
                  for a in args]
            out = fn(*up)
            if torch.is_tensor(out):
                return out.to(dt)
            return tuple(o.to(dt) if o.dim() == 4 else o for o in out)
        return run

    res = {}
    for mode in ("kernel", "plain", "plain_fp32"):
        fa.FORCE_REFERENCE = mode != "kernel"
        if mode == "plain_fp32":
            fa._attention_torch, fa._dq_torch, fa._dkv_torch = map(in_fp32,
                                                                   plain)
        try:
            loss = engine.module.loss(params, {"input_ids": tokens})
            grads = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            fa.FORCE_REFERENCE = False
            fa._attention_torch, fa._dq_torch, fa._dkv_torch = plain
        res[mode] = (float(loss.detach()),
                     [g[0].clone() if n.endswith("[0]") else g
                      for n, g in zip(leaves, grads)])
        del loss, grads
    dl = abs(res["kernel"][0] - res["plain"][0])
    if dl > 2e-3:
        raise AssertionError(f"[train] micro step: loss {res['kernel'][0]} "
                             f"vs plain {res['plain'][0]}")
    parts = []
    for name, gk, gp, g32 in zip(leaves, *(res[m][1] for m in res)):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"[train] micro step: non-finite d{name}")
        top = g32.abs().max()
        d_kp, d_k32, d_p32 = (((a - b).abs().max() / top).item()
                              for a, b in ((gk, gp), (gk, g32), (gp, g32)))
        parts.append(f"{name} {d_kp:.3g} / {d_k32:.3g} / {d_p32:.3g}")
        if d_k32 > MICRO_STEP_TOL or d_kp > 0.1:
            raise AssertionError(
                f"[train] micro step: d{name} with the kernels is "
                f"{d_k32:.3g} of its largest entry from the fp32 "
                f"attention's ({MICRO_STEP_TOL} allowed; the plain "
                f"version's: {d_p32:.3g}) and {d_kp:.3g} from the plain "
                f"version's")
    log(f"[train] one micro step at T=2048, kernels vs plain attention: "
        f"loss {res['kernel'][0]:.5f} vs {res['plain'][0]:.5f} (|diff| "
        f"{dl:.3g}, 2e-3 allowed; fp32 attention "
        f"{res['plain_fp32'][0]:.5f}); max |dgrad| / max |grad| as kernel "
        f"to plain / kernel to fp32 attention / plain to fp32 attention: "
        f"{'; '.join(parts)}")


def profile_train_step(engine):
    """torch.profiler over one train_batch: the share of the step's device
    time in each flash kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.train_batch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy, evs = device_summary(prof, wall, "profile train",
                               "one train_batch", 12)
    for key in ("flash_fwd", "flash_dq", "flash_dkv", "flash_delta"):
        ms = sum(e.self_device_time_total for e in evs if key in e.key) / 1e3
        n = sum(e.count for e in evs if key in e.key)
        log(f"[profile train]   {key}: {ms:.1f} ms x{n} "
            f"({100 * ms / busy:.1f}% of device time)")
    gemm = sum(e.self_device_time_total for e in evs
               if "nvjet" in e.key or "gemm" in e.key.lower()) / 1e3
    log(f"[profile train]   library GEMMs (projections, MLP, lm_head): "
        f"{gemm:.1f} ms ({100 * gemm / busy:.1f}% of device time)")


def run_training(label, layers, seq, steps, remat=False, checks=False,
                 profile_step=False):
    """Build MISTRAL_7B at full width and ``layers`` layers through
    ``initialize`` and take ``steps`` optimizer steps of 2 micro steps on 2
    random sequences of ``seq`` tokens (the same 2 each step). Returns the
    launch counts of the steps and what was measured."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=layers, remat=remat)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = {"input_ids": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)}
    t0 = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg), config=dict(TRAIN_CONFIG), training_data=data)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in
                   tree_tensors(engine.state.params))
    log(f"[{label}] MISTRAL_7B widths, {layers} of 32 layers: "
        f"{n_params / 1e9:.3f} B parameters, fp32 master + 2 moments + "
        f"accumulator {16 * n_params / 1e9:.1f} GB, built in "
        f"{time.perf_counter() - t0:.2f} s; remat {remat}")
    reset_launches()
    losses, norms, secs = [], [], []
    for step in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = engine.train_batch()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
        log(f"[{label}] step {step + 1}: loss {losses[-1]:.4f}, grad norm "
            f"{norms[-1]:.4f}, next lr {engine.get_lr()[0]:.3g}, "
            f"{secs[-1]:.2f} s = {2 * (seq - 1) / secs[-1]:.1f} tokens/s")
    launches = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"[{label}] non-finite loss or grad norm: "
                             f"{losses} {norms}")
    if engine.global_steps != steps or engine.skipped_steps != 0 \
            or int(engine.state.global_step) != steps:
        raise AssertionError(f"[{label}] {engine.global_steps} steps, "
                             f"{engine.skipped_steps} skipped")
    per = steps * 2 * layers
    want = {"fwd": per * (2 if remat else 1), "delta": per, "dq": per,
            "dkv": per}
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, want {want}")
    log(f"[{label}] {steps} optimizer steps x 2 micro steps: launches "
        f"{json.dumps(launches)} (asserted); peak memory {peak:.2f} GB")
    if checks:
        # random weights at std 0.02: the final norm gives x unit RMS, so a
        # logit is a sum of hidden_size products with variance hidden_size *
        # 0.02^2, and the expected loss of independent logits of variance v
        # is ln(vocab) + v / 2 (10.373 + 0.819 at these widths)
        first = math.log(cfg.vocab_size) + cfg.hidden_size * 0.02 ** 2 / 2
        if abs(losses[0] - first) > 0.05:
            raise AssertionError(f"[{label}] first loss {losses[0]} is not "
                                 f"within 0.05 of ln(vocab) + hidden * "
                                 f"0.02^2 / 2 = {first:.3f}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"[{label}] the loss did not fall: {losses}")
        micro_step_check(engine, cfg.vocab_size)
    if profile_step:
        profile_train_step(engine)
    res = {"launches": launches, "losses": losses, "peak_gb": peak,
           "tokens_per_s": [2 * (seq - 1) / s for s in secs],
           "step_s": secs}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def tree_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_tensors(v)
    else:
        yield tree


def traced_train_step(first_loss):
    """One ``train_batch`` of the train phase's configuration with the
    ``telemetry`` block on: ``fwd_bwd`` spans (one a micro step) and an
    ``optimizer_step`` span on the "train" trace, whose durations sum to
    the synchronized step wall within 5%, and a loss equal to the untraced
    run's first."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    data = {"input_ids": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, TRAIN_SEQ)).astype(np.int32)}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg),
        config=dict(TRAIN_CONFIG, telemetry={"enabled": True}),
        training_data=data)
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    loss = float(engine.train_batch())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    spans = engine.tracer.export()
    names = sorted(s["name"] for s in spans)
    total = sum(s["t_end"] - s["t_start"] for s in spans)
    per = 2 * TRAIN_LAYERS
    launches = dict(fa.launches)
    if names != ["fwd_bwd", "fwd_bwd", "optimizer_step"] \
            or {s["trace_id"] for s in spans} != {"train"}:
        raise AssertionError(f"[train traced] spans {names}")
    if abs(total - wall) > 0.05 * wall:
        raise AssertionError(f"[train traced] spans sum to {total:.4f} s "
                             f"of a {wall:.4f} s step")
    if loss != first_loss:
        raise AssertionError(f"[train traced] loss {loss} != the untraced "
                             f"run's {first_loss}")
    if launches != {"fwd": per, "delta": per, "dq": per, "dkv": per}:
        raise AssertionError(f"[train traced] launches {launches}")
    log(f"[train traced] one step with telemetry on: spans "
        + ", ".join(f"{s['name']} {(s['t_end'] - s['t_start']) * 1e3:.1f} ms"
                    for s in spans)
        + f" sum to {total * 1e3:.1f} ms of a {wall * 1e3:.1f} ms "
        f"synchronized step ({total / wall:.4f}); loss {loss:.6f} equals the "
        f"untraced run's; launches {json.dumps(launches)}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"span_s": total, "step_s": wall, "loss": loss}


def phase_train(profile_step=False):
    tiny_train_parity()
    res = run_training("train", TRAIN_LAYERS, TRAIN_SEQ, TRAIN_STEPS,
                       checks=True, profile_step=profile_step)
    run_training("train remat", 2, 2049, 1, remat=True)
    res["traced"] = traced_train_step(res["losses"][0])
    return res


# ------------------------------------------------------------------ main

KERNEL_SOURCES = {
    "paged_attention": ("paged_attention.cu",
                        "deepspeed_tpu/ops/paged_attention.py:63"),
    "paged_attention_quant": ("paged_attention.cu",
                              "deepspeed_tpu/ops/paged_attention.py:63"),
    "quantize": ("quantize.cu", "deepspeed_tpu/ops/quantizer.py:130"),
    "quantized_matmul": ("quantized_matmul.cu",
                         "deepspeed_tpu/ops/quantizer.py:257"),
    "dequantize": ("dequantize.cu", "deepspeed_tpu/ops/quantizer.py:142"),
    "flash_fwd": ("flash_attention.cu",
                  "deepspeed_tpu/ops/flash_attention.py:92"),
    "flash_dq": ("flash_attention.cu",
                 "deepspeed_tpu/ops/flash_attention.py:148"),
    "flash_dkv": ("flash_attention.cu",
                  "deepspeed_tpu/ops/flash_attention.py:190"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace two puts of the bf16 and int8 paths")
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel phase (no result lines)")
    ap.add_argument("--only", choices=["timing", "main", "quant", "v1",
                                       "features", "kv_tier", "serving",
                                       "train"],
                    help="after device, build and kernel run this phase "
                         "alone (no result lines)")
    ap.add_argument("--compare", action="store_true",
                    help="after device and build, time the kernels at the "
                         "main path's shapes through their entry points "
                         "alone, so that a copy of this script in another "
                         "checkout times that checkout (no result lines)")
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
    if args.compare:
        timed("compare", phase_compare)
        log(f"[done] --compare: {json.dumps(secs)}")
        return
    errs = timed("kernel", phase_kernel)
    if args.quick:
        log(f"[done] --quick: {json.dumps(secs)}")
        return
    if args.only:
        phase = {"timing": phase_timing, "main": phase_main,
                 "quant": phase_quant, "v1": phase_v1,
                 "features": phase_features, "kv_tier": phase_kv_tier,
                 "serving": phase_serving, "train": phase_train}[args.only]
        kw = {} if args.only in ("timing", "v1", "kv_tier", "serving") else {
            "profile_step" if args.only == "train" else "profile_puts":
            args.profile}
        timed(args.only, phase, **kw)
        log(f"[done] --only {args.only}: {json.dumps(secs)}")
        return
    times = timed("timing", phase_timing)
    main_res = timed("main", phase_main, profile_puts=args.profile)
    int8, fp8 = timed("quant", phase_quant, profile_puts=args.profile)
    v1 = timed("v1", phase_v1)
    features = timed("features", phase_features, profile_puts=args.profile)
    serving = timed("serving", phase_serving)
    train = timed("train", phase_train, profile_step=args.profile)
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
                "quantized_matmul": int8["launches"]["quantized_matmul"],
                "dequantize": v1["v1 int8"]["launches"]["dequantize"],
                "flash_fwd": train["launches"]["fwd"],
                "flash_dq": train["launches"]["dq"],
                "flash_dkv": train["launches"]["dkv"]}
    log("[v1] MISTRAL_7B, 8 ragged prompts x 32 new tokens, bf16 | int8 | "
        "int4 weights: prefill tokens/s "
        + " | ".join(f"{r['prefill_tps']:.1f}" for r in v1.values())
        + "; decode tokens/s "
        + " | ".join(f"{r['decode_tps']:.1f}" for r in v1.values())
        + "; weights GB "
        + " | ".join(f"{r['weights_gb']:.3f}" for r in v1.values())
        + "; peak GB " + " | ".join(f"{r['peak_gb']:.2f}" for r in v1.values()))
    log(f"[features] MISTRAL_7B, 32 layers: prefix cache warm pass "
        f"{features['prefix']['warm']}; spec (proposed/accepted/decode "
        f"puts) bf16 "
        + ", ".join(f"{k} {v['proposed']}/{v['accepted']}/{v['puts']}"
                    for k, v in features["spec bf16"].items())
        + "; int8 "
        + ", ".join(f"{k} {v['proposed']}/{v['accepted']}/{v['puts']}"
                    for k, v in features["spec int8"].items())
        + f"; preemption bf16 {features['preempt bf16']}, int8 KV "
        f"{features['preempt int8 KV']}; checkpoint "
        f"{features['checkpoint']['gb']:.3f} GB loaded in "
        f"{features['checkpoint']['load_s']:.2f} s; KV tier pass-2 p50 TTFT "
        f"(off/on ms) bf16 "
        f"{features['kv_tier bf16']['ttft_p50_ms']['off']:.1f}/"
        f"{features['kv_tier bf16']['ttft_p50_ms']['on']:.1f}, int8 "
        f"{features['kv_tier int8']['ttft_p50_ms']['off']:.1f}/"
        f"{features['kv_tier int8']['ttft_p50_ms']['on']:.1f}")
    b, c, q = serving["burst"], serving["chaos"], serving["quant"]
    log(f"[serving] MISTRAL_7B through ServingFrontend: burst shed rate "
        f"{b['shed_rate']:.4f}, p50/p95 TTFT {b['frontend']['ttft_p50_ms']:.1f}"
        f"/{b['frontend']['ttft_p95_ms']:.1f} ms (bare scheduler "
        f"{b['bare']['ttft_p50_ms']:.1f}/{b['bare']['ttft_p95_ms']:.1f}), "
        f"tokens/s {b['frontend']['tokens_per_s']:.1f} (bare "
        f"{b['bare']['tokens_per_s']:.1f}); chaos recovery_s "
        f"{c['recovery_s']:.4f}, two replicas / one {c['two_over_one']:.2f}x; "
        f"int8 config {q['puts']} puts, span coverage {q['coverage_min']:.4f}")
    log(f"[train] MISTRAL_7B widths, {TRAIN_LAYERS} layers, bf16, AdamW: "
        f"tokens/s per step {[round(t, 1) for t in train['tokens_per_s']]}, "
        f"peak memory {train['peak_gb']:.2f} GB")
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
