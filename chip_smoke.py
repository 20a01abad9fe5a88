#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

    python3 chip_smoke.py            # one NVIDIA H100; exits non-zero on any failure

Phases, each of which raises on failure (nothing is caught):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every kernel of the port with nvcc (sm_90a) from the
             sources in this checkout, in parallel; print the build time.
3. kernel  — hold each kernel against its plain PyTorch version on the card
             (bf16 and fp32, decode and prefill chunks, G = 1 and 4,
             D = 64 and 128, negative table entries, padded rows, ALiBi, a
             window smaller than the context) on valid rows; then time it at
             the serving path's shapes beside its bound, its plain version
             and one PyTorch library call.
4. main    — the serving path at full MISTRAL_7B width (32 layers, bf16,
             random weights from a seeded torch.Generator): greedy
             generation of 32 tokens for 8 requests through
             InferenceEngineV2 and the Dynamic SplitFuse scheduler. Checks
             token counts, finite logits, that every put launched the paged
             kernel once per layer, that the pool's blocks all come back,
             that one prefill and one decode step agree with the plain
             attention, and that a small fp32 model gives the same greedy
             streams on the card as on the CPU.

The last lines are one ``{"kernels": [...]}`` JSON object, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.

``--profile`` adds a torch.profiler trace of two main-path puts (the
breakdown in PERF.md section 5).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import paged_attention as pa

PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor cores
# Tolerances of the kernel against its plain version, |k - ref| <= atol +
# rtol * |ref| on valid rows. bf16: both write a bf16 output (one rounding
# of 2^-8 relative each) and the plain version also rounds p to bf16
# before p @ V (another 2^-8 relative); 2e-2 covers a few such roundings at
# |o| <= 1. fp32: both compute in fp32 and differ only in summation order
# over at most a few thousand terms.
TOL = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}

MAIN_PROMPT_LENS = (17, 64, 129, 250, 333, 511, 700, 4600)
MAIN_NEW_TOKENS = 32


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
        for line in log_text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
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


def phase_kernel():
    max_err = 0.0
    for (name, ctxs, C, H, KH, D, bs, dtype, n_pad, alibi,
         window) in KERNEL_CASES:
        q, kp, vp, tbl, sp, nt = make_case(len(name), ctxs, C, H, KH, D, bs,
                                           dtype, n_pad)
        slopes = (torch.tensor([2.0 ** (-8.0 * (i + 1) / H) for i in range(H)],
                               device="cuda") if alibi else None)
        kw = dict(alibi_slopes=slopes, window=window)
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
        if dtype == torch.bfloat16:       # the serving path's dtype
            max_err = max(max_err, err)
        log(f"[kernel] {name}: ok, max |kernel - plain| = {err:.3g} "
            f"({str(dtype).split('.')[-1]}, atol {atol}, rtol {rtol})")
    return max_err


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
    must move (q read, o written, each live K/V position read once, the
    tables and lengths) over HBM bandwidth, and its flops (QK and PV over
    each row's live positions) over the bf16 tensor-core peak (the timed
    inputs are bf16)."""
    N, C, H, D = q.shape
    KH = kp.shape[1]
    item = q.element_size()
    rows, seqs = live_spans(sp.tolist(), nt.tolist(), C, window)
    kv_bytes = sum(seqs) * KH * D * item * 2
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


def timing_case(label, ctxs, C, window, flush, seed=7):
    q, kp, vp, tbl, sp, nt = make_case(seed, ctxs, C, 32, 8, 128, 16,
                                       torch.bfloat16)
    kw = dict(window=window)
    ms = time_ms(lambda: pa.paged_attention_cuda(q, kp, vp, tbl, sp, nt, **kw),
                 flush)
    plain_ms = time_ms(lambda: pa.paged_attention_torch(q, kp, vp, tbl, sp,
                                                        nt, **kw), flush,
                       iters=5, warmup=1)
    lib_ms = time_ms(sdpa_dense(q, kp, vp, tbl, sp, nt, window), flush)
    b_ms, by = bound(q, kp, tbl, sp, nt, window)
    row = {"case": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": by, "library_ms": lib_ms}
    log(f"[timing] {json.dumps(row)}")
    return row


def phase_timing():
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    main_ctx = [n + MAIN_NEW_TOKENS - 1 for n in MAIN_PROMPT_LENS]
    rows = [timing_case("decode N=8, the main path's 8 contexts at its last "
                        "step, window 4096", main_ctx, 1, 4096, flush)]
    for N in (8, 32):
        ctxs = [int(c) for c in np.linspace(512, 2048, N)]
        rows.append(timing_case(f"decode N={N}, contexts 512-2048", ctxs, 1,
                                4096, flush))
    rows.append(timing_case("prefill chunk C=256 at positions 3840-4095, "
                            "window 4096", [4096], 256, 4096, flush))
    del flush
    return rows


# ------------------------------------------------------------ main path

def small_parity():
    """The small-input reference: a TINY_TEST-shaped fp32 model (weights
    scaled x4 so greedy streams are not one repeated token) gives the same
    greedy streams through the kernel on the card as through the plain
    version on the CPU."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.testing import (
        assert_greedy_parity, greedy_generate)
    from deepspeed_tpu_torch.models.transformer import TINY_TEST, CausalLM

    model = CausalLM(TINY_TEST)
    params = model.init(torch.Generator("cpu").manual_seed(3), device="cpu")
    params = {g: {k: v * 4 if v.dim() >= 2 else v for k, v in sub.items()}
              for g, sub in params.items()}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, TINY_TEST.vocab_size, n).tolist()
               for n in (5, 40, 17, 33, 100)]
    kw = dict(kv_blocks=64, max_chunk_tokens=16, max_ragged_batch_size=32)
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = InferenceEngineV2(model, params,
                                RaggedInferenceEngineConfig(**kw), device=dev)
        streams[dev] = greedy_generate(eng, prompts, max_new_tokens=12,
                                       sequential=False)
    assert_greedy_parity(streams["cpu"], streams["cuda"], "the CUDA kernel")
    log(f"[main] small fp32 model: greedy streams on the card equal the "
        f"CPU plain path's ({len(prompts)} requests x 12 tokens)")

def step_logits(engine, prompts, step, mode):
    """Logits of one prefill step (two sequences, 256 and 200 prompt
    tokens) or of the decode step after it, with the paged attention run by
    ``mode``: the kernel, the plain version, or the plain version in fp32
    arithmetic (pools upcast per call, output rounded once to bf16 — the
    exact-softmax yardstick; test-only, swapped in here)."""
    plain = pa.paged_attention_torch

    def plain_fp32(q, k_pool, v_pool, *args, **kw):
        return plain(q.float(), k_pool.float(), v_pool.float(), *args,
                     **kw).to(q.dtype)

    pa.FORCE_REFERENCE = mode != "kernel"
    if mode == "plain_fp32":
        pa.paged_attention_torch = plain_fp32
    uids = [20_000, 20_001]
    try:
        out = engine.put(uids, [prompts[6][:256], prompts[7][:200]])
        if step == "decode":
            out = engine.put(uids, [[prompts[6][256]], [prompts[7][200]]])
        return out.float()
    finally:
        pa.FORCE_REFERENCE = False
        pa.paged_attention_torch = plain
        for u in uids:
            engine.flush(u)


def compare_steps(engine, prompts):
    """One prefill and one decode step through the kernel against the plain
    version. All three runs differ only in rounding inside attention, which
    32 layers amplify; the check is that the kernel's logits are no further
    from the fp32-arithmetic attention's than the plain bf16 version's are
    (the plain version rounds p to bf16 before p @ V; the kernel keeps p in
    fp32)."""
    for step in ("prefill", "decode"):
        k, p, p32 = (step_logits(engine, prompts, step, m)
                     for m in ("kernel", "plain", "plain_fp32"))
        if not torch.isfinite(k).all():
            raise AssertionError(f"[main] {step}: non-finite logits")
        d_kp = (k - p).abs().max().item()
        d_k32 = (k - p32).abs().max().item()
        d_p32 = (p - p32).abs().max().item()
        agree = (k.argmax(-1) == p.argmax(-1)).float().mean().item()
        log(f"[main] {step} step logits (max |logit| "
            f"{p32.abs().max().item():.4g}): max |kernel - plain| = "
            f"{d_kp:.4g}, max |kernel - fp32 attention| = {d_k32:.4g}, "
            f"max |plain - fp32 attention| = {d_p32:.4g}; argmax agreement "
            f"kernel/plain {agree:.2f}")
        if d_k32 > d_p32:
            raise AssertionError(
                f"[main] {step}: the kernel's logits are further from fp32 "
                f"attention ({d_k32:.4g}) than the plain version's "
                f"({d_p32:.4g})")


def profile_steps(engine, prompts, top=8):
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
    for label, us, chunks in steps:
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
        log(f"[profile] {label}: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms ({100 * busy / wall:.1f}%)")
        for e in evs[:top]:
            log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
                f"x{e.count:<5d} {e.key[:90]}")
    for u in uids:
        engine.flush(u)


def phase_main(seed=0, profile_puts=False):
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.testing import greedy_generate
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    small_parity()

    cfg = MISTRAL_7B
    model = CausalLM(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(seed),
                        device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = sum(v.numel() * v.element_size() for sub in params.values()
                 for v in sub.values())
    log(f"[main] MISTRAL_7B weights: {nbytes / 1e9:.2f} GB bf16, "
        f"{cfg.num_layers} layers, made in {time.perf_counter() - t0:.1f} s")
    kv_blocks = 1024
    ecfg = RaggedInferenceEngineConfig(kv_block_size=16, max_chunk_tokens=256,
                                       max_ragged_sequence_count=32,
                                       kv_blocks=kv_blocks)
    engine = InferenceEngineV2(model, params, ecfg, device="cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in MAIN_PROMPT_LENS]

    # warm-up (cuBLAS handles, allocator): one short request, flushed
    engine.put([10_000], [prompts[0][:16]])
    engine.flush(10_000)
    torch.cuda.synchronize()

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
            raise AssertionError("non-finite or mis-shaped logits")
        return int(np.argmax(logits))

    engine.put = timed_put
    pa.launches = 0
    t0 = time.perf_counter()
    streams = greedy_generate(engine, prompts, max_new_tokens=MAIN_NEW_TOKENS,
                              sequential=False, sample_fn=checked_argmax)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.launches
    engine.put = real_put

    if any(len(s) != MAIN_NEW_TOKENS for s in streams):
        raise AssertionError(f"[main] stream lengths {[len(s) for s in streams]}")
    if launches != cfg.num_layers * len(puts):
        raise AssertionError(f"[main] {launches} kernel launches for "
                             f"{len(puts)} puts x {cfg.num_layers} layers")
    if engine.free_blocks != kv_blocks:
        raise AssertionError(f"[main] {engine.free_blocks} of {kv_blocks} "
                             "blocks free after the run")
    pre = [(n, s) for n, is_pre, s in puts if is_pre]
    dec = [(n, s) for n, is_pre, s in puts if not is_pre]
    pre_tps = sum(n for n, _ in pre) / sum(s for _, s in pre)
    dec_tps = sum(n for n, _ in dec) / sum(s for _, s in dec)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[main] served {len(prompts)} requests (prompts "
        f"{list(MAIN_PROMPT_LENS)}) x {MAIN_NEW_TOKENS} new tokens in "
        f"{wall:.2f} s: {len(puts)} puts ({len(pre)} with prompt chunks, "
        f"{len(dec)} decode-only), {launches} paged-kernel launches = "
        f"{cfg.num_layers} x puts; free blocks back to {kv_blocks}")
    log(f"[main] prefill puts: {sum(n for n, _ in pre)} tokens in "
        f"{sum(s for _, s in pre):.3f} s = {pre_tps:.1f} tokens/s; "
        f"decode-only puts: {sum(n for n, _ in dec)} tokens in "
        f"{sum(s for _, s in dec):.3f} s = {dec_tps:.1f} tokens/s; "
        f"peak memory {peak:.2f} GB")

    compare_steps(engine, prompts)
    if profile_puts:
        profile_steps(engine, prompts)
    return {"launches": launches, "puts": len(puts), "prefill_tps": pre_tps,
            "decode_tps": dec_tps, "peak_gb": peak}


# ------------------------------------------------------------------ main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace two puts of the main path")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    max_err = phase_kernel()
    head = phase_timing()[0]
    main_res = phase_main(profile_puts=args.profile)
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "deepspeed_tpu/ops/paged_attention.py:63",
        "launches": main_res["launches"],
        "max_abs_err": max_err,
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["case"],
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
