#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

    python3 chip_smoke.py            # one NVIDIA H100; exits non-zero on any failure

Phases, each of which raises on failure (nothing is caught):

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every kernel of the port with nvcc (sm_90a) from the
             sources in this checkout, one nvcc per source, in parallel.
3. kernel  — hold each kernel against its plain PyTorch version on the card:
             the paged attention (bf16 and fp32, and int8 and fp8 pools:
             decode and prefill chunks, G = 1, 4 and 71 (Falcon-7B's 71
             query heads over one KV head), D = 64 and 128,
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
7. v1      — v1 inference at full MISTRAL_7B width (8 layers, bf16
             compute, random bf16 weights from a seeded generator) through
             init_inference and generate: the main path's 8 prompts as one
             ragged batch, 32 greedy new tokens, with bf16 weights, then
             int8 and int4 weight-only quantization (quantized at the build,
             11 quantize launches, and the dense tree dropped). Checks the
             output's shape and placement, finite logits, the launch counts
             ((1 + 32) x 74 dequantize, 8 flash forward, 32 x 8 paged at
             bs = 128), an EOS run, one prefill and one decode step against
             the plain versions, and that small fp32 v1 engines (quant off,
             8 and 4; tied and untied) give the same greedy streams on the
             card as on the CPU. Traces one decode step of each way.
8. features — the v2 serving features: small fp32 engines give the same
             greedy streams and counters on the card as on the CPU with the
             prefix cache, speculation at K = 3 and 4, and preemption (dense,
             int8 and fp8); then one MISTRAL_7B engine at full width (2
             of its 32 layers, bf16): the kernels' logits against the plain
             versions' on a verify put and a prefix-hit chunk (the gap the greedy-
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
             (and 57 quantized-matmul launches with int8 weights); the KV
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
             telemetry) at full MISTRAL_7B width (8 layers, bf16, blocks of
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
             (8 quantize launches at the build, 57 quantized-matmul
             launches a put, prefix tokens saved, each request's span chain
             covering its TTFT, a valid debug-dump trace, the Prometheus
             text and health report, a cancel that frees every block);
             then item 10b's cells: 16 requests (prompts of 64-2048
             tokens, 32 new) through a prefill and a decode replica with
             the KV handoff, bf16 and with int8 weights + int8 KV (16
             handoffs, 0 fallbacks; the prefill replica feeds each prompt
             token once, the decode replica only one-token rows over the
             blocks it imported), beside one and two mixed replicas, and
             with 2 staging slots (counted fallbacks); tenants gold and
             silver (weights 2:1) flooding one replica with a capped
             tenant over its token rate (submitted = completed + shed +
             expired per tenant, tenant_throttled fires; the dispatched
             token share while both floods were backlogged); 6 system
             prompts of 1024 tokens sent 4 times to two replicas with
             prefix affinity off and on, then add_replica() with warm-up
             and a first shared-prefix request that matches the warmed
             blocks; the autoscaler growing on a burst and shrinking near
             its tail with evacuation (its decision log equal to the
             journal, memory back within one pool), and an explicit
             set_replica_role of a prefill replica mid-traffic.
             Each run's counts are set to 0 just before it and read after:
             8 paged launches a put; every stream holds to the same
             prompts through a bare scheduler by the greedy-parity rule;
             no replica dies outside the chaos run and no replica's params
             require grad. Prints TTFT, TPOT and tokens/s beside the bare
             scheduler's, recovery_s and two replicas' tokens/s against
             one's, the split fleet's against one and two mixed replicas,
             handoff_s and payload bytes, the tenants' shares and TTFTs,
             prefix hit rates off and on, warm-up blocks and time, and the
             autoscaler's grow-decision-to-serving time and
             replica_seconds.
10. fabric — the cross-process serving fabric: MISTRAL_7B replicas (8
             layers, bf16, seeded weights) each in its own
             ``python -m deepspeed_tpu_torch.scripts.serve_replica``
             process on the card, the frontend in this one. The reference
             streams come first, from a bare scheduler over an engine built
             from the servers' own spec here (dropped before any server
             starts). (a) the serving chaos cell's traffic (16 x 128
             tokens, 32 new) through one replica process and two, and two
             of its prompts one at a time (byte-identical to the
             reference); (b) the disagg cell's traffic through a prefill
             and a decode process, bf16, int8 weights + KV and bf16
             weights + fp8 KV, the KV in chunk frames (16 handoffs, 0
             fallbacks; export, wire, queue and import times on one
             clock); (c) a SIGKILL of one of two
             servers mid-decode (requests fail over, replica_disconnected),
             its respawn on the same port re-dialed with reset
             (replica_reconnected), and a seeded drop_conn on the live link
             to it; (d) a ``serve_frontend`` process exporting its replica,
             adopted here beside a replica process, then SIGKILLed
             mid-decode (its requests fail over); (e) every server's stop
             line: 8 paged launches a put, and with int8 57
             quantized-matmul launches a put and 8 quantize launches. Every
             stream holds to the reference by the greedy-parity rule;
             every wait has a timeout, and every process is stopped in a
             ``finally``.
11. train  — the training path at full MISTRAL_7B width, 8 of its 32 layers
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
12. train_state — training state at MISTRAL_7B widths, bf16, the train
             phase's configuration, checkpoints under build/ (the free disk
             checked and printed first, every tag removed in a
             ``finally``): (a) 1 layer, 4 steps unbroken against 2 steps,
             a sync and an async save (``latest`` committed only after
             the wait, after the tag's leaves), a fresh engine's load and
             steps 3-4: losses, counters, lr and every param leaf
             bit-identical, 2 x 1 launches of each flash kernel a step;
             (e) on that tag, zero_to_fp32 rebuilds every master bit for
             bit and save_16bit_model's bf16 members ('<V2' headers) equal
             the masters cast to bf16; (b) TrainingSupervisor at 1 layer
             over a seeded crash, SIGTERM (run() again), three NaN-gradient
             steps (a rollback) and a wedged step (a fresh engine from the
             factory): losses_by_step equal to the unbroken run's bit for
             bit, the journal's events, the urgent save against the grace;
             (c) 2 layers: 2 steps, an urgent save, step 3, and a fresh
             engine's load whose step 3 loss is bit-identical (save and load
             seconds, the snapshot's host RAM); (d) one micro step with
             remat off, nothing_saveable and dots_saveable at 1 layer:
             the loss and every gradient leaf bit-identical, the forward
             launched twice a layer under both policies, peak memory and
             seconds.
13. offload — ZeRO-Offload and ZeRO-Infinity at MISTRAL_7B widths, bf16,
             AdamW, one 4096-token sequence a step, page-locked host
             masters, the C++ host optimizer asserted loaded: (a) 2 layers,
             4 steps with the moments in host RAM at ratio 1.0 against the
             on-device engine from the same seed (losses within 2e-4, the
             device params equal to the host masters bit for bit after
             each copy-back; the host's cores, OpenMP threads and RAM
             logged); (b) all 32 layers (7.24 B parameters) with
             nothing_saveable remat, 2 steps: host RAM or NVMe moments and
             the ratio chosen from MemAvailable and the card's 80 GB, the
             losses finite and falling, peak device memory, host RSS, each
             step split into forward + backward, grads to host, host AdamW
             and masters back (seconds and GB/s), 64 forward, 32 dq and 32
             dkv launches a step; (c) Twin-Flow at ratio 0.5 with the
             moments on NVMe, 2 layers, 2 steps: the kept leaves, the
             moment files' bytes, step seconds, losses within 2e-4 of
             (a)'s on-device engine; (d) ZeRO-Infinity, 2 layers in 2
             groups of 1, the store in host RAM (2 steps, the loss
             falling) and then in files (1 step): the first streamed loss
             against the whole-model CausalLM.loss of the gathered params
             (1e-4 relative), the bytes read a step equal to the expected,
             the peak device memory against two groups + edges +
             boundaries, step seconds, 4 forward, 2 dq and 2 dkv launches
             a step. This phase runs right after the timing phase, in a
             child process of this script (``--offload-result``), which
             hands the host memory back when it exits.
14. moe    — MoE at MISTRAL_7B widths with 8 experts (Mixtral-8x7B's
             count and top-2 routing, capacity factor 1.25): (a) v2 serving
             at SERVE_LAYERS layers, bf16, 23.7 GB of weights, the main
             prompts x 32 greedy tokens through the scheduler: stream
             lengths, finite logits, SERVE_LAYERS paged launches a put,
             every block back, one prefill and one decode step held
             against the plain versions with the routing of the fp32
             attention's run replayed in the others (``moe_tape``); a
             prefill and a decode put timed whole beside one layer's gate,
             dispatch einsum, expert products and combine einsum; (b) the
             same tree with int8 weights (the attention and lm_head; the
             expert stacks stay bf16: 5 quantize launches at the build,
             4 SERVE_LAYERS + 1 quantized matmuls a put) and int8 KV, and
             its steps; (c) dropless top-1 on the same tree, its group
             sizes and the seconds of their host reads; (d) small fp32
             top-1 and top-2 engines at capacities where no token can
             drop, and dropless, give the CPU's greedy streams, and v1
             int8 MoE ``generate`` the CPU's; (e)
             training at 1 layer (1.7 B parameters), top-1 and top-2, 3
             steps each, the flash kernels' launches asserted, finite
             losses and aux loss, and top-2's micro step held against the
             plain attention with the routing replayed.
15. distributed — the distributed spine at MISTRAL_7B widths, 2 layers,
             bf16, the train phase's AdamW, schedule and clipping, two
             4096-token rows a step, 3 steps: (a) the one-process engine at
             2 micro steps a step (saving after step 2); (b) ZeRO stages
             0, 1, 2 and 3 on fsdp = 2: two ranks as child processes of
             this script (``--dist-rank``) in a gloo world on the one card
             (NCCL refuses two ranks on one GPU), each rank its own row, its
             losses within 2e-4 of (a)'s and the params after step 3 within
             three AdamW steps of (a)'s on a strided sample of every leaf
             (the sums of squares within 1e-4), stage 3 holding about half
             of (a)'s param and moment bytes; (c) stage 3 with qwZ + qgZ:
             the losses within 2e-2 of stage 3's, 62 quantize and 62
             dequantize launches a rank a step (21 gathers, 20 re-gathers
             for the backward, 21 gradient reduces; asserted); (d) the
             ranks' stage-3 save (each rank its shard files) resumed by
             the one-process engine, and (a)'s save resumed by two stage-3
             ranks: step 3's loss within 2e-4 of the unbroken run's; (e) a
             one-rank nccl world in this process: every collective once on
             the card, ZeRO++'s quantized gather through the kernels, one
             stage-3 ZeRO++ step. Every rank run asserts one flash forward,
             delta, dq and dkv launch a layer a micro step and prints its
             step seconds, peak memory, param and moment bytes held, and
             the comms logger's calls, bytes, seconds and busbw per op with
             the bytes and seconds staged through host memory. A failed
             rank fails the phase; checkpoints under build/, removed in a
             ``finally``. Then tensor parallelism over tensor = 2 in the
             same two ranks (each process draws the whole tree once from
             one seed on the host; a rank's card receives only its
             blocks): (f) v2 serving at SERVE_LAYERS layers, bf16, the
             main prompts x 32 new tokens, then int8 weights + int8 KV on
             3 of them: the two ranks' streams and captured logits
             bit-equal, the logits within TP_LOGIT_LIMIT of the
             one-process engine's (this process, the same tree) on the
             same puts, prefill puts among them, and the streams held to
             its streams by the greedy-parity rule with the one-process
             engine's own kernel/plain logit gap; SERVE_LAYERS paged
             launches a put and 7 SERVE_LAYERS + 1 quantized-matmul
             launches a put under int8, 8 quantize launches at the build
             (asserted, per rank); the bf16 run's gloo all-reduces timed by
             the comms logger; (g) v1 ``generate`` with tp_size = 2, bf16
             and int8, the same prompts, held the same way (the limit on
             one forward's logits, the margin from a one-process
             forward), L flash, 32 L paged and 33 (9 L + 2)
             dequantize launches (asserted); (h) training on tensor = 2,
             both rows a step as 2 micro steps on both ranks, against (a)
             (losses, sampled params), its save after step 2 resumed in
             one process on the ranks' curve; (i) the moe phase's training
             model over expert = 2 (4 of the 8 experts a rank), 2 steps,
             against the same engine in one process (losses within 2e-4,
             grad norms within 1e-2). Then the sequence and pipe axes in
             the same two ranks, each held to (a) (losses, sampled params;
             the limits SEQ_*, RING_*, PIPE_* set from readings on the
             card): (j) Ulysses over
             sequence = 2 (the flash kernels on a rank's 16 query and 4 KV
             heads over the whole 4096 tokens: one forward, delta, dq and
             dkv launch a layer a micro step, asserted with their shapes;
             the all-to-alls in the comms logger); (k) ring attention over
             sequence = 2 (torch ops, as the JAX ring: no flash launch,
             asserted; the K/V permutes' bytes and seconds); (l) pipe = 2,
             one layer a stage, pipeline.micro_batches = 2, ZeRO 1, both
             rows as one micro batch (a rank's flash launches: 2 a step,
             the live ticks only; half of (a)'s layer bytes held), its
             save after step 2 resumed in one process on the ranks'
             curve; and (m), in this process while the ranks run, the
             host-driven PipelineEngine: two stages of width-4096 Linear
             layers between a tied embedding and unembedding, 4
             micro-batches, 3 SGD steps, its losses held to the same
             layers trained sequentially on the card (EXEC_TOL).

16. hf_import — the HF import (models/convert.py) at full width, after
             features, the HF files written by this script (a safetensors
             file with the standard library, .bin shards with torch.save)
             from a seeded port tree through its own inverse of the
             loader's names, each config.json from the published values:
             (a) Mistral-7B at HF_LAYERS layers, two bf16 safetensors
             shards + index (about 4 GB): every leaf bit-equal after
             load_hf_checkpoint (its time, GB/s and host RSS growth, beside
             the universal reader's), InferenceEngineV2(checkpoint_path=)
             with the model inferred from config.json streaming byte for
             byte as the in-memory tree's engine, v1 int8 from
             config.checkpoint with no model generating as v1 from the
             in-memory tree, and the same tree at HF_BIN_LAYERS layers as
             two pytorch_model shards, every leaf held; (b) Falcon-7B at
             HF_FALCON_LAYERS layers, the fused MQA query_key_value from
             this script's inverse of FusedQKVSrc: config_from_hf is the
             FALCON_7B preset but for depth, every leaf bit-equal, and the
             v2 engine (G = 71: every put on paged_prefill_tc_kernel) held
             to its plain paged attention by compare_steps and the
             greedy-parity rule, its put times printed; (c) BERT-base (12
             layers) as BertForMaskedLM and as BertForSequenceClassification
             with 3 labels: v1 encode, mlm and classify, fp32 and bf16, on
             the card against the same engine on the CPU. Every file under
             build/, removed in a ``finally``.

Depth and step cuts of PR 18, which made room for phase 14 (seconds on
one H100, 700 W, before: PR 17's two whole runs; after: this PR's, in
PERF.md section 6, PR 18): the features phase at 2 layers
(``FEATURE_LAYERS``, 8 before: 80.7-108.6 s; serving and fabric stay at
``SERVE_LAYERS`` = 8: the serving chaos cell's memory bound is one KV
pool, less than its replicas' fixed 64 MiB below 8 layers, and fabric at
2 layers took 64.3 s, as long as at 8); v1 at 8 layers (``V1_LAYERS``, 32 before: 23.0-32.1 s); the
offload headline (b) at 2 steps (3 before: 71.6-73.9 s), Twin-Flow (c) at
2 (3: 13.8-14.9 s), ZeRO-Infinity (d) at 2 layers in 2 groups of 1 (8 in
4 groups of 2: 46.6-48.5 s in host RAM, 45.7-53.2 in files; the engine's
default group is ceil(L / 4) layers); train_state (c)'s urgent save at 2
layers (8: 46.8-59.7 s).

The last lines are one ``{"kernels": [...]}`` JSON object, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.

``--profile`` adds a torch.profiler trace of two puts of the bf16 and of the
int8 main path, of a verify put and a prefix-hit put, and of one training
step (the breakdowns in PERF.md section 5). ``--quick`` stops after the kernel phase; ``--only PHASE`` runs one
later phase after it (a short call after an edit; no result lines;
``--only kv_tier`` runs the KV tier cell on its own MISTRAL_7B engine;
``--only serving`` runs the serving phase, ``--only fabric`` the fabric
phase, ``--only train_state`` the training-state phase, ``--only offload``
the offload phase, ``--only moe`` the MoE phase, ``--only distributed`` the
distributed phase, ``--only hf_import`` the HF import phase).
``--compare`` times the kernels at the main path's shapes through their
entry points alone: a copy of this script in an unpacked parent commit
times the parent's kernels on the same inputs (no result lines).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
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
# atol + rtol * |ref| on every row. bf16: both write a bf16 output (one
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
    # rows past n_tokens further than the window past the context attend
    # nothing (the gathered mean), on each route
    ("prefill C=64 G=4 D=128 rows past the window", [10, 300], 64, 32, 8,
     128, 16, torch.bfloat16, 1, False, 8),
    ("decode C=4 G=4 rows past the window", [2, 3, 500], 4, 32, 8, 128, 16,
     torch.bfloat16, 1, False, 1),
    ("fp32 C=12 G=2 alibi rows past the window", [3, 40], 12, 8, 4, 64, 8,
     torch.float32, 1, True, 2),
    # Falcon-7B (the HF import's): 71 query heads over one KV head at
    # D = 64, so a decode group is 71 rows (more than one 64-row block of
    # the tensor-core prefill kernel) and a 256-token chunk 18176
    ("decode G=71 D=64 (Falcon-7B MQA)", [1, 17, 300, 2000], 1, 71, 1, 64,
     16, torch.bfloat16, 1, False, 0),
    ("mixed put C=256 G=71 D=64 (Falcon-7B MQA)", MIXED_CTX, 256, 71, 1, 64,
     16, torch.bfloat16, 0, False, 0, MIXED_CHUNKS),
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
    # every row, those past n_tokens (a MoE put routes them) and those of
    # padded sequences included
    for i in range(q.shape[0]):
        o, r = out[i].float(), ref[i].float()
        d = (o - r).abs()
        err = max(err, d.max().item())
        bad = d > atol + rtol * r.abs()
        if bad.any():
            raise AssertionError(
                f"[kernel] {name}: sequence {i} ({int(nt[i])} tokens) max "
                f"|diff| {d.max().item():.3g} over atol {atol} + rtol "
                f"{rtol}·|ref|")
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
    """Per row (n, ci), those past n_tokens included, the number of KV
    positions it attends; per sequence the union of its rows' spans (the
    K/V the function must read)."""
    rows, seqs = [], []
    for s, n in zip(start, ntok):
        ctx = s + n
        if ctx == 0:
            continue
        lo_seq = None
        for ci in range(C):
            qp = s + ci
            lo = max(0, qp - window + 1) if window else 0
            hi = min(qp + 1, ctx)
            if hi <= lo:
                continue
            rows.append(hi - lo)
            lo_seq = lo if lo_seq is None else min(lo_seq, lo)
        if lo_seq is not None:
            seqs.append(ctx - lo_seq)
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
                chunks=None, shared=0, H=32, KH=8, D=128):
    q, kp, vp, tbl, sp, nt = make_case(seed, ctxs, C, H, KH, D, 16,
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
    # Falcon-7B (G = 71, D = 64, no window): every put on the tensor-core
    # prefill kernel
    falcon = dict(H=71, KH=1, D=64)
    rows["paged_attention falcon decode"] = timing_case(
        "Falcon-7B decode N=8 G=71 D=64, the main path's 8 contexts",
        main_ctx, 1, 0, flush, **falcon)
    rows["paged_attention falcon prefill"] = timing_case(
        "Falcon-7B prefill chunk C=256 G=71 D=64 at positions 3840-4095",
        [4096], 256, 0, flush, **falcon)
    timing_case("Falcon-7B mixed put C=256 G=71 D=64", MIXED_CTX, 256, 0,
                flush, chunks=MIXED_CHUNKS, **falcon)
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


def compare_steps(get_logits, label, steps=("prefill", "decode"),
                  slack_ulps=0):
    """One prefill and one decode step (or ``steps``) through the kernels
    against the plain versions; ``get_logits(step, mode)`` gives the logits
    of ``step`` in ``mode`` ("kernel", "plain" or "plain_fp32").
    The runs differ only in rounding, which 32 layers amplify; the check is
    that the kernels' logits are no further from the fp32-arithmetic
    attention's than the plain bf16 version's are (the plain version rounds
    p — and dequantized K/V — to bf16 before the products; the kernel keeps
    them in fp32). ``slack_ulps``: how many bf16 units in the last place of
    the largest logit the kernels' distance may exceed the plain one's by
    (the MoE cells: at 8 layers the kernel's advantage is of the order of
    one rounding of the bf16 logits themselves)."""
    res = {}
    for step in steps:
        # the yardstick first: a MoE engine records its routing in that run
        # and replays it in the other two (``moe_tape``)
        out = {m: get_logits(step, m)
               for m in ("plain_fp32", "kernel", "plain")}
        k, p, p32 = out["kernel"], out["plain"], out["plain_fp32"]
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
        ulp = 2.0 ** (math.floor(math.log2(p32.abs().max().item())) - 7)
        if d_k32 > d_p32 + slack_ulps * ulp:
            raise AssertionError(
                f"[{label}] {step}: the kernels' logits are further from "
                f"fp32 attention ({d_k32:.4g}) than the plain version's "
                f"({d_p32:.4g}) + {slack_ulps} ulp of {ulp:.4g}")
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
            "decode_tps": dec_tps, "peak_gb": peak, "streams": streams}


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

# The serving paths after main, quant and v1 (features with its KV tier
# cell, serving and fabric) run MISTRAL_7B at full width and SERVE_LAYERS
# of its 32 layers: at all 32 the whole smoke came within 10% of its time
# limit; the features phase at FEATURE_LAYERS. Every count they check
# follows the depth (one paged launch a layer and put; 7 quantized matmuls
# a layer and lm_head's a put). Serving and fabric stay at 8: the serving
# chaos cell wants the memory back within one KV pool, and its replica
# threads' fixed 64 MiB of library workspace is more than a pool below 8
# layers; the fabric phase's time is its server processes', not depth's.
SERVE_LAYERS = 8
FEATURE_LAYERS = 2          # SERVE_LAYERS until PR 18


def serve_cfg(layers=None):
    """MISTRAL_7B at full width, ``layers`` (default SERVE_LAYERS) layers."""
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    return dataclasses.replace(MISTRAL_7B, num_layers=layers or SERVE_LAYERS)


# The serving features at MISTRAL_7B width, on one bf16 engine built once
# (SERVE_LAYERS layers, blocks of 16, chunks of 256). The features are switched
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
    (15 at FEATURE_LAYERS) with quantized weights (else 0), and that every
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
    # 7 projections a layer and lm_head (15 at FEATURE_LAYERS); a draft
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


def parity_rule(off, on, gap, label, phase="features"):
    """Greedy parity between feature off and on at full width: bf16 batches
    of different composition may round differently, so each request's
    streams must be equal, or at their first differing position the
    feature-off run's top-2 logit margin must be no larger than ``gap``,
    the largest |kernel - plain| logit difference ``compare_steps``
    measured on this engine (the distributed phase: the largest
    |tensor-parallel - one process| difference on the same puts)."""
    diverged = []
    for i, (a, b) in enumerate(zip(off["streams"], on["streams"])):
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        m = off["margins"][i].get(j)
        if m is None or m > gap:
            raise AssertionError(
                f"[{phase}] {label}: request {i} diverges at token {j} "
                f"with a feature-off top-2 margin of {m} > the kernel/plain "
                f"logit gap {gap:.4g}")
        diverged.append((i, j, round(m, 4)))
    log(f"[{phase}] {label}: greedy parity: "
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


# The KV tier cell: 6 system prompts of 1024 tokens (64 blocks of 16, 32 MiB
# of bf16 KV each at 8 layers), each followed by a 32-token random tail, 8 new tokens a
# request; two passes of 12 requests (each prompt twice), one at a time. The
# pool holds about half the prefixes' 384 blocks, so prefixes are evicted
# between repeats: tier off re-prefills them, tier on restores them from host
# RAM (two prefixes' blocks: 64 MiB of bf16 KV, half that of int8) or disk.
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
    of two prefixes' blocks, disk 1 GiB in a temporary directory), the same
    two passes.
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
    (FEATURE_LAYERS layers, bf16 weights from a seed), bf16 then int8 weights
    + int8 KV."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models.transformer import CausalLM

    model = CausalLM(serve_cfg(FEATURE_LAYERS))
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
    then MISTRAL_7B at full width (FEATURE_LAYERS layers, bf16): the prefix
    cache, n-gram
    speculative decoding at K = 3 and 4, reservation admission with
    preemption, KV export/import (bf16, int8 and fp8 pools), preemption
    again with int8 KV, speculative decoding again with int8 weights and
    int8 KV; then the universal checkpoint at full width with 2 layers."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    small_feature_parity()
    cfg = serve_cfg(FEATURE_LAYERS)
    log(f"[features] MISTRAL_7B at full width, {cfg.num_layers} of "
        f"{MISTRAL_7B.num_layers} layers, bf16, random weights from a seed")
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


# ----------------------------------------------------------- HF import

# The HF import (models/convert.py) at full width. The card's machine may
# lack the safetensors and transformers packages, so this script writes the
# HF files itself (a safetensors file is an 8-byte length, a JSON header
# and the raw bytes; .bin shards go through torch.save) from a port param
# tree drawn from a seeded generator, through its own inverse of the
# loader's name mapping, and each config.json from the published values
# below (never downloaded).
HF_SEED = 31
HF_LAYERS = SERVE_LAYERS        # Mistral-7B's depth here (32 published)
HF_BIN_LAYERS = 2               # the pytorch_model*.bin copy
HF_FALCON_LAYERS = 2
HF_NEW_TOKENS = 16
HF_PROMPT_LENS = (17, 129, 333, 700)
HF_KV_BLOCKS = 512
# mistralai/Mistral-7B-v0.1 config.json
HF_MISTRAL = {
    "architectures": ["MistralForCausalLM"], "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 4096,
    "initializer_range": 0.02, "intermediate_size": 14336,
    "max_position_embeddings": 32768, "model_type": "mistral",
    "num_attention_heads": 32, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "sliding_window": 4096, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32000}
# tiiuae/falcon-7b config.json
HF_FALCON = {
    "alibi": False, "apply_residual_connection_post_layernorm": False,
    "architectures": ["FalconForCausalLM"], "attention_dropout": 0.0,
    "bias": False, "bos_token_id": 11, "eos_token_id": 11,
    "hidden_dropout": 0.0, "hidden_size": 4544, "initializer_range": 0.02,
    "layer_norm_epsilon": 1e-05, "model_type": "falcon",
    "multi_query": True, "new_decoder_architecture": False,
    "num_attention_heads": 71, "num_hidden_layers": 32,
    "parallel_attn": True, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 65024}
# bert-base-uncased config.json
HF_BERT = {
    "architectures": ["BertForMaskedLM"], "attention_probs_dropout_prob": 0.1,
    "hidden_act": "gelu", "hidden_dropout_prob": 0.1, "hidden_size": 768,
    "initializer_range": 0.02, "intermediate_size": 3072,
    "layer_norm_eps": 1e-12, "max_position_embeddings": 512,
    "model_type": "bert", "num_attention_heads": 12, "num_hidden_layers": 12,
    "pad_token_id": 0, "position_embedding_type": "absolute",
    "type_vocab_size": 2, "use_cache": True, "vocab_size": 30522}
# the encoder's card-vs-CPU tolerance, |card - cpu| <= atol + rtol * |cpu|
# elementwise: fp32 differs only in summation order (cuBLAS against the
# CPU's GEMM, no TF32) over 12 layers; bf16 rounds every product input and
# every layer's output to 8 bits of mantissa on both sides, in a different
# order, so two results may sit a few bf16 ulps (2^-8 relative) apart after
# 12 post-LN layers: 1/16 of the largest value bounds that with room.
HF_ENC_FP32_TOL = (1e-3, 1e-3)
HF_ENC_BF16_SHARE = 1.0 / 16

_ST_NAMES = {torch.float64: "F64", torch.float32: "F32",
             torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
             torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL",
             torch.float8_e4m3fn: "F8_E4M3", torch.float8_e5m2: "F8_E5M2"}


def st_write(path, tensors):
    """``tensors`` (name -> tensor, on any device) as one safetensors file,
    written with the standard library: the 8-byte little-endian header
    length, the JSON header (padded with spaces to 8 bytes) and each
    tensor's raw bytes in order. Returns the bytes written."""
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(len(raw).to_bytes(8, "little"))
        fh.write(raw)
        for t in tensors.values():
            a = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
            fh.write(memoryview(a.numpy()))
    return 8 + len(raw) + off


def hf_write(root, config, tensors, fmt="st", shards=1):
    """An HF checkpoint directory: ``config.json`` and the tensors (a dict
    in file order of names to functions making each tensor on the card) in
    ``shards`` files of about equal bytes, with their index when ``shards``
    > 1 (``model-0000i-of-0000n.safetensors`` + ``model.safetensors.index
    .json``, or ``pytorch_model-...bin`` + ``pytorch_model.bin.index
    .json``). Returns the tensor bytes written."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "config.json"), "w") as fh:
        json.dump(config, fh, indent=2)
    sizes = {}
    for name, make in tensors.items():
        t = make()
        sizes[name] = t.numel() * t.element_size()
        del t
    total = sum(sizes.values())
    per = -(-total // shards)
    groups, acc = [[]], 0
    for name in tensors:
        if acc >= per * len(groups) and len(groups) < shards:
            groups.append([])
        groups[-1].append(name)
        acc += sizes[name]
    ext = "safetensors" if fmt == "st" else "bin"
    stem = "model" if fmt == "st" else "pytorch_model"
    wmap = {}
    for i, names in enumerate(groups):
        fname = (f"{stem}.{ext}" if shards == 1
                 else f"{stem}-{i + 1:05d}-of-{shards:05d}.{ext}")
        if fmt == "st":
            st_write(os.path.join(root, fname),
                     {n: tensors[n]() for n in names})
        else:       # each a tensor of its own storage on the host
            torch.save({n: tensors[n]().cpu() for n in names},
                       os.path.join(root, fname))
        wmap.update({n: fname for n in names})
    if shards > 1:
        with open(os.path.join(root, f"{stem}.{ext}.index.json"), "w") as fh:
            json.dump({"metadata": {"total_size": total},
                       "weight_map": wmap}, fh)
    return total


def _lin(t):
    """A port [in, out] weight as the [out, in] ``nn.Linear`` stores it."""
    return t.t().contiguous()


def mistral_hf_tensors(params, layers):
    """The Llama/Mistral HF names of a port tree's first ``layers`` layers,
    written from the port layout by hand (not through the loader)."""
    lp, out = params["layers"], {}
    out["model.embed_tokens.weight"] = lambda: params["embed"]["wte"]
    for i in range(layers):
        pre = f"model.layers.{i}."
        for hf_name, leaf, lin in (
                ("input_layernorm.weight", "attn_norm_w", False),
                ("self_attn.q_proj.weight", "wq", True),
                ("self_attn.k_proj.weight", "wk", True),
                ("self_attn.v_proj.weight", "wv", True),
                ("self_attn.o_proj.weight", "wo", True),
                ("post_attention_layernorm.weight", "mlp_norm_w", False),
                ("mlp.gate_proj.weight", "w_gate", True),
                ("mlp.up_proj.weight", "w_in", True),
                ("mlp.down_proj.weight", "w_out", True)):
            out[pre + hf_name] = (
                lambda t=lp[leaf][i], lin=lin: _lin(t) if lin else t)
    out["model.norm.weight"] = lambda: params["final_norm"]["w"]
    out["lm_head.weight"] = lambda: _lin(params["lm_head"]["w"])
    return out


def fuse_qkv(wq, wk, wv, groups, q_per_group, hd):
    """The inverse of the loader's ``FusedQKVSrc``: port [in, out] q, k, v
    weights as one fused [rows, in] tensor packed per KV group as
    [groups, q_per_group + 2, hd] in dim 0 (Falcon-7B: one group of 71 q
    heads, then the K head, then the V head)."""
    h = wq.shape[0]
    q = wq.t().reshape(groups, q_per_group, hd, h)
    k = wk.t().reshape(groups, 1, hd, h)
    v = wv.t().reshape(groups, 1, hd, h)
    return torch.cat([q, k, v], dim=1).reshape(-1, h).contiguous()


def falcon_hf_tensors(params, cfg):
    lp, out = params["layers"], {}
    out["transformer.word_embeddings.weight"] = (
        lambda: params["embed"]["wte"])
    for i in range(cfg.num_layers):
        pre = f"transformer.h.{i}."
        out[pre + "input_layernorm.weight"] = (
            lambda i=i: lp["attn_norm_w"][i])
        out[pre + "input_layernorm.bias"] = (
            lambda i=i: lp["attn_norm_b"][i])
        out[pre + "self_attention.query_key_value.weight"] = (
            lambda i=i: fuse_qkv(lp["wq"][i], lp["wk"][i], lp["wv"][i],
                                 cfg.kv_heads, cfg.num_heads // cfg.kv_heads,
                                 cfg.head_dim))
        for hf_name, leaf in (("self_attention.dense.weight", "wo"),
                              ("mlp.dense_h_to_4h.weight", "w_in"),
                              ("mlp.dense_4h_to_h.weight", "w_out")):
            out[pre + hf_name] = lambda t=lp[leaf][i]: _lin(t)
    out["transformer.ln_f.weight"] = lambda: params["final_norm"]["w"]
    out["transformer.ln_f.bias"] = lambda: params["final_norm"]["b"]
    return out


def bert_hf_tensors(params, cfg, arch):
    """BertForMaskedLM / BertForSequenceClassification names."""
    lp, e, out = params["layers"], params["embed"], {}
    for hf_name, t in (("word_embeddings.weight", e["wte"]),
                       ("position_embeddings.weight", e["wpe"]),
                       ("token_type_embeddings.weight", e["tte"]),
                       ("LayerNorm.weight", e["ln_w"]),
                       ("LayerNorm.bias", e["ln_b"])):
        out["bert.embeddings." + hf_name] = lambda t=t: t
    names = {"wq": "attention.self.query", "wk": "attention.self.key",
             "wv": "attention.self.value", "wo": "attention.output.dense",
             "w_in": "intermediate.dense", "w_out": "output.dense"}
    for i in range(cfg.num_layers):
        pre = f"bert.encoder.layer.{i}."
        for leaf, hf_name in names.items():
            out[pre + hf_name + ".weight"] = (
                lambda t=lp[leaf][i]: _lin(t))
            out[pre + hf_name + ".bias"] = (
                lambda t=lp[leaf + "_b"][i]: t)
        for leaf, hf_name in (("attn_ln", "attention.output.LayerNorm"),
                              ("mlp_ln", "output.LayerNorm")):
            out[pre + hf_name + ".weight"] = (
                lambda t=lp[leaf + "_w"][i]: t)
            out[pre + hf_name + ".bias"] = (
                lambda t=lp[leaf + "_b"][i]: t)
    if arch == "BertForMaskedLM":
        m, c = params["mlm"], "cls.predictions."
        out[c + "transform.dense.weight"] = lambda: _lin(m["w"])
        out[c + "transform.dense.bias"] = lambda: m["b"]
        out[c + "transform.LayerNorm.weight"] = lambda: m["ln_w"]
        out[c + "transform.LayerNorm.bias"] = lambda: m["ln_b"]
        out[c + "bias"] = lambda: m["bias"]
    else:
        p, c = params["pooler"], params["classifier"]
        out["bert.pooler.dense.weight"] = lambda: _lin(p["w"])
        out["bert.pooler.dense.bias"] = lambda: p["b"]
        out["classifier.weight"] = lambda: _lin(c["w"])
        out["classifier.bias"] = lambda: c["b"]
    return out


def jitter_norms_and_biases(params, gen):
    """Norm weights around 1 and biases around 0 (the inits' 1 and 0 would
    hide a norm or bias read from the wrong tensor)."""
    for key, t in flat_leaves(params).items():
        if key.endswith(("norm_w", "ln_w")) or key == "final_norm.w":
            t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=gen,
                                            device=t.device))
        elif key.endswith("_b") or key.rsplit(".", 1)[-1] in ("b", "bias"):
            t.copy_(0.02 * torch.randn(t.shape, generator=gen,
                                       device=t.device))


def tree_equal(got, want, label):
    g, w = flat_leaves(got), flat_leaves(want)
    if set(g) != set(w):
        raise AssertionError(f"[hf_import] {label}: leaves {sorted(g)} vs "
                             f"{sorted(w)}")
    for k in w:
        if g[k].dtype != w[k].dtype or not torch.equal(g[k].to(w[k].device),
                                                       w[k]):
            raise AssertionError(f"[hf_import] {label}: leaf {k} differs")
    return len(w)


def hf_timed_load(path, model, label):
    """``load_hf_checkpoint`` onto the card, timed, with the bytes its
    reader pulled off disk and the host RSS growth while it ran."""
    from deepspeed_tpu_torch.models.convert import (load_hf_checkpoint,
                                                    open_checkpoint)

    reader = open_checkpoint(path)

    def load():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = load_hf_checkpoint(path, model=model, device="cuda",
                                 reader=reader)[1]
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (params, secs), rss = peak_rss_during(load)
    reader.close()
    gb = reader.bytes_read / 1e9
    log(f"[hf_import] {label}: {gb:.3f} GB read ({type(reader).__name__}) "
        f"onto the card in {secs:.2f} s = {gb / secs:.2f} GB/s (warm page "
        f"cache: the files were just written); host RSS growth during the "
        f"load {rss / 1e9:.3f} GB")
    return params, {"gb": gb, "load_s": secs, "gb_per_s": gb / secs,
                    "rss_gb": rss / 1e9}


def hf_file_rate(path):
    """GB/s of reading every file under ``path`` into one reused host
    buffer, nothing else done with the bytes: the host's read rate for
    these files as they sit in the page cache at the time."""
    view = memoryview(torch.empty(256 << 20, dtype=torch.uint8).numpy())
    total, t = 0, time.perf_counter()
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb", buffering=0) as fh:
            while True:
                k = fh.readinto(view)
                if not k:
                    break
                total += k
    return total / 1e9 / (time.perf_counter() - t)


def hf_mistral(root, universal):
    """(a) Mistral-7B at full width, HF_LAYERS layers: two bf16 safetensors
    shards with their index, loaded leaf for leaf through
    ``load_hf_checkpoint`` and served by ``InferenceEngineV2(checkpoint_path
    =...)`` with the in-memory tree's streams; v1 with int8 weights and the
    model inferred from config.json against v1 from the in-memory tree; the
    same tree at HF_BIN_LAYERS layers as two ``pytorch_model`` shards."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.testing import greedy_generate
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.convert import config_from_hf

    res = {}
    hf_cfg = dict(HF_MISTRAL, num_hidden_layers=HF_LAYERS)
    cfg = config_from_hf(hf_cfg)
    # the preset's context is 8192 and it leaves o_bias and mlp_bias None
    # (use_bias's False); config.json says 32768 and the mapping says False
    want = dataclasses.replace(serve_cfg(HF_LAYERS), max_seq_len=32768,
                               o_bias=False, mlp_bias=False)
    if cfg != want:
        raise AssertionError(f"[hf_import] config_from_hf(Mistral-7B) "
                             f"{cfg} != {want}")
    model = CausalLM(cfg)
    gen = torch.Generator("cuda").manual_seed(HF_SEED)
    params = model.init(gen, device="cuda", dtype=torch.bfloat16)
    jitter_norms_and_biases(params, gen)
    st_dir = os.path.join(root, "mistral")
    t = time.perf_counter()
    nbytes = hf_write(st_dir, hf_cfg, mistral_hf_tensors(params, HF_LAYERS),
                      shards=2)
    res["write_s"] = time.perf_counter() - t
    log(f"[hf_import] (a) Mistral-7B, {HF_LAYERS} layers: {nbytes / 1e9:.3f}"
        f" GB of bf16 written as 2 safetensors shards + index in "
        f"{res['write_s']:.2f} s")
    res["file_gb_per_s"] = hf_file_rate(st_dir)
    loaded, res["load"] = hf_timed_load(st_dir, model, "(a) safetensors")
    n = tree_equal(loaded, params, "(a) safetensors")
    del loaded
    res["file_again_gb_per_s"] = hf_file_rate(st_dir)
    loaded, res["load_again"] = hf_timed_load(st_dir, model,
                                              "(a) safetensors, read again")
    del loaded
    log(f"[hf_import] (a) {n} leaves bit-equal to the drawn tree; the "
        f"files' plain read rate before the loads "
        f"{res['file_gb_per_s']:.2f} GB/s, between them "
        f"{res['file_again_gb_per_s']:.2f} GB/s")
    uni = universal or {}
    if uni:
        log(f"[hf_import] (a) HF reader {res['load']['gb_per_s']:.2f} GB/s "
            f"beside the universal reader's {uni['gb'] / uni['load_s']:.2f} "
            f"GB/s (features checkpoint, this run)")

    rng = np.random.default_rng(HF_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in HF_PROMPT_LENS]
    ecfg = dict(kv_block_size=16, max_chunk_tokens=256,
                max_ragged_sequence_count=8, kv_blocks=HF_KV_BLOCKS)
    t = time.perf_counter()
    engine = InferenceEngineV2(checkpoint_path=st_dir, device="cuda",
                               config=RaggedInferenceEngineConfig(**ecfg))
    torch.cuda.synchronize()
    res["v2_build_s"] = time.perf_counter() - t
    if engine.model.cfg != cfg:
        raise AssertionError("[hf_import] (a) the v2 engine's inferred model")
    tree_equal(engine.params, params, "(a) v2 engine params")
    engine.put([10_000], [prompts[0][:16]])       # warm-up
    engine.flush(10_000)
    served = serve(engine, cfg, prompts, HF_NEW_TOKENS, "hf_import (a) v2")
    if served["launches"]["paged_attention"] != HF_LAYERS * served["puts"]:
        raise AssertionError(f"[hf_import] (a) {served['launches']} for "
                             f"{served['puts']} puts")
    res["v2"] = served
    del engine
    gc.collect()
    ref = greedy_generate(InferenceEngineV2(
        model, params, RaggedInferenceEngineConfig(**ecfg), device="cuda"),
        prompts, max_new_tokens=HF_NEW_TOKENS, sequential=False)
    if served["streams"] != ref:
        raise AssertionError("[hf_import] (a) v2 streams from the HF "
                             "checkpoint differ from the in-memory tree's")
    log(f"[hf_import] (a) v2 from checkpoint_path (built in "
        f"{res['v2_build_s']:.2f} s): {len(prompts)} streams byte-identical "
        f"to the in-memory engine's; {served['puts']} puts, "
        f"{json.dumps(served['launches'])}")
    gc.collect()
    torch.cuda.empty_cache()

    # v1, int8 weights, the model inferred from config.json
    quant = {"enabled": True, "bits": 8}
    reset_launches()
    t = time.perf_counter()
    te = init_inference(None, config={"checkpoint": st_dir, "dtype": "bf16",
                                      "quant": quant}, device="cuda")
    torch.cuda.synchronize()
    res["v1_build_s"] = time.perf_counter() - t
    build = v1_launches()
    if build["quantize"] != V1_QUANT_LEAVES:
        raise AssertionError(f"[hf_import] (a) v1 build launches {build}")
    reset_launches()
    out = te.generate(prompts, max_new_tokens=HF_NEW_TOKENS)
    torch.cuda.synchronize()
    gen_launches = v1_launches()
    del te
    gc.collect()
    ref_out = init_inference(model, config={"dtype": "bf16", "quant": quant},
                             params=params, device="cuda").generate(
        prompts, max_new_tokens=HF_NEW_TOKENS)
    if not torch.equal(out, ref_out):
        raise AssertionError("[hf_import] (a) v1 int8 generate from the HF "
                             "checkpoint differs from the in-memory tree's")
    for k in ("dequantize", "flash_fwd", "paged_attention"):
        if gen_launches[k] < 1:
            raise AssertionError(f"[hf_import] (a) v1 int8 launches "
                                 f"{gen_launches}")
    res["v1"] = {"build_launches": build, "launches": gen_launches}
    log(f"[hf_import] (a) v1 int8 from config.checkpoint with no model "
        f"(built in {res['v1_build_s']:.2f} s, {build['quantize']} quantize "
        f"launches): generate equal to the in-memory tree's; launches "
        f"{json.dumps(gen_launches)}")
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(st_dir, ignore_errors=True)

    # the same tree's first layers as pytorch_model*.bin shards
    bin_cfg = dataclasses.replace(cfg, num_layers=HF_BIN_LAYERS)
    bin_dir = os.path.join(root, "mistral_bin")
    t = time.perf_counter()
    hf_write(bin_dir, dict(hf_cfg, num_hidden_layers=HF_BIN_LAYERS),
             mistral_hf_tensors(params, HF_BIN_LAYERS), fmt="bin", shards=2)
    res["bin_write_s"] = time.perf_counter() - t
    loaded, res["bin_load"] = hf_timed_load(bin_dir, CausalLM(bin_cfg),
                                            "(a) pytorch_model.bin")
    want_tree = {g: ({k: v[:HF_BIN_LAYERS] for k, v in sub.items()}
                     if g == "layers" else sub) for g, sub in params.items()}
    n = tree_equal(loaded, want_tree, "(a) pytorch_model.bin")
    log(f"[hf_import] (a) .bin shards: {n} leaves bit-equal")
    del loaded, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def hf_serve(engine, prompts, mode, label):
    """Greedy streams of ``prompts`` through a margin-recording scheduler
    with the kernels or the plain versions pinned (``pinned``); each put
    timed and its paged launches' routes recorded. In "kernel" mode the
    paged kernel must be launched once a layer and put."""
    sched = margin_scheduler(engine)
    log_ = PutLog()
    log_.attach(engine)
    routes, real_cuda = set(), pa.paged_attention_cuda

    def routed(q, k_pool, *a, **kw):
        routes.add(pa.PAGED_ROUTES[pa.paged_route(
            q.shape[1], q.shape[2], k_pool.shape[1], q.shape[3], q.dtype)])
        return real_cuda(q, k_pool, *a, **kw)

    pa.paged_attention_cuda = routed
    reset_launches()
    base = 70_000
    try:
        with pinned(mode):
            for i, p in enumerate(prompts):
                sched.submit(base + i, p, max_new_tokens=HF_NEW_TOKENS)
            sched.run_to_completion()
            torch.cuda.synchronize()
    finally:
        pa.paged_attention_cuda = real_cuda
        log_.close()
    L = engine.model.cfg.num_layers
    launches = pa.launches
    if mode == "kernel" and launches != L * len(log_.puts):
        raise AssertionError(f"[hf_import] {label}: {launches} paged "
                             f"launches for {len(log_.puts)} puts")
    uids = [base + i for i in range(len(prompts))]
    pre = [s for _, is_pre, s in log_.puts if is_pre]
    dec = [s for _, is_pre, s in log_.puts if not is_pre]
    return {"streams": [sched.finished[u].generated for u in uids],
            "margins": [sched.margins.get(u, {}) for u in uids],
            "routes": routes, "launches": launches, "puts": len(log_.puts),
            "prefill_put_ms": float(np.median(pre)) * 1e3,
            "decode_put_ms": float(np.median(dec)) * 1e3}


def hf_falcon(root):
    """(b) Falcon-7B at full width, HF_FALCON_LAYERS layers: the fused MQA
    query_key_value written by this script's inverse of the loader's
    FusedQKVSrc, one bf16 safetensors file; config_from_hf equal to the
    FALCON_7B preset but for depth; the v2 engine from checkpoint_path
    (G = 71 query heads over one KV head at D = 64: every put on
    paged_prefill_tc_kernel) held to the same engine with the plain paged
    attention pinned by the greedy-parity rule."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import FALCON_7B, CausalLM
    from deepspeed_tpu_torch.models.convert import config_from_hf

    res = {}
    hf_cfg = dict(HF_FALCON, num_hidden_layers=HF_FALCON_LAYERS)
    cfg = config_from_hf(hf_cfg)
    if dataclasses.replace(cfg, num_layers=FALCON_7B.num_layers) != FALCON_7B:
        raise AssertionError(f"[hf_import] config_from_hf(Falcon-7B) {cfg} "
                             f"is not FALCON_7B but for depth")
    model = CausalLM(cfg)
    gen = torch.Generator("cuda").manual_seed(HF_SEED + 1)
    params = model.init(gen, device="cuda", dtype=torch.bfloat16)
    jitter_norms_and_biases(params, gen)
    # one shared input_layernorm feeds both parallel branches
    params["layers"]["mlp_norm_w"].copy_(params["layers"]["attn_norm_w"])
    params["layers"]["mlp_norm_b"].copy_(params["layers"]["attn_norm_b"])
    d = os.path.join(root, "falcon")
    t = time.perf_counter()
    nbytes = hf_write(d, hf_cfg, falcon_hf_tensors(params, cfg))
    res["write_s"] = time.perf_counter() - t
    log(f"[hf_import] (b) Falcon-7B, {cfg.num_layers} layers: "
        f"{nbytes / 1e9:.3f} GB of bf16 (query_key_value "
        f"[{(cfg.num_heads + 2) * cfg.head_dim}, {cfg.hidden_size}]) in "
        f"{res['write_s']:.2f} s")
    engine = InferenceEngineV2(checkpoint_path=d, device="cuda",
                               config=RaggedInferenceEngineConfig(
                                   kv_block_size=16, max_chunk_tokens=256,
                                   max_ragged_sequence_count=8,
                                   kv_blocks=HF_KV_BLOCKS))
    n = tree_equal(engine.params, params, "(b) v2 engine params")
    del params
    gc.collect()
    log(f"[hf_import] (b) {n} leaves bit-equal to the drawn tree")
    engine.put([10_000], [list(range(16))])       # warm-up
    engine.flush(10_000)
    rng = np.random.default_rng(HF_SEED + 1)
    chunks = [rng.integers(0, cfg.vocab_size, 257).tolist(),
              rng.integers(0, cfg.vocab_size, 201).tolist()]
    steps = compare_steps(functools.partial(step_logits, engine, chunks),
                          "hf_import (b) Falcon-7B")
    gap = max(r["max_dlogit"] for r in steps.values())
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in HF_PROMPT_LENS]
    on = hf_serve(engine, prompts, "kernel", "(b) kernel")
    off = hf_serve(engine, prompts, "plain", "(b) plain")
    want = {"paged_prefill_tc_kernel"}
    if on["routes"] != want:
        raise AssertionError(f"[hf_import] (b) routes {on['routes']}, want "
                             f"{want}")
    diverged = parity_rule(off, on, gap, "(b) Falcon-7B kernel vs plain",
                           phase="hf_import")
    log(f"[hf_import] (b) Falcon-7B G = {cfg.num_heads // cfg.kv_heads}: "
        f"{on['puts']} puts, {on['launches']} paged launches on "
        f"{sorted(on['routes'])}; median prefill put "
        f"{on['prefill_put_ms']:.2f} ms (plain {off['prefill_put_ms']:.2f}),"
        f" decode put {on['decode_put_ms']:.2f} ms (plain "
        f"{off['decode_put_ms']:.2f})")
    res.update(steps=steps, gap=gap, diverged=diverged,
               launches=on["launches"], puts=on["puts"],
               prefill_put_ms=on["prefill_put_ms"],
               decode_put_ms=on["decode_put_ms"],
               plain_prefill_put_ms=off["prefill_put_ms"],
               plain_decode_put_ms=off["decode_put_ms"])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    return res


def hf_encoder_diff(a, b, dt, label):
    """max |card - cpu| of one output, held to HF_ENC_TOL."""
    a, b = a.float().cpu(), b.float()
    d = (a - b).abs().max().item()
    if dt == "fp32":
        atol, rtol = HF_ENC_FP32_TOL
        ok = bool(((a - b).abs() <= atol + rtol * b.abs()).all())
        lim = f"atol {atol} + rtol {rtol}"
    else:
        lim_v = HF_ENC_BF16_SHARE * b.abs().max().item()
        ok, lim = d <= lim_v, f"{lim_v:.4g} (1/16 of max |cpu|)"
    if not (ok and torch.isfinite(a).all()):
        raise AssertionError(f"[hf_import] (c) {label}: max |card - cpu| "
                             f"{d:.4g} over {lim}")
    return d


def hf_bert(root):
    """(c) BERT-base (bert-base-uncased's config, 12 layers) written in the
    HF layout as BertForMaskedLM and as BertForSequenceClassification with
    3 labels; v1 encode, mlm and classify with the model inferred from
    config.json, fp32 and bf16, on the card against the same engine on the
    CPU on the same inputs."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.convert import encoder_config_from_hf
    from deepspeed_tpu_torch.models.encoder import EncoderLM

    res = {}
    gen = torch.Generator("cuda").manual_seed(HF_SEED + 2)
    dirs = {}
    for arch, extra in (("BertForMaskedLM", {}),
                        ("BertForSequenceClassification",
                         {"id2label": {str(i): f"LABEL_{i}"
                                       for i in range(3)}})):
        hf_cfg = dict(HF_BERT, architectures=[arch], **extra)
        cfg = encoder_config_from_hf(hf_cfg)
        params = EncoderLM(cfg).init(gen, device="cuda")
        jitter_norms_and_biases(params, gen)
        dirs[arch] = os.path.join(root, arch)
        hf_write(dirs[arch], hf_cfg, bert_hf_tensors(params, cfg, arch))
        del params
    rng = np.random.default_rng(HF_SEED + 2)
    B, T = 4, 128
    tokens = rng.integers(0, HF_BERT["vocab_size"], (B, T))
    mask = np.ones((B, T), np.int64)
    mask[1, 100:] = 0
    mask[3, 37:] = 0
    types = (rng.integers(0, 2, (B, T)) * mask).astype(np.int64)
    for dt in ("fp32", "bf16"):
        for arch, d in dirs.items():
            outs = {}
            for dev in ("cuda", "cpu"):
                eng = init_inference(None, config={"checkpoint": d,
                                                   "dtype": dt}, device=dev)
                o = {}
                o["hidden"], o["pooled"] = eng.encode(tokens, mask, types)
                if arch == "BertForMaskedLM":
                    o["mlm"] = eng.mlm(tokens, mask, types)
                else:
                    o["classify"] = eng.classify(tokens, mask, types)
                outs[dev] = o
                del eng
            for k, v in outs["cuda"].items():
                if v is None:
                    continue
                res[f"{dt} {arch} {k}"] = hf_encoder_diff(
                    v, outs["cpu"][k], dt, f"{dt} {arch} {k}")
    log("[hf_import] (c) BERT-base, 12 layers, card vs CPU on 4 x 128 "
        "tokens (padding and token types): max |diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in res.items())
        + f"; tolerance fp32 atol {HF_ENC_FP32_TOL[0]} + rtol "
        f"{HF_ENC_FP32_TOL[1]}, bf16 1/16 of the output's max |value|")
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return res


def phase_hf_import(universal=None):
    """The HF import at full width: (a) Mistral-7B, (b) Falcon-7B, (c)
    BERT-base; every file under build/, removed in a ``finally``.
    ``universal``: the features phase's checkpoint result (its reader's
    GB/s is printed beside the HF reader's)."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="hf_", dir=os.path.join(here, "build"))
    log(f"[hf_import] free disk under build/: "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB")
    res, secs = {}, {}
    try:
        for key, fn in (("a", lambda: hf_mistral(root, universal)),
                        ("b", lambda: hf_falcon(root)),
                        ("c", lambda: hf_bert(root))):
            t = time.perf_counter()
            res[key] = fn()
            secs[key] = time.perf_counter() - t
            log(f"[hf_import] ({key}) {secs[key]:.1f} s")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["secs"] = secs
    return res


# ------------------------------------------------------------- serving

# The serving stack at MISTRAL_7B width (SERVE_LAYERS layers, bf16, blocks of 16,
# chunks of 256): ServingFrontend -> admission queue -> router -> replica
# threads, over engines that share one bf16 weight tree (each engine has
# its own KV pools and scheduler).
SERVE_KV_BLOCKS = 1024              # 512 MiB of bf16 KV an engine
SERVE_MAX_SEQS = 8                  # a replica's concurrent sequences
BURST_REQUESTS, BURST_NEW, BURST_QUEUE = 48, 32, 16
BURST_LENGTHS = 16                  # lognormal prompt lengths, cycled
CHAOS_REQUESTS, CHAOS_PROMPT, CHAOS_NEW = 16, 128, 16
CHAOS_CRASH_STEP = 4
CHAOS_KV_BLOCKS = 256               # 16 x 9 blocks and room; 128 MiB
QCFG_REQUESTS, QCFG_SYS, QCFG_TAIL, QCFG_NEW = 8, 1024, 64, 16
# a bf16 block of 16 tokens: K and V, 8 KV heads of 128, 512 KiB
KV_BLOCK_BYTES_BF16 = SERVE_LAYERS * 2 * 8 * 16 * 128 * 2


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


# The item 10b cells: disaggregated prefill/decode with the KV handoff,
# multi-tenant fair share, prefix-affinity routing with warm-up, and the
# elastic autoscaler, each over engines that share the one bf16 tree.
DISAGG_REQUESTS, DISAGG_NEW = 16, 32
DISAGG_KV_BLOCKS = 1536             # 8 x (2048 + 32) tokens at once
TENANT_PROMPT, TENANT_NEW = 256, 16
TENANT_FLOOD, TENANT_CAPPED = 24, 8          # gold and silver; capped
TENANT_RATE = 100.0                 # capped's tokens/s: 4 requests a window
AFFINITY_SYS, AFFINITY_TAIL, AFFINITY_NEW = 1024, 32, 16
AFFINITY_PREFIXES, AFFINITY_REPEATS = 6, 4
SCALE_REQUESTS, SCALE_PROMPT, SCALE_NEW = 16, 512, 64


def disagg_prompts(V):
    """16 prompt lengths spread over 64-2048 (none one past a multiple of
    the 256-token chunk, so every prompt put carries a chunk longer than
    one token), shuffled."""
    rng = np.random.default_rng(24)
    lens = [int(n) + (1 if int(n) % 256 == 1 else 0)
            for n in np.linspace(64, 2048, DISAGG_REQUESTS)]
    rng.shuffle(lens)
    return [rng.integers(0, V, n).tolist() for n in lens]


def payload_bytes(payload):
    """Host bytes of one staged handoff: every slab and scale plane (whole
    or chunked form) and ``last_logits``."""
    slabs = list((payload.get("slabs") or {}).values())
    for chunk in payload.get("chunks") or ():
        slabs += list(chunk.values())
    total = sum(t.numel() * t.element_size() if torch.is_tensor(t)
                else np.asarray(t).nbytes for t in slabs)
    return total + np.asarray(payload["last_logits"]).nbytes


def frontend_run(fe, prompts, new_tokens, label, logs, **submit_kw):
    """Submit ``prompts`` at once through ``fe`` and wait; the launch
    counts are set to 0 just before and read just after. ``logs`` maps a
    name to the PutLog of each engine (unsynchronized: the replicas share
    the card). Fails unless every request finished, none failed, no
    replica died and the paged kernel ran once per layer and put."""
    from deepspeed_tpu_torch.serving import RequestState

    deaths = watch_deaths(fe)
    for log_ in logs.values():
        log_.puts.clear()
    reset_launches()
    t0 = time.perf_counter()
    handles = [fe.submit(p, max_new_tokens=new_tokens, **submit_kw)
               for p in prompts]
    done = fe.wait_all(handles, timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.launches,
                "quantized_matmul": qz.launches["quantized_matmul"]}
    snap = fe.metrics_snapshot()
    states = [h.state for h in handles]
    if not done or any(s != RequestState.FINISHED for s in states) \
            or snap["requests_failed"] or deaths:
        raise AssertionError(f"[serving] {label}: states {states}, failed "
                             f"{snap['requests_failed']}, deaths {deaths}")
    L = fe.router.replicas[0].engine.model.cfg.num_layers
    puts = {k: len(v.puts) for k, v in logs.items()}
    if launches["paged_attention"] != L * sum(puts.values()):
        raise AssertionError(f"[serving] {label}: launches {launches} for "
                             f"puts {puts}")
    stats = frontend_stats(handles, next(iter(logs.values())), wall)
    stats["puts"] = sum(puts.values())
    return {"streams": [[ev.token for ev in h.drain()] for h in handles],
            "handles": handles, "snap": snap, "launches": launches,
            "puts": puts, "stats": stats}


def disagg_run(engines, prompts, label, quant=False,
               max_staged=DISAGG_REQUESTS, decode_seqs=None):
    """One disaggregated frontend, replica 0 prefill and replica 1 decode,
    over ``engines`` (built fresh for the int8 run, whose config quantizes
    them); ``decode_seqs`` caps the decode replica's concurrent sequences
    for this run. Returns the run with each staged payload's bytes."""
    from deepspeed_tpu_torch.serving import ServingConfig, ServingFrontend

    seqs = engines[1].config.max_ragged_sequence_count
    if decode_seqs is not None:
        engines[1].config.max_ragged_sequence_count = decode_seqs
    blocks = (dict(weight_quant={"enabled": True, "dtype": "int8",
                                 "block": 128},
                   kv_quant={"enabled": True, "dtype": "int8"})
              if quant else {})
    logs = {"prefill": PutLog(sync=False), "decode": PutLog(sync=False)}
    qz.launches["quantize"] = 0
    fe = ServingFrontend(engines, ServingConfig(
        max_queue_depth=64, disaggregation={
            "enabled": True, "roles": ["prefill", "decode"],
            "handoff": {"enabled": True, "max_staged": max_staged}},
        **blocks))
    quantize_launches = qz.launches["quantize"]
    sizes, copies = [], {"export": [], "import": []}
    imported = {}
    real_stage = fe._stager.try_stage

    def stage(req, payload):
        sizes.append(payload_bytes(payload))
        return real_stage(req, payload)
    fe._stager.try_stage = stage

    def timed(engine, name):
        real = getattr(engine, f"{name}_sequence")

        def call(uid, *a, **kw):
            t = time.monotonic()
            out = real(uid, *a, **kw)
            copies[name].append(time.monotonic() - t)
            if name == "import":
                imported[uid] = t
            return out
        setattr(engine, f"{name}_sequence", call)
    timed(engines[0], "export")
    timed(engines[1], "import")
    try:
        logs["prefill"].attach(engines[0])
        logs["decode"].attach(engines[1])
        check_replicas(fe, label)
        if [r.role for r in fe.router.replicas] != ["prefill", "decode"]:
            raise AssertionError(f"[serving] {label}: roles")
        run = frontend_run(fe, prompts, DISAGG_NEW, label, logs)
        check_replicas(fe, label)
    finally:
        for log_ in logs.values():
            log_.close()
        fe.shutdown(drain=False, timeout=5)
        engines[1].config.max_ragged_sequence_count = seqs
        del engines[0].export_sequence, engines[1].import_sequence
    for eng in engines:
        occ = eng.occupancy()
        if occ["available_blocks"] != eng.config.kv_blocks:
            raise AssertionError(f"[serving] {label}: {occ} after shutdown")
    # staging to the start of the import: the wait for a decode slot
    waits = [imported[h._req.uid] - h._req.handoff_t
             for h in run["handles"] if h._req.uid in imported]
    run.update(sizes=sizes, quantize_launches=quantize_launches,
               journal=fe.journal.events(), copies=copies, waits=waits,
               pre_puts=logs["prefill"].puts, dec_puts=logs["decode"].puts)
    return run


def check_handoff_split(run, prompts, label, quant, cfg):
    """Every request handed off once with no fallback; the prefill replica
    fed each prompt token once and nothing else, the decode replica only
    one-token decode rows, one a new token (the scheduler feeds each token
    in the put that samples it; the first is sampled from the handed-off
    ``last_logits``); one paged launch a layer and put on each, and with
    int8 weights 7 quantized-matmul launches a layer and lm_head's a put."""
    snap, n = run["snap"], len(prompts)
    if not (snap["handoffs_started"] == snap["handoffs_completed"] == n
            and snap["handoff_fallbacks"] == 0 and len(run["sizes"]) == n):
        raise AssertionError(
            f"[serving] {label}: handoffs started "
            f"{snap['handoffs_started']}, completed "
            f"{snap['handoffs_completed']}, fallbacks "
            f"{snap['handoff_fallbacks']}, staged {len(run['sizes'])}")
    pre_tokens = sum(t for t, _, _ in run["pre_puts"])
    dec_rows = [(t, is_pre) for t, is_pre, _ in run["dec_puts"]]
    if pre_tokens != sum(map(len, prompts)) \
            or any(is_pre for _, is_pre in dec_rows) \
            or sum(t for t, _ in dec_rows) != n * DISAGG_NEW:
        raise AssertionError(
            f"[serving] {label}: prefill replica fed {pre_tokens} tokens "
            f"(prompts {sum(map(len, prompts))}); decode replica "
            f"{sum(t for t, _ in dec_rows)} tokens in {len(dec_rows)} "
            f"puts, {sum(1 for _, p in dec_rows if p)} with prompt chunks")
    n_puts = run["stats"]["puts"]
    want_qmm = ((7 * cfg.num_layers + (0 if cfg.tie_embeddings else 1))
                * n_puts if quant else 0)
    if run["launches"]["quantized_matmul"] != want_qmm:
        raise AssertionError(f"[serving] {label}: launches "
                             f"{run['launches']}, want {want_qmm} qmm")


def serving_disagg(model, params):
    """Cell 5: 16 requests, prompts of 64-2048 tokens, 32 new tokens each,
    through a prefill and a decode replica with the KV handoff (staging for
    16), bf16 and again with int8 weights + int8 KV; beside one and two
    mixed replicas on the same prompts; and 8 requests of 64 tokens, all
    prefilled in one put, with 2 staging slots before a decode replica
    that takes one sequence at a time, so that the finished prompts
    overflow the buffer into counted fallbacks (re-prefilled on the decode
    replica)."""
    from deepspeed_tpu_torch.serving import ServingConfig, ServingFrontend

    V = model.cfg.vocab_size
    prompts = disagg_prompts(V)
    e0 = serving_engine(model, params, DISAGG_KV_BLOCKS)
    e1 = serving_engine(model, params, DISAGG_KV_BLOCKS)
    gap = feature_gap(e0, "serving disagg", ())
    off = bare_run(e0, prompts, DISAGG_NEW, "disagg")
    mixed = {}
    for n in (1, 2):
        logs = {f"r{i}": PutLog(sync=False) for i in range(n)}
        fe = ServingFrontend([e0, e1][:n], ServingConfig(max_queue_depth=64))
        try:
            for i, eng in enumerate([e0, e1][:n]):
                logs[f"r{i}"].attach(eng)
            mixed[n] = frontend_run(fe, prompts, DISAGG_NEW,
                                    f"disagg mixed x{n}", logs)
        finally:
            for log_ in logs.values():
                log_.close()
            fe.shutdown(drain=False, timeout=5)
        parity_rule(off, mixed[n], gap, f"serving disagg mixed x{n}")
    bf16 = disagg_run([e0, e1], prompts, "disagg bf16")
    check_handoff_split(bf16, prompts, "disagg bf16", False, model.cfg)
    parity_rule(off, bf16, gap, "serving disagg bf16")
    short = [p[:64] for p in prompts[:8]]
    off_short = bare_run(e0, short, DISAGG_NEW, "disagg overflow")
    over = disagg_run([e0, e1], short, "disagg overflow", max_staged=2,
                      decode_seqs=1)
    snap = over["snap"]
    fallbacks = [e["detail"]["where"] for e in over["journal"]
                 if e["kind"] == "handoff_fallback"]
    if snap["handoff_fallbacks"] < 1 \
            or snap["handoffs_started"] != snap["handoffs_completed"] \
            or snap["handoffs_completed"] + snap["handoff_fallbacks"] != 8 \
            or fallbacks != ["staging_full"] * len(fallbacks) \
            or len(fallbacks) != snap["handoff_fallbacks"]:
        raise AssertionError(f"[serving] disagg overflow: fallbacks "
                             f"{fallbacks}, {snap}")
    parity_rule(off_short, over, gap, "serving disagg overflow")
    del e0, e1
    gc.collect()
    torch.cuda.empty_cache()

    hand = serving_engine(model, params, DISAGG_KV_BLOCKS)
    hand.configure_weight_quant(True, dtype="int8", block=128, skip=[])
    hand.configure_kv_quant(True, "int8", "block")
    gap8 = feature_gap(hand, "serving disagg int8", ())
    off8 = bare_run(hand, prompts, DISAGG_NEW, "disagg int8")
    del hand
    gc.collect()
    torch.cuda.empty_cache()
    engines = [serving_engine(model, params, DISAGG_KV_BLOCKS)
               for _ in range(2)]
    int8 = disagg_run(engines, prompts, "disagg int8", quant=True)
    want_q = 2 * (7 + (0 if model.cfg.tie_embeddings else 1))
    if int8["quantize_launches"] != want_q:
        raise AssertionError(f"[serving] disagg int8: "
                             f"{int8['quantize_launches']} quantize launches "
                             "at the build of two engines")
    check_handoff_split(int8, prompts, "disagg int8", True, model.cfg)
    parity_rule(off8, int8, gap8, "serving disagg int8")
    del engines
    gc.collect()
    torch.cuda.empty_cache()

    def row(r):
        s = r["stats"]
        return (f"p50/p95 TTFT {s['ttft_p50_ms']:.1f}/{s['ttft_p95_ms']:.1f}"
                f" ms, TPOT {s['tpot_ms']:.2f} ms, {s['tokens_per_s']:.1f} "
                f"tokens/s, {s['puts']} puts")
    for name, r in (("one mixed replica", mixed[1]),
                    ("two mixed replicas", mixed[2]),
                    ("prefill + decode bf16", bf16),
                    ("prefill + decode int8", int8)):
        log(f"[serving] disagg {name}: {row(r)}")
    res = {"bare": off["stats"], "mixed1": mixed[1]["stats"],
           "mixed2": mixed[2]["stats"]}
    for name, r in (("bf16", bf16), ("int8", int8)):
        ms = {k: np.percentile(np.asarray(v) * 1e3, (50, 95)).tolist()
              for k, v in (("export", r["copies"]["export"]),
                           ("import", r["copies"]["import"]),
                           ("wait", r["waits"]))}
        res[name] = dict(r["stats"], handoff_ms=ms,
                         payload_bytes_mean=float(np.mean(r["sizes"])),
                         puts_prefill=len(r["pre_puts"]),
                         puts_decode=len(r["dec_puts"]),
                         launches=r["launches"])
        log(f"[serving] disagg {name}: {DISAGG_REQUESTS} handoffs, 0 "
            f"fallbacks; p50/p95 ms: export "
            f"{ms['export'][0]:.2f}/{ms['export'][1]:.2f}, staged until the "
            f"import {ms['wait'][0]:.2f}/{ms['wait'][1]:.2f}, import "
            f"{ms['import'][0]:.2f}/{ms['import'][1]:.2f} (handoff_s, staged"
            f" to imported, is their sum); payload bytes a request mean "
            f"{np.mean(r['sizes']):.0f} (min {min(r['sizes'])}, max "
            f"{max(r['sizes'])}); puts prefill replica "
            f"{len(r['pre_puts'])}, decode replica {len(r['dec_puts'])}; "
            f"launches {json.dumps(r['launches'])}")
    res["overflow"] = {k: over["snap"][k] for k in (
        "handoffs_started", "handoffs_completed", "handoff_fallbacks")}
    log(f"[serving] disagg overflow (8 requests, 2 staging slots, one "
        f"decode sequence at a time): "
        f"{json.dumps(res['overflow'])}; every stream held")
    return res


def serving_tenancy(model, params):
    """Cell 6: one replica, tenants gold (weight 2) and silver (weight 1)
    flood 24 requests each (256-token prompts, 16 new tokens) at once,
    then tenant capped (weight 1, 100 tokens/s, below what it offers)
    sends 8."""
    from deepspeed_tpu_torch.serving import (Rejected, RequestState,
                                             ServingConfig, ServingFrontend)

    rng = np.random.default_rng(25)
    V = model.cfg.vocab_size
    plan = (["gold"] * TENANT_FLOOD + ["silver"] * TENANT_FLOOD
            + ["capped"] * TENANT_CAPPED)
    prompts = [rng.integers(0, V, TENANT_PROMPT).tolist() for _ in plan]
    engine = serving_engine(model, params, SERVE_KV_BLOCKS)
    gap = feature_gap(engine, "serving tenancy", ())
    off = bare_run(engine, prompts, TENANT_NEW, "tenancy")
    tenants = {"gold": {"weight": 2.0}, "silver": {"weight": 1.0},
               "capped": {"weight": 1.0, "token_rate": TENANT_RATE}}
    fe = ServingFrontend([engine], ServingConfig(max_queue_depth=128,
                                                 tenants=tenants))
    logs = {"r0": PutLog(sync=False)}
    logs["r0"].attach(engine)
    deaths = watch_deaths(fe)
    reset_launches()
    t0 = time.perf_counter()
    try:
        handles, shed = [], {t: 0 for t in tenants}
        for t, p in zip(plan, prompts):
            try:
                handles.append((t, fe.submit(p, max_new_tokens=TENANT_NEW,
                                             tenant=t)))
            except Rejected:
                shed[t] += 1
        done = fe.wait_all([h for _, h in handles], timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pa.launches
        snap = fe.metrics_snapshot()
        books = fe.health_report()["tenants"]
        throttled = [e["detail"] for e in fe.journal.events()
                     if e["kind"] == "tenant_throttled"]
    finally:
        logs["r0"].close()
        fe.shutdown(drain=False, timeout=5)
    L = model.cfg.num_layers
    if not done or deaths or snap["requests_failed"] \
            or launches != L * len(logs["r0"].puts):
        raise AssertionError(f"[serving] tenancy: done {done}, deaths "
                             f"{deaths}, launches {launches}")
    per = {}
    for t in tenants:
        hs = [h for u, h in handles if u == t]
        per[t] = {"submitted": plan.count(t),
                  "completed": sum(h.state == RequestState.FINISHED
                                   for h in hs),
                  "expired": sum(h.state == RequestState.EXPIRED
                                 for h in hs),
                  "shed": shed[t]}
        if per[t]["submitted"] != (per[t]["completed"] + per[t]["shed"]
                                   + per[t]["expired"]) \
                or snap[f"requests_submitted_tenant_{t}"] \
                != per[t]["submitted"]:
            raise AssertionError(f"[serving] tenancy {t}: {per[t]}")
        ttft = [(h._req.first_token_t - h._req.arrival_t) * 1e3 for h in hs
                if h.state == RequestState.FINISHED]
        per[t]["ttft_p50_ms"] = float(np.percentile(ttft, 50))
        per[t]["ttft_p95_ms"] = float(np.percentile(ttft, 95))
    if not any(d["tenant"] == "capped" and d["reason"] == "token_rate"
               for d in throttled):
        raise AssertionError(f"[serving] tenancy: throttle events "
                             f"{throttled}")
    # the dispatched-token share while gold and silver both had work
    # queued: requests admitted before the first of the two floods ran dry
    admitted = sorted((h._req.admitted_t, t) for t, h in handles
                      if t != "capped")
    last = {t: max(a for a, u in admitted if u == t)
            for t in ("gold", "silver")}
    cut = min(last.values())
    both = [t for a, t in admitted if a < cut]
    share = both.count("gold") / max(1, len(both))
    on = {"streams": [[ev.token for ev in h.drain()] for _, h in handles]}
    parity_rule(off, on, gap, "serving tenancy")
    log(f"[serving] tenancy: per tenant {json.dumps(per)}; while gold and "
        f"silver were both backlogged ({len(both)} dispatches) gold took "
        f"{share:.3f} of the dispatched tokens (weights 2:1 -> 0.667); "
        f"capped throttled {len(throttled)} time(s) (token_rate "
        f"{TENANT_RATE}); books "
        + json.dumps({t: {k: b[k] for k in ("service", "window_tokens")}
                      for t, b in books.items()})
        + f"; {len(logs['r0'].puts)} puts in {wall:.2f} s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"per_tenant": per, "gold_share": share,
            "both_backlogged": len(both), "throttle_events": len(throttled),
            "wall_s": wall}


def affinity_prompts(V):
    """The first wave sends each system prompt once; the later waves send
    each again, in a shuffled order (so that a cache-blind router, which
    alternates between two idle replicas, does not repeat the first
    wave's placement by accident)."""
    rng = np.random.default_rng(26)
    systems = [rng.integers(0, V, AFFINITY_SYS).tolist()
               for _ in range(AFFINITY_PREFIXES)]
    waves = [[s + rng.integers(0, V, AFFINITY_TAIL).tolist()
              for s in systems] for _ in range(AFFINITY_REPEATS)]
    rest = [p for w in waves[1:] for p in w]
    order = rng.permutation(len(rest))
    waves = [waves[0], [rest[i] for i in order]]
    extra = systems[0] + rng.integers(0, V, AFFINITY_TAIL).tolist()
    return waves, extra


def serving_affinity(model, params):
    """Cell 7: two mixed replicas with the prefix cache on; 6 system prompts
    of 1024 tokens (+ 32-token tails, 16 new tokens) sent 4 times: one
    wave with each prompt once, then the other three waves at once;
    affinity off, then on. Then ``add_replica()`` with warm-up, the first
    two replicas removed, and one more shared-prefix request, which must
    land on the warmed replica and match its warmed blocks."""
    from deepspeed_tpu_torch.serving import ServingConfig, ServingFrontend

    V = model.cfg.vocab_size
    waves, extra = affinity_prompts(V)
    flat = [p for w in waves for p in w]
    ref_engine = serving_engine(model, params, SERVE_KV_BLOCKS)
    gap = feature_gap(ref_engine, "serving affinity", ())
    off_ref = bare_run(ref_engine, flat + [extra], AFFINITY_NEW, "affinity")
    del ref_engine
    logs = {}

    def factory(i):
        eng = serving_engine(model, params, SERVE_KV_BLOCKS)
        eng.configure_prefix_cache(True, None)
        logs[f"r{i}"] = PutLog(sync=False)
        logs[f"r{i}"].attach(eng)
        return eng

    res = {}
    for name, enabled in (("off", False), ("on", True)):
        logs.clear()
        fe = ServingFrontend.from_engine_factory(factory, ServingConfig(
            num_replicas=2, max_queue_depth=64,
            prefix_cache={"enabled": True},
            affinity={"enabled": enabled, "refresh_interval_s": 0.05,
                      "warmup_max_blocks": 512}))
        try:
            check_replicas(fe, f"affinity {name}")
            first = frontend_run(fe, waves[0], AFFINITY_NEW,
                                 f"affinity {name} wave 1", dict(logs))
            time.sleep(0.2)             # a router tick refreshes digests
            before = [r.engine.prefix_stats() for r in fe.router.replicas]
            rest = frontend_run(fe, waves[1], AFFINITY_NEW,
                                f"affinity {name} waves 2-4", dict(logs))
            after = [r.engine.prefix_stats() for r in fe.router.replicas]
            saved = sum(a["tokens_saved"] - b["tokens_saved"]
                        for a, b in zip(after, before))
            # the share of the later waves' system-prompt tokens that
            # came from a replica's prefix cache
            offered = len(waves[1]) * AFFINITY_SYS
            res[name] = {"hit_rate": saved / offered,
                         "tokens_saved": saved,
                         "affinity": (fe._affinity.stats()
                                      if enabled else None),
                         "stats": rest["stats"]}
            on = {"streams": first["streams"] + rest["streams"]}
            parity_rule({"streams": off_ref["streams"][:len(flat)],
                         "margins": off_ref["margins"][:len(flat)]}, on,
                        gap, f"serving affinity {name}")
            if enabled:
                t = time.perf_counter()
                rid = fe.add_replica()
                grow_s = time.perf_counter() - t
                evs = [e["detail"] for e in fe.journal.events()
                       if e["kind"] == "replica_warmup"]
                if [e["replica"] for e in evs] != [rid] \
                        or evs[0]["blocks"] <= 0:
                    raise AssertionError(f"[serving] affinity warm-up: "
                                         f"{evs}")
                new = fe.router.replica_by_id(rid)
                fe.remove_replica(0)
                fe.remove_replica(1)
                p0 = new.engine.prefix_stats()
                last = frontend_run(fe, [extra], AFFINITY_NEW,
                                    "affinity warmed replica", dict(logs))
                p1 = new.engine.prefix_stats()
                matched = p1["tokens_saved"] - p0["tokens_saved"]
                if last["handles"][0]._req.replica_id != rid \
                        or matched < AFFINITY_SYS:
                    raise AssertionError(f"[serving] affinity: the warmed "
                                         f"replica matched {matched} tokens")
                parity_rule({"streams": off_ref["streams"][-1:],
                             "margins": off_ref["margins"][-1:]}, last, gap,
                            "serving affinity warmed replica")
                res["warmup"] = {"blocks": evs[0]["blocks"],
                                 "warmup_ms": evs[0]["warmup_s"] * 1e3,
                                 "grow_s": grow_s, "first_matched": matched}
        finally:
            for log_ in logs.values():
                log_.close()
            fe.shutdown(drain=False, timeout=5)
    del fe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serving] affinity off | on (waves 2-4, 18 requests): prefix hit "
        f"rate (system-prompt tokens served from a cache) "
        f"{res['off']['hit_rate']:.3f} | {res['on']['hit_rate']:.3f}, "
        f"tokens saved {res['off']['tokens_saved']} | "
        f"{res['on']['tokens_saved']}; p50 TTFT "
        f"{res['off']['stats']['ttft_p50_ms']:.1f} | "
        f"{res['on']['stats']['ttft_p50_ms']:.1f} ms; router "
        f"{json.dumps(res['on']['affinity'])}")
    w = res["warmup"]
    log(f"[serving] affinity warm-up: {w['blocks']} blocks in "
        f"{w['warmup_ms']:.1f} ms (add_replica {w['grow_s']:.2f} s); the "
        f"warmed replica's first shared-prefix request matched "
        f"{w['first_matched']} tokens")
    return res


def serving_autoscale(model, params):
    """Cell 8: the autoscaler on one replica (min 1, max 2, cooldowns
    5 s up and 1 s down, ticks of 0.1 s): 16 requests of 512 tokens and
    64 new tokens at once grow the fleet; near the tail (100 outstanding
    tokens a replica) it shrinks, evacuating the resident sequences (the
    5 s up-cooldown keeps their requeue from growing it again). Then a
    prefill + decode fleet re-roles its prefill replica to mixed while it
    serves 8 requests."""
    from deepspeed_tpu_torch.serving import ServingConfig, ServingFrontend

    rng = np.random.default_rng(27)
    V, L = model.cfg.vocab_size, model.cfg.num_layers
    prompts = [rng.integers(0, V, SCALE_PROMPT).tolist()
               for _ in range(SCALE_REQUESTS)]
    ref = serving_engine(model, params, SERVE_KV_BLOCKS)
    gap = feature_gap(ref, "serving autoscale", ())
    off = bare_run(ref, prompts, SCALE_NEW, "autoscale")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    log_ = PutLog(sync=False)
    first_put = {}

    def factory(i):
        eng = serving_engine(model, params, SERVE_KV_BLOCKS, log_)
        real = eng.put

        def put(uids, chunks, **kw):
            first_put.setdefault(i, time.monotonic())
            return real(uids, chunks, **kw)
        eng.put = put
        return eng

    fe = ServingFrontend([factory(0)], ServingConfig(
        max_queue_depth=64,
        autoscaler={"enabled": True, "min_replicas": 1, "max_replicas": 2,
                    "scale_up_queue_per_replica": 2.0,
                    "scale_down_queue_per_replica": 0.25,
                    "scale_down_tokens_per_replica": 100.0,
                    "up_stable_ticks": 1, "down_stable_ticks": 2,
                    "scale_up_cooldown_s": 5.0,
                    "scale_down_cooldown_s": 1.0,
                    "tick_interval_s": 0.1}), engine_factory=factory)
    try:
        run = frontend_run(fe, prompts, SCALE_NEW, "autoscale",
                           {"all": log_})
        deadline = time.monotonic() + 60
        while len(fe.router.replicas) > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        st = fe.autoscaler.stats()
        log_rows = [d for d in fe.autoscaler.decision_log
                    if d["action"] in ("scale_up", "scale_down",
                                       "replica_reroled")]
        evs = fe.journal.events(kinds=("scale_up", "scale_down",
                                       "replica_reroled"))
        snap = fe.metrics_snapshot()
    finally:
        log_.close()
        fe.shutdown(drain=False, timeout=5)
    if [(e["kind"], e["detail"]["replica"]) for e in evs] \
            != [(d["action"], d["replica"]) for d in log_rows]:
        raise AssertionError(f"[serving] autoscale: decision log {log_rows}"
                             f" != journal {evs}")
    ups = [d for d in log_rows if d["action"] == "scale_up"]
    downs = [d for d in log_rows if d["action"] == "scale_down"]
    if not ups or not downs or len(fe.router.replicas) != 1:
        raise AssertionError(f"[serving] autoscale: {log_rows}")
    grow_to_serving = first_put[ups[0]["replica"]] - ups[0]["t"]
    parity_rule(off, run, gap, "serving autoscale")
    stats = run["stats"]
    del fe, run             # the handles hold the frontend and its engines
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    pool = SERVE_KV_BLOCKS * KV_BLOCK_BYTES_BF16
    if mem1 - mem0 > pool:
        raise AssertionError(f"[serving] autoscale: {mem1 - mem0} bytes "
                             f"still allocated (one pool is {pool})")

    # an explicit re-role under disaggregation, mid-traffic
    rr_prompts = prompts[:8]
    engines = [serving_engine(model, params, SERVE_KV_BLOCKS)
               for _ in range(2)]
    logs = {"r0": PutLog(sync=False), "r1": PutLog(sync=False)}
    fe = ServingFrontend(engines, ServingConfig(
        max_queue_depth=64, disaggregation={
            "enabled": True, "roles": ["prefill", "decode"],
            "handoff": {"enabled": True, "max_staged": 16}}),
        engine_factory=lambda i: serving_engine(model, params,
                                                SERVE_KV_BLOCKS))
    deaths = watch_deaths(fe)
    try:
        logs["r0"].attach(engines[0])
        logs["r1"].attach(engines[1])
        reset_launches()
        handles = [fe.submit(p, max_new_tokens=SCALE_NEW)
                   for p in rr_prompts]
        deadline = time.monotonic() + 120
        while fe.metrics_snapshot()["handoffs_completed"] < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.005)
        t = time.perf_counter()
        changed = fe.set_replica_role(0, "mixed")
        rerole_s = time.perf_counter() - t
        done = fe.wait_all(handles, timeout=600)
        torch.cuda.synchronize()
        launches = pa.launches
        census = fe.router.role_census()
        rsnap = fe.metrics_snapshot()
        streams = [[ev.token for ev in h.drain()] for h in handles]
    finally:
        for lg in logs.values():
            lg.close()
        fe.shutdown(drain=False, timeout=5)
    n_puts = sum(len(lg.puts) for lg in logs.values())
    if not changed or not done or deaths or rsnap["requests_failed"] \
            or census != {"prefill": 0, "decode": 1, "mixed": 1} \
            or launches != L * n_puts:
        raise AssertionError(f"[serving] re-role: changed {changed}, done "
                             f"{done}, deaths {deaths}, census {census}, "
                             f"launches {launches} for {n_puts} puts")
    parity_rule({"streams": off["streams"][:8],
                 "margins": off["margins"][:8]}, {"streams": streams}, gap,
                "serving re-role")
    del engines, fe
    gc.collect()
    torch.cuda.empty_cache()
    res = {"scale_ups": st["scale_ups"], "scale_downs": st["scale_downs"],
           "peak_replicas": st["peak_replicas"],
           "replica_seconds": st["replica_seconds"],
           "grow_to_serving_s": grow_to_serving,
           "evacuated": snap.get("requests_evacuated", 0.0),
           "mem_delta": mem1 - mem0, "rerole_s": rerole_s,
           "rerole_evacuated": rsnap.get("requests_evacuated", 0.0),
           "stats": stats}
    decisions = [(d["action"], d["replica"], d.get("reason"))
                 for d in log_rows]
    log(f"[serving] autoscale: decisions {decisions} (journal equal); grow decision to the new replica's first put "
        f"{grow_to_serving:.3f} s; replica_seconds "
        f"{st['replica_seconds']:.2f} (peak {st['peak_replicas']}); "
        f"{int(res['evacuated'])} requests evacuated by the shrink; memory "
        f"after the cell {(mem1 - mem0) / 2**20:+.1f} MiB against before it; "
        f"re-role prefill -> mixed mid-traffic in {rerole_s:.3f} s "
        f"({int(res['rerole_evacuated'])} evacuated), census {census}")
    return res


def phase_serving():
    """The serving phase: ServingFrontend at full MISTRAL_7B width over
    engines that share one bf16 weight tree — the burst cell, the chaos
    cell, the quantized-through-the-config cell with the observability
    checks, and the disaggregation, tenancy, affinity and autoscale
    cells."""
    from deepspeed_tpu_torch.models.transformer import CausalLM

    cfg = serve_cfg()
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
    for name, cell in (("quant", serving_quant_obs),
                       ("disagg", serving_disagg),
                       ("tenancy", serving_tenancy),
                       ("affinity", serving_affinity),
                       ("autoscale", serving_autoscale)):
        t = time.perf_counter()
        res[name] = cell(model, params)
        res[name]["cell_s"] = time.perf_counter() - t
    log("[serving] cell seconds: "
        + ", ".join(f"{k} {v['cell_s']:.1f}" for k, v in res.items()))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------- fabric

FABRIC_SEED = 11
FABRIC_NEW = 32                     # new tokens a request in every run
FABRIC_ALONE = 2                    # chaos prompts served one at a time
FABRIC_CHUNK_BLOCKS = 16            # a handoff chunk frame: 32 MiB at bf16
FABRIC_START_S = 300.0              # a server's start: import, weights
FABRIC_WAIT_S = 600.0               # a run's requests
FABRIC_INT8 = {"weight_quant": {"enabled": True, "dtype": "int8",
                                "block": 128},
               "kv_quant": {"enabled": True, "dtype": "int8"}}
FABRIC_FP8 = {"kv_quant": {"enabled": True, "dtype": "fp8_e4m3"}}
FABRIC_DISAGG = {"enabled": True, "roles": ["prefill", "decode"],
                 "handoff": {"enabled": True,
                             "max_staged": DISAGG_REQUESTS,
                             "chunk_blocks": FABRIC_CHUNK_BLOCKS}}
REPO = os.path.dirname(os.path.abspath(__file__))


def fabric_model_kw():
    """The serving paths' TransformerConfig (MISTRAL_7B at SERVE_LAYERS
    layers) as a JSON spec writes it."""
    kw = dataclasses.asdict(serve_cfg())
    kw["dtype"] = "bfloat16"
    return kw


def fabric_spec(kv_blocks, serving=None, **extra):
    spec = {"model": fabric_model_kw(), "seed": FABRIC_SEED,
            "engine": {"kv_block_size": 16, "max_chunk_tokens": 256,
                       "max_ragged_sequence_count": SERVE_MAX_SEQS,
                       "kv_blocks": kv_blocks},
            "serving": dict(serving or {})}
    spec.update(extra)
    return spec


class FabricProc:
    """One ``python -m deepspeed_tpu_torch.scripts.<module>`` process on the
    card; a reader thread collects its output lines. Every wait has a
    timeout, and a process that exits early fails the wait with its last
    lines. ``started`` holds every process made, so that the phase's
    ``finally`` kills whatever still runs."""

    started = []

    def __init__(self, module, spec, label, tmp, listen="127.0.0.1:0"):
        path = os.path.join(tmp, f"{label}.json")
        with open(path, "w") as fh:
            json.dump(spec, fh)
        cmd = [sys.executable, "-m", f"deepspeed_tpu_torch.scripts.{module}",
               "--spec", path]
        if module == "serve_replica":
            cmd += ["--listen", listen, "--loopback-ok"]
        self.label, self.lines = label, []
        self.proc = subprocess.Popen(
            cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ, PYTHONPATH=REPO))
        FabricProc.started.append(self)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self.address = None

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def tagged(self, tag):
        return [ln.split(" ", 1)[1] for ln in list(self.lines)
                if ln.startswith(tag + " ")]

    def wait_tag(self, tag, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = self.tagged(tag)
            if got:
                return got[0]
            if self.proc.poll() is not None:
                self._reader.join(5)
                got = self.tagged(tag)
                if got:
                    return got[0]
                break
            time.sleep(0.05)
        raise AssertionError(
            f"[fabric] {self.label}: no {tag} line (exit "
            f"{self.proc.poll()}); last lines:\n" + "\n".join(self.lines[-30:]))

    def listening(self, tag="FABRIC_LISTENING"):
        self.address = self.wait_tag(tag, FABRIC_START_S)
        return self.address

    def stop(self, timeout=120.0):
        """SIGTERM and wait: a server that does not stop in ``timeout``
        fails the phase. Returns its output lines."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise AssertionError(f"[fabric] {self.label}: did not stop in "
                                 f"{timeout} s (killed)")
        self._reader.join(10)
        if self.proc.returncode != 0:
            raise AssertionError(
                f"[fabric] {self.label}: exit {self.proc.returncode}; last "
                "lines:\n" + "\n".join(self.lines[-30:]))
        return self.lines

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(30)


def fabric_frontend(peers, **extra):
    from deepspeed_tpu_torch.serving import ServingConfig, ServingFrontend

    fab = {"enabled": True, "peers": list(peers), "heartbeat_s": 1.0,
           "rpc_timeout_s": 300.0}
    fab.update(extra.pop("fabric", {}))
    return ServingFrontend([], ServingConfig(max_queue_depth=64, fabric=fab,
                                             **extra))


def status_clock(fe):
    """Record the arrival time of every status event on each remote
    handle (the ~4/s stream that is also the server's liveness signal)."""
    ticks = {}
    for rep in fe.router.replicas:
        real = rep._ev_status
        got = ticks.setdefault(rep.replica_id, [])

        def on_status(msg, _real=real, _got=got):
            _got.append(time.monotonic())
            return _real(msg)

        rep._ev_status = on_status
    return ticks


def fabric_run(fe, prompts, label, alone=False, during=None):
    """Submit ``prompts`` (at once, or one at a time with ``alone``) and
    wait; ``during(handles)`` runs while they stream. Fails unless every
    request finished with ``FABRIC_NEW`` tokens and none failed."""
    from deepspeed_tpu_torch.serving import RequestState

    t0 = time.perf_counter()
    handles = []
    if alone:
        for p in prompts:
            h = fe.submit(p, max_new_tokens=FABRIC_NEW)
            if not fe.wait_all([h], timeout=FABRIC_WAIT_S):
                raise AssertionError(f"[fabric] {label}: request timed out")
            handles.append(h)
    else:
        handles = [fe.submit(p, max_new_tokens=FABRIC_NEW) for p in prompts]
        if during is not None:
            during(handles)
        if not fe.wait_all(handles, timeout=FABRIC_WAIT_S):
            raise AssertionError(f"[fabric] {label}: requests timed out: "
                                 f"{[h.state for h in handles]}")
    wall = time.perf_counter() - t0
    snap = fe.metrics_snapshot()
    states = [h.state for h in handles]
    streams = [[ev.token for ev in h.drain()] for h in handles]
    if any(s != RequestState.FINISHED for s in states) \
            or snap["requests_failed"] \
            or any(len(s) != FABRIC_NEW for s in streams):
        raise AssertionError(f"[fabric] {label}: states {states}, failed "
                             f"{snap['requests_failed']}, lengths "
                             f"{[len(s) for s in streams]}")
    reqs = [h._req for h in handles]
    stats = latency_stats([r.first_token_t for r in reqs],
                          [r.last_token_t for r in reqs],
                          [r.arrival_t for r in reqs],
                          [len(r.generated_tokens) for r in reqs])
    stats.update(tokens_per_s=sum(map(len, streams)) / wall, wall_s=wall)
    hist = fe.metrics.histogram("rpc_call_s")
    stats.update(rpc_p50_ms=hist.percentile(50) * 1e3,
                 rpc_mean_ms=hist.mean * 1e3, rpc_calls=hist.count)
    return {"streams": streams, "snap": snap, "stats": stats,
            "handles": handles, "attempts": [h.attempts for h in handles]}


def fabric_row(label, r):
    s = r["stats"]
    log(f"[fabric] {label}: {s['tokens_per_s']:.1f} tokens/s, p50/p95 TTFT "
        f"{s['ttft_p50_ms']:.1f}/{s['ttft_p95_ms']:.1f} ms, TPOT "
        f"{s['tpot_ms']:.2f} ms, wall {s['wall_s']:.2f} s"
        + (f"; rpc_call_s p50 {s['rpc_p50_ms']:.2f} ms (bucket estimate), "
           f"mean {s['rpc_mean_ms']:.2f} ms over {s['rpc_calls']} calls"
           if s["rpc_calls"] else ""))


def wait_for(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return time.monotonic()
        time.sleep(0.02)
    raise AssertionError(f"[fabric] timed out waiting for {what}")


def live_on(handles, rid, n=2):
    """True once a request on replica ``rid`` has ``n`` tokens."""
    return any(h._req.replica_id == rid and h._req.n_generated >= n
               and not h._req.done for h in handles)


def fabric_threads(engine, prompts, ref):
    """The same traffic through in-process replica threads in this call:
    one replica over ``engine``, then two (a second engine over the same
    weight tensors, its own pool) — what (a)'s processes are held
    against."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.serving import ServingConfig, ServingFrontend

    other = InferenceEngineV2(engine.model, engine.params,
                              copy.copy(engine.config), device=engine.device)
    out = {}
    for n in (1, 2):
        fe = ServingFrontend([engine, other][:n],
                             ServingConfig(max_queue_depth=64))
        try:
            run = fabric_run(fe, prompts, f"threads x{n}")
        finally:
            fe.shutdown(drain=False, timeout=10)
        parity_rule(ref["chaos"], run, ref["gap bf16"],
                    f"fabric threads x{n}")
        out[n] = run["stats"]
        fabric_row(f"(a) {n} replica thread{'s' if n > 1 else ''} in this "
                   "process", run)
    for eng in (engine, other):
        occ = eng.occupancy()
        if occ["available_blocks"] != occ["total_blocks"]:
            raise AssertionError(f"[fabric] threads: {occ} after the runs")
    return out


def fabric_reference(prompts, disagg):
    """The reference streams, computed in this process before any server
    starts: a bare scheduler over an engine built from the servers' own
    spec (one seed on one card gives one set of weights) — the chaos
    traffic at once and its first ``FABRIC_ALONE`` prompts one at a time,
    the disagg traffic at bf16, with int8 weights + KV and with fp8 KV.
    Each engine is dropped before the next is built, the last before the
    servers start."""
    from deepspeed_tpu_torch.serving import ServingConfig
    from deepspeed_tpu_torch.serving.config import ModelSpec
    from deepspeed_tpu_torch.serving.frontend import (
        apply_engine_serving_config, engine_from_model_spec)

    spec = fabric_spec(DISAGG_KV_BLOCKS)
    mspec = ModelSpec(model=spec["model"], engine=spec["engine"],
                      seed=spec["seed"])
    ref = {}
    for name, blocks in (("bf16", {}), ("int8", FABRIC_INT8),
                         ("fp8", FABRIC_FP8)):
        engine = engine_from_model_spec(mspec, device="cuda")
        apply_engine_serving_config(engine, ServingConfig(**blocks))
        engine.put([10_000], [list(range(16))])     # warm-up
        engine.flush(10_000)
        ref[f"gap {name}"] = feature_gap(engine, f"fabric {name}", ())
        if name == "bf16":
            ref["chaos"] = bare_run(engine, prompts, FABRIC_NEW,
                                    "fabric chaos")
            ref["alone"] = [bare_run(engine, [p], FABRIC_NEW,
                                     f"fabric alone {i}")["streams"][0]
                            for i, p in enumerate(prompts[:FABRIC_ALONE])]
            ref["threads"] = fabric_threads(engine, prompts, ref)
        ref[f"disagg {name}"] = bare_run(engine, disagg, FABRIC_NEW,
                                         f"fabric disagg {name}")
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return ref


def fabric_processes_vs_threads(ref, procs, prompts):
    """(a) the chaos traffic through one remote replica, then two, and its
    first prompts one at a time through one: the one-at-a-time streams are
    byte-identical to the reference's (the same puts run on both sides),
    the concurrent ones hold by the greedy-parity rule."""
    res = {}
    for n in (1, 2):
        fe = fabric_frontend([p.address for p in procs[:n]])
        try:
            ticks = status_clock(fe)
            run = fabric_run(fe, prompts, f"processes x{n}")
            if n == 1:
                alone = fabric_run(fe, prompts[:FABRIC_ALONE],
                                   "processes x1 one at a time", alone=True)
                if alone["streams"] != ref["alone"]:
                    raise AssertionError(
                        "[fabric] one request at a time through a replica "
                        "process: streams differ from the reference's")
                res["alone_identical"] = len(alone["streams"])
        finally:
            fe.shutdown(drain=False, timeout=10)
        gaps = [b - a for t in ticks.values() for a, b in zip(t, t[1:])]
        if not gaps:
            raise AssertionError("[fabric] no status events arrived")
        run["stats"]["status_per_s"] = 1.0 / float(np.mean(gaps))
        run["stats"]["status_gap_p50_ms"] = float(np.percentile(gaps, 50)) \
            * 1e3
        run["diverged"] = parity_rule(ref["chaos"], run, ref["gap bf16"],
                                      f"fabric processes x{n}")
        res[n] = run
        fabric_row(f"(a) {n} replica process{'es' if n > 1 else ''}", run)
    one, two = res[1]["stats"], res[2]["stats"]
    th = ref["threads"]
    res["two_over_one"] = two["tokens_per_s"] / one["tokens_per_s"]
    res["threads_two_over_one"] = th[2]["tokens_per_s"] / th[1]["tokens_per_s"]
    res["threads"] = th
    log(f"[fabric] (a) tokens/s one | two replica processes "
        f"{one['tokens_per_s']:.1f} | {two['tokens_per_s']:.1f} "
        f"({res['two_over_one']:.2f}x); one | two replica threads in this "
        f"process {th[1]['tokens_per_s']:.1f} | {th[2]['tokens_per_s']:.1f} "
        f"({res['threads_two_over_one']:.2f}x); "
        f"status events "
        f"{one['status_per_s']:.2f}/s a replica, p50 gap "
        f"{one['status_gap_p50_ms']:.1f} ms; {res['alone_identical']} "
        f"requests one at a time byte-identical to the reference")
    return res


def fabric_disagg(ref, procs, prompts, name):
    """(b) the serving phase's disagg traffic through a prefill and a
    decode replica process: every prompt's KV crosses the wire twice (prefill server to
    this process, then to the decode server) in chunk frames; 16 handoffs,
    0 fallbacks, streams by the greedy-parity rule against the mixed
    reference. Times each handoff's export and import (in the servers,
    read from their stop lines later) against this process's staging and
    assign times on one monotonic clock."""
    fe = fabric_frontend([p.address for p in procs],
                         disaggregation=FABRIC_DISAGG)
    sizes, staged, assigned = {}, {}, {}
    real_stage = fe._stager.try_stage

    def stage(req, payload):
        sizes[req.uid] = payload_bytes(payload)
        staged[req.uid] = time.monotonic()
        return real_stage(req, payload)

    fe._stager.try_stage = stage
    dec = fe.router.replicas[1]
    real_assign = dec.assign

    def assign(req):
        assigned.setdefault(req.uid, time.monotonic())
        return real_assign(req)

    dec.assign = assign
    try:
        if [r.role for r in fe.router.replicas] != ["prefill", "decode"]:
            raise AssertionError("[fabric] disagg roles")
        run = fabric_run(fe, prompts, f"disagg {name}")
        wait_for(lambda: fe.metrics_snapshot()["handoffs_completed"]
                 >= len(prompts), 30, "the decode server's import count")
        snap = fe.metrics_snapshot()
    finally:
        fe.shutdown(drain=False, timeout=10)
    if not (snap["handoffs_started"] == snap["handoffs_completed"]
            == len(prompts) and snap["handoff_fallbacks"] == 0
            and len(sizes) == len(prompts)):
        raise AssertionError(
            f"[fabric] disagg {name}: started {snap['handoffs_started']}, "
            f"completed {snap['handoffs_completed']}, fallbacks "
            f"{snap['handoff_fallbacks']}, staged {len(sizes)}")
    run["diverged"] = parity_rule(ref[f"disagg {name}"], run,
                                  ref[f"gap {name}"],
                                  f"fabric disagg {name}")
    run.update(sizes=sizes, staged=staged, assigned=assigned,
               uids=[h._req.uid for h in run["handles"]])
    fabric_row(f"(b) disagg {name}, prefill + decode processes", run)
    return run


def handoff_split(run, pre_lines, dec_lines, name):
    """Per request, on one monotonic clock: export (prefill server), wire
    in (export end to staged here), queue (staged to assign), wire out
    (assign to the decode server's import start: the chunk frames, the
    assign RPC and the worker's pick-up) and import (decode server)."""
    exp = json.loads(pre_lines[0])["export"]
    imp = json.loads(dec_lines[0])["import"]
    parts = {k: [] for k in ("export", "wire_in", "queue", "wire_out",
                             "import")}
    for uid in run["uids"]:
        e, i = exp.get(str(uid)), imp.get(str(uid))
        if e is None or i is None:
            raise AssertionError(f"[fabric] disagg {name}: request {uid} "
                                 "has no export or import span")
        parts["export"].append(e[1] - e[0])
        parts["wire_in"].append(run["staged"][uid] - e[1])
        parts["queue"].append(run["assigned"][uid] - run["staged"][uid])
        parts["wire_out"].append(i[0] - run["assigned"][uid])
        parts["import"].append(i[1] - i[0])
    ms = {k: np.percentile(np.asarray(v) * 1e3, (50, 95)).tolist()
          for k, v in parts.items()}
    mb = np.mean(list(run["sizes"].values())) / 1e6
    log(f"[fabric] (b) disagg {name}: {len(run['uids'])} handoffs, 0 "
        f"fallbacks, payload {mb:.1f} MB a request on the wire twice; "
        "handoff p50/p95 ms: "
        + ", ".join(f"{k} {v[0]:.2f}/{v[1]:.2f}" for k, v in ms.items()))
    return {"ms": ms, "payload_mb": mb}


def fabric_failover(ref, procs, prompts, tmp, spec):
    """(c) SIGKILL the second of two servers mid-decode: its requests fail
    over to the first (transport loss: ``replica_disconnected``), streams
    by the greedy-parity rule; a server respawned on the same port is
    re-dialed with ``reset`` by the supervisor (``replica_reconnected``).
    Then one seeded ``drop_conn`` on the live link to it fails over the
    same way. Returns the respawned process in ``procs``' place."""
    ft = {"enabled": True, "max_retries": 3, "restart_backoff_s": 0.2,
          "restart_backoff_max_s": 2.0, "supervisor_poll_s": 0.05,
          "restart_window_s": 600.0, "max_restarts_in_window": 100}
    out = {}
    fe = fabric_frontend([p.address for p in procs], fault_tolerance=ft)
    killed = {}

    def kill_b(handles):
        wait_for(lambda: live_on(handles, 1), 120,
                 "a stream on the second server")
        killed["t"] = time.monotonic()
        procs[1].kill()
        port = procs[1].address.rsplit(":", 1)[1]
        procs[1] = FabricProc("serve_replica", spec, "server-b2", tmp,
                              listen=f"127.0.0.1:{port}")

    try:
        run = fabric_run(fe, prompts, "failover (SIGKILL)", during=kill_b)
        t_done = time.monotonic()
        procs[1].listening()
        t_rec = wait_for(lambda: fe.journal.count("replica_reconnected") > 0,
                         FABRIC_START_S, "replica_reconnected")
        kinds = [e["kind"] for e in fe.journal.events()]
        check = fabric_run(fe, prompts[:8], "after the reconnect")
    finally:
        fe.shutdown(drain=False, timeout=10)
    if "replica_disconnected" not in kinds \
            or run["snap"]["requests_failed_over"] < 1 \
            or not any(a > 1 for a in run["attempts"]):
        raise AssertionError(
            f"[fabric] failover: journal {sorted(set(kinds))}, failed over "
            f"{run['snap']['requests_failed_over']}")
    out["kill"] = run
    out["kill_diverged"] = parity_rule(ref["chaos"], run, ref["gap bf16"],
                                       "fabric failover (SIGKILL)")
    parity_rule({k: v[:8] for k, v in ref["chaos"].items()
                 if k in ("streams", "margins")}, check, ref["gap bf16"],
                "fabric after the reconnect")
    out["failover_s"] = t_done - killed["t"]
    out["recovery_s"] = t_rec - killed["t"]
    fabric_row("(c) two processes, the second SIGKILLed mid-decode", run)
    log(f"[fabric] (c) SIGKILL: {int(run['snap']['requests_failed_over'])} "
        f"requests failed over, every stream finished "
        f"{out['failover_s']:.2f} s after the kill; the respawned server "
        f"re-dialed (replica_reconnected) recovery_s {out['recovery_s']:.2f}"
        " (the respawn's start included)")

    fe = fabric_frontend([p.address for p in procs], fault_tolerance=ft,
                         chaos={"enabled": True, "seed": 7, "schedule": [
                             {"kind": "drop_conn", "link": "fabric-r1",
                              "dir": "rx", "at_frame_range": [60, 140],
                              "count": 1}]})
    try:
        run = fabric_run(fe, prompts, "failover (drop_conn)")
        fired = fe.net_chaos.fired()
        t_rec = wait_for(lambda: fe.journal.count("replica_reconnected") > 0,
                         120, "replica_reconnected after the drop")
        kinds = [e["kind"] for e in fe.journal.events()]
    finally:
        fe.shutdown(drain=False, timeout=10)
    if [f[:2] for f in fired] != [("drop_conn", "fabric-r1")] \
            or "replica_disconnected" not in kinds \
            or run["snap"]["requests_failed_over"] < 1:
        raise AssertionError(f"[fabric] drop_conn: fired {fired}, journal "
                             f"{sorted(set(kinds))}, failed over "
                             f"{run['snap']['requests_failed_over']}")
    out["drop"] = run
    out["drop_diverged"] = parity_rule(ref["chaos"], run, ref["gap bf16"],
                                       "fabric failover (drop_conn)")
    log(f"[fabric] (c) drop_conn {fired}: "
        f"{int(run['snap']['requests_failed_over'])} requests failed over, "
        f"every stream finished; reconnected")
    return out


def fabric_federation(ref, server, exporter, prompts):
    """(d) a serve_frontend process exports its one local replica; this
    process's frontend adopts it beside one replica server. Streams by the
    greedy-parity rule; then the exporter is SIGKILLed while federated
    streams run and they fail back to the replica server, none lost."""
    ft = {"enabled": True, "max_retries": 3, "restart_backoff_s": 0.2,
          "restart_backoff_max_s": 2.0, "supervisor_poll_s": 0.05}
    fe = fabric_frontend([server.address], fault_tolerance=ft, fabric={
        "listen": "127.0.0.1:0",
        "federation": {"enabled": True, "peers": [exporter.address]}})
    try:
        fed = [r.replica_id for r in fe.router.replicas
               if getattr(r, "is_federated", False)]
        if len(fed) != 1:
            raise AssertionError(f"[fabric] federation: adopted {fed}")
        run = fabric_run(fe, prompts, "federation")
        if run["snap"]["requests_federated"] < 1:
            raise AssertionError("[fabric] federation: no request ran on "
                                 "the adopted replica")

        def kill_exporter(handles):
            wait_for(lambda: live_on(handles, fed[0]), 120,
                     "a stream on the adopted replica")
            exporter.kill()

        lost = fabric_run(fe, prompts, "federation, exporter SIGKILLed",
                          during=kill_exporter)
    finally:
        fe.shutdown(drain=False, timeout=10)
    if lost["snap"]["requests_failed_over"] < 1:
        raise AssertionError("[fabric] federation: the exporter's death "
                             "failed nothing over")
    out = {"run": run, "lost": lost}
    out["diverged"] = parity_rule(ref["chaos"], run, ref["gap bf16"],
                                  "fabric federation")
    out["lost_diverged"] = parity_rule(ref["chaos"], lost, ref["gap bf16"],
                                       "fabric federation, exporter killed")
    fabric_row("(d) adopted export + one replica process", run)
    log(f"[fabric] (d) {int(run['snap']['requests_federated'])} requests "
        f"ran on the adopted replica; the exporter's SIGKILL failed "
        f"{int(lost['snap']['requests_failed_over'])} over, none lost")
    return out


def fabric_kernel_lines(lines, label, quant):
    """(e) a server's stop line: one paged launch a layer and put, and with
    int8 weights 7 quantized-matmul launches a layer and lm_head's a put
    and 8 quantize launches (its one engine build)."""
    got = [ln.split(" ", 1)[1] for ln in lines
           if ln.startswith("FABRIC_KERNELS ")]
    if len(got) != 1:
        raise AssertionError(f"[fabric] {label}: stop lines {got}")
    k = json.loads(got[0])
    qmm = 7 * SERVE_LAYERS + 1
    want = {"paged_attention": SERVE_LAYERS * k["puts"],
            "quantized_matmul": qmm * k["puts"] if quant else 0,
            "quantize": 8 if quant else 0, "dequantize": 0}
    if k["puts"] < 1 or any(k[n] != v for n, v in want.items()):
        raise AssertionError(f"[fabric] {label}: launches {k}, want {want}")
    log(f"[fabric] (e) {label}: {json.dumps(k)} ({SERVE_LAYERS} paged"
        + (f", {qmm} qmm" if quant else "") + " a put)")
    return k


def handoff_lines(lines):
    return [ln.split(" ", 1)[1] for ln in lines
            if ln.startswith("FABRIC_HANDOFF ")]


def phase_fabric():
    """The cross-process serving fabric: MISTRAL_7B replicas at SERVE_LAYERS
    layers,
    bf16, seeded weights, each in its own ``serve_replica`` process on the
    card, this process holding the frontend. Sub-phases (a)-(e), each
    timed; every process is stopped (or killed, on a failure) in a
    ``finally``, and a dead or hung server fails the phase."""
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    V = MISTRAL_7B.vocab_size
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, V, CHAOS_PROMPT).tolist()
               for _ in range(CHAOS_REQUESTS)]
    disagg = disagg_prompts(V)
    secs, res, stopped = {}, {}, {}
    t = time.perf_counter()
    ref = fabric_reference(prompts, disagg)
    secs["reference"] = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="fabric_")
    spec = fabric_spec(DISAGG_KV_BLOCKS, {"disaggregation": FABRIC_DISAGG})
    FabricProc.started = []
    try:
        t = time.perf_counter()
        servers = [FabricProc("serve_replica", spec, f"server-{n}", tmp)
                   for n in ("a", "b")]
        exporter = FabricProc("serve_frontend", fabric_spec(
            CHAOS_KV_BLOCKS, {"max_queue_depth": 64, "fabric": {
                "enabled": True, "listen": "127.0.0.1:0", "heartbeat_s": 1.0,
                "federation": {"enabled": True}}}, n_replicas=1),
            "exporter", tmp)
        for p in servers:
            p.listening()
        exporter.listening("FEDERATION_LISTENING")
        secs["start"] = time.perf_counter() - t
        log(f"[fabric] servers {[p.address for p in servers]}, exporter "
            f"{exporter.address}: up in {secs['start']:.1f} s")
        for key, fn in (
                ("a", lambda: fabric_processes_vs_threads(ref, servers,
                                                          prompts)),
                ("c", lambda: fabric_failover(ref, servers, prompts, tmp,
                                              spec)),
                ("b bf16", lambda: fabric_disagg(ref, servers, disagg,
                                                 "bf16")),
                ("d", lambda: fabric_federation(ref, servers[0], exporter,
                                                prompts))):
            t = time.perf_counter()
            res[key] = fn()
            secs[key] = time.perf_counter() - t
            log(f"[fabric] ({key}) {secs[key]:.1f} s")
        t = time.perf_counter()
        for p in servers:
            stopped[p.label] = p.stop()
        spec8 = fabric_spec(DISAGG_KV_BLOCKS, dict(
            FABRIC_INT8, disaggregation=FABRIC_DISAGG))
        servers8 = [FabricProc("serve_replica", spec8, f"server-{n}8", tmp)
                    for n in ("a", "b")]
        for p in servers8:
            p.listening()
        res["b int8"] = fabric_disagg(ref, servers8, disagg, "int8")
        for p in servers8:
            stopped[p.label] = p.stop()
        secs["b int8"] = time.perf_counter() - t
        log(f"[fabric] (b int8) {secs['b int8']:.1f} s (the servers' stop "
            "and start included)")
        # bf16 weights, fp8 KV: the fp8 pools' payloads cross the wire
        t = time.perf_counter()
        spec_f = fabric_spec(DISAGG_KV_BLOCKS, dict(
            FABRIC_FP8, disaggregation=FABRIC_DISAGG))
        servers_f = [FabricProc("serve_replica", spec_f, f"server-{n}f",
                                tmp) for n in ("a", "b")]
        for p in servers_f:
            p.listening()
        res["b fp8"] = fabric_disagg(ref, servers_f, disagg, "fp8")
        for p in servers_f:
            stopped[p.label] = p.stop()
        secs["b fp8"] = time.perf_counter() - t
        log(f"[fabric] (b fp8) {secs['b fp8']:.1f} s (the servers' stop "
            "and start included)")
    finally:
        for p in FabricProc.started:
            p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    res["e"] = {label: fabric_kernel_lines(lines, label, label.endswith("8"))
                for label, lines in stopped.items()}
    res["split bf16"] = handoff_split(
        res["b bf16"], handoff_lines(stopped["server-a"]),
        handoff_lines(stopped["server-b2"]), "bf16")
    res["split int8"] = handoff_split(
        res["b int8"], handoff_lines(stopped["server-a8"]),
        handoff_lines(stopped["server-b8"]), "int8")
    res["split fp8"] = handoff_split(
        res["b fp8"], handoff_lines(stopped["server-af"]),
        handoff_lines(stopped["server-bf"]), "fp8")
    log("[fabric] seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in secs.items()))
    res["secs"] = secs
    return res


# ------------------------------------------------------------ v1 inference

V1_NEW_TOKENS = 32
V1_WAYS = (("v1 bf16", None), ("v1 int8", 8), ("v1 int4", 4))
V1_LAYERS = 8               # of MISTRAL_7B's 32 (all 32 until PR 18)
# dequantize launches of one forward at MISTRAL_7B: per layer wq, wk, wv,
# wo, w_gate, w_in, w_out and the attention and MLP norm stacks (which the
# quantizer's size rule takes at full width), then lm_head and the gathered
# embedding rows
V1_DEQUANT_PER_FORWARD = 9 * V1_LAYERS + 2
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

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=V1_LAYERS)
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


def micro_step_check(engine, vocab, label="train", tape=None):
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
    10% of the plain version's. A MoE model's routing is recorded in the
    fp32 attention's run and replayed in the other two (``tape``: a list,
    ``moe_tape``)."""
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
    for mode in ("plain_fp32", "kernel", "plain"):
        fa.FORCE_REFERENCE = mode != "kernel"
        if mode == "plain_fp32":
            fa._attention_torch, fa._dq_torch, fa._dkv_torch = map(in_fp32,
                                                                   plain)
        routing = (contextlib.nullcontext() if tape is None
                   else moe_tape(tape, record=mode == "plain_fp32"))
        try:
            with routing:
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
        raise AssertionError(f"[{label}] micro step: loss {res['kernel'][0]} "
                             f"vs plain {res['plain'][0]}")
    parts = []
    for name, gk, gp, g32 in zip(leaves, *(res[m][1] for m in (
            "kernel", "plain", "plain_fp32"))):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"[{label}] micro step: non-finite d{name}")
        top = g32.abs().max()
        d_kp, d_k32, d_p32 = (((a - b).abs().max() / top).item()
                              for a, b in ((gk, gp), (gk, g32), (gp, g32)))
        parts.append(f"{name} {d_kp:.3g} / {d_k32:.3g} / {d_p32:.3g}")
        if d_k32 > MICRO_STEP_TOL or d_kp > 0.1:
            raise AssertionError(
                f"[{label}] micro step: d{name} with the kernels is "
                f"{d_k32:.3g} of its largest entry from the fp32 "
                f"attention's ({MICRO_STEP_TOL} allowed; the plain "
                f"version's: {d_p32:.3g}) and {d_kp:.3g} from the plain "
                f"version's")
    log(f"[{label}] one micro step at T=2048, kernels vs plain attention: "
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


# ------------------------------------------------------------ training state

STATE_LAYERS = 1        # (a), (b), (d): 480 M parameters, 5.8 GB a tag
URGENT_GRACE_S = 30.0   # ResilienceConfig.preempt_grace_s's default


def state_data(n=2):
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    return {"input_ids": np.random.default_rng(0).integers(
        0, MISTRAL_7B.vocab_size, (n, TRAIN_SEQ)).astype(np.int32)}


def state_engine(layers, data, **config):
    """MISTRAL_7B at full width and ``layers`` layers through
    ``initialize`` with the train phase's configuration (seed 0, so every
    engine starts from the same bits)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=layers)
    return deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg), config=dict(TRAIN_CONFIG, **config),
        training_data=data)[0]


def free_engine():
    gc.collect()
    torch.cuda.empty_cache()


def state_bytes(engine):
    """Bytes of a tag: fp32 masters and every moment, 12 a parameter with
    AdamW."""
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves

    return sum(t.numel() * t.element_size() for t in
               tree_leaves(engine.state.params)
               + tree_leaves(engine.state.opt_state.moments))


def ckpt_root(label, need_bytes):
    """A fresh directory under build/ (listed in .gitignore) with
    ``need_bytes`` free on its disk, else the phase fails with both."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt_", dir=os.path.join(here, "build"))
    free = shutil.disk_usage(root).free
    log(f"[{label}] disk: {free / 1e9:.1f} GB free under build/, "
        f"{need_bytes / 1e9:.1f} GB needed")
    if free < need_bytes:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError(f"[{label}] {need_bytes} bytes needed for the "
                             f"checkpoints, {free} free")
    return root


def loader_state(engine):
    return {"dataloader": engine.training_dataloader.state_dict()}


def resume_loader(engine, cs):
    engine.training_dataloader.load_state_dict(cs["dataloader"])
    engine.reset_data_iterator()


def timed_s(fn, *a, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def check_launches(label, micro_steps, layers, remat=False):
    per = micro_steps * layers
    want = {"fwd": per * (2 if remat else 1), "delta": per, "dq": per,
            "dkv": per}
    if dict(fa.launches) != want:
        raise AssertionError(f"[{label}] launches {dict(fa.launches)}, "
                             f"want {want}")
    return want


def params_equal(a_leaves, engine):
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves

    b_leaves = tree_leaves(engine.state.params)
    return [i for i, (a, b) in enumerate(zip(a_leaves, b_leaves, strict=True))
            if not torch.equal(a, b)]


def offline_readers(engine, tag_dir, root):
    """(e) zero_to_fp32 rebuilds every master bit for bit, and
    save_16bit_model writes bf16 members (header ``'<V2'``) whose bits are
    the masters cast to bf16."""
    import zipfile

    from deepspeed_tpu_torch.runtime.checkpointing import _flatten
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint

    t0 = time.perf_counter()
    save_dir, tag = os.path.split(tag_dir)
    state = get_fp32_state_dict_from_zero_checkpoint(save_dir, tag)
    flat = dict(_flatten(engine.state.params))
    if list(state) != list(flat):
        raise AssertionError(f"[train_state e] zero_to_fp32 keys {list(state)}")
    for key, p in flat.items():
        if not torch.equal(torch.from_numpy(state[key]).to(p.device), p):
            raise AssertionError(f"[train_state e] zero_to_fp32 {key} differs")
    del state
    path = engine.save_16bit_model(os.path.join(root, "fp16_export"))
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if names != [k + ".npy" for k in flat]:
            raise AssertionError(f"[train_state e] npz members {names}")
        for key, p in flat.items():
            member = io.BytesIO(zf.read(key + ".npy"))
            np.lib.format.read_magic(member)
            shape, _, _ = np.lib.format.read_array_header_1_0(member)
            head = member.getvalue()[:member.tell()]
            want = p.detach().to(torch.bfloat16).view(torch.int16).cpu()
            if b"'descr': '<V2'" not in head \
                    or tuple(shape) != tuple(p.shape) \
                    or member.read() != want.numpy().tobytes():
                raise AssertionError(f"[train_state e] 16-bit member {key}: "
                                     f"{head!r}")
    gb = os.path.getsize(path) / 1e9
    log(f"[train_state e] zero_to_fp32 rebuilt {len(flat)} leaves bit for bit "
        f"from {tag}; save_16bit_model wrote {gb:.3f} GB of bf16 members "
        f"('<V2' headers) equal to the masters cast to bf16; "
        f"{time.perf_counter() - t0:.1f} s")


def state_resume():
    """(a) 4 steps unbroken; 2 steps, a sync and an async save, a fresh
    engine's load and steps 3-4: losses, counters, lr and every param leaf
    bit-identical. (e) runs on the saved tag."""
    label = "train_state a"
    data = state_data()
    reset_launches()
    a = state_engine(STATE_LAYERS, data)
    want_losses = [float(a.train_batch()) for _ in range(4)]
    want = {"global_steps": a.global_steps, "skipped": a.skipped_steps,
            "lr": a.get_lr(), "device_step": int(a.state.global_step)}
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves

    want_params = [p.detach().clone() for p in tree_leaves(a.state.params)]
    nbytes = state_bytes(a)
    del a
    free_engine()
    root = ckpt_root(label, 2 * nbytes + nbytes // 6)
    out = {"bytes": nbytes}
    try:
        b = state_engine(STATE_LAYERS, data)
        losses = [float(b.train_batch()) for _ in range(2)]
        _, out["save_s"] = timed_s(b.save_checkpoint, root, tag="sync",
                                   client_state=loader_state(b))
        tag_dir, out["async_return_s"] = timed_s(
            b.save_checkpoint, root, tag="async", async_save=True,
            client_state=loader_state(b))
        with open(os.path.join(root, "latest")) as fh:
            before = fh.read()
        if before != "sync" or os.path.exists(os.path.join(tag_dir,
                                                           "manifest.json")):
            raise AssertionError(f"[{label}] the async tag committed before "
                                 f"its wait: latest {before!r}")
        _, out["async_wait_s"] = timed_s(b.wait_pending_checkpoint)
        leaf_mtime = max(os.path.getmtime(os.path.join(d, f))
                         for d, _, fs in os.walk(tag_dir) for f in fs
                         if f.endswith(".npy"))
        latest = os.path.join(root, "latest")
        if open(latest).read() != "async" \
                or os.path.getmtime(latest) < leaf_mtime:
            raise AssertionError(f"[{label}] latest not written after the "
                                 "async tag's leaves")
        t = time.perf_counter()
        offline_readers(b, tag_dir, root)
        out["offline_s"] = time.perf_counter() - t
        del b
        free_engine()
        c = state_engine(STATE_LAYERS, data)
        (_, cs), out["load_s"] = timed_s(c.load_checkpoint, root)
        resume_loader(c, cs)
        losses += [float(c.train_batch()) for _ in range(2)]
        got = {"global_steps": c.global_steps, "skipped": c.skipped_steps,
               "lr": c.get_lr(), "device_step": int(c.state.global_step)}
        bad = params_equal(want_params, c)
        if losses != want_losses or got != want or bad:
            raise AssertionError(
                f"[{label}] resumed run {losses} {got} vs unbroken "
                f"{want_losses} {want}; param leaves differing: {bad}")
        launches = check_launches(label, 8 * 2, STATE_LAYERS)
        del c
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_engine()
    gb = nbytes / 1e9
    log(f"[{label}] MISTRAL_7B widths, {STATE_LAYERS} layers, bf16: losses "
        f"{[round(x, 6) for x in losses]} after a save at step 2 and a "
        f"fresh engine's load are bit-identical to the unbroken run's, as "
        f"are global_steps {got['global_steps']}, skipped "
        f"{got['skipped']}, lr {got['lr'][0]:.6g} and all "
        f"{len(want_params)} param leaves; a tag holds {gb:.3f} GB; sync "
        f"save {out['save_s']:.2f} s ({gb / out['save_s']:.2f} GB/s), "
        f"async save returned in {out['async_return_s']:.2f} s and "
        f"committed {out['async_wait_s']:.2f} s later, load "
        f"{out['load_s']:.2f} s ({gb / out['load_s']:.2f} GB/s); latest "
        f"written after the tag's leaves; launches {json.dumps(launches)} "
        f"for 8 steps")
    return out


def join_abandoned_workers(timeout=120.0):
    """A wedged step's worker wakes after its slow step, finds itself
    superseded and exits: wait for it, so that no training thread runs
    into a later phase."""
    for t in threading.enumerate():
        if t.name == "train-supervised-loop":
            t.join(timeout)
            if t.is_alive():
                raise AssertionError("[train_state b] an abandoned training "
                                     f"worker still runs after {timeout} s")


# A fault fires at the first step boundary at or past its at_step: the
# three poisoned steps follow the boundaries at 6, 7 and 8, so the wedge
# sits at 9, which is reached only after the rollback to global_step6.
STATE_FAULTS = [
    {"kind": "crash", "at_step": 3},
    {"kind": "sigterm", "at_step": 5},
    {"kind": "nan_grads", "at_step": 6, "count": 3},
    {"kind": "slow_step", "at_step": 9, "duration_s": 10.0},
]
STATE_STEPS = 10


def latest_only_journal(save_dir):
    """An ops journal that, once a checkpoint is published, deletes every
    other tag under ``save_dir``: a restart or rollback reads only
    ``latest``, and a one-layer tag holds 5.8 GB."""
    from deepspeed_tpu_torch.telemetry.journal import OpsJournal

    class LatestOnly(OpsJournal):
        def emit(self, kind, **detail):
            event = super().emit(kind, **detail)
            if kind == "checkpoint_saved":
                with open(os.path.join(save_dir, "latest")) as fh:
                    keep = fh.read().strip()
                for name in os.listdir(save_dir):
                    path = os.path.join(save_dir, name)
                    if name != keep and os.path.isdir(path):
                        shutil.rmtree(path)
            return event

    return LatestOnly(capacity=512, source="training")


def state_supervisor():
    """(b) TrainingSupervisor over a seeded fault schedule at one layer:
    a crash, a SIGTERM (then run() again), three NaN-gradient steps in a
    row (a rollback) and a wedged step (a fresh engine from the factory);
    the loss curve equals the unbroken run's bit for bit."""
    from deepspeed_tpu_torch.runtime.resilience import TrainingSupervisor

    label = "train_state b"
    data = state_data()
    reset_launches()
    ref = state_engine(STATE_LAYERS, data)
    ref_losses = {}
    while ref.global_steps < STATE_STEPS:
        loss = float(ref.train_batch())
        ref_losses[ref.global_steps] = loss
    nbytes = state_bytes(ref)
    del ref
    free_engine()
    root = ckpt_root(label, 2 * nbytes + nbytes // 6)
    res = {"enabled": True, "save_dir": root, "save_interval_steps": 2,
           "restart_backoff_s": 0.05, "restart_backoff_jitter": 0.0,
           "max_consecutive_anomalies": 3, "max_restarts_in_window": 8,
           "watchdog_enabled": True, "step_timeout_s": 6.0,
           "watchdog_poll_s": 0.1,
           "faults": {"enabled": True, "seed": 0, "schedule": STATE_FAULTS}}

    def factory():
        return state_engine(STATE_LAYERS, data, resilience=res)

    t0 = time.perf_counter()
    try:
        sup = TrainingSupervisor(engine=factory(), engine_factory=factory,
                                 journal=latest_only_journal(root))
        grace = sup.config.preempt_grace_s
        first = sup.run(STATE_STEPS)
        if first["status"] != "preempted" or first["completed_steps"] != 5:
            raise AssertionError(f"[{label}] first run {first}")
        r = sup.run(STATE_STEPS)
        join_abandoned_workers()
        wall = time.perf_counter() - t0
        got = sup.losses_by_step()
        kinds = [e["kind"] for e in sup.journal.events()]
        reasons = [x["reason"] for x in r["restart_log"]]
        if r["status"] != "completed" or got != ref_losses:
            raise AssertionError(f"[{label}] {r['status']}: losses {got} vs "
                                 f"the unbroken run's {ref_losses}")
        if reasons != ["crash", "anomaly", "wedge"] or r["wedges"] != 1 \
                or r["anomaly_rollbacks"] != 1 or r["preemptions"] != 1:
            raise AssertionError(f"[{label}] restarts {reasons}, {r}")
        for kind in ("checkpoint_saved", "train_preempt_save", "train_wedge",
                     "train_restart", "train_anomaly_rollback"):
            if kind not in kinds:
                raise AssertionError(f"[{label}] no {kind} in {kinds}")
        calls = STATE_STEPS + len(sup.loss_log) + 1   # + the wedged worker's
        launches = check_launches(label, calls * 2, STATE_LAYERS)
        urgent = first["urgent_save_s"]
        del sup
    finally:
        join_abandoned_workers()
        shutil.rmtree(root, ignore_errors=True)
        free_engine()
    log(f"[{label}] supervisor over crash@3, sigterm@5 (then run() again), "
        f"nan_grads@6 x3, slow_step@9 (wedged past 6 s): losses_by_step "
        f"equal the unbroken run's bit for bit over {STATE_STEPS} steps; "
        f"restarts {reasons}, train_restarts {r['train_restarts']}, "
        f"steps_lost {r['steps_lost']}, anomaly_rollbacks "
        f"{r['anomaly_rollbacks']}, wedges {r['wedges']}; urgent_save_s "
        f"{urgent:.2f} against preempt_grace_s {grace:.0f}; journal {kinds.count('checkpoint_saved')} "
        f"checkpoint_saved, {kinds.count('train_restart')} train_restart; "
        f"launches {json.dumps(launches)} ({calls} train_batch calls); "
        f"{wall:.1f} s")
    return {"urgent_save_s": urgent, "restarts": r["train_restarts"],
            "steps_lost": r["steps_lost"], "wall_s": wall}


def rss_bytes():
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def peak_rss_during(fn, *a, **kw):
    """(fn's result, the highest resident set seen while it ran less the
    one before, sampled every 5 ms)."""
    base = rss_bytes()
    peak = [base]
    done = threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], rss_bytes())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        out = fn(*a, **kw)
    finally:
        done.set()
        t.join(5.0)
    return out, max(peak[0], rss_bytes()) - base


URGENT_LAYERS = 2       # 8 (TRAIN_LAYERS) until PR 18


def state_urgent():
    """(c) The train phase's configuration at URGENT_LAYERS layers: 2 steps,
    an urgent save, step 3; a fresh engine loads the save and its step 3
    loss is bit-identical."""
    label = "train_state c"
    data = state_data()
    reset_launches()
    e = state_engine(URGENT_LAYERS, data)
    for _ in range(2):
        e.train_batch()
    nbytes = state_bytes(e)
    root = ckpt_root(label, nbytes + nbytes // 6)
    try:
        _, rss = peak_rss_during(e.save_checkpoint, root, urgent=True,
                                 client_state=loader_state(e))
        urgent_s = e.last_urgent_save_s
        want = float(e.train_batch())
        del e
        free_engine()
        f = state_engine(URGENT_LAYERS, data)
        (_, cs), load_s = timed_s(f.load_checkpoint, root)
        resume_loader(f, cs)
        got = float(f.train_batch())
        if got != want:
            raise AssertionError(f"[{label}] step 3 after the load: loss "
                                 f"{got} vs {want}")
        launches = check_launches(label, 4 * 2, URGENT_LAYERS)
        del f
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_engine()
    gb = nbytes / 1e9
    log(f"[{label}] {URGENT_LAYERS} layers: urgent save of {gb:.3f} GB in "
        f"{urgent_s:.2f} s ({gb / urgent_s:.2f} GB/s) against the "
        f"{URGENT_GRACE_S:.0f} s default grace "
        f"({'within' if urgent_s <= URGENT_GRACE_S else 'OVER'}); host RAM "
        f"of the snapshot (peak resident set above the start) "
        f"{rss / 1e9:.3f} GB; load {load_s:.2f} s ({gb / load_s:.2f} GB/s); "
        f"step 3's loss {got:.6f} equals the uninterrupted engine's; "
        f"launches {json.dumps(launches)}")
    return {"urgent_save_s": urgent_s, "load_s": load_s, "rss": rss,
            "bytes": nbytes}


def state_remat():
    """(d) One micro step (forward and backward from a zero accumulator)
    with remat off, nothing_saveable and dots_saveable at one layer, twice
    each: the loss and every gradient leaf bit-identical to remat off's
    first, the forward launched twice a layer under both policies."""
    from deepspeed_tpu_torch.models.transformer import CausalLM
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves

    label = "train_state d"
    data = state_data(1)
    engine = state_engine(STATE_LAYERS, data)
    batch = {"input_ids": data["input_ids"]}
    base_cfg = engine.module.cfg
    ref = None
    out = {}
    # two rounds: the first call of a policy pays its one-time set-up, so
    # the second round's seconds are the ones reported
    for rnd in range(2):
        for mode in (None, "nothing_saveable", "dots_saveable"):
            engine.module = CausalLM(dataclasses.replace(
                base_cfg, remat=mode is not None, remat_policy=mode))
            for g in tree_leaves(engine.state.grad_acc):
                g.zero_()
            reset_launches()
            free_engine()
            torch.cuda.reset_peak_memory_stats()
            loss, secs = timed_s(engine.forward, batch)
            grads = tree_leaves(engine.state.grad_acc)
            peak = torch.cuda.max_memory_allocated() / 1e9
            check_launches(f"{label} {mode}", 1, STATE_LAYERS,
                           remat=mode is not None)
            if ref is None:
                ref = (float(loss), [g.clone() for g in grads])
            else:
                bad = [i for i, (a, b) in enumerate(zip(ref[1], grads))
                       if not torch.equal(a, b)]
                if float(loss) != ref[0] or bad:
                    raise AssertionError(
                        f"[{label}] {mode}: loss {float(loss)} vs {ref[0]}, "
                        f"gradient leaves differing {bad}")
            row = out.setdefault(str(mode), {"first_s": secs})
            row.update(peak_gb=peak, step_s=secs)
    del engine, ref
    free_engine()
    log(f"[{label}] one micro step at {STATE_LAYERS} layers, T = "
        f"{TRAIN_SEQ - 1}: loss and every gradient leaf bit-identical under "
        f"nothing_saveable and dots_saveable; forward launched 2 x "
        f"{STATE_LAYERS} under both; peak GB / seconds (first call's): "
        + ", ".join(f"{k} {v['peak_gb']:.2f} / {v['step_s']:.3f} "
                    f"({v['first_s']:.3f})" for k, v in out.items()))
    return out


def phase_train_state():
    secs = {}
    out = {}
    for name, fn in (("a+e", state_resume), ("b", state_supervisor),
                     ("c", state_urgent), ("d", state_remat)):
        t = time.perf_counter()
        out[name] = fn()
        secs[name] = round(time.perf_counter() - t, 1)
        log(f"[train_state] sub-phase {name}: {secs[name]} s")
    out["secs"] = secs
    return out


# ------------------------------------------------------------------ offload

OFFLOAD_SEQ = 4097          # 1 x 4096 tokens after the shift
OFFLOAD_LAYERS = 32         # the headline: all of MISTRAL_7B
OFFLOAD_STEPS = 2
# JAX's test_offload_matches_device_update holds the offloaded AdamW to the
# device update within this (relative and absolute)
OFFLOAD_TOL = 2e-4
# the streamed loss against the whole-model loss, relative: the same ops in
# the same order, so equal up to a reduction's order
INFINITY_TOL = 1e-4
ADAM_BYTES = 28             # an AdamW element: grad, master, m, v read;
#                             master, m, v written (fp32)
HOST_MARGIN = 8e9           # host RAM left free beside the offloaded state
DEVICE_BUDGET = 76e9        # of the card's 80 GB
OFFLOAD_CONFIG = {
    "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                              "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-5,
                                                 "warmup_max_lr": 1e-4,
                                                 "warmup_num_steps": 2}},
    "gradient_clipping": 1.0,
    "steps_per_print": 1000,
    "seed": 0,
}


def meminfo():
    out = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, value = line.split(":", 1)
            out[key] = int(value.split()[0]) * 1024
    return out


def omp_threads():
    """The OpenMP team size the host optimizer's loops get."""
    import ctypes

    try:
        return ctypes.CDLL("libgomp.so.1").omp_get_max_threads()
    except OSError:
        return None


def offload_batches(n):
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    ids = np.random.default_rng(0).integers(
        0, MISTRAL_7B.vocab_size, (n, OFFLOAD_SEQ)).astype(np.int32)
    return [{"input_ids": torch.from_numpy(ids[j:j + 1])} for j in range(n)]


def offload_engine(layers, offload=None, remat=None):
    """MISTRAL_7B at full width and ``layers`` layers through
    ``initialize``, seed 0; ZeRO-Offload (stage 2, page-locked masters)
    when ``offload`` is given."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    cfg = dataclasses.replace(MISTRAL_7B, num_layers=layers,
                              remat=remat is not None, remat_policy=remat)
    config = copy.deepcopy(OFFLOAD_CONFIG)
    if offload is not None:
        config["zero_optimization"] = {
            "stage": 2, "offload_optimizer": dict(offload, pin_memory=True)}
    return deepspeed_tpu_torch.initialize(model=CausalLM(cfg),
                                          config=config)[0]


def offload_step(engine, batch):
    """One optimizer step through forward / backward / step, synchronized:
    (loss, forward + backward seconds, update seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = engine.forward(batch)
    engine.backward(loss)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    return float(loss), t1 - t0, time.perf_counter() - t1


def masters_off_device(engine):
    """Offloaded leaves whose device params differ in any bit from the
    host masters, compared a piece at a time on the card."""
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    from deepspeed_tpu_torch.runtime.engine import PIECE_ELEMS

    plan = engine._offload_plan
    leaves = tree_leaves(engine.state.params)
    bad = []
    for i in plan.offloaded:
        dev = leaves[i].detach().view(-1)
        host = plan.master_tensors[i].view(-1)
        for lo in range(0, dev.numel(), PIECE_ELEMS):
            hi = min(lo + PIECE_ELEMS, dev.numel())
            if not torch.equal(dev[lo:hi], host[lo:hi].to(dev.device)):
                bad.append(i)
                break
    return bad


def split_line(t, fb, up):
    """A step's seconds and rates from ``engine.offload_timings``."""
    n = t["elements"]
    swap = (f", moment files read and written {t['swap_s']:.3f} s"
            if t["swap_s"] > 0.01 else "")
    return (f"fwd+bwd {fb:.3f} s, update {up:.3f} s (host part "
            f"{t['wall_s']:.3f} s: grads to host {t['d2h_s']:.3f} s = "
            f"{4 * n / t['d2h_s'] / 1e9:.1f} GB/s, host AdamW "
            f"{t['adam_s']:.3f} s = {ADAM_BYTES * n / t['adam_s'] / 1e9:.1f} "
            f"GB/s of state touched{swap}, masters to device "
            f"{t['h2d_s']:.3f} s = {4 * n / t['h2d_s'] / 1e9:.1f} GB/s)")


def close_engine(engine):
    engine.close()
    del engine
    free_engine()


def host_adam_rate(opt):
    """GB/s of state touched by the host AdamW alone on one staging
    piece (the main thread, no transfers), the best of 3."""
    from deepspeed_tpu_torch.runtime.engine import PIECE_ELEMS

    rng = np.random.default_rng(0)
    p = rng.standard_normal(PIECE_ELEMS, dtype=np.float32)
    g = rng.standard_normal(PIECE_ELEMS, dtype=np.float32)
    state = opt.init_state(p)
    for arr in state.values():
        arr[...] = 0.0          # first touch outside the timing
    best = math.inf
    for _ in range(3):
        t = time.perf_counter()
        opt.step(p, g, state)
        best = min(best, time.perf_counter() - t)
    return ADAM_BYTES * PIECE_ELEMS / best / 1e9


def offload_parity():
    """(a) 2 layers, 4 steps of one 4096-token sequence each: offload_optimizer
    cpu at ratio 1.0 against the on-device engine from the same seed."""
    label = "offload a"
    batches = offload_batches(4)
    dev = offload_engine(2)
    dev_losses = [offload_step(dev, b)[0] for b in batches]
    del dev
    free_engine()
    eng = offload_engine(2, offload={"device": "cpu", "ratio": 1.0})
    plan = eng._offload_plan
    if not plan.cpu_opt.has_native:
        raise AssertionError(f"[{label}] the C++ host optimizer is not loaded")
    mem = meminfo()
    rate = host_adam_rate(plan.cpu_opt)
    log(f"[{label}] host: has_native {plan.cpu_opt.has_native}, "
        f"os.cpu_count() {os.cpu_count()}, OpenMP threads {omp_threads()}, "
        f"MemTotal {mem['MemTotal'] / 1e9:.1f} GB, MemAvailable "
        f"{mem['MemAvailable'] / 1e9:.1f} GB; the host AdamW alone "
        f"{rate:.1f} GB/s of state touched; {len(plan.offloaded)} of "
        f"{len(plan.offloaded) + len(plan.kept)} leaves offloaded")
    reset_launches()
    losses = []
    for step, b in enumerate(batches):
        loss, fb, up = offload_step(eng, b)
        bad = masters_off_device(eng)
        if bad:
            raise AssertionError(f"[{label}] step {step + 1}: device params "
                                 f"of leaves {bad} differ from the masters")
        losses.append(loss)
        log(f"[{label}] step {step + 1}: loss {loss:.6f} (on-device engine "
            f"{dev_losses[step]:.6f}); {split_line(eng.offload_timings, fb, up)}")
    check_launches(label, len(batches), 2)
    gaps = [abs(a - b) for a, b in zip(losses, dev_losses)]
    if any(g > OFFLOAD_TOL * (1 + abs(b)) for g, b in zip(gaps, dev_losses)):
        raise AssertionError(f"[{label}] losses {losses} vs the on-device "
                             f"engine's {dev_losses}")
    log(f"[{label}] losses agree with the on-device engine's to "
        f"{max(gaps):.3g} ({OFFLOAD_TOL} relative and absolute allowed); "
        f"device params equal the host masters bit for bit after each "
        f"copy-back")
    close_engine(eng)
    return {"losses": losses, "device_losses": dev_losses, "gap": max(gaps),
            "adam_alone_gbs": rate}


def twin_flow_bytes(layers, ratio):
    """(offloaded fp32 bytes, all fp32 bytes, the largest kept leaf's
    bytes) of the plan's largest-first pick at ``ratio``."""
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM
    from deepspeed_tpu_torch.runtime.checkpointing import param_template
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves

    sizes = sorted((4 * t.numel() for t in tree_leaves(param_template(
        CausalLM(dataclasses.replace(MISTRAL_7B, num_layers=layers))))),
        reverse=True)
    total, acc, n = sum(sizes), 0, 0
    for s in sizes:
        if acc >= ratio * total:
            break
        acc += s
        n += 1
    return acc, total, sizes[n] if n < len(sizes) else 0


def release_host_memory():
    """Hand the host memory this process has freed back to the system:
    torch's cache of page-locked blocks and glibc's free heap."""
    import ctypes

    gc.collect()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def offload_choice(layers):
    """Host RAM moments at the largest ``ratio`` whose offloaded masters
    and moments leave HOST_MARGIN of MemAvailable and whose kept leaves
    fit the card (their moments, and the device AdamW's temporaries: six
    copies of the largest kept leaf); else the moments on NVMe at ratio
    1.0."""
    from deepspeed_tpu_torch.runtime.engine import PIECE_ELEMS

    avail = meminfo()["MemAvailable"]
    staging = 2 * 4 * PIECE_ELEMS
    for ratio in (1.0, 0.9, 0.8):
        off, total, largest_kept = twin_flow_bytes(layers, ratio)
        host = 3 * off + staging
        device = 2 * total + 2 * (total - off) + 6 * largest_kept + 5e9
        log(f"[offload b] ratio {ratio}: host RAM moments need {host / 1e9:.1f}"
            f" GB + {HOST_MARGIN / 1e9:.0f} GB margin of {avail / 1e9:.1f} GB "
            f"available; the card {device / 1e9:.1f} GB (params, "
            f"accumulator, kept moments, the kept leaves' update, ~5 GB of "
            f"activations)")
        if host + HOST_MARGIN <= avail and device <= DEVICE_BUDGET:
            return {"device": "cpu", "ratio": ratio}
    return {"device": "nvme", "ratio": 1.0}


def offload_headline():
    """(b) MISTRAL_7B at all 32 layers under ZeRO-Offload: AdamW,
    nothing_saveable remat, 1 x 4096 tokens, OFFLOAD_STEPS steps."""
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    label = "offload b"
    n = dataclasses.replace(MISTRAL_7B, num_layers=OFFLOAD_LAYERS).num_params()
    log(f"[{label}] reckoning: {n / 1e9:.3f} B parameters; the card holds "
        f"fp32 params {4 * n / 1e9:.2f} GB + the fp32 accumulator "
        f"{4 * n / 1e9:.2f} GB + activations under remat (~5 GB at T = "
        f"{OFFLOAD_SEQ - 1}); the host fp32 masters {4 * n / 1e9:.2f} GB + "
        f"two moments {8 * n / 1e9:.2f} GB")
    release_host_memory()
    choice = offload_choice(OFFLOAD_LAYERS)
    root = None
    if choice["device"] == "nvme":
        root = ckpt_root(label, int(8.4 * n))
        choice["nvme_path"] = root
    log(f"[{label}] chosen: moments on {choice['device']}, ratio "
        f"{choice['ratio']}")
    batch = offload_batches(1)[0]
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = offload_engine(OFFLOAD_LAYERS, offload=choice,
                             remat="nothing_saveable")
        plan = eng._offload_plan
        log(f"[{label}] built in {time.perf_counter() - t0:.1f} s: "
            f"{len(plan.offloaded)} of {len(plan.offloaded) + len(plan.kept)}"
            f" leaves offloaded, host RSS {rss_bytes() / 1e9:.1f} GB, device "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        reset_launches()
        losses, steps, rss_peak = [], [], rss_bytes()
        for step in range(OFFLOAD_STEPS):
            before = rss_bytes()
            (loss, fb, up), grew = peak_rss_during(offload_step, eng, batch)
            rss_peak = max(rss_peak, before + grew)
            t = dict(eng.offload_timings)
            losses.append(loss)
            steps.append({"loss": loss, "fwd_bwd_s": fb, "update_s": up,
                          "step_s": fb + up, **t, "rss_gb": rss_bytes() / 1e9})
            log(f"[{label}] step {step + 1}: loss {loss:.6f}, "
                f"{fb + up:.2f} s: {split_line(t, fb, up)}; host RSS "
                f"{rss_bytes() / 1e9:.1f} GB")
        launches = dict(fa.launches)
        check_launches(label, OFFLOAD_STEPS, OFFLOAD_LAYERS, remat=True)
        peak = torch.cuda.max_memory_allocated() / 1e9
        bad = masters_off_device(eng)
        first = math.log(MISTRAL_7B.vocab_size) \
            + MISTRAL_7B.hidden_size * 0.02 ** 2 / 2
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0] \
                or abs(losses[0] - first) > 0.05:
            raise AssertionError(f"[{label}] losses {losses} (the first within "
                                 f"0.05 of {first:.3f}, then falling)")
        if bad or eng.skipped_steps or int(eng.state.global_step) != \
                OFFLOAD_STEPS:
            raise AssertionError(f"[{label}] leaves {bad} differ from the "
                                 f"masters; {eng.skipped_steps} skipped")
        log(f"[{label}] MISTRAL_7B, 32 layers, {n / 1e9:.3f} B parameters: "
            f"losses {[round(x, 6) for x in losses]}, peak device memory "
            f"{peak:.2f} GB, host RSS at most {rss_peak / 1e9:.1f} GB; "
            f"launches {json.dumps(launches)} (asserted: 64 forward, 32 dq "
            f"and 32 dkv a micro step under remat)")
        close_engine(eng)
    finally:
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
    return {"choice": {k: v for k, v in choice.items() if k != "nvme_path"},
            "losses": losses, "steps": steps, "peak_gb": peak,
            "peak_rss_gb": rss_peak / 1e9, "launches": launches,
            "params": n}


TWIN_FLOW_STEPS = 2    # 3 until PR 18


def offload_twin_flow(device_losses):
    """(c) Twin-Flow at ratio 0.5 with the moments on NVMe, 2 layers, the
    first TWIN_FLOW_STEPS of (a)'s batches: the losses within OFFLOAD_TOL
    of (a)'s on-device engine."""
    from deepspeed_tpu_torch.runtime.engine import _paths

    label = "offload c"
    off = twin_flow_bytes(2, 0.5)[0]
    root = ckpt_root(label, int(2.2 * off))
    try:
        eng = offload_engine(2, offload={"device": "nvme", "ratio": 0.5,
                                         "nvme_path": root})
        plan = eng._offload_plan
        names = [".".join(p) for p, _ in _paths(eng.state.params)]
        reset_launches()
        losses, secs = [], []
        for b in offload_batches(TWIN_FLOW_STEPS):
            loss, fb, up = offload_step(eng, b)
            losses.append(loss)
            secs.append(fb + up)
            log(f"[{label}] loss {loss:.6f}: {split_line(eng.offload_timings, fb, up)}")
        check_launches(label, TWIN_FLOW_STEPS, 2)
        disk = sum(os.path.getsize(os.path.join(root, f))
                   for f in os.listdir(root))
        bad = masters_off_device(eng)
        gaps = [abs(a - b) for a, b in zip(losses, device_losses)]
        if bad or any(g > OFFLOAD_TOL * (1 + abs(b))
                      for g, b in zip(gaps, device_losses)):
            raise AssertionError(f"[{label}] losses {losses} vs the on-device"
                                 f" engine's {device_losses}; leaves "
                                 f"{bad} differ from the masters")
        kept = [names[i] for i in plan.kept]
        log(f"[{label}] ratio 0.5, moments on NVMe: offloaded "
            f"{[names[i] for i in plan.offloaded]}, kept on the device "
            f"{kept}; {disk / 1e9:.3f} GB of moment files; step seconds "
            f"{[round(s, 3) for s in secs]}; losses within {max(gaps):.3g} "
            f"of the on-device engine's")
        close_engine(eng)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"kept": kept, "disk_gb": disk / 1e9, "step_s": secs,
            "losses": losses}


INFINITY_LAYERS = 2
INFINITY_GROUP = 1         # the engine's default group, ceil(L / 4) (2 at 8 layers)


def offload_infinity(device, steps, whole=None):
    """(d) ZeRO-Infinity: MISTRAL_7B at INFINITY_LAYERS layers in groups of
    INFINITY_GROUP, the
    params, moments and accumulators in host RAM or in files, ``steps``
    steps on one sequence. The first streamed loss is held to the whole
    model's ``CausalLM.loss`` on the gathered params, computed here unless
    ``whole`` hands it over (the store is drawn from the same seed, so
    every cell's params are the same bits)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM
    from deepspeed_tpu_torch.models.weights import params_from_numpy
    from deepspeed_tpu_torch.runtime import zero_infinity

    label = f"offload d {device}"
    cfg = dataclasses.replace(MISTRAL_7B, num_layers=INFINITY_LAYERS)
    n = cfg.num_params()
    root = ckpt_root(label, int(12.5 * n)) if device == "nvme" else None
    config = {"train_micro_batch_size_per_gpu": 1,
              "optimizer": {"type": "AdamW", "params": {
                  "lr": 1e-4, "weight_decay": 0.01}},
              "zero_optimization": {"stage": 3, "offload_param": {
                  "device": device, "nvme_path": root}},
              "seed": 0}
    batch = {"input_ids": offload_batches(1)[0]["input_ids"].numpy()}
    try:
        t0 = time.perf_counter()
        eng, *rest = deepspeed_tpu_torch.initialize(model=CausalLM(cfg),
                                                    config=config)
        if not isinstance(eng, zero_infinity.ZeroInfinityEngine) or any(rest):
            raise AssertionError(f"[{label}] initialize built {eng}")
        init_s = time.perf_counter() - t0
        if eng.group_layers != INFINITY_GROUP:
            raise AssertionError(f"[{label}] groups of {eng.group_layers}")
        if whole is None:
            params = params_from_numpy(eng.gather_params(), "cuda")
            with torch.no_grad():
                whole = float(CausalLM(cfg).loss(params, {
                    "input_ids": torch.as_tensor(batch["input_ids"]).cuda()}))
            del params
            free_engine()
        read0 = eng.store.bytes_read
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses, secs = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(eng.train_batch(dict(batch)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        per = steps * INFINITY_LAYERS
        want = {"fwd": 2 * per, "delta": per, "dq": per, "dkv": per}
        launches = dict(fa.launches)
        rep = eng.streaming_report()
        read = (eng.store.bytes_read - read0) // steps
        groups = rep["groups"]
        group_bytes = (rep["param_bytes"] - rep["edge_bytes"]) // groups
        budget = 2 * group_bytes + rep["edge_bytes"] + (groups + 1) * (
            OFFLOAD_SEQ - 1) * cfg.hidden_size * 2
        gap = abs(losses[0] - whole)
        if launches != want:
            raise AssertionError(f"[{label}] launches {launches}, want {want}")
        if gap > INFINITY_TOL * abs(whole) or not all(np.isfinite(losses)) \
                or (steps > 1 and not losses[-1] < losses[0]):
            raise AssertionError(f"[{label}] streamed losses {losses}, the "
                                 f"whole model's {whole}")
        if read != rep["expected_bytes_per_step"]:
            raise AssertionError(f"[{label}] {read} bytes read a step, "
                                 f"{rep['expected_bytes_per_step']} expected")
        log(f"[{label}] {INFINITY_LAYERS} layers in {groups} groups of "
            f"{INFINITY_GROUP}, {rep['param_bytes'] / 1e9:.2f} GB of fp32 "
            f"params on {device}: built in {init_s:.1f} s; streamed losses "
            f"{[round(x, 6) for x in losses]}, the first against the whole "
            f"model's {whole:.6f} (|diff| {gap:.3g}, {INFINITY_TOL} relative "
            f"allowed); {read / 1e9:.2f} GB read a step = expected "
            f"{rep['expected_bytes_per_step'] / 1e9:.2f} GB; peak device "
            f"memory {peak / 1e9:.2f} GB against the budget of two groups + "
            f"edges + boundaries {budget / 1e9:.2f} GB (the whole model "
            f"{rep['param_bytes'] / 1e9:.2f} GB); step seconds "
            f"{[round(s, 2) for s in secs]}; launches {json.dumps(launches)}")
        eng.close()
        del eng
        free_engine()
    finally:
        if root is not None:
            shutil.rmtree(root, ignore_errors=True)
    return {"losses": losses, "whole": whole, "step_s": secs,
            "read_per_step": read, "expected": rep["expected_bytes_per_step"],
            "peak_gb": peak / 1e9, "budget_gb": budget / 1e9,
            "init_s": init_s, "launches": launches}


def phase_offload():
    secs = {}
    out = {}
    for name, fn in (("a", offload_parity), ("b", offload_headline),
                     ("c", lambda: offload_twin_flow(
                         out["a"]["device_losses"])),
                     ("d cpu", lambda: offload_infinity("cpu", 2)),
                     # one step: a file-store step costs 3x a host-RAM one
                     ("d nvme", lambda: offload_infinity(
                         "nvme", 1, out["d cpu"]["whole"]))):
        t = time.perf_counter()
        out[name] = fn()
        secs[name] = round(time.perf_counter() - t, 1)
        log(f"[offload] sub-phase {name}: {secs[name]} s")
    out["secs"] = secs
    return out


OFFLOAD_CHILD_S = 900       # the phase took 188-283 s on the card


def phase_offload_apart():
    """The offload phase in a child process of this script
    (``--offload-result PATH``), which inherits stdout and writes the
    phase's result as JSON. The 32-layer cell holds most of the host's RAM
    and registers it page-locked; a process that exits hands all of it
    back, so the phases after this one start from the host as it was."""
    gc.collect()
    torch.cuda.empty_cache()
    fd, path = tempfile.mkstemp(prefix="offload_", suffix=".json")
    os.close(fd)
    try:
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--offload-result", path], cwd=REPO, check=True,
                       timeout=OFFLOAD_CHILD_S)
        with open(path) as fh:
            return json.load(fh)
    finally:
        os.unlink(path)


# ------------------------------------------------------------------- MoE

# MISTRAL_7B's widths with Mixtral-8x7B's expert count and top-2 routing at
# the JAX defaults (capacity factor 1.25, min capacity 4). Serving at
# SERVE_LAYERS layers: 11.9 B parameters, 23.7 GB of bf16 weights (all 32
# layers would be 93 GB); training at 1 layer: 1.7 B parameters, 27 GB of
# fp32 master, moments and accumulator.
MOE_EXPERTS = 8
MOE_LAYERS = SERVE_LAYERS
MOE_KV_BLOCKS = 1024
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_SEQ = 4097
MOE_TRAIN_STEPS = 3


def moe_cfg(layers, **kw):
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    kw = {"moe_top_k": 2, **kw}
    return dataclasses.replace(MISTRAL_7B, num_layers=layers,
                               moe_num_experts=MOE_EXPERTS, **kw)


@contextlib.contextmanager
def moe_tape(tape, record):
    """Top-2 routing recorded into ``tape`` (``record``) or replayed from it:
    a replayed call's first expert is raised just above the token's largest
    logit where another one leads (a change as small as the gap it closes),
    and its second expert is chosen through the gate's ``noise``, which
    moves no gate value. So the three runs of a comparison route every
    token alike, and the kernels are held against the plain versions
    without routing flips between them (a flip moves a token's output by
    O(1), which no attention tolerance bounds)."""
    import deepspeed_tpu_torch.models.transformer as tt

    real = tt.top2gating
    calls = iter(range(1 << 30))

    def gate(logits, cf, min_cap, noise=None, group=None):
        i = next(calls)
        E = logits.shape[-1]
        if record:
            idx1 = torch.argmax(torch.softmax(logits.detach(), -1), -1)
            no1 = logits.detach().scatter(-1, idx1[:, None], -math.inf)
            tape.append((idx1, torch.argmax(no1, -1)))
            return real(logits, cf, min_cap, noise=noise, group=group)
        idx1, idx2 = tape[i]
        lead = torch.argmax(torch.softmax(logits.detach(), -1), -1)
        wrong = lead != idx1
        if bool(wrong.any()):
            top = logits.detach().max(-1).values
            bump = torch.zeros_like(logits.detach())
            rows = wrong.nonzero()[:, 0]
            bump[rows, idx1[rows]] = (top[rows] - logits.detach()[
                rows, idx1[rows]] + 1e-3)
            logits = logits + bump
        force = torch.nn.functional.one_hot(idx2, E).float() * 1e4
        return real(logits, cf, min_cap, noise=force, group=group)

    tt.top2gating = gate
    try:
        yield
    finally:
        tt.top2gating = real


def moe_step_logits(engine, chunks, tapes, step, mode):
    """``step_logits`` of a MoE engine, with the routing of the fp32
    attention's run (made first) replayed in the others."""
    tape = tapes.setdefault(step, [])
    with moe_tape(tape, record=mode == "plain_fp32"):
        return step_logits(engine, chunks, step, mode)


@contextlib.contextmanager
def moe_group_sizes(record):
    """Each dropless layer's host read of its group sizes: (sizes, seconds
    of the ``tolist``, which waits for the queued work before it)."""
    from deepspeed_tpu_torch.moe import grouped

    real = grouped._host_sizes

    def host_sizes(gs):
        t = time.perf_counter()
        out = real(gs)
        record.append((out, time.perf_counter() - t))
        return out

    grouped._host_sizes = host_sizes
    try:
        yield
    finally:
        grouped._host_sizes = real


def moe_serve(label, cfg, params, quant=None, steps=True):
    """One v2 engine over the shared MoE tree (the expert stacks are never
    quantized, so only the attention and lm_head get nodes of their own):
    MAIN_PROMPT_LENS x MAIN_NEW_TOKENS greedy through the scheduler, the
    launch counts checked, and (``steps``) one prefill and one decode step
    held against the plain versions with the routing replayed."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models.transformer import CausalLM

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    qz.launches["quantize"] = 0
    t0 = time.perf_counter()
    engine = InferenceEngineV2(
        CausalLM(cfg), params, RaggedInferenceEngineConfig(
            kv_block_size=16, max_chunk_tokens=256,
            max_ragged_sequence_count=32, kv_blocks=MOE_KV_BLOCKS,
            **(quant or {})), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    quantize_launches = qz.launches["quantize"]
    L = cfg.num_layers
    if quant and quantize_launches != 5:
        raise AssertionError(f"[{label}] {quantize_launches} quantize "
                             "launches at the build, want 5 (wq, wk, wv, wo,"
                             " lm_head; the expert stacks stay bf16)")
    for name in ("w_in", "w_out", "w_gate"):
        if engine.params["layers"][name].data_ptr() != \
                params["layers"][name].data_ptr():
            raise AssertionError(f"[{label}] the engine copied {name}")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in MAIN_PROMPT_LENS]
    engine.put([10_000], [prompts[0][:16]])          # warm-up
    engine.flush(10_000)
    sizes = []
    with moe_group_sizes(sizes):
        res = serve(engine, cfg, prompts, MAIN_NEW_TOKENS, label)
    res.update(build_s=build_s, quantize_launches=quantize_launches)
    puts, launches = res["puts"], res["launches"]
    if launches["paged_attention"] != L * puts:
        raise AssertionError(f"[{label}] {launches['paged_attention']} paged "
                             f"launches for {puts} puts x {L} layers")
    qmm = (4 * L + 1) * puts if quant else 0
    if launches["quantized_matmul"] != qmm:
        raise AssertionError(f"[{label}] {launches['quantized_matmul']} "
                             f"quantized-matmul launches, want {qmm}")
    log(f"[{label}] {L} paged launches a put and "
        f"{(4 * L + 1) if quant else 0} quantized matmuls a put (asserted); "
        f"engine built in {build_s:.2f} s")
    if cfg.moe_dropless:
        if len(sizes) != L * puts:
            raise AssertionError(f"[{label}] {len(sizes)} group-size reads "
                                 f"for {puts} puts x {L} layers")
        sync = [s for _, s in sizes]
        first = [g for g, _ in sizes[:L]]
        res["sync"] = {"reads": len(sync), "total_s": sum(sync),
                       "median_ms": 1e3 * float(np.median(sync)),
                       "max_ms": 1e3 * max(sync)}
        log(f"[{label}] group sizes of the first put's {L} layers: {first}; "
            f"{len(sync)} host reads (one a layer a put) took "
            f"{sum(sync):.3f} s in all, median {res['sync']['median_ms']:.3f}"
            f" ms, max {res['sync']['max_ms']:.3f} ms (each waits for the "
            f"work queued before it)")
    if steps:
        rng = np.random.default_rng(99)
        chunks = [rng.integers(0, cfg.vocab_size, 257).tolist(),
                  rng.integers(0, cfg.vocab_size, 201).tolist()]
        res["steps"] = compare_steps(
            functools.partial(moe_step_logits, engine, chunks, {}), label,
            slack_ulps=1)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return res


def moe_expert_share(cfg, params):
    """A prefill put (3 rows of 256 tokens: the engine's 768-token put) and
    a decode put (8 rows of 1) of the MoE engine timed whole (CUDA
    events), and each MoE piece of one
    layer timed alone at the same token count on layer 0's weights: the
    gate (router product and top-2 gating), the dispatch einsum, the
    expert products and the combine einsum. The MoE share of a put is
    layers x the pieces' sum over the put's time; the expert products'
    bound is their weight bytes (decode) or their operations (prefill)."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models.transformer import CausalLM
    from deepspeed_tpu_torch.moe import sharded_moe as sm

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    engine = InferenceEngineV2(
        CausalLM(cfg), params, RaggedInferenceEngineConfig(
            kv_block_size=16, max_chunk_tokens=256,
            max_ragged_sequence_count=32, kv_blocks=256), device="cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 257).tolist()
               for _ in range(8)]
    uids = list(range(30_000, 30_008))
    lp = {k: v[0] for k, v in params["layers"].items()}
    H, M, E = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts
    out = {}

    def prefill_put():
        # three fresh sequences, flushed after
        fresh = [40_000, 40_001, 40_002]
        engine.put(fresh, [p[:256] for p in prompts[:3]])
        for u in fresh:
            engine.flush(u)

    for lo in (0, 3, 6):
        engine.put(uids[lo:lo + 3], [p[:256] for p in prompts[lo:lo + 3]])

    def decode_put():
        # the same decode put each time: the token is trimmed off again
        engine.put(uids, [[p[256]] for p in prompts])
        for u in uids:
            engine.trim_sequence(u, 1)

    try:
        for step, S, put in (("prefill", 3 * 256, prefill_put),
                             ("decode", 8, decode_put)):
            put_ms = time_ms(put, flush, iters=5, warmup=1)
            h = (torch.randn((S, H), device="cuda") * 0.5).to(torch.bfloat16)
            router = lp["router_wg"].float()
            gate_out = sm.top2gating(h.float() @ router,
                                     cfg.moe_capacity_factor,
                                     cfg.moe_min_capacity)
            _, combine, dispatch, _ = gate_out
            expert_in = torch.einsum("sec,sm->ecm",
                                     dispatch.to(torch.bfloat16), h)
            expert_out = sm.expert_mlp(expert_in, lp["w_in"], lp["w_out"],
                                       lp["w_gate"], "silu", torch.bfloat16)
            C = combine.shape[-1]
            t = {
                "gate": time_ms(lambda: sm.top2gating(
                    h.float() @ router, cfg.moe_capacity_factor,
                    cfg.moe_min_capacity), flush, iters=10),
                "dispatch": time_ms(lambda: torch.einsum(
                    "sec,sm->ecm", dispatch.to(torch.bfloat16), h), flush,
                    iters=10),
                "experts": time_ms(lambda: sm.expert_mlp(
                    expert_in, lp["w_in"], lp["w_out"], lp["w_gate"],
                    "silu", torch.bfloat16), flush, iters=10),
                "combine": time_ms(lambda: torch.einsum(
                    "sec,ecm->sm", combine.to(torch.bfloat16), expert_out),
                    flush, iters=10)}
            w_bytes = 3 * E * H * M * 2
            flops = 2 * 3 * E * C * H * M
            bound = max(w_bytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
            moe_ms = cfg.num_layers * sum(t.values())
            out[step] = dict(t, put_ms=put_ms, tokens=S, capacity=C,
                             experts_bound_ms=1e3 * bound,
                             moe_share=moe_ms / put_ms)
            log(f"[moe share] {step} put of {S} tokens (capacity {C} a "
                f"expert): {put_ms:.2f} ms; one layer's gate "
                f"{t['gate']:.3f} ms, dispatch einsum {t['dispatch']:.3f} ms,"
                f" expert products {t['experts']:.3f} ms (bound "
                f"{1e3 * bound:.3f} ms by "
                f"{'bytes' if w_bytes / PEAK_BYTES_PER_S > flops / PEAK_BF16_FLOPS else 'operations'}"
                f"), combine einsum {t['combine']:.3f} ms; x "
                f"{cfg.num_layers} layers = {moe_ms:.2f} ms, "
                f"{out[step]['moe_share']:.3f} of the put")
    finally:
        for u in uids:
            engine.flush(u)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def moe_drops(record):
    """Each capacity gate's dropped assignments (k a token, less the
    dispatched ones) appended to ``record``."""
    import deepspeed_tpu_torch.models.transformer as tt

    real = {k: getattr(tt, k) for k in ("top1gating", "top2gating")}

    def wrap(name, k):
        def gate(logits, *a, **kw):
            out = real[name](logits, *a, **kw)
            record.append(k * logits.shape[0] - int(out[2].sum()))
            return out
        return gate

    tt.top1gating = wrap("top1gating", 1)
    tt.top2gating = wrap("top2gating", 2)
    try:
        yield
    finally:
        for k, v in real.items():
            setattr(tt, k, v)


def moe_small_parity():
    """Small fp32 MoE models (TINY_TEST widths, 4 experts, weights x4) give
    the same greedy streams through the kernels on the card as through the
    plain versions on the CPU: top-1 at capacity factor 0.5 and top-2 at
    the JAX default 1.25, where tokens drop (both runs must drop, and drop
    alike), and dropless; and the v1 int8 MoE ``generate`` (the expert
    stacks quantized too) at top-2 and 1.25 gives the CPU's stream. A put's
    padding rows route and take capacity slots, so where tokens drop these
    streams hold the paged kernels' rows past n_tokens to the plain
    version's (``tests/test_torch_moe.py::test_padding_rows_take_capacity``
    shows that zeroed padding rows move them)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.testing import greedy_generate
    from deepspeed_tpu_torch.models.transformer import TINY_TEST, CausalLM

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, TINY_TEST.vocab_size, n).tolist()
               for n in (5, 40, 17, 33, 100)]
    base = dict(kv_blocks=64, max_chunk_tokens=16, max_ragged_batch_size=32)
    variants = {"top1 cf 0.5": {"moe_top_k": 1, "moe_capacity_factor": 0.5},
                "top2 cf 1.25": {"moe_top_k": 2,
                                 "moe_capacity_factor": 1.25},
                "dropless": {"moe_dropless": True}}
    out = {"drops": {}}
    for name, kw in variants.items():
        cfg = dataclasses.replace(TINY_TEST, moe_num_experts=4, **kw)
        model = CausalLM(cfg)
        params = model.init(torch.Generator("cpu").manual_seed(3),
                            device="cpu")
        params = {g: {k: v * 4 if v.dim() >= 2 else v for k, v in sub.items()}
                  for g, sub in params.items()}
        streams, drops = {}, {}
        for dev in ("cpu", "cuda"):
            eng = InferenceEngineV2(model, params,
                                    RaggedInferenceEngineConfig(**base),
                                    device=dev)
            rec = []
            with moe_drops(rec):
                streams[dev] = greedy_generate(eng, prompts,
                                               max_new_tokens=12,
                                               sequential=False)
            drops[dev] = rec
        if streams["cpu"] != streams["cuda"] or drops["cpu"] != drops["cuda"]:
            raise AssertionError(f"[moe] small fp32 {name}: cpu {streams['cpu']}"
                                 f" dropping {sum(drops['cpu'])}, cuda "
                                 f"{streams['cuda']} dropping "
                                 f"{sum(drops['cuda'])}")
        if not cfg.moe_dropless and not sum(drops["cuda"]):
            raise AssertionError(f"[moe] small fp32 {name}: no token dropped")
        out["drops"][name] = sum(drops["cuda"])
        dropped = (f"{sum(drops['cuda'])} assignments dropped over "
                   f"{len(drops['cuda'])} gate calls, call for call as on "
                   "the CPU" if drops["cuda"] else "no capacity gate")
        log(f"[moe] small fp32 {name}: greedy streams on the card equal the "
            f"CPU plain path's ({len(prompts)} requests x 12 tokens), "
            f"{dropped}")
    cfg = dataclasses.replace(TINY_TEST, moe_num_experts=4, moe_top_k=2,
                              moe_capacity_factor=1.25)
    params = CausalLM(cfg).init(torch.Generator("cpu").manual_seed(4),
                                device="cpu")
    params = {g: {k: v * 4 if v.dim() >= 2 else v for k, v in sub.items()}
              for g, sub in params.items()}
    gen, drops = {}, {}
    for dev in ("cpu", "cuda"):
        reset_launches()
        eng = deepspeed_tpu_torch.init_inference(
            CausalLM(cfg), config={"dtype": "fp32", "quant": {
                "enabled": True, "bits": 8}}, params=params, device=dev)
        rec = []
        with moe_drops(rec):
            gen[dev] = eng.generate(prompts[:3], max_new_tokens=8).cpu()
        drops[dev] = rec
        deq = qz.launches["dequantize"]
    if not torch.equal(gen["cpu"], gen["cuda"]) \
            or drops["cpu"] != drops["cuda"] or deq == 0:
        raise AssertionError(f"[moe] v1 int8 MoE generate: cuda "
                             f"{gen['cuda'].tolist()} vs cpu "
                             f"{gen['cpu'].tolist()}, drops "
                             f"{sum(drops['cuda'])} vs {sum(drops['cpu'])}, "
                             f"{deq} dequantize launches")
    out["drops"]["v1 top2 cf 1.25"] = sum(drops["cuda"])
    log(f"[moe] v1 int8 MoE generate on the card equals the CPU's (3 "
        f"prompts x 8 tokens, top-2 at 1.25, {sum(drops['cuda'])} "
        f"assignments dropped alike; {deq} dequantize launches)")
    out["dequantize"] = deq
    return out


def moe_train(label, top_k, checks=False):
    """MISTRAL_7B's widths at MOE_TRAIN_LAYERS layer with 8 experts through
    ``initialize``: MOE_TRAIN_STEPS steps of 2 micro steps on 2 rows of
    MOE_TRAIN_SEQ tokens; finite losses and aux losses, the flash kernels'
    launches, and (``checks``) one micro step held against the plain
    attention with the routing replayed."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import CausalLM

    cfg = moe_cfg(MOE_TRAIN_LAYERS, moe_top_k=top_k)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = {"input_ids": np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, MOE_TRAIN_SEQ)).astype(np.int32)}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg), config=dict(TRAIN_CONFIG), training_data=data)
    n_params = sum(p.numel() for p in tree_tensors(engine.state.params))
    reset_launches()
    losses, secs = [], []
    for _ in range(MOE_TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(engine.train_batch()))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    launches = dict(fa.launches)
    with torch.no_grad():
        tokens = torch.as_tensor(data["input_ids"][:1, :-1], device="cuda")
        _, aux = engine.module.apply(engine.state.params, tokens,
                                     return_aux=True)
    aux = float(aux)
    per = MOE_TRAIN_STEPS * 2 * MOE_TRAIN_LAYERS
    want = {"fwd": per, "delta": per, "dq": per, "dkv": per}
    if launches != want or not np.isfinite(losses).all() \
            or not np.isfinite(aux) or not losses[-1] < losses[0]:
        raise AssertionError(f"[{label}] launches {launches} (want {want}), "
                             f"losses {losses}, aux {aux}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{label}] {n_params / 1e9:.3f} B parameters; {MOE_TRAIN_STEPS} "
        f"steps x 2 micro steps of {MOE_TRAIN_SEQ - 1} tokens: losses "
        f"{[round(x, 4) for x in losses]}, aux loss after {aux:.4f}, step s "
        f"{[round(x, 2) for x in secs]}, launches {json.dumps(launches)} "
        f"(asserted), peak {peak:.2f} GB")
    if checks:
        micro_step_check(engine, cfg.vocab_size, label=label, tape=[])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "aux": aux,
            "step_s": secs, "peak_gb": peak}


def phase_moe():
    """MoE at MISTRAL_7B widths with 8 experts: (a) v2 serving, top-2 at
    the capacity factor 1.25, of MOE_LAYERS layers, bf16, 8 requests x 32
    greedy tokens through the scheduler, the device time of a put split
    into the MoE pieces; (b) the same tree with int8 weights (attention and
    lm_head; the experts stay bf16) and int8 KV; (c) dropless top-1 on the
    same tree, with its group sizes and host reads; (d) small fp32 models
    card == CPU; (e) training, top-1 and top-2, at MOE_TRAIN_LAYERS layer.
    (f), expert parallelism, runs in the distributed phase's ranks. The
    kernels' launch counts are set to 0 before each served path and read
    after it."""
    cfg = moe_cfg(MOE_LAYERS)
    from deepspeed_tpu_torch.models.transformer import CausalLM

    free_engine()
    t0 = time.perf_counter()
    params = CausalLM(cfg).init(torch.Generator("cuda").manual_seed(0),
                                device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    nbytes = sum(v.numel() * v.element_size() for sub in params.values()
                 for v in sub.values())
    experts = sum(params["layers"][k].numel() * 2
                  for k in ("w_in", "w_out", "w_gate"))
    log(f"[moe] MISTRAL_7B widths, {cfg.num_layers} layers, {MOE_EXPERTS} "
        f"experts, top-2: {nbytes / 1e9:.2f} GB of bf16 weights "
        f"({experts / 1e9:.2f} GB of experts, {experts / 1e9 / cfg.num_layers:.2f}"
        f" GB a layer), made in {time.perf_counter() - t0:.1f} s")
    res = {"a": moe_serve("moe a top-2", cfg, params)}
    res["share"] = moe_expert_share(cfg, params)
    res["b"] = moe_serve("moe b int8", cfg, params,
                         quant=dict(weight_quant_enabled=True,
                                    weight_quant_block=128,
                                    kv_quant_enabled=True))
    res["c"] = moe_serve("moe c dropless", dataclasses.replace(
        cfg, moe_top_k=1, moe_dropless=True), params, steps=False)
    del params
    free_engine()
    res["d"] = moe_small_parity()
    res["e1"] = moe_train("moe e top-1", 1)
    res["e2"] = moe_train("moe e top-2", 2, checks=True)
    return res


# ----------------------------------------------------------- distributed

DIST_LAYERS = 2
DIST_SEQ = 4097             # one 4096-token row a rank a step
DIST_STEPS = 3
DIST_RANKS = 2
# the train and offload phases' tolerance for two engines that run the same
# bf16 program and sum its fp32 gradients in other orders (OFFLOAD_TOL)
DIST_TOL = OFFLOAD_TOL
# gathered params after step 3: no element further from (a)'s than AdamW
# moves one in the 3 steps at the peak lr. The forward is bf16: a master
# that differs in its last bits (gradients summed in another order) can
# round to the other bf16 weight, and where a gradient is small Adam's
# normalized step then differs by up to lr
DIST_PARAM_TOL = 3 * 1e-4
# qwZ + qgZ against plain stage 3: int8 weights on the wire and int8
# gradient partials move the loss by far less than this
DIST_QUANT_TOL = 2e-2
DIST_CHILD_S = 900          # the ranks' cells, (b)-(d) and (f)-(i)
# (i): MoE over expert = DIST_RANKS (4 of the 8 experts a rank) against one
# process; the second step's loss reads the first step's update. The bf16
# backward's partial token gradients (and gate gradients) are summed over
# the expert group after a bf16 rounding the one process does not make, so
# the leaves upstream of that sum (norms, router, attention) read larger
# gaps than the expert leaves, whose own gradients each rank computes whole.
# Limits from readings on an NVIDIA H100 80GB HBM3 at 700 W: the global grad
# norm 10x the largest (4.47e-05); each expert leaf's accumulated-gradient
# norm, summed over the ranks' experts, 10x the largest (1.02e-05, w_in);
# every other leaf's 5x the largest (1.06e-03, mlp_norm_w). The gathered
# params after the steps are held to DIST_PARAM_TOL, as (h)'s
MOE_DIST_STEPS = 2
MOE_DIST_NORM_TOL = 4.5e-4
MOE_DIST_EXPERT_TOL = 1e-4
MOE_DIST_LEAF_TOL = 5e-3
MOE_EXPERT_LEAVES = ("w_in", "w_out", "w_gate")
# (j)-(l): the sequence and pipe axes over the DIST_RANKS ranks, each held
# to (a): the step losses' largest relative gap to (a)'s and the sampled
# params' largest gap. From readings on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6, PR 22): (j) Ulysses read 1.17e-05 and 1.43e-04 (the
# same kernels on a rank's heads: the loss limit about 4x its reading, the
# params held to DIST_PARAM_TOL); (k) ring read 3.15e-04 at step 3 (it
# scores in bf16 einsums, as the JAX ring does, where (a)'s kernel scores
# in fp32: about 3x), its params held to the most two runs of AdamW can
# part an element in 3 steps at the peak lr (twice DIST_PARAM_TOL); (l)
# pipe read 5.0e-05 (the head's bf16 gradient of both rows at once: 4x)
SEQ_LOSS_TOL = 5e-5
SEQ_PARAM_TOL = DIST_PARAM_TOL
RING_LOSS_TOL = 1e-3
RING_PARAM_TOL = 2 * DIST_PARAM_TOL
PIPE_LOSS_TOL = DIST_TOL
PIPE_PARAM_TOL = DIST_PARAM_TOL
PIPE_MICRO = 2              # (l)'s pipeline.micro_batches
# (m): the host-driven PipelineEngine against sequential training, fp32
EXEC_WIDTH = 4096
EXEC_VOCAB = 32000
EXEC_MICRO = 4
EXEC_ROWS, EXEC_T = 2, 128  # a micro-batch's tokens
EXEC_STEPS = 3
# relative, each step's mean micro loss; read 6.89e-08 on an NVIDIA H100
# 80GB HBM3 at 700 W (fp32, the gradients summed in another order)
EXEC_TOL = 1e-6
# MISTRAL_7B's leaves that stage 3 shards over fsdp: 9 a layer, and of the
# globals wte, the final norm and lm_head; the untied wte is only indexed,
# so nothing saves it for the backward and it is not gathered again
DIST_LAYER_LEAVES = 9
DIST_GLOBAL_LEAVES = 3
DIST_GLOBAL_REGATHERED = 2


def dist_config(gas, extra=None, **zero):
    cfg = dict(TRAIN_CONFIG, gradient_accumulation_steps=gas,
               steps_per_print=100, comms_logger={"enabled": True},
               **(extra or {}))
    cfg["zero_optimization"] = dict(zero)
    return cfg


def dist_rows():
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    return np.random.default_rng(0).integers(
        0, MISTRAL_7B.vocab_size, (DIST_RANKS, DIST_SEQ)).astype(np.int32)


def dist_engine(gas, mesh=None, cfg=None, extra=None, **zero):
    """A training engine over ``mesh`` (one process without one) of ``cfg``
    (default MISTRAL_7B at DIST_LAYERS layers); ``extra``: more config
    blocks."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B, CausalLM

    cfg = cfg or dataclasses.replace(MISTRAL_7B, num_layers=DIST_LAYERS)
    kw = {} if mesh is None else {"mesh": mesh}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg), config=dist_config(gas, extra, **zero), **kw)
    return engine


def dist_step(engine, rows, grads=None, rows_per_micro=1):
    """One global step: the rows of the rank's data-parallel index on a mesh
    (a tensor, sequence or pipe group's ranks read the same), or every row,
    ``rows_per_micro`` rows a micro step; the loss and the synchronized
    seconds. ``grads``: a list that receives :func:`dist_grad_sumsq` of the
    accumulated gradients just before the update."""
    mine = rows[engine.dp_rank::engine.dp_world_size] if engine._mesh \
        else rows
    batches = [{"input_ids": mine[r:r + rows_per_micro]}
               for r in range(0, len(mine), rows_per_micro)]
    if grads is not None:
        real = engine.step

        def step():
            if engine.is_gradient_accumulation_boundary():
                grads.append(dist_grad_sumsq(engine))
            return real()
        engine.step = step
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        loss = float(engine.train_batch(iter(batches)))
    finally:
        if grads is not None:
            del engine.step
    torch.cuda.synchronize()
    return loss, time.perf_counter() - t


def dist_grad_sumsq(engine):
    """Each leaf's sum of squares of its accumulated gradient, over the
    blocks this rank holds first; summed over the ranks, the whole leaf's.
    Read where nothing is left to reduce (no data or fsdp axis)."""
    from deepspeed_tpu_torch.parallel.sharding import is_replica_zero
    from deepspeed_tpu_torch.runtime.engine import _at, _paths

    out = {}
    for path, acc in _paths(engine.state.grad_acc):
        if engine._mesh and not is_replica_zero(
                _at(engine._g_specs, path), engine.topology, engine.rank):
            continue
        out[".".join(path)] = sum(
            float(torch.sum(piece.double() ** 2))
            for piece in acc.detach().reshape(-1).split(1 << 26))
    return out


def dist_sample(engine):
    """A strided sample of 4096 elements of every param leaf, by flat index
    into the whole leaf, and its sum of squares: from the blocks this rank
    holds first (no collective), merged over the ranks by
    :func:`dist_merge`."""
    from deepspeed_tpu_torch.parallel.sharding import (is_replica_zero,
                                                       local_slice)
    from deepspeed_tpu_torch.runtime.engine import _at, _paths

    out = {}
    for path, p in _paths(engine.state.params):
        shape = tuple(p.shape)
        blk = tuple(slice(0, d) for d in shape)
        if engine._mesh:
            spec = _at(engine._p_specs, path)
            shape = engine._full_shapes[path]
            if not is_replica_zero(spec, engine.topology, engine.rank):
                continue
            blk = local_slice(shape, spec, engine.topology, engine.rank)
        n = math.prod(shape)
        idx = np.arange(0, n, max(1, n // 4096))[:4096]
        coords = np.unravel_index(idx, shape)
        inside = np.ones(len(idx), bool)
        for c, sl in zip(coords, blk):
            inside &= (c >= sl.start) & (c < sl.stop)
        local = tuple(torch.from_numpy(c[inside] - sl.start).to(p.device)
                      for c, sl in zip(coords, blk))
        out[".".join(path)] = {
            "idx": idx[inside].tolist(),
            "val": p.detach()[local].float().cpu().numpy().tolist(),
            "sumsq": float(torch.sum(p.detach().double() ** 2))}
    return out


def dist_merge(samples):
    """Every rank's :func:`dist_sample` as one: the values by flat index,
    the sums of squares added."""
    out = {}
    for sample in samples:
        for key, x in sample.items():
            m = out.setdefault(key, {"val": {}, "sumsq": 0.0})
            m["val"].update(zip(x["idx"], x["val"]))
            m["sumsq"] += x["sumsq"]
    return out


def dist_compare_samples(a, b, label, tol=DIST_PARAM_TOL):
    gap = 0.0
    for key, x in a.items():
        y = b[key]
        if sorted(x["val"]) != sorted(y["val"]):
            raise AssertionError(f"[{label}] {key}: sampled other elements")
        gap = max(gap, max(abs(v - y["val"][i]) for i, v in x["val"].items()))
        if abs(x["sumsq"] - y["sumsq"]) > 1e-4 * abs(y["sumsq"]):
            raise AssertionError(f"[{label}] {key}: sum of squares "
                                 f"{x['sumsq']} vs {y['sumsq']}")
    if gap > tol:
        raise AssertionError(f"[{label}] gathered params differ by {gap} "
                             f"(tolerance {tol})")
    return gap


def dist_comms():
    """The comms logger's records: op -> count, bytes, seconds, busbw."""
    from deepspeed_tpu_torch import comm

    out = {}
    for op, sizes in comm.comms_logger.log_all(print_log=False).items():
        recs = sizes.values()
        count = sum(r["count"] for r in recs)
        secs = sum(r["total_latency_ms"] for r in recs) / 1e3
        nbytes = sum(size * r["count"] for size, r in sizes.items())
        busbw = sum(r["busbw_gbps"] * r["count"] for r in recs) / count / 8
        out[op] = {"count": count, "bytes": nbytes, "s": round(secs, 4),
                   "busbw_gbs": round(busbw, 3)}
    return out


def dist_held(engine):
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves

    def nb(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    return nb(engine.state.params), nb(engine.state.opt_state.moments)


def dist_layer_bytes(engine):
    """The bytes of the stacked layer leaves this rank holds."""
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves

    return sum(t.numel() * t.element_size()
               for t in tree_leaves(engine.state.params["layers"]))


@contextlib.contextmanager
def flash_shapes(record):
    """Record (q shape, k shape) of every flash forward launch."""
    real = fa.flash_fwd_cuda

    def recording(q, k, v, *a, **kw):
        record.add((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, *a, **kw)

    fa.flash_fwd_cuda = recording
    try:
        yield record
    finally:
        fa.flash_fwd_cuda = real


def dist_run(label, rows, steps, zero, save_dir=None, load_dir=None,
             first=0, sample=False, mesh=None, gas=1, cfg=None, grads=False,
             extra=None, rows_per_micro=1, flash_per_micro=None):
    """On every rank: a ZeRO engine of ``cfg`` (``dist_engine``, with the
    config blocks ``extra``) over ``mesh`` (default fsdp = DIST_RANKS) at
    ``gas``, ``steps`` steps of ``rows_per_micro`` rows a micro step
    (saving after 2 when ``save_dir``; loading ``load_dir`` first); the
    rank's numbers (with ``grads``, each step's :func:`dist_grad_sumsq`).
    Asserts ``flash_per_micro`` (default: a layer's one) launches of each
    flash kernel a micro step, and records their shapes."""
    from deepspeed_tpu_torch import comm

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = dist_engine(gas, mesh=mesh or {"fsdp": DIST_RANKS}, cfg=cfg,
                         extra=extra, **zero)
    if load_dir is not None:
        engine.load_checkpoint(load_dir)
    comm.comms_logger.reset()
    reset_launches()
    losses, secs, norms, grad_sumsq = [], [], [], []
    shapes = set()
    for s in range(first, first + steps):
        with flash_shapes(shapes):
            loss, sec = dist_step(engine, rows, grad_sumsq if grads else None,
                                  rows_per_micro=rows_per_micro)
        losses.append(loss)
        secs.append(sec)
        norms.append(engine.get_global_grad_norm())
        if save_dir is not None and s == 1:
            engine.save_checkpoint(save_dir, tag="step2")
    launches = {"flash": dict(fa.launches), "quantize": qz.launches[
        "quantize"], "dequantize": qz.launches["dequantize"]}
    comms = dist_comms()
    staged = comm.comms_logger.host_staged_bytes
    staged_s = comm.comms_logger.host_staged_s
    gathers = [(t.gathers, t.regathers) for t in engine._gather_transforms]
    pbytes, mbytes = dist_held(engine)
    lbytes = dist_layer_bytes(engine)
    peak = torch.cuda.max_memory_allocated()
    sample = dist_sample(engine) if sample else None
    r = comm.get_rank()
    log(f"[distributed r{r}] {label}: losses {[round(x, 6) for x in losses]}"
        f", step s {[round(x, 3) for x in secs]}, peak "
        f"{peak / 1e9:.2f} GB, params held {pbytes / 1e9:.3f} GB (layers "
        f"{lbytes / 1e9:.3f}), moments {mbytes / 1e9:.3f} GB, launches "
        f"{json.dumps(launches)}, flash shapes (q, k) {sorted(shapes)}, "
        f"host_staged_bytes {staged} in {staged_s:.3f} s")
    for op, c in comms.items():
        log(f"[distributed r{r}] {label} comms {op}: {c['count']} calls, "
            f"{c['bytes'] / 1e9:.3f} GB, {c['s']:.3f} s, busbw "
            f"{c['busbw_gbs']:.3f} GB/s")
    per_micro = (engine.module.cfg.num_layers if flash_per_micro is None
                 else flash_per_micro)
    want = steps * gas * per_micro
    if any(launches["flash"][k] != want for k in ("fwd", "delta", "dq",
                                                   "dkv")):
        raise AssertionError(f"[distributed r{r}] {label}: flash launches "
                             f"{launches['flash']}, want {want} each")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": secs, "grad_norms": norms,
            "peak": peak, "param_bytes": pbytes, "moment_bytes": mbytes,
            "layer_bytes": lbytes, "launches": launches, "comms": comms,
            "staged": staged, "staged_s": staged_s, "grad_sumsq": grad_sumsq,
            "gathers": gathers, "sample": sample,
            "flash_shapes": sorted(shapes)}


def dist_rank_main(rank, work):
    """One rank of the distributed phase (``--dist-rank``): a gloo world of
    DIST_RANKS processes on the one card; (b) stages 0-3 (stage 3 saving
    after step 2), (d) a stage-3 engine resuming the one-process save, (c)
    stage 3 with qwZ + qgZ; then over tensor = DIST_RANKS (f) v2 serving,
    (g) v1 ``generate`` and (h) training (saving after step 2). Writes its
    results as JSON (the serving cells' streams and logits as ``.pt``)."""
    from deepspeed_tpu_torch import comm

    comm.init_distributed(dist_backend="gloo", device="cuda",
                          init_method=f"file://{work}/rendezvous",
                          rank=rank, world_size=DIST_RANKS, verbose=False)
    rows = dist_rows()
    out = {}
    try:
        for stage in (0, 1, 2, 3):
            out[f"s{stage}"] = dist_run(
                f"(b) stage {stage}", rows, DIST_STEPS, {"stage": stage},
                save_dir=os.path.join(work, "ranks") if stage == 3 else None,
                sample=True)
        ref_latest = os.path.join(work, "ref", "latest")
        deadline = time.monotonic() + DIST_CHILD_S
        while not os.path.exists(ref_latest):
            if time.monotonic() > deadline:
                raise AssertionError("[distributed] no one-process save")
            time.sleep(0.2)
        out["d"] = dist_run("(d) resume of the one-process save", rows, 1,
                            {"stage": 3}, load_dir=os.path.join(work, "ref"),
                            first=2)
        out["c"] = dist_run("(c) stage 3 + qwZ + qgZ", rows, DIST_STEPS,
                            {"stage": 3, "zero_quantized_weights": True,
                             "zero_quantized_gradients": True})
        t = time.perf_counter()
        model, params = tp_tree()
        out["f"] = tp_serving_rank(work, rank, model, params)
        out["g"] = tp_v1_rank(work, rank, model, params)
        del model, params
        out["h"] = dist_run("(h) tensor = 2", rows, DIST_STEPS, {"stage": 0},
                            save_dir=os.path.join(work, "tp"), sample=True,
                            mesh={"tensor": DIST_RANKS}, gas=DIST_RANKS)
        out["tp_s"] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
        out["i"] = dist_run("(i) MoE, expert = 2", rows, MOE_DIST_STEPS,
                            {"stage": 0}, mesh={"expert": DIST_RANKS},
                            gas=DIST_RANKS, cfg=moe_cfg(MOE_TRAIN_LAYERS),
                            sample=True, grads=True)
        out["moe_s"] = round(time.perf_counter() - t, 1)
        out.update(dist_seq_pipe_rank(work, rows))
    finally:
        comm.destroy_distributed()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def dist_seq_pipe_rank(work, rows):
    """This rank's (j) Ulysses and (k) ring over sequence = DIST_RANKS and
    (l) pipe = DIST_RANKS (saving after step 2), each on the two rows a
    step, 3 steps."""
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    out = {}
    t = time.perf_counter()
    seq = {"sequence": DIST_RANKS}
    out["j"] = dist_run("(j) Ulysses, sequence = 2", rows, DIST_STEPS,
                        {"stage": 2}, mesh=seq, gas=DIST_RANKS, sample=True)
    out["k"] = dist_run(
        "(k) ring, sequence = 2", rows, DIST_STEPS, {"stage": 2}, mesh=seq,
        gas=DIST_RANKS, sample=True, flash_per_micro=0,
        cfg=dataclasses.replace(MISTRAL_7B, num_layers=DIST_LAYERS,
                                attention_impl="ring"))
    out["seq_s"] = round(time.perf_counter() - t, 1)
    t = time.perf_counter()
    out["l"] = dist_run(
        "(l) pipe = 2", rows, DIST_STEPS, {"stage": 1},
        mesh={"pipe": DIST_RANKS}, rows_per_micro=DIST_RANKS, sample=True,
        extra={"pipeline": {"stages": DIST_RANKS,
                            "micro_batches": PIPE_MICRO}},
        flash_per_micro=PIPE_MICRO * DIST_LAYERS // DIST_RANKS,
        save_dir=os.path.join(work, "pipe"))
    out["pipe_s"] = round(time.perf_counter() - t, 1)
    return out


# ------------------------------------------- tensor parallelism, (f)-(h)

TP_SEED = 5
TP_QUANT_PROMPTS = 3        # the int8 weights + int8 KV run's prompts
TP_CAPTURE = 24             # puts whose logits are kept for the comparisons
TP_QUANT = {"weight_quant_enabled": True, "kv_quant_enabled": True}
TP_GAP_TOKENS = 256         # the v1 comparison's forward: 2 prompts this long
# the largest |tensor = 2 - one process| logit difference allowed on the
# same puts (and, for v1, on one forward), set from two readings on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): that difference,
# 0.166-0.180, and the one-process engines' own kernel/plain gap,
# 0.199-0.234, at logits up to 5.4-6.9 in magnitude
TP_LOGIT_LIMIT = 0.35


def tp_tree():
    """MISTRAL_7B at SERVE_LAYERS layers, bf16 weights drawn on the host
    from TP_SEED: the same tree in every process. Each engine cuts what it
    needs from it, so a rank's card only receives that rank's blocks."""
    from deepspeed_tpu_torch.models.transformer import CausalLM

    model = CausalLM(serve_cfg())
    t = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(TP_SEED), device="cpu",
                        dtype=torch.bfloat16)
    log(f"[distributed] the {model.cfg.num_layers}-layer tree drawn on the "
        f"host in {time.perf_counter() - t:.1f} s")
    return model, params


def tp_prompts(cfg):
    rng = np.random.default_rng(TP_SEED)
    return [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in MAIN_PROMPT_LENS]


def tp_v2_engine(model, params, quant, mesh):
    """The v2 engine from the host tree (over ``mesh``, or one process),
    its quantize launches, and the card's peak memory while it was built."""
    from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                                  RaggedInferenceEngineConfig)

    ecfg = RaggedInferenceEngineConfig(
        kv_block_size=16, max_chunk_tokens=256, max_ragged_sequence_count=32,
        kv_blocks=1024, **(TP_QUANT if quant else {}))
    free_engine()
    torch.cuda.reset_peak_memory_stats()
    qz.launches["quantize"] = 0
    engine = InferenceEngineV2(model, params, ecfg, device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    return engine, qz.launches["quantize"], torch.cuda.max_memory_allocated()


def tp_v2_serve(engine, prompts, label):
    """Serve ``prompts`` at once through a margin-recording scheduler
    (MAIN_NEW_TOKENS each): the streams, each put's inputs and seconds, the
    logits of the first TP_CAPTURE puts, and the launch counts (set to 0
    just before, read just after), checked against L paged launches a put
    and, under weight quantization, 7 L + 1 quantized-matmul launches."""
    sched = margin_scheduler(engine)
    puts = []
    real = engine.put

    def put(uids, chunks, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(uids, chunks, **kw)
        torch.cuda.synchronize()
        rec = {"key": [list(uids), [list(c) for c in chunks]],
               "s": time.perf_counter() - t,
               "decode": max(len(c) for c in chunks) == 1}
        if len(puts) < TP_CAPTURE:
            rec["logits"] = out.float().cpu()
        puts.append(rec)
        return out

    engine.put = put
    reset_launches()
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(prompts):
            sched.submit(i, p, max_new_tokens=MAIN_NEW_TOKENS)
        sched.run_to_completion()
        torch.cuda.synchronize()
    finally:
        del engine.put
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pa.launches,
                "quantized_matmul": qz.launches["quantized_matmul"]}
    L = engine.model.cfg.num_layers
    want = {"paged_attention": L * len(puts),
            "quantized_matmul": (7 * L + 1) * len(puts)
            if engine.config.weight_quant_enabled else 0}
    streams = [sched.finished[i].generated for i in range(len(prompts))]
    if launches != want or any(len(x) != MAIN_NEW_TOKENS for x in streams) \
            or engine.free_blocks != engine.config.kv_blocks:
        raise AssertionError(f"[{label}] launches {launches} (want {want}), "
                             f"stream lengths {[len(x) for x in streams]}, "
                             f"free blocks {engine.free_blocks}")
    dec = [p["s"] for p in puts if p["decode"]]
    log(f"[{label}] {len(prompts)} requests x {MAIN_NEW_TOKENS} tokens in "
        f"{wall:.2f} s, {len(puts)} puts ({len(dec)} decode-only, median "
        f"{1e3 * float(np.median(dec)):.2f} ms); launches "
        f"{json.dumps(launches)} = {json.dumps(want)} expected")
    return {"streams": streams, "puts": puts, "wall": wall,
            "launches": launches,
            "margins": [sched.margins.get(i, {}) for i in range(len(prompts))]}


def tp_serving_rank(work, rank, model, params):
    """(f) on a rank: the v2 engine over tensor = DIST_RANKS, its blocks
    cut from the host tree ``params`` (contiguous on the card), bf16 on the
    main prompts with the comms logger timing every all-reduce, then int8
    weights + int8 KV on TP_QUANT_PROMPTS of them. Writes streams, puts and
    captured logits to ``tp_f<rank>.pt``."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves

    out = {}
    for quant in (False, True):
        label = f"distributed f r{rank} {'int8' if quant else 'bf16'}"
        t = time.perf_counter()
        engine, n_quant, build_peak = tp_v2_engine(
            model, params, quant, {"tensor": DIST_RANKS})
        build_s = time.perf_counter() - t
        held = sum(t_.numel() * t_.element_size() for t_ in
                   tree_leaves(engine.params))
        want_q = 7 + 1 if quant else 0
        pool = tuple(engine.state_manager.kv_cache["k"].shape)
        if n_quant != want_q or pool[2] != model.cfg.kv_heads // DIST_RANKS:
            raise AssertionError(f"[{label}] {n_quant} quantize launches "
                                 f"(want {want_q}), pool {pool}")
        prompts = tp_prompts(model.cfg)[:TP_QUANT_PROMPTS if quant else None]
        engine.put([10_000], [prompts[0][:16]])        # warm-up
        engine.flush(10_000)
        comm.comms_logger.reset()
        comm.comms_logger.enabled = not quant
        comm.comms_logger.prof_all = not quant
        torch.cuda.reset_peak_memory_stats()
        res = tp_v2_serve(engine, prompts, label)
        comms = dist_comms()
        staged_s = comm.comms_logger.host_staged_s
        comm.comms_logger.enabled = False
        peak = torch.cuda.max_memory_allocated()
        log(f"[{label}] build {build_s:.2f} s ({n_quant} quantize launches "
            f"= {want_q} expected), weights held {held / 1e9:.3f} GB, build "
            f"peak {build_peak / 1e9:.3f} GB, pool {pool}, serving peak "
            f"{peak / 1e9:.2f} GB"
            + (f"; all-reduces {json.dumps(comms.get('all_reduce'))}, host "
               f"staging {staged_s:.3f} s" if not quant else ""))
        res.update(build_s=build_s, held=held, build_peak=build_peak,
                   peak=peak, comms=comms, staged_s=staged_s)
        out["int8" if quant else "bf16"] = res
        del engine
    torch.save(out, os.path.join(work, f"tp_f{rank}.pt"))
    return {k: {"wall": v["wall"], "puts": len(v["puts"]),
                "held": v["held"], "build_peak": v["build_peak"]}
            for k, v in out.items()}


def tp_v1_generate(engine, prompts, label, layers):
    """``generate`` of the prompts (MAIN_NEW_TOKENS greedy tokens) with the
    launch counts checked: L flash forwards, L paged launches a decode step,
    and with quantized weights (9 L + 2) dequantize launches a forward."""
    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=MAIN_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = v1_launches()
    bits = engine.config.quant.enabled
    want = {"dequantize": (1 + MAIN_NEW_TOKENS) * (9 * layers + 2)
            if bits else 0, "flash_fwd": layers,
            "paged_attention": MAIN_NEW_TOKENS * layers, "quantize": 0}
    if launches != want:
        raise AssertionError(f"[{label}] launches {launches}, want {want}")
    log(f"[{label}] generate {len(prompts)} prompts x {MAIN_NEW_TOKENS} in "
        f"{wall:.2f} s; launches {json.dumps(launches)} = expected")
    return out.cpu(), wall


def tp_gap_tokens(cfg):
    rng = np.random.default_rng(TP_SEED + 1)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (2, TP_GAP_TOKENS)),
                           dtype=torch.int32, device="cuda")


def tp_v1_engine(model, params, bits, tp):
    """``init_inference`` from the host tree at ``tp_size`` ``tp`` (bf16,
    int8 weights when ``bits``), its quantize launches checked, and the
    card's peak memory while it was built."""
    import deepspeed_tpu_torch

    config = {"dtype": "bf16"}
    if tp > 1:
        config["tensor_parallel"] = {"tp_size": tp}
    if bits:
        config["quant"] = {"enabled": True, "bits": bits}
    free_engine()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    engine = deepspeed_tpu_torch.init_inference(
        model, config=config, params=params, device="cuda")
    torch.cuda.synchronize()
    if qz.launches["quantize"] != (V1_QUANT_LEAVES if bits else 0):
        raise AssertionError(f"[distributed g] tp {tp}: "
                             f"{qz.launches['quantize']} quantize launches")
    return engine, torch.cuda.max_memory_allocated()


def tp_v1_rank(work, rank, model, params):
    """(g) on a rank: ``init_inference`` with tp_size = DIST_RANKS, its
    blocks cut from the host tree ``params``, bf16 and int8: the main
    prompts' greedy streams and one forward's logits, written to
    ``tp_g<rank>.pt``."""
    from deepspeed_tpu_torch.inference.quantization import tree_nbytes

    out = {}
    for bits in (None, 8):
        label = f"distributed g r{rank} {'int8' if bits else 'bf16'}"
        engine, build_peak = tp_v1_engine(model, params, bits, DIST_RANKS)
        held = tree_nbytes(engine.params)
        log(f"[{label}] weights held {held / 1e9:.3f} GB, build peak "
            f"{build_peak / 1e9:.3f} GB")
        prompts = tp_prompts(model.cfg)
        engine.generate([prompts[0][:16]], max_new_tokens=2)     # warm-up
        streams, wall = tp_v1_generate(engine, prompts, label,
                                       model.cfg.num_layers)
        with torch.no_grad():
            logits = engine.forward(tp_gap_tokens(model.cfg)).float().cpu()
        out["int8" if bits else "bf16"] = {
            "streams": streams, "wall": wall, "logits": logits,
            "held": held, "build_peak": build_peak}
        del engine
    torch.save(out, os.path.join(work, f"tp_g{rank}.pt"))
    return {k: {"wall": v["wall"], "held": v["held"],
                "build_peak": v["build_peak"]} for k, v in out.items()}


def tp_one_gap(get_logits, label):
    """The one-process engine's largest |kernel - plain| logit difference
    over a prefill and a decode step (``compare_steps``): the bf16 rounding
    noise that the tensor = 2 runs' parity is judged by, measured without
    them."""
    res = compare_steps(get_logits, label)
    return max(r["max_dlogit"] for r in res.values())


def tp_references(work):
    """The one-process engines on the same host tree: (f) the v2 engine's
    runs and (g) v1's streams and forward logits, each with its
    kernel/plain gap (``tp_one_gap``), kept for the comparison."""
    model, params = tp_tree()
    rng = np.random.default_rng(99)
    chunks = [rng.integers(0, model.cfg.vocab_size, 257).tolist(),
              rng.integers(0, model.cfg.vocab_size, 201).tolist()]
    ref = {"f": {}, "g": {}}
    for quant in (False, True):
        label = f"distributed f one process {'int8' if quant else 'bf16'}"
        engine, _, _ = tp_v2_engine(model, params, quant, None)
        prompts = tp_prompts(model.cfg)[:TP_QUANT_PROMPTS if quant else None]
        engine.put([10_000], [prompts[0][:16]])
        engine.flush(10_000)
        res = tp_v2_serve(engine, prompts, label)
        res["gap"] = tp_one_gap(
            functools.partial(step_logits, engine, chunks), label)
        ref["f"]["int8" if quant else "bf16"] = res
        del engine
    rng = np.random.default_rng(98)
    toks = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, (2, 256)),
                           dtype=torch.int32, device="cuda")
    plen = torch.tensor([256, 200], dtype=torch.int32, device="cuda")
    nxt = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, 2),
                          dtype=torch.int32, device="cuda")
    for bits in (None, 8):
        label = f"distributed g one process {'int8' if bits else 'bf16'}"
        engine, _ = tp_v1_engine(model, params, bits, 1)
        prompts = tp_prompts(model.cfg)
        engine.generate([prompts[0][:16]], max_new_tokens=2)
        streams, wall = tp_v1_generate(engine, prompts, label,
                                       model.cfg.num_layers)
        with torch.no_grad():
            logits = engine.forward(tp_gap_tokens(model.cfg)).float().cpu()
        gap = tp_one_gap(functools.partial(v1_step_logits, engine, toks,
                                           plen, nxt), label)
        # the engine is kept for the margins of the greedy-parity rule
        ref["g"]["int8" if bits else "bf16"] = {
            "streams": streams, "wall": wall, "logits": logits, "gap": gap,
            "engine": engine}
        del engine
    return ref


def tp_margin_at(engine, prompt, stream, j):
    """The one-process v1 engine's top-2 logit margin for the token at new
    position ``j`` of ``stream`` after ``prompt``."""
    toks = torch.as_tensor([list(prompt) + list(stream[:j])],
                           dtype=torch.int32, device="cuda")
    with torch.no_grad():
        last = engine.forward(toks)[0, -1].float().cpu().numpy()
    return margin_of(last)


def tp_limit(diff, label):
    """Fail when the tensor = 2 logits are further than TP_LOGIT_LIMIT from
    the one process's on the same inputs."""
    if not diff <= TP_LOGIT_LIMIT:
        raise AssertionError(
            f"[{label}] max |tensor = 2 - one process| logit difference "
            f"{diff:.4g} on the same inputs > the limit {TP_LOGIT_LIMIT}")


def tp_check(work, ref):
    """(f) and (g): the two ranks' streams and captured logits equal bit
    for bit; the rank's logits within TP_LOGIT_LIMIT of the one process's
    on the same puts ((g): on one forward); the streams held to the one
    process's by the greedy-parity rule, with the gap the one-process
    engine's own kernel/plain gap (``tp_one_gap``)."""
    ranks_f = [torch.load(os.path.join(work, f"tp_f{r}.pt"))
               for r in range(DIST_RANKS)]
    ranks_g = [torch.load(os.path.join(work, f"tp_g{r}.pt"))
               for r in range(DIST_RANKS)]
    summary = {}
    for mode in ("bf16", "int8"):
        a, b = ranks_f[0][mode], ranks_f[1][mode]
        same = a["streams"] == b["streams"] and all(
            torch.equal(x["logits"], y["logits"])
            for x, y in zip(a["puts"], b["puts"]) if "logits" in x)
        if not same:
            raise AssertionError(f"[distributed f] {mode}: the ranks' streams"
                                 " or logits differ")
        one = ref["f"][mode]
        pairs = [(x, y) for x, y in zip(a["puts"], one["puts"])
                 if "logits" in x and "logits" in y and x["key"] == y["key"]]
        n_pre = sum(not x["decode"] for x, _ in pairs)
        if not n_pre:
            raise AssertionError(f"[distributed f] {mode}: no prefill put "
                                 "on the same inputs to compare")
        diff = max(float((x["logits"] - y["logits"]).abs().max())
                   for x, y in pairs)
        scale = max(float(y["logits"].abs().max()) for _, y in pairs)
        tp_limit(diff, f"distributed f {mode}")
        div = parity_rule(one, a, one["gap"], f"distributed f {mode}",
                          "distributed")
        dec = [p["s"] for p in a["puts"] if p["decode"]]
        one_dec = [p["s"] for p in one["puts"] if p["decode"]]
        ar = a["comms"].get("all_reduce", {})
        summary[f"f {mode}"] = {
            "dlogit": diff, "limit": TP_LOGIT_LIMIT, "gap": one["gap"],
            "max_logit": scale, "puts_compared": [n_pre, len(pairs) - n_pre],
            "diverged": div, "wall_s": a["wall"], "one_wall_s": one["wall"],
            "decode_put_ms": 1e3 * float(np.median(dec)),
            "one_decode_put_ms": 1e3 * float(np.median(one_dec)),
            "puts": len(a["puts"]), "all_reduce": ar,
            "staged_s": a["staged_s"], "held": [r[mode]["held"]
                                                for r in ranks_f],
            "build_peak": [r[mode]["build_peak"] for r in ranks_f]}
        log(f"[distributed f] {mode}: ranks bit-equal ({len(a['puts'])} "
            f"puts, {sum('logits' in p for p in a['puts'])} captured logits "
            f"equal); max |tensor = 2 - one process| logit {diff:.4g} on "
            f"{n_pre} prefill and {len(pairs) - n_pre} decode puts of the "
            f"same inputs (limit {TP_LOGIT_LIMIT}; max |logit| {scale:.4g}; "
            f"the one process's kernel/plain gap {one['gap']:.4g}); tensor "
            f"= 2 {a['wall']:.2f} s vs one process {one['wall']:.2f} s, "
            f"median decode put "
            f"{summary[f'f {mode}']['decode_put_ms']:.2f} vs "
            f"{summary[f'f {mode}']['one_decode_put_ms']:.2f} ms"
            + (f"; gloo all-reduces {ar.get('count')} in {ar.get('s')} s, "
               f"host staging {a['staged_s']:.3f} s" if ar else ""))
    for mode in ("bf16", "int8"):
        a, b = ranks_g[0][mode], ranks_g[1][mode]
        if not (torch.equal(a["streams"], b["streams"])
                and torch.equal(a["logits"], b["logits"])):
            raise AssertionError(f"[distributed g] {mode}: the ranks differ")
        one = ref["g"][mode]
        diff = float((a["logits"] - one["logits"]).abs().max())
        tp_limit(diff, f"distributed g {mode}")
        gap = one["gap"]
        prompts = tp_prompts(serve_cfg())
        diverged = []
        for i, p in enumerate(prompts):
            x = a["streams"][i, len(p):len(p) + MAIN_NEW_TOKENS].tolist()
            y = one["streams"][i, len(p):len(p) + MAIN_NEW_TOKENS].tolist()
            if x == y:
                continue
            j = next(k for k, (u, v) in enumerate(zip(x, y)) if u != v)
            m = tp_margin_at(one["engine"], p, y, j)
            if m > gap:
                raise AssertionError(
                    f"[distributed g] {mode}: row {i} diverges at {j} with a "
                    f"one-process margin {m} > its kernel/plain gap "
                    f"{gap:.4g}")
            diverged.append((i, j, round(m, 4)))
        summary[f"g {mode}"] = {
            "dlogit": diff, "limit": TP_LOGIT_LIMIT, "gap": gap,
            "diverged": diverged, "wall_s": a["wall"],
            "one_wall_s": one["wall"],
            "held": [r[mode]["held"] for r in ranks_g],
            "build_peak": [r[mode]["build_peak"] for r in ranks_g]}
        log(f"[distributed g] {mode}: ranks bit-equal; max |tensor = 2 - "
            f"one process| logit {diff:.4g} on one forward of 2 x "
            f"{TP_GAP_TOKENS} tokens (limit {TP_LOGIT_LIMIT}); greedy parity "
            f"with one process: {len(prompts) - len(diverged)} of "
            f"{len(prompts)} rows equal, diverged {diverged} within the one "
            f"process's kernel/plain gap {gap:.4g}; generate "
            f"{a['wall']:.2f} s vs one process {one['wall']:.2f} s")
    return summary


def dist_nccl_one_rank(work, rows):
    """(e) A one-rank nccl world: every collective of ``comm`` once on the
    card (each an identity in a world of one) and ZeRO++'s quantized
    gather forward and backward through the kernels; then one step of a
    stage-3 ZeRO++ engine in that world (which shards nothing, as in the
    JAX package)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import zeropp

    comm.init_distributed(dist_backend="nccl", device="cuda",
                          init_method=f"file://{work}/nccl_rendezvous",
                          rank=0, world_size=1, verbose=False)
    try:
        g = torch.Generator("cuda").manual_seed(3)
        x = torch.randn(64, 256, device="cuda", generator=g)
        calls = {
            "all_reduce": lambda: comm.all_reduce(x.clone()),
            "all_reduce AVG": lambda: comm.all_reduce(x.clone(),
                                                      comm.ReduceOp.AVG),
            "all_gather_into_tensor": lambda: comm.all_gather_into_tensor(
                None, x, axis=1),
            "all_gather": lambda: comm.all_gather(None, x)[0],
            "reduce_scatter_tensor": lambda: comm.reduce_scatter_tensor(
                None, x, scatter_dim=1),
            "all_to_all_single": lambda: comm.all_to_all_single(
                None, x, "data"),
            "broadcast": lambda: comm.broadcast(x.clone(), 0),
            "ppermute": lambda: comm.ppermute(x, [(0, 0)], "data")}
        for name, fn in calls.items():
            if not torch.equal(fn(), x):
                raise AssertionError(f"[distributed e] nccl {name} is not "
                                     "the identity in a world of one")
        comm.barrier()
        reset_launches()
        w = x.clone().requires_grad_(True)
        y = zeropp.quantized_all_gather(w, "fsdp", 0, qw_bits=8, qg_bits=8)
        y.backward(torch.ones_like(y))
        # the plain versions: the kernels give their bits (kernel phase)
        q, s = qz._quantize_torch(x, 8, qz.choose_block(256))
        want = qz._dequantize_torch(q, s, qz.choose_block(256))
        if not torch.equal(y.detach(), want) or \
                qz.launches["quantize"] != 2 or qz.launches["dequantize"] != 2:
            raise AssertionError(
                f"[distributed e] quantized gather {qz.launches}, gap "
                f"{(y.detach() - want).abs().max().item()}")
        engine = dist_engine(2, stage=3, zero_quantized_weights=True,
                             zero_quantized_gradients=True)
        loss, sec = dist_step(engine, rows)
        del engine
        log(f"[distributed e] one-rank nccl world: {len(calls)} collectives "
            f"and barrier on nccl, the quantized gather through the kernels "
            f"(2 quantize, 2 dequantize launches), one stage-3 ZeRO++ step: "
            f"loss {loss:.6f} in {sec:.2f} s")
    finally:
        comm.destroy_distributed()
        free_engine()
    return loss


def dist_wait_for(path, procs, deadline, what):
    """Wait for ``path`` (a checkpoint's ``latest``) while the ranks run;
    fails when a rank has exited non-zero or the deadline passes."""
    while not os.path.exists(path):
        for p in procs:
            if p.poll() not in (None, 0):
                raise AssertionError(f"[distributed] a rank exited "
                                     f"{p.returncode} before {what}")
        if time.monotonic() > deadline:
            raise AssertionError(f"[distributed] no {what} in time")
        time.sleep(0.2)


def phase_distributed():
    """The distributed spine at MISTRAL_7B widths, DIST_LAYERS layers,
    bf16: two gloo ranks on the card in child processes (``--dist-rank``)
    run (b)-(d) while this process runs (a) the one-process engine at gas 2
    (saving after step 2) and, once the ranks' stage-3 save is committed,
    (d) its one-process resume. Then the ranks run the tensor-parallel
    cells over tensor = 2 while this process runs the one-process
    references of (f) v2 serving and (g) v1 ``generate`` (SERVE_LAYERS
    layers); once the ranks are done, (f) and (g) are checked (the ranks
    bit-equal, their logits within TP_LOGIT_LIMIT of one process's on the
    same inputs, the greedy-parity rule against one process) and (h), tensor
    = 2 training, against (a), and its save is resumed in one process;
    then (e) a one-rank nccl world. The ranks are mostly waiting on gloo,
    so the card has room for both."""
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    rows = dist_rows()
    per_ckpt = 12 * dataclasses.replace(MISTRAL_7B,
                                        num_layers=DIST_LAYERS).num_params()
    # the stage-3, one-process and tensor = 2 saves, and (f)/(g)'s logits
    work = ckpt_root("distributed", 3 * per_ckpt + per_ckpt // 6 + 10 ** 9)
    secs = {}
    procs = []
    t_ranks = time.perf_counter()
    deadline = time.monotonic() + DIST_CHILD_S
    try:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--dist-rank", str(r), "--dist-dir", work],
                                  cwd=REPO) for r in range(DIST_RANKS)]
        t = time.perf_counter()
        reset_launches()
        ref = dist_engine(2)
        ref_losses, ref_secs = [], []
        for s in range(DIST_STEPS):
            loss, sec = dist_step(ref, rows)
            ref_losses.append(loss)
            ref_secs.append(sec)
            if s == 1:
                ref.save_checkpoint(os.path.join(work, "ref"), tag="step2")
        ref_sample = dist_merge([dist_sample(ref)])
        ref_held = dist_held(ref)
        ref_layers = dist_layer_bytes(ref)
        if fa.launches["fwd"] != DIST_STEPS * 2 * DIST_LAYERS:
            raise AssertionError(f"[distributed a] launches {fa.launches}")
        log(f"[distributed a] one process, gas 2 (beside the ranks): losses "
            f"{[round(x, 6) for x in ref_losses]}, step s "
            f"{[round(x, 3) for x in ref_secs]}, params held "
            f"{ref_held[0] / 1e9:.3f} GB, moments {ref_held[1] / 1e9:.3f} GB")
        del ref
        free_engine()
        secs["a"] = round(time.perf_counter() - t, 1)

        # (d), this side: the ranks' stage-3 save, once committed
        dist_wait_for(os.path.join(work, "ranks", "latest"), procs, deadline,
                      "stage-3 save from the ranks")
        t = time.perf_counter()
        one = dist_engine(2)
        one.load_checkpoint(os.path.join(work, "ranks"))
        d_loss, _ = dist_step(one, rows)
        del one
        free_engine()
        secs["d"] = round(time.perf_counter() - t, 1)
        # (f), (g) this side: the one-process runs the ranks are held to
        t = time.perf_counter()
        tp_ref = tp_references(work)
        secs["fg_ref"] = round(time.perf_counter() - t, 1)
        # (m) here while the ranks run
        t = time.perf_counter()
        exec_summary = pipe_executor_cell()
        secs["m"] = round(time.perf_counter() - t, 1)
        try:
            for p in procs:
                rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
                if rc != 0:
                    raise AssertionError(f"[distributed] a rank exited {rc}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for r in range(DIST_RANKS):
            with open(os.path.join(work, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        secs["ranks"] = round(time.perf_counter() - t_ranks, 1)

        # (b): every stage's losses on every rank against (a)'s, and the
        # params gathered after step 3
        for stage in range(4):
            for r, res in enumerate(ranks):
                got = res[f"s{stage}"]["losses"]
                gaps = [abs(a - b) / abs(b) for a, b in zip(got, ref_losses)]
                if max(gaps) > DIST_TOL:
                    raise AssertionError(
                        f"[distributed b] stage {stage} rank {r}: losses "
                        f"{got} vs {ref_losses} (tolerance {DIST_TOL})")
            gap = dist_compare_samples(
                dist_merge([res[f"s{stage}"]["sample"] for res in ranks]),
                ref_sample, f"distributed b s{stage}")
            log(f"[distributed b] stage {stage}: losses within "
                f"{max(gaps):.3g} of (a)'s (tolerance {DIST_TOL}), gathered "
                f"params within {gap:.3g} (tolerance {DIST_PARAM_TOL})")
        s3 = ranks[0]["s3"]
        if not s3["param_bytes"] < 0.55 * ref_held[0] or \
                not s3["moment_bytes"] < 0.55 * ref_held[1]:
            raise AssertionError(f"[distributed b] stage 3 holds "
                                 f"{s3['param_bytes']}, {s3['moment_bytes']}")
        # (c): ZeRO++ against plain stage 3, launches from the gathers
        micro = DIST_STEPS
        for r, res in enumerate(ranks):
            c = res["c"]
            gaps = [abs(a - b) / abs(b) for a, b in
                    zip(c["losses"], res["s3"]["losses"])]
            gathers = sum(g for g, _ in c["gathers"])
            regathers = sum(x for _, x in c["gathers"])
            want_g = (DIST_LAYER_LEAVES * DIST_LAYERS
                      + DIST_GLOBAL_LEAVES) * micro
            want_r = (DIST_LAYER_LEAVES * DIST_LAYERS
                      + DIST_GLOBAL_REGATHERED) * micro
            want_q = want_g + want_r + want_g
            if (gathers, regathers) != (want_g, want_r) or \
                    c["launches"]["quantize"] != want_q or \
                    c["launches"]["dequantize"] != want_q or \
                    max(gaps) > DIST_QUANT_TOL:
                raise AssertionError(
                    f"[distributed c] rank {r}: gathers {gathers}/{want_g}, "
                    f"regathers {regathers}/{want_r}, launches "
                    f"{c['launches']} (want {want_q} each), losses "
                    f"{c['losses']} vs stage 3's {res['s3']['losses']}")
        log(f"[distributed c] qwZ + qgZ: losses within {max(gaps):.3g} of "
            f"stage 3's (bound {DIST_QUANT_TOL}); {want_q // micro} quantize "
            f"and {want_q // micro} dequantize launches a rank a step "
            f"({want_g // micro} gathers, {want_r // micro} re-gathers, "
            f"{want_g // micro} gradient reduces; asserted)")

        # (d): the ranks resumed the one-process save; the one process
        # resumed the ranks' stage-3 save
        for r, res in enumerate(ranks):
            gap = abs(res["d"]["losses"][0] - ref_losses[2]) / ref_losses[2]
            if gap > DIST_TOL:
                raise AssertionError(f"[distributed d] rank {r} resumed "
                                     f"{res['d']['losses']} vs {ref_losses}")
        want = ranks[0]["s3"]["losses"][2]
        if abs(d_loss - want) > DIST_TOL * abs(want):
            raise AssertionError(f"[distributed d] one process resumed the "
                                 f"ranks' save: {d_loss} vs {want}")
        log(f"[distributed d] the ranks' stage-3 save resumed in one process:"
            f" step 3 loss {d_loss:.6f} vs the ranks' {want:.6f}; the one-"
            f"process save resumed on the ranks: {ranks[0]['d']['losses'][0]:.6f}"
            f" vs {ref_losses[2]:.6f} (tolerance {DIST_TOL})")
        # (f), (g): the ranks against each other and the one process
        t = time.perf_counter()
        tp_summary = tp_check(work, tp_ref)
        for mode in ("bf16", "int8"):
            tp_ref["g"][mode]["engine"] = None
        del tp_ref
        free_engine()
        # (h): tensor = 2 against (a), and its save resumed in one process
        for r, res in enumerate(ranks):
            h = res["h"]
            gaps = [abs(a - b) / abs(b) for a, b in zip(h["losses"],
                                                         ref_losses)]
            flash = h["launches"]["flash"]
            if max(gaps) > DIST_TOL or h["losses"] != ranks[0]["h"]["losses"]:
                raise AssertionError(f"[distributed h] rank {r}: losses "
                                     f"{h['losses']} vs {ref_losses}")
            log(f"[distributed h] rank {r}: losses within {max(gaps):.3g} of "
                f"(a)'s (tolerance {DIST_TOL}); flash launches "
                f"{json.dumps(flash)} = {DIST_STEPS * 2 * DIST_LAYERS} "
                "expected each")
        gap = dist_compare_samples(
            dist_merge([res["h"]["sample"] for res in ranks]), ref_sample,
            "distributed h")
        one = dist_engine(2)
        one.load_checkpoint(os.path.join(work, "tp"))
        h_loss, _ = dist_step(one, rows)
        del one
        free_engine()
        want = ranks[0]["h"]["losses"][2]
        if abs(h_loss - want) > DIST_TOL * abs(want):
            raise AssertionError(f"[distributed h] one process resumed the "
                                 f"tensor-sharded save: {h_loss} vs {want}")
        log(f"[distributed h] gathered params within {gap:.3g} of (a)'s "
            f"(tolerance {DIST_PARAM_TOL}); the tensor-sharded save resumed "
            f"in one process: step 3 loss {h_loss:.6f} vs the ranks' "
            f"{want:.6f}; the ranks' tensor cells took "
            f"{ranks[0]['tp_s']} s")
        tp_summary["h"] = {"losses": ranks[0]["h"]["losses"],
                           "resumed": h_loss, "param_gap": gap,
                           "step_s": ranks[0]["h"]["step_s"],
                           "comms": ranks[0]["h"]["comms"]}
        secs["fgh_check"] = round(time.perf_counter() - t, 1)
        # (i): MoE over expert = 2 against one process
        t = time.perf_counter()
        moe_summary = moe_dist_check(ranks, rows)
        secs["i"] = round(time.perf_counter() - t, 1)
        # (j)-(l): the sequence and pipe axes against (a)
        t = time.perf_counter()
        seq_pipe = seq_pipe_check(ranks, ref_losses, ref_sample, ref_layers,
                                  work, rows)
        seq_pipe["m"] = exec_summary
        secs["jkl"] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
        e_loss = dist_nccl_one_rank(work, rows)
        secs["e"] = round(time.perf_counter() - t, 1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
        free_engine()
    log(f"[distributed] sub-phases s: {json.dumps(secs)}")
    return {"ref_losses": ref_losses, "ref_step_s": ref_secs,
            "ranks": ranks, "e_loss": e_loss, "secs": secs,
            "tensor": tp_summary, "moe": moe_summary, "seq_pipe": seq_pipe}


def seq_pipe_check(ranks, ref_losses, ref_sample, ref_layers, work, rows):
    """(j)-(l) against (a): every rank's losses within the cell's loss
    limit of (a)'s (and equal on both ranks), the params after the steps
    within its param limit on the strided sample; the flash launches were
    asserted by the ranks, their shapes are checked here; (l) holds half
    of (a)'s layer bytes, and its save after step 2 resumes in one process
    on the ranks' curve."""
    from deepspeed_tpu_torch.models.transformer import MISTRAL_7B

    cfg = MISTRAL_7B
    T = DIST_SEQ - 1
    D = cfg.hidden_size // cfg.num_heads
    want_shapes = {
        "j": [[[1, T, cfg.num_heads // DIST_RANKS, D],
               [1, T, cfg.num_kv_heads // DIST_RANKS, D]]],
        "k": [],
        "l": [[[1, T, cfg.num_heads, D], [1, T, cfg.num_kv_heads, D]]]}
    limits = {"j": (SEQ_LOSS_TOL, SEQ_PARAM_TOL),
              "k": (RING_LOSS_TOL, RING_PARAM_TOL),
              "l": (PIPE_LOSS_TOL, PIPE_PARAM_TOL)}
    names = {"j": "Ulysses, sequence = 2", "k": "ring, sequence = 2",
             "l": "pipe = 2, ZeRO 1"}
    out = {}
    for cell, (loss_tol, param_tol) in limits.items():
        gaps = []
        for r, res in enumerate(ranks):
            c = res[cell]
            gaps += [abs(a - b) / abs(b) for a, b in zip(c["losses"],
                                                         ref_losses)]
            shapes = [list(map(list, sh)) for sh in c["flash_shapes"]]
            if c["losses"] != ranks[0][cell]["losses"] or \
                    max(gaps) > loss_tol or shapes != want_shapes[cell]:
                raise AssertionError(
                    f"[distributed {cell}] rank {r}: losses {c['losses']} vs "
                    f"{ref_losses} (tolerance {loss_tol}), flash shapes "
                    f"{shapes} (want {want_shapes[cell]})")
        gap = dist_compare_samples(
            dist_merge([res[cell]["sample"] for res in ranks]), ref_sample,
            f"distributed {cell}", tol=param_tol)
        c = ranks[0][cell]
        comms = {op: v for op, v in c["comms"].items()
                 if op in ("all_to_all_single", "ppermute", "all_reduce")}
        log(f"[distributed {cell}] {names[cell]}: losses "
            f"{[round(x, 6) for x in c['losses']]} within {max(gaps):.3g} of "
            f"(a)'s (limit {loss_tol}); sampled params within {gap:.3g} "
            f"(limit {param_tol}); step s {[round(x, 2) for x in c['step_s']]}"
            f"; flash launches {json.dumps(c['launches']['flash'])} at "
            f"(q, k) {want_shapes[cell]}; comms {json.dumps(comms)}")
        out[cell] = {"losses": c["losses"], "loss_gap": max(gaps),
                     "param_gap": gap, "step_s": c["step_s"],
                     "launches": c["launches"]["flash"], "comms": c["comms"],
                     "param_bytes": c["param_bytes"],
                     "moment_bytes": c["moment_bytes"],
                     "layer_bytes": c["layer_bytes"], "peak": c["peak"]}
    lb = ranks[0]["l"]["layer_bytes"]
    if lb * DIST_RANKS != ref_layers:
        raise AssertionError(f"[distributed l] a stage holds {lb} layer "
                             f"bytes, (a) {ref_layers}")
    one = dist_engine(2)
    one.load_checkpoint(os.path.join(work, "pipe"))
    l_loss, _ = dist_step(one, rows)
    del one
    free_engine()
    want = ranks[0]["l"]["losses"][2]
    if abs(l_loss - want) > PIPE_LOSS_TOL * abs(want):
        raise AssertionError(f"[distributed l] one process resumed the "
                             f"pipe-sharded save: {l_loss} vs {want}")
    out["l"]["resumed"] = l_loss
    log(f"[distributed l] a stage holds {lb / 1e9:.3f} GB of layers, half "
        f"of (a)'s {ref_layers / 1e9:.3f} GB (params "
        f"{ranks[0]['l']['param_bytes'] / 1e9:.3f} GB, moments "
        f"{ranks[0]['l']['moment_bytes'] / 1e9:.3f} GB); the pipe-sharded "
        f"save resumed in one process: step 3 loss {l_loss:.6f} vs the "
        f"ranks' {want:.6f}; the ranks' cells took {ranks[0]['seq_s']} s "
        f"(j, k) and {ranks[0]['pipe_s']} s (l)")
    return out


def pipe_executor_cell():
    """(m): the host-driven PipelineEngine on the card: stages of width
    EXEC_WIDTH Linear layers between a tied embedding and unembedding
    (``tests/test_pipe_executor.py``'s model), 2 stages, EXEC_MICRO
    micro-batches, EXEC_STEPS SGD steps, against the same layers from the
    same params trained sequentially (the micro-batches' gradients summed,
    each of 1/M of its loss; the tied table's two uses summed): each step's
    mean micro loss within EXEC_TOL."""
    from deepspeed_tpu_torch.runtime.pipe import (LayerSpec, PipelineEngine,
                                                  PipelineModule,
                                                  TiedLayerSpec)

    class Linear:
        def __init__(self, out_dim):
            self.out_dim = out_dim

        def init(self, rng, x):
            n = x.shape[-1]
            return {"w": torch.randn(n, self.out_dim, generator=rng,
                                     device=x.device) / math.sqrt(n),
                    "b": torch.zeros(self.out_dim, device=x.device)}

        def apply(self, p, x):
            return torch.tanh(x @ p["w"] + p["b"])

    class Embed:
        def __init__(self, vocab, dim):
            self.vocab, self.dim = vocab, dim

        def init(self, rng, x):
            return {"e": 0.02 * torch.randn(self.vocab, self.dim,
                                            generator=rng, device=x.device)}

        def apply(self, p, x):
            return p["e"][x.long()]

    class Unembed(Embed):
        def apply(self, p, x):
            return x @ p["e"].t()

    def ce(logits, y):
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())

    V, H, M = EXEC_VOCAB, EXEC_WIDTH, EXEC_MICRO
    specs = [TiedLayerSpec("emb", Embed, V, H), LayerSpec(Linear, H),
             LayerSpec(Linear, H), TiedLayerSpec("emb", Unembed, V, H)]
    module = PipelineModule(specs, num_stages=2, partition_method="uniform")
    lr = 0.5
    eng = PipelineEngine(module, ce, num_micro_batches=M, optimizer="sgd",
                         optimizer_params={"lr": lr}, seed=7, device="cuda")
    rng = np.random.default_rng(7)
    data = [[(torch.from_numpy(rng.integers(0, V, (EXEC_ROWS, EXEC_T))).cuda(),
              torch.from_numpy(rng.integers(0, V, (EXEC_ROWS, EXEC_T))).cuda())
             for _ in range(M)] for _ in range(EXEC_STEPS)]
    eng._lazy_init(data[0][0][0])
    # the sequential reference: one copy of each distinct param
    layers = [lyr for sl in eng._stage_layers for lyr in sl]
    flat = [p for sp in eng.params for p in sp]
    e = flat[0]["e"].clone()
    mids = [{k: v.clone() for k, v in p.items()} for p in flat[1:3]]
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = [eng.train_batch(iter(micros)) for micros in data]
    torch.cuda.synchronize()
    exec_s = time.perf_counter() - t
    ref = []
    for micros in data:
        leaves = [e] + [v for p in mids for v in p.values()]
        for v in leaves:
            v.requires_grad_(True)
            v.grad = None
        total = 0.0
        for x, y in micros:
            h = layers[0].apply({"e": e}, x)
            h = layers[2].apply(mids[1], layers[1].apply(mids[0], h))
            loss = ce(layers[3].apply({"e": e}, h), y)
            (loss / M).backward()
            total += float(loss.detach())
        ref.append(total / M)
        with torch.no_grad():
            e = (e - lr * e.grad).detach()
            mids = [{k: (v - lr * v.grad).detach() for k, v in p.items()}
                    for p in mids]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    got = [eng.params[0][0]["e"]] + [v for p in (eng.params[0][1],
                                                 eng.params[1][0])
                                     for v in p.values()]
    pgap = max(float((a - b).abs().max()) for a, b in zip(
        got, [e] + [v for p in mids for v in p.values()]))
    if max(gaps) > EXEC_TOL or eng.params[0][0]["e"] is not \
            eng.params[1][-1]["e"]:
        raise AssertionError(f"[distributed m] PipelineEngine losses "
                             f"{losses} vs sequential {ref} (limit "
                             f"{EXEC_TOL})")
    log(f"[distributed m] PipelineEngine on the card, 2 stages, width {H}, "
        f"vocab {V}, tied embedding, {M} micro-batches, {EXEC_STEPS} SGD "
        f"steps: losses {[round(x, 6) for x in losses]} vs sequential "
        f"{[round(x, 6) for x in ref]} (within {max(gaps):.3g}, limit "
        f"{EXEC_TOL}); params within {pgap:.3g}; {exec_s:.2f} s")
    return {"losses": losses, "sequential": ref, "loss_gap": max(gaps),
            "param_gap": pgap, "s": exec_s}


def moe_dist_check(ranks, rows):
    """(i): the ranks' MoE engine over expert = 2 (each holding 4 of the 8
    experts of MISTRAL_7B's widths at MOE_TRAIN_LAYERS layer, the partial
    outputs summed over the pair) against the same engine in one process:
    equal losses on both ranks, each within DIST_TOL of one process's; the
    global grad norms within MOE_DIST_NORM_TOL; each leaf's accumulated
    gradient norm at every step within MOE_DIST_EXPERT_TOL for the expert
    leaves (summed over the ranks' experts) and MOE_DIST_LEAF_TOL for the
    others; the gathered params after the steps within DIST_PARAM_TOL; half
    the expert bytes a rank."""
    free_engine()
    reset_launches()
    one = dist_engine(2, cfg=moe_cfg(MOE_TRAIN_LAYERS))
    losses, norms, secs, one_grads = [], [], [], []
    for _ in range(MOE_DIST_STEPS):
        loss, sec = dist_step(one, rows, one_grads)
        losses.append(loss)
        norms.append(one.get_global_grad_norm())
        secs.append(sec)
    held = dist_held(one)
    one_sample = dist_merge([dist_sample(one)])
    del one
    free_engine()
    for r, res in enumerate(ranks):
        i = res["i"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(i["losses"], losses)]
        ngaps = [abs(a - b) / abs(b) for a, b in zip(i["grad_norms"], norms)]
        if i["losses"] != ranks[0]["i"]["losses"] or max(gaps) > DIST_TOL \
                or max(ngaps) > MOE_DIST_NORM_TOL \
                or not i["param_bytes"] < 0.75 * held[0]:
            raise AssertionError(
                f"[distributed i] rank {r}: losses {i['losses']} vs "
                f"{losses} (tolerance {DIST_TOL}), grad norms "
                f"{i['grad_norms']} vs {norms} (tolerance "
                f"{MOE_DIST_NORM_TOL}), params held {i['param_bytes']} vs "
                f"{held[0]}")
    # each leaf's gradient norm, step by step: the ranks' blocks merged
    leaf_gaps = {}
    for s_, want in enumerate(one_grads):
        got = {}
        for res in ranks:
            for k, v in res["i"]["grad_sumsq"][s_].items():
                got[k] = got.get(k, 0.0) + v
        if sorted(got) != sorted(want):
            raise AssertionError(f"[distributed i] gradient leaves "
                                 f"{sorted(got)} vs {sorted(want)}")
        for k, v in want.items():
            gap = abs(math.sqrt(got[k]) - math.sqrt(v)) / math.sqrt(v)
            leaf_gaps[k] = max(leaf_gaps.get(k, 0.0), gap)
    def is_expert(k):
        return k.split(".")[-1] in MOE_EXPERT_LEAVES

    for k, gap in leaf_gaps.items():
        tol = MOE_DIST_EXPERT_TOL if is_expert(k) else MOE_DIST_LEAF_TOL
        if gap > tol:
            raise AssertionError(f"[distributed i] gradient norm of {k} "
                                 f"{gap:.3g} from one process's (tolerance "
                                 f"{tol}); every leaf: "
                                 f"{json.dumps(leaf_gaps)}")
    experts = max(v for k, v in leaf_gaps.items() if is_expert(k))
    others = {k: v for k, v in leaf_gaps.items() if not is_expert(k)}
    worst = max(others, key=others.get)
    param_gap = dist_compare_samples(
        dist_merge([res["i"]["sample"] for res in ranks]), one_sample,
        "distributed i")
    i = ranks[0]["i"]
    log(f"[distributed i] MoE over expert = 2: losses "
        f"{[round(x, 6) for x in i['losses']]} vs one process "
        f"{[round(x, 6) for x in losses]} (within {max(gaps):.3g}, "
        f"tolerance {DIST_TOL}); grad norms within {max(ngaps):.3g} "
        f"(tolerance {MOE_DIST_NORM_TOL}); leaf gradient norms: expert "
        f"leaves within {experts:.3g} (tolerance {MOE_DIST_EXPERT_TOL}), "
        f"the others within {leaf_gaps[worst]:.3g} ({worst}; tolerance "
        f"{MOE_DIST_LEAF_TOL}); every leaf "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in leaf_gaps.items()})}"
        f"); gathered params within {param_gap:.3g} (tolerance "
        f"{DIST_PARAM_TOL}); params held a rank "
        f"{i['param_bytes'] / 1e9:.3f} GB vs {held[0] / 1e9:.3f} GB; step s "
        f"{[round(x, 2) for x in i['step_s']]} vs "
        f"{[round(x, 2) for x in secs]}; flash launches "
        f"{json.dumps(i['launches']['flash'])}; the ranks' cell took "
        f"{ranks[0]['moe_s']} s")
    return {"losses": i["losses"], "one_losses": losses,
            "grad_norms": i["grad_norms"], "one_grad_norms": norms,
            "leaf_gaps": leaf_gaps, "param_gap": param_gap,
            "step_s": i["step_s"], "one_step_s": secs,
            "launches": i["launches"]["flash"], "comms": i["comms"]}


def json_scalar(x):
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"{type(x).__name__} is not JSON serializable")


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
                                       "features", "hf_import", "kv_tier",
                                       "serving", "fabric", "train",
                                       "train_state", "offload", "moe",
                                       "distributed"],
                    help="after device, build and kernel run this phase "
                         "alone (no result lines)")
    ap.add_argument("--offload-result", metavar="PATH",
                    help="run the offload phase alone, without the build "
                         "and kernel phases, and write its result to PATH "
                         "as JSON (the whole run calls itself so)")
    ap.add_argument("--compare", action="store_true",
                    help="after device and build, time the kernels at the "
                         "main path's shapes through their entry points "
                         "alone, so that a copy of this script in another "
                         "checkout times that checkout (no result lines)")
    ap.add_argument("--dist-rank", type=int, metavar="R",
                    help="run one rank of the distributed phase, without the "
                         "build and kernel phases (the phase starts its "
                         "ranks so)")
    ap.add_argument("--dist-dir", metavar="DIR",
                    help="the distributed phase's rendezvous and result "
                         "directory (with --dist-rank)")
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
    if args.dist_rank is not None:
        dist_rank_main(args.dist_rank, args.dist_dir)
        return
    if args.offload_result:
        out = timed("offload", phase_offload)
        with open(args.offload_result, "w") as fh:
            json.dump(out, fh, default=json_scalar)
        return
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
                 "features": phase_features, "hf_import": phase_hf_import,
                 "kv_tier": phase_kv_tier,
                 "serving": phase_serving, "fabric": phase_fabric,
                 "train": phase_train,
                 "train_state": phase_train_state,
                 "offload": phase_offload, "moe": phase_moe,
                 "distributed": phase_distributed}[args.only]
        kw = {} if args.only in ("timing", "v1", "hf_import", "kv_tier",
                                 "serving", "fabric", "train_state",
                                 "offload", "moe", "distributed") else {
            "profile_step" if args.only == "train" else "profile_puts":
            args.profile}
        timed(args.only, phase, **kw)
        log(f"[done] --only {args.only}: {json.dumps(secs)}")
        return
    times = timed("timing", phase_timing)
    # first of the paths, in a process of its own: the 32-layer cell needs
    # the most of the host's RAM
    offload = timed("offload", phase_offload_apart)
    main_res = timed("main", phase_main, profile_puts=args.profile)
    int8, fp8 = timed("quant", phase_quant, profile_puts=args.profile)
    v1 = timed("v1", phase_v1)
    features = timed("features", phase_features, profile_puts=args.profile)
    hf = timed("hf_import", phase_hf_import, universal=features["checkpoint"])
    serving = timed("serving", phase_serving)
    fabric = timed("fabric", phase_fabric)
    train = timed("train", phase_train, profile_step=args.profile)
    state = timed("train_state", phase_train_state)
    moe = timed("moe", phase_moe)
    dist = timed("distributed", phase_distributed)
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
    log(f"[features] MISTRAL_7B, {FEATURE_LAYERS} layers: prefix cache warm pass "
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
    ha, hb, uni = hf["a"], hf["b"], features["checkpoint"]
    log(f"[hf_import] Mistral-7B ({HF_LAYERS} layers) from HF safetensors: "
        f"{ha['load']['gb']:.3f} GB at {ha['load']['gb_per_s']:.2f} GB/s "
        f"(universal reader {uni['gb'] / uni['load_s']:.2f} GB/s), "
        f"host RSS growth {ha['load']['rss_gb']:.3f} GB; .bin "
        f"{ha['bin_load']['gb_per_s']:.2f} GB/s; Falcon-7B G = 71 median "
        f"put ms prefill {hb['prefill_put_ms']:.2f} | decode "
        f"{hb['decode_put_ms']:.2f} (plain {hb['plain_prefill_put_ms']:.2f} "
        f"| {hb['plain_decode_put_ms']:.2f}); BERT-base card vs CPU max "
        f"|diff| {max(hf['c'].values()):.3g}")
    b, c, q = serving["burst"], serving["chaos"], serving["quant"]
    log(f"[serving] MISTRAL_7B through ServingFrontend: burst shed rate "
        f"{b['shed_rate']:.4f}, p50/p95 TTFT {b['frontend']['ttft_p50_ms']:.1f}"
        f"/{b['frontend']['ttft_p95_ms']:.1f} ms (bare scheduler "
        f"{b['bare']['ttft_p50_ms']:.1f}/{b['bare']['ttft_p95_ms']:.1f}), "
        f"tokens/s {b['frontend']['tokens_per_s']:.1f} (bare "
        f"{b['bare']['tokens_per_s']:.1f}); chaos recovery_s "
        f"{c['recovery_s']:.4f}, two replicas / one {c['two_over_one']:.2f}x; "
        f"int8 config {q['puts']} puts, span coverage {q['coverage_min']:.4f}")
    d, tn = serving["disagg"], serving["tenancy"]
    af, sc = serving["affinity"], serving["autoscale"]
    log(f"[serving] item 10b: disagg tokens/s bf16 "
        f"{d['bf16']['tokens_per_s']:.1f} | int8 {d['int8']['tokens_per_s']:.1f}"
        f" against one mixed {d['mixed1']['tokens_per_s']:.1f} and two "
        f"{d['mixed2']['tokens_per_s']:.1f}, export + import p50 "
        f"{d['bf16']['handoff_ms']['export'][0]:.2f} + "
        f"{d['bf16']['handoff_ms']['import'][0]:.2f} ms; gold share "
        f"{tn['gold_share']:.3f}; prefix hit rate affinity off | on "
        f"{af['off']['hit_rate']:.3f} | {af['on']['hit_rate']:.3f}, warm-up "
        f"{af['warmup']['blocks']} blocks; autoscale grow to serving "
        f"{sc['grow_to_serving_s']:.3f} s, replica_seconds "
        f"{sc['replica_seconds']:.2f}")
    fa_, fc, fd = fabric["a"], fabric["c"], fabric["d"]
    log(f"[fabric] MISTRAL_7B replicas as processes: tokens/s one "
        f"{fa_[1]['stats']['tokens_per_s']:.1f}, two "
        f"{fa_[2]['stats']['tokens_per_s']:.1f} ({fa_['two_over_one']:.2f}x; "
        f"threads 0.60-0.70x); disagg tokens/s bf16 "
        f"{fabric['b bf16']['stats']['tokens_per_s']:.1f} | int8 "
        f"{fabric['b int8']['stats']['tokens_per_s']:.1f} | fp8 KV "
        f"{fabric['b fp8']['stats']['tokens_per_s']:.1f}, payload "
        f"{fabric['split bf16']['payload_mb']:.1f} | "
        f"{fabric['split int8']['payload_mb']:.1f} MB; SIGKILL failover "
        f"{fc['failover_s']:.2f} s, recovery_s {fc['recovery_s']:.2f}; "
        f"federation {int(fd['run']['snap']['requests_federated'])} "
        f"adopted requests, the exporter's death failed "
        f"{int(fd['lost']['snap']['requests_failed_over'])} over")
    log(f"[train] MISTRAL_7B widths, {TRAIN_LAYERS} layers, bf16, AdamW: "
        f"tokens/s per step {[round(t, 1) for t in train['tokens_per_s']]}, "
        f"peak memory {train['peak_gb']:.2f} GB")
    ob = offload["b"]
    log(f"[offload] MISTRAL_7B, 32 layers under ZeRO-Offload (moments on "
        f"{ob['choice']['device']}, ratio {ob['choice']['ratio']}): step "
        f"seconds {[round(x['step_s'], 2) for x in ob['steps']]}, losses "
        f"{[round(x, 4) for x in ob['losses']]}, peak device memory "
        f"{ob['peak_gb']:.2f} GB, host RSS at most {ob['peak_rss_gb']:.1f} GB; "
        f"parity gap {offload['a']['gap']:.3g}; ZeRO-Infinity step seconds "
        f"cpu {offload['d cpu']['step_s']}, nvme {offload['d nvme']['step_s']}")
    r0 = dist["ranks"][0]
    log(f"[distributed] MISTRAL_7B widths, {DIST_LAYERS} layers, bf16, "
        f"{DIST_RANKS} gloo ranks on one card: step seconds (rank 0) "
        + ", ".join(f"stage {k}: {[round(x, 2) for x in r0[f's{k}']['step_s']]}"
                    for k in range(4))
        + f", qwZ + qgZ {[round(x, 2) for x in r0['c']['step_s']]}; one "
        f"process at gas 2 {[round(x, 2) for x in dist['ref_step_s']]}; "
        f"host-staged bytes a rank (stages 0-3, c) "
        f"{[r0[k]['staged'] for k in ('s0', 's1', 's2', 's3', 'c')]}")
    tp = dist["tensor"]
    log(f"[distributed] tensor = 2 over the gloo ranks: v2 bf16 "
        f"{tp['f bf16']['wall_s']:.2f} s vs one process "
        f"{tp['f bf16']['one_wall_s']:.2f} s (median decode put "
        f"{tp['f bf16']['decode_put_ms']:.2f} vs "
        f"{tp['f bf16']['one_decode_put_ms']:.2f} ms), diverged "
        f"{tp['f bf16']['diverged']} (gap {tp['f bf16']['gap']:.4g}); int8 "
        f"diverged {tp['f int8']['diverged']}; v1 bf16 | int8 generate "
        f"{tp['g bf16']['wall_s']:.2f} | {tp['g int8']['wall_s']:.2f} s vs "
        f"{tp['g bf16']['one_wall_s']:.2f} | {tp['g int8']['one_wall_s']:.2f}"
        f" s; training losses {[round(x, 6) for x in tp['h']['losses']]}, "
        f"step s {[round(x, 2) for x in tp['h']['step_s']]}")
    sp = dist["seq_pipe"]
    log(f"[distributed] sequence and pipe over the gloo ranks, losses' gap "
        f"to (a) | step s: (j) Ulysses {sp['j']['loss_gap']:.3g} | "
        f"{[round(x, 2) for x in sp['j']['step_s']]}, (k) ring "
        f"{sp['k']['loss_gap']:.3g} | {[round(x, 2) for x in sp['k']['step_s']]}"
        f", (l) pipe = 2 {sp['l']['loss_gap']:.3g} | "
        f"{[round(x, 2) for x in sp['l']['step_s']]}; (m) PipelineEngine "
        f"gap {sp['m']['loss_gap']:.3g} in {sp['m']['s']:.2f} s")
    ma, mb, mc = moe["a"], moe["b"], moe["c"]
    log(f"[moe] MISTRAL_7B widths, {MOE_LAYERS} layers, {MOE_EXPERTS} "
        f"experts: prefill | decode tokens/s top-2 bf16 "
        f"{ma['prefill_tps']:.1f} | {ma['decode_tps']:.1f}, int8 weights + "
        f"int8 KV {mb['prefill_tps']:.1f} | {mb['decode_tps']:.1f}, dropless "
        f"top-1 {mc['prefill_tps']:.1f} | {mc['decode_tps']:.1f} (group-size "
        f"reads {mc['sync']['total_s']:.3f} s); MoE share of a put prefill "
        f"{moe['share']['prefill']['moe_share']:.3f}, decode "
        f"{moe['share']['decode']['moe_share']:.3f}; training step s top-1 "
        f"{[round(x, 2) for x in moe['e1']['step_s']]}, top-2 "
        f"{[round(x, 2) for x in moe['e2']['step_s']]}; expert = 2 losses "
        f"{[round(x, 6) for x in dist['moe']['losses']]} vs one process "
        f"{[round(x, 6) for x in dist['moe']['one_losses']]}")
    # the flash kernels run on three paths, each counted from 0: the train
    # phase's, the offload headline's and a rank's distributed stage-0 run;
    # quantize on the quant phase's build and dequantize on v1 int8's, and
    # both on ZeRO++'s (a rank's qwZ + qgZ run)
    by_path = {name: {"train": launches[name],
                      "offload": ob["launches"][key],
                      "distributed": r0["s0"]["launches"]["flash"][key],
                      "tensor": r0["h"]["launches"]["flash"][key]}
               for name, key in (("flash_fwd", "fwd"), ("flash_dq", "dq"),
                                 ("flash_dkv", "dkv"))}
    for name, path in (("quantize", "quant"), ("dequantize", "v1")):
        by_path[name] = {path: launches[name],
                         "distributed": r0["c"]["launches"][name]}
    # the MoE paths, each counted from 0 just before it: (a) bf16 and (b)
    # int8 serving, (d) the small v1 int8 generate, (e) training and (i)
    # the expert-parallel ranks
    moe_flash = {k: moe["e1"]["launches"][k] + moe["e2"]["launches"][k]
                 for k in ("fwd", "dq", "dkv")}
    by_path["quantize"]["moe"] = mb["quantize_launches"]
    by_path["dequantize"]["moe"] = moe["d"]["dequantize"]
    for name, key in (("flash_fwd", "fwd"), ("flash_dq", "dq"),
                      ("flash_dkv", "dkv")):
        by_path[name]["moe"] = moe_flash[key]
        by_path[name]["moe expert-parallel"] = dist["moe"]["launches"][key]
        # a rank's (j) Ulysses and (l) pipe runs, each counted from 0
        by_path[name]["sequence"] = r0["j"]["launches"]["flash"][key]
        by_path[name]["pipe"] = r0["l"]["launches"]["flash"][key]
    by_path["paged_attention"] = {
        "main": launches["paged_attention"],
        "moe": ma["launches"]["paged_attention"],
        "hf_import": ha["v2"]["launches"]["paged_attention"],
        "hf_import falcon": hb["launches"]}
    # the HF import's v1 int8 path: its build's quantize launches, then the
    # generate's dequantize and flash forward launches, each counted from 0
    by_path["quantize"]["hf_import"] = ha["v1"]["build_launches"]["quantize"]
    by_path["dequantize"]["hf_import"] = ha["v1"]["launches"]["dequantize"]
    by_path["flash_fwd"]["hf_import"] = ha["v1"]["launches"]["flash_fwd"]
    by_path["paged_attention_quant"] = {
        "quant": launches["paged_attention_quant"],
        "moe": mb["launches"]["paged_attention"]}
    by_path["quantized_matmul"] = {
        "quant": launches["quantized_matmul"],
        "moe": mb["launches"]["quantized_matmul"]}
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
        if name in by_path:
            kernels[-1]["launches_by_path"] = by_path[name]
        if name == "paged_attention":
            kernels[-1]["falcon_g71"] = [
                times["paged_attention falcon decode"],
                times["paged_attention falcon prefill"]]
    log(f"[done] {time.perf_counter() - t_start:.1f} s {json.dumps(secs)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
