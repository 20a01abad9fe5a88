"""Port parity: ``deepspeed_tpu_torch.ops.paged_attention`` against the JAX
package's ``paged_attention_xla`` on the CPU (the Pallas path stays off:
``_FORCE_INTERPRET`` is left as it is), plus the wrapper's dispatch rules.

Inputs come from numpy with a fixed seed and go to both packages. Float32
throughout; tolerance atol = rtol = 2e-5, the JAX package's own
Pallas-vs-XLA tolerance (tests/test_paged_attention.py): both sides compute
the same einsums in fp32 and differ only in summation order.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import paged_attention as jpa
from deepspeed_tpu_torch.ops import paged_attention as tpa
import torch_cpu  # noqa: F401  (one torch thread: see the module)

ATOL = RTOL = 2e-5


def _case(seed, N, C, H, KH, D, bs, MB, ctx_lens, n_pad=0):
    """Pools + disjoint shuffled tables; entries past each context are -1;
    ``n_pad`` padded rows (n_tokens = 0, tables all -1) follow."""
    rng = np.random.default_rng(seed)
    NB = sum(-(-c // bs) for c in ctx_lens) + 3
    rows = N + n_pad
    q = rng.standard_normal((rows, C, H, D)).astype(np.float32)
    kp = rng.standard_normal((NB, KH, bs, D)).astype(np.float32)
    vp = rng.standard_normal((NB, KH, bs, D)).astype(np.float32)
    perm = rng.permutation(NB)
    tables = np.full((rows, MB), -1, np.int32)
    start = np.zeros(rows, np.int32)
    ntok = np.zeros(rows, np.int32)
    pos = 0
    for i, ctx in enumerate(ctx_lens):
        nblk = -(-ctx // bs)
        tables[i, :nblk] = perm[pos:pos + nblk]
        pos += nblk
        n = min(C, ctx)
        start[i], ntok[i] = ctx - n, n
    return q, kp, vp, tables, start, ntok


def _both(arrs, alibi=False, window=0, sm_scale=None):
    q, kp, vp, tables, start, ntok = arrs
    H = q.shape[2]
    slopes = (np.asarray([2.0 ** (-8.0 * (i + 1) / H) for i in range(H)],
                         np.float32) if alibi else None)
    ref = jpa.paged_attention_xla(
        *(jnp.asarray(a) for a in arrs),
        alibi_slopes=None if slopes is None else jnp.asarray(slopes),
        window=window, sm_scale=sm_scale)
    out = tpa.paged_attention(
        *(torch.from_numpy(a) for a in arrs),
        alibi_slopes=None if slopes is None else torch.from_numpy(slopes),
        window=window, sm_scale=sm_scale)
    return np.asarray(ref), out.numpy(), ntok


CASES = [
    # G = H / KH, C, ctx lens, padded rows, alibi, window
    pytest.param(4, 4, 1, [1, 17, 50], 1, False, 0, id="decode-G1"),
    pytest.param(8, 4, 1, [5, 33, 64], 2, False, 0, id="decode-G2"),
    pytest.param(8, 2, 1, [3, 40, 64], 0, False, 0, id="decode-G4"),
    pytest.param(4, 4, 5, [5, 23, 60], 1, False, 0, id="chunk5-G1"),
    pytest.param(8, 4, 5, [4, 30, 63], 1, False, 0, id="chunk5-G2"),
    pytest.param(8, 2, 5, [5, 9, 64], 1, False, 0, id="chunk5-G4"),
    pytest.param(8, 2, 5, [5, 38, 64], 1, True, 0, id="chunk5-G4-alibi"),
    pytest.param(4, 4, 1, [7, 50], 1, True, 0, id="decode-G1-alibi"),
    pytest.param(8, 2, 5, [5, 38, 64], 1, False, 12, id="chunk5-G4-window"),
    pytest.param(8, 4, 1, [20, 64], 1, True, 9, id="decode-G2-alibi-window"),
]


@pytest.mark.parametrize("H,KH,C,ctx_lens,n_pad,alibi,window", CASES)
def test_matches_xla(H, KH, C, ctx_lens, n_pad, alibi, window):
    arrs = _case(0, len(ctx_lens), C, H, KH, 16, 8, 8, ctx_lens, n_pad)
    ref, out, ntok = _both(arrs, alibi=alibi, window=window)
    for i in range(len(ntok)):
        # valid rows; test_every_row_matches_jax holds every row
        v = int(ntok[i])
        np.testing.assert_allclose(out[i, :v], ref[i, :v], atol=ATOL,
                                   rtol=RTOL)


def test_sm_scale_override_matches_xla():
    arrs = _case(1, 2, 3, 8, 2, 16, 8, 8, [9, 30])
    ref, out, ntok = _both(arrs, sm_scale=1.0)
    for i in range(2):
        np.testing.assert_allclose(out[i, :ntok[i]], ref[i, :ntok[i]],
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window", [0, 5, 20])
def test_clamp_tables_matches_jax(window):
    rng = np.random.default_rng(window)
    tables = rng.integers(-1, 40, (5, 8)).astype(np.int32)
    start = np.asarray([0, 3, 17, 40, 0], np.int32)
    ntok = np.asarray([1, 5, 5, 9, 0], np.int32)
    ref = jpa._clamp_tables(jnp.asarray(tables), jnp.asarray(start + ntok),
                            8, jnp.asarray(start), window)
    out = tpa._clamp_tables(torch.from_numpy(tables),
                            torch.from_numpy(start + ntok), 8,
                            torch.from_numpy(start), window)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out.dtype == torch.int32 and int(out.min()) >= 0


def test_cpu_tensor_runs_plain_version_without_nvcc(monkeypatch):
    """A CPU tensor takes the plain version because it lies on the CPU — the
    kernel build is never reached (this machine has no nvcc)."""
    from deepspeed_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("the kernel build must not run for CPU tensors")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    arrs = [torch.from_numpy(a) for a in _case(2, 2, 1, 4, 2, 16, 8, 4,
                                                 [3, 20])]
    out = tpa.paged_attention(*arrs)
    ref = tpa.paged_attention_torch(*arrs)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert tpa.launches == 0


def test_import_needs_no_nvcc():
    code = ("import sys; import deepspeed_tpu_torch.ops.paged_attention; "
            "assert 'deepspeed_tpu_torch.ops._build' not in sys.modules")
    env = {"PATH": "/nonexistent", "NVCC": "/nonexistent/nvcc",
           "PYTHONPATH": ":".join(sys.path)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No silent fallback: the kernel's own entry point raises on a CPU
    tensor instead of running the plain version."""
    arrs = [torch.from_numpy(a) for a in _case(3, 1, 1, 4, 2, 16, 8, 4, [5])]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tpa.paged_attention_cuda(*arrs)



def _mixed_case(seed, C, H, KH, D, bs, ctx_lens, chunks):
    """A SplitFuse put: sequence i brings ``chunks[i]`` tokens ending at its
    context ``ctx_lens[i]`` into a C-wide chunk (the first a full prompt
    chunk, the rest one decode token each)."""
    q, kp, vp, tables, start, ntok = _case(seed, len(ctx_lens), C, H, KH, D,
                                           bs, -(-max(ctx_lens) // bs) + 1,
                                           ctx_lens)
    ntok = np.minimum(np.asarray(chunks, np.int32), ntok)
    start = np.asarray(ctx_lens, np.int32) - ntok
    return q, kp, vp, tables, start, ntok


@pytest.mark.parametrize("window", [0, 40])
def test_mixed_put_matches_xla(window):
    """The bucketed SplitFuse shape the tensor-core route serves: one
    sequence's full chunk beside sequences of one token (the valid rows;
    rows past n_tokens are held by ``test_every_row_matches_jax``)."""
    arrs = _mixed_case(4, 16, 8, 2, 16, 8, [64, 5, 17, 33], [16, 1, 1, 1])
    ref, out, ntok = _both(arrs, window=window)
    assert list(ntok) == [16, 1, 1, 1]
    for i in range(len(ntok)):
        v = int(ntok[i])
        np.testing.assert_allclose(out[i, :v], ref[i, :v], atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("C,H,KH,D,dtype,route", [
    (1, 32, 8, 128, torch.bfloat16, 3),      # decode, G = 4
    (4, 32, 8, 128, torch.bfloat16, 3),      # G * C = 16
    (5, 32, 8, 128, torch.bfloat16, 2),      # G * C = 20
    (256, 32, 8, 128, torch.bfloat16, 2),    # a prefill chunk
    (64, 8, 8, 64, torch.bfloat16, 2),       # D = 64, G = 1
    (64, 8, 8, 80, torch.bfloat16, 1),       # other D
    (64, 32, 8, 128, torch.float32, 1),      # fp32
    (1, 8, 8, 256, torch.float32, 0),
    (1, 8, 8, 64, torch.bfloat16, 3),        # decode at D = 64, G = 1
    (2, 16, 2, 64, torch.bfloat16, 3),       # G * C = 16 at D = 64
    (1, 32, 2, 128, torch.bfloat16, 3),      # G = 16
    (1, 64, 2, 128, torch.bfloat16, 2),      # G = 32: G * C > 16
    (3, 32, 8, 128, torch.bfloat16, 3),      # G * C = 12
    (1, 32, 8, 96, torch.bfloat16, 0),       # other D keeps the CUDA cores
    (1, 32, 8, 128, torch.float32, 0),       # fp32 decode
    (4, 32, 8, 64, torch.float32, 0),        # fp32, G * C = 16
    (64, 32, 8, 64, torch.float32, 1),       # fp32 prefill
    (17, 8, 8, 128, torch.bfloat16, 2),      # bf16, G * C = 17
])
def test_route_choice(C, H, KH, D, dtype, route):
    """Which __global__ function a call takes is a function of its shapes
    (the pool type does not enter): bf16 decode groups (G * C <= 16) at D =
    64 or 128 the split-KV kernel, bf16 prefill at D = 64 or 128 the
    tensor-core kernel, fp32 and other D the CUDA-core kernel (one row a
    warp for decode groups, 8 rows a warp otherwise)."""
    assert tpa.paged_route(C, H, KH, D, dtype) == route
    assert tpa.PAGED_ROUTES[route].startswith(
        ("paged_attention_kernel", "paged_attention_kernel",
         "paged_prefill_tc_kernel", "paged_decode_split_kernel")[route])


SPLIT_EDGE_CASES = [
    # H, KH, C, bs, ctx lens, padded rows, alibi, window
    pytest.param(8, 2, 1, 16, [255, 257, 777, 1000], 1, False, 0,
                 id="spans-not-a-multiple-of-the-piece"),
    pytest.param(8, 2, 1, 16, [50, 257, 1000], 0, False, 100,
                 id="window-shorter-than-a-piece"),
    pytest.param(8, 2, 1, 16, [1, 300, 600], 1, False, 1,
                 id="window-1-one-live-position"),
    pytest.param(8, 2, 1, 128, [129, 900, 1100], 3, False, 512,
                 id="bs128-padded-rows-window"),
    pytest.param(8, 2, 4, 16, [4, 60, 700], 1, False, 300,
                 id="16-rows-C4-G4-window"),
    pytest.param(16, 2, 2, 16, [2, 90, 600], 1, True, 0,
                 id="16-rows-C2-G8-alibi"),
]


@pytest.mark.parametrize("H,KH,C,bs,ctx_lens,n_pad,alibi,window",
                         SPLIT_EDGE_CASES)
def test_split_route_edge_shapes_match_xla(H, KH, C, bs, ctx_lens, n_pad,
                                           alibi, window):
    """The plain version that the card holds the split-KV route against, at
    that route's edge shapes (the same kinds of spans as the card's cases,
    narrower): live spans not a multiple of the 256-position piece, windows
    shorter than a piece and of one position, bs = 128 tables with padded
    rows, and 16-row groups. Valid rows match ``paged_attention_xla`` (rows
    past n_tokens are held by ``test_every_row_matches_jax``)."""
    MB = max(-(-c // bs) for c in ctx_lens) + 1
    arrs = _case(5 + len(ctx_lens), len(ctx_lens), C, H, KH, 16, bs, MB,
                 ctx_lens, n_pad)
    ref, out, ntok = _both(arrs, alibi=alibi, window=window)
    for i in range(len(ntok)):
        v = int(ntok[i])
        np.testing.assert_allclose(out[i, :v], ref[i, :v], atol=ATOL,
                                   rtol=RTOL)


PAD_ROW_CASES = [
    # H, KH, C, ctx lens, padded sequences, alibi, window
    pytest.param(8, 2, 5, [3, 38, 64], 2, False, 0,
                 id="chunk5-short-and-padded"),
    pytest.param(8, 2, 8, [2, 30, 45], 1, True, 3,
                 id="chunk8-alibi-rows-past-the-window"),
    pytest.param(16, 2, 2, [1, 40], 1, False, 0, id="16-rows-C2-G8"),
    pytest.param(8, 4, 16, [5, 17, 33], 1, False, 40,
                 id="bucket16-window"),
]


def _attends(start, ntok, C, window):
    """[N, C]: whether row (n, ci) attends at least one KV position."""
    qp = start[:, None] + np.arange(C)[None, :]
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    hi = np.minimum(qp + 1, (start + ntok)[:, None])
    return hi > lo


@pytest.mark.parametrize("H,KH,C,ctx_lens,n_pad,alibi,window", PAD_ROW_CASES)
def test_every_row_matches_jax(H, KH, C, ctx_lens, n_pad, alibi, window):
    """Rows past n_tokens belong to the contract: a MoE put routes them and
    its capacity counts them, so the card's kernel is held to the plain
    version on every row. Every row (past n_tokens, further than the window
    past the context, and every row of a padded sequence) matches
    ``paged_attention_xla``; the rows that attend a position match the
    Pallas kernel in interpret mode too. Where a row attends nothing the
    two JAX versions differ (the Pallas kernel writes 0, the XLA reference
    the mean of V over the gathered slots); the port gives the XLA
    reference's, which is what the JAX package computes off the TPU."""
    MB = max(-(-c // 8) for c in ctx_lens) + 1
    arrs = _case(11 + len(ctx_lens), len(ctx_lens), C, H, KH, 16, 8, MB,
                 ctx_lens, n_pad)
    ref, out, ntok = _both(arrs, alibi=alibi, window=window)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    slopes = (jnp.asarray([2.0 ** (-8.0 * (i + 1) / H) for i in range(H)],
                          jnp.float32) if alibi else None)
    pallas = np.asarray(jpa._paged_pallas(
        *(jnp.asarray(a) for a in arrs), alibi_slopes=slopes, window=window,
        interpret=True))
    live = _attends(arrs[4], ntok, C, window)
    past = np.arange(C)[None, :] >= ntok[:, None]
    assert (live & past).any() and (~live).any()
    np.testing.assert_allclose(out[live], pallas[live], atol=ATOL, rtol=RTOL)
