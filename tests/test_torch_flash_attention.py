"""Port parity: ``deepspeed_tpu_torch.ops.flash_attention`` against the JAX
package's ``ops/flash_attention.py`` on the CPU.

The same q, k, v and upstream gradient, made from a seed with numpy, go
through both. The port's plain forward (``_attention_torch``) is held
against ``_attention_xla`` (o) and a numpy logsumexp (lse); its plain
backward (``_dq_torch``, ``_dkv_torch``) and the ``autograd.Function`` built
on the three are held against ``jax.vjp`` of ``_attention_xla``, which is
what the JAX package differentiates off the TPU, and against the Pallas
kernels themselves in interpret mode at T = S = 128 and 256. On the CPU the
Function uses the plain versions, so these tests exercise the wiring and
the formulas the card runs. Tolerances: fp32 1e-5 (both sides compute in
fp32 and differ in summation order only), bf16 2e-2 (a few roundings of
2^-8 at values of order 1). The bf16 backward is held against the vjp taken
in fp32 on the bf16-rounded inputs: the port's backward (plain and kernel)
keeps p, dp and ds in fp32 as the Pallas kernels do, while XLA's bf16 vjp
rounds each of them to bf16, so the fp32 vjp is what both approximate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

CASES = {
    # name: B, T, S, H, KH, D, causal, window, sm_scale
    "mha-causal": (2, 24, 24, 4, 4, 16, True, 0, None),
    "gqa-8-2": (1, 33, 33, 8, 2, 16, True, 0, None),
    "mqa": (1, 20, 20, 4, 1, 8, True, 0, None),
    "cross-length": (1, 9, 30, 4, 2, 16, True, 0, None),
    "non-causal": (2, 12, 19, 4, 2, 16, False, 0, None),
    "window-1": (1, 16, 16, 4, 2, 16, True, 1, None),
    "window-5": (1, 40, 40, 4, 2, 16, True, 5, None),
    "window-cross": (1, 10, 25, 4, 2, 16, True, 7, None),
    "window-wide": (1, 16, 16, 4, 2, 16, True, 100, None),
    "sm-scale-1": (1, 16, 16, 4, 2, 8, True, 0, 1.0),
    "d-80": (1, 12, 12, 2, 1, 80, True, 0, None),
    # the edges of the card's tiles, at small widths: a sequence one past a
    # 128-row tile, a window of 127 across two tiles, T < S with a window
    # across a tile, and a group of 8 query heads over one KV head
    "tile-plus-one": (1, 129, 129, 4, 2, 16, True, 0, None),
    "window-127-two-tiles": (1, 200, 200, 4, 2, 16, True, 127, None),
    "window-t-lt-s": (1, 70, 200, 4, 2, 16, True, 90, None),
    "gqa-8-1": (1, 40, 40, 8, 1, 16, True, 0, None),
}


def _inputs(case, seed=0):
    B, T, S, H, KH, D = case[:6]
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = mk(B, T, H, D)
    if case[8] is not None:
        # keep the logits at a few units, where the bf16 tolerance holds
        q = q / np.float32(case[8] * np.sqrt(D))
    return q, mk(B, S, KH, D), mk(B, S, KH, D), mk(B, T, H, D)


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().numpy()


def _jax_reference(arrs, dtype, causal, window, sm_scale, compute=None):
    """o and (dq, dk, dv) from ``_attention_xla`` and its vjp, on inputs
    rounded to ``dtype`` and computed in ``compute`` (default ``dtype``)."""
    q, k, v, do = (jnp.asarray(a, getattr(jnp, dtype)).astype(
        getattr(jnp, compute or dtype)) for a in arrs)
    o, vjp = jax.vjp(
        lambda q, k, v: jfa._attention_xla(q, k, v, causal, window, sm_scale),
        q, k, v)
    return [np.asarray(x, np.float32) for x in (o,) + tuple(vjp(do))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_matches_attention_xla(name, dtype):
    case = CASES[name]
    causal, window, sm_scale = case[6:]
    arrs = _inputs(case)
    ref_o = _jax_reference(arrs, dtype, causal, window, sm_scale)[0]
    q, k, v, _ = (_t(a, dtype) for a in arrs)
    o, lse = tfa._attention_torch(q, k, v, causal, window, sm_scale)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(o), ref_o, atol=TOL[dtype],
                               rtol=TOL[dtype])
    # lse against a numpy logsumexp over the attended columns
    B, T, S, H, KH, D = case[:6]
    scale = 1.0 / np.sqrt(D) if sm_scale is None else sm_scale
    qf, kf = _np(q), np.repeat(_np(k), H // KH, axis=2)
    s = np.einsum("bthd,bshd->bhts", qf, kf) * scale
    rows = np.arange(T)[:, None] + (S - T)
    cols = np.arange(S)[None, :]
    keep = np.ones((T, S), bool)
    if causal:
        keep &= rows >= cols
    if window:
        keep &= rows - cols < window
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    ref_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(_np(lse), ref_lse, atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_vjp_of_attention_xla(name, dtype):
    case = CASES[name]
    args = case[6:]
    arrs = _inputs(case, seed=1)
    _, ref_dq, ref_dk, ref_dv = _jax_reference(arrs, dtype, *args,
                                               compute="float32")
    q, k, v, do = (_t(a, dtype) for a in arrs)
    o, lse = tfa._attention_torch(q, k, v, *args)
    dq = tfa._dq_torch(q, k, v, o, do, lse, *args)
    dk, dv = tfa._dkv_torch(q, k, v, o, do, lse, *args)
    assert dq.dtype == q.dtype and dk.dtype == k.dtype
    assert dk.shape == k.shape and dv.shape == v.shape
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        np.testing.assert_allclose(_np(got), ref, atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("name", ["gqa-8-2", "cross-length", "non-causal",
                                  "window-5", "sm-scale-1"])
def test_function_backward_matches_vjp_of_attention_xla(name):
    """The public ``flash_attention`` under autograd: its forward and its
    hand-written backward, wired through ``torch.autograd.Function``."""
    case = CASES[name]
    causal, window, sm_scale = case[6:]
    arrs = _inputs(case, seed=2)
    ref = _jax_reference(arrs, "float32", causal, window, sm_scale)
    q, k, v, do = (_t(a, "float32") for a in arrs)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal, window=window,
                            sm_scale=sm_scale)
    o.backward(do)
    for got, want in zip([o] + [t.grad for t in leaves], ref):
        np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)
    # and against autograd through the plain forward
    leaves2 = [_t(a, "float32").requires_grad_() for a in arrs[:3]]
    o2, _ = tfa._attention_torch(*leaves2, causal, window, sm_scale)
    o2.backward(do)
    for a, b in zip(leaves, leaves2):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), atol=1e-5,
                                   rtol=1e-5)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)


@pytest.mark.parametrize("T,H,KH,window", [(128, 4, 2, 0), (256, 4, 4, 0),
                                           (256, 2, 1, 100),
                                           (256, 4, 1, 100)])
def test_plain_versions_match_pallas_kernels_in_interpret_mode(
        pallas_interpret, T, H, KH, window):
    """The three Pallas kernels themselves (``_fwd_kernel``, ``_dq_kernel``,
    ``_dkv_kernel``), run in interpret mode as the JAX package's own tests
    run them on the CPU, against the port's plain forward and backward."""
    case = (1, T, T, H, KH, 16, True, window, None)
    arrs = _inputs(case, seed=3)
    q, k, v, do = (jnp.asarray(a) for a in arrs)
    assert jfa._pallas_enabled(q, k, 128, 128)
    o, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, True, 128, 128, window), q, k, v)
    ref = [np.asarray(x) for x in (o,) + tuple(vjp(do))]
    tq, tk, tv, tdo = (_t(a, "float32") for a in arrs)
    to, lse = tfa._attention_torch(tq, tk, tv, True, window)
    dq = tfa._dq_torch(tq, tk, tv, to, tdo, lse, True, window)
    dk, dv = tfa._dkv_torch(tq, tk, tv, to, tdo, lse, True, window)
    for got, want in zip((to, dq, dk, dv), ref):
        np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sm_scale", [None, 1.0, 0.0])
@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_route_by_type_width_and_scale(dtype, D, sm_scale):
    """The route the C entries are told to take: the wgmma kernels for bf16
    at D = 64 or 128 with a positive scale, the CUDA-core kernels for every
    other call."""
    route = tfa.flash_route(getattr(torch, dtype), D, sm_scale)
    assert route in tfa.FLASH_ROUTES
    wgmma = dtype == "bfloat16" and D in (64, 128) and sm_scale != 0.0
    assert route == ("wgmma" if wgmma else "cuda_core")


def test_contract_errors_and_counters():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="sliding window requires causal"):
        tfa.flash_attention(q, q, q, causal=False, window=3)
    with pytest.raises(ValueError, match="H % KH"):
        tfa.flash_attention(torch.zeros((1, 4, 3, 8)), q, q)
    # a CPU tensor never reaches a kernel wrapper; the wrappers refuse one
    before = dict(tfa.launches)
    tfa.flash_attention(q, q, q)
    assert tfa.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd_cuda(q, q, q, True)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_delta_cuda(q, q)
    # block sizes are accepted and ignored, as the signature promises
    a = tfa.flash_attention(q + 1, q, q, True, 128, 64)
    b = tfa.flash_attention(q + 1, q, q, True)
    assert torch.equal(a, b)
