"""Flash attention — the training attention hot op, on PyTorch.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py``:

- ``_attention_torch`` is the plain PyTorch forward, the counterpart of
  ``_attention_xla`` (:419): grouped einsum over the [KH, group] head
  factorization (no KV repeat), logits in fp32, probabilities cast back to
  q's dtype before ``p @ v``. It also returns ``lse = logsumexp(s)`` per
  (batch, head, row), the residual the backward needs.
- ``_dq_torch`` and ``_dkv_torch`` are the plain backward, dense and not
  through autograd, by the formulas of the Pallas ``_dq_kernel`` (:148) and
  ``_dkv_kernel`` (:190): ``p = exp(s·scale − lse)``, ``δ = rowsum(do ∘ o)``,
  ``ds = p ∘ (do·vᵀ − δ)·scale``, ``dq = ds·k``, ``dk = dsᵀ·q`` and
  ``dv = pᵀ·do`` summed over the query heads of each KV head.
- ``flash_attention`` is a ``torch.autograd.Function``. On CPU tensors its
  forward and backward are the three plain functions above, so the CPU tests
  exercise the same wiring and formulas as the card. On CUDA tensors the
  forward launches the forward kernel and the backward launches
  ``flash_delta_kernel`` (δ once, as a pre-pass), then the dq and dkv
  kernels of ``csrc/flash_attention.cu`` — or raises. There is no fallback
  between them. ``FORCE_REFERENCE`` pins the plain versions on the card,
  for comparisons only.

Two routes (``FLASH_ROUTES``; ``flash_route`` picks one from the type, D and
``sm_scale``, and the C entries refuse a route the call does not meet):
bf16 with D = 64 or 128 and a positive scale runs every product on the
tensor cores with ``wgmma`` (``flash_fwd_wgmma_kernel``,
``flash_dq_wgmma_kernel``, ``flash_dkv_wgmma_kernel``; fp32 accumulation, p
and ds rounded to bf16 for the second product as the plain forward rounds
p; ``sm_scale`` multiplies the fp32 logits); fp32, fp16 (the engine's
``fp16.enabled``), bf16 at any other D and any ``sm_scale <= 0`` run in fp32
on the CUDA cores (``flash_fwd_kernel``, ``flash_dq_kernel``,
``flash_dkv_kernel``: there the forward folds ``sm_scale`` into q before the
product and the backward scales the logits after it, as the Pallas kernels
do; in fp32 the two differ by rounding only). The kernels index [B, T, H, D]
directly (no head-major copies), take any T and S and any D with D % 8 == 0
up to 256. ``block_q``/``block_kv`` stay in the signature for the JAX
callers' sake and are ignored: the CUDA kernels pick their own tiles.

``launches`` counts kernel launches by kernel (``fwd``, ``delta``, ``dq``,
``dkv``; plain integers: set them to 0 before a run and read them after).
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

# Test-only hook: run the plain versions on CUDA tensors too (a comparison
# run pins it; training never sets it).
FORCE_REFERENCE = False
launches = {"fwd": 0, "delta": 0, "dq": 0, "dkv": 0}


# ---------------------------------------------------------- plain versions

def _scale(D, sm_scale):
    return 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)


def _keep_mask(T, S, causal, window, device):
    """[T, S] bool: which (row, column) pairs attend; None when all do."""
    if not causal and not window:
        return None
    qpos = torch.arange(T, device=device)[:, None] + (S - T)
    kpos = torch.arange(S, device=device)[None, :]
    keep = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        keep &= qpos >= kpos
    if window:
        keep &= qpos - kpos < window
    return keep


def _attention_torch(q, k, v, causal: bool, window: int = 0, sm_scale=None):
    """Plain attention; returns (o [B, T, H, D] as q, lse [B, H, T] fp32)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = _scale(D, sm_scale)
    qg = q.reshape(B, T, KH, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k).float() * scale
    keep = _keep_mask(T, S, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)                          # [B, KH, G, T]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgts,bskd->btkgd", p, v)
    return o.reshape(B, T, H, D), lse.reshape(B, H, T)


def _p_ds(q, k, v, o, do, lse, causal, window, sm_scale):
    """The backward's dense intermediates in fp32, [B, KH, G, T, S]:
    ``p = exp(s·scale − lse)`` (0 where masked) and ``ds = p ∘ (dp − δ)·
    scale``."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = _scale(D, sm_scale)
    qg = q.float().reshape(B, T, KH, G, D)
    dog = do.float().reshape(B, T, KH, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    p = torch.exp(s - lse.reshape(B, KH, G, T)[..., None])
    keep = _keep_mask(T, S, causal, window, q.device)
    if keep is not None:
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = torch.einsum("btkgd,bskd->bkgts", dog, v.float())
    delta = (do.float() * o.float()).sum(-1)                  # [B, T, H]
    delta = delta.reshape(B, T, KH, G).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta) * scale
    return p, ds, qg, dog


def _dq_torch(q, k, v, o, do, lse, causal: bool, window: int = 0,
              sm_scale=None):
    """dq [B, T, H, D] as q, from the saved output and row statistics."""
    _, ds, _, _ = _p_ds(q, k, v, o, do, lse, causal, window, sm_scale)
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def _dkv_torch(q, k, v, o, do, lse, causal: bool, window: int = 0,
               sm_scale=None):
    """(dk, dv) [B, S, KH, D] as k, summed over each KV head's group."""
    p, ds, qg, dog = _p_ds(q, k, v, o, do, lse, causal, window, sm_scale)
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qg)
    dv = torch.einsum("bkgts,btkgd->bskd", p, dog)
    return dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_VP = ctypes.c_void_p
# B, T, S, H, KH, D, causal, window, scale, dtype, route, stream
_SHAPE_ARGS = [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] * 2 \
    + [_VP]
_ARGTYPES = {
    "flash_attention_fwd": [_VP] * 5 + _SHAPE_ARGS,
    "flash_attention_delta": [_VP] * 3 + [ctypes.c_int] * 5 + [_VP],
    "flash_attention_dq": [_VP] * 7 + _SHAPE_ARGS,
    "flash_attention_dkv": [_VP] * 8 + _SHAPE_ARGS,
}


# The routes of ``csrc/flash_attention.cu``'s C entries, by their code.
FLASH_ROUTES = ("cuda_core", "wgmma")


def flash_route(dtype, D: int, sm_scale) -> str:
    """The route (a name in ``FLASH_ROUTES``) that the forward, dq and dkv
    kernels take, from the type, the head width and the scale alone: bf16
    at D = 64 or 128 (the trained and served widths) with a positive scale
    takes the ``wgmma`` kernels; every other call the CUDA-core kernels,
    which compute in fp32 (the wgmma forward folds the scale into a base-2
    exponent and takes the row maximum of the raw logits)."""
    if dtype == torch.bfloat16 and D in (64, 128) and _scale(D, sm_scale) > 0:
        return "wgmma"
    return "cuda_core"


def _bind(name):
    from . import _build

    lib = _build.load("flash_attention")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _check_shapes(q, k, v, causal, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B, T, H, D] and k, v [B, S, KH, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[2] <= 0 \
            or H % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} (same B and D, H % KH == 0)")
    if window and not causal:
        raise ValueError("sliding window requires causal attention")


def _kernel_inputs(q, k, v, causal, window, *more):
    """Validate what the kernels take and return contiguous, 16-byte
    aligned tensors. Raises on anything else (no fallback)."""
    _check_shapes(q, k, v, causal, window)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash kernels need CUDA tensors, got {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the flash kernels take float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    B, T, H, D = q.shape
    S = k.shape[1]
    if D % 8 or D > 256:
        raise ValueError(f"kernel shape contract: D % 8 == 0 and D <= 256; "
                         f"got D={D}")
    if B == 0 or T == 0 or S == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if causal and T > S:
        raise ValueError(f"causal attention with T={T} > S={S}: the first "
                         "rows would attend nothing")
    out = []
    for t in (q, k, v) + more:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, q on {dev}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    for t in out[:3] + [m for m in out[3:] if m.dim() == 4]:
        if t.dtype != q.dtype:
            raise TypeError(f"q is {q.dtype}, another operand {t.dtype}")
    return out


def _shape_args(q, k, causal, window, sm_scale):
    B, T, H, D = q.shape
    route = FLASH_ROUTES.index(flash_route(q.dtype, D, sm_scale))
    return (B, T, k.shape[1], H, k.shape[2], D, int(bool(causal)),
            int(window or 0), _scale(D, sm_scale), _DTYPE_CODE[q.dtype],
            route, torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd_cuda(q, k, v, causal: bool, window: int = 0, sm_scale=None):
    """Launch the forward kernel of ``flash_route``'s route; returns (o as
    q, lse [B, H, T] fp32)."""
    from ._build import check

    q, k, v = _kernel_inputs(q, k, v, causal, window)
    B, T, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib, fn = _bind("flash_attention_fwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), *_shape_args(q, k, causal, window, sm_scale))
    check(lib, err, "flash_attention_fwd")
    launches["fwd"] += 1
    return o, lse


def flash_delta_cuda(o, do):
    """Launch ``flash_delta_kernel``: δ = rowsum(do ∘ o), [B, H, T] fp32."""
    from ._build import check

    if o.device.type != "cuda" or o.dtype not in _DTYPE_CODE \
            or do.dtype != o.dtype or do.shape != o.shape or o.dim() != 4:
        raise ValueError("flash_delta_cuda takes two CUDA tensors [B, T, H, "
                         "D] of one type: float32, bfloat16 or float16")
    o, do = o.contiguous(), do.contiguous()
    B, T, H, D = o.shape
    delta = torch.empty((B, H, T), dtype=torch.float32, device=o.device)
    lib, fn = _bind("flash_attention_delta")
    err = fn(o.data_ptr(), do.data_ptr(), delta.data_ptr(), B, T, H, D,
             _DTYPE_CODE[o.dtype],
             torch.cuda.current_stream(o.device).cuda_stream)
    check(lib, err, "flash_attention_delta")
    launches["delta"] += 1
    return delta


def _stats(q, lse, delta):
    B, T, H, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, T) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [B, H, T] = "
                             f"{(B, H, T)}, got {t.dtype} {tuple(t.shape)}")


def flash_dq_cuda(q, k, v, do, lse, delta, causal: bool, window: int = 0,
                  sm_scale=None):
    """Launch the dq kernel of ``flash_route``'s route; returns dq as q."""
    from ._build import check

    q, k, v, do, lse, delta = _kernel_inputs(q, k, v, causal, window, do,
                                             lse, delta)
    _stats(q, lse, delta)
    dq = torch.empty_like(q)
    lib, fn = _bind("flash_attention_dq")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             *_shape_args(q, k, causal, window, sm_scale))
    check(lib, err, "flash_attention_dq")
    launches["dq"] += 1
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, causal: bool, window: int = 0,
                   sm_scale=None):
    """Launch the dkv kernel of ``flash_route``'s route; returns (dk, dv)
    as k."""
    from ._build import check

    q, k, v, do, lse, delta = _kernel_inputs(q, k, v, causal, window, do,
                                             lse, delta)
    _stats(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib, fn = _bind("flash_attention_dkv")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             *_shape_args(q, k, causal, window, sm_scale))
    check(lib, err, "flash_attention_dkv")
    launches["dkv"] += 1
    return dk, dv


def flash_bwd_cuda(q, k, v, o, do, lse, causal: bool, window: int = 0,
                   sm_scale=None):
    """The backward on the card: δ once, then dq and (dk, dv)."""
    delta = flash_delta_cuda(o, do)
    dq = flash_dq_cuda(q, k, v, do, lse, delta, causal, window, sm_scale)
    dk, dv = flash_dkv_cuda(q, k, v, do, lse, delta, causal, window,
                            sm_scale)
    return dq, dk, dv


# ------------------------------------------------------------------- public

def _use_reference(t) -> bool:
    dev = t.device.type
    if dev == "cpu":
        return True
    if dev == "cuda":
        return FORCE_REFERENCE
    raise ValueError(f"flash_attention runs on cpu or cuda, not {dev}")


class _FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); the residuals are q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale):
        reference = _use_reference(q)
        fwd = _attention_torch if reference else flash_fwd_cuda
        o, lse = fwd(q, k, v, causal, window, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.attn_args = (causal, window, sm_scale)
        ctx.reference = reference
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        args = ctx.attn_args
        if ctx.reference:
            dq = _dq_torch(q, k, v, o, do, lse, *args)
            dk, dv = _dkv_torch(q, k, v, o, do, lse, *args)
        else:
            dq, dk, dv = flash_bwd_cuda(q, k, v, o, do, lse, *args)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_kv: int = 512, window: int = 0, sm_scale=None):
    """Blocked flash attention with a hand-written backward.

    q: [B, T, H, D]; k/v: [B, S, KH, D] with H % KH == 0 (GQA/MQA).
    ``window`` > 0: sliding window (query position p attends key positions
    (p − window, p]; requires ``causal=True``). Causal masking with T != S
    aligns the last query row with the last key (``row + (S − T) >= col``).
    A CPU tensor runs the plain versions; a CUDA tensor runs the kernels or
    raises. ``block_q``/``block_kv`` are accepted and ignored.
    """
    del block_q, block_kv
    _check_shapes(q, k, v, causal, window)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window or 0),
                                 sm_scale)
