"""Paged (block-table) attention — the FastGen serving hot op, on PyTorch.

Counterpart of ``deepspeed_tpu/ops/paged_attention.py``:

- ``paged_attention_torch`` is the plain PyTorch version, the counterpart of
  ``paged_attention_xla`` (:236): gather the block table into a dense
  context and mask it. Same masks (causal over the pool, context length,
  ALiBi ``slope·kv_pos``, window) and the same dtypes (scores in fp32, p
  cast back to q's dtype before the product with V). Quantized pools
  (int8 or float8_e4m3fn) come with ``k_scale``/``v_scale`` [NB, KH] f32;
  the gathered context is dequantized in fp32 and cast back to q's dtype,
  as the XLA reference does (:255-259).
- ``_clamp_tables`` (:140) states which table blocks the kernel skips.
- ``paged_attention`` dispatches on the tensor's device: a CPU tensor runs
  the plain version; a CUDA tensor launches the hand-written kernel
  ``csrc/paged_attention.cu`` (the counterpart of the Pallas
  ``_paged_kernel``, both its bf16/fp32 and its int8/fp8 branch) or raises.
  There is no fallback between them. ``paged_route`` picks the kernel's
  ``__global__`` function from the shapes (bf16 decode as a split-KV walk
  with a combine kernel, bf16 prefill chunks on the tensor cores, fp32 and
  other head sizes on the CUDA cores).
  ``force_reference`` (keyword, or the module hook ``FORCE_REFERENCE``)
  pins the plain version on the card, for comparisons only.

``launches`` counts the wrapper's kernel calls (a plain integer; set it to
0 before a run and read it after): one a call, whichever route it takes
(the split-KV route launches two kernels in that call). The count is
exact when serving replica threads launch at once: ``_count_launch``
increments it under a lock.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

NEG_INF = -1e30

# Test-only hook: run the plain version on CUDA tensors too (a comparison
# run pins it; serving never sets it).
FORCE_REFERENCE = False
launches = 0
_launch_lock = threading.Lock()


def _count_launch() -> None:
    """Add one to ``launches`` (a ``+=`` on a module global is not atomic
    across threads)."""
    global launches
    with _launch_lock:
        launches += 1


# ----------------------------------------------------------- plain version

def _clamp_tables(block_tables, ctx_len, block_size, start_pos=None,
                  window=0):
    """Replace dead/unallocated table entries with the sequence's nearest
    live block id — the statement of which blocks the kernel skips. Dead
    entries are those past the context length and, with a sliding window,
    those wholly before ``start_pos − window + 1``. Negative entries map to
    block 0, as the JAX version's ``jnp.maximum(tbl, 0)``."""
    N, MB = block_tables.shape
    live_blocks = torch.clamp(-(-ctx_len // block_size), min=1)     # [N]
    cols = torch.arange(MB, device=block_tables.device)[None, :]
    last_live = torch.clamp(live_blocks - 1, 0, MB - 1)[:, None]
    idx = torch.minimum(cols, last_live)
    if window and start_pos is not None:
        first_live = torch.clamp(
            torch.div(start_pos - window + 1, block_size,
                      rounding_mode="floor"), 0, MB - 1)[:, None]
        idx = torch.maximum(idx, first_live)
    tbl = torch.gather(block_tables, 1, idx.long())
    return torch.clamp(tbl, min=0).to(torch.int32)


def paged_attention_torch(q, k_pool, v_pool, block_tables, start_pos,
                          n_tokens, alibi_slopes=None, window: int = 0,
                          sm_scale=None, k_scale=None, v_scale=None):
    """Dense-gather formulation: gather the table into [N, KH, MB·bs, D]
    and mask (``paged_attention_xla``). Rows with ``ci >= n_tokens`` are
    unspecified. ``k_scale``/``v_scale`` [NB, KH]: per-(block, KV head)
    scales of quantized pools, gathered through the same table."""
    N, C, H, D = q.shape
    NB, KH, bs, _ = k_pool.shape
    G = H // KH
    MB = block_tables.shape[1]
    sm_scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    dev = q.device

    ctx_positions = torch.arange(MB * bs, device=dev)
    tbl = torch.clamp(block_tables.long(), min=0)
    # pool [NB, KH, bs, D] -> [N, MB, KH, bs, D] -> [N, KH, MB*bs, D]
    k_ctx, v_ctx = k_pool[tbl], v_pool[tbl]
    if k_scale is not None:
        k_ctx = (k_ctx.float()
                 * k_scale[tbl][:, :, :, None, None]).to(q.dtype)
        v_ctx = (v_ctx.float()
                 * v_scale[tbl][:, :, :, None, None]).to(q.dtype)
    k_ctx = k_ctx.permute(0, 2, 1, 3, 4).reshape(N, KH, MB * bs, D)
    v_ctx = v_ctx.permute(0, 2, 1, 3, 4).reshape(N, KH, MB * bs, D)

    qg = q.reshape(N, C, KH, G, D)
    s = torch.einsum("nckgd,nksd->nkgcs", qg, k_ctx).float() * sm_scale
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev).reshape(KH, G)
        s = s + (slopes[None, :, :, None, None]
                 * ctx_positions[None, None, None, None, :].float())
    start_pos = start_pos.long()
    ctx_len = (start_pos + n_tokens.long())[:, None]
    qpos = start_pos[:, None] + torch.arange(C, device=dev)[None, :]  # [N, C]
    causal = (qpos[:, None, None, :, None]
              >= ctx_positions[None, None, None, None, :])
    valid = (ctx_positions[None, :] < ctx_len)[:, None, None, None, :]
    keep = causal & valid
    if window:
        keep = keep & (qpos[:, None, None, :, None]
                       - ctx_positions[None, None, None, None, :] < window)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("nkgcs,nksd->nckgd", p, v_ctx)
    return o.reshape(N, C, H, D)


# ------------------------------------------------------------------ kernel

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODE = {torch.int8: 2, torch.float8_e4m3fn: 3}


# The routes of ``csrc/paged_attention.cu``, by the C entry point's code:
# the __global__ function (and its query rows a warp) each one launches.
PAGED_ROUTES = ("paged_attention_kernel<1 row a warp>",
                "paged_attention_kernel<8 rows a warp>",
                "paged_prefill_tc_kernel",
                "paged_decode_split_kernel")


def paged_route(C: int, H: int, KH: int, D: int, q_dtype) -> int:
    """The route (an index into ``PAGED_ROUTES``) that a call takes, from
    its shapes alone. A (sequence, KV head) group of G·C <= 16 query rows
    (decode) in bf16 at D = 64 or 128 (the served widths; any pool type)
    takes the split-KV kernel, a larger group the tensor-core prefill
    kernel. fp32 and other D take the CUDA-core kernel: one row a warp for
    a decode group, so that every warp of a block gets a row, 8 rows a warp
    otherwise."""
    decode = (H // KH) * C <= 16
    if q_dtype == torch.bfloat16 and D in (64, 128):
        return 3 if decode else 2
    return 0 if decode else 1


def _bind():
    from . import _build

    lib = _build.load("paged_attention")
    fn = lib.paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_decode_splits.argtypes = [ctypes.c_int] * 4
        lib.paged_decode_splits.restype = ctypes.c_longlong
    return lib, fn


def paged_attention_cuda(q, k_pool, v_pool, block_tables, start_pos,
                         n_tokens, alibi_slopes=None, window: int = 0,
                         sm_scale=None, k_scale=None, v_scale=None):
    """Launch ``csrc/paged_attention.cu`` on CUDA tensors; raises on
    anything it does not take (no fallback). int8/float8_e4m3fn pools need
    their ``k_scale``/``v_scale`` [NB, KH] float32 planes."""
    N, C, H, D = q.shape
    NB, KH, bs, Dk = k_pool.shape
    MB = block_tables.shape[1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got {dev}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("start_pos", start_pos),
                    ("n_tokens", n_tokens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"k_pool is {k_pool.dtype}, v_pool {v_pool.dtype}")
    quant = k_pool.dtype in _POOL_CODE
    if not quant and k_pool.dtype != q.dtype:
        raise TypeError(f"KV pools must be q's dtype ({q.dtype}), int8 or "
                        f"float8_e4m3fn; got {k_pool.dtype}")
    if quant != (k_scale is not None and v_scale is not None):
        raise ValueError("int8/fp8 pools take k_scale and v_scale, and only "
                         "they do")
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (t.device != dev or t.dtype != torch.float32
                    or t.shape != (NB, KH) or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous float32 "
                                 f"[{NB}, {KH}] tensor on {dev}")
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if D % 8 or D > 256 or KH <= 0 or H % KH:
        raise ValueError(f"kernel shape contract: D % 8 == 0, D <= 256 and "
                         f"H % KH == 0; got D={D}, H={H}, KH={KH}")
    if (block_tables.dtype != torch.int32 or start_pos.dtype != torch.int32
            or n_tokens.dtype != torch.int32):
        raise TypeError("block_tables, start_pos and n_tokens must be int32")
    if block_tables.shape[0] != N or start_pos.shape != (N,) \
            or n_tokens.shape != (N,):
        raise ValueError("block_tables [N, MB], start_pos and n_tokens [N]")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("the KV pools must be contiguous (a copy of a pool "
                         "per call would dominate the step)")
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    if N == 0 or C == 0:
        return out
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    start_pos = start_pos.contiguous()
    n_tokens = n_tokens.contiguous()
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=dev).contiguous()
        if slopes.shape != (H,):
            raise ValueError(f"alibi_slopes must be [H={H}]")
    sm_scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    lib, fn = _bind()
    from ._build import check

    route = paged_route(C, H, KH, D, q.dtype)
    window = int(window or 0)
    ws = None
    if route == 3:
        # the pieces' partials, (m, l) and acc [N, KH, n_split, G·C, D] in
        # fp32; the kernel's source decides the split count
        n_split = lib.paged_decode_splits(MB, bs, C, window)
        ws = torch.empty(N * KH * n_split * (H // KH) * C * (D + 2),
                         dtype=torch.float32, device=dev)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr() if quant else None,
             v_scale.data_ptr() if quant else None,
             block_tables.data_ptr(), start_pos.data_ptr(),
             n_tokens.data_ptr(),
             slopes.data_ptr() if slopes is not None else None,
             out.data_ptr(), ws.data_ptr() if ws is not None else None,
             N, C, H, D, NB, KH, bs, MB, window,
             sm_scale, _DTYPE_CODE[q.dtype],
             _POOL_CODE[k_pool.dtype] if quant else 0, route,
             torch.cuda.current_stream(dev).cuda_stream)
    check(lib, err, "paged_attention_fwd")
    _count_launch()
    return out


# ------------------------------------------------------------------ public

def paged_attention(q, k_pool, v_pool, block_tables, start_pos, n_tokens,
                    alibi_slopes=None, window: int = 0, sm_scale=None,
                    k_scale=None, v_scale=None,
                    force_reference: bool = False):
    """Block-table paged attention.

    q [N, C, H, D]; k/v pool [NB, KH, bs, D]; block_tables [N, MB] int32
    (entries < 0 = unallocated); start_pos/n_tokens [N] int32. The pool
    must already hold this chunk's K/V (write-then-attend). ``alibi_slopes``
    [H]: ALiBi slopes; ``window`` > 0: sliding window; ``k_scale``/
    ``v_scale`` [NB, KH] f32: the scales of int8/fp8 pools. Rows beyond
    n_tokens are unspecified (the kernel writes zeros there). A CPU tensor
    runs ``paged_attention_torch``; a CUDA tensor runs the kernel or
    raises.
    """
    kw = dict(alibi_slopes=alibi_slopes, window=window, sm_scale=sm_scale,
              k_scale=k_scale, v_scale=v_scale)
    dev = q.device.type
    if dev == "cpu" or (dev == "cuda" and (force_reference or FORCE_REFERENCE)):
        return paged_attention_torch(q, k_pool, v_pool, block_tables,
                                     start_pos, n_tokens, **kw)
    if dev == "cuda":
        return paged_attention_cuda(q, k_pool, v_pool, block_tables,
                                    start_pos, n_tokens, **kw)
    raise ValueError(f"paged_attention runs on cpu or cuda, not {dev}")
