"""Blockwise int8/int4/fp8 quantization and the quantized matmul, on PyTorch.

Counterpart of ``deepspeed_tpu/ops/quantizer.py``. Format: for ``x[..., N]``
with block size ``B``, ``q[..., N]`` (int8, or ``float8_e4m3fn`` with
``dtype="fp8_e4m3"``) and ``scales[..., ceil(N/B)]`` float32 with
``x ≈ q * scales`` (symmetric, no zero point). A ragged last group
(``N % B != 0``) is quantized against its own amax.

- ``_quantize_torch`` / ``_dequantize_torch`` are the plain versions, the
  counterparts of ``_quantize_xla`` (:98) and ``_dequantize_xla`` (:118),
  bit for bit: ``scale = amax / qmax``, ``inv = 1 / scale`` (0 for an
  all-zero group), ``q = clip(round(x * inv))`` with round half to even;
  fp8 clips to ±448 and casts (round to nearest even).
- ``quantize_blockwise`` launches ``csrc/quantize.cu`` (replaces the Pallas
  ``_quant_kernel`` :130) on a CUDA tensor, bit-identical to the plain
  version; ``quant_route`` picks its ``__global__`` function from the
  shapes (16-byte loads for bf16 weight leaves, a warp a group otherwise).
- ``quantized_matmul`` launches ``csrc/quantized_matmul.cu`` (replaces
  ``_qmm_kernel`` :257) on a CUDA tensor; its plain version is the XLA
  branch (dequantize in fp32, then an fp32 product). ``qmm_route`` picks
  the kernel's ``__global__`` function from the shapes (at the serving
  shapes the tensor-core decode kernel or the wgmma kernel, otherwise
  weight streaming at decode, mma.sync or CUDA cores).
- ``dequantize_blockwise`` launches ``csrc/dequantize.cu`` (replaces
  ``_dequant_kernel`` :142) on a CUDA tensor: int8 codes, any shape, a
  ragged last group, bf16, fp16 or fp32 out, bit-identical to the plain
  version. Other codes (fp8, packed int4) raise there: a caller unpacks
  int4 first (``unpack_int4``), as the JAX package does.

Dispatch follows the port's rule: a CPU tensor runs the plain version; a
CUDA tensor launches the kernel or raises, with no fallback between them.
``FORCE_REFERENCE`` pins the plain version on the card, for comparisons
only. ``launches`` counts each kernel's wrapper calls that launched it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

#: max finite magnitude of float8_e4m3fn; group scale = amax / FP8_MAX
FP8_MAX = 448.0

# Test-only hook: run the plain versions on CUDA tensors too (a comparison
# run pins it; serving never sets it).
FORCE_REFERENCE = False
launches = {"quantize": 0, "quantized_matmul": 0, "dequantize": 0}

_Q_DTYPES = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}


def qmax(bits: int) -> int:
    """Symmetric range limit: 127 for int8, 7 for int4."""
    return (1 << (bits - 1)) - 1


def choose_block(n: int, want: int = 128) -> int:
    """Largest divisor of n that is <= want (quant groups must tile the dim)."""
    b = min(want, n)
    while n % b != 0:
        b -= 1
    return b


def _pad_tail(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad the last dim up to a multiple of ``block``."""
    rem = x.shape[-1] % block
    if rem == 0:
        return x
    return torch.nn.functional.pad(x, (0, block - rem))


def _infer_block(n: int, n_groups: int, block: Optional[int]) -> int:
    """The block size of a (q, scales) pair: ``block`` when given, else the
    divisor layout ``N / groups``. A ragged layout must pass its block."""
    if block:
        return block
    if n % n_groups != 0:
        raise ValueError(
            f"cannot infer block size for N={n} with {n_groups} scale "
            "groups (ragged-tail layout) — pass the block= it was "
            "quantized with")
    return n // n_groups


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` rounded once, as IEEE division (and the JAX package)
    does. A tensor divided by a Python number on the card is computed as
    ``x * (1 / d)``, which is another rounding; dividing by a tensor of
    ``d`` is not."""
    return x / torch.full_like(x, d)


def _use_reference(t: torch.Tensor) -> bool:
    dev = t.device.type
    if dev == "cpu" or (dev == "cuda" and FORCE_REFERENCE):
        return True
    if dev == "cuda":
        return False
    raise ValueError(f"quantizer ops run on cpu or cuda, not {dev}")


# ----------------------------------------------------------- plain versions

def _quantize_torch(x, bits: int, block: int, dtype: str = "int8"):
    n = x.shape[-1]
    xp = _pad_tail(x.float(), block)
    lead, np_ = xp.shape[:-1], xp.shape[-1]
    nb = np_ // block
    xb = xp.reshape(*lead, nb, block)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    lim = FP8_MAX if dtype == "fp8_e4m3" else float(qmax(bits))
    scale = true_div(amax, lim)
    inv = torch.where(scale > 0, torch.reciprocal(scale),
                      torch.zeros_like(scale))
    if dtype == "fp8_e4m3":
        q = torch.clamp(xb * inv, -lim, lim).to(torch.float8_e4m3fn)
    else:
        q = torch.clamp(torch.round(xb * inv), -lim, lim).to(torch.int8)
    q = q.reshape(*lead, np_)[..., :n]
    return q, scale[..., 0].reshape(*lead, nb)


def _dequantize_torch(q, scales, block: int, dtype=torch.float32):
    n = q.shape[-1]
    qp = _pad_tail(q.float(), block)
    lead, np_ = qp.shape[:-1], qp.shape[-1]
    nb = np_ // block
    out = qp.reshape(*lead, nb, block) * scales.float().reshape(*lead, nb, 1)
    return out.reshape(*lead, np_)[..., :n].to(dtype)


def _quantized_matmul_torch(x, q, scales, block: int, out_dtype):
    w = _dequantize_torch(q, scales, block, torch.float32)
    return (x.float() @ w).to(out_dtype)


# ------------------------------------------------------------------ kernels

_X_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_Q_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}


def _bind(name: str, argtypes):
    from . import _build

    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _check_cuda(**tensors):
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        dev = t.device
    return dev


# The routes of ``csrc/quantize.cu``, by the C entry point's code.
QUANT_ROUTES = ("quantize_kernel", "quantize_vec_kernel")


def quant_route(n: int, block: int, x_dtype, aligned: bool = True) -> int:
    """The route (an index into ``QUANT_ROUTES``) that a quantization of
    rows of ``n`` values takes, from its shapes alone. ``aligned``: x starts
    on a 16-byte boundary.

    - bf16 x whose groups tile each row (``n % block == 0``) with a
      power-of-two block of 8 to 256 values, aligned: the kernel with
      16-byte loads, ``block / 8`` lanes a group (every weight leaf the
      engines quantize).
    - anything else (fp32 x, a ragged last group, other blocks, unaligned
      x): a warp a group.
    """
    if (x_dtype == torch.bfloat16 and aligned and n % block == 0
            and 8 <= block <= 256 and block & (block - 1) == 0):
        return 1
    return 0


def quantize_cuda(x, bits: int, block: int, dtype: str = "int8"):
    """Launch ``csrc/quantize.cu`` on a CUDA tensor x[..., N]."""
    dev = _check_cuda(x=x)
    if x.dtype not in _X_CODE:
        raise TypeError(f"quantize kernel takes float32 or bfloat16 input, "
                        f"got {x.dtype}")
    if dtype not in _Q_DTYPES:
        raise ValueError(f"quantize dtype {dtype!r} not in {tuple(_Q_DTYPES)}")
    if dtype == "int8" and bits not in (4, 8):
        raise ValueError(f"int8 quantization takes bits 4 or 8, got {bits}")
    n = x.shape[-1]
    lead = x.shape[:-1]
    groups = -(-n // block)
    q = torch.empty(x.shape, dtype=_Q_DTYPES[dtype], device=dev)
    s = torch.empty((*lead, groups), dtype=torch.float32, device=dev)
    rows = x.numel() // n if n else 0
    if rows == 0 or n == 0:
        return q, s
    x2 = x.contiguous()
    route = quant_route(n, block, x.dtype, x2.data_ptr() % 16 == 0)
    lib, fn = _bind("quantize", [ctypes.c_void_p] * 3 + [ctypes.c_int64]
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    from ._build import check

    err = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), rows, n, block,
             bits, _X_CODE[x.dtype], _Q_CODE[q.dtype], route,
             torch.cuda.current_stream(dev).cuda_stream)
    check(lib, err, "quantize")
    launches["quantize"] += 1
    return q, s


def dequantize_cuda(q, scales, block: int, dtype=torch.float32):
    """Launch ``csrc/dequantize.cu`` on CUDA tensors: int8 q[..., N] and
    float32 scales[..., ceil(N/B)] -> q * scale in ``dtype``."""
    dev = _check_cuda(q=q, scales=scales)
    if q.dtype != torch.int8:
        raise TypeError(f"dequantize kernel takes int8 codes (unpack int4 "
                        f"first), got {q.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    if dtype not in _OUT_CODE:
        raise TypeError(f"dequantize kernel writes float32, bfloat16 or "
                        f"float16, not {dtype}")
    if q.dim() == 0 or block <= 0:
        raise ValueError(f"q must have a last dim and block > 0; got shape "
                         f"{tuple(q.shape)}, block {block}")
    n = q.shape[-1]
    lead = tuple(q.shape[:-1])
    if tuple(scales.shape) != lead + (-(-n // block),):
        raise ValueError(f"scales {tuple(scales.shape)} do not match q "
                         f"{tuple(q.shape)} at block {block} (want "
                         f"{lead + (-(-n // block),)})")
    out = torch.empty(q.shape, dtype=dtype, device=dev)
    rows = q.numel() // n if n else 0
    if rows == 0:
        return out
    q2 = q.contiguous()
    if q2.data_ptr() % 16:              # the kernel loads q 16 bytes at a time
        q2 = q2.clone()
    s2 = scales.contiguous()
    lib, fn = _bind("dequantize", [ctypes.c_void_p] * 3 + [ctypes.c_int64]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    from ._build import check

    err = fn(q2.data_ptr(), s2.data_ptr(), out.data_ptr(), rows, n, block,
             _OUT_CODE[dtype], torch.cuda.current_stream(dev).cuda_stream)
    check(lib, err, "dequantize")
    launches["dequantize"] += 1
    return out


# The routes of ``csrc/quantized_matmul.cu``, by the C entry point's code:
# the __global__ function each one launches.
QMM_ROUTES = ("qmm_gemv_kernel", "qmm_kernel", "qmm_mma_kernel",
              "qmm_wgmma_kernel<128>", "qmm_wgmma_kernel<256>",
              "qmm_decode_tc_kernel")
# decode-sized M: at most this many rows (two n8 halves of the tensor-core
# decode kernel, the largest row tile of the weight-streaming one)
_QMM_SMALL_M = 16


def qmm_route(M: int, N: int, K: int, block: int, x_dtype,
              aligned: bool = True, sms: int = 132) -> int:
    """The route (an index into ``QMM_ROUTES``) that a call takes, from its
    shapes alone. ``aligned``: x and q start on 16-byte boundaries.

    - bf16 x with N, K and the scale block multiples of 64 (every serving
      projection: wq/wo, wk/wv, w_in/w_out, lm_head) and aligned pointers:
      at M <= 16 (decode) the tensor-core decode kernel, K split over a
      thread-block cluster; above, the wgmma kernel, 256 rows of x a block
      when that still gives at least one block an SM (``sms``), else 128
      (wk/wv at M = 2048).
    - other calls at M <= 16: the weight-streaming kernel, K split over the
      grid; other bf16 x: the mma.sync kernel; fp32 x: the CUDA-core tile.
    """
    serving = (x_dtype == torch.bfloat16 and aligned and N % 64 == 0
               and K % 64 == 0 and block % 64 == 0)
    if M <= _QMM_SMALL_M:
        return 5 if serving else 0
    if serving:
        return 4 if -(-N // 128) * -(-M // 256) >= sms else 3
    return 2 if x_dtype == torch.bfloat16 else 1


def quantized_matmul_cuda(x, q, scales, block: int, out_dtype):
    """Launch ``csrc/quantized_matmul.cu``: x[..., K] @ dequant(q, s)."""
    dev = _check_cuda(x=x, q=q, scales=scales)
    if x.dtype not in _X_CODE:
        raise TypeError(f"quantized matmul takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if q.dtype not in _Q_CODE:
        raise TypeError(f"quantized matmul takes int8 or float8_e4m3fn "
                        f"weights, got {q.dtype}")
    if out_dtype not in _X_CODE:
        raise TypeError(f"quantized matmul writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if scales.dtype != torch.float32:
        raise TypeError("scales must be float32")
    K, N = q.shape
    G = -(-N // block)
    if x.shape[-1] != K or scales.shape != (K, G):
        raise ValueError(f"shapes: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scales {tuple(scales.shape)} (want [{K}, {G}])")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("q and scales must be contiguous (a copy of a "
                         "weight per call would dominate the step)")
    lead = x.shape[:-1]
    M = x.numel() // K if K else 0
    out = torch.empty((*lead, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    x2 = x.reshape(M, K).contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    route = qmm_route(M, N, K, block, x.dtype,
                      x2.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0, sms)
    # route 0: split K so that the grid puts about six blocks (of 512
    # columns) on each SM, at least 64 rows of K and at most 64 splits; each
    # split writes an fp32 partial and a second kernel sums them into
    # ``out``. Route 5 sums its K slices on chip (no scratch).
    splits = 0
    if route == 0:
        col_blocks = -(-N // 512)
        splits = max(1, min(-(-6 * sms // col_blocks), K // 64, 64))
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
          if splits > 1 else out)
    lib, fn = _bind("quantized_matmul", [ctypes.c_void_p] * 5
                    + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    from ._build import check

    err = fn(x2.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(),
             ws.data_ptr(), M, N, K, block, splits, route, _X_CODE[x.dtype],
             _Q_CODE[q.dtype], _X_CODE[out_dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    check(lib, err, "quantized_matmul")
    launches["quantized_matmul"] += 1
    return out


# ------------------------------------------------------------------- public

def quantize_blockwise(x, bits: int = 8, block: Optional[int] = None,
                       dtype: str = "int8") -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """x[..., N] → (q [..., N], scales f32 [..., ceil(N/B)]).

    ``dtype="int8"``: symmetric int8 (int4 values with ``bits=4``, one per
    int8 slot; :func:`pack_int4` halves them). ``dtype="fp8_e4m3"``:
    float8_e4m3fn payload with ``scale = amax / 448``. A ragged ``block``
    must be passed again to ``dequantize_blockwise``/``quantized_matmul``.
    """
    n = x.shape[-1]
    block = block or choose_block(n)
    if _use_reference(x):
        return _quantize_torch(x, bits, block, dtype)
    return quantize_cuda(x, bits, block, dtype)


def dequantize_blockwise(q, scales, block: Optional[int] = None,
                         dtype=torch.float32):
    """``q[..., N] * scales[..., ceil(N/B)]`` (each scale over B adjacent
    columns) in ``dtype``: one fp32 product and one rounding an element."""
    block = _infer_block(q.shape[-1], scales.shape[-1], block)
    if _use_reference(q):
        return _dequantize_torch(q, scales, block, dtype)
    return dequantize_cuda(q, scales, block, dtype)


def quantized_matmul(x, q, scales, block: Optional[int] = None,
                     out_dtype=None):
    """``x[..., K] @ dequant(q[K, N], scales[K, ceil(N/B)])`` with fp32
    accumulation — the weight-serving hot op."""
    out_dtype = out_dtype or x.dtype
    block = _infer_block(q.shape[-1], scales.shape[-1], block)
    if _use_reference(x):
        return _quantized_matmul_torch(x, q, scales, block, out_dtype)
    return quantized_matmul_cuda(x, q, scales, block, out_dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7], even last dim → packed uint8 [..., N/2]
    (low nibble = even index)."""
    lo = q[..., 0::2].to(torch.int32) & 0xF
    hi = (q[..., 1::2].to(torch.int32) & 0xF) << 4
    return (lo | hi).to(torch.uint8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → int8 [..., N*2]. Each nibble is
    sign-extended by an arithmetic right shift of an int8 view (the low one
    shifted up first), so every pass moves one byte an element; v1 decode
    unpacks every int4 weight each forward."""
    p = p.to(torch.uint8)
    lo = (p << 4).view(torch.int8) >> 4
    hi = p.view(torch.int8) >> 4
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)
