"""Port parity: ``deepspeed_tpu_torch.ops.quantizer`` against the JAX
package's ``ops/quantizer.py`` on the CPU, plus the wrappers' dispatch
rules.

Inputs come from numpy with a fixed seed and go to both packages.

- Quantization must be bit-identical to ``_quantize_xla`` (codes compared
  as bytes, scales exactly equal): the plain version repeats its arithmetic
  operation for operation (IEEE division and reciprocal, round half to
  even, the fp8 cast's round to nearest even).
- Against the Pallas ``_quant_kernel`` in interpret mode the codes are
  equal and the scales agree to rtol 1e-6, the tolerance the JAX package
  holds its own kernel to (``tests/test_quantizer.py``).
- Dequantization is one fp32 product per element on both sides: exact,
  against ``_dequantize_xla`` and against the Pallas ``_dequant_kernel`` in
  interpret mode, for int8 and unpacked int4 codes, ragged last groups and
  float32, bfloat16 and float16 outputs.
- The quantized matmul is an fp32 product summed in another order by
  another BLAS: atol = rtol = 1e-5, as the JAX package holds its Pallas
  and XLA branches to each other.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import QMM_TOL
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.ops import quantizer as tq
import torch_cpu  # noqa: F401  (one torch thread: see the module)


def _x(seed, shape, zero_group=None, block=128, scale=None):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.05, 20.0) if scale is None else scale
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    if zero_group is not None:
        r, g = zero_group
        x[r, g * block:(g + 1) * block] = 0.0
    return x


def _bytes(q):
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy() if q.dtype != torch.int8 \
            else q.numpy().view(np.uint8)
    return np.asarray(q).view(np.uint8)


QUANT_CASES = [
    # shape, block, bits, dtype
    pytest.param((16, 256), 128, 8, "int8", id="int8"),
    pytest.param((6, 200), 128, 8, "int8", id="int8-ragged-tail"),
    pytest.param((7, 300), 64, 4, "int8", id="int4-ragged-tail"),
    pytest.param((3, 5, 96), 32, 8, "int8", id="int8-3d"),
    pytest.param((9, 256), 128, 8, "fp8_e4m3", id="fp8"),
    pytest.param((5, 130), 128, 8, "fp8_e4m3", id="fp8-ragged-tail"),
]


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,block,bits,dtype", QUANT_CASES)
def test_quantize_bit_identical_to_xla(shape, block, bits, dtype, in_dtype):
    x = _x(sum(shape) + bits, shape)
    x.reshape(-1, shape[-1])[1, :block] = 0.0          # an all-zero group
    xj = jnp.asarray(x).astype(in_dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if in_dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    qj, sj = jq._quantize_xla(xj, bits, block, dtype)
    qt, st = tq.quantize_blockwise(xt, bits=bits, block=block, dtype=dtype)
    assert qt.dtype == tq._Q_DTYPES[dtype] and st.dtype == torch.float32
    assert tuple(qt.shape) == shape
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    zero = st.reshape(-1, st.shape[-1])[1, 0]
    assert float(zero) == 0.0


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_matches_pallas_interpret(monkeypatch, bits):
    x = _x(bits, (16, 256), zero_group=(3, 1))
    qt, st = tq.quantize_blockwise(torch.from_numpy(x), bits=bits, block=128)
    monkeypatch.setattr(jq, "_FORCE_INTERPRET", True)
    qp, sp = jq.quantize_blockwise(jnp.asarray(x), bits=bits, block=128)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qp))
    np.testing.assert_allclose(st.numpy(), np.asarray(sp), rtol=1e-6)


@pytest.mark.parametrize("dtype,block,shape", [
    ("int8", 128, (8, 256)), ("int8", 128, (4, 200)),
    ("fp8_e4m3", 64, (5, 192))])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_dequantize_matches_xla_exactly(dtype, block, shape, out):
    x = _x(block, shape)
    qj, sj = jq._quantize_xla(jnp.asarray(x), 8, block, dtype)
    qt, st = tq.quantize_blockwise(torch.from_numpy(x), block=block,
                                   dtype=dtype)
    ref = jq._dequantize_xla(qj, sj, block, jnp.dtype(out))
    got = tq.dequantize_blockwise(qt, st, block=block,
                                  dtype=getattr(torch, out))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def _out_bits(t):
    """The output's bits, as integers of its width (exact comparison of
    float16/bfloat16/float32 values, NaN-safe)."""
    if isinstance(t, torch.Tensor):
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                torch.float16: torch.int16}[t.dtype]
        return t.view(view).numpy()
    a = np.asarray(t)
    return a.view({4: np.int32, 2: np.int16}[a.dtype.itemsize])


DEQUANT_CASES = [
    # shape, block, bits
    pytest.param((16, 256), 128, 8, id="int8"),
    pytest.param((8, 384), 128, 4, id="int4-unpacked"),
    pytest.param((6, 200), 128, 8, id="int8-ragged-tail"),
    pytest.param((3, 300), 64, 4, id="int4-ragged-tail-3-rows"),
    pytest.param((2, 5, 96), 32, 8, id="int8-3d"),
    pytest.param((256,), 128, 8, id="int8-one-row"),
]


@pytest.mark.parametrize("out", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape,block,bits", DEQUANT_CASES)
def test_dequantize_bit_identical_to_xla(shape, block, bits, out):
    x = _x(sum(shape) + bits, shape)
    qj, sj = jq._quantize_xla(jnp.asarray(x), bits, block)
    qt = torch.from_numpy(np.array(qj))
    st = torch.from_numpy(np.array(sj))
    ref = jq._dequantize_xla(qj, sj, block, jnp.dtype(out))
    got = tq.dequantize_blockwise(qt, st, block=block,
                                  dtype=getattr(torch, out))
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == shape
    np.testing.assert_array_equal(_out_bits(got), _out_bits(ref))


@pytest.mark.parametrize("out", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_bit_identical_to_pallas_interpret(monkeypatch, bits,
                                                      out):
    """The Pallas ``_dequant_kernel`` takes rows % 8 == 0 and n % 128 ==
    0; on such a shape it runs (interpret mode) and equals the port bit for
    bit."""
    x = _x(bits + 3, (16, 384))
    qj, sj = jq._quantize_xla(jnp.asarray(x), bits, 128)
    monkeypatch.setattr(jq, "_FORCE_INTERPRET", True)
    assert jq._pallas_2d_ok(16, 384, 128)
    ref = jq.dequantize_blockwise(qj, sj, block=128, dtype=jnp.dtype(out))
    got = tq.dequantize_blockwise(torch.from_numpy(np.array(qj)),
                                  torch.from_numpy(np.array(sj)), block=128,
                                  dtype=getattr(torch, out))
    np.testing.assert_array_equal(_out_bits(got), _out_bits(ref))


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("M,K,N,block", [
    (8, 64, 256, 128), (3, 40, 200, 128), (1, 96, 64, 32)])
def test_quantized_matmul_matches_xla(dtype, M, K, N, block):
    w = _x(K + N, (K, N), scale=1.0)
    x = _x(M, (M, K), scale=1.0)
    qj, sj = jq.quantize_blockwise(jnp.asarray(w), block=block, dtype=dtype)
    qt, st = tq.quantize_blockwise(torch.from_numpy(w), block=block,
                                   dtype=dtype)
    ref = jq.quantized_matmul(jnp.asarray(x), qj, sj, block=block)
    got = tq.quantized_matmul(torch.from_numpy(x), qt, st, block=block)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_quantized_matmul_matches_pallas_interpret(monkeypatch):
    w = _x(1, (64, 256), scale=1.0)
    x = _x(2, (8, 64), scale=1.0)
    qt, st = tq.quantize_blockwise(torch.from_numpy(w), block=128)
    monkeypatch.setattr(jq, "_FORCE_INTERPRET", True)
    qj, sj = jq.quantize_blockwise(jnp.asarray(w), block=128)
    ref = jq._qmm_pallas(jnp.asarray(x), qj, sj, 128, jnp.float32)
    got = tq.quantized_matmul(torch.from_numpy(x), qt, st)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_quantized_matmul_out_dtype_and_leading_dims():
    w = _x(3, (32, 64))
    x = _x(4, (2, 3, 32))
    qt, st = tq.quantize_blockwise(torch.from_numpy(w), block=32)
    got = tq.quantized_matmul(torch.from_numpy(x).bfloat16(), qt, st,
                              out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 64)
    dense = torch.from_numpy(x).bfloat16().float() @ tq.dequantize_blockwise(
        qt, st)
    torch.testing.assert_close(got, dense.bfloat16(), atol=0, rtol=0)


def test_int4_pack_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(-7, 8, (5, 64)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (5, 32)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)


def test_helpers_match_jax():
    for n, want in [(256, 128), (200, 128), (96, 128), (7, 4)]:
        assert tq.choose_block(n, want) == jq.choose_block(n, want)
    assert (tq.qmax(8), tq.qmax(4)) == (127, 7)
    assert tq.FP8_MAX == jq.FP8_MAX
    assert tq._infer_block(256, 2, None) == 128
    assert tq._infer_block(200, 2, 128) == 128
    with pytest.raises(ValueError, match="pass the block"):
        tq._infer_block(200, 3, None)
    with pytest.raises(ValueError, match="pass the block"):
        jq._infer_block(200, 3, None)


def test_cpu_tensors_run_plain_versions_without_nvcc(monkeypatch):
    """A CPU tensor takes the plain version because it lies on the CPU — the
    kernel build is never reached (this machine has no nvcc)."""
    from deepspeed_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("the kernel build must not run for CPU tensors")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    before = dict(tq.launches)
    x = torch.from_numpy(_x(5, (4, 64)))
    q, s = tq.quantize_blockwise(torch.from_numpy(_x(6, (64, 128))))
    tq.quantized_matmul(x, q, s)
    tq.dequantize_blockwise(q, s)
    assert tq.launches == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """No silent fallback: the kernels' own entry points raise on CPU
    tensors instead of running the plain versions."""
    x = torch.from_numpy(_x(6, (4, 128)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.quantize_cuda(x, 8, 128)
    q, s = tq.quantize_blockwise(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.quantized_matmul_cuda(x[:, :4].contiguous(), q[:4].contiguous(),
                                 s[:4].contiguous(), 128, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.dequantize_cuda(q, s, 128, torch.float32)


def test_dequantize_cuda_route_never_takes_plain_version(monkeypatch):
    """A tensor that takes the kernel path goes to the kernel's wrapper
    (``dequantize_cuda``), never to the plain version, and the wrapper raises
    on what is not a CUDA tensor."""
    q, s = tq.quantize_blockwise(torch.from_numpy(_x(7, (2, 128))))
    monkeypatch.setattr(tq, "_use_reference", lambda t: False)
    monkeypatch.setattr(tq, "_dequantize_torch", None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.dequantize_blockwise(q, s)


def test_import_needs_no_nvcc():
    code = ("import sys; import deepspeed_tpu_torch.ops.quantizer; "
            "assert 'deepspeed_tpu_torch.ops._build' not in sys.modules")
    env = {"PATH": "/nonexistent", "NVCC": "/nonexistent/nvcc",
           "PYTHONPATH": ":".join(sys.path)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


SERVING_SHAPES = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336),
                  (32000, 4096)]     # (N, K): wq/wo, wk/wv, w_in, w_out, lm_head


@pytest.mark.parametrize("M,N,K,block,x_dtype,aligned,route", [
    (1, 14336, 4096, 128, torch.bfloat16, True, 5),      # decode
    (16, 4096, 4096, 128, torch.float32, True, 0),
    (2048, 14336, 4096, 128, torch.bfloat16, True, 4),   # w_in, mixed put
    (2048, 4096, 4096, 128, torch.bfloat16, True, 4),    # wq / wo
    (2048, 1024, 4096, 128, torch.bfloat16, True, 3),    # wk / wv: 64 blocks
    (2048, 32000, 4096, 128, torch.bfloat16, True, 4),   # lm_head
    (2000, 4096, 14336, 128, torch.bfloat16, True, 4),   # w_out, ragged M
    (37, 14336, 4096, 128, torch.bfloat16, True, 3),
    (2048, 4100, 4096, 128, torch.bfloat16, True, 2),    # N % 64 != 0
    (512, 1536, 1024, 48, torch.bfloat16, True, 2),      # block 48
    (300, 130, 77, 64, torch.bfloat16, True, 2),         # K % 64 != 0
    (2048, 4096, 4096, 128, torch.bfloat16, False, 2),   # unaligned
    (2048, 4096, 4096, 128, torch.float32, True, 1),     # fp32 x
]
    # the tensor-core decode route: bf16 x at every serving shape
    + [(M, N, K, 128, torch.bfloat16, True, 5)
       for M in (1, 8, 16) for N, K in SERVING_SHAPES]
    + [(8, 14336, 4096, 64, torch.bfloat16, True, 5),    # block 64
       (12, 4224, 4096, 192, torch.bfloat16, True, 5),   # block 192
       (17, 14336, 4096, 128, torch.bfloat16, True, 3),  # past decode
       # the weight-streaming kernel keeps fp32 x, unaligned pointers and
       # widths that are not multiples of 64
       (1, 14336, 4096, 128, torch.float32, True, 0),
       (8, 4096, 14336, 128, torch.float32, True, 0),
       (8, 4096, 4096, 128, torch.bfloat16, False, 0),
       (8, 4100, 4096, 96, torch.bfloat16, True, 0),      # N % 64 != 0
       (8, 4096, 4160, 96, torch.bfloat16, True, 0),      # block 96
       (2, 520, 1000, 128, torch.bfloat16, True, 0),      # K % 64 != 0
       (3, 130, 300, 50, torch.bfloat16, True, 0)])
def test_qmm_route_choice(M, N, K, block, x_dtype, aligned, route):
    """Which __global__ function a call takes is a function of its shapes
    (and pointer alignment): bf16 x at the serving shapes takes the
    tensor-core decode kernel at M <= 16 and the wgmma kernel above (256
    rows of x a block where that still fills the 132 SMs); otherwise
    decode streams the weight, other bf16 shapes take mma.sync and fp32 x
    the CUDA cores."""
    assert tq.qmm_route(M, N, K, block, x_dtype, aligned, 132) == route
    assert tq.QMM_ROUTES[route].startswith(
        ("qmm_gemv_kernel", "qmm_kernel", "qmm_mma_kernel",
         "qmm_wgmma_kernel", "qmm_wgmma_kernel",
         "qmm_decode_tc_kernel")[route])


def _decode_tc_scheme(x, q, s, block):
    """The tensor-core decode route's arithmetic (``qmm_decode_tc_kernel``
    in ``csrc/quantized_matmul.cu``), in torch on the CPU: the codes as
    bf16 (exact), x' = fl32(x * s) for each K row and scale group split
    into hi = bf16(x') and lo = bf16(x' - hi), and the products of the
    codes with hi and with lo summed in fp32."""
    codes = q.float().bfloat16()
    assert torch.equal(codes.float(), q.float())       # exact in bf16
    codes = codes.float()
    M, K = x.shape
    N = q.shape[1]
    out = torch.empty((M, N), dtype=torch.float32)
    for g in range(-(-N // block)):
        cols = slice(g * block, min(N, (g + 1) * block))
        xs = x.float() * s[:, g]
        hi = xs.bfloat16().float()
        lo = (xs - hi).bfloat16().float()
        out[:, cols] = hi @ codes[:, cols] + lo @ codes[:, cols]
    return out


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("K,N", [(4096, 4096), (14336, 4096)],
                         ids=["wq", "w_out"])
def test_decode_tc_scheme_matches_xla(dtype, K, N):
    """Before any card run: the decode route's numeric scheme (scale folded
    into x, split hi + lo, fp32 sums) against the JAX package's XLA branch
    of ``quantized_matmul`` (dequantize in fp32, fp32 product) on the same
    seeded inputs at M = 8, within the tolerance the kernel is held to on
    the card (``chip_smoke.QMM_TOL``), for fp32 and for bf16 output."""
    rng = np.random.default_rng(K + N + len(dtype))
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    xj = jnp.asarray(rng.standard_normal((8, K)).astype(np.float32)).astype(
        jnp.bfloat16)
    qj, sj = jq.quantize_blockwise(jnp.asarray(w), block=128, dtype=dtype)
    del w
    qt = torch.from_numpy(np.array(qj).view(np.uint8)).view(
        tq._Q_DTYPES[dtype])
    st = torch.from_numpy(np.array(sj))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    ref = jq.quantized_matmul(xj, qj, sj, block=128, out_dtype=jnp.float32)
    got = _decode_tc_scheme(xt, qt, st, 128)
    for out, (atol, rtol) in QMM_TOL.items():
        r = torch.from_numpy(np.array(ref)).to(out).float()
        o = got.to(out).float()
        lim = atol * r.abs().max() + rtol * r.abs()
        assert ((o - r).abs() <= lim).all(), (out, (o - r).abs().max())


@pytest.mark.parametrize("n,block,x_dtype,aligned,route", [
    (14336, 128, torch.bfloat16, True, 1),    # a serving weight leaf
    (4096, 128, torch.bfloat16, True, 1),
    (4096, 64, torch.bfloat16, True, 1),
    (1024, 256, torch.bfloat16, True, 1),
    (48, 16, torch.bfloat16, True, 1),
    (64, 8, torch.bfloat16, True, 1),
    (14336, 128, torch.float32, True, 0),     # fp32 x
    (14336, 128, torch.bfloat16, False, 0),   # x off a 16-byte boundary
    (200, 128, torch.bfloat16, True, 0),      # a ragged last group
    (1024, 512, torch.bfloat16, True, 0),     # a group wider than 256
    (256, 48, torch.bfloat16, True, 0),       # block not a power of two
    (12, 4, torch.bfloat16, True, 0),         # block under 8
])
def test_quant_route_choice(n, block, x_dtype, aligned, route):
    """The quantize kernel's __global__ function is a function of the row
    width, the block, the input type and x's alignment: 16-byte loads for
    bf16 rows that power-of-two groups of 8 to 256 values tile, a warp a
    group otherwise."""
    assert tq.quant_route(n, block, x_dtype, aligned) == route
    assert tq.QUANT_ROUTES[route] == ("quantize_kernel",
                                      "quantize_vec_kernel")[route]


def test_quantized_matmul_cuda_route_never_takes_plain_version(monkeypatch):
    """A tensor that takes the kernel path goes to the kernel's wrapper
    (``quantized_matmul_cuda``), never to the plain version, and the wrapper
    raises on what is not a CUDA tensor."""
    x = torch.from_numpy(_x(8, (4, 128)))
    q, s = tq.quantize_blockwise(torch.from_numpy(_x(9, (128, 64))))
    monkeypatch.setattr(tq, "_use_reference", lambda t: False)
    monkeypatch.setattr(tq, "_quantized_matmul_torch", None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.quantized_matmul(x, q, s)
