// Blockwise dequantization, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/quantizer.py::_dequant_kernel (:142), the Pallas
// kernel that _dequantize_pallas (:172) drives, and takes the whole contract
// of dequantize_blockwise (:246) for int8 codes, which the Pallas kernel
// covers only in part (n % block == 0, n % 128 == 0, rows % 8 == 0): int8 q
// [rows, n] and float32 scales [rows, ceil(n / block)] in; any rows, any n, a
// ragged last group; bf16, fp16 or fp32 out.
//
// What it computes, bit for bit as the plain version
// (deepspeed_tpu_torch/ops/quantizer.py::_dequantize_torch, itself bit for
// bit the JAX _dequantize_xla :118): for each element of group g of its row,
//   out = round_to_out_type((float)q * scale[row, g])
// one IEEE fp32 product (__fmul_rn: no contraction can change it) and one
// rounding to nearest even into the output type (none for fp32). The file is
// built without --use_fast_math.
//
// What bounds it on an H100: bytes. It reads one byte of q and writes 2 or 4
// bytes of output an element (plus one f32 scale a group) with one multiply:
// far below the ~295 flop/byte at which arithmetic would be the limit. At
// MISTRAL_7B's w_in [4096, 14336] int8 -> bf16 that is 178.0 MB, 0.0531 ms
// at 3.35 TB/s.
//
// What this design does about it (simple first): the tensors are taken flat
// ([rows * n] elements, rows contiguous), and each thread of a grid-stride
// loop takes 16 consecutive elements: one 16-byte load of q, two (bf16,
// fp16) or four (fp32) 16-byte stores, neighbouring threads on neighbouring
// addresses. A chunk may cross a group or a row; the thread tracks its
// column and reads a new scale only where a group ends (the scale is read
// once per group and chunk, from L1/L2). The last chunk of the tensor, if
// short, is done element by element.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;          // elements a thread takes per step
constexpr long long kMaxBlocks = 4096;

// 16 fp32 values rounded to T and written with 16-byte stores (dst 16-byte
// aligned): bf16 and fp16 as pairs packed into 32-bit words.
__device__ __forceinline__ void store16(float* dst, const float (&v)[kChunk]) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < kChunk / 4; ++i)
    d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16, float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}
__device__ __forceinline__ uint32_t pack2(__half, float a, float b) {
  return (uint32_t)__half_as_ushort(__float2half_rn(a)) |
         ((uint32_t)__half_as_ushort(__float2half_rn(b)) << 16);
}
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float (&v)[kChunk]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < kChunk / 8; ++i)
    d[i] = make_uint4(pack2(T(), v[8 * i], v[8 * i + 1]),
                      pack2(T(), v[8 * i + 2], v[8 * i + 3]),
                      pack2(T(), v[8 * i + 4], v[8 * i + 5]),
                      pack2(T(), v[8 * i + 6], v[8 * i + 7]));
}

__device__ __forceinline__ void put(float* o, float v) { *o = v; }
__device__ __forceinline__ void put(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(__half* o, float v) { *o = __float2half_rn(v); }

// byte i (0..15) of a 16-byte word, as a signed code
__device__ __forceinline__ float code(const int4& w, int i) {
  const int word = i < 4 ? w.x : i < 8 ? w.y : i < 12 ? w.z : w.w;
  return static_cast<float>(static_cast<int8_t>((word >> (8 * (i & 3))) & 0xff));
}

// Steps (row, col) on to the next element of the flat tensor; where that
// element opens a group, sets gend to the group's end and loads its scale.
__device__ __forceinline__ void advance(long long& row, int& col, int& gend,
                                        float& s, const float* __restrict__ scales,
                                        int n, int block, int groups) {
  if (++col != gend) return;
  if (col == n) {
    col = 0;
    ++row;
  }
  const int g = col / block;
  gend = min((g + 1) * block, n);
  s = scales[row * groups + g];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  T* __restrict__ out, long long total, int n, int block,
                  int groups) {
  const long long chunks = (total + kChunk - 1) / kChunk;
  for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x; c < chunks;
       c += (long long)gridDim.x * kThreads) {
    const long long e0 = c * kChunk;
    long long row = e0 / n;
    int col = (int)(e0 - row * n);
    const int g = col / block;
    int gend = min((g + 1) * block, n);
    float s = scales[row * groups + g];
    const int len = (int)min((long long)kChunk, total - e0);
    // no advance past the chunk's last element: past the tensor's last one
    // there is no scale to load
    if (len < kChunk) {              // the tensor's short last chunk
      for (int i = 0; i < len; ++i) {
        put(out + e0 + i, __fmul_rn(static_cast<float>(q[e0 + i]), s));
        if (i + 1 < len) advance(row, col, gend, s, scales, n, block, groups);
      }
      continue;
    }
    const int4 w = *reinterpret_cast<const int4*>(q + e0);
    float v[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      v[i] = __fmul_rn(code(w, i), s);
      if (i + 1 < kChunk) advance(row, col, gend, s, scales, n, block, groups);
    }
    store16(out + e0, v);
  }
}

template <typename T>
cudaError_t launch(const void* q, const float* scales, void* out, long long rows,
                   int n, int block, cudaStream_t stream) {
  const int groups = (n + block - 1) / block;
  const long long total = rows * n;
  const long long chunks = (total + kChunk - 1) / kChunk;
  const long long want = (chunks + kThreads - 1) / kThreads;
  const unsigned nblocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  dequantize_kernel<T><<<nblocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), scales, static_cast<T*>(out), total, n, block,
      groups);
  return cudaGetLastError();
}

}  // namespace

// q [rows, n] int8 and scales [rows, ceil(n / block)] float32, contiguous, q
// and out 16-byte aligned; out [rows, n] (out_dtype 0 = float32, 1 =
// bfloat16, 2 = float16). Returns a cudaError_t.
extern "C" int dequantize(const void* q, const void* scales, void* out,
                          long long rows, int n, int block, int out_dtype,
                          void* stream) {
  if (rows < 0 || n <= 0 || block <= 0 || out_dtype < 0 || out_dtype > 2 ||
      (reinterpret_cast<uintptr_t>(q) & 15) || (reinterpret_cast<uintptr_t>(out) & 15))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const float* s = static_cast<const float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch<float>(q, s, out, rows, n, block, st);
    case 1: return launch<__nv_bfloat16>(q, s, out, rows, n, block, st);
    default: return launch<__half>(q, s, out, rows, n, block, st);
  }
}
