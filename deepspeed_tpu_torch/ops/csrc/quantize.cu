// Blockwise symmetric quantization, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/quantizer.py::_quant_kernel (:130), the Pallas
// kernel that _quantize_pallas (:154) drives, and takes the whole contract of
// quantize_blockwise (:212), which the Pallas kernel covers only in part
// (int8, n % 128 == 0, rows % 8 == 0): fp32 or bf16 input x [rows, n]; bits
// 8 or 4 into int8, or float8_e4m3fn; any rows; a ragged last group.
//
// What it computes, bit for bit as the plain version
// (deepspeed_tpu_torch/ops/quantizer.py::_quantize_torch, itself bit for bit
// the JAX _quantize_xla :98). For each row and each group of `block`
// consecutive columns (the last group may be shorter):
//   amax  = max |x|                         (exact: a max of exact values)
//   scale = amax / qmax                     IEEE division, round to nearest
//   inv   = scale > 0 ? 1 / scale : 0       IEEE reciprocal, round to nearest
//   int8: q = clip(rint(x * inv), -qmax, qmax)    rint: half to even
//   fp8:  q = e4m3(clip(x * inv, -448, 448))      round to nearest even
// qmax is 127 (bits 8), 7 (bits 4) or 448 (fp8). The file is built without
// --use_fast_math, and the roundings are spelled out (__fdiv_rn, __frcp_rn,
// __fmul_rn) so that no contraction or approximation can change a bit. An
// all-zero group gives scale 0 and q 0.
//
// What bounds it on an H100: bytes. It reads x once (2 or 4 bytes an
// element) and writes q once (1 byte) plus one f32 scale per group, with a
// handful of operations per element: far below the ~295 flop/byte at which
// arithmetic would be the limit.
//
// What this design does about it. Two routes (the Python wrapper picks one
// from the shapes, ops/quantizer.py::quant_route; this entry refuses a route
// the call does not meet):
// - quantize_vec_kernel (bf16 x, groups that tile each row, a power-of-two
//   block of 8 to 256 elements, x 16-byte aligned: the engine builds' weight
//   leaves). The groups of a contiguous tensor with n % block == 0 lie end
//   to end, so the kernel walks a flat array of groups. Each lane loads 16
//   bytes (8 values) at a time, so block / 8 lanes hold a group (16 for
//   block 128: a warp covers two groups a pass), and the amax is a
//   __shfl_xor_sync reduction over those lanes. A warp issues kVecPasses
//   passes' loads before it uses any (4 x 16 bytes in flight a lane), writes
//   each lane's 8 codes as one 8-byte store and the group's scale from its
//   first lane, and the grid strides over the groups with about as many
//   blocks as the card holds at once. A warp's loads of one pass are 512
//   contiguous bytes and its stores 256.
// - quantize_kernel (every other call: fp32 x, ragged last groups, other
//   blocks, unaligned x), simple first: one warp per (row, group). Lanes
//   stride over the group, so a warp's loads of one group are contiguous;
//   the amax is a warp reduction held in registers, so x is read from device
//   memory once (a group of up to kMaxPerLane * 32 elements stays in
//   registers between the max and the quantization; a larger group is read
//   again from L2).
// Both compute each code and scale with the same operations, so they give
// the same bits.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 8;  // groups up to 256 elements stay in registers

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// int8: clip(rint(v), -qmax, qmax) -> int8 bits
__device__ __forceinline__ uint8_t encode_int8(float v, float qmax) {
  const float r = fminf(fmaxf(rintf(v), -qmax), qmax);
  return static_cast<uint8_t>(static_cast<int8_t>(r));
}

// fp8 e4m3: clip to +-448, then round to nearest even (saturating; the clip
// already keeps the value finite)
__device__ __forceinline__ uint8_t encode_fp8(float v, float qmax) {
  const float c = fminf(fmaxf(v, -qmax), qmax);
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3));
}

template <typename T, bool FP8>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_kernel(const T* __restrict__ x, uint8_t* __restrict__ q,
                float* __restrict__ scales, long long rows, int n, int block,
                int groups, float qmax) {
  const int lane = threadIdx.x & 31;
  const long long item =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= rows * groups) return;  // warp-uniform
  const long long row = item / groups;
  const int g = (int)(item - row * groups);
  const int c0 = g * block;
  const int len = min(block, n - c0);
  const T* xr = x + row * (long long)n + c0;
  uint8_t* qr = q + row * (long long)n + c0;

  float v[kMaxPerLane];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < len ? to_f32(xr[c]) : 0.f;
    amax = fmaxf(amax, fabsf(v[i]));
  }
  for (int c = lane + 32 * kMaxPerLane; c < len; c += 32)
    amax = fmaxf(amax, fabsf(to_f32(xr[c])));
  amax = warp_max(amax);

  const float scale = __fdiv_rn(amax, qmax);
  const float inv = scale > 0.f ? __frcp_rn(scale) : 0.f;
  if (lane == 0) scales[row * groups + g] = scale;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < len) {
      const float t = __fmul_rn(v[i], inv);
      qr[c] = FP8 ? encode_fp8(t, qmax) : encode_int8(t, qmax);
    }
  }
  for (int c = lane + 32 * kMaxPerLane; c < len; c += 32) {
    const float t = __fmul_rn(to_f32(xr[c]), inv);
    qr[c] = FP8 ? encode_fp8(t, qmax) : encode_int8(t, qmax);
  }
}

constexpr int kVecThreads = 256;
constexpr int kVecPasses = 4;  // passes whose loads a warp keeps in flight

// the 8 codes of one lane (8 values of x scaled by inv), one byte each
template <bool FP8>
__device__ __forceinline__ uint2 encode8(const float (&v)[8], float inv, float qmax) {
  uint32_t c[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float t = __fmul_rn(v[i], inv);
    const uint32_t b = FP8 ? encode_fp8(t, qmax) : encode_int8(t, qmax);
    c[i >> 2] |= b << (8 * (i & 3));
  }
  return make_uint2(c[0], c[1]);
}

// groups: rows * n / block, each `block` = 8 L contiguous values of x and of
// q, and one scale; grid-stride over tasks of kVecPasses passes of 32 / L
// groups a warp
template <bool FP8, int L>
__global__ void __launch_bounds__(kVecThreads)
quantize_vec_kernel(const __nv_bfloat16* __restrict__ x, uint8_t* __restrict__ q,
                    float* __restrict__ scales, long long groups, float qmax) {
  constexpr int P = 32 / L;               // groups a pass
  constexpr int TG = P * kVecPasses;      // groups a task
  const int lane = threadIdx.x & 31;
  const int sub = lane / L, part = lane % L;
  const long long tasks = (groups + TG - 1) / TG;
  const long long nwarps = (long long)gridDim.x * (kVecThreads / 32);
  for (long long task = (long long)blockIdx.x * (kVecThreads / 32) + (threadIdx.x >> 5);
       task < tasks; task += nwarps) {  // warp-uniform
    const long long g0 = task * TG + sub;
    uint4 raw[kVecPasses];
#pragma unroll
    for (int u = 0; u < kVecPasses; ++u) {
      const long long gi = g0 + u * P;
      raw[u] = gi < groups
                   ? *reinterpret_cast<const uint4*>(x + gi * (8 * L) + 8 * part)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kVecPasses; ++u) {
      const long long gi = g0 + u * P;
      const uint32_t w[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      float v[8];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);  // bf16 -> fp32, exact
        v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
        amax = fmaxf(amax, fmaxf(fabsf(v[2 * i]), fabsf(v[2 * i + 1])));
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float scale = __fdiv_rn(amax, qmax);
      const float inv = scale > 0.f ? __frcp_rn(scale) : 0.f;
      if (gi < groups) {
        *reinterpret_cast<uint2*>(q + gi * (8 * L) + 8 * part) = encode8<FP8>(v, inv, qmax);
        if (part == 0) scales[gi] = scale;
      }
    }
  }
}

template <bool FP8, int L>
cudaError_t launch_vec(const void* x, void* q, float* scales, long long groups, float qmax,
                       cudaStream_t stream) {
  auto kernel = &quantize_vec_kernel<FP8, L>;
  static int resident = 0;  // one device's worth
  if (resident == 0) {
    const cudaError_t err = resident_blocks(kernel, kVecThreads, 0, &resident);
    if (err != cudaSuccess) return err;
  }
  constexpr int TG = 32 / L * kVecPasses * (kVecThreads / 32);  // groups a block a round
  const long long want = (groups + TG - 1) / TG;
  const int nblocks = (int)(want < resident ? want : resident);
  kernel<<<nblocks, kVecThreads, 0, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                              static_cast<uint8_t*>(q), scales, groups, qmax);
  return cudaGetLastError();
}

template <bool FP8>
cudaError_t launch_vec_block(const void* x, void* q, float* scales, long long groups,
                             int block, float qmax, cudaStream_t stream) {
  switch (block) {
    case 8: return launch_vec<FP8, 1>(x, q, scales, groups, qmax, stream);
    case 16: return launch_vec<FP8, 2>(x, q, scales, groups, qmax, stream);
    case 32: return launch_vec<FP8, 4>(x, q, scales, groups, qmax, stream);
    case 64: return launch_vec<FP8, 8>(x, q, scales, groups, qmax, stream);
    case 128: return launch_vec<FP8, 16>(x, q, scales, groups, qmax, stream);
    case 256: return launch_vec<FP8, 32>(x, q, scales, groups, qmax, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool FP8>
cudaError_t launch(const void* x, void* q, float* scales, long long rows, int n,
                   int block, float qmax, cudaStream_t stream) {
  const int groups = (n + block - 1) / block;
  const long long items = rows * groups;
  const long long nblocks = (items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_kernel<T, FP8><<<(unsigned)nblocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(q), scales, rows, n, block,
      groups, qmax);
  return cudaGetLastError();
}

}  // namespace

// x [rows, n] (x_dtype 0 = float32, 1 = bfloat16), contiguous. q [rows, n]
// one byte each (q_dtype 0 = int8 with `bits` 8 or 4, 1 = float8_e4m3fn);
// scales [rows, ceil(n / block)] float32. route (ops/quantizer.py::
// QUANT_ROUTES): 0 quantize_kernel, any call; 1 quantize_vec_kernel, bf16 x
// with n % block == 0, block a power of two from 8 to 256, x 16-byte and q
// 8-byte aligned. Returns a cudaError_t.
extern "C" int quantize(const void* x, void* q, void* scales, long long rows,
                        int n, int block, int bits, int x_dtype, int q_dtype,
                        int route, void* stream) {
  if (rows < 0 || n <= 0 || block <= 0 || (x_dtype != 0 && x_dtype != 1) ||
      (q_dtype != 0 && q_dtype != 1) || (q_dtype == 0 && bits != 8 && bits != 4) ||
      (route != 0 && route != 1))
    return cudaErrorInvalidValue;
  if (route == 1 &&
      (x_dtype != 1 || n % block != 0 || block < 8 || block > 256 || (block & (block - 1)) ||
       reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(q) % 8 != 0))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  float* s = static_cast<float*>(scales);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float qmax = q_dtype == 1 ? 448.f : (float)((1 << (bits - 1)) - 1);
  if (route == 1) {
    const long long groups = rows * (n / block);
    return q_dtype == 1 ? launch_vec_block<true>(x, q, s, groups, block, qmax, st)
                        : launch_vec_block<false>(x, q, s, groups, block, qmax, st);
  }
  if (q_dtype == 1)
    return x_dtype == 0 ? launch<float, true>(x, q, s, rows, n, block, qmax, st)
                        : launch<__nv_bfloat16, true>(x, q, s, rows, n, block, qmax, st);
  return x_dtype == 0 ? launch<float, false>(x, q, s, rows, n, block, qmax, st)
                      : launch<__nv_bfloat16, false>(x, q, s, rows, n, block, qmax, st);
}
