// Matmul straight from a blockwise-quantized weight, written by hand for
// Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/quantizer.py::_qmm_kernel (:257), the Pallas
// kernel that _qmm_pallas (:279) drives, and takes the whole contract of
// quantized_matmul (:302), which the Pallas kernel covers only in part.
//
// What it computes. out[M, N] = x[M, K] @ W with W[k, n] = q[k, n] *
// s[k, n / B]: q int8 or float8_e4m3fn [K, N], s float32 [K, ceil(N / B)]
// (a ragged last group allowed), x float32 or bfloat16, out float32 or
// bfloat16, any M, N and K. The weight element is dequantized in fp32
// exactly as the plain version does (one rounded product q * s), the
// products accumulate in fp32, and the result is rounded once to the
// output type. The scale varies along K, so it cannot be pulled out of the
// reduction: each weight element is dequantized after its load (in
// registers or shared memory), before the products (the Pallas kernel
// dequantizes its tile in VMEM).
//
// What bounds it on an H100. Decode (M = 8 rows) reads every weight byte
// once for 2M flops a byte: bound by the 3.35 TB/s of device memory, the
// point of a 1-byte weight. A mixed prefill put (M = 2048) does 2MNK flops
// on 1-byte weights: about 4000 flops a byte, bound by arithmetic.
//
// What this design does about it (the Python wrapper picks the route from
// the shapes, ops/quantizer.py::qmm_route):
// - Decode with bf16 x at the serving shapes (M <= 16; N, K and the scale
//   block multiples of 64; x and q 16-byte aligned: every projection the
//   port serves) runs qmm_decode_tc_kernel, on the tensor cores with the
//   split-K partials summed on chip (see its section below).
// - Other small M (fp32 x, odd widths, unaligned pointers) streams the
//   weight straight from device memory into registers: each thread owns 4
//   adjacent columns for all M rows (one 4-byte load per weight row, a warp
//   reading 128 contiguous bytes), x is staged in shared memory 128 rows of
//   K at a time and read as a broadcast. The weight rows come in groups of
//   8 and the next group's loads are issued before the current one is used,
//   so loads stay in flight while the FMAs run. K is split over the grid's
//   second dimension so that even a 1024-wide projection puts several
//   blocks on each SM; each split writes an fp32 partial and a second
//   kernel sums the partials in a fixed order into `out` (deterministic).
// - Large M with bf16 x at the serving shapes (N, K and the scale block
//   multiples of 64, aligned pointers: every projection of the models the
//   port serves) runs qmm_wgmma_kernel: Hopper's warpgroup MMA with the
//   dequantized weight as the register operand A and x^T read from shared
//   memory, fed by a 4-stage cp.async ring, 128 or 256 rows of x a block so
//   that each weight element is dequantized M / 256 times (see its section
//   below).
// - Other large-M bf16 shapes run on the tensor cores with mma.sync
//   (m16n8k16, bf16 operands, fp32 accumulation) over a 64 or 128 x 128
//   output tile and a 32-deep K step. Each dequantized weight w = q * s
//   (fp32) is split into two bf16 terms, hi = bf16(w) and lo = bf16(w - hi),
//   and the tile is multiplied by both: x is exact in bf16 and hi + lo
//   carries w to about 2^-17 of itself, so the result stays within fp32
//   rounding of the plain version's (the stated tolerance in chip_smoke.py)
//   at twice the tensor work of a single bf16 rounding. The wgmma route
//   splits the same way.
// - Large M with fp32 x takes a 128 x 128 output tile with a 16-deep K
//   step, 8 x 8 outputs per thread, fp32 FMAs on the CUDA cores from shared
//   memory (x transposed in shared memory so a thread's 8 rows are one
//   16-byte read); the weight tile is dequantized into shared memory.
// - Weight rows that are 16-byte (fp32 tile) or 4-byte (others) aligned are
//   read that many bytes a thread; any other width one byte at a time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;

// the routes of the C entry point (ops/quantizer.py::QMM_ROUTES)
constexpr int kRouteGemv = 0, kRouteTile = 1, kRouteMma = 2, kRouteWgmma128 = 3,
              kRouteWgmma256 = 4, kRouteDecodeTc = 5;

__device__ __forceinline__ float x_f32(float v) { return v; }
__device__ __forceinline__ float x_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <bool FP8>
__device__ __forceinline__ float q_f32(uint8_t b) {
  if (FP8) {
    __nv_fp8_e4m3 v;
    v.__x = b;
    return static_cast<float>(v);
  }
  return static_cast<float>(static_cast<int8_t>(b));
}

// the codes of 4 adjacent columns of one weight row, byte j = column j,
// read one byte at a time; `valid` (0-4) columns exist
__device__ __forceinline__ uint32_t load4(const uint8_t* qr, int valid) {
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < valid) r |= (uint32_t)qr[j] << (8 * j);
  return r;
}

template <typename TX, bool FP8, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
qmm_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ q,
           const float* __restrict__ s, void* __restrict__ out, int out_bf16,
           int M, int N, int K, int block, int G, int vec) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int XP = BM + 4;  // x row pad: keeps 16-byte alignment
  __shared__ __align__(16) float xs[BK * XP];  // [BK][BM] (transposed)
  __shared__ __align__(16) float wsm[BK * BN];  // [BK][BN], dequantized

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile [BM, BK] -> xs[kk][r]; consecutive threads read consecutive k
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, kk = idx - (idx / BK) * BK;
      const int m = m0 + r, k = k0 + kk;
      xs[kk * XP + r] = (m < M && k < K) ? x_f32(x[(size_t)m * K + k]) : 0.f;
    }
    // weight tile [BK, BN]: load the codes, dequantize, store fp32
    if (vec) {
      for (int idx = tid; idx < BK * (BN / 16); idx += NT) {
        const int kk = idx / (BN / 16);
        const int j = (idx - kk * (BN / 16)) * 16;
        const int k = k0 + kk, n = n0 + j;
        float* dst = wsm + kk * BN + j;
        if (k < K && n < N) {  // vec: N % 16 == 0, all 16 columns exist
          const uint4 raw = *reinterpret_cast<const uint4*>(q + (size_t)k * N + n);
          const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
          const float* srow = s + (size_t)k * G;
          if (block >= 16) {  // the 16 columns span at most two groups
            const int g0 = n / block;
            const int split = (g0 + 1) * block - n;  // first column of g0 + 1
            const float s0 = srow[g0];
            const float s1 = g0 + 1 < G ? srow[g0 + 1] : 0.f;
#pragma unroll
            for (int t = 0; t < 16; ++t)
              dst[t] = __fmul_rn(q_f32<FP8>(b[t]), t < split ? s0 : s1);
          } else {
#pragma unroll
            for (int t = 0; t < 16; ++t)
              dst[t] = __fmul_rn(q_f32<FP8>(b[t]), srow[(n + t) / block]);
          }
        } else {
#pragma unroll
          for (int t = 0; t < 16; ++t) dst[t] = 0.f;
        }
      }
    } else {
      for (int idx = tid; idx < BK * BN; idx += NT) {
        const int kk = idx / BN, j = idx - (idx / BN) * BN;
        const int k = k0 + kk, n = n0 + j;
        wsm[kk * BN + j] =
            (k < K && n < N)
                ? __fmul_rn(q_f32<FP8>(q[(size_t)k * N + n]), s[(size_t)k * G + n / block])
                : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 2) {
        const float2 v = *reinterpret_cast<const float2*>(xs + kk * XP + ty * TM + i);
        a[i] = v.x;
        a[i + 1] = v.y;
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(wsm + kk * BN + tx * TN + j);
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: one rounding to out's type
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(acc[i][j]);
      else
        static_cast<float*>(out)[o] = acc[i][j];
    }
  }
}

// ---- tensor-core path (bf16 x, M > 16)

constexpr int kMmaBN = 128, kMmaBK = 32, kMmaKP = kMmaBK + 8;  // bf16 pitch
constexpr int kMmaThreads = 256;  // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_k, __nv_bfloat16 hi_k) {
  return (uint32_t)__bfloat16_as_ushort(lo_k) | ((uint32_t)__bfloat16_as_ushort(hi_k) << 16);
}

// BM = 64 or 128 rows; each warp owns BM/2 rows x 32 columns. FAST: as in
// the weight-streaming path (aligned 4-byte rows, one scale group per 4
// columns): branch-free loads and one scale per row.
template <bool FP8, int BM, bool FAST>
__global__ void __launch_bounds__(kMmaThreads)
qmm_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
               const float* __restrict__ s, void* __restrict__ out, int out_bf16,
               int M, int N, int K, int block, int G, int xvec) {
  constexpr int MT = BM / 32;  // m16 tiles per warp
  constexpr int BP = kMmaKP / 2;  // pitch of a weight column, in bf16 pairs
  __shared__ __align__(16) __nv_bfloat16 as[BM * kMmaKP];  // x [m][k]
  __shared__ __align__(16) uint32_t bh[kMmaBN * BP];  // hi [n][k pair]
  __shared__ __align__(16) uint32_t bl[kMmaBN * BP];  // lo [n][k pair]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kMmaBN;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the weight tile's (k pair, 4 columns) items: every thread keeps its
  // k pair and columns for the whole K loop, so their scale-group indices
  // (-1 past N) are worked out once
  constexpr int kItems = (kMmaBK / 2) * (kMmaBN / 4) / kMmaThreads;
  const int kp = tid % (kMmaBK / 2);
  const int nq0 = (tid / (kMmaBK / 2)) * 4;
  int gi[kItems][4], valid[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int n = n0 + nq0 + it * (kMmaBN / kItems);
    valid[it] = max(0, min(4, N - n));
#pragma unroll
    for (int j = 0; j < 4; ++j) gi[it][j] = n + j < N ? (n + j) / block : -1;
  }

  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    // x tile [BM, 32] bf16: 8 values (16 bytes) a chunk, k fastest
    for (int c = tid; c < BM * (kMmaBK / 8); c += kMmaThreads) {
      const int r = c / (kMmaBK / 8), kc = (c % (kMmaBK / 8)) * 8;
      const int m = m0 + r, k = k0 + kc;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const __nv_bfloat16* src = x + (size_t)m * K + k;
        if (xvec && k + 8 <= K) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = k + j < K ? src[j] : __float2bfloat16(0.f);
        }
      }
      *reinterpret_cast<uint4*>(as + r * kMmaKP + kc) = v;
    }
    // weight tile [32, 128]: a thread takes rows (k, k+1) of 4 columns,
    // dequantizes them in fp32 (q * s, as the plain version), splits each
    // into hi + lo bf16 and stores the (k, k+1) pairs column-major. k pair
    // fastest across threads keeps the shared-memory stores conflict-free.
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int nq = nq0 + it * (kMmaBN / kItems);
      const int n = n0 + nq;
      uint32_t raw[2];
      float sc[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 2 * kp + h;
        const bool in = k < K && valid[it] > 0;
        const uint8_t* qr = q + (size_t)k * N + n;
        const float* sr = s + (size_t)k * G;
        if (FAST) {
          raw[h] = in ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
          const float v = in ? sr[gi[it][0]] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[h][j] = v;
        } else {
          raw[h] = in ? load4(qr, valid[it]) : 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[h][j] = in && gi[it][j] >= 0 ? sr[gi[it][j]] : 0.f;
        }
      }
      float w[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[h][j] = __fmul_rn(q_f32<FP8>((uint8_t)(raw[h] >> (8 * j))), sc[h][j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16 h0 = __float2bfloat16_rn(w[0][j]);
        const __nv_bfloat16 h1 = __float2bfloat16_rn(w[1][j]);
        const __nv_bfloat16 l0 = __float2bfloat16_rn(w[0][j] - __bfloat162float(h0));
        const __nv_bfloat16 l1 = __float2bfloat16_rn(w[1][j] - __bfloat162float(h1));
        bh[(nq + j) * BP + kp] = pack_bf16(h0, h1);
        bl[(nq + j) * BP + kp] = pack_bf16(l0, l1);
      }
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* ar = as + (wm * (BM / 2) + i * 16 + g) * kMmaKP + ks + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(ar);
        a[i][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kMmaKP);
        a[i][2] = *reinterpret_cast<const uint32_t*>(ar + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kMmaKP + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + g;
        const uint32_t* hr = bh + col * BP + ks / 2 + t;
        const uint32_t* lr = bl + col * BP + ks / 2 + t;
        const uint32_t h0 = hr[0], h1 = hr[4], l0 = lr[0], l1 = lr[4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], a[i], h0, h1);
          mma_bf16(acc[i][j], a[i], l0, l1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * (BM / 2) + i * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        const size_t o = (size_t)m * N + n;
        if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(acc[i][j][e]);
        else
          static_cast<float*>(out)[o] = acc[i][j][e];
      }
    }
  }
}

// ---- wgmma route (bf16 x, M > 16, N % 64 == 0, K % 64 == 0, block % 64 == 0)
//
// out^T = W^T . x^T on the warpgroup tensor-core instruction. Each of the
// block's two consumer warpgroups owns 64 output columns (n) as wgmma's 64
// rows of A and all BMX rows of x as its N; A is the dequantized weight,
// built in registers straight from the staged codes (no shared-memory copy
// of the bf16 weight), once per block for BMX rows of x; B = x^T is read by
// the tensor cores from shared memory, where x's rows (K contiguous) lie
// K-major in the 128-byte swizzle. Each k16 step issues two wgmma, hi then
// lo, into one fp32 accumulator. A ring of kWgStages stages (x tile, code
// tile, one scale a K row and warpgroup) is kept full by cp.async, every
// thread issuing its share; the stage for K step kt + kWgStages - 1 is
// issued as step kt's last products go out, so the copies of three steps
// are in flight behind the products.
//
// The A fragment layout is mma.m16n8k16's, a warp per 16 rows: lane (g, t)
// holds rows g and g + 8 at k = 2t, 2t + 1, 2t + 8, 2t + 9. Row g of warp w
// is output column 16 w + 2 g and row g + 8 column 16 w + 2 g + 1, so a
// lane's two columns are adjacent: one 2-byte load from the code tile a K
// row, and in the epilogue one 4-byte (bf16) or 8-byte (fp32) store a row
// of x, a warp writing whole 32-byte sectors (no staging pass needed for
// coalescing). The next k16 step's fragments are dequantized while the
// current step's two wgmma run (wgmma.wait_group 1 frees the registers of
// the step before). The wgmma wrappers, fences and descriptors are
// mma.cuh's, shared with flash_attention.cu's forward.

constexpr int kWgCols = 64;                        // output columns a warpgroup
constexpr int kWgGroups = 2;                       // consumer warpgroups a block
constexpr int kWgThreads = 128 * kWgGroups;
constexpr int kWgBN = kWgCols * kWgGroups;         // output columns a block
constexpr int kWgBK = 64;                          // K a stage: one 128-byte row of x
constexpr int kWgStages = 4;
constexpr int kWgCodePitch = kWgBN + 16;           // bytes a K row of the code tile:
                                                   // the 4 rows a fragment load reads
                                                   // fall in 4 bank groups

template <int BMX>
constexpr size_t wgmma_smem_bytes() {
  return (size_t)kWgStages * (BMX * kWgBK * 2 + kWgBK * kWgCodePitch + kWgGroups * kWgBK * 4) +
         1024;  // the x tiles start on a 1024-byte boundary (the swizzle's period)
}

// four codes (bytes of c) to fp32, exactly. int8: the byte with its sign bit
// flipped is q + 128; as the low mantissa bits of 2^23 it is the float
// 2^23 + q + 128, from which 2^23 + 128 is subtracted (exact below 2^24).
// fp8 e4m3: two at a time through f16, which holds every e4m3 value.
template <bool FP8>
__device__ __forceinline__ void codes4_f32(uint32_t c, float (&f)[4]) {
  if (FP8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __half2_raw r =
          __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(c >> (16 * h)), __NV_E4M3);
      const float2 v = __half22float2(__half2(r));
      f[2 * h] = v.x;
      f[2 * h + 1] = v.y;
    }
  } else {
    const uint32_t u = c ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __int_as_float((int)__byte_perm(u, 0x4B000000u, 0x7650 + j)) - 8388736.f;
  }
}

// w0, w1 (adjacent k) -> hi = RN bf16 pair, lo = RN bf16 pair of the
// remainders (exact in fp32), as the mma.sync route splits them
__device__ __forceinline__ void split_hi_lo(float w0, float w1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(w0, w1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(w0 - hf.x, w1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// This lane's hi and lo A fragments of one k16 step from the stage's code
// tile (rows k0 + 2t, 2t + 1, 2t + 8, 2t + 9 at the lane's two columns) and
// the warpgroup's scales of those rows: w = q * s in fp32 (__fmul_rn, as
// the plain version), then split.
template <bool FP8>
__device__ __forceinline__ void wg_fragments(const uint8_t* code, const float* sc,
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  constexpr int P = kWgCodePitch;
  const uint32_t u0 = *reinterpret_cast<const uint16_t*>(code);
  const uint32_t u1 = *reinterpret_cast<const uint16_t*>(code + P);
  const uint32_t u2 = *reinterpret_cast<const uint16_t*>(code + 8 * P);
  const uint32_t u3 = *reinterpret_cast<const uint16_t*>(code + 9 * P);
  const float2 s01 = *reinterpret_cast<const float2*>(sc);
  const float2 s89 = *reinterpret_cast<const float2*>(sc + 8);
  float f[4];
  // bytes: (k, column 2g), (k + 1, 2g), (k, 2g + 1), (k + 1, 2g + 1)
  codes4_f32<FP8>(__byte_perm(u0, u1, 0x5140), f);
  split_hi_lo(__fmul_rn(f[0], s01.x), __fmul_rn(f[1], s01.y), hi[0], lo[0]);
  split_hi_lo(__fmul_rn(f[2], s01.x), __fmul_rn(f[3], s01.y), hi[1], lo[1]);
  codes4_f32<FP8>(__byte_perm(u2, u3, 0x5140), f);
  split_hi_lo(__fmul_rn(f[0], s89.x), __fmul_rn(f[1], s89.y), hi[2], lo[2]);
  split_hi_lo(__fmul_rn(f[2], s89.x), __fmul_rn(f[3], s89.y), hi[3], lo[3]);
}

template <int BMX>
__device__ __forceinline__ void wg_mma(float (&d)[BMX / 2], const uint32_t (&a)[4],
                                       uint64_t desc);
template <>
__device__ __forceinline__ void wg_mma<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc) {
  wgmma_m64n128k16_rs<0>(d, a, desc, 1);  // B K-major, accumulate
}
template <>
__device__ __forceinline__ void wg_mma<256>(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc) {
  wgmma_m64n256k16_rs<0>(d, a, desc, 1);
}

// grid (N / 128 rounded up, M / BMX rounded up); 256 threads; dynamic shared
// memory wgmma_smem_bytes<BMX>()
template <bool FP8, int BMX>
__global__ void __launch_bounds__(kWgThreads, 1)
qmm_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                 const float* __restrict__ s, void* __restrict__ out, int out_bf16, int M,
                 int N, int K, int block, int G) {
  constexpr int XB = BMX * kWgBK * 2;             // bytes of an x tile
  constexpr int CB = kWgBK * kWgCodePitch;        // bytes of a code tile
  constexpr int SB = kWgGroups * kWgBK;           // scales a stage
  extern __shared__ __align__(16) uint8_t wg_smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(wg_smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t xs_s = raw + pad;                          // [stage][BMX][128 B]
  uint8_t* codes = wg_smem + pad + kWgStages * XB;         // [stage][64][pitch]
  const uint32_t codes_s = xs_s + kWgStages * XB;
  float* scales = reinterpret_cast<float*>(codes + kWgStages * CB);  // [stage][2][64]
  const uint32_t scales_s = codes_s + kWgStages * CB;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kWgBN, m0 = blockIdx.y * BMX;
  const int KT = K / kWgBK;

  // one stage's copies: x rows past M and columns past N are zero-filled
  auto load_stage = [&](int st, int kt) {
    const int k0 = kt * kWgBK;
    const uint32_t xd = xs_s + st * XB;
    for (int i = tid; i < BMX * 8; i += kWgThreads) {
      const int r = i >> 3, c = i & 7, m = m0 + r;
      cp_async16(xd + r * 128 + ((c ^ (r & 7)) << 4),
                 x + (size_t)min(m, M - 1) * K + k0 + c * 8, m < M ? 16 : 0);
    }
    const uint32_t cd = codes_s + st * CB;
    for (int i = tid; i < kWgBK * (kWgBN / 16); i += kWgThreads) {
      const int kk = i >> 3, c = i & 7, n = n0 + c * 16;
      cp_async16(cd + kk * kWgCodePitch + c * 16, q + (size_t)(k0 + kk) * N + min(n, N - 16),
                 n < N ? 16 : 0);
    }
    if (tid < SB) {
      const int gi = tid / kWgBK, kk = tid % kWgBK, n = n0 + gi * kWgCols;
      cp_async4(scales_s + (st * SB + tid) * 4, s + (size_t)(k0 + kk) * G + min(n, N - 1) / block,
                n < N ? 4 : 0);
    }
  };
  // this lane's code and scale pointers in a stage, at k16 step ks
  const int col = wg * kWgCols + w * 16 + 2 * g;
  auto code_at = [&](int st, int ks) {
    return codes + st * CB + (16 * ks + 2 * t) * kWgCodePitch + col;
  };
  auto scale_at = [&](int st, int ks) { return scales + st * SB + wg * kWgBK + 16 * ks + 2 * t; };

  float acc[BMX / 2];
#pragma unroll
  for (int i = 0; i < BMX / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int st = 0; st < kWgStages - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_async_commit();
  }
  cp_async_wait<kWgStages - 2>();
  fence_proxy_async();
  __syncthreads();

  uint32_t ah[2][4], al[2][4];
  wg_fragments<FP8>(code_at(0, 0), scale_at(0, 0), ah[0], al[0]);
  fence_regs(acc);
  for (int kt = 0; kt < KT; ++kt) {
    const int st = kt % kWgStages;
    const uint64_t desc = sw128_desc(xs_s + st * XB);
#pragma unroll
    for (int ks = 0; ks < kWgBK / 16; ++ks) {
      wgmma_fence();
      wg_mma<BMX>(acc, ah[ks & 1], desc + 2 * ks);  // + 32 bytes a k16 step
      wg_mma<BMX>(acc, al[ks & 1], desc + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();  // the step before is done: its fragments are free
      if (ks + 1 < kWgBK / 16) {
        wg_fragments<FP8>(code_at(st, ks + 1), scale_at(st, ks + 1), ah[(ks + 1) & 1],
                          al[(ks + 1) & 1]);
      } else if (kt + 1 < KT) {
        // step kt + 1 has landed (at most kWgStages - 3 younger groups in
        // flight); after the barrier no warpgroup still reads step kt - 1's
        // stage, which takes step kt + kWgStages - 1
        cp_async_wait<kWgStages - 3>();
        fence_proxy_async();
        __syncthreads();
        if (kt + kWgStages - 1 < KT) load_stage((kt + kWgStages - 1) % kWgStages, kt + kWgStages - 1);
        cp_async_commit();
        const int nst = (kt + 1) % kWgStages;
        wg_fragments<FP8>(code_at(nst, 0), scale_at(nst, 0), ah[0], al[0]);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // d[4i + e]: column (A row) g + 8 (e >> 1) of warp w, x row 8 i + 2 t + (e & 1)
  const int n = n0 + col;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < BMX / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * i + 2 * t + e;
      if (m >= M) continue;
      const size_t o = (size_t)m * N + n;
      if (out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
            __floats2bfloat162_rn(acc[4 * i + e], acc[4 * i + 2 + e]);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
            make_float2(acc[4 * i + e], acc[4 * i + 2 + e]);
    }
  }
}

// ---- weight-streaming path (M <= 16, the calls the decode route does not take)

constexpr int kGemvThreads = 128;  // 4 columns each: 512 columns a block
constexpr int kGemvKT = 128;       // rows of x staged per step
constexpr int kGemvU = 8;          // weight rows a group; the next group's
                                   // loads fly while this one is used

// U weight rows of this thread's 4 columns (codes and scales), rows at or
// past kt read as zeros. FAST: the rows are 4-byte aligned, N % 4 == 0 and
// the 4 columns share one scale group (every serving shape): one
// unconditional 4-byte load and one scale a row, which keeps the loads
// free of branches so that they stay in flight. Otherwise bytes are read
// one at a time and each column finds its own scale.
template <bool FAST>
struct GemvRows {
  uint32_t raw[kGemvU];
  float sc[kGemvU][FAST ? 1 : 4];

  __device__ __forceinline__ void fetch(const uint8_t* q, const float* s, int k0,
                                        int kk, int kt, int N, int G, int c0,
                                        int valid, const int* gi) {
#pragma unroll
    for (int u = 0; u < kGemvU; ++u) {
      const bool in = kk + u < kt;
      const int k = k0 + kk + u;
      const uint8_t* qr = q + (size_t)k * N + c0;
      const float* sr = s + (size_t)k * G;
      if (FAST) {
        raw[u] = in ? *reinterpret_cast<const uint32_t*>(qr) : 0u;
        sc[u][0] = in ? sr[gi[0]] : 0.f;
      } else {
        raw[u] = in ? load4(qr, valid) : 0u;
#pragma unroll
        for (int t = 0; t < 4; ++t) sc[u][t] = in && gi[t] >= 0 ? sr[gi[t]] : 0.f;
      }
    }
  }
};

// M <= MT rows; grid (ceil(N / 512), splits of K)
template <typename TX, bool FP8, int MT, bool FAST>
__global__ void __launch_bounds__(kGemvThreads)
qmm_gemv_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ q,
                const float* __restrict__ s, float* __restrict__ ws,
                void* __restrict__ out, int out_bf16, int M, int N, int K,
                int block, int G, int kchunk) {
  __shared__ float xs[MT * kGemvKT];  // [m][kk]
  const int c0 = (blockIdx.x * kGemvThreads + threadIdx.x) * 4;
  const int kbeg = blockIdx.y * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const bool live = c0 < N;
  const int valid = max(0, min(4, N - c0));
  int gi[4];  // scale-group index of each column, -1 past N
#pragma unroll
  for (int t = 0; t < 4; ++t) gi[t] = c0 + t < N ? (c0 + t) / block : -1;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[m][t] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kGemvKT) {
    const int kt = min(kGemvKT, kend - k0);
    __syncthreads();  // the previous step's readers are done
    for (int i = threadIdx.x; i < MT * kGemvKT; i += kGemvThreads) {
      const int m = i / kGemvKT, kk = i - (i / kGemvKT) * kGemvKT;
      xs[i] = (m < M && kk < kt) ? x_f32(x[(size_t)m * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    GemvRows<FAST> cur, nxt;
    cur.fetch(q, s, k0, 0, kt, N, G, c0, valid, gi);
    for (int kk = 0; kk < kt; kk += kGemvU) {
      nxt.fetch(q, s, k0, kk + kGemvU, kt, N, G, c0, valid, gi);
#pragma unroll
      for (int u = 0; u < kGemvU; ++u) {
        float w[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          w[t] = __fmul_rn(q_f32<FP8>((uint8_t)(cur.raw[u] >> (8 * t))),
                           cur.sc[u][FAST ? 0 : t]);
        const int kx = min(kk + u, kGemvKT - 1);  // past kt: w is 0
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[m * kGemvKT + kx];
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[m][t] = fmaf(xv, w[t], acc[m][t]);
        }
      }
      cur = nxt;
    }
  }

  if (!live) return;
  float* part = ws != nullptr ? ws + (size_t)blockIdx.y * M * N : nullptr;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int n = c0 + t;
      if (n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (part != nullptr)
        part[o] = acc[m][t];
      else if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(acc[m][t]);
      else
        static_cast<float*>(out)[o] = acc[m][t];
    }
  }
}

// out = sum over the splits of the fp32 partials, in split order
__global__ void splitk_sum(const float* __restrict__ ws, void* __restrict__ out,
                           int out_bf16, size_t mn, int splits) {
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < mn;
       o += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < splits; ++z) v += ws[(size_t)z * mn + o];
    if (out_bf16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
    else
      static_cast<float*>(out)[o] = v;
  }
}

// ---- decode route on the tensor cores (bf16 x, M <= 16, N % 64 == 0,
//      K % 64 == 0, block % 64 == 0, x and q 16-byte aligned)
//
// out^T[N, M] = W^T[N, K] . x^T[K, M] on mma.sync m16n8k16: the weight gives
// A (16 output columns x 16 of K), x^T gives B, whose n8 is 8 rows of x (two
// n8 halves for M <= 16). The scale varies along K (s[k, n / B]), so it is
// folded into x rather than into every weight element: for each K row k and
// scale group the kernel forms x'[m, k] = fl32(x[m, k] * s[k, group]) once,
// splits it into hi = bf16(x') and lo = bf16(x' - hi), and issues one MMA on
// hi and one on lo into one fp32 accumulator. The codes are exact in bf16
// (int8 through two logic operations and one packed FMA a pair, e4m3
// through f16), so a weight element costs about 2 instructions where the
// CUDA-core kernel spends about 13. Each product q * hi and q * lo is
// exact, and hi + lo carries x' to 2^-16 of itself, as the wgmma route's
// split of the dequantized weight does.
//
// Work split. A block (4 warps) owns a strip of 512, 256 or 128 output
// columns (each warp 128 of them; KW = 1, 2 or 4 warps share a 128-column
// sub-strip and take turns over its K rows) and one K slice; the blocks that
// share a strip form a thread-block cluster along K (8 or 16 blocks).
// dec_plan picks the strip and the cluster from N and the number of blocks
// the card holds at once: a warp's 16-row step is a chain of dependent
// loads, conversions and products, so the kernel wants every resident slot
// filled. The block streams its slice through a ring of kDecStages stages
// of 16 KW K rows, filled by 16-byte cp.async from all 128 threads: a warp's
// copies cover 512 / KW contiguous bytes of each weight row, and the stage's
// x (16 columns of each row for each K phase) and scales (each warp's two
// 64-column halves, 16 K rows) are fetched once for the block. At the end
// the partials of the KW warps of a sub-strip are summed in shared memory
// (in warp order), then each block of the cluster sums its share of the
// strip's columns over the cluster's blocks (ranks in order) through
// distributed shared memory and writes `out`: no fp32 partial goes to
// device memory, no second kernel runs, and every sum has a fixed order
// (the same bits on every run).
//
// Fragments. Lane (g, t) (g = lane / 4, t = lane % 4) holds A rows g and
// g + 8 of each of the warp's 8 tiles at k = 2t, 2t + 1, 2t + 8, 2t + 9.
// The k of the MMA map to the step's K rows 4t .. 4t + 3 (A and B permuted
// alike), and tile j = 4 h + jj's rows g and g + 8 to columns 64 h + 8 g +
// 2 jj and + 1: a tile stays in one 64-column half, hence in one scale
// group (block % 64 == 0), and a lane reads the 8 adjacent codes of each
// half from each of its 4 rows as one 8-byte load. The 16-byte chunk c of
// code row r is stored at chunk c ^ 2 (r / 4), which keeps those loads free
// of bank conflicts. The accumulator of tile j holds out rows 2t and 2t + 1
// (+ 8 in the second n8 half) at the tile's two columns of the lane.

constexpr int kDecThreads = 128;  // 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecBN = 128;       // output columns a warp: two 64-column halves
constexpr int kDecStages = 6;     // ring stages a block

// a stage: each warp's code tile (16 K rows x 128 columns), x for up to 4 K
// phases (16 columns of 8 MT rows each), each warp's two halves' scales
template <int MT>
__host__ __device__ constexpr int dec_stage_bytes() {
  return kDecWarps * 16 * kDecBN + kDecWarps * 8 * MT * 32 + kDecWarps * 2 * 16 * 4;
}
template <int MT>
__host__ __device__ constexpr size_t dec_smem_bytes() {
  return (size_t)kDecStages * dec_stage_bytes<MT>();
}

// (a & m) | c in one instruction (the compiler splits it in two when m and
// c are both immediates)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t m, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(m), "r"(c));
  return d;
}

// Two codes (byte b of w0, K row k; byte b of w1, row k + 1) -> the bf16
// pair (row k in the low half), exactly. int8: with s the sign bit and l the
// low 7 bits, q = l - 128 s; 0x4300 | l is the bf16 128 + l and 0xC300 |
// s << 7 is -(128 + 128 s), so one packed FMA (times 1) adds them without
// rounding.
// e4m3: two at a time through f16 and fp32, exact at every step.
template <bool FP8>
__device__ __forceinline__ uint32_t codes2_bf16(uint32_t w0, uint32_t w1, int b) {
  if (FP8) {
    const uint32_t z = __byte_perm(w0, w1, b | ((b + 4) << 4));
    const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)z, __NV_E4M3);
    const float2 f = __half22float2(__half2(hr));
    return pack2(f.x, f.y);
  }
  const uint32_t z = __byte_perm(w0, w1, b | ((b + 4) << 8));
  const uint32_t l = and_or(z, 0x007F007Fu, 0x43004300u);
  const uint32_t s = and_or(z, 0x00800080u, 0xC300C300u);
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(l), "r"(0x3F803F80u), "r"(s));
  return r;
}

// grid (C, strips of 128 * 4 / KW columns) in clusters of C blocks along x
// (C = 8 or 16); 128 threads; dynamic shared memory dec_smem_bytes<MT>().
// M <= 8 MT rows of x; KW: warps that share a 128-column sub-strip (1, 2 or
// 4), warp w taking K phase w % KW of each stage (a stage is 16 KW K rows);
// kchunk: K rows a block (a multiple of 16).
template <bool FP8, int MT>
__global__ void __launch_bounds__(kDecThreads)
qmm_decode_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                     const float* __restrict__ s, void* __restrict__ out, int out_bf16, int M,
                     int N, int K, int block, int G, int kchunk, int KW) {
  constexpr int SB = dec_stage_bytes<MT>();
  constexpr int MP = 8 * MT;                           // x rows a block sums
  constexpr int XO = kDecWarps * 16 * kDecBN;          // x's offset in a stage
  constexpr int SO = XO + kDecWarps * MP * 32;         // the scales'
  constexpr int E = MP * kDecBN;                       // one warp's partial, in floats
  static_assert(dec_smem_bytes<MT>() >= (size_t)kDecWarps * E * 4,
                "the partials reuse the ring");
  extern __shared__ __align__(16) uint8_t dec_smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int subs = kDecWarps / KW;                      // 128-column sub-strips a block
  const int n0 = blockIdx.y * kDecBN * subs;
  const int kq = warp % KW;                             // this warp's K phase
  const int kbeg = blockIdx.x * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int steps = max(0, kend - kbeg) / 16;           // 16-row steps of the slice
  const int nstage = (steps + KW - 1) / KW;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(dec_smem);

  // This thread's copies of a stage, the same every stage but for k0 (the
  // stage's first K row). Codes: chunks tid + 128 u of the stage's 16 KW
  // rows x 512 / KW bytes, row by row, so that a warp reads 512 / KW
  // contiguous bytes of each row; each lands in its warp's tile, chunk c of
  // tile row r at chunk c ^ 2 (r / 4). x: 16-byte chunks of (phase, row).
  // Scales: K row tid / 8 of the 8 (warp, half) pairs. What lies past N, M
  // or the slice is zero-filled.
  const int cpr = 32 / KW;                              // 16-byte chunks a row
  const int crow = tid / cpr, cc = tid % cpr;
  const bool clive = n0 + 16 * cc < N;
  const uint8_t* csrc = q + (size_t)crow * N + (clive ? n0 + 16 * cc : 0);
  const size_t cstep = (size_t)4 * KW * N;              // rows between u and u + 1
  uint32_t cdst[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = crow + 4 * KW * u, lr = r % 16;
    cdst[u] = ((cc / 8) * KW + r / 16) * 16 * kDecBN + lr * kDecBN +
              16 * ((cc % 8) ^ (2 * (lr >> 2)));
  }
  const int xq = tid / (2 * MP), xm = (tid / 2) % MP;
  const bool xlive = tid < 2 * MP * KW && xm < M;
  const __nv_bfloat16* xsrc = x + (size_t)(xlive ? xm : 0) * K + 16 * xq + 8 * (tid & 1);
  const int sr = tid / 8, sw = (tid % 8) / 2, sh = tid % 2;
  const int scol = n0 + kDecBN * (sw / KW) + 64 * sh;
  const bool slive = scol < N;
  const int srow = 16 * (sw % KW) + sr;                 // the scale's row in the stage
  const float* ssrc = s + (size_t)srow * G + (slive ? scol / block : 0);
  auto load = [&](int slot, int i) {
    const int k0 = kbeg + 16 * KW * i;
    const uint32_t st = ring_s + slot * SB;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      cp_async16(st + cdst[u], csrc + (size_t)k0 * N + u * cstep,
                 clive && k0 + crow + 4 * KW * u < kend ? 16 : 0);
    if (tid < 2 * MP * KW)
      cp_async16(st + XO + 16 * tid, xsrc + k0, xlive && k0 + 16 * xq < kend ? 16 : 0);
    cp_async4(st + SO + 4 * ((tid % 8) * 16 + sr), ssrc + (size_t)k0 * G,
              slive && k0 + srow < kend ? 4 : 0);
  };

  // this warp's columns: halves in one scale group or two
  const int nw = n0 + kDecBN * (warp / KW);
  const bool same = nw + 64 >= N || (nw + 64) / block == nw / block;

  float acc[8][MT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (i < nstage) load(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nstage; ++i) {
    cp_async_wait<kDecStages - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();                  // ... and every thread's; stage i - 1's slot is free
    if (i + kDecStages - 1 < nstage) load((i + kDecStages - 1) % kDecStages, i + kDecStages - 1);
    cp_async_commit();
    if (kq + KW * i >= steps) continue;  // this warp's phase lies past the slice
    const uint8_t* st = dec_smem + (i % kDecStages) * SB;
    const uint8_t* ct = st + warp * 16 * kDecBN;        // this warp's code tile
    const uint8_t* xt = st + XO + kq * MP * 32;         // its phase's x
    const uint8_t* sc = st + SO + warp * 2 * 16 * 4;    // its halves' scales

    // B: x' = x * s at K rows 4t .. 4t + 3 for x rows g (+ 8), split hi + lo
    uint32_t bh[2][MT][2], bl[2][MT][2];
    const float4 s0 = *reinterpret_cast<const float4*>(sc + 16 * t);
    const float4 s1 = *reinterpret_cast<const float4*>(sc + 64 + 16 * t);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint2 xv = *reinterpret_cast<const uint2*>(xt + (g + 8 * mt) * 32 + 8 * t);
      const float x0 = __uint_as_float(xv.x << 16), x1 = __uint_as_float(xv.x & 0xFFFF0000u);
      const float x2 = __uint_as_float(xv.y << 16), x3 = __uint_as_float(xv.y & 0xFFFF0000u);
      split_hi_lo(__fmul_rn(x0, s0.x), __fmul_rn(x1, s0.y), bh[0][mt][0], bl[0][mt][0]);
      split_hi_lo(__fmul_rn(x2, s0.z), __fmul_rn(x3, s0.w), bh[0][mt][1], bl[0][mt][1]);
      if (same) {
        bh[1][mt][0] = bh[0][mt][0], bh[1][mt][1] = bh[0][mt][1];
        bl[1][mt][0] = bl[0][mt][0], bl[1][mt][1] = bl[0][mt][1];
      } else {
        split_hi_lo(__fmul_rn(x0, s1.x), __fmul_rn(x1, s1.y), bh[1][mt][0], bl[1][mt][0]);
        split_hi_lo(__fmul_rn(x2, s1.z), __fmul_rn(x3, s1.w), bh[1][mt][1], bl[1][mt][1]);
      }
    }
    // A: the lane's 8 codes of each half in each of its 4 K rows
    uint2 w[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w[r][h] = *reinterpret_cast<const uint2*>(ct + (4 * t + r) * kDecBN +
                                                  8 * ((8 * h + g) ^ (4 * t)));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int b = 2 * (jj & 1);  // the byte of the tile's column in its word
        const uint32_t r0 = jj < 2 ? w[0][h].x : w[0][h].y, r1 = jj < 2 ? w[1][h].x : w[1][h].y;
        const uint32_t r2 = jj < 2 ? w[2][h].x : w[2][h].y, r3 = jj < 2 ? w[3][h].x : w[3][h].y;
        uint32_t a[4];
        a[0] = codes2_bf16<FP8>(r0, r1, b);
        a[1] = codes2_bf16<FP8>(r0, r1, b + 1);
        a[2] = codes2_bf16<FP8>(r2, r3, b);
        a[3] = codes2_bf16<FP8>(r2, r3, b + 1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[4 * h + jj][mt], a, bh[h][mt][0], bh[h][mt][1]);
          mma_bf16(acc[4 * h + jj][mt], a, bl[h][mt][0], bl[h][mt][1]);
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the partials reuse it
  float* red = reinterpret_cast<float*>(dec_smem);  // [warp][MP][128]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 64 * (j >> 2) + 8 * g + 2 * (j & 3);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float* r = red + (warp * MP + 8 * mt + 2 * t) * kDecBN + col;
      *reinterpret_cast<float2*>(r) = make_float2(acc[j][mt][0], acc[j][mt][2]);
      *reinterpret_cast<float2*>(r + kDecBN) = make_float2(acc[j][mt][1], acc[j][mt][3]);
    }
  }
  __syncthreads();
  // the KW warps of a sub-strip, summed in order into the first one's slot
  for (int e = tid; e < subs * E; e += kDecThreads) {
    float* p = red + (e / E) * KW * E + e % E;
    float v = p[0];
    for (int k = 1; k < KW; ++k) v += p[k * E];
    p[0] = v;
  }
  cluster.sync();  // every block's partial is in its shared memory

  // this block's share of the strip's columns, summed over the cluster's
  // blocks in rank order (the cluster spans the grid's x: rank = blockIdx.x);
  // the C loads are issued before the sum
  const int C = gridDim.x, cw = kDecBN * subs / C, c0 = blockIdx.x * cw;
  for (int e = tid; e < M * cw; e += kDecThreads) {
    const int m = e / cw, c = c0 + e % cw;
    const int off = ((c / kDecBN) * KW * MP + m) * kDecBN + c % kDecBN;
    float part[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < C) part[r] = cluster.map_shared_rank(red, r)[off];
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < C) v += part[r];
    const int n = n0 + c;
    if (n < N) {
      const size_t o = (size_t)m * N + n;
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
  cluster.sync();  // no block leaves while another still reads its shared memory
}

template <typename TX, bool FP8, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_tile(const void* x, const void* q, const float* s, void* out,
                        int out_bf16, int M, int N, int K, int block,
                        cudaStream_t stream) {
  const int G = (N + block - 1) / block;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  qmm_kernel<TX, FP8, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(q), s, out, out_bf16,
      M, N, K, block, G,
      (N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0) ? 1 : 0);
  return cudaGetLastError();
}

cudaError_t sum_splits(const float* ws, void* out, int out_bf16, int M, int N,
                       int z, cudaStream_t stream) {
  const size_t mn = (size_t)M * N;
  const unsigned blocks = (unsigned)((mn + 255) / 256 < 65536 ? (mn + 255) / 256 : 65536);
  splitk_sum<<<blocks, 256, 0, stream>>>(ws, out, out_bf16, mn, z);
  return cudaGetLastError();
}

template <typename TX, bool FP8, int MT>
cudaError_t launch_gemv(const void* x, const void* q, const float* s, void* out,
                        float* ws, int out_bf16, int M, int N, int K, int block,
                        int splits, cudaStream_t stream) {
  const int G = (N + block - 1) / block;
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + 15) / 16 * 16;
  const int z = (K + kchunk - 1) / kchunk;  // no empty split
  const int cols = kGemvThreads * 4;
  const dim3 grid((N + cols - 1) / cols, z);
  // c0 % 4 == 0, so with block % 4 == 0 a thread's 4 columns share a group
  const bool fast = N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                    block % 4 == 0;
  auto kernel = fast ? &qmm_gemv_kernel<TX, FP8, MT, true>
                     : &qmm_gemv_kernel<TX, FP8, MT, false>;
  kernel<<<grid, kGemvThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const uint8_t*>(q), s,
      z > 1 ? ws : nullptr, out, out_bf16, M, N, K, block, G, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || z == 1) return err;
  return sum_splits(ws, out, out_bf16, M, N, z, stream);
}

template <bool FP8, int BM>
cudaError_t launch_mma(const void* x, const void* q, const float* s, void* out,
                       int out_bf16, int M, int N, int K, int block,
                       cudaStream_t stream) {
  const int G = (N + block - 1) / block;
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + BM - 1) / BM);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  const bool fast = N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                    block % 4 == 0;
  auto kernel = fast ? &qmm_mma_kernel<FP8, BM, true> : &qmm_mma_kernel<FP8, BM, false>;
  kernel<<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q), s, out,
      out_bf16, M, N, K, block, G,
      (K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 1 : 0);
  return cudaGetLastError();
}

template <bool FP8, int BMX>
cudaError_t launch_wgmma(const void* x, const void* q, const float* s, void* out,
                         int out_bf16, int M, int N, int K, int block,
                         cudaStream_t stream) {
  const int G = (N + block - 1) / block;
  const dim3 grid((N + kWgBN - 1) / kWgBN, (M + BMX - 1) / BMX);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  auto kernel = &qmm_wgmma_kernel<FP8, BMX>;
  constexpr size_t smem = wgmma_smem_bytes<BMX>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                              static_cast<const uint8_t*>(q), s, out,
                                              out_bf16, M, N, K, block, G);
  return cudaGetLastError();
}

// The decode route's work split for an output width N: among strips of 512,
// 256 and 128 columns (KW = 1, 2 or 4 warps a 128-column sub-strip) and
// clusters of 8 or 16 blocks along K, the one with the most blocks that the
// card holds at once (`resident`), the widest strip and then the smaller
// cluster on a tie; if none fits, the one with the fewest blocks. A warp's
// 16-row step is a chain of dependent loads, conversions and products, so
// the kernel needs many warps on each SM more than long-lived ones.
void dec_plan(int N, int resident, int& KW, int& C) {
  long best = -1, fewest = 0;
  for (int kw = 1; kw <= 4; kw *= 2)
    for (int c = 8; c <= 16; c *= 2) {
      const int width = kDecBN * kDecWarps / kw;
      const long blocks = (long)(N + width - 1) / width * c;
      const bool fits = blocks <= resident;
      if ((fits && blocks > best) || (best < 0 && (fewest == 0 || blocks < fewest))) {
        if (fits) best = blocks;
        else fewest = blocks;
        KW = kw;
        C = c;
      }
    }
}

template <bool FP8, int MT>
cudaError_t launch_decode_tc(const void* x, const void* q, const float* s, void* out,
                             int out_bf16, int M, int N, int K, int block,
                             cudaStream_t stream) {
  const int G = (N + block - 1) / block;
  auto kernel = &qmm_decode_tc_kernel<FP8, MT>;
  constexpr size_t smem = dec_smem_bytes<MT>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  static int resident = 0;  // one device's worth
  if (resident == 0) {
    err = resident_blocks(kernel, kDecThreads, smem, &resident);
    if (err != cudaSuccess) return err;
  }
  int KW = 4, C = 8;
  dec_plan(N, resident, KW, C);
  const int width = kDecBN * kDecWarps / KW;
  const int strips = (N + width - 1) / width;
  if (strips > 65535) return cudaErrorInvalidValue;
  const int kchunk = (K / 16 + C - 1) / C * 16;
  if (C > 8)  // 16 is a non-portable cluster size
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, strips);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(x),
                           static_cast<const uint8_t*>(q), s, out, out_bf16, M, N, K, block, G,
                           kchunk, KW);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TX, bool FP8>
cudaError_t launch_route(int route, const void* x, const void* q, const float* s,
                         void* out, float* ws, int out_bf16, int M, int N, int K,
                         int block, int splits, cudaStream_t stream) {
  constexpr bool bf16_x = sizeof(TX) == 2;
  switch (route) {
    case kRouteGemv:
#define DS_GEMV(MT) \
  return launch_gemv<TX, FP8, MT>(x, q, s, out, ws, out_bf16, M, N, K, block, splits, stream)
      if (M <= 1) DS_GEMV(1);
      if (M <= 4) DS_GEMV(4);
      if (M <= 8) DS_GEMV(8);
      DS_GEMV(16);
#undef DS_GEMV
    case kRouteTile:
      if (bf16_x) return cudaErrorInvalidValue;
      return launch_tile<TX, FP8, 128, 128, 16, 8, 8>(x, q, s, out, out_bf16, M, N, K,
                                                      block, stream);
    case kRouteMma:
      if (!bf16_x) return cudaErrorInvalidValue;
      return M > 1024 ? launch_mma<FP8, 128>(x, q, s, out, out_bf16, M, N, K, block, stream)
                      : launch_mma<FP8, 64>(x, q, s, out, out_bf16, M, N, K, block, stream);
    case kRouteWgmma128:
    case kRouteWgmma256: {
      // the shapes the Python wrapper's route choice admits; anything else
      // is refused here, never run another way
      const bool ok = bf16_x && N % kWgCols == 0 && K % kWgBK == 0 && block % kWgCols == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(s) % 4 == 0;
      if (!ok) return cudaErrorInvalidValue;
      return route == kRouteWgmma256
                 ? launch_wgmma<FP8, 256>(x, q, s, out, out_bf16, M, N, K, block, stream)
                 : launch_wgmma<FP8, 128>(x, q, s, out, out_bf16, M, N, K, block, stream);
    }
    case kRouteDecodeTc: {
      const bool ok = bf16_x && M <= 16 && N % 64 == 0 && K % 64 == 0 && block % 64 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(s) % 4 == 0;
      if (!ok) return cudaErrorInvalidValue;
      return M <= 8 ? launch_decode_tc<FP8, 1>(x, q, s, out, out_bf16, M, N, K, block, stream)
                    : launch_decode_tc<FP8, 2>(x, q, s, out, out_bf16, M, N, K, block, stream);
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] (x_dtype 0 = float32, 1 = bfloat16), q [K, N] one byte each
// (q_dtype 0 = int8, 1 = float8_e4m3fn), s [K, ceil(N / block)] float32,
// out [M, N] (out_dtype 0 = float32, 1 = bfloat16); all contiguous. The
// caller (ops/quantizer.py::qmm_route) chooses the __global__ function from
// the shapes, and this entry refuses a route the call does not meet:
//   0 qmm_gemv_kernel   M <= 16, splits >= 1 K splits whose fp32 partials
//                       go to ws [splits, M, N] (unused with one split)
//   1 qmm_kernel        fp32 x, CUDA cores
//   2 qmm_mma_kernel    bf16 x, mma.sync
//   3, 4 qmm_wgmma_kernel with 128 or 256 rows of x a block: bf16 x,
//                       N % 64 == 0, K % 64 == 0, block % 64 == 0, x and q
//                       16-byte aligned
//   5 qmm_decode_tc_kernel  the same shapes at M <= 16 (splits 0, ws unused)
// Returns a cudaError_t.
extern "C" int quantized_matmul(const void* x, const void* q, const void* s,
                                void* out, void* ws, int M, int N, int K,
                                int block, int splits, int route, int x_dtype,
                                int q_dtype, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block <= 0 || splits < 0 ||
      (route == kRouteGemv) != (splits > 0) || (splits > 0 && M > 16) ||
      (x_dtype != 0 && x_dtype != 1) || (q_dtype != 0 && q_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1))
    return cudaErrorInvalidValue;
  const float* sf = static_cast<const float*>(s);
  float* wsf = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_QMM(TX, FP8)                                                            \
  return launch_route<TX, FP8>(route, x, q, sf, out, wsf, out_dtype, M, N, K, block, \
                               splits, st)
  if (x_dtype == 0) {
    if (q_dtype == 0) DS_QMM(float, false);
    DS_QMM(float, true);
  }
  if (q_dtype == 0) DS_QMM(__nv_bfloat16, false);
  DS_QMM(__nv_bfloat16, true);
#undef DS_QMM
}
