// Paged (block-table) attention over a ragged batch, written by hand for
// Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/paged_attention.py::_paged_kernel (:63), the
// Pallas kernel that _paged_pallas (:160) drives: bf16 and fp32 pools, and
// the int8/fp8 pool branch (quant=True, :73-103).
//
// What it computes. q [N, C, H, D]; pools [NB, KH, bs, D]; block_tables
// [N, MB] int32 (entries < 0 are unallocated); start_pos, n_tokens [N] int32.
// Query row (n, ci, h) sits at position start_pos[n] + ci and attends pool
// slot (b, s) of its table, at position b*bs + s, when kv <= q and
// kv < start_pos + n_tokens; with a window also when q - kv < window; with
// ALiBi the logit gains slope[h] * kv. Head h reads KV head h / G. Softmax is
// online and in fp32; the output has q's dtype. A row that attends nothing
// (a padded row with n_tokens = 0) writes zeros, as the Pallas kernel's
// acc / max(l, 1e-30) does. Quantized pools (int8 or float8_e4m3fn) carry
// one f32 scale per (block, KV head), k_scale/v_scale [NB, KH]: each staged
// K/V element is converted to fp32 and multiplied by its block's scale, as
// the Pallas kernel dequantizes each block in VMEM right after its DMA; the
// rest of the kernel is the same for every pool type.
//
// What bounds it on an H100. Decode (C = 1) reads every live K/V byte once
// for G query rows per KV head: about 2G flops per byte, far below the ~295
// flop/byte at which the 989 TFLOP/s tensor cores would be the limit, so
// decode is bound by the 3.35 TB/s of device memory. A 256-token prefill
// chunk with G = 4 has 1024 query rows per (sequence, KV head) and is bound by
// arithmetic.
//
// What this design does about it (simple and right first; tensor cores, TMA
// and a split-KV decode are later work):
// - The Pallas grid (N, KH, MB) runs its table dimension in order on one
//   core and carries the softmax state in VMEM scratch. Blocks on Hopper run
//   in no order, so the table walk is a loop inside the block, and the grid
//   is (sequence, KV head, tile of the G*C query rows of that group). A tile
//   holds 4 warps x RW rows, which keeps a 1024-row prefill group out of a
//   single block's registers.
// - The loop visits live positions only: from the window's first live
//   position (start - window + 1, as the Pallas `live` test at :90-94) to
//   the context length, further cut to the tile's own causal reach. This is
//   the counterpart of the Pallas pl.when plus the _clamp_tables index map:
//   dead blocks cost neither traffic nor arithmetic.
// - Each iteration stages 32 consecutive positions of K and V (one per lane)
//   in shared memory as fp32, rows padded to D + 1 floats so that a warp
//   reading one element of 32 different positions hits 32 banks. Each
//   position's table entry is read by the block itself (there is no scalar
//   prefetch); negative entries read block 0 as the JAX gather does
//   (jnp.maximum(tbl, 0)), so no negative entry is ever dereferenced.
// - Lane j scores position j of the tile against the warp's RW rows; the
//   online-softmax max and sum are warp reductions; p @ V broadcasts p_j
//   with a shuffle while each lane owns D/32 output columns.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // KV positions staged per iteration: one per lane

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8_e4m3* b = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// T: q and out. P: the pools (T, or int8_t / __nv_fp8_e4m3 with scales).
// DCH: output columns per lane, ceil(D / 32) rounded up to 1, 2, 4 or 8.
// RW: query rows per warp; a block holds kWarps * RW rows of one group.
template <typename T, typename P, int DCH, int RW>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                       const P* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ start_pos,
                       const int* __restrict__ n_tokens,
                       const float* __restrict__ slopes, T* __restrict__ out,
                       int C, int H, int D, int NB, int KH, int bs, int MB,
                       int window, float sm_scale) {
  constexpr int ROWS = kWarps * RW;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int DP = D + 1;
  float* q_s = smem;                 // [ROWS][D], pre-scaled by sm_scale
  float* k_s = q_s + ROWS * D;       // [kTile][DP]
  float* v_s = k_s + kTile * DP;     // [kTile][DP]

  const int n = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / KH;
  const int GC = G * C;
  const int r0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int D8 = D >> 3;

  const int startp = start_pos[n];
  const int ctx = startp + n_tokens[n];
  const int* tbl = tables + (size_t)n * MB;

  // This tile's rows r = g*C + ci span chunk positions [ci_min, ci_max].
  int ci_min = C, ci_max = -1;
  for (int r = r0; r < min(r0 + ROWS, GC); ++r) {
    const int ci = r % C;
    ci_min = min(ci_min, ci);
    ci_max = max(ci_max, ci);
  }
  // Live positions: [lo, hi). Nothing past the context or the table, and no
  // row of this tile attends past its own position; with a window nothing
  // before startp + ci_min - window + 1.
  const int hi = min(min(ctx, MB * bs), startp + ci_max + 1);
  const int lo = window > 0 ? max(0, startp + ci_min - window + 1) : 0;

  for (int idx = tid; idx < ROWS * D8; idx += kThreads) {
    const int rr = idx / D8;
    const int d = (idx - rr * D8) * 8;
    const int r = r0 + rr;
    float vals[8];
    if (r < GC) {
      const int g = r / C, ci = r - (r / C) * C;
      load8(q + ((size_t)(n * C + ci) * H + kh * G + g) * D + d, vals);
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] *= sm_scale;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) q_s[rr * D + d + j] = vals[j];
  }

  float m[RW], l[RW], slope[RW], acc[RW][DCH];
  int qpos[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = r0 + warp * RW + i;
    const int g = r / C;
    qpos[i] = r < GC ? startp + (r - g * C) : -1;  // -1: no such row
    slope[i] = (slopes != nullptr && r < GC) ? slopes[kh * G + g] : 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[i][c] = 0.f;
  }

  const float* qw = q_s + warp * RW * D;
  for (int t0 = (lo / kTile) * kTile; t0 < hi; t0 += kTile) {
    __syncthreads();  // q staged / the previous tile's readers are done
    for (int idx = tid; idx < kTile * D8; idx += kThreads) {
      const int s = idx / D8;
      const int d = (idx - s * D8) * 8;
      const int pos = t0 + s;
      float kv[8], vv[8];
      if (pos >= lo && pos < hi) {
        const int b = pos / bs;
        const int blk = min(max(tbl[b], 0), NB - 1);
        const size_t off = (((size_t)blk * KH + kh) * bs + (pos - b * bs)) * D + d;
        load8(k_pool + off, kv);
        load8(v_pool + off, vv);
        if (k_scale != nullptr) {  // quantized pool: dequantize the slot
          const float ks = k_scale[(size_t)blk * KH + kh];
          const float vs = v_scale[(size_t)blk * KH + kh];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            kv[j] *= ks;
            vv[j] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kv[j] = vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        k_s[s * DP + d + j] = kv[j];
        v_s[s * DP + d + j] = vv[j];
      }
    }
    __syncthreads();

    // scores: lane j against position t0 + j, for the warp's RW rows
    const int pos = t0 + lane;
    float sc[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) sc[i] = 0.f;
    const float* kr = k_s + lane * DP;
    for (int d = 0; d < D; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + i * D + d);
        sc[i] = fmaf(qv.x, k0, sc[i]);
        sc[i] = fmaf(qv.y, k1, sc[i]);
        sc[i] = fmaf(qv.z, k2, sc[i]);
        sc[i] = fmaf(qv.w, k3, sc[i]);
      }
    }

    // online softmax update (fp32), one row at a time
    const bool pos_live = pos >= lo && pos < hi;
    float p[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float s = sc[i] + slope[i] * (float)pos;
      const bool keep = pos_live && pos <= qpos[i] &&
                        (window <= 0 || qpos[i] - pos < window);
      const float mt = warp_max(keep ? s : -INFINITY);
      p[i] = 0.f;
      if (mt == -INFINITY) continue;  // warp-uniform: nothing live here
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);  // 0 on the first live tile
      p[i] = keep ? expf(s - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[i][c] *= alpha;
    }

    // acc += p @ V: p_j comes from lane j; lane owns columns lane + 32c
    const int jn = min(kTile, hi - t0);
    for (int j = 0; j < jn; ++j) {
      float vv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? v_s[j * DP + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = r0 + warp * RW + i;
    if (r >= GC) continue;
    const int g = r / C, ci = r - (r / C) * C;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = out + ((size_t)(n * C + ci) * H + kh * G + g) * D;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(dst + d, acc[i][c] / den);
    }
  }
}

template <typename T, typename P, int DCH, int RW>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* start_pos, const int* n_tokens,
                   const float* slopes, void* out, int N, int C, int H, int D,
                   int NB, int KH, int bs, int MB, int window, float sm_scale,
                   cudaStream_t stream) {
  constexpr int ROWS = kWarps * RW;
  const size_t smem = sizeof(float) * ((size_t)ROWS * D + 2 * (size_t)kTile * (D + 1));
  auto kernel = paged_attention_kernel<T, P, DCH, RW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int GC = (H / KH) * C;
  const dim3 grid(N, KH, (GC + ROWS - 1) / ROWS);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables, start_pos,
      n_tokens, slopes,
      static_cast<T*>(out), C, H, D, NB, KH, bs, MB, window, sm_scale);
  return cudaGetLastError();
}

template <typename T, typename P, int RW>
cudaError_t launch_d(int dch, const void* q, const void* k_pool,
                     const void* v_pool, const float* k_scale,
                     const float* v_scale, const int* tables, const int* start_pos,
                     const int* n_tokens, const float* slopes, void* out, int N,
                     int C, int H, int D, int NB, int KH, int bs, int MB,
                     int window, float sm_scale, cudaStream_t stream) {
#define DS_LAUNCH(DC)                                                        \
  return launch<T, P, DC, RW>(q, k_pool, v_pool, k_scale, v_scale, tables,  \
                              start_pos, n_tokens, slopes, out, N, C, H, D,  \
                              NB, KH, bs, MB, window, sm_scale, stream)
  if (dch <= 1) DS_LAUNCH(1);
  if (dch <= 2) DS_LAUNCH(2);
  if (dch <= 4) DS_LAUNCH(4);
  DS_LAUNCH(8);
#undef DS_LAUNCH
}

template <typename T, typename P>
cudaError_t launch_t(int rows_per_warp, int dch, const void* q,
                     const void* k_pool, const void* v_pool,
                     const float* k_scale, const float* v_scale, const int* tables,
                     const int* start_pos, const int* n_tokens,
                     const float* slopes, void* out, int N, int C, int H, int D,
                     int NB, int KH, int bs, int MB, int window,
                     float sm_scale, cudaStream_t stream) {
  if (rows_per_warp == 1)
    return launch_d<T, P, 1>(dch, q, k_pool, v_pool, k_scale, v_scale, tables,
                             start_pos, n_tokens, slopes, out, N, C, H, D, NB,
                             KH, bs, MB, window, sm_scale, stream);
  return launch_d<T, P, 8>(dch, q, k_pool, v_pool, k_scale, v_scale, tables,
                           start_pos, n_tokens, slopes, out, N, C, H, D, NB, KH,
                           bs, MB, window, sm_scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out share it).
// pool_dtype: 0 = q's dtype; 2 = int8, 3 = float8_e4m3fn, each with the
// scale planes k_scale/v_scale [NB, KH] float32 (null for dtype 0).
// rows_per_warp: 1 or 8 (the wrapper picks 1 for small G*C, i.e. decode).
// slopes: [H] float32 ALiBi slopes, or null. Returns a cudaError_t.
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* start_pos, const void* n_tokens,
                                   const void* slopes, void* out, int N, int C,
                                   int H, int D, int NB, int KH, int bs,
                                   int MB, int window, float sm_scale,
                                   int dtype, int pool_dtype, int rows_per_warp,
                                   void* stream) {
  const bool quant = pool_dtype == 2 || pool_dtype == 3;
  if (N <= 0 || C <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || D <= 0 ||
      D % 8 != 0 || D > 256 || NB <= 0 || bs <= 0 || MB <= 0 ||
      (rows_per_warp != 1 && rows_per_warp != 8) || (dtype != 0 && dtype != 1) ||
      (pool_dtype != 0 && !quant) ||
      (quant != (k_scale != nullptr && v_scale != nullptr)))
    return cudaErrorInvalidValue;
  const int dch = (D + 31) / 32;
  const int* tb = static_cast<const int*>(tables);
  const int* sp = static_cast<const int*>(start_pos);
  const int* nt = static_cast<const int*>(n_tokens);
  const float* sl = static_cast<const float*>(slopes);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DS_PAGED(T, P)                                                           \
  return launch_t<T, P>(rows_per_warp, dch, q, k_pool, v_pool, ks, vs, tb, sp, nt, \
                        sl, out, N, C, H, D, NB, KH, bs, MB, window, sm_scale, st)
  if (dtype == 0) {
    if (pool_dtype == 2) DS_PAGED(float, int8_t);
    if (pool_dtype == 3) DS_PAGED(float, __nv_fp8_e4m3);
    DS_PAGED(float, float);
  }
  if (pool_dtype == 2) DS_PAGED(__nv_bfloat16, int8_t);
  if (pool_dtype == 3) DS_PAGED(__nv_bfloat16, __nv_fp8_e4m3);
  DS_PAGED(__nv_bfloat16, __nv_bfloat16);
#undef DS_PAGED
}
