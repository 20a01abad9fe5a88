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
// acc / max(l, 1e-30) does; so does every row past n_tokens (the contract
// leaves those rows unspecified; zeros keep the output finite). Quantized pools (int8 or float8_e4m3fn) carry
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
// What this design does about it. Three routes; the Python wrapper picks
// one from the shapes (ops/paged_attention.py::paged_route):
// - paged_decode_split_kernel, then paged_decode_combine_kernel, for bf16
//   q at D = 64 or 128 with at most 16 query rows a (sequence, KV head)
//   (decode, any pool type): a split-KV walk, each (sequence, KV head)'s
//   live span cut into 256-position pieces, one block each, merged by a
//   second kernel in a fixed order; described in its section below.
// - paged_prefill_tc_kernel, for bf16 q at D = 64 or 128 with more than 16
//   query rows a (sequence, KV head): prefill chunks on the tensor cores,
//   described in its section below.
// - paged_attention_kernel, for fp32 and other D, on the CUDA cores, as
//   follows.
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

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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
  const int ntok = n_tokens[n];
  const int ctx = startp + ntok;
  const int* tbl = tables + (size_t)n * MB;

  // This tile's rows r = g*C + ci span chunk positions [ci_min, ci_max],
  // rows past the chunk's tokens (ci >= n_tokens) left out: they attend
  // nothing and are written as zeros.
  int ci_min = C, ci_max = -1;
  for (int r = r0; r < min(r0 + ROWS, GC); ++r) {
    const int ci = r % C;
    if (ci >= ntok) continue;
    ci_min = min(ci_min, ci);
    ci_max = max(ci_max, ci);
  }
  // Live positions: [lo, hi). Nothing past the context or the table, and no
  // row of this tile attends past its own position; with a window nothing
  // before startp + ci_min - window + 1. No live row: nothing.
  const int hi = ci_max < 0 ? 0 : min(min(ctx, MB * bs), startp + ci_max + 1);
  const int lo = ci_max < 0 ? 0 : window > 0 ? max(0, startp + ci_min - window + 1) : 0;

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
    // -1: no such row, or a row past n_tokens
    qpos[i] = r < GC && r - g * C < ntok ? startp + (r - g * C) : -1;
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

// ---- tensor-core prefill route (bf16 q, D = 64 or 128, G * C > 16)
//
// One block owns 64 query rows of one (sequence, KV head): rows r = ci * G
// + g (chunk position major, so that a decode row of a SplitFuse put and
// its G heads share one tile), 4 warps of 16 rows. It walks 64-position
// tiles of the live span of its rows, [lo, hi), with both products on the
// tensor cores through mma.cuh (mma.sync m16n8k16, bf16 operands, fp32
// accumulation; logits and output rows in accumulator fragments, the
// online softmax in registers, p rounded to bf16 as the A operand of p V,
// V read with ldmatrix.trans), as flash_attention.cu's forward does. K and
// V tiles are gathered through the block table (entry p / bs for position
// p; negative entries read block 0, as the JAX gather does) with 16-byte
// cp.async into a double-buffered ring: the next tile's gather is in flight
// while this tile's products run. Positions outside [lo, hi) are
// zero-filled, so no unwritten slot reaches a product. Quantized pools
// stage the codes; a conversion pass writes code * block scale (fp32,
// rounded once to bf16, as the plain version rounds its dequantized
// context) into the bf16 tiles the products read. sm_scale multiplies the
// fp32 logits, ALiBi adds slope * position in fp32, and the masks
// (causal, context, window, rows past n_tokens) are applied only on tiles
// that cross an edge. Rows past n_tokens are written as zeros; a block
// whose rows all lie there writes zeros and returns.

constexpr int kPfRows = 64;   // query rows a block
constexpr int kPfTile = 64;   // KV positions a tile
constexpr int kPfStages = 2;  // K/V tiles in the ring

template <typename P, int HD>
struct PfLayout {
  static constexpr bool kQuant = sizeof(P) == 1;
  static constexpr int STR = HD + 8;                       // bf16 tile pitch
  static constexpr int TILE = kPfTile * STR * 2;           // bytes of a bf16 tile
  static constexpr int CPITCH = kQuant ? HD + 16 : STR * 2;  // bytes a staged row
  static constexpr int STAGE = kPfTile * CPITCH;           // bytes of a staged tile
  // Q tile, then the staged K and V of each stage, then (quantized pools)
  // the converted K and V
  static constexpr size_t kBytes = (size_t)kPfRows * STR * 2 + 2 * kPfStages * (size_t)STAGE +
                                   (kQuant ? 2 * (size_t)TILE : 0);
};

// 16 codes (int8_t or __nv_fp8_e4m3) times a scale, in fp32, rounded to bf16
template <typename P>
__device__ __forceinline__ void pf_convert16(const P* c, float scale, __nv_bfloat16* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(c);
  const P* b = reinterpret_cast<const P*>(&raw);
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = pack2(__fmul_rn(static_cast<float>(b[2 * i]), scale),
                 __fmul_rn(static_cast<float>(b[2 * i + 1]), scale));
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
}

// grid (N, KH, ceil(G * C / 64)); 128 threads; PfLayout<P, HD>::kBytes of
// dynamic shared memory
template <typename P, int HD>
__global__ void __launch_bounds__(kThreads)
paged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q, const P* __restrict__ k_pool,
                        const P* __restrict__ v_pool, const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale, const int* __restrict__ tables,
                        const int* __restrict__ start_pos, const int* __restrict__ n_tokens,
                        const float* __restrict__ slopes, __nv_bfloat16* __restrict__ out,
                        int C, int H, int NB, int KH, int bs, int MB, int window,
                        float sm_scale) {
  using L = PfLayout<P, HD>;
  constexpr int STR = L::STR, DT = HD / 8;
  constexpr int CPR = HD * (int)sizeof(P) / 16;  // 16-byte chunks a pool row
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(sm);
  uint8_t* stage = sm + kPfRows * STR * 2;  // [kPfStages][K, V][kPfTile][CPITCH]
  const uint32_t stage_s = (uint32_t)__cvta_generic_to_shared(stage);

  const int n = blockIdx.x, kh = blockIdx.y;
  const int G = H / KH, GC = G * C;
  const int r0 = blockIdx.z * kPfRows;
  const int r_end = min(r0 + kPfRows, GC);
  const int tid = threadIdx.x, lane = tid & 31, m0 = (tid >> 5) * 16;
  const int gid = lane >> 2, tig = lane & 3;
  const int startp = start_pos[n], ntok = n_tokens[n];
  const int* tbl = tables + (size_t)n * MB;

  // the tile's chunk positions, capped by the chunk's own tokens
  const int ci_lo = r0 / G;
  const int ci_hi = min((r_end - 1) / G, ntok - 1);
  if (ci_lo > ci_hi) {  // every row lies past n_tokens: zeros
    for (int i = tid; i < (r_end - r0) * (HD / 8); i += kThreads) {
      const int r = r0 + i / (HD / 8), d = (i % (HD / 8)) * 8;
      const int ci = r / G, g = r - ci * G;
      *reinterpret_cast<uint4*>(out + ((size_t)(n * C + ci) * H + kh * G + g) * HD + d) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int cap = min(startp + ntok, MB * bs);  // context and table
  const int hi = min(cap, startp + ci_hi + 1);
  const int lo = window > 0 ? max(0, startp + ci_lo - window + 1) : 0;
  const int first = (lo / kPfTile) * kPfTile;
  const int n_tiles = hi > first ? (hi - first + kPfTile - 1) / kPfTile : 0;
  // every row of the tile is a live row
  const bool full = r0 + kPfRows <= GC && (r0 + kPfRows - 1) / G < ntok;

  // this thread's two rows: chunk position, query position (-1: past
  // n_tokens or past G * C, attends nothing), ALiBi slope
  int qpos[2];
  float slope[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + m0 + gid + 8 * hf;
    const int ci = r / G, g = r - ci * G;
    const bool live = r < GC && ci < ntok;
    qpos[hf] = live ? startp + ci : -1;
    slope[hf] = (slopes != nullptr && live) ? slopes[kh * G + g] : 0.f;
  }

  // Q rows: 16-byte chunks; rows past G * C are zero
  for (int i = tid; i < kPfRows * (HD / 8); i += kThreads) {
    const int rr = i / (HD / 8), d = (i % (HD / 8)) * 8, r = r0 + rr;
    const int ci = r / G, g = r - ci * G;
    const __nv_bfloat16* src = r < GC ? q + ((size_t)(n * C + ci) * H + kh * G + g) * HD + d : q;
    cp_async16((uint32_t)__cvta_generic_to_shared(Qs + rr * STR + d), src, r < GC ? 16 : 0);
  }
  // gather of the K and V tile at positions [p0, p0 + 64) into stage buf:
  // a thread's table entries are read first, all at once, then its copies
  // are issued
  constexpr int kChunks = kPfTile * CPR / kThreads;  // a thread's, of K and of V
  auto gather = [&](int p0, int buf) {
    size_t off[kChunks];
    bool live[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int i = tid + j * kThreads, sl = i / CPR, c = i - sl * CPR;
      const int p = p0 + sl;
      live[j] = p >= lo && p < hi;
      const int b = p / bs;
      const int blk = live[j] ? min(max(tbl[b], 0), NB - 1) : 0;
      off[j] = (((size_t)blk * KH + kh) * bs + (p - b * bs)) * HD + c * (16 / sizeof(P));
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int i = tid + j * kThreads, sl = i / CPR, c = i - sl * CPR;
      const uint32_t d = stage_s + (uint32_t)((2 * buf) * L::STAGE + sl * L::CPITCH + c * 16);
      cp_async16(d, live[j] ? k_pool + off[j] : k_pool, live[j] ? 16 : 0);
      cp_async16(d + L::STAGE, live[j] ? v_pool + off[j] : v_pool, live[j] ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kPfStages - 1; ++st) {
    if (st < n_tiles) gather(first + st * kPfTile, st);
    cp_async_commit();
  }

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;

  const int qpos_lo = startp + ci_lo, qpos_hi = startp + ci_hi;
  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = first + it * kPfTile, buf = it % kPfStages;
    // the stage of tile it + kPfStages - 1 was last read in iteration it - 1
    if (it + kPfStages - 1 < n_tiles)
      gather(j0 + (kPfStages - 1) * kPfTile, (it + kPfStages - 1) % kPfStages);
    cp_async_commit();
    cp_async_wait<kPfStages - 1>();  // this tile (and the Q rows) have landed
    __syncthreads();
    const __nv_bfloat16* Ks;
    const __nv_bfloat16* Vs;
    if constexpr (L::kQuant) {
      __nv_bfloat16* Kc = reinterpret_cast<__nv_bfloat16*>(stage + 2 * kPfStages * L::STAGE);
      __nv_bfloat16* Vc = Kc + kPfTile * STR;
      const uint8_t* src = stage + (2 * buf) * L::STAGE;
      for (int i = tid; i < kPfTile * (HD / 16); i += kThreads) {
        const int sl = i / (HD / 16), c = (i % (HD / 16)) * 16;
        const int p = j0 + sl;
        float ks = 0.f, vs = 0.f;  // dead positions hold zero codes
        if (p >= lo && p < hi) {
          const int blk = min(max(tbl[p / bs], 0), NB - 1);
          ks = k_scale[(size_t)blk * KH + kh];
          vs = v_scale[(size_t)blk * KH + kh];
        }
        pf_convert16(reinterpret_cast<const P*>(src + sl * L::CPITCH + c), ks,
                     Kc + sl * STR + c);
        pf_convert16(reinterpret_cast<const P*>(src + L::STAGE + sl * L::CPITCH + c), vs,
                     Vc + sl * STR + c);
      }
      __syncthreads();
      Ks = Kc;
      Vs = Vc;
    } else {
      Ks = reinterpret_cast<const __nv_bfloat16*>(stage + (2 * buf) * L::STAGE);
      Vs = reinterpret_cast<const __nv_bfloat16*>(stage + (2 * buf + 1) * L::STAGE);
    }

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    tc_dot_nt<HD>(s, Qs, Ks, m0, gid, tig);

    // every (row, position) pair attends: all rows live, the tile inside
    // the context, before every row's position, inside every row's window
    const bool dense = full && j0 >= lo && j0 + kPfTile <= hi && j0 + kPfTile - 1 <= qpos_lo &&
                       (window <= 0 || qpos_hi - j0 < window);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, p = j0 + nt * 8 + tig * 2 + (e & 1);
        const bool keep = dense || (p < cap && p <= qpos[hf] &&
                                    (window <= 0 || qpos[hf] - p < window));
        s[nt][e] = keep ? s[nt][e] * sm_scale + slope[hf] * (float)p : kNegInf;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = m_r[hf];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hf], s[nt][2 * hf + 1]));
      mx = quad_max(mx);
      const float alpha = expf(m_r[hf] - mx);
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          const float pv = s[nt][e] > kMasked ? expf(s[nt][e] - mx) : 0.f;
          s[nt][e] = pv;
          rs += pv;
        }
      rs = quad_sum(rs);
      l_r[hf] = l_r[hf] * alpha + rs;
      m_r[hf] = mx;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        oacc[dt][2 * hf] *= alpha;
        oacc[dt][2 * hf + 1] *= alpha;
      }
    }
    tc_dot_acc<HD>(oacc, s, Vs, lane);
    __syncthreads();  // this buffer (and the converted tiles) are free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + m0 + gid + 8 * hf;
    if (r >= GC) continue;
    const int ci = r / G, g = r - ci * G;
    // a row past n_tokens has l = 0 and acc = 0: zeros
    const float inv = 1.f / fmaxf(l_r[hf], 1e-30f);
    __nv_bfloat16* dst = out + ((size_t)(n * C + ci) * H + kh * G + g) * HD;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8 + tig * 2) =
          pack2(oacc[dt][2 * hf] * inv, oacc[dt][2 * hf + 1] * inv);
  }
}

template <typename P, int HD>
cudaError_t launch_prefill_tc(const void* q, const void* k_pool, const void* v_pool,
                              const float* k_scale, const float* v_scale, const int* tables,
                              const int* start_pos, const int* n_tokens, const float* slopes,
                              void* out, int N, int C, int H, int NB, int KH, int bs, int MB,
                              int window, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = PfLayout<P, HD>::kBytes;
  auto kernel = paged_prefill_tc_kernel<P, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int GC = (H / KH) * C;
  const dim3 grid(N, KH, (GC + kPfRows - 1) / kPfRows);
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables, start_pos, n_tokens, slopes,
      static_cast<__nv_bfloat16*>(out), C, H, NB, KH, bs, MB, window, sm_scale);
  return cudaGetLastError();
}


// ---- split-KV decode route (bf16 q, D = 64 or 128, G * C <= 16)
//
// Decode reads each live K/V byte once for at most 16 query rows a
// (sequence, KV head), so the card's memory rate bounds it, and reaching
// that rate needs bytes in flight on every SM. A (sequence, KV head)'s live
// span [lo, hi) (the window's first position to the context's end, as
// paged_attention_kernel walks it) is cut at multiples of kSplitPiece = 256
// positions, a multiple of every served block size (16 for serving, 128
// for v1), and each piece is one block: grid (N, KH, n_split), n_split the
// most pieces any span of these shapes can cover (decode_splits; the
// wrapper sizes the scratch with it through paged_decode_splits). A piece with no live position writes a
// neutral partial (m = -inf, l = 0) and returns.
//
// Inside a block the 4 warps share the piece: warp w owns its positions
// [64 w, 64 w + 64), two tiles of 32, one position a lane. A warp issues
// both tiles' K and V rows at once, as raw pool bytes (bf16, int8 or fp8
// codes) in 16-byte cp.async copies gathered through the block table
// (negative entries read block 0; dead positions are zero-filled), into a
// region of shared memory of its own: nothing is converted or staged in
// fp32, and no barrier of the block is crossed while they land. The
// group's G * C query rows are staged once as fp32 pre-scaled by sm_scale
// and read as broadcasts (every lane reads the same q value at once). Lane
// j scores position j against all the rows with 16-byte reads of its K
// row; then the online softmax of paged_attention_kernel (fp32 max and sum
// by warp shuffles) and p V with each lane owning D / 32 adjacent output
// columns, p_j and V's block scale broadcast from lane j. Quantized codes
// become code * block scale in fp32 before each product, as in
// paged_attention_kernel; all arithmetic is fp32. The four warps' (m, l,
// acc) are merged in shared memory in warp order, and the block writes its
// partial to fp32 scratch [N, KH, n_split, R] (m, l) and [.., R, D] (acc).
// paged_decode_combine_kernel then merges the pieces of each (sequence, KV
// head) in piece order and writes the rows: the same inputs give the same
// bits on every run. Rows past n_tokens, and rows that attend nothing, have
// l = 0 in every piece and are written as zeros.

constexpr int kSplitPiece = 256;                                  // positions a block
constexpr int kSplitTile = 32;                                    // positions a warp tile
constexpr int kSplitWarpTiles = kSplitPiece / (kWarps * kSplitTile);  // tiles a warp: 2

// The most pieces a live span can cover: spans lie inside the table's MB *
// bs positions, and with a window they hold at most window + C - 1
// positions, wherever they start.
long long decode_splits(int MB, int bs, int C, int window) {
  const long long all = (long long)MB * bs;
  const long long n_all = (all + kSplitPiece - 1) / kSplitPiece;
  if (window <= 0) return n_all;
  const long long span = std::min(all, (long long)window + C - 1);
  return std::min(n_all, (span + kSplitPiece - 2) / kSplitPiece + 1);
}

template <typename P, int HD, int RT>
struct SplitLayout {
  static constexpr int ROW = HD * (int)sizeof(P) + 16;  // bytes a staged row: 16-byte
                                                        // reads of 8 lanes in 8 rows
                                                        // fall in distinct banks
  static constexpr int TILE = kSplitTile * ROW;         // bytes of a K (or V) tile
  static constexpr size_t kStage = (size_t)kWarps * kSplitWarpTiles * 2 * TILE;
  static constexpr size_t kMerge = (size_t)kWarps * RT * (HD + 2) * sizeof(float);
  static constexpr size_t kBytes =
      (size_t)RT * HD * sizeof(float) + (kStage > kMerge ? kStage : kMerge);
};

// 16 staged bytes (8 bf16 or 16 codes) to fp32
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16*, uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
template <typename P>
__device__ __forceinline__ void chunk_f32(const P*, uint4 raw, float* f) {
  const P* b = reinterpret_cast<const P*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }

// DCH adjacent values of a staged row to fp32, in one 2-, 4- or 8-byte read
template <int DCH, typename P>
__device__ __forceinline__ void cols_f32(const P* p, float* f) {
  constexpr int kBytes = DCH * (int)sizeof(P);
  using W = typename std::conditional<
      kBytes == 8, uint2, typename std::conditional<kBytes == 4, uint32_t, uint16_t>::type>::type;
  const W raw = *reinterpret_cast<const W*>(p);
  const P* b = reinterpret_cast<const P*>(&raw);
#pragma unroll
  for (int c = 0; c < DCH; ++c) f[c] = to_f32(b[c]);
}

// grid (N, KH, n_split); 128 threads; SplitLayout<P, HD, RT>::kBytes of
// dynamic shared memory. part_ml [N, KH, n_split, R, 2] (m, l) and part_acc
// [N, KH, n_split, R, HD], R = G * C <= RT.
template <typename P, int HD, int RT>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q, const P* __restrict__ k_pool,
                          const P* __restrict__ v_pool, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, const int* __restrict__ tables,
                          const int* __restrict__ start_pos, const int* __restrict__ n_tokens,
                          const float* __restrict__ slopes, float* __restrict__ part_ml,
                          float* __restrict__ part_acc, int C, int H, int NB, int KH, int bs,
                          int MB, int window, float sm_scale) {
  using L = SplitLayout<P, HD, RT>;
  constexpr bool kQuant = sizeof(P) == 1;
  constexpr int EPC = 16 / (int)sizeof(P);    // values in 16 bytes
  constexpr int CPR = HD / EPC;               // 16-byte chunks a row
  constexpr int DCH = HD / 32;                // output columns a lane
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [RT][HD]
  uint8_t* stage = reinterpret_cast<uint8_t*>(q_s + RT * HD);
  const int n = blockIdx.x, kh = blockIdx.y, j = blockIdx.z;
  const int n_split = gridDim.z;
  const int G = H / KH, R = G * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int startp = start_pos[n], ntok = n_tokens[n];
  const int* tbl = tables + (size_t)n * MB;
  const size_t piece = ((size_t)n * KH + kh) * n_split + j;

  // the group's live span, as paged_attention_kernel's: rows r = g * C + ci
  // with ci < n_tokens; then this piece's share of it
  const int ci_max = min(C, ntok) - 1;
  const int hi = ci_max < 0 ? 0 : min(min(startp + ntok, MB * bs), startp + ci_max + 1);
  const int lo = ci_max < 0 ? 0 : window > 0 ? max(0, startp - window + 1) : 0;
  const int p0 = (lo / kSplitPiece) * kSplitPiece + j * kSplitPiece;
  const int p_lo = max(p0, lo), p_hi = min(p0 + kSplitPiece, hi);
  if (p_lo >= p_hi) {  // nothing live here: a neutral partial
    for (int r = tid; r < R; r += kThreads) {
      part_ml[(piece * R + r) * 2] = -INFINITY;
      part_ml[(piece * R + r) * 2 + 1] = 0.f;
    }
    return;
  }

  // this warp's tiles: K and V rows of positions w0 + 32 t + row
  const int w0 = p0 + warp * kSplitWarpTiles * kSplitTile;
  uint8_t* kst = stage + (size_t)warp * kSplitWarpTiles * 2 * L::TILE;  // [t][K, V][32][ROW]
  const uint32_t kst_s = (uint32_t)__cvta_generic_to_shared(kst);
#pragma unroll
  for (int t = 0; t < kSplitWarpTiles; ++t) {
    const int t0 = w0 + t * kSplitTile;
#pragma unroll
    for (int k = 0; k < CPR; ++k) {
      const int i = lane + 32 * k, row = i / CPR, c = i - row * CPR;
      const int p = t0 + row;
      const bool live = p >= p_lo && p < p_hi;
      const int b = p / bs;
      const int blk = live ? min(max(tbl[b], 0), NB - 1) : 0;
      const size_t off = (((size_t)blk * KH + kh) * bs + (p - b * bs)) * HD + c * EPC;
      const uint32_t d = kst_s + (uint32_t)((2 * t) * L::TILE + row * L::ROW + c * 16);
      cp_async16(d, live ? k_pool + off : k_pool, live ? 16 : 0);
      cp_async16(d + L::TILE, live ? v_pool + off : v_pool, live ? 16 : 0);
    }
    cp_async_commit();
  }

  // the rows, pre-scaled, as fp32; rows past R are zero
  for (int i = tid; i < RT * (HD / 8); i += kThreads) {
    const int r = i / (HD / 8), d = (i - r * (HD / 8)) * 8;
    float vals[8];
    if (r < R) {
      const int g = r / C, ci = r - g * C;
      load8(q + ((size_t)(n * C + ci) * H + kh * G + g) * HD + d, vals);
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] *= sm_scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = 0.f;
    }
    *reinterpret_cast<float4*>(q_s + r * HD + d) = make_float4(vals[0], vals[1], vals[2], vals[3]);
    *reinterpret_cast<float4*>(q_s + r * HD + d + 4) =
        make_float4(vals[4], vals[5], vals[6], vals[7]);
  }
  __syncthreads();  // q staged

  float m[RT], l[RT], slope[RT], acc[RT][DCH];
  int qpos[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int g = r / C, ci = r - g * C;
    // -1: no such row, or a row past n_tokens
    qpos[r] = r < R && ci < ntok ? startp + ci : -1;
    slope[r] = (slopes != nullptr && r < R) ? slopes[kh * G + g] : 0.f;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kSplitWarpTiles; ++t) {
    if (t == 0)
      cp_async_wait<kSplitWarpTiles - 1>();
    else
      cp_async_wait<0>();
    __syncwarp();  // every lane's copies of tile t have landed
    const int t0 = w0 + t * kSplitTile;
    if (t0 >= p_hi || t0 + kSplitTile <= p_lo) continue;  // warp-uniform: nothing live
    const int pos = t0 + lane;
    const bool pos_live = pos >= p_lo && pos < p_hi;
    float ks = 1.f, vs = 1.f;  // this lane's position's block scales
    if (kQuant && pos_live) {
      const int blk = min(max(tbl[pos / bs], 0), NB - 1);
      ks = k_scale[(size_t)blk * KH + kh];
      vs = v_scale[(size_t)blk * KH + kh];
    }

    // scores: lane j against position t0 + j, for every row
    float sc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) sc[r] = 0.f;
    const uint8_t* krow = kst + (2 * t) * L::TILE + lane * L::ROW;
#pragma unroll 2
    for (int c = 0; c < CPR; ++c) {
      float kf[EPC];
      chunk_f32(static_cast<const P*>(nullptr), *reinterpret_cast<const uint4*>(krow + c * 16),
                kf);
      if (kQuant) {
#pragma unroll
        for (int e = 0; e < EPC; ++e) kf[e] *= ks;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int e = 0; e < EPC; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + r * HD + c * EPC + e);
          sc[r] = fmaf(qv.x, kf[e], sc[r]);
          sc[r] = fmaf(qv.y, kf[e + 1], sc[r]);
          sc[r] = fmaf(qv.z, kf[e + 2], sc[r]);
          sc[r] = fmaf(qv.w, kf[e + 3], sc[r]);
        }
      }
    }

    // online softmax update (fp32), one row at a time
    float p[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float s = sc[r] + slope[r] * (float)pos;
      const bool keep = pos_live && pos <= qpos[r] && (window <= 0 || qpos[r] - pos < window);
      const float mt = warp_max(keep ? s : -INFINITY);
      p[r] = 0.f;
      if (mt == -INFINITY) continue;  // warp-uniform: nothing live for this row
      const float m_new = fmaxf(m[r], mt);
      const float alpha = expf(m[r] - m_new);  // 0 on the row's first live tile
      p[r] = keep ? expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[r][c] *= alpha;
    }

    // acc += p V: p_j and V's scale come from lane j; a lane owns DCH
    // adjacent columns
    const P* vt = reinterpret_cast<const P*>(kst + (2 * t + 1) * L::TILE) + lane * DCH;
    const int jn = min(kSplitTile, p_hi - t0);
    for (int jj = 0; jj < jn; ++jj) {
      float vv[DCH];
      cols_f32<DCH>(reinterpret_cast<const P*>(reinterpret_cast<const uint8_t*>(vt) + jj * L::ROW),
                    vv);
      if (kQuant) {
        const float vj = __shfl_sync(0xffffffffu, vs, jj);
#pragma unroll
        for (int c = 0; c < DCH; ++c) vv[c] *= vj;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], jj);
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

  // merge the warps' (m, l, acc) in warp order: the staged tiles are free
  // once every warp is past its last product
  __syncthreads();
  float* wml = reinterpret_cast<float*>(stage);  // [kWarps][RT][2]
  float* wacc = wml + kWarps * RT * 2;           // [kWarps][RT][HD]
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (lane == 0) {
      wml[(warp * RT + r) * 2] = m[r];
      wml[(warp * RT + r) * 2 + 1] = l[r];
    }
#pragma unroll
    for (int c = 0; c < DCH; ++c) wacc[(warp * RT + r) * HD + lane * DCH + c] = acc[r][c];
  }
  __syncthreads();
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[(w * RT + r) * 2]);
    float ls = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = wml[(w * RT + r) * 2];
        if (mw == -INFINITY) continue;  // this warp saw nothing of the row
        const float sc = expf(mw - mx);
        ls += wml[(w * RT + r) * 2 + 1] * sc;
        a += wacc[(w * RT + r) * HD + d] * sc;
      }
    }
    part_acc[(piece * R + r) * HD + d] = a;
    if (d == 0) {
      part_ml[(piece * R + r) * 2] = mx;
      part_ml[(piece * R + r) * 2 + 1] = ls;
    }
  }
}

// grid (N, KH); 128 threads. Merges the n_split pieces of each row in piece
// order and writes out [N, C, H, HD] in bf16 (rows past n_tokens: zeros).
template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_combine_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                            __nv_bfloat16* __restrict__ out, int C, int H, int KH, int n_split) {
  const int n = blockIdx.x, kh = blockIdx.y;
  const int G = H / KH, R = G * C;
  const size_t first = ((size_t)n * KH + kh) * n_split;  // piece 0 of this group
  for (int i = threadIdx.x; i < R * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), d = (i - r * (HD / 4)) * 4;
    float mx = -INFINITY;
    for (int j = 0; j < n_split; ++j) mx = fmaxf(mx, part_ml[((first + j) * R + r) * 2]);
    float ls = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
    if (mx != -INFINITY) {
      for (int j = 0; j < n_split; ++j) {
        const float mj = part_ml[((first + j) * R + r) * 2];
        if (mj == -INFINITY) continue;  // a neutral piece: its acc was never written
        const float sc = expf(mj - mx);
        ls += part_ml[((first + j) * R + r) * 2 + 1] * sc;
        const float4 v =
            *reinterpret_cast<const float4*>(part_acc + ((first + j) * R + r) * HD + d);
        a[0] += v.x * sc;
        a[1] += v.y * sc;
        a[2] += v.z * sc;
        a[3] += v.w * sc;
      }
    }
    const float den = fmaxf(ls, 1e-30f);
    const int g = r / C, ci = r - g * C;
    __nv_bfloat16* dst = out + ((size_t)(n * C + ci) * H + kh * G + g) * HD + d;
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack2(a[0] / den, a[1] / den), pack2(a[2] / den, a[3] / den));
  }
}

template <typename P, int HD, int RT>
cudaError_t launch_decode_split(const void* q, const void* k_pool, const void* v_pool,
                                const float* k_scale, const float* v_scale, const int* tables,
                                const int* start_pos, const int* n_tokens, const float* slopes,
                                float* ws, void* out, int N, int C, int H, int NB, int KH, int bs,
                                int MB, int window, float sm_scale, int n_split,
                                cudaStream_t stream) {
  constexpr size_t smem = SplitLayout<P, HD, RT>::kBytes;
  auto kernel = paged_decode_split_kernel<P, HD, RT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int R = (H / KH) * C;
  float* part_ml = ws;
  float* part_acc = ws + (size_t)N * KH * n_split * R * 2;
  kernel<<<dim3(N, KH, n_split), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const P*>(k_pool),
      static_cast<const P*>(v_pool), k_scale, v_scale, tables, start_pos, n_tokens, slopes,
      part_ml, part_acc, C, H, NB, KH, bs, MB, window, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<HD><<<dim3(N, KH), kThreads, 0, stream>>>(
      part_ml, part_acc, static_cast<__nv_bfloat16*>(out), C, H, KH, n_split);
  return cudaGetLastError();
}

template <typename P, int HD>
cudaError_t launch_decode_split_r(int R, const void* q, const void* k_pool, const void* v_pool,
                                  const float* k_scale, const float* v_scale, const int* tables,
                                  const int* start_pos, const int* n_tokens, const float* slopes,
                                  float* ws, void* out, int N, int C, int H, int NB, int KH,
                                  int bs, int MB, int window, float sm_scale, int n_split,
                                  cudaStream_t stream) {
  if (R <= 4)
    return launch_decode_split<P, HD, 4>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                         start_pos, n_tokens, slopes, ws, out, N, C, H, NB,
                                         KH, bs, MB, window, sm_scale, n_split, stream);
  return launch_decode_split<P, HD, 16>(q, k_pool, v_pool, k_scale, v_scale, tables, start_pos,
                                        n_tokens, slopes, ws, out, N, C, H, NB, KH, bs, MB,
                                        window, sm_scale, n_split, stream);
}

}  // namespace

// The pieces route 3 cuts each (sequence, KV head)'s live span into (its
// grid's third extent); the wrapper sizes route 3's scratch with it.
extern "C" long long paged_decode_splits(int MB, int bs, int C, int window) {
  return decode_splits(MB, bs, C, window);
}

// dtype: 0 = float32, 1 = bfloat16 (q and out share it).
// pool_dtype: 0 = q's dtype; 2 = int8, 3 = float8_e4m3fn, each with the
// scale planes k_scale/v_scale [NB, KH] float32 (null for dtype 0).
// route (chosen by ops/paged_attention.py::paged_route from the shapes):
//   0 paged_attention_kernel, 1 query row a warp (decode: G * C <= 16)
//   1 paged_attention_kernel, 8 query rows a warp
//   2 paged_prefill_tc_kernel (bf16 q, D = 64 or 128)
//   3 paged_decode_split_kernel + paged_decode_combine_kernel (bf16 q,
//     D = 64 or 128, G * C <= 16): ws is fp32 scratch of N * KH * n_split
//     * G * C * (D + 2) values, n_split = paged_decode_splits(MB, bs, C,
//     window) (null for the other routes)
// slopes: [H] float32 ALiBi slopes, or null. Returns a cudaError_t.
extern "C" int paged_attention_fwd(const void* q, const void* k_pool,
                                   const void* v_pool, const void* k_scale,
                                   const void* v_scale, const void* tables,
                                   const void* start_pos, const void* n_tokens,
                                   const void* slopes, void* out, void* ws, int N,
                                   int C, int H, int D, int NB, int KH, int bs,
                                   int MB, int window, float sm_scale,
                                   int dtype, int pool_dtype, int route,
                                   void* stream) {
  const bool quant = pool_dtype == 2 || pool_dtype == 3;
  const bool tc_shape = dtype == 1 && (D == 64 || D == 128);
  if (N <= 0 || C <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || D <= 0 ||
      D % 8 != 0 || D > 256 || NB <= 0 || bs <= 0 || MB <= 0 ||
      route < 0 || route > 3 || (route >= 2 && !tc_shape) ||
      (dtype != 0 && dtype != 1) || (pool_dtype != 0 && !quant) ||
      (quant != (k_scale != nullptr && v_scale != nullptr)))
    return cudaErrorInvalidValue;
  if (route == 3) {
    const int R = (H / KH) * C;
    const long long n_split = decode_splits(MB, bs, C, window);
    if (R > 16 || ws == nullptr || n_split > 65535) return cudaErrorInvalidValue;
#define DS_SPLIT(P, HD)                                                                      \
  return launch_decode_split_r<P, HD>(R, q, k_pool, v_pool, static_cast<const float*>(k_scale), \
                                      static_cast<const float*>(v_scale),                      \
                                      static_cast<const int*>(tables),                         \
                                      static_cast<const int*>(start_pos),                      \
                                      static_cast<const int*>(n_tokens),                       \
                                      static_cast<const float*>(slopes),                       \
                                      static_cast<float*>(ws), out, N, C, H, NB, KH, bs, MB,   \
                                      window, sm_scale, n_split,                               \
                                      static_cast<cudaStream_t>(stream))
    if (D == 64) {
      if (pool_dtype == 2) DS_SPLIT(int8_t, 64);
      if (pool_dtype == 3) DS_SPLIT(__nv_fp8_e4m3, 64);
      DS_SPLIT(__nv_bfloat16, 64);
    }
    if (pool_dtype == 2) DS_SPLIT(int8_t, 128);
    if (pool_dtype == 3) DS_SPLIT(__nv_fp8_e4m3, 128);
    DS_SPLIT(__nv_bfloat16, 128);
#undef DS_SPLIT
  }
  const int dch = (D + 31) / 32;
  const int* tb = static_cast<const int*>(tables);
  const int* sp = static_cast<const int*>(start_pos);
  const int* nt = static_cast<const int*>(n_tokens);
  const float* sl = static_cast<const float*>(slopes);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2) {
#define DS_TC(P, HD)                                                                   \
  return launch_prefill_tc<P, HD>(q, k_pool, v_pool, ks, vs, tb, sp, nt, sl, out, N, C, H, \
                                  NB, KH, bs, MB, window, sm_scale, st)
    if (D == 64) {
      if (pool_dtype == 2) DS_TC(int8_t, 64);
      if (pool_dtype == 3) DS_TC(__nv_fp8_e4m3, 64);
      DS_TC(__nv_bfloat16, 64);
    }
    if (pool_dtype == 2) DS_TC(int8_t, 128);
    if (pool_dtype == 3) DS_TC(__nv_fp8_e4m3, 128);
    DS_TC(__nv_bfloat16, 128);
#undef DS_TC
  }
  const int rows_per_warp = route == 0 ? 1 : 8;
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
