// Flash attention for training, forward and backward, written by hand for
// Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/flash_attention.py::_fwd_kernel (:92),
// ::_dq_kernel (:148) and ::_dkv_kernel (:190), the three Pallas kernels
// behind flash_attention (:442) and its custom_vjp.
//
// What they compute. q [B, T, H, D], k and v [B, S, KH, D] (H % KH == 0: query
// head h reads KV head h / (H / KH)), bf16, fp16 or fp32, arithmetic in fp32.
// With offs = S - T, row r attends column c iff c < S, and (causal)
// c <= r + offs, and (window > 0) r + offs - c < window.
//   forward: s = (q * scale) k^T on the attended pairs, o = softmax(s) v,
//            lse = m + log l per (b, h, row)         (scale folded into q)
//   delta:   delta = rowsum(do * o) per (b, h, row)  (a pre-pass of its own:
//            the Pallas kernels recompute it in every grid step)
//   dq:      p = exp(s * scale - lse), dp = do v^T, ds = p * (dp - delta) *
//            scale, dq = ds k                        (scale applied to s)
//   dkv:     dv = sum over the group's query heads and all live rows of
//            p^T do, dk = the same sum of ds^T q
//
// What does not carry over from the TPU. The Pallas grids walk the KV (or
// query) blocks in order as their innermost dimension and keep the running
// sums in VMEM; CUDA blocks run in no order. Here one block owns one output
// tile and loops over the live tiles of the other side itself: forward and
// dq own (b, h, tile of query rows) and loop from the window's first column
// to the causal diagonal; dkv owns (b, KV head, tile of KV rows) and loops
// over the group's query heads and, for each, from the first row that sees
// the tile to the last row whose window still holds it. Every output is
// written once, by one block, with no atomics, so results do not depend on
// scheduling. Any T and S (tail rows and columns are masked), any D with
// D % 8 == 0 up to 256. Masked pairs get p = 0 explicitly, so a row that has
// seen no live column yet carries m = -1e30, l = 0, acc = 0 and nothing has
// to heal later.
//
// What bounds it on an H100: operations. Per attended pair the forward does
// 4 D flops, dq 6 D and dkv 8 D against a few bytes of q, k, v per pair
// after tiling. Two sets of kernels share the structure above, one route
// each (the wrapper's flash_route picks it; the entries refuse a route the
// call does not meet):
// - bf16 with D = 64 or 128 and scale > 0 (the training widths) runs every
//   product on the tensor cores with wgmma, with the next tile in flight
//   behind the products (see "wgmma kernels" below): flash_fwd_wgmma_kernel,
//   flash_dq_wgmma_kernel, flash_dkv_wgmma_kernel.
// - fp32, fp16, and bf16 at any other D, does the products in fp32 on the
//   CUDA cores (67 TFLOP/s peak against 989 on the bf16 tensor cores), so
//   that fp32 inputs keep fp32 accuracy: 256 threads as a 16 x 16 grid, each with
//   a (BM/16) x (BN/16) register tile of the logits, operands staged in
//   shared memory as fp32 and read 16 bytes at a time with the tile's rows
//   and columns strided by 16 so that those reads are free of bank
//   conflicts. This path folds sm_scale into q in the forward and scales
//   the logits after the product in the backward, as the Pallas kernels do.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ void load8(const __half* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c,
                                       float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store4(__half* p, float a, float b, float c, float d) {
  const __half2 lo = __floats2half2_rn(a, b);
  const __half2 hi = __floats2half2_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// max / sum over the 16 threads that share a tile row (tx = lane % 16)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [row0, row0 + ROWS) of one (batch, head) of a [*, n_rows, heads,
// D] tensor into shared memory as fp32, times `scale`: s[r][0 .. DP), row
// stride DP + 4. `g` points at (batch, row 0, head, 0); `row_stride` is
// heads * D. Rows at or past n_rows and columns at or past D are zero.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* s, const T* g, long long row_stride,
                                          int row0, int n_rows, int D, float scale) {
  constexpr int DS = DP + 4;
  constexpr int CH = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH;
    const int d = (idx % CH) * 8;
    const int row = row0 + r;
    float v[8];
    if (row < n_rows && d < D) {
      load8(g + (long long)row * row_stride + d, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
    float* dst = s + r * DS + d;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ __forceinline__ bool attends(int row, int col, int offs, int S, int causal,
                                        int window) {
  if (col >= S) return false;
  if (causal && col > row + offs) return false;
  if (window > 0 && row + offs - col >= window) return false;
  return true;
}

// Does every (row, column) pair of rows [r0, r0 + nr) x columns [c0, c0 +
// nc) attend?
__device__ __forceinline__ bool span_is_dense(int r0, int nr, int c0, int nc, int n_rows,
                                              int offs, int S, int causal, int window) {
  if (c0 + nc > S || r0 + nr > n_rows) return false;
  if (causal && c0 + nc - 1 > r0 + offs) return false;
  if (window > 0 && r0 + nr - 1 + offs - c0 >= window) return false;
  return true;
}

// out[RI][CJ] += A[ty + 16 i][:] . B[tx + 16 j][:] over d in [0, D)
template <int RI, int CJ, int DS>
__device__ __forceinline__ void dot_tile(float (&out)[RI][CJ], const float* A,
                                         const float* Bm, int ty, int tx, int D) {
  for (int d = 0; d < D; d += 4) {
    float4 a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * DS + d);
#pragma unroll
    for (int j = 0; j < CJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * DS + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        out[i][j] += a[i].x * b[j].x + a[i].y * b[j].y + a[i].z * b[j].z + a[i].w * b[j].w;
  }
}

// acc[i][4 jj + e] += sum over c in [0, N) of P[ty + 16 i][c] * V[c][tx * 4 +
// 64 jj + e]; P has row stride PS, V row stride DS.
template <int RI, int NJ, int PS, int DS>
__device__ __forceinline__ void accum_tile(float (&acc)[RI][4 * NJ], const float* P,
                                           const float* V, int ty, int tx, int N) {
  for (int c = 0; c < N; c += 4) {
    float4 p4[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      p4[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * PS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(V + (c + cc) * DS + tx * 4 + 64 * jj);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float p = cc == 0 ? p4[i].x : cc == 1 ? p4[i].y : cc == 2 ? p4[i].z : p4[i].w;
          acc[i][4 * jj + 0] += p * v4.x;
          acc[i][4 * jj + 1] += p * v4.y;
          acc[i][4 * jj + 2] += p * v4.z;
          acc[i][4 * jj + 3] += p * v4.w;
        }
      }
    }
  }
}

// Write acc (times mul[i]) to rows row0 + ty + 16 i < n_rows of out, whose
// pointer is at (batch, row 0, head, 0).
template <typename T, int RI, int NJ>
__device__ __forceinline__ void store_tile(T* out, long long row_stride, int row0,
                                           int n_rows, int D, int ty, int tx,
                                           const float (&acc)[RI][4 * NJ],
                                           const float (&mul)[RI]) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = tx * 4 + 64 * jj;
      if (d < D)
        store4(out + (long long)row * row_stride + d, acc[i][4 * jj] * mul[i],
               acc[i][4 * jj + 1] * mul[i], acc[i][4 * jj + 2] * mul[i],
               acc[i][4 * jj + 3] * mul[i]);
    }
  }
}

// ------------------------------------------------------------------ forward
// grid (query tiles, H, B). Shared: Qs [BM][DS], Ks [BN][DS], Vs [BN][DS];
// the probabilities Ps [BM][BN + 4] reuse Ks once the logits are done.
template <typename T, int NJ, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int Tq, int S, int H, int KH, int D, int causal, int window,
                 float scale) {
  constexpr int DP = 64 * NJ, DS = DP + 4, RI = BM / 16, CJ = BN / 16, PS = BN + 4;
  static_assert(BM * PS <= BN * DS, "Ps must fit in Ks");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BM * DS;
  float* Vs = Ks + BN * DS;
  float* Ps = Ks;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int offs = S - Tq;
  const long long q_stride = (long long)H * D, kv_stride = (long long)KH * D;
  const T* qg = q + ((long long)b * Tq * H + h) * D;
  const T* kg = k + ((long long)b * S * KH + kh) * D;
  const T* vg = v + ((long long)b * S * KH + kh) * D;

  load_tile<T, BM, DP>(Qs, qg, q_stride, q0, Tq, D, scale);

  const int q_last = min(q0 + BM, Tq) - 1;
  const int col_hi = causal ? min(S, q_last + offs + 1) : S;
  const int col_lo = window > 0 ? max(0, q0 + offs - window + 1) : 0;

  float m[RI], l[RI], acc[RI][4 * NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = (col_lo / BN) * BN; j0 < col_hi; j0 += BN) {
    __syncthreads();  // the last tile's reads of Ps and Vs are done
    load_tile<T, BN, DP>(Ks, kg, kv_stride, j0, S, D, 1.f);
    load_tile<T, BN, DP>(Vs, vg, kv_stride, j0, S, D, 1.f);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    dot_tile<RI, CJ, DS>(s, Qs, Ks, ty, tx, D);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = j0 + tx + 16 * j;
        if (!attends(row, col, offs, S, causal, window)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float alpha = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = s[i][j] > kMasked ? expf(s[i][j] - mx) : 0.f;
        s[i][j] = p;
        rs += p;
      }
      rs = row_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 4 * NJ; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done with Ks before Ps overwrites it
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    __syncthreads();
    accum_tile<RI, NJ, PS, DS>(acc, Ps, Vs, ty, tx, BN);
  }

  float inv[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / li;
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < Tq) lse[((long long)b * H + h) * Tq + row] = m[i] + logf(li);
  }
  T* og = o + ((long long)b * Tq * H + h) * D;
  store_tile<T, RI, NJ>(og, q_stride, q0, Tq, D, ty, tx, acc, inv);
}

// -------------------------------------------------------------------- delta
// delta[b, h, t] = sum_d do[b, t, h, d] * o[b, t, h, d]; one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                   float* __restrict__ delta, long long rows, int Tq, int H, int D) {
  const long long n = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (n >= rows) return;
  const T* op = o + n * D;
  const T* dp = dO + n * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += to_f32(op[d]) * to_f32(dp[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const long long bt = n / H;
    const int hh = (int)(n % H);
    const long long bb = bt / Tq;
    const int t = (int)(bt % Tq);
    delta[(bb * H + hh) * Tq + t] = sum;
  }
}

// ----------------------------------------------------------------------- dq
// grid (query tiles, H, B). Shared: Qs, dOs [BM][DS], Ks, Vs [BN][DS]; the
// ds tile [BM][BN + 4] reuses Vs once dp is done.
template <typename T, int NJ, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dO,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int Tq, int S, int H, int KH, int D, int causal,
                int window, float scale) {
  constexpr int DP = 64 * NJ, DS = DP + 4, RI = BM / 16, CJ = BN / 16, PS = BN + 4;
  static_assert(BM * PS <= BN * DS, "dSs must fit in Vs");
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BM * DS;
  float* Ks = dOs + BM * DS;
  float* Vs = Ks + BN * DS;
  float* dSs = Vs;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int offs = S - Tq;
  const long long q_stride = (long long)H * D, kv_stride = (long long)KH * D;
  const T* qg = q + ((long long)b * Tq * H + h) * D;
  const T* dog = dO + ((long long)b * Tq * H + h) * D;
  const T* kg = k + ((long long)b * S * KH + kh) * D;
  const T* vg = v + ((long long)b * S * KH + kh) * D;

  load_tile<T, BM, DP>(Qs, qg, q_stride, q0, Tq, D, 1.f);
  load_tile<T, BM, DP>(dOs, dog, q_stride, q0, Tq, D, 1.f);

  float lse_r[RI], delta_r[RI], acc[RI][4 * NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = ((long long)b * H + h) * Tq + row;
    lse_r[i] = row < Tq ? lse[at] : 0.f;
    delta_r[i] = row < Tq ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BM, Tq) - 1;
  const int col_hi = causal ? min(S, q_last + offs + 1) : S;
  const int col_lo = window > 0 ? max(0, q0 + offs - window + 1) : 0;

  for (int j0 = (col_lo / BN) * BN; j0 < col_hi; j0 += BN) {
    __syncthreads();  // the last tile's reads of Ks and dSs are done
    load_tile<T, BN, DP>(Ks, kg, kv_stride, j0, S, D, 1.f);
    load_tile<T, BN, DP>(Vs, vg, kv_stride, j0, S, D, 1.f);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_tile<RI, CJ, DS>(s, Qs, Ks, ty, tx, D);
    dot_tile<RI, CJ, DS>(dp, dOs, Vs, ty, tx, D);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = j0 + tx + 16 * j;
        const bool keep = row < Tq && attends(row, col, offs, S, causal, window);
        const float p = keep ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();  // every thread is done with Vs before dSs overwrites it
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) dSs[(ty + 16 * i) * PS + tx + 16 * j] = s[i][j];
    __syncthreads();
    accum_tile<RI, NJ, PS, DS>(acc, dSs, Ks, ty, tx, BN);
  }

  float one[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) one[i] = 1.f;
  T* dqg = dq + ((long long)b * Tq * H + h) * D;
  store_tile<T, RI, NJ>(dqg, q_stride, q0, Tq, D, ty, tx, acc, one);
}

// ---------------------------------------------------------------------- dkv
// grid (KV tiles, KH, B). The block keeps its K and V tile [BN][DS] and loops
// over the group's query heads and their live query tiles (Qs, dOs [BM][DS]).
// The logits are computed transposed, kv rows by query columns, so that each
// thread's accumulators are rows of dk and dv: Pt and dSt [BN][BM + 4].
template <typename T, int NJ, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int Tq, int S, int H, int KH,
                 int D, int causal, int window, float scale) {
  constexpr int DP = 64 * NJ, DS = DP + 4, CI = BN / 16, RJ = BM / 16, PS = BM + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BN * DS;
  float* Qs = Vs + BN * DS;
  float* dOs = Qs + BM * DS;
  float* Pt = dOs + BM * DS;
  float* dSt = Pt + BN * PS;
  float* lse_s = dSt + BN * PS;
  float* delta_s = lse_s + BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * BN, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int offs = S - Tq;
  const long long q_stride = (long long)H * D, kv_stride = (long long)KH * D;
  const T* kg = k + ((long long)b * S * KH + kh) * D;
  const T* vg = v + ((long long)b * S * KH + kh) * D;

  load_tile<T, BN, DP>(Ks, kg, kv_stride, k0, S, D, 1.f);
  load_tile<T, BN, DP>(Vs, vg, kv_stride, k0, S, D, 1.f);

  float dk_acc[CI][4 * NJ], dv_acc[CI][4 * NJ];
#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NJ; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int k_last = min(k0 + BN, S) - 1;
  const int row_lo = causal ? max(0, k0 - offs) : 0;
  const int row_hi = window > 0 ? min(Tq, k_last + window - offs) : Tq;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qg = q + ((long long)b * Tq * H + h) * D;
    const T* dog = dO + ((long long)b * Tq * H + h) * D;
    const float* lse_g = lse + ((long long)b * H + h) * Tq;
    const float* delta_g = delta + ((long long)b * H + h) * Tq;
    for (int i0 = (row_lo / BM) * BM; i0 < row_hi; i0 += BM) {
      __syncthreads();  // the last tile's reads of Qs, dOs, Pt and dSt are done
      load_tile<T, BM, DP>(Qs, qg, q_stride, i0, Tq, D, 1.f);
      load_tile<T, BM, DP>(dOs, dog, q_stride, i0, Tq, D, 1.f);
      if (threadIdx.x < BM) {
        const int row = i0 + threadIdx.x;
        lse_s[threadIdx.x] = row < Tq ? lse_g[row] : 0.f;
        delta_s[threadIdx.x] = row < Tq ? delta_g[row] : 0.f;
      }
      __syncthreads();

      float st[CI][RJ], dpt[CI][RJ];
#pragma unroll
      for (int i = 0; i < CI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) st[i][j] = dpt[i][j] = 0.f;
      dot_tile<CI, RJ, DS>(st, Ks, Qs, ty, tx, D);
      dot_tile<CI, RJ, DS>(dpt, Vs, dOs, ty, tx, D);

#pragma unroll
      for (int i = 0; i < CI; ++i) {
        const int col = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const int rl = tx + 16 * j;
          const int row = i0 + rl;
          const bool keep = row < Tq && attends(row, col, offs, S, causal, window);
          const float p = keep ? expf(st[i][j] * scale - lse_s[rl]) : 0.f;
          Pt[(ty + 16 * i) * PS + rl] = p;
          dSt[(ty + 16 * i) * PS + rl] = p * (dpt[i][j] - delta_s[rl]) * scale;
        }
      }
      __syncthreads();
      accum_tile<CI, NJ, PS, DS>(dv_acc, Pt, dOs, ty, tx, BM);
      accum_tile<CI, NJ, PS, DS>(dk_acc, dSt, Qs, ty, tx, BM);
    }
  }

  float one[CI];
#pragma unroll
  for (int i = 0; i < CI; ++i) one[i] = 1.f;
  T* dkg = dk + ((long long)b * S * KH + kh) * D;
  T* dvg = dv + ((long long)b * S * KH + kh) * D;
  store_tile<T, CI, NJ>(dkg, kv_stride, k0, S, D, ty, tx, dk_acc, one);
  store_tile<T, CI, NJ>(dvg, kv_stride, k0, S, D, ty, tx, dv_acc, one);
}

// ---- wgmma kernels (bf16, D = 64 or 128: the training and v1 prefill path)
//
// Shared by the forward and the backward below: 128 rows a block as two
// warpgroups of 64 (256 threads); products on wgmma (mma.cuh) with fp32
// accumulation; tiles of bf16 in shared memory in the 128-byte swizzle,
// [D / 64][rows][128 B], filled by 16-byte cp.async copies (TileCopy: rows
// past the end zero-filled) through a ring of 2 stages, so the next tile's
// copies are in flight while this tile's products and exponentials run;
// the masks of the CUDA-core kernels (causal with offset S - T, window,
// tail rows and columns) applied only on tiles that cross an edge, p = 0
// for masked pairs, and a warpgroup skipping a tile none of its rows
// attends; logits in base 2 (s * scale * log2 e) through ex2.approx. An
// operand whose reduction dimension runs along D (K in Q K^T) is read
// K-major; one whose reduction runs along the tile's rows (V in P V, K in
// dS K, dO and Q in the dkv sums) is read MN-major through the transpose
// bit, the tile's two 64-value halves of D one half-tile apart (the
// descriptor's leading byte offset), so every tile shares one layout and
// one copy routine. A probability tile (p, ds) in accumulator registers is
// rounded to bf16 once and repacked in registers as the A operand of the
// second product, as the plain forward rounds p.

constexpr int kWgThreads = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

// One thread's share of copying ROWS rows of HD bf16 values of two tensors
// of one layout (rows [row0, row0 + ROWS) of one (batch, head) of a [*,
// n_rows, heads, HD] tensor, ga and gb at the head's row 0) into two tiles
// [HD / 64][ROWS][128 B] (at dst and dst + gap), chunk c of row r at chunk
// c ^ (r & 7) of its 128-byte row. Of kWgThreads threads, thread tid
// copies chunk column lc of rows lr + RSTEP i, so its shared-memory offset
// and its rows' strides are fixed before any loop, and the two tensors
// share each row's offset (copying them one at a time made the forward
// 8-13% slower on an H100). Rows at or past n_rows are zero-filled.
template <int HD, int ROWS>
struct TileCopy {
  static constexpr int CH = HD / 8;                // 16-byte chunks a row
  static constexpr int RSTEP = kWgThreads / CH;    // rows between a thread's chunks
  static_assert(RSTEP % 8 == 0 && ROWS % RSTEP == 0, "a thread's rows share a swizzle phase");
  int lr;
  uint32_t soff;
  long long lead, stride;
  __device__ __forceinline__ TileCopy(int tid, long long row_stride)
      : lr(tid / CH),
        soff((uint32_t)(((tid % CH) >> 3) * (ROWS * 128) + (tid / CH) * 128 +
                        ((((tid % CH) & 7) ^ ((tid / CH) & 7)) << 4))),
        lead((long long)(tid / CH) * row_stride + (tid % CH) * 8),
        stride(row_stride) {}
  __device__ __forceinline__ void operator()(uint32_t dst, uint32_t gap,
                                             const __nv_bfloat16* ga, const __nv_bfloat16* gb,
                                             int row0, int n_rows) const {
    const __nv_bfloat16* ta = ga + lead;
    const __nv_bfloat16* tb = gb + lead;
    const uint32_t d = dst + soff;
    const long long g0 = (long long)row0 * stride;
#pragma unroll
    for (int i = 0; i < ROWS / RSTEP; ++i) {
      const int row = row0 + lr + i * RSTEP;
      const long long g = row < n_rows ? g0 + (long long)i * RSTEP * stride : 0;
      cp_async16(d + i * RSTEP * 128, ta + g, row < n_rows ? 16 : 0);
      cp_async16(d + gap + i * RSTEP * 128, tb + g, row < n_rows ? 16 : 0);
    }
  }
};

// the 1024-byte-aligned start (the swizzle's period) of a kernel's dynamic
// shared memory, as a shared-memory address
__device__ __forceinline__ uint32_t sw128_base(const uint8_t* smem) {
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
  return raw + ((1024u - (raw & 1023u)) & 1023u);
}

// d += A . B over one k16 step, N = HD: A (64 x 16) from registers, B from
// shared memory MN-major (HD values of N at one k a row)
template <int HD>
__device__ __forceinline__ void wg_dot_mn(float (&d)[HD / 2], const uint32_t (&a)[4],
                                          uint64_t desc);
template <>
__device__ __forceinline__ void wg_dot_mn<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc) {
  wgmma_m64n64k16_rs<1>(d, a, desc, 1);
}
template <>
__device__ __forceinline__ void wg_dot_mn<128>(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t desc) {
  wgmma_m64n128k16_rs<1>(d, a, desc, 1);
}

// KK k16 A fragments from 16 KK columns of fp32 accumulators (x[4 j + e]:
// row gid + 8 (e >> 1), column 8 j + 2 tig + (e & 1)), rounded to bf16
template <int KK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KK][4], const float (&x)[8 * KK]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = pack2(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack2(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack2(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// rows row_a (acc[4 dt], acc[4 dt + 1]) and row_b (acc[4 dt + 2], acc[4 dt +
// 3]) of a 64 x HD accumulator tile to a [*, n_rows, heads, HD] tensor (out
// at the head's row 0), times mul_a / mul_b
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long row_stride, int row_a,
                                           int row_b, int n_rows, int tig,
                                           const float (&acc)[HD / 2], float mul_a,
                                           float mul_b) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + tig * 2;
    if (row_a < n_rows)
      *reinterpret_cast<uint32_t*>(out + (long long)row_a * row_stride + d) =
          pack2(acc[4 * dt] * mul_a, acc[4 * dt + 1] * mul_a);
    if (row_b < n_rows)
      *reinterpret_cast<uint32_t*>(out + (long long)row_b * row_stride + d) =
          pack2(acc[4 * dt + 2] * mul_b, acc[4 * dt + 3] * mul_b);
  }
}

// 2^x on the special-function unit in one instruction (ex2.approx, results
// below 2^-126 flushed to zero: p that small is zero in bf16 as well, and
// nothing in a row sum of at least 1); exp2f adds a range fix-up around it
// that costs more than the exponential itself in the softmax's loop.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma forward
//
// One block owns 128 query rows of one (batch, head). S = Q K^T,
// m64n128k16 over D / 16 steps: Q is the register A operand, loaded once
// from device memory in mma.m16n8k16's A layout a warp; a K tile of 128
// positions is B, K-major. O += P V, m64nDk16 over 8 steps of 16
// positions: P is the S accumulators repacked; the V tile is B MN-major.
// The online softmax stays in registers in fp32 (lse = m ln 2 + log l).
// Query tiles are issued longest first: blockIdx.z counts down from the
// last tile, and z is the slowest grid dimension, so under a causal mask
// the tiles with the most live columns start first. o and lse have the
// layout and meaning of the other forward kernels; the dq, delta and dkv
// kernels read them. The kernel needs scale > 0 (the route check in the
// entry). On an H100 the softmax's instructions, not the products, set
// the pace (fast_exp2 in place of exp2f made the kernel about 10% faster);
// two warpgroups taking turns on the tensor cores, P V overlapped with the
// next tile's softmax (Q in shared memory) and a 3-stage ring were each no
// faster (PERF.md section 6).

constexpr int kFwdRows = 128;   // query rows a block: two warpgroups of 64
constexpr int kFwdCols = 128;   // K/V positions a tile
constexpr int kFwdStages = 2;   // K/V tiles in the ring

template <int HD>
struct FwdLayout {
  static constexpr int TILE = kFwdCols * HD * 2;  // bytes of a K (or V) tile
  // the stages, on a 1024-byte boundary (the swizzle's period)
  static constexpr size_t kBytes = (size_t)kFwdStages * 2 * TILE + 1024;
};

// The online softmax of one tile in registers: s holds this thread's raw
// logits of rows row_a (s[4 j], s[4 j + 1]) and row_b (s[4 j + 2], s[4 j +
// 3]) at columns col0 + 8 j (+1); on return s holds p = 2^(s * sl2 - m)
// (sl2 = scale * log2 e > 0; m in the same base-2 units), the row maxima
// m_r, sums l_r and the output accumulators o (same row layout) rescaled.
// MASKED: the pairs the mask drops get p = 0.
template <bool MASKED, int NS, int NO>
__device__ __forceinline__ void fwd_softmax(float (&s)[NS], float (&m_r)[2], float (&l_r)[2],
                                            float (&o)[NO], float sl2, int row_a, int row_b,
                                            int col0, int offs, int S, int causal, int window) {
  if (MASKED) {
#pragma unroll
    for (int jt = 0; jt < NS / 4; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!attends(e < 2 ? row_a : row_b, col0 + jt * 8 + (e & 1), offs, S, causal, window))
          s[4 * jt + e] = kNegInf;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mx = kNegInf;
#pragma unroll
    for (int jt = 0; jt < NS / 4; ++jt)
      mx = fmaxf(mx, fmaxf(s[4 * jt + 2 * hf], s[4 * jt + 2 * hf + 1]));
    const float m_new = fmaxf(m_r[hf], quad_max(mx) * sl2);
    const float alpha = fast_exp2(m_r[hf] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int jt = 0; jt < NS / 4; ++jt)
#pragma unroll
      for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
        float p = fast_exp2(fmaf(s[4 * jt + e], sl2, -m_new));
        if (MASKED) p = s[4 * jt + e] > kMasked ? p : 0.f;
        s[4 * jt + e] = p;
        rs += p;
      }
    l_r[hf] = l_r[hf] * alpha + quad_sum(rs);
    m_r[hf] = m_new;
#pragma unroll
    for (int dt = 0; dt < NO / 4; ++dt) {
      o[4 * dt + 2 * hf] *= alpha;
      o[4 * dt + 2 * hf + 1] *= alpha;
    }
  }
}

// grid (H, B, ceil(T / 128)); 256 threads; FwdLayout<HD>::kBytes of dynamic
// shared memory
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int Tq, int S, int H, int KH, int causal,
                       int window, float scale) {
  constexpr int KS = HD / 16;        // k16 steps of Q K^T
  constexpr int PV = kFwdCols / 16;  // k16 steps of P V
  constexpr int TILE = FwdLayout<HD>::TILE;
  extern __shared__ __align__(16) uint8_t fw_smem[];
  const uint32_t base = sw128_base(fw_smem);  // [stage][K, V][D / 64][128][128 B]

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFwdRows;  // longest tiles first
  const int kh = h / (H / KH);
  const int offs = S - Tq;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KH * HD;
  const __nv_bfloat16* kg = k + ((long long)b * S * KH + kh) * HD;
  const __nv_bfloat16* vg = v + ((long long)b * S * KH + kh) * HD;

  // the block's columns: from the window's first to the last row's diagonal
  const int q_last = min(q0 + kFwdRows, Tq) - 1;
  const int col_hi = causal ? min(S, q_last + offs + 1) : S;
  const int col_lo = window > 0 ? max(0, q0 + offs - window + 1) : 0;
  const int first = (col_lo / kFwdCols) * kFwdCols;
  const int n_tiles = col_hi > first ? (col_hi - first + kFwdCols - 1) / kFwdCols : 0;

  // the K and V tile at positions [j0, j0 + 128) into stage st
  const TileCopy<HD, kFwdCols> copy(tid, kv_stride);
  auto load_tile = [&](int j0, int st) {
    copy(base + (uint32_t)(st * 2 * TILE), TILE, kg, vg, j0, S);
  };
#pragma unroll
  for (int st = 0; st < kFwdStages - 1; ++st) {
    if (st < n_tiles) load_tile(first + st * kFwdCols, st);
    cp_async_commit();
  }

  // this thread's two rows and its Q fragments (rows past T are zero)
  const int wr0 = q0 + wg * 64;
  const int row_a = wr0 + w * 16 + gid, row_b = row_a + 8;
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* qg = q + ((long long)b * Tq * H + h) * HD;
    const __nv_bfloat16* qra = qg + (long long)min(row_a, Tq - 1) * q_stride + 2 * tig;
    const __nv_bfloat16* qrb = qg + (long long)min(row_b, Tq - 1) * q_stride + 2 * tig;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = row_a < Tq ? *reinterpret_cast<const uint32_t*>(qra + 16 * ks) : 0u;
      qa[ks][1] = row_b < Tq ? *reinterpret_cast<const uint32_t*>(qrb + 16 * ks) : 0u;
      qa[ks][2] = row_a < Tq ? *reinterpret_cast<const uint32_t*>(qra + 16 * ks + 8) : 0u;
      qa[ks][3] = row_b < Tq ? *reinterpret_cast<const uint32_t*>(qrb + 16 * ks + 8) : 0u;
    }
  }
  fence_regs(qa);

  // this warpgroup's columns; a warpgroup whose rows all lie past T has none
  const bool wg_live = wr0 < Tq;
  const int wr_last = min(wr0 + 64, Tq) - 1;
  const int wcol_hi = causal ? min(S, wr_last + offs + 1) : S;
  const int wcol_lo = window > 0 ? max(0, wr0 + offs - window + 1) : 0;
  const float sl2 = scale * kLog2e;  // logits in base 2

  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float oacc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
  float s[kFwdCols / 2];
  uint32_t pa[PV][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = first + it * kFwdCols, st = it % kFwdStages;
    cp_async_wait<kFwdStages - 2>();  // tile it has landed (this thread's copies)
    fence_proxy_async();
    // every thread's copies of tile it are visible to the tensor cores, and
    // no warpgroup still reads the stage that tile it + kFwdStages - 1 takes
    __syncthreads();
    if (it + kFwdStages - 1 < n_tiles)
      load_tile(j0 + (kFwdStages - 1) * kFwdCols, (it + kFwdStages - 1) % kFwdStages);
    cp_async_commit();
    if (!wg_live || j0 >= wcol_hi || j0 + kFwdCols <= wcol_lo) continue;  // warpgroup-uniform

    const uint32_t ks_s = base + (uint32_t)(st * 2 * TILE), vs_s = ks_s + TILE;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n128k16_rs<0>(
          s, qa[ks], sw128_desc(ks_s + (ks >> 2) * (kFwdCols * 128) + (ks & 3) * 32), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // s[4 j + e]: row row_a (e < 2) or row_b, column j0 + 8 j + 2 tig + (e &
    // 1). A tile that crosses an edge of the mask (warpgroup-uniform) sets
    // its masked logits to kNegInf and gives them p = 0.
    if (span_is_dense(wr0, 64, j0, kFwdCols, Tq, offs, S, causal, window))
      fwd_softmax<false>(s, m_r, l_r, oacc, sl2, row_a, row_b, j0 + 2 * tig, offs, S, causal,
                         window);
    else
      fwd_softmax<true>(s, m_r, l_r, oacc, sl2, row_a, row_b, j0 + 2 * tig, offs, S, causal,
                        window);
    pack_a(pa, s);
    fence_regs(pa);
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PV; ++kk)
      wg_dot_mn<HD>(oacc, pa[kk], sw128_desc(vs_s + kk * 2048, kFwdCols * 128));
    wgmma_commit();
    wgmma_wait<0>();  // the stage is read before the next iteration's barrier
    fence_regs(oacc);
    fence_regs(pa);
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = hf ? row_b : row_a;
    const float li = fmaxf(l_r[hf], 1e-30f);
    inv[hf] = 1.f / li;
    if (tig == 0 && row < Tq)
      lse[((long long)b * H + h) * Tq + row] = m_r[hf] * 0.6931471805599453f + logf(li);
  }
  store_rows<HD>(o + ((long long)b * Tq * H + h) * HD, q_stride, row_a, row_b, Tq, tig, oacc,
                 inv[0], inv[1]);
}

// ---- wgmma backward
//
// dq and dkv stay two kernels, each output written once by one block (no
// atomics: the same bits every run); delta comes from flash_delta_kernel.
// Both compute p = 2^(s * scale * log2 e - lse * log2 e) (lse the
// forward's m + log l in natural units) and ds = p (dp - delta) scale in
// fp32, and round p and ds to bf16 once, as the A operands of the second
// products. Neither needs scale > 0 itself; the route check sends a call
// to the wgmma kernels only with the wgmma forward.
//
// dq: a block owns 128 query rows of one (batch, head); Q and dO are
// copied once into shared memory beside the K/V ring. Over each live tile
// of 64 K/V positions a warpgroup issues S = Q K^T and then dP = dO V^T
// (m64n64k16, both operands K-major in shared memory), computes p while dP
// runs, then ds, and issues dQ += dS K (m64nDk16, dS from registers, K
// MN-major). Query tiles are issued longest first, as in the forward.
//
// dkv: a block owns 128 KV rows of one (batch, KV head); K and V are
// copied once into shared memory. The block walks the group's G query
// heads and, for each, the 64-row query tiles that see its rows, as one
// stream through the ring (Q, dO, and the tile's lse and delta by 4-byte
// copies), so the ring is not drained between heads. Per tile a warpgroup
// issues S^T = K Q^T and dP^T = V dO^T (m64n64k16, shared-memory
// operands), computes p^T while dP^T runs, issues dV += P^T dO, computes
// ds^T while dV runs, then issues dK += dS^T Q (m64nDk16, P^T and dS^T from
// registers, dO and Q MN-major). dK and dV stay in registers for the whole
// walk (D fp32 a thread): that is why the first products take both
// operands from shared memory instead of holding K and V as register
// fragments. KV tiles are issued from position 0 up: under a causal mask
// the first see the most query rows.
//
// Registers (ptxas -v, in chip_smoke.py's build log): dq 170 a thread at D
// = 128 (134 at 64), dkv 255 (196 at 64; dK and dV alone take 128), no
// spills. On an H100 they run at 38-51% of the tensor cores' peak on the
// attended pairs (PERF.md section 6); a 3-stage ring was no faster (dkv
// 1%, dq none).

constexpr int kBwdRows = 128;   // rows a block owns: query rows (dq), KV rows (dkv)
constexpr int kBwdCols = 64;    // rows of a streamed tile: K/V positions (dq), query rows (dkv)
constexpr int kBwdStages = 2;   // streamed tiles in the ring

template <int HD>
struct BwdLayout {
  static constexpr int OWN = kBwdRows * HD * 2;   // bytes of an owned tile (Q, dO; K, V)
  static constexpr int TILE = kBwdCols * HD * 2;  // bytes of a streamed tile (K, V; Q, dO)
  // a stage: two streamed tiles, then (dkv) the query tile's lse and delta,
  // rounded up to the swizzle's period
  static constexpr int STAGE = (2 * TILE + 2 * kBwdCols * 4 + 1023) / 1024 * 1024;
  // [owned 0, owned 1][stage], from a 1024-byte boundary
  static constexpr size_t kBytes = 2 * (size_t)OWN + (size_t)kBwdStages * STAGE + 1024;
};

__device__ __forceinline__ bool keeps(int row, int col, int Tq, int offs, int S, int causal,
                                      int window) {
  return row < Tq && attends(row, col, offs, S, causal, window);
}

// dq's p in place: s holds this thread's raw logits of query rows row_a
// (s[4 j], s[4 j + 1]) and row_b (s[4 j + 2], s[4 j + 3]) at positions col0
// + 8 j (+1); lse2 their rows' lse * log2 e. MASKED: pairs the mask drops,
// and rows past T, get p = 0.
template <bool MASKED>
__device__ __forceinline__ void dq_probs(float (&s)[kBwdCols / 2], const float (&lse2)[2],
                                         float sl2, int row_a, int row_b, int col0, int Tq,
                                         int offs, int S, int causal, int window) {
#pragma unroll
  for (int j = 0; j < kBwdCols / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(s[4 * j + e], sl2, -lse2[e >> 1]));
      s[4 * j + e] = !MASKED || keeps(e < 2 ? row_a : row_b, col0 + 8 * j + (e & 1), Tq, offs, S,
                                      causal, window)
                         ? p
                         : 0.f;
    }
}

// dkv's p^T in place: s holds this thread's raw logits of KV rows kv_a
// (s[4 j], s[4 j + 1]) and kv_b (s[4 j + 2], s[4 j + 3]) at query rows row0
// + 8 j (+1), whose lse (natural units) lse_t[8 j] (+1) holds. MASKED as
// above.
template <bool MASKED>
__device__ __forceinline__ void dkv_probs(float (&s)[kBwdCols / 2], const float* lse_t,
                                          float sl2, int kv_a, int kv_b, int row0, int Tq,
                                          int offs, int S, int causal, int window) {
#pragma unroll
  for (int j = 0; j < kBwdCols / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse_t + 8 * j);
    const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = fast_exp2(fmaf(s[4 * j + e], sl2, -l2[e & 1]));
      s[4 * j + e] = !MASKED || keeps(row0 + 8 * j + (e & 1), e < 2 ? kv_a : kv_b, Tq, offs, S,
                                      causal, window)
                         ? p
                         : 0.f;
    }
  }
}

// d = A B^T over D for one warpgroup: A (at a) its 64 rows of an owned
// tile, B (at b) a streamed tile, both K-major in shared memory (their D
// halves kBwdRows * 128 and kBwdCols * 128 bytes apart)
template <int HD>
__device__ __forceinline__ void wg_dot_kk(float (&d)[kBwdCols / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    wgmma_m64n64k16_ss(d, sw128_desc(a + (ks >> 2) * (kBwdRows * 128) + (ks & 3) * 32),
                       sw128_desc(b + (ks >> 2) * (kBwdCols * 128) + (ks & 3) * 32), ks > 0);
}

// grid (H, B, ceil(T / 128)); 256 threads; BwdLayout<HD>::kBytes of dynamic
// shared memory
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int Tq, int S, int H, int KH, int causal,
                      int window, float scale) {
  using L = BwdLayout<HD>;
  constexpr int PK = kBwdCols / 16;  // k16 steps of dS K
  extern __shared__ __align__(16) uint8_t dq_smem[];
  const uint32_t q_s = sw128_base(dq_smem), do_s = q_s + L::OWN, ring = do_s + L::OWN;

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBwdRows;  // longest tiles first
  const int kh = h / (H / KH);
  const int offs = S - Tq;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KH * HD;
  const long long qh = ((long long)b * Tq * H + h) * HD;
  const __nv_bfloat16* kg = k + ((long long)b * S * KH + kh) * HD;
  const __nv_bfloat16* vg = v + ((long long)b * S * KH + kh) * HD;

  const int q_last = min(q0 + kBwdRows, Tq) - 1;
  const int col_hi = causal ? min(S, q_last + offs + 1) : S;
  const int col_lo = window > 0 ? max(0, q0 + offs - window + 1) : 0;
  const int first = (col_lo / kBwdCols) * kBwdCols;
  const int n_tiles = col_hi > first ? (col_hi - first + kBwdCols - 1) / kBwdCols : 0;

  {  // Q and dO join the first K/V tile's group of copies
    const TileCopy<HD, kBwdRows> own(tid, q_stride);
    own(q_s, L::OWN, q + qh, dO + qh, q0, Tq);
  }
  const TileCopy<HD, kBwdCols> copy(tid, kv_stride);
  auto load_tile = [&](int j0, int st) {
    copy(ring + (uint32_t)(st * L::STAGE), L::TILE, kg, vg, j0, S);
  };
#pragma unroll
  for (int st = 0; st < kBwdStages - 1; ++st) {
    if (st < n_tiles) load_tile(first + st * kBwdCols, st);
    cp_async_commit();
  }

  const int wr0 = q0 + wg * 64;
  const int row_a = wr0 + w * 16 + gid, row_b = row_a + 8;
  const float sl2 = scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = hf ? row_b : row_a;
    const long long at = ((long long)b * H + h) * Tq + row;
    lse2[hf] = row < Tq ? lse[at] * kLog2e : 0.f;
    dlt[hf] = row < Tq ? delta[at] : 0.f;
  }
  const bool wg_live = wr0 < Tq;
  const int wr_last = min(wr0 + 64, Tq) - 1;
  const int wcol_hi = causal ? min(S, wr_last + offs + 1) : S;
  const int wcol_lo = window > 0 ? max(0, wr0 + offs - window + 1) : 0;
  const uint32_t qa_s = q_s + wg * 64 * 128, da_s = do_s + wg * 64 * 128;  // this warpgroup's rows

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float s[kBwdCols / 2], dp[kBwdCols / 2];
  uint32_t dsa[PK][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = first + it * kBwdCols, st = it % kBwdStages;
    cp_async_wait<kBwdStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile it visible; no warpgroup still reads the stage the next copy takes
    if (it + kBwdStages - 1 < n_tiles)
      load_tile(j0 + (kBwdStages - 1) * kBwdCols, (it + kBwdStages - 1) % kBwdStages);
    cp_async_commit();
    if (!wg_live || j0 >= wcol_hi || j0 + kBwdCols <= wcol_lo) continue;  // warpgroup-uniform

    const uint32_t ks_s = ring + (uint32_t)(st * L::STAGE), vs_s = ks_s + L::TILE;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wg_dot_kk<HD>(s, qa_s, ks_s);
    wgmma_commit();
    wg_dot_kk<HD>(dp, da_s, vs_s);
    wgmma_commit();
    wgmma_wait<1>();  // S is done; dP runs on
    fence_regs(s);
    if (span_is_dense(wr0, 64, j0, kBwdCols, Tq, offs, S, causal, window))
      dq_probs<false>(s, lse2, sl2, row_a, row_b, j0 + 2 * tig, Tq, offs, S, causal, window);
    else
      dq_probs<true>(s, lse2, sl2, row_a, row_b, j0 + 2 * tig, Tq, offs, S, causal, window);
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < kBwdCols / 2; ++i) dp[i] = s[i] * (dp[i] - dlt[(i >> 1) & 1]) * scale;
    pack_a(dsa, dp);
    fence_regs(dsa);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
      wg_dot_mn<HD>(acc, dsa[kk], sw128_desc(ks_s + kk * 2048, kBwdCols * 128));
    wgmma_commit();
    wgmma_wait<0>();  // the stage is read before the next iteration's barrier
    fence_regs(acc);
    fence_regs(dsa);
  }
  cp_async_wait<0>();
  store_rows<HD>(dq + qh, q_stride, row_a, row_b, Tq, tig, acc, 1.f, 1.f);
}

// grid (KH, B, ceil(S / 128)); 256 threads; BwdLayout<HD>::kBytes of
// dynamic shared memory
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq,
                       int S, int H, int KH, int causal, int window, float scale) {
  using L = BwdLayout<HD>;
  constexpr int PK = kBwdCols / 16;  // k16 steps of P^T dO and dS^T Q
  extern __shared__ __align__(16) uint8_t dkv_smem[];
  const uint32_t k_s = sw128_base(dkv_smem), v_s = k_s + L::OWN, ring = v_s + L::OWN;
  // the ring's statistics are read through generic pointers
  const uint8_t* ring_g = dkv_smem + (ring - (uint32_t)__cvta_generic_to_shared(dkv_smem));

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBwdRows;  // longest first under a causal mask
  const int G = H / KH;
  const int offs = S - Tq;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KH * HD;
  const long long kvh = ((long long)b * S * KH + kh) * HD;

  // the query rows that see the block's KV rows, the same for every head
  const int k_last = min(k0 + kBwdRows, S) - 1;
  const int row_lo = causal ? max(0, k0 - offs) : 0;
  const int row_hi = window > 0 ? min(Tq, k_last + window - offs) : Tq;
  const int first = (row_lo / kBwdCols) * kBwdCols;
  const int per_head = row_hi > first ? (row_hi - first + kBwdCols - 1) / kBwdCols : 0;
  const int n_tiles = G * per_head;

  {  // K and V join the first query tile's group of copies
    const TileCopy<HD, kBwdRows> own(tid, kv_stride);
    own(k_s, L::OWN, k + kvh, v + kvh, k0, S);
  }
  // query tile t: head kh * G + t / per_head, rows from first + 64 (t % per_head)
  const TileCopy<HD, kBwdCols> copy(tid, q_stride);
  auto load_tile = [&](int t, int st) {
    const int g = t / per_head, i0 = first + (t - g * per_head) * kBwdCols;
    const int h = kh * G + g;
    const long long qh = ((long long)b * Tq * H + h) * HD;
    const uint32_t d = ring + (uint32_t)(st * L::STAGE);
    copy(d, L::TILE, q + qh, dO + qh, i0, Tq);
    if (tid < 2 * kBwdCols) {  // lse, then delta, of the tile's rows (0 past T)
      const int row = i0 + tid % kBwdCols;
      const float* src = (tid < kBwdCols ? lse : delta) + ((long long)b * H + h) * Tq;
      cp_async4(d + 2 * L::TILE + tid * 4, src + (row < Tq ? row : 0), row < Tq ? 4 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kBwdStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // this thread's two KV rows; the warpgroup's query rows
  const int wk0 = k0 + wg * 64;
  const int kv_a = wk0 + w * 16 + gid, kv_b = kv_a + 8;
  const bool wg_live = wk0 < S;
  const int wk_last = min(wk0 + 64, S) - 1;
  const int wrow_lo = causal ? max(0, wk0 - offs) : 0;
  const int wrow_hi = window > 0 ? min(Tq, wk_last + window - offs) : Tq;
  const uint32_t ka_s = k_s + wg * 64 * 128, va_s = v_s + wg * 64 * 128;
  const float sl2 = scale * kLog2e;

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[kBwdCols / 2], dp[kBwdCols / 2];
  uint32_t pa[PK][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int g = t / per_head, i0 = first + (t - g * per_head) * kBwdCols;
    const int st = t % kBwdStages;
    cp_async_wait<kBwdStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile t visible; no warpgroup still reads the stage the next copy takes
    if (t + kBwdStages - 1 < n_tiles) load_tile(t + kBwdStages - 1, (t + kBwdStages - 1) % kBwdStages);
    cp_async_commit();
    if (!wg_live || i0 >= wrow_hi || i0 + kBwdCols <= wrow_lo) continue;  // warpgroup-uniform

    const uint32_t qs_s = ring + (uint32_t)(st * L::STAGE), dos_s = qs_s + L::TILE;
    const float* lse_t =
        reinterpret_cast<const float*>(ring_g + st * L::STAGE + 2 * L::TILE) + 2 * tig;
    const float* dlt_t = lse_t + kBwdCols;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    wg_dot_kk<HD>(s, ka_s, qs_s);
    wgmma_commit();
    wg_dot_kk<HD>(dp, va_s, dos_s);
    wgmma_commit();
    wgmma_wait<1>();  // S^T is done; dP^T runs on
    fence_regs(s);
    if (span_is_dense(i0, kBwdCols, wk0, 64, Tq, offs, S, causal, window))
      dkv_probs<false>(s, lse_t, sl2, kv_a, kv_b, i0 + 2 * tig, Tq, offs, S, causal, window);
    else
      dkv_probs<true>(s, lse_t, sl2, kv_a, kv_b, i0 + 2 * tig, Tq, offs, S, causal, window);
    pack_a(pa, s);
    fence_regs(pa);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
      wg_dot_mn<HD>(dv_acc, pa[kk], sw128_desc(dos_s + kk * 2048, kBwdCols * 128));
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done; dV runs on
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kBwdCols / 8; ++j) {
      const float2 dl = *reinterpret_cast<const float2*>(dlt_t + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e & 1 ? dl.y : dl.x)) * scale;
    }
    wgmma_wait<0>();  // dV has read P^T's fragments
    fence_regs(dv_acc);
    fence_regs(pa);
    pack_a(pa, dp);
    fence_regs(pa);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
      wg_dot_mn<HD>(dk_acc, pa[kk], sw128_desc(qs_s + kk * 2048, kBwdCols * 128));
    wgmma_commit();
    wgmma_wait<0>();  // the stage is read before the next iteration's barrier
    fence_regs(dk_acc);
    fence_regs(pa);
  }
  cp_async_wait<0>();
  store_rows<HD>(dk + kvh, kv_stride, kv_a, kv_b, S, tig, dk_acc, 1.f, 1.f);
  store_rows<HD>(dv + kvh, kv_stride, kv_a, kv_b, S, tig, dv_acc, 1.f, 1.f);
}

// ----------------------------------------------------------------- launchers

struct Shape {
  int B, Tq, S, H, KH, D, causal, window;
  float scale;
};

bool bad_shape(const Shape& s, int dtype) {
  return s.B <= 0 || s.Tq <= 0 || s.S <= 0 || s.H <= 0 || s.KH <= 0 || s.H % s.KH ||
         s.D <= 0 || s.D % 8 || s.D > 256 || s.window < 0 || (s.window > 0 && !s.causal) ||
         (s.causal && s.Tq > s.S) || s.H > 65535 || s.B > 65535 ||
         dtype < 0 || dtype > 2;
}

// The routes of the C entries (ops/flash_attention.py::FLASH_ROUTES, the
// wrapper's flash_route picks one from the type, D and scale): 0 the
// CUDA-core kernels, which take every shape bad_shape admits; 1 the wgmma
// kernels, which take bf16 with D = 64 or 128 and scale > 0 (the forward
// folds scale into its base-2 exponent and takes the row maximum of the
// raw logits). A route the call does not meet is refused.
constexpr int kRouteCudaCore = 0, kRouteWgmma = 1;

bool bad_route(const Shape& s, int dtype, int route) {
  if (route == kRouteCudaCore) return false;
  return route != kRouteWgmma || dtype != 1 || (s.D != 64 && s.D != 128) || !(s.scale > 0.f);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int NJ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Shape& s, cudaStream_t st) {
  constexpr int BM = 64, BN = 64, DS = 64 * NJ + 4;
  const size_t smem = (size_t)(BM + 2 * BN) * DS * sizeof(float);
  auto kernel = flash_fwd_kernel<T, NJ, BM, BN>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Tq + BM - 1) / BM, s.H, s.B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, s.Tq, s.S, s.H, s.KH, s.D, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dO,
                      const float* lse, const float* delta, void* dq, const Shape& s,
                      cudaStream_t st) {
  constexpr int BM = NJ <= 2 ? 64 : 32, BN = BM, DS = 64 * NJ + 4;
  const size_t smem = (size_t)(2 * BM + 2 * BN) * DS * sizeof(float);
  auto kernel = flash_dq_kernel<T, NJ, BM, BN>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Tq + BM - 1) / BM, s.H, s.B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dO), lse, delta, static_cast<T*>(dq), s.Tq, s.S, s.H, s.KH,
      s.D, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dO,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const Shape& s, cudaStream_t st) {
  constexpr int BM = NJ <= 2 ? 64 : 32, BN = BM, DS = 64 * NJ + 4, PS = BM + 4;
  const size_t smem =
      ((size_t)(2 * BM + 2 * BN) * DS + 2 * (size_t)BN * PS + 2 * BM) * sizeof(float);
  auto kernel = flash_dkv_kernel<T, NJ, BM, BN>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.S + BN - 1) / BN, s.KH, s.B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dO), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      s.Tq, s.S, s.H, s.KH, s.D, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

template <int HD>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                             const Shape& s, cudaStream_t st) {
  constexpr size_t smem = FwdLayout<HD>::kBytes;
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.H, s.B, (s.Tq + kFwdRows - 1) / kFwdRows);
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  kernel<<<grid, kWgThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, s.Tq, s.S, s.H, s.KH, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dO,
                            const float* lse, const float* delta, void* dq, const Shape& s,
                            cudaStream_t st) {
  constexpr size_t smem = BwdLayout<HD>::kBytes;
  auto kernel = flash_dq_wgmma_kernel<HD>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.H, s.B, (s.Tq + kBwdRows - 1) / kBwdRows);
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  kernel<<<grid, kWgThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), lse, delta, static_cast<bf16*>(dq), s.Tq, s.S, s.H, s.KH,
      s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dO,
                             const float* lse, const float* delta, void* dk, void* dv,
                             const Shape& s, cudaStream_t st) {
  constexpr size_t smem = BwdLayout<HD>::kBytes;
  auto kernel = flash_dkv_wgmma_kernel<HD>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.KH, s.B, (s.S + kBwdRows - 1) / kBwdRows);
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  kernel<<<grid, kWgThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      s.Tq, s.S, s.H, s.KH, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

// dtype 0 = float32, 1 = bfloat16, 2 = float16; NJ = ceil(D / 64)
#define DS_DISPATCH_T(CALL, TT)                \
  do {                                         \
    const int nj = (s.D + 63) / 64;            \
    if (nj == 1) return (int)CALL(TT, 1);      \
    if (nj == 2) return (int)CALL(TT, 2);      \
    if (nj == 3) return (int)CALL(TT, 3);      \
    return (int)CALL(TT, 4);                   \
  } while (0)
#define DS_DISPATCH(CALL)                                   \
  do {                                                      \
    if (dtype == 0) DS_DISPATCH_T(CALL, float);             \
    if (dtype == 1) DS_DISPATCH_T(CALL, __nv_bfloat16);     \
    DS_DISPATCH_T(CALL, __half);                            \
  } while (0)

}  // namespace

// All tensors contiguous: q, o, do, dq [B, T, H, D]; k, v, dk, dv [B, S, KH,
// D] (dtype 0 = float32, 1 = bfloat16, 2 = float16); lse, delta [B, H, T]
// float32; route as above. Each returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int T, int S, int H, int KH, int D,
                                   int causal, int window, float scale, int dtype, int route,
                                   void* stream) {
  const Shape s{B, T, S, H, KH, D, causal, window, scale};
  if (bad_shape(s, dtype) || bad_route(s, dtype, route)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (route == kRouteWgmma)
    return (int)(D == 64 ? launch_fwd_wgmma<64>(q, k, v, o, lse_f, s, st)
                         : launch_fwd_wgmma<128>(q, k, v, o, lse_f, s, st));
#define FWD(TT, NJ) launch_fwd<TT, NJ>(q, k, v, o, lse_f, s, st)
  DS_DISPATCH(FWD);
#undef FWD
}

extern "C" int flash_attention_delta(const void* o, const void* dO, void* delta, int B,
                                     int T, int H, int D, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D <= 0 || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * T * H;
  const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(delta);
  if (dtype == 0)
    flash_delta_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dO), out, rows, T, H, D);
  else if (dtype == 1)
    flash_delta_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dO), out,
        rows, T, H, D);
  else
    flash_delta_kernel<__half><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const __half*>(o), static_cast<const __half*>(dO), out, rows, T, H, D);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_dq(const void* q, const void* k, const void* v,
                                  const void* dO, const void* lse, const void* delta,
                                  void* dq, int B, int T, int S, int H, int KH, int D,
                                  int causal, int window, float scale, int dtype, int route,
                                  void* stream) {
  const Shape s{B, T, S, H, KH, D, causal, window, scale};
  if (bad_shape(s, dtype) || bad_route(s, dtype, route)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (route == kRouteWgmma)
    return (int)(D == 64 ? launch_dq_wgmma<64>(q, k, v, dO, lse_f, delta_f, dq, s, st)
                         : launch_dq_wgmma<128>(q, k, v, dO, lse_f, delta_f, dq, s, st));
#define DQ(TT, NJ) launch_dq<TT, NJ>(q, k, v, dO, lse_f, delta_f, dq, s, st)
  DS_DISPATCH(DQ);
#undef DQ
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dO, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int T, int S, int H, int KH,
                                   int D, int causal, int window, float scale, int dtype,
                                   int route, void* stream) {
  const Shape s{B, T, S, H, KH, D, causal, window, scale};
  if (bad_shape(s, dtype) || bad_route(s, dtype, route)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (route == kRouteWgmma)
    return (int)(D == 64
                     ? launch_dkv_wgmma<64>(q, k, v, dO, lse_f, delta_f, dk, dv, s, st)
                     : launch_dkv_wgmma<128>(q, k, v, dO, lse_f, delta_f, dk, dv, s, st));
#define DKV(TT, NJ) launch_dkv<TT, NJ>(q, k, v, dO, lse_f, delta_f, dk, dv, s, st)
  DS_DISPATCH(DKV);
#undef DKV
}
