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
// after tiling. Two sets of kernels share the structure above:
// - bf16 with D = 64 or 128 (the training widths) runs every product on the
//   tensor cores: the forward on wgmma with K/V tiles in flight behind the
//   products (see "wgmma forward" below), dq and dkv with mma.sync (see
//   "tensor-core path" below).
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

// ------------------------------------------------------- tensor-core path
// bf16 with D = 64 or 128 (the widths of the models the port trains): the
// backward kernels with every product on the tensor cores (mma.sync
// m16n8k16, bf16 operands, fp32 accumulation); the forward is the wgmma
// kernel further below. 128 threads; each of the 4
// warps owns 16 rows of the block's 64-row tile and keeps its logits and
// its output rows in mma accumulator fragments, so the online softmax is
// done in registers with two shuffles a row. Tiles are staged in shared
// memory as bf16 with a row pitch of D + 8, which makes the 4-byte
// fragment loads and the 16-byte ldmatrix rows free of bank conflicts.
// The logits' accumulators are repacked in registers as the A operand of
// the second product (p and ds rounded to bf16 there, as in the plain
// forward); an operand that is needed with its reduction dimension along
// rows (v in p v, k in ds k, do and q in the dkv sums) is read with
// ldmatrix.trans. sm_scale multiplies the fp32 logits after the product.

constexpr int kTcThreads = 128;
constexpr int kTcTile = 64;

// Stage 64 rows [row0, row0 + 64) of one (batch, head) as bf16, row pitch
// HD + 8; rows at or past n_rows are zero.
template <int HD>
__device__ __forceinline__ void tc_load_tile(__nv_bfloat16* s, const __nv_bfloat16* g,
                                             long long row_stride, int row0, int n_rows) {
  constexpr int STR = HD + 8, CH = HD / 8;
  for (int idx = threadIdx.x; idx < kTcTile * CH; idx += kTcThreads) {
    const int r = idx / CH, d = (idx % CH) * 8;
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows) v = *reinterpret_cast<const uint4*>(g + (long long)row * row_stride + d);
    *reinterpret_cast<uint4*>(s + r * STR + d) = v;
  }
}

// rows row_a (elements 0, 1) and row_b (elements 2, 3) of accumulator tiles
// to a [*, n_rows, heads, HD] tensor, times mul_a / mul_b.
template <int HD>
__device__ __forceinline__ void tc_store(__nv_bfloat16* out, long long row_stride, int row_a,
                                         int row_b, int n_rows, int tig,
                                         const float (&acc)[HD / 8][4], float mul_a,
                                         float mul_b) {
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + tig * 2;
    if (row_a < n_rows)
      *reinterpret_cast<uint32_t*>(out + (long long)row_a * row_stride + d) =
          pack2(acc[dt][0] * mul_a, acc[dt][1] * mul_a);
    if (row_b < n_rows)
      *reinterpret_cast<uint32_t*>(out + (long long)row_b * row_stride + d) =
          pack2(acc[dt][2] * mul_b, acc[dt][3] * mul_b);
  }
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

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Tq, int S, int H, int KH, int causal,
                   int window, float scale) {
  constexpr int STR = HD + 8, DT = HD / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* dOs = Qs + kTcTile * STR;
  __nv_bfloat16* Ks = dOs + kTcTile * STR;
  __nv_bfloat16* Vs = Ks + kTcTile * STR;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int gid = lane / 4, tig = lane % 4;
  const int q0 = blockIdx.x * kTcTile, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int offs = S - Tq;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KH * HD;
  const __nv_bfloat16* kg = k + ((long long)b * S * KH + kh) * HD;
  const __nv_bfloat16* vg = v + ((long long)b * S * KH + kh) * HD;

  tc_load_tile<HD>(Qs, q + ((long long)b * Tq * H + h) * HD, q_stride, q0, Tq);
  tc_load_tile<HD>(dOs, dO + ((long long)b * Tq * H + h) * HD, q_stride, q0, Tq);

  const int rows[2] = {q0 + m0 + gid, q0 + m0 + gid + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long long at = ((long long)b * H + h) * Tq + rows[hf];
    lse_r[hf] = rows[hf] < Tq ? lse[at] : 0.f;
    delta_r[hf] = rows[hf] < Tq ? delta[at] : 0.f;
  }
  const int q_last = min(q0 + kTcTile, Tq) - 1;
  const int col_hi = causal ? min(S, q_last + offs + 1) : S;
  const int col_lo = window > 0 ? max(0, q0 + offs - window + 1) : 0;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int j0 = (col_lo / kTcTile) * kTcTile; j0 < col_hi; j0 += kTcTile) {
    __syncthreads();  // the last tile's reads of Ks and Vs are done
    tc_load_tile<HD>(Ks, kg, kv_stride, j0, S);
    tc_load_tile<HD>(Vs, vg, kv_stride, j0, S);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    tc_dot_nt<HD>(s, Qs, Ks, m0, gid, tig);
    tc_dot_nt<HD>(dp, dOs, Vs, m0, gid, tig);

    const bool dense = span_is_dense(q0, kTcTile, j0, kTcTile, Tq, offs, S, causal, window);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const int col = j0 + nt * 8 + tig * 2 + (e & 1);
        const bool keep = dense || (rows[hf] < Tq &&
                                    attends(rows[hf], col, offs, S, causal, window));
        const float p = keep ? expf(s[nt][e] * scale - lse_r[hf]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[hf]) * scale;
      }
    tc_dot_acc<HD>(acc, s, Ks, lane);
  }
  tc_store<HD>(dq + ((long long)b * Tq * H + h) * HD, q_stride, rows[0], rows[1], Tq, tig,
               acc, 1.f, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Tq,
                    int S, int H, int KH, int causal, int window, float scale) {
  constexpr int STR = HD + 8, DT = HD / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vs = Ks + kTcTile * STR;
  __nv_bfloat16* Qs = Vs + kTcTile * STR;
  __nv_bfloat16* dOs = Qs + kTcTile * STR;
  float* lse_s = reinterpret_cast<float*>(dOs + kTcTile * STR);
  float* delta_s = lse_s + kTcTile;
  const int lane = threadIdx.x % 32, m0 = (threadIdx.x / 32) * 16;
  const int gid = lane / 4, tig = lane % 4;
  const int k0 = blockIdx.x * kTcTile, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int offs = S - Tq;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KH * HD;

  tc_load_tile<HD>(Ks, k + ((long long)b * S * KH + kh) * HD, kv_stride, k0, S);
  tc_load_tile<HD>(Vs, v + ((long long)b * S * KH + kh) * HD, kv_stride, k0, S);

  const int cols[2] = {k0 + m0 + gid, k0 + m0 + gid + 8};  // this thread's KV rows
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  const int k_last = min(k0 + kTcTile, S) - 1;
  const int row_lo = causal ? max(0, k0 - offs) : 0;
  const int row_hi = window > 0 ? min(Tq, k_last + window - offs) : Tq;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const __nv_bfloat16* qg = q + ((long long)b * Tq * H + h) * HD;
    const __nv_bfloat16* dog = dO + ((long long)b * Tq * H + h) * HD;
    const float* lse_g = lse + ((long long)b * H + h) * Tq;
    const float* delta_g = delta + ((long long)b * H + h) * Tq;
    for (int i0 = (row_lo / kTcTile) * kTcTile; i0 < row_hi; i0 += kTcTile) {
      __syncthreads();  // the last tile's reads of Qs, dOs and the statistics are done
      tc_load_tile<HD>(Qs, qg, q_stride, i0, Tq);
      tc_load_tile<HD>(dOs, dog, q_stride, i0, Tq);
      if (threadIdx.x < kTcTile) {
        const int row = i0 + threadIdx.x;
        lse_s[threadIdx.x] = row < Tq ? lse_g[row] : 0.f;
        delta_s[threadIdx.x] = row < Tq ? delta_g[row] : 0.f;
      }
      __syncthreads();

      // transposed logits: this warp's 16 KV rows by the tile's 64 query rows
      float pt[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[nt][e] = 0.f;
      tc_dot_nt<HD>(pt, Ks, Qs, m0, gid, tig);
      const bool dense = span_is_dense(i0, kTcTile, k0, kTcTile, Tq, offs, S, causal, window);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = nt * 8 + tig * 2 + (e & 1);
          const int row = i0 + rl;
          const bool keep = dense || (row < Tq && attends(row, cols[e >> 1], offs, S,
                                                          causal, window));
          pt[nt][e] = keep ? expf(pt[nt][e] * scale - lse_s[rl]) : 0.f;
        }
      tc_dot_acc<HD>(dv_acc, pt, dOs, lane);

      float dst[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[nt][e] = 0.f;
      tc_dot_nt<HD>(dst, Vs, dOs, m0, gid, tig);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = nt * 8 + tig * 2 + (e & 1);
          dst[nt][e] = pt[nt][e] * (dst[nt][e] - delta_s[rl]) * scale;
        }
      tc_dot_acc<HD>(dk_acc, dst, Qs, lane);
    }
  }
  tc_store<HD>(dk + ((long long)b * S * KH + kh) * HD, kv_stride, cols[0], cols[1], S, tig,
               dk_acc, 1.f, 1.f);
  tc_store<HD>(dv + ((long long)b * S * KH + kh) * HD, kv_stride, cols[0], cols[1], S, tig,
               dv_acc, 1.f, 1.f);
}

// ---- wgmma forward (bf16, D = 64 or 128: the training and v1 prefill path)
//
// One block owns 128 query rows of one (batch, head): two warpgroups of 64
// rows (256 threads). Both products run on wgmma (mma.cuh), fp32
// accumulation:
// - S = Q K^T, m64n128k16 over D / 16 steps: Q is the register A operand,
//   loaded once from device memory in mma.m16n8k16's A layout a warp; a K
//   tile of 128 positions is B, K-major (D contiguous) in the 128-byte
//   swizzle: [D / 64][128 positions][128 bytes].
// - O += P V, m64nDk16 over 8 steps of 16 positions: P is the S
//   accumulators rounded to bf16 and repacked in registers as the A operand
//   (p rounded to bf16, as the mma.sync route and the plain forward do); the
//   V tile, laid out as K, is B MN-major (the transpose bit): rows of 64
//   values of D at one position, 8-position groups 1024 bytes apart, the
//   two 64-value blocks of D 16 KB apart.
// K and V tiles arrive through a ring of kFwdStages stages filled with
// 16-byte cp.async copies (rows past S zero-filled) by all 256 threads: the
// next tile's copies are in flight while this tile's products and softmax
// run. The online softmax stays in registers in fp32, with the logits in
// base 2 (s * scale * log2 e; lse = m ln 2 + log l), the masks of the
// CUDA-core kernels (causal with offset S - T, window, tail rows and
// columns) applied only on tiles that cross an edge, and p = 0 for masked
// pairs. A warpgroup skips a tile none of its rows attends. Query tiles
// are issued longest first: blockIdx.z counts down from the last tile, and
// z is the slowest grid dimension, so under a causal mask the tiles with
// the most live columns start first. o and lse have the layout and meaning
// of the other forward kernels; the dq, delta and dkv kernels read them.
// The kernel needs scale > 0; the entry sends any other scale to the
// CUDA-core forward. On an H100 the softmax's instructions, not the
// products, set the pace (fast_exp2 in place of exp2f made the kernel about
// 10% faster); two warpgroups taking turns on the tensor cores, P V
// overlapped with the next tile's softmax (Q in shared memory) and a
// 3-stage ring were each no faster (PERF.md section 6).

constexpr int kFwdRows = 128;   // query rows a block: two warpgroups of 64
constexpr int kFwdThreads = 256;
constexpr int kFwdCols = 128;   // K/V positions a tile
constexpr int kFwdStages = 2;   // K/V tiles in the ring

template <int HD>
struct FwdLayout {
  static constexpr int TILE = kFwdCols * HD * 2;  // bytes of a K (or V) tile
  // the stages, on a 1024-byte boundary (the swizzle's period)
  static constexpr size_t kBytes = (size_t)kFwdStages * 2 * TILE + 1024;
};


template <int HD>
__device__ __forceinline__ void wg_pv(float (&o)[HD / 2], const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wg_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_m64n64k16_rs<1>(o, a, desc, 1);
}
template <>
__device__ __forceinline__ void wg_pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  wgmma_m64n128k16_rs<1>(o, a, desc, 1);
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
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int Tq, int S, int H, int KH, int causal,
                       int window, float scale) {
  constexpr int KS = HD / 16;        // k16 steps of Q K^T
  constexpr int CH = HD / 8;         // 16-byte chunks a row
  constexpr int PV = kFwdCols / 16;  // k16 steps of P V
  constexpr int TILE = FwdLayout<HD>::TILE;
  extern __shared__ __align__(16) uint8_t fw_smem[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(fw_smem);
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);  // [stage][K, V][D / 64][128][128 B]

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

  // the K and V tile at positions [j0, j0 + 128) into stage st: chunk c of
  // position row r at c ^ (r & 7) of its 128-byte row. A thread copies the
  // same chunk column lc of rows lr + 256 / CH * i, so its shared-memory
  // offsets and its rows' strides are fixed before the loop.
  constexpr int RSTEP = kFwdThreads / CH;  // rows between a thread's chunks
  const int lr = tid / CH, lc = tid % CH;
  const uint32_t soff =
      (uint32_t)((lc >> 3) * (kFwdCols * 128) + lr * 128 + (((lc & 7) ^ (lr & 7)) << 4));
  const __nv_bfloat16* kt = kg + (long long)lr * kv_stride + lc * 8;
  const __nv_bfloat16* vt = vg + (long long)lr * kv_stride + lc * 8;
  auto load_tile = [&](int j0, int st) {
    const uint32_t kd = base + (uint32_t)(st * 2 * TILE) + soff;
    const long long g0 = (long long)j0 * kv_stride;
#pragma unroll
    for (int i = 0; i < kFwdCols / RSTEP; ++i) {
      const int row = j0 + lr + i * RSTEP;
      const long long g = row < S ? g0 + (long long)i * RSTEP * kv_stride : 0;
      cp_async16(kd + i * RSTEP * 128, kt + g, row < S ? 16 : 0);
      cp_async16(kd + TILE + i * RSTEP * 128, vt + g, row < S ? 16 : 0);
    }
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
  const float sl2 = scale * 1.4426950408889634f;  // logits in base 2

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
#pragma unroll
    for (int kk = 0; kk < PV; ++kk) {
      pa[kk][0] = pack2(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack2(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack2(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack2(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(pa);
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PV; ++kk)
      wg_pv<HD>(oacc, pa[kk], sw128_desc(vs_s + kk * 2048, kFwdCols * 128));
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
  __nv_bfloat16* og = o + ((long long)b * Tq * H + h) * HD;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + tig * 2;
    if (row_a < Tq)
      *reinterpret_cast<uint32_t*>(og + (long long)row_a * q_stride + d) =
          pack2(oacc[4 * dt] * inv[0], oacc[4 * dt + 1] * inv[0]);
    if (row_b < Tq)
      *reinterpret_cast<uint32_t*>(og + (long long)row_b * q_stride + d) =
          pack2(oacc[4 * dt + 2] * inv[1], oacc[4 * dt + 3] * inv[1]);
  }
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

template <int HD>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                             const Shape& s, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = FwdLayout<HD>::kBytes;
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.H, s.B, (s.Tq + kFwdRows - 1) / kFwdRows);
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  kernel<<<grid, kFwdThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, s.Tq, s.S, s.H, s.KH, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v, const void* dO,
                         const float* lse, const float* delta, void* dq, const Shape& s,
                         cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const size_t smem = (size_t)4 * kTcTile * (HD + 8) * sizeof(bf16);
  auto kernel = flash_dq_tc_kernel<HD>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Tq + kTcTile - 1) / kTcTile, s.H, s.B);
  kernel<<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), lse, delta, static_cast<bf16*>(dq), s.Tq, s.S, s.H,
      s.KH, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v, const void* dO,
                          const float* lse, const float* delta, void* dk, void* dv,
                          const Shape& s, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const size_t smem =
      (size_t)4 * kTcTile * (HD + 8) * sizeof(bf16) + 2 * kTcTile * sizeof(float);
  auto kernel = flash_dkv_tc_kernel<HD>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.S + kTcTile - 1) / kTcTile, s.KH, s.B);
  kernel<<<grid, kTcThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dO), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s.Tq, s.S, s.H, s.KH, s.causal, s.window, s.scale);
  return cudaGetLastError();
}

// The tensor-core kernels take bf16 with D = 64 or 128.
bool takes_tc(const Shape& s, int dtype) {
  return dtype == 1 && (s.D == 64 || s.D == 128);
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
// float32. Each returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int T, int S, int H, int KH, int D,
                                   int causal, int window, float scale, int dtype,
                                   void* stream) {
  const Shape s{B, T, S, H, KH, D, causal, window, scale};
  if (bad_shape(s, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  // the wgmma forward folds scale into its base-2 exponent and takes the
  // row maximum of the raw logits: it needs scale > 0
  if (takes_tc(s, dtype) && scale > 0.f)
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
                                  int causal, int window, float scale, int dtype,
                                  void* stream) {
  const Shape s{B, T, S, H, KH, D, causal, window, scale};
  if (bad_shape(s, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (takes_tc(s, dtype))
    return (int)(D == 64 ? launch_dq_tc<64>(q, k, v, dO, lse_f, delta_f, dq, s, st)
                         : launch_dq_tc<128>(q, k, v, dO, lse_f, delta_f, dq, s, st));
#define DQ(TT, NJ) launch_dq<TT, NJ>(q, k, v, dO, lse_f, delta_f, dq, s, st)
  DS_DISPATCH(DQ);
#undef DQ
}

extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v,
                                   const void* dO, const void* lse, const void* delta,
                                   void* dk, void* dv, int B, int T, int S, int H, int KH,
                                   int D, int causal, int window, float scale, int dtype,
                                   void* stream) {
  const Shape s{B, T, S, H, KH, D, causal, window, scale};
  if (bad_shape(s, dtype)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  if (takes_tc(s, dtype))
    return (int)(D == 64
                     ? launch_dkv_tc<64>(q, k, v, dO, lse_f, delta_f, dk, dv, s, st)
                     : launch_dkv_tc<128>(q, k, v, dO, lse_f, delta_f, dk, dv, s, st));
#define DKV(TT, NJ) launch_dkv<TT, NJ>(q, k, v, dO, lse_f, delta_f, dk, dv, s, st)
  DS_DISPATCH(DKV);
#undef DKV
}
