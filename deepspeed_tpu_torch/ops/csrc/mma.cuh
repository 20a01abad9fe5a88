// Building blocks shared by the port's tensor-core kernels
// (flash_attention.cu's training kernels, paged_attention.cu's prefill
// route, quantized_matmul.cu's wgmma route): 16-byte cp.async copies into
// shared memory; mma.sync m16n8k16 bf16 products with fp32 accumulation,
// fragment loads from bf16 tiles staged in shared memory with a row pitch
// of HD + 8 (free of bank conflicts for the 4-byte fragment loads and the
// 16-byte ldmatrix rows), and the repacking of a 16 x 64 accumulator tile
// as the A operand of a second product over a 64-row tile; the attention
// kernels' masked-logit constants.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // a masked logit
constexpr float kMasked = -5e29f;  // any logit at or below this was masked

// 16 bytes global -> shared, the last 16 - bytes of them zero (bytes = 0
// reads nothing). No memory clobber: cp_async_wait and __syncthreads order
// the copies against the reads of shared memory, and the compiler stays
// free to hoist the loads that compute the next copies' addresses.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// at most N of this thread's newest groups still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, each transposed: lane 8 i + r
// gives the address of row r (16 bytes) of matrix i; the lane receives
// (M_i[2 tig][gid], M_i[2 tig + 1][gid]) in r[i].
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A fragment: rows m0 + gid and m0 + gid + 8, columns k0 .. k0 + 15 of a
// row-major tile with pitch STR.
template <int STR>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* X, int m0,
                                       int k0, int gid, int tig) {
  const __nv_bfloat16* p = X + (m0 + gid) * STR + k0 + tig * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * STR);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * STR + 8);
}

// acc[nt] += A(rows m0.. of X) . Y^T for the 8 column tiles nt of a 64-row
// tile Y: both tiles row-major over the reduction dimension (HD).
template <int HD>
__device__ __forceinline__ void tc_dot_nt(float (&acc)[8][4], const __nv_bfloat16* X,
                                          const __nv_bfloat16* Y, int m0, int gid, int tig) {
  constexpr int STR = HD + 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    load_a<STR>(a, X, m0, ks * 16, gid, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* p = Y + (nt * 8 + gid) * STR + ks * 16 + tig * 2;
      mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(p),
               *reinterpret_cast<const uint32_t*>(p + 8));
    }
  }
}

// out[dt] += P . Y for the 16 x 64 tile P held in accumulator layout (p[nt])
// and the 64-row tile Y [64][HD] (reduction along Y's rows).
template <int HD>
__device__ __forceinline__ void tc_dot_acc(float (&out)[HD / 8][4], const float (&p)[8][4],
                                           const __nv_bfloat16* Y, int lane) {
  constexpr int STR = HD + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    a[0] = pack2(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack2(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack2(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack2(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* row =
        Y + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * STR + (lane / 16) * 8;
#pragma unroll
    for (int dt = 0; dt < HD / 8; dt += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, row + dt * 8);
      mma_bf16(out[dt], a, b[0], b[1]);
      mma_bf16(out[dt + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace
