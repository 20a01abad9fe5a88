// Host-side fused optimizers for ZeRO-Offload.
//
// TPU-native counterpart of the reference's AVX-vectorized CPU optimizers
// (csrc/adam/cpu_adam_impl.cpp:299, csrc/adagrad/cpu_adagrad.cpp:243,
// csrc/lion/cpu_lion_impl.cpp:255 with csrc/includes/simd.h templates).
// The reference hand-writes AVX2/AVX512 intrinsics; here tight scalar loops
// with restrict pointers + -O3 -march=native let GCC auto-vectorize to the
// same width, and OpenMP splits the flat partition across host cores.
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cmath>
#include <cstddef>
#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Adam/AdamW over flat fp32 arrays. adam_w_mode: decoupled weight decay.
// bias_correction uses step (1-based).
void ds_adam_step(float* __restrict params, const float* __restrict grads,
                  float* __restrict exp_avg, float* __restrict exp_avg_sq,
                  int64_t n, float lr, float beta1, float beta2, float eps,
                  float weight_decay, int adam_w_mode, int bias_correction,
                  int64_t step) {
    const float bc1 = bias_correction ? 1.0f - std::pow(beta1, (float)step) : 1.0f;
    const float bc2 = bias_correction ? 1.0f - std::pow(beta2, (float)step) : 1.0f;
    const float one_minus_b1 = 1.0f - beta1;
    const float one_minus_b2 = 1.0f - beta2;

#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grads[i];
        float p = params[i];
        if (weight_decay != 0.0f && !adam_w_mode) g += weight_decay * p;
        float m = exp_avg[i] = beta1 * exp_avg[i] + one_minus_b1 * g;
        float v = exp_avg_sq[i] = beta2 * exp_avg_sq[i] + one_minus_b2 * g * g;
        float update = (m / bc1) / (std::sqrt(v / bc2) + eps);
        if (weight_decay != 0.0f && adam_w_mode) update += weight_decay * p;
        params[i] = p - lr * update;
    }
}

void ds_adagrad_step(float* __restrict params, const float* __restrict grads,
                     float* __restrict exp_avg_sq, int64_t n, float lr,
                     float eps, float weight_decay) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grads[i] + weight_decay * params[i];
        float v = exp_avg_sq[i] = exp_avg_sq[i] + g * g;
        params[i] -= lr * g / (std::sqrt(v) + eps);
    }
}

void ds_lion_step(float* __restrict params, const float* __restrict grads,
                  float* __restrict exp_avg, int64_t n, float lr, float beta1,
                  float beta2, float weight_decay) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grads[i];
        float p = params[i];
        float c = beta1 * exp_avg[i] + (1.0f - beta1) * g;
        float sign = (c > 0.0f) ? 1.0f : ((c < 0.0f) ? -1.0f : 0.0f);
        params[i] = p - lr * (sign + weight_decay * p);
        exp_avg[i] = beta2 * exp_avg[i] + (1.0f - beta2) * g;
    }
}

// fp32 <-> bf16 conversion helpers for the HBM<->host path (params travel
// as bf16, master copies stay fp32 — reference ZeRO-Offload data flow).
void ds_fp32_to_bf16(const float* __restrict src, uint16_t* __restrict dst,
                     int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        __builtin_memcpy(&bits, &src[i], 4);
        // round-to-nearest-even
        uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
        dst[i] = (uint16_t)((bits + rounding) >> 16);
    }
}

void ds_bf16_to_fp32(const uint16_t* __restrict src, float* __restrict dst,
                     int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits = ((uint32_t)src[i]) << 16;
        __builtin_memcpy(&dst[i], &bits, 4);
    }
}

}  // extern "C"
