// Fused CPU Adam/AdamW for host-offloaded optimizer states.
//
// Reference analog: csrc/adam/cpu_adam_impl.cpp (AVX2/AVX512 Step_1/4/8
// templates with OMP tiling). Rebuilt for the TPU framework's host-offload
// tier: OpenMP `parallel for simd` + __restrict__ aliasing guarantees so
// -O3 -march=native emits the same packed AVX the reference hand-writes
// (Step_8-style unrolling comes from the compiler),
// exposed via a C ABI for ctypes binding (no pybind11 in this image).
//
// Semantics match the framework's in-HBM optax path: bias-corrected Adam with
// decoupled (AdamW) or L2 weight decay, fp32 master params and states, and an
// optional bf16 shadow copy written for the device transfer.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// One fused Adam step over a flat fp32 shard.
//   params, grads, exp_avg, exp_avg_sq: length n
//   step: 1-based step count (for bias correction)
//   adamw: 1 = decoupled weight decay, 0 = L2 (grad += wd * param)
void cpu_adam_step(float* __restrict__ params, const float* __restrict__ grads,
                   float* __restrict__ exp_avg,
                   float* __restrict__ exp_avg_sq, int64_t n, float lr, float beta1,
                   float beta2, float eps, float weight_decay, int adamw,
                   int64_t step) {
    const float bc1 = 1.0f - std::pow(beta1, (float)step);
    const float bc2 = 1.0f - std::pow(beta2, (float)step);
    const float step_size = lr / bc1;
    const float inv_sqrt_bc2 = 1.0f / std::sqrt(bc2);

#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grads[i];
        float p = params[i];
        if (!adamw && weight_decay != 0.0f) g += weight_decay * p;
        float m = beta1 * exp_avg[i] + (1.0f - beta1) * g;
        float v = beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
        exp_avg[i] = m;
        exp_avg_sq[i] = v;
        float denom = std::sqrt(v) * inv_sqrt_bc2 + eps;
        float p_new = p - step_size * (m / denom);
        // decoupled decay scales with lr, not the bias-corrected step size
        if (adamw && weight_decay != 0.0f) p_new -= lr * weight_decay * p;
        params[i] = p_new;
    }
}

// bf16 shadow copy of the fp32 master params (for the host->device transfer;
// reference: param fp16 shard update after CPU step).
void fp32_to_bf16(const float* __restrict__ src, uint16_t* __restrict__ dst,
                  int64_t n) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        std::memcpy(&bits, &src[i], 4);
        // round-to-nearest-even
        uint32_t rounding_bias = 0x7FFF + ((bits >> 16) & 1);
        dst[i] = (uint16_t)((bits + rounding_bias) >> 16);
    }
}

// Fused CPU Adagrad (reference: csrc/adagrad/cpu_adagrad.cpp)
void cpu_adagrad_step(float* __restrict__ params, const float* __restrict__ grads,
                      float* __restrict__ state_sum, int64_t n, float lr, float eps, float weight_decay) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grads[i];
        if (weight_decay != 0.0f) g += weight_decay * params[i];
        float s = state_sum[i] + g * g;
        state_sum[i] = s;
        params[i] -= lr * g / (std::sqrt(s) + eps);
    }
}

// Fused CPU Lion (reference: csrc/lion/cpu_lion_impl.cpp)
void cpu_lion_step(float* __restrict__ params, const float* __restrict__ grads,
                   float* __restrict__ exp_avg, int64_t n, float lr, float beta1, float beta2,
                   float weight_decay) {
#pragma omp parallel for simd schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        float g = grads[i];
        float m = exp_avg[i];
        float c = beta1 * m + (1.0f - beta1) * g;
        float update = (c > 0.0f) - (c < 0.0f);  // sign
        float p = params[i];
        p -= lr * (update + weight_decay * p);
        params[i] = p;
        exp_avg[i] = beta2 * m + (1.0f - beta2) * g;
    }
}

}  // extern "C"
