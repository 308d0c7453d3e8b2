// Fused bias + activation (+ dropout), forward and backward, for Hopper
// (sm_90a).
//
// Replaces the four TPU kernels of deepspeed_tpu/ops/pallas/fused_bias_act.py:
//   bias_act_kernel              <- `_bias_act_kernel`
//   bias_act_bwd_kernel          <- `_bias_act_bwd_kernel`
//   bias_act_dropout_kernel      <- `_bias_act_dropout_kernel`
//   bias_act_dropout_bwd_kernel  <- `_bias_act_dropout_bwd_kernel`
// Function, on x [N, D] (fp32 or bf16) and an fp32 bias [D], all in fp32:
//   y  = act(x + b)                                          forward
//   dx = act'(x + b) * g,  db partials = sums of dx          backward
// with act one of gelu (the tanh form, jax.nn.gelu's default), relu, silu
// and identity, each derivative written out (relu' is 0 at 0). The dropout
// variants keep an element when (bits >> 8) * 2^-24 >= rate, write a kept
// value as act(x + b) * scale (scale = fp32 1 / (1 - rate)) and 0 otherwise,
// and their backward draws the same bits again: the mask is never written to
// memory. The bits are Philox4x32-10 (Random123), counter based: flat
// element e = row * D + col takes word e % 4 of
//   philox(counter = (lo32(e / 4), hi32(e / 4), 0, 0), key = (seed, 0)),
// so the mask does not depend on the grid, the block or the row width's
// alignment, and the plain torch version draws the same bits. The TPU's own
// PRNG (`pltpu.prng_seed`) cannot be reproduced here; the reference's
// contract (forward and backward masks identical, the keep rate, seed
// determinism) holds per platform.
//
// What bounds it: bytes (x and out forward; x, g and dx backward). Design:
//   * A thread owns 4 neighbouring columns (one Philox draw when D % 4 == 0)
//     and keeps their bias in registers; `tpr` threads cover a row's tile of
//     4 * tpr columns, the block's 256 threads cover 256 / tpr rows at a
//     time, and blocks stride over row groups, so any N takes one launch.
//   * 16-byte (fp32) or 8-byte (bf16) accesses when D % 4 == 0 and the
//     pointers allow (the wrapper decides), else one element at a time.
//   * The backward's bias gradient: each block sums the fp32 dx of its
//     columns over the rows it visits, in a fixed order, then over its row
//     groups through shared memory, and writes one fp32 row of partials per
//     grid row (blockIdx.y); the wrapper sums the partials in a second,
//     ordered pass. No atomics: the same bits on every run. Rows past N are
//     bounds-checked, where the TPU wrapper zero-padded g.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Dtype { kF32 = 0, kBF16 = 1 };
enum Act { kGelu = 0, kRelu = 1, kSilu = 2, kIdentity = 3 };

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 4 elements as one access: 16 bytes of fp32 or 8 of bf16.
template <typename T> struct Quad;
template <> struct Quad<float> { using type = uint4; };
template <> struct Quad<__nv_bfloat16> { using type = uint2; };

// `nv` (1..4) elements at p widened to fp32; VEC: all 4 in one access.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* __restrict__ p, int nv, float* f) {
  if constexpr (VEC) {
    const typename Quad<T>::type raw = *reinterpret_cast<const typename Quad<T>::type*>(p);
    const T* xs = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = to_float(xs[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = i < nv ? to_float(p[i]) : 0.f;
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store4(T* __restrict__ p, int nv, const float* f) {
  if constexpr (VEC) {
    typename Quad<T>::type raw;
    T* xs = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) xs[i] = from_float<T>(f[i]);
    *reinterpret_cast<typename Quad<T>::type*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < nv) p[i] = from_float<T>(f[i]);
  }
}

// ---------------------------------------------------------------------------
// activations and their derivatives, in fp32. The plain version in
// ops/fused_bias_act.py takes the same operations in the same order; the
// _rn intrinsics keep nvcc from fusing a product and a sum into one
// rounding, which torch's separate ops never do.
// ---------------------------------------------------------------------------
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluCoef = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  return tanhf(__fmul_rn(kSqrt2OverPi, __fadd_rn(x, __fmul_rn(kGeluCoef, x3))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float act_fwd(int act, float x) {
  switch (act) {
    case kGelu: return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, gelu_tanh(x))));
    case kRelu: return x > 0.f ? x : 0.f;
    case kSilu: return __fmul_rn(x, sigmoid(x));
    default: return x;
  }
}

// gelu: 0.5 (1 + t) + 0.5 x (1 - t^2) sqrt(2/pi) (1 + 3 c x^2); silu:
// s (1 + x (1 - s)); relu: 1 where x > 0, else 0; identity: 1.
__device__ __forceinline__ float act_grad(int act, float x) {
  switch (act) {
    case kGelu: {
      const float t = gelu_tanh(x);
      const float du = __fmul_rn(kSqrt2OverPi,
                                 __fadd_rn(1.0f, __fmul_rn(3.0f * kGeluCoef, __fmul_rn(x, x))));
      return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(1.0f, t)),
                       __fmul_rn(__fmul_rn(0.5f, x),
                                 __fmul_rn(__fsub_rn(1.0f, __fmul_rn(t, t)), du)));
    }
    case kRelu: return x > 0.f ? 1.f : 0.f;
    case kSilu: {
      const float s = sigmoid(x);
      return __fmul_rn(s, __fadd_rn(1.0f, __fmul_rn(x, __fsub_rn(1.0f, s))));
    }
    default: return 1.f;
  }
}

// ---------------------------------------------------------------------------
// Philox4x32-10 (Salmon et al., SC'11; the constants of Random123)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, uint32_t k0) {
  uint32_t c2 = 0, c3 = 0, k1 = 0;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// keep[i] for the 4 elements from flat index e0 (the first `nv` count): two
// draws only when e0 is not a multiple of 4 and the quad spans two counters.
__device__ __forceinline__ void keep4(uint64_t e0, int nv, uint32_t seed,
                                     float rate, bool* keep) {
  const uint64_t q = e0 >> 2;
  const int off = (int)(e0 & 3);
  const uint4 a = philox((uint32_t)q, (uint32_t)(q >> 32), seed);
  uint4 b = a;
  if (off + nv > 4) b = philox((uint32_t)(q + 1), (uint32_t)((q + 1) >> 32), seed);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = off + i;
    const uint32_t bits = j < 4 ? word(a, j) : word(b, j - 4);
    keep[i] = (float)(bits >> 8) * (1.0f / 16777216.0f) >= rate;
  }
}

struct Args {
  const void* x;
  const float* bias;      // [D] fp32
  const void* g;          // backward: [N, D]
  void* out;              // forward: y; backward: dx
  float* db_parts;        // backward: [gridDim.y, D] fp32
  int64_t n;
  int d, tpr, act;
  float rate, scale;      // dropout: keep threshold and 1 / (1 - rate)
  uint32_t seed;
};

template <typename T, bool VEC, bool DROPOUT, bool BWD>
__device__ __forceinline__ void bias_act_body(const Args& a) {
  __shared__ float red[BWD ? kThreads * 4 : 1];
  const int tpr = a.tpr, rpi = kThreads / tpr;
  const int col_t = threadIdx.x % tpr, row_t = threadIdx.x / tpr;
  const int c0 = (blockIdx.x * tpr + col_t) * 4;
  const int nv = c0 < a.d ? min(4, a.d - c0) : 0;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* out = static_cast<T*>(a.out);
  float b[4], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    b[i] = i < nv ? a.bias[c0 + i] : 0.f;
    db[i] = 0.f;
  }
  const int64_t groups = (a.n + rpi - 1) / rpi;
  for (int64_t grp = blockIdx.y; grp < groups; grp += gridDim.y) {
    const int64_t r = grp * rpi + row_t;
    if (nv == 0 || r >= a.n) continue;
    const int64_t e0 = r * a.d + c0;
    float v[4];
    load4<T, VEC>(x + e0, nv, v);
    bool keep[4] = {true, true, true, true};
    if constexpr (DROPOUT) keep4((uint64_t)e0, nv, a.seed, a.rate, keep);
    if constexpr (!BWD) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float y = act_fwd(a.act, __fadd_rn(v[i], b[i]));
        v[i] = DROPOUT ? (keep[i] ? __fmul_rn(y, a.scale) : 0.f) : y;
      }
      store4<T, VEC>(out + e0, nv, v);
    } else {
      float gv[4];
      load4<T, VEC>(g + e0, nv, gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = act_grad(a.act, __fadd_rn(v[i], b[i]));
        v[i] = DROPOUT ? __fmul_rn(keep[i] ? __fmul_rn(d, a.scale) : 0.f, gv[i])
                       : __fmul_rn(d, gv[i]);
        db[i] = __fadd_rn(db[i], v[i]);  // zero in the unused lanes (gv = 0)
      }
      store4<T, VEC>(out + e0, nv, v);
    }
  }
  if constexpr (BWD) {
#pragma unroll
    for (int i = 0; i < 4; ++i) red[threadIdx.x * 4 + i] = db[i];
    __syncthreads();
    if (row_t == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = 0.f;
        for (int rt = 0; rt < rpi; ++rt) s += red[(rt * tpr + col_t) * 4 + i];
        if (i < nv) a.db_parts[(int64_t)blockIdx.y * a.d + c0 + i] = s;
      }
    }
  }
}

// One named kernel per TPU kernel, so a build log and a profile read by name.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) bias_act_kernel(Args a) {
  bias_act_body<T, VEC, false, false>(a);
}
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) bias_act_bwd_kernel(Args a) {
  bias_act_body<T, VEC, false, true>(a);
}
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) bias_act_dropout_kernel(Args a) {
  bias_act_body<T, VEC, true, false>(a);
}
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads) bias_act_dropout_bwd_kernel(Args a) {
  bias_act_body<T, VEC, true, true>(a);
}

enum Kind { kFwd = 0, kBwd = 1, kDropFwd = 2, kDropBwd = 3 };

template <typename T, bool VEC>
cudaError_t launch(int kind, const Args& a, dim3 grid, cudaStream_t st) {
  switch (kind) {
    case kFwd: bias_act_kernel<T, VEC><<<grid, kThreads, 0, st>>>(a); break;
    case kBwd: bias_act_bwd_kernel<T, VEC><<<grid, kThreads, 0, st>>>(a); break;
    case kDropFwd: bias_act_dropout_kernel<T, VEC><<<grid, kThreads, 0, st>>>(a); break;
    case kDropBwd: bias_act_dropout_bwd_kernel<T, VEC><<<grid, kThreads, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// One entry for the four kernels. kind: 0 bias_act, 1 bias_act_bwd, 2
// bias_act_dropout, 3 bias_act_dropout_bwd. x, g, out [n, d] row-major in
// `dtype` (0 float32, 1 bfloat16); bias [d] fp32; db_parts [grid_y, d] fp32
// (backward). act: 0 gelu, 1 relu, 2 silu, 3 identity. `tpr` (a power of two
// up to 256) threads cover 4 * tpr columns; the grid is (ceil(d / (4 * tpr)),
// grid_y). `vec` != 0 asks for 4-element accesses: the caller guarantees
// d % 4 == 0 and aligned pointers. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for arguments not taken.
extern "C" int dstt_bias_act(int kind, const void* x, const float* bias,
                             const void* g, void* out, float* db_parts,
                             long long n, int d, int dtype, int act, float rate,
                             float scale, unsigned int seed, int tpr, int grid_y,
                             int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0 || tpr <= 0 || tpr > kThreads || kThreads % tpr != 0 ||
      grid_y <= 0 || grid_y > 65535 || act < kGelu || act > kIdentity)
    return (int)cudaErrorInvalidValue;
  Args a{x, bias, g, out, db_parts, (int64_t)n, d, tpr, act, rate, scale, seed};
  const dim3 grid((unsigned)((d + 4 * tpr - 1) / (4 * tpr)), (unsigned)grid_y);
  if (dtype == kF32)
    return (int)(vec ? launch<float, true>(kind, a, grid, st)
                     : launch<float, false>(kind, a, grid, st));
  if (dtype == kBF16)
    return (int)(vec ? launch<__nv_bfloat16, true>(kind, a, grid, st)
                     : launch<__nv_bfloat16, false>(kind, a, grid, st));
  return (int)cudaErrorInvalidValue;
}
