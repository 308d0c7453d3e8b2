// RMSNorm forward, for Hopper (sm_90a).
//
// Replaces `_rms_fwd_kernel` (deepspeed_tpu/ops/pallas/rms_norm.py, wrapper
// `_rms_impl`). For each row of x [N, D] (fp32 or bf16) and a scale [D] (fp32
// or bf16), with the reference's rounding points:
//   var = mean(float(x)^2)                    (fp32 sum, divided by D)
//   inv = rsqrt(var + eps)
//   out = (float(x) * inv) * float(scale)     rounded once to x's dtype
// The backward is eager torch in the wrapper, as the reference's `_bwd` is
// jnp, not a kernel.
//
// What bounds it: bytes. Each element is read and written once; the row's
// sum of squares is needed before any output of the row. Design, as the quant
// kernels' rows:
//   * Rows up to kWarpRowMax wide: one warp per row, lanes stride the row,
//     a shuffle reduction, then the second pass re-reads the row from L1.
//   * Wider rows (Llama-3-8B's 4096): one block per row, a block reduction,
//     the second pass from L1/L2.
//   * Both grid-stride over rows, so any N takes one launch; the TPU's
//     `block_rows` padding has no counterpart.
//   * 16-byte loads and stores when the row width and the pointers allow
//     (the wrapper decides), else one element at a time: any D is taken.
// Not done yet (later work): keeping a wide row in registers or shared
// memory instead of reading it twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowMax = 1024;      // widest row given one warp

enum Dtype { kF32 = 0, kBF16 = 1 };

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

// VEC elements of x at p (16 bytes when VEC > 1) widened to fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, float* f) {
  if constexpr (VEC == 1) {
    f[0] = to_float(p[0]);
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* xs = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = to_float(xs[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* __restrict__ p, const float* f) {
  if constexpr (VEC == 1) {
    p[0] = from_float<T>(f[0]);
  } else {
    uint4 raw;
    T* xs = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) xs[i] = from_float<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Sum of squares of the part of row xr that thread `t` of `nt` reads.
template <typename T, int VEC>
__device__ __forceinline__ float partial_sumsq(const T* __restrict__ xr, int d,
                                               int t, int nt) {
  float acc = 0.f;
  for (int c = t * VEC; c < d; c += nt * VEC) {
    float f[VEC];
    load<T, VEC>(xr + c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc += f[i] * f[i];
  }
  return acc;
}

template <typename T, typename S, int VEC>
__device__ __forceinline__ void write_row(const T* __restrict__ xr,
                                          const S* __restrict__ scale,
                                          T* __restrict__ orow, int d, float inv,
                                          int t, int nt) {
  for (int c = t * VEC; c < d; c += nt * VEC) {
    float f[VEC];
    load<T, VEC>(xr + c, f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = (f[i] * inv) * to_float(scale[c + i]);
    store<T, VEC>(orow + c, f);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
rms_norm_warp(const T* __restrict__ x, const S* __restrict__ scale,
              T* __restrict__ out, int64_t n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t r = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       r < n; r += warps) {                      // r is the same on the whole warp
    const T* xr = x + r * d;
    const float var = warp_sum(partial_sumsq<T, VEC>(xr, d, lane, 32)) / (float)d;
    write_row<T, S, VEC>(xr, scale, out + r * d, d, rsqrtf(var + eps), lane, 32);
  }
}

template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
rms_norm_block(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int64_t n, int d, float eps) {
  __shared__ float red[kThreads / 32 + 1];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int64_t r = blockIdx.x; r < n; r += gridDim.x) {
    const T* xr = x + r * d;
    float s = warp_sum(partial_sumsq<T, VEC>(xr, d, threadIdx.x, kThreads));
    if (lane == 0) red[wid] = s;
    __syncthreads();
    if (wid == 0) {
      s = warp_sum(lane < kThreads / 32 ? red[lane] : 0.f);
      if (lane == 0) red[kThreads / 32] = s;
    }
    __syncthreads();
    const float var = red[kThreads / 32] / (float)d;
    write_row<T, S, VEC>(xr, scale, out + r * d, d, rsqrtf(var + eps),
                         threadIdx.x, kThreads);
    __syncthreads();                             // red is reused by the next row
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

int64_t grid_for(int64_t work, int64_t per_block, int64_t per_sm) {
  const int64_t blocks = (work + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sm_count() * per_sm;
  return blocks < cap ? (blocks > 0 ? blocks : 1) : cap;
}

template <typename T, typename S, int VEC>
cudaError_t launch(const void* x, const void* scale, void* out, int64_t n, int d,
                   float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const S* sc = static_cast<const S*>(scale);
  T* o = static_cast<T*>(out);
  if (d <= kWarpRowMax) {
    const int64_t g = grid_for(n, kThreads / 32, 16);
    rms_norm_warp<T, S, VEC><<<dim3((unsigned)g), kThreads, 0, st>>>(xt, sc, o, n, d, eps);
  } else {
    const int64_t g = grid_for(n, 1, 16);
    rms_norm_block<T, S, VEC><<<dim3((unsigned)g), kThreads, 0, st>>>(xt, sc, o, n, d, eps);
  }
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_vec(const void* x, const void* scale, void* out, int64_t n,
                       int d, float eps, int vec, cudaStream_t st) {
  if (vec) return launch<T, S, 16 / sizeof(T)>(x, scale, out, n, d, eps, st);
  return launch<T, S, 1>(x, scale, out, n, d, eps, st);
}

}  // namespace

// x [n, d] row-major in `x_dtype` (0 float32, 1 bfloat16), scale [d] in
// `scale_dtype` -> out [n, d] in x_dtype. `vec` != 0 asks for 16-byte
// accesses: the caller guarantees d * sizeof(x) % 16 == 0 and 16-byte
// aligned x and out. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a combination not compiled.
extern "C" int dstt_rms_norm(const void* x, const void* scale, void* out,
                             long long n, int d, float eps, int x_dtype,
                             int scale_dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (x_dtype == kF32 && scale_dtype == kF32)
    return (int)launch_vec<float, float>(x, scale, out, n, d, eps, vec, st);
  if (x_dtype == kF32 && scale_dtype == kBF16)
    return (int)launch_vec<float, __nv_bfloat16>(x, scale, out, n, d, eps, vec, st);
  if (x_dtype == kBF16 && scale_dtype == kF32)
    return (int)launch_vec<__nv_bfloat16, float>(x, scale, out, n, d, eps, vec, st);
  if (x_dtype == kBF16 && scale_dtype == kBF16)
    return (int)launch_vec<__nv_bfloat16, __nv_bfloat16>(x, scale, out, n, d, eps, vec, st);
  return (int)cudaErrorInvalidValue;
}
