// Per-row symmetric int8 and fp8 quantization and dequantization, for Hopper
// (sm_90a).
//
// Replaces four TPU kernels, all launched through `rowwise_pallas_op`
// (deepspeed_tpu/ops/pallas/quant.py):
//   `_quant_kernel`        quant.py        -> quantize_int8_{warp,block}
//   `_dequant_kernel`      quant.py        -> dequantize_int8
//   `_fp8_quant_kernel`    fp_quant.py     -> quantize_fp8_{warp,block}
//   `_fp8_dequant_kernel`  fp_quant.py     -> dequantize_fp8
// Same functions, bit for bit. For each row of x [N, D] (fp32, bf16 or fp16,
// widened to fp32):
//   absmax = max |x|;  scale = max(absmax * (1 / qmax), 1e-12)
//   int8: q = clip(rint(x / scale), -127, 127)       (qmax 127)
//   fp8:  q = fp8_rn(x / scale), e4m3 or e5m2         (qmax 448 or 57344)
// and dequantize writes (float(q) * scale) rounded to the output dtype. The
// reference's `absmax / qmax` divides by a constant, which XLA turns into a
// product with the constant's fp32 reciprocal, so the kernels multiply by
// that reciprocal too; `x / scale` divides by a value, which XLA keeps as a
// division, so the kernels divide there (IEEE division: the build has no
// fast math). Rounding is half to even (rintf, the fp8 conversion), and
// dequantize multiplies once in fp32. A NaN in a row
// makes its scale NaN, as jnp.max / jnp.maximum propagate it (CUDA's fmaxf
// would drop it), and an inf makes it inf, so a non-finite gradient stays
// non-finite after a qgZ round trip; a NaN quotient becomes int8 code 0 as
// in the reference's conversion. For int8, x / scale can land a hair above
// 127 on the absmax element (rint and the clip bring it back); with the
// reciprocal's scale it never lands above the fp8 maxima.
//
// What bounds them: bytes. Each element is read, divided and written once;
// the row's absmax needs the row before any code can be written. Design:
//   * Rows up to kWarpRowMax wide (ZeRO-Inference's groups of 64, qgZ's rows
//     of 128): one warp per row, lanes stride the row (coalesced), a shuffle
//     reduction gives the absmax, and the second pass re-reads the row from
//     L1.
//   * Wider rows (qgZ's rows of 4096, 14336 and 128256 fp32, up to 513 KB):
//     one block per row, a block reduction for the absmax, the row read a
//     second time (from L2 where it is still there).
//   * Both loop over rows grid-stride, so any N fits in one launch; no row
//     padding (the TPU's block_rows) is needed.
//   * Dequantize is elementwise over the flat [N*D] array, row = i / D.
// Not done yet (later work): vector loads, keeping a wide row in shared
// memory instead of reading it twice.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpRowMax = 512;       // widest row given one warp

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };
enum Code { kInt8 = 0, kE4M3 = 1, kE5M2 = 2 };

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// max that propagates NaN, as jnp.max and jnp.maximum do
__device__ __forceinline__ float nanmax(float m, float a) {
  return (a > m || a != a) ? a : m;
}

__device__ __forceinline__ float warp_nanmax(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// Every thread of the block gets the block's NaN-propagating max. `red`
// holds 33 floats.
__device__ __forceinline__ float block_nanmax(float m, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  m = warp_nanmax(m);
  if (lane == 0) red[wid] = m;
  __syncthreads();
  if (wid == 0) {
    m = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    m = warp_nanmax(m);
    if (lane == 0) red[32] = m;
  }
  __syncthreads();
  return red[32];
}

template <int CODE> struct Codec;
template <> struct Codec<kInt8> {
  using code_t = int8_t;
  static constexpr float kRecip = 1.0f / 127.0f;
  __device__ static code_t encode(float v) {
    const float r = rintf(v);
    // a NaN quotient (a row holding NaN or inf) gives code 0, as the
    // reference's float-to-int8 conversion does; fmaxf would clip it to -127
    if (r != r) return 0;
    return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
  __device__ static float decode(code_t c) { return static_cast<float>(c); }
};
template <> struct Codec<kE4M3> {
  using code_t = __nv_fp8_storage_t;
  static constexpr float kRecip = 1.0f / 448.0f;
  __device__ static code_t encode(float v) {
    return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  }
  __device__ static float decode(code_t c) {      // exact: e4m3 is inside fp16
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(c, __NV_E4M3)));
  }
};
template <> struct Codec<kE5M2> {
  using code_t = __nv_fp8_storage_t;
  static constexpr float kRecip = 1.0f / 57344.0f;
  __device__ static code_t encode(float v) {
    return __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E5M2);
  }
  __device__ static float decode(code_t c) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(c, __NV_E5M2)));
  }
};

// scale = max(absmax * (1 / qmax), 1e-12), NaN kept
template <int CODE>
__device__ __forceinline__ float row_scale(float absmax) {
  return nanmax(absmax * Codec<CODE>::kRecip, 1e-12f);
}

// ---------------------------------------------------------------------------
// quantize: one warp per row (narrow rows)
// ---------------------------------------------------------------------------
template <typename T, int CODE>
__device__ __forceinline__ void quant_warp_rows(
    const T* __restrict__ x, typename Codec<CODE>::code_t* __restrict__ q,
    float* __restrict__ s, int64_t n, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t r = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       r < n; r += warps) {                     // r is the same on the whole warp
    const T* xr = x + r * d;
    float m = 0.0f;
    for (int j = lane; j < d; j += 32) m = nanmax(m, fabsf(to_float(xr[j])));
    const float scale = row_scale<CODE>(warp_nanmax(m));
    typename Codec<CODE>::code_t* qr = q + r * d;
    for (int j = lane; j < d; j += 32)
      qr[j] = Codec<CODE>::encode(to_float(xr[j]) / scale);
    if (lane == 0) s[r] = scale;
  }
}

// ---------------------------------------------------------------------------
// quantize: one block per row (wide rows)
// ---------------------------------------------------------------------------
template <typename T, int CODE>
__device__ __forceinline__ void quant_block_rows(
    const T* __restrict__ x, typename Codec<CODE>::code_t* __restrict__ q,
    float* __restrict__ s, int64_t n, int d) {
  __shared__ float red[33];
  for (int64_t r = blockIdx.x; r < n; r += gridDim.x) {
    const T* xr = x + r * d;
    float m = 0.0f;
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      m = nanmax(m, fabsf(to_float(xr[j])));
    const float scale = row_scale<CODE>(block_nanmax(m, red));
    typename Codec<CODE>::code_t* qr = q + r * d;
    for (int j = threadIdx.x; j < d; j += blockDim.x)
      qr[j] = Codec<CODE>::encode(to_float(xr[j]) / scale);
    if (threadIdx.x == 0) s[r] = scale;
  }
}

// One named kernel per TPU kernel and launch shape, so a build log and a
// profile read by kernel name.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int8_warp(const T* x, int8_t* q, float* s, int64_t n, int d) {
  quant_warp_rows<T, kInt8>(x, q, s, n, d);
}
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int8_block(const T* x, int8_t* q, float* s, int64_t n, int d) {
  quant_block_rows<T, kInt8>(x, q, s, n, d);
}
template <typename T, int CODE>
__global__ void __launch_bounds__(kThreads)
quantize_fp8_warp(const T* x, __nv_fp8_storage_t* q, float* s, int64_t n, int d) {
  quant_warp_rows<T, CODE>(x, q, s, n, d);
}
template <typename T, int CODE>
__global__ void __launch_bounds__(kThreads)
quantize_fp8_block(const T* x, __nv_fp8_storage_t* q, float* s, int64_t n, int d) {
  quant_block_rows<T, CODE>(x, q, s, n, d);
}

// ---------------------------------------------------------------------------
// dequantize: elementwise over the flat array
// ---------------------------------------------------------------------------
template <int CODE, typename TO>
__device__ __forceinline__ void dequant_flat(
    const typename Codec<CODE>::code_t* __restrict__ q,
    const float* __restrict__ s, TO* __restrict__ out, int64_t total, int d) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride)
    out[i] = from_float<TO>(Codec<CODE>::decode(q[i]) * s[i / d]);
}

template <typename TO>
__global__ void __launch_bounds__(kThreads)
dequantize_int8(const int8_t* q, const float* s, TO* out, int64_t total, int d) {
  dequant_flat<kInt8, TO>(q, s, out, total, d);
}
template <int CODE, typename TO>
__global__ void __launch_bounds__(kThreads)
dequantize_fp8(const __nv_fp8_storage_t* q, const float* s, TO* out,
               int64_t total, int d) {
  dequant_flat<CODE, TO>(q, s, out, total, d);
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
  int64_t blocks = (work + per_block - 1) / per_block;
  int64_t cap = (int64_t)sm_count() * per_sm;
  return blocks < cap ? (blocks > 0 ? blocks : 1) : cap;
}

template <typename T>
cudaError_t launch_quant(const void* x, void* q, float* s, int64_t n, int d,
                         int code, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const bool warp = d <= kWarpRowMax;
  const int64_t g = warp ? grid_for(n, kThreads / 32, 32) : grid_for(n, 1, 8);
  if (code == kInt8) {
    int8_t* qt = static_cast<int8_t*>(q);
    if (warp) quantize_int8_warp<T><<<dim3((unsigned)g), kThreads, 0, st>>>(xt, qt, s, n, d);
    else quantize_int8_block<T><<<dim3((unsigned)g), kThreads, 0, st>>>(xt, qt, s, n, d);
  } else if (code == kE4M3 || code == kE5M2) {
    auto* qt = static_cast<__nv_fp8_storage_t*>(q);
    if (code == kE4M3) {
      if (warp) quantize_fp8_warp<T, kE4M3><<<dim3((unsigned)g), kThreads, 0, st>>>(xt, qt, s, n, d);
      else quantize_fp8_block<T, kE4M3><<<dim3((unsigned)g), kThreads, 0, st>>>(xt, qt, s, n, d);
    } else {
      if (warp) quantize_fp8_warp<T, kE5M2><<<dim3((unsigned)g), kThreads, 0, st>>>(xt, qt, s, n, d);
      else quantize_fp8_block<T, kE5M2><<<dim3((unsigned)g), kThreads, 0, st>>>(xt, qt, s, n, d);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_dequant(const void* q, const float* s, void* out,
                           int64_t total, int d, int code, cudaStream_t st) {
  TO* o = static_cast<TO*>(out);
  const int64_t g = grid_for(total, kThreads, 16);
  if (code == kInt8)
    dequantize_int8<TO><<<dim3((unsigned)g), kThreads, 0, st>>>(static_cast<const int8_t*>(q), s, o, total, d);
  else if (code == kE4M3)
    dequantize_fp8<kE4M3, TO><<<dim3((unsigned)g), kThreads, 0, st>>>(
        static_cast<const __nv_fp8_storage_t*>(q), s, o, total, d);
  else if (code == kE5M2)
    dequantize_fp8<kE5M2, TO><<<dim3((unsigned)g), kThreads, 0, st>>>(
        static_cast<const __nv_fp8_storage_t*>(q), s, o, total, d);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// x [n, d] row-major in `in_dtype` (0 float32, 1 bfloat16, 2 float16) ->
// codes q [n, d] (code 0 int8, 1 float8_e4m3fn, 2 float8_e5m2) and fp32
// scales s [n]. Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for a combination not compiled.
extern "C" int dstt_quantize_rows(const void* x, void* q, float* s, long long n,
                                  int d, int in_dtype, int code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (in_dtype == kF32) return (int)launch_quant<float>(x, q, s, n, d, code, st);
  if (in_dtype == kBF16) return (int)launch_quant<__nv_bfloat16>(x, q, s, n, d, code, st);
  if (in_dtype == kF16) return (int)launch_quant<__half>(x, q, s, n, d, code, st);
  return (int)cudaErrorInvalidValue;
}

// codes q [n, d] and scales s [n] -> out [n, d] in `out_dtype` (as above).
extern "C" int dstt_dequantize_rows(const void* q, const float* s, void* out,
                                    long long n, int d, int code, int out_dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)n * d;
  if (out_dtype == kF32) return (int)launch_dequant<float>(q, s, out, total, d, code, st);
  if (out_dtype == kBF16) return (int)launch_dequant<__nv_bfloat16>(q, s, out, total, d, code, st);
  if (out_dtype == kF16) return (int)launch_dequant<__half>(q, s, out, total, d, code, st);
  return (int)cudaErrorInvalidValue;
}
