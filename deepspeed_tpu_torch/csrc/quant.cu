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
//   * dequantize_int8 is elementwise over the flat [N*D] array, row = i / D.
//   * dequantize_fp8 moves 16 codes (a chunk) a thread: one 16-byte load,
//     Hopper's fp8x2 -> f16x2 conversion (exact: e4m3 and e5m2 lie inside
//     fp16), one fp32 product by the row's scale, bf16/fp16 pairs packed
//     and written with 16-byte stores (two a chunk; four for fp32). The
//     warp trades the loaded codes by shuffles so that each store
//     instruction writes whole chunks: with each lane storing its own
//     chunk, lanes wrote 16 bytes every 32 or 64, and the fp32-out case ran
//     at half the rate of the bf16 one. A chunk lies inside one row, so its
//     row and scale are found once a chunk, by a row-major walk (a carry,
//     no division per element). Where a row's codes do not start on a
//     16-byte boundary (d % 16 != 0, a view with an offset) the codes
//     before its first boundary and after its last whole chunk take a
//     scalar path in the same launch; where no code boundary puts the
//     output on one too (`deq_plan`; ops/quant.py::dequant_plan mirrors
//     it), the whole call does. The grid holds a thread a chunk: it beat
//     one wave of threads looping over 1, 2 or 4 chunks each (PERF.md).
// Not done yet (later work): vector accesses for the quantize kernels and
// dequantize_int8, keeping a wide row in shared memory instead of reading
// it twice.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
  static constexpr __nv_fp8_interpretation_t kInterp = __NV_E4M3;
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
  static constexpr __nv_fp8_interpretation_t kInterp = __NV_E5M2;
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

// ---------------------------------------------------------------------------
// dequantize fp8: 16-code chunks and a scalar path
// ---------------------------------------------------------------------------
constexpr int kChunk = 16;             // codes one 16-byte load brings
constexpr int kDeqBlocksPerSm = 4096;  // grid cap: a thread a chunk up to 138 M chunks

// How a call splits its rows. Row r's first 16-byte code boundary lies
// head(r) = (head0 - r * d) mod 16 codes in; codes [head(r), head(r) + 16
// chunks) go in whole chunks, the row's other `rest` = d - 16 chunks codes
// (before head(r), after the chunks) the scalar path. chunks is the most
// every row holds past its head; 0 sends the whole call the scalar way.
struct DeqPlan {
  int head0;
  int dmod;                            // d % 16
  int chunks;
  int rest;
};

__host__ __device__ __forceinline__ int deq_head(const DeqPlan& pl, int64_t row) {
  return (pl.head0 - (int)(((row & 15) * pl.dmod) & 15)) & 15;
}

// The plan of codes at q and outputs of `out_size` bytes at out: chunks
// only where a code at a 16-byte boundary has its output at one too.
DeqPlan deq_plan(const void* q, const void* out, int64_t n, int d, int out_size) {
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  DeqPlan pl{0, d & 15, 0, d};
  if (((oa - qa * (uintptr_t)out_size) & 15) != 0) return pl;
  pl.head0 = (int)((16 - (qa & 15)) & 15);
  int hmax = 0;
  for (int64_t r = 0; r < n && r < 16; ++r) hmax = std::max(hmax, deq_head(pl, r));
  if (d >= hmax + kChunk) {
    pl.chunks = (d - hmax) / kChunk;
    pl.rest = d - kChunk * pl.chunks;
  }
  return pl;
}

template <typename TO> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four codes (byte i of `w` is code i) times `scale`.
template <int CODE>
__device__ __forceinline__ void decode4(uint32_t w, float scale, float (&v)[4]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const __half2_raw h2 = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w >> (16 * hh)), Codec<CODE>::kInterp);
    const float2 f = __half22float2(__half2(h2));
    v[2 * hh] = f.x * scale;
    v[2 * hh + 1] = f.y * scale;
  }
}

template <int CODE, typename TO>
__global__ void __launch_bounds__(kThreads)
dequantize_fp8(const __nv_fp8_storage_t* __restrict__ q, const float* __restrict__ s,
               TO* __restrict__ out, int64_t n, int d, DeqPlan pl) {
  // a chunk's 16 outputs are P = sizeof(TO) 16-byte pieces; store round i
  // of lane l writes piece l % P of the chunk of lane (32 / P) i + l / P,
  // so each store instruction of the warp covers 32 / P whole chunks
  constexpr int P = sizeof(TO);
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total_chunks = n * pl.chunks;
  if (pl.chunks > 0) {
    // chunk c = (row, col) holds codes row * d + head(row) + 16 col; lane
    // l of a warp takes chunk base + l, then moves `stride` chunks on: the
    // column advances with a carry into the row (one division at start).
    // The loop is warp-uniform: every lane takes part in the shuffles.
    int64_t row = first / pl.chunks;
    int col = (int)(first - row * pl.chunks);
    const int64_t step_rows = stride / pl.chunks;
    const int step_cols = (int)(stride - step_rows * pl.chunks);
    for (int64_t base = first - lane; base < total_chunks; base += stride) {
      const bool mine = base + lane < total_chunks;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      float scale = 0.f;
      int64_t at = 0;
      if (mine) {
        at = row * d + deq_head(pl, row) + kChunk * col;
        raw = __ldg(reinterpret_cast<const uint4*>(q + at));
        scale = __ldg(s + row);
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int src = (32 / P) * i + lane / P, piece = lane % P;
        const uint32_t w0 = __shfl_sync(0xffffffffu, raw.x, src);
        const uint32_t w1 = __shfl_sync(0xffffffffu, raw.y, src);
        const uint32_t w2 = __shfl_sync(0xffffffffu, raw.z, src);
        const uint32_t w3 = __shfl_sync(0xffffffffu, raw.w, src);
        const float sc = __shfl_sync(0xffffffffu, scale, src);
        const int64_t dst = __shfl_sync(0xffffffffu, at, src) + piece * (kChunk / P);
        if (base + src >= total_chunks) continue;
        if constexpr (P == 4) {        // fp32: word `piece`, 4 outputs
          float v[4];
          decode4<CODE>(piece == 0 ? w0 : piece == 1 ? w1 : piece == 2 ? w2 : w3, sc, v);
          *reinterpret_cast<float4*>(out + dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {                       // bf16 / fp16: words 2 piece, +1, 8 outputs
          float lo[4], hi[4];
          decode4<CODE>(piece ? w2 : w0, sc, lo);
          decode4<CODE>(piece ? w3 : w1, sc, hi);
          *reinterpret_cast<uint4*>(out + dst) =
              make_uint4(pack2<TO>(lo[0], lo[1]), pack2<TO>(lo[2], lo[3]),
                         pack2<TO>(hi[0], hi[1]), pack2<TO>(hi[2], hi[3]));
        }
      }
      col += step_cols;
      row += step_rows;
      if (col >= pl.chunks) {
        col -= pl.chunks;
        ++row;
      }
    }
  }
  // the scalar path: code k of each row's `rest`, before its head or past
  // its chunks
  const int64_t total = n * pl.rest;
  for (int64_t e = first; e < total; e += stride) {
    const int64_t r = e / pl.rest;
    int c = (int)(e - r * pl.rest);
    if (pl.chunks > 0 && c >= deq_head(pl, r)) c += kChunk * pl.chunks;
    const int64_t i = r * d + c;
    out[i] = from_float<TO>(Codec<CODE>::decode(q[i]) * s[r]);
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
cudaError_t launch_dequant(const void* q, const float* s, void* out, int64_t n, int d,
                           int code, cudaStream_t st) {
  TO* o = static_cast<TO*>(out);
  if (code == kInt8) {
    const int64_t total = n * d;
    const int64_t g = grid_for(total, kThreads, 16);
    dequantize_int8<TO><<<dim3((unsigned)g), kThreads, 0, st>>>(static_cast<const int8_t*>(q), s, o, total, d);
    return cudaGetLastError();
  }
  if (code != kE4M3 && code != kE5M2) return cudaErrorInvalidValue;
  const DeqPlan pl = deq_plan(q, out, n, d, (int)sizeof(TO));
  const int64_t g = grid_for(std::max(n * pl.chunks, n * pl.rest), kThreads, kDeqBlocksPerSm);
  const auto* qc = static_cast<const __nv_fp8_storage_t*>(q);
  if (code == kE4M3)
    dequantize_fp8<kE4M3, TO><<<dim3((unsigned)g), kThreads, 0, st>>>(qc, s, o, n, d, pl);
  else
    dequantize_fp8<kE5M2, TO><<<dim3((unsigned)g), kThreads, 0, st>>>(qc, s, o, n, d, pl);
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
  if (out_dtype == kF32) return (int)launch_dequant<float>(q, s, out, n, d, code, st);
  if (out_dtype == kBF16) return (int)launch_dequant<__nv_bfloat16>(q, s, out, n, d, code, st);
  if (out_dtype == kF16) return (int)launch_dequant<__half>(q, s, out, n, d, code, st);
  return (int)cudaErrorInvalidValue;
}
