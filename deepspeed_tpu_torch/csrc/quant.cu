// Per-row symmetric int8 and fp8 quantization and dequantization, for Hopper
// (sm_90a).
//
// Replaces four TPU kernels, all launched through `rowwise_pallas_op`
// (deepspeed_tpu/ops/pallas/quant.py):
//   `_quant_kernel`        quant.py        -> quantize_int8_{warp,block,cluster}
//                                             (+ quantize_int8_scaled, its
//                                             encode step on given scales)
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
// the row's absmax needs the row before any code can be written.
// The int8 quantize (qgZ's, on every gradient of a training step) reads
// each element from device memory once in 16-byte pieces (4 fp32 or 8
// bf16/fp16 values, a "chunk"), keeps the row on chip between the absmax
// and the encode, and writes a chunk's codes with one 4- or 8-byte store
// (a warp's stores cover whole consecutive 128- or 256-byte spans). Three
// paths by the row's chunks, each a set of template instances the host
// picks from (`quant_plan`; ops/quant.py::quant_plan mirrors it):
//   * quantize_int8_warp<T, PER, RPW>: up to 128 chunks (qgZ's rows of 128
//     fp32, 32 chunks): a warp takes RPW = 4 / PER rows, lane l holding
//     chunks l, l + 32, ... of each in registers, all loaded before the
//     first row's shuffle max (one row a warp left 32 KB in flight an SM).
//   * quantize_int8_block<T, THREADS, PER>: up to 4096 chunks (qgZ's rows
//     of 4096 and 14336 fp32: 256 x 4 and 512 x 7 chunks): one block per
//     row, thread t holding chunks t, t + THREADS, ... in registers, one
//     block reduction (one barrier). A persistent block with a 2-stage
//     `cp.async` ring was 7% faster at 14336 but 11% slower at 4096, which
//     carries twice the bytes of a qgZ step (PERF.md).
//   * quantize_int8_cluster<T, THREADS, PER>: wider rows (the lm_head's
//     128256 fp32, 513 KB): a thread-block cluster of kQuantCluster = 16
//     CTAs per row (non-portable, launched with cudaLaunchKernelEx),
//     persistent; CTA c holds segment c of the row's chunks in a
//     kQuantStages-deep shared-memory ring that each thread fills for itself
//     with `cp.async`, so the next row's copies are in flight while this row
//     is reduced, exchanged, encoded and stored. Each CTA takes its
//     segment's absmax, and the CTAs read each other's through distributed
//     shared memory after a cluster barrier; a NaN or inf anywhere in the
//     row reaches every CTA's scale this way. It reaches 63% of the bytes
//     bound at the lm_head: one cluster a row with the row in registers
//     reached 41-61% (4, 8 or 16 CTAs), 8 CTAs or deeper rings did worse,
//     and what holds the cluster back is not measured yet (PERF.md).
//   Where a row does not start on a 16-byte boundary (an odd width, a view
//   with an offset), the elements before its first boundary and after its
//   last whole chunk (fewer than 2 chunks' worth) take a scalar path in the
//   same launch, held by the first lanes of the row's warp, block or first
//   CTA; where the codes of a chunk would not lie on a boundary of their
//   store's width, they are stored one byte at a time.
// The fp8 quantize keeps the two-pass design:
//   * Rows up to kWarpRowMax wide (ZeRO-Inference's groups of 64): one warp
//     per row, lanes stride the row (coalesced), a shuffle reduction gives
//     the absmax, and the second pass re-reads the row from L1.
//   * Wider rows: one block per row, a block reduction for the absmax, the
//     row read a second time (from L2 where it is still there).
//   * Both loop over rows grid-stride, so any N fits in one launch.
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
// Not done yet (later work): the one-pass body for the fp8 quantize, and
// vector accesses for dequantize_int8.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// ---------------------------------------------------------------------------
// int8 quantize: each element read once, 16-byte loads, the row on chip
// ---------------------------------------------------------------------------
constexpr int kQuantCluster = 16;      // CTAs of the cluster that holds one wide row

// How a call splits its rows, and which instance runs it. Row r's first
// 16-byte boundary of x lies head(r) = (head0 - r * d) mod V elements in
// (V = 16 / sizeof(T) elements a chunk); the row's `chunks` whole chunks
// follow it, and its other `rest` = d - V chunks elements (before head(r),
// after the chunks) take the scalar path. `wide`: a chunk's V codes lie on
// a V-byte boundary, so they go out in one store. path 0 is the warp
// kernel, 1 the block kernel, 2 the cluster kernel, -1 a row too wide for
// any instance; `threads` and `per` (chunks a lane or thread holds) name
// the instance, `rows` the rows a warp takes (warp path), `cluster` the
// CTAs of a row and `seg` the chunks of a CTA's segment (the whole row but
// on the cluster path).
struct QuantPlan {
  int head0;
  int dmod;                            // d % V
  int vec;                             // V
  int chunks;
  int rest;
  int wide;
  int path;
  int threads;
  int per;
  int rows;
  int cluster;
  int seg;
};

__host__ __device__ __forceinline__ int quant_head(const QuantPlan& pl, int64_t row) {
  const int m = pl.vec - 1;            // V is a power of two
  return (pl.head0 - (int)(((row & m) * pl.dmod) & m)) & m;
}

// The plan of x [n, d] with elements of `size` bytes at x, codes at q.
QuantPlan quant_plan(const void* x, const void* q, int64_t n, int d, int size) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  QuantPlan pl{0, 0, 16 / size, 0, d, 0, 0, 32, 1, 1, 1, 0};
  const int v = pl.vec;
  pl.dmod = d % v;
  if (xa % size == 0) {                // else no element lies on a boundary
    pl.head0 = (int)(((16 - xa % 16) % 16) / size);
    int hmax = 0;
    for (int64_t r = 0; r < n && r < v; ++r) hmax = std::max(hmax, quant_head(pl, r));
    if (d >= hmax + v) {
      pl.chunks = (d - hmax) / v;
      pl.rest = d - v * pl.chunks;
    }
    pl.wide = ((qa - xa / size) % v) == 0;
  }
  const int c = pl.chunks;
  pl.seg = c;
  if (c <= 128) {                      // warp: 32 lanes x PER chunks, 4 / PER rows
    pl.per = c <= 32 ? 1 : c <= 64 ? 2 : 4;
    pl.rows = 4 / pl.per;
  } else if (c <= 4096) {              // block
    pl.path = 1;
    if (c <= 1024) {
      pl.threads = 256;
      pl.per = c <= 256 ? 1 : c <= 512 ? 2 : 4;
    } else {
      pl.threads = 512;
      pl.per = c <= 2048 ? 4 : c <= 3584 ? 7 : 8;
    }
  } else {                             // cluster: a segment a CTA
    pl.path = 2;
    pl.cluster = kQuantCluster;
    pl.seg = (c + kQuantCluster - 1) / kQuantCluster;
    pl.threads = 512;
    pl.per = pl.seg <= 1024 ? 2 : pl.seg <= 2048 ? 4 : 8;
    if (pl.seg > 4096) pl.path = -1;
  }
  if (pl.rest > 32) pl.path = -1;      // a lane or thread a scalar: an unaligned x
  return pl;
}

// The V values of a 16-byte chunk as fp32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[16 / sizeof(T)]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    } else {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ float chunk_absmax(const uint4& raw, float m) {
  float v[16 / sizeof(T)];
  unpack<T>(raw, v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) m = nanmax(m, fabsf(v[i]));
  return m;
}

// The V codes of a chunk at dst: one store when `wide`, else byte by byte.
template <typename T>
__device__ __forceinline__ void chunk_encode(const uint4& raw, float scale, int8_t* dst,
                                             bool wide) {
  constexpr int V = 16 / sizeof(T);
  float v[V];
  unpack<T>(raw, v);
  uint32_t w[V / 4];
#pragma unroll
  for (int i = 0; i < V / 4; ++i) w[i] = 0u;
#pragma unroll
  for (int i = 0; i < V; ++i)
    w[i / 4] |= (uint32_t)(uint8_t)Codec<kInt8>::encode(v[i] / scale) << (8 * (i % 4));
  if (wide) {
    if constexpr (V == 4) *reinterpret_cast<uint32_t*>(dst) = w[0];
    else *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = (int8_t)(w[i / 4] >> (8 * (i % 4)));
  }
}

// Every thread of the block gets the NaN-keeping max of `m` over the block,
// after one barrier; `red` holds THREADS / 32 floats.
template <int THREADS>
__device__ __forceinline__ float block_nanmax_once(float m, float* red) {
  m = warp_nanmax(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) m = nanmax(m, red[w]);
  return m;
}

// One named kernel per path and instance, so a build log and a profile
// read by kernel name.
//
// quantize_int8_warp: RPW rows a warp, PER chunks of each a lane (lane l
// holds chunks l, l + 32, ...), all loaded before the first row's
// reduction; lane k < rest holds each row's scalar element k.
template <typename T, int PER, int RPW>
__global__ void __launch_bounds__(kThreads)
quantize_int8_warp(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                   int64_t n, int d, QuantPlan pl) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t r0 = ((int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * RPW;
  if (r0 >= n) return;                 // warp-uniform
  uint4 raw[RPW][PER];
  float xs[RPW];
  int head[RPW], spos[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int64_t r = r0 + i;
    head[i] = quant_head(pl, r);
    spos[i] = -1;
    xs[i] = 0.f;
    if (r >= n) continue;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = lane + 32 * k;
      raw[i][k] = c < pl.chunks
                      ? __ldg(reinterpret_cast<const uint4*>(x + r * d + head[i] + (int64_t)c * V))
                      : make_uint4(0u, 0u, 0u, 0u);
    }
    if (lane < pl.rest) {
      spos[i] = lane < head[i] ? lane : lane + V * pl.chunks;
      xs[i] = to_float(x[r * d + spos[i]]);
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int64_t r = r0 + i;
    if (r >= n) break;                 // warp-uniform
    float m = fabsf(xs[i]);
#pragma unroll
    for (int k = 0; k < PER; ++k) m = chunk_absmax<T>(raw[i][k], m);   // zero chunks add 0
    const float scale = row_scale<kInt8>(warp_nanmax(m));
    int8_t* qr = q + r * d;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = lane + 32 * k;
      if (c < pl.chunks) chunk_encode<T>(raw[i][k], scale, qr + head[i] + (int64_t)c * V, pl.wide);
    }
    if (spos[i] >= 0) qr[spos[i]] = Codec<kInt8>::encode(xs[i] / scale);
    if (lane == 0) s[r] = scale;
  }
}

// quantize_int8_block: one block a row, thread t holding chunks t, t +
// THREADS, ... in registers, and the row's scalar element t where t < rest.
template <typename T, int THREADS, int PER>
__global__ void __launch_bounds__(THREADS)
quantize_int8_block(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                    int64_t n, int d, QuantPlan pl) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[THREADS / 32];
  const int t = threadIdx.x;
  const int64_t r = blockIdx.x;
  const int head = quant_head(pl, r);
  const T* xr = x + r * d;
  uint4 raw[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = t + k * THREADS;
    raw[k] = c < pl.chunks ? __ldg(reinterpret_cast<const uint4*>(xr + head + (int64_t)c * V))
                           : make_uint4(0u, 0u, 0u, 0u);
  }
  int spos = -1;
  float xs = 0.f;
  if (t < pl.rest) {
    spos = t < head ? t : t + V * pl.chunks;
    xs = to_float(xr[spos]);
  }
  float m = fabsf(xs);
#pragma unroll
  for (int k = 0; k < PER; ++k) m = chunk_absmax<T>(raw[k], m);   // zero chunks add 0
  const float scale = row_scale<kInt8>(block_nanmax_once<THREADS>(m, red));
  int8_t* qr = q + r * d;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = t + k * THREADS;
    if (c < pl.chunks) chunk_encode<T>(raw[k], scale, qr + head + (int64_t)c * V, pl.wide);
  }
  if (spos >= 0) qr[spos] = Codec<kInt8>::encode(xs / scale);
  if (t == 0) s[r] = scale;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The float at `local` (a shared address) in the shared memory of CTA
// `rank` of this cluster.
__device__ __forceinline__ float ld_cluster(const float* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Stages of the cluster kernel's shared-memory ring (a stage a row): 2,
// three 64 KB CTAs an SM at the lm_head, beat 3 and 4, which fit fewer
// (PERF.md)
constexpr int kQuantStages = 2;

// Dynamic shared memory of a cluster instance: kQuantStages stages of
// THREADS * PER 16-byte chunks.
template <int THREADS, int PER>
constexpr int ring_bytes() { return kQuantStages * THREADS * PER * 16; }

// quantize_int8_cluster: the rows of one cluster of pl.cluster CTAs,
// persistent: rows first, first + step, ... CTA `rank` holds chunks [c0,
// end) of a row (c0 = rank * seg), thread t the chunks c0 + t + k THREADS,
// copied by itself with `cp.async` into stage (row index mod ST) of the
// ring, so the next ST - 1 rows' copies are in flight while this row is
// reduced, exchanged, encoded and stored; CTA 0's first `rest` threads hold
// the row's scalar elements. A CTA's max goes to `part`, which the
// cluster's CTAs read from each other after a cluster barrier. red, part
// and row_max alternate between two slots by row, so the one cluster
// barrier a row orders their reuse.
template <typename T, int THREADS, int PER>
__global__ void __launch_bounds__(THREADS)
quantize_int8_cluster(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                      int64_t n, int d, QuantPlan pl) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SLOTS = THREADS * PER, ST = kQuantStages;
  extern __shared__ uint4 ring[];      // [ST][SLOTS]
  __shared__ float red[2][THREADS / 32];
  __shared__ float part[2], row_max[2];
  const int t = threadIdx.x, rank = cluster_rank(), cs = pl.cluster;
  const int64_t first = blockIdx.x / cs, step = gridDim.x / cs;
  const int c0 = rank * pl.seg, end = min(pl.chunks, c0 + pl.seg);
  auto issue = [&](int64_t r, int stage) {   // row r (if any) into `stage`, one group
    if (r < n) {
      const T* xr = x + r * d + quant_head(pl, r);
      uint4* dst = ring + stage * SLOTS;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int c = c0 + t + k * THREADS;
        if (c < end) cp_async_16(dst + t + k * THREADS, xr + (int64_t)c * V);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < ST - 1; ++i) issue(first + i * step, i);
  int it = 0;
  for (int64_t r = first; r < n; r += step, ++it) {
    issue(r + (ST - 1) * step, (it + ST - 1) % ST);  // into the stage row r - step used
    cp_async_wait<ST - 1>();           // row r's copies of this thread have landed
    const uint4* buf = ring + (it % ST) * SLOTS;
    const int slot = it & 1;
    const int head = quant_head(pl, r);
    float xs = 0.f;
    int spos = -1;
    if (rank == 0 && t < pl.rest) {
      spos = t < head ? t : t + V * pl.chunks;
      xs = to_float(x[r * d + spos]);
    }
    float m = fabsf(xs);
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (c0 + t + k * THREADS < end) m = chunk_absmax<T>(buf[t + k * THREADS], m);
    m = block_nanmax_once<THREADS>(m, red[slot]);
    if (t == 0) part[slot] = m;
    cluster_sync();                    // every CTA's part of row r is written
    if (t < 32) {                      // the row's absmax, in rank order
      float rm = t < cs ? ld_cluster(&part[slot], t) : 0.f;
      rm = warp_nanmax(rm);
      if (t == 0) row_max[slot] = rm;
    }
    __syncthreads();
    const float scale = row_scale<kInt8>(row_max[slot]);
    int8_t* qr = q + r * d;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = c0 + t + k * THREADS;
      if (c < end)
        chunk_encode<T>(buf[t + k * THREADS], scale, qr + head + (int64_t)c * V, pl.wide);
    }
    if (spos >= 0) qr[spos] = Codec<kInt8>::encode(xs / scale);
    if (rank == 0 && t == 0) s[r] = scale;
  }
  cp_async_wait<0>();                  // nothing in flight at exit
  cluster_sync();                      // no CTA exits while its part may be read
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

// The int8 encode of rows whose scales are given (ZeRO++ qwZ: a block cut
// along its last axis holds pieces of rows whose scale is the whole row's,
// runtime/zero/partition.py::qwz_codes): q = clip(rint(x / s[row])), the
// `_quant_kernel`'s encode step. Elementwise over the flat array, each
// element read and written once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_int8_scaled(const T* __restrict__ x, const float* __restrict__ s,
                     int8_t* __restrict__ q, int64_t total, int d) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride)
    q[i] = Codec<kInt8>::encode(to_float(x[i]) / s[i / d]);
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

// The cluster kernel instance: a persistent grid of as many clusters of
// pl.cluster CTAs as the card holds at once, at most n, launched with
// cudaLaunchKernelEx (a cluster past the portable 8 CTAs asks for it).
template <typename T, int THREADS, int PER>
cudaError_t launch_int8_cluster(const T* x, int8_t* q, float* s, int64_t n, int d,
                                const QuantPlan& pl, cudaStream_t st) {
  auto* kernel = quantize_int8_cluster<T, THREADS, PER>;
  constexpr int smem = ring_bytes<THREADS, PER>();
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int resident = 0;             // clusters, per instantiation (one cluster size a build)
  if (resident == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && pl.cluster > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cfg.gridDim = dim3((unsigned)pl.cluster);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
  }
  cfg.gridDim = dim3((unsigned)(std::min<int64_t>(n, resident) * pl.cluster));
  return cudaLaunchKernelEx(&cfg, kernel, x, q, s, n, d, pl);
}

// The int8 quantize of x [n, d] by the instance `quant_plan` names; a row
// too wide for any instance, or a grid past the launch limit, is refused.
template <typename T>
cudaError_t launch_int8(const T* x, int8_t* q, float* s, int64_t n, int d, cudaStream_t st) {
  const QuantPlan pl = quant_plan(x, q, n, d, (int)sizeof(T));
  if (pl.path < 0) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaSuccess;
  if (pl.path == 0) {
    const int64_t per_block = (kThreads / 32) * pl.rows;
    const int64_t blocks = (n + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const dim3 g((unsigned)blocks);
    if (pl.per == 1) quantize_int8_warp<T, 1, 4><<<g, kThreads, 0, st>>>(x, q, s, n, d, pl);
    else if (pl.per == 2) quantize_int8_warp<T, 2, 2><<<g, kThreads, 0, st>>>(x, q, s, n, d, pl);
    else quantize_int8_warp<T, 4, 1><<<g, kThreads, 0, st>>>(x, q, s, n, d, pl);
  } else if (pl.path == 1) {
    if (n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    const dim3 g((unsigned)n);         // a block a row
    if (pl.threads == 256) {
      if (pl.per == 1) quantize_int8_block<T, 256, 1><<<g, 256, 0, st>>>(x, q, s, n, d, pl);
      else if (pl.per == 2) quantize_int8_block<T, 256, 2><<<g, 256, 0, st>>>(x, q, s, n, d, pl);
      else quantize_int8_block<T, 256, 4><<<g, 256, 0, st>>>(x, q, s, n, d, pl);
    } else {
      if (pl.per == 4) quantize_int8_block<T, 512, 4><<<g, 512, 0, st>>>(x, q, s, n, d, pl);
      else if (pl.per == 7) quantize_int8_block<T, 512, 7><<<g, 512, 0, st>>>(x, q, s, n, d, pl);
      else quantize_int8_block<T, 512, 8><<<g, 512, 0, st>>>(x, q, s, n, d, pl);
    }
  } else {
    if (pl.per == 8) err = launch_int8_cluster<T, 512, 8>(x, q, s, n, d, pl, st);
    else if (pl.per == 4) err = launch_int8_cluster<T, 512, 4>(x, q, s, n, d, pl, st);
    else err = launch_int8_cluster<T, 512, 2>(x, q, s, n, d, pl, st);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quant(const void* x, void* q, float* s, int64_t n, int d,
                         int code, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (code == kInt8) return launch_int8<T>(xt, static_cast<int8_t*>(q), s, n, d, st);
  const bool warp = d <= kWarpRowMax;
  const int64_t g = warp ? grid_for(n, kThreads / 32, 32) : grid_for(n, 1, 8);
  if (code == kE4M3 || code == kE5M2) {
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

template <typename T>
cudaError_t launch_int8_scaled(const void* x, const float* s, int8_t* q,
                               int64_t n, int d, cudaStream_t st) {
  const int64_t total = n * d;
  const int64_t g = grid_for(total, kThreads, 16);
  quantize_int8_scaled<T><<<dim3((unsigned)g), kThreads, 0, st>>>(
      static_cast<const T*>(x), s, q, total, d);
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

// The int8 quantize's plan of x [n, d] in `in_dtype` (as above) at x with
// codes at q, into out[12]: head0, d % V, V, chunks, rest, wide, path,
// threads, per, rows, cluster, seg (QuantPlan's fields in order). Reads no
// memory; returns cudaErrorInvalidValue for a dtype not compiled.
extern "C" int dstt_quant_plan(const void* x, const void* q, long long n, int d,
                               int in_dtype, int* out) {
  if (n <= 0 || d <= 0 || in_dtype < kF32 || in_dtype > kF16) return (int)cudaErrorInvalidValue;
  const QuantPlan pl = quant_plan(x, q, n, d, in_dtype == kF32 ? 4 : 2);
  const int f[12] = {pl.head0, pl.dmod, pl.vec, pl.chunks, pl.rest, pl.wide,
                     pl.path, pl.threads, pl.per, pl.rows, pl.cluster, pl.seg};
  for (int i = 0; i < 12; ++i) out[i] = f[i];
  return 0;
}

// x [n, d] in `in_dtype` (as above) and fp32 scales s [n] -> int8 codes
// q [n, d] = clip(rint(x / s[row]), -127, 127).
extern "C" int dstt_quantize_int8_scaled(const void* x, const float* s, void* q,
                                         long long n, int d, int in_dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  auto* qt = static_cast<int8_t*>(q);
  if (in_dtype == kF32) return (int)launch_int8_scaled<float>(x, s, qt, n, d, st);
  if (in_dtype == kBF16) return (int)launch_int8_scaled<__nv_bfloat16>(x, s, qt, n, d, st);
  if (in_dtype == kF16) return (int)launch_int8_scaled<__half>(x, s, qt, n, d, st);
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
