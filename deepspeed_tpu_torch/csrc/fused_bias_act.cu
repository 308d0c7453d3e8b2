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
// What bounds it: bytes (x and out forward; x, g and dx backward), and in
// the dropout kernels nearly as much the instructions they issue: a
// 4-element Philox draw, the exact tanhf of the gelu and its derivative.
// At BERT-base's FFN the dropout forward's row loop issues about 48 SASS
// instructions an element, whose issue takes about as long as the bytes
// take to move, so it comes near its bound only where loads, draws and
// arithmetic overlap. Design:
//   * A thread owns W neighbouring columns and keeps their bias in
//     registers; `tpr` threads cover a row's tile of W * tpr columns, the
//     block's 256 threads cover 256 / tpr rows at a time, and blocks stride
//     over row groups, so any N takes one launch.
//   * W = 8 for bf16 where D % 8 == 0 and x, g and the output start on
//     16-byte boundaries: one 16-byte access per operand and two Philox
//     counters a row. Otherwise W = 4: 16-byte (fp32) or 8-byte (bf16)
//     accesses where D % 4 == 0 and the pointers allow, else one element at
//     a time (fp32 with 8 columns, two 16-byte accesses, was slower than
//     4). The host plans it (`plan` below; ops/fused_bias_act.py's
//     `launch_plan` mirrors it and the smoke holds the two equal).
//   * A thread takes U rows a pass (rows_per_pass): every load of the U
//     rows (x, and g backward) is issued before any Philox or activation
//     work, and the draws, which do not depend on the loads, run while the
//     loads are in flight.
//   * The activation is a template argument and the keep test a PTX select
//     on the value computed first, so a pass is one straight-line block:
//     with a runtime switch, or a C select the compiler turned into a branch
//     around each element's gelu, no two elements' chains overlapped.
//   * A draw is 10 rounds of two 32 x 32 -> 64-bit products (one
//     IMAD.WIDE.U32 each gives both words) and two 3-input xors; the round
//     keys seed + i * 0x9E3779B9 are uniform over the launch, computed on
//     the host into the kernel's arguments, and i * 0xBB67AE85 are
//     constants. The keep test is integer: (bits >> 8) >= thr with the
//     host's thr = ceil(float32(rate) * 2^24), the same answer as the float
//     test for every word (thr = 2^24, a rate that rounds to 1.0, keeps
//     nothing).
//   * The backward's bias gradient: each block sums the fp32 dx of its
//     columns over the rows it visits, in a fixed order, then over its row
//     groups through shared memory, and writes one fp32 row of partials per
//     grid row (blockIdx.y); the wrapper sums the partials in a second,
//     ordered pass. No atomics: the same bits on every run. Rows past N are
//     bounds-checked, where the TPU wrapper zero-padded g.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
enum Dtype { kF32 = 0, kBF16 = 1 };
enum Act { kGelu = 0, kRelu = 1, kSilu = 2, kIdentity = 3 };
enum Kind { kFwd = 0, kBwd = 1, kDropFwd = 2, kDropBwd = 3 };

// Per kernel and activation: the rows a thread's pass takes and the blocks
// an SM holds (the grid is one wave of them, and __launch_bounds__ holds
// registers so that they fit: no entry spills). The dropout forward runs 6
// blocks an SM of one row a pass (38 registers; 6% faster than 4 of two
// rows at F), but silu's IEEE division, a call, needs 4 blocks of two.
// The dropout backward takes one row a pass: two spilled at 3 blocks and
// measured the same (PERF.md). ops/fused_bias_act.py mirrors both.
__host__ __device__ constexpr int rows_per_pass(int kind, int act) {
  return kind == kDropBwd || (kind == kDropFwd && act != kSilu) ? 1 : 2;
}
__host__ __device__ constexpr int blocks_per_sm(int kind, int act) {
  return kind == kFwd ? 4 : kind == kDropFwd ? (act == kSilu ? 4 : 6) : 3;
}
constexpr int kRounds = 10;

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

// W elements of T as loaded: 8-byte words (bf16, W = 4) or 16-byte ones.
template <typename T, int W>
struct Pack {
  static constexpr int kBytes = W * (int)sizeof(T);
  using Word = typename std::conditional<(kBytes >= 16), uint4, uint2>::type;
  Word w[kBytes / sizeof(Word)];
  __device__ __forceinline__ T at(int i) const { return reinterpret_cast<const T*>(w)[i]; }
};

// `nv` (1..W) elements at p; VEC: all W in whole-word accesses. Lanes past
// nv hold 0.
template <typename T, int W, bool VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, int nv, Pack<T, W>& r) {
  using Word = typename Pack<T, W>::Word;
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(r.w) / sizeof(Word)); ++i)
      r.w[i] = reinterpret_cast<const Word*>(p)[i];
  } else {
    T* xs = reinterpret_cast<T*>(r.w);
#pragma unroll
    for (int i = 0; i < W; ++i) xs[i] = i < nv ? p[i] : from_float<T>(0.f);
  }
}

template <typename T, int W, bool VEC>
__device__ __forceinline__ void store(T* __restrict__ p, int nv, const float* f) {
  if constexpr (VEC) {
    Pack<T, W> r;
    T* xs = reinterpret_cast<T*>(r.w);
#pragma unroll
    for (int i = 0; i < W; ++i) xs[i] = from_float<T>(f[i]);
    using Word = typename Pack<T, W>::Word;
#pragma unroll
    for (int i = 0; i < (int)(sizeof(r.w) / sizeof(Word)); ++i)
      reinterpret_cast<Word*>(p)[i] = r.w[i];
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i)
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

// The activation is a template argument, so a pass over a thread's rows is
// one straight-line block the compiler can interleave (a switch per element
// cost three branches an element and kept each element's chain apart).
template <int ACT>
__device__ __forceinline__ float act_fwd(float x) {
  if constexpr (ACT == kGelu) {
    return __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, gelu_tanh(x))));
  } else if constexpr (ACT == kRelu) {
    return x > 0.f ? x : 0.f;
  } else if constexpr (ACT == kSilu) {
    return __fmul_rn(x, sigmoid(x));
  } else {
    return x;
  }
}

// gelu: 0.5 (1 + t) + 0.5 x (1 - t^2) sqrt(2/pi) (1 + 3 c x^2); silu:
// s (1 + x (1 - s)); relu: 1 where x > 0, else 0; identity: 1.
template <int ACT>
__device__ __forceinline__ float act_grad(float x) {
  if constexpr (ACT == kGelu) {
    const float t = gelu_tanh(x);
    const float du = __fmul_rn(kSqrt2OverPi,
                               __fadd_rn(1.0f, __fmul_rn(3.0f * kGeluCoef, __fmul_rn(x, x))));
    return __fadd_rn(__fmul_rn(0.5f, __fadd_rn(1.0f, t)),
                     __fmul_rn(__fmul_rn(0.5f, x),
                               __fmul_rn(__fsub_rn(1.0f, __fmul_rn(t, t)), du)));
  } else if constexpr (ACT == kRelu) {
    return x > 0.f ? 1.f : 0.f;
  } else if constexpr (ACT == kSilu) {
    const float s = sigmoid(x);
    return __fmul_rn(s, __fadd_rn(1.0f, __fmul_rn(x, __fsub_rn(1.0f, s))));
  } else {
    return 1.f;
  }
}

// ---------------------------------------------------------------------------
// Philox4x32-10 (Salmon et al., SC'11; the constants of Random123)
// ---------------------------------------------------------------------------
struct Args {
  const void* x;
  const float* bias;      // [D] fp32
  const void* g;          // backward: [N, D]
  void* out;              // forward: y; backward: dx
  float* db_parts;        // backward: [gridDim.y, D] fp32
  int64_t n;
  int d, tpr;
  uint32_t thr;           // dropout: keep where (bits >> 8) >= thr
  float scale;            // dropout: fp32 1 / (1 - rate)
  uint32_t key[kRounds];  // key word 0 of each round: seed + i * 0x9E3779B9
};

// Counter (c0, c1, 0, 0) under the round keys (key[i], i * 0xBB67AE85).
// Each round's two products give their high and low words from one 64-bit
// product; round 0's zero words fold away.
__device__ __forceinline__ uint4 philox(uint32_t c0, uint32_t c1, const uint32_t* key) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
    c0 = (uint32_t)(p1 >> 32) ^ c1 ^ key[i];
    c2 = (uint32_t)(p0 >> 32) ^ c3 ^ (0xBB67AE85u * (uint32_t)i);
    c1 = (uint32_t)p1;
    c3 = (uint32_t)p0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// v where the element is kept ((word >> 8) >= thr), else +0, as one PTX
// select on v computed first: a C select let the compiler branch around
// act(x + b) for each element, one divergent region an element, so no two
// elements' chains could overlap.
__device__ __forceinline__ float keep_or_zero(uint32_t word, uint32_t thr, float v) {
  float r;
  asm("{\n\t.reg .pred k;\n\t"
      "setp.ge.u32 k, %1, %2;\n\t"
      "selp.f32 %0, %3, 0f00000000, k;\n\t}"
      : "=f"(r)
      : "r"(word >> 8), "r"(thr), "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The W words of elements e0 .. e0 + W - 1 (the first nv of them). VEC:
// e0 % W == 0 (D % W == 0), so W / 4 whole counters. Otherwise W = 4 and a
// second draw only where the 4 elements span two counters.
template <int W, bool VEC>
__device__ __forceinline__ void draw(uint64_t e0, int nv, const uint32_t* key, uint32_t* bits) {
  const uint64_t q = e0 >> 2;
  if constexpr (VEC) {
    // q is even when W = 8, so q + 1 keeps q's high word
    uint4 v[W / 4];
#pragma unroll
    for (int k = 0; k < W / 4; ++k) v[k] = philox((uint32_t)q + k, (uint32_t)(q >> 32), key);
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      bits[4 * k] = v[k].x;
      bits[4 * k + 1] = v[k].y;
      bits[4 * k + 2] = v[k].z;
      bits[4 * k + 3] = v[k].w;
    }
  } else {
    static_assert(W == 4, "unaligned rows take 4 columns a thread");
    const int off = (int)(e0 & 3);
    const uint4 a = philox((uint32_t)q, (uint32_t)(q >> 32), key);
    uint4 b = a;
    if (off + nv > 4) b = philox((uint32_t)(q + 1), (uint32_t)((q + 1) >> 32), key);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = off + i;
      bits[i] = j < 4 ? word(a, j) : word(b, j - 4);
    }
  }
}

template <typename T, int W, bool VEC, int U, int ACT, bool DROPOUT, bool BWD>
__device__ __forceinline__ void bias_act_body(const Args& a) {
  __shared__ float red[BWD ? kThreads * W : 1];
  const int tpr = a.tpr, rpi = kThreads / tpr;
  const int col_t = threadIdx.x % tpr, row_t = threadIdx.x / tpr;
  const int c0 = (blockIdx.x * tpr + col_t) * W;
  const int nv = c0 < a.d ? min(W, a.d - c0) : 0;
  const T* x = static_cast<const T*>(a.x);
  const T* g = static_cast<const T*>(a.g);
  T* out = static_cast<T*>(a.out);
  float b[W], db[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    b[i] = i < nv ? a.bias[c0 + i] : 0.f;
    db[i] = 0.f;
  }
  const int64_t groups = (a.n + rpi - 1) / rpi;
  const int64_t step = gridDim.y;
  for (int64_t grp = blockIdx.y; nv > 0 && grp < groups; grp += step * U) {
    // every load of the U rows first
    int64_t e0[U];
    bool live[U];
    Pack<T, W> xv[U], gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = (grp + u * step) * rpi + row_t;
      live[u] = r < a.n;
      e0[u] = r * a.d + c0;
      if (live[u]) {
        load<T, W, VEC>(x + e0[u], nv, xv[u]);
        if constexpr (BWD) load<T, W, VEC>(g + e0[u], nv, gv[u]);
      }
    }
    // then the draws, independent of the loads
    uint32_t bits[U][DROPOUT ? W : 1];
    if constexpr (DROPOUT) {
#pragma unroll
      for (int u = 0; u < U; ++u) draw<W, VEC>((uint64_t)e0[u], nv, a.key, bits[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!live[u]) continue;
      float v[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float xb = __fadd_rn(to_float(xv[u].at(i)), b[i]);
        if constexpr (!BWD) {
          float y = act_fwd<ACT>(xb);
          if constexpr (DROPOUT) y = keep_or_zero(bits[u][i], a.thr, __fmul_rn(y, a.scale));
          v[i] = y;
        } else {
          float d = act_grad<ACT>(xb);
          if constexpr (DROPOUT) d = keep_or_zero(bits[u][i], a.thr, __fmul_rn(d, a.scale));
          v[i] = __fmul_rn(d, to_float(gv[u].at(i)));
          db[i] = __fadd_rn(db[i], v[i]);  // zero in the unused lanes (g = 0)
        }
      }
      store<T, W, VEC>(out + e0[u], nv, v);
    }
  }
  if constexpr (BWD) {
#pragma unroll
    for (int i = 0; i < W; ++i) red[threadIdx.x * W + i] = db[i];
    __syncthreads();
    if (row_t == 0) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        float s = 0.f;
        for (int rt = 0; rt < rpi; ++rt) s += red[(rt * tpr + col_t) * W + i];
        if (i < nv) a.db_parts[(int64_t)blockIdx.y * a.d + c0 + i] = s;
      }
    }
  }
}

// One named kernel per TPU kernel, so a build log and a profile read by name.
template <typename T, int W, bool VEC, int ACT>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kFwd, ACT))
    bias_act_kernel(Args a) {
  bias_act_body<T, W, VEC, rows_per_pass(kFwd, ACT), ACT, false, false>(a);
}
template <typename T, int W, bool VEC, int ACT>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kBwd, ACT))
    bias_act_bwd_kernel(Args a) {
  bias_act_body<T, W, VEC, rows_per_pass(kBwd, ACT), ACT, false, true>(a);
}
template <typename T, int W, bool VEC, int ACT>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kDropFwd, ACT))
    bias_act_dropout_kernel(Args a) {
  bias_act_body<T, W, VEC, rows_per_pass(kDropFwd, ACT), ACT, true, false>(a);
}
template <typename T, int W, bool VEC, int ACT>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(kDropBwd, ACT))
    bias_act_dropout_bwd_kernel(Args a) {
  bias_act_body<T, W, VEC, rows_per_pass(kDropBwd, ACT), ACT, true, true>(a);
}

template <typename T, int W, bool VEC, int ACT>
cudaError_t launch_act(int kind, const Args& a, dim3 grid, cudaStream_t st) {
  switch (kind) {
    case kFwd: bias_act_kernel<T, W, VEC, ACT><<<grid, kThreads, 0, st>>>(a); break;
    case kBwd: bias_act_bwd_kernel<T, W, VEC, ACT><<<grid, kThreads, 0, st>>>(a); break;
    case kDropFwd: bias_act_dropout_kernel<T, W, VEC, ACT><<<grid, kThreads, 0, st>>>(a); break;
    case kDropBwd:
      bias_act_dropout_bwd_kernel<T, W, VEC, ACT><<<grid, kThreads, 0, st>>>(a);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int W, bool VEC>
cudaError_t launch(int kind, int act, const Args& a, dim3 grid, cudaStream_t st) {
  switch (act) {
    case kGelu: return launch_act<T, W, VEC, kGelu>(kind, a, grid, st);
    case kRelu: return launch_act<T, W, VEC, kRelu>(kind, a, grid, st);
    case kSilu: return launch_act<T, W, VEC, kSilu>(kind, a, grid, st);
    case kIdentity: return launch_act<T, W, VEC, kIdentity>(kind, a, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// The launch's shape: columns a thread (8 or 4), whole-word accesses or
// not, threads per row, grid. `addr` is the OR of the operands' addresses
// (only its low 4 bits are read).
struct Plan {
  int cols, vec, tpr, grid_x, grid_y;
};

Plan plan(int kind, int act, long long n, int d, int dtype, unsigned long long addr,
          int sms) {
  const int esize = dtype == kBF16 ? 2 : 4;
  Plan p;
  p.cols = dtype == kBF16 && d % 8 == 0 && addr % 16 == 0 ? 8 : 4;
  p.vec = p.cols == 8 || (d % 4 == 0 && addr % (4 * esize) == 0);
  // threads per row: a power of two up to kThreads, 4 columns a thread: the
  // fewest that cover the row; 8 columns a thread: of the powers of two from
  // 32 to that one, the one that leaves the fewest idle threads in the
  // row's tiles (the largest of equals)
  const int chunks = (d + p.cols - 1) / p.cols;
  int tpr = 1;
  while (tpr < kThreads && tpr < chunks) tpr *= 2;
  if (p.cols == 8) {
    auto idle = [chunks](int t) { return (chunks + t - 1) / t * t - chunks; };
    for (int t = tpr / 2; t >= 32; t /= 2)
      if (idle(t) < idle(tpr)) tpr = t;
  }
  p.tpr = tpr;
  p.grid_x = (d + p.cols * tpr - 1) / (p.cols * tpr);
  const long long groups = (n + kThreads / tpr - 1) / (kThreads / tpr);
  long long gy = (long long)sms * blocks_per_sm(kind, act) / p.grid_x;
  gy = gy < 1 ? 1 : gy;
  gy = gy < groups ? gy : groups;
  gy = gy < 65535 ? gy : 65535;
  p.grid_y = (int)(gy < 1 ? 1 : gy);
  return p;
}

unsigned long long addr_bits(const void* x, const void* g, const void* out) {
  return (unsigned long long)(uintptr_t)x | (unsigned long long)(uintptr_t)g |
         (unsigned long long)(uintptr_t)out;
}

}  // namespace

// The plan of a launch of `kind` with activation `act` over [n, d] of
// `dtype` whose operands' addresses OR to `addr`, on a card of `sms` SMs,
// as {cols, vec, tpr, grid_x, grid_y} in out[5] (what
// ops/fused_bias_act.py's launch_plan mirrors). Returns 0, or
// cudaErrorInvalidValue for arguments not taken.
extern "C" int dstt_bias_act_plan(int kind, int act, long long n, int d, int dtype,
                                  unsigned long long addr, int sms, int* out) {
  if (kind < kFwd || kind > kDropBwd || act < kGelu || act > kIdentity || n <= 0 ||
      d <= 0 || sms <= 0 || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(kind, act, n, d, dtype, addr, sms);
  out[0] = p.cols;
  out[1] = p.vec;
  out[2] = p.tpr;
  out[3] = p.grid_x;
  out[4] = p.grid_y;
  return 0;
}

// One entry for the four kernels. kind: 0 bias_act, 1 bias_act_bwd, 2
// bias_act_dropout, 3 bias_act_dropout_bwd. x, g, out [n, d] row-major in
// `dtype` (0 float32, 1 bfloat16); bias [d] fp32; db_parts [grid_y, d] fp32
// (backward). act: 0 gelu, 1 relu, 2 silu, 3 identity. thr, scale and seed:
// the dropout's keep threshold, scale and key. The launch follows `plan`
// for a card of `sms` SMs; `grid_y` is the caller's copy of the plan's grid
// rows (the rows of db_parts it allocated), and a launch whose plan differs
// is refused. Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue for arguments not taken.
extern "C" int dstt_bias_act(int kind, const void* x, const float* bias,
                             const void* g, void* out, float* db_parts,
                             long long n, int d, int dtype, int act,
                             unsigned int thr, float scale, unsigned int seed,
                             int sms, int grid_y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind < kFwd || kind > kDropBwd || n <= 0 || d <= 0 || sms <= 0 ||
      act < kGelu || act > kIdentity || (dtype != kF32 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(kind, act, n, d, dtype, addr_bits(x, g, out), sms);
  if (p.grid_y != grid_y) return (int)cudaErrorInvalidValue;
  Args a{x, bias, g, out, db_parts, (int64_t)n, d, p.tpr, thr, scale, {}};
  for (int i = 0; i < kRounds; ++i) a.key[i] = seed + (uint32_t)i * 0x9E3779B9u;
  const dim3 grid((unsigned)p.grid_x, (unsigned)p.grid_y);
  if (dtype == kF32)
    return (int)(p.vec ? launch<float, 4, true>(kind, act, a, grid, st)
                       : launch<float, 4, false>(kind, act, a, grid, st));
  if (p.cols == 8) return (int)launch<__nv_bfloat16, 8, true>(kind, act, a, grid, st);
  return (int)(p.vec ? launch<__nv_bfloat16, 4, true>(kind, act, a, grid, st)
                     : launch<__nv_bfloat16, 4, false>(kind, act, a, grid, st));
}
