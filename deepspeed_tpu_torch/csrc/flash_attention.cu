// Flash attention for training, for Hopper (sm_90a): the forward with its
// per-row logsumexp, and the two backward kernels (dQ, and dK/dV).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   forward <- `_flash_kernel` (wrapper `_pallas_flash_fwd_impl`)
//   dQ      <- `_dq_kernel`    (wrapper `_pallas_flash_bwd_impl`)
//   dK/dV   <- `_dkv_kernel`   (wrapper `_pallas_flash_bwd_impl`)
//
// Function (the TPU kernels' whole contract): q [B,Sq,H,d], k/v [B,Sk,Hkv,d];
// query head h reads KV head h / rep. Row qpos sees key kpos when
//   kpos < Sk,
//   and, causal (a window implies it): qpos >= kpos + causal_shift,
//   and, with a window W: kpos > qpos - W,
//   and, with segment ids: q_seg[b, qpos] == k_seg[b, kpos].
// The causal mask is aligned at row 0 (no Sk - Sq offset), as the TPU
// kernels' `_masked_scores` is. Rounding points are the TPU kernels':
// scores are fp32 dots scaled after the dot; the forward rounds p to v's
// dtype before P.V, divides by max(l, 1e-30) and emits lse = m +
// log(max(l, 1e-30)); the backward takes delta = rowsum(dO.O) (fp32, from
// the wrapper), rounds dS to k's/q's dtype before dS.K and dS^T.Q and p to
// dO's dtype before P^T.dO. Rows with nothing live give out 0 and lse
// about -1e30, and contribute exactly 0 to every gradient (p is 0 there,
// never exp() of a masked score).
//
// Six kernels; the launcher (`run`) picks by dtype, and a failure raises:
//   bf16 forward  flash_fwd_kernel_wgmma   tensor cores (wgmma) fed by TMA
//   bf16 dQ       flash_dq_kernel_wgmma    tensor cores (wgmma) fed by TMA
//   bf16 dK/dV    flash_dkv_kernel_wgmma   tensor cores (wgmma) fed by TMA
//   fp32 forward  flash_fwd_kernel         fp32 CUDA cores
//   fp32 dQ       flash_dq_kernel          fp32 CUDA cores
//   fp32 dK/dV    flash_dkv_kernel         fp32 CUDA cores
//
// What bounds them: at the training shape (B=1, S=2048, H=32, Hkv=8, d=128,
// causal) the work is arithmetic (34 GFLOP forward, 52 dQ, 69 dK/dV, against
// 42-59 MB of operands each), so the bound is the tensor cores' bf16 rate.
//
// The bf16 kernels (one design, shared device helpers below):
//   * Warp specialisation. A block is two consumer warpgroups and one
//     producer warpgroup (384 threads). One thread of the producer keeps a
//     ring of 2 stages of tiles in shared memory filled with TMA
//     (`cp.async.bulk.tensor.4d` over the [d, heads, S, B] view of each
//     tensor, so positions past S load as zeros and never from the next
//     batch) and signals each with an mbarrier; consumers release a stage
//     on a second mbarrier. `setmaxnreg` moves registers from the producer
//     (40) to the consumers (232).
//   * Tiles are [rows][64] bf16 "atoms" of 128-byte rows in TMA's 128-byte
//     swizzle (d = 128 is two atoms), which is the layout a wgmma shared-
//     memory descriptor reads: K-major with a stride of 1024 bytes between
//     8-row groups, or MN-major (the transpose bit) with the next atom at
//     LBO. So V, Q and dO serve as B operands of P.V, dS^T.Q and P^T.dO
//     where they lie, nothing is transposed in memory.
//   * An fp32 score accumulator of m64nNk16 is, as bf16 pairs, the register
//     A operand of the next product (rows r, r+8 and columns 2c, 2c+1 of
//     each 8-column group, per thread): p and dS are rounded to bf16 in
//     registers and fed back without shared memory. That rounding is the
//     reference's rounding point.
//   * Forward: 128 query rows per block (64 per consumer warpgroup), 64-key
//     tiles. S = Q.K^T is wgmma from shared memory; the online softmax runs
//     in registers (the row max and sum reduce over the 4 threads that share
//     a row); O += P.V is wgmma with P from registers. The row sum l is
//     summed per thread and reduced once at the end.
//   * dQ: the forward's block (128 query rows, 64 per consumer warpgroup)
//     and its ring of 64-key tiles, now of (K, V); the producer also loads
//     the block's dO beside Q, once. S = Q.K^T and dP = dO.V^T from shared
//     memory (Q and dO the A operands, K and V K-major B); lse and delta
//     belong to the accumulator's rows, so each thread loads its two rows'
//     values into registers once; dS is rounded in registers and is the A
//     operand of dQ += dS.K, with K read MN-major from the stage that fed
//     S. Each block owns its rows: no atomics, and dQ repeats bit for bit.
//   * dK/dV: 64 keys per block; the two consumer warpgroups take the same
//     keys and alternate over the `rep` query heads of the KV head (heads
//     0, 2, .. and 1, 3, ..). Per 64-row query tile: S^T = K.Q^T and dP^T =
//     V.dO^T from shared memory (Q and dO K-major), P^T and dS^T rounded in
//     registers, dV += P^T.dO and dK += dS^T.Q (dO and Q MN-major). lse and
//     delta are per query, the accumulator's column: each warpgroup stages
//     them in shared memory per tile and reads them by column. At the end
//     the second warpgroup hands its fp32 dK/dV to the first through shared
//     memory and the first adds them: a fixed order, no atomics, so a second
//     backward repeats dK and dV bit for bit. 64-key blocks (256 at the
//     training shape) rather than 128 keep the causal imbalance low enough
//     for 132 SMs without splitting the group into partials.
//   * Only tiles that cross the causal diagonal, the window's lower edge, or
//     the end of Sq/Sk, and every tile with segment ids, evaluate the
//     per-element mask; interior tiles skip it, and tiles with no live pair
//     for a warpgroup skip the products. The grid starts the heaviest tiles
//     first: under causal the last query tiles (forward) and the first key
//     tiles (dK/dV).
//   * d in {64, 128}. The tensor maps are encoded on the host per launch
//     (`cuTensorMapEncodeTiled`, reached through `cudaGetDriverEntryPoint`,
//     so the library needs no -lcuda) and passed as __grid_constant__.
//
// Why fp32 stays on the CUDA cores: wgmma takes fp32 operands only as TF32
// (10 mantissa bits, about 3 decimal digits), which would miss the fp32
// tolerance of 1e-4 of a row's largest value. So fp32 tensors take the
// first design: tiles in shared memory as fp32 with a padded row stride,
// fmaf micro-tiles per thread, the TPU grid's sequential key axis a loop
// inside the block, dead tiles never loaded.

#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF
constexpr int kFwdRows = 32, kFwdKeys = 64;     // forward and dQ tiles
constexpr int kDkvKeys = 32, kDkvRows = 32;     // dK/dV tiles

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round a float through the working dtype (the reference's `.astype(...)`).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;       // [B, H, Sq] (backward input)
  const float* delta;     // [B, H, Sq] (backward input)
  const int* qseg;        // [B, Sq] or null
  const int* kseg;        // [B, Sk] or null
  void* out;              // forward: o [B, Sq, H, d]; dQ: dq
  float* lse_out;         // forward: [B, H, Sq]
  void* dk;
  void* dv;
  int B, Sq, Sk, H, Hkv, causal, window, shift;
  float scale;
};

__device__ __forceinline__ bool is_live(const Params& p, int b, int qpos, int kpos) {
  if (kpos >= p.Sk || qpos >= p.Sq) return false;
  if (p.causal && qpos < kpos + p.shift) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  if (p.qseg != nullptr &&
      p.qseg[(size_t)b * p.Sq + qpos] != p.kseg[(size_t)b * p.Sk + kpos])
    return false;
  return true;
}

// Copy `rows` rows of one head, starting at sequence position `pos0`, from
// x [B, S, heads, D] into dst [rows][D + 1] as fp32; rows past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, float* dst,
                                          int rows, int pos0, int S, int heads,
                                          int b, int head) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int e = threadIdx.x; e < rows * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * VEC;
    const int pos = pos0 + r;
    float* d = dst + r * (D + 1) + c;
    if (pos < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          x + ((size_t)(b * S + pos) * heads + head) * D + c);
      const T* xs = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = to_float(xs[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = 0.f;
    }
  }
}

// Live key tiles [*lo, *hi] of a query tile spanning rows [q0, q1].
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int q1, int keys,
                                          int* lo, int* hi) {
  int k_lo = 0, k_hi = p.Sk - 1;
  if (p.causal) k_hi = min(k_hi, q1 - p.shift);
  if (p.window > 0) k_lo = max(k_lo, q0 - p.window + 1);
  if (k_hi < k_lo || k_hi < 0) { *lo = 0; *hi = -1; return; }
  *lo = k_lo / keys;
  *hi = k_hi / keys;
}

template <int D>
constexpr int fwd_smem_floats() {
  return kFwdRows * (D + 1) + 2 * kFwdKeys * (D + 1) + kFwdRows * kFwdKeys + 3 * kFwdRows;
}
template <int D>
constexpr int dq_smem_floats() {
  return 2 * kFwdRows * (D + 1) + 2 * kFwdKeys * (D + 1) + kFwdRows * kFwdKeys + 2 * kFwdRows;
}
template <int D>
constexpr int dkv_smem_floats() {
  return 2 * kDkvKeys * (D + 1) + 2 * kDkvRows * (D + 1) + 2 * kDkvKeys * kDkvRows + 2 * kDkvRows;
}

// ---------------------------------------------------------------------------
// fp32 forward on the CUDA cores: out and lse
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int DP = D + 1, R = kFwdRows, K = kFwdKeys;
  constexpr int SR = R / 8, SC = K / 16;       // score micro-tile per thread
  constexpr int PR = R / 4, PC = D / 32;       // accumulator micro-tile
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * R;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  extern __shared__ float smem[];
  float* qs = smem;                      // [R][DP]
  float* ks = qs + R * DP;               // [K][DP]
  float* vs = ks + K * DP;               // [K][DP]
  float* ps = vs + K * DP;               // [R][K]
  float* m_s = ps + R * K;               // [R]
  float* l_s = m_s + R;                  // [R]
  float* alpha_s = l_s + R;              // [R]

  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  load_rows<T, D>(q, qs, R, q0, p.Sq, p.H, b, h);

  int tile_lo, tile_hi;
  key_tiles(p, q0, min(q0 + R, p.Sq) - 1, K, &tile_lo, &tile_hi);

  float acc[PR][PC];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int kt = tile_lo; kt <= tile_hi; ++kt) {
    const int k0 = kt * K;
    load_rows<T, D>(k, ks, K, k0, p.Sk, p.Hkv, b, kvh);
    load_rows<T, D>(v, vs, K, k0, p.Sk, p.Hkv, b, kvh);
    __syncthreads();

    // scores: fp32 dot, then the scale; -inf where dead (exp() of it is 0)
    {
      const int tx = tid % 16, ty = tid / 16;
      float s[SR][SC];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float qv[SR], kv[SC];
#pragma unroll
        for (int i = 0; i < SR; ++i) qv[i] = qs[(ty + 8 * i) * DP + c];
#pragma unroll
        for (int j = 0; j < SC; ++j) kv[j] = ks[(tx + 16 * j) * DP + c];
#pragma unroll
        for (int i = 0; i < SR; ++i)
#pragma unroll
          for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = ty + 8 * i;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int kr = tx + 16 * j;
          ps[r * K + kr] = is_live(p, b, q0 + r, k0 + kr)
                               ? s[i][j] * p.scale
                               : __int_as_float(0xff800000);   // -inf
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row; p is rounded to v's dtype for P.V,
    // l sums the unrounded p (as the reference does)
    for (int r = warp; r < R; r += kThreads / 32) {
      const float a = ps[r * K + lane];
      const float c = ps[r * K + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * K + lane] = round_to<T>(pa);
      ps[r * K + lane + 32] = round_to<T>(pc);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      const float alpha = alpha_s[warp + 4 * i];
#pragma unroll
      for (int j = 0; j < PC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kr = 0; kr < K; ++kr) {
      float vv[PC];
#pragma unroll
      for (int j = 0; j < PC; ++j) vv[j] = vs[kr * DP + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const float pv = ps[(warp + 4 * i) * K + kr];
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
      }
    }
    __syncthreads();   // the next tile overwrites ks, vs and ps
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int r = warp + 4 * i;
    const int qpos = q0 + r;
    if (qpos >= p.Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* dst = out + ((size_t)(b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < PC; ++j) dst[lane + 32 * j] = from_float<T>(acc[i][j] / l);
    if (lane == 0) p.lse_out[(size_t)bh * p.Sq + qpos] = m_s[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// fp32 dQ on the CUDA cores: dq = sum over live key tiles of round(dS) . K
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  constexpr int DP = D + 1, R = kFwdRows, K = kFwdKeys;
  constexpr int SR = R / 8, SC = K / 16;
  constexpr int PR = R / 4, PC = D / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.Hkv);
  const int q0 = blockIdx.x * R;

  extern __shared__ float smem[];
  float* qs = smem;                      // [R][DP]
  float* dos = qs + R * DP;              // [R][DP]
  float* ks = dos + R * DP;              // [K][DP]
  float* vs = ks + K * DP;               // [K][DP]
  float* ds_s = vs + K * DP;             // [R][K]
  float* lse_s = ds_s + R * K;           // [R]
  float* delta_s = lse_s + R;            // [R]

  load_rows<T, D>(static_cast<const T*>(p.q), qs, R, q0, p.Sq, p.H, b, h);
  load_rows<T, D>(static_cast<const T*>(p.dout), dos, R, q0, p.Sq, p.H, b, h);
  for (int r = tid; r < R; r += kThreads) {
    const bool in = q0 + r < p.Sq;
    lse_s[r] = in ? p.lse[(size_t)bh * p.Sq + q0 + r] : 0.f;
    delta_s[r] = in ? p.delta[(size_t)bh * p.Sq + q0 + r] : 0.f;
  }

  int tile_lo, tile_hi;
  key_tiles(p, q0, min(q0 + R, p.Sq) - 1, K, &tile_lo, &tile_hi);

  float acc[PR][PC];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int kt = tile_lo; kt <= tile_hi; ++kt) {
    const int k0 = kt * K;
    load_rows<T, D>(static_cast<const T*>(p.k), ks, K, k0, p.Sk, p.Hkv, b, kvh);
    load_rows<T, D>(static_cast<const T*>(p.v), vs, K, k0, p.Sk, p.Hkv, b, kvh);
    __syncthreads();

    {
      const int tx = tid % 16, ty = tid / 16;
      float s[SR][SC], dp[SR][SC];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < D; ++c) {
        float qv[SR], dov[SR], kv[SC], vv[SC];
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          qv[i] = qs[(ty + 8 * i) * DP + c];
          dov[i] = dos[(ty + 8 * i) * DP + c];
        }
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          kv[j] = ks[(tx + 16 * j) * DP + c];
          vv[j] = vs[(tx + 16 * j) * DP + c];
        }
#pragma unroll
        for (int i = 0; i < SR; ++i)
#pragma unroll
          for (int j = 0; j < SC; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = ty + 8 * i;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int kr = tx + 16 * j;
          float ds = 0.f;
          if (is_live(p, b, q0 + r, k0 + kr)) {
            const float pr = expf(s[i][j] * p.scale - lse_s[r]);
            ds = pr * (dp[i][j] - delta_s[r]) * p.scale;
          }
          ds_s[r * K + kr] = round_to<T>(ds);      // ds.astype(k.dtype)
        }
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kr = 0; kr < K; ++kr) {
      float kv[PC];
#pragma unroll
      for (int j = 0; j < PC; ++j) kv[j] = ks[kr * DP + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const float d = ds_s[(warp + 4 * i) * K + kr];
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(d, kv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* dq = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int qpos = q0 + warp + 4 * i;
    if (qpos >= p.Sq) continue;
    T* dst = dq + ((size_t)(b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < PC; ++j) dst[lane + 32 * j] = from_float<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// fp32 dK, dV on the CUDA cores: one block per (key tile, batch x KV head),
// looping over the group members and their live query tiles
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Params p) {
  constexpr int DP = D + 1, K = kDkvKeys, R = kDkvRows;
  constexpr int SK = K / 8, SQ = R / 16;       // (key, query) micro-tile
  constexpr int PK = K / 4, PC = D / 32;       // accumulator micro-tile
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bkv = blockIdx.y, b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int rep = p.H / p.Hkv;
  const int k0 = blockIdx.x * K;
  const int k1 = min(k0 + K, p.Sk) - 1;

  extern __shared__ float smem[];
  float* ks = smem;                      // [K][DP]
  float* vs = ks + K * DP;               // [K][DP]
  float* qs = vs + K * DP;               // [R][DP]
  float* dos = qs + R * DP;              // [R][DP]
  float* pT = dos + R * DP;              // [K][R]
  float* dsT = pT + K * R;               // [K][R]
  float* lse_s = dsT + K * R;            // [R]
  float* delta_s = lse_s + R;            // [R]

  load_rows<T, D>(static_cast<const T*>(p.k), ks, K, k0, p.Sk, p.Hkv, b, kvh);
  load_rows<T, D>(static_cast<const T*>(p.v), vs, K, k0, p.Sk, p.Hkv, b, kvh);

  // live query range of this key tile
  int q_lo = 0, q_hi = p.Sq - 1;
  if (p.causal) q_lo = max(q_lo, k0 + p.shift);
  if (p.window > 0) q_hi = min(q_hi, k1 + p.window - 1);
  const int qt_lo = q_lo / R, qt_hi = q_lo <= q_hi ? q_hi / R : -1;

  float dk[PK][PC], dv[PK][PC];
#pragma unroll
  for (int i = 0; i < PK; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int g = 0; g < rep; ++g) {
    const int h = kvh * rep + g;
    const size_t row0 = (size_t)(b * p.H + h) * p.Sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * R;
      __syncthreads();   // the previous step's readers are done with qs/dos/pT/dsT
      load_rows<T, D>(static_cast<const T*>(p.q), qs, R, q0, p.Sq, p.H, b, h);
      load_rows<T, D>(static_cast<const T*>(p.dout), dos, R, q0, p.Sq, p.H, b, h);
      for (int r = tid; r < R; r += kThreads) {
        const bool in = q0 + r < p.Sq;
        lse_s[r] = in ? p.lse[row0 + q0 + r] : 0.f;
        delta_s[r] = in ? p.delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();

      {
        const int tx = tid % 16, ty = tid / 16;  // tx: query cols, ty: key rows
        float s[SK][SQ], dp[SK][SQ];
#pragma unroll
        for (int i = 0; i < SK; ++i)
#pragma unroll
          for (int j = 0; j < SQ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
        for (int c = 0; c < D; ++c) {
          float kv[SK], vv[SK], qv[SQ], dov[SQ];
#pragma unroll
          for (int i = 0; i < SK; ++i) {
            kv[i] = ks[(ty + 8 * i) * DP + c];
            vv[i] = vs[(ty + 8 * i) * DP + c];
          }
#pragma unroll
          for (int j = 0; j < SQ; ++j) {
            qv[j] = qs[(tx + 16 * j) * DP + c];
            dov[j] = dos[(tx + 16 * j) * DP + c];
          }
#pragma unroll
          for (int i = 0; i < SK; ++i)
#pragma unroll
            for (int j = 0; j < SQ; ++j) {
              s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
              dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < SK; ++i) {
          const int kr = ty + 8 * i;
#pragma unroll
          for (int j = 0; j < SQ; ++j) {
            const int qr = tx + 16 * j;
            float pr = 0.f, ds = 0.f;
            if (is_live(p, b, q0 + qr, k0 + kr)) {
              pr = expf(s[i][j] * p.scale - lse_s[qr]);
              ds = pr * (dp[i][j] - delta_s[qr]) * p.scale;
            }
            pT[kr * R + qr] = round_to<T>(pr);     // p.astype(dO.dtype)
            dsT[kr * R + qr] = round_to<T>(ds);    // ds.astype(q.dtype)
          }
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qr = 0; qr < R; ++qr) {
        float qv[PC], dov[PC];
#pragma unroll
        for (int j = 0; j < PC; ++j) {
          qv[j] = qs[qr * DP + lane + 32 * j];
          dov[j] = dos[qr * DP + lane + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < PK; ++i) {
          const int kr = warp + 4 * i;
          const float pv = pT[kr * R + qr], dsv = dsT[kr * R + qr];
#pragma unroll
          for (int j = 0; j < PC; ++j) {
            dv[i][j] = fmaf(pv, dov[j], dv[i][j]);
            dk[i][j] = fmaf(dsv, qv[j], dk[i][j]);
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < PK; ++i) {
    const int kpos = k0 + warp + 4 * i;
    if (kpos >= p.Sk) continue;
    const size_t off = ((size_t)(b * p.Sk + kpos) * p.Hkv + kvh) * D;
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      dk_out[off + lane + 32 * j] = from_float<T>(dk[i][j]);
      dv_out[off + lane + 32 * j] = from_float<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper helpers: mbarriers, TMA, wgmma descriptors and products
// ---------------------------------------------------------------------------
constexpr int kWg = 128;               // threads of a warpgroup
constexpr int kAtom = 64;              // bf16 columns of one 128-byte swizzle atom
constexpr int kAtomRow = 128;          // bytes of an atom's row
constexpr int kConsumers = 2;          // consumer warpgroups per block
constexpr int kHopperThreads = (kConsumers + 1) * kWg;
constexpr int kStages = 2;             // TMA ring depth
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

// Arrive once and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One TMA tile: box (64 columns of d, 1 head, rows, 1 batch) at (c0, head,
// pos, b) of the [d, heads, S, B] map, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int head,
                                         int pos, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(head), "r"(pos), "r"(b) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand at `p`
// (inside an atom whose base is 1024-byte aligned). K-major: sbo = 1024
// (the next 8 rows), lbo unused. MN-major: lbo = the next 64-column atom,
// sbo = 1024 (the next 8 rows along K).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;                     // 128-byte swizzle
  return d;
}

// Descriptor of k-step kk (16 columns of d) of a K-major [rows][d] tile
// stored as d/64 atoms of `rows` 128-byte rows.
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int rows,
                                                int kk) {
  return smem_desc(tile + (kk / 4) * rows * kAtomRow + (kk % 4) * 32, 16, 1024);
}

// Descriptor of k-step kk (16 rows) of a [rows][d] tile read MN-major
// (N = d).
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int rows,
                                                 int kk) {
  return smem_desc(tile + kk * 16 * kAtomRow, rows * kAtomRow, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator of a 64-column product as the A operands of the four
// k-steps of the next product (bf16, round to nearest even).
__device__ __forceinline__ void to_a_operands(const float (&s)[32],
                                              uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A in registers (the accumulator
// fragment of an m64nXk16 product, as bf16 pairs), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]: A in registers (the accumulator
// fragment of an m64nXk16 product, as bf16 pairs), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// P.V / dS^T.Q / P^T.dO: 64 x D += (64 x 16 in registers) . (16 x D).
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, db, 1);
  else wgmma_rs_n128(d, a, db, 1);
}

// Accumulator fragment of an m64nNk16 product for thread t of a warpgroup:
// register 4j + 2i + c holds row 16 (t / 32) + (t % 32) / 4 + 8i and column
// 8j + 2 (t % 4) + c.
__device__ __forceinline__ int frag_row(int t, int i) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * i;
}
__device__ __forceinline__ int frag_col(int t, int j, int c) {
  return 8 * j + 2 * (t % 4) + c;
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }
constexpr int kFwdBlockRows = kConsumers * 64;   // forward: 128 query rows a block
constexpr int kTileKeys = 64;                    // forward: keys a tile; dK/dV: keys a block
constexpr int kTileRows = 64;                    // dK/dV: query rows a tile

// ---------------------------------------------------------------------------
// pieces shared by the forward and dQ kernels: 128 query rows a block over a
// ring of 64-key (K, V) tiles
// ---------------------------------------------------------------------------
// The block's query tile, heaviest first (under causal the last query tile
// of every head leads), and the key tiles it visits.
struct QTile {
  int b, h, kvh, bh, q0, tile_lo, n_tiles;
};

__device__ __forceinline__ QTile q_tile(const Params& p) {
  const int heads = p.B * p.H;
  const int n_qt = (p.Sq + kFwdBlockRows - 1) / kFwdBlockRows;
  const int rank = blockIdx.x / heads, bh = blockIdx.x % heads;
  const int qt = p.causal ? n_qt - 1 - rank : rank;
  QTile r;
  r.bh = bh;
  r.b = bh / p.H;
  r.h = bh % p.H;
  r.kvh = r.h / (p.H / p.Hkv);
  r.q0 = qt * kFwdBlockRows;
  int tile_hi;
  key_tiles(p, r.q0, min(r.q0 + kFwdBlockRows, p.Sq) - 1, kTileKeys, &r.tile_lo, &tile_hi);
  r.n_tiles = tile_hi - r.tile_lo + 1;
  return r;
}

// No live pair between the 64 query rows from row0 and the key tile at k0.
__device__ __forceinline__ bool tile_dead(const Params& p, int row0, int k0) {
  return row0 >= p.Sq || (p.causal && k0 > row0 + 63 - p.shift) ||
         (p.window > 0 && k0 + kTileKeys - 1 <= row0 - p.window);
}

// Some pair of that tile is masked: only such edge tiles evaluate the mask
// per element.
__device__ __forceinline__ bool tile_masked(const Params& p, int row0, int k0) {
  return p.qseg != nullptr || k0 + kTileKeys > p.Sk ||
         (p.causal && k0 + kTileKeys - 1 > row0 - p.shift) ||
         (p.window > 0 && k0 <= row0 + 63 - p.window);
}

// One thread sets up the barriers: once_full for the once-loaded tiles, and
// full / empty per ring stage (empty is released by every consumer thread).
__device__ __forceinline__ void init_ring(uint64_t* once_full, uint64_t* kv_full,
                                          uint64_t* kv_empty) {
  if (threadIdx.x == 0) {
    mbar_init(once_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], kConsumers * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer (one thread): the block's N once-read [128][D] query-side
// tiles (Q; Q and dO) from maps[n] into once[n], then the (K, V) ring of
// 64-key tiles kept full.
template <int D, int N>
__device__ __forceinline__ void produce(const CUtensorMap* const (&maps)[N],
                                        uint8_t* const (&once)[N], uint64_t* once_full,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        uint8_t* ks, uint8_t* vs, uint64_t* kv_full,
                                        uint64_t* kv_empty, const QTile& qt) {
  constexpr int kAtoms = D / kAtom;
  constexpr int kQ = kFwdBlockRows * D * 2, kKV = kTileKeys * D * 2;
  mbar_expect_tx(once_full, N * kQ);
  for (int a = 0; a < kAtoms; ++a)
    for (int n = 0; n < N; ++n)
      tma_load(once[n] + a * kFwdBlockRows * kAtomRow, maps[n], once_full, a * kAtom,
               qt.h, qt.q0, qt.b);
  for (int i = 0; i < qt.n_tiles; ++i) {
    const int s = i % kStages;
    const int k0 = (qt.tile_lo + i) * kTileKeys;
    if (i >= kStages) mbar_wait(&kv_empty[s], (i / kStages - 1) & 1);
    mbar_expect_tx(&kv_full[s], 2 * kKV);
    for (int a = 0; a < kAtoms; ++a) {
      const int off = s * kKV + a * kTileKeys * kAtomRow;
      tma_load(ks + off, kmap, &kv_full[s], a * kAtom, qt.kvh, k0, qt.b);
      tma_load(vs + off, vmap, &kv_full[s], a * kAtom, qt.kvh, k0, qt.b);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores: out and lse
// ---------------------------------------------------------------------------
template <int D>
struct FwdSmem {
  static constexpr int kQ = kFwdBlockRows * D * 2;   // D/64 atoms of [128][64]
  static constexpr int kKV = kTileKeys * D * 2;      // one K or V tile
  static constexpr int kBytes = 1024 + kQ + 2 * kStages * kKV + 64;
};

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, Params p) {
  using S = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* ks = qs + S::kQ;                      // stage s at + s * S::kKV
  uint8_t* vs = ks + kStages * S::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * S::kKV);
  uint64_t* kv_full = q_full + 1;                // [kStages]
  uint64_t* kv_empty = kv_full + kStages;        // [kStages]

  const QTile qt = q_tile(p);
  const int b = qt.b, h = qt.h, bh = qt.bh, q0 = qt.q0;
  const int tile_lo = qt.tile_lo, n_tiles = qt.n_tiles;

  const int wg = threadIdx.x / kWg, t = threadIdx.x % kWg;
  init_ring(q_full, kv_full, kv_empty);

  if (wg == kConsumers) {
    // producer: one thread loads Q once and keeps the K/V ring full
    reg_dealloc<kProducerRegs>();
    if (t == 0) {
      const CUtensorMap* maps[1] = {&qmap};
      uint8_t* const once[1] = {qs};
      produce<D>(maps, once, q_full, &kmap, &vmap, ks, vs, kv_full, kv_empty, qt);
    }
  } else {
    // consumers: warpgroup wg owns query rows [row0, row0 + 64)
    reg_alloc<kConsumerRegs>();
    const int row0 = q0 + wg * 64;
    const int row_a = row0 + frag_row(t, 0);     // the thread's rows: row_a, row_a + 8
    const uint8_t* qw = qs + wg * 64 * kAtomRow;
    float o[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) o[r] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (tile_lo + i) * kTileKeys;
      mbar_wait(&kv_full[s], (i / kStages) & 1);
      if (!tile_dead(p, row0, k0)) {
        const uint8_t* kt = ks + s * S::kKV;
        const uint8_t* vt = vs + s * S::kKV;
        float sc[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) sc[r] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, kmajor_desc(qw, kFwdBlockRows, kk),
                       kmajor_desc(kt, kTileKeys, kk), 1);
        wg_commit();
        wg_wait_all();
        reg_fence(sc);

        const bool masked = tile_masked(p, row0, k0);
        float alpha[2];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          float mx = minus_inf();
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int r = 4 * j + 2 * ii + c;
              float x = sc[r] * p.scale;
              if (masked && !is_live(p, b, row_a + 8 * ii, k0 + frag_col(t, j, c)))
                x = minus_inf();                         // exp() of it is 0
              sc[r] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[ii], mx);
          alpha[ii] = expf(m[ii] - m_new);
          m[ii] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int r = 4 * j + 2 * ii + c;
              sc[r] = expf(sc[r] - m_new);
              sum += sc[r];
            }
          // l sums the unrounded p of this thread's columns; the four
          // threads of a row add theirs at the end
          l[ii] = l[ii] * alpha[ii] + sum;
        }
#pragma unroll
        for (int r = 0; r < D / 2; ++r) o[r] *= alpha[(r / 2) % 2];
        uint32_t pa[4][4];                               // p rounded to v's dtype
        to_a_operands(sc, pa);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kTileKeys / 16; ++kk)
          wgmma_rs<D>(o, pa[kk], mnmajor_desc(vt, kTileKeys, kk));
        wg_commit();
        wg_wait_all();
        reg_fence(o);
      }
      mbar_arrive(&kv_empty[s]);
    }

    bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      float lsum = l[ii];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const float lf = fmaxf(lsum, 1e-30f);
      const int qpos = row_a + 8 * ii;
      if (qpos >= p.Sq) continue;
      bf16* dst = out + ((size_t)(b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int r = 4 * j + 2 * ii;
        *reinterpret_cast<__nv_bfloat162*>(dst + frag_col(t, j, 0)) =
            __floats2bfloat162_rn(o[r] / lf, o[r + 1] / lf);
      }
      if (t % 4 == 0) p.lse_out[(size_t)bh * p.Sq + qpos] = m[ii] + logf(lf);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK, dV on the tensor cores: one block per (64-key tile, batch x KV
// head); warpgroup w takes query heads w, w + 2, .. of the group
// ---------------------------------------------------------------------------
template <int D>
struct DkvSmem {
  static constexpr int kTile = 64 * D * 2;               // one [64][D] bf16 tile
  static constexpr int kRing = kStages * 2 * kTile;      // a warpgroup's (Q, dO) stages
  static constexpr int kRowFloats = kConsumers * kStages * 2 * kTileRows;  // lse, delta
  static constexpr int kBytes = 1024 + 2 * kTile + kConsumers * kRing +
                                kRowFloats * 4 + 128;
  static_assert(kRing >= 2 * kTileKeys * D * 4, "the fold reuses a warpgroup's ring");
};

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap, Params p) {
  using S = DkvSmem<D>;
  constexpr int kAtoms = D / kAtom;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + S::kTile;
  uint8_t* ring = vs + S::kTile;                 // warpgroup w, stage s: Q, then dO
  float* rows_s = reinterpret_cast<float*>(ring + kConsumers * S::kRing);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s + S::kRowFloats);
  uint64_t* full = kv_full + 1;                  // [w * kStages + s]
  uint64_t* empty = full + kConsumers * kStages; // [w * kStages + s]

  // key tile 0, the heaviest under causal, of every KV head leads
  const int kv_heads = p.B * p.Hkv;
  const int kt = blockIdx.x / kv_heads, bkv = blockIdx.x % kv_heads;
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int rep = p.H / p.Hkv;
  const int k0 = kt * kTileKeys, k1 = min(k0 + kTileKeys, p.Sk) - 1;
  int q_lo = 0, q_hi = p.Sq - 1;                 // live query range of these keys
  if (p.causal) q_lo = k0 + p.shift;
  if (p.window > 0) q_hi = min(q_hi, k1 + p.window - 1);
  const int qt_lo = q_lo / kTileRows;
  const int n_qt = q_lo <= q_hi ? q_hi / kTileRows - qt_lo + 1 : 0;

  const int wg = threadIdx.x / kWg, t = threadIdx.x % kWg;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < kConsumers * kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: lane 0 of warp w keeps consumer warpgroup w's ring full;
    // warp 0 also loads the block's K and V
    reg_dealloc<kProducerRegs>();
    const int w = t / 32;
    if (w < kConsumers && t % 32 == 0) {
      if (w == 0) {
        mbar_expect_tx(kv_full, 2 * S::kTile);
        for (int a = 0; a < kAtoms; ++a) {
          tma_load(ks + a * kTileKeys * kAtomRow, &kmap, kv_full, a * kAtom, kvh, k0, b);
          tma_load(vs + a * kTileKeys * kAtomRow, &vmap, kv_full, a * kAtom, kvh, k0, b);
        }
      }
      const int steps = (rep - w + kConsumers - 1) / kConsumers * n_qt;
      uint8_t* my_ring = ring + w * S::kRing;
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        const int h = kvh * rep + w + kConsumers * (i / n_qt);
        const int q0 = (qt_lo + i % n_qt) * kTileRows;
        uint64_t* bar = &full[w * kStages + s];
        if (i >= kStages) mbar_wait(&empty[w * kStages + s], (i / kStages - 1) & 1);
        mbar_expect_tx(bar, 2 * S::kTile);
        uint8_t* stage = my_ring + s * 2 * S::kTile;
        for (int a = 0; a < kAtoms; ++a) {
          const int off = a * kTileRows * kAtomRow;
          tma_load(stage + off, &qmap, bar, a * kAtom, h, q0, b);
          tma_load(stage + S::kTile + off, &domap, bar, a * kAtom, h, q0, b);
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int key_a = k0 + frag_row(t, 0);       // the thread's keys: key_a, key_a + 8
    const int steps = (rep - wg + kConsumers - 1) / kConsumers * n_qt;
    const uint8_t* my_ring = ring + wg * S::kRing;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dk[r] = dv[r] = 0.f;
    mbar_wait(kv_full, 0);

    for (int i = 0; i < steps; ++i) {
      const int s = i % kStages;
      const int h = kvh * rep + wg + kConsumers * (i / n_qt);
      const int q0 = (qt_lo + i % n_qt) * kTileRows;
      const uint8_t* q_t = my_ring + s * 2 * S::kTile;
      const uint8_t* do_t = q_t + S::kTile;
      float* lse_t = rows_s + (wg * kStages + s) * 2 * kTileRows;
      float* delta_t = lse_t + kTileRows;
      {
        // stage the tile's lse and delta; read back by accumulator column
        const int r = t % kTileRows, qpos = q0 + r;
        const float* src = t < kTileRows ? p.lse : p.delta;
        (t < kTileRows ? lse_t : delta_t)[r] =
            qpos < p.Sq ? src[(size_t)(b * p.H + h) * p.Sq + qpos] : 0.f;
      }
      mbar_wait(&full[wg * kStages + s], (i / kStages) & 1);

      // S^T = K.Q^T and dP^T = V.dO^T, 64 keys x 64 queries
      float st[32], dpt[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) st[r] = dpt[r] = 0.f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st, kmajor_desc(ks, kTileKeys, kk), kmajor_desc(q_t, kTileRows, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, kmajor_desc(vs, kTileKeys, kk), kmajor_desc(do_t, kTileRows, kk), 1);
      wg_commit();
      named_bar_sync(1 + wg, kWg);               // lse and delta staged
      wg_wait_all();
      reg_fence(st);
      reg_fence(dpt);

      const bool masked = p.qseg != nullptr || q0 + kTileRows > p.Sq ||
                          k0 + kTileKeys > p.Sk ||
                          (p.causal && q0 < k0 + kTileKeys - 1 + p.shift) ||
                          (p.window > 0 && k0 <= q0 + kTileRows - 1 - p.window);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 4 * j + 2 * ii + c, col = frag_col(t, j, c);
            float pr = 0.f, ds = 0.f;
            if (!masked || is_live(p, b, q0 + col, key_a + 8 * ii)) {
              pr = expf(st[r] * p.scale - lse_t[col]);
              ds = pr * (dpt[r] - delta_t[col]) * p.scale;
            }
            st[r] = pr;
            dpt[r] = ds;
          }
      uint32_t pa[4][4], dsa[4][4];              // p to dO's dtype, dS to q's
      to_a_operands(st, pa);
      to_a_operands(dpt, dsa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk)
        wgmma_rs<D>(dv, pa[kk], mnmajor_desc(do_t, kTileRows, kk));
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk)
        wgmma_rs<D>(dk, dsa[kk], mnmajor_desc(q_t, kTileRows, kk));
      wg_commit();
      wg_wait_all();
      reg_fence(dk);
      reg_fence(dv);
      mbar_arrive(&empty[wg * kStages + s]);
    }

    // fold: warpgroup 1 hands its sums to warpgroup 0 through its drained
    // ring (the same fragment position in both), which adds them in that
    // order and writes
    float* fold = reinterpret_cast<float*>(ring + S::kRing);
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < D / 2; ++r) {
        fold[r * kWg + t] = dk[r];
        fold[(D / 2 + r) * kWg + t] = dv[r];
      }
    }
    named_bar_sync(1 + kConsumers, kConsumers * kWg);
    if (wg == 0) {
      bf16* dk_out = static_cast<bf16*>(p.dk);
      bf16* dv_out = static_cast<bf16*>(p.dv);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int kpos = key_a + 8 * ii;
        if (kpos >= p.Sk) continue;
        const size_t off = ((size_t)(b * p.Sk + kpos) * p.Hkv + kvh) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int r = 4 * j + 2 * ii;
          const float* fk = fold + r * kWg + t;
          const float* fv = fold + (D / 2 + r) * kWg + t;
          *reinterpret_cast<__nv_bfloat162*>(dk_out + off + frag_col(t, j, 0)) =
              __floats2bfloat162_rn(dk[r] + fk[0], dk[r + 1] + fk[kWg]);
          *reinterpret_cast<__nv_bfloat162*>(dv_out + off + frag_col(t, j, 0)) =
              __floats2bfloat162_rn(dv[r] + fv[0], dv[r + 1] + fv[kWg]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ on the tensor cores: the forward's block of 128 query rows (64 per
// consumer warpgroup) over a ring of (K, V) 64-key tiles
// ---------------------------------------------------------------------------
template <int D>
struct DqSmem {
  static constexpr int kQ = kFwdBlockRows * D * 2;   // Q or dO: D/64 atoms of [128][64]
  static constexpr int kKV = kTileKeys * D * 2;      // one K or V tile
  static constexpr int kBytes = 1024 + 2 * kQ + 2 * kStages * kKV + 64;
};

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_dq_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap, Params p) {
  using S = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);
  uint8_t* dos = qs + S::kQ;
  uint8_t* ks = dos + S::kQ;                     // stage s at + s * S::kKV
  uint8_t* vs = ks + kStages * S::kKV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * S::kKV);
  uint64_t* kv_full = q_full + 1;                // [kStages]
  uint64_t* kv_empty = kv_full + kStages;        // [kStages]

  const QTile qt = q_tile(p);
  const int b = qt.b, h = qt.h, bh = qt.bh, q0 = qt.q0;
  const int tile_lo = qt.tile_lo, n_tiles = qt.n_tiles;

  const int wg = threadIdx.x / kWg, t = threadIdx.x % kWg;
  init_ring(q_full, kv_full, kv_empty);

  if (wg == kConsumers) {
    // producer: one thread loads Q and dO once and keeps the K/V ring full
    reg_dealloc<kProducerRegs>();
    if (t == 0) {
      const CUtensorMap* maps[2] = {&qmap, &domap};
      uint8_t* const once[2] = {qs, dos};
      produce<D>(maps, once, q_full, &kmap, &vmap, ks, vs, kv_full, kv_empty, qt);
    }
  } else {
    // consumers: warpgroup wg owns query rows [row0, row0 + 64)
    reg_alloc<kConsumerRegs>();
    const int row0 = q0 + wg * 64;
    const int row_a = row0 + frag_row(t, 0);     // the thread's rows: row_a, row_a + 8
    const uint8_t* qw = qs + wg * 64 * kAtomRow;
    const uint8_t* dow = dos + wg * 64 * kAtomRow;
    float lse[2], delta[2];                      // per accumulator row
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int qpos = row_a + 8 * ii;
      const bool in = qpos < p.Sq;
      lse[ii] = in ? p.lse[(size_t)bh * p.Sq + qpos] : 0.f;
      delta[ii] = in ? p.delta[(size_t)bh * p.Sq + qpos] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dq[r] = 0.f;
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (tile_lo + i) * kTileKeys;
      mbar_wait(&kv_full[s], (i / kStages) & 1);
      if (!tile_dead(p, row0, k0)) {
        const uint8_t* kt = ks + s * S::kKV;
        const uint8_t* vt = vs + s * S::kKV;
        // S = Q.K^T and dP = dO.V^T, 64 queries x 64 keys
        float sc[32], dp[32];
#pragma unroll
        for (int r = 0; r < 32; ++r) sc[r] = dp[r] = 0.f;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, kmajor_desc(qw, kFwdBlockRows, kk),
                       kmajor_desc(kt, kTileKeys, kk), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dp, kmajor_desc(dow, kFwdBlockRows, kk),
                       kmajor_desc(vt, kTileKeys, kk), 1);
        wg_commit();
        wg_wait_all();
        reg_fence(sc);
        reg_fence(dp);

        const bool masked = tile_masked(p, row0, k0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int r = 4 * j + 2 * ii + c;
              float ds = 0.f;
              if (!masked || is_live(p, b, row_a + 8 * ii, k0 + frag_col(t, j, c))) {
                const float pr = expf(sc[r] * p.scale - lse[ii]);
                ds = pr * (dp[r] - delta[ii]) * p.scale;
              }
              sc[r] = ds;
            }
        uint32_t dsa[4][4];                      // dS rounded to k's dtype
        to_a_operands(sc, dsa);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kTileKeys / 16; ++kk)
          wgmma_rs<D>(dq, dsa[kk], mnmajor_desc(kt, kTileKeys, kk));
        wg_commit();
        wg_wait_all();
        reg_fence(dq);
      }
      mbar_arrive(&kv_empty[s]);
    }

    bf16* dq_out = static_cast<bf16*>(p.out);
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      const int qpos = row_a + 8 * ii;
      if (qpos >= p.Sq) continue;
      bf16* dst = dq_out + ((size_t)(b * p.Sq + qpos) * p.H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int r = 4 * j + 2 * ii;
        *reinterpret_cast<__nv_bfloat162*>(dst + frag_col(t, j, 0)) =
            __floats2bfloat162_rn(dq[r], dq[r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
enum Which { kFwd = 0, kDq = 1, kDkv = 2, kFwdWgmma = 3, kDkvWgmma = 4,
             kDqWgmma = 5 };

template <int D>
int smem_bytes(int which) {
  if (which == kFwd) return fwd_smem_floats<D>() * (int)sizeof(float);
  if (which == kDq) return dq_smem_floats<D>() * (int)sizeof(float);
  if (which == kDkv) return dkv_smem_floats<D>() * (int)sizeof(float);
  if (which == kFwdWgmma) return FwdSmem<D>::kBytes;
  if (which == kDkvWgmma) return DkvSmem<D>::kBytes;
  if (which == kDqWgmma) return DqSmem<D>::kBytes;
  return -1;
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The [D, heads, S, B] view of a contiguous bf16 tensor [B, S, heads, D],
// loading boxes of (64, 1, rows, 1) in 128-byte swizzle; positions past S
// (and past B) load as zeros.
bool tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads,
                int D, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kAtom, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool* configured) {
  if (*configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *configured = true;
  return err;
}

template <int D>
cudaError_t launch_fwd_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, p.q, p.B, p.Sq, p.H, D, kFwdBlockRows) ||
      !tensor_map(&km, p.k, p.B, p.Sk, p.Hkv, D, kTileKeys) ||
      !tensor_map(&vm, p.v, p.B, p.Sk, p.Hkv, D, kTileKeys))
    return cudaErrorInvalidValue;
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_fwd_kernel_wgmma<D>, FwdSmem<D>::kBytes, &configured);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.Sq + kFwdBlockRows - 1) / kFwdBlockRows;
  flash_fwd_kernel_wgmma<D><<<n_qt * p.B * p.H, kHopperThreads, FwdSmem<D>::kBytes,
                              stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  if (!tensor_map(&qm, p.q, p.B, p.Sq, p.H, D, kFwdBlockRows) ||
      !tensor_map(&km, p.k, p.B, p.Sk, p.Hkv, D, kTileKeys) ||
      !tensor_map(&vm, p.v, p.B, p.Sk, p.Hkv, D, kTileKeys) ||
      !tensor_map(&dom, p.dout, p.B, p.Sq, p.H, D, kFwdBlockRows))
    return cudaErrorInvalidValue;
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_dq_kernel_wgmma<D>, DqSmem<D>::kBytes, &configured);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.Sq + kFwdBlockRows - 1) / kFwdBlockRows;
  flash_dq_kernel_wgmma<D><<<n_qt * p.B * p.H, kHopperThreads, DqSmem<D>::kBytes,
                             stream>>>(qm, km, vm, dom, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dom;
  if (!tensor_map(&qm, p.q, p.B, p.Sq, p.H, D, kTileRows) ||
      !tensor_map(&km, p.k, p.B, p.Sk, p.Hkv, D, kTileKeys) ||
      !tensor_map(&vm, p.v, p.B, p.Sk, p.Hkv, D, kTileKeys) ||
      !tensor_map(&dom, p.dout, p.B, p.Sq, p.H, D, kTileRows))
    return cudaErrorInvalidValue;
  static bool configured = false;
  const cudaError_t err =
      allow_smem(flash_dkv_kernel_wgmma<D>, DkvSmem<D>::kBytes, &configured);
  if (err != cudaSuccess) return err;
  const int n_kt = (p.Sk + kTileKeys - 1) / kTileKeys;
  flash_dkv_kernel_wgmma<D><<<n_kt * p.B * p.Hkv, kHopperThreads, DkvSmem<D>::kBytes,
                              stream>>>(qm, km, vm, dom, p);
  return cudaGetLastError();
}

// The CUDA-core kernels, for fp32.
template <typename T, int D, int W>
cudaError_t launch_cuda_cores(const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = nullptr;
  dim3 grid;
  if constexpr (W == kFwd) {
    kernel = flash_fwd_kernel<T, D>;
    grid = dim3((p.Sq + kFwdRows - 1) / kFwdRows, p.B * p.H);
  } else if constexpr (W == kDq) {
    kernel = flash_dq_kernel<T, D>;
    grid = dim3((p.Sq + kFwdRows - 1) / kFwdRows, p.B * p.H);
  } else {
    kernel = flash_dkv_kernel<T, D>;
    grid = dim3((p.Sk + kDkvKeys - 1) / kDkvKeys, p.B * p.Hkv);
  }
  const int smem = smem_bytes<D>(W);
  static bool configured = false;
  const cudaError_t err = allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The choice by dtype: bf16 on the tensor cores, fp32 (which wgmma would
// take only as TF32) on the CUDA cores.
template <typename T, int D>
cudaError_t launch(int which, const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (which == kFwd) return launch_fwd_wgmma<D>(p, stream);
    if (which == kDq) return launch_dq_wgmma<D>(p, stream);
    return launch_dkv_wgmma<D>(p, stream);
  } else {
    if (which == kFwd) return launch_cuda_cores<T, D, kFwd>(p, stream);
    if (which == kDq) return launch_cuda_cores<T, D, kDq>(p, stream);
    return launch_cuda_cores<T, D, kDkv>(p, stream);
  }
}

template <typename T>
cudaError_t pick_dim(int which, const Params& p, int head_dim, cudaStream_t stream) {
  if (head_dim == 64) return launch<T, 64>(which, p, stream);
  if (head_dim == 128) return launch<T, 128>(which, p, stream);
  return cudaErrorInvalidValue;
}

int run(int which, const Params& p, int head_dim, int dtype, void* stream) {
  if (p.B <= 0 || p.Sq <= 0 || p.Sk <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if ((p.qseg == nullptr) != (p.kseg == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)pick_dim<float>(which, p, head_dim, s);
  if (dtype == 1) return (int)pick_dim<__nv_bfloat16>(which, p, head_dim, s);
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qseg,
                   const void* kseg, int B, int Sq, int Sk, int H, int Hkv,
                   int causal, int window, int shift, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.Hkv = Hkv;
  p.causal = causal; p.window = window; p.shift = shift;
  p.scale = scale;
  return p;
}

}  // namespace

// Dynamic shared memory (bytes) of kernel `which` at `head_dim`: 0 the fp32
// forward, 1 the fp32 dQ, 2 the fp32 dK/dV, 3 the bf16 forward, 4 the bf16
// dK/dV, 5 the bf16 dQ; -1 for an instantiation not compiled.
extern "C" int dstt_flash_smem_bytes(int which, int head_dim) {
  if (head_dim == 64) return smem_bytes<64>(which);
  if (head_dim == 128) return smem_bytes<128>(which);
  return -1;
}

// All pointers are device pointers; q/k/v/out contiguous in [B, S, heads,
// head_dim]; lse [B, H, Sq] fp32; qseg/kseg int32 [B, Sq]/[B, Sk] or both
// null. causal (0/1, a window implies it), window (<= 0: none), shift
// (causal_shift 0/1). dtype: 0 = float32, 1 = bfloat16. Each returns
// cudaGetLastError() after its launch (0 on success).
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v,
                              const void* qseg, const void* kseg, void* out,
                              void* lse, int B, int Sq, int Sk, int H, int Hkv,
                              int head_dim, int causal, int window, int shift,
                              float scale, int dtype, void* stream) {
  Params p = make_params(q, k, v, nullptr, nullptr, nullptr, qseg, kseg, B, Sq,
                         Sk, H, Hkv, causal, window, shift, scale);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  return run(kFwd, p, head_dim, dtype, stream);
}

extern "C" int dstt_flash_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* qseg, const void* kseg, void* dq, int B,
                             int Sq, int Sk, int H, int Hkv, int head_dim,
                             int causal, int window, int shift, float scale,
                             int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, qseg, kseg, B, Sq, Sk, H,
                         Hkv, causal, window, shift, scale);
  p.out = dq;
  return run(kDq, p, head_dim, dtype, stream);
}

extern "C" int dstt_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta,
                              const void* qseg, const void* kseg, void* dk, void* dv,
                              int B, int Sq, int Sk, int H, int Hkv, int head_dim,
                              int causal, int window, int shift, float scale,
                              int dtype, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, qseg, kseg, B, Sq, Sk, H,
                         Hkv, causal, window, shift, scale);
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, p, head_dim, dtype, stream);
}
