// Evoformer (DS4Science) attention for Hopper (sm_90a): the forward with its
// per-row logsumexp, the dQ and dK/dV backward kernels, and the two
// bias-gradient reductions.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/evoformer.py:
//   evo_fwd_kernel, evo_fwd_kernel_mma (bf16)  <- `_evo_fwd_kernel`
//   evo_dq_kernel, evo_dq_kernel_mma (bf16)    <- `_evo_dq_kernel`
//   evo_dkv_kernel, evo_dkv_kernel_mma (bf16)  <- `_evo_dkv_kernel`
//   evo_dbias2_kernel, evo_dbias2_kernel_mma and
//     evo_dbias2_combine_kernel (bf16)         <- `_evo_dbias2_kernel`
//   evo_dbias1_kernel, evo_dbias1_kernel_mma
//     (bf16)                                   <- `_evo_dbias1_kernel`
// (wrappers `_evo_fwd_impl`, `_evo_bwd_impl`)
//
// Function: q [B,N,Lq,H,D], k/v [B,N,Lk,H,D] (row g = (b*N + n)*H + h),
// bias1 [B,N,Lk] (per key of each row, OpenFold's mask) and bias2
// [B,H,Lq,Lk] (one pair panel per (b, h), shared by the N rows; never
// materialized over N), both fp32 and both optional. Scores are the fp32 dot
// times scale, then + bias1, then + bias2 (each rounded on its own, no fused
// multiply-add, as the reference adds them); keys at or past Lk are dead.
// The forward rounds p to v's dtype before P.V, divides by max(l, 1e-30) and
// emits lse = m + log(max(l, 1e-30)). The backward recomputes p = exp(s -
// lse) from (q, k, biases, lse), takes delta = rowsum(dO.O) (fp32, from the
// wrapper), forms the raw dS = p (dP - delta); dq sums round_k(dS * scale) K,
// dk sums round_q(dS * scale)^T Q, dv sums round_dO(p)^T dO, db2 sums the raw
// dS over the N rows of a panel, db1 sums it over heads and query rows.
//
// What bounds it: at OpenFold's widths (L = 384, D = 32, H = 8) the forward
// does 77 GFLOP against 0.41 GB of operands, so at the tensor cores' bf16
// rate it is bound by bytes (0.12 ms); at D = 8 (the extra-MSA stack) even
// more so. The fp32 kernels are the first, simple design: they multiply on
// the fp32 CUDA cores from shared memory, so arithmetic bounds them in
// practice. The bf16 forward, dQ, dK/dV, dbias2 and dbias1 multiply on the
// tensor cores; what sets their time is the
// work per score on the CUDA cores (the scale, two rounded bias adds, the
// exact expf, and in the backward dP - delta, two products, the sums).
//   * The TPU grid's sequential axes, which carried sums in VMEM from one
//     grid step to the next, are loops inside a block. In the CUDA-core
//     kernels forward, dQ and dbias2 walk 64-key tiles for a 32-row query
//     tile; dK/dV walks 32-row
//     query tiles for a 32-key tile; dbias2 walks the N rows of its (b, h)
//     panel tile in order, dbias1 the heads and query tiles of its (b, n)
//     key tile in order, so both reductions are deterministic, with no
//     atomics.
//   * Every tile is sized by D (a template parameter, 8..128): shared
//     memory holds [rows][D + 1] fp32 and each thread's share of a [rows][D]
//     accumulator is rows * D / 128 values, so D = 8 wastes nothing.
//   * The bias2 value of a (query, key) pair is read straight from the
//     panel (coalesced along keys); dbias2 reads its tile's once for all N
//     rows.
// The bf16 forward, evo_fwd_kernel_mma, runs on the tensor cores
// (`mma.sync` m16n8k16 from `ldmatrix`, fed by a `cp.async` ring; helpers in
// warp_mma.cuh). `launch` picks it for bf16; fp32 keeps evo_fwd_kernel,
// since the tensor cores take fp32 only as TF32:
//   * A warp owns 16 query rows of one MSA row; 4 warps (a warp group) own
//     a 64-row query tile of it, so each row's K/V is read from L2
//     ceil(Lq / 64) times.
//   * With a pair bias, a block is G = 2 warp groups (1 at D = 128;
//     `evo_fwd_plan` in ops/evoformer.py mirrors it) on G MSA rows n of one
//     (b, h, query tile), which share one copy of each [64, 64] pair-bias
//     tile in shared memory: the panel is read from L2 N/G times, not N
//     times. Each row's accumulator lives in its own warps' registers, so G
//     costs threads, not registers; a [64, Lk] resident panel (96 KB at Lk
//     = 384) would have left one 4-warp block an SM. G = 2 keeps two
//     256-thread blocks on an SM at D <= 32 (128 registers a thread, 89 KB),
//     so one block's fill overlaps the other's work: at E1 and E4 it beat
//     G = 4 (one 512-thread block an SM) and G = 1 on the card, though G
//     = 4 reads the panel half as often.
//   * The ring's unit is one 64-key tile of the G rows: K, V, the bias1
//     segments and the pair-bias tile of the next tile are in flight (2
//     stages) while one computes; the G rows' Q tiles stay resident. Rows
//     are read in their [B*N, L, H, D] layout (16-byte chunks of one head's
//     row), zero-filled past L; the fp32 biases in 16-byte chunks where Lk
//     % 4 == 0, else 4-byte ones.
//   * D = 8: Q and K are zero-padded to 16 columns in shared memory for the
//     k16 depth of Q.K^T; P.V uses one n8 tile.
//   * The score accumulator of two adjacent n8 tiles, rounded to bf16 pairs
//     in registers, is the A fragment of P.V (the reference's rounding
//     point); l sums the unrounded p; out and lse are written once per row,
//     no atomics, so the forward repeats bit for bit.
// The bf16 dK/dV, evo_dkv_kernel_mma, is the forward with keys and queries
// swapped (`launch` picks it for bf16; fp32 keeps evo_dkv_kernel):
//   * A warp owns 16 keys of one MSA row, a warp group a 64-key tile of it;
//     with a pair bias a block is G = 2 warp groups on 2 MSA rows (1 at D =
//     128; `evo_bwd_plan` mirrors it). K and V stay in shared memory (their
//     A fragments in registers at D <= 64) while a 2-stage ring brings each
//     64-row query tile: Q and dO of the G rows, their lse and delta, and
//     one fp32 [64 queries][68] pair-bias tile the G rows share, so the
//     panel is read from L2 N/G times. It is read transposed, per query
//     column of the S^T fragment; the 68-float row stride puts the 8 keys x
//     4 query pairs of one read on 32 distinct banks.
//   * S^T = K.Q^T and dP^T = V.dO^T run 16 queries at a time; p (0 for dead
//     queries) and dS * scale, rounded to bf16 in registers by a_from_c,
//     are the A fragments of dV += P^T.dO and dK += dS^T.Q, which read dO
//     and Q transposed with `ldmatrix .trans`. Rows of dead keys are never
//     written. dK and dV are written once per key row: no atomics, they
//     repeat bit for bit.
//   * Built for two resident blocks an SM at D <= 32 (at most 128
//     registers a thread): the work per score needs the warps more than the
//     registers. G = 1 and G = 4 were slower on the card (PERF.md).
// The bf16 dQ, evo_dq_kernel_mma, is the forward with the dP product added
// (`launch` picks it for bf16; fp32 keeps evo_dq_kernel):
//   * A warp owns 16 query rows of one MSA row, a warp group a 64-row query
//     tile of it; with a pair bias a block is G = 2 warp groups on 2 MSA
//     rows (1 at D = 128 or without one; `evo_bwd_plan` mirrors it) that
//     share each fp32 [64][72] pair-bias tile, so the panel is read from L2
//     N/G times. Q and dO of the G rows stay resident; lse and delta sit in
//     registers, one per accumulator row; a 2-stage ring brings K, V, the
//     bias1 segments and the pair tile of each 64-key tile.
//   * S = Q.K^T and dP = dO.V^T run on `mma.sync`; dS * scale, rounded to
//     bf16 in registers by a_from_c, is the A fragment of dQ += dS.K, which
//     reads K with `ldmatrix .trans` as the forward reads V for P.V.
//   * Keys at or past Lk get p = 0 explicitly: their K rows are zero-filled,
//     so exp(0 - lse) is not 0 and overflows where lse is -1e9 (a fully
//     masked row). Dead query rows may hold any p, even inf or NaN: a row of
//     the dS fragment reaches only its own dQ row, and those are never
//     written. dQ is written once per row, no atomics: it repeats bit for
//     bit.
//   * Built for two resident blocks an SM at D <= 32, as dK/dV is.
// The bf16 dbias2, evo_dbias2_kernel_mma (fp32 keeps evo_dbias2_kernel):
//   * A block of 4 warps x 16 query rows owns one 64 x 64 tile of a (b, h)
//     panel; its pair-bias values and fp32 sums stay in registers in
//     C-fragment layout while it walks the MSA rows of one split of N in
//     order, a 3-stage ring (2 at D >= 64) bringing row n + 1's Q, dO, K
//     and V tiles, bias1, lse and delta while row n computes S = Q.K^T and
//     dP = dO.V^T on `mma.sync`. Dead queries and keys are never written,
//     so they need no mask. Built for three resident blocks an SM at D <=
//     32.
//   * N is split as far as it shortens the grid's waves of resident blocks
//     (`dbias2_splits` in ops/evoformer.py, from the shapes and the card
//     alone); the splits' partials go to a workspace that
//     evo_dbias2_combine_kernel sums in split order, so db2 repeats bit for
//     bit, with no atomics.
// The bf16 dbias1, evo_dbias1_kernel_mma (fp32 keeps evo_dbias1_kernel), is
// dK/dV's tiling without its two products: the sum over queries becomes a
// sum along the rows of S^T, which each key's owner keeps in registers.
//   * A warp owns 16 keys of one MSA row, a warp group a 64-key tile of it;
//     a block is G warp groups on G MSA rows of one b (`evo_bwd_plan`
//     mirrors it), which share each fp32 [64 queries][68] pair-bias tile.
//     G = 1, built for three resident blocks an SM at D <= 32, beat G = 2
//     (two blocks an SM, 128 registers and 32 bytes of spills) on the card.
//     The block walks the heads and, in each, the 64-row query tiles: a
//     2-stage `cp.async` ring brings each step's Q and dO of the G rows,
//     their lse and delta and the pair tile; a head's first step brings its
//     K and V tiles too, which every warp copies into registers as the A
//     fragments of S^T = K.Q^T and dP^T = V.dO^T (a barrier then frees the
//     one K/V slot for the next head).
//   * p = exp(dot * scale + bias1 + bias2 - lse), each add rounded on its
//     own, is 0 for dead queries; the raw dS = p (dP - delta) of each key
//     is summed in registers over heads, query tiles and the thread's query
//     columns in order, then over the 4 lanes of a key row by shuffles, and
//     written once: no atomics and no cross-warp reduction, so db1 repeats
//     bit for bit. Dead keys' sums are never written.
//   * Without a pair bias the kernel skips the pair tile (one instance per
//     head dim, the pair bias's presence read at run time).
// Not done yet (later work): the bias reductions stay out of the dK/dV and
// dQ passes: db2 sums over the N rows that dK/dV spreads over its blocks,
// so fusing them needs an [N/G, B, H, Lq, Lk] workspace of partials (1.2 GB
// at OpenFold's MSA row attention), and db1 in dQ an [B, N, H, Lq/64, Lk]
// one of column partials (37.7 MB there) and a combine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "warp_mma.cuh"

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF
constexpr int kRows = 32;              // query rows of a tile
constexpr int kKeys = 64;              // keys of a tile (forward, dQ, bias grads)
constexpr int kDkvKeys = 32;           // keys of a dK/dV block
constexpr int kKeyPad = 1;             // p/dS tiles are [rows][keys + 1]

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
  const float* b1;        // [B*N, Lk] or null
  const float* b2;        // [B*H, Lq, Lk] or null
  const float* lse;       // [B*N*H, Lq] (backward input)
  const float* delta;     // [B*N*H, Lq] (backward input)
  void* out0;             // forward: out; dQ: dq; dK/dV: dk; dbias2: db2; dbias1: db1
  void* out1;             // forward: lse (fp32); dK/dV: dv
  int B, N, Lq, Lk, H;
  float scale;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The thread -> element map of a [ROWS][D] fp32 accumulator: TC threads
// across the D columns (CPT columns each), kThreads / TC row groups.
template <int D, int ROWS>
struct AccMap {
  static constexpr int TC = D < 32 ? D : 32;
  static constexpr int CPT = D / TC;
  static constexpr int RG = kThreads / TC;
  static constexpr int PR = ROWS / RG;
  static_assert(PR * RG == ROWS && CPT * TC == D, "tile does not divide");
  __device__ static int row(int i) { return threadIdx.x / TC + RG * i; }
  __device__ static int col(int j) { return threadIdx.x % TC + TC * j; }
};

// Copy `rows` rows of row g (= bn*H + h) from x [B*N, S, H, D], from
// sequence position pos0, into dst [rows][D + 1] as fp32; rows past S are 0.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, float* dst, int rows,
                                          int pos0, int S, int H, int bn, int h) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  static_assert(VPR * VEC == D, "D must be a multiple of 16 bytes");
  for (int e = threadIdx.x; e < rows * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * VEC;
    const int pos = pos0 + r;
    float* d = dst + r * (D + 1) + c;
    if (pos < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          x + ((size_t)((size_t)bn * S + pos) * H + h) * D + c);
      const T* xs = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = to_float(xs[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = 0.f;
    }
  }
}

// One value per row (lse or delta) of row g for query rows [q0, q0 + R).
__device__ __forceinline__ void load_row_stats(const float* __restrict__ x, float* dst,
                                               int R, size_t g, int q0, int Lq) {
  for (int r = threadIdx.x; r < R; r += kThreads)
    dst[r] = q0 + r < Lq ? x[g * Lq + q0 + r] : 0.f;
}

// s[i][j] = dot(a row ty + 8i, b row tx + 16j) over D, a [R][D+1], b [K][D+1].
template <int D, int R, int K>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          float (&s)[R / 8][K / 16]) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < R / 8; ++i)
#pragma unroll
    for (int j = 0; j < K / 16; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float av[R / 8], bv[K / 16];
#pragma unroll
    for (int i = 0; i < R / 8; ++i) av[i] = a[(ty + 8 * i) * DP + c];
#pragma unroll
    for (int j = 0; j < K / 16; ++j) bv[j] = b[(tx + 16 * j) * DP + c];
#pragma unroll
    for (int i = 0; i < R / 8; ++i)
#pragma unroll
      for (int j = 0; j < K / 16; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// The score of a live (query, key) pair: dot * scale, + bias1, + bias2.
__device__ __forceinline__ float biased(const Params& p, float dot, size_t bn, float b2v,
                                        int kpos) {
  float s = __fmul_rn(dot, p.scale);
  if (p.b1 != nullptr) s = __fadd_rn(s, p.b1[bn * p.Lk + kpos]);
  if (p.b2 != nullptr) s = __fadd_rn(s, b2v);
  return s;
}

__device__ __forceinline__ float bias2_at(const Params& p, int bh2, int qpos, int kpos) {
  return p.b2 != nullptr ? p.b2[((size_t)bh2 * p.Lq + qpos) * p.Lk + kpos] : 0.f;
}

// ---------------------------------------------------------------------------
// forward: out and lse, one block per (32-row query tile, row g)
// ---------------------------------------------------------------------------
template <int D>
constexpr int fwd_smem_floats() {
  return kRows * (D + 1) + 2 * kKeys * (D + 1) + kRows * (kKeys + kKeyPad) + 3 * kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) evo_fwd_kernel(Params p) {
  constexpr int DP = D + 1, R = kRows, K = kKeys, KP = K + kKeyPad;
  constexpr int SR = R / 8, SC = K / 16;
  using A = AccMap<D, R>;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int nqt = cdiv(p.Lq, R);
  const size_t g = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x % nqt) * R;
  const size_t bn = g / p.H;
  const int h = (int)(g % p.H), bh2 = (int)(bn / p.N) * p.H + h;

  extern __shared__ float smem[];
  float* qs = smem;                      // [R][DP]
  float* ks = qs + R * DP;               // [K][DP]
  float* vs = ks + K * DP;               // [K][DP]
  float* ps = vs + K * DP;               // [R][KP]
  float* m_s = ps + R * KP;              // [R]
  float* l_s = m_s + R;                  // [R]
  float* alpha_s = l_s + R;              // [R]

  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  load_rows<T, D>(static_cast<const T*>(p.q), qs, R, q0, p.Lq, p.H, (int)bn, h);

  float acc[A::PR][A::CPT];
#pragma unroll
  for (int i = 0; i < A::PR; ++i)
#pragma unroll
    for (int j = 0; j < A::CPT; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < p.Lk; k0 += K) {
    load_rows<T, D>(static_cast<const T*>(p.k), ks, K, k0, p.Lk, p.H, (int)bn, h);
    load_rows<T, D>(static_cast<const T*>(p.v), vs, K, k0, p.Lk, p.H, (int)bn, h);
    __syncthreads();

    {
      float s[SR][SC];
      tile_dots<D, R, K>(qs, ks, s);
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = ty + 8 * i, qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int kr = tx + 16 * j, kpos = k0 + kr;
          ps[r * KP + kr] = (qpos < p.Lq && kpos < p.Lk)
                                ? biased(p, s[i][j], bn, bias2_at(p, bh2, qpos, kpos), kpos)
                                : __int_as_float(0xff800000);   // -inf: exp() is 0
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per row; p is rounded to v's dtype for P.V,
    // l sums the unrounded p (as the reference does)
    for (int r = warp; r < R; r += kThreads / 32) {
      const float a = ps[r * KP + lane];
      const float c = ps[r * KP + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * KP + lane] = round_to<T>(pa);
      ps[r * KP + lane + 32] = round_to<T>(pc);
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
    for (int i = 0; i < A::PR; ++i) {
      const float alpha = alpha_s[A::row(i)];
#pragma unroll
      for (int j = 0; j < A::CPT; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kr = 0; kr < K; ++kr) {
      float vv[A::CPT];
#pragma unroll
      for (int j = 0; j < A::CPT; ++j) vv[j] = vs[kr * DP + A::col(j)];
#pragma unroll
      for (int i = 0; i < A::PR; ++i) {
        const float pv = ps[A::row(i) * KP + kr];
#pragma unroll
        for (int j = 0; j < A::CPT; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
      }
    }
    __syncthreads();   // the next tile overwrites ks, vs and ps
  }

  T* out = static_cast<T*>(p.out0);
  float* lse = static_cast<float*>(p.out1);
#pragma unroll
  for (int i = 0; i < A::PR; ++i) {
    const int r = A::row(i), qpos = q0 + r;
    if (qpos >= p.Lq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* dst = out + ((bn * p.Lq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < A::CPT; ++j) dst[A::col(j)] = from_float<T>(acc[i][j] / l);
    if (A::col(0) == 0) lse[g * p.Lq + qpos] = m_s[r] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// dQ: dq = sum over key tiles of round_k(dS * scale) . K, one block per
// (32-row query tile, row g)
// ---------------------------------------------------------------------------
template <int D>
constexpr int dq_smem_floats() {
  return 2 * kRows * (D + 1) + 2 * kKeys * (D + 1) + kRows * (kKeys + kKeyPad) + 2 * kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) evo_dq_kernel(Params p) {
  constexpr int DP = D + 1, R = kRows, K = kKeys, KP = K + kKeyPad;
  constexpr int SR = R / 8, SC = K / 16;
  using A = AccMap<D, R>;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nqt = cdiv(p.Lq, R);
  const size_t g = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x % nqt) * R;
  const size_t bn = g / p.H;
  const int h = (int)(g % p.H), bh2 = (int)(bn / p.N) * p.H + h;

  extern __shared__ float smem[];
  float* qs = smem;                      // [R][DP]
  float* dos = qs + R * DP;              // [R][DP]
  float* ks = dos + R * DP;              // [K][DP]
  float* vs = ks + K * DP;               // [K][DP]
  float* ds_s = vs + K * DP;             // [R][KP]
  float* lse_s = ds_s + R * KP;          // [R]
  float* delta_s = lse_s + R;            // [R]

  load_rows<T, D>(static_cast<const T*>(p.q), qs, R, q0, p.Lq, p.H, (int)bn, h);
  load_rows<T, D>(static_cast<const T*>(p.dout), dos, R, q0, p.Lq, p.H, (int)bn, h);
  load_row_stats(p.lse, lse_s, R, g, q0, p.Lq);
  load_row_stats(p.delta, delta_s, R, g, q0, p.Lq);

  float acc[A::PR][A::CPT];
#pragma unroll
  for (int i = 0; i < A::PR; ++i)
#pragma unroll
    for (int j = 0; j < A::CPT; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < p.Lk; k0 += K) {
    load_rows<T, D>(static_cast<const T*>(p.k), ks, K, k0, p.Lk, p.H, (int)bn, h);
    load_rows<T, D>(static_cast<const T*>(p.v), vs, K, k0, p.Lk, p.H, (int)bn, h);
    __syncthreads();

    {
      float s[SR][SC], dp[SR][SC];
      tile_dots<D, R, K>(qs, ks, s);
      tile_dots<D, R, K>(dos, vs, dp);
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = ty + 8 * i, qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int kr = tx + 16 * j, kpos = k0 + kr;
          float ds = 0.f;
          if (qpos < p.Lq && kpos < p.Lk) {
            const float sc = biased(p, s[i][j], bn, bias2_at(p, bh2, qpos, kpos), kpos);
            const float pr = expf(sc - lse_s[r]);
            ds = pr * (dp[i][j] - delta_s[r]);
          }
          ds_s[r * KP + kr] = round_to<T>(ds * p.scale);   // (dS*scale).astype(k.dtype)
        }
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kr = 0; kr < K; ++kr) {
      float kv[A::CPT];
#pragma unroll
      for (int j = 0; j < A::CPT; ++j) kv[j] = ks[kr * DP + A::col(j)];
#pragma unroll
      for (int i = 0; i < A::PR; ++i) {
        const float d = ds_s[A::row(i) * KP + kr];
#pragma unroll
        for (int j = 0; j < A::CPT; ++j) acc[i][j] = fmaf(d, kv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* dq = static_cast<T*>(p.out0);
#pragma unroll
  for (int i = 0; i < A::PR; ++i) {
    const int qpos = q0 + A::row(i);
    if (qpos >= p.Lq) continue;
    T* dst = dq + ((bn * p.Lq + qpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < A::CPT; ++j) dst[A::col(j)] = from_float<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (32-key tile, row g), looping over 32-row query tiles
// ---------------------------------------------------------------------------
template <int D>
constexpr int dkv_smem_floats() {
  return 2 * kDkvKeys * (D + 1) + 2 * kRows * (D + 1) +
         2 * kRows * (kDkvKeys + kKeyPad) + 2 * kRows;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) evo_dkv_kernel(Params p) {
  constexpr int DP = D + 1, K = kDkvKeys, R = kRows, KP = K + kKeyPad;
  constexpr int SR = R / 8, SC = K / 16;
  using A = AccMap<D, K>;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nkt = cdiv(p.Lk, K);
  const size_t g = blockIdx.x / nkt;
  const int k0 = (int)(blockIdx.x % nkt) * K;
  const size_t bn = g / p.H;
  const int h = (int)(g % p.H), bh2 = (int)(bn / p.N) * p.H + h;

  extern __shared__ float smem[];
  float* ks = smem;                      // [K][DP]
  float* vs = ks + K * DP;               // [K][DP]
  float* qs = vs + K * DP;               // [R][DP]
  float* dos = qs + R * DP;              // [R][DP]
  float* ps = dos + R * DP;              // [R][KP]
  float* dss = ps + R * KP;              // [R][KP]
  float* lse_s = dss + R * KP;           // [R]
  float* delta_s = lse_s + R;            // [R]

  load_rows<T, D>(static_cast<const T*>(p.k), ks, K, k0, p.Lk, p.H, (int)bn, h);
  load_rows<T, D>(static_cast<const T*>(p.v), vs, K, k0, p.Lk, p.H, (int)bn, h);

  float dk[A::PR][A::CPT], dv[A::PR][A::CPT];
#pragma unroll
  for (int i = 0; i < A::PR; ++i)
#pragma unroll
    for (int j = 0; j < A::CPT; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < p.Lq; q0 += R) {
    __syncthreads();   // the previous step's readers are done with qs/dos/ps/dss
    load_rows<T, D>(static_cast<const T*>(p.q), qs, R, q0, p.Lq, p.H, (int)bn, h);
    load_rows<T, D>(static_cast<const T*>(p.dout), dos, R, q0, p.Lq, p.H, (int)bn, h);
    load_row_stats(p.lse, lse_s, R, g, q0, p.Lq);
    load_row_stats(p.delta, delta_s, R, g, q0, p.Lq);
    __syncthreads();

    {
      float s[SR][SC], dp[SR][SC];
      tile_dots<D, R, K>(qs, ks, s);
      tile_dots<D, R, K>(dos, vs, dp);
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = ty + 8 * i, qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int kr = tx + 16 * j, kpos = k0 + kr;
          float pr = 0.f, ds = 0.f;
          if (qpos < p.Lq && kpos < p.Lk) {
            const float sc = biased(p, s[i][j], bn, bias2_at(p, bh2, qpos, kpos), kpos);
            pr = expf(sc - lse_s[r]);
            ds = pr * (dp[i][j] - delta_s[r]);
          }
          ps[r * KP + kr] = round_to<T>(pr);                // p.astype(dO.dtype)
          dss[r * KP + kr] = round_to<T>(ds * p.scale);     // (dS*scale).astype(q.dtype)
        }
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      float qv[A::CPT], dov[A::CPT];
#pragma unroll
      for (int j = 0; j < A::CPT; ++j) {
        qv[j] = qs[r * DP + A::col(j)];
        dov[j] = dos[r * DP + A::col(j)];
      }
#pragma unroll
      for (int i = 0; i < A::PR; ++i) {
        const int kr = A::row(i);
        const float pv = ps[r * KP + kr], dsv = dss[r * KP + kr];
#pragma unroll
        for (int j = 0; j < A::CPT; ++j) {
          dv[i][j] = fmaf(pv, dov[j], dv[i][j]);
          dk[i][j] = fmaf(dsv, qv[j], dk[i][j]);
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.out0);
  T* dv_out = static_cast<T*>(p.out1);
#pragma unroll
  for (int i = 0; i < A::PR; ++i) {
    const int kpos = k0 + A::row(i);
    if (kpos >= p.Lk) continue;
    const size_t off = ((bn * p.Lk + kpos) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < A::CPT; ++j) {
      dk_out[off + A::col(j)] = from_float<T>(dk[i][j]);
      dv_out[off + A::col(j)] = from_float<T>(dv[i][j]);
    }
  }
}

// The raw dS of this thread's (query, key) pairs of a (query tile, key
// tile) of row g, whose q/dO/k/v tiles and lse/delta are in shared memory.
template <int D, int R, int K>
__device__ __forceinline__ void raw_ds(const Params& p, const float* qs, const float* dos,
                                       const float* ks, const float* vs, const float* lse_s,
                                       const float* delta_s, size_t bn, int q0, int k0,
                                       const float (&b2v)[R / 8][K / 16],
                                       float (&ds)[R / 8][K / 16]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[R / 8][K / 16], dp[R / 8][K / 16];
  tile_dots<D, R, K>(qs, ks, s);
  tile_dots<D, R, K>(dos, vs, dp);
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
    const int r = ty + 8 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < K / 16; ++j) {
      const int kpos = k0 + tx + 16 * j;
      ds[i][j] = 0.f;
      if (qpos < p.Lq && kpos < p.Lk) {
        const float pr = expf(biased(p, s[i][j], bn, b2v[i][j], kpos) - lse_s[r]);
        ds[i][j] = pr * (dp[i][j] - delta_s[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dbias2: one block per (32-row query tile, 64-key tile, panel (b, h)),
// summing dS over the N rows of the panel in order
// ---------------------------------------------------------------------------
template <int D>
constexpr int dbias_smem_floats() {
  return 2 * kRows * (D + 1) + 2 * kKeys * (D + 1) + 2 * kRows + 8 * kKeys;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) evo_dbias2_kernel(Params p) {
  constexpr int DP = D + 1, R = kRows, K = kKeys;
  constexpr int SR = R / 8, SC = K / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nqt = cdiv(p.Lq, R), nkt = cdiv(p.Lk, K);
  const int bh2 = (int)(blockIdx.x / (nqt * nkt));
  const int tile = (int)(blockIdx.x % (nqt * nkt));
  const int q0 = (tile / nkt) * R, k0 = (tile % nkt) * K;
  const int b = bh2 / p.H, h = bh2 % p.H;

  extern __shared__ float smem[];
  float* qs = smem;                      // [R][DP]
  float* dos = qs + R * DP;              // [R][DP]
  float* ks = dos + R * DP;              // [K][DP]
  float* vs = ks + K * DP;               // [K][DP]
  float* lse_s = vs + K * DP;            // [R]
  float* delta_s = lse_s + R;            // [R]

  float b2v[SR][SC], acc[SR][SC];
#pragma unroll
  for (int i = 0; i < SR; ++i)
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int qpos = q0 + ty + 8 * i, kpos = k0 + tx + 16 * j;
      b2v[i][j] = (qpos < p.Lq && kpos < p.Lk) ? bias2_at(p, bh2, qpos, kpos) : 0.f;
      acc[i][j] = 0.f;
    }

  for (int n = 0; n < p.N; ++n) {
    const size_t bn = (size_t)b * p.N + n, g = bn * p.H + h;
    __syncthreads();   // the previous row's readers are done
    load_rows<T, D>(static_cast<const T*>(p.q), qs, R, q0, p.Lq, p.H, (int)bn, h);
    load_rows<T, D>(static_cast<const T*>(p.dout), dos, R, q0, p.Lq, p.H, (int)bn, h);
    load_rows<T, D>(static_cast<const T*>(p.k), ks, K, k0, p.Lk, p.H, (int)bn, h);
    load_rows<T, D>(static_cast<const T*>(p.v), vs, K, k0, p.Lk, p.H, (int)bn, h);
    load_row_stats(p.lse, lse_s, R, g, q0, p.Lq);
    load_row_stats(p.delta, delta_s, R, g, q0, p.Lq);
    __syncthreads();
    float ds[SR][SC];
    raw_ds<D, R, K>(p, qs, dos, ks, vs, lse_s, delta_s, bn, q0, k0, b2v, ds);
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) acc[i][j] += ds[i][j];
  }

  float* db2 = static_cast<float*>(p.out0);
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int qpos = q0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int kpos = k0 + tx + 16 * j;
      if (qpos < p.Lq && kpos < p.Lk)
        db2[((size_t)bh2 * p.Lq + qpos) * p.Lk + kpos] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// dbias1: one block per (64-key tile, row (b, n)), summing dS over the heads
// and query tiles in order, then over the block's 8 row groups in order
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) evo_dbias1_kernel(Params p) {
  constexpr int DP = D + 1, R = kRows, K = kKeys;
  constexpr int SR = R / 8, SC = K / 16;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nkt = cdiv(p.Lk, K);
  const size_t bn = blockIdx.x / nkt;
  const int k0 = (int)(blockIdx.x % nkt) * K;
  const int b = (int)(bn / p.N);

  extern __shared__ float smem[];
  float* qs = smem;                      // [R][DP]
  float* dos = qs + R * DP;              // [R][DP]
  float* ks = dos + R * DP;              // [K][DP]
  float* vs = ks + K * DP;               // [K][DP]
  float* lse_s = vs + K * DP;            // [R]
  float* delta_s = lse_s + R;            // [R]
  float* red = delta_s + R;              // [8][K]

  float col[SC];
#pragma unroll
  for (int j = 0; j < SC; ++j) col[j] = 0.f;

  for (int h = 0; h < p.H; ++h) {
    const size_t g = bn * p.H + h;
    const int bh2 = b * p.H + h;
    __syncthreads();   // the previous head's readers are done with ks/vs
    load_rows<T, D>(static_cast<const T*>(p.k), ks, K, k0, p.Lk, p.H, (int)bn, h);
    load_rows<T, D>(static_cast<const T*>(p.v), vs, K, k0, p.Lk, p.H, (int)bn, h);
    for (int q0 = 0; q0 < p.Lq; q0 += R) {
      load_rows<T, D>(static_cast<const T*>(p.q), qs, R, q0, p.Lq, p.H, (int)bn, h);
      load_rows<T, D>(static_cast<const T*>(p.dout), dos, R, q0, p.Lq, p.H, (int)bn, h);
      load_row_stats(p.lse, lse_s, R, g, q0, p.Lq);
      load_row_stats(p.delta, delta_s, R, g, q0, p.Lq);
      __syncthreads();
      float b2v[SR][SC], ds[SR][SC];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int qpos = q0 + ty + 8 * i, kpos = k0 + tx + 16 * j;
          b2v[i][j] = (qpos < p.Lq && kpos < p.Lk) ? bias2_at(p, bh2, qpos, kpos) : 0.f;
        }
      raw_ds<D, R, K>(p, qs, dos, ks, vs, lse_s, delta_s, bn, q0, k0, b2v, ds);
#pragma unroll
      for (int j = 0; j < SC; ++j)
#pragma unroll
        for (int i = 0; i < SR; ++i) col[j] += ds[i][j];
      __syncthreads();   // readers done before the next query tile loads
    }
  }

#pragma unroll
  for (int j = 0; j < SC; ++j) red[ty * K + tx + 16 * j] = col[j];
  __syncthreads();
  if (tid < K && k0 + tid < p.Lk) {
    float sum = 0.f;
    for (int r = 0; r < kThreads / 16; ++r) sum += red[r * K + tid];
    static_cast<float*>(p.out0)[bn * p.Lk + k0 + tid] = sum;
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores: one block per (64-row query tile, group
// of G MSA rows of one (b, h)); warp group wg (4 warps) owns MSA row n0 + wg
// ---------------------------------------------------------------------------
constexpr int kMmaRows = 64;           // query rows of a tile: 4 warps x 16
constexpr int kMmaKeys = 64;           // keys of a tile (the online softmax's step)
constexpr int kBiasStride = kMmaKeys + 8;   // fp32 pair-bias tile row stride

template <int D, bool PAIR>
struct FwdMma {
  static constexpr int DK = D < 16 ? 16 : D;           // Q.K^T depth (D = 8 padded)
  static constexpr int RS = DK + 8;                    // bf16 tile row stride, elements
  static constexpr int G = PAIR && D < 128 ? 2 : 1;   // MSA rows a block walks
  static constexpr int kStages = 2;
  static constexpr int kTile = kMmaRows * RS * 2;      // bytes of a [64][RS] bf16 tile
  static constexpr int kBias2 = PAIR ? kMmaRows * kBiasStride * 4 : 0;
  static constexpr int kStage = 2 * G * kTile + kBias2 + G * kMmaKeys * 4;
  static constexpr int kSmem = G * kTile + kStages * kStage;
};

// Issue the copies of an fp32 [ROWS][64] tile, row r from src + r * ld
// (rows at or past `valid_rows` and columns at or past `cols` are zeros),
// into dst with row stride `stride` floats: 16-byte copies when every row
// start is 16-byte aligned (ld % 4 == 0), else 4-byte ones.
template <int ROWS, int THREADS>
__device__ __forceinline__ void issue_f32_tile(float* dst, int stride, const float* src,
                                               size_t ld, int valid_rows, int cols) {
  if (ld % 4 == 0) {
    constexpr int N = ROWS * (kMmaKeys / 4);
#pragma unroll
    for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (N % THREADS != 0 && e >= N) break;
      const int r = e / (kMmaKeys / 4), c = (e % (kMmaKeys / 4)) * 4;
      const bool valid = r < valid_rows && c < cols;
      warp_mma::cp_async_16(dst + r * stride + c, valid ? src + r * ld + c : src, valid);
    }
  } else {
    constexpr int N = ROWS * kMmaKeys;
#pragma unroll
    for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (N % THREADS != 0 && e >= N) break;
      const int r = e / kMmaKeys, c = e % kMmaKeys;
      const bool valid = r < valid_rows && c < cols;
      warp_mma::cp_async_4(dst + r * stride + c, valid ? src + r * ld + c : src, valid);
    }
  }
}

template <int D, bool PAIR>
__global__ void __launch_bounds__(kThreads * FwdMma<D, PAIR>::G)
evo_fwd_kernel_mma(Params p) {
  using F = FwdMma<D, PAIR>;
  using namespace warp_mma;
  using bf16 = __nv_bfloat16;
  constexpr int G = F::G, RS = F::RS, KS = F::DK / 16, NT = D / 8, ST = F::kStages;
  constexpr int THREADS = kThreads * G;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wg = warp / 4, row0 = (warp % 4) * 16;     // MSA row n0 + wg, rows row0..+15
  const int grp = lane / 4, tig = lane % 4;
  const int nqt = cdiv(p.Lq, kMmaRows), ngr = cdiv(p.N, G), nkt = cdiv(p.Lk, kMmaKeys);
  // blocks of one (b, h) and one group of rows are adjacent (their K/V
  // tiles meet in L2), then the groups of one (b, h) (its pair panel)
  const int qt = (int)(blockIdx.x % nqt);
  const int rest = (int)(blockIdx.x / nqt);
  const int n0 = (rest % ngr) * G, bh2 = rest / ngr;
  const int b = bh2 / p.H, h = bh2 % p.H;
  const int rows = min(G, p.N - n0), q0 = qt * kMmaRows;
  const bool live = wg < rows;                         // warp-uniform
  const size_t bn0 = (size_t)b * p.N + n0, bn = bn0 + wg;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);        // [G][64][RS]
  unsigned char* ring = smem_raw + G * F::kTile;       // [ST] stages
  // a stage: K [G][64][RS], V [G][64][RS] bf16; bias2 [64][kBiasStride]
  // fp32 (PAIR); bias1 [G][64] fp32
  auto k_of = [&](int s, int r) { return reinterpret_cast<bf16*>(ring + s * F::kStage + r * F::kTile); };
  auto v_of = [&](int s, int r) { return k_of(s, G + r); };
  auto b2_of = [&](int s) { return reinterpret_cast<float*>(ring + s * F::kStage + 2 * G * F::kTile); };
  auto b1_of = [&](int s, int r) {
    return reinterpret_cast<float*>(ring + s * F::kStage + 2 * G * F::kTile + F::kBias2) + r * kMmaKeys;
  };

  if constexpr (D < 16) {              // the zero pad of Q and K (never copied)
    for (int r = threadIdx.x; r < (1 + ST) * G * kMmaRows; r += THREADS) {
      const int t = r / kMmaRows, rr = r % kMmaRows;
      bf16* tile = t < G ? qs + t * (F::kTile / 2) : k_of((t - G) / G, (t - G) % G);
      *reinterpret_cast<uint4*>(tile + rr * RS + 8) = make_uint4(0, 0, 0, 0);
    }
  }
  const size_t ld = (size_t)p.H * D;                   // elements between rows
  // G [64][D] tiles of x [B*N, L, H, D] from position pos0 (rows of MSA
  // rows at or past `rows` all zeros), tile r at dst + r * F::kTile bytes;
  // `tile0` spreads consecutive calls' chunks over the threads
  auto issue_rows = [&](bf16* dst, const bf16* x, int pos0, int L, int tile0) {
#pragma unroll
    for (int r = 0; r < G; ++r)
      cp_async_tile<kMmaRows, D, RS, THREADS>(
          dst + r * (F::kTile / 2), r < rows ? x + ((bn0 + r) * L + pos0) * ld + h * D : x,
          ld, r < rows ? L - pos0 : 0, (tile0 + r) * kMmaRows * (D / 8));
  };
  issue_rows(qs, q, q0, p.Lq, 0);
  auto issue = [&](int kt) {           // key tile kt of the G rows into stage kt % ST
    const int s = kt % ST, k0 = kt * kMmaKeys;
    issue_rows(k_of(s, 0), k, k0, p.Lk, 0);
    issue_rows(v_of(s, 0), v, k0, p.Lk, G);
    if (PAIR)
      issue_f32_tile<kMmaRows, THREADS>(b2_of(s), kBiasStride,
                                        p.b2 + ((size_t)bh2 * p.Lq + q0) * p.Lk + k0, p.Lk,
                                        p.Lq - q0, p.Lk - k0);
    if (p.b1 != nullptr)
      issue_f32_tile<G, THREADS>(b1_of(s, 0), kMmaKeys, p.b1 + bn0 * p.Lk + k0, p.Lk, rows,
                                 p.Lk - k0);
  };
  for (int s = 0; s < ST - 1; ++s) {   // Q travels with key tile 0
    if (s < nkt) issue(s);
    cp_async_commit();
  }

  float acc[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float ninf = __int_as_float(0xff800000);
  const bf16* qw = qs + wg * (F::kTile / 2);

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<ST - 2>();                           // tile kt has landed (this thread's part)
    __syncthreads();                                   // ... everyone's; tile kt - 1 is done
    if (kt + ST - 1 < nkt) issue(kt + ST - 1);         // into the stage tile kt - 1 used
    cp_async_commit();
    if (!live) continue;
    const int s_idx = kt % ST, k0 = kt * kMmaKeys;
    const bf16* ks = k_of(s_idx, wg);
    const bf16* vs = v_of(s_idx, wg);

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qw + a_offset(lane, RS, row0, 16 * kk));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, ks + b_nk_offset(lane, RS, 16 * jp, 16 * kk));
        mma_m16n8k16_bf16(s[2 * jp], a, bb[0], bb[1]);
        mma_m16n8k16_bf16(s[2 * jp + 1], a, bb[2], bb[3]);
      }
    }
    // dot * scale, + bias1, + bias2, each rounded; dead keys -inf
    const float* b1s = b1_of(s_idx, wg);
    const float* b2s = PAIR ? b2_of(s_idx) : nullptr;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = 8 * j + 2 * tig;
        float2 b1v = make_float2(0.f, 0.f), b2v = make_float2(0.f, 0.f);
        if (p.b1 != nullptr) b1v = *reinterpret_cast<const float2*>(b1s + c0);
        if (PAIR) b2v = *reinterpret_cast<const float2*>(b2s + (row0 + grp + 8 * hr) * kBiasStride + c0);
        float x0 = __fmul_rn(s[j][2 * hr], p.scale), x1 = __fmul_rn(s[j][2 * hr + 1], p.scale);
        if (p.b1 != nullptr) {
          x0 = __fadd_rn(x0, b1v.x);
          x1 = __fadd_rn(x1, b1v.y);
        }
        if (PAIR) {
          x0 = __fadd_rn(x0, b2v.x);
          x1 = __fadd_rn(x1, b2v.y);
        }
        s[j][2 * hr] = x0;
        s[j][2 * hr + 1] = x1;
      }
    }
    if (k0 + kMmaKeys > p.Lk) {                        // the last tile's dead keys
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + c_col(lane, e) >= p.Lk) s[j][e] = ninf;
    }
    // online softmax of rows grp (hr 0) and grp + 8 (hr 1)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = ninf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float pv = expf(s[j][2 * hr + c] - m_new);
          s[j][2 * hr + c] = pv;
          sum += pv;
        }
      const float alpha = expf(m[hr] - m_new);
      l[hr] = __fadd_rn(__fmul_rn(l[hr], alpha), quad_sum(sum));
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2 * hr] *= alpha;
        acc[j][2 * hr + 1] *= alpha;
      }
    }
    // acc += round(P) V
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t a[4];
      a_from_c(a, s[2 * kk], s[2 * kk + 1]);
      if constexpr (D < 16) {
        uint32_t bb[2];
        ldsm_x2_t(bb, vs + b_kn_offset(lane, RS, 16 * kk, 0));
        mma_m16n8k16_bf16(acc[0], a, bb[0], bb[1]);
      } else {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bb[4];
          ldsm_x4_t(bb, vs + b_kn_offset(lane, RS, 16 * kk, 16 * dp));
          mma_m16n8k16_bf16(acc[2 * dp], a, bb[0], bb[1]);
          mma_m16n8k16_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();                                  // nothing in flight at exit
  if (!live) return;

  bf16* out = static_cast<bf16*>(p.out0);
  float* lse = static_cast<float*>(p.out1);
  const size_t g = bn * p.H + h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qpos = q0 + row0 + grp + 8 * hr;
    if (qpos >= p.Lq) continue;
    const float lv = fmaxf(l[hr], 1e-30f);
    bf16* dst = out + ((bn * p.Lq + qpos) * p.H + h) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[j][2 * hr] / lv, acc[j][2 * hr + 1] / lv);
    if (tig == 0) lse[g * p.Lq + qpos] = m[hr] + logf(lv);
  }
}

// Issue the copies of G rows of 64 fp32 per-query values (lse or delta):
// row r from x[((bn0 + r) * H + h) * Lq + q0], zeros for rows at or past
// `rows` and queries at or past Lq; 16-byte copies when Lq % 4 == 0 (every
// row start is then aligned), else 4-byte ones. Thread `first` takes the
// first chunk, so that two calls spread over the block.
template <int G, int THREADS>
__device__ __forceinline__ void issue_stats(float* dst, const float* x, const Params& p,
                                            size_t bn0, int h, int rows, int q0, int first) {
  const int tid = (threadIdx.x + THREADS - first) % THREADS;
  if (p.Lq % 4 == 0) {
    constexpr int N = G * kMmaRows / 4;
    static_assert(N <= THREADS, "one chunk a thread");
    if (tid < N) {
      const int r = tid / (kMmaRows / 4), c = (tid % (kMmaRows / 4)) * 4;
      const bool valid = r < rows && q0 + c < p.Lq;
      warp_mma::cp_async_16(dst + r * kMmaRows + c,
                            valid ? x + ((bn0 + r) * p.H + h) * p.Lq + q0 + c : x, valid);
    }
  } else {
    constexpr int N = G * kMmaRows;
    static_assert(N <= THREADS, "one value a thread");
    if (tid < N) {
      const int r = tid / kMmaRows, c = tid % kMmaRows;
      const bool valid = r < rows && q0 + c < p.Lq;
      warp_mma::cp_async_4(dst + r * kMmaRows + c,
                           valid ? x + ((bn0 + r) * p.H + h) * p.Lq + q0 + c : x, valid);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dK/dV on the tensor cores: one block per (64-key tile, group of G MSA
// rows of one (b, h)); warp group wg (4 warps x 16 keys) owns the key tile
// of MSA row n0 + wg and walks the 64-row query tiles
// ---------------------------------------------------------------------------
// Row stride (floats) of the pair-bias tile the backward reads transposed:
// the 8 keys x 4 query pairs of one read fall on 32 distinct banks.
constexpr int kBiasStrideT = kMmaKeys + 4;

// MSA rows a dK/dV block walks with a pair bias (`evo_bwd_plan` mirrors
// it), and the resident blocks an SM is built for at D <= 32 (the
// registers a thread may take follow from it)
constexpr int kDkvGroup = 2;
constexpr int kDkvMinBlocks = 2;
constexpr int kDb2MinBlocks = 3;

template <int D, bool PAIR>
struct DkvMma {
  static constexpr int DK = D < 16 ? 16 : D;           // K.Q^T depth (D = 8 padded)
  static constexpr int RS = DK + 8;                    // bf16 tile row stride, elements
  static constexpr int G = PAIR && D < 128 ? kDkvGroup : 1;   // MSA rows a block walks
  static constexpr int kStages = 2;
  static constexpr int kTile = kMmaRows * RS * 2;      // bytes of a [64][RS] bf16 tile
  static constexpr int kBias2 = PAIR ? kMmaRows * kBiasStrideT * 4 : 0;
  // a stage: Q [G][64][RS], dO [G][64][RS]; the pair tile; lse [G][64], delta [G][64]
  static constexpr int kStage = 2 * G * kTile + kBias2 + 2 * G * kMmaRows * 4;
  static constexpr int kSmem = 2 * G * kTile + kStages * kStage;   // + resident K, V
  static constexpr bool kFragsInRegs = D <= 64;        // K and V A fragments held
};

template <int D, bool PAIR>
__global__ void __launch_bounds__(kThreads * DkvMma<D, PAIR>::G, D <= 32 ? kDkvMinBlocks : 1)
evo_dkv_kernel_mma(Params p) {
  using F = DkvMma<D, PAIR>;
  using namespace warp_mma;
  using bf16 = __nv_bfloat16;
  constexpr int G = F::G, RS = F::RS, KS = F::DK / 16, NT = D / 8, ST = F::kStages;
  constexpr int THREADS = kThreads * G;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wg = warp / 4, row0 = (warp % 4) * 16;     // MSA row n0 + wg, keys row0..+15
  const int grp = lane / 4, tig = lane % 4;
  const int nkt = cdiv(p.Lk, kMmaKeys), ngr = cdiv(p.N, G), nqt = cdiv(p.Lq, kMmaRows);
  // blocks of one (b, h) and one group of rows are adjacent (their Q/dO
  // tiles meet in L2), then the groups of one (b, h) (its pair panel)
  const int kt = (int)(blockIdx.x % nkt);
  const int rest = (int)(blockIdx.x / nkt);
  const int n0 = (rest % ngr) * G, bh2 = rest / ngr;
  const int b = bh2 / p.H, h = bh2 % p.H;
  const int rows = min(G, p.N - n0), k0 = kt * kMmaKeys;
  const bool live = wg < rows;                         // warp-uniform
  const size_t bn0 = (size_t)b * p.N + n0, bn = bn0 + wg;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);        // [G][64][RS], resident
  bf16* vs = ks + G * (F::kTile / 2);                  // [G][64][RS], resident
  unsigned char* ring = smem_raw + 2 * G * F::kTile;   // [ST] stages
  auto q_of = [&](int s, int r) { return reinterpret_cast<bf16*>(ring + s * F::kStage + r * F::kTile); };
  auto do_of = [&](int s, int r) { return q_of(s, G + r); };
  auto b2_of = [&](int s) { return reinterpret_cast<float*>(ring + s * F::kStage + 2 * G * F::kTile); };
  auto lse_of = [&](int s, int r) {
    return reinterpret_cast<float*>(ring + s * F::kStage + 2 * G * F::kTile + F::kBias2) + r * kMmaRows;
  };
  auto delta_of = [&](int s, int r) { return lse_of(s, G + r); };

  if constexpr (D < 16) {              // the zero pad of K, V, Q and dO (never copied)
    for (int r = threadIdx.x; r < (2 + 2 * ST) * G * kMmaRows; r += THREADS) {
      const int t = r / kMmaRows, rr = r % kMmaRows;
      bf16* tile = t < 2 * G ? ks + t * (F::kTile / 2)
                             : q_of((t - 2 * G) / (2 * G), (t - 2 * G) % (2 * G));
      *reinterpret_cast<uint4*>(tile + rr * RS + 8) = make_uint4(0, 0, 0, 0);
    }
  }
  const size_t ld = (size_t)p.H * D;                   // elements between rows
  // G [64][D] tiles of x [B*N, L, H, D] from position pos0, as the forward's
  auto issue_rows = [&](bf16* dst, const bf16* x, int pos0, int L, int tile0) {
#pragma unroll
    for (int r = 0; r < G; ++r)
      cp_async_tile<kMmaRows, D, RS, THREADS>(
          dst + r * (F::kTile / 2), r < rows ? x + ((bn0 + r) * L + pos0) * ld + h * D : x,
          ld, r < rows ? L - pos0 : 0, (tile0 + r) * kMmaRows * (D / 8));
  };
  issue_rows(ks, k, k0, p.Lk, 0);                      // K and V travel with query tile 0
  issue_rows(vs, v, k0, p.Lk, G);
  auto issue = [&](int qt) {           // query tile qt of the G rows into stage qt % ST
    const int s = qt % ST, q0 = qt * kMmaRows;
    issue_rows(q_of(s, 0), q, q0, p.Lq, 2 * G);
    issue_rows(do_of(s, 0), dout, q0, p.Lq, 3 * G);
    if (PAIR)                          // [64 queries][64 keys]
      issue_f32_tile<kMmaRows, THREADS>(b2_of(s), kBiasStrideT,
                                        p.b2 + ((size_t)bh2 * p.Lq + q0) * p.Lk + k0, p.Lk,
                                        p.Lq - q0, p.Lk - k0);
    issue_stats<G, THREADS>(lse_of(s, 0), p.lse, p, bn0, h, rows, q0, 0);
    issue_stats<G, THREADS>(delta_of(s, 0), p.delta, p, bn0, h, rows, q0, THREADS / 2);
  };
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nqt) issue(s);
    cp_async_commit();
  }

  // bias1 of this thread's two keys (rows grp, grp + 8 of its 16)
  float b1v[2] = {0.f, 0.f};
  if (p.b1 != nullptr && live) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kpos = k0 + row0 + grp + 8 * hr;
      if (kpos < p.Lk) b1v[hr] = p.b1[bn * p.Lk + kpos];
    }
  }
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  uint32_t kf[F::kFragsInRegs ? KS : 1][4], vf[F::kFragsInRegs ? KS : 1][4];
  const bf16* kw = ks + wg * (F::kTile / 2);
  const bf16* vw = vs + wg * (F::kTile / 2);

  for (int qt = 0; qt < nqt; ++qt) {
    cp_async_wait<ST - 2>();                           // tile qt has landed (this thread's part)
    __syncthreads();                                   // ... everyone's; tile qt - 1 is done
    if (qt + ST - 1 < nqt) issue(qt + ST - 1);         // into the stage tile qt - 1 used
    cp_async_commit();
    if (!live) continue;
    if constexpr (F::kFragsInRegs) {
      if (qt == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(kf[kk], kw + a_offset(lane, RS, row0, 16 * kk));
          ldsm_x4(vf[kk], vw + a_offset(lane, RS, row0, 16 * kk));
        }
      }
    }
    const int s_idx = qt % ST, q0 = qt * kMmaRows;
    const bf16* qw = q_of(s_idx, wg);
    const bf16* dow = do_of(s_idx, wg);
    const float* b2s = PAIR ? b2_of(s_idx) : nullptr;
    const float* lse_s = lse_of(s_idx, wg);
    const float* delta_s = delta_of(s_idx, wg);
    const bool tail = q0 + kMmaRows > p.Lq;

#pragma unroll
    for (int c = 0; c < kMmaRows / 16; ++c) {        // 16 queries a step
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries a warp
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ak[4], av[4], bb[4];
        if constexpr (F::kFragsInRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[kk][i];
            av[i] = vf[kk][i];
          }
        } else {
          ldsm_x4(ak, kw + a_offset(lane, RS, row0, 16 * kk));
          ldsm_x4(av, vw + a_offset(lane, RS, row0, 16 * kk));
        }
        ldsm_x4(bb, qw + b_nk_offset(lane, RS, 16 * c, 16 * kk));
        mma_m16n8k16_bf16(st[0], ak, bb[0], bb[1]);
        mma_m16n8k16_bf16(st[1], ak, bb[2], bb[3]);
        ldsm_x4(bb, dow + b_nk_offset(lane, RS, 16 * c, 16 * kk));
        mma_m16n8k16_bf16(dpt[0], av, bb[0], bb[1]);
        mma_m16n8k16_bf16(dpt[1], av, bb[2], bb[3]);
      }
      // score = dot * scale, + bias1, + bias2 (each rounded); p = exp(score
      // - lse), 0 for dead queries; dS = p (dP - delta). st becomes p and
      // dpt dS * scale, both rounded to bf16 below (the A fragments).
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = 16 * c + 8 * j + 2 * tig;       // query column of elements 0 / 2
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 del2 = *reinterpret_cast<const float2*>(delta_s + qc);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int kr = row0 + grp + 8 * hr;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = __fmul_rn(st[j][2 * hr + e], p.scale);
            if (p.b1 != nullptr) x = __fadd_rn(x, b1v[hr]);
            if (PAIR) x = __fadd_rn(x, b2s[(qc + e) * kBiasStrideT + kr]);
            float pr = expf(x - (e ? lse2.y : lse2.x));
            if (tail && q0 + qc + e >= p.Lq) pr = 0.f;
            const float ds = pr * (dpt[j][2 * hr + e] - (e ? del2.y : del2.x));
            st[j][2 * hr + e] = pr;
            dpt[j][2 * hr + e] = ds * p.scale;
          }
        }
      }
      uint32_t ap[4], ads[4];
      a_from_c(ap, st[0], st[1]);                      // p.astype(dO.dtype)
      a_from_c(ads, dpt[0], dpt[1]);                   // (dS * scale).astype(q.dtype)
      // dV += P^T dO, dK += dS^T Q over these 16 queries
      if constexpr (D < 16) {
        uint32_t bb[2];
        ldsm_x2_t(bb, dow + b_kn_offset(lane, RS, 16 * c, 0));
        mma_m16n8k16_bf16(dv[0], ap, bb[0], bb[1]);
        ldsm_x2_t(bb, qw + b_kn_offset(lane, RS, 16 * c, 0));
        mma_m16n8k16_bf16(dk[0], ads, bb[0], bb[1]);
      } else {
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bb[4];
          ldsm_x4_t(bb, dow + b_kn_offset(lane, RS, 16 * c, 16 * dp));
          mma_m16n8k16_bf16(dv[2 * dp], ap, bb[0], bb[1]);
          mma_m16n8k16_bf16(dv[2 * dp + 1], ap, bb[2], bb[3]);
          ldsm_x4_t(bb, qw + b_kn_offset(lane, RS, 16 * c, 16 * dp));
          mma_m16n8k16_bf16(dk[2 * dp], ads, bb[0], bb[1]);
          mma_m16n8k16_bf16(dk[2 * dp + 1], ads, bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();                                  // nothing in flight at exit
  if (!live) return;

  bf16* dk_out = static_cast<bf16*>(p.out0);
  bf16* dv_out = static_cast<bf16*>(p.out1);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kpos = k0 + row0 + grp + 8 * hr;
    if (kpos >= p.Lk) continue;
    const size_t off = ((bn * p.Lk + kpos) * p.H + h) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(dk_out + off + 8 * j) = pack_bf16(dk[j][2 * hr], dk[j][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + off + 8 * j) = pack_bf16(dv[j][2 * hr], dv[j][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ on the tensor cores: one block per (64-row query tile, group of G
// MSA rows of one (b, h)); warp group wg (4 warps x 16 query rows) owns the
// query tile of MSA row n0 + wg and walks the 64-key tiles
// ---------------------------------------------------------------------------
// MSA rows a dQ block walks with a pair bias (`evo_bwd_plan` mirrors it),
// and the resident blocks an SM it is built for at D <= 32
constexpr int kDqGroup = 2;
constexpr int kDqMinBlocks = 2;

template <int D, bool PAIR>
struct DqMma {
  static constexpr int DK = D < 16 ? 16 : D;           // Q.K^T depth (D = 8 padded)
  static constexpr int RS = DK + 8;                    // bf16 tile row stride, elements
  static constexpr int G = PAIR && D < 128 ? kDqGroup : 1;   // MSA rows a block walks
  static constexpr int kStages = 2;
  static constexpr int kTile = kMmaRows * RS * 2;      // bytes of a [64][RS] bf16 tile
  static constexpr int kBias2 = PAIR ? kMmaRows * kBiasStride * 4 : 0;
  // a stage: K [G][64][RS], V [G][64][RS]; the pair tile; bias1 [G][64]
  static constexpr int kStage = 2 * G * kTile + kBias2 + G * kMmaKeys * 4;
  static constexpr int kSmem = 2 * G * kTile + kStages * kStage;   // + resident Q, dO
};

template <int D, bool PAIR>
__global__ void __launch_bounds__(kThreads * DqMma<D, PAIR>::G, D <= 32 ? kDqMinBlocks : 1)
evo_dq_kernel_mma(Params p) {
  using F = DqMma<D, PAIR>;
  using namespace warp_mma;
  using bf16 = __nv_bfloat16;
  constexpr int G = F::G, RS = F::RS, KS = F::DK / 16, NT = D / 8, ST = F::kStages;
  constexpr int THREADS = kThreads * G;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wg = warp / 4, row0 = (warp % 4) * 16;     // MSA row n0 + wg, rows row0..+15
  const int grp = lane / 4, tig = lane % 4;
  const int nqt = cdiv(p.Lq, kMmaRows), ngr = cdiv(p.N, G), nkt = cdiv(p.Lk, kMmaKeys);
  // the forward's block order: the query tiles of one group of rows, then
  // the groups of one (b, h)
  const int qt = (int)(blockIdx.x % nqt);
  const int rest = (int)(blockIdx.x / nqt);
  const int n0 = (rest % ngr) * G, bh2 = rest / ngr;
  const int b = bh2 / p.H, h = bh2 % p.H;
  const int rows = min(G, p.N - n0), q0 = qt * kMmaRows;
  const bool live = wg < rows;                         // warp-uniform
  const size_t bn0 = (size_t)b * p.N + n0, bn = bn0 + wg;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);        // [G][64][RS], resident
  bf16* dos = qs + G * (F::kTile / 2);                 // [G][64][RS], resident
  unsigned char* ring = smem_raw + 2 * G * F::kTile;   // [ST] stages
  auto k_of = [&](int s, int r) { return reinterpret_cast<bf16*>(ring + s * F::kStage + r * F::kTile); };
  auto v_of = [&](int s, int r) { return k_of(s, G + r); };
  auto b2_of = [&](int s) { return reinterpret_cast<float*>(ring + s * F::kStage + 2 * G * F::kTile); };
  auto b1_of = [&](int s, int r) {
    return reinterpret_cast<float*>(ring + s * F::kStage + 2 * G * F::kTile + F::kBias2) + r * kMmaKeys;
  };

  if constexpr (D < 16) {              // the zero pad of Q, dO, K and V (never copied)
    for (int r = threadIdx.x; r < (2 + 2 * ST) * G * kMmaRows; r += THREADS) {
      const int t = r / kMmaRows, rr = r % kMmaRows;
      bf16* tile = t < 2 * G ? qs + t * (F::kTile / 2)
                             : k_of((t - 2 * G) / (2 * G), (t - 2 * G) % (2 * G));
      *reinterpret_cast<uint4*>(tile + rr * RS + 8) = make_uint4(0, 0, 0, 0);
    }
  }
  const size_t ld = (size_t)p.H * D;                   // elements between rows
  // G [64][D] tiles of x [B*N, L, H, D] from position pos0, as the forward's
  auto issue_rows = [&](bf16* dst, const bf16* x, int pos0, int L, int tile0) {
#pragma unroll
    for (int r = 0; r < G; ++r)
      cp_async_tile<kMmaRows, D, RS, THREADS>(
          dst + r * (F::kTile / 2), r < rows ? x + ((bn0 + r) * L + pos0) * ld + h * D : x,
          ld, r < rows ? L - pos0 : 0, (tile0 + r) * kMmaRows * (D / 8));
  };
  issue_rows(qs, q, q0, p.Lq, 0);                      // Q and dO travel with key tile 0
  issue_rows(dos, dout, q0, p.Lq, G);
  auto issue = [&](int kt) {           // key tile kt of the G rows into stage kt % ST
    const int s = kt % ST, k0 = kt * kMmaKeys;
    issue_rows(k_of(s, 0), k, k0, p.Lk, 2 * G);
    issue_rows(v_of(s, 0), v, k0, p.Lk, 3 * G);
    if (PAIR)                          // [64 queries][64 keys]
      issue_f32_tile<kMmaRows, THREADS>(b2_of(s), kBiasStride,
                                        p.b2 + ((size_t)bh2 * p.Lq + q0) * p.Lk + k0, p.Lk,
                                        p.Lq - q0, p.Lk - k0);
    if (p.b1 != nullptr)
      issue_f32_tile<G, THREADS>(b1_of(s, 0), kMmaKeys, p.b1 + bn0 * p.Lk + k0, p.Lk, rows,
                                 p.Lk - k0);
  };
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nkt) issue(s);
    cp_async_commit();
  }

  // lse and delta of this thread's two rows (grp, grp + 8 of its 16); 0
  // for dead queries
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
  if (live) {
    const size_t g = bn * p.H + h;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qpos = q0 + row0 + grp + 8 * hr;
      if (qpos < p.Lq) {
        lse[hr] = p.lse[g * p.Lq + qpos];
        delta[hr] = p.delta[g * p.Lq + qpos];
      }
    }
  }
  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const bf16* qw = qs + wg * (F::kTile / 2);
  const bf16* dow = dos + wg * (F::kTile / 2);

  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<ST - 2>();                           // tile kt has landed (this thread's part)
    __syncthreads();                                   // ... everyone's; tile kt - 1 is done
    if (kt + ST - 1 < nkt) issue(kt + ST - 1);         // into the stage tile kt - 1 used
    cp_async_commit();
    if (!live) continue;
    const int s_idx = kt % ST, k0 = kt * kMmaKeys;
    const bf16* ks = k_of(s_idx, wg);
    const bf16* vs = v_of(s_idx, wg);

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, qw + a_offset(lane, RS, row0, 16 * kk));
      ldsm_x4(ado, dow + a_offset(lane, RS, row0, 16 * kk));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, ks + b_nk_offset(lane, RS, 16 * jp, 16 * kk));
        mma_m16n8k16_bf16(s[2 * jp], aq, bb[0], bb[1]);
        mma_m16n8k16_bf16(s[2 * jp + 1], aq, bb[2], bb[3]);
        ldsm_x4(bb, vs + b_nk_offset(lane, RS, 16 * jp, 16 * kk));
        mma_m16n8k16_bf16(dp[2 * jp], ado, bb[0], bb[1]);
        mma_m16n8k16_bf16(dp[2 * jp + 1], ado, bb[2], bb[3]);
      }
    }
    // score = dot * scale, + bias1, + bias2 (each rounded); p = exp(score -
    // lse), 0 for dead keys; s becomes dS * scale = p (dP - delta) * scale,
    // rounded to bf16 below (the A fragment)
    const float* b1s = b1_of(s_idx, wg);
    const float* b2s = PAIR ? b2_of(s_idx) : nullptr;
    const bool tail = k0 + kMmaKeys > p.Lk;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = 8 * j + 2 * tig;
        float2 b1v = make_float2(0.f, 0.f), b2v = make_float2(0.f, 0.f);
        if (p.b1 != nullptr) b1v = *reinterpret_cast<const float2*>(b1s + c0);
        if (PAIR) b2v = *reinterpret_cast<const float2*>(b2s + (row0 + grp + 8 * hr) * kBiasStride + c0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = __fmul_rn(s[j][2 * hr + e], p.scale);
          if (p.b1 != nullptr) x = __fadd_rn(x, e ? b1v.y : b1v.x);
          if (PAIR) x = __fadd_rn(x, e ? b2v.y : b2v.x);
          float pr = expf(x - lse[hr]);
          if (tail && k0 + c0 + e >= p.Lk) pr = 0.f;
          const float ds = pr * (dp[j][2 * hr + e] - delta[hr]);
          s[j][2 * hr + e] = ds * p.scale;
        }
      }
    }
    // dQ += round(dS * scale) K over these 64 keys
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      uint32_t a[4];
      a_from_c(a, s[2 * kk], s[2 * kk + 1]);           // (dS * scale).astype(k.dtype)
      if constexpr (D < 16) {
        uint32_t bb[2];
        ldsm_x2_t(bb, ks + b_kn_offset(lane, RS, 16 * kk, 0));
        mma_m16n8k16_bf16(dq[0], a, bb[0], bb[1]);
      } else {
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t bb[4];
          ldsm_x4_t(bb, ks + b_kn_offset(lane, RS, 16 * kk, 16 * dd));
          mma_m16n8k16_bf16(dq[2 * dd], a, bb[0], bb[1]);
          mma_m16n8k16_bf16(dq[2 * dd + 1], a, bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();                                  // nothing in flight at exit
  if (!live) return;

  bf16* dq_out = static_cast<bf16*>(p.out0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qpos = q0 + row0 + grp + 8 * hr;
    if (qpos >= p.Lq) continue;
    bf16* dst = dq_out + ((bn * p.Lq + qpos) * p.H + h) * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(dq[j][2 * hr], dq[j][2 * hr + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 dbias2 on the tensor cores: one block per (64 x 64 panel tile, split
// s of the N rows, panel (b, h)), 4 warps x 16 query rows, summing dS over
// the split's rows in order into `dst` (db2, or split s of the workspace)
// ---------------------------------------------------------------------------
template <int D>
struct Db2Mma {
  static constexpr int DK = D < 16 ? 16 : D;
  static constexpr int RS = DK + 8;
  static constexpr int kStages = D <= 32 ? 3 : 2;
  static constexpr int kTile = kMmaRows * RS * 2;
  // a stage: Q, dO [64 queries][RS], K, V [64 keys][RS] bf16; bias1 [64
  // keys], lse, delta [64 queries] fp32
  static constexpr int kStage = 4 * kTile + 3 * kMmaRows * 4;
  static constexpr int kSmem = kStages * kStage;
};

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? kDb2MinBlocks : 1)
evo_dbias2_kernel_mma(Params p, int splits, int per, float* dst) {
  using F = Db2Mma<D>;
  using namespace warp_mma;
  using bf16 = __nv_bfloat16;
  constexpr int RS = F::RS, KS = F::DK / 16, ST = F::kStages;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = warp * 16, grp = lane / 4, tig = lane % 4;
  const int nqt = cdiv(p.Lq, kMmaRows), nkt = cdiv(p.Lk, kMmaKeys);
  // the tiles of one (panel, split) are adjacent: they walk the same rows
  const int tile = (int)(blockIdx.x % (nqt * nkt));
  const int rest = (int)(blockIdx.x / (nqt * nkt));
  const int split = rest % splits, bh2 = rest / splits;
  const int q0 = (tile / nkt) * kMmaRows, k0 = (tile % nkt) * kMmaKeys;
  const int b = bh2 / p.H, h = bh2 % p.H;
  const int n_begin = split * per, steps = min(p.N, n_begin + per) - n_begin;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto tile_of = [&](int s, int t) {   // t: 0 Q, 1 dO, 2 K, 3 V
    return reinterpret_cast<bf16*>(smem_raw + s * F::kStage + t * F::kTile);
  };
  auto vec_of = [&](int s, int t) {    // t: 0 bias1, 1 lse, 2 delta
    return reinterpret_cast<float*>(smem_raw + s * F::kStage + 4 * F::kTile) + t * kMmaRows;
  };
  if constexpr (D < 16) {              // the zero pad of every tile (never copied)
    for (int r = threadIdx.x; r < ST * 4 * kMmaRows; r += kThreads)
      *reinterpret_cast<uint4*>(tile_of(r / (4 * kMmaRows), (r / kMmaRows) % 4) +
                                (r % kMmaRows) * RS + 8) = make_uint4(0, 0, 0, 0);
  }
  const size_t ld = (size_t)p.H * D;
  auto issue = [&](int i) {            // MSA row n_begin + i into stage i % ST
    const int s = i % ST;
    const size_t bn = (size_t)b * p.N + n_begin + i;
    cp_async_tile<kMmaRows, D, RS, kThreads>(tile_of(s, 0), q + (bn * p.Lq + q0) * ld + h * D,
                                             ld, p.Lq - q0, 0);
    cp_async_tile<kMmaRows, D, RS, kThreads>(tile_of(s, 1), dout + (bn * p.Lq + q0) * ld + h * D,
                                             ld, p.Lq - q0, kMmaRows * (D / 8));
    cp_async_tile<kMmaRows, D, RS, kThreads>(tile_of(s, 2), k + (bn * p.Lk + k0) * ld + h * D,
                                             ld, p.Lk - k0, 2 * kMmaRows * (D / 8));
    cp_async_tile<kMmaRows, D, RS, kThreads>(tile_of(s, 3), v + (bn * p.Lk + k0) * ld + h * D,
                                             ld, p.Lk - k0, 3 * kMmaRows * (D / 8));
    if (p.b1 != nullptr)
      issue_f32_tile<1, kThreads>(vec_of(s, 0), kMmaKeys, p.b1 + bn * p.Lk + k0, p.Lk, 1,
                                  p.Lk - k0);
    issue_stats<1, kThreads>(vec_of(s, 1), p.lse, p, bn, h, 1, q0, 0);
    issue_stats<1, kThreads>(vec_of(s, 2), p.delta, p, bn, h, 1, q0, kThreads / 2);
  };
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  // this thread's pair-bias values and sums, in C-fragment layout: tile j,
  // element e is (query row0 + grp + 8 (e / 2), key 8 j + 2 tig + e % 2)
  float b2v[8][4], acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qpos = q0 + row0 + c_row(lane, e), kpos = k0 + 8 * j + c_col(lane, e);
      b2v[j][e] = qpos < p.Lq && kpos < p.Lk ? p.b2[((size_t)bh2 * p.Lq + qpos) * p.Lk + kpos] : 0.f;
      acc[j][e] = 0.f;
    }

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<ST - 2>();                           // row i has landed (this thread's part)
    __syncthreads();                                   // ... everyone's; row i - 1 is done
    if (i + ST - 1 < steps) issue(i + ST - 1);
    cp_async_commit();
    const int s_idx = i % ST;
    const bf16* qs = tile_of(s_idx, 0);
    const bf16* dos = tile_of(s_idx, 1);
    const bf16* ks = tile_of(s_idx, 2);
    const bf16* vs = tile_of(s_idx, 3);
    const float* b1s = vec_of(s_idx, 0);
    const float* lse_s = vec_of(s_idx, 1);
    const float* delta_s = vec_of(s_idx, 2);
    // S = Q K^T and dP = dO V^T: 16 queries x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, qs + a_offset(lane, RS, row0, 16 * kk));
      ldsm_x4(ado, dos + a_offset(lane, RS, row0, 16 * kk));
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, ks + b_nk_offset(lane, RS, 16 * jp, 16 * kk));
        mma_m16n8k16_bf16(s[2 * jp], aq, bb[0], bb[1]);
        mma_m16n8k16_bf16(s[2 * jp + 1], aq, bb[2], bb[3]);
        ldsm_x4(bb, vs + b_nk_offset(lane, RS, 16 * jp, 16 * kk));
        mma_m16n8k16_bf16(dp[2 * jp], ado, bb[0], bb[1]);
        mma_m16n8k16_bf16(dp[2 * jp + 1], ado, bb[2], bb[3]);
      }
    }
    // acc += p (dP - delta), p = exp(dot * scale + bias1 + bias2 - lse);
    // dead queries and keys are never written, so they need no mask
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float lse = lse_s[row0 + grp + 8 * hr], delta = delta_s[row0 + grp + 8 * hr];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2 b1v = make_float2(0.f, 0.f);
        if (p.b1 != nullptr) b1v = *reinterpret_cast<const float2*>(b1s + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = __fmul_rn(s[j][2 * hr + e], p.scale);
          if (p.b1 != nullptr) x = __fadd_rn(x, e ? b1v.y : b1v.x);
          x = __fadd_rn(x, b2v[j][2 * hr + e]);
          const float pr = expf(x - lse);
          acc[j][2 * hr + e] += pr * (dp[j][2 * hr + e] - delta);
        }
      }
    }
  }
  cp_async_wait<0>();                                  // nothing in flight at exit

  float* out = dst + (size_t)split * p.B * p.H * p.Lq * p.Lk;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qpos = q0 + row0 + c_row(lane, e), kpos = k0 + 8 * j + c_col(lane, e);
      if (qpos < p.Lq && kpos < p.Lk) out[((size_t)bh2 * p.Lq + qpos) * p.Lk + kpos] = acc[j][e];
    }
}

// db2 = the splits' partials summed in split order (deterministic).
__global__ void __launch_bounds__(256)
evo_dbias2_combine_kernel(const float* __restrict__ ws, float* __restrict__ db2, size_t n,
                          int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = ws[i];
    for (int s = 1; s < splits; ++s) sum += ws[(size_t)s * n + i];
    db2[i] = sum;
  }
}

// ---------------------------------------------------------------------------
// bf16 dbias1 on the tensor cores: one block per (64-key tile, group of G MSA
// rows of one b); warp group wg (4 warps x 16 keys) owns the key tile of MSA
// row n0 + wg and walks the heads and, in each, the 64-row query tiles
// ---------------------------------------------------------------------------
// MSA rows a dbias1 block walks (`evo_bwd_plan` mirrors it), and the
// resident blocks an SM it is built for at D <= 32: one row a block, three
// blocks an SM, beat two rows sharing each pair tile, two blocks an SM, by
// 10% at E1 (PERF.md)
constexpr int kDb1Group = 1;
constexpr int kDb1MinBlocks = 3;

template <int D>
struct Db1Mma {
  static constexpr int DK = D < 16 ? 16 : D;           // K.Q^T depth (D = 8 padded)
  static constexpr int RS = DK + 8;                    // bf16 tile row stride, elements
  static constexpr int G = D < 128 ? kDb1Group : 1;    // MSA rows a block walks
  static constexpr int kStages = 2;
  static constexpr int kTile = kMmaRows * RS * 2;      // bytes of a [64][RS] bf16 tile
  static constexpr int kBias2 = kMmaRows * kBiasStrideT * 4;
  // a stage: Q [G][64][RS], dO [G][64][RS]; the pair tile (with a pair
  // bias); lse [G][64], delta [G][64]
  __host__ __device__ static constexpr int stage(bool pair) {
    return 2 * G * kTile + (pair ? kBias2 : 0) + 2 * G * kMmaRows * 4;
  }
  __host__ __device__ static constexpr int smem(bool pair) {   // + K, V of one head
    return 2 * G * kTile + kStages * stage(pair);
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads * Db1Mma<D>::G, D <= 32 ? kDb1MinBlocks : 1)
evo_dbias1_kernel_mma(Params p) {
  using F = Db1Mma<D>;
  using namespace warp_mma;
  using bf16 = __nv_bfloat16;
  constexpr int G = F::G, RS = F::RS, KS = F::DK / 16, ST = F::kStages;
  constexpr int THREADS = kThreads * G;
  const bool pair = p.b2 != nullptr;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wg = warp / 4, row0 = (warp % 4) * 16;     // MSA row n0 + wg, keys row0..+15
  const int grp = lane / 4, tig = lane % 4;
  const int nkt = cdiv(p.Lk, kMmaKeys), ngr = cdiv(p.N, G), nqt = cdiv(p.Lq, kMmaRows);
  // the key tiles of one group of rows are adjacent (their Q/dO tiles meet
  // in L2), then the groups of one b
  const int kt = (int)(blockIdx.x % nkt);
  const int rest = (int)(blockIdx.x / nkt);
  const int n0 = (rest % ngr) * G, b = rest / ngr;
  const int rows = min(G, p.N - n0), k0 = kt * kMmaKeys;
  const bool live = wg < rows;                         // warp-uniform
  const size_t bn0 = (size_t)b * p.N + n0, bn = bn0 + wg;
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  const int stage_bytes = F::stage(pair);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);        // [G][64][RS], one head's
  bf16* vs = ks + G * (F::kTile / 2);                  // [G][64][RS]
  unsigned char* ring = smem_raw + 2 * G * F::kTile;   // [ST] stages
  auto q_of = [&](int s, int r) {
    return reinterpret_cast<bf16*>(ring + s * stage_bytes + r * F::kTile);
  };
  auto do_of = [&](int s, int r) { return q_of(s, G + r); };
  auto b2_of = [&](int s) {
    return reinterpret_cast<float*>(ring + s * stage_bytes + 2 * G * F::kTile);
  };
  auto lse_of = [&](int s, int r) {
    return reinterpret_cast<float*>(ring + s * stage_bytes + 2 * G * F::kTile +
                                    (pair ? F::kBias2 : 0)) + r * kMmaRows;
  };
  auto delta_of = [&](int s, int r) { return lse_of(s, G + r); };

  if constexpr (D < 16) {              // the zero pad of K, V, Q and dO (never copied)
    for (int r = threadIdx.x; r < (2 + 2 * ST) * G * kMmaRows; r += THREADS) {
      const int t = r / kMmaRows, rr = r % kMmaRows;
      bf16* tile = t < 2 * G ? ks + t * (F::kTile / 2)
                             : q_of((t - 2 * G) / (2 * G), (t - 2 * G) % (2 * G));
      *reinterpret_cast<uint4*>(tile + rr * RS + 8) = make_uint4(0, 0, 0, 0);
    }
  }
  const size_t ld = (size_t)p.H * D;                   // elements between rows
  // G [64][D] tiles of head h of x [B*N, L, H, D] from position pos0, as the
  // forward's
  auto issue_rows = [&](bf16* dst, const bf16* x, int pos0, int L, int h, int tile0) {
#pragma unroll
    for (int r = 0; r < G; ++r)
      cp_async_tile<kMmaRows, D, RS, THREADS>(
          dst + r * (F::kTile / 2), r < rows ? x + ((bn0 + r) * L + pos0) * ld + h * D : x,
          ld, r < rows ? L - pos0 : 0, (tile0 + r) * kMmaRows * (D / 8));
  };
  // step u is (head u / nqt, query tile u % nqt) of the G rows, into stage
  // u % ST; a head's first step brings its K and V too, into the one K/V
  // slot, which every warp has copied into registers by then (below)
  const int steps = p.H * nqt;
  auto issue = [&](int u) {
    const int s = u % ST, h = u / nqt, q0 = (u % nqt) * kMmaRows;
    if (u % nqt == 0) {
      issue_rows(ks, k, k0, p.Lk, h, 0);
      issue_rows(vs, v, k0, p.Lk, h, G);
    }
    issue_rows(q_of(s, 0), q, q0, p.Lq, h, 2 * G);
    issue_rows(do_of(s, 0), dout, q0, p.Lq, h, 3 * G);
    if (pair)                          // [64 queries][64 keys] of panel (b, h)
      issue_f32_tile<kMmaRows, THREADS>(b2_of(s), kBiasStrideT,
                                        p.b2 + (((size_t)b * p.H + h) * p.Lq + q0) * p.Lk + k0,
                                        p.Lk, p.Lq - q0, p.Lk - k0);
    issue_stats<G, THREADS>(lse_of(s, 0), p.lse, p, bn0, h, rows, q0, 0);
    issue_stats<G, THREADS>(delta_of(s, 0), p.delta, p, bn0, h, rows, q0, THREADS / 2);
  };
  for (int s = 0; s < ST - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  // bias1 of this thread's two keys (rows grp, grp + 8 of its 16); 0 for
  // dead keys, whose sums are never written
  float b1v[2] = {0.f, 0.f};
  if (live) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kpos = k0 + row0 + grp + 8 * hr;
      if (kpos < p.Lk) b1v[hr] = p.b1[bn * p.Lk + kpos];
    }
  }
  // the raw dS of keys grp and grp + 8, summed over heads, query tiles and
  // this thread's query columns, in that order
  float acc[2] = {0.f, 0.f};
  uint32_t kf[KS][4], vf[KS][4];                       // this warp's K and V A fragments
  const bf16* kw = ks + wg * (F::kTile / 2);
  const bf16* vw = vs + wg * (F::kTile / 2);

  for (int u = 0; u < steps; ++u) {
    cp_async_wait<ST - 2>();                           // step u has landed (this thread's part)
    __syncthreads();                                   // ... everyone's; step u - 1 is done
    const int q0 = (u % nqt) * kMmaRows;
    if (u % nqt == 0) {                                // a new head: K and V into registers
      if (live) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_x4(kf[kk], kw + a_offset(lane, RS, row0, 16 * kk));
          ldsm_x4(vf[kk], vw + a_offset(lane, RS, row0, 16 * kk));
        }
      }
      __syncthreads();                                 // the slot is free for the next head
    }
    if (u + ST - 1 < steps) issue(u + ST - 1);         // into the stage step u - 1 used
    cp_async_commit();
    if (!live) continue;
    const int s_idx = u % ST;
    const bf16* qw = q_of(s_idx, wg);
    const bf16* dow = do_of(s_idx, wg);
    const float* b2s = b2_of(s_idx);
    const float* lse_s = lse_of(s_idx, wg);
    const float* delta_s = delta_of(s_idx, wg);
    const bool tail = q0 + kMmaRows > p.Lq;

#pragma unroll
    for (int c = 0; c < kMmaRows / 16; ++c) {        // 16 queries a step
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 16 queries a warp
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bb[4];
        ldsm_x4(bb, qw + b_nk_offset(lane, RS, 16 * c, 16 * kk));
        mma_m16n8k16_bf16(st[0], kf[kk], bb[0], bb[1]);
        mma_m16n8k16_bf16(st[1], kf[kk], bb[2], bb[3]);
        ldsm_x4(bb, dow + b_nk_offset(lane, RS, 16 * c, 16 * kk));
        mma_m16n8k16_bf16(dpt[0], vf[kk], bb[0], bb[1]);
        mma_m16n8k16_bf16(dpt[1], vf[kk], bb[2], bb[3]);
      }
      // score = dot * scale, + bias1, + bias2 (each rounded); p = exp(score
      // - lse), 0 for dead queries; the raw dS = p (dP - delta), summed per key
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = 16 * c + 8 * j + 2 * tig;       // query column of elements 0 / 2
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + qc);
        const float2 del2 = *reinterpret_cast<const float2*>(delta_s + qc);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int kr = row0 + grp + 8 * hr;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = __fmul_rn(st[j][2 * hr + e], p.scale);
            x = __fadd_rn(x, b1v[hr]);
            if (pair) x = __fadd_rn(x, b2s[(qc + e) * kBiasStrideT + kr]);
            float pr = expf(x - (e ? lse2.y : lse2.x));
            if (tail && q0 + qc + e >= p.Lq) pr = 0.f;
            acc[hr] += pr * (dpt[j][2 * hr + e] - (e ? del2.y : del2.x));
          }
        }
      }
    }
  }
  cp_async_wait<0>();                                  // nothing in flight at exit
  if (!live) return;

  float* db1 = static_cast<float*>(p.out0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float sum = quad_sum(acc[hr]);               // the 4 lanes of a key, fixed order
    const int kpos = k0 + row0 + grp + 8 * hr;
    if (tig == 0 && kpos < p.Lk) db1[bn * p.Lk + kpos] = sum;
  }
}

// kFwdMma / kFwdMmaNoPair: the bf16 forward's bytes with / without a pair
// bias; kDkvMma / kDkvMmaNoPair the bf16 dK/dV's; kDb2Mma the bf16
// dbias2's; kDqMma / kDqMmaNoPair the bf16 dQ's; kDb1Mma / kDb1MmaNoPair
// the bf16 dbias1's (for `dstt_evo_smem_bytes` alone; launches say kFwd,
// kDq, kDkv, kDb2, kDb1).
enum Which {
  kFwd = 0, kDq = 1, kDkv = 2, kDb2 = 3, kDb1 = 4, kFwdMma = 5, kFwdMmaNoPair = 6,
  kDkvMma = 7, kDkvMmaNoPair = 8, kDb2Mma = 9, kDqMma = 10, kDqMmaNoPair = 11,
  kDb1Mma = 12, kDb1MmaNoPair = 13
};

template <int D>
int smem_bytes(int which) {
  switch (which) {
    case kFwd: return fwd_smem_floats<D>() * (int)sizeof(float);
    case kFwdMma: return FwdMma<D, true>::kSmem;
    case kFwdMmaNoPair: return FwdMma<D, false>::kSmem;
    case kDkvMma: return DkvMma<D, true>::kSmem;
    case kDkvMmaNoPair: return DkvMma<D, false>::kSmem;
    case kDb2Mma: return Db2Mma<D>::kSmem;
    case kDqMma: return DqMma<D, true>::kSmem;
    case kDqMmaNoPair: return DqMma<D, false>::kSmem;
    case kDb1Mma: return Db1Mma<D>::smem(true);
    case kDb1MmaNoPair: return Db1Mma<D>::smem(false);
    case kDq: return dq_smem_floats<D>() * (int)sizeof(float);
    case kDkv: return dkv_smem_floats<D>() * (int)sizeof(float);
    case kDb2:
    case kDb1: return dbias_smem_floats<D>() * (int)sizeof(float);
  }
  return -1;
}

// Launch a tensor-core kernel tiled as F (FwdMma, DqMma or DkvMma: one
// kernel each) over `tiles` tiles of each of the B*H*cdiv(N, G) groups of
// MSA rows.
template <typename F>
cudaError_t launch_groups(void (*kernel)(Params), int tiles, const Params& p,
                          cudaStream_t stream) {
  const long long blocks = (long long)p.B * p.H * cdiv(p.N, F::G) * tiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  static bool configured = false;                      // per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<(unsigned)blocks, kThreads * F::G, F::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool PAIR>
cudaError_t launch_fwd_mma(const Params& p, cudaStream_t stream) {
  return launch_groups<FwdMma<D, PAIR>>(evo_fwd_kernel_mma<D, PAIR>, cdiv(p.Lq, kMmaRows), p,
                                        stream);
}

template <int D, bool PAIR>
cudaError_t launch_dq_mma(const Params& p, cudaStream_t stream) {
  return launch_groups<DqMma<D, PAIR>>(evo_dq_kernel_mma<D, PAIR>, cdiv(p.Lq, kMmaRows), p,
                                       stream);
}

template <int D, bool PAIR>
cudaError_t launch_dkv_mma(const Params& p, cudaStream_t stream) {
  return launch_groups<DkvMma<D, PAIR>>(evo_dkv_kernel_mma<D, PAIR>, cdiv(p.Lk, kMmaKeys), p,
                                        stream);
}

// The bf16 dbias1 (a mask takes a gradient) into db1 (p.out0).
template <int D>
cudaError_t launch_db1_mma(const Params& p, cudaStream_t stream) {
  using F = Db1Mma<D>;
  if (p.b1 == nullptr) return cudaErrorInvalidValue;
  const long long blocks = (long long)p.B * cdiv(p.N, F::G) * cdiv(p.Lk, kMmaKeys);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  static bool configured = false;                      // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        evo_dbias1_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::smem(true));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  evo_dbias1_kernel_mma<D><<<(unsigned)blocks, kThreads * F::G, F::smem(p.b2 != nullptr),
                             stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t configure_db2_mma() {
  static bool configured = false;                      // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        evo_dbias2_kernel_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Db2Mma<D>::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

// The bf16 dbias2 over `splits` splits of the N rows (each of cdiv(N,
// splits) rows, none empty): one split writes db2 (p.out0) itself; more
// write their partials to ws [splits][B*H*Lq*Lk] and the combine sums them.
template <int D>
cudaError_t launch_db2_mma(const Params& p, float* ws, int splits, cudaStream_t stream) {
  if (p.b2 == nullptr || splits < 1 || splits > p.N || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const int per = cdiv(p.N, splits);
  if (cdiv(p.N, per) != splits) return cudaErrorInvalidValue;   // an empty split
  const long long blocks =
      (long long)p.B * p.H * splits * cdiv(p.Lq, kMmaRows) * cdiv(p.Lk, kMmaKeys);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = configure_db2_mma<D>();
  if (err != cudaSuccess) return err;
  float* db2 = static_cast<float*>(p.out0);
  evo_dbias2_kernel_mma<D><<<(unsigned)blocks, kThreads, Db2Mma<D>::kSmem, stream>>>(
      p, splits, per, splits > 1 ? ws : db2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)p.B * p.H * p.Lq * p.Lk;
  const unsigned grid = (unsigned)std::min<size_t>((n + 255) / 256, 4096);
  evo_dbias2_combine_kernel<<<grid, 256, 0, stream>>>(ws, db2, n, splits);
  return cudaGetLastError();
}

// Resident bf16 dbias2 blocks on one SM (occupancy calculator), or minus a
// CUDA error code.
template <int D>
int db2_blocks_per_sm() {
  cudaError_t err = configure_db2_mma<D>();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, evo_dbias2_kernel_mma<D>, kThreads,
                                                        Db2Mma<D>::kSmem);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename T, int D>
cudaError_t launch(int which, const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {                     // bf16: the tensor cores
    if (which == kDb1) return launch_db1_mma<D>(p, stream);
    if (which == kFwd)
      return p.b2 != nullptr ? launch_fwd_mma<D, true>(p, stream)
                             : launch_fwd_mma<D, false>(p, stream);
    if (which == kDq)
      return p.b2 != nullptr ? launch_dq_mma<D, true>(p, stream)
                             : launch_dq_mma<D, false>(p, stream);
    if (which == kDkv)
      return p.b2 != nullptr ? launch_dkv_mma<D, true>(p, stream)
                             : launch_dkv_mma<D, false>(p, stream);
    if (which == kDb2) return launch_db2_mma<D>(p, nullptr, 1, stream);
  }
  void (*kernel)(Params) = nullptr;
  const long long rows = (long long)p.B * p.N * p.H;
  long long blocks = 0;
  switch (which) {
    case kFwd:                                         // fp32 (bf16 returned above)
      if constexpr (sizeof(T) == 4) kernel = evo_fwd_kernel<T, D>;
      blocks = rows * cdiv(p.Lq, kRows);
      break;
    case kDq:                                          // fp32 (bf16 returned above)
      if constexpr (sizeof(T) == 4) kernel = evo_dq_kernel<T, D>;
      blocks = rows * cdiv(p.Lq, kRows);
      break;
    case kDkv:                                         // fp32 (bf16 returned above)
      if constexpr (sizeof(T) == 4) kernel = evo_dkv_kernel<T, D>;
      blocks = rows * cdiv(p.Lk, kDkvKeys);
      break;
    case kDb2:                                         // fp32 (bf16 returned above)
      if (p.b2 == nullptr) return cudaErrorInvalidValue;
      if constexpr (sizeof(T) == 4) kernel = evo_dbias2_kernel<T, D>;
      blocks = (long long)p.B * p.H * cdiv(p.Lq, kRows) * cdiv(p.Lk, kKeys);
      break;
    case kDb1:                                         // fp32 (bf16 returned above)
      if (p.b1 == nullptr) return cudaErrorInvalidValue;
      if constexpr (sizeof(T) == 4) kernel = evo_dbias1_kernel<T, D>;
      blocks = (long long)p.B * p.N * cdiv(p.Lk, kKeys);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int smem = smem_bytes<D>(which);
  static bool configured[5] = {false, false, false, false, false};   // per instantiation
  if (!configured[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[which] = true;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pick_dim(int which, const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 8: return launch<T, 8>(which, p, stream);
    case 16: return launch<T, 16>(which, p, stream);
    case 32: return launch<T, 32>(which, p, stream);
    case 64: return launch<T, 64>(which, p, stream);
    case 128: return launch<T, 128>(which, p, stream);
  }
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* b1, const void* b2, const void* lse, const void* delta,
                   void* out0, void* out1, int B, int N, int Lq, int Lk, int H, float scale) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
  p.B = B; p.N = N; p.Lq = Lq; p.Lk = Lk; p.H = H;
  p.scale = scale;
  return p;
}

}  // namespace

// Dynamic shared memory (bytes) of kernel `which` (0 forward, 1 dQ, 2 dK/dV,
// 3 dbias2, 4 dbias1 for fp32; 5 the bf16 forward with a pair bias, 6
// without; 7 the bf16 dK/dV with a pair bias, 8 without; 9 the bf16 dbias2;
// 10 the bf16 dQ with a pair bias, 11 without; 12 the bf16 dbias1 with a
// pair bias, 13 without) at `head_dim`; -1 for an instantiation not
// compiled.
extern "C" int dstt_evo_smem_bytes(int which, int head_dim) {
  switch (head_dim) {
    case 8: return smem_bytes<8>(which);
    case 16: return smem_bytes<16>(which);
    case 32: return smem_bytes<32>(which);
    case 64: return smem_bytes<64>(which);
    case 128: return smem_bytes<128>(which);
  }
  return -1;
}

// Launch kernel `which` (as above) on `stream`. All pointers are device
// pointers, contiguous: q/dout [B,N,Lq,H,D], k/v [B,N,Lk,H,D] in `dtype`
// (0 float32, 1 bfloat16); b1 fp32 [B,N,Lk] or null; b2 fp32 [B,H,Lq,Lk] or
// null; lse/delta fp32 [B,N,H,Lq]. Outputs: forward out0 = out (like q),
// out1 = lse; dQ out0 = dq; dK/dV out0 = dk, out1 = dv; dbias2 out0 = db2
// fp32 [B,H,Lq,Lk]; dbias1 out0 = db1 fp32 [B,N,Lk]. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dstt_evo_launch(int which, const void* q, const void* k, const void* v,
                               const void* dout, const void* b1, const void* b2,
                               const void* lse, const void* delta, void* out0, void* out1,
                               int B, int N, int Lq, int Lk, int H, int head_dim,
                               float scale, int dtype, void* stream) {
  if (B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, b1, b2, lse, delta, out0, out1, B, N, Lq, Lk, H,
                               scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)pick_dim<float>(which, p, head_dim, s);
  if (dtype == 1) return (int)pick_dim<__nv_bfloat16>(which, p, head_dim, s);
  return (int)cudaErrorInvalidValue;
}

// Params as dstt_evo_launch's, for a bias2 gradient: db2 fp32 [B,H,Lq,Lk];
// bf16 sums N in `splits` splits of cdiv(N, splits) rows each (none empty),
// their partials in ws, fp32 [splits, B, H, Lq, Lk] (null for one split),
// then combines them in split order; fp32 takes one split. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int dstt_evo_dbias2(const void* q, const void* k, const void* v, const void* dout,
                               const void* b1, const void* b2, const void* lse,
                               const void* delta, void* db2, void* ws, int B, int N, int Lq,
                               int Lk, int H, int head_dim, float scale, int dtype, int splits,
                               void* stream) {
  if (B <= 0 || N <= 0 || Lq <= 0 || Lk <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, b1, b2, lse, delta, db2, nullptr, B, N, Lq, Lk, H,
                               scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return splits == 1 ? (int)pick_dim<float>(kDb2, p, head_dim, s) : (int)cudaErrorInvalidValue;
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  switch (head_dim) {
    case 8: return (int)launch_db2_mma<8>(p, w, splits, s);
    case 16: return (int)launch_db2_mma<16>(p, w, splits, s);
    case 32: return (int)launch_db2_mma<32>(p, w, splits, s);
    case 64: return (int)launch_db2_mma<64>(p, w, splits, s);
    case 128: return (int)launch_db2_mma<128>(p, w, splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Resident bf16 dbias2 blocks on one SM of the current device at
// `head_dim` (occupancy calculator), or minus a CUDA error code (-1 for a
// head dim not compiled).
extern "C" int dstt_evo_dbias2_blocks_per_sm(int head_dim) {
  switch (head_dim) {
    case 8: return db2_blocks_per_sm<8>();
    case 16: return db2_blocks_per_sm<16>();
    case 32: return db2_blocks_per_sm<32>();
    case 64: return db2_blocks_per_sm<64>();
    case 128: return db2_blocks_per_sm<128>();
  }
  return -1;
}
