// Evoformer (DS4Science) attention for Hopper (sm_90a): the forward with its
// per-row logsumexp, the dQ and dK/dV backward kernels, and the two
// bias-gradient reductions.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/evoformer.py:
//   evo_fwd_kernel    <- `_evo_fwd_kernel`    (wrapper `_evo_fwd_impl`)
//   evo_dq_kernel     <- `_evo_dq_kernel`     (wrapper `_evo_bwd_impl`)
//   evo_dkv_kernel    <- `_evo_dkv_kernel`    (wrapper `_evo_bwd_impl`)
//   evo_dbias2_kernel <- `_evo_dbias2_kernel` (wrapper `_evo_bwd_impl`)
//   evo_dbias1_kernel <- `_evo_dbias1_kernel` (wrapper `_evo_bwd_impl`)
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
// rate it would be bound by bytes (0.12 ms); at D = 8 (the extra-MSA stack)
// even more so. This first version is simple and correct, not fast: it
// multiplies on the fp32 CUDA cores from shared memory, so arithmetic bounds
// it in practice.
//   * The TPU grid's sequential axes, which carried sums in VMEM from one
//     grid step to the next, are loops inside a block: forward, dQ and
//     dbias2 walk 64-key tiles for a 32-row query tile; dK/dV walks 32-row
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
// Not done yet (later work): mma.sync / wgmma on the tensor cores, TMA or
// cp.async pipelining, and fusing the bias reductions into the dK/dV pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

enum Which { kFwd = 0, kDq = 1, kDkv = 2, kDb2 = 3, kDb1 = 4 };

template <int D>
int smem_bytes(int which) {
  switch (which) {
    case kFwd: return fwd_smem_floats<D>() * (int)sizeof(float);
    case kDq: return dq_smem_floats<D>() * (int)sizeof(float);
    case kDkv: return dkv_smem_floats<D>() * (int)sizeof(float);
    case kDb2:
    case kDb1: return dbias_smem_floats<D>() * (int)sizeof(float);
  }
  return -1;
}

template <typename T, int D>
cudaError_t launch(int which, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = nullptr;
  const long long rows = (long long)p.B * p.N * p.H;
  long long blocks = 0;
  switch (which) {
    case kFwd:
      kernel = evo_fwd_kernel<T, D>;
      blocks = rows * cdiv(p.Lq, kRows);
      break;
    case kDq:
      kernel = evo_dq_kernel<T, D>;
      blocks = rows * cdiv(p.Lq, kRows);
      break;
    case kDkv:
      kernel = evo_dkv_kernel<T, D>;
      blocks = rows * cdiv(p.Lk, kDkvKeys);
      break;
    case kDb2:
      if (p.b2 == nullptr) return cudaErrorInvalidValue;
      kernel = evo_dbias2_kernel<T, D>;
      blocks = (long long)p.B * p.H * cdiv(p.Lq, kRows) * cdiv(p.Lk, kKeys);
      break;
    case kDb1:
      if (p.b1 == nullptr) return cudaErrorInvalidValue;
      kernel = evo_dbias1_kernel<T, D>;
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

}  // namespace

// Dynamic shared memory (bytes) of kernel `which` (0 forward, 1 dQ, 2 dK/dV,
// 3 dbias2, 4 dbias1) at `head_dim`; -1 for an instantiation not compiled.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)pick_dim<float>(which, p, head_dim, s);
  if (dtype == 1) return (int)pick_dim<__nv_bfloat16>(which, p, head_dim, s);
  return (int)cudaErrorInvalidValue;
}
