// Flash attention for training, for Hopper (sm_90a): the forward with its
// per-row logsumexp, and the two backward kernels (dQ, and dK/dV).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel  <- `_flash_kernel` (wrapper `_pallas_flash_fwd_impl`)
//   flash_dq_kernel   <- `_dq_kernel`    (wrapper `_pallas_flash_bwd_impl`)
//   flash_dkv_kernel  <- `_dkv_kernel`   (wrapper `_pallas_flash_bwd_impl`)
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
// What bounds it: at the training shape (S = 2048, d = 128, causal) the
// work is arithmetic (34 GFLOP forward, 120 GFLOP in this two-kernel
// backward, against 42 MB of operands), so the bound is the tensor cores'
// bf16 rate. This first version is simple and correct, not fast: it
// multiplies on the fp32 CUDA cores from shared memory.
//   * The TPU grid's sequential key axis, which carried (m, l, acc) or the
//     dQ/dK/dV sums in VMEM from one grid step to the next, is a loop
//     inside the block: forward and dQ run one block per (32-row q tile,
//     batch x head) over 64-key tiles; dK/dV runs one block per (32-key
//     tile, batch x KV head) over (group member x 32-row q tile), as the
//     TPU's folded innermost grid axis does, so the gradients of a KV head
//     shared by `rep` query heads sum in registers, with no atomics and no
//     rep-times-larger buffer.
//   * Dead tiles are never loaded: each block computes its live key (or
//     query) range from the causal band and the window, as `_block_live`
//     skips whole blocks.
//   * Tiles are stored in shared memory as fp32 with a padded row stride;
//     the 1024-row blocks the TPU wrapper picks for VMEM are gone.
// Not done yet (later work): mma.sync / wgmma on the tensor cores, TMA or
// cp.async pipelining, and a split of the key range for short sequences.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// forward: out and lse
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
// dQ: dq = sum over live key tiles of round(dS) . K
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
// dK, dV: one block per (key tile, batch x KV head), looping over the group
// members and their live query tiles
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

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
int smem_bytes(int which) {
  if (which == kFwd) return fwd_smem_floats<D>() * (int)sizeof(float);
  if (which == kDq) return dq_smem_floats<D>() * (int)sizeof(float);
  if (which == kDkv) return dkv_smem_floats<D>() * (int)sizeof(float);
  return -1;
}

template <typename T, int D>
cudaError_t launch(int which, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = nullptr;
  dim3 grid;
  if (which == kFwd) {
    kernel = flash_fwd_kernel<T, D>;
    grid = dim3((p.Sq + kFwdRows - 1) / kFwdRows, p.B * p.H);
  } else if (which == kDq) {
    kernel = flash_dq_kernel<T, D>;
    grid = dim3((p.Sq + kFwdRows - 1) / kFwdRows, p.B * p.H);
  } else {
    kernel = flash_dkv_kernel<T, D>;
    grid = dim3((p.Sk + kDkvKeys - 1) / kDkvKeys, p.B * p.Hkv);
  }
  const int smem = smem_bytes<D>(which);
  static bool configured[3] = {false, false, false};   // per instantiation
  if (!configured[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[which] = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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

// Dynamic shared memory (bytes) of kernel `which` (0 forward, 1 dQ, 2 dK/dV)
// at `head_dim`; -1 for an instantiation not compiled.
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
