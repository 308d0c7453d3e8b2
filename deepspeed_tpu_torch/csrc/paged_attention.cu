// Paged GQA attention over the serving KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` in
// deepspeed_tpu/ops/pallas/paged_attention.py (wrapper `paged_attention`).
// Same function: q [B,T,H,d] attends over KV pages [Hkv,NB,bs,d] addressed
// through block_tables [B,MB]; query head h reads KV head h / rep; row t
// sees key position kpos when kpos <= start_pos[b] + t (the causal mask is
// also the context-length mask), and, with a window W, when
// kpos > qpos - W. Scores are scaled by 1/sqrt(d), soft-capped
// (c * tanh(s / c)) when c > 0, then masked. fp8 e4m3 pages are dequantized
// on load with per-(head, page) fp32 scales. A row with nothing live divides
// by max(l, 1e-30) and writes zeros.
//
// What bounds it: at decode (T = 1, rep = 4) each KV byte is used by only
// `rep` query rows, so the kernel is bound by the bytes of the live KV pages;
// at prefill chunks (thousands of rows per KV head) it is bound by the
// arithmetic. The design is for the bytes:
//   * Grid (row tile, KV head, sequence x split). A row tile is ROWS rows of
//     the (token, group) fold r -> (t = r / rep, head = kvh * rep + r % rep):
//     consecutive rows are the query heads that share the KV head, adjacent
//     in memory. ROWS is 4 for folds of up to 4 rows (decode at rep <= 4),
//     8 up to 8, and 32 otherwise.
//   * Split over pages. At decode one block per (KV head, sequence) is
//     B * Hkv blocks, fewer than the 132 SMs at the serving batches. The
//     table's key span (max_blocks * block_size, so the host never reads
//     start_pos) is cut into 64-key tiles and the tiles into n_split ranges
//     of tiles_per_split; the wrapper picks both from the grid, the SM
//     count and the blocks of this instantiation that fit on an SM
//     (`dstt_paged_attention_blocks_per_sm`), so that the split grid stays
//     within one wave. Each split walks the live tiles of its range with
//     its own (m, l, acc) in fp32. With one split the block writes out;
//     otherwise it writes (acc, m, l) to an fp32 workspace that the wrapper
//     keeps for each stream, and `paged_attention_combine_kernel`, next on the same
//     stream, merges the splits in the order 0..n-1, so two calls agree bit
//     for bit. A split with no live tile writes m = -inf, l = 0 and adds
//     nothing.
//   * Loads in flight. K and V tiles stay in shared memory in their stored
//     dtype (bf16, fp8 or fp32), filled by 16-byte cp.async in a ring of 3
//     stages (2 for fp32 and for prefill's 32-row tiles): while one tile
//     computes, the next tiles' pages are loading. Each key row finds its
//     page in the block table when its copy is issued, a stage ahead of its
//     use, so any block size works. Rows are XOR-swizzled by 16-byte chunk,
//     so a warp's 16-byte reads of one chunk of eight keys hit eight bank
//     groups. Dequantization (the per-(head, page) scale, then rounding
//     through the model dtype, as the reference does) happens on the read
//     from shared memory.
//   * Arithmetic on the CUDA cores in fp32: the scores as register
//     micro-tiles over 16-byte chunks of K; the online softmax one warp per
//     row, over score rows padded to 65 floats so that no access conflicts
//     on a bank; P.V with each thread owning one 16-byte column chunk of
//     some rows over a subset of the keys, the subsets added in a fixed
//     order at the end. P is rounded through the model dtype before P.V, as
//     in the reference.
// Not done yet (later work): mma/wgmma tiles for prefill chunks.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kKeys = 64;              // keys per tile
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// Round a float through the model dtype (the reference's `.astype(q.dtype)`).
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until waited for; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A K or V value as the reference sees it: fp8 (or scaled) pages are
// multiplied by their page's scale and rounded through the model dtype.
template <typename TQ, typename TKV>
__device__ __forceinline__ float dequant(float x, float scale, bool scaled) {
  if (std::is_same<TKV, TQ>::value && !scaled) return x;
  return round_to<TQ>(x * scale);
}

template <typename TKV, int N>
__device__ __forceinline__ void unpack(const uint4& raw, float (&x)[N]) {
  const TKV* e = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = to_float(e[i]);
}

template <typename TKV, int D, int ROWS>
struct Layout {
  static constexpr int kVec = 16 / sizeof(TKV);          // elements of a 16-byte chunk
  static constexpr int kChunks = D / kVec;               // chunks of a key row
  static constexpr int kSwz = (kChunks < 8 ? kChunks : 8) - 1;   // chunk XOR mask
  static constexpr int kRowBytes = D * sizeof(TKV);
  static constexpr int kTile = kKeys * kRowBytes;        // one K or V tile
  // 3 stages where bytes bound (decode); 2 for fp32 pages and for 32-row
  // tiles (prefill chunks, bound by the arithmetic), so that two blocks fit
  // on an SM
  static constexpr int kStages = sizeof(TKV) == 4 || ROWS == 32 ? 2 : 3;
  static constexpr int kQP = D + 4;                      // padded q row, floats
  static constexpr int kPS = kKeys + 1;                  // padded score/p row
  // scores: a thread holds kSR rows x kSC keys (keys kg + kKG * j)
  static constexpr int kSR = ROWS <= 8 ? ROWS / 2 : 4;
  static constexpr int kRG = ROWS / kSR;
  static constexpr int kKG = kThreads / kRG;
  static constexpr int kSC = kKeys / kKG;
  // P.V: a thread holds one column chunk of kVR rows over keys vk + kVK * j
  static constexpr int kVRG0 = ROWS / 4 > 1 ? ROWS / 4 : 1;
  static constexpr int kVRG = kVRG0 < kThreads / kChunks ? kVRG0 : kThreads / kChunks;
  static constexpr int kVR = ROWS / kVRG;
  static constexpr int kVK = kThreads / (kChunks * kVRG);
  // bytes: the ring (later the key groups' sums), per-key scales, q,
  // scores (then p), per-row m, l, alpha and qpos
  static constexpr int kRingK = kStages * 2 * kTile;
  static constexpr int kSums = kVK * ROWS * D * 4;
  static constexpr int kRing = kRingK > kSums ? kRingK : kSums;
  static constexpr int kScales = kStages * 2 * kKeys * 4;
  static constexpr int kBytes = kRing + kScales + (ROWS * kQP + ROWS * kPS + 4 * ROWS) * 4;
  static_assert(kKG * kRG == kThreads && kSC * kKG == kKeys, "score mapping");
  static_assert(kChunks * kVRG * kVK == kThreads, "P.V mapping");
};

template <typename TQ, typename TKV, int D, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q,
                       const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ start_pos,
                       TQ* __restrict__ out, float* __restrict__ ws,
                       int T, int H, int num_blocks, int block_size,
                       int max_blocks, int window, float softcap, float scale,
                       int n_split, int tiles_per_split) {
  using L = Layout<TKV, D, ROWS>;
  constexpr int S = L::kStages, VEC = L::kVec;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, kvh = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int hkv = gridDim.y;
  const int rep = H / hkv;
  const int fold = T * rep;
  const int row0 = tile * ROWS;
  const int start = start_pos[b];
  const int ctx_keys = max_blocks * block_size;   // keys the table can name
  const bool scaled = k_scales != nullptr;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;                                      // [S][K, V][kTile]
  float* sc_s = reinterpret_cast<float*>(smem + L::kRing);   // [S][K, V][kKeys]
  float* qs = sc_s + S * 2 * kKeys;                          // [ROWS][kQP]
  float* ps = qs + ROWS * L::kQP;                            // [ROWS][kPS]
  float* m_s = ps + ROWS * L::kPS;                           // [ROWS]
  float* l_s = m_s + ROWS;                                   // [ROWS]
  float* alpha_s = l_s + ROWS;                               // [ROWS]
  int* qpos_s = reinterpret_cast<int*>(alpha_s + ROWS);      // [ROWS]

  for (int r = tid; r < ROWS; r += kThreads) {
    const int fr = row0 + r;
    qpos_s[r] = fr < fold ? start + fr / rep : -1;   // -1: padding row
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  for (int e = tid; e < ROWS * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int fr = row0 + r;
    float val = 0.f;
    if (fr < fold) {
      const int t = fr / rep, h = kvh * rep + fr % rep;
      val = to_float(q[((size_t)(b * T + t) * H + h) * D + c]);
    }
    qs[r * L::kQP + c] = val;
  }

  // live key tiles of this row tile, [tile_lo, tile_hi], cut to the split's
  // range: the tiles [t_begin, t_begin + n)
  const int last_row = min(row0 + ROWS, fold) - 1;
  const int qmin = start + row0 / rep, qmax = start + last_row / rep;
  const int kmax = min(qmax, ctx_keys - 1);
  const int kmin = window > 0 ? max(0, qmin - window + 1) : 0;
  const int tile_lo = kmin / kKeys, tile_hi = kmax < kmin ? tile_lo - 1 : kmax / kKeys;
  const int t_begin = max(tile_lo, split * tiles_per_split);
  const int n = min(tile_hi + 1, (split + 1) * tiles_per_split) - t_begin;

  const uint8_t* kbytes = reinterpret_cast<const uint8_t*>(k_pages);
  const uint8_t* vbytes = reinterpret_cast<const uint8_t*>(v_pages);
  // start the copies of key tile kt into ring stage st
  auto issue = [&](int kt, int st) {
    uint8_t* kd = ring + st * 2 * L::kTile;
    uint8_t* vd = kd + L::kTile;
    for (int e = tid; e < kKeys * L::kChunks; e += kThreads) {
      const int kr = e / L::kChunks, c = e % L::kChunks;
      const int kpos = kt * kKeys + kr;
      const bool valid = kpos < ctx_keys;
      size_t off = 0;
      if (valid) {
        const int page = block_tables[b * max_blocks + kpos / block_size];
        off = ((size_t)(kvh * num_blocks + page) * block_size + kpos % block_size) *
                  L::kRowBytes + c * 16;
      }
      const int dst = kr * L::kRowBytes + (c ^ (kr & L::kSwz)) * 16;
      cp_async16(kd + dst, kbytes + off, valid);
      cp_async16(vd + dst, vbytes + off, valid);
    }
    if (tid < kKeys) {
      const int kpos = kt * kKeys + tid;
      float ksc = 1.f, vsc = 1.f;
      if (scaled && kpos < ctx_keys) {
        const int page = block_tables[b * max_blocks + kpos / block_size];
        ksc = k_scales[kvh * num_blocks + page];
        vsc = v_scales[kvh * num_blocks + page];
      }
      sc_s[st * 2 * kKeys + tid] = ksc;
      sc_s[st * 2 * kKeys + kKeys + tid] = vsc;
    }
  };

  // P.V accumulators: column chunk cc of rows vr * kVR + i, keys vk + kVK * j
  const int cc = tid % L::kChunks;
  const int vr = (tid / L::kChunks) % L::kVRG;
  const int vk = tid / (L::kChunks * L::kVRG);
  float acc[L::kVR][VEC];
#pragma unroll
  for (int i = 0; i < L::kVR; ++i)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n) issue(t_begin + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int st = i % S;
    const int k0 = (t_begin + i) * kKeys;
    if (i + S - 1 < n) issue(t_begin + i + S - 1, (i + S - 1) % S);
    cp_async_commit();
    cp_async_wait<S - 1>();              // this thread's copies of tile i landed
    __syncthreads();                     // everyone's did
    const uint8_t* kt = ring + st * 2 * L::kTile;
    const uint8_t* vt = kt + L::kTile;
    const float* ksc_t = sc_s + st * 2 * kKeys;
    const float* vsc_t = ksc_t + kKeys;

    // 1. scores: S = Q K^T * scale, soft-capped, masked (-inf where dead)
    {
      const int kg = tid % L::kKG, rg = tid / L::kKG;
      float s[L::kSR][L::kSC];
#pragma unroll
      for (int i2 = 0; i2 < L::kSR; ++i2)
#pragma unroll
        for (int j = 0; j < L::kSC; ++j) s[i2][j] = 0.f;
      float ksc[L::kSC];
#pragma unroll
      for (int j = 0; j < L::kSC; ++j) ksc[j] = ksc_t[kg + L::kKG * j];
#pragma unroll 2
      for (int c = 0; c < L::kChunks; ++c) {
        float kx[L::kSC][VEC];
#pragma unroll
        for (int j = 0; j < L::kSC; ++j) {
          const int kr = kg + L::kKG * j;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              kt + kr * L::kRowBytes + (c ^ (kr & L::kSwz)) * 16);
          unpack<TKV>(raw, kx[j]);
#pragma unroll
          for (int e = 0; e < VEC; ++e) kx[j][e] = dequant<TQ, TKV>(kx[j][e], ksc[j], scaled);
        }
#pragma unroll
        for (int i2 = 0; i2 < L::kSR; ++i2) {
          const float* qr = qs + (rg * L::kSR + i2) * L::kQP + c * VEC;
#pragma unroll
          for (int e4 = 0; e4 < VEC / 4; ++e4) {
            const float4 qv = *reinterpret_cast<const float4*>(qr + 4 * e4);
#pragma unroll
            for (int j = 0; j < L::kSC; ++j) {
              s[i2][j] = fmaf(qv.x, kx[j][4 * e4 + 0], s[i2][j]);
              s[i2][j] = fmaf(qv.y, kx[j][4 * e4 + 1], s[i2][j]);
              s[i2][j] = fmaf(qv.z, kx[j][4 * e4 + 2], s[i2][j]);
              s[i2][j] = fmaf(qv.w, kx[j][4 * e4 + 3], s[i2][j]);
            }
          }
        }
      }
#pragma unroll
      for (int i2 = 0; i2 < L::kSR; ++i2) {
        const int r = rg * L::kSR + i2;
        const int qp = qpos_s[r];
#pragma unroll
        for (int j = 0; j < L::kSC; ++j) {
          const int kr = kg + L::kKG * j;
          const int kpos = k0 + kr;
          float x = s[i2][j] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          bool live = kpos <= qp && kpos < ctx_keys;
          if (window > 0) live = live && kpos > qp - window;
          // -inf (not the reference's -1e30) marks a dead key: exp() of it
          // is exactly 0, which is the reference's where(mask, p, 0), and
          // the running max still starts from -1e30 as in the reference
          ps[r * L::kPS + kr] = live ? x : __int_as_float(0xff800000);  // -inf
        }
      }
    }
    __syncthreads();

    // 2. online softmax: one warp per row, p in place of the scores
    for (int r = warp; r < ROWS; r += kThreads / 32) {
      const float a = ps[r * L::kPS + lane];
      const float c = ps[r * L::kPS + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * L::kPS + lane] = round_to<TQ>(pa);
      ps[r * L::kPS + lane + 32] = round_to<TQ>(pc);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + P V over this thread's keys
#pragma unroll
    for (int i2 = 0; i2 < L::kVR; ++i2) {
      const float alpha = alpha_s[vr * L::kVR + i2];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i2][e] *= alpha;
    }
#pragma unroll 2
    for (int kr = vk; kr < kKeys; kr += L::kVK) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          vt + kr * L::kRowBytes + (cc ^ (kr & L::kSwz)) * 16);
      float vx[VEC];
      unpack<TKV>(raw, vx);
      const float vsc = vsc_t[kr];
#pragma unroll
      for (int e = 0; e < VEC; ++e) vx[e] = dequant<TQ, TKV>(vx[e], vsc, scaled);
#pragma unroll
      for (int i2 = 0; i2 < L::kVR; ++i2) {
        const float pv = ps[(vr * L::kVR + i2) * L::kPS + kr];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i2][e] = fmaf(pv, vx[e], acc[i2][e]);
      }
    }
    __syncthreads();   // the next issue overwrites this stage, the next tile ps
  }

  // 4. add the key groups' sums in order (through the drained ring), then
  //    write out, or this split's partials
  float* sums = reinterpret_cast<float*>(ring);   // [kVK][ROWS][D]
#pragma unroll
  for (int i2 = 0; i2 < L::kVR; ++i2) {
    float* dst = sums + ((size_t)vk * ROWS + vr * L::kVR + i2) * D + cc * VEC;
#pragma unroll
    for (int e4 = 0; e4 < VEC / 4; ++e4)
      *reinterpret_cast<float4*>(dst + 4 * e4) =
          make_float4(acc[i2][4 * e4], acc[i2][4 * e4 + 1], acc[i2][4 * e4 + 2],
                      acc[i2][4 * e4 + 3]);
  }
  __syncthreads();
  const int rows_total = gridDim.z / n_split * hkv * fold;   // B * Hkv * fold
  for (int e = tid; e < ROWS * D; e += kThreads) {
    const int r = e / D, col = e % D;
    const int fr = row0 + r;
    if (fr >= fold) continue;
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < L::kVK; ++g) a += sums[((size_t)g * ROWS + r) * D + col];
    if (n_split == 1) {
      const int t = fr / rep, h = kvh * rep + fr % rep;
      out[((size_t)(b * T + t) * H + h) * D + col] =
          from_float<TQ>(a / fmaxf(l_s[r], 1e-30f));
    } else {
      const size_t row = (size_t)split * rows_total + (size_t)(b * hkv + kvh) * fold + fr;
      ws[row * D + col] = a;
      if (col == 0) {
        float* ml = ws + (size_t)n_split * rows_total * D + row * 2;
        ml[0] = n > 0 ? m_s[r] : __int_as_float(0xff800000);   // -inf: no live tile
        ml[1] = l_s[r];
      }
    }
  }
}

// Merge the splits' partials of each fold row, in split order 0..n-1: one
// warp per row, D / 32 columns a lane.
template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_combine_kernel(const float* __restrict__ ws, TQ* __restrict__ out,
                               int rows_total, int T, int H, int Hkv, int n_split) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  if (row >= rows_total) return;
  const float* ml = ws + (size_t)n_split * rows_total * D;
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ml[((size_t)s * rows_total + row) * 2]);
  float l = 0.f, o[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) o[i] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t sr = (size_t)s * rows_total + row;
    const float w = expf(ml[sr * 2] - m);          // 0 for a split with no live tile
    l += w * ml[sr * 2 + 1];
#pragma unroll
    for (int i = 0; i < D / 32; ++i) o[i] += w * ws[sr * D + lane + 32 * i];
  }
  const int rep = H / Hkv, fold = T * rep;
  const int fr = row % fold, bk = row / fold;
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int t = fr / rep, h = kvh * rep + fr % rep;
  const float denom = fmaxf(l, 1e-30f);
  TQ* dst = out + ((size_t)(b * T + t) * H + h) * D;
#pragma unroll
  for (int i = 0; i < D / 32; ++i) dst[lane + 32 * i] = from_float<TQ>(o[i] / denom);
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* block_tables;
  const int* start_pos;
  void* out;
  float* ws;
  int B, T, H, Hkv, num_blocks, block_size, max_blocks, window;
  float softcap, scale;
  int n_split, tiles_per_split;
};

// Lets the instantiation take its dynamic shared memory (once).
template <typename TQ, typename TKV, int D, int ROWS>
cudaError_t configure() {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TKV, D, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<TKV, D, ROWS>::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

template <typename TQ, typename TKV, int D, int ROWS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<TQ, TKV, D, ROWS>;
  constexpr int smem = Layout<TKV, D, ROWS>::kBytes;
  cudaError_t err = configure<TQ, TKV, D, ROWS>();
  if (err != cudaSuccess) return err;
  const int fold = a.T * (a.H / a.Hkv);
  const dim3 grid((fold + ROWS - 1) / ROWS, a.Hkv, a.B * a.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pages),
      static_cast<const TKV*>(a.v_pages), a.k_scales, a.v_scales,
      a.block_tables, a.start_pos, static_cast<TQ*>(a.out), a.ws, a.T, a.H,
      a.num_blocks, a.block_size, a.max_blocks, a.window, a.softcap, a.scale,
      a.n_split, a.tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  const int rows_total = a.B * a.Hkv * fold;
  const int per_block = kThreads / 32;
  paged_attention_combine_kernel<TQ, D>
      <<<(rows_total + per_block - 1) / per_block, kThreads, 0, stream>>>(
          a.ws, static_cast<TQ*>(a.out), rows_total, a.T, a.H, a.Hkv, a.n_split);
  return cudaGetLastError();
}

// Resident blocks of the instantiation on one SM (occupancy calculator),
// or minus a CUDA error code.
template <typename TQ, typename TKV, int D, int ROWS>
int blocks_per_sm() {
  cudaError_t err = configure<TQ, TKV, D, ROWS>();
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, paged_attention_kernel<TQ, TKV, D, ROWS>, kThreads,
        Layout<TKV, D, ROWS>::kBytes);
  return err == cudaSuccess ? n : -(int)err;
}

// The compiled instantiations: F::run<TQ, TKV, D, ROWS>(args...) for
// (q dtype, kv fp8, head_dim, rows), or kNotCompiled.
constexpr int kNotCompiled = -1;

struct Launch {
  template <typename TQ, typename TKV, int D, int ROWS>
  static int run(const Args& a, cudaStream_t stream) {
    return (int)launch<TQ, TKV, D, ROWS>(a, stream);
  }
};

struct Occupancy {
  template <typename TQ, typename TKV, int D, int ROWS>
  static int run() { return blocks_per_sm<TQ, TKV, D, ROWS>(); }
};

template <typename F, typename TQ, typename TKV, int D, typename... A>
int pick_rows(int rows, A... a) {
  if (rows == 4) return F::template run<TQ, TKV, D, 4>(a...);
  if (rows == 8) return F::template run<TQ, TKV, D, 8>(a...);
  if (rows == 32) return F::template run<TQ, TKV, D, 32>(a...);
  return kNotCompiled;
}

template <typename F, typename TQ, typename TKV, typename... A>
int pick_dim(int head_dim, int rows, A... a) {
  if (head_dim == 32) return pick_rows<F, TQ, TKV, 32>(rows, a...);
  if (head_dim == 64) return pick_rows<F, TQ, TKV, 64>(rows, a...);
  if (head_dim == 128) return pick_rows<F, TQ, TKV, 128>(rows, a...);
  return kNotCompiled;
}

template <typename F, typename... A>
int pick(int q_dtype, int kv_fp8, int head_dim, int rows, A... a) {
  if (q_dtype == 0 && !kv_fp8) return pick_dim<F, float, float>(head_dim, rows, a...);
  if (q_dtype == 0 && kv_fp8)
    return pick_dim<F, float, __nv_fp8_e4m3>(head_dim, rows, a...);
  if (q_dtype == 1 && !kv_fp8)
    return pick_dim<F, __nv_bfloat16, __nv_bfloat16>(head_dim, rows, a...);
  if (q_dtype == 1 && kv_fp8)
    return pick_dim<F, __nv_bfloat16, __nv_fp8_e4m3>(head_dim, rows, a...);
  return kNotCompiled;
}

template <typename TKV, int D>
int smem_bytes(int rows) {
  if (rows == 4) return Layout<TKV, D, 4>::kBytes;
  if (rows == 8) return Layout<TKV, D, 8>::kBytes;
  if (rows == 32) return Layout<TKV, D, 32>::kBytes;
  return -1;
}

template <typename TKV>
int smem_bytes_d(int head_dim, int rows) {
  if (head_dim == 32) return smem_bytes<TKV, 32>(rows);
  if (head_dim == 64) return smem_bytes<TKV, 64>(rows);
  if (head_dim == 128) return smem_bytes<TKV, 128>(rows);
  return -1;
}

}  // namespace

// Dynamic shared memory of the instantiation for (head_dim, rows per
// block, bytes of a stored K/V element: 4, 2 or 1), as `launch` requests
// it; -1 for one not compiled.
extern "C" int dstt_paged_attention_smem_bytes(int head_dim, int rows, int kv_bytes) {
  if (kv_bytes == 4) return smem_bytes_d<float>(head_dim, rows);
  if (kv_bytes == 2) return smem_bytes_d<__nv_bfloat16>(head_dim, rows);
  if (kv_bytes == 1) return smem_bytes_d<__nv_fp8_e4m3>(head_dim, rows);
  return -1;
}

// q_dtype: 0 = float32, 1 = bfloat16. kv_fp8: pages are float8_e4m3 (else
// the model dtype). k_scales/v_scales may be null. window <= 0 and
// softcap <= 0 turn those off. rows: query rows a block (4, 8 or 32, at
// least the fold T * H / Hkv unless 32). The table's key span is cut into
// n_split ranges of tiles_per_split 64-key tiles; with n_split > 1,
// workspace holds n_split * B * Hkv * fold * (head_dim + 2) floats. Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for arguments or a combination not compiled.
extern "C" int dstt_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* start_pos, void* out, void* workspace, int B, int T, int H,
    int Hkv, int num_blocks, int block_size, int head_dim, int max_blocks,
    int window, float softcap, float scale, int q_dtype, int kv_fp8, int rows,
    int n_split, int tiles_per_split, void* stream) {
  Args a{q, k_pages, v_pages,
         static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
         static_cast<const int*>(block_tables), static_cast<const int*>(start_pos),
         out, static_cast<float*>(workspace), B, T, H, Hkv, num_blocks, block_size,
         max_blocks, window, softcap, scale, n_split, tiles_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int fold = T * (H / Hkv);
  if (rows != 32 && rows < fold) return (int)cudaErrorInvalidValue;
  if (n_split < 1 || tiles_per_split < 1 ||
      (long long)n_split * tiles_per_split * kKeys < (long long)max_blocks * block_size ||
      (n_split > 1 && workspace == nullptr) || B * n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const int err = pick<Launch>(q_dtype, kv_fp8, head_dim, rows, a, s);
  return err == kNotCompiled ? (int)cudaErrorInvalidValue : err;
}

// Blocks of the instantiation for (head_dim, rows, q_dtype, kv_fp8) that
// fit on one SM at once (the split plan's wave), or a value <= 0: -1 for a
// combination not compiled, else minus a CUDA error code.
extern "C" int dstt_paged_attention_blocks_per_sm(int head_dim, int rows, int q_dtype,
                                                  int kv_fp8) {
  return pick<Occupancy>(q_dtype, kv_fp8, head_dim, rows);
}
