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
// arithmetic. This first version is simple and correct:
//   * One block per (row tile, KV head, sequence). A row tile is ROWS rows
//     of the (token, group) fold r -> (t = r / rep, head = kvh * rep +
//     r % rep): consecutive rows are the query heads that share the KV head,
//     adjacent in memory. ROWS is 8 for decode-sized folds and 32 otherwise.
//   * The TPU grid's sequential page axis, which carried (m, l, acc) in VMEM
//     from one grid step to the next, becomes a loop inside the block over
//     64-key tiles. Each key row finds its own page in the block table, so
//     any block size works and the block reads its table and start position
//     itself (no scalar prefetch). Tiles wholly above the tile's causal
//     horizon or wholly below its window are never loaded: the live key
//     range comes from the tile's own smallest and largest query position.
//   * K and V tiles are dequantized into shared memory as fp32 (rounded
//     through the model dtype first, as the reference does) with a padded
//     row stride; scores, the online softmax (m, l) and the accumulator are
//     fp32. P is rounded through the model dtype before P.V, as in the
//     reference.
// The TPU artefacts are gone: no padding of the fold to 8 sublanes, no
// scalar prefetch. Not done yet (later work): wgmma/TMA pipelines, and
// split-K over pages so that long decode contexts fill all 132 SMs.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int D, int ROWS>
constexpr size_t smem_floats() {
  // q tile, K tile, V tile (padded rows), P tile, m, l, alpha, qpos
  return ROWS * (D + 1) + 2 * kKeys * (D + 1) + ROWS * kKeys + 4 * ROWS;
}

template <typename TQ, typename TKV, int D, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q,
                       const TKV* __restrict__ k_pages,
                       const TKV* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ start_pos,
                       TQ* __restrict__ out,
                       int T, int H, int num_blocks, int block_size,
                       int max_blocks, int window, float softcap, float scale) {
  static_assert(ROWS % 8 == 0, "ROWS must be a multiple of 8");
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int DP = D + 1;                  // padded row: no bank conflicts
  constexpr int VEC = 16 / sizeof(TKV);      // elements per 16-byte load
  constexpr int VPR = D / VEC;               // 16-byte loads per key row
  constexpr int SR = ROWS / 8, SC = kKeys / 16;   // score micro-tile
  constexpr int PR = ROWS / 4, PC = D / 32;       // accumulator micro-tile

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int hkv = gridDim.y;
  const int rep = H / hkv;
  const int fold = T * rep;
  const int row0 = tile * ROWS;
  const int start = start_pos[b];
  const int ctx_keys = max_blocks * block_size;   // keys the table can name

  extern __shared__ float smem[];
  float* qs = smem;                          // [ROWS][DP]
  float* ks = qs + ROWS * DP;                // [kKeys][DP]
  float* vs = ks + kKeys * DP;               // [kKeys][DP]
  float* ps = vs + kKeys * DP;               // [ROWS][kKeys]
  float* m_s = ps + ROWS * kKeys;            // [ROWS]
  float* l_s = m_s + ROWS;                   // [ROWS]
  float* alpha_s = l_s + ROWS;               // [ROWS]
  int* qpos_s = reinterpret_cast<int*>(alpha_s + ROWS);   // [ROWS]

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
    qs[r * DP + c] = val;
  }

  // live key range of this row tile: [kmin, kmax]
  const int last_row = min(row0 + ROWS, fold) - 1;
  const int qmin = start + row0 / rep, qmax = start + last_row / rep;
  const int kmax = min(qmax, ctx_keys - 1);
  const int kmin = window > 0 ? max(0, qmin - window + 1) : 0;
  const int tile_lo = kmin / kKeys, tile_hi = kmax / kKeys;

  float acc[PR][PC];
#pragma unroll
  for (int i = 0; i < PR; ++i)
#pragma unroll
    for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;

  __syncthreads();

  for (int kt = tile_lo; kt <= tile_hi; ++kt) {
    // 1. K/V tile -> shared memory, dequantized and rounded through TQ
    for (int e = tid; e < kKeys * VPR; e += kThreads) {
      const int kr = e / VPR, cv = (e % VPR) * VEC;
      const int kpos = kt * kKeys + kr;
      float* kd = ks + kr * DP + cv;
      float* vd = vs + kr * DP + cv;
      if (kpos < ctx_keys) {
        const int page = block_tables[b * max_blocks + kpos / block_size];
        const size_t off =
            ((size_t)(kvh * num_blocks + page) * block_size + kpos % block_size) * D + cv;
        const uint4 kraw = *reinterpret_cast<const uint4*>(k_pages + off);
        const uint4 vraw = *reinterpret_cast<const uint4*>(v_pages + off);
        float ksc = 1.f, vsc = 1.f;
        if (k_scales != nullptr) {
          ksc = k_scales[kvh * num_blocks + page];
          vsc = v_scales[kvh * num_blocks + page];
        }
        const TKV* kx = reinterpret_cast<const TKV*>(&kraw);
        const TKV* vx = reinterpret_cast<const TKV*>(&vraw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          kd[i] = round_to<TQ>(to_float(kx[i]) * ksc);
          vd[i] = round_to<TQ>(to_float(vx[i]) * vsc);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kd[i] = vd[i] = 0.f;
      }
    }
    __syncthreads();

    // 2. scores: S = Q K^T * scale, soft-capped, masked (-inf where dead)
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
        const int qp = qpos_s[r];
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int kr = tx + 16 * j;
          const int kpos = kt * kKeys + kr;
          float x = s[i][j] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          bool live = kpos <= qp && kpos < ctx_keys;
          if (window > 0) live = live && kpos > qp - window;
          // -inf (not the reference's -1e30) marks a dead key: exp() of it
          // is exactly 0, which is the reference's where(mask, p, 0), and
          // the running max still starts from -1e30 as in the reference
          ps[r * kKeys + kr] = live ? x : __int_as_float(0xff800000);  // -inf
        }
      }
    }
    __syncthreads();

    // 3. online softmax: one warp per row
    for (int r = warp; r < ROWS; r += kThreads / 32) {
      const float a = ps[r * kKeys + lane];
      const float c = ps[r * kKeys + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[r * kKeys + lane] = round_to<TQ>(pa);
      ps[r * kKeys + lane + 32] = round_to<TQ>(pc);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      const float alpha = alpha_s[warp + 4 * i];
#pragma unroll
      for (int j = 0; j < PC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kr = 0; kr < kKeys; ++kr) {
      float vv[PC];
#pragma unroll
      for (int j = 0; j < PC; ++j) vv[j] = vs[kr * DP + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const float p = ps[(warp + 4 * i) * kKeys + kr];
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncthreads();   // the next tile overwrites ks, vs and ps
  }

  // 5. out = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < PR; ++i) {
    const int r = warp + 4 * i;
    const int fr = row0 + r;
    if (fr >= fold) continue;
    const int t = fr / rep, h = kvh * rep + fr % rep;
    const float denom = fmaxf(l_s[r], 1e-30f);
    TQ* dst = out + ((size_t)(b * T + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < PC; ++j) dst[lane + 32 * j] = from_float<TQ>(acc[i][j] / denom);
  }
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
  int B, T, H, Hkv, num_blocks, block_size, max_blocks, window;
  float softcap, scale;
};

template <typename TQ, typename TKV, int D, int ROWS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<TQ, TKV, D, ROWS>;
  constexpr size_t smem = smem_floats<D, ROWS>() * sizeof(float);
  static bool configured = false;    // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int fold = a.T * (a.H / a.Hkv);
  const dim3 grid((fold + ROWS - 1) / ROWS, a.Hkv, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k_pages),
      static_cast<const TKV*>(a.v_pages), a.k_scales, a.v_scales,
      a.block_tables, a.start_pos, static_cast<TQ*>(a.out), a.T, a.H,
      a.num_blocks, a.block_size, a.max_blocks, a.window, a.softcap, a.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t pick_rows(const Args& a, cudaStream_t stream) {
  if (a.T * (a.H / a.Hkv) <= 8) return launch<TQ, TKV, D, 8>(a, stream);
  return launch<TQ, TKV, D, 32>(a, stream);
}

template <typename TQ, typename TKV>
cudaError_t pick_dim(const Args& a, int head_dim, cudaStream_t stream) {
  if (head_dim == 64) return pick_rows<TQ, TKV, 64>(a, stream);
  if (head_dim == 128) return pick_rows<TQ, TKV, 128>(a, stream);
  return cudaErrorInvalidValue;
}

template <int D>
int smem_bytes(int rows) {
  if (rows == 8) return (int)(smem_floats<D, 8>() * sizeof(float));
  if (rows == 32) return (int)(smem_floats<D, 32>() * sizeof(float));
  return -1;
}

}  // namespace

// Dynamic shared memory of the instantiation for (head_dim, rows per
// block), in bytes, as `launch` requests it; -1 for one not compiled.
extern "C" int dstt_paged_attention_smem_bytes(int head_dim, int rows) {
  if (head_dim == 64) return smem_bytes<64>(rows);
  if (head_dim == 128) return smem_bytes<128>(rows);
  return -1;
}

// q_dtype: 0 = float32, 1 = bfloat16. kv_fp8: pages are float8_e4m3 (else
// the model dtype). k_scales/v_scales may be null. window <= 0 and
// softcap <= 0 turn those off. Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for a combination not compiled.
extern "C" int dstt_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* block_tables,
    const void* start_pos, void* out, int B, int T, int H, int Hkv,
    int num_blocks, int block_size, int head_dim, int max_blocks, int window,
    float softcap, float scale, int q_dtype, int kv_fp8, void* stream) {
  Args a{q, k_pages, v_pages,
         static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
         static_cast<const int*>(block_tables), static_cast<const int*>(start_pos),
         out, B, T, H, Hkv, num_blocks, block_size, max_blocks, window,
         softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0 && !kv_fp8) return (int)pick_dim<float, float>(a, head_dim, s);
  if (q_dtype == 0 && kv_fp8) return (int)pick_dim<float, __nv_fp8_e4m3>(a, head_dim, s);
  if (q_dtype == 1 && !kv_fp8) return (int)pick_dim<__nv_bfloat16, __nv_bfloat16>(a, head_dim, s);
  if (q_dtype == 1 && kv_fp8) return (int)pick_dim<__nv_bfloat16, __nv_fp8_e4m3>(a, head_dim, s);
  return (int)cudaErrorInvalidValue;
}
