// Block-sparse attention forward, for Hopper (sm_90a).
//
// Replaces `_sparse_kernel` (deepspeed_tpu/ops/sparse_attention/attention.py,
// wrapper `_pallas_sparse_fwd`). Function: q, k, v [B, S, H, D]; a layout
// [H, nb, nb] (nb = S / block) says which [block x block] score tiles exist;
// token (i, j) of head h may attend iff layout[h, i / block, j / block] != 0,
// and, with `causal`, i >= j. Rounding points are the TPU kernel's: scores are
// fp32 dots times 1/sqrt(D); masked scores are NEG_INF (-1e30) and their p is
// forced to 0; the online softmax over key blocks rounds p to v's dtype
// against the running max of each key block before P.V; l sums the unrounded
// p; the output is acc / max(l, 1e-30), so a row with no live key is 0.
//
// What bounds it: at BigBird-base (S = 4096, block 64, 11.9% live) and the
// Fixed pattern (block 16, 13.3% live) the live blocks' arithmetic and the
// operand bytes are about even (0.025-0.03 ms each on this card).
//
// Two kernels; `launch` picks by dtype:
//   bf16  sparse_attention_kernel_mma  tensor cores (mma.sync), cp.async ring
//   fp32  sparse_attention_kernel      fp32 CUDA cores (the tensor cores
//                                      take fp32 only as TF32)
//
// The bf16 kernel (helpers in warp_mma.cuh):
//   * A block is 4 warps of 16 query rows, 64 rows of one (batch, head) at
//     every block size: 4 query blocks at block 16, 2 at 32, 1 at 64, and
//     half a query block at 128 (two blocks of threads share it).
//   * It walks a group CSR built on the host (`SparseLayout.group_csr`):
//     for each (head, group of query blocks) the ascending union of the
//     group's live key blocks, each with a bit mask of the query blocks
//     that take it. Each key block is loaded once for the whole group (the
//     Fixed pattern's neighbouring query blocks share their window and all
//     share the global columns); a warp whose query block does not take an
//     entry leaves its m, l and acc untouched, exactly as the reference's
//     dead block does (alpha = 1, p = 0).
//   * Blocks start longest entry list first (`grp_order`): BigBird's global
//     query block walks every key block, and started last it would run
//     alone at the end.
//   * K and V of the next entries are in flight (`cp.async`, 2-4 stages by
//     block size) while one computes. S = Q.K^T and O += P.V are m16n8k16
//     products from `ldmatrix`; the score accumulators of a whole key block
//     (up to 128 keys) stay in registers, so the running max moves once
//     per layout block, and, rounded to bf16 pairs, are P.V's A fragments.
//
// The fp32 kernel, the first design:
//   * The point of the TPU kernel is that dead blocks cost nothing; here a
//     block of threads owns one tile of R = min(block, 64) query rows of one
//     (batch, head) and walks only the live key blocks of its (head, query
//     block), from a CSR list built once per layout on the host (`row_ptr`
//     [H * nb + 1], `cols`), in ascending order, the Pallas grid's order.
//     A dead block is never loaded; a (head, query block) with no live block
//     writes zeros.
//   * The TPU grid's sequential key axis, which carried (m, l, acc) in VMEM,
//     is that loop inside the block. A key block of 128 is scored in two
//     64-key chunks into one [R][block] panel before its softmax, so the
//     running max moves once per key block, as the TPU kernel's does.
//   * q, k and v are read strided in their [B, S, H, D] layout (16-byte
//     loads of one head's row), never transposed to [B*H, S, D].
// Not done yet (later work): a backward kernel (the backward recomputes
// through the plain version).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF
constexpr int kMaxRows = 64;           // query rows (and keys) of one tile

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

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
  void* out;
  const int* row_ptr;     // [H * nb + 1]
  const int* cols;        // live key blocks of each (h, qi), ascending
  const int* grp_ptr;     // [H * groups + 1] (bf16 kernel)
  const int* grp_cols;    // union of each (h, group)'s live key blocks, ascending
  const int* grp_mask;    // bit i: the group's query block i takes the entry
  const int* grp_order;   // [H * ceil(S / 64)]: h * nx + x, most entries first
  int B, S, H, block, causal;
  float scale;
};

// Copy `rows` rows of one head from sequence position pos0 of x [B, S, heads,
// D] into dst [rows][D + 1] as fp32.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, float* dst,
                                          int rows, int pos0, int S, int heads,
                                          int b, int head) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int e = threadIdx.x; e < rows * VPR; e += kThreads) {
    const int r = e / VPR, c = (e % VPR) * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        x + ((size_t)(b * S + pos0 + r) * heads + head) * D + c);
    const T* xs = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * (D + 1) + c;
#pragma unroll
    for (int i = 0; i < VEC; ++i) d[i] = to_float(xs[i]);
  }
}

// Panel row stride: a block's width plus 16, so the two query rows a warp
// writes in the score pass sit 16 banks apart.
__host__ __device__ constexpr int panel_stride(int block) { return block + 16; }

template <int D>
__host__ __device__ constexpr int smem_floats(int rows, int block) {
  return 2 * rows * (D + 1) + rows * panel_stride(block) + 3 * rows;
}

// One block of threads: R query rows (q0 .. q0 + R - 1, inside query block
// qi) of batch b, head h.
template <typename T, int D, int R>
__global__ void __launch_bounds__(kThreads) sparse_attention_kernel(Params p) {
  constexpr int DP = D + 1, KC = R;            // keys per chunk = R
  constexpr int SR = R / 16, SC = KC / 16;     // score micro-tile per thread
  constexpr int AR = R / 8, AC = D / 32;       // accumulator micro-tile
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int block = p.block, PW = panel_stride(block), nb = p.S / block;
  const int q0 = blockIdx.x * R, qi = q0 / block;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  extern __shared__ float smem[];
  float* qs = smem;                      // [R][DP]
  float* kv = qs + R * DP;               // [KC][DP]: a K chunk, then a V chunk
  float* ps = kv + KC * DP;              // [R][PW]: scores, then rounded p
  float* m_s = ps + R * PW;              // [R]
  float* l_s = m_s + R;                  // [R]
  float* alpha_s = l_s + R;              // [R]

  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  load_rows<T, D>(q, qs, R, q0, p.S, p.H, b, h);

  float acc[AR][AC];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int j = 0; j < AC; ++j) acc[i][j] = 0.f;

  const int lo = p.row_ptr[h * nb + qi], hi = p.row_ptr[h * nb + qi + 1];
  const int chunks = block / KC;
  for (int it = lo; it < hi; ++it) {
    const int kb0 = p.cols[it] * block;        // first key of the live block

    // scores of each KC-key chunk: fp32 dot, then the scale; NEG_INF where
    // the token-level causal mask removes the pair
    for (int ch = 0; ch < chunks; ++ch) {
      __syncthreads();                         // kv and ps are free again
      load_rows<T, D>(k, kv, KC, kb0 + ch * KC, p.S, p.H, b, h);
      __syncthreads();
      const int tx = tid % 16, ty = tid / 16;
      float s[SR][SC];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float qv[SR], kvv[SC];
#pragma unroll
        for (int i = 0; i < SR; ++i) qv[i] = qs[(ty + 16 * i) * DP + c];
#pragma unroll
        for (int j = 0; j < SC; ++j) kvv[j] = kv[(tx + 16 * j) * DP + c];
#pragma unroll
        for (int i = 0; i < SR; ++i)
#pragma unroll
          for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kvv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int c = ch * KC + tx + 16 * j;
          const bool dead = p.causal && q0 + r < kb0 + c;
          ps[r * PW + c] = dead ? kNegInf : s[i][j] * p.scale;
        }
      }
    }
    __syncthreads();

    // online softmax over the whole key block, one warp per row
    for (int r = warp; r < R; r += kThreads / 32) {
      float mx = kNegInf;
      for (int c = lane; c < block; c += 32) mx = fmaxf(mx, ps[r * PW + c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < block; c += 32) {
        const bool dead = p.causal && q0 + r < kb0 + c;
        const float pv = dead ? 0.f : expf(ps[r * PW + c] - m_new);
        sum += pv;
        ps[r * PW + c] = round_to<T>(pv);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V, one KC-key chunk of V at a time
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const float alpha = alpha_s[warp + 8 * i];
#pragma unroll
      for (int j = 0; j < AC; ++j) acc[i][j] *= alpha;
    }
    for (int ch = 0; ch < chunks; ++ch) {
      if (ch > 0) __syncthreads();
      load_rows<T, D>(v, kv, KC, kb0 + ch * KC, p.S, p.H, b, h);
      __syncthreads();
#pragma unroll 4
      for (int kr = 0; kr < KC; ++kr) {
        float vv[AC];
#pragma unroll
        for (int j = 0; j < AC; ++j) vv[j] = kv[kr * DP + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < AR; ++i) {
          const float pv = ps[(warp + 8 * i) * PW + ch * KC + kr];
#pragma unroll
          for (int j = 0; j < AC; ++j) acc[i][j] = fmaf(pv, vv[j], acc[i][j]);
        }
      }
    }
  }
  __syncthreads();                             // l_s of every row is final

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < AR; ++i) {
    const int r = warp + 8 * i;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* dst = out + ((size_t)(b * p.S + q0 + r) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < AC; ++j) dst[lane + 32 * j] = from_float<T>(acc[i][j] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: one block of 4 warps per 64 query rows of one
// (batch, head), walking the union of its group's live key blocks
// ---------------------------------------------------------------------------
constexpr int kMmaThreads = 128;       // 4 warps x 16 query rows
constexpr int kMmaRows = 64;

template <int D, int BS>
struct SparseMma {
  static constexpr int RS = D + 8;                       // tile row stride, elements
  static constexpr int QPG = BS < kMmaRows ? kMmaRows / BS : 1;   // query blocks a group
  static constexpr int kStages = BS == 16 ? 4 : BS == 128 ? 2 : 3;
  static constexpr int smem_bytes = (kMmaRows + 2 * kStages * BS) * RS *
                                    (int)sizeof(__nv_bfloat16);
};

template <int D, int BS>
__global__ void __launch_bounds__(kMmaThreads) sparse_attention_kernel_mma(Params p) {
  using M = SparseMma<D, BS>;
  using namespace warp_mma;
  using bf16 = __nv_bfloat16;
  constexpr int RS = M::RS, ST = M::kStages, NT = BS / 8;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = lane / 4;
  // blocks in grp_order's order, the longest entry lists first, so that no
  // long list starts last; the batch entries of one (h, x) are adjacent
  const int nx = cdiv(p.S, kMmaRows);
  const int hx = p.grp_order[blockIdx.x / p.B], b = blockIdx.x % p.B;
  const int h = hx / nx, q0 = (hx % nx) * kMmaRows, row0 = warp * 16;
  const int groups = cdiv(p.S / BS, M::QPG);
  const int group = q0 / (BS * M::QPG);                  // block 128: two blocks a group
  const int bit = warp * M::QPG / 4;                     // the warp's query block in it
  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* k = static_cast<const bf16*>(p.k);
  const bf16* v = static_cast<const bf16*>(p.v);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);          // [64][RS]
  bf16* ring = qs + kMmaRows * RS;                       // [ST][K, V][BS][RS]

  const int lo = p.grp_ptr[h * groups + group], hi = p.grp_ptr[h * groups + group + 1];
  const int units = hi - lo;
  const size_t ld = (size_t)p.H * D;                     // elements between rows
  const size_t head0 = (size_t)b * p.S * ld + h * D;      // (b, position 0, h)
  cp_async_tile<kMmaRows, D, RS, kMmaThreads>(qs, q + head0 + q0 * ld, ld, p.S - q0);
  auto issue = [&](int u, int col) {                     // unit u: key block col
    bf16* st = ring + (u % ST) * 2 * BS * RS;
    const size_t off = head0 + (size_t)col * BS * ld;
    cp_async_tile<BS, D, RS, kMmaThreads>(st, k + off, ld, BS);
    cp_async_tile<BS, D, RS, kMmaThreads>(st + BS * RS, v + off, ld, BS, BS * D / 8);
  };
  for (int s = 0; s < ST - 1; ++s) {                     // Q travels with unit 0
    if (s < units) issue(s, p.grp_cols[lo + s]);
    cp_async_commit();
  }
  // an entry's block and mask are read one unit ahead of their use
  int next_col = units > 0 ? p.grp_cols[lo] : 0;
  int next_mask = units > 0 ? p.grp_mask[lo] : 0;
  int next_issue = ST - 1 < units ? p.grp_cols[lo + ST - 1] : 0;

  float acc[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int u = 0; u < units; ++u) {
    const int col = next_col, mask = next_mask, issue_col = next_issue;
    if (u + 1 < units) {
      next_col = p.grp_cols[lo + u + 1];
      next_mask = p.grp_mask[lo + u + 1];
    }
    if (u + ST < units) next_issue = p.grp_cols[lo + u + ST];
    cp_async_wait<ST - 2>();                             // unit u has landed (this thread's part)
    __syncthreads();                                     // ... everyone's; unit u - 1 is done
    if (u + ST - 1 < units) issue(u + ST - 1, issue_col);   // into the stage unit u - 1 used
    cp_async_commit();
    // a warp whose query block does not take this key block leaves m, l
    // and acc as they are
    if (!((mask >> bit) & 1)) continue;
    const int k0 = col * BS;
    // only a block that reaches past the warp's first row needs the mask
    const bool masked = p.causal && k0 + BS - 1 > q0 + row0;
    const bf16* ks = ring + (u % ST) * 2 * BS * RS;
    const bf16* vs = ks + BS * RS;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + a_offset(lane, RS, row0, 16 * kk));
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bb[4];
        ldsm_x4(bb, ks + b_nk_offset(lane, RS, 16 * jp, 16 * kk));
        mma_m16n8k16_bf16(s[2 * jp], a, bb[0], bb[1]);
        mma_m16n8k16_bf16(s[2 * jp + 1], a, bb[2], bb[3]);
      }
    }
    // scores; the token-level causal mask at NEG_INF, its p forced to 0.
    // One max over the whole key block, as the reference's.
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    // key - row offset past which a score is dead: key k0 + 8j + col of
    // row q0 + row0 + crow is dead iff 8j + col - crow > q0 + row0 - k0
    const int live_upto = q0 + row0 - k0;
    if (masked) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + c_col(lane, e) - c_row(lane, e) > live_upto) s[j][e] = kNegInf;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[j][2 * hr + c];
          x = expf(x - m_new);
          if (masked && 8 * j + c_col(lane, c) - c_row(lane, 2 * hr) > live_upto) x = 0.f;
          sum += x;
        }
      const float alpha = expf(m[hr] - m_new);
      l[hr] = __fadd_rn(__fmul_rn(l[hr], alpha), quad_sum(sum));
      m[hr] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * hr] *= alpha;
        acc[j][2 * hr + 1] *= alpha;
      }
    }
    // acc += round(P) V
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk) {
      uint32_t a[4];
      a_from_c(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vs + b_kn_offset(lane, RS, 16 * kk, 16 * dp));
        mma_m16n8k16_bf16(acc[2 * dp], a, bb[0], bb[1]);
        mma_m16n8k16_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
  }
  cp_async_wait<0>();                                    // nothing in flight at exit

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qpos = q0 + row0 + grp + 8 * hr;
    if (qpos >= p.S) continue;
    const float lv = fmaxf(l[hr], 1e-30f);
    bf16* dst = out + ((size_t)(b * p.S + qpos) * p.H + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(acc[j][2 * hr] / lv, acc[j][2 * hr + 1] / lv);
  }
}

template <typename T, int D, int R>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  // the widest panel an instance meets: block 128 for R = 64, else block R
  const int most = smem_floats<D>(R, R == kMaxRows ? 2 * kMaxRows : R) * (int)sizeof(float);
  void (*kernel)(Params) = sparse_attention_kernel<T, D, R>;
  static bool configured = false;              // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int smem = smem_floats<D>(R, p.block) * (int)sizeof(float);
  const dim3 grid(p.S / R, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int BS>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int smem = SparseMma<D, BS>::smem_bytes;
  static bool configured = false;              // per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_attention_kernel_mma<D, BS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const long long blocks = (long long)cdiv(p.S, kMmaRows) * p.H * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  sparse_attention_kernel_mma<D, BS><<<(unsigned)blocks, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t pick_rows(const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {              // bf16: the tensor cores
    switch (p.block) {
      case 16: return launch_mma<D, 16>(p, stream);
      case 32: return launch_mma<D, 32>(p, stream);
      case 64: return launch_mma<D, 64>(p, stream);
      case 128: return launch_mma<D, 128>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  } else {                                     // fp32: the CUDA cores
    switch (p.block) {
      case 16: return launch<T, D, 16>(p, stream);
      case 32: return launch<T, D, 32>(p, stream);
      case 64:
      case 128: return launch<T, D, kMaxRows>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T>
cudaError_t pick_dim(const Params& p, int head_dim, cudaStream_t stream) {
  if (head_dim == 32) return pick_rows<T, 32>(p, stream);
  if (head_dim == 64) return pick_rows<T, 64>(p, stream);
  if (head_dim == 128) return pick_rows<T, 128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

template <int D>
int mma_smem_bytes(int block) {
  switch (block) {
    case 16: return SparseMma<D, 16>::smem_bytes;
    case 32: return SparseMma<D, 32>::smem_bytes;
    case 64: return SparseMma<D, 64>::smem_bytes;
    case 128: return SparseMma<D, 128>::smem_bytes;
  }
  return -1;
}

// Dynamic shared memory (bytes) of one launch at (head_dim, block, dtype: 0
// float32, 1 bfloat16); -1 for a combination not compiled.
extern "C" int dstt_sparse_smem_bytes(int head_dim, int block, int dtype) {
  if (block != 16 && block != 32 && block != 64 && block != 128) return -1;
  if (dtype == 1) {
    if (head_dim == 32) return mma_smem_bytes<32>(block);
    if (head_dim == 64) return mma_smem_bytes<64>(block);
    if (head_dim == 128) return mma_smem_bytes<128>(block);
    return -1;
  }
  if (dtype != 0) return -1;
  const int rows = block < kMaxRows ? block : kMaxRows;
  if (head_dim == 32) return smem_floats<32>(rows, block) * (int)sizeof(float);
  if (head_dim == 64) return smem_floats<64>(rows, block) * (int)sizeof(float);
  if (head_dim == 128) return smem_floats<128>(rows, block) * (int)sizeof(float);
  return -1;
}

// q, k, v, out [B, S, H, head_dim] contiguous in `dtype` (0 float32, 1
// bfloat16), S a multiple of block; fp32 reads row_ptr/cols, the layout's
// CSR list of live key blocks, bf16 reads grp_ptr/grp_cols/grp_mask, the
// group CSR of groups of max(1, 64 / block) query blocks, and grp_order,
// the blocks of 64 query rows (h * ceil(S / 64) + x) longest list first
// (all int32; the other lists may be null). Returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for a combination not compiled or
// a missing list.
extern "C" int dstt_sparse_attention(const void* q, const void* k, const void* v,
                                     void* out, const int* row_ptr, const int* cols,
                                     const int* grp_ptr, const int* grp_cols,
                                     const int* grp_mask, const int* grp_order,
                                     int B, int S, int H,
                                     int head_dim, int block, int causal, float scale,
                                     int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || block <= 0 || S % block != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 ? (row_ptr == nullptr || cols == nullptr)
                 : (grp_ptr == nullptr || grp_cols == nullptr || grp_mask == nullptr ||
                    grp_order == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, row_ptr, cols, grp_ptr, grp_cols, grp_mask, grp_order,
           B, S, H, block, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)pick_dim<float>(p, head_dim, s);
  if (dtype == 1) return (int)pick_dim<__nv_bfloat16>(p, head_dim, s);
  return (int)cudaErrorInvalidValue;
}
