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
// operand bytes are about even (0.025-0.03 ms each on this card). This first
// version is simple and correct, not fast: it multiplies on the fp32 CUDA
// cores from shared memory, as the port's flash kernels do.
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
// Not done yet (later work): mma.sync / wgmma on the tensor cores, cp.async
// or TMA double buffering of the next live block, and several query blocks
// per thread block for block 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr float kNegInf = -1e30f;      // the reference's NEG_INF
constexpr int kMaxRows = 64;           // query rows (and keys) of one tile

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

template <typename T, int D>
cudaError_t pick_rows(const Params& p, cudaStream_t stream) {
  switch (p.block) {
    case 16: return launch<T, D, 16>(p, stream);
    case 32: return launch<T, D, 32>(p, stream);
    case 64:
    case 128: return launch<T, D, kMaxRows>(p, stream);
    default: return cudaErrorInvalidValue;
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

// Dynamic shared memory (bytes) of one launch at (head_dim, block); -1 for a
// combination not compiled.
extern "C" int dstt_sparse_smem_bytes(int head_dim, int block) {
  if (block != 16 && block != 32 && block != 64 && block != 128) return -1;
  const int rows = block < kMaxRows ? block : kMaxRows;
  if (head_dim == 32) return smem_floats<32>(rows, block) * (int)sizeof(float);
  if (head_dim == 64) return smem_floats<64>(rows, block) * (int)sizeof(float);
  if (head_dim == 128) return smem_floats<128>(rows, block) * (int)sizeof(float);
  return -1;
}

// q, k, v, out [B, S, H, head_dim] contiguous in `dtype` (0 float32, 1
// bfloat16), S a multiple of block; row_ptr/cols the layout's CSR list of
// live key blocks (int32). Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a combination not compiled.
extern "C" int dstt_sparse_attention(const void* q, const void* k, const void* v,
                                     void* out, const int* row_ptr, const int* cols,
                                     int B, int S, int H, int head_dim, int block,
                                     int causal, float scale, int dtype,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || block <= 0 || S % block != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, out, row_ptr, cols, B, S, H, block, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)pick_dim<float>(p, head_dim, s);
  if (dtype == 1) return (int)pick_dim<__nv_bfloat16>(p, head_dim, s);
  return (int)cudaErrorInvalidValue;
}
