// Warp-level tensor-core helpers for Hopper (sm_90a): `mma.sync` m16n8k16
// on bf16 with fp32 accumulation, `ldmatrix` (plain and transposed) from
// shared memory, `cp.async` copies with zero-fill (16 and 4 bytes, and a
// whole bf16 tile), and the fragment maps that tie them together. Included by the kernels that multiply
// per warp rather than per warpgroup (`wgmma`): tiles of 16 rows, depths of
// 16 bytes and row strides that TMA does not take.
//
// Fragments of m16n8k16 (lane = 4 * grp + tig, grp 0..7, tig 0..3):
//   A (16 x 16, row-major)  a0: row grp,     cols 2 tig, 2 tig + 1
//                           a1: row grp + 8, cols 2 tig, 2 tig + 1
//                           a2: row grp,     cols 2 tig + 8, 2 tig + 9
//                           a3: row grp + 8, cols 2 tig + 8, 2 tig + 9
//   B (16 x 8, k x n)       b0: k 2 tig, 2 tig + 1,     col grp
//                           b1: k 2 tig + 8, 2 tig + 9, col grp
//   C (16 x 8, fp32)        c0, c1: row grp,     cols 2 tig, 2 tig + 1
//                           c2, c3: row grp + 8, cols 2 tig, 2 tig + 1
// So the C tiles of two adjacent n8 column groups, rounded to bf16 pairs,
// are the A fragment of the next product over those 16 columns
// (`a_from_c`): p is rounded in registers where the reference rounds it.
//
// Shared tiles are [rows][stride] bf16 with stride = width + 8 elements:
// the 16-byte pad puts the 8 rows an `ldmatrix` phase reads on 8 distinct
// groups of 4 banks, for every width here (16..128).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace warp_mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until waited for; zeros when !valid
// (`src` is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 4 bytes global -> shared (for rows whose starts are not 16-byte aligned).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of a [ROWS][W] bf16 tile (W a multiple of 8) into dst,
// row stride RS elements, from rows src + r * ld (elements) for r <
// valid_rows, zeros past them; THREADS threads of the block share the
// chunks. Each thread's chunks are a compile-time list: where they fall in
// one column of chunks, one pointer walks down the rows, so no per-chunk
// address stays live across the caller's loop. A tile of fewer chunks
// than threads starts at thread `first`, so that several tiles in a row
// spread over the block.
template <int ROWS, int W, int RS, int THREADS>
__device__ __forceinline__ void cp_async_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              size_t ld, int valid_rows, int first = 0) {
  constexpr int CPR = W / 8;                           // 16-byte chunks a row
  if constexpr (THREADS % CPR == 0 && ROWS % (THREADS / CPR) == 0) {
    constexpr int RPI = THREADS / CPR;                 // rows a pass covers
    const int r0 = threadIdx.x / CPR, c = (threadIdx.x % CPR) * 8;
    const __nv_bfloat16* s = src + r0 * ld + c;
#pragma unroll
    for (int i = 0; i < ROWS / RPI; ++i) {
      const int r = r0 + i * RPI;
      cp_async_16(dst + r * RS + c, r < valid_rows ? s + (size_t)i * RPI * ld : src,
                  r < valid_rows);
    }
  } else {
    constexpr int N = ROWS * CPR;
    const int tid = (threadIdx.x + THREADS - first % THREADS) % THREADS;
#pragma unroll
    for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (N % THREADS != 0 && e >= N) break;
      const int r = e / CPR, c = (e % CPR) * 8;
      cp_async_16(dst + r * RS + c, r < valid_rows ? src + r * ld + c : src, r < valid_rows);
    }
  }
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8, row
// l % 8, and receives r[i] = matrix i's (row l / 4, cols 2 (l % 4), +1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}
// As ldsm_x4, transposed: r[i] = matrix i's (rows 2 (l % 4), +1; col l / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}
// Two matrices, transposed; lanes 0..15 give the addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(row)));
}

// d += a . b on the tensor cores: bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment over 16 columns from the C tiles of its two n8 halves.
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Row and column, inside its 16 x 8 tile, of C element e (0..3) of `lane`.
__device__ __forceinline__ int c_row(int lane, int e) { return lane / 4 + (e >= 2 ? 8 : 0); }
__device__ __forceinline__ int c_col(int lane, int e) { return 2 * (lane % 4) + (e & 1); }

// Where `lane` points ldmatrix in a [rows][stride] tile, from (row0, col0):
//   A of rows row0..+15, cols col0..+15 (ldsm_x4 gives a0..a3);
__device__ __forceinline__ int a_offset(int lane, int stride, int row0, int col0) {
  return (row0 + lane % 16) * stride + col0 + (lane / 16) * 8;
}
//   B from a [n][k] tile (rows are the n index, e.g. K for Q.K^T): n rows
//   n0..+15, k cols k0..+15; ldsm_x4 gives (b0, b1) of n0..+7 in r[0], r[1]
//   and of n0+8..+15 in r[2], r[3];
__device__ __forceinline__ int b_nk_offset(int lane, int stride, int n0, int k0) {
  return (n0 + (lane / 16) * 8 + lane % 8) * stride + k0 + ((lane / 8) % 2) * 8;
}
//   B from a [k][n] tile (rows are the k index, e.g. V for P.V): k rows
//   k0..+15, n cols n0..+15; ldsm_x4_t gives (b0, b1) of n0..+7 in r[0],
//   r[1] and of n0+8..+15 in r[2], r[3]; ldsm_x2_t the first pair alone.
__device__ __forceinline__ int b_kn_offset(int lane, int stride, int k0, int n0) {
  return (k0 + ((lane / 8) % 2) * 8 + lane % 8) * stride + n0 + (lane / 16) * 8;
}

// The max and the sum over the 4 lanes that share a C row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace warp_mma
