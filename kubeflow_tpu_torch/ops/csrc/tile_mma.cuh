// Tensor-core tile helpers shared by the flash-attention kernels (sm_90a).
//
// Inline PTX only, no CUTLASS: 16-byte asynchronous copies into shared
// memory (cp.async with zero fill), 8x8 matrix loads from shared memory
// (ldmatrix, plain and transposed) and the warp-level bf16/f16 product
// mma.sync.m16n8k16 with f32 accumulators.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), two 16-bit values per 32-bit register, the lower index
// in the low half:
//   A (16 x 16, rows m, cols k): a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..),
//                                a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..)
//   B (16 x 8, k x n):           b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n g)
//   C (16 x 8, f32):             c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..)
// So the accumulators of two neighbouring n8 tiles, packed in pairs, are
// the A fragment of one k16 step: a product's result feeds the next
// product from registers.
//
// Shared-memory tiles hold rows of DP 16-bit values (DP = 64 or 128: 128
// or 256 bytes) cut into 16-byte chunks; chunk c of row r sits at chunk
// c ^ (r & 7). The 8 rows one ldmatrix reads at one logical chunk then
// fall in 8 distinct 16-byte bank groups: no bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace tile {

constexpr float NEG_INF = -1e30f;  // the masked-score and dead-row sentinel
constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile

// `_tile_mask` of the Pallas kernels for one (query, key) pair, in the
// bottom-right alignment (query i at position i + Skv - Sq).
template <bool SEG>
__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window, int qs, int ks) {
  bool keep = true;
  if (causal) {
    keep = kpos <= qpos;
    if (window > 0) keep = keep && (qpos - kpos < window);
  }
  if (SEG) keep = keep && (qs == ks);
  return keep;
}

// The tile skip: false when no pair of the (q tile, kv tile) is visible.
__device__ __forceinline__ bool tile_runs(int q_start, int R, int k_start,
                                          int off, int causal, int window) {
  bool run = true;
  if (causal) run = k_start <= q_start + R - 1 + off;
  if (window > 0) run = run && (k_start + BK - 1 >= q_start + off - window + 1);
  return run;
}

// True when every pair of the tile is visible under the causal and window
// masks: rows [0, R) of the q tile against keys [0, BK) of the kv tile.
__device__ __forceinline__ bool tile_whole(int q_start, int R, int k_start,
                                           int off, int causal, int window) {
  if (!causal) return true;
  return k_start + BK - 1 <= q_start + off &&
         (window <= 0 || q_start + R - 1 + off - k_start < window);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a tile of DP 16-bit values a row
template <int DP>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (DP * 2) + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 matrices; lane 8i..8i+7 gives the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed (rows given are the k axis of B)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a * b on the tensor cores, 16 x 8 x 16, f32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&d)[4], const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to nearest-even in T, packed (lo in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of k16 step kc from accumulators of n8 tiles 2kc, 2kc+1
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// Copy rows [0, valid) x chunks [0, D / 8) of a row-major (rows x D) 16-bit
// source into a swizzled ROWS x DP tile; other rows and chunks are zeros.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const void* src, int valid,
                                          int D, int tid) {
  constexpr int CH = DP / 8;
  static_assert(ROWS * CH % THREADS == 0, "whole chunks per thread");
  const char* s = static_cast<const char*>(src);
  const int dch = D / 8;
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / CH;
    const int c = e - r * CH;
    const bool in = r < valid && c < dch;
    cp_async16(dst + swz<DP>(r, c), in ? s + ((size_t)r * D + c * 8) * 2 : s, in);
  }
}

// Copy n 32-bit words (zero beyond valid) into shared memory.
template <int THREADS>
__device__ __forceinline__ void load_words(uint32_t dst, const void* src, int n,
                                           int valid, int tid) {
  const char* s = static_cast<const char*>(src);
  for (int i = tid; i < n; i += THREADS) {
    cp_async4(dst + 4 * i, i < valid ? s + 4 * i : s, i < valid);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace tile
