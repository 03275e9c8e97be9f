// f32-FMA tile helpers shared by the flash-attention `fma` bodies
// (csrc/flash_attention.cu forward, csrc/flash_attention_bwd.cu dq and
// dk/dv) on sm_90a.
//
// The `fma` bodies run where no tensor-core tile applies: f32 inputs (a
// tensor-core f32 product would be TF32) and bf16 / f16 at a head dim
// that is not a multiple of 16. Every product is an f32 FMA out of f32
// tiles in shared memory; blocks are 4 warps and stream 32-wide tiles
// (keys in the forward and dq, queries in dk/dv) through a 2-stage ring
// filled by `load`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace fma_tile {

constexpr int WARPS = 4;              // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 32;                // rows of a streamed tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ float part(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// The causal / window tile skip for query rows [q_start, q_start + R)
// against a BK-wide kv tile at k_start (bottom-right alignment: query i
// sits at position i + off, off = Skv - Sq).
__device__ __forceinline__ bool tile_runs(int q_start, int R, int k_start,
                                          int off, int causal, int window) {
  bool run = true;
  if (causal) run = k_start <= q_start + R - 1 + off;
  if (window > 0) run = run && (k_start + BK - 1 >= q_start + off - window + 1);
  return run;
}

// Rows [0, valid) x columns [0, D) of a row-major (rows x D) source into
// a ROWS x DP f32 tile of row stride LD floats in shared memory, zeros
// elsewhere. f32 with `vec` (D % 4 == 0, 16-byte aligned rows): 16-byte
// cp.async; other f32: 4-byte cp.async; bf16 / f16: loaded, widened to
// f32 and stored by the thread (a copy cannot widen).
template <typename T, int ROWS, int DP, int LD>
__device__ __forceinline__ void load(float* dst, const T* src, int valid, int D,
                                     bool vec, int tid) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      constexpr int CH = DP / 4;
      static_assert(ROWS * CH % THREADS == 0, "whole chunks per thread");
      const int dch = D / 4;
#pragma unroll
      for (int i = 0; i < ROWS * CH / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / CH;
        const int c = e - r * CH;
        const bool in = r < valid && c < dch;
        tile::cp_async16(tile::smem_addr(dst + r * LD + 4 * c),
                         in ? src + (size_t)r * D + 4 * c : src, in);
      }
      return;
    }
    for (int e = tid; e < ROWS * DP; e += THREADS) {
      const int r = e / DP;
      const int d = e - r * DP;
      const bool in = r < valid && d < D;
      tile::cp_async4(tile::smem_addr(dst + r * LD + d), in ? src + (size_t)r * D + d : src,
                      in);
    }
  } else {
    constexpr int N = ROWS * DP / THREADS;
    static_assert(N % 8 == 0, "whole batches per thread");
#pragma unroll 1
    for (int i0 = 0; i0 < N; i0 += 8) {  // 8 loads in flight, then their stores
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + (i0 + i) * THREADS;
        const int r = e / DP;
        const int d = e - r * DP;
        x[i] = r < valid && d < D ? to_f32(src[(size_t)r * D + d]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + (i0 + i) * THREADS;
        dst[(e / DP) * LD + e % DP] = x[i];
      }
    }
  }
}

}  // namespace fma_tile
