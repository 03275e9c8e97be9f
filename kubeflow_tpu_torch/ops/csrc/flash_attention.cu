// Flash-attention forward (online softmax, blockwise) for Hopper (sm_90a).
//
// Replaces the Pallas kernel kubeflow_tpu/ops/flash_attention.py
// (`_attn_kernel`, launched by `_flash_forward` at line 120): blockwise
// attention of q against k/v (B, H, S, D) with causal, sliding-window and
// segment-id masks, returning the output in q's dtype and the per-row
// log-sum-exp lse = m + log(l) in f32.
//
// What bounds it on the H100: the work is 4 * D flops per visible
// (query, key) pair against one read of q, k, v and one write of out and
// lse. At the training shape (B = 8, H = 16, S = 512, D = 64, causal,
// bf16) that is 33.6 MB, 10.0 us at 3.35 TB/s, against 4.3 GFLOP, 4.4 us
// of the 989 TFLOP/s bf16 tensor-core rate: bound by bytes, but so short
// that latency (up to 8 kv tiles a block in sequence, two waves of
// blocks) sets the pace.
//
// Two bodies, chosen in the C entry point by dtype and D only (mirrored
// by `body()` in ops/flash_attention.py):
//
// * bf16 / f16 with D a multiple of 16 up to 128: `flash_fwd_mma_kernel`,
//   on the tensor cores. 4 warps, each owning 16 of the block's 64 query
//   rows. The q tile is copied once and held in registers as mma A
//   fragments; k/v tiles of 64 keys stream through a 2-stage shared-memory
//   ring filled by 16-byte cp.async copies, so the next tile loads while
//   this one computes. S = Q.K^T runs as mma.sync.m16n8k16 (bf16/f16
//   operands, f32 accumulators), then `* scale` in f32 and the masks on
//   the accumulator fragment. The online softmax stays in registers (row
//   max and sum over the 4 lanes of a quad with __shfl_xor_sync); p is
//   rounded to the input dtype as the A operand of P.V straight from the
//   accumulators (tile_mma.cuh), and V is read with ldmatrix.trans. Scores
//   and probabilities never leave registers. The epilogue stages the
//   output through shared memory for 16-byte stores. Shared memory: 41 KB
//   at D <= 64, 81 KB at D <= 128, so several blocks share an SM. Blocks
//   are launched with the q tiles that see the most kv tiles first.
//   mma.sync rather than wgmma: at 64-row tiles and S <= 512 the kernel
//   is latency-bound long before the tensor-core rate matters, and
//   mma.sync's fixed register fragments let P feed P.V from registers
//   without descriptors or a second warpgroup layout.
// * f32, and bf16 / f16 at any other D: `flash_fwd_fma_kernel`, f32 FMAs
//   only. A tensor-core f32 product would be TF32 (or 3xTF32), about
//   three decimal digits, and would break the f32 parity gates, so this
//   body is bound by the f32 FMA pipe: 4 * D flops a visible pair at 67
//   TFLOP/s against one read of q, k, v and one write of out and lse at
//   3.35 TB/s. At the BERT serving shape (B = 8, H = 12, S = 128, D = 64,
//   padding segments, 105,528 visible pairs a head) that is 0.324 GFLOP,
//   0.0048385 ms, against 12.64 MB, 0.0038 ms: bound by operations. So
//   the design keeps the FMA pipe fed and enough warps in flight:
//   - Scores as register micro-tiles. Each lane owns 2 query rows x 4
//     keys and forms them by outer products over d from 16-byte shared
//     loads: 6 loads for 32 FMAs. The rows (or 8 keys) one load reads
//     sit in distinct bank groups (rows padded by 4 floats), and the
//     lanes that share a row read one address.
//   - Softmax in registers. A row's 32 keys of a tile lie on the 8 lanes
//     of its row group: max by __shfl_xor_sync, every lane works, and l
//     stays a per-lane partial summed once at the end.
//   - P.V. p (rounded to the input dtype) goes once a tile through the
//     warp's own p tile in shared memory; the 2 x 8 (D <= 64) output
//     micro-tile, the row max and sum stay in registers across kv tiles,
//     rescaled by alpha there: no shared-memory accumulator.
//   - K/V ring. 32-key tiles fill a 2-stage ring by 16-byte cp.async
//     (`fma_tile::load`, shared with the backward's `fma` bodies in
//     fma_tile.cuh), so tile ik + 1 loads while ik computes, with the
//     ragged last tile and columns past D zero-filled. f32 rows that are
//     not whole 16-byte chunks take 4-byte copies; bf16 / f16 (this body
//     takes them only at a D no tensor-core tile fits) are widened to f32
//     by the threads on load, without overlap. Two barriers a tile.
//   - Block shape. 4 warps of 8 query rows share one k/v ring: 46.3 KB
//     of shared memory at D <= 64 (86.3 KB at D <= 128), 4 (2) blocks an
//     SM, which `__launch_bounds__` states so ptxas may use the registers
//     that occupancy leaves. At B = 1, H = 12, S = 128 one warp's serial
//     chain over the kv tiles sets the time, so the rows a warp are few:
//     48 blocks run 192 warps (16 rows a warp took 1.8x as long on an
//     H100); B = 8 (384 blocks) fits in one wave.
//   - Segment-tile skip. A warp skips a kv tile in which none of its
//     rows sees a key (segments, causal, window): exact for a row that
//     sees some key. A dead row (its segment id at no visible kv
//     position) must keep out = mean(v) over every key it walks and lse
//     at the -1e30 sentinel, so a warp skips only when each of its rows
//     is live, which it decides from one pass over the kv segment ids.
//     Causal and window tiles outside a block's reach are not loaded.
//
// TPU grid -> CUDA blocks: the Pallas grid (B, H, q blocks, kv blocks)
// ran the kv axis sequentially ("arbitrary") with the accumulator in VMEM
// scratch. Here one thread block owns one (q tile, head, batch) and loops
// over kv tiles; the loop replaces the sequential grid axis. Tiles wholly
// in the causal future or wholly before the window are skipped, as
// `_attn_kernel` does (lines 74-78). The tile mask is `_tile_mask` (line
// 206) in `_full_mask`'s bottom-right alignment (query i sits at position
// i + Skv - Sq).
//
// Numerics follow `_attn_kernel`: scores in f32, masked entries set to
// -1e30, p = exp(s - m) with p rounded to the input dtype for the p.v
// product (the Pallas `p.astype(v.dtype)`), l summed from the unrounded
// p, rows with l == 0 written as zeros. Keys past Skv in a ragged last
// tile add exactly 0. s - m is formed in f32 before the exponential, so a
// row whose visible keys so far are all masked (s = m = -1e30) gets
// p = exp(0) = 1 as in the reference, and a dead row (no visible key at
// all) ends with out = mean(v) and lse at the -1e30 sentinel the backward
// kernels test.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "fma_tile.cuh"
#include "tile_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per kv tile

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// ---------------------------------------------------------------- fma body

using fma_tile::FULL;
using fma_tile::part;
constexpr int FMA_THREADS = fma_tile::THREADS;  // 4 warps
constexpr int FMA_RPW = 8;                 // query rows a warp
constexpr int FMA_BQ = FMA_RPW * fma_tile::WARPS;  // query rows a block
constexpr int FMA_BK = fma_tile::BK;       // keys a kv tile
constexpr int FMA_PST = FMA_BK + 4;        // row stride (floats) of a warp's p tile

// floats of the fma body's shared memory at head-dim tile DP: the q tile
// and a 2-stage k ring (rows of DP + 4), a 2-stage v ring (rows of DP),
// one p tile a warp and a 2-stage ring of kv segment ids
constexpr size_t fma_smem_floats(int DP) {
  return (size_t)FMA_BQ * (DP + 4) + 2 * (size_t)FMA_BK * (DP + 4) +
         2 * (size_t)FMA_BK * DP + (size_t)FMA_BQ * FMA_PST + 2 * FMA_BK;
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(FMA_THREADS, DP == 64 ? 4 : 2) flash_fwd_fma_kernel(
    const T* __restrict__ q,       // (B, H, Sq, D)
    const T* __restrict__ k,       // (B, H, Skv, D)
    const T* __restrict__ v,       // (B, H, Skv, D)
    const int* __restrict__ qseg,  // (B, Sq) when SEG
    const int* __restrict__ kseg,  // (B, Skv) when SEG
    T* __restrict__ out,           // (B, H, Sq, D)
    float* __restrict__ lse,       // (B, H, Sq)
    int H, int Sq, int Skv, int D, int causal, int window, float scale, int vec) {
  constexpr int KST = DP + 4;  // q and k rows: the 4 rows or 8 keys one load reads
                               // fall in distinct 16-byte bank groups
  constexpr int VST = DP;      // v rows: a load reads 8 neighbouring chunks of one row
  constexpr int NC = DP / 32;  // float4 output chunks a lane: kg + 8c
  constexpr int RI = FMA_RPW / 4;  // query rows a lane: rg + 4i
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // most kv tiles first
  const int q_start = iq * FMA_BQ;
  const int R = min(FMA_BQ, Sq - q_start);
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane >> 3;  // this lane's rows: rg + 4i of its warp's FMA_RPW
  const int kg = lane & 7;   // its keys: kg + 8jj of a tile; its output chunks kg + 8c
  const int w0 = warp * FMA_RPW;  // the warp's first row in the block
  const bool vec4 = vec != 0;

  extern __shared__ __align__(16) float fsmem[];
  float* q_s = fsmem;                          // FMA_BQ x KST
  float* k_s = q_s + FMA_BQ * KST;             // 2 stages x FMA_BK x KST
  float* v_s = k_s + 2 * FMA_BK * KST;         // 2 stages x FMA_BK x VST
  float* p_s = v_s + 2 * FMA_BK * VST;         // FMA_WARPS x FMA_RPW x FMA_PST
  int* kseg_s = reinterpret_cast<int*>(p_s + FMA_BQ * FMA_PST);  // 2 stages x FMA_BK
  float* p_w = p_s + w0 * FMA_PST;             // this warp's p tile

  const size_t bh = (size_t)b * H + h;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  // the kv tiles that run (causal and window skips) form one range [lo, hi]
  const int nk = (Skv + FMA_BK - 1) / FMA_BK;
  int lo = nk, hi = -1;
  for (int ik = 0; ik < nk; ++ik) {
    if (fma_tile::tile_runs(q_start, R, ik * FMA_BK, off, causal, window)) {
      lo = min(lo, ik);
      hi = ik;
    }
  }

  auto load_kv = [&](int ik, int st) {
    const int k0 = ik * FMA_BK;
    const int C = min(FMA_BK, Skv - k0);
    fma_tile::load<T, FMA_BK, DP, KST>(k_s + st * FMA_BK * KST, kb + (size_t)k0 * D, C, D, vec4, tid);
    fma_tile::load<T, FMA_BK, DP, VST>(v_s + st * FMA_BK * VST, vb + (size_t)k0 * D, C, D, vec4, tid);
    if (SEG) {
      tile::load_words<FMA_THREADS>(tile::smem_addr(kseg_s + st * FMA_BK),
                                    kseg + (size_t)b * Skv + k0, FMA_BK, C, tid);
    }
  };
  fma_tile::load<T, FMA_BQ, DP, KST>(q_s, q + (bh * Sq + q_start) * D, R, D, vec4, tid);
  if (lo <= hi) load_kv(lo, 0);
  tile::cp_async_commit();

  int qs[RI], qpos[RI];
  bool rin[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int lr = w0 + rg + 4 * i;
    rin[i] = lr < R;
    qpos[i] = q_start + lr + off;
    qs[i] = SEG && rin[i] ? qseg[(size_t)b * Sq + q_start + lr] : 0;
  }

  // `live`: every valid row of this warp sees some key. Only then does
  // the warp skip a kv tile in which none of its rows sees a key: such a
  // tile adds exactly nothing to a live row (before the row's first
  // visible key its p = 1 terms are wiped by alpha = exp(-1e30 - m) = 0,
  // after it they are exp(-1e30 - m) = 0), but it is part of a dead row's
  // mean(v). With segments this takes one pass over the kv segment ids.
  const int Rw = R - w0;  // valid rows of this warp (none when <= 0)
  bool live = true;
  if (SEG) {
    int qw[FMA_RPW];
#pragma unroll
    for (int r = 0; r < FMA_RPW; ++r) qw[r] = __shfl_sync(FULL, qs[r >> 2], (r & 3) << 3);
    unsigned seen = 0;
    for (int j0 = lane; j0 < Skv; j0 += 128) {
      int ks[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u;
        ks[u] = j < Skv ? kseg[(size_t)b * Skv + j] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u;
#pragma unroll
        for (int r = 0; r < FMA_RPW; ++r) {
          if (j < Skv &&
              tile::visible<true>(q_start + w0 + r + off, j, causal, window, qw[r], ks[u])) {
            seen |= 1u << r;
          }
        }
      }
    }
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) seen |= __shfl_xor_sync(FULL, seen, w);
    const unsigned need = (1u << max(0, min(Rw, FMA_RPW))) - 1;
    live = (seen & need) == need;
  } else if (causal) {
    live = Rw <= 0 || q_start + w0 + off >= 0;  // a row sees its own position
  }

  float4 o[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m[RI], l[RI];  // the row's running max; this lane's part of its running sum
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  for (int ik = lo; ik <= hi; ++ik) {
    const int st = (ik - lo) & 1;
    if (ik < hi) {
      load_kv(ik + 1, st ^ 1);
      tile::cp_async_commit();
      tile::cp_async_wait<1>();
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();  // tile ik has landed for every thread
    const int k_start = ik * FMA_BK;
    const int C = min(FMA_BK, Skv - k_start);

    // this lane's visible pairs, bit 4i + jj
    unsigned vis = 0;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = kg + 8 * jj;
        if (rin[i] && kj < C &&
            tile::visible<SEG>(qpos[i], k_start + kj, causal, window, qs[i],
                               SEG ? kseg_s[st * FMA_BK + kj] : 0)) {
          vis |= 1u << (4 * i + jj);
        }
      }
    }
    const bool any = __any_sync(FULL, vis != 0);
    if (any || !live) {  // warp-uniform
      // S = Q.K^T: a RI x 4 micro-tile of outer products over d, from
      // 16-byte loads (RI + 4 loads for 16 RI FMAs)
      float s[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      }
      const float* qr = q_s + (w0 + rg) * KST;
      const float* kr = k_s + (st * FMA_BK + kg) * KST;
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        float4 a[RI], bk[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = *reinterpret_cast<const float4*>(qr + 4 * i * KST + 4 * c);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          bk[jj] = *reinterpret_cast<const float4*>(kr + 8 * jj * KST + 4 * c);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // 4 RI independent FMAs in a row
#pragma unroll
          for (int i = 0; i < RI; ++i) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              s[i][jj] = fmaf(part(a[i], e), part(bk[jj], e), s[i][jj]);
            }
          }
        }
      }

      // scale in f32, the masks, then the online softmax: a row's 32 keys
      // lie on the 8 lanes of its row group
      float mx[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        mx[i] = m[i];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float x = s[i][jj] * scale;
          if (!((vis >> (4 * i + jj)) & 1u)) {
            // -1e30 where masked; -inf past Skv, so exp gives exactly 0
            x = kg + 8 * jj < C ? NEG_INF : __uint_as_float(0xff800000u);
          }
          s[i][jj] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1) {
#pragma unroll
        for (int i = 0; i < RI; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], w));
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float alpha = expf(m[i] - mx[i]);
        m[i] = mx[i];
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p = expf(s[i][jj] - mx[i]);
          sum += p;
          s[i][jj] = fma_tile::to_f32(from_f32<T>(p));  // p.astype(v.dtype) for p.v
        }
        l[i] = l[i] * alpha + sum;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          o[i][c].x *= alpha;
          o[i][c].y *= alpha;
          o[i][c].z *= alpha;
          o[i][c].w *= alpha;
        }
      }

      // O += P.V through the warp's p tile
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) p_w[(rg + 4 * i) * FMA_PST + kg + 8 * jj] = s[i][jj];
      }
      __syncwarp();
      const float* pr = p_w + rg * FMA_PST;
      const float* vr = v_s + st * FMA_BK * VST + 4 * kg;
#pragma unroll
      for (int j = 0; j < FMA_BK; j += 4) {
        float4 pp[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) pp[i] = *reinterpret_cast<const float4*>(pr + 4 * i * FMA_PST + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 vv = *reinterpret_cast<const float4*>(vr + (j + jj) * VST + 32 * c);
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              const float p = part(pp[i], jj);
              o[i][c].x = fmaf(p, vv.x, o[i][c].x);
              o[i][c].y = fmaf(p, vv.y, o[i][c].y);
              o[i][c].z = fmaf(p, vv.z, o[i][c].z);
              o[i][c].w = fmaf(p, vv.w, o[i][c].w);
            }
          }
        }
      }
    }
    __syncthreads();  // stage st and the p tiles are free for the next tiles
  }

  // epilogue: out = acc / l in q's dtype, lse = m + log(l) in f32; rows
  // with l == 0 (no tile ran) give zeros
  tile::cp_async_wait<0>();  // the q copy, when no kv tile ran
  T* ob = out + (bh * Sq + q_start) * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 1; w < 8; w <<= 1) li += __shfl_xor_sync(FULL, li, w);
    const float dn = li == 0.f ? 1.f : li;
    const int lr = w0 + rg + 4 * i;
    if (lr >= R) continue;
    T* orow = ob + (size_t)lr * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (kg + 8 * c);
      const float x[4] = {o[i][c].x / dn, o[i][c].y / dn, o[i][c].z / dn, o[i][c].w / dn};
      if constexpr (sizeof(T) == 4) {
        if (vec4) {
          if (col < D) *reinterpret_cast<float4*>(orow + col) = make_float4(x[0], x[1], x[2], x[3]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < D) orow[col + e] = from_f32<T>(x[e]);
      }
    }
    if (kg == 0) lse[bh * Sq + q_start + lr] = m[i] + logf(dn);
  }
}

template <typename T, int DP, bool SEG>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const int* qseg, const int* kseg, void* out, float* lse,
                       int B, int H, int Sq, int Skv, int D, int causal,
                       int window, float scale, int vec, cudaStream_t stream) {
  const dim3 grid(H, B, (Sq + FMA_BQ - 1) / FMA_BQ);
  const size_t smem = sizeof(float) * fma_smem_floats(DP);
  auto kern = flash_fwd_fma_kernel<T, DP, SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qseg, kseg, static_cast<T*>(out), lse, H, Sq,
      Skv, D, causal, window, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_any(bool seg, const void* q, const void* k, const void* v,
                           const int* qseg, const int* kseg, void* out, float* lse,
                           int B, int H, int Sq, int Skv, int D, int causal,
                           int window, float scale, int vec, cudaStream_t stream) {
#define KFT_ARGS q, k, v, qseg, kseg, out, lse, B, H, Sq, Skv, D, causal, window, scale, vec, stream
  if (D <= 64) return seg ? launch_fma<T, 64, true>(KFT_ARGS) : launch_fma<T, 64, false>(KFT_ARGS);
  return seg ? launch_fma<T, 128, true>(KFT_ARGS) : launch_fma<T, 128, false>(KFT_ARGS);
#undef KFT_ARGS
}

// ---------------------------------------------------------------- mma body

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(MMA_THREADS) flash_fwd_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    T* __restrict__ out, float* __restrict__ lse,
    int H, int Sq, int Skv, int D, int causal, int window, float scale) {
  constexpr int KC = DP / 16;                // k16 steps over the head dim
  constexpr int NT = BK / 8;                 // n8 tiles of a score row
  constexpr int DT = DP / 8;                 // n8 tiles of an output row
  constexpr int CH = DP / 8;                 // 16-byte chunks of a tile row
  constexpr uint32_t TILE = BK * DP * 2;     // bytes of one q, k or v tile
  static_assert(BQ == BK, "q and kv tiles share the tile size");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // most kv tiles first
  const int q_start = iq * BQ;
  const int R = min(BQ, Sq - q_start);
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  extern __shared__ __align__(128) unsigned char tsmem[];
  const uint32_t q_s = tile::smem_addr(tsmem);  // q tile; the output at the end
  const uint32_t k_s = q_s + TILE;             // 2 stages
  const uint32_t v_s = k_s + 2 * TILE;         // 2 stages
  int* qseg_s = reinterpret_cast<int*>(tsmem + 5 * TILE);  // BQ
  int* kseg_s = qseg_s + BQ;                               // 2 stages x BK

  const size_t bh = (size_t)b * H + h;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  // the kv tiles that run form one range [lo, hi]
  const int nk = (Skv + BK - 1) / BK;
  int lo = nk, hi = -1;
  for (int ik = 0; ik < nk; ++ik) {
    if (tile::tile_runs(q_start, R, ik * BK, off, causal, window)) {
      lo = min(lo, ik);
      hi = ik;
    }
  }

  auto load_kv = [&](int ik, int st) {
    const int k0 = ik * BK;
    const int C = min(BK, Skv - k0);
    tile::load_tile<BK, DP, MMA_THREADS>(k_s + st * TILE, kb + (size_t)k0 * D, C, D, tid);
    tile::load_tile<BK, DP, MMA_THREADS>(v_s + st * TILE, vb + (size_t)k0 * D, C, D, tid);
    if (SEG) {
      tile::load_words<MMA_THREADS>(tile::smem_addr(kseg_s + st * BK),
                                    kseg + (size_t)b * Skv + k0, BK, C, tid);
    }
  };
  tile::load_tile<BQ, DP, MMA_THREADS>(q_s, q + (bh * Sq + q_start) * D, R, D, tid);
  if (SEG) {
    tile::load_words<MMA_THREADS>(tile::smem_addr(qseg_s), qseg + (size_t)b * Sq + q_start,
                                  BQ, R, tid);
  }
  if (lo <= hi) load_kv(lo, 0);
  tile::cp_async_commit();

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows r0, r0 + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's part of the running sum
  uint32_t qf[KC][4];

  for (int ik = lo; ik <= hi; ++ik) {
    const int st = (ik - lo) & 1;
    if (ik < hi) {
      load_kv(ik + 1, st ^ 1);
      tile::cp_async_commit();
      tile::cp_async_wait<1>();
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();  // tile ik has landed for every thread
    if (ik == lo) {
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        tile::ldsm_x4(qf[kk], q_s + tile::swz<DP>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4)));
      }
    }
    const int k_start = ik * BK;
    const int C = min(BK, Skv - k_start);
    const uint32_t ks = k_s + st * TILE;
    const uint32_t vs = v_s + st * TILE;

    // S = Q . K^T (keys of the tile along n)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t bf[4];
        tile::ldsm_x4(bf, ks + tile::swz<DP>(16 * p + (lane & 7) + ((lane >> 4) << 3),
                                             2 * kk + ((lane >> 3) & 1)));
        tile::mma<T>(s[2 * p], qf[kk], bf[0], bf[1]);
        tile::mma<T>(s[2 * p + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale in f32, then the masks: -1e30 where masked, -inf past Skv
    const bool whole = !SEG && C == BK &&
                       tile::tile_whole(q_start, R, k_start, off, causal, window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (!whole) {
          const int r = r0 + ((e >> 1) << 3);
          const int kj = j * 8 + 2 * t + (e & 1);
          if (kj >= C) {
            x = __uint_as_float(0xff800000u);  // -inf: exp gives exactly 0, even on a dead row
          } else if (!tile::visible<SEG>(q_start + r + off, k_start + kj, causal, window,
                                         SEG ? qseg_s[r] : 0,
                                         SEG ? kseg_s[st * BK + kj] : 0)) {
            x = NEG_INF;
          }
        }
        s[j][e] = x;
      }
    }

    // online softmax over the quad that shares a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float a0 = __expf(m0 - mx0);
    const float a1 = __expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = __expf(s[j][0] - mx0);
      s[j][1] = __expf(s[j][1] - mx0);
      s[j][2] = __expf(s[j][2] - mx1);
      s[j][3] = __expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= a0;
      o[d][1] *= a0;
      o[d][2] *= a1;
      o[d][3] *= a1;
    }

    // O += P . V, P rounded to the input dtype as the A operand
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      uint32_t pa[4];
      tile::acc_to_a<T>(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int p = 0; p < DT / 2; ++p) {
        uint32_t bf[4];
        tile::ldsm_x4_t(bf, vs + tile::swz<DP>(16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * p + (lane >> 4)));
        tile::mma<T>(o[2 * p], pa, bf[0], bf[1]);
        tile::mma<T>(o[2 * p + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // stage st is free for the tile after next
  }

  // epilogue: out = acc / l in q's dtype through shared memory, lse in f32
  tile::cp_async_wait<0>();  // the q copy, when no kv tile ran
  __syncthreads();
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float d0 = l0 == 0.f ? 1.f : l0;
  const float d1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    *reinterpret_cast<uint32_t*>(tsmem + tile::swz<DP>(r0, d) + 4 * t) =
        tile::pack2<T>(o[d][0] / d0, o[d][1] / d0);
    *reinterpret_cast<uint32_t*>(tsmem + tile::swz<DP>(r0 + 8, d) + 4 * t) =
        tile::pack2<T>(o[d][2] / d1, o[d][3] / d1);
  }
  if (t == 0) {
    if (r0 < R) lse[bh * Sq + q_start + r0] = m0 + logf(d0);
    if (r0 + 8 < R) lse[bh * Sq + q_start + r0 + 8] = m1 + logf(d1);
  }
  __syncthreads();
  T* ob = out + (bh * Sq + q_start) * D;
  const int dch = D / 8;
#pragma unroll
  for (int i = 0; i < BQ * CH / MMA_THREADS; ++i) {
    const int e = tid + i * MMA_THREADS;
    const int r = e / CH;
    const int c = e - r * CH;
    if (r < R && c < dch) {
      *reinterpret_cast<uint4*>(ob + (size_t)r * D + c * 8) =
          *reinterpret_cast<const uint4*>(tsmem + tile::swz<DP>(r, c));
    }
  }
}

template <typename T, int DP, bool SEG>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* qseg, const int* kseg, void* out, float* lse,
                       int B, int H, int Sq, int Skv, int D, int causal,
                       int window, float scale, cudaStream_t stream) {
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  const size_t smem = 5 * (size_t)BK * DP * 2 + sizeof(int) * (BQ + 2 * BK);
  auto kern = flash_fwd_mma_kernel<T, DP, SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qseg, kseg, static_cast<T*>(out), lse, H, Sq,
      Skv, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mma_any(bool seg, const void* q, const void* k, const void* v,
                           const int* qseg, const int* kseg, void* out, float* lse,
                           int B, int H, int Sq, int Skv, int D, int causal,
                           int window, float scale, cudaStream_t stream) {
#define KFT_ARGS q, k, v, qseg, kseg, out, lse, B, H, Sq, Skv, D, causal, window, scale, stream
  if (D <= 64) return seg ? launch_mma<T, 64, true>(KFT_ARGS) : launch_mma<T, 64, false>(KFT_ARGS);
  return seg ? launch_mma<T, 128, true>(KFT_ARGS) : launch_mma<T, 128, false>(KFT_ARGS);
#undef KFT_ARGS
}

}  // namespace

// dtype codes shared with ops/flash_attention.py
enum { F32 = 0, BF16 = 1, F16 = 2 };

// The body that runs (mirrored by ops/flash_attention.py `body`): the
// tensor cores for bf16/f16 with D a multiple of 16 up to 128.
static bool mma_body(int dtype, int D) {
  return (dtype == BF16 || dtype == F16) && D % 16 == 0 && D <= 128;
}

extern "C" int kft_flash_forward(
    const void* q, const void* k, const void* v, const void* q_seg,
    const void* kv_seg, void* out, void* lse, int B, int H, int Sq, int Skv,
    int D, int causal, int window, float scale, int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (D <= 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  const int* qs = static_cast<const int*>(q_seg);
  const int* ks = static_cast<const int*>(kv_seg);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool seg = qs != nullptr;
#define KFT_ARGS q, k, v, qs, ks, out, l, B, H, Sq, Skv, D, causal, window, scale, st
  if (mma_body(dtype, D)) {
    // 16-byte copies and stores
    if (!tile::aligned16(q) || !tile::aligned16(k) || !tile::aligned16(v) ||
        !tile::aligned16(out)) {
      return (int)cudaErrorMisalignedAddress;
    }
    cudaError_t err = dtype == BF16 ? launch_mma_any<__nv_bfloat16>(seg, KFT_ARGS)
                                    : launch_mma_any<__half>(seg, KFT_ARGS);
    return (int)err;
  }
  if (D > 128) return (int)cudaErrorInvalidValue;
  // f32 rows of whole 16-byte chunks: 16-byte copies and stores
  const int vec = dtype == F32 && D % 4 == 0 && tile::aligned16(q) && tile::aligned16(k) &&
                  tile::aligned16(v) && tile::aligned16(out);
#define KFT_ARGS_FMA q, k, v, qs, ks, out, l, B, H, Sq, Skv, D, causal, window, scale, vec, st
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32) err = launch_fma_any<float>(seg, KFT_ARGS_FMA);
  if (dtype == BF16) err = launch_fma_any<__nv_bfloat16>(seg, KFT_ARGS_FMA);
  if (dtype == F16) err = launch_fma_any<__half>(seg, KFT_ARGS_FMA);
#undef KFT_ARGS_FMA
#undef KFT_ARGS
  return (int)err;
}

extern "C" const char* kft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
