// Flash-attention backward (dq; dk and dv) for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of kubeflow_tpu/ops/flash_attention.py
// `flash_attention_bwd` (line 367): `_bwd_dq_kernel` (line 246, launched at
// line 453) and `_bwd_dkv_kernel` (line 300, launched at line 484). Both
// recompute the probabilities of a (q tile, kv tile) pair from the saved
// per-row log-sum-exp instead of reading an S x S matrix:
//
//   p  = exp(s * scale - lse)   0 where masked, 0 on dead rows (lse <= -5e29)
//   dp = dO . V^T
//   ds = p * (dp - delta) * scale, rounded to q's dtype
//   dq = ds . K           dk = ds^T . Q           dv = p_(dO dtype)^T . dO
//
// with delta = rowsum(dO * O) computed by the caller, every product
// accumulated in f32 and every gradient written in f32 (the Pallas
// `accum_dtype`).
//
// What bounds it on the H100: at the training shape (B = 8, H = 16,
// S = 512, D = 64, causal, bf16) the dq kernel reads q, k, v, dO, lse,
// delta and writes dq in f32: about 50 MB, 15 us at 3.35 TB/s; the dk/dv
// kernel writes two f32 gradients: about 67 MB, 20 us. Its operations
// are 6 * D flops per visible (query, key) pair for dq (s, dp, dq) and
// 8 * D for dk/dv (s, dp, dk, dv): about 6.5 us and 8.7 us of the 989
// TFLOP/s bf16 tensor-core rate. Both are bound by bytes.
//
// TPU grid -> CUDA blocks: the Pallas grids (B, H, q blocks, kv blocks) for
// dq and (B, H, kv blocks, q blocks) for dk/dv ran their last axis in
// order ("arbitrary") with the accumulator in VMEM scratch. Here one
// thread block owns one (q tile, head, batch) for dq and one (kv tile,
// head, batch) for dk/dv and loops over the other axis; the loop replaces
// the sequential grid axis. With this split no two blocks write the same
// gradient row, so neither kernel needs atomics and the result is
// deterministic. Tiles that are wholly in the causal future or wholly
// before the window are skipped with the forward kernel's predicate and
// its bottom-right alignment (query i sits at position i + Skv - Sq; for
// Sq == Skv, as in training, this is `_tile_mask` at line 206). Masked,
// dead and ragged lanes add exactly 0.
//
// Each kernel has two bodies, chosen in its C entry point by dtype and D
// only, by the one rule `mma_body` (mirrored by `dq_body()` and
// `dkv_body()` in ops/flash_attention_bwd.py):
//
// * bf16 / f16 with D a multiple of 16 up to 128, on the tensor cores
//   (mma.sync.m16n8k16, f32 accumulators, operands in 16-bit tiles with
//   XOR-swizzled rows, read by ldmatrix; csrc/tile_mma.cuh):
//   - `flash_bwd_dq_mma_kernel`, in the forward's (queries x keys)
//     orientation. 4 warps, each owning 16 of the block's 64 query rows.
//     The q and dO tiles are copied once and stay in shared memory, with
//     each row's lse, delta and segment id in registers; K and V tiles
//     with their segment ids stream through a 2-stage ring of 16-byte
//     cp.async copies, the next kv tile loading while this one computes.
//     S = Q.K^T and dP = dO.V^T take their B operands from K and V rows
//     by plain ldmatrix; P and dS are formed in the accumulators with the
//     twin's f32 operations in its order; dS is packed to q's dtype (the
//     one rounding the twin makes) straight into the A operand of
//     dQ += dS.K, whose B operand is K read by ldmatrix.trans. dQ stays
//     in f32 registers over the whole kv loop (32 a thread at D = 64, 64
//     at D = 128) and leaves through shared memory in 16-byte stores. At
//     D <= 64 the q and dO A fragments are held in registers for the whole
//     loop; at D <= 128 they are re-read from shared memory per kv tile,
//     since S, dP and dQ fill the register file there. Blocks are launched
//     with the q tiles that see the most kv tiles first, as the forward's.
//     What bounds it: bytes (15 us at the training shape, above). Each K
//     and V element is read from device memory once per q tile, the
//     products run on the tensor cores, and copies overlap the math.
//     Shared memory: 49 KB at
//     D <= 64, 97 KB at D <= 128.
//   - `flash_bwd_dkv_mma_kernel`, in the transposed (keys x queries)
//     orientation. 4 warps, each owning 16 of the block's 64 keys. The K
//     and V tiles are copied once and stay in shared memory; q and dO
//     tiles with their lse, delta and segment rows stream through the
//     same kind of ring. S^T = K.Q^T and dP^T = V.dO^T; P^T and dS^T are
//     packed (P^T to dO's dtype, dS^T to q's) into the A operand of
//     dV += P^T.dO and dK += dS^T.Q, whose B operands are read with
//     ldmatrix.trans. dK and dV stay in f32 registers over the whole q
//     loop. At D <= 64 a pass covers the 64 queries of a tile, at
//     D <= 128 two passes of 32 (the 128 accumulator registers of dK and
//     dV leave room for no more). Shared memory: 50 KB at D <= 64, 98 KB
//     at D <= 128.
// * f32, and bf16 / f16 at any other D: `flash_bwd_dq_fma_kernel` and
//   `flash_bwd_dkv_fma_kernel`, f32 FMAs only. A tensor-core f32 product
//   would be TF32, about three decimal digits, and would break the f32
//   parity gates, so these bodies are bound by the f32 FMA pipe: at the
//   f32 parity steps' shape (B = 8, H = 16, S = 512, D = 64, causal) dq's
//   6 * D flops a visible pair are 6.45 GFLOP, 0.096 ms at 67 TFLOP/s,
//   and dk/dv's 8 * D 0.128 ms, against 0.015 / 0.020 ms of bytes. The
//   design is the forward's `fma` body (csrc/flash_attention.cu; tile
//   loads and the tile skip shared through fma_tile.cuh):
//   - `flash_bwd_dq_fma_kernel`, in the forward's (queries x keys)
//     orientation. 4 warps of 8 query rows. The q and dO tiles are copied
//     once; each row's lse, delta and segment id sit in registers. K and
//     V tiles of 32 keys with their segment ids stream through a 2-stage
//     ring of 16-byte cp.async copies, rows padded by 4 floats since both
//     are read key-wise. S = Q.K^T and dP = dO.V^T are 2-row x 4-key
//     register micro-tiles a lane, outer products over d from 16-byte
//     shared loads (12 loads for 64 FMAs). p and ds are formed in
//     registers in the twin's order, and ds goes once a tile through the
//     warp's own 8 x 36 tile. dQ += dS.K is a 2 x 8 (D <= 64) or 2 x 16
//     (D <= 128) micro-tile in registers over every kv tile, reading K
//     from the same ring stage, written once in 16-byte stores. Blocks
//     are launched with the q tiles that see the most kv tiles first.
//   - `flash_bwd_dkv_fma_kernel`, in the transposed (keys x queries)
//     orientation. 4 warps of 8 keys. The K and V tiles are copied once
//     and the keys' segment ids sit in registers; q and dO tiles of 32
//     rows with their lse, delta and segment ids stream through the same
//     kind of ring. S^T and dP^T are 2-key x 4-query micro-tiles; P^T
//     (rounded to dO's dtype) and dS^T (to q's) go through the warp's own
//     two tiles, and dV += P^T.dO and dK += dS^T.Q are 2-key x 8-d (16 at
//     D <= 128) micro-tiles in registers over every q tile.
//   - Tile skips. A block neither loads nor computes a tile outside its
//     causal / window reach, and a warp skips a tile in which none of its
//     rows (dq) or keys (dk/dv) has a visible pair. Masked pairs and dead
//     rows (lse at the -1e30 sentinel) add exactly 0 to p and ds, so the
//     skip is exact for every row and key; unlike the forward, a dead row
//     needs no pass over the tiles it cannot see.
//   - Occupancy. Shared memory: 55.75 KB (dq) and 60.75 KB (dk/dv) at
//     D <= 64, 103.75 / 108.75 KB at D <= 128. `__launch_bounds__` states
//     the blocks an SM that leaves (4 and 3, then 2 and 2), so that ptxas
//     may use the registers occupancy leaves.
// f32, bf16 and f16 inputs, D <= 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "fma_tile.cuh"
#include "tile_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // query rows per mma tile
constexpr int BK = 64;   // keys per mma tile
constexpr size_t MAX_SMEM = 232448;

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <> __device__ __forceinline__ float round_to<__half>(float x) {
  return __half2float(__float2half(x));
}

using tile::tile_runs;
using tile::visible;

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *qseg, *kseg;
  int B, H, Sq, Skv, D, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t prepare(K kern, size_t smem) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// ------------------------------------------------------------- fma bodies

using fma_tile::FULL;
using fma_tile::part;
constexpr int FMA_THREADS = fma_tile::THREADS;  // 4 warps
constexpr int FMA_BT = fma_tile::BK;  // rows of a streamed tile: keys (dq), queries (dk/dv)
constexpr int DQ_RPW = 8;             // dq: query rows a warp
constexpr int DKV_KPW = 8;            // dk/dv: keys a warp
// row stride (floats) of a warp's ds / p tile; at + 8 its writes would
// not conflict, but dq would no longer fit 4 blocks an SM
constexpr int FMA_PST = FMA_BT + 4;
constexpr size_t SM_SMEM = 233472;    // shared memory of an SM; a block reserves 1 KB more

// bytes of the dq body's shared memory at head-dim tile DP: the q and dO
// tiles, 2-stage K and V rings (rows of DP + 4 floats), one ds tile a
// warp and a 2-stage ring of kv segment ids
__host__ __device__ constexpr size_t dq_fma_smem(int DP) {
  return sizeof(float) * ((size_t)2 * DQ_RPW * fma_tile::WARPS * (DP + 4) +
                          (size_t)4 * FMA_BT * (DP + 4) +
                          (size_t)DQ_RPW * fma_tile::WARPS * FMA_PST) +
         sizeof(int) * 2 * FMA_BT;
}

// dk/dv: the K and V tiles, 2-stage q and dO rings, a p and a ds tile a
// warp, 2-stage rings of lse, delta and q segment ids
__host__ __device__ constexpr size_t dkv_fma_smem(int DP) {
  return sizeof(float) * ((size_t)2 * DKV_KPW * fma_tile::WARPS * (DP + 4) +
                          (size_t)4 * FMA_BT * (DP + 4) +
                          (size_t)2 * DKV_KPW * fma_tile::WARPS * FMA_PST +
                          (size_t)4 * FMA_BT) +
         sizeof(int) * 2 * FMA_BT;
}

__host__ __device__ constexpr int blocks_per_sm(size_t smem) {
  return (int)(SM_SMEM / (smem + 1024));
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(FMA_THREADS, blocks_per_sm(dq_fma_smem(DP)))
flash_bwd_dq_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout,          // (B, H, Sq, D)
    const float* __restrict__ lse,       // (B, H, Sq)
    const float* __restrict__ delta,     // (B, H, Sq)
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    float* __restrict__ dq,              // (B, H, Sq, D)
    int H, int Sq, int Skv, int D, int causal, int window, float scale, int vec) {
  constexpr int ST = DP + 4;           // row stride: the 4 rows or 8 keys one load
                                       // reads fall in distinct 16-byte bank groups
  constexpr int NC = DP / 32;          // float4 dQ chunks a lane: kg + 8c
  constexpr int RI = DQ_RPW / 4;       // query rows a lane: rg + 4i
  constexpr int BR = DQ_RPW * fma_tile::WARPS;  // query rows a block
  static_assert(blocks_per_sm(dq_fma_smem(DP)) >= 1, "a block fits an SM");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;  // most kv tiles first
  const int q_start = iq * BR;
  const int R = min(BR, Sq - q_start);
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane >> 3;  // this lane's rows: rg + 4i of its warp's DQ_RPW
  const int kg = lane & 7;   // its keys: kg + 8jj of a tile; its dQ chunks kg + 8c
  const int w0 = warp * DQ_RPW;
  const bool vec4 = vec != 0;

  extern __shared__ __align__(16) float fsmem[];
  float* q_s = fsmem;                     // BR x ST
  float* do_s = q_s + BR * ST;            // BR x ST
  float* k_s = do_s + BR * ST;            // 2 stages x FMA_BT x ST
  float* v_s = k_s + 2 * FMA_BT * ST;     // 2 stages x FMA_BT x ST
  float* ds_s = v_s + 2 * FMA_BT * ST;    // BR x FMA_PST, DQ_RPW rows a warp
  int* kseg_s = reinterpret_cast<int*>(ds_s + BR * FMA_PST);  // 2 stages x FMA_BT
  float* ds_w = ds_s + w0 * FMA_PST;      // this warp's ds tile

  const size_t bh = (size_t)b * H + h;
  const size_t row0 = bh * Sq + q_start;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  // the kv tiles that run (causal and window skips) form one range [lo, hi]
  const int nk = (Skv + FMA_BT - 1) / FMA_BT;
  int lo = nk, hi = -1;
  for (int ik = 0; ik < nk; ++ik) {
    if (fma_tile::tile_runs(q_start, R, ik * FMA_BT, off, causal, window)) {
      lo = min(lo, ik);
      hi = ik;
    }
  }

  auto load_kv = [&](int ik, int st) {
    const int k0 = ik * FMA_BT;
    const int C = min(FMA_BT, Skv - k0);
    fma_tile::load<T, FMA_BT, DP, ST>(k_s + st * FMA_BT * ST, kb + (size_t)k0 * D, C, D,
                                      vec4, tid);
    fma_tile::load<T, FMA_BT, DP, ST>(v_s + st * FMA_BT * ST, vb + (size_t)k0 * D, C, D,
                                      vec4, tid);
    if (SEG) {
      tile::load_words<FMA_THREADS>(tile::smem_addr(kseg_s + st * FMA_BT),
                                    kseg + (size_t)b * Skv + k0, FMA_BT, C, tid);
    }
  };
  fma_tile::load<T, BR, DP, ST>(q_s, q + row0 * D, R, D, vec4, tid);
  fma_tile::load<T, BR, DP, ST>(do_s, dout + row0 * D, R, D, vec4, tid);
  if (lo <= hi) load_kv(lo, 0);
  tile::cp_async_commit();

  // this lane's rows; past R the lse sentinel keeps a row dead
  float ls[RI], dl[RI];
  int qs[RI], qpos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int lr = w0 + rg + 4 * i;
    const bool in = lr < R;
    ls[i] = in ? lse[row0 + lr] : NEG_INF;
    dl[i] = in ? delta[row0 + lr] : 0.f;
    qpos[i] = q_start + lr + off;
    qs[i] = SEG && in ? qseg[(size_t)b * Sq + q_start + lr] : 0;
  }

  float4 acc[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
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
    __syncthreads();  // kv tile ik (and q, dO) have landed for every thread
    const int k_start = ik * FMA_BT;
    const int C = min(FMA_BT, Skv - k_start);

    // this lane's visible pairs of live rows, bit 4i + jj
    unsigned vis = 0;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = kg + 8 * jj;
        if (ls[i] > NEG_INF / 2 && kj < C &&
            visible<SEG>(qpos[i], k_start + kj, causal, window, qs[i],
                         SEG ? kseg_s[st * FMA_BT + kj] : 0)) {
          vis |= 1u << (4 * i + jj);
        }
      }
    }
    if (__any_sync(FULL, vis != 0)) {  // warp-uniform: else p = ds = 0 here
      // S = Q.K^T and dP = dO.V^T: RI x 4 micro-tiles of outer products
      // over d from 16-byte loads
      float s[RI][4], dp[RI][4];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
      }
      const float* qr = q_s + (w0 + rg) * ST;
      const float* gr = do_s + (w0 + rg) * ST;
      const float* kr = k_s + (st * FMA_BT + kg) * ST;
      const float* vr = v_s + (st * FMA_BT + kg) * ST;
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        float4 a[RI], g[RI], bk[4], bv[4];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          a[i] = *reinterpret_cast<const float4*>(qr + 4 * i * ST + 4 * c);
          g[i] = *reinterpret_cast<const float4*>(gr + 4 * i * ST + 4 * c);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          bk[jj] = *reinterpret_cast<const float4*>(kr + 8 * jj * ST + 4 * c);
          bv[jj] = *reinterpret_cast<const float4*>(vr + 8 * jj * ST + 4 * c);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int i = 0; i < RI; ++i) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              s[i][jj] = fmaf(part(a[i], e), part(bk[jj], e), s[i][jj]);
              dp[i][jj] = fmaf(part(g[i], e), part(bv[jj], e), dp[i][jj]);
            }
          }
        }
      }

      // p = exp(s * scale - lse), 0 where masked, ragged or dead;
      // ds = p * (dp - delta) * scale rounded to q's dtype, in the twin's
      // order, into the warp's ds tile
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float p = (vis >> (4 * i + jj)) & 1u ? expf(s[i][jj] * scale - ls[i]) : 0.f;
          ds_w[(rg + 4 * i) * FMA_PST + kg + 8 * jj] =
              round_to<T>(p * (dp[i][jj] - dl[i]) * scale);
        }
      }
      __syncwarp();

      // dQ += dS.K (K rows past the tile's keys are zeros, as their ds)
      const float* dr = ds_w + rg * FMA_PST;
      const float* kc = k_s + st * FMA_BT * ST + 4 * kg;
#pragma unroll
      for (int j = 0; j < FMA_BT; j += 4) {
        float4 pp[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pp[i] = *reinterpret_cast<const float4*>(dr + 4 * i * FMA_PST + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 kk = *reinterpret_cast<const float4*>(kc + (j + jj) * ST + 32 * c);
#pragma unroll
            for (int i = 0; i < RI; ++i) {
              const float x = part(pp[i], jj);
              acc[i][c].x = fmaf(x, kk.x, acc[i][c].x);
              acc[i][c].y = fmaf(x, kk.y, acc[i][c].y);
              acc[i][c].z = fmaf(x, kk.z, acc[i][c].z);
              acc[i][c].w = fmaf(x, kk.w, acc[i][c].w);
            }
          }
        }
      }
    }
    __syncthreads();  // stage st and the ds tiles are free for the next tiles
  }

  tile::cp_async_wait<0>();  // the q/dO copies, when no kv tile ran
  float* dqb = dq + row0 * D;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int lr = w0 + rg + 4 * i;
    if (lr >= R) continue;
    float* row = dqb + (size_t)lr * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (kg + 8 * c);
      if (vec4) {
        if (col < D) *reinterpret_cast<float4*>(row + col) = acc[i][c];
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < D) row[col + e] = part(acc[i][c], e);
      }
    }
  }
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(FMA_THREADS, blocks_per_sm(dkv_fma_smem(DP)))
flash_bwd_dkv_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qseg,
    const int* __restrict__ kseg,
    float* __restrict__ dk, float* __restrict__ dv,  // (B, H, Skv, D)
    int H, int Sq, int Skv, int D, int causal, int window, float scale, int vec) {
  constexpr int ST = DP + 4;           // row stride, as in dq
  constexpr int NC = DP / 32;          // float4 dK / dV chunks a lane: qg + 8c
  constexpr int KI = DKV_KPW / 4;      // keys a lane: kr + 4i
  constexpr int BC = DKV_KPW * fma_tile::WARPS;  // keys a block
  static_assert(blocks_per_sm(dkv_fma_smem(DP)) >= 1, "a block fits an SM");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ik = blockIdx.z;  // causal: the kv tiles seen by the most q tiles first
  const int k_start = ik * BC;
  const int C = min(BC, Skv - k_start);
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kr = lane >> 3;  // this lane's keys: kr + 4i of its warp's DKV_KPW
  const int qg = lane & 7;   // its queries: qg + 8jj of a tile; its d chunks qg + 8c
  const int w0 = warp * DKV_KPW;
  const bool vec4 = vec != 0;

  extern __shared__ __align__(16) float fsmem[];
  float* k_s = fsmem;                     // BC x ST
  float* v_s = k_s + BC * ST;             // BC x ST
  float* q_s = v_s + BC * ST;             // 2 stages x FMA_BT x ST
  float* do_s = q_s + 2 * FMA_BT * ST;    // 2 stages x FMA_BT x ST
  float* p_s = do_s + 2 * FMA_BT * ST;    // BC x FMA_PST, DKV_KPW keys a warp
  float* ds_s = p_s + BC * FMA_PST;       // BC x FMA_PST
  float* lse_s = ds_s + BC * FMA_PST;     // 2 stages x FMA_BT
  float* dl_s = lse_s + 2 * FMA_BT;       // 2 stages x FMA_BT
  int* qseg_s = reinterpret_cast<int*>(dl_s + 2 * FMA_BT);  // 2 stages x FMA_BT
  float* p_w = p_s + w0 * FMA_PST;        // this warp's P^T tile
  float* ds_w = ds_s + w0 * FMA_PST;      // this warp's dS^T tile

  const size_t bh = (size_t)b * H + h;
  const size_t krow0 = bh * Skv + k_start;

  // the q tiles that run form one range [lo, hi]
  const int nq = (Sq + FMA_BT - 1) / FMA_BT;
  int lo = nq, hi = -1;
  for (int iq = 0; iq < nq; ++iq) {
    if (fma_tile::tile_runs(iq * FMA_BT, min(FMA_BT, Sq - iq * FMA_BT), k_start, off, causal,
                            window)) {
      lo = min(lo, iq);
      hi = iq;
    }
  }

  auto load_q = [&](int iq, int st) {
    const int q_start = iq * FMA_BT;
    const int R = min(FMA_BT, Sq - q_start);
    const size_t row0 = bh * Sq + q_start;
    fma_tile::load<T, FMA_BT, DP, ST>(q_s + st * FMA_BT * ST, q + row0 * D, R, D, vec4, tid);
    fma_tile::load<T, FMA_BT, DP, ST>(do_s + st * FMA_BT * ST, dout + row0 * D, R, D, vec4,
                                      tid);
    tile::load_words<FMA_THREADS>(tile::smem_addr(lse_s + st * FMA_BT), lse + row0, FMA_BT,
                                  R, tid);
    tile::load_words<FMA_THREADS>(tile::smem_addr(dl_s + st * FMA_BT), delta + row0, FMA_BT,
                                  R, tid);
    if (SEG) {
      tile::load_words<FMA_THREADS>(tile::smem_addr(qseg_s + st * FMA_BT),
                                    qseg + (size_t)b * Sq + q_start, FMA_BT, R, tid);
    }
  };
  fma_tile::load<T, BC, DP, ST>(k_s, k + krow0 * D, C, D, vec4, tid);
  fma_tile::load<T, BC, DP, ST>(v_s, v + krow0 * D, C, D, vec4, tid);
  if (lo <= hi) load_q(lo, 0);
  tile::cp_async_commit();

  // this lane's keys
  bool kin[KI];
  int kpos[KI], ks[KI];
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = w0 + kr + 4 * i;
    kin[i] = key < C;
    kpos[i] = k_start + key;
    ks[i] = SEG && kin[i] ? kseg[(size_t)b * Skv + k_start + key] : 0;
  }

  float4 dka[KI][NC], dva[KI][NC];
#pragma unroll
  for (int i = 0; i < KI; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dka[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      dva[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  for (int iq = lo; iq <= hi; ++iq) {
    const int st = (iq - lo) & 1;
    if (iq < hi) {
      load_q(iq + 1, st ^ 1);
      tile::cp_async_commit();
      tile::cp_async_wait<1>();
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();  // q tile iq (and K, V) have landed for every thread
    const int q_start = iq * FMA_BT;
    const int R = min(FMA_BT, Sq - q_start);
    const float* lse_t = lse_s + st * FMA_BT;
    const float* dl_t = dl_s + st * FMA_BT;

    // this lane's visible pairs with live queries, bit 4i + jj
    unsigned vis = 0;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int qc = qg + 8 * jj;
      const bool qok = qc < R && lse_t[qc] > NEG_INF / 2;
      const int qsg = SEG ? qseg_s[st * FMA_BT + qc] : 0;
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        if (qok && kin[i] &&
            visible<SEG>(q_start + qc + off, kpos[i], causal, window, qsg, ks[i])) {
          vis |= 1u << (4 * i + jj);
        }
      }
    }
    if (__any_sync(FULL, vis != 0)) {  // warp-uniform: else p = ds = 0 here
      // S^T = K.Q^T and dP^T = V.dO^T: KI x 4 micro-tiles over d
      float s[KI][4], dp[KI][4];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = dp[i][jj] = 0.f;
      }
      const float* ar = k_s + (w0 + kr) * ST;
      const float* gr = v_s + (w0 + kr) * ST;
      const float* qr = q_s + (st * FMA_BT + qg) * ST;
      const float* orr = do_s + (st * FMA_BT + qg) * ST;
#pragma unroll
      for (int c = 0; c < DP / 4; ++c) {
        float4 a[KI], g[KI], bq[4], bo[4];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          a[i] = *reinterpret_cast<const float4*>(ar + 4 * i * ST + 4 * c);
          g[i] = *reinterpret_cast<const float4*>(gr + 4 * i * ST + 4 * c);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          bq[jj] = *reinterpret_cast<const float4*>(qr + 8 * jj * ST + 4 * c);
          bo[jj] = *reinterpret_cast<const float4*>(orr + 8 * jj * ST + 4 * c);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int i = 0; i < KI; ++i) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              s[i][jj] = fmaf(part(a[i], e), part(bq[jj], e), s[i][jj]);
              dp[i][jj] = fmaf(part(g[i], e), part(bo[jj], e), dp[i][jj]);
            }
          }
        }
      }

      // P^T = exp(S^T * scale - lse), 0 where masked, ragged or dead;
      // dS^T = P^T * (dP^T - delta) * scale, in the twin's order; P^T
      // rounded to dO's dtype and dS^T to q's into the warp's tiles
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int qc = qg + 8 * jj;
        const float l = lse_t[qc];
        const float dlt = dl_t[qc];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const float p = (vis >> (4 * i + jj)) & 1u ? expf(s[i][jj] * scale - l) : 0.f;
          p_w[(kr + 4 * i) * FMA_PST + qc] = round_to<T>(p);
          ds_w[(kr + 4 * i) * FMA_PST + qc] = round_to<T>(p * (dp[i][jj] - dlt) * scale);
        }
      }
      __syncwarp();

      // dV += P^T.dO and dK += dS^T.Q (rows past R are zeros, as their p)
      const float* pr = p_w + kr * FMA_PST;
      const float* sr = ds_w + kr * FMA_PST;
      const float* qcol = q_s + st * FMA_BT * ST + 4 * qg;
      const float* ocol = do_s + st * FMA_BT * ST + 4 * qg;
#pragma unroll
      for (int j = 0; j < FMA_BT; j += 4) {
        float4 pp[KI], ss[KI];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          pp[i] = *reinterpret_cast<const float4*>(pr + 4 * i * FMA_PST + j);
          ss[i] = *reinterpret_cast<const float4*>(sr + 4 * i * FMA_PST + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float4 od = *reinterpret_cast<const float4*>(ocol + (j + jj) * ST + 32 * c);
            const float4 qq = *reinterpret_cast<const float4*>(qcol + (j + jj) * ST + 32 * c);
#pragma unroll
            for (int i = 0; i < KI; ++i) {
              const float x = part(pp[i], jj);
              const float y = part(ss[i], jj);
              dva[i][c].x = fmaf(x, od.x, dva[i][c].x);
              dva[i][c].y = fmaf(x, od.y, dva[i][c].y);
              dva[i][c].z = fmaf(x, od.z, dva[i][c].z);
              dva[i][c].w = fmaf(x, od.w, dva[i][c].w);
              dka[i][c].x = fmaf(y, qq.x, dka[i][c].x);
              dka[i][c].y = fmaf(y, qq.y, dka[i][c].y);
              dka[i][c].z = fmaf(y, qq.z, dka[i][c].z);
              dka[i][c].w = fmaf(y, qq.w, dka[i][c].w);
            }
          }
        }
      }
    }
    __syncthreads();  // stage st and the p / ds tiles are free for the next tiles
  }

  tile::cp_async_wait<0>();  // the K/V copies, when no q tile ran
  float* dkb = dk + krow0 * D;
  float* dvb = dv + krow0 * D;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int key = w0 + kr + 4 * i;
    if (key >= C) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (qg + 8 * c);
      const size_t at = (size_t)key * D + col;
      if (vec4) {
        if (col < D) {
          *reinterpret_cast<float4*>(dkb + at) = dka[i][c];
          *reinterpret_cast<float4*>(dvb + at) = dva[i][c];
        }
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < D) {
          dkb[at + e] = part(dka[i][c], e);
          dvb[at + e] = part(dva[i][c], e);
        }
      }
    }
  }
}

template <typename T, int DP, bool SEG>
cudaError_t launch_dq_fma(const Args& a, float* dq, int vec) {
  auto kern = flash_bwd_dq_fma_kernel<T, DP, SEG>;
  const size_t smem = dq_fma_smem(DP);
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  constexpr int BR = DQ_RPW * fma_tile::WARPS;
  const dim3 grid(a.H, a.B, (a.Sq + BR - 1) / BR);
  kern<<<grid, FMA_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, dq, a.H, a.Sq, a.Skv, a.D, a.causal, a.window,
      a.scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_fma_any(const Args& a, float* dq, int vec) {
  const bool seg = a.qseg != nullptr;
  if (a.D <= 64) {
    return seg ? launch_dq_fma<T, 64, true>(a, dq, vec) : launch_dq_fma<T, 64, false>(a, dq, vec);
  }
  return seg ? launch_dq_fma<T, 128, true>(a, dq, vec) : launch_dq_fma<T, 128, false>(a, dq, vec);
}

template <typename T, int DP, bool SEG>
cudaError_t launch_dkv_fma(const Args& a, float* dk, float* dv, int vec) {
  auto kern = flash_bwd_dkv_fma_kernel<T, DP, SEG>;
  const size_t smem = dkv_fma_smem(DP);
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  constexpr int BC = DKV_KPW * fma_tile::WARPS;
  const dim3 grid(a.H, a.B, (a.Skv + BC - 1) / BC);
  kern<<<grid, FMA_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, dk, dv, a.H, a.Sq, a.Skv, a.D, a.causal,
      a.window, a.scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_fma_any(const Args& a, float* dk, float* dv, int vec) {
  const bool seg = a.qseg != nullptr;
  if (a.D <= 64) {
    return seg ? launch_dkv_fma<T, 64, true>(a, dk, dv, vec)
               : launch_dkv_fma<T, 64, false>(a, dk, dv, vec);
  }
  return seg ? launch_dkv_fma<T, 128, true>(a, dk, dv, vec)
             : launch_dkv_fma<T, 128, false>(a, dk, dv, vec);
}

// ---------------------------------------------------------- dk/dv mma body

constexpr int MMA_THREADS = 128;  // 4 warps x 16 keys

// One f32 gradient tile (64 keys x DP, 16 keys a warp in mma accumulator
// layout) through shared memory (rows padded to DP + 8 floats: the float2
// writes of a half-warp hit distinct banks) into rows [0, C) x [0, D) of
// dst in 16-byte stores.
template <int DP>
__device__ __forceinline__ void store_grad(const float (&acc)[DP / 8][4], float* stage,
                                           float* dst, int C, int D, int tid) {
  constexpr int LD = DP + 8;
  constexpr int C4 = DP / 4;
  const int lane = tid & 31;
  const int key0 = (tid >> 5) * 16 + (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int d = 0; d < DP / 8; ++d) {
    *reinterpret_cast<float2*>(stage + key0 * LD + d * 8 + 2 * t) =
        make_float2(acc[d][0], acc[d][1]);
    *reinterpret_cast<float2*>(stage + (key0 + 8) * LD + d * 8 + 2 * t) =
        make_float2(acc[d][2], acc[d][3]);
  }
  __syncthreads();
  const int d4 = D / 4;
#pragma unroll
  for (int i = 0; i < BK * C4 / MMA_THREADS; ++i) {
    const int e = tid + i * MMA_THREADS;
    const int r = e / C4;
    const int c = e - r * C4;
    if (r < C && c < d4) {
      *reinterpret_cast<float4*>(dst + (size_t)r * D + 4 * c) =
          *reinterpret_cast<const float4*>(stage + r * LD + 4 * c);
    }
  }
  __syncthreads();
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dkv_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qseg,
    const int* __restrict__ kseg,
    float* __restrict__ dk, float* __restrict__ dv,  // (B, H, Skv, D)
    int H, int Sq, int Skv, int D, int causal, int window, float scale) {
  constexpr int KC = DP / 16;                 // k16 steps over the head dim
  constexpr int SUB = DP <= 64 ? 64 : 32;     // queries per pass
  constexpr int NJ = SUB / 8;                 // n8 tiles of S^T per pass
  constexpr int DT = DP / 8;                  // n8 tiles of a dK / dV row
  constexpr uint32_t TILE = BQ * DP * 2;      // bytes of one 16-bit tile
  static_assert(BQ == BK, "q and kv tiles share the tile size");
  static_assert(BK * (DP + 8) * 4 <= 4 * TILE, "gradient stage fits the q/dO ring");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ik = blockIdx.z;  // causal: the kv tiles seen by the most q tiles first
  const int k_start = ik * BK;
  const int C = min(BK, Skv - k_start);
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = warp * 16 + g;  // this thread's keys: key0 and key0 + 8

  extern __shared__ __align__(128) unsigned char tsmem[];
  const uint32_t k_s = tile::smem_addr(tsmem);  // K tile
  const uint32_t v_s = k_s + TILE;             // V tile
  const uint32_t q_s = k_s + 2 * TILE;         // 2 stages
  const uint32_t do_s = k_s + 4 * TILE;        // 2 stages
  float* lse_s = reinterpret_cast<float*>(tsmem + 6 * TILE);  // 2 stages x BQ
  float* dl_s = lse_s + 2 * BQ;                               // 2 stages x BQ
  int* qseg_s = reinterpret_cast<int*>(dl_s + 2 * BQ);       // 2 stages x BQ
  int* kseg_s = qseg_s + 2 * BQ;                              // BK

  const size_t bh = (size_t)b * H + h;
  const size_t krow0 = bh * Skv + k_start;

  // the q tiles that run form one range [lo, hi]
  const int nq = (Sq + BQ - 1) / BQ;
  int lo = nq, hi = -1;
  for (int iq = 0; iq < nq; ++iq) {
    if (tile_runs(iq * BQ, min(BQ, Sq - iq * BQ), k_start, off, causal, window)) {
      lo = min(lo, iq);
      hi = iq;
    }
  }

  auto load_q = [&](int iq, int st) {
    const int q_start = iq * BQ;
    const int R = min(BQ, Sq - q_start);
    const size_t row0 = bh * Sq + q_start;
    tile::load_tile<BQ, DP, MMA_THREADS>(q_s + st * TILE, q + row0 * D, R, D, tid);
    tile::load_tile<BQ, DP, MMA_THREADS>(do_s + st * TILE, dout + row0 * D, R, D, tid);
    tile::load_words<MMA_THREADS>(tile::smem_addr(lse_s + st * BQ), lse + row0, BQ, R, tid);
    tile::load_words<MMA_THREADS>(tile::smem_addr(dl_s + st * BQ), delta + row0, BQ, R, tid);
    if (SEG) {
      tile::load_words<MMA_THREADS>(tile::smem_addr(qseg_s + st * BQ),
                                    qseg + (size_t)b * Sq + q_start, BQ, R, tid);
    }
  };
  tile::load_tile<BK, DP, MMA_THREADS>(k_s, k + krow0 * D, C, D, tid);
  tile::load_tile<BK, DP, MMA_THREADS>(v_s, v + krow0 * D, C, D, tid);
  if (SEG) {
    tile::load_words<MMA_THREADS>(tile::smem_addr(kseg_s), kseg + (size_t)b * Skv + k_start,
                                  BK, C, tid);
  }
  if (lo <= hi) load_q(lo, 0);
  tile::cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    dka[d][0] = dka[d][1] = dka[d][2] = dka[d][3] = 0.f;
    dva[d][0] = dva[d][1] = dva[d][2] = dva[d][3] = 0.f;
  }

  for (int iq = lo; iq <= hi; ++iq) {
    const int st = (iq - lo) & 1;
    if (iq < hi) {
      load_q(iq + 1, st ^ 1);
      tile::cp_async_commit();
      tile::cp_async_wait<1>();
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();  // q tile iq (and K, V) have landed for every thread
    const int q_start = iq * BQ;
    const int R = min(BQ, Sq - q_start);
    const uint32_t qs = q_s + st * TILE;
    const uint32_t dos = do_s + st * TILE;
    const float* lse_t = lse_s + st * BQ;
    const float* dl_t = dl_s + st * BQ;
    const int* qseg_t = qseg_s + st * BQ;
    const bool whole = !SEG && C == BK && R == BQ &&
                       tile::tile_whole(q_start, R, k_start, off, causal, window);
#pragma unroll
    for (int sub = 0; sub < BQ / SUB; ++sub) {
      // S^T = K . Q^T and dP^T = V . dO^T (queries of the pass along n)
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t kf[4], vf[4];
        const uint32_t arow = tile::swz<DP>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4));
        tile::ldsm_x4(kf, k_s + arow);
        tile::ldsm_x4(vf, v_s + arow);
#pragma unroll
        for (int p = 0; p < NJ / 2; ++p) {
          const uint32_t brow = tile::swz<DP>(
              sub * SUB + 16 * p + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1));
          uint32_t bq[4], bd[4];
          tile::ldsm_x4(bq, qs + brow);
          tile::ldsm_x4(bd, dos + brow);
          tile::mma<T>(s[2 * p], kf, bq[0], bq[1]);
          tile::mma<T>(s[2 * p + 1], kf, bq[2], bq[3]);
          tile::mma<T>(dp[2 * p], vf, bd[0], bd[1]);
          tile::mma<T>(dp[2 * p + 1], vf, bd[2], bd[3]);
        }
      }
      // P^T = exp(S^T * scale - lse), 0 where masked, ragged or dead;
      // dS^T = P^T * (dP^T - delta) * scale, in the twin's order
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + ((e >> 1) << 3);
          const int qc = sub * SUB + j * 8 + 2 * t + (e & 1);
          const float l = lse_t[qc];
          bool keep = l > NEG_INF / 2;
          if (!whole) {
            keep = keep && qc < R && key < C &&
                   visible<SEG>(q_start + qc + off, k_start + key, causal, window,
                                SEG ? qseg_t[qc] : 0, SEG ? kseg_s[key] : 0);
          }
          const float p = keep ? __expf(s[j][e] * scale - l) : 0.f;
          dp[j][e] = p * (dp[j][e] - dl_t[qc]) * scale;
          s[j][e] = p;
        }
      }
      // dV += P^T . dO and dK += dS^T . Q, A operands packed from registers
#pragma unroll
      for (int kc = 0; kc < NJ / 2; ++kc) {
        uint32_t pa[4], sa[4];
        tile::acc_to_a<T>(pa, s[2 * kc], s[2 * kc + 1]);    // p.astype(do.dtype)
        tile::acc_to_a<T>(sa, dp[2 * kc], dp[2 * kc + 1]);  // ds.astype(q.dtype)
#pragma unroll
        for (int p = 0; p < DT / 2; ++p) {
          const uint32_t brow = tile::swz<DP>(
              sub * SUB + 16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3), 2 * p + (lane >> 4));
          uint32_t bo[4], bq[4];
          tile::ldsm_x4_t(bo, dos + brow);
          tile::ldsm_x4_t(bq, qs + brow);
          tile::mma<T>(dva[2 * p], pa, bo[0], bo[1]);
          tile::mma<T>(dva[2 * p + 1], pa, bo[2], bo[3]);
          tile::mma<T>(dka[2 * p], sa, bq[0], bq[1]);
          tile::mma<T>(dka[2 * p + 1], sa, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // stage st is free for the tile after next
  }

  tile::cp_async_wait<0>();  // the K/V copies, when no q tile ran
  __syncthreads();
  float* stage = reinterpret_cast<float*>(tsmem + 2 * TILE);  // the q/dO ring
  store_grad<DP>(dka, stage, dk + krow0 * D, C, D, tid);
  store_grad<DP>(dva, stage, dv + krow0 * D, C, D, tid);
}

template <typename T, int DP, bool SEG>
cudaError_t launch_dkv_mma(const Args& a, float* dk, float* dv) {
  auto kern = flash_bwd_dkv_mma_kernel<T, DP, SEG>;
  const size_t smem = 6 * (size_t)BQ * DP * 2 + sizeof(float) * 4 * BQ +
                      sizeof(int) * (2 * BQ + BK);
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.Skv + BK - 1) / BK);
  kern<<<grid, MMA_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, dk, dv, a.H, a.Sq, a.Skv, a.D, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_mma_any(const Args& a, float* dk, float* dv) {
  const bool seg = a.qseg != nullptr;
  if (a.D <= 64) {
    return seg ? launch_dkv_mma<T, 64, true>(a, dk, dv) : launch_dkv_mma<T, 64, false>(a, dk, dv);
  }
  return seg ? launch_dkv_mma<T, 128, true>(a, dk, dv) : launch_dkv_mma<T, 128, false>(a, dk, dv);
}

// ------------------------------------------------------------- dq mma body

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(MMA_THREADS) flash_bwd_dq_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qseg,
    const int* __restrict__ kseg,
    float* __restrict__ dq,  // (B, H, Sq, D)
    int H, int Sq, int Skv, int D, int causal, int window, float scale) {
  constexpr int KC = DP / 16;                 // k16 steps over the head dim
  constexpr int NT = BK / 8;                  // n8 tiles of a score row
  constexpr int DT = DP / 8;                  // n8 tiles of a dQ row
  constexpr bool HOLD = DP <= 64;             // q/dO A fragments kept in registers
  constexpr uint32_t TILE = BQ * DP * 2;      // bytes of one 16-bit tile
  static_assert(BQ == BK, "q and kv tiles share the tile size");
  static_assert(BQ * (DP + 8) * 4 <= 4 * TILE, "gradient stage fits the K/V ring");
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
  const uint32_t q_s = tile::smem_addr(tsmem);  // q tile
  const uint32_t do_s = q_s + TILE;            // dO tile
  const uint32_t k_s = q_s + 2 * TILE;         // 2 stages
  const uint32_t v_s = q_s + 4 * TILE;         // 2 stages
  int* kseg_s = reinterpret_cast<int*>(tsmem + 6 * TILE);  // 2 stages x BK

  const size_t bh = (size_t)b * H + h;
  const size_t row0 = bh * Sq + q_start;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  // the kv tiles that run form one range [lo, hi]
  const int nk = (Skv + BK - 1) / BK;
  int lo = nk, hi = -1;
  for (int ik = 0; ik < nk; ++ik) {
    if (tile_runs(q_start, R, ik * BK, off, causal, window)) {
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
  tile::load_tile<BQ, DP, MMA_THREADS>(q_s, q + row0 * D, R, D, tid);
  tile::load_tile<BQ, DP, MMA_THREADS>(do_s, dout + row0 * D, R, D, tid);
  if (lo <= hi) load_kv(lo, 0);
  tile::cp_async_commit();

  // this thread's rows; past R the lse sentinel keeps a row dead
  const float lse0 = r0 < R ? lse[row0 + r0] : NEG_INF;
  const float lse1 = r0 + 8 < R ? lse[row0 + r0 + 8] : NEG_INF;
  const float dl0 = r0 < R ? delta[row0 + r0] : 0.f;
  const float dl1 = r0 + 8 < R ? delta[row0 + r0 + 8] : 0.f;
  int qs0 = 0, qs1 = 0;
  if (SEG) {
    qs0 = r0 < R ? qseg[(size_t)b * Sq + q_start + r0] : 0;
    qs1 = r0 + 8 < R ? qseg[(size_t)b * Sq + q_start + r0 + 8] : 0;
  }

  float dqa[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) dqa[d][0] = dqa[d][1] = dqa[d][2] = dqa[d][3] = 0.f;
  uint32_t qf[HOLD ? KC : 1][4], df[HOLD ? KC : 1][4];

  for (int ik = lo; ik <= hi; ++ik) {
    const int st = (ik - lo) & 1;
    if (ik < hi) {
      load_kv(ik + 1, st ^ 1);
      tile::cp_async_commit();
      tile::cp_async_wait<1>();
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();  // kv tile ik (and q, dO) have landed for every thread
    if constexpr (HOLD) {
      if (ik == lo) {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const uint32_t arow = tile::swz<DP>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4));
          tile::ldsm_x4(qf[kk], q_s + arow);
          tile::ldsm_x4(df[kk], do_s + arow);
        }
      }
    }
    const int k_start = ik * BK;
    const int C = min(BK, Skv - k_start);
    const uint32_t ks = k_s + st * TILE;
    const uint32_t vs = v_s + st * TILE;

    // S = Q . K^T and dP = dO . V^T (keys of the tile along n)
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t qa[4], da[4];
      if constexpr (HOLD) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = qf[kk][i];
          da[i] = df[kk][i];
        }
      } else {
        const uint32_t arow = tile::swz<DP>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4));
        tile::ldsm_x4(qa, q_s + arow);
        tile::ldsm_x4(da, do_s + arow);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        const uint32_t brow = tile::swz<DP>(16 * p + (lane & 7) + ((lane >> 4) << 3),
                                            2 * kk + ((lane >> 3) & 1));
        uint32_t bk[4], bv[4];
        tile::ldsm_x4(bk, ks + brow);
        tile::ldsm_x4(bv, vs + brow);
        tile::mma<T>(s[2 * p], qa, bk[0], bk[1]);
        tile::mma<T>(s[2 * p + 1], qa, bk[2], bk[3]);
        tile::mma<T>(dp[2 * p], da, bv[0], bv[1]);
        tile::mma<T>(dp[2 * p + 1], da, bv[2], bv[3]);
      }
    }

    // P = exp(S * scale - lse), 0 where masked, ragged or dead;
    // dS = P * (dP - delta) * scale, in the twin's order
    const bool whole = !SEG && C == BK && R == BQ &&
                       tile::tile_whole(q_start, R, k_start, off, causal, window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool second = e >= 2;  // row r0 + 8
        const int r = r0 + (second ? 8 : 0);
        const int kj = j * 8 + 2 * t + (e & 1);
        const float l = second ? lse1 : lse0;
        bool keep = l > NEG_INF / 2;
        if (!whole) {
          keep = keep && kj < C &&
                 visible<SEG>(q_start + r + off, k_start + kj, causal, window,
                              second ? qs1 : qs0, SEG ? kseg_s[st * BK + kj] : 0);
        }
        const float p = keep ? __expf(s[j][e] * scale - l) : 0.f;
        dp[j][e] = p * (dp[j][e] - (second ? dl1 : dl0)) * scale;
      }
    }

    // dQ += dS . K, dS packed to q's dtype as the A operand
#pragma unroll
    for (int kc = 0; kc < NT / 2; ++kc) {
      uint32_t sa[4];
      tile::acc_to_a<T>(sa, dp[2 * kc], dp[2 * kc + 1]);  // ds.astype(q.dtype)
#pragma unroll
      for (int p = 0; p < DT / 2; ++p) {
        uint32_t bk[4];
        tile::ldsm_x4_t(bk, ks + tile::swz<DP>(16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * p + (lane >> 4)));
        tile::mma<T>(dqa[2 * p], sa, bk[0], bk[1]);
        tile::mma<T>(dqa[2 * p + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // stage st is free for the tile after next
  }

  tile::cp_async_wait<0>();  // the q/dO copies, when no kv tile ran
  __syncthreads();
  float* stage = reinterpret_cast<float*>(tsmem + 2 * TILE);  // the K/V ring
  store_grad<DP>(dqa, stage, dq + row0 * D, R, D, tid);
}

template <typename T, int DP, bool SEG>
cudaError_t launch_dq_mma(const Args& a, float* dq) {
  auto kern = flash_bwd_dq_mma_kernel<T, DP, SEG>;
  const size_t smem = 6 * (size_t)BQ * DP * 2 + sizeof(int) * 2 * BK;
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, a.B, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, MMA_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, dq, a.H, a.Sq, a.Skv, a.D, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_mma_any(const Args& a, float* dq) {
  const bool seg = a.qseg != nullptr;
  if (a.D <= 64) return seg ? launch_dq_mma<T, 64, true>(a, dq) : launch_dq_mma<T, 64, false>(a, dq);
  return seg ? launch_dq_mma<T, 128, true>(a, dq) : launch_dq_mma<T, 128, false>(a, dq);
}

// dtype codes shared with ops/flash_attention.py
enum { F32 = 0, BF16 = 1, F16 = 2 };

// The body both kernels run (mirrored by ops/flash_attention_bwd.py
// `dq_body` and `dkv_body`): the tensor cores for bf16/f16 with D a
// multiple of 16 up to 128.
bool mma_body(int dtype, int D) {
  return (dtype == BF16 || dtype == F16) && D % 16 == 0 && D <= 128;
}

}  // namespace

#define KFT_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *lse, const void *delta, const void *q_seg,                \
      const void *kv_seg
#define KFT_BWD_DIMS                                                        \
  int B, int H, int Sq, int Skv, int D, int causal, int window, float scale, \
      int dtype, void *stream

static Args make_args(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* q_seg, const void* kv_seg, int B, int H,
                      int Sq, int Skv, int D, int causal, int window,
                      float scale, void* stream) {
  return Args{q, k, v, dout,
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg),
              B, H, Sq, Skv, D, causal, window, scale,
              static_cast<cudaStream_t>(stream)};
}

extern "C" int kft_flash_bwd_dq(KFT_BWD_ARGS, void* dq, KFT_BWD_DIMS) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (D <= 0 || Skv <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, q_seg, kv_seg, B, H, Sq,
                           Skv, D, causal, window, scale, stream);
  float* out = static_cast<float*>(dq);
  if (mma_body(dtype, D)) {
    // 16-byte copies and stores
    if (!tile::aligned16(q) || !tile::aligned16(k) || !tile::aligned16(v) ||
        !tile::aligned16(dout) || !tile::aligned16(dq)) {
      return (int)cudaErrorMisalignedAddress;
    }
    return (int)(dtype == BF16 ? launch_dq_mma_any<__nv_bfloat16>(a, out)
                               : launch_dq_mma_any<__half>(a, out));
  }
  if (D > 128) return (int)cudaErrorInvalidValue;
  // rows of whole 16-byte chunks: 16-byte f32 copies and stores
  const int vec = D % 4 == 0 && tile::aligned16(q) && tile::aligned16(k) &&
                  tile::aligned16(v) && tile::aligned16(dout) && tile::aligned16(dq);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32) err = launch_dq_fma_any<float>(a, out, vec);
  if (dtype == BF16) err = launch_dq_fma_any<__nv_bfloat16>(a, out, vec);
  if (dtype == F16) err = launch_dq_fma_any<__half>(a, out, vec);
  return (int)err;
}

extern "C" int kft_flash_bwd_dkv(KFT_BWD_ARGS, void* dk, void* dv,
                                 KFT_BWD_DIMS) {
  if (B == 0 || H == 0 || Skv == 0) return 0;
  if (D <= 0 || Sq <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, q_seg, kv_seg, B, H, Sq,
                           Skv, D, causal, window, scale, stream);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  if (mma_body(dtype, D)) {
    // 16-byte copies and stores
    if (!tile::aligned16(q) || !tile::aligned16(k) || !tile::aligned16(v) ||
        !tile::aligned16(dout) || !tile::aligned16(dk) || !tile::aligned16(dv)) {
      return (int)cudaErrorMisalignedAddress;
    }
    return (int)(dtype == BF16 ? launch_dkv_mma_any<__nv_bfloat16>(a, gk, gv)
                               : launch_dkv_mma_any<__half>(a, gk, gv));
  }
  if (D > 128) return (int)cudaErrorInvalidValue;
  // rows of whole 16-byte chunks: 16-byte f32 copies and stores
  const int vec = D % 4 == 0 && tile::aligned16(q) && tile::aligned16(k) &&
                  tile::aligned16(v) && tile::aligned16(dout) && tile::aligned16(dk) &&
                  tile::aligned16(dv);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32) err = launch_dkv_fma_any<float>(a, gk, gv, vec);
  if (dtype == BF16) err = launch_dkv_fma_any<__nv_bfloat16>(a, gk, gv, vec);
  if (dtype == F16) err = launch_dkv_fma_any<__half>(a, gk, gv, vec);
  return (int)err;
}

#undef KFT_BWD_ARGS
#undef KFT_BWD_DIMS

extern "C" const char* kft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
