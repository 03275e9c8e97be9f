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
// order ("arbitrary") with the accumulator in VMEM scratch. Here a work
// item is one (q tile, head, batch) for dq and one (kv tile, head, batch)
// for dk/dv, owned by one thread block (the `fma` bodies: one block an
// item; the `wgmma` bodies: persistent blocks, each taking items in
// turn), which loops over the other axis; the loop replaces the
// sequential grid axis. With this split no two blocks write the same
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
//   through Hopper's warpgroup path (csrc/wgmma_tile.cuh, shared with the
//   forward's `flash_fwd_wgmma_kernel`): `flash_bwd_dkv_wgmma_kernel` and
//   `flash_bwd_dq_wgmma_kernel`. Both have one shape:
//   - Warp specialisation. A block is one consumer warpgroup (64 keys of
//     a kv tile for dk/dv, 64 query rows of a q tile for dq) and one
//     producer warpgroup, which keeps 40 registers a thread
//     (`setmaxnreg.dec`; at 32 its segment-id work spilled) and of which
//     one warp issues every load; the consumers take 216
//     (`setmaxnreg.inc`) and only compute. 2 blocks an SM
//     (`__launch_bounds__`, checked against the same constexpr arithmetic
//     as the shared memory: 98-101 KB a block at either D).
//   - Persistent blocks. As many blocks as the SMs hold take the work
//     items (kv tile or q tile, head, batch) heaviest first, in rounds
//     whose every other one runs in reverse (the forward's order; head
//     by head instead is 2% faster for dq at the training shape and 12%
//     slower with segment ids).
//   - TMA and mbarriers. A work item's own two tiles (K and V, or q and
//     dO) come by TMA once, into one of 2 buffers at D <= 64 (the next
//     item's load while this one computes; one buffer and 5 stages is
//     13% slower at the training shape), 1 at D <= 128; the other two
//     stream through a ring of 4 stages at D <= 64 (3 are 3% slower for
//     dq), 2 at D <= 128, with a full and an empty barrier a stage.
//     Tiles are 64 x 64 boxes of the 128-byte swizzle (zeros past D and
//     past S, never the next head). The rows beside them (lse, delta,
//     segment ids: a TMA map of f32 rows
//     would need S * 4 to be a multiple of 16) come by plain loads of the
//     producer warp's lanes, each of which arrives on the full barrier
//     after its stores. lse is stored as +inf where a row adds nothing
//     (past S, or dead at the -1e30 sentinel), so p = exp(s - lse) is
//     exactly 0 there without a test.
//   - Products, each a wgmma with f32 accumulators. dk/dv (keys x
//     queries): S^T = K.Q^T and dP^T = V.dO^T with both operands K-major
//     (m64n64, or two m64n32 passes of 32 queries at D = 128, where dK
//     and dV take 128 registers); dV += P^T.dO and dK += dS^T.Q with P^T
//     (rounded to dO's dtype) and dS^T (to q's) packed from the
//     accumulators into the A operand, dO and q read MN-major with the
//     transpose bit from the same swizzled tiles. dq (queries x keys):
//     S = Q.K^T and dP = dO.V^T K-major; dQ += dS.K with dS packed to q's
//     dtype and K MN-major. A stage is released once the wait_group that
//     retires its last reader returns. dk/dv issues the next pass's S^T
//     and dP^T before it waits for this pass's dV and dK, so the
//     elementwise work runs while the tensor cores add the previous pass.
//     dq issues a tile's dQ as soon as its dS is packed and queues the
//     next tile's S and dP behind it, so the K/V stage is released before
//     the elementwise work and the ring refills sooner (2% faster at the
//     training shape and 14% at D = 128 than dk/dv's order).
//   - Skips. Producer and consumer take a work item's causal / window
//     range of streamed tiles from one function (`q_span`, `kv_span`); an
//     item with none still hands its buffer over and writes zeros. With
//     segment ids the producer also skips, exactly, a streamed tile none
//     of whose ids lies in the span of the item's ids, and tags each
//     stage with its tile and whether its pairs need the elementwise
//     masks (a causal / window boundary, keys past Skv for dq, or mixed
//     segment ids); a tag of END closes the item, so the consumer never
//     waits on a stage the producer does not fill. Other tiles take no
//     mask at all.
//   - Epilogue. The f32 gradient (64 x D) is staged in the item's buffer
//     (its two 16-bit tiles are exactly its size) in the layout of TMA
//     boxes of 32 f32 columns and stored by TMA (rows past S and columns
//     past D are not written): dK, then dV, through the one buffer; dq
//     once. Each gradient row has one owner: no atomics, bitwise
//     repeatable.
//   The percentages are scripts/chip_bwd_ring.py's, on an NVIDIA H100
//   80GB HBM3 at 700 W; it carries each alternative as a patch on this
//   source. What bounds it: bytes (15 / 20 us at the training shape,
//   above). Each item reads its own tiles once and the streamed ones once
//   an item, so the streamed tiles are read again for every item that
//   reaches them (from L2 where they stay there); the products run on
//   the tensor cores. The shared-memory opt-in and the register check
//   run once a device (`wg::prepare_once`).
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

#include <algorithm>
#include <atomic>

#include "fma_tile.cuh"
#include "tile_mma.cuh"
#include "wgmma_tile.cuh"

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

// --------------------------------------------------------------- wgmma bodies

constexpr int WG_THREADS = 256;  // the consumer warpgroup, then the producer warpgroup
constexpr int WG_BLOCKS = 2;     // blocks an SM, at every DP (the shared memory allows it)
constexpr int WG_PRODUCER_REGS = 40;
static_assert(BQ == wg::BOX && BK == wg::BOX, "a q or kv tile is one box of rows");

// Registers a thread: what __launch_bounds__ leaves at entry, then the
// producer warpgroup gives all but WG_PRODUCER_REGS to the consumers.
constexpr int WG_ENTRY_REGS = (65536 / (WG_THREADS * WG_BLOCKS)) & ~7;
constexpr int WG_CONSUMER_REGS =
    ((WG_THREADS * WG_ENTRY_REGS - 128 * WG_PRODUCER_REGS) / 128 > 240
         ? 240
         : (WG_THREADS * WG_ENTRY_REGS - 128 * WG_PRODUCER_REGS) / 128) &
    ~7;

// stages of the streamed ring: 4 at DP = 64, 2 at DP = 128; buffers of a
// work item's own two tiles (K and V for dk/dv, q and dO for dq): 2 and 1
__host__ __device__ constexpr int wg_stages(int DP) { return DP == 64 ? 4 : 2; }
__host__ __device__ constexpr int wg_bufs(int DP) { return DP == 64 ? 2 : 1; }

// Words of plain-loaded rows beside the tiles. dk/dv: a kv buffer's key
// segment ids; a stage's lse (+inf where a query adds nothing), delta, q
// segment ids and tag. dq: a q buffer's lse, delta and q segment ids; a
// stage's key segment ids and tag (4 words, to keep 8-byte alignment).
constexpr int DKV_ITEM_WORDS = BK;
constexpr int DKV_STAGE_WORDS = 3 * BQ + 4;
constexpr int DQ_ITEM_WORDS = 3 * BQ;
constexpr int DQ_STAGE_WORDS = BK + 4;

// dynamic shared memory: 1024 bytes of alignment slack, the buffers' and
// stages' tiles (two each), a full and an empty barrier for each buffer
// and stage, then their words
__host__ __device__ constexpr int wg_smem(int DP, int item_words, int stage_words) {
  return 1024 + 2 * (wg_bufs(DP) + wg_stages(DP)) * (DP / wg::BOX) * (int)wg::BOX_BYTES +
         16 * (wg_bufs(DP) + wg_stages(DP)) +
         4 * (wg_bufs(DP) * item_words + wg_stages(DP) * stage_words);
}
static_assert(WG_BLOCKS * (wg_smem(64, DKV_ITEM_WORDS, DKV_STAGE_WORDS) + 1024) <= SM_SMEM &&
                  WG_BLOCKS * (wg_smem(128, DKV_ITEM_WORDS, DKV_STAGE_WORDS) + 1024) <= SM_SMEM &&
                  WG_BLOCKS * (wg_smem(64, DQ_ITEM_WORDS, DQ_STAGE_WORDS) + 1024) <= SM_SMEM &&
                  WG_BLOCKS * (wg_smem(128, DQ_ITEM_WORDS, DQ_STAGE_WORDS) + 1024) <= SM_SMEM,
              "WG_BLOCKS blocks fit an SM");

// The streamed tiles [lo, hi] a work item reaches under the causal and
// window masks (lo > hi: none): q tiles for kv tile k_start (dk/dv), kv
// tiles for q tile q_start (dq). Producer and consumer both take their
// ranges from here.
__device__ __forceinline__ void q_span(int k_start, int Sq, int off, int causal, int window,
                                       int& lo, int& hi) {
  const int nq = (Sq + BQ - 1) / BQ;
  lo = nq;
  hi = -1;
  for (int iq = 0; iq < nq; ++iq) {
    if (tile_runs(iq * BQ, min(BQ, Sq - iq * BQ), k_start, off, causal, window)) {
      lo = min(lo, iq);
      hi = iq;
    }
  }
}

__device__ __forceinline__ void kv_span(int q_start, int R, int Skv, int off, int causal,
                                        int window, int& lo, int& hi) {
  const int nk = (Skv + BK - 1) / BK;
  lo = nk;
  hi = -1;
  for (int ik = 0; ik < nk; ++ik) {
    if (tile_runs(q_start, R, ik * BK, off, causal, window)) {
      lo = min(lo, ik);
      hi = ik;
    }
  }
}

// The segment-tile test, for the producer warp: the streamed tile's ids
// sit two a lane (rows or keys lane and lane + 32, valid where in0 /
// in1), the work item's span [lo_id, hi_id]. `run`: some streamed id lies
// in the span (else no pair of the two tiles can share a segment, and the
// tile is skipped: exact, since such pairs add 0). `mixed`: the pairs
// need the elementwise segment test (not every id is one and the same).
__device__ __forceinline__ void seg_test(int id0, bool in0, int id1, bool in1, int lo_id,
                                         int hi_id, bool& run, bool& mixed) {
  run = __ballot_sync(FULL, (in0 && id0 >= lo_id && id0 <= hi_id) ||
                                (in1 && id1 >= lo_id && id1 <= hi_id)) != 0;
  mixed = lo_id != hi_id ||
          __ballot_sync(FULL, (!in0 || id0 == lo_id) && (!in1 || id1 == lo_id)) != FULL;
}

__device__ __forceinline__ void warp_span(int& lo_id, int& hi_id) {
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    lo_id = min(lo_id, __shfl_xor_sync(FULL, lo_id, w));
    hi_id = max(hi_id, __shfl_xor_sync(FULL, hi_id, w));
  }
}

constexpr float POS_INF = __builtin_huge_valf();

// A stage's tag: the streamed tile's index times 2, plus 1 when its pairs
// need the elementwise masks; END closes a work item's stages (segment
// ids only, where the producer alone knows which tiles run).
constexpr int END = -1;

// One f32 gradient (64 rows x DP, the accumulators of a m64nDP product)
// into shared memory at `p` in the layout of DP / 32 TMA boxes of 32
// columns with the 128-byte swizzle (wgmma_tile.cuh).
template <int DP>
__device__ __forceinline__ void stage_grad(const float (&acc)[DP / 2], unsigned char* p, int r0,
                                           int t) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const int ch = (col & 31) >> 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      *reinterpret_cast<float2*>(p + (col >> 5) * wg::BOX_BYTES + r * 128 +
                                 ((ch ^ (r & 7)) << 4) + (col & 3) * 4) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// The staged gradient at `buf` into rows [row0, row0 + 64) of head bh by
// TMA (rows past S and columns past D are not written), then wait until
// the store has read the buffer: one thread.
__device__ __forceinline__ void store_staged(const CUtensorMap* map, uint32_t buf, int D, int row0,
                                           int bh, int boxes) {
  for (int c = 0; c < boxes && c * (wg::BOX / 2) < D; ++c) {
    wg::tma_store_3d(map, buf + c * wg::BOX_BYTES, c * (wg::BOX / 2), row0, bh);
  }
  wg::bulk_commit();
  wg::bulk_wait_read();
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// d = A . B over the head dim, both K-major: N = 64 or 32 rows of B
template <typename T, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                       bool first) {
  if constexpr (N == 64) {
    wg::mma_ss_n64<T>(d, desc_a, desc_b, first);
  } else {
    wg::mma_ss_n32<T>(d, desc_a, desc_b, first);
  }
}

// ------------------------------------------------------ dk/dv wgmma body

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(WG_THREADS, WG_BLOCKS) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,   // q as (D, Sq, B * H)
    const __grid_constant__ CUtensorMap k_map,   // k as (D, Skv, B * H)
    const __grid_constant__ CUtensorMap v_map,   // v as (D, Skv, B * H)
    const __grid_constant__ CUtensorMap do_map,  // dO as (D, Sq, B * H)
    const __grid_constant__ CUtensorMap dk_map,  // dk, f32, as (D, Skv, B * H)
    const __grid_constant__ CUtensorMap dv_map,  // dv, f32, as (D, Skv, B * H)
    const float* __restrict__ lse, const float* __restrict__ delta,  // (B, H, Sq)
    const int* __restrict__ qseg, const int* __restrict__ kseg,      // (B, Sq), (B, Skv)
    int B, int H, int Sq, int Skv, int D, int causal, int window, float scale) {
  constexpr int NB = DP / wg::BOX;              // 64-column boxes of a tile row
  constexpr int STAGES = wg_stages(DP);
  constexpr int BUFS = wg_bufs(DP);
  constexpr uint32_t TILE = NB * wg::BOX_BYTES;  // bytes of a 16-bit tile
  constexpr int KC = DP / 16;                    // k16 steps of S^T and dP^T
  constexpr int SUB = DP == 64 ? 64 : 32;        // queries a pass (a unit)
  constexpr int NH = BQ / SUB;                   // passes a q tile
  constexpr int NJ = SUB / 8;                    // n8 tiles of a pass's S^T
  constexpr int NKC = SUB / 16;                  // k16 steps of dV and dK a pass
  constexpr int SW = DKV_STAGE_WORDS;
  const int off = Skv - Sq;
  const int nk = (Skv + BK - 1) / BK;
  const int items = B * H * nk;
  const int tid = threadIdx.x;

  extern __shared__ unsigned char wsmem[];
  const uint32_t raw = tile::smem_addr(wsmem);
  const uint32_t base = (raw + 1023) & ~1023u;   // the swizzle works on 1024-byte groups
  unsigned char* gbase = wsmem + (base - raw);
  const uint32_t kv_s = base;                    // BUFS x (K tile, V tile)
  const uint32_t qd_s = kv_s + BUFS * 2 * TILE;  // STAGES x (q tile, dO tile)
  const uint32_t bars = qd_s + STAGES * 2 * TILE;
  auto kv_full = [&](int kb) { return bars + 8 * kb; };
  auto kv_empty = [&](int kb) { return bars + 8 * (BUFS + kb); };
  auto full = [&](int st) { return bars + 8 * (2 * BUFS + st); };
  auto empty = [&](int st) { return bars + 8 * (2 * BUFS + STAGES + st); };
  int* kmeta = reinterpret_cast<int*>(gbase + (bars - base) + 16 * (BUFS + STAGES));
  int* smeta = kmeta + BUFS * DKV_ITEM_WORDS;
  // stage st's words: lse, delta, q segment ids (BQ each), tag
  auto lse_m = [&](int st) { return reinterpret_cast<float*>(smeta + st * SW); };
  auto dl_m = [&](int st) { return reinterpret_cast<float*>(smeta + st * SW + BQ); };
  auto qs_m = [&](int st) { return smeta + st * SW + 2 * BQ; };
  auto tag_m = [&](int st) { return smeta + st * SW + 3 * BQ; };

  // Work item `item`: kv tile k_start of head bh, in the order of a (H, B,
  // nk) grid with the kv tiles seen by the most q tiles first (causal);
  // its q tiles [lo, hi].
  auto decode = [&](int item, int& bh, int& k_start, int& lo, int& hi) {
    bh = item % (B * H);
    k_start = item / (B * H) * BK;
    q_span(k_start, Sq, off, causal, window, lo, hi);
  };
  // The n-th item of this block: rounds of gridDim.x items, every other
  // round taken in reverse, so each block's sum of heavy and light items
  // comes out about even (past items: no more).
  auto next_item = [&](int n) {
    return n * (int)gridDim.x + ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };

  if (tid == 0) {
    for (int kb = 0; kb < BUFS; ++kb) {
      wg::mbar_init(kv_full(kb), 32);   // every lane of the producer warp
      wg::mbar_init(kv_empty(kb), 128);  // every consumer thread
    }
    for (int st = 0; st < STAGES; ++st) {
      wg::mbar_init(full(st), 32);
      wg::mbar_init(empty(st), 128);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so the compiler knows it is uniform
  const int wgi = __shfl_sync(FULL, tid >> 7, 0);
  if (wgi == 1) {
    // ---- producer: one warp loads, the others leave
    wg::setmaxnreg_dec<WG_PRODUCER_REGS>();
    if ((tid & 127) >= 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      wg::tma_prefetch_map(&q_map);
      wg::tma_prefetch_map(&k_map);
      wg::tma_prefetch_map(&v_map);
      wg::tma_prefetch_map(&do_map);
    }
    int st = 0, ph = 0;  // the ring: stage and phase
    for (int n = 0, item = next_item(0); item < items; item = next_item(++n)) {
      int bh, k_start, lo, hi;
      decode(item, bh, k_start, lo, hi);
      const int b = bh / H;
      const int C = min(BK, Skv - k_start);
      // this lane's rows of q tile iq: lse (+inf where the row adds
      // nothing: past Sq, or dead at the -1e30 sentinel), delta, segment id
      auto fetch = [&](int iq, float (&l)[2], float (&d)[2], int (&s)[2]) {
        const int q_start = iq * BQ;
        const size_t row0 = (size_t)bh * Sq + q_start;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          const bool in = q_start + j < Sq;
          const float x = in ? lse[row0 + j] : NEG_INF;
          l[u] = x > NEG_INF / 2 ? x : POS_INF;
          d[u] = in ? delta[row0 + j] : 0.f;
          s[u] = SEG && in ? qseg[(size_t)b * Sq + q_start + j] : 0;
        }
      };
      float l[2], d[2], l1[2] = {0.f, 0.f}, d1[2] = {0.f, 0.f};
      int s[2], s1[2] = {0, 0};
      if (lo <= hi) fetch(lo, l, d, s);
      // the key segment ids and their span
      int ks[2] = {0, 0};
      int lo_id = 0x7fffffff, hi_id = -0x7fffffff - 1;
      if (SEG) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = lane + 32 * u;
          if (j < C) {
            ks[u] = kseg[(size_t)b * Skv + k_start + j];
            lo_id = min(lo_id, ks[u]);
            hi_id = max(hi_id, ks[u]);
          }
        }
        warp_span(lo_id, hi_id);
      }
      // K and V into buffer n % BUFS once the item before last has left it
      const int kb = n % BUFS;
      wg::mbar_wait(kv_empty(kb), ((n / BUFS) & 1) ^ 1);  // the first round finds it free
      if (SEG) {
        kmeta[kb * BK + lane] = ks[0];
        kmeta[kb * BK + lane + 32] = ks[1];
      }
      if (lane == 0 && lo <= hi) {
        wg::mbar_arrive_expect_tx(kv_full(kb), 2 * TILE);
        const uint32_t kt = kv_s + kb * 2 * TILE;
        for (int c = 0; c < NB; ++c) {
          wg::tma_load_3d(kt + c * wg::BOX_BYTES, &k_map, kv_full(kb), c * wg::BOX, k_start, bh);
          wg::tma_load_3d(kt + TILE + c * wg::BOX_BYTES, &v_map, kv_full(kb), c * wg::BOX,
                          k_start, bh);
        }
      } else {
        wg::mbar_arrive(kv_full(kb));  // an item without q tiles still hands its buffer over
      }
      for (int iq = lo; iq <= hi; ++iq) {
        if (iq < hi) fetch(iq + 1, l1, d1, s1);  // in flight while this tile is handed over
        const int q_start = iq * BQ;
        const int R = min(BQ, Sq - q_start);
        bool run = true;
        bool mask = !tile::tile_whole(q_start, R, k_start, off, causal, window);
        if (SEG) {
          bool mixed;
          seg_test(s[0], lane < R, s[1], lane + 32 < R, lo_id, hi_id, run, mixed);
          mask = mask || mixed;
        }
        if (run) {
          wg::mbar_wait(empty(st), ph ^ 1);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            lse_m(st)[lane + 32 * u] = l[u];
            dl_m(st)[lane + 32 * u] = d[u];
            if (SEG) qs_m(st)[lane + 32 * u] = s[u];
          }
          if (lane == 0) {
            *tag_m(st) = 2 * iq + (mask ? 1 : 0);
            wg::mbar_arrive_expect_tx(full(st), 2 * TILE);
            const uint32_t qt = qd_s + st * 2 * TILE;
            for (int c = 0; c < NB; ++c) {
              wg::tma_load_3d(qt + c * wg::BOX_BYTES, &q_map, full(st), c * wg::BOX, q_start, bh);
              wg::tma_load_3d(qt + TILE + c * wg::BOX_BYTES, &do_map, full(st), c * wg::BOX,
                              q_start, bh);
            }
          } else {
            wg::mbar_arrive(full(st));
          }
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          l[u] = l1[u];
          d[u] = d1[u];
          s[u] = s1[u];
        }
      }
      if (SEG && lo <= hi) {  // the item's last stage: no tile, its end
        wg::mbar_wait(empty(st), ph ^ 1);
        if (lane == 0) *tag_m(st) = END;
        wg::mbar_arrive(full(st));
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroup: the 64 keys of each kv tile
    wg::setmaxnreg_inc<WG_CONSUMER_REGS>();
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int key0 = warp * 16 + g;  // this thread's keys: key0 and key0 + 8

    float dk[DP / 2], dv[DP / 2];
    float s[SUB / 2], dp[SUB / 2];   // S^T then P^T; dP^T then dS^T, of one pass
    uint32_t pa[NKC][4], sa[NKC][4];  // P^T and dS^T of the previous pass, packed A operands
    int st = 0, ph = 0;               // the ring, walked as the producer walks it
    auto advance = [&]() {
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    };
    auto pin = [&]() {  // every register operand, before wgmma.fence
      wg::fence_operands(dk);
      wg::fence_operands(dv);
#pragma unroll
      for (int kc = 0; kc < NKC; ++kc) {
        wg::fence_operands(pa[kc]);
        wg::fence_operands(sa[kc]);
      }
    };
    // P^T rounded to dO's dtype and dS^T to q's (both T): the A operands
    // of dV and dK, in the m16n8k16 A layout straight from the accumulators
    auto pack = [&]() {
#pragma unroll
      for (int kc = 0; kc < NKC; ++kc) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kc][i] = tile::pack2<T>(s[8 * kc + 2 * i], s[8 * kc + 2 * i + 1]);
          sa[kc][i] = tile::pack2<T>(dp[8 * kc + 2 * i], dp[8 * kc + 2 * i + 1]);
        }
      }
    };

    for (int n = 0, item = next_item(0); item < items; item = next_item(++n)) {
      int bh, k_start, lo, hi;
      decode(item, bh, k_start, lo, hi);
      const int kb = n % BUFS;
      const uint32_t kt = kv_s + kb * 2 * TILE;  // K, then V
      const uint32_t vt = kt + TILE;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
      wg::mbar_wait(kv_full(kb), (n / BUFS) & 1);
      int ks0 = 0, ks1 = 0;
      if (SEG) {
        ks0 = kmeta[kb * BK + key0];
        ks1 = kmeta[kb * BK + key0 + 8];
      }

      // The next q tile after `prev` (lo - 1 at first), its stage full:
      // its index and whether its pairs need the masks; -1 at the end.
      // Without segment ids the range says it; with them, the stage's tag.
      auto take = [&](int prev, bool& mask) {
        if constexpr (SEG) {
          wg::mbar_wait(full(st), ph);
          const int tag = __shfl_sync(FULL, *tag_m(st), 0);
          if (tag == END) {
            wg::mbar_arrive(empty(st));
            advance();
            return -1;
          }
          mask = tag & 1;
          return tag >> 1;
        } else {
          const int iq = prev + 1;
          if (iq > hi) return -1;
          const int q_start = iq * BQ;
          mask = !tile::tile_whole(q_start, min(BQ, Sq - q_start), k_start, off, causal, window);
          wg::mbar_wait(full(st), ph);
          return iq;
        }
      };
      // S^T = K.Q^T and dP^T = V.dO^T of pass h of the q tile in stage
      // sq: D/16 k16 steps, every operand K-major; queries h * SUB on
      auto issue_s = [&](int sq, int h) {
        const uint32_t qt = qd_s + sq * 2 * TILE + h * SUB * 128;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const uint32_t step = (kk >> 2) * wg::BOX_BYTES + (kk & 3) * 32;
          mma_ss<T, SUB>(s, wg::desc_k_major(kt + step), wg::desc_k_major(qt + step), kk == 0);
        }
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const uint32_t step = (kk >> 2) * wg::BOX_BYTES + (kk & 3) * 32;
          mma_ss<T, SUB>(dp, wg::desc_k_major(vt + step), wg::desc_k_major(qt + TILE + step),
                         kk == 0);
        }
        wg::commit();
      };
      // dV += P^T.dO and dK += dS^T.Q of pass h of the tile in stage sq:
      // dO and q MN-major (the queries are the reduced axis) with the
      // transpose bit, from the same swizzled tiles
      auto issue_dkv = [&](int sq, int h) {
        const uint32_t qt = qd_s + sq * 2 * TILE;
#pragma unroll
        for (int kc = 0; kc < NKC; ++kc) {
          const uint32_t rows = (h * SUB + 16 * kc) * 128;
          wg::mma_rs<T, DP>(dv, pa[kc], wg::desc_mn_major(qt + TILE + rows), 1);
          wg::mma_rs<T, DP>(dk, sa[kc], wg::desc_mn_major(qt + rows), 1);
        }
        wg::commit();
      };
      // P^T = exp(S^T * scale - lse), 0 where masked; dS^T = P^T * (dP^T -
      // delta) * scale, in the twin's order. Queries past Sq and dead rows
      // have lse = +inf, so their p is exactly 0 without a test; keys past
      // Skv form rows of dK and dV that are not stored.
      auto pass = [&](int iq, int h, int sq, bool mask) {
        const float* lt = lse_m(sq) + h * SUB;
        const float* dt = dl_m(sq) + h * SUB;
        const int* qst = qs_m(sq) + h * SUB;
        // this thread's keys sit at kp0 and kp0 + 8 counted from the
        // first query of the pass, its queries at 8 j + 2 t and + 1
        const int kp0 = k_start + key0 - (iq * BQ + h * SUB + off);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c0 = 8 * j + 2 * t;
          const float2 lv = *reinterpret_cast<const float2*>(lt + c0);
          const float2 dv2 = *reinterpret_cast<const float2*>(dt + c0);
          int2 qs2 = make_int2(0, 0);
          if (SEG && mask) qs2 = *reinterpret_cast<const int2*>(qst + c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c0 + (e & 1);
            float p = wg::exp(s[4 * j + e] * scale - ((e & 1) ? lv.y : lv.x));
            if (mask) {
              const int kp = kp0 + ((e >> 1) << 3);
              bool seen = true;
              if (causal) seen = kp <= qc && (window <= 0 || qc - kp < window);
              if (SEG) seen = seen && ((e & 1) ? qs2.y : qs2.x) == ((e >> 1) ? ks1 : ks0);
              p = seen ? p : 0.f;
            }
            s[4 * j + e] = p;
            dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? dv2.y : dv2.x)) * scale;
          }
        }
        // done here, not after the caller's next wait_group: the compiler
        // would otherwise sink the exponentials past it, out of the overlap
        wg::fence_operands(s);
        wg::fence_operands(dp);
      };

      if (lo <= hi) {
        bool mask = false;
        int iq = take(lo - 1, mask);
        if (iq >= 0) {
          // the first pass alone; then pass u's S^T and dP^T are issued
          // with pass u - 1's dV and dK behind them, so pass u's
          // elementwise work runs while the tensor cores add pass u - 1
          int sq = st;
          advance();
          wg::fence();
          issue_s(sq, 0);
          wg::wait<0>();
          wg::fence_operands(s);
          wg::fence_operands(dp);
          pass(iq, 0, sq, mask);
          pack();
          int ps = sq, phh = 0;  // the previous pass: its stage and half
          int h = 0;
          while (true) {
            if (++h == NH) {  // the next q tile
              h = 0;
              iq = take(iq, mask);
              if (iq < 0) break;
              sq = st;
              advance();
            }
            pin();
            wg::fence();
            issue_s(sq, h);
            issue_dkv(ps, phh);
            wg::wait<1>();  // S^T and dP^T have landed; dV and dK may still run
            wg::fence_operands(s);
            wg::fence_operands(dp);
            pass(iq, h, sq, mask);
            wg::wait<0>();  // pass u - 1 is in dV and dK
            wg::fence_operands(dk);
            wg::fence_operands(dv);
            if (phh == NH - 1) wg::mbar_arrive(empty(ps));  // its stage is read
            pack();
            ps = sq;
            phh = h;
          }
          // the last pass's dV and dK
          pin();
          wg::fence();
          issue_dkv(ps, phh);
          wg::wait<0>();
          wg::fence_operands(dk);
          wg::fence_operands(dv);
          wg::mbar_arrive(empty(ps));
        }
      }

      // epilogue: dK, then dV, as f32 in the kv buffer (its K and V are
      // read once the warpgroup meets here), each stored by TMA
      unsigned char* buf = gbase + (kt - base);
      consumer_sync();
      stage_grad<DP>(dk, buf, key0, t);
      wg::fence_proxy_async();  // the staged tile, visible to the TMA store
      consumer_sync();
      if (tid == 0) store_staged(&dk_map, kt, D, k_start, bh, DP / 32);
      consumer_sync();          // the buffer is read
      stage_grad<DP>(dv, buf, key0, t);
      wg::fence_proxy_async();
      consumer_sync();
      if (tid == 0) store_staged(&dv_map, kt, D, k_start, bh, DP / 32);
      // the buffer may take the item after next: this thread's reads and
      // writes of it come before the TMA's write
      wg::fence_proxy_async();
      wg::mbar_arrive(kv_empty(kb));
    }
    if (tid == 0) wg::bulk_wait();  // the last stores are done before the block is
  }
}

// --------------------------------------------------------- dq wgmma body

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(WG_THREADS, WG_BLOCKS) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,   // q as (D, Sq, B * H)
    const __grid_constant__ CUtensorMap k_map,   // k as (D, Skv, B * H)
    const __grid_constant__ CUtensorMap v_map,   // v as (D, Skv, B * H)
    const __grid_constant__ CUtensorMap do_map,  // dO as (D, Sq, B * H)
    const __grid_constant__ CUtensorMap dq_map,  // dq, f32, as (D, Sq, B * H)
    const float* __restrict__ lse, const float* __restrict__ delta,  // (B, H, Sq)
    const int* __restrict__ qseg, const int* __restrict__ kseg,      // (B, Sq), (B, Skv)
    int B, int H, int Sq, int Skv, int D, int causal, int window, float scale) {
  constexpr int NB = DP / wg::BOX;
  constexpr int STAGES = wg_stages(DP);
  constexpr int BUFS = wg_bufs(DP);
  constexpr uint32_t TILE = NB * wg::BOX_BYTES;
  constexpr int KC = DP / 16;  // k16 steps of S and dP
  constexpr int NT = BK / 8;   // n8 tiles of a score row
  constexpr int SW = DQ_STAGE_WORDS;
  const int off = Skv - Sq;
  const int nq = (Sq + BQ - 1) / BQ;
  const int items = B * H * nq;
  const int tid = threadIdx.x;

  extern __shared__ unsigned char wsmem[];
  const uint32_t raw = tile::smem_addr(wsmem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = wsmem + (base - raw);
  const uint32_t qd_s = base;                    // BUFS x (q tile, dO tile)
  const uint32_t kv_s = qd_s + BUFS * 2 * TILE;  // STAGES x (K tile, V tile)
  const uint32_t bars = kv_s + STAGES * 2 * TILE;
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (BUFS + qb); };
  auto full = [&](int st) { return bars + 8 * (2 * BUFS + st); };
  auto empty = [&](int st) { return bars + 8 * (2 * BUFS + STAGES + st); };
  int* qmeta = reinterpret_cast<int*>(gbase + (bars - base) + 16 * (BUFS + STAGES));
  int* smeta = qmeta + BUFS * DQ_ITEM_WORDS;
  // buffer qb's words: lse (+inf where a row adds nothing), delta, q segment ids
  auto lse_m = [&](int qb) { return reinterpret_cast<float*>(qmeta + qb * DQ_ITEM_WORDS); };
  auto dl_m = [&](int qb) { return reinterpret_cast<float*>(qmeta + qb * DQ_ITEM_WORDS + BQ); };
  auto qs_m = [&](int qb) { return qmeta + qb * DQ_ITEM_WORDS + 2 * BQ; };
  // stage st's words: key segment ids, tag
  auto ks_m = [&](int st) { return smeta + st * SW; };
  auto tag_m = [&](int st) { return smeta + st * SW + BK; };

  // Work item `item`: q tile q_start of head bh, the q tiles that see the
  // most kv tiles first (the forward's order); its kv tiles [lo, hi].
  auto decode = [&](int item, int& bh, int& q_start, int& lo, int& hi) {
    bh = item % (B * H);
    q_start = (nq - 1 - item / (B * H)) * BQ;
    kv_span(q_start, min(BQ, Sq - q_start), Skv, off, causal, window, lo, hi);
  };
  auto next_item = [&](int n) {
    return n * (int)gridDim.x + ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };
  // pairs of q tile q_start (R rows) and kv tile ik that need the
  // elementwise causal / window test, or the test of keys past Skv
  auto masked = [&](int q_start, int R, int ik) {
    return Skv - ik * BK < BK || !tile::tile_whole(q_start, R, ik * BK, off, causal, window);
  };

  if (tid == 0) {
    for (int qb = 0; qb < BUFS; ++qb) {
      wg::mbar_init(q_full(qb), 32);
      wg::mbar_init(q_empty(qb), 128);
    }
    for (int st = 0; st < STAGES; ++st) {
      wg::mbar_init(full(st), 32);
      wg::mbar_init(empty(st), 128);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  const int wgi = __shfl_sync(FULL, tid >> 7, 0);
  if (wgi == 1) {
    // ---- producer: one warp loads, the others leave
    wg::setmaxnreg_dec<WG_PRODUCER_REGS>();
    if ((tid & 127) >= 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      wg::tma_prefetch_map(&q_map);
      wg::tma_prefetch_map(&k_map);
      wg::tma_prefetch_map(&v_map);
      wg::tma_prefetch_map(&do_map);
    }
    int st = 0, ph = 0;
    for (int n = 0, item = next_item(0); item < items; item = next_item(++n)) {
      int bh, q_start, lo, hi;
      decode(item, bh, q_start, lo, hi);
      const int b = bh / H;
      const int R = min(BQ, Sq - q_start);
      const size_t row0 = (size_t)bh * Sq + q_start;
      // this lane's rows: lse (+inf where the row adds nothing), delta,
      // segment id; and the span of the tile's segment ids
      float l[2], d[2];
      int s[2] = {0, 0};
      int lo_id = 0x7fffffff, hi_id = -0x7fffffff - 1;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = lane + 32 * u;
        const bool in = j < R;
        const float x = in ? lse[row0 + j] : NEG_INF;
        l[u] = x > NEG_INF / 2 ? x : POS_INF;
        d[u] = in ? delta[row0 + j] : 0.f;
        if (SEG && in) {
          s[u] = qseg[(size_t)b * Sq + q_start + j];
          lo_id = min(lo_id, s[u]);
          hi_id = max(hi_id, s[u]);
        }
      }
      if (SEG) warp_span(lo_id, hi_id);
      const int qb = n % BUFS;
      wg::mbar_wait(q_empty(qb), ((n / BUFS) & 1) ^ 1);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        lse_m(qb)[lane + 32 * u] = l[u];
        dl_m(qb)[lane + 32 * u] = d[u];
        qs_m(qb)[lane + 32 * u] = s[u];
      }
      if (lane == 0) {
        wg::mbar_arrive_expect_tx(q_full(qb), 2 * TILE);
        const uint32_t qt = qd_s + qb * 2 * TILE;
        for (int c = 0; c < NB; ++c) {
          wg::tma_load_3d(qt + c * wg::BOX_BYTES, &q_map, q_full(qb), c * wg::BOX, q_start, bh);
          wg::tma_load_3d(qt + TILE + c * wg::BOX_BYTES, &do_map, q_full(qb), c * wg::BOX,
                          q_start, bh);
        }
      } else {
        wg::mbar_arrive(q_full(qb));
      }
      // this lane's keys lane and lane + 32 of kv tile ik
      auto fetch = [&](int ik, int (&ks)[2]) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = ik * BK + lane + 32 * u;
          ks[u] = SEG && j < Skv ? kseg[(size_t)b * Skv + j] : 0;
        }
      };
      int ks[2] = {0, 0}, ks1[2] = {0, 0};
      if (SEG && lo <= hi) fetch(lo, ks);
      for (int ik = lo; ik <= hi; ++ik) {
        if (SEG && ik < hi) fetch(ik + 1, ks1);
        const int k_start = ik * BK;
        bool run = true;
        bool mask = masked(q_start, R, ik);
        if (SEG) {
          const int C = min(BK, Skv - k_start);
          bool mixed;
          seg_test(ks[0], lane < C, ks[1], lane + 32 < C, lo_id, hi_id, run, mixed);
          mask = mask || mixed;
        }
        if (run) {
          wg::mbar_wait(empty(st), ph ^ 1);
          if (SEG) {
            ks_m(st)[lane] = ks[0];
            ks_m(st)[lane + 32] = ks[1];
          }
          if (lane == 0) {
            *tag_m(st) = 2 * ik + (mask ? 1 : 0);
            wg::mbar_arrive_expect_tx(full(st), 2 * TILE);
            const uint32_t kt = kv_s + st * 2 * TILE;
            for (int c = 0; c < NB; ++c) {
              wg::tma_load_3d(kt + c * wg::BOX_BYTES, &k_map, full(st), c * wg::BOX, k_start, bh);
              wg::tma_load_3d(kt + TILE + c * wg::BOX_BYTES, &v_map, full(st), c * wg::BOX,
                              k_start, bh);
            }
          } else {
            wg::mbar_arrive(full(st));
          }
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
        ks[0] = ks1[0];
        ks[1] = ks1[1];
      }
      if (SEG && lo <= hi) {
        wg::mbar_wait(empty(st), ph ^ 1);
        if (lane == 0) *tag_m(st) = END;
        wg::mbar_arrive(full(st));
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroup: the 64 query rows of each q tile
    wg::setmaxnreg_inc<WG_CONSUMER_REGS>();
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

    float dq[DP / 2];
    float s[NT * 4], dp[NT * 4];  // S then P; dP then dS
    uint32_t sa[NT / 2][4];       // dS of the previous tile, the A operand of its dQ
    int st = 0, ph = 0;
    auto advance = [&]() {
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    };
    auto pin = [&]() {
      wg::fence_operands(dq);
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) wg::fence_operands(sa[kc]);
    };
    // dS rounded to q's dtype (T): the A operand of dQ += dS.K
    auto pack = [&]() {
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sa[kc][i] = tile::pack2<T>(dp[8 * kc + 2 * i], dp[8 * kc + 2 * i + 1]);
      }
    };
    // dQ += dS.K of the tile in stage sk: K MN-major (the keys are the
    // reduced axis) with the transpose bit
    auto issue_dq = [&](int sk) {
      const uint32_t kt = kv_s + sk * 2 * TILE;
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        wg::mma_rs<T, DP>(dq, sa[kc], wg::desc_mn_major(kt + kc * 16 * 128), 1);
      }
      wg::commit();
    };

    for (int n = 0, item = next_item(0); item < items; item = next_item(++n)) {
      int bh, q_start, lo, hi;
      decode(item, bh, q_start, lo, hi);
      const int R = min(BQ, Sq - q_start);
      const int qb = n % BUFS;
      const uint32_t qt = qd_s + qb * 2 * TILE;  // q, then dO
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
      wg::mbar_wait(q_full(qb), (n / BUFS) & 1);
      // rows r0 and r0 + 8: lse (+inf where a row adds nothing), delta, segment id
      const float l0 = lse_m(qb)[r0], l1 = lse_m(qb)[r0 + 8];
      const float d0 = dl_m(qb)[r0], d1 = dl_m(qb)[r0 + 8];
      const int qs0 = SEG ? qs_m(qb)[r0] : 0;
      const int qs1 = SEG ? qs_m(qb)[r0 + 8] : 0;

      auto take = [&](int prev, bool& mask) {
        if constexpr (SEG) {
          wg::mbar_wait(full(st), ph);
          const int tag = __shfl_sync(FULL, *tag_m(st), 0);
          if (tag == END) {
            wg::mbar_arrive(empty(st));
            advance();
            return -1;
          }
          mask = tag & 1;
          return tag >> 1;
        } else {
          const int ik = prev + 1;
          if (ik > hi) return -1;
          mask = masked(q_start, R, ik);
          wg::mbar_wait(full(st), ph);
          return ik;
        }
      };
      // S = Q.K^T and dP = dO.V^T of the tile in stage sk, both operands
      // K-major
      auto issue_s = [&](int sk) {
        const uint32_t kt = kv_s + sk * 2 * TILE;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const uint32_t step = (kk >> 2) * wg::BOX_BYTES + (kk & 3) * 32;
          wg::mma_ss_n64<T>(s, wg::desc_k_major(qt + step), wg::desc_k_major(kt + step), kk == 0);
        }
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const uint32_t step = (kk >> 2) * wg::BOX_BYTES + (kk & 3) * 32;
          wg::mma_ss_n64<T>(dp, wg::desc_k_major(qt + TILE + step),
                            wg::desc_k_major(kt + TILE + step), kk == 0);
        }
        wg::commit();
      };
      // P = exp(S * scale - lse), 0 where masked; dS = P * (dP - delta) *
      // scale, in the twin's order. Dead rows have lse = +inf: p is 0.
      auto pass = [&](int ik, int sk, bool mask) {
        const int k_start = ik * BK;
        const int C = min(BK, Skv - k_start);
        const int* kst = ks_m(sk);
        // rows r0 and r0 + 8 sit at qp0 and qp0 + 8 counted from the
        // tile's first key, this thread's keys at 8 j + 2 t and + 1
        const int qp0 = q_start + r0 + off - k_start;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int k0 = 8 * j + 2 * t;
          int2 ks2 = make_int2(0, 0);
          if (SEG && mask) ks2 = *reinterpret_cast<const int2*>(kst + k0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = wg::exp(s[4 * j + e] * scale - ((e >> 1) ? l1 : l0));
            if (mask) {
              const int kj = k0 + (e & 1);
              const int qp = qp0 + ((e >> 1) << 3);
              bool seen = kj < C;
              if (causal) seen = seen && kj <= qp && (window <= 0 || qp - kj < window);
              if (SEG) seen = seen && ((e & 1) ? ks2.y : ks2.x) == ((e >> 1) ? qs1 : qs0);
              p = seen ? p : 0.f;
            }
            dp[4 * j + e] = p * (dp[4 * j + e] - ((e >> 1) ? d1 : d0)) * scale;
          }
        }
        wg::fence_operands(dp);
      };

      if (lo <= hi) {
        bool mask = false;
        int ik = take(lo - 1, mask);
        if (ik >= 0) {
          // the first tile's S and dP alone
          int prev = st;
          advance();
          wg::fence();
          issue_s(prev);
          wg::wait<0>();
          wg::fence_operands(s);
          wg::fence_operands(dp);
          pass(ik, prev, mask);
          pack();
          pin();
          wg::fence();
          issue_dq(prev);
          // tile ik's S and dP queue behind the previous tile's dQ, whose
          // stage is released as soon as it retires
          while ((ik = take(ik, mask)) >= 0) {
            const int sk = st;
            advance();
            wg::fence();
            issue_s(sk);
            wg::wait<1>();  // the previous tile is in dQ, and its stage is read
            wg::fence_operands(dq);
            wg::mbar_arrive(empty(prev));
            wg::wait<0>();
            wg::fence_operands(s);
            wg::fence_operands(dp);
            pass(ik, sk, mask);
            pack();
            pin();
            wg::fence();
            issue_dq(sk);
            prev = sk;
          }
          wg::wait<0>();
          wg::fence_operands(dq);
          wg::mbar_arrive(empty(prev));
        }
      }

      // epilogue: dQ as f32 in the q buffer (its q and dO are read once
      // the warpgroup meets here), stored by TMA
      consumer_sync();
      stage_grad<DP>(dq, gbase + (qt - base), r0, t);
      wg::fence_proxy_async();
      consumer_sync();
      if (tid == 0) store_staged(&dq_map, qt, D, q_start, bh, DP / 32);
      wg::fence_proxy_async();
      wg::mbar_arrive(q_empty(qb));
    }
    if (tid == 0) wg::bulk_wait();
  }
}

template <typename T, int DP, bool SEG>
cudaError_t launch_dkv_wgmma(const Args& a, float* dk, float* dv) {
  auto kern = flash_bwd_dkv_wgmma_kernel<T, DP, SEG>;
  const int smem = wg_smem(DP, DKV_ITEM_WORDS, DKV_STAGE_WORDS);
  static std::atomic<int> sms[64];
  int nsm = 0;
  cudaError_t err = wg::prepare_once(sms, kern, smem, WG_THREADS,
                                     128 * (WG_PRODUCER_REGS + WG_CONSUMER_REGS), &nsm);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H;
  CUtensorMap maps[6];
  if (!wg::tile_map<T>(&maps[0], a.q, a.D, a.Sq, BH) ||
      !wg::tile_map<T>(&maps[1], a.k, a.D, a.Skv, BH) ||
      !wg::tile_map<T>(&maps[2], a.v, a.D, a.Skv, BH) ||
      !wg::tile_map<T>(&maps[3], a.dout, a.D, a.Sq, BH) ||
      !wg::grad_map(&maps[4], dk, a.D, a.Skv, BH) || !wg::grad_map(&maps[5], dv, a.D, a.Skv, BH)) {
    return cudaErrorInvalidValue;
  }
  // persistent blocks: as many as the SMs hold at once
  const long items = (long)BH * ((a.Skv + BK - 1) / BK);
  const int grid = (int)std::min<long>(items, (long)nsm * WG_BLOCKS);
  kern<<<grid, WG_THREADS, smem, a.stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
                                             a.lse, a.delta, a.qseg, a.kseg, a.B, a.H, a.Sq,
                                             a.Skv, a.D, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv_wgmma_any(const Args& a, float* dk, float* dv) {
  const bool seg = a.qseg != nullptr;
  if (a.D <= 64) {
    return seg ? launch_dkv_wgmma<T, 64, true>(a, dk, dv) : launch_dkv_wgmma<T, 64, false>(a, dk, dv);
  }
  return seg ? launch_dkv_wgmma<T, 128, true>(a, dk, dv) : launch_dkv_wgmma<T, 128, false>(a, dk, dv);
}

template <typename T, int DP, bool SEG>
cudaError_t launch_dq_wgmma(const Args& a, float* dq) {
  auto kern = flash_bwd_dq_wgmma_kernel<T, DP, SEG>;
  const int smem = wg_smem(DP, DQ_ITEM_WORDS, DQ_STAGE_WORDS);
  static std::atomic<int> sms[64];
  int nsm = 0;
  cudaError_t err = wg::prepare_once(sms, kern, smem, WG_THREADS,
                                     128 * (WG_PRODUCER_REGS + WG_CONSUMER_REGS), &nsm);
  if (err != cudaSuccess) return err;
  const int BH = a.B * a.H;
  CUtensorMap maps[5];
  if (!wg::tile_map<T>(&maps[0], a.q, a.D, a.Sq, BH) ||
      !wg::tile_map<T>(&maps[1], a.k, a.D, a.Skv, BH) ||
      !wg::tile_map<T>(&maps[2], a.v, a.D, a.Skv, BH) ||
      !wg::tile_map<T>(&maps[3], a.dout, a.D, a.Sq, BH) ||
      !wg::grad_map(&maps[4], dq, a.D, a.Sq, BH)) {
    return cudaErrorInvalidValue;
  }
  const long items = (long)BH * ((a.Sq + BQ - 1) / BQ);
  const int grid = (int)std::min<long>(items, (long)nsm * WG_BLOCKS);
  kern<<<grid, WG_THREADS, smem, a.stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4], a.lse,
                                             a.delta, a.qseg, a.kseg, a.B, a.H, a.Sq, a.Skv, a.D,
                                             a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_wgmma_any(const Args& a, float* dq) {
  const bool seg = a.qseg != nullptr;
  if (a.D <= 64) return seg ? launch_dq_wgmma<T, 64, true>(a, dq) : launch_dq_wgmma<T, 64, false>(a, dq);
  return seg ? launch_dq_wgmma<T, 128, true>(a, dq) : launch_dq_wgmma<T, 128, false>(a, dq);
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
    return (int)(dtype == BF16 ? launch_dq_wgmma_any<__nv_bfloat16>(a, out)
                               : launch_dq_wgmma_any<__half>(a, out));
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
    return (int)(dtype == BF16 ? launch_dkv_wgmma_any<__nv_bfloat16>(a, gk, gv)
                               : launch_dkv_wgmma_any<__half>(a, gk, gv));
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
