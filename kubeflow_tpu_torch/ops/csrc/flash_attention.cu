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
// that latency (up to 8 kv tiles in sequence for a q tile) and the
// exponentials of the softmax set the pace.
//
// Two bodies, chosen in the C entry point by dtype and D only (mirrored
// by `body()` in ops/flash_attention.py):
//
// * bf16 / f16 with D a multiple of 16 up to 128: `flash_fwd_wgmma_kernel`,
//   on the tensor cores through Hopper's warpgroup path (wgmma_tile.cuh).
//   - Warp specialisation. A block is one consumer warpgroup of 64 query
//     rows and one producer warpgroup. The producer keeps 32 registers a
//     thread (`setmaxnreg.dec`), and one of its warps issues every copy;
//     the consumers take the rest (`setmaxnreg.inc`: 128 at D <= 64, 224
//     at D <= 128) and only compute. One consumer warpgroup (3 blocks an
//     SM at D <= 64) against two (128 rows sharing one K/V stream, 2
//     blocks an SM): two are 3% faster at S = 512 but lose the BERT
//     shapes and D = 128, and their consumers get 104 registers and
//     spill; scripts/chip_fwd_tiles.py carries the two-warpgroup variant
//     as a patch and times both (PERF.md).
//   - Persistent blocks. The launch has as many blocks as the SMs hold at
//     once; block c takes the q tiles c, 2G - 1 - c, 2G + c, ... of the
//     heaviest-first order (G blocks), so blocks get even work. Each q
//     tile has two buffers: the producer loads the next tile's q and k/v
//     while the consumers finish this one.
//   - TMA and an mbarrier ring. q, k, v and out are 3-D tensor maps (D, S,
//     B * H) of 64 x 64 boxes with the 128-byte swizzle, encoded on the
//     host for each call (cuTensorMapEncodeTiled, fetched through the
//     runtime's driver entry point). k/v tiles of 64 keys stream through
//     3 stages at D <= 64, 2 at D <= 128, with a full and an empty
//     barrier a stage. A box reads zeros past D (D = 16, 48, ... in a
//     tile of 64 or 128 columns) and past S (the ragged last tile), and
//     never the next head's rows; `expect_tx` counts the whole box. The kv
//     segment ids of a stage come by plain loads of the producer warp's
//     lanes, each of which arrives on the full barrier after its stores (a
//     2-D map of int32 ids would need Skv * 4 to be a multiple of 16).
//   - S = Q.K^T as wgmma m64n64k16 (f32 accumulators) over D/16 steps,
//     both operands K-major in shared memory. The accumulator layout is
//     the mma.sync m16n8 one repeated along n, so the scale, the masks
//     and the quad-shuffle online softmax work on it thread for thread as
//     on mma.sync fragments. Tiles of 64 keys: at S <= 512 a causal
//     diagonal tile masks less, the masks' tile helpers are shared with
//     the backward, and S, P and O fit the consumer's registers.
//   - O += P.V as wgmma m64nDk16 with A in registers: p rounded to the
//     input type and packed from the accumulators (the m16n8k16 A
//     layout); V from shared memory, MN-major with the transpose bit.
//     Tile j's S is issued with tile j - 1's P.V behind it, so tile j's
//     softmax runs while the tensor cores add tile j - 1 to O; a consumer
//     arrives on a stage's empty barrier once the P.V wait_group has
//     retired its reads.
//   - ptxas waits for every wgmma right after its issue if anything in
//     the kernel makes it unsure (a call, as IEEE division's slow path; a
//     branch it cannot see is uniform; an ordinary instruction writing an
//     accumulator between a fence and its wgmma): `build` in chip_smoke.py
//     reports that as "wgmma serialized".
//   - Epilogue: out = acc / l in T staged in the tile's q buffer and
//     written by TMA stores (rows past Sq and columns past D are not
//     written), lse in f32. The shared-memory opt-in is set once a
//     device, and __launch_bounds__ states the blocks an SM from the same
//     arithmetic as the shared memory.
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
// kernels test. A causal row before the first key (Sq > Skv) is such a
// row: both bodies walk every kv tile for its q tile, so its mean runs
// over all Skv keys, as in the twin.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "fma_tile.cuh"
#include "tile_mma.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
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

  // the kv tiles that run (causal and window skips) form one range [lo, hi];
  // a block with a row before the first key (causal, Sq > Skv) walks every
  // kv tile, so that row ends at mean(v) over all Skv keys, as the twin's
  // (written as one test in the loop: a separate widening after it made
  // ptxas spill 4 bytes at f32, DP = 64)
  const int nk = (Skv + FMA_BK - 1) / FMA_BK;
  int lo = nk, hi = -1;
  for (int ik = 0; ik < nk; ++ik) {
    if (q_start + off < 0 || fma_tile::tile_runs(q_start, R, ik * FMA_BK, off, causal, window)) {
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

// -------------------------------------------------------------- wgmma body

constexpr int WG_BQ = 64;        // query rows a block: its consumer warpgroup's
constexpr int WG_THREADS = 256;  // the consumer warpgroup, then the producer warpgroup
static_assert(BK == wg::BOX, "a kv tile is one box of rows");

// stages of the k/v ring: 3 at DP = 64, 2 at DP = 128
__host__ __device__ constexpr int wg_stages(int DP) { return DP == 64 ? 3 : 2; }

// dynamic shared memory: 1024 bytes of alignment slack, two q buffers,
// the k and v rings, the barriers (full and empty a q buffer, then a
// stage) and the kv segment ids a stage
__host__ __device__ constexpr int wg_smem_bytes(int DP) {
  return 1024 + (2 + 2 * wg_stages(DP)) * (DP / wg::BOX) * (int)wg::BOX_BYTES +
         8 * (4 + 2 * wg_stages(DP)) + 4 * BK * wg_stages(DP);
}

// blocks an SM: what the shared memory holds
__host__ __device__ constexpr int wg_blocks(int DP) { return DP == 64 ? 3 : 2; }
static_assert(wg_blocks(64) * (wg_smem_bytes(64) + 1024) <= 233472, "DP 64 fits");
static_assert(wg_blocks(128) * (wg_smem_bytes(128) + 1024) <= 233472, "DP 128 fits");

// Registers a thread: the kernel's count at entry (what __launch_bounds__
// leaves a thread), then the producer warpgroup gives all but
// WG_PRODUCER_REGS to the consumers.
__host__ __device__ constexpr int wg_entry_regs(int DP) {
  return (65536 / (WG_THREADS * wg_blocks(DP)) > 255 ? 255 : 65536 / (WG_THREADS * wg_blocks(DP))) &
         ~7;
}
constexpr int WG_PRODUCER_REGS = 32;
__host__ __device__ constexpr int wg_consumer_regs(int DP) {
  return ((WG_THREADS * wg_entry_regs(DP) - 128 * WG_PRODUCER_REGS) / 128 > 240
              ? 240
              : (WG_THREADS * wg_entry_regs(DP) - 128 * WG_PRODUCER_REGS) / 128) &
         ~7;
}

template <typename T, int DP, bool SEG>
__global__ void __launch_bounds__(WG_THREADS, wg_blocks(DP)) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,  // q as (D, Sq, B * H)
    const __grid_constant__ CUtensorMap k_map,  // k as (D, Skv, B * H)
    const __grid_constant__ CUtensorMap v_map,  // v as (D, Skv, B * H)
    const __grid_constant__ CUtensorMap o_map,  // out as (D, Sq, B * H)
    const int* __restrict__ qseg, const int* __restrict__ kseg, float* __restrict__ lse,
    int B, int H, int Sq, int Skv, int D, int causal, int window, float scale) {
  constexpr int NB = DP / wg::BOX;                 // 64-column boxes a tile row
  constexpr int STAGES = wg_stages(DP);
  constexpr uint32_t TILE = NB * wg::BOX_BYTES;    // bytes of a q, k or v tile
  constexpr int KC = DP / 16;                      // k16 steps of Q.K^T
  constexpr int NT = BK / 8;                       // n8 tiles of a score row
  constexpr int DT = DP / 8;                       // n8 tiles (16-byte chunks) of an output row
  const int off = Skv - Sq;
  const int nq = (Sq + WG_BQ - 1) / WG_BQ;
  const int ntiles = B * H * nq;
  const int nk = (Skv + BK - 1) / BK;
  const int tid = threadIdx.x;

  extern __shared__ unsigned char wsmem[];
  const uint32_t raw = tile::smem_addr(wsmem);
  const uint32_t base = (raw + 1023) & ~1023u;  // the swizzle works on 1024-byte groups
  unsigned char* gbase = wsmem + (base - raw);
  const uint32_t q_s = base;                       // 2 tiles
  const uint32_t k_s = q_s + 2 * TILE;             // STAGES tiles
  const uint32_t v_s = k_s + STAGES * TILE;        // STAGES tiles
  const uint32_t bars = v_s + STAGES * TILE;
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (2 + qb); };
  auto full = [&](int st) { return bars + 8 * (4 + st); };
  auto empty = [&](int st) { return bars + 8 * (4 + STAGES + st); };
  int* kseg_s = reinterpret_cast<int*>(gbase + (bars - base) + 8 * (4 + 2 * STAGES));

  // Tile `tile` of the q axis: the launch order of a (H, B, nq) grid, the
  // q tiles that see the most kv tiles first. The kv tiles it runs
  // (causal and window skips) form one range [lo, hi], empty (lo > hi)
  // only if no row of the tile has a key at or before its position; such
  // a tile (causal, Sq > Skv) walks every kv tile instead, so its rows
  // end at mean(v) over all Skv keys and the sentinel, as the twin's.
  auto decode = [&](int tile, int& bh, int& q_start, int& lo, int& hi) {
    bh = tile % (B * H);
    q_start = (nq - 1 - tile / (B * H)) * WG_BQ;
    const int R = min(WG_BQ, Sq - q_start);
    lo = nk;
    hi = -1;
    for (int ik = 0; ik < nk; ++ik) {
      if (tile::tile_runs(q_start, R, ik * BK, off, causal, window)) {
        lo = min(lo, ik);
        hi = ik;
      }
    }
    if (causal && q_start + off < 0) {  // a row before the first key
      lo = 0;
      hi = nk - 1;
    }
  };

  // The n-th tile of this block: rounds of gridDim.x tiles, every other
  // round taken in reverse, so each block's sum of heavy and light tiles
  // comes out about even (past ntiles: no more tiles).
  auto next_tile = [&](int n) {
    return n * (int)gridDim.x + ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };

  if (tid == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      wg::mbar_init(q_full(qb), 1);
      wg::mbar_init(q_empty(qb), 128);             // every consumer thread
    }
    for (int st = 0; st < STAGES; ++st) {
      wg::mbar_init(full(st), 32);                 // every lane of the producer warp
      wg::mbar_init(empty(st), 128);               // every consumer thread
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so the compiler knows it is uniform:
  // otherwise the loops around wgmma look divergent to ptxas, and it
  // waits for each wgmma right after its issue
  const int wgi = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wgi == 1) {
    // ---- producer: one warp issues the TMA loads, the others leave
    wg::setmaxnreg_dec<WG_PRODUCER_REGS>();
    if ((tid & 127) >= 32) return;
    const int lane = tid & 31;
    if (lane == 0) {
      wg::tma_prefetch_map(&q_map);
      wg::tma_prefetch_map(&k_map);
      wg::tma_prefetch_map(&v_map);
    }
    int st = 0, ph = 0;  // the k/v ring: stage and phase
    for (int n = 0, tile = next_tile(0); tile < ntiles; tile = next_tile(++n)) {
      int bh, q_start, lo, hi;
      decode(tile, bh, q_start, lo, hi);
      // the q tile into buffer n & 1 once the tile before last has left it
      const int qb = n & 1;
      wg::mbar_wait(q_empty(qb), ((n >> 1) & 1) ^ 1);  // the first round finds it free
      if (lane == 0) {
        wg::mbar_arrive_expect_tx(q_full(qb), TILE);
        for (int c = 0; c < NB; ++c) {
          wg::tma_load_3d(q_s + qb * TILE + c * wg::BOX_BYTES, &q_map, q_full(qb), c * wg::BOX,
                          q_start, bh);
        }
      }
      for (int ik = lo; ik <= hi; ++ik) {
        wg::mbar_wait(empty(st), ph ^ 1);  // the first round finds it free
        const int k0 = ik * BK;
        if (SEG) {  // the stage's kv segment ids by plain loads, before this lane arrives
          const int* ks = kseg + (size_t)(bh / H) * Skv;
          for (int j = lane; j < BK; j += 32) {
            if (k0 + j < Skv) kseg_s[st * BK + j] = ks[k0 + j];
          }
        }
        if (lane == 0) {
          wg::mbar_arrive_expect_tx(full(st), 2 * TILE);
          for (int c = 0; c < NB; ++c) {
            wg::tma_load_3d(k_s + st * TILE + c * wg::BOX_BYTES, &k_map, full(st), c * wg::BOX, k0, bh);
            wg::tma_load_3d(v_s + st * TILE + c * wg::BOX_BYTES, &v_map, full(st), c * wg::BOX, k0, bh);
          }
        } else {
          wg::mbar_arrive(full(st));
        }
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroup: the 64 query rows of each tile
    wg::setmaxnreg_inc<wg_consumer_regs(DP)>();
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

    float o[DT * 4];
    float s[NT * 4];
    uint32_t pa[NT / 2][4];  // P of the previous tile, the A operand of its P.V
    int st = 0, ph = 0;      // the k/v ring, walked as the producer walks it
    auto advance = [&]() {
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    };
    // P.V of the tile in stage sv: V MN-major (keys x D) with the transpose bit
    auto issue_pv = [&](int sv) {
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        wg::mma_rs<T, DP>(o, pa[kc], wg::desc_mn_major(v_s + sv * TILE + kc * 16 * 128), 1);
      }
      wg::commit();
    };
    auto pin = [&]() {  // every register operand, before wgmma.fence
      wg::fence_operands(o);
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) wg::fence_operands(pa[kc]);
    };
    // P rounded to T: the A operand of the tile's P.V, in the m16n8k16 A
    // layout straight from the accumulators
    auto pack_p = [&]() {
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kc][i] = tile::pack2<T>(s[8 * kc + 2 * i], s[8 * kc + 2 * i + 1]);
      }
    };

    for (int n = 0, tile = next_tile(0); tile < ntiles; tile = next_tile(++n)) {
      int bh, q_start, lo, hi;
      decode(tile, bh, q_start, lo, hi);
      const int b = bh / H;
      const int R = min(WG_BQ, Sq - q_start);  // valid rows of the tile
      int qs0 = 0, qs1 = 0;
      if (SEG) {
        if (r0 < R) qs0 = qseg[(size_t)b * Sq + q_start + r0];
        if (r0 + 8 < R) qs1 = qseg[(size_t)b * Sq + q_start + r0 + 8];
      }
      const int qb = n & 1;
      const uint32_t qt = q_s + qb * TILE;
#pragma unroll
      for (int i = 0; i < DT * 4; ++i) o[i] = 0.f;
      float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows r0, r0 + 8
      float l0 = 0.f, l1 = 0.f;          // this lane's part of the running sum

      // S = Q.K^T of the tile in stage sk: D/16 k16 steps, both operands
      // K-major in shared memory
      auto issue_s = [&](int sk) {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
          const uint32_t step = (kk >> 2) * wg::BOX_BYTES + (kk & 3) * 32;
          wg::mma_ss_n64<T>(s, wg::desc_k_major(qt + step),
                            wg::desc_k_major(k_s + sk * TILE + step), kk == 0);
        }
        wg::commit();
      };
      // Scale, masks and the online softmax of tile ik's scores in s (in
      // stage sk): s becomes p, m and l move on; alpha of rows r0, r0 + 8.
      auto softmax = [&](int ik, int sk, float& a0, float& a1) {
        // scale in f32, then the masks: -1e30 where masked, -inf past Skv
        const int k_start = ik * BK;
        const int C = min(BK, Skv - k_start);
        const bool whole = !SEG && C == BK &&
                           tile::tile_whole(q_start, R, k_start, off, causal, window);
        if (whole) {
#pragma unroll
          for (int i = 0; i < NT * 4; ++i) s[i] *= scale;
        } else {
          // `tile::visible` with positions counted from the tile's first
          // key: this thread's rows r0 and r0 + 8 sit at qp0 and qp0 + 8,
          // its keys at 8 j + 2 t and + 1; by selects, so no branch splits
          // the warpgroup
          const int qp0 = q_start + r0 + off - k_start;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int k0 = 8 * j + 2 * t;
            int2 ks = make_int2(0, 0);
            if (SEG) ks = *reinterpret_cast<const int2*>(kseg_s + sk * BK + k0);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = k0 + (e & 1);
              const int qp = qp0 + ((e >> 1) << 3);
              bool seen = true;
              if (causal) seen = kj <= qp && (window <= 0 || qp - kj < window);
              if (SEG) seen = seen && ((e & 1) ? ks.y : ks.x) == ((e >> 1) ? qs1 : qs0);
              // -inf past Skv: exp gives exactly 0 there, even on a dead row
              const float x = s[4 * j + e] * scale;
              s[4 * j + e] = kj >= C ? __uint_as_float(0xff800000u) : seen ? x : NEG_INF;
            }
          }
        }
        // online softmax over the quad that shares a row
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int w = 1; w < 4; w <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
        }
        a0 = wg::exp(m0 - mx0);
        a1 = wg::exp(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          s[4 * j] = wg::exp(s[4 * j] - mx0);
          s[4 * j + 1] = wg::exp(s[4 * j + 1] - mx0);
          s[4 * j + 2] = wg::exp(s[4 * j + 2] - mx1);
          s[4 * j + 3] = wg::exp(s[4 * j + 3] - mx1);
          sum0 += s[4 * j] + s[4 * j + 1];
          sum1 += s[4 * j + 2] + s[4 * j + 3];
        }
        l0 = l0 * a0 + sum0;
        l1 = l1 * a1 + sum1;
        // done here, not after the caller's next wait_group: the compiler
        // would otherwise sink the exponentials past it, out of the overlap
        wg::fence_operands(s);
        asm volatile("" : "+f"(l0), "+f"(l1), "+f"(a0), "+f"(a1)::"memory");
      };

      wg::mbar_wait(q_full(qb), (n >> 1) & 1);
      if (lo <= hi) {
        float a0, a1;
        int prev = st;  // the stage of the tile whose P.V is next
        wg::mbar_wait(full(st), ph);
        wg::fence();
        issue_s(st);
        wg::wait<0>();
        wg::fence_operands(s);
        softmax(lo, st, a0, a1);  // O is 0: nothing to rescale
        pack_p();
        advance();
        // Tile ik's S = Q.K^T is issued with tile ik - 1's P.V behind it,
        // so ik's softmax runs while the tensor cores add ik - 1 to O
        for (int ik = lo + 1; ik <= hi; ++ik) {
          wg::mbar_wait(full(st), ph);
          pin();
          wg::fence();
          issue_s(st);
          issue_pv(prev);
          wg::wait<1>();  // S has landed; P.V may still run
          wg::fence_operands(s);
          softmax(ik, st, a0, a1);
          wg::wait<0>();  // tile ik - 1 is in O, and its stage is free
          wg::fence_operands(o);
          wg::mbar_arrive(empty(prev));
#pragma unroll
          for (int d = 0; d < DT; ++d) {
            o[4 * d] *= a0;
            o[4 * d + 1] *= a0;
            o[4 * d + 2] *= a1;
            o[4 * d + 3] *= a1;
          }
          pack_p();
          prev = st;
          advance();
        }
        // the last tile's P.V
        pin();
        wg::fence();
        issue_pv(prev);
        wg::wait<0>();
        wg::fence_operands(o);
        wg::mbar_arrive(empty(prev));
      }

      // epilogue: out = acc / l in T, staged in the q tile (no read of it
      // is left once the warpgroup meets here) in the layout a TMA box
      // has, then stored by one TMA store a 64-column box (rows past Sq
      // and columns past D are not written); lse in f32
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, w);
        l1 += __shfl_xor_sync(0xffffffffu, l1, w);
      }
      const float d0 = l0 == 0.f ? 1.f : l0;
      const float d1 = l1 == 0.f ? 1.f : l1;
      unsigned char* ot = gbase + (qt - base);
      auto chunk = [&](int r, int c) {  // 16-byte chunk c of row r, as TMA swizzles it
        return ot + (c >> 3) * wg::BOX_BYTES + r * 128 + (((c & 7) ^ (r & 7)) << 4);
      };
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        *reinterpret_cast<uint32_t*>(chunk(r0, d) + 4 * t) =
            tile::pack2<T>(wg::div(o[4 * d], d0), wg::div(o[4 * d + 1], d0));
        *reinterpret_cast<uint32_t*>(chunk(r0 + 8, d) + 4 * t) =
            tile::pack2<T>(wg::div(o[4 * d + 2], d1), wg::div(o[4 * d + 3], d1));
      }
      if (t == 0) {
        if (r0 < R) lse[(size_t)bh * Sq + q_start + r0] = m0 + logf(d0);
        if (r0 + 8 < R) lse[(size_t)bh * Sq + q_start + r0 + 8] = m1 + logf(d1);
      }
      wg::fence_proxy_async();  // the staged tile, visible to the TMA store
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (tid == 0) {
        for (int c = 0; c < NB; ++c) {
          wg::tma_store_3d(&o_map, qt + c * wg::BOX_BYTES, c * wg::BOX, q_start, bh);
        }
        wg::bulk_commit();
        wg::bulk_wait_read();  // the store has read the buffer
      }
      // the buffer may take the tile after next: this thread's reads and
      // writes of it come before the TMA's write
      wg::fence_proxy_async();
      wg::mbar_arrive(q_empty(qb));
    }
    if (tid == 0) wg::bulk_wait();  // the last stores are done before the block is
  }
}

template <typename T, int DP, bool SEG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* qseg, const int* kseg, void* out, float* lse,
                         int B, int H, int Sq, int Skv, int D, int causal,
                         int window, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_wgmma_kernel<T, DP, SEG>;
  const int smem = wg_smem_bytes(DP);
  static std::atomic<int> sms[64];
  int nsm = 0;
  cudaError_t err = wg::prepare_once(sms, kern, smem, WG_THREADS,
                                     128 * (WG_PRODUCER_REGS + wg_consumer_regs(DP)), &nsm);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  if (!wg::tile_map<T>(&maps[0], q, D, Sq, B * H) || !wg::tile_map<T>(&maps[1], k, D, Skv, B * H) ||
      !wg::tile_map<T>(&maps[2], v, D, Skv, B * H) || !wg::tile_map<T>(&maps[3], out, D, Sq, B * H)) {
    return cudaErrorInvalidValue;
  }
  // persistent blocks: as many as the SMs hold at once
  const long tiles = (long)B * H * ((Sq + WG_BQ - 1) / WG_BQ);
  const int grid = (int)std::min<long>(tiles, (long)nsm * wg_blocks(DP));
  kern<<<grid, WG_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], qseg, kseg,
                                           lse, B, H, Sq, Skv, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma_any(bool seg, const void* q, const void* k, const void* v,
                             const int* qseg, const int* kseg, void* out, float* lse,
                             int B, int H, int Sq, int Skv, int D, int causal,
                             int window, float scale, cudaStream_t stream) {
#define KFT_ARGS q, k, v, qseg, kseg, out, lse, B, H, Sq, Skv, D, causal, window, scale, stream
  if (D <= 64) return seg ? launch_wgmma<T, 64, true>(KFT_ARGS) : launch_wgmma<T, 64, false>(KFT_ARGS);
  return seg ? launch_wgmma<T, 128, true>(KFT_ARGS) : launch_wgmma<T, 128, false>(KFT_ARGS);
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
    cudaError_t err = dtype == BF16 ? launch_wgmma_any<__nv_bfloat16>(seg, KFT_ARGS)
                                    : launch_wgmma_any<__half>(seg, KFT_ARGS);
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
