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
// * f32 (and any other D): `flash_fwd_kernel`, scalar f32 FMAs out of
//   shared memory. A tensor-core f32 product would be TF32, about three
//   decimal digits, and would break the f32 parity gates.
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

#include "tile_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per kv tile
constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <typename T, bool SEG>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q,       // (B, H, Sq, D)
    const T* __restrict__ k,       // (B, H, Skv, D)
    const T* __restrict__ v,       // (B, H, Skv, D)
    const int* __restrict__ qseg,  // (B, Sq) when SEG
    const int* __restrict__ kseg,  // (B, Skv) when SEG
    T* __restrict__ out,           // (B, H, Sq, D)
    float* __restrict__ lse,       // (B, H, Sq)
    int H, int Sq, int Skv, int D, int causal, int window, float scale) {
  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_start = iq * BQ;
  const int R = min(BQ, Sq - q_start);
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int KS = D + 1;  // padded K row: neighbouring keys hit distinct banks

  extern __shared__ float smem[];
  float* q_s = smem;              // BQ x D
  float* acc = q_s + BQ * D;      // BQ x D
  float* k_s = acc + BQ * D;      // BK x KS
  float* v_s = k_s + BK * KS;     // BK x D
  float* s_s = v_s + BK * D;      // BQ x BK
  float* m_s = s_s + BQ * BK;     // BQ
  float* l_s = m_s + BQ;          // BQ
  float* a_s = l_s + BQ;          // BQ
  int* qseg_s = reinterpret_cast<int*>(a_s + BQ);  // BQ
  int* kseg_s = qseg_s + BQ;                        // BK

  const size_t bh = (size_t)b * H + h;
  const T* qb = q + (bh * Sq + q_start) * D;
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  for (int e = tid; e < R * D; e += THREADS) {
    q_s[e] = to_f32(qb[e]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    if (SEG) qseg_s[r] = qseg[(size_t)b * Sq + q_start + r];
  }

  const int nk = (Skv + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_start = ik * BK;
    bool run = true;
    if (causal) run = k_start <= q_start + R - 1 + off;
    if (window > 0) run = run && (k_start + BK - 1 >= q_start + off - window + 1);
    if (!run) continue;  // block-uniform
    const int C = min(BK, Skv - k_start);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D;
      const int d = e - j * D;
      const bool in = j < C;
      k_s[j * KS + d] = in ? to_f32(kb[(size_t)k_start * D + e]) : 0.f;
      v_s[e] = in ? to_f32(vb[(size_t)k_start * D + e]) : 0.f;
    }
    if (SEG) {
      for (int j = tid; j < BK; j += THREADS) {
        kseg_s[j] = j < C ? kseg[(size_t)b * Skv + k_start + j] : 0;
      }
    }
    __syncthreads();
    for (int e = tid; e < R * BK; e += THREADS) {
      const int r = e / BK;
      const int j = e - r * BK;
      float sc = NEG_INF;
      if (j < C) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + j * KS;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = dot * scale;
        bool keep = true;
        if (causal) {
          const int qpos = q_start + r + off;
          const int kpos = k_start + j;
          keep = kpos <= qpos;
          if (window > 0) keep = keep && (qpos - kpos < window);
        }
        if (SEG) keep = keep && (qseg_s[r] == kseg_s[j]);
        if (!keep) sc = NEG_INF;
      }
      s_s[e] = sc;
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      float* sr = s_s + r * BK;
      float mx = NEG_INF;
      for (int j = 0; j < C; ++j) mx = fmaxf(mx, sr[j]);
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float p = j < C ? expf(sr[j] - m_cur) : 0.f;
        sum += p;
        sr[j] = to_f32(from_f32<T>(p));  // p.astype(v.dtype) for p.v
      }
      const float alpha = expf(m_prev - m_cur);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_cur;
      a_s[r] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < R * D; e += THREADS) {
      const int r = e / D;
      const int d = e - r * D;
      const float* pr = s_s + r * BK;
      float o = 0.f;
      for (int j = 0; j < BK; ++j) o = fmaf(pr[j], v_s[j * D + d], o);
      acc[e] = acc[e] * a_s[r] + o;
    }
  }
  __syncthreads();
  T* ob = out + (bh * Sq + q_start) * D;
  for (int e = tid; e < R * D; e += THREADS) {
    const float l = l_s[e / D];
    ob[e] = from_f32<T>(acc[e] / (l == 0.f ? 1.f : l));
  }
  for (int r = tid; r < R; r += THREADS) {
    const float l = l_s[r];
    lse[bh * Sq + q_start + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T, bool SEG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qseg, const int* kseg, void* out, float* lse,
                   int B, int H, int Sq, int Skv, int D, int causal,
                   int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  const size_t smem = sizeof(float) *
      (2 * BQ * D + BK * (D + 1) + BK * D + BQ * BK + 3 * BQ) +
      sizeof(int) * (BQ + BK);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = flash_fwd_kernel<T, SEG>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qseg, kseg, static_cast<T*>(out), lse, H, Sq,
      Skv, D, causal, window, scale);
  return cudaGetLastError();
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
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32) err = seg ? launch<float, true>(KFT_ARGS) : launch<float, false>(KFT_ARGS);
  if (dtype == BF16) {
    err = seg ? launch<__nv_bfloat16, true>(KFT_ARGS) : launch<__nv_bfloat16, false>(KFT_ARGS);
  }
  if (dtype == F16) err = seg ? launch<__half, true>(KFT_ARGS) : launch<__half, false>(KFT_ARGS);
#undef KFT_ARGS
  return (int)err;
}

extern "C" const char* kft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
