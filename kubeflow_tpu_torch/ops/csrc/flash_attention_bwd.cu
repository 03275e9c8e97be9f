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
//     What bounds it: bytes (15 us at the training shape, above). The
//     scalar body re-read K and V from shared memory in f32 once per
//     query row and per output element; here each K and V element is read
//     from device memory once per q tile, the products run on the tensor
//     cores, and copies overlap the math. Shared memory: 49 KB at
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
// * f32 (and any other D): `flash_bwd_dq_kernel` and
//   `flash_bwd_dkv_kernel`, scalar f32 FMAs out of shared memory: a
//   tensor-core f32 product would be TF32, about three decimal digits,
//   and would break the f32 parity gates.
//
// Scalar tiles: 64 query rows by 64 keys, 256 threads. Shared memory
// holds the tiles in f32 (rows of K and V padded to D + 1 floats so that
// the 32 lanes of a warp, which walk 32 keys, hit 32 banks):
//   dq:    q, dO, dq acc (3 x 64 x D) + K, V (2 x 64 x (D + 1)) + ds (64 x 64)
//          = 97 KB at D = 64, 178 KB at D = 128;
//   dk/dv: K, V (2 x 64 x (D + 1)) + dk, dv acc (2 x 64 x D) + q, dO
//          (2 x 64 x D) + p, ds (2 x 64 x 64) = 130 KB at D = 64, 226 KB
//          at D = 128;
// both under the 227 KB a block may have (dynamic shared memory, set per
// launch with cudaFuncSetAttribute). f32, bf16 and f16 inputs, D <= 128.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int THREADS = 256;
constexpr size_t MAX_SMEM = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

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

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int rows, int valid, int D, int tid) {
  for (int e = tid; e < rows * D; e += THREADS) {
    const int j = e / D;
    const int d = e - j * D;
    dst[j * ld + d] = j < valid ? to_f32(src[e]) : 0.f;
  }
}

template <typename T, bool SEG>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout,          // (B, H, Sq, D)
    const float* __restrict__ lse,       // (B, H, Sq)
    const float* __restrict__ delta,     // (B, H, Sq)
    const int* __restrict__ qseg, const int* __restrict__ kseg,
    float* __restrict__ dq,              // (B, H, Sq, D)
    int H, int Sq, int Skv, int D, int causal, int window, float scale) {
  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_start = iq * BQ;
  const int R = min(BQ, Sq - q_start);
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int KS = D + 1;

  extern __shared__ float smem[];
  float* q_s = smem;               // BQ x D
  float* do_s = q_s + BQ * D;      // BQ x D
  float* acc = do_s + BQ * D;      // BQ x D
  float* k_s = acc + BQ * D;       // BK x KS
  float* v_s = k_s + BK * KS;      // BK x KS
  float* ds_s = v_s + BK * KS;     // BQ x BK
  float* lse_s = ds_s + BQ * BK;   // BQ
  float* dl_s = lse_s + BQ;        // BQ
  int* qseg_s = reinterpret_cast<int*>(dl_s + BQ);  // BQ
  int* kseg_s = qseg_s + BQ;                        // BK

  const size_t bh = (size_t)b * H + h;
  const size_t row0 = bh * Sq + q_start;
  load_rows(q_s, D, q + row0 * D, R, R, D, tid);
  load_rows(do_s, D, dout + row0 * D, R, R, D, tid);
  for (int e = tid; e < R * D; e += THREADS) acc[e] = 0.f;
  for (int r = tid; r < R; r += THREADS) {
    lse_s[r] = lse[row0 + r];
    dl_s[r] = delta[row0 + r];
    if (SEG) qseg_s[r] = qseg[(size_t)b * Sq + q_start + r];
  }
  const T* kb = k + bh * Skv * D;
  const T* vb = v + bh * Skv * D;

  const int nk = (Skv + BK - 1) / BK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k_start = ik * BK;
    if (!tile_runs(q_start, R, k_start, off, causal, window)) continue;  // block-uniform
    const int C = min(BK, Skv - k_start);
    __syncthreads();  // the previous tile's readers are done
    load_rows(k_s, KS, kb + (size_t)k_start * D, BK, C, D, tid);
    load_rows(v_s, KS, vb + (size_t)k_start * D, BK, C, D, tid);
    if (SEG) {
      for (int j = tid; j < BK; j += THREADS) {
        kseg_s[j] = j < C ? kseg[(size_t)b * Skv + k_start + j] : 0;
      }
    }
    __syncthreads();
    for (int e = tid; e < R * BK; e += THREADS) {
      const int r = e / BK;
      const int j = e - r * BK;
      float ds = 0.f;
      if (j < C && lse_s[r] > NEG_INF / 2 &&
          visible<SEG>(q_start + r + off, k_start + j, causal, window,
                       SEG ? qseg_s[r] : 0, SEG ? kseg_s[j] : 0)) {
        const float* qr = q_s + r * D;
        const float* dr = do_s + r * D;
        const float* kr = k_s + j * KS;
        const float* vr = v_s + j * KS;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(dr[d], vr[d], dp);
        }
        const float p = expf(s * scale - lse_s[r]);
        ds = round_to<T>(p * (dp - dl_s[r]) * scale);
      }
      ds_s[e] = ds;
    }
    __syncthreads();
    for (int e = tid; e < R * D; e += THREADS) {
      const int r = e / D;
      const int d = e - r * D;
      const float* dsr = ds_s + r * BK;
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) sum = fmaf(dsr[j], k_s[j * KS + d], sum);
      acc[e] += sum;
    }
  }
  __syncthreads();
  float* dqb = dq + row0 * D;
  for (int e = tid; e < R * D; e += THREADS) dqb[e] = acc[e];
}

template <typename T, bool SEG>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qseg,
    const int* __restrict__ kseg,
    float* __restrict__ dk, float* __restrict__ dv,  // (B, H, Skv, D)
    int H, int Sq, int Skv, int D, int causal, int window, float scale) {
  const int ik = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k_start = ik * BK;
  const int C = min(BK, Skv - k_start);
  const int off = Skv - Sq;
  const int tid = threadIdx.x;
  const int KS = D + 1;

  extern __shared__ float smem[];
  float* k_s = smem;               // BK x KS
  float* v_s = k_s + BK * KS;      // BK x KS
  float* dk_acc = v_s + BK * KS;   // BK x D
  float* dv_acc = dk_acc + BK * D; // BK x D
  float* q_s = dv_acc + BK * D;    // BQ x D
  float* do_s = q_s + BQ * D;      // BQ x D
  float* p_s = do_s + BQ * D;      // BQ x BK, p rounded to dO's dtype
  float* ds_s = p_s + BQ * BK;     // BQ x BK
  float* lse_s = ds_s + BQ * BK;   // BQ
  float* dl_s = lse_s + BQ;        // BQ
  int* qseg_s = reinterpret_cast<int*>(dl_s + BQ);  // BQ
  int* kseg_s = qseg_s + BQ;                        // BK

  const size_t bh = (size_t)b * H + h;
  const size_t krow0 = bh * Skv + k_start;
  load_rows(k_s, KS, k + krow0 * D, BK, C, D, tid);
  load_rows(v_s, KS, v + krow0 * D, BK, C, D, tid);
  for (int e = tid; e < BK * D; e += THREADS) {
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }
  if (SEG) {
    for (int j = tid; j < BK; j += THREADS) {
      kseg_s[j] = j < C ? kseg[(size_t)b * Skv + k_start + j] : 0;
    }
  }

  const int nq = (Sq + BQ - 1) / BQ;
  for (int iq = 0; iq < nq; ++iq) {
    const int q_start = iq * BQ;
    const int R = min(BQ, Sq - q_start);
    if (!tile_runs(q_start, R, k_start, off, causal, window)) continue;  // block-uniform
    const size_t row0 = bh * Sq + q_start;
    __syncthreads();  // the previous tile's readers are done
    load_rows(q_s, D, q + row0 * D, R, R, D, tid);
    load_rows(do_s, D, dout + row0 * D, R, R, D, tid);
    for (int r = tid; r < R; r += THREADS) {
      lse_s[r] = lse[row0 + r];
      dl_s[r] = delta[row0 + r];
      if (SEG) qseg_s[r] = qseg[(size_t)b * Sq + q_start + r];
    }
    __syncthreads();
    for (int e = tid; e < R * BK; e += THREADS) {
      const int r = e / BK;
      const int j = e - r * BK;
      float p = 0.f, ds = 0.f;
      if (j < C && lse_s[r] > NEG_INF / 2 &&
          visible<SEG>(q_start + r + off, k_start + j, causal, window,
                       SEG ? qseg_s[r] : 0, SEG ? kseg_s[j] : 0)) {
        const float* qr = q_s + r * D;
        const float* dr = do_s + r * D;
        const float* kr = k_s + j * KS;
        const float* vr = v_s + j * KS;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(qr[d], kr[d], s);
          dp = fmaf(dr[d], vr[d], dp);
        }
        p = expf(s * scale - lse_s[r]);
        ds = round_to<T>(p * (dp - dl_s[r]) * scale);
      }
      p_s[e] = round_to<T>(p);  // p.astype(do.dtype) for dv
      ds_s[e] = ds;
    }
    __syncthreads();
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D;
      const int d = e - j * D;
      float sv = 0.f, sk = 0.f;
      for (int r = 0; r < R; ++r) {
        sv = fmaf(p_s[r * BK + j], do_s[r * D + d], sv);
        sk = fmaf(ds_s[r * BK + j], q_s[r * D + d], sk);
      }
      dv_acc[e] += sv;
      dk_acc[e] += sk;
    }
  }
  __syncthreads();
  float* dkb = dk + krow0 * D;
  float* dvb = dv + krow0 * D;
  for (int e = tid; e < C * D; e += THREADS) {
    dkb[e] = dk_acc[e];
    dvb[e] = dv_acc[e];
  }
}

size_t dq_smem(int D) {
  return sizeof(float) * (3 * BQ * D + 2 * BK * (D + 1) + BQ * BK + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}

size_t dkv_smem(int D) {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BK * D + 2 * BQ * D +
                          2 * BQ * BK + 2 * BQ) +
         sizeof(int) * (BQ + BK);
}

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

template <typename T, bool SEG>
cudaError_t launch_dq(const Args& a, float* dq) {
  auto kern = flash_bwd_dq_kernel<T, SEG>;
  const size_t smem = dq_smem(a.D);
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, dq, a.H, a.Sq, a.Skv, a.D, a.causal, a.window,
      a.scale);
  return cudaGetLastError();
}

template <typename T, bool SEG>
cudaError_t launch_dkv(const Args& a, float* dk, float* dv) {
  auto kern = flash_bwd_dkv_kernel<T, SEG>;
  const size_t smem = dkv_smem(a.D);
  cudaError_t err = prepare(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + BK - 1) / BK, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.qseg, a.kseg, dk, dv, a.H, a.Sq, a.Skv, a.D, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
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
  const bool seg = a.qseg != nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32) err = seg ? launch_dq<float, true>(a, out) : launch_dq<float, false>(a, out);
  if (dtype == BF16) {
    err = seg ? launch_dq<__nv_bfloat16, true>(a, out) : launch_dq<__nv_bfloat16, false>(a, out);
  }
  if (dtype == F16) err = seg ? launch_dq<__half, true>(a, out) : launch_dq<__half, false>(a, out);
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
  const bool seg = a.qseg != nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == F32) {
    err = seg ? launch_dkv<float, true>(a, gk, gv) : launch_dkv<float, false>(a, gk, gv);
  }
  if (dtype == BF16) {
    err = seg ? launch_dkv<__nv_bfloat16, true>(a, gk, gv)
              : launch_dkv<__nv_bfloat16, false>(a, gk, gv);
  }
  if (dtype == F16) {
    err = seg ? launch_dkv<__half, true>(a, gk, gv) : launch_dkv<__half, false>(a, gk, gv);
  }
  return (int)err;
}

#undef KFT_BWD_ARGS
#undef KFT_BWD_DIMS

extern "C" const char* kft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
