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
// TFLOP/s bf16 tensor-core rate. Both are bound by bytes. This first
// version runs every product as scalar f32 FMAs out of shared memory and
// is far from either bound; tensor cores (mma.sync, then wgmma with TMA
// staging) are the next step. The structure below is the one such a
// kernel keeps: the block's own tile stays resident, the other operand's
// tiles stream through, and p / ds never leave shared memory.
//
// TPU grid -> CUDA blocks: the Pallas grids (B, H, q blocks, kv blocks) for
// dq and (B, H, kv blocks, q blocks) for dk/dv ran their last axis in
// order ("arbitrary") with the accumulator in VMEM scratch. Here one
// thread block owns one (q tile, head, batch) for dq and one (kv tile,
// head, batch) for dk/dv -- blockIdx = (tile, h, b) -- and loops over the
// other axis; the loop replaces the sequential grid axis. With this split
// no two blocks write the same gradient row, so neither kernel needs
// atomics and the result is deterministic. Tiles that are wholly in the
// causal future or wholly before the window are skipped with the forward
// kernel's predicate and its bottom-right alignment (query i sits at
// position i + Skv - Sq; for Sq == Skv, as in training, this is
// `_tile_mask` at line 206). Masked, dead and ragged lanes add exactly 0.
//
// Tiles: 64 query rows by 64 keys, 256 threads. Shared memory holds the
// tiles in f32 (rows of K and V padded to D + 1 floats so that the 32
// lanes of a warp, which walk 32 keys, hit 32 banks):
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

// `_tile_mask` for one (query, key) pair, in the bottom-right alignment.
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

// The forward kernel's tile skip: false when no pair of the tile is visible.
__device__ __forceinline__ bool tile_runs(int q_start, int R, int k_start,
                                          int off, int causal, int window) {
  bool run = true;
  if (causal) run = k_start <= q_start + R - 1 + off;
  if (window > 0) run = run && (k_start + BK - 1 >= q_start + off - window + 1);
  return run;
}

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

// dtype codes shared with ops/flash_attention.py
enum { F32 = 0, BF16 = 1, F16 = 2 };

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
