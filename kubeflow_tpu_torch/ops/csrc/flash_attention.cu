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
// lse. Causal at D = 64 in bf16 that is about S / 4 flops per byte, below
// the ~295 flop/byte ridge for S up to about 1200, so at the model's
// shapes (S = 128..512) the bound is memory bandwidth. This first version
// runs the products as scalar f32 FMAs out of shared memory and is far
// from either limit. Tensor cores (mma.sync / wgmma with TMA staging) are
// the next step; the structure below (q tile resident, k/v tiles
// streamed, scores never written to device memory) is the one such a
// kernel keeps.
//
// TPU grid -> CUDA blocks: the Pallas grid (B, H, q blocks, kv blocks)
// ran the kv axis sequentially ("arbitrary") with the accumulator in VMEM
// scratch. Here one thread block owns one (q tile, head, batch) --
// blockIdx = (iq, h, b) -- and loops over kv tiles; the loop replaces the
// sequential grid axis. Tiles wholly in the causal future or wholly
// before the window are skipped, as `_attn_kernel` does (lines 74-78).
// The tile mask is `_tile_mask` (line 206) in `_full_mask`'s bottom-right
// alignment (query i sits at position i + Skv - Sq).
//
// Numerics follow `_attn_kernel`: scores in f32, masked entries set to
// -1e30, p = exp(s - m) with p rounded to the input dtype for the p.v
// product (the Pallas `p.astype(v.dtype)`), l summed from the unrounded
// p, rows with l == 0 written as zeros. Keys past Skv in a ragged last
// tile add exactly 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

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

}  // namespace

// dtype codes shared with ops/flash_attention.py
enum { F32 = 0, BF16 = 1, F16 = 2 };

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
