// Paged span attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernel kubeflow_tpu/ops/paged_attention.py
// (`_paged_attn_kernel`, launched by `paged_attention` at line 185): S
// queries per row starting at absolute position pos0[b] attend to the
// row's tokens in a flat (kv_heads, pool_tokens, D) pool, where logical
// token j lives at pool token table[b, j / P] * P + j % P. Causal and
// sliding-window masks come from positions alone; the GQA group is
// folded into the query rows; int8 pools are dequantized with per-token
// f32 scales right after the load.
//
// What bounds it on the H100: decode (S = 1) reads every K/V byte of the
// pages the row owns once and does 4 * D flops per byte pair, far below
// the ~295 flop/byte ridge, so it is bound by memory bandwidth. The
// design keeps the whole online softmax in shared memory and registers:
// each K/V page is read from device memory once per (row, kv head, row
// tile) and nothing but the output is written.
//
// TPU grid -> CUDA blocks: the Pallas grid (B, Hkv, W pages) ran the page
// axis sequentially ("arbitrary") with the accumulator in VMEM scratch.
// Here one thread block owns one (kv head, row, tile of ROW_TILE query
// rows) -- blockIdx = (h, b, tile) -- and walks the row's pages in a loop,
// which takes the place of the sequential grid axis. The block reads its
// own table[b, i] and pos0[b]; they replace the scalar-prefetch operands.
// Pages wholly past the span's last query, or wholly before the earliest
// query's window, are skipped exactly as in the Pallas kernel.
//
// Numerics: f32 accumulation; masked lanes add exactly 0 (the hardened
// `where(mask, exp(s - m), 0)`), and a row that saw no key (l == 0)
// writes zeros. Inner products are scalar f32 FMAs from shared memory;
// tensor cores (mma/wgmma) are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the gather path's masked-score fill
constexpr int THREADS = 128;
constexpr int ROW_TILE = 32;  // query rows (GQA group x span) per block
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int window) {
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

template <typename TQ, typename TKV, bool QUANT>
__global__ void __launch_bounds__(THREADS) paged_attn_kernel(
    const TQ* __restrict__ q,          // (B, H, S, D)
    const TKV* __restrict__ k_pool,    // (Hkv, T, D)
    const TKV* __restrict__ v_pool,    // (Hkv, T, D)
    const float* __restrict__ k_scale, // (Hkv, T) when QUANT
    const float* __restrict__ v_scale, // (Hkv, T) when QUANT
    const int* __restrict__ table,     // (B, W)
    const int* __restrict__ pos0,      // (B,)
    TQ* __restrict__ out,              // (B, H, S, D)
    int H, int Hkv, int S, int D, int T, int P, int W, int window,
    float mult) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int GS = G * S;
  const int r0 = blockIdx.z * ROW_TILE;
  const int R = min(ROW_TILE, GS - r0);
  const int tid = threadIdx.x;
  const int KS = D + 1;  // padded K row: neighbouring keys hit distinct banks

  extern __shared__ float smem[];
  float* q_s = smem;                  // ROW_TILE x D
  float* acc = q_s + ROW_TILE * D;    // ROW_TILE x D
  float* k_s = acc + ROW_TILE * D;    // P x KS
  float* v_s = k_s + P * KS;          // P x D
  float* s_s = v_s + P * D;           // ROW_TILE x P
  float* m_s = s_s + ROW_TILE * P;    // ROW_TILE
  float* l_s = m_s + ROW_TILE;        // ROW_TILE
  float* a_s = l_s + ROW_TILE;        // ROW_TILE

  // row r of kv head h is query s = r % S of head h * G + r / S; the GS
  // rows of one kv head are contiguous in q and in out
  const size_t row0 = ((size_t)b * H + (size_t)h * G) * S + r0;
  const TQ* q_rows = q + row0 * D;
  TQ* o_rows = out + row0 * D;

  for (int e = tid; e < R * D; e += THREADS) {
    q_s[e] = to_f32(q_rows[e]);
    acc[e] = 0.f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  const int p0 = pos0[b];
  const int n_pages = T / P;
  for (int i = 0; i < W; ++i) {
    const int first = i * P;
    // skip pages wholly past the span's last query and, when windowed,
    // pages wholly before the earliest query's window (block-uniform)
    bool run = first <= p0 + S - 1;
    if (window > 0) run = run && (first + P - 1 >= p0 - window + 1);
    const int page = table[b * W + i];
    if (!run || page < 0 || page >= n_pages) continue;
    __syncthreads();  // the previous page's readers are done with k/v/s
    const size_t tok0 = (size_t)h * T + (size_t)page * P;
    const TKV* kp = k_pool + tok0 * D;
    const TKV* vp = v_pool + tok0 * D;
    for (int e = tid; e < P * D; e += THREADS) {
      const int j = e / D;
      const int d = e - j * D;
      float kv = to_f32(kp[e]);
      float vv = to_f32(vp[e]);
      if (QUANT) {
        kv = kv * k_scale[tok0 + j];
        vv = vv * v_scale[tok0 + j];
      }
      k_s[j * KS + d] = kv;
      v_s[e] = vv;
    }
    __syncthreads();
    for (int e = tid; e < R * P; e += THREADS) {
      const int r = e / P;
      const int j = e - r * P;
      const float* qr = q_s + r * D;
      const float* kr = k_s + j * KS;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      const int qpos = p0 + (r0 + r) % S;
      s_s[e] = visible(first + j, qpos, window) ? dot * mult : NEG_INF;
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      const int qpos = p0 + (r0 + r) % S;
      float* sr = s_s + r * P;
      float mx = NEG_INF;
      for (int j = 0; j < P; ++j) mx = fmaxf(mx, sr[j]);
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < P; ++j) {
        // masked lanes add EXACTLY 0, even when the whole page is masked
        const float p = visible(first + j, qpos, window) ? expf(sr[j] - m_cur) : 0.f;
        sr[j] = p;
        sum += p;
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
      const float* pr = s_s + r * P;
      float o = 0.f;
      for (int j = 0; j < P; ++j) o = fmaf(pr[j], v_s[j * D + d], o);
      acc[e] = acc[e] * a_s[r] + o;
    }
  }
  __syncthreads();
  for (int e = tid; e < R * D; e += THREADS) {
    const float l = l_s[e / D];
    o_rows[e] = from_f32<TQ>(acc[e] / (l == 0.f ? 1.f : l));
  }
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* table,
                   const int* pos0, void* out, int B, int H, int Hkv, int S,
                   int D, int T, int P, int W, int window, float mult,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const dim3 grid(Hkv, B, (G * S + ROW_TILE - 1) / ROW_TILE);
  const size_t smem = sizeof(float) *
      (2 * ROW_TILE * D + P * (D + 1) + P * D + ROW_TILE * P + 3 * ROW_TILE);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = paged_attn_kernel<TQ, TKV, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, table, pos0, static_cast<TQ*>(out),
      H, Hkv, S, D, T, P, W, window, mult);
  return cudaGetLastError();
}

}  // namespace

// dtype codes shared with ops/paged_attention.py
enum { F32 = 0, BF16 = 1, F16 = 2, I8 = 3 };

extern "C" int kft_paged_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* pos0, void* out, int B, int H, int Hkv, int S, int D, int T,
    int P, int W, int window, float mult, int q_dtype, int kv_dtype,
    void* stream) {
  if (B == 0 || H == 0 || S == 0 || W == 0) return 0;
  if (Hkv <= 0 || H % Hkv || P <= 0 || T % P || D <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* p0 = static_cast<const int*>(pos0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KFT_ARGS q, k_pool, v_pool, ks, vs, tb, p0, out, B, H, Hkv, S, D, T, P, W, window, mult, st
  cudaError_t err = cudaErrorInvalidValue;
  if (kv_dtype == I8) {
    if (q_dtype == F32) err = launch<float, int8_t, true>(KFT_ARGS);
    if (q_dtype == BF16) err = launch<__nv_bfloat16, int8_t, true>(KFT_ARGS);
    if (q_dtype == F16) err = launch<__half, int8_t, true>(KFT_ARGS);
  } else if (kv_dtype == q_dtype) {
    if (q_dtype == F32) err = launch<float, float, false>(KFT_ARGS);
    if (q_dtype == BF16) err = launch<__nv_bfloat16, __nv_bfloat16, false>(KFT_ARGS);
    if (q_dtype == F16) err = launch<__half, __half, false>(KFT_ARGS);
  }
#undef KFT_ARGS
  return (int)err;
}

extern "C" const char* kft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
