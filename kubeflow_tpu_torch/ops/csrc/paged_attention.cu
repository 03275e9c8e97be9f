// Paged span attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernel kubeflow_tpu/ops/paged_attention.py
// (`_paged_attn_kernel`, launched by `paged_attention` at line 185): S
// queries per row starting at absolute position pos0[b] attend to the
// row's tokens in a flat (kv_heads, pool_tokens, D) pool, where logical
// token j lives at pool token table[b, j / P] * P + j % P. Causal and
// sliding-window masks come from positions alone; the GQA group is
// folded into the query rows; int8 pools are dequantized with per-token
// f32 scales (code * scale, as the twin) before any product.
//
// What bounds it on the H100: decode (S = 1) reads every K/V byte of the
// pages the row owns once and does 4 * D flops per byte pair, far below
// the ~295 flop/byte ridge, so it is bound by memory bandwidth; at the
// serving shape (B = 8, 16 kv heads, 4 pages of 32) the bytes take under
// 1 us, so in practice launch latency and the serial chain of one page's
// load, scores, softmax and P.V set the time. The design therefore
// spreads a row's pages over the warps of its block (flash-decoding
// inside one block), so the pages load and compute in parallel.
//
// TPU grid -> CUDA blocks: the Pallas grid (B, Hkv, W pages) ran the page
// axis sequentially ("arbitrary") with the accumulator in VMEM scratch.
// Here one block of 4 warps owns one (kv head, row, tile of query rows)
// -- blockIdx = (h, b, tile). The warps form groups of `split` warps; a
// group owns 4 of the tile's rows, and warp k of a group takes the row's
// visible pages lo + k, lo + k + split, ... in chunks of up to 32 keys.
// The launch picks split by G * S alone: 4 (all warps split one group's
// pages: decode, G * S <= 4), 2 (G * S <= 8), or 1 when G * S > 8
// (prefill pieces, wide GQA groups): there the warps split the rows, 16
// a block, and each walks every page. Within a warp:
//
// * Each chunk's K and V rows (and int8 scales) are copied into the
//   warp's own slice of shared memory with 16-byte cp.async copies (4-byte
//   for the scales). When the grid has no more blocks than the card has
//   SMs (decode at the serving shape, long contexts at small B * Hkv),
//   they are double-buffered, so the next chunk loads while this one
//   computes; with more blocks, one stage a warp halves the block's
//   shared memory and other blocks' warps hide the loads. K rows are
//   padded to an odd number of 16-byte chunks, so the 16-byte reads of 8
//   lanes on 8 keys hit distinct banks.
// * One lane per key: the score of (row, key) is the lane's f32 FMA dot
//   product over D of the q row (f32, broadcast from shared memory) and
//   its dequantized key, times `mult`; masked lanes hold -1e30.
// * The chunk's row max and sum are warp reductions (__shfl_xor_sync).
//   Each warp keeps, per row, its running max m, sum l and f32 output
//   accumulator in registers; p is not rounded before P.V, masked lanes
//   add exactly 0.
// * P.V: each lane owns output columns lane, lane + 32, ... (D / 32 of
//   them) and reads V rows of the chunk coalesced; the chunk's p go
//   through the warp's slice of shared memory and are read back four keys
//   at a time (one broadcast 16-byte load in place of four shuffles).
//
// The page skip of the Pallas kernel (pages wholly past the span's last
// query, or wholly before the earliest query's window) becomes the range
// [lo, hi] of pages a row visits; pages whose table entry lies outside
// the pool are skipped. The block reads its own table[b, i] and pos0[b];
// they replace the scalar-prefetch operands.
//
// Merge: a group's warps' (m, l, acc) meet in shared memory; m = max over
// the warps, each share is scaled by exp(m_w - m), l sums the scaled shares,
// and out = acc / l, or 0 where l == 0. A warp that saw no visible key
// holds (-1e30, 0, 0) and adds exactly 0, also on a row whose every warp
// is empty. One launch, no workspace, no atomics, a fixed order of sums:
// deterministic.
//
// Arithmetic stays in f32 FMAs, not the tensor cores: bytes bound it, and
// a bf16 P.V would round p and the dequantized V where the twin does not.
// Head dims up to 128 whose rows are a whole number of 16-byte chunks
// (D % 8 == 0 in bf16/f16, D % 4 in f32, D % 16 in int8).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the gather path's masked-score fill
constexpr int NW = 4;              // warps a block
constexpr int THREADS = NW * 32;
constexpr int RT = 4;              // query rows (GQA group x span) a block
constexpr int KCH = 32;            // keys a chunk: one a lane
constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90
constexpr unsigned FULL = 0xffffffffu;

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

// 16 bytes of shared memory as 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void load16(const unsigned char* p, float (&f)[16 / sizeof(T)]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i) f[i] = to_f32(x[i]);
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int window) {
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Shared memory: the block's q rows (f32, up to NW * RT x DP), the
// warps' partials (NW x RT x
// DP accumulators, then NW x RT maxima and sums), the warps' p (NW x RT x
// KCH), then per warp `nst` stages of [K chunk | V chunk | K scales |
// V scales], K and V rows `kld` bytes apart.
template <typename TQ, typename TKV, bool QUANT, int DP>
__global__ void __launch_bounds__(THREADS) paged_attn_split_kernel(
    const TQ* __restrict__ q,          // (B, H, S, D)
    const TKV* __restrict__ k_pool,    // (Hkv, T, D)
    const TKV* __restrict__ v_pool,    // (Hkv, T, D)
    const float* __restrict__ k_scale, // (Hkv, T) when QUANT
    const float* __restrict__ v_scale, // (Hkv, T) when QUANT
    const int* __restrict__ table,     // (B, W)
    const int* __restrict__ pos0,      // (B,)
    TQ* __restrict__ out,              // (B, H, S, D)
    int H, int Hkv, int S, int D, int T, int P, int W, int window,
    float mult, int kld, int nst, int split) {
  constexpr int NC = DP / 32;                    // output columns a lane
  constexpr int EPC = 16 / sizeof(TKV);          // elements of a 16-byte chunk
  constexpr int DCH = DP * sizeof(TKV) / 16;     // most 16-byte chunks a row
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = warp / split;   // this warp's group: its RT rows
  const int part = warp % split;  // and its share of their pages
  const int rb0 = blockIdx.z * (RT * NW / split);       // the block's first row
  const int Rb = min(RT * NW / split, G * S - rb0);     // the block's rows
  const int r0 = rb0 + grp * RT;                        // this warp's first row
  const int R = max(0, min(RT, G * S - r0));            // and its rows
  const int rowbytes = D * (int)sizeof(TKV);
  const int dch = rowbytes / 16;
  const int stage_bytes = 2 * KCH * kld + 2 * KCH * 4;

  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);   // NW * RT x DP
  float* mrg_acc = q_s + NW * RT * DP;           // NW x RT x DP
  float* mrg_m = mrg_acc + NW * RT * DP;         // NW x RT
  float* mrg_l = mrg_m + NW * RT;                // NW x RT
  float* p_s = mrg_l + NW * RT + warp * RT * KCH;  // this warp's RT x KCH
  unsigned char* stages = reinterpret_cast<unsigned char*>(mrg_l + NW * RT + NW * RT * KCH) +
                          (size_t)warp * nst * stage_bytes;

  // row r of kv head h is query s = r % S of head h * G + r / S; the G * S
  // rows of one kv head are contiguous in q and in out
  const size_t row0 = ((size_t)b * H + (size_t)h * G) * S + rb0;
  for (int e = tid; e < Rb * D; e += THREADS) {
    const int r = e / D;
    q_s[r * DP + e - r * D] = to_f32(q[row0 * D + e]);
  }

  // the pages the span visits form one range [lo, hi]: not wholly past
  // the last query, and (windowed) not wholly before the earliest
  // query's window
  const int p0 = pos0[b];
  int lo = 0;
  if (window > 0) {
    const int first = p0 - window + 2 - P;  // page i runs iff i * P >= first
    lo = first <= 0 ? 0 : (first + P - 1) / P;
  }
  const int last = p0 + S - 1;
  const int hi = last < 0 ? -1 : min(W - 1, last / P);
  const int nch = (P + KCH - 1) / KCH;
  const int n_pages = T / P;
  const int mine = R > 0 && hi - lo - part >= 0 ? (hi - lo - part) / split + 1 : 0;
  const int n_units = mine * nch;  // (page, chunk) pairs of this warp

  // unit u: chunk u % nch of page lo + part + (u / nch) * split; -1 when
  // the table entry lies outside the pool
  auto unit = [&](int u, int& i, int& c0) {
    const int kk = u / nch;
    i = lo + part + kk * split;
    c0 = (u - kk * nch) * KCH;
    const int page = table[b * W + i];
    return page >= 0 && page < n_pages ? page : -1;
  };

  auto fetch = [&](int u, int st) {
    int i, c0;
    const int page = unit(u, i, c0);
    if (page < 0) return;
    const int nk = min(KCH, P - c0);
    const size_t tok0 = (size_t)h * T + (size_t)page * P + c0;
    const unsigned char* kp = reinterpret_cast<const unsigned char*>(k_pool) + tok0 * rowbytes;
    const unsigned char* vp = reinterpret_cast<const unsigned char*>(v_pool) + tok0 * rowbytes;
    const uint32_t ks = tile::smem_addr(stages + st * stage_bytes);
    const uint32_t vs = ks + KCH * kld;
    for (int e = lane; e < KCH * dch; e += 32) {
      const int j = e / dch;
      const int c = e - j * dch;
      const bool in = j < nk;  // rows past the page's end are zeros
      const size_t src = in ? (size_t)j * rowbytes + 16 * c : 0;
      tile::cp_async16(ks + j * kld + 16 * c, kp + src, in);
      tile::cp_async16(vs + j * kld + 16 * c, vp + src, in);
    }
    if (QUANT) {
      const bool in = lane < nk;
      const uint32_t sc = vs + KCH * kld;
      tile::cp_async4(sc + 4 * lane, k_scale + tok0 + (in ? lane : 0), in);
      tile::cp_async4(sc + 4 * (KCH + lane), v_scale + tok0 + (in ? lane : 0), in);
    }
  };

  float m[RT], l[RT], acc[RT][NC];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  __syncthreads();  // q rows are in place
  if (n_units > 0) fetch(0, 0);
  tile::cp_async_commit();
  for (int u = 0; u < n_units; ++u) {
    const int st = nst == 2 ? (u & 1) : 0;
    if (nst == 2 && u + 1 < n_units) {
      fetch(u + 1, st ^ 1);
      tile::cp_async_commit();
      tile::cp_async_wait<1>();
    } else {
      tile::cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of chunk u have landed
    int i, c0;
    if (unit(u, i, c0) >= 0) {
      const unsigned char* kst = stages + st * stage_bytes;
      const unsigned char* vst = kst + KCH * kld;
      const float* sc = reinterpret_cast<const float*>(vst + KCH * kld);

      // scores: lane = key c0 + lane of page i
      float s[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) s[r] = 0.f;
      const float ksc = QUANT ? sc[lane] : 1.f;
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        if (c >= dch) break;
        float kf[EPC];
        load16<TKV>(kst + lane * kld + 16 * c, kf);
        if (QUANT) {
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[e] *= ksc;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < R) {
            const float* qr = q_s + (grp * RT + r) * DP + c * EPC;
#pragma unroll
            for (int e = 0; e < EPC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              s[r] = fmaf(qv.x, kf[e], s[r]);
              s[r] = fmaf(qv.y, kf[e + 1], s[r]);
              s[r] = fmaf(qv.z, kf[e + 2], s[r]);
              s[r] = fmaf(qv.w, kf[e + 3], s[r]);
            }
          }
        }
      }

      // online softmax over the chunk; masked lanes add EXACTLY 0, even
      // when the whole chunk is masked
      const int kpos = i * P + c0 + lane;
      const bool key_in = c0 + lane < P;
      float alpha[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        alpha[r] = 1.f;
        if (r < R) {
          const int qpos = p0 + (r0 + r) % S;
          const bool vis = key_in && visible(kpos, qpos, window);
          const float x = vis ? s[r] * mult : NEG_INF;
          const float m_cur = fmaxf(m[r], warp_max(x));
          const float p = vis ? expf(x - m_cur) : 0.f;
          alpha[r] = expf(m[r] - m_cur);
          l[r] = l[r] * alpha[r] + warp_sum(p);
          m[r] = m_cur;
          p_s[r * KCH + lane] = p;
        }
      }
      __syncwarp();  // the chunk's p are in place

      // acc = acc * alpha + P . V, V rows read coalesced; keys past the
      // page's end have p = 0 and zero-filled V rows
      const int nk = min(KCH, P - c0);
      float o[RT][NC];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
      }
      for (int j0 = 0; j0 < nk; j0 += 4) {
        float vf[4][NC];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const TKV* vrow = reinterpret_cast<const TKV*>(vst + (j0 + jj) * kld);
          const float vsc = QUANT ? sc[KCH + j0 + jj] : 1.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int d = lane + 32 * c;
            vf[jj][c] = d < D ? to_f32(vrow[d]) : 0.f;
            if (QUANT) vf[jj][c] *= vsc;
          }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < R) {
            const float4 p4 = *reinterpret_cast<const float4*>(p_s + r * KCH + j0);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              o[r][c] = fmaf(p4.x, vf[0][c], o[r][c]);
              o[r][c] = fmaf(p4.y, vf[1][c], o[r][c]);
              o[r][c] = fmaf(p4.z, vf[2][c], o[r][c]);
              o[r][c] = fmaf(p4.w, vf[3][c], o[r][c]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = acc[r][c] * alpha[r] + o[r][c];
      }
    }
    __syncwarp();  // stage st is free
    if (nst == 1 && u + 1 < n_units) {
      fetch(u + 1, 0);
      tile::cp_async_commit();
    }
  }

  // merge the warps' partials by their maxima
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (r < R) {
      if (lane == 0) {
        mrg_m[warp * RT + r] = m[r];
        mrg_l[warp * RT + r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) mrg_acc[(warp * RT + r) * DP + d] = acc[r][c];
      }
    }
  }
  __syncthreads();
  TQ* o_rows = out + row0 * D;
  for (int e = tid; e < Rb * D; e += THREADS) {
    const int rb = e / D;
    const int d = e - rb * D;
    const int r = rb % RT;
    const int w0 = rb / RT * split;  // the first warp of the row's group
    float mx = NEG_INF;
    for (int w = w0; w < w0 + split; ++w) mx = fmaxf(mx, mrg_m[w * RT + r]);
    float sum = 0.f, o = 0.f;
    for (int w = w0; w < w0 + split; ++w) {
      const float f = expf(mrg_m[w * RT + r] - mx);  // exactly 0 for an empty warp
      sum += mrg_l[w * RT + r] * f;
      o += mrg_acc[(w * RT + r) * DP + d] * f;
    }
    o_rows[e] = from_f32<TQ>(o / (sum == 0.f ? 1.f : sum));
  }
}

int sm_count() {
  static int n = 0;  // the card's SMs, read once
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename TQ, typename TKV, bool QUANT, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const int* table,
                   const int* pos0, void* out, int B, int H, int Hkv, int S,
                   int D, int T, int P, int W, int window, float mult,
                   cudaStream_t stream) {
  const int rowbytes = D * (int)sizeof(TKV);
  if (rowbytes % 16 != 0 || D > DP) return cudaErrorInvalidValue;
  const int kld = ((rowbytes / 16) | 1) * 16;  // an odd number of 16-byte chunks
  const size_t stage = 2 * (size_t)KCH * kld + 2 * KCH * sizeof(float);
  const size_t fixed =
      sizeof(float) * ((size_t)NW * RT * DP * 2 + 2 * NW * RT + NW * RT * KCH);
  // warps a row's pages are split across: all four at decode; for more
  // rows than a group holds, fewer, down to one (the warps split the rows)
  const int GS = H / Hkv * S;
  const int split = GS <= RT ? NW : GS <= 2 * RT ? NW / 2 : 1;
  const int rows = RT * NW / split;  // a block's rows
  const dim3 grid(Hkv, B, (GS + rows - 1) / rows);
  const long blocks = (long)grid.x * grid.y * grid.z;
  const int nst = blocks <= sm_count() && fixed + 2 * NW * stage <= MAX_SMEM ? 2 : 1;
  const size_t smem = fixed + nst * NW * stage;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = paged_attn_split_kernel<TQ, TKV, QUANT, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), ks, vs, table, pos0, static_cast<TQ*>(out),
      H, Hkv, S, D, T, P, W, window, mult, kld, nst, split);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch_any(const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const int* table,
                       const int* pos0, void* out, int B, int H, int Hkv, int S,
                       int D, int T, int P, int W, int window, float mult,
                       cudaStream_t stream) {
#define KFT_ARGS q, k, v, ks, vs, table, pos0, out, B, H, Hkv, S, D, T, P, W, window, mult, stream
  if (D <= 64) return launch<TQ, TKV, QUANT, 64>(KFT_ARGS);
  return launch<TQ, TKV, QUANT, 128>(KFT_ARGS);
#undef KFT_ARGS
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
  if (Hkv <= 0 || H % Hkv || P <= 0 || T % P || D <= 0 || D > 128) {
    return (int)cudaErrorInvalidValue;
  }
  if (!tile::aligned16(k_pool) || !tile::aligned16(v_pool)) {  // 16-byte copies
    return (int)cudaErrorMisalignedAddress;
  }
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* p0 = static_cast<const int*>(pos0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KFT_ARGS q, k_pool, v_pool, ks, vs, tb, p0, out, B, H, Hkv, S, D, T, P, W, window, mult, st
  cudaError_t err = cudaErrorInvalidValue;
  if (kv_dtype == I8) {
    if (q_dtype == F32) err = launch_any<float, int8_t, true>(KFT_ARGS);
    if (q_dtype == BF16) err = launch_any<__nv_bfloat16, int8_t, true>(KFT_ARGS);
    if (q_dtype == F16) err = launch_any<__half, int8_t, true>(KFT_ARGS);
  } else if (kv_dtype == q_dtype) {
    if (q_dtype == F32) err = launch_any<float, float, false>(KFT_ARGS);
    if (q_dtype == BF16) err = launch_any<__nv_bfloat16, __nv_bfloat16, false>(KFT_ARGS);
    if (q_dtype == F16) err = launch_any<__half, __half, false>(KFT_ARGS);
  }
#undef KFT_ARGS
  return (int)err;
}

extern "C" const char* kft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
