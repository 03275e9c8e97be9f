// Paged span attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas kernel kubeflow_tpu/ops/paged_attention.py
// (`_paged_attn_kernel`, launched by `paged_attention` at line 185): S
// queries per row starting at absolute position pos0[b] attend to the
// row's tokens in a flat (kv_heads, pool_tokens, D) pool, where logical
// token j lives at pool token table[b, j / P] * P + j % P. Causal and
// sliding-window masks come from positions alone; the GQA group is
// folded into the query rows (row r of kv head h is query s = r % S of
// head h * G + r / S); int8 pools carry per-token f32 scales.
//
// What bounds it on the H100: a decode step reads every K/V byte of the
// row's visible pages once and does 4 * D flops per key and row, far
// below the ~295 flop/byte ridge, so bytes bound it; at the serving shape
// (B = 8, 16 kv heads, 4 pages of 32) those bytes take under 1 us, so
// what sets the time is latency: the launch, and the chain of dependent
// device-memory round trips before the first product. The design cuts
// that chain and spreads a row's pages over as many warps as the card
// can give it.
//
// Two bodies; the launcher picks one by q's dtype and G * S alone
// (`mma_body`, mirrored by ops/paged_attention.py `body`):
//
// * `paged_attn_decode_kernel` takes every dtype (f32 q with f32 or int8
//   pools: the f32 parity path) and, for bf16/f16, spans of G * S <=
//   MMA_MIN_GS rows (the served MHA decode). A block owns DEC_ROWS query
//   rows of one (kv head, row). One lane a key: a lane's score is an f32
//   FMA dot product of its K row (read in a chunk order rotated by lane,
//   so the 8 lanes of a 16-byte phase hit 8 distinct bank groups) with
//   the q rows held as f32 in shared memory (each chunk's floats padded so
//   the rotated reads do not collide either), two sums a row to halve the
//   FMA chain; the chunk's row max and sum are warp shuffles; in P.V each
//   lane owns DP / 32 consecutive output columns (one vector load a V
//   row), p broadcast from shared memory. All f32: the span is
//   bytes-bound, and f32 is the parity path (a tensor-core f32 product
//   would be TF32); exponentials and the last division are exact for f32
//   q and the fast forms for 16-bit q, whose output is rounded to 16 bits.
// * `paged_attn_mma_kernel` takes bf16/f16 q (pools of q's type or int8)
//   at G * S > MMA_MIN_GS: the K = 4 verify (5 rows), the 8-head GQA
//   decode, prefill and suffix pieces. A block owns one 16-row tile of
//   the G * S rows; each warp holds the tile's Q fragments in registers
//   and runs S = Q.K^T and O = P.V on mma.sync.m16n8k16 with f32
//   accumulators (tile_mma.cuh), the mask and online softmax on the
//   accumulator fragments (per-element masks only on a chunk that is not
//   wholly visible), p packed to q's type for P.V in two 16-bit halves
//   (hi, then lo = p - hi), two products adding up to p to 16 more bits:
//   one 16-bit p alone puts a relative 2^-9 on each term, which a row of
//   a few keys whose values cancel (a piece's first rows at position 0)
//   shows far above its output's rounding. Why mma.sync and not wgmma: a span has 5-32 rows a kv head on the
//   served path, and wgmma's 64-row minimum would leave most of every
//   product as padding; the span's flop per byte is about its row count,
//   far below the ridge, so the tensor cores cut per-row issue latency,
//   not for their rate. int8 pools stay on the tensor cores: codes in
//   [-127, 127] are exact in bf16 and f16, so the warp widens a chunk's
//   codes into a swizzled 16-bit tile, multiplies each key's score by its
//   k scale after Q.K^T and folds the v scale into p before it is packed
//   (sum_j p_j (c_j s_j) = sum_j (p_j s_j) c_j), and p s is packed in
//   the same two halves.
//
// Loads. Every warp streams its own keys in chunks of KCH (a page, or 32
// keys of a longer one) through a ring of up to NSTAGE stages in shared
// memory, each completed on an mbarrier and filled by one elected lane:
// the mma body's 16-bit pages by TMA (a 3-D tensor map over the (D, T,
// Hkv) pool, 64-column boxes with the 128-byte swizzle, which is exactly
// tile::swz<64>'s layout for ldmatrix; D = 128 takes two boxes), every
// other page by a bulk copy of its contiguous rows (cp.async.bulk); int8
// scales by each lane's 4-byte cp.async, which arrives on the same
// mbarrier (cp.async.mbarrier.arrive.noinc). Loads of the next chunks fly
// while a chunk computes. No lane spends registers on copy addresses.
//
// Prologue. pos0[b], the row's whole table row and q are read at once by
// all threads (they do not depend on each other); after one barrier every
// warp knows its pages and issues them. The only dependent round trip
// left before arithmetic is table -> pages.
//
// Pages over a thread-block cluster. A row's visible pages [lo, hi] (not
// wholly past the span's last query, and, windowed, not wholly before the
// earliest query's window; table entries outside the pool are skipped)
// are cut into fixed groups of consecutive pages counted from lo: gp =
// ceil(n / NGMAX) pages a group, ng = ceil(n / gp) groups, where n is the
// row's own page count and NGMAX is the body's constant. Each group's
// partial (m, l, acc) is formed in a fixed order (its pages and chunks
// in turn, online softmax) and parked in shared memory. The launcher
// splits a row's groups over a cluster of C in {1, 2, 4, 8} blocks
// (cudaLaunchKernelEx with a cluster dimension), C chosen from the grid
// and W to fill the SMs (`cluster_size`): warp w of cluster rank k takes
// groups k * NW + w, + C * NW, .... Behind a cluster barrier the blocks
// merge the groups through distributed shared memory (mapa +
// ld.shared::cluster), in group order under the row's global max: M =
// max m_g, f_g = exp(m_g - M), out = sum_g f_g acc_g / sum_g f_g l_g (0
// where the sum is 0; an empty group holds (-1e30, 0, 0) and adds exactly
// 0); one thread a row forms the f_g and the sum of l, then every thread
// takes output elements. One launch, no workspace, no atomics. At C = 1
// the launch has no cluster and the merge reads the block's own shared
// memory. C, B and W change which block computes a group, never the
// sums: a row's output bits depend only on its own q, pages, pos0,
// window, G * S and dtype.
//
// TPU grid -> CUDA: the Pallas grid (B, Hkv, W pages) ran the page axis
// sequentially with the accumulator in VMEM scratch; here grid = (C, Hkv *
// row tiles, B), the page axis spread over warps and cluster blocks and
// merged as above. Scalar prefetch of the table becomes the prologue.
// Head dims up to 128 whose pool rows are whole 16-byte chunks (D % 8 ==
// 0 in bf16/f16, D % 4 in f32, D % 16 in int8).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tile_mma.cuh"
#include "wgmma_tile.cuh"

// dtype codes shared with ops/paged_attention.py
enum { F32 = 0, BF16 = 1, F16 = 2, I8 = 3 };

namespace {

constexpr float NEG_INF = -1e30f;  // the gather path's masked-score fill
constexpr int NW = 4;              // warps a block
constexpr int THREADS = NW * 32;
constexpr int KCH = 32;            // keys a ring stage: one a lane
constexpr int DEC_ROWS = 4;        // query rows a decode block
constexpr int MMA_ROWS = 16;       // query rows an mma block: one m16 tile
constexpr int MMA_MIN_GS = 4;      // G * S above which bf16/f16 spans take the mma body
constexpr int DEC_GROUPS = 16;     // most page groups a row is cut into: decode body
constexpr int MMA_GROUPS = 8;      // and mma body (its partials are 16 rows)
constexpr int NSTAGE = 2;          // ring stages a warp, at most
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_SMEM = 232448;   // a block's shared memory on sm_90
constexpr int SM_SMEM = 233472;    // an SM's
constexpr uint32_t BOXB = KCH * 128;  // a 64-column box of KCH 16-bit rows
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

// x rounded to nearest-even in T, back in f32
template <typename T> __device__ __forceinline__ float round16(float x);
template <> __device__ __forceinline__ float round16<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <> __device__ __forceinline__ float round16<__half>(float x) {
  return __half2float(__float2half(x));
}

// N consecutive T of shared memory (N * sizeof(T) bytes, aligned) as floats
template <typename T, int N>
__device__ __forceinline__ void load_cols(const unsigned char* p, float (&f)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  using V = typename std::conditional<
      BYTES == 16, uint4,
      typename std::conditional<BYTES == 8, uint2,
                                typename std::conditional<BYTES == 4, uint32_t,
                                                          uint16_t>::type>::type>::type;
  const V u = *reinterpret_cast<const V*>(p);
  const T* x = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_f32(x[i]);
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

// ------------------------------------------------- copies and the cluster

// `bytes` contiguous bytes global -> shared, completed on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bar` receives one arrival once this thread's earlier cp.async copies land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// every thread of every block of the cluster; orders shared-memory writes
// before the other blocks' reads that follow
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the cluster's barrier, or the block's when the launch has no cluster
__device__ __forceinline__ void block_sync(int C) {
  if (C > 1) {
    cluster_sync();
  } else {
    __syncthreads();
  }
}

// the address of the same shared-memory byte in cluster block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// a float of another cluster block's shared memory; ordered after the
// cluster barrier (both asm volatile) but free to batch with its peers
__device__ __forceinline__ float ld_remote(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// e^x and x / y: exact for f32 (the parity path), the fast forms where the
// result is rounded to 16 bits
template <typename T> __device__ __forceinline__ float exp_of(float x) {
  return std::is_same<T, float>::value ? expf(x) : __expf(x);
}
template <typename T> __device__ __forceinline__ float div_of(float x, float y) {
  return std::is_same<T, float>::value ? x / y : __fdividef(x, y);
}

// -------------------------------------------------- shared-memory layout

__host__ __device__ constexpr int align_up(int x, int a) { return (x + a - 1) / a * a; }

// A ring stage. Decode: K and V rows of KCH keys packed at their pool row
// length, then KCH k and v scales. Mma, 16-bit pools: K then V as
// 64-column TMA boxes (BOXB bytes each). Mma, int8: the codes as decode,
// widened per warp into a 16-bit staging tile of the TMA layout.
__host__ __device__ constexpr int dec_stage(int DP, int eb) {
  return 2 * KCH * DP * eb + 2 * KCH * 4;
}
__host__ __device__ constexpr int mma_stage(int DP, bool quant) {
  return quant ? align_up(2 * KCH * DP + 2 * KCH * 4, 128) : 2 * (DP / 64) * (int)BOXB;
}
__host__ __device__ constexpr int mma_staging(int DP, bool quant) {
  return quant ? 2 * (DP / 64) * (int)BOXB : 0;  // a warp's
}
// a group's partial: acc (rows x DP), then the rows' m and l
__host__ __device__ constexpr int slot_bytes(int rows, int DP) { return 4 * (rows * DP + 2 * rows); }
// the decode body's q rows: each 16-byte pool chunk's floats, padded when
// they span 32 bytes or more
__host__ __device__ constexpr int dec_qchunk(int eb) {
  return 4 * (16 / eb) >= 32 ? 4 * (16 / eb) + 16 : 4 * (16 / eb);
}
__host__ __device__ constexpr int dec_q(int DP, int eb) {
  return DEC_ROWS * (DP * eb / 16) * dec_qchunk(eb);
}

// Byte offsets from the 1024-aligned base: [staging][ring][q][p][slots]
// [merge weights][table][barriers]; the same in every block of a launch.
struct Layout {
  int staging, ring, q, p, slots, wts, table, bars, total;
};

__host__ __device__ inline Layout layout(int staging, int stage, int qbytes, int pbytes,
                                         int slot, int ns, int nslot, int W) {
  Layout L;
  L.staging = 0;
  L.ring = NW * staging;
  L.q = L.ring + NW * ns * stage;
  L.p = align_up(L.q + qbytes, 16);
  L.slots = align_up(L.p + pbytes, 16);
  L.wts = L.slots + NW * nslot * slot;  // the merge's weights, room for either body
  L.table = L.wts + 4 * MMA_ROWS * (DEC_GROUPS + 1);
  L.bars = align_up(L.table + 4 * W, 8);
  L.total = L.bars + 8 * NW * ns + 1024;  // + alignment slack
  return L;
}

// one stage, one group slot a warp, a short table: what fixes the blocks
// an SM (and so each thread's registers) in __launch_bounds__
__host__ __device__ constexpr int dec_floor(int DP, int eb) {
  return NW * dec_stage(DP, eb) + dec_q(DP, eb) + NW * DEC_ROWS * KCH * 4 +
         NW * slot_bytes(DEC_ROWS, DP) + 4 * MMA_ROWS * (DEC_GROUPS + 1) + 2048;
}
__host__ __device__ constexpr int mma_floor(int DP, bool quant) {
  return NW * (mma_staging(DP, quant) + mma_stage(DP, quant)) + MMA_ROWS * DP * 2 +
         NW * slot_bytes(MMA_ROWS, DP) + 4 * MMA_ROWS * (DEC_GROUPS + 1) + 2048;
}
__host__ __device__ constexpr int blocks_of(int floor_bytes, int cap) {
  return SM_SMEM / floor_bytes < 1 ? 1 : (SM_SMEM / floor_bytes > cap ? cap : SM_SMEM / floor_bytes);
}
// at most 3 blocks an SM (170 registers a thread) for the decode body,
// whose unrolled score loop spills at 128; the mma body holds Q and O
// fragments (DP / 4 + DP / 2 registers) and the halves of p, and gets 3
// blocks at DP = 64 and 2 at DP = 128
__host__ __device__ constexpr int dec_blocks(int DP, int eb) { return blocks_of(dec_floor(DP, eb), 3); }
__host__ __device__ constexpr int mma_blocks(int DP, bool quant) {
  return blocks_of(mma_floor(DP, quant), DP == 64 ? 3 : 2);
}

// ------------------------------------------------------ pages and groups

// the pages [lo, hi] a row's span visits and their groups
struct Span {
  int lo, hi, gp, ng;
};

__device__ __forceinline__ Span span_of(int p0, int S, int P, int W, int window, int ngmax) {
  Span s;
  s.lo = 0;
  if (window > 0) {
    const int first = p0 - window + 2 - P;  // page i runs iff i * P >= first
    s.lo = first <= 0 ? 0 : (first + P - 1) / P;
  }
  const int last = p0 + S - 1;
  s.hi = last < 0 ? -1 : min(W - 1, last / P);
  const int n = max(0, s.hi - s.lo + 1);
  s.gp = max(1, (n + ngmax - 1) / ngmax);
  s.ng = s.gp == 1 ? n : (n + s.gp - 1) / s.gp;
  return s;
}

// A warp's items: its groups gw, gw + cw, ... (cw = C * NW = 1 << wshift
// warps in the cluster), each group's pages in turn, each page's KCH-key
// chunks in turn.
struct Work {
  int gw, wshift, nch, ig, n;  // first group, log2 stride, chunks a page, items a full group, items
};

__device__ __forceinline__ Work work_of(const Span& sp, int gw, int wshift, int nch) {
  Work w;
  w.gw = gw;
  w.wshift = wshift;
  w.nch = nch;
  w.ig = sp.gp * nch;
  w.n = 0;
  if (gw < sp.ng) {
    const int groups = (sp.ng - gw + (1 << wshift) - 1) >> wshift;
    const int g_last = gw + ((groups - 1) << wshift);  // only the row's last group can be short
    const int pages = min(sp.gp, sp.hi - (sp.lo + g_last * sp.gp) + 1);
    w.n = (groups - 1) * w.ig + pages * nch;
  }
  return w;
}

struct Item {
  int j, i, c0;      // the warp's group index, page index, first key
  bool first, last;  // first and last item of its group
};

__device__ __forceinline__ Item item_of(const Work& w, const Span& sp, int u) {
  Item it;
  if (w.ig == 1) {  // a group is one page of one chunk: no division
    it.j = u;
    it.i = sp.lo + w.gw + (u << w.wshift);
    it.c0 = 0;
    it.first = it.last = true;
    return it;
  }
  it.j = u / w.ig;
  const int rem = u - it.j * w.ig;
  const int g = w.gw + (it.j << w.wshift);
  const int kk = rem / w.nch;
  it.i = sp.lo + g * sp.gp + kk;
  it.c0 = (rem - kk * w.nch) * KCH;
  it.first = rem == 0;
  it.last = rem == w.ig - 1 || u == w.n - 1;
  return it;
}

// ------------------------------------------------------------- the merge

// Rows [0, R) of the tile. The groups' partials sit in cluster block (g /
// NW) % C, slot (g / (NW * C)) * NW + g % NW (`slots` is this block's slot
// array). First thread r of each block takes row r: M = max m_g, f_g =
// exp(m_g - M), L = sum f_g l_g, into `wts` (NGMAX + 1 floats a row) of
// its own block; then thread t of block `rank` takes output elements rank
// * THREADS + t, + C * THREADS, ...: sum_g f_g acc_g / L. Sums run in
// group order.
template <typename TQ, int RT, int DP, int NGMAX, bool REMOTE>
__device__ __forceinline__ void merge(const unsigned char* slots, float* wts, int ng, int R,
                                      int D, int C, int wshift, int rank, int tid,
                                      TQ* __restrict__ o_rows) {
  constexpr int SLOT = slot_bytes(RT, DP);
  // the float at byte `off` of group g's slot (slot g without a cluster)
  auto ld = [&](int g, int off) {
    if (!REMOTE) return *reinterpret_cast<const float*>(slots + g * SLOT + off);
    const int at = ((g >> wshift) * NW + (g & (NW - 1))) * SLOT + off;
    return ld_remote(map_rank(tile::smem_addr(slots + at), (uint32_t)((g / NW) & (C - 1))));
  };
  if (tid < R) {
    float* w = wts + tid * (NGMAX + 1);
    float M = NEG_INF;
#pragma unroll 4
    for (int g = 0; g < ng; ++g) M = fmaxf(M, ld(g, 4 * (RT * DP + tid)));
    float L = 0.f;
#pragma unroll 4
    for (int g = 0; g < ng; ++g) {
      const float f = exp_of<TQ>(ld(g, 4 * (RT * DP + tid)) - M);  // 0 for an empty group
      L += ld(g, 4 * (RT * DP + RT + tid)) * f;
      w[g] = f;
    }
    w[NGMAX] = L == 0.f ? 1.f : L;
  }
  __syncthreads();
  for (int e = rank * THREADS + tid; e < R * D; e += C * THREADS) {
    const int rr = R == 1 ? 0 : e / D;
    const int d = e - rr * D;
    const float* w = wts + rr * (NGMAX + 1);
    float o = 0.f;
#pragma unroll 4
    for (int g = 0; g < ng; ++g) o += ld(g, 4 * (rr * DP + d)) * w[g];
    o_rows[e] = from_f32<TQ>(div_of<TQ>(o, w[NGMAX]));
  }
}

// ------------------------------------------------------ the decode body

template <typename TQ, typename TKV, bool QUANT, int DP>
__global__ void __launch_bounds__(THREADS, dec_blocks(DP, sizeof(TKV))) paged_attn_decode_kernel(
    const TQ* __restrict__ q,          // (B, H, S, D)
    const TKV* __restrict__ k_pool,    // (Hkv, T, D)
    const TKV* __restrict__ v_pool,    // (Hkv, T, D)
    const float* __restrict__ k_scale, // (Hkv, T) when QUANT
    const float* __restrict__ v_scale, // (Hkv, T) when QUANT
    const int* __restrict__ table,     // (B, W)
    const int* __restrict__ pos0,      // (B,)
    TQ* __restrict__ out,              // (B, H, S, D)
    int H, int Hkv, int S, int D, int T, int P, int W, int window, float mult,
    int ntiles, int ns, int nslot, int n_pages, int nch, int cshift) {
  constexpr int RT = DEC_ROWS;
  constexpr int NC = DP / 32;                    // output columns a lane
  constexpr int EB = sizeof(TKV);
  constexpr int EPC = 16 / EB;                   // elements of a 16-byte chunk
  constexpr int DCH = DP * EB / 16;              // most 16-byte chunks a row
  constexpr int QCB = dec_qchunk(EB);
  constexpr int QROW = DCH * QCB;
  constexpr int STAGE = dec_stage(DP, EB);
  constexpr int SLOT = slot_bytes(RT, DP);
  const int C = gridDim.x;  // the cluster is the grid's x extent
  const int rank = blockIdx.x;
  const int h = blockIdx.y / ntiles;
  const int rb0 = (blockIdx.y - h * ntiles) * RT;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int R = min(RT, G * S - rb0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rowbytes = D * EB;
  const int dch = rowbytes / 16;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay = layout(0, STAGE, dec_q(DP, EB), NW * RT * KCH * 4, SLOT, ns, nslot, W);
  unsigned char* ring = smem + lay.ring + warp * ns * STAGE;
  unsigned char* q_s = smem + lay.q;
  float* p_s = reinterpret_cast<float*>(smem + lay.p) + warp * RT * KCH;
  int* tbl = reinterpret_cast<int*>(smem + lay.table);
  float* wts = reinterpret_cast<float*>(smem + lay.wts);
  const uint32_t bars = tile::smem_addr(smem + lay.bars) + 8 * warp * ns;

  // prologue: barriers, then pos0, the table row and q, all at once
  if (lane == 0) {
    for (int s = 0; s < ns; ++s) wg::mbar_init(bars + 8 * s, QUANT ? 33 : 1);
    wg::mbar_init_fence();
  }
  const int p0 = pos0[b];
  for (int i = tid; i < W; i += THREADS) tbl[i] = table[(size_t)b * W + i];
  const size_t row0 = ((size_t)b * H + (size_t)h * G) * S + rb0;
  for (int e = tid; e < R * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    *reinterpret_cast<float*>(q_s + r * QROW + (d / EPC) * QCB + (d % EPC) * 4) =
        to_f32(q[row0 * D + e]);
  }
  __syncthreads();

  const Span sp = span_of(p0, S, P, W, window, DEC_GROUPS);
  const Work wk = work_of(sp, rank * NW + warp, cshift + 2, nch);

  auto page_of = [&](int i) {
    const int page = tbl[i];
    return page >= 0 && page < n_pages ? page : -1;
  };
  // item u into stage u % ns: lane 0 the K and V rows, every lane its key's scales
  auto issue = [&](int u) {
    const Item it = item_of(wk, sp, u);
    const int page = page_of(it.i);
    const int nk = min(KCH, P - it.c0);
    const uint32_t st = tile::smem_addr(ring + (u % ns) * STAGE);
    const uint32_t bar = bars + 8 * (u % ns);
    const size_t tok0 = (size_t)h * T + (size_t)max(page, 0) * P + it.c0;
    if (lane == 0) {
      if (page >= 0) {
        const uint32_t bytes = nk * rowbytes;
        if (u >= ns) wg::fence_proxy_async();  // the stage's last reads come first
        wg::mbar_arrive_expect_tx(bar, 2 * bytes);
        bulk_load(st, reinterpret_cast<const unsigned char*>(k_pool) + tok0 * rowbytes, bytes, bar);
        bulk_load(st + KCH * DP * EB, reinterpret_cast<const unsigned char*>(v_pool) + tok0 * rowbytes,
                  bytes, bar);
      } else {
        wg::mbar_arrive(bar);
      }
    }
    if (QUANT) {
      const bool in = page >= 0 && lane < nk;
      const uint32_t sc = st + 2 * KCH * DP * EB;
      tile::cp_async4(sc + 4 * lane, in ? k_scale + tok0 + lane : k_scale, in);
      tile::cp_async4(sc + 4 * (KCH + lane), in ? v_scale + tok0 + lane : v_scale, in);
      cp_async_arrive(bar);
    }
  };
  for (int u = 0; u < min(ns, wk.n); ++u) issue(u);

  float m[RT], l[RT], acc[RT][NC];
  const int rot = (lane / max(1, 8 / dch)) % dch;  // this lane's first chunk
  int qpos[RT];  // the rows' query positions
#pragma unroll
  for (int r = 0; r < RT; ++r) qpos[r] = p0 + (S == 1 ? 0 : (rb0 + r) % S);
  for (int u = 0; u < wk.n; ++u) {
    const Item it = item_of(wk, sp, u);
    if (it.first) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
      }
    }
    wg::mbar_wait(bars + 8 * (u % ns), (u / ns) & 1);
    if (page_of(it.i) >= 0) {
      const unsigned char* kst = ring + (u % ns) * STAGE;
      const unsigned char* vst = kst + KCH * DP * EB;
      const float* sc = reinterpret_cast<const float*>(vst + KCH * DP * EB);
      const int nk = min(KCH, P - it.c0);

      // scores: lane = key c0 + lane of page i, its chunks from `rot` on
      // two sums a row, even and odd chunks, to halve the FMA chain
      float s[RT], s2[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) s[r] = s2[r] = 0.f;
      const float ksc = QUANT ? sc[lane] : 1.f;
      int cc = rot;
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        if (c >= dch) break;
        float (&acc_s)[RT] = c & 1 ? s2 : s;
        float kf[EPC];
        load16<TKV>(kst + lane * rowbytes + 16 * cc, kf);
        if (QUANT) {
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[e] *= ksc;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if (r < R) {
            const float* qr = reinterpret_cast<const float*>(q_s + r * QROW + cc * QCB);
#pragma unroll
            for (int e = 0; e < EPC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              acc_s[r] = fmaf(qv.x, kf[e], acc_s[r]);
              acc_s[r] = fmaf(qv.y, kf[e + 1], acc_s[r]);
              acc_s[r] = fmaf(qv.z, kf[e + 2], acc_s[r]);
              acc_s[r] = fmaf(qv.w, kf[e + 3], acc_s[r]);
            }
          }
        }
        cc = cc + 1 == dch ? 0 : cc + 1;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) s[r] += s2[r];

      // online softmax over the chunk; masked lanes add EXACTLY 0, even
      // when the whole chunk is masked
      const int kpos = it.i * P + it.c0 + lane;
      const bool key_in = lane < nk;
      float alpha[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        alpha[r] = 1.f;
        if (r < R) {
          const bool vis = key_in && visible(kpos, qpos[r], window);
          const float x = vis ? s[r] * mult : NEG_INF;
          const float m_cur = fmaxf(m[r], warp_max(x));
          const float p = vis ? exp_of<TQ>(x - m_cur) : 0.f;
          alpha[r] = exp_of<TQ>(m[r] - m_cur);
          l[r] = l[r] * alpha[r] + warp_sum(p);
          m[r] = m_cur;
          p_s[r * KCH + lane] = p;
        }
      }
      __syncwarp();  // the chunk's p are in place

      // acc = acc * alpha + P . V, lane on output columns [NC lane, NC
      // lane + NC): one vector load a V row
      float o[RT][NC];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
      }
#pragma unroll
      for (int j0 = 0; j0 < KCH; j0 += 4) {
        if (j0 >= nk) break;
        float vf[4][NC];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const bool in = j0 + jj < nk && NC * lane < D;
#pragma unroll
          for (int c = 0; c < NC; ++c) vf[jj][c] = 0.f;
          if (in) load_cols<TKV, NC>(vst + (j0 + jj) * rowbytes + NC * lane * EB, vf[jj]);
          if (QUANT) {
            const float vsc = in ? sc[KCH + j0 + jj] : 0.f;
#pragma unroll
            for (int c = 0; c < NC; ++c) vf[jj][c] *= vsc;
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
    if (it.last) {  // park the group's partial in its slot
      float* slot = reinterpret_cast<float*>(smem + lay.slots + (it.j * NW + warp) * SLOT);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r < R) {
          if (lane == 0) {
            slot[RT * DP + r] = m[r];
            slot[RT * DP + RT + r] = l[r];
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) slot[r * DP + NC * lane + c] = acc[r][c];
        }
      }
    }
    __syncwarp();  // stage u % ns and the p are free
    if (u + ns < wk.n) issue(u + ns);
  }

  block_sync(C);  // every group's partial is parked
  if (C > 1) {
    merge<TQ, RT, DP, DEC_GROUPS, true>(smem + lay.slots, wts, sp.ng, R, D, C, cshift + 2,
                                         rank, tid, out + row0 * D);
  } else {
    merge<TQ, RT, DP, DEC_GROUPS, false>(smem + lay.slots, wts, sp.ng, R, D, C, cshift + 2,
                                          rank, tid, out + row0 * D);
  }
  if (C > 1) cluster_sync();  // no block leaves while another reads its partials
}

// --------------------------------------------------------- the mma body

template <typename TQ, typename TKV, bool QUANT, int DP>
__global__ void __launch_bounds__(THREADS, mma_blocks(DP, QUANT)) paged_attn_mma_kernel(
    const __grid_constant__ CUtensorMap k_map,  // 16-bit pools as (D, T, Hkv)
    const __grid_constant__ CUtensorMap v_map,
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool, const TKV* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ table, const int* __restrict__ pos0, TQ* __restrict__ out,
    int H, int Hkv, int S, int D, int T, int P, int W, int window, float mult,
    int ntiles, int ns, int nslot, int n_pages, int nch, int cshift, int kb) {
  constexpr int RT = MMA_ROWS;
  constexpr int NB = DP / 64;   // 64-column boxes a row
  constexpr int KC = DP / 16;   // k16 steps of Q.K^T
  constexpr int NO = DP / 8;    // n8 tiles of O
  constexpr int STAGE = mma_stage(DP, QUANT);
  constexpr int STAGING = mma_staging(DP, QUANT);
  constexpr int SLOT = slot_bytes(RT, DP);
  const int C = gridDim.x;
  const int rank = blockIdx.x;
  const int h = blockIdx.y / ntiles;
  const int rb0 = (blockIdx.y - h * ntiles) * RT;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int R = min(RT, G * S - rb0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;  // fragment row and column pair

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout lay = layout(STAGING, STAGE, RT * DP * 2, 0, SLOT, ns, nslot, W);
  unsigned char* ring = smem + lay.ring + warp * ns * STAGE;
  const uint32_t staging = tile::smem_addr(smem + warp * STAGING);
  const uint32_t q_t = tile::smem_addr(smem + lay.q);
  int* tbl = reinterpret_cast<int*>(smem + lay.table);
  float* wts = reinterpret_cast<float*>(smem + lay.wts);
  const uint32_t bars = tile::smem_addr(smem + lay.bars) + 8 * warp * ns;

  if (lane == 0) {
    if (!QUANT && warp == 0) {  // the maps' descriptors, fetched while the prologue loads
      wg::tma_prefetch_map(&k_map);
      wg::tma_prefetch_map(&v_map);
    }
    for (int s = 0; s < ns; ++s) wg::mbar_init(bars + 8 * s, QUANT ? 33 : 1);
    wg::mbar_init_fence();
  }
  const int p0 = pos0[b];
  for (int i = tid; i < W; i += THREADS) tbl[i] = table[(size_t)b * W + i];
  // the q tile, 16 rows of DP 16-bit values in tile::swz<DP> order; rows
  // past the span and columns past D are zeros
  const size_t row0 = ((size_t)b * H + (size_t)h * G) * S + rb0;
  for (int e = tid; e < RT * DP; e += THREADS) {
    const int r = e / DP;
    const int d = e - r * DP;
    const TQ x = r < R && d < D ? q[(row0 + r) * D + d] : from_f32<TQ>(0.f);
    *reinterpret_cast<TQ*>(smem + lay.q + tile::swz<DP>(r, d / 8) + 2 * (d % 8)) = x;
  }
  __syncthreads();

  const Span sp = span_of(p0, S, P, W, window, MMA_GROUPS);
  const Work wk = work_of(sp, rank * NW + warp, cshift + 2, nch);

  auto page_of = [&](int i) {
    const int page = tbl[i];
    return page >= 0 && page < n_pages ? page : -1;
  };
  auto issue = [&](int u) {
    const Item it = item_of(wk, sp, u);
    const int page = page_of(it.i);
    const int nk = min(KCH, P - it.c0);
    const uint32_t st = tile::smem_addr(ring + (u % ns) * STAGE);
    const uint32_t bar = bars + 8 * (u % ns);
    const int row = max(page, 0) * P + it.c0;  // the chunk's first pool token
    if (lane == 0) {
      if (page < 0) {
        wg::mbar_arrive(bar);
      } else if (QUANT) {
        const size_t off = ((size_t)h * T + row) * D;
        if (u >= ns) wg::fence_proxy_async();
        wg::mbar_arrive_expect_tx(bar, 2 * nk * D);
        bulk_load(st, reinterpret_cast<const unsigned char*>(k_pool) + off, nk * D, bar);
        bulk_load(st + KCH * DP, reinterpret_cast<const unsigned char*>(v_pool) + off, nk * D, bar);
      } else {
        // nk / kb boxes of kb rows a column box; zero fill past D
        if (u >= ns) wg::fence_proxy_async();
        wg::mbar_arrive_expect_tx(bar, 2 * nk * DP * 2);
        for (int x = 0; x < nk; x += kb) {
#pragma unroll
          for (int cb = 0; cb < NB; ++cb) {
            const uint32_t dst = st + cb * BOXB + x * 128;
            wg::tma_load_3d(dst, &k_map, bar, cb * 64, row + x, h);
            wg::tma_load_3d(dst + NB * BOXB, &v_map, bar, cb * 64, row + x, h);
          }
        }
      }
    }
    if (QUANT) {
      const bool in = page >= 0 && lane < nk;
      const size_t tok = (size_t)h * T + row + lane;
      const uint32_t sc = st + 2 * KCH * DP;
      tile::cp_async4(sc + 4 * lane, in ? k_scale + tok : k_scale, in);
      tile::cp_async4(sc + 4 * (KCH + lane), in ? v_scale + tok : v_scale, in);
      cp_async_arrive(bar);
    }
  };

  // keys past a short chunk (a page of fewer than KCH keys, or a page
  // that ends mid-chunk) stay zeros in every stage, so a product over
  // them adds exactly 0; int8 chunks are widened with zeros there
  if (!QUANT && P % KCH != 0) {
    for (int e = lane; e < ns * STAGE / 16; e += 32) {
      *reinterpret_cast<uint4*>(ring + 16 * e) = make_uint4(0, 0, 0, 0);
    }
    wg::fence_proxy_async();
    __syncwarp();
  }
  for (int u = 0; u < min(ns, wk.n); ++u) issue(u);

  // the tile's Q fragments, one k16 step a KC
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int mi = lane >> 3;
    tile::ldsm_x4(qa[kc], q_t + tile::swz<DP>((mi & 1) * 8 + (lane & 7), 2 * kc + (mi >> 1)));
  }

  // the two rows this lane's fragments hold: query positions
  const int qpos_a = p0 + (rb0 + g8) % S;
  const int qpos_b = p0 + (rb0 + g8 + 8) % S;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  float oacc[NO][4];
  for (int u = 0; u < wk.n; ++u) {
    const Item it = item_of(wk, sp, u);
    if (it.first) {
      m_a = m_b = NEG_INF;
      l_a = l_b = 0.f;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
      }
    }
    wg::mbar_wait(bars + 8 * (u % ns), (u / ns) & 1);
    if (page_of(it.i) >= 0) {
      const int nk = min(KCH, P - it.c0);
      const unsigned char* st = ring + (u % ns) * STAGE;
      const float* sc = reinterpret_cast<const float*>(st + 2 * KCH * DP);
      uint32_t kt = tile::smem_addr(st);
      if (QUANT) {
        // widen the codes into the staging tile: lane = key row
        kt = staging;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          const int8_t* raw = reinterpret_cast<const int8_t*>(st + kv * KCH * DP) + lane * D;
#pragma unroll
          for (int c = 0; c < DP / 8; ++c) {
            uint32_t w[4] = {0u, 0u, 0u, 0u};
            if (lane < nk && 8 * c < D) {
              const uint2 codes = *reinterpret_cast<const uint2*>(raw + 8 * c);
              const int8_t* x = reinterpret_cast<const int8_t*>(&codes);
#pragma unroll
              for (int e = 0; e < 4; ++e) w[e] = tile::pack2<TQ>((float)x[2 * e], (float)x[2 * e + 1]);
            }
            *reinterpret_cast<uint4*>(smem + warp * STAGING + kv * NB * BOXB + (c / 8) * BOXB +
                                      tile::swz<64>(lane, c % 8)) = make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
        __syncwarp();
      }
      const uint32_t vt = kt + NB * BOXB;
      const int n16 = (nk + 15) / 16;  // 16-key blocks the chunk holds

      // S = Q.K^T: 4 n8 tiles of 8 keys
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          if (np < n16) {
            const int mi = lane >> 3;
            const int key = np * 16 + (mi >> 1) * 8 + (lane & 7);
            const int ch = 2 * kc + (mi & 1);
            uint32_t bf[4];
            tile::ldsm_x4(bf, kt + (ch / 8) * BOXB + tile::swz<64>(key, ch % 8));
            tile::mma<TQ>(s[2 * np], qa[kc], bf[0], bf[1]);
            tile::mma<TQ>(s[2 * np + 1], qa[kc], bf[2], bf[3]);
          }
        }
      }

      // scale, mask, online softmax on the fragments; only a chunk that
      // is not wholly visible to every query of the span runs the masks
      const int kbase = it.i * P + it.c0;
      const bool whole = nk == KCH && kbase + KCH - 1 <= p0 &&
                         (window <= 0 || kbase > p0 + S - 1 - window);
      uint32_t vis = 0xffffu;  // bit 4 j + e: element e of n8 tile j is visible
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t4 + (e & 1);
          float x = s[j][e];
          if (QUANT) x *= sc[key];
          x *= mult;
          if (!whole) {
            const bool v = key < nk && visible(kbase + key, e < 2 ? qpos_a : qpos_b, window);
            if (!v) {
              vis &= ~(1u << (4 * j + e));
              x = NEG_INF;
            }
          }
          s[j][e] = x;
          if (e < 2) mx_a = fmaxf(mx_a, x);
          else mx_b = fmaxf(mx_b, x);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = __expf(m_a - mn_a), al_b = __expf(m_b - mn_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool v = (vis >> (4 * j + e)) & 1u;
          const float p = v ? __expf(s[j][e] - (e < 2 ? mn_a : mn_b)) : 0.f;
          if (e < 2) sum_a += p;
          else sum_b += p;
          // P.V takes p times the key's v scale (int8): exact codes as V
          s[j][e] = QUANT ? p * sc[KCH + 8 * j + 2 * t4 + (e & 1)] : p;
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        sum_a += __shfl_xor_sync(FULL, sum_a, o);
        sum_b += __shfl_xor_sync(FULL, sum_b, o);
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        oacc[n][0] *= al_a;
        oacc[n][1] *= al_a;
        oacc[n][2] *= al_b;
        oacc[n][3] *= al_b;
      }

      // O += P.V, p (int8: p times the v scale) packed to q's type from
      // the accumulators as two 16-bit halves, hi = p rounded and lo = p -
      // hi, two products adding up to p to 16 more bits
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        if (kk < n16) {
          uint32_t pa[4], pl[4];
          {
            float lo[2][4];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float v = s[2 * kk + x][e];
                s[2 * kk + x][e] = round16<TQ>(v);
                lo[x][e] = v - s[2 * kk + x][e];
              }
            }
            tile::acc_to_a<TQ>(pl, lo[0], lo[1]);
          }
          tile::acc_to_a<TQ>(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
          for (int cp = 0; cp < DP / 16; ++cp) {
            const int mi = lane >> 3;
            const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
            const int ch = 2 * cp + (mi >> 1);
            uint32_t bf[4];
            tile::ldsm_x4_t(bf, vt + (ch / 8) * BOXB + tile::swz<64>(key, ch % 8));
            tile::mma<TQ>(oacc[2 * cp], pa, bf[0], bf[1]);
            tile::mma<TQ>(oacc[2 * cp + 1], pa, bf[2], bf[3]);
            tile::mma<TQ>(oacc[2 * cp], pl, bf[0], bf[1]);
            tile::mma<TQ>(oacc[2 * cp + 1], pl, bf[2], bf[3]);
          }
        }
      }
    }
    if (it.last) {  // park the group's partial: rows g8 and g8 + 8
      float* slot = reinterpret_cast<float*>(smem + lay.slots + (it.j * NW + warp) * SLOT);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int d = 8 * n + 2 * t4;
        *reinterpret_cast<float2*>(slot + g8 * DP + d) = make_float2(oacc[n][0], oacc[n][1]);
        *reinterpret_cast<float2*>(slot + (g8 + 8) * DP + d) = make_float2(oacc[n][2], oacc[n][3]);
      }
      if (t4 == 0) {
        slot[RT * DP + g8] = m_a;
        slot[RT * DP + g8 + 8] = m_b;
        slot[RT * DP + RT + g8] = l_a;
        slot[RT * DP + RT + g8 + 8] = l_b;
      }
    }
    __syncwarp();  // stage u % ns (and the staging tile) are free
    if (u + ns < wk.n) issue(u + ns);
  }

  block_sync(C);
  if (C > 1) {
    merge<TQ, RT, DP, MMA_GROUPS, true>(smem + lay.slots, wts, sp.ng, R, D, C, cshift + 2,
                                         rank, tid, out + row0 * D);
  } else {
    merge<TQ, RT, DP, MMA_GROUPS, false>(smem + lay.slots, wts, sp.ng, R, D, C, cshift + 2,
                                          rank, tid, out + row0 * D);
  }
  if (C > 1) cluster_sync();
}

// ------------------------------------------------------------------ host

// The cluster size: double it while the grid still fits the SMs and the
// row's groups (at most `groups`) still give every warp of the cluster
// one.
int cluster_size(long blocks, int groups, int sms) {
  int c = 1;
  while (c < MAX_CLUSTER && blocks * 2 * c <= sms && 2 * c * NW <= groups) c *= 2;
  return c;
}

int log2_of(int c) {  // c a power of two
  int k = 0;
  while ((1 << k) < c) ++k;
  return k;
}

// Once a device for one kernel: the shared-memory opt-in (to the most a
// block may have), the SM count and the blocks an SM holds by registers,
// cached in `sms` (the count times 256, plus the blocks).
template <typename K>
cudaError_t prepare(std::atomic<int> (&sms)[64], K kern, int* nsm, int* reg_blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int packed = sms[dev & 63].load();
  if (packed == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int rb = 65536 / (THREADS * (attr.numRegs > 0 ? attr.numRegs : 255));
    packed = n * 256 + (rb < 1 ? 1 : rb > 255 ? 255 : rb);
    sms[dev & 63].store(packed);
  }
  *nsm = packed / 256;
  *reg_blocks = packed % 256;
  return cudaSuccess;
}


template <typename K, typename... A>
cudaError_t launch_cluster(K kern, int C, int ntiles, int Hkv, int B, size_t smem,
                           cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv * ntiles, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;  // one block needs no cluster
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What a launch needs from the grid: the cluster size, each warp's most
// groups (its partial slots) and the ring depth: up to NSTAGE stages, never
// more than a warp's most chunks (the launcher takes stages off while the
// grid would not fit the SMs at once, where smaller blocks share an SM).
struct Plan {
  int C, nslot, ns;
};

Plan plan(long blocks, int ngmax, int W, int P, int sms) {
  Plan p;
  const int groups = W < ngmax ? W : ngmax;
  p.C = cluster_size(blocks, groups, sms);
  const int cw = p.C * NW;
  p.nslot = (groups + cw - 1) / cw;
  const int gp = (W + ngmax - 1) / ngmax;
  const int items = p.nslot * gp * ((P + KCH - 1) / KCH);
  p.ns = items < NSTAGE ? (items < 1 ? 1 : items) : NSTAGE;
  return p;
}

// Take ring stages off a plan while its blocks would not fit the SMs at
// once (or a block's shared memory at all); `lay_of(ns)` is the layout.
template <typename F>
void fit_stages(Plan& pl, long blocks, int nsm, int reg_blocks, F lay_of) {
  auto fits = [&](int ns) {
    const int smem = lay_of(ns).total;
    const int by_smem = SM_SMEM / (smem + 1024);
    const long per_sm = by_smem < reg_blocks ? by_smem : reg_blocks;
    return smem <= MAX_SMEM && blocks * pl.C <= nsm * per_sm;
  };
  while (pl.ns > 1 && !fits(pl.ns)) --pl.ns;
}

#define KFT_PAGED_PARAMS                                                                   \
  const void *q, const void *k, const void *v, const float *ks, const float *vs,           \
      const int *table, const int *pos0, void *out, int B, int H, int Hkv, int S, int D,   \
      int T, int P, int W, int window, float mult, cudaStream_t stream
#define KFT_PAGED_ARGS q, k, v, ks, vs, table, pos0, out, B, H, Hkv, S, D, T, P, W, window, mult, stream

template <typename TQ, typename TKV, bool QUANT, int DP>
cudaError_t launch_decode(KFT_PAGED_PARAMS) {
  auto kern = paged_attn_decode_kernel<TQ, TKV, QUANT, DP>;
  static std::atomic<int> sms[64];
  int nsm = 0, reg_blocks = 1;
  cudaError_t err = prepare(sms, kern, &nsm, &reg_blocks);
  if (err != cudaSuccess) return err;
  const int ntiles = (H / Hkv * S + DEC_ROWS - 1) / DEC_ROWS;
  const long blocks = (long)B * Hkv * ntiles;
  Plan pl = plan(blocks, DEC_GROUPS, W, P, nsm);
  auto lay_of = [&](int ns) {
    return layout(0, dec_stage(DP, sizeof(TKV)), dec_q(DP, sizeof(TKV)), NW * DEC_ROWS * KCH * 4,
                  slot_bytes(DEC_ROWS, DP), ns, pl.nslot, W);
  };
  fit_stages(pl, blocks, nsm, reg_blocks, lay_of);
  const Layout lay = lay_of(pl.ns);
  if (lay.total > MAX_SMEM) return cudaErrorInvalidValue;
  return launch_cluster(kern, pl.C, ntiles, Hkv, B, lay.total, stream,
                        static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                        static_cast<const TKV*>(v), ks, vs, table, pos0, static_cast<TQ*>(out),
                        H, Hkv, S, D, T, P, W, window, mult, ntiles, pl.ns, pl.nslot, T / P,
                        (P + KCH - 1) / KCH, log2_of(pl.C));
}

// A 16-bit pool as a (D, T, Hkv) tensor of 64 x kb boxes with the 128-byte
// swizzle, encoded once per (pool, shape) and kept in a small cache of the
// calling thread (a served model's 12 layers hold 24 pools).
struct PoolMap {
  const void* p;
  int type, hkv, t, d, kb;
  CUtensorMap map;
};

bool pool_map(const CUtensorMap** out, const void* p, bool f16, int Hkv, int T, int D, int kb) {
  constexpr int N = 64;
  thread_local PoolMap cache[N];
  thread_local int next = 0;
  const int type = f16 ? 1 : 2;
  for (int i = 0; i < N; ++i) {
    const PoolMap& e = cache[i];
    if (e.p == p && e.type == type && e.hkv == Hkv && e.t == T && e.d == D && e.kb == kb) {
      *out = &e.map;
      return true;
    }
  }
  const wg::EncodeTiledFn encode = wg::encode_tiled();
  if (encode == nullptr) return false;
  PoolMap& e = cache[next];
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)Hkv};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kb, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(&e.map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(p), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    e.p = nullptr;
    return false;
  }
  e.p = p;
  e.type = type;
  e.hkv = Hkv;
  e.t = T;
  e.d = D;
  e.kb = kb;
  next = (next + 1) % N;
  *out = &e.map;
  return true;
}

template <typename TQ, typename TKV, bool QUANT, int DP>
cudaError_t launch_mma(KFT_PAGED_PARAMS) {
  auto kern = paged_attn_mma_kernel<TQ, TKV, QUANT, DP>;
  static std::atomic<int> sms[64];
  int nsm = 0, reg_blocks = 1;
  cudaError_t err = prepare(sms, kern, &nsm, &reg_blocks);
  if (err != cudaSuccess) return err;
  // a TMA box's rows: the largest power of two up to KCH dividing P, so
  // every chunk is whole boxes that never reach the next page
  const int kb = (P & -P) < KCH ? (P & -P) : KCH;
  const CUtensorMap* km = nullptr;
  const CUtensorMap* vm = nullptr;
  CUtensorMap none = {};
  if (QUANT) {
    km = vm = &none;
  } else {
    const bool f16 = std::is_same<TQ, __half>::value;
    if (!pool_map(&km, k, f16, Hkv, T, D, kb) || !pool_map(&vm, v, f16, Hkv, T, D, kb)) {
      return cudaErrorInvalidValue;
    }
  }
  const int ntiles = (H / Hkv * S + MMA_ROWS - 1) / MMA_ROWS;
  const long blocks = (long)B * Hkv * ntiles;
  Plan pl = plan(blocks, MMA_GROUPS, W, P, nsm);
  auto lay_of = [&](int ns) {
    return layout(mma_staging(DP, QUANT), mma_stage(DP, QUANT), MMA_ROWS * DP * 2, 0,
                  slot_bytes(MMA_ROWS, DP), ns, pl.nslot, W);
  };
  fit_stages(pl, blocks, nsm, reg_blocks, lay_of);
  const Layout lay = lay_of(pl.ns);
  if (lay.total > MAX_SMEM) return cudaErrorInvalidValue;
  return launch_cluster(kern, pl.C, ntiles, Hkv, B, lay.total, stream, *km, *vm,
                        static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                        static_cast<const TKV*>(v), ks, vs, table, pos0, static_cast<TQ*>(out),
                        H, Hkv, S, D, T, P, W, window, mult, ntiles, pl.ns, pl.nslot, T / P,
                        (P + KCH - 1) / KCH, log2_of(pl.C), kb);
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch_decode_any(KFT_PAGED_PARAMS) {
  if (D <= 64) return launch_decode<TQ, TKV, QUANT, 64>(KFT_PAGED_ARGS);
  return launch_decode<TQ, TKV, QUANT, 128>(KFT_PAGED_ARGS);
}

template <typename TQ, typename TKV, bool QUANT>
cudaError_t launch_mma_any(KFT_PAGED_PARAMS) {
  if (D <= 64) return launch_mma<TQ, TKV, QUANT, 64>(KFT_PAGED_ARGS);
  return launch_mma<TQ, TKV, QUANT, 128>(KFT_PAGED_ARGS);
}

#undef KFT_PAGED_PARAMS
#undef KFT_PAGED_ARGS

}  // namespace

// The body that runs (mirrored by ops/paged_attention.py `body`): the
// tensor cores for bf16/f16 q at G * S > MMA_MIN_GS rows a kv head.
static bool mma_body(int q_dtype, int GS) {
  return (q_dtype == BF16 || q_dtype == F16) && GS > MMA_MIN_GS;
}

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
  if (!tile::aligned16(k_pool) || !tile::aligned16(v_pool)) {  // bulk copies and TMA
    return (int)cudaErrorMisalignedAddress;
  }
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* p0 = static_cast<const int*>(pos0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KFT_ARGS q, k_pool, v_pool, ks, vs, tb, p0, out, B, H, Hkv, S, D, T, P, W, window, mult, st
  cudaError_t err = cudaErrorInvalidValue;
  if (mma_body(q_dtype, H / Hkv * S)) {
    if (kv_dtype == I8) {
      if (q_dtype == BF16) err = launch_mma_any<__nv_bfloat16, int8_t, true>(KFT_ARGS);
      if (q_dtype == F16) err = launch_mma_any<__half, int8_t, true>(KFT_ARGS);
    } else if (kv_dtype == q_dtype) {
      if (q_dtype == BF16) err = launch_mma_any<__nv_bfloat16, __nv_bfloat16, false>(KFT_ARGS);
      if (q_dtype == F16) err = launch_mma_any<__half, __half, false>(KFT_ARGS);
    }
    return (int)err;
  }
  if (kv_dtype == I8) {
    if (q_dtype == F32) err = launch_decode_any<float, int8_t, true>(KFT_ARGS);
    if (q_dtype == BF16) err = launch_decode_any<__nv_bfloat16, int8_t, true>(KFT_ARGS);
    if (q_dtype == F16) err = launch_decode_any<__half, int8_t, true>(KFT_ARGS);
  } else if (kv_dtype == q_dtype) {
    if (q_dtype == F32) err = launch_decode_any<float, float, false>(KFT_ARGS);
    if (q_dtype == BF16) err = launch_decode_any<__nv_bfloat16, __nv_bfloat16, false>(KFT_ARGS);
    if (q_dtype == F16) err = launch_decode_any<__half, __half, false>(KFT_ARGS);
  }
#undef KFT_ARGS
  return (int)err;
}

extern "C" const char* kft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
