// Flash-attention forward in fp32 for Hopper, two kernels on the tensor
// cores in 3xTF32 that share their tile steps: non-causal (K1's fp32 form:
// the encoder's self-attention, the decoder's cross-attention with Tq !=
// Tk, and its no-max form), and end-aligned causal (K4's fp32 form: the
// decoder's self-attention over a full block, Tq == Tk).
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py `_fwd_kernel_single`
// (K1) and `_fwd_kernel` (K4) run on fp32 inputs (`_flash_fwd`), where the
// TPU kernel works in q's dtype from end to end: q scaled by the exact
// 1/sqrt(64) (`_scale_exact`), fp32 scores, P kept in fp32 for P V. O is
// fp32 and the LSE the natural-log fp32 logsumexp of each query row.
//
// What bounds it on the card: operations at the encoder's shape, bytes at
// the decoder's (see the causal kernel below). One non-causal call does
// 4*B*H*Tq*Tk*64 flops (184 GFLOP at the encoder's B=16, T=1500, 20 heads)
// over ~0.5 GB of fp32 q, k, v and O (0.15 ms at 3.35 TB/s). On fp32 FMAs
// that is 2.75 ms at 67 TFLOP/s (the first design ran every product as an
// FFMA, 6.98 ms on an H100 80GB HBM3 at 700 W). The tensor cores take fp32
// only as TF32 (a 10-bit mantissa: ~5.8e-4 relative error alone), so each
// product here is three TF32 products, a_hi b_hi + a_hi b_lo + a_lo b_hi,
// with a_hi the TF32 of a (rounded to nearest by an integer add and mask)
// and a_lo its exact fp32 residual, whose low 13 bits the tensor core
// drops: 3 x 184 GFLOP at the 495 TFLOP/s of dense TF32 is 1.12 ms, with
// the 0.17 ms of exponentials (16 a clock an SM) beside it.
//
// Design: the non-causal kernel is a persistent grid of one 384-thread CTA
// an SM that walks 128-query-row work items of (batch, head), (batch,
// head)-major so the CTAs in flight share K and V in L2. Warpgroup 0 is
// the producer: its 128 threads load each 64-key tile of K and V from
// device memory with float4 loads through the tensors' element strides (a
// fused qkv projection's column blocks go in without copies; zeros past
// Tk), split every value into its TF32 high part and residual, and store
// both into a 2-stage ring in the wgmma operand layouts (128-byte
// swizzled, K-major): K as 128 rows (the 64 high parts, then the 64
// residuals) of 64 dims, and V transposed, 64 dims by 64 keys, high parts
// and residuals apart (TF32 wgmma takes K-major operands only, so V^T is
// made here, not by a copy engine). Warpgroups 1 and 2 each own 64 query
// rows: each splits its Q rows once per work item into the same layout,
// then per key tile runs
//   S  = Q_hi [K_hi; K_lo]^T (one m64n128k8 chain: hi.hi | hi.lo)
//      + Q_lo K_hi^T (an m64n64k8 chain into the hi.hi half), halves added,
//   P  = the online softmax of S in log2 units (fp32, ex2 after one FFMA),
//   O  = O corr + (P_lo V_hi + P_hi V_lo + P_hi V_hi) (m64n64k8, P from
//        registers), the tile's P V in an accumulator of its own: the
//        tensor core drops bits at each add of its accumulator, and O
//        carried across the tiles there read up to 2.9e-5 from the twin
//        (rel-L2, Tk=4096; a tile's 24 adds keep it near 1e-6).
// The S accumulator holds keys 2t and 2t + 1 of each 8-key block where the
// TF32 A fragment wants keys t and t + 4, so the producer stores V^T's keys
// of each 8-key block in the order (0, 2, 4, 6, 1, 3, 5, 7): P V sums over
// keys, so the permuted product is the same sum. The two consumer
// warpgroups' products take turns at the tensor cores, so one's softmax
// runs under the other's wgmmas. No atomics: the output is bit-repeatable.
// Rows past Tq are computed on zeros and not stored; keys past Tk are -inf
// in the last tile.
//
// The no-max form (kNoMax; the JAX package's KWT_FA_NOMAX): a pre-pass
// (key_bound.cuh `key_norm_max`) writes max_j ||k_j|| of each (batch,
// head); each consumer takes its rows' norms from its Q loads, and each
// row's fixed shift m = ||q / 8|| * kmax replaces the running max: p = 2^(s
// log2(e) / 8 - m log2(e)) in one FFMA and ex2, no rescale, O = o / max(l,
// 1e-30) and the LSE m + ln max(l, 1e-30), as the TPU kernel divides.
//
// The causal kernel (K4's fp32 form) runs the same tile steps (`load_kv`,
// `store_kv`, `tile`: the split, S, the online softmax, P V apart) under
// the end-aligned mask (row i sees keys j <= i + Tk - Tq), one warpgroup
// a CTA: a CTA takes one 64-row query tile of one (batch, head), splits
// its Q once, and walks the 64-key tiles at or below its last row's
// bound (`causal_tiles`, ops/flash_attention.py `causal_tile_plan` at 64
// rows and 64 keys), masking only those past its first row's bound: it
// splits each tile's K and V^T into its one stage (96 KB of shared memory,
// 254 registers: two CTAs an SM), then runs the tile's products while the
// next tile's loads are in flight. The grid launches the query tiles with
// the most key tiles first, so the short ones fill the gaps. At the
// training decoder's B=8, T=128, 20 heads a call moves 21 MB (6.3 us at
// 3.35 TB/s) over 320 CTAs of one or two key tiles (one wave), 0.34 GFLOP
// of kept pairs, 1.0 as 3 TF32 products (2.0 us at 495 TFLOP/s): bytes
// and latency bound it. On an H100 80GB HBM3 at 700 W (`tools.kernel_time`,
// PERF.md §6) it reads 0.0126-0.0129 ms there; the first design, a
// CUDA-core kernel (a 256-thread CTA of 64 rows, Q and each K tile
// transposed in shared memory, 4 x 4 FFMA blocks, P through shared
// memory), 0.0273; the non-causal kernel with the causal mask on its
// 128-row items (the probe that `tools.kernel_time --k4-sweep` builds as
// a patch of this source: its 160 items take two rounds of 132 CTAs),
// 0.0171-0.0176.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "card.cuh"
#include "key_bound.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kD = 64;  // head dim
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- the kernel (3xTF32 wgmma) ---------------------------------------------------

constexpr int kTcRows = 64;                 // query rows a consumer warpgroup
constexpr int kTcWGs = 2;                   // consumer warpgroups
constexpr int kTcBM = kTcRows * kTcWGs;     // query rows a work item
constexpr int kTcBN = 64;                   // keys a tile (ops/flash_attention.py F32_TC_KEYS)
constexpr int kTcStages = 2;                // K/V ring depth
constexpr int kTcThreads = 128 * (kTcWGs + 1);
constexpr int kTcConsumers = 128 * kTcWGs;
constexpr int kBlk = 64 * 32;               // floats of a 64-row block of 32 columns (8 KB)

// Shared memory of the CTA, every operand tile 128-byte swizzled,
// K-major, in blocks of 32 columns (128-byte rows): each consumer's Q rows
// (high parts, residuals), and per stage K (a block: 64 rows of high parts,
// then 64 of residuals) and V^T (64 dim rows of 64 keys, high parts and
// residuals apart).
struct __align__(1024) TcSmem {
  float q[kTcWGs][2][2][kBlk];        // [warpgroup][hi, lo][dim block]
  float k[kTcStages][2][2 * kBlk];    // [stage][dim block][hi rows, lo rows]
  float vt[kTcStages][2][2][kBlk];    // [stage][hi, lo][key block]
  float n2[kTcBM];                    // the no-max form's squared row norms
  uint64_t full[kTcStages], empty[kTcStages];
};

// Shared memory of the causal kernel's CTA: one warpgroup's Q rows and one
// K / V^T stage, laid out as TcSmem's (96 KB: two CTAs an SM).
struct __align__(1024) CausalSmem {
  float q[2][2][kBlk];
  float k[2][2 * kBlk];
  float vt[2][2][kBlk];
};

// Descriptor of k-step ks (8 TF32 columns) of a swizzled operand at shared
// address `base` whose 32-column blocks lie `block_floats` apart.
__device__ __forceinline__ uint64_t tc_desc(uint32_t base, int ks, int block_floats) {
  return sw128_desc(base + (ks >> 2) * block_floats * 4 + (ks & 3) * 32, 16, 1024);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(acc[i]);
}

// The key tiles that query rows [r0, r0 + rows) visit under the end-aligned
// causal mask (row i sees keys j <= i + tk - tq), ascending from key 0:
// ops/flash_attention.py `causal_tile_plan(tq, tk, r0, rows, F32_TC_KEYS)`.
__device__ __forceinline__ int causal_tiles(int tq, int tk, int r0, int rows) {
  return min((tk + kTcBN - 1) / kTcBN, (min(r0 + rows, tq) - 1 + tk - tq) / kTcBN + 1);
}

// ---- the steps of a tile, each run by the 128 threads (tid) of a warpgroup --

// The 64-key tile at k0 of K and V, zeros past tk: K's float4 f is key f /
// 16, dims 4 (f % 16) ..; V's, warp w's 16 keys, two float4s of a key a
// lane pair.
__device__ __forceinline__ void load_kv(float4 (&kx)[8], float4 (&vx)[8], const float* kb,
                                        const float* vb, int k0, int tk, long ks_t, long vs_t,
                                        int tid) {
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = tid + 128 * i, key = k0 + (f >> 4);
    kx[i] = key < tk ? *reinterpret_cast<const float4*>(kb + key * ks_t + 4 * (f & 15))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    const int vkey = k0 + 16 * warp + (lane >> 1), vd = 4 * (2 * i + (lane & 1));
    vx[i] = vkey < tk ? *reinterpret_cast<const float4*>(vb + vkey * vs_t + vd)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// That tile split into TF32 high parts and residuals: K into k (per dim
// block 64 rows of high parts, then 64 of residuals), V transposed into vt
// ([hi, lo][key block]), its keys in `vt_pos` order.
__device__ __forceinline__ void store_kv(float* k, float* vt, const float4 (&kx)[8],
                                         const float4 (&vx)[8], int tid) {
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = tid + 128 * i, key = f >> 4, d4 = f & 15;
    float* blk = k + (d4 >> 3) * 2 * kBlk;
    const int at = swz(key, (d4 & 7) * 4);
    float4 hi, lo;
    split_tf32(kx[i].x, hi.x, lo.x);
    split_tf32(kx[i].y, hi.y, lo.y);
    split_tf32(kx[i].z, hi.z, lo.z);
    split_tf32(kx[i].w, hi.w, lo.w);
    *reinterpret_cast<float4*>(blk + at) = hi;
    *reinterpret_cast<float4*>(blk + kBlk + at) = lo;  // the residual rows 64 below
  }
  const int pos = vt_pos(16 * warp + (lane >> 1)), kblk = pos >> 5, col = pos & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d0 = 4 * (2 * i + (lane & 1));
    const float x[4] = {vx[i].x, vx[i].y, vx[i].z, vx[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float hi, lo;
      split_tf32(x[e], hi, lo);
      const int at = swz(d0 + e, col);
      vt[kblk * kBlk + at] = hi;
      vt[(2 + kblk) * kBlk + at] = lo;
    }
  }
}

// The 64 query rows at qrow0, zeros past tq: float4 f is row f / 16, dims
// 4 (f % 16) ..
__device__ __forceinline__ void load_q(float4 (&qx)[8], const float* qb, int qrow0, int tq,
                                       long qs_t, int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = tid + 128 * i, row = qrow0 + (f >> 4);
    qx[i] = row < tq ? *reinterpret_cast<const float4*>(qb + row * qs_t + 4 * (f & 15))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Those rows split into q ([hi, lo][dim block]).
__device__ __forceinline__ void store_q(float* q, const float4 (&qx)[8], int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = tid + 128 * i, row = f >> 4, d4 = f & 15;
    const int at = swz(row, (d4 & 7) * 4);
    float4 hi, lo;
    split_tf32(qx[i].x, hi.x, lo.x);
    split_tf32(qx[i].y, hi.y, lo.y);
    split_tf32(qx[i].z, hi.z, lo.z);
    split_tf32(qx[i].w, hi.w, lo.w);
    *reinterpret_cast<float4*>(q + (d4 >> 3) * kBlk + at) = hi;
    *reinterpret_cast<float4*>(q + (2 + (d4 >> 3)) * kBlk + at) = lo;
  }
}

// One key tile for the warpgroup's 64 rows (this thread's rows r0 = 16 warp
// + g and r0 + 8), qa, ka, va the shared addresses of its Q, K and V^T:
//   S  = Q_hi [K_hi; K_lo]^T (one m64n128k8 chain: hi.hi | hi.lo)
//      + Q_lo K_hi^T (an m64n64k8 chain into the hi.hi half), halves added;
// where `masked`, S's columns at or past `lim` (keys past tk) and past
// `last0` (+ 8 on row r0 + 8; keys past the row's causal bound) are -inf;
// the online softmax in log2 units (m_run, l_run; corr each row's rescale);
// otile = P_lo V_hi + P_hi V_lo + P_hi V_hi in an accumulator of its own.
// Returns with every product complete.
template <bool kNoMax>
__device__ __forceinline__ void tile(float (&otile)[32], float (&corr)[2], float (&m_run)[2],
                                     float (&l_run)[2], uint32_t qa, uint32_t ka, uint32_t va,
                                     bool masked, int lim, int last0) {
  constexpr float scale_log2 = 0.125f * kLog2e;  // 1/sqrt(64) * log2(e)
  // S: d[0..31] keys hi.hi (+ lo.hi), d[32..63] the same keys hi.lo
  float d[64];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks)
    wgmma_m64n128k8_tf32_ss(d, tc_desc(qa, ks, kBlk), tc_desc(ka, ks, 2 * kBlk), ks);
#pragma unroll
  for (int ks = 0; ks < kD / 8; ++ks)
    wgmma_m64n64k8_tf32_ss(d, tc_desc(qa + 4 * 2 * kBlk, ks, kBlk), tc_desc(ka, ks, 2 * kBlk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] += d[32 + i];

  if (masked) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * i + (e & 1);
        if (col >= lim || col > last0 + 8 * (e >> 1)) d[4 * i + e] = -INFINITY;
      }
  }
  // online softmax in log2 units: rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3)
  corr[0] = corr[1] = 1.f;
  if constexpr (!kNoMax) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(d[4 * i + 2 * r], d[4 * i + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx * scale_log2);
      corr[r] = ex2(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
  }
  // P, split: high parts in d[0..31], residuals in d[32..63]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(fmaf(d[i], scale_log2, -m_run[(i >> 1) & 1]));
    l_run[(i >> 1) & 1] += p;
    split_tf32(p, d[i], d[32 + i]);
  }
  // the tile's P V = P_lo V_hi + P_hi V_lo + P_hi V_hi, k-step ks over
  // keys 8ks ..: A fragment (t, t + 4) of rows g, g + 8 = accumulator
  // (2t, 2t + 1)
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kTcBN / 8; ++ks) {
    const uint32_t a_hi[4] = {__float_as_uint(d[4 * ks]), __float_as_uint(d[4 * ks + 2]),
                              __float_as_uint(d[4 * ks + 1]), __float_as_uint(d[4 * ks + 3])};
    const uint32_t a_lo[4] = {__float_as_uint(d[32 + 4 * ks]),
                              __float_as_uint(d[32 + 4 * ks + 2]),
                              __float_as_uint(d[32 + 4 * ks + 1]),
                              __float_as_uint(d[32 + 4 * ks + 3])};
    wgmma_m64n64k8_tf32_rs(otile, a_lo, tc_desc(va, ks, kBlk), ks);
    wgmma_m64n64k8_tf32_rs(otile, a_hi, tc_desc(va + 4 * 2 * kBlk, ks, kBlk), 1);
    wgmma_m64n64k8_tf32_rs(otile, a_hi, tc_desc(va, ks, kBlk), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(otile);
  fence_acc(d);
}

// O += the tile's P V, after the rescale, in one FFMA.
__device__ __forceinline__ void add_tile(float (&oacc)[32], const float (&otile)[32],
                                         const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = fmaf(oacc[i], corr[(i >> 1) & 1], otile[i]);
}

// Full row sums over the quad, O normalised and stored, the LSE (natural
// log) stored; rows past tq are not stored.
template <bool kNoMax>
__device__ __forceinline__ void epilogue(float* o, float* lse, const float (&oacc)[32],
                                         const float (&m_run)[2], const float (&l_run)[2], int b,
                                         int h, int n_heads, int tq, int row0, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= tq) continue;
    if constexpr (kNoMax) l = fmaxf(l, 1e-30f);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* dst = o + (((long)b * tq + row) * n_heads + h) * kD + 2 * t4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(oacc[4 * i + 2 * r] * inv, oacc[4 * i + 2 * r + 1] * inv);
    if (t4 == 0) lse[((long)b * n_heads + h) * tq + row] = (m_run[r] + log2f(l)) * kLn2;
  }
}

// ---- the non-causal kernel ------------------------------------------------------

template <bool kNoMax>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_fwd_f32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, const float* __restrict__ kmax, int tq,
                            int tk, int n_heads, int n_qtiles, int n_work, long qs_b, long qs_t,
                            long qs_h, long ks_b, long ks_t, long ks_h, long vs_b, long vs_t,
                            long vs_h) {
  extern __shared__ uint8_t smem_raw[];
  TcSmem& s =
      *reinterpret_cast<TcSmem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid >> 5, lane = tid & 31;
  const int n_kt = (tk + kTcBN - 1) / kTcBN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kTcStages; ++i) {
      mbar_init(&s.full[i], 128);
      mbar_init(&s.empty[i], kTcConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V tiles, split, into the ring ----------------------
    uint32_t it = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int bh = w / n_qtiles, b = bh / n_heads, h = bh - b * n_heads;
      const float* kb = k + b * ks_b + h * ks_h;
      const float* vb = v + b * vs_b + h * vs_h;
      for (int j = 0; j < n_kt; ++j, ++it) {
        const int st = it % kTcStages;
        float4 kx[8], vx[8];
        load_kv(kx, vx, kb, vb, j * kTcBN, tk, ks_t, vs_t, tid);
        mbar_wait(&s.empty[st], ((it / kTcStages) & 1) ^ 1);
        store_kv(s.k[st][0], s.vt[st][0][0], kx, vx, tid);
        fence_proxy_async_smem();
        mbar_arrive(&s.full[st]);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each -----------------------------------------
  const int c = wg - 1;
  const int g = lane >> 2, t4 = lane & 3;
  uint32_t it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int bh = w / n_qtiles, b = bh / n_heads, h = bh - b * n_heads;
    const int qrow0 = (w - bh * n_qtiles) * kTcBM + c * kTcRows;
    float4 qx[8];
    load_q(qx, q + b * qs_b + h * qs_h, qrow0, tq, qs_t, tid);
    named_bar_sync(1 + c, 128);  // the previous work item's products have read Q
    store_q(s.q[c][0][0], qx, tid);
    if constexpr (kNoMax) {  // each row's squared norm over its 16 lanes
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float n2 = qx[i].x * qx[i].x + qx[i].y * qx[i].y + qx[i].z * qx[i].z + qx[i].w * qx[i].w;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, off);
        if ((lane & 15) == 0) s.n2[c * kTcRows + ((tid + 128 * i) >> 4)] = n2;
      }
    }
    fence_proxy_async_smem();
    named_bar_sync(1 + c, 128);

    // this thread's rows: r0 = 16 warp + g and r0 + 8 of the warpgroup's 64
    const int r0 = 16 * warp + g;
    float m_run[2] = {-INFINITY, -INFINITY};  // log2 units
    float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
    if constexpr (kNoMax) {
      const float bound = kmax[bh] * (0.125f * kLog2e);
      m_run[0] = sqrtf(s.n2[c * kTcRows + r0]) * bound;
      m_run[1] = sqrtf(s.n2[c * kTcRows + r0 + 8]) * bound;
    }
    // O in fp32 registers; each tile's P V in its own accumulator (a
    // tile's 24 adds on the tensor core, not the call's), added with the
    // rescale in one FFMA
    float oacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[i] = 0.f;

    for (int j = 0; j < n_kt; ++j, ++it) {
      const int st = it % kTcStages;
      // the operands' shared addresses, opaque to the compiler so that it
      // builds each descriptor where it issues it, not all of them ahead
      uint32_t qa = smem_u32(s.q[c][0][0]), ka = smem_u32(s.k[st][0]),
               va = smem_u32(s.vt[st][0][0]);
      asm volatile("" : "+r"(qa), "+r"(ka), "+r"(va));
      mbar_wait(&s.full[st], (it / kTcStages) & 1);
      // keys of the tile's last, ragged block past tk are -inf
      const bool ragged = j == n_kt - 1 && tk % kTcBN != 0;
      float otile[32], corr[2];
      tile<kNoMax>(otile, corr, m_run, l_run, qa, ka, va, ragged,
                   ragged ? tk - j * kTcBN - 2 * t4 : kTcBN, kTcBN);
      mbar_arrive(&s.empty[st]);
      add_tile(oacc, otile, corr);
    }
    epilogue<kNoMax>(o, lse, oacc, m_run, l_run, b, h, n_heads, tq, qrow0 + r0, t4);
  }
}

// ---- the causal kernel (K4's fp32 form) -------------------------------------

// One warpgroup a CTA, two CTAs an SM, one 64-row query tile of one (batch,
// head) a CTA, the tiles with the most key tiles first (blockIdx.x / n_bh
// counts query tiles down from the last), so that the short ones fill the
// gaps; per key tile at or below its last row's bound: the tile's K and V
// split into the one stage, then its products, while the next tile's
// loads are in flight.
__global__ void __launch_bounds__(128, 2)
    flash_fwd_f32_causal_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, float* __restrict__ o,
                                float* __restrict__ lse, int tq, int tk, int n_heads, int n_bh,
                                long qs_b, long qs_t, long qs_h, long ks_b, long ks_t, long ks_h,
                                long vs_b, long vs_t, long vs_h) {
  extern __shared__ uint8_t smem_raw[];
  CausalSmem& s =
      *reinterpret_cast<CausalSmem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_qt = (tq + kTcRows - 1) / kTcRows;
  const int bh = blockIdx.x % n_bh, b = bh / n_heads, h = bh - b * n_heads;
  const int qrow0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * kTcRows;
  const float* kb = k + b * ks_b + h * ks_h;
  const float* vb = v + b * vs_b + h * vs_h;
  const int n_kt = (tk + kTcBN - 1) / kTcBN;
  const int n_mine = causal_tiles(tq, tk, qrow0, kTcRows);
  const int n_free = min(n_mine, (qrow0 + tk - tq + 1) / kTcBN);

  float4 qx[8], kx[8], vx[8];
  load_q(qx, q + b * qs_b + h * qs_h, qrow0, tq, qs_t, tid);
  load_kv(kx, vx, kb, vb, 0, tk, ks_t, vs_t, tid);
  store_q(s.q[0][0], qx, tid);

  const int r0 = 16 * warp + g;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  for (int j = 0; j < n_mine; ++j) {
    __syncthreads();  // the previous tile's products have read K and V^T
    store_kv(s.k[0], s.vt[0][0], kx, vx, tid);
    fence_proxy_async_smem();
    __syncthreads();
    if (j + 1 < n_mine) load_kv(kx, vx, kb, vb, (j + 1) * kTcBN, tk, ks_t, vs_t, tid);
    uint32_t qa = smem_u32(s.q[0][0]), ka = smem_u32(s.k[0]), va = smem_u32(s.vt[0][0]);
    asm volatile("" : "+r"(qa), "+r"(ka), "+r"(va));
    const bool ragged = j == n_kt - 1 && tk % kTcBN != 0;
    float otile[32], corr[2];
    tile<false>(otile, corr, m_run, l_run, qa, ka, va, ragged || j >= n_free,
                ragged ? tk - j * kTcBN - 2 * t4 : kTcBN,
                qrow0 + r0 + tk - tq - j * kTcBN - 2 * t4);
    add_tile(oacc, otile, corr);
  }
  epilogue<false>(o, lse, oacc, m_run, l_run, b, h, n_heads, tq, qrow0 + r0, t4);
}

// The launches of either C entry, on the card it entered: kmax non-null
// takes the no-max form (plan[14] != 0) after the key-bound pre-pass; a
// causal call (plan[4] != 0) the causal kernel.
int launch(int card, const void* q, const void* k, const void* v, void* o, void* lse,
           float* kmax, const long long* plan, void* stream) {
  const int batch = static_cast<int>(plan[0]), tq = static_cast<int>(plan[1]);
  const int tk = static_cast<int>(plan[2]), n_heads = static_cast<int>(plan[3]);
  const bool causal = plan[4] != 0, no_max = plan[14] != 0;
  if (no_max != (kmax != nullptr) || (no_max && causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = plan + 5;
  constexpr int tc_smem = static_cast<int>(sizeof(TcSmem)) + 1024;  // + alignment slack
  constexpr int causal_smem = static_cast<int>(sizeof(CausalSmem)) + 1024;
  // per card: its SM count, set once the kernels' shared-memory limits are
  // raised there
  static int n_sms_of[kwt_card::kMaxCards] = {};
  int& n_sms = n_sms_of[card];
  if (n_sms == 0) {
    using Kernel = decltype(&flash_fwd_f32_tc_kernel<false>);
    const Kernel kernels[] = {flash_fwd_f32_tc_kernel<false>, flash_fwd_f32_tc_kernel<true>};
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_causal_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, causal_smem);
    for (const Kernel kernel : kernels)
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc_smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, card);
    if (e != cudaSuccess) {
      n_sms = 0;  // try again on the next call
      return static_cast<int>(e);
    }
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (causal) {
    const int n_bh = batch * n_heads;
    flash_fwd_f32_causal_kernel<<<(tq + kTcRows - 1) / kTcRows * n_bh, 128, causal_smem, cs>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), static_cast<float*>(lse), tq, tk, n_heads, n_bh, st[0], st[1],
        st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
    return static_cast<int>(cudaGetLastError());
  }
  if (no_max) {
    kwt_key_bound::key_norm_max<float><<<batch * n_heads, kwt_key_bound::kThreads, 0, cs>>>(
        static_cast<const float*>(k), kmax, tk, n_heads, st[3], st[4], st[5]);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_qtiles = (tq + kTcBM - 1) / kTcBM;
  const int n_work = n_qtiles * batch * n_heads;
  auto kernel = no_max ? flash_fwd_f32_tc_kernel<true> : flash_fwd_f32_tc_kernel<false>;
  kernel<<<n_work < n_sms ? n_work : n_sms, kTcThreads, tc_smem, cs>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), kmax, tq, tk, n_heads, n_qtiles, n_work,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Tq, H, 64), k and v (B, Tk, H, 64) fp32, each read through its own
// element strides; plan: B, Tq, Tk, H, causal, then the batch, token and
// head element strides of q, k and v (multiples of 4, the head dim
// contiguous; ops/flash_attention.py `_f32_plan`), then no_max (0 here).
// o (B, Tq, H, 64) and lse (B, H, Tq) fp32, contiguous. Returns the
// launch's cudaError_t.
extern "C" int kwt_flash_attention_f32(int card, const void* q, const void* k, const void* v,
                                       void* o, void* lse, const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  return launch(card, q, k, v, o, lse, nullptr, plan, stream);
}

// The no-max form: as kwt_flash_attention_f32 with plan[14] != 0 and no
// causal mask; kmax (B, H) fp32 takes the key-bound pre-pass's output.
extern "C" int kwt_flash_attention_f32_nomax(int card, const void* q, const void* k,
                                             const void* v, void* o, void* lse, void* kmax,
                                             const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  if (kmax == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(card, q, k, v, o, lse, static_cast<float*>(kmax), plan, stream);
}
