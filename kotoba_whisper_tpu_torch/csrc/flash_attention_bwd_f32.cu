// Flash-attention backward in fp32 for Hopper (K5's fp32 form), causal
// (the decoder's self-attention, end-aligned) and non-causal (its
// cross-attention, Tq != Tk).
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py `_bwd_dq_kernel`
// (:315) and `_bwd_dkv_kernel` (:385) run on fp32 inputs through
// `_flash_bwd` (:581), where the TPU kernels work in their inputs' dtype:
// q scaled by the exact 1/sqrt(64), fp32 scores, P = exp(s - LSE) from the
// forward's natural-log LSE, dP = dO V^T, dS = P (dP - D) with D =
// rowsum(dO * O), and P and dS kept in fp32 for dV = P^T dO, dK = dS^T
// (q / 8) and dQ = dS K / 8. The bf16 form (flash_attention_bwd.cu) rounds
// P and dS to bf16 before their products, as the TPU kernels do in bf16;
// in fp32 there is nothing to round.
//
// What bounds it on the card: at the training cross shape (B=8, 20 heads,
// Tq=128, Tk=1500) operations: the products over the kept (query, key)
// pairs, 2*B*H*Tq*Tk*64 flops each (3.9 GFLOP), each run as three TF32
// products (below): the five of the JAX split's arithmetic are 0.119 ms at
// the 495 TFLOP/s of dense TF32, the seven this form runs (S and dP in both
// kernels) 0.167 ms, over ~0.27 GB of fp32 tensors (0.08 ms at 3.35 TB/s);
// at the causal shape (T=128) bytes, ~42 MB of fp32 tensors (12.5 us) over
// 0.34 GFLOP of kept pairs (5.1 us at fp32 FMA).
//
// Design: two forms, neither with atomics, so every output is the same
// from run to run; ops/flash_attention.py `bwd_f32_cluster` picks the form.
// Both run their products on the tensor cores as 3xTF32: each fp32 operand
// is a TF32 high part (rounded to nearest) plus its residual, and a b =
// a_lo b_hi + a_hi b_lo + a_hi b_hi drops only a_lo b_lo (~2^-22
// relative), which keeps the fp32 parity the form exists for (TF32 alone,
// a 10-bit mantissa, would not).
//
// The causal form (`bwd_f32_causal_kernel`: the decoder's self-attention,
// at most 8 key tiles, Tk <= 512) is one launch. The earlier design (the
// split form's FFMA kernels for causal calls too) read 0.1255 ms on the
// card at B=8, T=128, 1.42x the memory-efficient SDPA backward. Now a
// cluster of one 256-thread CTA per 64-key tile per (batch, head) (160
// clusters of 2 at T=128, 96 KB each: two an SM): each CTA computes S and
// dP once a (query tile, key tile) pair, keeps dK and dV in registers, and
// the query tile's dQ is summed from the CTAs' shares through distributed
// shared memory, in rank order, by the CTA that owns the tile (rounds of
// one query tile, two cluster barriers each). D = rowsum(dO * O) is taken
// as dO is copied in, so no pre-pass. Its products are mma.sync (m16n8k8);
// the tiles sit XOR-swizzled in shared memory so that every fragment read
// is free of bank conflicts.
//
// The split form (the cross-attention call, and a causal call past 8 key
// tiles) is the JAX package's split on warpgroup wgmma: TF32 mma.sync
// issues at ~16 cycles an m16n8k8 a partition, so 3xTF32 there costs what
// fp32 FFMAs do (the first design ran every product as an FFMA, 1.378 ms
// at the cross shape on an H100 80GB HBM3 at 700 W; the SDPA backward read
// 1.315). Launches:
//  1. `bwd_f32_prepass`: D = rowsum(dO * O) in fp32 and the LSE, both as
//     (B*H, Tq padded to 128) rows; padded rows get D = 0 and LSE = +inf,
//     so exp(s - LSE) = 0 there. The LSE stays in natural-log units (the
//     fp32 K1/K4 write it so, flash_attention_f32.cu) and P is expf(s -
//     LSE), the twin's exp of the same fp32 difference.
//  2. `bwd_tc_dq_kernel` (query-major): dQ over (batch-head, 128 rows, key
//     part) items, S and dP per 32-key tile, dQ += dS K.
//  3. `bwd_tc_dkv_kernel` (key-major): dK and dV over (batch-head, 128
//     keys) items, S^T and dP^T per 32-row chunk, dV += P^T dO, dK += dS^T
//     (Q / 8).
//  4. With more than one key part, `dq_sum_kernel` sums the parts' dQ in
//     part order. dQ of a 128-row tile sums over every key (1500 at the
//     cross shape): one item a tile would be 160 items of ~60 us on 132
//     SMs, two rounds; cut into key parts (`bwd_f32_dq_parts`: 3 at the
//     cross shape, 480 items) the rounds are short and the grid balanced,
//     and the parts' sum in a fixed order keeps dQ bit-repeatable (the
//     bf16 form's L2 reduce-adds would not).
// Both main kernels are persistent grids of one 384-thread CTA an SM:
// warpgroup 0 loads the walked tensor's tiles (K and V, or Q and dO) with
// float4 loads through the tensors' strides, splits every value and stores
// the B operands (TF32 wgmma takes both operands K-major, so the
// transposes K^T, Q^T and dO^T are made here, their rows in `vt_pos` order
// so that an accumulator is the next product's A fragment) into a ring;
// consumer warpgroups 1 and 2 each own 64 rows of the item and keep one of
// their A operands as resident TF32 fragments in registers (Q / 8, or K:
// no shared-memory bandwidth spent on it) and the other split in shared
// memory (dO, or V). P and dS (or P^T and dS^T) are computed from the
// accumulators in registers and fed, split, to the next products as A
// fragments. dQ sums each tile's dS K, and dK and dV each chunk's dS^T
// (Q / 8) and P^T dO, in an accumulator of its own (12 adds), added to the
// item's sums by FADD: the tensor core drops bits at each add to its
// accumulator (K1's fp32 form read 2.9e-5 from its twin carrying a sum
// over ~1500 adds; dK/dV at Tq = 1500 would take 564). The consumers'
// products take turns at the tensor cores. Keys past Tk and rows past Tq
// read as zeros; keys past Tk and, causal, keys past a row's bound j <= i
// + Tk - Tq get P = 0.
// Tensors keep the model's (B, T, H, 64) layout, read through per-tensor
// element strides (multiples of 4: float4 loads), so a fused projection's
// column blocks go in without copies; dQ is written contiguous (B, Tq, H,
// 64), dK and dV as one contiguous (2, B, Tk, H, 64).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "card.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kT = 64;         // query rows of a query tile, keys of a key tile
constexpr int kThreads = 256;  // the causal form's CTA, the pre-pass's and the dQ sum's blocks

// Element strides of one (B, T, H, 64) tensor.
struct Layout {
  long long b, t, h;
};

__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// ---- the split form: D pre-pass, dQ and dK/dV kernels on 3xTF32 wgmma -------

using kwt_sm90::split_tf32;  // TF32 high part and exact residual
using kwt_sm90::swz;
using kwt_sm90::vt_pos;

constexpr int kBlk = 64 * 32;      // floats of a 64-row block of 32 columns (8 KB)
constexpr int kHalfBlk = 32 * 32;  // floats of a 32-row block of 32 columns (4 KB)
constexpr int kTcThreads = 384;    // a producer warpgroup and two consumer warpgroups
constexpr int kTcConsumers = 256;
constexpr int kDqRows = 128;       // query rows of a dQ work item (ops/flash_attention.py
                                   // BWD_F32_DQ_ROWS), 64 a consumer
constexpr int kDqKeys = 32;        // keys of a dQ tile (BWD_F32_DQ_KEYS)
constexpr int kDqStages = 3;
constexpr int kDkvKeys = 128;      // keys of a dK/dV work item (BWD_F32_DKV_KEYS), 64 a consumer
constexpr int kDkvRows = 32;       // query rows of a dK/dV chunk (BWD_F32_DKV_ROWS)
constexpr int kDkvStages = 2;

// Shared memory of the dQ CTA, every operand 128-byte swizzled and K-major,
// in blocks of 32 columns: each consumer's 64 rows of dO (the A operand of
// dP = dO V^T); per stage a 32-key tile of K and of V by key (the B
// operands of S and dP) and K^T (64 dims by the tile's keys in `vt_pos`
// order, the B operand of dQ = dS K), high parts and residuals apart.
struct __align__(1024) DqSmem {
  float dout[2][2][2][kBlk];           // [warpgroup][hi, lo][dim block]
  float k[kDqStages][2][2][kHalfBlk];  // [stage][hi, lo][dim block]
  float v[kDqStages][2][2][kHalfBlk];
  float kt[kDqStages][2][kBlk];        // [stage][hi, lo]
  uint64_t full[kDqStages], empty[kDqStages];
};

// Shared memory of the dK/dV CTA: each consumer's 64 keys of V (the A
// operand of dP^T = V dO^T); per stage a 32-row chunk of Q / 8 and of dO
// by row (the B operands of S^T and dP^T), their transposes, 64 dims by the
// chunk's rows in `vt_pos` order (the B operands of dK = dS^T (Q / 8) and
// dV = P^T dO), and the rows' LSE and D.
struct __align__(1024) DkvSmem {
  float v[2][2][2][kBlk];               // [warpgroup][hi, lo][dim block]
  float q[kDkvStages][2][2][kHalfBlk];  // [stage][hi, lo][dim block]
  float dout[kDkvStages][2][2][kHalfBlk];
  float qt[kDkvStages][2][kBlk];        // [stage][hi, lo]
  float dot[kDkvStages][2][kBlk];
  float lse[kDkvStages][kDkvRows], delta[kDkvStages][kDkvRows];
  uint64_t full[kDkvStages], empty[kDkvStages];
};
// each with 1 KB of alignment slack within the 227 KB a block may use
static_assert(sizeof(DqSmem) + 1024 <= 232448, "the dQ CTA's shared memory fits a block");
static_assert(sizeof(DkvSmem) + 1024 <= 232448, "the dK/dV CTA's shared memory fits a block");

// Descriptor of k-step ks (8 TF32 columns) of a swizzled K-major operand at
// shared address `base` whose 32-column blocks lie `blk` floats apart.
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int ks, int blk) {
  return kwt_sm90::sw128_desc(base + (ks >> 2) * blk * 4 + (ks & 3) * 32, 16, 1024);
}

// x (columns c4 .. c4 + 3 of row `row`) times `scale`, split, into a [row][64]
// operand of two 32-column blocks `blk` floats apart: high parts at hi,
// residuals at lo.
__device__ __forceinline__ void put_row(float* hi, float* lo, int blk, int row, int c4, float4 x,
                                        float scale) {
  float4 h, l;
  split_tf32(x.x * scale, h.x, l.x);
  split_tf32(x.y * scale, h.y, l.y);
  split_tf32(x.z * scale, h.z, l.z);
  split_tf32(x.w * scale, h.w, l.w);
  const int at = (c4 >> 5) * blk + swz(row, c4 & 31);
  *reinterpret_cast<float4*>(hi + at) = h;
  *reinterpret_cast<float4*>(lo + at) = l;
}
// The same values transposed: (row, c4 + e) to [c4 + e][vt_pos(row)] of a
// block of 64 rows of 32 columns.
__device__ __forceinline__ void put_col(float* hi, float* lo, int row, int c4, float4 x,
                                        float scale) {
  const int pos = vt_pos(row);
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float h, l;
    split_tf32(v[e] * scale, h, l);
    hi[swz(c4 + e, pos)] = h;
    lo[swz(c4 + e, pos)] = l;
  }
}

// Rows [r0, r0 + 32) of a (B, T, H, 64) tensor at `base` (zeros past t) as a
// producer thread loads them: row r0 + 8 warp + lane % 8, columns 4 (lane /
// 8) + 16 i, so that a warp's loads read 64 contiguous bytes of each of 8
// rows and its transposed stores meet at most two to a bank.
__device__ __forceinline__ void load_rows32(float4* x, const float* base, long long s_t, int r0,
                                            int t, int tid) {
  const int row = r0 + 8 * (tid >> 5) + (tid & 7), c0 = 4 * ((tid & 31) >> 3);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = row < t ? *reinterpret_cast<const float4*>(base + row * s_t + c0 + 16 * i)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Rows [r0, r0 + 64) of a (B, T, H, 64) tensor at `base` (zeros past t),
// split, into a consumer's [row][64] operand (two 8 KB blocks a part): 16
// threads a row, eight float4s a thread, all loaded before any is stored.
__device__ __forceinline__ void load_rows64(float* hi, float* lo, const float* base, long long s_t,
                                            int r0, int t, int tid) {
  float4 x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = tid + 128 * i, row = r0 + (f >> 4);
    x[i] = row < t ? *reinterpret_cast<const float4*>(base + row * s_t + 4 * (f & 15))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = tid + 128 * i;
    put_row(hi, lo, kBlk, f >> 4, 4 * (f & 15), x[i], 1.f);
  }
}

// The resident A fragments of a consumer's 64 rows of a (B, T, H, 64)
// tensor (times `scale`, zeros past t), split: k-step ks holds rows g, g + 8
// of the warp's 16 at columns 8 ks + t and 8 ks + t + 4.
__device__ __forceinline__ void load_frags(uint32_t (*hi)[4], uint32_t (*lo)[4], const float* base,
                                           long long s_t, int ra, int t, int t4, float scale) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = ra + 8 * (j & 1), col = 8 * ks + t4 + 4 * (j >> 1);
      split_tf32(row < t ? base[row * s_t + col] * scale : 0.f, hi[ks][j], lo[ks][j]);
    }
}

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) kwt_sm90::fence_reg(r[i]);
}

// The A fragment of k-step ks from an m64n32 accumulator's values (the
// columns 8 ks .. in `vt_pos` order): (2t, 2t + 1) of rows g, g + 8 as (t, t + 4).
__device__ __forceinline__ void acc_frag(const float* v, int ks, uint32_t* a) {
  a[0] = __float_as_uint(v[4 * ks]);
  a[1] = __float_as_uint(v[4 * ks + 2]);
  a[2] = __float_as_uint(v[4 * ks + 1]);
  a[3] = __float_as_uint(v[4 * ks + 3]);
}

// D and the padded LSE: 16 threads a (batch, head, row) unit, one float4
// of O and of dO each, the sum over the half-warp; rows past Tq get D = 0
// and LSE = +inf, so exp(s - LSE) = 0 there.
__global__ void __launch_bounds__(kThreads)
    bwd_f32_prepass(const float* __restrict__ o, const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ lse_pad,
                    float* __restrict__ delta, int batch, int tq, int tq_pad, int n_heads, Layout lo,
                    Layout ldo) {
  const long long n_units = (long long)batch * n_heads * tq_pad;
  const long long n_threads = (long long)gridDim.x * blockDim.x;
  const int sub = threadIdx.x & 15;
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  for (long long u = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 4; u < n_units;
       u += n_threads >> 4) {
    const int row = (int)(u % tq_pad);
    const long long bh = u / tq_pad;
    const int b = (int)(bh / n_heads), h = (int)(bh % n_heads);
    float s = 0.f;
    if (row < tq) {
      const float4 a =
          *reinterpret_cast<const float4*>(o + b * lo.b + row * lo.t + h * lo.h + 4 * sub);
      const float4 c =
          *reinterpret_cast<const float4*>(dout + b * ldo.b + row * ldo.t + h * ldo.h + 4 * sub);
      s = a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(half, s, off);
    if (sub == 0) {
      delta[u] = s;
      lse_pad[u] = row < tq ? lse[bh * tq + row] : INFINITY;
    }
  }
}

// The 32-key tiles [j0, j1) the dQ work item (batch-head bh, 128-row tile
// qt, key part `part` of n_parts) walks: the part's share of the tiles
// (ceil(n_kt / n_parts) each), causal only those at or below the tile's last
// row's bound (ops/flash_attention.py `bwd_f32_dq_tiles`).
__device__ __forceinline__ void dq_tiles(int qt, int part, int n_parts, int tq, int tk,
                                         bool causal, int& j0, int& j1) {
  const int n_kt = (tk + kDqKeys - 1) / kDqKeys, per = (n_kt + n_parts - 1) / n_parts;
  int n = n_kt;
  if (causal) n = min(n, (min((qt + 1) * kDqRows, tq) - 1 + tk - tq) / kDqKeys + 1);
  j0 = part * per;
  j1 = min(j0 + per, n);
}

// dQ: a persistent grid of one CTA an SM over work items (batch-head, 128
// query rows, key part), parts fastest. Warpgroup 0 loads each 32-key tile
// of K and V, splits it and stores K, V and K^T into a 3-stage ring;
// consumer c owns rows [64c, 64c + 64) of the item: Q / 8 as resident A
// fragments in registers, dO in shared memory. Per tile S = (Q / 8) K^T and
// dP = dO V^T (m64n32k8, three products each, the small terms first), P =
// exp(S - LSE) masked, dS = P (dP - D), then the tile's dS K (m64n64k8, dS
// as A fragments from registers) in an accumulator of its own, added to the
// item's fp32 sum. The item's dQ / 8 goes to dq (one part) or to its part's
// slice of `parts`, summed in part order by `dq_sum_kernel`.
template <bool kCausal>
__global__ void __launch_bounds__(kTcThreads, 1)
    bwd_tc_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse_pad, const float* __restrict__ delta,
                     float* __restrict__ out, int tq, int tk, int tq_pad, int n_heads, int n_qt,
                     int n_parts, int n_work, long long part_elems, Layout lq, Layout lk, Layout lv,
                     Layout ldo) {
  using namespace kwt_sm90;
  extern __shared__ uint8_t smem_raw[];
  DqSmem& s = *reinterpret_cast<DqSmem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDqStages; ++i) {
      mbar_init(&s.full[i], 128);
      mbar_init(&s.empty[i], kTcConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: K and V tiles, split, into the ring ------------------------
    setmaxnreg_dec<56>();
    uint32_t it = 0;
    const int key_l = 8 * (tid >> 5) + (tid & 7), c0 = 4 * ((tid & 31) >> 3);
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int part = w % n_parts, rest = w / n_parts, qt = rest % n_qt, bh = rest / n_qt;
      const int b = bh / n_heads, h = bh - b * n_heads;
      const float* kb = k + b * lk.b + h * lk.h;
      const float* vb = v + b * lv.b + h * lv.h;
      int j0, j1;
      dq_tiles(qt, part, n_parts, tq, tk, kCausal, j0, j1);
      for (int j = j0; j < j1; ++j, ++it) {
        const int st = it % kDqStages;
        float4 kx[4], vx[4];
        load_rows32(kx, kb, lk.t, j * kDqKeys, tk, tid);
        load_rows32(vx, vb, lv.t, j * kDqKeys, tk, tid);
        mbar_wait(&s.empty[st], ((it / kDqStages) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          put_row(s.k[st][0][0], s.k[st][1][0], kHalfBlk, key_l, c0 + 16 * i, kx[i], 1.f);
          put_row(s.v[st][0][0], s.v[st][1][0], kHalfBlk, key_l, c0 + 16 * i, vx[i], 1.f);
          put_col(s.kt[st][0], s.kt[st][1], key_l, c0 + 16 * i, kx[i], 1.f);
        }
        fence_proxy_async_smem();
        mbar_arrive(&s.full[st]);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each --------------------------------------------
  setmaxnreg_inc<224>();
  const int c = wg - 1, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int offset = tk - tq;  // causal: row i sees keys j <= i + offset
  const uint32_t do_hi = smem_u32(s.dout[c][0][0]), do_lo = smem_u32(s.dout[c][1][0]);
  uint32_t it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int part = w % n_parts, rest = w / n_parts, qt = rest % n_qt, bh = rest / n_qt;
    const int b = bh / n_heads, h = bh - b * n_heads;
    const int r0 = qt * kDqRows + 64 * c, ra = r0 + 16 * warp + g;  // rows ra and ra + 8
    const float* qb = q + b * lq.b + h * lq.h;
    uint32_t qh[8][4], ql[8][4];
    load_frags(qh, ql, qb, lq.t, ra, tq, t4, 0.125f);
    const float lse_r[2] = {lse_pad[(long long)bh * tq_pad + ra],
                            lse_pad[(long long)bh * tq_pad + ra + 8]};
    const float d_r[2] = {delta[(long long)bh * tq_pad + ra], delta[(long long)bh * tq_pad + ra + 8]};
    named_bar_sync(1 + c, 128);  // the previous item's products have read dO
    load_rows64(s.dout[c][0][0], s.dout[c][1][0], dout + b * ldo.b + h * ldo.h, ldo.t, r0, tq,
                tid);
    fence_proxy_async_smem();
    named_bar_sync(1 + c, 128);

    int j0, j1;
    dq_tiles(qt, part, n_parts, tq, tk, kCausal, j0, j1);
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;
    for (int j = j0; j < j1; ++j, ++it) {
      const int st = it % kDqStages;
      // the stage's shared addresses, opaque to the compiler so that it
      // builds each descriptor where it issues it
      uint32_t ka = smem_u32(s.k[st][0][0]), va = smem_u32(s.v[st][0][0]),
               kta = smem_u32(s.kt[st][0]);
      asm volatile("" : "+r"(ka), "+r"(va), "+r"(kta));
      mbar_wait(&s.full[st], (it / kDqStages) & 1);
      float sc[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {  // S = (Q / 8) K^T: lo.hi, hi.lo, hi.hi
        wgmma_m64n32k8_tf32_rs(sc, ql[ks], kdesc(ka, ks, kHalfBlk), ks);
        wgmma_m64n32k8_tf32_rs(sc, qh[ks], kdesc(ka + 8 * kHalfBlk, ks, kHalfBlk), 1);
        wgmma_m64n32k8_tf32_rs(sc, qh[ks], kdesc(ka, ks, kHalfBlk), 1);
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {  // dP = dO V^T
        wgmma_m64n32k8_tf32_ss(dp, kdesc(do_lo, ks, kBlk), kdesc(va, ks, kHalfBlk), ks);
        wgmma_m64n32k8_tf32_ss(dp, kdesc(do_hi, ks, kBlk), kdesc(va + 8 * kHalfBlk, ks, kHalfBlk),
                               1);
        wgmma_m64n32k8_tf32_ss(dp, kdesc(do_hi, ks, kBlk), kdesc(va, ks, kHalfBlk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(sc);
      fence_all(dp);
      // accumulator 4i + e: row ra + 8 (e / 2), key j 32 + 8i + 2 t4 + e % 2
      float dsh[16], dsl[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1, key = j * kDqKeys + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const bool in = key < tk && (!kCausal || key <= ra + 8 * r + offset);
        const float p = in ? expf(sc[i] - lse_r[r]) : 0.f;
        split_tf32(p * (dp[i] - d_r[r]), dsh[i], dsl[i]);
      }
      // the tile's dS K: lo.hi, hi.lo, hi.hi over its 32 keys
      float dqt[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kDqKeys / 8; ++ks) {
        uint32_t ah[4], al[4];
        acc_frag(dsh, ks, ah);
        acc_frag(dsl, ks, al);
        wgmma_m64n64k8_tf32_rs(dqt, al, kdesc(kta, ks, kBlk), ks);
        wgmma_m64n64k8_tf32_rs(dqt, ah, kdesc(kta + 4 * kBlk, ks, kBlk), 1);
        wgmma_m64n64k8_tf32_rs(dqt, ah, kdesc(kta, ks, kBlk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(dqt);
      fence_all(dsh);
      fence_all(dsl);
      mbar_arrive(&s.empty[st]);
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] += dqt[i];
    }

    // accumulator 4i + e: row ra + 8 (e / 2), dims 8i + 2 t4 ..
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row >= tq) continue;
      float* dst =
          out + part * part_elems + (((long long)b * tq + row) * n_heads + h) * kD + 2 * t4;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(dst + 8 * i) =
            make_float2(dq[4 * i + 2 * r] * 0.125f, dq[4 * i + 2 * r + 1] * 0.125f);
    }
  }
}

// The first 32-row chunk the dK/dV work item of keys [k0, k0 + 128) walks
// (to the last): 0, or causal the chunk of the first row that sees key k0
// (ops/flash_attention.py `bwd_f32_dkv_first_chunk`).
__device__ __forceinline__ int dkv_first_chunk(int k0, int tq, int tk, bool causal) {
  return causal ? max(k0 - (tk - tq), 0) / kDkvRows : 0;
}

// dK and dV: a persistent grid of one CTA an SM over work items (batch-head,
// 128 keys). Warpgroup 0 loads each 32-row chunk of Q and dO (and the rows'
// LSE and D), splits it and stores Q / 8, dO and their transposes into a
// 2-stage ring; consumer c owns keys [64c, 64c + 64) of the item: K as
// resident A fragments in registers, V in shared memory. Per chunk S^T = K
// (Q / 8)^T and dP^T = V dO^T (m64n32k8), P^T = exp(S^T - LSE) masked, dS^T
// = P^T (dP^T - D), then the chunk's P^T dO and dS^T (Q / 8) (m64n64k8, P^T
// and dS^T as A fragments from registers), each in a fresh accumulator of
// 12 adds, one after the other (one accumulator's registers), added to dV
// and dK by FADD: carried in the tensor core's accumulator over the chunks,
// the sums would take 12 truncating adds a chunk, 564 at Tq = 1500.
template <bool kCausal>
__global__ void __launch_bounds__(kTcThreads, 1)
    bwd_tc_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse_pad, const float* __restrict__ delta,
                      float* __restrict__ dkv, int batch, int tq, int tk, int tq_pad, int n_heads,
                      int n_kb, int n_work, Layout lq, Layout lk, Layout lv, Layout ldo) {
  using namespace kwt_sm90;
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& s =
      *reinterpret_cast<DkvSmem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_qc = (tq + kDkvRows - 1) / kDkvRows;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDkvStages; ++i) {
      mbar_init(&s.full[i], 128);
      mbar_init(&s.empty[i], kTcConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: Q and dO chunks, split, into the ring ----------------------
    setmaxnreg_dec<56>();
    uint32_t it = 0;
    const int row_l = 8 * (tid >> 5) + (tid & 7), c0 = 4 * ((tid & 31) >> 3);
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const int kb = w % n_kb, bh = w / n_kb, b = bh / n_heads, h = bh - b * n_heads;
      const float* qb = q + b * lq.b + h * lq.h;
      const float* dob = dout + b * ldo.b + h * ldo.h;
      for (int qc = dkv_first_chunk(kb * kDkvKeys, tq, tk, kCausal); qc < n_qc; ++qc, ++it) {
        const int st = it % kDkvStages, r0 = qc * kDkvRows;
        float4 qx[4], dx[4];
        load_rows32(qx, qb, lq.t, r0, tq, tid);
        load_rows32(dx, dob, ldo.t, r0, tq, tid);
        // rows < tq_pad: padded rows read LSE = +inf and D = 0
        const float lse_v = tid < kDkvRows ? lse_pad[(long long)bh * tq_pad + r0 + tid] : 0.f;
        const float d_v = tid < kDkvRows ? delta[(long long)bh * tq_pad + r0 + tid] : 0.f;
        mbar_wait(&s.empty[st], ((it / kDkvStages) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          put_row(s.q[st][0][0], s.q[st][1][0], kHalfBlk, row_l, c0 + 16 * i, qx[i], 0.125f);
          put_row(s.dout[st][0][0], s.dout[st][1][0], kHalfBlk, row_l, c0 + 16 * i, dx[i], 1.f);
          put_col(s.qt[st][0], s.qt[st][1], row_l, c0 + 16 * i, qx[i], 0.125f);
          put_col(s.dot[st][0], s.dot[st][1], row_l, c0 + 16 * i, dx[i], 1.f);
        }
        if (tid < kDkvRows) {
          s.lse[st][tid] = lse_v;
          s.delta[st][tid] = d_v;
        }
        fence_proxy_async_smem();
        mbar_arrive(&s.full[st]);
      }
    }
    return;
  }

  // ---- consumers: 64 keys each ----------------------------------------------------
  setmaxnreg_inc<224>();
  const int c = wg - 1, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int offset = tk - tq;
  const uint32_t v_hi = smem_u32(s.v[c][0][0]), v_lo = smem_u32(s.v[c][1][0]);
  const long long half = (long long)batch * tk * n_heads * kD;  // dV's offset in dkv
  uint32_t it = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int kb = w % n_kb, bh = w / n_kb, b = bh / n_heads, h = bh - b * n_heads;
    const int k0 = kb * kDkvKeys + 64 * c, ka = k0 + 16 * warp + g;  // keys ka and ka + 8
    uint32_t kh[8][4], kl[8][4];
    load_frags(kh, kl, k + b * lk.b + h * lk.h, lk.t, ka, tk, t4, 1.f);
    named_bar_sync(1 + c, 128);  // the previous item's products have read V
    load_rows64(s.v[c][0][0], s.v[c][1][0], v + b * lv.b + h * lv.h, lv.t, k0, tk, tid);
    fence_proxy_async_smem();
    named_bar_sync(1 + c, 128);

    float dv[32], dk[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[i] = dk[i] = 0.f;
    for (int qc = dkv_first_chunk(kb * kDkvKeys, tq, tk, kCausal); qc < n_qc; ++qc, ++it) {
      const int st = it % kDkvStages;
      uint32_t qa = smem_u32(s.q[st][0][0]), da = smem_u32(s.dout[st][0][0]),
               qta = smem_u32(s.qt[st][0]), dta = smem_u32(s.dot[st][0]);
      asm volatile("" : "+r"(qa), "+r"(da), "+r"(qta), "+r"(dta));
      mbar_wait(&s.full[st], (it / kDkvStages) & 1);
      float sc[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {  // S^T = K (Q / 8)^T: lo.hi, hi.lo, hi.hi
        wgmma_m64n32k8_tf32_rs(sc, kl[ks], kdesc(qa, ks, kHalfBlk), ks);
        wgmma_m64n32k8_tf32_rs(sc, kh[ks], kdesc(qa + 8 * kHalfBlk, ks, kHalfBlk), 1);
        wgmma_m64n32k8_tf32_rs(sc, kh[ks], kdesc(qa, ks, kHalfBlk), 1);
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {  // dP^T = V dO^T
        wgmma_m64n32k8_tf32_ss(dp, kdesc(v_lo, ks, kBlk), kdesc(da, ks, kHalfBlk), ks);
        wgmma_m64n32k8_tf32_ss(dp, kdesc(v_hi, ks, kBlk), kdesc(da + 8 * kHalfBlk, ks, kHalfBlk),
                               1);
        wgmma_m64n32k8_tf32_ss(dp, kdesc(v_hi, ks, kBlk), kdesc(da, ks, kHalfBlk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(sc);
      fence_all(dp);
      // accumulator 4i + e: key ka + 8 (e / 2), row qc 32 + 8i + 2 t4 + e % 2
      float ph[16], pl[16], ds[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int rl = 8 * (i >> 2) + 2 * t4 + (i & 1), key = ka + 8 * ((i >> 1) & 1);
        const bool in = key < tk && (!kCausal || key <= qc * kDkvRows + rl + offset);
        const float p = in ? expf(sc[i] - s.lse[st][rl]) : 0.f;
        split_tf32(p, ph[i], pl[i]);
        ds[i] = p * (dp[i] - s.delta[st][rl]);
      }
      // the chunk's P^T dO, then its dS^T (Q / 8), over its 32 rows, each in
      // a fresh accumulator (12 truncating adds) added to dV and dK by FADD
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kDkvRows / 8; ++ks) {
        uint32_t ah[4], al[4];
        acc_frag(ph, ks, ah);
        acc_frag(pl, ks, al);
        wgmma_m64n64k8_tf32_rs(acc, al, kdesc(dta, ks, kBlk), ks);
        wgmma_m64n64k8_tf32_rs(acc, ah, kdesc(dta + 4 * kBlk, ks, kBlk), 1);
        wgmma_m64n64k8_tf32_rs(acc, ah, kdesc(dta, ks, kBlk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(ph);
      fence_all(pl);
#pragma unroll
      for (int i = 0; i < 32; ++i) dv[i] += acc[i];
      float dsh[16], dsl[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) split_tf32(ds[i], dsh[i], dsl[i]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kDkvRows / 8; ++ks) {
        uint32_t ah[4], al[4];
        acc_frag(dsh, ks, ah);
        acc_frag(dsl, ks, al);
        wgmma_m64n64k8_tf32_rs(acc, al, kdesc(qta, ks, kBlk), ks);
        wgmma_m64n64k8_tf32_rs(acc, ah, kdesc(qta + 4 * kBlk, ks, kBlk), 1);
        wgmma_m64n64k8_tf32_rs(acc, ah, kdesc(qta, ks, kBlk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_all(acc);
      fence_all(dsh);
      fence_all(dsl);
      mbar_arrive(&s.empty[st]);
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] += acc[i];
    }

    // accumulator 4i + e: key ka + 8 (e / 2), dims 8i + 2 t4 ..
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = ka + 8 * r;
      if (key >= tk) continue;
      float* dst = dkv + (((long long)b * tk + key) * n_heads + h) * kD + 2 * t4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<float2*>(dst + 8 * i) =
            make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
        *reinterpret_cast<float2*>(dst + half + 8 * i) =
            make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

// dq = the parts' dQ / 8 summed in part order (float4s, a grid-stride loop).
__global__ void __launch_bounds__(kThreads)
    dq_sum_kernel(const float4* __restrict__ parts, float4* __restrict__ dq, long long n4,
                  int n_parts) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 sum = parts[i];
    for (int p = 1; p < n_parts; ++p) {
      const float4 x = parts[p * n4 + i];
      sum.x += x.x, sum.y += x.y, sum.z += x.z, sum.w += x.w;
    }
    dq[i] = sum;
  }
}

// ---- the causal form: one launch, a cluster of key tiles a (batch, head) ---

constexpr int kMaxCluster = 8;  // key tiles of a causal call (ops/flash_attention.py
                                // BWD_F32_MAX_CLUSTER)

// Row r, column c of a 64 x 64 fp32 tile in shared memory: rows of 64
// floats, columns XOR-swizzled by r so that the mma fragments' reads, 8
// rows x 4 columns and 4 rows x 8 columns, each hit 32 banks; a 4-aligned
// group of columns stays together (float2 and float4 accesses).
__device__ __forceinline__ int at(int r, int c) { return r * kD + (c ^ (((r & 3) << 3) | (r & 4))); }

struct CausalSmem {
  float k[kT * kD];     // K of the CTA's 64 keys, [key][d]
  float v[kT * kD];     // V
  float q[kT * kD];     // Q of the round's query tile, times 1/8, [row][d]
  float dout[kT * kD];  // dO, [row][d]
  float pt[kT * kT];    // P^T, [key][row]; then this CTA's share of dQ, [row][d]
  float dst[kT * kT];   // dS^T, [key][row]
  float lse[kT], delta[kT];
};

// c (16 x 8) += a (16 x 8) b (8 x 8) on the tensor cores in TF32.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms first.
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah, const uint32_t* al,
                                     const uint32_t* bh, const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// mma.sync m16n8k8 fragments (g = lane / 4, t = lane % 4), split: A (16 x
// 8) rows m0 + g (+8), columns k0 + t (+4); B (8 x 8) rows k0 + t (+4),
// column n0 + g. `mk`: the tile holds the operand as [m][k] (or [n][k]);
// `km`: as [k][m] (or [k][n]).
__device__ __forceinline__ void frag_a_mk(const float* s, int m0, int k0, int g, int t,
                                          uint32_t* hi, uint32_t* lo) {
  split_tf32(s[at(m0 + g, k0 + t)], hi[0], lo[0]);
  split_tf32(s[at(m0 + g + 8, k0 + t)], hi[1], lo[1]);
  split_tf32(s[at(m0 + g, k0 + t + 4)], hi[2], lo[2]);
  split_tf32(s[at(m0 + g + 8, k0 + t + 4)], hi[3], lo[3]);
}
__device__ __forceinline__ void frag_a_km(const float* s, int m0, int k0, int g, int t,
                                          uint32_t* hi, uint32_t* lo) {
  split_tf32(s[at(k0 + t, m0 + g)], hi[0], lo[0]);
  split_tf32(s[at(k0 + t, m0 + g + 8)], hi[1], lo[1]);
  split_tf32(s[at(k0 + t + 4, m0 + g)], hi[2], lo[2]);
  split_tf32(s[at(k0 + t + 4, m0 + g + 8)], hi[3], lo[3]);
}
__device__ __forceinline__ void frag_b_nk(const float* s, int n0, int k0, int g, int t,
                                          uint32_t* hi, uint32_t* lo) {
  split_tf32(s[at(n0 + g, k0 + t)], hi[0], lo[0]);
  split_tf32(s[at(n0 + g, k0 + t + 4)], hi[1], lo[1]);
}
__device__ __forceinline__ void frag_b_kn(const float* s, int n0, int k0, int g, int t,
                                          uint32_t* hi, uint32_t* lo) {
  split_tf32(s[at(k0 + t, n0 + g)], hi[0], lo[0]);
  split_tf32(s[at(k0 + t + 4, n0 + g)], hi[1], lo[1]);
}

// Rows [r0, r0 + 64) of a (B, T, H, 64) tensor at (b, h), zeros past t:
// this thread's four float4s (16 threads a row), loaded before any is
// stored, so that a tile's loads, and those of tiles loaded together, are
// in flight at once; then stored into a swizzled tile, times `scale`.
constexpr int kPerThread = kT * kD / 4 / kThreads;
__device__ __forceinline__ void load_tile(float4* x, const float* base, long long s_t, int r0,
                                          int t) {
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i >> 4, c = (i & 15) * 4;
    x[it] = r0 + r < t ? *reinterpret_cast<const float4*>(base + (r0 + r) * s_t + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}
__device__ __forceinline__ void store_tile(float* dst, const float4* x, float scale) {
#pragma unroll
  for (int it = 0; it < kPerThread; ++it) {
    const int i = threadIdx.x + it * kThreads;
    *reinterpret_cast<float4*>(dst + at(i >> 4, (i & 15) * 4)) =
        make_float4(x[it].x * scale, x[it].y * scale, x[it].z * scale, x[it].w * scale);
  }
}

// Cluster barrier halves, and a float4 of another CTA's shared memory.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float4 ld_cluster4(const float* p, uint32_t rank) {
  uint32_t addr;
  float4 x;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// The causal form. A cluster of n_kt CTAs per (batch, head); CTA c (its
// rank) owns keys [64c, 64c + 64) and walks the query tiles in rounds, one
// a round, those from the first whose rows see one of its keys: S^T =
// K (Q / 8)^T and dP^T = V dO^T (keys 16wm.., rows 32wn.. of warp (wm,
// wn)), P^T = exp(S^T - LSE) and dS^T = P^T (dP^T - D) to shared memory,
// then dV += P^T dO, dK += dS^T (Q / 8) (keys 16wm.., dims 32wn..) and its
// share of the tile's dQ, dS K (rows 16wm.., dims 32wn..), in place of P^T.
// After a cluster barrier CTA r, the tile's owner, sums the shares of the
// CTAs that took the round, in rank order, through distributed shared
// memory and writes dQ / 8; a second barrier (waited for before P^T is
// written again) frees the shares. A round's Q, dO and O are loaded
// together (three tiles in flight), and D = rowsum(dO * O) is taken from
// those registers. Every product is 3xTF32 mma.sync.
__global__ void __launch_bounds__(kThreads, 2)
    bwd_f32_causal_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ o,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ dq, float* __restrict__ dkv, int batch, int tq,
                          int tk, int n_heads, Layout lq, Layout lk, Layout lv, Layout ldo,
                          Layout lo) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  CausalSmem& s = *reinterpret_cast<CausalSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 16 rows of M, 32 columns of N
  const int rank = blockIdx.x, n_kt = gridDim.x, h = blockIdx.y, b = blockIdx.z;
  const int k0 = rank * kT, offset = tk - tq, n_qt = (tq + kT - 1) / kT;
  const long long bh = (long long)b * n_heads + h;
  const float* qb = q + b * lq.b + h * lq.h;
  const float* dob = dout + b * ldo.b + h * ldo.h;
  const float* ob = o + b * lo.b + h * lo.h;

  {
    float4 xk[kPerThread], xv[kPerThread];
    load_tile(xk, k + b * lk.b + h * lk.h, lk.t, k0, tk);
    load_tile(xv, v + b * lv.b + h * lv.h, lv.t, k0, tk);
    store_tile(s.k, xk, 1.f);
    store_tile(s.v, xv, 1.f);
  }
  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  bool pending = false;  // a release of the shares whose wait is still to come

  for (int r = 0; r < n_qt; ++r) {
    const int r0 = r * kT;
    // this CTA takes the round where a row of the tile sees its first key
    const bool part = max(k0 - offset, 0) / kT <= r;
    float sc[4][4], dp[4][4];
    if (part) {
      float4 xq[kPerThread], xd[kPerThread], xo[kPerThread];  // Q, dO and O, all in flight
      load_tile(xq, qb, lq.t, r0, tq);
      load_tile(xd, dob, ldo.t, r0, tq);
      load_tile(xo, ob, lo.t, r0, tq);
      const float lse_r = tid < kT && r0 + tid < tq ? lse[bh * tq + r0 + tid] : 0.f;
      __syncthreads();  // the last round's products have read Q and dO
      store_tile(s.q, xq, 0.125f);
      store_tile(s.dout, xd, 1.f);
#pragma unroll
      for (int it = 0; it < kPerThread; ++it) {  // D = rowsum(dO * O) over each row's 16 lanes
        float d = xd[it].x * xo[it].x + xd[it].y * xo[it].y + xd[it].z * xo[it].z +
                  xd[it].w * xo[it].w;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if ((tid & 15) == 0) s.delta[(tid + it * kThreads) >> 4] = d;
      }
      if (tid < kT) s.lse[tid] = lse_r;
      __syncthreads();

      zero(sc);
      zero(dp);
#pragma unroll 2
      for (int kk = 0; kk < kD; kk += 8) {
        uint32_t akh[4], akl[4], avh[4], avl[4];
        frag_a_mk(s.k, 16 * wm, kk, g, t4, akh, akl);
        frag_a_mk(s.v, 16 * wm, kk, g, t4, avh, avl);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bh_[2], bl_[2];
          frag_b_nk(s.q, 32 * wn + 8 * nt, kk, g, t4, bh_, bl_);
          mma3(sc[nt], akh, akl, bh_, bl_);
          frag_b_nk(s.dout, 32 * wn + 8 * nt, kk, g, t4, bh_, bl_);
          mma3(dp[nt], avh, avl, bh_, bl_);
        }
      }
    }
    if (pending) cluster_wait_acquire();  // the last round's owner has read this CTA's share
    pending = false;
    if (part) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int kl = 16 * wm + g + 8 * hf, rl = 32 * wn + 8 * nt + 2 * t4;
          const int key = k0 + kl;
          float p[2], ds[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int row = r0 + rl + j;
            const bool in = key < tk && row < tq && key <= row + offset;
            p[j] = in ? expf(sc[nt][2 * hf + j] - s.lse[rl + j]) : 0.f;
            ds[j] = p[j] * (dp[nt][2 * hf + j] - s.delta[rl + j]);
          }
          *reinterpret_cast<float2*>(s.pt + at(kl, rl)) = make_float2(p[0], p[1]);
          *reinterpret_cast<float2*>(s.dst + at(kl, rl)) = make_float2(ds[0], ds[1]);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T (Q / 8): keys 16wm.., dims 32wn.., over the rows
#pragma unroll 2
      for (int kk = 0; kk < kT; kk += 8) {
        uint32_t aph[4], apl[4], ash[4], asl[4];
        frag_a_mk(s.pt, 16 * wm, kk, g, t4, aph, apl);
        frag_a_mk(s.dst, 16 * wm, kk, g, t4, ash, asl);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bh_[2], bl_[2];
          frag_b_kn(s.dout, 32 * wn + 8 * nt, kk, g, t4, bh_, bl_);
          mma3(dv[nt], aph, apl, bh_, bl_);
          frag_b_kn(s.q, 32 * wn + 8 * nt, kk, g, t4, bh_, bl_);
          mma3(dk[nt], ash, asl, bh_, bl_);
        }
      }
      // this CTA's share of dQ: dS K, rows 16wm.., dims 32wn.., over its keys
      float dqs[4][4];
      zero(dqs);
#pragma unroll 2
      for (int kk = 0; kk < kT; kk += 8) {
        uint32_t ah[4], al[4];
        frag_a_km(s.dst, 16 * wm, kk, g, t4, ah, al);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bh_[2], bl_[2];
          frag_b_kn(s.k, 32 * wn + 8 * nt, kk, g, t4, bh_, bl_);
          mma3(dqs[nt], ah, al, bh_, bl_);
        }
      }
      __syncthreads();  // every warp has read P^T
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(s.pt + at(16 * wm + g + 8 * hf, 32 * wn + 8 * nt + 2 * t4)) =
              make_float2(dqs[nt][2 * hf], dqs[nt][2 * hf + 1]);
    }
    cluster_arrive_release();
    cluster_wait_acquire();  // every share of tile r is in its CTA's shared memory
    if (rank == r) {
      // each source's four float4s in flight at once, the sources in rank order
      float4 sum[kPerThread];
#pragma unroll
      for (int it = 0; it < kPerThread; ++it) sum[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int src = 0; src < n_kt; ++src) {
        if (max(src * kT - offset, 0) / kT > r) continue;  // it did not take the round
        float4 x[kPerThread];
#pragma unroll
        for (int it = 0; it < kPerThread; ++it) {
          const int i = tid + it * kThreads;
          x[it] = ld_cluster4(s.pt + at(i >> 4, (i & 15) * 4), src);
        }
#pragma unroll
        for (int it = 0; it < kPerThread; ++it)
          sum[it].x += x[it].x, sum[it].y += x[it].y, sum[it].z += x[it].z, sum[it].w += x[it].w;
      }
#pragma unroll
      for (int it = 0; it < kPerThread; ++it) {
        const int i = tid + it * kThreads;
        const int rr = i >> 4, c = (i & 15) * 4;
        if (r0 + rr < tq)
          *reinterpret_cast<float4*>(dq + (((long long)b * tq + r0 + rr) * n_heads + h) * kD + c) =
              make_float4(sum[it].x * 0.125f, sum[it].y * 0.125f, sum[it].z * 0.125f,
                          sum[it].w * 0.125f);
      }
    }
    cluster_arrive_release();
    pending = true;
  }

  const long long half = (long long)batch * tk * n_heads * kD;  // dV's offset in dkv
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = k0 + 16 * wm + g + 8 * hf;
      if (key >= tk) continue;
      const long long at_ =
          (((long long)b * tk + key) * n_heads + h) * kD + 32 * wn + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(dkv + at_) = make_float2(dk[nt][2 * hf], dk[nt][2 * hf + 1]);
      *reinterpret_cast<float2*>(dkv + half + at_) =
          make_float2(dv[nt][2 * hf], dv[nt][2 * hf + 1]);
    }
  if (pending) cluster_wait_acquire();  // no CTA leaves while its share may be read
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// q (B, Tq, H, 64), k and v (B, Tk, H, 64), o and dout (B, Tq, H, 64) fp32,
// each read through its own element strides, lse (B, H, Tq) fp32
// contiguous (natural log). plan (ops/flash_attention.py `_bwd_f32_plan`):
// B, Tq, Tk, H, causal, then the batch, token and head element strides of
// q, k, v, dout and o (multiples of 4, the head dim contiguous), then the
// form: 1 the causal cluster form (causal, at most kMaxCluster key tiles),
// 0 the split form, then the split form's dQ key parts. dq (B, Tq, H, 64)
// and dkv (2, B, Tk, H, 64) fp32 contiguous; scratch (the split form's): 2
// * B * H * Tq padded to 128 floats (the padded LSE, then D), then with
// more than one part each part's dQ (B, Tq, H, 64). One launch (the causal
// cluster form) or three, four with parts (the split form: the pre-pass,
// dQ, dK/dV, the parts' sum) on `stream`; returns the first failing
// launch's cudaError_t.
extern "C" int kwt_flash_attention_bwd_f32(int card, const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* dq, void* dkv, void* scratch,
                                           const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  const int batch = static_cast<int>(plan[0]), tq = static_cast<int>(plan[1]);
  const int tk = static_cast<int>(plan[2]), n_heads = static_cast<int>(plan[3]);
  const bool causal = plan[4] != 0, cluster = plan[20] != 0;
  const int n_parts = static_cast<int>(plan[21]);
  const long long* st = plan + 5;
  const Layout lq{st[0], st[1], st[2]}, lk{st[3], st[4], st[5]}, lv{st[6], st[7], st[8]};
  const Layout ldo{st[9], st[10], st[11]}, lo{st[12], st[13], st[14]};
  constexpr int causal_smem = static_cast<int>(sizeof(CausalSmem));
  constexpr int dq_smem = static_cast<int>(sizeof(DqSmem)) + 1024;  // + alignment slack
  constexpr int dkv_smem = static_cast<int>(sizeof(DkvSmem)) + 1024;
  // per card: its SM count, set once the kernels' shared-memory limits are
  // raised there
  static int n_sms_of[kwt_card::kMaxCards] = {};
  int& n_sms = n_sms_of[card];
  if (n_sms == 0) {
    cudaError_t e = allow_smem(bwd_f32_causal_kernel, causal_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_tc_dq_kernel<false>, dq_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_tc_dq_kernel<true>, dq_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_tc_dkv_kernel<false>, dkv_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_tc_dkv_kernel<true>, dkv_smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, card);
    if (e != cudaSuccess) {
      n_sms = 0;  // try again on the next call
      return static_cast<int>(e);
    }
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int n_kt = (tk + kT - 1) / kT;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);

  if (cluster) {
    if (!causal || n_kt > kMaxCluster || tq > tk) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_kt, n_heads, batch);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = causal_smem;
    cfg.stream = cs;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_kt;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, bwd_f32_causal_kernel, qf, kf, vf, static_cast<const float*>(o), df,
        static_cast<const float*>(lse), static_cast<float*>(dq), static_cast<float*>(dkv), batch,
        tq, tk, n_heads, lq, lk, lv, ldo, lo));
  }
  if (n_parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (tq + kDqRows - 1) / kDqRows, tq_pad = n_qt * kDqRows;
  const long long n_rows = (long long)batch * n_heads * tq_pad;
  float* lse_pad = static_cast<float*>(scratch);
  float* delta = lse_pad + n_rows;
  const long long dq_elems = (long long)batch * tq * n_heads * kD;
  float* parts = n_parts > 1 ? delta + n_rows : static_cast<float*>(dq);

  long long pre_blocks = (n_rows * 16 + kThreads - 1) / kThreads;
  if (pre_blocks > 4096) pre_blocks = 4096;
  bwd_f32_prepass<<<static_cast<int>(pre_blocks), kThreads, 0, cs>>>(
      static_cast<const float*>(o), df, static_cast<const float*>(lse), lse_pad, delta, batch, tq,
      tq_pad, n_heads, lo, ldo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int dq_work = batch * n_heads * n_qt * n_parts;
  auto dq_kernel = causal ? bwd_tc_dq_kernel<true> : bwd_tc_dq_kernel<false>;
  dq_kernel<<<dq_work < n_sms ? dq_work : n_sms, kTcThreads, dq_smem, cs>>>(
      qf, kf, vf, df, lse_pad, delta, parts, tq, tk, tq_pad, n_heads, n_qt, n_parts, dq_work,
      dq_elems, lq, lk, lv, ldo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_kb = (tk + kDkvKeys - 1) / kDkvKeys, dkv_work = batch * n_heads * n_kb;
  auto dkv_kernel = causal ? bwd_tc_dkv_kernel<true> : bwd_tc_dkv_kernel<false>;
  dkv_kernel<<<dkv_work < n_sms ? dkv_work : n_sms, kTcThreads, dkv_smem, cs>>>(
      qf, kf, vf, df, lse_pad, delta, static_cast<float*>(dkv), batch, tq, tk, tq_pad, n_heads,
      n_kb, dkv_work, lq, lk, lv, ldo);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return static_cast<int>(err);

  const long long n4 = dq_elems / 4;
  long long sum_blocks = (n4 + kThreads - 1) / kThreads;
  if (sum_blocks > 4 * n_sms) sum_blocks = 4 * n_sms;
  dq_sum_kernel<<<static_cast<int>(sum_blocks), kThreads, 0, cs>>>(
      reinterpret_cast<const float4*>(parts), static_cast<float4*>(dq), n4, n_parts);
  return static_cast<int>(cudaGetLastError());
}
