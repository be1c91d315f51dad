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
// Tq=128, Tk=1500) operations, five products of 2*B*H*Tq*Tk*64 flops over
// the kept (query, key) pairs, 19.7 GFLOP, 0.29 ms at the 67 TFLOP/s of
// fp32 FMA, over ~0.27 GB of fp32 tensors (0.08 ms at 3.35 TB/s); at the
// causal shape (T=128) bytes, ~42 MB of fp32 tensors (12.5 us) over 0.34
// GFLOP of kept pairs (5.1 us).
//
// Design: two forms, neither with atomics, so every output is the same
// from run to run; ops/flash_attention.py `bwd_f32_cluster` picks the form.
//
// The causal form (`bwd_f32_causal_kernel`: the decoder's self-attention,
// at most 8 key tiles, Tk <= 512) is one launch. The earlier design (the
// split form below for causal calls too) read 0.1255 ms on the card at
// B=8, T=128, 1.42x the memory-efficient SDPA backward: three launches,
// 320 CTAs a kernel that walked at most two tiles each, the dK/dV CTA's
// 138 KB of shared memory one an SM (three waves), S and dP computed in
// both kernels, 4 x 4 FFMA blocks fed by two shared-memory loads per 16
// FFMAs. Now a cluster of one 256-thread CTA per 64-key tile per (batch,
// head) (160 clusters of 2 at T=128, 96 KB each: two an SM): each CTA
// computes S and dP once a (query tile, key tile) pair, keeps dK and dV in
// registers, and the query tile's dQ is summed from the CTAs' shares
// through distributed shared memory, in rank order, by the CTA that owns
// the tile (rounds of one query tile, two cluster barriers each). D =
// rowsum(dO * O) is taken as dO is copied in, so no pre-pass. The products
// run on the tensor cores as 3xTF32 mma.sync (m16n8k8): each fp32 operand
// is a TF32 high part plus the TF32 of its residual, and a b = a_lo b_hi +
// a_hi b_lo + a_hi b_hi drops only a_lo b_lo (~2^-22 relative), which
// keeps the fp32 parity the form exists for (TF32 alone, a 10-bit
// mantissa, would not); the tiles sit XOR-swizzled in shared memory so
// that every fragment read is free of bank conflicts.
//
// The split form (the cross-attention call, and a causal call past 8 key
// tiles): the JAX package's split, in three launches, every product an
// fp32 FFMA:
//  1. `bwd_f32_prepass`: D = rowsum(dO * O) in fp32 and the LSE, both as
//     (B*H, Tq padded to 64) rows; padded rows get D = 0 and LSE = +inf,
//     so exp(s - LSE) = 0 there. The LSE stays in natural-log units (the
//     fp32 K1/K4 write it so, flash_attention_f32.cu) and P is expf(s -
//     LSE), the twin's exp of the same fp32 difference, not an ex2 of
//     log2-scaled scores.
//  2. `bwd_f32_dq_kernel`: a CTA of 256 threads takes 64 query rows of one
//     (batch, head), holds Q^T (times 1/8) and dO^T in shared memory, and
//     walks 64-key tiles of K and V (K transposed for S, as it is for dQ;
//     V transposed for dP), the causal form only the tiles at or below its
//     last row's bound. Thread (ty, tx) of a 16 x 16 grid computes its 4 x
//     4 blocks of S and dP (rows 4ty.., keys 4tx..) from one float4 of each
//     operand a head dim, then P and dS in registers, and writes dS^T to
//     shared memory; it then owns dQ's rows 4ty.. and dims 4tx..: dQ += dS
//     K from a float4 of dS^T and one of K a key. dQ times 1/8 at the end.
//  3. `bwd_f32_dkv_kernel`: a CTA takes 64 keys of one (batch, head), holds
//     K^T and V^T, and walks the 64-row query tiles that see one of its
//     keys (causal: from the first row at or past key - (Tk - Tq)): S^T and
//     dP^T (keys 4ty.., rows 4tx..), P and dS to shared memory by row, then
//     dV += P^T dO and dK += dS^T (Q / 8) for keys 4ty.., dims 4tx.., with
//     Q and dO also held row by row. dK and dV are written once.
// Keys past Tk (read as zeros) and, causal, keys past a row's bound j <= i
// + Tk - Tq get P = 0. Tensors keep the model's (B, T, H, 64) layout, read
// through per-tensor element strides (multiples of 4: float4 loads), so a
// fused projection's column blocks go in without copies; dQ is written
// contiguous (B, Tq, H, 64), dK and dV as one contiguous (2, B, Tk, H, 64).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "card.cuh"
#include "sm90_common.cuh"

namespace {

constexpr int kD = 64;         // head dim
constexpr int kT = 64;         // query rows of a query tile, keys of a key tile
constexpr int kPad = kT + 4;   // a transposed row's floats (keeps the 16-byte alignment)
constexpr int kThreads = 256;  // a 16 x 16 grid of 4 x 4 blocks

// Element strides of one (B, T, H, 64) tensor.
struct Layout {
  long long b, t, h;
};

struct DqSmem {
  float qt[kD][kPad];   // Q^T of the CTA's rows, times 1/8
  float dot[kD][kPad];  // dO^T
  float kt[kD][kPad];   // K^T of the tile
  float vt[kD][kPad];   // V^T of the tile
  float k[kT][kD];      // K of the tile, by key
  float dst[kT][kPad];  // dS^T of the tile
};

struct DkvSmem {
  float kt[kD][kPad];   // K^T of the CTA's keys
  float vt[kD][kPad];   // V^T
  float qt[kD][kPad];   // Q^T of the query tile, times 1/8
  float dot[kD][kPad];  // dO^T
  float q[kT][kD];      // Q of the tile, by row, times 1/8
  float dout[kT][kD];   // dO, by row
  float p[kT][kPad];    // P, by row
  float ds[kT][kPad];   // dS, by row
  float lse[kT], delta[kT];
};

// Rows [r0, r0 + 64) of a (B, T, H, 64) tensor at (b, h), transposed into
// dst[64 dims][kPad] times `scale`, zeros past t. Thread i reads float4s of
// consecutive rows, so the transposed stores of a warp hit consecutive
// words.
__device__ __forceinline__ void load_transposed(float (*dst)[kPad], const float* base, long long s_t,
                                                int r0, int t, float scale) {
#pragma unroll
  for (int it = 0; it < kT * kD / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i % kT, d4 = (i / kT) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t) x = *reinterpret_cast<const float4*>(base + (r0 + r) * s_t + d4);
    dst[d4][r] = x.x * scale;
    dst[d4 + 1][r] = x.y * scale;
    dst[d4 + 2][r] = x.z * scale;
    dst[d4 + 3][r] = x.w * scale;
  }
}

// The same rows as they are, dst[64 rows][64 dims], times `scale`.
__device__ __forceinline__ void load_rows(float (*dst)[kD], const float* base, long long s_t, int r0,
                                          int t, float scale) {
#pragma unroll
  for (int it = 0; it < kT * kD / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / (kD / 4), d4 = (i % (kD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t) x = *reinterpret_cast<const float4*>(base + (r0 + r) * s_t + d4);
    *reinterpret_cast<float4*>(&dst[r][d4]) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
}

// acc[i][j] += a[i] * c[j] over 64 steps of float4s: a from x[step][ra..],
// c from y[step][cb..].
template <int kXW, int kYW>
__device__ __forceinline__ void outer_sum(float (*acc)[4], const float (*x)[kXW], int ra,
                                          const float (*y)[kYW], int cb) {
#pragma unroll 8
  for (int d = 0; d < 64; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(&x[d][ra]);
    const float4 c = *reinterpret_cast<const float4*>(&y[d][cb]);
    const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// D and the padded LSE: 16 threads a (batch, head, row) unit, one float4
// of O and of dO each, the sum over the half-warp.
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

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
    bwd_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse_pad, const float* __restrict__ delta,
                      float* __restrict__ dq, int tq, int tk, int tq_pad, int n_heads, Layout lq,
                      Layout lk, Layout lv, Layout ldo) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DqSmem& s = *reinterpret_cast<DqSmem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * n_heads + h;
  const int offset = tk - tq;  // causal: row i sees keys j <= i + offset
  const float* kb = k + b * lk.b + h * lk.h;
  const float* vb = v + b * lv.b + h * lv.h;

  load_transposed(s.qt, q + b * lq.b + h * lq.h, lq.t, q0, tq, 0.125f);
  load_transposed(s.dot, dout + b * ldo.b + h * ldo.h, ldo.t, q0, tq, 1.f);
  float lse_r[4], d_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // rows < tq_pad: padded rows read +inf and 0
    lse_r[i] = lse_pad[bh * tq_pad + q0 + 4 * ty + i];
    d_r[i] = delta[bh * tq_pad + q0 + 4 * ty + i];
  }
  float acc[4][4];
  zero(acc);
  int n_tiles = (tk + kT - 1) / kT;
  if (kCausal) n_tiles = min(n_tiles, (min(q0 + kT, tq) - 1 + offset) / kT + 1);

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kT;
    __syncthreads();  // the previous tile's K, V and dS^T are read
    load_transposed(s.kt, kb, lk.t, k0, tk, 1.f);
    load_transposed(s.vt, vb, lv.t, k0, tk, 1.f);
    load_rows(s.k, kb, lk.t, k0, tk, 1.f);
    __syncthreads();

    // S = (Q / 8) K^T and dP = dO V^T for rows 4ty.., keys 4tx..
    float sc[4][4], dp[4][4];
    zero(sc);
    zero(dp);
    outer_sum<kPad, kPad>(sc, s.qt, 4 * ty, s.kt, 4 * tx);
    outer_sum<kPad, kPad>(dp, s.dot, 4 * ty, s.vt, 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + 4 * ty + i, key = k0 + 4 * tx + j;
        const bool in = key < tk && (!kCausal || key <= row + offset);
        const float p = in ? expf(sc[i][j] - lse_r[i]) : 0.f;
        s.dst[4 * tx + j][4 * ty + i] = p * (dp[i][j] - d_r[i]);
      }
    __syncthreads();

    // dQ += dS K for rows 4ty.., dims 4tx..
    outer_sum<kPad, kD>(acc, s.dst, 4 * ty, s.k, 4 * tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= tq) continue;
    *reinterpret_cast<float4*>(dq + (((long long)b * tq + row) * n_heads + h) * kD + 4 * tx) =
        make_float4(acc[i][0] * 0.125f, acc[i][1] * 0.125f, acc[i][2] * 0.125f,
                    acc[i][3] * 0.125f);
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
    bwd_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse_pad, const float* __restrict__ delta,
                       float* __restrict__ dkv, int batch, int tq, int tk, int tq_pad, int n_heads,
                       Layout lq, Layout lk, Layout lv, Layout ldo) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DkvSmem& s = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * n_heads + h;
  const int offset = tk - tq;
  const float* qb = q + b * lq.b + h * lq.h;
  const float* dob = dout + b * ldo.b + h * ldo.h;

  load_transposed(s.kt, k + b * lk.b + h * lk.h, lk.t, k0, tk, 1.f);
  load_transposed(s.vt, v + b * lv.b + h * lv.h, lv.t, k0, tk, 1.f);
  float dk[4][4], dv[4][4];
  zero(dk);
  zero(dv);
  // causal: the first query tile holding a row that sees key k0
  const int qt0 = kCausal ? max(k0 - offset, 0) / kT : 0;

  for (int r0 = qt0 * kT; r0 < tq_pad; r0 += kT) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are read
    load_transposed(s.qt, qb, lq.t, r0, tq, 0.125f);
    load_transposed(s.dot, dob, ldo.t, r0, tq, 1.f);
    load_rows(s.q, qb, lq.t, r0, tq, 0.125f);
    load_rows(s.dout, dob, ldo.t, r0, tq, 1.f);
    if (tid < kT) {
      s.lse[tid] = lse_pad[bh * tq_pad + r0 + tid];
      s.delta[tid] = delta[bh * tq_pad + r0 + tid];
    }
    __syncthreads();

    // S^T = K (Q / 8)^T and dP^T = V dO^T for keys 4ty.., rows 4tx..
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    outer_sum<kPad, kPad>(st, s.kt, 4 * ty, s.qt, 4 * tx);
    outer_sum<kPad, kPad>(dpt, s.vt, 4 * ty, s.dot, 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * ty + i, r = 4 * tx + j;
        const bool in = key < tk && (!kCausal || key <= r0 + r + offset);
        const float p = in ? expf(st[i][j] - s.lse[r]) : 0.f;
        s.p[r][4 * ty + i] = p;
        s.ds[r][4 * ty + i] = p * (dpt[i][j] - s.delta[r]);
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T (Q / 8) for keys 4ty.., dims 4tx..
    outer_sum<kPad, kD>(dv, s.p, 4 * ty, s.dout, 4 * tx);
    outer_sum<kPad, kD>(dk, s.ds, 4 * ty, s.q, 4 * tx);
  }

  const long long half = (long long)batch * tk * n_heads * kD;  // dV's offset in dkv
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    if (key >= tk) continue;
    const long long at = (((long long)b * tk + key) * n_heads + h) * kD + 4 * tx;
    *reinterpret_cast<float4*>(dkv + at) = make_float4(dk[i][0], dk[i][1], dk[i][2], dk[i][3]);
    *reinterpret_cast<float4*>(dkv + half + at) =
        make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
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

using kwt_sm90::split_tf32;  // TF32 high part and exact residual

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
// 0 the split form. dq (B, Tq, H, 64) and dkv (2, B, Tk, H, 64) fp32
// contiguous; scratch (the split form's) 2 * B * H * Tq padded to 64 floats
// (the padded LSE, then D). One launch (the causal cluster form) or three
// (the split form) on `stream`; returns the first failing launch's
// cudaError_t.
extern "C" int kwt_flash_attention_bwd_f32(int card, const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* dq, void* dkv, void* scratch,
                                           const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  const int batch = static_cast<int>(plan[0]), tq = static_cast<int>(plan[1]);
  const int tk = static_cast<int>(plan[2]), n_heads = static_cast<int>(plan[3]);
  const bool causal = plan[4] != 0, cluster = plan[20] != 0;
  const long long* st = plan + 5;
  const Layout lq{st[0], st[1], st[2]}, lk{st[3], st[4], st[5]}, lv{st[6], st[7], st[8]};
  const Layout ldo{st[9], st[10], st[11]}, lo{st[12], st[13], st[14]};
  constexpr int dq_smem = static_cast<int>(sizeof(DqSmem));
  constexpr int dkv_smem = static_cast<int>(sizeof(DkvSmem));
  constexpr int causal_smem = static_cast<int>(sizeof(CausalSmem));
  static bool configured[kwt_card::kMaxCards] = {};
  if (!configured[card]) {
    cudaError_t e = allow_smem(bwd_f32_dq_kernel<false>, dq_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_f32_dq_kernel<true>, dq_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_f32_dkv_kernel<false>, dkv_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_f32_dkv_kernel<true>, dkv_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_f32_causal_kernel, causal_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[card] = true;
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int n_qt = (tq + kT - 1) / kT, n_kt = (tk + kT - 1) / kT, tq_pad = n_qt * kT;
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
  float* lse_pad = static_cast<float*>(scratch);
  float* delta = lse_pad + (long long)batch * n_heads * tq_pad;

  const long long pre_threads = (long long)batch * n_heads * tq_pad * 16;
  long long pre_blocks = (pre_threads + kThreads - 1) / kThreads;
  if (pre_blocks > 4096) pre_blocks = 4096;
  bwd_f32_prepass<<<static_cast<int>(pre_blocks), kThreads, 0, cs>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout),
      static_cast<const float*>(lse), lse_pad, delta, batch, tq, tq_pad, n_heads, lo, ldo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dq_kernel = causal ? bwd_f32_dq_kernel<true> : bwd_f32_dq_kernel<false>;
  dq_kernel<<<dim3(n_qt, n_heads, batch), kThreads, dq_smem, cs>>>(
      qf, kf, vf, df, lse_pad, delta, static_cast<float*>(dq), tq, tk, tq_pad, n_heads, lq, lk,
      lv, ldo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dkv_kernel = causal ? bwd_f32_dkv_kernel<true> : bwd_f32_dkv_kernel<false>;
  dkv_kernel<<<dim3(n_kt, n_heads, batch), kThreads, dkv_smem, cs>>>(
      qf, kf, vf, df, lse_pad, delta, static_cast<float*>(dkv), batch, tq, tk, tq_pad, n_heads,
      lq, lk, lv, ldo);
  return static_cast<int>(cudaGetLastError());
}
