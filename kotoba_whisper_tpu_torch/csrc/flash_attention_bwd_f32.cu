// Flash-attention backward in fp32 for Hopper's CUDA cores (K5's fp32
// form), causal (the decoder's self-attention, end-aligned) and non-causal
// (its cross-attention, Tq != Tk).
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
// What bounds it on the card: operations. Five products of 2*B*H*Tq*Tk*64
// flops over the kept (query, key) pairs: at the training cross shape
// (B=8, 20 heads, Tq=128, Tk=1500) 19.7 GFLOP, 0.29 ms at the 67 TFLOP/s of
// fp32 FMA, over ~0.27 GB of fp32 tensors (0.08 ms at 3.35 TB/s); at the
// causal shape (T=128) 0.34 GFLOP (5.1 us) under ~42 MB (12.5 us), bound
// by bytes. The tensor cores take fp32 only as TF32 (a 10-bit mantissa),
// which would lose the fp32 parity this form exists for, so every product
// is an fp32 FFMA.
//
// Design: the JAX package's split, in three launches; no atomics, so every
// output is the same from run to run.
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

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// q (B, Tq, H, 64), k and v (B, Tk, H, 64), o and dout (B, Tq, H, 64) fp32,
// each read through its own element strides, lse (B, H, Tq) fp32
// contiguous (natural log). plan (ops/flash_attention.py `_bwd_f32_plan`):
// B, Tq, Tk, H, causal, then the batch, token and head element strides of
// q, k, v, dout and o (multiples of 4, the head dim contiguous). dq (B, Tq,
// H, 64) and dkv (2, B, Tk, H, 64) fp32 contiguous; scratch 2 * B * H * Tq
// padded to 64 floats (the padded LSE, then D). Three launches on `stream`;
// returns the first failing launch's cudaError_t.
extern "C" int kwt_flash_attention_bwd_f32(int card, const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* dq, void* dkv, void* scratch,
                                           const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  const int batch = static_cast<int>(plan[0]), tq = static_cast<int>(plan[1]);
  const int tk = static_cast<int>(plan[2]), n_heads = static_cast<int>(plan[3]);
  const bool causal = plan[4] != 0;
  const long long* st = plan + 5;
  const Layout lq{st[0], st[1], st[2]}, lk{st[3], st[4], st[5]}, lv{st[6], st[7], st[8]};
  const Layout ldo{st[9], st[10], st[11]}, lo{st[12], st[13], st[14]};
  constexpr int dq_smem = static_cast<int>(sizeof(DqSmem));
  constexpr int dkv_smem = static_cast<int>(sizeof(DkvSmem));
  static bool configured[kwt_card::kMaxCards] = {};
  if (!configured[card]) {
    cudaError_t e = allow_smem(bwd_f32_dq_kernel<false>, dq_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_f32_dq_kernel<true>, dq_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_f32_dkv_kernel<false>, dkv_smem);
    if (e == cudaSuccess) e = allow_smem(bwd_f32_dkv_kernel<true>, dkv_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[card] = true;
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int n_qt = (tq + kT - 1) / kT, n_kt = (tk + kT - 1) / kT, tq_pad = n_qt * kT;
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

  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
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
