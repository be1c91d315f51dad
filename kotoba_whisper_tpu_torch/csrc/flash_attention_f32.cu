// Flash-attention forward in fp32 for Hopper's CUDA cores, one kernel in two
// instantiations: non-causal (K1's fp32 form: the encoder's self-attention,
// the decoder's cross-attention with Tq != Tk) and end-aligned causal (K4's
// fp32 form: the decoder's self-attention over a full block, Tq == Tk).
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py `_fwd_kernel_single`
// (K1) and `_fwd_kernel` (K4) run on fp32 inputs (`_flash_fwd`), where the
// TPU kernel works in q's dtype from end to end: q scaled by the exact
// 1/sqrt(64) (`_scale_exact`), fp32 scores, P kept in fp32 for P V. O is
// fp32 and the LSE the natural-log fp32 logsumexp of each query row.
//
// What bounds it on the card: operations. One non-causal call does
// 4*B*H*Tq*Tk*64 flops (184 GFLOP at the encoder's B=16, T=1500, 20 heads:
// 2.75 ms at the 67 TFLOP/s of fp32 FMA) over ~0.5 GB of fp32 q, k, v and
// O (0.15 ms at 3.35 TB/s). The tensor cores take fp32 only as TF32 (a
// 10-bit mantissa), which would lose the fp32 parity this form exists for,
// so every product here is an fp32 FFMA.
//
// Design: a plain CUDA-core flash attention. A CTA of 256 threads takes 64
// query rows of one (batch, head) and walks 64-key tiles of K and V with an
// online softmax in log2 units. Q (pre-scaled by 1/8, exact) and each K
// tile are held transposed in shared memory (dims x rows, rows padded by 4
// floats), so thread (ty, tx) of a 16 x 16 grid computes its 4 x 4 block of
// S (rows 4ty.., keys 4tx..) from one float4 of Q^T and one of K^T a head
// dim: 16 FFMAs for two shared loads, Q's a broadcast. A row's max is
// reduced over the 16 threads holding it by shuffles (a half-warp), the
// tile's P (2^(s - m)) goes to shared memory transposed, and the same
// thread then owns O's rows 4ty.. and dims 4tx..: O += P V from a float4 of
// P^T and one of V a key. Rows past Tq are computed on zeros and not stored,
// keys past Tk and (causal) past a row's bound j <= i + Tk - Tq are -inf;
// the causal form visits only the key tiles at or below its last row's
// bound. Tensors keep the model's (B, T, H, 64) layout, read through
// per-tensor element strides (16-byte multiples), so a fused qkv
// projection's column blocks go in without copies; O is written contiguous
// (B, Tq, H, 64), the LSE (B, H, Tq). The no-max form (kNoMax; the JAX
// package's KWT_FA_NOMAX, non-causal): a pre-pass (key_bound.cuh
// `key_norm_max`) writes max_j ||k_j|| of each (batch, head); each row's
// norm comes from Q^T in shared memory, and its fixed shift m = ||q / 8|| *
// kmax replaces the running max: p = 2^(s log2(e) - m log2(e)) in one FFMA
// and ex2, no rescale, O = o / max(l, 1e-30) and the LSE m + ln max(l,
// 1e-30), as the TPU kernel divides.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "card.cuh"
#include "key_bound.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBM = 64;       // query rows a CTA
constexpr int kBN = 64;       // keys a tile
constexpr int kPad = kBM + 4;  // a transposed row's floats (keeps the 16-byte alignment)
constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Smem {
  float qt[kD][kPad];   // Q^T, times 1/8
  float kt[kD][kPad];   // K^T of the tile
  float v[kBN][kD];     // V of the tile
  float pt[kBN][kPad];  // P^T of the tile
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + 64) of a (B, T, H, 64) tensor at (b, h), transposed into
// dst[64 dims][kPad] (times `scale`), zeros past t. Thread i reads float4s of
// consecutive rows, so the transposed stores of a warp hit consecutive
// words.
__device__ __forceinline__ void load_transposed(float (*dst)[kPad], const float* base, long s_t,
                                                int r0, int t, float scale) {
#pragma unroll
  for (int it = 0; it < kBM * kD / 4 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i % kBM, d4 = (i / kBM) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t) x = *reinterpret_cast<const float4*>(base + (long)(r0 + r) * s_t + d4);
    dst[d4][r] = x.x * scale;
    dst[d4 + 1][r] = x.y * scale;
    dst[d4 + 2][r] = x.z * scale;
    dst[d4 + 3][r] = x.w * scale;
  }
}

template <bool kCausal, bool kNoMax>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, const float* __restrict__ kmax, int tq,
                         int tk, int n_heads, long qs_b,
                         long qs_t, long qs_h, long ks_b, long ks_t, long ks_h, long vs_b,
                         long vs_t, long vs_h) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int offset = tk - tq;  // causal: row i sees keys j <= i + offset
  const float* qb = q + b * qs_b + h * qs_h;
  const float* kb = k + b * ks_b + h * ks_h;
  const float* vb = v + b * vs_b + h * vs_h;

  load_transposed(s.qt, qb, qs_t, q0, tq, 0.125f);

  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  if constexpr (kNoMax) {  // rows 4ty.. of Q^T, dims 4tx.., summed over the half-warp
    __syncthreads();
    const float bound = kmax[(long)b * n_heads + h] * kLog2e;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float n2 = 0.f;
#pragma unroll
      for (int d = 0; d < 4; ++d) n2 = fmaf(s.qt[4 * tx + d][4 * ty + i], s.qt[4 * tx + d][4 * ty + i], n2);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) n2 += __shfl_xor_sync(0xffffffffu, n2, off);
      m_run[i] = sqrtf(n2) * bound;
    }
  }
  int n_tiles = (tk + kBN - 1) / kBN;
  if (kCausal) n_tiles = min(n_tiles, (min(q0 + kBM, tq) - 1 + offset) / kBN + 1);

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kBN;
    __syncthreads();  // the previous tile's K^T, V and P^T are read
    load_transposed(s.kt, kb, ks_t, k0, tk, 1.f);
#pragma unroll
    for (int it = 0; it < kBN * kD / 4 / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / (kD / 4), d4 = (i % (kD / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < tk) x = *reinterpret_cast<const float4*>(vb + (long)(k0 + r) * vs_t + d4);
      *reinterpret_cast<float4*>(&s.v[r][d4]) = x;
    }
    __syncthreads();

    // S = (Q / 8) K^T for rows 4ty.., keys 4tx..
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&s.qt[d][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&s.kt[d][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], cv[j], sc[i][j]);
    }
    // log2 units, masks, the rows' running max over the half-warp (kNoMax:
    // the fixed shift, p in one FFMA and ex2, no rescale)
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      if constexpr (kNoMax) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = k0 + 4 * tx + j < tk ? ex2(fmaf(sc[i][j], kLog2e, -m_run[i])) : 0.f;
          l_run[i] += p;
          s.pt[4 * tx + j][4 * ty + i] = p;
        }
        continue;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + 4 * tx + j;
        const bool in = key < tk && (!kCausal || key <= row + offset);
        sc[i][j] = in ? sc[i][j] * kLog2e : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row that saw no key yet
      corr[i] = ex2(m_run[i] - base);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ex2(sc[i][j] - base);
        sum += p;
        s.pt[4 * tx + j][4 * ty + i] = p;
      }
      l_run[i] = l_run[i] * corr[i] + sum;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= corr[i];
    }
    __syncthreads();

    // O += P V for rows 4ty.., dims 4tx..
#pragma unroll 8
    for (int kk = 0; kk < kBN; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&s.pt[kk][4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&s.v[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
  }

  // each thread's sums cover its own keys: the row's sum over the half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = q0 + 4 * ty + i;
    if (row >= tq) continue;
    if constexpr (kNoMax) l = fmaxf(l, 1e-30f);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    *reinterpret_cast<float4*>(o + (((long)b * tq + row) * n_heads + h) * kD + 4 * tx) =
        make_float4(acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
    if (tx == 0) lse[((long)b * n_heads + h) * tq + row] = (m_run[i] + log2f(l)) * kLn2;
  }
}

// The launches of either C entry, on the card it entered: kmax non-null
// takes the no-max form (plan[14] != 0) after the key-bound pre-pass.
int launch(int card, const void* q, const void* k, const void* v, void* o, void* lse,
           float* kmax, const long long* plan, void* stream) {
  const int batch = static_cast<int>(plan[0]), tq = static_cast<int>(plan[1]);
  const int tk = static_cast<int>(plan[2]), n_heads = static_cast<int>(plan[3]);
  const bool causal = plan[4] != 0, no_max = plan[14] != 0;
  if (no_max != (kmax != nullptr) || (no_max && causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = plan + 5;
  constexpr int smem = static_cast<int>(sizeof(Smem));
  static bool configured[kwt_card::kMaxCards] = {};
  if (!configured[card]) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_kernel<false, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_f32_kernel<true, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_f32_kernel<false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[card] = true;
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (no_max) {
    kwt_key_bound::key_norm_max<float><<<batch * n_heads, kwt_key_bound::kThreads, 0, cs>>>(
        static_cast<const float*>(k), kmax, tk, n_heads, st[3], st[4], st[5]);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((tq + kBM - 1) / kBM, n_heads, batch);
  auto kernel = no_max  ? flash_fwd_f32_kernel<false, true>
                : causal ? flash_fwd_f32_kernel<true, false>
                         : flash_fwd_f32_kernel<false, false>;
  kernel<<<grid, kThreads, smem, cs>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), kmax, tq, tk, n_heads, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8]);
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
