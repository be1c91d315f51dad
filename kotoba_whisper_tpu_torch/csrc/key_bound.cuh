// The key bound of the no-max forms of K1 (flash_attention_sm90.cu,
// flash_attention_f32.cu) and K8 (flash_attention_int8.cu): the JAX
// package's KWT_FA_NOMAX (kotoba_whisper_tpu/ops/flash_attention.py
// `_fwd_kernel_single`, `_fwd_kernel_single_int8`) shifts each row's
// softmax by ||q_i|| * max_j ||k_j|| * scale (K1) or (qs_i ||q8_i||) *
// (scale * max_j ks_j ||k8_j||) (K8) in place of the row max. The max over
// the keys of a (batch, head) spans every query tile, so a pass of its own
// writes it before the attention kernel reads it: one block a (batch,
// head), over K's bf16 or fp32 rows (K1: reading K once, ~18 us for the
// encoder's 61 MB of bf16 K at B=16 at 3.35 TB/s) or over the per-key
// values ks_j ||k8_j|| that K8's quantize pre-pass writes (~2 MB).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace kwt_key_bound {

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 8;  // key rows a block reads at once, eight threads a row
constexpr int kInFlight = 4;         // rows a thread loads before it sums them

// Eight values of a row as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// The block's max of non-negative x, in thread 0.
__device__ __forceinline__ float block_max(float x) {
  __shared__ float red[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float m = 0.f;
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

// K1's bound: kmax[b * n_heads + h] = sqrt(max over keys t < tk of the fp32
// sum over d of k[b, t, h, d]^2), K (B, T, H, 64) at element strides s_b,
// s_t, s_h (the head dim contiguous, rows 16-byte aligned). Grid B * H.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    key_norm_max(const T* __restrict__ k, float* __restrict__ kmax, int tk, int n_heads,
                 long long s_b, long long s_t, long long s_h) {
  const int bh = blockIdx.x, b = bh / n_heads, h = bh - b * n_heads;
  const T* kb = k + b * s_b + h * s_h + 8 * (threadIdx.x & 7);
  const int row = threadIdx.x >> 3;
  float best = 0.f;
  // the bounds are the block's, so every lane of a warp runs every shuffle
  for (int base = 0; base < tk; base += kRows * kInFlight) {
    float x[kInFlight][8];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int t = base + i * kRows + row;
      if (t < tk) {
        load8(kb + t * s_t, x[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) x[i][j] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      float n2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) n2 = fmaf(x[i][j], x[i][j], n2);
      n2 += __shfl_xor_sync(0xffffffffu, n2, 1);
      n2 += __shfl_xor_sync(0xffffffffu, n2, 2);
      n2 += __shfl_xor_sync(0xffffffffu, n2, 4);
      best = fmaxf(best, n2);
    }
  }
  best = block_max(best);
  if (threadIdx.x == 0) kmax[bh] = sqrtf(best);
}

// K8's bound: kmax[r] = the max of row r's n values of kn (each key's ks
// ||k8||, zero past Tk). Grid B * H.
__global__ void __launch_bounds__(kThreads)
    row_max(const float* __restrict__ kn, float* __restrict__ kmax, int n) {
  const float* row = kn + (long long)blockIdx.x * n;
  float best = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) best = fmaxf(best, row[i]);
  best = block_max(best);
  if (threadIdx.x == 0) kmax[blockIdx.x] = best;
}

}  // namespace kwt_key_bound
