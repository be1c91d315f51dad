// Decode-step attention over flat K/V caches (K2) for Hopper.
//
// Replaces: kotoba_whisper_tpu/ops/decode_attention.py `_kernel` (called
// through `decode_attention_flat`), and covers what the TPU main path
// actually ran in its place, `decode_attention_reference`: per-row fp32
// int8 scales folded into the scores (k_scale) and the softmax weights
// (v_scale), a lockstep scalar or per-row (B,) valid length.
//
// What bounds it on the card: one query row per batch element against a
// (B, T, H*64) cache, so every K/V byte is read once and used for one
// multiply-add: ~0.5-1 flop per byte, far below the ridge. The cross-
// attention call (T=1500) is bound by the bytes of K and V (61 MB in int8
// at B=16, about 18 us at 3.35 TB/s); the self-attention call (T <= 51)
// is bound by the launch itself.
//
// Design: the TPU kernel recovers heads with a block-diagonal q and an
// expand matrix only to dodge a TPU relayout; here each head is computed
// directly. The flat layout puts one head's 64 values of a row at a
// 1280-element stride, so every block reads WHOLE rows (16 bytes a lane,
// neighbouring lanes on neighbouring addresses) and reduces each head over
// the lanes that share it. T is split into 64-row chunks, one block per
// (chunk, batch row): 24 x 16 = 384 blocks for the cross cache at B=16,
// enough to fill 132 SMs. Each block writes its per-head running max, sum
// and weighted V sum; a second small kernel, one block per (head, row),
// combines the chunks (split-K flash decoding). A cache that fits one
// chunk (the self-attention cache, T <= 64) skips the combine: the block
// normalises and writes the output itself. Scores and weights stay in
// shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHD = 64;        // head dim
constexpr int kChunk = 64;     // cache rows per block (ops/decode_attention.py)
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void to_float8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void to_float8(const int8_t* p, float* x) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

// A 16-byte chunk of one cache row as floats.
template <typename KV>
struct Chunk {
  static constexpr int kElems = 16 / sizeof(KV);
  __device__ __forceinline__ static void load(const KV* p, float* x) {
#pragma unroll
    for (int i = 0; i < kElems; i += 8) to_float8(p + i, x + i);
  }
};

template <typename KV>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                        const KV* __restrict__ k, const KV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ valid_rows, int valid_all,
                        long q_stride, int t_cap, int n_heads, int n_splits,
                        float* __restrict__ part_o, float* __restrict__ part_m,
                        float* __restrict__ part_l, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  const int d = n_heads * kHD;
  float* q_s = smem;                 // (d)     pre-scaled query
  float* w_s = q_s + d;              // (kChunk, H) scores, then weights
  float* m_s = w_s + kChunk * n_heads;
  float* l_s = m_s + n_heads;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.y;
  int valid = valid_rows ? valid_rows[b] : valid_all;
  valid = min(valid, t_cap);
  const int t0 = split * kChunk;
  const int n_rows = max(min(t0 + kChunk, valid) - t0, 0);
  const long row0 = (long)b * t_cap + t0;

  for (int i = tid; i < d; i += kThreads)
    q_s[i] = __bfloat162float(q[(long)b * q_stride + i]) * 0.125f;  // 1/sqrt(64)
  __syncthreads();

  // Scores: a warp walks whole rows; each lane takes 16-byte chunks and
  // the lanes sharing a head reduce their partial dots.
  constexpr int kElems = Chunk<KV>::kElems;
  constexpr int kLanesPerHead = kHD / kElems;  // 8 (bf16) or 4 (int8)
  const int n_chunks = d / kElems;
  for (int r = warp; r < n_rows; r += kWarps) {
    const KV* krow = k + (row0 + r) * d;
    const float ks = k_scale ? k_scale[row0 + r] : 1.f;
    for (int c0 = 0; c0 < n_chunks; c0 += 32) {
      const int c = c0 + lane;
      float part = 0.f;
      if (c < n_chunks) {
        float x[kElems];
        Chunk<KV>::load(krow + c * kElems, x);
#pragma unroll
        for (int i = 0; i < kElems; ++i) part += x[i] * q_s[c * kElems + i];
      }
#pragma unroll
      for (int off = kLanesPerHead / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (c < n_chunks && (lane % kLanesPerHead) == 0)
        w_s[r * n_heads + c / kLanesPerHead] = part * ks;
    }
  }
  __syncthreads();

  // Per-head max and sum over this chunk's rows; weights carry v_scale.
  for (int h = warp; h < n_heads; h += kWarps) {
    float mx = -INFINITY;
    for (int r = lane; r < n_rows; r += 32) mx = fmaxf(mx, w_s[r * n_heads + h]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n_rows; r += 32) {
      const float p = expf(w_s[r * n_heads + h] - mx);
      sum += p;
      w_s[r * n_heads + h] = p * (v_scale ? v_scale[row0 + r] : 1.f);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[h] = mx;
      l_s[h] = sum;
    }
  }
  __syncthreads();

  // Weighted V sum: each thread owns 8 consecutive columns of the row.
  // With a single chunk the block normalises and writes the output itself.
  const long part_row = (long)b * n_splits + split;
  for (int cg = tid; cg < d / 8; cg += kThreads) {
    const int h = (cg * 8) / kHD;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < n_rows; ++r) {
      const float w = w_s[r * n_heads + h];
      float x[8];
      to_float8(v + (row0 + r) * d + cg * 8, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += w * x[i];
    }
    if (n_splits == 1) {
      const float inv = 1.f / fmaxf(l_s[h], 1e-30f);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        out[(long)b * d + cg * 8 + i] = __float2bfloat16(acc[i] * inv);
    } else {
      float* dst = part_o + part_row * d + cg * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = acc[i];
    }
  }
  if (n_splits > 1 && tid < n_heads) {
    part_m[part_row * n_heads + tid] = m_s[tid];
    part_l[part_row * n_heads + tid] = l_s[tid];
  }
}

// One block of 64 threads per (head, batch row): thread i owns column i
// of the head and folds the chunks' partial sums with their max and sum.
__global__ void __launch_bounds__(kHD)
    decode_combine_kernel(const float* __restrict__ part_o,
                          const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          __nv_bfloat16* __restrict__ out, int n_heads,
                          int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y, d = n_heads * kHD;
  const int c = h * kHD + threadIdx.x;
  const long base = (long)b * n_splits;
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, part_m[(base + s) * n_heads + h]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float f = expf(part_m[(base + s) * n_heads + h] - mx);  // 0 if empty
    l += part_l[(base + s) * n_heads + h] * f;
    o += part_o[(base + s) * d + c] * f;
  }
  out[(long)b * d + c] = __float2bfloat16(o / fmaxf(l, 1e-30f));
}

template <typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* valid_rows, int valid_all,
           long q_stride, void* out, void* part_o, void* part_m, void* part_l,
           int batch, int t_cap, int n_heads, int n_splits, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)n_heads * kHD + (size_t)kChunk * n_heads + 2 * n_heads);
  decode_split_kernel<KV><<<dim3(n_splits, batch), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(valid_rows),
      valid_all, q_stride, t_cap, n_heads, n_splits, static_cast<float*>(part_o),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<__nv_bfloat16*>(out));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  decode_combine_kernel<<<dim3(n_heads, batch), kHD, 0, stream>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<__nv_bfloat16*>(out),
      n_heads, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H*64) bf16, rows q_stride elements apart (a row of a fused qkv
// projection is read in place); k/v (B, T, H*64) bf16 (kv_int8=0) or int8 (kv_int8=1)
// with fp32 (B, T) scales (nullable); valid_rows (B,) int32 or null, then
// valid_all applies to every row. Scratch for n_splits > 1 (null for one
// split): part_o (B, n_splits, H*64), part_m/part_l (B, n_splits, H) fp32.
// out (B, H*64) bf16.
extern "C" int kwt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* k_scale,
                                    const void* v_scale, const void* valid_rows,
                                    int valid_all, long long q_stride,
                                    void* out, void* part_o, void* part_m,
                                    void* part_l, int batch, int t_cap,
                                    int n_heads, int n_splits, int kv_int8,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return launch<int8_t>(q, k, v, k_scale, v_scale, valid_rows, valid_all,
                          (long)q_stride, out, part_o, part_m, part_l, batch, t_cap, n_heads,
                          n_splits, s);
  return launch<__nv_bfloat16>(q, k, v, k_scale, v_scale, valid_rows,
                               valid_all, (long)q_stride, out, part_o, part_m, part_l, batch,
                               t_cap, n_heads, n_splits, s);
}
