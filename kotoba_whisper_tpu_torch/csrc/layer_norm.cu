// Fused LayerNorm (K6) for Hopper, bf16 rows in / bf16 out, with an
// optional fused residual add.
//
// Replaces: kotoba_whisper_tpu/ops/layer_norm.py `_ln_kernel` (called
// through `layer_norm`) and `_add_ln_kernel` (through `add_layer_norm`):
// fp32 row LayerNorm in one read and one write of the rows; the fused form
// also emits the bf16 residual sum, and normalises that ROUNDED sum, so its
// outputs equal the unfused `x = x + y; layer_norm(x)` sequence.
//
// What bounds it on the card: bytes. At the encoder's (B*1500, 1280) bf16
// rows (24000 rows at B=16) LayerNorm reads x and writes y (123 MB, about
// 37 us at 3.35 TB/s); the fused add reads x and y and writes the sum and
// y (246 MB, about 73 us). Its ~10 flops an element are far below the
// ridge.
//
// Design: one warp per row, eight rows per 256-thread block. Each lane
// loads its 16-byte chunks of the row (8 bf16) once and keeps them in
// registers as fp32 (at most 8 chunks a lane: rows up to 2048 wide), so
// the row crosses memory once each way. Statistics match the TPU kernel's
// `_ln_rows` step by step: the mean as sum / d, then the variance of the
// centred values (not E[x^2] - mean^2, not Welford), warp-shuffle sums in
// fp32; y = ((xc * rsqrt(var + eps)) * w) + b with the multiplies and the
// add rounded separately (no fused multiply-add), so it differs from the
// twin only where rsqrtf and the sum order do (well inside one bf16 ulp).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunks = 8;  // 16-byte chunks per lane: rows <= 2048
constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
    layer_norm_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ y,
                      const float* __restrict__ w, const float* __restrict__ b,
                      __nv_bfloat16* __restrict__ sum_out,
                      __nv_bfloat16* __restrict__ out, int rows, int d,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int n_chunks = d >> 3;
  const long base = (long)row * d;

  float v[kMaxChunks][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = lane + 32 * i;
    if (c >= n_chunks) break;
    load8(x + base + c * 8, v[i]);
    if (y != nullptr) {
      float yv[8];
      load8(y + base + c * 8, yv);
#pragma unroll
      for (int e = 0; e < 8; ++e)  // the sum rounded to bf16, as stored
        v[i][e] = __bfloat162float(__float2bfloat16_rn(v[i][e] + yv[e]));
      store8(sum_out + base + c * 8, v[i]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[i][e];
  }
  const float mean = __fdiv_rn(warp_sum(s), (float)d);

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = lane + 32 * i;
    if (c >= n_chunks) break;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[i][e] = __fsub_rn(v[i][e], mean);
      ss = __fadd_rn(ss, __fmul_rn(v[i][e], v[i][e]));
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)d), eps));

#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = lane + 32 * i;
    if (c >= n_chunks) break;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int col = c * 8 + e;
      o[e] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][e], rstd), w[col]), b[col]);
    }
    store8(out + base + c * 8, o);
  }
}

}  // namespace

// x (rows, d) bf16; y (rows, d) bf16 or null; w, b (d,) fp32; sum_out
// (rows, d) bf16 (written only when y is given); out (rows, d) bf16.
// d % 8 == 0 and d <= 2048. Returns the launch's cudaError_t.
extern "C" int kwt_layer_norm(const void* x, const void* y, const void* w,
                              const void* b, void* sum_out, void* out, int rows,
                              int d, float eps, void* stream) {
  if (d % 8 != 0 || d > kMaxChunks * 8 * 32) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_kernel<<<blocks, 32 * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(sum_out), static_cast<__nv_bfloat16*>(out), rows,
      d, eps);
  return static_cast<int>(cudaGetLastError());
}
