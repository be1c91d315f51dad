// Exponential / softmax calibration (K9) for Hopper: the per-score body
// of the attention kernels' softmax (or a bare exponential), repeated over
// a block of scores that stays on chip, so the loop measures the SM's
// exponential throughput and nothing of the memory.
//
// Replaces: tools/vpu_cal.py `_kernel` (its pallas_call at :76), which
// measured the TPU vector unit's softmax wall with the same loop:
//   s = x + acc * 1e-9             (a loop-carried dependency: no iteration
//                                   can be hoisted or shared)
//   softmax: m = max_j s, p = exp(s - m), l = sum_j p, acc += sum_j p / l
//   exp:     acc += sum_j exp(s)
// over (rows, cols) fp32 scores, `iters` times, -> acc (rows, 1).
//
// What bounds it on the card: operations, and among them the exponentials
// on the special function units (16 ex2 a clock per SM on the data sheet,
// ~3.9e12/s over 132 SMs at ~1.8 GHz): 512 x 1536 x 64 = 5.0e7 of them,
// about 0.013 ms. The 3 MB block is read once (about 1 us at 3.35 TB/s).
//
// Design: the TPU kernel holds the whole (512, 1536) block in VMEM on one
// core; 3 MB does not fit one SM, so the rows are spread over the card:
// one 256-thread block per row, each thread keeping its cols/256 scores in
// registers for the whole loop (no memory traffic inside it). The
// exponential is the one the attention kernels use, exp2f on log2(e)-
// scaled scores (csrc/flash_attention_bwd.cu). The row max and sums are block
// reductions (warp shuffles, then eight warp partials through shared
// memory, combined in the same order by every thread so all hold the same
// acc). Columns past `cols` hold -inf, which adds nothing to any sum.
#include <cuda_runtime.h>
#include <math.h>

#include "card.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <int kPer, bool kSoftmax>
__global__ void __launch_bounds__(kThreads)
    cal_kernel(const float* __restrict__ x, float* __restrict__ out, int cols,
               int iters) {
  __shared__ float red[kWarps];
  const int row = blockIdx.x;
  float xv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = threadIdx.x + j * kThreads;
    xv[j] = c < cols ? x[(long)row * cols + c] : -INFINITY;
  }
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    float s[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = xv[j] + acc * 1e-9f;
    if (kSoftmax) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPer; ++j) m = fmaxf(m, s[j]);
      m = block_reduce<true>(m, red);
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) l += exp2f((s[j] - m) * kLog2e);
      l = block_reduce<false>(l, red);
      acc = acc + l / l;
    } else {
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) e += exp2f(s[j] * kLog2e);
      acc = acc + block_reduce<false>(e, red);
    }
  }
  if (threadIdx.x == 0) out[row] = acc;
}

template <int kPer>
void launch(bool softmax, const float* x, float* out, int rows, int cols,
            int iters, cudaStream_t s) {
  if (softmax)
    cal_kernel<kPer, true><<<rows, kThreads, 0, s>>>(x, out, cols, iters);
  else
    cal_kernel<kPer, false><<<rows, kThreads, 0, s>>>(x, out, cols, iters);
}

}  // namespace

// x (rows, cols) fp32 with cols <= 2048; out (rows,) fp32. op_softmax != 0
// runs the softmax body, else the bare exponential. Returns the launch's
// cudaError_t.
extern "C" int kwt_vpu_cal(int card, const void* x, void* out, int rows, int cols,
                           int iters, int op_softmax, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sm = op_softmax != 0;
  switch ((cols + kThreads - 1) / kThreads) {
    case 1: launch<1>(sm, xf, of, rows, cols, iters, s); break;
    case 2: launch<2>(sm, xf, of, rows, cols, iters, s); break;
    case 3: launch<3>(sm, xf, of, rows, cols, iters, s); break;
    case 4: launch<4>(sm, xf, of, rows, cols, iters, s); break;
    case 5: launch<5>(sm, xf, of, rows, cols, iters, s); break;
    case 6: launch<6>(sm, xf, of, rows, cols, iters, s); break;
    case 7: launch<7>(sm, xf, of, rows, cols, iters, s); break;
    case 8: launch<8>(sm, xf, of, rows, cols, iters, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
