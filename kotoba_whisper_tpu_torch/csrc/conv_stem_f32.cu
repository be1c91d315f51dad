// Whisper's audio stem (K7) in fp32 for Hopper's CUDA cores: conv1 (k3,
// s1, pad 1) + GELU, then conv2 (k3, s2, pad 1) + GELU, from (B, n_mels, T)
// log-mel to (B, T/2, d).
//
// Replaces: kotoba_whisper_tpu/ops/conv_stem.py `_stem_kernel` (called
// through `conv_stem_pallas`) run on fp32 inputs, where the TPU kernel
// works in the activations' dtype: each conv sums its products in fp32 and
// adds its bias in fp32, then GELU in its erf form in fp32; conv2's zero
// padding applies to the post-GELU conv1 output. In fp32 nothing is rounded
// between the steps. GELU takes CUDA's erff (within 2 ulps), as the plain
// twin takes torch.erf; the TPU kernel's rational erf (|err| <= 1.5e-7,
// which the bf16 form keeps) sits further from both than fp32 resolves.
//
// What bounds it on the card: operations. At B=16, T=3000, 128 mels,
// d=1280 the two convs are 2*B*T*(3*128)*d + 2*B*(T/2)*(3*d)*d = 283 GFLOP,
// 4.2 ms at the 67 TFLOP/s of fp32 FMA, against ~0.5 GB of fp32 input,
// weights, y1 and output (~0.15 ms at 3.35 TB/s). The tensor cores take
// fp32 only as TF32 (a 10-bit mantissa), which would lose the fp32 parity
// this form exists for, so every product is an fp32 FFMA.
//
// Design: two launches of one implicit-GEMM kernel template, one
// instantiation per conv stride, through an fp32 intermediate y1 (B, T, d)
// in global memory, as the bf16 form does. Each launch is a GEMM C[m][n] =
// sum over taps t and channels c of A[stride*i + t - 1][c] * W[n][t][c] for
// m = (b, i), rows outside [0, T) read as zero (the conv's padding), with
// the (d, 3, C_in) tap-major weights the wrapper lays out once per weight
// version (ops/conv_stem.py `tap_major_weights`). A CTA of 256 threads
// computes a 128 x 128 output tile (a tile may span two batch elements:
// each row finds its own once, before the K loop) in K steps of 16
// channels of one tap (the taps outer, channels past C_in zero), so no
// step divides: A (128 rows x 16) and W (16 x 128 channels) go to shared
// memory by 4-byte cp.asyncs (zero-filled outside), two stages, the next
// step's copies in flight while this step is computed. A is read along its
// contiguous dimension (conv1: x's frames, (B, C, T); conv2: y1's
// channels). Thread (ty, tx) of a 16 x 16 grid accumulates its 8 x 8
// block (rows 4ty.. and 64 + 4ty.., channels 4tx.. and 64 + 4tx..) from
// two float4s of A and two of W a step: 64 FFMAs for four shared loads.
// Two CTAs an SM (at most 128 registers). The epilogue adds the bias,
// applies GELU and stores float4s.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "card.cuh"
#include "sm90_common.cuh"

namespace {

using kwt_sm90::cp_async4;
using kwt_sm90::cp_async_commit;
using kwt_sm90::cp_async_wait;

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kPadM = kBM + 4, kPadN = kBN + 4;  // keeps the rows 16-byte aligned
constexpr int kRows = kBM * kBK / kThreads;      // A (and W) elements a thread copies a step

struct Stage {
  float a[kBK][kPadM];  // A^T of the step: channel, row
  float w[kBK][kPadN];  // W^T of the step: channel, output channel
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// One conv + GELU. in: element (b, t, c) at b * in_b + t * in_t + c * in_c;
// w: (d, 3, c_in) tap-major; out: (batch, t_out, d) contiguous. kStride 1
// reads x (B, C, T), whose frames are contiguous, a thread's copies along
// rows; kStride 2 reads y1 (B, T, d), whose channels are, along channels.
template <int kStride>
__global__ void __launch_bounds__(kThreads, 2)
    conv_gelu_f32_kernel(const float* __restrict__ in, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ out, int batch,
                         int t_in, int t_out, int c_in, int d, long long in_b, long long in_t,
                         long long in_c) {
  __shared__ __align__(16) Stage st[2];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int n0 = blockIdx.x * kBN;
  const long long m0 = (long long)blockIdx.y * kBM;
  const long long n_rows = (long long)batch * t_out;

  // this thread's copies: A row ml(r) at channel kl(r) of each step, W
  // output channel nl(r) at channel kwl; rows and channels fixed over steps
  auto a_row = [&](int r) { return kStride == 1 ? tid % kBM : tid / kBK + r * (kThreads / kBK); };
  auto a_kl = [&](int r) { return kStride == 1 ? tid / kBM + r * (kThreads / kBM) : tid % kBK; };
  long long a_base[kRows];  // batch element's offset, or -1 past the rows
  int a_t[kRows];           // stride * i - 1: the row's first input frame
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long m = m0 + a_row(r);
    const int b = (int)(m / t_out), i = (int)(m - (long long)b * t_out);
    a_base[r] = m < n_rows ? b * in_b : -1;
    a_t[r] = kStride * i - 1;
  }
  const int kwl = tid % kBK;
  const int w_row = 3 * c_in;

  auto issue = [&](int step, Stage& sg) {
    const int tap = step / ((c_in + kBK - 1) / kBK);
    const int c0 = (step - tap * ((c_in + kBK - 1) / kBK)) * kBK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int c = c0 + a_kl(r), t = a_t[r] + tap;
      const bool ok = a_base[r] >= 0 && c < c_in && t >= 0 && t < t_in;
      cp_async4(&sg.a[a_kl(r)][a_row(r)], ok ? in + a_base[r] + t * in_t + c * in_c : in,
                ok ? 4 : 0);
      const int n = n0 + tid / kBK + r * (kThreads / kBK);
      const bool wok = n < d && c0 + kwl < c_in;
      cp_async4(&sg.w[kwl][tid / kBK + r * (kThreads / kBK)],
                wok ? w + (long long)n * w_row + tap * c_in + c0 + kwl : w, wok ? 4 : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_steps = 3 * ((c_in + kBK - 1) / kBK);
  issue(0, st[0]);
  cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) issue(s + 1, st[(s + 1) & 1]);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of step s have landed
    __syncthreads();     // and everyone's
    const Stage& sg = st[s & 1];
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sg.a[k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sg.a[k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sg.w[k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sg.w[k][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // step s's stage is read before step s + 2's copies refill it
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m >= n_rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + 64 * half + 4 * tx;
      if (n >= d) continue;  // d % 4 == 0: a float4 is in or out whole
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = gelu_erf(acc[i][4 * half + j] + bias[n + j]);
      *reinterpret_cast<float4*>(out + m * d + n) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

}  // namespace

// x (B, C, T) fp32 contiguous; w1 (d, 3, C) and w2 (d, 3, d) fp32
// tap-major, b1 and b2 (d,) fp32; y1 (B, T, d) fp32 scratch; out (B, T/2,
// d) fp32. plan (ops/conv_stem.py `_conv_stem_f32`): batch, T, C, d (d % 4
// == 0). Two launches on `stream`; returns the first failing launch's
// cudaError_t.
extern "C" int kwt_conv_stem_f32(int card, const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, void* y1, void* out,
                                 const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  const int batch = static_cast<int>(plan[0]), t = static_cast<int>(plan[1]);
  const int c_in = static_cast<int>(plan[2]), d = static_cast<int>(plan[3]);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int n_tiles = (d + kBN - 1) / kBN;
  const long long rows1 = (long long)batch * t, rows2 = (long long)batch * (t / 2);
  conv_gelu_f32_kernel<1><<<dim3(n_tiles, static_cast<unsigned>((rows1 + kBM - 1) / kBM)),
                            kThreads, 0, cs>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<float*>(y1), batch, t, t, c_in, d,
      (long long)c_in * t, 1, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_gelu_f32_kernel<2><<<dim3(n_tiles, static_cast<unsigned>((rows2 + kBM - 1) / kBM)),
                            kThreads, 0, cs>>>(
      static_cast<const float*>(y1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), batch, t, t / 2, d, d,
      (long long)t * d, d, 1);
  return static_cast<int>(cudaGetLastError());
}
