// Fused log-mel frontend (K3) for Hopper, fp32 throughout.
//
// Replaces: kotoba_whisper_tpu/ops/mel_pallas.py `_mel_kernel` (called
// through `log_mel_spectrogram_pallas`): framing of the reflect-padded
// signal, the Hann-folded real DFT (400 samples -> 201 bins), the power
// spectrum, the slaney mel projection and log10(max(x, 1e-10)). The
// per-utterance max-8 clamp, (x+4)/4 and the transpose stay outside.
//
// What bounds it on the card: per 30 s utterance the function reads 1.9 MB
// (0.96 MB over the int16 wire) and writes 1.5 MB, about 1 us at 3.35 TB/s;
// at a real FFT's cost (~11k flops a frame, 32 MFLOP an utterance) its
// operations take less, so the function is bound by its bytes. This kernel
// keeps the TPU kernel's dense Hann-folded DFT, ~0.97 GFLOP of fp32 FMAs an
// utterance (the mel projection's 394 filter nonzeros add ~2 MFLOP), about
// 14 us at the 67 TFLOP/s fp32 CUDA-core peak: the design is bound by its
// own FMAs, ~14x above the byte floor. An FFT-based kernel would close that.
// The TPU ran these products at Precision.HIGHEST, so there is no TF32 or
// reduced-precision tensor-core path here: plain fp32 FMAs.
//
// Design: a block owns 32 consecutive frames of one utterance. Those frames
// need one contiguous span of (32-1)*160+400 = 5360 samples, which is
// loaded once into shared memory with the reflect padding and the int16
// 1/32768 scaling applied on the fly (the TPU's three-row-slice framing
// solves a TPU gather problem the card does not have). The cos/sin tables
// (400 x 201 each, 322 KB apiece) do not fit in shared memory, so they are
// streamed through it from L2, 8 DFT rows a stage, padded to 208 bins and
// double-buffered with cp.async so the next stage loads while this one is
// used. 208 threads = 52 groups of 4 adjacent bins x 4 frame groups; each
// thread keeps 8 frames x 4 bins of real and imaginary sums in registers
// (64 accumulators) and reads samples and table values as float4, 16
// shared loads per 256 FMAs. The power spectrum then replaces the table
// stages in shared memory. The slaney filters are triangles over a few
// adjacent bins (394 nonzeros of 201 x 128), so each mel sums only its
// filter's [lo, hi) bin range, in the same order as a dense sum, which
// skips only exact zeros.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kBinsPad = 208;
constexpr int kFrames = 32;                         // frames per block
constexpr int kTX = 52, kTY = 4;                    // bin groups x frame groups
constexpr int kBPT = kBinsPad / kTX;                // 4 adjacent bins a thread
constexpr int kFPT = kFrames / kTY;                 // 8 frames a thread
constexpr int kThreads = kTX * kTY;                 // 208
constexpr int kRows = 8;                            // DFT rows per table stage
constexpr int kSpan = (kFrames - 1) * kHop + kNFFT; // 5360 samples
constexpr int kRow = 2 * kBinsPad;                  // floats per table row
constexpr int kStage = kRows * kRow;                // 3328 floats
static_assert(kBPT == 4, "bins are read as float4");
static_assert(kFrames * kBinsPad <= 2 * kStage, "power tile must fit the stages");
static_assert(kNFFT % kRows == 0 && kRows % 4 == 0, "stages tile the DFT rows");
static_assert(kStage / 4 % kThreads == 0, "each thread copies whole chunks");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Table rows [stage*kRows, +kRows) into `dst`, 16 bytes a copy.
__device__ __forceinline__ void load_stage(float* dst, const float* table,
                                           int stage, int tid) {
  const float* src = table + (long)stage * kStage;
#pragma unroll
  for (int i = 0; i < kStage / 4 / kThreads; ++i) {
    const int c = (tid + i * kThreads) * 4;
    cp_async16(dst + c, src + c);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
    mel_kernel(const In* __restrict__ audio, const float* __restrict__ table,
               const float* __restrict__ fb, const int* __restrict__ fb_lo,
               const int* __restrict__ fb_hi, float* __restrict__ out,
               long n_samples, int n_frames, int n_mels, float in_scale) {
  __shared__ __align__(16) float sig[kSpan];
  __shared__ __align__(16) float stage[2][kStage];  // table rows, then power

  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int b = blockIdx.y, f0 = blockIdx.x * kFrames;
  const In* a = audio + (long)b * n_samples;

  load_stage(stage[0], table, 0, tid);

  // Reflect-padded samples [f0*hop, f0*hop + span) of the padded signal.
  const long p0 = (long)f0 * kHop;
  for (int i = tid; i < kSpan; i += kThreads) {
    const long p = p0 + i;
    float x = 0.f;
    if (p < n_samples + kNFFT) {
      long idx = p - kNFFT / 2;
      if (idx < 0) idx = -idx;
      if (idx >= n_samples) idx = 2 * (n_samples - 1) - idx;
      x = static_cast<float>(a[idx]) * in_scale;
    }
    sig[i] = x;
  }

  float re[kFPT][kBPT], im[kFPT][kBPT];
#pragma unroll
  for (int i = 0; i < kFPT; ++i)
#pragma unroll
    for (int j = 0; j < kBPT; ++j) re[i][j] = im[i][j] = 0.f;

  constexpr int kStages = kNFFT / kRows;
  for (int st = 0; st < kStages; ++st) {
    if (st + 1 < kStages) {
      load_stage(stage[(st + 1) & 1], table, st + 1, tid);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* w = stage[st & 1];
    const int n0 = st * kRows;
#pragma unroll
    for (int g = 0; g < kRows; g += 4) {
      float4 xs[kFPT];  // samples n0+g .. n0+g+3 of each frame
#pragma unroll
      for (int i = 0; i < kFPT; ++i)
        xs[i] = *reinterpret_cast<const float4*>(sig + (ty + kTY * i) * kHop + n0 + g);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 wr = *reinterpret_cast<const float4*>(w + (g + u) * kRow + tx * kBPT);
        const float4 wi =
            *reinterpret_cast<const float4*>(w + (g + u) * kRow + kBinsPad + tx * kBPT);
#pragma unroll
        for (int i = 0; i < kFPT; ++i) {
          const float x = lane4(xs[i], u);
          re[i][0] = fmaf(x, wr.x, re[i][0]);
          re[i][1] = fmaf(x, wr.y, re[i][1]);
          re[i][2] = fmaf(x, wr.z, re[i][2]);
          re[i][3] = fmaf(x, wr.w, re[i][3]);
          im[i][0] = fmaf(x, wi.x, im[i][0]);
          im[i][1] = fmaf(x, wi.y, im[i][1]);
          im[i][2] = fmaf(x, wi.z, im[i][2]);
          im[i][3] = fmaf(x, wi.w, im[i][3]);
        }
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this stage
  }

  float* power = &stage[0][0];  // (kFrames, kBinsPad); padded bins are 0
#pragma unroll
  for (int i = 0; i < kFPT; ++i) {
    const float4 pw = make_float4(
        re[i][0] * re[i][0] + im[i][0] * im[i][0], re[i][1] * re[i][1] + im[i][1] * im[i][1],
        re[i][2] * re[i][2] + im[i][2] * im[i][2], re[i][3] * re[i][3] + im[i][3] * im[i][3]);
    *reinterpret_cast<float4*>(power + (ty + kTY * i) * kBinsPad + tx * kBPT) = pw;
  }
  __syncthreads();

  for (int idx = tid; idx < kFrames * n_mels; idx += kThreads) {
    const int fi = idx / n_mels, m = idx - fi * n_mels;
    const int f = f0 + fi;
    if (f >= n_frames) continue;
    const float* pw = power + fi * kBinsPad;
    float s = 0.f;
    for (int k = fb_lo[m]; k < fb_hi[m]; ++k) s = fmaf(pw[k], __ldg(fb + k * n_mels + m), s);
    out[((long)b * n_frames + f) * n_mels + m] = log10f(fmaxf(s, 1e-10f));
  }
}

}  // namespace

// audio (B, n_samples) fp32 (in_int16=0) or int16 (in_int16=1, scaled by
// 1/32768); table (400, 2, 208) fp32 Hann-folded cos|sin rows; fb (201,
// n_mels) fp32 with each mel's nonzero bin range [fb_lo[m], fb_hi[m]) as
// int32 -> out (B, n_frames, n_mels) fp32 log10 mel (unclamped).
extern "C" int kwt_log_mel(const void* audio, int in_int16, const void* table,
                           const void* fb, const void* fb_lo, const void* fb_hi,
                           void* out, int batch,
                           long long n_samples, int n_frames, int n_mels,
                           void* stream) {
  dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_int16)
    mel_kernel<int16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int16_t*>(audio), static_cast<const float*>(table),
        static_cast<const float*>(fb), static_cast<const int*>(fb_lo),
        static_cast<const int*>(fb_hi), static_cast<float*>(out), n_samples,
        n_frames, n_mels, 1.0f / 32768.0f);
  else
    mel_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(audio), static_cast<const float*>(table),
        static_cast<const float*>(fb), static_cast<const int*>(fb_lo),
        static_cast<const int*>(fb_hi), static_cast<float*>(out), n_samples,
        n_frames, n_mels, 1.0f);
  return static_cast<int>(cudaGetLastError());
}
