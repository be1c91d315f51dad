// Fused log-mel frontend (K3) for Hopper, fp32 throughout.
//
// Replaces: kotoba_whisper_tpu/ops/mel_pallas.py `_mel_kernel` (called
// through `log_mel_spectrogram_pallas`): framing of the reflect-padded
// signal, the Hann-windowed real DFT (400 samples -> 201 bins), the power
// spectrum, the slaney mel projection and log10(max(x, 1e-10)). The
// per-utterance max-8 clamp, (x+4)/4 and the transpose stay outside.
//
// What bounds it on the card: per 30 s utterance the function reads 1.9 MB
// (0.96 MB over the int16 wire) and writes 1.5 MB, about 1 us at 3.35 TB/s.
// A real FFT costs ~11k flops a frame, 32 MFLOP an utterance, about 0.5 us
// at the 67 TFLOP/s fp32 CUDA-core peak, so the function is bound by its
// bytes. The TPU computed the DFT as dense Hann-folded cos/sin products
// (~0.97 GFLOP an utterance) because its matrix unit makes them cheap; on
// the card that design is bound by its own FMAs, so this kernel takes the
// FFT. The TPU ran at Precision.HIGHEST: plain fp32 here, no TF32 and no
// tensor cores. An FFT's rounding grows like log N, the dense DFT's like
// sqrt N.
//
// Design: a block of 512 threads owns 16 consecutive frames of one
// utterance. They need one contiguous span of (16-1)*160+400 = 2800
// samples, loaded once into shared memory (all of a thread's loads in
// flight together) with the reflect padding and the int16 1/32768 scaling
// applied on the fly, beside the plan table (ops/mel.py `fft_table`:
// window, radix constants and twiddles built in float64 and rounded once to
// fp32, 4.8 KB) and the compact filterbank (`filter_weights`: each mel's
// nonzero weights, 1.6 KB at 128 mels). 75 KB of shared memory a block lets
// three blocks share an SM, so one block's loads overlap another's FFT.
// Each frame's real 400-point DFT is a 200-point complex FFT of
// z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1] in three Stockham stages in shared
// memory, radix 8 then 5 then 5 (ops/mel.py `FFT_STAGES`, whose
// `fft_index_maps` spell out the indices used here): each thread takes a
// butterfly, reads its R inputs, applies the stage's twiddles, computes the
// R-point DFT in registers and writes its R outputs to the other buffer.
// The first stage reads the window and samples straight from the span. The
// buffers hold a frame in 225 float2 slots, one pad after every 8 points, so
// the first stage's writes (8 apart) fall in distinct banks. The real split
//   X[k] = (Z[k] + conj Z[200-k]) / 2 - i e^{-2 pi i k/400} (Z[k] - conj Z[200-k]) / 2
// gives bins k and 200-k to one thread, which writes their power to shared
// memory. The slaney filters are triangles over a few adjacent bins (394
// nonzeros of 201 x 128), so each mel sums only its filter's [lo, hi) bin
// range, in the same order as a dense sum, which skips only exact zeros,
// with every operand in shared memory; a thread keeps one mel's filter and
// sums it over several frames at once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "card.cuh"

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kN = kNFFT / 2;                        // complex FFT points
constexpr int kBins = kN + 1;                        // 201
constexpr int kFrames = 16;                          // frames per block
constexpr int kThreads = 512;
constexpr int kSpan = (kFrames - 1) * kHop + kNFFT;  // 2800 samples
constexpr int kLoads = (kSpan + kThreads - 1) / kThreads;  // samples a thread loads
constexpr int kPitch = kN + kN / 8;                  // float2 slots per frame (225)
// the plan table (ops/mel.py FFT_TABLE_LAYOUT), offsets in floats
constexpr int kWin = 0, kRadix = 400, kTw2 = 408, kTw3 = 472, kSplit = 792, kTable = 1194;
// the compact filterbank (ops/mel.py MAX_MELS, MAX_FILTER_WEIGHTS)
constexpr int kMaxMels = 128, kMaxWeights = 512;
// frames a thread sums each mel for: the block's threads split into
// kThreads / n_mels groups of frames, at least 4
constexpr int kMelFrames = (kFrames * kMaxMels + kThreads - 1) / kThreads;
static_assert(kFrames * kBins <= 2 * kFrames * kPitch, "the power fits one FFT buffer");
static_assert(kThreads == kMaxWeights && kThreads > kMaxMels, "one table entry a thread");

struct __align__(16) Smem {
  float sig[kSpan];
  float tab[kTable + 2];   // + 2: keeps what follows 16-byte aligned
  float fw[kMaxWeights];   // each mel's filter weights, mel after mel
  int flo[kMaxMels];       // each mel's first bin
  int foff[kMaxMels + 4];  // where each mel's weights start; [n_mels] = the total
  float2 a[kFrames * kPitch];
  float2 b[kFrames * kPitch];
};

// slot of FFT point i: one pad after every 8 points
__device__ __forceinline__ int slot(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 mul_i(float2 a) { return make_float2(a.y, -a.x); }  // -i a
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// forward 8-point DFT in place, c = cos(pi/4)
__device__ __forceinline__ void dft8(float2* v, float c) {
  float2 a0 = add(v[0], v[4]), a4 = sub(v[0], v[4]);
  float2 a1 = add(v[1], v[5]), a5 = sub(v[1], v[5]);
  float2 a2 = add(v[2], v[6]), a6 = sub(v[2], v[6]);
  float2 a3 = add(v[3], v[7]), a7 = sub(v[3], v[7]);
  a5 = make_float2(c * (a5.x + a5.y), c * (a5.y - a5.x));   // * e^{-i pi/4}
  a6 = mul_i(a6);                                           // * e^{-i pi/2}
  a7 = make_float2(c * (a7.y - a7.x), -c * (a7.x + a7.y));  // * e^{-3i pi/4}
  const float2 b0 = add(a0, a2), b2 = sub(a0, a2), b1 = add(a1, a3), b3 = mul_i(sub(a1, a3));
  const float2 b4 = add(a4, a6), b6 = sub(a4, a6), b5 = add(a5, a7), b7 = mul_i(sub(a5, a7));
  v[0] = add(b0, b1);
  v[1] = add(b4, b5);
  v[2] = add(b2, b3);
  v[3] = add(b6, b7);
  v[4] = sub(b0, b1);
  v[5] = sub(b4, b5);
  v[6] = sub(b2, b3);
  v[7] = sub(b6, b7);
}

// forward 5-point DFT in place; c1, s1 = cos, sin(2pi/5), c2, s2 = of 4pi/5
__device__ __forceinline__ void dft5(float2* v, float c1, float s1, float c2, float s2) {
  const float2 sa = add(v[1], v[4]), da = sub(v[1], v[4]);
  const float2 sb = add(v[2], v[3]), db = sub(v[2], v[3]);
  const float2 x0 = v[0];
  const float2 r1 = make_float2(x0.x + c1 * sa.x + c2 * sb.x, x0.y + c1 * sa.y + c2 * sb.y);
  const float2 r2 = make_float2(x0.x + c2 * sa.x + c1 * sb.x, x0.y + c2 * sa.y + c1 * sb.y);
  const float2 i1 = mul_i(make_float2(s1 * da.x + s2 * db.x, s1 * da.y + s2 * db.y));
  const float2 i2 = mul_i(make_float2(s2 * da.x - s1 * db.x, s2 * da.y - s1 * db.y));
  v[0] = add(x0, add(sa, sb));
  v[1] = add(r1, i1);
  v[4] = sub(r1, i1);
  v[2] = add(r2, i2);
  v[3] = sub(r2, i2);
}

// A radix-5 Stockham stage over every frame of the block: butterfly j reads
// points j + 40r, twiddles input r by tw[(r-1) * kNs + j % kNs] and writes
// output r to (j / kNs) * 5 * kNs + j % kNs + r * kNs.
template <int kNs>
__device__ __forceinline__ void radix5_stage(const float2* __restrict__ src,
                                             float2* __restrict__ dst, const float2* tw,
                                             const float* radix, int tid) {
  for (int idx = tid; idx < kFrames * (kN / 5); idx += kThreads) {
    const int f = idx / (kN / 5), j = idx - f * (kN / 5), t = j % kNs;
    const float2* x = src + f * kPitch;
    float2 v[5];
#pragma unroll
    for (int r = 0; r < 5; ++r) v[r] = x[slot(j + r * (kN / 5))];
#pragma unroll
    for (int r = 1; r < 5; ++r) v[r] = cmul(v[r], tw[(r - 1) * kNs + t]);
    dft5(v, radix[1], radix[2], radix[3], radix[4]);
    float2* y = dst + f * kPitch;
    const int o = (j / kNs) * 5 * kNs + t;
#pragma unroll
    for (int r = 0; r < 5; ++r) y[slot(o + r * kNs)] = v[r];
  }
}

// |X[k]|^2 from Z[k], Z[200-k] and e = e^{-2 pi i k/400}
__device__ __forceinline__ float split_power(float2 zk, float2 zn, float2 e) {
  const float ax = zk.x + zn.x, ay = zk.y - zn.y;  // Z[k] + conj Z[200-k]
  const float bx = zk.x - zn.x, by = zk.y + zn.y;  // Z[k] - conj Z[200-k]
  const float p = e.x * bx - e.y * by, q = e.x * by + e.y * bx;
  const float xr = 0.5f * (ax + q), xi = 0.5f * (ay - p);
  return xr * xr + xi * xi;
}

template <typename In>
__global__ void __launch_bounds__(kThreads, 3)
    mel_kernel(const In* __restrict__ audio, const float* __restrict__ table,
               const float* __restrict__ fb_w, const int* __restrict__ fb_lo,
               const int* __restrict__ fb_off, float* __restrict__ out,
               long n_samples, int n_frames, int n_mels, float in_scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.y, f0 = blockIdx.x * kFrames;
  const In* a = audio + (long)b * n_samples;

  // Reflect-padded samples [f0*hop, f0*hop + span) of the padded signal,
  // that is samples s0.. of the clip: every load issued before any store.
  // Only the blocks at either end of a clip reflect (or pass its padded end).
  const int n = static_cast<int>(n_samples), s0 = f0 * kHop - kNFFT / 2;
  const bool inside = s0 >= 0 && s0 + kSpan <= n;
  float x[kLoads];
#pragma unroll
  for (int r = 0; r < kLoads; ++r) {
    int idx = s0 + tid + r * kThreads;
    x[r] = 0.f;
    if (tid + r * kThreads < kSpan && (inside || idx < n + kNFFT / 2)) {
      if (!inside) {
        if (idx < 0) idx = -idx;
        if (idx >= n) idx = 2 * (n - 1) - idx;
      }
      x[r] = static_cast<float>(a[idx]) * in_scale;
    }
  }
  for (int i = tid; i < kTable; i += kThreads) s.tab[i] = table[i];
  s.fw[tid] = fb_w[tid];
  if (tid < n_mels) s.flo[tid] = fb_lo[tid];
  if (tid <= n_mels) s.foff[tid] = fb_off[tid];
#pragma unroll
  for (int r = 0; r < kLoads; ++r)
    if (tid + r * kThreads < kSpan) s.sig[tid + r * kThreads] = x[r];
  __syncthreads();
  const float* radix = s.tab + kRadix;

  // Stage 1, radix 8 (span 1): butterfly j reads points j + 25r, each the
  // windowed sample pair (2n, 2n+1), and writes output r to 8j + r.
  for (int idx = tid; idx < kFrames * (kN / 8); idx += kThreads) {
    const int f = idx / (kN / 8), j = idx - f * (kN / 8);
    const float* x = s.sig + f * kHop;
    float2 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = 2 * (j + r * (kN / 8));
      const float2 xs = *reinterpret_cast<const float2*>(x + n);
      const float2 ws = *reinterpret_cast<const float2*>(s.tab + kWin + n);
      v[r] = make_float2(ws.x * xs.x, ws.y * xs.y);
    }
    dft8(v, radix[0]);
    float2* y = s.a + f * kPitch;
#pragma unroll
    for (int r = 0; r < 8; ++r) y[slot(8 * j + r)] = v[r];
  }
  __syncthreads();
  radix5_stage<8>(s.a, s.b, reinterpret_cast<const float2*>(s.tab + kTw2), radix, tid);
  __syncthreads();
  radix5_stage<40>(s.b, s.a, reinterpret_cast<const float2*>(s.tab + kTw3), radix, tid);
  __syncthreads();

  // Real split: bins k and 200-k from Z[k] and Z[200-k] (Z[200] = Z[0]).
  float* power = reinterpret_cast<float*>(s.b);  // (kFrames, kBins)
  const float2* e = reinterpret_cast<const float2*>(s.tab + kSplit);
  for (int idx = tid; idx < kFrames * (kN / 2 + 1); idx += kThreads) {
    const int f = idx / (kN / 2 + 1), k = idx - f * (kN / 2 + 1);
    const float2* z = s.a + f * kPitch;
    const float2 zk = z[slot(k)], zn = z[slot(k == 0 ? 0 : kN - k)];
    float* pw = power + f * kBins;
    pw[k] = split_power(zk, zn, e[k]);
    pw[kN - k] = split_power(zn, zk, e[kN - k]);
  }
  __syncthreads();

  // Mel m of frames g, g + groups, ...: one filter a thread, its frames'
  // sums side by side.
  const int groups = kThreads / n_mels, g = tid / n_mels, m = tid - g * n_mels;
  if (g < groups) {
    const int w0 = s.foff[m], w1 = s.foff[m + 1];
    const float* pw = power + s.flo[m] - w0;  // pw[w0] is bin lo of frame 0
    float sum[kMelFrames];
#pragma unroll
    for (int u = 0; u < kMelFrames; ++u) sum[u] = 0.f;
    for (int i = w0; i < w1; ++i) {
      const float w = s.fw[i];
#pragma unroll
      for (int u = 0; u < kMelFrames; ++u)
        if (g + u * groups < kFrames) sum[u] = fmaf(pw[(g + u * groups) * kBins + i], w, sum[u]);
    }
#pragma unroll
    for (int u = 0; u < kMelFrames; ++u) {
      const int fi = g + u * groups;
      if (fi < kFrames && f0 + fi < n_frames)
        out[((long)b * n_frames + f0 + fi) * n_mels + m] = log10f(fmaxf(sum[u], 1e-10f));
    }
  }
}

template <typename In>
int launch(int card, const void* audio, const void* table, const void* fb_w, const void* fb_lo,
           const void* fb_off, void* out, int batch, long long n_samples, int n_frames,
           int n_mels, float in_scale, cudaStream_t stream) {
  static bool ready[kwt_card::kMaxCards] = {};
  if (!ready[card]) {
    const cudaError_t err = cudaFuncSetAttribute(
        mel_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(sizeof(Smem)));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[card] = true;
  }
  dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  mel_kernel<In><<<grid, kThreads, sizeof(Smem), stream>>>(
      static_cast<const In*>(audio), static_cast<const float*>(table),
      static_cast<const float*>(fb_w), static_cast<const int*>(fb_lo),
      static_cast<const int*>(fb_off), static_cast<float*>(out), n_samples, n_frames, n_mels,
      in_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// audio (B, n_samples) fp32 (in_int16=0) or int16 (in_int16=1, scaled by
// 1/32768); table the fp32 FFT plan (ops/mel.py `fft_table`); the compact
// filterbank (`filter_weights`): fb_w (kMaxWeights,) fp32 weights, fb_lo
// (n_mels,) and fb_off (n_mels + 1,) int32, n_mels <= kMaxMels -> out (B,
// n_frames, n_mels) fp32 log10 mel (unclamped). Returns the launch's
// cudaError_t.
extern "C" int kwt_log_mel(int card, const void* audio, int in_int16, const void* table,
                           const void* fb_w, const void* fb_lo, const void* fb_off,
                           void* out, int batch,
                           long long n_samples, int n_frames, int n_mels,
                           void* stream) {
  if (n_mels > kMaxMels) return static_cast<int>(cudaErrorInvalidValue);
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_int16 ? launch<int16_t>(card, audio, table, fb_w, fb_lo, fb_off, out, batch,
                                    n_samples, n_frames, n_mels, 1.0f / 32768.0f, s)
                  : launch<float>(card, audio, table, fb_w, fb_lo, fb_off, out, batch, n_samples,
                                  n_frames, n_mels, 1.0f, s);
}
