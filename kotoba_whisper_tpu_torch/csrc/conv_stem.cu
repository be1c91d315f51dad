// Whisper's audio stem (K7) for Hopper, bf16: conv1 (k3, s1, pad 1) +
// GELU, then conv2 (k3, s2, pad 1) + GELU, from (B, T, n_mels) rows to
// (B, T/2, d).
//
// Replaces: kotoba_whisper_tpu/ops/conv_stem.py `_stem_kernel` (called
// through `conv_stem_pallas`), with its numerics: each conv sums its
// products in fp32 and adds its (bf16-rounded) bias in fp32 before one
// rounding to bf16; GELU is the exact erf form in fp32 on that rounded
// value, rounded again; conv2's zero padding applies to the post-GELU conv1
// output. erff replaces the TPU kernel's rational erf (|err| <= 1.5e-7, a
// Mosaic workaround).
//
// What bounds it on the card: operations. At B=16, T=3000, 128 mels,
// d=1280 the two convs are 2*B*T*(3*128)*d + 2*B*(T/2)*(3*d)*d = 283 GFLOP
// on the tensor cores (about 0.29 ms at 989 TFLOP/s), against 84 MB of
// input, weights and output (about 0.025 ms at 3.35 TB/s).
//
// Design: two launches of one implicit-GEMM kernel through a bf16
// intermediate y1 (B, T, d), instead of the TPU's single fused kernel: one
// conv2 output row needs three conv1 rows across all d channels, so a row
// tile of y1 wide enough to feed conv2 does not fit in 227 KB of shared
// memory. The TPU kernel rounds y1 to bf16 too, so the numbers are the
// same; the cost is y1's round trip through memory (2 x 96 MB at B=16).
// Each launch is a GEMM C[m][n] = sum over taps t and channels c of
// A[stride*i + t - 1][c] * W[n][t*C + c], where m = (b, i) runs over the
// output rows and input rows outside [0, T_in) read as zero (the conv's
// padding, taken by cp.async's zero fill). Blocks of 4 warps own 64 x 128
// output tiles and walk K in 32-wide chunks (each inside one tap), double-
// buffered with cp.async into shared memory whose 80-byte row pitch keeps
// ldmatrix free of bank conflicts; mma.sync m16n8k16 (bf16 operands, fp32
// sums), each warp 32 x 64. The epilogue adds the bias, rounds, applies
// GELU and rounds again. The wrapper lays x out as (B, T, C) rows and the
// weights as (d, 3*C) tap-major rows, as the TPU wrapper does before its
// kernel.
// Later work: wgmma + TMA, and the full fusion (y1 kept on chip, with a
// tiling over conv2's output channels).
#include "flash_common.cuh"

namespace {

using namespace kwt_flash;

constexpr int kBM = 64, kBN = 128, kBKc = 32;
constexpr int kPitch = kBKc + 8;  // 80-byte rows
constexpr int kConvThreads = 128;

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710677f));
}

template <int kStride>
__global__ void __launch_bounds__(kConvThreads)
    conv_tap_gemm(const __nv_bfloat16* __restrict__ a,
                  const __nv_bfloat16* __restrict__ w,
                  const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int m_rows, int t_in,
                  int t_out, int c_in, int n_out) {
  __shared__ __align__(128) __nv_bfloat16 sa[2][kBM * kPitch];
  __shared__ __align__(128) __nv_bfloat16 sb[2][kBN * kPitch];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int k_total = 3 * c_in;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;

  // This thread's two A-tile chunks: their rows' batch and output index.
  int a_b[2], a_i[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int m = m0 + ((tid + j * kConvThreads) >> 2);
    a_b[j] = m < m_rows ? m / t_out : -1;
    a_i[j] = m < m_rows ? m - (m / t_out) * t_out : 0;
  }

  auto load_chunk = [&](int buf, int k0) {
    const int tap = k0 / c_in, c0 = k0 - tap * c_in;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * kConvThreads, r = c >> 2, ch = c & 3;
      const int row = kStride * a_i[j] + tap - 1;
      const bool ok = a_b[j] >= 0 && row >= 0 && row < t_in;
      const __nv_bfloat16* src =
          a + (ok ? ((long)a_b[j] * t_in + row) * c_in + c0 + ch * 8 : 0);
      cp_async16(&sa[buf][r * kPitch + ch * 8], src, ok);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tid + j * kConvThreads, r = c >> 2, ch = c & 3;
      cp_async16(&sb[buf][r * kPitch + ch * 8],
                 w + (long)(n0 + r) * k_total + k0 + ch * 8, true);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) zero_acc(acc[mt]);

  const int n_chunks = k_total / kBKc;
  load_chunk(0, 0);
  for (int kc = 0; kc < n_chunks; ++kc) {
    const int buf = kc & 1;
    if (kc + 1 < n_chunks) {
      load_chunk(buf ^ 1, (kc + 1) * kBKc);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(af[mt], &sa[buf][(wm + mt * 16 + (lane & 15)) * kPitch + ks * 16 +
                                 (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        const int n = wn + np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bf, &sb[buf][n * kPitch + ks * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma16816(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }

  // Epilogue: + bias in fp32, round, exact GELU in fp32, round.
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + g + half * 8;
      if (m >= m_rows) continue;
      __nv_bfloat16* dst = out + (long)m * n_out + n0 + wn;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pre = __bfloat162float(__float2bfloat16_rn(
              acc[mt][nt][2 * half + e] + __bfloat162float(bias[n0 + wn + col + e])));
          y[e] = gelu_exact(pre);
        }
        *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(y[0], y[1]);
      }
    }
  }
}

template <int kStride>
int launch(const void* a, const void* w, const void* bias, void* out,
           int m_rows, int t_in, int t_out, int c_in, int n_out,
           cudaStream_t stream) {
  dim3 grid(n_out / kBN, (m_rows + kBM - 1) / kBM);
  conv_tap_gemm<kStride><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out),
      m_rows, t_in, t_out, c_in, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, T, C) bf16 rows; w1 (d, 3*C), w2 (d, 3*d) bf16 tap-major; b1, b2
// (d,) bf16; y1 (B, T, d) bf16 scratch; out (B, T/2, d) bf16. C % 32 == 0,
// d % 128 == 0, T even. Returns the first failing launch's cudaError_t.
extern "C" int kwt_conv_stem(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* y1,
                             void* out, int batch, int t, int c_in, int d,
                             void* stream) {
  if (c_in % kBKc != 0 || d % kBN != 0 || t % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = launch<1>(x, w1, b1, y1, batch * t, t, t, c_in, d, s);
  if (rc != 0) return rc;
  return launch<2>(y1, w2, b2, out, batch * (t / 2), t, t / 2, d, d, s);
}
