// Whisper's audio stem (K7) in fp32 for Hopper's tensor cores in 3xTF32:
// conv1 (k3, s1, pad 1) + GELU, then conv2 (k3, s2, pad 1) + GELU, from
// (B, n_mels, T) log-mel to (B, T/2, d).
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
// d=1280 the two convs are 2*B*T*(3*128)*d + 2*B*(T/2)*(3*d)*d = 283 GFLOP.
// The tensor cores take fp32 only as TF32 (a 10-bit mantissa: ~5e-4
// relative alone), so each product is three TF32 products, a_lo b_hi +
// a_hi b_lo + a_hi b_hi, with a_hi the TF32 of a (rounded to nearest) and
// a_lo its exact fp32 residual, whose low 13 bits the tensor core drops:
// 3 x 283 GFLOP at the 495 TFLOP/s of dense TF32 is 1.72 ms, against ~1.5
// GB of fp32 input, weights, split copies, y1 and output (~0.45 ms at 3.35
// TB/s). The first design ran every product as an fp32 FFMA (its bound 4.2
// ms at 67 TFLOP/s; 9.11 ms on an H100 80GB HBM3 at 700 W).
//
// Design: three launches. (1) `split_transpose_kernel` lays x out as (B,
// T, n_mels) rows, split into TF32 high parts and residuals (two arrays):
// TF32 wgmma takes K-major operands only, and TMA's tile mode cannot shift
// a box by one frame along x's own T-contiguous rows. (2) and (3) are two
// instantiations of one implicit-GEMM kernel, conv1 then conv2, each
// C[m][n] = sum over taps t and channels c of A[stride*i + t - 1][c] *
// W[n][t][c] for m = (b, i); input rows outside [0, T) read as zero (the
// conv's padding, TMA's out-of-bounds fill). Every operand is split before
// the main loop, so that loop is TMA and wgmma alone, as in a bf16 GEMM:
// the weights' high parts and residuals are made once per weight version
// in the (d, 3, C) tap-major cache (ops/conv_stem.py `tap_major_weights`),
// x's by (1), and y1's by conv1's epilogue, which writes y1 (B, T, d) as
// two arrays. conv2 reads y1 through the (B, T/2, 2, d) view, its stride-2
// taps as (pair, parity) coordinates (ops/conv_stem.py `tap_coords`, the
// bf16 form's plan). A persistent grid of one 384-thread CTA an SM walks
// 128 x 128 output tiles of one batch element, the column tiles of a row
// tile side by side (they share its A rows in L2). Warpgroup 0's first
// thread keeps TMA loads in flight in a 3-stage ring of K steps of 32
// channels of one tap (A's 128 rows and W's 128 rows, each as high parts
// and residuals: 64 KB a stage, 128-byte swizzled), running into the next
// tile while the consumers finish this one. Warpgroups 1 and 2 each own 64
// rows: per K step twelve m64n128k8 TF32 wgmmas (four k8 slices, three
// products each, the small terms first) into an accumulator of the step's
// own, added to the tile's fp32 sum by FADD. The tensor core drops bits at
// each add to its accumulator (truncation, not rounding): K1's fp32 form
// read 2.9e-5 from its twin when it carried a sum across ~1500 adds, and
// conv2's K is 3840 deep (1440 adds), so no sum stays there past 12 adds.
// The two consumers' wgmmas take turns at the tensor cores, so one's adds
// run under the other's products. The epilogue adds the bias, applies GELU
// (erff) and stores float4s (lane pairs trade a row's halves by shuffles);
// conv1's splits each value into y1's two arrays. Rows past T and channels
// past d are not stored. No atomics: the output is bit-repeatable.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "card.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kBM = 128;                    // output rows a tile (one batch element's)
constexpr int kBN = 128;                    // output channels a tile (ops/conv_stem.py F32_TILE_N)
constexpr int kBK = 32;                     // input channels a K step (128-byte rows)
constexpr int kStages = 3;                  // K-step ring depth
constexpr int kWGs = 2;                     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kWGs + 1);  // + the producer warpgroup
constexpr int kConsumers = 128 * kWGs;
constexpr int kPart = kBM * kBK;            // floats of one operand part of a stage
constexpr uint32_t kStageBytes = 4 * kPart * 4;  // A and W, high parts and residuals

struct __align__(1024) Smem {
  float a[kStages][2][kPart];  // [stage][hi, lo]: 128 rows x 32 channels
  float w[kStages][2][kPart];  // [stage][hi, lo]: 128 output channels x 32 input channels
  uint64_t full[kStages], empty[kStages];
};

// One conv's launch: tiles, channels and the per-tap TMA coordinates
// (ops/conv_stem.py `stem_plan` with F32_TILE_N columns).
struct ConvArgs {
  int n_mtiles;  // row tiles per batch element
  int n_ntiles;  // column tiles
  int n_work;    // batch * n_mtiles * n_ntiles
  int c_steps;   // K steps per tap: ceil(c_in / 32)
  int d;         // output channels
  int t_out;     // output rows per batch element
  int par[3];    // the tap's parity coordinate (conv2's (B, T/2, 2, d) view)
  int off[3];    // the tap's row (conv1) or row-pair (conv2) offset
};

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// Work item w -> batch element, first output row and first channel; the
// column tile runs fastest.
__device__ __forceinline__ void tile_of(int w, const ConvArgs& p, int& b, int& m0, int& n0) {
  const int nt = w % p.n_ntiles, rest = w / p.n_ntiles;
  b = rest / p.n_mtiles;
  m0 = (rest - b * p.n_mtiles) * kBM;
  n0 = nt * kBN;
}

// kStride 1: A is x's rows (B, T, C) through 3-D maps (C, T, B). kStride 2:
// A is y1 through 4-D maps (d, 2, T/2, B). One 128-row box a K step and
// part; W through 3-D maps (C, 3, d). out_lo non-null (conv1): the output
// is split into out (high parts) and out_lo (residuals).
template <int kStride>
__global__ void __launch_bounds__(kThreads, 1)
    conv_tf32_kernel(const __grid_constant__ CUtensorMap tm_a_hi,
                     const __grid_constant__ CUtensorMap tm_a_lo,
                     const __grid_constant__ CUtensorMap tm_w_hi,
                     const __grid_constant__ CUtensorMap tm_w_lo, const float* __restrict__ bias,
                     float* __restrict__ out, float* __restrict__ out_lo, const ConvArgs p) {
  extern __shared__ uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int k_steps = 3 * p.c_steps;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every load --------------------------------
    if (threadIdx.x == 0) {
      prefetch_tmap(&tm_a_hi);
      prefetch_tmap(&tm_a_lo);
      prefetch_tmap(&tm_w_hi);
      prefetch_tmap(&tm_w_lo);
      uint32_t it = 0;
      for (int w = blockIdx.x; w < p.n_work; w += gridDim.x) {
        int b, m0, n0;
        tile_of(w, p, b, m0, n0);
        for (int tap = 0; tap < 3; ++tap) {
          for (int cs = 0; cs < p.c_steps; ++cs, ++it) {
            const int st = it % kStages, c0 = cs * kBK;
            mbar_wait(&s.empty[st], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&s.full[st], kStageBytes);
            if constexpr (kStride == 1) {
              tma_load_3d(s.a[st][0], &tm_a_hi, &s.full[st], c0, m0 + p.off[tap], b);
              tma_load_3d(s.a[st][1], &tm_a_lo, &s.full[st], c0, m0 + p.off[tap], b);
            } else {
              tma_load_4d(s.a[st][0], &tm_a_hi, &s.full[st], c0, p.par[tap], m0 + p.off[tap], b);
              tma_load_4d(s.a[st][1], &tm_a_lo, &s.full[st], c0, p.par[tap], m0 + p.off[tap], b);
            }
            tma_load_3d(s.w[st][0], &tm_w_hi, &s.full[st], c0, tap, n0);
            tma_load_3d(s.w[st][1], &tm_w_lo, &s.full[st], c0, tap, n0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows of the tile each -----------------------------------
  const int c = wg - 1;
  const int tid = threadIdx.x - 128 * wg, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool odd = t4 & 1;
  uint32_t it = 0;
  for (int w = blockIdx.x; w < p.n_work; w += gridDim.x) {
    int b, m0, n0;
    tile_of(w, p, b, m0, n0);
    float sum[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sum[i] = 0.f;

    for (int k = 0; k < k_steps; ++k, ++it) {
      const int st = it % kStages;
      // this warpgroup's 64 A rows and the stage's 128 W rows, opaque to the
      // compiler so that it builds each descriptor where it issues it
      uint32_t aa = smem_u32(s.a[st][0]) + c * 64 * 128, wa = smem_u32(s.w[st][0]);
      asm volatile("" : "+r"(aa), "+r"(wa));
      mbar_wait(&s.full[st], (it / kStages) & 1);
      float acc[kBN / 2];
      wgmma_fence();
      // k8 slice ks is 32 bytes into the 128-byte rows; the residuals lie
      // one part (kPart floats) past the high parts
#pragma unroll
      for (int ks = 0; ks < kBK / 8; ++ks) {
        const uint64_t a_hi = sw128_desc(aa + ks * 32, 16, 1024);
        const uint64_t a_lo = sw128_desc(aa + kPart * 4 + ks * 32, 16, 1024);
        const uint64_t w_hi = sw128_desc(wa + ks * 32, 16, 1024);
        const uint64_t w_lo = sw128_desc(wa + kPart * 4 + ks * 32, 16, 1024);
        wgmma_m64n128k8_tf32_ss(acc, a_lo, w_hi, ks);  // the step's first overwrites
        wgmma_m64n128k8_tf32_ss(acc, a_hi, w_lo, 1);
        wgmma_m64n128k8_tf32_ss(acc, a_hi, w_hi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) fence_reg(acc[i]);
      mbar_arrive(&s.empty[st]);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sum[i] += acc[i];
    }

    // ---- epilogue: + bias, GELU, float4 stores ---------------------------------
    // accumulator i: row r0 (i % 4 < 2) or r0 + 8, column 8 (i / 4) + 2 t4 +
    // i % 2; lane pairs trade halves so that the even lane stores row r0's
    // four columns 8j + 4 (t4 / 2) .. and the odd lane row r0 + 8's
    const int r0 = 64 * c + 16 * warp + g;
    const int row = m0 + r0 + (odd ? 8 : 0);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int cp = n0 + 8 * j + 2 * t4;  // this thread's column pair
      const float2 bv = cp < p.d ? *reinterpret_cast<const float2*>(bias + cp)
                                 : make_float2(0.f, 0.f);
      const float y0 = gelu_erf(sum[4 * j] + bv.x), y1 = gelu_erf(sum[4 * j + 1] + bv.y);
      const float y2 = gelu_erf(sum[4 * j + 2] + bv.x), y3 = gelu_erf(sum[4 * j + 3] + bv.y);
      const float x0 = __shfl_xor_sync(0xffffffffu, odd ? y0 : y2, 1);
      const float x1 = __shfl_xor_sync(0xffffffffu, odd ? y1 : y3, 1);
      const float4 v = odd ? make_float4(x0, x1, y2, y3) : make_float4(y0, y1, x0, x1);
      const int col = n0 + 8 * j + 4 * (t4 >> 1);
      if (row >= p.t_out || col >= p.d) continue;  // d % 4 == 0: a float4 is in or out whole
      const long long at = ((long long)b * p.t_out + row) * p.d + col;
      if (out_lo == nullptr) {
        *reinterpret_cast<float4*>(out + at) = v;
      } else {
        float4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        *reinterpret_cast<float4*>(out + at) = hi;
        *reinterpret_cast<float4*>(out_lo + at) = lo;
      }
    }
  }
}

// x (B, C, T) -> xt_hi, xt_lo (B, T, C): x's rows transposed, each value
// split into its TF32 high part and residual; 32 x 32 tiles through shared
// memory, 256 threads (32 x 8).
__global__ void __launch_bounds__(256)
    split_transpose_kernel(const float* __restrict__ x, float* __restrict__ xt_hi,
                           float* __restrict__ xt_lo, int n_c, int n_t) {
  __shared__ float tile[32][33];  // [channel][frame], padded against bank conflicts
  const int b = blockIdx.z, t0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8)
    if (c0 + r < n_c && t0 + tx < n_t) tile[r][tx] = x[((long long)b * n_c + c0 + r) * n_t + t0 + tx];
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    if (t0 + r >= n_t || c0 + tx >= n_c) continue;
    float hi, lo;
    split_tf32(tile[tx][r], hi, lo);
    const long long at = ((long long)b * n_t + t0 + r) * n_c + c0 + tx;
    xt_hi[at] = hi;
    xt_lo[at] = lo;
  }
}

// fp32 map of `rank` dims (innermost first) with the byte strides of dims
// 1.., boxes of `box`, 128-byte swizzled, zero-filled out of bounds.
bool make_map(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

ConvArgs conv_args(const long long* plan, int conv) {
  // plan: batch, t, c_in, d, n_mtiles conv1, conv2, n_ntiles, then per
  // conv the three taps' parities and offsets
  const int d = static_cast<int>(plan[3]);
  ConvArgs a;
  a.n_mtiles = static_cast<int>(plan[4 + conv]);
  a.n_ntiles = static_cast<int>(plan[6]);
  a.n_work = static_cast<int>(plan[0]) * a.n_mtiles * a.n_ntiles;
  const int c_in = conv == 0 ? static_cast<int>(plan[2]) : d;
  a.c_steps = (c_in + kBK - 1) / kBK;
  a.d = d;
  a.t_out = static_cast<int>(plan[1]) / (conv + 1);
  for (int tap = 0; tap < 3; ++tap) {
    a.par[tap] = static_cast<int>(plan[7 + 6 * conv + tap]);
    a.off[tap] = static_cast<int>(plan[10 + 6 * conv + tap]);
  }
  return a;
}

}  // namespace

// x (B, C, t) fp32 log-mel; w1 (d, 3, C) and w2 (d, 3, d) fp32 tap-major,
// each as TF32 high parts (w*_hi) and residuals (w*_lo); b1, b2 (d,) fp32;
// xt (2, B, t, C) and y1 (2, B, t, d) fp32 scratch (high parts, then
// residuals); out (B, t/2, d) fp32. plan (ops/conv_stem.py `stem_plan` with
// F32_TILE_N columns): batch, t, C, d, the row tiles of each conv and the
// column tiles, then each conv's tap parities and offsets. C and d
// multiples of 4, t even; every pointer 16-byte aligned. Three launches:
// the split transpose, conv1, conv2. Returns the first failing launch's
// cudaError_t, or cudaErrorInvalidValue when a tensor map cannot be
// encoded.
extern "C" int kwt_conv_stem_f32(int card, const void* x, const void* w1_hi, const void* w1_lo,
                                 const void* b1, const void* w2_hi, const void* w2_lo,
                                 const void* b2, void* xt, void* y1, void* out,
                                 const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  const cuuint64_t batch = plan[0], t = plan[1], c_in = plan[2], d = plan[3];
  if (c_in % 4 != 0 || d % 4 != 0 || t % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  float* xt_hi = static_cast<float*>(xt);
  float* xt_lo = xt_hi + batch * t * c_in;
  float* y1_hi = static_cast<float*>(y1);
  float* y1_lo = y1_hi + batch * t * d;
  CUtensorMap tm_x_hi, tm_x_lo, tm_w1_hi, tm_w1_lo, tm_y1_hi, tm_y1_lo, tm_w2_hi, tm_w2_lo;
  const cuuint64_t x_dims[3] = {c_in, t, batch};
  const cuuint64_t x_strides[2] = {c_in * 4, t * c_in * 4};
  const cuuint32_t a_box3[3] = {kBK, kBM, 1};
  const cuuint64_t w1_dims[3] = {c_in, 3, d};
  const cuuint64_t w1_strides[2] = {c_in * 4, 3 * c_in * 4};
  const cuuint64_t w2_dims[3] = {d, 3, d};
  const cuuint64_t w2_strides[2] = {d * 4, 3 * d * 4};
  const cuuint32_t w_box[3] = {kBK, 1, kBN};
  // y1 (B, t, d) read as (d, parity, pair, B)
  const cuuint64_t y_pair_dims[4] = {d, 2, t / 2, batch};
  const cuuint64_t y_pair_strides[3] = {d * 4, 2 * d * 4, t * d * 4};
  const cuuint32_t a_box4[4] = {kBK, 1, kBM, 1};
  if (!make_map(&tm_x_hi, 3, xt_hi, x_dims, x_strides, a_box3) ||
      !make_map(&tm_x_lo, 3, xt_lo, x_dims, x_strides, a_box3) ||
      !make_map(&tm_w1_hi, 3, w1_hi, w1_dims, w1_strides, w_box) ||
      !make_map(&tm_w1_lo, 3, w1_lo, w1_dims, w1_strides, w_box) ||
      !make_map(&tm_y1_hi, 4, y1_hi, y_pair_dims, y_pair_strides, a_box4) ||
      !make_map(&tm_y1_lo, 4, y1_lo, y_pair_dims, y_pair_strides, a_box4) ||
      !make_map(&tm_w2_hi, 3, w2_hi, w2_dims, w2_strides, w_box) ||
      !make_map(&tm_w2_lo, 3, w2_lo, w2_dims, w2_strides, w_box))
    return static_cast<int>(cudaErrorInvalidValue);

  // per card: its SM count, set once the kernels' shared-memory limit is
  // raised there
  static int n_sms_of[kwt_card::kMaxCards] = {};
  int& n_sms = n_sms_of[card];
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;  // + alignment slack
  if (n_sms == 0) {
    cudaError_t e = cudaFuncSetAttribute(conv_tf32_kernel<1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv_tf32_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, card);
    if (e != cudaSuccess) {
      n_sms = 0;  // try again on the next call
      return static_cast<int>(e);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_c = static_cast<int>(c_in), n_t = static_cast<int>(t);
  split_transpose_kernel<<<dim3((n_t + 31) / 32, (n_c + 31) / 32, static_cast<unsigned>(batch)),
                           256, 0, s>>>(static_cast<const float*>(x), xt_hi, xt_lo, n_c, n_t);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const ConvArgs a1 = conv_args(plan, 0), a2 = conv_args(plan, 1);
  conv_tf32_kernel<1><<<a1.n_work < n_sms ? a1.n_work : n_sms, kThreads, smem, s>>>(
      tm_x_hi, tm_x_lo, tm_w1_hi, tm_w1_lo, static_cast<const float*>(b1), y1_hi, y1_lo, a1);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  conv_tf32_kernel<2><<<a2.n_work < n_sms ? a2.n_work : n_sms, kThreads, smem, s>>>(
      tm_y1_hi, tm_y1_lo, tm_w2_hi, tm_w2_lo, static_cast<const float*>(b2),
      static_cast<float*>(out), nullptr, a2);
  return static_cast<int>(cudaGetLastError());
}
