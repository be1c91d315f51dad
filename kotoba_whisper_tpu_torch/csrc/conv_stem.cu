// Whisper's audio stem (K7) for Hopper, bf16: conv1 (k3, s1, pad 1) +
// GELU, then conv2 (k3, s2, pad 1) + GELU, from (B, n_mels, T) log-mel to
// (B, T/2, d).
//
// Replaces: kotoba_whisper_tpu/ops/conv_stem.py `_stem_kernel` (called
// through `conv_stem_pallas`), with its numerics: each conv sums its
// products in fp32 and adds its (bf16-rounded) bias in fp32 before one
// rounding to bf16; GELU is the exact erf form in fp32 on that rounded
// value, rounded again; conv2's zero padding applies to the post-GELU conv1
// output. The erf is the TPU kernel's own rational one (|err| <= 1.5e-7),
// which the plain twin's torch.erf matches to far below bf16 resolution.
//
// What bounds it on the card: operations. At B=16, T=3000, 128 mels,
// d=1280 the two convs are 2*B*T*(3*128)*d + 2*B*(T/2)*(3*d)*d = 283 GFLOP
// on the tensor cores (about 0.29 ms at 989 TFLOP/s), against 84 MB of
// input, weights and output (about 0.025 ms at 3.35 TB/s).
//
// Design: two launches of one implicit-GEMM kernel template, one
// instantiation per conv stride, through a bf16 intermediate y1 (B, T, d),
// after a transpose of x (below).
// The TPU kernel's full fusion does not fit: 128 conv2 rows need 257 y1
// rows across all d channels (658 KB in bf16, 330 KB for 64 rows) against
// 227 KB of shared memory, and streaming y1 over K instead recomputes conv1
// once per conv2 column block. The TPU kernel rounds y1 to bf16 too, so the
// numbers are the same; y1's round trip (2 x 96 MB at B=16) runs beside the
// tensor work: conv2 reads its 96 MB over ~0.4 ms, 0.25 TB/s.
// Each launch is a GEMM C[m][n] = sum over taps t and channels c of
// A[stride*i + t - 1][c] * W[n][t][c] for m = (b, i), where input rows
// outside [0, T) read as zero (the conv's padding). A tap is a shift of
// the TMA coordinate, and TMA's out-of-bounds zero fill gives the padding:
// conv1 reads x as (B, T, n_mels) rows at frame i + tap - 1 (a transpose
// kernel lays them out first, 12 MB each way at B=16: TMA's tile mode
// takes no start coordinate that is not 16-byte aligned in the innermost
// dimension, so the one-frame shifts cannot run along x's own
// T-contiguous rows); conv2 reads y1
// through a 4-D map of the (B, T/2, 2, d) view, so its stride-2 taps are
// tap 0 = (pair i - 1, parity 1), tap 1 = (i, 0), tap 2 = (i, 1)
// (ops/conv_stem.py `tap_coords` plans them). Both A operands and the
// (d, 3, C) tap-major weights are read K-major.
// A persistent grid of one 384-thread CTA per SM walks 128 x 256 output
// tiles, n fastest, so the 5 column tiles of one row tile run side by
// side and share its A rows in L2 (a tile never crosses a batch element;
// ops/conv_stem.py `stem_tile` mirrors the order). Warpgroup 0 is the
// producer: it gives up its registers and one thread keeps TMA loads in
// flight in a 3-stage ring of 64-wide K steps (A 128 x 64, B 256 x 64,
// 48 KB a stage, mbarriers for full and empty), running ahead into the
// next tile while the consumers finish this one. Warpgroups 1 and 2 each
// own 64 rows of the tile and run wgmma m64n256k16 (bf16 in, fp32
// accumulators, 128-byte-swizzled shared memory), one K step in flight
// while the next is issued. The epilogue is most of the time that is not
// tensor work (61 M GELUs at B=16 for conv1, whose K is 384; the tensor
// cores wait while both consumers run it): it adds the
// bias (staged in shared memory per tile) in fp32, rounds, applies GELU in
// fp32 with the TPU kernel's branch-free rational erf and rounds again,
// writes each consumer's 64 x 256 tile into swizzled shared-memory boxes
// without bank conflicts, and leaves them to TMA stores, which skip rows
// past T and channels past d and drain while the next tile's products
// run.
#include "card.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kBM = 128;                    // output rows per tile
constexpr int kBN = 256;                    // output channels per tile
constexpr int kBK = 64;                     // input channels per K step (128 bytes)
constexpr int kStages = 3;                  // K-step ring depth
constexpr int kWGs = 2;                     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kWGs + 1);  // + the producer warpgroup
constexpr int kConsumers = 128 * kWGs;
constexpr int kBoxes = kBN / 64;            // 64-channel boxes of a row block's output
constexpr uint32_t kABytes = kBM * kBK * 2;
constexpr uint32_t kBBytes = kBN * kBK * 2;

struct __align__(1024) Smem {
  __nv_bfloat16 a[kStages][kBM * kBK];
  __nv_bfloat16 b[kStages][kBN * kBK];
  __nv_bfloat16 out[kWGs][kBoxes][64 * 64];  // a consumer's 64 x 256 tile, as TMA boxes
  uint32_t bias[kWGs][kBN / 2];              // the tile's bias, bf16 pairs
  uint64_t full[kStages], empty[kStages];
};

// One conv's launch: tiles, channels and the per-tap TMA coordinates
// (ops/conv_stem.py `stem_plan`).
struct ConvArgs {
  int n_mtiles;  // row tiles per batch element
  int n_ntiles;  // column tiles
  int n_work;    // batch * n_mtiles * n_ntiles
  int c_steps;   // K steps per tap: ceil(c_in / 64)
  int d;         // output channels
  int par[3];    // the tap's parity coordinate (conv2's (B, T/2, 2, d) view)
  int off[3];    // the tap's row (conv1) or row-pair (conv2) offset
};

// GELU in its erf form, 0.5 v (1 + erf(v / sqrt 2)), with the TPU kernel's
// own erf (`_erf`: Abramowitz-Stegun 7.1.26, |err| <= 1.5e-7), branch-free
// on the special function units' reciprocal and exponential.
__device__ __forceinline__ float gelu_erf(float v) {
  const float z = v * 0.70710677f, za = fabsf(z);
  const float t = __fdividef(1.f, fmaf(0.3275911f, za, 1.f));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf_a = 1.f - poly * __expf(-za * za);
  return 0.5f * v * (1.f + copysignf(erf_a, z));
}

// Work item w -> batch element, first output row and first channel; the
// column tile runs fastest.
__device__ __forceinline__ void tile_of(int w, const ConvArgs& p, int& b, int& m0, int& n0) {
  const int nt = w % p.n_ntiles, rest = w / p.n_ntiles;
  b = rest / p.n_mtiles;
  m0 = (rest - b * p.n_mtiles) * kBM;
  n0 = nt * kBN;
}

// kStride 1: A is x (B, T, C) through a 3-D map (C, T, B). kStride 2: A is
// y1 through a 4-D map (d, 2, T/2, B). One 128-row box a K step, K-major.
// W through a 3-D map (C, 3, d); the output through a 3-D map (d, T_out,
// B) in 64 x 64 boxes.
template <int kStride>
__global__ void __launch_bounds__(kThreads, 1)
    conv_gemm_sm90(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_out,
                   const __nv_bfloat16* __restrict__ bias, const ConvArgs p) {
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
    // ---- producer: one thread issues every load ------------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      prefetch_tmap(&tm_a);
      prefetch_tmap(&tm_w);
      uint32_t it = 0;
      for (int w = blockIdx.x; w < p.n_work; w += gridDim.x) {
        int b, m0, n0;
        tile_of(w, p, b, m0, n0);
        for (int tap = 0; tap < 3; ++tap) {
          for (int cs = 0; cs < p.c_steps; ++cs, ++it) {
            const int st = it % kStages, c0 = cs * kBK;
            mbar_wait(&s.empty[st], ((it / kStages) & 1) ^ 1);
            mbar_expect_tx(&s.full[st], kABytes + kBBytes);
            if constexpr (kStride == 1) {
              tma_load_3d(s.a[st], &tm_a, &s.full[st], c0, m0 + p.off[tap], b);
            } else {
              tma_load_4d(s.a[st], &tm_a, &s.full[st], c0, p.par[tap], m0 + p.off[tap], b);
            }
            tma_load_3d(s.b[st], &tm_w, &s.full[st], c0, tap, n0);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 rows of the tile each ---------------------------------
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid >> 5, lane = tid & 31;
    uint32_t it = 0;
    float acc[kBN / 2];
    for (int w = blockIdx.x; w < p.n_work; w += gridDim.x) {
      int b, m0, n0;
      tile_of(w, p, b, m0, n0);
      // K step `step`: this warpgroup's 64 A rows and the stage's 256 W
      // rows, each k16 32 bytes further into the 128-byte swizzled rows.
      auto issue = [&](uint32_t step, int first) {
        const int st = step % kStages;
        const uint32_t a_addr = smem_u32(s.a[st]) + c * 64 * 128;
        const uint32_t b_addr = smem_u32(s.b[st]);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n256k16_ss(acc, sw128_desc(a_addr + kk * 32, 16, 1024),
                              sw128_desc(b_addr + kk * 32, 16, 1024), first ? kk : 1);
      };
      // The loop is peeled (the first step overwrites the accumulators) so
      // that no wgmma is issued under a branch.
      mbar_wait(&s.full[it % kStages], (it / kStages) & 1);
      wgmma_fence();
      issue(it, 1);
      wgmma_commit();
      for (int k = 1; k < k_steps; ++k) {
        const uint32_t cur = it + k;
        mbar_wait(&s.full[cur % kStages], (cur / kStages) & 1);
        wgmma_fence();
        issue(cur, 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done: free its stage
        mbar_arrive(&s.empty[(cur - 1) % kStages]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) fence_reg(acc[i]);
      mbar_arrive(&s.empty[(it + k_steps - 1) % kStages]);
      it += k_steps;

      // ---- epilogue: + bias in fp32, round, GELU in fp32, round -------------
      // into this warpgroup's staging boxes (128-byte swizzled, as the
      // store's tensor map reads them), then TMA stores, which skip rows
      // past T and channels past d and drain while the next tile runs.
      if (tid == 0) bulk_wait_read<0>();  // the last tile's stores have read the boxes
      const int bcol = n0 + 2 * tid;
      s.bias[c][tid] = bcol < p.d ? *reinterpret_cast<const uint32_t*>(bias + bcol) : 0u;
      named_bar_sync(1 + c, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + (lane >> 2) + 8 * r;  // of this warpgroup's 64
        uint8_t* box_row = reinterpret_cast<uint8_t*>(s.out[c][0]) + row * 128 + (lane & 3) * 4;
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i) {
          const uint32_t bw = s.bias[c][i * 4 + (lane & 3)];
          const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw));
          // both sums rounded to bf16 in one conversion
          const float2 pre = __bfloat1622float2(__floats2bfloat162_rn(
              acc[4 * i + 2 * r] + bv.x, acc[4 * i + 2 * r + 1] + bv.y));
          // box i / 8, 16-byte chunk i % 8 of the row, swizzled by the row
          *reinterpret_cast<uint32_t*>(box_row + (i / 8) * 64 * 128 +
                                       (((i % 8) ^ (row & 7)) << 4)) =
              pack_bf16x2(gelu_erf(pre.x), gelu_erf(pre.y));
        }
      }
      fence_proxy_async_smem();
      named_bar_sync(1 + c, 128);
      if (tid == 0) {
#pragma unroll
        for (int j = 0; j < kBoxes; ++j)
          tma_store_3d(&tm_out, s.out[c][j], n0 + 64 * j, m0 + 64 * c, b);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait_all();
  }
}

// x (B, C, T) -> xt (B, T, C), bf16, through 64 x 64 tiles in shared
// memory, pairs of values a thread (C and T even).
__global__ void __launch_bounds__(256)
    transpose_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ xt,
                     int n_c, int n_t) {
  __shared__ __nv_bfloat16 tile[64][66];  // [channel][frame], padded against bank conflicts
  const int b = blockIdx.z, t0 = blockIdx.x * 64, c0 = blockIdx.y * 64;
  for (int k = threadIdx.x; k < 64 * 32; k += 256) {
    const int ci = k >> 5, tp = 2 * (k & 31);
    if (c0 + ci < n_c && t0 + tp < n_t) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
          x + ((long)b * n_c + c0 + ci) * n_t + t0 + tp);
      tile[ci][tp] = v.x;
      tile[ci][tp + 1] = v.y;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < 64 * 32; k += 256) {
    const int ti = k >> 5, cp = 2 * (k & 31);
    if (t0 + ti < n_t && c0 + cp < n_c) {
      __nv_bfloat162 v;
      v.x = tile[cp][ti];
      v.y = tile[cp + 1][ti];
      *reinterpret_cast<__nv_bfloat162*>(xt + ((long)b * n_t + t0 + ti) * n_c + c0 + cp) = v;
    }
  }
}

// bf16 map of `rank` dims (innermost first) with the byte strides of dims
// 1.., boxes of `box`, 128-byte swizzled, zero-filled out of bounds.
bool make_map(CUtensorMap* map, int rank, const void* base, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
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
  for (int tap = 0; tap < 3; ++tap) {
    a.par[tap] = static_cast<int>(plan[7 + 6 * conv + tap]);
    a.off[tap] = static_cast<int>(plan[10 + 6 * conv + tap]);
  }
  return a;
}

}  // namespace

// x (B, C, t) bf16 log-mel; w1 (d, 3, C), w2 (d, 3, d) bf16 tap-major; b1,
// b2 (d,) bf16; xt (B, t, C) and y1 (B, t, d) bf16 scratch; out (B, t/2,
// d) bf16. plan (ops/conv_stem.py `stem_plan`): batch, t, C, d, the row
// tiles of each conv and the column tiles, then each conv's tap parities
// and offsets. C and d multiples of 8, t even; every pointer 16-byte
// aligned. Three launches: the transpose, conv1, conv2. Returns the first
// failing launch's cudaError_t, or cudaErrorInvalidValue when a tensor map
// cannot be encoded.
extern "C" int kwt_conv_stem(int card, const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* xt, void* y1, void* out,
                             const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  const cuuint64_t batch = plan[0], t = plan[1], c_in = plan[2], d = plan[3];
  if (c_in % 8 != 0 || d % 8 != 0 || t % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_x, tm_w1, tm_y1_out, tm_y1_in, tm_w2, tm_out;
  const cuuint64_t x_dims[3] = {c_in, t, batch};
  const cuuint64_t x_strides[2] = {c_in * 2, t * c_in * 2};
  const cuuint32_t a_box3[3] = {kBK, kBM, 1};
  const cuuint64_t w1_dims[3] = {c_in, 3, d};
  const cuuint64_t w1_strides[2] = {c_in * 2, 3 * c_in * 2};
  const cuuint64_t w2_dims[3] = {d, 3, d};
  const cuuint64_t w2_strides[2] = {d * 2, 3 * d * 2};
  const cuuint32_t w_box[3] = {kBK, 1, kBN};
  // y1 (B, t, d) written as (d, t, B), read as (d, parity, pair, B)
  const cuuint64_t y_dims[3] = {d, t, batch};
  const cuuint64_t y_strides[2] = {d * 2, t * d * 2};
  const cuuint64_t y_pair_dims[4] = {d, 2, t / 2, batch};
  const cuuint64_t y_pair_strides[3] = {d * 2, 2 * d * 2, t * d * 2};
  const cuuint32_t a_box4[4] = {kBK, 1, kBM, 1};
  const cuuint64_t o_dims[3] = {d, t / 2, batch};
  const cuuint64_t o_strides[2] = {d * 2, t / 2 * d * 2};
  const cuuint32_t o_box[3] = {64, 64, 1};
  if (!make_map(&tm_x, 3, xt, x_dims, x_strides, a_box3) ||
      !make_map(&tm_w1, 3, w1, w1_dims, w1_strides, w_box) ||
      !make_map(&tm_y1_out, 3, y1, y_dims, y_strides, o_box) ||
      !make_map(&tm_y1_in, 4, y1, y_pair_dims, y_pair_strides, a_box4) ||
      !make_map(&tm_w2, 3, w2, w2_dims, w2_strides, w_box) ||
      !make_map(&tm_out, 3, out, o_dims, o_strides, o_box))
    return static_cast<int>(cudaErrorInvalidValue);

  // per card: its SM count, set once the kernels' shared-memory limit is
  // raised there
  static int n_sms_of[kwt_card::kMaxCards] = {};
  int& n_sms = n_sms_of[card];
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;  // + alignment slack
  if (n_sms == 0) {
    cudaError_t e =
        cudaFuncSetAttribute(conv_gemm_sm90<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv_gemm_sm90<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, card);
    if (e != cudaSuccess) {
      n_sms = 0;  // try again on the next call
      return static_cast<int>(e);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_c = static_cast<int>(c_in), n_t = static_cast<int>(t);
  transpose_kernel<<<dim3((n_t + 63) / 64, (n_c + 63) / 64, static_cast<unsigned>(batch)), 256,
                     0, s>>>(static_cast<const __nv_bfloat16*>(x),
                             static_cast<__nv_bfloat16*>(xt), n_c, n_t);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const ConvArgs a1 = conv_args(plan, 0), a2 = conv_args(plan, 1);
  conv_gemm_sm90<1><<<a1.n_work < n_sms ? a1.n_work : n_sms, kThreads, smem, s>>>(
      tm_x, tm_w1, tm_y1_out, static_cast<const __nv_bfloat16*>(b1), a1);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  conv_gemm_sm90<2><<<a2.n_work < n_sms ? a2.n_work : n_sms, kThreads, smem, s>>>(
      tm_y1_in, tm_w2, tm_out, static_cast<const __nv_bfloat16*>(b2), a2);
  return static_cast<int>(cudaGetLastError());
}
