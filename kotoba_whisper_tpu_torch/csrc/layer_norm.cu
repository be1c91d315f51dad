// Fused LayerNorm (K6) for Hopper, bf16 rows in / bf16 out (or fp32 rows
// in / fp32 out), with an optional fused residual add.
//
// Replaces: kotoba_whisper_tpu/ops/layer_norm.py `_ln_kernel` (called
// through `layer_norm`) and `_add_ln_kernel` (through `add_layer_norm`):
// fp32 row LayerNorm in one read and one write of the rows; the fused form
// also emits the residual sum in the rows' dtype, and normalises that
// ROUNDED sum, so its outputs equal the unfused `x = x + y; layer_norm(x)`
// sequence. In fp32 (an fp32 model's rows) nothing is rounded but the
// arithmetic itself.
//
// What bounds it on the card: bytes. At the encoder's (B*1500, 1280) bf16
// rows (24000 rows at B=16) LayerNorm reads x and writes y (123 MB, about
// 37 us at 3.35 TB/s); the fused add reads x and y and writes the sum and
// y (246 MB, about 73 us); fp32 rows move twice the bytes (73 and 147 us).
// Its ~10 flops an element are far below the ridge, so the design is about
// keeping bytes in flight.
//
// Design: a persistent grid, as many 128-thread blocks as fit on the SMs
// (the occupancy of the instantiation, times the SM count), one warp per
// row, each warp striding over rows (row, row + 4 * grid, ...), so there is
// no tail wave. Each lane owns the same 16-byte chunks (8 bf16) of every
// row it touches: chunks lane, lane + 32, ... (rows up to 2048 wide, at
// most 8 chunks a lane; the chunk count is a template parameter, so the
// row lives in registers with no dead slots). The lane loads its slice of
// the weight and bias once, in the dtype they are stored in (bf16 or fp32),
// and widens it to fp32 at each use, as the TPU kernel casts them in its
// body; the wrapper makes no cast or copy per call. The next row's 16-byte
// loads are issued before the current row's reductions, so one row's
// memory latency hides under the previous row's arithmetic. Rows stay
// packed bf16 in registers and are widened per pass; fp32 rows (a template
// parameter) are held as they are, 8 floats a chunk.
// Statistics match the TPU kernel's `_ln_rows` step by step: the mean as
// sum / d, then the variance of the centred values (not E[x^2] - mean^2,
// not Welford), each sum a tree within a chunk and a chain over the lane's
// chunks, then a warp-shuffle sum, all in fp32; y = ((xc * rsqrt(var +
// eps)) * w) + b with the multiplies and the add rounded separately (no
// fused multiply-add), so it differs from the twin only where rsqrtf and
// the sum order do (well inside one bf16 ulp). 16-byte stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "card.cuh"

namespace {

constexpr int kMaxChunks = 8;  // 16-byte chunks per lane: rows <= 2048
constexpr int kWarps = 4;      // rows in flight per block, one per warp
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void widen8(const uint4& raw, float* x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 narrow8(const float* x) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  return raw;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of 8 values as a tree, each add rounded.
__device__ __forceinline__ float tree8(const float* v) {
  return __fadd_rn(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])),
                   __fadd_rn(__fadd_rn(v[4], v[5]), __fadd_rn(v[6], v[7])));
}

// One lane's chunk of a row, a weight or a bias, kept as stored: 8 bf16 or
// 8 fp32. `set` rounds 8 floats to the chunk's type.
template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void widen(float* x) const { widen8(raw, x); }
  __device__ __forceinline__ void set(const float* x) { raw = narrow8(x); }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = raw;
  }
};
template <>
struct Chunk<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = reinterpret_cast<const float4*>(p)[0];
    hi = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void widen(float* x) const {
    x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
    x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
  }
  __device__ __forceinline__ void set(const float* x) {
    lo = make_float4(x[0], x[1], x[2], x[3]);
    hi = make_float4(x[4], x[5], x[6], x[7]);
  }
  __device__ __forceinline__ void store(float* p) const {
    reinterpret_cast<float4*>(p)[0] = lo;
    reinterpret_cast<float4*>(p)[1] = hi;
  }
};

// Rows of width d = 8 * n_chunks, (kChunks - 1) * 32 < n_chunks <=
// kChunks * 32, stored as XT (bf16 or fp32). kAdd: y and sum_out are given.
template <int kChunks, typename XT, typename WT, bool kAdd>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const XT* __restrict__ x, const XT* __restrict__ y,
                      const WT* __restrict__ w, const WT* __restrict__ b,
                      XT* __restrict__ sum_out, XT* __restrict__ out, int rows, int d,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const int n_chunks = d >> 3;
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  // chunk i of this lane is the row's chunk lane + 32 i; only the last may
  // be past the row's end
  const bool last_ok = lane + 32 * (kChunks - 1) < n_chunks;
  auto ok = [&](int i) { return i < kChunks - 1 || last_ok; };

  Chunk<WT> wc[kChunks], bc[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i)
    if (ok(i)) {
      wc[i].load(w + (lane + 32 * i) * 8);
      bc[i].load(b + (lane + 32 * i) * 8);
    }

  Chunk<XT> cx[kChunks], cy[kChunks];
  auto load_row = [&](int r, Chunk<XT>* px, Chunk<XT>* py) {
    const long base = (long)r * d;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      if (ok(i)) {
        px[i].load(x + base + (lane + 32 * i) * 8);
        if constexpr (kAdd) py[i].load(y + base + (lane + 32 * i) * 8);
      }
  };
  load_row(row, cx, cy);

  for (; row < rows; row += stride) {
    // the next row's loads go out before this row's reductions
    Chunk<XT> nx[kChunks], ny[kChunks];
    const int next = row + stride;
    if (next < rows) load_row(next, nx, ny);
    const long base = (long)row * d;

    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      if (!ok(i)) continue;
      float v[8];
      cx[i].widen(v);
      if constexpr (kAdd) {  // the sum rounded to XT, as stored, is the row
        float yv[8];
        cy[i].widen(yv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fadd_rn(v[e], yv[e]);
        cx[i].set(v);
        cx[i].store(sum_out + base + (lane + 32 * i) * 8);
        cx[i].widen(v);
      }
      s = __fadd_rn(s, tree8(v));
    }
    const float mean = __fdiv_rn(warp_sum(s), (float)d);

    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      if (!ok(i)) continue;
      float v[8];
      cx[i].widen(v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float c = __fsub_rn(v[e], mean);
        v[e] = __fmul_rn(c, c);
      }
      ss = __fadd_rn(ss, tree8(v));
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)d), eps));

#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      if (!ok(i)) continue;
      float v[8], wv[8], bv[8];
      cx[i].widen(v);
      wc[i].widen(wv);
      bc[i].widen(bv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[e], mean), rstd), wv[e]), bv[e]);
      Chunk<XT> o;
      o.set(v);
      o.store(out + base + (lane + 32 * i) * 8);
    }

#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      cx[i] = nx[i];
      if constexpr (kAdd) cy[i] = ny[i];
    }
  }
}

// The persistent grid of one instantiation: the blocks that fit on every
// SM at once (at least one), never more than the rows need.
template <int kChunks, typename XT, typename WT, bool kAdd>
int launch_one(int card, const void* x, const void* y, const void* w, const void* b,
               void* sum_out, void* out, int rows, int d, float eps, cudaStream_t stream) {
  // blocks on the whole card, per instantiation and card
  static int resident_of[kwt_card::kMaxCards] = {};
  int& resident = resident_of[card];
  auto kernel = layer_norm_kernel<kChunks, XT, WT, kAdd>;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int needed = (rows + kWarps - 1) / kWarps;
  kernel<<<needed < resident ? needed : resident, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const XT*>(y), static_cast<const WT*>(w),
      static_cast<const WT*>(b), static_cast<XT*>(sum_out), static_cast<XT*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <int kChunks, typename XT, typename WT>
int launch_add(int card, bool add, const void* x, const void* y, const void* w, const void* b,
               void* sum_out, void* out, int rows, int d, float eps, cudaStream_t stream) {
  return add
      ? launch_one<kChunks, XT, WT, true>(card, x, y, w, b, sum_out, out, rows, d, eps, stream)
      : launch_one<kChunks, XT, WT, false>(card, x, y, w, b, sum_out, out, rows, d, eps, stream);
}

template <typename XT, typename WT>
int launch_width(int card, const void* x, const void* y, const void* w, const void* b,
                 void* sum_out, void* out, int rows, int d, float eps, cudaStream_t stream) {
  const bool add = y != nullptr;
  switch ((d / 8 + 31) / 32) {  // chunks per lane
    case 1: return launch_add<1, XT, WT>(card, add, x, y, w, b, sum_out, out, rows, d, eps, stream);
    case 2: return launch_add<2, XT, WT>(card, add, x, y, w, b, sum_out, out, rows, d, eps, stream);
    case 3: return launch_add<3, XT, WT>(card, add, x, y, w, b, sum_out, out, rows, d, eps, stream);
    case 4: return launch_add<4, XT, WT>(card, add, x, y, w, b, sum_out, out, rows, d, eps, stream);
    case 5: return launch_add<5, XT, WT>(card, add, x, y, w, b, sum_out, out, rows, d, eps, stream);
    case 6: return launch_add<6, XT, WT>(card, add, x, y, w, b, sum_out, out, rows, d, eps, stream);
    case 7: return launch_add<7, XT, WT>(card, add, x, y, w, b, sum_out, out, rows, d, eps, stream);
    case 8: return launch_add<8, XT, WT>(card, add, x, y, w, b, sum_out, out, rows, d, eps, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (rows, d) bf16 (x_fp32 == 0) or fp32 (x_fp32 != 0); y (rows, d) in x's
// dtype or null; w, b (d,) bf16 (w_fp32 == 0) or fp32 (w_fp32 != 0);
// sum_out (rows, d) (written only when y is given) and out (rows, d) in x's
// dtype. Every pointer 16-byte aligned, 0 < d <= 2048, d % 8 == 0. Returns
// the launch's cudaError_t.
extern "C" int kwt_layer_norm(int card, const void* x, const void* y, const void* w,
                              const void* b, int w_fp32, int x_fp32, void* sum_out, void* out,
                              int rows, int d, float eps, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > kMaxChunks * 8 * 32 || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_fp32)
    return w_fp32 ? launch_width<float, float>(card, x, y, w, b, sum_out, out, rows, d, eps, s)
                  : launch_width<float, __nv_bfloat16>(card, x, y, w, b, sum_out, out, rows, d,
                                                       eps, s);
  return w_fp32
             ? launch_width<__nv_bfloat16, float>(card, x, y, w, b, sum_out, out, rows, d, eps, s)
             : launch_width<__nv_bfloat16, __nv_bfloat16>(card, x, y, w, b, sum_out, out, rows,
                                                          d, eps, s);
}
