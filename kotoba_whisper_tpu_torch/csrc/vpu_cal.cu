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
// over (rows, cols) fp32 scores, `iters` times, -> acc (rows, 1). Here
// each row gives acc and lsum, the sum over the iterations of its row sum
// l (softmax: of exp(s - max s); exp: of exp(s), so acc itself): the
// softmax form's acc is `iters` whatever its exponentials read, so lsum is
// what shows an exponential skipped or taken against the wrong max.
//
// What bounds it on the card: operations, and among them the exponentials
// on the special function units (16 ex2 a clock per SM on the data sheet,
// 4.18e12/s over 132 SMs at 1.98 GHz): 512 x 1536 x 64 = 5.0e7 of them,
// 0.012 ms. The 3 MB block is read once (about 1 us at 3.35 TB/s).
//
// Design: the TPU kernel holds the whole (512, 1536) block in VMEM on one
// core; 3 MB does not fit one SM, so the rows are spread over the card,
// kRows to a CTA, each row over the warps of its op (kSoftmaxWarps,
// kExpWarps; warp w of a CTA holds part w % warps of row w / warps, and
// runs on scheduler w % 4), its scores in registers for the whole loop
// (no memory traffic inside it). Each iteration waits on its row's
// reduction: with ~4 rows an SM, that chain, not the special function
// units, sets the pace, so the design shortens it. The exponential is
// ex2.approx.ftz.f32 after one FFMA, as the attention kernels take it; a
// lane sums (and takes the max of) its registers in kSums independent
// running sums, so that no exponential waits on the one before; the lanes'
// sums go by xor shuffles. The softmax form shifts each lane's scores by
// the lane's own max, so that its exponentials wait on no reduction (the
// warp's max is taken by shuffles meanwhile), rebases the lane's sum to
// the warp's max, and, over several warps, combines the warps' (max, sum)
// pairs in one pass: one named barrier of the row's warps an iteration,
// the pairs in shared memory (a slot per iteration parity, so no second
// barrier), warp i's pair in lanes i, i + warps, .., rebased and summed by
// xor shuffles, so every lane of the row holds the same acc. A row of the
// softmax form takes one warp (shuffles only), of the exp form four (a
// quarter of the row's exponentials a scheduler, the barrier cheaper than
// the longer exp chain): the fastest of `tools.vpu_cal --sweep`'s shapes on
// an H100 80GB HBM3 at 700 W, where the first design (one 256-thread CTA
// a row, two block reductions an iteration in the softmax form, each two
// __syncthreads) read 0.0455 ms softmax / 0.0265 ms exp and this one
// 0.0270 / 0.0199 (PERF.md §6). Columns past `cols` hold -inf, which adds
// nothing to any sum (tests/test_torch_vpu_cal.py mirrors the order).
#include <cuda_runtime.h>
#include <math.h>

#include "card.cuh"

namespace {

// The kernel's shape (tools/vpu_cal.py reads these lines): warps a row in
// the softmax and the exp form, independent partial sums (and maxes) a lane
constexpr int kSoftmaxWarps = 1, kExpWarps = 4;
constexpr int kSums = 4;
constexpr int kRows = 4;  // rows a CTA (tools/vpu_cal.py ROWS_PER_CTA)
constexpr int kMaxCols = 2048;
constexpr float kLog2e = 1.4426950408889634f;
static_assert((kSums & (kSums - 1)) == 0, "the pairwise sums take a power of two");

template <bool kSoftmax>
struct Shape {
  static constexpr int kRowWarps = kSoftmax ? kSoftmaxWarps : kExpWarps;
  static constexpr int kRowThreads = 32 * kRowWarps, kThreads = kRowThreads * kRows;
  static constexpr int kMaxPer = (kMaxCols + kRowThreads - 1) / kRowThreads;
  static_assert((kRowWarps & (kRowWarps - 1)) == 0 && kThreads <= 1024,
                "the xor reductions take a power of two");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The sum of v over each aligned group of `kLanes` lanes, by xor shuffles
// from the widest: the same value in every lane of the group.
template <int kLanes>
__device__ __forceinline__ float xor_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
template <int kLanes>
__device__ __forceinline__ float xor_max(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The lane's sum (or max) of v: kSums independent running sums (v_j into
// sum j % kSums, so that no exponential waits on the one before), then
// added pairwise from the widest.
template <bool kMax, int kPer>
__device__ __forceinline__ float lane_reduce(const float (&v)[kPer]) {
  float r[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) r[i] = kMax ? -INFINITY : 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    float& a = r[j % kSums];
    a = kMax ? fmaxf(a, v[j]) : a + v[j];
  }
#pragma unroll
  for (int w = kSums / 2; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) r[i] = kMax ? fmaxf(r[i], r[i + w]) : r[i] + r[i + w];
  return r[0];
}

// l, a sum of 2^(s - m), as a sum of 2^(s - big), big >= m (log2 units; a
// sum against a max of -inf holds nothing).
__device__ __forceinline__ float rebased(float m, float l, float big) {
  return m == -INFINITY ? 0.f : l * ex2(m - big);
}

template <int kPer, bool kSoftmax>
__global__ void __launch_bounds__(Shape<kSoftmax>::kThreads)
    cal_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int cols,
               int iters) {
  constexpr int kRowWarps = Shape<kSoftmax>::kRowWarps;
  constexpr int kRowThreads = Shape<kSoftmax>::kRowThreads;
  __shared__ float2 pairs[2][kRows][kRowWarps];  // [iteration parity][row][warp]: (max, sum)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / kRowWarps, part = warp % kRowWarps;
  const int row = blockIdx.x * kRows + slot;
  if (row >= rows) return;  // the row's warps leave together
  float xv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = j * kRowThreads + part * 32 + lane;
    xv[j] = c < cols ? x[(long)row * cols + c] : -INFINITY;
  }
  float acc = 0.f, lsum = 0.f;
  for (int it = 0; it < iters; ++it) {
    float s[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = fmaf(acc, 1e-9f, xv[j]);
    float m = 0.f, l = 0.f;  // the warp's (max, sum), the max in log2 units
    if constexpr (kSoftmax) {
      const float mt = lane_reduce<true>(s);  // -inf where the lane holds padding only
      m = xor_max<32>(mt) * kLog2e;
      const float bt = mt * kLog2e, shift = mt == -INFINITY ? 0.f : bt;
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[j] = ex2(fmaf(s[j], kLog2e, -shift));
      l = xor_sum<32>(rebased(bt, lane_reduce<false>(s), m));
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[j] = ex2(s[j] * kLog2e);
      l = xor_sum<32>(lane_reduce<false>(s));
    }
    if constexpr (kRowWarps > 1) {
      // the row's warps' pairs, warp i's in lanes i, i + kRowWarps, ..
      pairs[it & 1][slot][part] = make_float2(m, l);  // every lane: the same value, no branch
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(kRowThreads) : "memory");
      const float2 w = pairs[it & 1][slot][lane % kRowWarps];
      l = kSoftmax ? rebased(w.x, w.y, xor_max<kRowWarps>(w.x)) : w.y;
      l = xor_sum<kRowWarps>(l);
    }
    acc += kSoftmax ? l / l : l;
    if constexpr (kSoftmax) lsum += l;  // the exp form's lsum is acc
  }
  if (part == 0 && lane == 0)
    *reinterpret_cast<float2*>(out + 2 * row) = make_float2(acc, kSoftmax ? lsum : acc);
}

template <bool kSoftmax, int kPer = 1>
int launch(int per, const float* x, float* out, int rows, int cols, int iters, cudaStream_t s) {
  if constexpr (kPer > Shape<kSoftmax>::kMaxPer) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (per != kPer) return launch<kSoftmax, kPer + 1>(per, x, out, rows, cols, iters, s);
    cal_kernel<kPer, kSoftmax><<<(rows + kRows - 1) / kRows, Shape<kSoftmax>::kThreads, 0, s>>>(
        x, out, rows, cols, iters);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

// x (rows, cols) fp32 with 1 <= cols <= 2048; out (rows, 2) fp32, each
// row's acc and lsum, 8-byte aligned. op_softmax
// != 0 runs the softmax body, else the bare exponential. Returns the
// launch's cudaError_t.
extern "C" int kwt_vpu_cal(int card, const void* x, void* out, int rows, int cols,
                           int iters, int op_softmax, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  if (rows < 1 || cols < 1 || cols > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (op_softmax != 0) {
    constexpr int w = Shape<true>::kRowThreads;
    return launch<true>((cols + w - 1) / w, xf, of, rows, cols, iters, cs);
  }
  constexpr int w = Shape<false>::kRowThreads;
  return launch<false>((cols + w - 1) / w, xf, of, rows, cols, iters, cs);
}
