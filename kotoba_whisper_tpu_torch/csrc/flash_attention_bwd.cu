// Flash-attention backward for Hopper (K5), bf16 in / bf16 out, causal
// (decoder self-attention) and non-causal (cross-attention, encoder).
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py `_bwd_dq_kernel` and
// `_bwd_dkv_kernel` (called through `_flash_bwd`): dQ, dK and dV of
// softmax(q k^T / 8) v from the forward's fp32 LSE and
// D = rowsum(dO * O), which the wrapper computes outside the kernels as
// the JAX package does.
//
// What bounds it on the card: at the training cross shape (B=8, 20 heads,
// Tq=128, Tk=1500, D=64) the function must read q, k, v, o, dO, LSE and
// write dq, dk, dv: ~133 MB, dominated by K, V and their gradients (~40 us
// at 3.35 TB/s), against 5 products of 2*B*H*Tq*Tk*D flops (~19.7 GFLOP,
// ~20 us at 989 TFLOP/s): bound by bytes. The two-kernel split
// recomputes S and P in both kernels (7 products in all) and reads K and V
// in both; that is the design's cost, not the function's.
//
// Design: the TPU split is kept, because a Hopper block cannot carry a sum
// across the grid. The dQ kernel runs one block of 4 warps per (64-row Q
// tile, batch*head) and loops over 64-key tiles; the dK/dV kernel runs one
// block per (64-key tile, batch*head) and loops over 64-row Q tiles. Each
// warp owns 16 rows of its block's tile (queries in dQ, keys in dK/dV), so
// every sum stays in one warp's registers and no fp32 atomics are needed.
// Both kernels recompute S on the tensor cores and P = exp(S - LSE) from
// the saved LSE (exp2 with log2(e) folded in), through mma.sync m16n8k16
// with bf16 operands and fp32 sums; P and dS = P (dP - D) are rounded to
// bf16 before their products, as the TPU kernels round them. The dK/dV
// kernel computes S^T = K Q^T directly, so P^T and dS^T come out of the
// accumulators already in A-fragment order for P^T dO and dS^T Q. The
// streamed operand is double-buffered with cp.async; the block's own tile
// (Q and dO, or K and V) is staged once through the second buffer into
// register fragments. The 1/8 scale is applied to the fp32 scores, and dQ
// and dK are multiplied by it at the end: with the exact power-of-two
// scale this equals the TPU kernels' folding it into q in bf16. Causal
// blocks skip key tiles above their last row (dQ) or query tiles below
// their first key (dK/dV) and mask only the tiles that cross the diagonal.
// Query rows past Tq get LSE = +inf (P = 0) in the dK/dV kernel; keys past
// Tk are masked in the dQ kernel. Tensors keep the model's (B, T, H, 64)
// layout; LSE and D are (B, H, Tq) fp32.
// Later work: wgmma + TMA, a fused single pass with dQ atomics, and
// fewer registers for more blocks per SM.
#include "flash_common.cuh"

namespace {

using namespace kwt_flash;

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int tq, int tk,
                        int n_heads, float scale) {
  __shared__ __align__(128) __nv_bfloat16 sk[2][kBK * kD];
  __shared__ __align__(128) __nv_bfloat16 sv[2][kBK * kD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const long row_stride = (long)n_heads * kD;
  const __nv_bfloat16* qb = q + (long)b * tq * row_stride + h * kD;
  const __nv_bfloat16* dob = dout + (long)b * tq * row_stride + h * kD;
  const __nv_bfloat16* kb = k + (long)b * tk * row_stride + h * kD;
  const __nv_bfloat16* vb = v + (long)b * tk * row_stride + h * kD;
  const int row[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  const int offset = tk - tq;
  const float scale_log2 = scale * kLog2e;

  int n_tiles = (tk + kBK - 1) / kBK;
  int n_free = tk / kBK;  // leading tiles that need no mask
  if (kCausal) {
    const int last_row = min(q0 + kBQ - 1, tq - 1);
    n_tiles = min(n_tiles, (last_row + offset) / kBK + 1);
    n_free = min(n_free, (q0 + offset + 1) / kBK);
  }

  // Q and dO pass through the second buffers into register fragments.
  load_tile(sk[1], qb, q0, tq, row_stride, tid);
  load_tile(sv[1], dob, q0, tq, row_stride, tid);
  cp_async_commit();
  load_tile(sk[0], kb, 0, tk, row_stride, tid);
  load_tile(sv[0], vb, 0, tk, row_stride, tid);
  cp_async_commit();

  float lse2[2], dlt[2];  // this thread's rows: LSE in log2 units, D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < tq;
    lse2[r] = ok ? lse[(long)bh * tq + row[r]] * kLog2e : 0.f;
    dlt[r] = ok ? delta[(long)bh * tq + row[r]] : 0.f;
  }

  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
  load_a_frags(qf, sk[1], warp, lane);
  load_a_frags(dof, sv[1], warp, lane);
  __syncthreads();  // the first prefetch overwrites the second buffers

  float acc[8][4];
  zero_acc(acc);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile(sk[(j + 1) & 1], kb, (j + 1) * kBK, tk, row_stride, tid);
      load_tile(sv[(j + 1) & 1], vb, (j + 1) * kBK, tk, row_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* skt = sk[j & 1];
    const __nv_bfloat16* svt = sv[j & 1];

    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    mma_a_tile_t(s, qf, skt, lane);    // S = Q K^T
    mma_a_tile_t(dp, dof, svt, lane);  // dP = dO V^T

    const int key0 = j * kBK + (lane & 3) * 2;
    const bool masked = j >= n_free;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int col = key0 + nt * 8 + (e & 1);
          bool keep = col < tk;
          if (kCausal) keep = keep && col <= row[r] + offset;
          if (!keep) x = -INFINITY;
        }
        const float p = exp2f(x - lse2[r]);
        dp[nt][e] = p * (dp[nt][e] - dlt[r]);  // dS
      }
    }
    mma_acc_tile(acc, dp, skt, lane);  // dQ += dS K
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }
  store_rows(dq + (long)b * tq * row_stride + h * kD, acc, row[0], tq,
             row_stride, scale, lane);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int tq, int tk,
                         int n_heads, float scale) {
  __shared__ __align__(128) __nv_bfloat16 sq[2][kBQ * kD];
  __shared__ __align__(128) __nv_bfloat16 sdo[2][kBQ * kD];
  __shared__ float s_lse[2][kBQ];  // log2 units; +inf past tq
  __shared__ float s_dlt[2][kBQ];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * kBK;
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const long row_stride = (long)n_heads * kD;
  const __nv_bfloat16* qb = q + (long)b * tq * row_stride + h * kD;
  const __nv_bfloat16* dob = dout + (long)b * tq * row_stride + h * kD;
  const __nv_bfloat16* kb = k + (long)b * tk * row_stride + h * kD;
  const __nv_bfloat16* vb = v + (long)b * tk * row_stride + h * kD;
  // this thread's two keys
  const int key[2] = {k0 + warp * 16 + (lane >> 2), k0 + warp * 16 + (lane >> 2) + 8};
  const int offset = tk - tq;
  const float scale_log2 = scale * kLog2e;

  const int n_qt = (tq + kBQ - 1) / kBQ;
  // causal: query rows before this key tile's first key (shifted by the
  // end-alignment offset) see none of its keys
  const int i0 = kCausal ? max(k0 - offset, 0) / kBQ : 0;

  auto stage_stats = [&](int i, int buf) {
    const int g = i * kBQ + (tid & (kBQ - 1));
    const bool ok = g < tq;
    if (tid < kBQ) {
      s_lse[buf][tid] = ok ? lse[(long)bh * tq + g] * kLog2e : INFINITY;
    } else {
      s_dlt[buf][tid - kBQ] = ok ? delta[(long)bh * tq + g] : 0.f;
    }
  };

  // K and V pass through the second buffers into register fragments.
  load_tile(sq[1], kb, k0, tk, row_stride, tid);
  load_tile(sdo[1], vb, k0, tk, row_stride, tid);
  cp_async_commit();
  if (i0 < n_qt) {
    load_tile(sq[0], qb, i0 * kBQ, tq, row_stride, tid);
    load_tile(sdo[0], dob, i0 * kBQ, tq, row_stride, tid);
    stage_stats(i0, 0);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, sq[1], warp, lane);
  load_a_frags(vf, sdo[1], warp, lane);
  __syncthreads();  // the first prefetch overwrites the second buffers

  float dk_acc[8][4], dv_acc[8][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);
  for (int i = i0; i < n_qt; ++i) {
    const int buf = (i - i0) & 1;
    if (i + 1 < n_qt) {
      load_tile(sq[buf ^ 1], qb, (i + 1) * kBQ, tq, row_stride, tid);
      load_tile(sdo[buf ^ 1], dob, (i + 1) * kBQ, tq, row_stride, tid);
      stage_stats(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* sqt = sq[buf];
    const __nv_bfloat16* sdot = sdo[buf];

    float s[8][4], dp[8][4];  // S^T, dP^T: this warp's 16 keys x 64 rows
    zero_acc(s);
    zero_acc(dp);
    mma_a_tile_t(s, kf, sqt, lane);    // S^T = K Q^T
    mma_a_tile_t(dp, vf, sdot, lane);  // dP^T = V dO^T

    const int col0 = (lane & 3) * 2;
    // causal: does any (row, key) pair of this tile lie above the diagonal?
    const bool masked = kCausal && i * kBQ + offset < k0 + kBK - 1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = col0 + nt * 8 + (e & 1);
        float x = s[nt][e] * scale_log2;
        if (masked && key[e >> 1] > i * kBQ + c + offset) x = -INFINITY;
        const float p = exp2f(x - s_lse[buf][c]);
        s[nt][e] = p;                                   // P^T
        dp[nt][e] = p * (dp[nt][e] - s_dlt[buf][c]);    // dS^T
      }
    }
    mma_acc_tile(dv_acc, s, sdot, lane);  // dV += P^T dO
    mma_acc_tile(dk_acc, dp, sqt, lane);  // dK += dS^T Q
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }
  store_rows(dk + (long)b * tk * row_stride + h * kD, dk_acc, key[0], tk,
             row_stride, scale, lane);
  store_rows(dv + (long)b * tk * row_stride + h * kD, dv_acc, key[0], tk,
             row_stride, 1.f, lane);
}

}  // namespace

// q/dout (B, Tq, H, 64), k/v (B, Tk, H, 64) bf16 contiguous; lse, delta
// (B, H, Tq) fp32 -> dq (B, Tq, H, 64), dk/dv (B, Tk, H, 64) bf16. causal
// != 0 applies the end-aligned mask. Launches the dQ kernel, then the
// dK/dV kernel, on `stream`. Returns the first launch error (cudaError_t).
extern "C" int kwt_flash_attention_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, void* dk, void* dv,
                                       int batch, int tq, int tk, int n_heads,
                                       int causal, void* stream) {
  const float scale = 0.125f;  // 1/sqrt(64), exact
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* dop = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dlp = static_cast<const float*>(delta);

  auto dq_kernel = causal ? flash_bwd_dq_kernel<true> : flash_bwd_dq_kernel<false>;
  dq_kernel<<<dim3((tq + kBQ - 1) / kBQ, batch * n_heads), kThreads, 0, st>>>(
      qp, kp, vp, dop, lp, dlp, static_cast<__nv_bfloat16*>(dq), tq, tk,
      n_heads, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dkv_kernel = causal ? flash_bwd_dkv_kernel<true> : flash_bwd_dkv_kernel<false>;
  dkv_kernel<<<dim3((tk + kBK - 1) / kBK, batch * n_heads), kThreads, 0, st>>>(
      qp, kp, vp, dop, lp, dlp, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), tq, tk, n_heads, scale);
  return static_cast<int>(cudaGetLastError());
}
