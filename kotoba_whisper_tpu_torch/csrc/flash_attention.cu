// Causal flash-attention forward for Hopper (K4), bf16 in / bf16 out: the
// decoder's self-attention in training. (The non-causal forward, K1, is
// flash_attention_sm90.cu.)
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py `_fwd_kernel`, the
// TPU's online-softmax forward with the end-aligned causal mask. It emits O
// in the input dtype and the fp32 natural-log LSE.
//
// What bounds it on the card: at the decoder's training shape (B=8, T=128,
// 20 heads) one call needs ~0.34 GFLOP (the causal half of the scores) over
// ~10.6 MB (q, k, v, O, LSE): bound by its bytes at ~3 us, so launch cost
// dominates.
//
// Design: 64-key tiles with an online softmax (FlashAttention-2 order). One
// block of 4 warps owns 64 query rows of one (batch, head); each warp owns
// 16 rows and keeps its Q fragment, the running max/sum and the 16x64 fp32
// output accumulator in registers. QK^T and PV run on the tensor cores
// through mma.sync m16n8k16 (bf16 operands, fp32 sums); P is re-packed from
// the score accumulators into A fragments without touching shared memory.
// K/V tiles are double-buffered with cp.async, and tiles are XOR-swizzled
// so ldmatrix reads are free of bank conflicts. The 1/sqrt(64) scale and
// log2(e) fold into one fp32 multiply of the scores (exact scale, exp2 on
// the SFU). Query row r sees keys <= r + (tk - tq) (end-aligned, as the TPU
// kernel); the block loops only over key tiles at or below its last row,
// and only tiles that cross its first row's bound are masked (the diagonal
// tile when tq == tk); keys past T are masked to -inf, and rows past T are
// computed on zero-filled Q and never stored.
// Tensors keep the model's (B, T, H, D) layout: a head's row is 128
// contiguous bytes, so no transpose to (B*H, T, D) is needed. q, k and v
// take a token stride of their own, so the q/k/v column blocks of a fused
// (B, T, 3*H*D) qkv projection are read in place, without copies.
#include "flash_common.cuh"

namespace {

using namespace kwt_flash;

__global__ void __launch_bounds__(kThreads)
    flash_fwd_causal_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int tq, int tk, int n_heads, long q_stride,
                     long k_stride, long v_stride, float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 sq[kBQ * kD];
  __shared__ __align__(128) __nv_bfloat16 sk[2][kBK * kD];
  __shared__ __align__(128) __nv_bfloat16 sv[2][kBK * kD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const long row_stride = (long)n_heads * kD;  // of O
  const __nv_bfloat16* qb = q + (long)b * tq * q_stride + h * kD;
  const __nv_bfloat16* kb = k + (long)b * tk * k_stride + h * kD;
  const __nv_bfloat16* vb = v + (long)b * tk * v_stride + h * kD;
  // this thread's two query rows
  const int row[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  const int offset = tk - tq;

  // key tiles at or below the block's last row; the leading n_free of them
  // lie below its first row's bound and need no mask
  const int last_row = min(q0 + kBQ - 1, tq - 1);
  const int n_tiles = min((tk + kBK - 1) / kBK, (last_row + offset) / kBK + 1);
  const int n_free = min(n_tiles, (q0 + offset + 1) / kBK);

  load_tile(sq, qb, q0, tq, q_stride, tid);
  cp_async_commit();
  load_tile(sk[0], kb, 0, tk, k_stride, tid);
  load_tile(sv[0], vb, 0, tk, v_stride, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // This warp's 16x64 Q block as four 16x16 A fragments.
  uint32_t qf[4][4];
  load_a_frags(qf, sq, warp, lane);

  float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4+8
  float l_run[2] = {0.f, 0.f};              // this thread's partial sums
  float acc[8][4];
  zero_acc(acc);

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile(sk[(j + 1) & 1], kb, (j + 1) * kBK, tk, k_stride, tid);
      load_tile(sv[(j + 1) & 1], vb, (j + 1) * kBK, tk, v_stride, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* skt = sk[j & 1];
    const __nv_bfloat16* svt = sv[j & 1];

    // S = Q K^T for 16 rows x 64 keys: 8 key tiles of 8.
    float s[8][4];
    zero_acc(s);
    mma_a_tile_t(s, qf, skt, lane);

    // Scale into log2 units, mask, update the running max.
    const int key0 = j * kBK + (lane & 3) * 2;
    const bool masked = j >= n_free;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + nt * 8 + (e & 1);
        bool keep = true;
        if (masked) {
          keep = col < tk && col <= row[e >> 1] + offset;
        }
        const float x = keep ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);  // 0 on the first tile
      m_run[r] = mx[r];
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
      acc[nt][0] *= corr[0];
      acc[nt][1] *= corr[0];
      acc[nt][2] *= corr[1];
      acc[nt][3] *= corr[1];
    }

    // O += P V: P's accumulators re-packed as bf16 A fragments.
    mma_acc_tile(acc, s, svt, lane);
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // Finalize: full row sums across the quad, normalise, store O and LSE.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  __nv_bfloat16* ob = o + (long)b * tq * row_stride + h * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= tq) continue;
    const float inv = 1.f / fmaxf(l_run[r], 1e-30f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(ob + (long)row[r] * row_stride);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      dst[(dt * 8 + (lane & 3) * 2) >> 1] =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if ((lane & 3) == 0) {
      lse[(long)bh * tq + row[r]] =
          m_run[r] * 0.6931471805599453f + logf(fmaxf(l_run[r], 1e-30f));
    }
  }
}

}  // namespace

// q (B, Tq, H, 64), k/v (B, Tk, H, 64) bf16, each with a token stride in
// elements (H*64 when contiguous; each head's 64 values contiguous) -> o
// (B, Tq, H, 64) bf16 contiguous and lse (B, H, Tq) fp32, with the
// end-aligned causal mask. Returns the launch's cudaError_t.
extern "C" int kwt_flash_attention_causal_fwd(const void* q, const void* k, const void* v,
                                              void* o, void* lse, int batch, int tq, int tk,
                                              int n_heads, long long q_stride,
                                              long long k_stride, long long v_stride,
                                              void* stream) {
  const float scale_log2 = 0.125f * kLog2e;  // 1/sqrt(64)*log2(e)
  dim3 grid((tq + kBQ - 1) / kBQ, batch * n_heads);
  flash_fwd_causal_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), tq, tk, n_heads, (long)q_stride, (long)k_stride,
      (long)v_stride, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
