// int8 attention core (K8) for Hopper: non-causal softmax(q k^T / 8) v
// with the scores from an s8 x s8 -> s32 product ("qk"), and optionally
// P V as an s8 x s8 -> s32 product too ("qkpv").
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py
// `_fwd_kernel_single_int8` (called through `_flash_fwd` under
// KWT_FA_INT8). q arrives in bf16 and is quantized per query row inside
// the kernel: qs = max(absmax, 1e-8) * (1/127), q8 = round-half-even(q /
// qs). K arrives quantized per key row (int8 plus fp32 scales ks, (B, H,
// Tk)); the scores are dequantized as s32 * ((qs * 1/8) * ks), the TPU
// kernel's rank-1 fold, operation for operation. qk: P is rounded to bf16
// for P V on bf16 V (as K1). qkpv: p8 = round(p * 127) against the row's
// FINAL max, V quantized per column over T (int8 plus fp32 scales vs,
// (B, H, 64)), and O = s32 * ((1/127) * vs) / l. Emits O in bf16 and the
// fp32 natural-log LSE, which K5 takes for the backward pass.
//
// What bounds it on the card: at the encoder's shape (B=16, 20 heads,
// T=1500, D=64) qk mode does 2*B*H*T^2*D = 92 G int8 ops (0.047 ms at
// 1979 TOP/s) and 92 GFLOP of bf16 P V (0.093 ms at 989 TFLOP/s): 0.14 ms
// of tensor work, over 219 MB of q, k8, ks, v, O and LSE (0.065 ms). The
// 7.2e8 exponentials are a term of the same size on the SFUs (counted in
// PERF.md from the exp rate tools/vpu_cal.py measures).
//
// Design: the TPU kernel holds the whole key range and takes the row max
// over all of it before any exponential; p8 is rounded against that final
// max. A streaming kernel with a running max (K1's design) would quantize
// P against the wrong max, so this kernel makes two passes over the key
// tiles: pass 1 computes the int8 scores and the exact row max; pass 2
// recomputes the same scores (bit for bit), takes p = exp2((s - m) log2 e),
// the row sum and P V. The int8 products are cheap next to the
// exponentials, so the second QK^T costs little. One block of 4 warps owns
// 64 query rows of one (batch, head); each warp owns 16 rows and keeps its
// quantized Q fragments, the row max and sum and the 16 x 64 output
// accumulators in registers. QK^T runs on mma.sync m16n8k32 (s8, s32
// sums): int8 tiles live in shared memory with an 80-byte row pitch, which
// makes the 32-bit fragment loads free of bank conflicts. In qkpv mode p8
// leaves the score accumulators as A fragments with the keys permuted
// inside each 32-key step; the wrapper stores V transposed per head (D
// rows of Tk keys), so the B fragment reads the same permuted keys with
// two 16-bit loads. qk mode reuses K1's bf16 V tiles and P V product.
// Tiles are loaded with cp.async, one buffer per pass (no prefetch yet).
// Rows past Tq are computed on zero Q and not stored; keys past Tk are
// masked to -inf and zero-filled.
// Later work: double buffering, wgmma, and the KWT_FA_NOMAX shift bound.
#include "flash_common.cuh"

namespace {

using namespace kwt_flash;

constexpr int kP8 = 80;  // byte pitch of int8 tiles
constexpr float kInv127 = (float)(1.0 / 127.0);

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

template <bool kPV8>
__global__ void __launch_bounds__(kThreads)
    flash_int8_kernel(const __nv_bfloat16* __restrict__ q,
                      const int8_t* __restrict__ k8,
                      const float* __restrict__ ks,
                      const void* __restrict__ v_any,
                      const float* __restrict__ vs,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int tq, int tk, int n_heads, long q_stride, long v_stride,
                      int tk_pad) {
  __shared__ __align__(128) int8_t sq8[kBQ * kP8];
  __shared__ __align__(128) int8_t sk8[kBK * kP8];
  __shared__ __align__(128) __nv_bfloat16 sv[kBK * kD];  // bf16 V, or V^T int8
  __shared__ float s_qs[kBQ];
  __shared__ float s_ks[kBK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh - b * n_heads;

  // ---- quantize this block's 64 query rows: two threads per row ----
  {
    const int r = tid >> 1, half = tid & 1, gq = q0 + r;
    float x[32];
    if (gq < tq) {
      const __nv_bfloat16* src = q + ((long)b * tq + gq) * q_stride + h * kD + half * 32;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
        const __nv_bfloat162* hv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(hv[i]);
          x[c * 8 + 2 * i] = f.x;
          x[c * 8 + 2 * i + 1] = f.y;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = 0.f;
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) amax = fmaxf(amax, fabsf(x[i]));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    const float qs = fmaxf(amax, 1e-8f) * kInv127;
    uint32_t* dst = reinterpret_cast<uint32_t*>(sq8 + r * kP8 + half * 32);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int v4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v4[i] = (int)rintf(__fdiv_rn(x[c * 4 + i], qs));
      dst[c] = pack_s8(v4[0], v4[1], v4[2], v4[3]);
    }
    if (half == 0) s_qs[r] = qs;
  }
  __syncthreads();

  // This warp's 16 x 64 Q8 block as two 16 x 32 A fragments.
  uint32_t qa[2][4];
  const int wr = warp * 16;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int8_t* base = sq8 + kk * 32 + 4 * t4;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base + (wr + g) * kP8);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + (wr + g + 8) * kP8);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + (wr + g) * kP8 + 16);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + (wr + g + 8) * kP8 + 16);
  }
  // (qs * 1/8) for this thread's rows g and g + 8
  const float qsc[2] = {s_qs[wr + g] * 0.125f, s_qs[wr + g + 8] * 0.125f};

  const int n_tiles = (tk + kBK - 1) / kBK;
  const int8_t* kb = k8 + (long)b * tk * n_heads * kD + h * kD;
  const float* ksb = ks + (long)bh * tk;

  auto load_k = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads, r = c >> 2, ch = c & 3;
      const bool ok = k0 + r < tk;
      cp_async16(sk8 + r * kP8 + ch * 16,
                 kb + (ok ? (long)(k0 + r) * n_heads * kD : 0) + ch * 16, ok);
    }
    if (tid < kBK) s_ks[tid] = k0 + tid < tk ? ksb[k0 + tid] : 0.f;
  };

  // Dequantized scores of this warp's 16 rows against the staged key tile.
  auto scores = [&](int k0, float (*s)[4]) {
    int s32[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s32[nt][e] = 0;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int8_t* row = sk8 + (nt * 8 + g) * kP8 + kk * 32 + 4 * t4;
        mma_s8(s32[nt], qa[kk], *reinterpret_cast<const uint32_t*>(row),
               *reinterpret_cast<const uint32_t*>(row + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t4 + (e & 1);
        s[nt][e] = k0 + col < tk ? (float)s32[nt][e] * (qsc[e >> 1] * s_ks[col])
                                 : -INFINITY;
      }
    }
  };

  // ---- pass 1: the exact row max over every key ----
  float m_row[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < n_tiles; ++j) {
    load_k(j * kBK);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4];
    scores(j * kBK, s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) m_row[e >> 1] = fmaxf(m_row[e >> 1], s[nt][e]);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
  }

  // ---- pass 2: p = exp(s - m), row sums, P V ----
  float l_row[2] = {0.f, 0.f};
  float acc[8][4];    // qk: bf16 P V sums
  int acc8[8][4];     // qkpv: s8 P V sums
  zero_acc(acc);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc8[i][e] = 0;

  const int8_t* vtb = static_cast<const int8_t*>(v_any) + (long)bh * kD * tk_pad;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(v_any) + (long)b * tk * v_stride + h * kD;
  int8_t* svt = reinterpret_cast<int8_t*>(sv);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    load_k(k0);
    if (kPV8) {
      // V^T tile: 64 head dims x 64 keys, keys past tk_pad zero-filled
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + i * kThreads, r = c >> 2, ch = c & 3;
        const bool ok = k0 + ch * 16 < tk_pad;
        cp_async16(svt + r * kP8 + ch * 16, vtb + (long)r * tk_pad + (ok ? k0 + ch * 16 : 0),
                   ok);
      }
    } else {
      load_tile(sv, vb, k0, tk, v_stride, tid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[8][4];
    scores(k0, s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[nt][e] - m_row[e >> 1]) * kLog2e);
        s[nt][e] = p;
        l_row[e >> 1] += p;
      }

    if (kPV8) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // p8 of 32 keys; logical k 4t..4t+3 <-> keys 2t, 2t+1, 8+2t, 9+2t
        // (and +16 for the upper half), matched by the B loads below
        int p8[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) p8[i][e] = (int)rintf(s[4 * kk + i][e] * 127.f);
        const uint32_t a[4] = {
            pack_s8(p8[0][0], p8[0][1], p8[1][0], p8[1][1]),
            pack_s8(p8[0][2], p8[0][3], p8[1][2], p8[1][3]),
            pack_s8(p8[2][0], p8[2][1], p8[3][0], p8[3][1]),
            pack_s8(p8[2][2], p8[2][3], p8[3][2], p8[3][3])};
#pragma unroll
        for (int nd = 0; nd < 8; ++nd) {
          const int8_t* row = svt + (nd * 8 + g) * kP8 + kk * 32 + 2 * t4;
          const uint32_t b0 = (uint32_t)*reinterpret_cast<const uint16_t*>(row) |
                              ((uint32_t)*reinterpret_cast<const uint16_t*>(row + 8) << 16);
          const uint32_t b1 = (uint32_t)*reinterpret_cast<const uint16_t*>(row + 16) |
                              ((uint32_t)*reinterpret_cast<const uint16_t*>(row + 24) << 16);
          mma_s8(acc8[nd], a, b0, b1);
        }
      }
    } else {
      mma_acc_tile(acc, s, sv, lane);
    }
    __syncthreads();  // the next tile's loads overwrite these buffers
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }

  const long row_stride = (long)n_heads * kD;
  __nv_bfloat16* ob = o + (long)b * tq * row_stride + h * kD;
  const float* vsb = vs + (long)bh * kD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= tq) continue;
    const float l_safe = fmaxf(l_row[r], 1e-30f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(ob + (long)row * row_stride);
#pragma unroll
    for (int nd = 0; nd < 8; ++nd) {
      const int d0 = nd * 8 + 2 * t4;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = kPV8 ? (float)acc8[nd][2 * r + e] * (kInv127 * vsb[d0 + e])
                             : acc[nd][2 * r + e];
        y[e] = __fdiv_rn(x, l_safe);
      }
      dst[d0 >> 1] = pack_bf16(y[0], y[1]);
    }
    if (t4 == 0) lse[(long)bh * tq + row] = m_row[r] + logf(l_safe);
  }
}

}  // namespace

// q (B, Tq, H, 64) bf16 with token stride q_stride (elements); k8 (B, Tk,
// H, 64) int8 contiguous; ks (B, H, Tk) fp32. pv8 == 0 (qk): v (B, Tk, H,
// 64) bf16 with token stride v_stride, vs unused. pv8 != 0 (qkpv): v
// (B, H, 64, tk_pad) int8, V^T per head with keys zero-padded to tk_pad (a
// multiple of 16), vs (B, H, 64) fp32. o (B, Tq, H, 64) bf16, lse (B, H,
// Tq) fp32. Returns the launch's cudaError_t.
extern "C" int kwt_flash_attention_int8(const void* q, const void* k8,
                                        const void* ks, const void* v,
                                        const void* vs, void* o, void* lse,
                                        int batch, int tq, int tk, int n_heads,
                                        long long q_stride, long long v_stride,
                                        int tk_pad, int pv8, void* stream) {
  dim3 grid((tq + kBQ - 1) / kBQ, batch * n_heads);
  auto kernel = pv8 ? flash_int8_kernel<true> : flash_int8_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k8),
      static_cast<const float*>(ks), v, static_cast<const float*>(vs),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), tq, tk, n_heads,
      (long)q_stride, (long)v_stride, tk_pad);
  return static_cast<int>(cudaGetLastError());
}
