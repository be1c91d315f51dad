// Encoder self-attention forward (K1) for Hopper, bf16 in / bf16 out.
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py `_fwd_kernel_single`
// (called through `_flash_fwd`), the TPU's one-shot non-causal softmax
// attention that emits O in the input dtype and the fp32 natural-log LSE.
//
// What bounds it on the card: at the encoder's shape (B*20 heads, T=1500,
// D=64) one call does 4*B*H*T^2*D flops (184 GFLOP at B=16) over 4*B*T*H*D*2
// bytes (246 MB), so it sits well above the H100's ~295 flop/byte ridge:
// tensor-core bound (about 0.19 ms at 989 TFLOP/s), with the B*H*T^2
// exponentials on the SFUs a close second.
//
// Design: the TPU kernel keeps all of K and V resident (1500x64x2x2 B =
// 384 KB); a Hopper block has 227 KB of shared memory, so this kernel
// streams 64-key tiles with an online softmax instead (FlashAttention-2
// order). One block of 4 warps owns 64 query rows of one (batch, head);
// each warp owns 16 rows and keeps its Q fragment, the running max/sum and
// the 16x64 fp32 output accumulator in registers. QK^T and PV run on the
// tensor cores through mma.sync m16n8k16 (bf16 operands, fp32 sums); P is
// re-packed from the score accumulators into A fragments without touching
// shared memory. K/V tiles are double-buffered with cp.async, and tiles are
// XOR-swizzled so ldmatrix reads are free of bank conflicts. The 1/sqrt(64)
// scale and log2(e) fold into one fp32 multiply of the scores (exact scale,
// exp2 on the SFU). Keys past T (the ragged last tile of T=1500) are masked
// to -inf; rows past T are computed on zero-filled Q and never stored.
// Tensors keep the model's (B, T, H, D) layout: a head's row is 128
// contiguous bytes, so no transpose to (B*H, T, D) is needed.
// Later work: wgmma + TMA + warp specialisation, and overlapping the
// exponentials with the MMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per block (4 warps x 16)
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk `chunk` (0..7) of row `row` in a
// (rows x 64) bf16 tile: chunks are XOR-swizzled by the row's low 3 bits.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kD + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the destination
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0+64) of one head into a swizzled smem tile;
// rows >= n_rows are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          int row0, int n_rows,
                                          long row_stride, int tid) {
#pragma unroll
  for (int i = 0; i < (kBQ * kD / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3, ch = c & 7;
    const int g = row0 + r;
    const bool ok = g < n_rows;
    const __nv_bfloat16* src = base + (ok ? (long)g * row_stride : 0) + ch * 8;
    cp_async16(tile + swz(r, ch), src, ok);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int tq, int tk, int n_heads, float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 sq[kBQ * kD];
  __shared__ __align__(128) __nv_bfloat16 sk[2][kBK * kD];
  __shared__ __align__(128) __nv_bfloat16 sv[2][kBK * kD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const long row_stride = (long)n_heads * kD;
  const __nv_bfloat16* qb = q + (long)b * tq * row_stride + h * kD;
  const __nv_bfloat16* kb = k + (long)b * tk * row_stride + h * kD;
  const __nv_bfloat16* vb = v + (long)b * tk * row_stride + h * kD;

  load_tile(sq, qb, q0, tq, row_stride, tid);
  cp_async_commit();
  load_tile(sk[0], kb, 0, tk, row_stride, tid);
  load_tile(sv[0], vb, 0, tk, row_stride, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // This warp's 16x64 Q block as four 16x16 A fragments.
  uint32_t qf[4][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int r = warp * 16 + (lane & 15);
    ldsm_x4(qf[ks], sq + swz(r, ks * 2 + (lane >> 4)));
  }

  float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4+8
  float l_run[2] = {0.f, 0.f};              // this thread's partial sums
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  const int n_tiles = (tk + kBK - 1) / kBK;
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

    // S = Q K^T for 16 rows x 64 keys: 8 key tiles of 8.
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldsm_x4(bk, skt + swz(key, ks * 2 + ((lane >> 3) & 1)));
        mma16816(s[2 * np], qf[ks], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // Scale into log2 units, mask keys past tk, update the running max.
    const int key0 = j * kBK + (lane & 3) * 2;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + nt * 8 + (e & 1);
        const float x = col < tk ? s[nt][e] * scale_log2 : -INFINITY;
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
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bv[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(bv, svt + swz(key, dp * 2 + (lane >> 4)));
        mma16816(acc[2 * dp], pa, bv[0], bv[1]);
        mma16816(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }

  // Finalize: full row sums across the quad, normalise, store O and LSE.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int row[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
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

// q (B, Tq, H, 64), k/v (B, Tk, H, 64) bf16 contiguous -> o (B, Tq, H, 64)
// bf16 and lse (B, H, Tq) fp32. Returns the launch's cudaError_t.
extern "C" int kwt_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int batch, int tq, int tk, int n_heads,
                                       void* stream) {
  const float scale_log2 = 0.125f * 1.4426950408889634f;  // 1/sqrt(64)*log2(e)
  dim3 grid((tq + kBQ - 1) / kBQ, batch * n_heads);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), tq, tk, n_heads, scale_log2);
  return static_cast<int>(cudaGetLastError());
}
