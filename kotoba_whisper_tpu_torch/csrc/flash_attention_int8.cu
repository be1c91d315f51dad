// int8 attention core (K8) for Hopper: non-causal softmax(q k^T / 8) v
// with the scores from an s8 x s8 -> s32 product ("qk"), and optionally
// P V as an s8 x s8 -> s32 product too ("qkpv").
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py
// `_fwd_kernel_single_int8` (called through `_flash_fwd` under
// KWT_FA_INT8), together with the K (and V) quantization `_flash_fwd`
// runs in XLA ahead of it. q is quantized per query row inside the
// kernel: qs = max(absmax, 1e-8) * (1/127), q8 = round-half-even(q / qs).
// K is quantized per key row the same way; the scores are s32 * ((qs *
// 1/8) * ks), the TPU kernel's rank-1 fold, operation for operation. qk: P
// is rounded to bf16 for P V on bf16 V (as K1). qkpv: V is quantized per
// column over T, p8 = round(p * 127) against the row's FINAL max, and O =
// s32 * ((1/127) * vs) / l. Emits O in bf16 and the fp32 natural-log LSE,
// which K5 takes for the backward pass.
//
// What bounds it on the card: at the encoder's shape (B=16, 20 heads,
// T=1500, D=64) qk mode does 2*B*H*T^2*D = 92 G int8 ops (0.047 ms at
// 1979 TOP/s) and 92 GFLOP of bf16 P V (0.093 ms at 989 TFLOP/s): 0.14 ms
// of tensor work, over ~248 MB of bf16 q, k, v and O and the fp32 LSE
// (0.074 ms). The 7.2e8 exponentials take 0.172 ms at the SFUs' 16 a clock
// per SM, and every score also costs ~10 other instructions (convert,
// dequantize, max, shift, sum, pack), a term of the same size.
//
// Design: two launches.
//  1. `int8_prepass` quantizes K once, read in the model's (B, T, H, 64)
//     layout at its own strides (a fused projection's column block is read
//     in place): k8 (B, Tk, H, 64) and ks (B, H, tk_pad) with zero scales
//     past Tk; eight threads a key row, the absmax over shuffles, the
//     twin's rounding (round-half-even of the true quotient). qkpv: one
//     block a (batch, head) takes each column's absmax over T, then writes V8^T
//     (B, H, 64, tk_pad), keys zero past Tk, with the keys of each 32-key
//     group permuted so that the s32 score accumulator's register layout
//     is the A fragment of the P V wgmma: position 16hi + 4t + i holds key
//     16hi + 8(i >> 1) + 2t + (i & 1) (ops/flash_attention.py
//     `V8T_KEY_ORDER`).
//  2. `flash_int8_kernel`, K1's skeleton with int8 scores: a persistent
//     grid of one 384-thread CTA per SM walks 128-row query tiles,
//     (batch, head)-major, so one head's k8 (and V8^T) stays in L2 across
//     its query tiles. Warpgroup 0 is the producer (setmaxnreg 24): one
//     thread keeps TMA loads in flight on mbarriers: two bf16 Q tiles
//     (K1's 4-D maps), a 4-stage ring of 128-key k8 tiles (64-byte rows,
//     64-byte swizzle) with their 128 scales (a 1-D bulk copy), and a
//     3-stage ring of V tiles (bf16, MN-major, in place; or V8^T, 128-byte
//     rows of keys, K-major). Warpgroups 1 and 2 each own 64 of the 128
//     rows: they quantize their rows of the Q tile into s8 A fragments in
//     registers (row absmax over quad shuffles) and release it at once.
//     S = Q8 K8^T is a wgmma m64n128k32 s8 chain of two k-steps; s32 goes
//     to f32 by cvt.rn.f32.s32 (exact: |s32| <= 127^2 * 64 < 2^24), one
//     I2FP on sm_90, which runs on the ALU and measured faster than adding
//     s32 to the bits of 1.5 * 2^23 and subtracting 1.5 * 2^23 (PERF.md).
//       qk: one pass, K1's online softmax in log2 units; P leaves the
//     accumulators as bf16 A fragments and O += P V runs on K1's m64n64k16
//     bf16 wgmma. The exponentials of tile j run while P_{j-1} V_{j-1} is
//     in flight, and the warpgroups take turns at the tensor cores (named
//     barriers 1 and 2), as in K1.
//       qkpv: two passes over the key tiles. Pass 1 computes S and the
//     exact row max only (no exponentials, no V loads; its short S products
//     are issued without turns). Pass 2 recomputes the same S bit for bit
//     with the same instructions, so s - m <= 0 and
//     the row's max key gives p8 = 127; p = ex2(s log2(e) - m log2(e)),
//     the row sum, and p8 = round(p * 127) by adding 1.5 * 2^23 (round to
//     nearest even, as rint), its low byte packed with byte permutes into
//     the s8 A fragments; O += P8 V8 runs on wgmma m64n64k32 s8.
//     Holding a head's k8 and V8^T resident in shared memory across both
//     passes, as the TPU kernel holds them in VMEM, would need ~196 KB at
//     T=1500 beside the Q tiles, above the 227 KB a block may use with
//     the rings; the second pass reads k8 from L2 instead.
//   The loops are peeled so that no wgmma is issued under a branch
//   (ptxas serialises wgmmas on divergent paths). The epilogue divides by
//   l_safe = max(l, 1e-30), as the TPU kernel, and stores bf16 O and the
//   natural-log LSE from registers. The quantizers' and the epilogue's
//   true divisions are taken as products with the correctly rounded
//   reciprocal, checked against the nearest rounding boundary, and as true
//   quotients where one is near (`quant_words`, `div_for_bf16`): the same
//   bits, where true quotients throughout measured 8-13 % slower (PERF.md).
//   Rows past Tq are never stored; keys past Tk (TMA zero-fills k8 and V
//   there) are masked to -inf in the last, ragged key tile.
// The fp32-q form (fp32 q, k and v, as an fp32 model runs under
// KWT_FA_INT8): the pre-pass quantizes fp32 K (and V) the same way, and
// `flash_int8_f32_kernel` runs on the CUDA cores, since the TPU kernel's
// qk mode takes P V in fp32 there (`p.astype(in_dtype)` with an fp32 V),
// which the tensor cores take only as TF32. A 256-thread CTA takes 64 query
// rows and walks 64-key tiles, as the fp32 K1 does: q quantized per row in
// the kernel, S from __dp4a over four-dim words of Q8 and K8 (exact int32),
// dequantized as above; qk: K1's online softmax and O += P V on FFMAs; qkpv:
// a first pass for the exact row max, p = expf(s - m) (the twin's exp of
// the same difference, so p8 = round(p * 127) takes the twin's codes), and
// O += p8 V8 in int32 (V8^T's key order undone in shared memory). O is
// fp32, divided by l_safe (true division). Its bound at the encoder's
// shape: qk, the fp32 P V, 92 GFLOP (1.37 ms at 67 TFLOP/s); qkpv, its
// 7.2e8 exponentials (0.17 ms at the SFUs' rate).
#include <cuda.h>

#include <type_traits>

#include "card.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kD = 64;                      // head dim
constexpr int kWGs = 2;                     // consumer warpgroups, 64 query rows each
constexpr int kBM = 64 * kWGs;              // query rows per work item
constexpr int kBN = 128;                    // keys per tile
constexpr int kKStages = 4;                 // k8 ring depth
constexpr int kVStages = 3;                 // V ring depth
constexpr int kThreads = 128 * (kWGs + 1);  // + the producer warpgroup
constexpr int kConsumers = 128 * kWGs;
constexpr int kTurn = 256;  // threads on a turn barrier: the warpgroup waiting, the one handing over
constexpr uint32_t kQBytes = kBM * kD * 2;   // one 128 x 64 bf16 Q box
constexpr uint32_t kK8Bytes = kBN * kD;      // one 128 x 64 int8 key box
constexpr uint32_t kKsBytes = kBN * 4;       // its scales
constexpr int kPreThreads = 256;
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23: ulp 1, integers in its binade exact

struct __align__(1024) Smem {
  __nv_bfloat16 q[2][kBM * kD];
  int8_t k[kKStages][kBN * kD];
  __nv_bfloat16 v[kVStages][kBN * kD];  // bf16 V (qk), or an int8 V^T tile in the first half (qkpv)
  float ks[kKStages][kBN];
  uint64_t q_full[2], q_empty[2];
  uint64_t k_full[kKStages], k_empty[kKStages], v_full[kVStages], v_empty[kVStages];
};

template <typename T, int N>
__device__ __forceinline__ void fence_acc(T (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(acc[i]);
}

// The low bytes of four words, a lowest.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The bits of p * 127 + 1.5 * 2^23 (two roundings, as the twin's round(p *
// 127)): the low byte is round-half-even(p * 127) for p in [0, ~1].
__device__ __forceinline__ uint32_t p8_word(float p) {
  return __float_as_uint(__fadd_rn(__fmul_rn(p, 127.f), kMagic));
}

// w[i] = the bits of round-half-even(x[i] / d[i * step]) + 1.5 * 2^23 (the
// rounded value in the low byte for |x / d| <= 127.5), exactly as
// rintf(__fdiv_rn(x, d)) rounds: x times r = 1/d (correctly rounded) is
// within 2.3e-5 of the quotient, so it rounds the same way unless it lies
// within 2.4e-4 of a half; if any of the n does, all n take the true
// quotient.
template <int N>
__device__ __forceinline__ void quant_words(uint32_t* w, const float* x, const float* d,
                                            const float* r, int step) {
  float margin = 1.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float y = __fmul_rn(x[i], r[i * step]);
    const float t = __fadd_rn(y, kMagic);
    margin = fminf(margin, fabsf(fabsf(__fsub_rn(y, __fsub_rn(t, kMagic))) - 0.5f));
    w[i] = __float_as_uint(t);
  }
  if (margin < 2.4e-4f) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      w[i] = __float_as_uint(__fadd_rn(__fdiv_rn(x[i], d[i * step]), kMagic));
  }
}

// y[i] = x[i] / l as far as its bf16 rounding goes, equal to __fdiv_rn: x
// times r = 1/l (correctly rounded) is within two ulps of the quotient, so
// both round to the same bf16 unless the product's low 16 bits lie within
// 16 ulps of the rounding boundary 0x8000; if any of the n does, all n take
// the true quotient.
template <int N>
__device__ __forceinline__ void div_for_bf16(float* y, const float* x, float l, float r) {
  bool near = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    y[i] = __fmul_rn(x[i], r);
    near |= (__float_as_uint(y[i]) & 0xFFFFu) - 0x7FF0u < 0x20u;
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < N; ++i) y[i] = __fdiv_rn(x[i], l);
  }
}

// This thread's rows r and r + 8 of the 128-row bf16 Q tile (128-byte
// rows, 128-byte swizzle), quantized as the TPU kernel does into the s8 A
// fragments of the two k-steps of 32 head dims (row r in registers 0 and 2,
// row r + 8 in 1 and 3; columns 32kk + 16hi + 4(lane & 3) + 0..3); qsc gets
// qs / 8 of each row.
__device__ __forceinline__ void quantize_q(uint32_t (*qa)[4], float* qsc,
                                           const __nv_bfloat16* q_tile, int r, int lane) {
  const int t = lane & 3, sw = r & 7;  // (r + 8) & 7 == r & 7
  float x[2][16];                      // [row][8kk + 4hi + j]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const uint8_t* row = reinterpret_cast<const uint8_t*>(q_tile) + (r + 8 * rr) * 128;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int chunk = 4 * kk + 2 * hi + (t >> 1);
        const uint2 raw =
            *reinterpret_cast<const uint2*>(row + ((chunk ^ sw) << 4) + 8 * (t & 1));
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
        float* dst = &x[rr][8 * kk + 4 * hi];
        dst[0] = a.x;
        dst[1] = a.y;
        dst[2] = b.x;
        dst[3] = b.y;
      }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(x[rr][i]));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    const float qs = fmaxf(amax, 1e-8f) * kInv127, rq = __frcp_rn(qs);
    qsc[rr] = qs * 0.125f;
    uint32_t w[16];
    quant_words<16>(w, x[rr], &qs, &rq, 0);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const uint32_t* src = &w[8 * kk + 4 * hi];
        qa[kk][rr + 2 * hi] = pack_low_bytes(src[0], src[1], src[2], src[3]);
      }
  }
}

// S (64 x 128, s32) = Q8 (this warpgroup's 64 rows, registers) K8^T: two
// k-steps of 32 head dims, 32 bytes apart in the 64-byte swizzled key rows.
__device__ __forceinline__ void issue_s(int* sacc, const uint32_t (*qa)[4], uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_m64n128k32_s8_rs(sacc, qa[kk], sw64_desc(k_addr + kk * 32, 16, 512), kk);
}

// qk: O (64 x 64, fp32) += P (bf16 A fragments, 128 keys) V (bf16,
// MN-major): eight k-steps of 16 keys, each 16 rows (2048 bytes) further.
__device__ __forceinline__ void issue_pv(float* oacc, const uint32_t (*pa)[4], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_m64n64k16_rs_mn(oacc, pa[kk], sw128_desc(v_addr + kk * 2048, 1024, 1024));
}
// qkpv: O (64 x 64, s32) += P8 (s8 A fragments, 128 keys) V8 (V8^T rows of
// 128 keys, K-major): four k-steps of 32 keys, 32 bytes apart.
__device__ __forceinline__ void issue_pv(int* oacc, const uint32_t (*pa)[4], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBN / 32; ++kk)
    wgmma_m64n64k32_s8_rs(oacc, pa[kk], sw128_desc(v_addr + kk * 32, 16, 1024), 1);
}

// Scores of one tile from its s32 sums: s = s32 * ((qs / 8) * ks), columns
// 8i + 2(lane & 3) + {0, 1}; when `mask` (the ragged last tile), keys past
// tk (key0 is this thread's first column's key) are -inf, in a loop of its
// own so that the other tiles pay nothing for it.
__device__ __forceinline__ void dequant(float* s, const int* s32, const float* ks_tile,
                                        const float* qsc, bool mask, int key0, int tk,
                                        int col0) {
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    const float2 kv = *reinterpret_cast<const float2*>(ks_tile + 8 * i + col0);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * i + e] = __fmul_rn(__int2float_rn(s32[4 * i + e]),
                               __fmul_rn(qsc[e >> 1], (e & 1) ? kv.y : kv.x));
  }
  if (mask) {
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (key0 + 8 * i + (e & 1) >= tk) s[4 * i + e] = -INFINITY;
  }
}

// qk: K1's online softmax of one tile in place, log2 units: the running
// max m and this thread's partial sums l updated, corr = exp2(m_old -
// m_new) for O, S replaced by P = exp2(s log2(e) - m).
__device__ __forceinline__ void softmax_online(float* s, float* m_run, float* l_run,
                                               float* corr) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r] * kLog2e);
    corr[r] = ex2(m_run[r] - m_new);  // 0 on the first tile
    m_run[r] = m_new;
    l_run[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * i + e], kLog2e, -m_run[e >> 1]));
      s[4 * i + e] = p;
      l_run[e >> 1] += p;
    }
}

// qkpv: P = exp2(s log2(e) - m log2(e)) against the final max, in place,
// and this thread's partial sums.
__device__ __forceinline__ void softmax_fixed(float* s, const float* m_log2, float* l_run) {
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * i + e], kLog2e, -m_log2[e >> 1]));
      s[4 * i + e] = p;
      l_run[e >> 1] += p;
    }
}

// P (fp32, the S accumulator layout) -> bf16 A fragments of the P V wgmma:
// k-step kk takes the accumulator's n8 blocks 2kk and 2kk+1.
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// P -> p8 = round(p * 127) as s8 A fragments of the four k-steps of 32
// keys. Step kk takes the accumulator's n8 blocks 4kk..4kk+3 (b[4j + e]);
// its logical k = 16hi + 4(lane & 3) + i is key 16hi + 8(i >> 1) + 2(lane
// & 3) + (i & 1) of the step, the order V8^T's keys are stored in.
__device__ __forceinline__ void pack_p8(uint32_t (*pa)[4], const float* s) {
#pragma unroll
  for (int kk = 0; kk < kBN / 32; ++kk) {
    const float* b = s + 16 * kk;
    pa[kk][0] = pack_low_bytes(p8_word(b[0]), p8_word(b[1]), p8_word(b[4]), p8_word(b[5]));
    pa[kk][1] = pack_low_bytes(p8_word(b[2]), p8_word(b[3]), p8_word(b[6]), p8_word(b[7]));
    pa[kk][2] = pack_low_bytes(p8_word(b[8]), p8_word(b[9]), p8_word(b[12]), p8_word(b[13]));
    pa[kk][3] = pack_low_bytes(p8_word(b[10]), p8_word(b[11]), p8_word(b[14]), p8_word(b[15]));
  }
}

template <bool kPV8>
__global__ void __launch_bounds__(kThreads, 1)
    flash_int8_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k8,
                      const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ ks,
                      const float* __restrict__ vs, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int tq, int tk, int tk_pad, int n_heads,
                      int n_qtiles, int n_work) {
  extern __shared__ uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int n_tiles = (tk + kBN - 1) / kBN;
  constexpr uint32_t kVBytes = kPV8 ? kD * kBN : kBN * kD * 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], kConsumers);
    }
    for (int i = 0; i < kKStages; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.k_empty[i], kConsumers);
    }
    for (int i = 0; i < kVStages; ++i) {
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.v_empty[i], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every copy --------------------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      prefetch_tmap(&tm_q);
      prefetch_tmap(&tm_k8);
      prefetch_tmap(&tm_v);
      uint32_t kc = 0, vc = 0, qi = 0;  // k8 tiles, V tiles and Q tiles issued so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++qi) {
        const int bh = w / n_qtiles, q0 = (w - bh * n_qtiles) * kBM;
        const int b = bh / n_heads, h = bh - b * n_heads;
        const int qs = qi & 1;
        mbar_wait(&s.q_empty[qs], ((qi >> 1) & 1) ^ 1);
        mbar_expect_tx(&s.q_full[qs], kQBytes);
        tma_load_4d(s.q[qs], &tm_q, &s.q_full[qs], 0, h, q0, b);
        const float* ks_bh = ks + (long)bh * tk_pad;
        // qkpv: pass 1 streams the k8 tiles alone, pass 2 k8 and V8^T
        for (int pass = 0; pass < (kPV8 ? 2 : 1); ++pass) {
          const bool with_v = !kPV8 || pass == 1;
          for (int j = 0; j < n_tiles; ++j) {
            const int st = kc % kKStages;
            mbar_wait(&s.k_empty[st], ((kc / kKStages) & 1) ^ 1);
            mbar_expect_tx(&s.k_full[st], kK8Bytes + kKsBytes);
            tma_load_4d(s.k[st], &tm_k8, &s.k_full[st], 0, h, j * kBN, b);
            bulk_load(s.ks[st], ks_bh + j * kBN, kKsBytes, &s.k_full[st]);
            ++kc;
            if (!with_v) continue;
            const int vst = vc % kVStages;
            mbar_wait(&s.v_empty[vst], ((vc / kVStages) & 1) ^ 1);
            mbar_expect_tx(&s.v_full[vst], kVBytes);
            if (kPV8)
              tma_load_3d(s.v[vst], &tm_v, &s.v_full[vst], j * kBN, 0, bh);
            else
              tma_load_4d(s.v[vst], &tm_v, &s.v_full[vst], 0, h, j * kBN, b);
            ++vc;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -----------------------------------
    setmaxnreg_inc<240>();
    using Acc = typename std::conditional<kPV8, int, float>::type;
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid >> 5, lane = tid & 31;
    const int r_tile = c * 64 + warp * 16 + (lane >> 2);  // this thread's first row in the tile
    const int col0 = 2 * (lane & 3);                      // and first column in each n8 block
    const long row_stride = (long)n_heads * kD;           // of O
    const bool ragged = tk % kBN != 0;                    // only the last key tile is masked
    // the turns go round the consumers in order; consumer 0 takes the first
    if (c == kWGs - 1) named_bar_arrive(1, kTurn);
    const int next_turn = 1 + (c + 1) % kWGs;
    uint32_t kc = 0, vc = 0, qi = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++qi) {
      const int bh = w / n_qtiles, q0 = (w - bh * n_qtiles) * kBM;
      const int b = bh / n_heads, h = bh - b * n_heads;

      // Q8 in registers; the Q tile is free at once
      uint32_t qa[2][4];
      float qsc[2];
      const int qs = qi & 1;
      mbar_wait(&s.q_full[qs], (qi >> 1) & 1);
      quantize_q(qa, qsc, s.q[qs], r_tile, lane);
      mbar_arrive(&s.q_empty[qs]);

      int si[kBN / 2];    // S of the current tile, s32
      float sf[kBN / 2];  // its scores, then P
      float m_row[2] = {-INFINITY, -INFINITY};  // qkpv: the exact row max
      float m_log2[2];
      if constexpr (kPV8) {
        // ---- pass 1: S and the row max only ----
        for (int j = 0; j < n_tiles; ++j, ++kc) {
          const int st = kc % kKStages;
          mbar_wait(&s.k_full[st], (kc / kKStages) & 1);
          wgmma_fence();
          issue_s(si, qa, smem_u32(s.k[st]));
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(si);
          dequant(sf, si, s.ks[st], qsc, ragged && j == n_tiles - 1, j * kBN + col0, tk, col0);
          mbar_arrive(&s.k_empty[st]);
#pragma unroll
          for (int i = 0; i < kBN / 8; ++i) {
            m_row[0] = fmaxf(m_row[0], fmaxf(sf[4 * i], sf[4 * i + 1]));
            m_row[1] = fmaxf(m_row[1], fmaxf(sf[4 * i + 2], sf[4 * i + 3]));
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
          m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
          m_log2[r] = m_row[r] * kLog2e;
        }
      }

      // ---- the P V pass (qk: the only one) ----
      // Peeled (tile 0: S only; tiles 1..n-1: S and the previous tile's
      // P V; then the last P V) so that no wgmma is issued under a branch.
      Acc oacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[i] = 0;
      float m_run[2] = {-INFINITY, -INFINITY};  // qk: running max, log2 units
      float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
      uint32_t pa[kPV8 ? kBN / 32 : kBN / 16][4];
      float corr[2];
      {
        const int st = kc % kKStages;
        mbar_wait(&s.k_full[st], (kc / kKStages) & 1);
        named_bar_sync(1 + c, kTurn);
        wgmma_fence();
        issue_s(si, qa, smem_u32(s.k[st]));
        wgmma_commit();
        named_bar_arrive(next_turn, kTurn);
        wgmma_wait<0>();
        fence_acc(si);
        dequant(sf, si, s.ks[st], qsc, ragged && n_tiles == 1, col0, tk, col0);
        mbar_arrive(&s.k_empty[st]);
        ++kc;
        if constexpr (kPV8) {
          softmax_fixed(sf, m_log2, l_run);
          pack_p8(pa, sf);
        } else {
          softmax_online(sf, m_run, l_run, corr);
          pack_p(pa, sf);
        }
      }
      for (int j = 1; j < n_tiles; ++j, ++kc, ++vc) {
        const int st = kc % kKStages, vst = vc % kVStages;
        mbar_wait(&s.k_full[st], (kc / kKStages) & 1);
        mbar_wait(&s.v_full[vst], (vc / kVStages) & 1);
        named_bar_sync(1 + c, kTurn);
        wgmma_fence();
        issue_s(si, qa, smem_u32(s.k[st]));
        wgmma_commit();
        issue_pv(oacc, pa, smem_u32(s.v[vst]));
        wgmma_commit();
        named_bar_arrive(next_turn, kTurn);
        wgmma_wait<1>();  // S done, P V still in flight
        fence_acc(si);
        dequant(sf, si, s.ks[st], qsc, ragged && j == n_tiles - 1, j * kBN + col0, tk, col0);
        mbar_arrive(&s.k_empty[st]);
        if constexpr (kPV8)
          softmax_fixed(sf, m_log2, l_run);
        else
          softmax_online(sf, m_run, l_run, corr);
        wgmma_wait<0>();
        fence_acc(oacc);
        mbar_arrive(&s.v_empty[vst]);
        if constexpr (kPV8) {
          pack_p8(pa, sf);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            oacc[4 * i] *= corr[0];
            oacc[4 * i + 1] *= corr[0];
            oacc[4 * i + 2] *= corr[1];
            oacc[4 * i + 3] *= corr[1];
          }
          pack_p(pa, sf);
        }
      }
      {
        const int vst = vc % kVStages;
        mbar_wait(&s.v_full[vst], (vc / kVStages) & 1);
        named_bar_sync(1 + c, kTurn);
        wgmma_fence();
        issue_pv(oacc, pa, smem_u32(s.v[vst]));
        wgmma_commit();
        named_bar_arrive(next_turn, kTurn);
        wgmma_wait<0>();
        fence_acc(oacc);
        mbar_arrive(&s.v_empty[vst]);
        ++vc;
      }

      // ---- epilogue: full row sums over the quad, normalise, store ----------
      __nv_bfloat16* ob = o + (long)b * tq * row_stride + h * kD;
      const float* vsb = vs + (long)bh * kD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        const int row = q0 + r_tile + 8 * r;
        if (row >= tq) continue;
        const float l_safe = fmaxf(l_run[r], 1e-30f), rl = __frcp_rn(l_safe);
        uint32_t* dst = reinterpret_cast<uint32_t*>(ob + (long)row * row_stride);
        float x[16], y[16];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if constexpr (kPV8)
              x[2 * i + e] = (float)oacc[4 * i + 2 * r + e] * (kInv127 * vsb[8 * i + col0 + e]);
            else
              x[2 * i + e] = oacc[4 * i + 2 * r + e];
          }
        div_for_bf16<16>(y, x, l_safe, rl);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[(8 * i + col0) >> 1] = pack_bf16x2(y[2 * i], y[2 * i + 1]);
        if ((lane & 3) == 0)
          lse[(long)bh * tq + row] =
              (kPV8 ? m_row[r] : m_run[r] * kLn2) + logf(l_safe);
      }
    }
    // the last consumer hands its last turn over too; consumer 0 takes it
    // here, so every turn barrier ends balanced
    if (c == 0) named_bar_sync(1, kTurn);
  }
}

// ---- the fp32-q form: CUDA cores ----------------------------------------------

constexpr int kFT = 64;         // fp32 form: query rows a CTA, keys a tile
constexpr int kFPad = kFT + 4;  // a transposed row's words (keeps the 16-byte alignment)
constexpr int kFThreads = 256;  // a 16 x 16 grid of 4 x 4 blocks

struct F32Smem {
  int q8t[kD / 4][kFPad];  // Q8 of the CTA's rows, 4 dims a word, by row
  int k8t[kD / 4][kFPad];  // K8 of the tile, 4 dims a word, by key
  float qsc[kFT];          // qs / 8 of each row
  float ks[kFT];           // the tile's key scales
  union {
    float v[kFT][kD];  // qk: V of the tile, fp32, by key
    int v8[kFT][kD];   // qkpv: V8 of the tile by key (V8^T's order undone)
  };
  union {
    float pt[kFT][kFPad];  // qk: P^T of the tile
    int p8t[kFT][kFPad];   // qkpv: p8^T
  };
};

// The fp32 form's S tile: s = s32 * ((qs / 8) * ks), rows 4ty.., keys
// 4tx..; s32 from __dp4a over the 16 words of Q8 and K8 (exact integers in
// any order); keys past tk are -inf.
__device__ __forceinline__ void f32_scores(float (*sc)[4], const F32Smem& s, int ty, int tx,
                                           int k0, int tk) {
  int s32[4][4] = {};
#pragma unroll
  for (int w = 0; w < kD / 4; ++w) {
    const int4 a = *reinterpret_cast<const int4*>(&s.q8t[w][4 * ty]);
    const int4 c = *reinterpret_cast<const int4*>(&s.k8t[w][4 * tx]);
    const int av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s32[i][j] = __dp4a(av[i], cv[j], s32[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sc[i][j] = k0 + 4 * tx + j < tk
                     ? __fmul_rn(__int2float_rn(s32[i][j]),
                                 __fmul_rn(s.qsc[4 * ty + i], s.ks[4 * tx + j]))
                     : -INFINITY;
}

// K8 of keys [k0, k0 + 64) (zeros past tk) and their scales into shared
// memory: thread i takes 16 dims (four words) of key i / 4.
__device__ __forceinline__ void f32_load_k8(F32Smem& s, const int8_t* k8, const float* ks_bh,
                                            long long k8_row, int k0, int tk) {
  const int key = threadIdx.x >> 2, part = threadIdx.x & 3;
  int4 x = make_int4(0, 0, 0, 0);
  if (k0 + key < tk)
    x = *reinterpret_cast<const int4*>(k8 + (long long)(k0 + key) * k8_row + 16 * part);
  s.k8t[4 * part][key] = x.x;
  s.k8t[4 * part + 1][key] = x.y;
  s.k8t[4 * part + 2][key] = x.z;
  s.k8t[4 * part + 3][key] = x.w;
  if (threadIdx.x < kFT) s.ks[threadIdx.x] = ks_bh[k0 + threadIdx.x];  // zero past tk
}

// K8's fp32-q form: q (fp32) quantized per row here, K8 (and V8^T) from the
// pre-pass. A CTA of 256 threads takes 64 query rows of one (batch, head)
// and walks 64-key tiles. qk: one pass, K1's online softmax in log2 units,
// P kept in fp32 and O += P V on FFMAs with fp32 V (the TPU kernel's
// `p.astype(in_dtype)` is no rounding in fp32). qkpv: a first pass for the
// exact row max, then p = expf(s - m), p8 = round(p * 127) and O += p8 V8
// as exact int32 products. O = o / l_safe (true division),
// fp32; the LSE in natural-log units.
template <bool kPV8>
__global__ void __launch_bounds__(kFThreads)
    flash_int8_f32_kernel(const uint8_t* __restrict__ q, const int8_t* __restrict__ k8,
                          const float* __restrict__ ks, const uint8_t* __restrict__ v,
                          const int8_t* __restrict__ v8t, const float* __restrict__ vs,
                          float* __restrict__ o, float* __restrict__ lse, int tq, int tk,
                          int tk_pad, int n_heads, long long q_head, long long q_tok,
                          long long q_bat, long long v_head, long long v_tok, long long v_bat) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  F32Smem& s = *reinterpret_cast<F32Smem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * kFT, h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * n_heads + h;
  const unsigned half = 0xffffu << (tid & 16);  // the 16 threads of rows 4ty..
  const long long k8_row = (long long)n_heads * kD;
  const int8_t* k8_bh = k8 + (long long)b * tk * k8_row + h * kD;
  const float* ks_bh = ks + bh * tk_pad;
  const int n_tiles = (tk + kFT - 1) / kFT;

  {  // Q8: four threads a row, 16 dims each; the row's absmax over the four
    const int r = tid >> 2, part = tid & 3;
    float x[16] = {};
    if (q0 + r < tq) {
      const uint8_t* row = q + b * q_bat + (long long)(q0 + r) * q_tok + h * q_head + 64 * part;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 f = reinterpret_cast<const float4*>(row)[c];
        x[4 * c] = f.x, x[4 * c + 1] = f.y, x[4 * c + 2] = f.z, x[4 * c + 3] = f.w;
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) amax = fmaxf(amax, fabsf(x[i]));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    const float qs = fmaxf(amax, 1e-8f) * kInv127, rq = __frcp_rn(qs);
    uint32_t w[16];
    quant_words<16>(w, x, &qs, &rq, 0);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s.q8t[4 * part + c][r] = (int)pack_low_bytes(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
    if (part == 0) s.qsc[r] = qs * 0.125f;
  }

  float m_row[4];  // qkpv: the exact row max; qk: the running max in log2 units
#pragma unroll
  for (int i = 0; i < 4; ++i) m_row[i] = -INFINITY;
  if constexpr (kPV8) {
    for (int jt = 0; jt < n_tiles; ++jt) {
      __syncthreads();
      f32_load_k8(s, k8_bh, ks_bh, k8_row, jt * kFT, tk);
      __syncthreads();
      float sc[4][4];
      f32_scores(sc, s, ty, tx, jt * kFT, tk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m_row[i] = fmaxf(m_row[i], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        m_row[i] = fmaxf(m_row[i], __shfl_xor_sync(half, m_row[i], off));
  }

  using Acc = typename std::conditional<kPV8, int, float>::type;
  Acc acc[4][4] = {};
  float l_run[4] = {0.f, 0.f, 0.f, 0.f};
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kFT;
    __syncthreads();  // the previous tile's K8, V and P are read
    f32_load_k8(s, k8_bh, ks_bh, k8_row, k0, tk);
    if constexpr (kPV8) {
      // V8^T rows (one a head dim) at positions [k0, k0 + 64): thread i
      // takes 16 positions of dim i / 4; position 16hi + 4t + e of each
      // 32-key group holds key 16hi + 8(e >> 1) + 2t + (e & 1)
      const int d = tid >> 2, part = tid & 3;
      const int4 raw =
          *reinterpret_cast<const int4*>(v8t + (bh * kD + d) * tk_pad + k0 + 16 * part);
      const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int pos = 16 * part + e, k32 = pos & 31;
        const int key = (pos & ~31) + 16 * (k32 >> 4) + 8 * ((k32 & 3) >> 1) +
                        2 * ((k32 >> 2) & 3) + (k32 & 1);
        s.v8[key][d] = bytes[e];
      }
    } else {
#pragma unroll
      for (int it = 0; it < kFT * kD / 4 / kFThreads; ++it) {
        const int i = tid + it * kFThreads;
        const int r = i / (kD / 4), d4 = (i % (kD / 4)) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < tk)
          x = *reinterpret_cast<const float4*>(v + b * v_bat + (long long)(k0 + r) * v_tok +
                                               h * v_head + 4 * d4);
        *reinterpret_cast<float4*>(&s.v[r][d4]) = x;
      }
    }
    __syncthreads();

    float sc[4][4];
    f32_scores(sc, s, ty, tx, k0, tk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kPV8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // expf of the same fp32 difference as the twin's exp: p, and so
          // its rounding to p8, is the twin's bit for bit on the card
          const float p = expf(sc[i][j] - m_row[i]);
          l_run[i] += p;
          s.p8t[4 * tx + j][4 * ty + i] = (int)(p8_word(p) & 0xffu);
        }
      } else {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(half, mx, off));
        const float m_new = fmaxf(m_row[i], mx * kLog2e);
        const float corr = ex2(m_row[i] - m_new);  // 0 on the first tile
        m_row[i] = m_new;
        l_run[i] *= corr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = ex2(fmaf(sc[i][j], kLog2e, -m_new));
          l_run[i] += p;
          s.pt[4 * tx + j][4 * ty + i] = p;
          acc[i][j] *= corr;
        }
      }
    }
    __syncthreads();

    // O += P V (qk, FFMA) or p8 V8 (qkpv, int32) for rows 4ty.., dims 4tx..
#pragma unroll 8
    for (int kk = 0; kk < kFT; ++kk) {
      if constexpr (kPV8) {
        const int4 a = *reinterpret_cast<const int4*>(&s.p8t[kk][4 * ty]);
        const int4 c = *reinterpret_cast<const int4*>(&s.v8[kk][4 * tx]);
        const int av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * cv[j];
      } else {
        const float4 a = *reinterpret_cast<const float4*>(&s.pt[kk][4 * ty]);
        const float4 c = *reinterpret_cast<const float4*>(&s.v[kk][4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
      }
    }
  }

  // each thread's sums cover its own keys: the row's sum over the half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(half, l, off);
    const int row = q0 + 4 * ty + i;
    if (row >= tq) continue;
    const float l_safe = fmaxf(l, 1e-30f);
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x;
      if constexpr (kPV8)
        x = __int2float_rn(acc[i][j]) * (kInv127 * vs[bh * kD + 4 * tx + j]);
      else
        x = acc[i][j];
      y[j] = __fdiv_rn(x, l_safe);
    }
    *reinterpret_cast<float4*>(o + (((long long)b * tq + row) * n_heads + h) * kD + 4 * tx) =
        make_float4(y[0], y[1], y[2], y[3]);
    if (tx == 0) lse[bh * tq + row] = (kPV8 ? m_row[i] : m_row[i] * kLn2) + logf(l_safe);
  }
}

// The quantize pre-pass, from bf16 or fp32 (T) K and V. Blocks [0,
// n_vblocks) (qkpv: one a (batch, head)) quantize V per column and write
// V8^T; the others stride over the (batch, key, head) rows of K (padded to
// tk_pad keys), eight threads a row, eight values (Chunk<T>) a thread.
template <typename T>
__global__ void __launch_bounds__(kPreThreads)
    int8_prepass(const uint8_t* __restrict__ k, const uint8_t* __restrict__ v,
                 int8_t* __restrict__ k8, float* __restrict__ ks, int8_t* __restrict__ v8t,
                 float* __restrict__ vs, int batch, int tk, int tk_pad, int n_heads,
                 long long k_head, long long k_tok, long long k_bat, long long v_head,
                 long long v_tok, long long v_bat, int n_vblocks) {
  __shared__ float s_red[32][kD];
  __shared__ __align__(16) int8_t s_t[kD * kBN];
  __shared__ float s_vs[kD];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < n_vblocks) {
    // ---- V of one (batch, head) ----
    const int bh = blockIdx.x, b = bh / n_heads, h = bh - b * n_heads;
    const uint8_t* vb = v + b * v_bat + h * v_head;
    {
      // each column's absmax over T: 8 dims of keys kl, kl + 32, ...
      const int sub = tid & 7, kl = tid >> 3;
      float amax[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) amax[i] = 0.f;
      for (int t = kl; t < tk; t += 32) {
        float f[8];
        Chunk<T>::load(vb + t * v_tok + sub * Chunk<T>::kBytes, f);
#pragma unroll
        for (int i = 0; i < 8; ++i) amax[i] = fmaxf(amax[i], fabsf(f[i]));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s_red[kl][sub * 8 + i] = amax[i];
    }
    __syncthreads();
    if (tid < kD) {
      float m = 0.f;
      for (int i = 0; i < 32; ++i) m = fmaxf(m, s_red[i][tid]);
      const float sc = fmaxf(m, 1e-8f) * kInv127;
      s_vs[tid] = sc;
      vs[(long)bh * kD + tid] = sc;
    }
    __syncthreads();
    // V8^T, 128 keys at a time: warp `sub` takes dims 8sub..8sub+7, lane kl
    // the logical positions 4kl..4kl+3 of the chunk, i.e. keys kbase,
    // kbase + 1, kbase + 8, kbase + 9 (V8T_KEY_ORDER), one word a dim
    const int sub = tid >> 5, kl = tid & 31;
    const int p = (4 * kl) & 31;
    const int kbase = 32 * (kl >> 3) + 16 * (p >> 4) + 2 * ((p >> 2) & 3);
    float sc[8], rs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[i] = s_vs[8 * sub + i];
      rs[i] = __frcp_rn(sc[i]);
    }
    int8_t* out = v8t + (long)bh * kD * tk_pad;
    for (int c0 = 0; c0 < tk_pad; c0 += kBN) {
      uint32_t word[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) word[j] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = c0 + kbase + 8 * (i >> 1) + (i & 1);
        if (key < tk) {
          float x[8];
          uint32_t w[8];
          Chunk<T>::load(vb + key * v_tok + sub * Chunk<T>::kBytes, x);
          quant_words<8>(w, x, sc, rs, 1);
#pragma unroll
          for (int j = 0; j < 8; ++j) word[j] |= (w[j] & 0xffu) << (8 * i);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(s_t + (8 * sub + j) * kBN + 4 * kl) = word[j];
      __syncthreads();
      for (int u = tid; u < kD * kBN / 16; u += kPreThreads) {
        const int row = u >> 3, ch = u & 7;
        *reinterpret_cast<uint4*>(out + (long)row * tk_pad + c0 + ch * 16) =
            *reinterpret_cast<const uint4*>(s_t + row * kBN + ch * 16);
      }
      __syncthreads();
    }
    return;
  }
  // ---- K rows: each warp takes eight rows at a time, 8 values a thread ----
  const long n_rows = (long)batch * tk_pad * n_heads;
  const int lane = tid & 31, sub = lane & 7;
  const long n_warps = (long)(gridDim.x - n_vblocks) * (kPreThreads / 32);
  const long warp_id = (long)(blockIdx.x - n_vblocks) * (kPreThreads / 32) + (tid >> 5);
  for (long u00 = warp_id * 8; u00 < n_rows; u00 += n_warps * 8) {
    // two rows a thread (u and u + 4), both loads in flight before either is used
    float xr[2][8];
    long us[2];
    bool real[2];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const long u = u00 + 4 * g + (lane >> 3);
      const int h = (int)(u % n_heads);
      const long rest = u / n_heads;
      const int t = (int)(rest % tk_pad), b = (int)(rest / tk_pad);
      us[g] = u;
      real[g] = u < n_rows && t < tk;
      if (real[g])
        Chunk<T>::load(k + b * k_bat + t * k_tok + h * k_head + sub * Chunk<T>::kBytes, xr[g]);
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const long u = us[g];
      const int h = (int)(u % n_heads);
      const long rest = u / n_heads;
      const int t = (int)(rest % tk_pad), b = (int)(rest / tk_pad);
      const float* x = xr[g];
      float amax = 0.f;
      if (real[g]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
      }
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 4));
      const float sc = fmaxf(amax, 1e-8f) * kInv127, rs = __frcp_rn(sc);
      if (real[g]) {
        uint32_t w[8];
        quant_words<8>(w, x, &sc, &rs, 0);
        uint2 q8;
        q8.x = pack_low_bytes(w[0], w[1], w[2], w[3]);
        q8.y = pack_low_bytes(w[4], w[5], w[6], w[7]);
        *reinterpret_cast<uint2*>(k8 + (((long)b * tk + t) * n_heads + h) * kD + sub * 8) = q8;
      }
      if (u < n_rows && sub == 0) ks[((long)b * n_heads + h) * tk_pad + t] = real[g] ? sc : 0.f;
    }
  }
}

bool encode(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank, const void* base,
            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// 4-D map (head dim 64, heads, tokens, batch) of a (B, T, H, 64) tensor
// with the given byte strides; 128-token boxes of one head, zero-filled
// past T.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, CUtensorMapSwizzle swizzle,
              const void* base, int batch, int t, int n_heads, long long head_bytes,
              long long token_bytes, long long batch_bytes) {
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)n_heads, (cuuint64_t)t,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)head_bytes, (cuuint64_t)token_bytes,
                                 (cuuint64_t)batch_bytes};
  const cuuint32_t box[4] = {kD, 1, kBN, 1};
  return encode(map, type, 4, base, dims, strides, box, swizzle);
}

}  // namespace

// q (B, Tq, H, 64), k and v (B, Tk, H, 64) bf16 (or fp32: plan[18] != 0)
// at the plan's strides -> o (B, Tq, H, 64) in their dtype, contiguous, lse
// (B, H, Tq) fp32. scratch holds the
// pre-pass's outputs: k8 (B, Tk, H, 64) int8 at byte 0, ks (B, H, tk_pad)
// fp32 at plan[15]; qkpv: V8^T (B, H, 64, tk_pad) int8 at plan[16] and vs
// (B, H, 64) fp32 at plan[17]. plan (ops/flash_attention.py `_int8_plan`):
// batch, tq, tk, heads, pv8 (!= 0: qkpv), tk_pad (a multiple of 128), the
// head, token and batch byte strides of q, k and v (multiples of 16), the
// three offsets, and fp32 (!= 0: the fp32-q form). phases: bit 0 launches the pre-pass, bit 1 the main
// kernel (3: both, in order, on `stream`). Returns the first failing
// launch's cudaError_t, or cudaErrorInvalidValue when a tensor map cannot
// be encoded.
extern "C" int kwt_flash_attention_int8(int card, const void* q, const void* k, const void* v,
                                        void* o, void* lse, void* scratch,
                                        const long long* plan, int phases, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  const int batch = static_cast<int>(plan[0]), tq = static_cast<int>(plan[1]);
  const int tk = static_cast<int>(plan[2]), n_heads = static_cast<int>(plan[3]);
  const bool pv8 = plan[4] != 0, f32 = plan[18] != 0;
  const int tk_pad = static_cast<int>(plan[5]);
  const long long* st = plan + 6;
  uint8_t* base = static_cast<uint8_t*>(scratch);
  int8_t* k8 = reinterpret_cast<int8_t*>(base);
  float* ks = reinterpret_cast<float*>(base + plan[15]);
  int8_t* v8t = reinterpret_cast<int8_t*>(base + plan[16]);
  float* vs = reinterpret_cast<float*>(base + plan[17]);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);

  // per card: its SM count, set once the kernels' shared-memory limit is
  // raised there (a function attribute holds for the current device only)
  static int n_sms_of[kwt_card::kMaxCards] = {};
  int& n_sms = n_sms_of[card];
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;  // + alignment slack
  if (n_sms == 0) {
    cudaError_t e = cudaFuncSetAttribute(flash_int8_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_int8_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, card);
    if (e != cudaSuccess) {
      n_sms = 0;  // try again on the next call
      return static_cast<int>(e);
    }
  }

  if (phases & 1) {
    const long n_rows = (long)batch * tk_pad * n_heads;
    long k_blocks = (n_rows + 31) / 32;
    if (k_blocks > 16L * n_sms) k_blocks = 16L * n_sms;
    const int n_vblocks = pv8 ? batch * n_heads : 0;
    auto prepass = f32 ? int8_prepass<float> : int8_prepass<__nv_bfloat16>;
    prepass<<<n_vblocks + static_cast<int>(k_blocks), kPreThreads, 0, cs>>>(
        static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v), k8, ks, v8t, vs, batch,
        tk, tk_pad, n_heads, st[3], st[4], st[5], st[6], st[7], st[8], n_vblocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!(phases & 2)) return static_cast<int>(cudaSuccess);

  if (f32) {
    const dim3 grid((tq + kFT - 1) / kFT, n_heads, batch);
    auto kernel = pv8 ? flash_int8_f32_kernel<true> : flash_int8_f32_kernel<false>;
    kernel<<<grid, kFThreads, sizeof(F32Smem), cs>>>(
        static_cast<const uint8_t*>(q), k8, ks, static_cast<const uint8_t*>(v), v8t, vs,
        static_cast<float*>(o), static_cast<float*>(lse), tq, tk, tk_pad, n_heads, st[0], st[1],
        st[2], st[6], st[7], st[8]);
    return static_cast<int>(cudaGetLastError());
  }

  CUtensorMap tm_q, tm_k8, tm_v;
  const long long k8_token = (long long)n_heads * kD;
  bool ok = make_map(&tm_q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B, q,
                     batch, tq, n_heads, st[0], st[1], st[2]) &&
            make_map(&tm_k8, CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_64B, k8, batch,
                     tk, n_heads, kD, k8_token, k8_token * tk);
  if (pv8) {
    // (keys, head dims, batch * heads): boxes of 128 keys x 64 dims
    const cuuint64_t dims[3] = {(cuuint64_t)tk_pad, (cuuint64_t)kD,
                                (cuuint64_t)batch * n_heads};
    const cuuint64_t strides[2] = {(cuuint64_t)tk_pad, (cuuint64_t)tk_pad * kD};
    const cuuint32_t box[3] = {kBN, kD, 1};
    ok = ok && encode(&tm_v, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, v8t, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  } else {
    ok = ok && make_map(&tm_v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_SWIZZLE_128B, v,
                        batch, tk, n_heads, st[6], st[7], st[8]);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  const int n_qtiles = (tq + kBM - 1) / kBM;
  const int n_work = n_qtiles * batch * n_heads;
  auto kernel = pv8 ? flash_int8_kernel<true> : flash_int8_kernel<false>;
  kernel<<<n_work < n_sms ? n_work : n_sms, kThreads, smem, cs>>>(
      tm_q, tm_k8, tm_v, ks, vs, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), tq,
      tk, tk_pad, n_heads, n_qtiles, n_work);
  return static_cast<int>(cudaGetLastError());
}
