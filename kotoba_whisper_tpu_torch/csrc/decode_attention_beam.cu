// Decode-step attention of beam search's cross call (K2's beam form) for
// Hopper.
//
// Replaces: kotoba_whisper_tpu/ops/decode_attention.py
// `decode_attention_reference_beam` (:114, XLA on the TPU): the K beam
// queries of a group against the group's one shared cross-K/V row, every
// slot a key, fp32 softmax, int8 K/V with fp32 per-row scales, int4 K/V
// (packed two a byte) with bf16 per-head scales (k_scale folds into the
// scores, v_scale into the weights), or bf16 K/V.
//
// What bounds it on the card: bytes. Every K/V byte is read once for all K
// queries of its group: 12 groups x 5 beams over T=1500 keys of 20 heads
// are 46 MB in int8 (13.9 us at 3.35 TB/s) for 2 x 60 x 20 x 1500 x 64 =
// 230 M multiply-adds. The earlier form (decode_attention.cu's kernel with
// K queries a thread) spent ~130 CUDA-core instructions on each 16-byte
// chunk, kept the K*H scores of its rows in shared memory (one CTA an SM,
// at most 6 beams) and ran its K pass, softmax and V pass in series.
//
// Design: ops/decode_attention.py `beam_plan` states the grid.
// - One CTA per (group, head, 16-beam tile), so a CTA reads only its head's
//   64 columns of the group's rows and no other CTA needs its result. Where
//   that leaves SMs idle (few groups), the keys are split over a cluster of
//   up to 8 CTAs that combine over distributed shared memory.
// - Tensor cores: a head's beams are the 16 M rows of mma.sync m16n8k16
//   (bf16 in, fp32 accumulate; wgmma's 64 rows would be >= 92 % padding at
//   K=5), keys are N. Q is loaded once into A fragments; S = Q K^T, then P
//   stays in registers as the A fragment of O += P V (FlashAttention-2's
//   register layout), V the B operand.
// - int8 K and V become bf16 exactly in registers: for a byte x with low
//   seven bits m and sign bit h, x = (128 + m) - (128 + 128 h), and both
//   terms are bf16 bit patterns (0x4300 | m and 0x4300 | h << 7) that two
//   LOP3s build for two bytes at once, one bf16x2 FMA subtracting them
//   (bytes 0 and 2 of a word make one pair, bytes 1 and 3 the other). The
//   score reduction runs over the head dim, so K's dims are paired in the
//   order the bytes arrive and Q's A fragment takes the same order. P V
//   reduces over keys, so a V fragment pairs two keys' bytes of one dim: a
//   PRMT interleaves two keys' words first. Output dim 8r + n-block is
//   thread row r's (int8), so a thread reads 8 contiguous bytes of a key.
// - Key order: column n of an 8-key block is key kappa(n) (bits (n1 ^ n0,
//   n0, n2)), chosen with the 64-byte TMA swizzle (int8) so that the K
//   loads (16 B a lane) and the V loads (8 B a lane) of a warp hit 32
//   distinct banks; bf16 takes the 128-byte swizzle, K by 16-byte loads and
//   V by ldmatrix.trans in the same key order.
// - Scales: k_scale multiplies the fp32 score columns of its key, v_scale
//   multiplies p before P is rounded to bf16 for the P V product (as the
//   reference folds it into w). That rounding is the one this kernel adds
//   to the fp32 twin; bf16 keeps fp32's range, where fp16 would lose p *
//   v_scale below ~6e-8.
// - Online softmax over 64-key tiles in log2 units (the running max and sum
//   per row in registers, O rescaled as FlashAttention does), so shared
//   memory holds only the copy ring and the end's merge: two CTAs an SM,
//   and no cap on beams (16 a tile; more beams take more tiles).
// - One producer warp keeps the head's K and V tiles in flight through a
//   ring of stages (8 of 8 KB in int8, 4 of 16 KB in bf16) with 3-D TMA
//   boxes (a head's 64 columns x 64 keys x 1 group of the (G, T, H*64)
//   tensor, rows past T zero-filled), and copies the tile's scales
//   (cp.async, 4 bytes a key, zero past the CTA's keys) into the fragments'
//   column order, all counted on one mbarrier. Four consumer warps take
//   tiles in turn, each with its own running state, and merge (max, sum, O)
//   in shared memory at the end.
//
// The int4 form (`beam_int4_kernel`: bf16 q over packed int4 K/V with bf16
// per-head scales) turns the products around: keys are mma.sync's M and
// the beams its N of 8, so 5 beams fill 5 of 8 columns where they filled 5
// of 16 rows, S^T and O^T take 16 fp32 accumulators a thread each (32
// before), and the registers freed hold more consumer warps an SM
// (`kInt4Warps`, `kInt4CtasPerSm`). Per 64-key tile and warp:
// - S^T = K Q^T: four 16-key m-blocks; K's A fragment is converted from the
//   nibbles in registers (a nibble XOR 8 OR-ed into 0x4300, bf16 128 whose
//   ulp is 1, is 128 + (x + 8), and one bf16x2 FMA subtracts 136; a LOP3
//   builds nibbles i and i + 4 of a word as one pair), so K's dims pair as
//   (i, i + 4) and Q^T's B fragment, loaded once, takes that order;
// - k_scale multiplies each key's row, the online softmax runs per beam (a
//   column: the 8 lanes of a lane & 3 reduce by shuffles), v_scale
//   multiplies p before p is rounded to bf16;
// - O^T = V^T P^T: P^T's B fragment is S^T's accumulator packed to bf16
//   and transposed 8 x 8 at a time by movmatrix; V^T's A fragment pairs two
//   keys' nibbles of one dim by a PRMT, a thread's rows the dims of one
//   32-bit word of each key.
// Row p of an 8-key block is key p ^ (p >> 2), so that a warp's K loads (8
// bytes a lane) and V loads (a word of four keys) hit distinct banks. The
// scales come as the aligned 4-byte words that hold the keys' bf16s, the
// half picked by the element's parity. Beam counts above 8 take more
// tiles. The ring, the producer and the merge are the other forms'.
//
// The fp32 form (`beam_f32_kernel`: an fp32 model's beam step; fp32 q and
// output; fp32 K/V, int8 with fp32 row scales, or int4 with bf16 per-head
// scales) computes the same function with fp32 FFMAs only: mma.sync takes
// no fp32 operands (TF32 would round q and P to 10 bits), and no product is
// rounded. Its grid is its own (`beam_plan` with fp32 q): tiles of at most
// 8 beams and key shares of 32-key chunks over a cluster, four warps a CTA,
// each warp reading its chunks' K and V into registers, only the live
// beams computed (the kernel's comment has the layout).
#include <type_traits>

#include "card.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kHD = 64;            // head dim
constexpr int kKeys = 64;          // keys a tile (ops/decode_attention.py BEAM_KEY_TILE)
constexpr int kRows = 16;          // beams a tile: mma.sync's M (BEAM_ROWS)
constexpr int kConsumerWarps = 4;  // (BEAM_WARPS)
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr float kLog2e = 1.4426950408889634f;

// The K/V modes: stages of the copy ring (ops/decode_attention.py
// BEAM_STAGES), bytes of a head's 64 columns of a key, and the TMA column
// of head h (in the map's elements: bytes for int8).
template <typename KV>
struct Mode;
template <>
struct Mode<int8_t> {
  static constexpr int kStages = 8, kRowBytes = 64, kHeadCols = 64;
};
template <>
struct Mode<__nv_bfloat16> {
  static constexpr int kStages = 4, kRowBytes = 128, kHeadCols = 64;
};
template <typename KV>
constexpr bool kIsInt4 = std::is_same<KV, Int4>::value;
template <typename KV>
constexpr bool kIsInt8 = std::is_same<KV, int8_t>::value;

// ops/decode_attention.py `beam_smem_bytes` mirrors its size.
template <typename KV>
struct __align__(1024) Smem {
  static constexpr int kS = Mode<KV>::kStages;
  uint8_t k[kS][kKeys * Mode<KV>::kRowBytes];  // TMA boxes (swizzled: int8, bf16)
  uint8_t v[kS][kKeys * Mode<KV>::kRowBytes];
  float ks[kS][kKeys], vs[kS][kKeys];  // scales (int8) in fragment column order
  float o[kConsumerWarps][kRows][kHD];  // each warp's O, then its max and sum
  float m[kConsumerWarps][kRows], l[kConsumerWarps][kRows];
  float fo[kRows][kHD];  // the CTA's merged O, max and sum (read by the cluster)
  float fm[kRows], fl[kRows];
  uint64_t full[kS], empty[kS];
};

// Key of column n in an 8-key block, and its inverse.
template <typename KV>
__device__ __forceinline__ int kappa(int n) {
  return ((n >> 1 & 1) | (n >> 2) << 2) ^ (3 * (n & 1));
}
template <typename KV>
__device__ __forceinline__ int kappa_inv(int key) {
  return (key >> 1 & 1) | ((key ^ key >> 1) & 1) << 1 | (key >> 2) << 2;
}

// Byte offset within a 1024-aligned tile under the TMA swizzle: 16-byte
// chunk bits [4:5] (64-byte rows) or [4:6] (128-byte rows) XOR bits [7:..].
template <typename KV>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return kIsInt8<KV> ? off ^ ((off >> 7 & 3) << 4) : off ^ ((off >> 7 & 7) << 4);
}

// Bytes 0 and 2 of w, int8, as bf16x2 (byte 0 low), exactly.
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w) {
  const uint32_t mm = (w & 0x007F007Fu) | 0x43004300u;  // 128 + m
  const uint32_t mh = (w & 0x00800080u) | 0x43004300u;  // 128 + 128 h
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(mh), "r"(0xBF80BF80u), "r"(mm));
  return r;
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// Output dim of accumulator column n of n-block nb (V's thread row r reads
// dims 8r .. 8r + 7 in int8).
template <typename KV>
__device__ __forceinline__ int out_dim(int nb, int n) {
  return std::is_same<KV, __nv_bfloat16>::value ? 8 * nb + n : 8 * n + nb;
}

// KV: int8_t (fp32 (G, T) scales) or __nv_bfloat16 (no scales).
template <typename KV>
__global__ void __launch_bounds__(kThreads, 2)
    beam_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __nv_bfloat16* __restrict__ q, long q_stride,
                const void* __restrict__ k_scale, const void* __restrict__ v_scale,
                __nv_bfloat16* __restrict__ out, int t_len, int n_heads, int beams,
                int keys_per_split) {
  constexpr bool kInt8 = kIsInt8<KV>, kScaled = kInt8;
  constexpr int kS = Mode<KV>::kStages;
  constexpr int kRowBytes = Mode<KV>::kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  Smem<KV>& s = *reinterpret_cast<Smem<KV>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x, n_ranks = gridDim.x;
  const int h = blockIdx.y % n_heads, mt = blockIdx.y / n_heads, g = blockIdx.z;
  const int k_begin = rank * keys_per_split;
  const int k_end = min(t_len, k_begin + keys_per_split);
  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;
  const int rows = min(kRows, beams - mt * kRows);  // beams of this tile

  if (tid == 0) {
    for (int i = 0; i < kS; ++i) {
      mbar_init(&s.full[i], 33);  // the producer lanes' scale copies, and the boxes' bytes
      mbar_init(&s.empty[i], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: each tile's scales (all lanes), then its K and V boxes
    if (lane == 0) {
      prefetch_tmap(&tm_k);
      prefetch_tmap(&tm_v);
    }
    const long srow = (long)g * t_len;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kS, key0 = k_begin + i * kKeys;
      mbar_wait(&s.empty[st], ((i / kS) & 1) ^ 1);
      if (kScaled) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 2 * lane + e, slot = (key & ~7) | kappa_inv<KV>(key & 7);
          const bool in = key0 + key < k_end;
          const long at = srow + (in ? key0 + key : 0);
          cp_async4(&s.ks[st][slot], static_cast<const float*>(k_scale) + at, in ? 4 : 0);
          cp_async4(&s.vs[st][slot], static_cast<const float*>(v_scale) + at, in ? 4 : 0);
        }
      }
      cp_async_mbar_arrive_noinc(&s.full[st]);
      if (lane == 0) {
        mbar_expect_tx(&s.full[st], 2 * kKeys * kRowBytes);
        tma_load_3d(s.k[st], &tm_k, &s.full[st], h * Mode<KV>::kHeadCols, key0, g);
        tma_load_3d(s.v[st], &tm_v, &s.full[st], h * Mode<KV>::kHeadCols, key0, g);
      }
    }
  } else {
    // ---- consumers: warp w takes tiles w, w + 4, ... ------------------------
    const int r = lane >> 2, c = lane & 3;
    const bool upper = rows > 8;  // rows r + 8 hold beams
    // Q's A fragments, 4 k-steps over the head dim, in K's dim order
    uint32_t qa[4][4];
    {
      uint32_t w[2][8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r + 8 * half, beam = mt * kRows + row;
        uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
        if (row < rows) {
          const uint4* p = reinterpret_cast<const uint4*>(
              q + ((long)g * beams + beam) * q_stride + h * kHD + 16 * c);
          lo = p[0];
          hi = p[1];
        }
        const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) w[half][i] = x[i];
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          // int8 K pairs dims (4ks, 4ks + 2) and (4ks + 1, 4ks + 3) of the
          // thread's 16; bf16 K pairs them in order
          const int wi = 2 * ks;
          const uint32_t a = w[half][wi], b = w[half][wi + 1];
          qa[ks][half] = kScaled ? __byte_perm(a, b, 0x5410) : a;
          qa[ks][2 + half] = kScaled ? __byte_perm(a, b, 0x7632) : b;
        }
    }
    const float qscale = 0.125f * kLog2e;  // 1/sqrt(64), in log2 units
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    float oacc[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nb][e] = 0.f;
    const int col_a = kappa<KV>(2 * c), col_b = kappa<KV>(2 * c + 1);  // keys of columns 2c, 2c + 1

    for (int i = warp; i < n_tiles; i += kConsumerWarps) {
      const int st = i % kS, left = k_end - (k_begin + i * kKeys);  // keys of the tile in range
      mbar_wait(&s.full[st], (i / kS) & 1);
      const uint32_t kt = smem_u32(s.k[st]), vt = smem_u32(s.v[st]);

      // S = Q K^T: n-block nb, column n is key 8 nb + kappa(n)
      float sc[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int key = 8 * nb + kappa<KV>(r);
        uint32_t b[8];
        if (kInt8) {
          const uint4 x = lds128(kt + swz<KV>(key * kRowBytes + 16 * c));
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            b[2 * ks] = i8x2_bf16x2(xs[ks]);
            b[2 * ks + 1] = i8x2_bf16x2(xs[ks] >> 8);
          }
        } else {
          const uint4 x0 = lds128(kt + swz<KV>(key * kRowBytes + 32 * c));
          const uint4 x1 = lds128(kt + swz<KV>(key * kRowBytes + 32 * c + 16));
          b[0] = x0.x, b[1] = x0.y, b[2] = x0.z, b[3] = x0.w;
          b[4] = x1.x, b[5] = x1.y, b[6] = x1.z, b[7] = x1.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) mma_bf16(sc[nb], qa[ks], b[2 * ks], b[2 * ks + 1]);
      }

      // scale, mask keys past the CTA's range, running max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        float2 ksc = make_float2(1.f, 1.f);
        if (kScaled) ksc = *reinterpret_cast<const float2*>(&s.ks[st][8 * nb + 2 * c]);
        const bool in_a = 8 * nb + col_a < left, in_b = 8 * nb + col_b < left;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float& s0 = sc[nb][2 * half];
          float& s1 = sc[nb][2 * half + 1];
          s0 = in_a ? s0 * ksc.x * qscale : -INFINITY;
          s1 = in_b ? s1 * ksc.y * qscale : -INFINITY;
          mx[half] = fmaxf(mx[half], fmaxf(s0, s1));
        }
      }
      float corr[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        const float m_new = fmaxf(m_run[half], mx[half]);
        corr[half] = ex2(m_run[half] - m_new);
        m_run[half] = m_new;
      }
      // p = 2^(s - m), the row sums, P * v_scale as bf16 A fragments
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (half == 1 && !upper) {
            sc[nb][2] = sc[nb][3] = 0.f;
            continue;
          }
          sc[nb][2 * half] = ex2(sc[nb][2 * half] - m_run[half]);
          sc[nb][2 * half + 1] = ex2(sc[nb][2 * half + 1] - m_run[half]);
          sum[half] += sc[nb][2 * half] + sc[nb][2 * half + 1];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) l_run[half] = l_run[half] * corr[half] + sum[half];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        oacc[nb][0] *= corr[0];
        oacc[nb][1] *= corr[0];
        oacc[nb][2] *= corr[1];
        oacc[nb][3] *= corr[1];
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int odd = 0; odd < 2; ++odd) {
          const int nb = 2 * j + odd;
          float2 vsc = make_float2(1.f, 1.f);
          if (kScaled) vsc = *reinterpret_cast<const float2*>(&s.vs[st][8 * nb + 2 * c]);
          pa[j][2 * odd] = pack_bf16x2(sc[nb][0] * vsc.x, sc[nb][1] * vsc.y);
          pa[j][2 * odd + 1] = pack_bf16x2(sc[nb][2] * vsc.x, sc[nb][3] * vsc.y);
        }

      // O += P V: k-step j reduces keys 16 j + kappa(.) and 16 j + 8 + kappa(.)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bv[8][2];
        if (kInt8) {
          // keys of k-positions 2c, 2c + 1 (A, B) and 2c + 8, 2c + 9 (C, D)
          const int ka = 16 * j + col_a, kb = 16 * j + col_b;
          const uint2 wa = lds64(vt + swz<KV>(ka * kRowBytes + 8 * r));
          const uint2 wb = lds64(vt + swz<KV>(kb * kRowBytes + 8 * r));
          const uint2 wc = lds64(vt + swz<KV>((ka + 8) * kRowBytes + 8 * r));
          const uint2 wd = lds64(vt + swz<KV>((kb + 8) * kRowBytes + 8 * r));
          const uint32_t ab[4] = {__byte_perm(wa.x, wb.x, 0x5410), __byte_perm(wa.x, wb.x, 0x7632),
                                  __byte_perm(wa.y, wb.y, 0x5410), __byte_perm(wa.y, wb.y, 0x7632)};
          const uint32_t cd[4] = {__byte_perm(wc.x, wd.x, 0x5410), __byte_perm(wc.x, wd.x, 0x7632),
                                  __byte_perm(wc.y, wd.y, 0x5410), __byte_perm(wc.y, wd.y, 0x7632)};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            bv[2 * u][0] = i8x2_bf16x2(ab[u]);
            bv[2 * u + 1][0] = i8x2_bf16x2(ab[u] >> 8);
            bv[2 * u][1] = i8x2_bf16x2(cd[u]);
            bv[2 * u + 1][1] = i8x2_bf16x2(cd[u] >> 8);
          }
        } else {
          const int key = 16 * j + 8 * (lane >> 3 & 1) + kappa<KV>(lane & 7);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            uint32_t x[4];
            ldsm_x4_trans(x, vt + swz<KV>(key * kRowBytes + (2 * u + (lane >> 4)) * 16));
            bv[2 * u][0] = x[0];
            bv[2 * u][1] = x[1];
            bv[2 * u + 1][0] = x[2];
            bv[2 * u + 1][1] = x[3];
          }
        }
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) mma_bf16(oacc[nb], pa[j], bv[nb][0], bv[nb][1]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[st]);
    }

    // ---- this warp's state into shared memory --------------------------------
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 1);
      l_run[half] += __shfl_xor_sync(0xffffffffu, l_run[half], 2);
      if (c == 0) {
        s.m[warp][r + 8 * half] = m_run[half];
        s.l[warp][r + 8 * half] = l_run[half];
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        s.o[warp][r + 8 * half][out_dim<KV>(nb, 2 * c)] = oacc[nb][2 * half];
        s.o[warp][r + 8 * half][out_dim<KV>(nb, 2 * c + 1)] = oacc[nb][2 * half + 1];
      }
    }
    named_bar_sync(1, 32 * kConsumerWarps);
    // ---- merge the warps: thread -> (row, 8 dims) -------------------------
    const int row = tid >> 3, d0 = (tid & 7) * 8;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) mm = fmaxf(mm, s.m[w][row]);
    float ll = 0.f, o[8] = {};
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float f = s.m[w][row] == -INFINITY ? 0.f : ex2(s.m[w][row] - mm);
      ll = fmaf(f, s.l[w][row], ll);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = fmaf(f, s.o[w][row][d0 + e], o[e]);
    }
    if (n_ranks == 1) {
      if (row < rows) {
        const float inv = ll > 0.f ? 1.f / ll : 0.f;
        uint4 pk;
        pk.x = pack_bf16x2(o[0] * inv, o[1] * inv);
        pk.y = pack_bf16x2(o[2] * inv, o[3] * inv);
        pk.z = pack_bf16x2(o[4] * inv, o[5] * inv);
        pk.w = pack_bf16x2(o[6] * inv, o[7] * inv);
        *reinterpret_cast<uint4*>(
            out + (((long)g * beams + mt * kRows + row) * n_heads + h) * kHD + d0) = pk;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) s.fo[row][d0 + e] = o[e];
      if ((tid & 7) == 0) {
        s.fm[row] = mm;
        s.fl[row] = ll;
      }
    }
  }
  if (n_ranks == 1) return;

  // ---- key splits: rank 0 combines the cluster's (max, sum, O) ------------
  cluster_sync();
  if (rank == 0 && warp < kConsumerWarps) {
    const int row = tid >> 3, d0 = (tid & 7) * 8;
    if (row < rows) {
      float mm = -INFINITY;
      for (int rk = 0; rk < n_ranks; ++rk) mm = fmaxf(mm, ld_cluster(&s.fm[row], rk));
      float ll = 0.f, o[8] = {};
      for (int rk = 0; rk < n_ranks; ++rk) {
        const float m_r = ld_cluster(&s.fm[row], rk);
        const float f = m_r == -INFINITY ? 0.f : ex2(m_r - mm);
        ll = fmaf(f, ld_cluster(&s.fl[row], rk), ll);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = fmaf(f, ld_cluster(&s.fo[row][d0 + e], rk), o[e]);
      }
      const float inv = ll > 0.f ? 1.f / ll : 0.f;
      uint4 pk;
      pk.x = pack_bf16x2(o[0] * inv, o[1] * inv);
      pk.y = pack_bf16x2(o[2] * inv, o[3] * inv);
      pk.z = pack_bf16x2(o[4] * inv, o[5] * inv);
      pk.w = pack_bf16x2(o[6] * inv, o[7] * inv);
      *reinterpret_cast<uint4*>(
          out + (((long)g * beams + mt * kRows + row) * n_heads + h) * kHD + d0) = pk;
    }
  }
  cluster_sync();  // no CTA leaves while rank 0 reads its shared memory
}

// 3-D map (H*cols columns, T keys, G groups) of a (G, T, H*cols) tensor of
// `row_bytes` a head: boxes of one head's columns x kKeys keys, zero-filled
// past T.
bool encode_map(CUtensorMap* map, const void* base, int groups, int t_len, int n_heads, int cols,
                int row_bytes, CUtensorMapDataType dtype, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)n_heads * row_bytes;
  const cuuint64_t dims[3] = {(cuuint64_t)n_heads * cols, (cuuint64_t)t_len, (cuuint64_t)groups};
  const cuuint64_t strides[2] = {row, row * t_len};
  const cuuint32_t box[3] = {(cuuint32_t)cols, kKeys, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, dtype, 3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The K and V maps of a beam call, cached by address (a beam search's cross
// caches, one a layer, are allocated once).
template <typename Encode>
bool kv_maps(CUtensorMap* tk, CUtensorMap* tv, const void* k, const void* v, int groups,
             int t_len, int n_heads, int mode, Encode encode) {
  return cached_tmap(tk, {k, {groups, t_len, n_heads, mode, 0}},
                     [&](CUtensorMap* m) { return encode(m, k); }) &&
         cached_tmap(tv, {v, {groups, t_len, n_heads, mode, 0}},
                     [&](CUtensorMap* m) { return encode(m, v); });
}

// Launch `kernel` on (splits, H * m_tiles, G), the key shares of a (group,
// head, beam tile) one cluster.
template <typename... Params, typename... Args>
int launch_shares(void (*kernel)(Params...), int splits, int y, int groups, int threads, int smem,
                  cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, y, groups);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

template <typename KV>
int launch(int card, const void* q, long q_stride, const void* k, const void* v,
           const void* k_scale, const void* v_scale, void* out, int groups, int t_len,
           int n_heads, int beams, int splits, int keys_per_split, int mode, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<KV, __nv_bfloat16>::value;
  CUtensorMap tk, tv;
  if (!kv_maps(&tk, &tv, k, v, groups, t_len, n_heads, mode, [&](CUtensorMap* m, const void* x) {
        return encode_map(m, x, groups, t_len, n_heads, Mode<KV>::kHeadCols, Mode<KV>::kRowBytes,
                          kBf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                          kBf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
      }))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem<KV>)) + 1024;  // + alignment slack
  static bool configured[kwt_card::kMaxCards] = {};
  if (!configured[card]) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[card] = true;
  }
  return launch_shares(beam_kernel<KV>, splits, n_heads * ((beams + kRows - 1) / kRows), groups,
                       kThreads, smem, stream, tk, tv, static_cast<const __nv_bfloat16*>(q),
                       q_stride, k_scale, v_scale, static_cast<__nv_bfloat16*>(out), t_len,
                       n_heads, beams, keys_per_split);
}


// ---- the int4 form: keys as M ------------------------------------------------

// Consumer warps a CTA, the CTAs an SM that `__launch_bounds__` asks
// registers for (the plan's one wave), stages of the copy ring
// (ops/decode_attention.py BEAM_INT4_WARPS, BEAM_INT4_CTAS_PER_SM,
// BEAM_INT4_STAGES).
constexpr int kInt4Warps = 8, kInt4CtasPerSm = 2, kInt4Stages = 16;
constexpr int kInt4Beams = 8;      // beams a tile: mma.sync's N (BEAM_INT4_BEAMS)
constexpr int kInt4RowBytes = 32;  // a head's 64 int4 columns of a key

// ops/decode_attention.py `beam_smem_bytes` mirrors its size.
struct __align__(1024) Int4Smem {
  uint8_t k[kInt4Stages][kKeys * kInt4RowBytes];  // TMA boxes, unswizzled
  uint8_t v[kInt4Stages][kKeys * kInt4RowBytes];
  uint32_t ks[kInt4Stages][kKeys], vs[kInt4Stages][kKeys];  // the words holding each key's bf16
  float o[kInt4Warps][kInt4Beams][kHD];  // each warp's O by beam, then its max and sum
  float m[kInt4Warps][kInt4Beams], l[kInt4Warps][kInt4Beams];
  float fo[kInt4Beams][kHD];  // the CTA's merged O, max and sum (read by the cluster)
  float fm[kInt4Beams], fl[kInt4Beams];
  uint64_t full[kInt4Stages], empty[kInt4Stages];
};

// Key of row p of an 8-key block: p ^ (p >> 2), an involution. A warp's K
// loads (lanes of rows r = 0..7 read 8 bytes of key(r) each) then cover 8
// whole 32-byte rows, and its V loads (word r of the keys of rows 2c, 2c
// + 1) put keys 0, 2, 5, 7 and 1, 3, 4, 6 in four distinct 8-bank groups.
__device__ __forceinline__ int int4_key(int p) { return p ^ (p >> 2); }

// Nibbles j and j + 4 of w (its nibbles XOR 8), int4, as bf16x2 (nibble j
// low), exactly: (128 + x + 8) - 136.
__device__ __forceinline__ uint32_t i4x2_bf16x2(uint32_t w, int j) {
  const uint32_t x = (w >> (4 * j) & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// The bf16 of a scale word's half `hi`, as a float.
__device__ __forceinline__ float bf16_half(uint32_t w, int hi) {
  return __uint_as_float(hi ? w & 0xFFFF0000u : w << 16);
}

// An 8 x 8 bf16 block in an accumulator's layout (lane (r, c) holds row r,
// columns 2c, 2c + 1), transposed.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// bf16 q over packed int4 K/V, (G, T, H*32) bytes, with bf16 (G, T, H)
// scales. A CTA takes one (group, head, tile of 8 beams, key share), as
// beam_kernel does; its warps take 64-key tiles in turn.
__global__ void __launch_bounds__(32 * (kInt4Warps + 1), kInt4CtasPerSm)
    beam_int4_kernel(const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __nv_bfloat16* __restrict__ q, long q_stride,
                     const __nv_bfloat16* __restrict__ k_scale,
                     const __nv_bfloat16* __restrict__ v_scale, __nv_bfloat16* __restrict__ out,
                     int t_len, int n_heads, int beams, int keys_per_split) {
  constexpr int kWarps = kInt4Warps, kStages = kInt4Stages;
  extern __shared__ uint8_t smem_raw[];
  Int4Smem& s = *reinterpret_cast<Int4Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                              ~uintptr_t(1023));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x, n_ranks = gridDim.x;
  const int h = blockIdx.y % n_heads, mt = blockIdx.y / n_heads, g = blockIdx.z;
  const int k_begin = rank * keys_per_split;
  const int k_end = min(t_len, k_begin + keys_per_split);
  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;
  const int rows = min(kInt4Beams, beams - mt * kInt4Beams);  // beams of this tile

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 33);  // the producer lanes' scale copies, and the boxes' bytes
      mbar_init(&s.empty[i], 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer: each tile's scale words (all lanes), then its K and V boxes
    if (lane == 0) {
      prefetch_tmap(&tm_k);
      prefetch_tmap(&tm_v);
    }
    const long srow = (long)g * t_len;
    const long n_scales = (long)gridDim.z * t_len * n_heads;  // (G, T, H) bf16s
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages, key0 = k_begin + i * kKeys;
      mbar_wait(&s.empty[st], ((i / kStages) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 2 * lane + e;
        const bool in = key0 + key < k_end;
        // the aligned word holding bf16 (srow + key0 + key) * H + h; its
        // second half is past the tensor only for the last element, at an
        // even index
        const long el = (srow + (in ? key0 + key : 0)) * n_heads + h, word = el & ~1L;
        const int bytes = in ? (el + 1 < n_scales || (el & 1) ? 4 : 2) : 0;
        cp_async4(&s.ks[st][key], k_scale + word, bytes);
        cp_async4(&s.vs[st][key], v_scale + word, bytes);
      }
      cp_async_mbar_arrive_noinc(&s.full[st]);
      if (lane == 0) {
        mbar_expect_tx(&s.full[st], 2 * kKeys * kInt4RowBytes);
        tma_load_3d(s.k[st], &tm_k, &s.full[st], h * kInt4RowBytes, key0, g);
        tma_load_3d(s.v[st], &tm_v, &s.full[st], h * kInt4RowBytes, key0, g);
      }
    }
  } else {
    // ---- consumers: warp w takes tiles w, w + kWarps, ... ---------------------
    const int r = lane >> 2, c = lane & 3;
    // Q^T's B fragments, 4 k-steps over the head dim: beam r's dims in K's
    // pairing, (d, d + 4) and (d + 1, d + 5), d = 16c + 8 (ks / 2) + 2 (ks % 2)
    uint32_t qb[4][2];
    {
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (r < rows) {
        const uint4* p = reinterpret_cast<const uint4*>(
            q + ((long)g * beams + mt * kInt4Beams + r) * q_stride + h * kHD + 16 * c);
        lo = p[0];
        hi = p[1];
      }
      const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int wi = 4 * (ks >> 1) + (ks & 1);
        qb[ks][0] = __byte_perm(w[wi], w[wi + 2], 0x5410);
        qb[ks][1] = __byte_perm(w[wi], w[wi + 2], 0x7632);
      }
    }
    const float qscale = 0.125f * kLog2e;  // 1/sqrt(64), in log2 units
    // beams 2c, 2c + 1 (columns of S^T and O^T): running max and this lane's sum
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    // O^T: m-block mb, rows r / r + 8 are dims 8r + 2mb / 8r + 2mb + 1
    float oacc[4][4];
#pragma unroll
    for (int mb = 0; mb < 4; ++mb)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[mb][e] = 0.f;
    // S^T's rows r and r + 8 of m-block mb are keys 16 mb + kr and + 8; P^T's
    // k-positions 2c, 2c + 1 are keys ka, kb of its m-block (and + 8)
    const int kr = int4_key(r), ka = int4_key(2 * c), kb = int4_key(2 * c + 1);
    // the half of a scale word that holds the key's bf16 (the element's
    // parity: kr's, as a tile starts at an even key)
    const int hi_k = (int)((((long)g * t_len + kr) * n_heads + h) & 1);

    for (int i = warp; i < n_tiles; i += kWarps) {
      // keys of the tile in range
      const int st = i % kStages, left = k_end - (k_begin + i * kKeys);
      mbar_wait(&s.full[st], (i / kStages) & 1);
      const uint32_t kt = smem_u32(s.k[st]), vt = smem_u32(s.v[st]);

      // S^T = K Q^T over four 16-key m-blocks
      float sc[4][4];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        uint32_t kp[2][8];  // rows r, r + 8: dims paired as Q^T's
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const uint2 x = lds64(kt + (16 * mb + 8 * hf + kr) * kInt4RowBytes + 8 * c);
          const uint32_t u[2] = {x.x ^ 0x88888888u, x.y ^ 0x88888888u};
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            kp[hf][2 * ks] = i4x2_bf16x2(u[ks >> 1], 2 * (ks & 1));
            kp[hf][2 * ks + 1] = i4x2_bf16x2(u[ks >> 1], 2 * (ks & 1) + 1);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mb][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t a[4] = {kp[0][2 * ks], kp[1][2 * ks], kp[0][2 * ks + 1],
                                 kp[1][2 * ks + 1]};
          mma_bf16(sc[mb], a, qb[ks][0], qb[ks][1]);
        }
      }

      // scale, mask keys past the CTA's range, each beam's max over the
      // 8 lanes of its column
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = 16 * mb + 8 * hf + kr;
          const float ksc = bf16_half(s.ks[st][key], hi_k);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[mb][2 * hf + e];
            x = key < left ? x * ksc * qscale : -INFINITY;
            mx[e] = fmaxf(mx[e], x);
          }
        }
      float corr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
        const float m_new = fmaxf(m_run[e], mx[e]);
        corr[e] = ex2(m_run[e] - m_new);
        m_run[e] = m_new;
      }
      // p = 2^(s - m), the sums, P^T * v_scale as bf16 B fragments
      float sum[2] = {0.f, 0.f};
      uint32_t pb[4][2];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float vsc = bf16_half(s.vs[st][16 * mb + 8 * hf + kr], hi_k);
          const float p0 = ex2(sc[mb][2 * hf] - m_run[0]);
          const float p1 = ex2(sc[mb][2 * hf + 1] - m_run[1]);
          sum[0] += p0;
          sum[1] += p1;
          pb[mb][hf] = movmatrix_trans(pack_bf16x2(p0 * vsc, p1 * vsc));
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) l_run[e] = l_run[e] * corr[e] + sum[e];
#pragma unroll
      for (int mb = 0; mb < 4; ++mb) {
        oacc[mb][0] *= corr[0];
        oacc[mb][1] *= corr[1];
        oacc[mb][2] *= corr[0];
        oacc[mb][3] *= corr[1];
      }

      // O^T += V^T P^T: k-step j reduces the keys of m-block j; word r (dims
      // 8r .. 8r + 7) of keys ka, kb (A, B) and ka + 8, kb + 8 (C, D), a
      // PRMT pairing A's and B's nibbles
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t va = vt + (16 * j + ka) * kInt4RowBytes + 4 * r;
        const uint32_t vb = vt + (16 * j + kb) * kInt4RowBytes + 4 * r;
        const uint32_t wa = lds32(va), wb = lds32(vb);
        const uint32_t wc = lds32(va + 8 * kInt4RowBytes), wd = lds32(vb + 8 * kInt4RowBytes);
        const uint32_t ab[2] = {__byte_perm(wa, wb, 0x5410) ^ 0x88888888u,
                                __byte_perm(wa, wb, 0x7632) ^ 0x88888888u};
        const uint32_t cd[2] = {__byte_perm(wc, wd, 0x5410) ^ 0x88888888u,
                                __byte_perm(wc, wd, 0x7632) ^ 0x88888888u};
#pragma unroll
        for (int mb = 0; mb < 4; ++mb) {
          const int u0 = 2 * mb, u1 = 2 * mb + 1;  // dims 8r + u0 (row r), 8r + u1 (row r + 8)
          const uint32_t a[4] = {i4x2_bf16x2(ab[u0 >> 2], u0 & 3), i4x2_bf16x2(ab[u1 >> 2], u1 & 3),
                                 i4x2_bf16x2(cd[u0 >> 2], u0 & 3), i4x2_bf16x2(cd[u1 >> 2], u1 & 3)};
          mma_bf16(oacc[mb], a, pb[j][0], pb[j][1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&s.empty[st]);
    }

    // ---- this warp's state into shared memory: beams 2c + e, dims 8r .. 8r + 7
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l_run[e] += __shfl_xor_sync(0xffffffffu, l_run[e], off);
      if (r == 0) {
        s.m[warp][2 * c + e] = m_run[e];
        s.l[warp][2 * c + e] = l_run[e];
      }
      float* o = &s.o[warp][2 * c + e][8 * r];
      *reinterpret_cast<float4*>(o) =
          make_float4(oacc[0][e], oacc[0][2 + e], oacc[1][e], oacc[1][2 + e]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(oacc[2][e], oacc[2][2 + e], oacc[3][e], oacc[3][2 + e]);
    }
    named_bar_sync(1, 32 * kWarps);
    // ---- merge the warps: threads 0..63 -> (beam, 8 dims) ----------------------
    const int row = tid >> 3, d0 = (tid & 7) * 8;
    if (tid < 8 * kInt4Beams) {
      float mm = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, s.m[w][row]);
      float ll = 0.f, o[8] = {};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = s.m[w][row] == -INFINITY ? 0.f : ex2(s.m[w][row] - mm);
        ll = fmaf(f, s.l[w][row], ll);
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = fmaf(f, s.o[w][row][d0 + e], o[e]);
      }
      if (n_ranks == 1) {
        if (row < rows) {
          const float inv = ll > 0.f ? 1.f / ll : 0.f;
          uint4 pk;
          pk.x = pack_bf16x2(o[0] * inv, o[1] * inv);
          pk.y = pack_bf16x2(o[2] * inv, o[3] * inv);
          pk.z = pack_bf16x2(o[4] * inv, o[5] * inv);
          pk.w = pack_bf16x2(o[6] * inv, o[7] * inv);
          *reinterpret_cast<uint4*>(
              out + (((long)g * beams + mt * kInt4Beams + row) * n_heads + h) * kHD + d0) = pk;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) s.fo[row][d0 + e] = o[e];
        if ((tid & 7) == 0) {
          s.fm[row] = mm;
          s.fl[row] = ll;
        }
      }
    }
  }
  if (n_ranks == 1) return;

  // ---- key splits: rank 0 combines the cluster's (max, sum, O) ------------
  cluster_sync();
  const int row = tid >> 3, d0 = (tid & 7) * 8;
  if (rank == 0 && tid < 8 * kInt4Beams && row < rows) {
    float mm = -INFINITY;
    for (int rk = 0; rk < n_ranks; ++rk) mm = fmaxf(mm, ld_cluster(&s.fm[row], rk));
    float ll = 0.f, o[8] = {};
    for (int rk = 0; rk < n_ranks; ++rk) {
      const float m_r = ld_cluster(&s.fm[row], rk);
      const float f = m_r == -INFINITY ? 0.f : ex2(m_r - mm);
      ll = fmaf(f, ld_cluster(&s.fl[row], rk), ll);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = fmaf(f, ld_cluster(&s.fo[row][d0 + e], rk), o[e]);
    }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    uint4 pk;
    pk.x = pack_bf16x2(o[0] * inv, o[1] * inv);
    pk.y = pack_bf16x2(o[2] * inv, o[3] * inv);
    pk.z = pack_bf16x2(o[4] * inv, o[5] * inv);
    pk.w = pack_bf16x2(o[6] * inv, o[7] * inv);
    *reinterpret_cast<uint4*>(
        out + (((long)g * beams + mt * kInt4Beams + row) * n_heads + h) * kHD + d0) = pk;
  }
  cluster_sync();  // no CTA leaves while rank 0 reads its shared memory
}

int launch_int4(int card, const void* q, long q_stride, const void* k, const void* v,
                const void* k_scale, const void* v_scale, void* out, int groups, int t_len,
                int n_heads, int beams, int splits, int keys_per_split, int mode,
                cudaStream_t stream) {
  const auto kernel = &beam_int4_kernel;
  CUtensorMap tk, tv;
  if (!kv_maps(&tk, &tv, k, v, groups, t_len, n_heads, mode, [&](CUtensorMap* m, const void* x) {
        return encode_map(m, x, groups, t_len, n_heads, kInt4RowBytes, kInt4RowBytes,
                          CU_TENSOR_MAP_DATA_TYPE_UINT8, CU_TENSOR_MAP_SWIZZLE_NONE);
      }))
    return static_cast<int>(cudaErrorInvalidValue);
  // + alignment slack
  const int smem = static_cast<int>(sizeof(Int4Smem)) + 1024;
  static bool configured[kwt_card::kMaxCards] = {};
  if (!configured[card]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[card] = true;
  }
  return launch_shares(kernel, splits, n_heads * ((beams + kInt4Beams - 1) / kInt4Beams), groups,
                       32 * (kInt4Warps + 1), smem, stream, tk, tv,
                       static_cast<const __nv_bfloat16*>(q), q_stride,
                       static_cast<const __nv_bfloat16*>(k_scale),
                       static_cast<const __nv_bfloat16*>(v_scale),
                       static_cast<__nv_bfloat16*>(out), t_len, n_heads, beams, keys_per_split);
}


// ---- the fp32 form ---------------------------------------------------------

constexpr int kF32MaxRows = 8;  // most beams a tile (ops/decode_attention.py BEAM_F32_ROWS)
constexpr int kF32Chunk = 32;   // keys a warp takes at a time, one a lane (BEAM_F32_CHUNK)
constexpr int kF32Warps = 4;    // warps a CTA, taking the chunks in turn (BEAM_F32_WARPS)
constexpr int kF32Threads = 32 * kF32Warps;

// The fp32 form's K/V modes: bytes of a head's row of a key, and the CTAs
// an SM its registers allow, `__launch_bounds__`'s minimum (168 registers a
// thread over fp32 K/V, 128 else; ops/decode_attention.py
// BEAM_F32_CTAS_PER_SM, which sizes the grid's one wave).
template <typename KV>
struct F32Mode;
template <>
struct F32Mode<float> {
  static constexpr int kRowBytes = 256, kCtasPerSm = 3;
};
template <>
struct F32Mode<int8_t> {
  static constexpr int kRowBytes = 64, kCtasPerSm = 4;
};
template <>
struct F32Mode<Int4> {
  static constexpr int kRowBytes = 32, kCtasPerSm = 4;
};

// ops/decode_attention.py `beam_smem_bytes` mirrors its size (q_dtype fp32).
struct __align__(16) F32Smem {
  float q[kF32MaxRows][kHD];                   // the tile's beams' q, times log2(e) / 8
  float p[kF32Warps][kF32MaxRows][kF32Chunk];  // each warp's P * v_scale of its chunk
  float o[kF32Warps][kF32MaxRows][kHD];        // each warp's O, max and sum
  float m[kF32Warps][kF32MaxRows], l[kF32Warps][kF32MaxRows];
  float fo[kF32MaxRows][kHD];  // the CTA's merged O, max and sum (read by the cluster)
  float fm[kF32MaxRows], fl[kF32MaxRows];
};

// Four dims as floats, exactly (as Chunk widens them): the four bytes of
// an int8 word, or the low four nibbles of an int4 one.
__device__ __forceinline__ float4 floats4(uint32_t w, int8_t) {
  w ^= 0x80808080u;
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[j] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ float4 floats4(uint32_t w, Int4) {
  w ^= 0x8888u;
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = __int_as_float(0x4B000000u | (w >> (4 * j) & 0xFu)) - 8388616.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// Dims 4i .. 4i + 3 of a K row held as 32-bit words, as floats.
__device__ __forceinline__ float4 k_floats(const uint32_t* w, int i, float) {
  return make_float4(__uint_as_float(w[4 * i]), __uint_as_float(w[4 * i + 1]),
                     __uint_as_float(w[4 * i + 2]), __uint_as_float(w[4 * i + 3]));
}
__device__ __forceinline__ float4 k_floats(const uint32_t* w, int i, int8_t) {
  return floats4(w[i], int8_t());
}
__device__ __forceinline__ float4 k_floats(const uint32_t* w, int i, Int4) {
  return floats4(w[i >> 1] >> (16 * (i & 1)), Int4());
}

// Dims 4d .. 4d + 3 of a key's head row as the raw word that holds them
// (int8: 4 bytes; int4: 2 bytes).
__device__ __forceinline__ uint32_t v_word(const uint8_t* row, int d, int8_t) {
  return __ldg(reinterpret_cast<const unsigned int*>(row) + d);
}
__device__ __forceinline__ uint32_t v_word(const uint8_t* row, int d, Int4) {
  return __ldg(reinterpret_cast<const unsigned short*>(row) + d);
}

// The scale of key `at` (its (G, T) index): fp32 (G, T) per row (int8), or
// its head's bf16 of (G, T, H) (int4).
template <typename KV>
__device__ __forceinline__ float key_scale(const void* scale, long at, int n_heads, int h) {
  if (kIsInt4<KV>) {
    const unsigned short x = __ldg(static_cast<const unsigned short*>(scale) + at * n_heads + h);
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  return __ldg(static_cast<const float*>(scale) + at);
}

// KV: float (no scales), int8_t (fp32 (G, T) scales) or Int4 (bf16 (G, T,
// H) scales); R beams a tile. q and out fp32. Every product an fp32 FFMA.
//
// A CTA takes one (group, head, tile of R beams, key share):
// ops/decode_attention.py `beam_plan` gives the fp32 form tiles of R =
// ceil(K / ceil(K / 8)) beams (only those computed: 5 at beam search's K),
// key shares of whole 32-key chunks over a cluster of up to MAX_CLUSTER
// CTAs, and four warps a CTA, as many CTAs as one wave of four an SM holds.
// Warp w takes chunks w, w + 4, ... of its share with a running state (max
// and sum a beam, O) of its own, and reads K and V from device memory into
// registers, each chunk's loads issued while the chunk before is computed
// (int8 and int4: K and V; fp32: K, its V read where it is used):
// - scores: lane i takes key i of the chunk, its head row widened exactly
//   four dims at a time against each beam's q (broadcast from shared
//   memory), four partial sums a beam; times k_scale; keys past the share
//   are -inf;
// - the warp's online softmax a beam in log2 units (a warp max, ex2), each
//   lane's sum of its own keys, P * v_scale into the warp's slice of shared
//   memory;
// - O += P V: lane (d, half) takes dims 4d .. 4d + 3 of the chunk's keys
//   16 half .. 16 half + 15 against every beam's p.
// Then the two key halves of each warp's O are summed over a shuffle, the
// warps' states merged in shared memory and the shares' over the cluster,
// as the bf16 form merges them.
template <typename KV, int R>
__global__ void __launch_bounds__(kF32Threads, F32Mode<KV>::kCtasPerSm)
    beam_f32_kernel(const float* __restrict__ q, long q_stride, const uint8_t* __restrict__ k,
                    const uint8_t* __restrict__ v, const void* __restrict__ k_scale,
                    const void* __restrict__ v_scale, float* __restrict__ out, int t_len,
                    int n_heads, int beams, int keys_per_split) {
  constexpr bool kF32 = std::is_same<KV, float>::value, kScaled = !kF32;
  constexpr int kRow = F32Mode<KV>::kRowBytes;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  F32Smem& s = *reinterpret_cast<F32Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x, n_ranks = gridDim.x;
  const int h = blockIdx.y % n_heads, mt = blockIdx.y / n_heads, g = blockIdx.z;
  const int k_begin = rank * keys_per_split;
  const int k_end = min(t_len, k_begin + keys_per_split);
  const int n_chunks = (k_end - k_begin + kF32Chunk - 1) / kF32Chunk;
  const int rows = min(R, beams - mt * R);  // beams of this tile
  const long row_bytes = (long)n_heads * kRow;
  const uint8_t* kg = k + (long)g * t_len * row_bytes + (long)h * kRow;
  const uint8_t* vg = v + (long)g * t_len * row_bytes + (long)h * kRow;
  const long srow = (long)g * t_len;  // the group's first scale
  const int dq = lane & 15, half = lane >> 4;  // P V: dims 4dq .., keys 16 half ..

  // chunk c's K row of this lane's key (an out-of-share lane reads the
  // chunk's first key) and its scales, and (int8, int4) its V words: each
  // in flight while the chunk before is computed (K from the end of that
  // chunk's scores, V from the end of its P V)
  uint32_t kw[kRow / 4];
  uint32_t vw[16];
  float ksc = 1.f, vsc = 1.f;
  auto fetch_k = [&](int c) {
    const int key0 = k_begin + c * kF32Chunk, left = k_end - key0;
    const long at = lane < left ? key0 + lane : key0;
    const uint4* krow = reinterpret_cast<const uint4*>(kg + at * row_bytes);
#pragma unroll
    for (int u = 0; u < kRow / 16; ++u) {
      const uint4 w = __ldg(krow + u);
      kw[4 * u] = w.x, kw[4 * u + 1] = w.y, kw[4 * u + 2] = w.z, kw[4 * u + 3] = w.w;
    }
    if constexpr (kScaled) {
      ksc = key_scale<KV>(k_scale, srow + at, n_heads, h);
      vsc = key_scale<KV>(v_scale, srow + at, n_heads, h);
    }
  };
  auto fetch_v = [&](int c) {
    if constexpr (kScaled) {
      const int key0 = k_begin + c * kF32Chunk, left = k_end - key0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int jj = 16 * half + j;
        vw[j] = v_word(vg + (jj < left ? key0 + jj : key0) * row_bytes, dq, KV());
      }
    }
  };
  if (warp < n_chunks) {
    fetch_k(warp);
    fetch_v(warp);
  }

  // the tile's beams' q, times 1/sqrt(64) * log2(e); zero rows past the beams
  const float qscale = 0.125f * kLog2e;
  for (int x = tid; x < R * kHD; x += kF32Threads) {
    const int r = x / kHD, dd = x % kHD;
    s.q[r][dd] = r < rows ? q[((long)g * beams + mt * R + r) * q_stride + h * kHD + dd] * qscale
                          : 0.f;
  }
  __syncthreads();

  float m_run[R], l_run[R], o[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
    o[r][0] = o[r][1] = o[r][2] = o[r][3] = 0.f;
  }
  for (int c = warp; c < n_chunks; c += kF32Warps) {
    const int key0 = k_begin + c * kF32Chunk;
    const int left = k_end - key0;  // keys of the chunk in the share
    const bool in = lane < left;
    const float ksc_c = ksc, vsc_c = vsc;

    // ---- scores of this lane's key against each beam ----
    float4 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int d4 = 0; d4 < kHD / 4; ++d4) {
      const float4 x = k_floats(kw, d4, KV());
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&s.q[r][4 * d4]);
        acc[r].x = fmaf(qv.x, x.x, acc[r].x);
        acc[r].y = fmaf(qv.y, x.y, acc[r].y);
        acc[r].z = fmaf(qv.z, x.z, acc[r].z);
        acc[r].w = fmaf(qv.w, x.w, acc[r].w);
      }
    }
    // the warp's next chunk's K in flight from here
    const bool more = c + kF32Warps < n_chunks;
    if (more) fetch_k(c + kF32Warps);

    // ---- the warp's online softmax a beam ----
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sc = in ? ((acc[r].x + acc[r].y) + (acc[r].z + acc[r].w)) * ksc_c : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // no key seen yet
      const float corr = ex2(m_run[r] - base);
      const float p = ex2(sc - base);
      m_run[r] = m_new;
      l_run[r] = fmaf(l_run[r], corr, p);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[r][e] *= corr;
      s.p[warp][r][lane] = p * vsc_c;
    }
    __syncwarp();

    // ---- O += P V: keys 16 half .. 16 half + 15, four at a time ----
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
      const int j0 = 16 * half + 4 * j4;
      float4 vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kF32) {
          const long key = j0 + j < left ? key0 + j0 + j : key0;  // p is 0 past the share
          vv[j] = __ldg(reinterpret_cast<const float4*>(vg + key * row_bytes) + dq);
        } else {
          vv[j] = floats4(vw[4 * j4 + j], KV());
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(&s.p[warp][r][j0]);
        const float pj[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[r][0] = fmaf(pj[j], vv[j].x, o[r][0]);
          o[r][1] = fmaf(pj[j], vv[j].y, o[r][1]);
          o[r][2] = fmaf(pj[j], vv[j].z, o[r][2]);
          o[r][3] = fmaf(pj[j], vv[j].w, o[r][3]);
        }
      }
    }
    if (more) fetch_v(c + kF32Warps);
    __syncwarp();  // the warp's P is read before the next chunk's
  }

  // ---- this warp's state into shared memory, then the warps merged --------
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float l = l_run[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    float4 x = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
    x.x += __shfl_xor_sync(0xffffffffu, x.x, 16);
    x.y += __shfl_xor_sync(0xffffffffu, x.y, 16);
    x.z += __shfl_xor_sync(0xffffffffu, x.z, 16);
    x.w += __shfl_xor_sync(0xffffffffu, x.w, 16);
    if (lane == 0) {
      s.m[warp][r] = m_run[r];
      s.l[warp][r] = l;
    }
    if (half == 0) *reinterpret_cast<float4*>(&s.o[warp][r][4 * dq]) = x;
  }
  __syncthreads();
  // thread -> (beam, 4 dims); threads past the tile's R rows only keep the
  // cluster barriers company (they are warp-aligned)
  const int row = tid >> 4, d0 = (tid & 15) * 4;
  const bool active = row < R;
  float mm = -INFINITY, ll = 0.f, acc[4] = {};
  if (active) {
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) mm = fmaxf(mm, s.m[w][row]);
#pragma unroll
    for (int w = 0; w < kF32Warps; ++w) {
      const float f = s.m[w][row] == -INFINITY ? 0.f : ex2(s.m[w][row] - mm);
      ll = fmaf(f, s.l[w][row], ll);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(f, s.o[w][row][d0 + e], acc[e]);
    }
  }
  float* dst = out + (((long)g * beams + mt * R + row) * n_heads + h) * kHD + d0;
  if (n_ranks == 1) {
    if (row < rows) {
      const float inv = ll > 0.f ? 1.f / ll : 0.f;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
    }
    return;
  }
  if (active) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s.fo[row][d0 + e] = acc[e];
    if ((tid & 15) == 0) {
      s.fm[row] = mm;
      s.fl[row] = ll;
    }
  }
  // ---- key splits: rank 0 combines the cluster's (max, sum, O) ------------
  cluster_sync();
  if (rank == 0 && row < rows) {
    float mx = -INFINITY;
    for (int rk = 0; rk < n_ranks; ++rk) mx = fmaxf(mx, ld_cluster(&s.fm[row], rk));
    float lt = 0.f, ot[4] = {};
    for (int rk = 0; rk < n_ranks; ++rk) {
      const float m_r = ld_cluster(&s.fm[row], rk);
      const float f = m_r == -INFINITY ? 0.f : ex2(m_r - mx);
      lt = fmaf(f, ld_cluster(&s.fl[row], rk), lt);
#pragma unroll
      for (int e = 0; e < 4; ++e) ot[e] = fmaf(f, ld_cluster(&s.fo[row][d0 + e], rk), ot[e]);
    }
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    *reinterpret_cast<float4*>(dst) = make_float4(ot[0] * inv, ot[1] * inv, ot[2] * inv, ot[3] * inv);
  }
  cluster_sync();  // no CTA leaves while rank 0 reads its shared memory
}

// Beams a tile of the fp32 form (ops/decode_attention.py `beam_f32_rows`):
// ceil(K / ceil(K / 8)), so that the tiles are as even as they can be.
inline int f32_rows(int beams) {
  const int m_tiles = (beams + kF32MaxRows - 1) / kF32MaxRows;
  return (beams + m_tiles - 1) / m_tiles;
}

template <typename KV, int R>
int launch_f32_rows(const void* q, long q_stride, const void* k, const void* v,
                    const void* k_scale, const void* v_scale, void* out, int groups, int t_len,
                    int n_heads, int beams, int splits, int keys_per_split, cudaStream_t stream) {
  return launch_shares(beam_f32_kernel<KV, R>, splits, n_heads * ((beams + R - 1) / R), groups,
                       kF32Threads, static_cast<int>(sizeof(F32Smem)), stream,
                       static_cast<const float*>(q), q_stride, static_cast<const uint8_t*>(k),
                       static_cast<const uint8_t*>(v), k_scale, v_scale, static_cast<float*>(out),
                       t_len, n_heads, beams, keys_per_split);
}

template <typename KV>
int launch_f32(const void* q, long q_stride, const void* k, const void* v, const void* k_scale,
               const void* v_scale, void* out, int groups, int t_len, int n_heads, int beams,
               int splits, int keys_per_split, cudaStream_t stream) {
#define KWT_BEAM_F32_ROWS(R)                                                                   \
  case R:                                                                                      \
    return launch_f32_rows<KV, R>(q, q_stride, k, v, k_scale, v_scale, out, groups, t_len,    \
                                  n_heads, beams, splits, keys_per_split, stream);
  switch (f32_rows(beams)) {
    KWT_BEAM_F32_ROWS(1)
    KWT_BEAM_F32_ROWS(2)
    KWT_BEAM_F32_ROWS(3)
    KWT_BEAM_F32_ROWS(4)
    KWT_BEAM_F32_ROWS(5)
    KWT_BEAM_F32_ROWS(6)
    KWT_BEAM_F32_ROWS(7)
    KWT_BEAM_F32_ROWS(8)
  }
#undef KWT_BEAM_F32_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (G, K, H, 64) bf16, its G*K rows q_stride elements apart (a row of a
// fused projection is read in place), each row's heads contiguous; k/v
// (G, T, H*64) by kv_mode (ops/decode_attention.py KV_*): 0 bf16; 1 int8
// with fp32 (G, T) scales; 3 int4 packed two a byte, (G, T, H*32) bytes,
// with bf16 (G, T, H) scales, 4-byte aligned (mode 2 is refused); every
// slot a key. The keys of each (group, head, beam tile: 16 beams, int4's
// 8) are split over a cluster of `splits` CTAs of keys_per_split keys (a
// multiple of 64; ops/decode_attention.py `beam_plan`). out (G, K, H, 64) bf16. Returns the
// launch's cudaError_t, or cudaErrorInvalidValue for a mode it lacks or
// when a tensor map cannot be encoded.
extern "C" int kwt_decode_attention_beam(int card, const void* q, long long q_stride,
                                         const void* k, const void* v, const void* k_scale,
                                         const void* v_scale, void* out, int groups, int t_len,
                                         int n_heads, int beams, int splits, int keys_per_split,
                                         int kv_mode, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long qs = (long)q_stride;
  switch (kv_mode) {
    case 0:
      return launch<__nv_bfloat16>(card, q, qs, k, v, k_scale, v_scale, out, groups, t_len,
                                   n_heads, beams, splits, keys_per_split, kv_mode, s);
    case 1:
      return launch<int8_t>(card, q, qs, k, v, k_scale, v_scale, out, groups, t_len, n_heads,
                            beams, splits, keys_per_split, kv_mode, s);
    case 3:
      return launch_int4(card, q, qs, k, v, k_scale, v_scale, out, groups, t_len, n_heads, beams,
                         splits, keys_per_split, kv_mode, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fp32 form: q (G, K, H, 64) fp32, rows q_stride elements apart; k/v
// (G, T, H*64) by kv_mode: 4 fp32; 1 int8 with fp32 (G, T) scales; 3 int4
// packed two a byte with bf16 (G, T, H) scales, 4-byte aligned; the grid
// of `beam_plan` (splits, keys_per_split). out (G, K, H, 64) fp32. Returns
// the launch's cudaError_t (cudaErrorInvalidValue for a mode it lacks).
extern "C" int kwt_decode_attention_beam_f32(int card, const void* q, long long q_stride,
                                             const void* k, const void* v, const void* k_scale,
                                             const void* v_scale, void* out, int groups,
                                             int t_len, int n_heads, int beams, int splits,
                                             int keys_per_split, int kv_mode, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long qs = (long)q_stride;
  switch (kv_mode) {
    case 1:
      return launch_f32<int8_t>(q, qs, k, v, k_scale, v_scale, out, groups, t_len, n_heads,
                                beams, splits, keys_per_split, s);
    case 3:
      return launch_f32<Int4>(q, qs, k, v, k_scale, v_scale, out, groups, t_len, n_heads,
                              beams, splits, keys_per_split, s);
    case 4:
      return launch_f32<float>(q, qs, k, v, k_scale, v_scale, out, groups, t_len, n_heads,
                               beams, splits, keys_per_split, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
