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
// - int4 K and V become bf16 exactly too: a nibble XOR 8 OR-ed into 0x4300
//   (bf16 128, whose ulp is 1) is 128 + (x + 8), and one bf16x2 FMA
//   subtracts 136; a LOP3 builds nibble i and i + 4 of a word as one pair.
//   K's dims pair as (i, i + 4) of the thread's two words, and Q's A
//   fragment takes that order; V's thread row r reads word r (dims 8r ..
//   8r + 7) of four keys, a PRMT pairing two keys' nibbles. Its tiles are
//   32 bytes a key, unswizzled: the key order kappa puts a warp's four V
//   keys in distinct bank groups, and K's 8-byte loads span 256 bytes.
// - Key order: column n of an 8-key block is key kappa(n) (bits (n1 ^ n0,
//   n0, n2)), chosen with the 64-byte TMA swizzle (int8) so that the K
//   loads (16 B a lane) and the V loads (8 B a lane) of a warp hit 32
//   distinct banks; bf16 takes the 128-byte swizzle, K by 16-byte loads and
//   V by ldmatrix.trans in the same key order.
// - Scales: k_scale multiplies the fp32 score columns of its key (int4: its
//   head's bf16, copied as the aligned 4-byte word that holds it, the half
//   picked by the element's parity), v_scale
//   multiplies p before P is rounded to bf16 for the P V product (as the
//   reference folds it into w). That rounding is the one this kernel adds
//   to the fp32 twin; bf16 keeps fp32's range, where fp16 would lose p *
//   v_scale below ~6e-8.
// - Online softmax over 64-key tiles in log2 units (the running max and sum
//   per row in registers, O rescaled as FlashAttention does), so shared
//   memory holds only the copy ring and the end's merge: two CTAs an SM,
//   and no cap on beams (16 a tile; more beams take more tiles).
// - One producer warp keeps the head's K and V tiles in flight through a
//   ring of stages (8 of 8 KB in int8, 4 of 16 KB in bf16, 16 of 4 KB in
//   int4) with 3-D TMA boxes (a head's 64 columns x 64 keys x 1 group of
//   the (G, T, H*64) tensor, rows past T zero-filled), and copies the
//   tile's scales (cp.async, 4 bytes a key, zero past the CTA's keys) into
//   the fragments' column order, all counted on one mbarrier. Four consumer warps take tiles in turn, each
//   with its own running state, and merge (max, sum, O) in shared memory
//   at the end.
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
// of head h (in the map's elements: bytes for int8 and int4).
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
template <>
struct Mode<Int4> {
  static constexpr int kStages = 16, kRowBytes = 32, kHeadCols = 32;
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
  // scales in fragment column order: fp32 (int8), or (int4) the 4-byte
  // word holding the key's bf16
  float ks[kS][kKeys], vs[kS][kKeys];
  float o[kConsumerWarps][kRows][kHD];  // each warp's O, then its max and sum
  float m[kConsumerWarps][kRows], l[kConsumerWarps][kRows];
  float fo[kRows][kHD];  // the CTA's merged O, max and sum (read by the cluster)
  float fm[kRows], fl[kRows];
  uint64_t full[kS], empty[kS];
};

// Key of column n in an 8-key block, and its inverse. int4 takes keys
// n / 2 + 4 (n & 1): a warp's V loads of columns 2c (keys c) and 2c + 1
// (keys c + 4) then fall in four distinct 8-bank groups.
template <typename KV>
__device__ __forceinline__ int kappa(int n) {
  if (kIsInt4<KV>) return (n >> 1) | (n & 1) << 2;
  return ((n >> 1 & 1) | (n >> 2) << 2) ^ (3 * (n & 1));
}
template <typename KV>
__device__ __forceinline__ int kappa_inv(int key) {
  if (kIsInt4<KV>) return (key & 3) << 1 | key >> 2;
  return (key >> 1 & 1) | ((key ^ key >> 1) & 1) << 1 | (key >> 2) << 2;
}

// Byte offset within a 1024-aligned tile under the TMA swizzle: 16-byte
// chunk bits [4:5] (64-byte rows) or [4:6] (128-byte rows) XOR bits [7:..];
// int4's 32-byte rows are unswizzled.
template <typename KV>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  if (kIsInt4<KV>) return off;
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

// Nibbles j and j + 4 of w (its nibbles XOR 8), int4, as bf16x2 (nibble j
// low), exactly: (128 + x + 8) - 136.
__device__ __forceinline__ uint32_t i4x2_bf16x2(uint32_t w, int j) {
  const uint32_t x = (w >> (4 * j) & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// The bf16 of a scale word's half `hi`, as a float.
__device__ __forceinline__ float bf16_half(float word, int hi) {
  const uint32_t w = __float_as_uint(word);
  return __uint_as_float(hi ? w & 0xFFFF0000u : w << 16);
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
// dims 8r .. 8r + 7 in int8 and int4).
template <typename KV>
__device__ __forceinline__ int out_dim(int nb, int n) {
  return std::is_same<KV, __nv_bfloat16>::value ? 8 * nb + n : 8 * n + nb;
}

// KV: int8_t (fp32 (G, T) scales), Int4 (bf16 (G, T, H) scales) or
// __nv_bfloat16 (no scales).
template <typename KV>
__global__ void __launch_bounds__(kThreads, 2)
    beam_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __nv_bfloat16* __restrict__ q, long q_stride,
                const void* __restrict__ k_scale, const void* __restrict__ v_scale,
                __nv_bfloat16* __restrict__ out, int t_len, int n_heads, int beams,
                int keys_per_split) {
  constexpr bool kInt8 = kIsInt8<KV>, kInt4 = kIsInt4<KV>, kScaled = kInt8 || kInt4;
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
    const long n_scales = (long)gridDim.z * t_len * n_heads;  // int4: (G, T, H) bf16s
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kS, key0 = k_begin + i * kKeys;
      mbar_wait(&s.empty[st], ((i / kS) & 1) ^ 1);
      if (kScaled) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 2 * lane + e, slot = (key & ~7) | kappa_inv<KV>(key & 7);
          const bool in = key0 + key < k_end;
          const long at = srow + (in ? key0 + key : 0);
          if (kInt4) {
            // the aligned word holding bf16 at * H + h; its second half is
            // past the tensor only for the last element, at an even index
            const long el = at * n_heads + h, word = el & ~1L;
            const int bytes = in ? (el + 1 < n_scales || (el & 1) ? 4 : 2) : 0;
            cp_async4(&s.ks[st][slot], static_cast<const __nv_bfloat16*>(k_scale) + word, bytes);
            cp_async4(&s.vs[st][slot], static_cast<const __nv_bfloat16*>(v_scale) + word, bytes);
          } else {
            cp_async4(&s.ks[st][slot], static_cast<const float*>(k_scale) + at, in ? 4 : 0);
            cp_async4(&s.vs[st][slot], static_cast<const float*>(v_scale) + at, in ? 4 : 0);
          }
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
          // thread's 16; int4 K pairs (d, d + 4) and (d + 1, d + 5), d =
          // 8 (ks / 2) + 2 (ks % 2); bf16 K pairs them in order
          const int wi = kInt4 ? 4 * (ks >> 1) + (ks & 1) : 2 * ks;
          const uint32_t a = w[half][wi], b = w[half][kInt4 ? wi + 2 : wi + 1];
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
    // int4: the half of a scale word that holds the key's bf16 (the
    // element's parity; a tile's keys start at an even key)
    const int hi_a = (int)((((long)g * t_len + col_a) * n_heads + h) & 1);
    const int hi_b = (int)((((long)g * t_len + col_b) * n_heads + h) & 1);

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
        if (kInt4) {
          const uint2 x = lds64(kt + key * kRowBytes + 8 * c);
          const uint32_t u[2] = {x.x ^ 0x88888888u, x.y ^ 0x88888888u};
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            b[2 * ks] = i4x2_bf16x2(u[ks >> 1], 2 * (ks & 1));
            b[2 * ks + 1] = i4x2_bf16x2(u[ks >> 1], 2 * (ks & 1) + 1);
          }
        } else if (kInt8) {
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
        if (kInt4) ksc = make_float2(bf16_half(ksc.x, hi_a), bf16_half(ksc.y, hi_b));
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
          if (kInt4) vsc = make_float2(bf16_half(vsc.x, hi_a), bf16_half(vsc.y, hi_b));
          pa[j][2 * odd] = pack_bf16x2(sc[nb][0] * vsc.x, sc[nb][1] * vsc.y);
          pa[j][2 * odd + 1] = pack_bf16x2(sc[nb][2] * vsc.x, sc[nb][3] * vsc.y);
        }

      // O += P V: k-step j reduces keys 16 j + kappa(.) and 16 j + 8 + kappa(.)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bv[8][2];
        if (kInt4) {
          // word r (dims 8r .. 8r + 7) of keys of k-positions 2c, 2c + 1 (A,
          // B) and 2c + 8, 2c + 9 (C, D); a PRMT pairs A's and B's nibbles
          const int ka = 16 * j + col_a, kb = 16 * j + col_b;
          const uint32_t wa = lds32(vt + ka * kRowBytes + 4 * r);
          const uint32_t wb = lds32(vt + kb * kRowBytes + 4 * r);
          const uint32_t wc = lds32(vt + (ka + 8) * kRowBytes + 4 * r);
          const uint32_t wd = lds32(vt + (kb + 8) * kRowBytes + 4 * r);
          const uint32_t ab[2] = {__byte_perm(wa, wb, 0x5410) ^ 0x88888888u,
                                  __byte_perm(wa, wb, 0x7632) ^ 0x88888888u};
          const uint32_t cd[2] = {__byte_perm(wc, wd, 0x5410) ^ 0x88888888u,
                                  __byte_perm(wc, wd, 0x7632) ^ 0x88888888u};
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            bv[u][0] = i4x2_bf16x2(ab[u >> 2], u & 3);
            bv[u][1] = i4x2_bf16x2(cd[u >> 2], u & 3);
          }
        } else if (kInt8) {
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

// 3-D map (H*64 columns, T keys, G groups) of a (G, T, H*64) tensor (int4:
// H*32 bytes): boxes of one head's columns x kKeys keys, swizzled (int8,
// bf16), zero-filled past T.
template <typename KV>
bool make_map(CUtensorMap* map, const void* base, int groups, int t_len, int n_heads) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  constexpr int kCols = Mode<KV>::kHeadCols;
  const cuuint64_t row = (cuuint64_t)n_heads * Mode<KV>::kRowBytes;
  const cuuint64_t dims[3] = {(cuuint64_t)n_heads * kCols, (cuuint64_t)t_len, (cuuint64_t)groups};
  const cuuint64_t strides[2] = {row, row * t_len};
  const cuuint32_t box[3] = {kCols, kKeys, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const bool bf16 = std::is_same<KV, __nv_bfloat16>::value;
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                kIsInt4<KV> ? CU_TENSOR_MAP_SWIZZLE_NONE
                            : kIsInt8<KV> ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename KV>
int launch(int card, const void* q, long q_stride, const void* k, const void* v,
           const void* k_scale, const void* v_scale, void* out, int groups, int t_len,
           int n_heads, int beams, int splits, int keys_per_split, int mode, cudaStream_t stream) {
  // a beam search's cross caches (one a layer) are allocated once
  CUtensorMap tk, tv;
  if (!cached_tmap(&tk, {k, {groups, t_len, n_heads, mode, 0}},
                   [&](CUtensorMap* m) { return make_map<KV>(m, k, groups, t_len, n_heads); }) ||
      !cached_tmap(&tv, {v, {groups, t_len, n_heads, mode, 0}},
                   [&](CUtensorMap* m) { return make_map<KV>(m, v, groups, t_len, n_heads); }))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(Smem<KV>)) + 1024;  // + alignment slack
  static bool configured[kwt_card::kMaxCards] = {};
  if (!configured[card]) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[card] = true;
  }
  const int m_tiles = (beams + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, n_heads * m_tiles, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, beam_kernel<KV>, tk, tv, static_cast<const __nv_bfloat16*>(q), q_stride, k_scale,
      v_scale, static_cast<__nv_bfloat16*>(out), t_len, n_heads, beams, keys_per_split));
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
  const int m_tiles = (beams + R - 1) / R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, n_heads * m_tiles, groups);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = sizeof(F32Smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, beam_f32_kernel<KV, R>, static_cast<const float*>(q), q_stride,
      static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v), k_scale, v_scale,
      static_cast<float*>(out), t_len, n_heads, beams, keys_per_split));
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
// slot a key. The keys of each (group, head, 16-beam tile) are split over
// a cluster of `splits` CTAs of keys_per_split keys (a multiple of 64;
// ops/decode_attention.py `beam_plan`). out (G, K, H, 64) bf16. Returns the
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
      return launch<Int4>(card, q, qs, k, v, k_scale, v_scale, out, groups, t_len, n_heads,
                          beams, splits, keys_per_split, kv_mode, s);
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
