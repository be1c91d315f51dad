// Decode-step attention of beam search's cross call (K2's beam form) for
// Hopper.
//
// Replaces: kotoba_whisper_tpu/ops/decode_attention.py
// `decode_attention_reference_beam` (:114, XLA on the TPU): the K beam
// queries of a group against the group's one shared cross-K/V row, every
// slot a key, fp32 softmax, int8 K/V with fp32 per-row scales (k_scale folds
// into the scores, v_scale into the weights) or bf16 K/V.
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
//   boxes (64 columns x 64 keys x 1 group of the (G, T, H*64) tensor, rows
//   past T zero-filled), and copies the tile's scales (cp.async, 4 bytes a
//   key, zero past the CTA's keys) into the fragments' column order, all
//   counted on one mbarrier. Four consumer warps take tiles in turn, each
//   with its own running state, and merge (max, sum, O) in shared memory
//   at the end.
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

template <typename KV>
struct Stages;
template <>
struct Stages<int8_t> {
  static constexpr int n = 8;
};
template <>
struct Stages<__nv_bfloat16> {
  static constexpr int n = 4;
};

// ops/decode_attention.py `beam_smem_bytes` mirrors its size.
template <typename KV>
struct __align__(1024) Smem {
  static constexpr int kS = Stages<KV>::n;
  KV k[kS][kKeys * kHD];  // swizzled TMA boxes
  KV v[kS][kKeys * kHD];
  float ks[kS][kKeys], vs[kS][kKeys];  // int8 scales, in fragment column order
  float o[kConsumerWarps][kRows][kHD];  // each warp's O, then its max and sum
  float m[kConsumerWarps][kRows], l[kConsumerWarps][kRows];
  float fo[kRows][kHD];  // the CTA's merged O, max and sum (read by the cluster)
  float fm[kRows], fl[kRows];
  uint64_t full[kS], empty[kS];
};

// Key of column n in an 8-key block, and its inverse.
__device__ __forceinline__ int kappa(int n) { return ((n >> 1 & 1) | (n >> 2) << 2) ^ (3 * (n & 1)); }
__device__ __forceinline__ int kappa_inv(int key) {
  return (key >> 1 & 1) | ((key ^ key >> 1) & 1) << 1 | (key >> 2) << 2;
}

// Byte offset within a 1024-aligned tile under the TMA swizzle: 16-byte
// chunk bits [4:5] (64-byte rows) or [4:6] (128-byte rows) XOR bits [7:..].
template <typename KV>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return sizeof(KV) == 1 ? off ^ ((off >> 7 & 3) << 4) : off ^ ((off >> 7 & 7) << 4);
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
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// Output dim of accumulator column n of n-block nb.
template <typename KV>
__device__ __forceinline__ int out_dim(int nb, int n) {
  return sizeof(KV) == 1 ? 8 * n + nb : 8 * nb + n;
}

template <typename KV>
__global__ void __launch_bounds__(kThreads, 2)
    beam_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __nv_bfloat16* __restrict__ q, long q_stride,
                const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                __nv_bfloat16* __restrict__ out, int t_len, int n_heads, int beams,
                int keys_per_split) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  constexpr int kS = Stages<KV>::n;
  constexpr int kRowBytes = kHD * (int)sizeof(KV);
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
      if (kInt8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 2 * lane + e, slot = (key & ~7) | kappa_inv(key & 7);
          const bool in = key0 + key < k_end;
          const long at = srow + (in ? key0 + key : 0);
          cp_async4(&s.ks[st][slot], k_scale + at, in ? 4 : 0);
          cp_async4(&s.vs[st][slot], v_scale + at, in ? 4 : 0);
        }
      }
      cp_async_mbar_arrive_noinc(&s.full[st]);
      if (lane == 0) {
        mbar_expect_tx(&s.full[st], 2 * kKeys * kRowBytes);
        tma_load_3d(s.k[st], &tm_k, &s.full[st], h * kHD, key0, g);
        tma_load_3d(s.v[st], &tm_v, &s.full[st], h * kHD, key0, g);
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
          const uint32_t a = w[half][2 * ks], b = w[half][2 * ks + 1];
          // int8 K pairs dims (4ks, 4ks + 2) and (4ks + 1, 4ks + 3) of the
          // thread's 16; bf16 K pairs them in order
          qa[ks][half] = kInt8 ? __byte_perm(a, b, 0x5410) : a;
          qa[ks][2 + half] = kInt8 ? __byte_perm(a, b, 0x7632) : b;
        }
    }
    const float qscale = 0.125f * kLog2e;  // 1/sqrt(64), in log2 units
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    float oacc[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[nb][e] = 0.f;
    const int col_a = kappa(2 * c), col_b = kappa(2 * c + 1);  // keys of columns 2c, 2c + 1

    for (int i = warp; i < n_tiles; i += kConsumerWarps) {
      const int st = i % kS, left = k_end - (k_begin + i * kKeys);  // keys of the tile in range
      mbar_wait(&s.full[st], (i / kS) & 1);
      const uint32_t kt = smem_u32(s.k[st]), vt = smem_u32(s.v[st]);

      // S = Q K^T: n-block nb, column n is key 8 nb + kappa(n)
      float sc[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int key = 8 * nb + kappa(r);
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
        if (kInt8) ksc = *reinterpret_cast<const float2*>(&s.ks[st][8 * nb + 2 * c]);
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
          if (kInt8) vsc = *reinterpret_cast<const float2*>(&s.vs[st][8 * nb + 2 * c]);
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
          const int key = 16 * j + 8 * (lane >> 3 & 1) + kappa(lane & 7);
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

// 3-D map (H*64 columns, T keys, G groups) of a (G, T, H*64) tensor: boxes
// of one head's 64 columns x kKeys keys, swizzled, zero-filled past T.
template <typename KV>
bool make_map(CUtensorMap* map, const void* base, int groups, int t_len, int n_heads) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)n_heads * kHD * sizeof(KV);
  const cuuint64_t dims[3] = {(cuuint64_t)n_heads * kHD, (cuuint64_t)t_len, (cuuint64_t)groups};
  const cuuint64_t strides[2] = {row, row * t_len};
  const cuuint32_t box[3] = {kHD, kKeys, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, sizeof(KV) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                sizeof(KV) == 1 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename KV>
int launch(int card, const void* q, long q_stride, const void* k, const void* v,
           const void* k_scale, const void* v_scale, void* out, int groups, int t_len,
           int n_heads, int beams, int splits, int keys_per_split, cudaStream_t stream) {
  // a beam search's cross caches (one a layer) are allocated once
  CUtensorMap tk, tv;
  const int i8 = sizeof(KV) == 1;
  if (!cached_tmap(&tk, {k, {groups, t_len, n_heads, i8, 0}},
                   [&](CUtensorMap* m) { return make_map<KV>(m, k, groups, t_len, n_heads); }) ||
      !cached_tmap(&tv, {v, {groups, t_len, n_heads, i8, 0}},
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
      &cfg, beam_kernel<KV>, tk, tv, static_cast<const __nv_bfloat16*>(q), q_stride,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<__nv_bfloat16*>(out), t_len, n_heads, beams, keys_per_split));
}

}  // namespace

// q (G, K, H, 64) bf16, its G*K rows q_stride elements apart (a row of a
// fused projection is read in place), each row's heads contiguous; k/v
// (G, T, H*64) bf16 (kv_int8=0) or int8 (kv_int8=1) with fp32 (G, T)
// scales; every slot a key. The keys of each (group, head, 16-beam tile)
// are split over a cluster of `splits` CTAs of keys_per_split keys (a
// multiple of 64; ops/decode_attention.py `beam_plan`). out (G, K, H, 64)
// bf16. Returns the launch's cudaError_t, or cudaErrorInvalidValue when a
// tensor map cannot be encoded.
extern "C" int kwt_decode_attention_beam(int card, const void* q, long long q_stride,
                                         const void* k, const void* v, const void* k_scale,
                                         const void* v_scale, void* out, int groups, int t_len,
                                         int n_heads, int beams, int splits, int keys_per_split,
                                         int kv_int8, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_int8)
    return launch<int8_t>(card, q, (long)q_stride, k, v, k_scale, v_scale, out, groups, t_len,
                          n_heads, beams, splits, keys_per_split, s);
  return launch<__nv_bfloat16>(card, q, (long)q_stride, k, v, k_scale, v_scale, out, groups,
                               t_len, n_heads, beams, splits, keys_per_split, s);
}
