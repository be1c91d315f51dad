// Flash-attention forward for Hopper, bf16 in / bf16 out, one kernel in
// two instantiations: non-causal (K1: the encoder's self-attention, the
// decoder's cross-attention in training, any key count, long K streamed)
// and causal (K4: the decoder's self-attention in training).
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py `_fwd_kernel_single`
// (K1) and `_fwd_kernel` (K4, the online-softmax forward with the
// end-aligned causal mask), both called through `_flash_fwd`: O in the
// input dtype and the fp32 natural-log LSE that the backward kernels (K5)
// read.
//
// What bounds it on the card: at the encoder's shape (B*20 heads, T=1500,
// D=64) one call does 4*B*H*T^2*D flops (184 GFLOP at B=16, 0.186 ms at
// 989 TFLOP/s) and B*H*T^2 exponentials (0.172 ms at the SFUs' 16 per clock
// per SM) over ~250 MB: tensor-bound, with the exponentials nearly as
// large. Run one after the other, the two add up to ~0.36 ms; the design
// overlaps them. At the decoder's causal training shape (B=8, T=128, 20
// heads) one call needs ~0.34 GFLOP over ~10.6 MB: bound by its bytes at
// ~3 us, so launch cost and the latency of one tile's chain dominate.
//
// Design: FlashAttention-3 order. A persistent grid of one 384-thread CTA per
// SM walks 128-query-row tiles of (batch, head). Warpgroup 0 is the producer:
// it gives up its registers (setmaxnreg) and one thread keeps TMA loads in
// flight: two Q tiles (the next work item's loads while this one runs) and a
// 3-stage ring of 128-key K and V tiles, each completion counted on an
// mbarrier. Warpgroups 1 and 2 each own 64 of the 128 query rows: S = Q K^T
// is one wgmma m64n128k16 chain with Q and K read from 128-byte-swizzled
// shared memory; P leaves the S accumulators as bf16 A fragments in registers
// and O += P V is a wgmma m64n64k16 chain with V read transposed (MN-major)
// from shared memory. The exponentials overlap the tensor cores twice: within
// a warpgroup the softmax of tile j runs while P_{j-1} V_{j-1} is in flight,
// and the two warpgroups take turns at the tensor cores (named barriers 1 and
// 2), so one's softmax runs under the other's products. The 1/sqrt(64) scale
// and log2(e) fold into one FFMA ahead of ex2. The consumer loop is peeled so
// that no wgmma is issued under a branch (ptxas serialises wgmmas on
// divergent paths). Tensors keep the model's (B, T, H, 64) layout, read by
// 4-D tensor maps (head dim, heads, tokens, batch) with per-tensor token and
// batch strides, so a fused qkv projection's column blocks are read in place.
// TMA zero-fills rows past T; query rows past tq are never stored.
// Each work item plans its own key tiles (`plan_item`, mirrored by
// ops/flash_attention.py `causal_tile_plan`): the causal instantiation
// (kCausal) visits, in ascending order, only the tiles at or below its last
// row's bound j <= row + tk - tq, and takes the work items heaviest query
// tile first so the longest chains start in the first wave. Only the tiles
// past the first row's bound (and a ragged last tile) are masked, to -inf
// past each row's bound and past tk. Every row's first tile holds key 0, so
// its running max is finite before any tile where the row sees no key.
//
// The no-max form (kNoMax; the JAX package's KWT_FA_NOMAX, non-causal
// only): a pre-pass (key_bound.cuh `key_norm_max`) writes max_j ||k_j|| of
// each (batch, head), and each consumer thread takes the norms of its two
// rows from the Q tile in shared memory (no second read of q), so every
// row's shift is fixed before its first tile: m = ||q|| * kmax * scale *
// log2(e), no running max, no rescale of O and l. Rows whose every p
// underflows keep l = 0 and, as in the TPU kernel, divide by max(l, 1e-30):
// O is 0 and the LSE m + ln 1e-30.
#include <cuda.h>

#include "card.cuh"
#include "key_bound.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kD = 64;                      // head dim
constexpr int kWGs = 2;                     // consumer warpgroups, 64 query rows each
constexpr int kBM = 64 * kWGs;              // query rows per tile
constexpr int kBN = 128;                    // keys per K/V tile
constexpr int kStages = 3;                  // K/V ring depth
constexpr int kQBufs = 2;                   // Q tiles: the next work item's Q loads early
constexpr int kThreads = 128 * (kWGs + 1);  // + the producer warpgroup
constexpr int kConsumers = 128 * kWGs;
constexpr int kTurn = 256;  // threads on a turn barrier: the warpgroup waiting, the one handing over
constexpr uint32_t kTileBytes = kBN * kD * 2;  // one 128 x 64 bf16 K or V box
constexpr uint32_t kQBytes = kBM * kD * 2;

struct __align__(1024) Smem {
  __nv_bfloat16 q[kQBufs][kBM * kD];
  __nv_bfloat16 k[kStages][kBN * kD];
  __nv_bfloat16 v[kStages][kBN * kD];
  uint64_t q_full[kQBufs], q_empty[kQBufs];
  uint64_t k_full[kStages], k_empty[kStages], v_full[kStages], v_empty[kStages];
};

// S (64 x 128) = Q (this warpgroup's 64 rows) K^T: four k-steps of 16 head
// dims, each 32 bytes further into the 128-byte swizzled rows.
__device__ __forceinline__ void issue_s(float* sacc, uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss(sacc, sw128_desc(q_addr + kk * 32, 16, 1024),
                        sw128_desc(k_addr + kk * 32, 16, 1024), kk);
}
// O (64 x 64) += P (64 x 128 keys, registers) V: eight k-steps of 16 keys,
// each 16 rows (2048 bytes) further into the V tile.
__device__ __forceinline__ void issue_pv(float* oacc, const uint32_t (*pa)[4], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_m64n64k16_rs_mn(oacc, pa[kk], sw128_desc(v_addr + kk * 2048, 1024, 1024));
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(acc[i]);
}

// Online softmax of one S tile in place: when `mask`, keys past tk (from
// key0, this thread's first column) or, causal, the columns of row r
// (lane/4, lane/4 + 8) past lim[r] keys beyond key0 are masked to -inf;
// the running max m (log2 units) and this thread's partial sums l updated,
// corr = exp2(m_old - m_new) for O, and S replaced by P = exp2(S *
// scale_log2 - m). kNoMax: m is the rows' fixed bound, and only P and l
// are updated.
template <bool kCausal, bool kNoMax>
__device__ __forceinline__ void softmax_tile(float* sacc, float* m_run, float* l_run,
                                             float* corr, bool mask, int key0, int tk,
                                             const int* lim, float scale_log2) {
  if (mask) {
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kCausal ? i * 8 + (e & 1) > lim[e >> 1] : key0 + i * 8 + (e & 1) >= tk)
          sacc[4 * i + e] = -INFINITY;
  }
  if constexpr (!kNoMax) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * i], sacc[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
      corr[r] = ex2(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
  }
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sacc[4 * i + e], scale_log2, -m_run[e >> 1]));
      sacc[4 * i + e] = p;
      l_run[e >> 1] += p;
    }
}

// kNoMax: the fp32 squared norms of this thread's rows r and r + 8 of the
// 128-row bf16 Q tile (128-byte rows, 128-byte swizzle), each thread of the
// quad summing two of a row's eight 16-byte chunks.
__device__ __forceinline__ void q_norms2(float* n2, const __nv_bfloat16* tile, int r, int lane) {
  const int t = lane & 3, sw = r & 7;  // (r + 8) & 7 == r & 7
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const uint8_t* row = reinterpret_cast<const uint8_t*>(tile) + (r + 8 * rr) * 128;
    float acc = 0.f;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row + (((2 * t + cc) ^ sw) << 4));
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = __uint_as_float(w[i] << 16), b = __uint_as_float(w[i] & 0xFFFF0000u);
        acc = fmaf(a, a, fmaf(b, b, acc));
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    n2[rr] = acc;
  }
}

// P (fp32, the S accumulator layout) -> bf16 A fragments of the P V wgmma:
// k-step kk takes the accumulator's n8 blocks 2kk and 2kk+1.
__device__ __forceinline__ void pack_p(uint32_t (*pa)[4], const float* sacc) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(sacc[8 * kk], sacc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
  }
}

// Work item w: its (batch * head) index, first query row, the key tiles it
// visits and how many of the leading ones need no mask. Non-causal: every
// tile, items in (batch, head)-major order. Causal: the tiles at or below
// the last row's bound, items heaviest query tile first.
template <bool kCausal>
__device__ __forceinline__ void plan_item(int w, int n_qtiles, int n_bh, int tq, int tk,
                                          int& bh, int& q0, int& n_tiles, int& n_free) {
  if constexpr (kCausal) {
    const int step = w / n_bh;
    bh = w - step * n_bh;
    q0 = (n_qtiles - 1 - step) * kBM;
    const int offset = tk - tq, last_row = min(q0 + kBM - 1, tq - 1);
    n_tiles = min((tk + kBN - 1) / kBN, (last_row + offset) / kBN + 1);
    n_free = min(n_tiles, (q0 + offset + 1) / kBN);
  } else {
    bh = w / n_qtiles;
    q0 = (w - bh * n_qtiles) * kBM;
    n_tiles = (tk + kBN - 1) / kBN;
    n_free = tk / kBN;
  }
}

template <bool kCausal, bool kNoMax>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                          const float* __restrict__ kmax, int tq, int tk, int n_heads,
                          int n_qtiles, int n_work, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int n_bh = n_work / n_qtiles;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], kConsumers);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.k_empty[i], kConsumers);
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
      prefetch_tmap(&tm_k);
      prefetch_tmap(&tm_v);
      uint32_t it = 0, qi = 0;  // K/V tiles and Q tiles issued so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++qi) {
        int bh, q0, n_tiles, n_free;
        plan_item<kCausal>(w, n_qtiles, n_bh, tq, tk, bh, q0, n_tiles, n_free);
        const int b = bh / n_heads, h = bh - b * n_heads;
        const int qs = qi % kQBufs;
        mbar_wait(&s.q_empty[qs], ((qi / kQBufs) & 1) ^ 1);
        mbar_expect_tx(&s.q_full[qs], kQBytes);
        tma_load_4d(s.q[qs], &tm_q, &s.q_full[qs], 0, h, q0, b);
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int st = it % kStages;
          const uint32_t ph = (it / kStages) & 1;
          mbar_wait(&s.k_empty[st], ph ^ 1);
          mbar_expect_tx(&s.k_full[st], kTileBytes);
          tma_load_4d(s.k[st], &tm_k, &s.k_full[st], 0, h, j * kBN, b);
          mbar_wait(&s.v_empty[st], ph ^ 1);
          mbar_expect_tx(&s.v_full[st], kTileBytes);
          tma_load_4d(s.v[st], &tm_v, &s.v_full[st], 0, h, j * kBN, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -----------------------------------
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid >> 5, lane = tid & 31;
    const long row_stride = (long)n_heads * kD;  // of O
    // the turns go round the consumers in order; consumer 0 takes the first
    if (c == kWGs - 1) named_bar_arrive(1, kTurn);
    const int next_turn = 1 + (c + 1) % kWGs;
    uint32_t it = 0, qi = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++qi) {
      int bh, q0, n_tiles, n_free;
      plan_item<kCausal>(w, n_qtiles, n_bh, tq, tk, bh, q0, n_tiles, n_free);
      // this thread's rows are row0 and row0 + 8; causal: the last key each
      // sees, less the current tile's first column of this thread
      const int row0 = q0 + c * 64 + warp * 16 + (lane >> 2);
      int lim[2];
      if constexpr (kCausal) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lim[r] = min(row0 + 8 * r + tk - tq, tk - 1) - (lane & 3) * 2;
      }
      float oacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // rows lane/4 and lane/4 + 8, log2 units
      float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
      uint32_t pa[kBN / 16][4];                 // P of the previous tile, bf16 A fragments
      float sacc[kBN / 2];                      // S of the current tile
      const int qs = qi % kQBufs;
      const uint32_t q_addr = smem_u32(s.q[qs]) + c * 64 * 128;
      mbar_wait(&s.q_full[qs], (qi / kQBufs) & 1);
      if constexpr (kNoMax) {  // the rows' fixed shifts, log2 units
        float n2[2];
        q_norms2(n2, s.q[qs], c * 64 + warp * 16 + (lane >> 2), lane);
        const float bound = kmax[bh] * scale_log2;
        m_run[0] = sqrtf(n2[0]) * bound;
        m_run[1] = sqrtf(n2[1]) * bound;
      }

      // The loop is peeled (tile 0: S only; tiles 1..n-1: S and the
      // previous tile's P V; then the last P V) so that no wgmma is issued
      // under a branch: ptxas serialises wgmmas on divergent paths.
      const uint32_t last = it + n_tiles - 1;  // this work item's last K/V tile
      const bool ragged = tk % kBN != 0;       // non-causal: only the last tile is masked
      mbar_wait(&s.k_full[it % kStages], (it / kStages) & 1);
      named_bar_sync(1 + c, kTurn);  // this warpgroup's turn at the tensor cores
      wgmma_fence();
      issue_s(sacc, q_addr, smem_u32(s.k[it % kStages]));
      wgmma_commit();
      named_bar_arrive(next_turn, kTurn);
      wgmma_wait<0>();
      fence_acc(sacc);
      mbar_arrive(&s.k_empty[it % kStages]);
      if (n_tiles == 1) mbar_arrive(&s.q_empty[qs]);
      float corr[2];
      softmax_tile<kCausal, kNoMax>(sacc, m_run, l_run, corr,
                                    kCausal ? n_free == 0 : n_tiles == 1 && ragged,
                                    (lane & 3) * 2, tk, lim, scale_log2);
      pack_p(pa, sacc);
      for (uint32_t cur = it + 1; cur <= last; ++cur) {
        const int st = cur % kStages, pst = (cur - 1) % kStages;
        mbar_wait(&s.k_full[st], (cur / kStages) & 1);
        mbar_wait(&s.v_full[pst], ((cur - 1) / kStages) & 1);
        named_bar_sync(1 + c, kTurn);
        wgmma_fence();
        issue_s(sacc, q_addr, smem_u32(s.k[st]));
        wgmma_commit();
        issue_pv(oacc, pa, smem_u32(s.v[pst]));
        wgmma_commit();
        named_bar_arrive(next_turn, kTurn);
        wgmma_wait<1>();  // S done, P V still in flight
        fence_acc(sacc);
        mbar_arrive(&s.k_empty[st]);
        if (cur == last) mbar_arrive(&s.q_empty[qs]);  // the last read of this Q tile
        if constexpr (kCausal) {
          lim[0] -= kBN;
          lim[1] -= kBN;
        }
        softmax_tile<kCausal, kNoMax>(sacc, m_run, l_run, corr,
                                      kCausal ? (int)(cur - it) >= n_free : cur == last && ragged,
                                      (int)(cur - it) * kBN + (lane & 3) * 2, tk, lim,
                                      scale_log2);
        wgmma_wait<0>();
        fence_acc(oacc);
        mbar_arrive(&s.v_empty[pst]);
        if constexpr (!kNoMax) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            oacc[4 * i] *= corr[0];
            oacc[4 * i + 1] *= corr[0];
            oacc[4 * i + 2] *= corr[1];
            oacc[4 * i + 3] *= corr[1];
          }
        }
        pack_p(pa, sacc);
      }
      mbar_wait(&s.v_full[last % kStages], (last / kStages) & 1);
      named_bar_sync(1 + c, kTurn);
      wgmma_fence();
      issue_pv(oacc, pa, smem_u32(s.v[last % kStages]));
      wgmma_commit();
      named_bar_arrive(next_turn, kTurn);
      wgmma_wait<0>();
      fence_acc(oacc);
      mbar_arrive(&s.v_empty[last % kStages]);
      it += n_tiles;

      // ---- epilogue: full row sums over the quad, normalise, store ----------
      const int b = bh / n_heads, h = bh - b * n_heads;
      __nv_bfloat16* ob = o + (long)b * tq * row_stride + h * kD;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        const int row = row0 + 8 * r;
        if (row >= tq) continue;
        const float l_safe = fmaxf(l_run[r], 1e-30f), inv = 1.f / l_safe;
        uint32_t* dst = reinterpret_cast<uint32_t*>(ob + (long)row * row_stride);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i * 4 + (lane & 3)] =
              pack_bf16x2(oacc[4 * i + 2 * r] * inv, oacc[4 * i + 2 * r + 1] * inv);
        if ((lane & 3) == 0)
          lse[(long)bh * tq + row] = m_run[r] * 0.6931471805599453f + logf(l_safe);
      }
    }
    // the last consumer hands its last turn over too; consumer 0 takes it
    // here, so every turn barrier ends balanced
    if (c == 0) named_bar_sync(1, kTurn);
  }
}

// 4-D map (head dim 64, heads, tokens, batch) of a (B, T, H, 64) bf16
// tensor with the given byte strides of heads, tokens and batch; 128-token
// boxes of one head, 128-byte swizzled, zero-filled past T.
bool make_map(CUtensorMap* map, const void* base, int batch, int t, int n_heads,
              long long head_bytes, long long token_bytes, long long batch_bytes,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)n_heads, (cuuint64_t)t,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)head_bytes, (cuuint64_t)token_bytes,
                                 (cuuint64_t)batch_bytes};
  const cuuint32_t box[4] = {kD, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

namespace {

// The launches of either C entry, on the card it entered: kmax non-null
// takes the no-max form (plan[14] != 0) after the key-bound pre-pass.
int launch(int card, const void* q, const void* k, const void* v, void* o, void* lse,
           float* kmax, const long long* plan, void* stream) {
  const int batch = static_cast<int>(plan[0]), tq = static_cast<int>(plan[1]);
  const int tk = static_cast<int>(plan[2]), n_heads = static_cast<int>(plan[3]);
  const bool causal = plan[4] != 0, no_max = plan[14] != 0;
  if (no_max != (kmax != nullptr) || (no_max && causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = plan + 5;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, batch, tq, n_heads, st[0], st[1], st[2], kBM) ||
      !make_map(&tm_k, k, batch, tk, n_heads, st[3], st[4], st[5], kBN) ||
      !make_map(&tm_v, v, batch, tk, n_heads, st[6], st[7], st[8], kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  // per card: its SM count, set once the kernels' shared-memory limit is
  // raised there
  static int n_sms_of[kwt_card::kMaxCards] = {};
  int& n_sms = n_sms_of[card];
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;  // + alignment slack
  if (n_sms == 0) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90_kernel<false, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_sm90_kernel<true, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_fwd_sm90_kernel<false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, card);
    if (e != cudaSuccess) {
      n_sms = 0;  // try again on the next call
      return static_cast<int>(e);
    }
  }
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (no_max) {  // byte strides of k's heads, tokens and batch, in bf16 elements
    kwt_key_bound::key_norm_max<__nv_bfloat16><<<batch * n_heads, kwt_key_bound::kThreads, 0, cs>>>(
        static_cast<const __nv_bfloat16*>(k), kmax, tk, n_heads, st[5] / 2, st[4] / 2, st[3] / 2);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_qtiles = (tq + kBM - 1) / kBM;
  const int n_work = n_qtiles * batch * n_heads;
  const float scale_log2 = 0.125f * 1.4426950408889634f;  // 1/sqrt(64) * log2(e)
  auto kernel = no_max  ? flash_fwd_sm90_kernel<false, true>
                : causal ? flash_fwd_sm90_kernel<true, false>
                         : flash_fwd_sm90_kernel<false, false>;
  kernel<<<n_work < n_sms ? n_work : n_sms, kThreads, smem, cs>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), kmax, tq, tk,
      n_heads, n_qtiles, n_work, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, Tq, H, 64), k/v (B, Tk, H, 64) bf16 -> o (B, Tq, H, 64) bf16
// contiguous, lse (B, H, Tq) fp32. plan (ops/flash_attention.py
// `_fwd_plan`): batch, tq, tk, heads, causal (!= 0: the end-aligned mask,
// tq <= tk), then the byte strides of q's, k's and v's heads, tokens and
// batch (multiples of 16), then no_max (0 here). Returns the launch's
// cudaError_t, or cudaErrorInvalidValue when a tensor map cannot be
// encoded or the plan asks for the no-max form.
extern "C" int kwt_flash_attention_sm90_fwd(int card, const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  return launch(card, q, k, v, o, lse, nullptr, plan, stream);
}

// K1's no-max form: as kwt_flash_attention_sm90_fwd with plan[14] != 0 and
// no causal mask; kmax (B, H) fp32 takes the key-bound pre-pass's output.
extern "C" int kwt_flash_attention_sm90_fwd_nomax(int card, const void* q, const void* k,
                                                  const void* v, void* o, void* lse, void* kmax,
                                                  const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  if (kmax == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(card, q, k, v, o, lse, static_cast<float*>(kmax), plan, stream);
}
