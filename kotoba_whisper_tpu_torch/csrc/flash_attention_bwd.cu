// Flash-attention backward for Hopper (K5), bf16 in / bf16 out, causal
// (decoder self-attention, end-aligned) and non-causal (cross-attention).
//
// Replaces: kotoba_whisper_tpu/ops/flash_attention.py `_bwd_dq_kernel`
// (:315) and `_bwd_dkv_kernel` (:385), called through `_flash_bwd` (:581):
// dQ, dK and dV of softmax(q k^T / 8) v from the forward's fp32
// natural-log LSE and D = rowsum(dO * O), which `_flash_bwd` computes in
// XLA ahead of its two kernels.
//
// What bounds it on the card: the function reads q, k, v, O, dO and the LSE
// once and writes dq, dk, dv once. At the training cross shape (B=8, 20
// heads, Tq=128, Tk=1500, D=64) that is ~133 MB (0.0398 ms at 3.35 TB/s)
// against 5 products of 2*B*H*Tq*Tk*D flops (19.7 GFLOP, 0.0199 ms at 989
// TFLOP/s); at the causal shape (T=128) ~21 MB (0.0063 ms) against 0.34
// GFLOP. Both are bound by bytes.
//
// Design: FlashAttention-3's backward order, in three launches.
//  1. `bwd_prepass`: D = rowsum(dO * O) in fp32, read from the (B, T, H, 64)
//     layout, and the LSE in log2 units, both as (B*H, Tq padded to 64)
//     rows (+inf LSE and 0 D past Tq, so padded query rows give P = 0); it
//     zeroes the fp32 dQ accumulator when one is used.
//  2. `flash_bwd_sm90_kernel`: a persistent grid of one 384-thread CTA per
//     SM walks work items of one 128-key tile of one (batch, head), so K
//     and V are read once. Warpgroup 0 is the producer (setmaxnreg 24): one
//     thread loads the item's K and V tiles (two buffers: the next item's
//     load early) and a 3-stage ring of 64-row Q and dO tiles through 4-D
//     tensor maps (head dim, heads, tokens, batch, with per-tensor token
//     and batch strides, so fused projections are read in place), with
//     their LSE and D rows as 1-D bulk copies, each completion counted on
//     an mbarrier. Warpgroups 1 and 2 each own 64 of the tile's keys. Per
//     Q tile each computes S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16,
//     both operands K-major from 128-byte-swizzled shared memory), P^T =
//     exp2(S^T * log2(e)/8 - LSE2) and dS^T = P^T (dP^T - D), rounds P and
//     dS to bf16 as the TPU kernels do, and adds dV += P^T dO and dK +=
//     dS^T Q (wgmma from registers, dO and Q read MN-major). dK and dV stay
//     in registers across the item's Q tiles and are stored once, dK times
//     1/8, staged in the item's K and V buffers for two TMA stores (one
//     4-D map over the (2, B, Tk, H, 64) dK/dV allocation); the buffers are
//     released one tile later, once the stores have read them. Each
//     warpgroup stages its dS^T rows (bf16, swizzled by hand) in shared
//     memory; after one 256-thread barrier each computes 32 of the 64 head
//     dims of dQ = dS K over all 128 keys (wgmma m64n32k16, dS and K both
//     MN-major), so the two warpgroups do the same work and no wgmma is
//     issued under a branch. dS is double-buffered by tile parity: a
//     warpgroup writes a buffer again only after the next tile's barrier,
//     which the other passes only after its wgmma on that buffer completed.
//  3. `bwd_dq_convert` (only when a (batch, head) has several key tiles):
//     dQ times 1/8 to bf16.
// dQ across key tiles: each warpgroup stages its fp32 dQ half (64 rows x
// 32 dims, 8 KB, in its fragment order; two buffers by tile parity, so
// one tile's reduce reads while the next is computed) and one thread adds
// it into an fp32 accumulator in L2 with one bulk reduce-add
// (cp.reduce.async.bulk .add.f32); the accumulator keeps that fragment
// order per (batch*head, 64-row tile) and step 3 undoes it. The order of
// the adds from different CTAs varies from run to run, so dQ may differ by
// fp32 rounding of its sum (then one bf16 rounding) between runs. Where a
// (batch, head) has a single key tile (Tk <= 128: the causal T=128
// training shape), the item writes dQ in bf16 directly: no accumulator,
// no zeroing, no step 3.
// Causal plan (`plan_item`, mirrored by ops/flash_attention.py
// `bwd_tile_plan`): a key tile visits only the Q tiles whose rows see one
// of its keys (row >= key - (Tk - Tq)) and masks only those whose first row
// does not see its last key; items run lowest key tile first, the
// heaviest. Non-causal, only a ragged last key tile is masked, at keys
// past Tk (TMA zero-fills K and V there, and their dK and dV rows are not
// stored, but P = exp2(-LSE2) of a zero score could overflow into dQ).
// Against the four costs of the mma.sync pair it replaces: (1) K and V are
// read once and S, P are computed once (5 products, not 7); (2) wgmma from
// TMA-filled swizzled shared memory with a producer warp, in place of
// mma.sync fragments and cp.async; (3) D is computed by step 1, not by
// eager torch ops; (4) the wrapper's checks are cached per set of layouts
// (`_bwd_plan`) and the C entry takes one plan array.
// Deviations from FA3's hdim-64 recipe: 64-row Q tiles (S^T and dP^T at
// 64 x 64 per warpgroup, 128 accumulator registers with dK and dV, so the
// consumers fit the 168 registers ptxas sizes a 384-thread CTA at), and no
// overlap of a tile's exponentials with its own or the next tile's
// products within a warpgroup (a build that overlapped P with dP^T and dS
// with dV spilled and was slower); the two warpgroups run in step, met at
// the dS barrier.
#include <cuda.h>

#include "card.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kD = 64;                 // head dim
constexpr int kBN = 128;               // keys per work item (64 a consumer warpgroup)
constexpr int kBM = 64;                // query rows per Q tile
constexpr int kStages = 3;             // Q / dO ring depth
constexpr int kThreads = 384;          // producer warpgroup + two consumers
constexpr int kConsumers = 256;
constexpr uint32_t kKVBytes = kBN * kD * 2;  // one 128 x 64 bf16 K or V box
constexpr uint32_t kQBytes = kBM * kD * 2;   // one 64 x 64 bf16 Q or dO box
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBarDs = 1;   // named barrier: both warpgroups' dS staged
constexpr int kBarWg = 2;   // + warpgroup: its dQ staging buffer

struct __align__(1024) Smem {
  __nv_bfloat16 k[2][kBN * kD];
  __nv_bfloat16 v[2][kBN * kD];
  __nv_bfloat16 q[kStages][kBM * kD];
  __nv_bfloat16 dout[kStages][kBM * kD];
  __nv_bfloat16 ds[2][kBN * kBM];  // dS^T: 128 key rows of 64 queries, swizzled
  float dq[2][2][kBM * 32];        // per warpgroup and tile parity: fp32 dQ half, fragment order
  float lse[kStages][kBM];         // log2 units
  float dlt[kStages][kBM];
  uint64_t kv_full[2], kv_empty[2], q_full[kStages], q_empty[kStages];
};

template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(acc[i]);
}

// fp32 accumulator pairs (the m64nXk16 layout) -> bf16 A fragments of a
// register-A wgmma: k-step kk takes the accumulator's n8 blocks 2kk, 2kk+1.
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], const float* acc) {
#pragma unroll
  for (int kk = 0; kk < kBM / 16; ++kk) {
    a[kk][0] = pack_bf16x2(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// Work item w: its (batch * head) index, key tile, first Q tile and the
// first Q tile that needs no mask. Non-causal: every Q tile, none masked
// by the plan (a ragged last key tile masks keys past tk itself),
// items (batch, head)-major so one head's Q and dO stay in L2 across its
// key tiles. Causal: the Q tiles from the first row that sees key k0, the
// lowest key tiles (the most Q tiles) first.
template <bool kCausal>
__device__ __forceinline__ void plan_item(int w, int n_bh, int n_kt, int n_qt, int tq, int tk,
                                          int& bh, int& kt, int& qt0, int& free_from) {
  if constexpr (kCausal) {
    kt = w / n_bh;
    bh = w - kt * n_bh;
    const int offset = tk - tq, k0 = kt * kBN;
    qt0 = max(k0 - offset, 0) / kBM;
    free_from = max(qt0, min(n_qt, max(0, k0 + kBN - 1 - offset + kBM - 1) / kBM));
  } else {
    bh = w / n_kt;
    kt = w - bh * n_kt;
    qt0 = 0;
    free_from = 0;
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dkv,
                          const float* __restrict__ lse2, const float* __restrict__ delta,
                          float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dq,
                          int batch, int tq, int tk, int n_heads, int direct) {
  extern __shared__ uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;
  const int n_kt = (tk + kBN - 1) / kBN, n_qt = (tq + kBM - 1) / kBM;
  const int tq_pad = n_qt * kBM;
  const int n_bh = batch * n_heads, n_work = n_bh * n_kt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&s.kv_full[i], 1);
      mbar_init(&s.kv_empty[i], kConsumers);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.q_full[i], 1);
      mbar_init(&s.q_empty[i], kConsumers);
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
      prefetch_tmap(&tm_do);
      uint32_t ic = 0, qc = 0;  // items and Q tiles issued so far
      for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++ic) {
        int bh, kt, qt0, free_from;
        plan_item<kCausal>(w, n_bh, n_kt, n_qt, tq, tk, bh, kt, qt0, free_from);
        const int b = bh / n_heads, h = bh - b * n_heads;
        const int kb = ic & 1;
        mbar_wait(&s.kv_empty[kb], ((ic >> 1) & 1) ^ 1);
        mbar_expect_tx(&s.kv_full[kb], 2 * kKVBytes);
        tma_load_4d(s.k[kb], &tm_k, &s.kv_full[kb], 0, h, kt * kBN, b);
        tma_load_4d(s.v[kb], &tm_v, &s.kv_full[kb], 0, h, kt * kBN, b);
        for (int qt = qt0; qt < n_qt; ++qt, ++qc) {
          const int st = qc % kStages;
          mbar_wait(&s.q_empty[st], ((qc / kStages) & 1) ^ 1);
          mbar_expect_tx(&s.q_full[st], 2 * kQBytes + 2 * kBM * 4);
          tma_load_4d(s.q[st], &tm_q, &s.q_full[st], 0, h, qt * kBM, b);
          tma_load_4d(s.dout[st], &tm_do, &s.q_full[st], 0, h, qt * kBM, b);
          const long row = (long)bh * tq_pad + qt * kBM;
          bulk_load(s.lse[st], lse2 + row, kBM * 4, &s.q_full[st]);
          bulk_load(s.dlt[st], delta + row, kBM * 4, &s.q_full[st]);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ------------------------------------------
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg, warp = tid >> 5, lane = tid & 31;
    const long row_stride = (long)n_heads * kD;  // of dq
    const float scale_log2 = 0.125f * kLog2e;
    // this thread's accumulator rows: keys (S^T, dK, dV) or queries (dQ)
    // r0 and r0 + 8 of its warpgroup's 64; columns 8i + 2(lane & 3) + {0, 1}
    const int r0 = warp * 16 + (lane >> 2);
    const int col0 = 2 * (lane & 3);
    uint32_t ic = 0, qc = 0;
    int owed = -1;  // thread 0: the K/V buffer whose release waits for its dK/dV stores
    for (int w = blockIdx.x; w < n_work; w += gridDim.x, ++ic) {
      int bh, kt, qt0, free_from;
      plan_item<kCausal>(w, n_bh, n_kt, n_qt, tq, tk, bh, kt, qt0, free_from);
      const int b = bh / n_heads, h = bh - b * n_heads;
      const int kb = ic & 1;
      const int key0 = kt * kBN + c * 64 + r0;  // this thread's first key
      const bool ragged = !kCausal && kt == n_kt - 1 && tk % kBN != 0;
      float dk_acc[32], dv_acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      const uint32_t k_addr = smem_u32(s.k[kb]), v_addr = smem_u32(s.v[kb]);
      const uint32_t kc_addr = k_addr + c * 64 * 128, vc_addr = v_addr + c * 64 * 128;
      mbar_wait(&s.kv_full[kb], (ic >> 1) & 1);

      for (int qt = qt0; qt < n_qt; ++qt, ++qc) {
        const int st = qc % kStages;
        const uint32_t q_addr = smem_u32(s.q[st]), do_addr = smem_u32(s.dout[st]);
        mbar_wait(&s.q_full[st], (qc / kStages) & 1);

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, four k-steps
        // of 16 head dims each, 32 bytes further into the swizzled rows
        float sacc[32], dpacc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(sacc, sw128_desc(kc_addr + kk * 32, 16, 1024),
                             sw128_desc(q_addr + kk * 32, 16, 1024), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(dpacc, sw128_desc(vc_addr + kk * 32, 16, 1024),
                             sw128_desc(do_addr + kk * 32, 16, 1024), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(sacc);
        fence_acc(dpacc);

        // P^T and dS^T in place. Causal tiles below free_from drop the
        // pairs key > query + tk - tq; a ragged last key tile drops keys
        // past tk (their zero-filled K rows would otherwise meet a P that
        // exp2(-LSE2) can overflow)
        const bool masked = kCausal ? qt < free_from : ragged;
        const int lim = kCausal ? key0 - (qt * kBM + col0) - (tk - tq) : tk - key0;
#pragma unroll
        for (int i = 0; i < kBM / 8; ++i) {
          const float2 l2 = *reinterpret_cast<const float2*>(&s.lse[st][8 * i + col0]);
          const float2 dl = *reinterpret_cast<const float2*>(&s.dlt[st][8 * i + col0]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l = (e & 1) ? l2.y : l2.x, d = (e & 1) ? dl.y : dl.x;
            float x = fmaf(sacc[4 * i + e], scale_log2, -l);
            if (masked && (kCausal ? lim + 8 * (e >> 1) - 8 * i - (e & 1) > 0 : 8 * (e >> 1) >= lim))
              x = -INFINITY;
            const float p = ex2(x);
            sacc[4 * i + e] = p;
            dpacc[4 * i + e] = p * (dpacc[4 * i + e] - d);
          }
        }
        uint32_t pa[kBM / 16][4], dsa[kBM / 16][4];
        pack_a(pa, sacc);
        pack_a(dsa, dpacc);

        // stage this warpgroup's 64 dS^T rows: row = key, 128 bytes of
        // queries, 16-byte chunk i at i ^ (row & 7) (the 128-byte swizzle;
        // row & 7 is lane / 4 for both of this thread's rows)
        const int buf = qc & 1;
        uint8_t* ds_rows = reinterpret_cast<uint8_t*>(s.ds[buf]) + (c * 64 + r0) * 128 + 4 * (lane & 3);
        const int sw = lane >> 2;
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk) {
          *reinterpret_cast<uint32_t*>(ds_rows + (((2 * kk) ^ sw) << 4)) = dsa[kk][0];
          *reinterpret_cast<uint32_t*>(ds_rows + 8 * 128 + (((2 * kk) ^ sw) << 4)) = dsa[kk][1];
          *reinterpret_cast<uint32_t*>(ds_rows + (((2 * kk + 1) ^ sw) << 4)) = dsa[kk][2];
          *reinterpret_cast<uint32_t*>(ds_rows + 8 * 128 + (((2 * kk + 1) ^ sw) << 4)) = dsa[kk][3];
        }
        fence_proxy_async_smem();
        // the reduce that read this tile parity's dQ staging buffer (two
        // tiles ago) is done before any thread passes the barrier
        if (!direct && tid == 0) bulk_wait_read<1>();
        named_bar_sync(kBarDs, kConsumers);

        // dV += P^T dO, dK += dS^T Q (16 queries a k-step, 2048 bytes),
        // and this warpgroup's 32 dims of dQ = dS K over the 128 keys
        const uint32_t ds_addr = smem_u32(s.ds[buf]);
        float dq_acc_r[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_m64n64k16_rs_mn(dv_acc, pa[kk], sw128_desc(do_addr + kk * 2048, 1024, 1024));
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_m64n64k16_rs_mn(dk_acc, dsa[kk], sw128_desc(q_addr + kk * 2048, 1024, 1024));
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_m64n32k16_ss_mn(dq_acc_r, sw128_desc(ds_addr + kk * 2048, 1024, 1024),
                                sw128_desc(k_addr + kk * 2048 + c * 64, 1024, 1024), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dv_acc);
        fence_acc(dk_acc);
        fence_acc(dq_acc_r);
        mbar_arrive(&s.q_empty[st]);
        if (tid == 0 && owed >= 0) {  // the previous item's dK/dV stores have read their rows
          bulk_wait_read<0>();
          mbar_arrive(&s.kv_empty[owed]);
          owed = -1;
        }

        if (direct) {
          // the only key tile: dQ rows in bf16, times 1/8
          __nv_bfloat16* dqb = dq + ((long)b * tq) * row_stride + h * kD + c * 32 + col0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = qt * kBM + r0 + 8 * r;
            if (row >= tq) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              *reinterpret_cast<uint32_t*>(dqb + row * row_stride + 8 * i) =
                  pack_bf16x2(dq_acc_r[4 * i + 2 * r] * 0.125f, dq_acc_r[4 * i + 2 * r + 1] * 0.125f);
          }
        } else {
          // fragment order: float4 i of thread tid at (i * 128 + tid) * 4
          float* stage = s.dq[c][qc & 1];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(&stage[(i * 128 + tid) * 4]) =
                make_float4(dq_acc_r[4 * i], dq_acc_r[4 * i + 1], dq_acc_r[4 * i + 2],
                            dq_acc_r[4 * i + 3]);
          fence_proxy_async_smem();
          named_bar_sync(kBarWg + c, 128);
          if (tid == 0) {
            bulk_reduce_add_f32(dq_acc + ((long)bh * n_qt + qt) * (kBM * kD) + c * (kBM * 32),
                                stage, kBM * 32 * 4);
            bulk_commit();
          }
        }
      }
      // ---- epilogue: dK (times 1/8) and dV through TMA stores ------------
      // Both warpgroups' dQ products have read every K row after this
      // barrier; then each stages its 64 rows of dK in the K buffer and of
      // dV in the V buffer, swizzled as TMA reads them, and one thread
      // stores both (rows past tk are not written). That thread releases
      // the buffers once the stores have read them, after the next item's
      // first tile.
      named_bar_sync(kBarDs, kConsumers);
      {
        const int sw = lane >> 2;
        uint8_t* kr = reinterpret_cast<uint8_t*>(s.k[kb]) + (c * 64 + r0) * 128 + 4 * (lane & 3);
        uint8_t* vr = reinterpret_cast<uint8_t*>(s.v[kb]) + (c * 64 + r0) * 128 + 4 * (lane & 3);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int off = r * 8 * 128 + ((i ^ sw) << 4);
            *reinterpret_cast<uint32_t*>(kr + off) =
                pack_bf16x2(dk_acc[4 * i + 2 * r] * 0.125f, dk_acc[4 * i + 2 * r + 1] * 0.125f);
            *reinterpret_cast<uint32_t*>(vr + off) =
                pack_bf16x2(dv_acc[4 * i + 2 * r], dv_acc[4 * i + 2 * r + 1]);
          }
      }
      fence_proxy_async_smem();
      named_bar_sync(kBarWg + c, 128);
      if (tid == 0) {
        tma_store_4d(&tm_dkv, s.k[kb] + c * 64 * kD, 0, h, kt * kBN + c * 64, b);
        tma_store_4d(&tm_dkv, s.v[kb] + c * 64 * kD, 0, h, kt * kBN + c * 64, batch + b);
        bulk_commit();
        owed = kb;
      } else {
        mbar_arrive(&s.kv_empty[kb]);
      }
    }
    if (tid == 0) bulk_wait_all();  // the last stores and reduce have completed
  }
}

// D = rowsum(dO * O) and LSE * log2(e) as (B*H, tq_pad) rows (0 and +inf
// past tq); eight threads a (batch, row, head), 16 bytes each; the
// threads then zero n_zero4 float4s of the dQ accumulator.
__global__ void __launch_bounds__(256)
    bwd_prepass(const uint8_t* __restrict__ o, const uint8_t* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ lse2,
                float* __restrict__ delta, float4* __restrict__ zero, long n_zero4, int batch,
                int tq, int tq_pad, int n_heads, long long o_head, long long o_tok,
                long long o_bat, long long do_head, long long do_tok, long long do_bat) {
  const long n_units = (long)batch * tq_pad * n_heads;
  const long n_threads = (long)gridDim.x * blockDim.x;
  const long gtid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int sub = threadIdx.x & 7;
  for (long u0 = (gtid >> 5) * 4; u0 < n_units; u0 += (n_threads >> 5) * 4) {
    const long u = u0 + ((threadIdx.x & 31) >> 3);
    const int h = (int)(u % n_heads);
    const long rest = u / n_heads;
    const int i = (int)(rest % tq_pad), b = (int)(rest / tq_pad);
    float sum = 0.f;
    if (u < n_units && i < tq) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + b * o_bat + i * o_tok + h * o_head + sub * 16);
      const uint4 dv = *reinterpret_cast<const uint4*>(dout + b * do_bat + i * do_tok + h * do_head + sub * 16);
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(op[j]), g = __bfloat1622float2(dp[j]);
        sum = fmaf(a.x, g.x, sum);
        sum = fmaf(a.y, g.y, sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (u < n_units && sub == 0) {
      const long bh = (long)b * n_heads + h;
      delta[bh * tq_pad + i] = i < tq ? sum : 0.f;
      lse2[bh * tq_pad + i] = i < tq ? lse[bh * tq + i] * kLog2e : INFINITY;
    }
  }
  for (long j = gtid; j < n_zero4; j += n_threads) zero[j] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The fp32 dQ accumulator (fragment order per (batch*head, 64-row tile))
// times 1/8 into bf16 dq (B, Tq, H, 64) contiguous: one float4 a thread.
__global__ void __launch_bounds__(256)
    bwd_dq_convert(const float4* __restrict__ acc, __nv_bfloat16* __restrict__ dq, long n4,
                   int tq, int n_qt, int n_heads) {
  for (long u = (long)blockIdx.x * blockDim.x + threadIdx.x; u < n4;
       u += (long)gridDim.x * blockDim.x) {
    const long blk = u >> 10;  // 1024 float4s a (batch*head, Q tile)
    const int rem = (int)(u & 1023);
    const int c = rem >> 9, i = (rem >> 7) & 3, t = rem & 127;
    const int bh = (int)(blk / n_qt), qt = (int)(blk - (long)bh * n_qt);
    const int b = bh / n_heads, h = bh - b * n_heads;
    const int lane = t & 31;
    const int row = qt * kBM + (t >> 5) * 16 + (lane >> 2);
    const int col = c * 32 + 8 * i + 2 * (lane & 3);
    const float4 x = acc[u];
    const long base = ((long)b * tq) * n_heads * kD + h * kD + col;
    if (row < tq)
      *reinterpret_cast<uint32_t*>(dq + base + (long)row * n_heads * kD) =
          pack_bf16x2(x.x * 0.125f, x.y * 0.125f);
    if (row + 8 < tq)
      *reinterpret_cast<uint32_t*>(dq + base + (long)(row + 8) * n_heads * kD) =
          pack_bf16x2(x.z * 0.125f, x.w * 0.125f);
  }
}

// 4-D map (head dim 64, heads, tokens, batch) of a (B, T, H, 64) bf16
// tensor with the given byte strides; box_rows-token boxes of one head,
// 128-byte swizzled, zero-filled past T.
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

// q, o, dout (B, Tq, H, 64), k, v (B, Tk, H, 64) bf16 with the plan's
// strides; lse (B, H, Tq) fp32 contiguous -> dq (B, Tq, H, 64) and dkv
// (2, B, Tk, H, 64: dK then dV) bf16 contiguous. scratch: fp32 LSE2 and D rows (B*H,
// tq_pad each), then, unless plan[5] (direct dQ), the dQ accumulator
// (B*H*n_qt*4096). plan (ops/flash_attention.py `_bwd_plan`): batch, tq,
// tk, heads, causal (!= 0: the end-aligned mask, tq <= tk), direct, then
// the head, token and batch byte strides of q, k, v, dout and o
// (multiples of 16). Launches the pre-pass, the main kernel and, unless
// direct, the dQ conversion on `stream`. Returns the first launch's
// cudaError_t, or cudaErrorInvalidValue when a tensor map cannot be
// encoded.
extern "C" int kwt_flash_attention_bwd(int card, const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* dq, void* dkv, void* scratch,
                                       const long long* plan, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  const int batch = static_cast<int>(plan[0]), tq = static_cast<int>(plan[1]);
  const int tk = static_cast<int>(plan[2]), n_heads = static_cast<int>(plan[3]);
  const bool causal = plan[4] != 0;
  const int direct = static_cast<int>(plan[5]);
  const long long* st = plan + 6;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dkv;
  const long long head = kD * 2, token = head * n_heads;  // of dkv, contiguous
  if (!make_map(&tm_q, q, batch, tq, n_heads, st[0], st[1], st[2], kBM) ||
      !make_map(&tm_k, k, batch, tk, n_heads, st[3], st[4], st[5], kBN) ||
      !make_map(&tm_v, v, batch, tk, n_heads, st[6], st[7], st[8], kBN) ||
      !make_map(&tm_do, dout, batch, tq, n_heads, st[9], st[10], st[11], kBM) ||
      !make_map(&tm_dkv, dkv, 2 * batch, tk, n_heads, head, token, token * tk, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // per card: its SM count, set once the kernels' shared-memory limit is
  // raised there
  static int n_sms_of[kwt_card::kMaxCards] = {};
  int& n_sms = n_sms_of[card];
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;  // + alignment slack
  if (n_sms == 0) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_sm90_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(flash_bwd_sm90_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, card);
    if (e != cudaSuccess) {
      n_sms = 0;  // try again on the next call
      return static_cast<int>(e);
    }
  }
  const int n_qt = (tq + kBM - 1) / kBM, n_kt = (tk + kBN - 1) / kBN;
  const int tq_pad = n_qt * kBM, n_bh = batch * n_heads;
  float* lse2 = static_cast<float*>(scratch);
  float* delta = lse2 + (long)n_bh * tq_pad;
  float* acc = delta + (long)n_bh * tq_pad;
  const long n_acc4 = direct ? 0 : (long)n_bh * n_qt * (kBM * kD / 4);

  const long cap = (long)n_sms * 8 * 256;  // threads of the grid-stride pre- and post-passes
  long pre_threads = (long)n_bh * tq_pad * 8;
  if (pre_threads < n_acc4) pre_threads = n_acc4;
  if (pre_threads > cap) pre_threads = cap;
  const int pre_blocks = static_cast<int>((pre_threads + 255) / 256);
  bwd_prepass<<<pre_blocks, 256, 0, cs>>>(
      static_cast<const uint8_t*>(o), static_cast<const uint8_t*>(dout),
      static_cast<const float*>(lse), lse2, delta, reinterpret_cast<float4*>(acc), n_acc4,
      batch, tq, tq_pad, n_heads, st[12], st[13], st[14], st[9], st[10], st[11]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_work = n_bh * n_kt;
  auto kernel = causal ? flash_bwd_sm90_kernel<true> : flash_bwd_sm90_kernel<false>;
  kernel<<<n_work < n_sms ? n_work : n_sms, kThreads, smem, cs>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dkv, lse2, delta, acc, static_cast<__nv_bfloat16*>(dq), batch,
      tq, tk, n_heads, direct);
  err = cudaGetLastError();
  if (err != cudaSuccess || direct) return static_cast<int>(err);

  const int cv_blocks = static_cast<int>(((n_acc4 < cap ? n_acc4 : cap) + 255) / 256);
  bwd_dq_convert<<<cv_blocks, 256, 0, cs>>>(reinterpret_cast<const float4*>(acc),
                                            static_cast<__nv_bfloat16*>(dq), n_acc4, tq, n_qt,
                                            n_heads);
  return static_cast<int>(cudaGetLastError());
}
