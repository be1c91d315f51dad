// Decode-step attention over flat K/V caches (K2) for Hopper.
//
// Replaces: kotoba_whisper_tpu/ops/decode_attention.py `_kernel` (called
// through `decode_attention_flat`), and covers what the TPU main path
// actually ran in its place, `decode_attention_reference`: int8 or int4
// K/V with scales folded into the scores (k_scale) and the softmax weights
// (v_scale), a lockstep scalar or per-row (B,) valid length. Five K/V
// modes: bf16; int8 with fp32 per-row scales; int8 with bf16 per-head
// scales (the int4 cache's self K/V); int4 packed two a byte with bf16
// per-head scales (its cross K/V); fp32 (an fp32 model's compute cache).
// q and the output are bf16 with the first four, and fp32 (the fp32 form:
// an fp32 model's step, every sum fp32 as before) with the last three and
// fp32 K/V. Two kernels: the head kernel (`head_kernel`: packed int4, and
// int8 with fp32 row scales under fp32 q) and the row kernel
// (`decode_kernel`, every other mode).
//
// What bounds it on the card: one query row per batch element against a
// (B, T, H*64) cache, so every K/V byte is read once and used for one
// multiply-add: ~0.5-1 flop per byte, far below the ridge. The cross-
// attention call (T=1500) is bound by the bytes of K and V (61 MB in int8
// at B=16, about 18 us at 3.35 TB/s; 31 MB of int4 codes and 1.9 MB of
// scales, about 10 us). The self-attention call does not come here: its
// caches (at most 448 slots) take K2's self form, the ring kernel of
// decode_attention_ring.cu with key j at slot j (ops/decode_attention.py
// `self_form`).
//
// Design: two kernels, each one launch a call.
//
// The row kernel: T is split over a thread-block
// cluster of up to 8 CTAs per batch row (ops/decode_attention.py
// `split_plan`: 8 x 188 rows at T=1500, 128 CTAs at B=16). A CTA's rows of
// a batch row are contiguous in the (B, T, H*64) cache, so one producer
// warp streams them with 1-D bulk copies (cp.async.bulk, counted on
// mbarriers) through a 4-stage ring of 20 KB: its K rows, then its V rows,
// keeping ~60 KB in flight per CTA (3 stages with per-head scales, whose
// bf16 values a (row, head) then take shared memory). Ten consumer warps
// each own one 16-byte chunk of a row (a quarter of a head in int8, an
// eighth in bf16) and a group of rows, so every consumer thread works in
// both phases and the lanes sharing a head reduce by shuffles. int8
// becomes fp32 by a byte permute into the mantissa of 2^23 and one
// subtraction (the I2F pipe alone would take ~15 us at B=16), and all
// arithmetic stays fp32. The scores of a CTA's rows (<= 188 x 20) stay in
// shared memory, so the CTA's softmax takes its exact max before any
// exponential (no online rescaling); the weights carry v_scale into the V
// pass. The CTAs of a cluster then combine through distributed shared
// memory: each sends its weighted V sums for a slice of the output columns
// to the CTA that owns the slice, and its per-head max and sum to all, and
// after one cluster barrier each owner writes its slice: no fp32 partials
// in device memory and no second launch. An fp32 row of 20 heads is 5120
// bytes: a stage holds 4 rows, and a thread's chunk is 32 bytes (an eighth
// of a head), so the fp32 form keeps the bf16 form's lanes and groups.
//
// The head kernel (ops/decode_attention.py `head_plan`): the row kernel
// gave int4 128 CTAs of 11 warps at B=16, one an SM, each in strict phases
// behind a prologue of plain scale loads, and read 0.0468 ms (int8: 0.0389)
// though int4 moves half the bytes. Here a CTA takes one (key share, group
// of up to 4 heads, batch row), and the plan gives the card about three
// CTAs an SM (4 shares of 375 rows x 5 groups x 16 rows = 320 CTAs at the
// cross call): on an H100 80GB HBM3 at 700 W 320-400 int4 CTAs read
// 0.0233-0.0235 ms there, 640 0.0259 and 160 0.0345; int8 under fp32 q
// 0.0261-0.0271 against the row kernel's 0.0393-0.0398 (bytes: 0.0184).
// A producer warp streams the group's head columns of its rows (32 bytes a
// head in int4, 64 in int8) with 3-D TMA boxes (64 rows, zero-filled past
// T; no swizzle) through a ring of boxes, K's then V's (int4: 32 KB; int8:
// 4 boxes, 64 KB at 4 heads), and its lanes copy
// the rows' scales (int4: the aligned 4-byte words that hold the group's
// bf16s, since a (rows, H) bf16 tensor's 40-byte rows admit no TMA box;
// int8: one fp32 a row) with cp.asyncs counted on their own mbarrier, off
// the scores' path: the K pass keeps raw dot products and the softmax pass
// applies k_scale. Four consumer warps give each thread a chunk of 16 codes
// (a quarter of a head: 8 bytes of int4, 16 of int8) of a row and a group
// of rows, as the row kernel does. int4: a word's nibbles i and i + 4, XOR
// 8, become bf16x2 (128 + code + 8) by one LOP3 into 0x4308 and one bf16x2
// FMA subtracts 136 (exact), each half an fp32 by a shift or a mask, in the
// pairs' order; int8: the row kernel's byte permute into 2^23's mantissa
// and one subtraction. The products are fp32 FMAs against q (fp32,
// pre-scaled by 1/8 log2(e), in the chunk's order): scores and weights stay
// fp32, the row kernel's arithmetic. The shares of a (row, group) combine
// over a cluster's distributed shared memory as the row kernel's do.
#include <type_traits>

#include "card.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kHD = 64;               // head dim
constexpr int kConsumerWarps = 10;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStageBytes = 20480;  // (ops/decode_attention.py PREFIX_STAGE_BYTES)
constexpr int kMaxCluster = 8;  // CTAs per batch row (ops/decode_attention.py MAX_CLUSTER)
constexpr float kLog2e = 1.4426950408889634f;

// Copy stages of a CTA: 3 with per-head scales, 4 without.
template <bool kHeads>
constexpr int kStagesOf = kHeads ? 3 : 4;

// Shared memory of one CTA: the copy ring (reused for the row groups' V
// sums once the ring is drained), the scores/weights of its rows, its K/V
// scales (an fp32 a row, or a bf16 a (row, head)), its per-head max and
// sum, what the cluster's CTAs send it for its slice of the output (their
// weighted V sums, maxes and sums), and the barriers.
// ops/decode_attention.py `prefix_smem_bytes` mirrors `total`.
struct Layout {
  int ring, scores, k_scale, v_scale, m, l, recv_acc, recv_m, recv_l, bars, total;
  __host__ __device__ Layout(int rows, int n_heads, int d, int stages, bool heads) {
    const int scale_row = heads ? 2 * n_heads : 4;  // bytes of a row's scale
    ring = 0;
    scores = ring + stages * kStageBytes;
    k_scale = scores + 4 * rows * n_heads;
    v_scale = k_scale + scale_row * rows;
    m = (v_scale + scale_row * rows + 3) & ~3;
    l = m + 4 * n_heads;
    recv_acc = l + 4 * n_heads;                    // (ranks, slice), <= d + ranks
    recv_m = recv_acc + 4 * (d + kMaxCluster);     // (ranks, H)
    recv_l = recv_m + 4 * kMaxCluster * n_heads;   // (ranks, H)
    bars = (recv_l + 4 * kMaxCluster * n_heads + 7) & ~7;
    total = bars + 8 * 2 * stages;
  }
};

// KV: int8_t, __nv_bfloat16 or float (the element type of the cache's
// rows); kHeads: bf16 (B, T, H) scales, else fp32 (B, T) or none
// (bf16, fp32); QT: q's and the output's type, bf16 or float.
template <typename KV, bool kHeads, typename QT>
__global__ void __launch_bounds__(kThreads, 2)
    decode_kernel(const QT* __restrict__ q, long q_stride,
                  const uint8_t* __restrict__ k, const uint8_t* __restrict__ v,
                  const void* __restrict__ k_scale, const void* __restrict__ v_scale,
                  const int* __restrict__ valid_rows, int valid_all,
                  QT* __restrict__ out, int t_cap, int n_heads, int rows_per_cta) {
  using C = Chunk<KV>;
  constexpr int kElems = C::kElems;
  constexpr int kLanesPerHead = kHD / kElems;  // 4 (int8) or 8 (bf16, fp32)
  constexpr int kStages = kStagesOf<kHeads>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int d = n_heads * kHD;
  const Layout lay(rows_per_cta, n_heads, d, kStages, kHeads);
  uint8_t* ring = smem + lay.ring;
  float* sc = reinterpret_cast<float*>(smem + lay.scores);  // (rows, H)
  // scales: fp32 a row, or bf16 a (row, head)
  float* ks_s = reinterpret_cast<float*>(smem + lay.k_scale);
  float* vs_s = reinterpret_cast<float*>(smem + lay.v_scale);
  __nv_bfloat16* ks_h = reinterpret_cast<__nv_bfloat16*>(smem + lay.k_scale);
  __nv_bfloat16* vs_h = reinterpret_cast<__nv_bfloat16*>(smem + lay.v_scale);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* recv_acc = reinterpret_cast<float*>(smem + lay.recv_acc);
  float* recv_m = reinterpret_cast<float*>(smem + lay.recv_m);
  float* recv_l = reinterpret_cast<float*>(smem + lay.recv_l);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x, n_ranks = gridDim.x, b = blockIdx.y;
  const int per_rank = (d + n_ranks - 1) / n_ranks;  // output columns of each CTA
  const int valid = min(valid_rows ? valid_rows[b] : valid_all, t_cap);
  const int t0 = rank * rows_per_cta;
  const int n_rows = max(min(t0 + rows_per_cta, valid) - t0, 0);
  const long row0 = (long)b * t_cap + t0;
  const int row_bytes = d * C::kBits / 8;
  const int stage_rows = kStageBytes / row_bytes;
  const int n_chunks = (n_rows + stage_rows - 1) / stage_rows;  // per tensor

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
  // the cluster's CTAs write into each other's shared memory at the end;
  // this arrival, waited for before the first such write, proves all of
  // them started
  cluster_arrive_relaxed();

  if (warp == kConsumerWarps) {
    // ---- producer: K rows, then V rows, through the ring ------------------
    if (lane == 0) {
      for (int i = 0; i < 2 * n_chunks; ++i) {
        const int st = i % kStages, c = i < n_chunks ? i : i - n_chunks;
        const int r0 = c * stage_rows, n = min(stage_rows, n_rows - r0);
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], n * row_bytes);
        bulk_load(ring + st * kStageBytes, (i < n_chunks ? k : v) + (row0 + r0) * row_bytes,
                  n * row_bytes, &full[st]);
      }
    }
    __syncwarp();
    cluster_wait();
  } else {
    // ---- consumers: thread -> (chunk of a row, group of rows) ---------------
    const int n_cols = d / kElems;                 // chunks per row
    const int n_groups = kConsumers / n_cols;      // row groups (>= 1)
    const int col = tid % n_cols, grp = tid / n_cols;
    const bool active = grp < n_groups;
    const int h = col / kLanesPerHead;
    float qr[kElems];  // this chunk of q, pre-scaled by 1/sqrt(64) * log2(e)
    {
      const QT* qp = q + (long)b * q_stride + col * kElems;
#pragma unroll
      for (int e = 0; e < kElems; ++e) qr[e] = active ? to_f32(qp[e]) * (0.125f * kLog2e) : 0.f;
    }
    if (kHeads) {  // the CTA's rows' scales are contiguous: (rows, H)
      const __nv_bfloat16* ksg = static_cast<const __nv_bfloat16*>(k_scale) + row0 * n_heads;
      const __nv_bfloat16* vsg = static_cast<const __nv_bfloat16*>(v_scale) + row0 * n_heads;
      // kBatch loads of each in flight a thread before any store (188 x 20
      // at T=1500 take one batch), not one round trip a value
      constexpr int kBatch = 16;
      const int n = n_rows * n_heads;
      for (int i0 = tid; i0 < n; i0 += kBatch * kConsumers) {
        __nv_bfloat16 a[kBatch], c[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * kConsumers;
          if (i < n) {
            a[j] = ksg[i];
            c[j] = vsg[i];
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int i = i0 + j * kConsumers;
          if (i < n) {
            ks_h[i] = a[j];
            vs_h[i] = c[j];
          }
        }
      }
    } else {
      for (int r = tid; r < n_rows; r += kConsumers) {
        ks_s[r] = k_scale ? static_cast<const float*>(k_scale)[row0 + r] : 1.f;
        vs_s[r] = v_scale ? static_cast<const float*>(v_scale)[row0 + r] : 1.f;
      }
    }
    named_bar_sync(1, kConsumers);

    // scores (log2 units) of every row of this CTA, per head
    for (int i = 0; i < n_chunks; ++i) {
      const int st = i % kStages, r0 = i * stage_rows, n = min(stage_rows, n_rows - r0);
      mbar_wait(&full[st], (i / kStages) & 1);
      const uint8_t* tile = ring + st * kStageBytes;
      // the same trip count in every lane: the shuffles take the whole warp
      for (int it = 0; it < (n + n_groups - 1) / n_groups; ++it) {
        const int r = grp + it * n_groups;
        float part = 0.f;
        if (active && r < n) {
          float x[kElems];
          C::load(tile + (long)r * row_bytes + col * C::kBytes, x);
#pragma unroll
          for (int e = 0; e < kElems; ++e) part = fmaf(x[e], qr[e], part);
        }
#pragma unroll
        for (int off = kLanesPerHead / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (active && r < n && col % kLanesPerHead == 0)
          sc[(r0 + r) * n_heads + h] =
              part * (kHeads ? __bfloat162float(ks_h[(r0 + r) * n_heads + h]) : ks_s[r0 + r]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    named_bar_sync(1, kConsumers);

    // the CTA's exact per-head max, weights p * v_scale, and sums (an empty
    // CTA, all its rows past valid, keeps m = -inf and l = 0)
    for (int hh = warp; hh < n_heads; hh += kConsumerWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < n_rows; r += 32) mx = fmaxf(mx, sc[r * n_heads + hh]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int r = lane; r < n_rows; r += 32) {
        const float p = ex2(sc[r * n_heads + hh] - mx);
        sum += p;
        sc[r * n_heads + hh] =
            p * (kHeads ? __bfloat162float(vs_h[r * n_heads + hh]) : vs_s[r]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        m_s[hh] = mx;
        l_s[hh] = sum;
      }
    }
    named_bar_sync(1, kConsumers);

    // weighted V sums of this thread's chunk over its row group
    float acc[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] = 0.f;
    for (int i = 0; i < n_chunks; ++i) {
      const int j = n_chunks + i, st = j % kStages;
      const int r0 = i * stage_rows, n = min(stage_rows, n_rows - r0);
      mbar_wait(&full[st], (j / kStages) & 1);
      const uint8_t* tile = ring + st * kStageBytes;
      if (active) {
        for (int r = grp; r < n; r += n_groups) {
          const float w = sc[(r0 + r) * n_heads + h];
          float x[kElems];
          C::load(tile + (long)r * row_bytes + col * C::kBytes, x);
#pragma unroll
          for (int e = 0; e < kElems; ++e) acc[e] = fmaf(w, x[e], acc[e]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // the drained ring holds the row groups' sums
    named_bar_sync(1, kConsumers);
    float* red = reinterpret_cast<float*>(ring);  // (n_groups, d)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the bulk copies
    if (active) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) red[grp * d + col * kElems + e] = acc[e];
    }
    named_bar_sync(1, kConsumers);
    // send each column's sum to the CTA that owns its output slice, and
    // this CTA's per-head max and sum to every CTA
    cluster_wait();
    for (int c = tid; c < d; c += kConsumers) {
      float s = 0.f;
      for (int g = 0; g < n_groups; ++g) s += red[g * d + c];
      const int owner = c / per_rank;
      st_cluster(recv_acc + rank * per_rank + c - owner * per_rank, owner, s);
    }
    for (int i = tid; i < n_ranks * n_heads; i += kConsumers) {
      const int dst = i / n_heads, hh = i - dst * n_heads;
      st_cluster(recv_m + rank * n_heads + hh, dst, m_s[hh]);
      st_cluster(recv_l + rank * n_heads + hh, dst, l_s[hh]);
    }
  }
  // ---- combine: each CTA writes its slice of the output from what it was
  // sent; after this barrier no CTA touches another's shared memory
  cluster_sync();
  if (warp != kConsumerWarps) {
    const int c0 = rank * per_rank;
    for (int c = c0 + tid; c < min(d, c0 + per_rank); c += kConsumers) {
      const int hh = c / kHD;
      float mx = -INFINITY;
      for (int r = 0; r < n_ranks; ++r) mx = fmaxf(mx, recv_m[r * n_heads + hh]);
      float l = 0.f, o = 0.f;
      if (mx != -INFINITY) {
        for (int r = 0; r < n_ranks; ++r) {
          const float f = ex2(recv_m[r * n_heads + hh] - mx);  // 0 for an empty CTA
          l = fmaf(recv_l[r * n_heads + hh], f, l);
          o = fmaf(recv_acc[r * per_rank + c - c0], f, o);
        }
      }
      out[(long)b * d + c] = from_f32<QT>(l > 0.f ? o / l : 0.f);
    }
  }
}

template <typename KV, bool kHeads, typename QT>
int launch(int card, const void* q, long q_stride, const void* k, const void* v,
           const void* k_scale, const void* v_scale, const void* valid_rows, int valid_all,
           void* out, int batch, int t_cap, int n_heads, int n_ctas, int rows_per_cta,
           cudaStream_t stream) {
  const int d = n_heads * kHD;
  const Layout lay(rows_per_cta, n_heads, d, kStagesOf<kHeads>, kHeads);
  // per card: the largest shared-memory size opted into there
  static int configured_of[kwt_card::kMaxCards] = {};
  int& configured = configured_of[card];
  if (configured < lay.total) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<KV, kHeads, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = lay.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ctas, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, decode_kernel<KV, kHeads, QT>, static_cast<const QT*>(q), q_stride,
      static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v), k_scale, v_scale,
      static_cast<const int*>(valid_rows), valid_all, static_cast<QT*>(out), t_cap,
      n_heads, rows_per_cta));
}

// ---- the head kernel (packed int4; int8 with fp32 row scales) -----------------

constexpr int kHeadConsumers = 128;                // four consumer warps
constexpr int kHeadThreads = kHeadConsumers + 32;  // + the producer warp
constexpr int kHeadBox = 64;  // rows a TMA box (ops/decode_attention.py HEAD_BOX)
constexpr int kHeadInt4Ring = 32768;  // bytes of the int4 copy ring (HEAD_INT4_RING)

// Nibbles j and j + 4 of w as bf16x2 codes (nibble j low), exactly: each
// nibble XOR 8 in the mantissa of bf16 128 (ulp 1) is 128 + code + 8, and
// one bf16x2 FMA subtracts 136.
__device__ __forceinline__ uint32_t int4_pair(uint32_t w, int j) {
  const uint32_t x = ((w >> (4 * j)) & 0x000F000Fu) ^ 0x43084308u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(x), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Codes of an 8-byte chunk (columns 0..15) as fp32 in the pairs' order:
// x[8 wd + 2 j] is column 8 wd + j, x[8 wd + 2 j + 1] column 8 wd + j + 4.
__device__ __forceinline__ void int4_chunk(uint2 raw, float* x) {
  const uint32_t w[2] = {raw.x, raw.y};
#pragma unroll
  for (int wd = 0; wd < 2; ++wd)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t p = int4_pair(w[wd], j);
      x[8 * wd + 2 * j] = __uint_as_float(p << 16);
      x[8 * wd + 2 * j + 1] = __uint_as_float(p & 0xFFFF0000u);
    }
}
// Column (of a head's 16-column quarter) that element e of a chunk holds.
__device__ __forceinline__ int int4_col(int e) { return (e & 8) | ((e & 7) >> 1) | ((e & 1) << 2); }

// The head kernel's K/V codes: the bytes of a head's 64 columns, the boxes
// of the copy ring and the 4-byte scale words of a row and tensor for a CTA
// of hg heads, and a 16-code chunk (a quarter of a head) as fp32 with the
// column each element holds. Packed int4: kHeadInt4Ring bytes of boxes,
// 8-byte chunks in the pairs' order, bf16 (B, T, H) scales copied as the
// aligned words that hold a row's hg bf16s (a (rows, H) bf16 tensor's
// 40-byte rows admit no TMA box). int8: 4 boxes (HEAD_INT8_STAGES),
// 16-byte chunks in order, by the row kernel's 2^23 permute, and one fp32
// (B, T, 1) scale a row.
template <typename KV>
struct HeadCodes;
template <>
struct HeadCodes<Int4> {
  static constexpr int kHeadBytes = 32;
  __host__ __device__ static constexpr int stages(int hg) {
    return kHeadInt4Ring / (kHeadBox * hg * kHeadBytes);
  }
  __host__ __device__ static constexpr int words(int hg) { return hg / 2 + 1; }
  __device__ __forceinline__ static void load(const uint8_t* p, float* x) {
    int4_chunk(*reinterpret_cast<const uint2*>(p), x);
  }
  __device__ __forceinline__ static int col(int e) { return int4_col(e); }
};
template <>
struct HeadCodes<int8_t> {
  static constexpr int kHeadBytes = 64;
  __host__ __device__ static constexpr int stages(int) { return 4; }
  __host__ __device__ static constexpr int words(int) { return 1; }
  __device__ __forceinline__ static void load(const uint8_t* p, float* x) {
    Chunk<int8_t>::load(p, x);
  }
  __device__ __forceinline__ static int col(int e) { return e; }
};

// Shared memory of a head CTA over `rows` cache rows of `hg` heads: the copy
// ring of `stages` boxes (reused for the row groups' V sums once drained),
// the raw scores of (row, head), each row's `words` scale words a tensor,
// the per-head max and sum, what the cluster's CTAs send it, the barriers
// (full and empty a stage, then the scales'). ops/decode_attention.py
// `head_smem_bytes` mirrors `total`.
struct HeadLayout {
  int ring, scores, k_scale, v_scale, m, l, recv_acc, recv_m, recv_l, bars, total;
  __host__ __device__ HeadLayout(int rows, int hg, int words, int ring_bytes, int stages) {
    ring = 0;
    scores = ring + ring_bytes;
    k_scale = scores + 4 * rows * hg;
    v_scale = k_scale + 4 * words * rows;
    m = v_scale + 4 * words * rows;
    l = m + 4 * hg;
    recv_acc = l + 4 * hg;                         // (ranks, slice), <= hg * 64 + ranks
    recv_m = recv_acc + 4 * (hg * kHD + kMaxCluster);
    recv_l = recv_m + 4 * kMaxCluster * hg;        // (ranks, hg)
    bars = (recv_l + 4 * kMaxCluster * hg + 7) & ~7;
    total = bars + 8 * (2 * stages + 1);
  }
};

// KV: Int4 or int8_t (HeadCodes); QT: q's and the output's type; kHG: heads
// a CTA (4, 2 or 1).
template <typename KV, typename QT, int kHG>
__global__ void __launch_bounds__(kHeadThreads)
    head_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const QT* __restrict__ q, long q_stride, const void* __restrict__ k_scale,
                const void* __restrict__ v_scale, const int* __restrict__ valid_rows,
                int valid_all, QT* __restrict__ out, int t_cap, int n_heads, int rows_per_cta) {
  using Codes = HeadCodes<KV>;
  constexpr bool kInt4 = std::is_same<KV, Int4>::value;
  constexpr int kStages = Codes::stages(kHG);      // boxes of the copy ring
  constexpr int kCols = kHG * 4;                   // 16-code chunks of a row
  constexpr int kGroups = kHeadConsumers / kCols;  // row groups
  constexpr int kChunkBytes = Codes::kHeadBytes / 4;
  constexpr int kRowBytes = kHG * Codes::kHeadBytes;
  constexpr int kBoxBytes = kHeadBox * kRowBytes;
  constexpr int kWords = Codes::words(kHG);        // scale words a row and tensor
  constexpr int kOut = kHG * kHD;                  // output columns of the group
  extern __shared__ __align__(128) uint8_t smem[];
  const HeadLayout lay(rows_per_cta, kHG, kWords, kStages * kBoxBytes, kStages);
  uint8_t* ring = smem + lay.ring;
  float* sc = reinterpret_cast<float*>(smem + lay.scores);  // (rows, kHG)
  uint32_t* ks_w = reinterpret_cast<uint32_t*>(smem + lay.k_scale);  // (rows, kWords)
  uint32_t* vs_w = reinterpret_cast<uint32_t*>(smem + lay.v_scale);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* recv_acc = reinterpret_cast<float*>(smem + lay.recv_acc);
  float* recv_m = reinterpret_cast<float*>(smem + lay.recv_m);
  float* recv_l = reinterpret_cast<float*>(smem + lay.recv_l);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kStages;
  uint64_t* scale_bar = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x, n_ranks = gridDim.x, h0 = blockIdx.y * kHG, b = blockIdx.z;
  const int per_rank = (kOut + n_ranks - 1) / n_ranks;  // output columns of each CTA
  const int valid = min(valid_rows ? valid_rows[b] : valid_all, t_cap);
  const int t0 = rank * rows_per_cta;
  const int n_rows = max(min(t0 + rows_per_cta, valid) - t0, 0);
  const int n_boxes = (n_rows + kHeadBox - 1) / kHeadBox;  // per tensor

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kHeadConsumers / 32);
    }
    mbar_init(scale_bar, 32);
    fence_barrier_init();
  }
  __syncthreads();
  // the cluster's CTAs write into each other's shared memory at the end;
  // this arrival, waited for before the first such write, proves all of
  // them started
  cluster_arrive_relaxed();

  if (warp == kHeadConsumers / 32) {
    // ---- producer: the first boxes, the scales, then the rest of the boxes
    auto issue = [&](int i) {
      const int st = i % kStages, c = i < n_boxes ? i : i - n_boxes;
      mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[st], kBoxBytes);
      tma_load_3d(ring + st * kBoxBytes, i < n_boxes ? &tm_k : &tm_v, &full[st],
                  h0 * Codes::kHeadBytes, t0 + c * kHeadBox, b);
    };
    const int first = min(kStages, 2 * n_boxes);
    if (lane == 0)
      for (int i = 0; i < first; ++i) issue(i);
    __syncwarp();
    if constexpr (kInt4) {
      // the aligned words holding bf16s f0 .. f0 + kHG - 1 of a row, f0 =
      // (b T + t) H + h0; a word's second half is past the tensor only for
      // the last element, at an even index
      const long n_scales = (long)gridDim.z * t_cap * n_heads;
      for (int i = lane; i < n_rows * kWords; i += 32) {
        const int r = i / kWords, wd = i - r * kWords;
        const long f0 = ((long)b * t_cap + t0 + r) * n_heads + h0;
        const long el = (f0 & ~1L) + 2 * wd;
        const int bytes = el > f0 + kHG - 1 ? 0 : el + 1 < n_scales ? 4 : 2;
        cp_async4(&ks_w[i], static_cast<const __nv_bfloat16*>(k_scale) + el, bytes);
        cp_async4(&vs_w[i], static_cast<const __nv_bfloat16*>(v_scale) + el, bytes);
      }
    } else {
      // one fp32 a row, shared by the row's heads (a share's span starts
      // 4-byte aligned only: 4-byte copies)
      const long f0 = (long)b * t_cap + t0;
      for (int r = lane; r < n_rows; r += 32) {
        cp_async4(&ks_w[r], static_cast<const float*>(k_scale) + f0 + r);
        cp_async4(&vs_w[r], static_cast<const float*>(v_scale) + f0 + r);
      }
    }
    cp_async_mbar_arrive_noinc(scale_bar);
    if (lane == 0)
      for (int i = first; i < 2 * n_boxes; ++i) issue(i);
    __syncwarp();
    cluster_wait();
  } else {
    // ---- consumers: thread -> (16-code chunk of a row, group of rows) -----
    const int col = tid % kCols, grp = tid / kCols, hh = col / 4;
    float qr[16];  // this quarter of head h0 + hh in the chunk's order, times 1/8 log2(e)
    {
      const QT* qp = q + (long)b * q_stride + (h0 + hh) * kHD + (col % 4) * 16;
#pragma unroll
      for (int e = 0; e < 16; ++e) qr[e] = to_f32(qp[Codes::col(e)]) * (0.125f * kLog2e);
    }
    // raw dot products (log2 units) of every row of this CTA, per head
    for (int i = 0; i < n_boxes; ++i) {
      const int st = i % kStages, r0 = i * kHeadBox, n = min(kHeadBox, n_rows - r0);
      mbar_wait(&full[st], (i / kStages) & 1);
      const uint8_t* tile = ring + st * kBoxBytes;
      // the same trip count in every lane: the shuffles take the whole warp
      for (int it = 0; it < (n + kGroups - 1) / kGroups; ++it) {
        const int r = grp + it * kGroups;
        float part = 0.f;
        if (r < n) {
          float x[16];
          Codes::load(tile + r * kRowBytes + col * kChunkBytes, x);
#pragma unroll
          for (int e = 0; e < 16; ++e) part = fmaf(x[e], qr[e], part);
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (r < n && col % 4 == 0) sc[(r0 + r) * kHG + hh] = part;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    mbar_wait(scale_bar, 0);
    named_bar_sync(1, kHeadConsumers);

    // the CTA's exact per-head max, weights p * v_scale, and sums (an empty
    // CTA, all its rows past valid, keeps m = -inf and l = 0)
    for (int g = warp; g < kHG; g += kHeadConsumers / 32) {
      // int4: head h0 + g of row r is bf16 (f0 & 1) + g of the row's scale
      // words; int8: the row's one fp32
      auto scale = [&](const uint32_t* words, int r) {
        if constexpr (kInt4) {
          const int slot = (int)((((long)b * t_cap + t0 + r) * n_heads + h0) & 1) + g;
          return __bfloat162float(
              reinterpret_cast<const __nv_bfloat16*>(words + r * kWords)[slot]);
        } else {
          return __uint_as_float(words[r]);
        }
      };
      float mx = -INFINITY;
      for (int r = lane; r < n_rows; r += 32) {
        const float s = sc[r * kHG + g] * scale(ks_w, r);
        sc[r * kHG + g] = s;
        mx = fmaxf(mx, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int r = lane; r < n_rows; r += 32) {
        const float p = ex2(sc[r * kHG + g] - mx);
        sum += p;
        sc[r * kHG + g] = p * scale(vs_w, r);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        m_s[g] = mx;
        l_s[g] = sum;
      }
    }
    named_bar_sync(1, kHeadConsumers);

    // weighted V sums of this thread's chunk over its row group
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    for (int i = 0; i < n_boxes; ++i) {
      const int j = n_boxes + i, st = j % kStages;
      const int r0 = i * kHeadBox, n = min(kHeadBox, n_rows - r0);
      mbar_wait(&full[st], (j / kStages) & 1);
      const uint8_t* tile = ring + st * kBoxBytes;
      for (int r = grp; r < n; r += kGroups) {
        const float w = sc[(r0 + r) * kHG + hh];
        float x[16];
        Codes::load(tile + r * kRowBytes + col * kChunkBytes, x);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = fmaf(w, x[e], acc[e]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // the drained ring holds the row groups' sums, (kGroups, kOut) in the
    // chunks' order
    named_bar_sync(1, kHeadConsumers);
    float* red = reinterpret_cast<float*>(ring);
    fence_proxy_async_smem();  // after the TMA copies
#pragma unroll
    for (int e = 0; e < 16; e += 4)
      *reinterpret_cast<float4*>(&red[grp * kOut + col * 16 + e]) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    named_bar_sync(1, kHeadConsumers);
    // send each column's sum to the CTA that owns its output slice, and
    // this CTA's per-head max and sum to every CTA
    cluster_wait();
    for (int c = tid; c < kOut; c += kHeadConsumers) {
      float s = 0.f;
      for (int g = 0; g < kGroups; ++g) s += red[g * kOut + c];
      const int owner = c / per_rank;
      st_cluster(recv_acc + rank * per_rank + c - owner * per_rank, owner, s);
    }
    for (int i = tid; i < n_ranks * kHG; i += kHeadConsumers) {
      const int dst = i / kHG, g = i - dst * kHG;
      st_cluster(recv_m + rank * kHG + g, dst, m_s[g]);
      st_cluster(recv_l + rank * kHG + g, dst, l_s[g]);
    }
  }
  // ---- combine: each CTA writes its slice of the output from what it was
  // sent; after this barrier no CTA touches another's shared memory
  cluster_sync();
  if (warp != kHeadConsumers / 32) {
    const int c0 = rank * per_rank;
    for (int c = c0 + tid; c < min(kOut, c0 + per_rank); c += kHeadConsumers) {
      const int g = c / kHD;  // column c is chunk c / 16's element c % 16
      float mx = -INFINITY;
      for (int r = 0; r < n_ranks; ++r) mx = fmaxf(mx, recv_m[r * kHG + g]);
      float l = 0.f, o = 0.f;
      if (mx != -INFINITY) {
        for (int r = 0; r < n_ranks; ++r) {
          const float f = ex2(recv_m[r * kHG + g] - mx);  // 0 for an empty CTA
          l = fmaf(recv_l[r * kHG + g], f, l);
          o = fmaf(recv_acc[r * per_rank + c - c0], f, o);
        }
      }
      const int dim = (c & ~15) + Codes::col(c & 15);
      out[(long)b * n_heads * kHD + h0 * kHD + dim] = from_f32<QT>(l > 0.f ? o / l : 0.f);
    }
  }
}

// 3-D map (H * head bytes, T, B) of a (B, T, H * head bytes) byte cache:
// boxes of hg heads' columns x kHeadBox rows, unswizzled, zero-filled past T.
bool make_head_map(CUtensorMap* map, const void* base, int batch, int t_cap, int n_heads,
                   int head_bytes, int hg) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = (cuuint64_t)n_heads * head_bytes;
  const cuuint64_t dims[3] = {row, (cuuint64_t)t_cap, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {row, row * t_cap};
  const cuuint32_t box[3] = {(cuuint32_t)(hg * head_bytes), kHeadBox, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename KV, typename QT, int kHG>
int launch_heads(int card, const void* q, long q_stride, const void* k, const void* v,
                 const void* k_scale, const void* v_scale, const void* valid_rows, int valid_all,
                 void* out, int batch, int t_cap, int n_heads, int shares, int rows_per_cta,
                 int kv_mode, cudaStream_t stream) {
  using Codes = HeadCodes<KV>;
  constexpr int kStages = Codes::stages(kHG);
  // a decode loop's cross caches (one a layer) live across its steps
  CUtensorMap tk, tv;
  auto map_of = [&](const void* base) {
    return [=](CUtensorMap* m) {
      return make_head_map(m, base, batch, t_cap, n_heads, Codes::kHeadBytes, kHG);
    };
  };
  if (!cached_tmap(&tk, {k, {batch, t_cap, n_heads, kHG, kv_mode}}, map_of(k)) ||
      !cached_tmap(&tv, {v, {batch, t_cap, n_heads, kHG, kv_mode}}, map_of(v)))
    return static_cast<int>(cudaErrorInvalidValue);
  const HeadLayout lay(rows_per_cta, kHG, Codes::words(kHG),
                       kStages * kHeadBox * kHG * Codes::kHeadBytes, kStages);
  // per card: the largest shared-memory size opted into there
  static int configured_of[kwt_card::kMaxCards] = {};
  int& configured = configured_of[card];
  if (configured < lay.total) {
    const cudaError_t err = cudaFuncSetAttribute(
        head_kernel<KV, QT, kHG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        lay.total);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = lay.total;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shares, n_heads / kHG, batch);
  cfg.blockDim = dim3(kHeadThreads);
  cfg.dynamicSmemBytes = lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = shares;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, head_kernel<KV, QT, kHG>, tk, tv, static_cast<const QT*>(q), q_stride,
      k_scale, v_scale, static_cast<const int*>(valid_rows), valid_all, static_cast<QT*>(out),
      t_cap, n_heads, rows_per_cta));
}

}  // namespace

// q (B, H*64) bf16, or fp32 where q_f32 is set, rows q_stride elements
// apart (a row of a fused qkv projection is read in place); k/v (B, T,
// H*64) by kv_mode (ops/decode_attention.py KV_*): 0 bf16, no scales; 1
// int8 with fp32 (B, T) scales (nullable); 2 int8 with bf16 (B, T, H)
// scales; 4 fp32, no scales (packed int4, mode 3, and mode 1 under fp32 q
// take kwt_decode_attention_heads). bf16 q takes modes 0-2, fp32 q modes 2
// and 4.
// valid_rows (B,) int32 or null, then valid_all applies to every row. One
// cluster of n_ctas CTAs (<= 8) per batch row, each over rows_per_cta cache
// rows (the split plan of ops/decode_attention.py). out (B, H*64) in q's
// type. Returns the launch's cudaError_t (cudaErrorInvalidValue for a mode
// it lacks).
extern "C" int kwt_decode_attention(int card, const void* q, long long q_stride,
                                    const void* k, const void* v, const void* k_scale,
                                    const void* v_scale, const void* valid_rows, int valid_all,
                                    void* out, int batch, int t_cap, int n_heads, int n_ctas,
                                    int rows_per_cta, int kv_mode, int q_f32, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long qs = (long)q_stride;
#define KWT_LAUNCH(KV, HEADS, QT)                                                              \
  return launch<KV, HEADS, QT>(card, q, qs, k, v, k_scale, v_scale, valid_rows, valid_all, out, \
                               batch, t_cap, n_heads, n_ctas, rows_per_cta, s)
  if (q_f32) {
    switch (kv_mode) {
      case 2: KWT_LAUNCH(int8_t, true, float);
      case 4: KWT_LAUNCH(float, false, float);
    }
  } else {
    switch (kv_mode) {
      case 0: KWT_LAUNCH(__nv_bfloat16, false, __nv_bfloat16);
      case 1: KWT_LAUNCH(int8_t, false, __nv_bfloat16);
      case 2: KWT_LAUNCH(int8_t, true, __nv_bfloat16);
    }
  }
#undef KWT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The head kernel: packed int4 K/V (kv_mode 3), bytes (B, T, H*32), two
// columns a byte (models/whisper.py `pack_int4`), with bf16 (B, T, H)
// scales, 4-byte aligned; or int8 K/V (kv_mode 1), bytes (B, T, H*64),
// with fp32 (B, T, 1) scales. K/V 16-byte aligned. q (B, H*64) bf16, or
// fp32 where q_f32 is set, rows q_stride elements apart; valid_rows (B,)
// int32 or null, then valid_all applies to every row. The grid
// (ops/decode_attention.py `head_plan`): a cluster of `shares` CTAs (<= 8)
// per (batch row, group of heads_per_cta heads: 4, 2 or 1, dividing H),
// each over rows_per_cta cache rows. out (B, H*64) in q's type. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a mode or head group it
// lacks, or a map it cannot encode).
extern "C" int kwt_decode_attention_heads(int card, const void* q, long long q_stride,
                                          const void* k, const void* v, const void* k_scale,
                                          const void* v_scale, const void* valid_rows,
                                          int valid_all, void* out, int batch, int t_cap,
                                          int n_heads, int heads_per_cta, int shares,
                                          int rows_per_cta, int kv_mode, int q_f32, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  if (heads_per_cta < 1 || n_heads % heads_per_cta || shares < 1 || shares > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long qs = (long)q_stride;
#define KWT_HEADS(KV, QT, HG)                                                                  \
  if (heads_per_cta == HG)                                                                     \
  return launch_heads<KV, QT, HG>(card, q, qs, k, v, k_scale, v_scale, valid_rows, valid_all,  \
                                  out, batch, t_cap, n_heads, shares, rows_per_cta, kv_mode, s)
#define KWT_GROUPS(KV, QT)  \
  KWT_HEADS(KV, QT, 4);     \
  KWT_HEADS(KV, QT, 2);     \
  KWT_HEADS(KV, QT, 1)
  if (kv_mode == 3 && q_f32) {
    KWT_GROUPS(Int4, float);
  } else if (kv_mode == 3) {
    KWT_GROUPS(Int4, __nv_bfloat16);
  } else if (kv_mode == 1 && q_f32) {
    KWT_GROUPS(int8_t, float);
  } else if (kv_mode == 1) {
    KWT_GROUPS(int8_t, __nv_bfloat16);
  }
#undef KWT_GROUPS
#undef KWT_HEADS
  return static_cast<int>(cudaErrorInvalidValue);
}
