// Decode-step attention over flat K/V caches (K2) for Hopper.
//
// Replaces: kotoba_whisper_tpu/ops/decode_attention.py `_kernel` (called
// through `decode_attention_flat`), and covers what the TPU main path
// actually ran in its place, `decode_attention_reference`: int8 or int4
// K/V with scales folded into the scores (k_scale) and the softmax weights
// (v_scale), a lockstep scalar or per-row (B,) valid length. Five K/V
// modes, each its own instantiation: bf16; int8 with fp32 per-row scales;
// int8 with bf16 per-head scales (the int4 cache's self K/V); int4 packed
// two a byte with bf16 per-head scales (its cross K/V); fp32 (an fp32
// model's compute cache). q and the output are bf16 with the first four,
// and fp32 (the fp32 form: an fp32 model's step, every sum fp32 as before)
// with the last three and fp32 K/V.
//
// What bounds it on the card: one query row per batch element against a
// (B, T, H*64) cache, so every K/V byte is read once and used for one
// multiply-add: ~0.5-1 flop per byte, far below the ridge. The cross-
// attention call (T=1500) is bound by the bytes of K and V (61 MB in int8
// at B=16, about 18 us at 3.35 TB/s). The self-attention call does not
// come here: its caches (at most 448 slots) take K2's self form, the ring
// kernel of decode_attention_ring.cu with key j at slot j
// (ops/decode_attention.py `self_form`). This kernel gave such a cache one
// CTA per batch row, which read 0.0118 ms on the card at B=16, T=51, 20
// times its byte bound and 2.5x one scaled_dot_product_attention call: 16
// CTAs on 132 SMs, each over all 20 heads, and not the launch, held it.
//
// Design: one launch per call. T is split over a thread-block cluster of
// up to 8 CTAs per batch row (ops/decode_attention.py `split_plan`: 8 x 188
// rows at T=1500, 128 CTAs at B=16). A CTA's
// rows of a batch row are contiguous in the (B, T, H*64) cache, so one
// producer warp streams them with 1-D bulk copies (cp.async.bulk, counted
// on mbarriers) through a 4-stage ring of 20 KB: its K rows, then its V
// rows, keeping ~60 KB in flight per CTA (3 stages with per-head scales,
// whose bf16 values a (row, head) then take shared memory). Ten consumer
// warps each own one chunk of a row (16 bytes: a quarter of a head in
// int8, an eighth in bf16; 8 bytes in int4, a quarter of a head) and a
// group of rows, so every consumer thread works in both phases and the
// lanes sharing a head reduce by shuffles. int8 becomes fp32 by a byte
// permute into the mantissa of 2^23 and one subtraction, int4 by a nibble
// OR-ed into that mantissa (prmt or lop3 + fadd on the integer and FMA
// pipes; the I2F pipe alone would take ~15 us at B=16), and all arithmetic
// stays fp32. The scores of a CTA's rows (<= 188 x 20) stay
// in shared memory, so the CTA's softmax takes its exact max before any
// exponential (no online rescaling); the weights carry v_scale into the V
// pass. The CTAs of a cluster then combine through distributed shared
// memory: each sends its weighted V sums for a slice of the output columns
// to the CTA that owns the slice, and its per-head max and sum to all, and
// after one cluster barrier each owner writes its slice: no fp32 partials
// in device memory and no second launch. An fp32 row of 20 heads is 5120 bytes: a
// stage holds 4 rows, and a thread's chunk is 32 bytes (an eighth of a
// head), so the fp32 form keeps the bf16 form's lanes and groups.
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

// KV: int8_t, __nv_bfloat16, Int4 or float (the element type of the
// cache's rows); kHeads: bf16 (B, T, H) scales, else fp32 (B, T) or none
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
  constexpr int kLanesPerHead = kHD / kElems;  // 4 (int8, int4) or 8 (bf16, fp32)
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

}  // namespace

// q (B, H*64) bf16, or fp32 where q_f32 is set, rows q_stride elements
// apart (a row of a fused qkv projection is read in place); k/v (B, T,
// H*64) by kv_mode (ops/decode_attention.py KV_*): 0 bf16, no scales; 1
// int8 with fp32 (B, T) scales (nullable); 2 int8 with bf16 (B, T, H)
// scales; 3 int4 packed two a byte, (B, T, H*32) bytes, with bf16 (B, T, H)
// scales; 4 fp32, no scales. bf16 q takes modes 0-3, fp32 q modes 1-4.
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
      case 1: KWT_LAUNCH(int8_t, false, float);
      case 2: KWT_LAUNCH(int8_t, true, float);
      case 3: KWT_LAUNCH(Int4, true, float);
      case 4: KWT_LAUNCH(float, false, float);
    }
  } else {
    switch (kv_mode) {
      case 0: KWT_LAUNCH(__nv_bfloat16, false, __nv_bfloat16);
      case 1: KWT_LAUNCH(int8_t, false, __nv_bfloat16);
      case 2: KWT_LAUNCH(int8_t, true, __nv_bfloat16);
      case 3: KWT_LAUNCH(Int4, true, __nv_bfloat16);
    }
  }
#undef KWT_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
