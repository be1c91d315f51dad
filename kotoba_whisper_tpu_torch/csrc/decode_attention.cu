// Decode-step attention over flat K/V caches (K2) for Hopper.
//
// Replaces: kotoba_whisper_tpu/ops/decode_attention.py `_kernel` (called
// through `decode_attention_flat`), and covers what the TPU main path
// actually ran in its place, `decode_attention_reference`: per-row fp32
// int8 scales folded into the scores (k_scale) and the softmax weights
// (v_scale), a lockstep scalar or per-row (B,) valid length.
//
// What bounds it on the card: one query row per batch element against a
// (B, T, H*64) cache, so every K/V byte is read once and used for one
// multiply-add: ~0.5-1 flop per byte, far below the ridge. The cross-
// attention call (T=1500) is bound by the bytes of K and V (61 MB in int8
// at B=16, about 18 us at 3.35 TB/s); the self-attention call (T <= 51)
// is bound by its launch and the host's call.
//
// Design: one launch per call. T is split over a thread-block cluster of
// up to 8 CTAs per batch row (ops/decode_attention.py `split_plan`: 8 x 188
// rows at T=1500, 128 CTAs at B=16; one CTA for the self cache). A CTA's
// rows of a batch row are contiguous in the (B, T, H*64) cache, so one
// producer warp streams them with 1-D bulk copies (cp.async.bulk, counted
// on mbarriers) through a 4-stage ring of 20 KB: its K rows, then its V
// rows, keeping ~60 KB in flight per CTA. Ten consumer warps each own one
// 16-byte chunk of a row (a quarter of a head in int8, an eighth in bf16)
// and a group of rows, so every consumer thread works in both phases and
// the lanes sharing a head reduce by shuffles. int8 becomes fp32 by a byte
// permute into the mantissa of 2^23 and one subtraction (prmt + fadd on the
// integer and FMA pipes; the I2F pipe alone would take ~15 us at B=16), and
// all arithmetic stays fp32. The scores of a CTA's rows (<= 188 x 20) stay
// in shared memory, so the CTA's softmax takes its exact max before any
// exponential (no online rescaling); the weights carry v_scale into the V
// pass. The CTAs of a cluster then combine through distributed shared
// memory: each sends its weighted V sums for a slice of the output columns
// to the CTA that owns the slice, and its per-head max and sum to all, and
// after one cluster barrier each owner writes its slice: no fp32 partials
// in device memory and no second launch. The self-attention cache
// (T <= 64) is one CTA per row.
//
// Two more forms of the same kernel:
// - Ring (decode/streaming.py's shared-slot self cache, the ring mask of
//   `decode_attention_reference(ring_pos=...)`): row b's keys are its
//   `valid` most recent slots, ending at slot *ring_pos. Logical row j of
//   [0, valid) lies at physical slot (ring_pos + 1 - valid + j) mod T
//   (ops/decode_attention.py `ring_slot`); attention does not depend on
//   key order, so the split plan and the combine are the prefix form's. A
//   stage whose run of logical rows wraps past T takes two bulk copies on
//   its one mbarrier (`ring_copies`), the scales are read by physical
//   slot, and ring_pos is read from device memory, so a captured CUDA
//   graph replays with the value of the moment.
// - Beam (`decode_attention_reference_beam`: K beam queries of a group
//   against the group's one shared cross-K/V row): each consumer thread
//   holds its 16-byte column chunk of all K queries, so one pass over the
//   shared rows gives the K*H scores of each row, and the combine runs over
//   K*H (max, sum) pairs and K*d output columns. The bytes are the prefix
//   form's and the arithmetic K times it. The exact two-pass softmax keeps
//   all K*H scores of a CTA's rows in shared memory: at K=5, H=20, 188 rows
//   that is 75 KB beside the 80 KB ring (~191 KB in all), so a beam CTA
//   runs alone on its SM (T=1500 in 8 CTAs a group: 12 groups are 96 CTAs,
//   one wave on 132 SMs) and may take up to 184 registers a thread (ptxas:
//   136 at K=5 in int8, no spills); the prefix form (K=1) keeps two CTAs
//   an SM. Six beams are the most whose scores fit at T=1500, H=20.
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kHD = 64;               // head dim
constexpr int kConsumerWarps = 10;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 4;
constexpr int kStageBytes = 20480;
constexpr int kMaxCluster = 8;  // CTAs per batch row (ops/decode_attention.py MAX_CLUSTER)
constexpr float kLog2e = 1.4426950408889634f;

template <typename KV>
struct Chunk;
// 16 int8 values -> floats: each byte, biased by 128, becomes the low byte
// of 2^23's mantissa; one subtraction leaves the exact integer.
template <>
struct Chunk<int8_t> {
  static constexpr int kElems = 16;
  __device__ __forceinline__ static void load(const void* p, float* x) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                           raw.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + j)) - 8388736.f;
  }
};
// 8 bf16 values -> floats: each is the high half of its float.
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const void* p, float* x) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

// Store v at p's offset in the shared memory of CTA `rank` of the cluster.
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// Shared memory of one CTA: the copy ring (reused for the row groups' V
// sums once the ring is drained), the scores/weights of its rows (K*H
// columns), its K/V scales, its max and sum per (beam, head), what the
// cluster's CTAs send it for its slice of the K*d output columns (their
// weighted V sums, maxes and sums), and the barriers.
// ops/decode_attention.py `smem_bytes` mirrors `total`.
struct Layout {
  int ring, scores, k_scale, v_scale, m, l, recv_acc, recv_m, recv_l, bars, total;
  __host__ __device__ Layout(int rows, int n_heads, int d, int beams) {
    const int kh = beams * n_heads;
    ring = 0;
    scores = ring + kStages * kStageBytes;
    k_scale = scores + 4 * rows * kh;
    v_scale = k_scale + 4 * rows;
    m = v_scale + 4 * rows;
    l = m + 4 * kh;
    recv_acc = l + 4 * kh;                           // (ranks, slice), <= K*d + ranks
    recv_m = recv_acc + 4 * (beams * d + kMaxCluster);  // (ranks, K*H)
    recv_l = recv_m + 4 * kMaxCluster * kh;          // (ranks, K*H)
    bars = (recv_l + 4 * kMaxCluster * kh + 7) & ~7;
    total = bars + 8 * 2 * kStages;
  }
};

template <typename KV, int kBeams>
__global__ void __launch_bounds__(kThreads, kBeams == 1 ? 2 : 1)
    decode_kernel(const __nv_bfloat16* __restrict__ q, long q_stride, const KV* __restrict__ k,
                  const KV* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ valid_rows,
                  int valid_all, const int* __restrict__ ring_pos,
                  __nv_bfloat16* __restrict__ out, int t_cap, int n_heads, int rows_per_cta) {
  constexpr int kElems = Chunk<KV>::kElems;
  constexpr int kLanesPerHead = kHD / kElems;  // 4 (int8) or 8 (bf16)
  extern __shared__ __align__(128) uint8_t smem[];
  const int d = n_heads * kHD;
  const int kh = kBeams * n_heads;  // score columns of a row: (beam, head)
  const int kd = kBeams * d;        // output columns of a batch row (group)
  const Layout lay(rows_per_cta, n_heads, d, kBeams);
  uint8_t* ring = smem + lay.ring;
  float* sc = reinterpret_cast<float*>(smem + lay.scores);  // (rows, K*H)
  float* ks_s = reinterpret_cast<float*>(smem + lay.k_scale);
  float* vs_s = reinterpret_cast<float*>(smem + lay.v_scale);
  float* m_s = reinterpret_cast<float*>(smem + lay.m);
  float* l_s = reinterpret_cast<float*>(smem + lay.l);
  float* recv_acc = reinterpret_cast<float*>(smem + lay.recv_acc);
  float* recv_m = reinterpret_cast<float*>(smem + lay.recv_m);
  float* recv_l = reinterpret_cast<float*>(smem + lay.recv_l);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x, n_ranks = gridDim.x, b = blockIdx.y;
  const int per_rank = (kd + n_ranks - 1) / n_ranks;  // output columns of each CTA
  const int valid = min(valid_rows ? valid_rows[b] : valid_all, t_cap);
  const int t0 = rank * rows_per_cta;
  const int n_rows = max(min(t0 + rows_per_cta, valid) - t0, 0);
  // this CTA's logical row r lies at physical slot first + r, less t_cap
  // past the end: the prefix form reads slots [t0, t0 + n_rows); the ring
  // form's logical row j is slot (ring_pos + 1 - valid + j) mod t_cap
  const int first = ring_pos ? ((*ring_pos + 1 - valid + t0) % t_cap + t_cap) % t_cap : t0;
  const long base = (long)b * t_cap;  // the batch row's slot 0
  const int row_bytes = d * (int)sizeof(KV);
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
    // ---- producer: K rows, then V rows, through the ring; a stage whose
    // rows wrap past the cache's end takes two copies on its barrier -------
    if (lane == 0) {
      for (int i = 0; i < 2 * n_chunks; ++i) {
        const int st = i % kStages, c = i < n_chunks ? i : i - n_chunks;
        const int r0 = c * stage_rows, n = min(stage_rows, n_rows - r0);
        int slot = first + r0;
        if (slot >= t_cap) slot -= t_cap;
        const int n1 = min(n, t_cap - slot);
        const KV* src = (i < n_chunks ? k : v) + base * d;
        uint8_t* dst = ring + st * kStageBytes;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], n * row_bytes);
        bulk_load(dst, src + (long)slot * d, n1 * row_bytes, &full[st]);
        if (n > n1) bulk_load(dst + n1 * row_bytes, src, (n - n1) * row_bytes, &full[st]);
      }
    }
    __syncwarp();
    cluster_wait();
  } else {
    // ---- consumers: thread -> (16-byte chunk of a row, group of rows) -----
    const int n_cols = d / kElems;                 // chunks per row
    const int n_groups = kConsumers / n_cols;      // row groups (>= 1)
    const int col = tid % n_cols, grp = tid / n_cols;
    const bool active = grp < n_groups;
    const int h = col / kLanesPerHead;
    // this chunk of each beam's q, pre-scaled by 1/sqrt(64) * log2(e)
    float qr[kBeams][kElems];
#pragma unroll
    for (int j = 0; j < kBeams; ++j) {
      const __nv_bfloat16* qp = q + ((long)b * kBeams + j) * q_stride + col * kElems;
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        qr[j][e] = active ? __bfloat162float(qp[e]) * (0.125f * kLog2e) : 0.f;
    }
    for (int r = tid; r < n_rows; r += kConsumers) {
      int slot = first + r;
      if (slot >= t_cap) slot -= t_cap;
      ks_s[r] = k_scale ? k_scale[base + slot] : 1.f;
      vs_s[r] = v_scale ? v_scale[base + slot] : 1.f;
    }
    named_bar_sync(1, kConsumers);

    // scores (log2 units) of every row of this CTA, per (beam, head)
    for (int i = 0; i < n_chunks; ++i) {
      const int st = i % kStages, r0 = i * stage_rows, n = min(stage_rows, n_rows - r0);
      mbar_wait(&full[st], (i / kStages) & 1);
      const uint8_t* tile = ring + st * kStageBytes;
      // the same trip count in every lane: the shuffles take the whole warp
      for (int it = 0; it < (n + n_groups - 1) / n_groups; ++it) {
        const int r = grp + it * n_groups;
        float part[kBeams];
#pragma unroll
        for (int j = 0; j < kBeams; ++j) part[j] = 0.f;
        if (active && r < n) {
          float x[kElems];
          Chunk<KV>::load(tile + (long)r * row_bytes + col * 16, x);
#pragma unroll
          for (int j = 0; j < kBeams; ++j)
#pragma unroll
            for (int e = 0; e < kElems; ++e) part[j] = fmaf(x[e], qr[j][e], part[j]);
        }
#pragma unroll
        for (int j = 0; j < kBeams; ++j)
#pragma unroll
          for (int off = kLanesPerHead / 2; off > 0; off >>= 1)
            part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
        if (active && r < n && col % kLanesPerHead == 0) {
#pragma unroll
          for (int j = 0; j < kBeams; ++j)
            sc[(r0 + r) * kh + j * n_heads + h] = part[j] * ks_s[r0 + r];
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    named_bar_sync(1, kConsumers);

    // the CTA's exact max per (beam, head), weights p * v_scale, and sums
    // (an empty CTA, all its rows past valid, keeps m = -inf and l = 0)
    for (int jh = warp; jh < kh; jh += kConsumerWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < n_rows; r += 32) mx = fmaxf(mx, sc[r * kh + jh]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int r = lane; r < n_rows; r += 32) {
        const float p = ex2(sc[r * kh + jh] - mx);
        sum += p;
        sc[r * kh + jh] = p * vs_s[r];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        m_s[jh] = mx;
        l_s[jh] = sum;
      }
    }
    named_bar_sync(1, kConsumers);

    // weighted V sums of this thread's chunk over its row group, per beam
    float acc[kBeams][kElems];
#pragma unroll
    for (int j = 0; j < kBeams; ++j)
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[j][e] = 0.f;
    for (int i = 0; i < n_chunks; ++i) {
      const int jc = n_chunks + i, st = jc % kStages;
      const int r0 = i * stage_rows, n = min(stage_rows, n_rows - r0);
      mbar_wait(&full[st], (jc / kStages) & 1);
      const uint8_t* tile = ring + st * kStageBytes;
      if (active) {
        for (int r = grp; r < n; r += n_groups) {
          float x[kElems];
          Chunk<KV>::load(tile + (long)r * row_bytes + col * 16, x);
#pragma unroll
          for (int j = 0; j < kBeams; ++j) {
            const float w = sc[(r0 + r) * kh + j * n_heads + h];
#pragma unroll
            for (int e = 0; e < kElems; ++e) acc[j][e] = fmaf(w, x[e], acc[j][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    // the drained ring holds the row groups' sums, one beam at a time
    named_bar_sync(1, kConsumers);
    float* red = reinterpret_cast<float*>(ring);  // (n_groups, d)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // after the bulk copies
#pragma unroll
    for (int j = 0; j < kBeams; ++j) {
      if (j > 0) named_bar_sync(1, kConsumers);  // the previous beam's sums are read
      if (active) {
#pragma unroll
        for (int e = 0; e < kElems; ++e) red[grp * d + col * kElems + e] = acc[j][e];
      }
      named_bar_sync(1, kConsumers);
      // send each column's sum to the CTA that owns its output slice
      if (j == 0) cluster_wait();
      for (int c = tid; c < d; c += kConsumers) {
        float s = 0.f;
        for (int g = 0; g < n_groups; ++g) s += red[g * d + c];
        const int gc = j * d + c, owner = gc / per_rank;
        st_cluster(recv_acc + rank * per_rank + gc - owner * per_rank, owner, s);
      }
    }
    // and this CTA's max and sum per (beam, head) to every CTA
    for (int i = tid; i < n_ranks * kh; i += kConsumers) {
      const int dst = i / kh, jh = i - dst * kh;
      st_cluster(recv_m + rank * kh + jh, dst, m_s[jh]);
      st_cluster(recv_l + rank * kh + jh, dst, l_s[jh]);
    }
  }
  // ---- combine: each CTA writes its slice of the output from what it was
  // sent; after this barrier no CTA touches another's shared memory
  cluster_sync();
  if (warp != kConsumerWarps) {
    const int c0 = rank * per_rank;
    for (int c = c0 + tid; c < min(kd, c0 + per_rank); c += kConsumers) {
      const int j = c / d, jh = j * n_heads + (c - j * d) / kHD;
      float mx = -INFINITY;
      for (int r = 0; r < n_ranks; ++r) mx = fmaxf(mx, recv_m[r * kh + jh]);
      float l = 0.f, o = 0.f;
      if (mx != -INFINITY) {
        for (int r = 0; r < n_ranks; ++r) {
          const float f = ex2(recv_m[r * kh + jh] - mx);  // 0 for an empty CTA
          l = fmaf(recv_l[r * kh + jh], f, l);
          o = fmaf(recv_acc[r * per_rank + c - c0], f, o);
        }
      }
      out[(long)b * kd + c] = __float2bfloat16(l > 0.f ? o / l : 0.f);
    }
  }
}

template <typename KV, int kBeams>
int launch(const void* q, long q_stride, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* valid_rows, int valid_all, const void* ring_pos,
           void* out, int batch, int t_cap, int n_heads, int n_ctas, int rows_per_cta,
           cudaStream_t stream) {
  const int d = n_heads * kHD;
  const Layout lay(rows_per_cta, n_heads, d, kBeams);
  static int configured = 0;
  if (configured < lay.total) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<KV, kBeams>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
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
      &cfg, decode_kernel<KV, kBeams>, static_cast<const __nv_bfloat16*>(q), q_stride,
      static_cast<const KV*>(k), static_cast<const KV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(valid_rows), valid_all,
      static_cast<const int*>(ring_pos), static_cast<__nv_bfloat16*>(out), t_cap, n_heads,
      rows_per_cta));
}

template <int kBeams>
int launch_kv(int kv_int8, const void* q, long q_stride, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* valid_rows, int valid_all,
              const void* ring_pos, void* out, int batch, int t_cap, int n_heads, int n_ctas,
              int rows_per_cta, cudaStream_t s) {
  if (kv_int8)
    return launch<int8_t, kBeams>(q, q_stride, k, v, k_scale, v_scale, valid_rows, valid_all,
                                  ring_pos, out, batch, t_cap, n_heads, n_ctas, rows_per_cta, s);
  return launch<__nv_bfloat16, kBeams>(q, q_stride, k, v, k_scale, v_scale, valid_rows,
                                       valid_all, ring_pos, out, batch, t_cap, n_heads, n_ctas,
                                       rows_per_cta, s);
}

}  // namespace

// q (B, K, H*64) bf16, rows q_stride elements apart (a row of a fused
// qkv projection is read in place); k/v (B, T, H*64) bf16 (kv_int8=0) or
// int8 (kv_int8=1) with fp32 (B, T) scales (nullable), one row per batch
// row, shared by its n_beams queries (1 <= n_beams <= 6; 1 is the plain
// one-query form); valid_rows (B,) int32 or null, then valid_all applies
// to every row; ring_pos a device int32 or null (null: each row's keys are
// slots [0, valid); else its valid most recent ring slots, ending at
// *ring_pos). One cluster of n_ctas CTAs (<= 8) per batch row, each over
// rows_per_cta cache rows (the split plan of ops/decode_attention.py).
// out (B, K, H*64) bf16. Returns the launch's cudaError_t.
extern "C" int kwt_decode_attention(const void* q, long long q_stride, const void* k,
                                    const void* v, const void* k_scale, const void* v_scale,
                                    const void* valid_rows, int valid_all, const void* ring_pos,
                                    void* out, int batch, int t_cap, int n_heads, int n_beams,
                                    int n_ctas, int rows_per_cta, int kv_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long qs = static_cast<long>(q_stride);
  switch (n_beams) {
#define KWT_BEAMS(K)                                                                          \
  case K:                                                                                     \
    return launch_kv<K>(kv_int8, q, qs, k, v, k_scale, v_scale, valid_rows, valid_all,        \
                        ring_pos, out, batch, t_cap, n_heads, n_ctas, rows_per_cta, s);
    KWT_BEAMS(1)
    KWT_BEAMS(2)
    KWT_BEAMS(3)
    KWT_BEAMS(4)
    KWT_BEAMS(5)
    KWT_BEAMS(6)
#undef KWT_BEAMS
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
