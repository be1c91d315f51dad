// Decode-step self-attention over a ring cache (K2's ring form), and over
// a prefix self cache (K2's self form), for Hopper.
//
// Replaces: the ring mask of kotoba_whisper_tpu/ops/decode_attention.py
// `decode_attention_reference(..., ring_pos=...)` (:59, mask :96-98; XLA on
// the TPU), which decode/streaming.py's shared-slot self cache runs: row b's
// keys are its valid[b] most recent slots, ending at slot ring_pos; one
// query a (row, head); int8 K/V with fp32 per-row scales or bf16 per-head
// scales (the int4 cache keeps its self K/V in int8 with these; k_scale
// folds into the scores, v_scale into the weights), or bf16 K/V.
//
// What bounds it on the card: bytes, and few of them. At the stream's
// shape (48 rows, T=176 slots, 20 heads, valid over [1, 176]) the valid
// slots' K and V are 10.9 MB in int8, 3.3 us at 3.35 TB/s. The earlier form
// (decode_attention.cu's cluster kernel, split by capacity) gave each row a
// cluster of 3 CTAs of 59 rows whatever its length, and ran each CTA's K
// pass, softmax and V pass as a long chain of barriers over a few KB.
//
// Design: one CTA per (row, group of heads) (ops/decode_attention.py
// `ring_plan`), no cluster and no combine. The CTA reads only its heads'
// columns of its row's valid slots, all of them at once: logical key j of
// [0, valid) is slot (ring_pos + 1 - valid + j) mod T (`ring_slot`), and
// the valid slots are one or two runs of the ring. K and V come by 3-D TMA
// boxes (the heads' columns x 32 slots x the row) over those runs into
// shared memory indexed by slot, so a box that runs past a run, or two
// boxes over one slot, write that slot's own bytes, and past T the map
// zero-fills a box's overhang; per-row scales by 4-byte cp.asyncs, per-head
// ones (the CTA's heads' 2, 4 or 8 contiguous bytes a slot) by plain loads
// into fp32 a (slot, head). K with the scales, and V, count on two
// mbarriers. The heads a CTA takes are as many
// as keep all its K and V slots in shared memory with enough CTAs to fill
// the card (two a row's 20 heads at the stream's shape: 480 CTAs, four an
// SM). Then, on the CUDA cores (one query a head gives the tensor cores
// nothing to do): the scores in fp32 in the reference's own units, q / 8
// (exact) times K times k_scale (the lanes of a head's 64 columns reduce by
// shuffles; int8 becomes fp32 by a byte permute into the mantissa of 2^23
// and one subtraction) while V lands, and each warp's max per head by
// shuffles; after one barrier, P V by threads that each own a 16-byte
// column chunk and a group of keys, taking p = exp(s - max) (expf, not the
// approximate exp2: outputs near 1 in bf16 then round as the twin's do
// more often), its sum and p * v_scale on the fly; the groups of a warp
// reduce by shuffles, and after a second barrier the warps' sums and O / l.
// ring_pos and valid are read from device memory, so a captured CUDA graph
// replays with the values of the moment.
//
// The self form: the same kernels with a null ring_pos, key j at slot j
// (the ring's map with ring_pos = valid - 1, but no device read before the
// copies start). Every single-query self-attention call of the decoder
// (models/whisper.py `_decode_step_body`: lockstep, per-row, beam rows,
// serving; caches of at most 448 slots) takes it: ops/decode_attention.py
// `self_form` picks it for caches of at most 512 slots in every K/V mode
// but packed int4. The prefix kernel (decode_attention.cu) gave such a
// cache one CTA per batch row (16 CTAs of 352 threads at B=16, each over
// all 20 heads through the cluster machinery), 2.5x the device time of
// one scaled_dot_product_attention call; this grid is B x H / heads CTAs.
//
// The fp32 form (`ring_f32_kernel`: an fp32 model's step; fp32 q and output,
// fp32 K/V or int8 with either scale form, every sum fp32): one fp32 head's
// slots take 512 bytes, so the decoder's most positions (T=448) need 229 KB
// of K and V a head, more than a CTA's shared memory. So one CTA per (row,
// head) walks its valid keys in boxes of `chunk` slots
// (ops/decode_attention.py `ring_plan`: all of them where they fit two CTAs
// an SM, 176 at the stream's T, else 192): 16-byte cp.asyncs of each key's
// 64 columns at its ring slot, the box's scores (q / 8 times K times
// k_scale, lanes of a head's row reduced by shuffles), the box's max over
// the CTA, and P V with an online softmax across boxes: the running max m,
// p = exp(s - m), and each thread's sum of p and its P V sums rescaled by
// exp(m_old - m_new) when a box raises m.
#include "card.cuh"
#include "sm90_common.cuh"

namespace {

using namespace kwt_sm90;

constexpr int kHD = 64;  // head dim
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBox = 32;    // slots a TMA box (ops/decode_attention.py RING_BOX)

// Shared memory of one CTA over `hpc` heads and t_cap slots: K and V by
// slot (each with a box's overhang past T; K's space, at least the warps'
// P V sums), the scales by slot (one fp32, or one a head), the scores per
// head by key, the warps' maxima and sums of p per head, two mbarriers (K
// and the scales, V). ops/decode_attention.py `ring_smem_bytes` mirrors
// `total`.
struct Layout {
  int k, v, ks, vs, sc, m, lr, bars, total;
  __host__ __device__ Layout(int t_cap, int hpc, int elem, bool heads) {
    const int bytes = (t_cap + kBox) * hpc * kHD * elem;
    const int sw = heads ? hpc : 1;  // scales a slot
    k = 0;
    v = (k + max(bytes, kWarps * hpc * kHD * 4) + 127) & ~127;
    ks = v + bytes;
    vs = ks + 4 * sw * t_cap;
    sc = vs + 4 * sw * t_cap;
    m = sc + 4 * hpc * t_cap;
    lr = m + 4 * kWarps * 4;
    bars = (lr + 4 * kWarps * 4 + 7) & ~7;
    total = bars + 16;
  }
};

// kHeads: int8 K/V with bf16 (B, T, H) scales; else fp32 (B, T) scales
// (int8) or none (bf16).
template <typename KV, bool kHeads>
__global__ void __launch_bounds__(kThreads)
    ring_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const __nv_bfloat16* __restrict__ q, long q_stride,
                const void* __restrict__ k_scale, const void* __restrict__ v_scale,
                const int* __restrict__ valid_rows, int valid_all,
                const int* __restrict__ ring_pos, __nv_bfloat16* __restrict__ out, int t_cap,
                int n_heads, int hpc) {
  constexpr bool kInt8 = sizeof(KV) == 1;
  constexpr int kElems = Chunk<KV>::kElems;
  constexpr int kLanes = kHD / kElems;  // lanes of a head's row: 4 (int8) or 8 (bf16)
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout lay(t_cap, hpc, sizeof(KV), kHeads);
  const int sw = kHeads ? hpc : 0;  // a slot's scales are at slot * sw + head
  uint8_t* kb = smem + lay.k;
  uint8_t* vb = smem + lay.v;
  float* ks_s = reinterpret_cast<float*>(smem + lay.ks);
  float* vs_s = reinterpret_cast<float*>(smem + lay.vs);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);  // (hpc, t_cap) by key
  float* wm = reinterpret_cast<float*>(smem + lay.m);  // (warps, hpc) maxima
  float* lr = reinterpret_cast<float*>(smem + lay.lr);  // (warps, hpc)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, h0 = blockIdx.x * hpc;
  const int valid = max(min(valid_rows ? valid_rows[b] : valid_all, t_cap), 0);
  // slot of key 0: the ring's, or 0 without ring_pos (the self form: key j at slot j)
  const int first = ring_pos ? ((*ring_pos + 1 - valid) % t_cap + t_cap) % t_cap : 0;
  const int row = hpc * kHD * (int)sizeof(KV);  // a slot's bytes of this CTA's heads
  const long base = (long)b * t_cap;

  if (tid == 0) {
    prefetch_tmap(&tm_k);
    prefetch_tmap(&tm_v);
    mbar_init(&bars[0], kThreads + 1);  // each thread's scale copies, and the K bytes
    mbar_init(&bars[1], 1);             // the V bytes
    fence_barrier_init();
  }
  __syncthreads();

  // ---- every copy in flight: K and V by TMA boxes of kBox slots over the
  // keys' one or two runs of slots, each slot's data at its own smem row (a
  // box past a run, or two boxes over one slot, write that slot's own
  // bytes; a box starts on a 128-byte row boundary), then the scales by
  // cp.async, or per head by plain loads, issued after the boxes so that
  // their round trip does not hold the boxes back --------------------------
  if (warp == 0) {
    const int n1 = min(valid, t_cap - first);                   // [first, first + n1)
    const int align = row >= 128 ? 1 : 128 / row;              // slots of 128 bytes
    const int s1 = first & ~(align - 1);
    const int boxes1 = n1 > 0 ? (first + n1 - s1 + kBox - 1) / kBox : 0;
    const int boxes = boxes1 + (valid - n1 + kBox - 1) / kBox;  // then [0, valid - n1)
    if (lane == 0) {
      mbar_expect_tx(&bars[0], boxes * kBox * row);
      mbar_expect_tx(&bars[1], boxes * kBox * row);
    }
    for (int i = lane; i < boxes; i += 32) {
      const int s0 = i < boxes1 ? s1 + i * kBox : (i - boxes1) * kBox;
      tma_load_3d(kb + s0 * row, &tm_k, &bars[0], h0 * kHD, s0, b);
      tma_load_3d(vb + s0 * row, &tm_v, &bars[1], h0 * kHD, s0, b);
    }
  }
  // this thread's chunk of its head's q, times 1/sqrt(64) (exact);
  // a pass takes kThreads / kLanes consecutive (key, head) dots, heads
  // fastest, so the thread's head is fixed (hpc divides the pass)
  const int c = tid % kLanes, dot0 = tid / kLanes, per_pass = kThreads / kLanes;
  const int hh = dot0 % hpc;
  float qr[kElems];
  {
    const __nv_bfloat16* qp = q + (long)b * q_stride + (h0 + hh) * kHD + c * kElems;
#pragma unroll
    for (int e = 0; e < kElems; ++e) qr[e] = __bfloat162float(qp[e]) * 0.125f;
  }
  if (kHeads) {
    const __nv_bfloat16* ksg = static_cast<const __nv_bfloat16*>(k_scale);
    const __nv_bfloat16* vsg = static_cast<const __nv_bfloat16*>(v_scale);
    for (int i = tid; i < valid * hpc; i += kThreads) {
      const int j = i / hpc, e = i - j * hpc;
      int slot = first + j;
      if (slot >= t_cap) slot -= t_cap;
      const long at = (base + slot) * n_heads + h0 + e;
      ks_s[slot * hpc + e] = __bfloat162float(ksg[at]);
      vs_s[slot * hpc + e] = __bfloat162float(vsg[at]);
    }
    mbar_arrive(&bars[0]);  // release: the stores are seen past the wait
  } else {
    if (kInt8) {
      for (int j = tid; j < valid; j += kThreads) {
        int slot = first + j;
        if (slot >= t_cap) slot -= t_cap;
        cp_async4(ks_s + slot, static_cast<const float*>(k_scale) + base + slot);
        cp_async4(vs_s + slot, static_cast<const float*>(v_scale) + base + slot);
      }
    }
    cp_async_mbar_arrive_noinc(&bars[0]);
  }
  mbar_wait(&bars[0], 0);

  // ---- scores of every (key, head), and the max per head ------------------
  const int n_dots = valid * hpc;
  const int col0 = hh * kHD * (int)sizeof(KV) + c * 16;  // this lane's bytes of a slot
  float mx = -INFINITY;
#pragma unroll 2
  for (int it = 0, j = dot0 / hpc; it < (n_dots + per_pass - 1) / per_pass;  // the same in every lane
       ++it, j += per_pass / hpc) {
    const int i = dot0 + it * per_pass;
    int slot = first + j;
    if (slot >= t_cap) slot -= t_cap;
    float part = 0.f, part2 = 0.f;  // two chains
    if (i < n_dots) {
      float x[kElems];
      Chunk<KV>::load(kb + slot * row + col0, x);
#pragma unroll
      for (int e = 0; e < kElems; e += 2) {
        part = fmaf(x[e], qr[e], part);
        part2 = fmaf(x[e + 1], qr[e + 1], part2);
      }
      part += part2;
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (i < n_dots) {
      const float s = kInt8 ? part * ks_s[kHeads ? slot * sw + hh : slot] : part;
      mx = fmaxf(mx, s);
      if (c == 0) sc[hh * t_cap + j] = s;
    }
  }
  // the max of each head over the warp's dots (lanes kLanes * hpc apart
  // share a head), one value a (warp, head)
  for (int off = kLanes * hpc; off < 32; off <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane < kLanes * hpc && c == 0) wm[warp * hpc + hh] = mx;
  __syncthreads();

  // ---- P V: thread -> (16-byte column chunk, group of keys); p = e^(s - m)
  // and the weights p * v_scale on the fly, sums of p beside -------------
  const int n_chunks = row / 16, n_groups = kThreads / n_chunks;
  const int col = tid % n_chunks, grp = tid / n_chunks, hv = col / kLanes;
  float m = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, wm[w * hpc + hv]);
  const float* s = sc + hv * t_cap;
  float acc[kElems], l = 0.f;
#pragma unroll
  for (int e = 0; e < kElems; ++e) acc[e] = 0.f;
  mbar_wait(&bars[1], 0);
  for (int j = grp; j < valid; j += n_groups) {
    int slot = first + j;
    if (slot >= t_cap) slot -= t_cap;
    const float p = expf(s[j] - m);
    l += p;
    const float w = kInt8 ? p * vs_s[kHeads ? slot * sw + hv : slot] : p;
    float x[kElems];
    Chunk<KV>::load(vb + slot * row + col * 16, x);
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] = fmaf(w, x[e], acc[e]);
  }
  // the key groups of a warp (lanes n_chunks apart) by shuffles, then the
  // warps' sums in K's place
  for (int off = n_chunks; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
  float* red = reinterpret_cast<float*>(kb);  // (warps, hpc * 64)
  const int width = hpc * kHD;
  if (lane < n_chunks) {
#pragma unroll
    for (int e = 0; e < kElems; e += 4)
      *reinterpret_cast<float4*>(red + warp * width + col * kElems + e) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
    if (col % kLanes == 0) lr[warp * hpc + hv] = l;
  }
  __syncthreads();
  for (int i = tid; i < width; i += kThreads) {
    float o = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      o += red[w * width + i];
      ls += lr[w * hpc + i / kHD];
    }
    out[((long)b * n_heads + h0) * kHD + i] = __float2bfloat16(ls > 0.f ? o / ls : 0.f);
  }
}

// 3-D map (H*64 columns, T slots, B rows) of a (B, T, H*64) cache: boxes of
// `hpc` heads' columns x kBox slots, zero-filled past T.
template <typename KV>
bool make_map(CUtensorMap* map, const void* base, int batch, int t_cap, int n_heads, int hpc) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t rowb = (cuuint64_t)n_heads * kHD * sizeof(KV);
  const cuuint64_t dims[3] = {(cuuint64_t)n_heads * kHD, (cuuint64_t)t_cap, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {rowb, rowb * t_cap};
  const cuuint32_t box[3] = {(cuuint32_t)(hpc * kHD), kBox, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, sizeof(KV) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename KV, bool kHeads>
int launch(int card, const void* q, long q_stride, const void* k, const void* v,
           const void* k_scale, const void* v_scale, const void* valid_rows, int valid_all,
           const void* ring_pos, void* out, int batch, int t_cap, int n_heads, int hpc,
           cudaStream_t stream) {
  static bool configured[kwt_card::kMaxCards] = {};
  if (!configured[card]) {
    int most = 0;
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, card);
    const cudaError_t err = cudaFuncSetAttribute(
        ring_kernel<KV, kHeads>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[card] = true;
  }
  // a stream's self caches (one a layer) are allocated once
  CUtensorMap tk, tv;
  const int i8 = sizeof(KV) == 1;
  if (!cached_tmap(&tk, {k, {batch, t_cap, n_heads, hpc, i8}},
                   [&](CUtensorMap* m) { return make_map<KV>(m, k, batch, t_cap, n_heads, hpc); }) ||
      !cached_tmap(&tv, {v, {batch, t_cap, n_heads, hpc, i8}},
                   [&](CUtensorMap* m) { return make_map<KV>(m, v, batch, t_cap, n_heads, hpc); }))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(t_cap, hpc, sizeof(KV), kHeads);
  ring_kernel<KV, kHeads><<<dim3(n_heads / hpc, batch), kThreads, lay.total, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(q), q_stride, k_scale, v_scale,
      static_cast<const int*>(valid_rows), valid_all, static_cast<const int*>(ring_pos),
      static_cast<__nv_bfloat16*>(out), t_cap, n_heads, hpc);
  return static_cast<int>(cudaGetLastError());
}


// ---- the fp32 form ---------------------------------------------------------

// Shared memory of an fp32-form CTA over boxes of `chunk` slots of one head
// (`row` bytes a slot): K (at least the warps' P V sums) and V of a box, its
// two scales and scores a key, the warps' maxima and sums.
// ops/decode_attention.py `ring_f32_smem_bytes` mirrors `total`.
struct F32Layout {
  int k, v, ks, vs, sc, m, lr, total;
  __host__ __device__ F32Layout(int chunk, int row) {
    k = 0;
    v = (max(chunk * row, kWarps * kHD * 4) + 15) & ~15;
    ks = v + ((chunk * row + 15) & ~15);
    vs = ks + 4 * chunk;
    sc = vs + 4 * chunk;
    m = sc + 4 * chunk;
    lr = m + 4 * kWarps;
    total = lr + 4 * kWarps;
  }
};

// KV: float (no scales) or int8_t (kHeads: bf16 (B, T, H) scales, else fp32
// (B, T) ones). q and out fp32.
template <typename KV, bool kHeads>
__global__ void __launch_bounds__(kThreads)
    ring_f32_kernel(const float* __restrict__ q, long q_stride, const uint8_t* __restrict__ k,
                    const uint8_t* __restrict__ v, const void* __restrict__ k_scale,
                    const void* __restrict__ v_scale, const int* __restrict__ valid_rows,
                    int valid_all, const int* __restrict__ ring_pos, float* __restrict__ out,
                    int t_cap, int n_heads, int chunk) {
  constexpr bool kScaled = sizeof(KV) == 1;
  constexpr int kRow = kHD * (int)sizeof(KV);  // a slot's bytes of one head
  constexpr int kElems = Chunk<KV>::kElems, kBytes = Chunk<KV>::kBytes;
  constexpr int kLanes = kHD / kElems;  // lanes of a key's dot: 8 (fp32) or 4 (int8)
  constexpr int kCols = kRow / kBytes;  // column chunks of a slot in P V
  constexpr int kGroups = kThreads / kCols;
  extern __shared__ __align__(128) uint8_t smem[];
  const F32Layout lay(chunk, kRow);
  uint8_t* kb = smem + lay.k;
  uint8_t* vb = smem + lay.v;
  float* ks_s = reinterpret_cast<float*>(smem + lay.ks);
  float* vs_s = reinterpret_cast<float*>(smem + lay.vs);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  float* wm = reinterpret_cast<float*>(smem + lay.m);
  float* lr = reinterpret_cast<float*>(smem + lay.lr);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, h = blockIdx.x;
  const int valid = max(min(valid_rows ? valid_rows[b] : valid_all, t_cap), 0);
  // slot of key 0: the ring's, or 0 without ring_pos (the self form)
  const int first = ring_pos ? ((*ring_pos + 1 - valid) % t_cap + t_cap) % t_cap : 0;
  const long row_bytes = (long)n_heads * kRow;
  const uint8_t* kh = k + (long)b * t_cap * row_bytes + (long)h * kRow;
  const uint8_t* vh = v + (long)b * t_cap * row_bytes + (long)h * kRow;

  const int c = tid % kLanes, dot0 = tid / kLanes;
  constexpr int kPerPass = kThreads / kLanes;
  float qr[kElems];  // this lane's chunk of q, times 1/sqrt(64) (exact)
#pragma unroll
  for (int e = 0; e < kElems; ++e)
    qr[e] = q[(long)b * q_stride + h * kHD + c * kElems + e] * 0.125f;
  const int col = tid % kCols, grp = tid / kCols;
  float acc[kElems], l = 0.f, m_run = -INFINITY;
#pragma unroll
  for (int e = 0; e < kElems; ++e) acc[e] = 0.f;

  for (int j0 = 0; j0 < valid; j0 += chunk) {
    const int n = min(chunk, valid - j0);
    // ---- the box's K and V by 16-byte cp.asyncs, its scales by plain loads
    for (int i = tid; i < n * (kRow / 16); i += kThreads) {
      const int key = i / (kRow / 16), off = (i % (kRow / 16)) * 16;
      int slot = first + j0 + key;
      if (slot >= t_cap) slot -= t_cap;
      cp_async16(kb + key * kRow + off, kh + slot * row_bytes + off);
      cp_async16(vb + key * kRow + off, vh + slot * row_bytes + off);
    }
    cp_async_commit();
    if (kScaled) {
      for (int key = tid; key < n; key += kThreads) {
        int slot = first + j0 + key;
        if (slot >= t_cap) slot -= t_cap;
        const long at = (long)b * t_cap + slot;
        if (kHeads) {
          ks_s[key] = __bfloat162float(static_cast<const __nv_bfloat16*>(k_scale)[at * n_heads + h]);
          vs_s[key] = __bfloat162float(static_cast<const __nv_bfloat16*>(v_scale)[at * n_heads + h]);
        } else {
          ks_s[key] = static_cast<const float*>(k_scale)[at];
          vs_s[key] = static_cast<const float*>(v_scale)[at];
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // ---- the box's scores and the max of each warp's ---------------------
    float mx = -INFINITY;
    for (int it = 0; it < (n + kPerPass - 1) / kPerPass; ++it) {  // the same in every lane
      const int key = dot0 + it * kPerPass;
      float part = 0.f, part2 = 0.f;  // two chains
      if (key < n) {
        float x[kElems];
        Chunk<KV>::load(kb + key * kRow + c * kBytes, x);
#pragma unroll
        for (int e = 0; e < kElems; e += 2) {
          part = fmaf(x[e], qr[e], part);
          part2 = fmaf(x[e + 1], qr[e + 1], part2);
        }
        part += part2;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (key < n) {
        const float s_ = kScaled ? part * ks_s[key] : part;
        mx = fmaxf(mx, s_);
        if (c == 0) sc[key] = s_;
      }
    }
#pragma unroll
    for (int off = kLanes; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) wm[warp] = mx;
    __syncthreads();

    // ---- the running max, and P V of this thread's column chunk and keys
    float m_new = m_run;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, wm[w]);
    const float corr = expf(m_run - m_new);  // 0 on the first box
    l *= corr;
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] *= corr;
    for (int j = grp; j < n; j += kGroups) {
      const float p = expf(sc[j] - m_new);
      l += p;
      const float w = kScaled ? p * vs_s[j] : p;
      float x[kElems];
      Chunk<KV>::load(vb + j * kRow + col * kBytes, x);
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[e] = fmaf(w, x[e], acc[e]);
    }
    m_run = m_new;
    __syncthreads();  // the next box's copies overwrite K, V, the scales and scores
  }

  // the key groups of a warp (lanes kCols apart) by shuffles, then the
  // warps' sums in K's place
#pragma unroll
  for (int off = kCols; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
  float* red = reinterpret_cast<float*>(kb);  // (warps, 64)
  if (lane < kCols) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) red[warp * kHD + col * kElems + e] = acc[e];
    if (col == 0) lr[warp] = l;
  }
  __syncthreads();
  for (int i = tid; i < kHD; i += kThreads) {
    float o = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      o += red[w * kHD + i];
      ls += lr[w];
    }
    out[((long)b * n_heads + h) * kHD + i] = ls > 0.f ? o / ls : 0.f;
  }
}

template <typename KV, bool kHeads>
int launch_f32(int card, const void* q, long q_stride, const void* k, const void* v,
               const void* k_scale, const void* v_scale, const void* valid_rows, int valid_all,
               const void* ring_pos, void* out, int batch, int t_cap, int n_heads, int chunk,
               cudaStream_t stream) {
  const F32Layout lay(chunk, kHD * (int)sizeof(KV));
  // per card: the largest shared-memory size opted into there
  static int configured_of[kwt_card::kMaxCards] = {};
  int& configured = configured_of[card];
  if (configured < lay.total) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_f32_kernel<KV, kHeads>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = lay.total;
  }
  ring_f32_kernel<KV, kHeads><<<dim3(n_heads, batch), kThreads, lay.total, stream>>>(
      static_cast<const float*>(q), q_stride, static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), k_scale, v_scale, static_cast<const int*>(valid_rows),
      valid_all, static_cast<const int*>(ring_pos), static_cast<float*>(out), t_cap, n_heads,
      chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H*64) bf16, rows q_stride elements apart; k/v (B, T, H*64) by
// kv_mode (ops/decode_attention.py KV_*): 0 bf16; 1 int8 with fp32 (B, T)
// scales; 2 int8 with bf16 (B, T, H) scales (int4's mode 3 is refused);
// valid_rows (B,) int32 or null, then valid_all applies to every row;
// ring_pos a device int32: row b's keys are its valid most recent slots,
// ending at *ring_pos; or null (the self form): its slots [0, valid). One
// CTA per (row, hpc heads); hpc divides H and 64
// (ops/decode_attention.py `ring_plan`). out (B, H*64) bf16. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a mode it lacks).
extern "C" int kwt_decode_attention_ring(int card, const void* q, long long q_stride,
                                         const void* k, const void* v, const void* k_scale,
                                         const void* v_scale, const void* valid_rows,
                                         int valid_all, const void* ring_pos, void* out,
                                         int batch, int t_cap, int n_heads, int hpc, int kv_mode,
                                         void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long qs = (long)q_stride;
  switch (kv_mode) {
    case 0:
      return launch<__nv_bfloat16, false>(card, q, qs, k, v, k_scale, v_scale, valid_rows,
                                          valid_all, ring_pos, out, batch, t_cap, n_heads, hpc,
                                          s);
    case 1:
      return launch<int8_t, false>(card, q, qs, k, v, k_scale, v_scale, valid_rows, valid_all,
                                   ring_pos, out, batch, t_cap, n_heads, hpc, s);
    case 2:
      return launch<int8_t, true>(card, q, qs, k, v, k_scale, v_scale, valid_rows, valid_all,
                                  ring_pos, out, batch, t_cap, n_heads, hpc, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fp32 form: q (B, H*64) fp32, rows q_stride elements apart; k/v (B,
// T, H*64) by kv_mode: 4 fp32; 1 int8 with fp32 (B, T) scales; 2 int8 with
// bf16 (B, T, H) scales; valid_rows, valid_all and ring_pos (or null) as above. One
// CTA per (row, head), walking its keys in boxes of `chunk` slots
// (ops/decode_attention.py `ring_plan`). out (B, H*64) fp32. Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a mode it lacks).
extern "C" int kwt_decode_attention_ring_f32(int card, const void* q, long long q_stride,
                                             const void* k, const void* v, const void* k_scale,
                                             const void* v_scale, const void* valid_rows,
                                             int valid_all, const void* ring_pos, void* out,
                                             int batch, int t_cap, int n_heads, int chunk,
                                             int kv_mode, void* stream) {
  const kwt_card::CardScope scope(card);
  if (scope.error()) return scope.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long qs = (long)q_stride;
  switch (kv_mode) {
    case 1:
      return launch_f32<int8_t, false>(card, q, qs, k, v, k_scale, v_scale, valid_rows,
                                       valid_all, ring_pos, out, batch, t_cap, n_heads, chunk, s);
    case 2:
      return launch_f32<int8_t, true>(card, q, qs, k, v, k_scale, v_scale, valid_rows, valid_all,
                                      ring_pos, out, batch, t_cap, n_heads, chunk, s);
    case 4:
      return launch_f32<float, false>(card, q, qs, k, v, k_scale, v_scale, valid_rows, valid_all,
                                      ring_pos, out, batch, t_cap, n_heads, chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
