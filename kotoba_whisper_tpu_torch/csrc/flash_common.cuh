// Building blocks of the mma.sync kernel K8 (flash_attention_int8.cu):
// 64-row bf16 tiles of the model's (B, T, H, 64) layout staged in shared
// memory with cp.async, XOR-swizzled so ldmatrix reads are free of bank
// conflicts, and mma.sync m16n8k16 products with bf16 operands and fp32
// sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kwt_flash {

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per tile (4 warps x 16)
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk `chunk` (0..7) of row `row` in a
// (rows x 64) bf16 tile: chunks are XOR-swizzled by the row's low 3 bits.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kD + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the destination
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0+64) of one head into a swizzled smem tile;
// rows >= n_rows are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const __nv_bfloat16* base,
                                          int row0, int n_rows,
                                          long row_stride, int tid) {
#pragma unroll
  for (int i = 0; i < (kBQ * kD / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3, ch = c & 7;
    const int g = row0 + r;
    const bool ok = g < n_rows;
    const __nv_bfloat16* src = base + (ok ? (long)g * row_stride : 0) + ch * 8;
    cp_async16(tile + swz(r, ch), src, ok);
  }
}

// acc (16 x 64 head dims) += p (16 x 64 tile rows, as fp32 accumulators in
// the mma C layout, rounded to bf16 here) * tile, where tile is a swizzled
// (64 rows x 64 head dims) tile: K8's P V.
__device__ __forceinline__ void mma_acc_tile(float (*acc)[4],
                                             const float (*p)[4],
                                             const __nv_bfloat16* tile,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t b[4];
      const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(b, tile + swz(row, dp * 2 + (lane >> 4)));
      mma16816(acc[2 * dp], pa, b[0], b[1]);
      mma16816(acc[2 * dp + 1], pa, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

}  // namespace kwt_flash
