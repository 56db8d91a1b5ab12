// Warp-level tensor-core building blocks (mma.sync, ldmatrix, cp.async)
// for the bf16 dQ kernel K2 at head dims 8, 16 and 32,
// `flash_bwd_dq_mma<D>` (flash_backward.cu); the f32 kernels use its
// cp.async helpers.
//
// This kernel gives each warp 16 rows of a 64-row tile and builds every
// product from m16n8k16 steps (m16n8k8 when the contraction is head dim
// 8), with operands loaded from padded shared tiles by ldmatrix.
//
// Layouts (PTX ISA, mma.m16n8k16 / m16n8k8 with .bf16): lane t of a warp
// has g = t / 4 and tig = t % 4.  An f32 accumulator d[4] holds rows g and
// g + 8 (d[0..1] and d[2..3]) at columns 2 tig and 2 tig + 1 of an 8-wide
// n-tile.  The A fragment of a k16 step is four bf16 pairs: (row g, k
// 2 tig), (row g + 8, k 2 tig), (row g, k 8 + 2 tig), (row g + 8, k 8 +
// 2 tig); of a k8 step the first two.  So the accumulators of two
// neighbouring n-tiles, rounded to bf16 pairs, ARE the A fragment of a
// k16 step over those 16 columns: dS stays in registers between the score
// products and the product that consumes it.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace mmlspark {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;      // rows of a staged tile: 16 per warp, or a walked tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// bf16 elements per shared row of a D-column tile: the 8 rows one ldmatrix
// reads then start in 8 distinct 16-byte bank groups (16-byte rows at
// D = 8 do so unpadded; 48- and 80-byte rows at D = 16 and 32).
template <int D>
__host__ __device__ constexpr int pitch() {
  return D == 8 ? 8 : D + 8;
}

// k steps of a product that contracts over D: D / 16 steps of k16, or one
// k8 step at D = 8.
template <int D>
struct Frag {
  static_assert(D == 8 || D == 16 || D == 32, "the mma.sync kernels take head dims 8, 16 and 32");
  static constexpr int KS = D >= 16 ? D / 16 : 1;
};

// 16 bytes from global to shared memory, asynchronously; `valid` false
// reads nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sm90::smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed cp.async groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 x 8 bf16 matrices: thread t gives the address of row t % 8 of matrix
// t / 8 and receives, in r[i], row t / 4, columns 2 (t % 4) and 2 (t % 4)
// + 1 of matrix i (with `trans`, rows 2 (t % 4) and 2 (t % 4) + 1 of
// column t / 4).  The x2 forms read the addresses of threads 0-15.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(sm90::smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(sm90::smem_addr(p)));
}

// d += A B on one warp: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B on one warp: A 16 x 8 bf16 (row), B 8 x 8 bf16 (col).
__device__ __forceinline__ void mma_1688(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Rows [r0, r0 + 64) of head h of a (B, S, H, D) bf16 tensor into a
// padded shared tile, rows at or past S as zeros (all threads of the CTA).
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, int b, int h, int H, int S, int r0) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int row = i / CHUNKS, c = i % CHUNKS;
    const int r = r0 + row;
    const bool ok = r < S;
    const bf16* src = base + ((size_t(b) * S + (ok ? r : 0)) * H + h) * D + c * 8;
    cp_async16(dst + row * pitch<D>() + c * 8, src, ok);
  }
}

// The A fragments of 16 rows of a shared tile (`rows` points at the first)
// over all D columns.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[Frag<D>::KS][4], const bf16* rows, int lane) {
  constexpr int P = pitch<D>();
  if constexpr (D == 8) {
    ldmatrix_x2(a[0][0], a[0][1], rows + (lane % 16) * P);
  } else {
#pragma unroll
    for (int ks = 0; ks < Frag<D>::KS; ++ks) ldmatrix_x4(a[ks], rows + (lane % 16) * P + ks * 16 + (lane / 16) * 8);
  }
}

// s[nt] = A T_nt^T for the 8 n-tiles of a 64-row shared tile T whose rows
// are the product's columns (D contiguous): scores of 16 rows against 64.
template <int D>
__device__ __forceinline__ void score_tile(float (&s)[8][4], const uint32_t (&a)[Frag<D>::KS][4], const bf16* t,
                                           int lane) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
  if constexpr (D == 8) {
#pragma unroll
    for (int n4 = 0; n4 < 2; ++n4) {
      uint32_t kb[4];  // the k8 fragments of n-tiles 4 n4 .. 4 n4 + 3
      ldmatrix_x4(kb, t + (n4 * 32 + lane) * P);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_1688(s[4 * n4 + i], a[0][0], a[0][1], kb[i]);
    }
  } else if constexpr (D == 16) {
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t kb[4];  // columns 0-7 and 8-15 of n-tile nt, then of nt + 1
      ldmatrix_x4(kb, t + ((nt + lane / 16) * 8 + lane % 8) * P + ((lane / 8) % 2) * 8);
      mma_16816(s[nt], a[0], kb[0], kb[1]);
      mma_16816(s[nt + 1], a[0], kb[2], kb[3]);
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      uint32_t kb[4];  // columns 0-7, 8-15, 16-23, 24-31 of n-tile nt
      ldmatrix_x4(kb, t + (nt * 8 + lane % 8) * P + (lane / 8) * 8);
      mma_16816(s[nt], a[0], kb[0], kb[1]);
      mma_16816(s[nt], a[1], kb[2], kb[3]);
    }
  }
}

// acc += A T: A 16 x 64 as bf16 pairs in the accumulator layout of
// `score_tile` (a[nt][r]: row g + 8 r, columns 8 nt + 2 tig and + 1), T a
// 64-row shared tile whose rows are the contraction; acc[j] is the 16 x 8
// accumulator of columns 8 j .. 8 j + 7.
template <int D>
__device__ __forceinline__ void accumulate_tile(float (&acc)[D / 8][4], const uint32_t (&a)[8][2], const bf16* t,
                                                int lane) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint32_t pa[4] = {a[2 * ks][0], a[2 * ks][1], a[2 * ks + 1][0], a[2 * ks + 1][1]};
    if constexpr (D == 8) {
      uint32_t b0, b1;  // rows 16 ks .. + 7 and + 8 .. + 15
      ldmatrix_x2_trans(b0, b1, t + (16 * ks + lane % 16) * P);
      mma_16816(acc[0], pa, b0, b1);
    } else {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];  // rows 16 ks .. + 7 / + 8 .. + 15 of columns 16 np .. + 7, then 16 np + 8 .. + 15
        ldmatrix_x4_trans(vb, t + (16 * ks + lane % 16) * P + 16 * np + (lane / 16) * 8);
        mma_16816(acc[2 * np], pa, vb[0], vb[1]);
        mma_16816(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
  }
}

}  // namespace mma
}  // namespace mmlspark
