// Shared pieces of the f32 attention kernels on the CUDA cores: K1's
// `flash_fwd_f32<D>` (flash_attention.cu) and K2/K3's `flash_bwd_dq_f32<D>`
// / `flash_bwd_dkv_f32<D>` (flash_backward.cu).
//
// Tiles of 64 rows are staged in shared memory by cp.async (the helpers
// below; the bf16 kernels use TMA), each row padded by 4 floats: the rows
// one 128-bit access reads (4 rows of a thread's row group, or 8 rows of
// its column group) then start in distinct 16-byte bank groups at every
// head dim.  A thread of a warp is
// one of 4 row groups x 8 column groups: a product of two tiles gives it a
// register tile of rows rg + 4 i against rows kg + 8 j of the other tile.
// A warp's own strip of 72-float rows carries such a register tile (P, dS)
// from the thread that made it to the threads that multiply it on:
// conflict-free scalar writes, broadcast 128-bit reads.
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace mmlspark {

constexpr int F32_THREADS = 128;  // threads of an f32 CTA: four warps
constexpr int F32_ROWS = 64;      // rows of a staged or walked f32 tile
constexpr int F32_PP = 72;        // floats per row of a warp's strip

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

// Floats per padded shared row of a D-column tile.
template <int D>
__host__ __device__ constexpr int f32_pitch() {
  return D + 4;
}

// Rows [r0, r0 + 64) of head h of a (B, S, H, D) f32 tensor into a padded
// shared tile, rows at or past S as zeros (all threads of the CTA).
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* base, int b, int h, int H, int S, int r0) {
  constexpr int CHUNKS = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < F32_ROWS * CHUNKS; i += F32_THREADS) {
    const int row = i / CHUNKS, c = i % CHUNKS;
    const int r = r0 + row;
    const bool ok = r < S;
    cp_async16(dst + row * f32_pitch<D>() + c * 4, base + ((size_t(b) * S + (ok ? r : 0)) * H + h) * D + c * 4,
                    ok);
  }
}

// Output column n (of D / 8) of thread group kg: runs of 4 columns 32
// apart from D = 32 up (a warp's 8 groups read 128 contiguous bytes of a
// V row), else kg's own D / 8 columns.
template <int D>
__device__ __forceinline__ int f32_col(int kg, int n) {
  return D >= 32 ? (n / 4) * 32 + kg * 4 + n % 4 : kg * (D / 8) + n;
}

}  // namespace mmlspark
