// Flash attention backward for Hopper (sm_90a), loaded through a plain C
// interface (mmlspark_tpu_torch/ops/flash_attention.py).
//
// Replaces the two Pallas kernels of `_flash_backward` in
// mmlspark_tpu/ops/flash_attention.py: `_dq_kernel` (the pallas_call at
// :318) and `_dkv_kernel` (:330), with `_bwd_p_block` (:174) inlined in
// both.  Same function: from q, k, v, dO (B, S, H, D) and the forward's
// saved statistics lse and delta = rowsum(dO * O) (f32, (B, Sq, H)), each
// tile recomputes P = exp(S * scale - lse) (masked entries and rows whose
// lse is NEG_INF give exactly 0), dP = dO V^T, dS = P * (dP - delta), and
//   K2 `flash_bwd_dq`:  dQ = scale * dS K            (one CTA per query tile)
//   K3 `flash_bwd_dkv`: dV = P^T dO, dK = scale * dS^T Q  (one CTA per key tile)
// Each output has exactly one writer and nothing is accumulated with
// atomics, as in the JAX design, so a run gives the same gradients every
// time.  q_off/k_off place the tensors at global positions for the causal
// mask (query i at q_off + i, key j at k_off + j).
//
// Bound: tensor-core operations.  At the training shape (8, 2048, 8, 128)
// causal, K2 does three (64 x 64 x D) products per live tile and K3 four,
// on O(S D) bytes: far above the card's ~295 operations-per-byte ridge.
//
// Design (a simple first kernel, the backward twin of the forward; wgmma
// and TMA are later work):
//   * bf16: one CTA of 4 warps per (batch*head, 64-row tile); each warp owns
//     16 rows of the CTA's tile.  The CTA stages its own tile pair (Q, dO for
//     K2; K, V for K3) once and walks the other side's 64-row tiles through
//     shared memory, skipping tiles that lie wholly across the causal
//     diagonal.  The products run on the tensor cores through nvcuda::wmma
//     (bf16 in, f32 accumulate).  Scores and dP go through shared memory in
//     f32 for the elementwise step; P and dS are rounded to bf16 as the A
//     operand of the next product.  The gradient accumulators stay in wmma
//     fragments (registers) for the whole walk: unlike the forward, nothing
//     rescales them.  The ragged last tile of either length is masked.
//   * f32: one warp per output row (a query row for K2, a key row for K3),
//     each lane holding D/32 elements, the other side folded one row at a
//     time in f32 FMA (no TF32: the f32 path is the precise reference-grade
//     one).

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using mmlspark::NEG_INF;

namespace {

constexpr int TILE = 64;  // rows of the CTA's tile and of each walked tile
constexpr int WARPS = 4;  // 16 rows per warp
constexpr int THREADS = WARPS * 32;

using bf16 = __nv_bfloat16;

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;     // bf16 (64, D) tile pitch (padding breaks bank conflicts)
  static constexpr int LDS = TILE + 4;  // f32 (16, 64) block pitch
  static constexpr int LDP = TILE + 8;  // bf16 P / dS pitch
  static constexpr int LDO = D + 4;     // f32 output staging pitch
  static constexpr size_t TILE_H = size_t(TILE) * LDH * 2;
  static constexpr size_t WARP_F32 = size_t(16) * LDS * 4;
  // per warp: scores and dP in f32, reused at the end to stage the output
  static constexpr size_t SCRATCH = 2 * WARP_F32;
  static constexpr size_t PB = size_t(TILE) * LDP * 2;  // bf16 P / dS of all warps
  static constexpr size_t STATS = 2 * TILE * 4;         // lse and delta of the query tile
  static constexpr size_t BYTES = 4 * TILE_H + WARPS * SCRATCH + PB + STATS;
  static_assert(size_t(16) * LDO * 4 <= SCRATCH, "output staging fits the warp scratch");
  // wmma needs 32-byte aligned tile pointers: every section keeps it
  static_assert(TILE_H % 32 == 0 && WARP_F32 % 32 == 0 && PB % 32 == 0, "alignment");
};

// Stage TILE rows of D bf16 (row stride `stride` elements) into a padded
// shared tile with 16-byte loads; rows at or past n_rows become zeros.
template <int D, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n_rows, size_t stride) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// The lse and delta of query rows q0..q0+TILE-1 (layout (B, Sq, H)); rows
// past Sq get lse NEG_INF, so their P is exactly 0.
__device__ __forceinline__ void load_stats(float* row_lse, float* row_delta, const float* lse, const float* delta,
                                           int b, int h, int H, int q0, int Sq) {
  if (threadIdx.x < TILE) {
    const int qi = q0 + threadIdx.x;
    const size_t at = (size_t(b) * Sq + qi) * H + h;
    row_lse[threadIdx.x] = qi < Sq ? lse[at] : NEG_INF;
    row_delta[threadIdx.x] = qi < Sq ? delta[at] : 0.f;
  }
}

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using ARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

// out (16, 64) f32 = A (16, D) B^T, with B a (64, D) row-major tile: the
// score-shaped products (Q K^T, dO V^T, K Q^T, V dO^T) of one warp.
template <int D>
__device__ __forceinline__ void product_abt(float* out, const bf16* a, const bf16* bt) {
  using L = Layout<D>;
#pragma unroll
  for (int n = 0; n < TILE / 16; ++n) {
    Acc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ARow fa;
      BCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, L::LDH);
      wmma::load_matrix_sync(fb, bt + n * 16 * L::LDH + kk * 16, L::LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, L::LDS, wmma::mem_row_major);
  }
}

// acc (16, D) += P (16, 64) bf16 times B, a (64, D) row-major tile: the
// gradient-shaped products (dS K, P^T dO, dS^T Q) of one warp.
template <int D>
__device__ __forceinline__ void product_pb(Acc (&acc)[D / 16], const bf16* p, const bf16* b) {
  using L = Layout<D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      ARow fa;
      BRow fb;
      wmma::load_matrix_sync(fa, p + kk * 16, L::LDP);
      wmma::load_matrix_sync(fb, b + kk * 16 * L::LDH + n * 16, L::LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Write one warp's (16, D) accumulator to rows row0.. of a (B, S, H, D)
// bf16 tensor, times `mul`, through the warp's f32 staging block.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, Acc (&acc)[D / 16], float* stage, int row0, int n_rows,
                                           size_t stride, float mul) {
  using L = Layout<D>;
  const int lane = threadIdx.x % 32;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::store_matrix_sync(stage + n * 16, acc[n], L::LDO, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    if (row0 + r < n_rows) dst[size_t(row0 + r) * stride + c] = __float2bfloat16(mul * stage[r * L::LDO + c]);
  }
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Sq, int Sk, float scale,
                      int causal, int q_off, int k_off) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::TILE_H);
  bf16* Ks = reinterpret_cast<bf16*>(smem + 2 * L::TILE_H);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 3 * L::TILE_H);
  unsigned char* scratch = smem + 4 * L::TILE_H;
  bf16* Ps = reinterpret_cast<bf16*>(scratch + WARPS * L::SCRATCH);
  float* row_lse = reinterpret_cast<float*>(scratch + WARPS * L::SCRATCH + L::PB);
  float* row_delta = row_lse + TILE;

  const int n_qt = (Sq + TILE - 1) / TILE;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * TILE;  // heaviest causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t stride = size_t(H) * D;
  const size_t q_base = (size_t(b) * Sq * H + h) * D;
  const size_t k_base = (size_t(b) * Sk * H + h) * D;

  load_tile<D, L::LDH>(Qs, q + q_base, q0, Sq, stride);
  load_tile<D, L::LDH>(dOs, dout + q_base, q0, Sq, stride);
  load_stats(row_lse, row_delta, lse, delta, b, h, H, q0, Sq);

  const int last_row = min(q0 + TILE, Sq) - 1;
  int n_kt = (Sk + TILE - 1) / TILE;
  if (causal) {
    const int reach = q_off + last_row - k_off;  // key tile kt is live while k_off + kt*TILE <= reach + k_off
    n_kt = reach < 0 ? 0 : min(n_kt, reach / TILE + 1);
  }

  float* Sw = reinterpret_cast<float*>(scratch + warp * L::SCRATCH);
  float* dPw = Sw + 16 * L::LDS;
  bf16* Pw = Ps + warp * 16 * L::LDP;
  Acc acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, L::LDH>(Ks, k + k_base, k0, Sk, stride);
    load_tile<D, L::LDH>(Vs, v + k_base, k0, Sk, stride);
    __syncthreads();

    product_abt<D>(Sw, Qs + warp * 16 * L::LDH, Ks);    // S = Q K^T
    product_abt<D>(dPw, dOs + warp * 16 * L::LDH, Vs);  // dP = dO V^T
    __syncwarp();

    // dS = P (dP - delta); a lane holds columns lane and lane + 32
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int qi = q0 + row;
      const float l = row_lse[row], dl = row_delta[row];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const int col = k0 + c;
        const bool live = col < Sk && l != NEG_INF && !(causal && k_off + col > q_off + qi);
        const float p = live ? expf(Sw[r * L::LDS + c] * scale - l) : 0.f;
        Pw[r * L::LDP + c] = __float2bfloat16(p * (dPw[r * L::LDS + c] - dl));
      }
    }
    __syncwarp();

    product_pb<D>(acc, Pw, Ks);  // dQ += dS K
  }
  store_rows<D>(dq + q_base, acc, Sw, q0 + warp * 16, Sq, stride, scale);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                       int Sq, int Sk, float scale, int causal, int q_off, int k_off) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::TILE_H);
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * L::TILE_H);
  bf16* dOs = reinterpret_cast<bf16*>(smem + 3 * L::TILE_H);
  unsigned char* scratch = smem + 4 * L::TILE_H;
  bf16* Ps = reinterpret_cast<bf16*>(scratch + WARPS * L::SCRATCH);
  float* row_lse = reinterpret_cast<float*>(scratch + WARPS * L::SCRATCH + L::PB);
  float* row_delta = row_lse + TILE;

  const int k0 = int(blockIdx.x) * TILE;  // key tile 0 walks the most query tiles under the causal mask
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t stride = size_t(H) * D;
  const size_t q_base = (size_t(b) * Sq * H + h) * D;
  const size_t k_base = (size_t(b) * Sk * H + h) * D;

  load_tile<D, L::LDH>(Ks, k + k_base, k0, Sk, stride);
  load_tile<D, L::LDH>(Vs, v + k_base, k0, Sk, stride);

  const int n_qt = (Sq + TILE - 1) / TILE;
  int qt0 = 0;
  if (causal) {
    // the first query tile holding a row at or past the tile's first key
    const int reach = k_off + k0 - q_off;
    qt0 = reach <= 0 ? 0 : min(n_qt, reach / TILE);
  }

  float* Sw = reinterpret_cast<float*>(scratch + warp * L::SCRATCH);
  float* dPw = Sw + 16 * L::LDS;
  bf16* Pw = Ps + warp * 16 * L::LDP;
  const bf16* Kw = Ks + warp * 16 * L::LDH;
  const bf16* Vw = Vs + warp * 16 * L::LDH;
  Acc dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<D, L::LDH>(Qs, q + q_base, q0, Sq, stride);
    load_tile<D, L::LDH>(dOs, dout + q_base, q0, Sq, stride);
    load_stats(row_lse, row_delta, lse, delta, b, h, H, q0, Sq);
    __syncthreads();

    product_abt<D>(Sw, Kw, Qs);    // S^T = K Q^T
    product_abt<D>(dPw, Vw, dOs);  // dP^T = V dO^T
    __syncwarp();

    // P^T, kept in f32 over the scores and rounded to bf16 for the product;
    // a lane holds query columns lane and lane + 32
    for (int r = 0; r < 16; ++r) {
      const int kj = k0 + warp * 16 + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float l = row_lse[c];
        const bool live = kj < Sk && l != NEG_INF && !(causal && k_off + kj > q_off + q0 + c);
        const float p = live ? expf(Sw[r * L::LDS + c] * scale - l) : 0.f;
        Sw[r * L::LDS + c] = p;
        Pw[r * L::LDP + c] = __float2bfloat16(p);
      }
    }
    __syncwarp();
    product_pb<D>(dv_acc, Pw, dOs);  // dV += P^T dO
    __syncwarp();                    // every lane has read P^T before dS^T overwrites it

    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        Pw[r * L::LDP + c] = __float2bfloat16(Sw[r * L::LDS + c] * (dPw[r * L::LDS + c] - row_delta[c]));
      }
    }
    __syncwarp();
    product_pb<D>(dk_acc, Pw, Qs);  // dK += dS^T Q
  }
  store_rows<D>(dk + k_base, dk_acc, Sw, k0 + warp * 16, Sk, stride, scale);
  store_rows<D>(dv + k_base, dv_acc, Sw, k0 + warp * 16, Sk, stride, 1.f);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq, int B, int H, int Sq, int Sk,
                     float scale, int causal, int q_off, int k_off) {
  constexpr int E = D / 32;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;  // (b, h, qi), qi fastest
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * H * Sq) return;  // whole warps leave together
  const int qi = int(row % Sq);
  const int bh = int(row / Sq);
  const int b = bh / H, h = bh % H;
  const size_t stride = size_t(H) * D;
  const size_t col = size_t(h) * D + size_t(lane) * E;
  const size_t at = (size_t(b) * Sq + qi) * H + h;
  const float l = lse[at], dl = delta[at];

  float qv[E], dov[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = q[(size_t(b) * Sq + qi) * stride + col + e] * scale;
    dov[e] = dout[(size_t(b) * Sq + qi) * stride + col + e];
    acc[e] = 0.f;
  }
  const float* kp = k + size_t(b) * Sk * stride + col;
  const float* vp = v + size_t(b) * Sk * stride + col;
  int n_keys = causal ? max(0, min(Sk, q_off + qi - k_off + 1)) : Sk;
  if (l == NEG_INF) n_keys = 0;  // a row that saw no key has P = 0
  for (int j = 0; j < n_keys; ++j) {
    float s_part = 0.f, dp_part = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s_part += qv[e] * kp[size_t(j) * stride + e];
      dp_part += dov[e] * vp[size_t(j) * stride + e];
    }
    const float p = expf(mmlspark::warp_sum(s_part) - l);
    const float ds = p * (mmlspark::warp_sum(dp_part) - dl);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += ds * kp[size_t(j) * stride + e];
  }
#pragma unroll
  for (int e = 0; e < E; ++e) dq[(size_t(b) * Sq + qi) * stride + col + e] = scale * acc[e];
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int B,
                      int H, int Sq, int Sk, float scale, int causal, int q_off, int k_off) {
  constexpr int E = D / 32;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;  // (b, h, kj), kj fastest
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * H * Sk) return;  // whole warps leave together
  const int kj = int(row % Sk);
  const int bh = int(row / Sk);
  const int b = bh / H, h = bh % H;
  const size_t stride = size_t(H) * D;
  const size_t col = size_t(h) * D + size_t(lane) * E;

  float kv[E], vv[E], dk_acc[E], dv_acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    kv[e] = k[(size_t(b) * Sk + kj) * stride + col + e];
    vv[e] = v[(size_t(b) * Sk + kj) * stride + col + e];
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }
  const float* qp = q + size_t(b) * Sq * stride + col;
  const float* dop = dout + size_t(b) * Sq * stride + col;
  // queries qi with q_off + qi >= k_off + kj see this key under the causal mask
  const int q_start = causal ? max(0, k_off + kj - q_off) : 0;
  for (int qi = q_start; qi < Sq; ++qi) {
    const size_t at = (size_t(b) * Sq + qi) * H + h;
    const float l = lse[at];
    if (l == NEG_INF) continue;  // uniform across the warp
    float s_part = 0.f, dp_part = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      s_part += qp[size_t(qi) * stride + e] * scale * kv[e];
      dp_part += dop[size_t(qi) * stride + e] * vv[e];
    }
    const float p = expf(mmlspark::warp_sum(s_part) - l);
    const float ds = p * (mmlspark::warp_sum(dp_part) - delta[at]);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dv_acc[e] += p * dop[size_t(qi) * stride + e];
      dk_acc[e] += ds * qp[size_t(qi) * stride + e];
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    dk[(size_t(b) * Sk + kj) * stride + col + e] = scale * dk_acc[e];
    dv[(size_t(b) * Sk + kj) * stride + col + e] = dv_acc[e];
  }
}

template <int D>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int H, int Sq, int Sk, float scale, int causal,
                      int q_off, int k_off, cudaStream_t stream) {
  if (dtype == 1) {
    using L = Layout<D>;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(L::BYTES));
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + TILE - 1) / TILE, B * H);
    flash_bwd_dq_bf16<D><<<grid, THREADS, L::BYTES, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, Sq, Sk, scale, causal, q_off, k_off);
  } else {
    const unsigned blocks = unsigned(((long long)B * H * Sq + WARPS - 1) / WARPS);
    flash_bwd_dq_f32<D><<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), B, H, Sq, Sk, scale, causal, q_off,
        k_off);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, float scale,
                       int causal, int q_off, int k_off, cudaStream_t stream) {
  if (dtype == 1) {
    using L = Layout<D>;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(L::BYTES));
    if (err != cudaSuccess) return err;
    dim3 grid((Sk + TILE - 1) / TILE, B * H);
    flash_bwd_dkv_bf16<D><<<grid, THREADS, L::BYTES, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk,
        scale, causal, q_off, k_off);
  } else {
    const unsigned blocks = unsigned(((long long)B * H * Sk + WARPS - 1) / WARPS);
    flash_bwd_dkv_f32<D><<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), B, H, Sq,
        Sk, scale, causal, q_off, k_off);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients);
// lse and delta are f32 (B, Sq, H).  Each returns the cudaError_t of its
// launch.
extern "C" int mmlspark_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, void* dq, int B, int H, int Sq, int Sk,
                                     int D, float scale, int causal, int q_off, int k_off, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (D == 128) return launch_dq<128>(dtype, q, k, v, dout, l, dl, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  if (D == 64) return launch_dq<64>(dtype, q, k, v, dout, l, dl, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  return cudaErrorInvalidValue;
}

extern "C" int mmlspark_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                      const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Sq,
                                      int Sk, int D, float scale, int causal, int q_off, int k_off, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (B == 0 || H == 0 || Sk == 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (D == 128)
    return launch_dkv<128>(dtype, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  if (D == 64)
    return launch_dkv<64>(dtype, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  return cudaErrorInvalidValue;
}
