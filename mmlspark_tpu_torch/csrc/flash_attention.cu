// Flash attention forward for Hopper (sm_90a), loaded through a plain C
// interface (mmlspark_tpu_torch/ops/flash_attention.py).
//
// Replaces the Pallas kernel `_flash_kernel` / `_flash_forward` of
// mmlspark_tpu/ops/flash_attention.py (the pallas_call at :148) in all its
// variants.  Same function: q, k, v (B, S, H, D) read in place (no
// relayout to (B*H, S, D)), causal or not, f32 running max / normalizer /
// accumulator, output in q's dtype.  Optional log-sum-exp output `lse`
// (f32, written directly in the public (B, Sq, H) layout): m + log(l) of
// the scaled scores, NEG_INF for a row that sees no key.  `q_off`/`k_off`
// shift the global positions of the causal mask (query row i is at
// q_off + i, key j at k_off + j); a row with no visible key gives zeros.
//
// Bound: tensor-core operations.  At the prefill shapes (S >= 512, D = 128)
// attention does O(S^2 D) work on O(S D) bytes, far above the card's
// ~295 operations-per-byte ridge in bf16.
//
// Design (a simple first kernel; wgmma and TMA are later work):
//   * bf16: one CTA of 4 warps per (batch*head, 64-row query tile).  The
//     CTA walks 64-row K/V tiles staged in shared memory; each warp owns 16
//     query rows.  QK^T and PV run on the tensor cores through
//     nvcuda::wmma (bf16 in, f32 accumulate).  Scores go through shared
//     memory for the online-softmax fold (f32 max / normalizer per row);
//     P is rounded to bf16 for the PV product, the accumulator stays f32
//     in shared memory.  K/V tiles entirely above the causal diagonal are
//     never loaded, the ragged last tile of S is masked, and query tiles
//     launch heaviest-first so the causal triangle's long tiles start
//     early.
//   * f32: one warp per query row, each lane holding D/32 elements, keys
//     folded one at a time with the same online-softmax algebra in f32
//     FMA (no TF32: the f32 path is the precise reference-grade one).

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using mmlspark::NEG_INF;

namespace {

constexpr int TILE = 64;     // query rows per CTA and keys per K/V tile
constexpr int WARPS = 4;     // 16 query rows per warp
constexpr int THREADS = WARPS * 32;

template <int D>
struct Layout {
  static constexpr int LDH = D + 8;     // bf16 Q/K/V row pitch (padding breaks bank conflicts)
  static constexpr int LDS = TILE + 4;  // f32 score pitch
  static constexpr int LDP = TILE + 8;  // bf16 probability pitch
  static constexpr int LDO = D + 4;     // f32 accumulator pitch
  static constexpr size_t Q = size_t(TILE) * LDH * 2;
  static constexpr size_t KV = size_t(TILE) * LDH * 2;
  static constexpr size_t S = size_t(TILE) * LDS * 4;
  static constexpr size_t P = size_t(TILE) * LDP * 2;
  static constexpr size_t O = size_t(TILE) * LDO * 4;
  static constexpr size_t STATS = 3 * TILE * 4;
  static constexpr size_t BYTES = Q + 2 * KV + S + P + O + STATS;
  // wmma needs 32-byte aligned tile pointers: every section keeps it
  static_assert(Q % 32 == 0 && KV % 32 == 0 && S % 32 == 0 && P % 32 == 0 && O % 32 == 0, "alignment");
};

// Stage TILE rows of D bf16 (row stride `stride` elements) into a padded
// shared tile with 16-byte loads; rows at or past n_rows become zeros.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int n_rows, size_t stride) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int H, int Sq, int Sk, float scale, int causal, int q_off,
                   int k_off) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::Q);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::Q + L::KV);
  float* Ss = reinterpret_cast<float*>(smem + L::Q + 2 * L::KV);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::Q + 2 * L::KV + L::S);
  float* Os = reinterpret_cast<float*>(smem + L::Q + 2 * L::KV + L::S + L::P);
  float* row_m = reinterpret_cast<float*>(smem + L::Q + 2 * L::KV + L::S + L::P + L::O);
  float* row_l = row_m + TILE;
  float* row_c = row_l + TILE;

  const int n_qt = (Sq + TILE - 1) / TILE;
  const int q0 = (n_qt - 1 - int(blockIdx.x)) * TILE;  // heaviest causal tiles first
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t stride = size_t(H) * D;
  const __nv_bfloat16* qb = q + (size_t(b) * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + (size_t(b) * Sk * H + h) * D;
  const __nv_bfloat16* vb = v + (size_t(b) * Sk * H + h) * D;

  load_tile<D, L::LDH>(Qs, qb, q0, Sq, stride);
  for (int i = threadIdx.x; i < TILE * L::LDO; i += THREADS) Os[i] = 0.f;
  if (threadIdx.x < TILE) {
    row_m[threadIdx.x] = NEG_INF;
    row_l[threadIdx.x] = 0.f;
  }

  const int last_row = min(q0 + TILE, Sq) - 1;
  int n_kt = (Sk + TILE - 1) / TILE;
  if (causal) {
    // key tile kt is live while k_off + kt*TILE <= q_off + last_row: tiles
    // above the diagonal add nothing, and none is live when every key of
    // the tile's first row lies past the last query
    const int reach = q_off + last_row - k_off;
    n_kt = reach < 0 ? 0 : min(n_kt, reach / TILE + 1);
  }

  const __nv_bfloat16* Qw = Qs + warp * 16 * L::LDH;
  float* Sw = Ss + warp * 16 * L::LDS;
  __nv_bfloat16* Pw = Ps + warp * 16 * L::LDP;
  float* Ow = Os + warp * 16 * L::LDO;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, L::LDH>(Ks, kb, k0, Sk, stride);
    load_tile<D, L::LDH>(Vs, vb, k0, Sk, stride);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < TILE / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_frag;
      wmma::fill_fragment(s_frag, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qw + kk * 16, L::LDH);
        wmma::load_matrix_sync(bt, Ks + n * 16 * L::LDH + kk * 16, L::LDH);
        wmma::mma_sync(s_frag, a, bt, s_frag);
      }
      wmma::store_matrix_sync(Sw + n * 16, s_frag, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online-softmax fold, one row at a time; a lane holds columns lane
    // and lane + 32 of the tile
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int qi = q0 + row;
      const float m_old = row_m[row];
      float s0 = Sw[r * L::LDS + lane] * scale;
      float s1 = Sw[r * L::LDS + lane + 32] * scale;
      const int c0 = k0 + lane, c1 = c0 + 32;
      if (c0 >= Sk || (causal && k_off + c0 > q_off + qi)) s0 = NEG_INF;
      if (c1 >= Sk || (causal && k_off + c1 > q_off + qi)) s1 = NEG_INF;
      const float m_new = fmaxf(m_old, mmlspark::warp_max(fmaxf(s0, s1)));
      const float safe = mmlspark::safe_max(m_new);
      const float p0 = mmlspark::masked_exp(s0, safe);
      const float p1 = mmlspark::masked_exp(s1, safe);
      const float corr = mmlspark::masked_exp(m_old, safe);
      const float sum = mmlspark::warp_sum(p0 + p1);
      Pw[r * L::LDP + lane] = __float2bfloat16(p0);
      Pw[r * L::LDP + lane + 32] = __float2bfloat16(p1);
      if (lane == 0) {
        row_m[row] = m_new;
        row_l[row] = row_l[row] * corr + sum;
        row_c[row] = corr;
      }
    }
    __syncwarp();

    // O = O * corr + P V
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = i / D, c = i % D;
      Ow[r * L::LDO + c] *= row_c[warp * 16 + r];
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag;
      wmma::load_matrix_sync(o_frag, Ow + n * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Pw + kk * 16, L::LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * L::LDH + n * 16, L::LDH);
        wmma::mma_sync(o_frag, a, bv, o_frag);
      }
      wmma::store_matrix_sync(Ow + n * 16, o_frag, L::LDO, wmma::mem_row_major);
    }
  }
  __syncwarp();

  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, c = i % D;
    const int qi = q0 + warp * 16 + r;
    if (qi < Sq) {
      const float l = row_l[warp * 16 + r];
      out[(size_t(b) * Sq + qi) * stride + size_t(h) * D + c] =
          __float2bfloat16(Ow[r * L::LDO + c] / (l == 0.f ? 1.f : l));
    }
  }
  if (lse != nullptr && lane < 16) {
    const int row = warp * 16 + lane;
    const int qi = q0 + row;
    if (qi < Sq) {
      const float l = row_l[row];
      lse[(size_t(b) * Sq + qi) * H + h] = l == 0.f ? NEG_INF : row_m[row] + logf(l);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ out, float* __restrict__ lse, int B, int H, int Sq, int Sk, float scale,
                  int causal, int q_off, int k_off) {
  constexpr int E = D / 32;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;  // (b, h, qi), qi fastest
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * H * Sq) return;  // whole warps leave together
  const int qi = int(row % Sq);
  const int bh = int(row / Sq);
  const int b = bh / H, h = bh % H;
  const size_t stride = size_t(H) * D;
  const size_t col = size_t(h) * D + size_t(lane) * E;

  float qv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = q[(size_t(b) * Sq + qi) * stride + col + e] * scale;
    acc[e] = 0.f;
  }
  const float* kp = k + size_t(b) * Sk * stride + col;
  const float* vp = v + size_t(b) * Sk * stride + col;
  float m = NEG_INF, l = 0.f;
  // keys j with k_off + j <= q_off + qi are visible under the causal mask
  const int n_keys = causal ? max(0, min(Sk, q_off + qi - k_off + 1)) : Sk;
  for (int j = 0; j < n_keys; ++j) {
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) part += qv[e] * kp[size_t(j) * stride + e];
    const float s = mmlspark::warp_sum(part);
    const float m_new = fmaxf(m, s);
    const float p = expf(s - m_new);
    const float corr = mmlspark::masked_exp(m, m_new);
    l = l * corr + p;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = acc[e] * corr + p * vp[size_t(j) * stride + e];
    m = m_new;
  }
  const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
  for (int e = 0; e < E; ++e) out[(size_t(b) * Sq + qi) * stride + col + e] = acc[e] / l_safe;
  if (lse != nullptr && lane == 0) lse[(size_t(b) * Sq + qi) * H + h] = l == 0.f ? NEG_INF : m + logf(l);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H, int Sq,
                        int Sk, float scale, int causal, int q_off, int k_off, cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L::BYTES));
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + TILE - 1) / TILE, B * H);
  flash_fwd_bf16<D><<<grid, THREADS, L::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, H, Sq, Sk, scale, causal, q_off,
      k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H, int Sq,
                       int Sk, float scale, int causal, int q_off, int k_off, cudaStream_t stream) {
  const long long rows = (long long)B * H * Sq;
  const unsigned blocks = unsigned((rows + WARPS - 1) / WARPS);
  flash_fwd_f32<D><<<blocks, THREADS, 0, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                   static_cast<const float*>(v), static_cast<float*>(out), lse, B,
                                                   H, Sq, Sk, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  `lse` may be null (no log-sum-exp
// output).  Returns the cudaError_t of the launch.
extern "C" int mmlspark_flash_forward(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                                      int H, int Sq, int Sk, int D, float scale, int causal, int q_off, int k_off,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  if (dtype == 1 && D == 128) return launch_bf16<128>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  if (dtype == 1 && D == 64) return launch_bf16<64>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  if (dtype == 0 && D == 128) return launch_f32<128>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  if (dtype == 0 && D == 64) return launch_f32<64>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  return cudaErrorInvalidValue;
}
