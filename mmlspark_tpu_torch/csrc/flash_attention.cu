// Flash attention forward for Hopper (sm_90a), loaded through a plain C
// interface (mmlspark_tpu_torch/ops/flash_attention.py).
//
// Replaces the Pallas kernel `_flash_kernel` / `_flash_forward` of
// mmlspark_tpu/ops/flash_attention.py (the pallas_call at :148) in all its
// variants.  Same function: q (B, Sq, H, D) and k, v (B, Sk, H, D) read in
// place (no relayout to (B*H, S, D)), causal or not, f32 running max /
// normalizer / accumulator, output in q's dtype.  Optional log-sum-exp
// output `lse` (f32, written directly in the public (B, Sq, H) layout,
// natural-log units): m + log(l) of the scaled scores, NEG_INF for a row
// that sees no key.  `q_off`/`k_off` shift the global positions of the
// causal mask (query row i is at q_off + i, key j at k_off + j); a row with
// no visible key gives zeros.  Any Sq and Sk: ragged tiles are masked here.
//
// Bound: tensor-core operations.  At the prefill and training shapes
// (S >= 1024) attention does O(S^2 D) work on O(S D) bytes, far above the
// card's ~295 operations-per-byte ridge in bf16, so the kernel is as fast
// as its two products run and as little as the softmax between them holds
// them up.
//
// Design, bf16 (head dim 64 or 128):
//   * One CTA of two consumer warpgroups (256 threads) owns 128 query rows
//     of one (batch, head), 64 rows per warpgroup; query tiles launch
//     heaviest-first (causal rows near the end see the most keys).
//   * Q is staged once and K/V tiles of 128 keys stream through a 2-stage
//     ring in shared memory, all by TMA (tensor maps over the in-place
//     (B, S, H, D) layout, 128-byte swizzle, rows past S read as zeros).
//     Each stage has a "full" mbarrier with a transaction count and an
//     "empty" one that all 256 threads arrive on; one thread refills a
//     stage once it is empty, so tile t + 2 loads while tile t + 1 is
//     computed.  160 KB of shared memory at D = 128 (1 CTA per SM); 80 KB
//     at D = 64, where the kernel is held to 128 registers so that two
//     CTAs share an SM (the softmax is as long as the products there).
//     Descriptors advance in their low word only, and the masks compare
//     against two per-tile limits, to stay inside those registers.
//   * S = Q K^T: wgmma m64n128k16, both operands in shared memory
//     (K-major); the 64 x 128 f32 scores stay in registers.
//   * Online softmax in registers, in base 2: scale * log2(e) folds into
//     one FMA before exp2.  A row of the accumulator lies in the 4 lanes
//     of a quad, so row maxima take two shuffles; row sums stay per thread
//     until the end.  Only tiles that straddle the causal diagonal or the
//     ragged end of Sk are masked; a tile the warpgroup's rows cannot see
//     is skipped.
//   * O += P V: P rounded to bf16 stays in registers as wgmma's A operand
//     (the accumulator layout of S is the A-fragment layout of P); V is
//     the B operand straight from its tile (MN-major, transpose bit).  The
//     m64n{D}k16 accumulator stays in registers; the rescale is a
//     register multiply.
//   * Epilogue: divide by l (l = 0 gives 0), stage the bf16 rows in the
//     warpgroup's own Q rows of shared memory and write rows < Sq with
//     16-byte stores; lse = (m2 + log2 l) * ln 2 with m2 the base-2 max.
//   * f32: one warp per query row, each lane holding D/32 elements, keys
//     folded one at a time with the same online-softmax algebra in f32
//     FMA (no TF32: the f32 path is the precise reference-grade one).

#include "common.cuh"
#include "sm90.cuh"

using mmlspark::NEG_INF;
namespace sm90 = mmlspark::sm90;

namespace {

constexpr int WARPS = 4;  // f32 kernel: one query row per warp
constexpr int THREADS = WARPS * 32;

constexpr int BM = 128;             // bf16: query rows per CTA, 64 per warpgroup
constexpr int BN = 128;             // bf16: keys per K/V tile
constexpr int STAGES = 2;           // K/V ring depth
constexpr int WG_THREADS = 128;     // one warpgroup
constexpr int BF16_THREADS = 2 * WG_THREADS;
constexpr float LN2 = 0.69314718055994531f;

// Shared memory of the bf16 kernel: Q, then STAGES x (K, V), each tile
// stored as D / 64 swizzled boxes of 64 columns (see sm90.cuh).
template <int D>
struct Smem {
  static constexpr uint32_t BOX_Q = BM * 128;   // one 64-column box of Q
  static constexpr uint32_t BOX_KV = BN * 128;  // one 64-column box of K or V
  static constexpr uint32_t Q = BM * D * 2;
  static constexpr uint32_t KV = BN * D * 2;    // one K or V tile
  static constexpr uint32_t BYTES = Q + STAGES * 2 * KV;
  static constexpr size_t ALLOC = BYTES + 1024;  // room to align the base to the 1024-byte swizzle atom
};

using sm90::ex2;
using sm90::pack_bf16;

// Stage `kt`'s K and V tiles into ring slot `stage` (one thread).
template <int D>
__device__ __forceinline__ void load_kv(unsigned char* ring, uint64_t* full, const CUtensorMap* k_map,
                                        const CUtensorMap* v_map, int stage, int kt, int h, int b) {
  using L = Smem<D>;
  unsigned char* k_tile = ring + stage * 2 * L::KV;
  sm90::mbar_arrive_expect_tx(&full[stage], 2 * L::KV);
#pragma unroll
  for (int box = 0; box < D / 64; ++box) {
    sm90::tma_load_4d(k_tile + box * L::BOX_KV, k_map, &full[stage], box * 64, h, kt * BN, b);
    sm90::tma_load_4d(k_tile + L::KV + box * L::BOX_KV, v_map, &full[stage], box * 64, h, kt * BN, b);
  }
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS, D == 64 ? 2 : 1)  // D = 64: 2 CTAs per SM
    flash_fwd_bf16(__grid_constant__ const CUtensorMap q_map, __grid_constant__ const CUtensorMap k_map,
                   __grid_constant__ const CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int H, int Sq, int Sk, float scale_log2, int causal, int q_off,
                   int k_off) {
  using L = Smem<D>;
  constexpr int NO = D / 2;  // O accumulator registers per thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, kv_full[STAGES], kv_empty[STAGES];
  unsigned char* q_tile = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = q_tile + L::Q;

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, warp = (tid % WG_THREADS) / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * BM;  // heaviest causal tiles first
  const int wg_q0 = q0 + wg * 64;                                // this warpgroup's first row

  const int last_row = min(q0 + BM, Sq) - 1;
  int n_kt = (Sk + BN - 1) / BN;
  if (causal) {
    // key tile kt is live while k_off + kt*BN <= q_off + last_row: tiles
    // above the diagonal add nothing, and none is live when every key of
    // the first tile lies past the last query
    const int reach = q_off + last_row - k_off;
    n_kt = reach < 0 ? 0 : min(n_kt, reach / BN + 1);
  }

  if (tid == 0) {
    sm90::mbar_init(&q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], BF16_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0 && n_kt > 0) {
    sm90::mbar_arrive_expect_tx(&q_full, L::Q);
#pragma unroll
    for (int box = 0; box < D / 64; ++box)
      sm90::tma_load_4d(q_tile + box * L::BOX_Q, &q_map, &q_full, box * 64, h, q0, b);
    for (int kt = 0; kt < min(n_kt, STAGES); ++kt) load_kv<D>(ring, kv_full, &k_map, &v_map, kt, kt, h, b);
  }

  float s[64];  // scores of this thread's two rows (see sm90.cuh for the layout)
  float o[NO];
  uint32_t p[32];  // probabilities as bf16 pairs: the A operand of P V
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max of the base-2 scaled scores
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  const int row = warp * 16 + lane / 4;  // rows row and row + 8 of the warpgroup's 64
  const int col = 2 * (lane % 4);        // + 8j (+1): columns within a tile

  const uint64_t dq = sm90::desc_sw128(sm90::smem_addr(q_tile) + wg * 64 * 128, 16, 1024);
  if (n_kt > 0) sm90::mbar_wait(&q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % STAGES;
    const uint32_t phase = (kt / STAGES) & 1;
    const int k0 = kt * BN;
    sm90::mbar_wait(&kv_full[stage], phase);
    // a tile wholly above the diagonal for this warpgroup's rows adds nothing
    const bool hidden = causal && k_off + k0 > q_off + wg_q0 + 63;
    if (!hidden) {
      const uint32_t k_addr = sm90::smem_addr(ring + stage * 2 * L::KV);
      const uint64_t dk = sm90::desc_sw128(k_addr, 16, 1024);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = sm90::desc_advance(dq, (kk / 4) * L::BOX_Q + (kk % 4) * 32);
        const uint64_t db = sm90::desc_advance(dk, (kk / 4) * L::BOX_KV + (kk % 4) * 32);
        if (kk == 0)
          sm90::wgmma_m64n128k16_ss(s, da, db);
        else
          sm90::wgmma_m64n128k16_ss_acc(s, da, db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // mask only a tile that straddles the diagonal or the end of Sk
      const bool full = k0 + BN <= Sk && (!causal || k_off + k0 + BN - 1 <= q_off + wg_q0);
      if (!full) {
        // entry i is key k0 + col + dc of query wg_q0 + row + dr (dc, dr
        // constants): hidden past Sk, or above the diagonal when causal
        const int key_end = Sk - k0 - col;
        const int diag = causal ? q_off + wg_q0 + row - k_off - k0 - col : BN;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int dc = 8 * (i / 4) + i % 2, dr = 8 * ((i / 2) % 2);
          if (dc >= key_end || dc > diag + dr) s[i] = -INFINITY;
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float base[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row that sees nothing yet stays at zero weight
        corr[r] = ex2(m[r] - base[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= corr[(i / 2) % 2];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p0 = ex2(fmaf(s[2 * j], scale_log2, -base[j % 2]));
        const float p1 = ex2(fmaf(s[2 * j + 1], scale_log2, -base[j % 2]));
        l[j % 2] += p0 + p1;
        p[j] = pack_bf16(p0, p1);
      }

      const uint64_t dv = sm90::desc_sw128(k_addr + L::KV, L::BOX_KV, 1024);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = sm90::desc_advance(dv, kk * 16 * 128);  // 16 keys down
        if constexpr (D == 128)
          sm90::wgmma_m64n128k16_rs_mn(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], db);
        else
          sm90::wgmma_m64n64k16_rs_mn(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
    }
    sm90::mbar_arrive(&kv_empty[stage]);
    if (tid == 0 && kt + STAGES < n_kt) {
      sm90::mbar_wait(&kv_empty[stage], phase);  // both warpgroups are done with tile kt
      load_kv<D>(ring, kv_full, &k_map, &v_map, stage, kt + STAGES, h, b);
    }
    __syncwarp();
  }

  // epilogue: whole row sums, O / l staged as bf16 in this warpgroup's own
  // (no longer read) Q rows, same swizzle, then 16-byte rows to `out`
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = wg * 64 + row + 8 * r;  // row within the CTA's 128
      const uint32_t at = (j / 8) * L::BOX_Q + R * 128 + (((j % 8) ^ (R % 8)) * 16) + col * 2;
      *reinterpret_cast<uint32_t*>(q_tile + at) = pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  sm90::named_barrier_sync(1 + wg, WG_THREADS);
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = tid % WG_THREADS; i < 64 * CHUNKS; i += WG_THREADS) {
    const int R = wg * 64 + i / CHUNKS, j = i % CHUNKS;
    const int qi = q0 + R;
    if (qi < Sq) {
      const uint32_t at = (j / 8) * L::BOX_Q + R * 128 + (((j % 8) ^ (R % 8)) * 16);
      *reinterpret_cast<uint4*>(out + ((size_t(b) * Sq + qi) * H + h) * D + j * 8) =
          *reinterpret_cast<const uint4*>(q_tile + at);
    }
  }
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = wg_q0 + row + 8 * r;
      if (qi < Sq) lse[(size_t(b) * Sq + qi) * H + h] = l[r] == 0.f ? NEG_INF : (m[r] + log2f(l[r])) * LN2;
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
  using L = Smem<D>;
  CUtensorMap q_map, k_map, v_map;
  if (!sm90::encode_bshd_bf16(&q_map, q, B, Sq, H, D, BM)) return cudaErrorInvalidValue;
  if (Sk > 0) {
    if (!sm90::encode_bshd_bf16(&k_map, k, B, Sk, H, D, BN) || !sm90::encode_bshd_bf16(&v_map, v, B, Sk, H, D, BN))
      return cudaErrorInvalidValue;
  } else {
    k_map = v_map = q_map;  // no key tile is ever loaded
  }
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::ALLOC));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BM - 1) / BM);
  flash_fwd_bf16<D><<<grid, BF16_THREADS, L::ALLOC, stream>>>(q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out),
                                                               lse, H, Sq, Sk, scale * 1.4426950408889634f, causal,
                                                               q_off, k_off);
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out 16-byte aligned: TMA).
// `lse` may be null (no log-sum-exp output).  Returns the cudaError_t of the launch.
extern "C" int mmlspark_flash_forward(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                                      int H, int Sq, int Sk, int D, float scale, int causal, int q_off, int k_off,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  // the bf16 kernel folds the scale into its base-2 running max
  if (dtype == 1 && !(scale > 0.f)) return cudaErrorInvalidValue;
  if (dtype == 1 && D == 128) return launch_bf16<128>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  if (dtype == 1 && D == 64) return launch_bf16<64>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  if (dtype == 0 && D == 128) return launch_f32<128>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  if (dtype == 0 && D == 64) return launch_f32<64>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
  return cudaErrorInvalidValue;
}
