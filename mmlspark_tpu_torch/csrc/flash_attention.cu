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
// Bound: tensor-core operations at bf16, f32 operations at f32.  At the
// prefill and training shapes (S >= 1024) attention does O(S^2 D) work on
// O(S D) bytes, far above the card's ~295 operations-per-byte ridge in
// bf16, so the kernel is as fast as its two products run and as little as
// the softmax between them holds them up.
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
//
// Design, bf16 at head dims 8, 16 and 32 (`flash_fwd_bf16_narrow<D>`).
// Here each score element carries about 8 instructions that do not depend
// on D (the base-2 FMA, ex2, the mask, the pack) against a 64 x 64 x D
// product, so the kernel is bound by instruction issue and the ex2 rate
// (16 a clock an SM) and, at the prefill shapes, by the walk of the
// heaviest query tile; the design keeps the products off the issue slots
// and shortens that walk:
//   * one CTA owns 64 query rows of one (batch, head), heaviest causal
//     tiles first; Q's A fragments are read once from global memory into
//     registers (at D = 8 the k 8-15 half is zero, see sm90.cuh);
//   * where the grid is too small to fill the card (the wrapper's plan,
//     `_k1_split`), two consumer warpgroups split the CTA's key walk,
//     warpgroup w taking 64-key tiles kt = w (mod 2), which halves the
//     heaviest tile's chain; each keeps its own (m, l, O) and at the end
//     the second hands its triple to the first through shared memory,
//     merged in that fixed order, so a launch's bits do not depend on
//     timing; a full grid runs one consumer warpgroup a CTA (more CTAs an
//     SM, no merge);
//   * a producer warp streams K/V tiles by TMA (16-, 32- or 64-byte rows:
//     no swizzle, 32- and 64-byte swizzles) into a 4-stage ring on
//     full/empty mbarriers, stage kt % 4, so each warpgroup has two stages
//     of its own in flight and no CTA-wide barrier stands in a tile;
//   * S = Q K^T: wgmma m64n64k16 with Q in registers and K K-major in
//     shared memory (one k-step at D = 8 and 16, two at 32); the online
//     softmax is the one above (base 2, quad shuffles for the row max,
//     masks only on tiles that straddle the diagonal or the end of Sk);
//   * O += P V: wgmma m64nDk16, P in registers in the accumulator layout
//     of S, V read MN-major from its tile; O stays in registers and is
//     written with 4-byte stores after the divide.
//
// Design, f32 (`flash_fwd_f32<D>`, every head dim).  Full f32 on the CUDA
// cores, no TF32: the f32 path is the precise, reference-grade one (the
// f32 greedy tokens of the serving paths equal an oracle's).  Bound: f32
// operations (67 TFLOP/s), so the design keeps the FMA pipes fed from
// registers rather than from memory:
//   * one CTA of four warps owns 64 query rows, 16 per warp, heaviest
//     causal tiles first; Q is staged once and 64-key K/V tiles stream
//     through a 2-stage cp.async ring in shared memory, read by all 64
//     rows of the CTA (each K/V byte leaves device memory once a CTA);
//   * a warp's lanes are 4 row groups x 8 key groups: a thread holds a
//     4 x 8 register tile of scores (rows rg + 4i, keys kg + 8j) and
//     builds it from 128-bit shared loads, 128 FMAs for every 12 loads;
//     rows of Q, K and V are padded by 4 floats, so one access's 4 rows
//     or 8 keys fall in distinct bank groups at every head dim;
//   * the online softmax runs once a tile: the scores are scaled to base
//     2 (one multiply, any sign of the scale), a row's max takes three
//     shuffles across its 8 key groups, row sums stay per thread until
//     the end;
//   * P goes through the warp's own 16 x 64 strip of shared memory (72-
//     float rows: conflict-free scalar writes, broadcast 128-bit reads),
//     one __syncwarp, then O += P V with each thread's 4 rows x D/8
//     columns in registers (V rows read as 128 contiguous bytes a warp).

#include <cstring>

#include "common.cuh"
#include "f32.cuh"
#include "sm90.cuh"

using mmlspark::F32_PP;
using mmlspark::F32_ROWS;
using mmlspark::F32_THREADS;
using mmlspark::cp_async_commit;
using mmlspark::cp_async_wait;
using mmlspark::f32_col;
using mmlspark::f32_pitch;
using mmlspark::load_rows_f32;
using mmlspark::NEG_INF;
namespace sm90 = mmlspark::sm90;

namespace {

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

// ---- bf16 at head dims 8, 16 and 32: wgmma on a TMA ring, split key walk ----

constexpr int NARROW_BM = 64;       // query rows per CTA
constexpr int NARROW_BN = 64;       // keys per K/V tile
constexpr int NARROW_STAGES = 4;    // K/V ring depth: tile kt in stage kt % 4
// Consumer warpgroups a CTA splits its key walk between (`split`, 1 or 2,
// planned by the wrapper: 2 when the grid is too small to fill the card),
// warpgroup w walking key tiles kt = w (mod split); then the producer warp.
constexpr int NARROW_MAX_SPLIT = 2;
constexpr int NARROW_THREADS = NARROW_MAX_SPLIT * WG_THREADS + 32;

// Shared memory of the narrow kernel: the ring of STAGES x (K, V) tiles,
// then the second warpgroup's (m, l, O) for the merge, one float per
// thread a row of 128 (conflict-free).
template <int D>
struct NarrowSmem {
  static constexpr uint32_t TILE = sm90::Narrow<D>::TILE;  // one K or V tile
  static constexpr uint32_t RING = NARROW_STAGES * 2 * TILE;
  static constexpr int MERGED = 4 + D / 2;                  // floats a thread hands over
  static constexpr size_t ALLOC = RING + MERGED * WG_THREADS * sizeof(float) + 1024;  // + alignment room
};

template <int D>
__global__ void __launch_bounds__(NARROW_THREADS)
    flash_fwd_bf16_narrow(__grid_constant__ const CUtensorMap k_map, __grid_constant__ const CUtensorMap v_map,
                          const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int H, int Sq, int Sk, float scale_log2, int causal, int q_off,
                          int k_off, int split) {
  using L = NarrowSmem<D>;
  constexpr int NO = D / 2;  // O accumulator registers per thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NARROW_STAGES], empty[NARROW_STAGES];
  unsigned char* ring = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  float* merged = reinterpret_cast<float*>(ring + L::RING);

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS;  // `split`: the producer warp
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * NARROW_BM;  // heaviest causal tiles first

  const int last_row = min(q0 + NARROW_BM, Sq) - 1;
  int n_kt = (Sk + NARROW_BN - 1) / NARROW_BN;
  if (causal) {
    const int reach = q_off + last_row - k_off;
    n_kt = reach < 0 ? 0 : min(n_kt, reach / NARROW_BN + 1);
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NARROW_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], WG_THREADS);  // the warpgroup that walks the stage's tiles
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (wg == split) {
    // producer: tile kt into stage kt % STAGES once its previous tile is consumed
    if (tid % 32 == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int stage = kt % NARROW_STAGES;
        if (kt >= NARROW_STAGES) sm90::mbar_wait(&empty[stage], ((kt / NARROW_STAGES) - 1) & 1);
        unsigned char* dst = ring + stage * 2 * L::TILE;
        sm90::mbar_arrive_expect_tx(&full[stage], 2 * L::TILE);
        sm90::tma_load_4d(dst, &k_map, &full[stage], 0, h, kt * NARROW_BN, b);
        sm90::tma_load_4d(dst + L::TILE, &v_map, &full[stage], 0, h, kt * NARROW_BN, b);
      }
    }
    return;
  }

  const int t = tid % WG_THREADS, warp = t / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 4;  // rows row and row + 8 of the 64
  const int col = 2 * (lane % 4);        // + 8j (+1): columns within a tile
  uint32_t qa[sm90::Narrow<D>::KS][4];   // Q's A fragments, held for the whole walk
  sm90::load_frags<D>(qa, q, b, h, H, Sq, q0 + row);

  float s[32];     // scores of this thread's two rows (see sm90.cuh for the layout)
  uint32_t p[16];  // probabilities as bf16 pairs: the A operand of P V
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max of the base-2 scaled scores
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int kt = wg; kt < n_kt; kt += split) {
    const int stage = kt % NARROW_STAGES;
    const int k0 = kt * NARROW_BN;
    sm90::mbar_wait(&full[stage], (kt / NARROW_STAGES) & 1);
    const uint32_t k_addr = sm90::smem_addr(ring + stage * 2 * L::TILE);
    sm90::wgmma_fence();
    sm90::score_rs<D, NARROW_BN>(s, qa, k_addr);  // S = Q K^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);

    // mask only a tile that straddles the diagonal or the end of Sk
    const bool whole = k0 + NARROW_BN <= Sk && (!causal || k_off + k0 + NARROW_BN - 1 <= q_off + q0);
    if (!whole) {
      // entry i is key k0 + col + dc of query q0 + row + dr (dc, dr
      // constants): hidden past Sk, or above the diagonal when causal
      const int key_end = Sk - k0 - col;
      const int diag = causal ? q_off + q0 + row - k_off - k0 - col : NARROW_BN;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int dc = 8 * (i / 4) + i % 2, dr = 8 * ((i / 2) % 2);
        if (dc >= key_end || dc > diag + dr) s[i] = -INFINITY;
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
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
    for (int j = 0; j < 16; ++j) {
      const float p0 = ex2(fmaf(s[2 * j], scale_log2, -base[j % 2]));
      const float p1 = ex2(fmaf(s[2 * j + 1], scale_log2, -base[j % 2]));
      l[j % 2] += p0 + p1;
      p[j] = pack_bf16(p0, p1);
    }

    sm90::wgmma_fence();
    sm90::accumulate_rs<D, NARROW_BN / 16>(o, p, k_addr + L::TILE);  // O += P V
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::mbar_arrive(&empty[stage]);
  }

  // merge the two walks in a fixed order (warpgroup 0's, then 1's), so that
  // a launch's bits do not depend on timing: warpgroup 1 hands its (m, l, O)
  // over, warpgroup 0 rescales both to the joint max and writes the rows
  if (split == 2) {
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        merged[r * WG_THREADS + t] = m[r];
        merged[(2 + r) * WG_THREADS + t] = l[r];
      }
#pragma unroll
      for (int i = 0; i < NO; ++i) merged[(4 + i) * WG_THREADS + t] = o[i];
    }
    sm90::named_barrier_sync(1, 2 * WG_THREADS);
    if (wg == 1) return;
    float c0[2], c1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = merged[r * WG_THREADS + t];
      const float m_new = fmaxf(m[r], m1);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      c0[r] = ex2(m[r] - base);
      c1[r] = ex2(m1 - base);
      l[r] = l[r] * c0[r] + merged[(2 + r) * WG_THREADS + t] * c1[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i)
      o[i] = o[i] * c0[(i / 2) % 2] + merged[(4 + i) * WG_THREADS + t] * c1[(i / 2) % 2];
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row + 8 * r;
    if (qi >= Sq) continue;
    __nv_bfloat16* dst = out + ((size_t(b) * Sq + qi) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t(b) * Sq + qi) * H + h] = l[r] == 0.f ? NEG_INF : (m[r] + log2f(l[r])) * LN2;
  }
}

// ---- f32: register tiles on the CUDA cores --------------------------------

constexpr int F32_BM = F32_ROWS;  // query rows per CTA, 16 per warp
constexpr int F32_BN = F32_ROWS;  // keys per K/V tile

// Shared memory of the f32 kernel, in floats: Q, STAGES x (K, V), then each
// warp's 16 x 64 strip of P.  Rows of Q, K, V are padded by 4 floats, so
// the rows one 128-bit access reads (4 query rows, or 8 keys) start in
// distinct 16-byte bank groups at every D; P's 72-float rows put a warp's
// 4 rows of one access in 4 distinct groups and its 32 scalar writes in 32
// distinct banks.
template <int D>
struct F32Smem {
  static constexpr int PITCH = f32_pitch<D>();
  static constexpr int Q = F32_BM * PITCH;
  static constexpr int KV = F32_BN * PITCH;
  static constexpr int P = F32_BM * F32_PP;
  static constexpr size_t BYTES = size_t(Q + STAGES * 2 * KV + P) * sizeof(float);
};

// The launch bound names a minimum of one CTA per SM: without it ptxas
// held the kernel to 128 registers and spilled at D = 32; with it the
// kernel takes 130 (D = 32) to 242 (D = 128) registers and no spill, and
// shared memory still admits 2-3 CTAs per SM up to D = 64.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ out, float* __restrict__ lse, int H, int Sq, int Sk, float scale_log2,
                  int causal, int q_off, int k_off) {
  using L = F32Smem<D>;
  constexpr int PITCH = L::PITCH;
  constexpr int CW = D / 8;  // output columns per thread
  extern __shared__ float4 f32_smem[];
  float* q_tile = reinterpret_cast<float*>(f32_smem);
  float* ring = q_tile + L::Q;                             // STAGES x (K, V)
  float* p_strip = ring + STAGES * 2 * L::KV + (threadIdx.x / 32) * 16 * F32_PP;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, kg = lane % 8;  // rows rg + 4 i of the warp's 16; keys kg + 8 j of a tile
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * F32_BM;  // heaviest causal tiles first
  const int wq0 = q0 + warp * 16;

  const int last_row = min(q0 + F32_BM, Sq) - 1;
  int n_kt = (Sk + F32_BN - 1) / F32_BN;
  if (causal) {
    const int reach = q_off + last_row - k_off;
    n_kt = reach < 0 ? 0 : min(n_kt, reach / F32_BN + 1);
  }

  load_rows_f32<D>(q_tile, q, b, h, H, Sq, q0);
  if (n_kt > 0) {
    load_rows_f32<D>(ring, k, b, h, H, Sk, 0);
    load_rows_f32<D>(ring + L::KV, v, b, h, H, Sk, 0);
  }
  cp_async_commit();

  float o[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < CW; ++n) o[i][n] = 0.f;
  float m[4], l[4];  // running base-2 row max; this thread's share of the row sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const float* q_rows = q_tile + (warp * 16 + rg) * PITCH;  // row i at + 4 i * PITCH

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % STAGES;
    if (kt + 1 < n_kt) {
      // the other stage was released by the barrier that ended tile kt - 1
      float* next = ring + (1 - stage) * 2 * L::KV;
      load_rows_f32<D>(next, k, b, h, H, Sk, (kt + 1) * F32_BN);
      load_rows_f32<D>(next + L::KV, v, b, h, H, Sk, (kt + 1) * F32_BN);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but tile kt + 1 has landed
    __syncthreads();
    const int k0 = kt * F32_BN;
    // a tile wholly above the diagonal for this warp's rows adds nothing
    const bool hidden = causal && k_off + k0 > q_off + wq0 + 15;
    if (!hidden) {
      const float* k_tile = ring + stage * 2 * L::KV;
      const float* v_tile = k_tile + L::KV;
      // S: 4 rows x 8 keys a thread, 4 columns of d a step
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float4 qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(q_rows + 4 * i * PITCH + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(k_tile + (kg + 8 * j) * PITCH + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
          }
        }
      }

      // base-2 scaled scores (any sign of the scale); mask only a tile
      // that straddles the diagonal or the end of Sk
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] *= scale_log2;
      const bool full = k0 + F32_BN <= Sk && (!causal || k_off + k0 + F32_BN - 1 <= q_off + wq0);
      if (!full) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = k0 + kg + 8 * j;
            if (key >= Sk || (causal && k_off + key > q_off + wq0 + rg + 4 * i)) s[i][j] = -INFINITY;
          }
      }

      // the online softmax once a tile: a row's 64 scores lie in the 8
      // lanes of its group, so its max takes three shuffles
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = s[i][0];
#pragma unroll
        for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[i], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new;  // a row that sees nothing yet stays at zero weight
        const float corr = ex2(m[i] - base);
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int n = 0; n < CW; ++n) o[i][n] *= corr;
        float* p_row = p_strip + (rg + 4 * i) * F32_PP + kg;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = ex2(s[i][j] - base);
          l[i] += p;
          p_row[8 * j] = p;
        }
      }
      __syncwarp();  // the warp's P strip is whole

      // O += P V: each thread's 4 rows over all 64 keys, its D / 8 columns
      const float* p_rows = p_strip + rg * F32_PP;  // row i at + 4 i * F32_PP
#pragma unroll 2
      for (int kk = 0; kk < F32_BN; kk += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p_rows + 4 * i * F32_PP + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* v_row = v_tile + (kk + e) * PITCH;
          float vv[CW];
          if constexpr (CW >= 4) {
#pragma unroll
            for (int c = 0; c < CW / 4; ++c) {
              const float4 x = *reinterpret_cast<const float4*>(v_row + 32 * c + kg * 4);
              vv[4 * c] = x.x;
              vv[4 * c + 1] = x.y;
              vv[4 * c + 2] = x.z;
              vv[4 * c + 3] = x.w;
            }
          } else if constexpr (CW == 2) {
            const float2 x = *reinterpret_cast<const float2*>(v_row + kg * 2);
            vv[0] = x.x;
            vv[1] = x.y;
          } else {
            vv[0] = v_row[kg];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int n = 0; n < CW; ++n) o[i][n] = fmaf(p, vv[n], o[i][n]);
          }
        }
      }
      __syncwarp();  // P is read before the next tile writes it
    }
    __syncthreads();  // tile kt's stage is free for the load of tile kt + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
    const int qi = wq0 + rg + 4 * i;
    if (qi >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* dst = out + ((size_t(b) * Sq + qi) * H + h) * D;
    if constexpr (CW >= 4) {
#pragma unroll
      for (int c = 0; c < CW / 4; ++c)
        *reinterpret_cast<float4*>(dst + f32_col<D>(kg, 4 * c)) =
            make_float4(o[i][4 * c] * inv, o[i][4 * c + 1] * inv, o[i][4 * c + 2] * inv, o[i][4 * c + 3] * inv);
    } else {
#pragma unroll
      for (int n = 0; n < CW; ++n) dst[f32_col<D>(kg, n)] = o[i][n] * inv;
    }
    if (lse != nullptr && kg == 0)
      lse[(size_t(b) * Sq + qi) * H + h] = l[i] == 0.f ? NEG_INF : (m[i] + log2f(l[i])) * LN2;
  }
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
cudaError_t launch_bf16_narrow(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H,
                               int Sq, int Sk, float scale, int causal, int q_off, int k_off, int split,
                               cudaStream_t stream) {
  if (split != 1 && split != 2) return cudaErrorInvalidValue;
  CUtensorMap k_map, v_map;
  if (Sk > 0) {
    if (!sm90::encode_bshd_bf16(&k_map, k, B, Sk, H, D, NARROW_BN) ||
        !sm90::encode_bshd_bf16(&v_map, v, B, Sk, H, D, NARROW_BN))
      return cudaErrorInvalidValue;
  } else {
    memset(&k_map, 0, sizeof(k_map));  // no key tile is ever loaded
    v_map = k_map;
  }
  const dim3 grid(B * H, (Sq + NARROW_BM - 1) / NARROW_BM);
  flash_fwd_bf16_narrow<D><<<grid, split * WG_THREADS + 32, NarrowSmem<D>::ALLOC, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), lse, H, Sq, Sk,
      scale * 1.4426950408889634f, causal, q_off, k_off, split);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int H, int Sq,
                       int Sk, float scale, int causal, int q_off, int k_off, cudaStream_t stream) {
  using L = F32Smem<D>;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(L::BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + F32_BM - 1) / F32_BM);
  flash_fwd_f32<D><<<grid, F32_THREADS, L::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, H, Sq, Sk, scale * 1.4426950408889634f, causal, q_off, k_off);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (then scale > 0); q, k, v, out 16-byte
// aligned (TMA at bf16, cp.async at f32); D is 8, 16, 32, 64 or 128.
// `lse` may be null (no log-sum-exp output).  `split` (1 or 2): the
// consumer warpgroups of a bf16 CTA at D <= 32; ignored elsewhere.
// Returns the cudaError_t of the launch.
extern "C" int mmlspark_flash_forward(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                                      int H, int Sq, int Sk, int D, float scale, int causal, int q_off, int k_off,
                                      int dtype, int split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  if (dtype == 1) {
    if (!(scale > 0.f)) return cudaErrorInvalidValue;  // folded into the base-2 running max
    switch (D) {
      case 128: return launch_bf16<128>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
      case 64: return launch_bf16<64>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
      case 32: return launch_bf16_narrow<32>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, split, s);
      case 16: return launch_bf16_narrow<16>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, split, s);
      case 8: return launch_bf16_narrow<8>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, split, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 128: return launch_f32<128>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
      case 64: return launch_f32<64>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
      case 32: return launch_f32<32>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
      case 16: return launch_f32<16>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
      case 8: return launch_f32<8>(q, k, v, out, l, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
