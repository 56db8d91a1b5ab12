// Flash attention backward for Hopper (sm_90a), loaded through a plain C
// interface (mmlspark_tpu_torch/ops/flash_attention.py).
//
// Replaces the two Pallas kernels of `_flash_backward` in
// mmlspark_tpu/ops/flash_attention.py: `_dq_kernel` (the pallas_call at
// :318) and `_dkv_kernel` (:330), with `_bwd_p_block` (:174) inlined in
// both.  Same function: from q, k, v, dO (B, S, H, D) and the forward's
// saved statistics lse and delta = rowsum(dO * O) (f32, (B, Sq, H), read
// in place), each tile recomputes P = exp(S * scale - lse) (masked entries
// and rows whose lse is NEG_INF give exactly 0), dP = dO V^T,
// dS = P * (dP - delta), and
//   K2 `flash_bwd_dq`:  dQ = scale * dS K            (one CTA per query tile)
//   K3 `flash_bwd_dkv`: dV = P^T dO, dK = scale * dS^T Q  (one CTA per key tile)
// Each output has exactly one writer and nothing is accumulated with
// atomics, as in the JAX design, so a run gives the same gradients every
// time.  q_off/k_off place the tensors at global positions for the causal
// mask (query i at q_off + i, key j at k_off + j).  Any Sq and Sk.
//
// Bound: tensor-core operations at bf16 (f32: below).  At the training
// shape (8, 2048, 8, 128) causal, K2 does three (64 x 64 x D) products per
// live tile pair and K3 four, on O(S D) bytes: far above the card's ~295
// operations-per-byte ridge in bf16.  So the kernels are as fast as their
// products run, and as little as the elementwise step and the loads
// between them hold them up.
//
// Design, bf16 at head dim 64 or 128, on csrc/sm90.cuh as K1:
//   * One CTA of two consumer warpgroups (256 threads) owns 128 rows, 64
//     per warpgroup: query rows in K2 (heaviest causal tile first), key
//     rows in K3 (key tile 0, which sees the most queries, first).  Its
//     two owned tiles (Q, dO in K2; K, V in K3) are staged once by TMA;
//     the other side's tiles of 64 rows (K, V in K2; Q, dO in K3) stream
//     through a 2-stage ring on full/empty mbarriers, so tile t + 2 loads
//     while tile t + 1 is computed.  Tensor maps read the in-place
//     (B, S, H, D) layout, 128-byte swizzled, rows past S as zeros.
//   * The two score-shaped products are wgmma m64n64k16 with both operands
//     in shared memory, K-major: S = Q K^T and dP = dO V^T in K2; the
//     transposed S^T = K Q^T and dP^T = V dO^T in K3, so that there too
//     the accumulator's rows are the rows the CTA owns.
//   * The elementwise step stays in registers: P = exp2(S * scale * log2 e
//     - lse * log2 e), dS = P (dP - delta).  A row whose lse is NEG_INF, or
//     past Sq, gets the base +inf, so its P is exactly 0 with no branch.
//     K2 reads its two rows' statistics once; K3 reads the walked tile's 64
//     from its ring stage, where the producer warp put them (loaded from
//     global one tile ahead).  Only tiles on the causal diagonal (and K2's
//     ragged end of Sk) are masked, to exact zeros; a tile that a
//     warpgroup's rows cannot see is skipped, though the warpgroup still
//     releases the stage.
//   * The gradient products are wgmma RS: P and dS, rounded to bf16 in the
//     accumulator layout of the score product, are the register A operand
//     (no shared-memory round trip and no transpose), and the walked or
//     owned tile is the B operand read MN-major (transpose bit) from the
//     very tile the score product read K-major: dQ += dS K in K2,
//     dV += P^T dO and dK += dS^T Q in K3.  The gradient accumulators stay
//     in registers for the whole walk (K3 holds dK and dV: 128 registers
//     at D = 128).
//   * Epilogue: scale once, stage the bf16 rows in the warpgroup's own
//     (no longer read) rows of an owned tile, 16-byte stores of rows < S.
//
// Design, bf16 K2 and K3 at head dims 8, 16 and 32 (`flash_bwd_dq_narrow<D>`,
// `flash_bwd_dkv_narrow<D>`).  Each score element carries about 8
// instructions that do not depend on D (the FMA into base 2, ex2, the
// mask, dP - delta, the multiply, the packs), so the kernels are bound by
// instruction issue and the ex2 rate; the design puts every product on
// wgmma, one asynchronous instruction a 64 x N x 16 step, off the issue
// slots of that elementwise pass, and keeps enough warpgroups on an SM to
// overlap one's products with another's elementwise pass:
//   * a CTA of one or two warpgroups (K2: two) owns 64 rows each of one
//     (batch, head), read once from global memory into register A
//     fragments (the k 8-15 half zero at D = 8): queries with dO in K2
//     (heaviest causal tile first), keys with V in K3 (key tile 0 first);
//   * the walked 64-row tiles (K and V in K2, Q and dO in K3) stream by TMA
//     into a 4-stage ring on full/empty mbarriers, produced by a warp of
//     its own (K2 at D = 8, 16) or by warp 0 beside its products, which
//     refills the stage of the previous tile (a tile late, so that it
//     seldom waits on another warpgroup); K2 reads its two rows' exp2
//     bases and deltas once into registers, K3 has warp 0 store each
//     walked tile's 64 beside it from plain loads issued a tile ahead;
//   * a walked tile is taken 32 rows at a time (K2 at D = 32: all 64),
//     which holds the score registers to 32, so two or more CTAs share an
//     SM: S = Q K^T and dP = dO V^T in K2, S^T = K Q^T and dP^T = V dO^T
//     in K3, as wgmma m64n32k16 (m64n64k16) with the owned rows in
//     registers and the walked rows K-major in shared memory, so the
//     accumulator's rows are the rows the warpgroup owns; P and dS in
//     registers as in the wide kernels above, masked only where the
//     diagonal or the end of Sk crosses (TMA reads rows past S as zeros,
//     whose P is not 0), a tile the owned rows cannot see skipped (its
//     stage still released);
//   * the gradient products are wgmma m64nDk16 with P, dS (or their
//     transposes) as the register A operand as they lie, B read MN-major
//     from the very rows the score product read K-major: dQ += dS K in K2,
//     dV += P^T dO and dK += dS^T Q in K3; the accumulators stay in
//     registers;
//   * one writer per output row, no atomics; 4-byte stores after the scale.
//
// Design, f32 (`flash_bwd_dq_f32<D>`, `flash_bwd_dkv_f32<D>`, every head
// dim).  Full f32 on the CUDA cores, no TF32: the f32 path is the precise,
// reference-grade one (the f32 gradient checks hold the flash model to the
// dense one).  Bound: f32 operations (67 TFLOP/s), so the design keeps the
// FMA pipes fed from registers and shared memory, as the f32 K1 does
// (csrc/f32.cuh holds the pieces the three share):
//   * one CTA of four warps owns 64 rows of one (batch, head), 16 a warp,
//     staged once by cp.async with their partner: queries with dO in K2
//     (heaviest causal tile first), keys with V in K3 (key tile 0 first);
//   * the other side's 64-row tiles stream through a 2-stage cp.async
//     ring, each read by all 64 owned rows (every byte leaves device memory
//     once a CTA); the number of tiles follows the causal reach; K3's stage
//     also holds the tile's 64 exp2 bases and deltas, stored by threads
//     0-63 from registers loaded a tile earlier;
//   * a warp's lanes are 4 row groups x 8 column groups, so each thread
//     builds 4 x 8 register tiles of the two score products from 128-bit
//     shared loads: S = Q K^T and dP = dO V^T in K2, the transposed
//     S^T = K Q^T and dP^T = V dO^T in K3, whose rows are then the keys
//     the warp owns;
//   * P = exp2(S scale log2 e - lse log2 e) and dS = P (dP - delta) on those
//     registers; a row whose lse is NEG_INF (or past Sq) has the base +inf,
//     so its P is exactly 0; only tiles on the diagonal, and K2's ragged end
//     of Sk, are masked; a tile a warp's rows cannot see is skipped;
//   * P and dS reach the gradient products through the warp's own strip of
//     72-float rows (one __syncwarp): dQ += dS K in K2; dV += P^T dO, then
//     dK += dS^T Q in one strip in K3 (dS^T formed from this thread's own
//     P^T entries read back, so no score tile outlives its product); each
//     thread's 4 rows x D / 8 columns of every accumulator stay in
//     registers for the whole walk, scaled once and stored after it (K3
//     at D = 128 holds 128 of them, dK and dV: 255 registers, no spill,
//     under `__launch_bounds__(128, 1)`, which lets ptxas past 128);
//   * one writer per output, no atomics: two launches give the same bits.

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

using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // bf16: rows a CTA owns, 64 per warpgroup
constexpr int BN = 64;           // bf16: rows of a walked tile
constexpr int STAGES = 2;        // ring depth
constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int BF16_THREADS = 2 * WG_THREADS;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the bf16 kernels: the two owned tiles, then STAGES x
// the two walked tiles, each stored as D / 64 swizzled boxes of 64 columns
// (see sm90.cuh).
template <int D>
struct Smem {
  static constexpr uint32_t BOX_OWN = BM * 128;   // one 64-column box of an owned tile
  static constexpr uint32_t BOX_WALK = BN * 128;  // one 64-column box of a walked tile
  static constexpr uint32_t OWN = BM * D * 2;
  static constexpr uint32_t WALK = BN * D * 2;
  static constexpr uint32_t BYTES = 2 * OWN + STAGES * 2 * WALK;
  static constexpr size_t ALLOC = BYTES + 1024;  // room to align the base to the 1024-byte swizzle atom
};

// Load rows row0.. of head h, batch b of two tensors (`tile` bytes each,
// boxes `box` bytes apart) into dst and dst + tile; one arrival on `bar`
// that expects both tiles' bytes (one thread).
template <int D>
__device__ __forceinline__ void load_pair(unsigned char* dst, uint32_t tile, uint32_t box, uint64_t* bar,
                                          const CUtensorMap* a, const CUtensorMap* b_map, int h, int row0, int b) {
  sm90::mbar_arrive_expect_tx(bar, 2 * tile);
#pragma unroll
  for (int i = 0; i < D / 64; ++i) {
    sm90::tma_load_4d(dst + i * box, a, bar, i * 64, h, row0, b);
    sm90::tma_load_4d(dst + tile + i * box, b_map, bar, i * 64, h, row0, b);
  }
}

// lse and delta of query row qi (layout (B, Sq, H)); a row past Sq reads
// as one that saw no key.
__device__ __forceinline__ void fetch_stats(const float* lse, const float* delta, int b, int h, int H, int Sq,
                                            int qi, float& l, float& dl) {
  l = NEG_INF;
  dl = 0.f;
  if (qi < Sq) {
    const size_t at = (size_t(b) * Sq + qi) * H + h;
    l = lse[at];
    dl = delta[at];
  }
}

// The base-2 offset of a row's exp2: +inf for a row that saw no key, so
// that its P is exactly 0.
__device__ __forceinline__ float exp2_base(float l) { return l == NEG_INF ? INFINITY : l * LOG2E; }

// S (or S^T) = A B^T over D: A the warpgroup's 64 rows of an owned tile,
// B a walked tile of 64 rows, both K-major.
template <int D>
__device__ __forceinline__ void score_product(float (&s)[32], uint64_t a, uint64_t b) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = sm90::desc_advance(a, (kk / 4) * L::BOX_OWN + (kk % 4) * 32);
    const uint64_t db = sm90::desc_advance(b, (kk / 4) * L::BOX_WALK + (kk % 4) * 32);
    if (kk == 0)
      sm90::wgmma_m64n64k16_ss(s, da, db);
    else
      sm90::wgmma_m64n64k16_ss_acc(s, da, db);
  }
}

// acc (64 x D) += A B: A (64 x 64) bf16 pairs in registers, in the
// accumulator layout of a score product; B `rows` rows of a tile read
// MN-major from shared address `b_addr` (the next 64 columns one box of
// rows * 128 bytes further on).
template <int D>
__device__ __forceinline__ void grad_product(float (&acc)[D / 2], const uint32_t (&a)[16], uint32_t b_addr,
                                             uint32_t box) {
  const uint64_t b = sm90::desc_sw128(b_addr, box, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sm90::desc_advance(b, kk * 16 * 128);  // 16 rows down
    if constexpr (D == 128)
      sm90::wgmma_m64n128k16_rs_mn(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db);
    else
      sm90::wgmma_m64n64k16_rs_mn(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], db);
  }
}

// Stage `acc * mul` (this warpgroup's 64 x D rows) as bf16 in its own rows
// of the owned tile `tile`, in the tile's swizzle.
template <int D>
__device__ __forceinline__ void stage_rows(unsigned char* tile, const float (&acc)[D / 2], float mul, int wg,
                                           int row, int col) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = wg * 64 + row + 8 * r;  // row within the CTA's 128
      const uint32_t at = (j / 8) * Smem<D>::BOX_OWN + R * 128 + (((j % 8) ^ (R % 8)) * 16) + col * 2;
      *reinterpret_cast<uint32_t*>(tile + at) = sm90::pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// Write this warpgroup's staged rows of `tile` (global rows row0 + 64 wg
// ..) to a (B, S, H, D) bf16 tensor with 16-byte stores, rows < S only.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const unsigned char* tile, int wg, int row0, int S, int b,
                                           int h, int H) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x % WG_THREADS; i < 64 * CHUNKS; i += WG_THREADS) {
    const int R = wg * 64 + i / CHUNKS, j = i % CHUNKS;
    const int r = row0 + R;
    if (r < S) {
      const uint32_t at = (j / 8) * Smem<D>::BOX_OWN + R * 128 + (((j % 8) ^ (R % 8)) * 16);
      *reinterpret_cast<uint4*>(out + ((size_t(b) * S + r) * H + h) * D + j * 8) =
          *reinterpret_cast<const uint4*>(tile + at);
    }
  }
}

// The accumulator entry i of a thread lies at row + 8 * ((i / 2) % 2) and
// column col + 8 * (i / 4) + i % 2 of the 64 x 64 score tile (sm90.cuh).
__device__ __forceinline__ int entry_dr(int i) { return 8 * ((i / 2) % 2); }
__device__ __forceinline__ int entry_dc(int i) { return 8 * (i / 4) + i % 2; }

// K2: one CTA per 128 query rows of one (batch, head), walking key tiles.
template <int D>
__global__ void __launch_bounds__(BF16_THREADS, D == 64 ? 2 : 1)  // D = 64: 2 CTAs per SM
    flash_bwd_dq_bf16(__grid_constant__ const CUtensorMap q_map, __grid_constant__ const CUtensorMap do_map,
                      __grid_constant__ const CUtensorMap k_map, __grid_constant__ const CUtensorMap v_map,
                      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, int H,
                      int Sq, int Sk, float scale, int causal, int q_off, int k_off) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t own_full, full[STAGES], empty[STAGES];
  unsigned char* q_tile = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* do_tile = q_tile + L::OWN;
  unsigned char* ring = do_tile + L::OWN;

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, warp = (tid % WG_THREADS) / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * BM;  // heaviest causal tiles first
  const int wg_q0 = q0 + wg * 64;                                // this warpgroup's first row

  const int last_row = min(q0 + BM, Sq) - 1;
  int n_kt = (Sk + BN - 1) / BN;
  if (causal) {
    // key tile kt is live while k_off + kt*BN <= q_off + last_row
    const int reach = q_off + last_row - k_off;
    n_kt = reach < 0 ? 0 : min(n_kt, reach / BN + 1);
  }

  if (tid == 0) {
    sm90::mbar_init(&own_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], BF16_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0 && n_kt > 0) {
    load_pair<D>(q_tile, L::OWN, L::BOX_OWN, &own_full, &q_map, &do_map, h, q0, b);
    for (int kt = 0; kt < min(n_kt, STAGES); ++kt)
      load_pair<D>(ring + kt * 2 * L::WALK, L::WALK, L::BOX_WALK, &full[kt], &k_map, &v_map, h, kt * BN, b);
  }

  const int row = warp * 16 + lane / 4;  // rows row and row + 8 of the warpgroup's 64
  const int col = 2 * (lane % 4);        // + 8j (+1): columns within a tile
  float base[2], dl[2];                  // this thread's two rows' exp2 base and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    fetch_stats(lse, delta, b, h, H, Sq, wg_q0 + row + 8 * r, base[r], dl[r]);
    base[r] = exp2_base(base[r]);
  }
  const float scale_log2 = scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t ds[16];  // dS as bf16 pairs: the A operand of dS K
  const uint64_t dq_a = sm90::desc_sw128(sm90::smem_addr(q_tile) + wg * 64 * 128, 16, 1024);
  const uint64_t ddo_a = sm90::desc_sw128(sm90::smem_addr(do_tile) + wg * 64 * 128, 16, 1024);

  if (n_kt > 0) sm90::mbar_wait(&own_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % STAGES;
    const uint32_t phase = (kt / STAGES) & 1;
    const int k0 = kt * BN;
    sm90::mbar_wait(&full[stage], phase);
    // a tile wholly above the diagonal for this warpgroup's rows adds nothing
    const bool hidden = causal && k_off + k0 > q_off + wg_q0 + 63;
    if (!hidden) {
      const uint32_t k_addr = sm90::smem_addr(ring + stage * 2 * L::WALK);
      sm90::wgmma_fence();
      score_product<D>(s, dq_a, sm90::desc_sw128(k_addr, 16, 1024));  // S = Q K^T
      sm90::wgmma_commit();
      score_product<D>(dp, ddo_a, sm90::desc_sw128(k_addr + L::WALK, 16, 1024));  // dP = dO V^T
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = sm90::ex2(fmaf(s[i], scale_log2, -base[(i / 2) % 2]));
      // mask only a tile that straddles the diagonal or the end of Sk
      const bool whole = k0 + BN <= Sk && (!causal || k_off + k0 + BN - 1 <= q_off + wg_q0);
      if (!whole) {
        // entry i is key k0 + col + dc of query wg_q0 + row + dr: hidden
        // past Sk, or above the diagonal when causal
        const int key_end = Sk - k0 - col;
        const int diag = causal ? q_off + wg_q0 + row - k_off - k0 - col : BN;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int dc = entry_dc(i);
          if (dc >= key_end || dc > diag + entry_dr(i)) s[i] = 0.f;
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        ds[j] = sm90::pack_bf16(s[2 * j] * (dp[2 * j] - dl[j % 2]), s[2 * j + 1] * (dp[2 * j + 1] - dl[j % 2]));
      sm90::wgmma_fence();
      grad_product<D>(acc, ds, k_addr, L::BOX_WALK);  // dQ += dS K
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(&empty[stage]);
    if (tid == 0 && kt + STAGES < n_kt) {
      sm90::mbar_wait(&empty[stage], phase);  // both warpgroups are done with tile kt
      load_pair<D>(ring + stage * 2 * L::WALK, L::WALK, L::BOX_WALK, &full[stage], &k_map, &v_map, h,
                   (kt + STAGES) * BN, b);
    }
    __syncwarp();
  }

  // epilogue: scale * dQ as bf16 in this warpgroup's own Q rows, then rows < Sq
  stage_rows<D>(q_tile, acc, scale, wg, row, col);
  sm90::named_barrier_sync(1 + wg, WG_THREADS);
  store_rows<D>(dq, q_tile, wg, q0, Sq, b, h, H);
}

// K3: one CTA per 128 key rows of one (batch, head), walking query tiles.
// Warp 0 also produces the ring: Q and dO by TMA, and the tile's 64
// statistics, fetched from global one tile ahead, into the stage's slot.
template <int D>
__global__ void __launch_bounds__(BF16_THREADS, 1)
    flash_bwd_dkv_bf16(__grid_constant__ const CUtensorMap q_map, __grid_constant__ const CUtensorMap do_map,
                       __grid_constant__ const CUtensorMap k_map, __grid_constant__ const CUtensorMap v_map,
                       const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Sq, int Sk, float scale, int causal, int q_off,
                       int k_off) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t own_full, full[STAGES], empty[STAGES];
  __shared__ __align__(16) float st_base[STAGES][BN], st_delta[STAGES][BN];  // the walked tile's statistics
  unsigned char* k_tile = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* v_tile = k_tile + L::OWN;
  unsigned char* ring = v_tile + L::OWN;

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, warp = (tid % WG_THREADS) / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = int(blockIdx.y) * BM;  // key tile 0 walks the most query tiles under the causal mask
  const int wg_k0 = k0 + wg * 64;

  const int n_qt = (Sq + BN - 1) / BN;
  int qt0 = 0;
  if (causal) {
    // the first query tile holding a row at or past the CTA's first key
    const int reach = k_off + k0 - q_off;
    qt0 = reach <= 0 ? 0 : min(n_qt, reach / BN);
  }
  const int n_it = n_qt - qt0;

  if (tid == 0) {
    sm90::mbar_init(&own_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);  // warp 0's lanes, one of them with the TMA bytes
      sm90::mbar_init(&empty[s], BF16_THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // warp 0: stage query tile qt (its lse and delta from l, d) into `stage`
  auto produce = [&](int stage, int qt, const float (&l)[2], const float (&d)[2]) {
    reinterpret_cast<float2*>(st_base[stage])[lane] = make_float2(exp2_base(l[0]), exp2_base(l[1]));
    reinterpret_cast<float2*>(st_delta[stage])[lane] = make_float2(d[0], d[1]);
    if (lane == 0)
      load_pair<D>(ring + stage * 2 * L::WALK, L::WALK, L::BOX_WALK, &full[stage], &q_map, &do_map, h, qt * BN, b);
    else
      sm90::mbar_arrive(&full[stage]);
  };
  // lanes hold queries 2 lane and 2 lane + 1 of a tile
  auto fetch = [&](int qt, float (&l)[2], float (&d)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) fetch_stats(lse, delta, b, h, H, Sq, qt * BN + 2 * lane + e, l[e], d[e]);
  };
  if (tid < 32 && n_it > 0) {
    if (lane == 0) load_pair<D>(k_tile, L::OWN, L::BOX_OWN, &own_full, &k_map, &v_map, h, k0, b);
    for (int it = 0; it < min(n_it, STAGES); ++it) {
      float l[2], d[2];
      fetch(qt0 + it, l, d);
      produce(it, qt0 + it, l, d);
    }
  }

  const int row = warp * 16 + lane / 4;  // key rows row and row + 8 of the warpgroup's 64
  const int col = 2 * (lane % 4);        // + 8j (+1): query columns within a tile
  const float scale_log2 = scale * LOG2E;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[16], dsa[16];  // P^T and dS^T as bf16 pairs: the A operands
  const uint64_t dk_a = sm90::desc_sw128(sm90::smem_addr(k_tile) + wg * 64 * 128, 16, 1024);
  const uint64_t dv_a = sm90::desc_sw128(sm90::smem_addr(v_tile) + wg * 64 * 128, 16, 1024);

  if (n_it > 0) sm90::mbar_wait(&own_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int stage = it % STAGES;
    const uint32_t phase = (it / STAGES) & 1;
    const int q0 = (qt0 + it) * BN;
    const bool refill = tid < 32 && it + STAGES < n_it;
    float next_l[2], next_d[2];
    if (refill) fetch(qt0 + it + STAGES, next_l, next_d);  // in flight while this tile is computed
    sm90::mbar_wait(&full[stage], phase);
    // a tile whose every query precedes this warpgroup's keys adds nothing
    const bool hidden = causal && q_off + q0 + BN - 1 < k_off + wg_k0;
    if (!hidden) {
      const uint32_t q_addr = sm90::smem_addr(ring + stage * 2 * L::WALK);
      sm90::wgmma_fence();
      score_product<D>(s, dk_a, sm90::desc_sw128(q_addr, 16, 1024));  // S^T = K Q^T
      sm90::wgmma_commit();
      score_product<D>(dp, dv_a, sm90::desc_sw128(q_addr + L::WALK, 16, 1024));  // dP^T = V dO^T
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      const float2* sb = reinterpret_cast<const float2*>(st_base[stage]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = sb[4 * j + lane % 4];  // queries 8j + col, + 1
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * j + e] = sm90::ex2(fmaf(s[4 * j + e], scale_log2, e % 2 ? -bb.y : -bb.x));
      }
      // mask only a tile that straddles the diagonal: entry i is key
      // wg_k0 + row + dr against query q0 + col + dc
      const bool whole = !causal || q_off + q0 >= k_off + wg_k0 + 63;
      if (!whole) {
        const int lim = k_off + wg_k0 + row - q_off - q0 - col;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (entry_dc(i) < lim + entry_dr(i)) s[i] = 0.f;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      const float2* sd = reinterpret_cast<const float2*>(st_delta[stage]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dd = sd[4 * j + lane % 4];
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e % 2 ? dd.y : dd.x));
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        pa[j] = sm90::pack_bf16(s[2 * j], s[2 * j + 1]);
        dsa[j] = sm90::pack_bf16(dp[2 * j], dp[2 * j + 1]);
      }
      sm90::wgmma_fence();
      grad_product<D>(dva, pa, q_addr + L::WALK, L::BOX_WALK);  // dV += P^T dO
      grad_product<D>(dka, dsa, q_addr, L::BOX_WALK);           // dK += dS^T Q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dva);
      sm90::fence_regs(dka);
    }
    sm90::mbar_arrive(&empty[stage]);
    if (refill) {
      sm90::mbar_wait(&empty[stage], phase);  // both warpgroups are done with the stage
      produce(stage, qt0 + it + STAGES, next_l, next_d);
    }
    __syncwarp();
  }

  // epilogue: scale * dK and dV as bf16 in this warpgroup's own K and V
  // rows, then rows < Sk
  stage_rows<D>(k_tile, dka, scale, wg, row, col);
  stage_rows<D>(v_tile, dva, 1.f, wg, row, col);
  sm90::named_barrier_sync(1 + wg, WG_THREADS);
  store_rows<D>(dk, k_tile, wg, k0, Sk, b, h, H);
  store_rows<D>(dv, v_tile, wg, k0, Sk, b, h, H);
}

// ---- bf16 at head dims 8, 16 and 32: wgmma on a TMA ring ---------------------

constexpr int NARROW_STAGES = 4;  // ring depth

// K2 at D <= 32.  One CTA of OWN warpgroups owns 64 query rows each of
// one (batch, head), heaviest causal tiles first, their Q and dO rows held
// as register A fragments and their statistics in registers; the walked
// 64-key tiles of K and V stream through a ring of NARROW_STAGES stages by
// TMA, produced by a warp of its own (PRODUCER) or by warp 0 beside its
// products (as K3 below).  A tile's keys are taken HALF at a time.  The
// shape at each head dim was chosen on the H100 with `chip_smoke.py --ab
// TAG --bwd` (PERF.md §6): a producer warp won 6% at D = 16 and lost 24%
// at D = 32; whole 64-key tiles won 5% at D = 32 only.
template <int D>
struct NarrowDq {
  static constexpr int OWN = 2;
  static constexpr int HALF = D == 32 ? 64 : 32;
  static constexpr bool PRODUCER = D <= 16;
  static constexpr int THREADS = OWN * WG_THREADS + (PRODUCER ? 32 : 0);
};

template <int D>
__global__ void __launch_bounds__(NarrowDq<D>::THREADS)
    flash_bwd_dq_narrow(__grid_constant__ const CUtensorMap k_map, __grid_constant__ const CUtensorMap v_map,
                        const bf16* __restrict__ q, const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Sq, int Sk, float scale,
                        int causal, int q_off, int k_off) {
  constexpr uint32_t TILE = sm90::Narrow<D>::TILE;
  constexpr uint32_t ROW = sm90::Narrow<D>::ROW;
  constexpr int OWN = NarrowDq<D>::OWN, HALF = NarrowDq<D>::HALF;
  constexpr bool PRODUCER = NarrowDq<D>::PRODUCER;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NARROW_STAGES], empty[NARROW_STAGES];
  unsigned char* ring = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, warp = (tid % WG_THREADS) / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * OWN * 64;  // heaviest causal tiles first
  const int wg_q0 = q0 + wg * 64;                                      // this warpgroup's first row

  const int last_row = min(q0 + OWN * 64, Sq) - 1;
  int n_kt = (Sk + BN - 1) / BN;
  if (causal) {
    // key tile kt is live while k_off + kt*BN <= q_off + last_row
    const int reach = q_off + last_row - k_off;
    n_kt = reach < 0 ? 0 : min(n_kt, reach / BN + 1);
  }

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NARROW_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], OWN * WG_THREADS);  // the consumer warpgroups
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // one lane: key tile kt into `stage`
  auto produce = [&](int stage, int kt) {
    unsigned char* dst = ring + stage * 2 * TILE;
    sm90::mbar_arrive_expect_tx(&full[stage], 2 * TILE);
    sm90::tma_load_4d(dst, &k_map, &full[stage], 0, h, kt * BN, b);
    sm90::tma_load_4d(dst + TILE, &v_map, &full[stage], 0, h, kt * BN, b);
  };
  if constexpr (PRODUCER) {
    // the producer warp: tile kt into stage kt % STAGES once the stage's
    // previous tile is consumed
    if (wg == OWN) {
      if (lane == 0)
        for (int kt = 0; kt < n_kt; ++kt) {
          const int stage = kt % NARROW_STAGES;
          if (kt >= NARROW_STAGES) sm90::mbar_wait(&empty[stage], ((kt / NARROW_STAGES) - 1) & 1);
          produce(stage, kt);
        }
      return;
    }
  } else if (tid == 0) {
    for (int kt = 0; kt < min(n_kt, NARROW_STAGES); ++kt) produce(kt, kt);
  }

  const int row = warp * 16 + lane / 4;  // query rows row and row + 8 of the warpgroup's 64
  const int col = 2 * (lane % 4);        // + 8j (+1): key columns within a tile
  uint32_t qa[sm90::Narrow<D>::KS][4], da[sm90::Narrow<D>::KS][4];  // Q's and dO's A fragments
  sm90::load_frags<D>(qa, q, b, h, H, Sq, wg_q0 + row);
  sm90::load_frags<D>(da, dout, b, h, H, Sq, wg_q0 + row);
  float base[2], dl[2];  // this thread's two rows' exp2 base and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    fetch_stats(lse, delta, b, h, H, Sq, wg_q0 + row + 8 * r, base[r], dl[r]);
    base[r] = exp2_base(base[r]);
  }
  const float scale_log2 = scale * LOG2E;
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  float s[HALF / 2], dp[HALF / 2];
  uint32_t dsa[HALF / 4];  // dS as bf16 pairs: the A operand of dS K

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % NARROW_STAGES;
    const int k0 = kt * BN;
    // without a producer warp, warp 0 refills the stage of the previous
    // tile, one tile late, so that it seldom waits on the other warpgroup
    const int next = kt - 1 + NARROW_STAGES;
    const bool refill = !PRODUCER && tid < 32 && kt >= 1 && next < n_kt;
    sm90::mbar_wait(&full[stage], (kt / NARROW_STAGES) & 1);
    // a tile wholly above the diagonal for this warpgroup's rows, or rows
    // all past Sq, adds nothing
    const bool hidden = wg_q0 >= Sq || (causal && k_off + k0 > q_off + wg_q0 + 63);
    if (!hidden) {
      const uint32_t k_addr = sm90::smem_addr(ring + stage * 2 * TILE);
#pragma unroll
      for (int half = 0; half < BN / HALF; ++half) {
        const int hk0 = k0 + half * HALF;
        const uint32_t hk_addr = k_addr + half * HALF * ROW;
        sm90::wgmma_fence();
        sm90::score_rs<D, HALF>(s, qa, hk_addr);  // S = Q K^T
        sm90::wgmma_commit();
        sm90::score_rs<D, HALF>(dp, da, hk_addr + TILE);  // dP = dO V^T
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // S, and the previous half's gradient product
        sm90::fence_regs(s);
#pragma unroll
        for (int i = 0; i < HALF / 2; ++i) s[i] = sm90::ex2(fmaf(s[i], scale_log2, -base[(i / 2) % 2]));
        // mask only a half that straddles the diagonal or the end of Sk
        // (TMA reads keys past Sk as zeros, whose P is not 0)
        const bool whole = hk0 + HALF <= Sk && (!causal || k_off + hk0 + HALF - 1 <= q_off + wg_q0);
        if (!whole) {
          // entry i is key hk0 + col + dc of query wg_q0 + row + dr: hidden
          // past Sk, or above the diagonal when causal
          const int key_end = Sk - hk0 - col;
          const int diag = causal ? q_off + wg_q0 + row - k_off - hk0 - col : HALF;
#pragma unroll
          for (int i = 0; i < HALF / 2; ++i) {
            const int dc = entry_dc(i);
            if (dc >= key_end || dc > diag + entry_dr(i)) s[i] = 0.f;
          }
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < HALF / 4; ++j)
          dsa[j] = sm90::pack_bf16(s[2 * j] * (dp[2 * j] - dl[j % 2]), s[2 * j + 1] * (dp[2 * j + 1] - dl[j % 2]));
        sm90::wgmma_fence();
        sm90::accumulate_rs<D, HALF / 16>(dqa, dsa, hk_addr);  // dQ += dS K
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dqa);
    }
    sm90::mbar_arrive(&empty[stage]);
    if (refill) {
      const int prev = (kt - 1) % NARROW_STAGES;
      sm90::mbar_wait(&empty[prev], ((kt - 1) / NARROW_STAGES) & 1);  // every warpgroup is done with it
      if (lane == 0) produce(prev, next);
    }
    __syncwarp();
  }

  // epilogue: scale * dQ, rows < Sq, 4-byte stores of bf16 pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = wg_q0 + row + 8 * r;
    if (qi >= Sq) continue;
    const size_t at = ((size_t(b) * Sq + qi) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dq + at + 8 * j) =
          sm90::pack_bf16(dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
  }
}

// K3 at D <= 32: wgmma on a TMA ring.  One CTA of OWN warpgroups owns 64
// key rows each (their K and V rows held as register A fragments); the
// walked 64-query tiles of Q and dO stream through a ring of
// NARROW_STAGES stages by TMA.  Warp 0 also produces the ring, as in the
// wide kernel above (a TMA box over the (B, Sq, H) statistics needs H * 4
// bytes to be a multiple of 16, so they take plain loads).  No warp of its
// own for the producer keeps the registers of two or more CTAs within an
// SM.
//
// The shape at each narrow head dim, chosen on the H100 with
// `chip_smoke.py --ab TAG --bwd` (PERF.md §6): warpgroups a CTA, and the
// queries of a walked tile taken at a time.  One warpgroup a CTA at
// D = 8 puts five CTAs on an SM and never waits on another warpgroup;
// two at D = 16 and 32 halve the walked tiles a key needs.
template <int D>
struct NarrowDkv {
  static constexpr int OWN = D == 8 ? 1 : 2;
  static constexpr int HALF = 32;
  static constexpr int THREADS = OWN * WG_THREADS;
};

template <int D>
__global__ void __launch_bounds__(NarrowDkv<D>::THREADS)
    flash_bwd_dkv_narrow(__grid_constant__ const CUtensorMap q_map, __grid_constant__ const CUtensorMap do_map,
                         const bf16* __restrict__ k, const bf16* __restrict__ v, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int Sq, int Sk, float scale, int causal, int q_off, int k_off) {
  constexpr uint32_t TILE = sm90::Narrow<D>::TILE;
  constexpr int NO = D / 2;  // registers of each gradient accumulator
  constexpr int OWN = NarrowDkv<D>::OWN, THREADS = NarrowDkv<D>::THREADS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[NARROW_STAGES], empty[NARROW_STAGES];
  __shared__ __align__(16) float st_base[NARROW_STAGES][BN], st_delta[NARROW_STAGES][BN];
  unsigned char* ring = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);

  const int tid = threadIdx.x;
  const int wg = tid / WG_THREADS, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = int(blockIdx.y) * OWN * 64;  // key tile 0 walks the most query tiles under the causal mask

  const int n_qt = (Sq + BN - 1) / BN;
  int qt0 = 0;
  if (causal) {
    // the first query tile holding a row at or past the CTA's first key
    const int reach = k_off + k0 - q_off;
    qt0 = reach <= 0 ? 0 : min(n_qt, reach / BN);
  }
  const int n_it = n_qt - qt0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NARROW_STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);  // warp 0's lanes, lane 0 with the TMA bytes
      sm90::mbar_init(&empty[s], THREADS);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // warp 0: stage query tile qt (its lse and delta from l, d) into `stage`
  auto produce = [&](int stage, int qt, const float (&l)[2], const float (&d)[2]) {
    reinterpret_cast<float2*>(st_base[stage])[lane] = make_float2(exp2_base(l[0]), exp2_base(l[1]));
    reinterpret_cast<float2*>(st_delta[stage])[lane] = make_float2(d[0], d[1]);
    if (lane == 0) {
      unsigned char* dst = ring + stage * 2 * TILE;
      sm90::mbar_arrive_expect_tx(&full[stage], 2 * TILE);
      sm90::tma_load_4d(dst, &q_map, &full[stage], 0, h, qt * BN, b);
      sm90::tma_load_4d(dst + TILE, &do_map, &full[stage], 0, h, qt * BN, b);
    } else {
      sm90::mbar_arrive(&full[stage]);
    }
  };
  // lanes hold queries 2 lane and 2 lane + 1 of a tile
  auto fetch = [&](int qt, float (&l)[2], float (&d)[2]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) fetch_stats(lse, delta, b, h, H, Sq, qt * BN + 2 * lane + e, l[e], d[e]);
  };
  if (tid < 32) {
    for (int it = 0; it < min(n_it, NARROW_STAGES); ++it) {
      float l[2], d[2];
      fetch(qt0 + it, l, d);
      produce(it, qt0 + it, l, d);
    }
  }

  const int warp = (tid % WG_THREADS) / 32;
  const int row = warp * 16 + lane / 4;  // key rows row and row + 8 of the warpgroup's 64
  const int col = 2 * (lane % 4);        // + 8j (+1): query columns within a tile
  const int wg_k0 = k0 + wg * 64;
  uint32_t ka[sm90::Narrow<D>::KS][4], va[sm90::Narrow<D>::KS][4];  // K's and V's A fragments
  sm90::load_frags<D>(ka, k, b, h, H, Sk, wg_k0 + row);
  sm90::load_frags<D>(va, v, b, h, H, Sk, wg_k0 + row);
  const float scale_log2 = scale * LOG2E;
  float dka[NO], dva[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
  // A tile's 64 queries are taken HALF at a time: 32 halves the score
  // registers, so that two or more CTAs share an SM at every head dim.
  constexpr int HALF = NarrowDkv<D>::HALF;
  constexpr uint32_t ROW = sm90::Narrow<D>::ROW;
  float s[HALF / 2], dp[HALF / 2];
  uint32_t pa[HALF / 4], dsa[HALF / 4];  // P^T and dS^T as bf16 pairs: the A operands

  for (int it = 0; it < n_it; ++it) {
    const int stage = it % NARROW_STAGES;
    const int q0 = (qt0 + it) * BN;
    // warp 0 refills the stage of the previous tile, one tile late, so that
    // it seldom waits on the other warpgroup
    const int next = it - 1 + NARROW_STAGES;
    const bool refill = tid < 32 && it >= 1 && next < n_it;
    float next_l[2], next_d[2];
    if (refill) fetch(qt0 + next, next_l, next_d);  // in flight while this tile is computed
    sm90::mbar_wait(&full[stage], (it / NARROW_STAGES) & 1);
    // a tile whose every query precedes this warpgroup's keys adds nothing
    const bool hidden = causal && q_off + q0 + BN - 1 < k_off + wg_k0;
    if (!hidden) {
      const uint32_t q_addr = sm90::smem_addr(ring + stage * 2 * TILE);
#pragma unroll
      for (int half = 0; half < BN / HALF; ++half) {
        const int hq0 = q0 + half * HALF;
        const uint32_t hq_addr = q_addr + half * HALF * ROW;
        sm90::wgmma_fence();
        sm90::score_rs<D, HALF>(s, ka, hq_addr);  // S^T = K Q^T
        sm90::wgmma_commit();
        sm90::score_rs<D, HALF>(dp, va, hq_addr + TILE);  // dP^T = V dO^T
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // S^T, and the previous half's gradient products
        sm90::fence_regs(s);
        const float2* sb = reinterpret_cast<const float2*>(st_base[stage] + half * HALF);
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
          const float2 bb = sb[4 * j + lane % 4];  // queries 8j + col, + 1
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * j + e] = sm90::ex2(fmaf(s[4 * j + e], scale_log2, e % 2 ? -bb.y : -bb.x));
        }
        // mask only a half that straddles the diagonal: entry i is key
        // wg_k0 + row + dr against query hq0 + col + dc
        const bool whole = !causal || q_off + hq0 >= k_off + wg_k0 + 63;
        if (!whole) {
          const int lim = k_off + wg_k0 + row - q_off - hq0 - col;
#pragma unroll
          for (int i = 0; i < HALF / 2; ++i)
            if (entry_dc(i) < lim + entry_dr(i)) s[i] = 0.f;
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dp);
        const float2* sd = reinterpret_cast<const float2*>(st_delta[stage] + half * HALF);
#pragma unroll
        for (int j = 0; j < HALF / 8; ++j) {
          const float2 dd = sd[4 * j + lane % 4];
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e % 2 ? dd.y : dd.x));
        }
#pragma unroll
        for (int j = 0; j < HALF / 4; ++j) {
          pa[j] = sm90::pack_bf16(s[2 * j], s[2 * j + 1]);
          dsa[j] = sm90::pack_bf16(dp[2 * j], dp[2 * j + 1]);
        }
        sm90::wgmma_fence();
        sm90::accumulate_rs<D, HALF / 16>(dva, pa, hq_addr + TILE);  // dV += P^T dO
        sm90::accumulate_rs<D, HALF / 16>(dka, dsa, hq_addr);        // dK += dS^T Q
        sm90::wgmma_commit();
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dva);
      sm90::fence_regs(dka);
    }
    sm90::mbar_arrive(&empty[stage]);
    if (refill) {
      const int prev = (it - 1) % NARROW_STAGES;
      sm90::mbar_wait(&empty[prev], ((it - 1) / NARROW_STAGES) & 1);  // both warpgroups are done with it
      produce(prev, qt0 + next, next_l, next_d);
    }
    __syncwarp();
  }

  // epilogue: scale * dK and dV, rows < Sk, 4-byte stores of bf16 pairs
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = wg_k0 + row + 8 * r;
    if (kj >= Sk) continue;
    const size_t at = ((size_t(b) * Sk + kj) * H + h) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
          sm90::pack_bf16(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j) = sm90::pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

// ---- f32: register tiles on the CUDA cores ---------------------------------

// Shared memory of the f32 kernels, in floats: the two owned tiles (Q, dO
// in K2; K, V in K3), STAGES x the two walked tiles (K, V; Q, dO), in K3
// STAGES x the walked tile's 64 exp2 bases and 64 deltas, then each
// warp's 16 x 64 strip.  221184 bytes in K2 and 222208 in K3 at D = 128.
template <int D>
struct F32Smem {
  static constexpr int TILE = F32_ROWS * f32_pitch<D>();
  static constexpr int STATS = STAGES * 2 * F32_ROWS;
  static constexpr int STRIPS = F32_ROWS * F32_PP;
  static constexpr size_t DQ_BYTES = size_t(2 * TILE + STAGES * 2 * TILE + STRIPS) * sizeof(float);
  static constexpr size_t DKV_BYTES = size_t(2 * TILE + STAGES * 2 * TILE + STATS + STRIPS) * sizeof(float);
};

// s[i][j] = sum over d of a[rg + 4 i][d] t[kg + 8 j][d]: 4 rows of an
// owned tile (`a` at row rg, row i 4 i rows further) against the 64 rows of
// a walked tile (`t` at row kg), from 128-bit shared loads: 128 FMAs for
// every 12 loads.
template <int D>
__device__ __forceinline__ void f32_scores(float (&s)[4][8], const float* a, const float* t) {
  constexpr int P = f32_pitch<D>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + 4 * i * P + d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 tv = *reinterpret_cast<const float4*>(t + 8 * j * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = fmaf(av[i].x, tv.x, s[i][j]);
        s[i][j] = fmaf(av[i].y, tv.y, s[i][j]);
        s[i][j] = fmaf(av[i].z, tv.z, s[i][j]);
        s[i][j] = fmaf(av[i].w, tv.w, s[i][j]);
      }
    }
  }
}

// acc[i][n] += sum over k of w[rg + 4 i][k] t[k][f32_col(kg, n)]: 4 rows
// of a warp's strip (`w` at row rg) times a 64-row tile, each thread's D / 8
// columns (a warp's 8 column groups read 128 contiguous bytes of a row).
template <int D>
__device__ __forceinline__ void f32_accumulate(float (&acc)[4][D / 8], const float* w, const float* t, int kg) {
  constexpr int P = f32_pitch<D>();
  constexpr int CW = D / 8;
#pragma unroll 2
  for (int kk = 0; kk < F32_ROWS; kk += 4) {
    float4 wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = *reinterpret_cast<const float4*>(w + 4 * i * F32_PP + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* row = t + (kk + e) * P;
      float tv[CW];
      if constexpr (CW >= 4) {
#pragma unroll
        for (int c = 0; c < CW / 4; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(row + 32 * c + kg * 4);
          tv[4 * c] = x.x;
          tv[4 * c + 1] = x.y;
          tv[4 * c + 2] = x.z;
          tv[4 * c + 3] = x.w;
        }
      } else if constexpr (CW == 2) {
        const float2 x = *reinterpret_cast<const float2*>(row + kg * 2);
        tv[0] = x.x;
        tv[1] = x.y;
      } else {
        tv[0] = row[kg];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = e == 0 ? wv[i].x : e == 1 ? wv[i].y : e == 2 ? wv[i].z : wv[i].w;
#pragma unroll
        for (int n = 0; n < CW; ++n) acc[i][n] = fmaf(p, tv[n], acc[i][n]);
      }
    }
  }
}

// Store `acc * mul` (rows row0 + 4 i, each thread's D / 8 columns) into a
// (B, S, H, D) f32 tensor, rows < S only.
template <int D>
__device__ __forceinline__ void f32_store(float* out, const float (&acc)[4][D / 8], float mul, int row0, int S,
                                          int b, int h, int H, int kg) {
  constexpr int CW = D / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * i;
    if (r >= S) continue;
    float* dst = out + ((size_t(b) * S + r) * H + h) * D;
    if constexpr (CW >= 4) {
#pragma unroll
      for (int c = 0; c < CW / 4; ++c)
        *reinterpret_cast<float4*>(dst + f32_col<D>(kg, 4 * c)) =
            make_float4(acc[i][4 * c] * mul, acc[i][4 * c + 1] * mul, acc[i][4 * c + 2] * mul,
                        acc[i][4 * c + 3] * mul);
    } else {
#pragma unroll
      for (int n = 0; n < CW; ++n) dst[f32_col<D>(kg, n)] = acc[i][n] * mul;
    }
  }
}

// K2 at f32: one CTA of four warps per 64 query rows of one (batch, head),
// 16 a warp, walking 64-key tiles.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq, int H, int Sq, int Sk, float scale,
                     int causal, int q_off, int k_off) {
  using L = F32Smem<D>;
  constexpr int P = f32_pitch<D>();
  extern __shared__ float4 f32_smem[];
  float* q_tile = reinterpret_cast<float*>(f32_smem);
  float* do_tile = q_tile + L::TILE;
  float* ring = do_tile + L::TILE;  // STAGES x (K, V)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, kg = lane % 8;  // rows rg + 4 i of the warp's 16; keys kg + 8 j of a tile
  float* strip = ring + STAGES * 2 * L::TILE + warp * 16 * F32_PP;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (int(gridDim.y) - 1 - int(blockIdx.y)) * F32_ROWS;  // heaviest causal tiles first
  const int wq0 = q0 + warp * 16;

  const int last_row = min(q0 + F32_ROWS, Sq) - 1;
  int n_kt = (Sk + F32_ROWS - 1) / F32_ROWS;
  if (causal) {
    const int reach = q_off + last_row - k_off;
    n_kt = reach < 0 ? 0 : min(n_kt, reach / F32_ROWS + 1);
  }

  load_rows_f32<D>(q_tile, q, b, h, H, Sq, q0);
  load_rows_f32<D>(do_tile, dout, b, h, H, Sq, q0);
  if (n_kt > 0) {
    load_rows_f32<D>(ring, k, b, h, H, Sk, 0);
    load_rows_f32<D>(ring + L::TILE, v, b, h, H, Sk, 0);
  }
  cp_async_commit();

  float base[4], dl[4];  // this thread's rows' exp2 base and delta
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l;
    fetch_stats(lse, delta, b, h, H, Sq, wq0 + rg + 4 * i, l, dl[i]);
    base[i] = exp2_base(l);
  }
  const float scale_log2 = scale * LOG2E;
  float acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) acc[i][n] = 0.f;
  const float* q_rows = q_tile + (warp * 16 + rg) * P;
  const float* do_rows = do_tile + (warp * 16 + rg) * P;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % STAGES;
    if (kt + 1 < n_kt) {
      // the other stage was released by the barrier that ended tile kt - 1
      float* next = ring + (1 - stage) * 2 * L::TILE;
      load_rows_f32<D>(next, k, b, h, H, Sk, (kt + 1) * F32_ROWS);
      load_rows_f32<D>(next + L::TILE, v, b, h, H, Sk, (kt + 1) * F32_ROWS);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but tile kt + 1 has landed
    __syncthreads();
    const int k0 = kt * F32_ROWS;
    // a tile wholly above the diagonal for this warp's rows, or a warp
    // wholly past Sq, adds nothing
    const bool hidden = wq0 >= Sq || (causal && k_off + k0 > q_off + wq0 + 15);
    if (!hidden) {
      const float* k_tile = ring + stage * 2 * L::TILE;
      const float* v_tile = k_tile + L::TILE;
      float p[4][8], dp[4][8];
      f32_scores<D>(p, q_rows, k_tile + kg * P);  // S = Q K^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) p[i][j] = sm90::ex2(fmaf(p[i][j], scale_log2, -base[i]));
      // mask only a tile that straddles the diagonal or the end of Sk
      const bool whole = k0 + F32_ROWS <= Sk && (!causal || k_off + k0 + F32_ROWS - 1 <= q_off + wq0);
      if (!whole) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = k0 + kg + 8 * j;
            if (key >= Sk || (causal && k_off + key > q_off + wq0 + rg + 4 * i)) p[i][j] = 0.f;
          }
      }
      f32_scores<D>(dp, do_rows, v_tile + kg * P);  // dP = dO V^T
      // dS = P (dP - delta) through the warp's strip, then dQ += dS K
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) strip[(rg + 4 * i) * F32_PP + kg + 8 * j] = p[i][j] * (dp[i][j] - dl[i]);
      __syncwarp();
      f32_accumulate<D>(acc, strip + rg * F32_PP, k_tile, kg);
      __syncwarp();  // dS is read before the next tile writes it
    }
    __syncthreads();  // tile kt's stage is free for the load of tile kt + 2
  }
  cp_async_wait<0>();
  f32_store<D>(dq, acc, scale, wq0 + rg, Sq, b, h, H, kg);
}

// K3 at f32: one CTA of four warps per 64 key rows of one (batch, head), 16
// a warp, walking 64-query tiles; each ring stage also holds its tile's
// exp2 bases and deltas, stored by threads 0-63 from registers loaded a
// tile earlier.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int H,
                      int Sq, int Sk, float scale, int causal, int q_off, int k_off) {
  using L = F32Smem<D>;
  constexpr int P = f32_pitch<D>();
  extern __shared__ float4 f32_smem[];
  float* k_tile = reinterpret_cast<float*>(f32_smem);
  float* v_tile = k_tile + L::TILE;
  float* ring = v_tile + L::TILE;               // STAGES x (Q, dO)
  float* stats = ring + STAGES * 2 * L::TILE;  // STAGES x (64 bases, 64 deltas)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 8, kg = lane % 8;  // key rows rg + 4 i of the warp's 16; queries kg + 8 j of a tile
  float* strip = stats + L::STATS + warp * 16 * F32_PP;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = int(blockIdx.y) * F32_ROWS;  // key tile 0 walks the most query tiles under the causal mask
  const int wk0 = k0 + warp * 16;

  const int n_qt = (Sq + F32_ROWS - 1) / F32_ROWS;
  int qt0 = 0;
  if (causal) {
    // the first query tile holding a row at or past the CTA's first key
    const int reach = k_off + k0 - q_off;
    qt0 = reach <= 0 ? 0 : min(n_qt, reach / F32_ROWS);
  }
  const int n_it = n_qt - qt0;

  // threads 0-63: the exp2 base and delta of query tid of tile qt
  auto fetch = [&](int qt, float& bs, float& dd) {
    float l;
    fetch_stats(lse, delta, b, h, H, Sq, qt * F32_ROWS + tid, l, dd);
    bs = exp2_base(l);
  };
  load_rows_f32<D>(k_tile, k, b, h, H, Sk, k0);
  load_rows_f32<D>(v_tile, v, b, h, H, Sk, k0);
  float next_b = 0.f, next_d = 0.f;  // the statistics of tile it + 1 (threads 0-63)
  if (n_it > 0) {
    load_rows_f32<D>(ring, q, b, h, H, Sq, qt0 * F32_ROWS);
    load_rows_f32<D>(ring + L::TILE, dout, b, h, H, Sq, qt0 * F32_ROWS);
    if (tid < F32_ROWS) {
      fetch(qt0, stats[tid], stats[F32_ROWS + tid]);
      if (n_it > 1) fetch(qt0 + 1, next_b, next_d);
    }
  }
  cp_async_commit();

  const float scale_log2 = scale * LOG2E;
  float dka[4][D / 8], dva[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) dka[i][n] = dva[i][n] = 0.f;
  const float* k_rows = k_tile + (warp * 16 + rg) * P;
  const float* v_rows = v_tile + (warp * 16 + rg) * P;

  for (int it = 0; it < n_it; ++it) {
    const int stage = it % STAGES;
    if (it + 1 < n_it) {
      // the other stage was released by the barrier that ended tile it - 1
      const int qt = qt0 + it + 1;
      float* next = ring + (1 - stage) * 2 * L::TILE;
      load_rows_f32<D>(next, q, b, h, H, Sq, qt * F32_ROWS);
      load_rows_f32<D>(next + L::TILE, dout, b, h, H, Sq, qt * F32_ROWS);
      if (tid < F32_ROWS) {
        float* st = stats + (1 - stage) * 2 * F32_ROWS;
        st[tid] = next_b;
        st[F32_ROWS + tid] = next_d;
        if (it + 2 < n_it) fetch(qt + 1, next_b, next_d);  // in flight while this tile is computed
      }
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but tile it + 1 has landed
    __syncthreads();
    const int q0 = (qt0 + it) * F32_ROWS;
    // a tile whose every query precedes this warp's keys, or a warp wholly
    // past Sk, adds nothing
    const bool hidden = wk0 >= Sk || (causal && q_off + q0 + F32_ROWS - 1 < k_off + wk0);
    if (!hidden) {
      const float* q_t = ring + stage * 2 * L::TILE;
      const float* do_t = q_t + L::TILE;
      const float* st = stats + stage * 2 * F32_ROWS;
      float s[4][8];
      f32_scores<D>(s, k_rows, q_t + kg * P);  // S^T = K Q^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bq = st[kg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = sm90::ex2(fmaf(s[i][j], scale_log2, -bq));
      }
      // mask only a tile that straddles the diagonal: entry (i, j) is key
      // wk0 + rg + 4 i against query q0 + kg + 8 j
      const bool whole = !causal || q_off + q0 >= k_off + wk0 + 15;
      if (!whole) {
        const int lim = k_off + wk0 + rg - q_off - q0 - kg;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (lim + 4 * i > 8 * j) s[i][j] = 0.f;
      }
      // P^T through the warp's strip: dV += P^T dO
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) strip[(rg + 4 * i) * F32_PP + kg + 8 * j] = s[i][j];
      __syncwarp();
      f32_accumulate<D>(dva, strip + rg * F32_PP, do_t, kg);
      __syncwarp();  // P^T is read before dS^T overwrites it
      // dS^T = P^T (dP^T - delta), P^T read back from this thread's own
      // strip entries, then dK += dS^T Q
      f32_scores<D>(s, v_rows, do_t + kg * P);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float dd = st[F32_ROWS + kg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* e = strip + (rg + 4 * i) * F32_PP + kg + 8 * j;
          *e = *e * (s[i][j] - dd);
        }
      }
      __syncwarp();
      f32_accumulate<D>(dka, strip + rg * F32_PP, q_t, kg);
      __syncwarp();  // dS^T is read before the next tile writes the strip
    }
    __syncthreads();  // tile it's stage is free for the load of tile it + 2
  }
  cp_async_wait<0>();
  f32_store<D>(dk, dka, scale, wk0 + rg, Sk, b, h, H, kg);
  f32_store<D>(dv, dva, 1.f, wk0 + rg, Sk, b, h, H, kg);
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                          const float* delta, void* dq, int B, int H, int Sq, int Sk, float scale, int causal,
                          int q_off, int k_off, cudaStream_t stream) {
  constexpr size_t bytes = F32Smem<D>::DQ_BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + F32_ROWS - 1) / F32_ROWS);
  flash_bwd_dq_f32<D><<<grid, F32_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), H, Sq, Sk, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                           const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, float scale,
                           int causal, int q_off, int k_off, cudaStream_t stream) {
  constexpr size_t bytes = F32Smem<D>::DKV_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sk + F32_ROWS - 1) / F32_ROWS);
  flash_bwd_dkv_f32<D><<<grid, F32_THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk,
      scale, causal, q_off, k_off);
  return cudaGetLastError();
}

// Tensor maps of the four bf16 inputs: the owned pair in boxes of BM rows,
// the walked pair in boxes of BN.  A side of length 0 is never loaded and
// borrows the other side's maps.
template <int D>
cudaError_t bf16_maps(CUtensorMap (&own)[2], CUtensorMap (&walk)[2], const void* own_a, const void* own_b,
                      int S_own, const void* walk_a, const void* walk_b, int S_walk, int B, int H) {
  if (!sm90::encode_bshd_bf16(&own[0], own_a, B, S_own, H, D, BM) ||
      !sm90::encode_bshd_bf16(&own[1], own_b, B, S_own, H, D, BM))
    return cudaErrorInvalidValue;
  if (S_walk == 0) {
    walk[0] = own[0];
    walk[1] = own[1];
    return cudaSuccess;
  }
  if (!sm90::encode_bshd_bf16(&walk[0], walk_a, B, S_walk, H, D, BN) ||
      !sm90::encode_bshd_bf16(&walk[1], walk_b, B, S_walk, H, D, BN))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                           const float* delta, void* dq, int B, int H, int Sq, int Sk, float scale, int causal,
                           int q_off, int k_off, cudaStream_t stream) {
  CUtensorMap own[2], walk[2];  // (q, dO), (k, v)
  cudaError_t err = bf16_maps<D>(own, walk, q, dout, Sq, k, v, Sk, B, H);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(Smem<D>::ALLOC));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + BM - 1) / BM);
  flash_bwd_dq_bf16<D><<<grid, BF16_THREADS, Smem<D>::ALLOC, stream>>>(
      own[0], own[1], walk[0], walk[1], lse, delta, static_cast<bf16*>(dq), H, Sq, Sk, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                            const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, float scale,
                            int causal, int q_off, int k_off, cudaStream_t stream) {
  CUtensorMap own[2], walk[2];  // (k, v), (q, dO)
  cudaError_t err = bf16_maps<D>(own, walk, k, v, Sk, q, dout, Sq, B, H);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(Smem<D>::ALLOC));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sk + BM - 1) / BM);
  flash_bwd_dkv_bf16<D><<<grid, BF16_THREADS, Smem<D>::ALLOC, stream>>>(
      walk[0], walk[1], own[0], own[1], lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk,
      scale, causal, q_off, k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_narrow(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                             const float* delta, void* dq, int B, int H, int Sq, int Sk, float scale, int causal,
                             int q_off, int k_off, cudaStream_t stream) {
  CUtensorMap k_map, v_map;
  if (Sk > 0) {
    if (!sm90::encode_bshd_bf16(&k_map, k, B, Sk, H, D, BN) || !sm90::encode_bshd_bf16(&v_map, v, B, Sk, H, D, BN))
      return cudaErrorInvalidValue;
  } else {
    memset(&k_map, 0, sizeof(k_map));  // no key tile is ever loaded
    v_map = k_map;
  }
  constexpr int rows = NarrowDq<D>::OWN * 64;  // a CTA's owned queries
  const dim3 grid(B * H, (Sq + rows - 1) / rows);
  flash_bwd_dq_narrow<D><<<grid, NarrowDq<D>::THREADS, sm90::Narrow<D>::TILE * 2 * NARROW_STAGES + 1024, stream>>>(
      k_map, v_map, static_cast<const bf16*>(q), static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
      H, Sq, Sk, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_narrow(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, float scale,
                              int causal, int q_off, int k_off, cudaStream_t stream) {
  CUtensorMap q_map, do_map;
  if (Sq > 0) {
    if (!sm90::encode_bshd_bf16(&q_map, q, B, Sq, H, D, BN) || !sm90::encode_bshd_bf16(&do_map, dout, B, Sq, H, D, BN))
      return cudaErrorInvalidValue;
  } else {
    memset(&q_map, 0, sizeof(q_map));  // no query tile is ever loaded
    do_map = q_map;
  }
  constexpr int keys = NarrowDkv<D>::OWN * 64;  // a CTA's owned keys
  const dim3 grid(B * H, (Sk + keys - 1) / keys);
  flash_bwd_dkv_narrow<D><<<grid, NarrowDkv<D>::THREADS, sm90::Narrow<D>::TILE * 2 * NARROW_STAGES + 1024, stream>>>(
      q_map, do_map, static_cast<const bf16*>(k), static_cast<const bf16*>(v), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Sk, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int H, int Sq, int Sk, float scale, int causal,
                      int q_off, int k_off, cudaStream_t stream) {
  if (dtype == 1) {
    if constexpr (D >= 64) {
      return launch_dq_bf16<D>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, stream);
    } else {
      return launch_dq_narrow<D>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, stream);
    }
  }
  return launch_dq_f32<D>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, stream);
}

template <int D>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, float scale,
                       int causal, int q_off, int k_off, cudaStream_t stream) {
  if (dtype == 1) {
    if constexpr (D >= 64) {
      return launch_dkv_bf16<D>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off,
                                stream);
    } else {
      return launch_dkv_narrow<D>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off,
                                  stream);
    }
  }
  return launch_dkv_f32<D>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients; at
// bf16 q, k, v, dout 16-byte aligned for TMA);
// D is 8, 16, 32, 64 or 128; lse and delta are f32 (B, Sq, H).  Each
// returns the cudaError_t of its launch.
extern "C" int mmlspark_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, void* dq, int B, int H, int Sq, int Sk,
                                     int D, float scale, int causal, int q_off, int k_off, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (B == 0 || H == 0 || Sq == 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 128: return launch_dq<128>(dtype, q, k, v, dout, l, dl, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    case 64: return launch_dq<64>(dtype, q, k, v, dout, l, dl, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    case 32: return launch_dq<32>(dtype, q, k, v, dout, l, dl, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    case 16: return launch_dq<16>(dtype, q, k, v, dout, l, dl, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    case 8: return launch_dq<8>(dtype, q, k, v, dout, l, dl, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    default: return cudaErrorInvalidValue;
  }
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
  switch (D) {
    case 128: return launch_dkv<128>(dtype, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    case 64: return launch_dkv<64>(dtype, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    case 32: return launch_dkv<32>(dtype, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    case 16: return launch_dkv<16>(dtype, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    case 8: return launch_dkv<8>(dtype, q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off, s);
    default: return cudaErrorInvalidValue;
  }
}
