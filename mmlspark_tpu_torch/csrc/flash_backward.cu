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
// Bound: tensor-core operations.  At the training shape (8, 2048, 8, 128)
// causal, K2 does three (64 x 64 x D) products per live tile pair and K3
// four, on O(S D) bytes: far above the card's ~295 operations-per-byte
// ridge in bf16.  So the kernels are as fast as their products run, and as
// little as the elementwise step and the loads between them hold them up.
//
// Design, bf16 (head dim 64 or 128), on csrc/sm90.cuh as K1:
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
//   * f32: one warp per output row (a query row for K2, a key row for K3),
//     each lane holding D/32 elements, the other side folded one row at a
//     time in f32 FMA (no TF32: the f32 path is the precise reference-grade
//     one).

#include "common.cuh"
#include "sm90.cuh"

using mmlspark::NEG_INF;
namespace sm90 = mmlspark::sm90;

namespace {

constexpr int WARPS = 4;  // f32 kernels: one output row per warp
constexpr int THREADS = WARPS * 32;

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
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                      const float* delta, void* dq, int B, int H, int Sq, int Sk, float scale, int causal,
                      int q_off, int k_off, cudaStream_t stream) {
  if (dtype == 1) return launch_dq_bf16<D>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, scale, causal, q_off, k_off, stream);
  const unsigned blocks = unsigned(((long long)B * H * Sq + WARPS - 1) / WARPS);
  flash_bwd_dq_f32<D><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), B, H, Sq, Sk, scale, causal, q_off,
      k_off);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int B, int H, int Sq, int Sk, float scale,
                       int causal, int q_off, int k_off, cudaStream_t stream) {
  if (dtype == 1)
    return launch_dkv_bf16<D>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, scale, causal, q_off, k_off, stream);
  const unsigned blocks = unsigned(((long long)B * H * Sk + WARPS - 1) / WARPS);
  flash_bwd_dkv_f32<D><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), B, H, Sq,
      Sk, scale, causal, q_off, k_off);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients; at
// bf16 q, k, v, dout 16-byte aligned: TMA); lse and delta are f32
// (B, Sq, H).  Each returns the cudaError_t of its launch.
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
