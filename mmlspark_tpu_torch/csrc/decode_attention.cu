// Single-query decode attention over a KV-cache window for Hopper
// (sm_90a), loaded through a plain C interface
// (mmlspark_tpu_torch/ops/decode_attention.py).
//
// Replaces the Pallas kernel `_sqa_kernel` / `_fused_forward` of
// mmlspark_tpu/ops/decode_attention.py (the pallas_call at :245) in both
// its forms: the normalized output, and the raw online-softmax triple of
// `fused_single_query_attention_stats` (:326, `emit_stats`) that a
// seq-sharded cache read merges across shards.  Same function: q (B, H, D)
// in the model dtype against
// caches (B, L, H, D) in the model dtype or int8, under a per-row
// visibility mask (B, L); for int8, the per-(row, slot, head) f32 k_scale
// multiplies the score after QK^T and v_scale folds into the softmax
// weight before PV, so only int8 bytes stream.  f32 statistics, (B, H, D)
// f32 out; a fully masked row gives zeros.  The stats form writes acc
// (B, H, D), m (B, H) and l (B, H) unnormalized, acc against the row's max
// m; a fully masked row gives the merge identity m = NEG_INF, l = 0,
// acc = 0.
//
// Bound: device-memory bytes.  One query per (row, head) does 2 FLOPs per
// cached byte (bf16) -- far below the card's ridge -- so the time is the
// 2*B*L*H*D*itemsize cache bytes (plus the scales) over the memory rate.
//
// Design (flash-decoding, not the TPU's head-folded lane layout, whose
// 128-lane selector matmul and H <= 128 cap exist for the TPU's lanes):
//   * sqa_split: grid (splits, H, B), 4 warps per CTA, each CTA one
//     `split`-slot span of the window for one (row, head).  A warp is cut
//     into lane groups of D*itemsize/16 lanes; a group reads one slot's K
//     and V row with 16-byte loads (a contiguous row per group: coalesced),
//     reduces q.k across its lanes, and folds the slot into its own
//     online-softmax state (m, l, acc).  Loads for 4 slots are issued
//     before their math.  Groups, then warps, merge their states; the CTA
//     writes its (acc[D], m, l) triple.  A fully masked span writes the
//     merge identity m = NEG_INF, l = 0, acc = 0 (the JAX package's
//     merge_attention_stats contract), which is what a later stats-emitting
//     entry point returns as is.
//   * sqa_combine: one CTA per (row, head) merges the span triples against
//     their global max M and either normalizes (acc / l) or, for the stats
//     form, writes the merged triple (acc, M, l) as it is.

#include "common.cuh"

using mmlspark::NEG_INF;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;

template <typename CT>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const CT* x = reinterpret_cast<const CT*>(&raw);
#pragma unroll
  for (int i = 0; i < int(16 / sizeof(CT)); ++i) out[i] = mmlspark::to_float(x[i]);
}

struct SqaArgs {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const uint8_t* visible;
  const float* k_scale;
  const float* v_scale;
  float* partials;  // (B, H, splits, D + 2): acc[D], m, l
  float* out;       // (B, H, D): acc / l, or acc for the stats form
  float* m_out;     // (B, H) for the stats form, else null
  float* l_out;     // (B, H) for the stats form, else null
  int B, L, H, split;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename CT, int D, bool QUANT>
__global__ void __launch_bounds__(THREADS) sqa_split(SqaArgs a) {
  constexpr int E = 16 / sizeof(CT);  // cache elements per 16-byte load
  constexpr int LPK = D / E;          // lanes per slot
  constexpr int KPS = 32 / LPK;       // slots per warp step
  static_assert(LPK <= 32 && 32 % LPK == 0, "head dim does not fit the lane groups");
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int L = a.L, H = a.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / LPK, sub = lane % LPK;
  const size_t stride = size_t(H) * D;

  float qv[E];
  const QT* qp = static_cast<const QT*>(a.q) + (size_t(b) * H + h) * D + sub * E;
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = mmlspark::to_float(qp[e]);
  const CT* kb = static_cast<const CT*>(a.k_cache) + size_t(b) * L * stride + size_t(h) * D + sub * E;
  const CT* vb = static_cast<const CT*>(a.v_cache) + size_t(b) * L * stride + size_t(h) * D + sub * E;
  const uint8_t* visb = a.visible + size_t(b) * L;
  const float* ksb = QUANT ? a.k_scale + size_t(b) * L * H + h : nullptr;
  const float* vsb = QUANT ? a.v_scale + size_t(b) * L * H + h : nullptr;

  const int s0 = sp * a.split, s1 = min(L, s0 + a.split);
  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  // the loop bounds depend on the warp only, so every lane reaches every
  // shuffle; slots past the span or masked out carry NEG_INF
  for (int base = s0 + warp * KPS; base < s1; base += WARPS * KPS * UNROLL) {
    uint4 kraw[UNROLL], vraw[UNROLL];
    float ks[UNROLL], vs[UNROLL];
    bool live[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = base + u * WARPS * KPS + g;
      live[u] = j < s1 && visb[j] != 0;
      kraw[u] = make_uint4(0, 0, 0, 0);
      vraw[u] = make_uint4(0, 0, 0, 0);
      ks[u] = 1.f;
      vs[u] = 1.f;
      if (live[u]) {
        kraw[u] = *reinterpret_cast<const uint4*>(kb + size_t(j) * stride);
        vraw[u] = *reinterpret_cast<const uint4*>(vb + size_t(j) * stride);
        if (QUANT) {
          ks[u] = ksb[size_t(j) * H];
          vs[u] = vsb[size_t(j) * H];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[E], vf[E];
      unpack16<CT>(kraw[u], kf);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part += qv[e] * kf[e];
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      float s = part * a.scale;
      if (QUANT) s *= ks[u];
      if (!live[u]) s = NEG_INF;
      const float m_new = fmaxf(m, s);
      const float safe = mmlspark::safe_max(m_new);
      const float p = mmlspark::masked_exp(s, safe);
      const float corr = mmlspark::masked_exp(m, safe);
      l = l * corr + p;
      const float w = QUANT ? p * vs[u] : p;
      unpack16<CT>(vraw[u], vf);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = acc[e] * corr + w * vf[e];
      m = m_new;
    }
  }

  // merge the warp's lane groups (butterfly: every group ends with the sum)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float safe = mmlspark::safe_max(fmaxf(m, m_o));
    const float c_self = mmlspark::masked_exp(m, safe), c_o = mmlspark::masked_exp(m_o, safe);
    l = l * c_self + l_o * c_o;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * c_self + acc_o * c_o;
    }
    m = fmaxf(m, m_o);
  }

  // merge the warps and write this span's triple
  __shared__ float w_m[WARPS], w_l[WARPS], w_acc[WARPS][D];
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) w_acc[warp][sub * E + e] = acc[e];
    if (sub == 0) {
      w_m[warp] = m;
      w_l[warp] = l;
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < D) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, w_m[w]);
    const float safe = mmlspark::safe_max(M);
    float A = 0.f, Ls = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = mmlspark::masked_exp(w_m[w], safe);
      A += w_acc[w][t] * c;
      Ls += w_l[w] * c;
    }
    float* dst = a.partials + ((size_t(b) * H + h) * n_splits + sp) * (D + 2);
    dst[t] = A;
    if (t == 0) {
      dst[D] = M;
      dst[D + 1] = Ls;
    }
  }
}

// A span whose every slot is masked holds m = NEG_INF, so its weight c is
// exactly 0; when every span is masked M stays NEG_INF and A = Ls = 0.
template <int D>
__global__ void sqa_combine(const float* __restrict__ partials, float* __restrict__ out,
                            float* __restrict__ m_out, float* __restrict__ l_out, int n_splits) {
  const int bh = blockIdx.x, t = threadIdx.x;
  const float* p = partials + size_t(bh) * n_splits * (D + 2);
  float M = NEG_INF;
  for (int s = 0; s < n_splits; ++s) M = fmaxf(M, p[s * (D + 2) + D]);
  const float safe = mmlspark::safe_max(M);
  float A = 0.f, Ls = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float c = mmlspark::masked_exp(p[s * (D + 2) + D], safe);
    A += p[s * (D + 2) + t] * c;
    Ls += p[s * (D + 2) + D + 1] * c;
  }
  if (m_out == nullptr) {
    out[size_t(bh) * D + t] = A / (Ls == 0.f ? 1.f : Ls);
    return;
  }
  out[size_t(bh) * D + t] = A;
  if (t == 0) {
    m_out[bh] = M;
    l_out[bh] = Ls;
  }
}

template <typename QT, typename CT, int D, bool QUANT>
cudaError_t launch(const SqaArgs& a) {
  const int n_splits = (a.L + a.split - 1) / a.split;
  dim3 grid(n_splits, a.H, a.B);
  sqa_split<QT, CT, D, QUANT><<<grid, THREADS, 0, a.stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sqa_combine<D><<<a.B * a.H, D, 0, a.stream>>>(a.partials, a.out, a.m_out, a.l_out, n_splits);
  return cudaGetLastError();
}

template <typename QT, typename CT, bool QUANT>
cudaError_t by_dim(int D, const SqaArgs& a) {
  if (D == 128) return launch<QT, CT, 128, QUANT>(a);
  if (D == 64) return launch<QT, CT, 64, QUANT>(a);
  return cudaErrorInvalidValue;
}

template <typename QT>
cudaError_t by_cache(int cache_dtype, int D, const SqaArgs& a) {
  switch (cache_dtype) {
    case 0: return by_dim<QT, float, false>(D, a);
    case 1: return by_dim<QT, __nv_bfloat16, false>(D, a);
    case 2: return by_dim<QT, int8_t, true>(D, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16; cache_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k_scale / v_scale then required).  `partials`
// is scratch of B*H*ceil(L/split)*(D+2) floats.  With `m_out` and `l_out`
// null, `out` gets the normalized output; with both set (the stats form),
// `out` gets acc and they get m and l.  Returns the cudaError_t of the
// launches.
extern "C" int mmlspark_sqa_forward(const void* q, const void* k_cache, const void* v_cache,
                                    const void* visible, const void* k_scale, const void* v_scale,
                                    void* partials, void* out, void* m_out, void* l_out, int B, int L,
                                    int H, int D, int split, float scale, int q_dtype, int cache_dtype,
                                    void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (L < 1 || split < 1 || (m_out == nullptr) != (l_out == nullptr)) return cudaErrorInvalidValue;
  SqaArgs a{q,
            k_cache,
            v_cache,
            static_cast<const uint8_t*>(visible),
            static_cast<const float*>(k_scale),
            static_cast<const float*>(v_scale),
            static_cast<float*>(partials),
            static_cast<float*>(out),
            static_cast<float*>(m_out),
            static_cast<float*>(l_out),
            B,
            L,
            H,
            split,
            scale,
            static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return by_cache<float>(cache_dtype, D, a);
  if (q_dtype == 1) return by_cache<__nv_bfloat16>(cache_dtype, D, a);
  return cudaErrorInvalidValue;
}
