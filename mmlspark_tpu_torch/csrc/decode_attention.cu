// Single-query decode attention over a KV-cache window for Hopper
// (sm_90a), loaded through a plain C interface
// (mmlspark_tpu_torch/ops/decode_attention.py).
//
// Replaces the Pallas kernel `_sqa_kernel` / `_fused_forward` of
// mmlspark_tpu/ops/decode_attention.py (the pallas_call at :245) in both
// its forms: the normalized output, and the raw online-softmax triple of
// `fused_single_query_attention_stats` (:326, `emit_stats`) that a
// seq-sharded cache read merges across shards.  Same function: q (B, H, D)
// in the model dtype against caches (B, L, H, D) in the model dtype or
// int8, under a per-row visibility mask (B, L); for int8, the per-(row,
// slot, head) f32 k_scale multiplies the score after QK^T and v_scale
// folds into the softmax weight before PV, so only int8 bytes stream.
// f32 statistics, (B, H, D) f32 out; a fully masked row gives zeros.  The
// stats form writes acc (B, H, D), m (B, H) and l (B, H) unnormalized, acc
// against the row's max m; a fully masked row gives the merge identity
// m = NEG_INF, l = 0, acc = 0.
//
// Bound: device-memory bytes.  One query per (row, head) does 2 FLOPs per
// cached byte (bf16) -- far below the card's ridge -- so the time is the
// K/V bytes of the visible slots (plus their scales and the mask) over the
// memory rate.  The design streams those bytes once with enough in flight
// and reads back nothing but the span partials, D + 2 floats a span.
//
// Design (flash-decoding in one launch; not the TPU's head-folded lane
// layout, whose 128-lane selector matmul and H <= 128 cap exist for the
// TPU's lanes):
//   * grid (H, spans, B), 8 warps per CTA, each CTA one `span`-slot range
//     of the window for one (row, head).  The wrapper sizes the span from
//     the window and the SM count (`_span_plan`): B*H*spans CTAs fill the
//     card about twice, each streaming several pipeline stages.
//   * A warp is cut into lane groups of D*itemsize/16 lanes; a group reads
//     one slot's K and V row with 16-byte loads (a contiguous row per
//     group), reduces q.k across its lanes, and folds the slot into its own
//     online-softmax state (m, l, acc).  Head dims 8, 16, 32, 64 and 128:
//     at 32 a group is 2 (int8), 4 (bf16) or 8 (f32) lanes, so a warp load
//     round covers 16, 8 or 4 slots; at 16 and 8 a group shrinks to one
//     lane where a 16-byte load holds the whole row, and an int8 row of
//     8 bytes (head dim 8) is one 8-byte load (the load is capped at the
//     row, never padded: padding would multiply a bandwidth-bound read).
//     The span merge's thread groups over spans are THREADS / D, at most
//     WARPS (8 at head dims 8-32; the rest of the threads idle in it).  A
//     stage is UNROLL such slot groups per warp.  The stream is a register double buffer: stage g + 1's K/V
//     loads (and stage g + 2's mask bytes, on which the K/V loads of the
//     stage after depend) are issued before stage g's math.  Masked slots
//     are never loaded.  Two slot groups a stage and two CTAs per SM were
//     the fastest on the H100 of the choices tried (three or four groups,
//     three CTAs).  int8 bytes become floats by a byte permute and an
//     exact subtraction, not the conversion instruction, which issues at
//     an eighth of the FMA rate.
//   * Lane groups, then warps, merge their states into the span's triple.
//     One head per CTA keeps that merge in the CTA and the span partials
//     small (D + 2 floats): a CTA over all heads of a row would read the
//     scales and mask bytes once, but its spans would be H times as many
//     floats for the last CTA to merge.  The int8 scales are 4-byte reads H
//     floats apart; the CTAs of a row's other heads read the same sectors,
//     so L2 serves them.
//   * The span merge is folded into the same launch: each CTA writes its
//     partial and counts itself in on a per-(row, head) arrival counter
//     with an acquire-release add; the CTA that arrives last merges all
//     spans in span order (the global max first, then the rescaled sums
//     with threads over D and thread groups over spans, summed in a fixed
//     order), writes the output or the stats triple, and zeroes the counter
//     for the next launch (or the next replay of a CUDA graph).  Which CTA merges never changes the
//     order of the sums, so two calls on the same inputs are bitwise equal.
//     A span with no visible slot carries m = NEG_INF, l = 0, acc = 0 and
//     weighs exactly 0 in the merge; with a single span the CTA writes the
//     result itself.

#include <type_traits>

#include "common.cuh"

using mmlspark::NEG_INF;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 2;      // slot groups per warp in one pipeline stage
constexpr int MAX_SPANS = 64;  // the wrapper's cap (ops/decode_attention.py)

// The first E elements of a lane's load as floats.
template <typename CT, int E>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  if constexpr (std::is_same<CT, int8_t>::value) {
    // int8 without the conversion instruction (an eighth of the FMA rate):
    // x + 128 is the low byte of the f32 2^23 + x + 128, whose high byte
    // is 0x4B; one byte permute and one exact subtraction per element.
    const uint32_t words[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                               raw.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = __uint_as_float(__byte_perm(words[i], 0x4B000000u, 0x7540 + j)) - 8388736.f;
    }
  } else {
    const CT* x = reinterpret_cast<const CT*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) out[i] = mmlspark::to_float(x[i]);
  }
}

// A lane's BYTES (16, or 8: an int8 row at head dim 8) of a cache row.
template <int BYTES>
__device__ __forceinline__ uint4 load_row(const void* p) {
  if constexpr (BYTES == 16) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    return make_uint4(r.x, r.y, 0u, 0u);
  }
}

struct SqaArgs {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const uint8_t* visible;
  const float* k_scale;
  const float* v_scale;
  float* partials;  // (B, H, spans, D + 2): acc[D], m, l; unused for one span
  int* counters;    // (B, H) arrival counts, zero between launches
  float* out;       // (B, H, D): acc / l, or acc for the stats form
  float* m_out;     // (B, H) for the stats form, else null
  float* l_out;     // (B, H) for the stats form, else null
  int B, L, H, span, n_spans;
  float scale;
  cudaStream_t stream;
};

// One pipeline stage of a lane group: the raw K/V rows (and int8 scales)
// of its UNROLL slots, and whether each slot is visible.
struct Stage {
  uint4 k[UNROLL], v[UNROLL];
  float ks[UNROLL], vs[UNROLL];
  bool live[UNROLL];
};

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

template <int D>
__device__ __forceinline__ void write_result(const SqaArgs& a, int bh, int t, float acc, float m,
                                             float l) {
  if (a.m_out == nullptr) {
    a.out[size_t(bh) * D + t] = acc / (l == 0.f ? 1.f : l);
    return;
  }
  a.out[size_t(bh) * D + t] = acc;
  if (t == 0) {
    a.m_out[bh] = m;
    a.l_out[bh] = l;
  }
}

template <typename QT, typename CT, int D, bool QUANT>
__global__ void __launch_bounds__(THREADS, 2) sqa_forward(const __grid_constant__ SqaArgs a) {
  constexpr int E = 16 / sizeof(CT) < D ? 16 / sizeof(CT) : D;  // cache elements per load (16 bytes, or a row)
  constexpr int LPK = D / E;           // lanes per slot
  constexpr int KPS = 32 / LPK;        // slots per warp load
  constexpr int ROUND = WARPS * KPS;   // slots per CTA load round
  constexpr int STAGE = ROUND * UNROLL;
  constexpr int G = THREADS / D < WARPS ? THREADS / D : WARPS;  // span groups of the merge
  static_assert(LPK <= 32 && 32 % LPK == 0, "head dim does not fit the lane groups");
  static_assert(G >= 1 && G * D <= THREADS, "head dim does not fit the merge");
  const int h = blockIdx.x, sp = blockIdx.y, b = blockIdx.z;
  const int L = a.L, H = a.H;
  const int bh = b * H + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / LPK, sub = lane % LPK;
  const int t = threadIdx.x;
  const size_t stride = size_t(H) * D;
  const float scale = a.scale;

  float qv[E];
  const QT* qp = static_cast<const QT*>(a.q) + size_t(bh) * D + sub * E;
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = mmlspark::to_float(qp[e]);
  const CT* kb = static_cast<const CT*>(a.k_cache) + size_t(b) * L * stride + size_t(h) * D + sub * E;
  const CT* vb = static_cast<const CT*>(a.v_cache) + size_t(b) * L * stride + size_t(h) * D + sub * E;
  const uint8_t* visb = a.visible + size_t(b) * L;
  const float* ksb = QUANT ? a.k_scale + size_t(b) * L * H + h : nullptr;
  const float* vsb = QUANT ? a.v_scale + size_t(b) * L * H + h : nullptr;
  const int s0 = sp * a.span, s1 = min(L, s0 + a.span);

  // `j0` is the lane group's slot in round 0 of a stage; slots past the
  // span or masked out are not loaded and score NEG_INF
  auto visible = [&](int j0, bool(&live)[UNROLL]) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u * ROUND;
      live[u] = j < s1 && visb[j] != 0;
    }
  };
  auto fetch = [&](int j0, const bool(&live)[UNROLL], Stage& st) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t j = size_t(j0 + u * ROUND);
      st.live[u] = live[u];
      st.k[u] = make_uint4(0, 0, 0, 0);
      st.v[u] = make_uint4(0, 0, 0, 0);
      st.ks[u] = 1.f;
      st.vs[u] = 1.f;
      if (live[u]) {
        st.k[u] = load_row<int(E * sizeof(CT))>(kb + j * stride);
        st.v[u] = load_row<int(E * sizeof(CT))>(vb + j * stride);
        if (QUANT) {
          st.ks[u] = ksb[j * H];
          st.vs[u] = vsb[j * H];
        }
      }
    }
  };

  float m = NEG_INF, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  auto fold = [&](const Stage& st) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float kf[E], vf[E];
      unpack<CT, E>(st.k[u], kf);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part += qv[e] * kf[e];
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      float s = part * scale;
      if (QUANT) s *= st.ks[u];
      if (!st.live[u]) s = NEG_INF;
      const float m_new = fmaxf(m, s);
      const float safe = mmlspark::safe_max(m_new);
      const float p = mmlspark::masked_exp(s, safe);
      const float corr = mmlspark::masked_exp(m, safe);
      l = l * corr + p;
      const float w = QUANT ? p * st.vs[u] : p;
      unpack<CT, E>(st.v[u], vf);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = acc[e] * corr + w * vf[e];
      m = m_new;
    }
  };

  // the stream: stage g + 1's K/V and stage g + 2's mask bytes are in
  // flight while stage g is folded.  The loop bounds depend on the warp
  // only, so every lane reaches every shuffle.
  {
    Stage cur, nxt;
    bool ahead[UNROLL], far[UNROLL];
    const int first = s0 + warp * KPS;
    visible(first + g, ahead);
    fetch(first + g, ahead, cur);
    visible(first + STAGE + g, ahead);
    for (int wb = first; wb < s1; wb += STAGE) {
      fetch(wb + STAGE + g, ahead, nxt);
      visible(wb + 2 * STAGE + g, far);
      fold(cur);
      cur = nxt;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) ahead[u] = far[u];
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

  // merge the warps into this span's triple
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
  float span_acc = 0.f, span_m = NEG_INF, span_l = 0.f;
  if (t < D) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) span_m = fmaxf(span_m, w_m[w]);
    const float safe = mmlspark::safe_max(span_m);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = mmlspark::masked_exp(w_m[w], safe);
      span_acc += w_acc[w][t] * c;
      span_l += w_l[w] * c;
    }
  }
  const int n = a.n_spans;
  if (n == 1) {
    if (t < D) write_result<D>(a, bh, t, span_acc, span_m, span_l);
    return;
  }

  // publish the partial, then count this span in; the last CTA merges
  float* parts = a.partials + size_t(bh) * n * (D + 2);
  if (t < D) {
    parts[size_t(sp) * (D + 2) + t] = span_acc;
    if (t == 0) {
      parts[size_t(sp) * (D + 2) + D] = span_m;
      parts[size_t(sp) * (D + 2) + D + 1] = span_l;
    }
  }
  // the partial's stores, the CTA barrier, then one acquire-release add
  // at device scope: it publishes this CTA's stores (release is
  // cumulative over the barrier) and, in the last CTA, acquires every
  // other CTA's before the barrier hands them to its threads
  __syncthreads();
  __shared__ int s_last;
  if (t == 0) {
    s_last = atomic_add_acq_rel(a.counters + bh, 1) == n - 1;
    if (s_last) atomicExch(a.counters + bh, 0);
  }
  __syncthreads();
  if (!s_last) return;

  // the merge, in span order: the global max, each span's weight, then
  // the weighted sums (partials read past L1: other CTAs wrote them)
  __shared__ float s_w[MAX_SPANS];
  float m_t = NEG_INF;
  if (t < n) {
    m_t = __ldcg(parts + size_t(t) * (D + 2) + D);
    s_w[t] = m_t;
  }
  __syncthreads();
  float M = NEG_INF;
  for (int s = 0; s < n; ++s) M = fmaxf(M, s_w[s]);
  __syncthreads();
  if (t < n) s_w[t] = mmlspark::masked_exp(m_t, mmlspark::safe_max(M));
  __syncthreads();
  const int col = t % D, grp = t / D;
  if (grp < G) {
    float sum_acc = 0.f, sum_l = 0.f;
#pragma unroll 4
    for (int s = grp; s < n; s += G) {
      const float c = s_w[s];
      const float* p = parts + size_t(s) * (D + 2);
      sum_acc += __ldcg(p + col) * c;
      if (col == 0) sum_l += __ldcg(p + D + 1) * c;
    }
    w_acc[grp][col] = sum_acc;
    if (col == 0) w_l[grp] = sum_l;
  }
  __syncthreads();
  if (t < D) {
    float A = 0.f, Ls = 0.f;
#pragma unroll
    for (int k = 0; k < G; ++k) {
      A += w_acc[k][t];
      Ls += w_l[k];
    }
    write_result<D>(a, bh, t, A, M, Ls);
  }
}

template <typename QT, typename CT, int D, bool QUANT>
cudaError_t launch(const SqaArgs& a) {
  dim3 grid(a.H, a.n_spans, a.B);
  sqa_forward<QT, CT, D, QUANT><<<grid, THREADS, 0, a.stream>>>(a);
  return cudaGetLastError();
}

template <typename QT, typename CT, bool QUANT>
cudaError_t by_dim(int D, const SqaArgs& a) {
  if (D == 128) return launch<QT, CT, 128, QUANT>(a);
  if (D == 64) return launch<QT, CT, 64, QUANT>(a);
  if (D == 32) return launch<QT, CT, 32, QUANT>(a);
  if (D == 16) return launch<QT, CT, 16, QUANT>(a);
  if (D == 8) return launch<QT, CT, 8, QUANT>(a);
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
// 1 = bfloat16, 2 = int8 (k_scale / v_scale then required).  The window
// is cut into ceil(L / span) spans, at most 64; with more than one,
// `partials` is scratch of B*H*spans*(D+2) floats and `counters` B*H
// int32 that are zero at the launch (the kernel leaves them zero).  With
// `m_out` and `l_out` null, `out` gets the normalized output; with both
// set (the stats form), `out` gets acc and they get m and l.  Returns the
// cudaError_t of the launch.
extern "C" int mmlspark_sqa_forward(const void* q, const void* k_cache, const void* v_cache,
                                    const void* visible, const void* k_scale, const void* v_scale,
                                    void* partials, void* counters, void* out, void* m_out, void* l_out,
                                    int B, int L, int H, int D, int span, float scale, int q_dtype,
                                    int cache_dtype, void* stream) {
  if (B == 0 || H == 0) return cudaSuccess;
  if (L < 1 || span < 1 || B > 65535 || (m_out == nullptr) != (l_out == nullptr))
    return cudaErrorInvalidValue;
  const int n_spans = (L + span - 1) / span;
  if (n_spans > MAX_SPANS || (n_spans > 1 && (partials == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  SqaArgs a{q,
            k_cache,
            v_cache,
            static_cast<const uint8_t*>(visible),
            static_cast<const float*>(k_scale),
            static_cast<const float*>(v_scale),
            static_cast<float*>(partials),
            static_cast<int*>(counters),
            static_cast<float*>(out),
            static_cast<float*>(m_out),
            static_cast<float*>(l_out),
            B,
            L,
            H,
            span,
            n_spans,
            scale,
            static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return by_cache<float>(cache_dtype, D, a);
  if (q_dtype == 1) return by_cache<__nv_bfloat16>(cache_dtype, D, a);
  return cudaErrorInvalidValue;
}
