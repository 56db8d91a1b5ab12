"""The least time causal attention's kernels can take on a card: the work
the math needs, not what a kernel does.

  * products over the visible (query, key) pairs, S (S + 1) / 2 a head
    under a causal mask: 2 forward (QK^T, PV) and 4 backward (dV, dP,
    dQ, dK), each 2 * head_dim FLOPs a pair.  A kernel's recomputation
    of S or dP is not counted;
  * each input and output byte once: forward q, k, v in and the output
    and its row log-sum-exp (f32) out; backward q, k, v, the output, its
    gradient and the log-sum-exp in, dq, dk, dv out;
  * one exponential a visible pair, in the forward (the softmax);
  * the bound is the largest of FLOPs over the peak FLOP/s, bytes over
    the peak bytes/s and exponentials over the card's ex2 rate (as the
    port's `chip_smoke.py` bounds its kernels).
"""

from __future__ import annotations


def visible_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def causal_bounds(batch: int, heads: int, seq: int, head_dim: int,
                  elem_bytes: int, peak_flops: float, peak_bw: float,
                  ex2_per_s: float = float("inf")) -> dict:
    """Seconds a layer's forward and backward attention need at least."""
    pairs = batch * heads * visible_pairs(seq)
    tensor = batch * seq * heads * head_dim * elem_bytes
    lse = batch * heads * seq * 4
    fwd_flops, bwd_flops = 2 * 2 * head_dim * pairs, 4 * 2 * head_dim * pairs
    fwd_bytes, bwd_bytes = 4 * tensor + lse, 8 * tensor + lse
    return {"forward": max(fwd_flops / peak_flops, fwd_bytes / peak_bw,
                           pairs / ex2_per_s),
            "backward": max(bwd_flops / peak_flops, bwd_bytes / peak_bw),
            "forward_flops": fwd_flops, "backward_flops": bwd_flops,
            "forward_bytes": fwd_bytes, "backward_bytes": bwd_bytes}
