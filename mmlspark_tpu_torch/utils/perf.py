"""Analytic FLOP accounting (the port of `lm_train_flops`,
`mmlspark_tpu/utils/perf.py:99-133`)."""

from __future__ import annotations


def lm_train_flops(batch: int, seq: int, d_model: int, n_layers: int,
                   vocab_size: int, *, causal: bool = True,
                   attn_impl: str = "flash", mlp_ratio: int = 4) -> dict:
    """Analytic TransformerLM train-step FLOPs.

      * `dense` — 6 x tokens x N_linear (forward + 2x backward over the
        QKVO projections, the MLP pair and the vocabulary head);
      * `attn` — the attention products the math requires: 2 forward
        (QK^T, PV) + 4 backward (dV, dP, dQ, dK), each 2*B*S^2*d, halved
        under a causal mask.  Kernel-side recompute (the flash backward
        re-issuing S and dP) is not counted, so an MFU from `total` is
        conservative;
      * `total` = dense + attn;
      * `xla_visible` — the JAX package's cross-check field: the dense
        part alone for flash attention (its kernels are opaque to XLA),
        dense + the full S^2 products otherwise.
    """
    n_linear = (n_layers * (4 + 2 * mlp_ratio) * d_model * d_model
                + d_model * vocab_size)
    dense = 6 * batch * seq * n_linear
    attn_full = 6 * 2 * n_layers * batch * seq * seq * d_model
    attn = attn_full // 2 if causal else attn_full
    xla_visible = dense if attn_impl == "flash" else dense + attn_full
    return {"dense": dense, "attn": attn, "attn_full": attn_full,
            "total": dense + attn, "xla_visible": xla_visible}
