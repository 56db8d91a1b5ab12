"""Work of a decoder-only LM (frozen copy of the port's `lm_train_flops`,
`mmlspark_tpu_torch/utils/perf.py`, as it stood when the benchmark was
defined; the benchmark never reads the program's copy).

  * `dense`: 6 x tokens x the linear parameters (QKVO, the MLP pair, the
    vocabulary head): forward plus the two backward products;
  * `attn`: the attention products the math needs, 2 forward (QK^T, PV)
    and 4 backward (dV, dP, dQ, dK), each 2 * B * S^2 * d, halved under a
    causal mask.  A kernel's recomputation is not counted;
  * `total` = dense + attn.
"""

from __future__ import annotations


def lm_train_flops(batch: int, seq: int, d_model: int, n_layers: int,
                   vocab_size: int, *, causal: bool = True,
                   mlp_ratio: int = 4) -> dict:
    n_linear = (n_layers * (4 + 2 * mlp_ratio) * d_model * d_model
                + d_model * vocab_size)
    dense = 6 * batch * seq * n_linear
    attn_full = 6 * 2 * n_layers * batch * seq * seq * d_model
    attn = attn_full // 2 if causal else attn_full
    return {"dense": dense, "attn": attn, "total": dense + attn}


def train_step_flops(cfg: dict, mix: dict) -> float:
    """FLOPs of one training step of a GPT-2 configuration under a mix's
    batch and sequence length."""
    return float(lm_train_flops(mix["batch"], mix["seq"], cfg["n_embd"],
                                cfg["n_layer"], cfg["vocab_size"])["total"])
