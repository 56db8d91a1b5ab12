"""Draft bundles for speculative decoding (the port of
`mmlspark_tpu/zoo/speculative.py`; numpy on bundles, no device).

Any draft LM with the target's vocabulary gives the target's greedy
tokens; how well it predicts the target sets only the acceptance rate.
`truncated_draft_bundle` builds the draft that needs no training: the
target's first `n_layers` blocks with its embeddings, final norm and head
(a layer-truncated self-draft).  Its leaves ALIAS the target's arrays, so
the bundle adds no parameter memory on the host.

`soften_late_blocks` scales the residual-path output projections
(attention `proj`, MLP `mlp_down`) of the late blocks toward zero, making
a target its truncated draft agrees with on almost every greedy token: a
bench and test harness for stable acceptance rates, never a real
checkpoint's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mmlspark_tpu_torch.models.bundle import ModelBundle


def _lm_fields(bundle: ModelBundle) -> tuple[int, str]:
    cfg = bundle.config
    if "n_layers" not in cfg or "vocab_size" not in cfg:
        raise ValueError(
            f"architecture {bundle.architecture!r} is not a generatable "
            "LM bundle (no n_layers/vocab_size config)")
    return int(cfg["n_layers"]), str(cfg.get("mlp_impl", "dense"))


def truncated_draft_bundle(bundle: ModelBundle,
                           n_layers: int = 1) -> ModelBundle:
    """A draft LM that is the target's first `n_layers` blocks: the
    target's tok_embed / pos_embed / block{i}_w / final_norm_w / lm_head
    arrays, aliased; the config differs only in `n_layers`.  MoE targets
    are refused (per-step routing and the batched verify route different
    capacity groups)."""
    total, mlp_impl = _lm_fields(bundle)
    if mlp_impl == "moe":
        raise ValueError(
            "speculative decoding does not support MoE models: per-step "
            "routing and batched verify route different capacity groups")
    if not 1 <= n_layers <= total:
        raise ValueError(
            f"draft n_layers must be in [1, {total}], got {n_layers}")
    params = bundle.variables["params"]
    kept = {name: params[name] for name in
            ("tok_embed", "pos_embed", "final_norm_w", "lm_head")}
    for i in range(n_layers):
        kept[f"block{i}_w"] = params[f"block{i}_w"]
    variables = dict(bundle.variables)
    variables["params"] = kept
    config = dict(bundle.config)
    config["n_layers"] = n_layers
    metadata = {"speculative": {"draft_of": bundle.architecture,
                                "target_layers": total,
                                "draft_layers": n_layers}}
    return ModelBundle(bundle.architecture, config, variables, metadata)


def soften_late_blocks(bundle: ModelBundle, keep_layers: int,
                       factor: float = 0.05) -> ModelBundle:
    """A copy of `bundle` whose blocks `keep_layers..` have their
    residual-path output projections (proj, mlp_down: kernel and bias)
    scaled by `factor` (f32), so that `truncated_draft_bundle(result,
    keep_layers)` agrees with it on almost every greedy token; at 0.0 the
    softened model IS its truncation.  The input is untouched."""
    total, _ = _lm_fields(bundle)
    if not 1 <= keep_layers <= total:
        raise ValueError(
            f"keep_layers must be in [1, {total}], got {keep_layers}")
    params = dict(bundle.variables["params"])
    for i in range(keep_layers, total):
        block = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in params[f"block{i}_w"].items()}
        for name in ("proj", "mlp_down"):
            if name in block:
                block[name] = {k: np.asarray(v) * factor
                               for k, v in block[name].items()}
        params[f"block{i}_w"] = block
    variables = dict(bundle.variables)
    variables["params"] = params
    return dataclasses.replace(bundle, variables=variables,
                               metadata=dict(bundle.metadata or {}))
