"""The partition-rule data of `mmlspark_tpu/parallel/partition.py`: the
TransformerLM rule set and its JSON round trip (:63-68, :289-310).

A rule is (regex over the '/'-joined parameter path, spec), first match
wins; a spec is a sequence of mesh-axis entries (an axis name, None, or a
list of names).  The port does not shard yet, so it keeps the rules as
plain data: a trained bundle records them in `metadata["partition"]`
byte-identically to the JAX Trainer, and a config's `partition_rules`
round-trips through either package.  The seq-sharded cache layout is kept
the same way, as the axes each cache dimension splits over.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from mmlspark_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

# Sequence-sharded decode (models/generate.py, a mesh with seq > 1): the
# KV cache's rows split over 'data' and its window over 'seq', so each
# shard owns a contiguous slab of cache slots; heads stay whole (the seq
# path refuses model > 1).  The payload (B, W, H, D) and the int8 scales
# (B, W, H) follow the same layout.
SEQ_KV_CACHE_SPEC = (DATA_AXIS, SEQ_AXIS, None, None)
SEQ_KV_SCALE_SPEC = (DATA_AXIS, SEQ_AXIS, None)

# The Megatron split of the JAX package's DEFAULT_RULES: column-parallel
# qkv / mlp_up / lm_head, row-parallel proj / mlp_down, expert stacks over
# 'model', everything else replicated.
DEFAULT_RULES: tuple = (
    (r"(qkv|mlp_up|lm_head)/kernel$", (None, MODEL_AXIS)),
    (r"(proj|mlp_down)/kernel$", (MODEL_AXIS, None)),
    (r"moe/(w_in|w_out)$", (MODEL_AXIS, None, None)),
    (r".*", ()),
)


def rules_to_json(rules: Sequence) -> list:
    """JSON-able form: [[pattern, [axis|null|[axis,...], ...]], ...]."""
    return [[pattern, [list(e) if isinstance(e, (tuple, list)) else e
                       for e in spec]] for pattern, spec in rules]


def rules_from_json(data: Iterable) -> tuple:
    """Inverse of rules_to_json: ((pattern, (entry, ...)), ...), with a
    multi-axis entry as a tuple of names."""
    return tuple((str(pattern), tuple(tuple(e) if isinstance(e, list) else e
                                      for e in entries))
                 for pattern, entries in data)
