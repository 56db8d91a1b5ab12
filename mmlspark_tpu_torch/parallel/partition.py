"""Partition rules and placements over a mesh's model axis: the port of
`mmlspark_tpu/parallel/partition.py` for the single controller.

A rule is (regex over the '/'-joined parameter path, spec), first match
wins; a spec is a tuple of mesh-axis entries (an axis name, None, or a
tuple of names), `()` meaning replicated (JAX's `P()`).  The rule data
(`DEFAULT_RULES`, the JSON round trip) is byte-identical to the JAX
package's, so a bundle records the same `metadata["partition"]`.

`leaf_spec` / `match_partition_rules` keep the JAX invariants: scalar and
size-1 leaves, and rank-1 `bias` leaves, are never sharded; an int8
`*_scale` leaf follows its kernel's output axis; an unmatched leaf raises
or replicates (`on_unmatched`).  `compatible_spec` demotes a spec that a
shape cannot tile to `()`, as the JAX function does.

Placement.  A placed leaf is a `ModelShards`: a list with one tensor per
model index of a data row's model group (`parallel/mesh.py`
`model_group`), entry m on that index's device.  A sharded leaf's entry m
is the slice the JAX spec gives model index m; a replicated leaf's entries
are the whole tensor (one object per distinct device).  `shard_tree` /
`gather_tree` place a flax-layout tree and bring it back, full leaves in
the reference's layout byte for byte.

One placement differs from GSPMD's: `qkv` is [q | k | v] along its
output columns, and the JAX spec `(None, "model")` gives model index 0 all
of q and half of k, which GSPMD then reshards to heads.  The port cannot
reshard inside a kernel call, so its `qkv` placement is head-aligned:
model index m holds columns [m D/mp, (m+1) D/mp) of EACH third (its H/mp
heads of q, k and v; `groups=3`), and so does a `qkv/kernel_scale`.  The
shard shapes equal JAX's; the contents are a permutation of its columns,
which `gather_tree` undoes.  Where mp does not divide the head count (or
D), the port replicates `qkv` where JAX would shard it.

`shard_constraint` / `use_mesh` (activation hints for GSPMD) have no
counterpart: the port's model code places activations explicitly
(`models/definitions.py`, `models/generate.py`).
"""

from __future__ import annotations

import re
from typing import Any, Iterable, Optional, Sequence

import numpy as np
import torch

from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                              model_group)

UNMATCHED_RAISE = "raise"
UNMATCHED_REPLICATE = "replicate"

# The Megatron split of the JAX package's DEFAULT_RULES: column-parallel
# qkv / mlp_up / lm_head, row-parallel proj / mlp_down, expert stacks over
# 'model', everything else replicated.
DEFAULT_RULES: tuple = (
    (r"(qkv|mlp_up|lm_head)/kernel$", (None, MODEL_AXIS)),
    (r"(proj|mlp_down)/kernel$", (MODEL_AXIS, None)),
    (r"moe/(w_in|w_out)$", (MODEL_AXIS, None, None)),
    (r".*", ()),
)

# Activation and cache layouts of the transformer forward and decode
# (the JAX specs): attention tensors (B, S, H, D) carry heads on 'model';
# the MLP hidden its channel slice; the decode KV cache (B, W, H, D) rows
# on 'data' and heads on 'model'.
HEADS_SPEC = (DATA_AXIS, None, MODEL_AXIS, None)
HIDDEN_SPEC = (DATA_AXIS, None, MODEL_AXIS)
KV_CACHE_SPEC = (DATA_AXIS, None, MODEL_AXIS, None)
KV_SCALE_SPEC = (DATA_AXIS, None, MODEL_AXIS)

# Speculative decoding: the draft's cache rides the data axis only (its
# weights replicate).
DRAFT_KV_CACHE_SPEC = (DATA_AXIS, None, None, None)
DRAFT_KV_SCALE_SPEC = (DATA_AXIS, None, None)

# Sequence-sharded decode (models/generate.py, a mesh with seq > 1): the
# KV cache's rows split over 'data' and its window over 'seq', so each
# shard owns a contiguous slab of cache slots; heads stay whole (the seq
# path refuses model > 1).  The payload (B, W, H, D) and the int8 scales
# (B, W, H) follow the same layout.
SEQ_KV_CACHE_SPEC = (DATA_AXIS, SEQ_AXIS, None, None)
SEQ_KV_SCALE_SPEC = (DATA_AXIS, SEQ_AXIS, None)

# the head-aligned leaves: [q | k | v] along the output axis
_QKV = re.compile(r"(^|/)qkv/kernel(_scale)?$")


def path_str(path: Sequence) -> str:
    """The '/'-joined form of a tree path (keys, or objects with a `key`
    or `idx`): the string the rule regexes are matched against."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _match(path: str, rules: Sequence, on_unmatched: str) -> tuple:
    for pattern, spec in rules:
        if re.search(pattern, path):
            return tuple(spec)
    if on_unmatched == UNMATCHED_REPLICATE:
        return ()
    raise ValueError(
        f"no partition rule matched param path {path!r} "
        f"(on_unmatched='raise'; add a rule or a catch-all ('.*', ()))")


def leaf_spec(path: str, shape: Sequence[int], rules: Sequence,
              on_unmatched: str = UNMATCHED_RAISE) -> tuple:
    """The spec of ONE leaf: the scalar / bias / scale invariants first,
    then the rules."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0 or int(np.prod(shape)) == 1:
        return ()
    name = path.rsplit("/", 1)[-1]
    if name == "bias" and len(shape) == 1:
        return ()
    if name.endswith("_scale"):
        kernel_spec = _match(path[:-len("_scale")], rules, on_unmatched)
        last = kernel_spec[-1] if len(kernel_spec) else None
        return (last,) if last is not None else ()
    return _match(path, rules, on_unmatched)


def _check_rules(rules: Optional[Sequence]) -> tuple:
    rule_list = tuple(DEFAULT_RULES if rules is None else rules)
    for pattern, spec in rule_list:
        re.compile(pattern)   # a bad regex surfaces at the call site
        if not isinstance(spec, (tuple, list)):
            raise TypeError(f"rule for {pattern!r} must map to a spec "
                            f"tuple, got {type(spec).__name__}")
    return rule_list


def _map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path_str(path), tree)


def match_partition_rules(tree: Any, rules: Optional[Sequence] = None, *,
                          on_unmatched: str = UNMATCHED_RAISE) -> Any:
    """A spec tree of `tree`'s structure (nested dicts; leaves anything
    with a `.shape`), first matching rule wins."""
    if on_unmatched not in (UNMATCHED_RAISE, UNMATCHED_REPLICATE):
        raise ValueError(f"on_unmatched must be 'raise' or 'replicate', "
                         f"got {on_unmatched!r}")
    rule_list = _check_rules(rules)
    return _map_with_path(
        lambda p, leaf: leaf_spec(p, np.shape(leaf) if not hasattr(
            leaf, "shape") else tuple(leaf.shape), rule_list, on_unmatched),
        tree)


def compatible_spec(spec: Sequence, shape: Sequence[int], mesh) -> tuple:
    """`spec`, or `()` where `shape` cannot be tiled by it: a spec longer
    than the rank, an axis the mesh lacks, or a dim the axis size does not
    divide (demotion to replicated is always correct, merely less
    parallel)."""
    spec, shape = tuple(spec), tuple(shape)
    if len(spec) == 0:
        return spec
    if mesh is None or len(spec) > len(shape):
        return ()
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        size = 1
        for a in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if a not in mesh.shape:
                return ()
            size *= mesh.shape[a]
        if size and dim % size:
            return ()
    return spec


def model_dim(spec: Sequence) -> Optional[int]:
    """The dim a spec splits over 'model' (alone), or None.  A spec that
    names another axis for a weight raises: the port places weights over
    'model' only."""
    found = None
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        if tuple(axes) != (MODEL_AXIS,):
            raise ValueError(f"spec {tuple(spec)}: the port places weights "
                             f"over '{MODEL_AXIS}' alone")
        found = i
    return found


# -- per-shard slices --------------------------------------------------------

def take_slice(x, dim: Optional[int], index: int, count: int,
               groups: int = 1):
    """Model index `index`'s slice of `x` (tensor or numpy) along `dim`
    (None: the whole of it).  `groups` > 1 views the dim as `groups`
    equal runs and takes the index's slice of each (the head-aligned
    qkv), joined in group order."""
    if dim is None:
        return x
    n = x.shape[dim]
    run = n // groups
    width = run // count
    pieces = [_narrow(x, dim, g * run + index * width, width)
              for g in range(groups)]
    if len(pieces) == 1:
        return pieces[0]
    return (torch.cat(pieces, dim) if isinstance(x, torch.Tensor)
            else np.concatenate(pieces, dim))


def _narrow(x, dim: int, start: int, length: int):
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, start, length)
    index = [slice(None)] * x.ndim
    index[dim] = slice(start, start + length)
    return x[tuple(index)]


def join_slices(parts: Sequence, dim: Optional[int], groups: int = 1):
    """The inverse of `take_slice` over every index: the parts (on one
    device) joined into the full leaf."""
    if dim is None:
        return parts[0]
    cat = torch.cat if isinstance(parts[0], torch.Tensor) else \
        np.concatenate
    if groups == 1:
        return cat(list(parts), dim)
    runs = []
    for g in range(groups):
        runs += [_narrow(p, dim, g * (p.shape[dim] // groups),
                         p.shape[dim] // groups) for p in parts]
    return cat(runs, dim)


class ModelShards(list):
    """A leaf placed over a data row's model group: entry m is model index
    m's slice (`take_slice(full, dim, m, len(self), groups)`) on its
    device, or with `dim` None the whole leaf.  `shape` is the full
    logical shape; `device` and `dtype` are entry 0's (the group's home)."""

    def __init__(self, parts: Iterable, dim: Optional[int], groups: int = 1,
                 shape: Optional[tuple] = None):
        super().__init__(parts)
        self.dim, self.groups = dim, groups
        if shape is None:
            shape = list(self[0].shape)
            if dim is not None:
                shape[dim] *= len(self)
        self.shape = tuple(shape)

    @property
    def device(self) -> torch.device:
        return self[0].device

    @property
    def dtype(self):
        return self[0].dtype

    def map(self, fn) -> "ModelShards":
        """`fn` of every entry, the layout kept and the shape read from the
        results (one call per distinct entry: a replicated leaf's shared
        tensor maps once)."""
        seen: dict = {}
        out = []
        for t in self:
            if id(t) not in seen:
                seen[id(t)] = fn(t)
            out.append(seen[id(t)])
        return ModelShards(out, self.dim, self.groups)

    def full(self, device=None):
        """The whole leaf on `device` (default the home's)."""
        device = self.device if device is None else device
        if self.dim is None:
            return self[0].to(device)
        return join_slices([t.to(device) for t in self], self.dim,
                           self.groups)


def place(x, devices: Sequence, dim: Optional[int],
          groups: int = 1) -> ModelShards:
    """`x` (tensor or numpy) over a model group's `devices`: entry m model
    index m's slice on devices[m]; a replicated leaf is moved once per
    distinct device."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    count = len(devices)
    copies: dict = {}
    parts = []
    for m, dev in enumerate(devices):
        if dim is None:
            if dev not in copies:
                copies[dev] = t.to(dev)
            parts.append(copies[dev])
        else:
            parts.append(take_slice(t, dim, m, count, groups)
                         .to(dev).contiguous())
    return ModelShards(parts, dim, groups, tuple(t.shape))


def qkv_groups(path: str, spec: Sequence, shape: Sequence[int],
               count: int, n_heads: Optional[int] = None) -> tuple:
    """(spec, groups) of a leaf under the port's head-aligned qkv
    placement: a qkv kernel (or its scale) split on its output axis takes
    groups 3 when mp divides the width of a third (and the head count,
    given `n_heads`); otherwise it replicates (module docstring)."""
    spec = tuple(spec)
    if not _QKV.search(path) or not spec or spec[-1] is None:
        return spec, 1
    third = shape[-1] // 3
    if shape[-1] % 3 or third % count or (
            n_heads is not None and n_heads % count):
        return (), 1
    return spec, 3


def make_shard_fns(mesh, specs: Any, n_heads: Optional[int] = None) -> Any:
    """Per-leaf placement callables from a spec tree (the JAX
    `make_shard_fns`): each fn places its flax-layout leaf over the first
    data row's model group under its (shape-checked, head-aligned) spec."""
    devices = model_group(mesh, 0)

    def one(path, spec):
        def put(x):
            s = compatible_spec(spec, np.shape(x) if not hasattr(
                x, "shape") else tuple(x.shape), mesh)
            s, groups = qkv_groups(path, s, tuple(x.shape), len(devices),
                                   n_heads)
            return place(x, devices, model_dim(s), groups)
        return put

    return _map_with_path(one, specs)


def make_gather_fns(mesh, specs: Any) -> Any:
    """Per-leaf gather callables: a placed leaf (or a tensor) -> the full
    host numpy array, in the reference's layout (topology-portable: what
    a checkpoint or bundle holds)."""
    def one(_path, _spec):
        def gather(x):
            if isinstance(x, ModelShards):
                x = x.full(torch.device("cpu"))
            if isinstance(x, torch.Tensor):
                return x.detach().cpu().numpy()
            return np.asarray(x)
        return gather

    return _map_with_path(one, specs)


def shard_tree(tree: Any, mesh, rules: Optional[Sequence] = None, *,
               on_unmatched: str = UNMATCHED_RAISE,
               n_heads: Optional[int] = None) -> Any:
    """A host flax-layout tree placed over the mesh's model axis by the
    rules: every leaf a `ModelShards` over the first data row's model
    group (data rows replicate it; `ModelShards.full` or `place` move it
    to another row)."""
    specs = match_partition_rules(tree, rules, on_unmatched=on_unmatched)
    fns = make_shard_fns(mesh, specs, n_heads)
    return _zip_map(lambda f, x: f(x), fns, tree)


def gather_tree(tree: Any, mesh) -> Any:
    """A (possibly placed) tree gathered to full host numpy arrays."""
    fns = make_gather_fns(mesh, _map_with_path(lambda p, x: (), tree))
    return _zip_map(lambda f, x: f(x), fns, tree)


def _zip_map(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    return fn(a, b)


# -- the port's parameters by their flax paths --------------------------------

def flax_leaf(prefix: str, leaf: str, node: dict) -> tuple:
    """(flax path, flax shape, port dim of each flax dim) of the port
    leaf `prefix.leaf` in a node of sibling leaves `node` (name -> shape),
    by `models/bundle.py` `variables_to_jax`'s node rules."""
    shape = tuple(node[leaf])
    base = prefix.replace(".", "/")
    ident = tuple(range(len(shape)))
    if "mean" in node or ("scale" in node and "weight" not in node):
        return f"{base}/{leaf}", shape, ident      # a norm's scale / bias
    if leaf == "weight" and len(shape) == 4:
        # Conv (out, in, kh, kw) <- HWIO (kh, kw, in, out)
        return (f"{base}/kernel", (shape[2], shape[3], shape[1], shape[0]),
                (2, 3, 1, 0))
    if leaf == "weight" and ("bias" in node or "scale" in node):
        return f"{base}/kernel", shape[::-1], (1, 0)   # Dense (out, in)
    if leaf == "weight":
        return f"{base}/embedding", shape, ident
    if leaf == "scale":
        return f"{base}/kernel_scale", shape, ident
    return f"{base}/{leaf}", shape, ident


def is_expert_stack(path: str, shape: Sequence[int], axis_size: int = 1
                    ) -> bool:
    """`ops/moe.py` `is_expert_stack` over a '/'-joined path."""
    keys = path.split("/")
    return (len(shape) == 3 and keys[-1] in ("w_in", "w_out")
            and any("moe" in k.lower() for k in keys[:-1])
            and axis_size > 0 and shape[0] % axis_size == 0)


def param_sharding_rule(mesh, tensor_parallel: bool = True,
                        expert_parallel: bool = True,
                        partition_rules: Optional[Sequence] = None):
    """The JAX Trainer's `_param_sharding_rule` (trainer.py:78-118) as a
    spec function `rule(path, flax shape) -> spec`: the registry's layout
    where it survives `compatible_spec` (an expert stack's only with
    `expert_parallel`), else expert stacks over 'model', else a kernel of
    rank >= 2 whose last dim mp divides and is at least 8 mp split there,
    else replicated."""
    mp = mesh.shape.get(MODEL_AXIS, 1)
    rules = tuple(DEFAULT_RULES if partition_rules is None
                  else partition_rules)

    def rule(path: str, shape: tuple) -> tuple:
        if tensor_parallel and mp > 1:
            spec = compatible_spec(
                leaf_spec(path, shape, rules, UNMATCHED_REPLICATE), shape,
                mesh)
            if len(spec) and (expert_parallel
                              or not is_expert_stack(path, shape, mp)):
                return spec
        if expert_parallel and mp > 1 and is_expert_stack(path, shape, mp):
            return (MODEL_AXIS, None, None)
        if (tensor_parallel and mp > 1 and len(shape) >= 2
                and shape[-1] % mp == 0 and shape[-1] >= mp * 8):
            return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
        return ()

    return rule


def registry_rule(mesh, rules: Optional[Sequence] = None,
                  on_unmatched: str = UNMATCHED_REPLICATE):
    """`shard_tree`'s spec function over the rules alone (the scoring and
    decoding placements of `TPUModel.set_mesh` / `TextGenerator`)."""
    rule_list = _check_rules(rules)
    return lambda path, shape: compatible_spec(
        leaf_spec(path, shape, rule_list, on_unmatched), shape, mesh)


def port_splits(module, mesh, rule) -> dict:
    """{port parameter or buffer name: (port dim, groups)} of every leaf of
    `module` that `rule(flax path, flax shape)` splits over 'model' (the
    others replicate): the flax path and dims come from the leaf's node
    (`flax_leaf`), a qkv kernel takes the head-aligned layout
    (`qkv_groups`, at `module.n_heads` when it has one)."""
    mp = mesh.shape[MODEL_AXIS]
    nodes: dict = {}
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        prefix, _, leaf = name.rpartition(".")
        nodes.setdefault(prefix, {})[leaf] = tuple(t.shape)
    n_heads = getattr(module, "n_heads", None)
    out = {}
    for prefix, node in nodes.items():
        for leaf in node:
            path, shape, dims = flax_leaf(prefix, leaf, node)
            spec = tuple(rule(path, shape))
            spec, groups = qkv_groups(path, spec, shape, mp, n_heads)
            dim = model_dim(spec)
            if dim is not None:
                out[f"{prefix}.{leaf}" if prefix else leaf] = (dims[dim],
                                                               groups)
    return out


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
