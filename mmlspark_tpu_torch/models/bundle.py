"""ModelBundle: the serialized-model format, shared with the JAX package.

A bundle is a directory:

    bundle.json      {"architecture": <registry name>, "config": {...},
                      "metadata": {...}}
    params.msgpack   the flax variables (params, and batch_stats for
                     BatchNorm models) in flax's msgpack format

Both files are read and written here with the plain `msgpack` package,
decoding and encoding flax's ndarray extension type (ext code 1: a packed
(shape, dtype name, C-order bytes) triple), so a bundle written by either
package loads in the other.  `ModelBundle.variables` keeps the flax tree of
numpy arrays; `variables_from_jax` turns it into the port's state_dict and
`variables_to_jax` back (a bundle the port writes loads in the JAX
package).

numpy has no bfloat16, and the JAX package's quantized bundles
(`quant/quantize.py`) hold bfloat16 leaves: those load as `BF16Array`,
which carries the raw 16-bit payload, so a loaded bundle saves back with
the same bytes; `np.asarray` of one widens it exactly to f32.  An int8
Dense node (`kernel` int8 (in, out), `kernel_scale` f32 (out,), `bias`)
builds an `Int8Dense` layer holding the int8 weight (out, in), an int8
Conv node (`kernel` int8 HWIO) an `Int8Conv` holding it as (out, in, kh,
kw).  A mixture-of-experts block's `moe` node holds a Dense `router`
(transposed like every Dense kernel) and the rank-3 expert stacks `w_in`
(E, D, H) and `w_out` (E, H, D), which keep their names and layout.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import is_lazy

from mmlspark_tpu_torch.core.bf16 import BF16Array
from mmlspark_tpu_torch.models.definitions import (
    MODEL_REGISTRY, BatchNorm, Int8Conv, Int8Dense, build_model,
    init_scoring_params, init_transformer_lm_params, model_config)

# flax.serialization's msgpack extension codes
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
# msgpack's per-object limit; flax chunks larger leaves, which no model of
# this package reaches
_MAX_LEAF_BYTES = 2 ** 30


@dataclasses.dataclass
class ModelBundle:
    """An architecture + its flax-layout variables (numpy arrays)."""

    architecture: str
    config: dict
    variables: dict            # {"params": ..., possibly "batch_stats": ...}
    metadata: dict = dataclasses.field(default_factory=dict)

    def module(self, device="cuda", config: Optional[dict] = None
               ) -> nn.Module:
        """The architecture (with `config` in place of the bundle's when
        given) built on `device` with these weights loaded: f32 masters
        (bfloat16 leaves widen exactly), BatchNorm statistics as buffers,
        the shapes a layer infers from its input taken from the weights,
        and for each int8 Dense or Conv node of a
        `quantize_bundle(..., "int8")` tree an `Int8Dense` / `Int8Conv`
        holding the int8 weight, its f32 scale and its bias as stored."""
        module = build_model(self.architecture,
                             self.config if config is None else config,
                             device=device)
        state = variables_from_jax(self.variables)
        _materialize(module, state)
        for name, value in state.items():
            prefix, _, leaf = name.rpartition(".")
            if leaf == "weight" and value.dtype == torch.int8:
                parent, _, attr = prefix.rpartition(".")
                module.get_submodule(parent).register_module(
                    attr, _int8_layer(module.get_submodule(prefix), value,
                                      state.get(f"{prefix}.bias")))
        module.load_state_dict(state)
        return module.eval()

    def partition_rules(self) -> Optional[tuple]:
        """The partition rules this bundle was trained under
        (`metadata["partition"]["rules"]`), or None for a bundle without
        them (consumers then take DEFAULT_RULES)."""
        data = (self.metadata or {}).get("partition", {}).get("rules")
        if not data:
            return None
        from mmlspark_tpu_torch.parallel.partition import rules_from_json
        return rules_from_json(data)

    def partition_mesh_shape(self) -> Optional[dict]:
        """{"data": dp, "model": mp} the bundle was produced under, or
        None."""
        return (self.metadata or {}).get("partition", {}).get("mesh")

    @staticmethod
    def from_module(module: nn.Module,
                    metadata: Optional[dict] = None) -> "ModelBundle":
        """A bundle of a registered module's current weights."""
        return ModelBundle(registry_name(module), model_config(module),
                           variables_to_jax(module.state_dict()),
                           dict(metadata or {}))

    @staticmethod
    def init(architecture: str, config: dict, seed: int = 0,
             metadata: Optional[dict] = None,
             input_shape: Optional[tuple] = None) -> "ModelBundle":
        """Fresh seeded numpy weights for a registered architecture.  The
        scoring models need the `input_shape` of a batch (their first
        layers' widths come from it, as in flax's `ModelBundle.init`)."""
        if architecture not in MODEL_REGISTRY:
            raise KeyError(f"model '{architecture}' is not ported")
        if architecture == "TransformerLM":
            variables = init_transformer_lm_params(config, seed)
        elif input_shape is None:
            raise ValueError(f"ModelBundle.init of {architecture} needs "
                             "the input_shape of a batch")
        else:
            module = build_model(architecture, config, device="cpu")
            variables = init_scoring_params(module, tuple(input_shape), seed)
            config = model_config(module)  # every field, as flax records
        return ModelBundle(architecture, dict(config), variables,
                           dict(metadata or {}))


def calibrated_bundle(bundle: ModelBundle, images: np.ndarray,
                      seed: int, branch_scale: float = 1.0) -> ModelBundle:
    """A float bundle with random weights made input-dependent, for checks
    that must see a wrong forward: every BatchNorm gets scale ~ U[0.5,
    1.5] and bias ~ N(0, 0.1) from `seed`, and as mean and var the
    statistics of its own input over `images` in an f32 CPU forward (set
    just before the layer runs, so each later layer sees normalised
    activations); the head's bias is then shifted so that the logits of
    `images` have mean 0 in every class.  Without this, random weights
    give logits that a constant term dominates, one class for every
    input."""
    rng = np.random.default_rng(seed)
    module = bundle.module("cpu", {**bundle.config, "dtype": "float32"})
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in norms:
        n = bn.scale.numel()
        bn.scale.data = torch.from_numpy(
            rng.uniform(0.5, 1.5, n).astype(np.float32)
            * (branch_scale if bn.zero_scale else 1.0))
        bn.bias.data = torch.from_numpy(
            rng.normal(0.0, 0.1, n).astype(np.float32))

    def fit(bn, args):
        x = args[0].float()
        bn.mean.copy_(x.mean((0, 2, 3)))
        bn.var.copy_(x.var((0, 2, 3), unbiased=False))

    handles = [bn.register_forward_pre_hook(fit) for bn in norms]
    try:
        with torch.no_grad():
            logits = module(torch.from_numpy(np.asarray(images)))[0]
    finally:
        for h in handles:
            h.remove()
    module.out.bias.data = module.out.bias.data - logits.mean(0)
    return ModelBundle(bundle.architecture, dict(bundle.config),
                       variables_to_jax(module.state_dict()),
                       dict(bundle.metadata))


def _materialize(module: nn.Module, state: dict) -> None:
    """Give every layer that infers its shape from its input (`Dense(None,
    ...)`, `Conv(None, ...)`) the shape of its weight in `state`."""
    for name, param in module.named_parameters():
        if is_lazy(param):
            param.materialize(tuple(state[name].shape))


def load_variables(module: nn.Module, variables: dict) -> nn.Module:
    """Load float flax-layout variables (params, and batch_stats for
    BatchNorm models) into a registered module in place: its f32 masters
    and buffers, lazy layers materialized from the weights' shapes."""
    state = variables_from_jax(variables)
    _materialize(module, state)
    module.load_state_dict(state)
    return module


def _int8_layer(old: nn.Module, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> nn.Module:
    """The int8 counterpart of a Dense or Conv layer, at the stored
    weight's shape."""
    bias_dtype = None if bias is None else bias.dtype
    device = old.weight.device
    if weight.dim() == 4:
        return Int8Conv(weight.shape[1], weight.shape[0], old.kernel,
                        old.strides, old.compute_dtype, bias_dtype,
                        device=device)
    return Int8Dense(weight.shape[1], weight.shape[0], old.compute_dtype,
                     bias_dtype=bias_dtype, device=device)


def _to_torch(x) -> torch.Tensor:
    """A flax leaf as an f32 tensor (bfloat16 widened exactly)."""
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_jax(tree: dict) -> dict:
    """The JAX package's parameter tree (numpy leaves, flax names) -> the
    port's state_dict: Dense kernels (in, out) become Linear weights
    (out, in), Conv kernels HWIO become (out, in, kh, kw), embeddings
    `embedding` -> `weight`, LayerNorm and BatchNorm `scale`/`bias` keep
    their names, and any other leaf (a MoE block's expert stacks `w_in`,
    `w_out`) keeps its name and layout.  Values are f32 (bfloat16 leaves
    widened exactly), except
    an int8 Dense or Conv node's: its weight stays int8 in the torch
    layout, its `kernel_scale` becomes `scale` (f32) and its bias keeps
    its stored dtype (bfloat16 as `torch.bfloat16`).

    The pipeline's stacked tree (`parallel/pipeline.py`: `tok_embed`,
    `pos_embed`, `blocks` with every block leaf stacked on a leading
    layer dim, `norm_scale`, `norm_bias`, `head`, `head_bias`) maps the
    same way: its raw leaves keep their names and layout, and a stacked
    Dense kernel (L, in, out) becomes `blocks.<layer>.weight` (L, out,
    in)."""
    state = {}

    def weight(kernel: np.ndarray, dtype) -> torch.Tensor:
        k = np.asarray(kernel, dtype)
        order = {4: (3, 2, 0, 1), 3: (0, 2, 1)}.get(k.ndim, (1, 0))
        return torch.from_numpy(np.ascontiguousarray(k.transpose(order)))

    def walk(prefix: str, node: dict) -> None:
        if "kernel_scale" in node:
            state[f"{prefix}.weight"] = weight(node["kernel"], np.int8)
            state[f"{prefix}.scale"] = _to_torch(node["kernel_scale"])
            if "bias" in node:
                bias = node["bias"]
                state[f"{prefix}.bias"] = (bias.torch()
                                           if isinstance(bias, BF16Array)
                                           else _to_torch(bias))
        elif "kernel" in node:
            state[f"{prefix}.weight"] = weight(node["kernel"], np.float32)
            if "bias" in node:
                state[f"{prefix}.bias"] = _to_torch(node["bias"])
        elif "embedding" in node:
            state[f"{prefix}.weight"] = _to_torch(node["embedding"])
        elif "scale" in node:
            state[f"{prefix}.scale"] = _to_torch(node["scale"])
            state[f"{prefix}.bias"] = _to_torch(node["bias"])
        else:
            for name, child in node.items():
                path = f"{prefix}.{name}" if prefix else name
                if isinstance(child, dict):
                    walk(path, child)
                else:
                    state[path] = _to_torch(child)

    walk("", tree)
    return state


def variables_from_jax(variables: dict) -> dict:
    """`params_from_jax` of `variables["params"]` plus the BatchNorm
    statistics of `variables["batch_stats"]` (`mean`, `var`, f32)."""
    state = params_from_jax(variables["params"])

    def walk(prefix: str, node: dict) -> None:
        for name, child in node.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(child, dict):
                walk(path, child)
            else:
                state[path] = _to_torch(child)

    walk("", variables.get("batch_stats", {}))
    return state


def params_to_jax(state_dict: dict) -> dict:
    """The parameter tree of `variables_to_jax` (the inverse of
    `params_from_jax`)."""
    return variables_to_jax(state_dict)["params"]


def variables_to_jax(state_dict: dict) -> dict:
    """The inverse of `variables_from_jax`: the port's state_dict -> the
    JAX package's variables of numpy arrays with flax names, {"params":
    ...} plus "batch_stats" when the model has BatchNorm layers.  A node
    with `mean`/`var` is a BatchNorm (scale/bias to params, mean/var to
    batch_stats), `scale`/`bias` alone a LayerNorm, `weight`/`scale` an
    int8 Dense or Conv (written back as the int8 tree it was loaded from:
    int8 kernel, f32 `kernel_scale`, the bias in its own dtype), a rank-4
    `weight` a Conv (bias optional), `weight`/`bias` a Dense, `weight`
    alone an embedding, and a node without `weight` or `scale` (a MoE
    block's expert stacks, the pipeline's raw leaves at the root) keeps
    its leaves as they are; a rank-3 `weight` is a stacked Dense of the
    pipeline's tree (L, out, in) -> `kernel` (L, in, out)."""
    nodes: dict = {}
    for name, value in state_dict.items():
        prefix, _, leaf = name.rpartition(".")
        value = value.detach().cpu()
        if value.dtype == torch.int8:
            host = value.numpy().copy()
        elif value.dtype == torch.bfloat16:
            host = BF16Array(value.view(torch.int16).numpy().view(np.uint16)
                             .copy())
        else:
            host = value.float().numpy().copy()
        nodes.setdefault(prefix, {})[leaf] = host

    def kernel(w: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(
            w.transpose({4: (2, 3, 1, 0), 3: (0, 2, 1)}.get(w.ndim, (1, 0))))

    variables: dict = {"params": {}}
    for prefix, leaves in nodes.items():
        stats = None
        if "mean" in leaves:
            node = {"scale": leaves["scale"], "bias": leaves["bias"]}
            stats = {"mean": leaves["mean"], "var": leaves["var"]}
        elif "weight" in leaves and "scale" in leaves:
            node = {"kernel": kernel(leaves["weight"]),
                    "kernel_scale": leaves["scale"]}
        elif "scale" in leaves:
            node = {"scale": leaves["scale"], "bias": leaves["bias"]}
        elif "weight" not in leaves:
            node = dict(leaves)
        elif "bias" in leaves or leaves["weight"].ndim == 4:
            node = {"kernel": kernel(leaves["weight"])}
        else:
            node = {"embedding": leaves["weight"]}
        if "bias" in leaves and "kernel" in node:
            node["bias"] = leaves["bias"]
        for tree, value in (("params", node), ("batch_stats", stats)):
            if value is None:
                continue
            parent = variables.setdefault(tree, {})
            if not prefix:
                # leaves at the root (the pipeline's raw embed / head)
                parent.update(value)
                continue
            *path, last = prefix.split(".")
            for key in path:
                parent = parent.setdefault(key, {})
            parent[last] = value
    return variables


def registry_name(module: nn.Module) -> str:
    """The registry name a module's bundle records."""
    for name, cls in MODEL_REGISTRY.items():
        if type(module) is cls:
            return name
    raise KeyError(f"{type(module).__name__} is not a registered model")


def _unpack_ext(code: int, data: bytes):
    import msgpack
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        return msgpack.ExtType(code, data)
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: keep the payload, so it saves back as is
        return BF16Array(np.frombuffer(buffer, dtype=np.uint16)
                         .reshape(shape))
    arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()))
    arr = arr.reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def _pack_ext(x):
    import msgpack
    if isinstance(x, BF16Array):
        return msgpack.ExtType(_EXT_NDARRAY, msgpack.packb(
            (x.shape, BF16Array.dtype_name, x.bits.tobytes("C")),
            use_bin_type=True))
    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        if arr.dtype.hasobject or arr.nbytes > _MAX_LEAF_BYTES:
            raise ValueError(f"cannot serialize array leaf {arr.dtype} "
                             f"{arr.shape}")
        payload = msgpack.packb((arr.shape, arr.dtype.name,
                                 arr.tobytes("C")), use_bin_type=True)
        code = _EXT_NPSCALAR if isinstance(x, np.generic) else _EXT_NDARRAY
        return msgpack.ExtType(code, payload)
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _sorted_tree(tree):
    """The tree with every dict's keys in sorted order: flax writes a
    tree in the order of JAX's tree walk, so the files agree byte for
    byte."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def save_bundle(bundle: ModelBundle, path: str) -> None:
    import msgpack
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "bundle.json"), "w") as f:
        json.dump({
            "architecture": bundle.architecture,
            "config": bundle.config,
            "metadata": bundle.metadata,
        }, f, indent=1)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(msgpack.packb(_sorted_tree(bundle.variables),
                              default=_pack_ext, strict_types=True))


def load_bundle(path: str) -> ModelBundle:
    import msgpack
    with open(os.path.join(path, "bundle.json")) as f:
        info = json.load(f)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        variables = msgpack.unpackb(f.read(), ext_hook=_unpack_ext,
                                    raw=False)
    return ModelBundle(info["architecture"], info["config"], variables,
                       info.get("metadata", {}))

