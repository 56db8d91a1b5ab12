"""ModelBundle: the serialized-model format, shared with the JAX package.

A bundle is a directory:

    bundle.json      {"architecture": <registry name>, "config": {...},
                      "metadata": {...}}
    params.msgpack   the flax parameter tree in flax's msgpack format

Both files are read and written here with the plain `msgpack` package,
decoding and encoding flax's ndarray extension type (ext code 1: a packed
(shape, dtype name, C-order bytes) triple), so a bundle written by either
package loads in the other.  `ModelBundle.variables` keeps the flax tree of
numpy arrays; `params_from_jax` turns it into the port's state_dict and
`params_to_jax` back (a bundle the port trains loads in the JAX package).

numpy has no bfloat16, and the JAX package's quantized bundles
(`quant/quantize.py`) hold bfloat16 leaves: those load as `BF16Array`,
which carries the raw 16-bit payload, so a loaded bundle saves back with
the same bytes; `np.asarray` of one widens it exactly to f32.  An int8
Dense node (`kernel` int8 (in, out), `kernel_scale` f32 (out,), `bias`)
builds an `Int8Dense` layer holding the int8 weight (out, in).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from mmlspark_tpu_torch.core.bf16 import BF16Array
from mmlspark_tpu_torch.models.definitions import (
    MODEL_REGISTRY, Int8Dense, build_model, init_transformer_lm_params,
    model_config)

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
    variables: dict            # {"params": ...}
    metadata: dict = dataclasses.field(default_factory=dict)

    def module(self, device="cuda") -> nn.Module:
        """The architecture built on `device` with these weights loaded:
        f32 masters (bfloat16 leaves widen exactly), and for each int8
        Dense node of a `quantize_bundle(..., "int8")` tree an `Int8Dense`
        holding the int8 weight, its f32 scale and its bias as stored."""
        module = build_model(self.architecture, self.config, device=device)
        state = params_from_jax(self.variables["params"])
        for name, value in state.items():
            prefix, _, leaf = name.rpartition(".")
            if leaf == "weight" and value.dtype == torch.int8:
                parent, _, attr = prefix.rpartition(".")
                old = module.get_submodule(prefix)
                module.get_submodule(parent).register_module(attr, Int8Dense(
                    old.in_features, old.out_features, old.compute_dtype,
                    bias_dtype=state[f"{prefix}.bias"].dtype,
                    device=old.weight.device))
        module.load_state_dict(state)
        return module.eval()

    @staticmethod
    def from_module(module: nn.Module,
                    metadata: Optional[dict] = None) -> "ModelBundle":
        """A bundle of a registered module's current weights."""
        return ModelBundle(registry_name(module), model_config(module),
                           {"params": params_to_jax(module.state_dict())},
                           dict(metadata or {}))

    @staticmethod
    def init(architecture: str, config: dict, seed: int = 0,
             metadata: Optional[dict] = None) -> "ModelBundle":
        """Fresh seeded numpy weights for a registered architecture."""
        if architecture not in MODEL_REGISTRY:
            raise KeyError(f"model '{architecture}' is not ported")
        return ModelBundle(architecture, dict(config),
                           init_transformer_lm_params(config, seed),
                           dict(metadata or {}))


def params_from_jax(tree: dict) -> dict:
    """The JAX package's parameter tree (numpy leaves, flax names) -> the
    port's state_dict: Dense kernels (in, out) become Linear weights
    (out, in), embeddings `embedding` -> `weight`, LayerNorm `scale`/`bias`
    keep their names.  Values are f32 (bfloat16 leaves widened exactly),
    except an int8 Dense node's: its weight stays int8 (out, in), its
    `kernel_scale` becomes `scale` (f32) and its bias keeps its stored
    dtype (bfloat16 as `torch.bfloat16`)."""
    state = {}

    def tensor(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def walk(prefix: str, node: dict) -> None:
        if "kernel_scale" in node:
            bias = node["bias"]
            state[f"{prefix}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(node["kernel"], np.int8).T))
            state[f"{prefix}.scale"] = tensor(node["kernel_scale"])
            state[f"{prefix}.bias"] = (bias.torch()
                                       if isinstance(bias, BF16Array)
                                       else tensor(bias))
        elif "kernel" in node:
            state[f"{prefix}.weight"] = tensor(node["kernel"]).T.contiguous()
            state[f"{prefix}.bias"] = tensor(node["bias"])
        elif "embedding" in node:
            state[f"{prefix}.weight"] = tensor(node["embedding"])
        elif "scale" in node:
            state[f"{prefix}.scale"] = tensor(node["scale"])
            state[f"{prefix}.bias"] = tensor(node["bias"])
        else:
            for name, child in node.items():
                walk(f"{prefix}.{name}" if prefix else name, child)

    walk("", tree)
    return state


def params_to_jax(state_dict: dict) -> dict:
    """The inverse of `params_from_jax`: the port's state_dict -> the JAX
    package's parameter tree of f32 numpy arrays with flax names.  A node
    with `weight` and `bias` is a Dense (weight (out, in) -> kernel
    (in, out)), `weight` alone an embedding, `scale`/`bias` a LayerNorm,
    `weight`/`scale`/`bias` an int8 Dense, written back as the int8 tree
    it was loaded from (int8 kernel, f32 `kernel_scale`, the bias in its
    own dtype)."""
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
    tree: dict = {}
    for prefix, leaves in nodes.items():
        if "weight" in leaves and "scale" in leaves:
            node = {"kernel": np.ascontiguousarray(leaves["weight"].T),
                    "kernel_scale": leaves["scale"], "bias": leaves["bias"]}
        elif "scale" in leaves:
            node = {"scale": leaves["scale"], "bias": leaves["bias"]}
        elif "bias" in leaves:
            node = {"kernel": np.ascontiguousarray(leaves["weight"].T),
                    "bias": leaves["bias"]}
        else:
            node = {"embedding": leaves["weight"]}
        parent = tree
        *path, last = prefix.split(".")
        for key in path:
            parent = parent.setdefault(key, {})
        parent[last] = node
    return tree


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

