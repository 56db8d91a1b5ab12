"""ModelBundle: the serialized-model format, shared with the JAX package.

A bundle is a directory:

    bundle.json      {"architecture": <registry name>, "config": {...},
                      "metadata": {...}}
    params.msgpack   the flax parameter tree in flax's msgpack format

Both files are read and written here with the plain `msgpack` package,
decoding and encoding flax's ndarray extension type (ext code 1: a packed
(shape, dtype name, C-order bytes) triple), so a bundle written by either
package loads in the other.  `ModelBundle.variables` keeps the flax tree of
numpy arrays; `params_from_jax` turns it into the port's state_dict.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from mmlspark_tpu_torch.models.definitions import (
    MODEL_REGISTRY, build_model, init_transformer_lm_params)

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
        """The architecture built on `device` with these weights loaded."""
        module = build_model(self.architecture, self.config, device=device)
        module.load_state_dict(params_from_jax(self.variables["params"]))
        return module.eval()

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
    keep their names.  Values stay f32; `load_state_dict` casts Dense
    weights to the model dtype."""
    state = {}

    def tensor(x) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=np.float32))

    def walk(prefix: str, node: dict) -> None:
        if "kernel_scale" in node:
            raise NotImplementedError(
                f"{prefix}: int8-quantized weight bundles are not ported")
        if "kernel" in node:
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


def _bf16_to_f32(raw: bytes) -> np.ndarray:
    bits = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def _unpack_ext(code: int, data: bytes):
    import msgpack
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        return msgpack.ExtType(code, data)
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen exactly to f32
        arr = _bf16_to_f32(buffer)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()))
    arr = arr.reshape(shape)
    return arr[()] if code == _EXT_NPSCALAR else arr


def _pack_ext(x):
    import msgpack
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
        f.write(msgpack.packb(bundle.variables, default=_pack_ext,
                              strict_types=True))


def load_bundle(path: str) -> ModelBundle:
    import msgpack
    with open(os.path.join(path, "bundle.json")) as f:
        info = json.load(f)
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        variables = msgpack.unpackb(f.read(), ext_hook=_unpack_ext,
                                    raw=False)
    return ModelBundle(info["architecture"], info["config"], variables,
                       info.get("metadata", {}))

