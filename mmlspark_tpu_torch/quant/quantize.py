"""Quantization: the port of `mmlspark_tpu/quant/quantize.py`.

Weight post-training quantization of model bundles, on the host in numpy
(`quantize_bundle`):

  * ``bf16`` — every floating leaf becomes bfloat16 and the config's
    compute dtype "bfloat16": half the weight bytes.
  * ``int8`` — every rank-2 (Dense) or rank-4 (Conv) ``kernel`` becomes
    per-output-channel symmetric int8 with an MSE clip search over
    `_CLIP_FRACTIONS` of the channel's |w| max, stored beside its f32
    ``kernel_scale`` (out,); every other floating leaf becomes bfloat16,
    and the whole ``moe`` subtree stays un-int8'd.  The decode path runs
    int8 weights x bf16 activations with the scale after the product
    (`models/definitions.py` `int8_linear`).

numpy has no bfloat16: the port rounds f32 -> bf16 with torch's
round-to-nearest-even cast (the rounding `ml_dtypes` does) and carries the
raw payload as `core.bf16.BF16Array`, so the quantized trees, and the
`params.msgpack` files saved from them, are byte-identical to the JAX
package's.

KV-cache quantization (`quantize_kv`): per-head symmetric int8 with one
f32 scale per (row, slot, head): the granularity the decode step writes
(one new token's K/V per step) and the cache read dequantizes at no extra
bandwidth (the scale array is 1/D the payload).  `torch.round` rounds half
to even, as `jnp.round` does, so the int8 bytes equal the JAX package's
for the same input.
"""

from __future__ import annotations

import inspect
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.bf16 import BF16Array

if TYPE_CHECKING:
    from mmlspark_tpu_torch.models.bundle import ModelBundle

INT8_MAX = 127.0

# per-channel clip search: candidate fractions of the channel's |w| max
# tried as the clipping range, the one of least squared error kept
_CLIP_FRACTIONS = (1.0, 0.975, 0.95, 0.925, 0.9, 0.85, 0.8)


def quantize_array_int8(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8 of a kernel whose LAST axis is
    the output channel (flax Dense (in, out), Conv HWIO).  Returns (q int8,
    scale f32 (out,)) with w ~= q * scale and, per channel, |w - q*scale|
    <= max(scale/2, amax - 127*scale); an all-zero channel gets scale 0.
    The same numpy operations as the JAX package's, so the bytes agree."""
    w = np.asarray(w, np.float32)
    red = tuple(range(w.ndim - 1))
    amax = np.abs(w).max(axis=red)
    best_scale = best_err = None
    for frac in _CLIP_FRACTIONS:
        scale = amax * (frac / INT8_MAX)
        inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
        q = np.clip(np.round(w * inv), -INT8_MAX, INT8_MAX)
        err = ((w - q * scale) ** 2).sum(axis=red)
        if best_err is None:
            best_scale, best_err = scale, err
        else:
            better = err < best_err
            best_err = np.where(better, err, best_err)
            best_scale = np.where(better, scale, best_scale)
    scale = best_scale.astype(np.float32)
    inv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    q = np.clip(np.round(w * inv), -INT8_MAX, INT8_MAX).astype(np.int8)
    return q, scale


def dequantize_array(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """The f32 weights an int8 (q, scale) pair represents."""
    return np.asarray(q, np.float32) * np.asarray(scale, np.float32)


def _is_float(arr) -> bool:
    return isinstance(arr, BF16Array) or np.issubdtype(
        np.asarray(arr).dtype, np.floating)


def _should_quantize(key: str, arr) -> bool:
    return key == "kernel" and arr.ndim in (2, 4) and _is_float(arr)


def _quantize_tree(tree: dict, mode: str, stats: dict,
                   int8_ok: bool = True) -> dict:
    out: dict = {}
    # keys in sorted order, as the JAX package's tree walk visits them
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            # the `moe` subtree stays float (router included), as in the
            # JAX package, whose decode re-applies the real MoE module
            out[k] = _quantize_tree(v, mode, stats, int8_ok and k != "moe")
            continue
        if mode == "int8" and int8_ok and _should_quantize(k, v):
            q, s = quantize_array_int8(np.asarray(v))
            out[k] = q
            out[k + "_scale"] = s
            stats["int8_kernels"] += 1
        elif _is_float(v):
            out[k] = BF16Array.from_f32(np.asarray(v))
        else:
            out[k] = np.asarray(v)
    return out


def _dequantize_tree(tree: dict, dtype=np.float32) -> dict:
    out: dict = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _dequantize_tree(v, dtype)
        elif k.endswith("_scale") and k[:-len("_scale")] in tree:
            continue
        elif k + "_scale" in tree:
            out[k] = dequantize_array(v, tree[k + "_scale"]).astype(dtype)
        elif isinstance(v, BF16Array):
            # bfloat16 is no numpy floating type: the JAX package keeps
            # such leaves as they are, and so does the port
            out[k] = v
        elif np.issubdtype(np.asarray(v).dtype, np.floating):
            out[k] = np.asarray(v, dtype)
        else:
            out[k] = np.asarray(v)
    return out


def _takes_dtype(architecture: str) -> bool:
    from mmlspark_tpu_torch.models.definitions import MODEL_REGISTRY
    cls = MODEL_REGISTRY.get(architecture)
    return cls is not None and "dtype" in inspect.signature(cls).parameters


def quantize_bundle(bundle: ModelBundle, mode: str = "bf16") -> ModelBundle:
    """A new ModelBundle with quantized variables (the input untouched):
    the same architecture, the config's compute dtype "bfloat16", and
    `metadata["quantization"]` = {mode, compute_dtype, int8_kernels}."""
    from mmlspark_tpu_torch.models.bundle import ModelBundle
    if mode not in ("bf16", "int8"):
        raise ValueError(f"unknown quantization mode '{mode}' (bf16 | int8)")
    stats = {"int8_kernels": 0}
    variables = _quantize_tree(bundle.variables, mode, stats)
    config = dict(bundle.config)
    if _takes_dtype(bundle.architecture):
        config["dtype"] = "bfloat16"
    metadata = dict(bundle.metadata or {})
    metadata["quantization"] = {
        "mode": mode, "compute_dtype": "bfloat16",
        "int8_kernels": stats["int8_kernels"],
    }
    return ModelBundle(bundle.architecture, config, variables, metadata)


def dequantize_bundle(bundle: ModelBundle, dtype=np.float32) -> ModelBundle:
    """A quantized bundle's int8 kernels expanded back to `dtype` weights
    (for measuring the error; never the serving path); bfloat16 leaves
    stay bfloat16, as in the JAX package."""
    from mmlspark_tpu_torch.models.bundle import ModelBundle
    metadata = dict(bundle.metadata or {})
    metadata.pop("quantization", None)
    return ModelBundle(bundle.architecture, dict(bundle.config),
                       _dequantize_tree(bundle.variables, dtype), metadata)


def quantization_mode(bundle: ModelBundle) -> Optional[str]:
    """'bf16' / 'int8' for a quantized bundle, None otherwise."""
    return ((bundle.metadata or {}).get("quantization") or {}).get("mode")


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., H, D) -> (int8 values (..., H, D), f32 scale (..., H)).

    All-zero vectors (never-written cache slots) get scale 0, so the
    dequant reproduces exact zeros."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = amax / INT8_MAX
    nonzero = amax > 0
    inv = torch.where(nonzero, INT8_MAX / torch.where(nonzero, amax, 1.0),
                      0.0)
    q = torch.clamp(torch.round(x32 * inv[..., None]), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale
