"""Model definitions in PyTorch: the decoder-only `TransformerLM` (the port
of `mmlspark_tpu/models/definitions.py` :196-357, dense MLP only) and the
model registry.

The module tree keeps the flax names, so a parameter's path reads the same
in both packages: `tok_embed`, `pos_embed`, `block{i}_w.{LayerNorm_0, qkv,
proj, LayerNorm_1, mlp_up, mlp_down}`, `final_norm_w`, `lm_head`.  Traps of
the flax definition that the port keeps:

  * LayerNorm eps is 1e-6, statistics in f32 (flax's E[x^2] - E[x]^2
    variance in the forward);
  * gelu is the tanh approximation;
  * a flax Dense kernel is (in, out), a torch Linear weight (out, in)
    (`models/bundle.py::params_from_jax` transposes);
  * parameters are f32 in a bundle; Dense layers compute in the model dtype,
    so their weights are cast to it once at load.  Embeddings and norms keep
    f32, because the decode path sums embeddings and applies norm
    scales in f32 before casting.

`forward` is `module.apply` of the flax model: the parity target for
logits and `naive_generate`'s recompute oracle.  It is inference only.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.ops.attention import attention
from mmlspark_tpu_torch.ops.flash_attention import flash_attention

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LN_EPS = 1e-6


def dtype_of(dtype) -> torch.dtype:
    """A model dtype from its name (the bundle config's form) or itself."""
    if isinstance(dtype, torch.dtype):
        if dtype not in DTYPES.values():
            raise ValueError(f"unsupported model dtype {dtype}")
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"unsupported model dtype {dtype!r}; known: "
                         f"{sorted(DTYPES)}")
    return DTYPES[dtype]


def dtype_name(dtype: torch.dtype) -> str:
    return next(n for n, t in DTYPES.items() if t == dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`'s parameters (`scale`, `bias`, kept f32)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """flax's LayerNorm(dtype=dtype): f32 statistics with the fast
        variance, output cast to `dtype`."""
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu,
                          min=0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.scale
        return ((x32 - mu) * mul + self.bias).to(dtype)


class TransformerBlock(nn.Module):
    """Pre-norm decoder block: attention then a dense GELU MLP."""

    def __init__(self, d_model: int, n_heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16, attn_impl: str = "dense",
                 device=None):
        super().__init__()
        if attn_impl not in ("dense", "flash"):
            raise NotImplementedError(
                f"attn_impl '{attn_impl}' is not ported (dense | flash)")
        self.d_model, self.n_heads = d_model, n_heads
        self.dtype = dtype_of(dtype)
        self.attn_impl = attn_impl
        kw = dict(dtype=self.dtype, device=device)
        self.LayerNorm_0 = LayerNorm(d_model, device=device)
        self.qkv = nn.Linear(d_model, 3 * d_model, **kw)
        self.proj = nn.Linear(d_model, d_model, **kw)
        self.LayerNorm_1 = LayerNorm(d_model, device=device)
        self.mlp_up = nn.Linear(d_model, mlp_ratio * d_model, **kw)
        self.mlp_down = nn.Linear(mlp_ratio * d_model, d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h = self.LayerNorm_0(x, self.dtype)
        qkv = self.qkv(h)
        shape = (b, s, self.n_heads, self.d_model // self.n_heads)
        q, k, v = (t.reshape(shape) for t in qkv.split(self.d_model, -1))
        if self.attn_impl == "flash":
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
        else:
            o = attention(q, k, v, causal=True)
        x = x + self.proj(o.reshape(b, s, self.d_model))
        h = self.LayerNorm_1(x, self.dtype)
        h = F.gelu(self.mlp_up(h), approximate="tanh")
        return x + self.mlp_down(h)


class TransformerLM(nn.Module):
    """Decoder-only language model, dense and single-device.

    Takes the flax model's constructor fields, so a bundle config from
    either package builds it; the fields of features not ported yet
    (sequence sharding, mixture-of-experts) must keep their defaults.
    `remat`/`remat_policy` only change how training rematerializes, so
    they are kept for the config round trip and ignored."""

    def __init__(self, vocab_size: int = 256, d_model: int = 128,
                 n_heads: int = 8, n_layers: int = 2, max_len: int = 2048,
                 mlp_ratio: int = 4, dtype="bfloat16",
                 attn_impl: str = "dense", seq_axis: Optional[str] = None,
                 mlp_impl: str = "dense", n_experts: int = 8,
                 expert_axis: Optional[str] = None, moe_router_k: int = 1,
                 moe_group_size: int = 512, remat: bool = False,
                 remat_policy: str = "full", device="cuda"):
        super().__init__()
        if mlp_impl != "dense":
            raise NotImplementedError(f"mlp_impl '{mlp_impl}' is not ported")
        if seq_axis is not None or expert_axis is not None:
            raise NotImplementedError(
                "sequence- and expert-sharded TransformerLM are not ported")
        device = resolve_device(device)
        self.dtype = dtype_of(dtype)
        self.config = dict(
            vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
            n_layers=n_layers, max_len=max_len, mlp_ratio=mlp_ratio,
            dtype=dtype_name(self.dtype), attn_impl=attn_impl,
            seq_axis=seq_axis, mlp_impl=mlp_impl, n_experts=n_experts,
            expert_axis=expert_axis, moe_router_k=moe_router_k,
            moe_group_size=moe_group_size, remat=remat,
            remat_policy=remat_policy)
        self.vocab_size, self.d_model = vocab_size, d_model
        self.n_heads, self.n_layers, self.max_len = n_heads, n_layers, max_len
        self.tok_embed = nn.Embedding(vocab_size, d_model, device=device)
        self.pos_embed = nn.Embedding(max_len, d_model, device=device)
        for i in range(n_layers):
            self.add_module(f"block{i}_w", TransformerBlock(
                d_model, n_heads, mlp_ratio, self.dtype, attn_impl,
                device=device))
        self.final_norm_w = LayerNorm(d_model, device=device)
        self.lm_head = nn.Linear(d_model, vocab_size, dtype=self.dtype,
                                 device=device)

    @property
    def blocks(self) -> list:
        return [getattr(self, f"block{i}_w") for i in range(self.n_layers)]

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> logits (B, S, vocab) f32."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = (self.tok_embed.weight.to(self.dtype)[tokens]
             + self.pos_embed.weight.to(self.dtype)[pos][None])
        for block in self.blocks:
            x = block(x)
        x = self.final_norm_w(x, self.dtype)
        return self.lm_head(x).float()


def init_transformer_lm_params(config: dict, seed: int = 0) -> dict:
    """A seeded numpy init of a TransformerLM's parameters in the flax
    layout ({"params": tree}, f32): Dense kernels ~ N(0, 1/fan_in), small
    random biases and norm affines (so every term of the math is live),
    embeddings ~ N(0, 1/d_model)."""
    rng = np.random.default_rng(seed)
    cfg = {**_LM_DEFAULTS, **config}
    d, v, r = cfg["d_model"], cfg["vocab_size"], cfg["mlp_ratio"]

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def dense(n_in, n_out):
        return {"kernel": normal((n_in, n_out), n_in ** -0.5),
                "bias": normal((n_out,), 0.02)}

    def norm():
        return {"scale": 1.0 + normal((d,), 0.05), "bias": normal((d,), 0.02)}

    params = {"tok_embed": {"embedding": normal((v, d), d ** -0.5)},
              "pos_embed": {"embedding": normal((cfg["max_len"], d),
                                                d ** -0.5)}}
    for i in range(cfg["n_layers"]):
        params[f"block{i}_w"] = {
            "LayerNorm_0": norm(), "qkv": dense(d, 3 * d),
            "proj": dense(d, d), "LayerNorm_1": norm(),
            "mlp_up": dense(d, r * d), "mlp_down": dense(r * d, d)}
    params["final_norm_w"] = norm()
    params["lm_head"] = dense(d, v)
    return {"params": params}


_LM_DEFAULTS = {"vocab_size": 256, "d_model": 128, "n_layers": 2,
                "max_len": 2048, "mlp_ratio": 4}

MODEL_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "TransformerLM": TransformerLM,
}


def build_model(name: str, config: Optional[dict] = None,
                device="cuda") -> nn.Module:
    """Construct a registered architecture from its bundle config."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"model '{name}' is not ported; known: "
                       f"{sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**dict(config or {}), device=device)


def model_config(module: nn.Module) -> dict:
    """The JSON-safe constructor config of a registered module (the same
    keys and values as the JAX package's `model_config`)."""
    return dict(module.config)
