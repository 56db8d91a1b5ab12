"""Model definitions in PyTorch: the decoder-only `TransformerLM` (the port
of `mmlspark_tpu/models/definitions.py` :196-357, with a dense or a
mixture-of-experts MLP), the vision and tabular scoring models
(`MLPClassifier`, `LinearModel`, `ConvNetCIFAR10`, `ResNet` with basic or
bottleneck blocks, `resnet50`; :36-195) and the model registry.  The
scoring models' forward returns the output and the named nodes the flax
models sow (`_Scorer`); convolutions, pools and BatchNorm run as torch
ops on channels-last tensors (cuDNN on the card), with flax's "SAME"
padding (`pad_same`).

The module tree keeps the flax names, so a parameter's path reads the same
in both packages: `tok_embed`, `pos_embed`, `block{i}_w.{LayerNorm_0, qkv,
proj, LayerNorm_1, mlp_up, mlp_down}` (a MoE block's `moe.{router, w_in,
w_out}` in place of `mlp_up` / `mlp_down`), `final_norm_w`, `lm_head`.
Traps of the flax definition that the port keeps:

  * LayerNorm eps is 1e-6, statistics in f32 (flax's E[x^2] - E[x]^2
    variance in the forward);
  * gelu is the tanh approximation;
  * a flax Dense kernel is (in, out), a torch Linear weight (out, in)
    (`models/bundle.py::params_from_jax` transposes);
  * every parameter is an f32 master, cast per call as flax does: a Dense
    computes `F.linear(x.to(dtype), w.to(dtype), b.to(dtype))`, embeddings
    are taken from `weight.to(dtype)`, LayerNorm keeps f32 statistics and
    an f32 affine before the cast.  Training updates the f32 masters; the
    serving path casts the Dense weights once (`models/generate.py`).
    An int8-quantized bundle's Dense layers are `Int8Dense` instead (built
    by `ModelBundle.module`): int8 weights, never cast to f32.

`forward` is `module.apply` of the flax model: the parity target for
logits, `naive_generate`'s recompute oracle, and the training forward.
`forward(tokens, collect=True)` also returns what the flax model sows
(`mutable=["losses", "metrics"]`): a MoE block's `moe_aux_loss`,
`moe_z_loss` and `moe_overflow_fraction` (`ops/moe.py`), nested by module
path as flax nests them.  `remat=True` recomputes each block in the
backward (`torch.utils.checkpoint`), which changes memory only: policy
"full" recomputes all of it; "save_attention" runs the block under a
selective-checkpoint policy that keeps the flash operator's (out, lse)
(`ops/flash_attention.py` `flash_attention_op`) and, for the other
attention impls, the attention output (`attention_output`), so the
backward recomputes the dense ops but never re-launches the attention
kernel.

Sequence parallelism: with `attn_impl` ring | ring_flash | ulysses and
`seq_axis` ("seq"), the attention of every block runs sequence-sharded
over the mesh of the enclosing `parallel.ring.use_seq_mesh` block (batch
over 'data', sequence over 'seq'; `seq_parallel_attention`), as the JAX
model runs under `shard_map`.  The token-wise layers (embeddings, norms,
Dense layers, the MLP, the head) run unsharded on the device of the
tokens, the mesh's first device, as the port's seq decode engine runs
them: positions are then the global ones by construction, and only the
attention's K/V (and its gradients) move between shards.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedParameter, is_lazy
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.ops.attention import attention
from mmlspark_tpu_torch.ops.flash_attention import flash_attention
from mmlspark_tpu_torch.ops.moe import MoEMLP
from mmlspark_tpu_torch.parallel.ring import (active_seq_mesh,
                                              seq_parallel_attention,
                                              use_seq_mesh)
from mmlspark_tpu_torch.quant.modules import (quant_conv_apply,
                                              quant_dense_apply)

ATTN_IMPLS = ("dense", "flash", "ring", "ring_flash", "ulysses")
SEQ_IMPLS = ("ring", "ring_flash", "ulysses")
MLP_IMPLS = ("dense", "moe")
REMAT_POLICIES = ("full", "save_attention")

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


class Dense(nn.Linear):
    """flax `nn.Dense(dtype=dtype)`: an f32 weight (out, in) and bias,
    cast to the compute dtype on every call.  `n_in=None` leaves the
    weight uninitialized until the first call or a state_dict sets its
    shape, as flax infers a Dense layer's inputs from the data."""

    def __init__(self, n_in: Optional[int], n_out: int, dtype: torch.dtype,
                 device=None):
        super().__init__(n_in or 1, n_out, device=device)
        self.compute_dtype = dtype
        if n_in is None:
            self.weight = UninitializedParameter(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_lazy(self.weight):
            self.weight.materialize((self.out_features, x.shape[-1]))
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Int8Dense(nn.Module):
    """A Dense layer of an int8-quantized bundle (`quant/quantize.py`):
    the int8 weight (out, in), its f32 per-output-channel `scale` and the
    bias as stored (bfloat16 in a quantized bundle), all buffers.  The
    forward is `quant/modules.py` `quant_dense_apply`: the product in the
    compute dtype, rounded there, then the scale and the bias in f32, then
    the cast."""

    def __init__(self, n_in: int, n_out: int, dtype: torch.dtype,
                 bias_dtype=torch.float32, device=None):
        super().__init__()
        self.in_features, self.out_features = n_in, n_out
        self.compute_dtype = dtype
        self.register_buffer("weight", torch.zeros(
            (n_out, n_in), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.zeros(n_out, device=device))
        self.register_buffer("bias", torch.zeros(n_out, dtype=bias_dtype,
                                                 device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return quant_dense_apply(x, self.weight, self.scale, self.bias,
                                 self.compute_dtype)


@torch.library.custom_op("mmlspark::attention_output", mutates_args=())
def attention_output(o: torch.Tensor) -> torch.Tensor:
    """An identity operator (a copy) that names a block's attention
    output, the flax `checkpoint_name(o, "attn_out")`, so that the
    "save_attention" policy keeps it."""
    return o.clone()


@attention_output.register_fake
def _attention_output_fake(o):
    return torch.empty_like(o)


attention_output.register_autograd(lambda ctx, g: g)


@functools.cache
def _saved_by_policy() -> tuple:
    return (torch.ops.mmlspark.flash_attention_lse.default,
            torch.ops.mmlspark.attention_output.default)


def _save_attention_policy(ctx, op, *args, **kwargs):
    """Keep the attention operators' outputs, recompute every other op."""
    if op in _saved_by_policy():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_attention_contexts():
    return create_selective_checkpoint_contexts(_save_attention_policy)


class TransformerBlock(nn.Module):
    """Pre-norm decoder block: attention then a dense GELU MLP, or with
    `mlp_impl="moe"` the mixture-of-experts MLP (`ops/moe.py`, submodule
    `moe`).  `forward(x)` returns (x, sown): the MoE's sown values
    ({} for a dense block).  `name_attention` passes the attention output
    of a non-flash impl through `attention_output` (the save_attention
    remat policy keeps it)."""

    def __init__(self, d_model: int, n_heads: int, mlp_ratio: int = 4,
                 dtype=torch.bfloat16, attn_impl: str = "dense",
                 seq_axis: Optional[str] = None, mlp_impl: str = "dense",
                 n_experts: int = 8, moe_router_k: int = 1,
                 moe_group_size: int = 512, name_attention: bool = False,
                 device=None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl '{attn_impl}' "
                             f"({' | '.join(ATTN_IMPLS)})")
        if mlp_impl not in MLP_IMPLS:
            raise ValueError(f"unknown mlp_impl '{mlp_impl}' "
                             f"({' | '.join(MLP_IMPLS)})")
        self.d_model, self.n_heads = d_model, n_heads
        self.dtype = dtype_of(dtype)
        self.attn_impl = attn_impl
        self.seq_axis = seq_axis
        self.mlp_impl = mlp_impl
        self.name_attention = name_attention and attn_impl != "flash"
        kw = dict(dtype=self.dtype, device=device)
        self.LayerNorm_0 = LayerNorm(d_model, device=device)
        self.qkv = Dense(d_model, 3 * d_model, **kw)
        self.proj = Dense(d_model, d_model, **kw)
        self.LayerNorm_1 = LayerNorm(d_model, device=device)
        if mlp_impl == "moe":
            self.moe = MoEMLP(d_model, n_experts=n_experts,
                              mlp_ratio=mlp_ratio, dtype=self.dtype,
                              group_size=moe_group_size,
                              router_k=moe_router_k, device=device)
        else:
            self.mlp_up = Dense(d_model, mlp_ratio * d_model, **kw)
            self.mlp_down = Dense(mlp_ratio * d_model, d_model, **kw)

    def forward(self, x: torch.Tensor) -> tuple:
        b, s, _ = x.shape
        h = self.LayerNorm_0(x, self.dtype)
        qkv = self.qkv(h)
        shape = (b, s, self.n_heads, self.d_model // self.n_heads)
        q, k, v = (t.reshape(shape) for t in qkv.split(self.d_model, -1))
        if self.attn_impl in SEQ_IMPLS:
            o = self._seq_attention(q, k, v)
        elif self.attn_impl == "flash":
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
        else:
            o = attention(q, k, v, causal=True)
        if self.name_attention and torch.is_grad_enabled():
            o = attention_output(o)
        x = x + self.proj(o.reshape(b, s, self.d_model))
        h = self.LayerNorm_1(x, self.dtype)
        if self.mlp_impl == "moe":
            y, sown = self.moe(h)
            return x + y, {"moe": sown}
        h = F.gelu(self.mlp_up(h), approximate="tanh")
        return x + self.mlp_down(h), {}

    def _seq_attention(self, q, k, v) -> torch.Tensor:
        mesh = active_seq_mesh()
        if mesh is None:
            raise ValueError(
                f"attn_impl '{self.attn_impl}' with seq_axis "
                f"'{self.seq_axis}' runs over a mesh: call the model inside "
                "parallel.ring.use_seq_mesh(mesh) (make_seq_parallel_lm_step "
                "does)")
        if self.seq_axis not in mesh.shape:
            raise ValueError(f"seq_axis '{self.seq_axis}' is not an axis of "
                             f"the mesh {mesh.shape}")
        return seq_parallel_attention(mesh, q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=True,
                                      impl=self.attn_impl)


def _block_in_mesh(block: nn.Module, mesh, x: torch.Tensor) -> tuple:
    """`block(x)` inside `mesh`'s `use_seq_mesh` block: a rematerialized
    block recomputes in the backward, outside the caller's block."""
    with use_seq_mesh(mesh):
        return block(x)


def _by_collection(sown: dict) -> dict:
    """{block name: {"moe": {"losses": ..., "metrics": ...}}} -> flax's
    {"losses": {block: {"moe": {...}}}, "metrics": {...}}."""
    out: dict = {}
    for block, mods in sown.items():
        for mod, cols in mods.items():
            for col, values in cols.items():
                out.setdefault(col, {}).setdefault(block, {})[mod] = values
    return out


class TransformerLM(nn.Module):
    """Decoder-only language model with a dense or mixture-of-experts MLP.

    Takes the flax model's constructor fields, so a bundle config from
    either package builds it; `expert_axis` (expert parallelism) must keep
    its default (ROADMAP A10).  `attn_impl` ring | ring_flash | ulysses
    need `seq_axis` (module docstring).  `remat=True` recomputes each
    block in the backward, under `remat_policy` "full" or
    "save_attention" (module docstring)."""

    def __init__(self, vocab_size: int = 256, d_model: int = 128,
                 n_heads: int = 8, n_layers: int = 2, max_len: int = 2048,
                 mlp_ratio: int = 4, dtype="bfloat16",
                 attn_impl: str = "dense", seq_axis: Optional[str] = None,
                 mlp_impl: str = "dense", n_experts: int = 8,
                 expert_axis: Optional[str] = None, moe_router_k: int = 1,
                 moe_group_size: int = 512, remat: bool = False,
                 remat_policy: str = "full", device="cuda"):
        super().__init__()
        if expert_axis is not None:
            raise NotImplementedError(
                "the expert-sharded TransformerLM is not ported (ROADMAP "
                "A10)")
        if (attn_impl in SEQ_IMPLS) != (seq_axis is not None):
            raise ValueError(
                f"attn_impl '{attn_impl}' with seq_axis {seq_axis!r}: the "
                f"sequence-sharded impls {SEQ_IMPLS} take a seq_axis, the "
                "others none")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy '{remat_policy}' "
                             "(full | save_attention)")
        device = resolve_device(device)
        self.dtype = dtype_of(dtype)
        self.remat = remat
        self.remat_policy = remat_policy
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
        self.mlp_impl = mlp_impl
        self.tok_embed = nn.Embedding(vocab_size, d_model, device=device)
        self.pos_embed = nn.Embedding(max_len, d_model, device=device)
        for i in range(n_layers):
            self.add_module(f"block{i}_w", TransformerBlock(
                d_model, n_heads, mlp_ratio, self.dtype, attn_impl,
                seq_axis, mlp_impl, n_experts, moe_router_k, moe_group_size,
                name_attention=remat and remat_policy == "save_attention",
                device=device))
        self.final_norm_w = LayerNorm(d_model, device=device)
        self.lm_head = Dense(d_model, vocab_size, self.dtype, device=device)

    @property
    def blocks(self) -> list:
        return [getattr(self, f"block{i}_w") for i in range(self.n_layers)]

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, tokens: torch.Tensor, collect: bool = False):
        """tokens (B, S) int -> logits (B, S, vocab) f32; with `collect`,
        (logits, sown) where sown is flax's {"losses": ..., "metrics":
        ...} of the MoE blocks ({} for a dense model)."""
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = (self.tok_embed.weight.to(self.dtype)[tokens]
             + self.pos_embed.weight.to(self.dtype)[pos][None])
        mesh = active_seq_mesh()
        sown = {}
        context = (_save_attention_contexts
                   if self.remat_policy == "save_attention" else None)
        for i, block in enumerate(self.blocks):
            if self.remat and torch.is_grad_enabled():
                kw = {} if context is None else {"context_fn": context}
                x, block_sown = checkpoint(_block_in_mesh, block, mesh, x,
                                           use_reentrant=False, **kw)
            else:
                x, block_sown = block(x)
            if block_sown:
                sown[f"block{i}_w"] = block_sown
        x = self.final_norm_w(x, self.dtype)
        logits = self.lm_head(x).float()
        return (logits, _by_collection(sown)) if collect else logits


def init_transformer_lm_params(config: dict, seed: int = 0) -> dict:
    """A seeded numpy init of a TransformerLM's parameters in the flax
    layout ({"params": tree}, f32): Dense kernels ~ N(0, 1/fan_in), small
    random biases and norm affines (so every term of the math is live),
    embeddings ~ N(0, 1/d_model); a MoE block's router a Dense layer and
    its expert stacks w_in (E, D, H) ~ N(0, 1/D), w_out (E, H, D) ~ N(0,
    1/H)."""
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
    moe = cfg.get("mlp_impl", "dense") == "moe"
    e = cfg.get("n_experts", 8)
    for i in range(cfg["n_layers"]):
        block = params[f"block{i}_w"] = {
            "LayerNorm_0": norm(), "qkv": dense(d, 3 * d),
            "proj": dense(d, d), "LayerNorm_1": norm()}
        if moe:
            block["moe"] = {"router": dense(d, e),
                            "w_in": normal((e, d, r * d), d ** -0.5),
                            "w_out": normal((e, r * d, d), (r * d) ** -0.5)}
        else:
            block["mlp_up"] = dense(d, r * d)
            block["mlp_down"] = dense(r * d, d)
    params["final_norm_w"] = norm()
    params["lm_head"] = dense(d, v)
    return {"params": params}


# --------------------------------------------------------------------------
# vision and tabular scoring models (`mmlspark_tpu/models/definitions.py`
# :36-195)
# --------------------------------------------------------------------------

BN_EPS = 1e-5
BN_MOMENTUM = 0.99


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: ceil(size / stride)
    outputs, the total pad split with the odd one after (a 7x7 stride-2
    conv on 32 pads 2 before and 3 after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: tuple, stride: tuple,
             value: float = 0.0) -> tuple[torch.Tensor, tuple]:
    """`x` (N, C, H, W) and the symmetric padding for a "SAME" window:
    a symmetric pad is left to the conv / pool, an asymmetric one is
    applied here with `value`."""
    ph = same_pads(x.shape[2], kernel[0], stride[0])
    pw = same_pads(x.shape[3], kernel[1], stride[1])
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """An (N, C, H, W) activation as the flax model's (N, H, W, C): a
    view, contiguous for a channels-last tensor."""
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """flax `nn.Conv(features, kernel, strides, padding="SAME",
    dtype=dtype)`: an f32 weight (out, in, kh, kw) in channels-last
    memory and an optional bias, cast to the compute dtype on every call.
    Activations are (N, C, H, W) tensors in channels-last memory, so cuDNN
    runs its NHWC kernels with no transpose.  `n_in=None` infers the
    input channels, as `Dense` does."""

    def __init__(self, n_in: Optional[int], n_out: int, kernel: tuple,
                 strides: tuple = (1, 1), use_bias: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.out_features, self.kernel, self.strides = n_out, kernel, strides
        self.compute_dtype = dtype
        self.weight = (UninitializedParameter(device=device) if n_in is None
                       else nn.Parameter(torch.zeros(
                           (n_out, n_in, *kernel), device=device
                       ).contiguous(memory_format=torch.channels_last)))
        self.bias = (nn.Parameter(torch.zeros(n_out, device=device))
                     if use_bias else None)
        self.register_load_state_dict_post_hook(Conv._channels_last)

    @staticmethod
    def _channels_last(module, _keys) -> None:
        module.weight.data = module.weight.data.contiguous(
            memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_lazy(self.weight):
            self.weight.materialize((self.out_features, x.shape[1],
                                     *self.kernel))
        dt = self.compute_dtype
        x, padding = pad_same(x, self.kernel, self.strides)
        # a member's weight under torch.func.vmap (the population sweep)
        # has no memory format of its own to ask for
        wrapped = torch._C._functorch.is_functorch_wrapped_tensor(self.weight)
        w = (self.weight.to(dt) if wrapped else
             self.weight.to(dt, memory_format=torch.channels_last))
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), w, b, self.strides, padding)


class Int8Conv(nn.Module):
    """A Conv layer of an int8-quantized bundle: the int8 weight (out, in,
    kh, kw), its f32 per-output-channel `scale` and the optional bias as
    stored, all buffers; the forward is `quant/modules.py`
    `quant_conv_apply` over the same "SAME" padding as `Conv`."""

    def __init__(self, n_in: int, n_out: int, kernel: tuple,
                 strides: tuple, dtype: torch.dtype, bias_dtype=None,
                 device=None):
        super().__init__()
        self.out_features, self.kernel, self.strides = n_out, kernel, strides
        self.compute_dtype = dtype
        self.register_buffer("weight", torch.zeros(
            (n_out, n_in, *kernel), dtype=torch.int8, device=device))
        self.register_buffer("scale", torch.zeros(n_out, device=device))
        self.register_buffer("bias", None if bias_dtype is None else
                             torch.zeros(n_out, dtype=bias_dtype,
                                         device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = pad_same(x, self.kernel, self.strides)
        return quant_conv_apply(x, self.weight, self.scale, self.bias,
                                self.strides, padding, self.compute_dtype)


_STATS_SINK: list = []


@contextlib.contextmanager
def functional_batch_stats():
    """Within the block a training BatchNorm leaves its buffers alone and
    puts its moved (mean, var) into the yielded dict, keyed by module."""
    sink: dict = {}
    _STATS_SINK.append(sink)
    try:
        yield sink
    finally:
        _STATS_SINK.pop()


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(use_running_average=not train, dtype=dtype)`:
    `scale` and `bias` (flax params) and `mean` and `var` (flax
    batch_stats, here buffers), eps 1e-5, momentum 0.99.  `zero_scale`
    marks the layer whose scale flax initialises to zero (the last of a
    bottleneck block).  The module's `training` flag is flax's `train`.

    In inference the math is flax's: (x - mean) * rsqrt(var + eps) * scale
    + bias in f32, cast to the compute dtype (one `F.batch_norm`, which
    takes bf16 activations with f32 statistics).

    In training the statistics are the batch's, over (N, H, W) in f32,
    with flax's fast biased variance max(0, E[x^2] - E[x]^2); the output
    is (x - mean) * (rsqrt(var + eps) * scale) + bias in f32, cast to the
    compute dtype, and the buffers move in place to 0.99 * buffer + (1 -
    0.99) * batch statistic, the variance biased as flax keeps it
    (`F.batch_norm(training=True)` would update with the unbiased one).
    Inside `functional_batch_stats()` the buffers stay as they are and
    the new statistics go to the block's dict instead (a functional form,
    for `torch.func.vmap`, under which the in-place update cannot run)."""

    def __init__(self, features: int, dtype=torch.bfloat16,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            x = x.to(self.compute_dtype)
            return F.batch_norm(x, self.mean.float(), self.var.float(),
                                self.scale.float(), self.bias.float(),
                                training=False, eps=BN_EPS)
        # over the (N, H, W, C) view, contiguous for a channels-last
        # activation: every per-channel broadcast then runs along the
        # innermost axis (vectorized kernels on the card)
        xf = nhwc(x).float()
        dims = (0, 1, 2)
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        sink = _STATS_SINK[-1] if _STATS_SINK else None
        with torch.no_grad():
            moved = [BN_MOMENTUM * buf + (1 - BN_MOMENTUM) * stat
                     for buf, stat in ((self.mean, mean), (self.var, var))]
            if sink is not None:
                sink[self] = moved
            else:
                self.mean.copy_(moved[0])
                self.var.copy_(moved[1])
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        y = (xf - mean) * mul + self.bias
        return y.to(self.compute_dtype).permute(0, 3, 1, 2)


class _Scorer(nn.Module):
    """Base of the scoring models: `forward(x)` returns the final output
    and the sown nodes (name -> tensor, in the flax model's call order;
    conv and pool nodes (N, H, W, C)), as flax's `module.apply(...,
    mutable=["intermediates"])` does."""

    def __init__(self, config: dict, device):
        super().__init__()
        self.dtype = dtype_of(config["dtype"])
        self.config = {**config, "dtype": dtype_name(self.dtype)}
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self.out.bias.device


class MLPClassifier(_Scorer):
    """Dense + ReLU layers (nodes h0, h1, ...) and the logits node z."""

    def __init__(self, hidden_sizes=(100,), num_classes: int = 2,
                 dtype="bfloat16", device="cuda"):
        super().__init__(dict(hidden_sizes=list(hidden_sizes),
                              num_classes=num_classes, dtype=dtype), device)
        n_in = None
        for i, h in enumerate(hidden_sizes):
            self.add_module(f"dense{i}", Dense(n_in, h, self.dtype,
                                               device=self._device))
            n_in = h
        self.out = Dense(n_in, num_classes, self.dtype, device=self._device)
        self.n_hidden = len(hidden_sizes)

    def forward(self, x: torch.Tensor) -> tuple:
        nodes = {}
        x = x.to(self.dtype)
        for i in range(self.n_hidden):
            x = nodes[f"h{i}"] = F.relu(getattr(self, f"dense{i}")(x))
        z = nodes["z"] = self.out(x).float()
        return z, nodes


class LinearModel(_Scorer):
    """One Dense head, node z."""

    def __init__(self, num_outputs: int = 1, dtype="float32",
                 device="cuda"):
        super().__init__(dict(num_outputs=num_outputs, dtype=dtype), device)
        self.out = Dense(None, num_outputs, self.dtype, device=self._device)

    def forward(self, x: torch.Tensor) -> tuple:
        z = self.out(x.to(self.dtype)).float()
        return z, {"z": z}


class ConvNetCIFAR10(_Scorer):
    """3 x (3x3 SAME conv + ReLU, 2x2 max pool) then two Dense layers over
    (N, 32, 32, 3) images: nodes conv1, pool1, ..., pool3, dense1, z.
    The flatten is in (H, W, C) order, as flax's reshape of NHWC, so
    `dense1_w`'s rows need no permutation."""

    def __init__(self, num_classes: int = 10, widths=(64, 128, 256),
                 dense_width: int = 512, dtype="bfloat16", device="cuda"):
        super().__init__(dict(num_classes=num_classes, widths=list(widths),
                              dense_width=dense_width, dtype=dtype), device)
        n_in = None
        for i, w in enumerate(widths, start=1):
            self.add_module(f"conv{i}_w", Conv(n_in, w, (3, 3),
                                               dtype=self.dtype,
                                               device=self._device))
            n_in = w
        self.n_convs = len(widths)
        self.dense1_w = Dense(None, dense_width, self.dtype,
                              device=self._device)
        self.out = Dense(dense_width, num_classes, self.dtype,
                         device=self._device)

    def forward(self, x: torch.Tensor) -> tuple:
        nodes = {}
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        for i in range(1, self.n_convs + 1):
            x = F.relu(getattr(self, f"conv{i}_w")(x))
            nodes[f"conv{i}"] = nhwc(x)
            x = F.max_pool2d(x, 2, 2)
            nodes[f"pool{i}"] = nhwc(x)
        x = nhwc(x).reshape(x.shape[0], -1)
        x = nodes["dense1"] = F.relu(self.dense1_w(x))
        z = nodes["z"] = self.out(x).float()
        return z, nodes


class ResNetBlock(nn.Module):
    """Basic block: 3x3 (strides) -> BN -> ReLU -> 3x3 -> BN, plus the
    input or, where the shape changes, a 1x1 (strides) projection + BN."""

    def __init__(self, n_in: int, filters: int, strides=(1, 1),
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(n_in, filters, (3, 3), strides, False, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, (3, 3), (1, 1), False, **kw)
        self.BatchNorm_1 = BatchNorm(filters, **kw)
        self.project = tuple(strides) != (1, 1) or n_in != filters
        if self.project:
            self.Conv_2 = Conv(n_in, filters, (1, 1), strides, False, **kw)
            self.BatchNorm_2 = BatchNorm(filters, **kw)
        self.n_out = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        if self.project:
            x = self.BatchNorm_2(self.Conv_2(x))
        return F.relu(y + x)


class ResNetBottleneckBlock(nn.Module):
    """1x1 reduce -> 3x3 (strides) -> 1x1 expand (x4), each with BN (the
    last one's scale zero-initialised), plus the input or a 1x1 (strides)
    projection + BN (`Conv_3` / `BatchNorm_3`)."""

    def __init__(self, n_in: int, filters: int, strides=(1, 1),
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        out = 4 * filters
        self.Conv_0 = Conv(n_in, filters, (1, 1), (1, 1), False, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, False, **kw)
        self.BatchNorm_1 = BatchNorm(filters, **kw)
        self.Conv_2 = Conv(filters, out, (1, 1), (1, 1), False, **kw)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True, **kw)
        self.project = tuple(strides) != (1, 1) or n_in != out
        if self.project:
            self.Conv_3 = Conv(n_in, out, (1, 1), strides, False, **kw)
            self.BatchNorm_3 = BatchNorm(out, **kw)
        self.n_out = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.project:
            x = self.BatchNorm_3(self.Conv_3(x))
        return F.relu(y + x)


class ResNet(_Scorer):
    """ResNet over (N, H, W, C) images: a 7x7 stride-2 stem conv + BN +
    ReLU (node stem), a 3x3 stride-2 SAME max pool (-inf padding), stages
    of basic or bottleneck blocks (nodes stage1..stageN; the first block
    of every stage after the first strides 2), the global average pool
    (node pool, f32) and the logits (node z).  Blocks keep flax's
    auto-names, `ResNetBlock_k` / `ResNetBottleneckBlock_k` numbered over
    all stages.  The module's `training` flag is flax's `train`: in
    `train()` mode every BatchNorm normalizes with the batch's statistics
    and updates its buffers (`BatchNorm`)."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), widths=(64, 128, 256, 512),
                 num_classes: int = 1000, block_kind: str = "basic",
                 dtype="bfloat16", device="cuda"):
        super().__init__(dict(stage_sizes=list(stage_sizes),
                              widths=list(widths), num_classes=num_classes,
                              block_kind=block_kind, dtype=dtype), device)
        blocks = {"basic": ResNetBlock, "bottleneck": ResNetBottleneckBlock}
        if block_kind not in blocks:
            raise KeyError(block_kind)
        block_cls = blocks[block_kind]
        kw = dict(dtype=self.dtype, device=self._device)
        self.stem_conv = Conv(None, 64, (7, 7), (2, 2), False, **kw)
        self.BatchNorm_0 = BatchNorm(64, **kw)
        self.stages: list[list[str]] = []
        n_in, k = 64, 0
        for i, (n_blocks, w) in enumerate(zip(stage_sizes, widths), 1):
            names = []
            for b in range(n_blocks):
                strides = (2, 2) if b == 0 and i > 1 else (1, 1)
                name = f"{block_cls.__name__}_{k}"
                block = block_cls(n_in, w, strides, **kw)
                self.add_module(name, block)
                names.append(name)
                n_in, k = block.n_out, k + 1
            self.stages.append(names)
        self.out = Dense(n_in, num_classes, self.dtype, device=self._device)

    def forward(self, x: torch.Tensor) -> tuple:
        nodes = {}
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.BatchNorm_0(self.stem_conv(x)))
        nodes["stem"] = nhwc(x)
        x, padding = pad_same(x, (3, 3), (2, 2), value=float("-inf"))
        x = F.max_pool2d(x, 3, 2, padding)
        for i, names in enumerate(self.stages, 1):
            for name in names:
                x = getattr(self, name)(x)
            nodes[f"stage{i}"] = nhwc(x)
        # jnp.mean of bf16 accumulates in f32 and returns bf16
        pool = x.mean((2, 3), dtype=torch.float32).to(self.dtype).float()
        nodes["pool"] = pool
        z = nodes["z"] = self.out(pool).float()
        return z, nodes


def resnet50(num_classes: int = 1000, dtype="bfloat16",
             device="cuda") -> ResNet:
    """ResNet-50: bottleneck stages (3, 4, 6, 3) of widths 64-512 (pool
    node 2048 wide)."""
    return ResNet(stage_sizes=(3, 4, 6, 3), widths=(64, 128, 256, 512),
                  num_classes=num_classes, block_kind="bottleneck",
                  dtype=dtype, device=device)


def init_scoring_params(module: nn.Module, input_shape: tuple,
                        seed: int = 0) -> dict:
    """Seeded numpy variables of a scoring model in the flax layout
    ({"params": ..., "batch_stats": ...}), matched to flax's initialisers
    in distribution: kernels lecun-normal (truncated normal, variance
    1/fan_in), biases 0, BatchNorm scale 1 (0 where flax zero-initialises
    it), bias 0, mean 0, var 1.  A forward over zeros of `input_shape`
    first sets the shapes inferred from the input, as flax's init does
    (in eval mode: the init moves no BatchNorm statistics)."""
    from mmlspark_tpu_torch.models.bundle import variables_to_jax
    training = module.training
    try:
        with torch.no_grad():
            module.eval()(torch.zeros(input_shape, device=module.device))
    finally:
        module.train(training)
    rng = np.random.default_rng(seed)
    state = {}
    for prefix, mod in module.named_modules():
        if isinstance(mod, (Dense, Conv)):
            w = mod.weight
            fan_in = int(np.prod(w.shape[1:]))
            draw = rng.standard_normal(tuple(w.shape), dtype=np.float32)
            while (bad := np.abs(draw) > 2).any():
                draw[bad] = rng.standard_normal(int(bad.sum()),
                                                dtype=np.float32)
            # 0.8796...: the std of a standard normal truncated to [-2, 2]
            std = np.float32(fan_in ** -0.5 / .87962566103423978)
            state[f"{prefix}.weight"] = torch.from_numpy(draw * std)
            if mod.bias is not None:
                state[f"{prefix}.bias"] = torch.zeros(w.shape[0])
        elif isinstance(mod, BatchNorm):
            n = mod.scale.shape[0]
            state[f"{prefix}.scale"] = (torch.zeros(n) if mod.zero_scale
                                        else torch.ones(n))
            state[f"{prefix}.bias"] = torch.zeros(n)
            state[f"{prefix}.mean"] = torch.zeros(n)
            state[f"{prefix}.var"] = torch.ones(n)
    return variables_to_jax(state)


_LM_DEFAULTS = {"vocab_size": 256, "d_model": 128, "n_layers": 2,
                "max_len": 2048, "mlp_ratio": 4}

MODEL_REGISTRY: dict[str, Callable[..., nn.Module]] = {
    "MLPClassifier": MLPClassifier,
    "LinearModel": LinearModel,
    "ConvNetCIFAR10": ConvNetCIFAR10,
    "ResNet": ResNet,
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
