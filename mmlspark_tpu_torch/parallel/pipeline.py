"""GPipe over the mesh's model axis: the port of
`mmlspark_tpu/parallel/pipeline.py` (`init_pipelined_lm` :42-62, `_embed`
:65-67, `_head` :70-78, `_apply_stage` :81-95, `_pipeline_blocks`
:98-133, `pipelined_lm_apply` :136-155, `sequential_lm_apply` :158-166,
`pipeline_param_shardings` :169-176, `make_pipeline_lm_step` :179-201,
`count_pipeline_bubble` :204-206, the bundle converters :214-252).

The transformer block stack is cut into stages, one a device of a data
row's model group (the stage axis is 'model'): stage s holds layers
[s L/S, (s+1) L/S) and runs them on its own device.

  * **The tree.**  The port's pipeline parameters are a flat dict of
    named tensors, f32: `tok_embed` (V, D), `pos_embed` (max_len, D),
    `blocks.<leaf>` for every parameter of a dense `TransformerBlock`
    stacked on a leading layer dim in the port's layout (a Dense weight
    (L, out, in)), `norm_scale`, `norm_bias`, `head` (D, V) and
    `head_bias`.  `models/bundle.py` `params_from_jax` / `params_to_jax`
    carry it to and from the JAX package's stacked tree.
  * **Placement** (`pipeline_param_shardings`, `place_pipeline_params`):
    each stacked block leaf is split on its layer dim over data row 0's
    stages (a `ModelShards` of dim 0), the embeddings sit on the first
    stage's device and the final norm and head on the last's, where they
    are used.  Another data row runs over its own model group with `.to`
    copies of them, whose gradients autograd sums back.
  * **The schedule** (`_pipeline_blocks`): the batch is cut into M
    microbatches and run over M + S - 1 ticks; at tick t stage s applies
    its layers to microbatch t - s on its own device, the activation
    moves to stage s + 1's device with `.to`, and the last stage banks
    the outputs.  Autograd gives the reverse pipeline, as XLA transposes
    the JAX scan's `ppermute`.  The JAX scan also computes stale
    microbatches in the bubble and throws them away; the port skips those
    ticks' work, which changes no result.  `_apply_stage.applications`
    counts stage applications (M x S a forward).
  * **The head** runs in f32 with its own LayerNorm (two-pass variance,
    eps 1e-6), not `TransformerLM`'s; the blocks compute in the model
    dtype with their f32 masters cast per call, as the port's
    `TransformerBlock` does.  With `remat` each layer is recomputed in the
    backward (`torch.utils.checkpoint`, as `jax.checkpoint` wraps each
    scan step).

The init (`init_pipelined_lm`) is the port's seeded numpy init of a
`TransformerLM` stacked into the tree (`init_transformer_lm_params`), not
the JAX `jax.random` draw: parity tests carry the JAX tree across.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from mmlspark_tpu_torch.models.bundle import params_from_jax, params_to_jax
from mmlspark_tpu_torch.models.definitions import (TransformerBlock,
                                                   dtype_of,
                                                   init_transformer_lm_params)
from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                              model_group)
from mmlspark_tpu_torch.parallel.partition import (ModelShards, join_slices,
                                                   place, take_slice)
from mmlspark_tpu_torch.parallel.ring import reduce_to_home

HEAD_EPS = 1e-6
EMBED_LEAVES = ("tok_embed", "pos_embed")
BLOCKS = "blocks."


def init_pipelined_lm(seed: int = 0, *, vocab_size: int, d_model: int,
                      n_heads: int, n_layers: int, max_len: int,
                      mlp_ratio: int = 4, dtype=torch.float32) -> dict:
    """The pipeline's tree (module docstring) from the port's seeded
    numpy init of the same `TransformerLM`, host f32 tensors.  `dtype` is
    the compute dtype of the blocks; the tree is f32 either way."""
    dtype_of(dtype)
    variables = init_transformer_lm_params(
        dict(vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
             n_layers=n_layers, max_len=max_len, mlp_ratio=mlp_ratio), seed)
    return pipeline_params_from_variables(variables, n_layers)


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok_embed"][tokens] + params["pos_embed"][:tokens.shape[1]]


def _head(params: dict, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + HEAD_EPS)
    x = x * params["norm_scale"] + params["norm_bias"]
    z = x @ params["head"]
    if "head_bias" in params:
        z = z + params["head_bias"]
    return z


def _layer(block: TransformerBlock, x: torch.Tensor, names: tuple,
           *leaves) -> torch.Tensor:
    return functional_call(block, dict(zip(names, leaves)), (x,))[0]


def _apply_stage(block: TransformerBlock, local_blocks: dict,
                 x: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """This stage's stacked layers `local_blocks` ({block leaf: (L_s,
    ...)}) applied in order, each as `block` with that layer's leaves;
    with `remat` each layer recomputed in the backward."""
    _apply_stage.applications += 1
    names = tuple(local_blocks)
    stacks = [local_blocks[n] for n in names]
    for j in range(stacks[0].shape[0]):
        leaves = [t[j] for t in stacks]
        if remat and torch.is_grad_enabled():
            x = checkpoint(_layer, block, x, names, *leaves,
                           use_reentrant=False)
        else:
            x = _layer(block, x, names, *leaves)
    return x


_apply_stage.applications = 0


def _pipeline_blocks(block: TransformerBlock, stages: Sequence[dict],
                     x: torch.Tensor, devices: Sequence, n_micro: int,
                     remat: bool = False) -> torch.Tensor:
    """The GPipe schedule (module docstring): `stages[s]` is stage s's
    layers on `devices[s]`, `x` the embedded batch on the first stage's
    device; returns the last stage's outputs in batch order."""
    n_stages = len(stages)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} must divide into n_micro={n_micro}")
    xs = x.split(b // n_micro)
    outs: list = [None] * n_micro
    inbox: list = [None] * n_stages
    for t in range(n_micro + n_stages - 1):
        nxt: list = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue    # a bubble tick: nothing of this stage's
            y = _apply_stage(block, stages[s], xs[m] if s == 0 else inbox[s],
                             remat)
            if s == n_stages - 1:
                outs[m] = y
            else:
                nxt[s + 1] = y.to(devices[s + 1])
        inbox = nxt
    return torch.cat(outs)


def stage_devices(mesh, row: int = 0, stage_axis: str = MODEL_AXIS) -> list:
    """Data row `row`'s stages: its model group, stage 0 first."""
    if stage_axis != MODEL_AXIS:
        raise ValueError(f"the stage axis is '{MODEL_AXIS}', got "
                         f"{stage_axis!r}")
    return model_group(mesh, row)


def pipeline_param_shardings(mesh, params: dict,
                             stage_axis: str = MODEL_AXIS) -> dict:
    """Where each leaf lives: {name: a list of stage devices (a stacked
    block leaf, split on its layer dim) or one device}: the embeddings on
    data row 0's first stage, the final norm and head on its last."""
    stages = stage_devices(mesh, 0, stage_axis)
    return {name: stages if name.startswith(BLOCKS)
            else stages[0] if name in EMBED_LEAVES else stages[-1]
            for name in params}


def _full(leaf) -> torch.Tensor:
    """A leaf whole: a `ModelShards` joined on its first part's device."""
    if isinstance(leaf, ModelShards):
        return join_slices([t.to(leaf.device) for t in leaf], leaf.dim)
    return torch.as_tensor(leaf)


def place_pipeline_params(params: dict, shardings: dict) -> dict:
    """`params` (host or placed) on the placements `shardings` names; a
    stacked block leaf becomes the `ModelShards` of its stages' layers,
    f32."""
    out = {}
    for name, where in shardings.items():
        full = _full(params[name]).detach().float()
        if isinstance(where, (list, tuple)):
            if full.shape[0] % len(where):
                raise ValueError(
                    f"n_layers={full.shape[0]} must divide evenly into "
                    f"pipeline_stages={len(where)} stages")
            out[name] = place(full, list(where), 0)
        else:
            out[name] = full.to(where)
    return out


def pipeline_leaves(params: dict) -> list:
    """The placed tree's tensors in a fixed order (each stage's part of a
    block leaf its own tensor): what an optimizer updates."""
    out: list = []
    for leaf in params.values():
        out += list(leaf) if isinstance(leaf, ModelShards) else [leaf]
    return out


def joined_leaves(params: dict, tensors: Sequence) -> dict:
    """{name: whole tensor} of `tensors` laid out as `pipeline_leaves`
    lays out `params` (a gradient or an optimizer moment of each part),
    each stage's parts joined on its first part's device."""
    out, at = {}, 0
    for name, leaf in params.items():
        if isinstance(leaf, ModelShards):
            parts = list(tensors[at:at + len(leaf)])
            at += len(leaf)
            out[name] = torch.cat([t.to(parts[0].device) for t in parts])
        else:
            out[name] = tensors[at]
            at += 1
    return out


def split_leaves(params: dict, full: dict) -> list:
    """The inverse of `joined_leaves`: whole tensors cut into the parts
    `pipeline_leaves(params)` lists, each on its part's device."""
    out: list = []
    for name, leaf in params.items():
        value = torch.as_tensor(full[name])
        if isinstance(leaf, ModelShards):
            out += [take_slice(value, 0, m, len(leaf)).to(t.device, t.dtype)
                    for m, t in enumerate(leaf)]
        else:
            out.append(value.to(leaf.device, leaf.dtype))
    return out


def _block_module(d_model: int, n_heads: int, mlp_ratio: int,
                  dtype) -> TransformerBlock:
    # the block's own parameters are never used (every call passes its
    # layer's leaves), so it is built without storage
    return TransformerBlock(d_model, n_heads, mlp_ratio, dtype_of(dtype),
                            attn_impl="dense", device="meta")


def _row_params(params: dict, devices: list) -> tuple:
    """Data row's view of the placed tree over its stages `devices`:
    (embed/head leaves, per-stage {block leaf: layers}), moved with `.to`
    where the row's stages differ from row 0's."""
    first, last = devices[0], devices[-1]
    plain = {n: t.to(first if n in EMBED_LEAVES else last)
             for n, t in params.items() if not n.startswith(BLOCKS)}
    stages = [{n[len(BLOCKS):]: t[s].to(dev)
               for n, t in params.items() if n.startswith(BLOCKS)}
              for s, dev in enumerate(devices)]
    return plain, stages


def pipeline_row_logits(mesh, params: dict, slabs: Sequence, *,
                        n_heads: int, n_micro: int = 4,
                        stage_axis: str = MODEL_AXIS, mlp_ratio: int = 4,
                        dtype=torch.float32, remat: bool = False) -> list:
    """Each data row's logits (f32, on its last stage's device) of its
    token slab `slabs[i]` through the pipeline over its model group."""
    d_model = params["norm_scale"].shape[0]
    block = _block_module(d_model, n_heads, mlp_ratio, dtype)
    dt = dtype_of(dtype)
    out = []
    for row, tokens in enumerate(slabs):
        devices = stage_devices(mesh, row, stage_axis)
        plain, stages = _row_params(params, devices)
        x = _embed(plain, tokens.to(devices[0])).to(dt)
        x = _pipeline_blocks(block, stages, x, devices, n_micro, remat)
        out.append(_head(plain, x.float()))
    return out


def _data_slabs(mesh, tokens) -> list:
    tokens = torch.as_tensor(tokens)
    n = mesh.shape[DATA_AXIS]
    if tokens.shape[0] % n:
        raise ValueError(f"batch {tokens.shape[0]} must divide over the "
                         f"'{DATA_AXIS}' axis ({n})")
    return list(tokens.split(tokens.shape[0] // n))


def pipelined_lm_apply(mesh, params: dict, tokens, *, n_heads: int,
                       n_micro: int = 4, stage_axis: str = MODEL_AXIS,
                       mlp_ratio: int = 4, dtype=torch.float32,
                       remat: bool = False) -> torch.Tensor:
    """Forward logits (B, S, V) f32 through the dp x pp mesh: the tokens
    split over 'data' into contiguous slabs, data row i's through the
    pipeline over its model group; joined in row order on row 0's last
    stage.  `params` is placed (`place_pipeline_params`) or a host tree,
    which is placed first."""
    if not any(isinstance(t, ModelShards) for t in params.values()):
        params = place_pipeline_params(
            params, pipeline_param_shardings(mesh, params, stage_axis))
    rows = pipeline_row_logits(mesh, params, _data_slabs(mesh, tokens),
                               n_heads=n_heads, n_micro=n_micro,
                               stage_axis=stage_axis, mlp_ratio=mlp_ratio,
                               dtype=dtype, remat=remat)
    home = rows[0].device
    return torch.cat([r.to(home) for r in rows])


def sequential_lm_apply(params: dict, tokens, *, n_heads: int,
                        mlp_ratio: int = 4,
                        dtype=torch.float32) -> torch.Tensor:
    """One-device reference: the same tree, the whole block stack in
    order on the tokens' device (the parity oracle of the schedule)."""
    tokens = torch.as_tensor(tokens)
    full = {n: _full(t).to(tokens.device) for n, t in params.items()}
    d_model = full["norm_scale"].shape[0]
    block = _block_module(d_model, n_heads, mlp_ratio, dtype)
    x = _embed(full, tokens).to(dtype_of(dtype))
    x = _apply_stage(block, {n[len(BLOCKS):]: t for n, t in full.items()
                             if n.startswith(BLOCKS)}, x)
    return _head(full, x.float())


def lm_loss(logits: torch.Tensor, targets: torch.Tensor, mask=None,
            denom=None) -> torch.Tensor:
    """The next-token negative log-likelihood of a row slab summed over
    its tokens, over `denom` (default 1); `mask` is unused (every token
    counts)."""
    total = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                            targets.reshape(-1).long().to(logits.device),
                            reduction="sum")
    return total if denom is None else total / denom


def pipeline_train_step(mesh, params: dict, tx, opt_state, xs, ys, masks,
                        loss_fn, denom, *, n_heads: int, n_micro: int = 4,
                        stage_axis: str = MODEL_AXIS, mlp_ratio: int = 4,
                        dtype=torch.float32, remat: bool = False,
                        reduce=None) -> tuple:
    """One update of the placed tree `params` through the pipeline, the
    one step both `make_pipeline_lm_step` and the Trainer run: data row
    i's token slab `xs[i]` through the GPipe schedule over its model
    group, `loss_fn(logits, ys[i], masks[i], denom=denom)` of each row
    added in row order on row 0's last stage, the gradients through the
    reverse pipeline on each stage's device (zeros for a leaf that gets
    none), `reduce(grads, loss) -> loss` where given (the Trainer's sum
    over processes, in place on the gradients), and one update of `tx`
    (`train/optim.py` `Optimizer`, its state from
    `tx.init(pipeline_leaves(params))`) in place on the leaves.  Returns
    (the loss detached, the gradients)."""
    leaves = pipeline_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    rows = pipeline_row_logits(mesh, params, xs, n_heads=n_heads,
                               n_micro=n_micro, stage_axis=stage_axis,
                               mlp_ratio=mlp_ratio, dtype=dtype, remat=remat)
    loss = reduce_to_home([
        loss_fn(r, y.to(r.device), mk.to(r.device), denom=denom.to(r.device))
        for r, y, mk in zip(rows, ys, masks)])
    loss.backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in leaves]
    loss = loss.detach()
    if reduce is not None:
        loss = reduce(grads, loss)
    tx.update(grads, opt_state, leaves)
    return loss, grads


def make_pipeline_lm_step(mesh, tx, *, n_heads: int, n_micro: int = 4,
                          stage_axis: str = MODEL_AXIS, mlp_ratio: int = 4,
                          dtype=torch.float32):
    """`step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss)`: `pipeline_train_step` (dp over 'data', pp over the stage axis)
    with every token counted, the loss the mean next-token NLL over the
    batch."""
    def step(params, opt_state, tokens, targets):
        xs = _data_slabs(mesh, tokens)
        ys = _data_slabs(mesh, targets)
        masks = [torch.ones(y.shape[0], device=y.device) for y in ys]
        denom = torch.tensor(float(sum(y.numel() for y in ys)))
        loss, _ = pipeline_train_step(
            mesh, params, tx, opt_state, xs, ys, masks, lm_loss, denom,
            n_heads=n_heads, n_micro=n_micro, stage_axis=stage_axis,
            mlp_ratio=mlp_ratio, dtype=dtype)
        return params, opt_state, loss

    return step


def count_pipeline_bubble(n_micro: int, n_stages: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


# --------------------------------------------------------------------------
# bundle interop: the pipeline's tree <-> TransformerLM flax variables, so
# a pipelined fit emits an ordinary TransformerLM bundle and warm-starts
# from one
# --------------------------------------------------------------------------

def pipeline_params_from_variables(variables: dict, n_layers: int) -> dict:
    """TransformerLM flax variables (numpy leaves) -> the pipeline's tree
    (host f32 tensors, module docstring)."""
    p = variables["params"]
    tree = {
        "tok_embed": p["tok_embed"]["embedding"],
        "pos_embed": p["pos_embed"]["embedding"],
        "blocks": {
            leaf: {key: np.stack([np.asarray(p[f"block{i}_w"][leaf][key],
                                             np.float32)
                                  for i in range(n_layers)])
                   for key in node}
            for leaf, node in p["block0_w"].items()},
        "norm_scale": p["final_norm_w"]["scale"],
        "norm_bias": p["final_norm_w"]["bias"],
        "head": p["lm_head"]["kernel"],
        "head_bias": p["lm_head"]["bias"],
    }
    return params_from_jax(tree)


def variables_from_pipeline_params(params: dict, n_layers: int) -> dict:
    """The inverse of `pipeline_params_from_variables`: the tree (host or
    placed) unstacked into a TransformerLM's flax variables (numpy)."""
    tree = params_to_jax({n: _full(t) for n, t in params.items()})
    flax_params = {
        "tok_embed": {"embedding": tree["tok_embed"]},
        "pos_embed": {"embedding": tree["pos_embed"]},
        "final_norm_w": {"scale": tree["norm_scale"],
                         "bias": tree["norm_bias"]},
        "lm_head": {"kernel": tree["head"], "bias": tree["head_bias"]},
    }
    for i in range(n_layers):
        flax_params[f"block{i}_w"] = {
            leaf: {key: np.ascontiguousarray(v[i]) for key, v in node.items()}
            for leaf, node in tree["blocks"].items()}
    return {"params": flax_params}
