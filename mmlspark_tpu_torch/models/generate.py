"""Autoregressive generation with a KV cache: the port of the decode core,
`DecodeEngine` and `TextGenerator` of `mmlspark_tpu/models/generate.py`.

The serving path is `TextGenerator.transform` -> `DecodeEngine.generate`:

  * **bucketed prefill** — prompts are right-padded to a bucket (next power
    of two, floored at `DEFAULT_MIN_BUCKET`, capped at max_len minus the
    generation budget) with per-row true lengths; one causal forward
    writes every layer's K/V.  From `_PREFILL_FLASH_MIN` tokens up the
    prefill attention runs the flash kernel (ops/flash_attention.py), which
    takes any bucket length: the JAX package's dense fallback for buckets
    that do not tile its blocks is not needed here.
  * **cache-windowed decode** — generation runs in segments attending only
    over the cache prefix rounded up to `chunk` slots (`decode_segments`);
    every step's cache read is the fused single-query kernel
    (ops/decode_attention.py), over a model-dtype or int8 cache.  The JAX
    package's `lax.scan` over a segment is a Python loop over its steps.
  * **stop-token early exit** — a per-row done mask freezes stopped rows;
    the host checks it between segments and skips the rest once every row
    has stopped (after `min_new_tokens`).

Greedy tokens equal the JAX package's at f32 (tests/test_torch_generate.py).
Unlike the JAX programs, the caches are updated in place: one decode step
writes one slot instead of rebuilding the cache.  The module keeps f32
master parameters; the engine casts the Dense weights to the model dtype
once, at construction (`ServingWeights`), and the block math reads those
copies; `TextGenerator` keeps only them, so serving holds no f32 Dense
weights beside the bf16 ones.

Sampling draws come from per-row `torch.Generator`s seeded from
(seed, row id, step), so a row's draws never depend on its batch.  Torch
and JAX random streams differ, so sampled tokens differ between packages;
the distribution is the same.

  * **seq-sharded long-context decode** — with a `Mesh` whose 'seq' axis
    is > 1, the prompt and the cache window split over the seq shards:
    ring prefill, window slabs re-split on growth, and each step's read as
    per-shard softmax statistics merged across shards (`DecodeEngine`).
  * **serving hooks** — `serve_prefill`, `serve_step`, `serve_window`
    and `merge_cache_rows`, through which the continuous-batching
    scheduler (serve/engine.py) drives a resident batch whose rows sit at
    different decode ages; `serialize_cache_row`/`deserialize_cache_row`
    cut a cache row into wire pages the JAX package reads, and read its.
  * **chunked prefill** — with `prefill_chunk`, a bucket the chunk
    divides (and exceeds) prefills in chunks: chunk 0 at slot 0 (the
    flash kernel from `_PREFILL_FLASH_MIN` tokens up), every later chunk
    through the dense full-cache branch at its offset, the last prompt
    position's logits carried between chunks; the serve hooks
    (`serve_prefill_chunk`, `serve_prefill_finish`) let the scheduler
    interleave the chunks with decode segments, and the resume hooks
    (`serve_resume_init`, `serve_prefill_resume`) open a prefill from a
    prefix pool's donor rows and prefill only the novel suffix.

  * **speculative decoding** — with a draft model (`zoo/speculative.py`
    builds one from the target bundle) and `spec_tokens` k, decode runs
    draft/verify rounds: the draft's k+1 single-token steps through the
    per-row decode step (the decode kernel on every draft step), ONE
    target forward over the k+1 positions (`_verify_step_rows`, its read
    `segment_cache_attention`), and the agreeing prefix commits.  Greedy
    tokens are the plain engine's; sampled ones come from a rejection
    sampler on the row streams' disjoint speculative positions.
  * **int8 weights** — a `quantize_bundle(..., "int8")` bundle's Dense
    layers stay int8 on the card (`ServingWeights`); `_dense` runs the
    product in the model dtype and applies the per-channel scale after.
  * **beam search** — `make_beam_search_fn` / `beam_search`: one prefill
    a row, expanded to B*W cache rows, top-W of W*V each step, caches and
    history re-indexed to the surviving ancestors.
  * **mixture-of-experts models** — a MoE block's MLP half is
    `ops/moe.py` `moe_apply` over the serving copy of its experts
    (`_mlp`).  Each call routes its B x S tokens as the module does, so a
    decode step routes its whole batch, padding and finished rows
    included, as one capacity group, exactly as the JAX engine does:
    under capacity pressure a row's tokens depend on its co-batched rows,
    and greedy tokens equal the recompute oracle's only in the drop-free
    regime (moe_group_size=1).  Speculative decoding and the seq-sharded
    path refuse MoE models, as in the JAX package.

Not ported yet (it raises NotImplementedError): tensor-parallel decode (a
mesh with model > 1).
"""

from __future__ import annotations

import copy
import functools
import io
import os
import struct
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_bundle,
                                              save_bundle)
from mmlspark_tpu_torch.models.definitions import Int8Dense, TransformerLM
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.telemetry import active_run
from mmlspark_tpu_torch.observe.trace import trace_event, trace_span
from mmlspark_tpu_torch.ops.attention import (NEG_INF, merge_attention_stats,
                                              ring_attention,
                                              segment_cache_attention)
from mmlspark_tpu_torch.ops.decode_attention import (
    fused_single_query_attention, fused_single_query_attention_stats)
from mmlspark_tpu_torch.ops.flash_attention import flash_attention
from mmlspark_tpu_torch.ops.moe import moe_apply
from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                              Mesh)
from mmlspark_tpu_torch.parallel.partition import SEQ_KV_CACHE_SPEC
from mmlspark_tpu_torch.parallel.ring import reshard
from mmlspark_tpu_torch.quant.modules import quant_dense_apply
from mmlspark_tpu_torch.quant.quantize import quantize_kv

DEFAULT_CACHE_CHUNK = 128  # cache-window growth granularity (slots)
DEFAULT_MIN_BUCKET = 8     # smallest prompt bucket
_PREFILL_FLASH_MIN = 512   # prompt length from which prefill runs flash
_WINDOW_DIM = SEQ_KV_CACHE_SPEC.index(SEQ_AXIS)  # the cache axis over 'seq'
# speculative sampling streams: stream ids past any decode step (steps are
# < max_len < 2**20) for the draft's draws, the acceptance coins and the
# residual draw of each round, so they never meet the per-step streams
_SPEC_DRAFT_STREAM = 1 << 20
_SPEC_COIN_STREAM = 2 << 20
_SPEC_FIX_STREAM = 3 << 20


# ---------------------------------------------------------------------------
# The decode core: the block math over the module's weights
# ---------------------------------------------------------------------------

class ServingWeights:
    """A TransformerLM's weights as the decode path reads them: every
    Dense weight and bias cast to the model dtype once (a copy at bf16,
    the module's own f32 tensors at f32), embeddings and LayerNorms as the
    module holds them (f32).  Attribute names follow the module's, so the
    block math takes either.  The module's f32 Dense masters are not
    referenced, so serving holds the model-dtype copy alone.  An int8
    layer (`Int8Dense`, from an int8-quantized bundle) stays int8, one
    byte a weight, with its f32 `scale` and an f32 bias.  A MoE block's
    `moe` holds its router in f32 (the JAX module routes in f32) and its
    expert stacks cast to the model dtype once (`ops/moe.py`
    `moe_apply`)."""

    def __init__(self, module):
        _check_generatable(module)
        dtype = module.dtype

        def cast(linear):
            if isinstance(linear, Int8Dense):
                return SimpleNamespace(weight=linear.weight,
                                       scale=linear.scale,
                                       bias=linear.bias.detach().float())
            return SimpleNamespace(weight=linear.weight.detach().to(dtype),
                                   bias=linear.bias.detach().to(dtype))

        def mlp(blk) -> dict:
            if module.mlp_impl != "moe":
                return dict(mlp_up=cast(blk.mlp_up),
                            mlp_down=cast(blk.mlp_down))
            moe = blk.moe
            return dict(moe=SimpleNamespace(
                router_weight=moe.router.weight.detach().float(),
                router_bias=moe.router.bias.detach().float(),
                w_in=moe.w_in.detach().to(dtype),
                w_out=moe.w_out.detach().to(dtype),
                router_k=moe.router_k, group_size=moe.group_size,
                capacity_factor=moe.capacity_factor,
                z_loss_weight=moe.z_loss_weight))

        self.dtype, self.n_heads = dtype, module.n_heads
        self.device = module.device
        self.mlp_impl = module.config["mlp_impl"]
        self.max_len, self.vocab_size = module.max_len, module.vocab_size
        self.d_model, self.n_layers = module.d_model, module.n_layers
        self.tok_embed, self.pos_embed = module.tok_embed, module.pos_embed
        self.final_norm_w = module.final_norm_w
        self.lm_head = cast(module.lm_head)
        self.blocks = [SimpleNamespace(
            LayerNorm_0=blk.LayerNorm_0, LayerNorm_1=blk.LayerNorm_1,
            qkv=cast(blk.qkv), proj=cast(blk.proj), **mlp(blk))
            for blk in module.blocks]
        self._copies: dict = {}

    def dense_layers(self) -> list:
        """Every Dense layer's weights: each block's (qkv, proj, and a
        dense block's mlp_up and mlp_down), then the head."""
        return [getattr(blk, name) for blk in self.blocks
                for name in ("qkv", "proj", "mlp_up", "mlp_down")
                if hasattr(blk, name)] + [self.lm_head]

    def on(self, device) -> "ServingWeights":
        """These weights on `device`: this object where they already are,
        else a copy made once and kept, so the engines sharing this object
        hold the weights once per distinct device of their meshes."""
        device = torch.device(device)
        if _same_device(self.device, device):
            return self
        if device not in self._copies:
            def move(layer):
                # a module (embeddings, norms) by its leaves, a namespace
                # (cast layers, a MoE block's pieces) by its attributes
                items = ([(leaf, getattr(layer, leaf)) for leaf in
                          ("weight", "scale", "bias") if hasattr(layer, leaf)]
                         if isinstance(layer, torch.nn.Module)
                         else vars(layer).items())
                return SimpleNamespace(**{
                    name: (value.detach().to(device)
                           if isinstance(value, torch.Tensor) else value)
                    for name, value in items})
            twin = copy.copy(self)
            twin.device, twin._copies = device, {}
            for name in ("tok_embed", "pos_embed", "final_norm_w",
                         "lm_head"):
                setattr(twin, name, move(getattr(self, name)))
            twin.blocks = [SimpleNamespace(**{
                name: move(part) for name, part in vars(blk).items()})
                for blk in self.blocks]
            self._copies[device] = twin
        return self._copies[device]


def _ln(norm, x: torch.Tensor, dtype) -> torch.Tensor:
    """The decode path's LayerNorm: f32 two-pass statistics, f32 affine,
    then the cast (generate.py `_ln`)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + 1e-6)
    return (y * norm.scale + norm.bias).to(dtype)


def _dense(linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """A Dense layer over its model-dtype copy (`ServingWeights`), or an
    int8 layer (one with a `scale`): the JAX decode path's int8 branch,
    the product rounded to `dtype` before the per-channel scale."""
    scale = getattr(linear, "scale", None)
    if scale is not None:
        return quant_dense_apply(x, linear.weight, scale, linear.bias,
                                 dtype)
    return F.linear(x.to(dtype), linear.weight, linear.bias)


def _mlp(block, h2: torch.Tensor, dtype) -> torch.Tensor:
    """The block's MLP half over normalized activations h2 (B, S, D): the
    dense GELU MLP, or a MoE block's experts (`ops/moe.py` `moe_apply`,
    the JAX `_mlp`'s re-applied `MoEMLP`).  MoE routes the B x S tokens
    of the call as the module does, so a decode step routes its whole
    batch, padding and finished rows included, as one capacity group, as
    the JAX engine does."""
    moe = getattr(block, "moe", None)
    if moe is not None:
        return moe_apply(h2, moe.router_weight, moe.router_bias, moe.w_in,
                         moe.w_out, router_k=moe.router_k,
                         group_size=moe.group_size,
                         capacity_factor=moe.capacity_factor,
                         z_loss_weight=moe.z_loss_weight)[0]
    return _dense(block.mlp_down, F.gelu(_dense(block.mlp_up, h2, dtype),
                                         approximate="tanh"), dtype)


def _split_heads(qkv: torch.Tensor, n_heads: int) -> tuple:
    b, s, d3 = qkv.shape
    d = d3 // 3
    return tuple(t.reshape(b, s, n_heads, d // n_heads)
                 for t in qkv.split(d, dim=-1))


def _qkv(block, n_heads: int, x: torch.Tensor, dtype) -> tuple:
    """The block's attention inputs: q, k, v (B, S, H, Dh) in `dtype`."""
    return _split_heads(_dense(block.qkv, _ln(block.LayerNorm_0, x, dtype),
                               dtype), n_heads)


def _block_tail(block, x: torch.Tensor, o: torch.Tensor,
                dtype) -> torch.Tensor:
    """The block after attention: the output projection of `o` (any shape
    that reshapes to x's) onto the residual, then the MLP half."""
    x = x + _dense(block.proj, o.reshape(x.shape).to(dtype), dtype)
    return x + _mlp(block, _ln(block.LayerNorm_1, x, dtype), dtype)


def _block_with_cache(block, n_heads: int, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      pos: int, dtype) -> torch.Tensor:
    """One TransformerBlock over a token segment starting at cache slot
    `pos`, writing its K/V into the (B, W, H, Dh) caches in place."""
    s = x.shape[1]
    dh = x.shape[2] // n_heads
    q, k, v = _qkv(block, n_heads, x, dtype)
    k_cache[:, pos:pos + s] = k.to(k_cache.dtype)
    v_cache[:, pos:pos + s] = v.to(v_cache.dtype)
    if s >= _PREFILL_FLASH_MIN and pos == 0:
        # long-prompt prefill: attention against the cache is exactly
        # causal self-attention over the segment
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True)
    else:
        width = k_cache.shape[1]
        scores = torch.einsum("bqhd,blhd->bhql", q.float(),
                              k_cache.float()) * dh ** -0.5
        q_pos = pos + torch.arange(s, device=x.device)
        visible = (torch.arange(width, device=x.device)[None, :]
                   <= q_pos[:, None])
        scores = torch.where(visible[None, None], scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhql,blhd->bqhd", w, v_cache.float())
    return _block_tail(block, x, o, dtype)


def _forward_with_cache(module, tokens: torch.Tensor, caches: list,
                        pos: int) -> torch.Tensor:
    """Logits (B, S, V) f32 for a token segment at cache slot `pos`; the
    per-layer (k, v) caches are written in place.  `module` is the
    `ServingWeights` of a TransformerLM."""
    dtype = module.dtype
    positions = pos + torch.arange(tokens.shape[1], device=tokens.device)
    emb = (module.tok_embed.weight[tokens]
           + module.pos_embed.weight[positions][None])
    x = emb.to(dtype)
    for block, (kc, vc) in zip(module.blocks, caches):
        x = _block_with_cache(block, module.n_heads, x, kc, vc, pos, dtype)
    x = _ln(module.final_norm_w, x, dtype)
    return _dense(module.lm_head, x, dtype).float()


def _write_token(cache: tuple, slot, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Write one decode token's K/V (B, H, Dh) per row in place, on the
    cache's device: at the shared cache slot `slot` (an int: every row of
    a `decode_segment` batch writes the same slot), or at per-row slots
    (a (B,) long tensor: the serving engine's mixed-age batch).  An int8
    cache ((k_q, k_scale, v_q, v_scale)) quantizes the token on write,
    payload and (B, H) scale at the same slots."""
    dev = cache[0].device
    k, v = k.to(dev), v.to(dev)
    at = ((slice(None), slot) if isinstance(slot, int) else
          (torch.arange(k.shape[0], device=dev), slot.to(dev)))
    if len(cache) == 4:
        kq, ks, vq, vs = cache
        kq[at], ks[at] = quantize_kv(k)
        vq[at], vs[at] = quantize_kv(v)
    else:
        kc, vc = cache
        kc[at] = k.to(kc.dtype)
        vc[at] = v.to(vc.dtype)


def _cache_read_args(cache: tuple) -> tuple:
    """(k, v, {k_scale, v_scale}) of a model-dtype or int8 cache."""
    if len(cache) == 4:
        kq, ks, vq, vs = cache
        return kq, vq, dict(k_scale=ks, v_scale=vs)
    return cache[0], cache[1], {}


def _decode_step(module, tok: torch.Tensor, pos: torch.Tensor, caches: list,
                 attend) -> torch.Tensor:
    """Logits (B, V) f32 for one decode token per row at per-row positions
    `pos` (true prompt length + step).  `attend(cache, q, k, v)` writes the
    token's K/V (B, H, Dh) into its layer's cache and returns the (B, H, Dh)
    read of the window.  `module` is the `ServingWeights` of a
    TransformerLM on the device the residual stream lives on."""
    dtype = module.dtype
    emb = module.tok_embed.weight[tok] + module.pos_embed.weight[pos]
    x = emb[:, None].to(dtype)
    for block, cache in zip(module.blocks, caches):
        q, k, v = (t[:, 0] for t in _qkv(block, module.n_heads, x, dtype))
        x = _block_tail(block, x, attend(cache, q.contiguous(), k, v), dtype)
    x = _ln(module.final_norm_w, x, dtype)
    return _dense(module.lm_head, x, dtype).float()[:, 0]


def _row_write(cache: torch.Tensor, update: torch.Tensor,
               slots0: torch.Tensor) -> None:
    """Write S contiguous entries a row in place: `update` (B, S, ...)
    lands at slots slots0[r]..slots0[r]+S-1 of row r of `cache` (B, W,
    ...), the start clamped into [0, W - S] as `dynamic_update_slice`
    clamps it."""
    b, s = update.shape[:2]
    dev = cache.device
    start = torch.clamp(slots0.to(dev), 0, cache.shape[1] - s)
    cols = start[:, None] + torch.arange(s, device=dev)[None, :]
    cache[torch.arange(b, device=dev)[:, None], cols] = update.to(
        device=dev, dtype=cache.dtype)


def _write_segment(cache: tuple, slots0: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    """Write a segment's K/V (B, S, H, Dh) at per-row start slots in
    place (the JAX `_row_write` of the verify forward); an int8 cache
    quantizes the segment on write, payload and (B, S, H) scales."""
    if len(cache) == 4:
        kq, ks, vq, vs = cache
        for dst, part in zip((kq, ks, vq, vs),
                             quantize_kv(k) + quantize_kv(v)):
            _row_write(dst, part, slots0)
    else:
        _row_write(cache[0], k, slots0)
        _row_write(cache[1], v, slots0)


def _verify_step_rows(module, toks: torch.Tensor, pos0: torch.Tensor,
                      slots0: torch.Tensor, caches: list,
                      visible: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, V) f32 of per-row contiguous verify segments (the
    speculative target forward): row r's S tokens sit at positions
    pos0[r].. (clamped to the position table) and write cache slots
    slots0[r]..; every query reads the window under its own row of
    `visible` (B, S, W) through `segment_cache_attention`."""
    dtype = module.dtype
    s = toks.shape[1]
    positions = torch.clamp(
        pos0[:, None] + torch.arange(s, device=toks.device)[None, :],
        max=module.max_len - 1)
    x = (module.tok_embed.weight[toks]
         + module.pos_embed.weight[positions]).to(dtype)
    for block, cache in zip(module.blocks, caches):
        q, k, v = _qkv(block, module.n_heads, x, dtype)
        _write_segment(cache, slots0, k, v)
        kc, vc, scales = _cache_read_args(cache)
        o = segment_cache_attention(q, kc, vc, visible, **scales)
        x = _block_tail(block, x, o, dtype)
    x = _ln(module.final_norm_w, x, dtype)
    return _dense(module.lm_head, x, dtype).float()


def _grow_cache(cache: torch.Tensor, window: int) -> torch.Tensor:
    """Zero-extend a cache prefix to `window` slots (payloads (B, W, H, D)
    and int8 scales (B, W, H) alike)."""
    if cache.shape[1] == window:
        return cache
    out = cache.new_zeros((cache.shape[0], window) + tuple(cache.shape[2:]))
    out[:, :cache.shape[1]] = cache
    return out


# ---------------------------------------------------------------------------
# Cache-row pages: the wire format of the JAX package's
# serialize_cache_row / deserialize_cache_row
# ---------------------------------------------------------------------------

# page header (n_layers, n_tensors); per-tensor header (dtype-name length,
# ndim); dims and byte lengths as >I
_PAGE_HDR, _TENSOR_HDR, _U32 = (struct.Struct(">HH"), struct.Struct(">BB"),
                                struct.Struct(">I"))


def _wire_bytes(part: torch.Tensor) -> bytes:
    """A host tensor's raw bytes; bfloat16 through its int16 view (numpy
    has no bfloat16), the same bits the JAX package writes."""
    if part.dtype == torch.bfloat16:
        part = part.view(torch.int16)
    return part.numpy().tobytes()


def _from_wire(raw: bytes, name: str, shape: tuple) -> torch.Tensor:
    """The tensor a page record holds: `name` is a numpy dtype name, or
    "bfloat16" read through int16.  A record whose name, byte count or
    shape does not fit raises ValueError."""
    try:
        dtype = np.dtype("int16" if name == "bfloat16" else name)
        out = torch.from_numpy(
            np.frombuffer(raw, dtype=dtype).reshape(shape).copy())
    except TypeError as e:
        raise ValueError(f"unknown page tensor dtype {name!r}") from e
    return out.view(torch.bfloat16) if name == "bfloat16" else out


def _row_to_host(parts: list) -> list:
    """`parts` (a list of layers of tensors on one device) as
    contiguous host tensors, through one device-to-host copy."""
    flat = [t.contiguous() for layer in parts for t in layer]
    if flat[0].device.type == "cpu":
        host = flat
    else:
        data = torch.cat([t.view(torch.uint8).reshape(-1)
                          for t in flat]).cpu()
        host, at = [], 0
        for t in flat:
            n = t.numel() * t.element_size()
            host.append(data[at:at + n].clone().view(t.dtype)
                        .reshape(t.shape))
            at += n
    it = iter(host)
    return [[next(it) for _ in layer] for layer in parts]


def _slice_header(part: torch.Tensor) -> bytes:
    """The record header of one window slice: its dtype name, shape and
    byte length (the raw bytes follow it)."""
    name = str(part.dtype).removeprefix("torch.").encode("ascii")
    return b"".join([_TENSOR_HDR.pack(len(name), part.dim()), name,
                     *(_U32.pack(dim) for dim in part.shape),
                     _U32.pack(part.numel() * part.element_size())])


def _frame_page(parts: list) -> bytes:
    """One page: the page header, then per layer-tensor window slice its
    record (`parts`: layers of host tensors)."""
    bio = io.BytesIO()
    bio.write(_PAGE_HDR.pack(len(parts), len(parts[0])))
    for layer in parts:
        for part in layer:
            bio.write(_slice_header(part))
            bio.write(_wire_bytes(part))
    return bio.getvalue()


class CacheRowPages:
    """ONE row of a serve cache cut into chunk-granular window pages, made
    one at a time: `pages[i]` copies page i's window slices of every
    layer-tensor from the card to the host in one copy, then frames them
    as a self-describing blob (dtype name + shape + raw bytes per slice)
    that `deserialize_cache_row` — the port's or the JAX package's —
    reassembles without side-channel layout info.  Both cache layouts
    work, the 2-tuple model-dtype (k, v) and the 4-tuple int8 (kq,
    k_scale, vq, v_scale).  The KV handoff bus frames a row's pages as it
    pushes them, so the row's copies spread over the ticks its transfer
    takes.  Holds views of `caches`, which must not be written
    meanwhile."""

    def __init__(self, caches, row: int, chunk: int):
        self._row = [[t[row].detach() for t in layer] for layer in caches]
        self._width = self._row[0][0].shape[0]
        self._step = max(1, int(chunk))

    def __len__(self) -> int:
        return -(-self._width // self._step)

    def _slices(self, i: int) -> list:
        lo = i * self._step
        return [[t[lo:lo + self._step] for t in layer] for layer in self._row]

    def __getitem__(self, i: int) -> bytes:
        if not 0 <= i < len(self):
            raise IndexError(i)
        return _frame_page(_row_to_host(self._slices(i)))

    def nbytes(self) -> int:
        """The pages' total length, from the shapes alone: the headers
        `_frame_page` writes and the slices' bytes."""
        return sum(_PAGE_HDR.size + sum(
            len(_slice_header(part)) + part.numel() * part.element_size()
            for layer in self._slices(i) for part in layer)
            for i in range(len(self)))


def serialize_cache_row(caches, row: int, chunk: int) -> list:
    """The JAX package's `serialize_cache_row`: every page of
    `CacheRowPages(caches, row, chunk)`, as a list."""
    return list(CacheRowPages(caches, row, chunk))


def deserialize_cache_row(pages: list) -> list:
    """Reassemble `serialize_cache_row` pages (in chunk order) into a
    1-row cache of host tensors, ready for `DecodeEngine.
    merge_cache_rows`: window slices concatenate back on the window axis
    and gain the batch dim.  Bit-exact: dtype and bits round-trip
    untouched.  Truncated or mismatched pages raise ValueError."""
    if not pages:
        raise ValueError("cannot deserialize an empty page list")

    def read(bio, n):
        data = bio.read(n)
        if len(data) != n:
            raise ValueError("short page: truncated tensor record")
        return data

    parts = None
    for blob in pages:
        bio = io.BytesIO(blob)
        n_layers, n_tensors = _PAGE_HDR.unpack(read(bio, _PAGE_HDR.size))
        if parts is None:
            parts = [[[] for _ in range(n_tensors)]
                     for _ in range(n_layers)]
        elif len(parts) != n_layers or len(parts[0]) != n_tensors:
            raise ValueError("page layout mismatch across pages")
        for li in range(n_layers):
            for ti in range(n_tensors):
                nlen, ndim = _TENSOR_HDR.unpack(read(bio, _TENSOR_HDR.size))
                name = read(bio, nlen).decode("ascii")
                shape = tuple(_U32.unpack(read(bio, _U32.size))[0]
                              for _ in range(ndim))
                (nbytes,) = _U32.unpack(read(bio, _U32.size))
                parts[li][ti].append(_from_wire(read(bio, nbytes), name,
                                                shape))
    return [tuple(torch.cat(tensors, dim=0)[None] for tensors in layer)
            for layer in parts]


# ---------------------------------------------------------------------------
# Plans, sampling, stopping
# ---------------------------------------------------------------------------

def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def bucket_length(n: int, max_len: int, max_new_tokens: int,
                  min_bucket: int = DEFAULT_MIN_BUCKET) -> int:
    """The prompt bucket for a true length `n`: next power of two, floored
    at `min_bucket` and capped at `max_len - max_new_tokens`."""
    cap = max_len - max_new_tokens
    if n < 1:
        raise ValueError("prompt length must be >= 1")
    if n > cap:
        raise ValueError(
            f"prompt length ({n}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds the model's max_len ({max_len})")
    return min(max(1 << (n - 1).bit_length(), min_bucket), cap)


def decode_segments(bucket: int, max_new_tokens: int, chunk: int) -> list:
    """The segment plan of a windowed decode: (start_step, seg_len, window)
    covering steps 0..max_new_tokens-2 (step s writes cache slot
    bucket+s; the first generated token comes from prefill).  `window` is
    the chunk-rounded cover of the segment's highest written slot, and
    segments are capped at `chunk` steps so the early-exit check runs at
    least once per chunk."""
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    segs = []
    s = 0
    while s <= max_new_tokens - 2:
        w = _round_up(bucket + s + 1, chunk)
        last = min(w - bucket - 1, s + chunk - 1, max_new_tokens - 2)
        segs.append((s, last - s + 1, w))
        s = last + 1
    return segs


def filter_logits(logits: torch.Tensor, top_k: Optional[int] = None,
                  top_p: Optional[float] = None) -> torch.Tensor:
    """Mask (B, V) logits to the top-k entries and/or the top-p nucleus
    (the first token always survives); the rest become NEG_INF."""
    out = logits.float()
    if top_k is not None and top_k < out.shape[-1]:
        kth = torch.topk(out, top_k, dim=-1).values[..., -1:]
        out = torch.where(out >= kth, out, NEG_INF)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(out, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        cutoff = torch.where(keep, sorted_logits, float("inf")).amin(
            dim=-1, keepdim=True)
        out = torch.where(out >= cutoff, out, NEG_INF)
    return out


_MASK64 = (1 << 64) - 1


def _mix(a: int, b: int) -> int:
    """A 63-bit seed from two ints (splitmix64 finalizer): the stream id of
    (seed, row id) and of (row stream, step)."""
    z = (a * 0x9E3779B97F4A7C15 + b + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _gumbel_draw(logits: torch.Tensor, seed: int) -> torch.Tensor:
    """One categorical draw from a row's (V,) logits by the Gumbel max,
    its uniforms from a generator seeded with `seed`."""
    gen = torch.Generator(device=logits.device)
    gen.manual_seed(seed)
    u = torch.rand(logits.shape[-1], generator=gen, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)))


def _make_row_sampler(temperature: float, top_k, top_p):
    """A `(logits (B, V), row_seeds [B], step) -> tokens (B,)` sampler:
    greedy at temperature 0, else the Gumbel-max draw over the filtered,
    temperature-scaled logits, each row from its own generator seeded with
    (row stream, step).  `step` is one int for the batch, or a (B,) tensor
    of per-row steps (the serving engine's mixed-age rows draw from the
    stream positions a batch of their own would give them)."""
    if temperature <= 0.0:
        def sample(logits, row_seeds, step):
            return torch.argmax(logits, dim=-1)
        return sample

    def sample(logits, row_seeds, step):
        filtered = filter_logits(logits.float() / temperature, top_k, top_p)
        out = torch.empty(logits.shape[0], dtype=torch.long,
                          device=logits.device)
        steps = ([step] * len(row_seeds) if isinstance(step, int)
                 else step.tolist())
        for i, (row_seed, row_step) in enumerate(zip(row_seeds, steps)):
            out[i] = _gumbel_draw(filtered[i], _mix(row_seed, row_step))
        return out
    return sample


def _make_stop_check(stop_tokens: tuple):
    if not stop_tokens:
        return lambda tok: torch.zeros(tok.shape, dtype=torch.bool,
                                       device=tok.device)
    stops = {}   # the stop ids on each device that samples

    def is_stop(tok):
        if tok.device not in stops:
            stops[tok.device] = torch.tensor(list(stop_tokens),
                                             dtype=torch.long,
                                             device=tok.device)
        return torch.isin(tok, stops[tok.device])
    return is_stop


def _check_generatable(module) -> None:
    if not isinstance(module, TransformerLM):
        raise ValueError(
            f"generation decodes TransformerLM models, got "
            f"{type(module).__name__}")


def _same_device(have: torch.device, want: torch.device) -> bool:
    """`have` is `want`, where a `want` without an index takes any card."""
    return have.type == want.type and (want.index is None
                                       or have.index == want.index)


def _check_mesh_axes(mesh) -> None:
    """The refusals that depend on the mesh alone, shared by `DecodeEngine`
    and `TextGenerator.set_mesh`: a non-Mesh (TypeError); seq>1 with
    model>1 (ValueError, as the JAX engine raises); a model axis alone,
    tensor-parallel decode, is not ported (NotImplementedError)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a mmlspark_tpu_torch.parallel.mesh."
                        f"Mesh, got {type(mesh).__name__}")
    if mesh.shape[MODEL_AXIS] > 1:
        if mesh.shape[SEQ_AXIS] > 1:
            raise ValueError(
                "seq-sharded decode (mesh seq>1) does not compose with "
                "model>1: the seq path keeps heads unsharded "
                "(SEQ_KV_CACHE_SPEC) so the stats merge is the only "
                "cross-shard attention collective")
        raise NotImplementedError(
            "tensor-parallel decode (mesh model>1) is not ported (ROADMAP "
            "A10)")


def _check_mesh(mesh, module, device: torch.device, *, chunk: int,
                min_bucket: int, prefill_chunk, draft_module) -> None:
    """The JAX engine's construction checks of a meshed decode
    (generate.py:1164-1201), then the port's own: a model axis (tensor-
    parallel decode) is not ported, and the mesh's devices must be the
    engine's."""
    _check_mesh_axes(mesh)
    seq = mesh.shape[SEQ_AXIS]
    if seq > 1:
        if getattr(module, "mlp_impl", "dense") == "moe":
            raise ValueError(
                "seq-sharded decode does not support MoE models: per-shard "
                "expert routing would diverge from the global capacity "
                "groups")
        if draft_module is not None:
            raise ValueError(
                "seq-sharded decode does not compose with speculative "
                "decoding: the multi-token verify forward has no "
                "seq-sharded cache path (ROADMAP A8; use a data-only mesh)")
        if prefill_chunk is not None:
            raise ValueError(
                "seq-sharded decode does not compose with chunked prefill: "
                "distributed blockwise (ring) prefill already splits the "
                "prompt over shards")
        if chunk % seq:
            raise ValueError(
                f"cache chunk ({chunk}) must divide by the mesh seq axis "
                f"({seq}) so every window width shards evenly")
        if min_bucket % seq:
            raise ValueError(
                f"min_bucket ({min_bucket}) must divide by the mesh seq axis "
                f"({seq}) so every prompt bucket shards evenly")
    for dev in mesh.devices.flat:
        if not _same_device(dev, device):
            raise ValueError(f"the mesh holds {dev}, the engine runs on "
                             f"{device}")


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def make_beam_search_fn(module, prompt_len: int, max_new_tokens: int,
                        beam_width: int):
    """A `prompts (B, P) int -> (tokens, scores)` beam search for one
    (prompt_len, max_new_tokens) shape (the JAX `make_beam_search_fn`):
    tokens (B, W, P+N) int32 best-first per row, scores (B, W) f32, the
    summed log-probabilities of each beam's generated tokens.  `module` is
    a TransformerLM or its `ServingWeights`; the search runs where they
    are.

    Length-N beams, no early stop and no length penalty.  The prompt
    prefills ONCE a row (the flash kernel from `_PREFILL_FLASH_MIN`
    tokens up), its caches are expanded to B*W rows, and each step scores
    every beam's vocabulary expansion, keeps the top W of W*V a row and
    re-indexes the cache rows and the token history to the surviving
    beams' ancestors.  The caches hold the P+N slots the search writes
    (the JAX program's hold max_len; the extra slots are masked out)."""
    weights = (module if isinstance(module, ServingWeights)
               else ServingWeights(module))
    if prompt_len < 1:
        raise ValueError("prompt_len must be >= 1")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if prompt_len + max_new_tokens > weights.max_len:
        raise ValueError(
            f"prompt_len ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds the model's max_len ({weights.max_len})")
    if beam_width < 1:
        raise ValueError("beam_width must be >= 1")
    if beam_width > weights.vocab_size:
        raise ValueError(
            f"beam_width ({beam_width}) cannot exceed the vocabulary "
            f"({weights.vocab_size}): the first expansion keeps beam_width "
            "distinct tokens")
    w, v = beam_width, weights.vocab_size

    def beam_fn(prompts) -> tuple:
        prompts = _to_device(prompts, torch.long, weights.device)
        if prompts.shape[1] != prompt_len:
            raise ValueError(
                f"prompts have length {prompts.shape[1]} but this beam "
                f"search was built for prompt_len={prompt_len}")
        b = prompts.shape[0]
        shape = (b, prompt_len + max_new_tokens, weights.n_heads,
                 weights.d_model // weights.n_heads)
        with torch.inference_mode():
            caches = [tuple(torch.zeros(shape, dtype=weights.dtype,
                                        device=weights.device)
                            for _ in range(2))
                      for _ in range(weights.n_layers)]
            logits = _forward_with_cache(weights, prompts, caches, 0)
            scores, tok = torch.topk(torch.log_softmax(logits[:, -1], -1), w)
            # every beam of a row shares the prompt's cache: B -> B*W rows
            caches = [tuple(c.repeat_interleave(w, dim=0) for c in layer)
                      for layer in caches]
            history = torch.zeros((b, w, max_new_tokens), dtype=torch.long,
                                  device=weights.device)
            history[:, :, 0] = tok
            row_base = torch.arange(b, device=weights.device)[:, None] * w
            for t in range(max_new_tokens - 1):
                logits = _forward_with_cache(weights, tok.reshape(b * w, 1),
                                             caches, prompt_len + t)
                total = scores[:, :, None] + torch.log_softmax(
                    logits[:, 0], -1).reshape(b, w, v)
                scores, flat = torch.topk(total.reshape(b, w * v), w)
                beam, tok = flat // v, flat % v
                take = (row_base + beam).reshape(-1)
                caches = [tuple(c[take] for c in layer) for layer in caches]
                history = history.gather(
                    1, beam[:, :, None].expand(b, w, max_new_tokens))
                history[:, :, t + 1] = tok
            tokens = torch.cat([prompts[:, None].expand(b, w, prompt_len),
                                history], dim=2)
            return (tokens.cpu().numpy().astype(np.int32),
                    scores.cpu().numpy())

    return beam_fn


def beam_search(module, prompts, max_new_tokens: int,
                beam_width: int = 4) -> tuple:
    """One-shot `make_beam_search_fn`: (tokens (B, W, P+N) best-first,
    scores (B, W))."""
    prompts = np.asarray(prompts)
    return make_beam_search_fn(module, prompts.shape[1], max_new_tokens,
                               beam_width)(prompts)


# ---------------------------------------------------------------------------
# The decode engine
# ---------------------------------------------------------------------------

class DecodeEngine:
    """Bucketed, cache-windowed, early-exit generation for one sampling
    configuration of one module: a `TransformerLM`, or the `ServingWeights`
    made from one (so that several engines share one model-dtype copy).

    `cache_dtype='int8'` stores the KV cache quantized per head
    (quantize-on-write, dequant inside the cache read), so each decode
    step streams 1 byte per cached element instead of the model dtype's 2
    or 4.  Near-tie greedy choices can then differ from the model-dtype
    cache's, exactly as in the JAX package.

    `mesh` (a `parallel.mesh.Mesh`, model 1) runs the seq-sharded
    long-context path of the JAX engine (generate.py:1291-1407).  Rows
    split over 'data' into groups; each group's prompt and KV-cache
    window split over its ring of 'seq' shards:

      * prefill is distributed blockwise: each shard embeds its slab of
        the prompt at its global positions and runs LayerNorm, qkv and
        the MLP itself, with `ring_attention` (the flash forward with lse
        per (shard, block)) between them;
      * the cache window is partitioned in contiguous slabs; the prompt's
        slab boundaries (p/n) are not the window's (w/n), and every
        window growth moves them again, so K/V (and int8 scales) are
        re-split at each change of window; int8 quantizes after the
        re-split, and a decode token is quantized and written only by the
        shard that owns its slot;
      * a decode step computes q, k, v on the group's home device (shard
        0), each shard reads its slab through the stats entry of the
        decode kernel under its slice of the visibility mask, and the
        (acc, m, l) triples merge at home (`merge_attention_stats`); the
        projection, MLP, final norm, head and sampling run once, at home.
        The JAX code replicates that non-attention math on every chip;
        computing it once is the same arithmetic.

    Shards may share one device (a mesh that repeats a card)."""

    def __init__(self, module, max_new_tokens: int, *,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 stop_tokens: tuple = (),
                 chunk: int = DEFAULT_CACHE_CHUNK,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 cache_dtype: str = "model", mesh=None,
                 min_new_tokens: int = 1,
                 prefill_chunk: Optional[int] = None,
                 draft_module=None, spec_tokens: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        if not isinstance(module, ServingWeights):
            _check_generatable(module)
        if not _same_device(module.device, self.device):
            raise ValueError(f"the module's weights are on {module.device}, "
                             f"the engine runs on {self.device}")
        if mesh is not None:
            _check_mesh(mesh, module, self.device, chunk=chunk,
                        min_bucket=min_bucket, prefill_chunk=prefill_chunk,
                        draft_module=draft_module)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                "prefill_chunk must be >= 1 (None = whole-prompt)")
        if spec_tokens < 0:
            raise ValueError("spec_tokens must be >= 0")
        if spec_tokens and draft_module is None:
            raise ValueError(
                "spec_tokens > 0 needs a draft_module (zoo/speculative.py "
                "builds one)")
        if draft_module is not None:
            if spec_tokens < 1:
                raise ValueError("draft_module set but spec_tokens is 0")
            if not isinstance(draft_module, ServingWeights):
                _check_generatable(draft_module)
            if draft_module.vocab_size != module.vocab_size:
                raise ValueError(
                    f"draft vocab ({draft_module.vocab_size}) != target "
                    f"vocab ({module.vocab_size}): speculative acceptance "
                    "compares distributions over one vocabulary")
            if draft_module.max_len < module.max_len:
                raise ValueError(
                    f"draft max_len ({draft_module.max_len}) < target "
                    f"max_len ({module.max_len}): the draft must reach "
                    "every position the target decodes")
            if not _same_device(draft_module.device, self.device):
                raise ValueError(
                    f"the draft's weights are on {draft_module.device}, "
                    f"the engine runs on {self.device}")
            if "moe" in (module.mlp_impl, draft_module.mlp_impl):
                raise ValueError(
                    "speculative decoding does not support MoE models: "
                    "the multi-token verify forward routes a different "
                    "capacity group than step-by-step decode, so "
                    "greedy-exactness cannot hold (see _mlp)")
        if cache_dtype not in ("model", "int8"):
            raise ValueError(
                f"unknown cache_dtype '{cache_dtype}' (model | int8)")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if max_new_tokens >= module.max_len:
            raise ValueError(
                f"max_new_tokens ({max_new_tokens}) leaves no room for a "
                f"prompt within max_len ({module.max_len})")
        if top_k is not None and top_k < 1:
            raise ValueError("top_k must be >= 1")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if not 1 <= min_new_tokens <= max_new_tokens:
            raise ValueError(
                f"min_new_tokens ({min_new_tokens}) must be in "
                f"1..max_new_tokens ({max_new_tokens})")
        stop_tokens = tuple(int(t) for t in stop_tokens or ())
        for t in stop_tokens:
            if not 0 <= t < module.vocab_size:
                raise ValueError(
                    f"stop token {t} outside the vocabulary "
                    f"(0..{module.vocab_size - 1})")
        # the engine keeps the model-dtype copy and drops the f32 masters
        self.weights = (module if isinstance(module, ServingWeights)
                        else ServingWeights(module))
        self.mesh = mesh
        self.seq_shards = mesh.shape[SEQ_AXIS] if mesh is not None else 1
        self.max_new_tokens = max_new_tokens
        self.stop_tokens = stop_tokens
        self.chunk = chunk
        self.min_bucket = min_bucket
        self.cache_dtype = cache_dtype
        self.min_new_tokens = min_new_tokens
        self.prefill_chunk = prefill_chunk
        greedy = temperature <= 0.0
        self.temperature = temperature
        self.top_k = None if greedy else top_k
        self.top_p = None if greedy else top_p
        self._sample = _make_row_sampler(temperature, self.top_k,
                                         self.top_p)
        self._is_stop = _make_stop_check(stop_tokens)
        self.spec_tokens = spec_tokens
        self.draft_weights = (
            None if draft_module is None
            else draft_module if isinstance(draft_module, ServingWeights)
            else ServingWeights(draft_module))
        self.last_segments_run = 0
        self.last_new_tokens_computed = 0
        self.last_exit_checks_skipped = 0
        self.last_spec_rounds = 0
        self.last_spec_drafted = 0
        self.last_spec_accepted = 0
        self.last_spec_acceptance = 0.0
        self._programs: set = set()

    def bucket_for(self, prompt_len: int) -> int:
        return bucket_length(prompt_len, self.weights.max_len,
                             self.max_new_tokens, self.min_bucket)

    def _stop_gate(self, tok: torch.Tensor, new_count) -> torch.Tensor:
        # a stop token only freezes once the row has emitted
        # `min_new_tokens` tokens including it; `new_count` is that count,
        # one int for the batch or a (B,) tensor of per-row counts
        if not isinstance(new_count, int):
            return self._is_stop(tok) & (new_count >= self.min_new_tokens)
        if new_count < self.min_new_tokens:
            return torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)
        return self._is_stop(tok)

    def _first_token(self, last: torch.Tensor, live: torch.Tensor,
                     row_seeds: list) -> tuple:
        tok = self._sample(last, row_seeds, 0)
        return tok, ~live | self._stop_gate(tok, 1)

    def prefill(self, prompts: torch.Tensor, true_len: torch.Tensor,
                live: torch.Tensor, row_seeds: list, ring=None) -> tuple:
        """The prompt forward of one bucket: prompts (B, bucket) long,
        true_len (B,) long, live (B,) bool, on the engine's device (on the
        ring's first device with a ring).  Returns (first token (B,),
        done (B,), per-layer caches over the first window).

        `ring`: the devices of one data group's seq shards (a meshed
        engine); the caches are then per-layer tuples of per-shard slab
        lists, and prefill runs blockwise over the ring."""
        if ring is not None:
            last, caches = self._ring_prefill(prompts, true_len, ring)
            return self._first_token(last, live, row_seeds) + (caches,)
        b, p = prompts.shape
        caches = self._new_caches(b, _round_up(p + 1, self.chunk))
        logits = _forward_with_cache(self.weights, prompts, caches, 0)
        last = logits[torch.arange(b, device=self.device), true_len - 1]
        return self._prefill_finish(caches, last, live, row_seeds)

    def _new_caches(self, b: int, window: int, device=None,
                    model=None) -> list:
        """Zeroed model-dtype (k, v) caches of `window` slots per layer of
        `model` (default: the engine's weights) on `device` (default: the
        engine's)."""
        model = model or self.weights
        shape = (b, window, model.n_heads, model.d_model // model.n_heads)
        return [tuple(torch.zeros(shape, dtype=model.dtype,
                                  device=device or self.device)
                      for _ in range(2))
                for _ in range(model.n_layers)]

    # -- chunked prefill (the JAX prefill_chunk0/chunk/finish and
    # resume_init programs) ------------------------------------------------

    def _prefill_chunk0(self, w0: int, tokens: torch.Tensor,
                        true_len: torch.Tensor) -> tuple:
        """Chunk 0 of a chunked prefill, at slot 0: allocates the window-
        `w0` caches and seeds the running last-prompt-position logits.
        At slot 0 the chunk's attention is causal self-attention over the
        chunk, so from `_PREFILL_FLASH_MIN` tokens up it runs the flash
        kernel, as a whole-prompt prefill does."""
        b, cl = tokens.shape
        caches = self._new_caches(b, w0)
        logits = _forward_with_cache(self.weights, tokens, caches, 0)
        idx = torch.clamp(true_len - 1, 0, cl - 1)
        return caches, logits[torch.arange(b, device=logits.device), idx]

    def _prefill_chunk(self, tokens: torch.Tensor, caches: list,
                       last: torch.Tensor, true_len: torch.Tensor,
                       c0: int) -> tuple:
        """One later prompt segment at slot offset `c0` > 0 (a chunk, or a
        resumed suffix), written into `caches` in place through the dense
        full-cache branch.  Rows whose last prompt token falls inside the
        segment take its logits there; the rest keep `last`."""
        b, cl = tokens.shape
        width = int(caches[0][0].shape[1])
        if not 0 < c0 <= c0 + cl <= width:
            raise ValueError(
                f"prefill segment [{c0}, {c0 + cl}) does not fit a cache "
                f"window of {width} slots at an offset past 0")
        logits = _forward_with_cache(self.weights, tokens, caches, c0)
        idx = torch.clamp(true_len - 1 - c0, 0, cl - 1)
        cand = logits[torch.arange(b, device=logits.device), idx]
        here = (true_len - 1 >= c0) & (true_len - 1 < c0 + cl)
        return caches, torch.where(here[:, None], cand, last)

    def _prefill_finish(self, caches: list, last: torch.Tensor,
                        live: torch.Tensor, row_seeds: list) -> tuple:
        """Sample the first token from the last prompt position's logits
        and, for an int8 cache, quantize the whole prompt cache once
        (decode steps quantize each token as they write it)."""
        tok, done = self._first_token(last, live, row_seeds)
        if self.cache_dtype == "int8":
            caches = [quantize_kv(kc) + quantize_kv(vc)
                      for kc, vc in caches]
        return tok, done, caches

    def _resume_init(self, w0: int, row_caches: list) -> tuple:
        """Open a resumed prefill from donor prefix rows: int8 rows
        dequantize to the model dtype as the JAX program does
        (`(kq.float() * scale).to(dtype)`), every row is copied into
        fresh window-`w0` caches (never a view of the donor: the suffix
        writes into them in place), and the running logits start at zero
        (the suffix always holds the last prompt position)."""
        dtype, caches = self.weights.dtype, []
        for layer in row_caches:
            if len(layer) == 4:
                kq, ks, vq, vs = layer
                layer = ((kq.float() * ks[..., None]).to(dtype),
                         (vq.float() * vs[..., None]).to(dtype))
            fresh = []
            for t in layer:
                out = torch.zeros((t.shape[0], w0) + tuple(t.shape[2:]),
                                  dtype=dtype, device=self.device)
                out[:, :t.shape[1]] = t.to(self.device)
                fresh.append(out)
            caches.append(tuple(fresh))
        b = int(row_caches[0][0].shape[0])
        return caches, torch.zeros((b, self.weights.vocab_size),
                                   device=self.device)

    def _run_chunked_prefill(self, prompts: torch.Tensor,
                             true_len: torch.Tensor, live: torch.Tensor,
                             row_seeds: list) -> tuple:
        """The host loop of a chunked prefill (`generate`): chunk 0, the
        later chunks at their offsets, then the finish; the same
        (tok, done, caches) contract and first token as `prefill`."""
        b, p = prompts.shape
        cl = self.prefill_chunk
        w0 = _round_up(p + 1, self.chunk)
        with trace_span("decode.prefill_chunk", cat="bucket", bucket=p,
                        batch=b, chunk=cl, index=0):
            caches, last = self._prefill_chunk0(w0, prompts[:, :cl],
                                                true_len)
        self._program("prefill_chunk0", b, cl, w0)
        for ci in range(1, p // cl):
            with trace_span("decode.prefill_chunk", cat="bucket", bucket=p,
                            batch=b, chunk=cl, index=ci):
                caches, last = self._prefill_chunk(
                    prompts[:, ci * cl:(ci + 1) * cl], caches, last,
                    true_len, ci * cl)
            self._program("prefill_chunk", b, cl, w0)
        out = self._prefill_finish(caches, last, live, row_seeds)
        self._program("prefill_finish", b, w0)
        return out

    def _chunks_prefill(self, bucket: int) -> bool:
        return self.serve_prefill_chunks(bucket) > 0

    def _ring_prefill(self, prompts, true_len, ring) -> tuple:
        """Distributed blockwise prefill of one data group (JAX
        `seq_prefill_impl` and `_seq_prefill_block`): (the last prompt
        token's logits (B, V) f32, per-layer caches of per-shard slabs)."""
        n = len(ring)
        b, p = prompts.shape
        s_l = p // n
        shards = [self.weights.on(dev) for dev in ring]
        home, dtype, n_heads = shards[0], self.weights.dtype, \
            self.weights.n_heads
        xs = []
        for i, (dev, w) in enumerate(zip(ring, shards)):
            # shared positions: the slab's global offset, as one forward
            # over the whole prompt would see them
            tokens = prompts[:, i * s_l:(i + 1) * s_l].to(dev)
            positions = i * s_l + torch.arange(s_l, device=dev)
            xs.append((w.tok_embed.weight[tokens]
                       + w.pos_embed.weight[positions][None]).to(dtype))
        w0 = _round_up(p + 1, self.chunk)
        caches = []
        for layer in range(self.weights.n_layers):
            blocks = [w.blocks[layer] for w in shards]
            q, k, v = zip(*(_qkv(blk, n_heads, x, dtype)
                            for blk, x in zip(blocks, xs)))
            k, v = ([t.contiguous() for t in part] for part in (k, v))
            o = ring_attention([t.contiguous() for t in q], k, v, causal=True)
            xs = [_block_tail(blk, x, oi, dtype)
                  for blk, x, oi in zip(blocks, xs, o)]
            # the window's slab boundaries are not the prompt's
            k, v = (reshard(t, w0, ring, _WINDOW_DIM) for t in (k, v))
            if self.cache_dtype == "int8":
                kq, ks = zip(*map(quantize_kv, k))
                vq, vs = zip(*map(quantize_kv, v))
                caches.append((list(kq), list(ks), list(vq), list(vs)))
            else:
                caches.append((k, v))
        # the last prompt token of each row, from the shard that holds it
        x_last = torch.empty((b, 1, self.weights.d_model), dtype=dtype,
                             device=ring[0])
        for r, t in enumerate(true_len.tolist()):
            x_last[r, 0] = xs[(t - 1) // s_l][r, (t - 1) % s_l].to(ring[0])
        x_last = _ln(home.final_norm_w, x_last, dtype)
        return _dense(home.lm_head, x_last, dtype).float()[:, 0], caches

    def decode_segment(self, seg_len: int, window: int, caches: list,
                       tok: torch.Tensor, done: torch.Tensor,
                       true_len: torch.Tensor, bucket: int, t0: int,
                       row_seeds: list, ring=None) -> tuple:
        """`seg_len` decode steps from step `t0`, attending over `window`
        cache slots (split over `ring`'s shards for a meshed engine).
        Returns (caches, the tokens fed to the steps (B, seg_len), the next
        token, done)."""
        if ring is None:
            caches = [tuple(_grow_cache(c, window) for c in layer)
                      for layer in caches]
            slots = [torch.arange(window, device=self.device)]
        else:
            if caches[0][0][0].shape[_WINDOW_DIM] * len(ring) != window:
                caches = [tuple(reshard(part, window, ring, _WINDOW_DIM)
                                for part in layer) for layer in caches]
            width = window // len(ring)
            slots = [j * width + torch.arange(width, device=dev)
                     for j, dev in enumerate(ring)]
        prompt_visible = [s[None, :] < true_len.to(s.device)[:, None]
                          for s in slots]
        home = self.weights.on(tok.device)
        emitted = []
        for t in range(t0, t0 + seg_len):
            slot = bucket + t
            visible = [pv | ((s >= bucket) & (s <= slot))[None, :]
                       for pv, s in zip(prompt_visible, slots)]
            attend = (functools.partial(_window_read, visible=visible[0],
                                        slot=slot) if ring is None else
                      functools.partial(_sharded_read, visible=visible,
                                        slot=slot))
            logits = _decode_step(home, tok, true_len + t, caches, attend)
            nxt = torch.where(done, tok, self._sample(logits, row_seeds,
                                                      t + 1))
            emitted.append(tok)
            done = done | self._stop_gate(nxt, t + 2)
            tok = nxt
        return caches, torch.stack(emitted, dim=1), tok, done

    # -- speculative decoding (the JAX draft_prefill and spec_round
    # programs) ---------------------------------------------------------

    def _draft_prefill(self, prompts: torch.Tensor) -> list:
        """The draft model's model-dtype caches over a bucket of prompts,
        on the prompts' device: the target's window arithmetic and no
        sampling (the draft's first proposal comes from its first round
        step).  From `_PREFILL_FLASH_MIN` tokens up its attention is the
        flash kernel, as the target's prefill is."""
        dev = prompts.device
        draft = self.draft_weights.on(dev)
        b, p = prompts.shape
        caches = self._new_caches(b, _round_up(p + 1, self.chunk), dev,
                                  draft)
        _forward_with_cache(draft, prompts, caches, 0)
        return caches

    def _draft_token(self, logits: torch.Tensor, row_seeds: list,
                     round_idx: int, j: int) -> tuple:
        """Draft proposal j of a round: the argmax when greedy, else a
        draw from the filtered, tempered draft distribution on the row's
        draft stream.  Returns (tokens (B,), that distribution or None)."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1), None
        filtered = filter_logits(logits / self.temperature, self.top_k,
                                 self.top_p)
        tok = torch.stack([
            _gumbel_draw(filtered[i], _mix(
                _mix(seed, _SPEC_DRAFT_STREAM + round_idx), j))
            for i, seed in enumerate(row_seeds)])
        return tok, torch.softmax(filtered, dim=-1)

    def _accept(self, logits: torch.Tensor, d: torch.Tensor,
                d_dists: list, row_seeds: list, round_idx: int) -> tuple:
        """How many proposals each row accepts, and the token that follows
        them.  Greedy: accept while the proposal is the target's argmax,
        then the target's own next token.  Sampled: standard rejection
        sampling, proposal j kept with probability min(1, p(d)/q(d)) on
        the row's coin stream, then a draw from the residual max(p - q, 0)
        (the target itself past the last proposal) on its residual stream.
        Returns (n_acc (B,), next token (B,))."""
        k = d.shape[1]
        if self.temperature <= 0.0:
            g = torch.argmax(logits, dim=-1)
            n_acc = (d == g[:, :k]).long().cumprod(dim=1).sum(dim=1)
            return n_acc, g.gather(1, n_acc[:, None])[:, 0]
        b, s, v = logits.shape
        pt = torch.softmax(filter_logits(logits / self.temperature,
                                         self.top_k, self.top_p), dim=-1)
        qd = torch.stack(d_dists, dim=1)                       # (B, k, V)
        pt_d = pt[:, :k].gather(2, d[..., None])[..., 0]
        qd_d = qd.gather(2, d[..., None])[..., 0]
        u = torch.empty((b, k), device=logits.device)
        gen = torch.Generator(device=logits.device)
        for i, seed in enumerate(row_seeds):
            gen.manual_seed(_mix(seed, _SPEC_COIN_STREAM + round_idx))
            u[i] = torch.rand(k, generator=gen, device=logits.device)
        accept = u * torch.clamp(qd_d, min=1e-30) < pt_d
        n_acc = accept.long().cumprod(dim=1).sum(dim=1)
        # the residual at each row's first rejected position; past the last
        # proposal the draft distribution is empty and it is the target's
        at = n_acc[:, None, None].expand(b, 1, v)
        p_at = pt.gather(1, at)[:, 0]
        q_at = torch.cat([qd, torch.zeros_like(qd[:, :1])], dim=1).gather(
            1, at)[:, 0]
        res = torch.clamp(p_at - q_at, min=0.0)
        res = torch.where(res.sum(dim=-1, keepdim=True) > 1e-30, res, p_at)
        res_logits = torch.where(res > 0, torch.log(torch.clamp(
            res, min=1e-38)), NEG_INF)
        corr = torch.stack([
            _gumbel_draw(res_logits[i], _mix(
                _mix(seed, _SPEC_FIX_STREAM + round_idx), int(n_acc[i])))
            for i, seed in enumerate(row_seeds)])
        return n_acc, corr

    def _spec_round(self, window: int, caches: list, draft_caches: list,
                    tok: torch.Tensor, done: torch.Tensor,
                    true_len: torch.Tensor, budget: torch.Tensor,
                    bucket: int, t_row: torch.Tensor, round_idx: int,
                    row_seeds: list) -> tuple:
        """One speculative round over a batch whose rows sit at per-row
        steps `t_row` (the JAX `spec_round_impl`; `generate` and the
        serving engine share it), on the device of `tok`:

          * the draft's k+1 single-token steps through the per-row decode
            step (the decode kernel reads its cache), proposals from the
            first k; the last step only writes the last proposal's K/V, so
            the draft never reads a zero slot;
          * ONE target forward over [tok, d_1..d_k] (`_verify_step_rows`),
            token t_row+j's K/V at slot bucket+t_row+j as the per-step
            path writes it;
          * the agreeing prefix plus one token commits, each committed
            token passing the stop and budget freezes of the per-step
            path.  Rejected proposals leave K/V past a row's frontier that
            no committed query sees and the next round overwrites.

        Returns (caches, draft_caches, toks (B, k+1), counts (B,), tok,
        done, accepted (B,)): row r's first counts[r] entries of toks are
        committed tokens (the rest repeat the frozen token); `accepted` is
        the draft/target agreement length (0 for a row done on entry)."""
        dev = tok.device
        target, draft = self.weights.on(dev), self.draft_weights.on(dev)
        caches = [tuple(_grow_cache(c, window) for c in layer)
                  for layer in caches]
        draft_caches = [tuple(_grow_cache(c, window) for c in layer)
                        for layer in draft_caches]
        k = self.spec_tokens
        s = k + 1
        slots = torch.arange(window, device=dev)
        max_pos = target.max_len - 1
        prompt_visible = slots[None, :] < true_len[:, None]
        decode_slots = slots[None, :] >= bucket
        d_toks, d_dists = [], []
        cur = tok
        for j in range(s):
            t = t_row + j
            slot = torch.clamp(bucket + t, max=window - 1)
            visible = prompt_visible | (decode_slots
                                        & (slots[None, :] <= slot[:, None]))
            logits = _decode_step(
                draft, cur, torch.clamp(true_len + t, max=max_pos),
                draft_caches, functools.partial(_window_read,
                                                visible=visible, slot=slot))
            if j == k:
                break           # K/V back-fill only; the proposal is unused
            cur, dist = self._draft_token(logits, row_seeds, round_idx, j)
            d_toks.append(cur)
            d_dists.append(dist)
        d = torch.stack(d_toks, dim=1)                          # (B, k)
        slots0 = torch.clamp(bucket + t_row, max=window - s)
        last = slots0[:, None] + torch.arange(s, device=dev)[None, :]
        visible = prompt_visible[:, None, :] | (
            decode_slots[:, None, :] & (slots[None, None, :]
                                        <= last[:, :, None]))
        logits = _verify_step_rows(target, torch.cat([tok[:, None], d], 1),
                                   true_len + t_row, slots0, caches, visible)
        n_acc, corr = self._accept(logits, d, d_dists, row_seeds, round_idx)
        # commit: positions 0..n_acc are real (the accepted prefix, then
        # the correction or bonus token)
        seq = torch.where(torch.arange(s, device=dev)[None, :]
                          < n_acc[:, None],
                          torch.cat([d, torch.zeros_like(d[:, :1])], 1),
                          corr[:, None])
        accepted = torch.where(done, 0, n_acc)
        out_toks = []
        count = torch.zeros_like(t_row)
        cur = tok
        for i in range(s):
            live = ~done & (i <= n_acc)
            cur = torch.where(live, seq[:, i], cur)
            idx = t_row + 1 + i                 # the token's global index
            done = done | (live & (self._stop_gate(cur, idx + 1)
                                   | (idx >= budget)))
            count = count + live.long()
            out_toks.append(cur)
        return (caches, draft_caches, torch.stack(out_toks, dim=1), count,
                cur, done, accepted)

    def _generate_speculative(self, prompts: np.ndarray, tl_host: np.ndarray,
                              live: np.ndarray, row_seeds: list,
                              groups: list) -> np.ndarray:
        """The speculative form of `generate`: per data group the target
        prefill (chunked or whole: the same functions), the draft
        prefill, then rounds until every row freezes or fills its budget,
        the window growing with the group's oldest row as the serving
        path's does."""
        k, max_new = self.spec_tokens, self.max_new_tokens
        b, p = prompts.shape
        out = np.zeros((b, max_new), np.int32)
        rounds = drafted = accepted_total = new_computed = 0
        with torch.inference_mode():
            for rows, ring in groups:
                dev = self.device if ring is None else ring[0]
                n = len(row_seeds[rows])
                prompts_t = torch.as_tensor(prompts[rows], dtype=torch.long,
                                            device=dev)
                tl = torch.as_tensor(tl_host[rows], dtype=torch.long,
                                     device=dev)
                args = (prompts_t, tl, torch.as_tensor(live[rows],
                                                       device=dev),
                        row_seeds[rows])
                with trace_span("decode.prefill", cat="bucket", bucket=p,
                                batch=n, speculative=True):
                    if ring is None and self._chunks_prefill(p):
                        tok, done, caches = self._run_chunked_prefill(*args)
                    else:
                        tok, done, caches = self.prefill(*args, ring)
                        if ring is not None:
                            # one seq shard: its slab is the whole window
                            caches = [tuple(part[0] for part in layer)
                                      for layer in caches]
                    dcaches = self._draft_prefill(prompts_t)
                group_out = out[rows]
                group_out[:, 0] = tok.cpu().numpy()
                emitted = np.ones(n, np.int64)
                t_row = np.zeros(n, np.int64)
                # freeze once a row's newest token index reaches max_new-1
                budget = torch.full((n,), max_new - 1, dtype=torch.long,
                                    device=dev)
                done_h = done.cpu().numpy()
                g_rounds = 0
                while not done_h.all():
                    w_in = int(caches[0][0].shape[1])
                    window = max(self.serve_window(p, int(t_row.max()),
                                                   k + 1),
                                 w_in, int(dcaches[0][0].shape[1]))
                    with trace_span("decode.spec_round", cat="segment",
                                    window=window, round=g_rounds):
                        (caches, dcaches, toks, counts, tok, done,
                         acc) = self._spec_round(
                            window, caches, dcaches, tok, done, tl, budget,
                            p, torch.as_tensor(t_row, device=dev), g_rounds,
                            row_seeds[rows])
                    self._program("spec_round", n, w_in, window, k)
                    toks_h, counts_h = toks.cpu().numpy(), counts.cpu().numpy()
                    drafted += int((counts_h > 0).sum()) * k
                    accepted_total += int(acc.sum())
                    for r in np.nonzero(counts_h)[0]:
                        take = min(int(counts_h[r]), max_new - int(emitted[r]))
                        group_out[r, emitted[r]:emitted[r] + take] = \
                            toks_h[r, :take]
                        emitted[r] += take
                    t_row = t_row + counts_h
                    done_h = done.cpu().numpy()
                    g_rounds += 1
                tok_h = tok.cpu().numpy()
                for r in range(n):
                    # a row frozen early repeats its stop token, as the
                    # non-speculative fill does
                    group_out[r, emitted[r]:] = tok_h[r]
                out[rows] = group_out
                rounds += g_rounds
                new_computed = max(new_computed, int(emitted.max()))
        rate = accepted_total / drafted if drafted else 0.0
        self.last_spec_rounds = rounds
        self.last_spec_drafted = drafted
        self.last_spec_accepted = accepted_total
        self.last_spec_acceptance = rate
        self.last_segments_run = rounds
        self.last_new_tokens_computed = new_computed
        self.last_exit_checks_skipped = 0
        inc_counter("decode.spec_drafted_tokens", drafted)
        inc_counter("decode.spec_accepted_tokens", accepted_total)
        run = active_run()
        if run is not None:
            run.gauge("decode.spec_acceptance_rate", round(rate, 4))
            run.gauge("decode.spec_rounds", rounds)
        return out

    def _groups(self, b: int) -> list:
        """(row slice, seq ring or None) per data group."""
        if self.mesh is None:
            return [(slice(0, b), None)]
        rings = self.mesh.seq_rings()
        if b % len(rings):
            raise ValueError(
                f"batch ({b}) must divide by the mesh data axis "
                f"({len(rings)}); pad it with not-live rows")
        rows = b // len(rings)
        return [(slice(g * rows, (g + 1) * rows), ring)
                for g, ring in enumerate(rings)]

    def generate(self, prompts, true_len, *, seed: int = 0, row_ids=None,
                 live=None) -> np.ndarray:
        """Generate `max_new_tokens` per row: prompts (B, bucket) int
        right-padded, true_len (B,) per-row prompt lengths.  Returns the
        GENERATED region (B, max_new_tokens) int32; after a row's first
        stop token the remaining slots repeat it.  `row_ids` are the
        per-row sampling-stream ids (default 0..B-1); `live=False` rows
        are born done."""
        prompts = np.asarray(prompts)
        b, p = prompts.shape
        tl_host = np.asarray(true_len)
        if int(tl_host.max()) > p:
            raise ValueError(
                f"true_len ({int(tl_host.max())}) exceeds the prompt "
                f"bucket width ({p})")
        if int(tl_host.max()) + self.max_new_tokens > self.weights.max_len:
            raise ValueError(
                f"prompt_len ({int(tl_host.max())}) + max_new_tokens "
                f"({self.max_new_tokens}) exceeds the model's max_len "
                f"({self.weights.max_len})")
        if p % self.seq_shards:
            raise ValueError(
                f"prompt bucket ({p}) must divide by the mesh seq axis "
                f"({self.seq_shards}) for distributed blockwise prefill "
                "(pad the bucket; true_len already handles the tail)")
        groups = self._groups(b)
        ids = range(b) if row_ids is None else [int(i) for i in row_ids]
        row_seeds = [_mix(int(seed), i) for i in ids]
        live = np.ones(b, bool) if live is None else np.asarray(live, bool)
        if self.spec_tokens:
            return self._generate_speculative(prompts, tl_host, live,
                                              row_seeds, groups)
        check_exit = bool(self.stop_tokens)
        parts = [[] for _ in groups]
        segments_run = exit_checks_skipped = 0
        with torch.inference_mode():
            states = []
            for rows, ring in groups:
                dev = self.device if ring is None else ring[0]
                tl = torch.as_tensor(tl_host[rows], dtype=torch.long,
                                     device=dev)
                args = (torch.as_tensor(prompts[rows], dtype=torch.long,
                                        device=dev), tl,
                        torch.as_tensor(live[rows], device=dev),
                        row_seeds[rows])
                # a meshed engine's ring prefill already splits the prompt
                tok, done, caches = (
                    self._run_chunked_prefill(*args)
                    if ring is None and self._chunks_prefill(p)
                    else self.prefill(*args, ring))
                states.append([caches, tok, done, tl])
            for t0, seg_len, window in decode_segments(
                    p, self.max_new_tokens, self.chunk):
                if check_exit and t0 + 1 < self.min_new_tokens:
                    # no row can be done before the stop floor: skip the
                    # device->host sync
                    exit_checks_skipped += 1
                elif check_exit and all(bool(st[2].all()) for st in states):
                    break
                for (rows, ring), st, out in zip(groups, states, parts):
                    caches, tok, done, tl = st
                    caches, toks, tok, done = self.decode_segment(
                        seg_len, window, caches, tok, done, tl, p, t0,
                        row_seeds[rows], ring)
                    st[:3] = caches, tok, done
                    out.append(toks)
                segments_run += 1
            generated = np.concatenate([
                torch.cat(out + [st[1][:, None]], dim=1).cpu().numpy()
                for out, st in zip(parts, states)])
        self.last_segments_run = segments_run
        self.last_new_tokens_computed = generated.shape[1]
        self.last_exit_checks_skipped = exit_checks_skipped
        if generated.shape[1] < self.max_new_tokens:
            # early exit: every row is frozen on its stop token
            fill = np.repeat(generated[:, -1:],
                             self.max_new_tokens - generated.shape[1], axis=1)
            generated = np.concatenate([generated, fill], axis=1)
        return generated.astype(np.int32)

    # -- serving hooks (serve/engine.py) ---------------------------------
    # The continuous-batching scheduler drives the engine at segment
    # granularity: prefill a join cohort, splice its cache rows into the
    # resident batch, advance everyone one mixed-age segment, cancel and
    # harvest at the boundary.  Each hook enters inference mode itself:
    # the scheduler's loop thread does not inherit the caller's grad mode,
    # and the resident caches are inference tensors, written in place.

    def _refuse_seq(self, hook: str) -> None:
        """Serving hooks refuse a seq-sharded engine: per-row cache
        writes, row splices and cache pages assume whole-window rows on
        one device."""
        if self.seq_shards > 1:
            raise ValueError(
                f"{hook} does not support a seq-sharded engine (mesh "
                f"seq={self.seq_shards}): serving assumes whole-window "
                "cache rows; use DecodeEngine.generate / TextGenerator "
                "for seq-parallel long-context decode")

    def serve_prefill(self, prompts, true_len, live, row_seeds) -> tuple:
        """Prefill one join cohort: prompts (N, bucket) right-padded,
        per-row true lengths, `live=False` born-done pad rows, per-row
        sampling streams (`_mix(seed, request id)`).  Returns (tok, done,
        caches): the cohort's first generated token per row and its
        bucket-window caches, ready to splice into a resident batch with
        `merge_cache_rows`.  Prompts take numpy arrays or tensors."""
        self._refuse_seq("serve_prefill")
        dev = self.device
        prompts = _to_device(prompts, torch.long, dev)
        with torch.inference_mode():
            out = self.prefill(
                prompts, _to_device(true_len, torch.long, dev),
                _to_device(live, torch.bool, dev), list(row_seeds))
        self._program("prefill", *prompts.shape)
        return out

    def serve_step(self, caches, tok, done, true_len, budget, bucket: int,
                   t_row, row_seeds, seg_len: int, window: int) -> tuple:
        """Advance a mixed-age resident batch `seg_len` decode steps (the
        JAX `serve_segment_impl`): per-row step offsets `t_row` (a joined
        row starts at 0 while resident rows are mid-generation) and
        per-row token budgets.  Returns (caches, toks (B, seg_len), tok,
        done): `toks` holds the tokens each step PRODUCED, a frozen row
        repeating its token.  A row freezes on a stop token, when its
        budget is spent (t + 1 >= budget), or when it was done already;
        a free slot is born done.  Row r writes its K/V at slot
        bucket + t_row[r] + step, clamped into the window, and reads
        under its own visibility mask through the decode kernel (K4).
        `window` must cover the highest slot a live row writes
        (`serve_window`); a resident cache never shrinks."""
        self._refuse_seq("serve_step")
        dev = self.device
        b = len(row_seeds)
        w_in = int(caches[0][0].shape[1])
        window = max(int(window), w_in)
        max_pos = self.weights.max_len - 1
        with torch.inference_mode():
            tok, done = (_to_device(tok, torch.long, dev),
                         _to_device(done, torch.bool, dev))
            true_len = _to_device(true_len, torch.long, dev)
            budget, t_row = (_to_device(x, torch.long, dev)
                             for x in (budget, t_row))
            caches = [tuple(_grow_cache(c, window) for c in layer)
                      for layer in caches]
            slots = torch.arange(window, device=dev)[None, :]
            prompt_visible = slots < true_len[:, None]
            emitted = []
            for s_off in range(seg_len):
                t = t_row + s_off                      # (B,) per-row step
                slot = torch.clamp(bucket + t, max=window - 1)
                visible = prompt_visible | ((slots >= bucket)
                                            & (slots <= slot[:, None]))
                logits = _decode_step(
                    self.weights, tok, torch.clamp(true_len + t, max=max_pos),
                    caches, functools.partial(_window_read, visible=visible,
                                              slot=slot))
                nxt = torch.where(done, tok,
                                  self._sample(logits, row_seeds, t + 1))
                done = done | self._stop_gate(nxt, t + 2) | (t + 1 >= budget)
                emitted.append(nxt)
                tok = nxt
            toks = torch.stack(emitted, dim=1)
        self._program("serve_segment", b, w_in, window, seg_len)
        return caches, toks, tok, done

    def serve_window(self, bucket: int, max_t: int, seg_len: int) -> int:
        """The chunk-rounded cache window covering a segment whose oldest
        live row sits at step `max_t`, capped at the model's position
        budget (frozen rows past the cap clamp their writes in-window)."""
        need = min(bucket + max_t + seg_len, self.weights.max_len)
        return _round_up(max(need, bucket + 1), self.chunk)

    def serve_prefill_chunks(self, bucket: int) -> int:
        """How many chunks a chunked prefill of this bucket runs (0 = the
        whole-prompt prefill applies: chunking off, a bucket no larger
        than the chunk, or one the chunk does not divide).  Buckets are
        powers of two (or the model's cap), so a power-of-two chunk
        divides every power-of-two bucket larger than itself."""
        cl = self.prefill_chunk
        if not cl or bucket <= cl or bucket % cl:
            return 0
        return bucket // cl

    def serve_prefill_chunk(self, prompts, true_len, index: int,
                            state) -> tuple:
        """Run chunk `index` of a join cohort's chunked prefill; `state` is
        None for chunk 0, else the (caches, last logits) the previous
        chunk returned (its caches are written in place).  The scheduler
        interleaves these calls with resident decode segments, so a long
        prompt does not stall running rows."""
        self._refuse_seq("serve_prefill_chunk")
        prompts = np.asarray(prompts)
        b, p = prompts.shape
        cl = self.prefill_chunk
        w0 = _round_up(p + 1, self.chunk)
        tokens = _to_device(prompts[:, index * cl:(index + 1) * cl],
                            torch.long, self.device)
        tl = _to_device(true_len, torch.long, self.device)
        with torch.inference_mode():
            if index == 0:
                state = self._prefill_chunk0(w0, tokens, tl)
                self._program("prefill_chunk0", b, cl, w0)
            else:
                caches, last = state
                state = self._prefill_chunk(tokens, caches, last, tl,
                                            index * cl)
                self._program("prefill_chunk", b, cl, w0)
        return state

    def serve_prefill_finish(self, state, live, row_seeds) -> tuple:
        """Close a chunked (or resumed) serve prefill: the same (tok,
        done, caches) contract as `serve_prefill`, ready for
        `merge_cache_rows`."""
        self._refuse_seq("serve_prefill_finish")
        caches, last = state
        b, w0 = int(last.shape[0]), int(caches[0][0].shape[1])
        with torch.inference_mode():
            out = self._prefill_finish(
                caches, last, _to_device(live, torch.bool, self.device),
                list(row_seeds))
        self._program("prefill_finish", b, w0)
        return out

    def serve_resume_chunks(self, bucket: int, prefix_len: int) -> int:
        """How many SUFFIX chunks a chunk-interleaved resume from a
        `prefix_len`-token donor prefix runs (0 = resume inline through
        `serve_prefill_resume`: chunking off for this bucket, or a prefix
        that is not chunk-aligned)."""
        total = self.serve_prefill_chunks(bucket)
        cl = self.prefill_chunk
        if (not total or prefix_len <= 0 or prefix_len >= bucket
                or prefix_len % cl):
            return 0
        return total - prefix_len // cl

    def serve_resume_init(self, row_caches, bucket: int) -> tuple:
        """Open a resumed prefill from donor prefix rows (a prefix pool
        hit's chunk payloads, joined on the slot axis; either cache
        layout): dequantize and copy them into the bucket's window and
        zero the running logits — a (caches, last) state that
        `serve_prefill_chunk` (index >= 1) and `serve_prefill_finish`
        continue.  The donor tensors are only read."""
        self._refuse_seq("serve_resume_init")
        w0 = _round_up(bucket + 1, self.chunk)
        b = int(row_caches[0][0].shape[0])
        n = int(row_caches[0][0].shape[1])
        with torch.inference_mode():
            state = self._resume_init(w0, row_caches)
        self._program("resume_init", b, n, w0, len(row_caches[0]))
        return state

    def serve_prefill_resume(self, prompts, true_len, prefix_len: int,
                             row_caches, live, row_seeds) -> tuple:
        """Prefill ONLY the novel suffix of prompts whose first
        `prefix_len` tokens have donor cache rows (a prefix pool hit):
        one segment at offset `prefix_len` over the whole suffix through
        the dense full-cache branch, then the finish — the suffix attends
        the donor slots as a fresh prefill attends its own, so greedy
        tokens are a fresh prefill's.  Same (tok, done, caches) contract
        as `serve_prefill`."""
        self._refuse_seq("serve_prefill_resume")
        prompts = np.asarray(prompts)
        b, p = prompts.shape
        if not 0 < prefix_len < p:
            raise ValueError(
                f"prefix_len ({prefix_len}) must be inside the bucket "
                f"({p})")
        caches, last = self.serve_resume_init(row_caches, p)
        w0 = int(caches[0][0].shape[1])
        with torch.inference_mode():
            state = self._prefill_chunk(
                _to_device(prompts[:, prefix_len:], torch.long, self.device),
                caches, last, _to_device(true_len, torch.long, self.device),
                prefix_len)
        self._program("prefill_chunk", b, p - prefix_len, w0)
        return self.serve_prefill_finish(state, live, row_seeds)

    def serve_draft_prefill(self, prompts) -> list:
        """Prefill the draft model's caches for a join cohort (speculative
        serving): the draft caches to splice beside the target's
        (`merge_cache_rows` takes both)."""
        self._refuse_seq("serve_draft_prefill")
        prompts = _to_device(prompts, torch.long, self.device)
        with torch.inference_mode():
            caches = self._draft_prefill(prompts)
        self._program("draft_prefill", *prompts.shape)
        return caches

    def serve_spec_round(self, caches, draft_caches, tok, done, true_len,
                         budget, bucket: int, t_row, round_idx: int,
                         row_seeds, window: int) -> tuple:
        """One speculative round over the resident batch (the round
        `generate` runs, with per-row steps and budgets): returns
        (caches, draft_caches, toks (B, k+1), counts, tok, done,
        accepted); the scheduler advances each row's step by its count
        and emits that prefix of its toks.  Writes the caches in place
        where they need no growth."""
        self._refuse_seq("serve_spec_round")
        dev = self.device
        b = len(row_seeds)
        w_in = int(caches[0][0].shape[1])
        window = max(int(window), w_in, int(draft_caches[0][0].shape[1]))
        with torch.inference_mode():
            out = self._spec_round(
                window, caches, draft_caches,
                _to_device(tok, torch.long, dev),
                _to_device(done, torch.bool, dev),
                _to_device(true_len, torch.long, dev),
                _to_device(budget, torch.long, dev), int(bucket),
                _to_device(t_row, torch.long, dev), int(round_idx),
                list(row_seeds))
        self._program("spec_round", b, w_in, window, self.spec_tokens)
        return out

    @staticmethod
    def merge_cache_rows(dst_caches, src_caches, dst_rows, src_rows,
                         mesh=None) -> list:
        """Splice cohort cache rows into a resident batch: row
        `src_rows[i]` of `src_caches` replaces row `dst_rows[i]` of
        `dst_caches`.  Both sides are grown to the wider window first
        (zero-pad), so a freshly prefilled cohort joins a long-running
        batch.  Both cache layouts (2-tuple model dtype, 4-tuple int8) work:
        every tensor is row-indexed on axis 0.  Returns the merged caches;
        a `dst_caches` tensor that needs no growth is written in place.
        `mesh`: the JAX signature's; a seq > 1 mesh is refused."""
        if mesh is not None and mesh.shape[SEQ_AXIS] > 1:
            raise ValueError(
                "merge_cache_rows refuses seq-sharded caches (mesh seq>1): "
                "row splicing assumes whole-window rows")
        window = max(dst_caches[0][0].shape[1], src_caches[0][0].shape[1])
        with torch.inference_mode():
            merged = []
            for dst_layer, src_layer in zip(dst_caches, src_caches):
                layer = []
                for d, s in zip(dst_layer, src_layer):
                    d = _grow_cache(d, window)
                    di = torch.as_tensor(list(dst_rows), dtype=torch.long,
                                         device=d.device)
                    si = torch.as_tensor(list(src_rows), dtype=torch.long,
                                         device=s.device)
                    d[di] = _grow_cache(s, window)[si].to(d.device)
                    layer.append(d)
                merged.append(tuple(layer))
        return merged

    @property
    def compiled_programs(self) -> int:
        """Distinct shape classes the serving hooks have run so far (the
        JAX engine's compiled programs: a prefill per (cohort, bucket), a
        segment per (batch, window in, window, steps)).  Nothing compiles
        here; warmup's coverage and a per-class CUDA graph read it."""
        return len(self._programs)

    def _program(self, *key) -> None:
        """Register one executed shape class; a NEW class surfaces as a
        telemetry `recompile` event, as in the JAX engine."""
        if key not in self._programs:
            self._programs.add(key)
            trace_event("recompile", cat="compile", where="decode",
                        program=str(key))


def _to_device(x, dtype, device) -> torch.Tensor:
    """A host array, list or tensor as a `dtype` tensor on `device`."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                           dtype=dtype, device=device)


def _window_read(cache: tuple, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, visible: torch.Tensor,
                 slot: int) -> torch.Tensor:
    """One layer's decode read over the whole window: write the token at
    the shared `slot`, then the normalized fused cache read."""
    _write_token(cache, slot, k, v)
    kc, vc, scales = _cache_read_args(cache)
    return fused_single_query_attention(q, kc, vc, visible, **scales)


def _sharded_read(cache: tuple, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, visible: list, slot: int) -> torch.Tensor:
    """One layer's decode read over a window split into per-shard slabs
    (JAX `_seq_decode_block`): the shard owning global `slot` writes the
    token (quantizing it for an int8 cache), every shard reads its slab
    through the stats kernel under its slice of the mask, and the triples
    merge on q's device.  `cache` holds per-shard slab lists."""
    width = cache[0][0].shape[_WINDOW_DIM]
    owner, local = divmod(slot, width)
    _write_token(tuple(part[owner] for part in cache), local, k, v)
    stats = []
    for j, vis in enumerate(visible):
        kc, vc, scales = _cache_read_args(tuple(part[j] for part in cache))
        stats.append(fused_single_query_attention_stats(
            q.to(kc.device), kc, vc, vis, **scales))
    return merge_attention_stats(*zip(*stats))


# ---------------------------------------------------------------------------
# The pipeline stage
# ---------------------------------------------------------------------------

class TextGenerator(Transformer):
    """Pipeline Transformer: a token-prompt column in, prompt + generated
    tokens out, decoded through the `DecodeEngine` with rows grouped by
    prompt bucket.  Output rows align with input rows.  With `stopTokens`
    set, each row is trimmed after its first stop token (kept) at or past
    the `minNewTokens` floor.  `beamWidth > 0` runs beam search instead
    (`make_beam_search_fn`, rows grouped by prompt length) and emits each
    row's best beam; `specTokens > 0` decodes speculatively with the draft
    set by `set_draft_bundle`.

    `device` (default "cuda") is where the model runs; it is a run-time
    setting, not a param, and is not saved."""

    inputCol = Param(None, "column of int token-id prompt arrays",
                     ptype=str)
    outputCol = Param("generated", "output column (prompt + new tokens)",
                      ptype=str)
    maxNewTokens = Param(32, "tokens to generate per row", ptype=int,
                         validator=lambda v: v > 0)
    temperature = Param(0.0, "0 = greedy; > 0 samples with this "
                        "temperature", ptype=float,
                        validator=lambda v: v >= 0)
    topK = Param(0, "sample only among the k most probable tokens "
                 "(0 = off; ignored when greedy)", ptype=int,
                 validator=lambda v: v >= 0)
    topP = Param(1.0, "nucleus sampling: smallest probability mass to "
                 "sample within (1.0 = off; ignored when greedy)",
                 ptype=float, validator=lambda v: 0 < v <= 1)
    beamWidth = Param(0, "deterministic beam search width; each row "
                      "emits its best beam (0 = off; overrides "
                      "temperature/topK/topP, stopTokens and kvCacheDtype; "
                      "rows grouped by prompt length)", ptype=int,
                      validator=lambda v: v >= 0)
    seed = Param(0, "sampling seed (ignored when greedy); each row's "
                 "stream also folds in its table position", ptype=int)
    stopTokens = Param(None, "token ids that end a row's generation: the "
                       "row is trimmed after its first stop token (kept), "
                       "and a batch whose rows have all stopped exits "
                       "decode early (None/empty = off)", ptype=(list, tuple))
    cacheChunk = Param(DEFAULT_CACHE_CHUNK, "decode cache-window growth "
                       "granularity in slots", ptype=int,
                       validator=lambda v: v >= 1)
    kvCacheDtype = Param(None, "decode KV-cache storage dtype: 'int8' "
                         "stores the cache quantized per head; None/"
                         "'model' keeps the module's own dtype", ptype=str,
                         domain=("model", "int8"))
    minNewTokens = Param(1, "suppress stop tokens until a row has "
                         "generated this many tokens (including the stop "
                         "itself)", ptype=int, validator=lambda v: v >= 1)
    specTokens = Param(0, "speculative decoding: tokens the draft model "
                       "proposes per verify round (0 = off; requires "
                       "set_draft_bundle).  Greedy outputs stay those of "
                       "plain decoding; sampled ones draw from the same "
                       "target distribution by rejection sampling, on "
                       "other streams", ptype=int,
                       validator=lambda v: v >= 0)
    prefillChunk = Param(0, "chunked prefill: run prompt forwards in "
                         "chunks of this many tokens (0 = whole-prompt); "
                         "a bucket the chunk does not divide, or no "
                         "larger than it, prefills whole", ptype=int,
                         validator=lambda v: v >= 0)

    def __init__(self, bundle: Optional[ModelBundle] = None, device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self._bundle = bundle
        self._weights = None
        self._draft_bundle = None
        self._draft_weights = None
        self._mesh = None
        self._engines: dict = {}

    def set_bundle(self, bundle: ModelBundle) -> "TextGenerator":
        self._bundle = bundle
        self._weights = None
        self._engines = {}
        return self

    def set_draft_bundle(self, bundle: Optional[ModelBundle]
                         ) -> "TextGenerator":
        """The small LM that `specTokens` speculation drafts with
        (`zoo.truncated_draft_bundle` builds one from the target bundle).
        Not saved with the stage: attach again after load."""
        self._draft_bundle = bundle
        self._draft_weights = None
        self._engines = {}
        return self

    def set_mesh(self, mesh) -> "TextGenerator":
        """Generate over a device mesh (the JAX `set_mesh`): rows split over
        'data', zero-padded to whole groups with not-live rows; a 'seq' axis
        > 1 runs the seq-sharded long-context engine.  The model-dtype
        weights are held once per distinct device of the mesh.  Not saved
        with the stage: attach again after load.  `None` detaches."""
        if mesh is not None:
            _check_mesh_axes(mesh)
        self._mesh = mesh
        self._engines = {}
        return self

    @property
    def bundle(self) -> Optional[ModelBundle]:
        return self._bundle

    def _serving_weights(self) -> ServingWeights:
        if self._weights is None:
            # the f32 module is dropped once its Dense weights are cast
            self._weights = ServingWeights(self._bundle.module(self.device))
        return self._weights

    def _beam_fn_for(self, prompt_len: int):
        """The beam search of one prompt length, made once; it runs on
        the stage's device whatever the mesh (each row's search is
        independent of the others)."""
        key = ("beam", prompt_len, self.maxNewTokens, self.beamWidth)
        if key not in self._engines:
            self._engines[key] = make_beam_search_fn(
                self._serving_weights(), prompt_len, self.maxNewTokens,
                self.beamWidth)
        return self._engines[key]

    def _engine_for(self) -> DecodeEngine:
        # greedy ignores the filters: normalize them out of the cache key
        sampling = self.temperature > 0
        top_k = (self.topK or None) if sampling else None
        top_p = self.topP if sampling and self.topP < 1.0 else None
        stops = tuple(int(t) for t in (self.stopTokens or ()))
        kv_dtype = self.kvCacheDtype or "model"
        spec = int(self.specTokens)
        if spec and self._draft_bundle is None:
            raise ValueError(
                "specTokens > 0 needs a draft model; call "
                "set_draft_bundle() (zoo.truncated_draft_bundle builds one)")
        key = (self.maxNewTokens, self.temperature, top_k, top_p, stops,
               self.cacheChunk, kv_dtype, self.minNewTokens,
               self.prefillChunk or None, spec)
        if key not in self._engines:
            if spec and self._draft_weights is None:
                self._draft_weights = ServingWeights(
                    self._draft_bundle.module(self.device))
            self._engines[key] = DecodeEngine(
                self._serving_weights(), self.maxNewTokens,
                temperature=self.temperature, top_k=top_k, top_p=top_p,
                stop_tokens=stops, chunk=self.cacheChunk,
                cache_dtype=kv_dtype, min_new_tokens=self.minNewTokens,
                prefill_chunk=self.prefillChunk or None,
                mesh=self._mesh, device=self.device,
                draft_module=self._draft_weights if spec else None,
                spec_tokens=spec)
        return self._engines[key]

    def _transform_beam(self, rows: list, out: list) -> None:
        """Beam rows: one search per prompt length, each row's best beam."""
        by_len: dict[int, list[int]] = {}
        for i, r in enumerate(rows):
            by_len.setdefault(len(r), []).append(i)
        for plen, idxs in sorted(by_len.items()):
            tokens, _ = self._beam_fn_for(plen)(
                np.stack([rows[i] for i in idxs]))
            for j, i in enumerate(idxs):
                out[i] = tokens[j, 0]

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        if self._bundle is None:
            raise ValueError(
                "TextGenerator has no model bundle; call set_bundle()")
        rows = [np.asarray(r, np.int32) for r in table[self.inputCol]]
        out: list = [None] * len(rows)
        if self.beamWidth > 0:
            self._transform_beam(rows, out)
        else:
            self._transform_engine(rows, out)
        if out and len({len(r) for r in out}) == 1:
            return table.with_column(self.outputCol, np.stack(out))
        result = np.empty(len(out), object)
        for i, r in enumerate(out):
            result[i] = r
        return table.with_column(self.outputCol, result)

    def _transform_engine(self, rows: list, out: list) -> None:
        """Greedy and sampled rows: the bucketed engine."""
        engine = self._engine_for()
        by_bucket: dict[int, list[int]] = {}
        for i, r in enumerate(rows):
            by_bucket.setdefault(engine.bucket_for(len(r)), []).append(i)
        stops = np.asarray(engine.stop_tokens, np.int32)
        groups = 1 if self._mesh is None else self._mesh.shape[DATA_AXIS]
        for bucket, idxs in sorted(by_bucket.items()):
            # pad rows to whole data groups: length-1 zero prompts, born
            # not-live, with stream ids past the table's rows
            pad = -len(idxs) % groups
            prompts = np.zeros((len(idxs) + pad, bucket), np.int32)
            true_len = np.array([len(rows[i]) for i in idxs] + [1] * pad,
                                np.int32)
            for j, i in enumerate(idxs):
                prompts[j, :true_len[j]] = rows[i]
            live = np.arange(len(idxs) + pad) < len(idxs)
            # the per-row sampling-stream id is the row's table position
            got = engine.generate(prompts, true_len, seed=self.seed,
                                  row_ids=list(idxs) + list(
                                      range(len(rows), len(rows) + pad)),
                                  live=live)
            for j, i in enumerate(idxs):
                gen = got[j]
                if stops.size:
                    # stops before the minNewTokens floor were suppressed
                    # by the engine; don't trim at them either
                    start = max(int(self.minNewTokens) - 1, 0)
                    hits = np.isin(gen[start:], stops).nonzero()[0]
                    if hits.size:
                        gen = gen[:start + hits[0] + 1]
                out[i] = np.concatenate([rows[i], gen])

    def _save_extra(self, path: str) -> None:
        if self._bundle is not None:
            save_bundle(self._bundle, f"{path}/bundle")

    def _load_extra(self, path: str, **_init_kwargs) -> None:
        self.set_bundle(load_bundle(f"{path}/bundle")
                        if os.path.exists(f"{path}/bundle") else None)
        self.set_draft_bundle(None)


def naive_generate(module, prompts, max_new_tokens: int) -> np.ndarray:
    """Recompute-everything greedy decoding through the module's forward:
    O(N * S^2) work, no cache.  The parity oracle; never the product
    path."""
    _check_generatable(module)
    with torch.inference_mode():
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                               device=module.device)
        for _ in range(max_new_tokens):
            nxt = torch.argmax(module(toks)[:, -1], dim=-1)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
        return toks.cpu().numpy().astype(np.int32)
