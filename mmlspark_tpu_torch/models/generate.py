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

Not ported yet (they raise NotImplementedError): tensor-parallel decode
(a mesh with model > 1), chunked prefill, speculative decoding, beam
search, the serving hooks.
"""

from __future__ import annotations

import copy
import functools
import os
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
from mmlspark_tpu_torch.models.definitions import TransformerLM
from mmlspark_tpu_torch.ops.attention import (NEG_INF, merge_attention_stats,
                                              ring_attention)
from mmlspark_tpu_torch.ops.decode_attention import (
    fused_single_query_attention, fused_single_query_attention_stats)
from mmlspark_tpu_torch.ops.flash_attention import flash_attention
from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS,
                                              Mesh)
from mmlspark_tpu_torch.parallel.partition import SEQ_KV_CACHE_SPEC
from mmlspark_tpu_torch.parallel.ring import reshard
from mmlspark_tpu_torch.quant.quantize import quantize_kv

DEFAULT_CACHE_CHUNK = 128  # cache-window growth granularity (slots)
DEFAULT_MIN_BUCKET = 8     # smallest prompt bucket
_PREFILL_FLASH_MIN = 512   # prompt length from which prefill runs flash
_WINDOW_DIM = SEQ_KV_CACHE_SPEC.index(SEQ_AXIS)  # the cache axis over 'seq'


# ---------------------------------------------------------------------------
# The decode core: the block math over the module's weights
# ---------------------------------------------------------------------------

class ServingWeights:
    """A TransformerLM's weights as the decode path reads them: every
    Dense weight and bias cast to the model dtype once (a copy at bf16,
    the module's own f32 tensors at f32), embeddings and LayerNorms as the
    module holds them (f32).  Attribute names follow the module's, so the
    block math takes either.  The module's f32 Dense masters are not
    referenced, so serving holds the model-dtype copy alone."""

    def __init__(self, module):
        _check_generatable(module)
        dtype = module.dtype

        def cast(linear):
            return SimpleNamespace(weight=linear.weight.detach().to(dtype),
                                   bias=linear.bias.detach().to(dtype))

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
            qkv=cast(blk.qkv), proj=cast(blk.proj), mlp_up=cast(blk.mlp_up),
            mlp_down=cast(blk.mlp_down)) for blk in module.blocks]
        self._copies: dict = {}

    def on(self, device) -> "ServingWeights":
        """These weights on `device`: this object where they already are,
        else a copy made once and kept, so the engines sharing this object
        hold the weights once per distinct device of their meshes."""
        device = torch.device(device)
        if _same_device(self.device, device):
            return self
        if device not in self._copies:
            def move(layer):
                return SimpleNamespace(**{
                    name: getattr(layer, name).detach().to(device)
                    for name in ("weight", "scale", "bias")
                    if hasattr(layer, name)})
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
    """A Dense layer over its model-dtype copy (`ServingWeights`)."""
    return F.linear(x.to(dtype), linear.weight, linear.bias)


def _mlp(block, h2: torch.Tensor, dtype) -> torch.Tensor:
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


def _write_token(cache: tuple, index, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Write one decode token's K/V (B, H, Dh) at cache slot `index` in
    place, quantized on write for an int8 cache ((k_q, k_scale, v_q,
    v_scale)), on the cache's device."""
    dev = cache[0].device
    k, v = k.to(dev), v.to(dev)
    if len(cache) == 4:
        kq, ks, vq, vs = cache
        kq[:, index], ks[:, index] = quantize_kv(k)
        vq[:, index], vs[:, index] = quantize_kv(v)
    else:
        kc, vc = cache
        kc[:, index] = k.to(kc.dtype)
        vc[:, index] = v.to(vc.dtype)


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


def _grow_cache(cache: torch.Tensor, window: int) -> torch.Tensor:
    """Zero-extend a cache prefix to `window` slots (payloads (B, W, H, D)
    and int8 scales (B, W, H) alike)."""
    if cache.shape[1] == window:
        return cache
    out = cache.new_zeros((cache.shape[0], window) + tuple(cache.shape[2:]))
    out[:, :cache.shape[1]] = cache
    return out


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


def _make_row_sampler(temperature: float, top_k, top_p):
    """A `(logits (B, V), row_seeds [B], step) -> tokens (B,)` sampler:
    greedy at temperature 0, else the Gumbel-max draw over the filtered,
    temperature-scaled logits, each row from its own generator seeded with
    (row stream, step)."""
    if temperature <= 0.0:
        def sample(logits, row_seeds, step):
            return torch.argmax(logits, dim=-1)
        return sample

    def sample(logits, row_seeds, step):
        filtered = filter_logits(logits.float() / temperature, top_k, top_p)
        out = torch.empty(logits.shape[0], dtype=torch.long,
                          device=logits.device)
        gen = torch.Generator(device=logits.device)
        for i, row_seed in enumerate(row_seeds):
            gen.manual_seed(_mix(row_seed, step))
            u = torch.rand(filtered.shape[-1], generator=gen,
                           device=logits.device)
            gumbel = -torch.log(-torch.log(u))
            out[i] = torch.argmax(filtered[i] + gumbel)
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
                "seq-sharded cache path")
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
        if prefill_chunk is not None:
            raise NotImplementedError("chunked prefill is not ported")
        if draft_module is not None or spec_tokens:
            raise NotImplementedError("speculative decoding is not ported")
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
        greedy = temperature <= 0.0
        self._sample = _make_row_sampler(temperature,
                                         None if greedy else top_k,
                                         None if greedy else top_p)
        self._is_stop = _make_stop_check(stop_tokens)
        self.last_segments_run = 0
        self.last_new_tokens_computed = 0
        self.last_exit_checks_skipped = 0

    def bucket_for(self, prompt_len: int) -> int:
        return bucket_length(prompt_len, self.weights.max_len,
                             self.max_new_tokens, self.min_bucket)

    def _stop_gate(self, tok: torch.Tensor, new_count: int) -> torch.Tensor:
        # a stop token only freezes once the row has emitted
        # `min_new_tokens` tokens including it
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
        model = self.weights
        b, p = prompts.shape
        w0 = _round_up(p + 1, self.chunk)
        dh = model.d_model // model.n_heads
        shape = (b, w0, model.n_heads, dh)
        caches = [(torch.zeros(shape, dtype=model.dtype, device=self.device),
                   torch.zeros(shape, dtype=model.dtype, device=self.device))
                  for _ in range(model.n_layers)]
        logits = _forward_with_cache(self.weights, prompts, caches, 0)
        last = logits[torch.arange(b, device=self.device), true_len - 1]
        tok, done = self._first_token(last, live, row_seeds)
        if self.cache_dtype == "int8":
            # quantize-on-write at prefill granularity: the prompt's whole
            # cache quantizes once here; decode steps quantize each token
            caches = [quantize_kv(kc) + quantize_kv(vc)
                      for kc, vc in caches]
        return tok, done, caches

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
        check_exit = bool(self.stop_tokens)
        parts = [[] for _ in groups]
        segments_run = exit_checks_skipped = 0
        with torch.inference_mode():
            states = []
            for rows, ring in groups:
                dev = self.device if ring is None else ring[0]
                tl = torch.as_tensor(tl_host[rows], dtype=torch.long,
                                     device=dev)
                tok, done, caches = self.prefill(
                    torch.as_tensor(prompts[rows], dtype=torch.long,
                                    device=dev), tl,
                    torch.as_tensor(live[rows], device=dev),
                    row_seeds[rows], ring)
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
    the `minNewTokens` floor.

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
    beamWidth = Param(0, "beam search width (not ported: must stay 0)",
                      ptype=int, validator=lambda v: v >= 0)
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
    specTokens = Param(0, "speculative decoding (not ported: must stay 0)",
                       ptype=int, validator=lambda v: v >= 0)
    prefillChunk = Param(0, "chunked prefill (not ported: must stay 0)",
                         ptype=int, validator=lambda v: v >= 0)

    def __init__(self, bundle: Optional[ModelBundle] = None, device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self._bundle = bundle
        self._weights = None
        self._mesh = None
        self._engines: dict = {}

    def set_bundle(self, bundle: ModelBundle) -> "TextGenerator":
        self._bundle = bundle
        self._weights = None
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

    def _engine_for(self) -> DecodeEngine:
        for name in ("beamWidth", "specTokens", "prefillChunk"):
            if self.get(name):
                raise NotImplementedError(f"{name} is not ported")
        # greedy ignores the filters: normalize them out of the cache key
        sampling = self.temperature > 0
        top_k = (self.topK or None) if sampling else None
        top_p = self.topP if sampling and self.topP < 1.0 else None
        stops = tuple(int(t) for t in (self.stopTokens or ()))
        kv_dtype = self.kvCacheDtype or "model"
        key = (self.maxNewTokens, self.temperature, top_k, top_p, stops,
               self.cacheChunk, kv_dtype, self.minNewTokens)
        if key not in self._engines:
            if self._weights is None:
                # the f32 module is dropped once its Dense weights are cast
                self._weights = ServingWeights(
                    self._bundle.module(self.device))
            self._engines[key] = DecodeEngine(
                self._weights, self.maxNewTokens,
                temperature=self.temperature, top_k=top_k, top_p=top_p,
                stop_tokens=stops, chunk=self.cacheChunk,
                cache_dtype=kv_dtype, min_new_tokens=self.minNewTokens,
                mesh=self._mesh, device=self.device)
        return self._engines[key]

    def transform(self, table: DataTable) -> DataTable:
        self._check_required()
        if self._bundle is None:
            raise ValueError(
                "TextGenerator has no model bundle; call set_bundle()")
        engine = self._engine_for()
        rows = [np.asarray(r, np.int32) for r in table[self.inputCol]]
        out: list = [None] * len(rows)
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
        if out and len({len(r) for r in out}) == 1:
            return table.with_column(self.outputCol, np.stack(out))
        result = np.empty(len(out), object)
        for i, r in enumerate(out):
            result[i] = r
        return table.with_column(self.outputCol, result)

    def _save_extra(self, path: str) -> None:
        if self._bundle is not None:
            save_bundle(self._bundle, f"{path}/bundle")

    def _load_extra(self, path: str) -> None:
        self.set_bundle(load_bundle(f"{path}/bundle")
                        if os.path.exists(f"{path}/bundle") else None)


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
