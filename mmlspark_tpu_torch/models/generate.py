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

Not ported yet (they raise NotImplementedError): meshes and seq-sharded
decode, chunked prefill, speculative decoding, beam search, the serving
hooks.
"""

from __future__ import annotations

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
from mmlspark_tpu_torch.ops.attention import NEG_INF
from mmlspark_tpu_torch.ops.decode_attention import \
    fused_single_query_attention
from mmlspark_tpu_torch.ops.flash_attention import flash_attention
from mmlspark_tpu_torch.quant.quantize import quantize_kv

DEFAULT_CACHE_CHUNK = 128  # cache-window growth granularity (slots)
DEFAULT_MIN_BUCKET = 8     # smallest prompt bucket
_PREFILL_FLASH_MIN = 512   # prompt length from which prefill runs flash


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
        self.max_len, self.vocab_size = module.max_len, module.vocab_size
        self.d_model, self.n_layers = module.d_model, module.n_layers
        self.tok_embed, self.pos_embed = module.tok_embed, module.pos_embed
        self.final_norm_w = module.final_norm_w
        self.lm_head = cast(module.lm_head)
        self.blocks = [SimpleNamespace(
            LayerNorm_0=blk.LayerNorm_0, LayerNorm_1=blk.LayerNorm_1,
            qkv=cast(blk.qkv), proj=cast(blk.proj), mlp_up=cast(blk.mlp_up),
            mlp_down=cast(blk.mlp_down)) for blk in module.blocks]


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


def _block_with_cache(block, n_heads: int, x: torch.Tensor,
                      k_cache: torch.Tensor, v_cache: torch.Tensor,
                      pos: int, dtype) -> torch.Tensor:
    """One TransformerBlock over a token segment starting at cache slot
    `pos`, writing its K/V into the (B, W, H, Dh) caches in place."""
    b, s, d = x.shape
    dh = d // n_heads
    h = _ln(block.LayerNorm_0, x, dtype)
    q, k, v = _split_heads(_dense(block.qkv, h, dtype), n_heads)
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
    x = x + _dense(block.proj, o.reshape(b, s, d).to(dtype), dtype)
    h2 = _ln(block.LayerNorm_1, x, dtype)
    return x + _mlp(block, h2, dtype)


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


def _decode_block(block, n_heads: int, x: torch.Tensor, cache: tuple,
                  slot: int, visible: torch.Tensor, dtype) -> torch.Tensor:
    """One TransformerBlock for a single decode token per row: write its
    K/V at the shared cache `slot` (quantized on write for an int8 cache,
    whose `cache` is (k_q, k_scale, v_q, v_scale)), then read the window
    through the fused single-query kernel under the per-row mask."""
    b, _, d = x.shape
    h = _ln(block.LayerNorm_0, x, dtype)
    q, k, v = (t[:, 0] for t in _split_heads(_dense(block.qkv, h, dtype),
                                             n_heads))
    q = q.contiguous()
    if len(cache) == 4:
        kq, ks, vq, vs = cache
        kq[:, slot], ks[:, slot] = quantize_kv(k)
        vq[:, slot], vs[:, slot] = quantize_kv(v)
        o = fused_single_query_attention(q, kq, vq, visible,
                                         k_scale=ks, v_scale=vs)
    else:
        kc, vc = cache
        kc[:, slot] = k.to(kc.dtype)
        vc[:, slot] = v.to(vc.dtype)
        o = fused_single_query_attention(q, kc, vc, visible)
    x = x + _dense(block.proj, o.reshape(b, 1, d).to(dtype), dtype)
    h2 = _ln(block.LayerNorm_1, x, dtype)
    return x + _mlp(block, h2, dtype)


def _decode_step(module, tok: torch.Tensor, pos: torch.Tensor, slot: int,
                 caches: list, visible: torch.Tensor) -> torch.Tensor:
    """Logits (B, V) f32 for one decode token per row: per-row positions
    `pos` (true prompt length + step), shared write `slot`.  `module` is
    the `ServingWeights` of a TransformerLM."""
    dtype = module.dtype
    emb = module.tok_embed.weight[tok] + module.pos_embed.weight[pos]
    x = emb[:, None].to(dtype)
    for block, cache in zip(module.blocks, caches):
        x = _decode_block(block, module.n_heads, x, cache, slot, visible,
                          dtype)
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


def _make_stop_check(stop_tokens: tuple, device):
    if not stop_tokens:
        return lambda tok: torch.zeros(tok.shape, dtype=torch.bool,
                                       device=tok.device)
    stops = torch.tensor(list(stop_tokens), dtype=torch.long, device=device)
    return lambda tok: torch.isin(tok, stops)


def _check_generatable(module) -> None:
    if not isinstance(module, TransformerLM):
        raise ValueError(
            f"generation decodes TransformerLM models, got "
            f"{type(module).__name__}")


def _on_device(module, device: torch.device) -> bool:
    have = module.device
    return have.type == device.type and (device.index is None
                                         or have.index == device.index)


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
    cache's, exactly as in the JAX package."""

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
        if not _on_device(module, self.device):
            raise ValueError(f"the module's weights are on {module.device}, "
                             f"the engine runs on {self.device}")
        if mesh is not None:
            raise NotImplementedError("meshed and seq-sharded decode are "
                                      "not ported")
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
        self._is_stop = _make_stop_check(stop_tokens, self.device)
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

    def prefill(self, prompts: torch.Tensor, true_len: torch.Tensor,
                live: torch.Tensor, row_seeds: list) -> tuple:
        """The prompt forward of one bucket: prompts (B, bucket) long,
        true_len (B,) long, live (B,) bool.  Returns (first token (B,),
        done (B,), per-layer caches over the first window)."""
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
        tok = self._sample(last, row_seeds, 0)
        done = ~live | self._stop_gate(tok, 1)
        if self.cache_dtype == "int8":
            # quantize-on-write at prefill granularity: the prompt's whole
            # cache quantizes once here; decode steps quantize each token
            caches = [quantize_kv(kc) + quantize_kv(vc)
                      for kc, vc in caches]
        return tok, done, caches

    def decode_segment(self, seg_len: int, window: int, caches: list,
                       tok: torch.Tensor, done: torch.Tensor,
                       true_len: torch.Tensor, bucket: int, t0: int,
                       row_seeds: list) -> tuple:
        """`seg_len` decode steps from step `t0`, attending over `window`
        cache slots.  Returns (caches, the tokens fed to the steps
        (B, seg_len), the next token, done)."""
        caches = [tuple(_grow_cache(c, window) for c in layer)
                  for layer in caches]
        slots = torch.arange(window, device=self.device)
        prompt_visible = slots[None, :] < true_len[:, None]
        emitted = []
        for t in range(t0, t0 + seg_len):
            slot = bucket + t
            visible = prompt_visible | ((slots >= bucket)
                                        & (slots <= slot))[None, :]
            logits = _decode_step(self.weights, tok, true_len + t, slot,
                                  caches, visible)
            nxt = torch.where(done, tok, self._sample(logits, row_seeds,
                                                      t + 1))
            emitted.append(tok)
            done = done | self._stop_gate(nxt, t + 2)
            tok = nxt
        return caches, torch.stack(emitted, dim=1), tok, done

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
        ids = range(b) if row_ids is None else [int(i) for i in row_ids]
        row_seeds = [_mix(int(seed), i) for i in ids]
        live = np.ones(b, bool) if live is None else np.asarray(live, bool)
        dev = self.device
        check_exit = bool(self.stop_tokens)
        parts = []
        segments_run = exit_checks_skipped = 0
        with torch.inference_mode():
            prompts_t = torch.as_tensor(prompts, dtype=torch.long, device=dev)
            tl = torch.as_tensor(tl_host, dtype=torch.long, device=dev)
            tok, done, caches = self.prefill(
                prompts_t, tl, torch.as_tensor(live, device=dev), row_seeds)
            for t0, seg_len, window in decode_segments(
                    p, self.max_new_tokens, self.chunk):
                if check_exit and t0 + 1 < self.min_new_tokens:
                    # no row can be done before the stop floor: skip the
                    # device->host sync
                    exit_checks_skipped += 1
                elif check_exit and bool(done.all()):
                    break
                caches, toks, tok, done = self.decode_segment(
                    seg_len, window, caches, tok, done, tl, p, t0, row_seeds)
                parts.append(toks)
                segments_run += 1
            generated = torch.cat(parts + [tok[:, None]], dim=1).cpu().numpy()
        self.last_segments_run = segments_run
        self.last_new_tokens_computed = generated.shape[1]
        self.last_exit_checks_skipped = exit_checks_skipped
        if generated.shape[1] < self.max_new_tokens:
            # early exit: every row is frozen on its stop token
            fill = np.repeat(generated[:, -1:],
                             self.max_new_tokens - generated.shape[1], axis=1)
            generated = np.concatenate([generated, fill], axis=1)
        return generated.astype(np.int32)


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
        self._engines: dict = {}

    def set_bundle(self, bundle: ModelBundle) -> "TextGenerator":
        self._bundle = bundle
        self._weights = None
        self._engines = {}
        return self

    def set_mesh(self, mesh) -> "TextGenerator":
        raise NotImplementedError("meshed generation is not ported")

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
                device=self.device)
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
        for bucket, idxs in sorted(by_bucket.items()):
            prompts = np.zeros((len(idxs), bucket), np.int32)
            true_len = np.array([len(rows[i]) for i in idxs], np.int32)
            for j, i in enumerate(idxs):
                prompts[j, :true_len[j]] = rows[i]
            # the per-row sampling-stream id is the row's table position
            got = engine.generate(prompts, true_len, seed=self.seed,
                                  row_ids=idxs)
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
