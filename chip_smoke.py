"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written kernels from `mmlspark_tpu_torch/csrc/`, holds each against
its plain PyTorch version, drives the LM serving path
(`TextGenerator.transform` -> `DecodeEngine.generate`) at the full width of
the repo's LM bench configuration, and times kernels and path.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. card (nvidia-smi name and power limit) and kernel build
  2. flash-attention kernel vs plain: causal bf16 at S in {512, 1024,
     1984}, one non-causal case, one f32 case
  3. single-query decode kernel vs plain: bf16 and int8 caches at
     L in {128, 1152, 2048}, the engine's mask layout, a fully masked row
  4. the serving path at full width (TransformerLM vocab 8192, d_model
     1024, 8 heads, 4 layers, max_len 2048, bf16, seeded random weights):
     8 ragged prompts, 64 greedy tokens, model-dtype and int8 KV caches;
     both kernels' launch counts must rise; f32 prefill logits against the
     plain forward; greedy agreement with the recompute oracle at f32
  5. timings with CUDA events (median after warm-up)

Prints the card line, a JSON line of per-kernel numbers, and last
`{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s

LM_CONFIG = {"vocab_size": 8192, "d_model": 1024, "n_heads": 8,
             "n_layers": 4, "max_len": 2048, "dtype": "bfloat16"}
PROMPT_LENGTHS = (20, 45, 70, 100, 600, 900, 1200, 1500)
MAX_NEW = 64


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call with the host's launch overhead taken out:
    `calls` calls captured in one CUDA graph, the replay timed by CUDA
    events (median of `reps`), divided by `calls`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, warmup=1, reps=reps) / calls


KERNEL_GROUPS = (("flash_attention (K1)", ("flash_fwd",)),
                 ("fused_single_query_attention (K4)", ("sqa_",)),
                 ("GEMM (cuBLAS)", ("gemm", "gemv", "cutlass", "xmma",
                                    "cublas", "nvjet")))


def device_breakdown(fn, card) -> dict:
    """Profile one call with torch.profiler: device kernel time by group
    and the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups: dict = {}
    top = []
    for evt in prof.key_averages():
        # kernel rows only: an operator row repeats its kernels' time
        if evt.device_type == DeviceType.CPU:
            continue
        us = evt.self_device_time_total
        if us <= 0:
            continue
        name = evt.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other kernels")
        groups[group] = groups.get(group, 0.0) + us
        top.append((us, evt.count, evt.key[:90]))
    busy = sum(groups.values())
    if busy == 0:
        print(f"  device breakdown: not measured (the profiler saw no "
              f"device time) [{card}]")
        return {}
    print(f"  device busy {busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall "
          f"(idle share {1 - busy / wall_us:.3f}) [{card}]")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"    {group}: {us / 1e3:.3f} ms ({us / busy:.3f} of busy)")
    for us, count, key in sorted(top, reverse=True)[:8]:
        print(f"      {us / 1e3:.3f} ms in {count} launches: {key}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / wall_us,
            "groups_ms": {g: us / 1e3 for g, us in groups.items()}}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def engine_mask(b: int, window: int, bucket: int, frontier: int,
                true_len: torch.Tensor) -> torch.Tensor:
    """The decode engine's visibility layout: per-row prompt slots, the pad
    hole up to the bucket, then decode slots bucket..frontier."""
    slots = torch.arange(window, device=true_len.device)
    return ((slots[None] < true_len[:, None])
            | ((slots >= bucket) & (slots <= frontier))[None]).contiguous()


def phase_flash(dev, card) -> dict:
    from mmlspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                        flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, s, dtype):
        return [torch.randn((b, s, 8, 128), generator=gen, device=dev)
                .to(dtype) for _ in range(3)]

    cases = [(2, 512, True, torch.bfloat16), (2, 1024, True, torch.bfloat16),
             (2, 1984, True, torch.bfloat16), (2, 1000, False, torch.bfloat16),
             (2, 700, True, torch.float32)]
    max_err = 0.0
    for b, s, causal, dtype in cases:
        q, k, v = qkv(b, s, dtype)
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, causal=causal)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        err = (got.float() - ref.float()).abs().max().item()
        ok = torch.allclose(got.float(), ref.float(), rtol=tol, atol=tol)
        print(f"flash_attention B={b} S={s} causal={causal} {dtype}: "
              f"max_abs_err={err:.3e} (tol {tol})")
        require(ok, f"flash kernel disagrees at S={s} {dtype}")
        if dtype == torch.bfloat16 and causal:
            max_err = max(max_err, err)

    # timing at the prefill shape of a full bucket of 8 rows
    b, s, h, d = 8, 1024, 8, 128
    q, k, v = qkv(b, s, torch.bfloat16)
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = graph_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        calls=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)        # QK^T + PV, causal
    nbytes = 4.0 * b * s * h * d * 2                   # q, k, v in; out
    bound_f, bound_b = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"timing flash_attention (8,1024,8,128) causal bf16, device time "
          f"(CUDA graph): {ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms; bound "
          f"{max(bound_f, bound_b):.4f} ms (operations {bound_f:.4f} ms at "
          f"989 TFLOP/s, bytes {bound_b:.4f} ms at 3.35 TB/s); kernel "
          f"{flops / ms / 1e9:.1f} TFLOP/s [{card}]")
    return {"name": "flash_attention", "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_f, bound_b),
            "bound_by": "operations" if bound_f >= bound_b else "bytes",
            "library_ms": lib_ms}


def phase_decode(dev, card) -> list:
    from mmlspark_tpu_torch.ops.decode_attention import (
        fused_single_query_attention, fused_single_query_attention_plain)
    from mmlspark_tpu_torch.quant.quantize import quantize_kv
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, d = 8, 8, 128

    def case(window):
        bucket = window - 128 if window > 128 else 64
        q = torch.randn((b, h, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((b, window, h, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        true_len = torch.randint(1, bucket + 1, (b,), generator=gen,
                                 device=dev)
        visible = engine_mask(b, window, bucket, bucket + 40, true_len)
        visible[-1] = False                       # a fully masked row
        return q, k, v, visible

    errs = {"model": 0.0, "int8": 0.0}
    for window in (128, 1152, 2048):
        q, k, v, visible = case(window)
        for kind in ("model", "int8"):
            kw, kc, vc = {}, k, v
            if kind == "int8":
                (kc, ks), (vc, vs) = quantize_kv(k), quantize_kv(v)
                kw = dict(k_scale=ks, v_scale=vs)
            got = fused_single_query_attention(q, kc, vc, visible, **kw)
            torch.cuda.synchronize()
            ref = fused_single_query_attention_plain(q, kc, vc, visible, **kw)
            err = (got - ref).abs().max().item()
            print(f"fused_single_query_attention L={window} cache={kind}: "
                  f"max_abs_err={err:.3e} (tol 2e-3)")
            require(err <= 2e-3, f"decode kernel disagrees at L={window} "
                                 f"{kind}")
            require(torch.count_nonzero(got[-1]).item() == 0,
                    "fully masked row is not zero")
            errs[kind] = max(errs[kind], err)

    # timing at (8, 1152, 8, 128): the first decode window of a 1024 bucket
    window, bucket = 1152, 1024
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, window, h, d), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    true_len = torch.randint(600, bucket + 1, (b,), generator=gen, device=dev)
    visible = engine_mask(b, window, bucket, bucket + 63, true_len)
    n_visible = int(visible.sum().item())
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    entries = []
    for kind, kc, vc, kw in (("model", k, v, {}),
                             ("int8", kq, vq, dict(k_scale=ks, v_scale=vs))):
        def call():
            return fused_single_query_attention(q, kc, vc, visible, **kw)
        ms = graph_ms(call)
        call_ms = cuda_ms(call)
        plain_ms = graph_ms(lambda: fused_single_query_attention_plain(
            q, kc, vc, visible, **kw))
        lib_ms = None
        if kind == "model":
            mask = visible[:, None, None, :]
            lib_ms = graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask))
        # bytes this run's data needs: K and V rows of the visible slots,
        # their scales, the mask, q in, f32 out
        item = kc.element_size()
        nbytes = (2.0 * n_visible * h * d * item + b * window
                  + q.numel() * 2 + b * h * d * 4)
        if kind == "int8":
            nbytes += 2.0 * n_visible * h * 4
        flops = 4.0 * n_visible * h * d
        bound_b = nbytes / PEAK_BYTES * 1e3
        bound_f = flops / PEAK_F32_FLOPS * 1e3
        print(f"timing fused_single_query_attention (8,1152,8,128) "
              f"cache={kind}, device time (CUDA graph): {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s); one eager call incl. host "
              f"launch {call_ms:.4f} ms; plain {plain_ms:.4f} ms; SDPA "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
              f"{max(bound_b, bound_f):.4f} ms [{card}]")
        entries.append({
            "name": ("fused_single_query_attention" if kind == "model"
                     else "fused_single_query_attention[int8]"),
            "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/decode_attention.cu",
            "replaces": "mmlspark_tpu/ops/decode_attention.py:245",
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_b, bound_f),
            "bound_by": "bytes" if bound_b >= bound_f else "operations",
            "library_ms": lib_ms})
    return entries


def phase_main_path(dev, card) -> dict:
    from mmlspark_tpu_torch import DataTable, ModelBundle, TextGenerator
    from mmlspark_tpu_torch.core.table import object_column
    from mmlspark_tpu_torch.models.generate import (_forward_with_cache,
                                                    naive_generate)
    from mmlspark_tpu_torch.ops.decode_attention import \
        fused_single_query_attention
    from mmlspark_tpu_torch.ops.flash_attention import flash_attention

    bundle = ModelBundle.init("TransformerLM", LM_CONFIG, seed=0)
    rng = np.random.default_rng(1)
    rows = [rng.integers(0, LM_CONFIG["vocab_size"], n).astype(np.int32)
            for n in PROMPT_LENGTHS]
    table = DataTable({"prompt": object_column(rows)})
    counts = {}
    tokens_per_s = {}
    breakdown = {}
    for kv in (None, "int8"):
        stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                              maxNewTokens=MAX_NEW, kvCacheDtype=kv)
        stage.transform(table)                    # warm-up: load, init
        flash_attention.launches = 0
        fused_single_query_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stage.transform(table)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts[kv or "model"] = (flash_attention.launches,
                                 fused_single_query_attention.launches)
        for r, o in zip(rows, out["generated"]):
            require(len(o) == len(r) + MAX_NEW, "row length")
            require(np.array_equal(o[:len(r)], r), "prompt not kept")
            require(((o >= 0) & (o < LM_CONFIG["vocab_size"])).all(),
                    "token outside the vocabulary")
        tokens_per_s[kv or "model"] = len(rows) * MAX_NEW / seconds
        print(f"main path kv={kv or 'model'}: {len(rows)} rows x {MAX_NEW} "
              f"tokens in {seconds * 1e3:.1f} ms = "
              f"{tokens_per_s[kv or 'model']:.1f} tokens/s; launches "
              f"flash={counts[kv or 'model'][0]} "
              f"decode={counts[kv or 'model'][1]} [{card}]")
        require(counts[kv or "model"][0] > 0, "flash kernel not launched")
        require(counts[kv or "model"][1] > 0, "decode kernel not launched")
        breakdown[kv or "model"] = device_breakdown(
            lambda: stage.transform(table), card)

    # per-phase device time of the largest bucket (1984: two rows)
    stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                          maxNewTokens=MAX_NEW)
    engine = stage._engine_for()
    long_rows = rows[6:]
    bucket = engine.bucket_for(max(map(len, long_rows)))
    prompts = torch.zeros((len(long_rows), bucket), dtype=torch.long,
                          device=dev)
    for j, r in enumerate(long_rows):
        prompts[j, :len(r)] = torch.from_numpy(r.astype(np.int64))
    tl = torch.tensor([len(r) for r in long_rows], device=dev)
    live = torch.ones(len(long_rows), dtype=torch.bool, device=dev)
    seeds = [0] * len(long_rows)
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: engine.prefill(prompts, tl, live, seeds),
                             warmup=2, reps=5)
        tok, done, caches = engine.prefill(prompts, tl, live, seeds)
        steps = 32
        window = -(-(bucket + steps) // engine.chunk) * engine.chunk
        seg_ms = cuda_ms(lambda: engine.decode_segment(
            steps, window, caches, tok, done, tl, bucket, 0, seeds),
            warmup=1, reps=5)
    print(f"timing main path bucket {bucket} x {len(long_rows)} rows: "
          f"prefill {prefill_ms:.3f} ms; decode {seg_ms / steps:.3f} "
          f"ms/step (window {window}) [{card}]")

    # f32: the kernel path's prefill logits against the plain forward, and
    # greedy tokens against the recompute oracle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle32 = ModelBundle("TransformerLM", {**LM_CONFIG, "dtype": "float32"},
                           bundle.variables)
    module32 = bundle32.module(dev)
    mid = rows[4:6]                                # bucket 1024
    p = 1024
    prompts = torch.zeros((len(mid), p), dtype=torch.long, device=dev)
    for j, r in enumerate(mid):
        prompts[j, :len(r)] = torch.from_numpy(r.astype(np.int64))
    shape = (len(mid), p + 128, LM_CONFIG["n_heads"],
             LM_CONFIG["d_model"] // LM_CONFIG["n_heads"])
    caches = [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
              for _ in range(LM_CONFIG["n_layers"])]
    with torch.inference_mode():
        before = flash_attention.launches
        kernel_logits = _forward_with_cache(module32, prompts, caches, 0)
        require(flash_attention.launches > before, "f32 prefill skipped flash")
        plain_logits = module32(prompts)
    logit_err = (kernel_logits - plain_logits).abs().max().item()
    print(f"f32 prefill logits (bucket 1024) kernel vs plain forward: "
          f"max_abs_err={logit_err:.3e} (tol 1e-3)")
    require(logit_err <= 1e-3, "f32 prefill logits disagree")

    out = TextGenerator(bundle32, device=dev, inputCol="prompt",
                        maxNewTokens=MAX_NEW).transform(table)
    matches = total = 0
    for r, o in zip(rows, out["generated"]):
        ref = naive_generate(module32, r[None], MAX_NEW)[0]
        matches += int((o[len(r):] == ref[len(r):]).sum())
        total += MAX_NEW
    print(f"f32 greedy tokens kernel path vs recompute oracle: "
          f"{matches}/{total} = {matches / total:.4f} match")
    return {"counts": counts, "tokens_per_s": tokens_per_s,
            "device_breakdown": breakdown,
            "prefill_ms": prefill_ms, "decode_ms_per_step": seg_ms / steps,
            "greedy_match_f32": matches / total}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from mmlspark_tpu_torch.ops import native

    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    build_s = native.build()
    print(f"kernel build: {build_s:.1f} s")
    dev = torch.device("cuda")
    flash = phase_flash(dev, card)
    decode = phase_decode(dev, card)
    main_path = phase_main_path(dev, card)
    flash["launches"] = main_path["counts"]["model"][0]
    decode[0]["launches"] = main_path["counts"]["model"][1]
    decode[1]["launches"] = main_path["counts"]["int8"][1]
    kernels = [flash] + decode
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"main_path": {k: v for k, v in main_path.items()
                                    if k != "counts"}, "card": card}))
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
