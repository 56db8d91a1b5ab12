"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written kernels from `mmlspark_tpu_torch/csrc/`, holds each against
its plain PyTorch version, drives the LM serving path
(`TextGenerator.transform` -> `DecodeEngine.generate`) and the LM training
path (`Trainer.fit_arrays`) at the full width of the repo's LM bench
configuration and the seq-sharded long-context decode path at the width
of its long-context configuration, and times kernels and paths.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. card (nvidia-smi name and power limit) and kernel build; K1's, K2's,
     K3's and K4's `-Xptxas -v` lines (registers, shared memory, spills: a
     spill in a bf16 kernel, or in any K4 kernel, fails)
  2. flash-attention forward K1 vs plain: causal bf16 at S in {512, 1024,
     1984}, one non-causal case, one f32 case
  3. K1 with its log-sum-exp output and q/k offsets vs plain: causal bf16
     at S in {512, 2048, 1000}, q_offset 512, k_offset > q_offset (fully
     masked rows), one f32 case; out and lse compared
  4. flash backward K2 (dQ) and K3 (dK/dV) vs plain: causal bf16 at S in
     {512, 2048, 1000, 129}, non-causal Sq 768 / Sk 1280, offsets, head
     dim 64 at S 2048, f32; a second launch at S 2048 bitwise equal to the
     first; `torch.autograd.grad` through `flash_attention` vs plain
     autograd; K2 and K3 timed with their TFLOP/s, ratio to the library
     pair and share of the bound
  5. single-query decode kernel K4 vs plain: bf16 and int8 caches at
     L in {128, 1152, 2048}, the engine's mask layout, a fully masked row;
     at the timed shape two calls bitwise equal and a CUDA graph replayed
     twice equal to an eager call (the in-launch span merge resets its
     arrival counters)
  6. the serving path at full width (TransformerLM vocab 8192, d_model
     1024, 8 heads, 4 layers, max_len 2048, bf16, seeded random weights):
     8 ragged prompts, 64 greedy tokens, model-dtype and int8 KV caches;
     K1 and K4 launch counts must rise; f32 prefill logits against the
     plain forward; greedy agreement with the recompute oracle at f32
  7. the training path at the same width: `fit_arrays` on 16 rows of
     2048 tokens, batch 8, 2 epochs of adam at 3e-4 with flash attention;
     the loss must fall and K1[lse], K2, K3 must each launch n_layers x
     steps times; the trained bundle generates through `TextGenerator`;
     step time, tokens/s, MFU and a profiler breakdown of one step
  8. the stats entry of the decode kernel, K4[stats], vs plain: bf16 and
     int8 caches (f32 q), head dims 64 and 128, the long-context slab
     (2, 4224, 8, 64) and a window not a multiple of SPLIT, a fully masked
     row giving exactly m = NEG_INF, l = 0, acc = 0; K4 at head dim 64;
     the repeat and graph checks of phase 5 at the slab and at K4's
     (2, 8448, 8, 64)
  9. K1[lse] at head dim 64 vs plain on the ring prefill's (shard, block)
     pairs (2, 4096, 8, 64) with q/k offsets 0/0, 4096/0, 4096/4096; K1
     at head dim 64 over (2, 8192, 8, 64); bf16 outputs held to a
     norm-relative limit as well as an absolute one (also in 2 and 3)
 10. the seq-sharded long-context path at the repo's long-context width
     (TransformerLM vocab 8192, d_model 512, 8 heads, 4 layers, max_len
     8448; context 8192, batch 2, 32 greedy tokens, cache chunk 256):
     `DecodeEngine` at seq=1 and over a seq=2 mesh whose two shards share
     this card; f32 greedy tokens identical, bf16 prefill logits close,
     K4[stats] and K1[lse] launch counts exact; prefill ms and decode
     ms/step of both engines
 11. f32 gradient check: every parameter's gradient with the flash
     kernels against the dense-attention model, TF32 off

Kernel and step times come from CUDA events (median after warm-up); each
timed K1 shape also prints its TFLOP/s, its ratio to the library call of
the same run and its share of the bound.
Prints the card line, a JSON line of per-kernel numbers, and last
`{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
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
TRAIN_ROWS, TRAIN_SEQ, TRAIN_BATCH = 16, 2048, 8   # 2 steps per epoch
# the repo's long-context configuration (bench.py bench_lm_long_context):
# head dim 64, context 8192, 32 greedy tokens, batch 2, cache chunk 256
LC_CONFIG = {"vocab_size": 8192, "d_model": 512, "n_heads": 8,
             "n_layers": 4, "max_len": 8448, "dtype": "bfloat16"}
LC_CONTEXT, LC_NEW, LC_BATCH, LC_CHUNK = 8192, 32, 2, 256


def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel-table name."""
    from mmlspark_tpu_torch.ops.decode_attention import (
        fused_single_query_attention, fused_single_query_attention_stats)
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_with_lse, flash_bwd_dkv,
        flash_bwd_dq)
    return {"flash_attention": flash_attention,
            "flash_attention[lse]": flash_attention_with_lse,
            "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
            "fused_single_query_attention": fused_single_query_attention,
            "fused_single_query_attention_stats":
                fused_single_query_attention_stats}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ||d||_F / ||ref||_F limit of an attention output: the bf16 kernels read
# 2.0e-3 to 2.5e-3 on the H100; a V tile of 64 keys skipped out of 4096
# reads 0.12
OUT_NORM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def out_errs(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|d|, ||d||_F / ||ref||_F) of an attention output.  The absolute
    limit alone is loose at bf16 and long S: |out| is about sqrt(e/n) over
    n visible keys, so a dropped or doubled V tile that leaves the
    log-sum-exp alone moves each entry by less than the limit; the
    norm-relative error sees it."""
    d, r = got.float() - ref.float(), ref.float()
    return d.abs().max().item(), (d.norm()
                                  / r.norm().clamp(min=1e-30)).item()


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


def repeat_and_graph_check(fn, what: str) -> None:
    """Two eager calls of `fn` bitwise equal, and a CUDA graph of one call
    replayed twice equal to them (outputs zeroed before each replay)."""
    def parts(x):
        return x if isinstance(x, tuple) else (x,)
    first, second = parts(fn()), parts(fn())
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(first, second)),
            f"{what}: two calls on the same inputs differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = parts(fn())
    for _ in range(2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(first, captured)),
                f"{what}: a CUDA graph replay differs from an eager call")
    print(f"{what}: two calls bitwise equal; a CUDA graph replayed twice "
          f"equals them")


GEMM_KEYS = ("gemm", "gemv", "cutlass", "xmma", "cublas", "nvjet")
KERNEL_GROUPS = (("flash_attention (K1)", ("flash_fwd",)),
                 ("fused_single_query_attention (K4)", ("sqa_",)),
                 ("GEMM (cuBLAS)", GEMM_KEYS))
LC_GROUPS = (("K1 / K1[lse] flash_fwd", ("flash_fwd",)),
             ("K4 / K4[stats] sqa_", ("sqa_",)),
             ("GEMM (cuBLAS)", GEMM_KEYS))
TRAIN_GROUPS = (("K1 flash forward with lse", ("flash_fwd",)),
                ("K2 flash_bwd_dq", ("flash_bwd_dq",)),
                ("K3 flash_bwd_dkv", ("flash_bwd_dkv",)),
                ("GEMM (cuBLAS)", GEMM_KEYS))


def device_breakdown(fn, card, kernel_groups=KERNEL_GROUPS) -> dict:
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
        group = next((g for g, keys in kernel_groups
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
        err, norm_err = out_errs(got, ref)
        ok = torch.allclose(got.float(), ref.float(), rtol=tol, atol=tol)
        print(f"flash_attention B={b} S={s} causal={causal} {dtype}: "
              f"max_abs_err={err:.3e} (tol {tol}), ||d||/||ref|| "
              f"{norm_err:.3e} (tol {OUT_NORM_TOL[dtype]})")
        require(ok and norm_err <= OUT_NORM_TOL[dtype],
                f"flash kernel disagrees at S={s} {dtype}")
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
          f"989 TFLOP/s, bytes {bound_b:.4f} ms at 3.35 TB/s); "
          f"{k1_rates(flops, ms, lib_ms, max(bound_f, bound_b))} [{card}]")
    return {"name": "flash_attention", "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bound_f, bound_b),
            "bound_by": "operations" if bound_f >= bound_b else "bytes",
            "library_ms": lib_ms}


def attention_bound(flops: float, nbytes: float) -> tuple:
    """(bound ms, "operations" | "bytes") at the bf16 tensor-core peak and
    the HBM rate."""
    bound_f, bound_b = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(bound_f, bound_b), ("operations" if bound_f >= bound_b
                                   else "bytes")


def k1_rates(flops: float, ms: float, lib_ms: float, bound: float) -> str:
    """A timed K1 shape's rate, its ratio to the library call of the same
    run and its share of the bound."""
    return (f"K1 {flops / ms / 1e9:.1f} TFLOP/s, {ms / lib_ms:.2f}x the "
            f"library call, {bound / ms:.3f} of the bound")


MANGLED_TYPES = (("13__nv_bfloat16", "bf16"), ("f", "f32"), ("a", "int8"))


def short_kernel_name(mangled: str, prefix: str) -> str:
    """`flash_fwd_bf16<128>` for a kernel templated on its head dim;
    `sqa_forward<q bf16, cache int8, 64>` for the decode kernels, whose
    template names the q and cache types (a repeated type is a mangling
    back-reference, S<n>_); else the mangled name."""
    found = re.search("(" + prefix + r"\w*?)ILi(\d+)E", mangled)
    if found:
        return f"{found.group(1)}<{found.group(2)}>"
    found = re.search("(" + prefix + r"\w*?)I(\w+?)Li(\d+)ELb", mangled)
    if not found:
        return mangled
    types, rest = [], found.group(2)
    while rest:
        back = re.match(r"S\w*?_", rest)
        if back:
            types.append(types[-1])
            rest = rest[back.end():]
            continue
        code, word = next(((c, w) for c, w in MANGLED_TYPES
                           if rest.startswith(c)), (rest, rest))
        types.append(word)
        rest = rest[len(code):]
    return (f"{found.group(1)}<q {types[0]}, cache {types[-1]}, "
            f"{found.group(3)}>")


def ptxas_report(name: str, prefix: str) -> list:
    """Registers, static shared memory and spills of each kernel of library
    `name` whose symbol holds `prefix`, read from the `-Xptxas -v` build
    log beside the library (`native.build`)."""
    from mmlspark_tpu_torch.ops import native
    rows, kernel, spills = [], None, (0, 0)
    with open(native.library_path(name)[:-3] + ".log") as f:
        for line in f:
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                kernel = found.group(1)
                continue
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if found:
                spills = (int(found.group(1)), int(found.group(2)))
            found = re.search(r"Used (\d+) registers(.*)", line)
            if found and kernel and prefix in kernel:
                smem = re.search(r"(\d+) bytes smem", found.group(2))
                rows.append({
                    "kernel": short_kernel_name(kernel, prefix),
                    "registers": int(found.group(1)),
                    "static_smem_bytes": int(smem.group(1)) if smem else 0,
                    "spill_stores": spills[0], "spill_loads": spills[1]})
                kernel = None
    return rows


def phase_flash_lse(dev, card) -> dict:
    from mmlspark_tpu_torch.ops.attention import NEG_INF
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse, flash_attention_with_lse_plain)
    gen = torch.Generator(device=dev).manual_seed(2)

    def rand(b, s, dtype):
        return torch.randn((b, s, 8, 128), generator=gen, device=dev).to(dtype)

    # (B, Sq, Sk, q_offset, k_offset, dtype)
    cases = [(2, 512, 512, 0, 0, torch.bfloat16),
             (2, 2048, 2048, 0, 0, torch.bfloat16),
             (2, 1000, 1000, 0, 0, torch.bfloat16),
             (2, 512, 512, 512, 0, torch.bfloat16),
             (2, 512, 512, 0, 200, torch.bfloat16),   # 200 fully masked rows
             (2, 700, 700, 0, 0, torch.float32)]
    max_err = 0.0
    for b, sq, sk, q_off, k_off, dtype in cases:
        q, k, v = rand(b, sq, dtype), rand(b, sk, dtype), rand(b, sk, dtype)
        out, lse = flash_attention_with_lse(q, k, v, True, None, q_off, k_off)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, True, None,
                                                          q_off, k_off)
        bf16 = dtype == torch.bfloat16
        out_tol, lse_tol = (2e-2, 1e-3) if bf16 else (1e-4, 1e-4)
        err, norm_err = out_errs(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"flash_attention_with_lse B={b} Sq={sq} Sk={sk} "
              f"q_offset={q_off} k_offset={k_off} {dtype}: out "
              f"max_abs_err={err:.3e} (tol {out_tol}), ||d||/||ref|| "
              f"{norm_err:.3e} (tol {OUT_NORM_TOL[dtype]}), lse "
              f"max_abs_err={lse_err:.3e} (tol {lse_tol})")
        require(err <= out_tol and norm_err <= OUT_NORM_TOL[dtype]
                and lse_err <= lse_tol,
                f"flash lse kernel disagrees at Sq={sq} offsets "
                f"{q_off}/{k_off} {dtype}")
        if k_off > q_off:
            masked = k_off - q_off
            require(bool((lse[:, :masked] <= NEG_INF / 2).all()) and
                    torch.count_nonzero(out[:, :masked]).item() == 0,
                    "fully masked rows are not zero / NEG_INF")
        if bf16:
            max_err = max(max_err, err)

    # timing at the training shape: every block's forward
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 8, 128
    q, k, v = (rand(b, s, torch.bfloat16) for _ in range(3))
    ms = graph_ms(lambda: flash_attention_with_lse(q, k, v, True))
    plain_ms = graph_ms(lambda: flash_attention_with_lse_plain(q, k, v, True),
                        calls=3)
    # the library call with the same outputs: PyTorch's flash forward,
    # which returns the log-sum-exp too (in (B, H, S))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(
        lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True))
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)        # QK^T + PV, causal
    nbytes = 4.0 * b * s * h * d * 2 + b * s * h * 4    # q, k, v, out; lse
    bound, bound_by = attention_bound(flops, nbytes)
    print(f"timing flash_attention_with_lse (8,2048,8,128) causal bf16, "
          f"device time (CUDA graph): {ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"aten flash forward with lse {lib_ms:.4f} ms; bound {bound:.4f} "
          f"ms ({bound_by}); {k1_rates(flops, ms, lib_ms, bound)} [{card}]")
    return {"name": "flash_attention[lse]", "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}


def phase_backward(dev, card) -> list:
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_with_lse_plain,
        flash_block_grads_plain, flash_bwd_dkv, flash_bwd_dq)
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand(b, s, dtype, d=128):
        return torch.randn((b, s, 8, d), generator=gen, device=dev).to(dtype)

    def check_grads(what, got, ref, dtype):
        # bf16: max 2e-2 and norm 1e-2 of the reference; f32: 1e-4 both
        max_tol, norm_tol = (2e-2, 1e-2) if dtype == torch.bfloat16 else (
            1e-4, 1e-4)
        errs_ = [grad_errs(a, r) for a, r in zip(got, ref)]
        print(f"{what}: max|d|/max|ref| dq {errs_[0][0]:.3e} dk "
              f"{errs_[1][0]:.3e} dv {errs_[2][0]:.3e} (tol {max_tol}); "
              f"||d||/||ref|| dq {errs_[0][1]:.3e} dk {errs_[1][1]:.3e} dv "
              f"{errs_[2][1]:.3e} (tol {norm_tol})")
        require(all(m <= max_tol and n <= norm_tol for m, n in errs_),
                f"{what} disagrees")

    # (B, Sq, Sk, causal, q_offset, k_offset, dtype, head dim)
    cases = [(2, 512, 512, True, 0, 0, torch.bfloat16, 128),
             (2, 2048, 2048, True, 0, 0, torch.bfloat16, 128),
             (2, 1000, 1000, True, 0, 0, torch.bfloat16, 128),
             (2, 768, 1280, False, 0, 0, torch.bfloat16, 128),
             (2, 512, 512, True, 512, 256, torch.bfloat16, 128),
             (2, 129, 129, True, 0, 0, torch.bfloat16, 128),
             (2, 2048, 2048, True, 0, 0, torch.bfloat16, 64),
             (2, 700, 700, True, 0, 0, torch.float32, 128)]
    errs = {"dq": 0.0, "dkv": 0.0}
    for b, sq, sk, causal, q_off, k_off, dtype, d in cases:
        scale = d ** -0.5
        args = backward_inputs(gen, b, sq, sk, causal, q_off, k_off, dtype,
                               d)
        dq = flash_bwd_dq(*args, causal, scale, q_off, k_off)
        dk, dv = flash_bwd_dkv(*args, causal, scale, q_off, k_off)
        torch.cuda.synchronize()
        ref = flash_block_grads_plain(*args, causal, scale, q_off, k_off)
        check_grads(f"flash backward B={b} Sq={sq} Sk={sk} D={d} "
                    f"causal={causal} offsets {q_off}/{k_off} {dtype}",
                    (dq, dk, dv), ref, dtype)
        if dtype == torch.bfloat16 and sq == 2048:
            # one writer per output, no atomics: a second launch on the
            # same inputs gives the same bits
            again = (flash_bwd_dq(*args, causal, scale, q_off, k_off),
                     *flash_bwd_dkv(*args, causal, scale, q_off, k_off))
            torch.cuda.synchronize()
            same = all(torch.equal(a, r)
                       for a, r in zip(again, (dq, dk, dv)))
            print(f"flash backward D={d} repeat: bitwise equal {same}")
            require(same, f"two backward launches differ at D={d}")
        if dtype == torch.bfloat16:
            errs["dq"] = max(errs["dq"], (dq.float() - ref[0].float()).abs()
                             .max().item())
            errs["dkv"] = max(errs["dkv"], *((a.float() - r.float()).abs()
                                             .max().item()
                                             for a, r in zip((dk, dv),
                                                             ref[1:])))

    # the autograd wiring: grads through flash_attention vs plain autograd
    for s, dtype in ((2048, torch.bfloat16), (700, torch.float32)):
        q, k, v, do = (rand(2, s, dtype).requires_grad_() for _ in range(4))
        got = torch.autograd.grad(flash_attention(q, k, v, causal=True),
                                  (q, k, v), do.detach())
        torch.cuda.synchronize()
        ref = torch.autograd.grad(
            flash_attention_with_lse_plain(q, k, v, True)[0], (q, k, v),
            do.detach())
        check_grads(f"autograd through flash_attention S={s} {dtype} vs "
                    f"plain autograd", got, ref, dtype)

    # timing at the training shape: every block's backward; head dim 64
    # (the long-context width) printed beside it
    timed = time_backward(card, gen, 128)
    time_backward(card, gen, 64)
    entries = []
    for name, err in (("flash_bwd_dq", errs["dq"]),
                      ("flash_bwd_dkv", errs["dkv"])):
        entries.append({
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_backward.cu",
            "replaces": ("mmlspark_tpu/ops/flash_attention.py:318"
                         if name == "flash_bwd_dq" else
                         "mmlspark_tpu/ops/flash_attention.py:330"),
            "max_abs_err": err, **timed[name]})
    return entries


def backward_inputs(gen, b, sq, sk, causal, q_off, k_off, dtype, d=128):
    """q, k, v, dout (B, S, 8, d) from `gen`, and the plain forward's lse
    and delta = rowsum(dout * out)."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse_plain)

    def rand(s):
        return torch.randn((b, s, 8, d), generator=gen,
                           device=gen.device).to(dtype)
    q, do, k, v = rand(sq), rand(sq), rand(sk), rand(sk)
    out, lse = flash_attention_with_lse_plain(q, k, v, causal, None, q_off,
                                              k_off)
    return q, k, v, do, lse, (do.float() * out.float()).sum(-1)


def grad_errs(got, ref) -> tuple:
    """(max|d|/max|ref|, ||d||_F/||ref||_F).  The first is loose at bf16
    (the first rows' gradients are far larger than a late row's, so its
    limit exceeds a late entry); the norm-relative error sees a tile of
    keys or queries dropped or counted twice."""
    d, r = got.float() - ref.float(), ref.float()
    return (d.abs().max() / r.abs().max()).item(), (d.norm()
                                                    / r.norm()).item()


def time_backward(card, gen, d: int) -> dict:
    """K2 and K3 at (8, 2048, 8, d) causal bf16 against the plain version
    and the library's backward pair (PyTorch's flash backward on its own
    forward's saved outputs), all from CUDA graphs: per kernel its ms,
    plain_ms, bound_ms, bound_by and library_ms (the pair)."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_block_grads_plain, flash_bwd_dkv, flash_bwd_dq)
    b, s, h = TRAIN_BATCH, TRAIN_SEQ, 8
    scale = d ** -0.5
    args = backward_inputs(gen, b, s, s, True, 0, 0, torch.bfloat16, d)
    dq_ms = graph_ms(lambda: flash_bwd_dq(*args, True, scale))
    dkv_ms = graph_ms(lambda: flash_bwd_dkv(*args, True, scale))
    plain_ms = graph_ms(lambda: flash_block_grads_plain(*args, True, scale),
                        calls=3)
    q, k, v, do = (t.transpose(1, 2) for t in args[:4])
    saved = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, True, scale=scale)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = saved[:8]

    def sdpa_backward():
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, True,
            seed, offset, scale=scale)
    lib_dq = sdpa_backward()[0].transpose(1, 2)
    torch.cuda.synchronize()
    ref_dq = flash_block_grads_plain(*args, True, scale)[0]
    lib_err = grad_errs(lib_dq, ref_dq)[1]
    print(f"aten flash backward D={d} dq vs plain: ||d||/||ref|| "
          f"{lib_err:.3e}")
    require(lib_err <= 1e-2, "the library backward is not the same function")
    sdpa_bwd_ms = graph_ms(sdpa_backward)
    del saved, out, lse, lib_dq, ref_dq
    tri = s * (s + 1) / 2
    io = 4.0 * b * s * h * d * 2 + 2.0 * b * s * h * 4  # q, k, v, dO; lse, delta
    timed = {}
    for name, ms, products, outs in (("flash_bwd_dq", dq_ms, 3, 1),
                                     ("flash_bwd_dkv", dkv_ms, 4, 2)):
        flops = products * 2.0 * b * h * d * tri
        bound, bound_by = attention_bound(flops, io + outs * b * s * h * d * 2)
        print(f"timing {name} (8,2048,8,{d}) causal bf16, device time (CUDA "
              f"graph): {ms:.4f} ms; plain (dq, dk, dv together) "
              f"{plain_ms:.4f} ms; aten flash backward (pair, CUDA graph) "
              f"{sdpa_bwd_ms:.4f} ms; bound {bound:.4f} ms ({bound_by}); "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / sdpa_bwd_ms:.2f}x the "
              f"library pair, {bound / ms:.3f} of the bound [{card}]")
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by, "library_ms": sdpa_bwd_ms}
    pair_bound = sum(t["bound_ms"] for t in timed.values())
    print(f"timing K2 + K3 (8,2048,8,{d}) causal bf16: {dq_ms + dkv_ms:.4f} "
          f"ms, {(dq_ms + dkv_ms) / sdpa_bwd_ms:.2f}x the library pair, "
          f"{pair_bound / (dq_ms + dkv_ms):.3f} of the bound [{card}]")
    del args
    torch.cuda.empty_cache()
    return timed


def phase_decode(dev, card) -> list:
    from mmlspark_tpu_torch.ops.decode_attention import (
        _sm_count, _span_plan, fused_single_query_attention,
        fused_single_query_attention_plain)
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
    span, n_spans = _span_plan(window, b * h, _sm_count(q.device))
    for kind, kc, vc, kw in (("model", k, v, {}),
                             ("int8", kq, vq, dict(k_scale=ks, v_scale=vs))):
        def call():
            return fused_single_query_attention(q, kc, vc, visible, **kw)
        repeat_and_graph_check(call, f"fused_single_query_attention "
                                     f"(8,1152,8,128) cache={kind}")
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
              f"cache={kind}, {n_spans} spans of {span} slots, device time "
              f"(CUDA graph): {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s); one eager call incl. host "
              f"launch {call_ms:.4f} ms; plain {plain_ms:.4f} ms; SDPA "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
              f"{max(bound_b, bound_f):.4f} ms, "
              f"{max(bound_b, bound_f) / ms:.3f} of it [{card}]")
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
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    _forward_with_cache,
                                                    naive_generate)
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
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = stage.transform(table)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = read_counts()
        counts[kv or "model"] = (launched["flash_attention"],
                                 launched["fused_single_query_attention"])
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
        if kv is None:
            breakdown["model"] = device_breakdown(
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
        kernel_logits = _forward_with_cache(ServingWeights(module32),
                                            prompts, caches, 0)
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


def stats_bound(b: int, h: int, d: int, n_visible: int, window: int,
                item: int, quantized: bool) -> tuple:
    """(bound ms, "bytes" | "operations") of one single-query cache read:
    the K and V rows of the visible slots (and their int8 scales), the
    mask, q in and the f32 outputs, over the HBM rate; its 4 f32 FLOPs
    per visible element over the f32 peak."""
    nbytes = (2.0 * n_visible * h * d * item + b * window + b * h * d * 4
              + b * h * d * 4 + 2 * b * h * 4)
    if quantized:
        nbytes += 2.0 * n_visible * h * 4
    bound_b = nbytes / PEAK_BYTES * 1e3
    bound_f = 4.0 * n_visible * h * d / PEAK_F32_FLOPS * 1e3
    return max(bound_b, bound_f), ("bytes" if bound_b >= bound_f
                                   else "operations")


def phase_decode_stats(dev, card) -> list:
    """K4[stats] against its plain version: bf16 caches and int8 caches
    (with f32 q), head dims 64 and 128, the long-context slab
    (2, 4224, 8, 64) and a window that is not a multiple of SPLIT; the
    fully masked last row must be exactly the merge identity.  Tolerances:
    acc and l within 1e-4 of their largest |value|, m within 1e-4
    absolute (f32 arithmetic on both sides, summed in another order).
    Then the times of K4[stats] at the slab and of K4 at head dim 64 on
    the seq=1 engine's window (2, 8448, 8, 64)."""
    from mmlspark_tpu_torch.ops.attention import NEG_INF
    from mmlspark_tpu_torch.ops.decode_attention import (
        SPLIT, _sm_count, _span_plan, fused_single_query_attention,
        fused_single_query_attention_plain,
        fused_single_query_attention_stats,
        fused_single_query_attention_stats_plain)
    from mmlspark_tpu_torch.quant.quantize import quantize_kv
    gen = torch.Generator(device=dev).manual_seed(5)
    b, h = LC_BATCH, LC_CONFIG["n_heads"]
    slab = (LC_CONTEXT + LC_CHUNK) // 2       # one of two shards' window

    def inputs(window, d, kind, full=False):
        q = torch.randn((b, h, d), generator=gen, device=dev).to(
            torch.float32 if kind == "int8" else torch.bfloat16)
        k, v = (torch.randn((b, window, h, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        # the second shard's layout: prompt slots, a hole, decode slots
        slots = torch.arange(window, device=dev)
        hole = window - window // 16
        visible = ((slots < window - window // 8)
                   | ((slots >= hole) & (slots <= hole + 5)))
        visible = visible[None].repeat(b, 1)
        if full:
            visible[:] = True
        else:
            visible[-1] = False
        kw = {}
        if kind == "int8":
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            kw = dict(k_scale=ks, v_scale=vs)
        return q, k, v, visible.contiguous(), kw

    errs = {"model": 0.0, "int8": 0.0}
    ragged = SPLIT * 15 + 37
    for window, d, kind in ((slab, 64, "model"), (slab, 64, "int8"),
                            (slab, 128, "model"), (slab, 128, "int8"),
                            (ragged, 64, "model"), (ragged, 128, "int8")):
        q, k, v, visible, kw = inputs(window, d, kind)
        acc, m, l = fused_single_query_attention_stats(q, k, v, visible, **kw)
        torch.cuda.synchronize()
        r_acc, r_m, r_l = fused_single_query_attention_stats_plain(
            q, k, v, visible, **kw)
        e_acc = ((acc - r_acc).abs().max() / r_acc.abs().max()).item()
        e_l = ((l - r_l).abs().max() / r_l.abs().max()).item()
        e_m = (m[:-1] - r_m[:-1]).abs().max().item()
        abs_err = max((acc - r_acc).abs().max().item(), e_m,
                      (l - r_l).abs().max().item())
        print(f"fused_single_query_attention_stats B={b} L={window} H={h} "
              f"D={d} cache={kind} q={q.dtype}: acc {e_acc:.3e}, l "
              f"{e_l:.3e} of max|ref| (tol 1e-4); m max_abs_err {e_m:.3e} "
              f"(tol 1e-4)")
        require(e_acc <= 1e-4 and e_l <= 1e-4 and e_m <= 1e-4,
                f"stats kernel disagrees at L={window} D={d} {kind}")
        require(bool((m[-1] == NEG_INF).all()) and bool((l[-1] == 0).all())
                and torch.count_nonzero(acc[-1]).item() == 0,
                "a fully masked row is not m = NEG_INF, l = 0, acc = 0")
        errs[kind] = max(errs[kind], abs_err)

    entries = []
    for kind in ("model", "int8"):
        q, k, v, visible, kw = inputs(slab, 64, kind, full=True)
        span, n_spans = _span_plan(slab, b * h, _sm_count(q.device))
        repeat_and_graph_check(
            lambda: fused_single_query_attention_stats(q, k, v, visible,
                                                       **kw),
            f"fused_single_query_attention_stats ({b},{slab},{h},64) "
            f"cache={kind}")
        ms = graph_ms(lambda: fused_single_query_attention_stats(
            q, k, v, visible, **kw))
        plain_ms = graph_ms(lambda: fused_single_query_attention_stats_plain(
            q, k, v, visible, **kw))
        bound, bound_by = stats_bound(b, h, 64, int(visible.sum().item()),
                                      slab, k.element_size(), kind == "int8")
        print(f"timing fused_single_query_attention_stats ({b},{slab},{h},64)"
              f" cache={kind}, every slot visible, {n_spans} spans of {span}"
              f" slots, device time (CUDA graph): {ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms; library none (no PyTorch call returns "
              f"the unnormalized triple); bound {bound:.4f} ms ({bound_by}),"
              f" {bound / ms:.3f} of it [{card}]")
        entries.append({
            "name": ("fused_single_query_attention_stats" if kind == "model"
                     else "fused_single_query_attention_stats[int8]"),
            "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/decode_attention.cu",
            "replaces": "mmlspark_tpu/ops/decode_attention.py:245 "
                        "(fused_single_query_attention_stats, :326)",
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None})

    # K4 at head dim 64 on the seq=1 engine's window
    window, bucket = LC_CONTEXT + LC_CHUNK, LC_CONTEXT
    q = torch.randn((b, h, 64), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, window, h, 64), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    visible = engine_mask(b, window, bucket, bucket + 15,
                          torch.full((b,), bucket, device=dev))
    got = fused_single_query_attention(q, k, v, visible)
    torch.cuda.synchronize()
    err = (got - fused_single_query_attention_plain(q, k, v, visible)
           ).abs().max().item()
    require(err <= 2e-3, "decode kernel disagrees at head dim 64")
    repeat_and_graph_check(
        lambda: fused_single_query_attention(q, k, v, visible),
        f"fused_single_query_attention ({b},{window},{h},64)")
    span, n_spans = _span_plan(window, b * h, _sm_count(q.device))
    ms = graph_ms(lambda: fused_single_query_attention(q, k, v, visible))
    plain_ms = graph_ms(lambda: fused_single_query_attention_plain(
        q, k, v, visible))
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=visible[:, None, None, :]))
    bound, bound_by = stats_bound(b, h, 64, int(visible.sum().item()),
                                  window, 2, False)
    print(f"fused_single_query_attention ({b},{window},{h},64) bf16 cache: "
          f"max_abs_err={err:.3e} (tol 2e-3); {n_spans} spans of {span} "
          f"slots; device time (CUDA graph) {ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms ({ms / lib_ms:.2f}x); "
          f"bound {bound:.4f} ms ({bound_by}), {bound / ms:.3f} of it "
          f"[{card}]")
    entries.append({
        "name": "fused_single_query_attention[d64]", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/decode_attention.cu",
        "replaces": "mmlspark_tpu/ops/decode_attention.py:245",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms})
    return entries


def phase_ring_lse(dev, card) -> list:
    """K1[lse] at head dim 64 against plain on the ring prefill's (shard,
    block) pairs of two shards: (2, 4096, 8, 64) causal with q_offset /
    k_offset 0/0, 4096/0 and 4096/4096 in bf16, 4096/0 in f32; and K1 on
    the seq=1 engine's whole prompt (2, 8192, 8, 64).  Tolerances at bf16:
    out within 2e-2 absolute AND ||d||_F within 1e-2 of ||ref||_F (see
    `out_errs`), lse within 1e-3; 1e-4 each at f32.  Then the times of
    both."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain, flash_attention_with_lse,
        flash_attention_with_lse_plain)
    gen = torch.Generator(device=dev).manual_seed(6)
    b, h, s_l = LC_BATCH, LC_CONFIG["n_heads"], LC_CONTEXT // 2

    def rand(s, dtype):
        return torch.randn((b, s, h, 64), generator=gen, device=dev).to(dtype)

    max_err = 0.0
    for q_off, k_off, dtype in ((0, 0, torch.bfloat16),
                                (s_l, 0, torch.bfloat16),
                                (s_l, s_l, torch.bfloat16),
                                (s_l, 0, torch.float32)):
        q, k, v = (rand(s_l, dtype) for _ in range(3))
        out, lse = flash_attention_with_lse(q, k, v, True, None, q_off, k_off)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, True, None,
                                                          q_off, k_off)
        bf16 = dtype == torch.bfloat16
        out_tol, lse_tol = (2e-2, 1e-3) if bf16 else (1e-4, 1e-4)
        err, norm_err = out_errs(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"flash_attention_with_lse B={b} S={s_l} H={h} D=64 causal "
              f"q_offset={q_off} k_offset={k_off} {dtype}: out "
              f"max_abs_err={err:.3e} (tol {out_tol}), ||d||/||ref|| "
              f"{norm_err:.3e} (tol {OUT_NORM_TOL[dtype]}), lse max_abs_err="
              f"{lse_err:.3e} (tol {lse_tol})")
        require(err <= out_tol and norm_err <= OUT_NORM_TOL[dtype]
                and lse_err <= lse_tol,
                f"flash lse kernel disagrees at head dim 64, offsets "
                f"{q_off}/{k_off} {dtype}")
        if bf16:
            max_err = max(max_err, err)

    # the full off-diagonal pair: every key visible to every query
    q, k, v = (rand(s_l, torch.bfloat16) for _ in range(3))
    ms = graph_ms(lambda: flash_attention_with_lse(q, k, v, True, None, s_l,
                                                   0))
    plain_ms = graph_ms(lambda: flash_attention_with_lse_plain(
        q, k, v, True, None, s_l, 0), calls=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, False))
    flops = 4.0 * b * h * 64 * s_l * s_l
    bound, bound_by = attention_bound(flops, 4.0 * b * s_l * h * 64 * 2
                                      + b * s_l * h * 4)
    print(f"timing flash_attention_with_lse ({b},{s_l},{h},64) q_offset "
          f"{s_l} k_offset 0 (no key masked) bf16, device time (CUDA "
          f"graph): {ms:.4f} ms; plain {plain_ms:.4f} ms; aten flash "
          f"forward with lse, non-causal {lib_ms:.4f} ms; bound {bound:.4f} "
          f"ms ({bound_by}); {k1_rates(flops, ms, lib_ms, bound)} [{card}]")
    entries = [{
        "name": "flash_attention[lse,d64]", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms}]
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # K1 over the seq=1 engine's whole prompt
    s = LC_CONTEXT
    q, k, v = (rand(s, torch.bfloat16) for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, norm_err = out_errs(got, flash_attention_plain(q, k, v, causal=True))
    print(f"flash_attention ({b},{s},{h},64) causal bf16: max_abs_err="
          f"{err:.3e} (tol 2e-2), ||d||/||ref|| {norm_err:.3e} (tol "
          f"{OUT_NORM_TOL[torch.bfloat16]})")
    require(err <= 2e-2 and norm_err <= OUT_NORM_TOL[torch.bfloat16],
            "flash kernel disagrees at head dim 64")
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = graph_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        calls=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4.0 * b * h * 64 * (s * (s + 1) / 2)
    bound, bound_by = attention_bound(flops, 4.0 * b * s * h * 64 * 2)
    print(f"timing flash_attention ({b},{s},{h},64) causal bf16, device "
          f"time (CUDA graph): {ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({bound_by}); "
          f"{k1_rates(flops, ms, lib_ms, bound)} [{card}]")
    entries.append({
        "name": "flash_attention[d64]", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": lib_ms})
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return entries


def host_ms(fn, reps: int = 10) -> list:
    """Host wall times (ms, sorted) of `reps` calls that end synchronized.
    The seq path launches many small kernels from the host, and a one-card
    host shares its cores, so its spread is reported, not only its median."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def phase_long_context(dev, card) -> dict:
    """The seq-sharded long-context path at full width: `DecodeEngine` at
    seq=1 and over a seq=2 mesh whose two shards share this card, on the
    repo's long-context configuration with weights and prompts from a
    seed.  At f32 the greedy tokens must be identical; at bf16 the
    last-position prefill logits must agree within 5e-2 of their largest
    |value| (bf16 rounding of the activations along two attention
    orders), and token agreement is printed with the first differing step
    and the plain forward's top-2 logit margin there.  The seq=2 run must
    launch K4[stats] n_layers x steps x shards times and K1[lse] n_layers
    x the live (shard, block) pairs."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models import DecodeEngine
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    _forward_with_cache)
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    n_layers, shards = LC_CONFIG["n_layers"], 2
    steps = LC_NEW - 1
    mesh = make_mesh(MeshSpec(data=1, model=1, seq=shards),
                     [torch.device(dev.type, 0)] * shards)
    bundle = ModelBundle.init("TransformerLM", LC_CONFIG, seed=0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, LC_CONFIG["vocab_size"],
                           (LC_BATCH, LC_CONTEXT)).astype(np.int32)
    true_len = np.full(LC_BATCH, LC_CONTEXT, np.int32)
    out: dict = {"shards_share_one_card": True}

    def engines(b, **kw):
        weights = ServingWeights(b.module(dev))
        return {seq: DecodeEngine(weights, LC_NEW, chunk=LC_CHUNK,
                                  mesh=None if seq == 1 else mesh,
                                  device=dev, **kw) for seq in (1, shards)}

    def run(engine):
        engine.generate(prompts, true_len)            # warm-up
        torch.cuda.synchronize()
        reset_counts()
        tokens = engine.generate(prompts, true_len)
        torch.cuda.synchronize()
        return tokens, read_counts()

    def last_logits(engine, seq):
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        tl = torch.as_tensor(true_len, dtype=torch.long, device=dev)
        with torch.inference_mode():
            if seq == 1:
                w = engine.weights
                shape = (LC_BATCH, LC_CONTEXT + LC_CHUNK, w.n_heads,
                         w.d_model // w.n_heads)
                caches = [(torch.zeros(shape, dtype=w.dtype, device=dev),
                           torch.zeros(shape, dtype=w.dtype, device=dev))
                          for _ in range(w.n_layers)]
                logits = _forward_with_cache(w, tokens, caches, 0)
                return logits[torch.arange(LC_BATCH, device=dev), tl - 1]
            return engine._ring_prefill(tokens, tl, mesh.seq_rings()[0])[0]

    # bf16, model-dtype cache: the path the counts are read from
    eng = engines(bundle)
    tokens, counts = {}, {}
    for seq in (1, shards):
        tokens[seq], counts[seq] = run(eng[seq])
        once = DecodeEngine(eng[seq].weights, 1, chunk=LC_CHUNK,
                            mesh=eng[seq].mesh, device=dev)
        once.generate(prompts, true_len)
        prefills = host_ms(lambda: once.generate(prompts, true_len))
        totals = host_ms(lambda: eng[seq].generate(prompts, true_len))
        prefill_ms = statistics.median(prefills)
        # decode ms/step: each generate's time less the median prefill
        decode = [(t - prefill_ms) / steps for t in totals]
        out[f"seq{seq}"] = {"prefill_ms": prefill_ms,
                            "prefill_ms_all": prefills,
                            "decode_ms_per_step": statistics.median(decode),
                            "decode_ms_per_step_all": decode,
                            "generate_ms": statistics.median(totals),
                            "device_breakdown": device_breakdown(
                                lambda: eng[seq].generate(prompts, true_len),
                                card, LC_GROUPS)}
        print(f"long-context seq={seq}"
              f"{' (both shards on this one card)' if seq > 1 else ''}, "
              f"{len(totals)} runs each, median [min, max]: prefill "
              f"{prefill_ms:.3f} [{prefills[0]:.3f}, {prefills[-1]:.3f}] ms "
              f"(generate with 1 new token); decode "
              f"{statistics.median(decode):.3f} [{decode[0]:.3f}, "
              f"{decode[-1]:.3f}] ms/step ({LC_BATCH} rows x {LC_NEW} tokens "
              f"in {statistics.median(totals):.3f} ms); launches "
              f"{counts[seq]} [{card}]")
    want_stats = n_layers * steps * shards
    want_lse = n_layers * shards * (shards + 1) // 2
    got = counts[shards]
    require(got["fused_single_query_attention_stats"] == want_stats,
            f"K4[stats] launched {got['fused_single_query_attention_stats']}"
            f" times, want {want_stats}")
    require(got["flash_attention[lse]"] == want_lse,
            f"K1[lse] launched {got['flash_attention[lse]']} times, want "
            f"{want_lse}")
    require(got["flash_attention"] == 0 and
            got["fused_single_query_attention"] == 0,
            "the seq path launched the whole-window kernels")
    require(counts[1]["flash_attention"] == n_layers and
            counts[1]["fused_single_query_attention"] == n_layers * steps,
            "the seq=1 engine skipped its kernels")
    out["counts"] = {1: counts[1], shards: got}
    ref, seq_logits = last_logits(eng[1], 1), last_logits(eng[shards], shards)
    rel = ((ref - seq_logits).abs().max() / ref.abs().max()).item()
    same = tokens[1] == tokens[shards]
    first = [int(np.argmin(row)) if not row.all() else None for row in same]
    margins = []
    if any(t is not None for t in first):
        # the plain bf16 forward's top-2 gap at each row's first
        # differing step
        module = ModelBundle("TransformerLM", {**LC_CONFIG,
                                               "attn_impl": "flash"},
                             bundle.variables).module(dev)
        for r, t in enumerate(first):
            if t is None:
                continue
            seqs = np.concatenate([prompts[r], tokens[1][r, :t]])[None]
            with torch.inference_mode():
                top = torch.topk(module(torch.as_tensor(
                    seqs, dtype=torch.long, device=dev))[0, -1], 2).values
            margins.append((r, t, (top[0] - top[1]).item()))
        del module
    print(f"long-context bf16: last-position prefill logits seq={shards} vs "
          f"seq=1 max|d|/max|ref| {rel:.3e} (tol 5e-2); greedy tokens equal "
          f"{int(same.sum())}/{same.size}; first differing step per row "
          f"{first}; plain forward top-2 margin there (row, step, margin) "
          f"{margins}")
    require(rel <= 5e-2, "bf16 prefill logits of the two engines disagree")
    out["bf16"] = {"logits_rel_err": rel,
                   "tokens_match": int(same.sum()) / same.size,
                   "first_differing_step": first, "margins": margins}
    del eng
    torch.cuda.empty_cache()

    # bf16, int8 cache: K4[stats] over int8 slabs
    eng = engines(bundle, cache_dtype="int8")
    tok8, counts8 = run(eng[shards])
    ref8 = eng[1].generate(prompts, true_len)
    out["int8"] = {"tokens_match": float((tok8 == ref8).mean()),
                   "stats_launches":
                       counts8["fused_single_query_attention_stats"]}
    print(f"long-context bf16 int8 cache: seq={shards} vs seq=1 greedy "
          f"tokens equal {float((tok8 == ref8).mean()):.4f}; launches "
          f"{counts8}")
    require(counts8["fused_single_query_attention_stats"] == want_stats,
            "K4[stats] on the int8 cache: launch count")
    del eng
    torch.cuda.empty_cache()

    # f32: greedy tokens identical, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle32 = ModelBundle("TransformerLM", {**LC_CONFIG, "dtype": "float32"},
                           bundle.variables)
    eng = engines(bundle32)
    tok32 = {seq: eng[seq].generate(prompts, true_len) for seq in eng}
    ref = last_logits(eng[1], 1)
    rel32 = ((ref - last_logits(eng[shards], shards)).abs().max()
             / ref.abs().max()).item()
    match = bool(np.array_equal(tok32[1], tok32[shards]))
    print(f"long-context f32: greedy tokens seq={shards} vs seq=1 identical "
          f"{match} ({LC_BATCH} x {LC_NEW}); last-position prefill logits "
          f"max|d|/max|ref| {rel32:.3e}")
    require(match, "f32 greedy tokens of the seq engine differ from seq=1")
    out["f32"] = {"tokens_identical": match, "logits_rel_err": rel32}
    del eng
    torch.cuda.empty_cache()
    return out


def char_corpus(n_rows: int, seq: int, vocab: int) -> np.ndarray:
    """Example 401's learnable corpus: rows cycle the vocabulary from a
    random phase, seq + 1 tokens each (inputs and targets are slices)."""
    rng = np.random.default_rng(41)
    starts = rng.integers(0, vocab, size=(n_rows, 1))
    return ((starts + np.arange(seq + 1)) % vocab).astype(np.int32)


def train_config(model_config: dict):
    from mmlspark_tpu_torch import TrainerConfig
    return TrainerConfig(
        architecture="TransformerLM", model_config=model_config,
        optimizer="adam", learning_rate=3e-4, batch_size=TRAIN_BATCH,
        epochs=2, loss="softmax_xent", seed=0)


def phase_train(dev, card) -> dict:
    """The training path at full width through `Trainer.fit_arrays`."""
    from mmlspark_tpu_torch import DataTable, TextGenerator, Trainer
    from mmlspark_tpu_torch.utils.perf import lm_train_flops
    vocab, n_layers = LM_CONFIG["vocab_size"], LM_CONFIG["n_layers"]
    rows = char_corpus(TRAIN_ROWS, TRAIN_SEQ, vocab)
    tokens, targets = rows[:, :-1], rows[:, 1:]
    model_config = {**LM_CONFIG, "attn_impl": "flash"}
    trainer = Trainer(train_config(model_config), device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bundle = trainer.fit_arrays(tokens, targets, log_fn=print)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = read_counts()
    steps = bundle.metadata["steps"]
    losses = [r["loss"] for r in trainer.history]
    print(f"training path: {steps} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens "
          f"in {seconds:.3f} s; history {trainer.history}; launches "
          f"{launched} [{card}]")
    require(steps == TRAIN_ROWS // TRAIN_BATCH * 2, "metadata steps")
    require(all(np.isfinite(losses)), "non-finite training loss")
    require(losses[1] < losses[0], "the loss did not fall")
    for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
        require(launched[name] == n_layers * steps,
                f"{name} launched {launched[name]} times, want "
                f"{n_layers * steps}")

    prompts = tokens[:4, :12]
    out = TextGenerator(bundle, device=dev, inputCol="prompt",
                        maxNewTokens=16).transform(
        DataTable({"prompt": prompts}))["generated"]
    out = np.asarray(out)
    require(out.shape == (4, 28) and ((out >= 0) & (out < vocab)).all(),
            "generation from the trained bundle")
    expect = (prompts[:, -1:] + 1 + np.arange(16)) % vocab
    print(f"trained bundle generates {out.shape}; continuation accuracy vs "
          f"the cycle {float((out[:, 12:] == expect).mean()):.3f}")

    # the step alone: ms (CUDA events), tokens/s, analytic MFU
    timer = Trainer(train_config(model_config), device=dev)
    state = timer.init_state(total_steps=16, initial_bundle=bundle)
    step = timer.make_train_step()
    xb = torch.from_numpy(tokens[:TRAIN_BATCH].astype(np.int64)).to(dev)
    yb = torch.from_numpy(targets[:TRAIN_BATCH].astype(np.int64)).to(dev)
    mb = torch.ones(TRAIN_BATCH, device=dev)
    step_ms = cuda_ms(lambda: step(state, xb, yb, mb), warmup=1, reps=5)
    n_tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = lm_train_flops(TRAIN_BATCH, TRAIN_SEQ, LM_CONFIG["d_model"],
                           n_layers, vocab)["total"]
    mfu = flops / (step_ms / 1e3) / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"timing train step {TRAIN_BATCH}x{TRAIN_SEQ} bf16 flash: "
          f"{step_ms:.3f} ms/step = {n_tokens / step_ms * 1e3:.1f} tokens/s; "
          f"analytic MFU {mfu:.4f} of 989 TFLOP/s ({flops / 1e12:.3f} "
          f"TFLOP/step); peak allocated {peak_gb:.2f} GiB [{card}]")
    breakdown = device_breakdown(lambda: step(state, xb, yb, mb), card,
                                 TRAIN_GROUPS)
    return {"counts": launched, "seconds": seconds, "history": trainer.history,
            "step_ms": step_ms, "tokens_per_s": n_tokens / step_ms * 1e3,
            "mfu": mfu, "device_breakdown": breakdown}


def phase_grad_check(dev, card) -> dict:
    """f32 gradients of every parameter through the flash kernels against
    the dense-attention model, on one (2, 2048) batch, TF32 off."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.train.trainer import make_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = char_corpus(2, TRAIN_SEQ, LM_CONFIG["vocab_size"])
    x = torch.from_numpy(rows[:, :-1].astype(np.int64)).to(dev)
    y = torch.from_numpy(rows[:, 1:].astype(np.int64)).to(dev)
    init = ModelBundle.init("TransformerLM", LM_CONFIG, seed=4)
    loss_fn = make_loss("softmax_xent")
    grads, losses = {}, {}
    for impl in ("flash", "dense"):
        module = ModelBundle("TransformerLM", {
            **LM_CONFIG, "dtype": "float32", "attn_impl": impl},
            init.variables).module(dev).train()
        loss = loss_fn(module(x), y, torch.ones(2, device=dev))
        loss.backward()
        torch.cuda.synchronize()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad for n, p in module.named_parameters()}
        del module, loss
    worst_name, worst = None, 0.0
    for name, g in grads["flash"].items():
        ref = grads["dense"][name]
        rel = ((g - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        if rel > worst:
            worst_name, worst = name, rel
    loss_diff = abs(losses["flash"] - losses["dense"])
    print(f"f32 gradient check (2, 2048), flash kernels vs dense attention: "
          f"loss {losses['flash']:.6f} vs {losses['dense']:.6f} (diff "
          f"{loss_diff:.3e}, tol 1e-4); worst parameter {worst_name} "
          f"max|d|/max|ref| {worst:.3e} (tol 1e-3)")
    require(loss_diff <= 1e-4, "f32 loss differs")
    require(worst <= 1e-3, f"f32 gradient of {worst_name} differs")
    del grads
    torch.cuda.empty_cache()
    return {"loss_diff": loss_diff, "worst_param": worst_name,
            "worst_rel_err": worst}


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
    k1_build = ptxas_report("flash_attention", "flash_fwd")
    bwd_build = ptxas_report("flash_backward", "flash_bwd")
    k4_build = ptxas_report("decode_attention", "sqa_")
    for row in k1_build + bwd_build + k4_build:
        print(f"ptxas {row['kernel']}: {row['registers']} registers, "
              f"{row['static_smem_bytes']} bytes static shared memory, "
              f"{row['spill_stores']} / {row['spill_loads']} bytes spill "
              f"stores / loads")
    require(len(k1_build) == 4 and not any(
        row["spill_stores"] or row["spill_loads"] for row in k1_build),
        "K1's build log lacks a kernel or reports spills")
    require(len(bwd_build) == 8 and not any(
        row["spill_stores"] or row["spill_loads"] for row in bwd_build
        if "bf16" in row["kernel"]),
        "K2/K3's build log lacks a kernel or reports spills in a bf16 kernel")
    require(len(k4_build) == 12 and not any(
        row["spill_stores"] or row["spill_loads"] for row in k4_build),
        "K4's build log lacks a kernel or reports spills")
    dev = torch.device("cuda")
    flash = phase_flash(dev, card)
    flash_lse = phase_flash_lse(dev, card)
    backward = phase_backward(dev, card)
    decode = phase_decode(dev, card)
    torch.cuda.empty_cache()
    main_path = phase_main_path(dev, card)
    torch.cuda.empty_cache()
    train = phase_train(dev, card)
    torch.cuda.empty_cache()
    decode_stats = phase_decode_stats(dev, card)
    ring_lse = phase_ring_lse(dev, card)
    long_context = phase_long_context(dev, card)
    torch.cuda.empty_cache()
    grad_check = phase_grad_check(dev, card)
    # launches: each kernel's count from the path that runs it (serving
    # for K1 and K4, training for K1[lse], K2 and K3)
    flash["launches"] = main_path["counts"]["model"][0]
    decode[0]["launches"] = main_path["counts"]["model"][1]
    decode[1]["launches"] = main_path["counts"]["int8"][1]
    flash_lse["launches"] = train["counts"]["flash_attention[lse]"]
    for entry in backward:
        entry["launches"] = train["counts"][entry["name"]]
    # the long-context path: K4[stats] and K1[lse] at head dim 64 from the
    # seq=2 engine, K1 and K4 at head dim 64 from the seq=1 engine
    seq1, seq2 = (long_context["counts"][n] for n in (1, 2))
    decode_stats[0]["launches"] = seq2["fused_single_query_attention_stats"]
    decode_stats[1]["launches"] = long_context["int8"]["stats_launches"]
    decode_stats[2]["launches"] = seq1["fused_single_query_attention"]
    ring_lse[0]["launches"] = seq2["flash_attention[lse]"]
    ring_lse[1]["launches"] = seq1["flash_attention"]
    kernels = [flash, flash_lse] + backward + decode + decode_stats + ring_lse
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"main_path": {k: v for k, v in main_path.items()
                                    if k != "counts"},
                      "train_path": {k: v for k, v in train.items()
                                     if k != "counts"},
                      "long_context": long_context,
                      "grad_check": grad_check, "k1_build": k1_build,
                      "bwd_build": bwd_build, "k4_build": k4_build,
                      "card": card}))
    print(card)
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
