"""The training window: `Trainer.fit_arrays`, the loop a fit runs, staging
and all.

Set-up makes the weights on the card from the seed and hands them to the
port as a bundle (the warm start of a fit), makes a pool of seeded rows,
builds one `Trainer`, and runs its fits from that bundle:

  * the check fits, on the pool's first rows (every row differs): one of
    one step, whose optimizer state gives the first gradient as the
    optimizer got it (Adam's first moment / (1 - b1); momentum's trace
    less the decayed weights), and one of `check_steps` steps under a
    tracer, whose step spans give each step's loss and whose end state
    gives each leaf's change, BatchNorm's running statistics included;
  * the window fit, long enough to outlast the window, its rows cycling
    through the pool.  A step hook (the chaos injector's `on_step`, which
    the fit calls before each step) opens the window after `warm_steps`
    steps, synchronized, and closes it, synchronized, at the first step
    boundary `seconds` later, then ends the fit.  `train_step_ms` is the
    window over the steps it holds; `train_tokens_per_s` (a token mix)
    their tokens over the window.

With `--trace 1` the fit's `PipelineTimings` are read over the window
(staging host and transfer, the dispatch thread's compute span) and the
device is profiled over `trace_steps` steps, `trace_after_steps` into the
window.

`correct`: once the window has closed and the Trainer is freed, the plain
reference trains the same steps from the same weights on the same rows
in float32 (`harness/compare.py` `train_numbers`).
"""

from __future__ import annotations

import math
import time

import torch

from cellbench.harness import compare, core, traffic
from cellbench.harness.trace import DeviceTrace


class WindowClosed(Exception):
    """Raised from the step hook to end the window fit."""


def _step_hook(fn):
    """A chaos injector with every fault off whose `on_step` calls `fn`."""
    from mmlspark_tpu_torch.resilience.chaos import ChaosInjector

    class StepHook(ChaosInjector):
        def on_step(self, step: int) -> None:
            fn(step)

    return StepHook(seed=0, net_error_rate=0.0, stall_rate=0.0, stall_s=0.0,
                    torn_ckpt_rate=0.0, preempt_at_step=0, nan_at_step=0,
                    hang_at_step=0, hang_s=0.0, torn_ckpt_target="payload",
                    script=[])


def pools(ctx: core.Context) -> tuple:
    cfg, mix, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    n = mix["pool_rows"]
    if mix["inputs"] == "tokens":
        return traffic.token_rows(n, mix["seq"], cfg["vocab_size"], seed, dev)
    return (traffic.images(n, cfg, seed, dev),
            traffic.labels(n, cfg["num_classes"], seed, dev))


def prepare(ctx: core.Context) -> dict:
    """The Trainer, the bundle of the seeded weights and the row pools."""
    from mmlspark_tpu_torch.models.bundle import ModelBundle, variables_to_jax
    from mmlspark_tpu_torch.train.config import TrainerConfig
    from mmlspark_tpu_torch.train.trainer import Trainer
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    prog, recipe = cfg["program"], mix["recipe"]
    weights = ctx.reference.make_weights(cfg, ctx.seed, dev)
    bundle = ModelBundle(prog["architecture"], dict(prog["model_config"]),
                         variables_to_jax(ctx.reference.port_state(weights,
                                                                   cfg)))
    del weights
    core.note(ctx, "weights made and handed over as a bundle")
    x, y = pools(ctx)
    core.free_device()
    tc = TrainerConfig(
        architecture=prog["architecture"],
        model_config=dict(prog["model_config"]),
        optimizer=recipe["optimizer"],
        learning_rate=recipe["learning_rate"],
        momentum=recipe.get("momentum", 0.9),
        weight_decay=recipe.get("weight_decay", 0.0),
        loss="softmax_xent", epochs=1, batch_size=mix["batch"], seed=0,
        shuffle_each_epoch=False, prefetch_depth=mix["prefetch_depth"],
        numerics_cadence=0)
    return {"trainer": Trainer(tc, device=dev), "bundle": bundle,
            "x": x, "y": y}


def _fit(p: dict, steps: int) -> None:
    rows = steps * p["trainer"].config.batch_size
    p["trainer"].fit_arrays(traffic.CyclicRows(p["x"], rows),
                            traffic.CyclicRows(p["y"], rows),
                            initial_bundle=p["bundle"], log_every=1 << 30,
                            log_fn=lambda _msg: None)


def _hooked_fit(p: dict, steps: int, on_step) -> None:
    """A fit of `steps` steps' rows with `on_step` as its step hook, which
    ends it by raising `WindowClosed`."""
    from mmlspark_tpu_torch.resilience.chaos import set_injector
    previous = set_injector(_step_hook(on_step))
    try:
        _fit(p, steps)
        raise RuntimeError(f"a fit of {steps} steps ended before its hook "
                           "closed it")
    except WindowClosed:
        pass
    finally:
        set_injector(previous)


def program_check(ctx: core.Context, p: dict) -> tuple:
    """The check fit: its first `check_steps` steps, on rows that all
    differ, under a tracer (each step span holds the step's loss).  Its
    step hook reads, in stream order, the optimizer's state after the
    first step (the first gradient as the optimizer got it: Adam's first
    moment / (1 - b1), momentum's trace less the decayed weights) and,
    before the step after the last, every leaf's change (parameters and
    BatchNorm's running statistics), copied to the host; then ends the
    fit.  Returns ({"losses", "grad": {leaf: norm}, "grad_tensors" and
    "change": {leaf: host tensor}}, the shortest synced step in
    seconds)."""
    from mmlspark_tpu_torch.observe.trace import Tracer, tracing
    recipe, trainer = ctx.traffic["recipe"], p["trainer"]
    n = ctx.traffic["check_steps"]
    seen: dict = {}

    def initial() -> dict:
        w = ctx.reference.make_weights(ctx.config, ctx.seed, ctx.device)
        return ctx.reference.port_state(w, ctx.config)

    def spy(update):
        def wrapped(grads, opt_state, params, return_updates=False):
            seen.setdefault("opt_state", opt_state)
            return update(grads, opt_state, params, return_updates)
        return wrapped

    def on_step(step: int) -> None:
        names = trainer._names
        if step == 0:
            trainer._tx.update = spy(trainer._tx.update)
        elif step == 1:
            opt = seen.pop("opt_state")
            if recipe["optimizer"] == "adam":
                b1 = recipe.get("b1", 0.9)
                grads = {k: m / (1 - b1) for k, m in zip(names, opt["mu"])}
            else:
                w0, wd = initial(), recipe.get("weight_decay", 0.0)
                grads = {k: t - wd * w0[k]
                         for k, t in zip(names, opt["trace"])}
            seen["grad"] = ctx.reference.leaf_norms(grads)
            seen["grad_tensors"] = {k: g.detach().cpu()
                                    for k, g in grads.items()}
            del trainer._tx.update, grads, opt   # the class's own again
        elif step == n:
            w0 = initial()
            leaves = dict(trainer.module.named_parameters())
            leaves.update(trainer.module.named_buffers())
            seen["change"] = {k: (leaves[k].detach() - w0[k]).cpu()
                              for k in w0}
            raise WindowClosed

    tracer = Tracer()
    with tracing(tracer):
        _hooked_fit(p, n + 1, on_step)
    core.free_device()
    core.note(ctx, "check fit done")
    spans = sorted((r for r in tracer.records()
                    if r["type"] == "span" and r["name"] == "train.step"),
                   key=lambda r: r["attrs"]["step"])
    losses = [float(r["attrs"]["loss"]) for r in spans]
    return ({"losses": losses, "grad": seen["grad"],
             "grad_tensors": seen["grad_tensors"], "change": seen["change"]},
            min(r["dur"] for r in spans))


def window(ctx: core.Context, p: dict, step_s: float) -> dict:
    """The window fit (module docstring)."""
    from mmlspark_tpu_torch.observe.spans import pipeline_timing
    mix, dev = ctx.traffic, ctx.device
    warm = mix["warm_steps"]
    first = warm + mix["trace_after_steps"]
    last = first + mix["trace_steps"]
    profiler = DeviceTrace(dev.type == "cuda") if ctx.trace else None
    w: dict = {}

    def on_step(step: int) -> None:
        clean = w["clean"]
        if step == warm:
            w["t0"] = clean.mark("open", step)
            return
        if step < warm:
            return
        if profiler is not None and step == first:
            clean.mark("start", step)
            profiler.start()
        elif profiler is not None and step == last:
            profiler.stop()
            clean.mark("stop", step)
        if time.perf_counter() - w["t0"] >= ctx.seconds:
            w["t1"] = clean.mark("close", step)
            w["steps"] = step - warm
            raise WindowClosed

    steps = warm + math.ceil(2 * ctx.seconds / step_s) + 8
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        with pipeline_timing() as timings:
            w["clean"] = core.Clean(dev, timings)
            _hooked_fit(p, steps, on_step)
    finally:
        if profiler is not None:
            profiler.stop()
    w["peak"] = core.peak_bytes(dev)
    w["clean_s"], w["clean_steps"], w["timings"] = w["clean"].totals()
    w["trace"] = profiler.reduce() if profiler is not None else None
    return w


def reference_check(ctx: core.Context, p: dict, quant=None,
                    half: bool = False) -> dict:
    """The reference's {"losses", "grad", "change"} over the check steps,
    from the seeded weights on the same rows (tensors on the device)."""
    mix, dev = ctx.traffic, ctx.device
    bs = mix["batch"]
    batches = [(torch.from_numpy(p["x"][k * bs:(k + 1) * bs]).to(dev),
                torch.from_numpy(p["y"][k * bs:(k + 1) * bs]).to(dev))
               for k in range(mix["check_steps"])]
    weights = ctx.reference.make_weights(ctx.config, ctx.seed, dev)
    out = ctx.reference.train_steps(weights, batches, ctx.config,
                                    mix["recipe"], quant=quant, half=half,
                                    rows=mix["reference_rows"])
    del weights, batches
    core.free_device()
    return out


def run(ctx: core.Context) -> core.Outcome:
    p = prepare(ctx)
    prog, step_s = program_check(ctx, p)
    w = window(ctx, p, step_s)
    setup_s = w["t0"] - ctx.t_start
    window_s = w["t1"] - w["t0"]
    p["trainer"] = None
    core.free_device()
    core.note(ctx, f"window closed: {w['steps']} steps")
    numbers = compare.train_numbers(prog, reference_check(ctx, p))
    core.note(ctx, "reference done")
    # a traced run's readers read the window less its profiled steps
    record = {"config": ctx.config, "traffic": ctx.traffic,
              "window_s": w["clean_s"], "steps": w["clean_steps"],
              "timings": w["timings"], "trace": w["trace"],
              "peaks": core.card_peaks(ctx.device)}
    rates = {"train_step_ms": 1e3 * window_s / w["steps"]}
    if ctx.traffic["inputs"] == "tokens":
        rates["train_tokens_per_s"] = (w["steps"] * ctx.traffic["batch"]
                                       * ctx.traffic["seq"] / window_s)
    return core.Outcome(setup_s, w["steps"], 0, rates, record,
                        numbers, w["peak"])

