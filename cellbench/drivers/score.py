"""The scoring window: `TPUModel.transform_batches` over a stream of tables.

Set-up makes the weights on the card from the seed, hands them to the
port as a bundle, makes a pool of seeded uint8 images, and streams
`warm_tables` tables through one `transform_batches` iterator.  The
window opens when the last of them comes back and closes at the first
table that comes back `seconds` later: `score_images_per_s` is the rows of
the tables that came back inside it over its length.  The stream then
stops and what is in flight drains, uncounted.

`correct`: `sample_tables` of the window's tables, drawn from the seed as
they come back (a reservoir), are scored again by the plain reference in
float32 once the window has closed and the port's model is freed.

With `--trace 1` the stage's `PipelineTimings` are collected over the
window (host, transfer, compute, drain thread-seconds per batch) and the
device is profiled over `trace_tables` tables from `trace_after_s` into
the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cellbench.harness import compare, core, traffic
from cellbench.harness.trace import DeviceTrace


def _bundle(ctx, weights):
    from mmlspark_tpu_torch.models.bundle import ModelBundle, variables_to_jax
    prog = ctx.config["program"]
    return ModelBundle(prog["architecture"], dict(prog["model_config"]),
                       variables_to_jax(weights))


def run(ctx: core.Context) -> core.Outcome:
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    from mmlspark_tpu_torch.observe.spans import pipeline_timing
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    weights = ctx.reference.make_weights(cfg, ctx.seed, dev)
    bundle = _bundle(ctx, weights)
    del weights
    rows = mix["table_rows"]
    pool = traffic.images(mix["pool_images"], cfg, ctx.seed, dev)
    slots = len(pool) // rows
    model = TPUModel(bundle, device=dev, inputCol="image",
                     outputCol="scores", miniBatchSize=mix["batch"],
                     prefetchDepth=mix["prefetch_depth"])
    core.free_device()
    core.note(ctx, "weights, bundle and image pool made")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    stop = [False]

    def tables():
        t = 0
        while not stop[0]:
            s = t % slots
            yield DataTable({"image": pool[s * rows:(s + 1) * rows]})
            t += 1

    draw = traffic.sample(ctx.seed)
    kept: list = []          # (slot, scores) of the reservoir
    seen = 0                 # window tables so far
    warm = mix["warm_tables"]
    profiler = DeviceTrace(dev.type == "cuda") if ctx.trace else None
    traced_from = None
    t0 = t1 = None
    counted = 0
    with pipeline_timing() as timings:
        clean = core.Clean(dev, timings)
        for k, table in enumerate(model.transform_batches(tables())):
            if k == warm - 1:
                t0 = clean.mark("open", 0)
                continue
            if t0 is None or t1 is not None:
                continue
            # a window table: counted, maybe kept for the check
            counted += len(table["scores"])
            seen += 1
            if len(kept) < mix["sample_tables"]:
                kept.append((k % slots, table["scores"]))
            else:
                j = int(draw.integers(seen))
                if j < mix["sample_tables"]:
                    kept[j] = (k % slots, table["scores"])
            now = time.perf_counter()
            if profiler is not None:
                if traced_from is None and now - t0 >= mix["trace_after_s"]:
                    clean.mark("start", counted)
                    profiler.start()
                    traced_from = seen
                elif traced_from is not None and "stop" not in clean.marks \
                        and seen - traced_from >= mix["trace_tables"]:
                    profiler.stop()
                    clean.mark("stop", counted)
            if now - t0 >= ctx.seconds:
                t1 = clean.mark("close", counted)
                stop[0] = True
    if profiler is not None:
        profiler.stop()
    window_s = t1 - t0
    setup_s = t0 - ctx.t_start
    peak = core.peak_bytes(dev)
    del model, bundle
    core.free_device()
    clean_s, clean_images, window_timings = clean.totals()
    core.note(ctx, f"window closed: {counted} images")
    numbers = check(ctx, kept, pool)
    core.note(ctx, "reference done")
    # a traced run's readers read the window less its profiled tables
    record = {"config": cfg, "traffic": mix, "window_s": clean_s,
              "images": clean_images, "timings": window_timings,
              "trace": profiler.reduce() if profiler is not None else None,
              "peaks": core.card_peaks(dev), "kept": kept, "pool": pool}
    return core.Outcome(setup_s, counted, 0,
                        {"score_images_per_s": counted / window_s},
                        record, numbers, peak)


def check(ctx: core.Context, kept: list, pool: np.ndarray,
          quant=None) -> dict:
    """The compared numbers of the kept tables: their scores against the
    reference's in float32, computed after the port's model is freed.
    With `quant` the reference in that precision takes the program's
    place (the control)."""
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    rows = mix["table_rows"]
    weights = ctx.reference.make_weights(cfg, ctx.seed, dev)
    prog, ref = [], []
    for slot, scores in kept:
        images = torch.from_numpy(pool[slot * rows:(slot + 1) * rows]).to(dev)
        ref.append(ctx.reference.score(weights, images, cfg,
                                       rows=mix["reference_rows"]).cpu())
        prog.append(torch.from_numpy(np.asarray(scores)) if quant is None
                    else ctx.reference.score(weights, images, cfg, quant,
                                             rows=mix["reference_rows"]).cpu())
    del weights
    core.free_device()
    if not prog:
        return {"score_gap": (float("inf"), None)}
    return compare.score_numbers(torch.cat(prog), torch.cat(ref))

