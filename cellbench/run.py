"""Run one cell of the port's benchmark once and print its result line.

    python cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the PyTorch/CUDA port
(`mmlspark_tpu_torch`).  The run makes its weights and inputs from
`--seed`, warms up the shapes its traffic uses (set-up), measures for
`--seconds`, checks what the timed path produced against the plain
reference in `cellbench/reference/`, and prints one JSON line last:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with `--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` a `breakdown` of the traced part of the window, and last
`checks`: each compared number beside its limit (also the last lines of
standard error).  Without a CUDA card it exits 3 and prints no result;
it exits 4 when a JAX package (`jax`, `jaxlib`, `flax`, `mmlspark_tpu`)
is loaded in the process once the window has closed.

How to add to the benchmark (each piece is a new file; no file that is
there needs an edit, see `cellbench/README.md`):

  * a configuration: `configs/<config>.json` (sizes as run, `source`,
    `reduced`, `assumed`, `departures`, `deployment`, `costs` naming a
    module under `costs/`, and `program`: the architecture and model
    config the port builds) and its plain reference
    `reference/<config>.py` (`make_weights`, and `train_steps` or `score`
    as its drivers call them);
  * a traffic mix: `traffic/<mix>.json`, parameters only, naming the
    driver of its window (`"driver"`);
  * a driver: `drivers/<entry>.py` with `run(ctx) -> Outcome`
    (`harness/core.py`);
  * a per-layer metric: `metrics/<metric>.py` with `read(record)`, which
    returns None where the run has nothing to read;
  * a cell: an entry of `workloads` in `BENCHMARK.json` and its limits,
    `limits/<workload>.json`, set from chip readings (`calibrate.py`).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so only the first
    run of a checkout compiles (the port's own nvcc build goes to
    `mmlspark_tpu_torch/_build/`)."""
    cache = os.path.join(HERE, "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from cellbench.harness import core, manifest
    cell = manifest.Manifest(ROOT).workload(args.workload)
    chips = int(cell.get("chips", 1))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"cellbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 3
    try:
        result, numbers = core.execute(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START, ROOT)
    except Exception:
        traceback.print_exc()
        return 1
    loaded = core.banned_modules(sys.modules)
    if loaded:
        print(f"cellbench: JAX packages loaded in the process: {loaded}",
              file=sys.stderr)
        return 4
    print("cellbench numbers: " + json.dumps(
        {k: v[0] for k, v in numbers.items()}), file=sys.stderr)
    for line in core.check_lines(result["checks"], numbers):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
