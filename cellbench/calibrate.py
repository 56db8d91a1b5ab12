"""Readings that the limits of `correct` are set from (not run by the
benchmark's own runs).

    python cellbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 2]

In one process, on the card, at the cell's own size: for each seed the
program's numbers against the reference (a training cell's check fit, no
window; a scoring cell's run with a short window at its own load); for
each control seed the reference in the next precision below the
configuration's (fp8 for bfloat16) in the program's place; for each fault
seed the faults the cell can have: a training cell's batch half left out
(the reference on the first half of each batch), a scoring cell's answer
altered where it is produced (each minibatch's last row given its
neighbour's scores).  A state left unchanged reads 1 by the change's
measure and needs no run.  One JSON line per reading, then a summary:
each number's largest program reading and smallest control and fault
readings.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _plain(numbers: dict) -> dict:
    return {k: v[0] for k, v in numbers.items()}


def train_readings(ctx, arm_seeds: dict, emit) -> None:
    from cellbench.harness import compare, core, manifest
    drv = manifest.driver("train")
    for seed in sorted(set().union(*arm_seeds.values())):
        ctx.seed = seed
        if seed in arm_seeds["program"]:
            p = drv.prepare(ctx)
            prog, _ = drv.program_check(ctx, p)
            rows = {"x": p["x"], "y": p["y"]}
            del p
            core.free_device()
        else:
            x, y = drv.pools(ctx)
            rows = {"x": x, "y": y}
        ref = drv.reference_check(ctx, rows)
        if arm_seeds["control"] or arm_seeds["half_batch"]:
            # on the host: the next arm's reference needs the card's room
            ref = {"losses": ref["losses"],
                   "grad": {n: t.cpu() for n, t in ref["grad"].items()},
                   "change": {n: t.cpu() for n, t in ref["change"].items()}}
            core.free_device()
        if seed in arm_seeds["program"]:
            emit("program", seed, compare.train_numbers(prog, ref))
            del prog
        for arm, kw in (("control", {"quant": "fp8"}),
                        ("half_batch", {"half": True})):
            if seed in arm_seeds[arm]:
                other = drv.reference_check(ctx, rows, **kw)
                as_prog = {"losses": other["losses"],
                           "grad": compare._norms(other["grad"]),
                           "grad_tensors": {n: t.cpu() for n, t in
                                            other["grad"].items()},
                           "change": {n: t.cpu() for n, t in
                                      other["change"].items()}}
                del other
                core.free_device()
                emit(arm, seed, compare.train_numbers(as_prog, ref))
                del as_prog
        del ref
        core.free_device()


def score_readings(ctx, arm_seeds: dict, emit) -> None:
    from cellbench.harness import manifest
    drv = manifest.driver("score")
    for seed in sorted(set().union(*arm_seeds.values())):
        ctx.seed = seed
        if seed in arm_seeds["program"] or seed in arm_seeds["control"]:
            out = drv.run(ctx)
            if seed in arm_seeds["program"]:
                emit("program", seed, out.numbers)
            if seed in arm_seeds["control"]:
                emit("control", seed, drv.check(
                    ctx, out.record["kept"], out.record["pool"], "fp8"))
            del out
        if seed in arm_seeds["altered_answer"]:
            with altered_answers():
                emit("altered_answer", seed, drv.run(ctx).numbers)


class altered_answers:
    """Within the block each minibatch's last row comes out of the
    scoring stage with its neighbour's scores."""

    def __enter__(self):
        from mmlspark_tpu_torch.models.tpu_model import TPUModel
        self._cls, self._orig = TPUModel, TPUModel._apply
        orig = self._orig

        def _apply(model, module, x):
            out = orig(model, module, x).clone()
            out[-1] = out[-2]
            return out

        TPUModel._apply = _apply
        return self

    def __exit__(self, *exc):
        self._cls._apply = self._orig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from cellbench.harness import core
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    ctx = core.context(args.workload, 0, args.seconds, False,
                       torch.device("cuda", 0), T_START, ROOT)
    readings: dict = {}

    def emit(arm: str, seed: int, numbers: dict) -> None:
        plain = _plain(numbers)
        readings.setdefault(arm, []).append(plain)
        print(json.dumps({"arm": arm, "seed": seed, "numbers": plain,
                          "where": {k: v[1] for k, v in numbers.items()}}),
              flush=True)

    if ctx.traffic["driver"] == "train":
        arm_seeds = {"program": _seeds(args.seeds),
                     "control": _seeds(args.control_seeds),
                     "half_batch": _seeds(args.fault_seeds)}
        train_readings(ctx, arm_seeds, emit)
    else:
        arm_seeds = {"program": _seeds(args.seeds),
                     "control": _seeds(args.control_seeds),
                     "altered_answer": _seeds(args.fault_seeds)}
        score_readings(ctx, arm_seeds, emit)
    summary = {}
    for arm, rows in readings.items():
        pick = max if arm == "program" else min
        summary[arm] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"summary": summary, "counts": {
        arm: len(rows) for arm, rows in readings.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
