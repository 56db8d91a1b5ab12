"""The numbers `correct` compares, each against the plain reference.

Training (`train_numbers`):
  * `loss_gap`: the widest relative gap of a checked step's loss;
  * `grad_gap`: over every parameter, |program's first-gradient norm -
    the reference's| / max(the reference's norm of that leaf, the median
    leaf's), the worst leaf (`grad_gap_median`: the median leaf's);
  * `change_gap`: the same of each leaf's change over the checked steps
    (parameters and running statistics), leaving out the elements whose
    reference gradient is under a thousandth of the median leaf's root
    mean square: those move under Adam by round-off alone
    (`change_gap_median`: the median leaf's);
  * `grad_diff_median`: the median leaf's ||program's first gradient -
    the reference's|| / max(its reference norm, the median leaf's).
Scoring (`score_numbers`):
  * `score_gap`: over the sampled rows, the widest ||program - reference||
    / ||reference|| of a row's scores.
`verdict` holds each number the cell's limits name to its limit: a
number that is not finite, or is over its limit, makes the run not
correct.
"""

from __future__ import annotations

import math
import statistics


def worst_leaf(prog: dict, ref: dict, leaves) -> tuple:
    """(worst gap, its leaf) of per-leaf norms (module docstring)."""
    leaves = list(leaves)
    median = statistics.median(ref[n] for n in leaves)
    worst, at = 0.0, None
    for n in leaves:
        gap = abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
        if not math.isfinite(gap) or gap > worst:
            worst, at = gap, n
            if not math.isfinite(gap):
                break
    return worst, at


def train_numbers(prog: dict, ref: dict) -> dict:
    """{number: (value, where)} of a training check (module docstring).
    `prog` holds the program's losses, first-gradient norms by leaf and
    changes by leaf (tensors anywhere); `ref` the reference's losses and
    its first gradients and changes by leaf (tensors on its device).

    A leaf's change is compared over the elements whose reference
    gradient is at least a thousandth of the median leaf's root mean
    square: an element below it (a key's bias under softmax, a third of
    the port's `qkv` bias leaf) moves under Adam by round-off alone."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not losses:
        losses.append(float("inf"))
    ref_grad = _norms(ref["grad"])
    rms = statistics.median(ref_grad[n] / math.sqrt(t.numel())
                            for n, t in ref["grad"].items())
    p_change, r_change = {}, {}
    for n, r in ref["change"].items():
        p = prog["change"][n].to(r.device, r.dtype)
        if n in ref["grad"]:
            keep = ref["grad"][n].abs() >= 1e-3 * rms
            p, r = p[keep], r[keep]
        p_change[n], r_change[n] = float(p.norm()), float(r.norm())
    out = {"loss_gap": (max(losses), None),
           "grad_gap": worst_leaf(prog["grad"], ref_grad, ref_grad),
           "grad_gap_median": median_leaf(prog["grad"], ref_grad),
           "change_gap": worst_leaf(p_change, r_change, r_change),
           "change_gap_median": median_leaf(p_change, r_change)}
    if "grad_tensors" in prog:
        out.update(grad_difference(prog["grad_tensors"], ref["grad"],
                                   ref_grad))
    return out


def grad_difference(prog: dict, ref: dict, ref_norms: dict) -> dict:
    """The first gradients' difference, leaf by leaf: the median leaf's
    ||program - reference|| / max(the reference leaf's norm, the median
    leaf's) (`grad_diff_median`).  Where the gaps of norms cannot tell
    the next precision down from the configuration's (rounding that
    averages out over a leaf), the difference does."""
    median = statistics.median(ref_norms.values())
    gaps = []
    for n, r in ref.items():
        d = prog[n].detach().to(r.device, r.dtype) - r
        gaps.append(float(d.norm()) / max(ref_norms[n], median, 1e-30))
    return {"grad_diff_median": (statistics.median(gaps), None)}


def median_leaf(prog: dict, ref: dict) -> tuple:
    """(the median leaf's gap, None): a reading steady from seed to seed
    where the worst leaf is the noise of one small leaf."""
    median = statistics.median(ref.values())
    gaps = [abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30) for n in ref]
    return statistics.median(gaps), None


def _norms(tensors: dict) -> dict:
    import torch
    names = list(tensors)
    norms = torch.stack([tensors[n].float().norm() for n in names])
    return dict(zip(names, norms.cpu().tolist()))


def score_numbers(prog, ref) -> dict:
    """{"score_gap": (value, row)} of sampled rows' scores (tensors)."""
    gaps = ((prog - ref).float().norm(dim=-1)
            / ref.float().norm(dim=-1).clamp(min=1e-30))
    i = int(gaps.nan_to_num(float("inf")).argmax())
    return {"score_gap": (float(gaps[i]), i)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): checks is {number: {"value", "limit"}} for each
    number the cell's limits name (a cell compares the numbers that
    separate its sound runs from its control and faults); no limit, or a
    limited number not read, is not correct."""
    checks, ok = {}, bool(limits)
    for name, entry in limits.items():
        value = numbers.get(name, (float("nan"), None))[0]
        finite = math.isfinite(value)
        # JSON has no infinity: a number that is not finite prints as null
        checks[name] = {"value": value if finite else None,
                        "limit": entry["limit"]}
        if not finite or value > entry["limit"]:
            ok = False
    return ok, checks
