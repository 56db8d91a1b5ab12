"""Numerics health: device-side tree probes and rolling loss-spike
detection (the port of `mmlspark_tpu/observe/numerics.py`).

  * `tree_health` — a flat dict of scalar diagnostics over the step's
    parameters, gradients and updates (and the logits): non-finite
    counts, per-layer-group grad/param norms and update-to-weight
    ratios, with the JAX package's keys.  The trainer computes it on the
    device on probe steps only (`TrainerConfig.numerics_cadence`) and
    fetches it once, at the step boundary (`fetch_health`).
  * `LossSpikeDetector` — a rolling-median/MAD detector over the
    per-step loss: `nonfinite` immediately, `spike` past the noise
    envelope, `divergence` when spikes sustain (pure Python, the JAX
    package's logic).
  * `NonFiniteError` / `DivergenceError` — raised by the trainer
    (`halt_on_nonfinite` / `halt_on_divergence`) BEFORE the step-boundary
    checkpoint, so the newest checkpoint on disk is the last healthy
    state.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Mapping, Optional

import torch


def _group_of(name: str) -> str:
    """The layer group of a parameter: its top-level module ("block2_w",
    "tok_embed", ...), as the JAX package's `_group_of` reads a flax
    path."""
    return name.split(".", 1)[0] if name else "params"


def _grouped_sq_sums(tree: Mapping[str, torch.Tensor]) -> dict:
    out: dict = {}
    for name in sorted(tree, key=lambda n: n.split(".")):
        g = _group_of(name)
        sq = torch.sum(torch.square(tree[name].float()))
        out[g] = out[g] + sq if g in out else sq
    return out


def _nonfinite_count(tree: Mapping[str, torch.Tensor]):
    counts = [torch.sum(~torch.isfinite(t.float())) for t in tree.values()]
    if not counts:
        return torch.zeros(())
    return torch.stack(counts).sum().float()


def tree_health(params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor],
                updates: Mapping[str, torch.Tensor],
                acts=None) -> dict:
    """The flat health dict of 0-d f32 tensors over name -> tensor maps.

    Keys: `nonfinite_params` / `nonfinite_grads` / `nonfinite_acts`
    (element counts), `param_norm/<group>`, `grad_norm/<group>`,
    `update_ratio/<group>` (||update|| / (||param|| + eps)), and
    `act_norm` over `acts` when given.  `acts` may be a list of per-shard
    tensors (a data-parallel step's logits): their counts and squared
    sums add up on the first one's device, as over the joined batch."""
    eps = 1e-12
    health: dict = {
        "nonfinite_params": _nonfinite_count(params),
        "nonfinite_grads": _nonfinite_count(grads),
    }
    p_sq = _grouped_sq_sums(params)
    g_sq = _grouped_sq_sums(grads)
    u_sq = _grouped_sq_sums(updates)
    for g in p_sq:
        p_norm = torch.sqrt(p_sq[g])
        health[f"param_norm/{g}"] = p_norm
        if g in g_sq:
            health[f"grad_norm/{g}"] = torch.sqrt(g_sq[g])
        if g in u_sq:
            health[f"update_ratio/{g}"] = torch.sqrt(u_sq[g]) / (p_norm
                                                                 + eps)
    if isinstance(acts, (list, tuple)):
        home = acts[0].device
        parts = [a.float() for a in acts]
        health["act_norm"] = torch.sqrt(torch.stack([
            torch.sum(torch.square(a)).to(home) for a in parts]).sum())
        health["nonfinite_acts"] = torch.stack([
            torch.sum(~torch.isfinite(a)).float().to(home)
            for a in parts]).sum()
    elif acts is not None:
        acts = acts.float()
        health["act_norm"] = torch.sqrt(torch.sum(torch.square(acts)))
        health["nonfinite_acts"] = torch.sum(~torch.isfinite(acts)).float()
    return {k: v.float() for k, v in health.items()}


def fetch_health(health: dict) -> dict:
    """The health dict as Python floats in sorted key order (the order
    the JAX Trainer's `device_get` gives them): one device-to-host
    copy."""
    keys = sorted(health)
    values = torch.stack([health[k].reshape(()) for k in keys]).cpu()
    return {k: float(v) for k, v in zip(keys, values.tolist())}


class NonFiniteError(RuntimeError):
    """Training state went non-finite and halt_on_nonfinite is armed.

    Raised at the step boundary BEFORE any checkpoint write, so the
    newest checkpoint on disk is the last finite one."""

    def __init__(self, step: int, detail: str,
                 ckpt_dir: Optional[str] = None):
        self.step = step
        self.detail = detail
        self.ckpt_dir = ckpt_dir
        msg = (f"non-finite training state detected at step {step} "
               f"({detail})")
        if ckpt_dir:
            msg += (f"; halting before the poisoned state reaches a "
                    f"checkpoint — the newest valid checkpoint in "
                    f"{ckpt_dir} is the last finite state")
        super().__init__(msg)


class DivergenceError(RuntimeError):
    """The loss-spike detector returned `divergence` and
    halt_on_divergence is armed; raised before any checkpoint write."""

    def __init__(self, step: int, loss: float,
                 threshold: Optional[float] = None,
                 ckpt_dir: Optional[str] = None):
        self.step = step
        self.loss = loss
        self.threshold = threshold
        self.ckpt_dir = ckpt_dir
        msg = (f"loss divergence detected at step {step} (loss={loss:g}"
               + (f", spike threshold {threshold:g}" if threshold
                  is not None else "") + ")")
        if ckpt_dir:
            msg += (f"; halting before the diverged state reaches a "
                    f"checkpoint — restore from {ckpt_dir}")
        super().__init__(msg)


class LossSpikeDetector:
    """Rolling loss-health verdicts: ok | spike | divergence | nonfinite.

    The rolling median and MAD of the last `window` finite losses define
    the envelope; a loss above `median + spike_sigmas * sigma` (sigma the
    larger of 1.4826 * MAD, `min_rel * |median|` and 1e-9) is a `spike`,
    and `div_consecutive` consecutive spikes are a `divergence`.  Spikes
    do not enter the baseline."""

    def __init__(self, window: int = 25, spike_sigmas: float = 6.0,
                 min_rel: float = 0.1, div_consecutive: int = 3,
                 warmup: int = 5):
        self.window = window
        self.spike_sigmas = spike_sigmas
        self.min_rel = min_rel
        self.div_consecutive = div_consecutive
        self.warmup = warmup
        self._recent: deque = deque(maxlen=window)
        self._spike_run = 0

    def threshold(self) -> Optional[float]:
        """The current spike threshold, or None during warmup."""
        if len(self._recent) < self.warmup:
            return None
        xs = sorted(self._recent)
        n = len(xs)
        med = (xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2)
        mad = sorted(abs(x - med) for x in xs)[n // 2]
        sigma = max(1.4826 * mad, self.min_rel * abs(med), 1e-9)
        return med + self.spike_sigmas * sigma

    def update(self, loss: float) -> str:
        """Feed one per-step loss; returns the verdict for this step."""
        if not math.isfinite(loss):
            self._spike_run += 1
            return "nonfinite"
        thr = self.threshold()
        if thr is not None and loss > thr:
            self._spike_run += 1
            return ("divergence"
                    if self._spike_run >= self.div_consecutive else "spike")
        self._spike_run = 0
        self._recent.append(loss)
        return "ok"
