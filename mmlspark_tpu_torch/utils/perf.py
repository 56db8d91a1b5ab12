"""Performance accounting: model FLOPs, the card's peaks and MFU (the port
of `mmlspark_tpu/utils/perf.py`).

MFU = achieved FLOP/s / the card's peak FLOP/s: achieved = counted
forward FLOPs x rows/sec, the peak from the device table below (the
dense bf16 tensor-core rate).  The table holds the card this repo runs
on and nothing else: any other device, and the CPU, get None, and a
caller then omits the utilization rather than fabricate one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# dense bf16 tensor-core FLOP/s and HBM bytes/s by device name (the
# vendor's spec sheet for the SXM part); keys are matched as lowercase
# substrings of torch.cuda.get_device_name.  These are the peaks the
# kernel table's bounds divide by (PERF.md §6, chip_smoke.py).
_PEAK_BF16: list[tuple[str, float]] = [("h100 80gb hbm3", 989e12)]
_PEAK_HBM_BPS: list[tuple[str, float]] = [("h100 80gb hbm3", 3.35e12)]


def _device_name(device) -> Optional[str]:
    """The lowercase CUDA device name of `device` (default `cuda:0`), or
    None for a host device or when no card is visible."""
    device = torch.device("cuda", 0) if device is None else \
        torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_name(device).lower()


def _lookup(table: list, device) -> Optional[float]:
    name = _device_name(device)
    if name is None:
        return None
    for key, value in table:
        if key in name:
            return value
    return None


def device_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of `device` (a torch device, default
    `cuda:0`); None when unknown (the CPU, an unlisted card) — callers
    then omit MFU rather than fabricate it."""
    return _lookup(_PEAK_BF16, device)


def device_peak_hbm_bw(device=None) -> Optional[float]:
    """HBM peak bytes/s of `device` (default `cuda:0`); None when
    unknown — callers then omit bandwidth utilization."""
    return _lookup(_PEAK_HBM_BPS, device)


def forward_flops(bundle, input_shape: tuple,
                  dtype=np.float32) -> Optional[float]:
    """FLOPs of one forward of a batch of `input_shape` through the
    bundle's module, counted by the cost counter (observe/costmodel.py:
    matrix products and convolutions) on meta tensors, so nothing runs.
    None when nothing can be counted."""
    from mmlspark_tpu_torch.observe.costmodel import CostCounter
    try:
        module = bundle.module("cpu").to("meta")
        x = torch.empty(tuple(input_shape), device="meta",
                        dtype=torch.from_numpy(
                            np.zeros(0, np.dtype(dtype))).dtype)
        if not x.is_floating_point():
            x = x.float()   # the scoring forward widens integer pixels
        with torch.inference_mode(), CostCounter() as counter:
            module(x)
        if counter.error is not None:
            return None
        return float(counter.flops) or None
    except Exception:
        return None


def lm_train_flops(batch: int, seq: int, d_model: int, n_layers: int,
                   vocab_size: int, *, causal: bool = True,
                   attn_impl: str = "flash", mlp_ratio: int = 4) -> dict:
    """Analytic TransformerLM train-step FLOPs.

      * `dense` — 6 x tokens x N_linear (forward + 2x backward over the
        QKVO projections, the MLP pair and the vocabulary head);
      * `attn` — the attention products the math requires: 2 forward
        (QK^T, PV) + 4 backward (dV, dP, dQ, dK), each 2*B*S^2*d, halved
        under a causal mask.  Kernel-side recompute (the flash backward
        re-issuing S and dP) is not counted, so an MFU from `total` is
        conservative;
      * `total` = dense + attn;
      * `xla_visible` — what a counter that cannot see inside the
        attention kernels counts: the dense part alone for flash
        attention, dense + the full S^2 products otherwise.  The port's
        cost counter is such a counter (its kernels report their own work
        beside it, observe/costmodel.py).
    """
    n_linear = (n_layers * (4 + 2 * mlp_ratio) * d_model * d_model
                + d_model * vocab_size)
    dense = 6 * batch * seq * n_linear
    attn_full = 6 * 2 * n_layers * batch * seq * seq * d_model
    attn = attn_full // 2 if causal else attn_full
    xla_visible = dense if attn_impl == "flash" else dense + attn_full
    return {"dense": dense, "attn": attn, "attn_full": attn_full,
            "total": dense + attn, "xla_visible": xla_visible}


def mfu(images_per_sec: float, flops_per_image: Optional[float],
        device=None) -> Optional[float]:
    """Model-FLOPs utilization of one card at `images_per_sec`; None when
    either the FLOP count or the card's peak is unknown."""
    peak = device_peak_flops(device)
    if peak is None or not flops_per_image:
        return None
    return images_per_sec * flops_per_image / peak
