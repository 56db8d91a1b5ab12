"""Readings behind chip_smoke phase 21's ResNet-50 gates, one JSON line per
branch scale: seeded random ResNet-50 weights made input-dependent by
`calibrated_bundle` (each bottleneck branch's last BatchNorm scaled by the
branch scale), its bf16 and int8 arms against the f32 arm, and on the card
also against the port's CPU forward at the same precision, beside planted
faults (`chip_smoke.planted_fault`) at several nodes.

    python3 scripts/torch_vision_gate_sweep.py          # one CUDA card
    python3 scripts/torch_vision_gate_sweep.py --cpu    # small, on the CPU

On the card: full width, 1024 uint8 224 x 224 x 3 images drawn as phase 21
draws them, batch 256, branch scales 0.3, 0.1 and 0.03.  On the CPU:
widths 16-128, 256 images of 64 x 64, batch 64, branch scales 1.0 and
0.1, no faults (the CPU is both sides there).  Agreement counts the rows
whose f32 top-2 gap exceeds 2^-6 of max |logit|.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from mmlspark_tpu_torch import DataTable, TPUModel  # noqa: E402
from mmlspark_tpu_torch.models import ModelBundle  # noqa: E402
from mmlspark_tpu_torch.models.bundle import calibrated_bundle  # noqa: E402
from mmlspark_tpu_torch.quant import quantize_bundle  # noqa: E402

CLEAR = 2.0 ** -6
FAULTS = {"bf16": ("stem_conv", "ResNetBottleneckBlock_7/Conv_1",
                   "ResNetBottleneckBlock_12/Conv_1"),
          "int8": ("stem_conv", "ResNetBottleneckBlock_7/Conv_1",
                   "ResNetBottleneckBlock_7/Conv_3",
                   "ResNetBottleneckBlock_12/Conv_1")}


def sweep(device: str, images: np.ndarray, make, scales, batch: int,
          same_rows: int) -> None:
    table = DataTable({"x": images})
    for scale in scales:
        bundle = make(images[:32], scale)
        kw = dict(device=device, inputCol="x", outputCol="y",
                  miniBatchSize=batch)
        arms = {"f32": TPUModel(bundle, computeDtype="float32", **kw),
                "bf16": TPUModel(bundle, computeDtype="bfloat16", **kw),
                "int8": TPUModel(quantize_bundle(bundle, "int8"), **kw)}
        scores = {k: m.transform(table)["y"] for k, m in arms.items()}
        f32 = scores["f32"]
        out = {"branch_scale": scale,
               "distinct_f32_argmax": int(len(np.unique(f32.argmax(1))))}
        for arm in ("bf16", "int8"):
            out[arm] = {"vs_f32": cs.arm_readings(scores[arm], f32, CLEAR)}
            if device == "cpu":
                continue
            cpu = cs.cpu_scores(arms[arm], images[:same_rows])
            out[arm]["vs_cpu"] = cs.same_readings(scores[arm][:same_rows],
                                                  cpu)
            for node in FAULTS[arm]:
                model = TPUModel(cs.planted_fault(arms[arm].bundle, arm,
                                                  node),
                                 **{**arms[arm].param_values(),
                                    "device": device})
                got = model.transform(table)["y"]
                out[arm][node] = {
                    "vs_f32": cs.arm_readings(got, f32, CLEAR),
                    "vs_cpu": cs.same_readings(got[:same_rows], cpu)}
        print(json.dumps(out), flush=True)
        del arms, scores
        if device == "cuda":
            torch.cuda.empty_cache()


def small_resnet(images: np.ndarray, scale: float) -> ModelBundle:
    bundle = ModelBundle.init(
        "ResNet", {"stage_sizes": [3, 4, 6, 3], "widths": [16, 32, 64, 128],
                   "num_classes": 1000, "block_kind": "bottleneck",
                   "dtype": "float32"},
        seed=0, input_shape=(1,) + images.shape[1:])
    return calibrated_bundle(bundle, images, seed=1, branch_scale=scale)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()
    rng = np.random.default_rng(0)
    if args.cpu:
        images = rng.integers(0, 256, (256, 64, 64, 3), dtype=np.uint8)
        sweep("cpu", images, small_resnet, (1.0, 0.1), 64, 0)
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device; pass --cpu for the small CPU sweep",
              file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    # the draws of chip_smoke phase 21: the ConvNet's images, then these
    rng.integers(0, 256, (cs.VISION["convnet_images"], 32, 32, 3),
                 dtype=np.uint8)
    images = rng.integers(0, 256, (cs.VISION["resnet_images"], 224, 224, 3),
                          dtype=np.uint8)
    sweep("cuda", images, cs.resnet50_bundle, (0.3, 0.1, 0.03),
          cs.VISION["resnet_batch"], cs.VISION_GATES["resnet50"]["same_rows"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
