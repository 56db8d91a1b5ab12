"""Where the time of chip_smoke phase 22's ingestion arm goes on the
consumer thread: the phase's corpus (768 PNGs of 224 x 224 x 3) through
`read_images_iter(batch_size=128, resize_to=(224, 224))` into ResNet-50
bf16 `transform_batches` at a fixed depth, once warm, then once under
cProfile.  Prints one JSON line: the wall, the spans, and the functions
with the most cumulative and the most own time.

    python3 scripts/torch_ingest_profile.py --depth -1   # one CUDA card

Python 3.12's cProfile sees every thread but keeps one call stack, so
its attribution is sound only when one thread does all the work: depth
-1 (the default) runs decoding and staging inline on the calling
thread; a positive depth overlaps them and its function times mix.
"""

import argparse
import cProfile
import json
import os
import pstats
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from mmlspark_tpu_torch import DataTable, TPUModel  # noqa: E402
from mmlspark_tpu_torch.io.image_reader import read_images_iter  # noqa: E402
from mmlspark_tpu_torch.observe.telemetry import run_telemetry  # noqa: E402

TOP = 25


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--depth", type=int, default=-1)
    args = parser.parse_args()
    dev = torch.device("cuda")
    bs = cs.INGEST["batch"]
    with tempfile.TemporaryDirectory() as corpus:
        _, arrays = cs.ingest_corpus(corpus)
        r50 = cs.resnet50_bundle(arrays[:cs.INGEST["calibration_rows"]],
                                 cs.VISION["resnet_branch_scale"])
        model = TPUModel(r50, device=dev, inputCol="image",
                         outputCol="scores", miniBatchSize=bs,
                         computeDtype="bfloat16")
        model.transform(DataTable({"image": arrays[:bs]}))

        def source():
            return read_images_iter(corpus, batch_size=bs,
                                    resize_to=(224, 224), device=dev)
        cs.ingest_arm(model, args.depth, source)          # warm
        profile = cProfile.Profile()
        with run_telemetry(None) as rt:
            t0 = time.perf_counter()
            profile.enable()
            arm = cs.ingest_arm(model, args.depth, source)
            profile.disable()
            wall = time.perf_counter() - t0
    rows = [(v[3], v[2], v[1],
             f"{os.path.basename(k[0])}:{k[1]}:{k[2]}")
            for k, v in pstats.Stats(profile).stats.items()]

    def top(key):
        return [{"cum_s": c, "self_s": t, "calls": n, "where": w}
                for c, t, n, w in sorted(rows, key=key, reverse=True)[:TOP]]
    print(json.dumps({
        "card": cs.card_line(), "depth": args.depth, "wall_s": wall,
        "images_per_s": arm["rate"],
        "spans_s": dict(rt.timings.seconds),
        "top_cumulative": top(lambda r: r[0]),
        "top_self": top(lambda r: r[1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
