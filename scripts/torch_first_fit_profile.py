"""Where the port's first tree fit of a process spends its seconds.

Fits example 101's DecisionTreeClassifier (through TrainClassifier) on the
census at the UCI Adult's training size twice on the card, each under
cProfile, and prints both fits' seconds and the first fit's top entries
by cumulative time; then one LogisticRegression fit.

    python3 scripts/torch_first_fit_profile.py
"""

import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from mmlspark_tpu_torch.ml import (DecisionTreeClassifier,  # noqa: E402
                                   LogisticRegression, TrainClassifier)
from mmlspark_tpu_torch.utils.demo_data import adult_census_like  # noqa


def main() -> None:
    train = adult_census_like(n=48842, seed=0).slice(0, 32561)
    dev = torch.device("cuda")
    for i in range(2):
        prof = cProfile.Profile()
        prof.enable()
        t0 = time.perf_counter()
        TrainClassifier(DecisionTreeClassifier(maxDepth=5, device=dev),
                        labelCol="income").fit(train)
        torch.cuda.synchronize()
        print(f"DT fit {i}: {time.perf_counter() - t0:.3f} s", flush=True)
        prof.disable()
        if i == 0:
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats(
                "cumtime").print_stats(18)
            print(text.getvalue())
    t0 = time.perf_counter()
    TrainClassifier(LogisticRegression(device=dev),
                    labelCol="income").fit(train)
    print(f"LR fit: {time.perf_counter() - t0:.3f} s")


if __name__ == "__main__":
    main()
