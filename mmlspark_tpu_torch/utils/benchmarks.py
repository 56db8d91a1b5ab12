"""The learner-grid metric benchmark (the port of
`mmlspark_tpu/utils/benchmarks.py`: the same grid, each learner on
`device`).

Counterpart of the reference's committed metric regression net
(VerifyTrainClassifier.scala:36-37,203-216 + benchmarkMetrics.csv): every
learner family trained on every grid dataset, metrics rounded and diffed
EXACTLY against a committed CSV.  Regeneration is deliberate:

    python scripts/regen_benchmarks.py

after any change that legitimately moves the numbers; the test fails on any
unintentional drift.
"""

from __future__ import annotations

import io

import numpy as np


def _learners(device="cuda"):
    from mmlspark_tpu_torch.ml import (DecisionTreeClassifier, GBTClassifier,
                                       LogisticRegression,
                                       MultilayerPerceptronClassifier,
                                       NaiveBayes, RandomForestClassifier)
    return {
        "LogisticRegression": lambda: LogisticRegression(device=device),
        "DecisionTreeClassifier": lambda: DecisionTreeClassifier(
            maxDepth=5, device=device),
        "RandomForestClassifier": lambda: RandomForestClassifier(
            numTrees=10, maxDepth=5, device=device),
        "GBTClassifier": lambda: GBTClassifier(maxIter=10, maxDepth=4,
                                               device=device),
        "NaiveBayes": lambda: NaiveBayes(device=device),
        "MultilayerPerceptronClassifier":
            lambda: MultilayerPerceptronClassifier(
                layers=[-1, 16, -1], maxIter=30, seed=0, device=device),
    }


def compute_learner_grid(dataset: "str | None" = None,
                         device="cuda") -> list[dict]:
    """accuracy (+AUC when binary) for every (dataset, learner) pair.

    `dataset` limits computation to one grid dataset — the per-dataset
    parametrized tests use this so no single test carries the whole grid's
    runtime."""
    from mmlspark_tpu_torch.ml import ComputeModelStatistics, TrainClassifier
    from mmlspark_tpu_torch.utils.demo_data import grid_datasets

    rows = []
    for ds_name, table in grid_datasets().items():
        if dataset is not None and ds_name != dataset:
            continue
        label = "income" if "income" in table.columns else "label"
        n_train = int(table.num_rows * 0.75)
        train = table.slice(0, n_train)
        test = table.slice(n_train, table.num_rows)
        for learner_name, make in _learners(device).items():
            # NB needs non-negative features; skip it off the raw-numeric
            # datasets with negative values (the reference grid also runs
            # each learner only where it applies)
            if learner_name == "NaiveBayes" and ds_name != "census_mixed":
                continue
            # binary-only, as in the reference (TrainClassifier.scala:101-104)
            if learner_name == "GBTClassifier" and \
                    len(set(np.asarray(table[label]).tolist())) > 2:
                continue
            model = TrainClassifier(make(), labelCol=label).fit(train)
            metrics = ComputeModelStatistics().transform(
                model.transform(test))
            row = {"dataset": ds_name, "learner": learner_name,
                   "accuracy": round(float(metrics["accuracy"][0]), 6)}
            row["AUC"] = (round(float(metrics["AUC"][0]), 6)
                          if "AUC" in metrics.columns else "")
            rows.append(row)
    return rows


def grid_to_csv(rows: list[dict]) -> str:
    buf = io.StringIO()
    buf.write("dataset,learner,accuracy,AUC\n")
    for r in rows:
        buf.write(f"{r['dataset']},{r['learner']},{r['accuracy']},{r['AUC']}\n")
    return buf.getvalue()
