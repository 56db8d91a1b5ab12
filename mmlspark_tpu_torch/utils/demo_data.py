"""Deterministic synthetic datasets for the example/e2e layer (the port's
copy of `mmlspark_tpu/utils/demo_data.py`).

The reference pins a datasets bundle (tools/config.sh:101-105: Adult Census,
flight delays, Amazon book reviews, CIFAR-10) that its notebooks and the
VerifyTrainClassifier metric grid consume.  This build runs air-gapped, so
the example workloads use generators that reproduce each dataset's *shape*
(mixed types, text, images, class structure) deterministically from a seed —
the workload code paths exercised are identical.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.table import DataTable, object_column


def adult_census_like(n: int = 600, seed: int = 0) -> DataTable:
    """Mixed-type tabular data shaped like Adult Census Income (notebook
    101): numeric, categorical-string, and free-string columns with a
    binary income label correlated to several of them."""
    rng = np.random.default_rng(seed)
    age = rng.integers(17, 80, n).astype(np.float64)
    hours = rng.integers(10, 70, n).astype(np.float64)
    education = rng.choice(
        ["HS-grad", "Bachelors", "Masters", "Doctorate", "Some-college"],
        n, p=[0.35, 0.3, 0.18, 0.05, 0.12])
    workclass = rng.choice(["Private", "Self-emp", "Government"], n,
                           p=[0.7, 0.15, 0.15])
    edu_rank = np.array([{"HS-grad": 0, "Some-college": 1, "Bachelors": 2,
                          "Masters": 3, "Doctorate": 4}[e] for e in education])
    score = (0.05 * (age - 38) + 0.06 * (hours - 40) + 0.9 * edu_rank
             + 0.5 * (workclass == "Self-emp") + rng.normal(0, 1.2, n))
    income = np.where(score > 1.8, ">50K", "<=50K")
    occupation = np.array(
        [f"{w.lower()} {e.lower().replace('-', ' ')} worker"
         for w, e in zip(workclass, education)], object)
    return DataTable({
        "age": age, "hours_per_week": hours,
        "education": object_column(list(education)),
        "workclass": object_column(list(workclass)),
        "occupation": object_column(list(occupation)),
        "income": object_column(list(income)),
    })


def flight_delays_like(n: int = 800, seed: int = 1) -> DataTable:
    """Regression data shaped like the flight-delay dataset (notebook 102):
    numeric + categorical features, continuous delay target."""
    rng = np.random.default_rng(seed)
    day_of_week = rng.integers(1, 8, n).astype(np.float64)
    dep_hour = rng.integers(5, 23, n).astype(np.float64)
    distance = rng.uniform(100, 2500, n)
    carrier = rng.choice(["AA", "DL", "UA", "WN"], n)
    carrier_bias = np.array([{"AA": 4.0, "DL": -2.0, "UA": 6.0,
                              "WN": 0.0}[c] for c in carrier])
    delay = (3.0 * (dep_hour - 12).clip(0) + 0.004 * distance
             + 5.0 * (day_of_week >= 6) + carrier_bias
             + rng.normal(0, 6.0, n))
    return DataTable({
        "day_of_week": day_of_week, "dep_hour": dep_hour,
        "distance": distance, "carrier": object_column(list(carrier)),
        "arr_delay": delay,
    })


_POSITIVE = ["great", "wonderful", "excellent", "loved", "fantastic",
             "brilliant", "superb", "delightful", "rich", "moving"]
_NEGATIVE = ["terrible", "boring", "awful", "hated", "dull", "weak",
             "disappointing", "flat", "tedious", "poor"]
_NEUTRAL = ["book", "story", "author", "chapter", "plot", "characters",
            "writing", "pages", "read", "novel", "the", "a", "was", "felt",
            "this", "it"]


def book_reviews_like(n: int = 400, seed: int = 2) -> DataTable:
    """Text classification data shaped like Amazon book reviews (notebooks
    201/202): free-text reviews with a binary sentiment rating."""
    rng = np.random.default_rng(seed)
    texts, ratings = [], []
    for _ in range(n):
        positive = bool(rng.integers(0, 2))
        pool = _POSITIVE if positive else _NEGATIVE
        n_sent = int(rng.integers(2, 5))
        n_neut = int(rng.integers(6, 14))
        words = list(rng.choice(pool, n_sent)) + \
            list(rng.choice(_NEUTRAL, n_neut))
        rng.shuffle(words)
        texts.append(" ".join(words))
        ratings.append(5 if positive else 1)
    return DataTable({"text": object_column(texts),
                      "rating": np.asarray(ratings, np.float64)})


def cifar_like(n: int = 256, seed: int = 3,
               n_classes: int = 10) -> DataTable:
    """Image classification data shaped like CIFAR-10 (notebook 301):
    32x32x3 uint8 images whose class controls a per-class color/frequency
    pattern, so a small ConvNet can actually learn them."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, n)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    images = np.empty((n, 32, 32, 3), np.uint8)
    for i, cls in enumerate(y):
        phase = 2 * np.pi * cls / n_classes
        freq = 1 + (cls % 3)
        base = np.stack([
            127 + 100 * np.sin(freq * xx / 5 + phase),
            127 + 100 * np.cos(freq * yy / 5 + phase),
            127 + 60 * np.sin((xx + yy) / 7 + phase),
        ], axis=-1)
        noise = rng.normal(0, 25, (32, 32, 3))
        images[i] = np.clip(base + noise, 0, 255).astype(np.uint8)
    return DataTable({"image": images,
                      "label": y.astype(np.float64)})


# --------------------------------------------------------------------------
# the learner-grid datasets (the VerifyTrainClassifier benchmark CSV's
# 9 bundled CSVs, benchmarkMetrics.csv:1-46)
# --------------------------------------------------------------------------

def _blobs(n, d, n_classes, spread, noise, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, spread, size=(n_classes, d))
    y = rng.integers(0, n_classes, n)
    x = centers[y] + rng.normal(0, noise, size=(n, d))
    return x.astype(np.float64), y


def grid_datasets() -> dict[str, DataTable]:
    """Deterministic datasets spanning the difficulty range of the
    reference's benchmark CSVs (easy/separable -> noisy/nonlinear ->
    mixed-type)."""
    out: dict[str, DataTable] = {}

    x, y = _blobs(300, 4, 2, spread=4.0, noise=0.6, seed=10)
    out["blobs_easy"] = DataTable(
        {**{f"f{i}": x[:, i] for i in range(4)}, "label": y.astype(np.float64)})

    x, y = _blobs(300, 6, 2, spread=1.5, noise=1.2, seed=11)
    out["blobs_noisy"] = DataTable(
        {**{f"f{i}": x[:, i] for i in range(6)}, "label": y.astype(np.float64)})

    rng = np.random.default_rng(12)
    x = rng.uniform(-2, 2, size=(300, 2))
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.int64)  # XOR: nonlinear
    out["xor"] = DataTable({"f0": x[:, 0], "f1": x[:, 1],
                            "label": y.astype(np.float64)})

    x, y = _blobs(360, 5, 3, spread=3.5, noise=0.8, seed=13)
    out["blobs_3class"] = DataTable(
        {**{f"f{i}": x[:, i] for i in range(5)}, "label": y.astype(np.float64)})

    out["census_mixed"] = adult_census_like(n=400, seed=14)

    # adversarial shapes, matching the reference grid's breadth (9 CSVs,
    # benchmarkMetrics.csv:1-46) — each targets a failure mode a learner
    # family has actually hit:

    # class imbalance (~6% positives): accuracy alone is a trap; AUC matters
    rng = np.random.default_rng(15)
    n = 400
    y = (rng.random(n) < 0.06).astype(np.int64)
    x = rng.normal(0, 1.0, size=(n, 4)) + 1.6 * y[:, None]
    out["imbalanced"] = DataTable(
        {**{f"f{i}": x[:, i] for i in range(4)}, "label": y.astype(np.float64)})

    # many classes (8) with few rows per class: per-class statistics thin out
    x, y = _blobs(480, 6, 8, spread=5.0, noise=0.9, seed=16)
    out["many_class"] = DataTable(
        {**{f"f{i}": x[:, i] for i in range(6)}, "label": y.astype(np.float64)})

    # collinear features: duplicated/linearly-dependent columns (the exact
    # failure that broke LinearRegression in example 102 — normal equations
    # blow up without the augmented-lstsq fit)
    rng = np.random.default_rng(17)
    base = rng.normal(0, 1, size=(300, 2))
    x = np.column_stack([base[:, 0], base[:, 1],
                         base[:, 0] * 2.0,                  # exact duplicate
                         base[:, 0] + base[:, 1],           # exact sum
                         base[:, 0] + rng.normal(0, 1e-6, 300)])  # near-dup
    y = (base[:, 0] - base[:, 1] > 0).astype(np.int64)
    out["collinear"] = DataTable(
        {**{f"f{i}": x[:, i] for i in range(5)}, "label": y.astype(np.float64)})

    # wide sparse one-hot-ish features (hashed-text regime): d >> informative
    rng = np.random.default_rng(18)
    n, d = 300, 64
    x = (rng.random((n, d)) < 0.05).astype(np.float64)  # ~5% density
    w = np.zeros(d)
    w[:6] = [2.0, -2.0, 1.5, -1.5, 1.0, -1.0]
    y = ((x @ w + rng.normal(0, 0.4, n)) > 0).astype(np.int64)
    out["wide_sparse"] = DataTable(
        {**{f"f{i}": x[:, i] for i in range(d)}, "label": y.astype(np.float64)})

    return out


def digits_images(seed: int = 0):
    """REAL image-classification data: the UCI handwritten-digits set that
    ships inside scikit-learn (1797 8x8 grayscale images, 10 classes) — the
    one genuine labeled image dataset available to an air-gapped build
    (CIFAR-10's raw archive needs network egress; see docs/design_cuts.md).
    Images are nearest-neighbor upscaled to the ConvNetCIFAR10 input
    contract (32, 32, 3) uint8 so the flagship scoring model trains and
    scores on real data with real accuracy semantics (the reference's
    equivalent fixture is its pretrained ConvNet_CIFAR10.model,
    CNTKTestUtils.scala:12-36).

    Returns (x_train, y_train, x_test, y_test): deterministic shuffled
    80/20 split, images uint8 (N, 32, 32, 3), labels int32."""
    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = d.images.astype(np.float32)                 # (N, 8, 8), 0..16
    x = np.kron(imgs, np.ones((1, 4, 4), np.float32))  # -> (N, 32, 32)
    x = np.clip(x * (255.0 / 16.0), 0, 255).astype(np.uint8)
    x = np.repeat(x[..., None], 3, axis=-1)
    y = d.target.astype(np.int32)
    order = np.random.default_rng(seed).permutation(len(x))
    x, y = x[order], y[order]
    n_test = len(x) // 5
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]
