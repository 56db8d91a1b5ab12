"""Finding a cell's pieces by name.

`BENCHMARK.json` at the checkout's root names the cells; each piece is a
file of its own under `cellbench/`, found by the name the manifest gives:

  * `configs/<config>.json`    the model configuration as it is run;
  * `traffic/<traffic>.json`   the traffic mix: data the generator reads,
                               naming the driver of its window;
  * `drivers/<driver>.py`      the entry point a window drives;
  * `reference/<config>.py`    the configuration's plain reference;
  * `metrics/<metric>.py`      one per-layer metric's reader;
  * `limits/<workload>.json`   the limits `correct` holds each number to;
  * `costs/<costs>.py`         frozen work counts (the config's `costs`).

Modules are loaded from their paths, so a name may hold dots and dashes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str) -> ModuleType:
    """The module at `path`, loaded once per process under a name of its
    own (`cellbench._by_path.<relative path>`)."""
    rel = os.path.relpath(path, HERE)
    name = "cellbench._by_path." + rel.replace(os.sep, "/")
    if name in sys.modules:
        return sys.modules[name]
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[name]
        raise
    return module


def piece(kind: str, name: str, ext: str) -> str:
    return os.path.join(HERE, kind, f"{name}{ext}")


class Manifest:
    """`BENCHMARK.json` and the lookups of one cell's pieces."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.data = read_json(os.path.join(root, "BENCHMARK.json"))

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _reports(self, metric: dict, workload: str) -> bool:
        return workload in metric.get("workloads", [workload])

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.data["end_to_end"]
                if self._reports(m, workload)]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics a cell reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def config(name: str) -> dict:
    return read_json(piece("configs", name, ".json"))


def traffic(name: str) -> dict:
    return read_json(piece("traffic", name, ".json"))


def limits(workload: str) -> dict:
    return read_json(piece("limits", workload, ".json"))


def driver(name: str) -> ModuleType:
    return load_module(piece("drivers", name, ".py"))


def reference(config_name: str) -> ModuleType:
    return load_module(piece("reference", config_name, ".py"))


def metric_reader(name: str) -> ModuleType:
    return load_module(piece("metrics", name, ".py"))


def costs(name: str) -> ModuleType:
    return load_module(piece("costs", name, ".py"))


def peaks(device_name: str):
    """The card's peaks from `costs/peaks.json` ({} keys by lowercase
    substring of the device's name), or None for a card not listed."""
    cards = read_json(os.path.join(HERE, "costs", "peaks.json"))["cards"]
    low = device_name.lower()
    for key, value in cards.items():
        if key in low:
            return value
    return None
