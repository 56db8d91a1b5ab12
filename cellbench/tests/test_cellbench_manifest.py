"""BENCHMARK.json and the files it names: names, units and keys in the
characters and sizes the benchmark's format allows, and every piece
found by name."""

import json
import os
import re

import pytest

from cellbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return manifest.Manifest()


def test_keys_and_sizes(bench):
    data = bench.data
    assert set(data) == KEYS["top"]
    assert os.path.getsize(os.path.join(bench.root, "BENCHMARK.json")) \
        <= 64 * 1024
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in data[section]:
            extra = set(entry) - KEYS[section]
            assert extra <= {"workloads"}, (section, entry["name"], extra)
            assert KEYS[section] <= set(entry), (section, entry["name"])
    assert 1 <= data["run_seconds"] <= 51
    assert 1 <= len(data["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in data["paths"])
    assert len(data["command"]) <= 32


def test_names_units_and_text(bench):
    data = bench.data
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in data[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    for section in ("configs", "workloads"):
        seen = [n for s, n in names if s == section]
        assert len(seen) == len(set(seen))
    metrics = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in data["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in data["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for c in data["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in data["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_every_cell_reports_what_it_must(bench):
    data = bench.data
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in data["workloads"]}
    configs = {w["config"] for w in data["workloads"]}
    assert configs == {c["name"] for c in data["configs"]}
    layers: dict = {}
    for m in data["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        names = {m["name"] for m in bench.end_to_end(cell)}
        assert "setup_s" in names and len(names) >= 2, cell
        assert bench.per_layer(cell), cell
        for m in bench.per_layer(cell):
            assert m["moves"] in names, (cell, m["name"])
    four = sum(w["chips"] == 4 for w in data["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_every_piece_is_found_by_name(bench):
    data = bench.data
    for c in data["configs"]:
        path = os.path.join(bench.root, c["file"])
        cfg = manifest.read_json(path)
        assert cfg["name"] == c["name"]
        assert c["file"].startswith("cellbench/")
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert cfg["source"] == c["source"]
        manifest.reference(c["name"])
        manifest.costs(cfg["costs"])
    for w in data["workloads"]:
        mix = manifest.traffic(w["traffic"])
        driver = manifest.driver(mix["driver"])
        assert callable(driver.run)
        limits = manifest.limits(w["name"])
        assert limits, w["name"]
    for m in data["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read)


def test_limits_hold_their_readings(bench):
    """Each limit lies above the program's largest reading and below the
    smallest control or fault reading it was set between."""
    for w in bench.data["workloads"]:
        for name, entry in manifest.limits(w["name"]).items():
            assert entry["lower"] < entry["limit"] < entry["upper"], name


def test_file_names_use_name_characters():
    here = manifest.HERE
    for dirpath, dirnames, files in os.walk(here):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "_cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), here)
            assert PATH.match(rel), rel
