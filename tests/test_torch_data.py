"""The port's data layer (`mmlspark_tpu_torch/data/`) against the JAX
package's, on the CPU: each operator's output and order on the cases of
`tests/test_data.py`, the depth knob, the Autotuner's decisions on the
same synthetic stall trace, and `read_images_iter`'s batches (equal to
the JAX reader's, decoded lazily, in row order, refusing a shape change).
Outputs are compared exactly; resized batches within one level on at
most 0.5% of the pixels, as in `test_torch_image_reader.py`.
"""

import io
import threading

import numpy as np
import pytest
from PIL import Image

from mmlspark_tpu import DataTable as JaxDataTable
from mmlspark_tpu import config as jax_config
from mmlspark_tpu.data import Autotuner as JaxAutotuner
from mmlspark_tpu.data import Dataset as JaxDataset
from mmlspark_tpu.io.image_reader import read_images_iter as jax_iter
from mmlspark_tpu.parallel.prefetch import resolve_depth as jax_resolve
from mmlspark_tpu_torch import DataTable, config
from mmlspark_tpu_torch.data import Autotuner, Dataset, MapError
from mmlspark_tpu_torch.data import snapshot
from mmlspark_tpu_torch.io import image_reader
from mmlspark_tpu_torch.io.image_reader import read_images_iter
from mmlspark_tpu_torch.observe.metrics import get_counter
from mmlspark_tpu_torch.observe.telemetry import run_telemetry
from mmlspark_tpu_torch.parallel.prefetch import DEPTH_FLOOR, resolve_depth


def _sub3(tag):
    return [f"{tag}{i}" for i in range(3)]


def _bad_at(i, every=3):
    if i % every == 0:
        raise ValueError(f"bad {i}")
    return i


# name -> a graph over a Dataset class; each runs on both packages
GRAPHS = {
    "map_pinned": lambda D: D.from_iterable(range(40)).map(
        lambda i: i * 10, depth=4, workers=2, span=None),
    "map_inline": lambda D: D.from_iterable(range(5)).map(
        lambda i: i + 1, depth=-1, span=None),
    "map_autotuned": lambda D: D.from_iterable(lambda: range(40)).map(
        lambda x: x * 3, depth=0, span=None),
    "map_skip": lambda D: D.from_iterable(range(9)).map(
        _bad_at, depth=2, span=None, on_error="skip"),
    "batch": lambda D: D.from_iterable(range(7)).batch(3),
    "batch_drop": lambda D: D.from_iterable(range(7)).batch(
        3, drop_remainder=True),
    "shuffle": lambda D: D.from_iterable(lambda: range(100)).shuffle(
        16, seed=7),
    "shuffle_skip": lambda D: D.from_iterable(lambda: range(60)).shuffle(
        10, seed=3).skip(25),
    "interleave": lambda D: D.from_iterable(["a", "b", "c"]).interleave(
        lambda t: D.from_iterable(_sub3(t)), cycle_length=2),
    "interleave_block": lambda D: D.from_iterable(["a", "b"]).interleave(
        lambda t: [f"{t}{i}" for i in range(4)], cycle_length=2,
        block_length=2),
    "prefetch": lambda D: D.from_iterable(lambda: range(50)).prefetch(4),
    "prefetch_off": lambda D: D.from_iterable(lambda: range(10)).prefetch(-1),
    "take_skip": lambda D: D.from_iterable(range(20)).skip(3).take(5),
    "chain": lambda D: D.from_iterable(range(23)).map(
        lambda i: i * i, depth=3, span=None).batch(4).prefetch(2).map(
        sum, depth=0, span=None),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_operator_outputs_and_order_match_jax(name):
    got = list(GRAPHS[name](Dataset).iterator())
    ref = list(GRAPHS[name](JaxDataset).iterator())
    assert got == ref and len(got) > 0


def test_from_table_streams_rows_like_jax():
    cols = {"a": np.arange(4), "b": np.arange(4) * 2}
    got = list(Dataset.from_table(DataTable(cols), columns=["b"]).iterator())
    ref = list(JaxDataset.from_table(JaxDataTable(cols),
                                     columns=["b"]).iterator())
    assert got == ref == [{"b": v} for v in (0, 2, 4, 6)]


@pytest.mark.parametrize("knob", [5, 1, 0, -1, -7, None])
def test_depth_knob_resolves_as_the_jax_package(knob):
    assert resolve_depth(knob) == jax_resolve(knob)
    assert resolve_depth(0) == (DEPTH_FLOOR, True)


def test_map_order_survives_out_of_order_completion():
    gate = threading.Event()

    def fn(i):
        if i == 0:
            gate.wait(5)
        if i == 3:
            gate.set()
        return i * 10

    ds = Dataset.from_iterable(range(8)).map(fn, depth=4, workers=2,
                                             span=None)
    assert list(ds.iterator()) == [i * 10 for i in range(8)]


def test_map_error_policies():
    it = Dataset.from_iterable(range(6)).map(
        lambda i: 1 // (i - 3), depth=2, span=None).iterator()
    assert [next(it) for _ in range(3)] == [-1, -1, -1]
    with pytest.raises(ZeroDivisionError):
        next(it)
    out = list(Dataset.from_iterable(range(4)).map(
        lambda i: 1 // (i - 2), depth=2, span=None,
        on_error="column").iterator())
    assert isinstance(out[2], MapError) and out[2].item == 2
    with run_telemetry(None) as rt:
        before = get_counter("rows.skipped_on_error")
        assert list(GRAPHS["map_skip"](Dataset).iterator()) == \
            [1, 2, 4, 5, 7, 8]
        assert get_counter("rows.skipped_on_error") == before + 3
    events = [r for r in rt.tracer.records() if r.get("name") ==
              "rows.skipped"]
    assert [e["attrs"]["stage"] for e in events] == ["data.map.map"] * 3


def test_autotuned_stage_and_live_retune():
    it = GRAPHS["map_autotuned"](Dataset).iterator(interval=8)
    stage = it.stage("map")
    assert it.tuner is not None and stage.tunable
    assert stage.runner.depth == DEPTH_FLOOR
    assert stage.runner.max_depth >= 64
    assert list(it) == [x * 3 for x in range(40)]
    it = Dataset.from_iterable(lambda: range(200)).map(
        lambda x: x * 3, depth=0, span=None).iterator(autotune=False)
    runner, out = it.stage("map").runner, []
    for i, v in enumerate(it):
        out.append(v)
        if i == 20:
            assert runner.set_depth(16) == 16
        if i == 100:
            assert runner.set_depth(2) == 2
    assert out == [x * 3 for x in range(200)]
    pinned = GRAPHS["map_pinned"](Dataset).iterator()
    assert pinned.tuner is None and not pinned.stage("map").tunable
    pinned.close()
    assert pinned.stage("map").runner._closed and list(pinned) == []


class FakeRunner:
    """The Prefetcher tuning surface with counters a test advances."""

    def __init__(self, depth, max_depth):
        self.depth, self.max_depth = depth, max_depth
        self._c = {"deliveries": 0, "stalls": 0, "stall_s": 0.0,
                   "residency": 0}

    def stats(self):
        return {**self._c, "depth": self.depth, "max_depth": self.max_depth}

    def set_depth(self, depth):
        self.depth = max(1, min(int(depth), self.max_depth))
        return self.depth

    def advance(self, deliveries, stalls, stall_s, residency):
        for k, v in zip(self._c, (deliveries, stalls, stall_s, residency)):
            self._c[k] += v


class FakeStage:
    def __init__(self, name, runner):
        self.name, self.runner = name, runner


def stall_trace(tuner_cls, steps=18):
    """The decisions of `tuner_cls` over a skewed two-stage trace: the
    slow stage starves the consumer until its window is 8 deep, the fast
    one never stalls and rides full; a third stage idles."""
    slow, fast, idle = FakeRunner(2, 64), FakeRunner(6, 64), FakeRunner(4, 8)
    tuner = tuner_cls([FakeStage("slow", slow), FakeStage("fast", fast),
                       FakeStage("idle", idle)], interval=1, floor=2)
    for _ in range(steps):
        if slow.depth < 8:
            slow.advance(32, 32, 1.0, 0)
        else:
            slow.advance(32, 0, 0.0, (32 * slow.depth) // 3)
        fast.advance(32, 0, 0.0, 32 * fast.depth)
        tuner.step()
    return tuner.decisions, (slow.depth, fast.depth, idle.depth)


def test_autotuner_decisions_equal_the_jax_tuners_on_one_stall_trace():
    got, depths = stall_trace(Autotuner)
    ref, ref_depths = stall_trace(JaxAutotuner)
    assert got == ref and depths == ref_depths
    assert depths[0] >= 8 and depths[1] == 2 and depths[2] == 4
    assert {d["action"] for d in got} == {"widen", "narrow"}


def test_autotuner_publishes_gauges_and_events():
    with run_telemetry(None) as rt:
        slow = FakeRunner(2, 64)
        tuner = Autotuner([FakeStage("decode", slow)], interval=1, floor=2)
        slow.advance(32, 32, 2.0, 0)
        assert len(tuner.step()) == 1
        events = [r for r in rt.tracer.records()
                  if r.get("name") == "data.autotune"]
        assert [(e["cat"], e["attrs"]["action"]) for e in events] == \
            [("data", "widen")]
        assert rt.gauges()["data.decode.depth"]["last"] == slow.depth


def test_snapshot_offsets_replay_the_remaining_stream():
    snapshot.clear()
    ds = Dataset.from_iterable(lambda: range(30)).shuffle(
        8, seed=1).snapshot("epoch")
    full = list(ds.iterator())
    it = ds.iterator()
    head = [next(it) for _ in range(11)]
    assert snapshot.snapshot_offsets() == {"epoch": 11}
    it.close()
    snapshot.set_restore_offsets({"epoch": 11, "bad": "x"})
    assert head + list(ds.iterator()) == full
    snapshot.clear()


def test_distribute_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        Dataset.from_iterable(range(3)).distribute()


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    base = np.add.outer(np.arange(20), np.arange(20)) % 256
    for i in range(11):
        arr = ((base + 7 * i) % 256).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(np.stack([arr] * 3, axis=-1)).save(buf, "PNG")
        (root / f"img_{i:05d}.png").write_bytes(buf.getvalue())
    return str(root)


@pytest.mark.parametrize("knob,resize", [(8, None), (0, (16, 12)),
                                         (-1, (20, 20))])
def test_read_images_iter_batches_equal_the_jax_readers(png_dir, knob,
                                                        resize):
    config.set("MMLSPARK_TPU_PREFETCH_DEPTH", knob)
    jax_config.set("MMLSPARK_TPU_PREFETCH_DEPTH", knob)
    try:
        got = list(read_images_iter(png_dir, batch_size=4,
                                    resize_to=resize, device="cpu"))
        ref = list(jax_iter(png_dir, batch_size=4, resize_to=resize))
    finally:
        config.set("MMLSPARK_TPU_PREFETCH_DEPTH", None)
        jax_config.set("MMLSPARK_TPU_PREFETCH_DEPTH", 8)
    assert [len(t["path"]) for t in got] == [4, 4, 3]
    assert [list(t["path"]) for t in got] == [list(t["path"]) for t in ref]
    for g, r in zip(got, ref):
        a, b = g["image"], r["image"]
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
        assert g.meta("image").image.height == a.shape[1]
    diff = np.abs(np.concatenate([t["image"] for t in got]).astype(np.int16)
                  - np.concatenate([t["image"] for t in ref]))
    assert diff.max() <= (0 if resize is None else 1)
    assert (diff > 0).mean() <= 5e-3     # over the stream's pixels


def test_read_images_iter_decodes_lazily(png_dir, monkeypatch):
    calls = []
    real = image_reader.decode_many
    monkeypatch.setattr(image_reader, "decode_many",
                        lambda bufs: calls.append(len(bufs)) or real(bufs))
    config.set("MMLSPARK_TPU_PREFETCH_DEPTH", -1)
    try:
        it = read_images_iter(png_dir, batch_size=4, device="cpu")
        assert calls == []                 # nothing read before next()
        first = next(it)
        assert calls == [4] and len(first["path"]) == 4
        it.close()
    finally:
        config.set("MMLSPARK_TPU_PREFETCH_DEPTH", None)


def test_read_images_iter_refuses_a_shape_change_and_the_service(tmp_path):
    for i, side in enumerate((8, 8, 9)):
        buf = io.BytesIO()
        Image.fromarray(np.full((side, side, 3), i, np.uint8)).save(
            buf, "PNG")
        (tmp_path / f"{i}.png").write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match="uniform shapes"):
        list(read_images_iter(str(tmp_path), batch_size=2, device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        next(read_images_iter(str(tmp_path), service=object(),
                              device="cpu"))
