"""The port's data service (`mmlspark_tpu_torch/data/graph.py`,
`data/service/`) on the CPU: the cases of the JAX package's
tests/test_data_service.py on the port (graph round-trips, split ranges,
deterministic sharding, exactly-once crash recovery, snapshot/resume,
autoscaling, the per-worker gauge namespace, element frames; its four
page-frame cases are tests/test_torch_transport.py's), and
parity with the JAX package: `graph.dumps` byte-equal, `build_range`
splits equal, the in-process service's deterministic output equal to the
JAX service's at 1, 2 and 3 workers and across an injected crash,
`read_images_iter(service=...)` equal to the JAX reader's.  The
checkpoint sidecar carries the live snapshot offsets as the JAX Trainer's
does, and a resumed fit re-arms them.

Every case runs in-process (workers pumped on the consumer thread) except
three process-mode cases, which spawn real worker processes and skip
through `proc_workers` when this host cannot start a subprocess that
connects back over a loopback socket.
"""

import json
import socket
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from mmlspark_tpu.data import Dataset as JaxDataset
from mmlspark_tpu.data import graph as jax_graph
from mmlspark_tpu.resilience import chaos as jax_chaos
from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.data import Dataset, graph
from mmlspark_tpu_torch.data import snapshot as snapmod
from mmlspark_tpu_torch.data.graph import GraphSerializationError
from mmlspark_tpu_torch.observe.telemetry import run_telemetry
from mmlspark_tpu_torch.resilience.chaos import (ChaosInjector, Fault,
                                                 set_injector)


def _double(x):
    return x * 2


def _tens(x):
    return [x * 10, x * 10 + 1]


def _boom_on_seven(x):
    if x == 7:
        raise ValueError("boom")
    return x


@pytest.fixture(autouse=True)
def _clean_snapshots():
    snapmod.clear()
    yield
    snapmod.clear()


@pytest.fixture(scope="module")
def proc_workers():
    """Skip unless a subprocess of this interpreter can start and connect
    back to a loopback listener (what process mode needs)."""
    from mmlspark_tpu_torch.data.service import transport
    try:
        srv, port = transport.listen()
    except OSError as e:
        pytest.skip(f"no loopback listener: {e}")
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import socket; socket.create_connection(('127.0.0.1', "
             f"{port}), timeout=30).close()"])
    except OSError as e:
        srv.close()
        pytest.skip(f"cannot start a subprocess: {e}")
    try:
        conn = transport.accept(srv, timeout_s=30.0)
        if conn is None:
            pytest.skip("a subprocess never connected back over loopback")
        conn.close()
    finally:
        srv.close()
        proc.wait(timeout=30)


def local(ds):
    return [b for b in ds.iterator(autotune=False)]


def batches(ds, **kw):
    kw.setdefault("mode", "inproc")
    it = ds.distribute(**kw).iterator(autotune=False)
    with it:
        return [b for b in it]


# -- graph serialization -----------------------------------------------------

def every_op_dataset(D=Dataset):
    """A plan touching every serializable op (from_files rides the
    process-mode image case)."""
    return (D.from_iterable(list(range(24)))
            .map(_double, name="dbl", on_error="fail", span=None)
            .shuffle(8, seed=11)
            .interleave(_tens, cycle_length=2, block_length=1)
            .skip(2).take(40)
            .batch(4, drop_remainder=False)
            .snapshot("rt")
            .prefetch(2, name="pf"))


def test_roundtrip_every_op_byte_exact():
    ds = every_op_dataset()
    text = graph.dumps(ds)
    assert graph.dumps(graph.loads(text)) == text
    # and the rebuilt plan yields the identical element sequence
    assert [list(b) for b in local(graph.loads(text))] \
        == [list(b) for b in local(ds)]


@pytest.mark.parametrize("policy", ["fail", "skip", "column"])
def test_roundtrip_on_error_policies(policy):
    src = Dataset.from_iterable(list(range(12)))
    if policy == "fail":
        ds = src.map(_double, on_error=policy, span=None)
    else:
        ds = src.map(_boom_on_seven, on_error=policy, span=None)
    text = graph.dumps(ds)
    assert graph.dumps(graph.loads(text)) == text
    spec = json.loads(text)
    assert spec["root"]["params"]["on_error"] == policy


def test_roundtrip_seeded_shuffle_replays():
    ds = Dataset.from_iterable(list(range(50))).shuffle(16, seed=3)
    rebuilt = graph.loads(graph.dumps(ds))
    assert local(rebuilt) == local(ds)


def test_lambda_rejected_at_serialize_time():
    ds = Dataset.from_iterable([1, 2]).map(lambda x: x, span=None)
    with pytest.raises(GraphSerializationError, match="lambda"):
        graph.to_spec(ds)


def test_registered_fn_roundtrips():
    closure = graph.register_fn("test.torch_data_service.plus3",
                                lambda x: x + 3)
    ds = Dataset.from_iterable([1, 2, 3]).map(closure, span=None)
    rebuilt = graph.loads(graph.dumps(ds))
    assert local(rebuilt) == [4, 5, 6]


def test_from_table_not_serializable():
    from mmlspark_tpu_torch.core.table import DataTable
    ds = Dataset.from_table(DataTable({"a": np.arange(4)}))
    with pytest.raises(GraphSerializationError, match="from_table"):
        graph.to_spec(ds)


def test_unknown_version_rejected():
    spec = graph.to_spec(Dataset.from_iterable([1]))
    spec["version"] = 999
    with pytest.raises(GraphSerializationError, match="version"):
        graph.from_spec(spec)


def range_ds(D=Dataset):
    return (D.from_iterable(list(range(40))).shuffle(8, seed=5)
            .map(_double, span=None).batch(3).prefetch(2))


@pytest.mark.parametrize("lo,hi", [(0, 3), (2, 7), (5, 5), (8, 20)])
def test_build_range_matches_local_slice(lo, hi):
    """A split is a pure function of (graph, range): building [lo, hi)
    equals slicing the full local output, through the pushed-down
    batch/map/prefetch ops above the barrier too."""
    ds = range_ds()
    spec = graph.to_spec(ds)
    full = [list(b) for b in local(ds)]
    got = [list(b) for b in
           graph.build_range(spec, lo, hi, sync=True).iterator(
               autotune=False)]
    assert got == full[lo:hi]


# -- parity with the JAX package ---------------------------------------------

def test_dumps_byte_equal_to_the_jax_package():
    """The same plan over the same module-level functions serializes to
    the same bytes in both packages, and each package's spec rebuilds in
    the other."""
    text = graph.dumps(every_op_dataset())
    assert text == jax_graph.dumps(every_op_dataset(JaxDataset))
    assert graph.dumps(graph.loads(jax_graph.dumps(
        every_op_dataset(JaxDataset)))) == text
    assert [list(b) for b in local(graph.loads(text))] == \
        [list(b) for b in jax_graph.loads(text).iterator(autotune=False)]


@pytest.mark.parametrize("lo,hi", [(0, 3), (4, 9), (11, 20)])
def test_build_range_equal_to_the_jax_package(lo, hi):
    spec = graph.to_spec(range_ds())
    assert spec == jax_graph.to_spec(range_ds(JaxDataset))
    got = [list(b) for b in graph.build_range(
        spec, lo, hi, sync=True).iterator(autotune=False)]
    want = [list(b) for b in jax_graph.build_range(
        spec, lo, hi, sync=True).iterator(autotune=False)]
    assert got == want


def graph_ds(D=Dataset):
    return (D.from_iterable(list(range(60)))
            .shuffle(16, seed=7).map(_double, span=None).batch(5))


def jax_batches(ds, **kw):
    it = ds.distribute(mode="inproc", **kw).iterator(autotune=False)
    with it:
        return [list(b) for b in it]


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_deterministic_output_equal_to_the_jax_service(workers):
    got = [list(b) for b in batches(graph_ds(), workers=workers,
                                    split_elems=2)]
    assert got == jax_batches(graph_ds(JaxDataset), workers=workers,
                              split_elems=2)
    assert got == [list(b) for b in local(graph_ds())]


def test_crash_output_equal_to_the_jax_service():
    prev = set_injector(ChaosInjector(
        script=[Fault(kind="worker_crash", worker=0, at_elem=4)]))
    try:
        with run_telemetry(None) as rt:
            got = [list(b) for b in batches(graph_ds(), workers=2,
                                            split_elems=2)]
    finally:
        set_injector(prev)
    jprev = jax_chaos.set_injector(jax_chaos.ChaosInjector(
        script=[jax_chaos.Fault(kind="worker_crash", worker=0, at_elem=4)]))
    try:
        want = jax_batches(graph_ds(JaxDataset), workers=2, split_elems=2)
    finally:
        jax_chaos.set_injector(jprev)
    assert got == want == [list(b) for b in local(graph_ds())]
    assert "redispatch" in [e["kind"] for e in rt.summary()["data_service"]]


# -- deterministic / dynamic sharding ---------------------------------------

def test_deterministic_mode_byte_identical_to_local():
    want = [list(b) for b in local(graph_ds())]
    for workers in (1, 2, 3):
        got = [list(b) for b in batches(graph_ds(), workers=workers,
                                        split_elems=2)]
        assert got == want, f"workers={workers} diverged"


def test_dynamic_mode_exactly_once():
    want = sorted(x for b in local(graph_ds()) for x in b)
    got = [x for b in batches(graph_ds(), workers=3, deterministic=False,
                              split_elems=1) for x in b]
    assert sorted(got) == want


def test_negative_workers_bypasses_service():
    """workers < 0 mirrors the prefetch escape hatch: the distribute op
    becomes a passthrough (no fleet, no session)."""
    it = graph_ds().distribute(workers=-1).iterator(autotune=False)
    with it:
        assert it.stage("service") is None
        assert [list(b) for b in it] == [list(b) for b in local(graph_ds())]


# -- crash recovery (exactly-once) ------------------------------------------

def _with_faults(faults):
    return set_injector(ChaosInjector(script=faults))


def test_inproc_crash_redispatches_and_stays_byte_identical():
    want = [list(b) for b in local(graph_ds())]
    prev = _with_faults([Fault(kind="worker_crash", worker=0, at_elem=4)])
    try:
        with run_telemetry(None) as rt:
            got = [list(b) for b in batches(graph_ds(), workers=2,
                                            split_elems=2)]
    finally:
        set_injector(prev)
    assert got == want  # no dup, no drop, same order
    kinds = [e["kind"] for e in rt.summary()["data_service"]]
    assert "worker_dead" in kinds and "redispatch" in kinds
    assert kinds.index("worker_dead") < kinds.index("redispatch")
    end = [e for e in rt.summary()["data_service"]
           if e["kind"] == "session_end"][-1]
    assert end["delivered"] == len(want)
    assert end["redispatches"] >= 1


def test_inproc_crash_dynamic_exactly_once():
    want = sorted(x for b in local(graph_ds()) for x in b)
    prev = _with_faults([Fault(kind="worker_crash", worker=1, at_elem=3)])
    try:
        got = [x for b in batches(graph_ds(), workers=2,
                                  deterministic=False, split_elems=1)
               for x in b]
    finally:
        set_injector(prev)
    assert sorted(got) == want
    assert len(got) == len(want)


def test_single_worker_crash_respawns():
    want = [list(b) for b in local(graph_ds())]
    prev = _with_faults([Fault(kind="worker_crash", worker=0, at_elem=5)])
    try:
        with run_telemetry(None) as rt:
            got = [list(b) for b in batches(graph_ds(), workers=1,
                                            split_elems=2)]
    finally:
        set_injector(prev)
    assert got == want
    kinds = [e["kind"] for e in rt.summary()["data_service"]]
    assert "respawn" in kinds


def test_worker_slow_shifts_load_not_data():
    want = [list(b) for b in local(graph_ds())]
    prev = _with_faults([Fault(kind="worker_slow", worker=0, at_elem=0,
                               factor=8.0)])
    try:
        with run_telemetry(None) as rt:
            got = [list(b) for b in batches(graph_ds(), workers=2,
                                            split_elems=1)]
    finally:
        set_injector(prev)
    assert got == want
    by_worker: dict = {}
    for e in rt.summary()["data_service"]:
        if e["kind"] == "split_end":
            by_worker[e["worker"]] = by_worker.get(e["worker"], 0) + 1
    assert by_worker.get(0, 0) < sum(n for w, n in by_worker.items()
                                     if w != 0)


# -- mid-epoch snapshot / resume --------------------------------------------

def snap_ds():
    return (Dataset.from_iterable(list(range(60))).shuffle(8, seed=3)
            .batch(4).distribute(workers=2, mode="inproc", split_elems=2)
            .snapshot("train"))


def test_snapshot_resume_replays_exact_remainder():
    full = [list(b) for b in snap_ds().iterator(autotune=False)]
    snapmod.clear()
    it = snap_ds().iterator(autotune=False)
    first = [list(next(it)) for _ in range(7)]
    offsets = snapmod.snapshot_offsets()
    it.close()
    assert offsets == {"train": 7}
    snapmod.set_restore_offsets(offsets)
    rest = [list(b) for b in snap_ds().iterator(autotune=False)]
    assert first + rest == full


def test_snapshot_resume_fast_forward_never_produces_prefix():
    """With snapshot directly above distribute, resume fast-forwards the
    dispatch origin: the skipped prefix is never produced, which the
    dispatch events' split ranges show."""
    snapmod.set_restore_offsets({"train": 7})
    with run_telemetry(None) as rt:
        rest = [list(b) for b in snap_ds().iterator(autotune=False)]
    full = [list(b) for b in snap_ds().iterator(autotune=False)]
    assert rest == full[7:]
    events = rt.summary()["data_service"]
    assert any(e["kind"] == "resume" and e.get("offset") == 7
               for e in events)
    assert min(e["start"] for e in events if e["kind"] == "dispatch") == 7


def test_snapshot_resume_islice_fallback():
    """A snapshot NOT directly above the service still resumes exactly
    (the consumer drops the consumed prefix)."""
    def build():
        return (Dataset.from_iterable(list(range(40))).batch(4)
                .distribute(workers=2, mode="inproc")
                .prefetch(-1).snapshot("t2"))
    full = [list(b) for b in build().iterator(autotune=False)]
    snapmod.clear()
    it = build().iterator(autotune=False)
    first = [list(next(it)) for _ in range(4)]
    offsets = snapmod.snapshot_offsets()
    it.close()
    snapmod.set_restore_offsets(offsets)
    rest = [list(b) for b in build().iterator(autotune=False)]
    assert first + rest == full


def _port_trainer_for_meta():
    from mmlspark_tpu_torch.train.trainer import Trainer, TrainerConfig
    trainer = Trainer.__new__(Trainer)   # the sidecar reads these only
    trainer.shard_devices, trainer.model_size = ["cpu"], 1
    trainer.config = TrainerConfig(batch_size=8)
    trainer._effective_batch_size = 8
    return Trainer, trainer


def test_snapshot_offsets_land_in_trainer_meta():
    """The trainer's checkpoint sidecar carries every live snapshot's
    consumed offset, and a saved meta re-arms the restore registry."""
    Trainer, trainer = _port_trainer_for_meta()
    h = snapmod.register("train")
    h.consumed = 13
    meta = Trainer._ckpt_meta(trainer, 5)
    assert meta["data_snapshots"] == {"train": 13}
    snapmod.clear()
    snapmod.set_restore_offsets(meta["data_snapshots"])
    assert snapmod.take_restore("train") == 13
    assert snapmod.take_restore("train") == 0  # one-shot


def test_ckpt_meta_equal_to_the_jax_trainers():
    """With a live snapshot("train") handle the port's sidecar is the JAX
    Trainer's, `data_snapshots` included; with none, neither has it."""
    from mmlspark_tpu.data import snapshot as jax_snapmod
    from mmlspark_tpu.train.trainer import Trainer as JaxTrainer
    from mmlspark_tpu.train.trainer import TrainerConfig as JaxConfig
    Trainer, trainer = _port_trainer_for_meta()
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.mesh = type("M", (), {"shape": {}})()
    jt.config = JaxConfig(batch_size=8)
    jt._effective_batch_size = 8
    jax_snapmod.clear()
    try:
        assert Trainer._ckpt_meta(trainer, 3) == \
            JaxTrainer._ckpt_meta(jt, 3)
        snapmod.register("train").consumed = 21
        jax_snapmod.register("train").consumed = 21
        meta = Trainer._ckpt_meta(trainer, 3)
        assert meta == JaxTrainer._ckpt_meta(jt, 3)
        assert meta["data_snapshots"] == {"train": 21}
    finally:
        jax_snapmod.clear()


def test_resumed_fit_rearms_the_snapshot_offset(tmp_path):
    from mmlspark_tpu_torch import Trainer, TrainerConfig
    cfg = TrainerConfig(
        architecture="TransformerLM",
        model_config={"vocab_size": 16, "d_model": 8, "n_heads": 2,
                      "n_layers": 1, "max_len": 4, "dtype": "float32"},
        optimizer="sgd", learning_rate=0.1, epochs=1, batch_size=4,
        seed=0, numerics_cadence=0, checkpoint_every_steps=1)
    rows = np.random.default_rng(0).integers(0, 16, (8, 5)).astype(np.int32)
    snapmod.register("train").consumed = 6
    Trainer(cfg, device="cpu").fit_arrays(rows[:, :-1], rows[:, 1:],
                                          ckpt_dir=str(tmp_path))
    snapmod.clear()
    Trainer(cfg, device="cpu").fit_arrays(rows[:, :-1], rows[:, 1:],
                                          ckpt_dir=str(tmp_path),
                                          resume=True)
    assert snapmod.take_restore("train") == 6


# -- autoscaling -------------------------------------------------------------

def test_autotuner_scales_worker_fleet_from_stall_evidence():
    """workers=0 = autoscale: the fleet starts at one worker and the stock
    Autotuner widens it through the ServiceConsumer's depth surface
    (scale_unit='workers'), never above MAX_WORKERS, never below its
    depth_floor of 1."""
    prev = config.get("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL")
    config.set("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL", 8)
    try:
        it = (Dataset.from_iterable(list(range(200))).batch(2)
              .distribute(workers=0, mode="inproc", split_elems=1)
              .iterator())
        with it:
            out = [list(b) for b in it]
        assert len(out) == 100
        stage = it.stage("service")
        assert stage is not None and stage.tunable
        assert stage.runner.scale_unit == "workers"
        assert stage.runner.depth_floor == 1
        widened = [d for d in (it.tuner.decisions if it.tuner else [])
                   if d["stage"] == "service" and d["action"] == "widen"]
        assert widened, "no widen decision despite a stalling consumer"
        assert all(d["unit"] == "workers" for d in widened)
        assert stage.runner.depth > 1
        assert stage.runner.depth <= stage.runner.max_depth
    finally:
        config.set("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL", prev)


def test_service_consumer_scale_clamped():
    from mmlspark_tpu_torch.data.service import DataService
    from mmlspark_tpu_torch.data.service.consume import ServiceConsumer
    svc = DataService(workers=2, mode="inproc", max_workers=3)
    spec = graph.to_spec(Dataset.from_iterable(list(range(8))))
    consumer = ServiceConsumer(svc, spec)
    try:
        assert consumer.depth == 2
        assert consumer.max_depth == 3
        assert consumer.set_depth(99) == 3
        assert consumer.set_depth(0) == 1  # floor: one worker
        assert {"deliveries", "stalls", "stall_s",
                "residency"} <= set(consumer.stats())
    finally:
        consumer.close()


# -- per-worker gauge namespace ---------------------------------------------

def test_prefetcher_gauges_use_worker_namespace():
    """Inside a service worker (namespace knob set), Prefetcher stage
    gauges publish under data.service.w<k>.<stage>.* instead of
    prefetch.<stage>.*."""
    from mmlspark_tpu_torch.parallel.prefetch import Prefetcher
    config.set("MMLSPARK_TPU_DATA_SERVICE_WORKER_NS", "data.service.w3")
    try:
        with run_telemetry(None) as rt:
            with Prefetcher(lambda x: x, range(6), depth=2,
                            name="decode") as pf:
                list(pf)
        gauges = rt.summary()["gauges"]
    finally:
        config.set("MMLSPARK_TPU_DATA_SERVICE_WORKER_NS", None)
    assert "data.service.w3.decode.depth" in gauges
    assert not any(k.startswith("prefetch.decode") for k in gauges)
    with run_telemetry(None) as rt:
        with Prefetcher(lambda x: x, range(6), depth=2,
                        name="decode") as pf:
            list(pf)
    assert "prefetch.decode.depth" in rt.summary()["gauges"]


def test_dispatcher_publishes_per_worker_gauges():
    with run_telemetry(None) as rt:
        got = [list(b) for b in batches(graph_ds(), workers=2,
                                        split_elems=1)]
    assert got == [list(b) for b in local(graph_ds())]
    gauges = rt.summary()["gauges"]
    produced = {k: v["last"] for k, v in gauges.items()
                if k.startswith("data.service.w") and
                k.endswith(".produced")}
    assert len(produced) == 2, gauges.keys()
    assert sum(int(v) for v in produced.values()) >= 12  # every batch


# -- process mode (real worker processes) ------------------------------------

def test_spawn_worker_hides_the_card(monkeypatch, tmp_path):
    """A spawned worker's environment has CUDA_VISIBLE_DEVICES="" (it
    never creates a CUDA context), its gauge namespace and the chaos plan;
    its stderr goes to the log directory when the knob names one."""
    from mmlspark_tpu_torch.data.service import transport
    seen = {}

    def fake_popen(cmd, **kw):
        seen.update(cmd=cmd, **kw)
        return "proc"
    monkeypatch.setattr(transport.subprocess, "Popen", fake_popen)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    config.set("MMLSPARK_TPU_DATA_SERVICE_WORKER_LOG", str(tmp_path))
    try:
        assert transport.spawn_worker(
            3, "127.0.0.1", 4242,
            env={"MMLSPARK_TPU_DATA_SERVICE_CHAOS": "crash:2"}) == "proc"
    finally:
        config.set("MMLSPARK_TPU_DATA_SERVICE_WORKER_LOG", None)
    env = seen["env"]
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env["MMLSPARK_TPU_DATA_SERVICE_WORKER_NS"] == "data.service.w3"
    assert env["MMLSPARK_TPU_DATA_SERVICE_CHAOS"] == "crash:2"
    import os

    import mmlspark_tpu_torch
    assert env["PYTHONPATH"].split(os.pathsep)[0] == os.path.dirname(
        os.path.dirname(os.path.abspath(mmlspark_tpu_torch.__file__)))
    assert seen["cmd"][1:3] == ["-m", "mmlspark_tpu_torch.data.service.worker"]
    assert seen["cmd"][-4:] == ["--connect", "127.0.0.1:4242", "--id", "3"]
    assert (tmp_path / "worker-3.log").exists()


def test_worker_runs_a_split_without_torch(tmp_path):
    """A worker's imports and an image-decode split load no torch (the
    package's exports resolve lazily), so a worker process starts in a
    fraction of a second and can never touch the card."""
    write_pngs(tmp_path, 6)
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'torch' or name.startswith('torch.'):\n"
        "            raise ImportError('torch imported: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from mmlspark_tpu_torch.data import Dataset, graph\n"
        "from mmlspark_tpu_torch.data.service import transport, worker\n"
        "from mmlspark_tpu_torch.io.image_reader import "
        "service_decode_chunk\n"
        "from mmlspark_tpu_torch.resilience.retry import RetryPolicy\n"
        f"ds = Dataset.from_files({str(tmp_path)!r}).batch(4)\n"
        "spec = graph.to_spec(ds.map(service_decode_chunk, span=None))\n"
        "out = list(worker.WorkerCore(spec).run_split(0, 2))\n"
        "print([len(paths) for _, (paths, images) in out])\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.split() == ["[4,", "2]"]


def test_process_mode_deterministic_matches_local(proc_workers):
    """Real workers give the local stream; then the fleet shrinks and
    regrows: a retired worker leaves the selector before its socket
    closes, so the replacement's connection (which may reuse the
    descriptor number) registers."""
    from mmlspark_tpu_torch.data.service import DataService
    ds = (Dataset.from_iterable(list(range(40))).shuffle(8, seed=2)
          .batch(4))
    want = [list(b) for b in local(ds)]
    assert [list(b) for b in batches(ds, workers=2, mode="process")] == want
    session = DataService(workers=2, mode="process",
                          split_elems=1).session(graph.to_spec(ds))
    try:
        got = []
        while True:
            try:
                got.append(list(session.next_element()))
            except StopIteration:
                break
        assert got == want
        assert session.scale(1) == 1 and session.scale(2) == 2
        for _ in range(600):
            if sum(w.alive and w.ready for w in session._workers) == 2:
                break
            session._pump(0.05)
        assert sum(w.alive and w.ready for w in session._workers) == 2
    finally:
        session.close()


def write_pngs(directory, n=12):
    for i in range(n):
        arr = np.full((8, 8, 3), i * 3, dtype=np.uint8)
        arr[:, :, 1] += np.arange(8, dtype=np.uint8)
        Image.fromarray(arr).save(directory / f"img_{i:02d}.png")


def test_process_mode_images_via_read_images_iter(proc_workers, tmp_path):
    """read_images_iter consumes the service with no caller-visible
    change: the same tables in the same order as the port's local reader
    and as the JAX reader's service path."""
    from mmlspark_tpu.data.service import DataService as JaxService
    from mmlspark_tpu.io.image_reader import read_images_iter as jax_iter
    from mmlspark_tpu_torch.data.service import DataService
    from mmlspark_tpu_torch.io.image_reader import read_images_iter
    write_pngs(tmp_path)
    local_tables = list(read_images_iter(str(tmp_path), batch_size=5,
                                         device="cpu"))
    svc = DataService(workers=2, mode="process", split_elems=1)
    svc_tables = list(read_images_iter(str(tmp_path), batch_size=5,
                                       service=svc, device="cpu"))
    jax_tables = list(jax_iter(str(tmp_path), batch_size=5,
                               service=JaxService(workers=2, mode="inproc",
                                                  split_elems=1)))
    assert len(svc_tables) == len(local_tables) == len(jax_tables) == 3
    for a, b, c in zip(svc_tables, local_tables, jax_tables):
        assert list(a["path"]) == list(b["path"]) == list(c["path"])
        np.testing.assert_array_equal(np.asarray(a["image"]),
                                      np.asarray(b["image"]))
        np.testing.assert_array_equal(np.asarray(a["image"]),
                                      np.asarray(c["image"]))


def test_worker_that_cannot_start_raises(proc_workers, monkeypatch):
    """A fleet whose workers exit before connecting raises
    DataServiceError once the respawn budget is spent; it never falls
    back to running the graph locally."""
    from mmlspark_tpu_torch.data.service import (DataService,
                                                 DataServiceError, transport)

    def dead_worker(worker_id, host, port, env=None):
        return subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])
    monkeypatch.setattr(transport, "spawn_worker", dead_worker)
    svc = DataService(workers=1, mode="process", respawns=1)
    it = Dataset.from_iterable(list(range(8))).distribute(svc).iterator(
        autotune=False)
    with pytest.raises(DataServiceError, match="respawn budget exhausted"):
        with it:
            next(it)


# ---------------------------------------------------------------------------
# transport element frames (the four page-frame cases of the JAX file are
# tests/test_torch_transport.py's)
# ---------------------------------------------------------------------------

def test_elem_frame_roundtrips_numpy():
    from mmlspark_tpu.data.service.transport import FrameBuffer as JaxBuf
    from mmlspark_tpu_torch.data.service.transport import (FrameBuffer,
                                                           send_elem)
    a, b = socket.socketpair()
    try:
        obj = (["p0", "p1"], [np.arange(6, dtype=np.uint8).reshape(2, 3),
                              None])
        send_elem(a, 4, 7, obj)
        data = b.recv(1 << 16)
    finally:
        a.close()
        b.close()
    for buf in (FrameBuffer(), JaxBuf()):
        buf.feed(data)
        [(kind, split, seq, got)] = list(buf.frames())
        assert (kind, split, seq) == ("elem", 4, 7)
        assert got[0] == obj[0] and got[1][1] is None
        np.testing.assert_array_equal(got[1][0], obj[1][0])
