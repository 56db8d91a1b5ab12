"""The port over several processes (`parallel/distributed.py` over
torch.distributed): two real processes over gloo on 127.0.0.1, each
with a local mesh of `[cpu] * 4` (a global data axis of 8), running the
scenarios of `tests/multihost_worker.py` through
`tests/torch_multihost_worker.py`, held against the JAX single-process
8-device Trainer to the JAX test's tolerances.  The JAX init reaches the
workers as a bundle file written here."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_multihost_worker",
                                                  WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def worker():
    return _worker_module()


@pytest.fixture(scope="module")
def init_bundle(worker, tmp_path_factory):
    """The JAX package's init of the MLP, as a bundle file."""
    from mmlspark_tpu.models import ModelBundle as JaxModelBundle
    from mmlspark_tpu.models.bundle import save_bundle as jax_save_bundle
    from mmlspark_tpu.models.definitions import build_model
    bundle = JaxModelBundle.init(build_model("MLPClassifier", worker.MLP),
                                 (1, 4), seed=0)
    path = str(tmp_path_factory.mktemp("init") / "bundle")
    jax_save_bundle(bundle, path)
    return bundle, path


@pytest.fixture(scope="module")
def two_process_run(init_bundle, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mh"))
    port = _free_port()
    procs, logs = [], []
    for pid in range(2):
        env = dict(os.environ)
        env.update({
            "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
            "MMLSPARK_TPU_COORDINATOR": f"127.0.0.1:{port}",
            "MMLSPARK_TPU_NUM_PROCESSES": "2",
            "MMLSPARK_TPU_PROCESS_ID": str(pid),
            "MMLSPARK_TPU_COLLECTIVE_TIMEOUT_S": "60",
        })
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, out, init_bundle[1]], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=120)
            logs.append(stdout)
    finally:
        for p in procs:  # a collective deadlock must not leak workers
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-3000:]}"
    return out


@pytest.fixture(scope="module")
def results(two_process_run):
    return [np.load(os.path.join(two_process_run, f"result{pid}.npz"))
            for pid in range(2)]


@pytest.fixture(scope="module")
def jax_ref(worker, init_bundle):
    """The JAX single-process 8-device fit from the same init, and its
    scores of the whole table."""
    from mmlspark_tpu import DataTable as JaxDataTable
    from mmlspark_tpu.models import TPUModel as JaxTPUModel
    from mmlspark_tpu.train import Trainer as JaxTrainer
    from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
    x, y = worker.make_data()
    trainer = JaxTrainer(JaxTrainerConfig(**worker.FIT))
    assert trainer.mesh.shape["data"] == 8
    bundle = trainer.fit_arrays(x, y, initial_bundle=init_bundle[0])
    scores = JaxTPUModel(bundle, inputCol="features", outputCol="scores",
                         miniBatchSize=32).transform(
        JaxDataTable({"features": x}))["scores"]
    return dict(
        losses=np.asarray([h["loss"] for h in trainer.history]),
        kernel=np.asarray(bundle.variables["params"]["dense0"]["kernel"]),
        steps=bundle.metadata["steps"], scores=np.asarray(scores))


def test_two_processes_match_the_jax_single_process_fit(results, jax_ref):
    """Same global batch, same math: the losses and weights of the JAX
    8-device run."""
    got = results[0]
    np.testing.assert_allclose(got["losses"], jax_ref["losses"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["kernel"], jax_ref["kernel"], rtol=1e-3,
                               atol=1e-5)
    assert int(got["steps"]) == jax_ref["steps"] == 4


def test_both_processes_agree_on_the_result(results):
    np.testing.assert_array_equal(results[0]["kernel"], results[1]["kernel"])
    np.testing.assert_array_equal(results[0]["losses"], results[1]["losses"])


def test_restore_broadcasts_from_the_coordinator(results):
    """Process 1 has no checkpoint directory; it restores the final state
    from the coordinator's broadcast."""
    for r in results:
        assert int(r["restored_step"]) == int(r["steps"])
        np.testing.assert_array_equal(r["restored_kernel"], r["kernel"])


def test_scoring_uneven_partitions_on_both_mesh_paths(results, jax_ref,
                                                      worker):
    """Each process gets back exactly its own rows (process 0 has 3
    fewer), the same on its local mesh and on the mesh over both
    processes, and equal to the JAX scoring of the JAX-trained bundle."""
    rows = len(worker.make_data()[0]) // 2
    r0, r1 = results
    assert r0["scores"].shape == (rows - 3, 2)
    assert r1["scores"].shape == (rows, 2)
    for r in results:
        np.testing.assert_allclose(r["scores_global"], r["scores"],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r0["scores"], jax_ref["scores"][:rows - 3],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r1["scores"], jax_ref["scores"][rows:],
                               rtol=1e-4, atol=1e-5)


def test_unequal_partitions_rotate_all_rows(results):
    for r in results:
        assert int(r["uneq_rows_seen"]) == int(r["uneq_rows_total"])


def test_only_the_coordinator_writes_checkpoints(two_process_run):
    """The coordinator's directory holds the rotation (found through
    `latest_valid_checkpoint`); process 1 never made its own.  The
    sidecar records the real process count and the global data axis."""
    from mmlspark_tpu_torch.resilience.checkpoints import (
        checkpoint_meta, latest_valid_checkpoint)
    path = latest_valid_checkpoint(os.path.join(two_process_run, "ckpt0"))
    assert path is not None and path.endswith("ckpt_0000000004.msgpack")
    meta = checkpoint_meta(path)
    assert meta["process_count"] == 2
    assert meta["data_devices"] == 8
    assert meta["effective_batch_size"] == 128
    assert not os.path.exists(os.path.join(two_process_run, "ckpt1"))


def test_health_check_and_a_withheld_barrier(results):
    """Both processes answer the health check; a barrier process 1
    withholds raises CollectiveTimeoutError naming the op after its
    timeout."""
    for r in results:
        assert r["health"].tolist() == [0, 1]
    assert str(results[0]["timeout_op"]) == "barrier:withheld"
    assert 2.5 <= float(results[0]["waited"]) <= 10.0


def test_pipeline_stages_inside_processes_match_one_process(results,
                                                             worker):
    """Two stages inside each process and the data axis across them
    train as one process's (2, 2) pipeline fed the same global batches
    (process 0's next 4 rows, then process 1's)."""
    import torch

    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from mmlspark_tpu_torch.train import Trainer, TrainerConfig
    toks, tgts = worker.make_tokens()
    order = np.r_[0:4, 8:12, 4:8, 12:16]
    ref = Trainer(TrainerConfig(**worker.PP_FIT), mesh=make_mesh(
        MeshSpec(data=2, model=2), [torch.device("cpu")] * 4))
    bundle = ref.fit_arrays(toks[order], tgts[order])
    want = np.asarray([h["loss"] for h in ref.history])
    for r in results:
        np.testing.assert_allclose(r["pp_losses"], want, rtol=1e-6)
        np.testing.assert_allclose(
            r["pp_head"], bundle.variables["params"]["lm_head"]["kernel"],
            rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(results[0]["pp_head"],
                                  results[1]["pp_head"])


def test_one_process_collectives_are_identities():
    """Without a process group every collective is the identity, and
    the knobs unset mean no initialization."""
    import torch

    from mmlspark_tpu_torch.parallel import distributed as d
    assert d.initialize_distributed(d.DistributedConfig(), device="cpu") \
        is False
    assert (d.process_count(), d.process_index(), d.is_coordinator()) == \
        (1, 0, True)
    assert d.health_check() == [0]
    t = [torch.ones(3)]
    assert d.all_reduce_sum(t) is not None and torch.equal(t[0],
                                                           torch.ones(3))
    tree = {"a": np.arange(3), "b": torch.zeros(2)}
    assert d.broadcast_one_to_all(tree) is tree
    np.testing.assert_array_equal(d.process_allgather(np.asarray(5)), [5])
    assert d.run_collective("x", lambda: 7) == 7
    from mmlspark_tpu_torch.parallel.bridge import put_sharded
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(data=2), [torch.device("cpu")] * 2)
    slabs = put_sharded(np.arange(8).reshape(4, 2), mesh)
    assert [s.tolist() for s in slabs] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]
    with pytest.raises(ValueError, match="not divisible"):
        put_sharded(np.arange(3), mesh)
    with pytest.raises(ValueError, match="MMLSPARK_TPU_PROCESS_ID"):
        d.initialize_distributed(d.DistributedConfig(
            coordinator_address="127.0.0.1:1", num_processes=2),
            device="cpu")


def test_broadcast_at_world_size_one_keeps_each_leaf():
    """Over a gloo group of one rank the collectives run: a tree of mixed
    leaves (tensors of two dtypes, numpy arrays, a numpy scalar) comes
    back with each leaf's values, dtype, shape and kind, and a sum is
    unchanged."""
    import socket

    import torch

    from mmlspark_tpu_torch.parallel import distributed as d
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert d.initialize_distributed(d.DistributedConfig(
        coordinator_address=f"127.0.0.1:{port}", num_processes=1,
        process_id=0), device="cpu")
    try:
        tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "h": torch.ones(4, dtype=torch.bfloat16),
                "z": {"n": np.arange(5, dtype=np.int64),
                      "s": np.int64(7)}}
        out = d.broadcast_one_to_all(tree)
        assert out is not tree
        assert torch.equal(out["w"], tree["w"])
        assert out["h"].dtype == torch.bfloat16 and torch.equal(out["h"],
                                                                tree["h"])
        assert isinstance(out["z"]["n"], np.ndarray)
        np.testing.assert_array_equal(out["z"]["n"], np.arange(5))
        assert out["z"]["s"] == 7 and not isinstance(out["z"]["s"],
                                                      np.ndarray)
        t = [torch.full((3,), 2.0)]
        d.all_reduce_sum(t)
        assert torch.equal(t[0], torch.full((3,), 2.0))
        assert d.process_count() == 1
    finally:
        d.shutdown_distributed()
    assert d.process_count() == 1
