"""Training BatchNorm across processes (`parallel/ring.py` `process_sum`
under `ShardGroup.all_sum`): two real processes over gloo on 127.0.0.1,
one data shard each (`tests/torch_multihost_worker.py bn`), fit a basic
ResNet whose BatchNorm statistics are the global batch's.

Bounds: bit-equal to one process's data-2 fit fed the same global
batches (two terms add alike in either order); within 1e-4 of the JAX
Trainer's data-2 fit from the same init (losses relative, leaves of each
leaf's max |w|); the same `batch_stats` bytes on both processes; only
the coordinator's checkpoint directory exists."""

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


@pytest.fixture(scope="module")
def worker():
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_multihost_worker",
                                                  WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def init_bundle(worker, tmp_path_factory):
    """The port's seeded init of the ResNet (no eager flax init), as a
    bundle file, and as the JAX bundle of the same variables."""
    from mmlspark_tpu.models import ModelBundle as JaxModelBundle
    from mmlspark_tpu_torch.models.bundle import ModelBundle, save_bundle
    bundle = ModelBundle.init("ResNet", worker.BN_RESNET, seed=0,
                              input_shape=(1, 8, 8, 3))
    path = str(tmp_path_factory.mktemp("bn_init") / "bundle")
    save_bundle(bundle, path)
    return JaxModelBundle(bundle.architecture, bundle.config,
                          bundle.variables), path


def _references(worker, init_bundle):
    """One process's data-2 fit over `[cpu] * 2`, fed each step's global
    batch in the processes' order (process 0's 4 rows, then process
    1's), and the JAX Trainer's data-2 fit of the same batches."""
    import jax
    import torch

    from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from mmlspark_tpu.train import Trainer as JaxTrainer
    from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
    from mmlspark_tpu_torch.models.bundle import load_bundle
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from mmlspark_tpu_torch.train import Trainer, TrainerConfig
    x, y = worker.make_images()
    order = np.r_[0:4, 8:12, 4:8, 12:16]
    trainer = Trainer(TrainerConfig(**worker.BN_FIT), mesh=make_mesh(
        MeshSpec(data=2), [torch.device("cpu")] * 2))
    # one intra-op thread, as each worker runs: the CPU kernels split
    # their reductions by thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bundle = trainer.fit_arrays(
            x[order], y[order], initial_bundle=load_bundle(init_bundle[1]))
    finally:
        torch.set_num_threads(threads)
    jax_trainer = JaxTrainer(JaxTrainerConfig(**worker.BN_FIT),
                             mesh=jax_make_mesh(JaxMeshSpec(data=2),
                                                devices=jax.devices()[:2]))
    jax_bundle = jax_trainer.fit_arrays(x[order], y[order],
                                        initial_bundle=init_bundle[0])
    return (trainer, bundle,
            np.asarray([h["loss"] for h in jax_trainer.history]),
            jax.tree_util.tree_map(np.asarray, jax_bundle.variables))


@pytest.fixture(scope="module")
def both(worker, init_bundle, tmp_path_factory):
    """The two workers' results, and the references computed here while
    the workers run."""
    out = str(tmp_path_factory.mktemp("mh_bn"))
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
            [sys.executable, WORKER, "bn", out, init_bundle[1]], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        refs = _references(worker, init_bundle)
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
    return (out, [dict(np.load(os.path.join(out, f"bn{pid}.npz")))
                  for pid in range(2)]), refs


@pytest.fixture(scope="module")
def run(both):
    return both[0]


@pytest.fixture(scope="module")
def one_process(both):
    return both[1]


def _flat(tree, prefix):
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(_flat(tree[key], f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(tree[key])
    return out


def test_two_processes_equal_one_process_data_two_bit_for_bit(run,
                                                              one_process):
    _, results = run
    trainer, bundle, _, _ = one_process
    want = {**_flat(bundle.variables["batch_stats"], "stat"),
            **_flat(bundle.variables["params"], "param")}
    losses = np.asarray([h["loss"] for h in trainer.history])
    for r in results:
        assert int(r["steps"]) == 4
        np.testing.assert_array_equal(r["losses"], losses)
        assert sorted(k for k in r if "/" in k) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(r[key], value, err_msg=key)


def test_both_processes_hold_the_same_batch_stats_bytes(run):
    _, (r0, r1) = run
    stats = [k for k in r0 if k.startswith("stat/")]
    assert stats
    for key in stats:
        assert r0[key].tobytes() == r1[key].tobytes(), key


def test_two_processes_match_the_jax_data_two_fit(run, one_process):
    _, results = run
    _, _, jax_losses, jax_vars = one_process
    want = {**_flat(jax_vars["batch_stats"], "stat"),
            **_flat(jax_vars["params"], "param")}
    got = results[0]
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-4)
    for key, value in want.items():
        bound = 1e-4 * max(1.0, float(np.abs(value).max()))
        assert np.abs(got[key] - value).max() <= bound, key


def test_only_the_coordinator_writes_batchnorm_checkpoints(run):
    from mmlspark_tpu_torch.resilience.checkpoints import (
        latest_valid_checkpoint)
    out, _ = run
    path = latest_valid_checkpoint(os.path.join(out, "bn_ckpt0"))
    assert path is not None and path.endswith("ckpt_0000000004.msgpack")
    assert not os.path.exists(os.path.join(out, "bn_ckpt1"))
