"""Training over several processes with a seq axis inside each: two real
processes over gloo on 127.0.0.1 (`tests/torch_multihost_worker.py seq`),
a global data 2 x seq 2 mesh, so each process holds data 1 x seq 2 (the
seq axis replicates its batch), fit tests/test_torch_multihost_bn.py's
basic ResNet, its BatchNorm statistics summed over the processes once
(the seq replicas add nothing).  A data axis the process count does not
divide raises the JAX Trainer's ValueError in each worker.

Bounds: bit-equal to one process's fit over data 2 x seq 2 fed the same
global batches; within 1e-4 of the JAX Trainer's fit over a data 2 x seq
2 mesh from the same init (losses relative, leaves of each leaf's max
|w|); the bundle's partition mesh counts data 2; only the coordinator's
checkpoint directory exists, its sidecar recording data_devices 2."""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_multihost_bn import (ROOT, WORKER, _flat, _free_port,
                                     init_bundle, worker)

__all__ = ["init_bundle", "worker"]   # the fixtures this file shares


def _references(worker, init_bundle):
    """One process's fit over data 2 x seq 2 (`[cpu] * 4`), fed each
    step's global batch in the processes' order, and the JAX Trainer's
    fit over a data 2 x seq 2 mesh of the same batches."""
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
        MeshSpec(data=2, seq=2), [torch.device("cpu")] * 4))
    # one intra-op thread, as each worker runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bundle = trainer.fit_arrays(
            x[order], y[order], initial_bundle=load_bundle(init_bundle[1]))
    finally:
        torch.set_num_threads(threads)
    jax_trainer = JaxTrainer(JaxTrainerConfig(**worker.BN_FIT),
                             mesh=jax_make_mesh(JaxMeshSpec(data=2, seq=2),
                                                devices=jax.devices()[:4]))
    jax_bundle = jax_trainer.fit_arrays(x[order], y[order],
                                        initial_bundle=init_bundle[0])
    return (trainer, bundle,
            np.asarray([h["loss"] for h in jax_trainer.history]),
            jax.tree_util.tree_map(np.asarray, jax_bundle.variables))


@pytest.fixture(scope="module")
def both(worker, init_bundle, tmp_path_factory):
    """The two workers' results, and the references computed here while
    the workers run."""
    out = str(tmp_path_factory.mktemp("mh_seq"))
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
            [sys.executable, WORKER, "seq", out, init_bundle[1]], env=env,
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
    return (out, [dict(np.load(os.path.join(out, f"seq{pid}.npz")))
                  for pid in range(2)]), refs


def test_two_processes_over_a_seq_mesh_equal_one_process_bit_for_bit(both):
    (_, results), (trainer, bundle, _, _) = both
    want = {**_flat(bundle.variables["batch_stats"], "stat"),
            **_flat(bundle.variables["params"], "param")}
    losses = np.asarray([h["loss"] for h in trainer.history])
    assert bundle.metadata["partition"]["mesh"] == {"data": 2, "model": 1}
    for r in results:
        assert int(r["steps"]) == 4 and int(r["mesh_data"]) == 2
        np.testing.assert_array_equal(r["losses"], losses)
        assert sorted(k for k in r if "/" in k) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(r[key], value, err_msg=key)


def test_two_processes_over_a_seq_mesh_match_the_jax_fit(both):
    (_, results), (_, _, jax_losses, jax_vars) = both
    want = {**_flat(jax_vars["batch_stats"], "stat"),
            **_flat(jax_vars["params"], "param")}
    got = results[0]
    np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-4)
    for key, value in want.items():
        bound = 1e-4 * max(1.0, float(np.abs(value).max()))
        assert np.abs(got[key] - value).max() <= bound, key


def test_only_the_coordinator_writes_and_records_data_two(both):
    from mmlspark_tpu_torch.resilience.checkpoints import (
        checkpoint_meta, latest_valid_checkpoint)
    (out, _), _ = both
    path = latest_valid_checkpoint(os.path.join(out, "seq_ckpt0"))
    assert path is not None and path.endswith("ckpt_0000000004.msgpack")
    meta = checkpoint_meta(path)
    assert (meta["data_devices"], meta["model_devices"],
            meta["process_count"]) == (2, 1, 2)
    assert not os.path.exists(os.path.join(out, "seq_ckpt1"))
