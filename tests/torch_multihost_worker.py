"""One process of the port's two-process run (`tests/test_torch_multihost.py`),
after `tests/multihost_worker.py`: two processes over gloo on 127.0.0.1,
each scoring and training on a local mesh of `[cpu] * 4`, so that the
global data axis is 8.  The worker never initializes torch.distributed
itself: `Trainer.__init__` joins the process group from the
MMLSPARK_TPU_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID knobs.  It
imports only the port.

Invoked as: python torch_multihost_worker.py <out_dir> <init_bundle_dir>,
or with `bn` first (`tests/test_torch_multihost_bn.py`): a ResNet with
training BatchNorm fitted over a global data axis of 2, one shard a
process, its statistics summed across the processes; with `seq` first
(`tests/test_torch_multihost_seq.py`) the same over a global data 2 x
seq 2 mesh.
"""

import os
import sys
import time

import numpy as np

MLP = {"hidden_sizes": [16], "num_classes": 2, "dtype": "float32"}
FIT = dict(architecture="MLPClassifier", model_config=MLP,
           optimizer="momentum", learning_rate=0.05, epochs=4,
           batch_size=128, loss="softmax_xent", seed=0,
           shuffle_each_epoch=False, numerics_cadence=0)
WITHHELD_TIMEOUT_S = 3.0
# the pipelined LM: 2 stages inside each process, data across them
PP_LM = {"vocab_size": 32, "d_model": 16, "n_heads": 4, "n_layers": 2,
         "max_len": 12, "dtype": "float32"}
PP_FIT = dict(architecture="TransformerLM", model_config=PP_LM,
              optimizer="adam", learning_rate=1e-2, epochs=2, batch_size=8,
              loss="softmax_xent", seed=0, shuffle_each_epoch=False,
              pipeline_stages=2, pipeline_microbatches=2,
              numerics_cadence=0)


# training BatchNorm across the processes: a basic ResNet, one data shard
# a process (momentum: no Adam amplification of round-off on a
# zero-gradient direction)
BN_RESNET = {"stage_sizes": [1], "widths": [4], "num_classes": 3,
             "dtype": "float32"}
BN_FIT = dict(architecture="ResNet", model_config=BN_RESNET,
              optimizer="momentum", learning_rate=0.05, epochs=2,
              batch_size=8, loss="softmax_xent", seed=0,
              shuffle_each_epoch=False, numerics_cadence=0)


def make_images(n=16, seed=3):
    """Images (n, 8, 8, 3) and labels, process p holding rows
    [n/2 p, n/2 (p + 1))."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def bn_main(out_dir, init_dir, mode="bn"):
    """The BatchNorm fit: each process feeds 4 rows a step of its half;
    only the coordinator writes checkpoints.  `mode` "seq" fits over a
    global data 2 x seq 2 mesh (each process data 1 x seq 2: the seq axis
    replicates the batch), and checks that a data axis the processes do
    not divide still raises."""
    import torch

    from mmlspark_tpu_torch.models.bundle import load_bundle
    from mmlspark_tpu_torch.train import Trainer, TrainerConfig

    torch.set_num_threads(1)
    pid = int(os.environ["MMLSPARK_TPU_PROCESS_ID"])
    nproc = int(os.environ["MMLSPARK_TPU_NUM_PROCESSES"])
    x, y = make_images()
    half = len(x) // nproc
    mesh = {"data": 2, "seq": 2} if mode == "seq" else {"data": 2}
    trainer = Trainer(TrainerConfig(
        **BN_FIT, mesh=mesh,
        checkpoint_dir=os.path.join(out_dir, f"{mode}_ckpt{pid}"),
        checkpoint_every_steps=2), device="cpu")
    assert trainer.data_size == 1 and trainer.mesh.process_count == nproc
    if mode == "seq":
        from mmlspark_tpu_torch.parallel.mesh import (MeshSpec,
                                                      make_process_mesh)
        assert trainer.mesh.shape == {"data": 1, "model": 1, "seq": 2}
        assert trainer.mesh.global_shape["data"] == 2
        try:
            make_process_mesh(MeshSpec(data=1, seq=4),
                              [torch.device("cpu")] * 2)
            raise AssertionError("a data axis of 1 over 2 processes")
        except ValueError as err:
            assert "multiple of the process count" in str(err), err
    bundle = trainer.fit_arrays(x[pid * half:(pid + 1) * half],
                                y[pid * half:(pid + 1) * half],
                                initial_bundle=load_bundle(init_dir))
    flat = {}

    def walk(node, path):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], path + (key,))
            else:
                flat["/".join(path + (key,))] = np.asarray(node[key])
    # the final state's statistics (the bundle's) and parameters
    walk({"stat": bundle.variables["batch_stats"],
          "param": bundle.variables["params"]}, ())
    np.savez(os.path.join(out_dir, f"{mode}{pid}.npz"),
             losses=np.asarray([h["loss"] for h in trainer.history]),
             steps=bundle.metadata["steps"],
             mesh_data=bundle.metadata["partition"]["mesh"]["data"], **flat)
    print(f"{mode} worker {pid} done", flush=True)


def make_tokens(n=16, seed=7):
    """Token rows and their next-token targets, process p holding rows
    [8p, 8p + 8)."""
    toks = np.random.default_rng(seed).integers(0, 32, (n, 12)).astype(
        np.int32)
    return toks, np.roll(toks, -1, axis=1)


def make_data(n=128, seed=0):
    """Deterministic two-blob data, identical in the test and the workers."""
    rng = np.random.default_rng(seed)
    half = n // 2
    x0 = rng.normal(loc=-2.0, size=(half, 4)).astype(np.float32)
    x1 = rng.normal(loc=+2.0, size=(n - half, 4)).astype(np.float32)
    x = np.concatenate([x0, x1])
    y = np.concatenate([np.zeros(half, np.int32), np.ones(n - half, np.int32)])
    return x, y


def main():
    if sys.argv[1] in ("bn", "seq"):
        bn_main(sys.argv[2], sys.argv[3], sys.argv[1])
        return
    out_dir, init_dir = sys.argv[1], sys.argv[2]
    import torch

    from mmlspark_tpu_torch import DataTable
    from mmlspark_tpu_torch.models import TPUModel
    from mmlspark_tpu_torch.models.bundle import load_bundle
    from mmlspark_tpu_torch.parallel import distributed
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_process_mesh
    from mmlspark_tpu_torch.train import Trainer, TrainerConfig

    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    pid = int(os.environ["MMLSPARK_TPU_PROCESS_ID"])
    nproc = int(os.environ["MMLSPARK_TPU_NUM_PROCESSES"])
    x, y = make_data()
    rows = len(x) // nproc
    x_local = x[pid * rows:(pid + 1) * rows]
    y_local = y[pid * rows:(pid + 1) * rows]

    ckpt_dir = os.path.join(out_dir, f"ckpt{pid}")
    trainer = Trainer(TrainerConfig(**FIT, mesh={"data": 8},
                                    checkpoint_dir=ckpt_dir,
                                    checkpoint_every_steps=2),
                      device="cpu")   # joins the process group
    assert distributed.process_count() == nproc
    assert trainer.mesh.process_count == nproc
    assert trainer.mesh.global_shape["data"] == 8 and trainer.data_size == 4
    bundle = trainer.fit_arrays(x_local, y_local,
                                initial_bundle=load_bundle(init_dir))

    # scoring: process 0 drops its last 3 rows (an uneven partition)
    x_score = x_local[:-3] if pid == 0 else x_local
    scorer = TPUModel(bundle, device="cpu", inputCol="features",
                      outputCol="scores", miniBatchSize=32)
    # no mesh set: the default is this process's own devices, scored
    # independently
    assert not scorer._mesh_is_multiprocess(scorer._mesh)
    local = scorer.transform(DataTable({"features": x_score}))["scores"]
    assert local.shape[0] == len(x_score), local.shape
    scorer_g = TPUModel(bundle, device="cpu", inputCol="features",
                        outputCol="scores", miniBatchSize=32).set_mesh(
        make_process_mesh(MeshSpec(), [cpu] * 4))
    # a mesh over both processes: checked, then the same local loop
    assert scorer_g._mesh_is_multiprocess(scorer_g._mesh)
    glob = scorer_g.transform(DataTable({"features": x_score}))["scores"]

    # unequal partitions (20 vs 12 rows): lockstep feeds 12 rows an epoch,
    # the rotation brings every local row in within 2 epochs
    n_uneq = 20 if pid == 0 else 12
    rng_u = np.random.default_rng(100 + pid)
    xu = rng_u.standard_normal((n_uneq, 4)).astype(np.float32)
    yu = rng_u.standard_normal((n_uneq, 1)).astype(np.float32)
    t2 = Trainer(TrainerConfig(
        architecture="LinearModel", model_config={"num_outputs": 1},
        optimizer="sgd", learning_rate=0.01, epochs=4, batch_size=8,
        loss="mse", seed=0, shuffle_each_epoch=False), device="cpu")
    t2.fit_arrays(xu, yu)
    rows_seen = int(t2._rows_seen.sum())

    # pipeline stages inside each process, the data axis across them
    toks, tgts = make_tokens()
    half = len(toks) // nproc
    pp_trainer = Trainer(TrainerConfig(**PP_FIT), mesh=make_process_mesh(
        MeshSpec(data=2, model=2), [cpu] * 2))
    pp_bundle = pp_trainer.fit_arrays(toks[pid * half:(pid + 1) * half],
                                      tgts[pid * half:(pid + 1) * half])

    # the restore: only the coordinator has a file; process 1 gets it by
    # broadcast
    state = trainer.init_state((1,) + x_local.shape[1:], 1)
    restored = trainer.restore_checkpoint(state, ckpt_dir)
    restored_kernel = trainer.state_tree(restored)["params"]["dense0"][
        "kernel"]
    health = distributed.health_check(timeout_s=30)

    # a barrier process 1 withholds: process 0 raises naming the op
    flag = os.path.join(out_dir, "withheld.done")
    timeout_op, waited = "", 0.0
    if pid == 0:
        t0 = time.monotonic()
        try:
            distributed.barrier("withheld", timeout_s=WITHHELD_TIMEOUT_S)
        except distributed.CollectiveTimeoutError as err:
            timeout_op, waited = err.op, time.monotonic() - t0
        open(flag, "w").close()
    else:
        # stay alive (and out of the barrier) until process 0 gave up
        deadline = time.monotonic() + 60
        while not os.path.exists(flag) and time.monotonic() < deadline:
            time.sleep(0.05)

    np.savez(
        os.path.join(out_dir, f"result{pid}.npz"),
        kernel=np.asarray(bundle.variables["params"]["dense0"]["kernel"]),
        losses=np.asarray([h["loss"] for h in trainer.history]),
        steps=bundle.metadata["steps"],
        restored_step=int(restored.step),
        restored_kernel=np.asarray(restored_kernel),
        scores=np.asarray(local), scores_global=np.asarray(glob),
        uneq_rows_seen=rows_seen, uneq_rows_total=n_uneq,
        health=np.asarray(health), timeout_op=np.asarray(timeout_op),
        waited=waited,
        pp_losses=np.asarray([h["loss"] for h in pp_trainer.history]),
        pp_head=np.asarray(pp_bundle.variables["params"]["lm_head"][
            "kernel"]))
    print(f"worker {pid} done", flush=True)
    # process 0's timed-out barrier still waits on a daemon thread: leave
    # without tearing the process group down
    os._exit(0)


if __name__ == "__main__":
    main()
