"""The port's data-parallel mesh layer on the CPU, against the JAX package
where both have the function: `MeshSpec`, the MMLSPARK_TPU_MESH_* knobs
and `default_mesh` / `best_mesh` / `mesh_spec_from_config`, the bridge's
placements after tests/test_parallel.py's cases (slabs of host shards
`[torch.device("cpu")] * n` against the JAX package's shards on
`jax.devices()[:n]`), the gradient reduce, the shard runner's lockstep
sums, the checkpoints of a data-parallel fit (metadata, restores across
data widths and across the packages byte for byte, a preempted dp = 2
fit resumed at dp = 1, the saved-batch `ValueError`), and the
seq-parallel step's token-wise layers on each shard's own slab (forward
hooks).  No JAX Trainer compiles here: the parity of trained values is
tests/test_torch_dp_train.py's.
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.parallel import bridge as jax_bridge
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import DataTable, Trainer, TrainerConfig, config
from mmlspark_tpu_torch.models.definitions import (Dense, LayerNorm,
                                                   TransformerLM,
                                                   init_transformer_lm_params)
from mmlspark_tpu_torch.models.bundle import params_from_jax
from mmlspark_tpu_torch.parallel import bridge
from mmlspark_tpu_torch.parallel.mesh import (MeshSpec, batch_devices,
                                              best_mesh, default_mesh,
                                              distinct_devices, make_mesh,
                                              mesh_spec_from_config)
from mmlspark_tpu_torch.parallel.ring import (ShardGroup,
                                              make_seq_parallel_lm_step,
                                              reduce_to_home, shard_tokens)
from mmlspark_tpu_torch.resilience.chaos import reset_chaos
from mmlspark_tpu_torch.resilience.checkpoints import (checkpoint_meta,
                                                       latest_valid_checkpoint)
from mmlspark_tpu_torch.resilience.ckpt_writer import serialize_tree
from mmlspark_tpu_torch.resilience.preemption import Preempted
from mmlspark_tpu_torch.train.optim import Optimizer

CPU = torch.device("cpu")


def host_mesh(n, **spec):
    return make_mesh(MeshSpec(data=n, **spec), [CPU] * n)


# ---------------------------------------------------------------- meshes ---

def test_mesh_spec_resolution_matches_the_jax_package():
    for spec, n in ((dict(), 8), (dict(data=-1, model=2), 8),
                    (dict(data=2, model=2, seq=2), 8), (dict(data=4), 4)):
        assert MeshSpec(**spec).resolve(n) == JaxMeshSpec(**spec).resolve(n)
    for spec in (dict(data=3), dict(data=-1, model=3)):
        with pytest.raises(ValueError):
            MeshSpec(**spec).resolve(8)
        with pytest.raises(ValueError):
            JaxMeshSpec(**spec).resolve(8)


@pytest.mark.parametrize("knobs,shape", [
    ({}, {"data": 1, "model": 1, "seq": 1}),
    ({"MMLSPARK_TPU_MESH_DATA": 4}, {"data": 4, "model": 1, "seq": 1}),
    ({"MMLSPARK_TPU_MESH_DATA": 2, "MMLSPARK_TPU_MESH_SEQ": 2},
     {"data": 2, "model": 1, "seq": 2}),
    ({"MMLSPARK_TPU_MESH_DATA": 2, "MMLSPARK_TPU_MESH_MODEL": 2},
     {"data": 2, "model": 2, "seq": 1}),
])
def test_default_mesh_under_the_three_knobs(knobs, shape):
    """The knobs carry the JAX package's names, defaults and docs; with
    them at their defaults the host's default mesh is one shard, else
    the dp x mp x seq mesh they declare over `[cpu] * n`."""
    try:
        for name, value in knobs.items():
            config.set(name, value)
        assert mesh_spec_from_config() == MeshSpec(
            data=knobs.get("MMLSPARK_TPU_MESH_DATA", -1),
            model=knobs.get("MMLSPARK_TPU_MESH_MODEL", 1),
            seq=knobs.get("MMLSPARK_TPU_MESH_SEQ", 1))
        mesh = default_mesh("cpu")
        assert mesh.shape == shape
        assert set(mesh.devices.flat) == {CPU}
    finally:
        for name in knobs:
            config.set(name, None)
    described = {v["name"]: v for v in config.describe()}
    from mmlspark_tpu import config as jax_config
    jax_described = {v["name"]: v for v in jax_config.describe()}
    for axis in ("DATA", "MODEL", "SEQ"):
        name = f"MMLSPARK_TPU_MESH_{axis}"
        assert described[name]["default"] == jax_described[name]["default"]
        assert described[name]["doc"] == jax_described[name]["doc"]


def test_best_mesh_and_placements():
    assert best_mesh(device="cpu").shape["data"] == 1
    mesh = best_mesh(4, device="cpu")
    assert mesh.shape == {"data": 4, "model": 1, "seq": 1}
    assert batch_devices(mesh) == [CPU] * 4
    assert distinct_devices(batch_devices(mesh)) == [CPU]
    with pytest.raises(ValueError, match="one type"):
        make_mesh(MeshSpec(data=2), [CPU, torch.device("meta")])


def test_shard_batch_layout_matches_the_jax_shards():
    """tests/test_parallel.py's layout case: 16 rows over 8 shards hold 2
    rows each, in row order, as the JAX package's addressable shards."""
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    slabs = bridge.shard_batch(x, host_mesh(8))
    ref = jax_bridge.shard_batch(x, jax_make_mesh(JaxMeshSpec(data=8)))
    assert [tuple(s.shape) for s in slabs] == [
        tuple(s.data.shape) for s in ref.addressable_shards]
    for got, want in zip(slabs, sorted(ref.addressable_shards,
                                       key=lambda s: s.index[0].start)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(
        bridge.gather_to_host(slabs, host_mesh(8)), x)


def test_shard_table_columns_pads_and_trims_as_the_jax_bridge():
    cols = {"x": np.arange(10, dtype=np.float32).reshape(10, 1),
            "s": [str(i) for i in range(10)]}
    slabs, valid = bridge.shard_table_columns(DataTable(cols), ["x"],
                                              host_mesh(8))
    ref, ref_valid = jax_bridge.shard_table_columns(
        JaxDataTable(cols), ["x"], jax_make_mesh(JaxMeshSpec(data=8)))
    assert valid == ref_valid == 10
    joined = bridge.gather_to_host(slabs["x"], host_mesh(8))
    assert joined.shape == tuple(ref["x"].shape) == (16, 1)
    np.testing.assert_array_equal(joined, np.asarray(ref["x"]))
    with pytest.raises(TypeError):
        bridge.shard_table_columns(DataTable(cols), ["s"], host_mesh(8))


def test_put_batch_parts_and_trees():
    mesh = host_mesh(2)
    tok, live = bridge.put_batch_parts(mesh, np.arange(8).reshape(4, 2),
                                       np.ones(4, bool))
    assert [t.shape[0] for t in tok] == [2, 2] and live[1].dtype == torch.bool
    with pytest.raises(ValueError, match="pad rows first"):
        bridge.put_batch_parts(mesh, np.zeros((3, 2)))
    tree = {"w": np.ones((2, 2), np.float32), "parts": tok}
    placed = bridge.put_tree(tree, CPU)
    snap = bridge.snapshot_tree(placed)
    placed["w"].add_(1.0)
    assert float(snap["w"].sum()) == 4.0
    assert torch.equal(bridge.gather_replicated(snap, mesh)["parts"],
                       torch.arange(8).reshape(4, 2))


def test_reduce_to_home_sums_in_shard_order_and_psums_in_lockstep():
    parts = [torch.full((3,), float(i + 1)) for i in range(4)]
    assert torch.equal(reduce_to_home(parts), torch.full((3,), 10.0))
    group = ShardGroup(3)
    xs = [torch.tensor([float(i)], requires_grad=True) for i in range(3)]

    def body(i):
        from mmlspark_tpu_torch.parallel.ring import active_data_shard
        shard = active_data_shard()
        assert (shard.index, shard.count) == (i, 3)
        [total] = shard.group.all_sum(i, [xs[i] * (i + 1)])
        return total * (i + 1)

    outs = group.run(body, lockstep=True)
    assert [o.item() for o in outs] == [8.0, 16.0, 24.0]
    torch.stack(outs).sum().backward()
    # d/dx_j sum_i (i+1) * S with S = sum_j (j+1) x_j: 6 * (j+1)
    assert [float(x.grad) for x in xs] == [6.0, 12.0, 18.0]
    with pytest.raises(RuntimeError, match="lockstep"):
        group.run(lambda i: group.all_sum(i, [xs[i]]))
    with pytest.raises(ZeroDivisionError):
        group.run(lambda i: 1 // (i - 1), lockstep=True)


# ----------------------------------------------------------- the Trainer ---

def blobs(n=128, seed=0):
    """tests/test_train.py's two Gaussian blobs."""
    rng = np.random.default_rng(seed)
    half = n // 2
    x = np.concatenate([rng.normal(-2.0, size=(half, 4)),
                        rng.normal(2.0, size=(n - half, 4))]).astype(
        np.float32)
    y = np.concatenate([np.zeros(half, np.int32), np.ones(n - half,
                                                           np.int32)])
    perm = rng.permutation(n)
    return x[perm], y[perm]


def mlp_config(**kw):
    return {**dict(architecture="MLPClassifier",
                   model_config={"hidden_sizes": [16], "num_classes": 2,
                                 "dtype": "float32"},
                   optimizer="momentum", learning_rate=0.05, epochs=2,
                   batch_size=64, loss="softmax_xent", seed=0,
                   shuffle_each_epoch=False, numerics_cadence=0), **kw}


def port_fit(dp, ckpt, **kw):
    trainer = Trainer(TrainerConfig(**mlp_config(**kw)),
                      mesh=host_mesh(dp) if dp > 1 else None, device="cpu")
    return trainer, trainer.fit_arrays(*blobs(), ckpt_dir=ckpt)


def jax_fit(dp, ckpt, **kw):
    mesh = jax_make_mesh(JaxMeshSpec(data=dp), jax.devices()[:dp])
    trainer = JaxTrainer(JaxTrainerConfig(**mlp_config(**kw)), mesh=mesh)
    return trainer, trainer.fit_arrays(*blobs(), ckpt_dir=ckpt)


def test_mesh_options_and_refusals():
    """A `TrainerConfig.mesh` with data 2 trains over host shards, one
    with a model axis over a (data, model) mesh; pipeline stages over a
    scoring architecture raise the JAX Trainer's ValueError; a seq axis
    replicates the batch (one data shard at seq index 0), and a
    sequence-sharded model raises ValueError naming
    `make_seq_parallel_lm_step` (tests/test_torch_seq_axis_train.py
    holds the fits)."""
    cfg = TrainerConfig(**{**mlp_config(), "mesh": {"data": 2}})
    assert Trainer(cfg, device="cpu").data_size == 2
    cfg = TrainerConfig(**{**mlp_config(), "mesh": {"data": 1, "model": 2}})
    trainer = Trainer(cfg, device="cpu")
    assert (trainer.data_size, trainer.model_size) == (1, 2)
    assert Trainer(TrainerConfig(**mlp_config()), mesh=make_mesh(
        MeshSpec(data=1, model=2), [CPU] * 2)).model_size == 2
    with pytest.raises(ValueError, match="TransformerLM"):
        Trainer(TrainerConfig(**{**mlp_config(), "pipeline_stages": 2}),
                device="cpu")
    trainer = Trainer(TrainerConfig(**mlp_config()),
                      mesh=make_mesh(MeshSpec(data=1, seq=2), [CPU] * 2))
    assert (trainer.data_size, trainer.model_size) == (1, 1)
    assert trainer.mesh.shape["seq"] == 2 and trainer.shard_devices == [CPU]
    ring = {"vocab_size": 32, "d_model": 16, "n_heads": 2, "n_layers": 1,
            "max_len": 8, "dtype": "float32", "attn_impl": "ring_flash",
            "seq_axis": "seq"}
    with pytest.raises(ValueError, match="make_seq_parallel_lm_step"):
        Trainer(TrainerConfig(architecture="TransformerLM",
                              model_config=ring),
                mesh=make_mesh(MeshSpec(data=1, seq=2), [CPU] * 2))


def payload(ckpt):
    """The bytes of the newest valid checkpoint in `ckpt`."""
    with open(latest_valid_checkpoint(ckpt), "rb") as f:
        return f.read()


def restored_bytes(trainer, ckpt, shape=(1, 4)):
    state = trainer.init_state(shape, total_steps=1)
    state = trainer.restore_checkpoint(state, ckpt)
    return serialize_tree(trainer.state_tree(state)), state


def test_dp_checkpoints_record_the_topology_as_the_jax_trainer(tmp_path):
    """dp = 2: the sidecar's data_devices and the bundle's partition mesh
    as the JAX Trainer writes them at dp = 2."""
    trainer, bundle = port_fit(2, str(tmp_path / "port"))
    jtrainer, jbundle = jax_fit(2, str(tmp_path / "jax"))
    meta = checkpoint_meta(latest_valid_checkpoint(str(tmp_path / "port")))
    jmeta = checkpoint_meta(latest_valid_checkpoint(str(tmp_path / "jax")))
    for key in ("data_devices", "model_devices", "effective_batch_size",
                "step"):
        assert meta[key] == jmeta[key], key
    assert meta["data_devices"] == 2
    assert bundle.metadata == jbundle.metadata
    assert bundle.metadata["partition"]["mesh"] == {"data": 2, "model": 1}


@pytest.mark.parametrize("save_dp,restore_dp", [(2, 1), (1, 2)])
def test_elastic_restore_is_byte_identical_within_the_port(
        tmp_path, save_dp, restore_dp):
    """tests/test_train.py's elastic case: a checkpoint saved at dp = N
    restores at dp = M with the state tree byte-equal to the file's, the
    replicas of every shard equal to the masters."""
    ckpt = str(tmp_path / "ckpt")
    _, saved = port_fit(save_dp, ckpt)
    raw = payload(ckpt)
    trainer = Trainer(TrainerConfig(**mlp_config()),
                      mesh=host_mesh(restore_dp) if restore_dp > 1 else None,
                      device="cpu")
    got, state = restored_bytes(trainer, ckpt)
    assert got == raw
    assert state.step == saved.metadata["steps"] == 4
    if restore_dp > 1:
        for leaves in trainer._replicas.leaves:
            assert all(torch.equal(a, b)
                       for a, b in zip(leaves, state.params))


@pytest.mark.parametrize("port_dp,jax_dp", [(2, 1), (1, 2)])
def test_restores_across_the_packages_and_widths(tmp_path, port_dp, jax_dp):
    """A port checkpoint at one data width restores in the JAX Trainer at
    the other (which writes it back byte for byte), and the JAX
    Trainer's restores in the port at the other width (its state tree
    serializes to the file's bytes)."""
    port_ckpt, jax_ckpt = str(tmp_path / "port"), str(tmp_path / "jax")
    port_fit(port_dp, port_ckpt)
    jax_fit(port_dp, jax_ckpt)
    jmesh = jax_make_mesh(JaxMeshSpec(data=jax_dp), jax.devices()[:jax_dp])
    jtrainer = JaxTrainer(JaxTrainerConfig(**mlp_config()), mesh=jmesh)
    jstate = jtrainer.restore_checkpoint(
        jtrainer.init_state((1, 4), total_steps=1), port_ckpt)
    jtrainer.save_checkpoint(jstate, str(tmp_path / "again"), sync=True)
    jtrainer._close_writers()
    assert payload(str(tmp_path / "again")) == payload(port_ckpt)
    trainer = Trainer(TrainerConfig(**mlp_config()),
                      mesh=host_mesh(jax_dp) if jax_dp > 1 else None,
                      device="cpu")
    got, _ = restored_bytes(trainer, jax_ckpt)
    assert got == payload(jax_ckpt)


def test_preempted_dp2_fit_resumes_at_dp1(tmp_path):
    """tests/test_train.py:290: preempt at step 5 under dp = 2, resume
    under dp = 1 from the checkpoint: the fault-free step count (2 steps
    an epoch x 4 epochs) and the fault-free run's weights."""
    ckpt = str(tmp_path / "ckpt")
    kw = dict(epochs=4, checkpoint_every_steps=1)
    config.set("MMLSPARK_TPU_CHAOS_PREEMPT_AT_STEP", 5)
    reset_chaos()
    try:
        with pytest.raises(Preempted):
            port_fit(2, ckpt, **kw)
    finally:
        config.set("MMLSPARK_TPU_CHAOS_PREEMPT_AT_STEP", None)
        reset_chaos()
    resumed = Trainer(TrainerConfig(**mlp_config(**kw)),
                      device="cpu").fit_arrays(*blobs(), ckpt_dir=ckpt,
                                               resume=True)
    assert resumed.metadata["steps"] == 8
    _, clean = port_fit(2, None, **kw)
    for got, ref in zip(jax.tree_util.tree_leaves(resumed.variables),
                        jax.tree_util.tree_leaves(clean.variables)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=0, atol=1e-6)


def test_saved_batch_that_does_not_divide_raises(tmp_path):
    """The JAX Trainer's elastic ValueError: a checkpoint whose effective
    batch (63 rows, dp = 1) does not divide into a data axis of 2."""
    ckpt = str(tmp_path / "ckpt")
    port_fit(1, ckpt, **{"batch_size": 63})
    meta = checkpoint_meta(latest_valid_checkpoint(ckpt))
    assert meta["effective_batch_size"] == 63
    trainer = Trainer(TrainerConfig(**mlp_config(batch_size=64)),
                      mesh=host_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="does not divide into the new "
                                         "data-axis unit 2"):
        trainer.fit_arrays(*blobs(), ckpt_dir=ckpt, resume=True)


# --------------------------------------- step 0: the seq-parallel step ---

LM = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=2, max_len=32,
          dtype="float32")


@pytest.mark.parametrize("data,seq", [(2, 2), (1, 4)])
def test_seq_step_runs_each_shards_token_wise_layers_on_its_slab(data, seq):
    """Forward hooks on every Dense and LayerNorm of the module (the
    replicas share them): each call of the seq-parallel step sees one
    (B/data, S/seq, .) slab on the device of the shard it belongs to,
    every shard once per layer; the step equals the whole-array forward's
    loss (the old layout) to f32 rounding."""
    module = TransformerLM(**LM, attn_impl="ring_flash", seq_axis="seq",
                           device="cpu")
    module.load_state_dict(params_from_jax(
        init_transformer_lm_params(LM, seed=0)["params"]))
    mesh = make_mesh(MeshSpec(data=data, model=1, seq=seq),
                     [CPU] * (data * seq))
    b, s = 4, LM["max_len"]
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: seen.append(
            (name, tuple(args[0].shape), args[0].device)))
        for name, m in module.named_modules()
        if isinstance(m, (Dense, LayerNorm))]
    rng = np.random.default_rng(3)
    rows = rng.integers(0, LM["vocab_size"], (b, s + 1))
    mask = np.ones((b, s), np.float32)
    tokens, targets, masks = (shard_tokens(a, mesh) for a in (
        rows[:, :-1], rows[:, 1:], mask))
    assert [tuple(t.shape) for t in tokens] == [(b // data, s // seq)] * (
        data * seq)
    tx = Optimizer(TrainerConfig(optimizer="adam", learning_rate=1e-2), 1)
    params = list(module.parameters())
    step = make_seq_parallel_lm_step(module, tx, mesh)
    with torch.no_grad():
        from mmlspark_tpu_torch.parallel.ring import use_seq_mesh
        from mmlspark_tpu_torch.train.trainer import make_loss
        with use_seq_mesh(mesh):
            whole = make_loss("softmax_xent")(
                module(torch.from_numpy(rows[:, :-1])),
                torch.from_numpy(rows[:, 1:]), torch.ones(b))
    seen.clear()
    _, _, loss = step(params, tx.init(params), tokens, targets, masks)
    for hook in hooks:
        hook.remove()
    n_calls = 2 + LM["n_layers"] * 6     # final norm, head; 4 Dense + 2 norms
    assert len(seen) == n_calls * data * seq
    assert {shape[:2] for _, shape, _ in seen} == {(b // data, s // seq)}
    assert {dev for _, _, dev in seen} == {CPU}
    np.testing.assert_allclose(float(loss), float(whole), rtol=1e-6)
