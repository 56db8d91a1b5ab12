"""Training the vision and tabular models in the port against the JAX
package, on the CPU: BatchNorm's training forward and its statistics
against flax's, the optimizer state of a ConvNet and a ResNet crossing
both ways, `Trainer.fit_arrays` for the ConvNet and the basic ResNet
(tests/test_torch_scoring_train.py holds the MLP, the linear model and
the bottleneck ResNets with this file's cases and checks), ResNet
checkpoints crossing the packages byte for byte, a preempted ResNet fit
resumed at another prefetch depth, and the recovery supervisor over a
ConvNet fit.

Both Trainers get the same inputs (seeded numpy) and the same
`initial_bundle` (the port's seeded init); the JAX Trainer runs on a
one-device mesh, all its fits jitted once, on two threads, in a module
fixture.  Tolerances (f32): history loss and grad_norm rel 1e-5, final
params and batch_stats atol 1e-5.  The ResNet inputs are images scaled
to [0, 1): at uint8 scale the stem's running variance is ~1e4, where one
f32 ulp is ~1e-3.  The ConvNet trains on uint8 images as they are.

Two bottleneck ResNets: two identity blocks under Adam, and one block
with a projection under SGD-momentum.  With a projection after the stem,
every path from the stem runs through a 1x1 conv into a training
BatchNorm, which removes a constant shift of its input, so each stem
BatchNorm bias channel whose ReLU is active at every position has a zero
true gradient (measured: 2 of 64 channels at round-off, ~1e-9).  Adam
scales the f32 round-off both packages feed it there to lr-sized steps
of either sign (1.9e-3 apart after 6 steps), and the gap spreads to the
layers below (3e-5); momentum keeps round-off at round-off.  Identity
blocks carry the shift to the pool, so no leaf of that model has a zero
true gradient.  The same amplification separates the packages by ~1e-3
when a basic ResNet's first block is 16 or 64 wide; the basic case here
projects the stem's 64 channels to 8.
"""

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import serialization

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
from mmlspark_tpu_torch.models.definitions import BatchNorm
from mmlspark_tpu_torch.resilience import checkpoints as port_ckpt
from mmlspark_tpu_torch.resilience.chaos import (ChaosInjector, Fault,
                                                 reset_chaos, set_injector)
from mmlspark_tpu_torch.resilience.ckpt_writer import serialize_tree
from mmlspark_tpu_torch.resilience.preemption import Preempted
from mmlspark_tpu_torch.train import RecoveryPolicy, RecoverySupervisor
from mmlspark_tpu_torch.train.optim import (opt_state_from_jax,
                                            opt_state_to_jax)

N_ROWS, BATCH = 20, 8     # a partial last batch: 4 rows of pad each epoch
RESNET = {"stage_sizes": [1, 1], "widths": [8, 8], "num_classes": 4,
          "block_kind": "basic", "dtype": "float32"}
# name: (architecture, model config, optimizer settings, loss, input)
CASES = {
    "mlp_momentum": ("MLPClassifier", {"hidden_sizes": [16, 8],
                                       "num_classes": 3, "dtype": "float32"},
                     dict(optimizer="momentum", learning_rate=0.05),
                     "softmax_xent", "table"),
    "linear_mse": ("LinearModel", {"num_outputs": 1, "dtype": "float32"},
                   dict(optimizer="sgd", learning_rate=0.05), "mse",
                   "table"),
    "linear_sigmoid": ("LinearModel", {"num_outputs": 1, "dtype": "float32"},
                       dict(optimizer="adam", learning_rate=1e-2),
                       "sigmoid_xent", "table"),
    "convnet": ("ConvNetCIFAR10", {"num_classes": 5, "widths": [4, 8, 8],
                                   "dense_width": 16, "dtype": "float32"},
                dict(optimizer="adam", learning_rate=1e-3,
                     lr_schedule="cosine", gradient_clip_norm=1.0),
                "softmax_xent", "uint8"),
    "resnet_basic": ("ResNet", RESNET,
                     dict(optimizer="adam", learning_rate=1e-3),
                     "softmax_xent", "unit"),
    "resnet_bottleneck": ("ResNet", {"stage_sizes": [2], "widths": [16],
                                     "num_classes": 4,
                                     "block_kind": "bottleneck",
                                     "dtype": "float32"},
                          dict(optimizer="adam", learning_rate=1e-3),
                          "softmax_xent", "unit"),
    "resnet_bottleneck_projection": ("ResNet", {
        "stage_sizes": [1], "widths": [4], "num_classes": 4,
        "block_kind": "bottleneck", "dtype": "float32"},
        dict(optimizer="momentum", learning_rate=1e-2),
        "softmax_xent", "unit"),
}


def data(name: str):
    arch, mc, _, loss, kind = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if kind == "table":
        x = rng.standard_normal((N_ROWS, 6)).astype(np.float32)
    else:
        x = rng.integers(0, 256, (N_ROWS, 16, 16, 3)).astype(np.uint8)
        if kind == "unit":
            x = (x / np.float32(255)).astype(np.float32)
    if loss == "softmax_xent":
        y = rng.integers(0, mc["num_classes"], N_ROWS).astype(np.int32)
    elif loss == "mse":
        y = rng.standard_normal(N_ROWS)           # float64, as users pass
    else:
        y = rng.integers(0, 2, N_ROWS).astype(np.float32)
    return x, y


def fit_config(name: str, **kw) -> dict:
    arch, mc, opt, loss, _ = CASES[name]
    return dict(architecture=arch, model_config=dict(mc), loss=loss,
                batch_size=BATCH, epochs=2, seed=3, shuffle_each_epoch=True,
                numerics_cadence=0, **opt, **kw)


def initial(name: str) -> ModelBundle:
    arch, mc, *_ = CASES[name]
    x, _ = data(name)
    return ModelBundle.init(arch, mc, seed=1, input_shape=(1,) + x.shape[1:])


def one_device_mesh():
    return make_mesh(JaxMeshSpec(data=1), devices=jax.devices()[:1])


CKPT = dict(checkpoint_every_steps=2)
# the cases this file fits; tests/test_torch_scoring_train.py fits the rest
HERE = ("convnet", "resnet_basic")


def fit_both(names, root) -> dict:
    """Each case fitted by both Trainers from the same initial bundle, the
    JAX fits jitted on threads; the basic ResNet's fits checkpoint every
    2 steps (6 steps in all) under `root`."""
    def jax_fit(name):
        x, y = data(name)
        init = initial(name)
        kw = CKPT if name == "resnet_basic" else {}
        trainer = JaxTrainer(JaxTrainerConfig(**fit_config(name, **kw)),
                             mesh=one_device_mesh())
        bundle = trainer.fit_arrays(
            x, y, ckpt_dir=str(root / f"jax_{name}") if kw else None,
            initial_bundle=JaxModelBundle(init.architecture, init.config,
                                          init.variables))
        return trainer, bundle

    with ThreadPoolExecutor(2) as pool:
        jax_runs = dict(zip(names, pool.map(jax_fit, names)))
    out = {}
    for name in names:
        x, y = data(name)
        kw = CKPT if name == "resnet_basic" else {}
        port = Trainer(TrainerConfig(**fit_config(name, **kw)),
                       device="cpu")
        bundle = port.fit_arrays(
            x, y, ckpt_dir=str(root / f"port_{name}") if kw else None,
            initial_bundle=initial(name))
        out[name] = (*jax_runs[name], port, bundle)
    return out


def check_fit(name: str, fitted: tuple) -> None:
    """20 rows at batch 8, shuffled, 2 epochs (6 steps): the history, the
    final params and batch_stats (every statistic moved), the metadata
    and the config equal the JAX Trainer's."""
    jax_trainer, jax_bundle, port, bundle = fitted
    assert len(port.history) == len(jax_trainer.history) == 2
    for got, ref in zip(port.history, jax_trainer.history):
        assert got["epoch"] == ref["epoch"]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
    assert bundle.metadata == jax_bundle.metadata
    assert bundle.metadata["steps"] == 6
    assert bundle.config == jax_bundle.config
    ref_leaves = jax.tree_util.tree_leaves_with_path(jax_bundle.variables)
    got_leaves = jax.tree_util.tree_leaves_with_path(bundle.variables)
    assert [p for p, _ in ref_leaves] == [p for p, _ in got_leaves]
    has_bn = "batch_stats" in jax_bundle.variables
    assert has_bn == (CASES[name][0] == "ResNet")
    for (_, ref), (_, got) in zip(ref_leaves, got_leaves):
        ref, got = np.asarray(ref), np.asarray(got)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if has_bn:
        moved = [not np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(initial(name).variables["batch_stats"]),
            jax.tree_util.tree_leaves(bundle.variables["batch_stats"]))]
        assert all(moved)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("vision_fits")
    return {**fit_both(HERE, root), "root": root}


# ------------------------------------------------------------ BatchNorm ---

@pytest.mark.parametrize("dtype,out_rtol", [("float32", 1e-6),
                                            ("bfloat16", 2 ** -8)])
def test_batchnorm_training_matches_flax(dtype, out_rtol):
    """The training forward and the updated statistics against flax's
    `BatchNorm(use_running_average=False)` with `mutable=["batch_stats"]`
    from the same statistics: the output within rel `out_rtol` of its max
    (f32 1e-6; bf16 one rounding of the output, 2^-8), the statistics rel
    1e-6 at both dtypes (f32 in both packages)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((6, 5, 7, 8)) * 3 + 1).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
              "bias": rng.normal(0, 0.1, 8).astype(np.float32)}
    stats = {"mean": rng.normal(0, 1, 8).astype(np.float32),
             "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    jdt = jnp.dtype(dtype)
    y_ref, mut = nn.BatchNorm(use_running_average=False, dtype=jdt).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x).astype(jdt),
        mutable=["batch_stats"])
    bn = BatchNorm(8, dtype=getattr(torch, dtype), device="cpu")
    bn.load_state_dict({k: torch.from_numpy(v)
                        for k, v in {**params, **stats}.items()})
    got = bn.train()(torch.from_numpy(x).to(getattr(torch, dtype))
                     .permute(0, 3, 1, 2))
    assert got.dtype == getattr(torch, dtype)
    got = got.detach().float().permute(0, 2, 3, 1).numpy()
    ref = np.asarray(y_ref.astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=out_rtol * np.abs(ref).max())
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, key).numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   rtol=1e-6)
    # eval mode normalizes with the buffers and leaves them alone
    before = bn.mean.clone()
    bn.eval()(torch.zeros(2, 8, 3, 3, dtype=getattr(torch, dtype)))
    assert torch.equal(bn.mean, before)


# ------------------------------------------------------ optimizer state ---

@pytest.mark.parametrize("name", ["convnet", "resnet_basic"])
def test_opt_state_of_conv_models_crosses_both_ways(fits, name):
    """optax's state after the JAX fit (Adam moments of conv kernels HWIO,
    BatchNorm scales and biases) -> the port's state -> optax's tree
    again: byte-equal in flax's format."""
    jax_trainer, _, port, _ = fits[name]
    raw = serialization.to_bytes(jax.device_get(
        jax_trainer._last_state.opt_state))
    tree = serialization.msgpack_restore(raw)
    state = opt_state_from_jax(tree, port._names)
    conv = [n for n, p in port.module.named_parameters() if p.dim() == 4]
    assert conv and all(state["mu"][port._names.index(n)].dim() == 4
                        for n in conv)
    assert serialize_tree(opt_state_to_jax(state, port._names)) == raw


# ---------------------------------------------------------- fit_arrays ---

@pytest.mark.parametrize("name", HERE)
def test_fit_matches_jax(fits, name):
    check_fit(name, fits[name])


def test_fit_trains_the_uint8_convnet_in_its_own_dtype(fits):
    """The ConvNet case feeds uint8 images: the module casts them on the
    device, as the JAX model does, and the loss falls."""
    assert data("convnet")[0].dtype == np.uint8
    _, _, port, _ = fits["convnet"]
    assert port.history[1]["loss"] < port.history[0]["loss"]
    table = port.training_metric_data()
    assert table.metric_type == "training" and table.num_rows == 2
    assert {"epoch", "loss", "wall_s", "grad_norm"} <= set(table.data)


# ---------------------------------------------------------- checkpoints ---

def files_of(path: str) -> list:
    out = []
    for suffix in ("", ".sha256", ".meta.json"):
        with open(path + suffix, "rb") as f:
            out.append(f.read())
    return out


def test_jax_resnet_checkpoint_round_trips_through_the_port(fits, tmp_path):
    """The port restores the JAX Trainer's newest ResNet checkpoint (params,
    Adam state, batch_stats) and writes it back: the payload and both
    sidecars equal the JAX files byte for byte."""
    root = fits["root"]
    newest = port_ckpt.latest_valid_checkpoint(str(root / "jax_resnet_basic"))
    assert os.path.basename(newest) == "ckpt_0000000006.msgpack"
    raw = files_of(newest)[0]
    port = Trainer(TrainerConfig(**fit_config("resnet_basic", **CKPT)),
                   device="cpu")
    state = port.init_state((1, 16, 16, 3), 6, initial("resnet_basic"))
    state = port.restore_checkpoint(state, str(root / "jax_resnet_basic"))
    assert state.step == 6 and len(state.batch_stats) == 2 * 7
    assert serialize_tree(port.state_tree(state)) == raw
    port._effective_batch_size = BATCH
    path = port.save_checkpoint(state, str(tmp_path), sync=True)
    port._close_writers()
    assert files_of(path) == files_of(newest)
    assert hashlib.sha256(raw).hexdigest() == files_of(path)[1].decode()


def test_port_resnet_checkpoint_round_trips_through_jax(fits, tmp_path):
    """The JAX Trainer restores the port's newest ResNet checkpoint: params
    and batch_stats equal the port's bundle exactly; written back by the
    JAX Trainer, the payload and both sidecars equal the port's files."""
    _, _, _, bundle = fits["resnet_basic"]
    d = str(fits["root"] / "port_resnet_basic")
    newest = port_ckpt.latest_valid_checkpoint(d)
    init = initial("resnet_basic")
    jt = JaxTrainer(JaxTrainerConfig(**fit_config("resnet_basic", **CKPT)),
                    mesh=one_device_mesh())
    state = jt.init_state((1, 16, 16, 3), 6, initial_bundle=JaxModelBundle(
        init.architecture, init.config, init.variables))
    state = jt.restore_checkpoint(state, d)
    assert int(state.step) == bundle.metadata["steps"] == 6
    restored = {"params": jax.device_get(state.params),
                "batch_stats": jax.device_get(state.batch_stats)}
    ref = jax.tree_util.tree_leaves_with_path(bundle.variables)
    got = jax.tree_util.tree_leaves_with_path(restored)
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (_, a), (_, b) in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    jt._effective_batch_size = BATCH
    path = jt.save_checkpoint(state, str(tmp_path), sync=True)
    jt._close_writers()
    assert files_of(path) == files_of(newest)


@pytest.mark.parametrize("preempt_depth,resume_depth",
                         [(2, -1), (-1, 0), (0, 2)])
def test_resumed_resnet_fit_is_bit_equal(fits, tmp_path, preempt_depth,
                                         resume_depth):
    """A SIGTERM at step 3 at one prefetch depth, resumed at another: the
    step count, params and batch_stats equal the fault-free fit's bit for
    bit (staged but unconsumed batches are dropped; the plan replays the
    same order at any depth)."""
    _, _, _, ref = fits["resnet_basic"]
    x, y = data("resnet_basic")
    ckpt = str(tmp_path / "ckpt")
    previous = set_injector(ChaosInjector(script=[Fault("sigterm", step=3)]))
    try:
        with pytest.raises(Preempted):
            Trainer(TrainerConfig(**fit_config(
                "resnet_basic", prefetch_depth=preempt_depth, **CKPT)),
                device="cpu").fit_arrays(x, y, ckpt_dir=ckpt, resume=True,
                                         initial_bundle=initial(
                                             "resnet_basic"))
    finally:
        set_injector(previous)
        reset_chaos()
    resumed = Trainer(TrainerConfig(**fit_config(
        "resnet_basic", prefetch_depth=resume_depth, **CKPT)),
        device="cpu").fit_arrays(x, y, ckpt_dir=ckpt, resume=True,
                                 initial_bundle=initial("resnet_basic"))
    assert resumed.metadata["steps"] == ref.metadata["steps"] == 6
    got = jax.tree_util.tree_leaves(resumed.variables)
    want = jax.tree_util.tree_leaves(ref.variables)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- recovery ---

def test_supervisor_recovers_a_convnet_fit_from_a_nan_step(tmp_path):
    """A NaN poisons step 3 of a ConvNet fit (a probe and a checkpoint
    every step): the supervisor rolls back, skips the window and finishes
    the configured steps with finite weights."""
    x, y = data("convnet")
    cfg = TrainerConfig(**{**fit_config("convnet"), "numerics_cadence": 1,
                           "halt_on_nonfinite": True,
                           "checkpoint_every_steps": 1})
    previous = set_injector(ChaosInjector(script=[Fault("nan", step=3)]))
    try:
        sup = RecoverySupervisor(cfg, RecoveryPolicy(max_recoveries=2),
                                 device="cpu")
        bundle = sup.fit_arrays(x, y, ckpt_dir=str(tmp_path))
    finally:
        set_injector(previous)
        reset_chaos()
    assert bundle.metadata["steps"] == 6
    assert all(np.isfinite(np.asarray(a)).all()
               for a in jax.tree_util.tree_leaves(bundle.variables))
    assert [e["event"] for e in sup.timeline] == \
        ["failure", "recover", "completed"]
    assert sup.timeline[0]["kind"] == "nonfinite"
    assert sup.timeline[1]["skip_window"] == [3, 3]
