"""The port's tensor-parallel Trainer against the JAX Trainer on a (data,
model) mesh of the same shape, on the CPU: the port's shards are host
shards `[torch.device("cpu")] * n`, the JAX Trainer's `jax.devices()[:n]`.

Cases (tests/test_torch_dp_train.py's data and fit settings: 20 rows at
batch 8, 2 epochs, 6 steps, f32): the MLP at (data 2, model 2) and (4,
2), the ConvNet (two of its conv kernels 16 wide) at (2, 2);
tests/test_torch_tp_resnet.py holds a basic ResNet with BatchNorm at (2,
2).  The
Trainer's fallback splits their wide kernels (and the ConvNet's conv
kernels) on the output channels, each shard computing its columns,
joined before the next layer (BatchNorm then sees every channel).
tests/test_torch_tp_lm.py holds the LM cases and
tests/test_torch_tp_checkpoint.py the checkpoints, with these helpers.  Both Trainers start from one
`initial_bundle` whose biases are all nonzero (a row-parallel bias added
once per shard instead of once would show).  Tolerances, those of the
data-parallel file: loss and grad_norm rel 1e-5, parameters and
`batch_stats` atol 1e-5 (the key third of each qkv bias left out: its
true gradient is zero and Adam scales round-off there).  The shard
shape of every leaf equals the JAX leaf's `sharding.shard_shape` at the
JAX Trainer's init (its `_param_sharding_rule` and the port's
`param_sharding_rule` place alike; qkv head-aligned, the same shapes).
The row-parallel sums run in model order, not XLA's all-reduce order, so
values agree to these tolerances, not bit for bit.  The JAX fits run jitted once each, on two threads, in a module
fixture.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.parallel.partition import flax_leaf
from test_torch_dp_train import CASES as DP_CASES
from test_torch_dp_train import data, leaves
from test_torch_dp_train import fit_config as dp_fit_config

# the ConvNet wider than the data-parallel file's, so that the fallback
# splits two of its conv kernels as well as its first Dense layer
CASES = {**DP_CASES, "convnet": (
    DP_CASES["convnet"][0], {**DP_CASES["convnet"][1],
                             "widths": [4, 16, 16]},
    *DP_CASES["convnet"][2:])}


def fit_config(name) -> dict:
    return {**dp_fit_config(name), "model_config": dict(CASES[name][1])}

RUNS = [("mlp", 2, 2), ("mlp", 4, 2), ("convnet", 2, 2)]
CPU = torch.device("cpu")


def host_mesh(dp, mp):
    return make_mesh(MeshSpec(data=dp, model=mp), [CPU] * (dp * mp))


def jax_mesh(dp, mp):
    return jax_make_mesh(JaxMeshSpec(data=dp, model=mp),
                         jax.devices()[:dp * mp])


def initial(name):
    """The seeded init of `name` with every bias (and norm shift) drawn
    nonzero."""
    arch, mc, *_ = CASES[name]
    x, _ = data(name)
    init = ModelBundle.init(arch, mc, seed=1,
                            input_shape=(1,) + x.shape[1:])
    rng = np.random.default_rng(7)

    def perturb(node, key=None):
        if isinstance(node, dict):
            return {k: perturb(v, k) for k, v in node.items()}
        if key == "bias":
            return (node + rng.normal(0, 0.1, node.shape)).astype(np.float32)
        return node
    variables = dict(init.variables)
    variables["params"] = perturb(init.variables["params"])
    return ModelBundle(init.architecture, init.config, variables,
                       dict(init.metadata))


def port_fit(name, dp, mp, **kw):
    trainer = Trainer(TrainerConfig(**{**fit_config(name), **kw}),
                      mesh=host_mesh(dp, mp))
    return trainer, trainer.fit_arrays(*data(name),
                                       initial_bundle=initial(name))


def jax_shard_shapes(params) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            tuple(leaf.sharding.shard_shape(leaf.shape))
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


def port_shard_shapes(trainer) -> dict:
    """{flax path: shard shape in the flax layout} of every parameter, as
    model index 0's replica of data row 0 holds it."""
    _, shards = trainer._replicas.rows[0]
    nodes: dict = {}
    for name, t in trainer.module.named_parameters():
        prefix, _, leaf = name.rpartition(".")
        nodes.setdefault(prefix, {})[leaf] = tuple(t.shape)
    out = {}
    for prefix, node in nodes.items():
        for leaf in node:
            path, shape, dims = flax_leaf(prefix, leaf, node)
            name = f"{prefix}.{leaf}"
            split = trainer.param_splits.get(name)
            shard = list(shape)
            if split is not None:
                flax_dim = dims.index(split[0])
                shard[flax_dim] = tuple(
                    shards[0].get_parameter(name).shape)[split[0]]
            out[path] = tuple(shard)
    return out


def jax_config(name) -> dict:
    """The JAX side's fit settings: the LM's attention dense (the same
    function as the port's flash plain version, at f32; the JAX flash
    kernel's interpret mode costs seconds a fit)."""
    cfg = fit_config(name)
    if name == "lm":
        cfg["model_config"] = {**cfg["model_config"], "attn_impl": "dense"}
    return cfg


def jax_fit(run):
    name, dp, mp = run
    init = initial(name)
    trainer = JaxTrainer(JaxTrainerConfig(**jax_config(name)),
                         mesh=jax_mesh(dp, mp))
    x, y = data(name)
    jax_init = JaxModelBundle(init.architecture, init.config, init.variables)
    bundle = trainer.fit_arrays(x, y, initial_bundle=jax_init)
    # the placement the rule gives (read at init: the jitted step may pick
    # its own output layout for a leaf the rule leaves replicated)
    state = trainer.init_state((1,) + x.shape[1:], 1, initial_bundle=jax_init,
                               input_dtype=x.dtype)
    return trainer.history, bundle, jax_shard_shapes(state.params)


def check_fit(name, dp, mp, jax_history, jax_bundle, jax_shapes) -> None:
    """The port's fit of `name` at (dp, mp) against the JAX Trainer's
    (module docstring)."""
    trainer, bundle = port_fit(name, dp, mp)
    assert (trainer.data_size, trainer.model_size) == (dp, mp)
    assert bundle.metadata == jax_bundle.metadata
    assert bundle.metadata["partition"]["mesh"] == {"data": dp, "model": mp}
    assert port_shard_shapes(trainer) == jax_shapes
    assert trainer.param_splits   # something is split over 'model'
    assert len(trainer.history) == len(jax_history)
    for got, ref in zip(trainer.history, jax_history):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-5)
    check_leaves(name, bundle.variables, jax_bundle.variables)
    assert ("batch_stats" in bundle.variables) == (name == "resnet")


def check_leaves(name, got_tree, want_tree, atol=1e-5) -> None:
    got, want = leaves(got_tree), leaves(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    d = CASES[name][1].get("d_model", 0)
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape
        if "qkv" in path and w.ndim == 1:
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=path)


@pytest.fixture(scope="module")
def jax_fits():
    with ThreadPoolExecutor(2) as pool:
        return dict(zip(RUNS, pool.map(jax_fit, RUNS)))


@pytest.mark.parametrize("name,dp,mp", RUNS)
def test_tensor_parallel_fit_matches_the_jax_trainer(jax_fits, name, dp,
                                                     mp):
    check_fit(name, dp, mp, *jax_fits[name, dp, mp])


def test_split_layers_compute_their_output_columns_per_shard():
    """The ConvNet's split conv and Dense layers run once per model shard
    on the shard's slice (forward hooks on the model index replicas see
    half the output channels), joined on the row's home."""
    trainer = Trainer(TrainerConfig(**fit_config("convnet")),
                      mesh=host_mesh(1, 2))
    x, _ = data("convnet")
    trainer.init_state((1,) + x.shape[1:], 1, initial_bundle=initial(
        "convnet"))
    home, shards = trainer._replicas.rows[0]
    assert set(trainer.param_splits) == {
        "conv2_w.weight", "conv3_w.weight", "dense1_w.weight"}
    # replicas share their module's hooks: the hook tells them apart by
    # the module it is called with
    index = {id(rep.conv2_w): m for m, rep in enumerate(shards)}
    seen = []
    handle = trainer.module.conv2_w.register_forward_hook(
        lambda mod, args, out: seen.append((index.get(id(mod)),
                                            out.shape[1])))
    with torch.no_grad():
        z, nodes = home(torch.as_tensor(x[:2]))
    handle.remove()
    width = CASES["convnet"][1]["widths"][1]
    # each model index's slice, then the home's call joining them
    assert seen == [(0, width // 2), (1, width // 2), (None, width)]
    assert nodes["conv2"].shape[-1] == width and z.shape == (2, 5)
