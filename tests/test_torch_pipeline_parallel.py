"""The port's GPipe schedule (`mmlspark_tpu_torch/parallel/pipeline.py`)
against the JAX package's (`mmlspark_tpu/parallel/pipeline.py`) at the
JAX test's CFG (vocab 32, d 16, 4 heads, 4 layers, max_len 12) over a
(2, 4) mesh: the JAX side on `jax.devices()[:8]`, the port's on
`[cpu] * 8`.  The JAX init is carried across (`params_from_jax`), since
the port's init is its own seeded numpy draw.  Every JAX reference is
computed once, jitted, in a module fixture."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel import pipeline as jpp
from mmlspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmlspark_tpu_torch.models.bundle import params_from_jax, params_to_jax
from mmlspark_tpu_torch.models.definitions import init_transformer_lm_params
from mmlspark_tpu_torch.parallel import pipeline as pp
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.parallel.partition import ModelShards

CFG = dict(vocab_size=32, d_model=16, n_heads=4, n_layers=4, max_len=12)
CPU = torch.device("cpu")
MICRO = (1, 2, 4)


def jax_tree(seed, **cfg):
    # jitted: flax's eager init costs seconds
    return jax.device_get(jax.jit(lambda k: jpp.init_pipelined_lm(
        k, **cfg))(jax.random.key(seed)))


def loss_of(logits, targets):
    lp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.take_along_axis(lp, targets[..., None], -1).mean()


@pytest.fixture(scope="module")
def ref():
    """The JAX side: the forward at each microbatch count, the bf16
    forward, and `jax.grad` of the sequential loss (no shard_map)."""
    mesh = jmake_mesh(JMeshSpec(data=2, model=4), jax.devices()[:8])
    with ThreadPoolExecutor(2) as pool:
        params, g_params = pool.map(lambda a: jax_tree(*a[0], **a[1]), [
            ((0,), CFG), ((2,), {**CFG, "n_layers": 2})])
    tokens = np.random.default_rng(0).integers(0, 32, (8, 12)).astype(
        np.int32)
    targets = np.roll(tokens, -1, axis=1)

    def forward(m, dtype=jnp.float32):
        return np.asarray(jax.jit(lambda p, t: jpp.pipelined_lm_apply(
            mesh, p, t, n_heads=4, n_micro=m, dtype=dtype))(
                params, tokens), np.float32)

    jobs = {m: (forward, m) for m in MICRO}
    jobs["bf16"] = (forward, 2, jnp.bfloat16)
    jobs["grads"] = (lambda: jax.device_get(jax.jit(jax.grad(
        lambda p: loss_of(jpp.sequential_lm_apply(p, tokens, n_heads=4),
                          targets)))(g_params)),)
    # the compiles run side by side
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(*job) for k, job in jobs.items()}
        out = {k: f.result() for k, f in futures.items()}
    out.update(params=params, tokens=tokens, g_params=g_params)
    return out


@pytest.fixture(scope="module")
def mesh24():
    return make_mesh(MeshSpec(data=2, model=4), [CPU] * 8)


@pytest.mark.parametrize("n_micro", MICRO)
def test_pipeline_matches_the_jax_pipeline(ref, mesh24, n_micro):
    """Every microbatch count reproduces the JAX pipeline's logits."""
    params = params_from_jax(ref["params"])
    got = pp.pipelined_lm_apply(mesh24, params, ref["tokens"], n_heads=4,
                                n_micro=n_micro)
    np.testing.assert_allclose(got.numpy(), ref[n_micro], rtol=2e-5,
                               atol=2e-5)


def test_stage_applications_are_micro_times_stages(ref, mesh24):
    """The bubble's ticks are skipped: each data row's forward applies a
    stage M x S times."""
    params = params_from_jax(ref["params"])
    before = pp._apply_stage.applications
    pp.pipelined_lm_apply(mesh24, params, ref["tokens"], n_heads=4,
                          n_micro=4)
    assert pp._apply_stage.applications - before == 2 * 4 * 4


def test_gradients_match_jax_sequential(ref):
    """The reverse pipeline autograd builds gives `jax.grad` of the JAX
    sequential stack's loss (2 layers over a (4, 2) mesh, 2 microbatches
    a row)."""
    mesh = make_mesh(MeshSpec(data=4, model=2), [CPU] * 8)
    params = pp.place_pipeline_params(
        params_from_jax(ref["g_params"]),
        pp.pipeline_param_shardings(mesh, params_from_jax(ref["g_params"])))
    leaves = pp.pipeline_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tokens = torch.as_tensor(ref["tokens"])
    targets = torch.roll(tokens, -1, 1)
    logits = pp.pipelined_lm_apply(mesh, params, tokens, n_heads=4,
                                   n_micro=2)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 32), targets.reshape(-1).long())
    loss.backward()
    grads = params_to_jax(pp.joined_leaves(params,
                                           [t.grad for t in leaves]))
    want = jax.tree_util.tree_leaves_with_path(ref["grads"])
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert len(want) == len(got)
    for path, w in want:
        g = got[path]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_bf16_and_remat_match_the_jax_pipeline(ref, mesh24):
    """bf16 blocks (f32 masters cast per call) give the JAX pipeline's
    bf16 logits; remat per layer leaves the forward as it was."""
    params = params_from_jax(ref["params"])
    got = pp.pipelined_lm_apply(mesh24, params, ref["tokens"], n_heads=4,
                                n_micro=2, dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), ref["bf16"], rtol=0.05,
                               atol=0.05)
    got = pp.pipelined_lm_apply(mesh24, params, ref["tokens"], n_heads=4,
                                n_micro=2, remat=True)
    np.testing.assert_allclose(got.numpy(), ref[2], rtol=2e-5, atol=2e-5)


def test_remat_keeps_the_gradients(ref):
    """Recomputing each layer in the backward leaves the gradients as
    they were."""
    mesh = make_mesh(MeshSpec(data=4, model=2), [CPU] * 8)
    tokens = torch.as_tensor(ref["tokens"])

    def grads(remat):
        params = pp.place_pipeline_params(
            params_from_jax(ref["params"]),
            pp.pipeline_param_shardings(mesh, params_from_jax(
                ref["params"])))
        leaves = pp.pipeline_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        logits = pp.pipelined_lm_apply(mesh, params, tokens, n_heads=4,
                                       n_micro=2, remat=remat)
        torch.nn.functional.cross_entropy(
            logits.reshape(-1, 32),
            torch.roll(tokens, -1, 1).reshape(-1).long()).backward()
        return [t.grad for t in leaves]
    for a, b in zip(grads(False), grads(True)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_bubble_fraction():
    assert pp.count_pipeline_bubble(1, 4) == pytest.approx(3 / 4)
    assert pp.count_pipeline_bubble(16, 4) == pytest.approx(3 / 19)
    assert pp.count_pipeline_bubble(8, 1) == 0.0
    assert pp.count_pipeline_bubble(4, 2) == pytest.approx(0.2)


def test_converters_round_trip_against_the_jax_ones(ref):
    """Both converters give what the JAX ones give, and invert each
    other."""
    variables = init_transformer_lm_params(CFG, seed=3)
    jtree = jax.device_get(jpp.pipeline_params_from_variables(
        variables, CFG["n_layers"]))
    got = pp.pipeline_params_from_variables(variables, CFG["n_layers"])
    want = params_from_jax(jtree)
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    back = pp.variables_from_pipeline_params(got, CFG["n_layers"])
    jback = jax.device_get(jpp.variables_from_pipeline_params(
        jtree, CFG["n_layers"]))
    flat = dict(jax.tree_util.tree_leaves_with_path(jback))
    mine = jax.tree_util.tree_leaves_with_path(back)
    assert len(mine) == len(flat)
    for path, leaf in mine:
        np.testing.assert_array_equal(leaf, flat[path])
    # and the stacked tree itself crosses both ways byte for byte
    again = params_to_jax(want)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        np.testing.assert_array_equal(
            dict(jax.tree_util.tree_leaves_with_path(again))[path], leaf)


def test_stage_leaves_are_placed_per_stage(mesh24):
    """Each stacked block leaf is split over row 0's stages on its layer
    dim; the embeddings sit on the first stage, the head on the last."""
    params = pp.init_pipelined_lm(0, **CFG)
    where = pp.pipeline_param_shardings(mesh24, params)
    assert where["blocks.qkv.weight"] == [CPU] * 4
    placed = pp.place_pipeline_params(params, where)
    leaf = placed["blocks.qkv.weight"]
    assert isinstance(leaf, ModelShards) and len(leaf) == 4
    assert [tuple(t.shape) for t in leaf] == [(1, 48, 16)] * 4
    for s, t in enumerate(leaf):
        assert torch.equal(t, params["blocks.qkv.weight"][s:s + 1])
    assert isinstance(placed["head"], torch.Tensor)
    assert len(pp.pipeline_leaves(placed)) == 6 + 12 * 4
    with pytest.raises(ValueError, match="divide evenly"):
        pp.place_pipeline_params(
            pp.init_pipelined_lm(0, **{**CFG, "n_layers": 3}),
            pp.pipeline_param_shardings(mesh24, params))


def test_train_step_learns(mesh24):
    """`make_pipeline_lm_step` with the port's Adam lowers the loss of a
    fixed batch, its stage leaves updated in place on their stages."""
    from mmlspark_tpu_torch.train.config import TrainerConfig
    from mmlspark_tpu_torch.train.optim import Optimizer
    tx = Optimizer(TrainerConfig(optimizer="adam", learning_rate=1e-2), 20)
    params = pp.init_pipelined_lm(1, **CFG)
    params = pp.place_pipeline_params(
        params, pp.pipeline_param_shardings(mesh24, params))
    opt = tx.init(pp.pipeline_leaves(params))
    step = pp.make_pipeline_lm_step(mesh24, tx, n_heads=4, n_micro=4)
    toks = torch.as_tensor(np.arange(96).reshape(8, 12) % 32)
    losses = []
    for _ in range(20):
        params, opt, loss = step(params, opt, toks, torch.roll(toks, -1, 1))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])
