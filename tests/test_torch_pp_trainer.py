"""The port's Trainer with pipeline stages against the JAX package, at
`PP_MODEL` of `tests/test_parallel_trainer.py` over a (4, 2) mesh of
`[cpu] * 8` (stages on the model axis): the fit's losses and weights
against a jitted JAX loop of `sequential_lm_apply` and the JAX Trainer's
optax chain from the same carried-in init, the checkpoint's bytes against
the JAX serializer over the same state, the emitted bundle scored in the
JAX package, the warm start, the six validation errors word for word,
and the resume across stage counts."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from mmlspark_tpu.models.bundle import load_bundle as jax_load_bundle
from mmlspark_tpu.parallel import pipeline as jpp
from mmlspark_tpu.parallel.mesh import MeshSpec as JMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jmake_mesh
from mmlspark_tpu.resilience.ckpt_writer import serialize_tree
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu.train.trainer import build_optimizer
from mmlspark_tpu_torch import DataTable
from mmlspark_tpu_torch.models import TPUModel
from mmlspark_tpu_torch.models.bundle import (ModelBundle, params_to_jax,
                                              save_bundle)
from mmlspark_tpu_torch.parallel import pipeline as pp
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.parallel.partition import ModelShards
from mmlspark_tpu_torch.resilience.checkpoints import latest_valid_checkpoint
from mmlspark_tpu_torch.train import Trainer, TrainerConfig
from mmlspark_tpu_torch.train.optim import Optimizer, opt_state_to_jax

PP_MODEL = {"vocab_size": 32, "d_model": 16, "n_heads": 4, "n_layers": 2,
            "max_len": 12, "dtype": "float32"}
RNG = np.random.default_rng(7)
TOKS = RNG.integers(0, 32, (16, 12)).astype(np.int32)
TGTS = np.roll(TOKS, -1, axis=1).astype(np.int32)
CPU = torch.device("cpu")
FIT = dict(architecture="TransformerLM", optimizer="adam",
           learning_rate=1e-2, epochs=2, batch_size=8, loss="softmax_xent",
           seed=0, shuffle_each_epoch=False, pipeline_stages=2,
           pipeline_microbatches=2)


def sorted_tree(tree):
    """A tree with every dict's keys in sorted order, as a jit's output
    holds them."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def mesh42():
    return make_mesh(MeshSpec(data=4, model=2), [CPU] * 8)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One pipelined fit from the JAX init (as a TransformerLM bundle),
    and the JAX loop over the same batches."""
    jtree = jax.device_get(jax.jit(lambda k: jpp.init_pipelined_lm(
        k, vocab_size=32, d_model=16, n_heads=4, n_layers=2,
        max_len=12))(jax.random.key(0)))
    init = ModelBundle("TransformerLM", dict(PP_MODEL), jax.device_get(
        jpp.variables_from_pipeline_params(jtree, 2)))
    ckpt = str(tmp_path_factory.mktemp("pp_ckpt"))
    cfg = TrainerConfig(**FIT, model_config=dict(PP_MODEL),
                        checkpoint_dir=ckpt)
    trainer = Trainer(cfg, mesh=mesh42())
    bundle = trainer.fit_arrays(TOKS, TGTS, initial_bundle=init)

    jcfg = JaxTrainerConfig(**FIT, model_config=dict(PP_MODEL))
    tx = build_optimizer(jcfg, 4)

    @jax.jit
    def step(params, opt, x, y):
        def loss_fn(p):
            lp = jax.nn.log_softmax(jpp.sequential_lm_apply(p, x, n_heads=4))
            return -jnp.take_along_axis(lp, y[..., None], -1).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    params, opt, losses = jtree, tx.init(jtree), []
    for _epoch in range(2):
        for start in (0, 8):
            params, opt, loss = step(params, opt, TOKS[start:start + 8],
                                     TGTS[start:start + 8])
            losses.append(float(loss))
    return dict(trainer=trainer, bundle=bundle, ckpt=ckpt, init=init,
                jax_params=jax.device_get(params), jax_losses=losses,
                jax_opt=opt, tx=tx)


def test_fit_matches_the_jax_loop(run):
    """Per-epoch losses and the final stacked weights follow the JAX
    sequential loop's under the JAX Trainer's optax chain."""
    trainer = run["trainer"]
    want = np.asarray(run["jax_losses"]).reshape(2, 2).mean(axis=1)
    got = np.asarray([h["loss"] for h in trainer.history])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert run["bundle"].metadata["steps"] == 4
    mine = params_to_jax(pp.joined_leaves(
        trainer._pp_params, trainer._last_state.params))
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(mine))
    for path, leaf in jax.tree_util.tree_leaves_with_path(run["jax_params"]):
        name = jax.tree_util.keystr(path)
        got_leaf = got_leaves[path]
        if name == "['blocks']['qkv']['bias']":
            # the key third has a zero true gradient: Adam scales each
            # package's round-off there to lr-sized steps (ROADMAP queue C)
            keep = np.r_[0:16, 32:48]
            got_leaf, leaf = got_leaf[:, keep], leaf[:, keep]
        np.testing.assert_allclose(got_leaf, leaf, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_stage_leaves_and_moments_live_on_their_stages(run):
    """Each stage's layers, and their Adam moments, are that stage's part
    of the stacked leaf."""
    trainer = run["trainer"]
    leaf = trainer._pp_params["blocks.qkv.weight"]
    assert isinstance(leaf, ModelShards) and len(leaf) == 2
    assert [tuple(t.shape) for t in leaf] == [(1, 48, 16)] * 2
    state = trainer._last_state
    assert len(state.opt_state["mu"]) == len(state.params)
    for p, m in zip(state.params, state.opt_state["mu"]):
        assert p.shape == m.shape and p.device == m.device


def test_checkpoint_bytes_equal_the_jax_serializer(run):
    """The newest checkpoint holds the stacked tree and its Adam state,
    byte-identical to the JAX Trainer's serializer over the same state;
    restoring it gives the live state back."""
    trainer, ckpt = run["trainer"], run["ckpt"]
    path = latest_valid_checkpoint(ckpt)
    assert os.path.basename(path) == "ckpt_0000000004.msgpack"
    with open(path, "rb") as f:
        raw = f.read()
    state = trainer._last_state
    tree = trainer.state_tree(state)
    jparams = sorted_tree(tree["params"])
    jopt = serialization.from_state_dict(run["tx"].init(jparams),
                                         tree["opt_state"])
    # the JAX Trainer's tree as its writer gets it: a jit's output dict,
    # keys sorted
    jax_bytes = serialize_tree({"batch_stats": {}, "opt_state": jopt,
                                "params": jparams,
                                "step": jnp.asarray(4, jnp.int32)})
    assert raw == jax_bytes
    assert opt_state_to_jax(state.opt_state, trainer._names)["0"][
        "count"] == 4
    before = [t.detach().clone() for t in state.params]
    restored = trainer.restore_checkpoint(state, ckpt)
    assert restored.step == 4
    for a, b in zip(before, restored.params):
        assert torch.equal(a, b)


def test_bundle_scores_equal_in_the_jax_package(run, tmp_path):
    """The emitted bundle is an ordinary TransformerLM bundle: the JAX
    package loads it and its forward equals the port's, which stays
    within 2e-4 of the pipelined forward of the live state; TPUModel
    scores it over the mesh."""
    bundle, trainer = run["bundle"], run["trainer"]
    save_bundle(bundle, str(tmp_path / "b"))
    jb = jax_load_bundle(str(tmp_path / "b"))
    assert jb.architecture == "TransformerLM"
    toks = TOKS[:8]
    want = np.asarray(jax.jit(jb.module().apply)(jb.variables, toks))
    mine = bundle.module("cpu")(torch.as_tensor(toks)).detach().numpy()
    np.testing.assert_allclose(mine, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        piped = pp.pipelined_lm_apply(trainer.mesh, trainer._pp_params,
                                      toks, n_heads=4, n_micro=2)
    np.testing.assert_allclose(mine, piped.numpy(), rtol=2e-4, atol=2e-4)
    scored = TPUModel(bundle, device="cpu", inputCol="tokens",
                      outputCol="scores", miniBatchSize=8).set_mesh(
        trainer.mesh).transform(DataTable({"tokens": TOKS[:10]}))
    assert scored["scores"].shape == (10, 12, 32)
    np.testing.assert_allclose(scored["scores"][:8], mine, rtol=1e-5,
                               atol=1e-5)


def test_warm_start_adds_two_steps(run):
    """A pipelined fit warm-started from its own bundle resumes the step
    count and stacks the bundle's blocks back."""
    cfg = TrainerConfig(**{**FIT, "epochs": 1, "learning_rate": 1e-3},
                        model_config=dict(PP_MODEL))
    t2 = Trainer(cfg, mesh=mesh42())
    b2 = t2.fit_arrays(TOKS, TGTS, initial_bundle=run["bundle"])
    assert b2.metadata["steps"] == run["bundle"].metadata["steps"] + 2



def test_trainer_step_and_make_pipeline_lm_step_share_one_core():
    """The Trainer's pipelined step and `make_pipeline_lm_step` both run
    `pipeline_train_step`: from the same init, one SGD step over every
    row gives the same loss and the same leaves."""
    cfg = TrainerConfig(**{**FIT, "optimizer": "sgd"},
                        model_config=dict(PP_MODEL))
    trainer = Trainer(cfg, mesh=mesh42())
    state = trainer.init_state((1, 12), 4)
    x = torch.from_numpy(TOKS[:8].astype(np.int64))
    y = torch.from_numpy(TGTS[:8].astype(np.int64))
    loss, _ = trainer.make_train_step()(
        state, list(x.split(2)), list(y.split(2)),
        [torch.ones(2) for _ in range(4)])

    mesh = mesh42()
    params = pp.init_pipelined_lm(0, vocab_size=32, d_model=16, n_heads=4,
                                  n_layers=2, max_len=12)
    params = pp.place_pipeline_params(
        params, pp.pipeline_param_shardings(mesh, params))
    tx = Optimizer(cfg, 4)
    opt = tx.init(pp.pipeline_leaves(params))
    _, _, ref = pp.make_pipeline_lm_step(mesh, tx, n_heads=4, n_micro=2)(
        params, opt, x, y)
    assert abs(float(loss) - float(ref)) <= 1e-6 * abs(float(ref))
    for mine, want in zip(state.params, pp.pipeline_leaves(params)):
        torch.testing.assert_close(mine.detach(), want.detach(), rtol=1e-6,
                                   atol=1e-7)

BAD = [
    ({"architecture": "MLPClassifier", "model_config": {}}, None),
    ({"model_config": dict(PP_MODEL, attn_impl="flash")}, None),
    ({"model_config": dict(PP_MODEL, mlp_impl="moe")}, None),
    ({"model_config": dict(PP_MODEL, remat=True,
                           remat_policy="save_attention")}, None),
    ({"pipeline_stages": 4}, None),
    ({"model_config": dict(PP_MODEL, n_layers=3)}, None),
    ({"pipeline_microbatches": 0}, None),
]


@pytest.mark.parametrize("change", [c for c, _ in BAD],
                         ids=["architecture", "flash", "moe", "remat_policy",
                              "axis_size", "divide", "microbatches"])
def test_validation_errors_word_for_word(change):
    """Each bad pipeline config raises the JAX Trainer's ValueError with
    the same message."""
    kw = {**FIT, "model_config": dict(PP_MODEL), **change}
    with pytest.raises(ValueError) as jerr:
        JaxTrainer(JaxTrainerConfig(**kw), mesh=jmake_mesh(
            JMeshSpec(data=4, model=2), jax.devices()[:8]))
    with pytest.raises(ValueError) as err:
        Trainer(TrainerConfig(**kw), mesh=mesh42())
    assert str(err.value) == str(jerr.value)


def test_resume_across_stage_counts_raises(tmp_path):
    """A pipeline checkpoint does not resume onto another stage count."""
    model = dict(PP_MODEL, n_layers=4)
    cfg = TrainerConfig(**{**FIT, "epochs": 1}, model_config=model)
    Trainer(cfg, mesh=mesh42()).fit_arrays(TOKS, TGTS,
                                           ckpt_dir=str(tmp_path))
    cfg4 = TrainerConfig(**{**FIT, "epochs": 1, "pipeline_stages": 4},
                         model_config=model)
    t4 = Trainer(cfg4, mesh=make_mesh(MeshSpec(data=2, model=4), [CPU] * 8))
    with pytest.raises(ValueError, match="requires the same stage count"):
        t4.fit_arrays(TOKS, TGTS, ckpt_dir=str(tmp_path), resume=True)
