"""Population training (`mmlspark_tpu_torch/train/sweep.py`) against the
JAX package's (`mmlspark_tpu/train/sweep.py`), on the CPU: the cases of
tests/test_sweep.py, run in the port and, where the JAX package has the
same case, held to its `PopulationTrainer` with each JAX member's init
carried across (`fit_arrays(member_variables=...)`).

Bounds:

  * a population of 1 equals the port's plain Trainer from the same init
    byte for byte on the CPU (the vmapped member step runs the plain
    step's arithmetic; the JAX package's own version of this test parts
    by one f32 ulp on this host);
  * the members' per-step losses within 1e-5 relative of the JAX
    population's, the final parameters within 1e-4 of each leaf's max
    |w| (f32; Adam steps at 0.01-0.0003);
  * member curves independent of N within 1e-6; culled members
    byte-frozen; the halving rung culls the same members as the JAX
    package's; a resumed population equals the uninterrupted one byte for
    byte; the winner's bundle scores through `TPUModel` within 1e-5 of
    the stacked forward.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel.bridge import stack_trees as jax_stack_trees
from mmlspark_tpu.parallel.bridge import unstack_member as jax_unstack
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.train import PopulationTrainer as JaxPopulationTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.parallel.bridge import stack_trees, unstack_member
from mmlspark_tpu_torch.train import (PopulationTrainer, Trainer,
                                      TrainerConfig)

RATES = (0.02, 0.005, 0.001, 0.0003)
HALVING_RATES = (0.02, 0.01, 1e-5, 1e-6)


def _kw(**kw):
    base = dict(architecture="MLPClassifier",
                model_config={"hidden_sizes": [16], "num_classes": 3,
                              "dtype": "float32"},
                optimizer="adam", learning_rate=0.01, epochs=3,
                batch_size=32, loss="softmax_xent", seed=7,
                shuffle_each_epoch=True)
    base.update(kw)
    return base


def _cfg(**kw):
    return TrainerConfig(**_kw(**kw))


def _data(n=96, d=8, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, classes)).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


def _members(rates):
    return [{"learning_rate": r} for r in rates]


def _tree_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return all(np.array_equal(np.asarray(u), np.asarray(v))
               for u, v in zip(la, lb))


@pytest.fixture(scope="module")
def jax_refs():
    """JAX populations on a one-device mesh: (member inits, result) of the
    4-rate sweep and of the halving sweep."""
    x, y = _data()
    mesh = make_mesh(JaxMeshSpec(data=1), devices=jax.devices()[:1])

    def run(rates, **kw):
        pt = JaxPopulationTrainer(JaxTrainerConfig(**_kw(
            epochs=kw.pop("epochs", 3))), _members(rates), mesh=mesh, **kw)
        inits = [pt.member_init_variables(k, (1, x.shape[1]))
                 for k in range(len(rates))]
        result = pt.fit_arrays(x, y)
        return inits, result.member_loss, result.active, [
            jax.tree_util.tree_map(np.asarray, jax_unstack(
                result.state.params, k)) for k in range(len(rates))]

    jobs = {"sweep": lambda: run(RATES, epochs=2),
            "halving": lambda: run(HALVING_RATES, epochs=4,
                                   halving_rungs=1, cull_fraction=0.5)}
    with ThreadPoolExecutor(2) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


def test_population_n1_byte_identical_to_plain_trainer():
    """One vmapped member is a plain Trainer fit from the member's init:
    every parameter byte matches on the CPU."""
    cfg = _cfg()
    x, y = _data()
    pt = PopulationTrainer(cfg, 1, device="cpu")
    init = pt.member_init_bundle(0, (1, x.shape[1]))
    result = pt.fit_arrays(x, y)
    bundle = Trainer(cfg, device="cpu").fit_arrays(x, y, initial_bundle=init)
    assert _tree_equal(pt.member_variables(result.state, 0)["params"],
                       bundle.variables["params"])


def test_population_matches_the_jax_population(jax_refs):
    """The 4-rate sweep from the JAX members' inits: per-step member
    losses and final parameters as the JAX package's."""
    inits, jloss, _, jparams = jax_refs["sweep"]
    x, y = _data()
    pt = PopulationTrainer(_cfg(epochs=2), _members(RATES), device="cpu")
    result = pt.fit_arrays(x, y, member_variables=inits)
    np.testing.assert_allclose(result.member_loss, jloss, rtol=1e-5)
    for k in range(len(RATES)):
        got = jax.tree_util.tree_leaves(
            pt.member_variables(result.state, k)["params"])
        for g, w in zip(got, jax.tree_util.tree_leaves(jparams[k])):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-4 * np.abs(w).max())


def test_member_curve_independent_of_population_size():
    cfg = _cfg(epochs=2)
    x, y = _data()
    small = PopulationTrainer(cfg, _members(RATES[:2]),
                              device="cpu").fit_arrays(x, y)
    large = PopulationTrainer(cfg, _members(RATES),
                              device="cpu").fit_arrays(x, y)
    np.testing.assert_allclose(small.member_loss, large.member_loss[:, :2],
                               rtol=0, atol=1e-6)


def test_halving_mask_freezes_culled_members_exactly(jax_refs):
    """After a rung culls a member its parameters never move again, byte
    for byte; the survivors keep training; the rung culls the members
    the JAX package's culls from the same inits."""
    inits, _, jactive, _ = jax_refs["halving"]
    cfg = _cfg(epochs=4)
    x, y = _data()
    pt = PopulationTrainer(cfg, _members(HALVING_RATES), halving_rungs=1,
                           cull_fraction=0.5, device="cpu")
    # the same population with no halving, truncated at the rung
    at_rung = PopulationTrainer(_cfg(epochs=2), _members(HALVING_RATES),
                                device="cpu").fit_arrays(
        x, y, member_variables=inits)
    result = pt.fit_arrays(x, y, member_variables=inits)
    np.testing.assert_array_equal(result.active, jactive)
    culled = [k for k in range(4) if result.active[k] == 0.0]
    assert len(culled) == 2
    for k in range(4):
        frozen = pt.member_variables(result.state, k)
        before = pt.member_variables(at_rung.state, k)
        assert _tree_equal(frozen, before) == (k in culled), k
    for moment in ("mu", "nu"):
        for now, then in zip(result.state.opt_state[moment],
                             at_rung.state.opt_state[moment]):
            for k in culled:
                assert torch.equal(now[k], then[k])


def test_winner_unstacks_and_roundtrips_through_bundle(tmp_path):
    from mmlspark_tpu_torch.models.bundle import load_bundle, save_bundle
    from mmlspark_tpu_torch.models.tpu_model import TPUModel
    x, y = _data()
    pt = PopulationTrainer(_cfg(), _members((0.02, 0.005)), device="cpu")
    result = pt.fit_arrays(x, y)
    k = result.best_member
    bundle = result.winner_bundle()
    assert bundle.metadata["sweep"] == {"member": k, "population": 2,
                                        "learning_rate": (0.02, 0.005)[k]}
    stacked_logits = pt.score_population(result.state, x)[k]
    save_bundle(bundle, str(tmp_path / "winner"))
    model = TPUModel(load_bundle(str(tmp_path / "winner")), device="cpu",
                     inputCol="feats", outputCol="out", miniBatchSize=32)
    out = model.transform(DataTable({"feats": x}))
    np.testing.assert_allclose(np.stack(list(out["out"])), stacked_logits,
                               rtol=0, atol=1e-5)


def test_mid_sweep_checkpoint_resume_matches_uninterrupted(tmp_path):
    x, y = _data()
    ckpt = str(tmp_path / "ckpt")
    members = _members((0.02, 0.005, 0.001))
    cfg = _cfg(epochs=4, checkpoint_every_steps=5, async_checkpointing=False)
    full = PopulationTrainer(cfg, members, device="cpu").fit_arrays(x, y)
    half = _cfg(epochs=2, checkpoint_every_steps=5,
                async_checkpointing=False)
    PopulationTrainer(half, members, device="cpu").fit_arrays(
        x, y, ckpt_dir=ckpt)
    resumed = PopulationTrainer(cfg, members, device="cpu").fit_arrays(
        x, y, ckpt_dir=ckpt, resume=True)
    assert resumed.state.step == full.state.step
    assert _tree_equal(resumed.state.params, full.state.params)
    assert _tree_equal(resumed.state.opt_state["mu"],
                       full.state.opt_state["mu"])
    assert _tree_equal(resumed.state.opt_state["nu"],
                       full.state.opt_state["nu"])


def test_sweep_timeline_lands_in_run_summary():
    from mmlspark_tpu_torch.observe.telemetry import run_telemetry
    x, y = _data()
    with run_telemetry(None) as rt:
        PopulationTrainer(_cfg(epochs=2), 3, halving_rungs=1,
                          device="cpu").fit_arrays(x, y)
    summary = rt.summary()
    kinds = [e["event"] for e in summary["sweep"]]
    assert kinds[0] == "start"
    assert kinds.count("member_final") == 3
    assert "winner" in kinds and "cull" in kinds
    start = summary["sweep"][0]
    assert start["population"] == 3 and len(start["lrs"]) == 3
    assert summary["spans"].get("train.step", {}).get("count", 0) > 0
    steps = [r for r in rt.tracer.records()
             if r.get("name") == "train.step" and "attrs" in r]
    assert steps and len(steps[0]["attrs"]["member_loss"]) == 3


def test_resnet_population_with_batch_stats():
    """BatchNorm models sweep too: the statistics move functionally under
    vmap, for every member, and the winner's bundle carries them."""
    cfg = TrainerConfig(architecture="ResNet",
                        model_config={"stage_sizes": [1], "widths": [4],
                                      "num_classes": 10,
                                      "block_kind": "basic",
                                      "dtype": "float32"},
                        optimizer="momentum", learning_rate=0.01,
                        epochs=1, batch_size=16, loss="softmax_xent", seed=3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=32).astype(np.int32)
    pt = PopulationTrainer(cfg, _members((0.02, 0.005)), device="cpu")
    result = pt.fit_arrays(x, y)
    bundle = result.winner_bundle()
    init = pt.member_init_variables(result.best_member, (1, 8, 8, 3))
    assert not _tree_equal(bundle.variables["batch_stats"],
                           init["batch_stats"])
    assert pt.score_population(result.state, x[:8]).shape == (2, 8, 10)
    # member 0 alone: the same statistics as a plain fit from its init
    one = PopulationTrainer(cfg, _members((0.02,)), device="cpu")
    alone = one.fit_arrays(x, y)
    plain = Trainer(dataclasses.replace(cfg, learning_rate=0.02),
                    device="cpu").fit_arrays(
        x, y, initial_bundle=one.member_init_bundle(0, (1, 8, 8, 3)))
    for g, w in zip(jax.tree_util.tree_leaves(
            one.member_variables(alone.state, 0)["batch_stats"]),
            jax.tree_util.tree_leaves(plain.variables["batch_stats"])):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_train_classifier_population_sweep_picks_winner():
    from mmlspark_tpu_torch.ml import (ComputeModelStatistics,
                                       MultilayerPerceptronClassifier,
                                       TrainClassifier)
    rng = np.random.default_rng(3)
    n = 120
    x0, x1 = rng.normal(size=(n,)), rng.normal(size=(n,))
    y = (x0 + 0.5 * x1 > 0).astype(np.int64)
    t = DataTable({"f0": x0, "f1": x1, "label": y})
    mlp = MultilayerPerceptronClassifier(layers=[-1, 16, -1], maxIter=8,
                                         stepSize=0.01, seed=1, device="cpu")
    model = TrainClassifier(mlp, populationSize=4).fit(t)
    sm = model.sweep_metrics
    assert sm is not None and sm.num_rows == 4
    assert {"model_name", "accuracy", "learning_rate", "final_loss",
            "active"} <= set(sm.columns)
    acc = float(ComputeModelStatistics().evaluate(model.transform(t))
                .metrics["accuracy"][0])
    assert acc == pytest.approx(max(float(a) for a in sm["accuracy"]),
                                abs=1e-9)
    rates = TrainClassifier(mlp, sweepLearningRates=[0.1, 0.01]).fit(
        t).sweep_metrics["learning_rate"]
    assert list(rates) == [0.1, 0.01]


def test_stack_unstack_roundtrip_matches_jax():
    trees = [{"w": np.full((2, 3), i, np.float32), "b": np.ones(3) * i}
             for i in range(4)]
    stacked = stack_trees(trees)
    ref = jax_stack_trees(trees)
    assert stacked["w"].shape == (4, 2, 3)
    assert _tree_equal(stacked, ref)
    for i in range(4):
        got = unstack_member(stacked, i)
        assert np.array_equal(got["w"], trees[i]["w"])
        assert np.array_equal(got["b"], trees[i]["b"])
    tensors = stack_trees([{"a": torch.full((2,), float(i))}
                           for i in range(3)])
    assert isinstance(tensors["a"], torch.Tensor)
    assert np.array_equal(unstack_member(tensors, 2)["a"], [2.0, 2.0])


def test_population_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PopulationTrainer(_cfg(), 2)
    # a model axis is taken (the members split as the Trainer's
    # placement has it), and a seq axis (it replicates the batch: one
    # data shard at seq index 0; tests/test_torch_seq_axis_sweep.py)
    pt = PopulationTrainer(_cfg(mesh={"data": 1, "model": 2}), 2,
                           device="cpu")
    assert pt.model_size == 2 and pt.mesh.shape["model"] == 2
    pt = PopulationTrainer(_cfg(mesh={"data": 1, "seq": 2}), 2, device="cpu")
    assert pt.mesh.shape["seq"] == 2
    assert pt.shard_devices == [torch.device("cpu")]
