"""The mixture-of-experts TransformerLM of the port against the JAX
package's, on the CPU: bundles and training.

Both packages take the same weights (the port's seeded numpy init, fed to
flax as the parameter tree).  Tolerances:

  * MoE bundle and bf16 / int8 PTQ files byte-identical both ways, the
    expert stacks and the router left float; an int8 MoE bundle decodes;
  * a 4-step f32 MoE `fit_arrays` with aux_loss_weight 0.05: the
    epoch's loss within 1e-5 relative; in every leaf all but 0.1% of the
    weights within 1e-4 of its max |w|, none further than 4 x lr (4 Adam
    steps), and the leaf within 1e-4 in Frobenius norm (Adam scales f32
    round-off in a near-zero gradient, such as an expert's rarely routed
    hidden unit, to lr-sized steps; the key third of each qkv bias, whose
    true gradient is zero, left out); the history's
    moe_overflow_fraction within 1e-6;
  * the remat policies: tests/test_torch_moe_remat.py.
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.bundle import load_bundle as jax_load_bundle
from mmlspark_tpu.models.bundle import save_bundle as jax_save_bundle
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.quant.quantize import quantize_bundle as jax_quantize
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import DataTable, TextGenerator, Trainer, TrainerConfig
from mmlspark_tpu_torch.core.bf16 import BF16Array
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.models.bundle import load_bundle, save_bundle
from mmlspark_tpu_torch.quant.quantize import quantize_bundle

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 64, "dtype": "float32", "mlp_impl": "moe",
       "n_experts": 4, "moe_router_k": 2, "moe_group_size": 8}


def _bundle(cfg, seed=0):
    return ModelBundle.init("TransformerLM", cfg, seed=seed)


# ------------------------------------------------------------ bundles ---

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _raw(leaf):
    if isinstance(leaf, BF16Array):
        return "bfloat16", leaf.bits.tobytes()
    arr = np.asarray(leaf)
    return str(arr.dtype), arr.tobytes()


@pytest.mark.parametrize("mode", [None, "int8", "bf16"])
def test_moe_bundle_files_byte_identical_both_ways(mode, tmp_path):
    bundle = ModelBundle.from_module(_bundle(CFG).module("cpu"))
    jb = JaxModelBundle("TransformerLM", dict(bundle.config),
                        bundle.variables, {})
    if mode is not None:
        bundle, jb = quantize_bundle(bundle, mode), jax_quantize(jb, mode)
    save_bundle(bundle, str(tmp_path / "port"))
    jax_save_bundle(jb, str(tmp_path / "jax"))
    for name in ("params.msgpack", "bundle.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    back = jax_load_bundle(str(tmp_path / "port"))
    got = dict(_leaves(load_bundle(str(tmp_path / "jax")).variables))
    for name, leaf in _leaves(back.variables):
        assert _raw(got[name]) == _raw(leaf), name
        if "moe" in name:
            # the expert stacks and the router stay float
            assert _raw(leaf)[0] in ("float32", "bfloat16"), name
    if mode == "int8":
        assert "moe/w_in" in "".join(got)
        lm = load_bundle(str(tmp_path / "port")).module("cpu")
        assert lm.block0_w.moe.w_in.dtype == torch.float32
        toks = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
        out = TextGenerator(load_bundle(str(tmp_path / "port")),
                            device="cpu", inputCol="p",
                            maxNewTokens=4).transform(
            DataTable({"p": toks}))["generated"]
        assert np.asarray(out).shape == (1, 12)


# ------------------------------------------------------------ training ---

FIT = dict(architecture="TransformerLM", optimizer="adam",
           learning_rate=1e-2, batch_size=4, epochs=1, seed=3,
           shuffle_each_epoch=True, numerics_cadence=0, aux_loss_weight=0.05)


def _corpus(n_rows=16, seq=16, vocab=64, seed=41):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, vocab, size=(n_rows, 1))
    rows = ((starts + np.arange(seq + 1)) % vocab).astype(np.int32)
    return rows[:, :-1], rows[:, 1:]


# one layer: the JAX Trainer's compile is most of this file's time
TRAIN_CFG = {**CFG, "attn_impl": "dense", "n_layers": 1}


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX Trainer's 4-step fit of the MoE LM at dense attention."""
    x, y = _corpus()
    trainer = JaxTrainer(
        JaxTrainerConfig(model_config=dict(TRAIN_CFG), **FIT),
        mesh=make_mesh(JaxMeshSpec(data=1), devices=jax.devices()[:1]))
    bundle = trainer.fit_arrays(x, y, initial_bundle=JaxModelBundle(
        "TransformerLM", dict(TRAIN_CFG),
        _bundle(TRAIN_CFG, seed=9).variables))
    return trainer.history, bundle


def test_moe_fit_arrays_matches_the_jax_trainer(jax_fit):
    x, y = _corpus()
    init = _bundle(TRAIN_CFG, seed=9)
    (jh,), jbundle = jax_fit
    pt = Trainer(TrainerConfig(model_config=dict(TRAIN_CFG), **FIT),
                 device="cpu")
    bundle = pt.fit_arrays(x, y, initial_bundle=init)
    assert bundle.metadata["steps"] == jbundle.metadata["steps"] == 4
    (ph,) = pt.history
    assert ph["loss"] == pytest.approx(jh["loss"], rel=1e-5)
    assert ph["moe_overflow_fraction"] == pytest.approx(
        jh["moe_overflow_fraction"], abs=1e-6)
    assert 0 < ph["moe_overflow_fraction"] < 1
    # the aux terms are in the objective: the plain NLL is below it
    plain = Trainer(TrainerConfig(model_config=dict(TRAIN_CFG), **{
        **FIT, "aux_loss_weight": 0.0}), device="cpu")
    plain.fit_arrays(x, y, initial_bundle=init)
    assert plain.history[0]["loss"] < ph["loss"]
    got, want = dict(_leaves(bundle.variables)), dict(
        _leaves(jbundle.variables))
    assert set(got) == set(want)
    d = TRAIN_CFG["d_model"]
    for name, w in want.items():
        g, w = np.asarray(got[name]), np.asarray(w)
        if name.endswith("qkv/bias"):
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        # Adam scales f32 round-off in a near-zero gradient (an expert's
        # rarely routed hidden unit) to a step of up to lr: such entries
        # part by less than lr a step, the rest within 1e-4 of max |w|
        diff = np.abs(g - w)
        assert diff.max() <= FIT["learning_rate"] * 4, name
        assert (diff > 1e-4 * np.abs(w).max()).mean() <= 1e-3, name
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), name
