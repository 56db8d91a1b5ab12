"""Checkpoint files across the two packages, on the CPU: the port's
rotation (`resilience/checkpoints.py`) against the JAX package's module
on the same directory actions; a JAX Trainer checkpoint read by the port
and written back byte-identical (tree, key order, dtypes, sidecars); a
port checkpoint restored by the JAX Trainer; and the optimizer state of
every `build_optimizer` chain carried both ways
(`opt_state_from_jax` / `opt_state_to_jax`).
"""

import hashlib
import os

import jax
import numpy as np
import pytest
from flax import serialization

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh
from mmlspark_tpu.resilience import checkpoints as jax_ckpt
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu.train.trainer import build_optimizer
from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
from mmlspark_tpu_torch.models.bundle import params_from_jax
from mmlspark_tpu_torch.models.definitions import (TransformerLM,
                                                   init_transformer_lm_params)
from mmlspark_tpu_torch.resilience import checkpoints as port_ckpt
from mmlspark_tpu_torch.resilience.ckpt_writer import (read_checkpoint,
                                                       serialize_tree)
from mmlspark_tpu_torch.train.optim import (Optimizer, opt_state_from_jax,
                                            opt_state_to_jax)

LM = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 1,
      "max_len": 16, "dtype": "float32", "attn_impl": "dense"}
FIT = dict(architecture="TransformerLM", optimizer="adam",
           learning_rate=1e-2, lr_schedule="warmup_cosine", warmup_steps=2,
           gradient_clip_norm=1.0, batch_size=4, epochs=1, seed=3,
           numerics_cadence=0, checkpoint_every_steps=2)


def corpus(n_rows=12, seq=16, vocab=64, seed=5):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, vocab, size=(n_rows, seq + 1)).astype(np.int32)
    return rows[:, :-1], rows[:, 1:]


def files(d) -> dict:
    """{name: bytes} of a checkpoint directory."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


# ------------------------------------------------------------ rotation ---

def _drive(mod, d, case):
    """One script of directory actions through a checkpoints module;
    returns what the module reports along the way."""
    seen = []
    for step in (1, 2, 3, 4, 5):
        mod.write_checkpoint(d, step, f"payload {step}".encode() * 7,
                             keep=3, meta={"step": step, "format": 1})
    seen.append([s for s, _ in mod.list_checkpoints(d)])
    newest = os.path.join(d, mod.checkpoint_name(5))
    if case == "payload":
        with open(newest, "r+b") as f:
            f.truncate(5)
    elif case == "sidecar":
        with open(newest + ".sha256", "r+b") as f:
            f.truncate(3)
    elif case == "latest":
        with open(os.path.join(d, mod.LATEST), "wb") as f:
            f.write(b"ckpt_99")
    elif case == "orphans":
        for name in ("ckpt_0000000006.msgpack.tmp", "LATEST.tmp"):
            with open(os.path.join(d, name), "wb") as f:
                f.write(b"half")
    elif case == "legacy":
        for _, path in mod.list_checkpoints(d):
            os.remove(path + ".sha256")
        with open(os.path.join(d, "checkpoint.msgpack"), "wb") as f:
            f.write(b"legacy")
    found = mod.latest_valid_checkpoint(d)
    seen.append(None if found is None else os.path.basename(found))
    seen.append(mod.checkpoint_meta(found) if found else None)
    seen.append([mod.is_valid(p) for _, p in mod.list_checkpoints(d)])
    mod.prune(d, 2)
    seen.append([s for s, _ in mod.list_checkpoints(d)])
    seen.append(mod.sweep_orphan_tmps(d))
    return seen


@pytest.mark.parametrize("case", ["clean", "payload", "sidecar", "latest",
                                  "orphans", "legacy"])
def test_rotation_matches_the_reference(tmp_path, case):
    """Writes with keep=3, then a torn payload / sidecar / LATEST pointer,
    orphaned tmp files or a legacy single file; the same reports and the
    same directory, byte for byte, from both modules."""
    ref_dir, got_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = _drive(jax_ckpt, ref_dir, case)
    got = _drive(port_ckpt, got_dir, case)
    assert got == ref
    assert files(got_dir) == files(ref_dir)
    if case in ("payload", "sidecar"):
        assert got[1] == port_ckpt.checkpoint_name(4)   # fell back


# --------------------------------------------------- JAX <-> port files ---

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX Trainer fit (adam with clipping and a warmup-cosine schedule,
    3 steps) that checkpoints at steps 2 and 3, and its initial bundle."""
    x, y = corpus()
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    init = ModelBundle.init("TransformerLM", LM, seed=0)
    trainer = JaxTrainer(JaxTrainerConfig(model_config=dict(LM), **FIT),
                         mesh=make_mesh(JaxMeshSpec(data=1),
                                        devices=jax.devices()[:1]))
    bundle = trainer.fit_arrays(x, y, ckpt_dir=d, initial_bundle=
                                JaxModelBundle("TransformerLM", dict(LM),
                                               init.variables))
    return d, init, bundle


def test_jax_checkpoint_round_trips_through_the_port(jax_run, tmp_path):
    """The port restores the JAX Trainer's newest checkpoint and writes it
    back: the payload, its sha256 sidecar and its meta sidecar equal the
    JAX files byte for byte."""
    d, init, _ = jax_run
    newest = port_ckpt.latest_valid_checkpoint(d)
    assert os.path.basename(newest) == "ckpt_0000000003.msgpack"
    with open(newest, "rb") as f:
        raw = f.read()
    port = Trainer(TrainerConfig(model_config=dict(LM), **FIT),
                   device="cpu")
    state = port.init_state((1, 16), 3, init)
    state = port.restore_checkpoint(state, d)
    assert state.step == 3 and state.opt_state["count"] == 3
    assert serialize_tree(port.state_tree(state)) == raw
    port._effective_batch_size = FIT["batch_size"]
    out = str(tmp_path / "port")
    path = port.save_checkpoint(state, out, sync=True)
    port._close_writers()
    for suffix in ("", ".sha256", ".meta.json"):
        with open(newest + suffix, "rb") as a, open(path + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert hashlib.sha256(raw).hexdigest() == \
        open(path + ".sha256").read()


def test_port_checkpoint_restores_in_the_jax_trainer(jax_run, tmp_path):
    """A port fit (flash attention, f32) checkpoints; the JAX Trainer
    restores it: parameters equal the port's bundle exactly, the optax
    state equals the port's own, and the step is the port's."""
    _, init, _ = jax_run
    x, y = corpus()
    d = str(tmp_path / "ckpt")
    cfg = dict(FIT, model_config={**LM, "attn_impl": "flash"})
    port = Trainer(TrainerConfig(**cfg), device="cpu")
    bundle = port.fit_arrays(x, y, ckpt_dir=d, initial_bundle=init)
    jt = JaxTrainer(JaxTrainerConfig(**cfg), mesh=make_mesh(
        JaxMeshSpec(data=1), devices=jax.devices()[:1]))
    state = jt.init_state((1, x.shape[1]), 3, initial_bundle=JaxModelBundle(
        "TransformerLM", cfg["model_config"], init.variables))
    state = jt.restore_checkpoint(state, d)
    assert int(state.step) == bundle.metadata["steps"] == 3
    ref = jax.tree_util.tree_leaves_with_path(bundle.variables["params"])
    got = jax.tree_util.tree_leaves_with_path(jax.device_get(state.params))
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (_, a), (_, b) in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    jax_opt = serialization.to_state_dict(jax.device_get(state.opt_state))
    port_opt = opt_state_to_jax(port._last_state.opt_state, port._names)
    assert serialization.msgpack_serialize(jax_opt) == \
        serialize_tree(port_opt)


def test_large_leaves_serialize_as_flax_does():
    """Leaves of 64 KiB and more are framed by hand (ext 32 around a bin
    32, the data passed as a view): the bytes equal flax's for f32, int8,
    int32 and 0-d leaves, at and past the threshold."""
    rng = np.random.default_rng(9)
    tree = {"big": rng.standard_normal((256, 64)).astype(np.float32),
            "edge": rng.standard_normal(16384).astype(np.float32),
            "bytes": rng.integers(-128, 127, (70000,)).astype(np.int8),
            "ints": {"b": np.arange(3 * 8192, dtype=np.int32).reshape(
                3, 8192), "a": np.asarray(7, np.int32)},
            "small": np.ones((4, 4), np.float32)}
    assert tree["edge"].nbytes == 1 << 16
    assert serialize_tree(tree) == serialization.msgpack_serialize(
        jax.tree_util.tree_map(lambda a: a, tree))


def test_read_checkpoint_refuses_another_tree(jax_run):
    d, _, _ = jax_run
    newest = port_ckpt.latest_valid_checkpoint(d)
    tree = read_checkpoint(None, newest)
    assert sorted(tree) == ["batch_stats", "opt_state", "params", "step"]
    with pytest.raises(ValueError, match="keys"):
        read_checkpoint({"params": {}, "step": np.int32(0)}, newest)
    port = Trainer(TrainerConfig(**dict(FIT, optimizer="momentum"),
                                 model_config=dict(LM)), device="cpu")
    with pytest.raises(ValueError):
        port.restore_checkpoint(port.init_state((1, 16), 3),
                                os.path.dirname(newest))


# ------------------------------------------------- optimizer state trees ---

CHAINS = {
    "adam_clip_warmup": dict(optimizer="adam", gradient_clip_norm=1.0,
                             lr_schedule="warmup_cosine", warmup_steps=2),
    "adam": dict(optimizer="adam"),
    "adam_decay_clip_cosine": dict(optimizer="adam", weight_decay=1e-3,
                                   gradient_clip_norm=0.5,
                                   lr_schedule="cosine"),
    "adamw_cosine": dict(optimizer="adamw", weight_decay=1e-2,
                         lr_schedule="cosine"),
    "momentum_decay": dict(optimizer="momentum", weight_decay=1e-3),
    "sgd_cosine_clip": dict(optimizer="sgd", lr_schedule="cosine",
                            gradient_clip_norm=1.0),
    "sgd": dict(optimizer="sgd"),
}


def has_count(tree) -> bool:
    return isinstance(tree, dict) and ("count" in tree or any(
        has_count(v) for v in tree.values()))


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_opt_state_crosses_both_ways(chain):
    """optax's state after one update of a `build_optimizer` chain ->
    the port's state -> optax's tree again, byte-identical in flax's
    format; then one more update from it in each package agrees to f32
    rounding."""
    kw = dict(CHAINS[chain], learning_rate=1e-2)
    cfg = JaxTrainerConfig(**kw)
    tx = build_optimizer(cfg, 10)
    params = init_transformer_lm_params(LM, seed=1)["params"]
    rng = np.random.default_rng(7)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        for _ in range(2)]
    update = jax.jit(lambda g, st, p: (lambda u, st2: (
        jax.tree_util.tree_map(lambda a, b: a + b, p, u), st2))(
        *tx.update(g, st, p)))
    params, state = jax.device_get(update(grads[0], tx.init(params),
                                          params))
    raw = serialization.to_bytes(jax.device_get(state))
    tree = serialization.msgpack_restore(raw)

    names = [n for n, _ in TransformerLM(**LM, device="cpu")
             .named_parameters()]
    port_state = opt_state_from_jax(tree, names)
    assert port_state["count"] == (1 if has_count(tree) else 0)
    assert serialize_tree(opt_state_to_jax(port_state, names)) == raw
    port = Optimizer(TrainerConfig(**kw), 10)
    assert port.init([])["layout"] == port_state["layout"]

    # one more update from the crossed state, in each package
    named = params_from_jax(params)
    got = [named[n].clone() for n in names]
    gnamed = params_from_jax(grads[1])
    port.update([gnamed[n] for n in names], port_state, got)
    ref = params_from_jax(jax.device_get(update(grads[1], state,
                                                params)[0]))
    for name, t in zip(names, got):
        np.testing.assert_allclose(t.numpy(), ref[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
