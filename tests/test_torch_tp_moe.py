"""Expert parallelism of the port against the JAX package on the CPU
(tests/test_parallel_trainer.py:144-225, tests/test_moe.py:147-179): the
mixture-of-experts LM of `EP_MODEL` (8 experts, `expert_axis="model"`)
over (data 2, model 2) host shards and `jax.devices()[:4]`.

  * The Trainer places each (E, D, H) / (E, H, D) expert stack on its
    leading dim over 'model' (4 experts a shard) and replicates the
    router; `expert_parallel=False` lets the fallback split a stack's
    trailing dim instead, and so does an expert count mp does not divide
    (6 experts at model 4): every shard shape equals the JAX Trainer's at
    init.
  * The fit against the JAX Trainer's: tests/test_torch_tp_moe_fit.py.
  * The expert-parallel forward of the model-group replica: logits, the
    sown load-balance and z losses and the overflow fraction, and the
    gradient of the expert stacks, against the JAX forward with its
    stacks placed by `expert_parallel_rules` (f32, 1e-5).
  * Greedy decode over a model axis at `moe_group_size=1` equals one
    device's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.ops.moe import expert_parallel_rules as jax_ep_rules
from mmlspark_tpu.train import Trainer as JaxTrainer
from mmlspark_tpu.train import TrainerConfig as JaxTrainerConfig
from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
from mmlspark_tpu_torch.models.generate import DecodeEngine
from mmlspark_tpu_torch.parallel.partition import ModelShards
from test_torch_dp_train import leaves
from test_torch_tp_train import host_mesh, jax_mesh, jax_shard_shapes

EP_MODEL = {"vocab_size": 32, "d_model": 32, "n_heads": 4, "n_layers": 1,
            "max_len": 12, "dtype": "float32", "mlp_impl": "moe",
            "n_experts": 8, "expert_axis": "model", "moe_group_size": 24}
RNG = np.random.default_rng(5)
TOKS = RNG.integers(0, 32, (16, 12)).astype(np.int32)
TGTS = np.roll(TOKS, -1, axis=1)


def fit_config(**kw):
    return dict(architecture="TransformerLM", model_config=dict(EP_MODEL),
                optimizer="adam", learning_rate=1e-2, epochs=2,
                batch_size=8, loss="softmax_xent", seed=0,
                shuffle_each_epoch=False, aux_loss_weight=0.01,
                numerics_cadence=0, **kw)


def initial(model=EP_MODEL):
    return ModelBundle.init("TransformerLM", model, seed=2)


def jax_init(model=EP_MODEL):
    init = initial(model)
    return JaxModelBundle(init.architecture, init.config, init.variables)


def port_shapes(trainer) -> dict:
    """{flax path of a moe leaf: the shard shape model index 0 holds}."""
    _, shards = trainer._replicas.rows[0]
    out = {}
    for name, t in trainer.module.named_parameters():
        if ".moe." in name:
            held = shards[0].get_parameter(name) \
                if name in trainer.param_splits else t
            path = name.replace(".", "/").replace("router/weight",
                                                  "router/kernel")
            shape = tuple(held.shape)
            out[path] = shape[::-1] if path.endswith("kernel") else shape
    return out


@pytest.mark.parametrize("model,mp,kw", [
    (EP_MODEL, 2, {}),
    (EP_MODEL, 2, {"expert_parallel": False}),
    ({**EP_MODEL, "n_experts": 6, "moe_group_size": 12}, 4, {}),
])
def test_expert_stacks_are_placed_as_the_jax_trainer_places_them(model, mp,
                                                                  kw):
    trainer = Trainer(TrainerConfig(**{**fit_config(**kw),
                                       "model_config": dict(model)}),
                      mesh=host_mesh(2, mp))
    trainer.init_state((1, 12), 1, initial_bundle=initial(model))
    jt = JaxTrainer(JaxTrainerConfig(**{**fit_config(**kw),
                                        "model_config": dict(model)}),
                    mesh=jax_mesh(2, mp))
    state = jt.init_state((1, 12), 1, initial_bundle=jax_init(model),
                          input_dtype=np.int32)
    jax_shapes = {k: v for k, v in jax_shard_shapes(state.params).items()
                  if "/moe/" in k}
    assert port_shapes(trainer) == jax_shapes
    splits = trainer.param_splits
    router = "block0_w.moe.router.weight"
    assert router not in splits
    ep = kw.get("expert_parallel", True) and model["n_experts"] % mp == 0
    for leaf in ("w_in", "w_out"):
        dim, _ = splits[f"block0_w.moe.{leaf}"]
        assert dim == (0 if ep else 2)


def test_expert_parallel_forward_and_gradient_match_jax():
    """The model-group forward (each shard runs its 4 experts' products)
    and its stacks' gradient against the JAX forward on its mesh."""
    model = {**EP_MODEL, "moe_router_k": 2, "moe_group_size": 8}
    init = initial(model)
    toks = RNG.integers(0, 32, (4, 12)).astype(np.int32)
    lm = jax_build_model("TransformerLM", model)
    mesh = jax_mesh(2, 2)
    params = jax.device_put(init.variables["params"],
                            jax_ep_rules(init.variables["params"], mesh))
    assert not params["block0_w"]["moe"]["w_in"].sharding.is_fully_replicated

    def fwd(p, t):
        out, state = lm.apply({"params": p}, t,
                              mutable=["losses", "metrics"])
        return out, state

    out, state = jax.jit(fwd)(params, jnp.asarray(toks))
    grad = jax.jit(jax.grad(lambda p, t: fwd(p, t)[0].sum()))(
        params, jnp.asarray(toks))
    trainer = Trainer(TrainerConfig(**{**fit_config(),
                                       "model_config": dict(model)}),
                      mesh=host_mesh(1, 2))
    trainer.init_state((1, 12), 1, initial_bundle=init)
    home, shards = trainer._replicas.rows[0]
    trainer._replicas.zero_grad()
    logits, sown = home(torch.as_tensor(toks), collect=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(out),
                               rtol=1e-5, atol=1e-5)
    for col in ("losses", "metrics"):
        for (path, g), (_, w) in zip(
                leaves({k: v.detach().numpy()
                        for k, v in _flat(sown[col]).items()}),
                leaves({k: np.asarray(v[0]) if isinstance(v, tuple)
                        else np.asarray(v)
                        for k, v in _flat(state[col]).items()})):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=path)
    logits.sum().backward()
    grads = dict(zip(trainer._names, trainer._replicas.reduced_grads()))
    for leaf in ("w_in", "w_out"):
        np.testing.assert_allclose(
            grads[f"block0_w.moe.{leaf}"].numpy(),
            np.asarray(grad["block0_w"]["moe"][leaf]), rtol=1e-4, atol=1e-5)
    w_in = shards[1].get_parameter("block0_w.moe.w_in")
    assert tuple(w_in.shape) == (4, 32, 128) and w_in.grad is not None


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_expert_parallel_greedy_decode_equals_one_device():
    model = {**EP_MODEL, "moe_group_size": 1, "max_len": 32}
    module = initial(model).module("cpu")
    prompts = RNG.integers(0, 32, (4, 8))
    true_len = np.array([8, 3, 5, 6])
    want = DecodeEngine(module, 8, device="cpu").generate(prompts, true_len)
    engine = DecodeEngine(module, 8, device="cpu", mesh=host_mesh(2, 2))
    got = engine.generate(prompts, true_len)
    np.testing.assert_array_equal(got, want)
    group = engine._weights_on(torch.device("cpu"))
    assert isinstance(group.blocks[0].moe.w_in, ModelShards)
    assert [tuple(t.shape) for t in group.blocks[0].moe.w_in] == \
        [(4, 32, 128)] * 2
