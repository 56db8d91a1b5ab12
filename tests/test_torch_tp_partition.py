"""The placement layer of the port's model axis against the JAX package,
on the CPU (tests/test_partition.py:63-190): the rule registry and its
invariants, `compatible_spec`, `shard_tree` / `gather_tree` over a 2-D
host mesh, the head-aligned qkv layout, the Trainer's sharding rule over
a whole model, the mesh's model groups, the bridge's model-axis
placements and the model-group collectives (and their gradients).

Specs compare as tuples (JAX `P(None, "model")` is the port's
`(None, "model")`); shard shapes against the JAX leaf's
`sharding.shard_shape` on `jax.devices()[:n]`.  The port's qkv slices
hold each model index's heads of q, k and v (JAX's hold columns
[m 3D/mp, (m+1) 3D/mp) until GSPMD reshards them): the same shapes, and
`gather_tree` gives the reference's layout back byte for byte.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.parallel import partition as J
from mmlspark_tpu.train.trainer import _param_sharding_rule
from mmlspark_tpu_torch.models.definitions import build_model
from mmlspark_tpu_torch.parallel import partition as T
from mmlspark_tpu_torch.parallel.bridge import (put_tree_like,
                                                replicate_tree, shard_batch)
from mmlspark_tpu_torch.parallel.mesh import (ModelSharding, model_group,
                                              model_sharding)
from mmlspark_tpu_torch.parallel.ring import all_gather, all_to_all, psum
from test_torch_tp_train import host_mesh, jax_mesh

RNG = np.random.default_rng(0)
CPU = torch.device("cpu")


def _arr(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


TREE = {
    "block0_w": {
        "qkv": {"kernel": _arr(16, 48), "bias": _arr(48),
                "kernel_scale": _arr(48)},
        "proj": {"kernel": _arr(16, 16), "bias": _arr(16),
                 "kernel_scale": _arr(16)},
        "mlp_up": {"kernel": _arr(16, 64), "bias": _arr(64)},
        "mlp_down": {"kernel": _arr(64, 16), "bias": _arr(16)},
        "moe": {"w_in": _arr(4, 16, 64), "w_out": _arr(4, 64, 16),
                "router": {"kernel": _arr(16, 4)}},
    },
    "tok_embed": {"embedding": _arr(32, 16)},
    "lm_head": {"kernel": _arr(16, 32), "bias": _arr(32)},
    "final_norm_w": {"scale": np.ones(16, np.float32)},
    "odd": {"kernel": _arr(16, 63)},
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_default_rules_and_invariants_match_the_jax_registry():
    got = dict(_flat(T.match_partition_rules(TREE)))
    want = dict(_flat(J.match_partition_rules(TREE)))
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got["block0_w/qkv/kernel"] == (None, "model")
    assert got["block0_w/proj/kernel"] == ("model", None)
    assert got["block0_w/moe/w_in"] == ("model", None, None)
    assert got["block0_w/qkv/kernel_scale"] == ("model",)
    assert got["block0_w/proj/kernel_scale"] == ()
    assert T.rules_to_json(T.DEFAULT_RULES) == J.rules_to_json(
        J.DEFAULT_RULES)


@pytest.mark.parametrize("path,shape,rules", [
    ("loss_scale", (), ((r".*", ("model",)),)),
    ("gate/w", (1,), ((r".*", ("model",)),)),
    ("gate/w", (1, 1), ((r".*", ("model",)),)),
    ("qkv/bias", (48,), ((r".*", ("model",)),)),
    ("odd/bias", (8, 8), ((r".*", ("model",)),)),
    ("mlp_up/kernel_scale", (64,), None),
    ("proj/kernel_scale", (16,), None),
    ("special/kernel", (8, 8), ((r"special/kernel$", ("model", None)),
                                (r"kernel$", (None, "model")),
                                (r".*", ()))),
    ("plain/kernel", (8, 8), ((r"special/kernel$", ("model", None)),
                              (r"kernel$", (None, "model")),
                              (r".*", ()))),
])
def test_leaf_spec_cases_match_jax(path, shape, rules):
    port_rules = T.DEFAULT_RULES if rules is None else rules
    jax_rules = J.DEFAULT_RULES if rules is None else tuple(
        (p, P(*s)) for p, s in rules)
    assert T.leaf_spec(path, shape, port_rules) == tuple(
        J.leaf_spec(path, shape, jax_rules))


def test_unmatched_policy_raise_vs_replicate():
    rules = ((r"kernel$", (None, "model")),)
    with pytest.raises(ValueError, match="no partition rule matched"):
        T.match_partition_rules({"odd": {"w": _arr(4, 4)}}, rules)
    specs = T.match_partition_rules({"odd": {"w": _arr(4, 4)}}, rules,
                                    on_unmatched=T.UNMATCHED_REPLICATE)
    assert specs["odd"]["w"] == ()


@pytest.mark.parametrize("spec,shape", [
    ((None, "model"), (16, 48)), ((None, "model"), (16,)),
    ((None, "model"), (16, 7)), ((None, "expert"), (16, 48)),
    (("model", None, None), (6, 4, 4)), ((), (4, 4)),
])
def test_compatible_spec_demotes_as_jax(spec, shape):
    got = T.compatible_spec(spec, shape, host_mesh(1, 2))
    assert got == tuple(J.compatible_spec(P(*spec), shape, jax_mesh(1, 2)))


def test_shard_gather_roundtrip_on_a_2d_mesh():
    """Every leaf's shard shape is JAX's; gathering gives the leaves back
    byte for byte."""
    mesh, jmesh = host_mesh(2, 2), jax_mesh(2, 2)
    tree = {k: v for k, v in TREE.items() if k != "odd"}
    placed = T.shard_tree(tree, mesh, on_unmatched=T.UNMATCHED_REPLICATE)
    jplaced = J.shard_tree(tree, jmesh, on_unmatched=J.UNMATCHED_REPLICATE)
    jleaves = dict(_flat(jplaced))
    for path, leaf in _flat(placed):
        jleaf = jleaves[path]
        assert isinstance(leaf, T.ModelShards) and len(leaf) == 2, path
        assert tuple(leaf[1].shape) == tuple(
            jleaf.sharding.shard_shape(jleaf.shape)), path
    back = T.gather_tree(placed, mesh)
    for (path, a), (_, b) in zip(_flat(back), _flat(tree)):
        assert isinstance(a, np.ndarray) and a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("mp,heads", [(2, 4), (4, 4), (2, 3)])
def test_qkv_head_aligned_round_trip(mp, heads):
    """Model index m holds columns [m D/mp, (m+1) D/mp) of each of the q,
    k and v thirds; a head count mp does not divide replicates."""
    d = 12 * (heads // np.gcd(heads, 12))
    kernel = _arr(d, 3 * d)
    mesh = host_mesh(1, mp)
    placed = T.shard_tree({"qkv": {"kernel": kernel}}, mesh,
                          n_heads=heads)["qkv"]["kernel"]
    if heads % mp:
        assert placed.dim is None
        return
    assert placed.groups == 3 and placed.dim == 1
    w = d // mp
    for m, part in enumerate(placed):
        want = np.concatenate([kernel[:, g * d + m * w:g * d + (m + 1) * w]
                               for g in range(3)], 1)
        np.testing.assert_array_equal(part.numpy(), want)
    assert T.gather_tree({"k": placed}, mesh)["k"].tobytes() == \
        kernel.tobytes()


@pytest.mark.parametrize("arch,config,mp,kw", [
    ("TransformerLM", {"vocab_size": 32, "d_model": 16, "n_heads": 4,
                       "n_layers": 1, "max_len": 12}, 2, {}),
    ("TransformerLM", {"vocab_size": 30, "d_model": 16, "n_heads": 4,
                       "n_layers": 1, "max_len": 12, "mlp_impl": "moe",
                       "n_experts": 6}, 2, {"expert_parallel": False}),
    ("ConvNetCIFAR10", {"num_classes": 10, "widths": [8, 16, 32],
                        "dense_width": 64}, 2, {}),
    ("MLPClassifier", {"hidden_sizes": [64, 8], "num_classes": 3}, 4, {}),
])
def test_trainer_rule_places_every_leaf_as_jax(arch, config, mp, kw):
    """`param_sharding_rule` over a model's flax paths and shapes gives
    the JAX Trainer's `_param_sharding_rule` spec for every leaf."""
    shape = (1, 12) if arch == "TransformerLM" else \
        (1, 32, 32, 3) if arch.startswith("Conv") else (1, 6)
    jmodel = jax_build_model(arch, config)
    x = np.zeros(shape, np.int32 if arch == "TransformerLM" else np.float32)
    params = jax.eval_shape(jmodel.init, jax.random.key(0), x)["params"]
    jmesh, mesh = jax_mesh(1, mp), host_mesh(1, mp)
    jrule = _param_sharding_rule(jmesh, True, kw.get("expert_parallel",
                                                     True))
    rule = T.param_sharding_rule(mesh, True, kw.get("expert_parallel",
                                                    True))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        p = T.path_str(path)
        want = jrule(path, leaf)
        assert isinstance(want, NamedSharding)
        assert rule(p, tuple(leaf.shape)) == tuple(want.spec), p
    # the port's module leaves split as the flax leaves do
    module = build_model(arch, config, device="cpu")
    module(torch.zeros(shape, dtype=torch.long if arch == "TransformerLM"
                       else torch.float32))
    splits = T.port_splits(module, mesh, rule)
    assert splits
    for name, (dim, groups) in splits.items():
        assert groups == (3 if ".qkv." in name else 1)


def test_mesh_model_groups_and_model_sharding():
    mesh = host_mesh(2, 2)
    assert model_group(mesh, 1) == [mesh.devices[1, 0, 0],
                                    mesh.devices[1, 1, 0]]
    sharding = model_sharding(mesh, (None, "model"))
    assert isinstance(sharding, ModelSharding)
    parts = sharding.place(torch.arange(8.).reshape(2, 4))
    assert [p.tolist() for p in parts] == [[[0., 1.], [4., 5.]],
                                           [[2., 3.], [6., 7.]]]
    # a shape the axis does not divide demotes to replicated
    assert model_sharding(mesh, (None, "model")).place(
        torch.zeros(2, 3)).dim is None


def test_bridge_places_batches_and_trees_over_the_model_axis():
    mesh = host_mesh(2, 2)
    rows = np.arange(10).reshape(5, 2)
    slabs = shard_batch(rows, mesh)          # along data, padded to 6
    assert [s.tolist() for s in slabs] == [[[0, 1], [2, 3], [4, 5]],
                                           [[6, 7], [8, 9], [0, 0]]]
    assert len(shard_batch(rows, mesh, axis="model")) == 2
    rep = replicate_tree({"w": np.ones(3, np.float32)}, mesh)
    assert len(rep["w"]) == 4 and rep["w"][0] is rep["w"][3]
    like = T.shard_tree({"qkv": {"kernel": _arr(4, 12)}}, mesh)
    new = {"qkv": {"kernel": _arr(4, 12)}}
    restored = put_tree_like(new, like)
    assert T.gather_tree(restored, mesh)["qkv"]["kernel"].tobytes() == \
        new["qkv"]["kernel"].tobytes()


def test_model_group_collectives_and_their_gradients():
    """`psum` sums in model order on the home and hands the sum to every
    shard; `all_gather` joins along a dim; `all_to_all` moves slab j of
    every sender to receiver j; gradients flow back through each (the
    backward of a read shared by shards sums them)."""
    a = torch.tensor([1., 2.], requires_grad=True)
    b = torch.tensor([3., 4.], requires_grad=True)
    total = psum([a, b])
    assert all(t.tolist() == [4., 6.] for t in total)
    (total[0].sum() + 2 * total[1].sum()).backward()
    assert a.grad.tolist() == [3., 3.] and b.grad.tolist() == [3., 3.]
    gathered = all_gather([a, b], 0)
    assert gathered[1].tolist() == [1., 2., 3., 4.]
    x = torch.arange(8.).reshape(4, 2)
    moved = all_to_all([x], [CPU, CPU], 0, 0)
    assert [m.tolist() for m in moved] == [[[0., 1.], [2., 3.]],
                                           [[4., 5.], [6., 7.]]]
    two = all_to_all([x, x + 10], [CPU, CPU], 0, 1)
    assert two[1].tolist() == [[4., 5., 14., 15.], [6., 7., 16., 17.]]
