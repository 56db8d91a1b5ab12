"""The port's vision and tabular scoring models (`MLPClassifier`,
`LinearModel`, `ConvNetCIFAR10`, `ResNet` basic and bottleneck,
`resnet50`) against the flax models of the JAX package, on the CPU.

Both packages get the same weights: the port's seeded init in the flax
layout, with random non-zero BatchNorm statistics (scale and var in
[0.5, 1.5], bias and mean ~ N(0, 0.2)), fed to flax as the variables.
Tolerances: f32 outputs and every sown node within rtol 1e-5 / atol
1e-5 (of the node's scale); bf16 logits within 2e-2 of max |logit| with
identical argmax; int8 weights (`quantize_bundle`) against the JAX
`quantized_call` forward within 2e-2 of max |logit|, identical argmax.
"""

import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import load_bundle as jax_load_bundle
from mmlspark_tpu.models import save_bundle as jax_save_bundle
from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.quant import quantize_bundle as jax_quantize_bundle
from mmlspark_tpu.quant import quantized_call
from mmlspark_tpu.quant.modules import quant_conv_apply as jax_quant_conv
from mmlspark_tpu_torch.models import (ModelBundle, load_bundle, resnet50,
                                       save_bundle)
from mmlspark_tpu_torch.models.bundle import (calibrated_bundle,
                                              variables_from_jax,
                                              variables_to_jax)
from mmlspark_tpu_torch.models.definitions import BatchNorm, same_pads
from mmlspark_tpu_torch.quant import quantize_bundle
from mmlspark_tpu_torch.quant.modules import quant_conv_apply

# (architecture, config, input shape): stride-2 SAME convs and pools on
# even and odd sizes, both block kinds, a projection and an identity block
CASES = {
    "mlp": ("MLPClassifier", {"hidden_sizes": [16, 8], "num_classes": 3},
            (6, 11)),
    "linear": ("LinearModel", {"num_outputs": 2}, (5, 7)),
    "convnet": ("ConvNetCIFAR10", {"widths": [4, 8, 8], "dense_width": 16},
                (3, 32, 32, 3)),
    "convnet_odd": ("ConvNetCIFAR10", {"widths": [4, 4, 8],
                                       "dense_width": 8}, (2, 21, 19, 1)),
    "resnet_basic": ("ResNet", {"stage_sizes": [2, 1], "widths": [64, 8],
                                "num_classes": 5, "block_kind": "basic"},
                     (2, 17, 15, 3)),
    "resnet_bottleneck": ("ResNet", {"stage_sizes": [1, 2, 1],
                                     "widths": [4, 8, 8], "num_classes": 7,
                                     "block_kind": "bottleneck"},
                          (3, 33, 31, 3)),
}


def random_stats(variables: dict, seed: int) -> dict:
    """The tree with BatchNorm scale/var in [0.5, 1.5] and bias/mean
    ~ N(0, 0.2), so every BatchNorm term and every bottleneck branch is
    live."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean",) or (k == "bias" and "scale" in node):
                out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(variables)


@functools.cache
def make_bundle(case: str, dtype: str = "float32") -> ModelBundle:
    arch, cfg, shape = CASES[case]
    b = ModelBundle.init(arch, {**cfg, "dtype": dtype}, seed=1,
                         input_shape=shape)
    return ModelBundle(b.architecture, b.config,
                       random_stats(b.variables, seed=2))


def inputs(case: str, seed: int = 3) -> np.ndarray:
    shape = CASES[case][2]
    return np.random.default_rng(seed).uniform(
        0, 4 if len(shape) == 4 else 1, shape).astype(np.float32)


def flax_apply(bundle, x, quantized: bool = False):
    """The flax model's output and sown nodes in its call order (jitted:
    eager flax costs seconds a model here; the jit's output sorts dict
    keys, so the order is read while tracing), under `quantized_call` for
    an int8 tree."""
    module = jax_build_model(bundle.architecture, bundle.config)
    order = []

    def forward(variables, x):
        with quantized_call() if quantized else contextlib.nullcontext():
            out, state = module.apply(variables, x,
                                      mutable=["intermediates"])
        order.extend(k for k, v in state["intermediates"].items()
                     if not isinstance(v, dict))
        return out, state

    out, state = jax.jit(forward)(
        jax.tree_util.tree_map(jnp.asarray, bundle.variables), x)
    inter = state["intermediates"]
    nodes = {k: np.asarray(inter[k][0], np.float32) for k in order}
    return np.asarray(out, np.float32), nodes


@functools.cache
def quantized(case: str, mode: str) -> tuple:
    """(port bundle, JAX bundle) of `case` quantized to `mode`."""
    bundle = make_bundle(case)
    return quantize_bundle(bundle, mode), jax_quantize_bundle(
        JaxModelBundle(bundle.architecture, bundle.config, bundle.variables),
        mode)


@functools.cache
def resnet_bundle(stage_sizes: tuple) -> ModelBundle:
    """ResNet at resnet50()'s published widths (bottleneck 64-512, 1000
    classes), at `stage_sizes`."""
    config = {**resnet50(dtype="float32", device="cpu").config,
              "stage_sizes": list(stage_sizes)}
    bundle = ModelBundle.init("ResNet", config, seed=0,
                              input_shape=(1, 32, 32, 3))
    return ModelBundle(bundle.architecture, bundle.config,
                       random_stats(bundle.variables, seed=8))


R50_INPUT = np.random.default_rng(9).uniform(0, 1, (2, 32, 32, 3)).astype(
    np.float32)

CALIBRATED = ("convnet", "resnet_basic", "resnet_bottleneck")


@functools.cache
def calibrated(case: str) -> tuple:
    """(bundle made input-dependent by `calibrated_bundle` over 16 seeded
    images of `case`, the images)."""
    arch, cfg, shape = CASES[case]
    images = np.random.default_rng(10).uniform(
        0, 4, (16,) + shape[1:]).astype(np.float32)
    bundle = ModelBundle.init(arch, {**cfg, "dtype": "float32"}, seed=1,
                              input_shape=shape)
    return calibrated_bundle(bundle, images, seed=2, branch_scale=0.5), images


# every flax forward the file compares with, computed once on threads (a
# jit compile each)
REFS = {
    **{("f32", c): lambda c=c: (make_bundle(c), inputs(c), False)
       for c in CASES},
    **{("bf16", c): lambda c=c: (make_bundle(c, "bfloat16"), inputs(c, 4),
                                 False)
       for c in ("convnet", "resnet_bottleneck", "mlp")},
    **{("quantized", m, c): lambda c=c, m=m: (quantized(c, m)[1],
                                              inputs(c, 5), m == "int8")
       for c in ("convnet", "resnet_bottleneck") for m in ("int8", "bf16")},
    ("wide",): lambda: (resnet_bundle((1, 1, 1, 1)), R50_INPUT, False),
    **{("calibrated", c): lambda c=c: (*calibrated(c), False)
       for c in CALIBRATED},
}


@pytest.fixture(scope="module")
def refs():
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(lambda k=k: flax_apply(*REFS[k]()))
                   for k in REFS}
        return {k: f.result() for k, f in futures.items()}


def port_apply(bundle, x):
    with torch.inference_mode():
        out, nodes = bundle.module("cpu")(torch.from_numpy(x))
    return out.numpy(), {k: v.float().numpy() for k, v in nodes.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_output_and_every_node_match_flax(refs, case):
    ref, ref_nodes = refs["f32", case]
    got, nodes = port_apply(make_bundle(case), inputs(case))
    assert list(nodes) == list(ref_nodes)   # names, in flax's call order
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    for name, want in ref_nodes.items():
        assert nodes[name].shape == want.shape, name
        np.testing.assert_allclose(nodes[name], want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("case", ["convnet", "resnet_bottleneck", "mlp"])
def test_bf16_logits_within_tolerance_and_same_argmax(refs, case):
    ref, _ = refs["bf16", case]
    got, _ = port_apply(make_bundle(case, "bfloat16"), inputs(case, 4))
    # bf16 rounds at different points in the two frameworks
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("case", ["convnet", "resnet_bottleneck"])
def test_quantized_bundles_score_as_the_jax_quantized_forward(refs, case,
                                                              mode):
    ref, _ = refs["quantized", mode, case]
    x = inputs(case, 5)
    module = quantized(case, mode)[0].module("cpu")
    if mode == "int8":
        kinds = {type(m).__name__ for m in module.modules()}
        assert {"Int8Conv", "Int8Dense"} <= kinds
        assert all(b.dtype != torch.float32 for n, b in module.named_buffers()
                   if n.endswith(".weight"))
    with torch.inference_mode():
        got = module(torch.from_numpy(x))[0].numpy()
    assert np.abs(got - ref).max() <= 2e-2 * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_int8_conv_rounds_the_product_once_before_the_scale():
    """The one rounding the port adds (quant/modules.py): a bf16 product
    before the f32 scale, where XLA keeps the f32 accumulator.  Pinned:
    one bf16 rounding of the product and one ulp of the output apart at
    most, and not identical."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 9, 8)).astype(np.float32)
    q = rng.integers(-127, 128, (3, 3, 8, 16)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, 16).astype(np.float32)
    bias = rng.normal(size=16).astype(np.float32)

    class Mod:  # the nn.Conv fields quant_conv_apply reads
        input_dilation = kernel_dilation = strides = 1
        padding, dtype, feature_group_count = "SAME", jnp.bfloat16, 1

    ref = np.asarray(jax_quant_conv(Mod(), jnp.asarray(x), jnp.asarray(q),
                                    jnp.asarray(scale), jnp.asarray(bias)),
                     np.float32)
    got = quant_conv_apply(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(np.ascontiguousarray(q.transpose(3, 2, 0, 1))),
        torch.from_numpy(scale), torch.from_numpy(bias), (1, 1), (1, 1),
        torch.bfloat16).float().permute(0, 2, 3, 1).numpy()
    # the product's extra rounding moves the pre-bias value by at most
    # 2^-9 of its size (|ref - bias|, within the output's rounding), and
    # the two final bf16 casts then land at most one ulp (2^-7 |ref|) apart
    bound = 2 ** -8 * np.abs(ref - bias) + 2 ** -7 * np.abs(ref) + 1e-6
    assert (np.abs(got - ref) <= bound).all()
    assert not np.array_equal(got, ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_tree_has_flax_names_and_shapes(case):
    arch, cfg, shape = CASES[case]
    got = ModelBundle.init(arch, cfg, seed=0, input_shape=shape)
    module = jax_build_model(arch, cfg)
    assert got.config == JaxModelBundle.from_module(module, {}).config
    ref = jax.eval_shape(module.init, jax.random.key(0),
                         jnp.zeros(shape, jnp.float32))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), dict(ref))
    assert jax.tree_util.tree_map(lambda a: a.shape, got.variables) == shapes
    if arch == "ResNet" and cfg["block_kind"] == "bottleneck":
        # the zero-initialised scale of each bottleneck's last BatchNorm
        blocks = {k: v for k, v in got.variables["params"].items()
                  if k.startswith("ResNetBottleneckBlock_")}
        assert blocks and all(not b["BatchNorm_2"]["scale"].any()
                              for b in blocks.values())


def test_init_matches_flax_initialisers_in_distribution():
    got = ModelBundle.init("ConvNetCIFAR10", {"widths": [32, 32, 64],
                                              "dense_width": 256},
                           seed=0, input_shape=(1, 32, 32, 3))
    p = got.variables["params"]
    for name, fan_in in (("conv2_w", 9 * 32), ("dense1_w", 4 * 4 * 64)):
        k = p[name]["kernel"]
        assert abs(k.std() * fan_in ** 0.5 - 1.0) < 0.05
        assert np.abs(k).max() <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
        assert not p[name]["bias"].any()


def test_bundles_with_batch_stats_load_across_packages(refs, tmp_path):
    bundle = make_bundle("resnet_bottleneck")
    x = inputs("resnet_bottleneck")
    ref, _ = refs["f32", "resnet_bottleneck"]
    save_bundle(bundle, str(tmp_path / "port"))
    jb = jax_load_bundle(str(tmp_path / "port"))
    assert set(jb.variables) == {"params", "batch_stats"}
    same = jax.tree_util.tree_map(np.array_equal, jb.variables,
                                  bundle.variables)
    assert all(jax.tree_util.tree_leaves(same))
    jax_save_bundle(jb, str(tmp_path / "jax"))
    back = load_bundle(str(tmp_path / "jax"))
    with open(tmp_path / "port" / "params.msgpack", "rb") as f1, \
            open(tmp_path / "jax" / "params.msgpack", "rb") as f2:
        assert f1.read() == f2.read()
    got, _ = port_apply(back, x)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_state_dict_round_trips_through_the_flax_layout():
    bundle = make_bundle("resnet_basic")
    module = bundle.module("cpu")
    again = variables_to_jax(module.state_dict())
    same = jax.tree_util.tree_map(np.array_equal, again, bundle.variables)
    assert all(jax.tree_util.tree_leaves(same))
    state = variables_from_jax(again)
    assert state["BatchNorm_0.mean"].shape == (64,)
    assert state["stem_conv.weight"].shape == (64, 3, 7, 7)
    assert ModelBundle.from_module(module).config == bundle.config


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (32, 7, 2, (2, 3)), (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)),
    (56, 3, 2, (0, 1)), (56, 1, 2, (0, 0)), (17, 3, 2, (1, 1)),
    (32, 3, 1, (1, 1))])
def test_same_padding_is_xla_s(size, kernel, stride, pads):
    assert same_pads(size, kernel, stride) == pads
    want = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert tuple(want[0]) == pads


def _full_width_matches_flax(bundle, ref, ref_nodes):
    got, nodes = port_apply(bundle, R50_INPUT)
    assert got.shape == (2, 1000) and nodes["pool"].shape == (2, 2048)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(nodes["pool"], ref_nodes["pool"], rtol=1e-5,
                               atol=1e-5 * np.abs(ref_nodes["pool"]).max())


@pytest.mark.slow
def test_resnet50_full_width_matches_flax():
    """resnet50() at its published widths and depth (1000 classes, pool
    2048 wide) on a 32 x 32 input, batch 2, at f32 (slow: its init and
    compile take ~5 s; `test_full_width_resnet_stand_in_matches_flax`
    runs the widths at one block a stage)."""
    bundle = resnet_bundle((3, 4, 6, 3))
    assert bundle.config == resnet50(dtype="float32", device="cpu").config
    _full_width_matches_flax(bundle, *flax_apply(bundle, R50_INPUT))


def test_full_width_resnet_stand_in_matches_flax(refs):
    """The stand-in: resnet50()'s widths, stage sizes (1, 1, 1, 1)."""
    _full_width_matches_flax(resnet_bundle((1, 1, 1, 1)), *refs["wide",])


@pytest.mark.parametrize("case", CALIBRATED)
def test_calibrated_bundle_normalises_each_batchnorm_and_centres_logits(
        refs, case):
    """`calibrated_bundle`: every BatchNorm's input over the calibration
    images has per-channel mean 0 and variance 1 after its own statistics
    (channels ReLU left all zero aside), its scale is drawn in [0.5, 1.5]
    (times the branch scale where flax initialises it to zero), and the
    flax forward of the saved tree gives logits of mean 0 in every class;
    the same seed gives the same tree."""
    bundle, images = calibrated(case)
    module = bundle.module("cpu")
    seen = []

    def check(bn, args):
        x = args[0].double()
        z = (x - bn.mean.double()[:, None, None]) \
            / bn.var.double()[:, None, None].clamp_min(1e-30).sqrt()
        live = bn.var.double() > 1e-8
        seen.append(bool(live.any()))
        mean, var = z.mean((0, 2, 3))[live], z.var((0, 2, 3),
                                                   unbiased=False)[live]
        assert torch.allclose(mean, torch.zeros_like(mean), atol=1e-4)
        assert torch.allclose(var, torch.ones_like(var), atol=1e-3)
        low, high = (0.25, 0.75) if bn.zero_scale else (0.5, 1.5)
        assert ((bn.scale >= low) & (bn.scale <= high)).all()

    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for bn in norms:
        bn.register_forward_pre_hook(check)
    with torch.inference_mode():
        module(torch.from_numpy(images))
    assert len(seen) == len(norms) and all(seen)
    ref, _ = refs["calibrated", case]
    assert np.abs(ref.mean(0)).max() <= 1e-5 * np.abs(ref).max()
    again = calibrated_bundle(
        ModelBundle.init(bundle.architecture, bundle.config, seed=1,
                         input_shape=CASES[case][2]), images, seed=2,
        branch_scale=0.5)
    for a, b in zip(variables_from_jax(bundle.variables).values(),
                    variables_from_jax(again.variables).values()):
        assert torch.equal(a, b)
