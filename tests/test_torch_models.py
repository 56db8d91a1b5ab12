"""The port's TransformerLM and bundles against the JAX package, on the
CPU: forward logits against `module.apply`, and bundles written by either
package loading in the other.

Both packages get the same weights: the port's seeded numpy init, fed to
flax as the parameter tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models import load_bundle as jax_load_bundle
from mmlspark_tpu.models import save_bundle as jax_save_bundle
from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu_torch.models import ModelBundle, load_bundle, save_bundle

CFG = {"vocab_size": 128, "d_model": 64, "n_heads": 4, "n_layers": 2,
       "max_len": 640, "dtype": "float32"}


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=0)


@pytest.fixture(scope="module")
def jax_lm(bundle):
    module = jax_build_model("TransformerLM", CFG)
    variables = jax.tree_util.tree_map(jnp.asarray, bundle.variables)
    return module, variables


def _rows(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
            for n in lengths]


# ------------------------------------------------------------ forward ---

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_module_apply(bundle, dtype):
    cfg = {**CFG, "dtype": dtype}
    tokens = np.stack(_rows([24, 24], seed=1))
    ref = jax_build_model("TransformerLM", cfg).apply(bundle.variables,
                                                      jnp.asarray(tokens))
    module = ModelBundle("TransformerLM", cfg, bundle.variables).module("cpu")
    with torch.inference_mode():
        got = module(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == tuple(ref.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    else:
        # bf16 rounds at different points in the two frameworks: the
        # logits agree to a few bf16 ulps of their O(1) scale
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=0.1)
        assert np.abs(got.numpy() - np.asarray(ref)).mean() < 0.01


# ------------------------------------------------------------ bundles ---

def test_bundle_written_by_jax_loads_in_port(tmp_path, jax_lm):
    module, variables = jax_lm
    jax_save_bundle(JaxModelBundle.from_module(module, variables),
                    str(tmp_path / "b"))
    got = load_bundle(str(tmp_path / "b"))
    assert got.architecture == "TransformerLM"
    assert got.config == JaxModelBundle.from_module(module, variables).config
    flat_ref = jax.tree_util.tree_leaves_with_path(variables)
    for path, leaf in flat_ref:
        node = got.variables
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    tokens = np.stack(_rows([24, 24], seed=2))
    with torch.inference_mode():
        logits = got.module("cpu")(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(module.apply(variables, tokens)),
        rtol=1e-5, atol=1e-5)


def test_bundle_written_by_port_loads_in_jax(tmp_path, bundle):
    save_bundle(bundle, str(tmp_path / "b"))
    got = jax_load_bundle(str(tmp_path / "b"))
    assert got.architecture == bundle.architecture
    assert got.config == bundle.config
    ref = jax.tree_util.tree_leaves(bundle.variables)
    leaves = jax.tree_util.tree_leaves(got.variables)
    assert len(ref) == len(leaves)
    for a, b in zip(ref, leaves):
        np.testing.assert_array_equal(np.asarray(b), a)
    again = load_bundle(str(tmp_path / "b"))
    for a, b in zip(ref, jax.tree_util.tree_leaves(again.variables)):
        np.testing.assert_array_equal(b, a)


