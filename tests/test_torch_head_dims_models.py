"""The repo's small LMs, whose head dims are 8 and 16, through the port's
serving path against the JAX package, on the CPU.

Two configurations: the LM example's (examples/example_401_lm_generation.py:
vocab 16, d_model 32 over 4 heads, head dim 8, 2 layers, max_len 40) and
`TransformerLM`'s default widths (mmlspark_tpu/models/definitions.py:
vocab 256, d_model 128 over 8 heads, head dim 16, 2 layers, max_len 2048),
both at f32.  The weights are the JAX package's own init (the flax
module's `init`, jitted: one program instead of one per op), carried into
the port as the bundle's parameter tree; the prompts are numpy arrays.
`TextGenerator`'s greedy tokens must be IDENTICAL in both packages: at
f32 the two sides differ only in summation order, far below these
models' top-2 logit gaps.
On the card the same calls run K4 at every decode step (and K1 at
prefills of 512 tokens and more); chip_smoke phase 16 drives them there.
"""

import jax
import numpy as np
import pytest

from mmlspark_tpu import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models import TextGenerator as JaxTextGenerator
from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu_torch import DataTable, TextGenerator
from mmlspark_tpu_torch.models import ModelBundle

EXAMPLE = {"vocab_size": 16, "d_model": 32, "n_heads": 4, "n_layers": 2,
           "max_len": 40, "dtype": "float32"}
DEFAULT_WIDTHS = {"vocab_size": 256, "d_model": 128, "n_heads": 8,
                  "n_layers": 2, "max_len": 2048, "dtype": "float32"}


@pytest.mark.parametrize("config,lengths,new", [
    (EXAMPLE, [8, 8, 8, 8], 12),            # the example's 4 prompts x 12
    (DEFAULT_WIDTHS, [20, 31, 17, 26], 16)])  # ragged in one bucket
def test_small_head_dim_lm_generates_the_jax_tokens(config, lengths, new):
    head_dim = config["d_model"] // config["n_heads"]
    assert head_dim in (8, 16)
    module = jax_build_model("TransformerLM", config)
    variables = jax.jit(module.init)(jax.random.key(3),
                                     np.zeros((1, 8), np.int32))
    jax_bundle = JaxModelBundle.from_module(
        module, jax.tree_util.tree_map(np.asarray, variables))
    bundle = ModelBundle("TransformerLM", dict(config), jax_bundle.variables)
    rng = np.random.default_rng(head_dim)
    rows = [rng.integers(0, config["vocab_size"], n).astype(np.int32)
            for n in lengths]
    params = dict(inputCol="prompt", maxNewTokens=new, cacheChunk=16)
    ref = JaxTextGenerator(jax_bundle, **params).transform(
        JaxDataTable({"prompt": rows}))["generated"]
    got = TextGenerator(bundle, device="cpu", **params).transform(
        DataTable({"prompt": rows}))["generated"]
    assert len(got) == len(rows)
    for g, r, prompt in zip(got, ref, rows):
        assert len(g) == len(prompt) + new
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
        np.testing.assert_array_equal(g[:len(prompt)], prompt)
