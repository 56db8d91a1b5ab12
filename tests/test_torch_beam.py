"""The port's beam search against the JAX package's `make_beam_search_fn`
and its `TextGenerator(beamWidth=...)`, on the CPU at f32: tokens (B, W,
P+N) best-first equal, scores (B, W) within rel 1e-5 (the two sides sum
the same log-probabilities in different orders); a prompt of 520 tokens
prefills through the flash path on both sides.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu import DataTable as JaxDataTable
from mmlspark_tpu.models import ModelBundle as JaxModelBundle
from mmlspark_tpu.models.definitions import build_model as jax_build_model
from mmlspark_tpu.models.generate import TextGenerator as JaxTextGenerator
from mmlspark_tpu.models.generate import \
    make_beam_search_fn as jax_make_beam_search_fn
from mmlspark_tpu_torch import DataTable, TextGenerator
from mmlspark_tpu_torch.core.table import object_column
from mmlspark_tpu_torch.models import (ModelBundle, beam_search,
                                       make_beam_search_fn)

CFG = {"vocab_size": 64, "d_model": 32, "n_heads": 4, "n_layers": 2,
       "max_len": 528, "dtype": "float32"}
# (prompt rows, prompt length, max_new_tokens, beam width)
CASES = {"short": (2, 5, 6, 3), "flash_prefill": (1, 520, 3, 2)}
# the stage at width 1: each row's beam is its greedy decode
STAGE_ROWS = (4, 7, 4)
STAGE_NEW, STAGE_WIDTH = 5, 1


@pytest.fixture(scope="module")
def bundle():
    return ModelBundle.init("TransformerLM", CFG, seed=2)


def _prompts(case):
    rows, plen, _, _ = CASES[case]
    return np.random.default_rng(plen).integers(
        0, CFG["vocab_size"], (rows, plen)).astype(np.int32)


def _stage_rows():
    rng = np.random.default_rng(7)
    return [rng.integers(0, CFG["vocab_size"], (n,)).astype(np.int32)
            for n in STAGE_ROWS]


@pytest.fixture(scope="module")
def jax_side(bundle):
    """Every case's JAX (tokens, scores) and the JAX stage's output."""
    module = jax_build_model("TransformerLM", CFG)
    variables = jax.tree_util.tree_map(jnp.asarray, bundle.variables)

    def case_job(case):
        _, plen, new, width = CASES[case]
        fn = jax_make_beam_search_fn(module, plen, new, width)
        tokens, scores = fn(variables, jnp.asarray(_prompts(case)))
        return np.asarray(tokens), np.asarray(scores)

    def stage_job():
        jb = JaxModelBundle("TransformerLM", dict(CFG), bundle.variables, {})
        stage = JaxTextGenerator(jb, inputCol="p", outputCol="out",
                                 maxNewTokens=STAGE_NEW,
                                 beamWidth=STAGE_WIDTH)
        return list(stage.transform(JaxDataTable(
            {"p": object_column(_stage_rows())}))["out"])

    with ThreadPoolExecutor(4) as pool:
        jobs = {case: pool.submit(case_job, case) for case in CASES}
        jobs["stage"] = pool.submit(stage_job)
    return {key: job.result() for key, job in jobs.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_tokens_and_scores_match_jax(bundle, jax_side, case):
    _, plen, new, width = CASES[case]
    want_tokens, want_scores = jax_side[case]
    tokens, scores = beam_search(bundle.module("cpu"), _prompts(case), new,
                                 beam_width=width)
    assert tokens.dtype == np.int32
    assert tokens.shape == want_tokens.shape == (len(_prompts(case)), width,
                                                 plen + new)
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-5, atol=0)
    # best-first, and each score is its beam's summed log-probabilities
    assert (np.diff(scores, axis=1) <= 0).all()
    module = bundle.module("cpu")
    with torch.inference_mode():
        logp = torch.log_softmax(module(torch.as_tensor(
            tokens[0, 0], dtype=torch.long)[None]), -1)[0]
    gen = torch.as_tensor(tokens[0, 0, plen:], dtype=torch.long)
    recomputed = logp[plen - 1:-1].gather(1, gen[:, None]).sum().item()
    assert recomputed == pytest.approx(float(scores[0, 0]), rel=1e-5)


def test_beam_width_validation(bundle):
    module = bundle.module("cpu")
    with pytest.raises(ValueError, match="beam_width"):
        make_beam_search_fn(module, 4, 3, 0)
    with pytest.raises(ValueError, match="vocabulary"):
        make_beam_search_fn(module, 4, 3, CFG["vocab_size"] + 1)
    with pytest.raises(ValueError, match="max_len"):
        make_beam_search_fn(module, 520, 9, 2)
    fn = make_beam_search_fn(module, 4, 3, 2)
    with pytest.raises(ValueError, match="prompt_len=4"):
        fn(np.zeros((1, 5), np.int32))


def test_text_generator_beam_matches_jax_stage(bundle, jax_side):
    """`beamWidth` emits each row's best beam, rows grouped by length; at
    width 1 that is the greedy decode."""
    table = DataTable({"p": object_column(_stage_rows())})
    got = TextGenerator(bundle, device="cpu", inputCol="p", outputCol="out",
                        maxNewTokens=STAGE_NEW,
                        beamWidth=STAGE_WIDTH).transform(table)["out"]
    greedy = TextGenerator(bundle, device="cpu", inputCol="p",
                           outputCol="out", maxNewTokens=STAGE_NEW,
                           cacheChunk=16).transform(table)["out"]
    for g, w, e in zip(got, jax_side["stage"], greedy):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        np.testing.assert_array_equal(np.asarray(g), np.asarray(e))
