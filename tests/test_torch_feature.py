"""The port's featurization (`mmlspark_tpu_torch/feature/`) against the JAX
package's, on the CPU, at small sizes with numpy seeds.

  * `Featurize` / `AssembleFeatures` on the census, flight and collinear
    tables, one-hot on and off: the features and the block plan in the
    column metadata bit-identical; saved plans load both ways.
  * The hashing helpers: identical slots and counts.
  * The text chain: the port's native hash rows byte-identical to the JAX
    package's native path, on ASCII and non-ASCII documents (the latter
    recomputed by the stages, and counted so in `fused_rows`); the fused
    path byte-identical to the staged one; IDF weights within 1e-6;
    `TextFeaturizer` end to end.
  * `Word2Vec` within 1e-4 of max |v| of the JAX package's (same vocabulary,
    the same numpy draws).
"""

import numpy as np
import pytest

from mmlspark_tpu import native_loader as jax_native
from mmlspark_tpu.core.pipeline import load_stage as jax_load_stage
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.feature import Featurize as JaxFeaturize
from mmlspark_tpu.feature import TextFeaturizer as JaxTextFeaturizer
from mmlspark_tpu.feature import Tokenizer as JaxTokenizer
from mmlspark_tpu.feature import Word2Vec as JaxWord2Vec
from mmlspark_tpu.feature import hashing as jax_hashing
from mmlspark_tpu.utils import demo_data as jax_demo
from mmlspark_tpu_torch import native_loader
from mmlspark_tpu_torch.core.pipeline import PipelineModel, load_stage
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.feature import (Featurize, TextFeaturizer, Tokenizer,
                                        Word2Vec, hashing)
from mmlspark_tpu_torch.feature import text as text_mod
from mmlspark_tpu_torch.utils import demo_data


def both(table):
    """The same columns as a port table and a JAX table."""
    cols = {c: table[c] for c in table.columns}
    return DataTable(cols), JaxDataTable(cols)


TABLES = {
    "census": lambda: demo_data.adult_census_like(n=300, seed=0),
    "flights": lambda: demo_data.flight_delays_like(n=300, seed=1),
    "collinear": lambda: demo_data.grid_datasets()["collinear"],
}


def test_generators_are_the_jax_packages():
    for name in ("adult_census_like", "flight_delays_like",
                 "book_reviews_like", "cifar_like"):
        a, b = getattr(demo_data, name)(n=50), getattr(jax_demo, name)(n=50)
        assert a.columns == b.columns
        for c in a.columns:
            assert list(a[c].ravel()) == list(b[c].ravel()), (name, c)


@pytest.mark.parametrize("one_hot", [True, False])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_featurize_is_bit_identical(name, one_hot, tmp_path):
    port, jax = both(TABLES[name]())
    label = port.columns[-1]
    args = dict(featureColumns={"features": [c for c in port.columns
                                             if c != label]},
                numberOfFeatures=1 << 12, oneHotEncodeCategoricals=one_hot)
    pm, jm = Featurize(**args).fit(port), JaxFeaturize(**args).fit(jax)
    pf, jf = pm.transform(port), jm.transform(jax)
    assert pf["features"].dtype == jf["features"].dtype
    np.testing.assert_array_equal(pf["features"], jf["features"])
    assert pf.meta("features").extra == jf.meta("features").extra
    jm.save(str(tmp_path / "jax"))
    pm.save(str(tmp_path / "port"))
    np.testing.assert_array_equal(
        load_stage(str(tmp_path / "jax")).transform(port)["features"],
        jf["features"])
    np.testing.assert_array_equal(
        jax_load_stage(str(tmp_path / "port")).transform(jax)["features"],
        jf["features"])


def test_hashing_helpers_match():
    rng = np.random.default_rng(0)
    words = ["alpha", "beta", "gamma", "delta", "épsilon", "zeta"]
    docs = [list(rng.choice(words, rng.integers(0, 9))) for _ in range(40)]
    for binary in (False, True):
        a = hashing.hash_token_lists(docs, 97, binary)
        b = jax_hashing.hash_token_lists(docs, 97, binary)
        for (ai, av), (bi, bv) in zip(a, b):
            np.testing.assert_array_equal(ai, bi)
            np.testing.assert_array_equal(av, bv)
    col = np.empty(len(a), object)
    col[:] = a
    np.testing.assert_array_equal(
        hashing.densify_sparse_column(col, num_features=97),
        jax_hashing.densify_sparse_column(col, num_features=97))
    assert hashing.stable_hash("word") == jax_hashing.stable_hash("word")


DOCS = ["The quick brown fox", "  jumps\tover the\nlazy dog ", "", None,
        "Café au lait is NOT a stop word", "it was THE best of times",
        "a b c d e f g", "\x1cseparated\x1fwords here"]


@pytest.mark.parametrize("stop, lower, lower_for_stop, min_len, binary", [
    (["the", "a", "is"], True, False, 0, False),
    (["the", "not"], False, True, 2, True),
    ([], True, False, 3, False)])
def test_native_text_hash_matches_the_jax_native_path(
        stop, lower, lower_for_stop, min_len, binary):
    args = (stop, lower, lower_for_stop, min_len, 1 << 10, binary)
    rows, fallback = native_loader.native_text_hash(DOCS, *args)
    jrows, jfallback = jax_native.native_text_hash(DOCS, *args)
    assert fallback == jfallback == [4]
    for a, b in zip(rows, jrows):
        if a is None:
            assert b is None
            continue
        assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()


def test_text_featurizer_matches_and_counts_its_paths(tmp_path):
    data = demo_data.book_reviews_like(n=120, seed=2)
    texts = list(data["text"])
    texts[5] = "Ünïcode review, great great book"
    port, jax = both(DataTable({"text": np.asarray(texts, object),
                                "rating": data["rating"]}))
    args = dict(inputCol="text", outputCol="feats", useStopWordsRemover=True,
                useIDF=True, numFeatures=1 << 12, minDocFreq=2)
    pm, jm = TextFeaturizer(**args).fit(port), \
        JaxTextFeaturizer(**args).fit(jax)
    pidf, jidf = pm.get_stages()[-1], jm.get_stages()[-1]
    assert sorted(pidf._idf) == sorted(jidf._idf)
    np.testing.assert_allclose([pidf._idf[k] for k in sorted(pidf._idf)],
                               [jidf._idf[k] for k in sorted(jidf._idf)],
                               rtol=1e-6)
    before = dict(text_mod.fused_rows)
    out, jout = pm.transform(port), jm.transform(jax)
    assert text_mod.fused_rows["native"] - before["native"] == 119
    assert text_mod.fused_rows["python"] - before["python"] == 1
    staged = PipelineModel.transform(pm, port)["feats"]
    assert out.columns == jout.columns
    for a, b, c in zip(out["feats"], jout["feats"], staged):
        assert a[0].tobytes() == b[0].tobytes() == c[0].tobytes()
        np.testing.assert_allclose(a[1], b[1], rtol=1e-6)
        assert a[1].tobytes() == c[1].tobytes()
    jm.save(str(tmp_path / "jax"))
    loaded = load_stage(str(tmp_path / "jax"))
    assert type(loaded).__name__ == "TextFeaturizerModel"
    for a, b in zip(loaded.transform(port)["feats"], out["feats"]):
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()
    pm.save(str(tmp_path / "port"))
    back = jax_load_stage(str(tmp_path / "port"))
    for a, b in zip(back.transform(jax)["feats"], jout["feats"]):
        assert a[0].tobytes() == b[0].tobytes()


def test_word2vec_matches_jax():
    data = demo_data.book_reviews_like(n=300, seed=2)
    port, jax = both(data)
    tokens = Tokenizer(inputCol="text", outputCol="tokens").transform(port)
    jtokens = JaxTokenizer(inputCol="text", outputCol="tokens").transform(jax)
    args = dict(inputCol="tokens", outputCol="embedding", vectorSize=16,
                windowSize=3, minCount=3, maxIter=2, seed=0)
    pm = Word2Vec(device="cpu", **args).fit(tokens)
    jm = JaxWord2Vec(**args).fit(jtokens)
    assert pm.vocabulary == jm.vocabulary
    scale = np.abs(jm.vectors).max()
    assert np.abs(pm.vectors - jm.vectors).max() <= 1e-4 * scale
    np.testing.assert_allclose(pm.transform(tokens)["embedding"],
                               jm.transform(jtokens)["embedding"],
                               atol=1e-4 * scale)
