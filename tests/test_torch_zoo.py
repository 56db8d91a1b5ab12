"""The port's local model zoo (`zoo/downloader.py`) and the four committed
pretrained bundles scored through the port's `TPUModel`, against the JAX
package, on the CPU.

The bundles are the JAX package's committed `.tpubundle` files, read in
place.  Each scores through both stages on real held-out data (the UCI
digits split of `digits_images()`, the WDBC held-out fifth, both read
from scikit-learn's bundled files; fresh synthetic reviews hashed by the
JAX package's TextFeaturizer): at f32 (`computeDtype="float32"`)
within rtol 1e-5 / atol 1e-5 of max |logit| with identical argmax; at the
bundles' own bf16 within 2e-2 of max |logit|, argmax identical wherever
the top-2 gap exceeds 2e-2 of max |logit|.  The accuracy pins are the JAX
package's own (`tests/test_zoo.py`).  The JAX side's scores are computed
once, on threads, in a module fixture.
"""

import gzip
import importlib.util
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.models import TPUModel as JaxTPUModel
from mmlspark_tpu.utils.demo_data import book_reviews_like
from mmlspark_tpu.zoo import ModelDownloader as JaxModelDownloader
from mmlspark_tpu.zoo import pretrained_repo as jax_pretrained_repo
from mmlspark_tpu_torch import DataTable, TPUModel
from mmlspark_tpu_torch.core.schema import (SchemaConstants,
                                            find_score_columns,
                                            set_score_column)
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.zoo import (LocalRepo, ModelDownloader,
                                    ModelNotFoundError, RemoteRepo,
                                    create_builtin_repo, pretrained_repo,
                                    sha256_file)

ZOO = ("ConvNet", "ResNetDigits", "TabularWDBC", "TextSentiment")
CONVNET_PIN = [6, 6, 6, 2, 5, 6, 6, 2, 2, 1, 1, 9, 0, 4, 1, 9, 5, 5, 3, 0,
               5, 1, 5, 0, 4]


def _sklearn_data(name: str) -> str:
    """A data file scikit-learn bundles, read without importing it (the
    import costs ~4 s here)."""
    spec = importlib.util.find_spec("sklearn")
    return os.path.join(os.path.dirname(spec.origin), "datasets", "data",
                        name)


def digits_test_split():
    """`mmlspark_tpu.utils.demo_data.digits_images()`'s held-out split
    (the same file, transforms and seeded order as `load_digits` there)."""
    with gzip.open(_sklearn_data("digits.csv.gz")) as f:
        data = np.loadtxt(f, delimiter=",")
    imgs = data[:, :-1].reshape(-1, 8, 8).astype(np.float32)
    x = np.kron(imgs, np.ones((1, 4, 4), np.float32))
    x = np.clip(x * (255.0 / 16.0), 0, 255).astype(np.uint8)
    x = np.repeat(x[..., None], 3, axis=-1)
    y = data[:, -1].astype(np.int32)
    order = np.random.default_rng(0).permutation(len(x))
    n_test = len(x) // 5
    return x[order][:n_test], y[order][:n_test]


def wdbc_held_out(bundle):
    """The publish script's split of the UCI breast-cancer table
    (`load_breast_cancer`'s file): the held-out fifth, standardized with
    the bundle's recorded statistics (`tests/test_zoo.py`)."""
    data = np.loadtxt(_sklearn_data("breast_cancer.csv"), delimiter=",",
                      skiprows=1)
    features, target = data[:, :-1], data[:, -1].astype(int)
    order = np.random.default_rng(3).permutation(len(features))
    held = order[: len(features) // 5]
    meta = bundle.metadata
    x = ((features[held].astype(np.float32)
          - np.asarray(meta["feature_means"], np.float32))
         / np.asarray(meta["feature_stds"], np.float32))
    return x, target[held]


def review_features(bundle):
    """Fresh held-out reviews through the bundle's recorded featurizer
    (the JAX package's TextFeaturizer, as the bundle was made)."""
    from mmlspark_tpu.feature.hashing import densify_sparse_column
    from mmlspark_tpu.feature.text import TextFeaturizer
    cfg = bundle.metadata["featurizer"]
    table = book_reviews_like(n=300, seed=99)
    labels = (np.asarray(table["rating"]) >= 3).astype(int)
    feats = densify_sparse_column(
        TextFeaturizer(**cfg).fit(table).transform(table)[cfg["outputCol"]],
        num_features=cfg["numFeatures"])
    return np.asarray(feats, np.float32), labels


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """name -> (port bundle, inputs, labels, batch size)."""
    dl = ModelDownloader(str(tmp_path_factory.mktemp("port_cache")))
    bundles = {n: dl.load_bundle(dl.download_by_name(pretrained_repo(), n))
               for n in ZOO}
    x_img, y_img = digits_test_split()
    x_wdbc, y_wdbc = wdbc_held_out(bundles["TabularWDBC"])
    x_txt, y_txt = review_features(bundles["TextSentiment"])
    return {"ConvNet": (bundles["ConvNet"], x_img, y_img, 128),
            "ResNetDigits": (bundles["ResNetDigits"], x_img, y_img, 128),
            "TabularWDBC": (bundles["TabularWDBC"], x_wdbc, y_wdbc, 256),
            "TextSentiment": (bundles["TextSentiment"], x_txt, y_txt, 128)}


@pytest.fixture(scope="module")
def jax_scores(zoo, tmp_path_factory):
    """(name, computeDtype) -> the JAX TPUModel's scores."""
    dl = JaxModelDownloader(str(tmp_path_factory.mktemp("jax_cache")))
    bundles = {n: dl.load_bundle(dl.download_by_name(jax_pretrained_repo(),
                                                     n)) for n in ZOO}

    def run(key):
        name, cd = key
        _, x, _, bs = zoo[name]
        model = JaxTPUModel(bundles[name], inputCol="x", outputCol="s",
                            miniBatchSize=bs, computeDtype=cd)
        return np.asarray(model.transform(JaxDataTable({"x": x}))["s"],
                          np.float32)

    keys = [(n, cd) for n in ZOO for cd in (None, "float32")]
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(run, k) for k in keys}
        return {k: f.result() for k, f in futures.items()}


def port_scores(zoo, name, computeDtype=None) -> np.ndarray:
    bundle, x, _, bs = zoo[name]
    model = TPUModel(bundle, device="cpu", inputCol="x", outputCol="s",
                     miniBatchSize=bs, computeDtype=computeDtype)
    return model.transform(DataTable({"x": x}))["s"]


@pytest.mark.parametrize("name", ZOO)
def test_zoo_bundle_scores_as_the_jax_stage_at_f32(zoo, jax_scores, name):
    got = port_scores(zoo, name, "float32")
    ref = jax_scores[name, "float32"]
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


@pytest.mark.parametrize("name", ZOO)
def test_zoo_bundle_scores_as_the_jax_stage_at_bf16(zoo, jax_scores, name):
    assert zoo[name][0].config["dtype"] == "bfloat16"
    got = port_scores(zoo, name)
    ref = jax_scores[name, None]
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 2e-2 * scale
    top2 = np.sort(ref, axis=1)
    clear = top2[:, -1] - top2[:, -2] > 2e-2 * scale
    np.testing.assert_array_equal(got.argmax(1)[clear], ref.argmax(1)[clear])


def test_convnet_reproduces_its_accuracy_and_prediction_pin(zoo):
    _, _, y, _ = zoo["ConvNet"]
    preds = port_scores(zoo, "ConvNet").argmax(1)
    assert (preds == y).mean() >= 0.97
    assert preds[:25].tolist() == CONVNET_PIN


@pytest.mark.parametrize("name,floor", [("ResNetDigits", 0.95),
                                        ("TabularWDBC", 0.95),
                                        ("TextSentiment", 0.9)])
def test_zoo_accuracy_floors(zoo, name, floor):
    bundle, _, y, _ = zoo[name]
    assert bundle.metadata["pretrained"] is True
    assert (port_scores(zoo, name).argmax(1) == y).mean() >= floor


def test_example_301_predictions_equal_under_both_packages(zoo, jax_scores):
    """`examples/example_301_cifar_eval.py`'s flow: the zoo ConvNet
    through TPUModel at miniBatchSize 128, the predictions tagged as a
    score column, and its statistics half (`ComputeModelStatistics`, the
    JAX package's metrics on the same tagged table)."""
    bundle, x, y, _ = zoo["ConvNet"]
    test = DataTable({"image": x, "label": y.astype(np.float64)})
    scored = TPUModel(bundle, device="cpu", inputCol="image",
                      outputCol="scores", miniBatchSize=128).transform(test)
    preds = np.argmax(scored["scores"], axis=1).astype(np.float64)
    scored = scored.with_column("prediction", preds)
    set_score_column(scored, "example301", "prediction",
                     SchemaConstants.SCORED_LABELS_COLUMN,
                     SchemaConstants.CLASSIFICATION_KIND)
    set_score_column(scored, "example301", "label",
                     SchemaConstants.TRUE_LABELS_COLUMN,
                     SchemaConstants.CLASSIFICATION_KIND)
    assert find_score_columns(scored) == {"scored_labels": "prediction",
                                          "true_labels": "label"}
    ref = np.argmax(jax_scores["ConvNet", None], axis=1).astype(np.float64)
    np.testing.assert_array_equal(preds, ref)
    from mmlspark_tpu.core.schema import set_score_column as jax_tag
    from mmlspark_tpu.ml import ComputeModelStatistics as JaxStatistics
    from mmlspark_tpu_torch.ml import ComputeModelStatistics
    jax_table = JaxDataTable({"prediction": ref, "label": test["label"]})
    jax_tag(jax_table, "example301", "prediction",
            SchemaConstants.SCORED_LABELS_COLUMN,
            SchemaConstants.CLASSIFICATION_KIND)
    jax_tag(jax_table, "example301", "label",
            SchemaConstants.TRUE_LABELS_COLUMN,
            SchemaConstants.CLASSIFICATION_KIND)
    got = ComputeModelStatistics().evaluate(scored)
    want = JaxStatistics().evaluate(jax_table)
    assert got.metrics.columns == want.metrics.columns
    for c in got.metrics.columns:
        np.testing.assert_array_equal(got.metrics[c], want.metrics[c])
    np.testing.assert_array_equal(got.confusion_matrix,
                                  want.confusion_matrix)


def test_pretrained_repo_is_the_jax_package_s_read_in_place(tmp_path):
    schemas = {s.name: s for s in pretrained_repo().list_schemas()}
    ref = {s.name: s for s in jax_pretrained_repo().list_schemas()}
    assert set(schemas) == set(ZOO)
    assert {n: s.to_json() for n, s in schemas.items()} == {
        n: s.to_json() for n, s in ref.items()}
    for s in schemas.values():
        assert sha256_file(s.uri) == s.hash and os.path.getsize(s.uri) == s.size
    assert schemas["TabularWDBC"].modelType == "generic"
    assert schemas["TextSentiment"].modelType == "text"


@pytest.fixture
def source_repo(tmp_path):
    repo = LocalRepo(str(tmp_path / "source"))
    bundle = ModelBundle.init("MLPClassifier", {"hidden_sizes": [8],
                                                "num_classes": 3},
                              seed=1, input_shape=(1, 5),
                              metadata={"input_shape": [1, 5],
                                        "layer_names": ["z", "h0"]})
    repo.add_model(bundle, "TinyMLP", "unit", model_type="generic")
    return repo


def test_download_verifies_and_caches(tmp_path, source_repo):
    [s] = source_repo.list_schemas()
    assert s.name == "TinyMLP" and s.layerNames == ["z", "h0"]
    dl = ModelDownloader(str(tmp_path / "cache"))
    schema = dl.download_by_name(source_repo, "TinyMLP")
    assert os.path.exists(schema.uri)
    with open(s.uri, "ab") as f:   # a cached copy is not fetched again
        f.write(b"corruption")
    assert dl.download_by_name(source_repo, "TinyMLP").uri == schema.uri
    with pytest.raises(ValueError, match="hash"):
        dl.download_model(source_repo, s, always_download=True)
    with pytest.raises(ModelNotFoundError):
        dl.download_by_name(source_repo, "Missing")
    bundle = dl.load_bundle(schema)
    assert bundle.architecture == "MLPClassifier"
    out = TPUModel(bundle, device="cpu", inputCol="x").transform(
        DataTable({"x": np.zeros((2, 5), np.float32)}))["output"]
    assert out.shape == (2, 3)


def test_repositories_serve_both_packages(tmp_path, source_repo):
    """A repo the port publishes downloads in the JAX package (and the
    payload's bytes are the JAX package's for the same bundle); the port
    downloads from a cache the JAX package wrote."""
    jdl = JaxModelDownloader(str(tmp_path / "jax_cache"))
    schema = jdl.download_by_name(source_repo, "TinyMLP")
    jb = jdl.load_bundle(schema)
    with open(schema.uri + ".meta") as f:
        assert json.load(f)["hash"] == schema.hash
    from mmlspark_tpu.zoo import LocalRepo as JaxLocalRepo
    jrepo = JaxLocalRepo(str(tmp_path / "jax_repo"))
    jschema = jrepo.add_model(jb, "TinyMLP", "unit", model_type="generic")
    assert jschema.hash == schema.hash
    port = ModelDownloader(str(tmp_path / "port_cache"))
    got = port.load_bundle(port.download_by_name(jrepo, "TinyMLP"))
    assert got.config == jb.config


def test_builtin_repo_and_remote_repo(tmp_path):
    repo = create_builtin_repo(str(tmp_path / "zoo"), include=["MLP"])
    [s] = repo.list_schemas()
    assert (s.name, s.inputShape, s.layerNames) == ("MLP", [1, 16],
                                                    ["z", "h0"])
    from mmlspark_tpu.zoo import ModelDownloader as JaxDL
    jb = JaxDL(str(tmp_path / "c")).load_bundle(s)
    assert jb.config == {"hidden_sizes": [100], "num_classes": 2,
                         "dtype": "bfloat16"}
    remote = RemoteRepo("http://127.0.0.1:1/")
    assert (remote.base_url, remote.read_timeout) == ("http://127.0.0.1:1",
                                                      60.0)


@pytest.fixture
def served_repo(tmp_path):
    """A LocalRepo with one model and its MANIFEST, served over HTTP from
    a thread on 127.0.0.1; yields (base url, the LocalRepo)."""
    import functools
    import http.server
    import threading
    repo = create_builtin_repo(str(tmp_path / "serve"), include=["MLP"])
    repo.export_manifest()

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(Quiet, directory=repo.path))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", repo
    finally:
        server.shutdown()
        thread.join(timeout=10)
        server.server_close()


def test_remote_repo_equals_the_jax_remote_repo(served_repo, tmp_path):
    """Over one HTTP server the port's RemoteRepo lists the JAX
    RemoteRepo's schemas and fetches the same payload bytes, and a
    download through it verifies and loads."""
    from mmlspark_tpu.zoo import RemoteRepo as JaxRemoteRepo
    base, repo = served_repo
    remote, jax_remote = RemoteRepo(base), JaxRemoteRepo(base)
    schemas = list(remote.list_schemas())
    jax_schemas = list(jax_remote.list_schemas())
    assert [s.to_json() for s in schemas] == \
        [s.to_json() for s in jax_schemas]
    assert [s.name for s in schemas] == ["MLP"]
    payload = remote.get_payload(schemas[0])
    assert payload == jax_remote.get_payload(jax_schemas[0])
    with open(os.path.join(repo.path, schemas[0].uri), "rb") as f:
        assert payload == f.read()
    dl = ModelDownloader(str(tmp_path / "cache"))
    local = dl.download_by_name(remote, "MLP")
    assert sha256_file(local.uri) == schemas[0].hash
    assert dl.load_bundle(local).config["hidden_sizes"] == [100]
    with pytest.raises(ModelNotFoundError):
        dl.download_by_name(remote, "DoesNotExist")


def test_remote_payload_uri_scheme_restricted(tmp_path, monkeypatch):
    """A remote-supplied .meta whose payload uri is not http(s) is refused
    without being opened (the JAX package's hostile-manifest case)."""
    import dataclasses

    from mmlspark_tpu_torch.resilience import net
    repo = create_builtin_repo(str(tmp_path / "zoo"), include=["MLP"])
    [src] = repo.list_schemas()
    secret = tmp_path / "secret.bin"
    secret.write_bytes(b"host file contents")
    opened = []
    monkeypatch.setattr(net, "http_get",
                        lambda url, **kw: opened.append(url) or b"")
    remote = RemoteRepo("http://127.0.0.1:1/unused")
    for bad in (f"file://{secret}", "ftp://internal/payload",
                "gopher://internal:70/x"):
        with pytest.raises(ModelNotFoundError, match="non-http"):
            remote.get_payload(dataclasses.replace(src, uri=bad))
    assert opened == []

