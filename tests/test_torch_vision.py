"""The port's vision stages (`mmlspark_tpu_torch/vision/`) against the
JAX package's on the CPU: the `ImageTransformer` chain and its ragged
path, `UnrollImage`, `ImageFeaturizer`'s cut widths and features on the
zoo's ConvNet and ResNetDigits, saving and loading of all three stages
and of a `PipelineModel` holding them in both directions between the
packages, and the slice as a whole: example 302's path up to the
features (read over loopback HTTP, resize 40 -> center-crop 32 -> flip,
`ImageFeaturizer(ResNetDigits, cutOutputLayers=1)`).

Tolerances, on the [0, 255] scale: chains with a resize or blur within
1e-2, the rest exact; f32 features within rtol 1e-5 / atol 1e-5 of max
|feature|; the zoo's bf16 bundles within 2e-2 of max |feature| (bf16
rounding of two runtimes).  The JAX side runs once, on threads, in a
module fixture.
"""

import http.server
import os
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from mmlspark_tpu.core.pipeline import PipelineModel as JaxPipelineModel
from mmlspark_tpu.core.pipeline import load_stage as jax_load_stage
from mmlspark_tpu.core.table import DataTable as JaxDataTable
from mmlspark_tpu.io import read_images as jax_read_images
from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.vision import ImageFeaturizer as JaxFeaturizer
from mmlspark_tpu.vision import ImageTransformer as JaxTransformer
from mmlspark_tpu.vision import UnrollImage as JaxUnroll
from mmlspark_tpu_torch import DataTable, PipelineModel
from mmlspark_tpu_torch.core.pipeline import load_stage
from mmlspark_tpu_torch.io import read_images
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.vision import (ImageFeaturizer, ImageTransformer,
                                       UnrollImage)
from mmlspark_tpu_torch.zoo import ModelDownloader, pretrained_repo

RNG = np.random.default_rng(7)
IMAGES = RNG.integers(0, 256, (6, 24, 20, 3), dtype=np.uint8)
RAGGED = [RNG.integers(0, 256, (h, 10, 3), dtype=np.uint8)
          for h in (8, 12, 8, 14)]

# name -> fluent chain over either package's ImageTransformer
CHAINS = {
    "resize_gray": lambda t: t.resize(8, 8).color_format("bgr2gray"),
    "crop_flip": lambda t: t.crop(2, 3, 10, 7).flip(0),
    "center_blur_threshold": lambda t: t.center_crop(16, 16).blur(
        3.0, 4.0).threshold(100.0, 255.0, "tozero"),
    "gaussian_normalize": lambda t: t.gaussian_kernel(5, 1.2).normalize(
        [0.4, 0.5, 0.6], [0.2, 0.2, 0.2]),
    "swap_flip_resize": lambda t: t.color_format("bgr2rgb").flip(-1).resize(
        30, 12),
}
INEXACT = {"resize_gray", "center_blur_threshold", "gaussian_normalize",
           "swap_flip_resize"}


def zoo_bundles():
    dl = ModelDownloader(tempfile.mkdtemp())
    return {n: dl.load_bundle(dl.download_by_name(pretrained_repo(), n))
            for n in ("ConvNet", "ResNetDigits")}


ZOO = zoo_bundles()


def f32(bundle: ModelBundle) -> ModelBundle:
    return ModelBundle(bundle.architecture,
                       {**bundle.config, "dtype": "float32"},
                       bundle.variables, dict(bundle.metadata))


def to_jax(bundle: ModelBundle) -> JaxModelBundle:
    return JaxModelBundle(bundle.architecture, dict(bundle.config),
                          bundle.variables, dict(bundle.metadata))


# (bundle, cutOutputLayers, width, float32?)
FEATURIZERS = {
    "convnet_cut1": ("ConvNet", 1, 512, True),
    "convnet_cut0": ("ConvNet", 0, 10, True),
    "convnet_cut2_bf16": ("ConvNet", 2, None, False),
    "resnet_cut1": ("ResNetDigits", 1, 128, True),
    "resnet_cut2": ("ResNetDigits", 2, None, True),
    "resnet_cut1_bf16": ("ResNetDigits", 1, 128, False),
}


def featurizer_bundle(case):
    name, _, _, exact = FEATURIZERS[case]
    return f32(ZOO[name]) if exact else ZOO[name]


@pytest.fixture(scope="module")
def jax_refs():
    def chain(name):
        return np.asarray(CHAINS[name](JaxTransformer(
            inputCol="image", outputCol="out")).transform(
            JaxDataTable({"image": IMAGES}))["out"])

    def feats(case):
        _, cut, _, _ = FEATURIZERS[case]
        out = JaxFeaturizer(to_jax(featurizer_bundle(case)), inputCol="image",
                            outputCol="f", cutOutputLayers=cut,
                            miniBatchSize=4).transform(
            JaxDataTable({"image": IMAGES}))["f"]
        return np.asarray(out, np.float32)

    jobs = {("chain", n): (lambda n=n: chain(n)) for n in CHAINS}
    jobs.update({("feat", c): (lambda c=c: feats(c)) for c in FEATURIZERS})
    with ThreadPoolExecutor(6) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def images_close(got, ref, exact):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1e-2 * 255


def features_close(got, ref, exact):
    assert got.shape == ref.shape and got.dtype == np.float32
    scale = np.abs(ref).max()
    if exact:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)
    else:
        assert np.abs(got - ref).max() <= 2e-2 * scale


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_transformer_chain_matches_jax(jax_refs, name):
    out = CHAINS[name](ImageTransformer(
        inputCol="image", outputCol="out", device="cpu")).transform(
        DataTable({"image": IMAGES}))
    got = out["out"]
    images_close(got, jax_refs[("chain", name)], name not in INEXACT)
    meta = out.meta("out").image
    assert (meta.height, meta.width) == got.shape[1:3]
    assert not np.shares_memory(got, IMAGES)


@pytest.mark.parametrize("ops,stacked", [
    (lambda t: t.resize(6, 6), True), (lambda t: t.flip(1), False),
    (lambda t: t.crop(0, 0, 8, 4).threshold(99.0, 1.0, "binary_inv"),
     True)])
def test_ragged_column_groups_by_shape_like_jax(ops, stacked):
    got = ops(ImageTransformer(device="cpu")).transform(
        DataTable({"image": RAGGED}))["image"]
    ref = ops(JaxTransformer()).transform(
        JaxDataTable({"image": RAGGED}))["image"]
    assert (got.dtype != object) == stacked == (ref.dtype != object)
    for g, r in zip(got, ref):
        images_close(np.asarray(g), np.asarray(r), False)


def test_unknown_stage_raises():
    t = ImageTransformer(device="cpu").set("stages", [{"stage": "warp"}])
    with pytest.raises(ValueError, match="unknown image stage"):
        t.transform(DataTable({"image": IMAGES}))


def test_unroll_image_matches_jax():
    got = UnrollImage(inputCol="image", device="cpu").transform(
        DataTable({"image": IMAGES}))["unrolled"]
    ref = JaxUnroll(inputCol="image").transform(
        JaxDataTable({"image": IMAGES}))["unrolled"]
    assert got.shape == (6, 24 * 20 * 3)
    np.testing.assert_array_equal(got, np.asarray(ref))
    with pytest.raises(ValueError, match="uniform"):
        UnrollImage(device="cpu").transform(DataTable({"image": RAGGED}))


@pytest.mark.parametrize("case", sorted(FEATURIZERS))
def test_featurizer_cut_widths_and_features_match_jax(jax_refs, case):
    _, cut, width, exact = FEATURIZERS[case]
    got = ImageFeaturizer(featurizer_bundle(case), inputCol="image",
                          outputCol="f", cutOutputLayers=cut,
                          miniBatchSize=4, device="cpu").transform(
        DataTable({"image": IMAGES}))
    feats = got["f"]
    assert "f_img" not in got.columns
    if width is not None:
        assert feats.shape == (6, width)
    features_close(feats, jax_refs[("feat", case)], exact)


def test_featurizer_layer_name_and_errors():
    bundle = f32(ZOO["ResNetDigits"])
    named = ImageFeaturizer(bundle, inputCol="image", outputCol="s",
                            layerName="stage1", device="cpu").transform(
        DataTable({"image": IMAGES}))["s"]
    assert named.ndim == 4 and named.shape[0] == 6
    with pytest.raises(ValueError, match="cutOutputLayers=9"):
        ImageFeaturizer(bundle, cutOutputLayers=9, device="cpu").transform(
            DataTable({"image": IMAGES}))
    with pytest.raises(ValueError, match="no model bundle"):
        ImageFeaturizer(device="cpu").transform(DataTable({"image": IMAGES}))


def stages(package):
    transformer_cls, unroll_cls, featurizer_cls = package
    bundle = f32(ZOO["ResNetDigits"])
    if featurizer_cls is JaxFeaturizer:
        bundle = to_jax(bundle)
        extra = {}
    else:
        extra = {"device": "cpu"}
    return [
        transformer_cls(inputCol="image", outputCol="small", **extra)
        .resize(40, 40).center_crop(32, 32).flip().blur(2.0, 2.0),
        unroll_cls(inputCol="small", outputCol="flat", **extra),
        featurizer_cls(bundle, inputCol="small", outputCol="features",
                       cutOutputLayers=1, miniBatchSize=4, **extra)]


PORT = (ImageTransformer, UnrollImage, ImageFeaturizer)
JAX = (JaxTransformer, JaxUnroll, JaxFeaturizer)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_stages_and_a_pipeline_of_them_load_across_the_packages(
        tmp_path, direction):
    saver, loader = (PORT, JAX) if direction == "port_to_jax" else (JAX, PORT)
    saved = stages(saver)
    load = (jax_load_stage if loader is JAX
            else lambda p: load_stage(p, device="cpu"))
    for i, stage in enumerate(saved):
        stage.save(str(tmp_path / f"s{i}"))
    loaded = [load(str(tmp_path / f"s{i}")) for i in range(3)]
    assert [type(s).__name__ for s in loaded] == [
        "ImageTransformer", "UnrollImage", "ImageFeaturizer"]
    assert [type(s).__module__.split(".")[0] for s in loaded] == [
        "mmlspark_tpu" if loader is JAX else "mmlspark_tpu_torch"] * 3
    assert loaded[0].stages == saved[0].stages
    pipeline = (JaxPipelineModel if saver is JAX else PipelineModel)(saved)
    pipeline.save(str(tmp_path / "pipe"))
    reloaded = load(str(tmp_path / "pipe"))
    table_cls = JaxDataTable if loader is JAX else DataTable
    got = reloaded.transform(table_cls({"image": IMAGES}))
    ref = pipeline.transform((JaxDataTable if saver is JAX
                              else DataTable)({"image": IMAGES}))
    images_close(np.asarray(got["small"]), np.asarray(ref["small"]), False)
    np.testing.assert_allclose(np.asarray(got["flat"]),
                               np.asarray(ref["flat"]), atol=1e-2 * 255)
    features_close(np.asarray(got["features"], np.float32),
                   np.asarray(ref["features"], np.float32), True)


def write_store(root: str, n: int = 12) -> None:
    """A 2-class PNG tree with the MANIFEST that makes it HTTP-servable
    (example 302's `_write_image_dir`, on seeded noise)."""
    rng = np.random.default_rng(5)
    rels = []
    for i in range(n):
        rel = f"class{i % 2}/img{i:03d}.png"
        os.makedirs(os.path.join(root, os.path.dirname(rel)), exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
                        ).save(os.path.join(root, rel))
        rels.append(rel)
    with open(os.path.join(root, "MANIFEST"), "w") as f:
        f.write("\n".join(rels) + "\n")


def test_example_302_path_up_to_the_features_matches_jax(tmp_path):
    write_store(str(tmp_path))

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(tmp_path), **kw)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_port}/"
        table = read_images(url, pattern="*.png", device="cpu")
        jtable = jax_read_images(url, pattern="*.png")
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert table["image"].shape == (12, 32, 32, 3)
    assert list(table["path"]) == list(jtable["path"])
    np.testing.assert_array_equal(table["image"], jtable["image"])

    def run(transformer_cls, featurizer_cls, tbl, bundle, **extra):
        small = (transformer_cls(inputCol="image", outputCol="image",
                                 **extra)
                 .resize(40, 40).center_crop(32, 32).flip().transform(tbl))
        return small, featurizer_cls(bundle, inputCol="image",
                                     outputCol="features",
                                     cutOutputLayers=1,
                                     **extra).transform(small)

    small, feats = run(ImageTransformer, ImageFeaturizer, table,
                       ZOO["ResNetDigits"], device="cpu")
    jsmall, jfeats = run(JaxTransformer, JaxFeaturizer, jtable,
                         to_jax(ZOO["ResNetDigits"]))
    assert small["image"].shape[1:] == (32, 32, 3)
    images_close(small["image"], np.asarray(jsmall["image"]), False)
    assert feats["features"].shape == (12, 128)      # feature_dim
    features_close(feats["features"],
                   np.asarray(jfeats["features"], np.float32), False)
