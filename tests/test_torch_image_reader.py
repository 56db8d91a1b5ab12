"""The port's readers (`io/files.py`, `io/image_reader.py`,
`native_loader.py`) against the JAX package's on the CPU: path lists with
recursion, pattern, zip entries and `sample_ratio`; `read_images` uniform,
ragged, with `resize_to` and under the three `on_error` policies; PNG and
JPEG decode bitwise equal to the JAX decoder's, through the port's own
build of its own copy of the decoder source and through the PIL fallback.

Tolerances: decoded pixels and path lists exact; `resize_to` output
(resized in float32, rounded half to even, clipped to uint8) within one
level on at most 0.5% of the pixels (the two packages' antialiased
filters round apart by ~3e-3, which moves a value sitting on a .5 tie).
"""

import io
import os
import subprocess
import zipfile

import numpy as np
import pytest
from PIL import Image

from mmlspark_tpu.io import files as jfiles
from mmlspark_tpu.io import image_reader as jreader
from mmlspark_tpu_torch import native_loader
from mmlspark_tpu_torch.io import files, image_reader
from mmlspark_tpu_torch.io import read_binary_files, read_images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def encoded(arr: np.ndarray, fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **({"quality": 90}
                                           if fmt == "JPEG" else {}))
    return buf.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for i in range(5):
        arr = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
        (root / f"a{i}.png").write_bytes(encoded(arr, "PNG"))
        (root / f"b{i}.jpg").write_bytes(encoded(arr, "JPEG"))
    (root / "gray.png").write_bytes(encoded(
        rng.integers(0, 256, (30, 41), dtype=np.uint8), "PNG"))
    (root / "notes.txt").write_bytes(b"not an image")
    sub = root / "sub" / "deeper"
    sub.mkdir(parents=True)
    (sub / "c.png").write_bytes(encoded(
        rng.integers(0, 256, (17, 23, 3), dtype=np.uint8), "PNG"))
    with zipfile.ZipFile(root / "sub" / "pack.zip", "w") as zf:
        for i in range(4):
            zf.writestr(f"z{i}.png", encoded(
                rng.integers(0, 256, (9, 11, 3), dtype=np.uint8), "PNG"))
    return str(root)


def test_the_decoder_builds_from_the_ports_source_under_its_build_dir():
    so = native_loader.build_native()
    assert so.startswith(os.path.join(REPO, "mmlspark_tpu_torch", "_build"))
    assert os.path.basename(so).startswith("libmmldecode-")
    assert native_loader.get_native_lib() is not None
    assert all(p.startswith(os.path.join(REPO, "mmlspark_tpu_torch", ""))
               for p in native_loader.source_paths())


@pytest.mark.parametrize("kw", [
    {}, {"recursive": True}, {"pattern": "*.png"},
    {"recursive": True, "pattern": "a*"}])
def test_list_files_matches_jax(corpus, kw):
    assert files.list_files(corpus, **kw) == jfiles.list_files(corpus, **kw)


@pytest.mark.parametrize("kw", [
    {"recursive": True}, {"recursive": True, "inspect_zip": False},
    {"recursive": True, "sample_ratio": 0.5, "seed": 3},
    {"recursive": True, "sample_ratio": 0.3, "seed": 11},
    {"recursive": True, "pattern": "*.zip", "sample_ratio": 0.5}])
def test_binary_files_and_sampled_paths_match_jax(corpus, kw):
    got = read_binary_files(corpus, **kw)
    ref = jfiles.read_binary_files(corpus, **kw)
    assert list(got["path"]) == list(ref["path"])
    assert list(got["bytes"]) == list(ref["bytes"])
    assert got.meta("bytes").binary.path_col == "path"


def test_zip_entries_expand_to_virtual_paths(corpus):
    paths = list(read_binary_files(corpus, recursive=True,
                                   pattern="*.zip")["path"])
    assert len(paths) == 4 and all("pack.zip/z" in p for p in paths)
    with pytest.raises(ValueError, match="sample_ratio"):
        list(files.iter_binary_files(corpus, sample_ratio=1.5))


@pytest.fixture(params=["native", "pil"])
def decoder(request, monkeypatch):
    """Both decoders of the port: the native library, and PIL with the
    library absent."""
    if request.param == "pil":
        monkeypatch.setattr(image_reader, "native_decode_batch",
                            lambda buffers: None)
        monkeypatch.setattr(image_reader, "native_decode", lambda data: None)
    return request.param


def test_png_and_jpeg_decode_bitwise_equal_to_the_jax_decoder(corpus,
                                                             decoder):
    table = read_binary_files(corpus, recursive=True)
    buffers = list(table["bytes"]) + [b"\x89PNG\r\n\x1a\n broken", b""]
    before = dict(image_reader.decoder_counts)
    got = image_reader.decode_many(buffers)
    ref = jreader.decode_many(buffers)
    assert len(got) == len(ref) == len(buffers)
    assert [g is None for g in got] == [r is None for r in ref]
    assert sum(g is not None for g in got) == len(buffers) - 3
    for g, r in zip(got, ref):
        if r is not None:
            assert g.dtype == np.uint8 and np.array_equal(g, r)
    decoded = image_reader.decoder_counts[decoder] - before[decoder]
    assert decoded == len(buffers) - 3
    one = image_reader.decode_bytes(buffers[0])
    assert np.array_equal(one, ref[0])


def test_read_images_uniform_and_ragged_match_jax(corpus):
    got = read_images(corpus, device="cpu")    # gray.png has 1 channel
    ref = jreader.read_images(corpus)
    assert got["image"].dtype == object == ref["image"].dtype
    assert list(got["path"]) == list(ref["path"]) and len(ref["path"]) == 11
    for g, r in zip(got["image"], ref["image"]):
        assert np.array_equal(g, r)
    ragged = read_images(corpus, recursive=True, device="cpu")
    jragged = jreader.read_images(corpus, recursive=True)
    assert ragged["image"].dtype == object == jragged["image"].dtype
    assert [g.shape for g in ragged["image"]] == \
        [r.shape for r in jragged["image"]]
    uniform = read_images(corpus, pattern="a*", device="cpu")
    assert uniform["image"].shape == (5, 30, 41, 3)
    assert uniform.meta("image").image.height == 30


def resize_close(got: np.ndarray, ref: np.ndarray) -> None:
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 5e-3


@pytest.mark.parametrize("size", [(24, 24), (64, 50), (30, 41)])
def test_read_images_resize_to_matches_jax(corpus, size):
    got = read_images(corpus, recursive=True, resize_to=size, device="cpu")
    ref = jreader.read_images(corpus, recursive=True, resize_to=size)
    assert list(got["path"]) == list(ref["path"])
    assert got["image"].shape == (len(ref["path"]),) + size + (3,)
    resize_close(got["image"], ref["image"])


@pytest.mark.parametrize("policy", ["skip", "fail", "column"])
def test_on_error_policies_match_jax(corpus, policy):
    kw = dict(recursive=True, resize_to=(16, 16), on_error=policy)
    if policy == "fail":
        for reader in (read_images, jreader.read_images):
            with pytest.raises(ValueError, match="could not decode"):
                reader(corpus, **kw)
        return
    got = read_images(corpus, device="cpu", **kw)
    ref = jreader.read_images(corpus, **kw)
    assert list(got["path"]) == list(ref["path"])
    resize_close(got["image"], ref["image"])
    if policy == "column":
        assert list(got["decode_error"]) == list(ref["decode_error"])
        bad = [i for i, e in enumerate(got["decode_error"]) if e]
        assert len(bad) == 1 and not got["image"][bad[0]].any()
    else:
        assert "decode_error" not in got


def test_legacy_drop_failures_flag(corpus):
    assert read_images(corpus, pattern="*.txt", device="cpu").num_rows == 0
    with pytest.raises(ValueError, match="could not decode"):
        read_images(corpus, drop_failures=False, device="cpu")


def test_resize_to_runs_on_the_card_by_default(corpus, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    read_images(corpus)           # no resize: host work only
    with pytest.raises(RuntimeError, match="no CUDA device"):
        read_images(corpus, resize_to=(8, 8))


def test_a_failed_build_raises_from_build_native(monkeypatch, tmp_path):
    monkeypatch.setattr(native_loader, "LINK_LIBS", ("-lno_such_codec",))
    from mmlspark_tpu_torch import config
    config.set("MMLSPARK_TPU_NATIVE_CACHE", str(tmp_path))
    try:
        assert native_loader.library_path().startswith(str(tmp_path))
        with pytest.raises(subprocess.CalledProcessError):
            native_loader.build_native()
    finally:
        config.set("MMLSPARK_TPU_NATIVE_CACHE", None)
