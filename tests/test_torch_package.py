"""Guards of the PyTorch port (mmlspark_tpu_torch): it never imports the
JAX stack, its entry points never fall back to the CPU on their own, its
kernel sources ship and build outside git, and, on a card, each kernel
agrees with its plain version.

This file imports neither jax nor mmlspark_tpu, so on a machine with a
card and no flax its kernel cases run alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_package.py
"""

import ast
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch import (DataTable, ModelBundle, TextGenerator,
                                TransformerLM)
from mmlspark_tpu_torch.models import DecodeEngine
from mmlspark_tpu_torch.ops import native
from mmlspark_tpu_torch.ops.decode_attention import (
    fused_single_query_attention, fused_single_query_attention_plain)
from mmlspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_plain)
from mmlspark_tpu_torch.quant.quantize import quantize_kv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mmlspark_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mmlspark_tpu"}
CFG = {"vocab_size": 32, "d_model": 32, "n_heads": 2, "n_layers": 1,
       "max_len": 64, "dtype": "float32"}


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_never_imports_the_jax_stack():
    sources = _port_sources()
    assert len(sources) > 10 and os.path.exists(sources[0])
    offenders = [(os.path.relpath(p, REPO), name) for p in sources
                 for name in _imported_roots(p) if name in FORBIDDEN]
    assert offenders == []


def test_entry_points_raise_without_cuda(monkeypatch):
    """Default device is the card; with none they raise instead of
    quietly running on the host."""
    bundle = ModelBundle.init("TransformerLM", CFG)
    module = bundle.module("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TextGenerator(bundle),
                 lambda: DecodeEngine(module, 4),
                 lambda: TransformerLM(**CFG),
                 lambda: bundle.module()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # an explicit host device is honoured
    assert TextGenerator(bundle, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="weights are on"):
        DecodeEngine(bundle.module("cpu").to("meta"), 4, device="cpu")


def test_kernel_sources_ship_and_build_outside_git():
    for name in native.SIGNATURES:
        assert os.path.exists(os.path.join(native.CSRC, f"{name}.cu"))
    assert native.library_path("flash_attention").startswith(
        native.BUILD_DIR)
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert "mmlspark_tpu_torch/_build/" in ignored
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        pyproject = f.read()
    assert '"mmlspark_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in pyproject


def test_unported_options_raise():
    bundle = ModelBundle.init("TransformerLM", CFG)
    module = bundle.module("cpu")
    for kw in ({"mesh": object()}, {"prefill_chunk": 4},
               {"spec_tokens": 2}):
        with pytest.raises(NotImplementedError):
            DecodeEngine(module, 4, device="cpu", **kw)
    for param in ("beamWidth", "specTokens", "prefillChunk"):
        stage = TextGenerator(bundle, device="cpu", inputCol="p",
                              **{param: 2})
        with pytest.raises(NotImplementedError, match=param):
            stage.transform(_table([[1, 2, 3]]))
    with pytest.raises(NotImplementedError):
        TextGenerator(bundle, device="cpu").set_mesh(object())


def _table(rows):
    return DataTable({"p": [np.asarray(r, np.int32) for r in rows]})


# ---------------------------------------------- kernels on the card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,causal,dtype", [
    (512, True, torch.bfloat16), (1984, True, torch.bfloat16),
    (300, False, torch.bfloat16), (700, True, torch.float32)])
def test_flash_kernel_matches_plain(cuda, s, causal, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn((2, s, 8, 128), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("window,cache", [
    (128, "bfloat16"), (1152, "bfloat16"), (2048, "int8"), (1152, "int8"),
    (200, "float32")])
def test_decode_kernel_matches_plain(cuda, window, cache):
    b, h, d = 8, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(window)
    dtype = torch.float32 if cache == "float32" else torch.bfloat16
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, window, h, d), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    slots = torch.arange(window, device=cuda)
    true_len = torch.randint(1, max(2, window // 2), (b,), generator=gen,
                             device=cuda)
    visible = (slots[None] < true_len[:, None]) | (
        (slots >= window // 2) & (slots <= window // 2 + 7))[None]
    visible[-1] = False
    kw = {}
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        kw = dict(k_scale=ks, v_scale=vs)
    got = fused_single_query_attention(q, k, v, visible, **kw)
    torch.cuda.synchronize()
    ref = fused_single_query_attention_plain(q, k, v, visible, **kw)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-3)
    assert torch.count_nonzero(got[-1]) == 0
