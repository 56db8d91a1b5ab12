"""Guards of the PyTorch port (mmlspark_tpu_torch): it never imports the
JAX stack, its entry points never fall back to the CPU on their own, its
kernel sources ship and build outside git, and, on a card, each kernel
agrees with its plain version.

This file imports neither jax nor mmlspark_tpu, so on a machine with a
card and no flax its kernel cases run alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_package.py
"""

import ast
import importlib
import os

import numpy as np
import pytest
import torch

import chip_smoke
from mmlspark_tpu_torch import (DataTable, ModelBundle, TextGenerator,
                                TPULearner, TPUModel, Trainer, TrainerConfig,
                                TransformerLM)
from mmlspark_tpu_torch.models import DecodeEngine
from mmlspark_tpu_torch import native_loader
from mmlspark_tpu_torch.ops import image as image_ops
from mmlspark_tpu_torch.ops import native
from mmlspark_tpu_torch.ops.attention import NEG_INF
from mmlspark_tpu_torch.ops.decode_attention import (
    SPLIT, _sm_count, _span_plan, fused_single_query_attention,
    fused_single_query_attention_plain,
    fused_single_query_attention_stats,
    fused_single_query_attention_stats_plain)
from mmlspark_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_attention_with_lse,
    flash_attention_with_lse_plain, flash_block_grads_plain, flash_bwd_dkv,
    flash_bwd_dq)
from mmlspark_tpu_torch.ops.moe import MoEMLP
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from mmlspark_tpu_torch.quant.quantize import quantize_kv
from mmlspark_tpu_torch.train import PopulationTrainer
from mmlspark_tpu_torch.vision import (ImageFeaturizer, ImageTransformer,
                                       UnrollImage)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mmlspark_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_dtypes",
             "mmlspark_tpu"}
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
    covered = {os.path.relpath(os.path.dirname(p), PKG) for p in sources[1:]}
    assert {"train", "parallel", "utils", "ops", "models", "quant",
            "zoo", "io", "data", "vision", "resilience", "ml", "feature",
            "stages"} <= covered
    for module in ("native_loader.py", "ops/image.py", "io/remote.py",
                   "data/autotune.py", "resilience/net.py",
                   "train/learner.py", "ml/learners.py", "ml/trees.py",
                   "ml/train_classifier.py", "ml/train_regressor.py",
                   "ml/find_best_model.py", "ml/statistics.py",
                   "feature/assemble.py", "feature/hashing.py",
                   "feature/text.py", "feature/word2vec.py",
                   "stages/basic.py", "stages/adapter.py",
                   "stages/data_conversion.py", "stages/summarize.py",
                   "stages/sample.py", "quant/gate.py",
                   "utils/demo_data.py", "utils/benchmarks.py"):
        assert os.path.join(PKG, module) in sources
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
                 lambda: bundle.module(),
                 lambda: TPUModel(bundle),
                 lambda: ImageTransformer(),
                 lambda: UnrollImage(),
                 lambda: ImageFeaturizer(bundle),
                 lambda: image_ops.resize(np.zeros((1, 4, 4, 3)), 2, 2),
                 lambda: Trainer(TrainerConfig(
                     architecture="ResNet", model_config={
                         "stage_sizes": [1], "widths": [8]})),
                 lambda: TPULearner(TrainerConfig()),
                 lambda: PopulationTrainer(TrainerConfig(), 2),
                 lambda: MoEMLP(8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # an explicit host device is honoured
    assert TextGenerator(bundle, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="weights are on"):
        DecodeEngine(bundle.module("cpu").to("meta"), 4, device="cpu")


def test_kernel_sources_ship_and_build_outside_git():
    assert {"flash_attention", "flash_backward",
            "decode_attention"} <= set(native.SIGNATURES)
    for name in native.SIGNATURES:
        assert os.path.exists(os.path.join(native.CSRC, f"{name}.cu"))
        assert native.library_path(name).startswith(native.BUILD_DIR)
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert "mmlspark_tpu_torch/_build/" in ignored
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        pyproject = f.read()
    assert ('"mmlspark_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh", '
            '"native/*.cpp"]') in pyproject


def test_decoder_source_is_the_ports_own_and_builds_outside_git():
    """The decoder's C++ source lies under mmlspark_tpu_torch/ (the port
    reads no file of the JAX package) and its library goes to the
    git-ignored build directory, named by the source's digest."""
    sources = native_loader.source_paths()
    assert sources and all(
        os.path.commonpath([p, PKG]) == PKG and os.path.exists(p)
        for p in sources)
    assert native_loader.BUILD_DIR == os.path.join(PKG, "_build")
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert "mmlspark_tpu_torch/_build/" in ignored
    assert native_loader.library_path().startswith(native_loader.BUILD_DIR)
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        assert "mmlspark_tpu/native/" not in text, path


def _cpu_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshSpec(**{"data": 1, **axes}),
                     [torch.device("cpu")] * n)


def test_unported_options_raise():
    """Tensor-parallel decode (a model axis) raises NotImplementedError;
    speculation without a draft is refused with a ValueError naming what
    is missing (speculative decoding and beam search are ported); a mesh
    that is not a port `Mesh` is refused."""
    bundle = ModelBundle.init("TransformerLM", CFG)
    module = bundle.module("cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        DecodeEngine(module, 4, device="cpu", mesh=_cpu_mesh(model=2))
    with pytest.raises(ValueError, match="draft_module"):
        DecodeEngine(module, 4, device="cpu", spec_tokens=2)
    with pytest.raises(ValueError, match="set_draft_bundle"):
        TextGenerator(bundle, device="cpu", inputCol="p",
                      specTokens=2).transform(_table([[1, 2, 3]]))
    beam = TextGenerator(bundle, device="cpu", inputCol="p", beamWidth=2,
                         maxNewTokens=3).transform(_table([[1, 2, 3]]))
    assert np.asarray(beam["generated"][0]).shape == (6,)
    with pytest.raises(TypeError, match="Mesh"):
        DecodeEngine(module, 4, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        TextGenerator(bundle, device="cpu").set_mesh(object())
    with pytest.raises(NotImplementedError, match="A10"):
        TextGenerator(bundle, device="cpu").set_mesh(_cpu_mesh(model=2))
    # seq>1 with model>1: the JAX engine's ValueError, the same from both
    with pytest.raises(ValueError, match="model>1"):
        TextGenerator(bundle, device="cpu").set_mesh(
            _cpu_mesh(seq=2, model=2))


def _table(rows):
    return DataTable({"p": [np.asarray(r, np.int32) for r in rows]})


def test_serving_holds_one_model_dtype_copy_of_the_dense_weights():
    """At bf16 the engines of one TextGenerator share one ServingWeights of
    bf16 Dense weights, and nothing keeps the f32 masters; the tokens equal
    an engine built on the module itself."""
    bundle = ModelBundle.init("TransformerLM", {**CFG, "dtype": "bfloat16"})
    stage = TextGenerator(bundle, device="cpu", inputCol="p", maxNewTokens=4)
    rows = [[1, 2, 3], [4, 5, 6]]
    got = stage.transform(_table(rows))["generated"]
    first = stage._engine_for()
    stage.set("maxNewTokens", 5)
    assert stage._engine_for().weights is first.weights
    assert not hasattr(first, "module") and not hasattr(stage, "_module")
    dense = [first.weights.lm_head] + [getattr(blk, name)
                                       for blk in first.weights.blocks
                                       for name in ("qkv", "proj", "mlp_up",
                                                    "mlp_down")]
    assert all(t.dtype == torch.bfloat16 for lin in dense
               for t in (lin.weight, lin.bias))
    ref = DecodeEngine(bundle.module("cpu"), 4, device="cpu").generate(
        np.asarray(rows, np.int32), np.array([3, 3]))
    np.testing.assert_array_equal(np.stack(got)[:, 3:], ref)


def test_serving_weights_held_once_per_device():
    """A mesh's shards read one copy of the weights per distinct device:
    the weights' own device gets the object itself, another device one
    copy, made once."""
    from mmlspark_tpu_torch.models.generate import ServingWeights
    weights = ServingWeights(ModelBundle.init("TransformerLM", CFG)
                             .module("cpu"))
    assert weights.on("cpu") is weights
    twin = weights.on("meta")
    assert weights.on(torch.device("meta")) is twin
    assert twin.device.type == "meta" and twin.blocks[0].qkv.weight.is_meta
    assert twin.tok_embed.weight.is_meta and not weights.lm_head.weight.is_meta
    assert twin.blocks[0].LayerNorm_1.scale.is_meta


@pytest.mark.parametrize("spec,n,want", [
    ({}, None, {"data": 1, "model": 1, "seq": 1}),
    ({"data": 1, "model": 1}, 1, {"data": 1, "model": 1, "seq": 1}),
    ({"data": -1, "model": -1}, None, ValueError),
    ({"data": 2}, None, ValueError),
    ({}, 2, {"data": 2, "model": 1, "seq": 1}),
    ({"data": 2}, 2, {"data": 2, "model": 1, "seq": 1}),
    ({"data": -1, "seq": 2}, 8, {"data": 4, "model": 1, "seq": 2}),
    ({"data": -1, "seq": 3}, 8, ValueError)])
def test_mesh_spec_resolves_against_one_card(spec, n, want):
    """The JAX resolve over n devices; the default is one device."""
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec
    if isinstance(want, dict):
        assert MeshSpec(**spec).resolve(n) == want
    else:
        with pytest.raises(want):
            MeshSpec(**spec).resolve(n)


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
    _assert_out_norm_close(got, ref, dtype)


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


@pytest.mark.cuda
@pytest.mark.parametrize("window,d,cache,q_dtype", [
    (4224, 64, "bfloat16", "bfloat16"), (4224, 64, "int8", "float32"),
    (1000, 64, "float32", "float32"), (1000, 128, "int8", "bfloat16"),
    (2 * SPLIT + 5, 128, "bfloat16", "float32")])
def test_decode_stats_kernel_matches_plain(cuda, window, d, cache, q_dtype):
    """K4[stats]: acc and l within 1e-3 of their largest value, m within
    1e-4; the fully masked last row is exactly the merge identity."""
    b, h = 2, 8
    gen = torch.Generator(device=cuda).manual_seed(window + d)
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(
        getattr(torch, q_dtype))
    kv_dtype = torch.float32 if cache == "float32" else torch.bfloat16
    k, v = (torch.randn((b, window, h, d), generator=gen, device=cuda)
            .to(kv_dtype) for _ in range(2))
    slots = torch.arange(window, device=cuda)
    visible = ((slots < window // 3) | (slots >= window - 9))[None].repeat(
        b, 1)
    visible[-1] = False
    kw = {}
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        kw = dict(k_scale=ks, v_scale=vs)
    before = fused_single_query_attention_stats.launches
    acc, m, l = fused_single_query_attention_stats(q, k, v, visible, **kw)
    torch.cuda.synchronize()
    assert fused_single_query_attention_stats.launches == before + 1
    ref_acc, ref_m, ref_l = fused_single_query_attention_stats_plain(
        q, k, v, visible, **kw)
    assert (acc - ref_acc).abs().max() <= 1e-3 * ref_acc.abs().max()
    assert (l - ref_l).abs().max() <= 1e-3 * ref_l.abs().max()
    assert (m[:-1] - ref_m[:-1]).abs().max() <= 1e-4
    assert (m[-1] == NEG_INF).all() and (l[-1] == 0).all()
    assert torch.count_nonzero(acc[-1]) == 0


def _decode_inputs(cuda, b, window, d, seed, dtype=torch.bfloat16, h=8):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, window, h, d), generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    return q, k, v


def _assert_stats_close(got, ref):
    """K4[stats] against plain: acc and l within 1e-4 of their largest
    value, m within 1e-4 on the rows that see a slot; a fully masked row
    exactly the merge identity."""
    (acc, m, l), (r_acc, r_m, r_l) = got, ref
    assert (acc - r_acc).abs().max() <= 1e-4 * r_acc.abs().max()
    assert (l - r_l).abs().max() <= 1e-4 * r_l.abs().max()
    seen = r_l > 0
    assert (m[seen] - r_m[seen]).abs().max() <= 1e-4
    assert (m[~seen] == NEG_INF).all() and (l[~seen] == 0).all()
    assert torch.count_nonzero(acc[~seen]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("b,window,d", [
    (2, 8448, 64), (2, 4224, 64), (8, 1152, 128), (2, 37, 64),
    (1, 64, 128), (1, 65, 128), (4, 700, 64), (1, 20000, 64)])
def test_decode_kernel_across_span_plans(cuda, b, window, d):
    """K4 and K4[stats] against plain on windows whose span plans differ
    (the long-context window, the slab, the serving window, one span below
    one slot step, a span boundary at 64/65, up to the cap), with the
    engine's mask layout and a fully masked last row; a second call is
    bitwise equal to the first."""
    q, k, v = _decode_inputs(cuda, b, window, d, seed=window + d)
    bucket = max(1, window - 64)
    true_len = torch.randint(1, bucket + 1, (b,), device=cuda)
    slots = torch.arange(window, device=cuda)
    visible = ((slots[None] < true_len[:, None])
               | (slots >= bucket)[None]).contiguous()
    if b > 1:
        visible[-1] = False
    before = (fused_single_query_attention.launches,
              fused_single_query_attention_stats.launches)
    out = fused_single_query_attention(q, k, v, visible)
    stats = fused_single_query_attention_stats(q, k, v, visible)
    again = fused_single_query_attention(q, k, v, visible)
    stats_again = fused_single_query_attention_stats(q, k, v, visible)
    torch.cuda.synchronize()
    assert (fused_single_query_attention.launches,
            fused_single_query_attention_stats.launches) == (
        before[0] + 2, before[1] + 2)
    ref = fused_single_query_attention_plain(q, k, v, visible)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-3)
    _assert_stats_close(stats, fused_single_query_attention_stats_plain(
        q, k, v, visible))
    assert torch.equal(out, again)
    assert all(torch.equal(x, y) for x, y in zip(stats, stats_again))
    if b > 1:
        assert torch.count_nonzero(out[-1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_decode_kernel_all_spans_masked_but_one(cuda, cache):
    """Only a few slots inside one span of the slab are visible: every
    other span carries the merge identity and must weigh exactly 0."""
    b, window, d = 2, 4224, 64
    q, k, v = _decode_inputs(cuda, b, window, d, seed=11)
    span, n_spans = _span_plan(window, b * 8, _sm_count(q.device))
    assert n_spans > 2
    visible = torch.zeros((b, window), dtype=torch.bool, device=cuda)
    visible[:, 2 * span + 3:2 * span + 40] = True
    kw = {}
    if cache == "int8":
        q = q.float()
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        kw = dict(k_scale=ks, v_scale=vs)
    out = fused_single_query_attention(q, k, v, visible, **kw)
    stats = fused_single_query_attention_stats(q, k, v, visible, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, fused_single_query_attention_plain(q, k, v, visible, **kw),
        rtol=0, atol=2e-3)
    _assert_stats_close(stats, fused_single_query_attention_stats_plain(
        q, k, v, visible, **kw))


def _decode_calls(cases):
    return [(fused_single_query_attention(*c),
             fused_single_query_attention_stats(*c)) for c in cases]


@pytest.mark.cuda
def test_decode_kernel_back_to_back_and_graph_replays(cuda):
    """Launches of different B*H one after another on one stream, without
    a sync between them, each agree with plain; the same launches
    captured in a CUDA graph and replayed twice equal the eager calls
    bitwise (the merge leaves its arrival counters zero for the next
    launch and the next replay)."""
    cases = []
    for b, window, d, seed in ((2, 8448, 64, 1), (8, 1152, 128, 2),
                               (1, 4224, 64, 3), (2, 4224, 64, 4)):
        q, k, v = _decode_inputs(cuda, b, window, d, seed)
        visible = torch.ones((b, window), dtype=torch.bool, device=cuda)
        visible[:, window // 3:window // 2] = False
        cases.append((q, k, v, visible.contiguous()))
    eager = _decode_calls(cases)
    torch.cuda.synchronize()
    for c, (out, stats) in zip(cases, eager):
        torch.testing.assert_close(
            out, fused_single_query_attention_plain(*c), rtol=0, atol=2e-3)
        _assert_stats_close(stats,
                            fused_single_query_attention_stats_plain(*c))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _decode_calls(cases)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _decode_calls(cases)
    for _ in range(2):
        for out, stats in captured:
            out.zero_()
            for t in stats:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for (out, stats), (g_out, g_stats) in zip(eager, captured):
            assert torch.equal(out, g_out)
            assert all(torch.equal(x, y) for x, y in zip(stats, g_stats))


@pytest.mark.cuda
@pytest.mark.parametrize("q_off,k_off", [(0, 0), (512, 0), (512, 512)])
def test_flash_lse_kernel_head_dim_64_ring_offsets(cuda, q_off, k_off):
    """K1[lse] at head dim 64 on the ring prefill's (shard, block) pairs:
    slabs of 512 at the offsets of two shards, causal, bf16."""
    gen = torch.Generator(device=cuda).manual_seed(q_off + 3 * k_off)
    q, k, v = (torch.randn((2, 512, 8, 64), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = flash_attention_with_lse(q, k, v, True, None, q_off, k_off)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, True, None,
                                                      q_off, k_off)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    _assert_out_norm_close(out, ref_out, torch.bfloat16)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)


def _assert_out_norm_close(got, ref, dtype):
    """||d||_F within 1e-2 of ||ref||_F at bf16 (1e-4 at f32).  An output
    entry is about sqrt(e/n) over n visible keys, so the 2e-2 absolute
    limit misses a V tile dropped while the log-sum-exp stays right; this
    limit sees it, and a dropped tile of a gradient too."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    d, r = got.float() - ref.float(), ref.float()
    assert (d.norm() / r.norm().clamp(min=1e-30)).item() <= tol


def _assert_grad_close(got, ref, dtype):
    """max|d| within 2e-2 of max|ref| and ||d||_F within 1e-2 of ||ref||_F
    at bf16 (1e-4 both at f32).  The max-relative limit alone is loose at
    bf16: the first rows' gradients dwarf a late row's, so a dropped or
    doubled tile of late keys or queries passes it; the norm-relative one
    catches that."""
    max_tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    d, r = got.float() - ref.float(), ref.float()
    assert (d.abs().max() / r.abs().max().clamp(min=1e-30)).item() <= max_tol
    _assert_out_norm_close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,causal,q_off,k_off,dtype,d", [
    (512, 512, True, 0, 0, torch.bfloat16, 128),
    (1000, 1000, True, 0, 0, torch.bfloat16, 128),
    (512, 512, True, 512, 0, torch.bfloat16, 128),
    (256, 256, True, 0, 100, torch.bfloat16, 128),   # 100 masked rows
    (300, 400, False, 0, 0, torch.bfloat16, 64),
    (700, 700, True, 0, 0, torch.float32, 128)])
def test_flash_lse_kernel_matches_plain(cuda, sq, sk, causal, q_off, k_off,
                                        dtype, d):
    gen = torch.Generator(device=cuda).manual_seed(sq + k_off)
    q = torch.randn((2, sq, 8, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, sk, 8, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    before = flash_attention_with_lse.launches
    out, lse = flash_attention_with_lse(q, k, v, causal, None, q_off, k_off)
    torch.cuda.synchronize()
    assert flash_attention_with_lse.launches == before + 1
    ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, causal, None,
                                                      q_off, k_off)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    _assert_out_norm_close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=0,
                               atol=1e-3 if dtype == torch.bfloat16 else 1e-4)
    if k_off > q_off:
        assert (lse[:, :k_off - q_off] <= NEG_INF / 2).all()
        assert torch.count_nonzero(out[:, :k_off - q_off]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("b,sq,sk,causal,q_off,d", [
    (2, 129, 129, True, 0, 128),    # one row and one key past a tile
    (2, 1, 640, True, 500, 128),    # one query (q_offset with lse only)
    (2, 300, 37, False, 0, 64),     # fewer keys than a tile
    (3, 200, 200, True, 0, 64),
    (2, 128, 128, True, 0, 128),    # one K/V tile: S's registers feed P V
    (2, 128, 100, False, 0, 128)])
def test_flash_kernel_at_tile_edges(cuda, b, sq, sk, causal, q_off, d,
                                    with_lse):
    """K1 and K1[lse] against plain at the edges of the bf16 kernel's
    128-row query tiles and 128-key K/V tiles."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn((b, sq, 8, d), generator=gen, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((b, sk, 8, d), generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    counter = flash_attention_with_lse if with_lse else flash_attention
    before = counter.launches
    if with_lse:
        out, lse = flash_attention_with_lse(q, k, v, causal, None, q_off)
        ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, causal,
                                                          None, q_off)
    else:
        out = flash_attention(q, k, v, causal=causal)
        ref_out = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    _assert_out_norm_close(out, ref_out, torch.bfloat16)
    if with_lse:
        torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)


# ------------------------------------------------ head dim 32 ---------

# K1 and K1[lse] at head dim 32 (bf16: the narrow wgmma kernel's 64-row
# query and 64-key tiles; f32: one warp per row): the prefill shape, and the
# tiles' edges -- a row and a key past a tile, one query deep in the
# sequence, fewer keys than a tile, B = 3, one tile exactly, a row whose
# every key lies ahead (k_offset > q_offset).
# (B, Sq, Sk, causal, q_offset, k_offset)
D32_FLASH = [(2, 1024, 1024, True, 0, 0), (2, 1000, 1000, False, 0, 0),
             (2, 129, 129, True, 0, 0), (2, 1, 640, True, 500, 0),
             (2, 300, 37, False, 0, 0), (3, 200, 200, True, 0, 0),
             (2, 64, 64, True, 0, 0), (2, 512, 512, True, 512, 0),
             (2, 512, 512, True, 0, 200)]


def _check_flash_kernels(cuda, d, b, sq, sk, causal, q_off, k_off, dtype):
    """K1 (without offsets) and K1[lse] at head dim d against plain: out
    within the D64/D128 cases' limits, lse within 1e-3 (bf16) / 1e-4; a
    second call bitwise equal to the first; K1 equal to K1[lse]'s out;
    rows that see no key exactly zero with lse NEG_INF."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + k_off + d % 32)
    q = torch.randn((b, sq, 8, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, sk, 8, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    before = (flash_attention.launches, flash_attention_with_lse.launches)
    out, lse = flash_attention_with_lse(q, k, v, causal, None, q_off, k_off)
    again, _ = flash_attention_with_lse(q, k, v, causal, None, q_off, k_off)
    no_lse = (flash_attention(q, k, v, causal=causal)
                 if q_off == k_off == 0 else None)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, causal, None,
                                                      q_off, k_off)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    _assert_out_norm_close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, rtol=0,
                               atol=1e-3 if dtype == torch.bfloat16 else 1e-4)
    if k_off > q_off:
        hidden = k_off - q_off
        assert torch.count_nonzero(out[:, :hidden]) == 0
        assert (lse[:, :hidden] == NEG_INF).all()
    if no_lse is not None:
        assert torch.equal(no_lse, out)
    assert (flash_attention.launches - before[0],
            flash_attention_with_lse.launches - before[1]) == (
        int(no_lse is not None), 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,causal,q_off,k_off", D32_FLASH)
def test_flash_kernels_at_head_dim_32(cuda, b, sq, sk, causal, q_off, k_off,
                                      dtype):
    """K1 and K1[lse] at head dim 32 against plain (`_check_flash_kernels`)."""
    _check_flash_kernels(cuda, 32, b, sq, sk, causal, q_off, k_off, dtype)


# K4 and K4[stats] at head dim 32: the serving window of a 16-row batch
# (the chip's timed shape), one span below a slot step, a span boundary,
# and the long window at the span cap.  (B, L)
D32_DECODE = [(16, 1088), (2, 37), (1, 65), (2, 8448)]


DECODE_CACHES = [("bfloat16", "bfloat16"), ("float32", "float32"),
                 ("int8", "bfloat16"), ("int8", "float32")]


def _check_decode_kernels(cuda, d, b, window, cache, q_dtype):
    """K4 within 2e-3 of plain and K4[stats] within the stats limits at
    head dim d, with the engine's mask layout and a fully masked last row;
    a second call bitwise equal; launches counted once each."""
    gen = torch.Generator(device=cuda).manual_seed(window + b + d % 32)
    q = torch.randn((b, 8, d), generator=gen, device=cuda).to(
        getattr(torch, q_dtype))
    kv_dtype = torch.float32 if cache == "float32" else torch.bfloat16
    k, v = (torch.randn((b, window, 8, d), generator=gen, device=cuda)
            .to(kv_dtype) for _ in range(2))
    bucket = max(1, window - 64)
    true_len = torch.randint(1, bucket + 1, (b,), generator=gen, device=cuda)
    slots = torch.arange(window, device=cuda)
    visible = ((slots[None] < true_len[:, None])
               | (slots >= bucket)[None]).contiguous()
    if b > 1:
        visible[-1] = False
    kw = {}
    if cache == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        kw = dict(k_scale=ks, v_scale=vs)
    before = (fused_single_query_attention.launches,
              fused_single_query_attention_stats.launches)
    out = fused_single_query_attention(q, k, v, visible, **kw)
    again = fused_single_query_attention(q, k, v, visible, **kw)
    stats = fused_single_query_attention_stats(q, k, v, visible, **kw)
    torch.cuda.synchronize()
    assert (fused_single_query_attention.launches - before[0],
            fused_single_query_attention_stats.launches - before[1]) == (2, 1)
    assert torch.equal(out, again)
    ref = fused_single_query_attention_plain(q, k, v, visible, **kw)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-3)
    _assert_stats_close(stats, fused_single_query_attention_stats_plain(
        q, k, v, visible, **kw))
    if b > 1:
        assert torch.count_nonzero(out[-1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cache,q_dtype", DECODE_CACHES)
@pytest.mark.parametrize("b,window", D32_DECODE)
def test_decode_kernels_at_head_dim_32(cuda, b, window, cache, q_dtype):
    """K4 and K4[stats] at head dim 32 against plain
    (`_check_decode_kernels`)."""
    _check_decode_kernels(cuda, 32, b, window, cache, q_dtype)


@pytest.mark.cuda
def test_flash_kernel_refuses_misaligned_tensors(cuda):
    """TMA reads 16-byte-aligned tensors only: a view that starts 2 bytes
    into its storage raises ValueError, and no kernel launches."""
    shape = (2, 64, 8, 128)
    n = int(np.prod(shape))
    good = torch.randn(shape, device=cuda).to(torch.bfloat16)
    bad = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)[1:n + 1]
    bad = bad.view(shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 2
    before = (flash_attention.launches, flash_attention_with_lse.launches)
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention(*args, causal=True)
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention_with_lse(*args, True)
    assert (flash_attention.launches,
            flash_attention_with_lse.launches) == before


def _backward_inputs(cuda, b, sq, sk, causal, q_off, k_off, dtype, d):
    """q, k, v, dout from a seed, and the forward's lse and delta (plain)."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + q_off + b + d)
    q, do = (torch.randn((b, sq, 8, d), generator=gen, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, sk, 8, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    out, lse = flash_attention_with_lse_plain(q, k, v, causal, d ** -0.5,
                                              q_off, k_off)
    return q, k, v, do, lse, (do.float() * out.float()).sum(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,causal,q_off,k_off,dtype,d", [
    (2, 512, 512, True, 0, 0, torch.bfloat16, 128),
    (2, 1000, 1000, True, 0, 0, torch.bfloat16, 128),
    (2, 768, 1280, False, 0, 0, torch.bfloat16, 128),
    (2, 512, 512, True, 512, 256, torch.bfloat16, 128),
    (2, 256, 256, True, 0, 100, torch.bfloat16, 64),
    (2, 700, 700, True, 0, 0, torch.float32, 128),
    # the edges of the bf16 kernels' 128-row owned and 64-row walked tiles
    (2, 129, 129, True, 0, 0, torch.bfloat16, 128),
    (2, 1, 640, True, 500, 0, torch.bfloat16, 128),   # one query row
    (2, 300, 37, False, 0, 0, torch.bfloat16, 64),    # fewer keys than a tile
    (3, 200, 200, True, 0, 0, torch.bfloat16, 64),
    (2, 128, 128, True, 0, 0, torch.bfloat16, 128),   # one key tile of K3
    (2, 200, 60, False, 0, 0, torch.bfloat16, 128),   # one key tile of K2
    # rows 0-99 of the first 128-row tile see no key: lse NEG_INF
    (2, 256, 256, True, 0, 100, torch.bfloat16, 128)])
def test_flash_backward_kernels_match_plain(cuda, b, sq, sk, causal, q_off,
                                            k_off, dtype, d):
    q, k, v, do, lse, delta = _backward_inputs(cuda, b, sq, sk, causal,
                                               q_off, k_off, dtype, d)
    scale = d ** -0.5
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, q_off, k_off)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, q_off,
                           k_off)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    refs = flash_block_grads_plain(q, k, v, do, lse, delta, causal, scale,
                                   q_off, k_off)
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == dtype and got.shape == ref.shape
        _assert_grad_close(got, ref, dtype)
    if k_off > q_off:
        assert torch.count_nonzero(dq[:, :k_off - q_off]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (64, torch.float32),
                                     (16, torch.bfloat16)])
def test_flash_backward_kernels_at_ring_offsets(cuda, d, dtype):
    """K2 and K3 as the ring-flash backward launches them: one shard's
    queries against one K/V block at the block pair's global offsets
    (the diagonal pairs and the off-diagonal one of a 2-shard ring,
    causal), against the lse and delta of the WHOLE sequence; each
    against the plain version on the same inputs."""
    b, s_l = 2, 384
    gen = torch.Generator(device=cuda).manual_seed(d + s_l)
    q, k, v, do = (torch.randn((b, 2 * s_l, 8, d), generator=gen,
                               device=cuda).to(dtype) for _ in range(4))
    scale = d ** -0.5
    out, lse = flash_attention_with_lse_plain(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1)

    def part(t, i):
        return t[:, i * s_l:(i + 1) * s_l].contiguous()

    for i, src in ((0, 0), (1, 0), (1, 1)):
        args = (part(q, i), part(k, src), part(v, src), part(do, i),
                part(lse, i), part(delta, i), True, scale, i * s_l,
                src * s_l)
        before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        torch.cuda.synchronize()
        assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
            before[0] + 1, before[1] + 1)
        for got, ref in zip((dq, dk, dv), flash_block_grads_plain(*args)):
            _assert_grad_close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_flash_autograd_on_one_card(cuda, dtype):
    """`seq_parallel_attention(impl="ring_flash")` over a data 1 x seq 2
    mesh whose shards share the card: output and q/k/v gradients against
    plain autograd of the dense attention, and exactly 3 launches each of
    K1[lse], K2 and K3 (the causal fold rule: n(n+1)/2 block pairs), 2 of
    them on diagonal blocks and 1 below."""
    from mmlspark_tpu_torch.ops.attention import attention
    from mmlspark_tpu_torch.parallel.ring import seq_parallel_attention
    mesh = make_mesh(MeshSpec(data=1, seq=2), [cuda, cuda])
    gen = torch.Generator(device=cuda).manual_seed(3)
    base = [torch.randn((2, 512, 8, 64), generator=gen, device=cuda)
            .to(dtype) for _ in range(3)]
    leaves = [t.clone().requires_grad_() for t in base]
    kernels = (flash_attention_with_lse, flash_bwd_dq, flash_bwd_dkv)
    before = [(fn.launches, dict(fn.block_launches)) for fn in kernels]
    out = seq_parallel_attention(mesh, *leaves, causal=True,
                                 impl="ring_flash")
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    for fn, (total, blocks) in zip(kernels, before):
        assert fn.launches - total == 3
        assert {kind: n - blocks[kind] for kind, n in
                fn.block_launches.items()} == {"diagonal": 2,
                                               "off-diagonal": 1}
    refs = [t.float().clone().requires_grad_() for t in base]
    ref = attention(*refs, causal=True)
    (ref ** 2).sum().backward()
    _assert_out_norm_close(out, ref, dtype)
    for got, want in zip(leaves, refs):
        _assert_grad_close(got.grad, want.grad, dtype)


@pytest.mark.cuda
def test_flash_backward_refuses_misaligned_tensors(cuda):
    """K2 and K3 read q, k, v and dout through TMA: a view that starts 2
    bytes into its storage raises ValueError, and no kernel launches."""
    shape = (2, 64, 8, 128)
    n = int(np.prod(shape))
    args = list(_backward_inputs(cuda, 2, 64, 64, True, 0, 0,
                                 torch.bfloat16, 128))
    bad = torch.zeros(n + 8, dtype=torch.bfloat16, device=cuda)[1:n + 1]
    bad = bad.view(shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 2
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    for i, name in enumerate(("q", "k", "v", "dout")):
        call = args[:i] + [bad] + args[i + 1:]
        for kernel in (flash_bwd_dq, flash_bwd_dkv):
            with pytest.raises(ValueError, match=f"{name} is not 16-byte"):
                kernel(*call, True, 128 ** -0.5)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_backward_kernels_are_deterministic(cuda, d):
    """One writer per output and no atomics: two launches on the same
    inputs give bitwise-equal dq, dk and dv."""
    args = _backward_inputs(cuda, 2, 1000, 1000, True, 0, 0, torch.bfloat16,
                            d)
    first = (flash_bwd_dq(*args, True, d ** -0.5),
             *flash_bwd_dkv(*args, True, d ** -0.5))
    second = (flash_bwd_dq(*args, True, d ** -0.5),
              *flash_bwd_dkv(*args, True, d ** -0.5))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_autograd_matches_plain_autograd(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v, do = (torch.randn((2, 1000, 8, 128), generator=gen, device=cuda)
                   .to(dtype).requires_grad_() for _ in range(4))
    before = (flash_attention_with_lse.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    got = torch.autograd.grad(flash_attention(q, k, v, causal=True),
                              (q, k, v), do.detach())
    torch.cuda.synchronize()
    assert (flash_attention_with_lse.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref = torch.autograd.grad(
        flash_attention_with_lse_plain(q, k, v, causal=True)[0], (q, k, v),
        do.detach())
    for a, b in zip(got, ref):
        _assert_grad_close(a, b, dtype)


# ------------------------------------------- head dims 8 and 16 -------

SMALL_HEAD_DIMS = [8, 16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,sq,sk,causal,q_off,k_off", D32_FLASH)
@pytest.mark.parametrize("d", SMALL_HEAD_DIMS)
def test_flash_kernels_at_small_head_dims(cuda, d, b, sq, sk, causal, q_off,
                                          k_off, dtype):
    """K1 and K1[lse] at head dims 8 and 16 (bf16: the narrow wgmma
    kernel; f32: the register-tiled kernel) at the head-dim-32
    cases' tile edges and limits (`_check_flash_kernels`)."""
    _check_flash_kernels(cuda, d, b, sq, sk, causal, q_off, k_off, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,causal,q_off,k_off", [
    (2, 129, 129, True, 0, 0), (2, 1, 640, True, 500, 0),
    (2, 300, 37, False, 0, 0), (2, 512, 512, True, 0, 200)])
@pytest.mark.parametrize("d", [64, 128])
def test_f32_flash_kernel_at_wide_head_dims(cuda, d, b, sq, sk, causal,
                                            q_off, k_off):
    """The register-tiled f32 K1 at head dims 64 and 128 (its largest
    shared tiles and register micro-tiles) at the tile edges: out within
    1e-4 of plain, lse within 1e-4, rows that see no key exactly zero."""
    gen = torch.Generator(device=cuda).manual_seed(sq + sk + d)
    q = torch.randn((b, sq, 8, d), generator=gen, device=cuda)
    k, v = (torch.randn((b, sk, 8, d), generator=gen, device=cuda)
            for _ in range(2))
    out, lse = flash_attention_with_lse(q, k, v, causal, None, q_off, k_off)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, causal, None,
                                                      q_off, k_off)
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    if k_off > q_off:
        assert torch.count_nonzero(out[:, :k_off - q_off]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cache,q_dtype", DECODE_CACHES)
@pytest.mark.parametrize("b,window", D32_DECODE)
@pytest.mark.parametrize("d", SMALL_HEAD_DIMS)
def test_decode_kernels_at_small_head_dims(cuda, d, b, window, cache,
                                           q_dtype):
    """K4 and K4[stats] at head dims 8 and 16 (one-lane slot groups; at 8
    an int8 row is one 8-byte load; the span merge's groups capped at the
    warps) against plain (`_check_decode_kernels`)."""
    _check_decode_kernels(cuda, d, b, window, cache, q_dtype)


# K2 and K3 at head dims 8-128 (bf16 at 8-32: the narrow wgmma pair; f32:
# the register-tiled pair, 64 owned rows in four warps of 16): the training
# shape's causal diagonal, non-causal ragged sides, offsets with rows that
# see no key, the edges of the 64-row owned and walked tiles, and the f32
# K3's warp edges (Sk = 33: one valid row in warp 2 and warp 3 past Sk;
# Sk = 96: half the second CTA).  (B, Sq, Sk, causal, q_offset, k_offset)
SMALL_BACKWARD = [(2, 512, 512, True, 0, 0), (2, 768, 1280, False, 0, 0),
                  (2, 512, 512, True, 512, 256), (2, 256, 256, True, 0, 100),
                  (2, 129, 129, True, 0, 0), (2, 1, 640, True, 500, 0),
                  (2, 300, 37, False, 0, 0), (3, 200, 200, True, 0, 0),
                  (2, 64, 64, True, 0, 0), (2, 200, 33, False, 0, 0),
                  (2, 33, 33, True, 0, 0), (2, 96, 96, True, 0, 0),
                  (2, 160, 96, False, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,causal,q_off,k_off", SMALL_BACKWARD)
@pytest.mark.parametrize("d,dtype", [
    (8, torch.bfloat16), (8, torch.float32), (16, torch.bfloat16),
    (16, torch.float32), (32, torch.bfloat16), (32, torch.float32),
    (64, torch.float32), (128, torch.float32)])
def test_flash_backward_kernels_at_small_head_dims(cuda, d, dtype, b, sq, sk,
                                                   causal, q_off, k_off):
    """K2 and K3 at head dims 8, 16 and 32, and at f32 also 64 and 128
    (the register-tiled pair's widest tiles and accumulators), against
    plain with the head-dim-64/128 gradient limits; a second launch
    bitwise equal (one writer per output, no atomics)."""
    q, k, v, do, lse, delta = _backward_inputs(cuda, b, sq, sk, causal,
                                               q_off, k_off, dtype, d)
    scale = d ** -0.5
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, q_off, k_off)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, q_off,
                           k_off)
    dq2 = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale, q_off, k_off)
    dk2, dv2 = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale, q_off,
                             k_off)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 2, before[1] + 2)
    refs = flash_block_grads_plain(q, k, v, do, lse, delta, causal, scale,
                                   q_off, k_off)
    for got, again, ref in zip((dq, dk, dv), (dq2, dk2, dv2), refs):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.equal(got, again)
        _assert_grad_close(got, ref, dtype)
    if k_off > q_off:
        assert torch.count_nonzero(dq[:, :k_off - q_off]) == 0


@pytest.mark.cuda
def test_f32_flash_backward_refuses_misaligned_tensors(cuda):
    """The f32 K2 and K3 read q, k, v and dout by cp.async, 16 bytes at a
    time: a view 4 bytes into its storage raises ValueError, and no kernel
    launches."""
    shape = (2, 64, 8, 64)
    n = int(np.prod(shape))
    args = list(_backward_inputs(cuda, 2, 64, 64, True, 0, 0,
                                 torch.float32, 64))
    bad = torch.zeros(n + 8, dtype=torch.float32, device=cuda)[1:n + 1]
    bad = bad.view(shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 4
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    for i, name in enumerate(("q", "k", "v", "dout")):
        call = args[:i] + [bad] + args[i + 1:]
        for kernel in (flash_bwd_dq, flash_bwd_dkv):
            with pytest.raises(ValueError, match=f"{name} is not 16-byte"):
                kernel(*call, True, 64 ** -0.5)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [8, 16, 32])
def test_flash_autograd_at_small_head_dims(cuda, d, dtype):
    """`torch.autograd.grad` through `flash_attention` at head dims 8-32:
    K1[lse] forward, K2 + K3 backward, each launched once, against plain
    autograd."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v, do = (torch.randn((2, 1000, 8, d), generator=gen, device=cuda)
                   .to(dtype).requires_grad_() for _ in range(4))
    before = (flash_attention_with_lse.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    got = torch.autograd.grad(flash_attention(q, k, v, causal=True),
                              (q, k, v), do.detach())
    torch.cuda.synchronize()
    assert (flash_attention_with_lse.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    ref = torch.autograd.grad(
        flash_attention_with_lse_plain(q, k, v, causal=True)[0], (q, k, v),
        do.detach())
    for a, b in zip(got, ref):
        _assert_grad_close(a, b, dtype)


@pytest.mark.cuda
def test_small_head_dim_kernels_refuse_misaligned_tensors(cuda):
    """The cp.async kernels (K1 at every dtype below head dim 64 and at
    f32, K2/K3 bf16 below 64) read 16 bytes at a time: a view 4 bytes into
    its storage raises ValueError, and no kernel launches."""
    shape = (2, 64, 8, 16)
    n = int(np.prod(shape))
    for dtype in (torch.float32, torch.bfloat16):
        good = torch.randn(shape, device=cuda).to(dtype)
        offset = 4 // good.element_size()
        bad = torch.zeros(n + 16, dtype=dtype, device=cuda)[offset:n + offset]
        bad = bad.view(shape)
        assert bad.data_ptr() % 16 == 4
        before = (flash_attention.launches, flash_attention_with_lse.launches)
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention(bad, good, good, causal=True)
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_attention_with_lse(good, bad, good, True)
        assert (flash_attention.launches,
                flash_attention_with_lse.launches) == before


@pytest.mark.parametrize("sm_count", [1, 114, 132])
def test_k1_split_plan_matches_enumeration(sm_count):
    """The bf16 K1 at head dims 8-32 splits a CTA's key walk between two
    warpgroups exactly when its grid, counted query tile by query tile,
    gives fewer than SPLIT_BELOW CTAs an SM."""
    fa = importlib.import_module("mmlspark_tpu_torch.ops.flash_attention")
    for b in (1, 2, 3, 8):
        for h in (1, 3, 8):
            for sq in (1, 63, 64, 65, 500, 1000, 1024, 2048, 4097):
                ctas = sum(1 for _ in range(b) for _ in range(h)
                           for start in range(0, sq, fa.NARROW_ROWS))
                want = 2 if ctas < fa.SPLIT_BELOW * sm_count else 1
                assert fa._k1_split(b, h, sq, sm_count) == want, (b, h, sq)


# ---------------------- the wgmma kernels at head dims 8, 16 and 32 ---

# bf16 K1 (`flash_fwd_bf16_narrow`: 64 query rows a CTA, two warpgroups
# splitting the 64-key tiles, merged in a fixed order), K2
# (`flash_bwd_dq_narrow`: 128 owned queries, two warpgroups, 64-key tiles
# on a TMA ring) and K3 (`flash_bwd_dkv_narrow`: 128 owned keys, two
# warpgroups, 64-query tiles on a TMA ring whose statistics the producer
# warp stores; one warpgroup of 64 at head dim 8 in both): tile and split
# edges (Sq = Sk = 33, 96; 128 and 129 rows; 192, where the split walk's
# last tile falls to the first warpgroup), the training shape's length,
# ragged non-causal sides both ways, the phase-15 offsets (200 rows that
# see no key), and H = 1 and 3, whose (B, Sq, H) statistics rows are not
# 16-byte multiples.  (B, Sq, Sk, H, causal, q_offset, k_offset)
NARROW_CASES = [(2, 33, 33, 8, True, 0, 0), (2, 96, 96, 8, True, 0, 0),
                (2, 1000, 1000, 8, True, 0, 0), (2, 300, 700, 8, False, 0, 0),
                (2, 700, 300, 8, False, 0, 0), (2, 512, 512, 8, True, 512, 0),
                (2, 512, 512, 8, True, 0, 200), (2, 128, 128, 8, True, 0, 0),
                (2, 129, 129, 8, True, 0, 0), (2, 192, 192, 8, True, 0, 0),
                (1, 200, 200, 1, True, 0, 0), (3, 130, 130, 3, True, 0, 0),
                (2, 1, 640, 3, True, 500, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,causal,q_off,k_off", NARROW_CASES)
@pytest.mark.parametrize("d", [8, 16, 32])
def test_narrow_wgmma_kernels_match_plain(cuda, d, b, sq, sk, h, causal,
                                          q_off, k_off):
    """bf16 K1, K1[lse], K2 and K3 at head dims 8-32 against plain with
    the head-dim-64/128 limits; K1 equal to K1[lse]'s out and every
    kernel's second launch bitwise equal to its first; rows that see no
    key exactly zero out and dQ with lse NEG_INF, and keys that no query
    sees exactly zero dK, dV."""
    gen = torch.Generator(device=cuda).manual_seed(sq + 7 * sk + h + d)
    q, do = (torch.randn((b, sq, h, d), generator=gen, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, sk, h, d), generator=gen, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    scale = d ** -0.5
    before = (flash_attention.launches, flash_attention_with_lse.launches,
              flash_bwd_dq.launches, flash_bwd_dkv.launches)
    out, lse = flash_attention_with_lse(q, k, v, causal, None, q_off, k_off)
    out2, lse2 = flash_attention_with_lse(q, k, v, causal, None, q_off,
                                          k_off)
    no_lse = (flash_attention(q, k, v, causal=causal)
              if q_off == k_off == 0 else None)
    ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, causal, None,
                                                      q_off, k_off)
    delta = (do.float() * ref_out.float()).sum(-1)
    dq = flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale, q_off,
                      k_off)
    dq2 = flash_bwd_dq(q, k, v, do, ref_lse, delta, causal, scale, q_off,
                       k_off)
    dk, dv = flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal, scale, q_off,
                           k_off)
    dk2, dv2 = flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal, scale,
                             q_off, k_off)
    torch.cuda.synchronize()
    assert (flash_attention.launches - before[0],
            flash_attention_with_lse.launches - before[1],
            flash_bwd_dq.launches - before[2],
            flash_bwd_dkv.launches - before[3]) == (
        int(no_lse is not None), 2, 2, 2)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(dq, dq2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if no_lse is not None:
        assert torch.equal(no_lse, out)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    _assert_out_norm_close(out, ref_out, torch.bfloat16)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
    refs = flash_block_grads_plain(q, k, v, do, ref_lse, delta, causal,
                                   scale, q_off, k_off)
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _assert_grad_close(got, ref, torch.bfloat16)
    if causal and k_off > q_off:
        hidden = k_off - q_off
        assert torch.count_nonzero(out[:, :hidden]) == 0
        assert torch.count_nonzero(dq[:, :hidden]) == 0
        assert (lse[:, :hidden] == NEG_INF).all()
    if causal and q_off + sq - 1 < k_off + sk - 1:
        # keys past the last query's reach get exactly zero gradients
        seen = max(0, q_off + sq - k_off)
        assert torch.count_nonzero(dk[:, seen:]) == 0
        assert torch.count_nonzero(dv[:, seen:]) == 0


# ------------------------------------------------ serving on the card ---

SERVE_CFG = {"vocab_size": 256, "d_model": 256, "n_heads": 4, "n_layers": 2,
             "max_len": 1024, "dtype": "bfloat16"}


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["model", "int8"])
def test_serve_step_runs_the_decode_kernel_on_a_mixed_age_batch(
        cuda, cache, monkeypatch):
    """`serve_step` over a resident batch whose rows sit at different
    ages, with a free slot (born done) and a row that spends its budget
    mid-segment: every K4 read inside it agrees with the plain read on
    the same inputs, and K4 launches n_layers x seg_len times."""
    from mmlspark_tpu_torch.models import generate
    bundle = ModelBundle.init("TransformerLM", SERVE_CFG, seed=3)
    engine = DecodeEngine(bundle.module(cuda), 24, chunk=16,
                          cache_dtype=cache, device=cuda)
    rng = np.random.default_rng(3)
    lengths, bucket = [5, 9, 16, 1], 16
    prompts = np.zeros((4, bucket), np.int64)
    for j, n in enumerate(lengths):
        prompts[j, :n] = rng.integers(0, SERVE_CFG["vocab_size"], n)
    live = np.asarray([True, True, True, False])
    tok, done, caches = engine.serve_prefill(prompts, lengths, live,
                                             [0, 1, 2, 3])
    errs = []
    kernel = generate.fused_single_query_attention

    def checked(q, k, v, visible, **scales):
        out = kernel(q, k, v, visible, **scales)
        ref = fused_single_query_attention_plain(q, k, v, visible, **scales)
        errs.append((out - ref).abs().max().item())
        return out

    monkeypatch.setattr(generate, "fused_single_query_attention", checked)
    seg, t_row = 8, np.asarray([0, 3, 9, 0])
    budget = np.asarray([24, 6, 24, 0])
    window = engine.serve_window(bucket, int(t_row.max()), seg)
    before = fused_single_query_attention.launches
    caches, toks, tok, done = engine.serve_step(
        caches, tok, done, lengths, budget, bucket, t_row, [0, 1, 2, 3],
        seg, window)
    torch.cuda.synchronize()
    assert fused_single_query_attention.launches - before == \
        SERVE_CFG["n_layers"] * seg
    assert len(errs) == SERVE_CFG["n_layers"] * seg
    assert max(errs) <= 2e-3
    assert caches[0][0].shape[1] == window == 48
    done = done.cpu().numpy()
    assert done[1] and done[3] and not done[0] and not done[2]
    toks = toks.cpu().numpy()
    assert ((toks >= 0) & (toks < SERVE_CFG["vocab_size"])).all()
    assert (toks[1, 2:] == toks[1, 2]).all()   # frozen after its budget


@pytest.mark.cuda
def test_warmup_builds_and_runs_both_serving_kernels(cuda):
    """Readiness means the kernels are built and loaded: warming a bucket
    of 512 runs K1 at every cohort prefill and K4 at every step."""
    from mmlspark_tpu_torch.ops.native import _libs
    from mmlspark_tpu_torch.serve import ServeConfig, ServingEngine
    bundle = ModelBundle.init("TransformerLM", SERVE_CFG, seed=4)
    engine = ServingEngine(bundle, ServeConfig(
        max_new_tokens=16, max_batch=2, segment_steps=8,
        warmup_buckets=(512,)), device=cuda)
    before = (flash_attention.launches, fused_single_query_attention.launches)
    engine.warmup()
    assert engine.ready
    assert {"flash_attention", "decode_attention"} <= set(_libs)
    layers = SERVE_CFG["n_layers"]
    # cohorts of 1 and 2 rows; two 8-step segments of a 16-token ladder
    assert flash_attention.launches - before[0] == 2 * layers
    assert fused_single_query_attention.launches - before[1] == \
        2 * 8 * layers


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chunk0_of_512_tokens_runs_the_flash_kernel(cuda, dtype,
                                                    monkeypatch):
    """Chunk 0 of a chunked prefill sits at slot 0, so a 512-token chunk
    runs K1 once per layer; each K1 output agrees with the dense branch
    (causal softmax over the same q, k, v in f32) within the K1
    tolerance.  Chunk 1 runs the dense branch and launches nothing; at
    f32 the first tokens equal the whole-prompt prefill's."""
    from mmlspark_tpu_torch.models import generate
    bundle = ModelBundle.init("TransformerLM", {**SERVE_CFG, "dtype": dtype},
                              seed=5)
    engine = DecodeEngine(bundle.module(cuda), 16, chunk=64,
                          prefill_chunk=512, device=cuda)
    rng = np.random.default_rng(5)
    lengths, bucket = [600, 1000], 1024
    prompts = np.zeros((2, bucket), np.int64)
    for j, n in enumerate(lengths):
        prompts[j, :n] = rng.integers(0, SERVE_CFG["vocab_size"], n)
    kernel, checked_calls = generate.flash_attention, []

    def checked(q, k, v, causal):
        out = kernel(q, k, v, causal=causal)
        s, dh = q.shape[1], q.shape[-1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              k.float()) * dh ** -0.5
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        w = torch.softmax(torch.where(keep, scores, NEG_INF), dim=-1)
        ref = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
        tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
        _assert_out_norm_close(out, ref, q.dtype)
        checked_calls.append(s)
        return out

    monkeypatch.setattr(generate, "flash_attention", checked)
    before = flash_attention.launches
    state = engine.serve_prefill_chunk(prompts, lengths, 0, None)
    torch.cuda.synchronize()
    layers = SERVE_CFG["n_layers"]
    assert flash_attention.launches - before == layers
    assert checked_calls == [512] * layers
    state = engine.serve_prefill_chunk(prompts, lengths, 1, state)
    tok, done, caches = engine.serve_prefill_finish(
        state, np.ones(2, bool), [0, 1])
    torch.cuda.synchronize()
    assert flash_attention.launches - before == layers
    assert caches[0][0].shape[1] == 1088
    if dtype == "float32":
        whole, _, _ = engine.serve_prefill(prompts, lengths,
                                           np.ones(2, bool), [0, 1])
        assert torch.equal(tok, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["model", "int8"])
def test_resumed_row_first_segment_runs_the_decode_kernel(cuda, cache,
                                                          monkeypatch):
    """A row resumed from pooled prefix rows (dequantized and re-quantized
    for an int8 cache), spliced beside an older row: every K4 read of its
    first segment agrees with the plain read within 2e-3, n_layers x
    seg_len launches."""
    from mmlspark_tpu_torch.models import generate
    from mmlspark_tpu_torch.serve.engine import _assemble_prefix_row
    from mmlspark_tpu_torch.serve.prefix_cache import PrefixCache
    bundle = ModelBundle.init("TransformerLM", SERVE_CFG, seed=6)
    engine = DecodeEngine(bundle.module(cuda), 24, chunk=16,
                          cache_dtype=cache, prefill_chunk=16, device=cuda)
    rng = np.random.default_rng(6)
    bucket = 64
    prompts = np.zeros((2, bucket), np.int64)
    prompts[:, :40] = rng.integers(0, SERVE_CFG["vocab_size"], (2, 40))
    tok, done, caches = engine.serve_prefill(prompts, [40, 40],
                                             np.ones(2, bool), [0, 1])
    pool = PrefixCache(16)
    pool.insert(prompts[0, :40], 32,
                [tuple(t[0:1] for t in layer) for layer in caches])
    shared = prompts[0:1].copy()
    shared[0, 32:40] = 7                    # a new suffix after 32 tokens
    hit = pool.acquire(shared[0, :40], 32)
    assert hit.n_tokens == 32
    r_tok, _, r_caches = engine.serve_prefill_resume(
        shared, [40], 32, _assemble_prefix_row(hit.rows), [True], [2])
    pool.release(hit)
    merged = DecodeEngine.merge_cache_rows(caches, r_caches, [1], [0])
    tok = tok.clone()
    tok[1] = r_tok[0]
    errs, kernel = [], generate.fused_single_query_attention

    def checked(q, k, v, visible, **scales):
        out = kernel(q, k, v, visible, **scales)
        ref = fused_single_query_attention_plain(q, k, v, visible, **scales)
        errs.append((out - ref).abs().max().item())
        return out

    monkeypatch.setattr(generate, "fused_single_query_attention", checked)
    seg, t_row = 8, np.asarray([5, 0])
    window = engine.serve_window(bucket, int(t_row.max()), seg)
    before = fused_single_query_attention.launches
    merged, toks, _, done = engine.serve_step(
        merged, tok, np.zeros(2, bool), [40, 40], np.asarray([24, 24]),
        bucket, t_row, [0, 2], seg, window)
    torch.cuda.synchronize()
    assert fused_single_query_attention.launches - before == \
        SERVE_CFG["n_layers"] * seg
    assert len(errs) == SERVE_CFG["n_layers"] * seg
    assert max(errs) <= 2e-3
    toks = toks.cpu().numpy()
    assert ((toks >= 0) & (toks < SERVE_CFG["vocab_size"])).all()


# ------------------------------- vision scoring (no kernel) on the card ---

@pytest.mark.cuda
@pytest.mark.parametrize("arch,config,shape,classes", [
    ("ConvNetCIFAR10", {"dtype": "float32"}, (1, 32, 32, 3), 3),
    ("ResNet", {"stage_sizes": [1, 1, 1, 1], "block_kind": "bottleneck",
                "dtype": "float32"}, (1, 64, 64, 3), 20)])
def test_scoring_forward_on_the_card_matches_the_cpu(cuda, arch, config,
                                                     shape, classes):
    """TPUModel's forward on the card (cuDNN, TF32 off by the stage at f32
    even with TF32 on globally) against the CPU's at the same precision,
    on seeded weights made input-dependent by `calibrated_bundle` (the
    f32 argmax takes at least `classes` classes): within 1e-4 of max
    |logit| at f32, 2e-2 with bf16 activations and 4e-2 with int8
    weights (read on an H100: at most 6.2e-3 / 1.5e-2, and 0.17 or more
    with a planted fault: one conv's kh and kw swapped, or an int8 scale
    rolled by a channel)."""
    from mmlspark_tpu_torch.models.bundle import calibrated_bundle
    from mmlspark_tpu_torch.quant import quantize_bundle
    images = np.random.default_rng(2).integers(
        0, 256, (70,) + shape[1:], dtype=np.uint8)
    bundle = calibrated_bundle(
        ModelBundle.init(arch, config, seed=0, input_shape=shape),
        images[:32], seed=1, branch_scale=0.1)
    table = DataTable({"x": images})

    def score(device, b=bundle, **params):
        return TPUModel(b, device=device, inputCol="x", outputCol="y",
                        miniBatchSize=32, **params).transform(table)["y"]

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = score("cuda")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    ref = score("cpu")
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert len(np.unique(ref.argmax(1))) >= classes
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    int8 = quantize_bundle(bundle, "int8")
    for arm, limit in (({"computeDtype": "bfloat16"}, 2e-2),
                       ({"b": int8}, 4e-2)):
        card, cpu = score("cuda", **arm), score("cpu", **arm)
        assert np.isfinite(card).all()
        assert np.abs(card - cpu).max() <= limit * np.abs(cpu).max()


# ----------------------------------- the image pipeline (no kernel) on the card

# name -> (op, its key in chip_smoke.OP_LIMITS: absolute on [0, 255])
IMAGE_OPS = {
    "resize_linear": (lambda x: image_ops.resize(x, 50, 70), "resize"),
    "resize_cubic": (lambda x: image_ops.resize(x, 90, 30, "cubic"),
                     "resize"),
    "resize_lanczos3": (lambda x: image_ops.resize(x, 50, 70, "lanczos3"),
                        "resize"),
    "resize_nearest": (lambda x: image_ops.resize(x, 33, 81, "nearest"),
                       "exact"),
    "gray": (lambda x: image_ops.cvt_color(x, "bgr2gray"), "gray"),
    "swap": (lambda x: image_ops.cvt_color(x, "bgr2rgb"), "exact"),
    "blur_4x4": (lambda x: image_ops.blur(x, 4, 4), "blur"),
    "gaussian_4": (lambda x: image_ops.gaussian_kernel(x, 4, 1.0),
                   "gaussian"),
    "gaussian_blur_5": (lambda x: image_ops.gaussian_blur(x, 5, 0.0),
                        "gaussian"),
    "threshold": (lambda x: image_ops.threshold(x, 127.0, 255.0,
                                                "tozero_inv"), "exact"),
    "flip": (lambda x: image_ops.flip(x, -1), "exact"),
    "crop": (lambda x: image_ops.crop(x, 3, 5, 40, 30), "exact"),
    "normalize": (lambda x: image_ops.normalize(x, [0.4, 0.5, 0.6]),
                  "normalize"),
    "unroll": (lambda x: image_ops.unroll(x), "exact"),
}
IMAGE_HOST = np.random.default_rng(4).integers(0, 256, (3, 61, 47, 3),
                                               dtype=np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(IMAGE_OPS))
def test_image_ops_on_the_card_match_the_cpu(cuda, name):
    """Each image op on the card against the same op on the CPU, TF32 on
    globally (the gaussian's conv and the lanczos matmuls turn it off):
    exact where the op only moves or compares values, else within
    chip_smoke's absolute limit of the op (resize 1e-2; blur, gaussian
    and gray 1e-3; normalize 1e-5)."""
    fn, kind = IMAGE_OPS[name]
    host = IMAGE_HOST
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fn(torch.from_numpy(host).to(cuda))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    ref = fn(torch.from_numpy(host))
    assert got.device.type == "cuda" and got.dtype == ref.dtype
    diff = (got.cpu().float() - ref.float()).abs().max().item()
    assert diff <= chip_smoke.OP_LIMITS[kind], diff


@pytest.mark.cuda
def test_image_op_limits_reject_the_lanczos_resize_in_tf32(cuda):
    """The TF32 control: the lanczos3 resize with its matmuls in TF32 (the
    `exact_f32` guard taken away) errs far past the resize limit that
    the sound op keeps."""
    fn, kind = IMAGE_OPS["resize_lanczos3"]
    x = torch.from_numpy(IMAGE_HOST).to(cuda)
    got = chip_smoke.tf32_lanczos(x, 50, 70).cpu()
    diff = (got - fn(torch.from_numpy(IMAGE_HOST))).abs().max().item()
    assert diff > chip_smoke.OP_LIMITS[kind], diff


# -- the AutoML layer on the card (phase 24 holds it at full size) --------

@pytest.mark.cuda
def test_trees_are_bit_repeatable_on_the_card(cuda):
    """Two fits of a forest and of a boosted ensemble on the card give
    bit-equal trees (histograms summed in a fixed order, the ordered
    prefix sums), and predict as the CPU's fit does on >= 99.9% of the
    rows (the boosted gradients pass through the card's own sigmoid, so
    a near-tie split may part)."""
    from mmlspark_tpu_torch.ml import GBTClassifier, RandomForestClassifier
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3000, 12)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] + 0.5 * rng.normal(size=3000) > 0)
    table = DataTable({"features": x, "label": y.astype(np.float64)})

    for make in (lambda d: RandomForestClassifier(numTrees=8, maxDepth=6,
                                                  device=d),
                 lambda d: GBTClassifier(maxIter=8, maxDepth=5, device=d)):
        first, second = make(cuda).fit(table), make(cuda).fit(table)
        arrays = [[a for e in m.ensembles for t in e.trees for a in t]
                  for m in (first, second)]
        assert len(arrays[0]) == len(arrays[1])
        for a, b in zip(*arrays):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        on_cpu = make("cpu").fit(table)
        agree = np.mean(first.transform(table)["prediction"]
                        == on_cpu.transform(table)["prediction"])
        assert agree >= 0.999


@pytest.mark.cuda
def test_text_library_builds_with_zlib_alone(cuda):
    """The fused text hasher is its own library, linked with -lz only, so
    a host without the image codecs' headers builds it; it hashes as the
    Python stages do."""
    from mmlspark_tpu_torch.feature import HashingTF, Tokenizer
    assert native_loader.TEXT_LINK_LIBS == ("-lz",)
    path = native_loader.build_text()
    assert os.path.basename(path).startswith("libmmltext-")
    docs = ["The quick brown fox", "  jumps\tover the\nlazy dog ", ""]
    rows, fallback = native_loader.native_text_hash(
        docs, [], True, False, 0, 1 << 10, False)
    staged = HashingTF(inputCol="t", numFeatures=1 << 10).transform(
        Tokenizer(inputCol="d", outputCol="t").transform(
            DataTable({"d": np.asarray(docs, object)})))["tf"]
    assert fallback == []
    for (i, v), (si, sv) in zip(rows, staged):
        assert i.tobytes() == si.tobytes() and v.tobytes() == sv.tobytes()
