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
from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
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
    covered = {os.path.relpath(os.path.dirname(p), PKG) for p in sources[1:]}
    assert {"train", "parallel", "utils", "ops", "models"} <= covered
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
    assert '"mmlspark_tpu_torch" = ["csrc/*.cu", "csrc/*.cuh"]' in pyproject


def _cpu_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(MeshSpec(**{"data": 1, **axes}),
                     [torch.device("cpu")] * n)


def test_unported_options_raise():
    """Chunked prefill, speculation, beam search and tensor-parallel decode
    (a model axis) raise NotImplementedError; a mesh that is not a port
    `Mesh` is refused."""
    bundle = ModelBundle.init("TransformerLM", CFG)
    module = bundle.module("cpu")
    for kw in ({"prefill_chunk": 4}, {"spec_tokens": 2},
               {"mesh": _cpu_mesh(model=2)}):
        with pytest.raises(NotImplementedError):
            DecodeEngine(module, 4, device="cpu", **kw)
    for param in ("beamWidth", "specTokens", "prefillChunk"):
        stage = TextGenerator(bundle, device="cpu", inputCol="p",
                              **{param: 2})
        with pytest.raises(NotImplementedError, match=param):
            stage.transform(_table([[1, 2, 3]]))
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
