"""The port's seq-sharded attention pieces against the JAX package, on the
CPU: the stats entry of the decode read (K4[stats]), the cross-shard
merge, ring attention over a sequence mesh, and the single-controller
collectives and meshes they run on.

The port's wrappers run their plain versions on CPU tensors; the JAX
Pallas kernel runs in interpret mode, as the JAX package's own tests run
it.  A port mesh of n shards here is n repeats of the CPU device; the JAX
side runs on the virtual CPU devices of tests/conftest.py.  Tolerance:
f32 math on both sides, differing only in summation order (1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.attention import (
    single_query_attention as jax_single_query_attention)
from mmlspark_tpu.ops.decode_attention import (
    fused_single_query_attention_stats as jax_stats)
from mmlspark_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from mmlspark_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mmlspark_tpu.parallel.ring import (
    seq_parallel_attention as jax_seq_parallel_attention)
from mmlspark_tpu.quant.quantize import quantize_kv as jax_quantize_kv
from mmlspark_tpu_torch.ops.attention import (NEG_INF, merge_attention_stats,
                                              ring_attention)
from mmlspark_tpu_torch.ops.decode_attention import (
    fused_single_query_attention_stats,
    fused_single_query_attention_stats_plain)
from mmlspark_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh
from mmlspark_tpu_torch.parallel.ring import (pmax, ppermute, psum, reshard,
                                              seq_parallel_attention, shard,
                                              unshard)
from mmlspark_tpu_torch.quant.quantize import quantize_kv

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


def _cpu_mesh(data=1, seq=1, model=1):
    return make_mesh(MeshSpec(data=data, model=model, seq=seq),
                     [CPU] * (data * seq * model))


def _window(b=3, l=128, h=4, d=64, seed=0):
    """A decode read in the engine's layout; the last row is fully
    masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, l, h, d)).astype(np.float32)
            for _ in range(2))
    true_len = rng.integers(1, l // 2, size=b)
    slots = np.arange(l)[None, :]
    visible = (slots < true_len[:, None]) | (
        (slots >= l // 2) & (slots <= l // 2 + 5))
    visible[-1] = False
    return q, k, v, visible


# ------------------------------------------------------- K4[stats] ---

@pytest.mark.parametrize("q_dtype,cache,d", [
    ("float32", "float32", 64), ("float32", "float32", 128),
    ("bfloat16", "bfloat16", 64), ("bfloat16", "bfloat16", 128),
    ("float32", "int8", 64), ("bfloat16", "int8", 128)])
def test_stats_plain_matches_jax_kernel(q_dtype, cache, d):
    q, k, v, visible = _window(d=d, seed=d + len(cache))
    jq_dt, tq_dt = getattr(jnp, q_dtype), getattr(torch, q_dtype)
    jvis, tvis = jnp.asarray(visible), torch.from_numpy(visible)
    jq, tq = jnp.asarray(q, jq_dt), torch.from_numpy(q).to(tq_dt)
    if cache == "int8":
        (jk, jks), (jv, jvs) = (jax_quantize_kv(jnp.asarray(x))
                                for x in (k, v))
        (tk, tks), (tv, tvs) = (quantize_kv(torch.from_numpy(x))
                                for x in (k, v))
        jkw, tkw = dict(k_scale=jks, v_scale=jvs), dict(k_scale=tks,
                                                        v_scale=tvs)
    else:
        jk, jv = (jnp.asarray(x, getattr(jnp, cache)) for x in (k, v))
        tk, tv = (torch.from_numpy(x).to(getattr(torch, cache))
                  for x in (k, v))
        jkw = tkw = {}
    ref = jax_stats(jq, jk, jv, jvis, block_k=64, interpret=True, **jkw)
    before = fused_single_query_attention_stats.launches
    got = fused_single_query_attention_stats(tq, tk, tv, tvis, **tkw)
    assert fused_single_query_attention_stats.launches == before
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    acc, m, l = got
    assert (m[-1] == NEG_INF).all() and (np.asarray(ref[1])[-1]
                                         == NEG_INF).all()
    assert (l[-1] == 0).all() and torch.count_nonzero(acc[-1]) == 0


# ----------------------------------------------------------- merge ---

@pytest.mark.parametrize("n", [2, 4])
def test_merge_matches_jax_whole_window_read(n):
    """The window cut into n slabs, one of them fully masked: per-slab
    stats merged across the slabs equal the JAX whole-window read."""
    q, k, v, visible = _window(b=3, l=128, d=64, seed=n)
    visible[-1] = True                      # every row sees some slot
    width = 128 // n
    visible[:, width:2 * width] = False     # shard 1 sees nothing
    ref = jax_single_query_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                     jnp.asarray(visible))
    tq, tk, tv, tvis = (torch.from_numpy(x) for x in (q, k, v, visible))
    stats = [fused_single_query_attention_stats_plain(
        tq, tk[:, j * width:(j + 1) * width],
        tv[:, j * width:(j + 1) * width],
        tvis[:, j * width:(j + 1) * width]) for j in range(n)]
    assert (stats[1][1] == NEG_INF).all() and (stats[1][2] == 0).all()
    got = merge_attention_stats(*zip(*stats))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # one shard: the no-axis form, acc / l
    whole = fused_single_query_attention_stats_plain(tq, tk, tv, tvis)
    np.testing.assert_allclose(merge_attention_stats(*whole).numpy(),
                               np.asarray(ref), **TOL)


# ------------------------------------------------- ring attention ---

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("data,seq", [(1, 4), (2, 2)])
def test_seq_parallel_attention_matches_jax_ring(causal, data, seq):
    rng = np.random.default_rng(7 + data)
    q, k, v = (rng.standard_normal((2, 64, 4, 32)).astype(np.float32)
               for _ in range(3))
    mesh = jax_make_mesh(JaxMeshSpec(data=data, model=1, seq=seq),
                         jax.devices()[:data * seq])
    # jitted: one compile of the shard_mapped ring instead of eager steps
    ref = jax.jit(functools.partial(jax_seq_parallel_attention, mesh,
                                    causal=causal, impl="ring"))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    port_mesh = _cpu_mesh(data=data, seq=seq)
    got = seq_parallel_attention(port_mesh, tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    dense = seq_parallel_attention(port_mesh, tq, tk, tv, causal=causal,
                                   impl="dense")
    np.testing.assert_allclose(dense.numpy(), np.asarray(ref), **TOL)


def test_ring_attention_refusals():
    """Ulysses refuses heads that do not divide the seq axis (the JAX
    ValueError); an unknown impl raises; every seq-parallel impl takes
    gradients now (ring_flash and Ulysses since seq-parallel training,
    the ring through its dense fold: tests/test_torch_seq_train.py holds
    their values)."""
    mesh = _cpu_mesh(seq=2)
    q = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="divisible"):
        seq_parallel_attention(mesh, q, q, q, impl="ulysses")
    with pytest.raises(ValueError, match="unknown"):
        seq_parallel_attention(mesh, q, q, q, impl="nope")
    leaf = torch.randn((1, 8, 2, 16), requires_grad=True)
    slabs = shard(leaf, [CPU, CPU], 1)
    torch.stack(ring_attention(slabs, slabs, slabs,
                               causal=True)).sum().backward()
    assert torch.isfinite(leaf.grad).all()
    for impl in ("ring", "ring_flash"):
        leaf = torch.randn((1, 8, 2, 16), requires_grad=True)
        seq_parallel_attention(mesh, leaf, leaf, leaf, causal=True,
                               impl=impl).sum().backward()
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()


# --------------------------------------------- collectives, meshes ---

def test_reshard_moves_slab_boundaries():
    """A 12-slot prompt cut over 2 shards re-split as a 16-slot window over
    the same shards (the prefill re-layout), then grown to 24 (a window
    growth): each slot keeps its value, new slots are zero."""
    x = torch.arange(2 * 12 * 3, dtype=torch.float32).reshape(2, 12, 3)
    parts = shard(x, [CPU, CPU], 1)
    assert [p.shape[1] for p in parts] == [6, 6]
    window = reshard(parts, 16, [CPU, CPU], 1)
    assert [p.shape[1] for p in window] == [8, 8]
    full = unshard(window, 1, CPU)
    torch.testing.assert_close(full[:, :12], x)
    assert (full[:, 12:] == 0).all()
    grown = unshard(reshard(window, 24, [CPU, CPU], 1), 1, CPU)
    torch.testing.assert_close(grown[:, :16], full)
    assert (grown[:, 16:] == 0).all()
    with pytest.raises(ValueError, match="split"):
        reshard(parts, 15, [CPU, CPU], 1)


def test_collectives_over_shards():
    parts = [torch.tensor([1.0, 5.0]), torch.tensor([4.0, 2.0]),
             torch.tensor([0.0, 3.0])]
    assert all(torch.equal(t, torch.tensor([4.0, 5.0])) for t in pmax(parts))
    assert all(torch.equal(t, torch.tensor([5.0, 10.0])) for t in psum(parts))
    rotated = ppermute(parts)                  # shard i + 1 gets shard i's
    assert [t.tolist() for t in rotated] == [[0.0, 3.0], [1.0, 5.0],
                                             [4.0, 2.0]]


def test_mesh_layout_and_devices():
    mesh = _cpu_mesh(data=2, seq=2)
    assert mesh.shape == {"data": 2, "model": 1, "seq": 2}
    assert mesh.devices.shape == (2, 1, 2)
    assert mesh.seq_rings() == [[CPU, CPU], [CPU, CPU]]
    with pytest.raises(ValueError, match="one type"):
        Mesh(np.array([CPU, torch.device("meta")],
                      dtype=object).reshape(1, 1, 2))
    with pytest.raises(ValueError, match="wants"):
        make_mesh(MeshSpec(data=1, seq=2), [CPU])
