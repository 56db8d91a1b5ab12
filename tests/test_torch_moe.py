"""The port's mixture-of-experts op (`mmlspark_tpu_torch/ops/moe.py`)
against the JAX package's (`mmlspark_tpu/ops/moe.py`), on the CPU.

  * `topk_dispatch` at k = 1 and 2, with capacity drops and exact ties in
    the router logits: dispatch and the kept fraction equal, the combine
    gates and the aux and z losses within 2 f32 ulps of 1 (1e-6
    relative, 1e-7 absolute: the packages sum in other orders);
  * `_group_size` and the capacity for group sizes that do not divide
    the token count;
  * `MoEMLP`: the output (f32 within 1e-5 of max |y|, bf16 within one bf16
    ulp of the output scale), the sown values, and the gradients of an
    objective that adds the sown aux and z losses, against `jax.grad`
    (within 1e-4 of each gradient's max |g|, f32);
  * the relu experts have no bias and the router runs in f32 on a bf16
    model;
  * expert parallelism raises naming ROADMAP A10.

The JAX side of every case is jitted once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops import moe as J
from mmlspark_tpu_torch.ops import moe as P

# (tokens, experts, capacity, k): drops at capacity 4-5, ample capacity
DISPATCH_CASES = [(32, 4, 5, 1), (12, 4, 4, 1), (24, 4, 48, 1),
                  (32, 4, 5, 2), (12, 4, 4, 2), (24, 4, 48, 2)]
# (batch, seq, d_model, experts, group_size, k, capacity_factor, dtype)
MODULE_CASES = {
    "k1_groups_divide": (2, 16, 8, 4, 8, 1, 1.0, "float32"),
    "k2_drops": (2, 16, 8, 4, 8, 2, 1.0, "float32"),
    "k2_ragged_groups": (3, 10, 8, 4, 8, 2, 1.25, "float32"),
    "k1_one_group": (1, 12, 8, 2, 512, 1, 1.25, "float32"),
    "k2_bf16": (2, 16, 8, 4, 8, 2, 1.25, "bfloat16"),
}


def _logits(t, e, seed):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((t, e)).astype(np.float32)
    lg[3] = lg[2]                # two tokens with equal logits
    lg[5, 1] = lg[5, 0]          # a tie between two experts of one token
    lg[7] = 0.0                  # every expert tied
    return lg


@pytest.fixture(scope="module")
def jax_dispatch():
    out = {}
    for case in DISPATCH_CASES:
        t, e, c, k = case
        fn = jax.jit(lambda lg, c=c, k=k: J.topk_dispatch(lg, c, k))
        out[case] = [np.asarray(a) for a in fn(jnp.asarray(
            _logits(t, e, t + k)))]
    return out


@pytest.mark.parametrize("case", DISPATCH_CASES, ids=str)
def test_topk_dispatch_matches_jax(case, jax_dispatch):
    t, e, c, k = case
    got = [a.numpy() for a in P.topk_dispatch(
        torch.from_numpy(_logits(t, e, t + k)), c, k)]
    want = jax_dispatch[case]
    dispatch, combine, aux, z, kept = got
    np.testing.assert_array_equal(dispatch, want[0])
    np.testing.assert_allclose(combine, want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(aux, want[2], rtol=1e-6)
    np.testing.assert_allclose(z, want[3], rtol=1e-6)
    assert float(kept) == float(want[4])
    # each slot holds at most one token: the gather form's premise
    assert dispatch.sum(0).max() <= 1.0


def test_top1_dispatch_and_ties_go_to_the_first_expert():
    lg = torch.zeros((6, 4))
    dispatch, combine, aux = P.top1_dispatch(lg, capacity=3)
    # every expert tied: all choose expert 0, the first 3 fit
    assert dispatch[:, 0].sum() == 3 and dispatch[:, 1:].sum() == 0
    np.testing.assert_array_equal(dispatch[:3, 0].numpy(), np.eye(3))
    np.testing.assert_allclose(combine.sum((1, 2))[:3].numpy(), 0.25)
    jd, jc, ja = J.top1_dispatch(jnp.zeros((6, 4)), 3)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    assert float(aux) == pytest.approx(float(ja), rel=1e-6)


@pytest.mark.parametrize("t,target", [(30, 8), (12, 512), (7, 3), (64, 16),
                                      (1, 512)])
def test_group_size_and_capacity(t, target):
    gs = P._group_size(t, target)
    assert gs == J._group_size(t, target)
    for e, cf, k in ((4, 1.25, 2), (8, 1.0, 1), (3, 1.25, 1)):
        want = max(1, int(np.ceil(gs / e * cf * k)))
        assert P.capacity_of(gs, e, cf, k) == want


def _module_inputs(case, seed=3):
    b, s, d, e, gs, k, cf, dt = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    h = 4 * d
    params = {"router": {"kernel": rng.standard_normal((d, e)).astype(
        np.float32), "bias": 0.1 * rng.standard_normal(e).astype(np.float32)},
        "w_in": (rng.standard_normal((e, d, h)) * d ** -0.5).astype(
            np.float32),
        "w_out": (rng.standard_normal((e, h, d)) * h ** -0.5).astype(
            np.float32)}
    r = rng.standard_normal((b, s, d)).astype(np.float32)
    return x, params, r


def _jax_module(case):
    b, s, d, e, gs, k, cf, dt = case
    return J.MoEMLP(d_model=d, n_experts=e, capacity_factor=cf,
                    dtype=jnp.dtype(dt), group_size=gs, router_k=k)


def _port_module(case, params):
    b, s, d, e, gs, k, cf, dt = case
    m = P.MoEMLP(d, e, capacity_factor=cf, dtype=getattr(torch, dt),
                 group_size=gs, router_k=k, device="cpu")
    with torch.no_grad():
        m.router.weight.copy_(torch.from_numpy(params["router"]["kernel"].T))
        m.router.bias.copy_(torch.from_numpy(params["router"]["bias"]))
        m.w_in.copy_(torch.from_numpy(params["w_in"]))
        m.w_out.copy_(torch.from_numpy(params["w_out"]))
    return m


@pytest.fixture(scope="module")
def jax_module_refs():
    """Per case: y, the sown values, and the gradients of
    sum(y * r) + aux + z over (params, x)."""
    out = {}
    for name, case in MODULE_CASES.items():
        x, params, r = _module_inputs(case)
        mod = _jax_module(case)
        dt = jnp.dtype(case[-1])

        def objective(p, xv):
            y, st = mod.apply({"params": p}, xv.astype(dt),
                              mutable=["losses", "metrics"])
            losses = jax.tree_util.tree_leaves(st["losses"])
            return (jnp.sum(y.astype(jnp.float32) * r) + sum(losses),
                    (y, st))

        (_, (y, st)), grads = jax.jit(jax.value_and_grad(
            objective, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
        out[name] = (np.asarray(y.astype(jnp.float32)),
                     {k: float(v[0]) for col in st.values()
                      for k, v in col.items()},
                     jax.tree_util.tree_map(np.asarray, grads))
    return out


@pytest.mark.parametrize("name", list(MODULE_CASES))
def test_moe_mlp_forward_and_sown_values(name, jax_module_refs):
    case = MODULE_CASES[name]
    x, params, _ = _module_inputs(case)
    y_ref, sown_ref, _ = jax_module_refs[name]
    m = _port_module(case, params)
    y, sown = m(torch.from_numpy(x).to(getattr(torch, case[-1])))
    assert y.dtype == getattr(torch, case[-1])
    scale = np.abs(y_ref).max()
    tol = 1e-5 if case[-1] == "float32" else 2 ** -7
    np.testing.assert_allclose(y.float().detach().numpy(), y_ref, rtol=0,
                               atol=tol * scale)
    flat = {**sown["losses"], **sown["metrics"]}
    assert set(flat) == set(sown_ref)
    for key, want in sown_ref.items():
        assert flat[key].item() == pytest.approx(want, rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("name", [n for n, c in MODULE_CASES.items()
                                  if c[-1] == "float32"])
def test_moe_mlp_gradients_of_the_aux_objective(name, jax_module_refs):
    case = MODULE_CASES[name]
    x, params, r = _module_inputs(case)
    _, _, (gp, gx) = jax_module_refs[name]
    m = _port_module(case, params)
    xt = torch.from_numpy(x).requires_grad_()
    y, sown = m(xt)
    obj = (y * torch.from_numpy(r)).sum() + sum(sown["losses"].values())
    obj.backward()
    got = {"router.kernel": m.router.weight.grad.numpy().T,
           "router.bias": m.router.bias.grad.numpy(),
           "w_in": m.w_in.grad.numpy(), "w_out": m.w_out.grad.numpy(),
           "x": xt.grad.numpy()}
    want = {"router.kernel": gp["router"]["kernel"],
            "router.bias": gp["router"]["bias"], "w_in": gp["w_in"],
            "w_out": gp["w_out"], "x": gx}
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-4 * np.abs(want[key]).max(),
                                   err_msg=key)


def test_experts_are_relu_without_bias_and_the_router_is_f32():
    """With every expert identical and no drops the output is gate x
    relu(x W_in) W_out (no bias, no gelu); on a bf16 model the router
    still sees the f32 input and f32 weights."""
    case = (2, 8, 8, 4, 512, 1, 8.0, "float32")
    x, params, _ = _module_inputs(case)
    params["w_in"][:] = params["w_in"][0]
    params["w_out"][:] = params["w_out"][0]
    m = _port_module(case, params)
    y, _ = m(torch.from_numpy(x))
    xf = x.reshape(-1, 8)
    logits = xf @ params["router"]["kernel"] + params["router"]["bias"]
    gate = np.exp(logits - logits.max(-1, keepdims=True))
    gate = (gate / gate.sum(-1, keepdims=True)).max(-1)
    ref = (np.maximum(xf @ params["w_in"][0], 0) @ params["w_out"][0]
           ) * gate[:, None]
    np.testing.assert_allclose(y.detach().numpy().reshape(-1, 8), ref,
                               rtol=1e-5, atol=1e-5)
    # a bf16 model routes on the f32 product of its bf16 input: the aux
    # loss is that of f32 logits, not of bf16 ones
    mb = _port_module(case[:-1] + ("bfloat16",), params)
    xb = torch.from_numpy(x).bfloat16()
    _, sown = mb(xb)
    w, b = mb.router.weight.detach(), mb.router.bias.detach()
    logits = torch.nn.functional.linear(xb.float().reshape(-1, 8), w, b)
    want = P.route(logits[None], capacity=P.capacity_of(16, 4, 8.0, 1))
    assert sown["losses"]["moe_aux_loss"].item() == want["aux"].item()
    bf16 = P.route(torch.nn.functional.linear(
        xb.reshape(-1, 8), w.bfloat16(), b.bfloat16())[None],
        capacity=P.capacity_of(16, 4, 8.0, 1))
    assert bf16["aux"].item() != want["aux"].item()


def test_expert_parallelism_raises_naming_a10():
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        P.MoEMLP(8, expert_axis="model", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        P.expert_parallel_rules({}, None)


@pytest.mark.parametrize("path,shape,axis,want", [
    (("block0_w", "moe", "w_in"), (8, 4, 16), 4, True),
    (("block0_w", "moe", "w_out"), (8, 16, 4), 8, True),
    (("block0_w", "moe", "w_in"), (6, 4, 16), 4, False),
    (("block0_w", "mlp", "w_in"), (8, 4, 16), 4, False),
    (("block0_w", "moe", "router", "kernel"), (4, 8), 1, False),
])
def test_is_expert_stack_matches_jax(path, shape, axis, want):
    keys = [jax.tree_util.DictKey(p) for p in path]
    assert P.is_expert_stack(keys, shape, axis) is want
    assert J.is_expert_stack(keys, shape, axis) is want


def test_two_routed_choices_backward_is_repeatable():
    """At k = 2 every token's gradient sums two slot contributions, which
    any scatter order adds to the same bits."""
    case = MODULE_CASES["k2_drops"]
    x, params, r = _module_inputs(case)
    grads = []
    for _ in range(2):
        m = _port_module(case, params)
        xt = torch.from_numpy(x).requires_grad_()
        y, sown = m(xt)
        ((y * torch.from_numpy(r)).sum()
         + sum(sown["losses"].values())).backward()
        grads.append([xt.grad, m.w_in.grad, m.router.weight.grad])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
