"""The port's copy of the chaos injector (mmlspark_tpu_torch/resilience/
chaos.py) against the JAX package's: for one seed and one call order both
give the same fault pattern, scripted faults fire alike, the scenario
runner checks `expect` alike, and the MMLSPARK_TPU_CHAOS_* knobs are the
same names with the same defaults.
"""

import os

import pytest

from mmlspark_tpu import config as jax_config
from mmlspark_tpu.resilience import chaos as jax_chaos
from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.resilience import chaos


def _pattern(module, seed, n=64):
    """Which of `n` requests raise which injected fault, and which of a
    run of checkpoint writes the probabilistic tear hits."""
    inj = module.ChaosInjector(seed=seed, net_error_rate=0.3,
                               stall_rate=0.2, stall_s=0.0,
                               torn_ckpt_rate=0.0)
    out = []
    for i in range(n):
        try:
            inj.on_request(f"http://host/{i}")
            out.append("ok")
        except module.InjectedNetworkError:
            out.append("net")
        except module.InjectedStallError:
            out.append("stall")
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_same_seed_same_fault_pattern_as_jax(seed):
    got = _pattern(chaos, seed)
    assert got == _pattern(jax_chaos, seed)
    assert {"ok", "net", "stall"} <= set(got)


def test_torn_checkpoint_draws_match_jax(tmp_path):
    hits = {}
    for name, module in (("port", chaos), ("jax", jax_chaos)):
        inj = module.ChaosInjector(seed=5, torn_ckpt_rate=0.4,
                                   torn_ckpt_target="payload")
        row = []
        for i in range(24):
            path = tmp_path / f"{name}-{i}.ckpt"
            path.write_bytes(b"x" * 100)
            row.append(inj.maybe_tear_checkpoint(str(path)))
            if row[-1]:
                assert os.path.getsize(path) == 50
        hits[name] = row
    assert hits["port"] == hits["jax"] and any(hits["port"])


def _scripted(module):
    """Every scripted hook, called in one order: what fired, where."""
    F = module.Fault
    inj = module.ChaosInjector(seed=0, script=[
        F(kind="replica_crash", at_request=3, replica=1),
        F(kind="replica_flap", at_request=5, replica=0, seconds=2.0),
        F(kind="burst", at_request=2, size=4),
        F(kind="handoff_torn", at_request=2),
        F(kind="worker_crash", worker=1, at_elem=10),
        F(kind="nan", step=4)])
    fired = []
    for i in range(1, 8):
        fired += [("replica", i, f.kind, f.replica)
                  for f in inj.replica_faults_due(i)]
        fired += [("serve", i, f.kind, f.size)
                  for f in inj.serve_faults_due(i)]
        fired += [("handoff", i, f.kind) for f in inj.handoff_faults_due(i)]
        fired += [("data", i, f.kind) for f in inj.data_faults_due(1, i * 3)]
        fired += [("nan", i) for _ in [0] if inj.poison_nan(i)]
    return fired, inj.active


def test_scripted_faults_fire_alike():
    got = _scripted(chaos)
    assert got == _scripted(jax_chaos)
    assert ("replica", 3, "replica_crash", 1) in got[0]
    assert got[1]
    with pytest.raises(ValueError, match="fault kind"):
        chaos.Fault(kind="meteor")
    with pytest.raises(ValueError, match="tear target"):
        chaos.Fault(kind="tear", target="disk")


def test_run_scenario_checks_expect_alike():
    def run():
        inj = chaos.get_injector()
        return {"fired": len(inj.replica_faults_due(9)), "steps": 5,
                "outcome": "completed"}

    scenario = chaos.Scenario(
        "demo", faults=[chaos.Fault(kind="replica_crash", at_request=1)],
        expect={"fired": 1, "min_steps": 5, "max_steps": 4,
                "outcome": "completed"})
    before = chaos.get_injector()
    report = chaos.run_scenario(scenario, run)
    assert chaos.get_injector() is before      # the previous one restored
    assert report["name"] == "demo" and not report["passed"]
    assert {k: c["ok"] for k, c in report["checks"].items()} == {
        "fired": True, "min_steps": True, "max_steps": False,
        "outcome": True}
    chaos.reset_chaos()
    assert not chaos.get_injector().active


def test_chaos_knobs_are_the_jax_names_and_defaults():
    ours = {d["name"]: d["default"] for d in config.describe()
            if d["name"].startswith("MMLSPARK_TPU_CHAOS_")}
    ref = {d["name"]: d["default"] for d in jax_config.describe()
           if d["name"].startswith("MMLSPARK_TPU_CHAOS_")}
    assert ours == ref and len(ours) == 10
