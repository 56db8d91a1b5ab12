"""The port's configuration tier: one registry for every MMLSPARK_TPU_* knob
it reads (the port of `mmlspark_tpu/config.py`).

The variable names are the JAX package's own, so a deployment's settings
carry over to the port unchanged.  A variable is declared exactly once with
its name, type, default, and doc; reads go through `get()` with precedence

    programmatic override (`set()`)  >  process environment  >  default

and `describe()` lists the whole surface.  Modules never call os.environ
for MMLSPARK_TPU_* values directly — they import this registry.  The
registry is the port's own: a knob `set()` here does not reach the JAX
package's registry, nor the other way round.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

_PREFIX = "MMLSPARK_TPU_"


@dataclasses.dataclass(frozen=True)
class ConfigVar:
    name: str              # full env name, MMLSPARK_TPU_*
    default: Any
    doc: str
    ptype: Callable = str  # parser applied to env-var strings

    def current(self) -> Any:
        if self.name in _overrides:
            return _overrides[self.name]
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        return self.ptype(raw)


_registry: dict[str, ConfigVar] = {}
_overrides: dict[str, Any] = {}
_declared_by: dict[str, str] = {}  # var name -> declaring module


def register(name: str, default: Any = None, doc: str = "",
             ptype: Callable = str) -> ConfigVar:
    """Declare a config variable (idempotent for identical declarations)."""
    if not name.startswith(_PREFIX):
        raise ValueError(f"config vars are namespaced {_PREFIX}*; got {name!r}")
    existing = _registry.get(name)
    if existing is not None:
        if (existing.default, existing.doc, existing.ptype) != \
                (default, doc, ptype):
            raise ValueError(f"{name} already registered with different "
                             f"default/doc/ptype; one declaration per "
                             f"variable")
        return existing  # identical re-declaration: keep the one instance
    var = ConfigVar(name, default, doc, ptype)
    _registry[name] = var
    # provenance, so generated docs can list the FRAMEWORK's variables
    # without picking up test/application declarations made in-process
    import sys
    _declared_by[name] = sys._getframe(1).f_globals.get("__name__", "")
    return var


def get(name: str) -> Any:
    """Typed current value: override > environment > default."""
    if name not in _registry:
        raise KeyError(f"unregistered config var {name!r}; known: "
                       f"{sorted(_registry)}")
    return _registry[name].current()


def set(name: str, value: Any) -> None:  # noqa: A001 - mirrors Configuration.set
    """Programmatic override (highest precedence); None removes it."""
    if name not in _registry:
        raise KeyError(f"unregistered config var {name!r}")
    if value is None:
        _overrides.pop(name, None)
    else:
        _overrides[name] = value


def describe() -> list[dict]:
    """Every registered variable with default, doc, current value, and the
    module that declared it (so generated docs can keep test/application
    declarations made in-process out of the framework's reference table)."""
    return [{"name": v.name, "default": v.default, "doc": v.doc,
             "current": v.current(),
             "declared_by": _declared_by.get(v.name, "")} for v in
            sorted(_registry.values(), key=lambda v: v.name)]


# --------------------------------------------------------------------------
# the framework's variables (one declaration each; consumers import these)
# --------------------------------------------------------------------------

LOG_LEVEL = register(
    "MMLSPARK_TPU_LOG_LEVEL", default=None,
    doc="When set (DEBUG/INFO/...), the framework manages its own log "
        "output: root logger level + stderr handler (observe/logging.py). "
        "Unset: standard library behavior, the application configures.")

TELEMETRY = register(
    "MMLSPARK_TPU_TELEMETRY", default=None,
    doc="Telemetry kill switch: '0'/'off'/'false' makes run_telemetry() "
        "blocks inert (no spans, no files, hot loops keep the zero-cost "
        "fast path); unset or anything else leaves them live "
        "(observe/telemetry.py).")

TELEMETRY_DIR = register(
    "MMLSPARK_TPU_TELEMETRY_DIR", default=None,
    doc="Default output directory for run_telemetry(): run.jsonl event "
        "stream + run_summary.json land here when the block passes no "
        "dir. Unset + no explicit dir: in-memory ring only, no files.")

COSTMODEL = register(
    "MMLSPARK_TPU_COSTMODEL", default=None,
    doc="Per-program cost counting kill switch: '0'/'off'/'false' skips "
        "the cost counter over each program's first execution while the "
        "rest of telemetry stays live (observe/costmodel.py).")

BENCH_HISTORY = register(
    "MMLSPARK_TPU_BENCH_HISTORY", default=None,
    doc="Default bench-history store path for "
        "`python -m mmlspark_tpu_torch.observe.history` (--store "
        "overrides); unset: .bench_history.jsonl in the working "
        "directory.")

CKPT_KEEP = register(
    "MMLSPARK_TPU_CKPT_KEEP", 3,
    "checkpoint rotation: how many validated checkpoints to keep",
    ptype=int)

# population training (train/sweep.py), under the JAX package's names
SWEEP_HALVING_RUNGS = register(
    "MMLSPARK_TPU_SWEEP_HALVING_RUNGS", 0, ptype=int,
    doc="population training: successive-halving rung count (0 = no "
        "culling; rungs split the step budget evenly, each culls the "
        "trailing members by recent loss — train/sweep.py)")

SWEEP_CULL_FRACTION = register(
    "MMLSPARK_TPU_SWEEP_CULL_FRACTION", 0.5, ptype=float,
    doc="population training: fraction of still-active members culled "
        "at each halving rung (mask-frozen, never re-stacked)")

SWEEP_MIN_ACTIVE = register(
    "MMLSPARK_TPU_SWEEP_MIN_ACTIVE", 1, ptype=int,
    doc="population training: floor of active members a halving rung "
        "may not cull below")

# several processes (parallel/distributed.py), under the JAX package's names
COORDINATOR = register(
    "MMLSPARK_TPU_COORDINATOR", default=None,
    doc="host:port of process 0, the torch.distributed rendezvous "
        "(init_method tcp://host:port) for multi-process runs (the "
        "reference's MPI hostfile analogue, parallel/distributed.py).")

NUM_PROCESSES = register(
    "MMLSPARK_TPU_NUM_PROCESSES", default=None, ptype=int,
    doc="Total process count of the multi-process run (torch.distributed "
        "world size).")

PROCESS_ID = register(
    "MMLSPARK_TPU_PROCESS_ID", default=None, ptype=int,
    doc="This process's index in the multi-process run (torch.distributed "
        "rank; 0 = coordinator).")

COLLECTIVE_TIMEOUT_S = register(
    "MMLSPARK_TPU_COLLECTIVE_TIMEOUT_S", default=600.0, ptype=float,
    doc="Bounded wait for named torch.distributed collectives (barriers, "
        "checkpoint broadcast/gather): on expiry a CollectiveTimeoutError "
        "names the operation instead of the job hanging forever "
        "(parallel/distributed.py).")

# the port's CPU test environment (utils/testenv.py)
TEST_PLATFORM = register(
    "MMLSPARK_TPU_TEST_PLATFORM", default="cpu",
    doc="Test harness: 'cpu' pins the port's CPU test environment (no "
        "CUDA device visible, float32 default dtype, tensors on the CPU; "
        "utils/testenv.py); 'cuda' leaves the card visible for the "
        "`cuda`-marked cases.")

TEST_BUDGET_S = register(
    "MMLSPARK_TPU_TEST_BUDGET_S", default=30.0, ptype=float,
    doc="Per-test duration alert budget in seconds (reference "
        "TestBase.scala:65 alerts at 3s).")
