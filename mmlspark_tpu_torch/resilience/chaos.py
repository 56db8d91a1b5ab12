"""Deterministic fault injection: the test harness for the resilience layer
(the port of `mmlspark_tpu/resilience/chaos.py`: the same faults, the same
`MMLSPARK_TPU_CHAOS_*` names, and for one seed and one call order the same
fault pattern).

A resilience subsystem that is only ever exercised by real outages is
untested code.  `ChaosInjector` is a seeded, config-driven fault source
that the I/O and training layers consult at their hazard points:

  * `on_request(url)`   — before a network fetch: may raise a connection
    error or a (virtual-clock) stalled-read timeout;
  * `on_step(step)`     — per training step: may deliver one simulated
    SIGTERM preemption at a configured step;
  * `maybe_hang(step)`  — inside the (watchdog-bounded) step execution:
    may stall for CHAOS_HANG_S real seconds, the hung-device drill;
  * `tear_file(path)`   — truncates a file in place, simulating a torn
    checkpoint from a crash or partial upload;
  * `maybe_tear_checkpoint(path)` — probabilistic form of the same, hooked
    into checkpoint rotation (target payload, sha256 sidecar, or the
    LATEST pointer);
  * `after_checkpoint_write(path)` — scripted post-rotation tears that
    must survive prune (scenario runner).

Determinism: one `random.Random(seed)` drives every probabilistic
decision, so a given seed + call sequence produces the SAME fault
pattern on every run — chaos tests are exactly reproducible, never
flaky-by-design.  Everything is off (zero rates, no seed needed) unless
the MMLSPARK_TPU_CHAOS_* variables turn it on.

**Scenario DSL**: `Scenario(name, faults=[Fault(...)], expect={...})`
declares a multi-fault script (e.g. NaN at step 30 + SIGTERM at step 45
+ a torn checkpoint on the 2nd rotation) with expected-outcome
assertions; `run_scenario(scenario, run_fn)` installs the script, runs
the workload, and checks `expect` against the observation dict `run_fn`
returns (`min_`/`max_` prefixes give bounds, anything else is an exact
match).  The repo's drills (scripts/*_drill.py) run their scenario suites
through the JAX package's module; tests/test_torch_router.py runs the
router drill's four scenarios on the port through this one.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import time
from typing import Callable, Optional, Sequence

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.trace import trace_event
from mmlspark_tpu_torch.resilience.checkpoints import LATEST
from mmlspark_tpu_torch.resilience.clock import get_clock


CHAOS_SEED = config.register(
    "MMLSPARK_TPU_CHAOS_SEED", 0,
    "chaos injector: RNG seed (fault patterns are a pure function of "
    "seed + call order)", ptype=int)
CHAOS_NET_ERROR_RATE = config.register(
    "MMLSPARK_TPU_CHAOS_NET_ERROR_RATE", 0.0,
    "chaos injector: probability a network request raises a connection "
    "error (0 = off)", ptype=float)
CHAOS_STALL_RATE = config.register(
    "MMLSPARK_TPU_CHAOS_STALL_RATE", 0.0,
    "chaos injector: probability a network request stalls for "
    "CHAOS_STALL_S then times out (0 = off)", ptype=float)
CHAOS_STALL_S = config.register(
    "MMLSPARK_TPU_CHAOS_STALL_S", 30.0,
    "chaos injector: stalled-read duration (spent on the resilience "
    "clock, so virtual under tests)", ptype=float)
CHAOS_TORN_CKPT_RATE = config.register(
    "MMLSPARK_TPU_CHAOS_TORN_CKPT_RATE", 0.0,
    "chaos injector: probability a freshly written checkpoint is torn "
    "(truncated) after the fact (0 = off)", ptype=float)
CHAOS_PREEMPT_AT_STEP = config.register(
    "MMLSPARK_TPU_CHAOS_PREEMPT_AT_STEP", 0,
    "chaos injector: deliver one simulated SIGTERM when training reaches "
    "this global step (0 = off)", ptype=int)
CHAOS_NAN_AT_STEP = config.register(
    "MMLSPARK_TPU_CHAOS_NAN_AT_STEP", 0,
    "chaos injector: poison one training step's loss mask with NaN when "
    "training reaches this global step (0 = off) — the numerics-probe / "
    "halt_on_nonfinite drill (observe/numerics.py)", ptype=int)
CHAOS_HANG_AT_STEP = config.register(
    "MMLSPARK_TPU_CHAOS_HANG_AT_STEP", 0,
    "chaos injector: stall one training step for CHAOS_HANG_S real "
    "seconds when training reaches this global step (0 = off) — the "
    "hung-device drill the step watchdog exists for "
    "(TrainerConfig.step_timeout_s)", ptype=int)
CHAOS_HANG_S = config.register(
    "MMLSPARK_TPU_CHAOS_HANG_S", 30.0,
    "chaos injector: hung-step stall duration in REAL seconds (the "
    "watchdog races a wall-clock deadline, so this one hazard cannot "
    "ride the virtual clock)", ptype=float)
CHAOS_TORN_CKPT_TARGET = config.register(
    "MMLSPARK_TPU_CHAOS_TORN_CKPT_TARGET", "payload",
    "chaos injector: what the torn-checkpoint fault corrupts — "
    "'payload' (truncate the msgpack), 'sidecar' (truncate the sha256), "
    "or 'latest' (truncate the LATEST pointer); restore must skip to a "
    "valid checkpoint in every case", ptype=str)


class InjectedNetworkError(ConnectionError):
    """A chaos-injected connection failure (retryable by classification)."""


class InjectedStallError(TimeoutError):
    """A chaos-injected stalled read that hit its timeout."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted fault in a chaos scenario.

    Training faults: 'nan' | 'sigterm' | 'hang' (fire once when training
    reaches `step`) or 'tear' (corrupt `target` on the `at_write`-th
    rotation).

    Serving faults (interpreted by the serve drill's workload runner,
    scripts/serve_drill.py, against serve/engine.py): 'burst' (inject
    `size` extra back-to-back arrivals when the workload reaches request
    index `at_request`), 'slow_client' (the at_request-th HTTP client
    connects, sends a partial request, then stalls `seconds` — the engine
    must keep serving everyone else), 'poison' (the at_request-th request
    is malformed — out-of-vocabulary tokens / impossible budget — and
    must be rejected without corrupting any neighbor).  Mid-flight
    SIGTERM drills reuse kind 'sigterm': the runner feeds request indices
    to `on_step`, so `step` doubles as a request index there.

    Replica faults (interpreted by the router drill's workload runner,
    scripts/router_drill.py, against serve/router.py fleets): they fire
    at request index `at_request` and act on fleet replica number
    `replica` — 'replica_crash' (everything in flight on it fails over),
    'replica_hang' (busy but frozen until the router's hang detector
    ejects it; recovers after `seconds` on the virtual clock),
    'replica_flap' (crash now, recover after `seconds` — the half-open
    probe re-admission drill), 'replica_slow' (tick throttled by
    `factor` — stays routable until miss evidence ejects it).

    Data-service faults (interpreted by the service worker runners,
    data/service/dispatcher.py, during the data drill
    scripts/data_drill.py): they act on service worker number `worker`
    once that worker has produced `at_elem` elements —
    'worker_crash' (the worker dies with its split unacked; the
    dispatcher must re-dispatch it with no duplicated or dropped rows),
    'worker_slow' (the worker's production throttled by `factor` — the
    stall-evidence autoscaling drill).

    KV-handoff faults (interpreted by the handoff bus itself,
    serve/handoff.py, which reads them through `get_injector()`):
    they fire on the `at_request`-th KV transfer (1-based) —
    'handoff_torn' (one page frame is bit-flipped on the wire; the
    decode side must reject it on crc32 and the request re-prefills
    byte-exact), 'handoff_stall' (the sender withholds pages for
    `seconds` VIRTUAL seconds; the per-transfer deadline must fire and
    re-queue the request), 'prefill_crash_mid_transfer' (the prefill
    replica crashes after its first page is on the wire; the remaining
    pages never arrive and the request must re-prefill elsewhere).

    In the port the data service is not ported yet (ROADMAP A12): its
    fault kinds are kept so a script means the same in both packages,
    and nothing of the port consults them.
    """

    kind: str
    step: int = 0            # nan / sigterm / hang trigger step
    seconds: float = 0.5     # hang / slow-client stall duration (REAL s);
    #                          replica_hang/flap down-time (VIRTUAL s)
    at_write: int = 1        # tear: which checkpoint write (1-based)
    target: str = "payload"  # tear: payload | sidecar | latest
    at_request: int = 1      # serving faults: workload request index (1-based)
    size: int = 8            # burst: how many extra arrivals to inject
    replica: int = 0         # replica faults: fleet position (0-based)
    factor: float = 4.0      # replica_slow / worker_slow: throttle factor
    worker: int = 0          # data faults: service worker id (0-based)
    at_elem: int = 0         # data faults: fire once the worker has
    #                          produced this many elements

    _KINDS = ("nan", "sigterm", "hang", "tear",
              "burst", "slow_client", "poison",
              "replica_crash", "replica_hang", "replica_flap",
              "replica_slow",
              "worker_crash", "worker_slow",
              "handoff_torn", "handoff_stall", "prefill_crash_mid_transfer")
    _SERVE_KINDS = ("burst", "slow_client", "poison")
    _REPLICA_KINDS = ("replica_crash", "replica_hang", "replica_flap",
                      "replica_slow")
    _DATA_KINDS = ("worker_crash", "worker_slow")
    _HANDOFF_KINDS = ("handoff_torn", "handoff_stall",
                      "prefill_crash_mid_transfer")
    _TARGETS = ("payload", "sidecar", "latest")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"fault kind must be one of {self._KINDS}, "
                             f"got {self.kind!r}")
        if self.kind == "tear" and self.target not in self._TARGETS:
            raise ValueError(f"tear target must be one of {self._TARGETS}, "
                             f"got {self.target!r}")


class ChaosInjector:
    """One seeded fault source; `get_injector()` holds the process instance."""

    def __init__(self, seed: Optional[int] = None,
                 net_error_rate: Optional[float] = None,
                 stall_rate: Optional[float] = None,
                 stall_s: Optional[float] = None,
                 torn_ckpt_rate: Optional[float] = None,
                 preempt_at_step: Optional[int] = None,
                 nan_at_step: Optional[int] = None,
                 hang_at_step: Optional[int] = None,
                 hang_s: Optional[float] = None,
                 torn_ckpt_target: Optional[str] = None,
                 script: Optional[Sequence[Fault]] = None):
        read = lambda explicit, var, cast: cast(
            var.current() if explicit is None else explicit)
        self.net_error_rate = read(net_error_rate, CHAOS_NET_ERROR_RATE, float)
        self.stall_rate = read(stall_rate, CHAOS_STALL_RATE, float)
        self.stall_s = read(stall_s, CHAOS_STALL_S, float)
        self.torn_ckpt_rate = read(torn_ckpt_rate, CHAOS_TORN_CKPT_RATE, float)
        self.torn_ckpt_target = read(torn_ckpt_target,
                                     CHAOS_TORN_CKPT_TARGET, str)
        self.preempt_at_step = read(preempt_at_step, CHAOS_PREEMPT_AT_STEP,
                                    int)
        self.nan_at_step = read(nan_at_step, CHAOS_NAN_AT_STEP, int)
        self.hang_at_step = read(hang_at_step, CHAOS_HANG_AT_STEP, int)
        self.hang_s = read(hang_s, CHAOS_HANG_S, float)
        # the declarative multi-fault script (scenario runner): each entry
        # fires at most once, latched by its index
        self.script: list[Fault] = list(script or [])
        self._fired: set = set()
        self._write_count = 0
        self._rng = random.Random(read(seed, CHAOS_SEED, int))
        self._preempt_fired = False
        self._nan_fired = False
        self._hang_fired = False

    @property
    def active(self) -> bool:
        return bool(self.net_error_rate or self.stall_rate
                    or self.torn_ckpt_rate or self.preempt_at_step
                    or self.nan_at_step or self.hang_at_step or self.script)

    def _script_due(self, kind: str, step: int) -> Optional[Fault]:
        """The first unfired scripted fault of `kind` due at `step`."""
        for i, f in enumerate(self.script):
            if f.kind == kind and i not in self._fired and step >= f.step:
                self._fired.add(i)
                return f
        return None

    # -- network hazards -------------------------------------------------
    def on_request(self, url: str) -> None:
        """Called before a network fetch; may raise an injected fault."""
        if self.net_error_rate and self._rng.random() < self.net_error_rate:
            inc_counter("chaos.net_errors")
            trace_event("chaos.net_error", cat="resilience", url=url)
            raise InjectedNetworkError(
                f"chaos: injected connection error for {url}")
        if self.stall_rate and self._rng.random() < self.stall_rate:
            inc_counter("chaos.stalls")
            trace_event("chaos.stall", cat="resilience", url=url,
                        stall_s=self.stall_s)
            get_clock().sleep(self.stall_s)  # virtual under tests
            raise InjectedStallError(
                f"chaos: injected {self.stall_s:.0f}s stalled read for {url}")

    # -- checkpoint hazards ----------------------------------------------
    @staticmethod
    def tear_file(path: str, keep_fraction: float = 0.5) -> None:
        """Truncate `path` in place — a torn write/partial upload."""
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, int(size * keep_fraction)))
        inc_counter("chaos.torn_files")
        trace_event("chaos.torn_file", cat="resilience", path=path)
        get_logger("resilience").warning("chaos: tore file %s", path)

    @classmethod
    def tear_checkpoint(cls, path: str, target: str = "payload") -> None:
        """Tear one aspect of a written checkpoint: the msgpack payload,
        its sha256 sidecar, or the directory's LATEST pointer — the three
        distinct corruption states a crash/partial upload can leave.
        Restore must skip to a valid checkpoint under ALL of them."""
        if target == "sidecar":
            cls.tear_file(path + ".sha256")
        elif target == "latest":
            cls.tear_file(os.path.join(os.path.dirname(path), LATEST))
        else:
            cls.tear_file(path)

    def maybe_tear_checkpoint(self, path: str) -> bool:
        if self.torn_ckpt_rate and self._rng.random() < self.torn_ckpt_rate:
            self.tear_checkpoint(path, self.torn_ckpt_target)
            return True
        return False

    def after_checkpoint_write(self, path: str) -> bool:
        """Post-rotation hook (runs AFTER the LATEST move and prune):
        scripted scenario tears land here so the corrupt state survives
        on disk for the next restore to prove it skips it."""
        self._write_count += 1
        fault = None
        for i, f in enumerate(self.script):
            if f.kind == "tear" and i not in self._fired \
                    and self._write_count >= f.at_write:
                self._fired.add(i)
                fault = f
                break
        if fault is None:
            return False
        trace_event("chaos.torn_checkpoint", cat="resilience", path=path,
                    target=fault.target, write=self._write_count)
        self.tear_checkpoint(path, fault.target)
        return True

    # -- preemption -------------------------------------------------------
    def on_step(self, step: int) -> None:
        """Deliver the configured one-shot SIGTERM when `step` arrives.

        Uses a real signal (not a flag) so the SAME handler path that a
        cloud preemption notice exercises is the one under test.
        """
        due = self._script_due("sigterm", step) is not None
        if due or (self.preempt_at_step and not self._preempt_fired
                   and step >= self.preempt_at_step):
            if not due:
                self._preempt_fired = True
            inc_counter("chaos.preemptions")
            trace_event("chaos.preemption", cat="resilience", step=step)
            get_logger("resilience").warning(
                "chaos: raising simulated SIGTERM at step %d", step)
            signal.raise_signal(signal.SIGTERM)

    def maybe_hang(self, step: int) -> bool:
        """Stall the calling thread for `hang_s` REAL seconds, once, when
        `step` reaches the configured hang point — the hung-device drill.
        Called INSIDE the step execution the watchdog bounds
        (train/trainer.py), so the stall is observed exactly where a
        wedged collective or device would be."""
        fault = self._script_due("hang", step)
        hang_s = fault.seconds if fault is not None else self.hang_s
        due = fault is not None
        if not due and self.hang_at_step and not self._hang_fired \
                and step >= self.hang_at_step:
            self._hang_fired = True
            due = True
        if not due:
            return False
        inc_counter("chaos.hangs")
        trace_event("chaos.hang", cat="resilience", step=step,
                    hang_s=hang_s)
        get_logger("resilience").warning(
            "chaos: hanging step %d for %.2fs (real time)", step, hang_s)
        time.sleep(hang_s)  # REAL seconds: the watchdog deadline is wall
        return True

    # -- serving hazards ---------------------------------------------------
    def serve_faults_due(self, request_index: int) -> list:
        """The unfired scripted serving faults due at `request_index`
        (1-based workload position), each fired at most once.  The serve
        drill's workload runner consults this before issuing each request
        and acts the fault out — a burst enqueues `size` extra arrivals,
        a slow client stalls its connection, a poison request goes out
        malformed.  The engine under test never sees this hook; only the
        traffic it produces."""
        due = []
        for i, f in enumerate(self.script):
            if f.kind in Fault._SERVE_KINDS and i not in self._fired \
                    and request_index >= f.at_request:
                self._fired.add(i)
                inc_counter(f"chaos.serve_{f.kind}")
                trace_event(f"chaos.serve_{f.kind}", cat="resilience",
                            request_index=request_index)
                due.append(f)
        return due

    def replica_faults_due(self, request_index: int) -> list:
        """The unfired scripted REPLICA faults due at `request_index`
        (1-based workload position), each fired at most once.  The
        router drill's workload runner consults this before issuing each
        request and acts the fault out on the fleet's `Replica` handles
        (inject_crash / inject_hang / inject_slow / recover) — the
        router under test never sees this hook, only a fleet whose
        members actually fail."""
        due = []
        for i, f in enumerate(self.script):
            if f.kind in Fault._REPLICA_KINDS and i not in self._fired \
                    and request_index >= f.at_request:
                self._fired.add(i)
                inc_counter(f"chaos.{f.kind}")
                trace_event(f"chaos.{f.kind}", cat="resilience",
                            request_index=request_index, replica=f.replica)
                due.append(f)
        return due

    def handoff_faults_due(self, transfer_index: int) -> list:
        """The unfired scripted KV-HANDOFF faults due at `transfer_index`
        (1-based count of KV transfers begun), each fired at most once.
        The handoff bus (serve/handoff.py) consults this as it opens each
        transfer and acts the fault out on the wire (bit-flip a page /
        withhold pages / crash the sending replica) — the receiving side
        and the router only ever see the resulting damage."""
        due = []
        for i, f in enumerate(self.script):
            if f.kind in Fault._HANDOFF_KINDS and i not in self._fired \
                    and transfer_index >= f.at_request:
                self._fired.add(i)
                inc_counter(f"chaos.{f.kind}")
                trace_event(f"chaos.{f.kind}", cat="resilience",
                            transfer_index=transfer_index)
                due.append(f)
        return due

    # -- data-service hazards ----------------------------------------------
    def data_faults_due(self, worker: int, produced: int) -> list:
        """The unfired scripted data-service faults due for service
        `worker` once it has produced `produced` elements, each fired at
        most once.  The inproc worker runner consults this between
        elements and acts the fault out (die with the split unacked /
        throttle production); the dispatcher under test only sees the
        resulting failure."""
        due = []
        for i, f in enumerate(self.script):
            if f.kind in Fault._DATA_KINDS and i not in self._fired \
                    and f.worker == worker and produced >= f.at_elem:
                self._fired.add(i)
                inc_counter(f"chaos.{f.kind}")
                trace_event(f"chaos.{f.kind}", cat="resilience",
                            worker=worker, produced=produced)
                due.append(f)
        return due

    def data_faults_for(self, worker: int) -> list:
        """All unfired data-service faults targeting `worker`, marked
        fired — the process-mode path, where the dispatcher folds them
        into the spawned worker's environment and the fault plays out
        in that process."""
        due = []
        for i, f in enumerate(self.script):
            if f.kind in Fault._DATA_KINDS and i not in self._fired \
                    and f.worker == worker:
                self._fired.add(i)
                inc_counter(f"chaos.{f.kind}")
                trace_event(f"chaos.{f.kind}", cat="resilience",
                            worker=worker)
                due.append(f)
        return due

    # -- numerics hazards --------------------------------------------------
    def poison_nan(self, step: int) -> bool:
        """True exactly once (per configured injection), when `step`
        reaches a NaN injection point; the trainer then multiplies the
        step's loss mask by NaN (dtype-agnostic — poisons float and token
        models alike), so loss, gradients, and the updated params all go
        non-finite — the drill the numerics probe, halt_on_nonfinite, and
        the recovery supervisor exist for."""
        due = self._script_due("nan", step) is not None
        if not due and self.nan_at_step and not self._nan_fired \
                and step >= self.nan_at_step:
            self._nan_fired = True
            due = True
        if due:
            inc_counter("chaos.nan_injections")
            trace_event("chaos.nan_injection", cat="resilience", step=step)
            get_logger("resilience").warning(
                "chaos: poisoning step %d loss mask with NaN", step)
        return due


_injector: Optional[ChaosInjector] = None


def get_injector() -> ChaosInjector:
    """The process injector, built lazily from the CHAOS_* config."""
    global _injector
    if _injector is None:
        _injector = ChaosInjector()
    return _injector


def set_injector(injector: Optional[ChaosInjector]) -> Optional[ChaosInjector]:
    """Install a specific injector (the scenario runner's seam); returns
    the previous one so callers can restore it.  None = rebuild lazily
    from config on next use."""
    global _injector
    previous, _injector = _injector, injector
    return previous


def reset_chaos() -> None:
    """Rebuild the injector from current config on next use (tests call
    this after flipping CHAOS_* variables)."""
    global _injector
    _injector = None


# --------------------------------------------------------------------------
# Declarative chaos scenarios: multi-fault scripts + expected outcomes
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Scenario:
    """One declarative chaos drill: a fault script plus the outcome it
    must produce.

    `expect` keys check the observation dict the workload returns:
    `min_<k>`/`max_<k>` bound `obs[k]`; any other key is an exact match.
    Typical observation keys (see scripts/chaos_drill.py and
    tests/test_recovery.py): outcome ('completed' | 'gave_up' |
    'preempted'), steps, recoveries, finite (bool).
    """

    name: str
    faults: Sequence[Fault] = dataclasses.field(default_factory=list)
    expect: dict = dataclasses.field(default_factory=dict)


def run_scenario(scenario: Scenario, run_fn: Callable[[], dict]) -> dict:
    """Install the scenario's fault script, run the workload, check the
    expectations.

    `run_fn` owns the workload (typically a RecoverySupervisor fit) and
    returns an observation dict; this runner never raises on a failed
    expectation — it returns a machine-readable report
    `{name, passed, checks: {key: {want, got, ok}}, observed}` so a
    drill suite can run every scenario and fail at the end with the full
    picture.  The previous process injector is restored on exit.
    """
    previous = set_injector(ChaosInjector(script=list(scenario.faults)))
    trace_event("chaos.scenario_start", cat="resilience",
                scenario=scenario.name, faults=len(list(scenario.faults)))
    try:
        observed = run_fn()
    finally:
        set_injector(previous)
    checks: dict = {}
    for key, want in scenario.expect.items():
        if key.startswith("min_"):
            got = observed.get(key[4:])
            ok = got is not None and got >= want
        elif key.startswith("max_"):
            got = observed.get(key[4:])
            ok = got is not None and got <= want
        else:
            got = observed.get(key)
            ok = got == want
        checks[key] = {"want": want, "got": got, "ok": bool(ok)}
    passed = all(c["ok"] for c in checks.values())
    trace_event("chaos.scenario_end", cat="resilience",
                scenario=scenario.name, passed=passed)
    return {"name": scenario.name, "passed": passed, "checks": checks,
            "observed": observed}
