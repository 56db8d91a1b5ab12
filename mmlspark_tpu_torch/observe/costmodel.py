"""Per-program cost counting + roofline attribution (the port of
`mmlspark_tpu/observe/costmodel.py`).

The telemetry layer knows how long each program took; this module knows
how much work it did.  Joining the two yields, for every program a run
paid for:

  * **MFU** — achieved FLOP/s over the card's bf16 peak
    (`utils/perf.device_peak_flops`);
  * **HBM-bandwidth utilization** — achieved bytes/s over the card's HBM
    peak (`utils/perf.device_peak_hbm_bw`);
  * a **roofline verdict** — the program's arithmetic intensity against
    the card's ridge point names its ceiling (compute vs bandwidth), and
    its achieved fraction of that ceiling says whether the program ever
    gets near it: one far below BOTH ceilings is not the bottleneck — the
    host is (`host-bound`).

The JAX package reads a compiled program's XLA `cost_analysis()`.  An
eager PyTorch program has no compiled form, so its counterpart is the
**cost counter** (`CostCounter`): a `TorchDispatchMode` active for one
REAL execution of the program (the first of each new shape class; never
an extra execution — a train step updates its optimizer state in place
and a decode segment writes its caches).  It sums

  * FLOPs through `torch.utils.flop_counter`'s formula registry (mm,
    addmm, bmm, convolution, attention, ...), and
  * `bytes_accessed`: the tensor inputs of every non-view, non-allocating
    aten op read once plus its outputs written once — the eager analogue
    of what XLA's cost model sums per HLO op.

The hand-written kernels are opaque to the counter, as Pallas kernels are
to XLA.  Their wrappers report their own work where they count launches
(`kernel_work`): FLOPs of the products they compute and the bytes of
their own inputs and outputs, and the counter hides whatever runs inside
the wrapper (the plain version on the CPU) so nothing counts twice.  A
cost row carries `flops` and `bytes_accessed` with the kernels included,
and `kernel_flops` / `kernel_bytes` beside them: subtract them for the
JAX package's `xla_visible` view.

Over a mesh the counter sees every shard's ops, run one after another on
the calling thread.  With a model axis each shard's slice of a split
product counts its own share, so the shares of a column- or row-parallel
layer sum to the whole product and a replicated layer, run once on its
row's home, counts once: a train step's dense FLOPs equal the global
batch's `lm_train_flops(...)["xla_visible"]` at any (data, model)
(`tests/test_torch_tp_lm.py`).  The kernels report at their wrappers
with each shard's own H/mp heads.  The model-group collectives are
copies between devices and the row-parallel sums' adds: bytes, no FLOPs
(a copy between shards that share a device moves nothing and counts
nothing).

Each hot loop owns a `ProgramCosts`: it counts a new shape class's first
execution under an active run (that execution's seconds are not timed:
the dispatch mode slows it), times every later execution into
`RunTelemetry.add_program_time`, and replays its remembered rows into
every later `run_telemetry` block, so a warm model or engine still gets
roofline rows.  Any failure of the count is a logged no-op: the run
proceeds, the program simply has no cost row.

MMLSPARK_TPU_COSTMODEL=0 switches counting off without touching the rest
of telemetry (the mirror of the MMLSPARK_TPU_TELEMETRY kill switch).
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.observe.logging import get_logger

COSTMODEL = config.COSTMODEL

# below this fraction of the binding ceiling, the program is not what
# bounds the run — something outside it (the host pipeline) is
HOST_BOUND_FLOOR = 0.05

# the counters active on this thread (innermost last); a kernel wrapper
# reports to each of them.  The autograd engine runs a CUDA backward on
# its own thread, so the flash operator carries its forward's counters
# to its backward (`bound`).
_COUNTERS: contextvars.ContextVar[tuple] = \
    contextvars.ContextVar("mmlspark_tpu_cost_counters", default=())

# ops that allocate without reading or writing data
_ALLOCATIONS = frozenset(("empty", "empty_like", "empty_strided",
                          "new_empty", "new_empty_strided"))


def costmodel_enabled() -> bool:
    """False only when MMLSPARK_TPU_COSTMODEL is an explicit off value."""
    raw = COSTMODEL.current()
    return str(raw).strip().lower() not in ("0", "off", "false") \
        if raw is not None else True


def _self_reporting() -> frozenset:
    """Operators whose implementation is a kernel wrapper that reports
    its own work: counting their formula too would count it twice."""
    from mmlspark_tpu_torch.ops import flash_attention  # noqa: F401
    ops = torch.ops.mmlspark
    return frozenset((ops.flash_attention.default,
                      ops.flash_attention_lse.default,
                      ops.flash_attention_lse_backward.default))


def _tensor_bytes(tree, seen: set) -> int:
    total = 0
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor) and id(leaf) not in seen:
            seen.add(id(leaf))
            total += leaf.numel() * leaf.element_size()
    return total


class CostCounter(TorchDispatchMode):
    """FLOPs and bytes of the aten ops run while active, plus the work
    the kernel wrappers report (module docstring).  A failure to count
    never fails the op: it lands in `error` and the row is dropped."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self._skip = _self_reporting()
        self.flops = 0
        self.bytes_accessed = 0
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.kernel_launches: dict[str, int] = {}
        self.error: Optional[BaseException] = None
        self._hidden = 0
        self._token = None

    def __enter__(self):
        self._token = _COUNTERS.set(_COUNTERS.get() + (self,))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _COUNTERS.reset(self._token)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._hidden or func in self._skip:
            return func(*args, **kwargs)
        if func._overloadpacket not in self._registry:
            # a composite op (conv2d, linear, reshape under inference
            # mode) is counted through the ops it decomposes into
            TorchDispatchMode.__enter__(self)
            try:
                out = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self.error is None:
            try:
                self._count(func, args, kwargs, out)
            except Exception as exc:  # counting never fails the program
                self.error = exc
        return out

    def _count(self, func, args, kwargs, out) -> None:
        formula = self._registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if getattr(func, "is_view", False) or \
                func._overloadpacket.__name__ in _ALLOCATIONS:
            return
        seen: set = set()
        self.bytes_accessed += _tensor_bytes((args, kwargs), seen)
        self.bytes_accessed += _tensor_bytes(out, set())

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.kernel_flops += int(flops)
        self.kernel_bytes += int(nbytes)
        self.kernel_launches[name] = self.kernel_launches.get(name, 0) + 1

    def row(self) -> dict:
        """The cost row: totals with the kernels included, and the
        kernels' share beside them."""
        return {"flops": float(self.flops + self.kernel_flops),
                "bytes_accessed": float(self.bytes_accessed
                                        + self.kernel_bytes),
                "kernel_flops": float(self.kernel_flops),
                "kernel_bytes": float(self.kernel_bytes),
                "kernel_launches": dict(self.kernel_launches)}


class _KernelWork:
    """One kernel wrapper's call under active counters: its work is
    reported on entry and the counters see nothing of what runs inside."""

    def __init__(self, counters: tuple, name: str, flops: float,
                 nbytes: float):
        self.counters = counters
        for c in counters:
            c.add_kernel(name, flops, nbytes)

    def __enter__(self):
        for c in self.counters:
            c._hidden += 1

    def __exit__(self, *exc):
        for c in self.counters:
            c._hidden -= 1


_NULL = contextlib.nullcontext()


def kernel_work(name: str, cost: Callable[..., tuple], *args):
    """The context a kernel wrapper runs its kernel (or, on the CPU, its
    plain version) in: with a counter active, `cost(*args)` -> (flops,
    bytes) is reported once and the body is hidden from the counter;
    with none active, one check and a shared null context."""
    counters = _COUNTERS.get()
    if not counters:
        return _NULL
    return _KernelWork(counters, name, *cost(*args))


def active_counters() -> tuple:
    """The counters active on this thread (carried across threads with
    `bound`)."""
    return _COUNTERS.get()


@contextlib.contextmanager
def bound(counters: tuple):
    """Make `counters` the active ones for the block (a backward that the
    autograd engine runs on its own thread)."""
    token = _COUNTERS.set(counters)
    try:
        yield
    finally:
        _COUNTERS.reset(token)


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class ProgramCosts:
    """One hot loop's cost rows, keyed by its own shape-class key (module
    docstring).  `where` names the loop in the run's tables."""

    def __init__(self, where: str):
        self.where = where
        self.rows: dict[str, dict] = {}
        self._counted: set = set()

    def clear(self) -> None:
        self.rows.clear()
        self._counted.clear()

    def replay(self, run, program: str) -> None:
        if program in self.rows:
            run.record_program_cost(self.where, program, self.rows[program])

    @contextlib.contextmanager
    def execution(self, run, program, *, basis: str = "dispatch",
                  probe: Optional[Callable[[], object]] = None,
                  device=None, timer: Optional["DeviceTimes"] = None):
        """Wrap one real execution of `program`.  The first under an
        active run is counted (not timed); later ones add their seconds:
        the block's wall with `basis`, or, given a `timer`, its device
        time, which the caller adds with `timer.flush` once it has synced.
        `probe`, for a call without side effects, runs once more after
        the counted execution, synced on `device`, for a clean step
        time."""
        if run is None or not run.live:
            yield
            return
        program = str(program)
        if program in self._counted or not costmodel_enabled():
            self.replay(run, program)
            if timer is not None:
                with timer.span(program):
                    yield
                return
            t0 = time.perf_counter()
            yield
            run.add_program_time(self.where, program,
                                 time.perf_counter() - t0, basis=basis)
            return
        self._counted.add(program)
        counter = CostCounter()
        with counter:
            yield
        try:
            if counter.error is not None:
                raise counter.error
            rec = counter.row()
            if probe is not None:
                _sync(device)
                t0 = time.perf_counter()
                probe()
                _sync(device)
                rec["probe_step_s"] = round(time.perf_counter() - t0, 6)
        except Exception as exc:  # diagnostics must never crash the run
            get_logger("observe.costmodel").info(
                "cost count unavailable for %s program %s: %s",
                self.where, program, exc)
            run.tracer.event("program_cost_unavailable", cat="cost",
                             where=self.where, program=program,
                             error=str(exc))
            return
        self.rows[program] = rec
        run.record_program_cost(self.where, program, rec)
        run.tracer.event("program_cost", cat="cost", where=self.where,
                         program=program,
                         **{k: v for k, v in rec.items()
                            if k != "kernel_launches"})


class DeviceTimes:
    """Device seconds of program executions on `device`'s current stream:
    CUDA events around each on a card (read at `flush`, after the caller's
    own sync, so timing adds none), the wall of the synchronous execution
    on the host."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []

    @contextlib.contextmanager
    def span(self, program: str):
        if not self.cuda:
            t0 = time.perf_counter()
            yield
            self.marks.append((program, time.perf_counter() - t0))
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.marks.append((program, (start, end)))

    def flush(self, run, where: str) -> None:
        """Add every timed execution to `run` (basis "device")."""
        for program, mark in self.marks:
            if isinstance(mark, tuple):
                mark[1].synchronize()
                mark = mark[0].elapsed_time(mark[1]) / 1e3
            run.add_program_time(where, program, mark, basis="device")
        self.marks.clear()


def roofline(flops: Optional[float], bytes_accessed: Optional[float],
             step_s: Optional[float], peak_flops: Optional[float] = None,
             peak_bw: Optional[float] = None,
             host_floor: float = HOST_BOUND_FLOOR) -> dict:
    """One program's roofline placement.

    The ridge point (peak_flops / peak_bw, FLOP per byte) splits the
    roofline: a program whose arithmetic intensity sits above it has a
    compute ceiling, below it a bandwidth ceiling.  The achieved fraction
    of that ceiling (MFU or bw_util) is the verdict's second axis — a
    program under `host_floor` of its own ceiling is not what bounds the
    run, so the verdict is `host-bound` rather than naming a device
    ceiling it never approaches.  Unknown peaks (CPU, unlisted cards)
    yield None utilizations and no verdict — never fabricated numbers.
    """
    ai = (flops / bytes_accessed
          if flops and bytes_accessed else None)
    ridge = (peak_flops / peak_bw
             if peak_flops and peak_bw else None)
    mfu = (flops / step_s / peak_flops
           if flops and step_s and peak_flops else None)
    bw_util = (bytes_accessed / step_s / peak_bw
               if bytes_accessed and step_s and peak_bw else None)
    bound = None
    if ai is not None and ridge is not None:
        bound = "compute" if ai >= ridge else "bandwidth"
    util = {"compute": mfu, "bandwidth": bw_util, None: None}[bound]
    verdict = None
    if util is not None:
        verdict = "host-bound" if util < host_floor else f"{bound}-bound"
    return {
        "arithmetic_intensity": round(ai, 3) if ai is not None else None,
        "ridge": round(ridge, 3) if ridge is not None else None,
        "mfu": round(mfu, 5) if mfu is not None else None,
        "hbm_bw_util": round(bw_util, 5) if bw_util is not None else None,
        "bound": bound,
        "verdict": verdict,
    }


def program_summary(costs: dict, times: dict,
                    peak_flops: Optional[float] = None,
                    peak_bw: Optional[float] = None) -> dict:
    """Join cost rows with execution times into the per-program roofline
    table (run_summary's `programs` section and the report's roofline
    view).

    `costs` and `times` are keyed `(where, program)` — costs from the
    hot loops' counted executions, times accumulated by the hot loops
    (`RunTelemetry.add_program_time`).  The per-step time each roofline
    uses is the most honest one available: accumulated span walls when
    the live span brackets a synced execution (`basis='step_wall'`, the
    trainer's step spans), else the count-time probe, else the recorded
    seconds under their own basis.
    """
    out: dict[str, dict] = {}
    for key in sorted(set(costs) | set(times), key=str):
        where, program = key
        cost = costs.get(key, {})
        t = times.get(key, {})
        count = t.get("count", 0)
        basis = t.get("basis")
        span_step_s = (t["seconds"] / count) if count else None
        probe_s = cost.get("probe_step_s")
        if basis == "step_wall" and span_step_s:
            step_s, step_basis = span_step_s, "span_wall"
        elif probe_s:
            step_s, step_basis = probe_s, "probe"
        else:
            step_s, step_basis = span_step_s, basis
        row = {
            "where": where,
            "program": program,
            "flops": cost.get("flops"),
            "bytes_accessed": cost.get("bytes_accessed"),
            "executions": count,
            "span_s": round(t.get("seconds", 0.0), 6),
            "step_s": round(step_s, 6) if step_s else None,
            "step_basis": step_basis,
            **roofline(cost.get("flops"), cost.get("bytes_accessed"),
                       step_s, peak_flops, peak_bw),
        }
        out[f"{where}:{program}"] = row
    return out


def program_rows(costs: dict, times: dict,
                 peak_flops: Optional[float] = None,
                 peak_bw: Optional[float] = None) -> dict:
    """`program_summary` with each row's kernel share beside it
    (`kernel_flops`, `kernel_bytes`, `kernel_launches`; None where the
    program has no cost row)."""
    out = program_summary(costs, times, peak_flops, peak_bw)
    for key, row in out.items():
        cost = costs.get((row["where"], row["program"]), {})
        for field in ("kernel_flops", "kernel_bytes", "kernel_launches"):
            row[field] = cost.get(field)
    return out


def device_peaks() -> tuple:
    """(peak_flops, peak_hbm_bw) of the default card, either None when
    unknown — one lazy import point for the summary/exposition callers."""
    try:
        from mmlspark_tpu_torch.utils.perf import (device_peak_flops,
                                                   device_peak_hbm_bw)
        return device_peak_flops(), device_peak_hbm_bw()
    except Exception:
        return None, None
