"""Several processes over `torch.distributed`: the port of
`mmlspark_tpu/parallel/distributed.py` (`DistributedConfig` :24-45,
`initialize_distributed` :51-71, `CollectiveTimeoutError` :74-99,
`run_collective` :107-145, `barrier` :148-160, `health_check` :163-176,
`process_count` / `process_index` / `is_coordinator` :179-188).

Every process runs the same program; `initialize_distributed` joins them
into one process group from the knobs MMLSPARK_TPU_COORDINATOR
(host:port of process 0), _NUM_PROCESSES and _PROCESS_ID, with
`init_method="tcp://<coordinator>"`.  The backend is NCCL for a CUDA
device and gloo for the host.  `DistributedConfig.backend` may name gloo
for CUDA tensors (NCCL refuses two ranks on one card); a failed NCCL
init raises, and nothing falls back to gloo on its own.

The three collectives the JAX Trainer reaches through `multihost_utils`
live here too: `process_allgather` (a small array from every process),
`broadcast_one_to_all` (a tree from the coordinator) and
`all_reduce_sum` (a list of tensors summed over the processes, one
collective for each device and dtype).  Over gloo a CUDA tensor goes
through host memory and back; over NCCL it stays on the card (the
process's own; a tensor on another card moves to it and back).  With one
process (no group) each is the identity; at world size 1 it runs over
the one rank.

`run_collective` bounds a collective's wait: `fn` runs on a daemon
thread and the caller joins it for at most MMLSPARK_TPU_COLLECTIVE_TIMEOUT_S
seconds, then raises `CollectiveTimeoutError` naming the operation.  The
span `collective.<op>` wraps every call (with one process too), a
timeout adds to the counter `collective.timeouts` and raises the event
`collective.timeout`.
"""

from __future__ import annotations

import dataclasses
import datetime
import threading
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.core.device import resolve_device

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass
class DistributedConfig:
    """Rendezvous of a multi-process run; unset fields read the knobs.
    `backend` None picks NCCL for a CUDA device, gloo for the host."""

    coordinator_address: Optional[str] = None   # "host:port" of process 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    backend: Optional[str] = None

    @staticmethod
    def from_env() -> "DistributedConfig":
        return DistributedConfig(
            coordinator_address=config.COORDINATOR.current(),
            num_processes=config.NUM_PROCESSES.current(),
            process_id=config.PROCESS_ID.current(),
        )


# the backend and the device its collectives run on, once initialized
_group: dict = {}


def initialize_distributed(config_: Optional[DistributedConfig] = None,
                           device="cuda") -> bool:
    """Join the process group a multi-process config describes.

    Returns True when running several processes (or once initialized),
    False when no knob is set (the single-process case, where nothing is
    initialized).  Safe to call more than once.  `device` picks the
    backend when the config names none: NCCL for a CUDA device (which
    must exist), gloo for the CPU."""
    if dist.is_available() and dist.is_initialized():
        return True
    cfg = config_ or DistributedConfig.from_env()
    if cfg.coordinator_address is None and cfg.num_processes is None:
        return False
    missing = [name for name, value in (
        ("MMLSPARK_TPU_COORDINATOR", cfg.coordinator_address),
        ("MMLSPARK_TPU_NUM_PROCESSES", cfg.num_processes),
        ("MMLSPARK_TPU_PROCESS_ID", cfg.process_id)) if value is None]
    if missing:
        raise ValueError(f"a multi-process run needs {missing} as well")
    dev = resolve_device(device)
    backend = cfg.backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r} ({' | '.join(BACKENDS)})")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend runs on a CUDA device")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{cfg.coordinator_address}",
        world_size=int(cfg.num_processes), rank=int(cfg.process_id),
        timeout=datetime.timedelta(seconds=collective_timeout_s()))
    _group.update(backend=backend,
                  device=dev if backend == "nccl" else torch.device("cpu"))
    return True


def shutdown_distributed() -> None:
    """Leave the process group (after which `process_count()` is 1)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _group.clear()


def backend() -> Optional[str]:
    """The process group's backend, or None before one is initialized."""
    return _group.get("backend")


class CollectiveTimeoutError(RuntimeError):
    """A named collective did not complete within its deadline: some
    participant is dead or wedged.  Carries the operation, this
    process's id and the expected peer set."""

    def __init__(self, op: str, timeout_s: float, present: list[int]):
        everyone = list(range(process_count()))
        missing = sorted(set(everyone) - set(present)) if present else None
        detail = (f"; peers that reached the {op!r} rendezvous: {present}, "
                  f"MISSING: {missing}" if present else
                  f"; expected participants: {everyone}")
        super().__init__(
            f"collective {op!r} timed out after {timeout_s:.0f}s on "
            f"process {process_index()}{detail}. A participant host "
            "is likely dead or wedged — check its logs, then restart the "
            "job (training resumes from the newest checkpoint with "
            "resume=True).")
        self.op = op
        self.timeout_s = timeout_s
        self.present = present
        self.missing = missing


def collective_timeout_s() -> float:
    return float(config.COLLECTIVE_TIMEOUT_S.current())


def run_collective(op: str, fn: Callable[[], Any],
                   timeout_s: Optional[float] = None) -> Any:
    """Run a blocking collective with a bounded wait (module docstring).
    With one process `fn` runs on the caller's thread, still spanned."""
    from mmlspark_tpu_torch.observe.metrics import inc_counter
    from mmlspark_tpu_torch.observe.trace import trace_event, trace_span
    if process_count() == 1:
        with trace_span(f"collective.{op}", cat="collective", op=op):
            return fn()
    timeout = timeout_s if timeout_s is not None else collective_timeout_s()
    result: dict[str, Any] = {}
    error: list[BaseException] = []

    def run():
        try:
            result["value"] = fn()
        except BaseException as e:  # surfaced to the caller below
            error.append(e)

    worker = threading.Thread(target=run, daemon=True,
                              name=f"collective-{op}")
    worker.start()
    with trace_span(f"collective.{op}", cat="collective", op=op,
                    timeout_s=timeout):
        worker.join(timeout)
    if worker.is_alive():
        inc_counter("collective.timeouts")
        trace_event("collective.timeout", cat="resilience", op=op,
                    timeout_s=timeout)
        raise CollectiveTimeoutError(op, timeout, present=[])
    if error:
        raise error[0]
    return result["value"]


def _grouped() -> bool:
    """A process group is up (at world size 1 too: its collectives then
    run, over one rank)."""
    return dist.is_available() and dist.is_initialized()


def barrier(tag: str, timeout_s: Optional[float] = None) -> None:
    """A named, bounded-wait barrier over all processes: a dead peer
    becomes a CollectiveTimeoutError naming the rendezvous point."""
    if not _grouped():
        return
    run_collective(f"barrier:{tag}", dist.barrier, timeout_s)


def health_check(timeout_s: Optional[float] = None) -> list[int]:
    """Every process id, all-gathered with a bounded wait and sorted
    ([0] with one process)."""
    if process_count() == 1:
        return [0]
    return run_collective(
        "health_check",
        lambda: sorted(int(i) for i in
                       process_allgather(np.asarray(process_index()))),
        timeout_s)


def process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_coordinator() -> bool:
    return process_index() == 0


# --------------------------------------------------------------------------
# the collectives the Trainer and TPUModel use
# --------------------------------------------------------------------------

def _comm_device() -> torch.device:
    return _group.get("device", torch.device("cpu"))


def process_allgather(x) -> np.ndarray:
    """`x` (a small numpy array or scalar) from every process, stacked on
    a leading process axis in rank order (a scalar gives shape (n,))."""
    host = np.asarray(x)
    if not _grouped():
        return host[None]
    t = torch.from_numpy(np.array(host)).to(_comm_device())
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return np.stack([p.cpu().numpy() for p in parts])


def _map(fn: Callable, tree: Any) -> Any:
    """`fn` of every leaf, dict keys walked in sorted order (the same
    order on every process, whatever order each built its tree in)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def sync_all() -> None:
    """Wait for every process (unbounded: callers bound it with
    `run_collective`)."""
    if _grouped():
        dist.barrier()


def broadcast_one_to_all(tree: Any) -> Any:
    """The coordinator's `tree` (numpy arrays, scalars or tensors) on
    every process; the other processes pass a tree of the same structure,
    shapes and dtypes.  The leaves of one device and dtype travel as one
    buffer, as `all_reduce_sum`'s do: over NCCL a CUDA buffer stays on the
    card, over gloo it goes through host memory and back.  Tensors come
    back on their own device, numpy leaves as numpy."""
    if not _grouped():
        return tree
    leaves: list = []
    _map(leaves.append, tree)
    tensors = [leaf.detach() if isinstance(leaf, torch.Tensor)
               else torch.from_numpy(np.array(leaf)) for leaf in leaves]
    out: list = [None] * len(tensors)
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for (dev, _dtype), idx in groups.items():
        buf = torch.cat([tensors[i].reshape(-1) for i in idx]).to(
            _comm_device())
        dist.broadcast(buf, src=0)
        flat = buf.to(dev)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view(tensors[i].shape)
            at += n
    it = iter(range(len(leaves)))

    def back(leaf):
        value = out[next(it)]
        if isinstance(leaf, torch.Tensor):
            return value
        value = value.numpy()
        return value if isinstance(leaf, np.ndarray) else value[()]
    return _map(back, tree)


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> list:
    """Each tensor summed over the processes, in place (the list is
    returned).  The tensors of one device and dtype are flattened into
    one buffer and reduced with one collective; over gloo a CUDA buffer
    goes through host memory and back."""
    tensors = list(tensors)
    if not _grouped() or not tensors:
        return tensors
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    for (dev, _dtype), idx in groups.items():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        buf = flat.to(_comm_device())
        dist.all_reduce(buf)
        flat = buf.to(dev)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            with torch.no_grad():
                tensors[i].copy_(flat[at:at + n].view_as(tensors[i]))
            at += n
    return tensors
