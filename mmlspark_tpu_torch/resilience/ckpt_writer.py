"""Async checkpoint writer: the save cost moves off the training loop (the
port of `mmlspark_tpu/resilience/ckpt_writer.py`).

  * **step loop (caller)** — copies the state on the device (the
    Trainer's `state_tree(state, to="device")`, made on the compute
    stream before `submit` returns) and hands the copy to `submit()`.
    The copy is what makes the async write safe: the port's optimizer
    updates the f32 masters in place (`train/optim.py`), so the next
    step would otherwise overwrite what the writer has not read yet.
  * **writer thread** — waits for the copy's event, moves it to the
    host on a side stream (the compute stream runs on), serializes it in
    flax's msgpack state-dict format (`serialize_chunks`) and calls
    `checkpoints.write_checkpoint` (atomic tmp/rename + sidecar + LATEST
    + prune).

At most ONE write is in flight: a `submit()` racing a slow disk blocks
(backpressure: bounded memory, rotation order = submission order).
`drain()` is the shutdown/preemption barrier.  A writer-thread failure is
latched and re-raised as `CheckpointWriteError` from the next
`submit()`/`drain()`: async never silently drops a checkpoint.

`serialize_tree` writes the bytes flax's `serialization.to_bytes` writes
for the same tree of numpy arrays: dict keys in sorted order (the order a
JAX tree walk gives them), arrays as flax's ndarray extension (code 1),
numpy scalars as code 3 (`models/bundle.py` holds the codes).
`serialize_chunks` gives the same bytes as pieces, a large array's data
as a view, which the writer hashes and writes without joining them.
Leaves above 2**30 bytes, which flax would chunk, raise: no model of
this package has one.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.models.bundle import (_EXT_NDARRAY, _pack_ext,
                                              _unpack_ext)
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.trace import (active_tracer, trace_event,
                                              trace_span, tracing)
from mmlspark_tpu_torch.resilience.checkpoints import (checkpoint_name,
                                                       write_checkpoint)


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed (the original error chained as
    __cause__); raised from the submit/drain after the failure."""


# a leaf array of at least this many bytes is framed by hand: the
# msgpack headers written here, its buffer passed on as a view
_DIRECT_BYTES = 1 << 16


def serialize_chunks(host_tree: Any) -> list:
    """A tree of dicts and numpy arrays -> the rotation payload as a list
    of bytes-like pieces whose concatenation is `serialize_tree`'s bytes.
    Small leaves go through `msgpack.packb`; a large array's ext frame
    (ext 32 around the (shape, dtype name, bin 32) triple) is written
    here and its data passed as a view of the array, so the payload is
    never copied into one buffer (the writer hashes and writes the
    pieces)."""
    import msgpack
    packer = msgpack.Packer()
    out: list = []

    def emit(node):
        if isinstance(node, dict):
            out.append(packer.pack_map_header(len(node)))
            for key in sorted(node):
                out.append(packer.pack(key))
                emit(node[key])
            return
        if (isinstance(node, np.ndarray) and not node.dtype.hasobject
                and node.nbytes >= _DIRECT_BYTES):
            arr = np.ascontiguousarray(node)
            if arr.nbytes > 2 ** 30:
                raise ValueError(f"cannot serialize array leaf {arr.dtype} "
                                 f"{arr.shape}")
            head = (b"\x93" + msgpack.packb(list(arr.shape))
                    + msgpack.packb(arr.dtype.name)
                    + b"\xc6" + arr.nbytes.to_bytes(4, "big"))
            out.append(b"\xc9" + (len(head) + arr.nbytes).to_bytes(4, "big")
                       + bytes([_EXT_NDARRAY]) + head)
            out.append(memoryview(arr.reshape(-1)).cast("B"))
            return
        out.append(msgpack.packb(node, default=_pack_ext, strict_types=True))

    emit(host_tree)
    return out


def serialize_tree(host_tree: Any) -> bytes:
    """A tree of dicts and numpy arrays -> the rotation payload bytes."""
    return b"".join(serialize_chunks(host_tree))


def _check_like(template: Any, tree: Any, path: str) -> None:
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"checkpoint tree at {path or '/'} has keys "
                             f"{got}, the state wants {sorted(template)}")
        for key, sub in template.items():
            _check_like(sub, tree[key], f"{path}/{key}")
    elif np.shape(tree) != np.shape(template):
        raise ValueError(f"checkpoint leaf {path} has shape "
                         f"{np.shape(tree)}, the state wants "
                         f"{np.shape(template)}")


def read_checkpoint(template: Any, path: str) -> Any:
    """A rotation payload as its tree of numpy arrays, checked against
    `template` (a tree of the same keys and leaf shapes; None skips the
    check)."""
    import msgpack
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_unpack_ext, raw=False)
    if template is not None:
        _check_like(template, tree, "")
    return tree


def _cuda_device(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, dict):
        for v in tree.values():
            dev = _cuda_device(v)
            if dev is not None:
                return dev
        return None
    if isinstance(tree, torch.Tensor) and tree.is_cuda:
        return tree.device
    return None


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tree


class CheckpointWriter:
    """One background writer for one checkpoint directory.

    `submit(step, tree, meta)` hands a tree (device tensors or numpy
    leaves, already copied by the caller) to the writer thread; `drain()` blocks until every submitted write is
    durable; `close()` drains and stops the thread.  `sync=True` is the
    one-call synchronous form (emergency and final saves)."""

    def __init__(self, ckpt_dir: str, keep: Optional[int] = None,
                 name: str = "ckpt-writer"):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._name = name
        self._cond = threading.Condition()
        self._item: Optional[tuple] = None
        self._inflight = 0
        self._error: Optional[BaseException] = None
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- caller side -----------------------------------------------------
    def submit(self, step: int, tree: Any, meta: Optional[dict] = None,
               sync: bool = False) -> str:
        """Queue one write; blocks only while a previous write is in
        flight.  Returns the payload path the write lands at."""
        self._raise_pending()
        # the snapshot's completion on the compute stream: the writer's
        # side stream waits on it before copying to the host
        dev = _cuda_device(tree)
        event = None
        if dev is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        # the caller's tracer, captured here: the writer thread does not
        # inherit contextvars
        tracer = active_tracer()
        with self._cond:
            while self._item is not None and self._error is None:
                self._cond.wait()
            self._raise_pending_locked()
            self._item = (int(step), tree, meta, tracer, dev, event)
            self._inflight += 1
            self._ensure_thread()
            self._cond.notify_all()
        if sync:
            self.drain()
        return os.path.join(self.ckpt_dir, checkpoint_name(int(step)))

    def drain(self) -> None:
        """Block until every submitted write is on disk; surfaces a
        latched writer failure."""
        with self._cond:
            while self._inflight > 0 and self._error is None:
                self._cond.wait()
        self._raise_pending()

    def close(self, best_effort: bool = False) -> None:
        """Drain and stop the writer thread.  `best_effort=True` logs a
        latched failure instead of raising (the finally-block form)."""
        try:
            self.drain()
        except CheckpointWriteError as e:
            if not best_effort:
                raise
            get_logger("resilience").warning(
                "checkpoint writer for %s closed with a failed write: %s",
                self.ckpt_dir, e.__cause__)
        finally:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None

    # -- error surfacing -------------------------------------------------
    def _raise_pending(self) -> None:
        with self._cond:
            self._raise_pending_locked()

    def _raise_pending_locked(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointWriteError(
                f"background checkpoint write to {self.ckpt_dir} "
                f"failed") from err

    # -- writer thread ---------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"mmlspark-{self._name}")
            self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._item is None and not self._stop:
                    self._cond.wait()
                if self._item is None and self._stop:
                    return
                step, tree, meta, tracer, dev, event = self._item
            try:
                scope = tracing(tracer) if tracer is not None \
                    else contextlib.nullcontext()
                with scope, trace_span("checkpoint.async_write",
                                       cat="checkpoint", step=step):
                    if dev is not None:
                        side = torch.cuda.Stream(device=dev)
                        with torch.cuda.stream(side):
                            side.wait_event(event)
                            host = _to_host(tree)
                    else:
                        host = _to_host(tree)
                    del tree
                    write_checkpoint(self.ckpt_dir, step,
                                     serialize_chunks(host), keep=self.keep,
                                     meta=meta)
                inc_counter("checkpoint.async_writes")
            except BaseException as e:  # latched; surfaced at next submit
                with self._cond:
                    self._error = e
                inc_counter("checkpoint.async_write_failures")
                trace_event("checkpoint.async_write_failed",
                            cat="resilience", step=step, error=repr(e))
                get_logger("resilience").error(
                    "async checkpoint write (step %d, %s) failed: %s",
                    step, self.ckpt_dir, e)
            finally:
                with self._cond:
                    self._item = None
                    self._inflight -= 1
                    self._cond.notify_all()
