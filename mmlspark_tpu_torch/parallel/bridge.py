"""Host table <-> device tensor bridge (the port of
`mmlspark_tpu/parallel/bridge.py`'s one-device half).

`pad_to_multiple` zero-pads a host batch to a fixed row count, so every
batch of a scoring pass has one shape.  `DeviceFeed` stages fixed-shape
batches onto one device and fetches results back:

  * **to the card**: the host rows are written (stacked and zero-padded)
    into a pinned host buffer, then copied with `non_blocking=True` on a
    side stream; an event marks the copy.  The consumer's stream waits on
    that event before it reads the batch (`ready`), and the batch tensor,
    allocated on the side stream, is `record_stream`-ed onto the consumer's
    stream, so the allocator does not hand its memory back to the side
    stream before the consumer has used it.
  * **back to the host**: `fetch` copies an output into a pinned buffer
    with `non_blocking=True` on the current stream and records an event;
    `take` waits for that event and copies the rows out.
  * **pinned buffers** come from a pool keyed by (shape, dtype).  A buffer
    goes back to the pool with the event of the copy that reads or writes
    it, and is reused only after that event has completed.

On a CPU device there are no streams or pinned buffers: batches are host
tensors and `take` reads the output directly.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch


def pad_to_multiple(arr: np.ndarray, multiple: int,
                    axis: int = 0) -> tuple[np.ndarray, int]:
    """Zero-pad `arr` along `axis` to a multiple; returns (padded,
    valid_count)."""
    n = arr.shape[axis]
    rem = n % multiple
    if rem == 0:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, multiple - rem)
    return np.pad(arr, widths), n


class DeviceFeed:
    """Pinned, stream-ordered staging of fixed-shape batches onto one
    device (module docstring).  `stage` and `put` may run on any thread;
    `ready`, `fetch` and `take` run on the consumer's thread."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.copy_stream = (torch.cuda.Stream(device) if self.cuda
                            else None)
        self._free: dict[tuple, list] = {}
        self._lock = threading.Lock()
        # bytes `put` has sent to the device (copied on a card)
        self.put_bytes = 0

    # -- the pinned pool -------------------------------------------------
    def _acquire(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        with self._lock:
            free = self._free.get((shape, dtype))
            buf, event = free.pop() if free else (None, None)
        if buf is None:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        if event is not None:
            event.synchronize()  # its last copy has finished with it
        return buf

    def _release(self, buf: torch.Tensor,
                 event: Optional[torch.cuda.Event]) -> None:
        with self._lock:
            self._free.setdefault((tuple(buf.shape), buf.dtype),
                                  []).append((buf, event))

    # -- host -> device --------------------------------------------------
    def stage(self, rows: np.ndarray, batch: int) -> torch.Tensor:
        """`rows` zero-padded to `batch` rows in a host buffer (pinned,
        from the pool, on a card)."""
        rows = np.ascontiguousarray(rows)
        shape = (batch,) + rows.shape[1:]
        dtype = torch.from_numpy(rows[:0]).dtype
        host = (self._acquire(shape, dtype) if self.cuda
                else torch.empty(shape, dtype=dtype))
        view = host.numpy()
        view[:len(rows)] = rows
        view[len(rows):] = 0
        return host

    def put(self, host: torch.Tensor) -> tuple:
        """A staged host buffer on the device: returns (tensor, event),
        the event None on the CPU.  The buffer goes back to the pool with
        the copy's event."""
        with self._lock:
            self.put_bytes += host.numel() * host.element_size()
        if not self.cuda:
            return host, None
        with torch.cuda.stream(self.copy_stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        self._release(host, event)
        return dev, event

    def ready(self, dev: torch.Tensor,
              event: Optional[torch.cuda.Event]) -> torch.Tensor:
        """Order the current stream after `dev`'s copy and keep its memory
        from the side stream's reuse until the current stream is done."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            dev.record_stream(stream)
        return dev

    # -- device -> host --------------------------------------------------
    def fetch(self, out: torch.Tensor) -> tuple:
        """Start the copy of `out` to the host: returns a handle for
        `take`."""
        if not self.cuda:
            return out, None
        host = self._acquire(tuple(out.shape), out.dtype)
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def take(self, handle: tuple, valid: int) -> np.ndarray:
        """The first `valid` rows of a fetched output, as a numpy array
        of its own."""
        host, event = handle
        if event is None:
            return host[:valid].numpy().copy()
        event.synchronize()
        rows = host[:valid].numpy().copy()
        self._release(host, None)
        return rows
