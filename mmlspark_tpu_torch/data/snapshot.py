"""Mid-epoch snapshot offsets (the port of `mmlspark_tpu/data/snapshot.py`).

A `snapshot(tag)` op counts the elements it has delivered this iteration
into a process-wide registry.  `snapshot_offsets()` is what a checkpoint's
`.meta.json` sidecar records ("7 chunks of epoch 3 were consumed"); on
resume the saved offsets come back through `set_restore_offsets`, and the
next `iterator()` build of each tagged dataset drops the first `offset`
elements of the seeded local stream.

Offsets are plain advisory ints: a missing or stale tag degrades to a
fresh epoch, never a crash.
"""

from __future__ import annotations

from typing import Optional


class SnapshotHandle:
    """Live consumed-element counter for one tagged snapshot op."""

    __slots__ = ("tag", "consumed")

    def __init__(self, tag: str):
        self.tag = tag
        self.consumed = 0


_handles: dict[str, SnapshotHandle] = {}
_restore: dict[str, int] = {}


def register(tag: str) -> SnapshotHandle:
    """Called by `Dataset.snapshot` at iterator build: a fresh handle
    (consumed=0) replaces any previous iteration's counter."""
    h = SnapshotHandle(tag)
    _handles[tag] = h
    return h


def snapshot_offsets() -> dict[str, int]:
    """Current consumed-offset per live tag — checkpoint-meta payload."""
    return {t: h.consumed for t, h in _handles.items()}


def set_restore_offsets(offsets: Optional[dict]) -> None:
    """Stage saved offsets (from a checkpoint's meta sidecar) to be
    applied by the NEXT iterator build of each tagged dataset."""
    if not offsets:
        return
    for tag, off in offsets.items():
        try:
            n = int(off)
        except (TypeError, ValueError):
            continue
        if n > 0:
            _restore[str(tag)] = n


def take_restore(tag: str) -> int:
    """Consume (one-shot) the pending restore offset for `tag`, 0 if
    none — each staged offset fast-forwards exactly one build."""
    return _restore.pop(tag, 0)


def clear() -> None:
    """Drop all handles and pending restores (test isolation)."""
    _handles.clear()
    _restore.clear()
