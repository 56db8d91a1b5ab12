"""Checkpoint rotation: keep-last-K, LATEST pointer, checksum validation
(the port of `mmlspark_tpu/resilience/checkpoints.py`; the directory
layout, names, sidecars and pointer are the JAX package's, so either
package restores what the other wrote).

    ckpt_dir/
      ckpt_0000000100.msgpack            payload (atomic tmp+rename)
      ckpt_0000000100.msgpack.sha256     sidecar checksum
      ckpt_0000000100.msgpack.meta.json  elastic-resume meta (advisory)
      LATEST                             name of the newest checkpoint

Restore walks candidates newest-first (the LATEST pointer is an
optimization, not trusted): a checkpoint only qualifies if its sidecar
checksum matches the payload bytes, so a torn or bit-rotted file is
SKIPPED with a warning and a counter, never crashed on.  A legacy
`checkpoint.msgpack` (no sidecar) is accepted last.

`prune` counts a payload this process wrote or already checked, and has
not changed since (same inode, size and mtime), as valid without reading
it again; every restore walk re-hashes.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

from mmlspark_tpu_torch import config
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import inc_counter
from mmlspark_tpu_torch.observe.trace import trace_event, trace_span

CKPT_KEEP = config.CKPT_KEEP

_PREFIX = "ckpt_"
_SUFFIX = ".msgpack"
_LEGACY = "checkpoint.msgpack"
LATEST = "LATEST"


def checkpoint_name(step: int) -> str:
    return f"{_PREFIX}{step:010d}{_SUFFIX}"


def step_of(name: str) -> int:
    return int(name[len(_PREFIX):-len(_SUFFIX)])


def _pieces(data) -> list:
    """`data` as a list of bytes-like pieces (a payload may come as the
    pieces of `ckpt_writer.serialize_chunks`)."""
    return [data] if isinstance(data, (bytes, bytearray, memoryview)) \
        else list(data)


def _sha256(data) -> str:
    h = hashlib.sha256()
    for piece in _pieces(data):
        h.update(piece)
    return h.hexdigest()


def _atomic_write(path: str, data) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(_pieces(data))
    os.replace(tmp, path)  # a crash never leaves a torn file at `path`


# (device, inode, size, mtime_ns) -> sha256 of the checkpoint payloads this
# process wrote or checked: `prune` counts such a file as valid without
# reading it again.  Any write to the file (a tear, a rewrite) changes its
# size or mtime and drops it from the cache; a restore always re-reads
# and re-hashes (`is_valid`).
_verified: dict = {}


def _stat_key(path: str):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return st.st_dev, st.st_ino, st.st_size, st.st_mtime_ns


def _remember(path: str, digest: str) -> None:
    key = _stat_key(path)
    if key is not None:
        _verified[path] = (key, digest)


def _known_valid(path: str) -> bool:
    """`is_valid` for `prune`: a payload this process wrote or checked,
    unchanged since (same inode, size and mtime) and whose sidecar still
    names its digest, counts without a re-read."""
    known = _verified.get(path)
    if known is not None and known[0] == _stat_key(path):
        try:
            with open(path + ".sha256") as f:
                if f.read().strip() == known[1]:
                    return True
        except OSError:
            pass
    return is_valid(path)


def sweep_orphan_tmps(ckpt_dir: str) -> int:
    """Delete stray `*.tmp` files of a writer killed mid-write (the only
    debris the tmp+rename protocol can leave); swept on every write and
    restore walk.  Returns how many went."""
    if not os.path.isdir(ckpt_dir):
        return 0
    swept = 0
    for name in os.listdir(ckpt_dir):
        if not name.endswith(".tmp"):
            continue
        try:
            os.remove(os.path.join(ckpt_dir, name))
            swept += 1
        except FileNotFoundError:
            continue
    if swept:
        inc_counter("checkpoint.orphan_tmps_swept", swept)
        trace_event("checkpoint.orphan_tmps_swept", cat="resilience",
                    dir=ckpt_dir, count=swept)
        get_logger("resilience").warning(
            "swept %d orphaned .tmp file(s) from %s (writer killed "
            "mid-write)", swept, ckpt_dir)
    return swept


def write_checkpoint(ckpt_dir: str, step: int, data,
                     keep: Optional[int] = None,
                     meta: Optional[dict] = None) -> str:
    """Write one checkpoint + checksum sidecar (+ the `.meta.json` when
    `meta` is given), advance LATEST, prune; returns the payload path.
    `data` is the payload's bytes or a list of its bytes-like pieces.
    The sidecar lands before the payload's rename and LATEST moves after
    both, so every state a crash leaves is ignorable or valid."""
    nbytes = sum(memoryview(p).nbytes for p in _pieces(data))
    with trace_span("checkpoint.write", cat="checkpoint", step=step,
                    bytes=nbytes):
        os.makedirs(ckpt_dir, exist_ok=True)
        sweep_orphan_tmps(ckpt_dir)
        name = checkpoint_name(step)
        path = os.path.join(ckpt_dir, name)
        digest = _sha256(data)
        _atomic_write(path + ".sha256", digest.encode())
        if meta is not None:
            _atomic_write(path + ".meta.json",
                          json.dumps(meta, sort_keys=True).encode())
        _atomic_write(path, data)
        _remember(path, digest)
        _atomic_write(os.path.join(ckpt_dir, LATEST), name.encode())
        from mmlspark_tpu_torch.resilience.chaos import get_injector
        get_injector().maybe_tear_checkpoint(path)
        inc_counter("checkpoint.writes")
        prune(ckpt_dir,
              keep if keep is not None else int(CKPT_KEEP.current()))
        # scripted tears land after the prune, so the torn state stays on
        # disk for the next restore to skip
        get_injector().after_checkpoint_write(path)
        return path


def checkpoint_meta(path: Optional[str]) -> Optional[dict]:
    """The `.meta.json` sidecar of a payload path, or None on any read or
    parse failure (advisory: never makes a valid checkpoint
    unrestorable)."""
    if not path:
        return None
    try:
        with open(path + ".meta.json") as f:
            out = json.load(f)
        return out if isinstance(out, dict) else None
    except (OSError, ValueError):
        return None


def list_checkpoints(ckpt_dir: str) -> list[tuple[int, str]]:
    """[(step, path)] of rotation-layout checkpoints, newest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith(_PREFIX) and name.endswith(_SUFFIX):
            try:
                out.append((step_of(name), os.path.join(ckpt_dir, name)))
            except ValueError:
                continue
    return sorted(out, reverse=True)


def is_valid(path: str) -> bool:
    """True when the payload matches its sidecar checksum (read and hashed
    in 16 MiB blocks)."""
    sidecar = path + ".sha256"
    if not (os.path.exists(path) and os.path.exists(sidecar)):
        return False
    with open(sidecar) as f:
        expected = f.read().strip()
    key = _stat_key(path)
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    if h.hexdigest() != expected:
        return False
    if key is not None:
        _verified[path] = (key, expected)
    return True


def latest_valid_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest checkpoint that passes validation, or None: the LATEST
    pointer's target first, then every rotation checkpoint newest-first,
    then the legacy single file.  Invalid candidates are skipped with a
    warning and the `checkpoint.skipped_corrupt` counter."""
    with trace_span("checkpoint.validate", cat="checkpoint"):
        sweep_orphan_tmps(ckpt_dir)
        candidates: list[str] = []
        pointer = os.path.join(ckpt_dir, LATEST)
        if os.path.exists(pointer):
            with open(pointer) as f:
                candidates.append(os.path.join(ckpt_dir, f.read().strip()))
        candidates += [p for _, p in list_checkpoints(ckpt_dir)]
        seen = set()
        log = get_logger("resilience")
        for path in candidates:
            if path in seen:
                continue
            seen.add(path)
            if is_valid(path):
                return path
            if os.path.exists(path):
                inc_counter("checkpoint.skipped_corrupt")
                trace_event("checkpoint.skipped_corrupt", cat="resilience",
                            path=path)
                log.warning("skipping corrupt/torn checkpoint %s "
                            "(checksum mismatch)", path)
        legacy = os.path.join(ckpt_dir, _LEGACY)
        if os.path.exists(legacy):
            return legacy
        return None


def prune(ckpt_dir: str, keep: int) -> None:
    """Delete rotation checkpoints (and sidecars) beyond the newest `keep`
    valid ones; corrupt files are deleted outright."""
    if keep <= 0:
        return
    kept = 0
    for _, path in list_checkpoints(ckpt_dir):
        if kept < keep and _known_valid(path):
            kept += 1
            continue
        _verified.pop(path, None)
        for victim in (path, path + ".sha256", path + ".meta.json"):
            try:
                os.remove(victim)
            except FileNotFoundError:
                pass
        inc_counter("checkpoint.pruned")
