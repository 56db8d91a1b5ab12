"""Versioned, round-trip-exact serialization of Dataset plans (the port
of `mmlspark_tpu/data/graph.py`; the same spec, byte for byte).

The data service (data/service/) ships a pipeline to worker processes as
data, not code: every `Dataset` op records a declarative `_spec` node, and
this module turns that chain into a versioned JSON document
(`to_spec`/`dumps`) and back into an executable `Dataset`
(`from_spec`/`loads`).  Round-trips are exact: `dumps(loads(dumps(ds)))`
is byte-identical, and running the rebuilt plan yields the same element
sequence as the original, which is the determinism contract the
service's byte-identical mode rests on.  A plan built from the same
module-level functions serializes to the same bytes in both packages.

Functions cross the process boundary by reference, never as pickled
code: a module-level function serializes as its import path
(`{"kind": "import", module, qualname}`), checked at serialize time so a
failure surfaces at `distribute()` on the consumer, not mid-epoch in a
worker.  Callables that are not importable (closures built at run time)
can be registered under a stable name at module import time with
`register_fn`; lambdas and unregistered closures raise
`GraphSerializationError`.  `from_table` sources hold a live in-memory
table and never serialize.

`build_range` is the worker's entry point: it builds the plan restricted
to output elements `[start, stop)`, a *split*.  Index-preserving ops (1:1
`map`, `prefetch`, `snapshot`, and `batch` by index arithmetic) are
pushed above the skip/take barrier, so upstream work for other splits is
never done; barrier ops (`shuffle`, `interleave`, `map(on_error="skip")`,
sources) replay their seeded stream below it, which keeps a split's
contents a pure function of (graph, range), the property crash
re-dispatch relies on.  `sync=True` builds every staged op inline (depth
-1: no pools), what the in-process workers use.
"""

from __future__ import annotations

import importlib
import json
from typing import Any, Callable, Optional

from mmlspark_tpu_torch.data.dataset import Dataset

GRAPH_VERSION = 1


class GraphSerializationError(ValueError):
    """A Dataset plan (or one of its functions) cannot be expressed in
    the versioned graph spec."""


_REGISTRY: dict[str, Callable] = {}


def register_fn(name: str, fn: Optional[Callable] = None):
    """Register a callable under a stable name for graph references.
    Call at module import time (workers re-register by importing the
    recorded module).  Usable directly or as a decorator."""
    def apply(f: Callable) -> Callable:
        _REGISTRY[name] = f
        return f
    return apply(fn) if fn is not None else apply


def _import_qualname(module: str, qualname: str):
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def _fn_ref(fn: Callable, op: str) -> dict:
    """Serialize a callable as a resolvable reference, verifying at
    serialize time that the reference round-trips to the same object."""
    for name, f in _REGISTRY.items():
        if f is fn:
            return {"kind": "registered", "name": name,
                    "module": getattr(fn, "__module__", "") or ""}
    mod = getattr(fn, "__module__", None)
    qn = getattr(fn, "__qualname__", None)
    if mod and qn and "<" not in qn:
        try:
            resolved = _import_qualname(mod, qn)
        except Exception:
            resolved = None
        if resolved is fn:
            return {"kind": "import", "module": mod, "qualname": qn}
    raise GraphSerializationError(
        f"{op}: callable {fn!r} is not serializable — it must be a "
        "module-level function (importable as module:qualname) or "
        "registered via data.graph.register_fn at import time; lambdas "
        "and runtime closures cannot cross the service boundary")


def _resolve_fn(ref: dict) -> Callable:
    if ref.get("kind") == "registered":
        name = ref["name"]
        if name not in _REGISTRY and ref.get("module"):
            importlib.import_module(ref["module"])  # triggers register_fn
        if name not in _REGISTRY:
            raise GraphSerializationError(
                f"registered fn {name!r} not found (module "
                f"{ref.get('module')!r} did not register it)")
        return _REGISTRY[name]
    if ref.get("kind") == "import":
        return _import_qualname(ref["module"], ref["qualname"])
    raise GraphSerializationError(f"unknown fn ref {ref!r}")


def _json_check(op: str, params: dict) -> dict:
    try:
        json.dumps(params)
    except (TypeError, ValueError) as e:
        raise GraphSerializationError(
            f"{op}: params are not JSON-serializable ({e})") from None
    return params


def _node_spec(ds: Dataset) -> dict:
    if ds._spec is None:
        raise GraphSerializationError(
            f"dataset {ds._name!r} has no serializable plan (from_table "
            "and distribute nodes hold live process state)")
    op, params, parent = ds._spec
    p = dict(params)
    if op == "map":
        p["fn"] = _fn_ref(p["fn"], "map")
    elif op == "interleave":
        p["sub_fn"] = _fn_ref(p["sub_fn"], "interleave")
    elif op == "iterable":
        items = p["items"]
        if callable(items):
            p["items"] = {"fn": _fn_ref(items, "from_iterable")}
        else:
            p["items"] = _json_check("from_iterable",
                                     {"items": list(items)})["items"]
    node = {"op": op, "params": _json_check(op, p)}
    if parent is not None:
        node["parent"] = _node_spec(parent)
    return node


def to_spec(ds: Dataset) -> dict:
    """Serialize a Dataset plan to a versioned spec dict."""
    return {"version": GRAPH_VERSION, "root": _node_spec(ds)}


def dumps(ds: Dataset) -> str:
    """`to_spec` as canonical JSON (sorted keys — byte-stable)."""
    return json.dumps(to_spec(ds), sort_keys=True, separators=(",", ":"))


def _check_version(spec: dict) -> None:
    v = spec.get("version")
    if v != GRAPH_VERSION:
        raise GraphSerializationError(
            f"graph spec version {v!r} not supported "
            f"(this build speaks version {GRAPH_VERSION})")


def _stage_knobs(params: dict, sync: bool) -> dict:
    # sync=True forces stages inline (depth -1): in-process workers stay
    # thread-free, so drills are deterministic on a virtual clock
    return {"depth": -1 if sync else params.get("depth")}


def _build_node(node: Optional[dict], *, sync: bool = False) -> Dataset:
    if node is None:
        raise GraphSerializationError("graph node chain has no source")
    op, p = node["op"], node["params"]
    if op == "iterable":
        items = p["items"]
        src = _resolve_fn(items["fn"]) if isinstance(items, dict) else items
        return Dataset.from_iterable(src, name=p.get("name", "iterable"))
    if op == "files":
        return Dataset.from_files(
            p["path"], recursive=p["recursive"],
            sample_ratio=p["sample_ratio"], inspect_zip=p["inspect_zip"],
            pattern=p["pattern"], seed=p["seed"],
            name=p.get("name", "files"))
    return _apply_node(node, _build_node(node.get("parent"), sync=sync),
                       sync=sync)


def _apply_node(node: dict, parent: Dataset, *, sync: bool) -> Dataset:
    op, p = node["op"], node["params"]
    if op == "map":
        return parent.map(_resolve_fn(p["fn"]), name=p["name"],
                          workers=p["workers"], on_error=p["on_error"],
                          span=p["span"], **_stage_knobs(p, sync))
    if op == "batch":
        return parent.batch(p["batch_size"],
                            drop_remainder=p["drop_remainder"])
    if op == "shuffle":
        return parent.shuffle(p["buffer_size"], seed=p["seed"])
    if op == "interleave":
        return parent.interleave(_resolve_fn(p["sub_fn"]),
                                 cycle_length=p["cycle_length"],
                                 block_length=p["block_length"])
    if op == "prefetch":
        return parent.prefetch(-1 if sync else p["depth"], name=p["name"])
    if op == "skip":
        return parent.skip(p["n"])
    if op == "take":
        return parent.take(p["n"])
    if op == "snapshot":
        return parent.snapshot(p["tag"])
    raise GraphSerializationError(f"unknown graph op {op!r}")


def from_spec(spec: dict, *, sync: bool = False) -> Dataset:
    """Rebuild an executable Dataset from a spec dict.  `sync=True`
    forces every staged op inline (no pools) — inproc worker mode."""
    _check_version(spec)
    return _build_node(spec["root"], sync=sync)


def loads(text: str, *, sync: bool = False) -> Dataset:
    return from_spec(json.loads(text), sync=sync)


# ops whose output index i maps 1:1 to input index i, so an output
# range pushes through unchanged
_INDEX_PRESERVING = ("prefetch",)


def build_range(spec: dict, start: int, stop: int, *,
                sync: bool = False) -> Dataset:
    """Build the plan restricted to output elements [start, stop) — one
    service split.  See module docstring for the pushdown rules."""
    _check_version(spec)
    if not (0 <= start <= stop):
        raise ValueError(f"bad range [{start}, {stop})")
    node: Optional[dict] = spec["root"]
    pushed: list[dict] = []
    lo, hi = start, stop
    while node is not None:
        op, p = node["op"], node["params"]
        if op == "map" and p["on_error"] != "skip":
            pushed.append(node)           # 1:1 (column wraps, never drops)
        elif op in _INDEX_PRESERVING:
            pushed.append(node)
        elif op == "snapshot":
            pass  # identity in a worker: consumed-offset counting is a
            # consumer-side concern; per-split counts are meaningless
        elif op == "batch":
            pushed.append(node)           # batch i <- elements [i*bs,(i+1)*bs)
            bs = p["batch_size"]
            lo, hi = lo * bs, hi * bs
        else:
            break                         # barrier: replay seeded stream
        node = node.get("parent")
    ds = _build_node(node, sync=sync).skip(lo).take(hi - lo)
    for n in reversed(pushed):
        ds = _apply_node(n, ds, sync=sync)
    return ds
