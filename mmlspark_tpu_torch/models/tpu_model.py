"""TPUModel: DNN scoring of a table column as a pipeline Transformer (the
port of `mmlspark_tpu/models/tpu_model.py`; the counterpart of
MMLSpark's CNTKModel).

`transform` streams fixed-shape minibatches of the input column through
the bundle's module: every batch is `miniBatchSize` rows (the last
zero-padded, its output trimmed), so the device sees one shape.  Over a
mesh (`set_mesh`, or with none set `parallel.mesh.default_mesh`, the
JAX stage's `_get_mesh`) each minibatch is padded to a multiple of the
data axis, cut into contiguous slabs and scored per shard, the module
replicated once to each distinct device (CNTKModel's Spark partitions);
the results are joined in row order.
The scoring models are torch modules whose convolutions, Dense layers,
BatchNorm and pools run on cuDNN and cuBLAS; no hand-written kernel lies
on this path.

  * **Node selection**: `outputNodeName` / `outputNodeIndex` pick one of
    the named nodes the module returns (`models/definitions.py`
    `_Scorer`), as the JAX stage picks a sown intermediate.
  * **Compute dtype**: `computeDtype` rebuilds the module at that dtype;
    with an override or a quantized bundle (bf16 or int8 weights,
    `quant/quantize.py`) the output is float32 at the table boundary.
    int8 bundles keep their weights int8 on the device (`Int8Dense`,
    `Int8Conv`).  A float32 forward runs with TF32 off for cuDNN and
    cuBLAS, set by the stage itself, so f32 means f32 on the card.
  * **Staging**: the host half of every batch (stacking the column,
    zero padding into a pinned buffer, the non-blocking copy on a side
    stream) runs on the worker threads of a `Dataset` map stage
    (`data/dataset.py`), `prefetchDepth` batches ahead of the dispatch
    thread, which only launches the forward and drains results through
    pinned buffers (`parallel/bridge.py` `DeviceFeed`).  The device's
    in-flight window follows the stage's depth live, so with
    `prefetchDepth=0` the data layer's Autotuner sizes both.
    `transform_batches` keeps one window open across tables, and takes
    any iterable of tables, a `Dataset` of them included.
  * **Inputs**: uint8 columns travel as bytes and are cast to float32 on
    the device; other integer columns are not cast; float64 columns are
    scored as float32, as JAX (without x64) places them.
  * **CheckpointData**: a table whose input column `stages.CheckpointData`
    cached on the stage's devices is scored from the cache: one tensor on
    one device, or over a mesh one contiguous slab per shard, which that
    shard scores in minibatches of its share of `miniBatchSize` (the last
    zero-padded on the device), so the column makes no host->device copy
    (`DeviceFeed.put_bytes` stays where it was); float64 / int64 narrow
    on the device as they do on the host.  `transform_batches` reads the
    host column, as the JAX stage's does.
  * **Outputs**: numpy has no bfloat16, so a bfloat16 node (selected from
    a bf16 module without an override) comes out widened, exactly, to
    float32; the JAX stage returns it as bfloat16.

Under `run_telemetry` each new batch shape class raises a `recompile`
event and its first batch is counted for the run's roofline row
(`observe/costmodel.py`), with one synced probe forward after it.

A TransformerLM bundle is scored over token ids (integer columns are
not cast): the output is its logits (B, S, vocab), float32, as the JAX
stage returns them.

Over a mesh with a model axis the bundle's variables are placed by its
own partition rules (DEFAULT_RULES for a bundle without them; unmatched
leaves replicate), as the JAX stage's `shard_tree` places them: each
data row's slab is scored on the row's home replica over its model group
(`parallel/bridge.py` `ModelShardReplicas`, `models/definitions.py`), a
TransformerLM's attention per model shard on its own heads (the flash
kernel K1 under `attn_impl="flash"`).  A vision bundle's leaves match no
rule but the catch-all, so every leaf replicates and each row's slab is
scored once on its home.

Several processes (`parallel/distributed.py`): each process scores its
own rows, as MMLSpark scores each partition on its own executor
(CNTKModel.scala:215-221).  A mesh over this process's own devices (the
default: `default_mesh` stays local) and a mesh over every process
(`parallel/mesh.py` `make_process_mesh`, which holds this process's block
of data rows) take the same loop and give the same rows.  The JAX package
runs a global mesh in lockstep steps with zero padding because its jitted
program spans every process; here the model and stage axes stay inside a
process, so no scoring step crosses one and no lockstep is needed.  A
global mesh is only checked: it must span every process, with a data axis
a multiple of the process count (the JAX package's two ValueErrors).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import exact_f32, resolve_device
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.table import DataTable
from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_bundle,
                                              save_bundle)
from mmlspark_tpu_torch.observe.costmodel import ProgramCosts
from mmlspark_tpu_torch.observe.spans import active_timings, span_on
from mmlspark_tpu_torch.observe.telemetry import active_run
from mmlspark_tpu_torch.observe.trace import (active_tracer,
                                              current_span_id,
                                              span_on_tracer)
from mmlspark_tpu_torch.parallel.bridge import DeviceFeed, ModelShardReplicas
from mmlspark_tpu_torch.parallel.distributed import process_count
from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                              batch_devices, default_mesh)
from mmlspark_tpu_torch.parallel.partition import port_splits, registry_rule
from mmlspark_tpu_torch.data import Dataset
from mmlspark_tpu_torch.parallel.prefetch import OncePerTable, resolve_depth


class TPUModel(Transformer):
    """Score a table column through a bundle's model on one device or
    over a mesh (module docstring)."""

    saved_class = "mmlspark_tpu.models.tpu_model.TPUModel"

    inputCol = Param(None, "input column (numeric array per row)", ptype=str)
    outputCol = Param("output", "output column for scores", ptype=str)
    miniBatchSize = Param(
        256, "rows per forward; the last batch is zero-padded", ptype=int,
        validator=lambda v: v > 0)
    outputNodeName = Param(None, "named node to output (None = final)",
                           ptype=str)
    outputNodeIndex = Param(None, "index into the ordered named nodes",
                            ptype=int)
    prefetchDepth = Param(
        None, "pipeline depth: staged batches in flight (host staging and "
        "the host->device copy overlap the forward); None defers to "
        "MMLSPARK_TPU_PREFETCH_DEPTH, positive values pin the depth, 0 "
        "lets the data layer's Autotuner size it from measured stalls, -1 "
        "disables overlap",
        ptype=int, validator=lambda v: v >= -1)
    computeDtype = Param(
        None, "compute-dtype override: 'bfloat16' runs a float32 bundle "
        "at bf16, 'float32' forces exact f32; None keeps the bundle "
        "module's own dtype.  With an override (or a quantized bundle) "
        "outputs are float32 at the table boundary", ptype=str,
        domain=("float32", "bfloat16"))

    def __init__(self, bundle: Optional[ModelBundle] = None, device="cuda",
                 **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self._bundle = bundle
        # (compute dtype, device) -> the module there
        self._modules: dict = {}
        self._feeds: dict = {}     # device -> its DeviceFeed
        self._mesh = None
        self._shards: Optional[list] = None   # each shard's device
        # batch shape classes scored under telemetry (a NEW one is a
        # `recompile` event, as in the JAX package) and their cost rows
        # (counted over the class's first batch, replayed into later runs)
        self._seen_shapes: set = set()
        self._costs = ProgramCosts("tpu_model")

    # -- model wiring ----------------------------------------------------
    def set_bundle(self, bundle: Optional[ModelBundle]) -> "TPUModel":
        self._bundle = bundle
        self._modules.clear()
        self._seen_shapes.clear()
        self._costs.clear()
        return self

    @property
    def bundle(self) -> Optional[ModelBundle]:
        return self._bundle

    def set_mesh(self, mesh) -> "TPUModel":
        """Score over `mesh` (`parallel.mesh.Mesh`): each minibatch cut
        into one slab per data row; the module replicated to each distinct
        device, or with a model axis placed by the bundle's partition
        rules over each row's model group (module docstring)."""
        self._mesh = mesh
        self._shards = [resolve_device(d) for d in batch_devices(mesh)]
        self.device = self._shards[0]
        self._modules.clear()
        self._feeds.clear()
        self._seen_shapes.clear()
        self._costs.clear()
        return self

    def shard_devices(self) -> list:
        """Each shard's device: the mesh's data axis, or with none set
        `default_mesh`'s (this stage's own device when that is one
        shard)."""
        if self._shards is None:
            shards = batch_devices(default_mesh(self.device))
            self._shards = [self.device] if len(shards) == 1 else shards
            self.device = self._shards[0]
        return self._shards

    @staticmethod
    def _mesh_is_multiprocess(mesh) -> bool:
        """Whether `mesh` spans several processes (module docstring)."""
        return mesh is not None and mesh.process_count > 1

    def _check_process_mesh(self) -> None:
        """A mesh over several processes must span all of them, with a
        data axis a multiple of the process count (module docstring)."""
        mesh = self._mesh
        if not self._mesh_is_multiprocess(mesh):
            return
        nproc = process_count()
        if mesh.process_count != nproc:
            raise ValueError(
                f"multi-host scoring mesh spans {mesh.process_count} of "
                f"{nproc} processes; use a mesh over ALL processes' "
                f"devices, or a local-devices mesh for independent "
                f"per-process scoring")
        n_data = mesh.global_shape[DATA_AXIS]
        if n_data % nproc:
            raise ValueError(
                f"multi-host scoring needs the data axis ({n_data}) to be "
                f"a multiple of the process count ({nproc})")

    def _select_output(self, final, nodes: dict):
        name, idx = self.outputNodeName, self.outputNodeIndex
        if name is not None:
            if name not in nodes:
                raise KeyError(
                    f"model has no node '{name}'; nodes: {list(nodes)}")
            return nodes[name]
        if idx is not None:
            keys = list(nodes)
            if idx >= len(keys):
                raise IndexError(
                    f"outputNodeIndex {idx} out of range; nodes: {keys}")
            return nodes[keys[idx]]
        return final

    def _quant_mode(self) -> Optional[str]:
        return ((self._bundle.metadata or {}).get("quantization")
                or {}).get("mode")

    def _shard_modules(self, devices: list) -> list:
        """The module each data shard scores with: the bundle's module on
        its device, or over a model axis each data row's home replica
        (placed once per compute dtype)."""
        if self._mesh is None or self._mesh.shape[MODEL_AXIS] == 1:
            return [self._scoring_module(d) for d in devices]
        key = (self.computeDtype, "model group")
        if key not in self._modules:
            module = self._scoring_module(devices[0])
            splits = port_splits(module, self._mesh, registry_rule(
                self._mesh, self._bundle.partition_rules()))
            self._modules[key] = ModelShardReplicas(
                module, self._mesh, splits, trainable=False).shards
        return self._modules[key]

    def _scoring_module(self, device=None) -> torch.nn.Module:
        """The bundle's module on `device` (default the stage's first),
        rebuilt at `computeDtype` when the Param is set (cached per dtype
        and device)."""
        if self._bundle is None:
            raise ValueError("TPUModel has no model bundle; call set_bundle()")
        cd = self.computeDtype
        device = self.device if device is None else device
        if (cd, device) not in self._modules:
            config = (None if cd is None
                      else {**self._bundle.config, "dtype": cd})
            self._modules[cd, device] = self._bundle.module(device, config)
        return self._modules[cd, device]

    def _apply(self, module, x: torch.Tensor) -> torch.Tensor:
        """The forward of one device batch, its selected node as the table
        will hold it."""
        cast_f32 = (self.computeDtype is not None
                    or self._quant_mode() is not None)
        exact = (contextlib.nullcontext() if module.dtype != torch.float32
                 else exact_f32())
        with torch.inference_mode(), exact:
            if x.dtype == torch.uint8:
                x = x.float()
            out = module(x)
            # a scoring model returns (output, nodes), a TransformerLM its
            # logits and no nodes
            out = self._select_output(*(out if isinstance(out, tuple)
                                        else (out, {})))
        if out.dtype == torch.bfloat16 or (cast_f32
                                           and out.is_floating_point()):
            out = out.float()
        return out

    def _scored(self, modules: list, xs: list, key: str, run, tracer,
                parent) -> list:
        """`_apply` of one batch of shape class `key`, shard by shard
        (`modules[i]` over `xs[i]`); under a run, a new class raises a
        `recompile` event and its first batch is counted
        (observe/costmodel.py), with a synced probe forward after it for a
        clean step time (the forward has no side effect); later batches
        add their dispatch walls."""
        def apply():
            return [self._apply(m, x) for m, x in zip(modules, xs)]
        if run is None:
            return apply()
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            tracer.event("recompile", parent=parent, cat="compile",
                         where="tpu_model", shape_class=key)
        with self._costs.execution(run, key, probe=apply,
                                   device=self.device):
            return apply()

    @staticmethod
    def _tensor_column(col: np.ndarray) -> np.ndarray:
        if col.dtype == object:
            if not len(col):
                return np.zeros((0, 1), np.float32)
            stacked = np.stack([np.asarray(v) for v in col])
            # integer rows stay integer; everything else is float32
            if np.issubdtype(stacked.dtype, np.integer):
                col = stacked
            else:
                return stacked.astype(np.float32)
        if col.dtype == np.float64:
            return col.astype(np.float32)
        if col.dtype == np.int64:
            return col.astype(np.int32)
        return col

    def _empty_output(self, module, col: np.ndarray) -> np.ndarray:
        """A zero-row result of the output's trailing shape and dtype (one
        zero row through the forward)."""
        feed = self._get_feed()
        dev, event = feed.put(feed.stage(
            np.zeros((0,) + col.shape[1:], col.dtype), 1))
        out = self._apply(module, feed.ready(dev, event))
        return feed.take(feed.fetch(out), 0)

    def _get_feed(self, device=None) -> DeviceFeed:
        """The `DeviceFeed` of `device` (default the stage's first), one
        per distinct device."""
        device = self.device if device is None else device
        if device not in self._feeds:
            self._feeds[device] = DeviceFeed(device)
        return self._feeds[device]

    def _check_input(self, table) -> str:
        self._check_required()
        if not isinstance(table, DataTable):
            raise TypeError(
                f"TPUModel scores DataTables, not a {type(table).__name__}; "
                "stream a Dataset of tables through transform_batches")
        if self.inputCol is None:
            raise ValueError("TPUModel: inputCol is not set")
        return self.inputCol

    # -- transform -------------------------------------------------------
    def transform(self, table: DataTable) -> DataTable:
        in_col = self._check_input(table)
        self._check_process_mesh()
        cached = getattr(table, "_device_cache", {}).get(in_col)
        if cached is not None:
            return table.with_column(
                self.outputCol,
                self._transform_cached(cached, len(table[in_col])))
        [scored] = list(self.transform_batches([table]))
        return scored

    def _transform_cached(self, column, n: Optional[int] = None
                          ) -> np.ndarray:
        """Score a column held on the devices (module docstring): one
        tensor, or a list of contiguous slabs, slab i on shard i's device
        (`n` the valid rows, default all).  Each shard scores its slab in
        minibatches of its share of `miniBatchSize`, with the dispatch
        window of the streaming loop."""
        devices = self.shard_devices()
        slabs = list(column) if isinstance(column, (list, tuple)) \
            else [column]
        if len(slabs) != len(devices) or any(
                t.device.type != d.type or (d.index is not None
                                            and t.device.index != d.index)
                for t, d in zip(slabs, devices)):
            raise ValueError(
                f"the column is cached on {[str(t.device) for t in slabs]}; "
                f"the stage scores on {[str(d) for d in devices]}")
        modules = self._shard_modules(devices)
        slabs = [t.float() if t.dtype == torch.float64 else
                 t.int() if t.dtype == torch.int64 else t for t in slabs]
        length = slabs[0].shape[0]
        n = length * len(slabs) if n is None else n
        if n == 0:
            return self._empty_output(
                modules[0], np.zeros((0,) + tuple(slabs[0].shape[1:]),
                                     str(slabs[0].dtype)[6:]))
        bs = -(-self.miniBatchSize // len(slabs))
        valid = [min(max(n - i * length, 0), length)
                 for i in range(len(slabs))]
        feeds = [self._get_feed(d) for d in devices]
        timings, tracer, run = active_timings(), active_tracer(), active_run()
        window = resolve_depth(self.prefetchDepth)[0]
        in_flight: list = []
        parts: list = [[] for _ in slabs]
        for start in range(0, length, bs):
            rows = min(bs, length - start)
            with span_on(timings, "transfer"):
                chunks = [t[start:start + bs] for t in slabs]
                if rows < bs:
                    chunks = [torch.cat([c, c.new_zeros(
                        (bs - rows,) + tuple(c.shape[1:]))]) for c in chunks]
            key = (f"{(bs * len(slabs),) + tuple(chunks[0].shape[1:])}:"
                   f"{str(chunks[0].dtype)[6:]}")
            parent = current_span_id()
            with span_on_tracer(tracer, "score.batch",
                                parent=parent, cat="batch",
                                shape_class=key,
                                rows=sum(min(max(v - start, 0), bs)
                                         for v in valid),
                                device_cached=True), \
                    span_on(timings, "compute"):
                outs = self._scored(modules, chunks, key, run, tracer,
                                    parent)
                in_flight.append([(feed.fetch(out),
                                   min(max(v - start, 0), bs))
                                  for feed, out, v in zip(feeds, outs,
                                                          valid)])
            while len(in_flight) > window:
                handles = in_flight.pop(0)
                with span_on(timings, "drain"):
                    for i, (feed, (handle, k)) in enumerate(
                            zip(feeds, handles)):
                        parts[i].append(feed.take(handle, k))
        for handles in in_flight:
            with span_on(timings, "drain"):
                for i, (feed, (handle, k)) in enumerate(zip(feeds, handles)):
                    parts[i].append(feed.take(handle, k))
        flat = [p for shard in parts for p in shard]
        return flat[0] if len(flat) == 1 else np.concatenate(flat)

    def transform_batches(self, tables) -> Iterator[DataTable]:
        """Streaming scoring: for each incoming table (any iterable of
        tables: a list, `read_images_iter`, a `Dataset`) yield it back
        with the output column appended.  Only the dispatch window's
        batches are resident on the host or the device, and the window
        stays open across table boundaries (module docstring)."""
        self._check_required()
        self._check_process_mesh()
        devices = self.shard_devices()
        modules = self._shard_modules(devices)
        feeds = [self._get_feed(d) for d in devices]
        bs = self.miniBatchSize
        # each shard's slab of a minibatch padded to a multiple of them
        slab = -(-bs // len(devices))
        timings = active_timings()   # captured HERE: workers have no context
        tracer, run = active_tracer(), active_run()
        score_span = tracer.span(
            "score.transform_batches", parent=current_span_id(),
            cat="phase", batch_size=bs) if tracer is not None else None
        score_id = score_span.span_id if score_span is not None else None
        in_flight: list[tuple[Any, int, dict]] = []
        ready: list[DataTable] = []
        pending: list[dict] = []

        def plans():
            # one item per minibatch, in (table, batch) order; each table's
            # stacking runs once, on the first staging thread to need it
            for table in tables:
                in_col = self._check_input(table)
                n = len(table[in_col])
                column = OncePerTable(
                    lambda t=table: self._tensor_column(t[in_col]))
                rec = {"table": table, "parts": [], "n_left": -(-n // bs)}
                if n == 0:
                    yield ("empty", rec, column, 0)
                for start in range(0, n, bs):
                    yield ("batch", rec, column, start)

        def stage(item):
            kind, rec, column, start = item
            if kind == "empty":
                return kind, rec, column, None, 0
            with span_on_tracer(tracer, "score.stage", parent=score_id,
                                cat="stage"):
                with span_on(timings, "host"):
                    rows = column.get()[start:start + bs]
                    hosts = [feed.stage(rows[i * slab:(i + 1) * slab], slab)
                             for i, feed in enumerate(feeds)]
                with span_on(timings, "transfer"):
                    puts = [feed.put(h) for feed, h in zip(feeds, hosts)]
            return kind, rec, puts, None, len(rows)

        def drain(limit: int):
            while len(in_flight) > limit:
                handles, valid, rec = in_flight.pop(0)
                with span_on(timings, "drain"):
                    for i, (feed, handle) in enumerate(zip(feeds, handles)):
                        rec["parts"].append(feed.take(
                            handle, min(max(valid - i * slab, 0), slab)))
                rec["n_left"] -= 1
            while pending and pending[0]["n_left"] == 0:
                rec = pending.pop(0)
                parts = rec["parts"]
                result = (parts[0] if len(parts) == 1
                          else np.concatenate(parts, axis=0))
                ready.append(rec["table"].with_column(self.outputCol,
                                                      result))

        staged = (Dataset.from_iterable(plans)
                  .map(stage, name="score", depth=self.prefetchDepth,
                       span=None)
                  .iterator())
        # the device's in-flight window follows the staging depth live, so
        # an Autotuner widen deepens dispatch pipelining in the same step
        score_runner = staged.stage("score").runner
        try:
            for kind, rec, payload, event, valid in staged:
                if rec.get("queued") is None:
                    rec["queued"] = True
                    pending.append(rec)
                if kind == "empty":   # payload: the table's column
                    rec["parts"] = [self._empty_output(modules[0],
                                                       payload.get())]
                    drain(len(in_flight))
                else:
                    # payload: each shard's (tensor, event)
                    xs = [feed.ready(*put)
                          for feed, put in zip(feeds, payload)]
                    key = (f"{(slab * len(xs),) + tuple(xs[0].shape[1:])}:"
                           f"{str(xs[0].dtype)[6:]}")
                    with span_on_tracer(tracer, "score.batch",
                                        parent=score_id, cat="batch",
                                        shape_class=key, rows=valid), \
                            span_on(timings, "compute"):
                        outs = self._scored(modules, xs, key, run, tracer,
                                            score_id)
                        handles = [feed.fetch(out)
                                   for feed, out in zip(feeds, outs)]
                    in_flight.append((handles, valid, rec))
                    drain(score_runner.depth)
                while ready:
                    yield ready.pop(0)
            drain(0)
            while ready:
                yield ready.pop(0)
        finally:
            staged.close()
            if score_span is not None:
                score_span.finish()

    # -- persistence -----------------------------------------------------
    def _save_extra(self, path: str) -> None:
        if self._bundle is not None:
            save_bundle(self._bundle, f"{path}/bundle")

    def _load_extra(self, path: str, **_init_kwargs) -> None:
        self.set_bundle(load_bundle(f"{path}/bundle")
                        if os.path.exists(f"{path}/bundle") else None)
