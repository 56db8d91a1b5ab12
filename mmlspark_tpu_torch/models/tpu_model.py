"""TPUModel: DNN scoring of a table column as a pipeline Transformer (the
port of `mmlspark_tpu/models/tpu_model.py`; the counterpart of
MMLSpark's CNTKModel).

`transform` streams fixed-shape minibatches of the input column through
the bundle's module on one device: every batch is `miniBatchSize` rows
(the last zero-padded, its output trimmed), so the device sees one shape.
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
  * **Outputs**: numpy has no bfloat16, so a bfloat16 node (selected from
    a bf16 module without an override) comes out widened, exactly, to
    float32; the JAX stage returns it as bfloat16.

Not ported, each raising with its ROADMAP item: a mesh of several devices
(`set_mesh`, the multi-host path; A10) and the device-cached
`CheckpointData` column (A6).  The port records no program-cost rows
(`observe/costmodel.py`, A11).  A TransformerLM bundle is scored by
`TextGenerator`, not here.
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
from mmlspark_tpu_torch.observe.spans import active_timings, span_on
from mmlspark_tpu_torch.observe.trace import (active_tracer,
                                              current_span_id,
                                              span_on_tracer)
from mmlspark_tpu_torch.parallel.bridge import DeviceFeed
from mmlspark_tpu_torch.data import Dataset
from mmlspark_tpu_torch.parallel.prefetch import OncePerTable


class TPUModel(Transformer):
    """Score a table column through a bundle's model on one device
    (module docstring)."""

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
        self._modules: dict = {}   # compute dtype -> module on the device
        self._feed: Optional[DeviceFeed] = None

    # -- model wiring ----------------------------------------------------
    def set_bundle(self, bundle: Optional[ModelBundle]) -> "TPUModel":
        self._bundle = bundle
        self._modules.clear()
        return self

    @property
    def bundle(self) -> Optional[ModelBundle]:
        return self._bundle

    def set_mesh(self, mesh) -> "TPUModel":
        """Score on a one-device `parallel.mesh.Mesh`'s device; a mesh of
        several devices is not ported."""
        devices = list(mesh.devices.flat)
        if len(devices) > 1:
            raise NotImplementedError(
                f"TPUModel over a mesh of {len(devices)} devices is not "
                "ported (ROADMAP A10); it scores on one device")
        self.device = resolve_device(devices[0])
        self._modules.clear()
        self._feed = None
        return self

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

    def _scoring_module(self) -> torch.nn.Module:
        """The bundle's module on the device, rebuilt at `computeDtype`
        when the Param is set (cached per dtype)."""
        if self._bundle is None:
            raise ValueError("TPUModel has no model bundle; call set_bundle()")
        if self._bundle.architecture == "TransformerLM":
            raise NotImplementedError(
                "TPUModel over a TransformerLM bundle is not ported; score "
                "it with TextGenerator (ROADMAP A3)")
        cd = self.computeDtype
        if cd not in self._modules:
            config = (None if cd is None
                      else {**self._bundle.config, "dtype": cd})
            self._modules[cd] = self._bundle.module(self.device, config)
        return self._modules[cd]

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
            out = self._select_output(*module(x))
        if out.dtype == torch.bfloat16 or (cast_f32
                                           and out.is_floating_point()):
            out = out.float()
        return out

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

    def _get_feed(self) -> DeviceFeed:
        if self._feed is None:
            self._feed = DeviceFeed(self.device)
        return self._feed

    def _check_input(self, table) -> str:
        self._check_required()
        if not isinstance(table, DataTable):
            raise TypeError(
                f"TPUModel scores DataTables, not a {type(table).__name__}; "
                "stream a Dataset of tables through transform_batches")
        if getattr(table, "_device_cache", None):
            raise NotImplementedError(
                "the device-cached CheckpointData column is not ported "
                "(ROADMAP A6)")
        if self.inputCol is None:
            raise ValueError("TPUModel: inputCol is not set")
        return self.inputCol

    # -- transform -------------------------------------------------------
    def transform(self, table: DataTable) -> DataTable:
        self._check_input(table)
        [scored] = list(self.transform_batches([table]))
        return scored

    def transform_batches(self, tables) -> Iterator[DataTable]:
        """Streaming scoring: for each incoming table (any iterable of
        tables: a list, `read_images_iter`, a `Dataset`) yield it back
        with the output column appended.  Only the dispatch window's
        batches are resident on the host or the device, and the window
        stays open across table boundaries (module docstring)."""
        self._check_required()
        module = self._scoring_module()
        bs = self.miniBatchSize
        feed = self._get_feed()
        timings = active_timings()   # captured HERE: workers have no context
        tracer = active_tracer()
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
                    host = feed.stage(rows, bs)
                with span_on(timings, "transfer"):
                    dev, event = feed.put(host)
            return kind, rec, dev, event, len(rows)

        def drain(limit: int):
            while len(in_flight) > limit:
                handle, valid, rec = in_flight.pop(0)
                with span_on(timings, "drain"):
                    rec["parts"].append(feed.take(handle, valid))
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
                    rec["parts"] = [self._empty_output(module,
                                                       payload.get())]
                    drain(len(in_flight))
                else:
                    dev = payload
                    key = f"{tuple(dev.shape)}:{str(dev.dtype)[6:]}"
                    with span_on_tracer(tracer, "score.batch",
                                        parent=score_id, cat="batch",
                                        shape_class=key, rows=valid), \
                            span_on(timings, "compute"):
                        out = self._apply(module, feed.ready(dev, event))
                        handle = feed.fetch(out)
                    in_flight.append((handle, valid, rec))
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
