"""The single-device Trainer: the port of `mmlspark_tpu/train/trainer.py`
(`_make_loss` :157-179, `_epoch_order` :197-208, `Trainer` :211-312,
:367-442, `fit_arrays` :445-927, `_numerics_check` :929-987,
`training_metric_data` :978-986, `bundle_from_state` :988-1022,
`_ckpt_meta` :1040-1060, `save_checkpoint` / `restore_checkpoint`
:1062-1170) for every registered architecture on one card: the
`TransformerLM` and the scoring models (`MLPClassifier`, `LinearModel`,
`ConvNetCIFAR10`, `ResNet`), the path of MMLSpark's CNTKLearner.

`fit_arrays` keeps the JAX loop's contract: the clamped batch size, the
numpy data order (`np.random.default_rng(seed)`, or `[seed, rng_fold]`),
a partial last batch padded by cycling rows of the epoch's order with a
0/1 loss mask (the pad rows are real rows, so they count in BatchNorm's
batch statistics, as in the JAX Trainer), one `history` row per epoch
that ran a step (loss, grad_norm, wall_s) fetched at the epoch's end,
and a bundle whose metadata records `steps` and the partition layout
exactly as the JAX Trainer writes them.

A step is forward -> loss -> `backward()` -> global gradient norm (f32)
-> the optax-algebra update of the f32 masters (`train/optim.py`).  The
forward runs in `train()` mode: a scoring model's BatchNorm layers
normalize with the batch's statistics and move their running statistics
in place during the forward (`models/definitions.py` `BatchNorm`), and
the loss reads the logits node of the scorer's `(z, nodes)`.  With
`attn_impl="flash"` the LM's attention forward and backward are the CUDA
kernels K1-K3 (`ops/flash_attention.py`); convolutions, pools, BatchNorm
and Dense layers are torch ops (cuDNN, cuBLAS).  A float32 model's step
runs with TF32 off (`core.device.exact_f32`), as `TPUModel` scores it.
A mixture-of-experts LM's sown losses (`moe_aux_loss`, `moe_z_loss`) join
the objective weighted by `aux_loss_weight`, and its sown metrics fold
into one history column each (`moe_overflow_fraction`, `fold_metrics`),
as in the JAX Trainer.

Staging, as in the JAX Trainer: a `Dataset` map stage (`data/dataset.py`)
builds batch k+1 (the index gather, the mask, pinned host buffers and the
non-blocking copy on a side stream, `parallel/bridge.py` `DeviceFeed`)
while step k runs.  `prefetch_depth` sets the window: positive pins it, 0
hands it to the data layer's Autotuner, -1 stages on the dispatch
thread.  Batches travel in their own dtype (uint8 images as bytes) and
the module casts on the card; float64 and int64 arrays are narrowed to
float32 and int32 on the host, as JAX places them.  The data order, the
pad rows and the mask are the same at every depth.

Fault tolerance, as in the JAX Trainer:

  * checkpoints (`ckpt_dir` or `config.checkpoint_dir`) every
    `checkpoint_every_steps` steps and at the end, in the JAX package's
    rotation layout and payload format (`resilience/checkpoints.py`,
    `resilience/ckpt_writer.py`: a checkpoint either package writes
    restores in the other, BatchNorm statistics in its `batch_stats`),
    async by default: the state is copied on the card before the next
    step runs and written by a background thread;
  * `resume=True` restores the newest valid checkpoint and replays the
    same data order, skipping the completed steps; the `.meta.json`
    sidecar's effective batch size is adopted (the one-card half of
    elastic resume);
  * SIGTERM (`PreemptionGuard`) -> an emergency checkpoint at the step
    boundary, then `Preempted`;
  * `skip_data_windows`: the step number advances, the data and the
    update are skipped (the recovery supervisor's lever,
    `train/supervisor.py`);
  * `step_timeout_s`: the hung-step watchdog (armed from the third
    executed step), a best-effort checkpoint of the last completed state
    on `HungStepError` when the hung step never launched (one that did
    may still be updating the parameters, moments and BatchNorm
    statistics in place, so none is written and recovery falls back to
    the last periodic checkpoint);
  * the numerics probe every `numerics_cadence` steps
    (`observe/numerics.py`), computed on the card and fetched at the
    step boundary; `halt_on_nonfinite` / `halt_on_divergence` raise
    before any checkpoint write;
  * the chaos hooks of `resilience/chaos.py` (`on_step`, `maybe_hang`,
    `poison_nan`, torn checkpoints).

Still raising NotImplementedError: meshes and pipeline stages (ROADMAP
A10; seq-parallel training is `parallel/ring.py`'s
`make_seq_parallel_lm_step`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.device import exact_f32, resolve_device
from mmlspark_tpu_torch.data import Dataset
from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_variables,
                                              variables_from_jax)
from mmlspark_tpu_torch.models.definitions import (BatchNorm, build_model,
                                                   init_scoring_params,
                                                   init_transformer_lm_params)
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.metrics import MetricData, inc_counter
from mmlspark_tpu_torch.observe.numerics import (DivergenceError,
                                                 LossSpikeDetector,
                                                 NonFiniteError,
                                                 fetch_health, tree_health)
from mmlspark_tpu_torch.observe.spans import (active_timings, monotonic,
                                              span_on)
from mmlspark_tpu_torch.observe.telemetry import active_run
from mmlspark_tpu_torch.observe.trace import (active_tracer, current_span_id,
                                              span_on_tracer, trace_event,
                                              trace_span)
from mmlspark_tpu_torch.parallel.bridge import DeviceFeed
from mmlspark_tpu_torch.parallel.partition import DEFAULT_RULES, rules_to_json
from mmlspark_tpu_torch.resilience.chaos import get_injector
from mmlspark_tpu_torch.resilience.checkpoints import (
    checkpoint_meta, latest_valid_checkpoint)
from mmlspark_tpu_torch.resilience.ckpt_writer import (CheckpointWriter,
                                                       read_checkpoint)
from mmlspark_tpu_torch.resilience.preemption import (HungStepError,
                                                      Preempted,
                                                      PreemptionGuard,
                                                      StepWatchdog)
from mmlspark_tpu_torch.train.config import TrainerConfig
from mmlspark_tpu_torch.train.optim import (Optimizer, backward_and_update,
                                            global_norm, named_tree,
                                            opt_state_from_jax,
                                            opt_state_to_jax, stats_tree)

_LOG = logging.getLogger("mmlspark_tpu_torch.train")


def make_loss(kind: str) -> Callable:
    """The JAX `_make_loss`: a per-row loss (mean over any trailing axes)
    averaged over the rows whose mask is 1."""
    def loss_fn(logits, labels, mask):
        mask = mask.float()
        denom = torch.clamp(mask.sum(), min=1.0)
        if kind == "softmax_xent":
            ll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 labels.reshape(-1).long(),
                                 reduction="none").reshape(labels.shape)
        elif kind == "sigmoid_xent":
            z, t = logits.squeeze(-1), labels.float()
            ll = -t * F.logsigmoid(z) - (1.0 - t) * F.logsigmoid(-z)
        elif kind in ("mse", "mae"):
            pred = logits.squeeze(-1) if logits.dim() > labels.dim() \
                else logits
            diff = pred - labels.float()
            ll = diff * diff if kind == "mse" else diff.abs()
        else:
            raise ValueError(f"unknown loss {kind}")
        if ll.dim() > 1:
            ll = ll.mean(dim=tuple(range(1, ll.dim())))
        return (ll * mask).sum() / denom

    return loss_fn


def sown_leaves(tree: dict) -> list:
    """The leaves of a sown collection in JAX's tree order (sorted keys)."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for key in sorted(tree) for leaf in sown_leaves(tree[key])]


def fold_metrics(tree: dict) -> dict:
    """The JAX `_fold_metrics`: a sown "metrics" collection collapsed to
    {metric name: the mean over every module that sowed it} (every MoE
    layer's overflow fraction into one `moe_overflow_fraction`), 0-d f32
    tensors, detached."""
    grouped: dict = {}

    def walk(node, name):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], key)
        else:
            grouped.setdefault(name, []).append(node.detach().float())

    walk(tree, "metric")
    return {k: torch.stack(v).mean() for k, v in grouped.items()}


def epoch_order(rng, epoch: int, n: int, n_local: int,
                shuffle: bool) -> np.ndarray:
    """The `n` row indices this epoch feeds (the JAX `_epoch_order`)."""
    if shuffle:
        return rng.permutation(n_local)[:n]
    if n == n_local:
        return np.arange(n)
    return (np.arange(n) + epoch * n) % n_local


def host_batch(arr: np.ndarray) -> np.ndarray:
    """A host batch as JAX (without x64) places it: float64 and int64
    narrowed to float32 and int32, every other dtype kept."""
    narrow = {np.dtype(np.float64): np.float32,
              np.dtype(np.int64): np.int32}.get(arr.dtype)
    return arr if narrow is None else arr.astype(narrow)


@dataclasses.dataclass
class TrainState:
    """The global step, the parameters (the module's f32 masters, updated
    in place), the optimizer's state and the BatchNorm statistics (the
    module's `mean` / `var` buffers, updated in place by the training
    forward; empty for a model without BatchNorm)."""

    step: int
    params: list
    opt_state: dict
    batch_stats: list = dataclasses.field(default_factory=list)


class Trainer:
    """Drives the training loop for one model on one card."""

    def __init__(self, config: TrainerConfig, mesh=None, device="cuda"):
        if config.pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline stages are not ported (ROADMAP A10)")
        if mesh is not None:
            raise NotImplementedError(
                "the Trainer over a mesh is not ported (one card; ROADMAP "
                "A10): seq-parallel training is "
                "parallel.ring.make_seq_parallel_lm_step")
        spec = config.mesh
        if max(spec.data, spec.model, spec.seq) > 1:
            raise NotImplementedError(
                f"training over a mesh ({spec}) is not ported: the Trainer "
                "runs on one card (ROADMAP A10)")
        spec.resolve(1)   # a malformed spec raises
        self.config = config
        self.device = resolve_device(device)
        self.module = build_model(config.architecture, config.model_config,
                                  device=self.device)
        # the scoring models return (z, nodes) and infer their first
        # layers' widths from the input
        self._scoring = config.architecture != "TransformerLM"
        self._names = [n for n, _ in self.module.named_parameters()]
        self._stat_names = [f"{prefix}.{leaf}" for prefix, mod in
                            self.module.named_modules()
                            if isinstance(mod, BatchNorm)
                            for leaf in ("mean", "var")]
        self._loss = make_loss(config.loss)
        self.history: list[dict] = []
        self.last_health: Optional[dict] = None
        self.last_staging: Optional[dict] = None
        # background checkpoint writers, one per directory; closed at the
        # end of each fit
        self._writers: dict[str, CheckpointWriter] = {}
        self._effective_batch_size: Optional[int] = None

    # -- state ----------------------------------------------------------
    def init_state(self, input_shape: tuple, total_steps: int = 1,
                   initial_bundle: Optional[ModelBundle] = None,
                   input_dtype=np.float32) -> TrainState:
        """Load the module's seeded init (or warm-start from a bundle:
        parameters and BatchNorm statistics) into its f32 masters and
        buffers, and build the optimizer state.  A scoring model's init
        (`init_scoring_params`) reads `input_shape`, a batch's shape, for
        the widths its first layer infers; the LM's ignores it.
        `input_dtype` is the JAX signature's: a shape is all the port's
        init reads.  A warm start resumes the bundle's recorded step."""
        self._tx = Optimizer(self.config, total_steps)
        if initial_bundle is not None:
            variables = initial_bundle.variables
        elif self._scoring:
            variables = init_scoring_params(self.module, tuple(input_shape),
                                            self.config.seed)
        else:
            variables = init_transformer_lm_params(self.module.config,
                                                   self.config.seed)
        load_variables(self.module, variables)
        self.module.train()
        params = list(self.module.parameters())
        start = int((initial_bundle.metadata or {}).get("steps", 0)) \
            if initial_bundle is not None else 0
        return TrainState(step=start, params=params,
                          opt_state=self._tx.init(params),
                          batch_stats=[self.module.get_buffer(n)
                                       for n in self._stat_names])

    # -- the step -------------------------------------------------------
    def make_train_step(self):
        """`step(state, x, y, mask, probe=False) -> (loss, metrics)`, both
        device tensors; the state's parameters, optimizer state and
        BatchNorm statistics are updated in place and its step advances.
        `metrics` holds `grad_norm`, and on a probe step `health`
        (`tree_health` over the new parameters, the gradients, the
        updates and the logits)."""
        module, loss_fn, tx, names = (self.module, self._loss, self._tx,
                                      self._names)
        scoring = self._scoring
        f32 = module.dtype == torch.float32
        aux_w = float(self.config.aux_loss_weight)

        def train_step(state: TrainState, x, y, mask, probe: bool = False):
            def loss_and_logits():
                if scoring:
                    logits, sown = module(x)[0], {}
                else:
                    logits, sown = module(x, collect=True)
                loss = loss_fn(logits, y, mask)
                if aux_w:
                    # model-sown auxiliary losses (the MoE load-balance and
                    # z terms, ops/moe.py) join the objective
                    loss = loss + aux_w * sum(
                        sown_leaves(sown.get("losses", {})))
                return loss, (logits, sown.get("metrics", {}))

            # a float32 model computes in f32 on the card: TF32 off
            with exact_f32() if f32 else contextlib.nullcontext():
                loss, (logits, sown), grads, updates = backward_and_update(
                    tx, state.params, state.opt_state, loss_and_logits,
                    return_updates=probe)
            metrics = {**fold_metrics(sown), "grad_norm": global_norm(grads)}
            state.step += 1
            if probe:
                metrics["health"] = tree_health(
                    dict(zip(names, state.params)), dict(zip(names, grads)),
                    dict(zip(names, updates)), acts=logits.detach())
            return loss.detach(), metrics

        return train_step

    def _sync(self) -> None:
        """Wait for the work queued so far on the card (a CUDA event's
        synchronize: what the watchdog bounds)."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            event.synchronize()

    # -- the loop -------------------------------------------------------
    def fit_arrays(self, x: np.ndarray, y: np.ndarray,
                   initial_bundle: Optional[ModelBundle] = None,
                   log_every: int = 50,
                   log_fn: Optional[Callable[[str], None]] = None,
                   ckpt_dir: Optional[str] = None,
                   resume: bool = False,
                   skip_data_windows: Optional[Sequence] = None
                   ) -> ModelBundle:
        """Train on arrays for `config.epochs` epochs; returns the trained
        bundle.  `self.history` gains one row per epoch that ran a step.

        `ckpt_dir` (default `config.checkpoint_dir`) arms the SIGTERM
        guard and the checkpoints; `resume=True` restarts from the newest
        valid checkpoint there, replaying the same data order and skipping
        completed steps, so a preempted-and-resumed run ends with the step
        count and weights of an uninterrupted one.  `skip_data_windows`
        ([(first, last)] inclusive step ranges) skips those steps' data
        and updates while the step number advances."""
        cfg = self.config
        ckpt_dir = ckpt_dir if ckpt_dir is not None else cfg.checkpoint_dir
        n = n_local = len(x)
        bs = max(cfg.batch_size, 1)   # the JAX clamp with a data axis of 1
        # the newest valid checkpoint, validated once for this fit
        restore_from = latest_valid_checkpoint(ckpt_dir) \
            if resume and ckpt_dir else None
        if restore_from:
            bs = self._adopt_saved_batch(restore_from, bs)
        self._effective_batch_size = bs
        steps_per_epoch = max(1, (n + bs - 1) // bs)
        total_steps = steps_per_epoch * cfg.epochs

        state = self.init_state((1,) + x.shape[1:], total_steps,
                                initial_bundle, input_dtype=x.dtype)
        base_step = skip_until = int(state.step)
        if restore_from:
            with trace_span("checkpoint.restore", cat="checkpoint",
                            ckpt_dir=ckpt_dir):
                state = self._restore_path(state, restore_from)
            skip_until = int(state.step)
            trace_event("train.resume", cat="resilience", step=skip_until,
                        ckpt_dir=ckpt_dir,
                        skipped_steps=skip_until - base_step)
            get_logger("train").info(
                "resuming from checkpoint at step %d (skipping %d "
                "completed steps)", skip_until, skip_until - base_step)
        step_fn = self.make_train_step()
        rng = np.random.default_rng(
            cfg.seed if not cfg.rng_fold else [cfg.seed, int(cfg.rng_fold)])
        t0 = monotonic()
        emit = log_fn if log_fn is not None else _LOG.info
        chaos = get_injector()
        tracer = active_tracer()
        run = active_run()
        fit_span = tracer.span(
            "train.fit", parent=current_span_id(), cat="phase",
            architecture=cfg.architecture, total_steps=total_steps,
            batch_size=bs, resume_from=skip_until - base_step or 0,
        ) if tracer is not None else None
        fit_id = fit_span.span_id if fit_span is not None else None
        cadence = max(0, int(cfg.numerics_cadence))
        detector = LossSpikeDetector() if cadence else None
        self.last_health = None
        windows = [(int(a), int(b)) for a, b in (skip_data_windows or [])]
        watchdog = StepWatchdog(cfg.step_timeout_s) \
            if cfg.step_timeout_s else None
        feed = DeviceFeed(self.device)
        timings = active_timings()   # captured HERE: workers have no context

        def plan():
            # pulled on the dispatch thread (the map stage tops up there),
            # so the orders are drawn in the same sequence at every depth
            step_c = base_step
            for epoch in range(cfg.epochs):
                order = epoch_order(rng, epoch, n, n_local,
                                    cfg.shuffle_each_epoch)
                for start in range(0, n, bs):
                    if step_c >= skip_until:
                        skipped = any(a <= step_c <= b for a, b in windows)
                        yield epoch, step_c, None if skipped else order, \
                            start
                    step_c += 1

        def stage(item):
            # on a staging worker: the gather, the mask, the pinned
            # buffers and the copies to the card (a skip window's marker
            # stages nothing)
            epoch, step_c, order, start = item
            if order is None:
                return epoch, step_c, None
            with span_on_tracer(tracer, "train.stage", parent=fit_id,
                                cat="stage", step=step_c):
                with span_on(timings, "host"):
                    idx = order[start:start + bs]
                    valid = len(idx)
                    if valid < bs:
                        # cycle rows of the order into the pad, masked out
                        idx = np.concatenate([idx,
                                              np.resize(order, bs - valid)])
                    mask = np.zeros(bs, np.float32)
                    mask[:valid] = 1.0
                    hosts = [feed.stage(host_batch(a), bs)
                             for a in (x[idx], y[idx], mask)]
                with span_on(timings, "transfer"):
                    return epoch, step_c, [feed.put(h) for h in hosts]

        losses, norms, sown = [], [], []
        cur_epoch: Optional[int] = None

        def finish_epoch():
            # one device->host fetch per epoch, never per step
            if cur_epoch is None or not losses:
                return
            keys = list(sown[0]) if sown else []
            fetched = torch.stack(losses + norms + [
                m[key] for m in sown for key in keys]).cpu().numpy()
            n = len(losses)
            rec = {"epoch": cur_epoch,
                   "loss": float(np.sum(fetched[:n])) / max(n, 1),
                   "wall_s": monotonic() - t0,
                   "grad_norm": float(np.mean(fetched[n:2 * n]))}
            # model-sown diagnostics (the MoE overflow fraction) averaged
            # over the epoch's steps, one history column each
            per_step = fetched[2 * n:].reshape(n, len(keys))
            for i, key in enumerate(keys):
                rec[key] = float(np.mean(per_step[:, i]))
            self.history.append(rec)
            if cur_epoch % max(1, log_every) == 0 \
                    or cur_epoch == cfg.epochs - 1:
                emit(f"epoch {cur_epoch}: loss={rec['loss']:.5f} "
                     f"({rec['wall_s']:.1f}s)")

        exec_count = 0
        # orders a watched worker's launch against the watchdog giving up
        # on it: a step is either abandoned before it launches or recorded
        # here as launched
        launch_gate, launched = threading.Lock(), [None]
        # NO `prefetch` op below the plan: its pulls stay on this thread
        staged = (Dataset.from_iterable(plan)
                  .map(stage, name="train", depth=cfg.prefetch_depth,
                       span=None)
                  .iterator())
        with PreemptionGuard(install=bool(ckpt_dir)) as guard:
            try:
                for epoch, step_c, batch in staged:
                    if epoch != cur_epoch:
                        finish_epoch()
                        cur_epoch = epoch
                        losses, norms, sown = [], [], []
                    if batch is None:
                        # a skip window: the step number advances, no
                        # data is staged and no update runs
                        state.step += 1
                        inc_counter("train.skipped_steps")
                        trace_event("train.step_skipped", cat="resilience",
                                    step=step_c, epoch=epoch)
                        continue
                    xb, yb, mask_d = (feed.ready(*b) for b in batch)
                    chaos.on_step(step_c)  # may deliver a simulated SIGTERM
                    if chaos.poison_nan(step_c):
                        mask_d = mask_d * float("nan")
                    probe_now = bool(cadence) and step_c % cadence == 0
                    # the watchdog arms from the third executed step (the
                    # first two pay kernel builds and allocator warm-up)
                    dog = watchdog if exec_count >= 2 else None

                    def exec_step(dog=dog, step=step_c,
                                  args=(xb, yb, mask_d, probe_now)):
                        chaos.maybe_hang(step)
                        with launch_gate:
                            if dog is not None and dog.abandoned.is_set():
                                return None   # the watchdog gave up on it
                            launched[0] = step
                        out = step_fn(state, *args)
                        if dog is not None:
                            self._sync()
                        return out

                    if dog is None:
                        run_step = exec_step
                    else:
                        def run_step(dog=dog, step=step_c):
                            return dog.run(exec_step, step=step,
                                           ckpt_dir=ckpt_dir)
                    if tracer is None:
                        with span_on(timings, "compute"):
                            loss, metrics = run_step()
                    else:
                        with tracer.span("train.step", parent=fit_id,
                                         cat="step", step=step_c,
                                         epoch=epoch) as sp, \
                                span_on(timings, "compute"):
                            loss, metrics = run_step()
                            sp.attrs["loss"] = float(loss)
                            sp.attrs["grad_norm"] = float(
                                metrics["grad_norm"])
                    exec_count += 1
                    health = metrics.pop("health", None)
                    losses.append(loss)
                    norms.append(metrics.pop("grad_norm"))
                    if metrics:
                        sown.append(metrics)
                    if probe_now and health is not None:
                        # may raise BEFORE the step-boundary checkpoint, so
                        # a poisoned state never rotates over the last
                        # finite one
                        self._numerics_check(step_c, loss, health,
                                             detector, run, ckpt_dir)
                    step = step_c + 1
                    if ckpt_dir and cfg.checkpoint_every_steps and \
                            step % cfg.checkpoint_every_steps == 0:
                        self.save_checkpoint(
                            state, ckpt_dir, step=step,
                            sync=not cfg.async_checkpointing)
                    if guard.triggered:
                        # the emergency save is a barrier: durable before
                        # the process exits in its grace window
                        self.save_checkpoint(state, ckpt_dir, step=step,
                                             sync=True)
                        self._last_state = state
                        trace_event("train.preempted", cat="resilience",
                                    step=step, ckpt_dir=ckpt_dir)
                        raise Preempted(step=step, ckpt_dir=ckpt_dir)
                finish_epoch()
            except HungStepError as e:
                with launch_gate:
                    started = launched[0] == e.step
                if started:
                    # the abandoned worker may still be updating the
                    # params, moments and BatchNorm statistics in place: a
                    # copy now could mix old and new leaves, so recovery
                    # takes the last periodic checkpoint
                    get_logger("train").warning(
                        "hung step %d had launched; no emergency "
                        "checkpoint", e.step)
                    trace_event("train.hung_step_no_checkpoint",
                                cat="resilience", step=e.step)
                elif ckpt_dir:
                    # the hung step never launched, so `state` is the
                    # last completed boundary: checkpoint it, best effort
                    try:
                        path = self.save_checkpoint(state, ckpt_dir,
                                                    sync=True)
                        trace_event("train.hung_step_checkpoint",
                                    cat="resilience", path=path)
                    except Exception as err:
                        get_logger("train").warning(
                            "emergency checkpoint after hung step "
                            "failed: %s", err)
                raise
            finally:
                # the staging stage's counters (deliveries, stalls: the
                # dispatch thread's waits on unfinished batches), kept
                # for inspection
                self.last_staging = staged.stage("train").runner.stats()
                staged.close()
                self._close_writers()
                if fit_span is not None:
                    fit_span.finish()
        if ckpt_dir:
            self.save_checkpoint(state, ckpt_dir, sync=True)
            self._close_writers()
        # the run's loss curve through the typed contract
        self.training_metric_data().log("train", "debug")
        self._last_state = state
        return self.bundle_from_state(state)

    def _adopt_saved_batch(self, path: str, bs: int) -> int:
        """The one-card half of elastic resume: a checkpoint's `.meta.json`
        names the effective batch size it was written under; adopt it so
        the step numbering and data order replay identically."""
        saved = checkpoint_meta(path) or {}
        saved_bs = int(saved.get("effective_batch_size") or 0)
        saved_dp = int(saved.get("data_devices") or 0)
        saved_mp = int(saved.get("model_devices") or 0)
        if (saved_dp and saved_dp != 1) or saved_mp > 1:
            trace_event("train.elastic_resume", cat="resilience",
                        saved_dp=saved_dp, dp=1, saved_mp=saved_mp or 1,
                        mp=1, saved_batch=saved_bs or bs, batch=bs)
            inc_counter("train.elastic_resumes")
            get_logger("train").info(
                "elastic resume: checkpoint written under dp=%d x mp=%d, "
                "restoring onto one card", saved_dp, saved_mp or 1)
        if saved_bs and saved_bs != bs:
            get_logger("train").info(
                "elastic resume: adopting the checkpoint's effective batch "
                "size %d (config %d) so data order replays identically",
                saved_bs, bs)
            return saved_bs
        return bs

    def _numerics_check(self, step: int, loss, health: dict, detector,
                        run, ckpt_dir: Optional[str]) -> None:
        """One probe step's health pass: fetch the probe's scalars (one
        copy), feed the loss-spike detector, emit the `numerics.*`
        events, and with halt_on_nonfinite / halt_on_divergence raise
        before any checkpoint write."""
        fetched = fetch_health({**health, "loss": loss})
        loss_val = fetched.pop("loss")
        self.last_health = {"step": step, "loss": loss_val, **fetched}
        nonfinite = (fetched.get("nonfinite_params", 0.0)
                     + fetched.get("nonfinite_grads", 0.0)
                     + fetched.get("nonfinite_acts", 0.0)
                     + (0.0 if np.isfinite(loss_val) else 1.0))
        verdict = detector.update(loss_val) if detector is not None \
            else "ok"
        if run is not None:
            for key, value in fetched.items():
                run.gauge(f"numerics.{key}", value, step=step)
        trace_event("numerics.probe", cat="numerics", step=step,
                    loss=loss_val, verdict=verdict,
                    nonfinite_elements=nonfinite)
        if nonfinite:
            inc_counter("numerics.nonfinite_probes")
            trace_event("numerics.nonfinite", cat="resilience", step=step,
                        loss=loss_val, nonfinite_elements=nonfinite,
                        halting=bool(self.config.halt_on_nonfinite))
            get_logger("train").warning(
                "numerics: non-finite training state at step %d "
                "(%g element(s), loss=%g)", step, nonfinite, loss_val)
            if self.config.halt_on_nonfinite:
                raise NonFiniteError(
                    step, f"{nonfinite:g} non-finite element(s), "
                          f"loss={loss_val:g}", ckpt_dir)
        elif verdict in ("spike", "divergence"):
            inc_counter(f"numerics.loss_{verdict}")
            trace_event(f"numerics.loss_{verdict}", cat="resilience",
                        step=step, loss=loss_val,
                        threshold=detector.threshold())
            get_logger("train").warning(
                "numerics: loss %s at step %d (loss=%g, threshold=%g)",
                verdict, step, loss_val, detector.threshold())
            if verdict == "divergence" and self.config.halt_on_divergence:
                raise DivergenceError(step, loss_val,
                                      detector.threshold(), ckpt_dir)

    def training_metric_data(self) -> MetricData:
        """This trainer's history as a typed metric table (epoch, loss,
        wall_s and any other history column, e.g. grad_norm)."""
        extras = sorted({k for r in self.history for k in r}
                        - {"epoch", "loss", "wall_s"})
        cols = {key: [r.get(key, float("nan")) for r in self.history]
                for key in ("epoch", "loss", "wall_s", *extras)}
        return MetricData.create_table(cols, "training",
                                       self.config.architecture)

    def bundle_from_state(self, state: TrainState) -> ModelBundle:
        """The trained bundle (parameters, and the BatchNorm statistics as
        `batch_stats`); metadata records the step and the partition
        layout (rules and a {data: 1, model: 1} mesh) as the JAX Trainer
        does."""
        rules = self.config.partition_rules or DEFAULT_RULES
        metadata = {
            "steps": int(state.step),
            "partition": {"rules": rules_to_json(rules),
                          "mesh": {"data": 1, "model": 1}},
        }
        return ModelBundle.from_module(self.module, metadata)

    # -- checkpoint / resume ----------------------------------------------
    def state_tree(self, state: TrainState, to: str = "numpy") -> dict:
        """The checkpoint tree of the JAX Trainer (`{"batch_stats": flax's
        statistics tree ({} without BatchNorm), "opt_state": optax's
        state, "params": the flax tree, "step"}`), leaves as
        `named_tree`'s `to` says."""
        return {"batch_stats": stats_tree(self._stat_names,
                                          state.batch_stats, to=to),
                "opt_state": opt_state_to_jax(state.opt_state, self._names,
                                              to=to),
                "params": named_tree(self._names, state.params, to=to),
                "step": np.asarray(int(state.step), np.int32)}

    def _writer_for(self, ckpt_dir: str) -> CheckpointWriter:
        writer = self._writers.get(ckpt_dir)
        if writer is None:
            writer = self._writers[ckpt_dir] = CheckpointWriter(ckpt_dir)
        return writer

    def _close_writers(self) -> None:
        """Drain and stop every checkpoint writer (best effort: a failed
        write was surfaced at its submit/drain)."""
        for writer in self._writers.values():
            writer.close(best_effort=True)
        self._writers.clear()

    def _ckpt_meta(self, step: int) -> dict:
        """The `.meta.json` sidecar: the topology and effective batch size
        this checkpoint was written under, the JAX Trainer's keys."""
        return {"step": int(step), "data_devices": 1, "model_devices": 1,
                "process_count": 1,
                "effective_batch_size": self._effective_batch_size,
                "seed": int(self.config.seed),
                "rng_fold": int(self.config.rng_fold), "format": 1}

    def save_checkpoint(self, state: TrainState, ckpt_dir: str, *,
                        step: Optional[int] = None,
                        sync: bool = True) -> str:
        """Write one rotation checkpoint.  The state is copied on its
        device first (in JAX layout: Dense kernels transposed), so the
        next step's in-place update cannot reach a pending write;
        `sync=False` returns once the copy is queued and the background
        writer has it (the copy to the host, serialization and the disk
        happen on the writer thread), `sync=True` drains first."""
        with trace_span("checkpoint.save", cat="checkpoint", sync=sync):
            step = int(state.step) if step is None else int(step)
            snapshot = self.state_tree(state, to="device")
            return self._writer_for(ckpt_dir).submit(
                step, snapshot, meta=self._ckpt_meta(step), sync=sync)

    def restore_checkpoint(self, state: TrainState,
                           ckpt_dir: str) -> TrainState:
        """Restore from the newest VALID checkpoint in `ckpt_dir` (torn or
        corrupt files skipped by checksum, the legacy single file
        accepted) into the live parameters (in place) and a new optimizer
        state, and the BatchNorm statistics into their buffers.  A
        checkpoint of another optimizer chain, or of another tree (a
        pipeline-stage checkpoint's stacked blocks), raises ValueError."""
        with trace_span("checkpoint.restore", cat="checkpoint",
                        ckpt_dir=ckpt_dir):
            path = latest_valid_checkpoint(ckpt_dir)
            if path is None:
                raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
            return self._restore_path(state, path)

    def _restore_path(self, state: TrainState, path: str) -> TrainState:
        restored = read_checkpoint(self.state_tree(state, to="view"), path)
        opt_state = opt_state_from_jax(restored["opt_state"], self._names,
                                       device=self.device)
        if opt_state["layout"] != state.opt_state["layout"]:
            raise ValueError(
                f"checkpoint {path} holds another optimizer chain's state "
                f"than {self.config.optimizer!r} with this config's clip, "
                "weight decay and schedule")
        named = variables_from_jax({"params": restored["params"],
                                    "batch_stats": restored["batch_stats"]})
        with torch.no_grad():
            for name, t in zip(self._names + self._stat_names,
                               state.params + state.batch_stats):
                t.copy_(named[name])
        return TrainState(step=int(np.asarray(restored["step"])),
                          params=state.params, opt_state=opt_state,
                          batch_stats=state.batch_stats)
