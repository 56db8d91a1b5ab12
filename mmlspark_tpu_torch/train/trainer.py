"""The Trainer: the port of `mmlspark_tpu/train/trainer.py`
(`_make_loss` :157-179, `_epoch_order` :197-208, `Trainer` :211-312,
:367-442, `fit_arrays` :445-927, `_numerics_check` :929-987,
`training_metric_data` :978-986, `bundle_from_state` :988-1022,
`_ckpt_meta` :1040-1060, `save_checkpoint` / `restore_checkpoint`
:1062-1170) for every registered architecture: the
`TransformerLM` and the scoring models (`MLPClassifier`, `LinearModel`,
`ConvNetCIFAR10`, `ResNet`), the path of MMLSpark's CNTKLearner, on
one card or data-parallel over a `Mesh` with a data axis (and a model
and a seq axis).

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

Data parallelism (`Trainer(config, mesh=...)` or a `TrainerConfig.mesh`
with data > 1; the JAX Trainer's topology, which replaces the
reference's `mpiexec` ring), under the port's single controller
(`parallel/mesh.py`):

  * the batch size clamps to `max(bs - bs % data, data)`; the global
    batch is gathered, padded by cycling rows and masked exactly as on
    one card, then cut into `data` contiguous slabs, slab i staged on
    shard i's device (one `DeviceFeed` per distinct device);
  * each shard runs its forward and backward on its slab with its own
    replica of the module (`parallel/bridge.py` `ShardReplicas`: on a
    device of its own a copy of the masters, sharing storage where
    shards share a device), the loss's denominator the GLOBAL mask
    count; a MoE's sown losses and metrics are averaged over the
    shards; a training BatchNorm takes the global batch's statistics
    (the shards then run in lockstep, `parallel/ring.py` `ShardGroup`);
  * the gradients are summed onto the masters' device in shard order
    (`reduce_to_home`); clipping, `grad_norm`, the numerics probe and
    the optimizer run once there; the new values reach every other
    distinct device;
  * checkpoints hold the one copy, recording `data_devices` and the
    bundle's partition mesh `{"data": data, "model": 1}` as the JAX
    Trainer does; a restore onto another data width is byte-identical
    (the elastic resume), and a saved effective batch size that does
    not divide into the new data axis raises the JAX Trainer's
    `ValueError`.

Tensor and expert parallelism (a mesh with model > 1, e.g.
`MeshSpec(data=d, model=m)`):

  * the parameters are placed by the JAX Trainer's `_param_sharding_rule`
    (`parallel/partition.py` `param_sharding_rule` over the config's
    `tensor_parallel`, `expert_parallel` and `partition_rules`: the
    registry's Megatron split, expert stacks over 'model', the fallback
    that splits a wide kernel's last dim); each data row keeps a home
    replica with the replicated leaves and one replica per model index
    with that index's slices (`parallel/bridge.py` `ModelShardReplicas`);
  * each data row's forward and backward runs over its model group
    (`models/definitions.py`: per-shard heads through the flash kernels,
    row-parallel sums on the home, column-parallel outputs joined); the
    gradients are reduced over the data rows in row order for each model
    index, joined into the masters' full gradient, and clipping,
    `grad_norm` (each leaf counted once), the numerics probe and the
    optimizer run once, on the masters (whole, on the mesh's first
    device), whose new values go back into every slice;
  * checkpoints and bundles hold the gathered full tree (restores cross
    dp <-> dp x mp byte-identically), recording `model_devices` and the
    partition mesh `{"data": d, "model": m}`.

A seq axis (e.g. `MeshSpec(data=d, model=m, seq=s)`) replicates the
batch, as the JAX Trainer's `P('data')` batch sharding does
(`mmlspark_tpu/train/trainer.py:622`): each (data, model) group computes
once, at seq index 0 (`parallel/mesh.py` `batch_devices`, `model_group`),
and the devices at seq index > 0 hold no replica and launch nothing; the
JAX step computes the same replicated batch on every seq index, so the
results are the port's over data d x model m, bit for bit.  The data
width (`data_size`, the shards, the BatchNorm all-sum, the MoE groups,
the sums over processes) counts data shards only, and checkpoints and
bundles record `data_devices`, `model_devices` and the partition mesh
`{"data", "model"}` as the JAX Trainer writes them (a resume across seq
widths is an ordinary resume).  A sequence-sharded model raises
(`refuse_seq_sharded`): it trains through
`parallel.ring.make_seq_parallel_lm_step`.

Pipeline stages (`pipeline_stages > 1`, a `TransformerLM` with dense
attention and MLP over a (data, stages) mesh: the stage axis is 'model'):

  * the parameters are the pipeline's stacked tree (`parallel/pipeline.py`),
    each stage's block layers, and their optimizer moments, on the stage's
    device, the embeddings on the first stage's and the head on the
    last's; a warm start stacks an ordinary `TransformerLM` bundle;
  * the step runs each data row's slab through the GPipe schedule over
    its model group (`pipeline_row_logits`), `pipeline_microbatches`
    microbatches a row; the batch clamps to a multiple of data x
    microbatches; `grad_norm` and clipping add each device's part;
  * the numerics cadence and the watchdog are off, as in the JAX Trainer;
  * checkpoints hold the stacked tree and its optimizer state (the JAX
    Trainer's bytes for the same state); a resume onto another stage count
    raises; the bundle is unstacked into an ordinary `TransformerLM`
    bundle that `TPUModel` scores.

Several processes (`parallel/distributed.py`, the knobs
MMLSPARK_TPU_COORDINATOR, _NUM_PROCESSES, _PROCESS_ID): `__init__`
joins the process group before the mesh is built, and with no mesh given
the mesh spans every process (`parallel/mesh.py` `make_process_mesh`).
`fit_arrays` takes this process's partition: each process feeds
`batch_size / process_count` rows a step onto its own block of the data
axis, every epoch takes the smallest partition's row count (the
partition sizes are all-gathered; surplus rows rotate into later epochs
through `epoch_order`), and the seed is `seed + process_index()`.  The
step all-reduces the mask count, the loss, the metrics and the locally
summed gradients over the processes, and one identical optimizer update
runs in each, so every process holds the whole masters.  The checkpoint
flags must agree on every process; the coordinator decides a resume and
broadcasts it; a preemption flag is all-gathered before the emergency
save; only the coordinator writes checkpoints, and a restore is read by
the coordinator and broadcast (the BatchNorm statistics with the
parameters).  A training BatchNorm takes the global batch's statistics:
`ShardGroup.all_sum` adds each process's shard sums over the processes
(`parallel/ring.py` `process_sum`, a differentiable all-reduce inside
`run_collective`, called in the same layer order on every process and
the reverse in the backward), after the local shard sum, the order of
`_sum_over_processes`.  Each process's shard 0 moves its running
statistics with the same global values, so every process ends with the
same `batch_stats`; the coordinator's are the ones its checkpoints
write.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.device import exact_f32, resolve_device
from mmlspark_tpu_torch.data import Dataset
from mmlspark_tpu_torch.data.snapshot import (set_restore_offsets,
                                             snapshot_offsets)
from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_variables,
                                              params_from_jax,
                                              variables_from_jax)
from mmlspark_tpu_torch.models.definitions import (SEQ_IMPLS, BatchNorm,
                                                   build_model,
                                                   init_scoring_params,
                                                   init_transformer_lm_params,
                                                   model_config)
from mmlspark_tpu_torch.observe.costmodel import ProgramCosts
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
from mmlspark_tpu_torch.parallel.bridge import (DeviceFeed,
                                                ModelShardReplicas,
                                                ShardReplicas)
from mmlspark_tpu_torch.parallel.distributed import (
    all_reduce_sum, barrier, broadcast_one_to_all, initialize_distributed,
    is_coordinator, process_allgather, process_count, process_index,
    run_collective, sync_all)
from mmlspark_tpu_torch.parallel.mesh import (MODEL_AXIS, batch_devices,
                                              distinct_devices, mesh_for_spec)
from mmlspark_tpu_torch.parallel.partition import (DEFAULT_RULES,
                                                   param_sharding_rule,
                                                   port_splits, rules_to_json)
from mmlspark_tpu_torch.parallel.ring import ShardGroup, reduce_to_home
from mmlspark_tpu_torch.resilience.chaos import get_injector
from mmlspark_tpu_torch.resilience.checkpoints import (
    checkpoint_meta, checkpoint_name, latest_valid_checkpoint)
from mmlspark_tpu_torch.resilience.ckpt_writer import (CheckpointWriter,
                                                       read_checkpoint)
from mmlspark_tpu_torch.resilience.preemption import (HungStepError,
                                                      Preempted,
                                                      PreemptionGuard,
                                                      StepWatchdog)
from mmlspark_tpu_torch.train.config import TrainerConfig
from mmlspark_tpu_torch.train.optim import (Optimizer, global_norm,
                                            named_tree,
                                            opt_state_from_jax,
                                            opt_state_to_jax, stats_tree)

_LOG = logging.getLogger("mmlspark_tpu_torch.train")


def make_loss(kind: str) -> Callable:
    """The JAX `_make_loss`: a per-row loss (mean over any trailing axes)
    averaged over the rows whose mask is 1.  `denom` replaces the mask's
    own count (a data shard's loss over the global batch's count)."""
    def loss_fn(logits, labels, mask, denom=None):
        mask = mask.float()
        if denom is None:
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


def _global_count(masks: Sequence) -> torch.Tensor:
    """The batch's mask count (the loss's denominator) over every shard
    of every process."""
    count = reduce_to_home([m.float().sum() for m in masks])
    return all_reduce_sum([count])[0]


def _sum_over_processes(grads: list, loss: torch.Tensor,
                        sums: dict) -> tuple:
    """The locally summed gradients (in place), the loss and the metric
    sums added over the processes in one collective; (loss, sums) come
    back detached.  With one process nothing moves."""
    if process_count() == 1:
        return loss, sums
    extra = [loss.detach().clone()] + [v.detach().clone()
                                       for v in sums.values()]
    all_reduce_sum(list(grads) + extra)
    return extra[0], dict(zip(sums, extra[1:]))


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


def refuse_seq_sharded(config: TrainerConfig, what: str) -> None:
    """A sequence-sharded model (a TransformerLM with `attn_impl` ring |
    ring_flash | ulysses and a `seq_axis`) raises ValueError before any
    work, whatever the mesh: the Trainer's step replicates the batch over
    'seq', and such a model trains through
    `parallel.ring.make_seq_parallel_lm_step`.  The JAX Trainer and sweep
    refuse it too, with a NameError from `jax.lax.axis_index` outside any
    `shard_map` (`mmlspark_tpu/models/definitions.py:324-325`)."""
    mc = config.model_config or {}
    if config.architecture == "TransformerLM" and \
            mc.get("attn_impl") in SEQ_IMPLS and mc.get("seq_axis"):
        raise ValueError(
            f"{what} runs a sequence-sharded model (attn_impl "
            f"{mc['attn_impl']!r}, seq_axis {mc['seq_axis']!r}) unsharded: "
            "train it with parallel.ring.make_seq_parallel_lm_step, or "
            "pick attn_impl 'dense' or 'flash' (a mesh's seq axis then "
            "replicates the batch)")


class Trainer:
    """Drives the training loop for one model on one card, or
    data-parallel over a mesh's data axis (module docstring)."""

    def __init__(self, config: TrainerConfig, mesh=None, device="cuda"):
        refuse_seq_sharded(config, "the Trainer")
        # torch.distributed from the knobs when launched as several
        # processes (a no-op with one); before the mesh, so that it spans
        # every process
        initialize_distributed(
            device=device if mesh is None else mesh.devices.flat[0])
        if mesh is None:
            device = resolve_device(device)
            mesh = mesh_for_spec(config.mesh, device)
        self.config = config
        self.mesh = mesh
        # the model axis: how many shards each leaf the placement splits
        # is cut into
        self.model_size = 1 if mesh is None else mesh.shape[MODEL_AXIS]
        # {port leaf name: (dim, groups)} of the split leaves (set with
        # the state)
        self.param_splits: dict = {}
        # shard i's device (one entry on one card); the masters live on
        # the first
        self.shard_devices = ([resolve_device(device)] if mesh is None
                              else batch_devices(mesh))
        self.device = self.shard_devices[0]
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
        # the train step's cost rows by batch shape class (counted over a
        # class's first step under a run, replayed into later runs)
        self._costs = ProgramCosts("trainer")
        self._effective_batch_size: Optional[int] = None
        # each shard's replica of the module (built with the state) and
        # their runner; a training BatchNorm needs them in lockstep
        self._replicas = None
        self._group = ShardGroup(len(self.shard_devices))
        self._lockstep = bool(self._stat_names)
        # pipeline stages: the placed stacked tree (set with the state)
        self._pp = config.pipeline_stages > 1
        self._pp_params: Optional[dict] = None
        self._rows_seen: Optional[np.ndarray] = None
        if self._pp:
            self._validate_pipeline()

    def _validate_pipeline(self) -> None:
        """The JAX Trainer's pipeline preconditions, checked at
        construction."""
        cfg = self.config
        if cfg.architecture != "TransformerLM":
            raise ValueError(
                "pipeline_stages > 1 supports architecture='TransformerLM' "
                f"(got {cfg.architecture!r}); the stage schedule partitions "
                "a transformer block stack")
        m = self.module
        attn_impl = m.config["attn_impl"]
        if attn_impl != "dense" or m.mlp_impl != "dense":
            raise ValueError(
                "pipeline training runs dense transformer blocks; compose "
                "long-context/MoE via attn_impl/mlp_impl WITHOUT "
                "pipeline_stages, or keep the pipelined model dense "
                f"(got attn_impl={attn_impl!r}, mlp_impl={m.mlp_impl!r})")
        if m.remat and m.remat_policy != "full":
            raise ValueError(
                "pipeline training supports remat_policy='full' only (the "
                "stage scan checkpoints whole layers); got "
                f"remat_policy={m.remat_policy!r}")
        stages = self.model_size
        if stages != cfg.pipeline_stages:
            raise ValueError(
                f"pipeline_stages={cfg.pipeline_stages} must equal the "
                f"mesh's '{MODEL_AXIS}' axis size ({stages}) — the stage "
                "ring rides that axis")
        if m.n_layers % cfg.pipeline_stages:
            raise ValueError(
                f"n_layers={m.n_layers} must divide evenly into "
                f"pipeline_stages={cfg.pipeline_stages} stages")
        if cfg.pipeline_microbatches < 1:
            raise ValueError("pipeline_microbatches must be >= 1")

    @property
    def data_size(self) -> int:
        """The data axis: how many shards a batch is cut into (this
        process's; a seq axis adds none)."""
        return len(self.shard_devices)

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
        if self._pp:
            return self._init_state_pipelined(initial_bundle)
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
        if self.model_size > 1:
            cfg = self.config
            self.param_splits = port_splits(
                self.module, self.mesh, param_sharding_rule(
                    self.mesh, cfg.tensor_parallel, cfg.expert_parallel,
                    cfg.partition_rules))
            self._replicas = ModelShardReplicas(self.module, self.mesh,
                                                self.param_splits)
        else:
            self._replicas = ShardReplicas(self.module, self.shard_devices)
        params = list(self.module.parameters())
        start = int((initial_bundle.metadata or {}).get("steps", 0)) \
            if initial_bundle is not None else 0
        return TrainState(step=start, params=params,
                          opt_state=self._tx.init(params),
                          batch_stats=[self.module.get_buffer(n)
                                       for n in self._stat_names])

    def _init_state_pipelined(self, initial_bundle) -> TrainState:
        """The state over the pipeline's stacked tree, placed on the
        stages (`parallel/pipeline.py`); a warm start stacks an ordinary
        TransformerLM bundle's blocks."""
        from mmlspark_tpu_torch.parallel.pipeline import (
            init_pipelined_lm, pipeline_leaves, pipeline_param_shardings,
            pipeline_params_from_variables, place_pipeline_params)
        c = self.module.config
        if initial_bundle is not None:
            params = pipeline_params_from_variables(initial_bundle.variables,
                                                    c["n_layers"])
        else:
            params = init_pipelined_lm(
                self.config.seed, vocab_size=c["vocab_size"],
                d_model=c["d_model"], n_heads=c["n_heads"],
                n_layers=c["n_layers"], max_len=c["max_len"],
                mlp_ratio=c["mlp_ratio"])
        self._pp_params = place_pipeline_params(
            params, pipeline_param_shardings(self.mesh, params))
        self._names = list(self._pp_params)
        leaves = pipeline_leaves(self._pp_params)
        for t in leaves:
            t.requires_grad_(True)
        start = int((initial_bundle.metadata or {}).get("steps", 0)) \
            if initial_bundle is not None else 0
        return TrainState(step=start, params=leaves,
                          opt_state=self._tx.init(leaves), batch_stats=[])

    # -- the step -------------------------------------------------------
    def make_train_step(self):
        """`step(state, x, y, mask, probe=False) -> (loss, metrics)`, both
        device tensors: x, y and mask are lists of per-shard slabs (one
        card takes the tensors themselves).  Each shard's forward and
        backward runs on its slab with its own replica, its loss over the
        global mask count; the gradients are summed onto the masters in
        shard order, the optimizer runs once, and the new values reach the
        other devices (module docstring).  The state's parameters,
        optimizer state and BatchNorm statistics are updated in place and
        its step advances.  `metrics` holds `grad_norm` (and a MoE's sown
        metrics), and on a probe step `health` (`tree_health` over the new
        parameters, the gradients, the updates and the logits).

        Under several processes the mask count, the loss, the metrics and
        the locally summed gradients are all-reduced over the processes
        (one collective) before the one identical update each runs."""
        if self._pp:
            return self._make_pipeline_train_step()
        loss_fn, tx, names = self._loss, self._tx, self._names
        scoring, group = self._scoring, self._group
        f32 = self.module.dtype == torch.float32
        aux_w = float(self.config.aux_loss_weight)
        # the global data axis: every process's shards
        n = self.data_size * process_count()

        def train_step(state: TrainState, xs, ys, masks,
                       probe: bool = False):
            if isinstance(xs, torch.Tensor):
                xs, ys, masks = [xs], [ys], [masks]
            replicas = self._replicas
            replicas.zero_grad()
            denom = torch.clamp(_global_count(masks), min=1.0)

            def shard_loss(i):
                module = replicas.shards[i]
                if scoring:
                    logits, sown = module(xs[i])[0], {}
                else:
                    logits, sown = module(xs[i], collect=True)
                loss = loss_fn(logits, ys[i], masks[i],
                               denom=denom.to(logits.device))
                if aux_w:
                    # model-sown auxiliary losses (the MoE load-balance and
                    # z terms, ops/moe.py) join the objective: each shard's
                    # are means over its groups, the global mean is their
                    # mean over the shards
                    loss = loss + (aux_w / n) * sum(
                        sown_leaves(sown.get("losses", {})))
                return loss, logits.detach(), fold_metrics(
                    sown.get("metrics", {}))

            # a float32 model computes in f32 on the card: TF32 off
            with exact_f32() if f32 else contextlib.nullcontext():
                shards = group.run(shard_loss, lockstep=self._lockstep)
                loss = reduce_to_home([out[0] for out in shards])
                loss.backward()
                grads = replicas.reduced_grads()
                sums = {key: reduce_to_home([out[2][key] for out in shards])
                        for key in shards[0][2]}
                loss, sums = _sum_over_processes(grads, loss, sums)
                updates = tx.update(grads, state.opt_state, state.params,
                                    return_updates=probe)
            replicas.broadcast()
            metrics = {key: value / n for key, value in sums.items()}
            metrics["grad_norm"] = global_norm(grads)
            state.step += 1
            if probe:
                metrics["health"] = tree_health(
                    dict(zip(names, state.params)), dict(zip(names, grads)),
                    dict(zip(names, updates)),
                    acts=[out[1] for out in shards])
            return loss.detach(), metrics

        return train_step

    def _make_pipeline_train_step(self):
        """The step through the pipeline (`parallel/pipeline.py`
        `pipeline_train_step`): each data row's slab through the GPipe
        schedule over its stages, the loss over the global mask count,
        the gradients of each stage's layers on its device summed over
        the processes, one update of the stacked tree's leaves (the
        numerics probe is off under pipeline stages)."""
        from mmlspark_tpu_torch.parallel.pipeline import pipeline_train_step
        loss_fn, tx, cfg, c = self._loss, self._tx, self.config, \
            self.module.config
        f32 = self.module.dtype == torch.float32

        def train_step(state: TrainState, xs, ys, masks,
                       probe: bool = False):
            if isinstance(xs, torch.Tensor):
                xs, ys, masks = [xs], [ys], [masks]
            denom = torch.clamp(_global_count(masks), min=1.0)
            with exact_f32() if f32 else contextlib.nullcontext():
                loss, grads = pipeline_train_step(
                    self.mesh, self._pp_params, tx, state.opt_state, xs, ys,
                    masks, loss_fn, denom, n_heads=c["n_heads"],
                    n_micro=cfg.pipeline_microbatches,
                    mlp_ratio=c["mlp_ratio"], dtype=self.module.dtype,
                    remat=c["remat"],
                    reduce=lambda g, l: _sum_over_processes(g, l, {})[0])
            state.step += 1
            return loss, {"grad_norm": global_norm(grads)}

        return train_step

    def _sync(self) -> None:
        """Wait for the work queued so far on every card of the step (a
        CUDA event's synchronize each: what the watchdog bounds)."""
        for dev in distinct_devices(self.shard_devices):
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
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
        and updates while the step number advances.

        Under several processes `x` / `y` are this process's partition
        (module docstring)."""
        cfg = self.config
        ckpt_dir = ckpt_dir if ckpt_dir is not None else cfg.checkpoint_dir
        n = n_local = len(x)
        nproc = process_count()
        data = self.data_size * nproc   # the global data axis
        if nproc > 1:
            self._check_processes(n_local, ckpt_dir, resume)
            # every process runs the same step count: each epoch feeds the
            # smallest partition's rows, surplus rows rotate in later
            sizes = run_collective("fit.sizes", lambda: process_allgather(
                np.asarray(n_local, np.int64)))
            n = int(sizes.min())
            if n != n_local:
                get_logger("train").warning(
                    "unequal data partitions %s: each epoch uses %d of this "
                    "process's %d rows (lockstep step count); surplus rows "
                    "rotate into later epochs", sizes.tolist(), n, n_local)
        bs = max(cfg.batch_size - cfg.batch_size % data, data)
        if self._pp:
            # each data row's batch splits into whole microbatches
            unit = data * cfg.pipeline_microbatches
            bs = max(bs - bs % unit, unit)
        # the newest valid checkpoint (the coordinator's directory decides),
        # validated once for this fit
        restore_from = latest_valid_checkpoint(ckpt_dir) \
            if resume and ckpt_dir and is_coordinator() else None
        if restore_from:
            bs = self._adopt_saved_batch(restore_from, bs)
        found = restore_from is not None
        if nproc > 1 and resume and ckpt_dir:
            # a restore is a collective: every process follows the
            # coordinator's decision (and the batch size it adopted)
            found, bs = (int(v) for v in run_collective(
                "resume.poll", lambda: broadcast_one_to_all(
                    np.asarray([int(found), bs], np.int64))))
        self._effective_batch_size = bs
        # rows this process feeds a step (data % nproc == 0 and
        # bs % data == 0 give equal whole shares)
        bs_local = bs // nproc
        steps_per_epoch = max(1, (n + bs_local - 1) // bs_local)
        total_steps = steps_per_epoch * cfg.epochs

        state = self.init_state((1,) + x.shape[1:], total_steps,
                                initial_bundle, input_dtype=x.dtype)
        base_step = skip_until = int(state.step)
        if found:
            with trace_span("checkpoint.restore", cat="checkpoint",
                            ckpt_dir=ckpt_dir):
                state = (self._restore_path(state, restore_from)
                         if nproc == 1 else
                         self._restore_broadcast(state, ckpt_dir))
            skip_until = int(state.step)
            trace_event("train.resume", cat="resilience", step=skip_until,
                        ckpt_dir=ckpt_dir,
                        skipped_steps=skip_until - base_step)
            get_logger("train").info(
                "resuming from checkpoint at step %d (skipping %d "
                "completed steps)", skip_until, skip_until - base_step)
        step_fn = self.make_train_step()
        # distinct streams per process, so partitions shuffle independently
        seed = cfg.seed + process_index()
        rng = np.random.default_rng(
            seed if not cfg.rng_fold else [seed, int(cfg.rng_fold)])
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
        # the numerics probe and the watchdog are off under pipeline stages
        cadence = max(0, int(cfg.numerics_cadence)) if not self._pp else 0
        detector = LossSpikeDetector() if cadence else None
        self.last_health = None
        windows = [(int(a), int(b)) for a, b in (skip_data_windows or [])]
        watchdog = StepWatchdog(cfg.step_timeout_s) \
            if cfg.step_timeout_s and not self._pp else None
        self._rows_seen = np.zeros(n_local, bool)   # coverage, inspectable
        feeds = {dev: DeviceFeed(dev)
                 for dev in distinct_devices(self.shard_devices)}
        timings = active_timings()   # captured HERE: workers have no context

        def plan():
            # pulled on the dispatch thread (the map stage tops up there),
            # so the orders are drawn in the same sequence at every depth
            step_c = base_step
            for epoch in range(cfg.epochs):
                order = epoch_order(rng, epoch, n, n_local,
                                    cfg.shuffle_each_epoch)
                self._rows_seen[order] = True
                for start in range(0, n, bs_local):
                    if step_c >= skip_until:
                        skipped = any(a <= step_c <= b for a, b in windows)
                        yield epoch, step_c, None if skipped else order, \
                            start
                    step_c += 1

        def stage(item):
            # on a staging worker: the gather, the mask, the pinned
            # buffers and the copies to the card, one slab per data shard
            # (a skip window's marker stages nothing)
            epoch, step_c, order, start = item
            if order is None:
                return epoch, step_c, None
            with span_on_tracer(tracer, "train.stage", parent=fit_id,
                                cat="stage", step=step_c):
                with span_on(timings, "host"):
                    idx = order[start:start + bs_local]
                    valid = len(idx)
                    if valid < bs_local:
                        # cycle rows of the order into the pad, masked out
                        idx = np.concatenate([
                            idx, np.resize(order, bs_local - valid)])
                    mask = np.zeros(bs_local, np.float32)
                    mask[:valid] = 1.0
                    rows = (x[idx], y[idx], mask)
                    slab = bs_local // self.data_size
                    hosts = [[feeds[dev].stage(
                        host_batch(a[i * slab:(i + 1) * slab]), slab)
                        for a in rows]
                        for i, dev in enumerate(self.shard_devices)]
                with span_on(timings, "transfer"):
                    return epoch, step_c, [
                        [feeds[dev].put(h) for h in shard]
                        for dev, shard in zip(self.shard_devices, hosts)]

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
                    # per shard (x, y, mask), ready on its device
                    parts = [[feeds[dev].ready(*b) for b in shard]
                             for dev, shard in zip(self.shard_devices,
                                                   batch)]
                    xb, yb, mask_d = (list(col) for col in zip(*parts))
                    chaos.on_step(step_c)  # may deliver a simulated SIGTERM
                    if chaos.poison_nan(step_c):
                        mask_d = [m * float("nan") for m in mask_d]
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
                        # the span is synced by the loss fetch, so its wall
                        # is the step's: the roofline joins it directly
                        # ("step_wall"); a new shape class's first step
                        # is counted instead (observe/costmodel.py)
                        # the global batch's shape class
                        key = (f"{(bs,) + tuple(xb[0].shape[1:])}:"
                               f"{str(xb[0].dtype)[6:]}")
                        with self._costs.execution(run, key,
                                                   basis="step_wall"), \
                                tracer.span("train.step", parent=fit_id,
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
                    preempt_now = guard.triggered
                    if nproc > 1:
                        # lockstep: every process agrees before the
                        # collective save
                        preempt_now = bool(run_collective(
                            "preempt.sync", lambda: int(process_allgather(
                                np.asarray(int(guard.triggered))).max())))
                    if preempt_now:
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

    def _check_processes(self, n_local: int, ckpt_dir, resume: bool) -> None:
        """The preconditions of a fit over several processes: the mesh
        spans them all (`make_process_mesh`, which holds the data axis to
        a multiple of their count) and the checkpoint flags (a
        collective) set alike on every process."""
        nproc = process_count()
        spans = 1 if self.mesh is None else self.mesh.process_count
        if spans != nproc:
            raise ValueError(
                f"multi-host training needs a mesh over all {nproc} "
                f"processes (parallel.mesh.make_process_mesh), got one over "
                f"{spans}")
        flags = np.asarray([int(bool(ckpt_dir)),
                            int(self.config.checkpoint_every_steps or 0),
                            int(bool(resume))], np.int64)
        all_flags = run_collective("fit.flags",
                                   lambda: process_allgather(flags))
        if not (all_flags == flags).all():
            raise ValueError(
                "checkpoint_dir/checkpoint_every_steps must be set "
                "consistently on every process (checkpointing is a "
                f"collective); got {all_flags.tolist()}")

    def _adopt_saved_batch(self, path: str, bs: int) -> int:
        """Elastic resume: a checkpoint's `.meta.json` names the topology
        and effective batch size it was written under; adopt the saved
        batch size (when it divides into this data axis) so the step
        numbering and data order replay identically."""
        saved = checkpoint_meta(path) or {}
        # mid-epoch data position saved by snapshot() ops: arm the restore
        # registry so the NEXT build of each tagged pipeline skips the
        # already-consumed prefix
        if saved.get("data_snapshots"):
            set_restore_offsets(saved["data_snapshots"])
        saved_bs = int(saved.get("effective_batch_size") or 0)
        saved_dp = int(saved.get("data_devices") or 0)
        saved_mp = int(saved.get("model_devices") or 0)
        data, mp = self.data_size * process_count(), self.model_size
        if saved_mp and self._pp and saved_mp != mp:
            # the stage ring is not elastic: stage-placed block stacks do
            # not re-partition across another stage count mid-run
            raise ValueError(
                f"checkpoint written under dp={saved_dp or '?'} x "
                f"mp={saved_mp} cannot resume onto the current "
                f"dp={data} x mp={mp} mesh: pipeline "
                f"training requires the same stage count "
                f"(pipeline_stages == '{MODEL_AXIS}' axis size)")
        if saved_dp and (saved_dp != data or (saved_mp and saved_mp != mp)):
            trace_event("train.elastic_resume", cat="resilience",
                        saved_dp=saved_dp, dp=data, saved_mp=saved_mp or 1,
                        mp=mp, saved_batch=saved_bs or bs, batch=bs)
            inc_counter("train.elastic_resumes")
            get_logger("train").info(
                "elastic resume: checkpoint written under dp=%d x mp=%d, "
                "restoring onto dp=%d x mp=%d (reshard-on-restore)",
                saved_dp, saved_mp or 1, data, mp)
        if saved_bs and saved_bs != bs:
            unit = data * (self.config.pipeline_microbatches if self._pp
                           else 1)
            if saved_bs % unit:
                raise ValueError(
                    f"elastic resume: checkpoint written under "
                    f"dp={saved_dp or '?'} x mp={saved_mp or 1} with "
                    f"effective batch size {saved_bs} cannot replay onto "
                    f"the current dp={data} x mp={mp} mesh ({saved_bs} does "
                    f"not divide into the new data-axis unit {unit}); "
                    f"pick a batch_size divisible by both topologies to "
                    f"keep resumed runs reproducible")
            get_logger("train").info(
                "elastic resume: adopting the checkpoint's effective batch "
                "size %d (config clamped to %d) so data order replays "
                "identically", saved_bs, bs)
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
        layout (rules and the {data, model} mesh) as the JAX Trainer
        does."""
        rules = self.config.partition_rules or DEFAULT_RULES
        metadata = {
            "steps": int(state.step),
            "partition": {"rules": rules_to_json(rules),
                          "mesh": {"data": self.data_size * process_count(),
                                   "model": self.model_size}},
        }
        if self._pp:
            # the stacked tree unstacked: an ordinary TransformerLM bundle
            from mmlspark_tpu_torch.parallel.pipeline import (
                variables_from_pipeline_params)
            return ModelBundle(
                "TransformerLM", model_config(self.module),
                variables_from_pipeline_params(
                    self._pp_params, self.module.config["n_layers"]),
                metadata)
        return ModelBundle.from_module(self.module, metadata)

    # -- checkpoint / resume ----------------------------------------------
    def state_tree(self, state: TrainState, to: str = "numpy") -> dict:
        """The checkpoint tree of the JAX Trainer (`{"batch_stats": flax's
        statistics tree ({} without BatchNorm), "opt_state": optax's
        state, "params": the flax tree, "step"}`), leaves as
        `named_tree`'s `to` says.  Under pipeline stages the params are
        the stacked tree and the optimizer state mirrors it, each stage's
        parts joined."""
        if self._pp:
            return self._pipeline_tree(state, to)
        return {"batch_stats": stats_tree(self._stat_names,
                                          state.batch_stats, to=to),
                "opt_state": opt_state_to_jax(state.opt_state, self._names,
                                              to=to),
                "params": named_tree(self._names, state.params, to=to),
                "step": np.asarray(int(state.step), np.int32)}

    def _pipeline_tree(self, state: TrainState, to: str) -> dict:
        from mmlspark_tpu_torch.parallel.pipeline import joined_leaves

        def whole(tensors):
            joined = joined_leaves(self._pp_params, tensors)
            return [joined[n] for n in self._names]
        opt = {k: whole(v) if isinstance(v, list) else v
               for k, v in state.opt_state.items()}
        return {"batch_stats": {},
                "opt_state": opt_state_to_jax(opt, self._names, to=to),
                "params": named_tree(self._names, whole(state.params), to=to),
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
        meta = {"step": int(step),
                "data_devices": self.data_size * process_count(),
                "model_devices": self.model_size,
                "process_count": process_count(),
                "effective_batch_size": self._effective_batch_size,
                "seed": int(self.config.seed),
                "rng_fold": int(self.config.rng_fold), "format": 1}
        # mid-epoch data position: every live snapshot() op's consumed
        # count rides the sidecar, so a resume replays exactly the
        # remaining elements (data/snapshot.py)
        offsets = snapshot_offsets()
        if offsets:
            meta["data_snapshots"] = offsets
        return meta

    def save_checkpoint(self, state: TrainState, ckpt_dir: str, *,
                        step: Optional[int] = None,
                        sync: bool = True) -> str:
        """Write one rotation checkpoint.  The state is copied on its
        device first (in JAX layout: Dense kernels transposed), so the
        next step's in-place update cannot reach a pending write;
        `sync=False` returns once the copy is queued and the background
        writer has it (the copy to the host, serialization and the disk
        happen on the writer thread), `sync=True` drains first.

        Under several processes every process enters the collective
        `checkpoint.gather` (each holds the whole state: nothing crosses)
        and only the coordinator writes."""
        with trace_span("checkpoint.save", cat="checkpoint", sync=sync):
            step = int(state.step) if step is None else int(step)
            if process_count() == 1:
                snapshot = self.state_tree(state, to="device")
            else:
                run_collective("checkpoint.gather", sync_all)
                if not is_coordinator():
                    return os.path.join(ckpt_dir, checkpoint_name(step))
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
        pipeline-stage checkpoint's stacked blocks, into a trainer
        without stages), raises ValueError.  Under several processes the
        coordinator reads the file and broadcasts it (`_restore_broadcast`).
        """
        with trace_span("checkpoint.restore", cat="checkpoint",
                        ckpt_dir=ckpt_dir):
            if process_count() > 1:
                return self._restore_broadcast(state, ckpt_dir)
            path = latest_valid_checkpoint(ckpt_dir)
            if path is None:
                raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
            return self._restore_path(state, path)

    def _restore_broadcast(self, state: TrainState,
                           ckpt_dir: str) -> TrainState:
        """The restore over several processes: all peers meet at a named
        barrier, agree on whether the coordinator's checkpoint is
        readable, and get the coordinator's read by broadcast (no shared
        filesystem needed)."""
        barrier("restore_checkpoint")
        path = latest_valid_checkpoint(ckpt_dir) if is_coordinator() \
            else None
        readable = int(run_collective(
            "restore.readable", lambda: broadcast_one_to_all(
                np.asarray(int(path is not None), np.int32))))
        if not readable:
            raise FileNotFoundError(
                f"coordinator has no valid checkpoint in {ckpt_dir}")
        template = self.state_tree(state, to="numpy")
        host = read_checkpoint(template, path) if is_coordinator() \
            else template
        restored = run_collective("restore.broadcast",
                                  lambda: broadcast_one_to_all(host))
        return self._apply_restored(state, restored, path or ckpt_dir)

    def _restore_path(self, state: TrainState, path: str) -> TrainState:
        restored = read_checkpoint(self.state_tree(state, to="view"), path)
        return self._apply_restored(state, restored, path)

    def _apply_restored(self, state: TrainState, restored: dict,
                        path: str) -> TrainState:
        """A checkpoint's tree into the live parameters (in place), a new
        optimizer state and the BatchNorm buffers."""
        if self._pp:
            return self._apply_restored_pipeline(state, restored, path)
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
        if self._replicas is not None:
            self._replicas.broadcast()
        return TrainState(step=int(np.asarray(restored["step"])),
                          params=state.params, opt_state=opt_state,
                          batch_stats=state.batch_stats)

    def _apply_restored_pipeline(self, state: TrainState, restored: dict,
                                 path: str) -> TrainState:
        from mmlspark_tpu_torch.parallel.pipeline import split_leaves
        opt_state = opt_state_from_jax(restored["opt_state"], self._names)
        if opt_state["layout"] != state.opt_state["layout"]:
            raise ValueError(
                f"checkpoint {path} holds another optimizer chain's state "
                f"than {self.config.optimizer!r} with this config's clip, "
                "weight decay and schedule")
        for key, value in list(opt_state.items()):
            if isinstance(value, list):
                opt_state[key] = split_leaves(self._pp_params,
                                              dict(zip(self._names, value)))
        parts = split_leaves(self._pp_params,
                             params_from_jax(restored["params"]))
        with torch.no_grad():
            for t, value in zip(state.params, parts):
                t.copy_(value)
        return TrainState(step=int(np.asarray(restored["step"])),
                          params=state.params, opt_state=opt_state,
                          batch_stats=[])
