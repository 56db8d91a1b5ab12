"""Population training: N hyperparameter-sweep members stepped together,
the port of `mmlspark_tpu/train/sweep.py`, on one card or over a data
and model mesh.

Every member's parameters, optimizer moments and BatchNorm statistics are
stacked on a leading population axis (N, ...), the shared data batch is
broadcast, and one step advances every member: `torch.func.vmap` over the
member step, which is `torch.func.functional_call` of the model on the
member's tensors, `grad_and_value`, and the Trainer's optax algebra
(`train/optim.py` `Optimizer.updates`) with the member's learning rate as
a tensor.  So the member products run as batched matmuls, and each
member's update is the plain Trainer's arithmetic at its rate: its own
global-norm clip, its own schedule over its base rate.

  * member k's init depends on (seed, k) only, never on N: the port's own
    seeded init (`init_scoring_params` / `init_transformer_lm_params`)
    from the seed sequence [seed, k]; `fit_arrays(member_variables=...)`
    starts from given variables instead (the parity tests carry the JAX
    package's member inits across);
  * successive halving culls trailing members at rung boundaries through
    a per-member `active` mask: the update still runs, and
    `torch.where` keeps a culled member's parameters, moments and
    statistics, so their bytes do not change and nothing is re-stacked;
  * BatchNorm's in-place statistics update cannot run under vmap: the
    training forward runs inside `functional_batch_stats()`
    (`models/definitions.py`), which hands the moved statistics back.

Data order, batch clamping and the loss mask follow `Trainer.fit_arrays`.
A population checkpoint is one file (stacked trees in the flax and optax
layouts with the population axis first, plus `lr` and `active`).

Over a mesh (`mesh=` or a `TrainerConfig.mesh` with data or model > 1)
the members' vmap runs per data shard on that shard's slab, outside the
meshed step, as the JAX sweep has it (`mmlspark_tpu/train/sweep.py:269-323`):

  * each data shard's vmapped `grad_and_value` over its view of the
    stacked parameters, the loss over the global mask count, the members'
    gradients summed onto the home device in shard order
    (`parallel/ring.py` `reduce_to_home`), one vmapped update there;
  * over a model axis each member's stacked leaves are split by the
    Trainer's placement behind the population axis (the JAX
    `_stacked_shardings`, :214-227; `parallel/partition.py`
    `param_sharding_rule` / `port_splits`, `take_slice` one dim further
    in), and the vmap runs over each data row's `ModelShardReplicas` (the
    home and its model shards under one `_ModelRow`, so that
    `functional_call` reaches every replica), the Megatron split inside
    the vmapped forward: the flash operator launches once per model
    shard on its heads for every member (`ops/flash_attention.py`, whose
    vmap rules fold the member axis into the batch axis); a split leaf's
    slices' gradients are summed over the rows and joined in model
    order.  The masters stay whole, so checkpoints and `member_bundle`
    hold the reference layout;
  * a model with BatchNorm over several data shards takes each member's
    statistics over the global batch, as the JAX sweep's jit does.  The
    shards then run in lockstep, each on a thread of its own
    (`ShardGroup.run(lockstep=True)`) with a replica of its own
    (`functional_call` swaps a module's tensors in place, so two threads
    cannot share one).  A functorch wrapper belongs to its thread's
    transform and cannot meet another thread's, so a lockstep step does
    not take `grad_and_value` inside the vmap: each shard runs the
    vmapped forward under ordinary autograd, the stacked parameters as
    leaves, `ShardGroup.all_sum` sees the members' plain (N, C) sums
    through a vmap rule (`parallel/ring.py` `_MemberAllSum`), and one
    `torch.autograd.grad` of the sum of every member's loss over the
    shards' joint graph gives each member its own gradient (members are
    independent).  This keeps the all-sum's plain, differentiable
    tensor moves, which carry each shard's share of the cross-shard
    terms backward as in the Trainer's data step; an all-sum operator
    with a vmap rule and a backward of its own would need the backward
    in lockstep too.  Shard 0's moved statistics are the global batch's;
    a culled member's stay frozen.

A seq axis replicates the batch, as the JAX sweep's `batch_sharding`
does (`mmlspark_tpu/train/sweep.py:357`): the rows run at seq index 0
(`batch_devices`, `model_group`), the devices past it compute nothing,
and `_lockstep` counts data shards.  A population across processes
raises, in both packages (`mmlspark_tpu/train/sweep.py:149-150`), as
does a sequence-sharded model (`train/trainer.py` `refuse_seq_sharded`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad_and_value, vmap

from mmlspark_tpu_torch.config import (SWEEP_CULL_FRACTION,
                                       SWEEP_HALVING_RUNGS,
                                       SWEEP_MIN_ACTIVE)
from mmlspark_tpu_torch.core.device import exact_f32, resolve_device
from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_variables,
                                              params_from_jax,
                                              variables_from_jax)
from mmlspark_tpu_torch.models.definitions import (BatchNorm, build_model,
                                                   functional_batch_stats,
                                                   init_scoring_params,
                                                   init_transformer_lm_params,
                                                   model_config)
from mmlspark_tpu_torch.observe.logging import get_logger
from mmlspark_tpu_torch.observe.spans import active_timings, monotonic, span_on
from mmlspark_tpu_torch.observe.telemetry import active_run
from mmlspark_tpu_torch.observe.trace import active_tracer, current_span_id
from mmlspark_tpu_torch.parallel.bridge import (ModelShardReplicas,
                                                ShardReplicas, stack_trees,
                                                unstack_member)
from mmlspark_tpu_torch.parallel.distributed import process_count
from mmlspark_tpu_torch.parallel.mesh import (MODEL_AXIS, batch_devices,
                                              mesh_for_spec, model_group)
from mmlspark_tpu_torch.parallel.ring import ShardGroup, reduce_to_home
from mmlspark_tpu_torch.parallel.partition import (DEFAULT_RULES,
                                                   join_slices,
                                                   param_sharding_rule,
                                                   port_splits,
                                                   rules_to_json, take_slice)
from mmlspark_tpu_torch.resilience.checkpoints import (checkpoint_name,
                                                       latest_valid_checkpoint)
from mmlspark_tpu_torch.resilience.ckpt_writer import (CheckpointWriter,
                                                       read_checkpoint)
from mmlspark_tpu_torch.train.config import TrainerConfig
from mmlspark_tpu_torch.train.optim import (Optimizer, named_tree,
                                            opt_state_from_jax,
                                            opt_state_to_jax, stats_tree)
from mmlspark_tpu_torch.train.trainer import (Trainer, epoch_order,
                                              host_batch, make_loss,
                                              refuse_seq_sharded, sown_leaves)

_MOMENTS = ("mu", "nu", "trace")


@dataclasses.dataclass
class PopulationState:
    """The stacked training state: the shared step, every member's
    parameters, optimizer state and BatchNorm statistics with a leading
    (N,) axis (lists in the trainer's parameter and statistic order), and
    the per-member learning rates and active mask, (N,) f32."""

    step: int
    params: list
    opt_state: dict
    batch_stats: list
    lr: torch.Tensor
    active: torch.Tensor


@dataclasses.dataclass
class SweepResult:
    """What a population fit returns: the final stacked state, every
    member's loss curve and the winner."""

    state: PopulationState
    member_loss: np.ndarray          # (steps, N) per-step per-member loss
    lrs: np.ndarray                  # (N,) the rates trained at
    active: np.ndarray               # (N,) final mask (1 = survived)
    best_member: int
    _trainer: "PopulationTrainer"

    @property
    def population(self) -> int:
        return int(self.lrs.shape[0])

    def final_losses(self) -> np.ndarray:
        """Each member's final-step training loss (a culled member's is
        the loss its frozen parameters still give)."""
        return self.member_loss[-1]

    def member_bundle(self, k: int) -> ModelBundle:
        return self._trainer.member_bundle(self.state, k)

    def winner_bundle(self) -> ModelBundle:
        return self.member_bundle(self.best_member)


@dataclasses.dataclass
class _Row:
    """One data shard's forward: the module it calls, its leaf entries
    (the module's names for the tensor, the master's index, (dim, groups,
    model index) of a split leaf's slice or None, and the device), its
    BatchNorm statistics' names and modules, and its home device."""

    module: nn.Module
    leaves: list
    stat_keys: list
    norms: list
    device: torch.device


class _ModelRow(nn.Module):
    """A data row's home replica and its model shards under one module,
    so that `functional_call` reaches every replica's tensors; calls the
    home, which runs the model group (`ModelShardReplicas`)."""

    def __init__(self, home: nn.Module, peers: Sequence):
        super().__init__()
        self.home = home
        self.peers = nn.ModuleList(peers)

    def forward(self, *args, **kwargs):
        return self.home(*args, **kwargs)


class PopulationTrainer:
    """Trains a population of sweep members with one vmapped step, on one
    card or over a data and model mesh (module docstring).

    `members` is an int (population size N, every member at the config's
    learning rate) or a sequence of per-member dicts with optional
    `learning_rate` and `seed`.  The data order and batch clamping follow
    `Trainer.fit_arrays`, so a member's steps are the plain Trainer's at
    the same config."""

    def __init__(self, trainer_config: TrainerConfig,
                 members: Union[int, Sequence[dict]], mesh=None,
                 halving_rungs: Optional[int] = None,
                 cull_fraction: Optional[float] = None,
                 min_active: Optional[int] = None, device="cuda"):
        if process_count() > 1:
            # the JAX sweep raises here too (mmlspark_tpu/train/sweep.py:149)
            raise NotImplementedError(
                "population training is single-controller; shard the "
                "candidate grid across hosts, not one population")
        if trainer_config.pipeline_stages > 1:
            raise ValueError(
                "population training does not compose with pipeline "
                "parallelism (the stage ring owns the 'model' axis)")
        refuse_seq_sharded(trainer_config, "population training")
        if mesh is None:
            device = resolve_device(device)
            mesh = mesh_for_spec(trainer_config.mesh, device)
        self.mesh = mesh
        self.shard_devices = ([resolve_device(device)] if mesh is None
                              else batch_devices(mesh))
        self.model_size = 1 if mesh is None else mesh.shape[MODEL_AXIS]
        device = self.shard_devices[0]
        if isinstance(members, int):
            if members < 1:
                raise ValueError("population size must be >= 1")
            members = [{} for _ in range(members)]
        self.members = [dict(m) for m in members]
        if not self.members:
            raise ValueError("population needs at least one member")
        self.config = trainer_config
        self.device = resolve_device(device)
        self.module = build_model(trainer_config.architecture,
                                  trainer_config.model_config,
                                  device=self.device)
        self._scoring = trainer_config.architecture != "TransformerLM"
        self._names = [n for n, _ in self.module.named_parameters()]
        self._norms = [(prefix, mod) for prefix, mod in
                       self.module.named_modules()
                       if isinstance(mod, BatchNorm)]
        self._stat_names = [f"{prefix}.{leaf}" for prefix, _ in self._norms
                            for leaf in ("mean", "var")]
        # a training BatchNorm over several data shards takes the global
        # batch's statistics: the shards then run in lockstep (module
        # docstring)
        self._lockstep = len(self.shard_devices) > 1 and bool(self._norms)
        # {port leaf name: (dim, groups)} of the leaves split over the
        # model axis, and each data shard's forward (set with the state)
        self.param_splits: dict = {}
        self._rows: list = []
        self._loss = make_loss(trainer_config.loss)
        self.halving_rungs = int(SWEEP_HALVING_RUNGS.current()
                                 if halving_rungs is None else halving_rungs)
        self.cull_fraction = float(SWEEP_CULL_FRACTION.current()
                                   if cull_fraction is None
                                   else cull_fraction)
        self.min_active = int(SWEEP_MIN_ACTIVE.current()
                              if min_active is None else min_active)
        if not 0.0 < self.cull_fraction < 1.0:
            raise ValueError("cull_fraction must be in (0, 1)")
        self.history: list[dict] = []
        self._writers: dict[str, CheckpointWriter] = {}
        self._effective_batch_size: Optional[int] = None

    # -- init -----------------------------------------------------------
    @property
    def population(self) -> int:
        return len(self.members)

    def member_lr(self, k: int) -> float:
        return float(self.members[k].get("learning_rate",
                                         self.config.learning_rate))

    def _member_seed(self, k: int) -> int:
        return int(self.members[k].get("seed", self.config.seed))

    def member_init_variables(self, k: int, input_shape: tuple,
                              input_dtype=np.float32) -> dict:
        """Member k's fresh init (flax layout, numpy leaves), seeded by
        [seed_k, k] alone: the tree the population stacks at slot k."""
        seed = [self._member_seed(k), k]
        if self._scoring:
            return init_scoring_params(self.module, tuple(input_shape), seed)
        return init_transformer_lm_params(self.module.config, seed)

    def member_init_bundle(self, k: int, input_shape: tuple,
                           input_dtype=np.float32) -> ModelBundle:
        """Member k's init as a warm-start bundle for a plain Trainer."""
        return ModelBundle(self.config.architecture,
                           model_config(self.module),
                           self.member_init_variables(k, input_shape,
                                                      input_dtype))

    def init_state(self, input_shape: tuple, total_steps: int = 1,
                   input_dtype=np.float32,
                   member_variables: Optional[Sequence[dict]] = None
                   ) -> PopulationState:
        """Stack every member's init (its fresh seeded init, or
        `member_variables[k]`) and a fresh optimizer state onto the card."""
        self._tx = Optimizer(self.config, total_steps)
        n = self.population
        if member_variables is not None and len(member_variables) != n:
            raise ValueError(f"{len(member_variables)} member variables for "
                             f"a population of {n}")
        params, stats = [], []
        for k in range(n):
            variables = (member_variables[k] if member_variables is not None
                         else self.member_init_variables(k, input_shape,
                                                         input_dtype))
            load_variables(self.module, variables)
            params.append([p.detach().clone()
                           for p in self.module.parameters()])
            stats.append([self.module.get_buffer(s).detach().clone()
                          for s in self._stat_names])
        self.module.train()
        self._build_rows()
        opt = self._tx.init(params[0])
        for key in _MOMENTS:
            if key in opt:
                opt[key] = [torch.zeros((n,) + tuple(p.shape),
                                        device=p.device) for p in params[0]]
        return PopulationState(
            step=0, params=[torch.stack(leaves) for leaves in zip(*params)],
            opt_state=opt,
            batch_stats=[torch.stack(leaves) for leaves in zip(*stats)],
            lr=torch.tensor([self.member_lr(k) for k in range(n)],
                            dtype=torch.float32, device=self.device),
            active=torch.ones(n, device=self.device))

    # -- the step -------------------------------------------------------
    def _build_rows(self) -> None:
        """Each data shard's forward and the tensors it reads (module
        docstring): over a model axis the data row's home replica with its
        model shards (`ModelShardReplicas`), whose split leaves are read
        as each model index's slices; in lockstep a replica per shard
        (`ShardReplicas`: `functional_call` swaps a module's tensors in
        place, so two threads cannot share one module); else the module
        itself."""
        names, n = self._names, len(self.shard_devices)
        self._rows = []
        if self.model_size > 1:
            cfg = self.config
            self.param_splits = port_splits(
                self.module, self.mesh, param_sharding_rule(
                    self.mesh, cfg.tensor_parallel, cfg.expert_parallel,
                    cfg.partition_rules))
            replicas = ModelShardReplicas(self.module, self.mesh,
                                          self.param_splits)
            for i, (home, shards) in enumerate(replicas.rows):
                devices = model_group(self.mesh, i)
                peers = [f"peers.{m}." for m in range(self.model_size)]
                leaves = []
                for j, name in enumerate(names):
                    split = replicas.splits.get(name)
                    if split is None:
                        # the home's leaf, which the model shards share
                        leaves.append(((f"home.{name}",) + tuple(
                            p + name for p in peers), j, None, devices[0]))
                    else:
                        leaves += [((peers[m] + name,), j, split + (m,),
                                    dev) for m, dev in enumerate(devices)]
                self._rows.append(_Row(
                    _ModelRow(home, shards), leaves,
                    [f"home.{s}" for s in self._stat_names],
                    [home.get_submodule(p) for p, _ in self._norms],
                    devices[0]))
            return
        shards = (ShardReplicas(self.module, self.shard_devices).shards
                  if self._lockstep else [self.module] * n)
        for module, dev in zip(shards, self.shard_devices):
            self._rows.append(_Row(
                module, [((name,), j, None, dev)
                         for j, name in enumerate(names)],
                list(self._stat_names),
                [module.get_submodule(p) for p, _ in self._norms], dev))

    def _row_tensors(self, row: "_Row", params: list,
                     stats: list) -> tuple:
        """One data shard's view of the stacked (N, ...) tensors: each
        leaf on its device, a split leaf as model index m's slice (the
        Trainer's placement behind the population axis)."""
        tensors = []
        for _, j, split, dev in row.leaves:
            t = params[j]
            if split is not None:
                dim, groups, m = split
                t = take_slice(t, dim + 1, m, self.model_size,
                               groups).to(dev).contiguous()
            tensors.append(t.to(dev))
        return tensors, [t.to(row.device) for t in stats]

    def _joined_grads(self, per_row: list) -> list:
        """Each parameter's (N, ...) gradient on the home device from the
        data shards' gradients (one per leaf entry of a row): summed over
        the shards in shard order (`reduce_to_home`), a split leaf's
        slices each summed so and joined in model order."""
        grads, pos = [], 0
        leaves = self._rows[0].leaves
        while pos < len(leaves):
            split = leaves[pos][2]
            if split is None:
                grads.append(reduce_to_home([g[pos] for g in per_row]))
                pos += 1
                continue
            dim, groups, _ = split
            parts = [reduce_to_home([g[pos + m] for g in per_row])
                     .to(self.device) for m in range(self.model_size)]
            grads.append(join_slices(parts, dim + 1, groups))
            pos += self.model_size
        return grads

    def _forward(self, row: "_Row", tensors: list, stats: list,
                 x: torch.Tensor) -> tuple:
        """(logits, sown) of the row's forward over one member's tensors
        (`tensors` in the row's leaf order, `stats` in statistic order)."""
        named = {key: t for (keys, _, _, _), t in zip(row.leaves, tensors)
                 for key in keys}
        named.update(zip(row.stat_keys, stats))
        # a model row names every key of a tied leaf itself
        tie = not isinstance(row.module, _ModelRow)
        if self._scoring:
            return functional_call(row.module, named, (x,),
                                   tie_weights=tie)[0], {}
        return functional_call(row.module, named, (x,), {"collect": True},
                               tie_weights=tie)

    def make_population_step(self):
        """`step(state, x, y, mask) -> (N,) losses`: x, y and mask are lists
        of per-shard slabs (one card takes the tensors themselves).  Each
        data shard's vmapped `grad_and_value` over its view of the stacked
        parameters on its slab (in lockstep: each shard's vmapped forward
        on a thread of its own, then one `torch.autograd.grad` of the sum
        of every member's loss over the shards' joint graph), the loss
        over the global mask count; the members' gradients summed onto the
        home device in shard order and joined over the model axis; one
        vmapped update there (module docstring).  The state's stacked
        tensors are replaced and its step advances."""
        loss_fn, tx, rows = self._loss, self._tx, self._rows
        aux_w = float(self.config.aux_loss_weight)
        n = len(self.shard_devices)
        lockstep = self._lockstep

        def member_loss(row, tensors, stats, x, y, mask, denom):
            with functional_batch_stats() as moved:
                logits, sown = self._forward(row, tensors, stats, x)
            loss = loss_fn(logits, y, mask, denom=denom)
            if aux_w:
                loss = loss + (aux_w / n) * sum(
                    sown_leaves(sown.get("losses", {})))
            return loss, [t for mod in row.norms for t in moved[mod]]

        def member_grads(row, tensors, stats, x, y, mask, denom):
            grads, (loss, new_stats) = grad_and_value(
                lambda p: member_loss(row, p, stats, x, y, mask, denom),
                has_aux=True)(list(tensors))
            return grads, loss, new_stats

        batched = (0, 0, None, None, None, None)
        shard_fns = [vmap(functools.partial(
            member_loss if lockstep else member_grads, row), in_dims=batched)
            for row in rows]

        def member_update(params, stats, moments, lr, active, grads,
                          new_stats, count):
            opt = {"count": count, **moments}
            updates = tx.updates(grads, opt, params, lr=lr)
            new_params = [p + u for p, u in zip(params, updates)]
            # the halving freeze: a culled member runs the same step and
            # keeps its old tensors, byte for byte
            keep = active > 0

            def freeze(new, old):
                return [torch.where(keep, a, b) for a, b in zip(new, old)]

            return (freeze(new_params, params), freeze(new_stats, stats),
                    {k: freeze(opt[k], moments[k]) for k in moments})

        update = vmap(member_update, in_dims=(0, 0, 0, 0, 0, 0, 0, None))
        group = ShardGroup(n)
        f32 = self.module.dtype == torch.float32

        def lockstep_grads(inputs, xs, ys, masks, denom) -> tuple:
            """The shards' vmapped forwards in lockstep (their BatchNorm
            statistics summed across them) under ordinary autograd, then
            one backward over the joint graph: members are independent,
            so the gradient of the sum is each member's own."""
            leaves = [[t.detach().requires_grad_() for t in tensors]
                      for tensors, _ in inputs]
            outs = group.run(lambda i: shard_fns[i](
                leaves[i], inputs[i][1], xs[i], ys[i], masks[i],
                denom.to(xs[i].device)), lockstep=True)
            flat = torch.autograd.grad(
                reduce_to_home([loss.sum() for loss, _ in outs]),
                [t for row in leaves for t in row])
            per_row, at = [], 0
            for row in leaves:
                per_row.append(list(flat[at:at + len(row)]))
                at += len(row)
            return (per_row, reduce_to_home([loss for loss, _ in outs]),
                    [t.detach() for t in outs[0][1]])

        def population_step(state: PopulationState, xs, ys, masks):
            if isinstance(xs, torch.Tensor):
                xs, ys, masks = [xs], [ys], [masks]
            moments = {k: state.opt_state[k] for k in _MOMENTS
                       if k in state.opt_state}
            denom = torch.clamp(reduce_to_home(
                [m.float().sum() for m in masks]), min=1.0)
            with exact_f32() if f32 else contextlib.nullcontext():
                inputs = [self._row_tensors(row, state.params,
                                            state.batch_stats)
                          for row in rows]
                if lockstep:
                    per_row, losses, new_stats = lockstep_grads(
                        inputs, xs, ys, masks, denom)
                else:
                    # each shard inside `data_shard` (a MoE routes with
                    # the global batch's group size)
                    per_shard = group.run(lambda i: shard_fns[i](
                        inputs[i][0], inputs[i][1], xs[i], ys[i], masks[i],
                        denom.to(xs[i].device)))
                    per_row = [g[0] for g in per_shard]
                    losses = reduce_to_home([g[1] for g in per_shard])
                    # without lockstep BatchNorm runs on one shard only
                    new_stats = per_shard[0][2]
                grads = self._joined_grads(per_row)
                # the moved BatchNorm statistics are shard 0's: the global
                # batch's where the shards run in lockstep
                state.params, state.batch_stats, new_moments = update(
                    state.params, state.batch_stats, moments, state.lr,
                    state.active, grads, [t.to(self.device)
                                          for t in new_stats],
                    state.opt_state["count"])
            state.opt_state.update(new_moments)
            state.opt_state["count"] += 1
            state.step += 1
            return losses.detach()

        return population_step

    # -- scoring --------------------------------------------------------
    def score_population(self, state: PopulationState,
                         x: np.ndarray) -> np.ndarray:
        """Every member's inference logits, (N, rows, ...), from one
        vmapped forward in eval mode; over a data mesh each shard scores
        its slab of the rows (padded to a multiple of the shards), joined
        in row order."""
        def member_apply(row, tensors, stats, xb):
            return self._forward(row, tensors, stats, xb)[0]

        rows = host_batch(np.asarray(x))
        slab = -(-len(rows) // len(self.shard_devices))
        modules = {id(row.module): row.module for row in self._rows}
        for module in modules.values():
            module.eval()
        outs = []
        try:
            with torch.no_grad(), (exact_f32() if self.module.dtype ==
                                   torch.float32 else
                                   contextlib.nullcontext()):
                for i, row in enumerate(self._rows):
                    xb = torch.from_numpy(np.ascontiguousarray(
                        rows[i * slab:(i + 1) * slab])).to(row.device)
                    tensors, stats = self._row_tensors(
                        row, state.params, state.batch_stats)
                    outs.append(vmap(functools.partial(member_apply, row),
                                     in_dims=(0, 0, None))(
                        tensors, stats, xb).float().cpu().numpy())
        finally:
            for module in modules.values():
                module.train()
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=1)

    # -- the loop -------------------------------------------------------
    def fit_arrays(self, x: np.ndarray, y: np.ndarray,
                   ckpt_dir: Optional[str] = None, resume: bool = False,
                   member_variables: Optional[Sequence[dict]] = None
                   ) -> SweepResult:
        """Train the whole population on shared data; returns the final
        stacked state, per-member loss curves and the winner (the best
        mean loss over the final epoch among the survivors).  `ckpt_dir`
        with `config.checkpoint_every_steps` writes population checkpoints;
        `resume=True` restarts from the newest valid one, replaying the
        data order and skipping the completed steps."""
        cfg = self.config
        n_pop = self.population
        ckpt_dir = ckpt_dir if ckpt_dir is not None else cfg.checkpoint_dir
        n = len(x)
        data = len(self.shard_devices)
        bs = max(cfg.batch_size - cfg.batch_size % data, data)
        steps_per_epoch = max(1, (n + bs - 1) // bs)
        total_steps = steps_per_epoch * cfg.epochs
        self._effective_batch_size = bs
        state = self.init_state((1,) + x.shape[1:], total_steps,
                                input_dtype=np.asarray(x).dtype,
                                member_variables=member_variables)
        skip_until = 0
        if resume and ckpt_dir and \
                latest_valid_checkpoint(ckpt_dir) is not None:
            state = self.restore_checkpoint(state, ckpt_dir)
            skip_until = int(state.step)
            get_logger("train").info(
                "sweep resuming from checkpoint at step %d", skip_until)
        step_fn = self.make_population_step()
        rng = np.random.default_rng(cfg.seed)

        # rung boundaries: the step budget split evenly, the last strictly
        # before the end so the final span trains the survivors
        rungs = []
        if self.halving_rungs > 0:
            span = total_steps / (self.halving_rungs + 1)
            rungs = sorted({int(span * (i + 1))
                            for i in range(self.halving_rungs)})
            rungs = [r for r in rungs if 0 < r < total_steps]

        tracer = active_tracer()
        run = active_run()
        timings = active_timings()
        fit_span = tracer.span(
            "sweep.fit", parent=current_span_id(), cat="phase",
            architecture=cfg.architecture, population=n_pop,
            total_steps=total_steps, batch_size=bs,
            halving_rungs=len(rungs)) if tracer is not None else None
        fit_id = fit_span.span_id if fit_span is not None else None
        if run is not None:
            run.record_sweep({
                "event": "start", "population": n_pop,
                "total_steps": total_steps,
                "lrs": [self.member_lr(k) for k in range(n_pop)],
                "rungs": rungs, "resumed_at": skip_until})

        t0 = monotonic()
        active_host = state.active.cpu().numpy().astype(np.float32)
        loss_rows: list = []        # one (N,) device tensor per step run
        rung_start = 0
        epoch_losses: list = []

        def finish_epoch(epoch: int) -> None:
            if epoch < 0 or not epoch_losses:
                return
            mean = torch.stack(epoch_losses).cpu().numpy().mean(axis=0)
            act = active_host > 0
            self.history.append({
                "epoch": epoch,
                "loss": float(mean[act].mean()) if act.any()
                else float(mean.mean()),
                "member_loss": [float(v) for v in mean],
                "wall_s": monotonic() - t0})

        def cull(step_c: int) -> None:
            """One halving rung: rank the active members by their mean
            loss since the previous rung; freeze the trailing fraction."""
            nonlocal active_host, rung_start
            window = loss_rows[rung_start:]
            rung_start = len(loss_rows)
            if not window:
                return
            mean = torch.stack(window).cpu().numpy().mean(axis=0)
            alive = np.flatnonzero(active_host > 0)
            n_keep = max(self.min_active,
                         len(alive) - max(1, int(len(alive)
                                                 * self.cull_fraction)))
            if n_keep >= len(alive):
                return
            order = alive[np.argsort(mean[alive], kind="stable")]
            culled = order[n_keep:]
            active_host = active_host.copy()
            active_host[culled] = 0.0
            state.active = torch.from_numpy(active_host).to(self.device)
            if run is not None:
                run.record_sweep({
                    "event": "cull", "step": step_c,
                    "culled": [int(c) for c in culled],
                    "survivors": [int(s) for s in order[:n_keep]],
                    "window_loss": [float(v) for v in mean]})
            get_logger("train").info(
                "sweep rung at step %d: culled members %s (%d survive)",
                step_c, [int(c) for c in culled], n_keep)

        step_c = 0
        cur_epoch = -1
        for epoch in range(cfg.epochs):
            order = epoch_order(rng, epoch, n, n, cfg.shuffle_each_epoch)
            finish_epoch(cur_epoch)
            cur_epoch, epoch_losses = epoch, []
            for start in range(0, n, bs):
                if step_c < skip_until:
                    # completed before the checkpoint being resumed; a rung
                    # crossed before the save is in the restored mask
                    step_c += 1
                    if step_c in rungs:
                        rung_start = len(loss_rows)
                    continue
                with span_on(timings, "host"):
                    idx = order[start:start + bs]
                    valid = len(idx)
                    if valid < bs:
                        idx = np.concatenate(
                            [idx, np.resize(order, bs - valid)])
                    mask = np.zeros(bs, np.float32)
                    mask[:valid] = 1.0
                    hosts = [host_batch(a) for a in (x[idx], y[idx], mask)]
                with span_on(timings, "transfer"):
                    # one contiguous slab per data shard
                    slab = bs // data
                    xb, yb, mask_d = ([torch.from_numpy(np.ascontiguousarray(
                        h[i * slab:(i + 1) * slab])).to(dev)
                        for i, dev in enumerate(self.shard_devices)]
                        for h in hosts)
                if tracer is None:
                    with span_on(timings, "compute"):
                        losses = step_fn(state, xb, yb, mask_d)
                else:
                    with tracer.span(
                            "train.step", parent=fit_id, cat="step",
                            step=step_c, epoch=epoch,
                            population=n_pop) as sp, \
                            span_on(timings, "compute"):
                        losses = step_fn(state, xb, yb, mask_d)
                        fetched = losses.cpu().numpy()
                        act = active_host > 0
                        sp.attrs["loss"] = float(
                            fetched[act].mean() if act.any()
                            else fetched.mean())
                        sp.attrs["member_loss"] = [
                            round(float(v), 6) for v in fetched]
                        sp.attrs["active_members"] = int(act.sum())
                loss_rows.append(losses)
                epoch_losses.append(losses)
                step_c += 1
                if step_c in rungs:
                    cull(step_c)
                if ckpt_dir and cfg.checkpoint_every_steps and \
                        step_c % cfg.checkpoint_every_steps == 0:
                    self.save_checkpoint(state, ckpt_dir, step=step_c,
                                         sync=not cfg.async_checkpointing)
        finish_epoch(cur_epoch)
        self._close_writers()
        if ckpt_dir:
            self.save_checkpoint(state, ckpt_dir, sync=True)
            self._close_writers()

        member_loss = (torch.stack(loss_rows).cpu().numpy()
                       if loss_rows else np.zeros((0, n_pop), np.float32))
        tail = (member_loss[-max(1, steps_per_epoch):] if len(member_loss)
                else np.zeros((1, n_pop), np.float32))
        tail_mean = tail.mean(axis=0)
        best = int(np.argmin(np.where(active_host > 0, tail_mean, np.inf)))
        if run is not None:
            for k in range(n_pop):
                run.record_sweep({
                    "event": "member_final", "member": k,
                    "lr": self.member_lr(k),
                    "active": bool(active_host[k] > 0),
                    "final_loss": float(member_loss[-1, k])
                    if len(member_loss) else None})
            run.record_sweep({"event": "winner", "member": best,
                              "final_loss": float(tail_mean[best])})
        if fit_span is not None:
            fit_span.attrs["winner"] = best
            fit_span.finish()
        self._last_state = state
        return SweepResult(
            state=state, member_loss=member_loss,
            lrs=np.asarray([self.member_lr(k) for k in range(n_pop)],
                           np.float32),
            active=active_host.copy(), best_member=best, _trainer=self)

    # -- unstacking ----------------------------------------------------------
    def member_variables(self, state: PopulationState, k: int) -> dict:
        """Member k's variables in the flax layout (numpy leaves)."""
        variables = {"params": named_tree(self._names,
                                          [p[k] for p in state.params])}
        if self._stat_names:
            variables["batch_stats"] = stats_tree(
                self._stat_names, [s[k] for s in state.batch_stats])
        return variables

    def member_bundle(self, state: PopulationState, k: int) -> ModelBundle:
        """Member k as an ordinary ModelBundle: loadable by `TPUModel`,
        fine-tunable by `Trainer`; metadata as the JAX package writes it."""
        rules = self.config.partition_rules or DEFAULT_RULES
        metadata = {
            "steps": int(state.step),
            "sweep": {"member": int(k), "population": self.population,
                      "learning_rate": self.member_lr(k)},
            "partition": {"rules": rules_to_json(rules),
                          "mesh": {"data": len(self.shard_devices),
                                   "model": self.model_size}},
        }
        return ModelBundle(self.config.architecture,
                           model_config(self.module),
                           self.member_variables(state, k), metadata)

    def member_trainer(self, k: int) -> Trainer:
        """A plain Trainer configured as member k (its rate and seed)."""
        cfg = dataclasses.replace(self.config,
                                  learning_rate=self.member_lr(k),
                                  seed=self._member_seed(k))
        return Trainer(cfg, mesh=self.mesh, device=self.device)

    # -- checkpoint / resume ----------------------------------------------
    def _writer_for(self, ckpt_dir: str) -> CheckpointWriter:
        writer = self._writers.get(ckpt_dir)
        if writer is None:
            writer = self._writers[ckpt_dir] = CheckpointWriter(ckpt_dir)
        return writer

    def _close_writers(self) -> None:
        for writer in self._writers.values():
            writer.close(best_effort=True)
        self._writers.clear()

    def _member_opt(self, state: PopulationState, k: int) -> dict:
        opt = state.opt_state
        return {key: ([t[k] for t in value] if key in _MOMENTS else value)
                for key, value in opt.items()}

    def state_tree(self, state: PopulationState) -> dict:
        """The population checkpoint tree, numpy leaves: stacked flax
        params, optax state and batch_stats ({} without BatchNorm), the
        step, `lr` and `active`."""
        n = self.population
        return {
            "step": np.asarray(int(state.step), np.int32),
            "params": stack_trees([named_tree(
                self._names, [p[k] for p in state.params])
                for k in range(n)]),
            "opt_state": stack_trees([opt_state_to_jax(
                self._member_opt(state, k), self._names) for k in range(n)]),
            "batch_stats": stack_trees([stats_tree(
                self._stat_names, [s[k] for s in state.batch_stats])
                for k in range(n)]) if self._stat_names else {},
            "lr": state.lr.cpu().numpy(),
            "active": state.active.cpu().numpy()}

    def save_checkpoint(self, state: PopulationState, ckpt_dir: str, *,
                        step: Optional[int] = None,
                        sync: bool = True) -> str:
        """One rotation checkpoint of the whole population in one file."""
        step = int(state.step) if step is None else int(step)
        meta = {"step": step, "population": self.population,
                "effective_batch_size": self._effective_batch_size,
                "seed": int(self.config.seed), "sweep": True, "format": 1}
        path = self._writer_for(ckpt_dir).submit(
            step, self.state_tree(state), meta=meta, sync=sync)
        return path if path else os.path.join(ckpt_dir,
                                              checkpoint_name(step))

    def restore_checkpoint(self, state: PopulationState,
                           ckpt_dir: str) -> PopulationState:
        """The newest valid population checkpoint as a state, the active
        mask included (culls before the save stay culled)."""
        path = latest_valid_checkpoint(ckpt_dir)
        if path is None:
            raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
        restored = read_checkpoint(self.state_tree(state), path)
        dev, n = self.device, self.population

        def stacked(tree: dict, names: list) -> list:
            members = [params_from_jax(unstack_member(tree, k))
                       for k in range(n)] if names else []
            return [torch.stack([m[name] for m in members]).to(dev)
                    for name in names]

        params = stacked(restored["params"], self._names)
        stats = [variables_from_jax({"params": {}, "batch_stats":
                                     unstack_member(restored["batch_stats"],
                                                    k)})
                 for k in range(n)] if self._stat_names else []
        stats = [torch.stack([m[name] for m in stats]).to(dev)
                 for name in self._stat_names]
        members = [opt_state_from_jax(
            unstack_member(restored["opt_state"], k), self._names,
            device=dev) for k in range(n)]
        opt = {key: value for key, value in members[0].items()
               if key not in _MOMENTS}
        for key in _MOMENTS:
            if key in members[0]:
                opt[key] = [torch.stack(leaves) for leaves in
                            zip(*(m[key] for m in members))]
        return PopulationState(
            step=int(np.asarray(restored["step"])), params=params,
            opt_state=opt, batch_stats=stats,
            lr=torch.from_numpy(np.array(restored["lr"],
                                         np.float32)).to(dev),
            active=torch.from_numpy(np.array(restored["active"],
                                             np.float32)).to(dev))

