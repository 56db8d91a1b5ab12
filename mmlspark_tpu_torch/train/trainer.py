"""The single-device Trainer: the port of `mmlspark_tpu/train/trainer.py`
(`_make_loss` :157-179, `_epoch_order` :197-208, `Trainer` :211-312,
:367-442, :445-927, :988-1021) for a `TransformerLM` on one card.

`fit_arrays` keeps the JAX loop's contract: the clamped batch size, the
numpy data order (`np.random.default_rng(seed)`, or `[seed, rng_fold]`),
a partial last batch padded by cycling rows of the epoch's order with a
0/1 loss mask, one `history` row per epoch (loss, grad_norm, wall_s)
fetched at the epoch's end, and a bundle whose metadata records `steps`
and the partition layout exactly as the JAX Trainer writes them.

A step is forward -> loss -> `backward()` -> global gradient norm (f32)
-> the optax-algebra update of the f32 masters (`train/optim.py`).  With
`attn_impl="flash"` the attention forward and backward are the CUDA
kernels K1-K3 (`ops/flash_attention.py`).  Batches are staged serially:
pinned host memory, then a non-blocking copy to the card.

Not ported (they raise NotImplementedError): pipeline stages, multi-device
meshes, checkpoint/resume, recovery skip windows, the hung-step watchdog,
halting on non-finite or diverging losses, and every architecture but
`TransformerLM`.  `numerics_cadence` is accepted and runs no probe;
`prefetch_depth` is kept for the config round trip.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.models.bundle import ModelBundle, params_from_jax
from mmlspark_tpu_torch.models.definitions import (build_model,
                                                   init_transformer_lm_params)
from mmlspark_tpu_torch.parallel.partition import DEFAULT_RULES, rules_to_json
from mmlspark_tpu_torch.train.config import TrainerConfig
from mmlspark_tpu_torch.train.optim import Optimizer, global_norm

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


def epoch_order(rng, epoch: int, n: int, n_local: int,
                shuffle: bool) -> np.ndarray:
    """The `n` row indices this epoch feeds (the JAX `_epoch_order`)."""
    if shuffle:
        return rng.permutation(n_local)[:n]
    if n == n_local:
        return np.arange(n)
    return (np.arange(n) + epoch * n) % n_local


@dataclasses.dataclass
class TrainState:
    """The global step, the parameters (the module's f32 masters, updated
    in place) and the optimizer's state."""

    step: int
    params: list
    opt_state: dict


class Trainer:
    """Drives the training loop for one model on one card."""

    def __init__(self, config: TrainerConfig, mesh=None, device="cuda"):
        if config.architecture != "TransformerLM":
            raise NotImplementedError(
                f"architecture {config.architecture!r} is not ported "
                "(TransformerLM)")
        if config.pipeline_stages > 1:
            raise NotImplementedError("pipeline stages are not ported")
        if mesh is not None:
            raise NotImplementedError("meshes are not ported (one card)")
        spec = config.mesh
        if max(spec.data, spec.model, spec.seq) > 1:
            raise NotImplementedError(
                f"training over a mesh ({spec}) is not ported: the Trainer "
                "runs on one card (ROADMAP A10)")
        spec.resolve(1)   # a malformed spec raises
        if config.step_timeout_s > 0:
            raise NotImplementedError("the hung-step watchdog is not ported")
        if config.halt_on_nonfinite or config.halt_on_divergence:
            raise NotImplementedError(
                "halting on numerics (halt_on_nonfinite / "
                "halt_on_divergence) is not ported")
        self.config = config
        self.device = resolve_device(device)
        self.module = build_model(config.architecture, config.model_config,
                                  device=self.device)
        self._loss = make_loss(config.loss)
        self.history: list[dict] = []

    # -- state ----------------------------------------------------------
    def init_state(self, total_steps: int = 1,
                   initial_bundle: Optional[ModelBundle] = None
                   ) -> TrainState:
        """Load the module's seeded init (or warm-start from a bundle) into
        its f32 masters and build the optimizer state.  A warm start
        resumes the bundle's recorded step."""
        self._tx = Optimizer(self.config, total_steps)
        if initial_bundle is not None:
            variables = initial_bundle.variables
        else:
            variables = init_transformer_lm_params(self.module.config,
                                                   self.config.seed)
        self.module.load_state_dict(params_from_jax(variables["params"]))
        self.module.train()
        params = list(self.module.parameters())
        start = int((initial_bundle.metadata or {}).get("steps", 0)) \
            if initial_bundle is not None else 0
        return TrainState(step=start, params=params,
                          opt_state=self._tx.init(params))

    # -- the step -------------------------------------------------------
    def make_train_step(self):
        """`step(state, x, y, mask) -> (loss, {"grad_norm": ...})`, both
        device tensors; the state's parameters and optimizer state are
        updated in place and its step advances."""
        module, loss_fn, tx = self.module, self._loss, self._tx

        def train_step(state: TrainState, x, y, mask):
            for p in state.params:
                p.grad = None
            loss = loss_fn(module(x), y, mask)
            loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in state.params]
            grad_norm = global_norm(grads)
            tx.update(grads, state.opt_state, state.params)
            state.step += 1
            return loss.detach(), {"grad_norm": grad_norm}

        return train_step

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        if np.issubdtype(arr.dtype, np.integer):
            arr = arr.astype(np.int64)
        elif arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

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
        bundle.  `self.history` gains one row per epoch."""
        cfg = self.config
        ckpt_dir = ckpt_dir if ckpt_dir is not None else cfg.checkpoint_dir
        if ckpt_dir or resume:
            raise NotImplementedError("checkpoint/resume is not ported")
        if skip_data_windows:
            raise NotImplementedError("recovery skip windows are not ported")
        n = n_local = len(x)
        bs = max(cfg.batch_size, 1)   # the JAX clamp with a data axis of 1
        steps_per_epoch = max(1, (n + bs - 1) // bs)
        total_steps = steps_per_epoch * cfg.epochs

        state = self.init_state(total_steps, initial_bundle)
        step_fn = self.make_train_step()
        rng = np.random.default_rng(
            cfg.seed if not cfg.rng_fold else [cfg.seed, int(cfg.rng_fold)])
        t0 = time.monotonic()
        emit = log_fn if log_fn is not None else _LOG.info

        def finish_epoch(epoch: int, losses: list, norms: list) -> None:
            # one device->host fetch per epoch, never per step
            fetched = torch.stack(losses + norms).cpu().numpy()
            rec = {"epoch": epoch,
                   "loss": float(np.sum(fetched[:len(losses)]))
                   / max(len(losses), 1),
                   "wall_s": time.monotonic() - t0,
                   "grad_norm": float(np.mean(fetched[len(losses):]))}
            self.history.append(rec)
            if epoch % max(1, log_every) == 0 or epoch == cfg.epochs - 1:
                emit(f"epoch {epoch}: loss={rec['loss']:.5f} "
                     f"({rec['wall_s']:.1f}s)")

        for epoch in range(cfg.epochs):
            order = epoch_order(rng, epoch, n, n_local,
                                cfg.shuffle_each_epoch)
            losses, norms = [], []
            for start in range(0, n, bs):
                idx = order[start:start + bs]
                valid = len(idx)
                if valid < bs:
                    # cycle rows of the order into the pad, masked out
                    idx = np.concatenate([idx, np.resize(order, bs - valid)])
                mask = np.zeros(bs, np.float32)
                mask[:valid] = 1.0
                loss, metrics = step_fn(state, self._to_device(x[idx]),
                                        self._to_device(y[idx]),
                                        self._to_device(mask))
                losses.append(loss)
                norms.append(metrics["grad_norm"])
            finish_epoch(epoch, losses, norms)
        return self.bundle_from_state(state)

    def bundle_from_state(self, state: TrainState) -> ModelBundle:
        """The trained bundle; metadata records the step and the partition
        layout (rules and a {data: 1, model: 1} mesh) as the JAX Trainer
        does."""
        rules = self.config.partition_rules or DEFAULT_RULES
        metadata = {
            "steps": int(state.step),
            "partition": {"rules": rules_to_json(rules),
                          "mesh": {"data": 1, "model": 1}},
        }
        return ModelBundle.from_module(self.module, metadata)
