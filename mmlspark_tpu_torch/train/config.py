"""TrainerConfig: the port of `mmlspark_tpu/train/config.py` (:22-156).

The same fields, defaults, validation and JSON form, so a config saved by
either package loads in the other.  Fields of features the port's Trainer
does not run yet are kept for that round trip; the Trainer raises on the
ones that would change a run (see `train/trainer.py`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from mmlspark_tpu_torch.parallel.mesh import MeshSpec
from mmlspark_tpu_torch.parallel.partition import (rules_from_json,
                                                   rules_to_json)

LOSSES = ("softmax_xent", "sigmoid_xent", "mse", "mae")
OPTIMIZERS = ("sgd", "momentum", "adam", "adamw")


@dataclasses.dataclass
class TrainerConfig:
    # model
    architecture: str = "MLPClassifier"
    model_config: dict = dataclasses.field(default_factory=dict)

    # optimization
    optimizer: str = "momentum"
    learning_rate: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_schedule: str = "constant"          # constant | cosine | warmup_cosine
    warmup_steps: int = 0
    gradient_clip_norm: Optional[float] = None

    # loop
    loss: str = "softmax_xent"
    epochs: int = 1
    batch_size: int = 256
    seed: int = 0
    shuffle_each_epoch: bool = True

    # parallelism
    mesh: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    tensor_parallel: bool = True
    expert_parallel: bool = True
    # ordered (regex over the parameter path, spec) rules, first match
    # wins; None = DEFAULT_RULES (parallel/partition.py)
    partition_rules: Optional[tuple] = None
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4

    # input staging: batches in flight on the Trainer's Dataset map stage
    # (batch k+1's gather and copy overlap step k).  Positive pins the
    # window, 0 hands it to the data layer's Autotuner, -1 stages
    # synchronously on the dispatch thread
    prefetch_depth: int = 2

    # checkpoint/resume
    checkpoint_dir: Optional[str] = None
    checkpoint_every_steps: int = 0
    async_checkpointing: bool = True
    step_timeout_s: float = 0.0
    # folds an attempt number into the data-order RNG (0 keeps the stream)
    rng_fold: int = 0

    # numerics health probes
    numerics_cadence: int = 50
    halt_on_nonfinite: bool = False
    halt_on_divergence: bool = False

    # weight on model-sown auxiliary losses (none for a dense model)
    aux_loss_weight: float = 0.0

    def __post_init__(self):
        if self.loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got {self.loss!r}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"optimizer must be one of {OPTIMIZERS}, got {self.optimizer!r}")
        if isinstance(self.mesh, dict):
            self.mesh = MeshSpec(**self.mesh)
        if self.partition_rules is not None:
            # rules as (pattern, spec) pairs or in their JSON wire form
            self.partition_rules = rules_from_json(
                rules_to_json(self.partition_rules))

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["mesh"] = dataclasses.asdict(self.mesh)
        if self.partition_rules is not None:
            d["partition_rules"] = rules_to_json(self.partition_rules)
        return d

    @staticmethod
    def from_json(d: dict) -> "TrainerConfig":
        d = dict(d)
        if "mesh" in d:
            d["mesh"] = MeshSpec(**d["mesh"])
        return TrainerConfig(**d)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @staticmethod
    def load(path: str) -> "TrainerConfig":
        with open(path) as f:
            return TrainerConfig.from_json(json.load(f))
