from mmlspark_tpu_torch.train.config import TrainerConfig
from mmlspark_tpu_torch.train.learner import TPULearner
from mmlspark_tpu_torch.train.sweep import (PopulationState,
                                            PopulationTrainer, SweepResult)
from mmlspark_tpu_torch.train.supervisor import (RecoveryBudgetExceeded,
                                                 RecoveryPolicy,
                                                 RecoverySupervisor)
from mmlspark_tpu_torch.train.trainer import Trainer, TrainState
