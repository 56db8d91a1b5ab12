from mmlspark_tpu_torch.train.config import TrainerConfig
from mmlspark_tpu_torch.train.trainer import Trainer, TrainState
