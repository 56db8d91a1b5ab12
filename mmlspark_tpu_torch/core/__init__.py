from mmlspark_tpu_torch._lazy import lazy_exports
from mmlspark_tpu_torch.core.params import Param, ParamError, Params
from mmlspark_tpu_torch.core.pipeline import (Estimator, Evaluator, Pipeline,
                                              PipelineModel, PipelineStage,
                                              Transformer, load_stage)
from mmlspark_tpu_torch.core.schema import ColumnMeta, SchemaConstants
from mmlspark_tpu_torch.core.table import DataTable, object_column

# core.device imports torch: resolved on first use (`_lazy.py`)
__getattr__, __dir__ = lazy_exports(
    __name__, {"resolve_device": "mmlspark_tpu_torch.core.device"})
