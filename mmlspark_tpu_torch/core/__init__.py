from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.params import Param, ParamError, Params
from mmlspark_tpu_torch.core.pipeline import (Estimator, Evaluator, Pipeline,
                                              PipelineModel, PipelineStage,
                                              Transformer, load_stage)
from mmlspark_tpu_torch.core.schema import ColumnMeta, SchemaConstants
from mmlspark_tpu_torch.core.table import DataTable, object_column
