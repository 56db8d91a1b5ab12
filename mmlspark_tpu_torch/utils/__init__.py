"""Cross-cutting utilities: the stage registry, random data generation."""

from mmlspark_tpu_torch.utils.datagen import ColumnOptions, generate_table
from mmlspark_tpu_torch.utils.registry import all_stage_classes, api_summary

__all__ = ["all_stage_classes", "api_summary", "generate_table",
           "ColumnOptions"]
