"""mmlspark_tpu_torch — the PyTorch / CUDA port of mmlspark_tpu.

A second package beside the JAX one, with the same SparkML-style
Params/Transformer API, the same `DataTable` and bundle formats, and
hand-written Hopper kernels (CUDA C++ in `csrc/`, built by nvcc at first
use) where the JAX package has Pallas kernels.  It never imports jax, flax,
optax or mmlspark_tpu.

Ported so far: LM serving, `TextGenerator.transform` ->
`DecodeEngine.generate`, with the flash-attention prefill and the fused
single-query decode read as CUDA kernels.

Layer map:
  core/    - params DSL, column metadata, DataTable, stage save/load,
             device selection
  models/  - TransformerLM (torch.nn), bundles, the decode engine
  ops/     - plain attention and the kernel wrappers (flash prefill,
             single-query decode read), the nvcc build/loader
  quant/   - int8 KV-cache quantization
  csrc/    - the CUDA sources
"""

__version__ = "0.1.0"

from mmlspark_tpu_torch.core import (DataTable, Param, Params, PipelineStage,
                                     Transformer, load_stage)
from mmlspark_tpu_torch.models import (DecodeEngine, ModelBundle,
                                       TextGenerator, TransformerLM,
                                       build_model, load_bundle,
                                       naive_generate, save_bundle)
