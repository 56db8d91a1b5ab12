"""mmlspark_tpu_torch — the PyTorch / CUDA port of mmlspark_tpu.

A second package beside the JAX one, with the same SparkML-style
Params/Transformer API, the same `DataTable` and bundle formats, and
hand-written Hopper kernels (CUDA C++ in `csrc/`, built by nvcc at first
use) where the JAX package has Pallas kernels.  It never imports jax, flax,
optax or mmlspark_tpu.

Ported so far: LM serving, `TextGenerator.transform` ->
`DecodeEngine.generate`, with the flash-attention prefill and the fused
single-query decode read as CUDA kernels; and LM training,
`Trainer(TrainerConfig(...)).fit_arrays`, with the flash-attention forward
(with its log-sum-exp) and backward (dQ, dK/dV) as CUDA kernels; and
seq-sharded long-context decode, `DecodeEngine`/`TextGenerator` over a
single-controller data x seq `Mesh`, with ring prefill over the flash
forward with lse and the decode read's stats entry as a CUDA kernel.

Layer map:
  core/    - params DSL, column metadata, DataTable, stage save/load,
             device selection
  models/  - TransformerLM (torch.nn), bundles, the decode engine
  train/   - TrainerConfig, the optax-algebra optimizers, the Trainer
  parallel/ - MeshSpec, Mesh and make_mesh (single controller, devices may
             repeat), the collectives and ring attention over a mesh
             (ring.py), the partition-rule data
  ops/     - attention in torch (dense, cache read, stats merge, ring) and
             the kernel wrappers (flash forward and backward, single-query
             decode read and its stats entry), the nvcc build/loader
  quant/   - int8 KV-cache quantization
  utils/   - analytic FLOP accounting
  csrc/    - the CUDA sources
"""

__version__ = "0.1.0"

from mmlspark_tpu_torch.core import (DataTable, Param, Params, PipelineStage,
                                     Transformer, load_stage)
from mmlspark_tpu_torch.models import (DecodeEngine, ModelBundle,
                                       TextGenerator, TransformerLM,
                                       build_model, load_bundle,
                                       naive_generate, save_bundle)
from mmlspark_tpu_torch.train import Trainer, TrainerConfig
