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
forward with lse and the decode read's stats entry as a CUDA kernel; and
online serving, `serve.start_engine` + `serve.start_http` ->
`ServingEngine.submit` -> the `DecodeEngine` serve hooks (continuous
batching of mixed-age rows, admission, deadlines, drain, HTTP), over the
flash prefill and the decode read; and the replicated colocated fleet,
`serve.build_fleet` + `serve.start_router` (a router over engine
replicas: power-of-two-choices, ejection, failover under a retry budget,
hedging, prefix affinity), with chunked prefill and the radix prefix KV
pool; and the rest of one-card LM decoding: int8-weight bundles
(`quant.quantize_bundle`), speculative decoding with a truncated draft
(`zoo.truncated_draft_bundle`; `TextGenerator(specTokens=...)`, the
`ServingEngine`'s speculative lanes) and beam search
(`TextGenerator(beamWidth=...)`); fault-tolerant training (checkpoint
rotation in the JAX package's format, async writes, resume, the
preemption guard, the step watchdog, numerics halts and the
`RecoverySupervisor`); and seq-parallel training over a data x seq
`Mesh` (`parallel.ring.make_seq_parallel_lm_step` with the differentiable
ring flash over the flash forward with lse and the dQ and dK/dV kernels,
the dense ring, Ulysses); and vision and tabular scoring,
`TPUModel(bundle, inputCol=..., outputCol=...).transform(table)` over the
MLP, linear, ConvNet and ResNet models (ResNet-50 included; bf16, f32 and
int8 weights; convolutions, BatchNorm and Dense layers on cuDNN and
cuBLAS, with staging through pinned buffers and a copy stream), composed
with `Pipeline` / `PipelineModel`, over bundles from the local model zoo
(`zoo.ModelDownloader`, `zoo.pretrained_repo`); and the image pipeline
that feeds it: `io.read_images` / `io.read_images_iter` over local, zip
and remote sources with the host decoder (`native_loader`), the streaming
`data.Dataset` with its depth Autotuner, and `vision.ImageTransformer`,
`UnrollImage` and `ImageFeaturizer` (torch image ops on the card); and
training of the vision and tabular models, `Trainer.fit_arrays` over the
MLP, linear, ConvNet and ResNet models (BatchNorm statistics updated in
training and carried in checkpoints and bundles, batches staged through
a `Dataset` map stage) and `TPULearner.fit(table) -> TPUModel`.

Layer map:
  core/    - params DSL, column metadata and the schema helpers, DataTable,
             stages, Pipeline / PipelineModel and their save/load, device
             selection, host bfloat16 arrays
  models/  - TransformerLM and the scoring models (torch.nn), bundles,
             TPUModel, the decode engine, beam search
  train/   - TrainerConfig, the optax-algebra optimizers and their state
             trees, the Trainer, TPULearner, the recovery supervisor
  parallel/ - MeshSpec, Mesh and make_mesh (single controller, devices may
             repeat), the collectives, attention over a mesh and the
             seq-parallel LM step (ring.py), the partition-rule data, the
             ordered Prefetcher and the pinned host <-> device feed
  io/      - binary-file, image, remote (http, gs, s3) and SQL readers
  data/    - the streaming Dataset graph, its executor, the depth
             Autotuner, snapshot offsets; the data service's framing
  vision/  - ImageTransformer, UnrollImage, ImageFeaturizer
  ops/     - the image ops; attention in torch (dense, cache read, stats
             merge, ring, differentiable ring flash, Ulysses) and
             the kernel wrappers (flash forward and backward, single-query
             decode read and its stats entry), the nvcc build/loader
  quant/   - weight PTQ of bundles (bf16, int8), the int8 Dense and Conv
             forwards, int8 KV-cache quantization
  zoo/     - the local model repository and downloader, the pretrained
             bundles, draft bundles for speculative decoding
  serve/   - the continuous-batching ServingEngine, admission, requests,
             the prefix pool, replicas and the router, the HTTP front end
             and the lifecycle (threads, SIGTERM drain)
  observe/ - logger, counters, spans, traces, run telemetry, SLOs,
             waterfalls, Prometheus text, numerics probes
  resilience/ - the injectable clock, circuit breakers, the retry
             policy and the one HTTP seam, the SIGTERM guard and step
             watchdog, the seeded chaos injector, checkpoint rotation
             and the async writer
  native_loader.py, native/ - the host image decoder (C++, g++ at first
             use)
  config.py - the MMLSPARK_TPU_* knob registry (the JAX package's names)
  utils/   - analytic FLOP accounting
  csrc/    - the CUDA sources
"""

__version__ = "0.1.0"

from mmlspark_tpu_torch.core import (DataTable, Estimator, Param, Params,
                                     Pipeline, PipelineModel, PipelineStage,
                                     Transformer, load_stage)
from mmlspark_tpu_torch.models import (DecodeEngine, ModelBundle,
                                       TextGenerator, TPUModel, TransformerLM,
                                       build_model, load_bundle,
                                       naive_generate, save_bundle)
from mmlspark_tpu_torch.train import TPULearner, Trainer, TrainerConfig
from mmlspark_tpu_torch.zoo import ModelDownloader, pretrained_repo
