"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): builds the
hand-written kernels from `mmlspark_tpu_torch/csrc/`, holds each against
its plain PyTorch version, drives the LM serving path
(`TextGenerator.transform` -> `DecodeEngine.generate`, with int8
weights, speculative decoding and beam search too), the online
serving engine and a replicated fleet of them over HTTP, and the LM
training path
(`Trainer.fit_arrays`, with checkpoints, preemption, resume and the
recovery supervisor too) at the full width of the repo's LM bench
configuration, the seq-sharded long-context decode and seq-parallel
training paths at the width of its long-context configuration and the
disaggregated prefill/decode tiers, and vision and tabular scoring
(`TPUModel.transform` over the zoo ConvNet, ResNet-50 and the MLP zoo
bundles), the image pipeline (PNG files -> the streaming reader ->
ResNet-50 scoring under the depth Autotuner; `ImageTransformer` and
`ImageFeaturizer`), vision and tabular training, and the AutoML layer
(`TrainClassifier` / `TrainRegressor` over every learner family,
`FindBestModel`, the text featurizer and `CheckpointData`), the
mixture-of-experts LM (served, trained, rematerialized) and the
population sweep, the measurement layer, and data, tensor and expert
parallelism over meshes whose shards share the card, pipeline stages
and several processes, and the data service's worker processes feeding
ResNet-50 scoring, and times kernels and paths.

    python3 chip_smoke.py

(`python3 chip_smoke.py --ab TAG [--tree DIR]` runs only the host-bound
serving phases, for a parent-against-change comparison; with `--bwd`
only the K2/K3 checks and times (f32 at every head dim, bf16 at 8-32),
with `--fwd` only the bf16 K1 / K1[lse] ones at head dims 8-32:
`ab_main`.)

Phases (any failure exits non-zero before the result line):
  1. card (nvidia-smi name and power limit, and the ex2 rate the bounds
     use: 16 a clock an SM x SMs x clocks.max.sm) and kernel build; K1's, K2's,
     K3's and K4's `-Xptxas -v` lines (registers, shared memory, spills: a
     spill in any of the 60 kernels fails)
  2. flash-attention forward K1 vs plain: causal bf16 at S in {512, 1024,
     1984}, one non-causal case, one f32 case
  3. K1 with its log-sum-exp output and q/k offsets vs plain: causal bf16
     at S in {512, 2048, 1000}, q_offset 512, k_offset > q_offset (fully
     masked rows), one f32 case; out and lse compared
  4. flash backward K2 (dQ) and K3 (dK/dV) vs plain: causal bf16 at S in
     {512, 2048, 1000, 129}, non-causal Sq 768 / Sk 1280, offsets, head
     dim 64 at S 2048, f32 at head dims 128 and 64; a second launch at S 2048 bitwise equal to the
     first; `torch.autograd.grad` through `flash_attention` vs plain
     autograd; K2 and K3 timed with their TFLOP/s, ratio to the library
     pair and share of the bound
  5. single-query decode kernel K4 vs plain: bf16 and int8 caches at
     L in {128, 1152, 2048}, the engine's mask layout, a fully masked row;
     at the timed shape two calls bitwise equal and a CUDA graph replayed
     twice equal to an eager call (the in-launch span merge resets its
     arrival counters)
  6. the serving path at full width (TransformerLM vocab 8192, d_model
     1024, 8 heads, 4 layers, max_len 2048, bf16, seeded random weights):
     8 ragged prompts, 64 greedy tokens, model-dtype and int8 KV caches;
     K1 and K4 launch counts must rise; f32 prefill logits against the
     plain forward; greedy agreement with the recompute oracle at f32
  7. the training path at the same width: `fit_arrays` on 16 rows of
     2048 tokens, batch 8, 2 epochs of adam at 3e-4 with flash attention;
     the loss must fall and K1[lse], K2, K3 must each launch n_layers x
     steps times; the trained bundle generates through `TextGenerator`;
     step time, tokens/s and MFU
  8. the stats entry of the decode kernel, K4[stats], vs plain: bf16 and
     int8 caches (f32 q), head dims 64 and 128, the long-context slab
     (2, 4224, 8, 64) and a window not a multiple of SPLIT, a fully masked
     row giving exactly m = NEG_INF, l = 0, acc = 0; K4 at head dim 64;
     the repeat and graph checks of phase 5 at the slab and at K4's
     (2, 8448, 8, 64)
  9. K1[lse] at head dim 64 vs plain on the ring prefill's (shard, block)
     pairs (2, 4096, 8, 64) with q/k offsets 0/0, 4096/0, 4096/4096; K1
     at head dim 64 over (2, 8192, 8, 64); bf16 outputs held to a
     norm-relative limit as well as an absolute one (also in 2 and 3)
 10. the seq-sharded long-context path at the repo's long-context width
     (TransformerLM vocab 8192, d_model 512, 8 heads, 4 layers, max_len
     8448; context 8192, batch 2, 32 greedy tokens, cache chunk 256):
     `DecodeEngine` at seq=1 and over a seq=2 mesh whose two shards share
     this card; f32 greedy tokens identical, bf16 prefill logits close,
     K4[stats] and K1[lse] launch counts exact; prefill ms and decode
     ms/step of both engines
 11. f32 gradient check: every parameter's gradient with the flash
     kernels against the dense-attention model, TF32 off; K1[lse], K2, K3
     launched once a layer
 12. the online serving engine (`start_engine` + `start_http` ->
     `ServingEngine.submit` -> `_tick` -> the DecodeEngine serve hooks)
     at the width of phase 6: the phase-6 prompts, a mid-flight join and
     a streamed request POSTed over HTTP at f32 (tokens equal the offline
     engine's), bf16 and bf16 with an int8 cache (in-vocabulary rows);
     K1 and K4 launch counts exact against the engine's own spans; a
     clean drain; the repo's serving bench arms (continuous vs static
     goodput, latency percentiles, 88 of 96 shed at a queue of 8)
 13. the replicated fleet (`build_fleet` of 2 replicas on this card +
     `start_router` + `start_http` -> `Router` -> `Replica`s -> the
     engines) at the width of phase 6 with chunked prefill (512) and the
     prefix pool: the phase-12 prompts and four prompts sharing an
     896-token prefix over HTTP, at f32 (tokens equal the offline
     whole-prompt engine's), bf16 and bf16 with an int8 cache; K1 and K4
     launch counts exact against the replicas' spans, pool hits >= 3 on
     the replica affinity picked; at f32 a replica crashed mid-pass and
     every request still exact; a chunk's and a resumed prefill's ms;
     the repo's fleet bench arms (chunked first token, the Zipf prefix
     arm at its 8 heads of head dim 32 with K1 and K4 counted against
     its engine's spans, the router arm with one replica slowed 4x)
 14. the disaggregated tiers (`build_fleet` of 1 prefill + 1 decode
     replica on this card + `start_router` + `start_http` -> `Router` ->
     the prefill engine -> the KV handoff bus over loopback sockets ->
     `splice_remote` on the decode engine) at the width of phase 6 with
     chunked prefill (512): the phase-13 prompts over HTTP at f32 (tokens
     equal the offline engine's), bf16 and bf16 with an int8 cache; every
     spliced row byte-equal to what the prefill tier serialized; K1 =
     4 x (whole + chunk-0 prefills), all on the prefill tier, K4 = 4 x
     the decode steps, all on the decode tier; at f32 a torn page and a
     prefill crash mid-transfer, both re-prefilled exact; the bench's
     disaggregated arm against a colocated fleet; the disagg drill's
     interference scenario at full width (victims' inter-token p99,
     colocated over tiered, at least the drill's 1.2; 8 timed passes an
     arm, the arms interleaved pass by pass, pooled)
 15. head dim 32: K1 and K1[lse] at (2, 1024, 8, 32), f32 and bf16,
     causal and not and at q/k offsets, and K4 and K4[stats] at (16,
     1088, 8, 32) over bf16, f32 and int8 caches, against their plain
     versions, with their times, bounds and library calls; the main paths
     that run them at the Zipf arm's width (`TextGenerator.transform`,
     and the seq=2 `DecodeEngine`) with exact launch counts
 16. small head dims: the checks and times of phase 15 at head dims 8
     and 16; the f32 K1 at 64 and 128 (and its path: f32 `TextGenerator`
     at LC_CONFIG's and LM_CONFIG's widths); K2 and K3 at (8, 2048, 8, d)
     causal, bf16 and f32, at head dims 8, 16 and 32 against plain and
     the library's backward (a refused library call fails the run);
     then (a) the LM example's configuration (head dim 8) trained with
     flash attention at f32 and bf16, decoded (K4; continuation accuracy
     printed), checked by the example's recompute oracle over its own
     flash module (K1; f32 tokens equal it and a dense module's) and
     decoded over a seq=2 mesh (K1[lse], K4[stats]), (b) `TransformerLM`'s
     default widths (head dim 16) trained at bf16 and f32, served at bf16
     / int8 / f32 (f32 tokens equal the oracle's) and decoded over a
     seq=2 mesh, (c) the Zipf arm's width (head dim 32) trained at bf16
     and f32; every count exact, and every phase-16 row of the kernels
     line takes its launches from these paths; f32 gradient checks at 8,
     16, 32; bf16 K1, K1[lse] and K3 at 8, 16, 32 on the narrow wgmma
     kernels' edge cases (H = 1 and 3, split and 128-key edges, offsets,
     repeats bitwise equal); K1[lse] timed at the training shapes of (b)
     and (c), their rows' launches from those trainings
 17. the f32 training kernels at head dims 64 and 128: K2 and K3 at (8,
     2048, 8, d) causal against plain (a second launch bitwise equal) and
     K1[lse] on the same inputs, timed beside their bounds, plain versions
     and library calls (`aten._efficient_attention_backward` /
     `_forward`); the f32 gradient check at the long-context width (head
     dim 64); the rows' launches from that check (64) and phase 11's (128)
 18. the rest of LM decoding: (a) `TextGenerator(specTokens=7)` with a
     1-block draft of a target whose blocks 1-3 are softened to zero, at
     the width of phase 6 and its prompts, f32 and bf16: f32 tokens equal
     the plain stage's and the recompute oracle's, K1 = (target + draft
     layers) x the prefills of buckets >= 512 and K4 = rounds x 8 draft
     steps, exact; (b) the repo's speculative bench arm at its width
     (8 layers, 8 x 64 prompt, 128 new, k 7): tokens/s beside its plain
     engine, the acceptance rate; (c) an int8 and a
     bf16 `quantize_bundle` of the phase-6 model through `TextGenerator`:
     tokens/s, ms/step, resident Dense bytes, greedy agreement, K1 and K4
     exact; (d) `ServingEngine(spec_tokens=3)` over HTTP at f32 (every
     response 200, tokens equal the offline speculative engine's), then
     one request on its int8 degraded lane with the breaker forced open
     (tokens equal the offline int8 engine's); (e) beam width 4 over a
     600-token prompt at f32: K1 once a layer, the best score within 1e-3
     of a full-forward recompute
 19. checkpointed training at the width of phase 7 (`Trainer.fit_arrays`,
     8 x 2048, adam, async checkpoints every 2 steps in a temporary
     directory): two fault-free fits (bitwise repeatable?), a chaos
     SIGTERM at step 2 then resume=True, a resume past a torn newest
     checkpoint; both resumed fits end at the fault-free step count with
     the fault-free weights (bit-equal when the two fault-free fits are),
     K1[lse], K2 and K3 each n_layers x the steps executed over every
     attempt; `RecoverySupervisor` against a chaos NaN (halt_on_nonfinite)
     and a chaos hang (the step watchdog): rollback, completion and the
     reference's timeline; the checkpoint's bytes, a sync write's
     seconds, the step with an async checkpoint every step against none,
     a restore's seconds
 20. seq-parallel training at the long-context width (LC_CONFIG, bf16,
     2 x 8192 tokens, data 1 x seq 2 on this card):
     `make_seq_parallel_lm_step` with the differentiable ring flash, 4
     steps of adam, the loss falls, K1[lse], K2 and K3 each n_layers x 3
     block pairs a step (the causal fold rule), counted by their wrappers
     as n_layers x 2 diagonal and n_layers x 1 below it, ms/step beside the
     one-card flash step; f32 gradients at 2 x 2048 against the one-card
     flash step; ulysses and the dense ring fold at a small width against
     the dense step; K1[lse], K2 and K3 at the ring's block shape (2,
     4096, 8, 64) on the diagonal block and the one below it, against
     plain, timed beside their bounds and library calls
 21. vision and tabular scoring (`TPUModel.transform`; convolutions,
     BatchNorm and Dense layers on cuDNN and cuBLAS, no hand-written
     kernel): (a) the zoo ConvNet (ConvNet_UCIDigits, bf16) over 32768
     uint8 32 x 32 x 3 images at miniBatchSize 4096, bench.py
     bench_convnet's configuration: the bf16 arm with prefetch off and on
     and its host / transfer / compute / drain span seconds, an f32 arm
     and an int8 arm with its resident weight bytes; (b) resnet50() at
     full width over 1024 uint8 224 x 224 x 3 images at 256 (bench.py
     bench_resnet50's): computeDtype bfloat16, float32 and the int8
     bundle; (c) the TabularWDBC and TextSentiment MLP bundles over
     seeded 30- and 4096-wide features.  Every arm: rows/s end to end and
     in the device steady state (the stage's forward over batches on the
     card), FLOPs per row and the share of the peak.  Gates: the f32 arm
     (TF32 on globally; the stage turns it off) within 1e-4 of max
     |logit| of the port's CPU f32 forward on the first 256 rows, argmax
     equal where the top-2 gap exceeds 1e-3; bf16 and int8 arms within
     1e-1 of max |logit| of the f32 arm, argmax equal on at least 99% of
     the rows whose top-2 gap exceeds 2^-6 of max |logit|; shapes, no NaN
     or Inf
 22. the image pipeline (`read_images_iter` -> `TPUModel.transform_batches`;
     `ImageTransformer`, `ImageFeaturizer`; torch ops, no hand-written
     kernel): (0) the host's codecs (the native decoder built from
     `mmlspark_tpu_torch/native/decode.cpp`, PIL), each holding a PNG of
     distinct channels; (a) bench.py bench_ingestion's configuration: 768
     PNGs of 224 x 224 x 3 written with the standard library, read in
     batches of 128 with resize_to (224, 224) and scored by the ResNet-50
     of phase 21 at bf16, at depth 0 (the Autotuner), fixed 8 and the hand
     sweep 2-32, each arm 2 times interleaved: median images/s each, the
     fixed-8 / hand-8 gap (one configuration: the noise floor), autotune
     over the best hand arm, the Autotuner's steps and decisions, the
     autotune arm's decode / host / transfer / compute / drain
     thread-seconds (when the host decodes no PNG, (a) starts from the
     pixel arrays and says so); the codec headers on g++'s include path,
     the native build and PIL are printed first; gates: pixels equal the
     written arrays, all rows in order in every arm, streamed scores
     within 1e-3 of max |score| of `transform` over the stacked arrays,
     argmax equal; (b) 1024 seeded 240 x 320 images through
     `ImageTransformer.resize(256, 256).center_crop(224, 224).flip()` and
     `ImageFeaturizer` over that ResNet-50 at f32 (cut 1: pool, 2048; cut
     2: stage4, 7 x 7 x 2048), images/s each; each op alone at (256, 320,
     240, 3) float32 by CUDA events with its bytes and share of 3.35 TB/s;
     gates: each op and the transformer against the port's CPU forward
     (exact for crop, flip, threshold, the channel swap and unroll;
     absolute on the [0, 255] scale: resize 1e-2, blur, gaussian and gray
     1e-3, normalize 1e-5), the featurizer's f32 features within 1e-5 of
     max |feature| of the CPU's, the widths, and three planted faults
     (resize without antialiasing, a 4 x 4 blur padded symmetrically, the
     lanczos3 resize in TF32) rejected by the limit of the op they break
 23. training the vision and tabular models (`Trainer.fit_arrays`,
     `TPULearner.fit`; torch ops, no hand-written kernel): (a) the zoo
     ConvNet at scripts/train_zoo_model.py's configuration (bf16, adam
     1e-3, cosine, batch 128) over 4096 seeded template images, 3 epochs,
     at prefetch_depth -1 and 2, each twice, interleaved: the loss falls,
     train accuracy >= 0.9 through `TPUModel`; (b) resnet50() bf16 over
     uint8 224 x 224 images, batch 128, momentum, 8 steps at prefetch -1
     and 2: finite losses, every batch_stats leaf moved; (c) ResNetDigits
     at f32 (TF32 on around it), 2 steps on the card and on the CPU:
     params and batch_stats within 1e-4 of each leaf's max, torch's
     unbiased running variance planted and rejected; (d) a ResNetDigits
     fit preempted by the chaos hook and resumed (cuDNN deterministic):
     equal to the fault-free fit within the spread of two fault-free
     fits; (e) `TPULearner` -> `TPUModel` over 65536 rows x 30: accuracy
     >= 0.95.  Step ms (CUDA events, median of 5), images/s end to end
     per arm, training FLOPs per image and the share of the bf16 peak,
     peak memory, host / transfer / dispatch / stall seconds
 24. the AutoML layer (`TrainClassifier`, `TrainRegressor`, `Featurize`,
     `TextFeaturizer`, `Word2Vec`, `FindBestModel`,
     `ComputeModelStatistics`, `CheckpointData`; torch ops, no
     hand-written kernel), each fit on the card and on the CPU: (a) the
     census (48842 rows, the UCI Adult's 32561 / 16281 split) through
     example 101's six families, fit and transform seconds, accuracy and
     AUC; card predictions equal to the CPU's on >= 99.9% of the test
     rows per family, the same FindBestModel winner, two RandomForest fits
     bit-equal; (b) flights (125000 rows) through example 102's three
     regressors, R^2 within 1e-4 of the CPU's, LinearRegression's
     coefficients on the collinear featurized matrix within 1e-3 of
     max |w| of float64 lstsq, with the gels solve and the JAX package's
     cutoff read beside the limit; (c) 25000 reviews through example
     201's TextFeaturizer, every ASCII row counted through the fused
     native hasher, the first 2000 byte-identical to the staged path,
     LogisticRegression accuracy within 0.002 of the CPU's, example 202's
     Word2Vec after one pass within 1e-3 of max |v| of the CPU's; (d) the
     zoo ConvNet at f32 over 8192 images from a CheckpointData-cached
     table: scores bit-equal to the plain table's with no host->device
     bytes, and `accuracy_gate` between the f32 and int8 bundles
 25. the mixture-of-experts LM and the population sweep (the MoE
     router and experts are torch ops, no hand-written kernel of their
     own): LM_CONFIG with 8 experts, top 2, groups of 512 (seeded
     weights in the flax layout): (a) `TextGenerator.transform` over the
     phase-6 prompts, 64 greedy tokens, bf16 and an int8 PTQ bundle
     (expert stacks and router left bf16): K1 and K4 counted exactly,
     tokens/s, prefill ms, ms/step and the decode steps' overflow
     fraction; f32 prefill logits against the plain forward (1e-3); f32
     greedy tokens against the recompute oracle at moe_group_size=1
     (>= 0.95 equal); (b) `Trainer.fit_arrays` at phase 7's shape with
     aux_loss_weight 1e-2: the loss falls, K1[lse], K2 and K3 n_layers x
     steps each, history's moe_overflow_fraction, step ms, tokens/s, the
     FLOPs as run, the routing share; (c) one step
     each with no remat, "full" and "save_attention": K1[lse] n / 2n / n,
     the bytes held for the backward none > save_attention > full,
     gradients within 1e-5 of max |g| (bit-equal expected); (d)
     `TrainClassifier(MLP, sweepLearningRates=[4 rates])` on the census
     of phase 24 (a) against 4 serial fits (seconds, member and test
     accuracy), and the same sweep with 2 halving rungs: every culled
     member's stacked tensors byte-unchanged from its rung to the end

 26. the measurement layer (observe/costmodel.py, utils/perf.py, the
     profiler, the report and history CLIs), all under one
     `run_telemetry`, its depth cut to `MEASURE`: (a) `Trainer.fit_arrays`
     at phase 7's shape, 2 steps: the `trainer:` row's counted FLOPs
     less the kernels' within 1% of `lm_train_flops(...)["xla_visible"]`,
     its `kernel_flops` the kernel formulas over the K1[lse] / K2 / K3
     launches of the counted step, MFU on the span-wall basis; (b)
     resnet50() bf16, one batch of 256 at 224 x 224 through
     `TPUModel.transform`: the `tpu_model:` row has a probe time and its
     FLOPs per row within 2% of `flops_per_row` and of `forward_flops`;
     (c) 4 of the phase-6 prompts (buckets 32, 128, 1024, 1984) through
     `TextGenerator`, twice: `decode:` rows for every prefill and segment
     class, `kernel_flops` the K1 / K4 formulas over their launches, the
     warm pass timed on the card; (d) `profile` around one train step:
     the Chrome trace parses and holds `flash_fwd`, `flash_bwd` kernels
     and the `annotate` span; (e) `python -m
     mmlspark_tpu_torch.observe.report` over the run directory prints a
     roofline verdict for (a) and (b), and `observe.history ingest` then
     `check --strict` over the phase's own bench records says `new` then
     `ok`
 27. data parallelism over a mesh of 2 shards on this card
     (`phase_data_parallel`, only the port): (a) the LM at LM_CONFIG's
     width, one batch of 8 x 2048 for 4 steps at data 2 against one
     card from one init: per-step losses within 5e-3 relative, K1[lse],
     K2 and K3 exactly 4 layers x 2 shards x 4 steps = 32 times, every
     Dense call at batch 4, the step's ms at both widths, f32 at 2
     layers with TF32 off: weights within 1e-5 of max |w|; K1[lse], K2,
     K3 checked against plain and timed at the shard shape (4, 2048, 8,
     128); (b) a data-2 checkpoint records data_devices 2 and restores
     onto one card byte for byte, a preemption at step 5 under data 2
     resumes on one card to the fault-free step count; (c) the zoo
     ConvNet's config and resnet50() bf16, 2 steps of 2 x 64: weights and
     batch_stats against one card, a planted per-shard BatchNorm
     rejected; (d) resnet50() bf16 scoring through `TPUModel.set_mesh`
     and from a `CheckpointData` cache over the mesh, held to
     VISION_GATES' bf16 limit against one card; (e) the census sweep at
     data 2, member accuracies against one card's; (f) one data 1 x
     seq 2 ring-flash step: every token-wise layer at S/2 a shard, the
     loss equal to the whole-array forward's
 28. the model axis over meshes of 2 and 4 shards on this card
     (`phase_model_parallel`, only the port): (a) the LM at LM_CONFIG's
     width, 8 x 2048 for 4 steps at data 1 x model 2 against one card
     from one init: losses and grad norms within 5e-3 relative, K1[lse],
     K2 and K3 exactly 4 layers x 2 shards x 4 steps = 32 times on
     (8, 2048, 4, 128), each shard's qkv / mlp_up / lm_head at 1536 /
     2048 / 4096 columns (forward hooks), the step's ms at both, f32 at
     2 layers with TF32 off: the weights by phase 27's share rule; (b)
     that f32 fit's checkpoint and bundle record (data 1, model 2) and
     restore onto one card and onto data 2 x model 2 byte for byte; (c)
     `TextGenerator` at model 2: f32 greedy tokens equal one card's over
     phase 6's prompts with K1 / K4 once a layer a model shard, bf16 and
     int8-cache rows against their floors, a speculative run with the
     draft replicated equal to the plain one; (d) `ServingEngine` over
     data 2 x model 2 at f32: tokens equal one card's, a prefix-pool
     hit; (e) phase 25's MoE LM at model 2 (4 experts a shard): losses,
     overflow and one forward's sown values against one card's, f32
     decode at group size 1 equal; (f) `TPUModel` over (a)'s bundle at
     model 2 and resnet50() bf16 at data 2 x model 2 against one card;
     (g) K1[lse], K2, K3 at (8, 2048, 4, 128), K1 at (2, 1024, 4, 128)
     and K4 at (2, 1152, 4, 128) against plain and timed
 29. pipeline stages and several processes (`phase_pipeline_and_processes`):
     (a) the Trainer's GPipe step at 2 stages on this card against the
     core at one stage; (b) the flash LM over 2 processes sharing the
     card over gloo, bit-equal to the one-process data-2 fit, and
     ResNet-50 with training BatchNorm (its statistics all-reduced over
     the processes) bit-equal likewise; (c) NCCL at world size 1
 30. the data service (`phase_data_service`): phase 22's 768 PNGs ->
     `read_images_iter(service=DataService(workers=w, mode="process"))`
     -> ResNet-50 bf16 `TPUModel.transform_batches`, decode in worker
     processes that see no card: (a) w = 1, 2, 4 beside the local
     reader (time to the first table, steady images/s; rows in order,
     pixels equal, scores within phase 22's limit, no worker holding a
     context on the card); (b) dynamic at 2 workers, every file once;
     (c) a worker killed by the chaos injector, output byte-equal to
     local, the death and the re-dispatch in the `data_service`
     timeline; (d) workers=0, the Autotuner's fleet widths
 31. populations (`phase_populations`, only the port): (a) the LM
     population at LM_CONFIG's width, 4 members at SWEEP_RATES, 2 steps
     of 8 x 2048: K1[lse], K2 and K3 exactly n_layers x steps times each
     whatever the population's size (the members folded into one
     launch), each member's curve within 5e-3 of its plain `Trainer`
     fit, an f32 arm at 2 layers within 2e-5 (weights as POP's note
     says), the folded kernels checked and timed at (32, 2048, 8, 128);
     (b) the f32 population at 2 layers over data 2 x model 2 on this
     card against one card, K1[lse] / K2 / K3 layers x steps x 4 shards;
     (c) a ResNet-18 population with training BatchNorm at data 2 against
     one card at the same global batch, phase 27 (c)'s limits, a planted
     per-shard BatchNorm rejected

Each phase's seconds print on a line of their own (`phase seconds N`) and
as one `{"phase_seconds": ...}` line; the whole run stays under 1000 s.

Kernel and step times come from CUDA events (median after warm-up); each
timed K1 shape also prints its TFLOP/s, its ratio to the library call of
the same run and its share of the bound.  A bound is the largest of the
FLOPs at the peak, the bytes at the HBM rate and the exponentials at the
ex2 rate (`attention_bound`); no gate reads it.
Prints the card line, a JSON line of per-kernel numbers, and last
`{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bytes/s
EX2_PER_CLOCK_SM = 16      # sm_90 special-function units: ex2 a clock an SM

LM_CONFIG = {"vocab_size": 8192, "d_model": 1024, "n_heads": 8,
             "n_layers": 4, "max_len": 2048, "dtype": "bfloat16"}
PROMPT_LENGTHS = (20, 45, 70, 100, 600, 900, 1200, 1500)
MAX_NEW = 64
TRAIN_ROWS, TRAIN_SEQ, TRAIN_BATCH = 16, 2048, 8   # 2 steps per epoch
# the repo's long-context configuration (bench.py bench_lm_long_context):
# head dim 64, context 8192, 32 greedy tokens, batch 2, cache chunk 256
LC_CONFIG = {"vocab_size": 8192, "d_model": 512, "n_heads": 8,
             "n_layers": 4, "max_len": 8448, "dtype": "bfloat16"}
LC_CONTEXT, LC_NEW, LC_BATCH, LC_CHUNK = 8192, 32, 2, 256


def counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel-table name."""
    from mmlspark_tpu_torch.ops.decode_attention import (
        fused_single_query_attention, fused_single_query_attention_stats)
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_with_lse, flash_bwd_dkv,
        flash_bwd_dq)
    return {"flash_attention": flash_attention,
            "flash_attention[lse]": flash_attention_with_lse,
            "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv,
            "fused_single_query_attention": fused_single_query_attention,
            "fused_single_query_attention_stats":
                fused_single_query_attention_stats}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
        if hasattr(fn, "block_launches"):
            fn.block_launches = dict.fromkeys(fn.block_launches, 0)


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def read_block_counts() -> dict:
    """The flash kernels' launches by block kind ("diagonal" where q and k
    start at the same global position, "off-diagonal" elsewhere)."""
    return {name: dict(fn.block_launches) for name, fn in counters().items()
            if hasattr(fn, "block_launches")}


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ||d||_F / ||ref||_F limit of an attention output: the bf16 kernels read
# 2.0e-3 to 2.5e-3 on the H100; a V tile of 64 keys skipped out of 4096
# reads 0.12
OUT_NORM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def out_errs(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|d|, ||d||_F / ||ref||_F) of an attention output.  The absolute
    limit alone is loose at bf16 and long S: |out| is about sqrt(e/n) over
    n visible keys, so a dropped or doubled V tile that leaves the
    log-sum-exp alone moves each entry by less than the limit; the
    norm-relative error sees it."""
    d, r = got.float() - ref.float(), ref.float()
    return d.abs().max().item(), (d.norm()
                                  / r.norm().clamp(min=1e-30)).item()


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call with the host's launch overhead taken out:
    `calls` calls captured in one CUDA graph, the replay timed by CUDA
    events (median of `reps`), divided by `calls`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, warmup=1, reps=reps) / calls


def repeat_and_graph_check(fn, what: str) -> None:
    """Two eager calls of `fn` bitwise equal, and a CUDA graph of one call
    replayed twice equal to them (outputs zeroed before each replay)."""
    def parts(x):
        return x if isinstance(x, tuple) else (x,)
    first, second = parts(fn()), parts(fn())
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(first, second)),
            f"{what}: two calls on the same inputs differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = parts(fn())
    for _ in range(2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(first, captured)),
                f"{what}: a CUDA graph replay differs from an eager call")
    print(f"{what}: two calls bitwise equal; a CUDA graph replayed twice "
          f"equals them")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def engine_mask(b: int, window: int, bucket: int, frontier: int,
                true_len: torch.Tensor) -> torch.Tensor:
    """The decode engine's visibility layout: per-row prompt slots, the pad
    hole up to the bucket, then decode slots bucket..frontier."""
    slots = torch.arange(window, device=true_len.device)
    return ((slots[None] < true_len[:, None])
            | ((slots >= bucket) & (slots <= frontier))[None]).contiguous()


def phase_flash(dev, card) -> dict:
    from mmlspark_tpu_torch.ops.flash_attention import (flash_attention,
                                                        flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, s, dtype):
        return [torch.randn((b, s, 8, 128), generator=gen, device=dev)
                .to(dtype) for _ in range(3)]

    cases = [(2, 512, True, torch.bfloat16), (2, 1024, True, torch.bfloat16),
             (2, 1984, True, torch.bfloat16), (2, 1000, False, torch.bfloat16),
             (2, 700, True, torch.float32)]
    max_err = 0.0
    for b, s, causal, dtype in cases:
        q, k, v = qkv(b, s, dtype)
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, causal=causal)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        err, norm_err = out_errs(got, ref)
        ok = torch.allclose(got.float(), ref.float(), rtol=tol, atol=tol)
        print(f"flash_attention B={b} S={s} causal={causal} {dtype}: "
              f"max_abs_err={err:.3e} (tol {tol}), ||d||/||ref|| "
              f"{norm_err:.3e} (tol {OUT_NORM_TOL[dtype]})")
        require(ok and norm_err <= OUT_NORM_TOL[dtype],
                f"flash kernel disagrees at S={s} {dtype}")
        if dtype == torch.bfloat16 and causal:
            max_err = max(max_err, err)

    # timing at the prefill shape of a full bucket of 8 rows
    b, s, h, d = 8, 1024, 8, 128
    q, k, v = qkv(b, s, torch.bfloat16)
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = graph_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        calls=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)        # QK^T + PV, causal
    nbytes = 4.0 * b * s * h * d * 2                   # q, k, v in; out
    bound, by, term = attention_bound(flops, nbytes,
                                      b * h * visible_pairs(s, s, True))
    print(f"timing flash_attention (8,1024,8,128) causal bf16, device time "
          f"(CUDA graph): {ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({term}); "
          f"{k1_rates(flops, ms, lib_ms, bound)} [{card}]")
    return {"name": "flash_attention", "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_term": term,
            "library_ms": lib_ms}


def exp_rate() -> float:
    """The card's ex2 rate a second: EX2_PER_CLOCK_SM x its SM count x its
    highest SM clock (`nvidia-smi` clocks.max.sm), read once."""
    if exp_rate.detail is None:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        mhz = float(out.stdout.strip().splitlines()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        exp_rate.value = EX2_PER_CLOCK_SM * sms * mhz * 1e6
        exp_rate.detail = (f"{EX2_PER_CLOCK_SM} ex2 a clock an SM x {sms} "
                           f"SMs x {mhz:.0f} MHz clocks.max.sm = "
                           f"{exp_rate.value:.4g} ex2/s")
    return exp_rate.value


exp_rate.value, exp_rate.detail = 0.0, None


def visible_pairs(sq: int, sk: int, causal: bool, q_off: int = 0,
                  k_off: int = 0) -> int:
    """The (query, key) pairs of one (batch, head) that the causal mask at
    global offsets leaves visible (all sq x sk when not causal): the
    exponentials K1, K2 and K3 each take there."""
    if not causal:
        return sq * sk
    return int(np.clip(q_off + np.arange(sq) - k_off + 1, 0, sk).sum())


def attention_bound(flops: float, nbytes: float, exps: float,
                    peak: float = PEAK_BF16_FLOPS) -> tuple:
    """(bound ms, bound_by, term): the largest of three times -- `flops` at
    `peak` FLOP/s (the bf16 tensor-core peak unless given), `nbytes` at the
    HBM rate and `exps` exponentials at the card's ex2 rate (`exp_rate`).
    `term` names the winner ("flops", "bytes" or "exp"); `bound_by` is
    "bytes" for the bytes and "operations" for either count of operations
    at its type's peak."""
    times = {"flops": flops / peak * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3,
             "exp": exps / exp_rate() * 1e3}
    term = max(times, key=times.get)
    return (times[term], "bytes" if term == "bytes" else "operations",
            term)


def k1_rates(flops: float, ms: float, lib_ms: float, bound: float) -> str:
    """A timed K1 shape's rate, its ratio to the library call of the same
    run and its share of the bound."""
    return (f"K1 {flops / ms / 1e9:.1f} TFLOP/s, {ms / lib_ms:.2f}x the "
            f"library call, {bound / ms:.3f} of the bound")


MANGLED_TYPES = (("13__nv_bfloat16", "bf16"), ("f", "f32"), ("a", "int8"))


def short_kernel_name(mangled: str, prefix: str) -> str:
    """`flash_fwd_bf16<128>` for a kernel templated on its head dim;
    `sqa_forward<q bf16, cache int8, 64>` for the decode kernels, whose
    template names the q and cache types (a repeated type is a mangling
    back-reference, S<n>_); else the mangled name."""
    found = re.search("(" + prefix + r"\w*?)ILi(\d+)E", mangled)
    if found:
        return f"{found.group(1)}<{found.group(2)}>"
    found = re.search("(" + prefix + r"\w*?)I(\w+?)Li(\d+)ELb", mangled)
    if not found:
        return mangled
    types, rest = [], found.group(2)
    while rest:
        back = re.match(r"S\w*?_", rest)
        if back:
            types.append(types[-1])
            rest = rest[back.end():]
            continue
        code, word = next(((c, w) for c, w in MANGLED_TYPES
                           if rest.startswith(c)), (rest, rest))
        types.append(word)
        rest = rest[len(code):]
    return (f"{found.group(1)}<q {types[0]}, cache {types[-1]}, "
            f"{found.group(3)}>")


def ptxas_report(name: str, prefix: str) -> list:
    """Registers, static shared memory and spills of each kernel of library
    `name` whose symbol holds `prefix`, read from the `-Xptxas -v` build
    log beside the library (`native.build`)."""
    from mmlspark_tpu_torch.ops import native
    rows, kernel, spills = [], None, (0, 0)
    with open(native.library_path(name)[:-3] + ".log") as f:
        for line in f:
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                kernel = found.group(1)
                continue
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if found:
                spills = (int(found.group(1)), int(found.group(2)))
            found = re.search(r"Used (\d+) registers(.*)", line)
            if found and kernel and prefix in kernel:
                smem = re.search(r"(\d+) bytes smem", found.group(2))
                rows.append({
                    "kernel": short_kernel_name(kernel, prefix),
                    "registers": int(found.group(1)),
                    "static_smem_bytes": int(smem.group(1)) if smem else 0,
                    "spill_stores": spills[0], "spill_loads": spills[1]})
                kernel = None
    return rows


def phase_flash_lse(dev, card) -> dict:
    from mmlspark_tpu_torch.ops.attention import NEG_INF
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse, flash_attention_with_lse_plain)
    gen = torch.Generator(device=dev).manual_seed(2)

    def rand(b, s, dtype):
        return torch.randn((b, s, 8, 128), generator=gen, device=dev).to(dtype)

    # (B, Sq, Sk, q_offset, k_offset, dtype)
    cases = [(2, 512, 512, 0, 0, torch.bfloat16),
             (2, 2048, 2048, 0, 0, torch.bfloat16),
             (2, 1000, 1000, 0, 0, torch.bfloat16),
             (2, 512, 512, 512, 0, torch.bfloat16),
             (2, 512, 512, 0, 200, torch.bfloat16),   # 200 fully masked rows
             (2, 700, 700, 0, 0, torch.float32)]
    max_err = 0.0
    for b, sq, sk, q_off, k_off, dtype in cases:
        q, k, v = rand(b, sq, dtype), rand(b, sk, dtype), rand(b, sk, dtype)
        out, lse = flash_attention_with_lse(q, k, v, True, None, q_off, k_off)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, True, None,
                                                          q_off, k_off)
        bf16 = dtype == torch.bfloat16
        out_tol, lse_tol = (2e-2, 1e-3) if bf16 else (1e-4, 1e-4)
        err, norm_err = out_errs(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"flash_attention_with_lse B={b} Sq={sq} Sk={sk} "
              f"q_offset={q_off} k_offset={k_off} {dtype}: out "
              f"max_abs_err={err:.3e} (tol {out_tol}), ||d||/||ref|| "
              f"{norm_err:.3e} (tol {OUT_NORM_TOL[dtype]}), lse "
              f"max_abs_err={lse_err:.3e} (tol {lse_tol})")
        require(err <= out_tol and norm_err <= OUT_NORM_TOL[dtype]
                and lse_err <= lse_tol,
                f"flash lse kernel disagrees at Sq={sq} offsets "
                f"{q_off}/{k_off} {dtype}")
        if k_off > q_off:
            masked = k_off - q_off
            require(bool((lse[:, :masked] <= NEG_INF / 2).all()) and
                    torch.count_nonzero(out[:, :masked]).item() == 0,
                    "fully masked rows are not zero / NEG_INF")
        if bf16:
            max_err = max(max_err, err)

    # timing at the training shape: every block's forward
    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 8, 128
    q, k, v = (rand(b, s, torch.bfloat16) for _ in range(3))
    ms = graph_ms(lambda: flash_attention_with_lse(q, k, v, True))
    plain_ms = graph_ms(lambda: flash_attention_with_lse_plain(q, k, v, True),
                        calls=3)
    # the library call with the same outputs: PyTorch's flash forward,
    # which returns the log-sum-exp too (in (B, H, S))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(
        lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True))
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)        # QK^T + PV, causal
    nbytes = 4.0 * b * s * h * d * 2 + b * s * h * 4    # q, k, v, out; lse
    bound, bound_by, term = attention_bound(flops, nbytes,
                                            b * h * visible_pairs(s, s, True))
    print(f"timing flash_attention_with_lse (8,2048,8,128) causal bf16, "
          f"device time (CUDA graph): {ms:.4f} ms; plain {plain_ms:.4f} ms; "
          f"aten flash forward with lse {lib_ms:.4f} ms; bound {bound:.4f} "
          f"ms ({term}); {k1_rates(flops, ms, lib_ms, bound)} [{card}]")
    return {"name": "flash_attention[lse]", "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "bound_term": term,
            "library_ms": lib_ms}


def phase_backward(dev, card) -> list:
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_with_lse_plain,
        flash_block_grads_plain, flash_bwd_dkv, flash_bwd_dq)
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand(b, s, dtype, d=128):
        return torch.randn((b, s, 8, d), generator=gen, device=dev).to(dtype)

    def check_grads(what, got, ref, dtype):
        # bf16: max 2e-2 and norm 1e-2 of the reference; f32: 1e-4 both
        max_tol, norm_tol = (2e-2, 1e-2) if dtype == torch.bfloat16 else (
            1e-4, 1e-4)
        errs_ = [grad_errs(a, r) for a, r in zip(got, ref)]
        print(f"{what}: max|d|/max|ref| dq {errs_[0][0]:.3e} dk "
              f"{errs_[1][0]:.3e} dv {errs_[2][0]:.3e} (tol {max_tol}); "
              f"||d||/||ref|| dq {errs_[0][1]:.3e} dk {errs_[1][1]:.3e} dv "
              f"{errs_[2][1]:.3e} (tol {norm_tol})")
        require(all(m <= max_tol and n <= norm_tol for m, n in errs_),
                f"{what} disagrees")

    # (B, Sq, Sk, causal, q_offset, k_offset, dtype, head dim)
    cases = [(2, 512, 512, True, 0, 0, torch.bfloat16, 128),
             (2, 2048, 2048, True, 0, 0, torch.bfloat16, 128),
             (2, 1000, 1000, True, 0, 0, torch.bfloat16, 128),
             (2, 768, 1280, False, 0, 0, torch.bfloat16, 128),
             (2, 512, 512, True, 512, 256, torch.bfloat16, 128),
             (2, 129, 129, True, 0, 0, torch.bfloat16, 128),
             (2, 2048, 2048, True, 0, 0, torch.bfloat16, 64),
             (2, 700, 700, True, 0, 0, torch.float32, 128),
             (2, 1000, 1000, True, 0, 0, torch.float32, 64)]
    errs = {"dq": 0.0, "dkv": 0.0}
    for b, sq, sk, causal, q_off, k_off, dtype, d in cases:
        scale = d ** -0.5
        args = backward_inputs(gen, b, sq, sk, causal, q_off, k_off, dtype,
                               d)
        dq = flash_bwd_dq(*args, causal, scale, q_off, k_off)
        dk, dv = flash_bwd_dkv(*args, causal, scale, q_off, k_off)
        torch.cuda.synchronize()
        ref = flash_block_grads_plain(*args, causal, scale, q_off, k_off)
        check_grads(f"flash backward B={b} Sq={sq} Sk={sk} D={d} "
                    f"causal={causal} offsets {q_off}/{k_off} {dtype}",
                    (dq, dk, dv), ref, dtype)
        if dtype == torch.bfloat16 and sq == 2048:
            # one writer per output, no atomics: a second launch on the
            # same inputs gives the same bits
            again = (flash_bwd_dq(*args, causal, scale, q_off, k_off),
                     *flash_bwd_dkv(*args, causal, scale, q_off, k_off))
            torch.cuda.synchronize()
            same = all(torch.equal(a, r)
                       for a, r in zip(again, (dq, dk, dv)))
            print(f"flash backward D={d} repeat: bitwise equal {same}")
            require(same, f"two backward launches differ at D={d}")
        if dtype == torch.bfloat16:
            errs["dq"] = max(errs["dq"], (dq.float() - ref[0].float()).abs()
                             .max().item())
            errs["dkv"] = max(errs["dkv"], *((a.float() - r.float()).abs()
                                             .max().item()
                                             for a, r in zip((dk, dv),
                                                             ref[1:])))

    # the autograd wiring: grads through flash_attention vs plain autograd
    for s, dtype in ((2048, torch.bfloat16), (700, torch.float32)):
        q, k, v, do = (rand(2, s, dtype).requires_grad_() for _ in range(4))
        got = torch.autograd.grad(flash_attention(q, k, v, causal=True),
                                  (q, k, v), do.detach())
        torch.cuda.synchronize()
        ref = torch.autograd.grad(
            flash_attention_with_lse_plain(q, k, v, True)[0], (q, k, v),
            do.detach())
        check_grads(f"autograd through flash_attention S={s} {dtype} vs "
                    f"plain autograd", got, ref, dtype)

    # timing at the training shape: every block's backward; head dim 64
    # (the long-context width) printed beside it
    timed = time_backward(card, gen, 128)
    time_backward(card, gen, 64)
    entries = []
    for name, err in (("flash_bwd_dq", errs["dq"]),
                      ("flash_bwd_dkv", errs["dkv"])):
        entries.append({
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_backward.cu",
            "replaces": ("mmlspark_tpu/ops/flash_attention.py:318"
                         if name == "flash_bwd_dq" else
                         "mmlspark_tpu/ops/flash_attention.py:330"),
            "max_abs_err": err, **timed[name]})
    return entries


def backward_inputs(gen, b, sq, sk, causal, q_off, k_off, dtype, d=128,
                    h=8):
    """q, k, v, dout (B, S, h, d) from `gen`, and the plain forward's lse
    and delta = rowsum(dout * out)."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse_plain)

    def rand(s):
        return torch.randn((b, s, h, d), generator=gen,
                           device=gen.device).to(dtype)
    q, do, k, v = rand(sq), rand(sq), rand(sk), rand(sk)
    out, lse = flash_attention_with_lse_plain(q, k, v, causal, None, q_off,
                                              k_off)
    return q, k, v, do, lse, (do.float() * out.float()).sum(-1)


def grad_errs(got, ref) -> tuple:
    """(max|d|/max|ref|, ||d||_F/||ref||_F).  The first is loose at bf16
    (the first rows' gradients are far larger than a late row's, so its
    limit exceeds a late entry); the norm-relative error sees a tile of
    keys or queries dropped or counted twice."""
    d, r = got.float() - ref.float(), ref.float()
    return (d.abs().max() / r.abs().max()).item(), (d.norm()
                                                    / r.norm()).item()


def time_backward(card, gen, d: int, dtype=torch.bfloat16,
                  args: Optional[tuple] = None,
                  shape: Optional[tuple] = None, offsets: tuple = (0, 0),
                  lib_causal: bool = True) -> dict:
    """K2 and K3 at (B, S, H, d) causal, (B, S, H) = `shape` (default the
    training shape (8, 2048, 8)), q and k at global `offsets`, against the
    plain version and the library's backward pair, all from CUDA graphs:
    per kernel its ms, plain_ms, bound_ms, bound_by and library_ms (the
    pair).  The library pair is PyTorch's flash backward on its own
    forward's saved outputs at bf16, its memory-efficient backward
    (`aten._efficient_attention_backward`, the port's (B, S, H, D) layout)
    at f32, causal from the top left when `lib_causal` (the mask the
    offsets leave: a diagonal block is causal, one wholly below it is
    not).  `args`: the inputs of `backward_inputs` at that shape and those
    offsets, made here when not given."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_block_grads_plain, flash_bwd_dkv, flash_bwd_dq)
    b, s, h = shape or (TRAIN_BATCH, TRAIN_SEQ, 8)
    scale = d ** -0.5
    bf16 = dtype == torch.bfloat16
    tag = "bf16" if bf16 else "f32"
    if offsets != (0, 0):
        tag += f" at offsets {offsets[0]}/{offsets[1]}"
    if args is None:
        args = backward_inputs(gen, b, s, s, True, *offsets, dtype, d, h)
    kw = {"q_offset": offsets[0], "k_offset": offsets[1]}
    dq_ms = graph_ms(lambda: flash_bwd_dq(*args, True, scale, **kw))
    dkv_ms = graph_ms(lambda: flash_bwd_dkv(*args, True, scale, **kw))
    plain_ms = graph_ms(
        lambda: flash_block_grads_plain(*args, True, scale, **kw), calls=3)
    lib = "aten flash backward" if bf16 else "aten efficient backward"
    if bf16:
        q, k, v, do = (t.transpose(1, 2) for t in args[:4])
        saved = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, lib_causal, scale=scale)
        out, lse, cum_q, cum_k, max_q, max_k, seed, offset = saved[:8]

        def lib_backward():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0,
                lib_causal, seed, offset, scale=scale)
    else:
        q, k, v, do = args[:4]
        # custom_mask_type 1: causal from the top-left
        mask = 1 if lib_causal else 0
        out, lse, seed, offset = torch.ops.aten._efficient_attention_forward(
            q, k, v, None, None, None, None, None, 0.0, mask, True,
            scale=scale)[:4]

        def lib_backward():
            return torch.ops.aten._efficient_attention_backward(
                do, q, k, v, None, out, None, None, s, s, lse, 0.0, seed,
                offset, mask, False, scale=scale)
    lib_ms = library_ms(lib_backward, f"{lib} at D={d} {tag}")
    lib_dq = lib_backward()[0]
    if bf16:
        lib_dq = lib_dq.transpose(1, 2)
    ref_dq = flash_block_grads_plain(*args, True, scale, **kw)[0]
    lib_err = grad_errs(lib_dq, ref_dq)[1]
    print(f"{lib} D={d} {tag} dq vs plain: ||d||/||ref|| {lib_err:.3e}")
    require(lib_err <= (1e-2 if bf16 else 1e-4),
            "the library backward is not the same function")
    del out, lse, lib_dq, ref_dq
    tri = visible_pairs(s, s, True, *offsets)
    item = args[0].element_size()
    io = 4.0 * b * s * h * d * item + 2.0 * b * s * h * 4  # q, k, v, dO; lse, delta
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    timed = {}
    for name, ms, products, outs in (("flash_bwd_dq", dq_ms, 3, 1),
                                     ("flash_bwd_dkv", dkv_ms, 4, 2)):
        flops = products * 2.0 * b * h * d * tri
        # each kernel recomputes P: one exponential a visible pair
        bound, bound_by, term = attention_bound(
            flops, io + outs * b * s * h * d * item, b * h * tri, peak)
        print(f"timing {name} ({b},{s},{h},{d}) causal {tag}, device time "
              f"(CUDA graph): {ms:.4f} ms; plain (dq, dk, dv together) "
              f"{plain_ms:.4f} ms; {lib} (pair, CUDA graph) {lib_ms:.4f} "
              f"ms; bound {bound:.4f} ms ({term}); "
              f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / lib_ms:.2f}x the "
              f"library pair, {bound / ms:.3f} of the bound [{card}]")
        timed[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by, "bound_term": term,
                       "library_ms": lib_ms}
    pair_bound = sum(t["bound_ms"] for t in timed.values())
    print(f"timing K2 + K3 ({b},{s},{h},{d}) causal {tag}: "
          f"{dq_ms + dkv_ms:.4f} ms, {(dq_ms + dkv_ms) / lib_ms:.2f}x the "
          f"library pair, {pair_bound / (dq_ms + dkv_ms):.3f} of the bound "
          f"[{card}]")
    del args
    torch.cuda.empty_cache()
    return timed


def phase_decode(dev, card) -> list:
    from mmlspark_tpu_torch.ops.decode_attention import (
        _sm_count, _span_plan, fused_single_query_attention,
        fused_single_query_attention_plain)
    from mmlspark_tpu_torch.quant.quantize import quantize_kv
    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, d = 8, 8, 128

    def case(window):
        bucket = window - 128 if window > 128 else 64
        q = torch.randn((b, h, d), generator=gen, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((b, window, h, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        true_len = torch.randint(1, bucket + 1, (b,), generator=gen,
                                 device=dev)
        visible = engine_mask(b, window, bucket, bucket + 40, true_len)
        visible[-1] = False                       # a fully masked row
        return q, k, v, visible

    errs = {"model": 0.0, "int8": 0.0}
    for window in (128, 1152, 2048):
        q, k, v, visible = case(window)
        for kind in ("model", "int8"):
            kw, kc, vc = {}, k, v
            if kind == "int8":
                (kc, ks), (vc, vs) = quantize_kv(k), quantize_kv(v)
                kw = dict(k_scale=ks, v_scale=vs)
            got = fused_single_query_attention(q, kc, vc, visible, **kw)
            torch.cuda.synchronize()
            ref = fused_single_query_attention_plain(q, kc, vc, visible, **kw)
            err = (got - ref).abs().max().item()
            print(f"fused_single_query_attention L={window} cache={kind}: "
                  f"max_abs_err={err:.3e} (tol 2e-3)")
            require(err <= 2e-3, f"decode kernel disagrees at L={window} "
                                 f"{kind}")
            require(torch.count_nonzero(got[-1]).item() == 0,
                    "fully masked row is not zero")
            errs[kind] = max(errs[kind], err)

    # timing at (8, 1152, 8, 128): the first decode window of a 1024 bucket
    window, bucket = 1152, 1024
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, window, h, d), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    true_len = torch.randint(600, bucket + 1, (b,), generator=gen, device=dev)
    visible = engine_mask(b, window, bucket, bucket + 63, true_len)
    n_visible = int(visible.sum().item())
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    entries = []
    span, n_spans = _span_plan(window, b * h, _sm_count(q.device))
    for kind, kc, vc, kw in (("model", k, v, {}),
                             ("int8", kq, vq, dict(k_scale=ks, v_scale=vs))):
        def call():
            return fused_single_query_attention(q, kc, vc, visible, **kw)
        repeat_and_graph_check(call, f"fused_single_query_attention "
                                     f"(8,1152,8,128) cache={kind}")
        ms = graph_ms(call)
        call_ms = cuda_ms(call)
        plain_ms = graph_ms(lambda: fused_single_query_attention_plain(
            q, kc, vc, visible, **kw))
        lib_ms = None
        if kind == "model":
            mask = visible[:, None, None, :]
            lib_ms = graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask))
        # bytes this run's data needs: K and V rows of the visible slots,
        # their scales, the mask, q in, f32 out
        item = kc.element_size()
        nbytes = (2.0 * n_visible * h * d * item + b * window
                  + q.numel() * 2 + b * h * d * 4)
        if kind == "int8":
            nbytes += 2.0 * n_visible * h * 4
        flops = 4.0 * n_visible * h * d
        bound, by, term = attention_bound(flops, nbytes, n_visible * h,
                                          PEAK_F32_FLOPS)
        print(f"timing fused_single_query_attention (8,1152,8,128) "
              f"cache={kind}, {n_spans} spans of {span} slots, device time "
              f"(CUDA graph): {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s); one eager call incl. host "
              f"launch {call_ms:.4f} ms; plain {plain_ms:.4f} ms; SDPA "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
              f"{bound:.4f} ms ({term}), {bound / ms:.3f} of it [{card}]")
        entries.append({
            "name": ("fused_single_query_attention" if kind == "model"
                     else "fused_single_query_attention[int8]"),
            "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/decode_attention.cu",
            "replaces": "mmlspark_tpu/ops/decode_attention.py:245",
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_term": term,
            "library_ms": lib_ms})
    return entries


def phase_main_path(dev, card) -> dict:
    from mmlspark_tpu_torch import DataTable, ModelBundle, TextGenerator
    from mmlspark_tpu_torch.core.table import object_column
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    _forward_with_cache,
                                                    naive_generate)
    from mmlspark_tpu_torch.ops.flash_attention import flash_attention

    bundle = ModelBundle.init("TransformerLM", LM_CONFIG, seed=0)
    rng = np.random.default_rng(1)
    rows = [rng.integers(0, LM_CONFIG["vocab_size"], n).astype(np.int32)
            for n in PROMPT_LENGTHS]
    table = DataTable({"prompt": object_column(rows)})
    counts = {}
    tokens_per_s = {}
    for kv in (None, "int8"):
        stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                              maxNewTokens=MAX_NEW, kvCacheDtype=kv)
        stage.transform(table)                    # warm-up: load, init
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = stage.transform(table)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = read_counts()
        counts[kv or "model"] = (launched["flash_attention"],
                                 launched["fused_single_query_attention"])
        for r, o in zip(rows, out["generated"]):
            require(len(o) == len(r) + MAX_NEW, "row length")
            require(np.array_equal(o[:len(r)], r), "prompt not kept")
            require(((o >= 0) & (o < LM_CONFIG["vocab_size"])).all(),
                    "token outside the vocabulary")
        tokens_per_s[kv or "model"] = len(rows) * MAX_NEW / seconds
        print(f"main path kv={kv or 'model'}: {len(rows)} rows x {MAX_NEW} "
              f"tokens in {seconds * 1e3:.1f} ms = "
              f"{tokens_per_s[kv or 'model']:.1f} tokens/s; launches "
              f"flash={counts[kv or 'model'][0]} "
              f"decode={counts[kv or 'model'][1]} [{card}]")
        require(counts[kv or "model"][0] > 0, "flash kernel not launched")
        require(counts[kv or "model"][1] > 0, "decode kernel not launched")

    # per-phase device time of the largest bucket (1984: two rows)
    stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                          maxNewTokens=MAX_NEW)
    engine = stage._engine_for()
    long_rows = rows[6:]
    bucket = engine.bucket_for(max(map(len, long_rows)))
    prompts = torch.zeros((len(long_rows), bucket), dtype=torch.long,
                          device=dev)
    for j, r in enumerate(long_rows):
        prompts[j, :len(r)] = torch.from_numpy(r.astype(np.int64))
    tl = torch.tensor([len(r) for r in long_rows], device=dev)
    live = torch.ones(len(long_rows), dtype=torch.bool, device=dev)
    seeds = [0] * len(long_rows)
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: engine.prefill(prompts, tl, live, seeds),
                             warmup=2, reps=5)
        tok, done, caches = engine.prefill(prompts, tl, live, seeds)
        steps = 32
        window = -(-(bucket + steps) // engine.chunk) * engine.chunk
        seg_ms = cuda_ms(lambda: engine.decode_segment(
            steps, window, caches, tok, done, tl, bucket, 0, seeds),
            warmup=1, reps=5)
    print(f"timing main path bucket {bucket} x {len(long_rows)} rows: "
          f"prefill {prefill_ms:.3f} ms; decode {seg_ms / steps:.3f} "
          f"ms/step (window {window}) [{card}]")

    # f32: the kernel path's prefill logits against the plain forward, and
    # greedy tokens against the recompute oracle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle32 = ModelBundle("TransformerLM", {**LM_CONFIG, "dtype": "float32"},
                           bundle.variables)
    module32 = bundle32.module(dev)
    mid = rows[4:6]                                # bucket 1024
    p = 1024
    prompts = torch.zeros((len(mid), p), dtype=torch.long, device=dev)
    for j, r in enumerate(mid):
        prompts[j, :len(r)] = torch.from_numpy(r.astype(np.int64))
    shape = (len(mid), p + 128, LM_CONFIG["n_heads"],
             LM_CONFIG["d_model"] // LM_CONFIG["n_heads"])
    caches = [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
              for _ in range(LM_CONFIG["n_layers"])]
    with torch.inference_mode():
        before = flash_attention.launches
        kernel_logits = _forward_with_cache(ServingWeights(module32),
                                            prompts, caches, 0)
        require(flash_attention.launches > before, "f32 prefill skipped flash")
        plain_logits = module32(prompts)
    logit_err = (kernel_logits - plain_logits).abs().max().item()
    print(f"f32 prefill logits (bucket 1024) kernel vs plain forward: "
          f"max_abs_err={logit_err:.3e} (tol 1e-3)")
    require(logit_err <= 1e-3, "f32 prefill logits disagree")

    out = TextGenerator(bundle32, device=dev, inputCol="prompt",
                        maxNewTokens=MAX_NEW).transform(table)
    matches = total = 0
    for r, o in zip(rows, out["generated"]):
        ref = naive_generate(module32, r[None], MAX_NEW)[0]
        matches += int((o[len(r):] == ref[len(r):]).sum())
        total += MAX_NEW
    print(f"f32 greedy tokens kernel path vs recompute oracle: "
          f"{matches}/{total} = {matches / total:.4f} match")
    return {"counts": counts, "tokens_per_s": tokens_per_s,
            "prefill_ms": prefill_ms, "decode_ms_per_step": seg_ms / steps,
            "greedy_match_f32": matches / total}


def stats_bound(b: int, h: int, d: int, n_visible: int, window: int,
                item: int, quantized: bool) -> tuple:
    """`attention_bound` of one single-query cache read: the K and V rows
    of the visible slots (and their int8 scales), the mask, q in and the
    f32 outputs, over the HBM rate; its 4 f32 FLOPs per visible element
    over the f32 peak; one exponential per visible slot and head."""
    nbytes = (2.0 * n_visible * h * d * item + b * window + b * h * d * 4
              + b * h * d * 4 + 2 * b * h * 4)
    if quantized:
        nbytes += 2.0 * n_visible * h * 4
    return attention_bound(4.0 * n_visible * h * d, nbytes, n_visible * h,
                           PEAK_F32_FLOPS)


def phase_decode_stats(dev, card) -> list:
    """K4[stats] against its plain version: bf16 caches and int8 caches
    (with f32 q), head dims 64 and 128, the long-context slab
    (2, 4224, 8, 64) and a window that is not a multiple of SPLIT; the
    fully masked last row must be exactly the merge identity.  Tolerances:
    acc and l within 1e-4 of their largest |value|, m within 1e-4
    absolute (f32 arithmetic on both sides, summed in another order).
    Then the times of K4[stats] at the slab and of K4 at head dim 64 on
    the seq=1 engine's window (2, 8448, 8, 64)."""
    from mmlspark_tpu_torch.ops.attention import NEG_INF
    from mmlspark_tpu_torch.ops.decode_attention import (
        SPLIT, _sm_count, _span_plan, fused_single_query_attention,
        fused_single_query_attention_plain,
        fused_single_query_attention_stats,
        fused_single_query_attention_stats_plain)
    from mmlspark_tpu_torch.quant.quantize import quantize_kv
    gen = torch.Generator(device=dev).manual_seed(5)
    b, h = LC_BATCH, LC_CONFIG["n_heads"]
    slab = (LC_CONTEXT + LC_CHUNK) // 2       # one of two shards' window

    def inputs(window, d, kind, full=False):
        q = torch.randn((b, h, d), generator=gen, device=dev).to(
            torch.float32 if kind == "int8" else torch.bfloat16)
        k, v = (torch.randn((b, window, h, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        # the second shard's layout: prompt slots, a hole, decode slots
        slots = torch.arange(window, device=dev)
        hole = window - window // 16
        visible = ((slots < window - window // 8)
                   | ((slots >= hole) & (slots <= hole + 5)))
        visible = visible[None].repeat(b, 1)
        if full:
            visible[:] = True
        else:
            visible[-1] = False
        kw = {}
        if kind == "int8":
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            kw = dict(k_scale=ks, v_scale=vs)
        return q, k, v, visible.contiguous(), kw

    errs = {"model": 0.0, "int8": 0.0}
    ragged = SPLIT * 15 + 37
    for window, d, kind in ((slab, 64, "model"), (slab, 64, "int8"),
                            (slab, 128, "model"), (slab, 128, "int8"),
                            (ragged, 64, "model"), (ragged, 128, "int8")):
        q, k, v, visible, kw = inputs(window, d, kind)
        acc, m, l = fused_single_query_attention_stats(q, k, v, visible, **kw)
        torch.cuda.synchronize()
        r_acc, r_m, r_l = fused_single_query_attention_stats_plain(
            q, k, v, visible, **kw)
        e_acc = ((acc - r_acc).abs().max() / r_acc.abs().max()).item()
        e_l = ((l - r_l).abs().max() / r_l.abs().max()).item()
        e_m = (m[:-1] - r_m[:-1]).abs().max().item()
        abs_err = max((acc - r_acc).abs().max().item(), e_m,
                      (l - r_l).abs().max().item())
        print(f"fused_single_query_attention_stats B={b} L={window} H={h} "
              f"D={d} cache={kind} q={q.dtype}: acc {e_acc:.3e}, l "
              f"{e_l:.3e} of max|ref| (tol 1e-4); m max_abs_err {e_m:.3e} "
              f"(tol 1e-4)")
        require(e_acc <= 1e-4 and e_l <= 1e-4 and e_m <= 1e-4,
                f"stats kernel disagrees at L={window} D={d} {kind}")
        require(bool((m[-1] == NEG_INF).all()) and bool((l[-1] == 0).all())
                and torch.count_nonzero(acc[-1]).item() == 0,
                "a fully masked row is not m = NEG_INF, l = 0, acc = 0")
        errs[kind] = max(errs[kind], abs_err)

    entries = []
    for kind in ("model", "int8"):
        q, k, v, visible, kw = inputs(slab, 64, kind, full=True)
        span, n_spans = _span_plan(slab, b * h, _sm_count(q.device))
        repeat_and_graph_check(
            lambda: fused_single_query_attention_stats(q, k, v, visible,
                                                       **kw),
            f"fused_single_query_attention_stats ({b},{slab},{h},64) "
            f"cache={kind}")
        ms = graph_ms(lambda: fused_single_query_attention_stats(
            q, k, v, visible, **kw))
        plain_ms = graph_ms(lambda: fused_single_query_attention_stats_plain(
            q, k, v, visible, **kw))
        bound, bound_by, term = stats_bound(
            b, h, 64, int(visible.sum().item()), slab, k.element_size(),
            kind == "int8")
        print(f"timing fused_single_query_attention_stats ({b},{slab},{h},64)"
              f" cache={kind}, every slot visible, {n_spans} spans of {span}"
              f" slots, device time (CUDA graph): {ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms; library none (no PyTorch call returns "
              f"the unnormalized triple); bound {bound:.4f} ms ({term}),"
              f" {bound / ms:.3f} of it [{card}]")
        entries.append({
            "name": ("fused_single_query_attention_stats" if kind == "model"
                     else "fused_single_query_attention_stats[int8]"),
            "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/decode_attention.cu",
            "replaces": "mmlspark_tpu/ops/decode_attention.py:245 "
                        "(fused_single_query_attention_stats, :326)",
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "bound_term": term,
            "library_ms": None})

    # K4 at head dim 64 on the seq=1 engine's window
    window, bucket = LC_CONTEXT + LC_CHUNK, LC_CONTEXT
    q = torch.randn((b, h, 64), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, window, h, 64), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    visible = engine_mask(b, window, bucket, bucket + 15,
                          torch.full((b,), bucket, device=dev))
    got = fused_single_query_attention(q, k, v, visible)
    torch.cuda.synchronize()
    err = (got - fused_single_query_attention_plain(q, k, v, visible)
           ).abs().max().item()
    require(err <= 2e-3, "decode kernel disagrees at head dim 64")
    repeat_and_graph_check(
        lambda: fused_single_query_attention(q, k, v, visible),
        f"fused_single_query_attention ({b},{window},{h},64)")
    span, n_spans = _span_plan(window, b * h, _sm_count(q.device))
    ms = graph_ms(lambda: fused_single_query_attention(q, k, v, visible))
    plain_ms = graph_ms(lambda: fused_single_query_attention_plain(
        q, k, v, visible))
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=visible[:, None, None, :]))
    bound, bound_by, term = stats_bound(b, h, 64, int(visible.sum().item()),
                                        window, 2, False)
    print(f"fused_single_query_attention ({b},{window},{h},64) bf16 cache: "
          f"max_abs_err={err:.3e} (tol 2e-3); {n_spans} spans of {span} "
          f"slots; device time (CUDA graph) {ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms ({ms / lib_ms:.2f}x); "
          f"bound {bound:.4f} ms ({term}), {bound / ms:.3f} of it "
          f"[{card}]")
    entries.append({
        "name": "fused_single_query_attention[d64]", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/decode_attention.cu",
        "replaces": "mmlspark_tpu/ops/decode_attention.py:245",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "bound_term": term,
        "library_ms": lib_ms})
    return entries


def phase_ring_lse(dev, card) -> list:
    """K1[lse] at head dim 64 against plain on the ring prefill's (shard,
    block) pairs of two shards: (2, 4096, 8, 64) causal with q_offset /
    k_offset 0/0, 4096/0 and 4096/4096 in bf16, 4096/0 in f32; and K1 on
    the seq=1 engine's whole prompt (2, 8192, 8, 64).  Tolerances at bf16:
    out within 2e-2 absolute AND ||d||_F within 1e-2 of ||ref||_F (see
    `out_errs`), lse within 1e-3; 1e-4 each at f32.  Then the times of
    both."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain, flash_attention_with_lse,
        flash_attention_with_lse_plain)
    gen = torch.Generator(device=dev).manual_seed(6)
    b, h, s_l = LC_BATCH, LC_CONFIG["n_heads"], LC_CONTEXT // 2

    def rand(s, dtype):
        return torch.randn((b, s, h, 64), generator=gen, device=dev).to(dtype)

    max_err = 0.0
    for q_off, k_off, dtype in ((0, 0, torch.bfloat16),
                                (s_l, 0, torch.bfloat16),
                                (s_l, s_l, torch.bfloat16),
                                (s_l, 0, torch.float32)):
        q, k, v = (rand(s_l, dtype) for _ in range(3))
        out, lse = flash_attention_with_lse(q, k, v, True, None, q_off, k_off)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, True, None,
                                                          q_off, k_off)
        bf16 = dtype == torch.bfloat16
        out_tol, lse_tol = (2e-2, 1e-3) if bf16 else (1e-4, 1e-4)
        err, norm_err = out_errs(out, ref_out)
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"flash_attention_with_lse B={b} S={s_l} H={h} D=64 causal "
              f"q_offset={q_off} k_offset={k_off} {dtype}: out "
              f"max_abs_err={err:.3e} (tol {out_tol}), ||d||/||ref|| "
              f"{norm_err:.3e} (tol {OUT_NORM_TOL[dtype]}), lse max_abs_err="
              f"{lse_err:.3e} (tol {lse_tol})")
        require(err <= out_tol and norm_err <= OUT_NORM_TOL[dtype]
                and lse_err <= lse_tol,
                f"flash lse kernel disagrees at head dim 64, offsets "
                f"{q_off}/{k_off} {dtype}")
        if bf16:
            max_err = max(max_err, err)

    # the full off-diagonal pair: every key visible to every query
    q, k, v = (rand(s_l, torch.bfloat16) for _ in range(3))
    ms = graph_ms(lambda: flash_attention_with_lse(q, k, v, True, None, s_l,
                                                   0))
    plain_ms = graph_ms(lambda: flash_attention_with_lse_plain(
        q, k, v, True, None, s_l, 0), calls=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
        qt, kt, vt, 0.0, False))
    flops = 4.0 * b * h * 64 * s_l * s_l
    bound, bound_by, term = attention_bound(
        flops, 4.0 * b * s_l * h * 64 * 2 + b * s_l * h * 4,
        b * h * visible_pairs(s_l, s_l, True, s_l, 0))
    print(f"timing flash_attention_with_lse ({b},{s_l},{h},64) q_offset "
          f"{s_l} k_offset 0 (no key masked) bf16, device time (CUDA "
          f"graph): {ms:.4f} ms; plain {plain_ms:.4f} ms; aten flash "
          f"forward with lse, non-causal {lib_ms:.4f} ms; bound {bound:.4f} "
          f"ms ({term}); {k1_rates(flops, ms, lib_ms, bound)} [{card}]")
    entries = [{
        "name": "flash_attention[lse,d64]", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "bound_term": term,
        "library_ms": lib_ms}]
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # K1 over the seq=1 engine's whole prompt
    s = LC_CONTEXT
    q, k, v = (rand(s, torch.bfloat16) for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err, norm_err = out_errs(got, flash_attention_plain(q, k, v, causal=True))
    print(f"flash_attention ({b},{s},{h},64) causal bf16: max_abs_err="
          f"{err:.3e} (tol 2e-2), ||d||/||ref|| {norm_err:.3e} (tol "
          f"{OUT_NORM_TOL[torch.bfloat16]})")
    require(err <= 2e-2 and norm_err <= OUT_NORM_TOL[torch.bfloat16],
            "flash kernel disagrees at head dim 64")
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = graph_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        calls=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    flops = 4.0 * b * h * 64 * (s * (s + 1) / 2)
    bound, bound_by, term = attention_bound(
        flops, 4.0 * b * s * h * 64 * 2, b * h * visible_pairs(s, s, True))
    print(f"timing flash_attention ({b},{s},{h},64) causal bf16, device "
          f"time (CUDA graph): {ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({term}); "
          f"{k1_rates(flops, ms, lib_ms, bound)} [{card}]")
    entries.append({
        "name": "flash_attention[d64]", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "bound_term": term,
        "library_ms": lib_ms})
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return entries


def host_ms(fn, reps: int = 10) -> list:
    """Host wall times (ms, sorted) of `reps` calls that end synchronized.
    The seq path launches many small kernels from the host, and a one-card
    host shares its cores, so its spread is reported, not only its median."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def phase_long_context(dev, card) -> dict:
    """The seq-sharded long-context path at full width: `DecodeEngine` at
    seq=1 and over a seq=2 mesh whose two shards share this card, on the
    repo's long-context configuration with weights and prompts from a
    seed.  At f32 the greedy tokens must be identical; at bf16 the
    last-position prefill logits must agree within 5e-2 of their largest
    |value| (bf16 rounding of the activations along two attention
    orders), and token agreement is printed with the first differing step
    and the plain forward's top-2 logit margin there.  The seq=2 run must
    launch K4[stats] n_layers x steps x shards times and K1[lse] n_layers
    x the live (shard, block) pairs."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models import DecodeEngine
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    _forward_with_cache)
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    n_layers, shards = LC_CONFIG["n_layers"], 2
    steps = LC_NEW - 1
    mesh = make_mesh(MeshSpec(data=1, model=1, seq=shards),
                     [torch.device(dev.type, 0)] * shards)
    bundle = ModelBundle.init("TransformerLM", LC_CONFIG, seed=0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, LC_CONFIG["vocab_size"],
                           (LC_BATCH, LC_CONTEXT)).astype(np.int32)
    true_len = np.full(LC_BATCH, LC_CONTEXT, np.int32)
    out: dict = {"shards_share_one_card": True}

    def engines(b, **kw):
        weights = ServingWeights(b.module(dev))
        return {seq: DecodeEngine(weights, LC_NEW, chunk=LC_CHUNK,
                                  mesh=None if seq == 1 else mesh,
                                  device=dev, **kw) for seq in (1, shards)}

    def run(engine):
        engine.generate(prompts, true_len)            # warm-up
        torch.cuda.synchronize()
        reset_counts()
        tokens = engine.generate(prompts, true_len)
        torch.cuda.synchronize()
        return tokens, read_counts()

    def last_logits(engine, seq):
        tokens = torch.as_tensor(prompts, dtype=torch.long, device=dev)
        tl = torch.as_tensor(true_len, dtype=torch.long, device=dev)
        with torch.inference_mode():
            if seq == 1:
                w = engine.weights
                shape = (LC_BATCH, LC_CONTEXT + LC_CHUNK, w.n_heads,
                         w.d_model // w.n_heads)
                caches = [(torch.zeros(shape, dtype=w.dtype, device=dev),
                           torch.zeros(shape, dtype=w.dtype, device=dev))
                          for _ in range(w.n_layers)]
                logits = _forward_with_cache(w, tokens, caches, 0)
                return logits[torch.arange(LC_BATCH, device=dev), tl - 1]
            return engine._ring_prefill(tokens, tl, mesh.seq_rings()[0])[0]

    # bf16, model-dtype cache: the path the counts are read from
    eng = engines(bundle)
    tokens, counts = {}, {}
    for seq in (1, shards):
        tokens[seq], counts[seq] = run(eng[seq])
        once = DecodeEngine(eng[seq].weights, 1, chunk=LC_CHUNK,
                            mesh=eng[seq].mesh, device=dev)
        once.generate(prompts, true_len)
        prefills = host_ms(lambda: once.generate(prompts, true_len))
        totals = host_ms(lambda: eng[seq].generate(prompts, true_len))
        prefill_ms = statistics.median(prefills)
        # decode ms/step: each generate's time less the median prefill
        decode = [(t - prefill_ms) / steps for t in totals]
        out[f"seq{seq}"] = {"prefill_ms": prefill_ms,
                            "prefill_ms_all": prefills,
                            "decode_ms_per_step": statistics.median(decode),
                            "decode_ms_per_step_all": decode,
                            "generate_ms": statistics.median(totals)}
        print(f"long-context seq={seq}"
              f"{' (both shards on this one card)' if seq > 1 else ''}, "
              f"{len(totals)} runs each, median [min, max]: prefill "
              f"{prefill_ms:.3f} [{prefills[0]:.3f}, {prefills[-1]:.3f}] ms "
              f"(generate with 1 new token); decode "
              f"{statistics.median(decode):.3f} [{decode[0]:.3f}, "
              f"{decode[-1]:.3f}] ms/step ({LC_BATCH} rows x {LC_NEW} tokens "
              f"in {statistics.median(totals):.3f} ms); launches "
              f"{counts[seq]} [{card}]")
    want_stats = n_layers * steps * shards
    want_lse = n_layers * shards * (shards + 1) // 2
    got = counts[shards]
    require(got["fused_single_query_attention_stats"] == want_stats,
            f"K4[stats] launched {got['fused_single_query_attention_stats']}"
            f" times, want {want_stats}")
    require(got["flash_attention[lse]"] == want_lse,
            f"K1[lse] launched {got['flash_attention[lse]']} times, want "
            f"{want_lse}")
    require(got["flash_attention"] == 0 and
            got["fused_single_query_attention"] == 0,
            "the seq path launched the whole-window kernels")
    require(counts[1]["flash_attention"] == n_layers and
            counts[1]["fused_single_query_attention"] == n_layers * steps,
            "the seq=1 engine skipped its kernels")
    out["counts"] = {1: counts[1], shards: got}
    ref, seq_logits = last_logits(eng[1], 1), last_logits(eng[shards], shards)
    rel = ((ref - seq_logits).abs().max() / ref.abs().max()).item()
    same = tokens[1] == tokens[shards]
    first = [int(np.argmin(row)) if not row.all() else None for row in same]
    margins = []
    if any(t is not None for t in first):
        # the plain bf16 forward's top-2 gap at each row's first
        # differing step
        module = ModelBundle("TransformerLM", {**LC_CONFIG,
                                               "attn_impl": "flash"},
                             bundle.variables).module(dev)
        for r, t in enumerate(first):
            if t is None:
                continue
            seqs = np.concatenate([prompts[r], tokens[1][r, :t]])[None]
            with torch.inference_mode():
                top = torch.topk(module(torch.as_tensor(
                    seqs, dtype=torch.long, device=dev))[0, -1], 2).values
            margins.append((r, t, (top[0] - top[1]).item()))
        del module
    print(f"long-context bf16: last-position prefill logits seq={shards} vs "
          f"seq=1 max|d|/max|ref| {rel:.3e} (tol 5e-2); greedy tokens equal "
          f"{int(same.sum())}/{same.size}; first differing step per row "
          f"{first}; plain forward top-2 margin there (row, step, margin) "
          f"{margins}")
    require(rel <= 5e-2, "bf16 prefill logits of the two engines disagree")
    out["bf16"] = {"logits_rel_err": rel,
                   "tokens_match": int(same.sum()) / same.size,
                   "first_differing_step": first, "margins": margins}
    del eng
    torch.cuda.empty_cache()

    # bf16, int8 cache: K4[stats] over int8 slabs
    eng = engines(bundle, cache_dtype="int8")
    tok8, counts8 = run(eng[shards])
    ref8 = eng[1].generate(prompts, true_len)
    out["int8"] = {"tokens_match": float((tok8 == ref8).mean()),
                   "stats_launches":
                       counts8["fused_single_query_attention_stats"]}
    print(f"long-context bf16 int8 cache: seq={shards} vs seq=1 greedy "
          f"tokens equal {float((tok8 == ref8).mean()):.4f}; launches "
          f"{counts8}")
    require(counts8["fused_single_query_attention_stats"] == want_stats,
            "K4[stats] on the int8 cache: launch count")
    del eng
    torch.cuda.empty_cache()

    # f32: greedy tokens identical, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle32 = ModelBundle("TransformerLM", {**LC_CONFIG, "dtype": "float32"},
                           bundle.variables)
    eng = engines(bundle32)
    tok32 = {seq: eng[seq].generate(prompts, true_len) for seq in eng}
    ref = last_logits(eng[1], 1)
    rel32 = ((ref - last_logits(eng[shards], shards)).abs().max()
             / ref.abs().max()).item()
    match = bool(np.array_equal(tok32[1], tok32[shards]))
    print(f"long-context f32: greedy tokens seq={shards} vs seq=1 identical "
          f"{match} ({LC_BATCH} x {LC_NEW}); last-position prefill logits "
          f"max|d|/max|ref| {rel32:.3e}")
    require(match, "f32 greedy tokens of the seq engine differ from seq=1")
    out["f32"] = {"tokens_identical": match, "logits_rel_err": rel32}
    del eng
    torch.cuda.empty_cache()
    return out


def char_corpus(n_rows: int, seq: int, vocab: int) -> np.ndarray:
    """Example 401's learnable corpus: rows cycle the vocabulary from a
    random phase, seq + 1 tokens each (inputs and targets are slices)."""
    rng = np.random.default_rng(41)
    starts = rng.integers(0, vocab, size=(n_rows, 1))
    return ((starts + np.arange(seq + 1)) % vocab).astype(np.int32)


def train_config(model_config: dict):
    from mmlspark_tpu_torch import TrainerConfig
    return TrainerConfig(
        architecture="TransformerLM", model_config=model_config,
        optimizer="adam", learning_rate=3e-4, batch_size=TRAIN_BATCH,
        epochs=2, loss="softmax_xent", seed=0)


def phase_train(dev, card) -> dict:
    """The training path at full width through `Trainer.fit_arrays`."""
    from mmlspark_tpu_torch import DataTable, TextGenerator, Trainer
    from mmlspark_tpu_torch.utils.perf import lm_train_flops
    vocab, n_layers = LM_CONFIG["vocab_size"], LM_CONFIG["n_layers"]
    rows = char_corpus(TRAIN_ROWS, TRAIN_SEQ, vocab)
    tokens, targets = rows[:, :-1], rows[:, 1:]
    model_config = {**LM_CONFIG, "attn_impl": "flash"}
    trainer = Trainer(train_config(model_config), device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bundle = trainer.fit_arrays(tokens, targets, log_fn=print)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = read_counts()
    steps = bundle.metadata["steps"]
    losses = [r["loss"] for r in trainer.history]
    print(f"training path: {steps} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens "
          f"in {seconds:.3f} s; history {trainer.history}; launches "
          f"{launched} [{card}]")
    require(steps == TRAIN_ROWS // TRAIN_BATCH * 2, "metadata steps")
    require(all(np.isfinite(losses)), "non-finite training loss")
    require(losses[1] < losses[0], "the loss did not fall")
    for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
        require(launched[name] == n_layers * steps,
                f"{name} launched {launched[name]} times, want "
                f"{n_layers * steps}")

    prompts = tokens[:4, :12]
    out = TextGenerator(bundle, device=dev, inputCol="prompt",
                        maxNewTokens=16).transform(
        DataTable({"prompt": prompts}))["generated"]
    out = np.asarray(out)
    require(out.shape == (4, 28) and ((out >= 0) & (out < vocab)).all(),
            "generation from the trained bundle")
    expect = (prompts[:, -1:] + 1 + np.arange(16)) % vocab
    print(f"trained bundle generates {out.shape}; continuation accuracy vs "
          f"the cycle {float((out[:, 12:] == expect).mean()):.3f}")

    # the step alone: ms (CUDA events), tokens/s, analytic MFU
    timer = Trainer(train_config(model_config), device=dev)
    state = timer.init_state((1, TRAIN_SEQ), total_steps=16,
                             initial_bundle=bundle)
    step = timer.make_train_step()
    xb = torch.from_numpy(tokens[:TRAIN_BATCH].astype(np.int64)).to(dev)
    yb = torch.from_numpy(targets[:TRAIN_BATCH].astype(np.int64)).to(dev)
    mb = torch.ones(TRAIN_BATCH, device=dev)
    step_ms = cuda_ms(lambda: step(state, xb, yb, mb), warmup=1, reps=5)
    n_tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = lm_train_flops(TRAIN_BATCH, TRAIN_SEQ, LM_CONFIG["d_model"],
                           n_layers, vocab)["total"]
    mfu = flops / (step_ms / 1e3) / PEAK_BF16_FLOPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"timing train step {TRAIN_BATCH}x{TRAIN_SEQ} bf16 flash: "
          f"{step_ms:.3f} ms/step = {n_tokens / step_ms * 1e3:.1f} tokens/s; "
          f"analytic MFU {mfu:.4f} of 989 TFLOP/s ({flops / 1e12:.3f} "
          f"TFLOP/step); peak allocated {peak_gb:.2f} GiB [{card}]")
    return {"counts": launched, "seconds": seconds, "history": trainer.history,
            "step_ms": step_ms, "tokens_per_s": n_tokens / step_ms * 1e3,
            "mfu": mfu}


def phase_grad_check(dev, card) -> dict:
    """f32 gradients of every parameter through the flash kernels against
    the dense-attention model, on one (2, 2048) batch, TF32 off."""
    return flash_grad_check(dev, card, LM_CONFIG, TRAIN_SEQ, seed=4)


def flash_grad_check(dev, card, config: dict, seq: int, seed: int) -> dict:
    """f32 gradients of every parameter of a `config` model through the
    flash kernels (K1[lse], K2, K3) against the dense-attention model, on
    one (2, seq) batch of the example corpus, TF32 off: loss within 1e-4,
    every gradient within 1e-3 of its largest entry; K1[lse], K2 and K3
    each launched once a layer, counted from 0 around the flash model's
    forward and backward.  Returns the errors and those launches."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.train.trainer import make_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = char_corpus(2, seq, config["vocab_size"])
    x = torch.from_numpy(rows[:, :-1].astype(np.int64)).to(dev)
    y = torch.from_numpy(rows[:, 1:].astype(np.int64)).to(dev)
    init = ModelBundle.init("TransformerLM", config, seed=seed)
    loss_fn = make_loss("softmax_xent")
    grads, losses = {}, {}
    for impl in ("flash", "dense"):
        module = ModelBundle("TransformerLM", {
            **config, "dtype": "float32", "attn_impl": impl},
            init.variables).module(dev).train()
        torch.cuda.synchronize()
        reset_counts()
        loss = loss_fn(module(x), y, torch.ones(2, device=dev))
        loss.backward()
        torch.cuda.synchronize()
        if impl == "flash":
            launched = read_counts()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad for n, p in module.named_parameters()}
        del module, loss
    worst_name, worst = None, 0.0
    for name, g in grads["flash"].items():
        ref = grads["dense"][name]
        rel = ((g - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        if rel > worst:
            worst_name, worst = name, rel
    loss_diff = abs(losses["flash"] - losses["dense"])
    head_dim = config["d_model"] // config["n_heads"]
    print(f"f32 gradient check (2, {seq}) at head dim {head_dim}, flash "
          f"kernels vs dense attention: loss {losses['flash']:.6f} vs "
          f"{losses['dense']:.6f} (diff {loss_diff:.3e}, tol 1e-4); worst "
          f"parameter {worst_name} max|d|/max|ref| {worst:.3e} (tol 1e-3)")
    require(loss_diff <= 1e-4, f"f32 loss differs at head dim {head_dim}")
    require(worst <= 1e-3, f"f32 gradient of {worst_name} differs at head "
            f"dim {head_dim}")
    counts = {"K1[lse]": launched["flash_attention[lse]"],
              "K2": launched["flash_bwd_dq"], "K3": launched["flash_bwd_dkv"]}
    print(f"f32 gradient check at head dim {head_dim}: launches {counts} = "
          f"{config['n_layers']} layers x 1 step [{card}]")
    require(set(counts.values()) == {config["n_layers"]},
            f"f32 gradient check at head dim {head_dim}: launches {counts}, "
            f"want {config['n_layers']} each")
    del grads
    torch.cuda.empty_cache()
    return {"loss_diff": loss_diff, "worst_param": worst_name,
            "worst_rel_err": worst, "launches": counts}


# the repo's serving bench arm (bench.py bench_serve arms 1 and 2, not cut)
SERVE_BENCH_CONFIG = {"vocab_size": 8192, "d_model": 512, "n_heads": 8,
                      "n_layers": 4, "max_len": 256, "dtype": "bfloat16"}
SERVE_BENCH = dict(n_req=48, short_new=16, long_new=96, max_batch=8,
                   seg=16, chunk=64, lens=(40, 48, 56, 64), offered=96,
                   reps=2)
def http_json(port: int, method: str, path: str, body=None) -> tuple:
    """(status, parsed JSON body) of one request on a fresh connection."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, None if body is None else
                     json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode() or "{}")
    finally:
        conn.close()


def http_stream(port: int, body: dict) -> tuple:
    """(status, streamed token chunks, final line) of one `"stream": true`
    POST /generate."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/generate", json.dumps({**body,
                                                      "stream": True}))
        resp = conn.getresponse()
        chunks, final = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            payload = json.loads(line.decode())
            if payload.get("done"):
                final = payload
                break
            chunks.append(payload.get("tokens", []))
        return resp.status, chunks, final
    finally:
        conn.close()


def offline_tokens(weights, prompts, max_new, chunk, dev, **kw) -> list:
    """The offline `DecodeEngine`'s greedy tokens for each prompt, the
    prompts batched by bucket as `TextGenerator` batches them."""
    from mmlspark_tpu_torch.models import DecodeEngine
    engine = DecodeEngine(weights, max_new, chunk=chunk, device=dev, **kw)
    by_bucket: dict = {}
    for i, p in enumerate(prompts):
        by_bucket.setdefault(engine.bucket_for(len(p)), []).append(i)
    out: list = [None] * len(prompts)
    for bucket, idxs in by_bucket.items():
        padded = np.zeros((len(idxs), bucket), np.int32)
        for j, i in enumerate(idxs):
            padded[j, :len(prompts[i])] = prompts[i]
        rows = engine.generate(padded, [len(prompts[i]) for i in idxs])
        for j, i in enumerate(idxs):
            out[i] = rows[j].tolist()
    return out


def serve_traffic(port: int, prompts: list, late: np.ndarray,
                  streamed: np.ndarray, running) -> dict:
    """The phase's HTTP traffic: every prompt POSTed to /generate from its
    own client thread, one `"stream": true` request, and one more request
    once `running()` says its bucket's batch has run a segment (a
    mid-flight join).  Returns the responses by name, the wall seconds
    and the tokens served."""
    import threading
    results: dict = {}

    def post(name, prompt):
        results[name] = http_json(port, "POST", "/generate",
                                  {"prompt": prompt.tolist(),
                                   "deadline_ms": 600000})

    def stream():
        results["stream"] = http_stream(port, {"prompt": streamed.tolist(),
                                               "deadline_ms": 600000})

    t0 = time.perf_counter()
    threads = [threading.Thread(target=post, args=(i, p))
               for i, p in enumerate(prompts)]
    threads.append(threading.Thread(target=stream))
    for t in threads:
        t.start()
    give_up = time.perf_counter() + 120.0
    while not running() and time.perf_counter() < give_up:
        time.sleep(0.002)
    joiner = threading.Thread(target=post, args=("late", late))
    joiner.start()
    for t in threads + [joiner]:
        t.join(600)
    seconds = time.perf_counter() - t0
    tokens = sum(len(r[1].get("tokens", [])) for k, r in results.items()
                 if k != "stream") + len(results["stream"][2]["tokens"])
    return {"results": results, "seconds": seconds, "tokens": tokens}


def phase_serving(dev, card) -> dict:
    """The online serving engine at full width (chip_smoke phase 12).

    (a) `start_engine` + `start_http` on 127.0.0.1 over the slice-1
        configuration, `ServeConfig(max_new_tokens=64, max_batch=8,
        segment_steps=16)`, warm buckets covering the traffic (so the
        kernels are built before READY): the phase-6 prompts from
        concurrent client threads, one mid-flight join and one streamed
        request; at f32 (tokens equal the offline `DecodeEngine`'s), bf16
        and bf16 with an int8 cache (in-vocabulary rows, agreement with
        the offline engine printed).  K1 launches must equal n_layers x
        the prefills of buckets >= 512 and K4 n_layers x the decode steps
        run, both read off the engine's own spans; then `stop_http` and a
        drain that ends STOPPED.
    (b) the repo's serving bench arms 1 and 2 at their own width, bf16:
        continuous and static goodput, latency percentiles, the offline
        rate; 96 requests offered to a queue of 8 shed exactly 88 and
        every admitted one meets its deadline.
    (A profiled warm pass of (a)'s traffic at bf16 ran here until phase
    28 needed the time; phase 6 profiles the serving path.)"""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    bucket_length)
    from mmlspark_tpu_torch.observe.telemetry import run_telemetry
    from mmlspark_tpu_torch.observe.trace import aggregate_spans
    from mmlspark_tpu_torch.serve import ServeConfig, ServingEngine
    from mmlspark_tpu_torch.serve.lifecycle import (start_engine, start_http,
                                                    stop_http)
    n_layers, vocab = LM_CONFIG["n_layers"], LM_CONFIG["vocab_size"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in PROMPT_LENGTHS]
    late = rng.integers(0, vocab, 50).astype(np.int32)
    streamed = rng.integers(0, vocab, 30).astype(np.int32)
    every = prompts + [late, streamed]

    def bucket(p):
        return bucket_length(len(p), LM_CONFIG["max_len"], MAX_NEW)

    buckets = tuple(sorted({bucket(p) for p in every}))
    base = ModelBundle.init("TransformerLM", LM_CONFIG, seed=0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {}
    for name, dtype, cache in (("f32", "float32", "model"),
                               ("bf16", "bfloat16", "model"),
                               ("bf16_int8", "bfloat16", "int8")):
        bundle = ModelBundle("TransformerLM", {**LM_CONFIG, "dtype": dtype},
                             base.variables)
        cfg = ServeConfig(max_new_tokens=MAX_NEW, max_batch=8,
                          segment_steps=16, cache_dtype=cache,
                          default_deadline_s=600.0, warmup_buckets=buckets)
        with run_telemetry(None) as rt:
            engine = ServingEngine(bundle, cfg, device=dev)
            t0 = time.perf_counter()
            start_engine(engine, install_sigterm=False)
            warm_s = time.perf_counter() - t0
            server = start_http(engine, port=0)
            port = server.server_address[1]

            def running():
                return any(r.get("type") == "serve"
                           and r.get("event") == "segment"
                           and r.get("bucket") == bucket(late)
                           for r in rt.tracer.records())
            try:
                ready = http_json(port, "GET", "/readyz")[0]
                require(ready == 200, f"serving {name}: /readyz was {ready} "
                        f"before the first POST")
                torch.cuda.synchronize()
                reset_counts()
                traffic = serve_traffic(port, prompts, late, streamed,
                                        running)
                torch.cuda.synchronize()
                launched = read_counts()
                records = rt.tracer.records()
                stats = http_json(port, "GET", "/statz")[1]
            finally:
                stop_http(server)
                engine.stop()
            require(engine.state == "stopped",
                    f"serving {name}: drain ended {engine.state}")
        results = traffic["results"]
        statuses = sorted({r[0] for r in results.values()})
        require(statuses == [200], f"serving {name}: statuses {statuses}")
        got = [results[i][1]["tokens"] for i in range(len(prompts))]
        got += [results["late"][1]["tokens"], results["stream"][2]["tokens"]]
        # the late request joined a batch that had already run a segment
        serve = [r for r in records if r.get("type") == "serve"]
        late_id = results["late"][1]["request"]
        join = next(i for i, r in enumerate(serve)
                    if r["event"] == "join" and r["request"] == late_id)
        require(any(r["event"] == "segment"
                    and r["bucket"] == serve[join]["bucket"]
                    for r in serve[:join]),
                f"serving {name}: the late request did not join mid-flight")
        chunks = results["stream"][1]
        require(sum(chunks, []) == got[-1] and len(chunks) >= 2,
                f"serving {name}: the stream's chunks do not add up to its "
                f"final tokens")
        for row in got:
            require(len(row) == MAX_NEW and all(0 <= t < vocab for t in row),
                    f"serving {name}: a row out of the vocabulary")
        # the engine's own spans: prefills by bucket, steps per segment
        spans = [r for r in records if r.get("type") == "span"]
        flash_prefills = sum(1 for r in spans if r["name"] == "serve.prefill"
                             and r["attrs"]["bucket"] >= 512)
        steps = sum(r["attrs"]["seg_len"] for r in spans
                    if r["name"] == "serve.segment")
        k1, k4 = (launched["flash_attention"],
                  launched["fused_single_query_attention"])
        require(k1 == n_layers * flash_prefills and flash_prefills > 0,
                f"serving {name}: K1 launched {k1}, expected {n_layers} x "
                f"{flash_prefills} prefills of buckets >= 512")
        require(k4 == n_layers * steps and steps > 0,
                f"serving {name}: K4 launched {k4}, expected {n_layers} x "
                f"{steps} decode steps")
        weights = ServingWeights(bundle.module(dev))
        ref = offline_tokens(weights, every, MAX_NEW, cfg.cache_chunk, dev,
                             cache_dtype=cache)
        agree = sum(int(a == b) for g, r in zip(got, ref)
                    for a, b in zip(g, r))
        if name == "f32":
            require(got == ref, "serving f32: tokens differ from the "
                    "offline DecodeEngine's")
        agg = aggregate_spans(records)
        seg_ms = 1e3 * agg["serve.segment"]["total_s"] / agg[
            "serve.segment"]["count"]
        out[name] = {
            "tokens_per_s": traffic["tokens"] / traffic["seconds"],
            "seconds": traffic["seconds"], "tokens": traffic["tokens"],
            "warmup_s": warm_s, "launches": {"K1": k1, "K4": k4},
            "flash_prefills": flash_prefills, "decode_steps": steps,
            "segments": agg["serve.segment"]["count"],
            "segment_ms": seg_ms, "step_ms": seg_ms / cfg.segment_steps,
            "prefill_ms": 1e3 * agg["serve.prefill"]["total_s"]
            / agg["serve.prefill"]["count"],
            "agree_offline": f"{agree}/{MAX_NEW * len(every)}",
            "latency_p50_s": stats["latency_p50_s"],
            "latency_p99_s": stats["latency_p99_s"]}
        print(f"serving {name} (HTTP, {len(every)} requests x {MAX_NEW} "
              f"tokens): {out[name]['tokens_per_s']:.1f} tokens/s over "
              f"{traffic['seconds'] * 1e3:.1f} ms; warmup {warm_s:.2f} s; "
              f"K1 {k1} = {n_layers} x {flash_prefills} prefills, K4 {k4} "
              f"= {n_layers} x {steps} steps; segment {seg_ms:.2f} ms "
              f"({seg_ms / cfg.segment_steps:.2f} ms/step), prefill "
              f"{out[name]['prefill_ms']:.2f} ms; tokens agree with the "
              f"offline engine {out[name]['agree_offline']} [{card}]")
    out["bench"] = serve_bench(dev, card)
    return out


def serve_bench_workload() -> tuple:
    """bench.py bench_serve's requests (prompts of 40-64 tokens, 3 short
    budgets to 1 long) and its per-engine ServeConfig fields."""
    b = SERVE_BENCH
    rng = np.random.default_rng(0)
    vocab = SERVE_BENCH_CONFIG["vocab_size"]
    prompts = [rng.integers(0, vocab, (b["lens"][i % len(b["lens"])],))
               .astype(np.int32) for i in range(b["n_req"])]
    budgets = [b["long_new"] if i % 4 == 3 else b["short_new"]
               for i in range(b["n_req"])]
    scfg = dict(max_new_tokens=b["long_new"], max_batch=b["max_batch"],
                queue_capacity=max(b["n_req"], b["offered"]),
                segment_steps=b["seg"], default_deadline_s=600.0,
                cache_chunk=b["chunk"])
    return prompts, budgets, scfg


def drain_inline(engine, requests) -> None:
    """Tick an inline engine until every request finished (or it idles)."""
    while any(not r.finished for r in requests):
        if not engine._tick():
            break
    engine._tick()


def serve_bench(dev, card) -> dict:
    """bench.py bench_serve arms 1 and 2 on the port, at bf16."""
    import gc

    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models import DecodeEngine
    from mmlspark_tpu_torch.models.generate import ServingWeights
    from mmlspark_tpu_torch.serve import Overloaded, ServeConfig, \
        ServingEngine
    b = SERVE_BENCH
    bundle = ModelBundle.init("TransformerLM", SERVE_BENCH_CONFIG, seed=0)
    vocab = SERVE_BENCH_CONFIG["vocab_size"]
    prompts, budgets, scfg = serve_bench_workload()

    def timed(engine, batches):
        """The best wall of `reps` passes, each batch drained before the
        next is admitted; the last pass's requests."""
        wall, reqs = float("inf"), []
        gc.collect()
        gc.disable()
        try:
            for _ in range(b["reps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                reqs = []
                for idx in batches:
                    gang = [engine.submit(prompts[i],
                                          max_new_tokens=budgets[i])
                            for i in idx]
                    drain_inline(engine, gang)
                    reqs.extend(gang)
                wall = min(wall, time.perf_counter() - t0)
        finally:
            gc.enable()
        return wall, reqs

    def pct(values, q):
        return values[min(len(values) - 1,
                          int(round(q / 100 * (len(values) - 1))))]

    engine = ServingEngine(bundle, ServeConfig(**scfg), device=dev)
    engine.warmup()
    drain_inline(engine, [engine.submit(p, max_new_tokens=n)
                          for p, n in zip(prompts, budgets)])
    every = [list(range(b["n_req"]))]
    gangs = [list(range(i, min(i + b["max_batch"], b["n_req"])))
             for i in range(0, b["n_req"], b["max_batch"])]
    cont_wall, cont = timed(engine, every)
    static_wall, static = timed(engine, gangs)
    out = {}
    for name, wall, reqs in (("continuous", cont_wall, cont),
                             ("static", static_wall, static)):
        require(all(r.status == "ok" for r in reqs),
                f"serving bench {name}: a request did not finish ok")
        lat = sorted(r.latency_s() for r in reqs)
        out[name] = {"goodput_tokens_per_s":
                     sum(len(r.tokens) for r in reqs) / wall,
                     "wall_s": wall,
                     "latency_p50_s": pct(lat, 50),
                     "latency_p95_s": pct(lat, 95),
                     "latency_p99_s": pct(lat, 99)}
    # the static latencies: every request arrived when the pass began
    start = min(r.arrival for r in static)
    lat = sorted(r.finished_at - start for r in static)
    out["static"].update({f"latency_p{q}_s": pct(lat, q)
                          for q in (50, 95, 99)})
    # the offline DecodeEngine batch rate over the same gangs
    offline = DecodeEngine(ServingWeights(bundle.module(dev)),
                           b["long_new"], chunk=b["chunk"], device=dev)

    def run_offline():
        rows = {}
        for idx in gangs:
            bucket = max(offline.bucket_for(len(prompts[i])) for i in idx)
            padded = np.zeros((len(idx), bucket), np.int32)
            tl = np.asarray([len(prompts[i]) for i in idx], np.int32)
            for j, i in enumerate(idx):
                padded[j, :tl[j]] = prompts[i]
            for j, row in zip(idx, offline.generate(padded, tl)):
                rows[j] = row
        return rows

    run_offline()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = run_offline()
    torch.cuda.synchronize()
    out["offline_tokens_per_s"] = sum(budgets) / (time.perf_counter() - t0)
    agree = sum(int(a == c) for r, i in zip(cont, range(b["n_req"]))
                for a, c in zip(r.tokens, rows[i][:budgets[i]]))
    out["continuous_agree_offline"] = f"{agree}/{sum(budgets)}"
    out["continuous_over_static"] = (out["continuous"]["goodput_tokens_per_s"]
                                     / out["static"]["goodput_tokens_per_s"])
    # arm 2: a burst of `offered` requests on an idle engine, queue of 8
    over = ServingEngine(bundle, ServeConfig(**{
        **scfg, "queue_capacity": b["max_batch"],
        "default_deadline_s": 120.0}), device=dev)
    over.warmup()
    admitted, shed = [], 0
    for i in range(b["offered"]):
        try:
            admitted.append(over.submit(prompts[i % b["n_req"]],
                                        max_new_tokens=b["short_new"]))
        except Overloaded:
            shed += 1
    drain_inline(over, admitted)
    met = sum(1 for r in admitted
              if r.status == "ok" and r.finished_at <= r.deadline)
    require(shed == b["offered"] - b["max_batch"] and met == len(admitted),
            f"serving bench overload: shed {shed} of {b['offered']}, "
            f"{met}/{len(admitted)} admitted met their deadline")
    out["overload"] = {"offered": b["offered"], "shed": shed,
                       "admitted": len(admitted), "met_deadline": met}
    c, st = out["continuous"], out["static"]
    print(f"serving bench (vocab {vocab}, d_model "
          f"{SERVE_BENCH_CONFIG['d_model']}, bf16; {b['n_req']} requests "
          f"3:1 of {b['short_new']}:{b['long_new']} tokens): continuous "
          f"{c['goodput_tokens_per_s']:.1f} tokens/s (p50/p95/p99 "
          f"{c['latency_p50_s']:.3f}/{c['latency_p95_s']:.3f}/"
          f"{c['latency_p99_s']:.3f} s), static "
          f"{st['goodput_tokens_per_s']:.1f} tokens/s "
          f"({st['latency_p50_s']:.3f}/{st['latency_p95_s']:.3f}/"
          f"{st['latency_p99_s']:.3f} s), ratio "
          f"{out['continuous_over_static']:.3f}; offline "
          f"{out['offline_tokens_per_s']:.1f} tokens/s; continuous tokens "
          f"agree with offline {out['continuous_agree_offline']}; overload "
          f"{shed}/{b['offered']} shed, {met}/{len(admitted)} admitted met "
          f"the deadline [{card}]")
    return out


# chip_smoke phase 13: the replicated colocated fleet at the width of phase 6
FLEET_SERVE = dict(max_new_tokens=MAX_NEW, max_batch=8, segment_steps=16,
                   cache_chunk=64, prefill_chunk=512, prefix_cache=True)
# one prompt of an 896-token prefix and a 64-token suffix, then three more
# with the same prefix and new suffixes (each a pool hit of 896 tokens)
SHARED_PREFIX, SHARED_SUFFIX, SHARED_LATER = 896, 64, 3
# bench.py bench_lm_decode arm 5, the full arm (bf16, the bench's dtype)
FIRST_TOKEN = dict(config={"vocab_size": 8192, "d_model": 1024,
                           "n_heads": 8, "n_layers": 4, "max_len": 1024,
                           "dtype": "bfloat16"},
                   chunk=128, long=896, short=32, new=32)
# bench.py bench_serve arm 5, the full arm at its own width (8 heads of
# head dim 32), f32 for its exact gate
ZIPF = dict(config={"vocab_size": 8192, "d_model": 256, "n_heads": 8,
                    "n_layers": 4, "max_len": 1024, "dtype": "float32"},
            n=16, new=8, chunk=64, prefix=896, suffix=64, reps=2)


def post_all(port, named: dict, then: Optional[dict] = None) -> dict:
    """POST every (name, prompt) of `named` to /generate from its own
    client thread; once the last of them has its response, the prompts of
    `then` the same way.  The responses by name, the wall seconds and the
    tokens served."""
    import threading
    results: dict = {}

    def post(name, prompt):
        results[name] = http_json(port, "POST", "/generate",
                                  {"prompt": prompt.tolist(),
                                   "deadline_ms": 600000})

    t0 = time.perf_counter()
    threads = []
    for wave in (named, then or {}):
        started = [threading.Thread(target=post, args=item)
                   for item in wave.items()]
        for t in started:
            t.start()
        if wave is named and started:
            started[-1].join(600)
        threads += started
    for t in threads:
        t.join(600)
    seconds = time.perf_counter() - t0
    tokens = sum(len(r[1].get("tokens", [])) for r in results.values())
    return {"results": results, "seconds": seconds, "tokens": tokens}


def arm_crash(router) -> dict:
    """Once `armed["on"]`, the first replica holding a row that has run a
    decode segment raises from its next scheduler pass, on the router's
    own thread: `Replica.tick` takes the crash path (`Replica.crash()`:
    its rows fail, the router fails them over and ejects it)."""
    armed = {"on": False, "crashed": None}
    for rep in router.replicas:
        def faulty(engine=rep.engine, tick=rep.engine._tick, name=rep.name):
            if armed["on"] and armed["crashed"] is None and any(
                    len(g.rows[i].tokens) > 1
                    for g in list(engine._groups.values())
                    for i in g.live_slots()):
                armed["crashed"] = name
                raise RuntimeError("injected fault: replica crash mid-pass")
            return tick()
        rep.engine._tick = faulty
    return armed


def fleet_launch_plan(records, n_layers: int) -> dict:
    """The K1 and K4 launches the fleet's own spans call for: K1 once per
    layer at every prefill segment of >= 512 tokens at slot 0 (a
    whole-prompt prefill of such a bucket, or chunk 0 of such chunks),
    K4 once per layer at every decode step of every replica."""
    spans = [r for r in records if r.get("type") == "span"]
    whole = sum(1 for r in spans if r["name"] == "serve.prefill"
                and r["attrs"]["bucket"] >= 512)
    chunk0 = sum(1 for r in spans if r["name"] == "serve.prefill_chunk"
                 and r["attrs"]["index"] == 0
                 and r["attrs"]["bucket"] // r["attrs"]["chunks"] >= 512)
    steps = sum(r["attrs"]["seg_len"] for r in spans
                if r["name"] == "serve.segment")
    resumes = sum(1 for r in spans if r["name"] == "serve.prefill_resume")
    return {"whole_prefills": whole, "chunk0_prefills": chunk0,
            "resumes": resumes, "decode_steps": steps,
            "K1": n_layers * (whole + chunk0), "K4": n_layers * steps}


def prefill_timings(weights, dev, prompt, card) -> dict:
    """A chunk's prefill against the whole-prompt prefill of its bucket,
    and a resumed prefill against a fresh one, on one row of `prompt`
    (CUDA events, median of 20 after 3 warm-up calls)."""
    from mmlspark_tpu_torch.models import DecodeEngine
    eng = DecodeEngine(weights, MAX_NEW, chunk=FLEET_SERVE["cache_chunk"],
                       prefill_chunk=FLEET_SERVE["prefill_chunk"],
                       device=dev)
    bucket = eng.bucket_for(len(prompt))
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :len(prompt)] = prompt
    tl, live = [len(prompt)], np.ones(1, bool)
    state0 = eng.serve_prefill_chunk(padded, tl, 0, None)

    def chunked():
        state = eng.serve_prefill_chunk(padded, tl, 0, None)
        for ci in range(1, eng.serve_prefill_chunks(bucket)):
            state = eng.serve_prefill_chunk(padded, tl, ci, state)
        return eng.serve_prefill_finish(state, live, [0])

    _, _, caches = eng.serve_prefill(padded, tl, live, [0])
    donor = [tuple(t[:, :SHARED_PREFIX].clone() for t in layer)
             for layer in caches]
    out = {"bucket": bucket, "chunks": eng.serve_prefill_chunks(bucket),
           "chunk0_ms": cuda_ms(lambda: eng.serve_prefill_chunk(
               padded, tl, 0, None)),
           "chunk1_ms": cuda_ms(lambda: eng.serve_prefill_chunk(
               padded, tl, 1, state0)),
           "chunked_ms": cuda_ms(chunked),
           "whole_ms": cuda_ms(lambda: eng.serve_prefill(padded, tl, live,
                                                         [0])),
           "resume_ms": cuda_ms(lambda: eng.serve_prefill_resume(
               padded, tl, SHARED_PREFIX, donor, live, [0])),
           "matched": SHARED_PREFIX}
    print(f"  prefill of one {len(prompt)}-token row, bucket {bucket}: "
          f"chunk 0 (K1) {out['chunk0_ms']:.3f} ms, chunk 1 (dense) "
          f"{out['chunk1_ms']:.3f} ms, chunked {out['chunked_ms']:.3f} ms "
          f"vs whole {out['whole_ms']:.3f} ms; resumed after "
          f"{SHARED_PREFIX} pooled tokens {out['resume_ms']:.3f} ms vs "
          f"fresh chunked {out['chunked_ms']:.3f} ms [{card}]")
    return out


def phase_fleet(dev, card, benches: bool = True) -> dict:
    """The replicated serving fleet at full width (chip_smoke phase 13).

    (a) `build_fleet` of 2 replicas on this card over the slice-1
        configuration, `ServeConfig(max_new_tokens=64, max_batch=8,
        segment_steps=16, cache_chunk=64, prefill_chunk=512,
        prefix_cache=True)`, `RouterConfig(replicas=2,
        prefix_affinity=True)`, `start_router` + `start_http`: the phase-12
        prompts (buckets 1024 chunked in two 512-token chunks, 1984
        whole) and a 960-token prompt of an 896-token prefix, then three
        more with its prefix (pool hits, resumed inline) over HTTP; at
        f32 (tokens equal the offline whole-prompt `DecodeEngine`'s),
        bf16 and bf16 with an int8 cache (in-vocabulary rows, agreement
        printed).  Every response 200 after /readyz 200; K1 = n_layers x
        the prefill segments of >= 512 tokens at slot 0 and K4 = n_layers
        x the decode steps of both replicas, exactly, off the engines'
        own spans; pool hits >= 3 with hit_tokens >= 3 x 896, the shared
        prompts on one replica by affinity.  At f32 a second pass: the
        replica holding rows crashes mid-pass (on the router's thread);
        every request completes with the offline tokens, a retry is
        counted and the replica is ejected.
    (b) a chunk's prefill ms against the whole prompt's of its bucket, a
        resumed prefill against a fresh one (bf16).
    (c) the three fleet arms of bench.py at their own widths: chunked-
        prefill first token (bench_lm_decode arm 5), the Zipf prefix arm
        (bench_serve arm 5) and the router arm (bench_serve arm 3)."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    bucket_length)
    from mmlspark_tpu_torch.observe.telemetry import run_telemetry
    from mmlspark_tpu_torch.serve import (RouterConfig, ServeConfig,
                                          build_fleet)
    from mmlspark_tpu_torch.serve.lifecycle import (start_http,
                                                    start_router, stop_http)
    n_layers, vocab = LM_CONFIG["n_layers"], LM_CONFIG["vocab_size"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in PROMPT_LENGTHS]
    srng = np.random.default_rng(13)
    prefix = srng.integers(0, vocab, SHARED_PREFIX).astype(np.int32)
    shared = [np.concatenate([prefix, srng.integers(
        0, vocab, SHARED_SUFFIX).astype(np.int32)])
        for _ in range(1 + SHARED_LATER)]
    first = {**dict(enumerate(prompts)), "shared0": shared[0]}
    later = {f"shared{j}": shared[j] for j in range(1, len(shared))}
    names = list(first) + list(later)
    every = list(first.values()) + list(later.values())
    buckets = tuple(sorted({bucket_length(len(p), LM_CONFIG["max_len"],
                                          MAX_NEW) for p in every}))
    base = ModelBundle.init("TransformerLM", LM_CONFIG, seed=0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {}
    for name, dtype, cache in (("f32", "float32", "model"),
                               ("bf16", "bfloat16", "model"),
                               ("bf16_int8", "bfloat16", "int8")):
        bundle = ModelBundle("TransformerLM", {**LM_CONFIG, "dtype": dtype},
                             base.variables)
        scfg = ServeConfig(**FLEET_SERVE, cache_dtype=cache,
                           default_deadline_s=600.0, warmup_buckets=buckets)
        failover = None
        with run_telemetry(None) as rt:
            router = build_fleet(bundle, cfg=RouterConfig(
                replicas=2, prefix_affinity=True, default_deadline_s=600.0),
                serve_cfg=scfg, device=dev)
            t0 = time.perf_counter()
            start_router(router, install_sigterm=False)
            warm_s = time.perf_counter() - t0
            armed = arm_crash(router) if name == "f32" else None
            server = start_http(router, port=0)
            port = server.server_address[1]
            try:
                ready = http_json(port, "GET", "/readyz")[0]
                require(ready == 200, f"fleet {name}: /readyz was {ready} "
                        f"before the first POST")
                torch.cuda.synchronize()
                reset_counts()
                traffic = post_all(port, first, later)
                torch.cuda.synchronize()
                launched = read_counts()
                records = rt.tracer.records()
                stats = http_json(port, "GET", "/statz")[1]
                if armed is not None:
                    armed["on"] = True
                    failover = post_all(port, dict(enumerate(prompts)))
                    failover["stats"] = http_json(port, "GET", "/statz")[1]
            finally:
                stop_http(server)
                router.stop()
            require(router.state == "stopped",
                    f"fleet {name}: drain ended {router.state}")
        results = traffic["results"]
        statuses = sorted({results[k][0] for k in names})
        require(statuses == [200], f"fleet {name}: statuses {statuses}")
        got = [results[k][1]["tokens"] for k in names]
        for row in got:
            require(len(row) == MAX_NEW and all(0 <= t < vocab for t in row),
                    f"fleet {name}: a row out of the vocabulary")
        plan = fleet_launch_plan(records, n_layers)
        k1, k4 = (launched["flash_attention"],
                  launched["fused_single_query_attention"])
        require(k1 == plan["K1"] and plan["whole_prefills"] > 0
                and plan["chunk0_prefills"] > 0,
                f"fleet {name}: K1 launched {k1}, expected {n_layers} x "
                f"({plan['whole_prefills']} whole + "
                f"{plan['chunk0_prefills']} chunk-0 prefills)")
        require(k4 == plan["K4"] and plan["decode_steps"] > 0,
                f"fleet {name}: K4 launched {k4}, expected {n_layers} x "
                f"{plan['decode_steps']} decode steps")
        pools = [h["prefix"] for h in stats["replicas"].values()]
        hits = sum(p["hits"] for p in pools)
        hit_tokens = sum(p["hit_tokens"] for p in pools)
        require(hits >= SHARED_LATER
                and hit_tokens >= SHARED_LATER * SHARED_PREFIX
                and plan["resumes"] >= SHARED_LATER,
                f"fleet {name}: pool hits {hits} ({hit_tokens} tokens), "
                f"{plan['resumes']} resumes")
        routing = [r for r in records if r.get("type") == "routing"]
        shared_ids = {results[k][1]["request"] for k in names
                      if str(k).startswith("shared")}
        placed = {r["replica"] for r in routing if r["event"] == "dispatch"
                  and r.get("request") in shared_ids}
        steered = {r["request"] for r in routing if r["event"] == "affinity"}
        require(len(placed) == 1 and shared_ids <= steered
                and stats.get("affinity_routes", 0) >= len(shared_ids),
                f"fleet {name}: the shared-prefix requests went to {placed}, "
                f"affinity routes {stats.get('affinity_routes')}")
        weights = ServingWeights(bundle.module(dev))
        ref = offline_tokens(weights, every, MAX_NEW, scfg.cache_chunk, dev,
                             cache_dtype=cache)
        agree = sum(int(a == b) for g, r in zip(got, ref)
                    for a, b in zip(g, r))
        if name == "f32":
            for i, (g, r) in enumerate(zip(got, ref)):
                if g != r:
                    at = next(j for j, (a, b) in enumerate(zip(g, r))
                              if a != b)
                    print(f"  fleet f32: request {names[i]} differs from "
                          f"the offline engine first at token {at} "
                          f"({g[at]} vs {r[at]})")
            require(got == ref, "fleet f32: tokens differ from the offline "
                    "whole-prompt DecodeEngine's")
        out[name] = {
            "tokens_per_s": traffic["tokens"] / traffic["seconds"],
            "seconds": traffic["seconds"], "tokens": traffic["tokens"],
            "warmup_s": warm_s, "launches": {"K1": k1, "K4": k4},
            "plan": plan, "pool_hits": hits, "pool_hit_tokens": hit_tokens,
            "affinity_routes": stats.get("affinity_routes", 0),
            "routed": {n: h["routed"] for n, h in stats["replicas"].items()},
            "agree_offline": f"{agree}/{MAX_NEW * len(every)}"}
        print(f"fleet {name} (2 replicas, HTTP, {len(every)} requests x "
              f"{MAX_NEW} tokens): {out[name]['tokens_per_s']:.1f} tokens/s "
              f"over {traffic['seconds'] * 1e3:.1f} ms; warmup "
              f"{warm_s:.2f} s; K1 {k1} = {n_layers} x "
              f"({plan['whole_prefills']} whole + "
              f"{plan['chunk0_prefills']} chunk-0), K4 {k4} = {n_layers} x "
              f"{plan['decode_steps']} steps; pool {hits} hits, "
              f"{hit_tokens} tokens, {plan['resumes']} resumes; routed "
              f"{out[name]['routed']}; tokens agree with the offline "
              f"engine {out[name]['agree_offline']} [{card}]")
        if failover is not None:
            fres, fstats = failover["results"], failover["stats"]
            fstatus = sorted({r[0] for r in fres.values()})
            fgot = [fres[i][1]["tokens"] for i in range(len(prompts))]
            crashed = armed["crashed"]
            require(fstatus == [200] and fgot == ref[:len(prompts)],
                    f"fleet failover: statuses {fstatus}, tokens equal "
                    f"{fgot == ref[:len(prompts)]}")
            require(crashed is not None and fstats.get("retries", 0) >= 1
                    and fstats["replicas"][crashed]["crashed"]
                    and fstats["replicas"][crashed]["breaker"]["state"]
                    == "open",
                    f"fleet failover: crashed {crashed}, retries "
                    f"{fstats.get('retries')}")
            out["failover"] = {
                "crashed": crashed, "retries": fstats["retries"],
                "ejections": fstats.get("ejections", 0),
                "seconds": failover["seconds"],
                "tokens_per_s": failover["tokens"] / failover["seconds"]}
            print(f"fleet failover (f32): {crashed} crashed mid-pass; "
                  f"{len(prompts)}/{len(prompts)} requests 200 with the "
                  f"offline tokens; {fstats['retries']} retries, "
                  f"{out['failover']['ejections']} ejections [{card}]")
        if name == "bf16":
            out["prefill"] = prefill_timings(weights, dev, shared[1], card)
        del router, weights
        torch.cuda.empty_cache()
    if benches:
        out["first_token"] = bench_first_token(dev, card)
        out["zipf"] = bench_zipf(dev, card)
        out["router"] = bench_router(dev, card)
    return out


def bench_first_token(dev, card) -> dict:
    """bench.py bench_lm_decode arm 5: a resident row decoding, then an
    896-token prompt with a 32-token one right behind it; the short
    request's first-token ms (host clock around the ticks) with
    whole-prompt prefill and with the bench's chunk of 128.  Its bucket
    is 992 (max_len 1024 less 32 new tokens), which 128 does not divide,
    so the engine prefills it whole either way; a chunk of 32, which
    divides 992, is timed beside them."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models.generate import bucket_length
    from mmlspark_tpu_torch.observe.spans import monotonic
    from mmlspark_tpu_torch.serve import ServeConfig, ServingEngine
    c = FIRST_TOKEN
    bundle = ModelBundle.init("TransformerLM", c["config"], seed=0)
    rng = np.random.default_rng(0)
    vocab = c["config"]["vocab_size"]
    long_p = rng.integers(1, vocab, c["long"]).astype(np.int32)
    short_p = rng.integers(1, vocab, c["short"]).astype(np.int32)
    resident_p = rng.integers(1, vocab, c["short"] - 1).astype(np.int32)

    buckets = tuple(bucket_length(n, c["config"]["max_len"], c["new"])
                    for n in (c["short"], c["long"]))

    def first_token_ms(prefill_chunk: int) -> tuple:
        engine = ServingEngine(bundle, ServeConfig(
            max_new_tokens=c["new"], max_batch=4, queue_capacity=16,
            segment_steps=4, cache_chunk=c["chunk"],
            prefill_chunk=prefill_chunk, default_deadline_s=600.0,
            warmup_buckets=buckets), device=dev).warmup()
        best = float("inf")
        for _ in range(3):
            r0 = engine.submit(resident_p)
            engine._tick()
            lg, sh = engine.submit(long_p), engine.submit(short_p)
            t0, first = monotonic(), None
            for _ in range(400):
                engine._tick()
                if first is None and len(sh.tokens) > 0:
                    first = monotonic() - t0
                if sh.finished and lg.finished and r0.finished:
                    break
            require(lg.status == sh.status == r0.status == "ok",
                    f"first-token arm: statuses {lg.status} {sh.status}")
            best = min(best, first * 1e3)
        return best, engine._engines["primary"].serve_prefill_chunks(
            buckets[1])

    out = {}
    for label, chunk in (("whole", 0), ("chunk128", c["chunk"]),
                         ("chunk32", 32)):
        out[label], out[f"{label}_chunks"] = first_token_ms(chunk)
    print(f"first-token arm (bench_lm_decode arm 5: vocab {vocab}, d_model "
          f"{c['config']['d_model']}, bf16; {c['long']} + {c['short']} "
          f"tokens, bucket {buckets[1]}): the short request's first token "
          f"{out['whole']:.2f} ms whole, {out['chunk128']:.2f} ms with "
          f"the bench's chunk 128 ({out['chunk128_chunks']} chunks run), "
          f"{out['chunk32']:.2f} ms with chunk 32 ({out['chunk32_chunks']} "
          f"chunks) [{card}]")
    return out


def bench_zipf(dev, card) -> dict:
    """bench.py bench_serve arm 5: 16 prompts over 4 shared 896-token
    prefixes (Zipf weights) plus 64-token suffixes, 8 new tokens each,
    through one engine with and without the prefix pool; goodput (best of
    3 timed passes after a warm pass that fills the pool), the suffix
    fraction of prefilled prompt tokens, tokens equal across the arms."""
    import gc

    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models.generate import bucket_length
    from mmlspark_tpu_torch.observe.telemetry import run_telemetry
    from mmlspark_tpu_torch.serve import ServeConfig, ServingEngine
    z = ZIPF
    bundle = ModelBundle.init("TransformerLM", z["config"], seed=1)
    vocab = z["config"]["vocab_size"]
    rng = np.random.default_rng(11)
    prefixes = [rng.integers(0, vocab, z["prefix"]).astype(np.int32)
                for _ in range(4)]
    weights = 1.0 / np.arange(1, 5) ** 1.2
    prompts = [np.concatenate([prefixes[k], rng.integers(
        0, vocab, z["suffix"]).astype(np.int32)])
        for k in rng.choice(4, size=z["n"], p=weights / weights.sum())]

    n_layers = z["config"]["n_layers"]

    def run(prefix_cache: bool) -> tuple:
        kw = dict(max_new_tokens=z["new"], max_batch=SERVE_BENCH["max_batch"],
                  queue_capacity=max(32, z["n"]),
                  segment_steps=SERVE_BENCH["seg"], default_deadline_s=600.0,
                  cache_chunk=z["chunk"], prefill_chunk=z["chunk"])
        if prefix_cache:
            kw.update(prefix_cache=True, prefix_max_rows=64)
        with run_telemetry(None) as rt:
            engine = ServingEngine(bundle, ServeConfig(**kw), device=dev)
            engine.warmup()
            torch.cuda.synchronize()
            reset_counts()
            drain_inline(engine, [engine.submit(p, max_new_tokens=z["new"])
                                  for p in prompts])
            best_wall, best = float("inf"), None
            gc.collect()
            gc.disable()
            try:
                for _ in range(z["reps"]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    reqs = [engine.submit(p, max_new_tokens=z["new"])
                            for p in prompts]
                    drain_inline(engine, reqs)
                    wall = time.perf_counter() - t0
                    if wall < best_wall:
                        best_wall, best = wall, reqs
            finally:
                gc.enable()
            torch.cuda.synchronize()
            launched = read_counts()
            require(rt.tracer.dropped == 0, "zipf arm: trace records dropped")
            plan = fleet_launch_plan(rt.tracer.records(), n_layers)
        k1, k4 = (launched["flash_attention"],
                  launched["fused_single_query_attention"])
        require(k1 == plan["K1"] and k4 == plan["K4"]
                and plan["decode_steps"] > 0,
                f"zipf arm (pool {prefix_cache}): K1 {k1}, K4 {k4}, the "
                f"engine's spans call for {plan['K1']} and {plan['K4']}")
        return best, best_wall, engine.prefix_stats(), {"K1": k1, "K4": k4,
                                                        "plan": plan}

    bucket = bucket_length(z["prefix"] + z["suffix"], z["config"]["max_len"],
                           z["new"])
    reuse, reuse_wall, pool, reuse_counts = run(True)
    plain, plain_wall, _, plain_counts = run(False)
    require(all(r.status == "ok" for r in reuse + plain)
            and all(a.tokens == b.tokens for a, b in zip(reuse, plain)),
            "zipf arm: reuse tokens differ from no-reuse tokens")
    total = (1 + z["reps"]) * sum(len(p) for p in prompts)
    out = {"reuse_goodput": sum(len(r.tokens) for r in reuse) / reuse_wall,
           "plain_goodput": sum(len(r.tokens) for r in plain) / plain_wall,
           "suffix_fraction": 1.0 - pool["hit_tokens"] / total,
           "hit_rate": pool["hit_rate"], "hits": pool["hits"],
           "resident_rows": pool["resident_rows"],
           "resident_bytes": pool["resident_bytes"], "bucket": bucket,
           "launches": {"reuse": reuse_counts, "plain": plain_counts}}
    out["speedup"] = out["reuse_goodput"] / out["plain_goodput"]
    print(f"zipf prefix arm (bench_serve arm 5: vocab {vocab}, d_model "
          f"{z['config']['d_model']}, {z['config']['n_heads']} heads, f32; "
          f"{z['n']} prompts over 4 {z['prefix']}-token prefixes, bucket "
          f"{bucket}): goodput {out['reuse_goodput']:.1f} tokens/s with "
          f"the pool vs {out['plain_goodput']:.1f} without "
          f"({out['speedup']:.3f}x); suffix fraction "
          f"{out['suffix_fraction']:.4f}, hit rate {out['hit_rate']:.4f}, "
          f"{out['resident_rows']} rows resident; tokens equal; launches "
          f"K1 {reuse_counts['K1']} / {plain_counts['K1']} and K4 "
          f"{reuse_counts['K4']} / {plain_counts['K4']} (with / without the "
          f"pool, equal to the engines' spans: {n_layers} x "
          f"{reuse_counts['plan']['decode_steps']} / "
          f"{plain_counts['plan']['decode_steps']} steps) [{card}]")
    return out


def bench_router(dev, card) -> dict:
    """bench.py bench_serve arm 3: the serving bench's 48 requests through
    a 2-replica router with replica r1 slowed 4x (`inject_slow(4.0)`)
    against one healthy replica behind the same router; goodput (best of
    3 timed passes after a warm one), the ratio, the healthy replica's
    share of the routed attempts; every token equal to the offline
    engine's.  f32, so the exact gate holds whatever the batch
    composition."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models.generate import ServingWeights
    from mmlspark_tpu_torch.serve import (RouterConfig, ServeConfig,
                                          build_fleet)
    b = SERVE_BENCH
    variables = ModelBundle.init("TransformerLM", SERVE_BENCH_CONFIG,
                                 seed=0).variables
    bundle = ModelBundle("TransformerLM", {**SERVE_BENCH_CONFIG,
                                           "dtype": "float32"}, variables)
    prompts, budgets, scfg = serve_bench_workload()

    def run_router(n_replicas: int, degrade=None) -> tuple:
        router = build_fleet(bundle, cfg=RouterConfig(
            replicas=n_replicas, queue_capacity=max(b["n_req"], b["offered"]),
            default_deadline_s=600.0, drain_timeout_s=60.0,
            hang_timeout_s=600.0), serve_cfg=ServeConfig(**dict(
                scfg, queue_capacity=b["max_batch"], warmup_joins=True)),
            device=dev)
        router.warmup()
        if degrade is not None:
            router.replicas[degrade].inject_slow(4.0)

        def pass_once():
            t0 = time.perf_counter()
            reqs = [router.submit(p, max_new_tokens=n)
                    for p, n in zip(prompts, budgets)]
            while any(not r.finished for r in reqs):
                router._tick()
            return reqs, time.perf_counter() - t0

        pass_once()
        best_wall, best = float("inf"), None
        for _ in range(b["reps"]):
            reqs, wall = pass_once()
            if wall < best_wall:
                best_wall, best = wall, reqs
        stats = router.stats()
        router.stop()
        return best, best_wall, stats

    fleet, fleet_wall, fleet_stats = run_router(2, degrade=1)
    single, single_wall, _ = run_router(1)
    ref = offline_tokens(ServingWeights(bundle.module(dev)), prompts,
                         b["long_new"], b["chunk"], dev)
    exact = sum(r.status == "ok" and r.tokens == ref[i][:budgets[i]]
                for i, r in enumerate(fleet))
    require(exact == len(prompts),
            f"router arm: {exact}/{len(prompts)} requests equal the offline "
            f"tokens")

    def goodput(reqs, wall):
        return sum(len(r.tokens) for r in reqs if r.status == "ok") / wall

    routed = {n: h["routed"] for n, h in fleet_stats["replicas"].items()}
    out = {"fleet_goodput": goodput(fleet, fleet_wall),
           "single_goodput": goodput(single, single_wall),
           "healthy_share": routed["r0"] / max(1, sum(routed.values())),
           "routed": routed}
    out["ratio"] = out["fleet_goodput"] / out["single_goodput"]
    print(f"router arm (bench_serve arm 3: d_model "
          f"{SERVE_BENCH_CONFIG['d_model']}, f32; {b['n_req']} requests): "
          f"2 replicas, r1 slowed 4x, {out['fleet_goodput']:.1f} tokens/s "
          f"vs one healthy replica {out['single_goodput']:.1f} "
          f"(ratio {out['ratio']:.3f}); healthy share "
          f"{out['healthy_share']:.3f} of {sum(routed.values())} routed; "
          f"{exact}/{len(prompts)} equal the offline tokens [{card}]")
    return out


# chip_smoke phase 14: the disaggregated tiers at the width of phase 6
TIER_SERVE = dict(max_new_tokens=MAX_NEW, max_batch=8, segment_steps=16,
                  cache_chunk=64, prefill_chunk=512)


def probe_tiers(router) -> dict:
    """Instrument a tiered fleet on the router's own thread: K1 and K4
    launches attributed to the replica whose scheduler pass made them
    (replicas tick in series; the bus launches no kernel), the prefill
    tier's `serve_step` calls, and the handoff byte check — the pages a
    decode replica received equal, byte for byte, the pages the prefill
    tier serialized for that request, and the row `splice_remote` seated
    equals those pages' tensors bitwise.  Also each splice's wall time,
    and its row's first decode segment after it."""
    from mmlspark_tpu_torch.ops.decode_attention import \
        fused_single_query_attention
    from mmlspark_tpu_torch.ops.flash_attention import flash_attention
    probe = {"k1": {}, "k4": {}, "prefill_steps": 0, "pages_checked": 0,
             "rows_checked": 0, "bad": [], "splice_to_decode_ms": [],
             "sent": {}, "pending": {}}
    for rep in router.replicas:
        probe["k1"][rep.name] = probe["k4"][rep.name] = 0

        def ticked(name=rep.name, tick=rep.engine._tick):
            k1, k4 = (flash_attention.launches,
                      fused_single_query_attention.launches)
            try:
                return tick()
            finally:
                probe["k1"][name] += flash_attention.launches - k1
                probe["k4"][name] += fused_single_query_attention.launches - k4
        rep.engine._tick = ticked
        eng = rep.engine._engines["primary"]
        if rep.role == "prefill":
            def step(*a, _step=eng.serve_step, **kw):
                probe["prefill_steps"] += 1
                return _step(*a, **kw)
            eng.serve_step = step
        else:
            def splice(prompt, max_new, deadline, first_tok, src, lane=
                       "primary", trace=None, engine=rep.engine,
                       _splice=rep.engine.splice_remote):
                req = _splice(prompt, max_new, deadline, first_tok, src,
                              lane=lane, trace=trace)
                if req is None:
                    return req
                g = engine._groups[(req.bucket, lane)]
                slot = next(i for i, r in enumerate(g.rows) if r is req)
                same = all(torch.equal(d[slot, :s.shape[1]],
                                       s[0].to(d.device))
                           for dl, sl in zip(g.caches, src)
                           for d, s in zip(dl, sl))
                probe["rows_checked"] += 1
                if not same:
                    probe["bad"].append(("row", req.id))
                probe["pending"][id(req)] = (req, time.perf_counter())
                return req
            rep.engine.splice_remote = splice

            def advance(g, lane, engine=rep.engine,
                        _advance=rep.engine._advance):
                rows = [r for r in g.rows if r is not None]
                _advance(g, lane)
                now = time.perf_counter()
                for r in rows:
                    seen = probe["pending"].pop(id(r), None)
                    if seen is not None:
                        probe["splice_to_decode_ms"].append(
                            (now - seen[1]) * 1e3)
            rep.engine._advance = advance
    bus = router.handoff
    from mmlspark_tpu_torch.serve import handoff

    original = handoff.encode_page

    def encode_page(rid, index, data):
        # the page as the prefill tier serialized it, before the wire
        # (a torn page is flipped after this)
        probe["sent"].setdefault(rid, {})[index] = data
        return original(rid, index, data)
    handoff.encode_page = encode_page
    probe["undo"] = lambda: setattr(handoff, "encode_page", original)

    def try_splice(link, key, p, now, _try=bus._try_splice):
        rid, n = p["meta"]["req"], int(p["meta"]["pages"])
        sent = probe["sent"].get(rid, {})
        probe["pages_checked"] += 1
        if [p["pages"].get(i) for i in range(n)] != [sent.get(i)
                                                     for i in range(n)]:
            probe["bad"].append(("pages", rid))
        return _try(link, key, p, now)
    bus._try_splice = try_splice
    return probe


def recover_after(router, name: str, seconds: float) -> dict:
    """A replica the handoff bus crashes restarts `seconds` later, on the
    router's own thread (its next pass after that): the process that
    comes back warm."""
    rep = router._by_name[name]
    seen = {"crashed_at": None, "recovered": 0}

    def crash(detail="replica crashed", _crash=rep.crash):
        seen["crashed_at"] = time.perf_counter()
        return _crash(detail)

    def tick(_tick=rep.tick):
        if (rep._crashed and seen["crashed_at"] is not None
                and time.perf_counter() - seen["crashed_at"] >= seconds):
            rep.recover()
            seen["crashed_at"] = None
            seen["recovered"] += 1
        return _tick()
    rep.crash = crash
    rep.tick = tick
    return seen


def phase_tiered(dev, card, benches: bool = True) -> dict:
    """The disaggregated prefill/decode tiers at full width (chip_smoke
    phase 14).

    (a) `build_fleet(RouterConfig(replicas=2, prefill_replicas=1,
        decode_replicas=1))` on this card over the slice-1 configuration,
        `ServeConfig(max_new_tokens=64, max_batch=8, segment_steps=16,
        cache_chunk=64, prefill_chunk=512)`, `start_router` +
        `start_http`: the phase-13 prompts over HTTP at f32 (tokens equal
        the offline whole-prompt `DecodeEngine`'s), bf16 and bf16 with an
        int8 cache.  Gates: every response 200 after /readyz 200; the
        handoff byte check of `probe_tiers` on every splice; K1 = n_layers
        x the prefill segments of >= 512 tokens at slot 0, every one on
        the prefill tier; K4 = n_layers x the decode steps, every one on
        the decode tier; the decode tier's estimator saw no prefill and
        the prefill tier ran no `serve_step`.  At f32 a second pass, the
        prompts one after another, under a fault plan installed before it
        (a torn page on its second transfer, a prefill crash after the
        first page of its fifth; the crashed replica restarts half a
        second later on the router's thread): every response 200 with
        the offline tokens, two transfers re-prefilled.
    (b) the bench's disaggregated arm (`bench_disagg`) and the
        interference scenario of the disagg drill at full width
        (`bench_interference`)."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    bucket_length)
    from mmlspark_tpu_torch.observe.telemetry import run_telemetry
    from mmlspark_tpu_torch.resilience.chaos import (ChaosInjector, Fault,
                                                     set_injector)
    from mmlspark_tpu_torch.serve import (RouterConfig, ServeConfig,
                                          build_fleet)
    from mmlspark_tpu_torch.serve.lifecycle import (start_http,
                                                    start_router, stop_http)
    n_layers, vocab = LM_CONFIG["n_layers"], LM_CONFIG["vocab_size"]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in PROMPT_LENGTHS]
    srng = np.random.default_rng(13)
    prefix = srng.integers(0, vocab, SHARED_PREFIX).astype(np.int32)
    shared = [np.concatenate([prefix, srng.integers(
        0, vocab, SHARED_SUFFIX).astype(np.int32)])
        for _ in range(1 + SHARED_LATER)]
    named = {**dict(enumerate(prompts)),
             **{f"shared{j}": p for j, p in enumerate(shared)}}
    names, every = list(named), list(named.values())
    buckets = tuple(sorted({bucket_length(len(p), LM_CONFIG["max_len"],
                                          MAX_NEW) for p in every}))
    base = ModelBundle.init("TransformerLM", LM_CONFIG, seed=0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {}
    for name, dtype, cache in (("f32", "float32", "model"),
                               ("bf16", "bfloat16", "model"),
                               ("bf16_int8", "bfloat16", "int8")):
        bundle = ModelBundle("TransformerLM", {**LM_CONFIG, "dtype": dtype},
                             base.variables)
        scfg = ServeConfig(**TIER_SERVE, cache_dtype=cache,
                           default_deadline_s=600.0, warmup_buckets=buckets)
        faults = None
        with run_telemetry(None) as rt:
            router = build_fleet(bundle, cfg=RouterConfig(
                replicas=2, prefill_replicas=1, decode_replicas=1,
                default_deadline_s=600.0, probe_reset_s=1.0),
                serve_cfg=scfg, device=dev)
            t0 = time.perf_counter()
            start_router(router, install_sigterm=False)
            warm_s = time.perf_counter() - t0
            probe = probe_tiers(router)
            server = start_http(router, port=0)
            port = server.server_address[1]
            try:
                ready = http_json(port, "GET", "/readyz")[0]
                health = http_json(port, "GET", "/healthz")[1]
                require(ready == 200 and health.get("role") == "tiered",
                        f"tiers {name}: /readyz {ready}, /healthz {health}")
                torch.cuda.synchronize()
                reset_counts()
                traffic = post_all(port, named)
                torch.cuda.synchronize()
                launched = read_counts()
                records = rt.tracer.records()
                stats = http_json(port, "GET", "/statz")[1]
                checked = {k: probe[k] for k in ("pages_checked",
                                                 "rows_checked", "k1", "k4",
                                                 "prefill_steps")}
                checked["k1"], checked["k4"] = (dict(probe["k1"]),
                                                dict(probe["k4"]))
                checked["s2d"] = sorted(probe["splice_to_decode_ms"])
                checked["remote_joins"] = router._by_name[
                    "d0"].engine._counts.get("remote_joins")
                checked["handoffs"] = router._by_name[
                    "p0"].engine._counts.get("handoffs")
                if name == "f32":
                    seq0 = router.handoff._seq
                    revived = recover_after(router, "p0", 0.5)
                    set_injector(ChaosInjector(script=[
                        Fault(kind="handoff_torn", at_request=seq0 + 2),
                        Fault(kind="prefill_crash_mid_transfer",
                              at_request=seq0 + 5)]))
                    try:
                        t1 = time.perf_counter()
                        fres = {i: http_json(port, "POST", "/generate", {
                            "prompt": p.tolist(), "deadline_ms": 600000})
                            for i, p in enumerate(prompts)}
                        faults = {"results": fres,
                                  "seconds": time.perf_counter() - t1,
                                  "stats": http_json(port, "GET",
                                                     "/statz")[1],
                                  "recovered": revived["recovered"]}
                    finally:
                        set_injector(None)
            finally:
                stop_http(server)
                router.stop()
                probe["undo"]()
            require(router.state == "stopped",
                    f"tiers {name}: drain ended {router.state}")
        results = traffic["results"]
        statuses = sorted({results[k][0] for k in names})
        require(statuses == [200], f"tiers {name}: statuses {statuses}")
        got = [results[k][1]["tokens"] for k in names]
        for row in got:
            require(len(row) == MAX_NEW and all(0 <= t < vocab for t in row),
                    f"tiers {name}: a row out of the vocabulary")
        hand = stats["handoff"]
        require(not probe["bad"] and checked["pages_checked"] >= len(every)
                and checked["rows_checked"] == len(every)
                and hand["spliced"] == len(every) and hand["retries"] == 0,
                f"tiers {name}: byte check {probe['bad'][:4]}, pages "
                f"checked {checked['pages_checked']}, rows "
                f"{checked['rows_checked']}, handoff {hand}")
        plan = fleet_launch_plan(records, n_layers)
        k1, k4 = (launched["flash_attention"],
                  launched["fused_single_query_attention"])
        require(k1 == plan["K1"] == checked["k1"]["p0"]
                and checked["k1"]["d0"] == 0
                and plan["whole_prefills"] > 0 and plan["chunk0_prefills"] > 0,
                f"tiers {name}: K1 {k1} ({checked['k1']}), expected "
                f"{n_layers} x ({plan['whole_prefills']} whole + "
                f"{plan['chunk0_prefills']} chunk-0) on p0")
        require(k4 == plan["K4"] == checked["k4"]["d0"]
                and checked["k4"]["p0"] == 0
                and plan["decode_steps"] > 0,
                f"tiers {name}: K4 {k4} ({checked['k4']}), expected "
                f"{n_layers} x {plan['decode_steps']} steps on d0")
        d0 = router._by_name["d0"].engine
        require(d0.estimator.snapshot()["prefill_s"] == {}
                and checked["prefill_steps"] == 0
                and checked["remote_joins"] == len(every)
                and checked["handoffs"] == len(every),
                f"tiers {name}: decode-tier prefills "
                f"{d0.estimator.snapshot()['prefill_s']}, prefill-tier "
                f"serve_step calls {checked['prefill_steps']}")
        tiers = stats["tiers"]
        require(tiers["prefill"]["replicas"] == ["p0"]
                and tiers["decode"]["replicas"] == ["d0"],
                f"tiers {name}: /statz tiers {tiers}")
        weights = ServingWeights(bundle.module(dev))
        ref = offline_tokens(weights, every, MAX_NEW, scfg.cache_chunk, dev,
                             cache_dtype=cache)
        agree = sum(int(a == b) for g, r in zip(got, ref)
                    for a, b in zip(g, r))
        if name == "f32":
            require(got == ref, "tiers f32: tokens differ from the offline "
                    "whole-prompt DecodeEngine's")
        s2d = checked["s2d"]
        out[name] = {
            "tokens_per_s": traffic["tokens"] / traffic["seconds"],
            "seconds": traffic["seconds"], "tokens": traffic["tokens"],
            "warmup_s": warm_s, "launches": {"K1": k1, "K4": k4},
            "plan": plan, "handoff": hand,
            "pages_per_request": hand["pages_sent"] / len(every),
            "bytes_per_request": hand["bytes_sent"] / len(every),
            "splice_to_first_decode_ms": {
                "median": statistics.median(s2d), "min": s2d[0],
                "max": s2d[-1], "n": len(s2d)},
            "agree_offline": f"{agree}/{MAX_NEW * len(every)}"}
        print(f"tiers {name} (p0 -> d0 over the handoff bus, HTTP, "
              f"{len(every)} requests x {MAX_NEW} tokens): "
              f"{out[name]['tokens_per_s']:.1f} tokens/s over "
              f"{traffic['seconds'] * 1e3:.1f} ms; warmup {warm_s:.2f} s; "
              f"K1 {k1} = {n_layers} x ({plan['whole_prefills']} whole + "
              f"{plan['chunk0_prefills']} chunk-0), all on p0; K4 {k4} = "
              f"{n_layers} x {plan['decode_steps']} steps, all on d0; "
              f"handoff {hand['pages_sent']} pages, {hand['bytes_sent']} "
              f"bytes ({out[name]['bytes_per_request']:.0f} a request), "
              f"overlap {hand['overlap']}; splice to first decode segment "
              f"median {statistics.median(s2d):.2f} ms [{s2d[0]:.2f}, "
              f"{s2d[-1]:.2f}]; {checked['pages_checked']} page lists and "
              f"{checked['rows_checked']} seated rows byte-equal to what p0 "
              f"serialized; tokens agree with the offline engine "
              f"{out[name]['agree_offline']} [{card}]")
        if faults is not None:
            fres, fstats = faults["results"], faults["stats"]
            fstatus = sorted({r[0] for r in fres.values()})
            fgot = [fres[i][1]["tokens"] for i in range(len(prompts))]
            fh = fstats["handoff"]
            require(fstatus == [200] and fgot == ref[:len(prompts)],
                    f"tiers faults: statuses {fstatus}, tokens equal "
                    f"{fgot == ref[:len(prompts)]}")
            require(fh["retries"] - hand["retries"] == 2
                    and fstats.get("handoff_retries", 0) == 2
                    and faults["recovered"] == 1 and not probe["bad"],
                    f"tiers faults: handoff retries {fh['retries']}, router "
                    f"{fstats.get('handoff_retries')}, p0 restarted "
                    f"{faults['recovered']}, byte check {probe['bad'][:4]}")
            out["faults"] = {"retries": fh["retries"] - hand["retries"],
                             "seconds": faults["seconds"],
                             "recovered": faults["recovered"]}
            print(f"tiers faults (f32, {len(prompts)} prompts one after "
                  f"another): a torn page and a prefill crash mid-transfer, "
                  f"both re-prefilled (p0 restarted once); "
                  f"{len(prompts)}/{len(prompts)} requests 200 with the "
                  f"offline tokens [{card}]")
        del router, weights
        torch.cuda.empty_cache()
    for name in ("f32", "bf16", "bf16_int8"):
        out[name]["bytes_vs_bf16"] = (out[name]["bytes_per_request"]
                                      / out["bf16"]["bytes_per_request"])
    if benches:
        out["disagg_arm"] = bench_disagg(dev, card)
        out["interference"] = bench_interference(dev, card)
        require(out["interference"]["passed"],
                f"interference: p99 ratio {out['interference']['p99_ratio']:.3f}"
                f" under the drill's {INTERFERENCE['min_p99_ratio']}")
    return out


def bench_disagg(dev, card) -> dict:
    """bench.py bench_serve arm 4: the serving bench's 48 requests through
    1 prefill + 1 decode replica with int8 caches and chunk-64 prefill,
    against a colocated 2-replica fleet of the same config; goodput (best
    of 3 timed passes after a warm one) and the bus's bytes, pages,
    splices and overlap.  Every token equal to the colocated engine's of
    the same config.  f32, so the exact gate holds whatever the batch
    composition (as the router arm)."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.serve import (RouterConfig, ServeConfig,
                                          ServingEngine, build_fleet)
    b = SERVE_BENCH
    variables = ModelBundle.init("TransformerLM", SERVE_BENCH_CONFIG,
                                 seed=0).variables
    bundle = ModelBundle("TransformerLM", {**SERVE_BENCH_CONFIG,
                                           "dtype": "float32"}, variables)
    prompts, budgets, scfg = serve_bench_workload()
    dcfg = dict(scfg, cache_dtype="int8", prefill_chunk=b["chunk"],
                warmup_joins=True)
    engine = ServingEngine(bundle, ServeConfig(**dcfg), device=dev).warmup()
    ref_reqs = [engine.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, budgets)]
    drain_inline(engine, ref_reqs)
    require(all(r.status == "ok" for r in ref_reqs),
            "disagg arm: the colocated engine did not finish every request")
    ref = [r.tokens for r in ref_reqs]
    del engine

    def run(tiered: bool) -> tuple:
        tiers = dict(prefill_replicas=1, decode_replicas=1) if tiered else {}
        router = build_fleet(bundle, cfg=RouterConfig(
            replicas=2, queue_capacity=max(b["n_req"], b["offered"]),
            default_deadline_s=600.0, drain_timeout_s=60.0,
            hang_timeout_s=600.0, **tiers), serve_cfg=ServeConfig(**dcfg),
            device=dev)
        router.warmup()

        def pass_once():
            t0 = time.perf_counter()
            reqs = [router.submit(p, max_new_tokens=n)
                    for p, n in zip(prompts, budgets)]
            while any(not r.finished for r in reqs):
                router._tick()
            return reqs, time.perf_counter() - t0

        pass_once()                     # warm: every shape once
        best_wall, best = float("inf"), None
        for _ in range(b["reps"]):
            reqs, wall = pass_once()
            if wall < best_wall:
                best_wall, best = wall, reqs
        stats = router.stats()
        router.stop()
        return best, best_wall, stats

    disagg, disagg_wall, dstats = run(True)
    coloc, coloc_wall, _ = run(False)
    for label, reqs in (("disagg", disagg), ("colocated fleet", coloc)):
        exact = sum(r.status == "ok" and r.tokens == ref[i]
                    for i, r in enumerate(reqs))
        require(exact == len(prompts),
                f"disagg arm: {exact}/{len(prompts)} {label} requests equal "
                f"the colocated engine's tokens")

    def goodput(reqs, wall):
        return sum(len(r.tokens) for r in reqs if r.status == "ok") / wall

    hand = dstats["handoff"]
    out = {"disagg_goodput": goodput(disagg, disagg_wall),
           "coloc_goodput": goodput(coloc, coloc_wall),
           "handoff": {k: hand[k] for k in ("bytes_sent", "pages_sent",
                                            "spliced", "overlap",
                                            "retries")}}
    out["ratio"] = out["disagg_goodput"] / out["coloc_goodput"]
    print(f"disagg arm (bench_serve arm 4: d_model "
          f"{SERVE_BENCH_CONFIG['d_model']}, 8 heads, f32 weights, int8 "
          f"cache, chunk {b['chunk']}; {b['n_req']} requests): 1 prefill + "
          f"1 decode replica {out['disagg_goodput']:.1f} tokens/s vs a "
          f"colocated 2-replica fleet {out['coloc_goodput']:.1f} (ratio "
          f"{out['ratio']:.3f}); handoff over all 4 passes "
          f"{hand['bytes_sent']} bytes, {hand['pages_sent']} pages, "
          f"{hand['spliced']} spliced, overlap {hand['overlap']}; "
          f"{len(prompts)}/{len(prompts)} equal the colocated engine's "
          f"tokens [{card}]")
    return out


# the disagg drill's interference scenario at the width of phase 6: 3
# victims decoding while 6 long prompts arrive (a 1000-token prompt is
# bucket 1024: two 512-token chunks, K1 at chunk 0).  A victim's tokens
# arrive a segment (4) at a time, so a timed pass gives 3 x 12 = 36 gaps,
# whose p99 is their largest: the gate pools 8 passes an arm (~280 gaps;
# 16 until phase 28 needed the time: pooled 1.406 over 16, the passes'
# own ratios 0.93-2.08, PERF.md section 6; 6 passes once pooled 1.144
# when one pass read 0.888), the arms' passes interleaved so that the
# host's drift over the run falls on both alike
INTERFERENCE = dict(victims=3, victim_len=20, victim_new=48, burst=6,
                    burst_len=1000, burst_new=4, seg=4, passes=8,
                    min_p99_ratio=1.2)


def bench_interference(dev, card) -> dict:
    """scripts/disagg_drill.py's interference scenario at full width, f32:
    the victims' inter-token gaps read off the wall clock of the engine
    decoding them (each replica's `_tick` timed; a gap is the engine
    time between two of a victim's token arrivals over the tokens that
    arrived), colocated (3 replicas) against tiered (2 prefill + 1
    decode).  Both fleets are built once and warmed by one pass each;
    then `passes` timed passes an arm run interleaved (colocated, tiered,
    colocated, ...), and each arm's gaps are pooled.  Gates: every
    request of every pass exact against the offline engine in both arms,
    the decode tier saw no prefill and seated every request remotely.
    Returns the pooled p99 ratio with `passed` (the ratio at the drill's
    1.2 or more; the caller holds the run to it) and every pass's own
    ratio of p99s."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    bucket_length)
    from mmlspark_tpu_torch.serve import (RouterConfig, ServeConfig,
                                          build_fleet)
    c = INTERFERENCE
    vocab = LM_CONFIG["vocab_size"]
    bundle = ModelBundle("TransformerLM", {**LM_CONFIG, "dtype": "float32"},
                         ModelBundle.init("TransformerLM", LM_CONFIG,
                                          seed=0).variables)
    rng = np.random.default_rng(21)
    victims = [rng.integers(0, vocab, c["victim_len"]).astype(np.int32)
               for _ in range(c["victims"])]
    burst = [rng.integers(0, vocab, c["burst_len"]).astype(np.int32)
             for _ in range(c["burst"])]
    buckets = tuple(sorted({bucket_length(len(p), LM_CONFIG["max_len"],
                                          c["victim_new"])
                            for p in victims + burst}))
    scfg = ServeConfig(max_new_tokens=c["victim_new"], max_batch=8,
                       segment_steps=c["seg"], cache_chunk=64,
                       prefill_chunk=512, default_deadline_s=600.0,
                       warmup_buckets=buckets)

    def fleet(tiered: bool) -> dict:
        """A warmed fleet with each replica's `_tick` timed, and its pass
        runner: `run_pass()` -> (requests, victims' gaps)."""
        tiers = (dict(replicas=3, prefill_replicas=2, decode_replicas=1)
                 if tiered else dict(replicas=3))
        router = build_fleet(bundle, cfg=RouterConfig(
            default_deadline_s=600.0, hang_timeout_s=600.0, **tiers),
            serve_cfg=scfg, device=dev)
        router.warmup()
        spent = {rep.name: 0.0 for rep in router.replicas}
        for rep in router.replicas:
            def timed(name=rep.name, tick=rep.engine._tick):
                t0 = time.perf_counter()
                try:
                    return tick()
                finally:
                    spent[name] += time.perf_counter() - t0
            rep.engine._tick = timed

        def run_pass():
            vs = [router.submit(p, max_new_tokens=c["victim_new"])
                  for p in victims]
            bs = [router.submit(p, max_new_tokens=c["burst_new"])
                  for p in burst]
            seen = {r.id: (0, None, None) for r in vs}
            gaps = []
            while any(not r.finished for r in vs + bs):
                router._tick()
                for rr in vs:
                    if not rr.attempts:
                        continue
                    host = rr.attempts[-1][0]
                    n_tok, old_host, mark = seen[rr.id]
                    cur = len(rr.stream_state()[1])
                    if cur > n_tok:
                        if mark is not None and host == old_host:
                            gaps.append((spent[host] - mark) / (cur - n_tok))
                        seen[rr.id] = (cur, host, spent[host])
            return vs + bs, gaps

        return {"router": router, "run_pass": run_pass, "passes": [],
                "gaps": [], "pass_p99": []}

    t0 = time.perf_counter()
    arms = {"colocated": fleet(False), "tiered": fleet(True)}
    for arm in arms.values():
        arm["passes"].append(arm["run_pass"]()[0])   # the warm pass
    for _ in range(c["passes"]):
        for arm in arms.values():                     # colocated first
            reqs, pass_gaps = arm["run_pass"]()
            arm["passes"].append(reqs)
            arm["gaps"] += pass_gaps
            arm["pass_p99"].append(float(np.percentile(pass_gaps, 99)))
    seconds = time.perf_counter() - t0
    tiered, coloc = arms["tiered"], arms["colocated"]
    decode = [rep for rep in tiered["router"].replicas
              if rep.role == "decode"]
    decode_prefills = sum(len(rep.engine.estimator.snapshot()["prefill_s"])
                          for rep in decode)
    remote_joins = sum(rep.engine._counts.get("remote_joins", 0)
                       for rep in decode)
    for arm in arms.values():
        arm["router"].stop()
        arm["p99_ms"] = float(np.percentile(np.asarray(arm["gaps"]), 99)) \
            * 1e3
        arm["p50_ms"] = float(np.percentile(np.asarray(arm["gaps"]), 50)) \
            * 1e3
    weights = ServingWeights(bundle.module(dev))
    ref_v = offline_tokens(weights, victims, c["victim_new"], 64, dev)
    ref_b = offline_tokens(weights, burst, c["burst_new"], 64, dev)
    ref = ref_v + ref_b
    for label, res in arms.items():
        for k, reqs in enumerate(res["passes"]):
            exact = sum(r.status == "ok" and r.tokens == ref[i]
                        for i, r in enumerate(reqs))
            require(exact == len(ref), f"interference {label} pass {k}: "
                    f"{exact}/{len(ref)} requests equal the offline tokens")
    n = c["victims"] + c["burst"]
    runs = 1 + c["passes"]
    require(decode_prefills == 0 and remote_joins >= runs * n,
            f"interference: decode-tier prefills {decode_prefills}, remote "
            f"joins {remote_joins} ({runs} passes of {n})")
    ratio = coloc["p99_ms"] / tiered["p99_ms"]
    pass_ratios = [a / b for a, b in zip(coloc["pass_p99"],
                                         tiered["pass_p99"])]
    out = {"tiered_p99_ms": tiered["p99_ms"], "coloc_p99_ms": coloc["p99_ms"],
           "tiered_p50_ms": tiered["p50_ms"], "coloc_p50_ms": coloc["p50_ms"],
           "p99_ratio": ratio, "min_p99_ratio": c["min_p99_ratio"],
           "passed": ratio >= c["min_p99_ratio"],
           "pass_ratios": pass_ratios,
           "gaps": (len(tiered["gaps"]), len(coloc["gaps"])),
           "passes": c["passes"], "seconds": seconds}
    print(f"interference (disagg drill at full width, f32: "
          f"{c['victims']} victims of {c['victim_len']} tokens x "
          f"{c['victim_new']} new, a burst of {c['burst']} x "
          f"{c['burst_len']} tokens; {c['passes']} timed passes an arm, "
          f"interleaved, pooled: {len(tiered['gaps'])} tiered / "
          f"{len(coloc['gaps'])} colocated gaps): victims' inter-token p99 "
          f"{coloc['p99_ms']:.3f} ms colocated vs {tiered['p99_ms']:.3f} ms "
          f"tiered, pooled ratio {ratio:.3f} (the drill's floor "
          f"{c['min_p99_ratio']}); p50 {coloc['p50_ms']:.3f} vs "
          f"{tiered['p50_ms']:.3f} ms; each pass's ratio of p99s "
          f"{[round(r, 3) for r in pass_ratios]}; decode tier prefills 0, "
          f"{remote_joins} remote joins; every token equal to the offline "
          f"engine's; {seconds:.1f} s of fleets and passes [{card}]")
    return out


# chip_smoke phases 15 and 16: head dims 32, then 16 and 8 -- the shapes of
# the kernel checks and times: K1 at the prefill shape of two 1024-token
# rows, K4 at the serving window of a 16-row batch
SMALL_FLASH = (2, 1024, 8)
SMALL_DECODE = (16, 1088, 8)
# phase 15's main paths: the Zipf prefix arm's width (bench.py bench_serve
# arm 5, d_model 256 over 8 heads)
D32_CONFIG = {"vocab_size": 8192, "d_model": 256, "n_heads": 8,
              "n_layers": 4, "max_len": 1024, "dtype": "bfloat16"}
D32_PROMPT, D32_NEW, D32_CHUNK = 960, 8, 64


def library_ms(fn, what: str) -> float:
    """graph_ms of the one library call that computes a kernel row's
    function.  One eager call first, so that a refusal never happens
    inside a graph capture; a refusal fails the run, so that no row's
    library time goes missing unseen."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        raise SmokeFailure(f"the library call for {what} refused its inputs: "
                           f"{str(e).splitlines()[0][:160]}") from e
    return graph_ms(fn)


def head_dim_kernel_checks(dev, card, d: int) -> dict:
    """K1 and K1[lse] at (2, 1024, 8, d), f32 and bf16, causal and not and
    at q/k offsets (the second 512 queries over the first 512 keys' block,
    and 200 rows that see no key), and K4 and K4[stats] at (16, 1088, 8, d)
    over bf16, f32 and int8 caches, each against its plain version with
    the head-dim-64/128 cases' limits; then each one's device time (a CUDA
    graph of 20 calls, median of 5), its bound, the library call's time
    where one PyTorch call computes the same function, and the plain
    version's.  Phase 15 runs it at head dim 32, phase 16 at 16 and 8."""
    from mmlspark_tpu_torch.ops.attention import NEG_INF
    from mmlspark_tpu_torch.ops.decode_attention import (
        _sm_count, _span_plan, fused_single_query_attention,
        fused_single_query_attention_plain,
        fused_single_query_attention_stats,
        fused_single_query_attention_stats_plain)
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain, flash_attention_with_lse,
        flash_attention_with_lse_plain)
    from mmlspark_tpu_torch.quant.quantize import quantize_kv
    gen = torch.Generator(device=dev).manual_seed(d)
    b, s, h = SMALL_FLASH
    shape = (b, s, h, d)
    errs: dict = {}
    qkv = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        qkv[dtype] = (q, k, v)
        bf16 = dtype == torch.bfloat16
        out_tol, lse_tol = (2e-2, 1e-3) if bf16 else (1e-4, 1e-4)
        key = "k1_bf16" if bf16 else "k1_f32"
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal)
            out, lse = flash_attention_with_lse(q, k, v, causal)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v,
                                                              causal)
            err, norm_err = out_errs(got, ref_out)
            lse_err = (lse - ref_lse).abs().max().item()
            print(f"head dim {d}: flash_attention / _with_lse {shape} "
                  f"causal={causal} {dtype}: out max_abs_err={err:.3e} (tol "
                  f"{out_tol}), ||d||/||ref|| {norm_err:.3e} (tol "
                  f"{OUT_NORM_TOL[dtype]}); with lse bitwise equal "
                  f"{torch.equal(got, out)}; lse max_abs_err={lse_err:.3e} "
                  f"(tol {lse_tol})")
            require(err <= out_tol and norm_err <= OUT_NORM_TOL[dtype]
                    and lse_err <= lse_tol and torch.equal(got, out),
                    f"head dim {d}: K1 disagrees (causal={causal} {dtype})")
            errs[key] = max(errs.get(key, 0.0), err)
        half = s // 2
        for q_off, k_off in ((half, 0), (0, 200)):
            args = tuple(t.contiguous() for t in (
                q[:, half:], k[:, :half], v[:, :half])) if q_off else (q, k, v)
            out, lse = flash_attention_with_lse(*args, True, None, q_off,
                                                k_off)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_attention_with_lse_plain(
                *args, True, None, q_off, k_off)
            err, norm_err = out_errs(out, ref_out)
            lse_err = (lse - ref_lse).abs().max().item()
            hidden = max(0, k_off - q_off)
            dark = (torch.count_nonzero(out[:, :hidden]).item() == 0
                    and bool((lse[:, :hidden] == NEG_INF).all()))
            print(f"head dim {d}: flash_attention_with_lse q/k offsets "
                  f"{q_off}/{k_off} over {tuple(args[0].shape)} causal "
                  f"{dtype}: out max_abs_err={err:.3e}, ||d||/||ref|| "
                  f"{norm_err:.3e}; lse max_abs_err={lse_err:.3e}; {hidden} "
                  f"rows that see no key exactly 0 / NEG_INF: {dark}")
            require(err <= out_tol and norm_err <= OUT_NORM_TOL[dtype]
                    and lse_err <= lse_tol and dark,
                    f"head dim {d}: K1[lse] disagrees at offsets "
                    f"{q_off}/{k_off} ({dtype})")
            errs[key] = max(errs[key], err)

    b4, window, h4 = SMALL_DECODE
    decode_shape = (b4, window, h4, d)
    bucket = window - 64
    cases = {}
    for kind in ("bf16", "f32", "int8"):
        dtype = torch.float32 if kind == "f32" else torch.bfloat16
        q = torch.randn((b4, h4, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(decode_shape, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        true_len = torch.randint(1, bucket + 1, (b4,), generator=gen,
                                 device=dev)
        visible = engine_mask(b4, window, bucket, bucket + 40, true_len)
        visible[-1] = False                       # a fully masked row
        kw = {}
        if kind == "int8":
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            kw = dict(k_scale=ks, v_scale=vs)
        cases[kind] = (q, k, v, visible, kw)
        got = fused_single_query_attention(q, k, v, visible, **kw)
        acc, m, l = fused_single_query_attention_stats(q, k, v, visible,
                                                       **kw)
        torch.cuda.synchronize()
        err = (got - fused_single_query_attention_plain(
            q, k, v, visible, **kw)).abs().max().item()
        r_acc, r_m, r_l = fused_single_query_attention_stats_plain(
            q, k, v, visible, **kw)
        e_acc = ((acc - r_acc).abs().max() / r_acc.abs().max()).item()
        e_l = ((l - r_l).abs().max() / r_l.abs().max()).item()
        e_m = (m[:-1] - r_m[:-1]).abs().max().item()
        print(f"head dim {d}: fused_single_query_attention {decode_shape} "
              f"cache={kind}: max_abs_err={err:.3e} (tol 2e-3); _stats acc "
              f"{e_acc:.3e}, l {e_l:.3e} of max|ref| (tol 1e-4), m "
              f"{e_m:.3e} (tol 1e-4)")
        require(err <= 2e-3 and e_acc <= 1e-4 and e_l <= 1e-4
                and e_m <= 1e-4 and torch.count_nonzero(got[-1]).item() == 0
                and bool((l[-1] == 0).all()),
                f"head dim {d}: K4 / K4[stats] disagree (cache={kind})")
        errs[f"k4_{kind}"] = err
        errs[f"k4s_{kind}"] = (acc - r_acc).abs().max().item()
    repeat_and_graph_check(
        lambda: fused_single_query_attention(*cases["int8"][:4],
                                             **cases["int8"][4]),
        f"fused_single_query_attention {decode_shape} cache=int8")
    repeat_and_graph_check(
        lambda: flash_attention(*qkv[torch.bfloat16], causal=True),
        f"flash_attention {shape} causal bf16")

    # times, bounds, library calls
    entries: dict = {}

    def entry(name, replaces, err, ms, plain_ms, bound, lib_ms):
        entries[name] = {
            "name": name, "route": "cuda",
            "source": ("mmlspark_tpu_torch/csrc/flash_attention.cu"
                       if name.startswith("flash") else
                       "mmlspark_tpu_torch/csrc/decode_attention.cu"),
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "bound_term": bound[2], "library_ms": lib_ms}

    flops = 4.0 * b * h * d * (s * (s + 1) / 2)        # QK^T + PV, causal
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, ", f32")):
        q, k, v = qkv[dtype]
        item = q.element_size()
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        for lse in (False, True):
            name = f"flash_attention[{'lse, ' if lse else ''}d{d}{tag}]"
            if lse:
                ms = graph_ms(lambda: flash_attention_with_lse(q, k, v, True))
                plain_ms = graph_ms(lambda: flash_attention_with_lse_plain(
                    q, k, v, True), calls=3)
                # PyTorch's flash forward returns the lse too (bf16 only);
                # at f32 its memory-efficient forward does
                lib_ms = (library_ms(
                    lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                        qt, kt, vt, 0.0, True), name)
                    if dtype == torch.bfloat16 else library_ms(
                    lambda: torch.ops.aten
                    ._scaled_dot_product_efficient_attention(
                        qt, kt, vt, None, True, is_causal=True), name))
            else:
                ms = graph_ms(lambda: flash_attention(q, k, v, causal=True))
                plain_ms = graph_ms(lambda: flash_attention_plain(
                    q, k, v, causal=True), calls=3)
                lib_ms = library_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), name)
            nbytes = 4.0 * b * s * h * d * item + (b * s * h * 4 if lse else 0)
            bound = attention_bound(flops, nbytes,
                                    b * h * visible_pairs(s, s, True), peak)
            print(f"timing {name} {shape} causal, device time (CUDA "
                  f"graph): {ms:.4f} ms; plain {plain_ms:.4f} ms; library "
                  f"{lib_ms:.4f} ms; "
                  f"bound {bound[0]:.4f} ms ({bound[2]}); "
                  f"{flops / ms / 1e9:.1f} TFLOP/s, {bound[0] / ms:.3f} of "
                  f"the bound [{card}]")
            entry(name, "mmlspark_tpu/ops/flash_attention.py:148",
                  errs["k1_bf16" if dtype == torch.bfloat16 else "k1_f32"],
                  ms, plain_ms, bound, lib_ms)

    span, n_spans = _span_plan(window, b4 * h4, _sm_count(dev))
    for kind in ("bf16", "f32", "int8"):
        q, k, v, visible, kw = cases[kind]
        n_visible = int(visible.sum().item())
        bound = stats_bound(b4, h4, d, n_visible, window,
                            k.element_size(), kind == "int8")
        lib_ms = None
        if kind != "int8":
            mask = visible[:, None, None, :]
            lib_ms = library_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask), f"K4 d{d} {kind}")
        for stats in (False, True):
            fn = (fused_single_query_attention_stats if stats
                  else fused_single_query_attention)
            plain = (fused_single_query_attention_stats_plain if stats
                     else fused_single_query_attention_plain)
            ms = graph_ms(lambda: fn(q, k, v, visible, **kw))
            plain_ms = graph_ms(lambda: plain(q, k, v, visible, **kw))
            base = ("fused_single_query_attention_stats" if stats
                    else "fused_single_query_attention")
            name = (f"{base}[d{d}]" if kind == "bf16"
                    else f"{base}[d{d}, {kind}]")
            print(f"timing {name} {decode_shape}, {n_spans} spans of {span} "
                  f"slots, device time (CUDA graph): {ms:.4f} ms; plain "
                  f"{plain_ms:.4f} ms; library "
                  f"{'none' if stats or lib_ms is None else f'SDPA {lib_ms:.4f} ms'}"
                  f"; bound {bound[0]:.4f} ms ({bound[2]}), "
                  f"{bound[0] / ms:.3f} of it [{card}]")
            entry(name, "mmlspark_tpu/ops/decode_attention.py:245" + (
                " (fused_single_query_attention_stats, :326)" if stats
                else ""), errs[f"k4s_{kind}" if stats else f"k4_{kind}"], ms,
                plain_ms, bound, None if stats else lib_ms)
    return entries


def d32_main_paths(dev, card) -> dict:
    """The main paths that run the head-dim-32 instances, at the Zipf
    arm's width with seeded weights: `TextGenerator.transform` on two
    960-token prompts (bucket 1016: K1 at every layer's whole prefill, K4
    at every decode step) at bf16, bf16 with an int8 cache and f32, and
    the seq=2 `DecodeEngine` (both shards on this card: K1[lse] on the
    ring prefill, K4[stats] per shard) at bf16.  Launches counted from 0
    around each run; f32 greedy tokens equal the recompute oracle's."""
    from mmlspark_tpu_torch import DataTable, ModelBundle, TextGenerator
    from mmlspark_tpu_torch.core.table import object_column
    from mmlspark_tpu_torch.models import DecodeEngine
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    naive_generate)
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    n_layers, vocab = D32_CONFIG["n_layers"], D32_CONFIG["vocab_size"]
    base = ModelBundle.init("TransformerLM", D32_CONFIG, seed=2)
    rng = np.random.default_rng(32)
    rows = [rng.integers(0, vocab, D32_PROMPT).astype(np.int32)
            for _ in range(2)]
    table = DataTable({"prompt": object_column(rows)})
    out: dict = {}
    for name, dtype, kv in (("bf16", "bfloat16", None),
                            ("int8", "bfloat16", "int8"),
                            ("f32", "float32", None)):
        bundle = ModelBundle("TransformerLM", {**D32_CONFIG, "dtype": dtype},
                             base.variables)
        stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                              maxNewTokens=D32_NEW, kvCacheDtype=kv)
        stage.transform(table)                    # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = stage.transform(table)["generated"]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = read_counts()
        k1, k4 = (launched["flash_attention"],
                  launched["fused_single_query_attention"])
        # one prefill batch of both rows, then D32_NEW - 1 decode steps
        require(k1 == n_layers and k4 == n_layers * (D32_NEW - 1),
                f"head dim 32 TextGenerator {name}: K1 {k1}, K4 {k4}, "
                f"expected {n_layers} and {n_layers * (D32_NEW - 1)}")
        out[name] = {"K1": k1, "K4": k4,
                     "tokens_per_s": len(rows) * D32_NEW / seconds}
        if name == "f32":
            module = bundle.module(dev)
            refs = [naive_generate(module, r[None], D32_NEW)[0] for r in rows]
            equal = all(np.array_equal(g, r) for g, r in zip(got, refs))
            require(equal, "head dim 32 TextGenerator f32: tokens differ "
                    "from the recompute oracle's")
        print(f"head dim 32 main path TextGenerator.transform {name}: "
              f"{len(rows)} rows x {D32_PROMPT} + {D32_NEW} tokens in "
              f"{seconds * 1e3:.1f} ms; launches K1 {k1} = {n_layers} x 1 "
              f"prefill, K4 {k4} = {n_layers} x {D32_NEW - 1} steps [{card}]")
    shards = 2
    mesh = make_mesh(MeshSpec(data=1, model=1, seq=shards),
                     [torch.device(dev.type, 0)] * shards)
    prompts = np.stack(rows)
    true_len = np.full(len(rows), D32_PROMPT, np.int32)
    for name, dtype, kv in (("bf16", "bfloat16", "model"),
                            ("int8", "bfloat16", "int8"),
                            ("f32", "float32", "model")):
        bundle = ModelBundle("TransformerLM", {**D32_CONFIG, "dtype": dtype},
                             base.variables)
        engine = DecodeEngine(ServingWeights(bundle.module(dev)), D32_NEW,
                              chunk=D32_CHUNK, mesh=mesh, cache_dtype=kv,
                              device=dev)
        engine.generate(prompts, true_len)        # warm-up
        torch.cuda.synchronize()
        reset_counts()
        engine.generate(prompts, true_len)
        torch.cuda.synchronize()
        launched = read_counts()
        lse, stats = (launched["flash_attention[lse]"],
                      launched["fused_single_query_attention_stats"])
        want = n_layers * (D32_NEW - 1) * shards
        # the ring prefill: one launch per live (shard, block) pair a layer
        want_lse = n_layers * shards * (shards + 1) // 2
        require(lse == want_lse and stats == want,
                f"head dim 32 seq=2 engine {name}: K1[lse] {lse}, "
                f"K4[stats] {stats} (expected {want_lse} and {want})")
        out[f"seq2_{name}"] = {"K1[lse]": lse, "K4[stats]": stats}
        print(f"head dim 32 main path DecodeEngine over a seq=2 mesh (both "
              f"shards on this card), {name}: launches K1[lse] {lse} = "
              f"{n_layers} x {shards * (shards + 1) // 2} (shard, block) "
              f"pairs, "
              f"K4[stats] {stats} = {n_layers} x {D32_NEW - 1} steps x "
              f"{shards} shards [{card}]")
    return out


def phase_head_dim_32(dev, card) -> tuple:
    """chip_smoke phase 15: K1, K1[lse], K4 and K4[stats] at head dim 32
    (their checks and times, `head_dim_kernel_checks`) and the main paths
    that run those instances (`d32_main_paths`): the kernels-line rows
    with their launches, and the paths' counts."""
    entries = head_dim_kernel_checks(dev, card, 32)
    paths = d32_main_paths(dev, card)
    launches = {
        "flash_attention[d32]": paths["bf16"]["K1"],
        "flash_attention[d32, f32]": paths["f32"]["K1"],
        "flash_attention[lse, d32]": paths["seq2_bf16"]["K1[lse]"],
        "flash_attention[lse, d32, f32]": paths["seq2_f32"]["K1[lse]"],
        "fused_single_query_attention[d32]": paths["bf16"]["K4"],
        "fused_single_query_attention[d32, int8]": paths["int8"]["K4"],
        "fused_single_query_attention[d32, f32]": paths["f32"]["K4"],
        "fused_single_query_attention_stats[d32]":
            paths["seq2_bf16"]["K4[stats]"],
        "fused_single_query_attention_stats[d32, int8]":
            paths["seq2_int8"]["K4[stats]"],
        "fused_single_query_attention_stats[d32, f32]":
            paths["seq2_f32"]["K4[stats]"]}
    require(set(launches) == set(entries),
            f"head dim 32: timed {sorted(entries)}, counted "
            f"{sorted(launches)}")
    return [{**entries[n], "launches": c} for n, c in launches.items()], paths


# chip_smoke phase 16: head dims 8 and 16 (and K2/K3 at 32).  The main
# paths: (a) the LM example's configuration (examples/example_401_lm_
# generation.py: head dim 8; its corpus, adam at 3e-3 cosine, 30 epochs of
# 64 rows at batch 32), trained here with flash attention; (b)
# `TransformerLM`'s default widths (mmlspark_tpu/models/definitions.py:
# head dim 16); (c) the Zipf arm's width (ZIPF, head dim 32) trained
EXAMPLE_CONFIG = {"vocab_size": 16, "d_model": 32, "n_heads": 4,
                  "n_layers": 2, "max_len": 40, "dtype": "float32"}
EXAMPLE = dict(rows=64, seq=24, batch=32, prompt=8, new=12, seq2_chunk=8)
DEFAULT_LM_CONFIG = {"vocab_size": 256, "d_model": 128, "n_heads": 8,
                     "n_layers": 2, "max_len": 2048, "dtype": "bfloat16"}
DEFAULT_PROMPTS, DEFAULT_NEW = (600, 900, 1200, 1500), 16
SEQ2_PROMPT, SEQ2_CHUNK = 960, 64
# (path, head dim, (B, S, H)): where training paths (a) and (c) launch K2
# and K3 -- the LM example's batch of 23-token rows over 4 heads of 8, the
# Zipf width's 8 x 1024 over 8 heads of 32.  Path (b)'s, (8, 2048, 8) at
# head dim 16, is the training shape every narrow row is timed at.
PATH_BWD_SHAPES = (
    ("a", EXAMPLE_CONFIG["d_model"] // EXAMPLE_CONFIG["n_heads"],
     (EXAMPLE["batch"], EXAMPLE["seq"] - 1, EXAMPLE_CONFIG["n_heads"])),
    ("c", ZIPF["config"]["d_model"] // ZIPF["config"]["n_heads"],
     (TRAIN_BATCH, ZIPF["config"]["max_len"], ZIPF["config"]["n_heads"])))


def small_dim_backward_checks(dev, card) -> dict:
    """K2 and K3 at head dims 8, 16 and 32, bf16 and f32, at the training
    shape (8, 2048, 8, d) and at PATH_BWD_SHAPES, causal, against plain
    with phase 4's limits, a second launch bitwise equal
    (`check_backward`); then each one's time, bound, plain and library
    times (`time_backward`)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    shapes = [(d, (TRAIN_BATCH, TRAIN_SEQ, 8), "") for d in (8, 16, 32)]
    shapes += [(d, shape, f", {shape}") for _, d, shape in PATH_BWD_SHAPES]
    entries = {}
    for d, (b, s, h), at in shapes:
        for dtype, tag in ((torch.bfloat16, ""), (torch.float32, ", f32")):
            args = backward_inputs(gen, b, s, s, True, 0, 0, dtype, d, h)
            abs_err = check_backward(args, d, dtype,
                                     f"head dim {d}: flash backward ({b}, "
                                     f"{s}, {h}, {d}) causal {dtype}")
            entries.update(backward_entries(d, tag + at, abs_err,
                                            time_backward(card, gen, d, dtype,
                                                          args, (b, s, h))))
            del args
    return entries


# the wgmma kernels at head dims 8-32 (bf16 K1 `flash_fwd_bf16_narrow`, K2
# `flash_bwd_dq_narrow`, K3 `flash_bwd_dkv_narrow`): the split walk's and
# the 128-row CTA's edges, ragged non-causal sides, the phase-15 offsets,
# H = 1 and 3 (statistics rows that are not 16-byte multiples).  The cases of
# tests/test_torch_package.py::test_narrow_wgmma_kernels_match_plain.
# (B, Sq, Sk, H, causal, q_offset, k_offset)
NARROW_CASES = ((2, 33, 33, 8, True, 0, 0), (2, 96, 96, 8, True, 0, 0),
                (2, 1000, 1000, 8, True, 0, 0),
                (2, 300, 700, 8, False, 0, 0), (2, 700, 300, 8, False, 0, 0),
                (2, 512, 512, 8, True, 512, 0), (2, 512, 512, 8, True, 0, 200),
                (2, 128, 128, 8, True, 0, 0), (2, 129, 129, 8, True, 0, 0),
                (2, 192, 192, 8, True, 0, 0), (1, 200, 200, 1, True, 0, 0),
                (3, 130, 130, 3, True, 0, 0), (2, 1, 640, 3, True, 500, 0))


def narrow_kernel_checks(dev, card) -> None:
    """bf16 K1, K1[lse], K2 and K3 at head dims 8, 16 and 32 on
    NARROW_CASES against plain with the head-dim-64/128 limits: K1's out
    equal to K1[lse]'s, a second launch of each bitwise equal to the
    first, each wrapper's launch count, rows that see no key exactly zero
    out and dQ with lse NEG_INF, keys no query reaches exactly zero
    gradients."""
    from mmlspark_tpu_torch.ops.attention import NEG_INF
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_with_lse,
        flash_attention_with_lse_plain, flash_block_grads_plain,
        flash_bwd_dkv, flash_bwd_dq)
    worst = [0.0, 0.0, 0.0, 0.0]   # out max|d|, dQ, dK, dV ||d||/||ref||
    for d in (8, 16, 32):
        for b, sq, sk, h, causal, q_off, k_off in NARROW_CASES:
            gen = torch.Generator(device=dev).manual_seed(sq + 7 * sk + h + d)
            q, do = (torch.randn((b, sq, h, d), generator=gen, device=dev)
                     .to(torch.bfloat16) for _ in range(2))
            k, v = (torch.randn((b, sk, h, d), generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
            scale = d ** -0.5
            what = (f"head dim {d}: bf16 K1/K2/K3 (B, Sq, Sk, H) = ({b}, "
                    f"{sq}, {sk}, {h}) causal={causal} offsets "
                    f"{q_off}/{k_off}")
            before = read_counts()
            out, lse = flash_attention_with_lse(q, k, v, causal, None, q_off,
                                                k_off)
            again = flash_attention_with_lse(q, k, v, causal, None, q_off,
                                             k_off)
            no_lse = (flash_attention(q, k, v, causal=causal)
                      if q_off == k_off == 0 else out)
            ref_out, ref_lse = flash_attention_with_lse_plain(
                q, k, v, causal, None, q_off, k_off)
            delta = (do.float() * ref_out.float()).sum(-1)
            grads, grads2 = ((flash_bwd_dq(q, k, v, do, ref_lse, delta,
                                           causal, scale, q_off, k_off),
                              *flash_bwd_dkv(q, k, v, do, ref_lse, delta,
                                             causal, scale, q_off, k_off))
                             for _ in range(2))
            torch.cuda.synchronize()
            launched = {n: c - before[n] for n, c in read_counts().items()}
            want = {"flash_attention": int(q_off == k_off == 0),
                    "flash_attention[lse]": 2, "flash_bwd_dq": 2,
                    "flash_bwd_dkv": 2}
            counted = all(launched[n] == c for n, c in want.items())
            refs = flash_block_grads_plain(q, k, v, do, ref_lse, delta,
                                           causal, scale, q_off, k_off)
            err, norm_err = out_errs(out, ref_out)
            lse_err = (lse - ref_lse).abs().max().item()
            g_errs = [grad_errs(a, r) for a, r in zip(grads, refs)]
            same = (torch.equal(out, again[0]) and torch.equal(lse, again[1])
                    and torch.equal(no_lse, out)
                    and all(torch.equal(a, r) for a, r in zip(grads, grads2)))
            dark = True
            if causal and k_off > q_off:
                hid = k_off - q_off
                dark = (torch.count_nonzero(out[:, :hid]).item() == 0
                        and torch.count_nonzero(grads[0][:, :hid]).item() == 0
                        and bool((lse[:, :hid] == NEG_INF).all()))
            if causal and q_off + sq < k_off + sk:
                seen = max(0, q_off + sq - k_off)
                dark = dark and all(torch.count_nonzero(g[:, seen:]).item()
                                    == 0 for g in grads[1:])
            require(err <= 2e-2 and norm_err <= 1e-2 and lse_err <= 1e-3
                    and all(m <= 2e-2 and n <= 1e-2 for m, n in g_errs)
                    and same and dark and counted,
                    f"{what}: out {err:.3e} / {norm_err:.3e}, lse "
                    f"{lse_err:.3e}, dQ dK dV {g_errs}, repeats equal "
                    f"{same}, unseen rows and keys exactly zero {dark}, "
                    f"launches {launched} (want {want})")
            worst = [max(worst[0], err)] + [max(w, e[1]) for w, e in
                                             zip(worst[1:], g_errs)]
    print(f"bf16 K1, K1[lse], K2 and K3 at head dims 8, 16, 32 on "
          f"{len(NARROW_CASES)} edge cases each: all within the limits "
          f"(worst out max_abs_err {worst[0]:.3e}, dQ / dK / dV ||d||/||ref|| "
          f"{worst[1]:.3e} / {worst[2]:.3e} / {worst[3]:.3e}), repeats "
          f"bitwise equal, launch counts exact, unseen rows and keys exactly "
          f"zero [{card}]")


def backward_entries(d: int, tag: str, abs_err: list, timed: dict) -> dict:
    """The kernels-line rows of K2 and K3 at head dim `d` (`tag`: "" or
    ", f32", then the shape where it is not the training shape) from their
    max |error| (dq, dk, dv) and `time_backward`."""
    return {f"{name}[d{d}{tag}]": {
        "name": f"{name}[d{d}{tag}]", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/flash_backward.cu",
        "replaces": ("mmlspark_tpu/ops/flash_attention.py:318"
                     if name == "flash_bwd_dq" else
                     "mmlspark_tpu/ops/flash_attention.py:330"),
        "max_abs_err": err, **timed[name]}
        for name, err in (("flash_bwd_dq", abs_err[0]),
                          ("flash_bwd_dkv", max(abs_err[1:])))}


def check_backward(args, d: int, dtype, what: str) -> list:
    """K2 and K3 on `backward_inputs` (causal, no offsets) against plain
    with phase 4's limits, a second launch bitwise equal.  Returns the max
    |error| of dq, dk, dv."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_block_grads_plain, flash_bwd_dkv, flash_bwd_dq)
    scale = d ** -0.5
    got = (flash_bwd_dq(*args, True, scale), *flash_bwd_dkv(*args, True, scale))
    again = (flash_bwd_dq(*args, True, scale),
             *flash_bwd_dkv(*args, True, scale))
    torch.cuda.synchronize()
    ref = flash_block_grads_plain(*args, True, scale)
    max_tol, norm_tol = ((2e-2, 1e-2) if dtype == torch.bfloat16
                         else (1e-4, 1e-4))
    errs = [grad_errs(a, r) for a, r in zip(got, ref)]
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    print(f"{what}: max|d|/max|ref| dq {errs[0][0]:.3e} dk {errs[1][0]:.3e} "
          f"dv {errs[2][0]:.3e} (tol {max_tol}); ||d||/||ref|| dq "
          f"{errs[0][1]:.3e} dk {errs[1][1]:.3e} dv {errs[2][1]:.3e} (tol "
          f"{norm_tol}); repeat bitwise equal {same}")
    require(all(m <= max_tol and n <= norm_tol for m, n in errs) and same,
            f"{what}: K2/K3 disagree")
    return [(a.float() - r.float()).abs().max().item()
            for a, r in zip(got, ref)]


def time_lse_f32(card, d: int, args: tuple) -> dict:
    """The f32 K1[lse] at the training shape (8, 2048, 8, d) causal, on
    `backward_inputs`' q, k, v: out and lse within 1e-4 of plain; its time
    beside its bound, plain and the library's memory-efficient forward with
    log-sum-exp (`aten._efficient_attention_forward`, the port's layout)."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse, flash_attention_with_lse_plain)
    q, k, v = args[:3]
    b, s, h, _ = q.shape
    scale = d ** -0.5
    out, lse = flash_attention_with_lse(q, k, v, True)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, True)
    err, norm_err = out_errs(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    print(f"head dim {d}: f32 flash_attention_with_lse {tuple(q.shape)} "
          f"causal: out max_abs_err={err:.3e} (tol 1e-4), ||d||/||ref|| "
          f"{norm_err:.3e} (tol 1e-4); lse max_abs_err={lse_err:.3e} (tol "
          f"1e-4)")
    require(err <= 1e-4 and norm_err <= 1e-4 and lse_err <= 1e-4,
            f"head dim {d}: f32 K1[lse] disagrees")
    del out, lse, ref_out, ref_lse
    name = f"flash_attention[lse, d{d}, f32]"
    ms = graph_ms(lambda: flash_attention_with_lse(q, k, v, True))
    plain_ms = graph_ms(lambda: flash_attention_with_lse_plain(q, k, v, True),
                        calls=3)
    lib_ms = library_ms(
        lambda: torch.ops.aten._efficient_attention_forward(
            q, k, v, None, None, None, None, None, 0.0, 1, True,
            scale=scale), name)
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    bound, by, term = attention_bound(
        flops, 4.0 * b * s * h * d * 4 + b * s * h * 4,
        b * h * visible_pairs(s, s, True), PEAK_F32_FLOPS)
    print(f"timing {name} {tuple(q.shape)} causal, device time (CUDA graph): "
          f"{ms:.4f} ms; plain {plain_ms:.4f} ms; aten efficient forward "
          f"with lse {lib_ms:.4f} ms; bound {bound:.4f} ms ({term}); "
          f"{flops / ms / 1e9:.1f} TFLOP/s, {ms / lib_ms:.2f}x the library "
          f"call, {bound / ms:.3f} of the bound [{card}]")
    return {"name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_term": term,
            "library_ms": lib_ms}


def bf16_k1_rows(dev, card, shape: tuple, seed: int) -> dict:
    """bf16 K1 and K1[lse] at `shape` (B, S, H, D) causal: out and lse
    against plain with phase 15's limits, K1's out bitwise equal to
    K1[lse]'s and a second K1[lse] launch bitwise equal to the first; then
    each one's time (CUDA graph) beside its bound, plain version and library
    call (SDPA for K1; `aten._scaled_dot_product_flash_attention`, which
    returns the log-sum-exp too, for K1[lse]).  Returns both kernels-line
    rows (without launches), named by head dim and shape."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain, flash_attention_with_lse,
        flash_attention_with_lse_plain)
    b, s, h, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    got = flash_attention(q, k, v, causal=True)
    out, lse = flash_attention_with_lse(q, k, v, True)
    again = flash_attention_with_lse(q, k, v, True)[1]
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_with_lse_plain(q, k, v, True)
    err, norm_err = out_errs(out, ref_out)
    lse_err = (lse - ref_lse).abs().max().item()
    same = torch.equal(got, out) and torch.equal(lse, again)
    print(f"bf16 flash_attention / _with_lse {shape} causal: out "
          f"max_abs_err={err:.3e} (tol 2e-2), ||d||/||ref|| {norm_err:.3e} "
          f"(tol 1e-2); lse max_abs_err={lse_err:.3e} (tol 1e-3); K1 equal "
          f"to K1[lse] and a repeat bitwise {same}")
    require(err <= 2e-2 and norm_err <= 1e-2 and lse_err <= 1e-3 and same,
            f"bf16 K1 disagrees at {shape}")
    del got, out, lse, again, ref_out, ref_lse
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    exps = b * h * visible_pairs(s, s, True)
    rows = {}
    for lse in (False, True):
        name = (f"flash_attention[{'lse, ' if lse else ''}d{d}, "
                f"({b}, {s})]")
        if lse:
            ms = graph_ms(lambda: flash_attention_with_lse(q, k, v, True))
            plain_ms = graph_ms(lambda: flash_attention_with_lse_plain(
                q, k, v, True), calls=3)
            lib, lib_ms = "aten flash forward with lse", library_ms(
                lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    qt, kt, vt, 0.0, True), name)
        else:
            ms = graph_ms(lambda: flash_attention(q, k, v, causal=True))
            plain_ms = graph_ms(lambda: flash_attention_plain(
                q, k, v, causal=True), calls=3)
            lib, lib_ms = "SDPA", library_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), name)
        bound, by, term = attention_bound(
            flops, 4.0 * b * s * h * d * 2 + (b * s * h * 4 if lse else 0),
            exps)
        print(f"timing {name} {shape} causal bf16, device time (CUDA "
              f"graph): {ms:.4f} ms; plain {plain_ms:.4f} ms; {lib} "
              f"{lib_ms:.4f} ms; bound {bound:.4f} ms ({term}); "
              f"{k1_rates(flops, ms, lib_ms, bound)} [{card}]")
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_term": term,
            "library_ms": lib_ms}
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return rows


def phase_wide_f32_backward(dev, card, grad_check: dict) -> tuple:
    """chip_smoke phase 17: the f32 training kernels at head dims 64 and
    128.  K2 and K3 at (8, 2048, 8, d) causal against plain (1e-4, a
    second launch bitwise equal) and K1[lse] on the same q, k, v, each
    timed beside its bound, plain and library call; then the f32 gradient
    check at LC_CONFIG's width (head dim 64, seq TRAIN_SEQ).  The rows'
    launches: head dim 128 from phase 11's gradient check at LM_CONFIG
    (`grad_check`), head dim 64 from this one, 4 each (one a layer)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(128)
    entries = {}
    for d in (64, 128):
        args = backward_inputs(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, True,
                               0, 0, torch.float32, d)
        abs_err = check_backward(args, d, torch.float32,
                                 f"head dim {d}: flash backward (8, 2048, 8, "
                                 f"{d}) causal f32")
        entries.update(backward_entries(d, ", f32", abs_err, time_backward(
            card, gen, d, torch.float32, args)))
        lse_row = time_lse_f32(card, d, args)
        entries[lse_row["name"]] = lse_row
        del args
        torch.cuda.empty_cache()
    grads = {64: flash_grad_check(dev, card, LC_CONFIG, TRAIN_SEQ, seed=64),
             128: grad_check}
    rows = []
    for d, check in grads.items():
        for name, key in ((f"flash_bwd_dq[d{d}, f32]", "K2"),
                          (f"flash_bwd_dkv[d{d}, f32]", "K3"),
                          (f"flash_attention[lse, d{d}, f32]", "K1[lse]")):
            rows.append({**entries[name], "launches": check["launches"][key]})
    seconds = time.perf_counter() - t0
    print(f"phase 17 (f32 training kernels at head dims 64, 128): "
          f"{seconds:.1f} s [{card}]")
    return rows, {"grad_check_d64": grads[64], "seconds": seconds}


def wide_f32_k1(dev, card) -> tuple:
    """The redesigned f32 K1 at head dims 64 and 128: checked against plain
    and timed at (2, 1024, 8, d) causal beside its bound, plain version
    and SDPA; then its main path at each width, f32 `TextGenerator` over
    one 600-token prompt (bucket 1024: K1 at each layer's prefill) of the
    repo's LM configurations of those head dims (LC_CONFIG, LM_CONFIG),
    launches counted exactly.  Returns (entries, launches)."""
    from mmlspark_tpu_torch import DataTable, ModelBundle, TextGenerator
    from mmlspark_tpu_torch.core.table import object_column
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(64)
    b, s, h = SMALL_FLASH
    entries, launches = {}, {}
    for d, config in ((64, LC_CONFIG), (128, LM_CONFIG)):
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   for _ in range(3))
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err, norm_err = out_errs(got, flash_attention_plain(q, k, v,
                                                            causal=True))
        print(f"head dim {d}: f32 flash_attention {(b, s, h, d)} causal: "
              f"max_abs_err={err:.3e} (tol 1e-4), ||d||/||ref|| "
              f"{norm_err:.3e} (tol 1e-4)")
        require(err <= 1e-4 and norm_err <= 1e-4,
                f"head dim {d}: f32 K1 disagrees")
        ms = graph_ms(lambda: flash_attention(q, k, v, causal=True))
        plain_ms = graph_ms(lambda: flash_attention_plain(q, k, v,
                                                          causal=True), calls=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        name = f"flash_attention[d{d}, f32]"
        lib_ms = library_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), name)
        flops = 4.0 * b * h * d * (s * (s + 1) / 2)
        bound, by, term = attention_bound(
            flops, 4.0 * b * s * h * d * 4, b * h * visible_pairs(s, s, True),
            PEAK_F32_FLOPS)
        print(f"timing {name} {(b, s, h, d)} causal, device time (CUDA "
              f"graph): {ms:.4f} ms; plain {plain_ms:.4f} ms; SDPA "
              f"{lib_ms:.4f} ms; bound {bound:.4f} ms ({term}); "
              f"{flops / ms / 1e9:.1f} TFLOP/s, "
              f"{bound / ms:.3f} of the bound [{card}]")
        entries[name] = {
            "name": name, "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bound_term": term,
            "library_ms": lib_ms}
        del q, k, v, qt, kt, vt, got
        bundle = ModelBundle.init("TransformerLM",
                                  {**config, "dtype": "float32"}, seed=d)
        row = np.random.default_rng(d).integers(
            0, config["vocab_size"], 600).astype(np.int32)
        stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                              maxNewTokens=4)
        table = DataTable({"prompt": object_column([row])})
        stage.transform(table)                    # warm-up
        torch.cuda.synchronize()
        reset_counts()
        stage.transform(table)
        torch.cuda.synchronize()
        k1 = read_counts()["flash_attention"]
        require(k1 == config["n_layers"],
                f"head dim {d} f32 TextGenerator: K1 {k1}, expected "
                f"{config['n_layers']}")
        print(f"head dim {d} f32 main path TextGenerator.transform, one "
              f"600-token prompt (d_model {config['d_model']}): K1 {k1} = "
              f"{config['n_layers']} layers x 1 prefill [{card}]")
        launches[name] = k1
        del bundle, stage
        torch.cuda.empty_cache()
    return entries, launches


def flash_training(dev, card, label: str, config: dict, seq: int) -> dict:
    """`Trainer.fit_arrays` of a `config` model with flash attention on
    TRAIN_ROWS rows of `seq` tokens, batch TRAIN_BATCH, at bf16 and then
    f32: K1[lse], K2 and K3 each n_layers x steps exactly, the loss falls.
    Returns per `train_<dtype>` the steps, first and last loss and those
    launches."""
    from mmlspark_tpu_torch import Trainer
    n_layers = config["n_layers"]
    rows = char_corpus(TRAIN_ROWS, seq, config["vocab_size"])
    out = {}
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "f32")):
        trainer = Trainer(train_config(
            {**config, "dtype": dtype, "attn_impl": "flash"}), device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        bundle = trainer.fit_arrays(rows[:, :-1], rows[:, 1:])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = read_counts()
        steps = bundle.metadata["steps"]
        losses = [r["loss"] for r in trainer.history]
        print(f"path {label}: fit_arrays {steps} steps of {TRAIN_BATCH}x{seq}"
              f" {tag} flash in {seconds:.2f} s, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; launches {launched} [{card}]")
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"path {label} {tag}: the loss did not fall")
        for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
            require(launched[name] == n_layers * steps,
                    f"path {label} {tag}: {name} launched {launched[name]} "
                    f"times, want {n_layers * steps}")
        out[f"train_{tag}"] = {"steps": steps,
                               "losses": [losses[0], losses[-1]],
                               "K1[lse]": launched["flash_attention[lse]"],
                               "K2": launched["flash_bwd_dq"],
                               "K3": launched["flash_bwd_dkv"]}
        del trainer, bundle
        torch.cuda.empty_cache()
    return out


def seq2_decode(dev, card, label: str, config: dict, variables,
                prompts: np.ndarray, new: int, chunk: int) -> tuple:
    """The seq=2 `DecodeEngine` (both shards on this card) over `prompts`
    with a `config` model's `variables`, at bf16, bf16 with an int8 cache
    and f32: K1[lse] on the ring prefill (n_layers x 3 (shard, block)
    pairs) and K4[stats] per shard at every decode step, both counted
    exactly.  Returns (launches, new tokens), each by cache name."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models import DecodeEngine
    from mmlspark_tpu_torch.models.generate import ServingWeights
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    shards, n_layers = 2, config["n_layers"]
    mesh = make_mesh(MeshSpec(data=1, model=1, seq=shards),
                     [torch.device(dev.type, 0)] * shards)
    true_len = np.full(len(prompts), prompts.shape[1], np.int32)
    launches, tokens = {}, {}
    for name, dtype, kv in (("bf16", "bfloat16", "model"),
                            ("int8", "bfloat16", "int8"),
                            ("f32", "float32", "model")):
        bundle = ModelBundle("TransformerLM", {**config, "dtype": dtype},
                             variables)
        engine = DecodeEngine(ServingWeights(bundle.module(dev)), new,
                              chunk=chunk, mesh=mesh, cache_dtype=kv,
                              device=dev)
        engine.generate(prompts, true_len)        # warm-up
        torch.cuda.synchronize()
        reset_counts()
        got = engine.generate(prompts, true_len)
        torch.cuda.synchronize()
        launched = read_counts()
        lse, stats = (launched["flash_attention[lse]"],
                      launched["fused_single_query_attention_stats"])
        want = (n_layers * shards * (shards + 1) // 2,
                n_layers * (new - 1) * shards)
        require((lse, stats) == want,
                f"path {label} seq=2 engine {name}: K1[lse] {lse}, K4[stats] "
                f"{stats} (expected {want})")
        launches[f"seq2_{name}"] = {"K1[lse]": lse, "K4[stats]": stats}
        tokens[name] = np.asarray(got)
        print(f"path {label} DecodeEngine over a seq=2 mesh (both shards on "
              f"this card), {name}: {prompts.shape[0]} prompts x "
              f"{prompts.shape[1]} + {new} tokens; launches K1[lse] {lse} = "
              f"{n_layers} x {shards * (shards + 1) // 2} (shard, block) "
              f"pairs, K4[stats] {stats} = {n_layers} x {new - 1} steps x "
              f"{shards} shards [{card}]")
        del engine, bundle
    torch.cuda.empty_cache()
    return launches, tokens


def example_path(dev, card) -> dict:
    """Path (a): the LM example's configuration built with the port's API:
    `Trainer.fit_arrays` with flash attention on the example's corpus,
    optimizer and epochs (K1[lse], K2, K3 at head dim 8, each n_layers x
    steps exactly; the loss falls), then `TextGenerator.transform` on 4
    prompts of 8 tokens x 12 new (K4 at head dim 8 on each of the 11
    decode steps of each layer exactly; no K1: the prompts are short), the
    continuation accuracy against the cycle printed as the example prints
    it, then the example's own oracle, `naive_generate` over the trained
    bundle's module (flash attention: K1 at head dim 8 on each of its
    n_layers x 12 forwards, exactly).  At f32, as the example, the tokens
    equal that oracle's and a dense-attention module's; at bf16 also with
    an int8 cache.  Last, the f32-trained weights decode the same prompts
    over a seq=2 mesh (`seq2_decode`: K1[lse] and K4[stats] at head dim 8),
    whose f32 tokens equal the f32 `TextGenerator`'s."""
    from mmlspark_tpu_torch import (DataTable, ModelBundle, TextGenerator,
                                    Trainer, TrainerConfig)
    from mmlspark_tpu_torch.models.generate import naive_generate
    vocab, n_layers = EXAMPLE_CONFIG["vocab_size"], EXAMPLE_CONFIG["n_layers"]
    rows = char_corpus(EXAMPLE["rows"], EXAMPLE["seq"], vocab)
    tokens, targets = rows[:, :-1], rows[:, 1:]
    prompts = tokens[:4, :EXAMPLE["prompt"]]
    new = EXAMPLE["new"]
    expect = (prompts[:, -1:] + 1 + np.arange(new)) % vocab
    out: dict = {}
    for dtype in ("float32", "bfloat16"):
        tag = "f32" if dtype == "float32" else "bf16"
        config = {**EXAMPLE_CONFIG, "dtype": dtype, "attn_impl": "flash"}
        trainer = Trainer(TrainerConfig(
            architecture="TransformerLM", model_config=config,
            optimizer="adam", learning_rate=3e-3, lr_schedule="cosine",
            epochs=30, batch_size=EXAMPLE["batch"], loss="softmax_xent",
            seed=0,
            shuffle_each_epoch=False), device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        bundle = trainer.fit_arrays(tokens, targets)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = read_counts()
        steps = bundle.metadata["steps"]
        losses = [r["loss"] for r in trainer.history]
        print(f"path (a) the LM example's configuration, {dtype}: "
              f"fit_arrays {steps} steps in {seconds:.2f} s, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches K1[lse] "
              f"{launched['flash_attention[lse]']}, K2 "
              f"{launched['flash_bwd_dq']}, K3 {launched['flash_bwd_dkv']} "
              f"= {n_layers} x {steps} [{card}]")
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"path (a) {dtype}: the loss did not fall")
        for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
            require(launched[name] == n_layers * steps,
                    f"path (a) {dtype}: {name} launched {launched[name]} "
                    f"times, want {n_layers * steps}")
        out[f"train_{tag}"] = {"steps": steps, "losses": [losses[0],
                                                          losses[-1]],
                               "K1[lse]": launched["flash_attention[lse]"],
                               "K2": launched["flash_bwd_dq"],
                               "K3": launched["flash_bwd_dkv"]}
        for kv in ((None,) if dtype == "float32" else (None, "int8")):
            stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                                  maxNewTokens=new, kvCacheDtype=kv)
            torch.cuda.synchronize()
            reset_counts()
            got = np.asarray(stage.transform(
                DataTable({"prompt": prompts}))["generated"])
            torch.cuda.synchronize()
            launched = read_counts()
            k1, k4 = (launched["flash_attention"],
                      launched["fused_single_query_attention"])
            accuracy = float((got[:, EXAMPLE["prompt"]:] == expect).mean())
            name = tag if kv is None else "int8"
            print(f"path (a) TextGenerator.transform {name}: 4 prompts x "
                  f"{EXAMPLE['prompt']} + {new} tokens; continuation accuracy "
                  f"vs the true cycle: {accuracy:.3f}; launches K1 {k1}, K4 "
                  f"{k4} = {n_layers} x {new - 1} steps [{card}]")
            require(got.shape == (4, EXAMPLE["prompt"] + new)
                    and k1 == 0 and k4 == n_layers * (new - 1),
                    f"path (a) {name}: K1 {k1}, K4 {k4} (expected 0 and "
                    f"{n_layers * (new - 1)})")
            out[f"decode_{name}"] = {"K4": k4, "accuracy": accuracy}
            if kv is not None:
                continue
            # the example's oracle: the trained bundle's own module
            torch.cuda.synchronize()
            reset_counts()
            oracle = naive_generate(bundle.module(dev), prompts, new)
            torch.cuda.synchronize()
            k1 = read_counts()["flash_attention"]
            agree = float((oracle == got).mean())
            print(f"path (a) naive_generate over the trained {tag} module "
                  f"(flash): launches K1 {k1} = {n_layers} x {new} "
                  f"forwards; tokens equal to TextGenerator's: {agree:.3f} "
                  f"[{card}]")
            require(oracle.shape == got.shape and k1 == n_layers * new,
                    f"path (a) {tag} oracle: K1 {k1} (expected "
                    f"{n_layers * new})")
            out[f"oracle_{tag}"] = {"K1": k1, "agreement": agree}
            if dtype == "float32":
                dense = naive_generate(ModelBundle(
                    "TransformerLM", {**config, "attn_impl": "dense"},
                    bundle.variables).module(dev), prompts, new)
                require(np.array_equal(got, oracle)
                        and np.array_equal(got, dense),
                        "path (a) f32: tokens differ from the recompute "
                        "oracles'")
                f32_bundle, f32_tokens = bundle, got
    launches, seq2_tokens = seq2_decode(
        dev, card, "(a)", EXAMPLE_CONFIG, f32_bundle.variables, prompts, new,
        EXAMPLE["seq2_chunk"])
    require(np.array_equal(seq2_tokens["f32"],
                           f32_tokens[:, EXAMPLE["prompt"]:]),
            "path (a) seq=2 engine f32: tokens differ from TextGenerator's")
    out.update(launches)
    return out


def default_widths_path(dev, card) -> dict:
    """Path (b): `TransformerLM` at its default widths.  `flash_training`
    at batch 8 x 2048 (K1[lse], K2, K3 at head dim 16); `TextGenerator.
    transform` on prompts of 600-1500 tokens (K1 at each bucket's prefill,
    K4 at every decode step, exactly) at bf16, bf16 with an int8 cache and
    f32, whose greedy tokens equal the recompute oracle's; the seq=2
    `DecodeEngine` at the same three (`seq2_decode`)."""
    from mmlspark_tpu_torch import DataTable, ModelBundle, TextGenerator
    from mmlspark_tpu_torch.core.table import object_column
    from mmlspark_tpu_torch.models.generate import (_PREFILL_FLASH_MIN,
                                                    bucket_length,
                                                    naive_generate)
    cfg = DEFAULT_LM_CONFIG
    vocab, n_layers = cfg["vocab_size"], cfg["n_layers"]
    out = flash_training(dev, card, "(b) TransformerLM default widths", cfg,
                         TRAIN_SEQ)

    base = ModelBundle.init("TransformerLM", cfg, seed=16)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in DEFAULT_PROMPTS]
    table = DataTable({"prompt": object_column(prompts)})
    buckets = {bucket_length(len(r), cfg["max_len"], DEFAULT_NEW)
               for r in prompts}
    n_buckets = len(buckets)
    # K1 prefills a bucket of _PREFILL_FLASH_MIN (512) tokens or more
    n_flash = len([bk for bk in buckets if bk >= _PREFILL_FLASH_MIN])
    for name, dtype, kv in (("bf16", "bfloat16", None),
                            ("int8", "bfloat16", "int8"),
                            ("f32", "float32", None)):
        bundle = ModelBundle("TransformerLM", {**cfg, "dtype": dtype},
                             base.variables)
        stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                              maxNewTokens=DEFAULT_NEW, kvCacheDtype=kv)
        stage.transform(table)                    # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        got = stage.transform(table)["generated"]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = read_counts()
        k1, k4 = (launched["flash_attention"],
                  launched["fused_single_query_attention"])
        want = (n_layers * n_flash, n_layers * (DEFAULT_NEW - 1) * n_buckets)
        require((k1, k4) == want,
                f"path (b) TextGenerator {name}: K1 {k1}, K4 {k4}, expected "
                f"{want}")
        if name == "f32":
            module = bundle.module(dev)
            equal = all(np.array_equal(
                g, naive_generate(module, r[None], DEFAULT_NEW)[0])
                for g, r in zip(got, prompts))
            require(equal, "path (b) TextGenerator f32: tokens differ from "
                    "the recompute oracle's")
        out[name] = {"K1": k1, "K4": k4,
                     "tokens_per_s": len(prompts) * DEFAULT_NEW / seconds}
        print(f"path (b) TextGenerator.transform {name}: prompts "
              f"{DEFAULT_PROMPTS} + {DEFAULT_NEW} tokens ({n_buckets} "
              f"buckets) in {seconds * 1e3:.1f} ms; launches K1 {k1} = "
              f"{n_layers} x {n_flash} prefills, K4 {k4} = {n_layers} x "
              f"{DEFAULT_NEW - 1} steps x {n_buckets}"
              f"{'; tokens equal the oracle' if name == 'f32' else ''} "
              f"[{card}]")
    seq_prompts = np.stack([rng.integers(0, vocab, SEQ2_PROMPT).astype(
        np.int32) for _ in range(2)])
    out.update(seq2_decode(dev, card, "(b)", cfg, base.variables,
                           seq_prompts, DEFAULT_NEW, SEQ2_CHUNK)[0])
    return out


def phase_small_head_dims(dev, card) -> tuple:
    """chip_smoke phase 16: K1 and K1[lse] (bf16, f32) and K4 and K4[stats]
    (bf16, int8, f32 caches) at head dims 8 and 16, the f32 K1 at 64 and
    128, and K2 and K3 (bf16, f32) at 8, 16 and 32, each against its
    plain version and timed; then the main paths that run them -- (a) the
    LM example's configuration, (b) `TransformerLM`'s default widths, (c)
    the Zipf arm's width trained (`flash_training`) -- and the f32
    gradient checks at head dims 8, 16 and 32.  Returns the kernels-line
    rows, each with its launches on those paths, and the paths' numbers."""
    t0 = time.perf_counter()
    entries = {}
    for d in (8, 16):
        entries.update(head_dim_kernel_checks(dev, card, d))
    wide, wide_launches = wide_f32_k1(dev, card)
    entries.update(wide)
    entries.update(small_dim_backward_checks(dev, card))
    narrow_kernel_checks(dev, card)
    # K1[lse] at the training shapes of paths (b) and (c)
    for i, shape in enumerate(((TRAIN_BATCH, TRAIN_SEQ, 8, 16),
                               (TRAIN_BATCH, ZIPF["config"]["max_len"], 8,
                                32))):
        entries.update({name: row for name, row in bf16_k1_rows(
            dev, card, shape, seed=216 + i).items() if "lse" in name})
    torch.cuda.empty_cache()
    paths = {"a": example_path(dev, card), "b": default_widths_path(dev, card),
             "c": flash_training(dev, card, "(c) the Zipf arm's width",
                                 ZIPF["config"], ZIPF["config"]["max_len"])}
    grads = {d: flash_grad_check(dev, card, config, seq, seed=d)
             for d, config, seq in (
                 (8, EXAMPLE_CONFIG, EXAMPLE["seq"]),
                 (16, DEFAULT_LM_CONFIG, TRAIN_SEQ),
                 (32, ZIPF["config"], ZIPF["config"]["max_len"]))}
    launches = dict(wide_launches)
    bwd_rows = [(8, "a", ""), (16, "b", ""), (32, "c", "")]
    bwd_rows += [(d, path, f", {shape}") for path, d, shape in PATH_BWD_SHAPES]
    for d, path, at in bwd_rows:
        for tag, dtype in (("", "bf16"), (", f32", "f32")):
            train = paths[path][f"train_{dtype}"]
            launches[f"flash_bwd_dq[d{d}{tag}{at}]"] = train["K2"]
            launches[f"flash_bwd_dkv[d{d}{tag}{at}]"] = train["K3"]
    launches[f"flash_attention[lse, d16, ({TRAIN_BATCH}, {TRAIN_SEQ})]"] = \
        paths["b"]["train_bf16"]["K1[lse]"]
    launches[f"flash_attention[lse, d32, ({TRAIN_BATCH}, "
             f"{ZIPF['config']['max_len']})]"] = \
        paths["c"]["train_bf16"]["K1[lse]"]
    # K1 and K4 at head dim 32 are phase 15's rows
    for d, path in ((8, paths["a"]), (16, paths["b"])):
        for tag, dtype in (("", "bf16"), (", f32", "f32")):
            launches[f"flash_attention[lse, d{d}{tag}]"] = \
                path[f"train_{dtype}"]["K1[lse]"]
            # K1 at head dim 8 runs in the example's oracle: no repo
            # configuration of head dim 8 prefills 512 tokens or more
            launches[f"flash_attention[d{d}{tag}]"] = (
                path[f"oracle_{dtype}"] if d == 8 else path[dtype])["K1"]
        for kind, cache in (("", "bf16"), (", int8", "int8"),
                            (", f32", "f32")):
            launches[f"fused_single_query_attention[d{d}{kind}]"] = (
                path[f"decode_{cache}"] if d == 8 else path[cache])["K4"]
            launches[f"fused_single_query_attention_stats[d{d}{kind}]"] = \
                path[f"seq2_{cache}"]["K4[stats]"]
    require(set(launches) == set(entries),
            f"phase 16: timed {sorted(set(entries) - set(launches))} not "
            f"counted, counted {sorted(set(launches) - set(entries))} not timed")
    seconds = time.perf_counter() - t0
    print(f"phase 16 (small head dims): {seconds:.1f} s [{card}]")
    return ([{**entries[n], "launches": c} for n, c in launches.items()],
            {"paths": paths, "grad_check": grads, "seconds": seconds})


# chip_smoke phase 18: the rest of LM decoding.  (a) speculative decoding
# at phase 6's width; (b) at the repo's speculative bench arm (bench.py
# bench_lm arm 4: 8 layers, max_len 512, 8 rows of 64 tokens, 128 new,
# k 7, cache chunk 128); (c) int8 weights at phase 6's width; (d) the
# serving engine's speculative lanes and its int8 degraded lane; (e) beam
# search
SPEC_K = 7
SPEC_BENCH_CONFIG = {"vocab_size": 8192, "d_model": 1024, "n_heads": 8,
                     "n_layers": 8, "max_len": 512, "dtype": "bfloat16"}
# reps 3 until phase 28 needed the time, 2 until phase 31 did
SPEC_BENCH = dict(batch=8, prompt=64, new=128, k=7, chunk=128, reps=1)
SPEC_SERVE_LENGTHS = (20, 70, 600, 900)
SPEC_SERVE_K = 3
BEAM = dict(prompt=600, new=16, width=4)
def lm_table(lengths, seed: int = 1) -> tuple:
    """Seeded prompts of the given lengths (phase 6's draw at seed 1 for
    PROMPT_LENGTHS) and their DataTable."""
    from mmlspark_tpu_torch import DataTable
    from mmlspark_tpu_torch.core.table import object_column
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, LM_CONFIG["vocab_size"], n).astype(np.int32)
            for n in lengths]
    return rows, DataTable({"prompt": object_column(rows)})


def count_rounds(engine) -> list:
    """Per `generate` call of `engine`, its speculative rounds: the
    engine's `generate` wrapped so that `TextGenerator.transform`, which
    calls it once a bucket, leaves the rounds of every bucket."""
    rounds: list = []
    inner = engine.generate

    def generate(*args, **kw):
        out = inner(*args, **kw)
        rounds.append(engine.last_spec_rounds)
        return out
    engine.generate = generate
    return rounds


def timed_transform(stage, table) -> tuple:
    """(output column, seconds, launch counts) of one warm
    `stage.transform(table)`, the counters zeroed just before it."""
    stage.transform(table)                        # warm-up: load, build
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = stage.transform(table)["generated"]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def spec_main_path(dev, card) -> dict:
    """Phase 18 (a): `TextGenerator(specTokens=7).set_draft_bundle(...)`
    over the phase-6 prompts at LM_CONFIG's width; the target's blocks
    1-3 softened to zero (`soften_late_blocks(..., 1, 0.0)`), the draft
    its first block.  f32 tokens equal the plain stage's and the
    recompute oracle's; K1 = (target + draft layers) x the prefills of
    buckets >= 512; K4 = rounds x (k+1) x draft layers, every draft step
    and nothing else."""
    from mmlspark_tpu_torch import ModelBundle, TextGenerator
    from mmlspark_tpu_torch.models.generate import naive_generate
    from mmlspark_tpu_torch.zoo import (soften_late_blocks,
                                        truncated_draft_bundle)
    n_layers = LM_CONFIG["n_layers"]
    rows, table = lm_table(PROMPT_LENGTHS)
    base = ModelBundle.init("TransformerLM", LM_CONFIG, seed=0)
    out: dict = {}
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        target = soften_late_blocks(ModelBundle(
            "TransformerLM", {**LM_CONFIG, "dtype": dtype}, base.variables),
            1, 0.0)
        draft = truncated_draft_bundle(target, 1)
        plain_stage = TextGenerator(target, device=dev, inputCol="prompt",
                                    maxNewTokens=MAX_NEW)
        plain, plain_s, _ = timed_transform(plain_stage, table)
        stage = TextGenerator(target, device=dev, inputCol="prompt",
                              maxNewTokens=MAX_NEW, specTokens=SPEC_K
                              ).set_draft_bundle(draft)
        engine = stage._engine_for()
        rounds = count_rounds(engine)
        got, spec_s, launched = timed_transform(stage, table)
        buckets = {engine.bucket_for(len(r)) for r in rows}
        rounds = rounds[-len(buckets):]           # the timed transform's
        prefills = sum(1 for b in buckets if b >= 512)
        k1 = launched["flash_attention"]
        k4 = launched["fused_single_query_attention"]
        require(k1 == (n_layers + 1) * prefills and prefills > 0,
                f"speculative {name}: K1 launched {k1}, expected "
                f"({n_layers} + 1) x {prefills} prefills")
        require(k4 == sum(rounds) * (SPEC_K + 1) and k4 > 0,
                f"speculative {name}: K4 launched {k4}, expected "
                f"{sum(rounds)} rounds x {SPEC_K + 1} draft steps")
        agree = sum(int((g[len(r):] == p[len(r):]).sum())
                    for g, p, r in zip(got, plain, rows))
        total = MAX_NEW * len(rows)
        if name == "f32":
            require(agree == total, f"speculative f32: {agree}/{total} "
                    f"tokens equal the plain stage's")
            module = target.module(dev)
            for g, r in zip(got, rows):
                require(np.array_equal(g, naive_generate(module, r[None],
                                                         MAX_NEW)[0]),
                        "speculative f32: tokens differ from the "
                        "recompute oracle's")
            del module
        tokens = MAX_NEW * len(rows)
        out[name] = {"tokens_per_s": tokens / spec_s,
                     "plain_tokens_per_s": tokens / plain_s,
                     "rounds": sum(rounds),
                     "acceptance": engine.last_spec_acceptance,
                     "launches": {"K1": k1, "K4": k4},
                     "agree_plain": f"{agree}/{total}"}
        print(f"speculative main path {name} (k {SPEC_K}, 1-layer draft of "
              f"a softened target): {tokens / spec_s:.1f} tokens/s against "
              f"plain {tokens / plain_s:.1f}; {sum(rounds)} rounds; K1 {k1} "
              f"= ({n_layers} + 1) x {prefills}, K4 {k4} = {sum(rounds)} x "
              f"{SPEC_K + 1}; tokens equal the plain stage's "
              f"{agree}/{total} [{card}]")
        del stage, plain_stage, engine
        torch.cuda.empty_cache()
    return out


def spec_bench(dev, card) -> dict:
    """Phase 18 (b): bench.py's speculative arm at its own width, bf16:
    `DecodeEngine` with and without a 1-layer draft of the softened
    target, the best of SPEC_BENCH["reps"] generates each, in this call;
    the acceptance rate and the agreement of the greedy tokens."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models import DecodeEngine
    from mmlspark_tpu_torch.zoo import (soften_late_blocks,
                                        truncated_draft_bundle)
    b = SPEC_BENCH
    target = soften_late_blocks(ModelBundle.init(
        "TransformerLM", SPEC_BENCH_CONFIG, seed=0), 1, 0.0)
    draft = truncated_draft_bundle(target, 1)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, SPEC_BENCH_CONFIG["vocab_size"],
                           (b["batch"], b["prompt"])).astype(np.int32)
    tl = np.full(b["batch"], b["prompt"], np.int32)
    base = DecodeEngine(target.module(dev), b["new"], chunk=b["chunk"],
                        device=dev)
    spec = DecodeEngine(base.weights, b["new"], chunk=b["chunk"],
                        draft_module=draft.module(dev), spec_tokens=b["k"],
                        device=dev)
    ref, got = base.generate(prompts, tl), spec.generate(prompts, tl)
    # the verify's plain attention (`segment_cache_attention`) timed
    # alone at its shape, times layers x rounds
    verify_ms = verify_attention_ms(dev, spec, b["batch"], b["prompt"])
    best = {"plain": float("inf"), "spec": float("inf")}
    for _ in range(b["reps"]):
        for name, eng in (("plain", base), ("spec", spec)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.generate(prompts, tl)
            best[name] = min(best[name], time.perf_counter() - t0)
    tokens = b["batch"] * b["new"]
    out = {"tokens_per_s": tokens / best["spec"],
           "plain_tokens_per_s": tokens / best["plain"],
           "speedup": best["plain"] / best["spec"],
           "acceptance": spec.last_spec_acceptance,
           "rounds": spec.last_spec_rounds,
           "agree": f"{int((ref == got).sum())}/{ref.size}",
           "verify_attention_ms": verify_ms * SPEC_BENCH_CONFIG["n_layers"]
           * spec.last_spec_rounds}
    print(f"speculative bench arm (bf16, {b['batch']} x {b['prompt']} "
          f"prompt, {b['new']} new, k {b['k']}, 8 layers): "
          f"{out['tokens_per_s']:.1f} tokens/s against plain "
          f"{out['plain_tokens_per_s']:.1f} ({out['speedup']:.2f}x); "
          f"acceptance {out['acceptance']:.4f} over {out['rounds']} rounds; "
          f"tokens equal the plain engine's {out['agree']}; the verify's "
          f"segment_cache_attention {verify_ms:.4f} ms a call x "
          f"{SPEC_BENCH_CONFIG['n_layers']} layers x {out['rounds']} "
          f"rounds = {out['verify_attention_ms']:.3f} ms [{card}]")
    return out


def verify_attention_ms(dev, engine, batch: int, prompt: int) -> float:
    """Device ms (CUDA graph) of one verify layer's attention read,
    `segment_cache_attention`, at a round's shape: q (B, k+1, H, D), the
    first round's window, bf16 caches."""
    from mmlspark_tpu_torch.ops.attention import segment_cache_attention
    w = engine.weights
    s = engine.spec_tokens + 1
    window = engine.serve_window(prompt, 0, s)
    h, d = w.n_heads, w.d_model // w.n_heads
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((batch, s, h, d), generator=gen, device=dev).to(w.dtype)
    k, v = (torch.randn((batch, window, h, d), generator=gen, device=dev)
            .to(w.dtype) for _ in range(2))
    slots = torch.arange(window, device=dev)
    visible = (slots[None, None, :] <= prompt + torch.arange(
        s, device=dev)[None, :, None]).expand(batch, s, window)
    return graph_ms(lambda: segment_cache_attention(q, k, v, visible))


def int8_weights_path(dev, card) -> dict:
    """Phase 18 (c): `quantize_bundle(..., "int8")` of the phase-6 model
    through `TextGenerator`, beside `quantize_bundle(..., "bf16")`:
    tokens/s, decode ms/step at the 1984 bucket (phase 6's timing), the
    Dense weights' resident bytes, greedy agreement, and K1 = n_layers x
    2 prefills, K4 = n_layers x 63 steps x 5 buckets, exact."""
    from mmlspark_tpu_torch import ModelBundle, TextGenerator
    from mmlspark_tpu_torch.quant import quantize_bundle
    n_layers = LM_CONFIG["n_layers"]
    rows, table = lm_table(PROMPT_LENGTHS)
    base = ModelBundle.init("TransformerLM", {**LM_CONFIG,
                                              "dtype": "float32"}, seed=0)
    out: dict = {}
    tokens: dict = {}
    for mode in ("bf16", "int8"):
        stage = TextGenerator(quantize_bundle(base, mode), device=dev,
                              inputCol="prompt", maxNewTokens=MAX_NEW)
        got, seconds, launched = timed_transform(stage, table)
        tokens[mode] = got
        engine = stage._engine_for()
        buckets = {engine.bucket_for(len(r)) for r in rows}
        steps = MAX_NEW - 1
        k1 = launched["flash_attention"]
        k4 = launched["fused_single_query_attention"]
        require(k1 == n_layers * sum(1 for b in buckets if b >= 512),
                f"{mode} weights: K1 launched {k1}")
        require(k4 == n_layers * steps * len(buckets),
                f"{mode} weights: K4 launched {k4}, expected {n_layers} x "
                f"{steps} x {len(buckets)}")
        layers = engine.weights.dense_layers()
        nbytes = sum(t.numel() * t.element_size() for layer in layers
                     for t in (layer.weight, getattr(layer, "scale", None))
                     if t is not None)
        require(all(layer.weight.dtype == (torch.int8 if mode == "int8"
                                           else torch.bfloat16)
                    for layer in layers), f"{mode} weights: a Dense layer "
                "is not resident in its dtype")
        long_rows = rows[6:]
        bucket = engine.bucket_for(max(map(len, long_rows)))
        prompts = torch.zeros((len(long_rows), bucket), dtype=torch.long,
                              device=dev)
        for j, r in enumerate(long_rows):
            prompts[j, :len(r)] = torch.from_numpy(r.astype(np.int64))
        tl = torch.tensor([len(r) for r in long_rows], device=dev)
        live = torch.ones(len(long_rows), dtype=torch.bool, device=dev)
        with torch.inference_mode():
            tok, done, caches = engine.prefill(prompts, tl, live,
                                               [0] * len(long_rows))
            window = -(-(bucket + 32) // engine.chunk) * engine.chunk
            seg_ms = cuda_ms(lambda: engine.decode_segment(
                32, window, caches, tok, done, tl, bucket, 0,
                [0] * len(long_rows)), warmup=1, reps=5)
        # the per-call weight cast an int8 step pays: every Dense weight
        # to bf16 once, device time in a CUDA graph (bf16 weights: none)
        cast_ms = (graph_ms(lambda: [layer.weight.to(torch.bfloat16)
                                     for layer in layers])
                   if mode == "int8" else 0.0)
        out[mode] = {"tokens_per_s": len(rows) * MAX_NEW / seconds,
                     "ms_per_step": seg_ms / 32,
                     "dense_weight_bytes": nbytes,
                     "launches": {"K1": k1, "K4": k4},
                     "weight_cast_ms_per_step": cast_ms}
        print(f"{mode} weights main path: "
              f"{out[mode]['tokens_per_s']:.1f} tokens/s; decode "
              f"{seg_ms / 32:.3f} ms/step (bucket {bucket}, window "
              f"{window}); Dense weights resident {nbytes} bytes; casting "
              f"them to bf16 {cast_ms:.4f} ms; K1 {k1}, K4 {k4} [{card}]")
        del stage, engine, caches
        torch.cuda.empty_cache()
    agree = sum(int((a[len(r):] == b[len(r):]).sum()) for a, b, r in zip(
        tokens["int8"], tokens["bf16"], rows))
    total = MAX_NEW * len(rows)
    out["agree_bf16"] = f"{agree}/{total}"
    print(f"int8 against bf16 weights: generated tokens {agree}/{total} "
          f"equal [{card}]")
    return out


def spec_serving(dev, card) -> dict:
    """Phase 18 (d): `ServingEngine(spec_tokens=3, draft_bundle=...)` over
    HTTP at f32 (every response 200, tokens equal the offline speculative
    engine's), then, with the miss breaker forced open, one request on
    its int8 degraded lane (the int8 tree at f32 compute, also
    speculative with the same draft), its tokens equal the offline int8
    speculative engine's."""
    import threading
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models.generate import (ServingWeights,
                                                    bucket_length)
    from mmlspark_tpu_torch.quant import quantize_bundle
    from mmlspark_tpu_torch.serve import ServeConfig, ServingEngine
    from mmlspark_tpu_torch.serve.lifecycle import (start_engine, start_http,
                                                    stop_http)
    from mmlspark_tpu_torch.zoo import (soften_late_blocks,
                                        truncated_draft_bundle)
    rows, _ = lm_table(SPEC_SERVE_LENGTHS, seed=3)
    degraded_prompt = rows[0][:15]
    f32 = {**LM_CONFIG, "dtype": "float32"}
    target = soften_late_blocks(ModelBundle.init("TransformerLM", f32,
                                                 seed=0), 1, 0.0)
    draft = truncated_draft_bundle(target, 1)
    q = quantize_bundle(target, "int8")
    int8 = ModelBundle("TransformerLM", {**q.config, "dtype": "float32"},
                       q.variables)
    buckets = tuple(sorted({bucket_length(len(r), f32["max_len"], MAX_NEW)
                            for r in rows}))
    cfg = ServeConfig(max_new_tokens=MAX_NEW, max_batch=8, segment_steps=16,
                      spec_tokens=SPEC_SERVE_K, default_deadline_s=600.0,
                      warmup_buckets=buckets, miss_window=8,
                      miss_min_samples=4, shed_miss_rate=0.5,
                      breaker_reset_s=600.0)
    engine = ServingEngine(target, cfg, draft_bundle=draft,
                           degraded_bundle=int8, device=dev)
    t0 = time.perf_counter()
    start_engine(engine, install_sigterm=False)
    warm_s = time.perf_counter() - t0
    server = start_http(engine, port=0)
    port = server.server_address[1]
    results: dict = {}

    def post(i, prompt):
        results[i] = http_json(port, "POST", "/generate",
                               {"prompt": prompt.tolist(),
                                "deadline_ms": 600000})
    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i, r))
                   for i, r in enumerate(rows)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        seconds = time.perf_counter() - t0
        for _ in range(cfg.miss_window):
            engine.breaker.record(missed=True)
        require(engine.breaker.state == "open",
                f"spec serving: the breaker is {engine.breaker.state}")
        post("degraded", degraded_prompt)
    finally:
        stop_http(server)
        engine.stop()
    require(engine.state == "stopped",
            f"spec serving: drain ended {engine.state}")
    statuses = sorted({r[0] for r in results.values()})
    require(statuses == [200], f"spec serving: statuses {statuses}")
    got = [results[i][1]["tokens"] for i in range(len(rows))]
    kw = dict(spec_tokens=SPEC_SERVE_K,
              draft_module=ServingWeights(draft.module(dev)))
    ref = offline_tokens(ServingWeights(target.module(dev)), rows, MAX_NEW,
                         cfg.cache_chunk, dev, **kw)
    require(got == ref, "spec serving f32: tokens differ from the offline "
            "speculative engine's")
    deg = results["degraded"][1]
    require(deg["degraded"], "spec serving: the request after the breaker "
            "opened did not run on the degraded lane")
    want = offline_tokens(ServingWeights(int8.module(dev)),
                          [degraded_prompt], MAX_NEW, cfg.cache_chunk, dev,
                          **kw)[0]
    require(deg["tokens"] == want, "degraded lane: tokens differ from the "
            "offline int8 engine's")
    tokens = MAX_NEW * len(rows)
    out = {"tokens_per_s": tokens / seconds, "seconds": seconds,
           "warmup_s": warm_s, "degraded_tokens": len(deg["tokens"])}
    print(f"speculative serving f32 (HTTP, {len(rows)} requests x {MAX_NEW} "
          f"tokens, k {SPEC_SERVE_K}): {out['tokens_per_s']:.1f} tokens/s; "
          f"warmup {warm_s:.2f} s; tokens equal the offline speculative "
          f"engine's; the int8 degraded lane's request equal the offline "
          f"int8 engine's [{card}]")
    return out


def beam_path(dev, card) -> dict:
    """Phase 18 (e): `make_beam_search_fn` at width 4 over a 600-token
    prompt at f32 (LM_CONFIG's width): K1 launched once a layer (the one
    prefill), the best beam's score within 1e-3 of its log-probabilities
    recomputed by the full forward, the search's host ms."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models import make_beam_search_fn
    from mmlspark_tpu_torch.models.generate import ServingWeights
    module = ModelBundle.init("TransformerLM", {**LM_CONFIG,
                                                "dtype": "float32"},
                              seed=0).module(dev)
    prompt = np.random.default_rng(5).integers(
        0, LM_CONFIG["vocab_size"], (1, BEAM["prompt"])).astype(np.int32)
    fn = make_beam_search_fn(ServingWeights(module), BEAM["prompt"],
                             BEAM["new"], BEAM["width"])
    fn(prompt)
    torch.cuda.synchronize()
    reset_counts()
    tokens, scores = fn(prompt)
    launched = read_counts()
    k1 = launched["flash_attention"]
    require(k1 == LM_CONFIG["n_layers"], f"beam: K1 launched {k1}")
    ms = host_ms(lambda: fn(prompt), reps=5)
    with torch.inference_mode():
        best = torch.as_tensor(tokens[0, 0], dtype=torch.long, device=dev)
        logp = torch.log_softmax(module(best[None])[0], -1)
        gen = best[BEAM["prompt"]:]
        recomputed = logp[BEAM["prompt"] - 1:-1].gather(
            1, gen[:, None]).sum().item()
    err = abs(recomputed - float(scores[0, 0]))
    require(err <= 1e-3, f"beam: best score {scores[0, 0]} against the "
            f"recomputed {recomputed}")
    require((np.diff(scores[0]) <= 0).all(), "beam: scores not best-first")
    out = {"ms": statistics.median(ms), "ms_range": [ms[0], ms[-1]],
           "launches": {"K1": k1}, "score_abs_err": err}
    print(f"beam search f32 (width {BEAM['width']}, prompt "
          f"{BEAM['prompt']}, {BEAM['new']} new): {out['ms']:.2f} ms "
          f"(host, median of 5, {ms[0]:.2f}-{ms[-1]:.2f}); K1 {k1}; best "
          f"score {scores[0, 0]:.4f}, recomputed {recomputed:.4f} [{card}]")
    return out


def phase_lm_decoding(dev, card) -> dict:
    """chip_smoke phase 18: the rest of LM decoding on the card, every
    path through the port's entry points (`spec_main_path`, `spec_bench`,
    `int8_weights_path`, `spec_serving`, `beam_path`)."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"speculative": spec_main_path(dev, card)}
    torch.cuda.empty_cache()
    out["spec_bench"] = spec_bench(dev, card)
    torch.cuda.empty_cache()
    out["int8_weights"] = int8_weights_path(dev, card)
    torch.cuda.empty_cache()
    out["spec_serving"] = spec_serving(dev, card)
    torch.cuda.empty_cache()
    out["beam"] = beam_path(dev, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 18 (LM decoding features): {out['seconds']:.1f} s [{card}]")
    return out


# chip_smoke phase 19: the phase-7 fit with checkpoints every 2 steps
# (async), a chaos preemption and its resume, a resume past a torn newest
# checkpoint, and the recovery supervisor against a NaN and a hung step
# reps 5 until phase 28 needed the time
CKPT = dict(every=2, preempt_at=2, nan_at=2, hang_at=3, hang_s=3.0,
            step_timeout_s=2.0, reps=2)


def ckpt_config(**kw):
    """The phase-7 training config with async checkpoints every
    CKPT["every"] steps and no numerics probe (unless `kw` says)."""
    from mmlspark_tpu_torch import TrainerConfig
    base = dict(architecture="TransformerLM",
                model_config={**LM_CONFIG, "attn_impl": "flash"},
                optimizer="adam", learning_rate=3e-4, batch_size=TRAIN_BATCH,
                epochs=2, loss="softmax_xent", seed=0, numerics_cadence=0,
                checkpoint_every_steps=CKPT["every"],
                async_checkpointing=True)
    base.update(kw)
    return TrainerConfig(**base)


def tree_leaves(tree) -> list:
    """A nested dict's arrays in sorted-path order."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key])
        else:
            out.append(np.asarray(node))
    walk(tree)
    return out


def bundle_leaves(bundle) -> list:
    """A bundle's parameter arrays in sorted-path order."""
    return tree_leaves(bundle.variables)


def max_leaf_diff(a, b) -> float:
    return max(float(np.abs(x.astype(np.float64) - y).max())
               for x, y in zip(bundle_leaves(a), bundle_leaves(b)))


def phase_checkpointed_training(dev, card) -> dict:
    """Phase 19: `Trainer.fit_arrays` at the phase-7 width with async
    checkpoints, in a temporary directory removed at the end.  (a) two
    fault-free fits, the first checkpointing (is the step bitwise
    repeatable on the card?); (b) a
    chaos SIGTERM at step CKPT["preempt_at"] -> Preempted, then
    resume=True; (c) a resume after tearing the newest checkpoint of (a)
    (falls back by checksum); gates on (b) and (c): the step count, the
    final weights bit-equal to (a)'s when (a)'s two fits are (else within
    their spread), K1[lse], K2 and K3 each n_layers x the steps
    executed over every attempt.  (d) `RecoverySupervisor` with
    halt_on_nonfinite against a chaos NaN, then with the watchdog against
    a chaos hang: each rolls back, completes, and records the JAX
    package's timeline.  Then the checkpoint's bytes, a sync write's
    seconds, the step with an async checkpoint every step against none
    (CUDA events, median of CKPT["reps"]) and a restore's seconds."""
    import os
    import shutil
    import tempfile
    from mmlspark_tpu_torch import ModelBundle, Trainer
    from mmlspark_tpu_torch.resilience.chaos import (ChaosInjector, Fault,
                                                     set_injector)
    from mmlspark_tpu_torch.resilience.checkpoints import (
        latest_valid_checkpoint, list_checkpoints, step_of)
    from mmlspark_tpu_torch.resilience.preemption import Preempted
    from mmlspark_tpu_torch.train import RecoveryPolicy, RecoverySupervisor
    t_phase = time.perf_counter()
    n_layers = LM_CONFIG["n_layers"]
    rows = char_corpus(TRAIN_ROWS, TRAIN_SEQ, LM_CONFIG["vocab_size"])
    x, y = rows[:, :-1], rows[:, 1:]
    init = ModelBundle.init("TransformerLM", LM_CONFIG, seed=0)
    steps = TRAIN_ROWS // TRAIN_BATCH * 2
    kernels = ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out: dict = {}

    def run(fn, faults=()):
        """fn() under a chaos script, counters from 0: (result or the
        exception it raised, launches, seconds)."""
        previous = set_injector(ChaosInjector(script=list(faults)))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        try:
            result = fn()
        except Preempted as e:
            result = e
        finally:
            torch.cuda.synchronize()
            set_injector(previous)
        return result, read_counts(), time.perf_counter() - t0

    def fit(ckpt, cfg=None, **kw):
        return lambda: Trainer(cfg or ckpt_config(), device=dev).fit_arrays(
            x, y, initial_bundle=init, ckpt_dir=ckpt, **kw)

    def require_launches(label, launched, executed):
        got = {k: launched[k] for k in kernels}
        print(f"  {label}: launches {got} = {n_layers} layers x "
              f"{executed} executed steps")
        require(all(v == n_layers * executed for v in got.values()),
                f"{label}: launches {got}, want {n_layers * executed} each")

    try:
        # (a) two fault-free fits, the second without checkpoints (it
        # only asks whether the step is bitwise repeatable)
        fits = []
        for i in (1, 2):
            bundle, launched, secs = run(fit(
                os.path.join(root, "a1") if i == 1 else None))
            require(bundle.metadata["steps"] == steps, "(a) metadata steps")
            require(all(np.isfinite(a).all() for a in bundle_leaves(bundle)),
                    "(a) non-finite weights")
            kept = [st for st, _ in list_checkpoints(os.path.join(root,
                                                                  "a1"))]
            print(f"fault-free fit (a) {i}: {steps} steps of "
                  f"{TRAIN_BATCH}x{TRAIN_SEQ} in {secs:.3f} s"
                  + (f"; checkpoints {kept}" if i == 1 else "")
                  + f" [{card}]")
            require_launches(f"(a) {i}", launched, steps)
            fits.append(bundle)
        spread = max_leaf_diff(fits[0], fits[1])
        repeatable = spread == 0.0
        print(f"  (a) two fault-free fits bitwise equal: {repeatable} "
              f"(max |d| {spread:.3e})")
        out["repeatable"], out["spread"] = repeatable, spread

        def same_as_a(label, bundle):
            diff = max_leaf_diff(bundle, fits[0])
            print(f"  {label}: max |d| against (a) {diff:.3e} (gate: "
                  f"{'0' if repeatable else f'<= {spread:.3e}'})")
            require(bundle.metadata["steps"] == steps,
                    f"{label}: {bundle.metadata['steps']} steps, want "
                    f"{steps}")
            require(diff == 0.0 if repeatable else diff <= spread,
                    f"{label}: final weights differ from the fault-free "
                    f"fit's by {diff:.3e}")
            return diff

        # (b) preempted at a step, then resumed
        d_b = os.path.join(root, "b")
        err, launched_1, secs_1 = run(
            fit(d_b), [Fault("sigterm", step=CKPT["preempt_at"])])
        require(isinstance(err, Preempted)
                and err.step == CKPT["preempt_at"] + 1,
                f"(b) a SIGTERM at step {CKPT['preempt_at']} gave {err!r}")
        bundle, launched_2, secs_2 = run(fit(d_b, resume=True))
        print(f"(b) preempted at step {err.step} after {secs_1:.3f} s, "
              f"resumed in {secs_2:.3f} s [{card}]")
        require_launches("(b) both attempts", {
            k: launched_1[k] + launched_2[k] for k in kernels}, steps)
        out["b_max_diff"] = same_as_a("(b) resumed", bundle)

        # (c) the newest checkpoint of (a) torn: the resume falls back
        d_c = os.path.join(root, "a1")
        newest = list_checkpoints(d_c)[0][1]
        ChaosInjector.tear_file(newest)
        fallback = step_of(os.path.basename(latest_valid_checkpoint(d_c)))
        require(fallback == steps - CKPT["every"],
                f"(c) fell back to step {fallback}")
        bundle, launched, secs = run(fit(d_c, resume=True))
        print(f"(c) {os.path.basename(newest)} torn: restored step "
              f"{fallback}, resumed in {secs:.3f} s [{card}]")
        require_launches("(c) resumed", launched, steps - fallback)
        out["c_max_diff"] = same_as_a("(c) resumed", bundle)

        # (d) the supervisor against a NaN, then against a hung step
        sups = {}
        for label, cfg, fault, kind, restore, executed in (
                ("nan", ckpt_config(numerics_cadence=1,
                                    halt_on_nonfinite=True),
                 Fault("nan", step=CKPT["nan_at"]), "nonfinite",
                 CKPT["nan_at"], steps),
                ("hang", ckpt_config(step_timeout_s=CKPT["step_timeout_s"]),
                 Fault("hang", step=CKPT["hang_at"],
                       seconds=CKPT["hang_s"]), "hung_step",
                 CKPT["hang_at"], CKPT["hang_at"])):
            sup = RecoverySupervisor(cfg, RecoveryPolicy(max_recoveries=2),
                                     device=dev)
            bundle, launched, secs = run(
                lambda sup=sup, d=os.path.join(root, label): sup.fit_arrays(
                    x, y, ckpt_dir=d, initial_bundle=init), [fault])
            events = [e["event"] for e in sup.timeline]
            print(f"(d) supervisor against a chaos {label} at step "
                  f"{fault.step}: timeline {sup.timeline}; {secs:.3f} s "
                  f"[{card}]")
            require(events == ["failure", "recover", "completed"],
                    f"(d) {label}: timeline {events}")
            fail, recover = sup.timeline[0], sup.timeline[1]
            require(fail["kind"] == kind and fail["step"] == fault.step
                    and recover["restore_step"] == restore
                    and recover["skip_window"] == [restore, fault.step],
                    f"(d) {label}: failure {fail}, recover {recover}")
            require(bundle.metadata["steps"] == steps and all(
                np.isfinite(a).all() for a in bundle_leaves(bundle)),
                f"(d) {label}: the recovered fit")
            require_launches(f"(d) {label}, both attempts", launched,
                             executed)
            sups[label] = sup.timeline
        out["timelines"] = sups

        # (e) the checkpoint's cost at this width
        timer = Trainer(ckpt_config(), device=dev)
        state = timer.init_state((1, TRAIN_SEQ), 16, init)
        timer._effective_batch_size = TRAIN_BATCH
        step = timer.make_train_step()
        xb = torch.from_numpy(x[:TRAIN_BATCH].astype(np.int64)).to(dev)
        yb = torch.from_numpy(y[:TRAIN_BATCH].astype(np.int64)).to(dev)
        mb = torch.ones(TRAIN_BATCH, device=dev)
        d_e = os.path.join(root, "e")
        none_ms = cuda_ms(lambda: step(state, xb, yb, mb), warmup=1,
                          reps=CKPT["reps"])

        def step_and_save():
            step(state, xb, yb, mb)
            timer.save_checkpoint(state, d_e, sync=False)
        async_ms = cuda_ms(step_and_save, warmup=1, reps=CKPT["reps"])
        timer._close_writers()
        t0 = time.perf_counter()
        path = timer.save_checkpoint(state, d_e, sync=True)
        sync_s = time.perf_counter() - t0
        timer._close_writers()
        nbytes = os.path.getsize(path)
        again = Trainer(ckpt_config(), device=dev)
        fresh = again.init_state((1, TRAIN_SEQ), 16, init)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = again.restore_checkpoint(fresh, d_e)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        require(restored.step == state.step
                and all(torch.equal(a, b) for a, b in zip(restored.params,
                                                          state.params)),
                "(e) the restored state differs from the saved one")
        print(f"checkpoint cost at the phase-7 width ({nbytes} bytes: f32 "
              f"params and adam's two moments): sync write {sync_s:.3f} s; "
              f"train step with an async checkpoint every step "
              f"{async_ms:.3f} ms against {none_ms:.3f} ms with none "
              f"(CUDA events, median of {CKPT['reps']}); restore "
              f"{resume_s:.3f} s [{card}]")
        out.update(checkpoint_bytes=nbytes, sync_write_s=sync_s,
                   step_ms_async_every_step=async_ms,
                   step_ms_no_checkpoint=none_ms, restore_s=resume_s)
        del timer, again, state, restored, fresh
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19: {out['seconds']:.1f} s [{card}]")
    return out


# chip_smoke phase 20: LC_CONFIG trained seq-parallel (data 1 x seq 2 on
# this card) with the differentiable ring flash; the f32 check at 2 x 2048
# against the one-card flash step; ulysses and ring at a small width
# against the dense step; K1[lse], K2, K3 timed at the ring's block shape
RING = dict(batch=2, seq=8192, steps=4, reps=5, grad_seq=2048,
            small={"vocab_size": 256, "d_model": 128, "n_heads": 8,
                   "n_layers": 2, "max_len": 1024}, small_seq=1024,
            block=(2, 4096, 8, 64))


def seq_step(module, mesh):
    """`make_seq_parallel_lm_step` with adam at 3e-4 over `module`:
    (params, opt_state, step)."""
    from mmlspark_tpu_torch import TrainerConfig
    from mmlspark_tpu_torch.parallel.ring import make_seq_parallel_lm_step
    from mmlspark_tpu_torch.train.optim import Optimizer
    tx = Optimizer(TrainerConfig(optimizer="adam", learning_rate=3e-4), 1)
    params = list(module.parameters())
    return params, tx.init(params), make_seq_parallel_lm_step(module, tx,
                                                              mesh)


def seq_grads(dev, mesh, config: dict, variables, impls, seq: int) -> dict:
    """f32 loss and gradients of one (2, seq) batch of the example corpus
    through each impl (the seq impls inside `use_seq_mesh`), TF32 off:
    {impl: (loss, {name: grad})}."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.parallel.ring import use_seq_mesh
    from mmlspark_tpu_torch.train.trainer import make_loss
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = char_corpus(2, seq, config["vocab_size"])
    x = torch.from_numpy(rows[:, :-1].astype(np.int64)).to(dev)
    y = torch.from_numpy(rows[:, 1:].astype(np.int64)).to(dev)
    out = {}
    for impl in impls:
        sharded = impl in ("ring", "ring_flash", "ulysses")
        module = ModelBundle("TransformerLM", {
            **config, "dtype": "float32", "attn_impl": impl,
            "seq_axis": "seq" if sharded else None}, variables).module(
                dev).train()
        with use_seq_mesh(mesh):
            loss = make_loss("softmax_xent")(module(x), y,
                                             torch.ones(2, device=dev))
        loss.backward()
        out[impl] = (loss.item(),
                     {n: p.grad for n, p in module.named_parameters()})
        del module, loss
    return out


def compare_grads(label: str, got: tuple, ref: tuple, tol: float) -> dict:
    """Loss within 1e-5 relative (f32 rounding) and every gradient's
    max|d| within `tol` of its reference's max|ref|."""
    worst_name, worst = None, 0.0
    for name, g in got[1].items():
        r = ref[1][name]
        rel = ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
        if rel > worst:
            worst_name, worst = name, rel
    loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
    print(f"  {label}: loss {got[0]:.7f} vs {ref[0]:.7f} (rel {loss_rel:.3e},"
          f" tol 1e-5); worst parameter {worst_name} max|d|/max|ref| "
          f"{worst:.3e} (tol {tol})")
    require(loss_rel <= 1e-5, f"{label}: the loss differs")
    require(worst <= tol, f"{label}: the gradient of {worst_name} differs")
    return {"loss_rel": loss_rel, "worst_param": worst_name,
            "worst_rel_err": worst}


def phase_seq_parallel_training(dev, card) -> tuple:
    """Phase 20: `make_seq_parallel_lm_step` with `attn_impl="ring_flash"`
    at LC_CONFIG's width, bf16, 2 x 8192 tokens over a data 1 x seq 2 mesh
    on this card, RING["steps"] steps of adam: the loss falls, and
    K1[lse], K2 and K3 each launch n_layers x 3 (the causal fold rule
    over 2 shards: 2 diagonal block pairs + 1 below it) a step.  Its
    ms/step beside the one-card flash step's on the same batch.  At f32
    and 2 x 2048 one step's gradients against the one-card flash step's;
    ulysses and ring at a small width against the dense step's (the
    profiles of both steps were dropped when phase 28 needed the time).
    Then the ring's block pairs' kernel rows.  Returns (kernel
    rows, the path's numbers)."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from mmlspark_tpu_torch.parallel.ring import shard_tokens
    t_phase = time.perf_counter()
    n_layers, n = LC_CONFIG["n_layers"], 2
    mesh = make_mesh(MeshSpec(data=1, seq=n), [dev] * n)
    rows = char_corpus(RING["batch"], RING["seq"], LC_CONFIG["vocab_size"])
    batch = [shard_tokens(a, mesh) for a in (
        rows[:, :-1].astype(np.int64), rows[:, 1:].astype(np.int64),
        np.ones((RING["batch"], RING["seq"]), np.float32))]
    init = ModelBundle.init("TransformerLM", LC_CONFIG, seed=5)

    def module(impl):
        return ModelBundle("TransformerLM", {
            **LC_CONFIG, "attn_impl": impl,
            "seq_axis": "seq" if impl == "ring_flash" else None},
            init.variables).module(dev).train()

    params, opt, step = seq_step(module("ring_flash"), mesh)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    losses = []
    for _ in range(RING["steps"]):
        params, opt, loss = step(params, opt, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = read_counts()
    blocks = read_block_counts()
    losses = [float(v) for v in losses]
    # per step and layer, n diagonal block pairs and n(n-1)/2 below it
    want_blocks = {"diagonal": n_layers * n * RING["steps"],
                   "off-diagonal": n_layers * n * (n - 1) // 2 * RING["steps"]}
    want = sum(want_blocks.values())
    print(f"seq-parallel training (ring_flash, data 1 x seq {n} on one "
          f"card): {RING['steps']} steps of {RING['batch']}x{RING['seq']} "
          f"tokens at LC_CONFIG's width, bf16, in {seconds:.3f} s; losses "
          f"{[round(v, 4) for v in losses]}; launches {launched} (want "
          f"{want} = {n_layers} layers x {n * (n + 1) // 2} block pairs x "
          f"{RING['steps']} steps of K1[lse], K2, K3); by block kind "
          f"{blocks} (want {want_blocks} each) [{card}]")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            "seq-parallel training: the loss did not fall")
    for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
        require(launched[name] == want, f"seq-parallel training: {name} "
                f"launched {launched[name]} times, want {want}")
        require(blocks[name] == want_blocks, f"seq-parallel training: "
                f"{name} launched {blocks[name]} by block kind, want "
                f"{want_blocks}")
    require(launched["flash_attention"] == 0,
            "seq-parallel training launched K1 without lse")
    ring_ms = cuda_ms(lambda: step(params, opt, *batch), warmup=1,
                      reps=RING["reps"])
    del params, opt, step
    torch.cuda.empty_cache()
    # the one-card flash step: the same step over a mesh of one shard
    one = make_mesh(MeshSpec(data=1, seq=1), [dev])
    whole = [shard_tokens(a, one) for a in (
        rows[:, :-1].astype(np.int64), rows[:, 1:].astype(np.int64),
        np.ones((RING["batch"], RING["seq"]), np.float32))]
    fparams, fopt, fstep = seq_step(module("flash"), one)
    flash_ms = cuda_ms(lambda: fstep(fparams, fopt, *whole), warmup=1,
                       reps=RING["reps"])
    del fparams, fopt, fstep, batch, whole
    torch.cuda.empty_cache()
    n_tokens = RING["batch"] * RING["seq"]
    print(f"timing seq-parallel step {RING['batch']}x{RING['seq']} bf16: "
          f"ring_flash over seq {n} {ring_ms:.3f} ms/step "
          f"({n_tokens / ring_ms * 1e3:.1f} tokens/s) against the one-card "
          f"flash step {flash_ms:.3f} ms/step (CUDA events, median of "
          f"{RING['reps']}) [{card}]")

    grads = seq_grads(dev, mesh, LC_CONFIG, init.variables,
                      ("ring_flash", "flash"), RING["grad_seq"])
    print(f"f32 gradients at (2, {RING['grad_seq']}), LC_CONFIG's width:")
    f32 = compare_grads("ring_flash over seq 2 vs the one-card flash step",
                        grads["ring_flash"], grads["flash"], 1e-4)
    del grads
    small = {**RING["small"], "dtype": "float32"}
    small_init = ModelBundle.init("TransformerLM", small, seed=6)
    grads = seq_grads(dev, mesh, small, small_init.variables,
                      ("ulysses", "ring", "dense"), RING["small_seq"])
    print(f"f32 gradients at (2, {RING['small_seq']}), d_model "
          f"{small['d_model']}, {small['n_layers']} layers:")
    small_out = {impl: compare_grads(f"{impl} over seq 2 vs dense",
                                     grads[impl], grads["dense"], 1e-4)
                 for impl in ("ulysses", "ring")}
    del grads
    torch.cuda.empty_cache()
    rows = ring_block_rows(dev, card, blocks)
    out = {"losses": losses, "seconds": seconds, "launches": launched,
           "block_launches": blocks,
           "ring_flash_ms_per_step": ring_ms, "flash_ms_per_step": flash_ms,
           "f32_grads": f32, "small_width_grads": small_out}
    out["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 20: {out['phase_seconds']:.1f} s [{card}]")
    return rows, out


def ring_block_rows(dev, card, blocks: dict) -> list:
    """K1[lse], K2 and K3 at the ring's block shape RING["block"], bf16:
    shard 1's queries (q offset S_l) against the diagonal block (k offset
    S_l, causal) and the block below it (k offset 0, every key visible).
    K1[lse] and, at the lse and delta of the whole 2 x S_l sequence as the
    ring-flash backward gives them, K2 and K3 are checked against their
    plain versions.  K1[lse] is timed here beside its bound and PyTorch's
    flash forward with lse; K2 and K3 by `time_backward` at the block's
    offsets.  `blocks`: each kernel's launches on the path by block kind,
    as its wrapper counted them."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse, flash_attention_with_lse_plain,
        flash_block_grads_plain, flash_bwd_dkv, flash_bwd_dq)
    b, s, h, d = RING["block"]
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(20)
    q_all, k_all, v_all, do_all = (
        torch.randn((b, 2 * s, h, d), generator=gen, device=dev)
        .to(torch.bfloat16) for _ in range(4))
    q, do = q_all[:, s:].contiguous(), do_all[:, s:].contiguous()
    out, lse = flash_attention_with_lse_plain(q, k_all, v_all, True, scale,
                                              s, 0)
    delta = (do.float() * out.float()).sum(-1)
    del out, q_all, do_all
    item = 2
    rows = []
    for pair, k_off in (("diagonal", s), ("off-diagonal", 0)):
        k = k_all[:, k_off:k_off + s].contiguous()
        v = v_all[:, k_off:k_off + s].contiguous()
        causal_lib = pair == "diagonal"
        vis = visible_pairs(s, s, True, s, k_off)
        # K1[lse] against plain
        got, got_lse = flash_attention_with_lse(q, k, v, True, scale, s,
                                                k_off)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_with_lse_plain(q, k, v, True, scale,
                                                      s, k_off)
        err, norm_err = out_errs(got, ref)
        lse_err = (got_lse - ref_lse).abs().max().item()
        print(f"K1[lse] ring {pair} block (offsets {s}/{k_off}) "
              f"{RING['block']}: max_abs_err {err:.3e} (tol 2e-2), "
              f"||d||/||ref|| {norm_err:.3e} (tol 1e-2), lse {lse_err:.3e} "
              f"(tol 1e-3)")
        require(err <= 2e-2 and norm_err <= 1e-2 and lse_err <= 1e-3,
                f"K1[lse] disagrees on the ring's {pair} block")
        del got, got_lse, ref, ref_lse
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        k1_ms = graph_ms(lambda: flash_attention_with_lse(
            q, k, v, True, scale, s, k_off))
        k1_plain = graph_ms(lambda: flash_attention_with_lse_plain(
            q, k, v, True, scale, s, k_off), calls=3)
        k1_lib = library_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, causal_lib, scale=scale),
            f"aten flash forward on the ring's {pair} block")
        bound, by, term = attention_bound(
            4.0 * b * h * d * vis, 4.0 * b * s * h * d * item + b * s * h * 4,
            b * h * vis)
        print(f"timing K1[lse] ring {pair} {RING['block']}: {k1_ms:.4f} ms;"
              f" plain {k1_plain:.4f} ms; aten flash {k1_lib:.4f} ms; bound "
              f"{bound:.4f} ms ({term}); {k1_ms / k1_lib:.2f}x the library, "
              f"{bound / k1_ms:.3f} of the bound [{card}]")
        name = "flash_attention[lse]"
        rows.append({"name": f"{name[:-1]},d{d},ring {pair}]",
                     "route": "cuda", "launches": blocks[name][pair],
                     "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
                     "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
                     "max_abs_err": err, "ms": k1_ms, "plain_ms": k1_plain,
                     "bound_ms": bound, "bound_by": by, "bound_term": term,
                     "library_ms": k1_lib})
        # K2 and K3 against plain, at the global lse and delta
        args = (q, k, v, do, lse, delta, True, scale, s, k_off)
        got = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        ref = flash_block_grads_plain(*args)
        errs = [grad_errs(a, r) for a, r in zip(got, ref)]
        abs_errs = [(a.float() - r.float()).abs().max().item()
                    for a, r in zip(got, ref)]
        print(f"K2/K3 ring {pair} block at the whole sequence's lse and "
              f"delta: max|d|/max|ref| dq {errs[0][0]:.3e} dk "
              f"{errs[1][0]:.3e} dv {errs[2][0]:.3e} (tol 2e-2); "
              f"||d||/||ref|| dq {errs[0][1]:.3e} dk {errs[1][1]:.3e} dv "
              f"{errs[2][1]:.3e} (tol 1e-2)")
        require(all(m <= 2e-2 and nrm <= 1e-2 for m, nrm in errs),
                f"K2/K3 disagree on the ring's {pair} block")
        del got, ref, k, v, args, qt, kt, vt
        timed = time_backward(card, gen, d, shape=(b, s, h),
                              offsets=(s, k_off), lib_causal=causal_lib)
        for name, err in (("flash_bwd_dq", abs_errs[0]),
                          ("flash_bwd_dkv", max(abs_errs[1:]))):
            rows.append({
                "name": f"{name}[d{d},ring {pair}]", "route": "cuda",
                "launches": blocks[name][pair],
                "source": "mmlspark_tpu_torch/csrc/flash_backward.cu",
                "replaces": ("mmlspark_tpu/ops/flash_attention.py:318"
                             if name == "flash_bwd_dq" else
                             "mmlspark_tpu/ops/flash_attention.py:330"),
                "max_abs_err": err, **timed[name]})
        torch.cuda.empty_cache()
    return rows


# chip_smoke phase 21: vision and tabular scoring (TPUModel, no hand-written
# kernel: cuDNN and cuBLAS).  (a) the zoo ConvNet at bench.py
# bench_convnet's configuration, (b) ResNet-50 at bench_resnet50's, (c) the
# two MLP zoo bundles.  Inputs are made here with numpy from seed 0.
# reps 3 (VISION, INGEST) until phase 28 needed the time
VISION = dict(convnet_images=32768, convnet_batch=4096, resnet_images=1024,
              resnet_batch=256, check_rows=256, reps=1, steady_iters=4,
              wdbc_rows=65536, text_rows=16384, mlp_batch=4096,
              calibration_rows=32, resnet_branch_scale=0.1)
# The gates of phase 21, per model family and arm, each limit a share of
# max |logit|; PERF.md section 6 gives the readings each was set from:
# every limit sits about 2x or more above the sound arms' largest reading
# and below the planted fault's.
# - min_distinct: the f32 arm's argmax takes at least this many classes
#   over the scored rows, so a forward that ignores its input cannot pass
#   the agreement gate;
# - tol[arm] = (vs_f32, vs_cpu): the arm against the f32 arm on the card,
#   every logit within vs_f32 and the argmax the same on at least
#   AGREE_FLOOR of the rows whose f32 top-2 gap exceeds vs_f32, which must
#   be at least 1% of the rows (closer rows flip under rounding: on the
#   bench's noise images the zoo ConvNet's bf16 and int8 arms keep the f32
#   class on 0.989 / 0.960 of all rows, and the JAX package's own arms
#   fall below 99% too); and the arm on the card against the port's CPU
#   forward at the arm's own precision on the first same_rows rows,
#   within vs_cpu;
# - faults[arm]: the params node of the arm's planted fault
#   (`planted_fault`), which both limits must reject.
AGREE_FLOOR = 0.99
VISION_GATES = {
    "convnet": dict(min_distinct=5, same_rows=256,
                    tol={"bf16": (4e-2, 2e-2), "int8": (8e-2, 1.5e-2)},
                    faults={"bf16": "conv2_w", "int8": "conv1_w"}),
    "resnet50": dict(min_distinct=100, same_rows=32,
                     tol={"bf16": (8e-2, 6e-2), "int8": (1.8e-1, 9e-2)},
                     faults={"bf16": "ResNetBottleneckBlock_7/Conv_1",
                             "int8": "stem_conv"}),
    "mlp": dict(min_distinct=2, same_rows=256, tol={"bf16": (1.5e-2, 1e-2)},
                faults={"bf16": "dense0"}),
}


def resident_bytes(module) -> int:
    """Bytes of the module's parameters and buffers on the device."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))


def flops_per_row(model, row: np.ndarray) -> float:
    """2 x the multiply-adds of every conv and Dense layer of one row's
    forward, from the layers' weight and output shapes (forward hooks)."""
    from mmlspark_tpu_torch.models.definitions import (Conv, Dense, Int8Conv,
                                                       Int8Dense)
    module = model._scoring_module()
    total = [0.0]

    def hook(mod, _inp, out):
        w = mod.weight
        if w.dim() == 4:    # (out, in, kh, kw) over every output position
            total[0] += 2.0 * out.numel() * w.shape[1] * w.shape[2] \
                * w.shape[3]
        else:
            total[0] += 2.0 * out.numel() * w.shape[1]

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (Conv, Dense, Int8Conv, Int8Dense))]
    try:
        model._apply(module, torch.from_numpy(row[None]).to(model.device))
    finally:
        for h in handles:
            h.remove()
    return total[0]


def scoring_steady_state(model, rows: np.ndarray, batch: int,
                         iters: int) -> float:
    """Rows/s of the stage's own forward over batches already on the card
    (bench.py's device_steady_state): host clock around synchronized
    passes, after one warm pass."""
    module = model._scoring_module()
    batches = [torch.from_numpy(rows[i:i + batch]).to(model.device)
               for i in range(0, len(rows) - batch + 1, batch)]
    for b in batches:
        model._apply(module, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        for b in batches:
            model._apply(module, b)
    torch.cuda.synchronize()
    return iters * len(batches) * batch / (time.perf_counter() - t0)


def timed_scoring(model, table, reps: int) -> tuple:
    """(scores, sorted rows/s of `reps` end-to-end transforms); one warm
    transform of a batch first."""
    from mmlspark_tpu_torch import DataTable
    n = table.num_rows
    model.transform(DataTable({model.inputCol: table[model.inputCol][
        :model.miniBatchSize]}))
    rates, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.transform(table)[model.outputCol]
        rates.append(n / (time.perf_counter() - t0))
    return out, sorted(rates)


def check_scores(what: str, got: np.ndarray, shape: tuple) -> None:
    require(got.shape == shape and got.dtype == np.float32,
            f"{what}: scores {got.shape} {got.dtype}, expected {shape} "
            "float32")
    require(bool(np.isfinite(got).all()), f"{what}: non-finite scores")


def check_card_f32(what: str, card: np.ndarray, cpu: np.ndarray) -> dict:
    """The card's f32 forward against the port's CPU f32 forward of the
    same weights: within 1e-4 of max |logit|, the same argmax wherever the
    top-2 gap exceeds 1e-3."""
    scale = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max())
    top2 = np.sort(cpu, axis=1)
    clear = top2[:, -1] - top2[:, -2] > 1e-3
    same = bool((card.argmax(1)[clear] == cpu.argmax(1)[clear]).all())
    require(err <= 1e-4 * scale and same,
            f"{what}: card f32 vs CPU f32 max |d| {err:.3e} (limit "
            f"{1e-4 * scale:.3e}), argmax equal on the clear rows: {same}")
    return {"max_abs_err": err, "max_abs_logit": scale,
            "clear_rows": int(clear.sum())}


def arm_readings(arm: np.ndarray, f32: np.ndarray, clear_gap: float
                 ) -> dict:
    """A bf16 or int8 arm's scores against the f32 arm's; argmax
    agreement over the rows whose f32 top-2 gap exceeds `clear_gap` x max
    |logit|."""
    scale = float(np.abs(f32).max())
    same = arm.argmax(1) == f32.argmax(1)
    top2 = np.sort(f32, axis=1)
    clear = top2[:, -1] - top2[:, -2] > clear_gap * scale
    return {"argmax_agreement": float(same[clear].mean()) if clear.any()
            else 1.0,
            "clear_rows": int(clear.sum()), "rows": len(same),
            "argmax_agreement_all_rows": float(same.mean()),
            "max_logit_gap": float(np.abs(arm - f32).max()),
            "max_abs_logit": scale}


def same_readings(card: np.ndarray, cpu: np.ndarray) -> dict:
    """An arm on the card against the port's CPU forward at the same
    precision."""
    return {"max_abs_err": float(np.abs(card - cpu).max()),
            "max_abs_logit": float(np.abs(cpu).max())}


def arm_passes(vs_f32: dict, same: dict, tol: tuple) -> tuple:
    """(vs the f32 arm, vs the CPU at the same precision) within `tol`;
    the agreement counts only over at least 1% of the rows."""
    return (vs_f32["argmax_agreement"] >= AGREE_FLOOR
            and vs_f32["clear_rows"] >= vs_f32["rows"] / 100
            and vs_f32["max_logit_gap"] <= tol[0] * vs_f32["max_abs_logit"],
            same["max_abs_err"] <= tol[1] * same["max_abs_logit"])


def describe_arm(vs_f32: dict, same: dict, tol: tuple) -> str:
    return (f"argmax agreement {vs_f32['argmax_agreement']:.4f} of "
            f"{vs_f32['clear_rows']} rows of top-2 gap over {tol[0]:.1e} "
            f"(floor {AGREE_FLOOR}; "
            f"{vs_f32['argmax_agreement_all_rows']:.4f} of all), max logit "
            f"gap {vs_f32['max_logit_gap'] / vs_f32['max_abs_logit']:.3e} "
            f"of max |logit| (limit {tol[0]:.1e}); card vs CPU at its "
            f"precision {same['max_abs_err'] / same['max_abs_logit']:.3e} "
            f"of max |logit| (limit {tol[1]:.1e})")


def planted_fault(bundle, arm: str, node: str):
    """A copy of `bundle` with one known fault at the params node `node`
    ("/"-separated): for an int8 bundle the per-channel scale rolled by
    one channel; else a conv kernel with its two spatial axes swapped (a
    HWIO -> OIHW transpose that swaps kh and kw), or a Dense node's bias
    dropped."""
    from mmlspark_tpu_torch.models import ModelBundle

    def walk(tree, path):
        tree = dict(tree)
        if len(path) > 1:
            tree[path[0]] = walk(tree[path[0]], path[1:])
            return tree
        leaf = dict(tree[path[0]])
        if arm == "int8":
            leaf["kernel_scale"] = np.roll(np.asarray(leaf["kernel_scale"]),
                                           1)
        elif np.ndim(leaf["kernel"]) == 4:
            leaf["kernel"] = np.ascontiguousarray(
                np.asarray(leaf["kernel"]).transpose(1, 0, 2, 3))
        else:
            leaf["bias"] = np.zeros_like(np.asarray(leaf["bias"]))
        tree[path[0]] = leaf
        return tree

    variables = dict(bundle.variables)
    variables["params"] = walk(variables["params"], node.split("/"))
    return ModelBundle(bundle.architecture, bundle.config, variables,
                       bundle.metadata)


def cpu_scores(model, rows: np.ndarray) -> np.ndarray:
    """The port's CPU forward of `model`'s weights and params over `rows`
    in one batch."""
    from mmlspark_tpu_torch import DataTable, TPUModel
    params = {**model.param_values(), "miniBatchSize": len(rows),
              "inputCol": "x", "outputCol": "y"}
    return TPUModel(model.bundle, device="cpu", **params).transform(
        DataTable({"x": rows}))["y"]


def vision_arms(dev, card, name: str, family: str, arms: dict,
                rows: np.ndarray, batch: int, n_out: int, peak_of: dict,
                off_and_on: bool, iters: int) -> dict:
    """Each arm (name -> TPUModel) end to end (prefetch on; off too when
    `off_and_on`) and in the device steady state, its FLOPs per row and
    share of its peak, its resident weight bytes; then the gates of
    VISION_GATES[family]: the f32 arm against the CPU on the first rows and
    its count of distinct classes, each other arm against the f32 arm and
    against the CPU at its own precision, and each arm's planted fault
    rejected by both."""
    from mmlspark_tpu_torch import DataTable, TPUModel
    from mmlspark_tpu_torch.observe.spans import pipeline_timing
    gates = VISION_GATES[family]
    table = DataTable({"x": rows})
    out, scores = {}, {}
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    # TF32 on, as torch's cuDNN default: the f32 arm must turn it off
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        for arm, model in arms.items():
            with pipeline_timing() as spans:
                scores[arm], on = timed_scoring(model, table, VISION["reps"])
            entry = {"e2e_rows_per_s": on, "spans": spans.summary()}
            if off_and_on:
                _, entry["e2e_rows_per_s_prefetch_off"] = timed_scoring(
                    model.copy(prefetchDepth=-1), table, VISION["reps"])
            entry["steady_rows_per_s"] = scoring_steady_state(
                model, rows, batch, iters)
            fpr = flops_per_row(model, rows[0])
            peak = peak_of[arm]
            entry.update(
                flops_per_row=fpr, peak_flops=peak,
                steady_share_of_peak=entry["steady_rows_per_s"] * fpr / peak,
                resident_weight_bytes=resident_bytes(
                    model._scoring_module()))
            check_scores(f"phase 21 {name} {arm}", scores[arm],
                         (len(rows), n_out))
            out[arm] = entry
            print(f"phase 21 {name} {arm}: e2e {max(on):.1f} rows/s "
                  f"(prefetch on, best of {len(on)}"
                  + (f"; off {max(entry['e2e_rows_per_s_prefetch_off']):.1f}"
                     if off_and_on else "")
                  + f"), steady {entry['steady_rows_per_s']:.1f} rows/s, "
                  f"{fpr / 1e6:.2f} MFLOP/row, "
                  f"{entry['steady_share_of_peak']:.4f} of {peak / 1e12:.0f} "
                  f"TFLOP/s, weights {entry['resident_weight_bytes']} B, "
                  f"spans host/transfer/compute/drain "
                  + "/".join(f"{spans.seconds.get(k, 0.0):.3f}"
                             for k in ("host", "transfer", "compute",
                                       "drain"))
                  + f" s [{card}]")
        faulty = {arm: TPUModel(planted_fault(arms[arm].bundle, arm, node),
                                device=dev, **arms[arm].param_values())
                  for arm, node in gates["faults"].items()}
        fault_scores = {arm: m.transform(table)[m.outputCol]
                        for arm, m in faulty.items()}
        require(cudnn.allow_tf32 and matmul.allow_tf32,
                f"phase 21 {name}: the stage did not restore the TF32 flags")
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    f32 = scores["f32"]
    first = rows[:VISION["check_rows"]]
    out["f32"]["card_vs_cpu"] = check_card_f32(
        f"phase 21 {name}", f32[:len(first)],
        cpu_scores(arms["f32"], first))
    distinct = int(len(np.unique(f32.argmax(1))))
    out["f32"]["distinct_argmax"] = distinct
    require(distinct >= gates["min_distinct"],
            f"phase 21 {name}: the f32 argmax takes {distinct} classes over "
            f"{len(rows)} rows (floor {gates['min_distinct']})")
    lines = []
    for arm, tol in gates["tol"].items():
        model, n = arms[arm], gates["same_rows"]
        cpu = cpu_scores(model, rows[:n])
        entry = out[arm]
        entry["vs_f32"] = arm_readings(scores[arm], f32, tol[0])
        entry["vs_cpu"] = same_readings(scores[arm][:n], cpu)
        entry["fault"] = {"node": gates["faults"][arm],
                          "vs_f32": arm_readings(fault_scores[arm], f32,
                                                 tol[0]),
                          "vs_cpu": same_readings(fault_scores[arm][:n], cpu)}
        ok = arm_passes(entry["vs_f32"], entry["vs_cpu"], tol)
        caught = arm_passes(entry["fault"]["vs_f32"],
                            entry["fault"]["vs_cpu"], tol)
        lines.append(f"{arm} "
                     + describe_arm(entry["vs_f32"], entry["vs_cpu"], tol)
                     + f"; planted fault at {gates['faults'][arm]}: "
                     + describe_arm(entry["fault"]["vs_f32"],
                                    entry["fault"]["vs_cpu"], tol))
        require(all(ok), f"phase 21 {name} {arm}: " + lines[-1])
        require(not any(caught), f"phase 21 {name} {arm}: a gate passed "
                "the planted fault: " + lines[-1])
    print(f"phase 21 {name} gates: card f32 vs CPU f32 max |d| "
          f"{out['f32']['card_vs_cpu']['max_abs_err']:.3e} of max |logit| "
          f"{out['f32']['card_vs_cpu']['max_abs_logit']:.3e}, {distinct} "
          f"distinct f32 classes; " + "; ".join(lines) + f" [{card}]")
    return out


def phase_vision_scoring(dev, card) -> dict:
    """chip_smoke phase 21: `TPUModel.transform` over the vision and
    tabular models.  (a) the zoo ConvNet (ConvNet_UCIDigits, widths 64 /
    128 / 256, dense 512, bf16) over 32768 uint8 32 x 32 x 3 images at
    miniBatchSize 4096: the bf16 arm with prefetch off and on, f32 and
    int8 arms; (b) resnet50() at full width (1000 classes) with seeded
    random weights made input-dependent by `calibrated_bundle` over 1024
    uint8 224 x 224 x 3 images at 256: computeDtype bfloat16 and float32
    and the int8 bundle, prefetch off and on; (c) the TabularWDBC and
    TextSentiment MLP bundles over seeded 30- and 4096-wide features.
    Every arm: rows/s end to end and in the device steady state, FLOPs
    per row and share of the peak; gates (VISION_GATES): the card's f32
    forward against the CPU's on the first 256 rows, the f32 argmax's
    distinct classes, each bf16 and int8 arm against the f32 arm and
    against the CPU at its own precision, a planted fault per arm
    rejected, shapes, no NaN or Inf."""
    from mmlspark_tpu_torch import TPUModel
    from mmlspark_tpu_torch.quant import quantize_bundle
    from mmlspark_tpu_torch.zoo import ModelDownloader, pretrained_repo
    import tempfile
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    out: dict = {"card": card}
    with tempfile.TemporaryDirectory() as cache:
        dl = ModelDownloader(cache)
        zoo = {n: dl.load_bundle(dl.download_by_name(pretrained_repo(), n))
               for n in ("ConvNet", "TabularWDBC", "TextSentiment")}

    def stage(bundle, batch, **params):
        return TPUModel(bundle, device=dev, inputCol="x", outputCol="y",
                        miniBatchSize=batch, **params)

    # (a) the zoo ConvNet
    bs = VISION["convnet_batch"]
    images = rng.integers(0, 256, (VISION["convnet_images"], 32, 32, 3),
                          dtype=np.uint8)
    conv = zoo["ConvNet"]
    require(conv.config["widths"] == [64, 128, 256]
            and conv.config["dense_width"] == 512,
            f"phase 21: the zoo ConvNet's config is {conv.config}")
    out["convnet"] = vision_arms(
        dev, card, "convnet", "convnet",
        {"bf16": stage(conv, bs), "f32": stage(conv, bs,
                                               computeDtype="float32"),
         "int8": stage(quantize_bundle(conv, "int8"), bs)},
        images, bs, 10,
        {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_FLOPS,
         "int8": PEAK_BF16_FLOPS}, True, VISION["steady_iters"])
    del images
    torch.cuda.empty_cache()
    # (b) ResNet-50
    bs = VISION["resnet_batch"]
    images = rng.integers(0, 256, (VISION["resnet_images"], 224, 224, 3),
                          dtype=np.uint8)
    r50 = resnet50_bundle(images[:VISION["calibration_rows"]],
                          VISION["resnet_branch_scale"])
    out["resnet50"] = vision_arms(
        dev, card, "resnet50", "resnet50",
        {"bf16": stage(r50, bs, computeDtype="bfloat16"),
         "f32": stage(r50, bs),
         "int8": stage(quantize_bundle(r50, "int8"), bs)},
        images, bs, 1000,
        {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_FLOPS,
         "int8": PEAK_BF16_FLOPS}, True, VISION["steady_iters"])
    del images
    torch.cuda.empty_cache()
    # (c) the two MLP bundles
    bs = VISION["mlp_batch"]
    wdbc = rng.standard_normal((VISION["wdbc_rows"], 30), dtype=np.float32)
    text = (rng.random((VISION["text_rows"], 4096), dtype=np.float32)
            * (rng.random((VISION["text_rows"], 4096)) < 0.01)).astype(
        np.float32)
    for name, rows in (("TabularWDBC", wdbc), ("TextSentiment", text)):
        b = zoo[name]
        out[name] = vision_arms(
            dev, card, name, "mlp",
            {"bf16": stage(b, bs), "f32": stage(b, bs,
                                                computeDtype="float32")},
            rows, bs, 2, {"bf16": PEAK_BF16_FLOPS, "f32": PEAK_F32_FLOPS},
            False, 20)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 21 (vision and tabular scoring): {out['seconds']:.1f} s "
          f"[{card}]")
    return out


def resnet50_bundle(images: np.ndarray, branch_scale: float):
    """resnet50() at full width, f32, seeded (0, then 1 for the BatchNorm
    draws) and made input-dependent over `images` by `calibrated_bundle`,
    each bottleneck branch's last BatchNorm scaled by `branch_scale`."""
    from mmlspark_tpu_torch.models import ModelBundle
    from mmlspark_tpu_torch.models.bundle import calibrated_bundle
    r50 = ModelBundle.init("ResNet", {"stage_sizes": [3, 4, 6, 3],
                                      "widths": [64, 128, 256, 512],
                                      "num_classes": 1000,
                                      "block_kind": "bottleneck",
                                      "dtype": "float32"},
                           seed=0, input_shape=(1, 224, 224, 3))
    return calibrated_bundle(r50, images, seed=1, branch_scale=branch_scale)


# -- phase 22: the image pipeline ---------------------------------------------

# bench.py bench_ingestion's configuration: 768 PNGs of 224 x 224 x 3 on
# disk, read in batches of 128, scored by resnet50() at bf16; the depth
# knob 0 (the Autotuner), fixed 8 and the hand sweep, decisions every 4
# batch pulls (6 batches: each tuner steps once); each arm timed `reps`
# times (2 until phase 30 needed the time), the arms interleaved, the
# start rotated a rep.  (b): 1024 seeded
# uint8 images 240 high, 320 wide (a resize to 256 x 256 scales the
# height up and the width down), batch 256; each op alone at (256, 320,
# 240, 3) float32.
INGEST = dict(n_files=768, side=224, batch=128, fixed=8,
              sweep=(2, 4, 8, 16, 32), interval=4, calibration_rows=32,
              reps=1)
TRANSFORM = dict(images=1024, height=240, width=320, batch=256, reps=2,
                 check_rows=16, cpu_feature_rows=8)
OPS_SHAPE = (256, 320, 240, 3)
OPS_CHECK_ROWS = 8
# absolute limits on the [0, 255] scale of the outputs: the card against
# the port's CPU forward of the same op (0: exact).  Sound readings on the
# H100 sit at or below 3.2e-3 (resize) and 1.5e-5 (gray); TF32 errs by
# about a tenth of a level, far over each limit (the TF32 control below).
OP_LIMITS = {"resize": 1e-2, "blur": 1e-3, "gaussian": 1e-3, "gray": 1e-3,
             "normalize": 1e-5, "exact": 0.0}
ZOO_RESNET50 = {"input_shape": [1, 224, 224, 3],
                "layer_names": ["z", "pool", "stage4", "stage3", "stage2",
                                "stage1"]}


def png_bytes(arr: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of an (H, W, 3) uint8 array, written with the
    standard library alone (filter 0 on every row, zlib, CRC32)."""
    import struct
    import zlib
    h, w, _ = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(arr).reshape(h, w * 3)],
                         axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def ingest_corpus(directory: str) -> tuple:
    """bench_ingestion's corpus: image n is (i + j) % 256 + 7 n (mod 256),
    gray replicated to 3 channels; returns (paths, arrays)."""
    import os
    side = INGEST["side"]
    base = np.add.outer(np.arange(side), np.arange(side)) % 256
    paths, arrays = [], []
    for n in range(INGEST["n_files"]):
        arr = ((base + 7 * n) % 256).astype(np.uint8)
        arr = np.stack([arr] * 3, axis=-1)
        path = os.path.join(directory, f"img_{n:05d}.png")
        with open(path, "wb") as f:
            f.write(png_bytes(arr))
        paths.append(path)
        arrays.append(arr)
    return paths, np.stack(arrays)


def header_found(name: str) -> bool:
    """Whether g++ finds `<name>` on its include path."""
    try:
        done = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                              input=f"#include <{name}>\n", text=True,
                              capture_output=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return done.returncode == 0


def codecs() -> dict:
    """Which host decoders this machine has: the codec headers on g++'s
    include path, the native library (built here from
    `mmlspark_tpu_torch/native/decode.cpp`) and PIL; a decoder that is
    present must return the written pixels (BGR) of a PNG with distinct
    channels."""
    from mmlspark_tpu_torch import native_loader
    from mmlspark_tpu_torch.io import image_reader
    out = {"headers": {h: header_found(h)
                       for h in ("png.h", "jpeglib.h", "zlib.h")}}
    try:
        native_loader.build_native()
        out["native"] = "built"
    except Exception as e:   # reported, and then PIL or nothing decodes
        detail = getattr(e, "stderr", "") or repr(e)
        out["native"] = f"unavailable ({detail.strip().splitlines()[-1]})"
    try:
        import PIL
        out["pil"] = f"PIL {PIL.__version__}"
    except ImportError as e:
        out["pil"] = f"unavailable ({e})"
    rgb = np.random.default_rng(3).integers(0, 256, (48, 64, 3),
                                            dtype=np.uint8)
    data = png_bytes(rgb)
    if out["native"] == "built":
        got = native_loader.native_decode(data)
        require(got is not None and np.array_equal(got, rgb[..., ::-1]),
                "phase 22: the native decoder returned wrong pixels")
    if out["pil"].startswith("PIL"):
        got = image_reader._pil_decode(data)
        require(got is not None and np.array_equal(got, rgb[..., ::-1]),
                "phase 22: PIL returned wrong pixels")
    out["decodes"] = out["native"] == "built" or out["pil"].startswith("PIL")
    return out


def ingest_arm(model, knob: int, source) -> dict:
    """One arm of (a): `source()` -> `model.transform_batches` with the
    one depth knob governing both the reader's decode lookahead (the
    config variable) and the model's staging window (the Param)."""
    from mmlspark_tpu_torch import config
    config.set("MMLSPARK_TPU_PREFETCH_DEPTH", knob)
    m = model.copy(prefetchDepth=knob)
    paths, scores, images = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scored in m.transform_batches(source()):
        paths.extend(scored["path"])
        scores.append(scored["scores"])
        images.append(scored["image"])
    wall = time.perf_counter() - t0
    return {"rate": len(paths) / wall, "paths": paths,
            "scores": np.concatenate(scores), "images": images}


def check_ingest_arm(name: str, arm: dict, paths: list, arrays: np.ndarray,
                     reference: np.ndarray, gap_scale: float) -> float:
    """(a)'s gates on one pass: every file's row in order, the pixels the
    written arrays, the streamed scores `transform`'s; returns the largest
    score gap."""
    require(arm["paths"] == paths,
            f"phase 22 {name}: {len(arm['paths'])} rows, not the "
            f"{len(paths)} files in order")
    got = np.concatenate(arm["images"])
    require(got.shape == arrays.shape and np.array_equal(got, arrays),
            f"phase 22 {name}: the streamed pixels differ from the "
            "written arrays")
    gap = float(np.abs(arm["scores"] - reference).max())
    same = bool((arm["scores"].argmax(1) == reference.argmax(1)).all())
    require(same and gap <= 1e-3 * gap_scale,
            f"phase 22 {name}: streamed scores against transform of the "
            f"stacked arrays: max gap {gap:.3e} (limit "
            f"{1e-3 * gap_scale:.3e}), argmax equal {same}")
    return gap


@contextlib.contextmanager
def counting_tuner_steps():
    """Counts `Autotuner.step` calls inside the block (every tuner's)."""
    from mmlspark_tpu_torch.data.autotune import Autotuner
    counted = {"steps": 0}
    step = Autotuner.step

    def counting(self):
        counted["steps"] += 1
        return step(self)
    Autotuner.step = counting
    try:
        yield counted
    finally:
        Autotuner.step = step


def phase_image_pipeline(dev, card, shared: Optional[dict] = None) -> dict:
    """chip_smoke phase 22: the image pipeline.  (0) the host's codecs;
    (a) bench_ingestion's configuration: 768 PNGs written with the
    standard library -> `read_images_iter(batch_size=128, resize_to=(224,
    224))` -> `TPUModel(resnet50 bf16, miniBatchSize=128)
    .transform_batches` at depth 0 (the Autotuner), fixed 8 and the hand
    sweep, each `INGEST["reps"]` times interleaved: median images/s each,
    the autotune arm's spans, steps and decisions; gates on every pass:
    decoded pixels equal the written arrays, the 768 rows in order,
    streamed scores agree with `transform` of the stacked arrays.  (b)
    1024 seeded 240 x 320 images -> `ImageTransformer.resize(
    256, 256).center_crop(224, 224).flip()` -> `ImageFeaturizer` over the
    same ResNet-50 at f32, cut 1 (pool) and 2 (stage4), images/s each;
    each op alone at (256, 320, 240, 3) float32 timed by CUDA events
    against its bytes; gates: every op and the transformer against the
    port's CPU forward, the featurizer's f32 features against the CPU's,
    the widths, three planted faults rejected."""
    import os
    import tempfile
    from mmlspark_tpu_torch import DataTable, TPUModel, config
    from mmlspark_tpu_torch.data import Dataset
    from mmlspark_tpu_torch.io.image_reader import (_dense_batch,
                                                    _resize_all,
                                                    decoder_counts,
                                                    read_images_iter)
    from mmlspark_tpu_torch.observe.telemetry import run_telemetry
    t0 = time.perf_counter()
    out: dict = {"card": card}
    # (0) codecs
    out["codecs"] = codecs()
    print(f"phase 22 codecs: headers "
          + ", ".join(f"{h} {'found' if ok else 'missing'}"
                      for h, ok in out["codecs"]["headers"].items())
          + f"; native decoder {out['codecs']['native']}; "
          f"{out['codecs']['pil']}")
    bs = INGEST["batch"]
    prev_depth = config.get("MMLSPARK_TPU_PREFETCH_DEPTH")
    prev_interval = config.get("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL")
    with tempfile.TemporaryDirectory() as corpus:
        t_write = time.perf_counter()
        paths, arrays = ingest_corpus(corpus)
        out["corpus"] = {"files": len(paths), "write_s":
                         time.perf_counter() - t_write,
                         "bytes": sum(os.path.getsize(p) for p in paths)}
        if out["codecs"]["decodes"]:
            def source():
                return read_images_iter(corpus, batch_size=bs,
                                        resize_to=(224, 224), device=dev)
            out["decoder"] = "files"
        else:
            print(f"decoder: unavailable on this host "
                  f"(native {out['codecs']['native']}; "
                  f"{out['codecs']['pil']}); (a) starts from the pixel "
                  "arrays")

            def source():
                def decode(chunk):
                    return _dense_batch([p for p, _ in chunk], _resize_all(
                        [a for _, a in chunk], (224, 224), dev))
                return (Dataset.from_iterable(lambda: zip(paths, arrays))
                        .batch(bs).map(decode, name="decode"))
            out["decoder"] = "arrays"
        r50 = ingest_resnet50(arrays, shared)
        model = TPUModel(r50, device=dev, inputCol="image",
                         outputCol="scores", miniBatchSize=bs,
                         computeDtype="bfloat16")
        model.transform(DataTable({"image": arrays[:bs]}))   # warm
        reference = model.transform(DataTable({"image": arrays}))["scores"]
        gap_scale = float(np.abs(reference).max())
        before = dict(decoder_counts)
        knobs = [("fixed_8", INGEST["fixed"])] + [
            (f"hand_{k}", k) for k in INGEST["sweep"]] + [("autotune", 0)]
        rates = {name: [] for name, _ in knobs}
        gaps = dict.fromkeys(rates, 0.0)
        steps, decisions, spans = [], [], None
        try:
            config.set("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL",
                       INGEST["interval"])
            ingest_arm(model, INGEST["fixed"], source)   # untimed pass
            for rep in range(INGEST["reps"]):
                turn = rep % len(knobs)
                for name, knob in knobs[turn:] + knobs[:turn]:
                    if knob:
                        arm = ingest_arm(model, knob, source)
                    else:
                        with run_telemetry(None) as rt, \
                                counting_tuner_steps() as counted:
                            arm = ingest_arm(model, 0, source)
                        spans = rt.timings
                        steps.append(counted["steps"])
                        decisions.append(
                            [r["attrs"] for r in rt.tracer.records()
                             if r.get("name") == "data.autotune"])
                    gaps[name] = max(gaps[name], check_ingest_arm(
                        name, arm, paths, arrays, reference, gap_scale))
                    rates[name].append(arm["rate"])
                    del arm
        finally:
            config.set("MMLSPARK_TPU_PREFETCH_DEPTH", prev_depth)
            config.set("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL", prev_interval)
    decoded = {k: decoder_counts[k] - before[k] for k in decoder_counts}
    median = {k: statistics.median(v) for k, v in rates.items()}
    hand = {k: v for k, v in median.items() if k.startswith("hand_")}
    best = max(hand, key=hand.get)
    # fixed_8 and hand_8 are one configuration: their gap is the noise floor
    same = (median["fixed_8"], median[f"hand_{INGEST['fixed']}"])
    noise = abs(same[0] - same[1]) / max(same)
    out["ingest"] = {
        "images": len(paths), "batch": bs, "reps": INGEST["reps"],
        "decoded": decoded, "images_per_s": rates,
        "median_images_per_s": median, "hand_best": best,
        "autotune_vs_hand_best": median["autotune"] / hand[best],
        "noise_floor": noise,
        "max_score_gap": max(gaps.values()), "max_abs_score": gap_scale,
        "spans": spans.summary(), "autotune_steps": steps,
        "autotune_decisions": decisions,
        "service_arm": "phase 30"}
    print(f"phase 22 (a) ingestion of {len(paths)} PNGs "
          f"({out['corpus']['bytes']} bytes, written in "
          f"{out['corpus']['write_s']:.2f} s; decoded {decoded}): images/s, "
          f"median of {INGEST['reps']} interleaved [min, max]: "
          + ", ".join(f"{k} {median[k]:.1f} [{min(v):.1f}, {max(v):.1f}]"
                      for k, v in rates.items())
          + f"; noise floor |fixed_8 - hand_{INGEST['fixed']}| / max "
          f"{noise:.3f}; autotune / best hand ({best}) "
          f"{out['ingest']['autotune_vs_hand_best']:.3f}; autotune steps "
          f"a pass {steps}, decisions "
          + str([[(d["stage"], d["action"], d["depth_to"]) for d in ds]
                 for ds in decisions])
          + "; last autotune pass's spans "
          + "/".join(f"{k} {v:.3f}" for k, v in spans.seconds.items())
          + f" thread-s; pixels equal, rows in order, max score gap "
          f"{out['ingest']['max_score_gap']:.3e} of max |score| "
          f"{gap_scale:.3e}; the service arms: phase 30 [{card}]")
    del reference
    torch.cuda.empty_cache()
    out["transform"] = transform_and_featurize(dev, card, r50)
    out["ops"] = time_image_ops(dev, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 22 (the image pipeline): {out['seconds']:.1f} s [{card}]")
    return out


def transform_and_featurize(dev, card, r50) -> dict:
    """(b): the transformer and the featurizer end to end, each against
    the port's CPU forward."""
    from mmlspark_tpu_torch import DataTable
    from mmlspark_tpu_torch.models import ModelBundle
    from mmlspark_tpu_torch.vision import ImageFeaturizer, ImageTransformer
    cfg = TRANSFORM
    rng = np.random.default_rng(22)
    images = rng.integers(0, 256, (cfg["images"], cfg["height"],
                                   cfg["width"], 3), dtype=np.uint8)
    table = DataTable({"image": images})
    out = {}

    def chain(device):
        return (ImageTransformer(inputCol="image", outputCol="image",
                                 device=device)
                .resize(256, 256).center_crop(224, 224).flip())
    transformer = chain(dev)
    transformer.transform(DataTable({"image": images[:cfg["batch"]]}))
    rates = []
    for _ in range(cfg["reps"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        crops = transformer.transform(table)["image"]
        rates.append(len(images) / (time.perf_counter() - t))
    n = cfg["check_rows"]
    cpu = chain("cpu").transform(DataTable({"image": images[:n]}))["image"]
    err = float(np.abs(crops[:n] - cpu).max())
    limit = OP_LIMITS["resize"]
    require(crops.shape == (len(images), 224, 224, 3)
            and crops.dtype == np.float32 and err <= limit,
            f"phase 22 transformer: {crops.shape} {crops.dtype}, card vs CPU "
            f"max |d| {err:.3e} (limit {limit:.0e})")
    out["transformer"] = {"images_per_s": sorted(rates), "max_abs_err": err}
    bundle = ModelBundle(r50.architecture, r50.config, r50.variables,
                         {**(r50.metadata or {}), **ZOO_RESNET50})
    crops_table = DataTable({"image": crops})
    m = cfg["cpu_feature_rows"]
    for cut, want in ((1, (2048,)), (2, (7, 7, 2048))):
        feat = ImageFeaturizer(bundle, inputCol="image", outputCol="f",
                               cutOutputLayers=cut,
                               miniBatchSize=cfg["batch"], device=dev)
        feat.transform(DataTable({"image": crops[:cfg["batch"]]}))
        rates = []
        for _ in range(cfg["reps"]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            feats = feat.transform(crops_table)["f"]
            rates.append(len(crops) / (time.perf_counter() - t))
        cpu = ImageFeaturizer(bundle, inputCol="image", outputCol="f",
                              cutOutputLayers=cut, miniBatchSize=m,
                              device="cpu").transform(
            DataTable({"image": crops[:m]}))["f"]
        scale = float(np.abs(cpu).max())
        err = float(np.abs(feats[:m] - cpu).max())
        require(feats.shape == (len(crops),) + want
                and bool(np.isfinite(feats).all())
                and err <= 1e-5 * scale,
                f"phase 22 featurizer cut {cut}: {feats.shape} (want "
                f"{(len(crops),) + want}), card f32 vs CPU max |d| "
                f"{err:.3e} (limit {1e-5 * scale:.3e})")
        out[f"featurizer_cut{cut}"] = {
            "node": ZOO_RESNET50["layer_names"][cut], "width": list(want),
            "images_per_s": sorted(rates), "max_abs_err": err,
            "max_abs_feature": scale}
    print(f"phase 22 (b) ImageTransformer resize(256, 256).center_crop(224, "
          f"224).flip() over {len(images)} images 240 x 320: "
          f"{max(out['transformer']['images_per_s']):.1f} images/s (best "
          f"of {cfg['reps']}), card vs CPU {out['transformer']['max_abs_err']:.3e}; "
          + "; ".join(
              f"ImageFeaturizer cut {c} ({out[f'featurizer_cut{c}']['node']}, "
              f"{out[f'featurizer_cut{c}']['width']}) f32 "
              f"{max(out[f'featurizer_cut{c}']['images_per_s']):.1f} "
              f"images/s, card vs CPU "
              f"{out[f'featurizer_cut{c}']['max_abs_err']:.3e} of max "
              f"|feature| {out[f'featurizer_cut{c}']['max_abs_feature']:.3e}"
              for c in (1, 2)) + f" [{card}]")
    return out


def image_op_cases():
    """name -> (call on a (B, H, W, C) tensor, its `OP_LIMITS` key).  crop
    returns a view, so its timed form copies the crop out."""
    from mmlspark_tpu_torch.ops import image as ops
    return {
        "resize_down_160x120": (lambda t: ops.resize(t, 160, 120), "resize"),
        "resize_up_480x360": (lambda t: ops.resize(t, 480, 360), "resize"),
        "resize_mixed_256x256": (lambda t: ops.resize(t, 256, 256),
                                 "resize"),
        "resize_lanczos3_160x120": (
            lambda t: ops.resize(t, 160, 120, "lanczos3"), "resize"),
        "crop_224": (lambda t: ops.crop(t, 8, 48, 224, 224).contiguous(),
                     "exact"),
        "flip": (lambda t: ops.flip(t, 1), "exact"),
        "bgr2gray": (lambda t: ops.cvt_color(t, "bgr2gray"), "gray"),
        "bgr2rgb": (lambda t: ops.cvt_color(t, "bgr2rgb"), "exact"),
        "blur_4x4": (lambda t: ops.blur(t, 4, 4), "blur"),
        "blur_5x5": (lambda t: ops.blur(t, 5, 5), "blur"),
        "gaussian_kernel_4": (lambda t: ops.gaussian_kernel(t, 4, 1.0),
                              "gaussian"),
        "gaussian_kernel_5": (lambda t: ops.gaussian_kernel(t, 5, 0.0),
                              "gaussian"),
        "threshold": (lambda t: ops.threshold(t, 127.5, 255.0), "exact"),
        "normalize": (lambda t: ops.normalize(t, [0.45, 0.45, 0.45],
                                              [0.25, 0.25, 0.25]),
                      "normalize"),
        "unroll": (lambda t: ops.unroll(t), "exact"),
    }


@contextlib.contextmanager
def tf32_allowed():
    """A planted fault's setting: TF32 on for cuBLAS and cuDNN, and
    `ops.image` without the `exact_f32` guard of its lanczos matmuls and
    its gaussian conv."""
    from mmlspark_tpu_torch.ops import image as ops
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = ops.exact_f32, cudnn.allow_tf32, matmul.allow_tf32
    ops.exact_f32 = contextlib.nullcontext
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        yield
    finally:
        ops.exact_f32, cudnn.allow_tf32, matmul.allow_tf32 = saved


def tf32_lanczos(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """A planted fault: the lanczos3 resize with its matmuls in TF32."""
    from mmlspark_tpu_torch.ops import image as ops
    with tf32_allowed():
        return ops.resize(x, height, width, "lanczos3")


def unfiltered_resize(x: torch.Tensor, height: int,
                      width: int) -> torch.Tensor:
    """A planted fault: `ops.image.resize` without the antialiasing
    filter that `jax.image.resize` applies when it downsamples."""
    return torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
        align_corners=False, antialias=False).permute(0, 2, 3, 1)


def mirrored_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """A planted fault: `ops.image.blur` with an even window's "SAME"
    padding mirrored (k // 2 low, (k - 1) // 2 high)."""
    pads = (k // 2, (k - 1) // 2) * 2
    f = torch.nn.functional
    summed = f.avg_pool2d(f.pad(x.permute(0, 3, 1, 2), pads), k, stride=1,
                          divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[1:3]), device=x.device)
    counts = f.avg_pool2d(f.pad(ones, pads), k, stride=1,
                          divisor_override=1)
    return (summed / counts).permute(0, 2, 3, 1)


def time_image_ops(dev, card) -> dict:
    """Each op alone at OPS_SHAPE float32 on the card: CUDA-event median
    of 5 after warm-up, the bytes it must move (its input read once, its
    output written once) and their share of 3.35 TB/s; each checked
    against the port's CPU forward on the first rows within its
    `OP_LIMITS` entry, and three planted faults (resize without the
    antialiasing filter, a 4 x 4 blur padded symmetrically, the lanczos3
    resize in TF32) rejected by the limit of the op they break.  The
    gaussian in TF32 is read and printed, not gated: cuDNN may run its
    one-channel conv without tensor cores, where TF32 changes nothing."""
    from mmlspark_tpu_torch.ops import image as ops
    rng = np.random.default_rng(23)
    host = rng.uniform(0, 255, OPS_SHAPE).astype(np.float32)
    x = torch.from_numpy(host).to(dev)
    head = torch.from_numpy(host[:OPS_CHECK_ROWS].copy())
    rows, lines = {}, []
    with torch.inference_mode():
        for name, (fn, kind) in image_op_cases().items():
            y = fn(x)
            torch.cuda.synchronize()
            ref = fn(head)
            err = float((y[:OPS_CHECK_ROWS].cpu() - ref).abs().max())
            limit = OP_LIMITS[kind]
            require(err <= limit,
                    f"phase 22 op {name}: card vs CPU max |d| {err:.3e} "
                    f"(limit {limit:.0e})")
            ms = cuda_ms(lambda: fn(x), warmup=2, reps=5)
            nbytes = x.numel() * x.element_size() + y.numel() * \
                y.element_size()
            share = nbytes / (ms * 1e-3) / PEAK_BYTES
            rows[name] = {"ms": ms, "bytes": nbytes, "bw_share": share,
                          "max_abs_err": err, "limit": limit,
                          "out_shape": list(y.shape)}
            lines.append(f"{name} {ms:.3f} ms {nbytes / 1e6:.1f} MB "
                         f"{share:.3f} of 3.35 TB/s (card vs CPU "
                         f"{err:.1e}, limit {limit:.0e})")
            del y
        # name -> (fault on the card, the sound op on the CPU, limit)
        faults = {
            "resize without antialias": (
                lambda t: unfiltered_resize(t, 160, 120),
                lambda t: ops.resize(t, 160, 120), "resize"),
            "blur 4x4 padded symmetrically": (
                lambda t: mirrored_blur(t, 4), lambda t: ops.blur(t, 4, 4),
                "blur"),
            "lanczos3 resize in TF32": (
                lambda t: tf32_lanczos(t, 160, 120),
                lambda t: ops.resize(t, 160, 120, "lanczos3"), "resize")}
        caught = {}
        for name, (fault, sound, kind) in faults.items():
            err = float((fault(x)[:OPS_CHECK_ROWS].cpu()
                         - sound(head)).abs().max())
            caught[name] = {"max_abs_err": err, "limit": OP_LIMITS[kind]}
            require(err > OP_LIMITS[kind],
                    f"phase 22: the op gate passed the planted fault "
                    f"'{name}' (max |d| {err:.3e}, limit "
                    f"{OP_LIMITS[kind]:.0e})")
        with tf32_allowed():
            gauss = ops.gaussian_kernel(x, 4, 1.0)[:OPS_CHECK_ROWS].cpu()
        tf32_gauss = float((gauss - ops.gaussian_kernel(head, 4, 1.0))
                           .abs().max())
    print(f"phase 22 ops at {OPS_SHAPE} float32 (CUDA events, median of 5): "
          + "; ".join(lines) + "; planted faults rejected: "
          + ", ".join(f"{k} max |d| {v['max_abs_err']:.3e} (limit "
                      f"{v['limit']:.0e})" for k, v in caught.items())
          + f"; gaussian_kernel_4 in TF32 (not gated) max |d| "
          f"{tf32_gauss:.3e} [{card}]")
    return {"shape": list(OPS_SHAPE), "rows": rows, "faults": caught,
            "tf32_gaussian_max_abs_err": tf32_gauss}


# ---------------------------------------------------------------------------
# phase 23: training the vision and tabular models
# ---------------------------------------------------------------------------

VISION_TRAIN = dict(
    # (a) the zoo ConvNet at scripts/train_zoo_model.py::train_convnet's
    # configuration, on seeded class templates plus noise
    convnet_images=4096, convnet_epochs=3, convnet_batch=128,
    convnet_noise=48.0, convnet_reps=2, min_accuracy=0.9,
    # (b) resnet50() at 224 x 224, 8 steps of 128
    resnet_images=1024, resnet_side=224, resnet_batch=128, resnet_lr=0.01,
    # (c) card against CPU at f32: the zoo ResNetDigits, 2 steps on one
    # batch of 8 (BatchNorm over 2 x 2 maps in the last stage: 32 values a
    # channel, where an unbiased running variance is 32/31 of flax's)
    digits_batch=8, card_vs_cpu_tol=1e-4,
    # (d) resume: ResNetDigits, 512 images at batch 64, 2 epochs, a
    # checkpoint every 4 steps, a SIGTERM at step 6
    resume_images=512, resume_batch=64, resume_every=4, preempt_at=6,
    # (e) TPULearner over the WDBC bundle's width
    learner_rows=65536, learner_features=30, learner_batch=512,
    learner_epochs=2, learner_accuracy=0.95,
    step_reps=5)
RESNET_DIGITS = {"stage_sizes": [1, 1, 1], "widths": [8, 16, 32],
                 "num_classes": 10, "block_kind": "bottleneck"}
CONVNET = {}   # ConvNetCIFAR10's defaults: widths 64 / 128 / 256, dense 512
RESNET50 = {"stage_sizes": [3, 4, 6, 3], "widths": [64, 128, 256, 512],
            "num_classes": 1000, "block_kind": "bottleneck",
            "dtype": "bfloat16"}


def template_images(n: int, classes: int, noise: float, seed: int) -> tuple:
    """`n` uint8 32 x 32 x 3 images in `classes` classes: each class a
    fixed seeded template, each image its template plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    templates = rng.integers(0, 256, (classes, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, classes, n)
    noisy = templates[labels] + rng.normal(0.0, noise, (n, 32, 32, 3))
    return np.clip(noisy, 0, 255).astype(np.uint8), labels.astype(np.int32)


def train_step_ms(trainer, bundle, x: np.ndarray, y: np.ndarray,
                  dev) -> tuple:
    """(median ms, one step as a no-argument function): CUDA events
    around each of VISION_TRAIN["step_reps"] steady steps of `trainer`'s
    step over one batch already on the card, after two warm steps, from
    `bundle`'s weights."""
    state = trainer.init_state((1,) + x.shape[1:], 16, bundle)
    step = trainer.make_train_step()
    xb, yb = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    mb = torch.ones(len(x), device=dev)
    for _ in range(2):
        step(state, xb, yb, mb)
    times = []
    for _ in range(VISION_TRAIN["step_reps"]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, xb, yb, mb)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), lambda: step(state, xb, yb, mb)


def fit_spans(timing, trainer) -> dict:
    """One fit's staging and dispatch seconds: host (the gather and the
    pinned buffers) and transfer (the copies' launch) on whichever thread
    staged, compute (the step's dispatch), and stall (the dispatch
    thread's waits on a batch not yet staged; 0 at depth -1, where the
    dispatch thread stages)."""
    return {"host": timing.seconds.get("host", 0.0),
            "transfer": timing.seconds.get("transfer", 0.0),
            "compute": timing.seconds.get("compute", 0.0),
            "stall": trainer.last_staging["stall_s"]}


def describe_spans(spans: dict) -> str:
    return "; ".join(
        f"prefetch {depth} " + ", ".join(
            "/".join(f"{s[k]:.3f}" for k in ("host", "transfer", "compute",
                                            "stall")) for s in runs)
        for depth, runs in spans.items())


def timed_fit(trainer, x: np.ndarray, y: np.ndarray, **kw) -> tuple:
    """(bundle, seconds) of one `fit_arrays`, the card synchronized on
    both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = trainer.fit_arrays(x, y, **kw)
    torch.cuda.synchronize()
    return bundle, time.perf_counter() - t0


def leaf_gaps(got, ref) -> dict:
    """Each params / batch_stats leaf's max |got - ref| over its max
    |ref| (path -> ratio)."""
    out = {}

    def walk(path, a, b):
        if isinstance(b, dict):
            for key in sorted(b):
                walk(f"{path}/{key}", a[key], b[key])
        else:
            b = np.asarray(b)
            out[path] = float(np.abs(np.asarray(a) - b).max()
                              / max(float(np.abs(b).max()), 1e-30))
    walk("", got.variables, ref.variables)
    return out


def unbiased_batchnorm(self, x: torch.Tensor) -> torch.Tensor:
    """The planted fault of phase 23 (c): torch's training BatchNorm,
    whose running variance moves toward the UNBIASED batch variance."""
    from mmlspark_tpu_torch.models.definitions import BN_EPS
    return torch.nn.functional.batch_norm(
        x.float(), self.mean, self.var, self.scale, self.bias,
        training=True, momentum=0.01, eps=BN_EPS).to(self.compute_dtype)


def phase_vision_training(dev, card) -> dict:
    """chip_smoke phase 23: `Trainer.fit_arrays` and `TPULearner.fit` over
    the vision and tabular models.  (a) the zoo ConvNet (64 / 128 / 256,
    dense 512, bf16) at its published training configuration (adam 1e-3,
    cosine, batch 128) over 4096 seeded template images, 3 epochs, at
    prefetch_depth -1 and 2, each twice, interleaved: the loss falls and
    the trained bundle scores >= 0.9 of its training images right through
    `TPUModel`; (b) resnet50() bf16 over 224 x 224 uint8 images, batch
    128, momentum 0.9, 8 steps at prefetch -1 and 2: finite losses, every
    batch_stats leaf moved; (c) ResNetDigits at f32 (TF32 turned on
    around it: the Trainer must turn it off), 2 momentum steps on one
    seeded batch, on the card and on the CPU: params and batch_stats
    within 1e-4 of each leaf's max |value|, and a planted fault (torch's
    unbiased running variance) rejected; (d) a ResNetDigits fit preempted
    by the chaos hook and resumed ends bit-equal to the fault-free fit
    when two fault-free fits are bit-equal (cuDNN's deterministic
    algorithms on), else within their spread; (e) `TPULearner.fit` ->
    `TPUModel.transform` on an MLP over 65536 seeded two-class rows of 30
    features: accuracy >= 0.95.  Prints step ms (CUDA events, median of 5
    steady steps), images/s end to end per arm, training FLOPs per image
    (3 x the forward's, from the layer shapes) and the share of the bf16
    peak, peak memory."""
    import os
    import shutil
    import tempfile
    import warnings
    from mmlspark_tpu_torch import (DataTable, ModelBundle, TPULearner,
                                    TPUModel, Trainer, TrainerConfig)
    from mmlspark_tpu_torch.models.definitions import BatchNorm
    from mmlspark_tpu_torch.observe.spans import pipeline_timing
    from mmlspark_tpu_torch.resilience.chaos import (ChaosInjector, Fault,
                                                     set_injector)
    from mmlspark_tpu_torch.resilience.preemption import Preempted
    vt = VISION_TRAIN
    t_phase = time.perf_counter()
    out: dict = {"card": card}

    # (a) the zoo ConvNet
    x, y = template_images(vt["convnet_images"], 10, vt["convnet_noise"], 0)
    cfg = dict(architecture="ConvNetCIFAR10", model_config=dict(CONVNET),
               optimizer="adam", learning_rate=1e-3, lr_schedule="cosine",
               epochs=vt["convnet_epochs"], batch_size=vt["convnet_batch"],
               loss="softmax_xent", seed=0)
    init = ModelBundle.init("ConvNetCIFAR10", CONVNET, seed=0,
                            input_shape=(1, 32, 32, 3))
    b = vt["convnet_batch"]
    # the step alone first: it also pays the first calls' setup before
    # the timed fits
    step_ms, one_step = train_step_ms(
        Trainer(TrainerConfig(**cfg), device=dev), init, x[:b], y[:b], dev)
    arms: dict = {-1: [], 2: []}
    spans: dict = {-1: [], 2: []}
    bundles = []
    for depth in (-1, 2) * vt["convnet_reps"]:
        trainer = Trainer(TrainerConfig(**cfg, prefetch_depth=depth),
                          device=dev)
        with pipeline_timing() as timing:
            bundle, secs = timed_fit(trainer, x, y, initial_bundle=init)
        losses = [r["loss"] for r in trainer.history]
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"phase 23 (a) depth {depth}: epoch losses {losses}")
        arms[depth].append(len(x) * vt["convnet_epochs"] / secs)
        spans[depth].append(fit_spans(timing, trainer))
        bundles.append(bundle)
    model = TPUModel(bundles[-1], device=dev, inputCol="x", outputCol="s",
                     miniBatchSize=1024)
    scores = model.transform(DataTable({"x": x}))["s"]
    accuracy = float((scores.argmax(1) == y).mean())
    require(accuracy >= vt["min_accuracy"],
            f"phase 23 (a): train accuracy {accuracy:.4f} through TPUModel")
    fwd = flops_per_row(model, x[0])
    steady = b / step_ms * 1e3
    same = all(all(np.array_equal(u, v) for u, v in zip(
        bundle_leaves(bundles[0]), bundle_leaves(other)))
        for other in bundles[1:])
    out["convnet"] = {
        "train_accuracy": accuracy, "losses": losses,
        "e2e_images_per_s": {str(k): v for k, v in arms.items()},
        "spans": {str(k): v for k, v in spans.items()},
        "step_ms": step_ms, "steady_images_per_s": steady,
        "train_flops_per_image": 3 * fwd,
        "steady_share_of_bf16_peak": steady * 3 * fwd / PEAK_BF16_FLOPS,
        "fits_bit_equal": same}
    print(f"phase 23 (a) zoo ConvNet, 3 epochs of {len(x)} images at batch "
          f"{b}: train accuracy {accuracy:.4f} through TPUModel, losses "
          f"{[round(v, 4) for v in losses]}; e2e images/s at prefetch -1 "
          f"{[round(v, 1) for v in arms[-1]]}, at 2 "
          f"{[round(v, 1) for v in arms[2]]}; step {step_ms:.3f} ms = "
          f"{steady:.1f} images/s, {3 * fwd / 1e9:.4f} GFLOP/image trained, "
          f"{out['convnet']['steady_share_of_bf16_peak']:.4f} of 989 "
          f"TFLOP/s; the 4 fits bit-equal: {same} [{card}]")
    print(f"  spans (s) per fit, host / transfer / dispatch / stall: "
          f"{describe_spans(spans)} [{card}]")
    del x, y, bundles, model
    torch.cuda.empty_cache()

    # (b) ResNet-50
    rng = np.random.default_rng(1)
    b, side = vt["resnet_batch"], vt["resnet_side"]
    x = rng.integers(0, 256, (vt["resnet_images"], side, side, 3),
                     dtype=np.uint8)
    y = rng.integers(0, RESNET50["num_classes"], len(x)).astype(np.int32)
    cfg = dict(architecture="ResNet", model_config=dict(RESNET50),
               optimizer="momentum", momentum=0.9,
               learning_rate=vt["resnet_lr"], epochs=1, batch_size=b,
               loss="softmax_xent", seed=0)
    init = ModelBundle.init("ResNet", RESNET50, seed=0,
                            input_shape=(1, side, side, 3))
    step_ms, one_step = train_step_ms(
        Trainer(TrainerConfig(**cfg), device=dev), init, x[:b], y[:b], dev)
    del one_step
    r50: dict = {}
    for depth in (-1, 2):
        trainer = Trainer(TrainerConfig(**cfg, prefetch_depth=depth),
                          device=dev)
        torch.cuda.reset_peak_memory_stats()
        with pipeline_timing() as timing:
            bundle, secs = timed_fit(trainer, x, y, initial_bundle=init)
        peak = torch.cuda.max_memory_allocated()
        losses = [r["loss"] for r in trainer.history]
        require(bundle.metadata["steps"] == len(x) // b
                and all(np.isfinite(losses)),
                f"phase 23 (b) depth {depth}: steps "
                f"{bundle.metadata['steps']}, losses {losses}")
        unmoved = sum(np.array_equal(u, v) for u, v in zip(
            tree_leaves(init.variables["batch_stats"]),
            tree_leaves(bundle.variables["batch_stats"])))
        require(unmoved == 0, f"phase 23 (b) depth {depth}: {unmoved} "
                "batch_stats leaves did not move")
        r50[str(depth)] = {"e2e_images_per_s": len(x) / secs,
                           "fit_s": secs, "loss": losses,
                           "peak_allocated_bytes": peak,
                           "spans": fit_spans(timing, trainer)}
    fwd = flops_per_row(TPUModel(bundle, device=dev, inputCol="x"), x[0])
    steady = b / step_ms * 1e3
    out["resnet50"] = {
        "arms": r50,
        "step_ms": step_ms, "steady_images_per_s": steady,
        "train_flops_per_image": 3 * fwd,
        "steady_share_of_bf16_peak": steady * 3 * fwd / PEAK_BF16_FLOPS}
    print(f"phase 23 (b) resnet50 bf16, {len(x) // b} steps of {b} x "
          f"{side} x {side} uint8: e2e images/s "
          + ", ".join(f"prefetch {k} {v['e2e_images_per_s']:.1f} (peak "
                      f"allocated {v['peak_allocated_bytes'] / 2 ** 30:.2f} "
                      f"GiB)" for k, v in r50.items())
          + f"; step {step_ms:.3f} ms = {steady:.1f} images/s, "
          f"{3 * fwd / 1e9:.3f} GFLOP/image trained, "
          f"{out['resnet50']['steady_share_of_bf16_peak']:.4f} of 989 "
          f"TFLOP/s; losses {r50['2']['loss']} [{card}]")
    print(f"  spans (s) per fit, host / transfer / dispatch / stall: "
          + describe_spans({k: [v["spans"]] for k, v in r50.items()})
          + f" [{card}]")
    del x, y, init, bundle
    torch.cuda.empty_cache()

    # (c) the card against the CPU at f32, and the planted fault
    x, y = template_images(vt["digits_batch"], 10, 16.0, 2)
    digits = {**RESNET_DIGITS, "dtype": "float32"}
    cfg = dict(architecture="ResNet", model_config=digits,
               optimizer="momentum", learning_rate=0.05, epochs=2,
               batch_size=vt["digits_batch"], loss="softmax_xent", seed=0)
    init = ModelBundle.init("ResNet", digits, seed=3,
                            input_shape=(1, 32, 32, 3))

    def digits_fit(device, fault=False):
        saved = BatchNorm.forward
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        flags = cudnn.allow_tf32, matmul.allow_tf32
        if fault:
            BatchNorm.forward = lambda self, v: (
                unbiased_batchnorm(self, v) if self.training
                else saved(self, v))
        # TF32 on: the Trainer's f32 step must turn it off
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        try:
            return Trainer(TrainerConfig(**cfg), device=device).fit_arrays(
                x, y, initial_bundle=init)
        finally:
            BatchNorm.forward = saved
            cudnn.allow_tf32, matmul.allow_tf32 = flags

    cpu = digits_fit("cpu")
    tol = vt["card_vs_cpu_tol"]
    gaps = leaf_gaps(digits_fit(dev), cpu)
    fault = leaf_gaps(digits_fit(dev, fault=True), cpu)
    worst = max(gaps, key=gaps.get)
    caught = max(fault, key=fault.get)
    out["card_vs_cpu"] = {"worst_leaf": worst, "worst": gaps[worst],
                          "fault_worst_leaf": caught,
                          "fault_worst": fault[caught], "tol": tol}
    print(f"phase 23 (c) ResNetDigits f32, 2 momentum steps on a batch of "
          f"{len(x)}: card vs CPU worst leaf {worst} at "
          f"{gaps[worst]:.3e} of its max |value| (limit {tol:g}); planted "
          f"unbiased running variance: worst {caught} at "
          f"{fault[caught]:.3e} [{card}]")
    require(gaps[worst] <= tol, f"phase 23 (c): the card's f32 fit is "
            f"{gaps[worst]:.3e} of {worst}'s max from the CPU's")
    require(fault[caught] > tol, "phase 23 (c): the gate passed torch's "
            f"unbiased running variance (worst {fault[caught]:.3e})")

    # (d) resume
    x, y = template_images(vt["resume_images"], 10, 32.0, 4)
    cfg = dict(architecture="ResNet", model_config=dict(RESNET_DIGITS),
               optimizer="adam", learning_rate=2e-3, lr_schedule="cosine",
               epochs=2, batch_size=vt["resume_batch"], loss="softmax_xent",
               seed=1, checkpoint_every_steps=vt["resume_every"])
    init = ModelBundle.init("ResNet", RESNET_DIGITS, seed=1,
                            input_shape=(1, 32, 32, 3))
    root = tempfile.mkdtemp(prefix="chip_smoke_vision_")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with warnings.catch_warnings(record=True) as caught_warnings:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)

            def fit(ckpt, **kw):
                return Trainer(TrainerConfig(**cfg), device=dev).fit_arrays(
                    x, y, initial_bundle=init, ckpt_dir=ckpt, **kw)

            first = fit(os.path.join(root, "a"))
            second = fit(None)
            previous = set_injector(ChaosInjector(
                script=[Fault("sigterm", step=vt["preempt_at"])]))
            preempted = None
            try:
                fit(os.path.join(root, "b"), resume=True)
            except Preempted as e:
                preempted = e.step
            finally:
                set_injector(previous)
            resumed = fit(os.path.join(root, "b"), resume=True)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    nondeterministic = sorted({str(w.message).split("\n")[0]
                               for w in caught_warnings
                               if "deterministic" in str(w.message)})
    spread = max(leaf_gaps(second, first).values())
    gap = max(leaf_gaps(resumed, first).values())
    steps = 2 * vt["resume_images"] // vt["resume_batch"]
    out["resume"] = {"preempted_at": preempted, "steps":
                     resumed.metadata["steps"], "fault_free_spread": spread,
                     "resumed_gap": gap,
                     "nondeterministic_ops": nondeterministic}
    print(f"phase 23 (d) ResNetDigits bf16 resume: preempted after step "
          f"{preempted}, resumed to {resumed.metadata['steps']} steps; "
          f"two fault-free fits differ by {spread:.3e}, the resumed fit by "
          f"{gap:.3e} (of each leaf's max); ops warned nondeterministic: "
          f"{nondeterministic} [{card}]")
    require(preempted == vt["preempt_at"] + 1
            and resumed.metadata["steps"] == steps,
            f"phase 23 (d): preempted at {preempted}, "
            f"{resumed.metadata['steps']} steps")
    require(gap <= spread, f"phase 23 (d): the resumed fit is {gap:.3e} "
            f"from the fault-free one, whose repeat is {spread:.3e}")

    # (e) TPULearner -> TPUModel
    rng = np.random.default_rng(5)
    n, f = vt["learner_rows"], vt["learner_features"]
    feats = rng.standard_normal((n, f), dtype=np.float32)
    labels = (feats @ rng.standard_normal(f) > 0).astype(np.int32)
    table = DataTable({"features": feats, "label": labels})
    learner = TPULearner(TrainerConfig(
        architecture="MLPClassifier",
        model_config={"hidden_sizes": [32], "num_classes": 2},
        optimizer="adam", learning_rate=1e-2, lr_schedule="cosine",
        epochs=vt["learner_epochs"], batch_size=vt["learner_batch"],
        loss="softmax_xent", seed=3), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = learner.fit(table)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    scores = fitted.transform(table)["output"]
    score_s = time.perf_counter() - t0 - fit_s
    accuracy = float((scores.argmax(1) == labels).mean())
    out["learner"] = {"accuracy": accuracy, "fit_s": fit_s,
                      "transform_s": score_s}
    print(f"phase 23 (e) TPULearner MLP [32] over {n} rows x {f}: fit "
          f"{fit_s:.3f} s ({fitted.bundle.metadata['steps']} steps), "
          f"transform {score_s:.3f} s, accuracy {accuracy:.4f} [{card}]")
    require(accuracy >= vt["learner_accuracy"],
            f"phase 23 (e): accuracy {accuracy:.4f}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 23 (vision and tabular training): {out['seconds']:.1f} s "
          f"[{card}]")
    return out


# -- phase 24: the AutoML layer ------------------------------------------

# sizes: the UCI Adult's own train/test split, about two weeks of US
# domestic flights, 25,000 reviews, 8192 images (flights and reviews were
# 500,000 and 100,000 until phase 28 needed the time, 250,000 and 50,000
# until phase 30 did)
AUTOML = dict(census_rows=48842, census_train=32561, flight_rows=125000,
              flight_train=93750, review_rows=25000, review_train=18750,
              staged_rows=2000, cache_images=8192, cache_batch=1024)
# the gates: card predictions equal to the CPU's on this share of the
# test rows; LinearRegression's coefficients within this share of max |w|
# of float64 numpy.linalg.lstsq's; R^2, text accuracy and Word2Vec
# (share of max |v|) card vs CPU
AUTOML_LIMITS = dict(agree=0.999, lr_coef=1e-3, r2=1e-4, text_acc=0.002,
                     w2v=1e-3)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def census_learners(dev) -> dict:
    """Example 101's six families with its settings."""
    from mmlspark_tpu_torch.ml import (DecisionTreeClassifier, GBTClassifier,
                                       LogisticRegression,
                                       MultilayerPerceptronClassifier,
                                       NaiveBayes, RandomForestClassifier)
    return {
        "LogisticRegression": LogisticRegression(device=dev),
        "DecisionTree": DecisionTreeClassifier(maxDepth=5, device=dev),
        "RandomForest": RandomForestClassifier(numTrees=10, maxDepth=5,
                                               device=dev),
        "GBT": GBTClassifier(maxIter=10, maxDepth=4, device=dev),
        "NaiveBayes": NaiveBayes(device=dev),
        "MLP": MultilayerPerceptronClassifier(layers=[-1, 32, -1],
                                              maxIter=40, device=dev),
    }


def fit_scored(trainer, train, test, dev) -> tuple:
    """(model, scored test table, fit s, transform s, metrics row)."""
    from mmlspark_tpu_torch.ml import ComputeModelStatistics
    t0 = time.perf_counter()
    model = trainer.fit(train)
    sync(dev)
    t1 = time.perf_counter()
    scored = model.transform(test)
    sync(dev)
    t2 = time.perf_counter()
    metrics = ComputeModelStatistics().transform(scored)
    return model, scored, t1 - t0, t2 - t1, {
        c: float(metrics[c][0]) for c in metrics.columns}


def automl_census(dev, card) -> dict:
    """(a) TrainClassifier over example 101's families, FindBestModel on
    accuracy and ComputeModelStatistics on the winner, on the card and on
    the CPU; two RandomForest fits on the card bit-equal."""
    from mmlspark_tpu_torch.ml import (ComputeModelStatistics, FindBestModel,
                                       RandomForestClassifier,
                                       TrainClassifier)
    from mmlspark_tpu_torch.utils.demo_data import adult_census_like
    cfg = AUTOML
    data = adult_census_like(n=cfg["census_rows"], seed=0)
    train = data.slice(0, cfg["census_train"])
    test = data.slice(cfg["census_train"], data.num_rows)
    cpu = torch.device("cpu")
    out: dict = {"rows": [train.num_rows, test.num_rows]}
    # the first fits of a process load the card's sort, search and solver
    # kernels: timed apart, on 256 rows, so the family times are steady
    t0 = time.perf_counter()
    for learner in census_learners(dev).values():
        TrainClassifier(learner, labelCol="income").fit(train.slice(0, 256))
    sync(dev)
    out["warmup_s"] = time.perf_counter() - t0
    print(f"phase 24 (a) warm-up: the six families on 256 rows "
          f"{out['warmup_s']:.3f} s [{card}]")
    winners = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        models, rows = {}, {}
        for name, learner in census_learners(d).items():
            model, scored, fit_s, tr_s, m = fit_scored(
                TrainClassifier(learner, labelCol="income"), train, test, d)
            models[name] = (model, scored)
            rows[name] = {"fit_s": fit_s, "transform_s": tr_s,
                          "accuracy": m["accuracy"], "AUC": m.get("AUC")}
        best = FindBestModel([m for m, _ in models.values()],
                             evaluationMetric="accuracy").fit(test)
        winners[where] = next(n for n, (m, _) in models.items()
                              if m is best.best_model)
        result = ComputeModelStatistics().evaluate(best.transform(test))
        out[where] = {"families": rows, "winner": winners[where],
                      "winner_metrics": {c: float(result.metrics[c][0])
                                         for c in result.metrics.columns},
                      "confusion_matrix":
                          np.asarray(result.confusion_matrix).tolist()}
        out[f"_{where}_scored"] = {n: s for n, (_, s) in models.items()}
    card_scored, cpu_scored = out.pop("_card_scored"), out.pop("_cpu_scored")
    agree = {}
    for name in card_scored:
        a = np.asarray(card_scored[name]["scored_labels"])
        b = np.asarray(cpu_scored[name]["scored_labels"])
        agree[name] = float(np.mean(a == b))
        print(f"phase 24 (a) census {name}: card fit "
              f"{out['card']['families'][name]['fit_s']:.3f} s, transform "
              f"{out['card']['families'][name]['transform_s']:.3f} s, "
              f"accuracy {out['card']['families'][name]['accuracy']:.6f}, "
              f"AUC {out['card']['families'][name]['AUC']}, predictions "
              f"equal to the CPU's on {agree[name]:.6f} of "
              f"{len(a)} test rows [{card}]")
        require(agree[name] >= AUTOML_LIMITS["agree"],
                f"phase 24 (a): {name}'s card predictions equal the CPU's "
                f"on {agree[name]:.6f} of the test rows, below "
                f"{AUTOML_LIMITS['agree']}")
    out["agreement"] = agree
    require(winners["card"] == winners["cpu"],
            f"phase 24 (a): FindBestModel picks {winners['card']} on the "
            f"card and {winners['cpu']} on the CPU")
    forests = [TrainClassifier(
        RandomForestClassifier(numTrees=10, maxDepth=5, device=dev),
        labelCol="income").fit(train).fit_model for _ in range(2)]
    trees = [[a for e in f.ensembles for t in e.trees for a in t]
             for f in forests]
    equal = (len(trees[0]) == len(trees[1]) and all(
        x.dtype == y.dtype and np.array_equal(x, y)
        for x, y in zip(*trees)))
    out["forest_repeat_bit_equal"] = equal
    require(equal, "phase 24 (a): two RandomForest fits on the card differ")
    print(f"phase 24 (a) census winner {winners['card']} on both, "
          f"{out['card']['winner_metrics']}; two RandomForest fits on the "
          f"card bit-equal ({len(trees[0])} arrays) [{card}]")
    return out


def automl_flights(dev, card) -> dict:
    """(b) TrainRegressor over example 102's learners on the card and the
    CPU; LinearRegression against float64 numpy.linalg.lstsq, with the
    gels solve and the JAX package's cutoff read beside the limit."""
    from mmlspark_tpu_torch.ml import (GBTRegressor, LinearRegression,
                                       RandomForestRegressor, TrainRegressor)
    from mmlspark_tpu_torch.ml.learners import lstsq_min_norm
    from mmlspark_tpu_torch.utils.demo_data import flight_delays_like
    cfg = AUTOML
    data = flight_delays_like(n=cfg["flight_rows"], seed=1)
    train = data.slice(0, cfg["flight_train"])
    test = data.slice(cfg["flight_train"], data.num_rows)
    cpu = torch.device("cpu")
    out: dict = {"rows": [train.num_rows, test.num_rows]}
    fitted = {}
    for name, make in (
            ("LinearRegression", lambda d: LinearRegression(device=d)),
            ("RandomForest", lambda d: RandomForestRegressor(
                numTrees=10, maxDepth=5, device=d)),
            ("GBT", lambda d: GBTRegressor(maxIter=15, maxDepth=4,
                                           device=d))):
        row = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            model, _, fit_s, tr_s, m = fit_scored(
                TrainRegressor(make(d), labelCol="arr_delay"), train, test,
                d)
            row[where] = {"fit_s": fit_s, "transform_s": tr_s,
                          "r2": m["R^2"], "rmse": m["root_mean_squared_error"]}
            if where == "card":
                fitted[name] = model
        gap = abs(row["card"]["r2"] - row["cpu"]["r2"])
        row["r2_gap"] = gap
        out[name] = row
        print(f"phase 24 (b) flights {name}: card fit "
              f"{row['card']['fit_s']:.3f} s, transform "
              f"{row['card']['transform_s']:.3f} s, R^2 "
              f"{row['card']['r2']:.6f} (CPU {row['cpu']['r2']:.6f}, gap "
              f"{gap:.2e}, limit {AUTOML_LIMITS['r2']}) [{card}]")
        require(gap <= AUTOML_LIMITS["r2"],
                f"phase 24 (b): {name}'s R^2 on the card is {gap:.2e} from "
                f"the CPU's")
    lr = fitted["LinearRegression"]
    featurizer = lr._pipeline.get_stages()[0]
    x = np.asarray(featurizer.transform(train)["features"], np.float32)
    y = np.asarray(train["arr_delay"], np.float32)
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    ref = np.linalg.lstsq(x64 - x64.mean(0), y64 - y64.mean(),
                          rcond=None)[0]
    scale = float(np.abs(ref).max())

    def err(w) -> float:
        return float(np.abs(np.asarray(w, np.float64) - ref).max() / scale)

    xd = torch.as_tensor(x, device=dev)
    yd = torch.as_tensor(y, device=dev)
    xc, yc = xd - xd.mean(0), yd - yd.mean()
    with torch.inference_mode():
        gels = torch.linalg.lstsq(xc, yc[:, None]).solution[:, 0]
        u, s, vt = torch.linalg.svd(xc, full_matrices=False)
        jax_cut = s >= torch.finfo(torch.float32).eps * max(xc.shape) * s[0]
        s_inv = torch.where(jax_cut, 1.0 / s, torch.zeros_like(s))
        jax_rule = vt.T @ (s_inv * (u.T @ yc))
        port_rule = lstsq_min_norm(xc, yc)
    readings = {"fit": err(lr.fit_model.w), "svd_port_rule":
                err(port_rule.cpu().numpy()),
                "gels": err(gels.cpu().numpy()),
                "svd_jax_cutoff": err(jax_rule.cpu().numpy()),
                "jax_cutoff_rank": int(jax_cut.sum()),
                "singular_values": s.cpu().numpy().tolist()}
    out["lr_coefficients"] = readings
    print(f"phase 24 (b) LinearRegression coefficients on {x.shape} "
          f"featurized rows: {readings['fit']:.3e} of max |w| from float64 "
          f"lstsq (limit {AUTOML_LIMITS['lr_coef']}); planted: gels "
          f"{readings['gels']:.3e}, the JAX cutoff eps*max(m,n)*s[0] "
          f"{readings['svd_jax_cutoff']:.3e} (rank "
          f"{readings['jax_cutoff_rank']} of {x.shape[1]}) [{card}]")
    require(readings["fit"] <= AUTOML_LIMITS["lr_coef"],
            f"phase 24 (b): LinearRegression is {readings['fit']:.3e} of "
            f"max |w| from float64 lstsq")
    return out


def automl_text(dev, card) -> dict:
    """(c) example 201's TextFeaturizer (the fused native path counted,
    byte-identical to the staged path), TrainClassifier(LogisticRegression)
    and example 202's Word2Vec, card against CPU."""
    from mmlspark_tpu_torch.core.pipeline import PipelineModel
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.feature import (TextFeaturizer, Tokenizer,
                                            Word2Vec, densify_sparse_column)
    from mmlspark_tpu_torch.feature import text as text_mod
    from mmlspark_tpu_torch.feature.hashing import nonzero_slots
    from mmlspark_tpu_torch.ml import LogisticRegression, TrainClassifier
    from mmlspark_tpu_torch.utils.demo_data import book_reviews_like
    cfg = AUTOML
    cpu = torch.device("cpu")
    data = book_reviews_like(n=cfg["review_rows"], seed=2)
    train = data.slice(0, cfg["review_train"])
    test = data.slice(cfg["review_train"], data.num_rows)
    out: dict = {"rows": [train.num_rows, test.num_rows]}
    t0 = time.perf_counter()
    fz = TextFeaturizer(inputCol="text", outputCol="feats",
                        useStopWordsRemover=True, useIDF=True,
                        numFeatures=1 << 14).fit(train)
    out["featurizer_fit_s"] = time.perf_counter() - t0
    before = dict(text_mod.fused_rows)
    t0 = time.perf_counter()
    feats = {"train": fz.transform(train), "test": fz.transform(test)}
    out["featurizer_transform_s"] = time.perf_counter() - t0
    native = text_mod.fused_rows["native"] - before["native"]
    python = text_mod.fused_rows["python"] - before["python"]
    ascii_rows = sum(all(ord(ch) < 128 for ch in str(t))
                     for t in data["text"])
    out["fused_rows"] = {"native": native, "python": python,
                         "ascii_rows": ascii_rows}
    require(native == ascii_rows and python == data.num_rows - ascii_rows,
            f"phase 24 (c): the fused native path hashed {native} rows and "
            f"the stages {python}, of {ascii_rows} ASCII rows")
    sub = train.slice(0, cfg["staged_rows"])
    fused = fz.transform(sub)["feats"]
    staged = PipelineModel.transform(fz, sub)["feats"]
    same = all(a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
               and a[0].tobytes() == b[0].tobytes()
               and a[1].tobytes() == b[1].tobytes()
               for a, b in zip(fused, staged)) and len(fused) == len(staged)
    require(same, "phase 24 (c): the fused rows differ from the staged "
            "path's")
    slots = nonzero_slots(feats["train"]["feats"])

    def dense(t):
        return DataTable({"rating": t["rating"], "feats":
                          densify_sparse_column(t["feats"], selected=slots)})

    tables = {k: dense(v) for k, v in feats.items()}
    acc = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        _, _, fit_s, tr_s, m = fit_scored(
            TrainClassifier(LogisticRegression(device=d), labelCol="rating"),
            tables["train"], tables["test"], d)
        acc[where] = m["accuracy"]
        out[f"lr_{where}"] = {"fit_s": fit_s, "transform_s": tr_s,
                              "accuracy": m["accuracy"], "AUC": m.get("AUC")}
    gap = abs(acc["card"] - acc["cpu"])
    require(gap <= AUTOML_LIMITS["text_acc"],
            f"phase 24 (c): LogisticRegression accuracy {acc['card']} on the "
            f"card, {acc['cpu']} on the CPU")
    tokens = Tokenizer(inputCol="text", outputCol="tokens").transform(data)
    vecs = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        t0 = time.perf_counter()
        w2v = Word2Vec(inputCol="tokens", outputCol="embedding",
                       vectorSize=32, windowSize=4, minCount=3, maxIter=1,
                       seed=0, device=d).fit(tokens)
        sync(d)
        out[f"word2vec_{where}_s"] = time.perf_counter() - t0
        vecs[where] = w2v.vectors
    w2v_err = float(np.abs(vecs["card"] - vecs["cpu"]).max()
                    / np.abs(vecs["cpu"]).max())
    out["word2vec_err"] = w2v_err
    out["word2vec_vocab"] = int(vecs["card"].shape[0])
    print(f"phase 24 (c) text: {native} rows through the fused native "
          f"path, {python} through the stages, the first "
          f"{cfg['staged_rows']} byte-identical to the staged path; "
          f"{len(slots)} slots; LogisticRegression accuracy "
          f"{acc['card']:.6f} (CPU {acc['cpu']:.6f}); Word2Vec one pass "
          f"{out['word2vec_card_s']:.3f} s on the card "
          f"({out['word2vec_cpu_s']:.3f} s CPU), {w2v_err:.3e} of max |v| "
          f"from the CPU's (limit {AUTOML_LIMITS['w2v']}) [{card}]")
    require(w2v_err <= AUTOML_LIMITS["w2v"],
            f"phase 24 (c): Word2Vec is {w2v_err:.3e} of max |v| from the "
            f"CPU's")
    return out


def automl_checkpoint(dev, card) -> dict:
    """(d) the zoo ConvNet at f32 over a CheckpointData-cached table: scores
    bit-equal to the plain table's, no host->device copy of the column;
    `accuracy_gate` between the f32 and int8 bundles."""
    import tempfile
    from mmlspark_tpu_torch import TPUModel
    from mmlspark_tpu_torch.core.table import DataTable
    from mmlspark_tpu_torch.quant import accuracy_gate, quantize_bundle
    from mmlspark_tpu_torch.stages import CheckpointData
    from mmlspark_tpu_torch.zoo import ModelDownloader, pretrained_repo
    cfg = AUTOML
    with tempfile.TemporaryDirectory() as cache:
        dl = ModelDownloader(cache)
        bundle = dl.load_bundle(dl.download_by_name(pretrained_repo(),
                                                    "ConvNet"))
    images, labels = template_images(cfg["cache_images"], 10, 32.0, 24)
    table = DataTable({"image": images})

    def stage(b, **params):
        return TPUModel(b, device=dev, inputCol="image", outputCol="scores",
                        miniBatchSize=cfg["cache_batch"], **params)

    f32 = stage(bundle, computeDtype="float32")
    f32.transform(table.slice(0, cfg["cache_batch"]))   # build and warm up
    sync(dev)
    t0 = time.perf_counter()
    plain = f32.transform(table)["scores"]
    sync(dev)
    plain_s = time.perf_counter() - t0
    cached_table = CheckpointData(device=dev).transform(table)
    sync(dev)
    put_before = f32._get_feed().put_bytes
    t0 = time.perf_counter()
    cached = f32.transform(cached_table)["scores"]
    sync(dev)
    cached_s = time.perf_counter() - t0
    put = f32._get_feed().put_bytes - put_before
    equal = plain.dtype == cached.dtype and np.array_equal(plain, cached)
    gate = accuracy_gate(f32, stage(quantize_bundle(bundle, "int8")), table,
                         labels)
    out = {"rows": len(images), "plain_s": plain_s, "cached_s": cached_s,
           "bit_equal": bool(equal), "cached_put_bytes": int(put),
           "column_bytes": int(images.nbytes), "accuracy_gate": gate}
    print(f"phase 24 (d) CheckpointData: {len(images)} images through the "
          f"zoo ConvNet at f32, plain {plain_s * 1e3:.2f} ms, cached "
          f"{cached_s * 1e3:.2f} ms, bit-equal {equal}, host->device bytes "
          f"of the cached run {put} (the column: {images.nbytes}); "
          f"accuracy_gate f32 vs int8 {gate} [{card}]")
    require(equal, "phase 24 (d): scores from the cached table differ from "
            "the plain table's")
    require(put == 0, f"phase 24 (d): the cached run put {put} bytes on "
            "the device")
    return out


def phase_automl(dev, card) -> dict:
    """Phase 24: the AutoML layer at the sizes its users run (module
    docstring)."""
    t0 = time.perf_counter()
    out = {"census": automl_census(dev, card)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["flights"] = automl_flights(dev, card)
    out["text"] = automl_text(dev, card)
    out["checkpoint_data"] = automl_checkpoint(dev, card)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 24: {out['seconds']:.1f} s [{card}]")
    return out


# phase 25: the mixture-of-experts LM at LM_CONFIG's width and the
# population sweep on example 101's census
MOE_CONFIG = {**LM_CONFIG, "mlp_impl": "moe", "n_experts": 8,
              "moe_router_k": 2, "moe_group_size": 512}
MOE_AUX = 1e-2
SWEEP_RATES = (1e-3, 3e-3, 1e-2, 3e-2)
SWEEP_RUNGS = 2


def expected_serving_launches(engine, lengths) -> tuple:
    """(K1, K4) launches of one `TextGenerator.transform` over prompts of
    `lengths` with no stop tokens: K1 once a layer for every bucket of
    `_PREFILL_FLASH_MIN` tokens or more, K4 once a layer for every decode
    step of every bucket."""
    from mmlspark_tpu_torch.models.generate import (_PREFILL_FLASH_MIN,
                                                    decode_segments)
    n_layers = engine.weights.n_layers
    buckets = sorted({engine.bucket_for(n) for n in lengths})
    k1 = n_layers * sum(b >= _PREFILL_FLASH_MIN for b in buckets)
    k4 = n_layers * sum(seg for b in buckets for _, seg, _ in decode_segments(
        b, engine.max_new_tokens, engine.chunk))
    return k1, k4


def moe_layer_flops(tokens: int, config: dict) -> int:
    """Forward FLOPs of one MoE layer as it runs: the f32 router product
    over every token and the two expert products over every capacity
    slot (empty slots included: the expert GEMMs run them)."""
    from mmlspark_tpu_torch.ops.moe import _group_size, capacity_of
    d, e = config["d_model"], config["n_experts"]
    h = config.get("mlp_ratio", 4) * d
    gs = _group_size(tokens, config["moe_group_size"])
    slots = e * (tokens // gs) * capacity_of(gs, e, 1.25,
                                             config["moe_router_k"])
    return 2 * tokens * d * e + 2 * 2 * slots * d * h


def moe_serving(dev, card) -> dict:
    """(a) `TextGenerator.transform` over the MoE LM: exact K1 / K4
    counts, f32 prefill logits against the plain forward, f32 greedy
    tokens against the recompute oracle at moe_group_size=1, an int8 PTQ
    bundle with float expert stacks, tokens/s, ms/step and the decode
    overflow fraction."""
    from mmlspark_tpu_torch import DataTable, ModelBundle, TextGenerator
    from mmlspark_tpu_torch.core.bf16 import BF16Array
    from mmlspark_tpu_torch.core.table import object_column
    from mmlspark_tpu_torch.models import generate as gen
    from mmlspark_tpu_torch.quant.quantize import quantize_bundle
    bundle = ModelBundle.init("TransformerLM", MOE_CONFIG, seed=0)
    rng = np.random.default_rng(1)
    rows = [rng.integers(0, MOE_CONFIG["vocab_size"], n).astype(np.int32)
            for n in PROMPT_LENGTHS]
    table = DataTable({"prompt": object_column(rows)})
    n_tokens = len(rows) * MAX_NEW
    out: dict = {}
    arms = (("bf16", bundle), ("int8", quantize_bundle(bundle, "int8")))
    for arm, b in arms:
        if arm == "int8":
            moe = b.variables["params"]["block0_w"]["moe"]
            require(all(isinstance(moe[k], BF16Array) for k in
                         ("w_in", "w_out")) and isinstance(
                moe["router"]["kernel"], BF16Array),
                "phase 25 (a): the int8 PTQ bundle quantized the MoE")
        stage = TextGenerator(b, device=dev, inputCol="prompt",
                              maxNewTokens=MAX_NEW)
        stage.transform(table)                       # warm-up
        engine = stage._engine_for()
        want = expected_serving_launches(engine, PROMPT_LENGTHS)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        gen_out = stage.transform(table)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = read_counts()
        got = (launched["flash_attention"],
               launched["fused_single_query_attention"])
        for r, o in zip(rows, gen_out["generated"]):
            require(len(o) == len(r) + MAX_NEW and np.array_equal(
                o[:len(r)], r) and ((o >= 0) & (o < MOE_CONFIG[
                    "vocab_size"])).all(), f"phase 25 (a) {arm}: a row")
        require(got == want, f"phase 25 (a) {arm}: K1 / K4 launched {got}, "
                f"want {want}")
        steps = want[1] // MOE_CONFIG["n_layers"]
        out[arm] = {"tokens_per_s": n_tokens / seconds, "seconds": seconds,
                    "launches": {"K1": got[0], "K4": got[1]},
                    "decode_steps": steps}
        print(f"phase 25 (a) MoE serving {arm}: {len(rows)} rows x {MAX_NEW} "
              f"tokens in {seconds * 1e3:.1f} ms = "
              f"{n_tokens / seconds:.1f} tokens/s; launches K1 {got[0]} K4 "
              f"{got[1]} (want {want}) [{card}]")
    # ms a decode step and the overflow of the decode steps' routing
    stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                          maxNewTokens=MAX_NEW)
    engine = stage._engine_for()
    long_rows = rows[6:]
    bucket = engine.bucket_for(max(map(len, long_rows)))
    prompts = torch.zeros((len(long_rows), bucket), dtype=torch.long,
                          device=dev)
    for j, r in enumerate(long_rows):
        prompts[j, :len(r)] = torch.from_numpy(r.astype(np.int64))
    tl = torch.tensor([len(r) for r in long_rows], device=dev)
    live = torch.ones(len(long_rows), dtype=torch.bool, device=dev)
    seeds = [0] * len(long_rows)
    steps = 32
    window = -(-(bucket + steps) // engine.chunk) * engine.chunk
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: engine.prefill(prompts, tl, live, seeds),
                             warmup=1, reps=3)
        tok, done, caches = engine.prefill(prompts, tl, live, seeds)
        seg_ms = cuda_ms(lambda: engine.decode_segment(
            steps, window, caches, tok, done, tl, bucket, 0, seeds),
            warmup=1, reps=3)
        overflow = []
        real_apply = gen.moe_apply

        def recording(x, *args, **kw):
            y, sown = real_apply(x, *args, **kw)
            if x.shape[1] == 1:
                overflow.append(sown["metrics"]["moe_overflow_fraction"])
            return y, sown
        gen.moe_apply = recording
        try:
            engine.decode_segment(steps, window, caches, tok, done, tl,
                                  bucket, 0, seeds)
        finally:
            gen.moe_apply = real_apply
        decode_overflow = float(torch.stack(overflow).mean())
    out.update(prefill_ms=prefill_ms, decode_ms_per_step=seg_ms / steps,
               decode_overflow_fraction=decode_overflow)
    print(f"phase 25 (a) MoE bucket {bucket} x {len(long_rows)} rows: "
          f"prefill {prefill_ms:.3f} ms; decode {seg_ms / steps:.3f} "
          f"ms/step; decode routing overflow fraction {decode_overflow:.4f} "
          f"(the step's {len(long_rows)} rows routed as one group) [{card}]")
    del caches
    # f32: the kernel path's prefill logits against the plain forward, and
    # greedy tokens against the recompute oracle in the drop-free regime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = {**MOE_CONFIG, "dtype": "float32"}
    module32 = ModelBundle("TransformerLM", cfg32,
                           bundle.variables).module(dev)
    mid = rows[4:6]
    prompts = torch.zeros((len(mid), 1024), dtype=torch.long, device=dev)
    for j, r in enumerate(mid):
        prompts[j, :len(r)] = torch.from_numpy(r.astype(np.int64))
    shape = (len(mid), 1024 + 128, MOE_CONFIG["n_heads"],
             MOE_CONFIG["d_model"] // MOE_CONFIG["n_heads"])
    caches = [(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
              for _ in range(MOE_CONFIG["n_layers"])]
    with torch.inference_mode():
        kernel_logits = gen._forward_with_cache(gen.ServingWeights(module32),
                                                prompts, caches, 0)
        plain_logits = module32(prompts)
    logit_err = (kernel_logits - plain_logits).abs().max().item()
    print(f"phase 25 (a) f32 MoE prefill logits (bucket 1024) kernel vs "
          f"plain forward: max_abs_err={logit_err:.3e} (tol 1e-3)")
    require(logit_err <= 1e-3, "phase 25 (a): f32 MoE prefill logits")
    del caches, module32, kernel_logits, plain_logits
    cfg1 = {**cfg32, "moe_group_size": 1}
    b1 = ModelBundle("TransformerLM", cfg1, bundle.variables)
    module1 = b1.module(dev)
    gen1 = TextGenerator(b1, device=dev, inputCol="prompt",
                         maxNewTokens=MAX_NEW).transform(table)
    matches = 0
    for r, o in zip(rows, gen1["generated"]):
        ref = gen.naive_generate(module1, r[None], MAX_NEW)[0]
        matches += int((o[len(r):] == ref[len(r):]).sum())
    match = matches / n_tokens
    print(f"phase 25 (a) f32 greedy tokens at moe_group_size=1 vs the "
          f"recompute oracle: {matches}/{n_tokens} = {match:.4f} (gate "
          f">= 0.95)")
    require(match >= 0.95, "phase 25 (a): f32 greedy tokens part from the "
            "recompute oracle in the drop-free regime")
    out.update(prefill_logit_err_f32=logit_err, greedy_match_f32=match)
    del module1
    torch.cuda.empty_cache()
    return out


def moe_train_step(module, x, y):
    """One forward + backward of the MoE objective (NLL + MOE_AUX x the
    sown losses): the bytes allocated when the forward ends (what the
    backward keeps) and the gradients by name."""
    from mmlspark_tpu_torch.train.trainer import make_loss, sown_leaves
    for p in module.parameters():
        p.grad = None
    logits, sown = module(x, collect=True)
    loss = make_loss("softmax_xent")(logits, y, torch.ones(
        x.shape[0], device=x.device)) + MOE_AUX * sum(
        sown_leaves(sown["losses"]))
    held = torch.cuda.memory_allocated()
    loss.backward()
    return held, {n: p.grad for n, p in module.named_parameters()}


def moe_training(dev, card) -> dict:
    """(b) `Trainer.fit_arrays` over the MoE LM at phase 7's shape and (c)
    one step in each remat mode."""
    from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
    from mmlspark_tpu_torch.ops.moe import capacity_of, route
    from mmlspark_tpu_torch.utils.perf import lm_train_flops
    n_layers, vocab = MOE_CONFIG["n_layers"], MOE_CONFIG["vocab_size"]
    rows = char_corpus(TRAIN_ROWS, TRAIN_SEQ, vocab)
    tokens, targets = rows[:, :-1], rows[:, 1:]
    config = {**MOE_CONFIG, "attn_impl": "flash"}
    cfg = TrainerConfig(architecture="TransformerLM", model_config=config,
                        optimizer="adam", learning_rate=3e-4,
                        batch_size=TRAIN_BATCH, epochs=2, seed=0,
                        aux_loss_weight=MOE_AUX)
    trainer = Trainer(cfg, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    bundle = trainer.fit_arrays(tokens, targets)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = read_counts()
    steps = bundle.metadata["steps"]
    losses = [r["loss"] for r in trainer.history]
    overflow = [r.get("moe_overflow_fraction") for r in trainer.history]
    print(f"phase 25 (b) MoE training: {steps} steps of {TRAIN_BATCH}x"
          f"{TRAIN_SEQ} in {seconds:.3f} s; history {trainer.history}; "
          f"launches {launched} [{card}]")
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"phase 25 (b): the loss did not fall: {losses}")
    require(all(o is not None and 0.0 <= o <= 1.0 for o in overflow),
            "phase 25 (b): history lacks moe_overflow_fraction")
    for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
        require(launched[name] == n_layers * steps,
                f"phase 25 (b): {name} launched {launched[name]} times, "
                f"want {n_layers * steps}")
    out: dict = {"steps": steps, "seconds": seconds,
                 "history": trainer.history,
                 "launches": {k: launched[k] for k in (
                     "flash_attention[lse]", "flash_bwd_dq",
                     "flash_bwd_dkv")}}
    # the step alone, and the routing's share of it
    state = trainer.init_state((1, TRAIN_SEQ), total_steps=16,
                               initial_bundle=bundle)
    step = trainer.make_train_step()
    xb = torch.from_numpy(tokens[:TRAIN_BATCH].astype(np.int64)).to(dev)
    yb = torch.from_numpy(targets[:TRAIN_BATCH].astype(np.int64)).to(dev)
    mb = torch.ones(TRAIN_BATCH, device=dev)
    step_ms = cuda_ms(lambda: step(state, xb, yb, mb), warmup=1, reps=5)
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    gs = MOE_CONFIG["moe_group_size"]
    logits = torch.randn((n_tok // gs, gs, MOE_CONFIG["n_experts"]),
                         device=dev)
    cap = capacity_of(gs, MOE_CONFIG["n_experts"], 1.25,
                      MOE_CONFIG["moe_router_k"])
    route_ms = cuda_ms(lambda: route(logits, cap, MOE_CONFIG["moe_router_k"]),
                       warmup=2, reps=10)
    flops = (lm_train_flops(TRAIN_BATCH, TRAIN_SEQ, MOE_CONFIG["d_model"],
                            n_layers, vocab, mlp_ratio=0)["total"]
             + 3 * n_layers * moe_layer_flops(n_tok, MOE_CONFIG))
    out.update(step_ms=step_ms, tokens_per_s=n_tok / step_ms * 1e3,
               flops_per_step=flops, route_ms=route_ms,
               routing_share=n_layers * route_ms / step_ms,
               mfu=flops / (step_ms / 1e3) / PEAK_BF16_FLOPS)
    print(f"phase 25 (b) MoE train step {TRAIN_BATCH}x{TRAIN_SEQ} bf16 flash: "
          f"{step_ms:.3f} ms/step = {n_tok / step_ms * 1e3:.1f} tokens/s; "
          f"{flops / 1e12:.3f} TFLOP/step as run (attention, qkv/proj/head, "
          f"f32 router over every token, the expert GEMMs over every "
          f"capacity slot, x3 for the backward) = {out['mfu']:.4f} of 989 "
          f"TFLOP/s; routing (softmax, top-2, positions) {route_ms:.3f} ms "
          f"a layer's forward = {out['routing_share']:.4f} of the step "
          f"[{card}]")
    del state, trainer
    torch.cuda.empty_cache()
    # (c) one step in each remat mode from the same weights and batch
    grads, peaks, held, counts = {}, {}, {}, {}
    for mode in ("none", "full", "save_attention"):
        mcfg = {**config, "remat": mode != "none",
                "remat_policy": "full" if mode == "none" else mode}
        module = ModelBundle("TransformerLM", mcfg,
                             bundle.variables).module(dev).train()
        moe_train_step(module, xb, yb)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        held[mode], g = moe_train_step(module, xb, yb)
        held[mode] -= base
        torch.cuda.synchronize()
        counts[mode] = read_counts()["flash_attention[lse]"]
        peaks[mode] = torch.cuda.max_memory_allocated() - base
        grads[mode] = {n: t.detach().clone() for n, t in g.items()}
        del module, g
        torch.cuda.empty_cache()
    want = {"none": n_layers, "full": 2 * n_layers,
            "save_attention": n_layers}
    gaps = {}
    for mode in ("full", "save_attention"):
        gaps[mode] = max(((grads[mode][n] - grads["none"][n]).abs().max()
                          / grads["none"][n].abs().max().clamp(min=1e-30)
                          ).item() for n in grads["none"])
    bit_equal = {mode: all(torch.equal(grads[mode][n], grads["none"][n])
                           for n in grads["none"])
                 for mode in ("full", "save_attention")}
    print(f"phase 25 (c) remat none / full / save_attention: K1[lse] "
          f"{counts['none']} / {counts['full']} / "
          f"{counts['save_attention']} a step (want {want}); held for the "
          f"backward when the forward ends {held['none'] / 2 ** 30:.3f} / "
          f"{held['full'] / 2 ** 30:.3f} / "
          f"{held['save_attention'] / 2 ** 30:.3f} GiB; peak allocated "
          f"over the weights {peaks['none'] / 2 ** 30:.3f} / "
          f"{peaks['full'] / 2 ** 30:.3f} / "
          f"{peaks['save_attention'] / 2 ** 30:.3f} GiB (the end of the "
          f"backward, where every gradient exists); gradients vs none: "
          f"max |d|/max |g| {gaps['full']:.3e} / {gaps['save_attention']:.3e}"
          f", bit-equal {bit_equal['full']} / {bit_equal['save_attention']} "
          f"[{card}]")
    require(counts == want, f"phase 25 (c): K1[lse] launches {counts}, "
            f"want {want}")
    require(held["none"] > held["save_attention"] > held["full"],
            f"phase 25 (c): memory held for the backward {held} not none > "
            f"save_attention > full")
    require(max(gaps.values()) <= 1e-5,
            f"phase 25 (c): remat gradients differ by {gaps}")
    out["remat"] = {"k1_lse_launches": counts, "held_bytes": held,
                    "peak_bytes": peaks, "grad_gap": gaps,
                    "bit_equal": bit_equal}
    del grads
    torch.cuda.empty_cache()
    return out


def moe_sweep(dev, card) -> dict:
    """(d) `TrainClassifier(MLP, sweepLearningRates)` on example 101's
    census against 4 serial fits, and a halving population whose culled
    members stay byte-frozen."""
    from mmlspark_tpu_torch.ml import (ComputeModelStatistics,
                                       MultilayerPerceptronClassifier,
                                       TrainClassifier)
    from mmlspark_tpu_torch.train import PopulationTrainer
    from mmlspark_tpu_torch.utils.demo_data import adult_census_like
    data = adult_census_like(n=AUTOML["census_rows"], seed=0)
    train = data.slice(0, AUTOML["census_train"])
    test = data.slice(AUTOML["census_train"], data.num_rows)

    def mlp(rate=SWEEP_RATES[0]):
        return MultilayerPerceptronClassifier(layers=[-1, 32, -1],
                                              maxIter=40, stepSize=rate,
                                              device=dev)

    def accuracy(model) -> float:
        return float(ComputeModelStatistics().evaluate(
            model.transform(test)).metrics["accuracy"][0])

    TrainClassifier(mlp(), labelCol="income",
                    sweepLearningRates=list(SWEEP_RATES[:2])).fit(
        train.slice(0, 256))                      # warm-up
    sync(dev)
    t0 = time.perf_counter()
    swept = TrainClassifier(mlp(), labelCol="income",
                            sweepLearningRates=list(SWEEP_RATES)).fit(train)
    sync(dev)
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = [TrainClassifier(mlp(r), labelCol="income").fit(train)
              for r in SWEEP_RATES]
    sync(dev)
    serial_s = time.perf_counter() - t0
    sm = swept.sweep_metrics
    member_acc = [float(a) for a in sm["accuracy"]]
    winner = int(np.argmax(member_acc))
    serial_acc = [accuracy(m) for m in serial]
    swept_acc = accuracy(swept)
    print(f"phase 25 (d) sweep of {len(SWEEP_RATES)} MLP rates "
          f"{list(SWEEP_RATES)} on {train.num_rows} census rows: "
          f"{sweep_s:.3f} s against {serial_s:.3f} s for the serial fits "
          f"({serial_s / sweep_s:.2f}x); members' train accuracy "
          f"{member_acc}; winner member {winner} (rate "
          f"{SWEEP_RATES[winner]}), test accuracy {swept_acc:.6f}; serial "
          f"fits' test accuracy {serial_acc} [{card}]")
    require(np.isfinite(sm["final_loss"]).all(),
            "phase 25 (d): a member's loss is not finite")
    # halving: the same sweep with SWEEP_RUNGS rungs, the stacked
    # parameters snapshot after every step
    snaps = []
    make_step = PopulationTrainer.make_population_step

    def recording(self):
        step = make_step(self)

        def recorded(state, x, y, mask):
            losses = step(state, x, y, mask)
            snaps.append(([p.clone() for p in state.params],
                          state.active.clone()))
            return losses
        return recorded

    PopulationTrainer.make_population_step = recording
    try:
        halved = TrainClassifier(mlp(), labelCol="income",
                                 sweepLearningRates=list(SWEEP_RATES),
                                 sweepHalvingRungs=SWEEP_RUNGS).fit(train)
    finally:
        PopulationTrainer.make_population_step = make_step
    active = np.asarray(halved.sweep_metrics["active"])
    culled = [k for k in range(len(SWEEP_RATES)) if active[k] == 0]
    require(culled, "phase 25 (d): the halving rungs culled no member")
    final = snaps[-1][0]
    frozen = True
    for k in culled:
        first = next(i for i, (_, act) in enumerate(snaps)
                     if act[k].item() == 0)
        at_cull = snaps[first - 1][0]
        frozen &= all(torch.equal(p[k], q[k]) for s, _ in snaps[first:]
                      for p, q in zip(s, at_cull))
        frozen &= all(torch.equal(p[k], q[k]) for p, q in zip(final,
                                                                 at_cull))
    print(f"phase 25 (d) halving ({SWEEP_RUNGS} rungs, {len(snaps)} steps): "
          f"culled members {culled}, survivors "
          f"{[k for k in range(len(SWEEP_RATES)) if k not in culled]}; "
          f"culled members' tensors byte-unchanged after their rung: "
          f"{frozen} [{card}]")
    require(frozen, "phase 25 (d): a culled member moved after its rung")
    return {"sweep_s": sweep_s, "serial_s": serial_s,
            "member_accuracy": member_acc, "winner": winner,
            "winner_test_accuracy": swept_acc,
            "serial_test_accuracy": serial_acc, "culled": culled,
            "culled_frozen": frozen}


def phase_moe_and_sweep(dev, card) -> dict:
    """Phase 25: the mixture-of-experts LM served and trained at
    LM_CONFIG's width, the remat policies, and the population sweep."""
    out = {"serving": moe_serving(dev, card)}
    out["training"] = moe_training(dev, card)
    out["sweep"] = moe_sweep(dev, card)
    return out


# -- phase 26: the measurement layer ------------------------------------------

R50_CONFIG = {"stage_sizes": [3, 4, 6, 3], "widths": [64, 128, 256, 512],
              "num_classes": 1000, "block_kind": "bottleneck",
              "dtype": "float32"}
# (a) 2 steps of phase 7's shape (1 counted, 1 timed), (b) one batch of
# 256 at 224^2, (c) phase 6's prompts of 4 buckets (32, 128 and the two
# that run K1, 1024 and 1984): the phase's depth, cut to fit the run
MEASURE = {"train_rows": TRAIN_BATCH, "batch": 256, "side": 224,
           "prompts": (20, 70, 600, 1500)}


def measured_rows(rows: dict, card: str) -> None:
    """Print each roofline row of a run with the card line."""
    for key, r in sorted(rows.items()):
        print(f"  {key}: {r['flops']:.6e} FLOPs (kernels "
              f"{r.get('kernel_flops') or 0:.6e}), {r['bytes_accessed']:.6e} "
              f"bytes, {r['executions']} timed execution(s), step "
              f"{r['step_s']} s ({r['step_basis']}), MFU {r['mfu']}, HBM bw "
              f"{r['hbm_bw_util']}, AI {r['arithmetic_intensity']}, "
              f"verdict {r['verdict']}; kernels {r.get('kernel_launches')} "
              f"[{card}]")


def run_clis_at_once(*commands) -> list:
    """Each `python -m <args>` of `commands` from the repo root, all at
    once; their standard outputs, in order.  A nonzero exit fails the
    run."""
    import os
    procs = [subprocess.Popen([sys.executable, "-m", *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
             for args in commands]
    outs = []
    for args, proc in zip(commands, procs):
        out, err = proc.communicate(timeout=300)
        require(proc.returncode == 0, f"python -m {' '.join(args)} exited "
                                      f"{proc.returncode}: {err[-2000:]}")
        outs.append(out)
    return outs


def measure_training(dev, card) -> tuple:
    """(a): the 4-step fit at phase 7's shape; returns the trainer (its
    last state drives (d)), the launches and the seconds."""
    from mmlspark_tpu_torch import Trainer
    rows = char_corpus(MEASURE["train_rows"], TRAIN_SEQ,
                       LM_CONFIG["vocab_size"])
    trainer = Trainer(train_config({**LM_CONFIG, "attn_impl": "flash"}),
                      device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer.fit_arrays(rows[:, :-1], rows[:, 1:])
    torch.cuda.synchronize()
    return trainer, read_counts(), time.perf_counter() - t0


def check_train_row(row: dict, launched: dict, card: str) -> dict:
    from mmlspark_tpu_torch.utils.perf import lm_train_flops
    n_layers = LM_CONFIG["n_layers"]
    ref = lm_train_flops(TRAIN_BATCH, TRAIN_SEQ, LM_CONFIG["d_model"],
                         n_layers, LM_CONFIG["vocab_size"])
    dense = row["flops"] - row["kernel_flops"]
    # the kernel table's formulas: 2·B·H·D a visible pair per product,
    # two products in K1, three in K2, four in K3
    pair = 2 * TRAIN_BATCH * LM_CONFIG["d_model"] * visible_pairs(
        TRAIN_SEQ, TRAIN_SEQ, True)
    per_launch = {"K1[lse]": 2 * pair, "K2": 3 * pair, "K3": 4 * pair}
    want = sum(per_launch[k] * n for k, n in
               row["kernel_launches"].items())
    steps = MEASURE["train_rows"] // TRAIN_BATCH * 2
    print(f"(a) train step {TRAIN_BATCH}x{TRAIN_SEQ}: counted dense "
          f"{dense:.6e} FLOPs against lm_train_flops xla_visible "
          f"{ref['xla_visible']:.6e} ({dense / ref['xla_visible']:.6f}); "
          f"kernels {row['kernel_flops']:.6e} against the formulas "
          f"{want:.6e} over {row['kernel_launches']}; the fit's wrapper "
          f"launches {launched} over {steps} steps [{card}]")
    require(abs(dense / ref["xla_visible"] - 1) <= 0.01,
            "the train step's counted dense FLOPs miss lm_train_flops")
    require(row["kernel_launches"] == {"K1[lse]": n_layers, "K2": n_layers,
                                       "K3": n_layers},
            f"the counted step's kernels: {row['kernel_launches']}")
    require(row["kernel_flops"] == want, "kernel_flops is not the formulas'")
    for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
        require(launched[name] == n_layers * steps,
                f"{name} launched {launched[name]} times in the fit")
    require(row["step_basis"] == "span_wall" and row["executions"] ==
            steps - 1 and row["mfu"] and row["verdict"],
            "the trainer row's MFU is not on the span-wall basis")
    return {"dense_flops": dense, "xla_visible": ref["xla_visible"],
            "kernel_flops": row["kernel_flops"], "mfu": row["mfu"],
            "step_s": row["step_s"], "verdict": row["verdict"],
            "analytic_mfu": ref["total"] / row["step_s"] / PEAK_BF16_FLOPS}


def measure_scoring(dev, card) -> tuple:
    """(b): one batch of 256 through resnet50() at bf16; returns the stage
    and the rows scored."""
    from mmlspark_tpu_torch import DataTable, TPUModel
    from mmlspark_tpu_torch.models import ModelBundle
    n, side = MEASURE["batch"], MEASURE["side"]
    bundle = ModelBundle.init("ResNet", R50_CONFIG, seed=0,
                              input_shape=(1, side, side, 3))
    images = np.random.default_rng(5).integers(0, 256, (n, side, side, 3),
                                               dtype=np.uint8)
    model = TPUModel(bundle, device=dev, inputCol="x", outputCol="y",
                     miniBatchSize=n, computeDtype="bfloat16")
    out = np.asarray(model.transform(DataTable({"x": images}))["y"])
    require(out.shape == (n, R50_CONFIG["num_classes"])
            and np.isfinite(out).all(), "resnet50 scores")
    return model, images


def check_scoring_row(row: dict, model, images, card: str) -> dict:
    from mmlspark_tpu_torch.utils.perf import forward_flops
    n = len(images)
    per_row = row["flops"] / n
    hooked = flops_per_row(model, images[0])
    counted = forward_flops(model.bundle, images.shape, np.uint8)
    print(f"(b) resnet50 bf16 batch {n}: counted {per_row:.6e} FLOPs/row, "
          f"flops_per_row {hooked:.6e} ({per_row / hooked:.6f}), "
          f"forward_flops {counted / n:.6e}; probe step {row['step_s']} s, "
          f"MFU {row['mfu']}, verdict {row['verdict']} [{card}]")
    require(row["step_basis"] == "probe" and row["step_s"] > 0,
            "the tpu_model row has no probe time")
    require(abs(per_row / hooked - 1) <= 0.02 and
            abs(counted / row["flops"] - 1) <= 0.02,
            "ResNet-50's counted FLOPs miss flops_per_row / forward_flops")
    return {"flops_per_row": per_row, "hooked_flops_per_row": hooked,
            "probe_s": row["step_s"], "mfu": row["mfu"],
            "verdict": row["verdict"],
            "images_per_sec": n / row["step_s"]}


def measure_decode(dev, card) -> tuple:
    """(c): the phase-6 prompts through `TextGenerator`, a counted pass
    then a warm one; returns each pass's wrapper launches."""
    from mmlspark_tpu_torch import DataTable, ModelBundle, TextGenerator
    from mmlspark_tpu_torch.core.table import object_column
    bundle = ModelBundle.init("TransformerLM", LM_CONFIG, seed=0)
    rng = np.random.default_rng(1)
    rows = [rng.integers(0, LM_CONFIG["vocab_size"], n).astype(np.int32)
            for n in MEASURE["prompts"]]
    stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                          maxNewTokens=MAX_NEW)
    launches = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_counts()
        stage.transform(DataTable({"prompt": object_column(rows)}))
        torch.cuda.synchronize()
        launches.append(read_counts())
    return launches


def check_decode_rows(rows: dict, launches: list, card: str) -> dict:
    n_layers, d = LM_CONFIG["n_layers"], LM_CONFIG["d_model"]
    h = LM_CONFIG["n_heads"]
    prefills = {k: r for k, r in rows.items()
                if k.startswith("decode:('prefill'")}
    segments = {k: r for k, r in rows.items()
                if k.startswith("decode:('segment'")}
    require(prefills and segments, f"decode rows: {sorted(rows)}")
    k1 = k4 = 0
    for key, r in prefills.items():
        b, p = (int(x) for x in key[:-1].split(", ")[1:])
        got = r["kernel_launches"].get("K1", 0)
        k1 += got
        pairs = p * (p + 1) // 2
        require(got in (0, n_layers) and r["kernel_flops"] ==
                got * 4 * b * h * (d // h) * pairs,
                f"{key}: K1 {got} launches, kernel_flops "
                f"{r['kernel_flops']}")
    for key, r in segments.items():
        b, _, window, seg_len = (int(x) for x in
                                 key[:-1].split(", ")[1:])
        got = r["kernel_launches"].get("K4", 0)
        k4 += got
        require(got == seg_len * n_layers and r["kernel_flops"] ==
                got * 4 * b * window * d,
                f"{key}: K4 {got} launches, kernel_flops "
                f"{r['kernel_flops']}")
    print(f"(c) decode: {len(prefills)} prefill and {len(segments)} segment "
          f"classes; counted K1 {k1}, K4 {k4}; wrapper launches of the "
          f"counted pass {launches[0]} [{card}]")
    # a class counted once covers every later execution of it, so the
    # rows hold at most the counted pass's launches
    require(0 < k1 <= launches[0]["flash_attention"] and
            0 < k4 <= launches[0]["fused_single_query_attention"],
            "the decode rows' kernels are not the pass's launches")
    require(all(r["executions"] >= 1 and r["step_basis"] == "device"
                for r in segments.values()),
            "the warm pass timed no segment on the card")
    return {"prefill_classes": len(prefills),
            "segment_classes": len(segments), "k1": k1, "k4": k4}


def profile_train_step(trainer, dev, card) -> dict:
    """(d): one train step under `profile`; the Chrome trace parsed."""
    import os
    import tempfile
    from mmlspark_tpu_torch import profile
    from mmlspark_tpu_torch.observe import annotate
    rows = char_corpus(TRAIN_BATCH, TRAIN_SEQ, LM_CONFIG["vocab_size"])
    xb = torch.from_numpy(rows[:, :-1].astype(np.int64)).to(dev)
    yb = torch.from_numpy(rows[:, 1:].astype(np.int64)).to(dev)
    mb = torch.ones(TRAIN_BATCH, device=dev)
    step, state = trainer.make_train_step(), trainer._last_state
    torch.cuda.synchronize()
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        with profile(trace_dir) as path:
            with annotate("chip_smoke.train_step"):
                step(state, xb, yb, mb)
            torch.cuda.synchronize()
        size = os.path.getsize(path)
        with open(path) as f:
            names = [str(e.get("name")) for e in json.load(f)["traceEvents"]]
    finally:
        import shutil
        shutil.rmtree(trace_dir, ignore_errors=True)
    found = {key: sum(key in n for n in names)
             for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "chip_smoke.train_step")}
    print(f"(d) profile of one train step: {size} bytes of Chrome trace, "
          f"{len(names)} events; {found} [{card}]")
    require(all(found.values()), f"the trace lacks {found}")
    return {"trace_bytes": size, "events": len(names), "found": found}


def run_clis(run_dir: str, work: str, train: dict, scoring: dict,
             card: str) -> dict:
    """(e): the report over the run directory, then history ingest and
    check --strict over the phase's own bench records (in `work`)."""
    import os
    bench = os.path.join(work, "bench.jsonl")
    with open(bench, "w") as f:
        f.write(json.dumps({"metric": "lm_train_step_8x2048_bf16",
                            "mfu": train["mfu"],
                            "step_ms": train["step_s"] * 1e3}) + "\n")
        f.write(json.dumps({"metric": "resnet50_score_256_bf16",
                            "mfu": scoring["mfu"],
                            "images_per_sec": scoring["images_per_sec"]})
                + "\n")
    store = os.path.join(work, "history.jsonl")
    history = ("mmlspark_tpu_torch.observe.history", bench, "--store",
               store, "--strict", "--format", "json")
    text, ingested = run_clis_at_once(
        ("mmlspark_tpu_torch.observe.report", run_dir),
        (history[0], "ingest") + history[1:])
    (checked,) = run_clis_at_once((history[0], "check") + history[1:])
    section = text[text.index("-- roofline"):].split("\n\n")[0]
    print(section)
    verdicts = {}
    for key in ("trainer:", "tpu_model:"):
        block = section[section.index(f"  {key}"):]
        line = next(x for x in block.splitlines() if "verdict:" in x)
        verdicts[key[:-1]] = line.split("verdict: ")[1]
    require(all(v in ("compute-bound", "bandwidth-bound", "host-bound")
                for v in verdicts.values()),
            f"report verdicts {verdicts}")
    said = [sorted({r["verdict"] for r in json.loads(out[out.index("["):])})
            for out in (ingested, checked)]
    print(f"(e) report verdicts {verdicts}; history ingest {said[0]}, check "
          f"--strict {said[1]} [{card}]")
    require(said == [["new"], ["ok"]], f"history verdicts {said}")
    return {"verdicts": verdicts, "history": said}


def phase_measurement(dev, card) -> dict:
    """Phase 26 (module docstring): (a)-(c) under one `run_telemetry`,
    then (d) and (e)."""
    import shutil
    import tempfile
    from mmlspark_tpu_torch import run_telemetry
    from mmlspark_tpu_torch.utils.perf import (device_peak_flops,
                                               device_peak_hbm_bw)
    peaks = (device_peak_flops(), device_peak_hbm_bw())
    print(f"device peaks {peaks} [{card}]")
    require(peaks == (PEAK_BF16_FLOPS, PEAK_BYTES),
            "utils.perf peaks are not the bounds' peaks")
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_measure_")
    work = tempfile.mkdtemp(prefix="chip_smoke_history_")
    try:
        with run_telemetry(run_dir) as rt:
            trainer, launched, fit_s = measure_training(dev, card)
            model, images = measure_scoring(dev, card)
            decode_launches = measure_decode(dev, card)
        rows = rt.summary()["programs"]
        measured_rows(rows, card)
        train_key = f"trainer:({TRAIN_BATCH}, {TRAIN_SEQ}):int32"
        n, side = MEASURE["batch"], MEASURE["side"]
        score_key = f"tpu_model:({n}, {side}, {side}, 3):uint8"
        require(train_key in rows and score_key in rows,
                f"program rows {sorted(rows)}")
        for row in rows.values():
            require(row["flops"] and row["bytes_accessed"] and
                    row["kernel_flops"] is not None,
                    f"{row['where']}:{row['program']} lacks its costs")
        train = check_train_row(rows[train_key], launched, card)
        train["fit_s"] = fit_s
        scoring = check_scoring_row(rows[score_key], model, images, card)
        decode = check_decode_rows(
            {k: r for k, r in rows.items() if k.startswith("decode:")},
            decode_launches, card)
        profiled = profile_train_step(trainer, dev, card)
        clis = run_clis(run_dir, work, train, scoring, card)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
    return {"train": train, "scoring": scoring, "decode": decode,
            "profile": profiled, "clis": clis}


# -- phase 27: data parallelism over a mesh whose shards share this card ------

# (a) the LM at LM_CONFIG's width, a global batch of 8 x 2048 over data 2
# (4 rows a shard), 4 steps (one a epoch, so the history is per step);
# the f32 check at a depth of f32_layers.  (b) checkpoints of a small
# flash LM, 8 steps, a preemption at step 5.  (c) the zoo ConvNet's
# config and resnet50() bf16, 2 steps of 128 (2 x 64), momentum.  (d)
# resnet50() bf16 scoring, 1024 images at 256.  (e) phase 25's census
# sweep.  (f) one ring-flash step of data 1 x seq 2 at LC_CONFIG's width,
# f32, 2 x 2048.
DP = dict(n=2, steps=4, f32_layers=2, loss_rtol=5e-3, f32_tol=1e-5,
          ckpt_config={"vocab_size": 256, "d_model": 128, "n_heads": 4,
                       "n_layers": 2, "max_len": 256, "dtype": "bfloat16",
                       "attn_impl": "flash"},
          ckpt_rows=32, ckpt_batch=8, ckpt_epochs=2, preempt_at=5,
          vision_images=256, vision_batch=128, vision_lr=0.01,
          weight_tol=1e-1, stats_tol=1e-2,
          score_images=1024, score_batch=256, calibration_rows=32,
          sweep_acc_tol=2e-3, shard_shape=(4, 2048, 8, 128))


def dp_mesh(dev, n: int = DP["n"]):
    """A data-n mesh whose shards all sit on `dev`."""
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec(data=n), [dev] * n)


def named_gaps(got, ref, skip_key_bias: int = 0) -> dict:
    """Each leaf's max |got - ref| over its max |ref| (path -> ratio);
    with `skip_key_bias` = d_model, the key third of each qkv bias left
    out (its true gradient is zero and Adam scales round-off there)."""
    out = {}

    def walk(path, a, b):
        if isinstance(b, dict):
            for key in sorted(b):
                walk(f"{path}/{key}", a[key], b[key])
            return
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if skip_key_bias and path.endswith("qkv/bias"):
            d = skip_key_bias
            a, b = np.delete(a, np.s_[d:2 * d]), np.delete(b, np.s_[d:2 * d])
        out[path] = float(np.abs(a - b).max()
                          / max(float(np.abs(b).max()), 1e-30))
    walk("", got, ref)
    return out


def f32_weight_gaps(got, ref, d_model: int) -> dict:
    """An f32 data-2 fit's parameters against one card's, over the leaves:
    the largest share of a leaf's entries past DP["f32_tol"] of its max
    |w|, the largest |d|, and the largest ||d|| / ||w|| (the key third of
    each qkv bias left out: its true gradient is zero).  Adam scales the
    round-off of a near-zero gradient, which moves with the GEMMs' batch
    shapes on the card, to a step of up to its learning rate, so single
    entries part by up to lr a step; a lost shard's gradient moves most
    entries."""
    out = {"share": 0.0, "share_leaf": None, "max_abs": 0.0,
           "frobenius": 0.0}
    gp, rp = named_leaf_arrays(got), named_leaf_arrays(ref)
    for path, r in rp.items():
        g = gp[path]
        if path.endswith("qkv/bias"):
            g = np.delete(g, np.s_[d_model:2 * d_model])
            r = np.delete(r, np.s_[d_model:2 * d_model])
        diff = np.abs(g - r)
        share = float((diff > DP["f32_tol"] * np.abs(r).max()).mean())
        if out["share_leaf"] is None or share > out["share"]:
            out["share"], out["share_leaf"] = share, path
        out["max_abs"] = max(out["max_abs"], float(diff.max()))
        out["frobenius"] = max(out["frobenius"], float(
            np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)))
    return out


def named_leaf_arrays(tree, prefix: str = "") -> dict:
    """A nested dict's leaves by "/"-joined path, as f64 numpy arrays."""
    out = {}
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.update(named_leaf_arrays(tree[key], f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(tree[key], np.float64)
    return out


def update_gap(got, ref, init) -> float:
    """The data-2 fit's parameter update against the one-card fit's, as
    one relative error over every params leaf: ||got - ref|| over
    ||ref - init|| (Frobenius, f64).  A bf16 step's round-off moves with
    the shards' batch shapes, so a leaf whose true gradient is near zero
    (a BatchNorm bias before another BatchNorm) differs by its whole
    update; this measure weighs each leaf by how far the fit moved it."""
    num = den = 0.0
    for g, r, i in zip(tree_leaves(got["params"]), tree_leaves(ref["params"]),
                       tree_leaves(init["params"])):
        g, r, i = (np.asarray(a, np.float64) for a in (g, r, i))
        num += float(((g - r) ** 2).sum())
        den += float(((r - i) ** 2).sum())
    return (num / max(den, 1e-300)) ** 0.5


def dense_batches(module) -> tuple:
    """Forward hooks on every Dense and LayerNorm of `module` (shard
    replicas share them): (calls, a list of (class, input shape, device)
    the hooks fill, the hook handles)."""
    from mmlspark_tpu_torch.models.definitions import Dense, LayerNorm
    calls: list = []
    handles = [m.register_forward_hook(
        lambda mod, args, out: calls.append(
            (type(mod).__name__, tuple(args[0].shape), args[0].device)))
        for m in module.modules() if isinstance(m, (Dense, LayerNorm))]
    return calls, handles


def dp_shard_kernel_rows(dev, card, launched: dict,
                         shape: tuple = DP["shard_shape"],
                         tag: str = "data 2 shard", phase: int = 27) -> list:
    """K1[lse], K2 and K3 at a path's shard shape (default the data-2
    path's, DP["shard_shape"]) bf16, causal: against their plain versions
    (the phase-3 and phase-4 limits), timed beside the bound and the
    library call; `launched`: each kernel's launches on that path; `tag`
    names the rows, `phase` the failures."""
    from mmlspark_tpu_torch.ops.flash_attention import (
        flash_attention_with_lse, flash_attention_with_lse_plain,
        flash_block_grads_plain, flash_bwd_dkv, flash_bwd_dq)
    b, s, h, d = shape
    gen = torch.Generator(device=dev).manual_seed(27)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    out, lse = flash_attention_with_lse(q, k, v, True)
    torch.cuda.synchronize()
    ref, ref_lse = flash_attention_with_lse_plain(q, k, v, True)
    err, norm_err = out_errs(out, ref)
    lse_err = (lse - ref_lse).abs().max().item()
    print(f"K1[lse] at the {tag} shape {shape} bf16: "
          f"max_abs_err {err:.3e} (tol 2e-2), ||d||/||ref|| {norm_err:.3e} "
          f"(tol 1e-2), lse {lse_err:.3e} (tol 1e-3)")
    require(err <= 2e-2 and norm_err <= 1e-2 and lse_err <= 1e-3,
            f"phase {phase}: K1[lse] disagrees at the shard shape")
    ms = graph_ms(lambda: flash_attention_with_lse(q, k, v, True))
    plain_ms = graph_ms(lambda: flash_attention_with_lse_plain(q, k, v,
                                                               True), calls=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = library_ms(
        lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True), "aten flash forward at the shard shape")
    flops = 4.0 * b * h * d * (s * (s + 1) / 2)
    nbytes = 4.0 * b * s * h * d * 2 + b * s * h * 4
    bound, bound_by, term = attention_bound(flops, nbytes,
                                            b * h * visible_pairs(s, s, True))
    print(f"timing K1[lse] {shape} causal bf16: {ms:.4f} ms; "
          f"plain {plain_ms:.4f} ms; aten flash forward {lib_ms:.4f} ms; "
          f"bound {bound:.4f} ms ({term}); "
          f"{k1_rates(flops, ms, lib_ms, bound)} [{card}]")
    rows = [{"name": f"flash_attention[lse,{tag}]", "route": "cuda",
             "source": "mmlspark_tpu_torch/csrc/flash_attention.cu",
             "replaces": "mmlspark_tpu/ops/flash_attention.py:148",
             "launches": launched["flash_attention[lse]"],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": bound_by, "bound_term": term,
             "library_ms": lib_ms}]
    del q, k, v, out, lse, ref, ref_lse, qt, kt, vt
    args = backward_inputs(gen, b, s, s, True, 0, 0, torch.bfloat16, d, h)
    scale = d ** -0.5
    got = (flash_bwd_dq(*args, True, scale), *flash_bwd_dkv(*args, True,
                                                            scale))
    torch.cuda.synchronize()
    want = flash_block_grads_plain(*args, True, scale)
    errs = [grad_errs(a, r) for a, r in zip(got, want)]
    abs_errs = [(a.float() - r.float()).abs().max().item()
                for a, r in zip(got, want)]
    print(f"K2/K3 at the shard shape: max|d|/max|ref| dq {errs[0][0]:.3e} "
          f"dk {errs[1][0]:.3e} dv {errs[2][0]:.3e} (tol 2e-2); "
          f"||d||/||ref|| dq {errs[0][1]:.3e} dk {errs[1][1]:.3e} dv "
          f"{errs[2][1]:.3e} (tol 1e-2)")
    require(all(m <= 2e-2 and n <= 1e-2 for m, n in errs),
            f"phase {phase}: K2/K3 disagree at the shard shape")
    del got, want
    timed = time_backward(card, gen, d, args=args, shape=(b, s, h))
    for name, err in (("flash_bwd_dq", abs_errs[0]),
                      ("flash_bwd_dkv", max(abs_errs[1:]))):
        rows.append({
            "name": f"{name}[{tag}]", "route": "cuda",
            "source": "mmlspark_tpu_torch/csrc/flash_backward.cu",
            "replaces": ("mmlspark_tpu/ops/flash_attention.py:318"
                         if name == "flash_bwd_dq" else
                         "mmlspark_tpu/ops/flash_attention.py:330"),
            "launches": launched[name], "max_abs_err": err, **timed[name]})
    torch.cuda.empty_cache()
    return rows


def dp_lm(dev, card) -> tuple:
    """(a) The LM at LM_CONFIG's width, flash, bf16: a one-card fit and a
    data-2 fit from one init over one batch of 8 x 2048, 4 steps; the
    per-step losses within DP["loss_rtol"], K1[lse], K2 and K3 exactly
    n_layers x 2 shards x 4 steps each, every Dense call at batch 4; the
    step's ms at both widths; at f32 and DP["f32_layers"] layers the
    weights after 4 steps as `f32_weight_gaps` holds them.
    Returns (the kernel rows at the shard shape, the numbers)."""
    from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
    vocab, n_layers, n = LM_CONFIG["vocab_size"], LM_CONFIG["n_layers"], \
        DP["n"]
    rows = char_corpus(TRAIN_BATCH, TRAIN_SEQ, vocab)
    x, y = rows[:, :-1], rows[:, 1:]

    def config(model_config):
        return TrainerConfig(
            architecture="TransformerLM", model_config=model_config,
            optimizer="adam", learning_rate=3e-4, batch_size=TRAIN_BATCH,
            epochs=DP["steps"], loss="softmax_xent", seed=0,
            numerics_cadence=0)

    model_config = {**LM_CONFIG, "attn_impl": "flash"}
    init = ModelBundle.init("TransformerLM", model_config, seed=0)
    one = Trainer(config(model_config), device=dev)
    one.fit_arrays(x, y, initial_bundle=init)
    dp = Trainer(config(model_config), mesh=dp_mesh(dev))
    calls, handles = dense_batches(dp.module)
    torch.cuda.synchronize()
    reset_counts()
    dp.fit_arrays(x, y, initial_bundle=init)
    torch.cuda.synchronize()
    launched = read_counts()
    for handle in handles:
        handle.remove()
    losses = [[r["loss"] for r in t.history] for t in (one, dp)]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses[1], losses[0])]
    dense = {shape[0] for kind, shape, _ in calls if kind == "Dense"}
    want = n_layers * n * DP["steps"]
    print(f"phase 27 (a) data {n} on one card, {DP['steps']} steps of "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} bf16 flash at LM_CONFIG's width: "
          f"losses {[round(v, 5) for v in losses[1]]} against one card's "
          f"{[round(v, 5) for v in losses[0]]} (max rel gap {max(gaps):.3e}, "
          f"tol {DP['loss_rtol']}); launches {launched} (want {want} each "
          f"of K1[lse], K2, K3); Dense calls "
          f"{sum(k == 'Dense' for k, _, _ in calls)} at batch "
          f"{sorted(dense)} [{card}]")
    require(max(gaps) <= DP["loss_rtol"], "phase 27 (a): the data-2 losses "
            "differ from one card's")
    require(losses[1][-1] < losses[1][0], "phase 27 (a): the loss did not "
            "fall")
    for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
        require(launched[name] == want, f"phase 27 (a): {name} launched "
                f"{launched[name]} times, want {want}")
    require(dense == {TRAIN_BATCH // n}, f"phase 27 (a): Dense calls at "
            f"batch {sorted(dense)}, want {TRAIN_BATCH // n}")
    # the step alone at both widths (CUDA events, median of 5)
    xb = torch.from_numpy(x.astype(np.int64)).to(dev)
    yb = torch.from_numpy(y.astype(np.int64)).to(dev)
    mb = torch.ones(TRAIN_BATCH, device=dev)
    times = {}
    for width, trainer in ((1, one), (n, dp)):
        state = trainer.init_state((1, TRAIN_SEQ), 16, init)
        step = trainer.make_train_step()
        args = ((xb, yb, mb) if width == 1 else
                tuple(list(t.chunk(n)) for t in (xb, yb, mb)))
        times[width] = cuda_ms(lambda: step(state, *args), warmup=1, reps=5)
        del state, step
    print(f"timing train step {TRAIN_BATCH}x{TRAIN_SEQ} bf16 flash: one card "
          f"{times[1]:.3f} ms; data {n} on the same card {times[n]:.3f} ms "
          f"({times[n] / times[1]:.3f}x; CUDA events, median of 5) [{card}]")
    del one, dp
    torch.cuda.empty_cache()
    # f32, TF32 off in the step: the weights after 4 steps
    f32_config = {**model_config, "dtype": "float32",
                  "n_layers": DP["f32_layers"]}
    f32_init = ModelBundle.init("TransformerLM", f32_config, seed=0)
    bundles = [Trainer(config(f32_config), mesh=mesh, device=dev).fit_arrays(
        x, y, initial_bundle=f32_init) for mesh in (None, dp_mesh(dev))]
    f32 = f32_weight_gaps(bundles[1].variables, bundles[0].variables,
                          LM_CONFIG["d_model"])
    print(f"phase 27 (a) f32, {DP['f32_layers']} layers, TF32 off: weights "
          f"after {DP['steps']} steps at data {n} against one card: share "
          f"of a leaf's entries past {DP['f32_tol']} of its max |w| at most "
          f"{f32['share']:.3e} ({f32['share_leaf']}; limit 1e-3), max |d| "
          f"{f32['max_abs']:.3e} (limit {DP['steps'] * 3e-4:.1e}, Adam's "
          f"step), ||d|| / ||w|| at most {f32['frobenius']:.3e} (limit "
          f"{DP['f32_tol']}); the key third of each qkv bias left out "
          f"[{card}]")
    require(f32["share"] <= 1e-3 and f32["max_abs"] <= DP["steps"] * 3e-4
            and f32["frobenius"] <= DP["f32_tol"],
            "phase 27 (a): the f32 weights differ")
    del bundles
    torch.cuda.empty_cache()
    rows = dp_shard_kernel_rows(dev, card, launched)
    return rows, {"losses": losses[1], "one_card_losses": losses[0],
                  "loss_rel_gaps": gaps, "launches": launched,
                  "step_ms": times[n], "one_card_step_ms": times[1],
                  "f32_weights": f32}


def dp_checkpoints(dev, card) -> dict:
    """(b) A data-2 fit's checkpoint records data_devices 2 and restores
    onto one card byte for byte; a data-2 fit preempted at step
    DP["preempt_at"] resumes on one card to the fault-free step count."""
    import os
    import shutil
    import tempfile
    from mmlspark_tpu_torch import Trainer, TrainerConfig, config
    from mmlspark_tpu_torch.resilience.chaos import reset_chaos
    from mmlspark_tpu_torch.resilience.checkpoints import (
        checkpoint_meta, latest_valid_checkpoint)
    from mmlspark_tpu_torch.resilience.ckpt_writer import serialize_tree
    from mmlspark_tpu_torch.resilience.preemption import Preempted
    mc = DP["ckpt_config"]
    rows = char_corpus(DP["ckpt_rows"], mc["max_len"], mc["vocab_size"])
    x, y = rows[:, :-1], rows[:, 1:]
    cfg = TrainerConfig(architecture="TransformerLM", model_config=dict(mc),
                        optimizer="adam", learning_rate=1e-3,
                        batch_size=DP["ckpt_batch"], epochs=DP["ckpt_epochs"],
                        loss="softmax_xent", seed=0, numerics_cadence=0,
                        checkpoint_every_steps=1)
    steps = DP["ckpt_rows"] // DP["ckpt_batch"] * DP["ckpt_epochs"]
    root = tempfile.mkdtemp()
    try:
        saved = os.path.join(root, "saved")
        Trainer(cfg, mesh=dp_mesh(dev)).fit_arrays(x, y, ckpt_dir=saved)
        path = latest_valid_checkpoint(saved)
        meta = checkpoint_meta(path)
        with open(path, "rb") as f:
            raw = f.read()
        one = Trainer(cfg, device=dev)
        state = one.restore_checkpoint(one.init_state((1, mc["max_len"]), 1),
                                       saved)
        same = serialize_tree(one.state_tree(state)) == raw
        resumed_dir = os.path.join(root, "preempted")
        config.set("MMLSPARK_TPU_CHAOS_PREEMPT_AT_STEP", DP["preempt_at"])
        reset_chaos()
        preempted = False
        try:
            Trainer(cfg, mesh=dp_mesh(dev)).fit_arrays(
                x, y, ckpt_dir=resumed_dir)
        except Preempted:
            preempted = True
        finally:
            config.set("MMLSPARK_TPU_CHAOS_PREEMPT_AT_STEP", None)
            reset_chaos()
        resumed = Trainer(cfg, device=dev).fit_arrays(
            x, y, ckpt_dir=resumed_dir, resume=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 27 (b) checkpoints: data 2 writes data_devices "
          f"{meta['data_devices']}, effective batch "
          f"{meta['effective_batch_size']}; restored onto one card byte for "
          f"byte: {same} ({len(raw)} bytes); preempted at step "
          f"{DP['preempt_at']} under data 2: {preempted}; resumed on one "
          f"card to step {resumed.metadata['steps']} (want {steps}) [{card}]")
    require(meta["data_devices"] == 2, "phase 27 (b): data_devices")
    require(same, "phase 27 (b): the restore onto one card is not "
            "byte-identical")
    require(preempted and resumed.metadata["steps"] == steps,
            "phase 27 (b): the preempted data-2 fit did not resume to the "
            "fault-free step count")
    return {"data_devices": meta["data_devices"], "restore_bytes": len(raw),
            "restore_byte_identical": same,
            "resumed_steps": resumed.metadata["steps"]}


def dp_vision(dev, card) -> dict:
    """(c) The zoo ConvNet's config (adam 1e-3, cosine, as phase 23 (a))
    and resnet50() bf16 (momentum 0.01, as phase 23 (b)), 2 steps of 128
    (2 x 64 at data 2) on images scaled to [0, 1), each shard's half of a
    batch at another brightness: the data-2 fit's parameter update
    within DP["weight_tol"] of the one-card fit's (`update_gap`; bf16
    round-off moves with the shards' batch shapes, a shard's gradient
    left out moves it by O(1)) and the ResNet's batch_stats within
    DP["stats_tol"] of each leaf's max; a planted BatchNorm with each
    shard's own statistics must fail the batch_stats gate."""
    from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
    from mmlspark_tpu_torch.models import definitions
    rng = np.random.default_rng(27)
    b, n_img = DP["vision_batch"], DP["vision_images"]
    out: dict = {}
    for name, arch, mc, side, opt in (
            ("convnet", "ConvNetCIFAR10", {**CONVNET, "dtype": "bfloat16"},
             32, dict(optimizer="adam", learning_rate=1e-3,
                      lr_schedule="cosine")),
            ("resnet50", "ResNet", dict(RESNET50), 224,
             dict(optimizer="momentum", momentum=0.9,
                  learning_rate=DP["vision_lr"]))):
        # images scaled to [0, 1), the first half of every batch (shard
        # 0's slab) dimmed to a quarter
        x = (rng.integers(0, 256, (n_img, side, side, 3), dtype=np.uint8)
             / np.float32(255)).astype(np.float32)
        for start in range(0, n_img, b):
            x[start:start + b // 2] *= np.float32(0.25)
        y = rng.integers(0, mc.get("num_classes", 10), n_img).astype(
            np.int32)
        cfg = TrainerConfig(architecture=arch, model_config=mc, epochs=1,
                            batch_size=b, loss="softmax_xent", seed=0,
                            shuffle_each_epoch=False, numerics_cadence=0,
                            **opt)
        init = ModelBundle.init(arch, mc, seed=0,
                                input_shape=(1, side, side, 3))
        one = Trainer(cfg, device=dev).fit_arrays(x, y, initial_bundle=init)
        dp = Trainer(cfg, mesh=dp_mesh(dev)).fit_arrays(x, y,
                                                        initial_bundle=init)
        gap = update_gap(dp.variables, one.variables, init.variables)
        entry = {"update_gap": gap}
        line = (f"phase 27 (c) {name} bf16, 2 steps of {b} at data "
                f"{DP['n']}: the update's relative gap to one card's "
                f"{gap:.3e} (tol {DP['weight_tol']})")
        require(gap <= DP["weight_tol"],
                f"phase 27 (c) {name}: the data-2 weights differ")
        if "batch_stats" in one.variables:
            stats = named_gaps(dp.variables["batch_stats"],
                               one.variables["batch_stats"])
            worst_s = max(stats, key=stats.get)
            real = definitions.active_data_shard
            definitions.active_data_shard = lambda: None
            try:
                planted = Trainer(cfg, mesh=dp_mesh(dev)).fit_arrays(
                    x, y, initial_bundle=init)
            finally:
                definitions.active_data_shard = real
            planted_gaps = named_gaps(planted.variables["batch_stats"],
                                      one.variables["batch_stats"])
            worst_p = max(planted_gaps, key=planted_gaps.get)
            entry.update(worst_stats=worst_s, stats_gap=stats[worst_s],
                         planted_worst=worst_p,
                         planted_gap=planted_gaps[worst_p])
            line += (f"; worst batch_stats leaf {worst_s} "
                     f"{stats[worst_s]:.3e} of its max (tol "
                     f"{DP['stats_tol']}); the planted per-shard "
                     f"statistics: {worst_p} {planted_gaps[worst_p]:.3e}")
            require(stats[worst_s] <= DP["stats_tol"],
                    f"phase 27 (c) {name}: the data-2 batch_stats differ")
            require(planted_gaps[worst_p] > DP["stats_tol"],
                    f"phase 27 (c) {name}: per-shard statistics pass the "
                    "batch_stats gate")
            del planted
        print(line + f" [{card}]")
        out[name] = entry
        del x, one, dp
        torch.cuda.empty_cache()
    return out


def dp_scoring(dev, card) -> dict:
    """(d) resnet50() bf16 through `TPUModel.set_mesh` at data 2 against
    one card, 1024 images at 256, and from a `CheckpointData` cache over
    the same mesh (no host->device bytes): VISION_GATES' bf16 limits
    against the one-card scores."""
    from mmlspark_tpu_torch import DataTable, TPUModel
    from mmlspark_tpu_torch.stages import CheckpointData
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (DP["score_images"], 224, 224, 3),
                          dtype=np.uint8)
    r50 = resnet50_bundle(images[:DP["calibration_rows"]],
                          VISION["resnet_branch_scale"])
    mesh = dp_mesh(dev)

    def stage():
        return TPUModel(r50, device=dev, inputCol="x", outputCol="y",
                        miniBatchSize=DP["score_batch"],
                        computeDtype="bfloat16")

    table = DataTable({"x": images})
    one = stage().transform(table)["y"]
    model = stage().set_mesh(mesh)
    dp = model.transform(table)["y"]
    cached = CheckpointData(device=dev, mesh=mesh).transform(table)
    before = model._get_feed().put_bytes
    from_cache = model.transform(cached)["y"]
    put = model._get_feed().put_bytes - before
    tol = VISION_GATES["resnet50"]["tol"]["bf16"][1]
    out = {}
    for what, got in (("TPUModel.set_mesh", dp),
                      ("CheckpointData over the mesh", from_cache)):
        check_scores(f"phase 27 (d) {what}", got, one.shape)
        readings = arm_readings(got, one, tol)
        ok = (readings["argmax_agreement"] >= AGREE_FLOOR
              and readings["clear_rows"] >= readings["rows"] / 100
              and readings["max_logit_gap"] <= tol
              * readings["max_abs_logit"])
        print(f"phase 27 (d) resnet50 bf16 {what} at data {DP['n']} against "
              f"one card: max logit gap "
              f"{readings['max_logit_gap'] / readings['max_abs_logit']:.3e} "
              f"of max |logit| (limit {tol}), argmax agreement "
              f"{readings['argmax_agreement']:.4f} of "
              f"{readings['clear_rows']} clear rows (floor {AGREE_FLOOR}) "
              f"[{card}]")
        require(ok, f"phase 27 (d): {what} scores differ from one card's")
        out[what] = readings
    print(f"phase 27 (d) the cached column put {put} bytes on the card "
          f"[{card}]")
    require(put == 0, "phase 27 (d): the cached column was copied again")
    return out


def dp_sweep(dev, card) -> dict:
    """(e) Phase 25's census sweep (4 rates, TrainClassifier over the
    MLP) at data 2 against one card: member accuracies within
    DP["sweep_acc_tol"]."""
    from mmlspark_tpu_torch.ml import (MultilayerPerceptronClassifier,
                                       TrainClassifier)
    from mmlspark_tpu_torch.utils.demo_data import adult_census_like
    data = adult_census_like(n=AUTOML["census_rows"], seed=0)
    train = data.slice(0, AUTOML["census_train"])
    sweeps = {}
    for width, mesh in ((1, None), (DP["n"], dp_mesh(dev))):
        mlp = MultilayerPerceptronClassifier(layers=[-1, 32, -1], maxIter=40,
                                             stepSize=SWEEP_RATES[0],
                                             device=dev)
        sync(dev)
        t0 = time.perf_counter()
        sm = TrainClassifier(mlp, labelCol="income",
                             sweepLearningRates=list(SWEEP_RATES),
                             mesh=mesh).fit(train).sweep_metrics
        sync(dev)
        sweeps[width] = ([float(a) for a in sm["accuracy"]],
                         time.perf_counter() - t0)
    gap = max(abs(a - b) for a, b in zip(sweeps[DP["n"]][0], sweeps[1][0]))
    print(f"phase 27 (e) census sweep of {list(SWEEP_RATES)}: member "
          f"accuracy at data {DP['n']} {sweeps[DP['n']][0]} against one "
          f"card's {sweeps[1][0]} (max gap {gap:.2e}, tol "
          f"{DP['sweep_acc_tol']}); {sweeps[DP['n']][1]:.3f} s against "
          f"{sweeps[1][1]:.3f} s [{card}]")
    require(gap <= DP["sweep_acc_tol"], "phase 27 (e): the data-2 sweep's "
            "member accuracies differ")
    return {"member_accuracy": sweeps[DP["n"]][0],
            "one_card_member_accuracy": sweeps[1][0], "max_gap": gap,
            "seconds": sweeps[DP["n"]][1], "one_card_seconds": sweeps[1][1]}


def dp_seq_step(dev, card) -> dict:
    """(f) One step of the seq-parallel ring-flash step, data 1 x seq 2 on
    this card, f32 at LC_CONFIG's width on 2 x RING["grad_seq"] tokens:
    every Dense and LayerNorm call sees (2, S/2, .) on the card, and the
    loss equals phase 20's whole-array forward's within 1e-5."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from mmlspark_tpu_torch.parallel.ring import shard_tokens
    mesh = make_mesh(MeshSpec(data=1, seq=2), [dev] * 2)
    seq = RING["grad_seq"]
    init = ModelBundle.init("TransformerLM", LC_CONFIG, seed=5)
    ref = seq_grads(dev, mesh, LC_CONFIG, init.variables, ("ring_flash",),
                    seq)["ring_flash"][0]
    rows = char_corpus(2, seq, LC_CONFIG["vocab_size"])
    module = ModelBundle("TransformerLM", {
        **LC_CONFIG, "dtype": "float32", "attn_impl": "ring_flash",
        "seq_axis": "seq"}, init.variables).module(dev).train()
    calls, handles = dense_batches(module)
    batch = [shard_tokens(a, mesh) for a in (
        rows[:, :-1].astype(np.int64), rows[:, 1:].astype(np.int64),
        np.ones((2, seq), np.float32))]
    params, opt, step = seq_step(module, mesh)
    _, _, loss = step(params, opt, *batch)
    loss = float(loss)
    for handle in handles:
        handle.remove()
    shapes = {shape[:2] for _, shape, _ in calls}
    devices = {str(d) for _, _, d in calls}
    rel = abs(loss - ref) / abs(ref)
    print(f"phase 27 (f) ring_flash step, data 1 x seq 2, f32 at "
          f"LC_CONFIG's width: {len(calls)} Dense / LayerNorm calls at "
          f"{sorted(shapes)} on {sorted(devices)} (want (2, {seq // 2})); "
          f"loss {loss:.7f} vs the whole-array forward's {ref:.7f} (rel "
          f"{rel:.3e}, tol 1e-5) [{card}]")
    require(shapes == {(2, seq // 2)}, "phase 27 (f): a token-wise layer "
            "saw more than its shard's slab")
    require(rel <= 1e-5, "phase 27 (f): the per-shard step's loss differs")
    del params, opt, step, module
    torch.cuda.empty_cache()
    return {"calls": len(calls), "shapes": sorted(shapes), "loss": loss,
            "whole_array_loss": ref, "loss_rel": rel}


def phase_data_parallel(dev, card) -> tuple:
    """Phase 27: data parallelism over a mesh whose 2 shards share this
    card, through the port's entry points only: (a) `dp_lm`, (b)
    `dp_checkpoints`, (c) `dp_vision`, (d) `dp_scoring`, (e) `dp_sweep`,
    (f) `dp_seq_step`.  Returns (the kernel rows at the data-2 shard
    shape, the numbers)."""
    t0 = time.perf_counter()
    rows, out = dp_lm(dev, card)
    out = {"lm": out}
    for key, fn in (("checkpoints", dp_checkpoints), ("vision", dp_vision),
                    ("scoring", dp_scoring), ("sweep", dp_sweep),
                    ("seq_step", dp_seq_step)):
        t1 = time.perf_counter()
        out[key] = fn(dev, card)
        torch.cuda.empty_cache()
        print(f"phase 27 {key}: {time.perf_counter() - t1:.1f} s [{card}]")
    out["phase_seconds"] = time.perf_counter() - t0
    print(f"phase 27: {out['phase_seconds']:.1f} s [{card}]")
    return rows, out


# -- phase 28: the model axis --------------------------------------------------

# Tensor and expert parallelism over meshes whose shards share this card:
# model 2 splits LM_CONFIG's 8 heads of 128 into 4 a shard.  Limits: the
# bf16 losses and grad norms within loss_rtol of one card's (phase 27's
# data-2 limit); the f32 weights after 4 steps as phase 27 (a) holds them
# (`f32_weight_gaps`); the f32 greedy tokens equal; the bf16 and int8-cache
# rows each agreeing on at least agree_floor of their tokens up to the
# first divergence (`row_agreement`); the MoE losses within moe_rtol and
# its overflow within moe_overflow_tol (bf16 routing: a token near a tie
# between two experts takes the other after one step's round-off, and
# the overflow moves with it; 2.04e-2 at step 2 on the H100, PERF.md
# section 6); one forward's sown values from the same
# weights within moe_sown_rtol; scoring logits within score_tol of max
# |logit|.
MP = dict(m=2, steps=4, f32_layers=2, loss_rtol=5e-3, bf16_rows_floor=0.25,
          int8_rows_floor=0.5, moe_steps=2, moe_rtol=5e-3,
          moe_overflow_tol=5e-2, moe_sown_rtol=1e-2, score_tol=2e-2,
          score_rows=4, score_seq=512, short_lengths=(20, 70, 600, 1200),
          short_new=32, spec_k=3, serve_lengths=(20, 45, 70, 100, 30, 60),
          serve_shared=80, serve_new=64, ep_prompts=4, ep_new=16,
          shard_shape=(8, 2048, 4, 128), prefill_shape=(2, 1024, 4, 128),
          decode_window=1152)


def mp_mesh(dev, data: int = 1, model: int = MP["m"]):
    """A (data, model) mesh whose shards all sit on `dev`."""
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec(data=data, model=model), [dev] * (data * model))


def layer_widths(module, names) -> tuple:
    """Forward hooks on the named layers of `module` (its replicas share
    them): ({name: the set of output widths seen}, the handles)."""
    seen: dict = {name: set() for name in names}
    handles = [module.get_submodule(name).register_forward_hook(
        lambda mod, args, out, name=name: seen[name].add(out.shape[-1]))
        for name in names]
    return seen, handles


def row_agreement(got, ref) -> dict:
    """Rows of generated tokens (prompt + new) against one card's: the
    share of rows equal, and each row's first differing position past
    the prompt (None where equal)."""
    first = []
    for a, b in zip(got, ref):
        a, b = np.asarray(a), np.asarray(b)
        diff = np.nonzero(a != b)[0]
        first.append(int(diff[0]) if diff.size else None)
    return {"rows_equal": sum(f is None for f in first) / len(first),
            "first_divergence": first}


def mp_lm(dev, card) -> tuple:
    """(a) The LM at LM_CONFIG's width, flash, bf16: a one-card fit and a
    (data 1, model 2) fit from one init over one batch of 8 x 2048, 4
    steps; losses and grad norms within MP["loss_rtol"]; K1[lse], K2 and
    K3 exactly n_layers x 2 shards x 4 steps each, on (8, 2048, 4, 128);
    each shard's qkv 1536 columns, mlp_up 2048 and lm_head 4096 (forward
    hooks); the step's ms at both; at f32 and MP["f32_layers"] layers the
    weights after 4 steps; (b) that f32 fit's checkpoint and bundle record
    the topology, and restore onto one card and onto (2, 2) byte for
    byte.  Returns (the kernel rows at the shard shape, the numbers, the
    bf16 bundle)."""
    import tempfile
    import shutil
    from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
    from mmlspark_tpu_torch.models import definitions
    from mmlspark_tpu_torch.resilience.checkpoints import (
        checkpoint_meta, latest_valid_checkpoint)
    vocab, n_layers, m = LM_CONFIG["vocab_size"], LM_CONFIG["n_layers"], \
        MP["m"]
    rows = char_corpus(TRAIN_BATCH, TRAIN_SEQ, vocab)
    x, y = rows[:, :-1], rows[:, 1:]

    def config(model_config, **kw):
        return TrainerConfig(
            architecture="TransformerLM", model_config=model_config,
            optimizer="adam", learning_rate=3e-4, batch_size=TRAIN_BATCH,
            epochs=MP["steps"], loss="softmax_xent", seed=0,
            numerics_cadence=0, **kw)

    model_config = {**LM_CONFIG, "attn_impl": "flash"}
    init = ModelBundle.init("TransformerLM", model_config, seed=0)
    one = Trainer(config(model_config), device=dev)
    one.fit_arrays(x, y, initial_bundle=init)
    tp = Trainer(config(model_config), mesh=mp_mesh(dev))
    widths, handles = layer_widths(tp.module, ("block0_w.qkv",
                                               "block0_w.mlp_up", "lm_head"))
    shapes: set = set()
    real = definitions.flash_attention

    def recording(q, k, v, **kw):
        shapes.add(tuple(q.shape))
        return real(q, k, v, **kw)
    definitions.flash_attention = recording
    torch.cuda.synchronize()
    reset_counts()
    try:
        bundle = tp.fit_arrays(x, y, initial_bundle=init)
        torch.cuda.synchronize()
    finally:
        definitions.flash_attention = real
        for handle in handles:
            handle.remove()
    launched = read_counts()
    losses = [[r["loss"] for r in t.history] for t in (one, tp)]
    norms = [[r["grad_norm"] for r in t.history] for t in (one, tp)]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses[1], losses[0])]
    norm_gaps = [abs(a - b) / abs(b) for a, b in zip(norms[1], norms[0])]
    want = n_layers * m * MP["steps"]
    d, v = LM_CONFIG["d_model"], vocab
    print(f"phase 28 (a) data 1 x model {m} on one card, {MP['steps']} "
          f"steps of {TRAIN_BATCH}x{TRAIN_SEQ} bf16 flash at LM_CONFIG's "
          f"width: losses {[round(t, 5) for t in losses[1]]} against one "
          f"card's {[round(t, 5) for t in losses[0]]} (max rel gap "
          f"{max(gaps):.3e}, tol {MP['loss_rtol']}); grad_norm "
          f"{[round(t, 4) for t in norms[1]]} against "
          f"{[round(t, 4) for t in norms[0]]} (max rel gap "
          f"{max(norm_gaps):.3e}, tol {MP['loss_rtol']}); launches "
          f"{launched} (want {want} each of K1[lse], K2, K3); the flash "
          f"wrapper's q shapes {sorted(shapes)}; layer output widths "
          f"{ {k: sorted(s) for k, s in widths.items()} } [{card}]")
    require(max(gaps) <= MP["loss_rtol"], "phase 28 (a): the model-2 losses "
            "differ from one card's")
    require(max(norm_gaps) <= MP["loss_rtol"], "phase 28 (a): the model-2 "
            "grad_norm differs from one card's")
    require(losses[1][-1] < losses[1][0], "phase 28 (a): the loss did not "
            "fall")
    for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
        require(launched[name] == want, f"phase 28 (a): {name} launched "
                f"{launched[name]} times, want {want}")
    require(shapes == {MP["shard_shape"]}, f"phase 28 (a): the flash "
            f"kernels ran on {sorted(shapes)}, want {MP['shard_shape']}")
    require(widths["block0_w.qkv"] == {3 * d // m}
            and widths["block0_w.mlp_up"] == {4 * d // m}
            and widths["lm_head"] == {v // m, v},
            "phase 28 (a): a shard's layer widths are not its slices")
    require(bundle.metadata["partition"]["mesh"] == {"data": 1, "model": m},
            "phase 28 (a): the bundle's partition mesh")
    xb = torch.from_numpy(x.astype(np.int64)).to(dev)
    yb = torch.from_numpy(y.astype(np.int64)).to(dev)
    mb = torch.ones(TRAIN_BATCH, device=dev)
    times = {}
    for width, trainer in ((1, one), (m, tp)):
        state = trainer.init_state((1, TRAIN_SEQ), 16, init)
        step = trainer.make_train_step()
        args = (xb, yb, mb) if width == 1 else ([xb], [yb], [mb])
        times[width] = cuda_ms(lambda: step(state, *args), warmup=1, reps=5)
        del state, step
    print(f"timing train step {TRAIN_BATCH}x{TRAIN_SEQ} bf16 flash: one card "
          f"{times[1]:.3f} ms; data 1 x model {m} on the same card "
          f"{times[m]:.3f} ms ({times[m] / times[1]:.3f}x; CUDA events, "
          f"median of 5) [{card}]")
    del one, tp
    torch.cuda.empty_cache()
    # f32, TF32 off in the step: the weights after 4 steps; (b) its
    # checkpoint
    f32_config = {**model_config, "dtype": "float32",
                  "n_layers": MP["f32_layers"]}
    f32_init = ModelBundle.init("TransformerLM", f32_config, seed=0)
    work = tempfile.mkdtemp(prefix="phase28_")
    try:
        f32_one = Trainer(config(f32_config), device=dev).fit_arrays(
            x, y, initial_bundle=f32_init)
        f32_tp = Trainer(config(f32_config, checkpoint_every_steps=0),
                         mesh=mp_mesh(dev))
        f32_bundle = f32_tp.fit_arrays(x, y, initial_bundle=f32_init,
                                       ckpt_dir=work)
        f32 = f32_weight_gaps(f32_bundle.variables, f32_one.variables, d)
        print(f"phase 28 (a) f32, {MP['f32_layers']} layers, TF32 off: "
              f"weights after {MP['steps']} steps at model {m} against one "
              f"card: share of a leaf's entries past {DP['f32_tol']} of its "
              f"max |w| at most {f32['share']:.3e} ({f32['share_leaf']}; "
              f"limit 1e-3), max |d| {f32['max_abs']:.3e} (limit "
              f"{MP['steps'] * 3e-4:.1e}, Adam's step), ||d|| / ||w|| at "
              f"most {f32['frobenius']:.3e} (limit {DP['f32_tol']}); the "
              f"key third of each qkv bias left out [{card}]")
        require(f32["share"] <= 1e-3 and f32["max_abs"] <= MP["steps"] * 3e-4
                and f32["frobenius"] <= DP["f32_tol"],
                "phase 28 (a): the f32 weights differ")
        meta = checkpoint_meta(latest_valid_checkpoint(work))
        want_meta = (meta["data_devices"], meta["model_devices"])
        restored = {}
        for label, mesh in (("one card", None),
                            ("data 2 x model 2", mp_mesh(dev, 2, 2))):
            t = Trainer(config(f32_config), mesh=mesh, device=dev)
            state = t.restore_checkpoint(
                t.init_state((1, TRAIN_SEQ), 1, f32_init), work)
            restored[label] = all(
                torch.equal(a, b.to(a.device)) for a, b in
                zip(state.params, f32_tp._last_state.params))
            del t, state
        print(f"phase 28 (b) the f32 model-2 fit's checkpoint records "
              f"(data_devices, model_devices) {want_meta}, its bundle "
              f"{f32_bundle.metadata['partition']['mesh']}; restores "
              f"byte-identical: {restored} [{card}]")
        require(want_meta == (1, m) and f32_bundle.metadata["partition"][
            "mesh"] == {"data": 1, "model": m}, "phase 28 (b): the topology "
            "recorded")
        require(all(restored.values()), "phase 28 (b): a restore differs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del f32_one, f32_tp, f32_bundle
    torch.cuda.empty_cache()
    rows = dp_shard_kernel_rows(dev, card, launched, MP["shard_shape"],
                                "model 2 shard", 28)
    return rows, {"losses": losses[1], "one_card_losses": losses[0],
                  "loss_rel_gaps": gaps, "grad_norms": norms[1],
                  "one_card_grad_norms": norms[0], "launches": launched,
                  "step_ms": times[m], "one_card_step_ms": times[1],
                  "f32_weights": f32, "checkpoint_topology": want_meta,
                  "restores_equal": restored}, bundle


def mp_decode(dev, card) -> tuple:
    """(c) `TextGenerator` over phase 6's prompts at data 1 x model 2: at
    f32 (TF32 off) greedy tokens equal one card's, K1 4 x 2 a prefill of a
    bucket of 512 or more and K4 4 x 2 a decode step; at bf16 and with an
    int8 KV cache (f32 model) each row's agreement with one card's; one
    speculative run with the draft replicated, equal to the plain run.
    Returns (the numbers, the bf16 run's launches)."""
    from mmlspark_tpu_torch import ModelBundle, TextGenerator
    from mmlspark_tpu_torch.core.device import exact_f32
    from mmlspark_tpu_torch.zoo import truncated_draft_bundle
    m, n_layers = MP["m"], LM_CONFIG["n_layers"]
    rows, table = lm_table(PROMPT_LENGTHS)
    short, short_table = lm_table(MP["short_lengths"], seed=2)
    f32_bundle = ModelBundle.init(
        "TransformerLM", {**LM_CONFIG, "dtype": "float32"}, seed=0)
    bf16_bundle = ModelBundle.init("TransformerLM", LM_CONFIG, seed=0)

    def run(bundle, tbl, new, mesh=None, **kw):
        stage = TextGenerator(bundle, device=dev, inputCol="prompt",
                              outputCol="out", maxNewTokens=new, **kw)
        if mesh is not None:
            stage.set_mesh(mesh)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = stage.transform(tbl)["out"]
        torch.cuda.synchronize()
        return stage, list(out), read_counts(), time.perf_counter() - t0

    with exact_f32():
        _, want, _, one_s = run(f32_bundle, table, MAX_NEW)
        stage, got, counts, tp_s = run(f32_bundle, table, MAX_NEW,
                                       mp_mesh(dev))
    k1, k4 = expected_serving_launches(stage._engine_for(), PROMPT_LENGTHS)
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    print(f"phase 28 (c) TextGenerator f32 at data 1 x model {m}, "
          f"{len(rows)} prompts x {MAX_NEW} tokens: greedy tokens equal to "
          f"one card's {same}; K1 {counts['flash_attention']} (want "
          f"{k1 * m} = {k1} x {m}), K4 {counts['fused_single_query_attention']}"
          f" (want {k4 * m} = {k4} x {m}); {tp_s:.2f} s against one card's "
          f"{one_s:.2f} s [{card}]")
    require(same, "phase 28 (c): the f32 model-2 tokens differ")
    require(counts["flash_attention"] == k1 * m
            and counts["fused_single_query_attention"] == k4 * m,
            "phase 28 (c): K1 / K4 not launched once a layer a model shard")
    out = {"f32_equal": same, "f32_launches": counts, "f32_s": tp_s,
           "one_card_f32_s": one_s}
    _, want_bf16, _, _ = run(bf16_bundle, short_table, MP["short_new"])
    stage, got_bf16, bf16_counts, _ = run(bf16_bundle, short_table,
                                          MP["short_new"], mp_mesh(dev))
    k1, k4 = expected_serving_launches(stage._engine_for(),
                                       MP["short_lengths"])
    bf16 = row_agreement(got_bf16, want_bf16)
    require(bf16_counts["flash_attention"] == k1 * m
            and bf16_counts["fused_single_query_attention"] == k4 * m,
            "phase 28 (c): bf16 K1 / K4 launches")
    with exact_f32():
        _, want_int8, _, _ = run(f32_bundle, short_table, MP["short_new"],
                                 kvCacheDtype="int8")
        _, got_int8, _, _ = run(f32_bundle, short_table, MP["short_new"],
                                mp_mesh(dev), kvCacheDtype="int8")
        draft = truncated_draft_bundle(f32_bundle, 1)
        spec_stage = TextGenerator(f32_bundle, device=dev, inputCol="prompt",
                                   outputCol="out",
                                   maxNewTokens=MP["short_new"],
                                   specTokens=MP["spec_k"])
        spec_stage.set_draft_bundle(draft).set_mesh(mp_mesh(dev))
        spec = list(spec_stage.transform(short_table)["out"])
        _, plain, _, _ = run(f32_bundle, short_table, MP["short_new"],
                             mp_mesh(dev))
    int8 = row_agreement(got_int8, want_int8)
    spec_same = all(np.array_equal(a, b) for a, b in zip(spec, plain))
    engine = spec_stage._engine_for()
    print(f"phase 28 (c) bf16 at model {m}, {len(short)} prompts "
          f"{MP['short_lengths']} x {MP['short_new']} tokens: rows equal to "
          f"one card's {bf16['rows_equal']:.3f} (floor "
          f"{MP['bf16_rows_floor']}), first divergence at "
          f"{bf16['first_divergence']} (prompt + new positions; None = "
          f"equal); K1 {bf16_counts['flash_attention']}, K4 "
          f"{bf16_counts['fused_single_query_attention']}; int8 KV cache "
          f"(f32 model) rows equal {int8['rows_equal']:.3f} (floor "
          f"{MP['int8_rows_floor']}), first divergence "
          f"{int8['first_divergence']}; speculative (k {MP['spec_k']}, "
          f"1-layer draft replicated) equal to the plain model-2 run "
          f"{spec_same} over {engine.last_spec_rounds} rounds of the last "
          f"bucket [{card}]")
    require(bf16["rows_equal"] >= MP["bf16_rows_floor"],
            "phase 28 (c): bf16 rows agree below the floor")
    require(int8["rows_equal"] >= MP["int8_rows_floor"],
            "phase 28 (c): int8-cache rows agree below the floor")
    require(spec_same, "phase 28 (c): the speculative tokens differ")
    out.update(bf16=bf16, bf16_launches=bf16_counts, int8=int8,
               speculative_equal=spec_same)
    torch.cuda.empty_cache()
    return out, bf16_counts


def mp_serving(dev, card) -> dict:
    """(d) `ServingEngine` over data 2 x model 2 (four shards on the
    card): MP["serve_lengths"] prompts and two sharing an
    MP["serve_shared"]-token prefix, MP["serve_new"] tokens each at f32;
    tokens equal the one-card engine's; the prefix pool serves a hit."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.core.device import exact_f32
    from mmlspark_tpu_torch.resilience.clock import VirtualClock
    from mmlspark_tpu_torch.serve.engine import ServeConfig, ServingEngine
    bundle = ModelBundle.init("TransformerLM",
                              {**LM_CONFIG, "dtype": "float32"}, seed=0)
    rng = np.random.default_rng(28)
    shared = rng.integers(0, LM_CONFIG["vocab_size"], MP["serve_shared"])
    prompts = [rng.integers(0, LM_CONFIG["vocab_size"], n)
               for n in MP["serve_lengths"]] + [
        np.concatenate([shared, rng.integers(0, LM_CONFIG["vocab_size"], 9)])
        for _ in range(2)]
    results = {}
    for label, mesh in (("one card", None),
                        ("data 2 x model 2", mp_mesh(dev, 2, 2))):
        cfg = ServeConfig(max_new_tokens=MP["serve_new"], max_batch=4,
                          segment_steps=16, cache_chunk=64,
                          prefix_cache=True, warmup_buckets=(128,))
        with exact_f32():
            engine = ServingEngine(bundle, cfg, clock=VirtualClock(),
                                   mesh=mesh, device=dev).warmup()
            t0 = time.perf_counter()
            toks = []
            for p in prompts:
                req = engine.submit(p)
                while not req.finished:
                    engine._tick()
                toks.append(np.asarray(req.tokens))
            torch.cuda.synchronize()
        results[label] = (toks, engine._counts.get("prefix_hits", 0),
                          time.perf_counter() - t0)
        del engine
    same = all(np.array_equal(a, b) for a, b in zip(
        results["data 2 x model 2"][0], results["one card"][0]))
    hits = results["data 2 x model 2"][1]
    print(f"phase 28 (d) ServingEngine f32 over data 2 x model 2 on one "
          f"card, {len(prompts)} requests x {MP['serve_new']} tokens: tokens "
          f"equal to the one-card engine's {same}; prefix-pool hits {hits}; "
          f"{results['data 2 x model 2'][2]:.2f} s against "
          f"{results['one card'][2]:.2f} s [{card}]")
    require(same, "phase 28 (d): the served tokens differ from one card's")
    require(hits >= 1, "phase 28 (d): no prefix-pool hit")
    torch.cuda.empty_cache()
    return {"equal": same, "prefix_hits": hits,
            "seconds": results["data 2 x model 2"][2],
            "one_card_seconds": results["one card"][2]}


def mp_experts(dev, card) -> dict:
    """(e) Phase 25's MoE LM at data 1 x model 2 (4 experts a shard): over
    MP["moe_steps"] steps the losses and the overflow fraction against
    one card's, the sown losses of one forward against one card's; f32
    greedy decode at moe_group_size 1 equal to one card's."""
    from mmlspark_tpu_torch import ModelBundle, Trainer, TrainerConfig
    from mmlspark_tpu_torch.models.generate import DecodeEngine
    from mmlspark_tpu_torch.train.trainer import sown_leaves
    m = MP["m"]
    config = {**MOE_CONFIG, "attn_impl": "flash"}
    rows = char_corpus(TRAIN_BATCH, TRAIN_SEQ, config["vocab_size"])
    x, y = rows[:, :-1], rows[:, 1:]
    init = ModelBundle.init("TransformerLM", config, seed=0)
    cfg = TrainerConfig(architecture="TransformerLM", model_config=config,
                        optimizer="adam", learning_rate=3e-4,
                        batch_size=TRAIN_BATCH, epochs=MP["moe_steps"],
                        seed=0, numerics_cadence=0, aux_loss_weight=MOE_AUX)
    fits = {}
    for width, mesh in ((1, None), (m, mp_mesh(dev))):
        trainer = Trainer(cfg, mesh=mesh, device=dev)
        state = trainer.init_state((1, TRAIN_SEQ), 1, init)
        module = (trainer.module if mesh is None
                  else trainer._replicas.shards[0])
        with torch.no_grad():
            _, sown = module(torch.from_numpy(x[:1].astype(np.int64)).to(dev),
                             collect=True)
        sown = [float(t) for t in sown_leaves(sown["losses"])] + [
            float(t) for t in sown_leaves(sown["metrics"])]
        del state
        trainer.fit_arrays(x, y, initial_bundle=init)
        fits[width] = (trainer.history, sown, dict(trainer.param_splits))
        del trainer
        torch.cuda.empty_cache()
    (h1, s1, _), (h2, s2, splits) = fits[1], fits[m]
    loss_gaps = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                 for a, b in zip(h2, h1)]
    over_gaps = [abs(a["moe_overflow_fraction"] - b["moe_overflow_fraction"])
                 for a, b in zip(h2, h1)]
    sown_gaps = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(s2, s1)]
    print(f"phase 28 (e) MoE LM (8 experts, top 2, groups of 512) at data 1 "
          f"x model {m}: expert stacks split {sorted(splits.items())[:2]}; "
          f"losses {[round(r['loss'], 5) for r in h2]} against "
          f"{[round(r['loss'], 5) for r in h1]} (max rel gap "
          f"{max(loss_gaps):.3e}, tol {MP['moe_rtol']}); overflow "
          f"{[round(r['moe_overflow_fraction'], 5) for r in h2]} against "
          f"{[round(r['moe_overflow_fraction'], 5) for r in h1]} (max gap "
          f"{max(over_gaps):.3e}, tol {MP['moe_overflow_tol']}); one "
          f"forward's sown losses and overflow {[round(t, 6) for t in s2]} "
          f"against {[round(t, 6) for t in s1]} (max rel gap "
          f"{max(sown_gaps):.3e}, tol {MP['moe_sown_rtol']}) [{card}]")
    require(splits.get("block0_w.moe.w_in") == (0, 1),
            "phase 28 (e): the expert stacks are not split by expert")
    require(max(loss_gaps) <= MP["moe_rtol"]
            and max(over_gaps) <= MP["moe_overflow_tol"]
            and max(sown_gaps) <= MP["moe_sown_rtol"],
            "phase 28 (e): the expert-parallel fit differs from one card's")
    f32 = ModelBundle.init("TransformerLM", {
        **MOE_CONFIG, "dtype": "float32", "moe_group_size": 1}, seed=0
    ).module(dev)
    prompts = np.random.default_rng(5).integers(
        0, MOE_CONFIG["vocab_size"], (MP["ep_prompts"], 64))
    true_len = np.array([64, 40, 17, 52][:MP["ep_prompts"]])
    from mmlspark_tpu_torch.core.device import exact_f32
    with exact_f32():
        want = DecodeEngine(f32, MP["ep_new"], device=dev).generate(
            prompts, true_len)
        got = DecodeEngine(f32, MP["ep_new"], device=dev,
                           mesh=mp_mesh(dev)).generate(prompts, true_len)
    same = bool(np.array_equal(got, want))
    print(f"phase 28 (e) f32 MoE greedy decode at moe_group_size 1, model "
          f"{m}: tokens equal to one card's {same} [{card}]")
    require(same, "phase 28 (e): the expert-parallel decode differs")
    torch.cuda.empty_cache()
    return {"losses": [r["loss"] for r in h2],
            "one_card_losses": [r["loss"] for r in h1],
            "overflow": [r["moe_overflow_fraction"] for r in h2],
            "one_card_overflow": [r["moe_overflow_fraction"] for r in h1],
            "sown": s2, "one_card_sown": s1, "decode_equal": same}


def mp_scoring(dev, card, bundle) -> dict:
    """(f) `TPUModel` over (a)'s bf16 bundle at data 1 x model 2 against
    one card (logits within MP["score_tol"] of max |logit|); resnet50()
    bf16 over bench_resnet50's images at data 2 x model 2 (its leaves
    match only the catch-all rule: each data row scores on its home)
    held to VISION_GATES against one card."""
    from mmlspark_tpu_torch import DataTable, TPUModel
    toks = char_corpus(MP["score_rows"], MP["score_seq"],
                       LM_CONFIG["vocab_size"])[:, :-1].astype(np.int32)
    scores = {}
    for label, mesh in (("one card", None), ("model 2", mp_mesh(dev))):
        stage = TPUModel(bundle, device=dev, inputCol="t", outputCol="y",
                         miniBatchSize=MP["score_rows"])
        if mesh is not None:
            stage.set_mesh(mesh)
        scores[label] = stage.transform(DataTable({"t": toks}))["y"]
        del stage
    gap = float(np.abs(scores["model 2"] - scores["one card"]).max()
                / np.abs(scores["one card"]).max())
    agree = float((scores["model 2"].argmax(-1)
                   == scores["one card"].argmax(-1)).mean())
    print(f"phase 28 (f) TPUModel over the LM bundle (bf16) at model "
          f"{MP['m']}, {toks.shape}: logits {scores['model 2'].shape} within "
          f"{gap:.3e} of max |logit| of one card's (limit "
          f"{MP['score_tol']}), argmax agreement {agree:.4f} [{card}]")
    require(scores["model 2"].shape == scores["one card"].shape
            and np.isfinite(scores["model 2"]).all()
            and gap <= MP["score_tol"],
            "phase 28 (f): the model-2 LM scores differ from one card's")
    out = {"lm_gap": gap, "lm_argmax_agreement": agree}
    del scores
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (DP["score_images"], 224, 224, 3),
                          dtype=np.uint8)
    r50 = resnet50_bundle(images[:DP["calibration_rows"]],
                          VISION["resnet_branch_scale"])

    def stage():
        return TPUModel(r50, device=dev, inputCol="x", outputCol="y",
                        miniBatchSize=DP["score_batch"],
                        computeDtype="bfloat16")

    table = DataTable({"x": images})
    one = stage().transform(table)["y"]
    got = stage().set_mesh(mp_mesh(dev, 2, 2)).transform(table)["y"]
    tol = VISION_GATES["resnet50"]["tol"]["bf16"][1]
    check_scores("phase 28 (f) resnet50 over data 2 x model 2", got,
                 one.shape)
    readings = arm_readings(got, one, tol)
    ok = (readings["argmax_agreement"] >= AGREE_FLOOR
          and readings["clear_rows"] >= readings["rows"] / 100
          and readings["max_logit_gap"] <= tol * readings["max_abs_logit"])
    print(f"phase 28 (f) resnet50 bf16 over data 2 x model 2 against one "
          f"card: max logit gap "
          f"{readings['max_logit_gap'] / readings['max_abs_logit']:.3e} of "
          f"max |logit| (limit {tol}), argmax agreement "
          f"{readings['argmax_agreement']:.4f} of {readings['clear_rows']} "
          f"clear rows (floor {AGREE_FLOOR}) [{card}]")
    require(ok, "phase 28 (f): resnet50 scores differ from one card's")
    out["resnet50"] = readings
    torch.cuda.empty_cache()
    return out


def mp_serving_kernel_rows(dev, card, launched: dict) -> list:
    """(g) K1 at the (c) prefill's shard shape MP["prefill_shape"] and K4
    at its first decode window, (2, MP["decode_window"], 4, 128), bf16:
    against their plain versions (phases 2 and 5's limits), timed beside
    the bound and the library call; launches from (c)'s bf16 run."""
    from mmlspark_tpu_torch.ops.decode_attention import (
        fused_single_query_attention, fused_single_query_attention_plain)
    b, s, h, d = MP["prefill_shape"]
    k1 = bf16_k1_rows(dev, card, MP["prefill_shape"], 28)
    row = next(r for r in k1.values() if "lse" not in r["name"])
    row.update(name="flash_attention[model 2 shard]",
               launches=launched["flash_attention"])
    gen = torch.Generator(device=dev).manual_seed(28)
    window, bucket = MP["decode_window"], 1024
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((b, window, h, d), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    true_len = torch.randint(600, bucket + 1, (b,), generator=gen, device=dev)
    visible = engine_mask(b, window, bucket, bucket + 31, true_len)
    got = fused_single_query_attention(q, k, v, visible)
    torch.cuda.synchronize()
    ref = fused_single_query_attention_plain(q, k, v, visible)
    err = (got - ref).abs().max().item()
    print(f"fused_single_query_attention at the model 2 shard shape "
          f"({b}, {window}, {h}, {d}) bf16: max_abs_err={err:.3e} (tol "
          f"2e-3)")
    require(err <= 2e-3, "phase 28 (g): K4 disagrees at the shard shape")

    def call():
        return fused_single_query_attention(q, k, v, visible)
    ms = graph_ms(call)
    plain_ms = graph_ms(lambda: fused_single_query_attention_plain(
        q, k, v, visible))
    mask = visible[:, None, None, :]
    lib_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask))
    n_visible = int(visible.sum().item())
    nbytes = (2.0 * n_visible * h * d * 2 + b * window + q.numel() * 2
              + b * h * d * 4)
    flops = 4.0 * n_visible * h * d
    bound, by, term = attention_bound(flops, nbytes, n_visible * h,
                                      PEAK_F32_FLOPS)
    print(f"timing fused_single_query_attention ({b}, {window}, {h}, {d}) "
          f"bf16, device time (CUDA graph): {ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms; bound {bound:.4f} ms "
          f"({term}), {bound / ms:.3f} of it [{card}]")
    del q, k, v, got, ref
    torch.cuda.empty_cache()
    return [row, {
        "name": "fused_single_query_attention[model 2 shard]",
        "route": "cuda", "source": "mmlspark_tpu_torch/csrc/decode_attention.cu",
        "replaces": "mmlspark_tpu/ops/decode_attention.py:245",
        "launches": launched["fused_single_query_attention"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "bound_term": term,
        "library_ms": lib_ms}]


def phase_model_parallel(dev, card) -> tuple:
    """Phase 28: the model axis over meshes whose shards share this card,
    through the port's entry points only: (a, b) `mp_lm`, (c) `mp_decode`,
    (d) `mp_serving`, (e) `mp_experts`, (f) `mp_scoring`, (g) the kernels
    at the shard shapes (`dp_shard_kernel_rows` at (8, 2048, 4, 128),
    `mp_serving_kernel_rows`).  Returns (the kernel rows, the numbers)."""
    t0 = time.perf_counter()
    rows, lm, bundle = mp_lm(dev, card)
    out = {"lm": lm}
    print(f"phase 28 lm: {time.perf_counter() - t0:.1f} s [{card}]")
    t1 = time.perf_counter()
    out["decode"], launched = mp_decode(dev, card)
    print(f"phase 28 decode: {time.perf_counter() - t1:.1f} s [{card}]")
    for key, fn in (("serving", mp_serving), ("experts", mp_experts)):
        t1 = time.perf_counter()
        out[key] = fn(dev, card)
        torch.cuda.empty_cache()
        print(f"phase 28 {key}: {time.perf_counter() - t1:.1f} s [{card}]")
    t1 = time.perf_counter()
    out["scoring"] = mp_scoring(dev, card, bundle)
    print(f"phase 28 scoring: {time.perf_counter() - t1:.1f} s [{card}]")
    t1 = time.perf_counter()
    rows += mp_serving_kernel_rows(dev, card, launched)
    print(f"phase 28 kernels: {time.perf_counter() - t1:.1f} s [{card}]")
    out["phase_seconds"] = time.perf_counter() - t0
    print(f"phase 28: {out['phase_seconds']:.1f} s [{card}]")
    return rows, out


PP = dict(stages=2, micro=4, steps=4, f32_layers=2, logits_tol=2e-5,
          grad_tol=1e-5, bundle_tol=2e-4, score_rows=2, score_seq=512)
MH = dict(n=2, rows=16, batch=8, epochs=2, score_seq=256, score_batch=4,
          drop=3, timeout_s=420, r50_rows=32, r50_batch=16, r50_side=224)


def pp_mesh(dev, stages: int = PP["stages"]):
    """A (1, stages) mesh whose stages all sit on `dev`."""
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    return make_mesh(MeshSpec(data=1, model=stages), [dev] * stages)


def pp_config(model_config: dict, **kw):
    from mmlspark_tpu_torch import TrainerConfig
    return TrainerConfig(**{**dict(
        architecture="TransformerLM", model_config=model_config,
        optimizer="adam", learning_rate=3e-4, batch_size=TRAIN_BATCH,
        epochs=PP["steps"], loss="softmax_xent", seed=0,
        shuffle_each_epoch=False, pipeline_stages=PP["stages"],
        pipeline_microbatches=PP["micro"]), **kw})


def checkpoint_bytes(ckpt_dir: str) -> bytes:
    from mmlspark_tpu_torch.resilience.checkpoints import (
        latest_valid_checkpoint)
    with open(latest_valid_checkpoint(ckpt_dir), "rb") as f:
        return f.read()


def pp_lm(dev, card) -> dict:
    """(a) The pipelined Trainer at LM_CONFIG's width (dense attention,
    bf16), both stages on this card: 4 steps of 8 x 2048, the losses and
    their fall, the Trainer's own step over two stages against its core
    (`pipeline_train_step` through `make_pipeline_lm_step`) over two
    stages and over one, the stage applications of a forward (M x S), the bubble,
    each stage's block bytes; at f32 and PP["f32_layers"] layers the
    pipelined logits and gradients against `sequential_lm_apply`, a
    checkpoint restored and written again byte for byte, the emitted
    bundle scored through `TPUModel` against the pipelined forward."""
    import shutil
    import tempfile

    from mmlspark_tpu_torch import DataTable, Trainer
    from mmlspark_tpu_torch.core.device import exact_f32
    from mmlspark_tpu_torch.models import TPUModel
    from mmlspark_tpu_torch.parallel import pipeline as pp
    from mmlspark_tpu_torch.train.optim import Optimizer
    rows = char_corpus(TRAIN_BATCH, TRAIN_SEQ, LM_CONFIG["vocab_size"])
    x, y = rows[:, :-1], rows[:, 1:]
    model_config = {**LM_CONFIG, "attn_impl": "dense"}
    mesh = pp_mesh(dev)
    trainer = Trainer(pp_config(model_config), mesh=mesh)
    trainer.fit_arrays(x, y)
    torch.cuda.synchronize()
    losses = [r["loss"] for r in trainer.history]
    blocks = [sum(leaf[s].numel() * leaf[s].element_size()
                  for name, leaf in trainer._pp_params.items()
                  if name.startswith(pp.BLOCKS))
              for s in range(PP["stages"])]
    xb = torch.from_numpy(x.astype(np.int64)).to(dev)
    yb = torch.from_numpy(y.astype(np.int64)).to(dev)
    before = pp._apply_stage.applications
    with torch.no_grad():
        pp.pipelined_lm_apply(mesh, trainer._pp_params, xb,
                              n_heads=LM_CONFIG["n_heads"],
                              n_micro=PP["micro"], dtype=torch.bfloat16)
    applications = pp._apply_stage.applications - before
    bubble = pp.count_pipeline_bubble(PP["micro"], PP["stages"])
    # the step fit_arrays runs: the Trainer's own, at two stages; the
    # same core (`pp.pipeline_train_step`, through make_pipeline_lm_step)
    # at two stages and at one
    state = trainer.init_state((1, TRAIN_SEQ), 16)
    train_step = trainer.make_train_step()
    ones = torch.ones(TRAIN_BATCH, device=dev)
    times = {"trainer": cuda_ms(
        lambda: train_step(state, [xb], [yb], [ones]), warmup=1, reps=3)}
    del trainer, state, train_step
    torch.cuda.empty_cache()
    for stages in (PP["stages"], 1):
        m = pp_mesh(dev, stages)
        params = pp.init_pipelined_lm(0, **{
            k: LM_CONFIG[k] for k in ("vocab_size", "d_model", "n_heads",
                                      "n_layers", "max_len")})
        params = pp.place_pipeline_params(
            params, pp.pipeline_param_shardings(m, params))
        tx = Optimizer(pp_config(model_config), 16)
        opt = tx.init(pp.pipeline_leaves(params))
        step = pp.make_pipeline_lm_step(m, tx, n_heads=LM_CONFIG["n_heads"],
                                        n_micro=PP["micro"],
                                        dtype=torch.bfloat16)
        times[stages] = cuda_ms(lambda: step(params, opt, xb, yb), warmup=1,
                                reps=3)
        del params, opt, step
        torch.cuda.empty_cache()
    print(f"phase 29 (a) pipeline, {PP['stages']} stages on one card, "
          f"{PP['micro']} microbatches, {PP['steps']} steps of "
          f"{TRAIN_BATCH}x{TRAIN_SEQ} bf16 dense at LM_CONFIG's width: "
          f"losses {[round(v, 5) for v in losses]} (fall "
          f"{losses[0] - losses[-1]:.5f}); stage applications a forward "
          f"{applications} (want M x S = {PP['micro'] * PP['stages']}); "
          f"bubble {bubble} (want 0.2); block bytes per stage {blocks} "
          f"[{card}]")
    print(f"timing pipelined train step {TRAIN_BATCH}x{TRAIN_SEQ} bf16 "
          f"dense (CUDA events, median of 3): the Trainer's step at "
          f"{PP['stages']} stages {times['trainer']:.3f} ms; "
          f"pipeline_train_step through make_pipeline_lm_step at "
          f"{PP['stages']} stages {times[PP['stages']]:.3f} ms, at one "
          f"stage {times[1]:.3f} ms (Trainer at {PP['stages']} / core at "
          f"one {times['trainer'] / times[1]:.3f}x) [{card}]")
    require(losses[-1] < losses[0], "phase 29 (a): the loss did not fall")
    require(applications == PP["micro"] * PP["stages"],
            f"phase 29 (a): {applications} stage applications, want "
            f"{PP['micro'] * PP['stages']}")
    require(abs(bubble - 0.2) < 1e-12, "phase 29 (a): the bubble is not 0.2")
    require(blocks[0] == blocks[1] > 0, "phase 29 (a): the stages hold "
            "unequal block bytes")
    # f32, 2 layers, TF32 off
    f32_config = {**model_config, "dtype": "float32",
                  "n_layers": PP["f32_layers"]}
    params = pp.init_pipelined_lm(1, **{
        k: f32_config[k] for k in ("vocab_size", "d_model", "n_heads",
                                   "n_layers", "max_len")})
    placed = pp.place_pipeline_params(
        params, pp.pipeline_param_shardings(mesh, params))
    leaves = pp.pipeline_leaves(placed)
    flat = {n: t.to(dev) for n, t in params.items()}
    for t in leaves + list(flat.values()):
        t.requires_grad_(True)
    heads = LM_CONFIG["n_heads"]
    with exact_f32():
        piped = pp.pipelined_lm_apply(mesh, placed, xb, n_heads=heads,
                                      n_micro=PP["micro"])
        seq = pp.sequential_lm_apply(flat, xb, n_heads=heads)
        logit_gap = (piped - seq).abs().max().item()
        for logits in (piped, seq):
            torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]),
                yb.reshape(-1)).backward()
    grads = pp.joined_leaves(placed, [t.grad for t in leaves])
    grad_gaps = {n: ((grads[n] - flat[n].grad).norm()
                     / flat[n].grad.norm().clamp(min=1e-30)).item()
                 for n in flat}
    worst = max(grad_gaps, key=grad_gaps.get)
    del piped, seq, placed, leaves, flat, grads, params
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp()
    try:
        cfg = pp_config(f32_config, epochs=2)
        t1 = Trainer(cfg, mesh=mesh)
        bundle = t1.fit_arrays(x, y, ckpt_dir=os.path.join(work, "a"))
        t2 = Trainer(cfg, mesh=mesh)
        state = t2.restore_checkpoint(t2.init_state((1, TRAIN_SEQ), 2),
                                      os.path.join(work, "a"))
        t2.save_checkpoint(state, os.path.join(work, "b"), sync=True)
        t2._close_writers()
        same_ckpt = checkpoint_bytes(os.path.join(work, "a")) == \
            checkpoint_bytes(os.path.join(work, "b"))
        toks = x[:PP["score_rows"], :PP["score_seq"]]
        with torch.no_grad(), exact_f32():
            want = pp.pipelined_lm_apply(mesh, t1._pp_params, toks,
                                         n_heads=heads,
                                         n_micro=PP["score_rows"])
        scored = TPUModel(bundle, device=dev, inputCol="tokens",
                          outputCol="logits",
                          miniBatchSize=PP["score_rows"]).transform(
            DataTable({"tokens": toks}))["logits"]
        score_gap = float(np.abs(scored - want.cpu().numpy()).max())
        del t1, t2, state, bundle
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 29 (a) f32, {PP['f32_layers']} layers, TF32 off: "
          f"pipelined logits against sequential_lm_apply max |d| "
          f"{logit_gap:.3e} (tol {PP['logits_tol']}); gradients ||d||/||ref|| "
          f"at most {grad_gaps[worst]:.3e} ({worst}; tol {PP['grad_tol']}); "
          f"checkpoint restored and written again byte-identical "
          f"{same_ckpt}; bundle scored through TPUModel against the "
          f"pipelined forward max |d| {score_gap:.3e} (tol "
          f"{PP['bundle_tol']}) [{card}]")
    require(logit_gap <= PP["logits_tol"], "phase 29 (a): the pipelined "
            "logits differ from the sequential stack's")
    require(grad_gaps[worst] <= PP["grad_tol"], "phase 29 (a): the "
            "pipelined gradients differ from the sequential stack's")
    require(same_ckpt, "phase 29 (a): the restored checkpoint does not "
            "write back byte-identical")
    require(score_gap <= PP["bundle_tol"], "phase 29 (a): the bundle's "
            "scores differ from the pipelined forward")
    return {"losses": losses, "stage_applications": applications,
            "bubble": bubble, "block_bytes": blocks,
            "trainer_step_ms": times["trainer"],
            "step_ms": times[PP["stages"]], "one_stage_step_ms": times[1],
            "f32_logit_gap": logit_gap, "f32_grad_gap": grad_gaps[worst],
            "checkpoint_identical": same_ckpt, "bundle_score_gap": score_gap}


def mh_rows() -> tuple:
    """The two processes' partitions: process p holds rows [8p, 8p + 8)
    of 16 rows of 2048 (inputs, targets)."""
    rows = char_corpus(MH["rows"], TRAIN_SEQ, LM_CONFIG["vocab_size"])
    return rows[:, :-1], rows[:, 1:]


def mh_settings(work: str, save: bool = False) -> None:
    """The parent's LM_CONFIG, TRAIN_SEQ and MH in DIR/settings.json
    (`save`), which each worker reads back, so both sides run one
    configuration."""
    global LM_CONFIG, TRAIN_SEQ, MH, RESNET50
    path = os.path.join(work, "settings.json")
    if save:
        with open(path, "w") as f:
            json.dump({"lm": LM_CONFIG, "seq": TRAIN_SEQ, "mh": MH,
                       "r50": RESNET50}, f)
        return
    with open(path) as f:
        settings = json.load(f)
    LM_CONFIG, TRAIN_SEQ, MH, RESNET50 = settings["lm"], settings["seq"], \
        settings["mh"], settings["r50"]


def mh_config():
    from mmlspark_tpu_torch import TrainerConfig
    return TrainerConfig(
        architecture="TransformerLM",
        model_config={**LM_CONFIG, "attn_impl": "flash"},
        optimizer="adam", learning_rate=3e-4, batch_size=MH["batch"],
        epochs=MH["epochs"], loss="softmax_xent", seed=0,
        shuffle_each_epoch=False, numerics_cadence=0)


def mh_r50_config():
    """ResNet-50 (training BatchNorm) at RESNET50, momentum, one epoch of
    MH["r50_rows"] rows in global batches of MH["r50_batch"]."""
    from mmlspark_tpu_torch import TrainerConfig
    return TrainerConfig(
        architecture="ResNet", model_config=dict(RESNET50),
        optimizer="momentum", learning_rate=0.01, batch_size=MH["r50_batch"],
        epochs=1, loss="softmax_xent", seed=0, shuffle_each_epoch=False,
        numerics_cadence=0)


def mh_r50_rows() -> tuple:
    """ResNet-50's images (uint8) and labels; process p holds rows
    [p n / 2, (p + 1) n / 2)."""
    side = MH["r50_side"]
    rng = np.random.default_rng(29)
    return (rng.integers(0, 256, (MH["r50_rows"], side, side, 3),
                         dtype=np.uint8),
            rng.integers(0, RESNET50["num_classes"], MH["r50_rows"]
                         ).astype(np.int32))


def mh_r50_init():
    from mmlspark_tpu_torch import ModelBundle
    side = MH["r50_side"]
    return ModelBundle.init("ResNet", dict(RESNET50), seed=0,
                            input_shape=(1, side, side, 3))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block (two fits of one
    batch then agree bit for bit; the default may pick atomic ones)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def file_digest(path: str) -> str:
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def tree_digest(trainer, state) -> str:
    """sha256 of a state's checkpoint tree as the writer serializes it."""
    import hashlib

    from mmlspark_tpu_torch.resilience.ckpt_writer import serialize_tree
    return hashlib.sha256(serialize_tree(
        trainer.state_tree(state))).hexdigest()


def mp_worker(rank: int, work: str, device: str = "cuda") -> int:
    """`chip_smoke.py --mp-worker RANK DIR [DEVICE]`: one of phase 29
    (b)'s two processes sharing the card over gloo (the knobs and the
    settings come from the parent).
    Fits its partition, checkpoints (the coordinator only), restores by
    broadcast, scores an uneven partition on both mesh paths, answers the
    health check, times the gloo all-reduce of the gradients' shapes,
    fits ResNet-50 (training BatchNorm) on its partition, and writes its
    numbers to DIR/worker<RANK>.json."""
    from mmlspark_tpu_torch import DataTable, ModelBundle, Trainer
    from mmlspark_tpu_torch.models import TPUModel
    from mmlspark_tpu_torch.models.bundle import save_bundle
    from mmlspark_tpu_torch.ops import native
    from mmlspark_tpu_torch.parallel import distributed as dist
    from mmlspark_tpu_torch.parallel.mesh import MeshSpec, make_process_mesh
    t0 = time.perf_counter()
    mh_settings(work)
    dev = torch.device(device)
    if dev.type == "cuda":
        native.build()     # built by the parent: found, not rebuilt
        dev = torch.device("cuda", 0)
    cfg = dist.DistributedConfig.from_env()
    cfg.backend = "gloo"     # NCCL refuses two ranks on one card
    dist.initialize_distributed(cfg, device=dev)
    require(dist.process_index() == rank, "worker rank mismatch")
    x, y = mh_rows()
    per = MH["rows"] // MH["n"]
    x, y = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    ckpt = os.path.join(work, f"ckpt{rank}")
    trainer = Trainer(mh_config(), device=dev)
    init = ModelBundle.init("TransformerLM", mh_config().model_config, seed=0)
    sync(dev)
    reset_counts()
    bundle = trainer.fit_arrays(x, y, initial_bundle=init, ckpt_dir=ckpt)
    sync(dev)
    launched = read_counts()
    state = trainer._last_state
    trained = tree_digest(trainer, state)
    save_bundle(bundle, os.path.join(work, f"bundle{rank}"))
    # the gloo all-reduce of the gradients' shapes, as the step runs it
    grads = [torch.ones_like(p) for p in state.params]
    reduce_ms = []
    for _ in range(3):
        sync(dev)
        t1 = time.perf_counter()
        dist.all_reduce_sum(grads)
        sync(dev)
        reduce_ms.append((time.perf_counter() - t1) * 1e3)
    del grads
    fresh = trainer.init_state((1, TRAIN_SEQ), 1)
    restored = trainer.restore_checkpoint(fresh, ckpt)
    restored_digest = tree_digest(trainer, restored)
    toks = x[:, :MH["score_seq"]]
    if rank == 0:
        toks = toks[:-MH["drop"]]
    local = TPUModel(bundle, device=dev, inputCol="tokens",
                     outputCol="logits",
                     miniBatchSize=MH["score_batch"]).transform(
        DataTable({"tokens": toks}))["logits"]
    glob = TPUModel(bundle, device=dev, inputCol="tokens",
                    outputCol="logits", miniBatchSize=MH["score_batch"]
                    ).set_mesh(make_process_mesh(MeshSpec(), [dev])
                               ).transform(DataTable({"tokens": toks}))[
        "logits"]
    out = {"rank": rank, "losses": [r["loss"] for r in trainer.history],
           "launches": launched, "trained_digest": trained,
           "restored_digest": restored_digest,
           "restored_step": int(restored.step),
           "score_rows": int(local.shape[0]),
           "score_equal": bool(np.array_equal(local, glob)),
           "health": dist.health_check(timeout_s=120),
           "allreduce_ms": statistics.median(reduce_ms),
           "allreduce_bytes": int(sum(p.numel() * 4 for p in state.params)),
           "mesh": {"process_count": trainer.mesh.process_count,
                    "global_data": trainer.mesh.global_shape["data"]},
           "seconds": time.perf_counter() - t0}
    # ResNet-50 with training BatchNorm: each BatchNorm's sums all-reduced
    # over the processes (forward and backward)
    del trainer, bundle, state, fresh, restored
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rx, ry = mh_r50_rows()
    per = MH["r50_rows"] // MH["n"]
    r50 = Trainer(mh_r50_config(), device=dev)
    with deterministic_cudnn():
        r50_bundle = r50.fit_arrays(rx[rank * per:(rank + 1) * per],
                                    ry[rank * per:(rank + 1) * per],
                                    initial_bundle=mh_r50_init())
    sync(dev)
    save_bundle(r50_bundle, os.path.join(work, f"r50_{rank}"))
    out["r50_losses"] = [r["loss"] for r in r50.history]
    out["r50_steps"] = int(r50_bundle.metadata["steps"])
    out["r50_seconds"] = time.perf_counter() - t1
    dist.barrier("worker.done", timeout_s=120)
    with open(os.path.join(work, f"worker{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown_distributed()
    return 0


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (a process group's rendezvous)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_workers(work: str, dev) -> list:
    """Start phase 29 (b)'s two processes (this script in --mp-worker
    mode), wait for both within MH["timeout_s"], kill what is left, and
    return their numbers."""
    port = free_port()
    procs, logs = [], []
    for rank in range(MH["n"]):
        env = dict(os.environ, MMLSPARK_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   MMLSPARK_TPU_NUM_PROCESSES=str(MH["n"]),
                   MMLSPARK_TPU_PROCESS_ID=str(rank),
                   MMLSPARK_TPU_COLLECTIVE_TIMEOUT_S=str(MH["timeout_s"]))
        logs.append(os.path.join(work, f"worker{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-worker",
                 str(rank), work, dev.type], env=env, stdout=log,
                stderr=subprocess.STDOUT))
    try:
        # both must end in time; one failing ends the wait for the other
        deadline = time.monotonic() + MH["timeout_s"]
        while (time.monotonic() < deadline
               and any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[rank]) as f:
                print(f"phase 29 (b) worker {rank} exited {p.returncode}; "
                      f"its log's tail:\n{f.read()[-3000:]}")
        require(p.returncode == 0, f"phase 29 (b): worker {rank} exited "
                f"{p.returncode}")
    out = []
    for rank in range(MH["n"]):
        with open(os.path.join(work, f"worker{rank}.json")) as f:
            out.append(json.load(f))
    return out


def mh_training(dev, card) -> tuple:
    """(b) Two processes sharing the card over gloo: the LM at LM_CONFIG
    with flash attention, 16 rows of 2048, global batch 8, 4 rows a
    process a step, 4 steps, held against this process's data-2 fit of
    the same global batches (process 0's next 4 rows, then process 1's):
    losses and weights bit-equal (and ResNet-50 with training BatchNorm,
    2 steps of 8 images a process, cuDNN deterministic: losses, weights
    and batch_stats bit-equal), K1[lse] / K2 / K3 16 launches in each
    process, the bundles byte-equal, a checkpoint directory only for
    process 0, process 1's restore equal to process 0's, uneven scoring
    equal on the local and the global mesh, `health_check()` == [0, 1],
    the gloo all-reduce ms.  Returns (the kernel rows at the process
    shard's shape, the numbers)."""
    import shutil
    import tempfile

    from mmlspark_tpu_torch import ModelBundle, Trainer
    from mmlspark_tpu_torch.models.bundle import save_bundle
    work = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        mh_settings(work, save=True)
        workers = run_workers(work, dev)
        workers_s = time.perf_counter() - t0
        x, y = mh_rows()
        per, half = MH["rows"] // MH["n"], MH["batch"] // MH["n"]
        order = np.concatenate([np.r_[p * per + k * half:
                                      p * per + (k + 1) * half]
                                for k in range(per // half)
                                for p in range(MH["n"])])
        ref = Trainer(mh_config(), mesh=dp_mesh(dev, MH["n"]))
        init = ModelBundle.init("TransformerLM", mh_config().model_config,
                                seed=0)
        bundle = ref.fit_arrays(x[order], y[order], initial_bundle=init)
        save_bundle(bundle, os.path.join(work, "bundle_ref"))
        ref_losses = [r["loss"] for r in ref.history]
        digests = [file_digest(os.path.join(work, name, "params.msgpack"))
                   for name in ("bundle0", "bundle1", "bundle_ref")]
        metas = [file_digest(os.path.join(work, name, "bundle.json"))
                 for name in ("bundle0", "bundle1", "bundle_ref")]
        dirs = [os.path.isdir(os.path.join(work, f"ckpt{r}"))
                for r in range(MH["n"])]
        del ref, bundle, init
        torch.cuda.empty_cache()
        # ResNet-50: this process's data-2 fit of the same global batches
        rx, ry = mh_r50_rows()
        rper, rhalf = MH["r50_rows"] // MH["n"], MH["r50_batch"] // MH["n"]
        rorder = np.concatenate([np.r_[p * rper + k * rhalf:
                                       p * rper + (k + 1) * rhalf]
                                 for k in range(rper // rhalf)
                                 for p in range(MH["n"])])
        r50_ref = Trainer(mh_r50_config(), mesh=dp_mesh(dev, MH["n"]))
        with deterministic_cudnn():
            r50_bundle = r50_ref.fit_arrays(rx[rorder], ry[rorder],
                                            initial_bundle=mh_r50_init())
        save_bundle(r50_bundle, os.path.join(work, "r50_ref"))
        r50_ref_losses = [r["loss"] for r in r50_ref.history]
        r50_digests = [file_digest(os.path.join(work, name,
                                                "params.msgpack"))
                       for name in ("r50_0", "r50_1", "r50_ref")]
        del r50_ref, r50_bundle
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    want = LM_CONFIG["n_layers"] * MH["epochs"] * (MH["rows"] // MH["n"]
                                                    // (MH["batch"]
                                                        // MH["n"]))
    w0, w1 = workers
    print(f"phase 29 (b) {MH['n']} processes over gloo sharing the card "
          f"(mesh data {w0['mesh']['global_data']} over "
          f"{w0['mesh']['process_count']} processes), {len(w0['losses'])} "
          f"epochs of {MH['rows'] // MH['n']} rows a process, global batch "
          f"{MH['batch']}, flash at LM_CONFIG's width: losses "
          f"{w0['losses']} / {w1['losses']} against the one-process data-"
          f"{MH['n']} fit's {ref_losses} (bit-equal "
          f"{w0['losses'] == w1['losses'] == ref_losses}); bundles "
          f"byte-equal {len(set(digests)) == 1} (json "
          f"{len(set(metas)) == 1}); launches {w0['launches']} / "
          f"{w1['launches']} (want {want} each of K1[lse], K2, K3 in each "
          f"process); checkpoint directories {dirs}; restored state equal "
          f"to the trained one {w0['restored_digest'] == w0['trained_digest']}"
          f" / {w1['restored_digest'] == w0['trained_digest']} (step "
          f"{w1['restored_step']}); uneven scoring rows "
          f"{w0['score_rows']} / {w1['score_rows']}, local == global mesh "
          f"{w0['score_equal']} / {w1['score_equal']}; health "
          f"{w0['health']} [{card}]")
    print(f"timing gloo all-reduce of the gradients ({w0['allreduce_bytes']}"
          f" bytes f32, through host memory): {w0['allreduce_ms']:.1f} / "
          f"{w1['allreduce_ms']:.1f} ms a step (median of 3); workers "
          f"{w0['seconds']:.1f} / {w1['seconds']:.1f} s, {workers_s:.1f} s "
          f"started to joined [{card}]")
    print(f"phase 29 (b) ResNet-50 ({RESNET50['dtype']}, training "
          f"BatchNorm, {MH['r50_rows'] // MH['n']} rows of "
          f"{MH['r50_side']}^2 a process, global batch {MH['r50_batch']}, "
          f"{w0['r50_steps']} steps, cuDNN deterministic): losses "
          f"{w0['r50_losses']} / {w1['r50_losses']} against the one-process "
          f"data-{MH['n']} fit's {r50_ref_losses}; bundles (parameters and "
          f"batch_stats) byte-equal {len(set(r50_digests)) == 1}; "
          f"{w0['r50_seconds']:.1f} / {w1['r50_seconds']:.1f} s [{card}]")
    require(w0["losses"] == w1["losses"] == ref_losses, "phase 29 (b): the "
            "two-process losses are not bit-equal to the data-2 fit's")
    require(w0["r50_losses"] == w1["r50_losses"] == r50_ref_losses
            and len(set(r50_digests)) == 1, "phase 29 (b): the two-process "
            "ResNet-50 fit is not bit-equal to the data-2 fit")
    require(len(set(digests)) == 1 and len(set(metas)) == 1,
            "phase 29 (b): the bundles are not byte-equal")
    for w in workers:
        for name in ("flash_attention[lse]", "flash_bwd_dq",
                     "flash_bwd_dkv"):
            require(w["launches"][name] == want, f"phase 29 (b): process "
                    f"{w['rank']} launched {name} {w['launches'][name]} "
                    f"times, want {want}")
        require(w["restored_digest"] == w0["trained_digest"]
                and w["restored_step"] == 2 * MH["epochs"],
                f"phase 29 (b): process {w['rank']}'s restore differs")
        require(w["score_equal"], f"phase 29 (b): process {w['rank']}'s "
                "scores differ between the local and the global mesh")
        require(w["health"] == [0, 1], "phase 29 (b): health check")
    require(dirs == [True, False], f"phase 29 (b): checkpoint directories "
            f"{dirs}, want only process 0's")
    require((w0["score_rows"], w1["score_rows"])
            == (MH["rows"] // MH["n"] - MH["drop"], MH["rows"] // MH["n"]),
            "phase 29 (b): the uneven scoring returned other row counts")
    rows = dp_shard_kernel_rows(dev, card, w0["launches"],
                                shape=(MH["batch"] // MH["n"], TRAIN_SEQ,
                                       LM_CONFIG["n_heads"],
                                       LM_CONFIG["d_model"]
                                       // LM_CONFIG["n_heads"]),
                                tag="process shard", phase=29)
    return rows, {"losses": w0["losses"], "ref_losses": ref_losses,
                  "launches": [w["launches"] for w in workers],
                  "allreduce_ms": [w["allreduce_ms"] for w in workers],
                  "allreduce_bytes": w0["allreduce_bytes"],
                  "r50_losses": w0["r50_losses"],
                  "r50_ref_losses": r50_ref_losses,
                  "worker_s": [w["seconds"] for w in workers],
                  "workers_s": workers_s}


def nccl_world_one(dev, card) -> dict:
    """(c) NCCL at world size 1: the group initialized, a sum and a
    broadcast of CUDA tensors through it, a barrier, one process."""
    from mmlspark_tpu_torch.parallel import distributed as dist
    dist.initialize_distributed(dist.DistributedConfig(
        f"127.0.0.1:{free_port()}", 1, 0), device=dev)
    try:
        backend = dist.backend()
        t = [torch.arange(4.0, device=dev)]
        dist.all_reduce_sum(t)
        tree = dist.broadcast_one_to_all({"w": torch.ones(3, device=dev)})
        dist.barrier("nccl_world_one", timeout_s=120)
        count = dist.process_count()
        ok = (t[0].is_cuda and t[0].tolist() == [0.0, 1.0, 2.0, 3.0]
              and tree["w"].is_cuda and tree["w"].sum().item() == 3.0)
    finally:
        dist.shutdown_distributed()
    print(f"phase 29 (c) NCCL at world size 1: backend {backend}, "
          f"all_reduce_sum and broadcast_one_to_all on the card {ok}, "
          f"barrier passed, process_count() {count} [{card}]")
    require(backend == "nccl" and ok and count == 1,
            "phase 29 (c): NCCL at world size 1")
    return {"backend": backend, "process_count": count}


def phase_pipeline_and_processes(dev, card) -> tuple:
    """Phase 29: (a) `pp_lm`, (b) `mh_training`, (c) `nccl_world_one`.
    Returns (the kernel rows, the numbers)."""
    t0 = time.perf_counter()
    out = {"pipeline": pp_lm(dev, card)}
    print(f"phase 29 pipeline: {time.perf_counter() - t0:.1f} s [{card}]")
    t1 = time.perf_counter()
    rows, out["processes"] = mh_training(dev, card)
    print(f"phase 29 processes: {time.perf_counter() - t1:.1f} s [{card}]")
    out["nccl"] = nccl_world_one(dev, card)
    out["phase_seconds"] = time.perf_counter() - t0
    print(f"phase 29: {out['phase_seconds']:.1f} s [{card}]")
    return rows, out


# -- phase 30: the data service -----------------------------------------------

# bench_ingestion's corpus, batch and ResNet-50 (phase 22) read through
# `read_images_iter(service=DataService(mode="process"))`: (a) the
# deterministic stream at these fleet widths, one chunk a split, beside
# the local reader; (b) the dynamic stream at 2 workers; (c) at 2
# workers, two chunks a split, worker 0 killed by the chaos injector
# before its second element; (d) workers=0 (the Autotuner sizes the
# fleet) over reads of `autoscale_batch` images, a tuner step every
# `autoscale_interval` pulls.
DATA_SERVICE = dict(widths=(1, 2, 4), split_elems=1, dynamic_workers=2,
                    crash_workers=2, crash_split_elems=2, crash_at=0,
                    autoscale_batch=32, autoscale_interval=2)


def ingest_resnet50(arrays: np.ndarray, shared: Optional[dict] = None):
    """Phases 22 and 30's ResNet-50 bundle, calibrated over the corpus's
    first `calibration_rows` images; kept in `shared` (main's dict of what
    phases hand on) so that it is built once a run."""
    shared = {} if shared is None else shared
    if "resnet50" not in shared:
        shared["resnet50"] = resnet50_bundle(
            arrays[:INGEST["calibration_rows"]],
            VISION["resnet_branch_scale"])
    return shared["resnet50"]


def card_pids() -> list:
    """The pids holding a compute context on the card, as nvidia-smi
    lists them."""
    done = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    require(done.returncode == 0,
            f"nvidia-smi --query-compute-apps failed: {done.stderr[-300:]}")
    return sorted(int(t) for t in done.stdout.split() if t.isdigit())


def process_facts(pid: int) -> dict:
    """Whether process `pid` maps libcuda (CUDA's user-mode library), and
    the CUDA_VISIBLE_DEVICES its environment holds."""
    facts = {"pid": pid, "libcuda": None, "cuda_visible_devices": None}
    try:
        with open(f"/proc/{pid}/maps") as f:
            facts["libcuda"] = "libcuda.so" in f.read()
        with open(f"/proc/{pid}/environ", "rb") as f:
            for item in f.read().split(b"\0"):
                if item.startswith(b"CUDA_VISIBLE_DEVICES="):
                    facts["cuda_visible_devices"] = item.split(b"=", 1)[
                        1].decode()
    except OSError:
        pass
    return facts


@contextlib.contextmanager
def recorded_workers():
    """Records every worker process the data service spawns inside the
    block."""
    from mmlspark_tpu_torch.data.service import transport
    procs: list = []
    spawn = transport.spawn_worker

    def recording(*args, **kwargs):
        proc = spawn(*args, **kwargs)
        procs.append(proc)
        return proc
    transport.spawn_worker = recording
    try:
        yield procs
    finally:
        transport.spawn_worker = spawn


@contextlib.contextmanager
def service_timeline():
    """A telemetry run whose summary holds the `data_service` timeline,
    with the per-program cost counter off: counting ResNet-50's first
    batch would land inside the timed pass."""
    from mmlspark_tpu_torch import config
    from mmlspark_tpu_torch.observe.telemetry import run_telemetry
    prev = config.get("MMLSPARK_TPU_COSTMODEL")
    config.set("MMLSPARK_TPU_COSTMODEL", "0")
    try:
        with run_telemetry(None) as rt:
            yield rt
    finally:
        config.set("MMLSPARK_TPU_COSTMODEL", prev)


def timeline_entry(event: dict) -> str:
    keys = ("worker", "split", "reason", "received", "redispatches",
            "delivered")
    return event["kind"] + "(" + ", ".join(
        f"{k}={event[k]}" for k in keys if k in event) + ")"


def service_arm(model, source, probe=None) -> dict:
    """One pass of `source()` -> `model.transform_batches`: the time to
    the reader's first table (worker start included), the steady rate
    after it, and the rows; `probe()` runs once the first table is out
    (the session and its workers are live then)."""
    marks: dict = {}

    def timed(tables):
        for table in tables:
            if "first_s" not in marks:
                marks["first_s"] = time.perf_counter() - t0
                marks["first_rows"] = len(table["path"])
                if probe is not None:
                    probe()
            yield table
    paths, scores, images = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for scored in model.transform_batches(timed(source())):
        paths.extend(scored["path"])
        scores.append(scored["scores"])
        images.append(scored["image"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steady_s = wall - marks["first_s"]
    return {"first_s": marks["first_s"], "wall_s": wall,
            "images_per_s": len(paths) / wall,
            "steady_images_per_s": (len(paths) - marks["first_rows"])
            / max(steady_s, 1e-9),
            "paths": paths, "scores": np.concatenate(scores),
            "images": np.concatenate(images)}


def phase_data_service(dev, card, shared: Optional[dict] = None) -> dict:
    """chip_smoke phase 30: the data service.  bench_ingestion's 768
    PNGs -> `read_images_iter(..., resize_to=(224, 224), device=dev,
    service=DataService(workers=w, mode="process"))` -> ResNet-50 bf16
    `TPUModel.transform_batches`: decode runs in worker processes that see
    no card; resize, batching and scoring run on the card here.  (a) w in
    DATA_SERVICE["widths"] beside the local reader: time to the first
    table and steady images/s; gates: the 768 paths in order, pixels equal
    to the local reader's, scores within phase 22's limit with argmax
    equal, no worker among nvidia-smi's compute pids and each with
    CUDA_VISIBLE_DEVICES empty (whether one maps libcuda is printed);
    (b) dynamic at 2 workers: every path exactly once, each row's pixels
    and scores its path's; (c) a worker crash: output byte-equal to local, the
    `data_service` timeline shows the death before the re-dispatch; (d)
    workers=0: the fleet widths the Autotuner chose (no gate)."""
    import tempfile
    from mmlspark_tpu_torch import DataTable, TPUModel, config
    from mmlspark_tpu_torch.data.service import DataService
    from mmlspark_tpu_torch.io.image_reader import read_images_iter
    from mmlspark_tpu_torch.resilience.chaos import (ChaosInjector, Fault,
                                                     set_injector)
    t0 = time.perf_counter()
    cfg = DATA_SERVICE
    bs = INGEST["batch"]
    out: dict = {"card": card, "config": dict(cfg, batch=bs,
                                              files=INGEST["n_files"])}
    with tempfile.TemporaryDirectory() as corpus:
        paths, arrays = ingest_corpus(corpus)
        model = TPUModel(ingest_resnet50(arrays, shared), device=dev,
                         inputCol="image", outputCol="scores",
                         miniBatchSize=bs, computeDtype="bfloat16")
        model.transform(DataTable({"image": arrays[:bs]}))   # warm

        def source(service=None, batch=bs, deterministic=True):
            return lambda: read_images_iter(
                corpus, batch_size=batch, resize_to=(224, 224), device=dev,
                service=service, deterministic=deterministic)
        local = service_arm(model, source())
        require(local["paths"] == paths
                and np.array_equal(local["images"], arrays),
                "phase 30: the local reader's rows differ from the files")
        limit = 1e-3 * float(np.abs(local["scores"]).max())
        row_of = {p: i for i, p in enumerate(paths)}

        def check(name: str, arm: dict, ordered: bool = True) -> dict:
            if ordered:
                require(arm["paths"] == paths,
                        f"phase 30 {name}: {len(arm['paths'])} rows, not "
                        f"the {len(paths)} files in order")
                idx = np.arange(len(paths))
            else:
                require(len(arm["paths"]) == len(paths)
                        and sorted(arm["paths"]) == sorted(paths),
                        f"phase 30 {name}: not every file exactly once "
                        f"({len(arm['paths'])} rows, "
                        f"{len(set(arm['paths']))} distinct)")
                idx = np.array([row_of[p] for p in arm["paths"]])
            require(np.array_equal(arm["images"], local["images"][idx]),
                    f"phase 30 {name}: pixels differ from the local "
                    "reader's")
            ref = local["scores"][idx]
            gap = float(np.abs(arm["scores"] - ref).max())
            same = bool((arm["scores"].argmax(1) == ref.argmax(1)).all())
            require(same and gap <= limit,
                    f"phase 30 {name}: scores against the local stream's: "
                    f"max gap {gap:.3e} (limit {limit:.3e}), argmax equal "
                    f"{same}")
            return {"first_s": arm["first_s"], "wall_s": arm["wall_s"],
                    "images_per_s": arm["images_per_s"],
                    "steady_images_per_s": arm["steady_images_per_s"],
                    "max_score_gap": gap,
                    "scores_bitwise_equal": bool(np.array_equal(
                        arm["scores"], ref))}

        def describe(arm: dict) -> str:
            return (f"first table {arm['first_s']:.3f} s, "
                    f"{arm['images_per_s']:.1f} images/s over the pass, "
                    f"steady {arm['steady_images_per_s']:.1f}")
        out["local"] = {k: local[k] for k in ("first_s", "wall_s",
                                              "images_per_s",
                                              "steady_images_per_s")}
        print(f"phase 30 local reader: {describe(local)} [{card}]")

        # (a) deterministic at each width, the workers looked at live
        out["widths"] = {}
        for w in cfg["widths"]:
            seen: dict = {}
            with recorded_workers() as procs:
                def probe():
                    live = [p.pid for p in procs if p.poll() is None]
                    seen.update(workers=live, on_card=card_pids(),
                                facts=[process_facts(pid) for pid in live])
                svc = DataService(workers=w, mode="process",
                                  split_elems=cfg["split_elems"])
                arm = service_arm(model, source(svc), probe)
            row = check(f"(a) workers={w}", arm)
            row.update(seen)
            require(len(seen["workers"]) == w,
                    f"phase 30 (a) workers={w}: {len(seen['workers'])} "
                    "live workers at the first table")
            require(not set(seen["workers"]) & set(seen["on_card"]),
                    f"phase 30 (a) workers={w}: worker pids "
                    f"{seen['workers']} among the card's compute pids "
                    f"{seen['on_card']}")
            require(all(f["cuda_visible_devices"] == ""
                        for f in seen["facts"]),
                    f"phase 30 (a) workers={w}: a worker sees a card: "
                    f"{seen['facts']}")
            out["widths"][w] = row
            print(f"phase 30 (a) {w} worker process(es): {describe(arm)}; "
                  f"{len(paths)} rows in order, pixels equal to the local "
                  f"reader's, "
                  f"max score gap {row['max_score_gap']:.3e} (limit "
                  f"{limit:.3e}, bitwise {row['scores_bitwise_equal']}); "
                  f"worker pids {seen['workers']}, the card's compute pids "
                  f"{seen['on_card']} (this process {os.getpid()}), "
                  f"workers mapping libcuda "
                  f"{[f['pid'] for f in seen['facts'] if f['libcuda']]}, "
                  f"each sees CUDA_VISIBLE_DEVICES='' [{card}]")
            del arm

        # (b) dynamic: first come, every path once
        arm = service_arm(model, source(
            DataService(workers=cfg["dynamic_workers"], mode="process",
                        split_elems=cfg["split_elems"]),
            deterministic=False))
        out["dynamic"] = check("(b) dynamic", arm, ordered=False)
        out["dynamic"]["in_file_order"] = arm["paths"] == paths
        print(f"phase 30 (b) dynamic, {cfg['dynamic_workers']} workers: "
              f"{describe(arm)}; each of the {len(paths)} files exactly "
              f"once (in "
              f"file order: {out['dynamic']['in_file_order']}), each row's "
              f"pixels and scores its file's [{card}]")
        del arm

        # (c) a worker killed mid-split by the chaos injector
        prev = set_injector(ChaosInjector(script=[Fault(
            kind="worker_crash", worker=0, at_elem=cfg["crash_at"])]))
        try:
            with service_timeline() as rt:
                arm = service_arm(model, source(DataService(
                    workers=cfg["crash_workers"], mode="process",
                    split_elems=cfg["crash_split_elems"])))
        finally:
            set_injector(prev)
        events = rt.summary()["data_service"]
        kinds = [e["kind"] for e in events]
        require("worker_dead" in kinds and "redispatch" in kinds
                and kinds.index("worker_dead") < kinds.index("redispatch"),
                f"phase 30 (c): the timeline lacks the death before the "
                f"re-dispatch: {kinds}")
        out["crash"] = check("(c) crash", arm)
        out["crash"]["timeline"] = [
            e for e in events if e["kind"] in ("worker_dead", "redispatch",
                                               "respawn", "session_end")]
        print(f"phase 30 (c) worker 0 killed after {cfg['crash_at'] + 1} "
              f"element(s) ({cfg['crash_workers']} workers, "
              f"{cfg['crash_split_elems']} chunks a split): {describe(arm)}; "
              f"rows and pixels byte-equal to the local reader's, scores "
              f"bitwise {out['crash']['scores_bitwise_equal']}; timeline "
              + ", ".join(timeline_entry(e) for e in out["crash"]["timeline"])
              + f" [{card}]")
        del arm

        # (d) the Autotuner sizes the fleet
        prev_interval = config.get("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL")
        config.set("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL",
                   cfg["autoscale_interval"])
        try:
            with service_timeline() as rt:
                arm = service_arm(model, source(
                    DataService(workers=0, mode="process",
                                split_elems=cfg["split_elems"]),
                    batch=cfg["autoscale_batch"]))
        finally:
            config.set("MMLSPARK_TPU_DATA_AUTOTUNE_INTERVAL", prev_interval)
        require(arm["paths"] == paths
                and np.array_equal(arm["images"], local["images"]),
                "phase 30 (d): the autoscaled stream differs from the "
                "local reader's rows")
        scale = [(e["workers_from"], e["workers_to"])
                 for e in rt.summary()["data_service"]
                 if e["kind"] == "scale"]
        out["autoscale"] = {"scale": scale, "first_s": arm["first_s"],
                            "images_per_s": arm["images_per_s"],
                            "steady_images_per_s":
                                arm["steady_images_per_s"]}
        print(f"phase 30 (d) workers=0, reads of "
              f"{cfg['autoscale_batch']}: the Autotuner's fleet widths "
              f"{scale or 'unchanged at 1'}; {describe(arm)} [{card}]")
        del arm, local
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 30 (the data service): {out['seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 31: populations over the whole mesh, BatchNorm populations
# ---------------------------------------------------------------------------

# (a) LM_CONFIG's members at SWEEP_RATES, one batch of TRAIN_BATCH x
# TRAIN_SEQ for `steps` steps (an epoch a step, so that each plain fit's
# history is its per-step curve); the f32 arm at f32_layers; (b) the f32
# population at mesh_layers over data 2 x model 2 against one card; (c) a
# basic ResNet-18 (the repo's ConvNet has no BatchNorm) at data 2 against
# one card, momentum, standard-normal images, one step (on an H100 one
# step's update parts by 6e-6 to 4.3e-3 between any two of the population
# and the plain Trainer at one card and at data 2, two steps' by up to
# 7.7e-2, too near phase 27 (c)'s limit of 0.1).
# f32 weights: Adam moves an entry by at most its rate a step, and an
# entry whose gradient is round-off takes a step of up to its rate, of
# either sign, which the batched GEMMs' rounding decides (the gradient of
# a bias summed over 16,384 tokens cancels to round-off): such entries
# part by up to 2 x steps x rate, and a leaf made mostly of them (a
# LayerNorm or qkv bias, zero at init) parts by much of its norm (on an
# H100: 0.2383 of a LayerNorm bias's entries past 1e-5 of its max at rate
# 3e-2, a qkv bias's ||d|| / ||w|| 2.164e-4 at 3e-3).  So the weights are
# held by the update's gap over every leaf (`update_gap`), as phase 27
# holds ResNet-50's, and by that bound on each entry
POP = dict(steps=2, f32_layers=2, bf16_loss_rtol=5e-3, f32_loss_rtol=2e-5,
           f32_update_tol=1e-3, mesh_layers=2, mesh_members=2,
           bn_config={"stage_sizes": [2, 2, 2, 2],
                      "widths": [64, 128, 256, 512], "num_classes": 10,
                      "dtype": "float32"},
           bn_rates=(0.02, 0.01, 0.005, 0.002), bn_images=128, bn_batch=128,
           bn_side=32, bn_loss_rtol=1e-5)


def member_weight_gaps(got: dict, ref: dict, init: dict,
                       d_model: int) -> dict:
    """An f32 member's parameters against its reference, both trained from
    `init` (flax trees with "params"): `f32_weight_gaps`, and the update's
    gap over every leaf as `update_gap` reckons it, the key third of each
    qkv bias left out (its true gradient is zero)."""
    leaves = [named_leaf_arrays(t["params"]) for t in (got, ref, init)]
    num = den = 0.0
    for path, r in leaves[1].items():
        g, i = leaves[0][path], leaves[2][path]
        if path.endswith("qkv/bias"):
            g, r, i = (np.delete(a, np.s_[d_model:2 * d_model])
                       for a in (g, r, i))
        num += float(((g - r) ** 2).sum())
        den += float(((r - i) ** 2).sum())
    return {**f32_weight_gaps(got["params"], ref["params"], d_model),
            "update_gap": (num / max(den, 1e-300)) ** 0.5}


def f32_weights_ok(w: dict, rate: float) -> bool:
    """`member_weight_gaps` within POP["f32_update_tol"] and no entry
    further than two Adam paths of `rate` apart (the note at POP)."""
    return (w["update_gap"] <= POP["f32_update_tol"]
            and w["max_abs"] <= 2 * POP["steps"] * rate)


def truncated_lm(variables: dict, n_layers: int) -> dict:
    """An LM init's variables cut to its first `n_layers` blocks."""
    params = {k: v for k, v in variables["params"].items()
              if not (k.startswith("block") and k.endswith("_w")
                      and int(k[5:-2]) >= n_layers)}
    return {**variables, "params": params}


def pop_config(model_config: dict, epochs: int):
    from mmlspark_tpu_torch import TrainerConfig
    return TrainerConfig(
        architecture="TransformerLM", model_config=model_config,
        optimizer="adam", learning_rate=3e-4, batch_size=TRAIN_BATCH,
        epochs=epochs, loss="softmax_xent", seed=0, numerics_cadence=0)


def pop_lm(dev, card, model_config: dict, tag: str,
           inits: Optional[list] = None) -> dict:
    """One population of the LM at SWEEP_RATES through
    `PopulationTrainer.fit_arrays` from `inits` (default each member's
    seeded init) and each member's plain `Trainer` fit from the same init
    at its rate: the members' per-step losses, the kernels' launches of
    the population's fit, its wall, its step's ms beside one plain step's,
    its peak memory, and (f32) the members' weights against their plain
    fits'."""
    from mmlspark_tpu_torch import ModelBundle
    from mmlspark_tpu_torch.models.definitions import model_config as cfg_of
    from mmlspark_tpu_torch.train import PopulationTrainer
    rows = char_corpus(TRAIN_BATCH, TRAIN_SEQ, model_config["vocab_size"])
    x, y = rows[:, :-1], rows[:, 1:]
    members = [{"learning_rate": r} for r in SWEEP_RATES]
    pt = PopulationTrainer(pop_config(model_config, POP["steps"]), members,
                           device=dev)
    if inits is None:
        inits = [pt.member_init_variables(k, (1, TRAIN_SEQ))
                 for k in range(len(members))]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    result = pt.fit_arrays(x, y, member_variables=inits)
    sync(dev)
    wall = time.perf_counter() - t0
    launched = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    curves = [[h["member_loss"][k] for h in pt.history]
              for k in range(len(members))]
    f32 = model_config["dtype"] == "float32"
    member_vars = ([pt.member_variables(result.state, k)
                    for k in range(len(members))] if f32 else None)
    # the population's step alone (it advances the finished state)
    xb, yb = (torch.from_numpy(a).to(dev) for a in (x, y))
    mb = torch.ones(TRAIN_BATCH, device=dev)
    step = pt.make_population_step()
    step_ms = cuda_ms(lambda: step(result.state, xb, yb, mb), warmup=0,
                      reps=2)
    del result, step
    torch.cuda.empty_cache()
    plain, plain_s, bundles = [], 0.0, []
    for k in range(len(members)):
        trainer = pt.member_trainer(k)
        sync(dev)
        t0 = time.perf_counter()
        bundle = trainer.fit_arrays(x, y, initial_bundle=ModelBundle(
            "TransformerLM", cfg_of(pt.module), inits[k]))
        sync(dev)
        plain_s += time.perf_counter() - t0
        plain.append([h["loss"] for h in trainer.history])
        if f32:
            bundles.append(bundle)
        if k == 0:
            state = trainer._last_state
            one = trainer.make_train_step()
            plain_step_ms = cuda_ms(lambda: one(state, xb, yb, mb),
                                    warmup=0, reps=2)
            del state, one
        del trainer, bundle
        torch.cuda.empty_cache()
    gaps = [abs(a - b) / abs(b) for pc, mc in zip(plain, curves)
            for a, b in zip(mc, pc)]
    out = {"curves": curves, "plain_curves": plain,
           "max_rel_gap": max(gaps), "launches": launched,
           "fit_s": wall, "plain_fits_s": plain_s, "step_ms": step_ms,
           "plain_step_ms": plain_step_ms, "peak_gib": peak / 2 ** 30,
           "inits": inits}
    if f32:
        out["weights"] = [member_weight_gaps(v, b.variables, i,
                                             model_config["d_model"])
                          for v, b, i in zip(member_vars, bundles, inits)]
    print(f"phase 31 (a) {tag}: {len(members)} members at {SWEEP_RATES}, "
          f"{POP['steps']} steps of {TRAIN_BATCH}x{TRAIN_SEQ}, "
          f"{model_config['n_layers']} layers: member losses {curves}; "
          f"plain fits {plain}; max rel gap {max(gaps):.3e}; launches "
          f"{launched}; the population's fit {wall:.2f} s (peak "
          f"{out['peak_gib']:.2f} GiB), the {len(members)} plain fits "
          f"{plain_s:.2f} s; a population step {step_ms:.1f} ms against a "
          f"plain step's {plain_step_ms:.1f} ms (CUDA events, median of 2) "
          f"[{card}]")
    return out


def pop_mesh(dev, card, inits: list) -> dict:
    """(b) The f32 LM population at LM_CONFIG's width and POP["mesh_layers"]
    over data 2 x model 2 (shards sharing the card) against the same
    population on one card: member losses and weights, K1[lse] / K2 / K3
    once per (data row, model shard, layer, step)."""
    from mmlspark_tpu_torch.train import PopulationTrainer
    model_config = {**LM_CONFIG, "attn_impl": "flash", "dtype": "float32",
                    "n_layers": POP["mesh_layers"]}
    rows = char_corpus(TRAIN_BATCH, TRAIN_SEQ, model_config["vocab_size"])
    x, y = rows[:, :-1], rows[:, 1:]
    members = [{"learning_rate": r}
               for r in SWEEP_RATES[:POP["mesh_members"]]]
    runs = {}
    for name, mesh in (("one card", None), ("data 2 x model 2",
                                            mp_mesh(dev, 2, 2))):
        pt = PopulationTrainer(pop_config(model_config, POP["steps"]),
                               members, mesh=mesh, device=dev)
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        result = pt.fit_arrays(x, y, member_variables=inits)
        sync(dev)
        runs[name] = {"losses": result.member_loss.tolist(),
                      "launches": read_counts(),
                      "seconds": time.perf_counter() - t0,
                      "params": [pt.member_variables(result.state, k)[
                          "params"] for k in range(len(members))],
                      "mesh": result.member_bundle(0).metadata[
                          "partition"]["mesh"]}
        del pt, result
        torch.cuda.empty_cache()
    one, mesh = runs["one card"], runs["data 2 x model 2"]
    gaps = [abs(a - b) / abs(b) for ra, rb in zip(mesh["losses"],
                                                   one["losses"])
            for a, b in zip(ra, rb)]
    weights = [member_weight_gaps({"params": a}, {"params": b}, i,
                                  model_config["d_model"])
               for a, b, i in zip(mesh["params"], one["params"], inits)]
    want = POP["mesh_layers"] * POP["steps"] * 4
    print(f"phase 31 (b) the f32 population of {len(members)} at "
          f"{POP['mesh_layers']} layers over data 2 x model 2 on this card: "
          f"member losses {mesh['losses']} against one card's "
          f"{one['losses']} (max rel gap {max(gaps):.3e}, tol "
          f"{POP['f32_loss_rtol']}); weights {weights}; launches "
          f"{mesh['launches']} (want {want} each of K1[lse], K2, K3); "
          f"bundle mesh {mesh['mesh']}; {mesh['seconds']:.2f} s against "
          f"{one['seconds']:.2f} s [{card}]")
    require(max(gaps) <= POP["f32_loss_rtol"], "phase 31 (b): the mesh "
            "population's losses differ from one card's")
    for k, w in enumerate(weights):
        require(f32_weights_ok(w, SWEEP_RATES[k]), f"phase 31 (b): member "
                f"{k}'s weights differ from one card's")
    for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
        require(mesh["launches"][name] == want, f"phase 31 (b): {name} "
                f"launched {mesh['launches'][name]} times, want {want}")
    require(mesh["mesh"] == {"data": 2, "model": 2}, "phase 31 (b): the "
            "member bundle's mesh")
    return {"losses": mesh["losses"], "one_card_losses": one["losses"],
            "max_rel_gap": max(gaps), "weights": weights,
            "launches": mesh["launches"], "seconds": mesh["seconds"],
            "one_card_seconds": one["seconds"]}


def pop_batchnorm(dev, card) -> dict:
    """(c) A ResNet population with training BatchNorm at data 2 (the
    shards' vmapped forwards in lockstep, each member's statistics over
    the global batch) against the same population on one card at the
    same global batch, one step, the batch's first half (shard 0's slab)
    dimmed to a quarter, as phase 27 (c) has it: member losses within
    POP["bn_loss_rtol"], each member's update within DP["weight_tol"] of
    one card's (`update_gap`) and its batch_stats within DP["stats_tol"]
    of each leaf's max, and a planted BatchNorm with each shard's own
    statistics must fail the batch_stats gate.  (The CPU holds the same
    populations to 1e-6, tests/test_torch_sweep_bn.py; on the card the
    convolutions round with the shards' batch shapes, and a random
    ResNet's BatchNorm amplifies that rounding in the backward: the note
    at POP.)"""
    from mmlspark_tpu_torch import TrainerConfig
    from mmlspark_tpu_torch.models import definitions
    from mmlspark_tpu_torch.train import PopulationTrainer
    side, b = POP["bn_side"], POP["bn_batch"]
    rng = np.random.default_rng(31)
    x = rng.standard_normal((POP["bn_images"], side, side, 3)).astype(
        np.float32)
    for start in range(0, POP["bn_images"], b):
        x[start:start + b // 2] *= np.float32(0.25)
    y = rng.integers(0, POP["bn_config"]["num_classes"],
                     POP["bn_images"]).astype(np.int32)
    cfg = TrainerConfig(architecture="ResNet",
                        model_config=dict(POP["bn_config"]),
                        optimizer="momentum", learning_rate=0.05,
                        batch_size=b, epochs=1, shuffle_each_epoch=False,
                        loss="softmax_xent", seed=0, numerics_cadence=0)
    members = [{"learning_rate": r} for r in POP["bn_rates"]]
    seeded = PopulationTrainer(cfg, members, device=dev)
    inits = [seeded.member_init_variables(k, (1, side, side, 3))
             for k in range(len(members))]
    del seeded

    def fit(mesh) -> dict:
        pt = PopulationTrainer(cfg, members, mesh=mesh, device=dev)
        sync(dev)
        t0 = time.perf_counter()
        result = pt.fit_arrays(x, y, member_variables=inits)
        sync(dev)
        run = {"losses": result.member_loss.tolist(),
               "seconds": time.perf_counter() - t0,
               "vars": [pt.member_variables(result.state, k)
                        for k in range(len(members))]}
        del pt, result
        torch.cuda.empty_cache()
        return run

    def stats_gap(run: dict) -> float:
        return max(max(named_gaps(a["batch_stats"], r["batch_stats"])
                       .values()) for a, r in zip(run["vars"], one["vars"]))

    one, dp = fit(None), fit(dp_mesh(dev))
    real = definitions.active_data_shard
    definitions.active_data_shard = lambda: None
    try:
        planted = fit(dp_mesh(dev))
    finally:
        definitions.active_data_shard = real
    gaps = [abs(a - b) / abs(b) for ra, rb in zip(dp["losses"],
                                                   one["losses"])
            for a, b in zip(ra, rb)]
    worst = max(update_gap(a, r, i) for a, r, i in zip(
        dp["vars"], one["vars"], inits))
    stats, planted_stats = stats_gap(dp), stats_gap(planted)
    print(f"phase 31 (c) ResNet-18 population of {len(members)} at "
          f"{list(POP['bn_rates'])} (momentum, f32), {POP['bn_images']} "
          f"images of {side}^2 in batches of {b}, each batch's first half "
          f"dimmed: data 2 member losses {dp['losses']} against one card's "
          f"{one['losses']} (max rel gap {max(gaps):.3e}, tol "
          f"{POP['bn_loss_rtol']}); the update's gap at most {worst:.3e} "
          f"(tol {DP['weight_tol']}); batch_stats at most {stats:.3e} of a "
          f"leaf's max (tol {DP['stats_tol']}), the planted per-shard "
          f"statistics {planted_stats:.3e}; {dp['seconds']:.2f} s against "
          f"{one['seconds']:.2f} s [{card}]")
    require(max(gaps) <= POP["bn_loss_rtol"], "phase 31 (c): the data-2 "
            "BatchNorm population's losses differ from one card's")
    require(worst <= DP["weight_tol"] and stats <= DP["stats_tol"],
            "phase 31 (c): the data-2 BatchNorm population's parameters or "
            "statistics differ")
    require(planted_stats > DP["stats_tol"], "phase 31 (c): per-shard "
            "statistics pass the batch_stats gate")
    return {"losses": dp["losses"], "one_card_losses": one["losses"],
            "max_rel_gap": max(gaps), "update_gap": worst,
            "batch_stats_gap": stats, "planted_stats_gap": planted_stats,
            "seconds": dp["seconds"], "one_card_seconds": one["seconds"]}


def phase_populations(dev, card) -> tuple:
    """Phase 31: (a) the LM population at LM_CONFIG's width, K1[lse], K2
    and K3 folded over the members (n_layers x steps launches whatever
    the population's size), each member's curve against its plain fit,
    an f32 arm; the folded kernels checked and timed at (members x
    TRAIN_BATCH, TRAIN_SEQ, 8, 128); (b) `pop_mesh`; (c)
    `pop_batchnorm`.  Returns (the kernel rows, the numbers)."""
    t0 = time.perf_counter()
    n_layers = LM_CONFIG["n_layers"]
    bf16 = pop_lm(dev, card, {**LM_CONFIG, "attn_impl": "flash"},
                  "bf16 at LM_CONFIG's width")
    want = n_layers * POP["steps"]
    require(bf16["max_rel_gap"] <= POP["bf16_loss_rtol"], "phase 31 (a): a "
            "member's bf16 losses differ from its plain fit's")
    for name in ("flash_attention[lse]", "flash_bwd_dq", "flash_bwd_dkv"):
        require(bf16["launches"][name] == want, f"phase 31 (a): {name} "
                f"launched {bf16['launches'][name]} times for "
                f"{len(SWEEP_RATES)} members, want {want} (one a layer a "
                "step, whatever the population's size)")
    require(all(c[-1] < c[0] for c in bf16["curves"][:2]),
            "phase 31 (a): the slow members' loss did not fall")
    # the f32 arms start from the bf16 arm's inits cut to their depth
    inits = [truncated_lm(v, POP["f32_layers"]) for v in bf16.pop("inits")]
    f32 = pop_lm(dev, card, {**LM_CONFIG, "attn_impl": "flash",
                             "dtype": "float32",
                             "n_layers": POP["f32_layers"]},
                 f"f32 at {POP['f32_layers']} layers", inits)
    f32.pop("inits")
    print(f"phase 31 (a) f32 weights against the plain fits: {f32['weights']}"
          f" [{card}]")
    require(f32["max_rel_gap"] <= POP["f32_loss_rtol"], "phase 31 (a): a "
            "member's f32 losses differ from its plain fit's")
    for k, w in enumerate(f32["weights"]):
        require(f32_weights_ok(w, SWEEP_RATES[k]), f"phase 31 (a): member "
                f"{k}'s f32 weights differ from its plain fit's")
    rows = dp_shard_kernel_rows(
        dev, card, bf16["launches"],
        shape=(len(SWEEP_RATES) * TRAIN_BATCH, TRAIN_SEQ,
               LM_CONFIG["n_heads"],
               LM_CONFIG["d_model"] // LM_CONFIG["n_heads"]),
        tag="population fold", phase=31)
    out = {"lm_bf16": bf16, "lm_f32": f32,
           "mesh": pop_mesh(dev, card, [truncated_lm(
               v, POP["mesh_layers"]) for v in inits[:POP["mesh_members"]]]),
           "batchnorm": pop_batchnorm(dev, card)}
    out["phase_seconds"] = time.perf_counter() - t0
    print(f"phase 31: {out['phase_seconds']:.1f} s [{card}]")
    return rows, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from mmlspark_tpu_torch.ops import native

    t_start = time.perf_counter()
    card = card_line()
    print(card)
    exp_rate()
    print(f"exp rate: {exp_rate.detail} [{card}]")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    build_s = native.build()
    print(f"kernel build: {build_s:.1f} s")
    k1_build = ptxas_report("flash_attention", "flash_fwd")
    bwd_build = ptxas_report("flash_backward", "flash_bwd")
    k4_build = ptxas_report("decode_attention", "sqa_")
    for row in k1_build + bwd_build + k4_build:
        print(f"ptxas {row['kernel']}: {row['registers']} registers, "
              f"{row['static_smem_bytes']} bytes static shared memory, "
              f"{row['spill_stores']} / {row['spill_loads']} bytes spill "
              f"stores / loads")
    # K1, K2 and K3: f32 and bf16 at 5 head dims each (bf16 wgmma, on
    # narrow tiles at 8, 16 and 32); K4: 2 q types x 3 caches x 5 head dims
    require(len(k1_build) == 10 and not any(
        row["spill_stores"] or row["spill_loads"] for row in k1_build),
        "K1's build log lacks a kernel or reports spills")
    require(len(bwd_build) == 20 and not any(
        row["spill_stores"] or row["spill_loads"] for row in bwd_build),
        "K2/K3's build log lacks a kernel or reports spills")
    require(len(k4_build) == 30 and not any(
        row["spill_stores"] or row["spill_loads"] for row in k4_build),
        "K4's build log lacks a kernel or reports spills")
    dev = torch.device("cuda")
    seconds: dict = {1: time.perf_counter() - t_start}
    print(f"phase seconds 1: {seconds[1]:.1f} s [{card}]")

    def phase(n: int, fn, *args, clear: bool = True):
        """Run phase `n`, print its seconds on a line of its own."""
        t0 = time.perf_counter()
        out = fn(dev, card, *args)
        if clear:
            torch.cuda.empty_cache()
        seconds[n] = time.perf_counter() - t0
        print(f"phase seconds {n}: {seconds[n]:.1f} s [{card}]")
        return out

    flash = phase(2, phase_flash, clear=False)
    flash_lse = phase(3, phase_flash_lse, clear=False)
    backward = phase(4, phase_backward, clear=False)
    decode = phase(5, phase_decode)
    main_path = phase(6, phase_main_path)
    train = phase(7, phase_train)
    decode_stats = phase(8, phase_decode_stats, clear=False)
    ring_lse = phase(9, phase_ring_lse, clear=False)
    long_context = phase(10, phase_long_context)
    grad_check = phase(11, phase_grad_check)
    reset_counts()
    serving = phase(12, phase_serving)
    print(json.dumps({"serving": serving, "card": card}))
    reset_counts()
    fleet = phase(13, phase_fleet)
    print(json.dumps({"fleet": fleet, "card": card}))
    reset_counts()
    tiered = phase(14, phase_tiered)
    print(json.dumps({"tiers": tiered, "card": card}))
    d32, d32_paths = phase(15, phase_head_dim_32)
    small, small_paths = phase(16, phase_small_head_dims)
    wide, wide_paths = phase(17, phase_wide_f32_backward, grad_check)
    lm_decoding = phase(18, phase_lm_decoding)
    print(json.dumps({"lm_decoding": lm_decoding, "card": card}))
    ckpt_training = phase(19, phase_checkpointed_training)
    print(json.dumps({"checkpointed_training": ckpt_training,
                      "card": card}))
    ring_rows, seq_training = phase(20, phase_seq_parallel_training)
    print(json.dumps({"seq_parallel_training": seq_training,
                      "card": card}))
    vision = phase(21, phase_vision_scoring)
    print(json.dumps({"vision_scoring": vision, "card": card}))
    shared: dict = {}   # what one phase hands on to a later one
    image_pipeline = phase(22, phase_image_pipeline, shared)
    print(json.dumps({"image_pipeline": image_pipeline, "card": card}))
    vision_training = phase(23, phase_vision_training)
    print(json.dumps({"vision_training": vision_training, "card": card}))
    automl = phase(24, phase_automl)
    print(json.dumps({"automl": automl, "card": card}))
    moe = phase(25, phase_moe_and_sweep)
    print(json.dumps({"moe_and_sweep": moe, "card": card}))
    measurement = phase(26, phase_measurement)
    print(json.dumps({"measurement": measurement, "card": card}))
    dp_rows, data_parallel = phase(27, phase_data_parallel)
    print(json.dumps({"data_parallel": data_parallel, "card": card}))
    mp_rows, model_parallel = phase(28, phase_model_parallel)
    print(json.dumps({"model_parallel": model_parallel, "card": card},
                     default=str))
    pp_rows, pipeline_processes = phase(29, phase_pipeline_and_processes)
    print(json.dumps({"pipeline_and_processes": pipeline_processes,
                      "card": card}, default=str))
    data_service = phase(30, phase_data_service, shared)
    print(json.dumps({"data_service": data_service, "card": card},
                     default=str))
    pop_rows, populations = phase(31, phase_populations)
    print(json.dumps({"populations": populations, "card": card},
                     default=str))
    total = time.perf_counter() - t_start
    print(json.dumps({"phase_seconds": {str(k): round(v, 1) for k, v in
                                        seconds.items()},
                      "total_s": round(total, 1), "card": card}))
    # launches: each kernel's count from the path that runs it (serving
    # for K1 and K4, training for K1[lse], K2 and K3)
    flash["launches"] = main_path["counts"]["model"][0]
    decode[0]["launches"] = main_path["counts"]["model"][1]
    decode[1]["launches"] = main_path["counts"]["int8"][1]
    flash_lse["launches"] = train["counts"]["flash_attention[lse]"]
    for entry in backward:
        entry["launches"] = train["counts"][entry["name"]]
    # the long-context path: K4[stats] and K1[lse] at head dim 64 from the
    # seq=2 engine, K1 and K4 at head dim 64 from the seq=1 engine
    seq1, seq2 = (long_context["counts"][n] for n in (1, 2))
    decode_stats[0]["launches"] = seq2["fused_single_query_attention_stats"]
    decode_stats[1]["launches"] = long_context["int8"]["stats_launches"]
    decode_stats[2]["launches"] = seq1["fused_single_query_attention"]
    ring_lse[0]["launches"] = seq2["flash_attention[lse]"]
    ring_lse[1]["launches"] = seq1["flash_attention"]
    kernels = ([flash, flash_lse] + backward + decode + decode_stats
               + ring_lse + d32 + small + wide + ring_rows + dp_rows
               + mp_rows + pp_rows + pop_rows)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "bound_term",
            "library_ms")
    print(json.dumps({"main_path": {k: v for k, v in main_path.items()
                                    if k != "counts"},
                      "train_path": {k: v for k, v in train.items()
                                     if k != "counts"},
                      "long_context": long_context,
                      "grad_check": grad_check, "head_dim_32": d32_paths,
                      "small_head_dims": small_paths,
                      "wide_f32_backward": wide_paths,
                      "k1_build": k1_build,
                      "bwd_build": bwd_build, "k4_build": k4_build,
                      "card": card}))
    print(card)
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def backward_times(dev, card) -> dict:
    """`chip_smoke.py --ab TAG --bwd`: K2 and K3 causal, f32 at every head
    dim and bf16 at 8, 16 and 32 on (8, 2048, 8, d), both also at
    PATH_BWD_SHAPES, checked against plain (`check_backward`) and timed
    (`time_backward`).  Returns per dtype and (B, S, H, D) the K2 and K3
    ms and the library pair's."""
    gen = torch.Generator(device=dev).manual_seed(11)
    out: dict = {"f32": {}, "bf16": {}}
    paths = [(d, shape) for _, d, shape in PATH_BWD_SHAPES]
    for dtype, dims in ((torch.float32, (8, 16, 32, 64, 128)),
                        (torch.bfloat16, (8, 16, 32))):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for d, (b, s, h) in [(d, (TRAIN_BATCH, TRAIN_SEQ, 8))
                             for d in dims] + paths:
            args = backward_inputs(gen, b, s, s, True, 0, 0, dtype, d, h)
            check_backward(args, d, dtype, f"head dim {d}: flash backward "
                           f"{tag} ({b}, {s}, {h}, {d})")
            timed = time_backward(card, gen, d, dtype, args, (b, s, h))
            out[tag][str((b, s, h, d))] = {
                "dq_ms": timed["flash_bwd_dq"]["ms"],
                "dkv_ms": timed["flash_bwd_dkv"]["ms"],
                "library_pair_ms": timed["flash_bwd_dq"]["library_ms"]}
            del args
            torch.cuda.empty_cache()
    return out


# `--fwd`: the bf16 K1 shapes of phases 15 and 16 at head dims 8-32 and the
# training shapes of paths (b) and (c)
FWD_SHAPES = ((2, 1024, 8, 8), (2, 1024, 8, 16), (2, 1024, 8, 32),
              (TRAIN_BATCH, TRAIN_SEQ, 8, 16), (TRAIN_BATCH, 1024, 8, 32))


def forward_times(dev, card) -> dict:
    """`chip_smoke.py --ab TAG --fwd`: bf16 K1 and K1[lse] at FWD_SHAPES,
    checked and timed with their library calls (`bf16_k1_rows`).  Returns
    per shape the K1 and K1[lse] ms and the library calls'."""
    out = {}
    for i, shape in enumerate(FWD_SHAPES):
        rows = list(bf16_k1_rows(dev, card, shape, seed=100 + i).values())
        out[str(shape)] = {"k1_ms": rows[0]["ms"],
                           "sdpa_ms": rows[0]["library_ms"],
                           "k1_lse_ms": rows[1]["ms"],
                           "aten_flash_ms": rows[1]["library_ms"]}
    return out


def ab_main(argv: list) -> int:
    """`python3 chip_smoke.py --ab TAG [--tree DIR]`: the host-bound
    serving phases alone, on the port package of the tree DIR (default:
    this script's own), for a parent-against-change comparison inside one
    chip call, where host-bound rates do not move between runs as they do
    between calls.  Unpack the parent into a git-ignored directory
    (`git archive <parent> | tar -x -C build/parent`) and run, in one
    call, `--ab parent --tree build/parent`, `--ab change` twice, then
    the parent again.  Runs phase 6 (`TextGenerator.transform`), 12 (the
    online engine over HTTP), 13 (the fleet over HTTP) and, where the
    tree has the tiers, 14, the last two without their bench arms; their
    gates hold as in a full run.  Prints one line, `AB {...}`: the
    tree's tag and directory, each phase's tokens/s, phase 14's overlap
    and splice-to-first-decode ms, the card's name and power limit.  With
    `--bwd`, only `backward_times` on that tree's kernels, with `--fwd`
    only `forward_times` (both: both), their ptxas lines printed first,
    for the same comparison of a kernel change."""
    import argparse
    import importlib.util
    import os
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--ab", required=True, metavar="TAG")
    ap.add_argument("--tree", default=None, metavar="DIR")
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument("--fwd", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree or os.path.dirname(__file__))
    sys.path.insert(0, tree)
    import mmlspark_tpu_torch
    from mmlspark_tpu_torch.ops import native
    require(os.path.dirname(os.path.dirname(os.path.abspath(
        mmlspark_tpu_torch.__file__))) == tree,
        f"--tree {tree}: the port imported from {mmlspark_tpu_torch.__file__}")
    native.build()
    card = card_line()
    dev = torch.device("cuda")
    out: dict = {"tree": args.ab, "dir": tree, "card": card}
    t0 = time.perf_counter()
    if args.bwd or args.fwd:
        exp_rate()
        print(f"exp rate: {exp_rate.detail} [{card}]")
        for row in (ptxas_report("flash_attention", "flash_fwd")
                    + ptxas_report("flash_backward", "flash_bwd")):
            print(f"ptxas {row['kernel']}: {row['registers']} registers, "
                  f"{row['static_smem_bytes']} bytes static shared memory, "
                  f"{row['spill_stores']} / {row['spill_loads']} bytes spill")
        if args.fwd:
            out["bf16_forward"] = forward_times(dev, card)
        if args.bwd:
            out["backward"] = backward_times(dev, card)
        out["seconds"] = time.perf_counter() - t0
        print("AB " + json.dumps(out))
        return 0
    out["phase6"] = phase_main_path(dev, card)["tokens_per_s"]
    torch.cuda.empty_cache()
    reset_counts()
    out["phase12"] = {k: v["tokens_per_s"] for k, v in phase_serving(
        dev, card).items() if isinstance(v, dict) and "tokens_per_s" in v}
    torch.cuda.empty_cache()
    reset_counts()
    out["phase13"] = {k: v["tokens_per_s"] for k, v in phase_fleet(
        dev, card, benches=False).items()
        if isinstance(v, dict) and "tokens_per_s" in v}
    if importlib.util.find_spec("mmlspark_tpu_torch.serve.handoff"):
        torch.cuda.empty_cache()
        reset_counts()
        out["phase14"] = {
            k: {"tokens_per_s": v["tokens_per_s"],
                "overlap": v["handoff"]["overlap"],
                "splice_to_first_decode_ms":
                    v["splice_to_first_decode_ms"]["median"]}
            for k, v in phase_tiered(dev, card, benches=False).items()
            if isinstance(v, dict) and "handoff" in v}
    out["seconds"] = time.perf_counter() - t0
    print("AB " + json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--mp-worker"]:
            sys.exit(mp_worker(int(sys.argv[2]), *sys.argv[3:5]))
        sys.exit(ab_main(sys.argv[1:]) if sys.argv[1:] else main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
