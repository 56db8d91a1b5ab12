from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_bundle,
                                              params_from_jax, save_bundle)
from mmlspark_tpu_torch.models.definitions import (MODEL_REGISTRY,
                                                   TransformerBlock,
                                                   TransformerLM, build_model,
                                                   model_config)
from mmlspark_tpu_torch.models.generate import (DecodeEngine, TextGenerator,
                                                bucket_length,
                                                decode_segments,
                                                naive_generate)
