from mmlspark_tpu_torch.models.bundle import (ModelBundle, load_bundle,
                                              params_from_jax, save_bundle)
from mmlspark_tpu_torch.models.definitions import (MODEL_REGISTRY,
                                                   ConvNetCIFAR10,
                                                   LinearModel,
                                                   MLPClassifier, ResNet,
                                                   TransformerBlock,
                                                   TransformerLM, build_model,
                                                   model_config, resnet50)
from mmlspark_tpu_torch.models.generate import (DecodeEngine, TextGenerator,
                                                beam_search, bucket_length,
                                                decode_segments,
                                                make_beam_search_fn,
                                                naive_generate)
from mmlspark_tpu_torch.models.tpu_model import TPUModel
