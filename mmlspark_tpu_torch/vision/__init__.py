"""Vision pipeline stages of the port (the port of `mmlspark_tpu/vision/`;
reference image-transformer/, image-featurizer/)."""

from mmlspark_tpu_torch.vision.transformer import (ImageTransformer,
                                                   UnrollImage)
from mmlspark_tpu_torch.vision.featurizer import ImageFeaturizer

__all__ = ["ImageTransformer", "UnrollImage", "ImageFeaturizer"]
