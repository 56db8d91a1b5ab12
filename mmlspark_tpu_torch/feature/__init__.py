"""Featurization layer (reference L4: featurize/, text-featurizer/).
The port of `mmlspark_tpu/feature/`: the same names."""

from mmlspark_tpu_torch.feature.assemble import AssembleFeatures, AssembleFeaturesModel, Featurize
from mmlspark_tpu_torch.feature.text import (
    HashingTF,
    IDF,
    IDFModel,
    NGram,
    StopWordsRemover,
    TextFeaturizer,
    Tokenizer,
)
from mmlspark_tpu_torch.feature.hashing import densify_sparse_column, stable_hash
from mmlspark_tpu_torch.feature.word2vec import Word2Vec, Word2VecModel

__all__ = [
    "AssembleFeatures", "AssembleFeaturesModel", "Featurize",
    "Tokenizer", "StopWordsRemover", "NGram", "HashingTF", "IDF", "IDFModel",
    "TextFeaturizer", "stable_hash", "densify_sparse_column",
    "Word2Vec", "Word2VecModel",
]
