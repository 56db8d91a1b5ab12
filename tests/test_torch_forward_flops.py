"""`forward_flops` (mmlspark_tpu_torch/utils/perf.py) against the JAX
package's: the port counts one forward on meta tensors with the cost
counter (convolutions and matrix products only), the JAX package reads
XLA's compiled count.  The port's count equals the layers' hand count
exactly; against XLA it differs by two stated effects."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.bundle import ModelBundle as JaxModelBundle
from mmlspark_tpu.utils.perf import forward_flops as jax_forward_flops
from mmlspark_tpu_torch.models import ModelBundle
from mmlspark_tpu_torch.models.definitions import Conv, Dense
from mmlspark_tpu_torch.utils.perf import forward_flops

# the port's count over XLA's: XLA adds the elementwise FLOPs (bias,
# ReLU, BatchNorm, pooling), which the MLP shows (0.985 measured), and
# skips the kernel taps that fall in a SAME convolution's padding, which
# the counter's convolution formula counts (a 3 x 3 SAME convolution on a
# 32 x 32 map has 1.043x the taps XLA counts); measured 1.083 for the
# ConvNet and 1.119 for the ResNet (its 7 x 7 stem pads more) at these
# widths
SPECS = {
    "mlp": ("MLPClassifier", {"hidden_sizes": [64, 32], "num_classes": 10,
                              "dtype": "float32"}, (8, 64), (0.97, 1.0)),
    "convnet": ("ConvNetCIFAR10", {"widths": [16, 32, 32],
                                   "dense_width": 64, "dtype": "float32"},
                (8, 32, 32, 3), (1.05, 1.11)),
    "resnet": ("ResNet", {"stage_sizes": [1, 1], "widths": [16, 32],
                          "num_classes": 10, "dtype": "float32"},
               (8, 32, 32, 3), (1.09, 1.15)),
}
BUNDLES = {name: ModelBundle.init(arch, cfg, seed=0,
                                  input_shape=(1,) + shape[1:])
           for name, (arch, cfg, shape, _) in SPECS.items()}


@pytest.fixture(scope="module")
def xla_counts():
    def count(name):
        b = BUNDLES[name]
        return jax_forward_flops(
            JaxModelBundle(b.architecture, dict(b.config), b.variables,
                           dict(b.metadata)), SPECS[name][2])
    with ThreadPoolExecutor(3) as pool:
        return dict(zip(SPECS, pool.map(count, SPECS)))


def _hand_count(bundle, shape) -> float:
    """2 x the multiply-adds of every conv and Dense layer, from their
    weights and outputs (chip_smoke's `flops_per_row`)."""
    module = bundle.module("cpu")
    total = [0.0]

    def hook(mod, _inp, out):
        w = mod.weight
        taps = w.shape[1] * (w.shape[2] * w.shape[3] if w.dim() == 4 else 1)
        total[0] += 2.0 * out.numel() * taps

    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            m.register_forward_hook(hook)
    with torch.inference_mode():
        module(torch.zeros(shape))
    return total[0]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_forward_flops_against_the_layers_and_xla(name, xla_counts):
    _, _, shape, (lo, hi) = SPECS[name]
    ours = forward_flops(BUNDLES[name], shape)
    assert ours == _hand_count(BUNDLES[name], shape)
    # integer pixels are widened first, as the scoring forward does
    assert forward_flops(BUNDLES[name], shape, np.uint8) == ours
    assert lo <= ours / xla_counts[name] <= hi, ours / xla_counts[name]


def test_forward_flops_is_none_when_nothing_counts():
    assert forward_flops(BUNDLES["mlp"], (8, 5)) is None   # a wrong width
