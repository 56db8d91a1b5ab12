"""Work of a bottleneck ResNet, counted from its shapes: the multiply-adds
of every convolution and of the Dense head (2 FLOPs each).  BatchNorm,
ReLU, pooling and the residual adds are left out, as model FLOPs leave
them out.  ResNet-50 at 224 x 224 is about 4.1 GMAC an image."""

from __future__ import annotations


def _out(size: int, stride: int) -> int:
    return -(-size // stride)   # "SAME" padding


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one image's forward."""
    size = _out(cfg["image_size"], 2)                 # the stem
    macs = size * size * 64 * cfg["channels"] * 7 * 7
    size = _out(size, 2)                              # the max pool
    n_in = 64
    for i, (n, w) in enumerate(zip(cfg["stage_sizes"], cfg["widths"])):
        for b in range(n):
            stride = 2 if b == 0 and i > 0 else 1
            out = _out(size, stride)
            macs += size * size * n_in * w                # 1x1 reduce
            macs += out * out * w * w * 9                 # 3x3, strided
            macs += out * out * w * 4 * w                 # 1x1 expand
            if stride != 1 or n_in != 4 * w:
                macs += out * out * n_in * 4 * w          # projection
            n_in, size = 4 * w, out
    return macs + n_in * cfg["num_classes"]


def forward_flops(cfg: dict) -> float:
    return 2.0 * forward_macs(cfg)


def train_step_flops(cfg: dict, mix: dict) -> float:
    """Forward plus the two backward products, over a step's batch."""
    return 3.0 * forward_flops(cfg) * mix["batch"]
