"""Plain ResNet-50 in float32 (the reference of the `resnet50` cells).

He et al. 2015 (arXiv:1512.03385, Table 1), v1.5 (the stride on the 3x3
conv): a 7x7 stride-2 stem, a 3x3 stride-2 max pool, bottleneck stages
(3, 4, 6, 3) of widths 64-512 (x4 out), global average pool, a 1000-way
Dense.  Departures, as the configuration lists them: "SAME" padding as
XLA splits it (the odd pixel after), BatchNorm eps 1e-5 and momentum
0.99 with the biased variance in the running statistics.

Tensors are named as the program's state dict names them, so the
harness hands one dict of weights to both sides; nothing here imports
the program.  Every matrix product runs in float32 with TF32 off
(`exact_f32`); `quant="fp8"` reads every convolution and Dense operand
in fp8 (`_lowp.py`), the control of `correct`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from cellbench.reference import _lowp, _optim


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def blocks(cfg: dict) -> list:
    """(name, n_in, filters, stride) of every bottleneck block in order."""
    out, n_in, k = [], 64, 0
    for i, (n, w) in enumerate(zip(cfg["stage_sizes"], cfg["widths"])):
        for b in range(n):
            stride = 2 if b == 0 and i > 0 else 1
            out.append((f"ResNetBottleneckBlock_{k}", n_in, w, stride))
            n_in, k = 4 * w, k + 1
    return out


def shapes(cfg: dict) -> dict:
    """Every tensor's name and shape, in a fixed order."""
    c = cfg["channels"]
    s = {"stem_conv.weight": (64, c, 7, 7)}
    s.update({f"BatchNorm_0.{leaf}": (64,) for leaf in
              ("scale", "bias", "mean", "var")})
    for name, n_in, w, stride in blocks(cfg):
        convs = [(n_in, w, 1), (w, w, 3), (w, 4 * w, 1)]
        if stride != 1 or n_in != 4 * w:
            convs.append((n_in, 4 * w, 1))
        for j, (ci, co, k) in enumerate(convs):
            s[f"{name}.Conv_{j}.weight"] = (co, ci, k, k)
            for leaf in ("scale", "bias", "mean", "var"):
                s[f"{name}.BatchNorm_{j}.{leaf}"] = (co,)
    s["out.weight"] = (cfg["num_classes"], 4 * cfg["widths"][-1])
    s["out.bias"] = (cfg["num_classes"],)
    return s


def port_state(W: dict, cfg: dict) -> dict:
    """The program's state dict: the weights are named as it names them."""
    return W


def is_stat(name: str) -> bool:
    return name.endswith(".mean") or name.endswith(".var")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Seeded float32 weights, drawn on `device` in one call: convs He
    normal (variance 2 / fan in), BatchNorm scales about 1 (about 0.25 on
    each block's last, so the residual stream grows slowly), small biases
    and running means, running variances about 1, the Dense layer
    variance 1 / fan in."""
    sh = shapes(cfg)
    sizes = [int(torch.Size(v).numel()) for v in sh.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(sh.items(), flat.split(sizes)):
        z = part.view(shape)
        leaf = name.rsplit(".", 1)[1]
        if name.endswith(".weight") and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            t = z * (2.0 / fan_in) ** 0.5
        elif name == "out.weight":
            t = z * shape[1] ** -0.5
        elif leaf == "scale":
            t = (0.25 + 0.05 * z) if ".BatchNorm_2." in name else 1 + 0.1 * z
        elif leaf == "var":
            t = torch.exp(0.2 * z)
        else:   # bias, mean
            t = 0.05 * z
        out[name] = t.contiguous()
    return out


def _pads(size: int, k: int, s: int) -> tuple:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    ph, pw = _pads(x.shape[2], k, s), _pads(x.shape[3], k, s)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _conv(x, w, stride: int, quant):
    return F.conv2d(_lowp.operand(_same(x, w.shape[-1], stride), quant),
                    _lowp.operand(w, quant), stride=stride)


def _per_channel(v):
    return v[None, :, None, None]


def _bn(x, W, prefix, cfg, train: bool, moved: Optional[dict]):
    scale, bias = W[f"{prefix}.scale"], W[f"{prefix}.bias"]
    if train:
        mean = x.mean((0, 2, 3))
        var = ((x - _per_channel(mean)) ** 2).mean((0, 2, 3))
        m = cfg["bn_momentum"]
        with torch.no_grad():
            moved[f"{prefix}.mean"] = m * W[f"{prefix}.mean"] + (1 - m) * mean
            moved[f"{prefix}.var"] = m * W[f"{prefix}.var"] + (1 - m) * var
    else:
        mean, var = W[f"{prefix}.mean"], W[f"{prefix}.var"]
    inv = torch.rsqrt(var + cfg["bn_eps"])
    return (x - _per_channel(mean)) * _per_channel(inv * scale) \
        + _per_channel(bias)


def logits(W: dict, images: torch.Tensor, cfg: dict, quant=None,
           train: bool = False, moved: Optional[dict] = None):
    """Logits (N, classes) of uint8 images (N, H, W, C); in training the
    batch's statistics normalize and the moved running statistics go to
    `moved`."""
    x = images.permute(0, 3, 1, 2).float()
    x = F.relu(_bn(_conv(x, W["stem_conv.weight"], 2, quant), W,
                   "BatchNorm_0", cfg, train, moved))
    x = F.max_pool2d(_same(x, 3, 2, float("-inf")), 3, 2)
    for name, n_in, w, stride in blocks(cfg):
        y = F.relu(_bn(_conv(x, W[f"{name}.Conv_0.weight"], 1, quant), W,
                       f"{name}.BatchNorm_0", cfg, train, moved))
        y = F.relu(_bn(_conv(y, W[f"{name}.Conv_1.weight"], stride, quant),
                       W, f"{name}.BatchNorm_1", cfg, train, moved))
        y = _bn(_conv(y, W[f"{name}.Conv_2.weight"], 1, quant), W,
                f"{name}.BatchNorm_2", cfg, train, moved)
        if f"{name}.Conv_3.weight" in W:
            x = _bn(_conv(x, W[f"{name}.Conv_3.weight"], stride, quant), W,
                    f"{name}.BatchNorm_3", cfg, train, moved)
        x = F.relu(y + x)
    pool = x.mean((2, 3))
    return F.linear(_lowp.operand(pool, quant),
                    _lowp.operand(W["out.weight"], quant), W["out.bias"])


@torch.no_grad()
def score(W: dict, images: torch.Tensor, cfg: dict, quant=None,
          rows: int = 256) -> torch.Tensor:
    """Inference logits, `rows` images at a time."""
    with exact_f32():
        return torch.cat([logits(W, images[i:i + rows], cfg, quant)
                          for i in range(0, len(images), rows)])


def train_steps(W: dict, batches: list, cfg: dict, recipe: dict,
                quant=None, half: bool = False, rows: int = 0) -> dict:
    """Steps of softmax cross-entropy training from `W` over `batches`
    ((uint8 images, int labels) on the weights' device): each step's loss,
    the first step's gradient of every parameter, and every leaf's change
    (parameters and running statistics) over all the steps.  `half`
    trains on the first half of each batch (a fault the check must
    catch).  A step runs on its whole batch (`rows` is not read):
    BatchNorm's statistics are the batch's."""
    params = {n: t.clone().requires_grad_(True) for n, t in W.items()
              if not is_stat(n)}
    stats = {n: t.clone() for n, t in W.items() if is_stat(n)}
    state = _optim.init(params, recipe)
    losses, first = [], {}
    with exact_f32():
        for step, (x, y) in enumerate(batches):
            if half:
                x, y = x[:len(x) // 2], y[:len(y) // 2]
            moved: dict = {}
            out = logits({**params, **stats}, x, cfg, quant, True, moved)
            loss = F.cross_entropy(out, y.long())
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            losses.append(float(loss.detach()))
            if step == 0:
                first = {n: g.detach().clone() for n, g in grads.items()}
            _optim.update(params, grads, state, recipe)
            stats.update(moved)
    change = {n: (params[n].detach() if n in params else stats[n]) - W[n]
              for n in W}
    return {"losses": losses, "grad": first, "change": change}


def leaf_norms(tensors: dict) -> dict:
    """{name: float32 L2 norm}, fetched in one copy."""
    names = list(tensors)
    norms = torch.stack([tensors[n].detach().float().norm() for n in names])
    return dict(zip(names, norms.cpu().tolist()))
