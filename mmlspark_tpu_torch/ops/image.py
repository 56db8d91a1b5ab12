"""Batched image ops (the port of `mmlspark_tpu/ops/image.py`).

Conventions as in the JAX package: NHWC layout, uint8 or float32 in
[0, 255], BGR channel order.  Every op runs on its input tensor's device;
a numpy input is moved to `device` first (default the card, as every
entry point of the port).  The JAX package left these ops to XLA, so here
they are plain torch ops: no hand-written kernel lies on this path.

Dtypes follow the JAX package: every op but `crop`, `center_crop` and
`flip` widens its input to float32 first (`_as_float`), so a channel swap
of a uint8 image comes back float32.  A float64 or int64 numpy input is
narrowed to float32 / int32 first, as JAX without x64 places it.

Where `jax.image` and torch part:
  * `resize` antialiases when it downsamples (jax.image's scale-aware
    kernels).  "linear" and "cubic" are `F.interpolate` with
    `antialias=True`; "nearest" gathers the rows and columns jax.image
    picks; "lanczos3" / "lanczos5" have no torch mode and apply
    jax.image's per-axis weight matrices, built on the host, as two
    matmuls.  An axis whose size does not change is left alone.
  * `blur` and `gaussian_kernel` pad "SAME" as XLA does: an even window
    puts (k - 1) // 2 on the low side and k // 2 on the high side.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mmlspark_tpu_torch.core.device import exact_f32, resolve_device

# OpenCV luma weights for BGR -> gray (cvtColor COLOR_BGR2GRAY)
_BGR_LUMA = (0.114, 0.587, 0.299)

# threshold types (Imgproc.THRESH_*)
THRESH_BINARY = "binary"
THRESH_BINARY_INV = "binary_inv"
THRESH_TRUNC = "trunc"
THRESH_TOZERO = "tozero"
THRESH_TOZERO_INV = "tozero_inv"

# every method string jax.image.resize accepts -> its kernel
_RESIZE_METHODS = {
    "nearest": "nearest",
    "linear": "linear", "bilinear": "linear", "trilinear": "linear",
    "triangle": "linear",
    "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic",
    "lanczos3": "lanczos3", "lanczos5": "lanczos5",
}


def as_images(images, device=None) -> torch.Tensor:
    """`images` as a tensor: a tensor stays where it is (`device` moves
    it when given); a numpy array goes to `device` (default the card).
    float64 and int64 narrow to float32 and int32."""
    if isinstance(images, torch.Tensor):
        x = images if device is None else images.to(resolve_device(device))
    else:
        arr = np.asarray(images)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        elif arr.dtype == np.int64:
            arr = arr.astype(np.int32)
        x = torch.from_numpy(np.ascontiguousarray(arr)).to(
            resolve_device("cuda" if device is None else device))
    if x.dtype == torch.float64:
        x = x.float()
    elif x.dtype == torch.int64:
        x = x.int()
    return x


def _as_float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.float()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """jax.image's nearest sample of each output index, computed in
    float32 as jax.image computes it."""
    offsets = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
               * np.float32(n_in) / np.float32(n_out))
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def _lanczos(radius: float, x: np.ndarray) -> np.ndarray:
    y = radius * np.sin(np.pi * x) * np.sin(np.pi * x / radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(x > 1e-3,
                       y / np.where(x != 0, np.pi ** 2 * x ** 2, 1), 1)
    return np.where(x > radius, 0.0, out)


def resize_weights(n_in: int, n_out: int, method: str) -> np.ndarray:
    """(n_in, n_out) float32 weight matrix of one axis, as
    `jax.image.scale_and_translate` builds it (antialiased, translation
    0, scale n_out / n_in)."""
    radius = {"lanczos3": 3.0, "lanczos5": 5.0}[method]
    inv_scale = np.float32(n_in / n_out)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = (np.abs(sample_f[None, :]
                - np.arange(n_in, dtype=np.float32)[:, None])
         / kernel_scale).astype(np.float32)
    weights = _lanczos(radius, x).astype(np.float32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize(images, height: int, width: int, method: str = "linear", *,
           device=None) -> torch.Tensor:
    """Batched resize to (height, width), float32 out (module
    docstring)."""
    if method not in _RESIZE_METHODS:
        raise ValueError(f'Unknown resize method "{method}"')
    kind = _RESIZE_METHODS[method]
    x = _as_float(as_images(images, device))
    h_in, w_in = int(x.shape[1]), int(x.shape[2])
    height, width = int(height), int(width)
    if (h_in, w_in) == (height, width):
        return x
    if kind == "nearest":
        if h_in != height:
            x = x.index_select(1, torch.from_numpy(
                _nearest_index(h_in, height)).to(x.device))
        if w_in != width:
            x = x.index_select(2, torch.from_numpy(
                _nearest_index(w_in, width)).to(x.device))
        return x.contiguous()
    if kind in ("linear", "cubic"):
        mode = "bilinear" if kind == "linear" else "bicubic"
        return _nhwc(F.interpolate(_nchw(x), size=(height, width), mode=mode,
                                   align_corners=False, antialias=True))
    with exact_f32():
        if h_in != height:
            wh = torch.from_numpy(resize_weights(h_in, height, kind))
            x = torch.einsum("bhwc,hk->bkwc", x, wh.to(x.device))
        if w_in != width:
            ww = torch.from_numpy(resize_weights(w_in, width, kind))
            x = torch.einsum("bhwc,wk->bhkc", x, ww.to(x.device))
    return x.contiguous()


def crop(images, x: int, y: int, height: int, width: int, *,
         device=None) -> torch.Tensor:
    """Rectangle crop at (x, y) = (col, row), OpenCV Rect semantics; the
    dtype is kept."""
    t = as_images(images, device)
    return t[:, y:y + height, x:x + width, :]


def center_crop(images, height: int, width: int, *,
                device=None) -> torch.Tensor:
    t = as_images(images, device)
    h, w = int(t.shape[1]), int(t.shape[2])
    y, x = max((h - height) // 2, 0), max((w - width) // 2, 0)
    return t[:, y:y + height, x:x + width, :]


def cvt_color(images, code: str, *, device=None) -> torch.Tensor:
    """Color conversion: bgr2gray, rgb2gray, bgr2rgb, rgb2bgr, gray2bgr,
    gray2rgb.  Gray output keeps a single channel axis."""
    x = _as_float(as_images(images, device))
    if code == "bgr2gray":
        w = torch.tensor(_BGR_LUMA, dtype=x.dtype, device=x.device)
        return (x * w).sum(dim=-1, keepdim=True)
    if code == "rgb2gray":
        w = torch.tensor(_BGR_LUMA[::-1], dtype=x.dtype, device=x.device)
        return (x * w).sum(dim=-1, keepdim=True)
    if code in ("bgr2rgb", "rgb2bgr"):
        return x.flip(-1)
    if code in ("gray2bgr", "gray2rgb"):
        return x.repeat_interleave(3, dim=-1)
    raise ValueError(f"unknown color conversion '{code}'")


def same_pads(k: int) -> tuple:
    """XLA's "SAME" padding of a stride-1 window of `k`: (low, high)."""
    return (k - 1) // 2, k // 2


def _axis_counts(n: int, k: int) -> torch.Tensor:
    """Valid pixels under a "SAME" window of `k` at each of `n` places."""
    lo, _ = same_pads(k)
    start = np.arange(n) - lo
    return torch.from_numpy((np.minimum(start + k, n)
                             - np.maximum(start, 0)).astype(np.float32))


def blur(images, height: int, width: int, *, device=None) -> torch.Tensor:
    """Normalized box blur: the window's sum over its valid pixels,
    divided by their count ("SAME" padding)."""
    x = _as_float(as_images(images, device))
    height, width = int(height), int(width)
    (top, bottom), (left, right) = same_pads(height), same_pads(width)
    h, w = int(x.shape[1]), int(x.shape[2])
    padded = F.pad(_nchw(x), (left, right, top, bottom))
    summed = F.avg_pool2d(padded, (height, width), stride=1,
                          divisor_override=1)
    counts = (_axis_counts(h, height)[:, None]
              * _axis_counts(w, width)[None, :]).to(x.device)
    return _nhwc(summed / counts)


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    """OpenCV getGaussianKernel: ksize x 1 column kernel, normalized.
    sigma <= 0 uses OpenCV's auto rule 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2
    k = np.exp(-(r ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_kernel(images, aperture_size: int, sigma: float, *,
                    device=None) -> torch.Tensor:
    """The reference's gaussiankernel stage: filter2D with the ksize x 1
    column kernel, a VERTICAL 1-D gaussian, zero "SAME" padding."""
    x = _as_float(as_images(images, device))
    k = int(aperture_size)
    kernel = torch.from_numpy(gaussian_kernel_1d(k, sigma)).to(x.device)
    b, h, w, c = x.shape
    lo, hi = same_pads(k)
    planes = F.pad(_nchw(x).reshape(b * c, 1, h, w), (0, 0, lo, hi))
    with exact_f32():
        out = F.conv2d(planes, kernel.view(1, 1, k, 1))
    return _nhwc(out.reshape(b, c, h, w))


def gaussian_blur(images, size: int, sigma: float, *,
                  device=None) -> torch.Tensor:
    """Full separable 2-D gaussian blur (the vertical pass, then the same
    pass over the transposed image)."""
    tmp = gaussian_kernel(images, size, sigma, device=device)
    return gaussian_kernel(tmp.transpose(1, 2), size, sigma).transpose(1, 2)


def threshold(images, thresh: float, max_val: float,
              kind: str = THRESH_BINARY, *, device=None) -> torch.Tensor:
    """Imgproc.threshold with a strict `>`; float32 out."""
    x = _as_float(as_images(images, device))
    above = x > thresh
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    top = torch.full((), max_val, dtype=x.dtype, device=x.device)
    if kind == THRESH_BINARY:
        return torch.where(above, top, zero)
    if kind == THRESH_BINARY_INV:
        return torch.where(above, zero, top)
    if kind == THRESH_TRUNC:
        return torch.minimum(x, torch.full((), thresh, dtype=x.dtype,
                                           device=x.device))
    if kind == THRESH_TOZERO:
        return torch.where(above, x, zero)
    if kind == THRESH_TOZERO_INV:
        return torch.where(above, zero, x)
    raise ValueError(f"unknown threshold type '{kind}'")


def flip(images, code: int = 1, *, device=None) -> torch.Tensor:
    """OpenCV flip: 0 = vertical (around x-axis), >0 horizontal, <0 both;
    the dtype is kept."""
    t = as_images(images, device)
    if code == 0:
        return t.flip(1)
    if code > 0:
        return t.flip(2)
    return t.flip(1, 2)


def unroll(images, *, device=None) -> torch.Tensor:
    """HWC -> flat CHW float32 vector per image: (B, H, W, C) ->
    (B, C*H*W)."""
    x = _as_float(as_images(images, device))
    return x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)


def normalize(images, mean: Optional[Sequence[float]] = None,
              std: Optional[Sequence[float]] = None, *,
              device=None) -> torch.Tensor:
    """Scale [0,255] -> [0,1], then optional per-channel standardization."""
    x = _as_float(as_images(images, device)) / 255.0
    if mean is not None:
        x = x - torch.as_tensor(np.asarray(mean), dtype=x.dtype,
                                device=x.device)
    if std is not None:
        x = x / torch.as_tensor(np.asarray(std), dtype=x.dtype,
                                device=x.device)
    return x
