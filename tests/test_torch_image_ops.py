"""The port's image ops (`mmlspark_tpu_torch/ops/image.py`) against the
JAX package's on the CPU: every op, every resize method string at up,
down, mixed and same scale, even and odd windows, uint8 and float
inputs, and the output dtypes.

Tolerances, absolute on the [0, 255] scale of the outputs: resize within
1e-2 (the linear antialiased filters of torch and jax.image round apart
by ~3e-3 at 320 x 240 -> 224 x 224), blur and gaussian within 1e-3; the
gray conversion and normalize within 1e-5 of max |ref| (three products
summed in another order); the rest exact.  The JAX side runs once, on
threads, in a module fixture.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from mmlspark_tpu.ops import image as jops
from mmlspark_tpu_torch.ops import image as ops

RNG = np.random.default_rng(0)
U8 = RNG.integers(0, 256, (2, 32, 24, 3), dtype=np.uint8)
F32 = RNG.uniform(0, 255, (2, 32, 24, 3)).astype(np.float32)
BIG = RNG.integers(0, 256, (2, 240, 320, 3), dtype=np.uint8)
GRAY = U8[..., :1].copy()

METHODS = ("nearest", "linear", "bilinear", "trilinear", "triangle",
           "cubic", "bicubic", "tricubic", "lanczos3", "lanczos5")
SIZES = {"down": (16, 12), "up": (40, 30), "same": (32, 24),
         "mixed": (40, 12), "width_only": (32, 20)}
RESIZE_CASES = [(m, s) for m in METHODS for s in SIZES]


def resize_case(m, s, lib):
    src = U8 if m != "linear" or s != "down" else F32
    return lib.resize(src, *SIZES[s], m)




def of_max(frac: float) -> tuple:
    """A limit of `frac` of max |ref| (at least `frac`)."""
    return ("of_max", frac)


# name -> (JAX call, port call on the CPU, limit): None is exact, a float an
# absolute limit on the [0, 255] scale, `of_max(f)` a share of max |ref|
OP_CASES = {
    "resize_big_down": (lambda: jops.resize(BIG, 224, 224),
                        lambda: ops.resize(BIG, 224, 224, device="cpu"),
                        1e-2),
    "resize_big_mixed": (lambda: jops.resize(BIG, 256, 256),
                         lambda: ops.resize(BIG, 256, 256, device="cpu"),
                         1e-2),
    "crop": (lambda: jops.crop(U8, 2, 3, 10, 7),
             lambda: ops.crop(U8, 2, 3, 10, 7, device="cpu"), None),
    "center_crop_f32": (lambda: jops.center_crop(F32, 20, 20),
                        lambda: ops.center_crop(F32, 20, 20, device="cpu"),
                        None),
    "center_crop_larger": (lambda: jops.center_crop(U8, 40, 10),
                           lambda: ops.center_crop(U8, 40, 10, device="cpu"),
                           None),
    "bgr2rgb": (lambda: jops.cvt_color(U8, "bgr2rgb"),
                lambda: ops.cvt_color(U8, "bgr2rgb", device="cpu"), None),
    "rgb2bgr": (lambda: jops.cvt_color(F32, "rgb2bgr"),
                lambda: ops.cvt_color(F32, "rgb2bgr", device="cpu"), None),
    "bgr2gray": (lambda: jops.cvt_color(U8, "bgr2gray"),
                 lambda: ops.cvt_color(U8, "bgr2gray", device="cpu"),
                 of_max(1e-5)),
    "rgb2gray": (lambda: jops.cvt_color(F32, "rgb2gray"),
                 lambda: ops.cvt_color(F32, "rgb2gray", device="cpu"),
                 of_max(1e-5)),
    "gray2bgr": (lambda: jops.cvt_color(GRAY, "gray2bgr"),
                 lambda: ops.cvt_color(GRAY, "gray2bgr", device="cpu"), None),
    "gray2rgb": (lambda: jops.cvt_color(GRAY, "gray2rgb"),
                 lambda: ops.cvt_color(GRAY, "gray2rgb", device="cpu"), None),
    "unroll": (lambda: jops.unroll(U8),
               lambda: ops.unroll(U8, device="cpu"), None),
    "normalize": (lambda: jops.normalize(U8),
                  lambda: ops.normalize(U8, device="cpu"), of_max(1e-5)),
    "normalize_mean_std": (
        lambda: jops.normalize(U8, np.array([.4, .5, .6], np.float32),
                               np.array([.2, .3, .25], np.float32)),
        lambda: ops.normalize(U8, [.4, .5, .6], [.2, .3, .25],
                              device="cpu"), of_max(1e-5)),
}
for _k in ((3, 3), (4, 4), (5, 2), (2, 6), (1, 1), (4.0, 3.0)):
    OP_CASES[f"blur_{_k[0]}x{_k[1]}"] = (
        lambda k=_k: jops.blur(F32, int(k[0]), int(k[1])),
        lambda k=_k: ops.blur(F32, k[0], k[1], device="cpu"), 1e-3)
    OP_CASES[f"blur_u8_{_k[0]}x{_k[1]}"] = (
        lambda k=_k: jops.blur(U8, int(k[0]), int(k[1])),
        lambda k=_k: ops.blur(U8, k[0], k[1], device="cpu"), 1e-3)
for _a in (3, 4, 5, 6):
    OP_CASES[f"gaussian_kernel_{_a}"] = (
        lambda a=_a: jops.gaussian_kernel(U8, a, 1.5),
        lambda a=_a: ops.gaussian_kernel(U8, a, 1.5, device="cpu"), 1e-3)
    OP_CASES[f"gaussian_blur_{_a}_auto_sigma"] = (
        lambda a=_a: jops.gaussian_blur(F32, a, 0.0),
        lambda a=_a: ops.gaussian_blur(F32, a, 0.0, device="cpu"), 1e-3)
for _kind in ("binary", "binary_inv", "trunc", "tozero", "tozero_inv"):
    OP_CASES[f"threshold_{_kind}"] = (
        lambda kd=_kind: jops.threshold(U8, 100.0, 255.0, kd),
        lambda kd=_kind: ops.threshold(U8, 100.0, 255.0, kd, device="cpu"),
        None)
    OP_CASES[f"threshold_f32_{_kind}"] = (
        lambda kd=_kind: jops.threshold(F32, 100.5, 200.0, kd),
        lambda kd=_kind: ops.threshold(F32, 100.5, 200.0, kd, device="cpu"),
        None)
for _code in (0, 1, -1):
    OP_CASES[f"flip_{_code}"] = (
        lambda c=_code: jops.flip(U8, c),
        lambda c=_code: ops.flip(U8, c, device="cpu"), None)


@pytest.fixture(scope="module")
def jax_refs():
    jobs = {("resize", m, s): (lambda m=m, s=s: resize_case(m, s, jops))
            for m, s in RESIZE_CASES}
    jobs.update({("op", name): case[0] for name, case in OP_CASES.items()})
    with ThreadPoolExecutor(8) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: np.asarray(f.result()) for k, f in futures.items()}


def check(got: torch.Tensor, ref: np.ndarray, tol) -> None:
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        got.shape, ref.shape, got.dtype, ref.dtype)
    if tol is None:
        np.testing.assert_array_equal(got, ref)
        return
    err = float(np.abs(got - ref).max())
    if isinstance(tol, tuple):
        assert err <= tol[1] * max(1.0, float(np.abs(ref).max())), err
    else:
        assert err <= tol, err


@pytest.mark.parametrize("method,size", RESIZE_CASES)
def test_resize_matches_jax_image(jax_refs, method, size):
    ref = jax_refs[("resize", method, size)]
    got = resize_case(method, size, _PortOps)
    check(got, ref, None if method == "nearest" or size == "same" else 1e-2)


class _PortOps:
    """The port's resize with the CPU chosen, in the JAX call's shape."""

    @staticmethod
    def resize(src, h, w, method):
        return ops.resize(src, h, w, method, device="cpu")


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_matches_jax(jax_refs, name):
    check(OP_CASES[name][1](), jax_refs[("op", name)], OP_CASES[name][2])


def test_output_dtypes_follow_the_jax_package():
    """Everything but crop, center_crop and flip widens uint8 to float32
    (a channel swap too); float64 numpy narrows to float32."""
    kept = {ops.crop(U8, 0, 0, 4, 4, device="cpu").dtype,
            ops.center_crop(U8, 4, 4, device="cpu").dtype,
            ops.flip(U8, 1, device="cpu").dtype}
    assert kept == {torch.uint8}
    widened = {ops.cvt_color(U8, "bgr2rgb", device="cpu").dtype,
               ops.resize(U8, 32, 24, device="cpu").dtype,
               ops.threshold(U8, 1.0, 2.0, device="cpu").dtype,
               ops.blur(U8, 1, 1, device="cpu").dtype,
               ops.resize(U8.astype(np.float64), 8, 8, device="cpu").dtype}
    assert widened == {torch.float32}


def test_chip_smokes_planted_faults_are_not_the_jax_ops():
    """The two image faults chip_smoke must reject (a resize without the
    antialiasing filter, a 4 x 4 blur whose "SAME" padding is mirrored)
    differ from the JAX package far beyond the ops' tolerances, while the
    port's ops stay within them: XLA pads an even window (1, 2)."""
    assert ops.same_pads(4) == (1, 2) and ops.same_pads(5) == (2, 2)
    big = torch.from_numpy(BIG).float()
    ref = np.asarray(jops.resize(BIG, 224, 224))
    assert np.abs(chip_smoke.unfiltered_resize(big, 224, 224).numpy()
                  - ref).max() > 10.0
    ref = np.asarray(jops.blur(F32, 4, 4))
    wrong = chip_smoke.mirrored_blur(torch.from_numpy(F32), 4).numpy()
    assert np.abs(wrong - ref).max() > 1.0
    assert np.abs(ops.blur(F32, 4, 4, device="cpu").numpy()
                  - ref).max() <= 1e-3


def test_unknown_names_raise_and_numpy_defaults_to_the_card(monkeypatch):
    with pytest.raises(ValueError, match="Unknown resize method"):
        ops.resize(U8, 4, 4, "area", device="cpu")
    with pytest.raises(ValueError, match="color conversion"):
        ops.cvt_color(U8, "bgr2hsv", device="cpu")
    with pytest.raises(ValueError, match="threshold type"):
        ops.threshold(U8, 1.0, 2.0, "otsu", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.resize(U8, 4, 4)
    # a tensor stays on its own device
    assert ops.flip(torch.from_numpy(U8)).device.type == "cpu"


def test_gaussian_kernel_1d_is_the_jax_packages():
    for size, sigma in ((5, 1.0), (4, 0.0), (7, 2.5)):
        np.testing.assert_array_equal(ops.gaussian_kernel_1d(size, sigma),
                                      jops.gaussian_kernel_1d(size, sigma))


def test_chip_smokes_tf32_fault_lifts_the_guard_and_restores_it():
    """`chip_smoke.tf32_allowed` (the TF32 control's setting) turns TF32 on
    and takes `exact_f32` away from the image ops only inside its block;
    on the CPU, where TF32 does nothing, the fault equals the sound op."""
    from mmlspark_tpu_torch.core.device import exact_f32
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    flags = cudnn.allow_tf32, matmul.allow_tf32
    with chip_smoke.tf32_allowed():
        assert cudnn.allow_tf32 and matmul.allow_tf32
        assert ops.exact_f32 is not exact_f32
    assert ops.exact_f32 is exact_f32
    assert (cudnn.allow_tf32, matmul.allow_tf32) == flags
    x = torch.from_numpy(F32)
    np.testing.assert_array_equal(
        chip_smoke.tf32_lanczos(x, 16, 12).numpy(),
        ops.resize(x, 16, 12, "lanczos3").numpy())
