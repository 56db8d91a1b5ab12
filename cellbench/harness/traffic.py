"""The one generator of inputs: a traffic mix's parameters and the seed
in, the same arrays out for the same seed, on any machine with the same
kind of device.  Every draw is one call on the device, copied to the host
once; each kind of input has its own stream of the seed."""

from __future__ import annotations

import numpy as np

_STREAMS = {"weights": 0, "images": 1, "labels": 2, "tokens": 3,
            "sample": 4}


def generator(seed: int, stream: str, device):
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + _STREAMS[stream] * 0x9E3779B97F4A7C15)
                    % (2 ** 63))
    return gen


def images(n: int, cfg: dict, seed: int, device) -> np.ndarray:
    """n uint8 images (n, size, size, channels)."""
    import torch
    s, c = cfg["image_size"], cfg["channels"]
    return torch.randint(0, 256, (n, s, s, c), dtype=torch.uint8,
                         generator=generator(seed, "images", device),
                         device=device).cpu().numpy()


def labels(n: int, classes: int, seed: int, device) -> np.ndarray:
    import torch
    return torch.randint(0, classes, (n,), generator=generator(
        seed, "labels", device), device=device).cpu().numpy()


def token_rows(n: int, seq: int, vocab: int, seed: int, device) -> tuple:
    """(inputs, next-token targets), each (n, seq) int64, from n sequences
    of seq + 1 uniform token ids."""
    import torch
    t = torch.randint(0, vocab, (n, seq + 1), generator=generator(
        seed, "tokens", device), device=device).cpu().numpy()
    return np.ascontiguousarray(t[:, :-1]), np.ascontiguousarray(t[:, 1:])


def sample(seed: int) -> np.random.Generator:
    """The stream that draws which outputs `correct` compares."""
    return np.random.default_rng([int(seed) % (2 ** 63), _STREAMS["sample"]])


class CyclicRows:
    """`n` rows that cycle through a pool (row i is pool[i % len(pool)]),
    indexed as a numpy array is: what `Trainer.fit_arrays` reads of its
    inputs (`len`, `shape`, `dtype`, `x[index array]`)."""

    def __init__(self, pool: np.ndarray, n: int):
        self.pool, self.n = pool, int(n)
        self.shape = (self.n,) + pool.shape[1:]
        self.dtype = pool.dtype

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx):
        return self.pool[np.asarray(idx) % len(self.pool)]
