"""Synthetic data (counterpart of ``repro/data/synthetic.py``): generated
from seeds, so nothing is downloaded.

* MNIST stand-in images: class-conditional blob patterns plus noise, 28 x
  28, 10 classes -- enough structure to reproduce the paper's accuracy
  against input bits trend.  Drawn by the reference's numpy calls in the
  reference's order, so the images and labels are bit for bit the
  reference's; only the return is a pair of tensors on ``device``.

The LM token stream (``lm_batch``) draws from ``jax.random`` in the
reference, so it cannot be reproduced bit for bit here; it comes with the
training slice of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _class_prototypes(num_classes: int, seed: int) -> np.ndarray:
    """Classes share a stroke pool and differ only in mixing weights: the
    subtle differences make low-bit input quantisation measurably hurt."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28]
    pool = []
    for _ in range(12):  # shared strokes
        cy, cx = rng.uniform(4, 24, 2)
        sy, sx = rng.uniform(1.5, 5.0, 2)
        rho = rng.uniform(-0.6, 0.6)
        d = ((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2 - 2 * rho * (
            (yy - cy) / sy
        ) * ((xx - cx) / sx)
        pool.append(np.exp(-d / 2))
    pool = np.stack(pool)
    weights = rng.dirichlet(np.ones(len(pool)) * 0.8, size=num_classes)
    protos = np.einsum("kp,phw->khw", weights.astype(np.float32), pool)
    protos /= protos.max(axis=(1, 2), keepdims=True) + 1e-6
    return protos.astype(np.float32)


_PROTO_CACHE: dict[int, np.ndarray] = {}


def image_batch(
    batch: int,
    step: int,
    seed: int = 0,
    noise: float = 0.25,
    device: str | torch.device = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> images ``(B, 28, 28)`` float32 in [0, 1] and labels ``(B,)``
    int32 on ``device``, deterministic in ``(batch, step, seed, noise)``."""
    dev = resolve_device(device)
    if seed not in _PROTO_CACHE:
        _PROTO_CACHE[seed] = _class_prototypes(10, seed + 777)
    protos = _PROTO_CACHE[seed]
    rng = np.random.default_rng(seed * 100_003 + step)
    labels = rng.integers(0, 10, size=batch)
    imgs = protos[labels]
    # random shift +- 2 px and noise
    out = np.zeros_like(imgs)
    for i in range(batch):
        dy, dx = rng.integers(-2, 3, 2)
        out[i] = np.roll(np.roll(imgs[i], dy, 0), dx, 1)
    out = np.clip(out + rng.normal(0, noise, out.shape), 0, 1).astype(np.float32)
    return (
        torch.from_numpy(out).to(dev),
        torch.from_numpy(labels.astype(np.int32)).to(dev),
    )
