"""LR schedules (counterpart of ``repro/optim/schedule.py``): linear warmup
then cosine decay to ``min_ratio * peak_lr``."""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np


@functools.cache
def _cosf():
    """The C library's single-precision ``cosf``, the function XLA:CPU
    calls for an fp32 ``cos``: within 0.56 ulp, not correctly rounded, so
    neither numpy's nor torch's fp32 cosine gives its bits."""
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.argtypes = [ctypes.c_float]
    libm.cosf.restype = ctypes.c_float
    return libm.cosf


def warmup_cosine(step: int, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> float:
    """The learning rate at ``step``, computed on the host in fp32 with the
    reference's operations in its order: each Python constant rounds to fp32
    where it meets the step, as JAX's weakly typed constants do."""
    f32 = np.float32
    s = f32(step)
    if s < f32(warmup_steps):
        return float(f32(peak_lr) * s / f32(max(warmup_steps, 1)))
    frac = np.clip((s - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(_cosf()(f32(np.pi) * frac))
    return float(f32(peak_lr) * (f32(min_ratio) + f32((1 - min_ratio) * 0.5) * (f32(1.0) + cos)))
