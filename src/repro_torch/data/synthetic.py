"""Synthetic data (counterpart of ``repro/data/synthetic.py``): generated
from seeds, so nothing is downloaded.

* LM token streams (:func:`lm_batch`): a seeded order-1 Markov chain over the
  vocabulary with a Zipf-like stationary distribution, deterministic in
  ``(seed, step)``: a restarted or replayed step regenerates identical
  batches.  The reference draws them from ``jax.random``; this module runs
  the same counter-based generator, threefry-2x32 in JAX's partitionable
  layout, in integer arithmetic on ``device``, so its keys, random bits,
  uniforms and ``repeat`` mask are the reference's bit for bit.  The
  categorical draw is Gumbel-max over ``-log(-log(u))``, whose fp32 ``log``
  may differ from XLA's in the last bit: a token can differ only where two
  candidates' ``logits + gumbel`` tie to within a few ulp.
* MNIST stand-in images: class-conditional blob patterns plus noise, 28 x
  28, 10 classes -- enough structure to reproduce the paper's accuracy
  against input bits trend.  Drawn by the reference's numpy calls in the
  reference's order, so the images and labels are bit for bit the
  reference's; only the return is a pair of tensors on ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# threefry-2x32 (JAX's default PRNG) on int32 tensors holding uint32 bits
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements per chunk of a large draw: bounds the temporaries to ~64 MiB each
_CHUNK = 1 << 24


def _i32(v: int) -> int:
    """The int32 holding the bits of ``v``'s low 32 bits."""
    v &= _M32
    return v - (1 << 32) if v >> 31 else v


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    # the right shift is arithmetic: keep only the bits rotated in
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 block cipher (20 rounds) of the count pairs
    ``(x0, x1)`` under ``key``: int32 tensors holding uint32 bits in (their
    additions wrap, as uint32's do), the same out."""
    ks = (_i32(key[0]), _i32(key[1]), _i32(key[0] ^ key[1] ^ 0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + _i32(ks[(i + 2) % 3] + i + 1)
    return x0, x1


def _hash_pair(key: tuple[int, int], hi: int, lo: int) -> tuple[int, int]:
    y0, y1 = threefry2x32(key, torch.tensor([_i32(hi)], dtype=torch.int32),
                          torch.tensor([_i32(lo)], dtype=torch.int32))
    return int(y0) & _M32, int(y1) & _M32


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)``'s two words."""
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in``: the cipher of the count pair ``(0, data)``."""
    return _hash_pair(key, 0, data)


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split`` under ``jax_threefry_partitionable``: key ``i``
    is the cipher of the count pair ``(0, i)``."""
    return [_hash_pair(key, 0, i) for i in range(num)]


def random_bits(key: tuple[int, int], start: int, count: int, device) -> torch.Tensor:
    """Elements ``start .. start + count - 1`` (flat, row-major) of
    ``jax.random.bits(key, shape)`` for any shape holding them, as an int32
    tensor of their bits: the cipher of each element's 64-bit flat index
    split into (high, low) words, its two outputs xor-ed."""
    n = torch.arange(start, start + count, dtype=torch.int64, device=device)
    hi = (n >> 32).to(torch.int32)
    lo = (((n & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)
    y0, y1 = threefry2x32(key, hi, lo)
    return y0 ^ y1


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's fp32 uniform in [0, 1): the top 23 bits as the mantissa of a
    float in [1, 2), minus 1 (exact)."""
    return (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0


def categorical(key: tuple[int, int], logits: torch.Tensor, rows: int) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=(rows,))`` for 1-D
    ``logits`` of V classes: per row the first argmax of ``logits + g``, g
    Gumbel noise ``-log(-log(u))`` from the uniforms of elements
    ``row * V .. row * V + V - 1``; u is the reference's ``uniform(minval=
    tiny, maxval=1)``, which is the uniform with 0 raised to fp32's tiny
    (``u * (1 - tiny) + tiny`` rounds to ``u`` for every other value).
    Drawn in chunks of rows; returns (rows,) int64."""
    V = logits.shape[-1]
    tiny = torch.finfo(torch.float32).tiny
    per = max(1, _CHUNK // V)
    out = []
    for r0 in range(0, rows, per):
        n = min(per, rows - r0)
        u = uniform_from_bits(random_bits(key, r0 * V, n * V, logits.device))
        g = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
        out.append(torch.argmax(g.reshape(n, V) + logits, dim=-1))
    return torch.cat(out)


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int  # per host
    seed: int = 0


def lm_logits(vocab_size: int, device) -> torch.Tensor:
    """The stream's Zipf-like class logits, ``-1.1 * log(rank)`` in fp32."""
    ranks = torch.arange(1, vocab_size + 1, dtype=torch.float32, device=device)
    return -1.1 * torch.log(ranks)


def lm_batch(cfg: LMStreamConfig, step: int, device: str | torch.device = "cuda") -> dict:
    """Deterministic ``(seed, step)`` -> ``{"tokens", "labels"}``, each
    ``(batch_size, seq_len)`` int32 on ``device``: a Zipf-like base draw,
    and with probability 0.3 each position repeats the previous draw (the
    Markov structure), as the reference draws them."""
    dev = resolve_device(device)
    B, S, V = cfg.batch_size, cfg.seq_len, cfg.vocab_size
    k1, k2 = split(fold_in(prng_key(cfg.seed), step))
    base = categorical(k1, lm_logits(V, dev), B * (S + 1)).reshape(B, S + 1)
    repeat = uniform_from_bits(random_bits(k2, 0, B * (S + 1), dev)) < torch.tensor(
        0.3, dtype=torch.float32, device=dev
    )
    toks = torch.where(repeat.reshape(B, S + 1), torch.roll(base, 1, dims=1), base)
    toks = toks.to(torch.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


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
