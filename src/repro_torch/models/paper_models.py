"""The paper's own example networks (counterpart of
``repro/models/paper_models.py``): the linear classifier, the
784-1024-512-10 MLP and the LeNet-style CNN of the TF tutorial, built on
the same :func:`~repro_torch.models.layers.linear` as the decoder, so the
TableNet conversion applies verbatim and a converted node runs the LUT
kernels (``_lut_apply`` / ``_tl1_apply``).

Convolutions are im2col + linear: the weight matrix is shared across
spatial positions, which is the paper's "same LUT for every chunk, output
shifted and added" convolution.  :func:`im2col` keeps the reference's
patch order (``i``-major, then ``j``, channels last), so conv weights
carried across from the reference mean the same thing here.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import get_config
from repro_torch.core.quantize import FixedPointFormat
from repro_torch.models.layers import Ctx, ExecCfg, linear, linear_spec
from repro_torch.models.params import tree_map


def linear_classifier_specs() -> dict:
    return {"fc": linear_spec(784, 10, axes=(None, None), bias=True)}


def linear_classifier_forward(params, images: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """images: (B, 28, 28) in [0, 1] -> logits (B, 10)."""
    x = images.reshape(images.shape[0], -1)
    return linear(params["fc"], x, ctx)


def mlp_specs() -> dict:
    return {
        "fc1": linear_spec(784, 1024, axes=(None, None), bias=True),
        "fc2": linear_spec(1024, 512, axes=(None, None), bias=True),
        "fc3": linear_spec(512, 10, axes=(None, None), bias=True),
    }


def mlp_forward(params, images: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    x = images.reshape(images.shape[0], -1)
    x = torch.relu(linear(params["fc1"], x, ctx))
    x = torch.relu(linear(params["fc2"], x, ctx))
    return linear(params["fc3"], x, ctx)


# ---------------------------------------------------------------------------
# LeNet-style CNN (conv 5x5x32 -> pool -> conv 5x5x64 -> pool -> fc -> fc)
# ---------------------------------------------------------------------------


def im2col(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, k*k*C) 'same' patches (zero-padded)."""
    B, H, W, C = x.shape
    pad = k // 2
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    cols = [xp[:, i : i + H, j : j + W, :] for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1)


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def lenet_specs() -> dict:
    return {
        "conv1": linear_spec(25, 32, axes=(None, None), bias=True),
        "conv2": linear_spec(25 * 32, 64, axes=(None, None), bias=True),
        "fc1": linear_spec(3136, 1024, axes=(None, None), bias=True),
        "fc2": linear_spec(1024, 10, axes=(None, None), bias=True),
    }


def lenet_forward(params, images: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """images: (B, 28, 28) -> logits (B, 10)."""
    x = images[..., None]  # (B, 28, 28, 1)
    x = torch.relu(linear(params["conv1"], im2col(x, 5), ctx))
    x = maxpool2(x)  # (B, 14, 14, 32)
    x = torch.relu(linear(params["conv2"], im2col(x, 5), ctx))
    x = maxpool2(x)  # (B, 7, 7, 64)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(linear(params["fc1"], x, ctx))
    return linear(params["fc2"], x, ctx)


PAPER_MODELS = {
    "linear": (linear_classifier_specs, linear_classifier_forward),
    "mlp": (mlp_specs, mlp_forward),
    "lenet": (lenet_specs, lenet_forward),
}


# ---------------------------------------------------------------------------
# training and evaluation helpers of the paper's recipes
# ---------------------------------------------------------------------------


def paper_ctx(**ex) -> Ctx:
    """The paper models' context (its model config is unused by them)."""
    return Ctx(get_config("granite_8b", reduced=True), ex=ExecCfg(**ex))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``-mean(sum(log_softmax(logits) * one_hot(labels)))``, the
    reference's loss."""
    onehot = F.one_hot(labels.to(torch.int64), logits.shape[-1]).to(logits.dtype)
    return -(F.log_softmax(logits, dim=-1) * onehot).sum(-1).mean()


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def sgd(
    params: dict,
    forward: Callable,
    ctx: Ctx,
    batches: Iterable[tuple[torch.Tensor, torch.Tensor]],
    lr: float,
) -> dict:
    """Plain SGD over ``batches``: ``p <- p - lr * grad`` for every leaf,
    on a copy of ``params``; returns the trained tree, detached."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = _leaves(params)
    for x, y in batches:
        loss = cross_entropy(forward(params, x, ctx), y)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for a, g in zip(leaves, grads):
                a.sub_(lr * g)
    return tree_map(lambda t: t.detach(), params)


def quantize_inputs(x: torch.Tensor, bits: int | None) -> torch.Tensor:
    """``x`` on the ``bits``/``bits`` unsigned fixed-point grid in [0, 1)
    (``None`` leaves it as it is)."""
    if bits is None:
        return x
    fmt = FixedPointFormat(bits, bits)
    return fmt.dequantize(fmt.quantize(x))
