"""Parameter specs and initialisation (counterpart of
``repro/models/params.py``).

Models declare shapes as :class:`PSpec` trees (nested dicts); the runtime
materialises tensors on an explicit device from an explicit
``torch.Generator``.  :func:`params_from_numpy` carries a tree exported
from the JAX package (``jax.tree.map(np.asarray, params)``) across, so
both packages can run on the same weights -- converted trees included,
whose tables, scales and biases cross as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple[Any, ...]  # logical axis name (str) or None per dim
    init: str = "normal"  # normal | zeros | ones | embed
    scale: float | None = None  # stddev override for "normal"
    dtype: Any = None  # None -> model default

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of a nested dict (``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree)


def _fan_in(spec: PSpec) -> int:
    # convention: last axis is the output axis of a projection, so a
    # stacked (L, q, p) leaf counts L*q -- the reference's rule, kept as is
    if len(spec.shape) == 1:
        return 1
    return int(np.prod(spec.shape[:-1]))


def init_params(
    tree,
    generator: torch.Generator,
    device: str | torch.device = "cuda",
    default_dtype: torch.dtype = torch.float32,
):
    """Materialise real tensors on ``device`` from ``generator``, with the
    reference's init rules (zeros / ones / N(0, 0.02) embeddings / N(0,
    1/fan_in) otherwise).  Draws happen on the generator's device and the
    result moves to ``device``, so a CPU generator gives the same weights
    on every device."""
    dev = resolve_device(device)

    def one(spec: PSpec):
        dtype = spec.dtype or default_dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        std = spec.scale
        if std is None:
            std = 0.02 if spec.init == "embed" else 1.0 / math.sqrt(_fan_in(spec))
        x = torch.randn(
            spec.shape, generator=generator, dtype=torch.float32,
            device=generator.device,
        )
        return (x * std).to(device=dev, dtype=dtype)

    return tree_map(one, tree)


def bf16_projections(tree):
    """``tree`` with every dense projection's weight (the ``w`` of a
    ``{"w": ..., "b": ...}`` node) rounded once to bf16; the embedding, the
    norms and the biases stay as they are (fp32).

    For ``ExecCfg(linear_mode="binary_matmul")`` only: both packages round a
    projection's W to bf16 before its bitplane product, so on this tree that
    mode's outputs are identical to the fp32 tree's, on the kernel path and
    on the plain path, with half the projection bytes to store and to read
    per decode step.  The standard mode (``x @ w``) is not meant to run on
    such a tree: its products would take bf16 weights."""
    if isinstance(tree, dict):
        return {
            k: v.to(torch.bfloat16) if k == "w" and isinstance(v, torch.Tensor)
            else bf16_projections(v)
            for k, v in tree.items()
        }
    return tree


def params_from_numpy(tree, device: str | torch.device = "cuda", plan=None):
    """Nested dict of numpy arrays (e.g. the JAX package's parameters via
    ``np.asarray``) -> the same tree of tensors on ``device``.

    A converted node -- an object with ``tables``/``b``/``scale``
    attributes, such as the JAX package's ``LUTLinear``/``LUTGroup`` after
    ``jax.tree.map(np.asarray, ...)`` -- becomes the port's :class:`~repro_torch.core.convert.LUTLinear` or,
    under an ``"a+b"`` key, :class:`~repro_torch.core.convert.LUTGroup`,
    with its plan read from ``plan`` (a ``ModelPlan``) by tree path.  A
    weight-family dequant scale stays on the host, as the converter keeps
    it; a TL1 ternary scale goes to ``device``."""
    from repro_torch.core.convert import LUTGroup, LUTLinear
    from repro_torch.core.planner import path_key

    dev = resolve_device(device)

    def tensor(a, host: bool = False):
        t = torch.from_numpy(np.array(a, copy=True))
        return t if host else t.to(dev)

    def converted(path: tuple, node):
        members = tuple(str(path[-1]).split("+"))
        key = path_key(path[:-1] + (members[0],))
        if plan is None or key not in plan.layers:
            raise ValueError(
                f"converted node {path_key(path)} has no plan entry {key!r}"
            )
        node_plan = plan.layers[key]
        b = node.b
        if isinstance(b, (tuple, list)):
            b = tuple(None if v is None else tensor(v) for v in b)
        elif b is not None:
            b = tensor(b)
        scale = node.scale
        if scale is not None:
            scale = tensor(scale, host=node_plan.table_family == "weight")
        tables = tensor(node.tables)
        if len(members) > 1:
            return LUTGroup(tables, node_plan, members, b=b, scale=scale)
        return LUTLinear(tables, node_plan, b=b, scale=scale)

    def walk(path: tuple, node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if hasattr(node, "tables"):
            return converted(path, node)
        return tensor(node)

    return walk((), tree)
