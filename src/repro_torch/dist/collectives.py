"""The port's collectives: ``torch.distributed`` calls that report
themselves to the audit's recorder (``kernels/common.py::RECORDER``).

Each call is one opaque leaf of a recording (``audit/walker.py::record``),
with its facts in the leaf's ``kwargs``: the HLO op it stands for
(``all-reduce``, ``all-gather``), the reduction, the tensor's dtype and
shape, its bytes, and the group's size.  ``dist/compression.py::
collective_stats`` sums such leaves as the reference sums the collectives
of a compiled step.  With no recorder active a call costs one ``None``
check.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import common

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _report(name: str, hlo: str, t: torch.Tensor, group, outputs, reduce=None):
    common.RECORDER(
        name, (t,), outputs, collective=hlo, reduce=reduce, dtype=str(t.dtype),
        shape=tuple(t.shape), bytes=t.numel() * t.element_size(),
        group_size=dist.get_world_size(group),
    )


def all_reduce(t: torch.Tensor, op: str, group=None) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (``op``: ``"sum"`` or
    ``"max"``); returns ``t``."""
    dist.all_reduce(t, op=_OPS[op], group=group)
    if common.RECORDER is not None:
        _report("all_reduce", "all-reduce", t, group, (t,), op)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, stacked along a new leading axis in
    rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.stack(parts)
    if common.RECORDER is not None:
        _report("all_gather", "all-gather", out, group, (out,))
    return out


def barrier(group=None) -> None:
    """Wait for every rank of ``group``; a leaf of no bytes."""
    dist.barrier(group=group)
    if common.RECORDER is not None:
        common.RECORDER("barrier", (), (), collective="barrier", reduce=None,
                        dtype=None, shape=(), bytes=0,
                        group_size=dist.get_world_size(group))
