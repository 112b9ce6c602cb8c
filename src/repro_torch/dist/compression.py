"""int8 gradient all-reduce with error feedback (counterpart of
``repro/dist/compression.py``), and the traffic of recorded collectives
(counterpart of ``repro/launch/hlo_analysis.py::collective_stats``).

The cross-pod hop is the slow link at scale, so gradients cross it as int8
codes.  Error feedback keeps the quantizer unbiased over steps: what it
drops this step is kept per worker and added to the next step's gradient
before quantizing.  Per leaf and per step, in the reference's order:

1. ``c = g + err`` in fp32;
2. ``scale = max(absmax(c) over the group, finfo(f32).tiny) / 127``,
   shared, so every worker dequantizes alike;
3. ``codes = clip(round(c / scale), -127, 127)`` as int8 (round half to
   even, as ``jnp.round``), and the new residual ``c - codes * scale``
   (at most half a step: the shared scale leaves nothing to clip);
4. the codes summed as int32 over the group (two int8 codes already leave
   int8's range), and the mean ``total * scale / n`` cast to ``g``'s dtype.

:func:`compressed_all_reduce` does this over a process group, its MAX and
SUM batched over the leaves (one collective each: a MAX per element and an
integer SUM give every leaf the numbers it would get alone);
:func:`compressed_psum_ref` is its plain version in one process, over a
leading pod axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist

from repro_torch.dist import collectives
from repro_torch.models.params import tree_flatten

_TINY = torch.finfo(torch.float32).tiny


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(absmax, _TINY) / 127.0


def _quantize(c: torch.Tensor, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes, residual ``c - dequantized``) of fp32 ``c``."""
    codes = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
    return codes, c - codes.to(torch.float32) * scale


def compressed_all_reduce(grads: Any, err: Any, group=None) -> tuple[Any, Any]:
    """``(grads, residuals) -> (the group's mean of the dequantized codes,
    new residuals)``, both trees shaped like ``grads`` (``err`` fp32, this
    rank's row).  Each leaf has its own scale; two collectives in all: a
    MAX of the leaves' absmax and an int32 SUM of their codes."""
    g_leaves, unflatten = tree_flatten(grads)
    e_leaves, _ = tree_flatten(err)
    if len(g_leaves) != len(e_leaves):
        raise ValueError(f"{len(g_leaves)} gradient leaves, {len(e_leaves)} residuals")
    cs = [g.to(torch.float32) + e.to(torch.float32) for g, e in zip(g_leaves, e_leaves)]
    absmax = torch.stack([c.abs().max() for c in cs])
    collectives.all_reduce(absmax, "max", group)
    scales = _scale(absmax)
    codes, new_err = zip(*(_quantize(c, scales[i]) for i, c in enumerate(cs)))
    total = torch.cat([q.reshape(-1).to(torch.int32) for q in codes])
    collectives.all_reduce(total, "sum", group)  # the wire hop
    n = float(dist.get_world_size(group))
    means, at = [], 0
    for i, g in enumerate(g_leaves):
        t = total[at:at + g.numel()].view(g.shape)
        at += g.numel()
        means.append((t.to(torch.float32) * scales[i] / n).to(g.dtype))
    return unflatten(means), unflatten(list(new_err))


def compressed_psum_ref(grads_stack: Any, err_stack: Any) -> tuple[Any, Any]:
    """The plain version in one process: every leaf carries a leading pod
    axis (one row per pod).  Returns ``(means, new residuals)``: each
    leaf's mean without the pod axis (every pod receives the same), the
    residuals with it."""
    g_leaves, unflatten = tree_flatten(grads_stack)
    e_leaves, _ = tree_flatten(err_stack)
    means, errs = [], []
    for g, e in zip(g_leaves, e_leaves):
        c = g.to(torch.float32) + e.to(torch.float32)
        n = c.shape[0]
        absmax = c.abs().reshape(n, -1).amax(1).amax()
        scale = _scale(absmax)
        codes, new_err = _quantize(c, scale)
        total = codes.to(torch.int32).sum(0)
        means.append((total.to(torch.float32) * scale / float(n)).to(g.dtype))
        errs.append(new_err)
    return unflatten(means), unflatten(errs)


# -- traffic -----------------------------------------------------------------

# the reference's HLO collective ops; their ring-model link bytes over a
# group of N:
#   all-reduce          2 (N-1)/N * payload  (reduce-scatter + all-gather)
#   all-gather          (N-1)/N * result bytes (the gathered tensor)
#   reduce-scatter      (N-1)/N * operand bytes (N * the result)
#   all-to-all          (N-1)/N * payload
#   collective-permute  payload (one hop a chip)
COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)


@dataclasses.dataclass
class CollectiveStats:
    by_op: dict
    result_bytes: int  # raw sum of the collectives' result sizes
    link_bytes: float  # ring-model bytes through each rank's links

    def to_dict(self) -> dict:
        return {
            "by_op": self.by_op,
            "result_bytes": self.result_bytes,
            "link_bytes": self.link_bytes,
        }


def collective_stats(records: Iterable, group_size: Optional[int] = None) -> CollectiveStats:
    """Counts, result bytes and ring-model link bytes per HLO op of the
    collectives among ``records`` (a recording's ops from
    ``audit/walker.py::record``, whose collective leaves carry their facts
    in ``kwargs``, or those facts as dicts).  ``group_size`` computes the
    same records as if each ran over a group of that size.  A barrier,
    which carries no data, is left out, as the reference's HLO has none."""
    by_op: dict[str, dict[str, float]] = {}
    total_result = 0
    total_link = 0.0
    for r in records:
        facts = r if isinstance(r, dict) else getattr(r, "kwargs", {})
        op = facts.get("collective")
        if op not in COLLECTIVES:
            continue
        payload = int(facts["bytes"])
        n = max(int(group_size if group_size is not None else facts["group_size"]), 1)
        ring = (n - 1) / n if n > 1 else 0.0
        if op == "all-reduce":
            link = 2 * ring * payload
        elif op == "all-gather":
            link = ring * payload
        elif op == "reduce-scatter":
            link = ring * payload * n
        elif op == "all-to-all":
            link = ring * payload
        else:  # collective-permute
            link = float(payload)
        rec = by_op.setdefault(op, {"count": 0, "result_bytes": 0, "link_bytes": 0.0})
        rec["count"] += 1
        rec["result_bytes"] += payload
        rec["link_bytes"] += link
        total_result += payload
        total_link += link
    return CollectiveStats(by_op, total_result, total_link)
