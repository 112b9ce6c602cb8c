"""Shared helpers for the port's Hopper kernels (counterpart of
``repro/kernels/common.py``), and the launch counts of a captured CUDA
graph: :func:`captured_counts` and :func:`replay_counted`."""
from __future__ import annotations

from typing import Callable, TypeVar

import numpy as np

T = TypeVar("T")

# Largest |value| each accumulator dtype can hold exactly enough for the
# contract check: integer dtypes their max code, float32 its max finite.
# Keys are the strings a plan's ``acc_dtype`` field carries.
ACC_CAPACITY: dict[str, float] = {
    "int16": float(2**15 - 1),
    "int32": float(2**31 - 1),
    "int64": float(2**63 - 1),
    "float32": float(np.finfo(np.float32).max),
}


def acc_capacity(acc_dtype: str) -> float:
    """Capacity of an accumulator dtype name (raises on unknown names)."""
    try:
        return ACC_CAPACITY[acc_dtype]
    except KeyError:
        raise ValueError(
            f"unknown accumulator dtype {acc_dtype!r}; "
            f"expected one of {sorted(ACC_CAPACITY)}"
        ) from None


def check_acc_contract(op: str, plan, kernel_acc_dtype: str) -> None:
    """Accumulator-contract assert, run before every dispatch.

    ``plan`` is duck-typed (any object with ``acc_dtype`` and a proved
    ``max_abs_acc`` stamped by the planner via ``audit.ranges``).  No-op
    when the plan carries no proved bound; otherwise raises if the bound
    exceeds either the plan's declared accumulator capacity or the capacity
    of the dtype the kernel actually accumulates in.
    """
    bound = getattr(plan, "max_abs_acc", None)
    if bound is None:
        return
    declared = plan.acc_dtype
    if bound > acc_capacity(declared):
        raise ValueError(
            f"{op}: plan declares acc_dtype={declared!r} but its proved "
            f"|acc| bound {bound:.6g} exceeds that dtype's capacity "
            f"{acc_capacity(declared):.6g}"
        )
    if bound > acc_capacity(kernel_acc_dtype):
        raise ValueError(
            f"{op}: kernel accumulates in {kernel_acc_dtype}, too narrow "
            f"for the plan's proved |acc| bound {bound:.6g}"
        )


def ceil_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def launch_counters() -> tuple[dict, ...]:
    """Every count the kernel wrappers keep in Python: each kernel's
    ``LAUNCHES``, the packs off the kernel (``bitplane_pack``'s
    ``PLAIN_CALLS``) and the table copies before a launch
    (``lut_affine``'s ``TABLE_COPIES``)."""
    from repro_torch.kernels.binary_matmul import ops as bmm_ops
    from repro_torch.kernels.bitplane_pack import ops as pack_ops
    from repro_torch.kernels.lut_affine import ops as lut_ops
    from repro_torch.kernels.lut_tl1 import ops as tl1_ops

    return (lut_ops.LAUNCHES, lut_ops.TABLE_COPIES, tl1_ops.LAUNCHES,
            pack_ops.LAUNCHES, pack_ops.PLAIN_CALLS, bmm_ops.LAUNCHES)


def captured_counts(capture: Callable[[], T]) -> tuple[T, list]:
    """Run ``capture`` (the capture of a CUDA graph, which records each
    launch without running it) and return its result with what it added to
    every count of :func:`launch_counters`, as ``(counts, key, added)``
    triples.  The counts are put back as they were, also when the capture
    raises: only a replay runs the launches (:func:`replay_counted`)."""
    counters = launch_counters()
    before = [dict(c) for c in counters]
    try:
        out = capture()
        added = [(c, key, c[key] - b[key])
                 for c, b in zip(counters, before) for key in c if c[key] != b[key]]
    finally:
        for c, b in zip(counters, before):
            c.update(b)
    return out, added


def replay_counted(graph, added: list) -> None:
    """``graph.replay()``, then add to each count what the capture added
    (``added`` from :func:`captured_counts`)."""
    graph.replay()
    for counts, key, n in added:
        counts[key] += n
