"""Shared helpers for the port's Hopper kernels (counterpart of
``repro/kernels/common.py``)."""
from __future__ import annotations

import numpy as np

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
