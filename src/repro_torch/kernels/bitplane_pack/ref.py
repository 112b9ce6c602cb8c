"""Plain PyTorch version of the packing kernel (counterpart of
``repro/kernels/bitplane_pack/ref.py``): the core library's
``pack_codes`` under the plan the kernel's arguments describe."""
from __future__ import annotations

import torch

from repro_torch.core.lut import LUTPlan, pack_codes
from repro_torch.core.quantize import FixedPointFormat, Float16Format

KINDS = ("fixed", "float16", "shift")


def pack_plan(
    q: int, *, kind: str, bits: int, frac: int, signed: bool, m: int, radix: int = 1
) -> LUTPlan:
    """The plan of a ``q``-wide input that the kernel's arguments describe:
    chunk-``m`` fixed-point or unsigned fp16 bitplanes, or chunk-1
    ``bitplane_shift`` codes of a ``Float16Format(signed, radix)`` (its
    checks are the kernel's argument checks too)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    if kind == "shift":
        fmt = Float16Format(signed=signed, mantissa_radix=radix)
        return LUTPlan(q, 1, m, fmt, mode="bitplane_shift")
    fmt = Float16Format() if kind == "float16" else FixedPointFormat(bits, frac, signed)
    return LUTPlan(q, 1, m, fmt, mode="bitplane")


def bitplane_pack_ref(
    x: torch.Tensor, *, kind: str, bits: int, frac: int, signed: bool, m: int,
    radix: int = 1,
) -> torch.Tensor:
    """``(..., q)`` -> ``(..., n, ceil(q/m))`` int32 LUT indices."""
    plan = pack_plan(
        x.shape[-1], kind=kind, bits=bits, frac=frac, signed=signed, m=m, radix=radix
    )
    return pack_codes(x, plan)
