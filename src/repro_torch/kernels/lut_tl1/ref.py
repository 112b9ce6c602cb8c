"""Plain PyTorch versions of the TL1 kernels (counterpart of
``repro/kernels/lut_tl1/ref.py``, same contract: the raw accumulate, no
scales or bias).

They gather a slice of packed rows at a time, so that the ``(B, rows, p)``
gathered entries and their int32 (or fp32) widening never exceed
``max_gather_bytes``: at full ``granite_8b`` width one unsliced prefill
gather would take tens of gigabytes.  Integer sums do not depend on the
slicing.
"""
from __future__ import annotations

import torch

from repro_torch.core.lut_tl1 import build_act_lut, unpack_indices

_GATHER_BYTES = 1 << 30


def lut_tl1_ref(
    acts: torch.Tensor,  # (B, 4*kb) int32 codes, or float32 (exact path)
    tables: torch.Tensor,  # (kb, p) uint8
    max_gather_bytes: int = _GATHER_BYTES,
) -> torch.Tensor:
    """``out[b, :] = sum_c lut_b[c, widx[c, :]]`` -> (B, p) int32, or
    float32 for float codes."""
    B, q4 = acts.shape
    kb, p = tables.shape
    assert q4 == 4 * kb, (acts.shape, tables.shape)
    lut = build_act_lut(acts)  # (B, 2*kb, 9)
    acc_dtype = torch.float32 if lut.is_floating_point() else torch.int32
    out = torch.zeros((B, p), dtype=acc_dtype, device=tables.device)
    # bytes per packed row: two int64 indices per column, and two gathered
    # entries per (batch row, column) with their widening
    per_row = 2 * p * (8 + B * (lut.element_size() + 4))
    step = max(1, max_gather_bytes // max(1, per_row))
    for r0 in range(0, kb, step):
        r1 = min(kb, r0 + step)
        idx = unpack_indices(tables[r0:r1]).to(torch.int64)  # (2*(r1-r0), p)
        ar = torch.arange(2 * (r1 - r0), device=tables.device)[:, None]
        g = lut[:, 2 * r0 : 2 * r1][:, ar, idx]  # (B, 2*(r1-r0), p)
        out += g.to(acc_dtype).sum(dim=1)
    return out


def lut_tl1_grouped_ref(
    acts: torch.Tensor,  # (B, 4*kb), shared across the group
    tables: torch.Tensor,  # (G, kb, p)
    max_gather_bytes: int = _GATHER_BYTES,
) -> torch.Tensor:
    """(G, B, p): every group member applied to the same codes."""
    return torch.stack([lut_tl1_ref(acts, t, max_gather_bytes) for t in tables])
