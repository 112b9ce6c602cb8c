"""Plain PyTorch versions of the LUT affine kernels (counterpart of
``repro/kernels/lut_affine/ref.py``, same contract).

They gather in chunk slices so that the ``(B, n, k_slice, p)`` fp32
intermediate never exceeds ``max_gather_bytes``: at full ``granite_8b``
width one unsliced gather would take gigabytes.
"""
from __future__ import annotations

import torch

_GATHER_BYTES = 1 << 30


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact fp32 ``2**e`` for integer ``e`` in the normal range, built
    from the exponent bits (no transcendental call to round)."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def lut_affine_ref(
    codes: torch.Tensor,  # (B, n, k) int32
    tables: torch.Tensor,  # (k, E, p)
    scales: torch.Tensor,  # (n,) fp32
    shift_bits: int = 0,
    max_gather_bytes: int = _GATHER_BYTES,
) -> torch.Tensor:
    """``out[b] = sum_j scales[j] * sum_c T[c, idx(b,j,c), :]`` -> (B, p)
    fp32.  With ``shift_bits``, ``idx = code & (E-1)`` and each row is
    scaled by ``2**(max(code >> shift_bits, 1) - 25)``."""
    B, n, k = codes.shape
    k2, E, p = tables.shape
    assert k == k2, (codes.shape, tables.shape)
    per_plane = torch.zeros((B, n, p), dtype=torch.float32, device=tables.device)
    step = max(1, max_gather_bytes // max(1, B * n * p * 4))
    for c0 in range(0, k, step):
        c1 = min(k, c0 + step)
        cd = codes[:, :, c0:c1]
        idx = cd & (E - 1) if shift_bits else cd
        ar = torch.arange(c1 - c0, device=tables.device)
        rows = tables[c0:c1][ar, idx].to(torch.float32)  # (B, n, kc, p)
        if shift_bits:
            sig = pow2(torch.clamp(cd >> shift_bits, min=1) - 25)
            rows = rows * sig[..., None]
        per_plane += rows.sum(dim=-2)
    return torch.einsum("bnp,n->bp", per_plane, scales.to(torch.float32))


def lut_affine_grouped_ref(
    codes: torch.Tensor,  # (B, n, k) int32, shared across the group
    tables: torch.Tensor,  # (G, k, E, p)
    scales: torch.Tensor,  # (n,)
    shift_bits: int = 0,
    max_gather_bytes: int = _GATHER_BYTES,
) -> torch.Tensor:
    """(G, B, p): every group member applied to the same packed input."""
    return torch.stack(
        [
            lut_affine_ref(codes, t, scales, shift_bits, max_gather_bytes)
            for t in tables
        ]
    )
