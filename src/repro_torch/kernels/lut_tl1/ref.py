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


# The kernel's form of the same accumulate: one folded LUT per packed byte
# (see csrc/lut_tl1.cu).  Integer sums equal lut_tl1_ref's bit for bit.

FOLD_SLOTS = 256  # one slot per byte value; 81 hold entries (both nibbles <= 8)
BIAS = 512  # the kernel's int16 entries: entry + BIAS, two tokens per 32-bit word
FLUSH_ROWS = 64  # rows a biased 16-bit half holds before it is widened


def fold_act_lut(acts: torch.Tensor) -> torch.Tensor:
    """(B, 4*kb) codes -> (B, kb, 256) folded LUT, adds only:
    ``F[b, c, (h << 4) | l] = pairLUT(a[4c], a[4c+1])[l] +
    pairLUT(a[4c+2], a[4c+3])[h]`` for digits ``h, l`` in 0..8 (81 slots),
    0 in the other 175.  int32 entries from integer codes, float32 from
    float codes."""
    B, q4 = acts.shape
    kb = q4 // 4
    lut = build_act_lut(acts).reshape(B, kb, 2, 9)  # low pair, high pair
    dtype = torch.float32 if lut.is_floating_point() else torch.int32
    lo, hi = lut[:, :, 0].to(dtype), lut[:, :, 1].to(dtype)
    folded = torch.zeros((B, kb, 16, 16), dtype=dtype, device=acts.device)
    folded[:, :, :9, :9] = hi[:, :, :, None] + lo[:, :, None, :]  # [.., h, l]
    return folded.reshape(B, kb, FOLD_SLOTS)


def _gather_folded(folded: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """(B, rows, 256) folded entries gathered by (rows, p) packed bytes ->
    (B, rows, p)."""
    rows = torch.arange(tables.shape[0], device=tables.device)[:, None]
    return folded[:, rows, tables.to(torch.int64)]


def lut_tl1_folded_ref(
    acts: torch.Tensor,  # (B, 4*kb) int32 codes, or float32 (exact path)
    tables: torch.Tensor,  # (kb, p) uint8
    max_gather_bytes: int = _GATHER_BYTES,
) -> torch.Tensor:
    """``out[b, :] = sum_c F_b[c, tables[c, :]]``: one lookup and one add
    per packed byte -> (B, p) int32, or float32 for float codes."""
    kb, p = tables.shape
    folded = fold_act_lut(acts)
    B = folded.shape[0]
    out = torch.zeros((B, p), dtype=folded.dtype, device=tables.device)
    step = max(1, max_gather_bytes // max(1, p * (8 + 2 * B * 4)))
    for r0 in range(0, kb, step):
        r1 = min(kb, r0 + step)
        out += _gather_folded(folded[:, r0:r1], tables[r0:r1]).sum(dim=1)
    return out


def lut_tl1_biased_ref(
    acts: torch.Tensor,  # (B, 4*kb) int32 codes whose folded entries are <= 511
    tables: torch.Tensor,  # (kb, p) uint8
    flush_rows: int = FLUSH_ROWS,
) -> torch.Tensor:
    """The kernel's int16 arithmetic: folded entries biased by +512, tokens
    2i and 2i+1 in the low and high 16-bit halves of one 32-bit word, the
    words of ``flush_rows`` packed rows added, then each half widened and
    ``rows << 9`` subtracted.  Raises if an entry leaves [-511, 511] or a
    16-bit half would overflow (more rows than it holds between flushes).
    -> (B, p) int32, equal to ``lut_tl1_ref``."""
    if acts.is_floating_point():
        raise TypeError("the biased form takes integer codes")
    kb, p = tables.shape
    B = acts.shape[0]
    folded = fold_act_lut(acts).to(torch.int64)
    used = torch.zeros((16, 16), dtype=torch.bool, device=acts.device)
    used[:9, :9] = True  # the 81 slots with entries
    used = used.reshape(FOLD_SLOTS)
    if folded.numel() and folded[..., used].abs().max().item() >= BIAS:
        raise ValueError(f"a folded entry exceeds {BIAS - 1}: not a biased-int16 plan")
    biased = torch.where(used, folded + BIAS, torch.zeros_like(folded))
    if B % 2:  # an odd token pairs with an all-zero one
        biased = torch.cat([biased, torch.full_like(biased[:1], BIAS)])
    words = biased[0::2] | (biased[1::2] << 16)  # (B2, kb, 256)
    wide = torch.zeros((biased.shape[0], p), dtype=torch.int64, device=tables.device)
    for r0 in range(0, kb, flush_rows):
        r1 = min(kb, r0 + flush_rows)
        fields = _gather_folded(biased[:, r0:r1], tables[r0:r1]).sum(dim=1)  # (B, p)
        if fields.numel() and fields.max().item() >= 2**16:
            raise AssertionError(f"{r1 - r0} rows overflow a 16-bit half")
        acc = _gather_folded(words[:, r0:r1], tables[r0:r1]).sum(dim=1)  # (B2, p)
        offset = (r1 - r0) << 9
        wide[0::2] += (acc & 0xFFFF) - offset
        wide[1::2] += (acc >> 16) - offset
    return wide[:B].to(torch.int32)
