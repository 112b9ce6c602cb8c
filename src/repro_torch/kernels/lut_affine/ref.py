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


def expert_of_token(group_sizes: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """(T,) int64 expert id of each expert-sorted row; rows past
    ``sum(group_sizes)`` (a ragged tail) get ``E``, one past the last
    expert."""
    ends = torch.cumsum(group_sizes.to(torch.int64), 0)
    rows = torch.arange(num_tokens, dtype=torch.int64, device=group_sizes.device)
    return (rows[:, None] >= ends[None, :]).sum(-1)


def lut_affine_experts_ref(
    codes: torch.Tensor,  # (T, n, k) int32, rows sorted by expert
    tables: torch.Tensor,  # (E, G, k, En, p)
    scales: torch.Tensor,  # (n,) fp32
    group_sizes: torch.Tensor,  # (E,) rows per expert
    shift_bits: int = 0,
    max_gather_bytes: int = _GATHER_BYTES,
) -> torch.Tensor:
    """(G, T, p) fp32: row ``t`` against ITS expert's tables,
    ``sum_j scales[j] * sum_c T[e(t), g, c, idx(t,j,c), :]``; rows past
    ``sum(group_sizes)`` give 0, as in the kernels.  The ``(T, G, n, k,
    p)`` gather runs in token and chunk slices of at most
    ``max_gather_bytes``."""
    T, n, k = codes.shape
    E, G, k2, En, p = tables.shape
    assert k == k2, (codes.shape, tables.shape)
    dev = tables.device
    eot = expert_of_token(group_sizes.to(dev), T)
    live = eot < E
    eot = torch.clamp(eot, max=E - 1)
    per_plane = torch.zeros((T, G, n, p), dtype=torch.float32, device=dev)
    c_step = max(1, min(k, max_gather_bytes // max(1, G * n * p * 4)))
    t_step = max(1, max_gather_bytes // max(1, G * n * c_step * p * 4))
    ag = torch.arange(G, device=dev)[None, :, None, None]
    for t0 in range(0, T, t_step):
        t1 = min(T, t0 + t_step)
        e = eot[t0:t1, None, None, None]
        for c0 in range(0, k, c_step):
            c1 = min(k, c0 + c_step)
            cd = codes[t0:t1, None, :, c0:c1]  # (Ts, 1, n, kc)
            idx = cd & (En - 1) if shift_bits else cd
            ac = torch.arange(c0, c1, device=dev)[None, None, None, :]
            rows = tables[e, ag, ac, idx].to(torch.float32)  # (Ts, G, n, kc, p)
            if shift_bits:
                sig = pow2(torch.clamp(cd >> shift_bits, min=1) - 25)
                rows = rows * sig[..., None]
            per_plane[t0:t1] += rows.sum(dim=-2)
    out = torch.einsum("tgnp,n->gtp", per_plane, scales.to(torch.float32))
    return torch.where(live[None, :, None], out, torch.zeros((), device=dev))


# The dense kernels' form of the same accumulate (see csrc/lut_affine.cu):
# each reference (b, j, c) contributes its gathered row times
# (-1)**sign_j * 2**e, e the plane exponent plus the code's sigma exponent,
# as an exact fp32 term; the terms are summed in fp32.  Integer tables whose
# exponents all lie in MAGIC's range take the magic-word path; the rest take
# the general path (an exact shift of the converted entry).

# table type -> (exponent-field bias, bit offset of the biased entry, entry
# bias, least and greatest total exponent of the magic path)
MAGIC = {
    torch.int8: (142, 8, 128, -141, 112),
    torch.int16: (150, 0, 32768, -149, 104),
}


def _as_f32(words: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit patterns -> the fp32 values of those bits."""
    w = words & 0xFFFFFFFF
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).view(torch.float32)


def magic_terms(
    entries: torch.Tensor,  # integer entries of an i8 / i16 table
    e: torch.Tensor,  # total exponents, broadcast against entries
    sign: torch.Tensor,  # 0 / 1, broadcast against entries
    dtype: torch.dtype,
) -> torch.Tensor:
    """``(-1)**sign * entries * 2**e`` in fp32 as the kernels compute it on
    the integer fast path, with adds and bit operations only: the magic
    word ``K = sign << 31 | (e + bias) << 23`` takes the biased entry into
    its mantissa (``K | (x + half) << off``), and the fp32 value of that word
    less the value of ``K | 0x8000`` (entry 0) is the term, exactly.
    Raises if an exponent leaves K's exponent field outside [1, 254]."""
    bias, off, half, lo, hi = MAGIC[dtype]
    e = e.to(torch.int64)
    if bool((e < lo).any()) or bool((e > hi).any()):
        raise ValueError(f"exponents outside [{lo}, {hi}]: no magic path for {dtype}")
    K = (sign.to(torch.int64) << 31) | ((e + bias) << 23)
    word = K | ((entries.to(torch.int64) + half) << off)
    return _as_f32(word) - _as_f32(K | 0x8000)


def magic_path(dtype: torch.dtype, lo: int, hi: int) -> bool:
    """Whether a launch whose total exponents lie in [lo, hi] takes the
    magic path (the host's range proof, once per launch)."""
    return dtype in MAGIC and MAGIC[dtype][3] <= lo and hi <= MAGIC[dtype][4]


def exponent_bounds(plane_exps, shift_bits: int) -> tuple[int, int]:
    """Least and greatest total exponent a launch can meet: a plane
    exponent plus, with ``shift_bits``, a sigma exponent in [-24, 6]."""
    lo, hi = min(plane_exps), max(plane_exps)
    return (lo - 24, hi + 6) if shift_bits else (lo, hi)


def lut_affine_kernel_ref(
    codes: torch.Tensor,  # (B, n, k) int32
    tables: torch.Tensor,  # (k, E, p)
    plane_exps,  # n ints: plane j's scale is (-1)**sign_j * 2**plane_exps[j]
    plane_neg: int,  # bit j set: plane j's scale is negative
    shift_bits: int = 0,
) -> torch.Tensor:
    """(B, p) fp32 by the dense kernels' arithmetic, one exact term per
    reference, for small test shapes (the whole ``(B, n, k, p)`` gather is
    held at once)."""
    B, n, k = codes.shape
    k2, E, p = tables.shape
    assert k == k2 and len(plane_exps) == n, (codes.shape, tables.shape, plane_exps)
    dev = tables.device
    idx = codes & (E - 1) if shift_bits else codes
    e = torch.tensor(list(plane_exps), dtype=torch.int64, device=dev)[None, :, None]
    if shift_bits:
        e = e + torch.clamp(codes.to(torch.int64) >> shift_bits, min=1) - 25
    else:
        e = e.expand(B, n, k)
    sign = torch.tensor([(plane_neg >> j) & 1 for j in range(n)], device=dev)[None, :, None]
    rows = tables[torch.arange(k, device=dev), idx]  # (B, n, k, p)
    if magic_path(tables.dtype, *exponent_bounds(plane_exps, shift_bits)):
        terms = magic_terms(rows, e[..., None], sign[..., None], tables.dtype)
    else:  # converted, shifted exactly (in fp64, then one exact rounding), signed
        val = rows.to(torch.float32).to(torch.float64) * torch.exp2(e[..., None].to(torch.float64))
        terms = torch.where(sign[..., None].bool(), -val, val).to(torch.float32)
    return terms.sum(dim=(1, 2))


# the ragged kernel's grid (csrc/lut_affine.cu::experts_kernel): blocks of
# EXPERT_ROWS expert-sorted rows (ops.py::experts_tiling), two halves of warps
# taking alternate halves of each staged pass of chunks, the pass as many
# chunks as 24 KiB of references hold (8 bytes each, at most 512)
EXPERT_ROWS = 4
_META_BYTES = 24 * 1024


def experts_kernel_ref(
    codes: torch.Tensor,  # (T, n, k) int32, rows sorted by expert
    tables: torch.Tensor,  # (E, G, k, En, p)
    plane_exps,  # n ints, as in lut_affine_kernel_ref
    plane_neg: int,
    group_sizes: torch.Tensor,  # (E,) rows per expert
    shift_bits: int = 0,
    splits: int = 1,
) -> torch.Tensor:
    """(G, T, p) fp32 by the ragged kernel's grid and arithmetic, for small
    test shapes: blocks of ``EXPERT_ROWS`` consecutive rows whose experts may
    differ, each row's expert the count of experts whose rows end at or
    before it, rows with no expert (at or past ``sum(group_sizes)``) 0.  In
    each of ``splits`` k ranges the two halves of every staged pass of
    chunks are summed apart, one exact term a reference in chunk-then-plane
    order, then added; the ranges' partials are added in split order.  Those
    are the kernel's fp32 sums, in the kernel's order."""
    T, n, k = codes.shape
    E, G, k2, En, p = tables.shape
    assert k == k2 and len(plane_exps) == n, (codes.shape, tables.shape, plane_exps)
    dev = tables.device
    ends = torch.cumsum(group_sizes.to(torch.int64).to(dev), 0)
    idx = codes & (En - 1) if shift_bits else codes
    e = torch.tensor(list(plane_exps), dtype=torch.int64, device=dev)[None, :, None]
    if shift_bits:
        e = e + torch.clamp(codes.to(torch.int64) >> shift_bits, min=1) - 25
    else:
        e = e.expand(T, n, k)
    sign = torch.tensor([(plane_neg >> j) & 1 for j in range(n)], device=dev)[None, :, None]
    fast = magic_path(tables.dtype, *exponent_bounds(plane_exps, shift_bits))
    kt_max = min(512, _META_BYTES // (EXPERT_ROWS * n * 8))
    out = torch.zeros((G, T, p), dtype=torch.float32, device=dev)
    for b0 in range(0, T, EXPERT_ROWS):
        rows = torch.arange(b0, min(T, b0 + EXPERT_ROWS), device=dev)
        expert = (ends[None, :] <= rows[:, None]).sum(-1)
        rows, expert = rows[expert < E], expert[expert < E]
        if not rows.numel():
            continue
        ar = torch.arange(k, device=dev)
        for g in range(G):
            ent = tables[expert[:, None, None], g, ar, idx[rows]]  # (r, n, k, p)
            if fast:
                terms = magic_terms(ent, e[rows][..., None], sign[..., None], tables.dtype)
            else:  # converted, shifted exactly (fp64, one exact rounding), signed
                val = ent.to(torch.float64) * torch.exp2(e[rows][..., None].to(torch.float64))
                terms = torch.where(sign[..., None].bool(), -val, val).to(torch.float32)
            total = None
            for s in range(splits):
                k0, k1 = k * s // splits, k * (s + 1) // splits
                halves = torch.zeros((2, rows.numel(), p), dtype=torch.float32, device=dev)
                for c0 in range(k0, k1, kt_max):
                    kt = min(kt_max, k1 - c0)
                    for h in range(2):
                        for c in range(c0 + kt * h // 2, c0 + kt * (h + 1) // 2):
                            for j in range(n):
                                halves[h] += terms[:, j, c]
                partial = halves[0] + halves[1]
                if splits == 1:
                    total = partial
                else:  # sum_splits: 0 + part[0] + part[1] + ...
                    total = (torch.zeros_like(partial) if total is None else total) + partial
            out[g, rows] = total
    return out
