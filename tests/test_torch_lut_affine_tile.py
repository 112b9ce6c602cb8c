"""The dense LUT affine kernels' host logic and arithmetic, on the CPU:
the wrapper's tiling rule (regime, rows per block, k ranges for one wave),
its aligned table copy, and ``ref.py``'s plain mirror of the kernels'
magic-word shift arithmetic, held against exact values, against
``lut_affine_ref`` and against the JAX package's Pallas kernel in interpret
mode.  The kernels themselves run only on the card
(``test_torch_kernels_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lut_affine import ops as jops
from repro_torch.kernels.lut_affine import ops
from repro_torch.kernels.lut_affine.ref import (
    MAGIC,
    exponent_bounds,
    lut_affine_kernel_ref,
    lut_affine_ref,
    magic_path,
    magic_terms,
)

SMS = 132  # an H100's SMs


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "G,B,n,k,E,row_bytes,regime,rows,splits",
    [
        # granite_8b decode (4 slots, radix-4 planes, 32 entries, i8)
        (1, 4, 3, 4096, 32, 4096, "decode", 4, 33),  # wq, wo
        (1, 4, 3, 14336, 32, 4096, "decode", 4, 33),  # w_down
        (2, 4, 3, 4096, 32, 1024, "decode", 4, 66),  # wk+wv
        (2, 4, 3, 4096, 32, 14336, "decode", 4, 4),  # w_gate+w_up
        # its prefill (4 slots x bucket 32)
        (1, 128, 3, 4096, 32, 4096, "prefill", 64, 8),
        (2, 128, 3, 4096, 32, 1024, "prefill", 64, 16),
        (2, 128, 3, 4096, 32, 14336, "prefill", 64, 1),
        # the regime boundary B * n = E, and tables too tall for a stage
        (1, 10, 3, 64, 32, 512, "decode", 4, 64),
        (1, 11, 3, 64, 32, 512, "prefill", 64, 64),
        (1, 200, 1, 64, 128, 512, "decode", 4, 5),
        # few chunks: never more ranges than chunks
        (1, 3, 3, 5, 32, 144, "decode", 4, 5),
    ],
)
def test_tiling_picks_the_regime_and_one_wave(G, B, n, k, E, row_bytes, regime, rows, splits):
    t = ops.tiling(G, B, n, k, E, row_bytes, SMS)
    assert (t.regime, t.rows, t.splits) == (regime, rows, splits)
    assert t.slabs == -(-row_bytes // ops.SLAB_BYTES)
    assert t.tiles == G * -(-B // rows) * t.slabs
    # one wave: the blocks fit the SMs unless the tiles alone do not
    assert t.tiles * t.splits <= max(t.tiles, ops.BLOCKS_PER_SM[regime] * SMS)
    assert 1 <= t.splits <= k


@pytest.mark.parametrize("n,rows", [(1, 4), (3, 4), (8, 4), (9, 3), (11, 2), (16, 2), (32, 1)])
def test_decode_rows_keep_a_chunk_within_one_producer_warp(n, rows):
    t = ops.tiling(1, 1, n, 64, 1024, 512, SMS)
    assert t.regime == "decode" and t.rows == rows
    assert rows * n <= ops.DECODE_REFS


@pytest.mark.parametrize("G,B,n,k,E,row_bytes", [
    (3, 1, 1, 7, 16, 16), (1, 129, 3, 1000, 32, 4112), (2, 17, 1, 3, 32, 640),
    (5, 64, 11, 40, 64, 2048), (1, 4, 3, 100000, 32, 65536),
])
def test_tiling_splits_never_exceed_chunks_or_one_wave(G, B, n, k, E, row_bytes):
    t = ops.tiling(G, B, n, k, E, row_bytes, SMS)
    assert 1 <= t.splits <= k
    if t.tiles < SMS:
        assert t.tiles * t.splits <= ops.BLOCKS_PER_SM[t.regime] * SMS
    else:
        assert t.splits == 1


# ---------------------------------------------------------------------------
# the aligned table copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.int16])
@pytest.mark.parametrize("p,offset", [(64, 0), (130, 0), (64, 1), (513, 3)])
def test_table_operand_pads_or_passes_through(dtype, p, offset):
    flat = torch.arange(offset + 2 * 3 * 5 * p).to(dtype)
    tables = flat[offset:].reshape(2, 3, 5, p)
    got = ops.table_operand(tables)
    size = tables.element_size()
    aligned = tables.data_ptr() % 16 == 0 and p * size % 16 == 0
    if aligned:
        assert got.data_ptr() == tables.data_ptr()
        return
    assert got.data_ptr() % 16 == 0 and got.shape[-1] * size % 16 == 0
    assert got.shape[-1] - p < 16 // size
    assert torch.equal(got[..., :p], tables)
    assert not got[..., p:].any()


# ---------------------------------------------------------------------------
# the magic-word arithmetic
# ---------------------------------------------------------------------------


def _exact(entries, e, sign):
    """(-1)**sign * entries * 2**e, exactly, rounded once to fp32."""
    v = entries.to(torch.float64) * torch.exp2(e.to(torch.float64))
    return torch.where(sign.bool(), -v, v).to(torch.float32)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_magic_terms_are_exact_at_every_edge(dtype):
    _, _, half, lo, hi = MAGIC[dtype]
    top = half - 1  # 127 or 32767
    entries = torch.tensor([0, 1, -1, top, -top, -half, top - 1, 2, -3])
    if dtype == torch.int8:
        entries = torch.cat([entries, torch.arange(-128, 128)])
    for e in (lo, lo + 1, -126, -30, -1, 0, 1, 6, hi - 1, hi):
        for sign in (0, 1):
            ee = torch.full_like(entries, e)
            ss = torch.full_like(entries, sign)
            got = magic_terms(entries, ee, ss, dtype)
            want = _exact(entries, ee, ss)
            assert torch.equal(got, want), (e, sign)
            assert torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_magic_terms_refuse_exponents_past_the_range(dtype):
    _, _, _, lo, hi = MAGIC[dtype]
    one = torch.ones(1, dtype=torch.int64)
    for e in (lo - 1, hi + 1, 113 if hi < 113 else hi + 1):
        with pytest.raises(ValueError):
            magic_terms(one, one * e, one * 0, dtype)


def test_magic_path_is_the_range_proof():
    # the main path: radix-4 plane scales x 2**-6 with sigma in [-24, 6]
    assert exponent_bounds([-6, -4, -2], 5) == (-30, 4)
    assert magic_path(torch.int8, -30, 4) and magic_path(torch.int16, -30, 4)
    # the old fast_int edges: -126 is inside both ranges, 113 inside neither
    assert magic_path(torch.int8, -126, 112) and not magic_path(torch.int8, -126, 113)
    assert magic_path(torch.int16, -126, 104) and not magic_path(torch.int16, -126, 105)
    assert magic_path(torch.int8, -141, 0) and not magic_path(torch.int8, -142, 0)
    assert magic_path(torch.int16, -149, 0) and not magic_path(torch.int16, -150, 0)
    assert not magic_path(torch.float32, 0, 0) and not magic_path(torch.bfloat16, 0, 0)


# ---------------------------------------------------------------------------
# the whole accumulate, against lut_affine_ref and the Pallas kernel
# ---------------------------------------------------------------------------


def _case(seed, B, n, k, E, p, dtype, shift_bits, edge_entries=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, E, (B, n, k)).astype(np.int32)
    if shift_bits:
        exp = rng.integers(0, 31, (B, 1, k)).astype(np.int32)
        exp[0, 0, :2] = (0, 30)  # sigma exponents -24 and +5 at the edges
        codes = codes + (exp << shift_bits)
    if dtype in (torch.int8, torch.int16):
        top = 127 if dtype == torch.int8 else 32767
        tables = rng.integers(-top, top + 1, (k, E, p)).astype(np.float32)
        if edge_entries:
            tables[..., :3] = (0, top, -top)
    else:
        tables = rng.standard_normal((k, E, p)).astype(np.float32)
    return codes, tables


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    # fp32 sums taken in another order
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-5, atol=1e-5 * max(1e-30, np.abs(want).max())
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.int16])
@pytest.mark.parametrize("shift_bits", [0, 5])
def test_kernel_arithmetic_matches_plain(dtype, shift_bits):
    codes, tables = _case(11, 5, 3, 13, 32, 40, dtype, shift_bits, edge_entries=True)
    scales = np.array([2.0**-6, 2.0**-4, -(2.0**-2)], np.float32)
    exps, neg = ops.plane_shifts(scales)
    t = torch.from_numpy(tables).to(dtype)
    c = torch.from_numpy(codes)
    got = lut_affine_kernel_ref(c, t, exps, neg, shift_bits)
    want = lut_affine_ref(c, t, torch.from_numpy(scales), shift_bits)
    _close(got, want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("edge", ["lo", "hi"])
def test_kernel_arithmetic_at_the_fast_int_edges_matches_pallas(dtype, edge):
    """Total exponents reaching the old fast_int edges: -126 (a plane scale
    of 2**-102 with sigma -24) and 113 (2**107 with sigma +6), on entries
    0, +-127 / +-32767; against lut_affine_ref and the TPU kernel run by
    Pallas' interpreter.  At 113 one chunk per row takes the top exponent
    and the rest sigma -24, so that a sum of +-32767 * 2**113 terms does not
    overflow fp32."""
    shift_bits = 5
    n = 2 if edge == "lo" else 1
    codes, tables = _case(12, 3, n, 4, 32, 8, dtype, shift_bits, edge_entries=True)
    codes &= 31
    if edge == "hi":
        codes[:, :, 1] |= 31 << shift_bits  # sigma +6; the others max(0, 1) - 25 = -24
    else:
        codes[:, :, 1] |= 30 << shift_bits  # sigma +5
    pe = -102 if edge == "lo" else 107
    scales = np.array([2.0**pe, -(2.0 ** (pe + 1))][:n], np.float32)
    exps, neg = ops.plane_shifts(scales)
    lo, hi = exponent_bounds(exps, shift_bits)
    assert (lo if edge == "lo" else hi) == (-126 if edge == "lo" else 113)
    # -126 takes the magic path, 113 the general one
    assert magic_path(dtype, lo, hi) == (edge == "lo")
    t = torch.from_numpy(tables).to(dtype)
    c = torch.from_numpy(codes)
    got = lut_affine_kernel_ref(c, t, exps, neg, shift_bits)
    assert torch.isfinite(got).all()
    want = lut_affine_ref(c, t, torch.from_numpy(scales), shift_bits)
    _close(got, want)
    jd = jnp.int8 if dtype == torch.int8 else jnp.int16
    pallas = jops.lut_affine(
        jnp.asarray(codes), jnp.asarray(tables).astype(jd), jnp.asarray(scales),
        shift_bits=shift_bits, interpret=True, blocks=(8, 128, 2),
    )
    _close(got, pallas)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_kernel_arithmetic_at_the_magic_edges(dtype):
    """Exponents at the magic range's own edges (i8 -141 / 112, i16 -149 /
    104), no shift bits: every term exact, the sums within fp32 order."""
    _, _, _, lo, hi = MAGIC[dtype]
    for pe in (lo, hi):
        codes, tables = _case(13, 2, 1, 6, 16, 8, dtype, 0, edge_entries=True)
        t = torch.from_numpy(tables).to(dtype)
        c = torch.from_numpy(codes)
        assert magic_path(dtype, *exponent_bounds([pe], 0))
        got = lut_affine_kernel_ref(c, t, [pe], 0, 0)
        rows = t[torch.arange(6), c].to(torch.float64) * 2.0**pe  # (2, 1, 6, 8)
        want = rows.sum(dim=(1, 2)).to(torch.float32)
        _close(got, want)
