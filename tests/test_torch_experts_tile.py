"""The ragged MoE kernel's host logic and arithmetic, on the CPU: the
wrapper's grid rule (``experts_tiling``: blocks of 4 expert-sorted rows
whatever their experts, k ranges for one wave) and ``ref.py``'s plain
mirror of the kernel (``experts_kernel_ref``: each row's expert counted from
the offsets, zero rows past the groups, the magic-word terms, the halves'
and the k ranges' sums in the kernel's order), held against exact sums,
against ``lut_affine_experts_ref`` and against the JAX package's Pallas
kernel in interpret mode.  The kernel itself runs only on the card
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
    experts_kernel_ref,
    lut_affine_experts_ref,
    magic_path,
)

SMS = 132  # an H100's SMs
DTYPES = {
    "f32": (torch.float32, jnp.float32),
    "bf16": (torch.bfloat16, jnp.bfloat16),
    "i8": (torch.int8, jnp.int8),
    "i16": (torch.int16, jnp.int16),
}
# 1e-5 x max|ref|: the same exact terms summed in another fp32 order
TOL = 1e-5


# ---------------------------------------------------------------------------
# the grid rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "G,T,k,row_bytes,tiles,splits",
    [
        # qwen2_moe_a2_7b decode: 4 tokens x top-4 = 16 rows, i8, radix-4 c1
        (2, 16, 2048, 1408, 24, 11),  # w_gate+w_up: 4 row tiles x G 2 x 3 slabs
        (1, 16, 1408, 2048, 16, 16),  # w_down: 4 x 4 slabs
        # its prefill: 128 tokens = 512 rows fill a wave unsplit
        (2, 512, 2048, 1408, 768, 1),
        (1, 512, 1408, 2048, 512, 1),
    ],
)
def test_experts_tiling_at_the_served_shapes(G, T, k, row_bytes, tiles, splits):
    t = ops.experts_tiling(G, T, k, row_bytes, SMS)
    assert (t.regime, t.rows, t.tiles, t.splits) == ("experts", 4, tiles, splits)
    wave = ops.BLOCKS_PER_SM["decode"] * SMS
    # one wave: the blocks fit it unless the tiles alone do not, and one
    # more range would not
    assert t.tiles * t.splits <= max(t.tiles, wave)
    assert t.splits == k or t.tiles * (t.splits + 1) > wave


@pytest.mark.parametrize("G,T,k,row_bytes", [
    (1, 1, 3, 16), (3, 9, 40, 96), (2, 11, 77, 528), (1, 30, 100000, 65536),
    (2, 10000, 2048, 1408),
])
def test_experts_tiling_one_row_count_never_more_ranges_than_chunks(G, T, k, row_bytes):
    t = ops.experts_tiling(G, T, k, row_bytes, SMS)
    assert t.rows == ops.EXPERT_ROWS == 4
    assert t.slabs == -(-row_bytes // ops.SLAB_BYTES)
    assert t.tiles == G * -(-T // 4) * t.slabs
    assert 1 <= t.splits <= k
    assert t.tiles * t.splits <= max(t.tiles, ops.BLOCKS_PER_SM["decode"] * SMS)


# ---------------------------------------------------------------------------
# the mirror's arithmetic
# ---------------------------------------------------------------------------

# E, G, T, n, k, En, p, group sizes (a sum below T leaves rows past the groups)
CASES = {
    "empty_experts": (5, 2, 11, 3, 77, 32, 40, (3, 0, 6, 2, 0)),
    "one_expert": (3, 3, 9, 3, 40, 32, 24, (0, 9, 0)),
    "t1": (4, 1, 1, 3, 64, 32, 19, (0, 0, 1, 0)),
    "tail": (6, 1, 30, 3, 33, 32, 16, (5, 1, 0, 7, 4, 2)),
    "e60_16_rows": (60, 2, 16, 3, 48, 32, 20, tuple(
        int(v) for v in np.bincount(np.random.default_rng(0).integers(0, 60, 16),
                                    minlength=60))),
}


def _case(seed, E, G, T, n, k, En, p, dtype, shift_bits, scales):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, En, (T, n, k)).astype(np.int32)
    if shift_bits:
        exp = rng.integers(0, 31, (T, 1, k)).astype(np.int32)
        exp[0, 0, :2] = (0, 30)  # sigma exponents -24 and +5 at the edges
        codes = codes + (exp << shift_bits)
    if dtype in ("i8", "i16"):
        top = 127 if dtype == "i8" else 32767
        tables = rng.integers(-top, top + 1, (E, G, k, En, p)).astype(np.float32)
        tables[..., :3] = (0, top, -top)
    else:
        tables = rng.standard_normal((E, G, k, En, p)).astype(np.float32)
    exps, neg = ops.plane_shifts(scales)
    return codes, tables, exps, neg


def _splits(G, T, k, p, dtype):
    size = torch.empty((), dtype=DTYPES[dtype][0]).element_size()
    row_bytes = -(-p * size // 16) * 16  # the aligned pitch the kernel reads
    return ops.experts_tiling(G, T, k, row_bytes, SMS).splits


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=TOL * max(1e-30, np.abs(want).max())
    )


SCALES = np.array([2.0**-6, 2.0**-4, -(2.0**-2)], np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift_bits", [0, 5])
@pytest.mark.parametrize("case", list(CASES))
def test_mirror_matches_plain(dtype, shift_bits, case):
    E, G, T, n, k, En, p, sizes = CASES[case]
    codes, tables, exps, neg = _case(len(case) + T, E, G, T, n, k, En, p, dtype, shift_bits,
                                     SCALES)
    t = torch.from_numpy(tables).to(DTYPES[dtype][0])
    c, gs = torch.from_numpy(codes), torch.tensor(sizes)
    splits = _splits(G, T, k, p, dtype)
    got = experts_kernel_ref(c, t, exps, neg, gs, shift_bits, splits)
    want = lut_affine_experts_ref(c, t, torch.from_numpy(SCALES), gs, shift_bits)
    assert got.shape == (G, T, p) and torch.isfinite(got).all()
    _close(got, want)
    assert not got[:, sum(sizes):].any()
    # the split sums: the same terms, one range at a time
    _close(experts_kernel_ref(c, t, exps, neg, gs, shift_bits, 1), got)


@pytest.mark.parametrize("dtype", ["i8", "i16"])
@pytest.mark.parametrize("case", list(CASES))
def test_mirror_is_exact_on_integer_sums(dtype, case):
    """Integer tables, integer plane scales and no shift bits: every term
    and every partial sum is an integer below 2**24, so any order gives the
    exact sum, bit for bit."""
    E, G, T, n, k, En, p, sizes = CASES[case]
    scales = np.array([1.0, 2.0, -1.0], np.float32)
    codes, tables, exps, neg = _case(7 + T, E, G, T, n, k, En, p, dtype, 0, scales)
    top = 127 if dtype == "i8" else 32767
    assert k * np.abs(scales).sum() * top < 2**24
    t = torch.from_numpy(tables).to(DTYPES[dtype][0])
    got = experts_kernel_ref(torch.from_numpy(codes), t, exps, neg, torch.tensor(sizes), 0,
                             _splits(G, T, k, p, dtype))
    ends = np.cumsum(sizes)
    want = np.zeros((G, T, p), np.int64)
    for r in range(T):
        e = int((ends <= r).sum())
        if e == E:
            continue  # no expert: 0
        rows = tables[e][:, np.arange(k), codes[r]].astype(np.int64)  # (G, n, k, p)
        want[:, r] = np.einsum("gnkp,n->gp", rows, scales.astype(np.int64))
    assert torch.equal(got, torch.from_numpy(want.astype(np.float32)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift_bits", [0, 5])
def test_mirror_matches_pallas_interpret(dtype, shift_bits):
    """Against the reference's Pallas kernel in interpret mode, whose rows
    past ``sum(group_sizes)`` come out 0, as the kernel's do (the JAX
    package's plain ``lut_affine_experts_ref`` gives them the last expert's
    value)."""
    E, G, T, n, k, En, p, sizes = CASES["tail"] if shift_bits else CASES["empty_experts"]
    codes, tables, exps, neg = _case(3 + T, E, G, T, n, k, En, p, dtype, shift_bits, SCALES)
    t = torch.from_numpy(tables).to(DTYPES[dtype][0])
    got = experts_kernel_ref(torch.from_numpy(codes), t, exps, neg, torch.tensor(sizes),
                             shift_bits, _splits(G, T, k, p, dtype))
    want = jops.lut_affine_experts(
        jnp.asarray(codes), jnp.asarray(tables).astype(DTYPES[dtype][1]), jnp.asarray(SCALES),
        jnp.asarray(np.asarray(sizes, np.int32)), interpret=True, shift_bits=shift_bits,
    )
    _close(got, want)
    assert not np.asarray(want)[:, sum(sizes):].any()


def test_mirror_matches_pallas_on_sixty_experts():
    E, G, T, n, k, En, p, sizes = CASES["e60_16_rows"]
    codes, tables, exps, neg = _case(60, E, G, T, n, k, En, p, "i8", 5, SCALES)
    got = experts_kernel_ref(torch.from_numpy(codes), torch.from_numpy(tables).to(torch.int8),
                             exps, neg, torch.tensor(sizes), 5, _splits(G, T, k, p, "i8"))
    want = jops.lut_affine_experts(
        jnp.asarray(codes), jnp.asarray(tables).astype(jnp.int8), jnp.asarray(SCALES),
        jnp.asarray(np.asarray(sizes, np.int32)), interpret=True, shift_bits=5,
    )
    _close(got, want)


@pytest.mark.parametrize("dtype", ["i8", "i16"])
@pytest.mark.parametrize("edge", ["lo", "lo_past", "hi", "hi_past"])
def test_mirror_at_the_magic_edges(dtype, edge):
    """One plane whose exponent is the magic range's edge (i8 -141 / 112,
    i16 -149 / 104), or one past it, where the general path takes over; no
    shift bits.  Each term is x * 2**e rounded once to fp32 (exact but past
    the lower edge of i16, where it falls below fp32's subnormals); the
    want sums those terms exactly."""
    _, _, _, lo, hi = MAGIC[DTYPES[dtype][0]]
    pe = {"lo": lo, "lo_past": lo - 1, "hi": hi, "hi_past": hi + 1}[edge]
    assert magic_path(DTYPES[dtype][0], *exponent_bounds([pe], 0)) == (edge in ("lo", "hi"))
    E, G, T, n, k, En, p, sizes = 3, 2, 7, 1, 6, 16, 8, (2, 0, 4)
    codes, tables, _, _ = _case(13, E, G, T, n, k, En, p, dtype, 0, SCALES[:1])
    t = torch.from_numpy(tables).to(DTYPES[dtype][0])
    got = experts_kernel_ref(torch.from_numpy(codes), t, [pe], 0, torch.tensor(sizes), 0,
                             _splits(G, T, k, p, dtype))
    assert torch.isfinite(got).all()
    ends = np.cumsum(sizes)
    want = np.zeros((G, T, p))
    for r in range(sum(sizes)):
        e = int((ends <= r).sum())
        rows = tables[e][:, np.arange(k), codes[r, 0]].astype(np.float64)  # (G, k, p)
        terms = torch.from_numpy(rows * 2.0**pe).to(torch.float32).double()
        want[:, r] = terms.sum(1).numpy()
    _close(got, torch.from_numpy(want).to(torch.float32))
    assert not got[:, sum(sizes):].any()
