"""The Hopper kernels (weight family: ``lut_affine`` in both its decode
and prefill kernels, and its ragged MoE form ``lut_affine_experts``; TL1: ``lut_tl1``; the binary-matmul mode:
``bitplane_pack`` and ``binary_matmul``) against their plain PyTorch
versions, on the card.  The
kernels have no CPU mode, so every test here is marked ``cuda`` and skips
without a card.  The file imports neither JAX nor the JAX package, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.binary_matmul import ops as bmm_ops
from repro_torch.kernels.bitplane_pack import ops as pack_ops
from repro_torch.kernels.lut_affine import ops
from repro_torch.kernels.lut_affine.ref import experts_kernel_ref
from repro_torch.kernels.lut_tl1 import ops as tl1_ops

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8, "i16": torch.int16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, B, n, k, E, p, G, dtype, shift_bits):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, E, (B, n, k)).astype(np.int32)
    if shift_bits:
        exp = rng.integers(0, 31, (B, 1, k)).astype(np.int32)
        codes = codes + (exp << shift_bits)
    if dtype in ("i8", "i16"):
        hi = 127 if dtype == "i8" else 32767
        tables = rng.integers(-hi, hi + 1, (G, k, E, p)).astype(np.float32)
    else:
        tables = rng.standard_normal((G, k, E, p)).astype(np.float32)
    scales = (2.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    scales[-1] = -scales[-1]  # a negative plane (signed fixed-point MSB)
    return codes, torch.from_numpy(tables).to(DTYPES[dtype]), scales


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    got, want = got.cpu().numpy(), want.cpu().numpy()
    # fp32 sums taken in another order
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * max(1e-30, np.abs(want).max())
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift_bits", [0, 5])
def test_kernels_match_plain_on_card(cuda_device, dtype, shift_bits):
    # B = 10 rows over 130 columns: few output tiles, so the launch also
    # splits k across blocks; ragged B and p edges
    codes, tables, scales = _case(7, 10, 3, 77, 32, 130, 2, dtype, shift_bits)
    c, t = torch.from_numpy(codes).to(cuda_device), tables.to(cuda_device)
    lead = c.reshape(2, 5, 3, 77)
    before = dict(ops.LAUNCHES)
    got1 = ops.lut_affine(lead, t[0], scales, shift_bits=shift_bits)
    got2 = ops.lut_affine_grouped(c, t, scales, shift_bits=shift_bits)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lut_affine"] == before["lut_affine"] + 1
    assert ops.LAUNCHES["lut_affine_grouped"] == before["lut_affine_grouped"] + 1
    want = ops.lut_affine_grouped(c, t, scales, shift_bits=shift_bits, use_kernels=False)
    assert tuple(got1.shape) == (2, 5, 130)
    _close(got1.reshape(10, 130), want[0])
    _close(got2, want)


@pytest.mark.cuda
def test_kernels_take_bias_and_one_row(cuda_device):
    codes, tables, scales = _case(8, 1, 3, 64, 32, 96, 2, "i8", 5)
    c, t = torch.from_numpy(codes).to(cuda_device), tables.to(cuda_device)
    bias = torch.randn((2, 96), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    got = ops.lut_affine_grouped(c, t, scales, biases=bias, shift_bits=5)
    want = ops.lut_affine_grouped(
        c, t, scales, biases=bias, shift_bits=5, use_kernels=False
    )
    _close(got, want)
    got1 = ops.lut_affine(c, t[1], scales, bias=bias[1], shift_bits=5)
    _close(got1, want[1])


def _dense_matches_plain(codes, tables, scales, shift_bits, device):
    """Both dense entries (the lone one on each table set, the grouped one on
    all of them) against the plain version, within 1e-5 x max|plain|."""
    c = torch.from_numpy(codes).to(device)
    t = tables.to(device)
    before = dict(ops.LAUNCHES)
    grouped = ops.lut_affine_grouped(c, t, scales, shift_bits=shift_bits)
    lone = [ops.lut_affine(c, t[g], scales, shift_bits=shift_bits) for g in range(t.shape[0])]
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lut_affine_grouped"] == before["lut_affine_grouped"] + 1
    assert ops.LAUNCHES["lut_affine"] == before["lut_affine"] + t.shape[0]
    want = ops.lut_affine_grouped(c, t, scales, shift_bits=shift_bits, use_kernels=False)
    _close(grouped, want)
    for g, got in enumerate(lone):
        _close(got, want[g])


def _regime(B, n, k, E, tables):
    G, _, _, p = tables.shape
    vec = 16 // tables.element_size()
    row_bytes = -(-p // vec) * vec * tables.element_size()
    return ops.tiling(G, B, n, k, E, row_bytes, torch.cuda.get_device_properties(0)
                      .multi_processor_count)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("B", [1, 4, 16, 17, 64, 128, 129])
def test_dense_rows_across_the_regimes_on_card(cuda_device, n, B):
    # n = 3: decode below 11 rows; n = 1: below 32; 64-row prefill tiles
    codes, tables, scales = _case(30 + B, B, n, 40, 32, 1000, 2, "i8", 5)
    t = _regime(B, n, 40, 32, tables)
    assert t.regime == ("decode" if B * n < 32 else "prefill")
    _dense_matches_plain(codes, tables, scales, 5, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["i8", "f32"])
@pytest.mark.parametrize("B", [3, 70])
@pytest.mark.parametrize("p", [130, 513, 1000, 4100])
def test_dense_ragged_slabs_on_card(cuda_device, dtype, B, p):
    # p ragged to the 512-byte slab; i8 rows of 130 / 513 / 1000 / 4100
    # bytes are not 16-byte multiples, so the wrapper pads a copy
    codes, tables, scales = _case(40 + p, B, 3, 24, 32, p, 1, dtype, 5)
    _dense_matches_plain(codes, tables, scales, 5, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["i8", "i16"])
@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("B", [4, 80])
def test_dense_takes_an_unaligned_table_base_on_card(cuda_device, dtype, offset, B):
    codes, tables, scales = _case(50 + offset, B, 3, 20, 32, 256, 2, dtype, 5)
    flat = torch.zeros(offset + tables.numel(), dtype=tables.dtype, device=cuda_device)
    flat[offset:] = tables.reshape(-1).to(cuda_device)
    view = flat[offset:].reshape(tables.shape)
    assert view.data_ptr() % 16 != 0
    _dense_matches_plain(codes, view, scales, 5, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 11, 32])
@pytest.mark.parametrize("B", [2, 40])
def test_dense_groups_and_planes_on_card(cuda_device, G, n, B):
    codes, tables, scales = _case(60 + n, B, n, 30, 32, 300, G, "i8", 5)
    _dense_matches_plain(codes, tables, scales, 5, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift_bits", [0, 5])
@pytest.mark.parametrize("B", [5, 90])
def test_dense_table_types_and_shifts_on_card(cuda_device, dtype, shift_bits, B):
    codes, tables, scales = _case(70 + B, B, 3, 33, 32, 520, 2, dtype, shift_bits)
    _dense_matches_plain(codes, tables, scales, shift_bits, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["i8", "i16"])
@pytest.mark.parametrize("edge", ["lo", "hi"])
@pytest.mark.parametrize("B", [4, 80])
def test_dense_integer_tables_off_the_magic_range_on_card(cuda_device, dtype, edge, B):
    # total exponents past the magic word's range (i8 [-141, 112], i16
    # [-149, 104]) take the general path: -150 (subnormal terms) and 113
    # (one chunk a row at sigma +6, the rest at -24, so sums stay finite)
    codes, tables, _ = _case(90 + B, B, 1, 4, 32, 200, 2, dtype, 5)
    codes &= 31
    if edge == "hi":
        codes[:, :, 1] |= 31 << 5
        scales = np.array([2.0**107], np.float32)
    else:
        codes[:, :, 1] |= 29 << 5
        scales = np.array([-(2.0**-126)], np.float32)
    _dense_matches_plain(codes, tables, scales, 5, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,p", [(4, 512, 4096), (128, 256, 1024)])
def test_dense_split_sums_are_deterministic_on_card(cuda_device, B, k, p):
    codes, tables, scales = _case(80 + B, B, 3, k, 32, p, 1, "i8", 5)
    assert _regime(B, 3, k, 32, tables).splits > 1
    c, t = torch.from_numpy(codes).to(cuda_device), tables[0].to(cuda_device)
    first = ops.lut_affine(c, t, scales, shift_bits=5)
    for _ in range(3):
        assert torch.equal(ops.lut_affine(c, t, scales, shift_bits=5), first)
    want = ops.lut_affine(c, t, scales, shift_bits=5, use_kernels=False)
    _close(first, want)


def _tl1_case(seed, lead, kb, p, G, act_bits):
    """Codes (..., 4*kb) with a zero-padded ragged tail, packed tables whose
    nibbles are base-3 pair indices 0..8, scales and biases."""
    rng = np.random.default_rng(seed)
    q = 4 * kb - 3  # ragged: the last packed row holds one real element
    if act_bits is None:
        acts = rng.standard_normal(lead + (4 * kb,)).astype(np.float32)
        act_scale = None
    else:
        qa = 2 ** (act_bits - 1) - 1
        acts = rng.integers(-qa, qa + 1, lead + (4 * kb,)).astype(np.int32)
        act_scale = torch.from_numpy(rng.random(lead + (1,)).astype(np.float32))
    acts[..., q:] = 0
    nib = rng.integers(0, 9, (G, kb, p, 2))
    tables = (nib[..., 0] | (nib[..., 1] << 4)).astype(np.uint8)
    scale = torch.from_numpy(rng.random(G).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((G, p)).astype(np.float32))
    return torch.from_numpy(acts), act_scale, torch.from_numpy(tables), scale, bias


def _tl1_same(got: torch.Tensor, want: torch.Tensor, exact: bool) -> None:
    if exact:  # integer accumulate: bit for bit
        assert torch.equal(got, want), (got - want).abs().max().item()
    else:  # fp32 sums in another order
        _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("act_bits", [8, 4, None])
@pytest.mark.parametrize(
    "lead,kb,p",
    [
        ((4,), 1024, 4096),  # decode wq: few output tiles, split packed rows
        ((2, 5), 77, 130),  # leading dims, 8-row tiles, ragged p
        ((3,), 50, 67),  # p not a multiple of 4: byte loads
        ((40,), 9, 256),  # fewer packed rows than one per warp
    ],
)
def test_tl1_kernels_match_plain_on_card(cuda_device, act_bits, lead, kb, p):
    acts, act_scale, tables, scale, bias = _tl1_case(9, lead, kb, p, 2, act_bits)
    acts, tables = acts.to(cuda_device), tables.to(cuda_device)
    scale, bias = scale.to(cuda_device), bias.to(cuda_device)
    if act_scale is not None:
        act_scale = act_scale.to(cuda_device)
    before = dict(tl1_ops.LAUNCHES)
    got1 = tl1_ops.lut_tl1(acts, tables[1], act_scale, scale[1], bias=bias[1])
    got2 = tl1_ops.lut_tl1_grouped(acts, tables, act_scale, scale, biases=bias)
    raw = tl1_ops.lut_tl1_grouped(acts, tables)
    torch.cuda.synchronize()
    assert tl1_ops.LAUNCHES["lut_tl1"] == before["lut_tl1"] + 1
    assert tl1_ops.LAUNCHES["lut_tl1_grouped"] == before["lut_tl1_grouped"] + 2
    want = tl1_ops.lut_tl1_grouped(
        acts, tables, act_scale, scale, biases=bias, use_kernels=False
    )
    want_raw = tl1_ops.lut_tl1_grouped(acts, tables, use_kernels=False)
    assert tuple(got1.shape) == lead + (p,)
    assert tuple(got2.shape) == (2,) + lead + (p,)
    exact = act_bits is not None
    _tl1_same(raw, want_raw, exact)
    _tl1_same(got2, want, exact)
    _tl1_same(got1, want[1], exact)


# E, G, T, n, k, En, p, group sizes (a sum below T leaves a zero tail)
EXPERT_CASES = [
    (5, 2, 11, 3, 77, 32, 130, (3, 0, 6, 2, 0)),  # gate+up, empty experts, T % 4
    (3, 3, 9, 3, 40, 32, 96, (0, 9, 0)),  # G = 3, every row on one expert
    (4, 1, 1, 3, 64, 32, 67, (0, 0, 1, 0)),  # T = 1, p not a multiple of 4
    (6, 1, 30, 3, 33, 32, 64, (5, 1, 0, 7, 4, 2)),  # 19 rows: an 11-row zero tail
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift_bits", [0, 5])
@pytest.mark.parametrize("case", EXPERT_CASES, ids=["gate_up", "g3", "t1", "tail"])
def test_experts_kernel_matches_plain_on_card(cuda_device, dtype, shift_bits, case):
    E, G, T, n, k, En, p, sizes = case
    codes, tables, scales = _case(11 + T, T, n, k, En, p, E * G, dtype, shift_bits)
    c = torch.from_numpy(codes).to(cuda_device)
    t = tables.reshape(E, G, k, En, p).to(cuda_device)
    gs = torch.tensor(sizes, dtype=torch.int64, device=cuda_device)
    before = ops.LAUNCHES["lut_affine_experts"]
    got = ops.lut_affine_experts(c, t, scales, gs, shift_bits=shift_bits)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lut_affine_experts"] == before + 1
    want = ops.lut_affine_experts(
        c, t, scales, gs, shift_bits=shift_bits, use_kernels=False
    )
    assert tuple(got.shape) == (G, T, p)
    _close(got, want)
    assert not got[:, sum(sizes):].any()


def _experts_splits(G, T, k, t):
    """The ragged launch's k ranges for tables ``t`` (ops.experts_tiling on
    the row pitch the kernel reads)."""
    vec = 16 // t.element_size()
    row_bytes = -(-t.shape[-1] // vec) * vec * t.element_size()
    return ops.experts_tiling(G, T, k, row_bytes, torch.cuda.get_device_properties(0)
                              .multi_processor_count).splits


# group sizes whose 4-row blocks hold rows of two to four experts (the
# first block: experts 0, 1, 1, 2; then blocks of four, three and two)
SPANNING = [(1, 2, 1, 1, 1, 1, 3, 2, 0, 2), (2, 2, 1, 1, 1, 1, 4, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift_bits", [0, 5])
@pytest.mark.parametrize("sizes", SPANNING, ids=["with_tail", "no_tail"])
def test_experts_blocks_span_experts_on_card(cuda_device, dtype, shift_bits, sizes):
    """Blocks whose rows belong to different experts: within 1e-5 x
    max|plain|, and bit for bit the CPU mirror of the kernel's grid and sum
    order (``experts_kernel_ref``), tail rows 0."""
    E, G, T, n, k, En, p = len(sizes), 2, 16, 3, 45, 32, 100
    codes, tables, scales = _case(21 + E, T, n, k, En, p, E * G, dtype, shift_bits)
    tables = tables.reshape(E, G, k, En, p)
    c, t = torch.from_numpy(codes).to(cuda_device), tables.to(cuda_device)
    gs = torch.tensor(sizes, dtype=torch.int64)
    got = ops.lut_affine_experts(c, t, scales, gs.to(cuda_device), shift_bits=shift_bits)
    want = ops.lut_affine_experts(c, t, scales, gs.to(cuda_device), shift_bits=shift_bits,
                                  use_kernels=False)
    _close(got, want)
    assert not got[:, sum(sizes):].any()
    exps, neg = ops.plane_shifts(scales)
    mirror = experts_kernel_ref(torch.from_numpy(codes), tables, exps, neg, gs, shift_bits,
                                _experts_splits(G, T, k, tables))
    assert torch.equal(got.cpu(), mirror)


def _routed_sizes(rng, E, rows, live):
    """Rows per expert of ``live`` top-4 routed rows (4 distinct experts a
    token) over ``E`` experts, padded with a zero tail to ``rows``."""
    ex = np.concatenate([rng.choice(E, 4, replace=False) for _ in range(live // 4)])
    sizes = np.bincount(ex, minlength=E)
    assert sizes.sum() == live <= rows
    return tuple(int(v) for v in sizes)


def _full_width_case(device, seed, G, T, k, p, sizes):
    """qwen2_moe_a2_7b's 60 experts at full width (i8, radix-4 bitplane
    codes with shift bits 5, 32 entries), made on the card from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    E, n, En = len(sizes), 3, 32
    idx = torch.randint(0, En, (T, n, k), generator=gen, device=device, dtype=torch.int32)
    exp = torch.randint(0, 31, (T, 1, k), generator=gen, device=device, dtype=torch.int32)
    tables = torch.randint(-127, 128, (E, G, k, En, p), generator=gen, device=device,
                           dtype=torch.int8)
    scales = np.array([2.0**-6, 2.0**-4, -(2.0**-2)], np.float32) * np.float32(2.0**-6)
    gs = torch.tensor(sizes, dtype=torch.int64, device=device)
    return idx + (exp << 5), tables, scales, gs


@pytest.mark.cuda
@pytest.mark.parametrize("G,k,p", [(2, 2048, 1408), (1, 1408, 2048)], ids=["gate_up", "down"])
def test_experts_full_width_decode_splits_are_deterministic_on_card(cuda_device, G, k, p):
    """16 routed rows on 60 experts, k cut into ranges (11 for w_gate+w_up,
    16 for w_down on 132 SMs); the w_gate+w_up stack is 11 GB, so expert
    bases pass 2**31 bytes.  Four launches give the same bits."""
    sizes = _routed_sizes(np.random.default_rng(G), 60, 16, 16)
    c, t, scales, gs = _full_width_case(cuda_device, G, G, 16, k, p, sizes)
    assert _experts_splits(G, 16, k, t) > 1
    first = ops.lut_affine_experts(c, t, scales, gs, shift_bits=5)
    for _ in range(3):
        assert torch.equal(ops.lut_affine_experts(c, t, scales, gs, shift_bits=5), first)
    _close(first, ops.lut_affine_experts(c, t, scales, gs, shift_bits=5, use_kernels=False))


@pytest.mark.cuda
def test_experts_prefill_shape_on_card(cuda_device):
    """512 rows (125 routed tokens and a 12-row zero tail) on 60 experts at
    w_down's full width: one k range."""
    sizes = _routed_sizes(np.random.default_rng(5), 60, 512, 500)
    c, t, scales, gs = _full_width_case(cuda_device, 5, 1, 512, 1408, 2048, sizes)
    assert _experts_splits(1, 512, 1408, t) == 1
    got = ops.lut_affine_experts(c, t, scales, gs, shift_bits=5)
    _close(got, ops.lut_affine_experts(c, t, scales, gs, shift_bits=5, use_kernels=False))
    assert not got[:, 500:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,p,offset", [("i8", 67, 0), ("f32", 130, 0), ("i8", 64, 3),
                                            ("i16", 96, 1)])
def test_experts_take_tables_the_kernel_cannot_read_directly_on_card(cuda_device, dtype, p,
                                                                     offset):
    """A row pitch that is not a multiple of 16 bytes, or a base off 16
    bytes: the wrapper copies such tables (``table_operand``) first."""
    sizes = (3, 0, 5, 2)
    E, G, T, n, k, En = len(sizes), 2, 12, 3, 30, 32
    codes, tables, scales = _case(31 + p, T, n, k, En, p, E * G, dtype, 5)
    tables = tables.reshape(E, G, k, En, p)
    flat = torch.zeros(offset + tables.numel(), dtype=tables.dtype, device=cuda_device)
    flat[offset:] = tables.reshape(-1).to(cuda_device)
    t = flat[offset:].reshape(tables.shape)
    assert t.data_ptr() % 16 != 0 or p * t.element_size() % 16 != 0
    c = torch.from_numpy(codes).to(cuda_device)
    gs = torch.tensor(sizes, dtype=torch.int64)
    got = ops.lut_affine_experts(c, t, scales, gs.to(cuda_device), shift_bits=5)
    _close(got, ops.lut_affine_experts(c, t, scales, gs.to(cuda_device), shift_bits=5,
                                       use_kernels=False))
    assert not got[:, sum(sizes):].any()
    exps, neg = ops.plane_shifts(scales)
    mirror = experts_kernel_ref(torch.from_numpy(codes), tables, exps, neg, gs, 5,
                                _experts_splits(G, T, k, tables))
    assert torch.equal(got.cpu(), mirror)


# (B, q, m, bits, frac, signed): the binary path's 8/6 signed m = 1 at a
# full-width decode row, ragged q with m 2..4, 2..24 bits, both signs
PACK_FIXED = [
    (4, 4096, 1, 8, 6, True),
    (3, 37, 2, 3, 1, True),
    (5, 70, 3, 4, 2, False),
    (2, 33, 4, 5, 3, True),
    (9, 64, 1, 6, 4, False),
    (300, 7, 3, 7, 0, True),
    (7, 45, 4, 8, 4, False),
    (2, 50, 1, 24, 10, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,q,m,bits,frac,signed", PACK_FIXED)
def test_pack_fixed_matches_plain_on_card(cuda_device, B, q, m, bits, frac, signed):
    rng = np.random.default_rng(B * q + m)
    x = rng.uniform(-4.0, 4.0, (B, q)).astype(np.float32)
    # rounding ties (half to even) and out-of-range inputs (saturation)
    x[0, : min(q, 5)] = np.array([0.5, 1.5, -0.5, -2.5, 1e9], np.float32)[: min(q, 5)] / 2**frac
    xs = torch.from_numpy(x).to(cuda_device).reshape(1, B, q)  # a leading dim
    kw = dict(kind="fixed", bits=bits, frac=frac, signed=signed, m=m)
    before = pack_ops.LAUNCHES["bitplane_pack"]
    got = pack_ops.bitplane_pack(xs, **kw)
    torch.cuda.synchronize()
    assert pack_ops.LAUNCHES["bitplane_pack"] == before + 1
    want = pack_ops.bitplane_pack(xs, use_kernels=False, **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, B, bits, -(-q // m))
    assert torch.equal(got, want)  # bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("B,q,m", [(1, 1, 1), (5, 33, 2), (8, 130, 4), (130, 16, 1), (4, 27, 3)])
def test_pack_float16_matches_plain_on_card(cuda_device, B, q, m):
    rng = np.random.default_rng(q)
    x = rng.uniform(0.0, 100.0, (B, q)) * (rng.uniform(size=(B, q)) > 0.1)
    x[0, : min(q, 6)] = [-3.0, 5.96e-8, 1.2e-7, 6.0e-5, 1e6, 0.0][: min(q, 6)]  # <0, subnormal, inf
    xs = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    kw = dict(kind="float16", m=m)
    got = pack_ops.bitplane_pack(xs, **kw)
    want = pack_ops.bitplane_pack(xs, use_kernels=False, **kw)
    assert tuple(got.shape) == (B, 11, -(-q // m))
    assert torch.equal(got, want)  # bit for bit


def _bmm_case(seed, B, n, q, p):
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy((rng.uniform(size=(B, n, q)) < 0.5).astype(np.int8))
    W = torch.from_numpy((rng.standard_normal((q, p)) / np.sqrt(q)).astype(np.float32))
    scales = (2.0 ** -np.arange(n)).astype(np.float32)
    scales[-1] = -scales[-1]  # the signed MSB plane
    return planes, W, scales


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("plane_dtype", [torch.int8, torch.int32])
@pytest.mark.parametrize(
    "B,n,q,p",
    [
        (4, 8, 4096, 1024),  # decode wk: few output tiles, q split across blocks
        (1, 1, 1, 1),
        (4, 8, 100, 30),  # ragged q and p: element loads
        (65, 11, 300, 140),  # 5 batch rows per block, a ragged last block
        (2, 16, 513, 257),
        (3, 32, 64, 64),  # the most planes the kernel takes
    ],
)
def test_binary_matmul_matches_plain_on_card(cuda_device, w_dtype, plane_dtype, B, n, q, p):
    planes, W, scales = _bmm_case(n * q, B, n, q, p)
    planes = planes.to(plane_dtype).to(cuda_device)
    W = W.to(cuda_device) if w_dtype == "f32" else W.to(torch.bfloat16).to(cuda_device)
    before = bmm_ops.LAUNCHES["binary_matmul"]
    got = bmm_ops.binary_matmul(planes, W, scales)
    torch.cuda.synchronize()
    assert bmm_ops.LAUNCHES["binary_matmul"] == before + 1
    want = bmm_ops.binary_matmul(planes, W, scales, use_kernels=False)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, p)
    _close(got, want)


@pytest.mark.cuda
def test_binary_matmul_takes_leading_dims_bias_and_packed_codes(cuda_device):
    """The binary path as ``linear`` runs it: int32 codes straight from the
    packing kernel (no cast between the two launches), leading dims, bias."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-2.5, 2.5, (2, 3, 200)).astype(np.float32)).to(cuda_device)
    W = torch.from_numpy((rng.standard_normal((200, 72)) / 14).astype(np.float32)).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(72).astype(np.float32)).to(cuda_device)
    planes = pack_ops.bitplane_pack(x, kind="fixed", m=1, bits=8, frac=6, signed=True)
    scales = 2.0 ** (np.arange(8) - 6.0)
    scales[-1] = -scales[-1]
    got = bmm_ops.binary_matmul(planes, W, scales, bias=bias)
    want = bmm_ops.binary_matmul(planes, W, scales, bias=bias, use_kernels=False)
    assert tuple(got.shape) == (2, 3, 72)
    _close(got, want)


# The redesigned binary matmul (TMA + wgmma): folded rows off the 64- and
# 128-row tiles for n in {1, 8, 11, 16}, q off the 64-deep stage, W that the
# tensor map cannot take as it is (p % 8 != 0, an unaligned base, fp32)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 11, 16])
@pytest.mark.parametrize("B", [5, 13])
@pytest.mark.parametrize("plane_dtype", [torch.int8, torch.int32])
def test_binary_matmul_tiles_off_the_row_tile_on_card(cuda_device, n, B, plane_dtype):
    q, p = 1000, 264  # q off the 64-deep stage, p off the 128/256-column tiles
    planes, W, scales = _bmm_case(7 * n + B, B, n, q, p)
    planes = planes.to(plane_dtype).to(cuda_device)
    W = W.to(torch.bfloat16).to(cuda_device)
    got = bmm_ops.binary_matmul(planes, W, scales)
    torch.cuda.synchronize()
    assert bmm_ops.tile(B, n) == (bmm_ops.DECODE_TILE if B * n <= 64 else bmm_ops.PREFILL_TILE)
    _close(got, bmm_ops.binary_matmul(planes, W, scales, use_kernels=False))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [30, 257, 1000])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_binary_matmul_takes_w_the_tensor_map_cannot_describe(cuda_device, p, offset):
    """bf16 W with p % 8 != 0 and W at a base 2 or 6 bytes past alignment
    (a contiguous view into a larger buffer): the wrapper copies it into an
    aligned buffer and the kernel runs; the result is unchanged."""
    q = 300
    planes, W, scales = _bmm_case(p + offset, 4, 8, q, p)
    buf = torch.zeros(q * p + offset, dtype=torch.bfloat16)
    buf[offset:] = W.reshape(-1).to(torch.bfloat16)
    Wd = buf.to(cuda_device)[offset:].view(q, p)
    assert (Wd.data_ptr() % 16 == 0) == (offset == 0)
    Wk = bmm_ops.w_operand(Wd)
    assert (Wk is not Wd) == (offset != 0 or p % 8 != 0)
    assert Wk.data_ptr() % 16 == 0 and Wk.shape[1] % 8 == 0
    before = bmm_ops.LAUNCHES["binary_matmul"]
    got = bmm_ops.binary_matmul(planes.to(cuda_device), Wd, scales)
    torch.cuda.synchronize()
    assert bmm_ops.LAUNCHES["binary_matmul"] == before + 1
    assert tuple(got.shape) == (4, p)
    _close(got, bmm_ops.binary_matmul(planes.to(cuda_device), Wd, scales, use_kernels=False))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [301, 300])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_binary_matmul_takes_planes_the_tensor_map_cannot_describe(cuda_device, q, offset):
    """int32 planes with q % 4 != 0 or at a base 4 or 12 bytes past
    alignment: the wrapper copies them (and pads W's rows to their depth)
    and the kernel runs; the result is unchanged."""
    B, n, p = 4, 8, 96
    planes, W, scales = _bmm_case(q + offset, B, n, q, p)
    buf = torch.zeros(B * n * q + offset, dtype=torch.int32)
    buf[offset:] = planes.reshape(-1).to(torch.int32)
    Pd = buf.to(cuda_device)[offset:].view(B, n, q)
    assert (Pd.data_ptr() % 16 == 0) == (offset == 0)
    assert (bmm_ops.planes_operand(Pd) is not Pd) == (offset != 0 or q % 4 != 0)
    Wd = W.to(torch.bfloat16).to(cuda_device)
    before = bmm_ops.LAUNCHES["binary_matmul"]
    got = bmm_ops.binary_matmul(Pd, Wd, scales)
    torch.cuda.synchronize()
    assert bmm_ops.LAUNCHES["binary_matmul"] == before + 1
    _close(got, bmm_ops.binary_matmul(Pd, Wd, scales, use_kernels=False))


@pytest.mark.cuda
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_binary_matmul_q_split_and_fp32_w_on_card(cuda_device, w_dtype):
    """A decode call that cuts q across blocks (splits > 1, the partials
    added in split order), with an fp32 W (rounded by the wrapper) and a
    bf16 W: the same bits either way."""
    B, n, q, p = 4, 8, 4096, 1024
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert bmm_ops.k_splits(B, n, q, p, sms) > 1
    planes, W, scales = _bmm_case(11, B, n, q, p)
    planes = planes.to(torch.int32).to(cuda_device)
    got = bmm_ops.binary_matmul(planes, W.to(w_dtype).to(cuda_device), scales)
    same = bmm_ops.binary_matmul(planes, W.to(torch.bfloat16).to(cuda_device), scales)
    torch.cuda.synchronize()
    assert torch.equal(got, same)
    _close(got, bmm_ops.binary_matmul(planes, W.to(cuda_device), scales, use_kernels=False))


# The redesigned TL1 template (one folded-LUT lookup per packed byte):
# int8 / int4 / exact codes, codes at +-qa (the largest folded entries),
# packed rows around the 64-row stage of the int16 entries, G = 1, 2, 3,
# p off the 1024-column tile, with the plan (int16 entries where it proves
# them) and without (int32 entries)
@pytest.mark.cuda
@pytest.mark.parametrize("act_bits", [8, 4, None])
@pytest.mark.parametrize("kb", [63, 64, 65, 129])
@pytest.mark.parametrize("G,p", [(1, 1030), (2, 513), (3, 2100)])
@pytest.mark.parametrize("with_plan", [True, False])
def test_tl1_folded_lut_edges_on_card(cuda_device, act_bits, kb, G, p, with_plan):
    from repro_torch.core.lut_tl1 import TL1Plan

    acts, act_scale, tables, scale, bias = _tl1_case(kb + p, (4,), kb, p, G, act_bits)
    if act_bits is not None:  # token 0 at +-qa
        qa = 2 ** (act_bits - 1) - 1
        acts[0, : 4 * kb - 3] = torch.where(acts[0, : 4 * kb - 3] < 0, -qa, qa)
    plan = TL1Plan(4 * kb - 3, p, act_bits=act_bits) if with_plan else None
    fmt = tl1_ops.entry_format(plan, act_bits is None)
    assert fmt == ("float32" if act_bits is None else "int16" if with_plan else "int32")
    acts, tables = acts.to(cuda_device), tables.to(cuda_device)
    got = tl1_ops.lut_tl1_grouped(acts, tables, plan=plan)
    one = tl1_ops.lut_tl1(acts, tables[G - 1], plan=plan)
    torch.cuda.synchronize()
    want = tl1_ops.lut_tl1_grouped(acts, tables, plan=plan, use_kernels=False)
    exact = act_bits is not None
    _tl1_same(got, want, exact)
    _tl1_same(one, want[G - 1], exact)


# ---------------------------------------------------------------------------
# bitplane_pack, redesigned: every kind, fp32 and bf16 input
# ---------------------------------------------------------------------------

PACK_KINDS = {
    "fixed-8-6-signed": dict(kind="fixed", m=1, bits=8, frac=6, signed=True),
    "fixed-12-3-signed-c2": dict(kind="fixed", m=2, bits=12, frac=3, signed=True),
    "fixed-5-1-c1": dict(kind="fixed", m=1, bits=5, frac=1, signed=False),
    "float16": dict(kind="float16", m=1),
    "float16-c3": dict(kind="float16", m=3),
    "shift-r4-signed": dict(kind="shift", m=1, signed=True, radix=4),
    "shift-r1": dict(kind="shift", m=1, radix=1),
    "shift-r11-signed": dict(kind="shift", m=1, signed=True, radix=11),
}
PACK_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# (lead, q, offset): the one-row launch floor, q % 4 != 0, a base one
# element off, leading dims, granite_8b's decode (4 x 4096) and prefill
# (128 x 14336) rows, the MoE widths (2048, 1408 at 16 expert rows, 5632)
PACK_SHAPES = [
    ((1,), 4, 0),
    ((3,), 37, 0),
    ((2,), 4096, 1),
    ((1,), 4098, 0),
    ((2, 3), 1408, 0),
    ((4,), 4096, 0),
    ((128,), 14336, 0),
    ((4,), 2048, 0),
    ((16,), 1408, 0),
    ((4,), 5632, 0),
]
# fp16 rounding's edges: +-0, subnormals (the smallest, ties to 0 and up),
# the smallest normal, RNE ties at 1, 65504, the overflow tie, +-inf
PACK_EDGES = [0.0, -0.0, 2.0**-24, -(2.0**-24), 2.0**-25, 3 * 2.0**-26, 2.0**-26,
              2.0**-14 - 2.0**-24, 2.0**-14, 1 + 2.0**-11, 1 + 3 * 2.0**-11, 65504.0,
              65519.996, 65520.0, -65520.0, 1e6, float("inf"), float("-inf"), -3.0, 0.5]


def _pack_input(device, lead, q, offset, dtype, seed):
    """Seeded values over many magnitudes (fp16 subnormals to overflow,
    both signs, fixed-point ties and saturation), the edges first, as a
    contiguous tensor whose base sits ``offset`` elements into a buffer."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead)) * q
    x = rng.standard_normal(n) * 2.0 ** rng.integers(-26, 18, n)
    x[::3] = rng.uniform(-3.0, 3.0, x[::3].shape)
    x[: min(n, len(PACK_EDGES))] = PACK_EDGES[: min(n, len(PACK_EDGES))]
    flat = torch.from_numpy(np.concatenate([np.zeros(offset), x]).astype(np.float32))
    flat = flat.to(PACK_DTYPES[dtype]).to(device)
    return flat[offset:].view(*lead, q)


def _pack_once(xs, kw):
    """One kernel call, counted once, against the plain version on the card."""
    before = pack_ops.LAUNCHES["bitplane_pack"]
    got = pack_ops.bitplane_pack(xs, **kw)
    torch.cuda.synchronize()
    assert pack_ops.LAUNCHES["bitplane_pack"] == before + 1
    want = pack_ops.bitplane_pack(xs, use_kernels=False, **kw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert got.shape[:-2] == xs.shape[:-1]
    assert torch.equal(got, want)  # bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("lead,q,offset", PACK_SHAPES)
@pytest.mark.parametrize("dtype", list(PACK_DTYPES))
@pytest.mark.parametrize("kind", list(PACK_KINDS))
def test_pack_every_kind_and_dtype_matches_plain_on_card(cuda_device, kind, dtype, lead, q,
                                                         offset):
    xs = _pack_input(cuda_device, lead, q, offset, dtype, q + offset)
    _pack_once(xs, PACK_KINDS[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(PACK_DTYPES))
@pytest.mark.parametrize("kind", ["fixed-8-6-signed", "float16", "shift-r4-signed",
                                  "shift-r11-signed"])
def test_pack_rows_past_the_grid_limit_on_card(cuda_device, kind, dtype):
    # 70000 rows: more than gridDim.y holds, so blocks loop over rows
    _pack_once(_pack_input(cuda_device, (70000,), 8, 0, dtype, 7), PACK_KINDS[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(PACK_DTYPES))
@pytest.mark.parametrize("kind", ["float16", "shift-r4-signed", "shift-r1", "shift-r11-signed"])
def test_pack_fp16_edges_on_card(cuda_device, kind, dtype):
    x = torch.tensor([PACK_EDGES * 2], dtype=torch.float32)  # q = 40: the 4-element path
    xs = x.to(PACK_DTYPES[dtype]).to(cuda_device)
    _pack_once(xs, PACK_KINDS[kind])
    _pack_once(xs[:, 1:], PACK_KINDS[kind])  # q = 39 from a base one element off


@pytest.mark.cuda
def test_pack_covered_plans_never_run_the_plain_version_on_card(cuda_device, monkeypatch):
    from repro_torch.core.lut import LUTPlan
    from repro_torch.core.quantize import FixedPointFormat, Float16Format

    def refuse(*a, **k):
        raise AssertionError("a covered plan ran the plain version")

    monkeypatch.setattr(pack_ops, "bitplane_pack_ref", refuse)
    monkeypatch.setattr(pack_ops, "pack_codes", refuse)
    x = _pack_input(cuda_device, (4,), 4096, 0, "f32", 3)
    plans = [
        LUTPlan(4096, 8, 1, Float16Format(True, 4), mode="bitplane_shift", table_format="i8"),
        LUTPlan(4096, 8, 1, FixedPointFormat(8, 6, True)),
        LUTPlan(4096, 8, 2, Float16Format()),
    ]
    for plan in plans:
        before = pack_ops.LAUNCHES["bitplane_pack"]
        codes = pack_ops.pack(x, plan)
        assert pack_ops.LAUNCHES["bitplane_pack"] == before + 1
        assert codes.shape == (4, plan.num_planes, plan.num_chunks) and codes.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw",
    [
        # the 4-element path asked for on a base one element off
        dict(kind="shift", m=1, bits=16, frac=0, signed=True, radix=4, vec=True, off=1),
        dict(kind="shift", m=1, bits=16, frac=0, signed=True, radix=12, vec=False, off=0),
        dict(kind="fixed", m=1, bits=25, frac=0, signed=True, radix=1, vec=False, off=0),
        dict(kind="float16", m=5, bits=16, frac=0, signed=False, radix=1, vec=False, off=0),
    ],
    ids=["unaligned_vec", "radix_12", "bits_25", "fp16_chunk_5"],
)
def test_pack_invalid_argument_raises_from_the_c_entry(cuda_device, kw):
    kw = dict(kw)
    off = kw.pop("off")
    x2 = torch.zeros(4 * 16 + off, device=cuda_device)[off:].view(4, 16)
    out = torch.empty((4, 25, 16), dtype=torch.int32, device=cuda_device)
    before = pack_ops.LAUNCHES["bitplane_pack"]
    with pytest.raises(RuntimeError, match="CUDA error"):
        pack_ops.launch(x2, out, **kw)
    assert pack_ops.LAUNCHES["bitplane_pack"] == before


# ---------------------------------------------------------------------------
# the paper networks' shapes: fp32 tables over 11 unsigned fp16 planes (E =
# 64 at chunk 1, 4096 at chunk 2), 10-column heads (rows of 40 bytes, which
# the wrapper copies into 48-byte rows every call), the Fig. 5 fixed 3/3
# plan at chunk 14, and the TL1 classifier head
# ---------------------------------------------------------------------------

# (B, k, E, p): linear fc / MLP fc3 / LeNet fc2 heads at chunk 1 (prefill),
# the linear head at chunk 2 (decode), LeNet conv1 and conv2 rows, MLP fc2,
# and the chunk-2 head at 500 rows
PAPER_LUT = [
    (500, 784, 64, 10),
    (500, 512, 64, 10),
    (6, 392, 4096, 10),
    (500, 392, 4096, 10),
    (4000, 25, 64, 32),
    (600, 800, 64, 64),
    (200, 1024, 64, 512),
    (3, 512, 4096, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,k,E,p", PAPER_LUT)
def test_lut_affine_at_the_paper_shapes_on_card(cuda_device, B, k, E, p):
    rng = np.random.default_rng(B + k + E + p)
    codes = torch.from_numpy(rng.integers(0, E, (B, 11, k)).astype(np.int32)).to(cuda_device)
    tables = torch.from_numpy(rng.standard_normal((k, E, p)).astype(np.float32)).to(cuda_device)
    scales = 2.0 ** np.arange(11) * 2.0**-24  # the fp16 planes' scales
    bias = torch.from_numpy(rng.standard_normal(p).astype(np.float32)).to(cuda_device)
    launches, copies = ops.LAUNCHES["lut_affine"], ops.TABLE_COPIES["table_operand"]
    got = ops.lut_affine(codes, tables, scales, bias)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lut_affine"] == launches + 1
    copied = p * 4 % ops.ROW_ALIGN != 0
    assert ops.TABLE_COPIES["table_operand"] == copies + int(copied)
    want = ops.lut_affine(codes, tables, scales, bias, use_kernels=False)
    _close(got, want)
    if copied:  # a pre-padded operand takes no copy and gives the same sums
        padded = torch.nn.functional.pad(tables, (0, -p % 4))
        again = ops.lut_affine(codes, padded, scales)[:, :p] + bias
        assert ops.TABLE_COPIES["table_operand"] == copies + 1
        assert torch.equal(again, got)


# (B, q, m): unsigned fp16 bitplanes of LeNet conv1 / the 784-wide inputs /
# conv2 / LeNet fc1, chunk 1 (conv1's q = 25 takes the scalar path) and
# chunk 2
PAPER_PACK = [(4000, 25, 1), (500, 784, 1), (500, 784, 2), (1000, 800, 1), (500, 3136, 1),
              (500, 1024, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,q,m", PAPER_PACK)
def test_pack_float16_at_the_paper_shapes_on_card(cuda_device, B, q, m):
    rng = np.random.default_rng(B + q + m)
    x = rng.uniform(0.0, 4.0, (B, q)) * (rng.uniform(size=(B, q)) > 0.3)  # ReLU-like
    x[0, :4] = [-1.0, 5.96e-8, 6.0e-5, 7e4]  # clamped, subnormal, normal, inf
    xs = torch.from_numpy(x.astype(np.float32)).to(cuda_device)
    before = pack_ops.LAUNCHES["bitplane_pack"]
    got = pack_ops.bitplane_pack(xs, kind="float16", m=m)
    torch.cuda.synchronize()
    assert pack_ops.LAUNCHES["bitplane_pack"] == before + 1
    assert tuple(got.shape) == (B, 11, -(-q // m))
    assert torch.equal(got, pack_ops.bitplane_pack(xs, kind="float16", m=m, use_kernels=False))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 7, 14])
def test_pack_fixed_3_3_at_the_fig5_chunks_on_card(cuda_device, m):
    rng = np.random.default_rng(m)
    x = rng.uniform(0.0, 1.0, (500, 784)).astype(np.float32)
    x[0, :3] = [1.0, 0.0625, 0.1875]  # saturation and round-half-even ties
    xs = torch.from_numpy(x).to(cuda_device)
    kw = dict(kind="fixed", m=m, bits=3, frac=3, signed=False)
    got = pack_ops.bitplane_pack(xs, **kw)
    assert tuple(got.shape) == (500, 3, -(-784 // m))
    assert int(got.max()) < 2**m
    assert torch.equal(got, pack_ops.bitplane_pack(xs, use_kernels=False, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("act_bits", [None, 8, 4, 2])
def test_tl1_classifier_head_on_card(cuda_device, act_bits):
    from repro_torch.core.lut_tl1 import TL1Plan, build_tl1_tables, quantize_acts

    rng = np.random.default_rng(21)
    plan = TL1Plan(784, 10, act_bits=act_bits)
    w = torch.from_numpy((rng.standard_normal((784, 10)) * 0.05).astype(np.float32))
    tables, scale = build_tl1_tables(w)
    x = torch.from_numpy(rng.uniform(0, 1, (500, 784)).astype(np.float32))
    acts, act_scale = quantize_acts(x.to(cuda_device), plan)
    t, s = tables.to(cuda_device), scale.to(cuda_device)
    before = tl1_ops.LAUNCHES["lut_tl1"]
    got = tl1_ops.lut_tl1(acts, t, act_scale, s, plan=plan)
    torch.cuda.synchronize()
    assert tl1_ops.LAUNCHES["lut_tl1"] == before + 1
    want = tl1_ops.lut_tl1(acts, t, act_scale, s, plan=plan, use_kernels=False)
    _tl1_same(got, want, act_bits is not None)


# ---------------------------------------------------------------------------
# The engine's decode step as a CUDA graph: each served path at a reduced
# config with seeded random weights, the graph engine against the eager one
# ---------------------------------------------------------------------------

GRAPH_PATHS = ["weight", "tl1", "moe", "binary"]
GRAPH_SLOTS, GRAPH_MAX_LEN, GRAPH_MAX_NEW = 3, 32, 6


def _graph_world(path, device):
    """(config, params, ExecCfg fields) of one served path: planned i8
    tables (weight, MoE with its experts), TL1 tables, or bf16 projections
    under the binary-matmul mode."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import bf16_projections, init_params

    cfg = get_config("qwen2_moe_a2_7b" if path == "moe" else "granite_8b", reduced=True)
    gen = torch.Generator(device=device).manual_seed(3)
    params = init_params(model_specs(cfg), gen, device=device)
    if path == "binary":
        return cfg, bf16_projections(params), dict(linear_mode="binary_matmul",
                                                   fixed_bits=8, fixed_frac=6)
    if path == "tl1":
        plan = plan_model(params, float("inf"), families=("tl1",))
    else:
        kw = {"convert_experts": True} if path == "moe" else {}
        uniform = plan_model(params, float("inf"), max_chunk=2, **kw)
        plan = plan_model(params, uniform.total_lut_bytes // 2, max_chunk=2,
                          modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                          table_formats=(None, "i8"), **kw)
    return cfg, convert_params(params, plan=plan, convert_experts=path == "moe")[0], {}


def _graph_prompts(vocab):
    rng = np.random.default_rng(29)
    return [rng.integers(0, vocab, int(rng.integers(3, 12))).astype(np.int32)
            for _ in range(5)]


def _counts_now():
    from repro_torch.kernels.common import launch_counters

    return {k: v for c in launch_counters() for k, v in c.items()}


def _graph_serve(world, cuda_graph, sample, device):
    """Serve the prompts; returns (streams, launches of the run, engine)."""
    from repro_torch.kernels.common import launch_counters
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request

    cfg, params, ex = world
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, **ex))
    eng = BatchingEngine(params, ctx, GRAPH_SLOTS, GRAPH_MAX_LEN, sample=sample, seed=5,
                         device=device, cuda_graph=cuda_graph)
    reqs = [Request(i, p, GRAPH_MAX_NEW) for i, p in enumerate(_graph_prompts(cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    for c in launch_counters():
        c.update(dict.fromkeys(c, 0))
    eng.run()
    torch.cuda.synchronize()
    return [r.generated for r in reqs], _counts_now(), eng


@pytest.mark.cuda
@pytest.mark.parametrize("sample", ["greedy", "top_k"])
@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_graph_engine_matches_the_eager_engine_on_card(cuda_device, path, sample):
    """Whole streams equal; every launch count of the run equal too (the
    replays add what the capture recorded), with as many forwards."""
    from repro_torch.models.layers import SampleCfg

    scfg = SampleCfg() if sample == "greedy" else SampleCfg("top_k", 0.9, 5)
    world = _graph_world(path, cuda_device)
    eager, eager_counts, eager_eng = _graph_serve(world, False, scfg, cuda_device)
    graph, graph_counts, graph_eng = _graph_serve(world, None, scfg, cuda_device)
    assert graph_eng.cuda_graph and graph_eng._graph is not None
    assert graph == eager
    assert graph_eng.readbacks == eager_eng.readbacks
    assert graph_counts == eager_counts
    assert sum(graph_counts.values()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_graph_capture_refuses_a_read_back_on_card(cuda_device, path, monkeypatch):
    """A read-back inside the step makes the capture raise; the step does
    not run eagerly instead: no cache state moves, nothing is read back and
    no launch is counted."""
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request, _engine

    cfg, params, ex = _graph_world(path, cuda_device)
    sample = _engine.sample_tokens

    def reads_back(logits, *a, **kw):
        float(logits.sum().item())
        return sample(logits, *a, **kw)

    monkeypatch.setattr(_engine, "sample_tokens", reads_back)
    eng = BatchingEngine(params, Ctx(cfg, ex=ExecCfg(lut_grouped=True, **ex)), GRAPH_SLOTS,
                         GRAPH_MAX_LEN, device=cuda_device)
    for i, p in enumerate(_graph_prompts(cfg.vocab_size)):
        eng.submit(Request(i, p, GRAPH_MAX_NEW))
    assert eng.step()  # admission prefill and the eager warm-up step
    index, readbacks, counts = eng.cache["index"].clone(), eng.readbacks, _counts_now()
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        eng.step()
    torch.cuda.synchronize()
    assert eng._graph is None
    assert torch.equal(eng.cache["index"], index)
    assert eng.readbacks == readbacks and _counts_now() == counts
