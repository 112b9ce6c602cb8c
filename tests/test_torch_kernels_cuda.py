"""The Hopper kernels (weight family: ``lut_affine`` in both its decode
and prefill kernels, and its ragged MoE form ``lut_affine_experts``; TL1: ``lut_tl1``; the binary-matmul mode:
``bitplane_pack`` and ``binary_matmul``) against their plain PyTorch
versions, on the card, the engine's decode step as a CUDA graph on each
served path (mixtral_8x7b's ring cache among them), and the
``generate()`` of rwkv6_3b on its recurrent state, of zamba2_1_2b on
its SSD states and shared block's K/V and of whisper_base's
encoder-decoder on its self and cross K/V; the five LUT wrappers under
tuned tiles (``kernels/lut_affine/autotune.py``).  The
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
from repro_torch.kernels.lut_affine import autotune, ops
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


# ---------------------------------------------------------------------------
# The dense kernels at full-width phi3_medium_14b and minitron_4b: every new
# call shape at decode (4 rows, the serving recipe's 3 planes of 32-entry i8
# tables with shift_bits 5), and the untied heads at decode and prefill;
# minitron's head (25.2 GB) is the largest table any kernel has read
# ---------------------------------------------------------------------------

# name -> (G, k, p)
FAMILY_CALLS = {
    "phi3_wq_wo": (1, 5120, 5120), "phi3_wk_wv": (2, 5120, 1280),
    "phi3_w_gate_w_up": (2, 5120, 17920), "phi3_w_down": (1, 17920, 5120),
    "minitron_wq_wo": (1, 3072, 3072), "minitron_wk_wv": (2, 3072, 1024),
    "minitron_w_in": (1, 3072, 9216), "minitron_w_out": (1, 9216, 3072),
}
FAMILY_SCALES = np.asarray([2.0**-3, 2.0**-5, -(2.0**-7)])  # radix-4 planes, signed top


def _family_case(device, seed, B, G, k, p):
    """Codes (B, 3, k) with exponents in their high bits and i8 tables (G, k,
    32, p), drawn on the card (the heads' tables would take minutes from the
    host)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(0, 32, (B, 3, k), generator=gen, device=device, dtype=torch.int32)
    codes += torch.randint(0, 31, (B, 1, k), generator=gen, device=device,
                           dtype=torch.int32) << 5
    tables = torch.randint(-127, 128, (G, k, 32, p), generator=gen, device=device,
                           dtype=torch.int8)
    return codes, tables


def _family_call(codes, tables, use_kernels=True):
    if tables.shape[0] == 1:
        return ops.lut_affine(codes, tables[0], FAMILY_SCALES, shift_bits=5,
                              use_kernels=use_kernels)[None]
    return ops.lut_affine_grouped(codes, tables, FAMILY_SCALES, shift_bits=5,
                                  use_kernels=use_kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FAMILY_CALLS))
def test_family_decode_shapes_match_plain_on_card(cuda_device, name):
    """Each call at its decode shape: the decode kernel, k split for one
    wave (phi3's w_down cuts the longest k yet, 17,920 chunks), one launch,
    no table copy, within 1e-5 x max|plain|."""
    G, k, p = FAMILY_CALLS[name]
    codes, tables = _family_case(cuda_device, len(name), 4, G, k, p)
    t = _regime(4, 3, k, 32, tables)
    assert t.regime == "decode" and t.splits > 1
    entry = "lut_affine" if G == 1 else "lut_affine_grouped"
    launches, copies = ops.LAUNCHES[entry], ops.TABLE_COPIES["table_operand"]
    got = _family_call(codes, tables)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[entry] == launches + 1
    assert ops.TABLE_COPIES["table_operand"] == copies
    _close(got, _family_call(codes, tables, use_kernels=False))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 128], ids=["decode", "prefill"])
@pytest.mark.parametrize("k,p", [(5120, 100352), (3072, 256000)], ids=["phi3", "minitron"])
def test_family_heads_match_plain_on_card(cuda_device, k, p, B):
    """The untied heads, 5120 -> 100,352 (16.4 GB of tables) and 3072 ->
    256,000 (25.2 GB), each past 2**32 bytes (a table offset needs 64
    bits): decode rows and a 128-row prefill (the tensor map over all
    k x 32 table rows), within 1e-5 x max|plain|."""
    codes, tables = _family_case(cuda_device, p + B, B, 1, k, p)
    assert tables.numel() > 2**32
    assert _regime(B, 3, k, 32, tables).regime == ("decode" if B == 4 else "prefill")
    got = _family_call(codes, tables)
    torch.cuda.synchronize()
    _close(got, _family_call(codes, tables, use_kernels=False))


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

GRAPH_PATHS = ["weight", "tl1", "moe", "binary", "mla", "phi3", "relu2", "vlm"]
GRAPH_SLOTS, GRAPH_MAX_LEN, GRAPH_MAX_NEW = 3, 32, 6


def _graph_world(path, device):
    """(config, params, ExecCfg fields) of one served path: planned i8
    tables (weight, MoE with its experts, mixtral_8x7b's ring and top-2
    experts, minicpm3_4b's MLA with its latent
    up-projections vetoed, phi3_medium_14b with its G = 3 ``wq+wk+wv``
    group, minitron_4b's two-matrix squared-ReLU MLP, llava_next_mistral_7b
    served text-only by the engine), TL1 tables, or bf16 projections under
    the binary-matmul mode."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.models.layers import mla_convertible
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import bf16_projections, init_params

    name = {"moe": "qwen2_moe_a2_7b", "mla": "minicpm3_4b", "phi3": "phi3_medium_14b",
            "relu2": "minitron_4b", "swa": "mixtral_8x7b",
            "vlm": "llava_next_mistral_7b"}.get(path, "granite_8b")
    cfg = get_config(name, reduced=True)
    gen = torch.Generator(device=device).manual_seed(3)
    params = init_params(model_specs(cfg), gen, device=device)
    if path == "binary":
        return cfg, bf16_projections(params), dict(linear_mode="binary_matmul",
                                                   fixed_bits=8, fixed_frac=6)
    kw = {"moe": {"convert_experts": True}, "swa": {"convert_experts": True},
          "mla": {"predicate": mla_convertible}}.get(path, {})
    if path == "tl1":
        plan = plan_model(params, float("inf"), families=("tl1",))
    else:
        uniform = plan_model(params, float("inf"), max_chunk=2, **kw)
        plan = plan_model(params, uniform.total_lut_bytes // 2, max_chunk=2,
                          modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                          table_formats=(None, "i8"), **kw)
    return cfg, convert_params(params, plan=plan, **kw)[0], {}


def _graph_prompts(vocab):
    rng = np.random.default_rng(29)
    return [rng.integers(0, vocab, int(rng.integers(3, 12))).astype(np.int32)
            for _ in range(5)]


def _counts_now():
    from repro_torch.kernels.common import launch_counters

    return {k: v for c in launch_counters() for k, v in c.items()}


def _graph_serve(world, cuda_graph, sample, device, prompts=None, max_new=GRAPH_MAX_NEW,
                 **kw):
    """Serve the prompts (``_graph_prompts``' by default; ``kw`` further
    engine arguments); returns (streams, launches of the run, engine)."""
    from repro_torch.kernels.common import launch_counters
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request

    cfg, params, ex = world
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, **ex))
    eng = BatchingEngine(params, ctx, GRAPH_SLOTS, GRAPH_MAX_LEN, sample=sample, seed=5,
                         device=device, cuda_graph=cuda_graph, **kw)
    if prompts is None:
        prompts = _graph_prompts(cfg.vocab_size)
    reqs = [Request(i, p, max_new) for i, p in enumerate(prompts)]
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
@pytest.mark.parametrize("path", ["weight", "tl1", "moe", "binary", "onehot"])
def test_plain_graph_engine_matches_the_plain_eager_engine_on_card(cuda_device, path):
    """The plain versions' engine (``use_kernels=False``; ``onehot``: the
    weight tree under ``linear_mode="onehot_mxu"``, whose non-shift plans
    take the one-hot product) under the default CUDA graph serves the eager
    engine's streams whole, launching no kernel: the plain versions read
    their plane scales from device tensors that the eager warm-up step
    made (``kernels/common.py::device_scales``), so the captured step
    copies nothing from the host."""
    from repro_torch.kernels.binary_matmul import ops as bmm_ops
    from repro_torch.kernels.bitplane_pack import ops as pack_ops
    from repro_torch.kernels.lut_affine import ops as lut_ops
    from repro_torch.kernels.lut_tl1 import ops as tl1_ops
    from repro_torch.models.layers import SampleCfg

    cfg, params, ex = _graph_world("weight" if path == "onehot" else path, cuda_device)
    ex = {**ex, "use_kernels": False,
          **({"linear_mode": "onehot_mxu"} if path == "onehot" else {})}
    world = (cfg, params, ex)
    eager, eager_counts, _ = _graph_serve(world, False, SampleCfg(), cuda_device)
    graph, graph_counts, eng = _graph_serve(world, None, SampleCfg(), cuda_device)
    assert eng.cuda_graph and eng._graph is not None
    assert graph == eager
    assert graph_counts == eager_counts
    kernels = {k for c in (lut_ops.LAUNCHES, tl1_ops.LAUNCHES, pack_ops.LAUNCHES,
                           bmm_ops.LAUNCHES) for k in c}
    assert not any(graph_counts[k] for k in kernels)


@pytest.mark.cuda
def test_a_dead_engines_graph_leaves_a_capture_alone_on_card(cuda_device):
    """An engine whose captured graph only the cyclic collector can free:
    it is freed before the next engine's capture, never during it (a graph
    destroyed mid-capture invalidates the capture)."""
    import gc

    from repro_torch.models.layers import SampleCfg

    world = _graph_world("weight", cuda_device)
    streams, _, eng = _graph_serve(world, None, SampleCfg(), cuda_device)
    assert eng._graph is not None
    eng.cycle = eng
    del eng
    threshold = gc.get_threshold()
    gc.set_threshold(1)  # a collection at nearly every allocation
    try:
        again, _, eng = _graph_serve(world, None, SampleCfg(), cuda_device)
    finally:
        gc.set_threshold(*threshold)
    assert eng._graph is not None and again == streams


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


# ---------------------------------------------------------------------------
# The paged KV cache under the decode step's CUDA graph: the page table is
# one device tensor, updated in place between replays
# ---------------------------------------------------------------------------

PAGE = 4


def _paged_prompts(vocab):
    """Two prompts open with one shared 8-token system prompt (two pages),
    one IS that prompt (a whole-prompt hit: copy-on-write), two share
    nothing."""
    rng = np.random.default_rng(31)
    system = rng.integers(0, vocab, 2 * PAGE).astype(np.int32)
    own = [rng.integers(0, vocab, n).astype(np.int32) for n in (3, 5, 7, 2)]
    return [np.concatenate([system, own[0]]), own[2], np.concatenate([system, own[1]]),
            system.copy(), own[3]]


@pytest.mark.cuda
@pytest.mark.parametrize("path", GRAPH_PATHS)
def test_paged_graph_engine_matches_the_eager_engine_on_card(cuda_device, path):
    """The paged engine (page_size 4, shared prefixes): the graph's streams
    equal the eager step's whole, with the same launch counts and forwards;
    drained and released, no page is in use."""
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request
    from repro_torch.kernels.common import launch_counters

    cfg, params, ex = _graph_world(path, cuda_device)
    runs = {}
    for graph in (False, None):
        eng = BatchingEngine(params, Ctx(cfg, ex=ExecCfg(lut_grouped=True, **ex)), GRAPH_SLOTS,
                             GRAPH_MAX_LEN, page_size=PAGE, device=cuda_device, cuda_graph=graph)
        reqs = [Request(i, p, GRAPH_MAX_NEW) for i, p in enumerate(_paged_prompts(cfg.vocab_size))]
        for r in reqs:
            eng.submit(r)
        for c in launch_counters():
            c.update(dict.fromkeys(c, 0))
        eng.run()
        torch.cuda.synchronize()
        runs[graph] = [r.generated for r in reqs], _counts_now(), eng
    (eager, eager_counts, eager_eng), (got, counts, eng) = runs[False], runs[None]
    assert eng._graph is not None and eager_eng._graph is None
    assert got == eager
    assert counts == eager_counts and sum(counts.values()) > 0
    assert eng.readbacks == eager_eng.readbacks
    assert eng.prefill_tokens == eager_eng.prefill_tokens < sum(
        len(p) for p in _paged_prompts(cfg.vocab_size))
    for e in (eng, eager_eng):
        e.alloc.release_prefixes()
        assert e.alloc.pages_in_use == 0


@pytest.mark.cuda
def test_paged_replays_write_across_page_boundaries_on_card(cuda_device):
    """Two slots whose decode writes cross page boundaries at different
    steps, all but the first two steps as graph replays, stepped beside the
    eager paged engine: after every step the device table holds the host's
    rows for the live slots, and every layer's K and V gathered through it
    equal the eager engine's at every valid position, so each replayed
    write landed in the page the table maps at that step."""
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request
    from repro_torch.serve._cache import paged_view, view_index

    cfg, params, ex = _graph_world("weight", cuda_device)
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, **ex))
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (3, 6)]
    engines = [BatchingEngine(params, ctx, 2, GRAPH_MAX_LEN, page_size=PAGE,
                              device=cuda_device, cuda_graph=graph) for graph in (None, False)]
    reqs = [[Request(i, p, 12) for i, p in enumerate(prompts)] for _ in engines]
    for eng, rs in zip(engines, reqs):
        for r in rs:
            eng.submit(r)
    graph, eager = engines
    table, layers = graph.cache["page_table"], dict(graph.cache["layers"])
    crossings = steps = 0
    while True:
        mapped = int((graph.alloc.table >= 0).sum())
        more = graph.step()
        assert more == eager.step()
        torch.cuda.synchronize()
        steps += 1
        crossings += steps > 2 and int((graph.alloc.table >= 0).sum()) > mapped
        assert graph.cache["page_table"] is table
        assert all(graph.cache["layers"][n] is t for n, t in layers.items())
        np.testing.assert_array_equal(graph.alloc.table, eager.alloc.table)
        live = [s for s, r in enumerate(graph.slots) if r is not None]
        np.testing.assert_array_equal(table.cpu().numpy()[live], graph.alloc.table[live])
        valid = graph.cache["valid"]
        assert torch.equal(valid, eager.cache["valid"])
        for name, pool in layers.items():
            for layer in range(pool.shape[0]):
                got = paged_view(pool[layer], *view_index(table))
                want = paged_view(eager.cache["layers"][name][layer],
                                  *view_index(eager.cache["page_table"]))
                for s in live:
                    assert torch.equal(got[s][valid[s]], want[s][valid[s]]), (name, layer, s, steps)
        if not more:
            break
    assert graph._graph is not None and crossings >= 2
    assert [r.generated for r in reqs[0]] == [r.generated for r in reqs[1]]


@pytest.mark.cuda
def test_paged_decode_forward_reads_nothing_back_on_card(cuda_device):
    """Routing, the paged write and view, and a copy-on-write copy, under
    ``set_sync_debug_mode("error")``: no read-back."""
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import make_cache
    from repro_torch.serve._cache import copy_pages

    cfg, params, ex = _graph_world("weight", cuda_device)
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, **ex))
    cache = make_cache(cfg, 3, GRAPH_MAX_LEN, ctx, page_size=PAGE, device=cuda_device)
    cache["overflow"] = torch.zeros(3, dtype=torch.bool, device=cuda_device)
    tok = torch.tensor([[5], [6], [7]], dtype=torch.int32, device=cuda_device)
    live = torch.tensor([[True], [False], [True]], device=cuda_device)
    src = torch.tensor([0, -1, -1], dtype=torch.int32, device=cuda_device)
    dst = torch.tensor([9, -1, -1], dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        model_forward(params, {"tokens": tok, "token_mask": live}, ctx, cache=cache)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for leaf in cache["layers"].values():
                copy_pages(leaf, src, dst)
            out, _, _ = model_forward(params, {"tokens": tok, "token_mask": live}, ctx,
                                      cache=cache)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out).all()
    assert cache["index"].tolist() == [2, 0, 2]
    assert not cache["overflow"].any()


# ---------------------------------------------------------------------------
# minicpm3_4b's MLA attention and latent cache on the card (the graph
# against the eager engine is GRAPH_PATHS' "mla" case above)
# ---------------------------------------------------------------------------


def _mla_serve(world, device, monkeypatch=None, use_kernels=True, **kw):
    """Serve ``_paged_prompts`` on the reduced MLA tree; with
    ``monkeypatch``, the attention's latents are rounded to bf16 first, as
    a paged prefill reads them from its bf16 cache."""
    from repro_torch.models import layers
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request

    if monkeypatch is not None:
        sdpa = layers._latent_sdpa

        def rounded(q_nope, q_rope, c_kv, k_rope, *rest):
            return sdpa(q_nope, q_rope, c_kv.to(torch.bfloat16), k_rope.to(torch.bfloat16),
                        *rest)

        monkeypatch.setattr(layers, "_latent_sdpa", rounded)
    cfg, params, ex = world
    eng = BatchingEngine(params, Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels,
                                                     **ex)),
                         GRAPH_SLOTS, GRAPH_MAX_LEN, device=device, **kw)
    reqs = [Request(i, p, GRAPH_MAX_NEW) for i, p in enumerate(_paged_prompts(cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    return [r.generated for r in reqs], eng


@pytest.mark.cuda
def test_mla_paged_engine_is_the_dense_engine_on_bf16_latents_on_card(cuda_device, monkeypatch):
    """The paged MLA engine (graph replays, shared prefixes, a copy-on-write
    hit) serves the streams, whole, of the dense graph engine whose
    attention takes its latents rounded to bf16."""
    world = _graph_world("mla", cuda_device)
    paged, eng = _mla_serve(world, cuda_device, page_size=PAGE)
    dense, dense_eng = _mla_serve(world, cuda_device, monkeypatch)
    assert eng._graph is not None and dense_eng._graph is not None
    assert paged == dense
    assert eng.prefill_tokens < dense_eng.prefill_tokens


@pytest.mark.cuda
def test_mla_kernel_path_first_tokens_match_plain_on_card(cuda_device):
    """The reduced MLA engine on the kernels and on the plain versions,
    both under the default graph: every request's first token equal."""
    world = _graph_world("mla", cuda_device)
    got, _ = _mla_serve(world, cuda_device)
    want, eng = _mla_serve(world, cuda_device, use_kernels=False)
    assert eng._graph is not None
    assert [s[0] for s in got] == [s[0] for s in want]


# ---------------------------------------------------------------------------
# mixtral_8x7b's sliding-window ring: the kernels at the row counts of the
# card's run at the published window (one slot's 4,072-token prefill, the
# 4,112-token full forward, two 4,096-token slots admitted in one prefill),
# at narrow widths so that the plain versions stay cheap; the ring engine's
# graph against its eager step, dense and paged
# ---------------------------------------------------------------------------

RING_ROWS = (4072, 4112, 8192)
RING_PROMPT_LENS = (3, 9, 12, 5, 14)
RING_MAX_NEW = 12  # with GRAPH_MAX_LEN 32 the ring holds 16: every request wraps


@pytest.mark.cuda
@pytest.mark.parametrize("B", RING_ROWS)
@pytest.mark.parametrize("G", [1, 2], ids=["lone", "grouped"])
def test_dense_at_the_ring_row_counts_on_card(cuda_device, G, B):
    """``lut_affine`` (``wq``, ``wo``, ``lm_head``) and
    ``lut_affine_grouped`` (``wk+wv``) on the prefill kernel at the ring
    run's rows: one launch, within 1e-5 x max|plain|."""
    codes, tables = _family_case(cuda_device, B + G, B, G, 64, 256)
    assert _regime(B, 3, 64, 32, tables).regime == "prefill"
    entry = "lut_affine" if G == 1 else "lut_affine_grouped"
    launches = ops.LAUNCHES[entry]
    got = _family_call(codes, tables)
    torch.cuda.synchronize()
    assert ops.LAUNCHES[entry] == launches + 1
    _close(got, _family_call(codes, tables, use_kernels=False))


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", RING_ROWS)
@pytest.mark.parametrize("G,k,p", [(2, 64, 256), (1, 256, 64)], ids=["gate_up", "down"])
def test_experts_at_the_ring_row_counts_on_card(cuda_device, G, k, p, tokens):
    """``lut_affine_experts`` on mixtral's 8 experts, top-2 routed: twice
    the ring run's tokens in expert-sorted rows (16,384 at the two-slot
    admission), one launch, within 1e-5 x max|plain|."""
    rng = np.random.default_rng(tokens + G)
    routed = np.concatenate([rng.choice(8, 2, replace=False) for _ in range(tokens)])
    sizes = tuple(int(v) for v in np.bincount(routed, minlength=8))
    c, t, scales, gs = _full_width_case(cuda_device, tokens + G, G, 2 * tokens, k, p, sizes)
    assert _experts_splits(G, 2 * tokens, k, t) == 1
    launches = ops.LAUNCHES["lut_affine_experts"]
    got = ops.lut_affine_experts(c, t, scales, gs, shift_bits=5)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lut_affine_experts"] == launches + 1
    _close(got, ops.lut_affine_experts(c, t, scales, gs, shift_bits=5, use_kernels=False))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,q", [(4072, 4096), (8192, 4096), (16384, 1024)])
@pytest.mark.parametrize("dtype", list(PACK_DTYPES))
def test_pack_at_the_ring_row_counts_on_card(cuda_device, dtype, rows, q):
    """The serving packs (``shift``, radix 4, signed) at the ring run's rows:
    d_model-wide inputs of a slot and of the two-slot admission, and the
    16,384 expert-sorted rows of ``w_down``'s input (narrowed); bit for bit."""
    _pack_once(_pack_input(cuda_device, (rows,), q, 0, dtype, rows), PACK_KINDS["shift-r4-signed"])


@pytest.mark.cuda
def test_ring_graph_engine_matches_the_eager_engine_on_card(cuda_device):
    """Reduced mixtral_8x7b (window 16, 4 experts top-2) on planned i8
    tables, every request past the ring: dense and paged (page_size 4, all
    pages mapped at admission, no sharing), each as graph replays and
    eager: four runs with equal streams, whole; graph and eager with the
    same launch counts and forwards; no page in use once drained."""
    from repro_torch.models.layers import SampleCfg

    world = _graph_world("swa", cuda_device)
    assert world[0].sliding_window == 16
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, world[0].vocab_size, n).astype(np.int32)
               for n in RING_PROMPT_LENS]
    runs = {}
    for paged in (False, True):
        for graph in (False, None):
            runs[paged, graph] = _graph_serve(world, graph, SampleCfg(), cuda_device, prompts,
                                              RING_MAX_NEW,
                                              **({"page_size": PAGE} if paged else {}))
    streams = runs[False, False][0]
    assert all(r[0] == streams for r in runs.values())
    for paged in (False, True):
        (_, eager_counts, eager_eng), (_, counts, eng) = runs[paged, False], runs[paged, None]
        assert eng._graph is not None and eager_eng._graph is None
        assert counts == eager_counts and counts["lut_affine_experts"] > 0
        assert eng.readbacks == eager_eng.readbacks
    paged_eng = runs[True, None][2]
    assert not paged_eng.alloc.share and paged_eng.alloc.pages_in_use == 0
    assert paged_eng.prefill_tokens == sum(RING_PROMPT_LENS)


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [None, PAGE], ids=["dense", "paged"])
def test_ring_decode_forward_reads_nothing_back_on_card(cuda_device, page_size):
    """A decode-shaped forward of the reduced mixtral tree into a ring whose
    slots are past their wrap, under ``set_sync_debug_mode("error")``: the
    ring's slots, the window mask, routing and the experts kernel read
    nothing back; pos holds each row's new position at its slot."""
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward
    from repro_torch.serve import make_cache

    cfg, params, ex = _graph_world("swa", cuda_device)
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, **ex))
    cache = make_cache(cfg, 3, GRAPH_MAX_LEN, ctx, page_size=page_size, device=cuda_device)
    cache["overflow"] = torch.zeros(3, dtype=torch.bool, device=cuda_device)
    cache["index"].copy_(torch.tensor([17, 40, 3], dtype=torch.int32))
    tok = torch.tensor([[5], [6], [7]], dtype=torch.int32, device=cuda_device)
    live = torch.tensor([[True], [True], [False]], device=cuda_device)
    with torch.no_grad():
        model_forward(params, {"tokens": tok, "token_mask": live}, ctx, cache=cache)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _, _ = model_forward(params, {"tokens": tok, "token_mask": live}, ctx,
                                      cache=cache)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out).all()
    assert cache["index"].tolist() == [19, 42, 3]
    pos = cache["pos"].cpu()
    assert pos[0, 18 % 16] == 18 and pos[1, 41 % 16] == 41 and not cache["valid"][2].any()
    assert not cache["overflow"].any()


# ---------------------------------------------------------------------------
# llava_next_mistral_7b's image prefix through generate() (the engine serving
# it text-only is GRAPH_PATHS' "vlm" case above)
# ---------------------------------------------------------------------------

VLM_PROMPT_LEN, VLM_MAX_NEW, VLM_MAX_LEN = 6, 8, 24  # 8 image tokens + 6 + 8 - 1 <= 24


def _vlm_generate(world, device, use_kernels, page_size, codes=None):
    """Greedy ``generate(embeds=...)`` of the reduced llava tree on 3 rows of
    8 seeded image embeddings and a 6-token prompt; returns (streams, the
    launches of the run, each pack site's (input, codes) in call order).
    Given ``codes`` (an earlier run's sites), each pack site takes the
    recorded codes of the same site instead of its own."""
    from repro_torch.models import layers
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import generate

    cfg, params, ex = world
    rng = np.random.default_rng(43)
    prompts = rng.integers(0, cfg.vocab_size, (3, VLM_PROMPT_LEN)).astype(np.int32)
    embeds = (rng.standard_normal((3, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(
        np.float32)
    pack0, sites = layers.pack, []
    replay = None if codes is None else iter(codes)

    def pack(x, plan, use_kernels=True):
        own = pack0(x, plan, use_kernels=use_kernels) if replay is None else next(replay)[1]
        sites.append((x.clone(), own))
        return own

    before = _counts_now()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "pack", pack)
        ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels, **ex))
        out = generate(params, ctx, prompts, VLM_MAX_NEW, max_len=VLM_MAX_LEN,
                       page_size=page_size, device=device,
                       embeds=torch.from_numpy(embeds).to(device))
    torch.cuda.synchronize()
    after = _counts_now()
    if replay is not None:
        assert next(replay, None) is None, "a recorded pack site was not replayed"
    return out.tolist(), {k: after[k] - before[k] for k in after}, sites


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [None, PAGE], ids=["dense", "paged"])
def test_vlm_generate_on_kernels_matches_plain_on_card(cuda_device, page_size):
    """Reduced llava_next_mistral_7b on planned i8 tables, ``generate`` with
    8 image embeddings before each prompt, dense and paged (6 identity
    pages of 4 a row): on the kernels (each LUT call and pack a launch), and
    on the plain versions given the kernel run's codes at every pack site,
    in order (an input at an fp16 rounding boundary could otherwise take
    the neighbouring code in one of them): the same streams, whole, and
    every site's plain input within 1e-5 x max of the kernel's."""
    world = _graph_world("vlm", cuda_device)
    assert world[0].num_image_tokens == 8
    got, launches, sites = _vlm_generate(world, cuda_device, True, page_size)
    assert launches["lut_affine"] > 0 and launches["lut_affine_grouped"] > 0
    assert launches["bitplane_pack"] == len(sites)
    want, plain_launches, seen = _vlm_generate(world, cuda_device, False, page_size, sites)
    assert not any(plain_launches.values())
    assert got == want
    for (x, _), (x_ref, _) in zip(seen, sites):
        assert ((x - x_ref).abs().max() <= 1e-5 * x_ref.abs().max()).item()


# ---------------------------------------------------------------------------
# rwkv6_3b through generate() on its recurrent state (BatchingEngine refuses
# the family, as the reference's does)
# ---------------------------------------------------------------------------

RWKV_PROMPT_LEN, RWKV_MAX_NEW = 9, 6  # an odd prompt: the WKV scan at chunk 1


def _rwkv_world(device):
    """Reduced rwkv6_3b on planned i8 tables (the serving recipe: eight lone
    projections a layer and the head), its zeroed ``mu_*``, ``u`` and
    ``decay_base`` drawn from a seed (U(0, 1), N(0, 0.5), U(-6, 1)) so that
    the token-shift carry and the bonus count."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params

    cfg = get_config("rwkv6_3b", reduced=True)
    gen = torch.Generator(device=device).manual_seed(3)
    params = init_params(model_specs(cfg), gen, device=device)
    time_mix = params["blocks"]["time"]
    for part in (time_mix, params["blocks"]["channel"]):
        for name, leaf in part.items():
            if name.startswith("mu_"):
                leaf.copy_(torch.rand(leaf.shape, generator=gen, device=device))
    time_mix["u"].copy_(0.5 * torch.randn(time_mix["u"].shape, generator=gen, device=device))
    base = time_mix["decay_base"]
    base.copy_(7.0 * torch.rand(base.shape, generator=gen, device=device) - 6.0)
    uniform = plan_model(params, float("inf"), max_chunk=2)
    plan = plan_model(params, uniform.total_lut_bytes // 2, max_chunk=2,
                      modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                      table_formats=(None, "i8"))
    assert not plan.groups
    return cfg, convert_params(params, plan=plan)[0]


def _rwkv_generate(world, device, use_kernels, codes=None):
    """Greedy ``generate`` of the reduced rwkv tree on 3 seeded prompts of
    RWKV_PROMPT_LEN tokens; returns (streams, the launches of the run, each
    pack site's (input, codes, plan) and each LUT call's (arguments, output)
    in call order).  Given ``codes`` (an earlier run's sites), each pack
    site takes the recorded codes of the same site instead of its own."""
    from repro_torch.models import layers
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import generate

    cfg, params = world
    rng = np.random.default_rng(47)
    prompts = rng.integers(0, cfg.vocab_size, (3, RWKV_PROMPT_LEN)).astype(np.int32)
    pack0, lut0, sites, calls = layers.pack, layers.lut_affine, [], []
    replay = None if codes is None else iter(codes)

    def pack(x, plan, use_kernels=True):
        own = pack0(x, plan, use_kernels=use_kernels) if replay is None else next(replay)[1]
        sites.append((x.clone(), own, plan))
        return own

    def lut_affine(*args, **kw):
        out = lut0(*args, **kw)
        calls.append((args, kw, out.clone()))
        return out

    before = _counts_now()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "pack", pack)
        mp.setattr(layers, "lut_affine", lut_affine)
        ctx = Ctx(cfg, ex=ExecCfg(use_kernels=use_kernels))
        out = generate(params, ctx, prompts, RWKV_MAX_NEW, device=device)
    torch.cuda.synchronize()
    after = _counts_now()
    if replay is not None:
        assert next(replay, None) is None, "a recorded pack site was not replayed"
    return out.tolist(), {k: after[k] - before[k] for k in after}, sites, calls


@pytest.mark.cuda
def test_rwkv_generate_on_kernels_matches_plain_on_card(cuda_device):
    """Reduced rwkv6_3b on planned i8 tables, greedy ``generate`` on its
    recurrent state: on the kernels, 8L + 1 ``lut_affine`` launches and as
    many packs a forward, no grouped launch; on the plain versions given
    the kernel run's codes at every pack site, in order: the same streams,
    whole, and every site's plain input within 1e-5 x max of the kernel's."""
    world = _rwkv_world(cuda_device)
    per_forward = 8 * world[0].num_layers + 1
    got, launches, sites, _ = _rwkv_generate(world, cuda_device, True)
    assert launches["lut_affine"] == launches["bitplane_pack"] == per_forward * RWKV_MAX_NEW
    assert launches["lut_affine_grouped"] == 0 and len(sites) == launches["bitplane_pack"]
    want, plain_launches, seen, _ = _rwkv_generate(world, cuda_device, False, sites)
    assert not any(plain_launches.values())
    assert got == want
    for (x, *_), (x_ref, *_) in zip(seen, sites):
        assert ((x - x_ref).abs().max() <= 1e-5 * x_ref.abs().max()).item()


@pytest.mark.cuda
def test_rwkv_packs_and_lut_calls_match_plain_on_card(cuda_device):
    """Every pack and every LUT call of the reduced rwkv tree's ``generate``
    on the kernels (8L + 1 of each a forward: the prefill's at 3 x
    RWKV_PROMPT_LEN rows, the decode steps' at 3) against its plain version
    on the same input: packs bit for bit, LUT calls within 1e-5 x max."""
    world = _rwkv_world(cuda_device)
    _, _, sites, calls = _rwkv_generate(world, cuda_device, True)
    assert len(sites) == len(calls) == (8 * world[0].num_layers + 1) * RWKV_MAX_NEW
    for x, codes, plan in sites:
        assert torch.equal(pack_ops.pack(x, plan, use_kernels=False), codes)
    for args, kw, out in calls:
        _close(out, ops.lut_affine(*args, **{**kw, "use_kernels": False}))


# ---------------------------------------------------------------------------
# zamba2_1_2b (Mamba-2 SSD layers and a shared attention block) through
# generate(); and its shared block's G = 3 wq+wk+wv group of i8 shift tables
# ---------------------------------------------------------------------------

HYBRID_PROMPT_LEN, HYBRID_MAX_NEW = 9, 6  # an odd prompt: the SSD scan at chunk 1


def _hybrid_world(device):
    """Reduced zamba2_1_2b (5 mamba layers, the shared block every 2: 2
    invocations) on planned i8 tables (the serving recipe: ``in_proj`` /
    ``out_proj`` lone, the shared block's ``wq+wk+wv`` and ``w_gate+w_up``
    grouped), its zeroed ``A_log`` and ``dt_bias`` drawn from a seed as
    Mamba-2 initialises them (A ~ U[1, 16]; dt log-uniform in [1e-3,
    1e-1])."""
    import math

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params

    cfg = get_config("zamba2_1_2b", reduced=True)
    gen = torch.Generator(device=device).manual_seed(5)
    params = init_params(model_specs(cfg), gen, device=device)
    mix = params["mamba"]["mix"]
    shape = mix["A_log"].shape
    mix["A_log"].copy_(torch.log(1.0 + 15.0 * torch.rand(shape, generator=gen, device=device)))
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen, device=device))
    mix["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    uniform = plan_model(params, float("inf"), max_chunk=2)
    plan = plan_model(params, uniform.total_lut_bytes // 2, max_chunk=2,
                      modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                      table_formats=(None, "i8"))
    assert len(plan.groups) == 2
    return cfg, convert_params(params, plan=plan)[0]


def _hybrid_generate(world, device, use_kernels, codes=None):
    """Greedy ``generate`` of the reduced hybrid tree on 3 seeded prompts of
    HYBRID_PROMPT_LEN tokens, grouped launches, on an fp32 cache (no bf16
    K/V that each path would round on its own); returns (streams, the
    launches of the run, each pack site's (input, codes, plan) and each LUT
    call's (kind, arguments, output) in call order).  Given ``codes`` (an
    earlier run's sites), each pack site takes the recorded codes of the
    same site instead of its own."""
    import functools

    import repro_torch.serve._engine as engine
    from repro_torch.models import layers
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import generate

    cfg, params = world
    rng = np.random.default_rng(53)
    prompts = rng.integers(0, cfg.vocab_size, (3, HYBRID_PROMPT_LEN)).astype(np.int32)
    pack0, sites, calls = layers.pack, [], []
    replay = None if codes is None else iter(codes)

    def pack(x, plan, use_kernels=True):
        own = pack0(x, plan, use_kernels=use_kernels) if replay is None else next(replay)[1]
        sites.append((x.clone(), own, plan))
        return own

    def recorded(kind, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((kind, args, kw, out.clone()))
            return out

        return call

    before = _counts_now()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "pack", pack)
        for kind in ("lut_affine", "lut_affine_grouped"):
            mp.setattr(layers, kind, recorded(kind, getattr(layers, kind)))
        mp.setattr(engine, "make_cache", functools.partial(engine.make_cache,
                                                           dtype=torch.float32))
        ctx = Ctx(cfg, ex=ExecCfg(use_kernels=use_kernels, lut_grouped=True))
        out = generate(params, ctx, prompts, HYBRID_MAX_NEW, device=device)
    torch.cuda.synchronize()
    after = _counts_now()
    if replay is not None:
        assert next(replay, None) is None, "a recorded pack site was not replayed"
    return out.tolist(), {k: after[k] - before[k] for k in after}, sites, calls


def _hybrid_per_forward(cfg):
    shared = cfg.num_layers // cfg.shared_attn_every
    return {"lut_affine": 2 * cfg.num_layers + 2 * shared + 1,
            "lut_affine_grouped": 2 * shared,
            "bitplane_pack": 2 * cfg.num_layers + 4 * shared + 1}


@pytest.mark.cuda
def test_hybrid_generate_on_kernels_matches_plain_on_card(cuda_device):
    """Reduced zamba2_1_2b on planned i8 tables, greedy ``generate``: on the
    kernels, 2L + 2S + 1 ``lut_affine``, 2S ``lut_affine_grouped`` and 2L +
    4S + 1 packs a forward (S shared invocations); on the plain versions
    given the kernel run's codes at every pack site, in order: the same
    streams, whole, and every site's plain input within 1e-5 x max of the
    kernel's."""
    world = _hybrid_world(cuda_device)
    got, launches, sites, _ = _hybrid_generate(world, cuda_device, True)
    for kind, n in _hybrid_per_forward(world[0]).items():
        assert launches[kind] == n * HYBRID_MAX_NEW, (kind, launches)
    assert len(sites) == launches["bitplane_pack"]
    want, plain_launches, seen, _ = _hybrid_generate(world, cuda_device, False, sites)
    assert not any(plain_launches.values())
    assert got == want
    for (x, *_), (x_ref, *_) in zip(seen, sites):
        assert ((x - x_ref).abs().max() <= 1e-5 * x_ref.abs().max()).item()


@pytest.mark.cuda
def test_hybrid_packs_and_lut_calls_match_plain_on_card(cuda_device):
    """Every pack and every LUT call (lone and grouped) of the reduced
    hybrid tree's ``generate`` on the kernels against its plain version on
    the same input: packs bit for bit, LUT calls within 1e-5 x max."""
    world = _hybrid_world(cuda_device)
    _, _, sites, calls = _hybrid_generate(world, cuda_device, True)
    per_forward = _hybrid_per_forward(world[0])
    assert len(sites) == per_forward["bitplane_pack"] * HYBRID_MAX_NEW
    assert len(calls) == (per_forward["lut_affine"]
                          + per_forward["lut_affine_grouped"]) * HYBRID_MAX_NEW
    for x, codes, plan in sites:
        assert torch.equal(pack_ops.pack(x, plan, use_kernels=False), codes)
    for kind, args, kw, out in calls:
        _close(out, getattr(ops, kind)(*args, **{**kw, "use_kernels": False}))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 2048], ids=["decode", "prefill"])
def test_g3_i8_shift_group_matches_plain_on_card(cuda_device, rows):
    """zamba2_1_2b's shared ``wq+wk+wv``: a G = 3 group of i8 shift tables
    (2048 -> 2048 each, radix-4 planes, 32 entries) at a decode row count
    (the decode kernel) and at a 2,048-row prefill (the prefill kernel),
    against its plain version within 1e-5 x max."""
    codes, tables, scales = _case(71, rows, 3, 2048, 32, 2048, 3, "i8", 5)
    codes = torch.from_numpy(codes).to(cuda_device)
    tables = tables.to(cuda_device)
    got = ops.lut_affine_grouped(codes, tables, scales, shift_bits=5)
    want = ops.lut_affine_grouped(codes, tables, scales, shift_bits=5, use_kernels=False)
    assert got.shape == (3, rows, 2048)
    _close(got, want)


# ---------------------------------------------------------------------------
# whisper_base's encoder-decoder through generate(enc_embeds=...); its
# biased G = 3 wq+wk+wv group at the encoder's 1,500-frame row counts, and
# the cross-attention's members run alone on that group's leaf
# ---------------------------------------------------------------------------

ENCDEC_PROMPT_LEN, ENCDEC_MAX_NEW, ENCDEC_FRAMES, ENCDEC_MAX_LEN = 4, 6, 20, 12


def _encdec_world(device):
    """Reduced whisper_base (2 encoder and 2 decoder layers) on planned i8
    tables (the serving recipe: three G = 3 ``wq+wk+wv`` groups, each with
    stacked biases; ``wo``, ``w_in``, ``w_out`` lone), its zeroed biases and
    LayerNorm biases and its unit LayerNorm scales drawn from a seed so
    that they count."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params

    cfg = get_config("whisper_base", reduced=True)
    gen = torch.Generator(device=device).manual_seed(7)
    params = init_params(model_specs(cfg), gen, device=device)

    def seed(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                seed(leaf)
            elif key in ("b", "bias"):
                leaf.copy_(0.1 * torch.randn(leaf.shape, generator=gen, device=device))
            elif key == "scale":
                leaf.copy_(1 + 0.2 * torch.randn(leaf.shape, generator=gen, device=device))

    seed(params)
    uniform = plan_model(params, float("inf"), max_chunk=2)
    plan = plan_model(params, uniform.total_lut_bytes // 2, max_chunk=2,
                      modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                      table_formats=(None, "i8"))
    assert len(plan.groups) == 3
    return cfg, convert_params(params, plan=plan)[0]


def _encdec_generate(world, device, use_kernels, page_size, codes=None):
    """Greedy ``generate(enc_embeds=...)`` of the reduced whisper tree on 3
    rows of ENCDEC_FRAMES seeded frames (std 0.1) and ENCDEC_PROMPT_LEN-token
    prompts into a ENCDEC_MAX_LEN-slot fp32 cache (no bf16 K/V that each
    path would round on its own), grouped launches; returns (streams, the
    launches of the run, each pack site's (input, codes, plan) and each LUT
    call's (kind, arguments, output) in call order).  Given ``codes`` (an
    earlier run's sites), each pack site takes the recorded codes of the
    same site instead of its own."""
    import functools

    import repro_torch.serve._engine as engine
    from repro_torch.models import layers
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import generate

    cfg, params = world
    rng = np.random.default_rng(59)
    prompts = rng.integers(0, cfg.vocab_size, (3, ENCDEC_PROMPT_LEN)).astype(np.int32)
    frames = (rng.standard_normal((3, ENCDEC_FRAMES, cfg.d_model)) * 0.1).astype(np.float32)
    pack0, sites, calls = layers.pack, [], []
    replay = None if codes is None else iter(codes)

    def pack(x, plan, use_kernels=True):
        own = pack0(x, plan, use_kernels=use_kernels) if replay is None else next(replay)[1]
        sites.append((x.clone(), own, plan))
        return own

    def recorded(kind, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((kind, args, kw, out.clone()))
            return out

        return call

    before = _counts_now()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "pack", pack)
        for kind in ("lut_affine", "lut_affine_grouped"):
            mp.setattr(layers, kind, recorded(kind, getattr(layers, kind)))
        mp.setattr(engine, "make_cache", functools.partial(engine.make_cache,
                                                           dtype=torch.float32))
        ctx = Ctx(cfg, ex=ExecCfg(use_kernels=use_kernels, lut_grouped=True))
        out = generate(params, ctx, prompts, ENCDEC_MAX_NEW, max_len=ENCDEC_MAX_LEN,
                       page_size=page_size, device=device,
                       enc_embeds=torch.from_numpy(frames).to(device))
    torch.cuda.synchronize()
    after = _counts_now()
    if replay is not None:
        assert next(replay, None) is None, "a recorded pack site was not replayed"
    return out.tolist(), {k: after[k] - before[k] for k in after}, sites, calls


def _encdec_launches(cfg):
    """A generate's launches: the prefill (3Le + 7L / Le + L / 4Le + 7L: the
    encoder, each layer's cross ``wk``/``wv``, the decoder) and 5L / L / 6L
    for each decode step; the tied head is no LUT."""
    Le, L = cfg.encoder_layers, cfg.num_layers
    steps = ENCDEC_MAX_NEW - 1
    return {"lut_affine": 3 * Le + 7 * L + 5 * L * steps,
            "lut_affine_grouped": Le + L + L * steps,
            "bitplane_pack": 4 * Le + 7 * L + 6 * L * steps}


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [None, PAGE], ids=["dense", "paged"])
def test_encdec_generate_on_kernels_matches_plain_on_card(cuda_device, page_size):
    """Reduced whisper_base on planned i8 tables, greedy
    ``generate(enc_embeds=...)``, dense and paged (3 identity pages of 4 a
    row; the cross K/V dense at 20 frames): on the kernels, the launches the
    tree plans; on the plain versions given the kernel run's codes at every
    pack site, in order: the same streams, whole, and every site's plain
    input within 1e-5 x max of the kernel's."""
    world = _encdec_world(cuda_device)
    got, launches, sites, _ = _encdec_generate(world, cuda_device, True, page_size)
    for kind, n in _encdec_launches(world[0]).items():
        assert launches[kind] == n, (kind, launches)
    assert len(sites) == launches["bitplane_pack"]
    want, plain_launches, seen, _ = _encdec_generate(world, cuda_device, False, page_size,
                                                     sites)
    assert not any(plain_launches.values())
    assert got == want
    for (x, *_), (x_ref, *_) in zip(seen, sites):
        assert ((x - x_ref).abs().max() <= 1e-5 * x_ref.abs().max()).item()


@pytest.mark.cuda
def test_encdec_packs_and_lut_calls_match_plain_on_card(cuda_device):
    """Every pack and every LUT call of the reduced whisper tree's
    ``generate`` on the kernels (the cross-attention's ``wq`` alone and its
    ``wk``/``wv`` as lone calls on the group's leaf among them) against its
    plain version on the same input: packs bit for bit, LUT calls within
    1e-5 x max; no table is copied."""
    world = _encdec_world(cuda_device)
    copies = ops.TABLE_COPIES["table_operand"]
    _, _, sites, calls = _encdec_generate(world, cuda_device, True, None)
    assert ops.TABLE_COPIES["table_operand"] == copies
    per_run = _encdec_launches(world[0])
    assert len(sites) == per_run["bitplane_pack"]
    assert len(calls) == per_run["lut_affine"] + per_run["lut_affine_grouped"]
    for x, codes, plan in sites:
        assert torch.equal(pack_ops.pack(x, plan, use_kernels=False), codes)
    for kind, args, kw, out in calls:
        _close(out, getattr(ops, kind)(*args, **{**kw, "use_kernels": False}))


@pytest.mark.cuda
def test_biased_g3_group_at_encoder_rows_matches_plain_on_card(cuda_device):
    """whisper_base's ``wq+wk+wv``: a G = 3 group of i8 shift tables (512 ->
    512 each, radix-4 planes, 32 entries) with stacked biases, at the
    encoder's 4 x 1,500 = 6,000 rows (the prefill kernel), against its plain
    version within 1e-5 x max."""
    codes, tables, scales = _case(73, 6000, 3, 512, 32, 512, 3, "i8", 5)
    codes = torch.from_numpy(codes).to(cuda_device)
    tables = tables.to(cuda_device)
    biases = torch.randn(3, 512, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    got = ops.lut_affine_grouped(codes, tables, scales, biases=biases, shift_bits=5)
    want = ops.lut_affine_grouped(codes, tables, scales, biases=biases, shift_bits=5,
                                  use_kernels=False)
    assert got.shape == (3, 6000, 512)
    _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,members", [(4, (0,)), (6000, (1, 2))], ids=["wq", "wk_wv"])
def test_cross_group_lone_members_match_plain_on_card(cuda_device, rows, members):
    """The cross-attention's members alone on the G = 3 leaf: ``wq`` at a
    decode row count and ``wk``/``wv`` at the encoder's 6,000 rows, each a
    ``lut_affine`` launch on its ``tables[g]`` view with its bias, against
    the grouped plain version's row of the same member within 1e-5 x max;
    the views are read in place (no table copy)."""
    codes, tables, scales = _case(79, rows, 3, 512, 32, 512, 3, "i8", 5)
    codes = torch.from_numpy(codes).to(cuda_device)
    tables = tables.to(cuda_device)
    biases = torch.randn(3, 512, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    want = ops.lut_affine_grouped(codes, tables, scales, biases=biases, shift_bits=5,
                                  use_kernels=False)
    copies, before = ops.TABLE_COPIES["table_operand"], ops.LAUNCHES["lut_affine"]
    for g in members:
        got = ops.lut_affine(codes, tables[g], scales, bias=biases[g], shift_bits=5)
        _close(got, want[g])
    assert ops.LAUNCHES["lut_affine"] == before + len(members)
    assert ops.TABLE_COPIES["table_operand"] == copies


def _audit_launch(kernel: str, dev):
    """One launch of ``kernel`` on small seeded operands: (the call, the
    operand shapes the launch reads, the shape it writes)."""
    rng = np.random.default_rng(33)
    B, n, k, E, p, G = 4, 3, 64, 32, 128, 2
    codes = torch.from_numpy(rng.integers(0, E, (B, n, k)).astype(np.int32)).to(dev)
    scales = np.float32([1.0, 0.5, -0.25])

    def tables(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    if kernel == "lut_affine":
        t = tables(k, E, p)
        return (lambda: ops.lut_affine(codes, t, scales)), [(B, n, k), (1, k, E, p)], (1, B, p)
    if kernel == "lut_affine_grouped":
        t = tables(G, k, E, p)
        return (lambda: ops.lut_affine_grouped(codes, t, scales)), [(B, n, k), (G, k, E, p)], (
            G, B, p)
    if kernel == "lut_affine_experts":
        experts, T = 4, 8
        t = tables(experts, G, k, E, p)
        rows = torch.from_numpy(rng.integers(0, E, (T, n, k)).astype(np.int32)).to(dev)
        sizes = torch.tensor([3, 0, 4, 1], dtype=torch.int32, device=dev)
        return (lambda: ops.lut_affine_experts(rows, t, scales, sizes)), [
            (T, n, k), (experts, G, k, E, p), (experts + 1,)], (G, T, p)
    kb = 16
    acts = torch.from_numpy(rng.integers(-127, 128, (B, 4 * kb)).astype(np.int32)).to(dev)
    packed = torch.from_numpy(rng.integers(0, 256, (G, kb, p)).astype(np.uint8)).to(dev)
    if kernel == "lut_tl1":
        return (lambda: tl1_ops.lut_tl1(acts, packed[0])), [(B, 4 * kb), (1, kb, p)], (1, B, p)
    if kernel == "lut_tl1_grouped":
        return (lambda: tl1_ops.lut_tl1_grouped(acts, packed)), [(B, 4 * kb), (G, kb, p)], (
            G, B, p)
    x = torch.from_numpy(rng.standard_normal((B, k)).astype(np.float32)).to(dev)
    return (lambda: pack_ops.bitplane_pack(x, kind="shift", m=1, signed=True, radix=4)), [
        (B, k)], (B, n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lut_affine", "lut_affine_grouped", "lut_affine_experts",
                                    "lut_tl1", "lut_tl1_grouped", "bitplane_pack"])
def test_each_audited_kernel_is_one_opaque_leaf_on_card(cuda_device, kernel):
    """The audit's recorder sees a launch as one opaque leaf named after the
    kernel, with the shapes of the operands the launch read and wrote."""
    from repro_torch.audit.walker import kernel_leaves, record

    call, in_shapes, out_shape = _audit_launch(kernel, cuda_device)
    call()  # built and bound outside the recording
    _, recorded = record(call)
    leaves = [op for op in recorded if op.opaque]
    assert kernel_leaves(recorded) == {kernel: 1}
    assert [m.shape for m in leaves[0].inputs] == in_shapes
    assert [m.shape for m in leaves[0].outputs] == [out_shape]


# ---------------------------------------------------------------------------
# tuned tiles (kernels/lut_affine/autotune.py)
# ---------------------------------------------------------------------------

TUNED = ["lut_affine", "lut_affine_grouped", "lut_affine_experts", "lut_tl1", "lut_tl1_grouped"]
TUNE_K, TUNE_P, TUNE_TOP = 300, 1000, 4  # chunks (TL1: packed rows), columns, experts a token


class _Splits:
    """Records the ``splits`` argument (the last before the stream) of each
    launch of one C entry, and launches it."""

    def __init__(self, module, entry):
        self.lib, self.entry, self.seen = module._lib(), entry, []
        self.real = getattr(self.lib, entry)

    def __enter__(self):
        def spy(*args):
            self.seen.append(args[-2])
            return self.real(*args)

        setattr(self.lib, self.entry, spy)
        return self.seen

    def __exit__(self, *exc):
        setattr(self.lib, self.entry, self.real)


def _tuned_case(name, rows, dev):
    """(the point a plan would tune for ``name`` at ``rows`` tokens, the
    module and C entry it launches, call(blocks, use_kernels), exact)."""
    G = 1 if name in ("lut_affine", "lut_tl1") else 2
    if name.startswith("lut_tl1"):
        acts, _, tables, _, _ = _tl1_case(31, (rows,), TUNE_K, TUNE_P + 500, G, 8)
        acts, tables = acts.to(dev), tables.to(dev)
        pt = autotune.TunePoint(B=rows, k=TUNE_K, entries=9, p=TUNE_P + 500, n=1, G=G,
                                table_bytes=1, family="tl1")

        def call(blocks, use_kernels=True):
            if G == 1:
                return tl1_ops.lut_tl1(acts, tables[0], blocks=blocks, use_kernels=use_kernels)
            return tl1_ops.lut_tl1_grouped(acts, tables, blocks=blocks, use_kernels=use_kernels)

        return pt, tl1_ops, f"{name}_launch", call, True
    pt = autotune.TunePoint(B=rows, k=TUNE_K, entries=32, p=TUNE_P, n=3, G=G, table_bytes=1)
    if name == "lut_affine_experts":  # rows x top-k expert-sorted rows on 6 experts
        T = rows * TUNE_TOP
        codes, tables, scales = _case(29, T, 3, TUNE_K, 32, TUNE_P, 6 * G, "i8", 5)
        c, t = torch.from_numpy(codes).to(dev), tables.reshape(6, G, TUNE_K, 32, TUNE_P).to(dev)
        sizes = [T // 6] * 5 + [T - 5 * (T // 6)]
        gs = torch.tensor(sizes, dtype=torch.int64, device=dev)

        def call(blocks, use_kernels=True):
            return ops.lut_affine_experts(c, t, scales, gs, shift_bits=5, blocks=blocks,
                                          use_kernels=use_kernels)

        return pt, ops, "lut_affine_experts_launch", call, False
    codes, tables, scales = _case(23, rows, 3, TUNE_K, 32, TUNE_P, G, "i8", 5)
    c, t = torch.from_numpy(codes).to(dev), tables.to(dev)

    def call(blocks, use_kernels=True):
        if G == 1:
            return ops.lut_affine(c, t[0], scales, shift_bits=5, blocks=blocks,
                                  use_kernels=use_kernels)
        return ops.lut_affine_grouped(c, t, scales, shift_bits=5, blocks=blocks,
                                      use_kernels=use_kernels)

    return pt, ops, f"{name}_launch", call, False


@pytest.mark.cuda
@pytest.mark.parametrize("tiling", ["analytic", "one_chunk", "whole_k"])
@pytest.mark.parametrize("name", TUNED)
def test_tuned_tilings_match_plain_on_card(cuda_device, name, tiling):
    """The analytic winner at the decode batch and the extreme legal
    tilings (``block_k = 1``: k ranges of one chunk; ``block_k = k``: no
    split) against the plain version; the dense launches cut k as they say,
    the ragged one keeps its shape rule."""
    pt, module, entry, call, exact = _tuned_case(name, 4, cuda_device)
    win = autotune.search_blocks(pt)
    blocks = {"analytic": win, "one_chunk": win[:2] + (1,), "whole_k": win[:2] + (pt.k,)}[tiling]
    assert autotune.blocks_fit_smem(pt, blocks)
    with _Splits(module, entry) as seen:
        got = call(blocks)
        rule = call(None)
    torch.cuda.synchronize()
    if name == "lut_affine_experts":
        assert seen[0] == seen[1] and torch.equal(got, rule)
    else:
        assert seen[0] == -(-pt.k // blocks[2])
    want = call(None, use_kernels=False)
    if exact:  # TL1's integer accumulate
        assert torch.equal(got, want)
    else:
        _close(got, want)
    # another cut of k moves the fp32 sums by their rounding only; TL1's not at all
    untuned = call(None)
    if exact:
        assert torch.equal(got, untuned)
    else:
        _close(got, untuned)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 128, 2432])
@pytest.mark.parametrize("name", TUNED)
def test_decode_tiles_keep_the_shape_rule_at_prefill_on_card(cuda_device, name, rows):
    """A plan tuned at the decode batch, dispatched at more rows than one
    tile (8: the dense decode kernel's second tile, TL1's 8-row kernel; a
    prefill of 128 and a VLM prefill of 2,432): the launch keeps the shape
    rule's splits (so its partials), and its output is the untuned
    launch's bit for bit."""
    pt, *_ = _tuned_case(name, 4, cuda_device)
    blocks = autotune.search_blocks(pt)
    _, module, entry, call, _ = _tuned_case(name, rows, cuda_device)
    with _Splits(module, entry) as seen:
        got, rule = call(blocks), call(None)
    torch.cuda.synchronize()
    assert len(seen) == 2 and seen[0] == seen[1]
    assert torch.equal(got, rule)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TUNED)
def test_kernel_path_refuses_tpu_tiles_on_card(cuda_device, name):
    *_, call, _ = _tuned_case(name, 4, cuda_device)
    counts = ops.LAUNCHES if name.startswith("lut_affine") else tl1_ops.LAUNCHES
    before = dict(counts)
    with pytest.raises(ValueError, match=r"blocks \(8, 128, 64\) are not a legal Hopper"):
        call((8, 128, 64))
    assert counts == before


@pytest.mark.cuda
def test_smem_mirrors_match_the_source_on_card(cuda_device):
    lib = ops._lib()
    for n in (1, 2, 3, 8, 11, 32):
        for E in (2, 16, 32, 64):
            assert autotune.decode_smem(n) == lib.lut_affine_smem_bytes(0, n, E)
            assert autotune.prefill_smem(n, E) == lib.lut_affine_smem_bytes(1, n, E)
    assert autotune.TL1_SMEM_BYTES == tl1_ops._lib().lut_tl1_smem_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["weight", "tl1"])
def test_measured_search_times_every_candidate_on_card(cuda_device, family):
    if family == "tl1":
        pt = autotune.TunePoint(B=4, k=TUNE_K, entries=9, p=TUNE_P + 500, n=1, G=2,
                                table_bytes=1, family="tl1")
    else:
        pt = autotune.TunePoint(B=4, k=TUNE_K, entries=32, p=TUNE_P, n=3, G=2, table_bytes=1)
    times = autotune.measure_candidates(pt, reps=3)
    assert set(times) == {None, *autotune.candidate_blocks(pt)}
    assert all(0 < t < 1 for t in times.values())
    assert autotune.search_blocks(pt, "measured", reps=3) in times


def _onehot_layer(device, table_format, seed=7):
    """A ``wq+wk+wv`` G = 3 group and a lone ``wo`` of 512 -> 384 converted
    on the card under a fixed-point 8/6 chunk-2 ``bitplane`` plan (fp32 or
    i8 tables)."""
    from repro_torch.core.convert import convert_params
    from repro_torch.core.lut import LUTPlan
    from repro_torch.core.planner import ModelPlan
    from repro_torch.core.quantize import FixedPointFormat

    gen = torch.Generator(device=device).manual_seed(seed)
    q, p = 512, 384
    names = ("wq", "wk", "wv", "wo")
    tree = {"attn": {n: {"w": torch.randn((q, p), generator=gen, device=device) / q**0.5,
                         "b": 0.1 * torch.randn(p, generator=gen, device=device)}
                     for n in names}}
    plan = LUTPlan(q, p, 2, FixedPointFormat(8, 6, signed=True), mode="bitplane",
                   table_format=table_format)
    mplan = ModelPlan({f"attn/{n}": plan for n in names},
                      groups=(("attn/wq", "attn/wk", "attn/wv"),))
    return convert_params(tree, plan=mplan)[0]["attn"]


@pytest.mark.cuda
@pytest.mark.parametrize("table_format", [None, "i8"], ids=["f32", "i8"])
@pytest.mark.parametrize("B", [4, 128])
def test_onehot_mxu_matches_the_kernels_on_card(cuda_device, table_format, B):
    """``linear_mode="onehot_mxu"`` on CUDA tensors (the plain path, asked
    for) against ``lut_affine`` (lone ``wo``) and ``lut_affine_grouped``
    (the G = 3 group, which the mode does not fuse) on the same input:
    each element within the tables' bf16 rounding (the plain gather over
    ``|T - bf16(T)|``, 0 for i8 entries) plus 1e-5 x max (fp32 sums in
    another order); the one-hot path launches no LUT kernel."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L

    attn = _onehot_layer(cuda_device, table_format)
    cfg = get_config("granite_8b", reduced=True)
    kctx = L.Ctx(cfg, ex=L.ExecCfg(remat="none", lut_grouped=True))
    octx = L.Ctx(cfg, ex=L.ExecCfg(remat="none", lut_grouped=True, linear_mode="onehot_mxu",
                                   use_kernels=False))
    x = 0.5 * torch.randn((B, 512), generator=torch.Generator(device=cuda_device).manual_seed(8),
                          device=cuda_device)
    names = ("wq", "wk", "wv", "wo")
    before = dict(ops.LAUNCHES)
    kern = L.fused_linears(attn, names, x, kctx)
    assert ops.LAUNCHES["lut_affine_grouped"] == before["lut_affine_grouped"] + 1
    assert ops.LAUNCHES["lut_affine"] == before["lut_affine"] + 1
    before = dict(ops.LAUNCHES)
    onehot = L.fused_linears(attn, names, x, octx)
    assert ops.LAUNCHES == before
    group, wo = attn["wq+wk+wv"], attn["wo"]
    for i, (k, o) in enumerate(zip(kern, onehot)):
        node, tables = (group, group.tables[i]) if i < 3 else (wo, wo.tables)
        codes = pack_ops.pack(x, node.plan)
        err = (tables.float() - tables.to(torch.bfloat16).float()).abs()
        scales = [abs(float(s)) for s in L._host_scales(node.plan, node.scale)]
        bound = ops.lut_affine(codes, err, scales, use_kernels=False)
        top = k.abs().max()
        assert bool(((o - k).abs() <= bound * (1 + 1e-6) + 1e-5 * top).all()), i
        if table_format == "i8":
            assert float(bound.max()) == 0.0
        else:
            assert not torch.equal(o, k)


@pytest.mark.cuda
def test_onehot_row_blocks_on_card(cuda_device, monkeypatch):
    """A one-hot built in row blocks (the last padded to the others' rows)
    gives the one-block product to fp32 summation order on the card (cuBLAS
    picks its reduction by the product's shape; the CPU test holds the
    blocks bit for bit)."""
    from repro_torch.models import layers as L

    wo = _onehot_layer(cuda_device, None)["wo"]
    x = torch.randn((37, 512), generator=torch.Generator(device=cuda_device).manual_seed(9),
                    device=cuda_device)
    codes = pack_ops.pack(x, wo.plan)
    scales = L._host_scales(wo.plan, wo.scale)
    whole = L._onehot_apply(wo.tables, wo.b, codes, scales)
    n, k, E = wo.plan.num_planes, wo.plan.num_chunks, wo.plan.num_entries
    monkeypatch.setattr(L, "_ONEHOT_BYTES", 8 * n * k * E * 4)
    _close(L._onehot_apply(wo.tables, wo.b, codes, scales), whole)
