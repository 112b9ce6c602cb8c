"""Parity of the port's core LUT modules with ``repro.core``: packed codes,
fp16 fields and sign bits, tables, narrow-table scales and the plan
accounting are bit-exact; the range certificate and the plain apply agree.

Inputs are made from numpy seeds and handed to both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.audit.ranges import layer_range_cert as j_cert
from repro.core import lut as jl
from repro.core.quantize import FixedPointFormat as JFixed
from repro.core.quantize import Float16Format as JF16
from repro_torch.audit.ranges import layer_range_cert
from repro_torch.core import lut as tl
from repro_torch.core.quantize import FixedPointFormat, Float16Format

# fp16 edge values: subnormals, +-0, the largest finite, the last value
# that rounds to it, the first that overflows, and far overflow
SPECIAL = np.array(
    [0.0, -0.0, 6e-8, -6e-8, 3e-6, 6.1e-5, -6.1e-5, 65504.0, -65504.0, 65519.0,
     65520.0, -65520.0, 1e6, -1e6, 1.0, -1.0, 0.5, 2049.0, 1e-3],
    np.float32,
)


def _inputs(seed: int, shape, with_special: bool = True) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * np.exp(rng.uniform(-12, 8, shape))).astype(
        np.float32
    )
    if with_special:
        flat = x.reshape(-1)
        flat[: SPECIAL.size] = SPECIAL[: flat.size]
    return x


def _pair(fmt_kind: str, **kw):
    if fmt_kind == "f16":
        return JF16(**kw), Float16Format(**kw)
    return JFixed(**kw), FixedPointFormat(**kw)


def _plans(q, p, m, fmt_kind, fmt_kw, mode, table_format=None):
    jf, tf = _pair(fmt_kind, **fmt_kw)
    return (
        jl.LUTPlan(q, p, m, jf, mode=mode, table_format=table_format),
        tl.LUTPlan(q, p, m, tf, mode=mode, table_format=table_format),
    )


PACK_CASES = [
    ("f16", dict(signed=True), "bitplane", 1),
    ("f16", dict(signed=False), "bitplane", 2),
    ("f16", dict(signed=True, mantissa_radix=2), "bitplane", 2),
    ("f16", dict(signed=True, mantissa_radix=4), "bitplane_shift", 1),
    ("f16", dict(signed=False, mantissa_radix=3), "bitplane_shift", 1),
    ("f16", dict(signed=True, mantissa_radix=1), "bitplane_shift", 1),
    ("f16", dict(signed=False), "full", 1),
    ("fixed", dict(total_bits=8, frac_bits=6, signed=True), "bitplane", 3),
    ("fixed", dict(total_bits=4, frac_bits=3, signed=False), "bitplane", 4),
    ("fixed", dict(total_bits=4, frac_bits=2, signed=True), "full", 2),
    ("fixed", dict(total_bits=3, frac_bits=3, signed=False), "full", 3),
]


@pytest.mark.parametrize("kind,fmt_kw,mode,m", PACK_CASES)
def test_pack_codes_bit_exact(kind, fmt_kw, mode, m):
    q = 23  # ragged: the tail chunk is padded
    jp, tp = _plans(q, 8, m, kind, fmt_kw, mode)
    x = _inputs(0, (3, 2, q))
    if kind == "fixed":
        x = np.clip(x, -4, 4)
    want = np.asarray(jl.pack_codes(jnp.asarray(x), jp))
    got = tl.pack_codes(torch.from_numpy(x), tp).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    radix=st.sampled_from([1, 2, 4]),
    signed=st.booleans(),
)
def test_fp16_fields_and_sign_bits_bit_exact(seed, radix, signed):
    x = _inputs(seed, (5, 37))
    jf, tf = JF16(signed=signed, mantissa_radix=radix), Float16Format(
        signed=signed, mantissa_radix=radix
    )
    h_j = jf.quantize(jnp.asarray(x))
    h_t = tf.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(
        np.asarray(h_j).view(np.uint16), h_t.numpy().view(np.uint16)
    )
    e_j, s_j = jf.decompose(h_j)
    e_t, s_t = tf.decompose(h_t)
    np.testing.assert_array_equal(np.asarray(e_j), e_t.numpy())
    np.testing.assert_array_equal(np.asarray(s_j), s_t.numpy())
    np.testing.assert_array_equal(
        np.asarray(jf.sign_bits(h_j)), tf.sign_bits(h_t).numpy()
    )
    np.testing.assert_array_equal(jf.plane_scales(), tf.plane_scales())


def test_fixed_point_bitplanes_bit_exact():
    jf, tf = JFixed(6, 3, signed=True), FixedPointFormat(6, 3, signed=True)
    x = np.clip(_inputs(3, (4, 19), with_special=False), -8, 8)
    c_j, c_t = jf.quantize(jnp.asarray(x)), tf.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(c_j), c_t.numpy())
    np.testing.assert_array_equal(
        np.asarray(jf.bitplanes(c_j)), tf.bitplanes(c_t).numpy()
    )
    np.testing.assert_array_equal(jf.plane_scales(), tf.plane_scales())


BUILD_CASES = [  # exact by construction: one product, or 0/1 sums of two
    ("f16", dict(signed=True, mantissa_radix=4), "bitplane_shift", 1),
    ("f16", dict(signed=False, mantissa_radix=2), "bitplane_shift", 1),
    ("f16", dict(signed=True), "bitplane", 1),
    ("f16", dict(signed=True), "bitplane", 2),
    ("f16", dict(signed=False), "full", 1),
    ("fixed", dict(total_bits=4, frac_bits=2, signed=True), "bitplane", 2),
    ("fixed", dict(total_bits=3, frac_bits=3, signed=False), "full", 1),
]


@pytest.mark.parametrize("kind,fmt_kw,mode,m", BUILD_CASES)
def test_build_luts_bit_exact_and_sliceable(kind, fmt_kw, mode, m):
    q, p = 13, 6
    jp, tp = _plans(q, p, m, kind, fmt_kw, mode)
    W = np.random.default_rng(1).standard_normal((q, p)).astype(np.float32)
    want = np.asarray(jl.build_luts(jnp.asarray(W), jp))
    got = tl.build_luts(torch.from_numpy(W), tp)
    np.testing.assert_array_equal(got.numpy(), want)
    # a chunk-sliced build is the same entries
    k = tp.num_chunks
    parts = [
        tl.build_luts(torch.from_numpy(W), tp, (c, min(k, c + 3)))
        for c in range(0, k, 3)
    ]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), want)
    np.testing.assert_array_equal(tl.plane_scales(tp), jl.plane_scales(jp))


@pytest.mark.parametrize("table_format", ["i8", "i16"])
@pytest.mark.parametrize("trailing", [None, 3])
def test_quantize_tables_bit_exact(table_format, trailing):
    rng = np.random.default_rng(2)
    mags = np.array([1e-3, 1.0, 40.0])[:, None, None, None]
    t = (rng.standard_normal((3, 5, 32, 7)) * mags).astype(np.float32)
    # a set whose max sits exactly on a power of two times qmax
    t[1, 0, 0, 0] = 2.0**3 * {"i8": 127.0, "i16": 32767.0}[table_format]
    q_j, s_j = jl.quantize_tables(jnp.asarray(t), table_format, trailing)
    q_t, s_t = tl.quantize_tables(torch.from_numpy(t), table_format, trailing)
    pow2 = exact_pow2(np.asarray(s_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.uint32), pow2.view(np.uint32))
    assert q_t.dtype == tl.TABLE_DTYPES[table_format]
    want = reference_quantize(t, pow2, table_format)
    np.testing.assert_array_equal(q_t.numpy(), want)
    # the reference's own tables differ only where its scale is inexact,
    # and then by at most one code
    exact = np.asarray(s_j) == pow2
    lead = exact.reshape(exact.shape + (1,) * (t.ndim - exact.ndim))
    diff = np.abs(np.asarray(q_j).astype(np.int64) - want)
    assert diff.max() <= 1 and not np.any(diff * np.broadcast_to(lead, t.shape))


def exact_pow2(ref_scale: np.ndarray) -> np.ndarray:
    """The power of two the reference's ``exp2(ceil(log2(.)))`` means.  Its
    own value can sit a few ulps off: XLA:CPU's vectorised exp2 is inexact
    at integer arguments (the scalar path is exact).  The port builds the
    exact power of two."""
    pow2 = (2.0 ** np.round(np.log2(ref_scale.astype(np.float64)))).astype(np.float32)
    np.testing.assert_allclose(ref_scale, pow2, rtol=2.0**-20, atol=0)
    return pow2


def reference_quantize(t: np.ndarray, pow2: np.ndarray, table_format: str):
    """The reference's quantization formula, run by the reference's jnp ops,
    with the exact power-of-two scale."""
    qmax = {"i8": 127.0, "i16": 32767.0}[table_format]
    sb = pow2.reshape(pow2.shape + (1,) * (t.ndim - pow2.ndim))
    q = jnp.clip(jnp.round(jnp.asarray(t) / sb), -qmax, qmax)
    return np.asarray(q).astype(np.int64)


PLAN_GRID = [
    (784, 10, 14, "fixed", dict(total_bits=3, frac_bits=3), "bitplane", None),
    (784, 10, 1, "fixed", dict(total_bits=3, frac_bits=3), "full", None),
    (4096, 1024, 1, "f16", dict(signed=True, mantissa_radix=4), "bitplane_shift", "i8"),
    (14336, 4096, 1, "f16", dict(signed=True, mantissa_radix=2), "bitplane_shift",
     "i16"),
    (100, 33, 2, "f16", dict(signed=True), "bitplane", None),
    (100, 33, 1, "f16", dict(signed=False), "full", None),
    (37, 5, 3, "fixed", dict(total_bits=8, frac_bits=4, signed=True), "bitplane", "i8"),
]
PLAN_FIELDS = (
    "num_chunks", "padded_in", "fields_per_element", "index_bits", "num_entries",
    "num_planes", "lut_evaluations", "shift_add_ops", "storage_bits",
    "total_lut_bits", "total_lut_bytes",
)


@pytest.mark.parametrize("q,p,m,kind,fmt_kw,mode,tf", PLAN_GRID)
def test_lut_plan_sizes_and_certificate_match(q, p, m, kind, fmt_kw, mode, tf):
    jp, tp = _plans(q, p, m, kind, fmt_kw, mode, tf)
    for f in PLAN_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    assert dataclasses.asdict(layer_range_cert(tp)).items() <= {
        **dataclasses.asdict(j_cert(jp))
    }.items()


def test_paper_mlp_op_counts():
    mlp = [(784, 1024), (1024, 512), (512, 10)]
    f16 = Float16Format()
    bp = sum(tl.LUTPlan(q, p, 1, f16).shift_add_ops for q, p in mlp)
    full = sum(tl.LUTPlan(q, p, 1, f16, mode="full").shift_add_ops for q, p in mlp)
    assert (bp, full) == (14652918, 1330678)


@pytest.mark.parametrize("kind,fmt_kw,mode,m", BUILD_CASES[:4] + BUILD_CASES[5:6])
def test_lut_affine_reference_matches(kind, fmt_kw, mode, m):
    q, p = 21, 9
    jp, tp = _plans(q, p, m, kind, fmt_kw, mode)
    rng = np.random.default_rng(4)
    W = rng.standard_normal((q, p)).astype(np.float32)
    b = rng.standard_normal((p,)).astype(np.float32)
    x = np.clip(rng.standard_normal((2, 3, q)).astype(np.float32), -1.9, 1.9)
    want = np.asarray(
        jl.lut_affine_reference(jnp.asarray(x), jnp.asarray(W), jnp.asarray(b), jp)
    )
    got = tl.lut_affine_reference(
        torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(b), tp
    ).numpy()
    # fp32 sums in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
