"""The port's TL1 family against the JAX package's, piece by piece: the
ternary and absmax quantizers, base-3 pair packing, the 9-entry activation
LUT, ``apply_tl1``, the kernel wrappers' plain versions (against the
reference's Pallas kernels in interpret mode), the range certificate, the
plan JSON and the converted tables.

The int path (``act_bits`` set) is integer arithmetic end to end, so it
must match bit for bit; the exact fp32 path sums in another order and is
held to 1e-5 relative."""
import jax
import jax.numpy as jnp
import types

import numpy as np
import pytest
import torch

from repro.audit.ranges import layer_range_cert as jcert
from repro.configs.base import get_config as jget_config
from repro.core import lut_tl1 as jtl1
from repro.core import quantize as jq
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_from_json as jplan_from_json
from repro.core.planner import plan_model as jplan_model
from repro.core.planner import plan_to_json as jplan_to_json
from repro.kernels.lut_tl1 import ops as jops
from repro.kernels.lut_tl1 import ref as jref
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro_torch.audit.ranges import layer_range_cert
from repro_torch.configs.base import get_config
from repro_torch.core import lut_tl1 as tl1
from repro_torch.core.convert import LUTGroup, LUTLinear, convert_params
from repro_torch.core.planner import ModelPlan, plan_from_json, plan_model, plan_to_json
from repro_torch.core.quantize import (
    FixedPointFormat,
    absmax_int_quantize,
    ternary_fake_quant,
    ternary_quantize,
)
from repro_torch.kernels.lut_tl1 import ops
from repro_torch.kernels.lut_tl1.ref import (
    fold_act_lut,
    lut_tl1_biased_ref,
    lut_tl1_folded_ref,
    lut_tl1_grouped_ref,
    lut_tl1_ref,
)
from repro_torch.models.layers import Ctx, ExecCfg, fused_linears
from repro_torch.models.params import params_from_numpy

# ulps of a float32 reduction taken in another order than XLA's
SCALE_RTOL = 2e-6
# the exact path's fp32 sums, in another order
EXACT_RTOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _weights(seed, shape, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _exact_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=EXACT_RTOL,
        atol=EXACT_RTOL * max(1e-30, float(np.abs(want).max())),
    )


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(37, 19), (64, 128), (3, 8), (512, 96)])
def test_ternary_quantize_matches_reference(shape):
    w = _weights(sum(shape), shape, 0.3)
    jt, js = jq.ternary_quantize(jnp.asarray(w))
    t, s = ternary_quantize(_t(w))
    assert t.dtype == torch.int8 and s.dtype == torch.float32 and s.ndim == 0
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(s.item(), float(js), rtol=SCALE_RTOL)
    # the refit makes the quantizer idempotent
    t2, s2 = ternary_quantize(s * t.to(torch.float32))
    np.testing.assert_array_equal(t2.numpy(), t.numpy())
    np.testing.assert_allclose(s2.item(), s.item(), rtol=1e-6)
    np.testing.assert_allclose(
        ternary_fake_quant(_t(w)).numpy(),
        np.asarray(jq.ternary_fake_quant(jnp.asarray(w))),
        rtol=SCALE_RTOL, atol=0,
    )


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape", [(5, 38), (2, 3, 30)])
def test_absmax_int_quantize_matches_reference(bits, shape):
    x = _weights(bits, shape, 1.0)
    x[0, ..., 0] = 0.0
    jc, js = jq.absmax_int_quantize(jnp.asarray(x), bits=bits)
    c, s = absmax_int_quantize(_t(x), bits=bits)
    assert c.dtype == torch.int32 and s.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=SCALE_RTOL, atol=0)


# ---------------------------------------------------------------------------
# packing, activation LUTs, apply_tl1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q,p", [(2, 3), (6, 5), (37, 19), (64, 8), (1, 1)])
def test_pack_and_unpack_bit_exact(q, p):
    t = np.random.default_rng(q * p).integers(-1, 2, (q, p)).astype(np.int8)
    packed = tl1.pack_ternary(_t(t))
    want = np.asarray(jtl1.pack_ternary(jnp.asarray(t)))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(
        tl1.unpack_indices(packed).numpy(), np.asarray(jtl1.unpack_indices(want))
    )
    # and stacked (leading dims)
    stacked = np.stack([want, want[::-1]])
    np.testing.assert_array_equal(
        tl1.unpack_indices(_t(stacked)).numpy(),
        np.asarray(jtl1.unpack_indices(jnp.asarray(stacked))),
    )


def test_build_act_lut_bit_exact():
    rng = np.random.default_rng(3)
    codes = rng.integers(-127, 128, (2, 3, 40)).astype(np.int32)
    lut = tl1.build_act_lut(_t(codes))
    want = np.asarray(jtl1.build_act_lut(jnp.asarray(codes)))
    assert lut.dtype == torch.int16 and want.dtype == np.int16
    np.testing.assert_array_equal(lut.numpy(), want)
    vals = rng.standard_normal((3, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        tl1.build_act_lut(_t(vals)).numpy(),
        np.asarray(jtl1.build_act_lut(jnp.asarray(vals))),
    )


@pytest.mark.parametrize("act_bits", [8, 4, None])
@pytest.mark.parametrize("lead,q,p", [((5,), 37, 19), ((2, 3), 64, 24)])
def test_apply_tl1_matches_reference(act_bits, lead, q, p):
    w = _weights(q, (q, p))
    x = _weights(p, lead + (q,), 1.0)
    b = _weights(7, (p,), 0.01)
    jtab, js = jtl1.build_tl1_tables(jnp.asarray(w))
    plan = tl1.TL1Plan(q, p, act_bits=act_bits)
    jplan = jtl1.TL1Plan(q, p, act_bits=act_bits)
    want = np.asarray(
        jtl1.apply_tl1(jtab, jnp.asarray(x), jplan, bias=jnp.asarray(b), scale=js)
    )
    # from the reference's tables and scale, so only the apply is compared
    got = tl1.apply_tl1(
        _t(np.asarray(jtab)), _t(x), plan, bias=_t(b), scale=_t(np.asarray(js))
    )
    if act_bits is None:
        _exact_close(got, want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    codes, act_scale = tl1.quantize_acts(_t(x), plan)
    jcodes, jact = jtl1.quantize_acts(jnp.asarray(x), jplan)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    if act_bits is not None:
        np.testing.assert_array_equal(act_scale.numpy(), np.asarray(jact))
    else:
        assert act_scale is None and jact is None


def test_apply_tl1_exact_equals_ternary_dense():
    w, x = _weights(2, (37, 19)), _weights(3, (5, 37), 1.0)
    plan = tl1.TL1Plan(37, 19, act_bits=None)
    got = tl1.tl1_linear_reference(_t(w), _t(x), plan)
    want = _t(x) @ ternary_fake_quant(_t(w))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# kernel wrappers (plain versions) against the reference's Pallas kernels
# ---------------------------------------------------------------------------


def _kernel_case(seed, lead, q, p, act_bits, G=None):
    shape = ((G,) if G else ()) + (q, p)
    w = _weights(seed, shape)
    if G:
        built = [jtl1.build_tl1_tables(jnp.asarray(w[g])) for g in range(G)]
        tables = np.stack([np.asarray(t) for t, _ in built])
        scale = np.stack([np.asarray(s) for _, s in built])
    else:
        jt, js = jtl1.build_tl1_tables(jnp.asarray(w))
        tables, scale = np.asarray(jt), np.asarray(js)
    x = _weights(seed + 1, lead + (q,), 1.0)
    codes, act_scale = jtl1.quantize_acts(jnp.asarray(x), jtl1.TL1Plan(q, p, act_bits))
    act_scale = None if act_scale is None else np.asarray(act_scale)
    bias = _weights(seed + 2, ((G,) if G else ()) + (p,), 0.01)
    return np.asarray(codes), tables, act_scale, scale, bias


def _maybe(a):
    return None if a is None else _t(a)


@pytest.mark.parametrize("act_bits", [8, 4, None])
@pytest.mark.parametrize("lead,q,p", [((5,), 38, 19), ((2, 3), 30, 12), ((1,), 2, 1)])
def test_plain_lut_tl1_matches_reference_kernel(act_bits, lead, q, p):
    codes, tables, act_scale, scale, bias = _kernel_case(4, lead, q, p, act_bits)
    want = np.asarray(jops.lut_tl1(
        jnp.asarray(codes), jnp.asarray(tables),
        None if act_scale is None else jnp.asarray(act_scale), jnp.asarray(scale),
        bias=jnp.asarray(bias), interpret=True,
    ))
    before = dict(ops.LAUNCHES)
    got = ops.lut_tl1(
        _t(codes), _t(tables), _maybe(act_scale), _t(scale), bias=_t(bias),
        plan=tl1.TL1Plan(q, p, act_bits=act_bits),
    )
    assert ops.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert tuple(got.shape) == lead + (p,)
    if act_bits is None:
        _exact_close(got, want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    # the raw accumulate against the reference's oracle, sliced or not
    flat = codes.reshape(-1, codes.shape[-1])
    kb = tables.shape[0]
    jraw = np.asarray(jref.lut_tl1_ref(
        jnp.swapaxes(jnp.asarray(flat).reshape(-1, kb, 4), 1, 2), jnp.asarray(tables)
    ))
    for nbytes in (1 << 30, 64):
        raw = lut_tl1_ref(_t(flat), _t(tables), max_gather_bytes=nbytes)
        assert raw.dtype == (torch.float32 if act_bits is None else torch.int32)
        if act_bits is None:
            _exact_close(raw, jraw)
        else:
            np.testing.assert_array_equal(raw.numpy(), jraw)


@pytest.mark.parametrize("act_bits", [8, None])
def test_plain_lut_tl1_grouped_matches_reference_kernel(act_bits):
    G, lead, q, p = 3, (2, 2), 38, 19
    codes, tables, act_scale, scale, biases = _kernel_case(5, lead, q, p, act_bits, G=G)
    want = np.asarray(jops.lut_tl1_grouped(
        jnp.asarray(codes), jnp.asarray(tables),
        None if act_scale is None else jnp.asarray(act_scale), jnp.asarray(scale),
        biases=jnp.asarray(biases), interpret=True,
    ))
    got = ops.lut_tl1_grouped(
        _t(codes), _t(tables), _maybe(act_scale), _t(scale), biases=_t(biases),
        plan=tl1.TL1Plan(q, p, act_bits=act_bits),
    )
    assert tuple(got.shape) == (G,) + lead + (p,)
    if act_bits is None:
        _exact_close(got, want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    # and member by member through the lone wrapper
    for g in range(G):
        one = ops.lut_tl1(
            _t(codes), _t(tables[g]), _maybe(act_scale), _t(scale[g]),
            bias=_t(biases[g]),
        )
        np.testing.assert_array_equal(one.numpy(), got[g].numpy())
    raw = lut_tl1_grouped_ref(_t(codes.reshape(-1, codes.shape[-1])), _t(tables))
    assert tuple(raw.shape) == (G, 4, p)


# ---------------------------------------------------------------------------
# the kernel's folded byte LUT (one lookup per packed byte), in plain form
# ---------------------------------------------------------------------------


def _jraw(codes: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """The reference's oracle of the raw accumulate, (B, p)."""
    kb = tables.shape[0]
    return np.asarray(jref.lut_tl1_ref(
        jnp.swapaxes(jnp.asarray(codes).reshape(-1, kb, 4), 1, 2), jnp.asarray(tables)
    ))


@pytest.mark.parametrize("act_bits", [8, 4, None])
@pytest.mark.parametrize("lead,q,p", [((5,), 38, 19), ((2, 3), 30, 12), ((1,), 2, 1)])
def test_folded_byte_lut_matches_reference_oracle(act_bits, lead, q, p):
    codes, tables, _, _, _ = _kernel_case(7, lead, q, p, act_bits)
    flat = codes.reshape(-1, codes.shape[-1])
    got = lut_tl1_folded_ref(_t(flat), _t(tables))
    want = _jraw(flat, tables)
    if act_bits is None:
        _exact_close(got, want)
        return
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, lut_tl1_ref(_t(flat), _t(tables)))
    # the kernel's int16 arithmetic: biased entries, two tokens per word
    assert torch.equal(lut_tl1_biased_ref(_t(flat), _t(tables)), got)


def test_folded_byte_lut_grouped_and_sliced():
    codes, tables, _, _, _ = _kernel_case(8, (2, 2), 38, 19, 8, G=3)
    flat = _t(codes.reshape(-1, codes.shape[-1]))
    want = lut_tl1_grouped_ref(flat, _t(tables))
    for g in range(3):
        for nbytes in (1 << 30, 64):
            got = lut_tl1_folded_ref(flat, _t(tables[g]), max_gather_bytes=nbytes)
            assert torch.equal(got, want[g])
        assert torch.equal(lut_tl1_biased_ref(flat, _t(tables[g])), want[g])


def test_fold_act_lut_is_the_sum_of_the_pair_luts():
    """81 slots (both nibbles <= 8) hold lo-pair + hi-pair entries, built
    with adds only; the other 175 are 0."""
    rng = np.random.default_rng(9)
    acts = torch.from_numpy(rng.integers(-127, 128, (3, 8)).astype(np.int32))
    folded = fold_act_lut(acts)
    assert tuple(folded.shape) == (3, 2, 256) and folded.dtype == torch.int32
    pair = tl1.build_act_lut(acts).to(torch.int32).reshape(3, 2, 2, 9)
    for byte in range(256):
        lo, hi = byte & 15, byte >> 4
        want = pair[:, :, 0, lo] + pair[:, :, 1, hi] if lo <= 8 and hi <= 8 else 0
        assert torch.equal(folded[:, :, byte], torch.as_tensor(want).expand(3, 2))


@pytest.mark.parametrize("kb", [63, 64, 65, 129])
@pytest.mark.parametrize("B", [1, 4, 5])
def test_biased_flush_boundary_at_extreme_codes(kb, B):
    """Codes at +-127, where folded entries reach +-508 (biased 4..1020):
    64 rows fit a 16-bit half exactly, so a flush every 64 rows is exact
    around the boundary; 65 rows of the largest entry overflow a half."""
    rng = np.random.default_rng(kb + B)
    acts = torch.from_numpy((127 * rng.choice([-1, 1], (B, 4 * kb))).astype(np.int32))
    nib = rng.integers(0, 9, (kb, 33, 2))
    tables = torch.from_numpy((nib[..., 0] | (nib[..., 1] << 4)).astype(np.uint8))
    want = lut_tl1_ref(acts, tables)
    assert torch.equal(lut_tl1_biased_ref(acts, tables), want)
    if kb <= 64:  # one flush for all rows
        assert torch.equal(lut_tl1_biased_ref(acts, tables, flush_rows=kb), want)
    # every entry at +508: byte 0x88 of a token whose codes are all +127
    top = torch.full((2, 4 * kb), 127, dtype=torch.int32)
    full = torch.full((kb, 3), 0x88, dtype=torch.uint8)
    assert torch.equal(lut_tl1_biased_ref(top, full), lut_tl1_ref(top, full))
    if kb > 64:
        with pytest.raises(AssertionError, match="16-bit half"):
            lut_tl1_biased_ref(top, full, flush_rows=65)


def test_biased_form_refuses_entries_past_511():
    acts = torch.full((1, 8), 200, dtype=torch.int32)  # entries up to 800
    tables = torch.zeros((2, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="511"):
        lut_tl1_biased_ref(acts, tables)


def test_entry_format_is_decided_from_the_plan():
    # every TL1 plan proves 4 * qa <= 508: int16 entries, biased, two tokens
    # to a 32-bit add; no plan (or no act_bits): int32; the exact path fp32
    for bits in (2, 4, 8):
        assert ops.entry_format(tl1.TL1Plan(16, 8, act_bits=bits), False) == "int16"
    assert ops.entry_format(None, False) == "int32"
    assert ops.entry_format(types.SimpleNamespace(act_bits=None), False) == "int32"
    assert ops.entry_format(types.SimpleNamespace(act_bits=9), False) == "int32"  # 4*255
    assert ops.entry_format(tl1.TL1Plan(16, 8, act_bits=None), True) == "float32"
    assert ops.entry_format(None, True) == "float32"


def test_launch_split_and_tile_rules():
    # decode: one wave of 3 blocks per SM, whole multiples of the output tiles
    assert ops.tile_rows(4) == 4 and ops.tile_rows(5) == 8
    assert ops.k_splits(2, 4, 1024, 14336, 132) == 14  # 28 tiles of 1024 columns
    assert ops.k_splits(1, 4, 1024, 4096, 132) == 64  # 4 tiles, 16 rows each
    assert ops.k_splits(1, 4, 3584, 4096, 132) == ops.MAX_SPLITS  # w_down
    assert ops.k_splits(2, 4, 1024, 1024, 132) == 64  # wk+wv
    assert ops.k_splits(2, 128, 1024, 14336, 132) == 1  # prefill fills the card
    assert ops.k_splits(1, 1, 40, 1024, 132) == 2  # at least 16 rows a range
    assert ops.k_splits(1, 1, 5, 1024, 132) == 1
    assert ops.k_splits(1, 1, 1, 1, 132) == 1


def test_wrappers_check_the_acc_contract():
    codes, tables, act_scale, scale, _ = _kernel_case(6, (2,), 16, 8, 8)
    bad = tl1.TL1Plan(16, 8, acc_dtype="int16", max_abs_acc=1e6)
    with pytest.raises(ValueError, match="capacity"):
        ops.lut_tl1(_t(codes), _t(tables), _t(act_scale), _t(scale), plan=bad)
    with pytest.raises(ValueError, match="capacity"):
        ops.lut_tl1_grouped(
            _t(codes), _t(tables[None]), _t(act_scale), _t(scale[None]), plan=bad
        )
    with pytest.raises(ValueError, match="width"):
        ops.lut_tl1(_t(codes[:, :-4]), _t(tables))


# ---------------------------------------------------------------------------
# certificate, plan accounting and JSON
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act_bits", [8, 4, 2, None])
@pytest.mark.parametrize("q,p", [(37, 19), (4096, 14336)])
def test_range_cert_and_accounting_match_reference(act_bits, q, p):
    plan, jplan = tl1.TL1Plan(q, p, act_bits), jtl1.TL1Plan(q, p, act_bits)
    got, want = layer_range_cert(plan, w_max=0.5), jcert(jplan, w_max=0.5)
    for f in ("family", "integer", "max_abs_acc", "min_acc_dtype", "entry_max",
              "table_quant_err", "act_quant_err"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("chunk_size", "num_chunks", "packed_chunks", "padded_in", "num_entries",
              "num_planes", "lut_evaluations", "shift_add_ops", "storage_bits",
              "total_lut_bits", "total_lut_bytes", "acc_dtype"):
        assert getattr(plan, f) == getattr(jplan, f), f


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"act_bits": None},
        {"act_bits": 4, "blocks": (8, 128, 16), "max_abs_acc": 140.0},
        {"acc_dtype": "int16"},
    ],
)
def test_plan_json_is_the_reference_json(kw):
    jplan = jtl1.TL1Plan(64, 24, **kw)
    plan = plan_from_json(jplan_to_json(jplan))
    assert isinstance(plan, tl1.TL1Plan)
    assert plan_to_json(plan) == jplan_to_json(jplan)
    assert plan == tl1.TL1Plan(64, 24, **kw)
    assert jplan_from_json(plan_to_json(plan)) == jplan


@pytest.mark.parametrize("act_bits", [8, 4])
@pytest.mark.parametrize("q,p,fits", [(16384, 64, False), (64, 16, True)])
def test_planner_acc_dtype_gate_matches_reference(act_bits, q, p, fits):
    """``tl1_acc_dtype`` narrower than int32: a 16384-wide TL1 layer proves
    an accumulator bound past int16 (int8 and int4 codes alike) and both
    packages refuse to plan it; a 64-wide one fits, and both stamp the same
    plan."""
    kw = dict(families=("tl1",), tl1_act_bits=act_bits, tl1_acc_dtype="int16")
    jparams = {"ffn": {"w": jax.ShapeDtypeStruct((q, p), jnp.float32)}}
    params = {"ffn": {"w": torch.empty((q, p), device="meta")}}
    if not fits:
        for planner, tree in ((jplan_model, jparams), (plan_model, params)):
            with pytest.raises(ValueError, match="no overflow-safe plan"):
                planner(tree, float("inf"), **kw)
        return
    mplan = plan_model(params, float("inf"), **kw)
    assert mplan.to_json() == jplan_model(jparams, float("inf"), **kw).to_json()
    ((plan),) = mplan.layers.values()
    assert plan.acc_dtype == "int16"
    assert plan.max_abs_acc == layer_range_cert(plan).max_abs_acc <= 2**15 - 1


@pytest.fixture(scope="module")
def granite():
    cfg = jget_config("granite_8b", reduced=True)
    jp = jinit_params(jmodel_specs(cfg), jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


@pytest.mark.parametrize(
    "kw",
    [
        {"families": ("tl1",)},
        {"families": ("tl1",), "tl1_act_bits": None},
        {"families": ("tl1",), "tl1_act_bits": 4},
    ],
)
def test_model_plan_json_identical_to_reference(granite, kw):
    jp, tp = granite
    want = jplan_model(jp, float("inf"), **kw).to_json()
    assert plan_model(tp, float("inf"), **kw).to_json() == want
    assert ModelPlan.from_json(want).to_json() == want


def test_mixed_family_plan_json_identical_to_reference(granite):
    """Under a budget between TL1's floor and full-mode fixed-point weight
    tables, the knapsack gives layers different families, in both
    packages alike."""
    jp, tp = granite
    kw = dict(max_chunk=2, modes=("bitplane", "full"), families=("weight", "tl1"))
    jfmt = jq.FixedPointFormat(4, 3, signed=True)
    fmt = FixedPointFormat(4, 3, signed=True)
    floor = jplan_model(jp, float("inf"), families=("tl1",)).total_lut_bytes
    top = jplan_model(jp, float("inf"), fmt=jfmt, **kw).total_lut_bytes
    mid = (floor + top) // 3
    want = jplan_model(jp, mid, fmt=jfmt, **kw).to_json()
    mplan = plan_model(tp, mid, fmt=fmt, **kw)
    assert mplan.families == ("weight", "tl1")
    assert mplan.to_json() == want


def test_converted_tl1_tables_bit_exact(granite):
    jp, tp = granite
    jm = jplan_model(jp, float("inf"), families=("tl1",))
    mplan = ModelPlan.from_json(jm.to_json())
    jlut, jrep = jconvert(jp, plan=jm)
    tlut, rep = convert_params(tp, plan=mplan)
    assert rep.table_bytes == jrep.table_bytes == mplan.total_lut_bytes
    assert rep.grouped == jrep.grouped == 2
    for parent, key, cls in (
        ("attn", "wq", LUTLinear), ("attn", "wo", LUTLinear),
        ("attn", "wk+wv", LUTGroup), ("ffn", "w_gate+w_up", LUTGroup),
        ("ffn", "w_down", LUTLinear),
    ):
        got, want = tlut["blocks"][parent][key], jlut["blocks"][parent][key]
        assert isinstance(got, cls) and got.plan == mplan.layers[
            f"blocks/{parent}/{key.split('+')[0]}"
        ]
        assert got.tables.dtype == torch.uint8
        np.testing.assert_array_equal(got.tables.numpy(), np.asarray(want.tables))
        assert tuple(got.scale.shape) == want.scale.shape
        np.testing.assert_allclose(
            got.scale.numpy(), np.asarray(want.scale), rtol=SCALE_RTOL, atol=0
        )


# ---------------------------------------------------------------------------
# layers: a fused TL1 group equals its members
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act_bits", [8, None])
def test_tl1_group_fused_equals_unfused(act_bits):
    cfg = get_config("granite_8b", reduced=True)
    q, p = 64, 32
    params = {
        "wk": {"w": _t(_weights(8, (q, p)))},
        "wv": {"w": _t(_weights(9, (q, p)))},
    }
    plan = tl1.TL1Plan(q, p, act_bits=act_bits)
    mplan = ModelPlan({"wk": plan, "wv": plan}, groups=(("wk", "wv"),))
    conv, _ = convert_params(params, plan=mplan)
    flat, _ = convert_params(params, plan=mplan, group_siblings=False)
    assert isinstance(conv["wk+wv"], LUTGroup) and isinstance(flat["wk"], LUTLinear)
    x = _t(_weights(10, (3, q), 1.0))
    fused = fused_linears(conv, ("wk", "wv"), x, Ctx(cfg, ex=ExecCfg(lut_grouped=True)))
    members = fused_linears(conv, ("wk", "wv"), x, Ctx(cfg))
    lone = fused_linears(flat, ("wk", "wv"), x, Ctx(cfg))
    for a, b, c in zip(fused, members, lone):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), c.numpy())
