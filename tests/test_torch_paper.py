"""The port's host side of the paper's networks against the JAX package:
the MNIST stand-in ``image_batch``, the formats' ``dequantize`` /
``fake_quant``, the stochastic-rounding LUT, the paper's LUT accounting
(``core/analysis.py``) and ``benchmarks/paper_tables.py``'s rows.  All of
these are exact in both packages, so every comparison is bit for bit
except ``quantize_stochastic``, whose draws come from a
``torch.Generator`` where the reference takes a JAX key: it is held to
unbiasedness, as the reference's own test holds it."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analysis as janalysis
from repro.core import quantize as jq
from repro.data.synthetic import image_batch as jimage_batch
from repro_torch.benchmarks import paper_tables
from repro_torch.core import analysis
from repro_torch.core.quantize import (
    FixedPointFormat,
    Float16Format,
    build_stochastic_rounding_lut,
    stochastic_round_via_lut,
)
from repro_torch.data.synthetic import image_batch


def _reference_script(name: str):
    """A module of the repo's ``benchmarks/`` folder (not a package), by path."""
    path = Path(__file__).resolve().parents[1] / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "batch,step,seed,noise",
    [(4, 0, 0, 0.25), (128, 7, 0, 0.25), (500, 50_000, 0, 0.25), (33, 3, 5, 0.1),
     (16, 10_001, 2, 0.0)],
)
def test_image_batch_is_the_references_bit_for_bit(batch, step, seed, noise):
    x, y = image_batch(batch, step, seed=seed, noise=noise, device="cpu")
    jx, jy = jimage_batch(batch, step, seed=seed, noise=noise)
    assert x.dtype == torch.float32 and y.dtype == torch.int32
    assert tuple(x.shape) == (batch, 28, 28) and tuple(y.shape) == (batch,)
    np.testing.assert_array_equal(x.numpy().view(np.uint32), np.asarray(jx).view(np.uint32))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


# ---------------------------------------------------------------------------
# formats
# ---------------------------------------------------------------------------

FIXED = [FixedPointFormat(3, 3), FixedPointFormat(8, 8), FixedPointFormat(8, 6, True),
         FixedPointFormat(12, 3, True), FixedPointFormat(1, 0)]


def _inputs(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, n).astype(np.float32)
    # rounding ties of every grid above, zeros and saturation
    edges = np.array([0.0, -0.0, 0.0625, 0.1875, 0.5, 0.999, 1.0, 2.5, -2.5, 1e6, -1e6],
                     np.float32)
    return np.concatenate([x, edges, x / 64])


@pytest.mark.parametrize("i", range(len(FIXED)))
def test_fixed_dequantize_and_fake_quant_bit_for_bit(i):
    fmt = FIXED[i]
    jfmt = jq.FixedPointFormat(fmt.total_bits, fmt.frac_bits, fmt.signed)
    x = _inputs(i)
    t = torch.from_numpy(x)
    codes = fmt.quantize(t)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jfmt.quantize(jnp.asarray(x))))
    np.testing.assert_array_equal(
        fmt.dequantize(codes).numpy().view(np.uint32),
        np.asarray(jfmt.dequantize(jnp.asarray(codes.numpy()))).view(np.uint32),
    )
    np.testing.assert_array_equal(
        fmt.fake_quant(t).numpy().view(np.uint32),
        np.asarray(jfmt.fake_quant(jnp.asarray(x))).view(np.uint32),
    )


def test_fixed_fake_quant_passes_the_gradient_straight_through():
    t = torch.linspace(-1, 1, 33, requires_grad=True)
    FixedPointFormat(4, 2, True).fake_quant(t).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.ones(33, np.float32))


@pytest.mark.parametrize("signed", [False, True])
def test_float16_dequantize_and_fake_quant_bit_for_bit(signed):
    fmt, jfmt = Float16Format(signed), jq.Float16Format(signed)
    x = np.concatenate([_inputs(7), np.array([65504.0, 1e5, 6e-8, 3e-8], np.float32)])
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        fmt.dequantize(fmt.quantize(t)).numpy().view(np.uint32),
        np.asarray(jfmt.dequantize(jfmt.quantize(jnp.asarray(x)))).view(np.uint32),
    )
    np.testing.assert_array_equal(
        fmt.fake_quant(t).numpy().view(np.uint32),
        np.asarray(jfmt.fake_quant(jnp.asarray(x))).view(np.uint32),
    )


@pytest.mark.parametrize("fmt", [FixedPointFormat(4, 2), FixedPointFormat(4, 2, True)],
                         ids=["unsigned", "signed"])
def test_quantize_stochastic_is_unbiased(fmt):
    # 3.3 and -1.1 lie off the 0.25 grid; 20,000 draws each: the mean's
    # standard error is under 0.002, the tolerance 0.01
    g = torch.Generator().manual_seed(0)
    for v in (1.3, -1.1, 0.5):
        x = torch.full((20_000,), v)
        codes = fmt.quantize_stochastic(x, g)
        lo = np.floor(v / fmt.scale)
        want = np.clip([lo, lo + 1], fmt.code_min, fmt.code_max)
        assert set(codes.unique().tolist()) <= set(want.astype(int).tolist())
        mean = float(fmt.dequantize(codes).mean())
        np.testing.assert_allclose(mean, np.clip(v, fmt.min_value, fmt.max_value),
                                   atol=0.01)
    # saturates at the format's ends
    big = fmt.quantize_stochastic(torch.tensor([100.0, -100.0]), g)
    assert big.tolist() == [fmt.code_max, fmt.code_min]


# ---------------------------------------------------------------------------
# stochastic rounding as a LUT
# ---------------------------------------------------------------------------

SR_CASES = [(FixedPointFormat(4, 0), 8, 64, 0), (FixedPointFormat(4, 0, True), 8, 64, 0),
            (FixedPointFormat(3, 2, True), 6, 17, 3), (FixedPointFormat(5, 1), 7, 9, 11)]


@pytest.mark.parametrize("case", SR_CASES, ids=["u4of8", "s4of8", "s3of6", "u5of7"])
def test_stochastic_rounding_table_and_lookup_are_the_references(case):
    fmt, in_bits, R, seed = case
    jfmt = jq.FixedPointFormat(fmt.total_bits, fmt.frac_bits, fmt.signed)
    table = build_stochastic_rounding_lut(fmt, in_bits, R, seed)
    jtable = jq.build_stochastic_rounding_lut(jfmt, in_bits, R, seed)
    assert table.dtype == np.int32
    np.testing.assert_array_equal(table, jtable)
    # every code of the input format, at every counter below R (and past it)
    if fmt.signed:
        codes = np.arange(-(2 ** (in_bits - 1)), 2 ** (in_bits - 1), dtype=np.int32)
    else:
        codes = np.arange(2**in_bits, dtype=np.int32)
    for step in list(range(R)) + [R, 3 * R + 1]:
        got = stochastic_round_via_lut(table, torch.from_numpy(codes), step)
        want = jq.stochastic_round_via_lut(jtable, jnp.asarray(codes), step)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stochastic_rounding_unbiased():
    fmt = FixedPointFormat(4, 0)
    table = build_stochastic_rounding_lut(fmt, in_bits=8, R=4096, seed=0)
    code = torch.tensor(0b0011_0100, dtype=torch.int32)  # 3.25, 4 extra frac bits
    outs = stochastic_round_via_lut(table, code.expand(4096), torch.arange(4096)).numpy()
    assert set(outs.tolist()) <= {3, 4}
    np.testing.assert_allclose(outs.mean(), 3.25, atol=0.05)


def test_stochastic_rounding_signed_two_complement():
    fmt = FixedPointFormat(4, 0, signed=True)
    table = build_stochastic_rounding_lut(fmt, in_bits=8, R=4096, seed=0)
    assert int(table.min()) == fmt.code_min  # the negative half is present
    steps = torch.arange(4096)

    def outs(code, n=4096):
        c = torch.tensor(code, dtype=torch.int32).expand(n)
        return stochastic_round_via_lut(table, c, steps[:n]).numpy()

    neg = outs(-52)  # -3.25: floors to -4, rounds up to -3 w.p. 0.25
    assert set(neg.tolist()) <= {-4, -3}
    np.testing.assert_allclose(neg.mean(), -3.25, atol=0.05)
    assert set(outs(-64, 64).tolist()) == {-4}  # exact values never dither
    assert set(outs(-128, 64).tolist()) == {fmt.code_min}  # saturates
    pos = outs(0b0011_0100)
    assert set(pos.tolist()) <= {3, 4}
    np.testing.assert_allclose(pos.mean(), 3.25, atol=0.05)


def test_stochastic_rounding_table_refuses_a_narrower_input():
    with pytest.raises(ValueError, match="wider"):
        build_stochastic_rounding_lut(FixedPointFormat(4, 0), 4, 8)


# ---------------------------------------------------------------------------
# the paper's accounting
# ---------------------------------------------------------------------------


def test_paper_claims_are_the_references():
    assert analysis.paper_claims() == janalysis.paper_claims()


def _jlayers(layers):
    return tuple(janalysis.LayerShape(s.in_features, s.out_features) for s in layers)


@pytest.mark.parametrize(
    "layers,fmt,jfmt",
    [
        ("LINEAR_CLASSIFIER", FixedPointFormat(3, 3), jq.FixedPointFormat(3, 3)),
        ("MLP", Float16Format(), jq.Float16Format()),
        ("CNN_DENSE", Float16Format(), jq.Float16Format()),
        ("MLP", FixedPointFormat(8, 8), jq.FixedPointFormat(8, 8)),
    ],
    ids=["linear_fixed3", "mlp_fp16", "cnn_dense_fp16", "mlp_fixed8"],
)
def test_figure_curve_is_the_references(layers, fmt, jfmt):
    mine, ref = getattr(analysis, layers), getattr(janalysis, layers)
    assert _jlayers(mine) == ref
    assert analysis.figure_curve(mine, fmt) == janalysis.figure_curve(ref, jfmt)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_conv_layer_costs_are_the_references(m):
    assert analysis.CNN_CONVS == janalysis.CNN_CONVS
    for q, p, pos in analysis.CNN_CONVS:
        assert analysis.conv_layer_cost(q, p, pos, Float16Format(), m) == (
            janalysis.conv_layer_cost(q, p, pos, jq.Float16Format(), m)
        )


def test_paper_tables_rows_are_the_references():
    rows, jrows = paper_tables.rows(), _reference_script("paper_tables").rows()
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    assert rows == jrows
