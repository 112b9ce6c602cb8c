"""The packing kernel's ``shift`` kind and the plan-taking ``pack`` entry,
on the CPU.

* The plain ``shift`` kind (``bitplane_pack(kind="shift")`` and
  ``pack(x, plan)``) against the JAX package's ``pack_codes`` on
  ``bitplane_shift`` plans, bit for bit: signed and unsigned, radix 1, 2,
  4 and 11, fp32 and bf16 inputs, and the edge values of fp16 rounding.
* A numpy mirror of the CUDA kernel's per-element arithmetic
  (``csrc/bitplane_pack.cu``: ``word`` and ``field``, the chunk shifts and
  the bf16-rounded clip bounds), held to both packages for every kind.
  The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
* ``kernel_args(plan)`` over every plan kind and mode, and the
  ``PLAIN_CALLS`` count of the plans it does not cover.
* The model's pack sites (``_lut_apply``, ``_group_apply``,
  ``fused_linears`` and the MoE dispatch's ``sorted_codes``) go through
  ``kernels.bitplane_pack.ops.pack``, counted by a spy; no launch is
  counted on the CPU, and the outputs are bit for bit those of
  ``pack_codes``.

Inputs come from numpy seeds and reach both packages as the same arrays.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lut import LUTPlan as JPlan
from repro.core.lut import pack_codes as jpack_codes
from repro.core.quantize import FixedPointFormat as JFixed
from repro.core.quantize import Float16Format as JF16
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTGroup, convert_params
from repro_torch.core.lut import LUTPlan, pack_codes
from repro_torch.core.planner import plan_model
from repro_torch.core.quantize import FixedPointFormat, Float16Format
from repro_torch.kernels.bitplane_pack import ops
from repro_torch.models import layers, moe
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.models.transformer import layer_params

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
SERVING = dict(
    max_chunk=2,
    modes=("bitplane", "bitplane_shift"),
    radices=(1, 2, 4),
    table_formats=(None, "i8"),
)

# fp16 rounding's edges, as fp32: +-0; the smallest subnormal and its
# negative; 2**-25 (a tie, to 0) and 3 * 2**-26 (up to 2**-24); 2**-26
# (to 0); the largest subnormal and the smallest normal; RNE ties at 1
# (1 + 2**-11 to 1, 1 + 3 * 2**-11 up to 1 + 2**-9); 65504 and a value
# just under the overflow tie; 65520 (the tie, to inf); 1e6; +-inf
EDGES = [
    0.0, -0.0, 2.0**-24, -(2.0**-24), 2.0**-25, 3 * 2.0**-26, 2.0**-26,
    2.0**-14 - 2.0**-24, 2.0**-14, 1 + 2.0**-11, 1 + 3 * 2.0**-11, -(1 + 2.0**-11),
    65504.0, -65504.0, 65519.996, 65520.0, -65520.0, 1e6, -1e6,
    math.inf, -math.inf, 0.1, -3.0, 6.0e-8,
]


def _input(x32: np.ndarray, dtype: str):
    """The same values for both packages: fp32 as given, or rounded once to
    bf16 by torch and handed to JAX as its exact fp32 widening."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(x32).to(tdt)
    return t, jnp.asarray(t.to(torch.float32).numpy()).astype(jdt), t.to(torch.float32).numpy()


def _bf16(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).item())


def kernel_mirror(x32, *, kind, m, bits=16, frac=0, signed=False, radix=1, bf16=False):
    """The CUDA kernel's arithmetic in numpy, element by element: ``x32``
    (B, q) holds the input's exact fp32 values (a bf16 input widened)."""
    B, q = x32.shape
    k = -(-q // m)
    xp = np.zeros((B, k * m), np.float32)
    xp[:, :q] = x32
    if kind == "fixed":
        lo, hi = (-(2 ** (bits - 1)), 2 ** (bits - 1) - 1) if signed else (0, 2**bits - 1)
        if bf16:  # clip bounds rounded to bf16, as torch.clamp of a bf16 tensor does
            lo, hi = _bf16(lo), _bf16(hi)
        c = np.clip(np.rint(xp * np.float32(2.0**frac)), lo, hi).astype(np.int64)
        u = np.where(c < 0, c + 2**bits, c)
        fields, width = [(u >> j) & 1 for j in range(bits)], 1
    else:
        h = xp if (kind == "shift" and signed) else np.maximum(xp, 0) + np.float32(0)
        with np.errstate(over="ignore"):  # overflow to inf is the contract
            u = h.astype(np.float16).view(np.uint16).astype(np.int64)
        e = (u >> 10) & 31
        man = (u & 1023) | ((e > 0).astype(np.int64) << 10)
        if kind == "float16":
            fields, width = [(((man >> j) & 1) << 5) | e for j in range(11)], 6
        else:
            sign = (u >> 15) << radix if signed else 0
            ib = radix + int(signed)
            fields = [((man >> (radix * j)) & (2**radix - 1)) | sign | (e << ib)
                      for j in range(-(-11 // radix))]
            width = 0
    planes = np.stack(fields, 1).reshape(B, len(fields), k, m)
    return sum(planes[..., i] << (width * i) for i in range(m)).astype(np.int32)


def _jplan(q, kind, m, bits=16, frac=0, signed=False, radix=1):
    if kind == "shift":
        return JPlan(q, 1, 1, JF16(signed=signed, mantissa_radix=radix), mode="bitplane_shift")
    fmt = JF16() if kind == "float16" else JFixed(bits, frac, signed)
    return JPlan(q, 1, m, fmt, mode="bitplane")


# ---------------------------------------------------------------------------
# the shift kind against the JAX package's pack_codes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("radix", [1, 2, 4, 11])
def test_shift_kind_matches_reference_pack_codes(radix, signed, dtype):
    rng = np.random.default_rng(radix * 10 + signed)
    # magnitudes from fp16 subnormals to overflow, both signs, ragged q
    x = rng.standard_normal((2, 3, 37)) * 2.0 ** rng.integers(-26, 18, (2, 3, 37))
    t, j, x32 = _input(x.astype(np.float32), dtype)
    plan = LUTPlan(37, 5, 1, Float16Format(signed, radix), mode="bitplane_shift")
    want = np.asarray(jpack_codes(j, _jplan(37, "shift", 1, signed=signed, radix=radix)))
    got = ops.bitplane_pack(t, kind="shift", m=1, signed=signed, radix=radix)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 3, plan.num_planes, 37)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.pack(t, plan).numpy(), want)
    mirror = kernel_mirror(x32.reshape(6, 37), kind="shift", m=1, signed=signed, radix=radix)
    np.testing.assert_array_equal(mirror.reshape(want.shape), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("radix", [1, 4, 11])
def test_shift_kind_edge_values(radix, signed, dtype):
    t, j, x32 = _input(np.asarray([EDGES], np.float32), dtype)
    q = len(EDGES)
    want = np.asarray(jpack_codes(j, _jplan(q, "shift", 1, signed=signed, radix=radix)))
    got = ops.bitplane_pack(t, kind="shift", m=1, signed=signed, radix=radix).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        kernel_mirror(x32, kind="shift", m=1, signed=signed, radix=radix), want
    )
    ib = radix + int(signed)
    e = got[0, 0] >> ib
    if dtype == "f32":
        assert e[EDGES.index(65520.0)] == 31 and e[EDGES.index(math.inf)] == 31  # inf
        assert e[EDGES.index(65504.0)] == 30
        assert (got[0, :, EDGES.index(2.0**-26)] & ((1 << ib) - 1) == 0).all()  # to 0
    sub = EDGES.index(2.0**-24)
    assert e[sub] == 0 and got[0, 0, sub] & (2**radix - 1) == 1  # subnormal: e 0, man 1
    if signed:
        assert got[0, 0, 1] == 1 << radix  # EDGES[1] = -0: its sign survives
    else:
        assert (got[0, :, EDGES.index(-3.0)] == 0).all()  # negatives clamp to +0


# ---------------------------------------------------------------------------
# the kernel's arithmetic for every kind (mirror) against both packages
# ---------------------------------------------------------------------------

MIRROR_CASES = [
    dict(kind="fixed", m=1, bits=8, frac=6, signed=True),
    dict(kind="fixed", m=3, bits=4, frac=2, signed=False),
    dict(kind="fixed", m=2, bits=12, frac=3, signed=True),  # bf16 clip bound 2047 -> 2048
    dict(kind="fixed", m=1, bits=24, frac=0, signed=False),
    dict(kind="float16", m=1),
    dict(kind="float16", m=4),
    dict(kind="shift", m=1, signed=True, radix=4),
    dict(kind="shift", m=1, signed=False, radix=2),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kw", MIRROR_CASES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_kernel_mirror_matches_both_packages(kw, dtype):
    rng = np.random.default_rng(len(str(kw)))
    x = rng.standard_normal((5, 43)) * 2.0 ** rng.integers(-8, 14, (5, 43))
    x[0, : len(EDGES)] = EDGES[:43]
    x[1, :4] = [0.5, 1.5, -2.5, 3e7]  # rounding ties and saturation after the scale
    x[1, :4] /= 2.0 ** kw.get("frac", 0)
    t, j, x32 = _input(x.astype(np.float32), dtype)
    want = np.asarray(jpack_codes(j, _jplan(43, **kw)))
    np.testing.assert_array_equal(ops.bitplane_pack(t, **kw).numpy(), want)
    np.testing.assert_array_equal(kernel_mirror(x32, bf16=dtype == "bf16", **kw), want)


# ---------------------------------------------------------------------------
# kernel_args and pack over every plan kind and mode
# ---------------------------------------------------------------------------

PLANS = {
    "fixed-c1": (LUTPlan(30, 7, 1, FixedPointFormat(8, 6, True)), "fixed"),
    "fixed-c3-unsigned": (LUTPlan(30, 7, 3, FixedPointFormat(5, 2, False)), "fixed"),
    "fixed-full": (LUTPlan(30, 7, 2, FixedPointFormat(4, 1, True), mode="full"), None),
    "f16-c1": (LUTPlan(30, 7, 1, Float16Format()), "float16"),
    "f16-c4": (LUTPlan(30, 7, 4, Float16Format()), "float16"),
    "f16-signed": (LUTPlan(30, 7, 1, Float16Format(signed=True)), None),
    "f16-radix2": (LUTPlan(30, 7, 2, Float16Format(mantissa_radix=2)), None),
    "f16-full": (LUTPlan(30, 7, 1, Float16Format(), mode="full"), None),
    "shift-r4-signed": (
        LUTPlan(30, 7, 1, Float16Format(True, 4), mode="bitplane_shift", table_format="i8"),
        "shift",
    ),
    "shift-r1": (LUTPlan(30, 7, 1, Float16Format(False, 1), mode="bitplane_shift"), "shift"),
    "shift-r11-signed": (
        LUTPlan(30, 7, 1, Float16Format(True, 11), mode="bitplane_shift"), "shift"
    ),
}


# ---------------------------------------------------------------------------
# the plan-taking entry refuses bf16 input where bf16 cannot hold the bounds
# ---------------------------------------------------------------------------

BF16_INEXACT = [FixedPointFormat(12, 3, True), FixedPointFormat(10, 0, True),
                FixedPointFormat(9, 4, False), FixedPointFormat(16, 8, False)]


@pytest.mark.parametrize("mode", ["bitplane", "full"])
@pytest.mark.parametrize("fmt", BF16_INEXACT, ids=str)
def test_pack_refuses_bf16_on_a_fixed_plan_with_inexact_bounds(fmt, mode):
    plan = LUTPlan(30, 7, 1, fmt, mode=mode)
    x = torch.full((2, 30), 1e6, dtype=torch.bfloat16)
    packs, plain = ops.LAUNCHES["bitplane_pack"], ops.PLAIN_CALLS["pack_codes"]
    with pytest.raises(ValueError, match="not exact in bf16"):
        ops.pack(x, plan)
    assert (ops.LAUNCHES["bitplane_pack"], ops.PLAIN_CALLS["pack_codes"]) == (packs, plain)
    # the same input in fp32 packs, saturating at the true bounds
    x32 = x.to(torch.float32)
    np.testing.assert_array_equal(ops.pack(x32, plan).numpy(), pack_codes(x32, plan).numpy())


def test_pack_still_takes_bf16_on_the_binary_modes_plan_and_fp32_everywhere():
    """8/6 signed (bounds -128 and 127, exact in bf16) packs bf16 input
    bit for bit with ``pack_codes``; every plan of :data:`PLANS` and the
    inexact-bound formats pack fp32 input, and every fp16 plan bf16."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-3, 3, (4, 30)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    plan86 = LUTPlan(30, 7, 1, FixedPointFormat(8, 6, True))
    np.testing.assert_array_equal(ops.pack(xb, plan86).numpy(), pack_codes(xb, plan86).numpy())
    plans = [plan for plan, _ in PLANS.values()]
    plans += [LUTPlan(30, 7, 1, fmt) for fmt in BF16_INEXACT]
    for plan in plans:
        np.testing.assert_array_equal(ops.pack(x, plan).numpy(), pack_codes(x, plan).numpy())
        if isinstance(plan.fmt, Float16Format):
            np.testing.assert_array_equal(
                ops.pack(xb, plan).numpy(), pack_codes(xb, plan).numpy()
            )


@pytest.mark.parametrize("name", list(PLANS))
def test_kernel_args_cover_the_kernels_plans(name):
    plan, kind = PLANS[name]
    args = ops.kernel_args(plan)
    x = torch.from_numpy(
        np.random.default_rng(1).uniform(-3, 3, (4, 30)).astype(np.float32)
    )
    want = pack_codes(x, plan)
    plain, launches = ops.PLAIN_CALLS["pack_codes"], ops.LAUNCHES["bitplane_pack"]
    got = ops.pack(x, plan)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert ops.LAUNCHES["bitplane_pack"] == launches  # a CPU tensor never launches
    if kind is None:
        assert args is None
        assert ops.PLAIN_CALLS["pack_codes"] == plain + 1
        return
    assert ops.PLAIN_CALLS["pack_codes"] == plain
    assert args["kind"] == kind and args["m"] == plan.chunk_size
    np.testing.assert_array_equal(ops.bitplane_pack(x, **args).numpy(), want.numpy())
    fmt = plan.fmt
    if kind == "fixed":
        assert (args["bits"], args["frac"], args["signed"]) == (
            fmt.total_bits, fmt.frac_bits, fmt.signed
        )
    if kind == "shift":
        assert (args["radix"], args["signed"]) == (fmt.mantissa_radix, fmt.signed)


def test_pack_checks_the_width_and_bitplane_pack_its_arguments():
    x = torch.zeros(2, 30)
    with pytest.raises(ValueError):
        ops.pack(x, LUTPlan(31, 7, 1, Float16Format(), mode="bitplane_shift"))
    with pytest.raises(ValueError):
        ops.bitplane_pack(x, kind="shift", m=2)  # bitplane_shift is chunk 1 only
    with pytest.raises(ValueError):
        ops.bitplane_pack(x, kind="shift", m=1, radix=12)
    with pytest.raises(ValueError):
        ops.bitplane_pack(x, kind="half", m=1)


@pytest.mark.parametrize(
    "q,m,ptr,itemsize,vec",
    [
        (4096, 1, 1 << 20, 4, True),
        (4096, 1, (1 << 20) + 4, 4, False),  # a base one fp32 element off
        (4096, 1, (1 << 20) + 8, 2, True),  # bf16: 8-byte groups
        (4096, 1, (1 << 20) + 2, 2, False),
        (4098, 1, 1 << 20, 4, False),  # q % 4 != 0
        (4096, 2, 1 << 20, 4, False),  # chunk 2: one thread per chunk
    ],
)
def test_vectorized_path_rule(q, m, ptr, itemsize, vec):
    assert ops.vectorized(q, m, ptr, itemsize) is vec


# ---------------------------------------------------------------------------
# the model's pack sites go through ops.pack
# ---------------------------------------------------------------------------


def numpy_params(specs, seed: int):
    """A PSpec tree as numpy arrays from a seed, with the reference's init
    scales."""
    rng = np.random.default_rng(seed)

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        std = 0.02 if s.init == "embed" else 1.0 / math.sqrt(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return walk(specs)


def _served_tree(name: str):
    """Reduced ``name`` planned by the serving recipe (every layer
    bitplane_shift) and converted."""
    cfg = get_config(name, reduced=True)
    experts = name == "qwen2_moe_a2_7b"
    params = params_from_numpy(numpy_params(model_specs(cfg), 5), device="cpu")
    uniform = plan_model(params, float("inf"), max_chunk=2, convert_experts=experts)
    mplan = plan_model(params, uniform.total_lut_bytes // 2, convert_experts=experts,
                       **SERVING)
    assert {p.mode for p in mplan.layers.values()} == {"bitplane_shift"}
    lut, _ = convert_params(params, plan=mplan, convert_experts=experts)
    return cfg, lut


@pytest.fixture(scope="module")
def granite():
    return _served_tree("granite_8b")


@pytest.fixture(scope="module")
def qwen():
    return _served_tree("qwen2_moe_a2_7b")


class PackSpy:
    """Counts the calls of ``pack`` in ``layers`` and ``moe``; with
    ``plain`` it packs by ``pack_codes`` instead, as the sites did before."""

    def __init__(self, monkeypatch, plain: bool = False):
        self.calls = {"layers": 0, "moe": 0}
        for mod, key in ((layers, "layers"), (moe, "moe")):
            monkeypatch.setattr(mod, "pack", self._spy(key, plain))

    def _spy(self, key, plain):
        def spy(x, plan, use_kernels=True):
            self.calls[key] += 1
            return pack_codes(x, plan) if plain else ops.pack(x, plan, use_kernels)

        return spy


def _x(cfg, shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32))


def _sites(granite, qwen):
    """Each pack site, driven once: name -> (call, packs through layers,
    packs through moe)."""
    cfg, lut = granite
    attn = layer_params(lut["blocks"], 0)["attn"]
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    x = _x(cfg, (3,), 0)
    group = next(v for v in attn.values() if isinstance(v, LUTGroup))
    qcfg, qlut = qwen
    ffn = layer_params(qlut["blocks"], 0)["ffn"]
    qctx = Ctx(qcfg, ex=ExecCfg(lut_grouped=True))
    xq = _x(qcfg, (2, 3), 1)
    return {
        "lut_apply": (lambda: layers.linear(attn["wo"], x, ctx), 1, 0),
        "group_apply": (lambda: layers._group_apply(group, list(group.members), x, ctx)[
            group.members[0]], 1, 0),
        "fused_linears": (lambda: torch.cat(
            layers.fused_linears(attn, ("wq", "wk", "wv"), x, ctx), -1),
            1 + ("wq" not in group.members), 0),
        # routed experts: gate+up gathered from one pack per token, then
        # w_down on the expert-sorted rows; the shared expert's gated MLP
        "moe_sorted_codes": (lambda: moe.moe_ffn(ffn, xq, qctx)[0], 2, 2),
    }


@pytest.mark.parametrize("site", ["lut_apply", "group_apply", "fused_linears",
                                  "moe_sorted_codes"])
def test_pack_sites_go_through_the_kernel_wrapper(granite, qwen, site, monkeypatch):
    call, n_layers, n_moe = _sites(granite, qwen)[site]
    with monkeypatch.context() as mp:
        plain = PackSpy(mp, plain=True)
        want = call()
    spy = PackSpy(monkeypatch)
    launches, uncovered = ops.LAUNCHES["bitplane_pack"], ops.PLAIN_CALLS["pack_codes"]
    got = call()
    assert spy.calls == plain.calls == {"layers": n_layers, "moe": n_moe}
    assert ops.LAUNCHES["bitplane_pack"] == launches  # no launch on the CPU
    assert ops.PLAIN_CALLS["pack_codes"] == uncovered  # every served plan is covered
    assert torch.equal(got, want)


@pytest.mark.parametrize("model", ["granite", "qwen"])
def test_forward_packs_once_per_pack_site(granite, qwen, model, monkeypatch):
    """One pack per lone projection and per group (granite: wq, wk+wv, wo,
    w_gate+w_up, w_down; qwen: the attention group, wo, the routed gate+up
    and w_down, the shared gate+up and w_down, and lm_head), as before."""
    cfg, lut = granite if model == "granite" else qwen
    per_layer, extra = (5, 0) if model == "granite" else (6, 1)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    spy = PackSpy(monkeypatch)
    with torch.no_grad():
        model_forward(lut, {"tokens": torch.from_numpy(tokens)},
                      Ctx(cfg, ex=ExecCfg(lut_grouped=True)))
    assert sum(spy.calls.values()) == per_layer * cfg.num_layers + extra
