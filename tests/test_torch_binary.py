"""The port's binary-matmul mode against the JAX package's, piece by piece:
the packing kernel's plain version against the reference's Pallas
``bitplane_pack`` (interpret mode) bit for bit, the binary matmul's plain
version against the reference's Pallas kernel (interpret mode) and its
oracle, the binary path against the chunk-1 LUT path on integer weights,
and ``linear`` under ``linear_mode="binary_matmul"`` on dense, biased and
converted layers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import ModelPlan as JModelPlan
from repro.core.planner import plan_model as jplan_model
from repro.kernels.binary_matmul.ops import binary_matmul as jbinary_matmul
from repro.kernels.binary_matmul.ref import binary_matmul_ref as jbinary_matmul_ref
from repro.kernels.bitplane_pack.ops import bitplane_pack as jbitplane_pack
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.models.layers import linear as jlinear
from repro.models.layers import mlp as jmlp
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTLinear
from repro_torch.core.lut import LUTPlan, build_luts, pack_codes, plane_scales
from repro_torch.core.planner import ModelPlan
from repro_torch.core.quantize import FixedPointFormat
from repro_torch.kernels.binary_matmul import ops as bmm_ops
from repro_torch.kernels.binary_matmul.ops import binary_matmul
from repro_torch.kernels.bitplane_pack import ops as pack_ops
from repro_torch.kernels.bitplane_pack.ops import bitplane_pack
from repro_torch.kernels.lut_affine.ops import lut_affine
from repro_torch.models.layers import Ctx, ExecCfg, linear, mlp
from repro_torch.models.params import params_from_numpy

# fp32 sums of exact bit x bf16 products, taken in another order (the
# reference's own test holds its kernel to its oracle at the same)
BMM_TOL = 1e-5
# a layer's output sums in another order than XLA's (~1e-7 relative) and,
# under binary_matmul, its inputs are quantized to the same 8/6 codes
LINEAR_TOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# bitplane_pack
# ---------------------------------------------------------------------------


# (B, q, m, bits, frac, signed): every bits 2..8, frac 0..4, both signs,
# m 1..4, ragged q (zero-padded tails) and the binary path's 8/6 signed m=1
PACK_FIXED = [
    (1, 1, 1, 2, 0, False),
    (3, 37, 2, 3, 1, True),
    (5, 70, 3, 4, 2, False),
    (2, 33, 4, 5, 3, True),
    (9, 64, 1, 6, 4, False),
    (4, 50, 3, 7, 0, True),
    (6, 300, 1, 8, 6, True),
    (7, 45, 4, 8, 4, False),
]


@pytest.mark.parametrize("B,q,m,bits,frac,signed", PACK_FIXED)
def test_pack_fixed_matches_reference(B, q, m, bits, frac, signed):
    rng = np.random.default_rng(B * q + m)
    x = rng.uniform(-4.0, 4.0, (B, q)).astype(np.float32)
    # exact rounding ties: half-to-even must agree
    x[0, : min(q, 4)] = np.array([0.5, 1.5, -0.5, -2.5], np.float32)[: min(q, 4)] / 2**frac
    kw = dict(kind="fixed", bits=bits, frac=frac, signed=signed, m=m)
    want = np.asarray(jbitplane_pack(jnp.asarray(x), interpret=True, **kw))
    got = bitplane_pack(_t(x), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,q,m", [(1, 1, 1), (5, 33, 2), (8, 130, 4), (130, 16, 1)])
def test_pack_float16_matches_reference(B, q, m):
    rng = np.random.default_rng(q)
    x = rng.uniform(0.0, 100.0, (B, q)) * (rng.uniform(size=(B, q)) > 0.1)
    x[0, 0] = -3.0  # negative inputs clamp to 0
    x = x.astype(np.float32)
    kw = dict(kind="float16", bits=16, frac=0, signed=False, m=m)
    want = np.asarray(jbitplane_pack(jnp.asarray(x), interpret=True, **kw))
    np.testing.assert_array_equal(bitplane_pack(_t(x), **kw).numpy(), want)


def test_pack_float16_subnormals():
    x = np.asarray([[5.96e-8, 1.2e-7, 6.0e-5, 0.0]], np.float32)
    kw = dict(kind="float16", bits=16, frac=0, signed=False, m=2)
    want = np.asarray(jbitplane_pack(jnp.asarray(x), interpret=True, **kw))
    got = bitplane_pack(_t(x), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, :, 0] & 31).max() == 0  # both halves subnormal: exponent 0


def test_pack_keeps_leading_dims_and_counts_no_cpu_launch():
    x = np.random.default_rng(0).uniform(-2, 2, (2, 3, 21)).astype(np.float32)
    before = pack_ops.LAUNCHES["bitplane_pack"]
    got = bitplane_pack(_t(x), kind="fixed", m=1, bits=8, frac=6, signed=True)
    assert tuple(got.shape) == (2, 3, 8, 21)
    assert pack_ops.LAUNCHES["bitplane_pack"] == before
    plan = LUTPlan(21, 1, 1, FixedPointFormat(8, 6, signed=True), mode="bitplane")
    np.testing.assert_array_equal(got.numpy(), pack_codes(_t(x), plan).numpy())


# ---------------------------------------------------------------------------
# binary_matmul
# ---------------------------------------------------------------------------


def _bmm_case(B, n, q, p, seed):
    rng = np.random.default_rng(seed)
    planes = (rng.uniform(size=(B, n, q)) < 0.5).astype(np.int8)
    W = (rng.standard_normal((q, p)) / np.sqrt(q)).astype(np.float32)
    scales = (0.5 ** np.arange(n)).astype(np.float32)
    return planes, W, scales


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "B,n,q,p", [(1, 1, 1, 1), (4, 8, 100, 30), (65, 11, 300, 140), (2, 16, 513, 257)]
)
def test_binary_matmul_matches_reference(B, n, q, p, dtype):
    planes, W, scales = _bmm_case(B, n, q, p, n * q)
    jW = jnp.asarray(W) if dtype == "f32" else jnp.asarray(W).astype(jnp.bfloat16)
    tW = _t(W) if dtype == "f32" else _t(W).to(torch.bfloat16)  # both round to even
    want = np.asarray(jbinary_matmul(jnp.asarray(planes), jW, jnp.asarray(scales),
                                     interpret=True))
    oracle = np.asarray(jbinary_matmul_ref(jnp.asarray(planes), jW, jnp.asarray(scales)))
    got = binary_matmul(_t(planes), tW, scales)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, p)
    for ref in (want, oracle):
        np.testing.assert_allclose(got.numpy(), ref, rtol=BMM_TOL, atol=BMM_TOL)


def test_binary_matmul_leading_dims_bias_and_int32_planes():
    planes, W, scales = _bmm_case(6, 8, 70, 19, 5)
    bias = np.random.default_rng(6).standard_normal(19).astype(np.float32)
    scales[-1] = -scales[-1]  # the signed MSB plane
    want = np.asarray(jbinary_matmul(jnp.asarray(planes.reshape(2, 3, 8, 70)), jnp.asarray(W),
                                     jnp.asarray(scales), jnp.asarray(bias), interpret=True))
    before = bmm_ops.LAUNCHES["binary_matmul"]
    for dtype in (torch.int8, torch.int32):
        got = binary_matmul(_t(planes).to(dtype).reshape(2, 3, 8, 70), _t(W), scales,
                            bias=_t(bias))
        assert tuple(got.shape) == (2, 3, 19)
        np.testing.assert_allclose(got.numpy(), want, rtol=BMM_TOL, atol=BMM_TOL)
    assert bmm_ops.LAUNCHES["binary_matmul"] == before  # CPU: the plain version


def test_kernel_tile_and_split_rules():
    """The wrapper's pure launch decisions: the decode tile up to 64 folded
    rows, one wave of blocks at decode (the granite_8b decode shapes), no
    split once the output tiles fill the card, never more ranges than
    64-deep steps."""
    assert bmm_ops.tile(4, 8) == bmm_ops.tile(8, 8) == bmm_ops.DECODE_TILE
    assert bmm_ops.tile(9, 8) == bmm_ops.tile(65, 1) == bmm_ops.PREFILL_TILE
    decode = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
    assert [bmm_ops.k_splits(4, 8, q, p, 132) for q, p in decode] == [8, 16, 2, 8]
    assert bmm_ops.k_splits(128, 8, 4096, 14336, 132) == 1
    assert bmm_ops.k_splits(4, 8, 100, 30, 132) == 2  # two 64-deep steps
    assert bmm_ops.k_splits(1, 1, 1, 1, 132) == 1


@pytest.mark.parametrize(
    "dtype,p,offset,copied",
    [
        (torch.bfloat16, 64, 0, False),  # the serve path's W: taken as it is
        (torch.float32, 64, 0, True),  # rounded once to bf16
        (torch.bfloat16, 30, 0, True),  # p % 8 != 0: padded to 32
        (torch.bfloat16, 64, 3, True),  # base 6 bytes past alignment
    ],
)
def test_w_operand_gives_the_tensor_map_an_aligned_bf16_w(dtype, p, offset, copied):
    q = 5
    W = torch.from_numpy(np.random.default_rng(p + offset).standard_normal((q, p)).astype(np.float32))
    if offset:
        buf = torch.zeros(q * p + 8, dtype=dtype)
        start = next(i for i in range(8) if (buf.data_ptr() + 2 * i) % 16 == 2 * offset)
        view = buf[start: start + q * p].view(q, p)
        view.copy_(W.to(dtype))
        W = view
    else:
        W = W.to(dtype)
    Wk = bmm_ops.w_operand(W)
    assert (Wk is not W) == copied
    assert Wk.dtype == torch.bfloat16 and Wk.is_contiguous()
    assert Wk.data_ptr() % 16 == 0 and Wk.shape[1] % 8 == 0
    assert Wk.shape == (q, -(-p // 8) * 8)
    assert torch.equal(Wk[:, :p], W.to(torch.bfloat16))
    assert not Wk[:, p:].any()


@pytest.mark.parametrize(
    "dtype,q,offset,copied",
    [
        (torch.int32, 8, 0, False),  # bitplane_pack's output: taken as it is
        (torch.int8, 8, 0, True),  # cast once to int32
        (torch.int32, 7, 0, True),  # q % 4 != 0: depth padded to 8
        (torch.int32, 8, 2, True),  # base 8 bytes past alignment
    ],
)
def test_planes_operand_gives_the_tensor_map_aligned_int32_planes(dtype, q, offset, copied):
    B, n = 3, 5
    planes = torch.from_numpy(
        (np.random.default_rng(q + offset).uniform(size=(B, n, q)) < 0.5).astype(np.int32))
    if offset:
        buf = torch.zeros(B * n * q + 4, dtype=dtype)
        start = next(i for i in range(4) if (buf.data_ptr() + 4 * i) % 16 == 4 * offset)
        view = buf[start: start + B * n * q].view(B, n, q)
        view.copy_(planes)
        planes = view
    else:
        planes = planes.to(dtype)
    Ak = bmm_ops.planes_operand(planes)
    assert (Ak is not planes) == copied
    assert Ak.dtype == torch.int32 and Ak.is_contiguous()
    assert Ak.data_ptr() % 16 == 0 and Ak.shape == (B, n, -(-q // 4) * 4)
    assert torch.equal(Ak[..., :q], planes.to(torch.int32))
    assert not Ak[..., q:].any()
    # W's rows padded to the planes' depth: the product is unchanged
    W = torch.from_numpy(np.random.default_rng(1).standard_normal((q, 12)).astype(np.float32))
    Wk = bmm_ops.w_operand(W, Ak.shape[2])
    assert Wk.shape == (Ak.shape[2], 16) and not Wk[q:].any() and not Wk[:, 12:].any()
    assert torch.equal(Wk[:q, :12], W.to(torch.bfloat16))
    scales = 2.0 ** -np.arange(n)
    got = bmm_ops.binary_matmul(Ak, Wk, scales)[:, :12]
    assert torch.equal(got, bmm_ops.binary_matmul(planes, W, scales))
    with pytest.raises(ValueError, match="rows"):
        bmm_ops.w_operand(W, q - 1)


def test_binary_matmul_refuses_non_power_of_two_scales():
    planes, W, _ = _bmm_case(2, 3, 8, 4, 0)
    with pytest.raises(ValueError, match="not \\+-2\\*\\*e"):
        binary_matmul(_t(planes), _t(W), [1.0, 0.5, 0.3])
    with pytest.raises(ValueError, match="scales for"):
        binary_matmul(_t(planes), _t(W), [1.0, 0.5])


def test_binary_matmul_equals_lut_path():
    """The binary path computes the chunk-1 LUT path's function: with
    integer weights both are exact, so they agree bit for bit (the port's
    version of the reference's test)."""
    fmt = FixedPointFormat(5, 3, signed=True)
    q, p = 40, 17
    plan = LUTPlan(q, p, 1, fmt)
    rng = np.random.default_rng(11)
    W = _t(rng.integers(-8, 8, (q, p)).astype(np.float32))
    x = _t(rng.uniform(-2.0, 2.0, (6, q)).astype(np.float32))
    codes = pack_codes(x, plan)  # (6, n, q): at m = 1 a code is one bit
    np.testing.assert_array_equal(
        bitplane_pack(x, kind="fixed", m=1, bits=5, frac=3, signed=True).numpy(),
        codes.numpy(),
    )
    scales = plane_scales(plan)
    via_bmm = binary_matmul(codes.to(torch.int8), W, scales)
    via_lut = lut_affine(codes, build_luts(W, plan), scales)
    np.testing.assert_array_equal(via_bmm.numpy(), via_lut.numpy())


# ---------------------------------------------------------------------------
# linear under binary_matmul
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    """Reduced granite_8b weights and a JAX conversion of its attention
    projections only (the MLP stays dense), crossed to the port."""
    jcfg = jget_config("granite_8b", reduced=True)
    jp = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(21))
    jm = jplan_model(jp, float("inf"), max_chunk=1)
    keep = {k: v for k, v in jm.layers.items() if "/attn/" in k}
    jm = JModelPlan(
        keep, groups=tuple(g for g in jm.groups if all(k in keep for k in g)),
        copies={k: v for k, v in jm.copies.items() if k in keep},
    )
    jlut, _ = jconvert(jp, plan=jm)
    tlut = params_from_numpy(
        jax.tree.map(np.asarray, jlut), device="cpu", plan=ModelPlan.from_json(jm.to_json())
    )
    return jcfg, jlut, tlut


def _ctxs(jcfg, **kw):
    return (
        JCtx(jcfg, ex=JExecCfg(remat="none", linear_mode="binary_matmul", use_pallas=True, **kw)),
        Ctx(get_config("granite_8b", reduced=True), ex=ExecCfg(linear_mode="binary_matmul", **kw)),
    )


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=LINEAR_TOL * float(np.abs(want).max())
    )


@pytest.mark.parametrize("bias", [False, True])
def test_linear_dense_matches_reference(bias):
    rng = np.random.default_rng(30 + bias)
    W = (rng.standard_normal((64, 48)) / 8).astype(np.float32)
    x = rng.uniform(-2.5, 2.5, (2, 5, 64)).astype(np.float32)  # past the 8/6 range too
    jp, tp = {"w": jnp.asarray(W)}, {"w": _t(W)}
    if bias:
        b = rng.standard_normal(48).astype(np.float32)
        jp["b"], tp["b"] = jnp.asarray(b), _t(b)
    jctx, ctx = _ctxs(jget_config("granite_8b", reduced=True))
    want = jlinear(jp, jnp.asarray(x), jctx)
    got = linear(tp, _t(x), ctx)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 5, 48)
    _close(got, want)
    # the binary path is not the standard one: 8/6 fixed-point inputs
    assert not torch.allclose(got, linear(tp, _t(x), Ctx(ctx.cfg)), atol=1e-3)


def test_linear_converted_layer_takes_its_lut_path(mixed):
    jcfg, jlut, tlut = mixed
    jnode = jax.tree.map(lambda a: a[0], jlut["blocks"]["attn"]["wq"])
    tnode = tlut["blocks"]["attn"]["wq"].layer(0)
    assert isinstance(tnode, LUTLinear)
    x = np.random.default_rng(31).standard_normal((2, 3, 64)).astype(np.float32)
    jctx, ctx = _ctxs(jcfg)
    want = jlinear(jnode, jnp.asarray(x), jctx)
    got = linear(tnode, _t(x), ctx)
    _close(got, want)
    # and it is the LUT path, not the binary one
    _close(got, jlinear(jnode, jnp.asarray(x), JCtx(jcfg, ex=JExecCfg(remat="none"))))


@pytest.mark.parametrize("grouped", [False, True])
def test_mlp_on_a_mixed_tree_matches_reference(mixed, grouped):
    """A dense MLP under the binary mode inside a tree whose attention is
    converted: each dense sibling packs its own input, as in the
    reference."""
    jcfg, jlut, tlut = mixed
    jp = jax.tree.map(lambda a: a[1], jlut["blocks"]["ffn"])
    tp = {k: {kk: vv[1] for kk, vv in v.items()} for k, v in tlut["blocks"]["ffn"].items()}
    x = np.random.default_rng(32).standard_normal((2, 4, 64)).astype(np.float32)
    jctx, ctx = _ctxs(jcfg, lut_grouped=grouped)
    before = pack_ops.LAUNCHES["bitplane_pack"]
    _close(mlp(tp, _t(x), ctx), jmlp(jp, jnp.asarray(x), jctx))
    assert pack_ops.LAUNCHES["bitplane_pack"] == before


def test_modes_standard_lut_gather_same_and_onehot_raises():
    W = np.random.default_rng(40).standard_normal((16, 8)).astype(np.float32)
    x = np.random.default_rng(41).standard_normal((3, 16)).astype(np.float32)
    cfg = get_config("granite_8b", reduced=True)
    a = linear({"w": _t(W)}, _t(x), Ctx(cfg, ex=ExecCfg(linear_mode="standard")))
    b = linear({"w": _t(W)}, _t(x), Ctx(cfg, ex=ExecCfg(linear_mode="lut_gather")))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ExecCfg(linear_mode="onehot_mxu")
    with pytest.raises(ValueError, match="unknown linear_mode"):
        ExecCfg(linear_mode="binary")
