"""The port's MoE family against the JAX package's, piece by piece, on
reduced ``qwen2_moe_a2_7b``: the plain ragged expert LUT op (against the
reference's jnp oracle, and its Pallas kernel in interpret mode), the
router, the serving recipe's plan with ``convert_experts=True``, the
converted expert tables and their one-scale-per-layer rule, and
``moe_ffn`` on dense, LUT (chunk 1 and planned), mixed and TL1-planned
expert trees.  Weights and inputs come from numpy seeds and reach both
packages as the same arrays."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.convert import LUTGroup as JGroup
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.kernels.lut_affine import ops as jops
from repro.kernels.lut_affine import ref as jref
from repro.models import moe as jmoe
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.models.model import model_forward as jmodel_forward
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTGroup, LUTLinear, convert_params
from repro_torch.core.lut_tl1 import TL1Plan, quantize_acts
from repro_torch.core.planner import plan_model
from repro_torch.kernels.lut_affine import ops
from repro_torch.kernels.lut_affine.ref import expert_of_token, lut_affine_experts_ref
from repro_torch.models import moe
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import PSpec, params_from_numpy
from repro_torch.models.transformer import layer_params

SERVING = dict(
    max_chunk=2,
    modes=("bitplane", "bitplane_shift"),
    radices=(1, 2, 4),
    table_formats=(None, "i8"),
    convert_experts=True,
)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "i8": (jnp.int8, torch.int8), "i16": (jnp.int16, torch.int16)}
# fp32 sums of the same terms in another order
SUM_TOL = 1e-6
# whole moe_ffn: fp32 sums in another order through two LUT layers, a
# softmax and a SwiGLU
FFN_TOL = 1e-5


def numpy_params(specs, seed: int):
    """A PSpec tree as numpy arrays with the reference's init rules; biases
    (zero at init) get small random values so that they are exercised."""
    rng = np.random.default_rng(seed)

    def walk(key, s):
        if isinstance(s, dict):
            return {k: walk(k, v) for k, v in s.items()}
        if s.init == "ones":
            return np.ones(s.shape, np.float32)
        if s.init == "zeros":
            scale = 0.1 if key == "b" else 0.0
            return (rng.standard_normal(s.shape) * scale).astype(np.float32)
        std = 0.02 if s.init == "embed" else 1.0 / math.sqrt(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return walk(None, specs)


def _close(got: torch.Tensor, want, tol: float) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=0, atol=tol * max(1e-30, np.abs(want).max())
    )


# ---------------------------------------------------------------------------
# The plain ragged LUT op
# ---------------------------------------------------------------------------


def _experts_case(seed, E, G, T, n, k, En, p, dtype, shift_bits):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, En, (T, n, k)).astype(np.int32)
    if shift_bits:
        exp = rng.integers(0, 31, (T, 1, k)).astype(np.int32)
        codes = codes + (exp << shift_bits)
    shape = (E, G, k, En, p)
    if dtype in ("i8", "i16"):
        hi = 127 if dtype == "i8" else 32767
        tables = rng.integers(-hi, hi + 1, shape).astype(np.float32)
    else:
        tables = rng.standard_normal(shape).astype(np.float32)
    scales = (2.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    scales[-1] = -scales[-1]
    jd, td = DTYPES[dtype]
    return codes, jnp.asarray(tables).astype(jd), torch.from_numpy(tables).to(td), scales


# E, G, T, n, k, En, p, group sizes
EXPERT_CASES = [
    (4, 2, 11, 3, 7, 32, 10, (3, 0, 6, 2)),  # gate+up, an empty expert, T % 4 != 0
    (3, 3, 9, 2, 5, 32, 33, (0, 9, 0)),  # G = 3, every row on one expert
    (2, 1, 1, 3, 13, 32, 8, (0, 1)),  # w_down, one row
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift_bits", [0, 5])
@pytest.mark.parametrize("case", EXPERT_CASES, ids=["gate_up", "g3_one_expert", "t1"])
def test_plain_experts_matches_reference(dtype, shift_bits, case):
    E, G, T, n, k, En, p, sizes = case
    codes, jt, tt, scales = _experts_case(
        E * 7 + T, E, G, T, n, k, En, p, dtype, shift_bits
    )
    gs = np.asarray(sizes, np.int32)
    want = jref.lut_affine_experts_ref(
        jnp.asarray(codes), jt, jnp.asarray(scales), jnp.asarray(gs), shift_bits
    )
    got = lut_affine_experts_ref(
        torch.from_numpy(codes), tt, torch.from_numpy(scales), torch.from_numpy(gs),
        shift_bits,
    )
    _close(got, want, SUM_TOL)
    # the wrapper's plain version, and token/chunk-sliced gathers, agree
    wrapped = ops.lut_affine_experts(
        torch.from_numpy(codes), tt, scales, torch.from_numpy(gs), shift_bits=shift_bits
    )
    _close(wrapped, want, SUM_TOL)
    sliced = lut_affine_experts_ref(
        torch.from_numpy(codes), tt, torch.from_numpy(scales), torch.from_numpy(gs),
        shift_bits, max_gather_bytes=G * n * 2 * p * 4,
    )
    _close(sliced, want, SUM_TOL)


@pytest.mark.parametrize(
    "dtype,shift_bits,sizes",
    [("i8", 5, (3, 0, 5, 1)), ("f32", 0, (2, 6, 0, 0))],
    ids=["i8_tail", "f32_tail"],
)
def test_plain_experts_matches_pallas_interpret(dtype, shift_bits, sizes):
    """Against the reference's Pallas kernel in interpret mode, whose rows
    past ``sum(group_sizes)`` come out 0, as the port's do."""
    E, G, T, n, k, En, p = 4, 2, 11, 3, 6, 32, 12
    codes, jt, tt, scales = _experts_case(5, E, G, T, n, k, En, p, dtype, shift_bits)
    gs = np.asarray(sizes, np.int32)
    want = jops.lut_affine_experts(
        jnp.asarray(codes), jt, jnp.asarray(scales), jnp.asarray(gs),
        interpret=True, shift_bits=shift_bits,
    )
    got = lut_affine_experts_ref(
        torch.from_numpy(codes), tt, torch.from_numpy(scales), torch.from_numpy(gs),
        shift_bits,
    )
    _close(got, want, SUM_TOL)
    assert not got[:, int(gs.sum()):].any()


def test_expert_of_token_matches_reference():
    gs = np.asarray([3, 0, 2, 0, 4], np.int32)
    want = np.asarray(jref.expert_of_token(jnp.asarray(gs), 12))
    got = expert_of_token(torch.from_numpy(gs), 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_experts_wrapper_checks_shapes():
    codes = torch.zeros((4, 3, 5), dtype=torch.int32)
    tables = torch.zeros((2, 1, 5, 32, 8))
    with pytest.raises(ValueError, match="group_sizes"):
        ops.lut_affine_experts(codes, tables, [1.0] * 3, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="chunks"):
        ops.lut_affine_experts(
            codes[..., :4], tables, [1.0] * 3, torch.zeros(2, dtype=torch.int64)
        )


# ---------------------------------------------------------------------------
# Routing, planning and conversion on reduced qwen2_moe_a2_7b
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    tree = numpy_params(model_specs(cfg), 21)
    jp = _jax_tree(tree)
    tp = params_from_numpy(tree, device="cpu")
    return cfg, jget_config("qwen2_moe_a2_7b", reduced=True), jp, tp


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _layer0_ffn(tree):
    """Layer 0's FFN subtree of a stacked JAX or port parameter tree."""
    ffn = tree["blocks"]["ffn"]
    if isinstance(tree["embed"], torch.Tensor):
        return layer_params(ffn, 0)
    return jax.tree.map(lambda a: a[0], ffn)


def test_route_matches_reference(qwen):
    cfg, jcfg, jp, tp = qwen
    x = np.random.default_rng(3).standard_normal((13, cfg.d_model)).astype(np.float32)
    w = tp["blocks"]["ffn"]["router"][0]
    jw, jidx, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(w.numpy()), jcfg)
    tw, tidx, taux = moe._route(torch.from_numpy(x), w, cfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    sizes = torch.zeros(cfg.num_experts, dtype=torch.int64)
    sizes.scatter_add_(0, tidx.reshape(-1), torch.ones(tidx.numel(), dtype=torch.int64))
    want = np.bincount(np.asarray(jidx).reshape(-1), minlength=cfg.num_experts)
    np.testing.assert_array_equal(sizes.numpy(), want)


def _serving_plan(params, plan_fn):
    kw = dict(SERVING)
    uniform = plan_fn(params, float("inf"), max_chunk=2, convert_experts=True)
    kw.pop("max_chunk")
    return plan_fn(params, uniform.total_lut_bytes // 2, max_chunk=2, **kw)


@pytest.fixture(scope="module")
def planned(qwen):
    cfg, jcfg, jp, tp = qwen
    jm = _serving_plan(jp, jplan_model)
    tm = _serving_plan(tp, plan_model)
    return jm, tm


def test_serving_plan_json_matches_reference(planned):
    jm, tm = planned
    assert json.dumps(tm.to_json(), sort_keys=True) == json.dumps(
        jm.to_json(), sort_keys=True
    )
    assert tm.copies["blocks/ffn/w_gate"] == 2 * 8  # layers x experts
    assert ("blocks/ffn/w_gate", "blocks/ffn/w_up") in tm.groups
    assert ("blocks/attn/wq", "blocks/attn/wk", "blocks/attn/wv") in tm.groups
    assert tm.total_lut_bytes == jm.total_lut_bytes


def _tables_equal(t, j):
    """Bit-identical tables and scales (the reference's scale is the exact
    power of two here; a scale a few ulps off would move codes by one)."""
    np.testing.assert_array_equal(t.tables.numpy(), np.asarray(j.tables))
    if j.scale is None:
        assert t.scale is None
    else:
        js = np.asarray(j.scale, np.float32)
        np.testing.assert_array_equal(t.scale.numpy().view(np.uint32), js.view(np.uint32))


def test_planned_expert_conversion_is_bit_identical(qwen, planned):
    cfg, jcfg, jp, tp = qwen
    jm, tm = planned
    jc, jr = jconvert(jp, plan=jm, convert_experts=True)
    tc, tr = convert_params(tp, plan=tm, convert_experts=True, slice_bytes=4096)
    assert (tr.converted, tr.skipped, tr.grouped) == (jr.converted, jr.skipped, jr.grouped)
    assert tr.table_bytes == jr.table_bytes == tm.total_lut_bytes
    jf, tf = jc["blocks"]["ffn"], tc["blocks"]["ffn"]
    assert isinstance(tf["w_gate+w_up"], LUTGroup) and isinstance(jf["w_gate+w_up"], JGroup)
    assert isinstance(tf["w_down"], LUTLinear)
    L, E = cfg.num_layers, cfg.num_experts
    assert tuple(tf["w_gate+w_up"].tables.shape[:3]) == (L, E, 2)
    assert tuple(tf["w_down"].tables.shape[:2]) == (L, E)
    for key in ("w_gate+w_up", "w_down"):
        _tables_equal(tf[key], jf[key])
    for key in ("wq+wk+wv", "wo"):
        _tables_equal(tc["blocks"]["attn"][key], jc["blocks"]["attn"][key])
    _tables_equal(tc["lm_head"], jc["lm_head"])
    np.testing.assert_array_equal(
        tc["blocks"]["attn"]["wq+wk+wv"].b.numpy(),
        np.asarray(jc["blocks"]["attn"]["wq+wk+wv"].b),
    )


def test_expert_stack_has_one_scale_per_layer():
    """A narrow expert stack is ONE table set per layer: its scale comes
    from the max over all experts, not one per expert."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((2, 3, 8, 6)).astype(np.float32)
    w[1, 2] *= 40.0  # one expert of layer 1 dominates its layer's range
    tree = {"moe": {
        "router": np.zeros((2, 8, 3), np.float32), "w_gate": w, "w_up": w * 0.5,
        "w_down": rng.standard_normal((2, 3, 6, 8)).astype(np.float32),
    }}
    jt = _jax_tree(tree)
    tt = params_from_numpy(tree, device="cpu")
    kw = dict(SERVING, max_chunk=1)
    jm = jplan_model(jt, float("inf"), **kw)
    tm = plan_model(tt, float("inf"), **kw)
    assert tm.to_json() == jm.to_json()
    assert {p.table_format for p in tm.layers.values()} == {"i8"}
    jc, _ = jconvert(jt, plan=jm, convert_experts=True)
    tc, _ = convert_params(tt, plan=tm, convert_experts=True)
    for key in ("w_gate+w_up", "w_down"):
        node = tc["moe"][key]
        assert tuple(node.scale.shape) == (2,)
        _tables_equal(node, jc["moe"][key])
    g = tc["moe"]["w_gate+w_up"]
    # layer 1's scale is set by its dominant expert: the others use few codes
    assert g.scale[1] > g.scale[0]
    assert g.tables[1, 2].abs().max() >= 64
    assert g.tables[1, 0].abs().max() < 16


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


def _ffn_inputs(cfg, seed=8):
    x = np.random.default_rng(seed).standard_normal((2, 6, cfg.d_model)) * 0.5
    return x.astype(np.float32)


def _ffn_pair(jtree, ttree, cfg, jcfg, x, grouped=True):
    jctx = JCtx(jcfg, ex=JExecCfg(remat="none", lut_grouped=grouped))
    # jitted: one compile instead of an eager compile per primitive
    want, jaux = jax.jit(lambda p, v: jmoe.moe_ffn(p, v, jctx))(
        _layer0_ffn(jtree), jnp.asarray(x)
    )
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=grouped))
    got, taux = moe.moe_ffn(_layer0_ffn(ttree), torch.from_numpy(x), ctx)
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    return got, want


def test_moe_ffn_dense_experts_match_reference(qwen):
    cfg, jcfg, jp, tp = qwen
    got, want = _ffn_pair(jp, tp, cfg, jcfg, _ffn_inputs(cfg))
    _close(got, want, FFN_TOL)


@pytest.mark.parametrize("how", ["chunk1", "planned"])
def test_moe_ffn_lut_experts_match_reference(qwen, planned, how):
    cfg, jcfg, jp, tp = qwen
    if how == "chunk1":
        jc, _ = jconvert(jp, chunk_size=1, convert_experts=True)
        tc, _ = convert_params(tp, chunk_size=1, convert_experts=True)
    else:
        jm, tm = planned
        jc, _ = jconvert(jp, plan=jm, convert_experts=True)
        tc, _ = convert_params(tp, plan=tm, convert_experts=True)
    got, want = _ffn_pair(jc, tc, cfg, jcfg, _ffn_inputs(cfg))
    _close(got, want, FFN_TOL)


@pytest.mark.parametrize(
    "members", [("w_down",), ("w_gate", "w_up"), ("w_gate",)],
    ids=["down_only", "gate_up", "gate_only"],
)
def test_moe_ffn_mixed_trees_match_reference(qwen, members):
    """Plans converting only some expert projections: each member runs on
    its own path (dense stand-in or ragged LUT) in both packages."""
    cfg, jcfg, jp, tp = qwen

    def pred(path, node, m=members):
        return path[-1] in m and node["w"].ndim >= 3

    kw = dict(max_chunk=1, convert_experts=True, predicate=pred)
    jm = jplan_model(jp, float("inf"), **kw)
    tm = plan_model(tp, float("inf"), **kw)
    assert tm.to_json() == jm.to_json()
    jc, _ = jconvert(jp, plan=jm, convert_experts=True, predicate=pred)
    tc, _ = convert_params(tp, plan=tm, convert_experts=True, predicate=pred)
    got, want = _ffn_pair(jc, tc, cfg, jcfg, _ffn_inputs(cfg, seed=9), grouped=False)
    _close(got, want, FFN_TOL)


@pytest.fixture(scope="module")
def tl1_trees(qwen):
    cfg, jcfg, jp, tp = qwen
    jm = jplan_model(jp, float("inf"), families=("tl1",), convert_experts=True)
    tm = plan_model(tp, float("inf"), families=("tl1",), convert_experts=True)
    assert tm.to_json() == jm.to_json()
    jc, _ = jconvert(jp, plan=jm, convert_experts=True)
    tc, _ = convert_params(tp, plan=tm, convert_experts=True)
    return jc, tc


def test_moe_ffn_tl1_experts_match_reference(qwen, tl1_trees):
    cfg, jcfg, _, _ = qwen
    jc, tc = tl1_trees
    g, jg = tc["blocks"]["ffn"]["w_gate+w_up"], jc["blocks"]["ffn"]["w_gate+w_up"]
    assert g.tables.dtype == torch.uint8 and tuple(g.scale.shape) == (2, 8, 2)
    np.testing.assert_array_equal(g.tables.numpy(), np.asarray(jg.tables))
    got, want = _ffn_pair(jc, tc, cfg, jcfg, _ffn_inputs(cfg, seed=10))
    _close(got, want, FFN_TOL)


@pytest.mark.parametrize("act_bits", [8, None])
def test_ragged_tl1_matches_reference(tl1_trees, act_bits):
    """The TL1 expert path alone: the int accumulate, and everything after
    it (one fp32 product per scale), bit for bit; the exact path's fp32
    sums within SUM_TOL."""
    jc, tc = tl1_trees
    node = tc["blocks"]["ffn"]["w_gate+w_up"].layer(0)
    plan = TL1Plan(node.plan.in_features, node.plan.out_features, act_bits=act_bits)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((10, plan.in_features)).astype(np.float32)
    gs = np.asarray([3, 0, 2, 1, 0, 4, 0, 0], np.int32)
    codes, ascale = quantize_acts(torch.from_numpy(x), plan)
    scale = node.scale
    got = moe._ragged_tl1(
        node.tables, plan, codes, torch.from_numpy(gs), scale=scale, act_scale=ascale
    )
    want = jmoe._ragged_tl1(
        jnp.asarray(node.tables.numpy()), plan_to_jax(plan), jnp.asarray(codes.numpy()),
        jnp.asarray(gs), scale=jnp.asarray(scale.numpy()),
        act_scale=None if ascale is None else jnp.asarray(ascale.numpy()),
    )
    if act_bits is None:
        _close(got, want, SUM_TOL)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def plan_to_jax(plan):
    from repro.core.planner import plan_from_json as jplan_from_json
    from repro_torch.core.planner import plan_to_json

    return jplan_from_json(plan_to_json(plan))


def test_lut_experts_close_to_dense_experts(qwen):
    """The port's chunk-1 LUT experts against its own dense experts: only
    the fp16 input quantization differs (as the reference's own test)."""
    cfg, _, _, tp = qwen
    tokens = torch.from_numpy(
        np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    )
    ref, _, aux = model_forward(tp, {"tokens": tokens}, Ctx(cfg))
    lut, _ = convert_params(tp, chunk_size=1, convert_experts=True)
    got, _, aux_lut = model_forward(lut, {"tokens": tokens}, Ctx(cfg, ex=ExecCfg(lut_grouped=True)))
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel < 1e-2
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    assert float(aux) > 0 and abs(float(aux_lut) - float(aux)) < 1e-2 * float(aux)


def test_model_forward_aux_matches_reference(qwen):
    """``forward``'s aux loss is the routers' losses summed over layers."""
    cfg, jcfg, jp, tp = qwen
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    _, _, jaux = jmodel_forward(
        jp, {"tokens": jnp.asarray(tokens)}, JCtx(jcfg, ex=JExecCfg(remat="none"))
    )
    _, _, aux = model_forward(tp, {"tokens": torch.from_numpy(tokens)}, Ctx(cfg))
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_moe_specs_init_rules():
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    s = moe.moe_specs(cfg)
    assert s["router"].dtype == torch.float32 and s["shared_gate"].dtype == torch.float32
    assert s["w_gate"].shape == (cfg.num_experts, cfg.d_model, cfg.moe_d_ff)
    assert isinstance(s["shared"]["w_down"]["w"], PSpec)
    assert s["shared"]["w_down"]["w"].shape == (2 * cfg.moe_d_ff, cfg.d_model)
