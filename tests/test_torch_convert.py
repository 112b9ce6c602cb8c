"""``repro_torch.core.convert`` against ``repro.core.convert`` on the same
weights and plan: the converted leaves are bit-identical (tables, biases,
group layout; narrow-table scales are the exact powers of two the
reference means), and ``ModelPlan.total_lut_bytes`` is the bytes of the
leaves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.convert import LUTGroup as JGroup
from repro.core.convert import LUTLinear as JLinear
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro_torch.core.convert import LUTGroup, LUTLinear, convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.models.params import params_from_numpy

SERVING = dict(
    max_chunk=2,
    modes=("bitplane", "bitplane_shift"),
    radices=(1, 2, 4),
    table_formats=(None, "i8"),
)


@pytest.fixture(scope="module")
def granite():
    cfg = jget_config("granite_8b", reduced=True)
    jp = jinit_params(jmodel_specs(cfg), jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    uniform = jplan_model(jp, float("inf"), max_chunk=2)
    jm = jplan_model(jp, uniform.total_lut_bytes // 2, **SERVING)
    return jp, tp, jm


def _pow2(ref_scale: np.ndarray) -> np.ndarray:
    """The exact power of two the reference's scale means (XLA:CPU's
    vectorised exp2 can leave it a few ulps off; see test_torch_core)."""
    pow2 = (2.0 ** np.round(np.log2(ref_scale.astype(np.float64)))).astype(np.float32)
    np.testing.assert_allclose(ref_scale, pow2, rtol=2.0**-20, atol=0)
    return pow2


def _assert_same_tree(t, j):
    if isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), (sorted(t), sorted(j))
        for k in j:
            _assert_same_tree(t[k], j[k])
        return
    if isinstance(j, (JLinear, JGroup)):
        assert isinstance(t, LUTGroup if isinstance(j, JGroup) else LUTLinear)
        assert plan_to(t.plan) == plan_to(j.plan)
        if isinstance(j, JGroup):
            assert t.members == j.members
        if j.scale is None:
            assert t.scale is None
            np.testing.assert_array_equal(t.tables.numpy(), np.asarray(j.tables))
        else:
            pow2 = _pow2(np.asarray(j.scale))
            np.testing.assert_array_equal(
                t.scale.numpy().view(np.uint32), pow2.view(np.uint32)
            )
            if np.array_equal(np.asarray(j.scale), pow2):
                np.testing.assert_array_equal(t.tables.numpy(), np.asarray(j.tables))
            else:  # rounding may move by one code against an inexact scale
                diff = t.tables.numpy().astype(np.int64) - np.asarray(j.tables)
                assert np.abs(diff).max() <= 1
        _assert_same_leaf(t.b, j.b)
        return
    _assert_same_leaf(t, j)


def _assert_same_leaf(t, j):
    if j is None:
        assert t is None
    elif isinstance(j, tuple):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _assert_same_leaf(a, b)
    else:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def plan_to(plan):
    from repro_torch.core.planner import plan_to_json

    d = plan_to_json(plan) if plan.__module__.startswith("repro_torch") else None
    if d is None:
        from repro.core.planner import plan_to_json as j_plan_to_json

        d = j_plan_to_json(plan)
    return d


def _leaf_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_bytes(v) for v in tree.values())
    if isinstance(tree, (LUTLinear, LUTGroup)):
        return tree.tables.numel() * tree.tables.element_size()
    return 0


@pytest.mark.parametrize("group_siblings", [True, False])
def test_planned_conversion_is_bit_identical(granite, group_siblings):
    jp, tp, jm = granite
    mp = ModelPlan.from_json(jm.to_json())
    if not group_siblings:
        jm = jplan_model(jp, jm.budget_bytes, group_siblings=False, **SERVING)
        mp = plan_model(tp, jm.budget_bytes, group_siblings=False, **SERVING)
    jc, jr = jconvert(jp, plan=jm, group_siblings=group_siblings)
    tc, tr = convert_params(
        tp, plan=mp, group_siblings=group_siblings, slice_bytes=4096
    )
    _assert_same_tree(tc, jc)
    assert (tr.converted, tr.skipped) == (jr.converted, jr.skipped)
    assert tr.grouped == jr.grouped
    assert tr.table_bytes == jr.table_bytes == _leaf_bytes(tc) == mp.total_lut_bytes


def test_uniform_conversion_and_fp16_accounting(granite):
    jp, tp, _ = granite
    jc, _ = jconvert(jp, chunk_size=1)
    tc, _ = convert_params(tp, chunk_size=1)
    _assert_same_tree(tc, jc)
    mp = plan_model(tp, float("inf"), max_chunk=1)
    conv, rep = convert_params(tp, plan=mp, table_dtype=torch.float16)
    assert _leaf_bytes(conv) == rep.table_bytes == mp.total_lut_bytes


def test_biases_and_mixed_bias_groups():
    rng = np.random.default_rng(2)

    def lin(q, p, bias):
        d = {"w": rng.standard_normal((q, p)).astype(np.float32)}
        if bias:
            d["b"] = rng.standard_normal((p,)).astype(np.float32)
        return d

    tree = {
        "attn": {
            "wq": lin(16, 8, True), "wk": lin(16, 8, False), "wv": lin(16, 8, True)
        },
        "ffn": {
            "w_gate": lin(16, 12, True),
            "w_up": lin(16, 12, True),
            "w_down": lin(12, 16, True),
        },
    }
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = params_from_numpy(tree, device="cpu")
    budget = jplan_model(jtree, float("inf"), max_chunk=2).total_lut_bytes // 2
    jm = jplan_model(jtree, budget, **SERVING)
    tm = plan_model(ttree, budget, **SERVING)
    assert tm.to_json() == jm.to_json()
    jc, _ = jconvert(jtree, plan=jm)
    tc, _ = convert_params(ttree, plan=tm)
    _assert_same_tree(tc, jc)
    assert isinstance(tc["attn"]["wq+wk+wv"].b, tuple)


def test_never_consumed_plan_entries_raise(granite):
    _, tp, jm = granite
    d = jm.to_json()
    d["layers"]["blocks/attn/w_ghost"] = d["layers"]["blocks/attn/wo"]
    with pytest.raises(ValueError, match="never consumed"):
        convert_params(tp, plan=ModelPlan.from_json(d))
    # an expert-stack entry planned with convert_experts=True is one the
    # converter never consumes without it
    rng = np.random.default_rng(3)
    moe = {"ffn": {
        "router": rng.standard_normal((4, 2)).astype(np.float32),
        **{k: rng.standard_normal((2, 4, 4)).astype(np.float32)
           for k in ("w_gate", "w_up", "w_down")},
    }}
    tmoe = params_from_numpy(moe, device="cpu")
    mp = plan_model(tmoe, float("inf"), convert_experts=True)
    assert mp.to_json() == jplan_model(
        jax.tree.map(jnp.asarray, moe), float("inf"), convert_experts=True
    ).to_json()
    with pytest.raises(ValueError, match="never consumed"):
        convert_params(tmoe, plan=mp)
    convert_params(tmoe, plan=mp, convert_experts=True)
