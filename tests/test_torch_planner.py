"""The port's planner against ``repro.core.planner`` on the same weights:
the serving recipe gives the same ModelPlan JSON (certified ``max_abs_acc``
included), and the port reads the reference's JSON back."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.planner import ModelPlan as JModelPlan
from repro.core.planner import plan_model as jplan_model
from repro.core.quantize import FixedPointFormat as JFixed
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro_torch.core.planner import ModelPlan, plan_from_json, plan_model
from repro_torch.core.quantize import FixedPointFormat
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
    jp = jinit_params(jmodel_specs(cfg), jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _serving_plans(params, plan_fn):
    uniform = plan_fn(params, float("inf"), max_chunk=2)
    return uniform, plan_fn(params, uniform.total_lut_bytes // 2, **SERVING)


def test_serving_recipe_gives_the_reference_plan_json(granite):
    jp, tp = granite
    ju, jm = _serving_plans(jp, jplan_model)
    tu, tm = _serving_plans(tp, plan_model)
    assert tu.to_json() == ju.to_json()
    assert tm.to_json() == jm.to_json()
    assert all(p.max_abs_acc is not None for p in tm.layers.values())
    assert tm.total_lut_bytes == jm.total_lut_bytes
    assert tm.total_shift_add_ops == jm.total_shift_add_ops
    assert {p.mode for p in tm.layers.values()} == {"bitplane_shift"}


@pytest.mark.parametrize("frac", [0.3, 0.6, 1.0])
def test_budgets_and_fixed_point_formats_match(granite, frac):
    jp, tp = granite
    jf, tf = JFixed(6, 4, signed=True), FixedPointFormat(6, 4, signed=True)
    kw = dict(
        max_chunk=3, modes=("bitplane", "full"), table_formats=(None, "i8", "i16")
    )
    j_inf = jplan_model(jp, float("inf"), fmt=jf, **kw)
    floor = jplan_model(jp, float("inf"), fmt=jf, max_chunk=1, modes=("bitplane",))
    lo, hi = floor.total_lut_bytes, j_inf.total_lut_bytes
    budget = int(lo + frac * (hi - lo))
    want = jplan_model(jp, budget, fmt=jf, **kw)
    got = plan_model(tp, budget, fmt=tf, **kw)
    assert got.to_json() == want.to_json()
    ungrouped = plan_model(tp, budget, fmt=tf, group_siblings=False, **kw)
    assert ungrouped.to_json() == jplan_model(
        jp, budget, fmt=jf, group_siblings=False, **kw
    ).to_json()


def test_reads_the_reference_json_back(granite):
    jp, _ = granite
    _, jm = _serving_plans(jp, jplan_model)
    d = jm.to_json()
    # a plan from the reference may carry its TPU tiles: they round-trip
    for entry in d["layers"].values():
        entry["blocks"] = [8, 128, 4]
    mp = ModelPlan.from_json(d)
    assert mp.to_json() == d == JModelPlan.from_json(d).to_json()
    assert all(p.blocks == (8, 128, 4) for p in mp.layers.values())


def test_plans_from_shapes_alone(granite):
    _, tp = granite
    meta = {k: v for k, v in tp.items()}
    meta["blocks"] = {
        k: {n: {"w": t["w"].to("meta")} for n, t in v.items()}
        if k in ("attn", "ffn") else v
        for k, v in tp["blocks"].items()
    }
    from_meta = _serving_plans(meta, plan_model)[1]
    assert from_meta.to_json() == _serving_plans(tp, plan_model)[1].to_json()


def test_tl1_and_budget_errors(granite):
    # the TL1 family plans since its slice was ported (test_torch_tl1.py
    # holds its JSON to the reference); an unknown family still raises
    _, tp = granite
    mixed = plan_model(tp, float("inf"), families=("weight", "tl1"))
    assert mixed.families == ("tl1",)  # fewer bytes and fewer adds here
    plan = plan_from_json({"family": "tl1", "in_features": 4, "out_features": 4})
    assert plan.table_family == "tl1" and plan.act_bits == 8
    with pytest.raises(ValueError, match="famil"):
        plan_model(tp, float("inf"), families=("lut3",))
    with pytest.raises(ValueError, match="famil"):
        plan_from_json({"family": "lut3", "in_features": 4, "out_features": 4})
    with pytest.raises(ValueError, match="budget"):
        plan_model(tp, 10)
    assert torch.is_tensor(tp["embed"])
