"""``repro_torch.audit`` against ``repro.audit`` on the three reduced audit
points, and the port's own seeded cases.

Plan level: the same plan travels as ``ModelPlan`` JSON and the same seeded
weights are converted by both packages; ``precision_report`` must agree
within 1e-12 relative, ``plan_consistency_violations`` and
``overflow_violations(graphs=())`` must give equal lists, clean and on
seeded breaches (a dropped converted leaf, a table with extra bytes, a
stale stamped bound).

Graph level: the reference's verdicts on its traced decode step and the
port's on its recorded one must agree -- both clean, both tripped by a
dense fallback spliced over ``wq`` and by a per-step stack of a group's
tables.  The reference's jaxpr walker reads ``jax.core.ClosedJaxpr``,
which JAX 0.9 keeps in ``jax.extend.core`` only, so its side runs with
those names aliased into ``jax.core`` through this file's ``monkeypatch``
fixture.  The reference's interval pass is not compared: under JAX 0.9
its decode step holds a false ``int32 sub`` overflow.

Then the port's own cases: the interval pass's flagging policy, the
in-place cache rule, a kernel report as one opaque leaf, a recorder that
changes nothing when off, and the CLI against the committed baseline.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.audit import points as jpoints
from repro.audit import rules as jrules
from repro.audit.ranges import overflow_violations as j_overflow_violations
from repro.audit.ranges import precision_report as j_precision_report
from repro.configs.base import get_config as jget_config
from repro.core.convert import LUTGroup as JLUTGroup
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import abstract_params as jabstract_params
from repro_torch.audit import (
    AUDIT_POINTS,
    INT_INPUT_BOUND,
    Interval,
    audit_point,
    diff_manifests,
    inplace_violations,
    input_interval,
    interval_eval,
    kernel_interval_model,
    layer_range_cert,
    load_manifest,
    multiplier_free_violations,
    op_census,
    overflow_violations,
    plan_consistency_violations,
    planned_weight_shapes,
    precision_report,
    record,
    state_shapes,
    storage_map,
    table_leaf_shapes,
    trace_point,
    zero_copy_violations,
)
from repro_torch.audit.__main__ import DEFAULT_BASELINE
from repro_torch.audit.__main__ import main as audit_main
from repro_torch.audit.interp import dtype_interval
from repro_torch.audit.walker import kernel_leaves
from repro_torch.core.convert import LUTGroup, convert_params
from repro_torch.core.lut_tl1 import TL1Plan
from repro_torch.core.planner import ModelPlan
from repro_torch.kernels import common
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import make_cache

NAMES = [pt.name for pt in AUDIT_POINTS]
POINTS = dict(zip(NAMES, AUDIT_POINTS))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The recorded steps are many small ops: one intra-op thread keeps
    them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_core_alias(monkeypatch):
    """The names the reference's walker reads from ``jax.core``, aliased
    from ``jax.extend.core`` for one test."""
    import jax.extend.core as jec

    for name in ("ClosedJaxpr", "Jaxpr", "Literal", "Var", "JaxprEqn"):
        monkeypatch.setattr(jax.core, name, getattr(jec, name), raising=False)


def _json(vs):
    return [v.to_json() for v in vs]


# ---------------------------------------------------------------------------
# plan level: both packages on one plan and one set of seeded weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plans():
    """Per point: weights drawn from a seed with numpy; the reference's plan
    over them and its converted tree (abstract, through ``jax.eval_shape``,
    as the reference's own audit converts), and the port's tree converted
    from the same weights under the same plan, read back from JSON."""
    out = {}
    for i, pt in enumerate(AUDIT_POINTS):
        jcfg = jget_config(pt.arch, reduced=True)
        rng = np.random.default_rng(11 + i)
        weights = jax.tree.map(
            lambda s: (0.05 * rng.standard_normal(s.shape)).astype(s.dtype),
            jabstract_params(jmodel_specs(jcfg)),
        )
        jp = jax.tree.map(jnp.asarray, weights)
        jm = jplan_model(
            jp, float("inf"), max_chunk=1, families=pt.families,
            convert_experts=pt.convert_experts, tl1_act_bits=pt.tl1_act_bits,
        )
        jlut = jax.eval_shape(
            lambda p: jconvert(p, plan=jm, table_dtype=jnp.float16,
                               convert_experts=pt.convert_experts)[0],
            jp,
        )
        mp = ModelPlan.from_json(jm.to_json())
        tlut, _ = convert_params(params_from_numpy(weights, device="cpu"), plan=mp,
                                 table_dtype=torch.float16,
                                 convert_experts=pt.convert_experts)
        out[pt.name] = dict(jm=jm, jlut=jlut, mp=mp, tlut=tlut)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_precision_report_matches_reference(plans, name):
    w = plans[name]
    got, want = precision_report(w["mp"]), j_precision_report(w["jm"])
    assert got.keys() == want.keys() and got
    for layer in want:
        assert got[layer].keys() == want[layer].keys()
        for k, v in want[layer].items():
            if isinstance(v, float):
                assert math.isclose(got[layer][k], v, rel_tol=1e-12, abs_tol=0.0), (layer, k)
            else:
                assert got[layer][k] == v, (layer, k)


@pytest.mark.parametrize("name", NAMES)
def test_clean_plan_rules_match_reference(plans, name):
    w = plans[name]
    assert _json(plan_consistency_violations(w["mp"], w["tlut"])) == _json(
        jrules.plan_consistency_violations(w["jm"], w["jlut"])) == []
    assert _json(overflow_violations(w["mp"])) == _json(
        j_overflow_violations(w["jm"])) == []


def _splice(tree, path, value):
    """``tree`` with the leaf at ``path`` replaced (dropped when ``value``
    is None), every dict on the way copied."""
    head, *rest = path
    node = dict(tree)
    if rest:
        node[head] = _splice(tree[head], rest, value)
    elif value is None:
        del node[head]
    else:
        node[head] = value
    return node


@pytest.mark.parametrize("name", NAMES)
def test_dropped_leaf_trips_never_consumed_as_reference(plans, name):
    w = plans[name]
    path = ("blocks", "attn", "wo")
    got = _json(plan_consistency_violations(w["mp"], _splice(w["tlut"], path, None)))
    want = _json(jrules.plan_consistency_violations(w["jm"], _splice(w["jlut"], path, None)))
    assert got == want
    assert {v["primitive"] for v in got} == {"never_consumed", "byte_mismatch"}


@pytest.mark.parametrize("name", NAMES)
def test_extra_table_bytes_trip_byte_mismatch_as_reference(plans, name):
    w = plans[name]
    path = ("blocks", "attn", "wo")
    t, j = w["tlut"]["blocks"]["attn"]["wo"], w["jlut"]["blocks"]["attn"]["wo"]
    grown_t = dataclasses.replace(t, tables=F.pad(t.tables, (0, 0, 0, 0, 0, 1)))
    pad = [(0, 0)] * (j.tables.ndim - 3) + [(0, 1), (0, 0), (0, 0)]
    if j.plan.table_family == "tl1":
        grown_t = dataclasses.replace(t, tables=F.pad(t.tables, (0, 0, 0, 1)))
        pad = [(0, 0)] * (j.tables.ndim - 2) + [(0, 1), (0, 0)]
    shape = tuple(d + hi for d, (_, hi) in zip(j.tables.shape, pad))
    grown_j = dataclasses.replace(j, tables=jax.ShapeDtypeStruct(shape, j.tables.dtype))
    got = _json(plan_consistency_violations(w["mp"], _splice(w["tlut"], path, grown_t)))
    want = _json(jrules.plan_consistency_violations(w["jm"], _splice(w["jlut"], path, grown_j)))
    assert got == want
    assert [v["primitive"] for v in got] == ["byte_mismatch"]


@pytest.mark.parametrize("name", NAMES)
def test_stale_stamp_trips_stale_bound_as_reference(plans, name):
    w = plans[name]
    key = "blocks/attn/wq"

    def stale(mplan):
        plan = dataclasses.replace(mplan.layers[key], max_abs_acc=1.0)
        return dataclasses.replace(mplan, layers={**dict(mplan.layers), key: plan})

    got = _json(overflow_violations(stale(w["mp"])))
    want = _json(j_overflow_violations(stale(w["jm"])))
    assert got == want
    assert [v["primitive"] for v in got] == ["stale_bound"]


def test_wide_int16_tl1_plan_trips_accumulate_as_reference():
    from repro.core.lut_tl1 import TL1Plan as JTL1Plan
    from repro.core.planner import ModelPlan as JModelPlan

    wide = dict(in_features=4096, out_features=64, act_bits=8, acc_dtype="int16")
    got = _json(overflow_violations(ModelPlan(layers={"ffn/w": TL1Plan(**wide)})))
    want = _json(j_overflow_violations(JModelPlan(layers={"ffn/w": JTL1Plan(**wide)})))
    assert got == want
    assert [v["primitive"] for v in got] == ["accumulate"]


# ---------------------------------------------------------------------------
# graph level: the reference's verdicts on its traced steps, the port's on
# its recorded ones
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traced():
    """The port's three points, recorded once (shared by every test here)."""
    return {pt.name: trace_point(pt) for pt in AUDIT_POINTS}


@pytest.fixture(scope="module")
def jpoint():
    """The reference's abstract granite_weight point."""
    return jpoints.build_point(jpoints.AUDIT_POINTS[0])


def _j_verdicts(art, params):
    jaxpr = jax.make_jaxpr(art["decode"])(params, art["cache"], art["decode_tokens"])
    return _rule_verdicts(
        jrules.multiplier_free_violations(
            jaxpr, weight_shapes=jrules.planned_weight_shapes(art["mplan"])),
        jrules.zero_copy_violations(
            jaxpr, table_shapes=jrules.table_leaf_shapes(art["template"])),
    )


def _rule_verdicts(mf, zc):
    return {"multiplier_free": bool(mf), "zero_copy": bool(zc)}


def _t_verdicts(art, ops):
    return _rule_verdicts(
        multiplier_free_violations(ops, weight_shapes=planned_weight_shapes(art["mplan"])),
        zero_copy_violations(ops, table_shapes=table_leaf_shapes(art["template"])),
    )


def _fresh_decode(art, params, fn=None):
    """Record the point's decode step on a fresh cache."""
    pt, cfg = art["point"], art["cfg"]
    cache = make_cache(cfg, pt.batch, pt.cache_len, art["ctx"], device="cpu")
    tok = torch.zeros((pt.batch, 1), dtype=torch.int32)
    with torch.no_grad():
        return record(fn or art["decode"], params, cache, tok)


@pytest.mark.parametrize("name", NAMES)
def test_clean_points_match_reference_verdicts(traced, jax_core_alias, name):
    jart = jpoints.build_point(POINTS[name])
    want = _j_verdicts(jart, jart["template"])
    art = traced[name]
    assert _t_verdicts(art, art["decode_ops"]) == want == {
        "multiplier_free": False, "zero_copy": False}


def test_dense_fallback_trips_multiplier_free_as_reference(traced, jpoint, jax_core_alias):
    art = traced["granite_weight"]
    path = ("blocks", "attn", "wq")
    raw = jabstract_params(jmodel_specs(jpoint["cfg"]))["blocks"]["attn"]["wq"]
    want = _j_verdicts(jpoint, _splice(jpoint["template"], path, raw))
    _, ops = _fresh_decode(art, _splice(art["template"], path, art["raw"]["blocks"]["attn"]["wq"]))
    got = _t_verdicts(art, ops)
    assert got == want == {"multiplier_free": True, "zero_copy": False}
    hits = multiplier_free_violations(ops, weight_shapes=planned_weight_shapes(art["mplan"]))
    assert {v.primitive for v in hits} == {"mm"}


def test_restacked_group_trips_zero_copy_as_reference(traced, jpoint, jax_core_alias):
    art = traced["granite_weight"]
    # the reference: members as separate inputs, stacked inside the step
    jgroup = jpoint["template"]["blocks"]["attn"]["wk+wv"]
    shape = jgroup.tables.shape
    jmembers = tuple(jax.ShapeDtypeStruct(shape[:1] + shape[2:], jgroup.tables.dtype)
                     for _ in range(shape[1]))

    def j_restacking(members, params, cache, tokens):
        node = JLUTGroup(jnp.stack(members, axis=1), jgroup.plan, jgroup.members,
                         b=jgroup.b, scale=jgroup.scale)
        return jpoint["decode"](_splice(params, ("blocks", "attn", "wk+wv"), node), cache, tokens)

    jaxpr = jax.make_jaxpr(j_restacking)(
        jmembers, jpoint["template"], jpoint["cache"], jpoint["decode_tokens"])
    want = _rule_verdicts(
        jrules.multiplier_free_violations(
            jaxpr, weight_shapes=jrules.planned_weight_shapes(jpoint["mplan"])),
        jrules.zero_copy_violations(
            jaxpr, table_shapes=jrules.table_leaf_shapes(jpoint["template"])),
    )
    # the port: the same splice, the stack recorded in the step
    group = art["template"]["blocks"]["attn"]["wk+wv"]
    members = [group.tables[:, g].clone() for g in range(group.tables.shape[1])]

    def restacking(params, cache, tokens):
        node = LUTGroup(torch.stack(members, dim=1), group.plan, group.members,
                        b=group.b, scale=group.scale)
        return art["decode"](_splice(params, ("blocks", "attn", "wk+wv"), node), cache, tokens)

    _, ops = _fresh_decode(art, art["template"], restacking)
    assert _t_verdicts(art, ops) == want == {"multiplier_free": False, "zero_copy": True}
    hits = zero_copy_violations(ops, table_shapes=table_leaf_shapes(art["template"]))
    assert {v.primitive for v in hits} == {"stack"}


@pytest.mark.parametrize("name", NAMES)
def test_point_is_clean_on_every_rule(traced, name):
    entry = audit_point(POINTS[name], trace=traced[name])
    assert set(entry["rules"]) == {
        "multiplier_free", "zero_copy", "inplace", "plan_consistency", "overflow"}
    assert all(not v for v in entry["rules"].values()), entry["rules"]
    assert entry["census"]["decode"] and entry["census"]["prefill"]
    assert entry["precision"] and entry["plan"]["total_lut_bytes"] > 0


# ---------------------------------------------------------------------------
# the port's own seeded cases
# ---------------------------------------------------------------------------


def output_interval(env, meta):
    """The final interval of one recorded tensor."""
    got = env.get(meta.storage, {}).get(meta.dtype)
    return got if got is not None else dtype_interval(meta.dtype)


def _eval(fn, *args):
    out, ops = record(fn, *args)
    env, facts = interval_eval(ops)
    return output_interval(env, ops[-1].outputs[0]), facts


def test_input_interval_policy():
    assert input_interval(torch.int32) == Interval(-float(INT_INPUT_BOUND), float(INT_INPUT_BOUND))
    assert input_interval(torch.int8) == Interval(-128.0, 127.0)
    assert input_interval(torch.uint8) == Interval(0.0, 255.0)
    assert input_interval(torch.float32).lo == -math.inf


def test_in_range_int_arithmetic_is_clean():
    out, facts = _eval(lambda x: x + 1, torch.zeros(4, dtype=torch.int32))
    assert facts == []
    assert out.within(Interval(-(2.0**24) + 1, 2.0**24 + 1))


def test_seeded_int16_add_overflow_fires():
    out, facts = _eval(lambda x: x + x, torch.zeros(4, dtype=torch.int16))
    assert len(facts) == 1 and facts[0].primitive == "add"
    assert facts[0].dtype == "int16" and "escapes" in facts[0].detail


def test_unsigned_wrap_and_narrowing_cast_are_not_flagged():
    out, facts = _eval(lambda x: x + x, torch.zeros(4, dtype=torch.uint8))
    assert facts == [] and out.within(Interval(0.0, 255.0))
    out, facts = _eval(lambda x: x.to(torch.int16), torch.zeros(4, dtype=torch.int32))
    assert facts == [] and out.within(Interval(-32768.0, 32767.0))


def test_a_write_through_a_view_reaches_its_buffer():
    # the zeros take the input's range through the slice written into them,
    # so the add over the whole buffer escapes int16
    def f(x):
        buf = torch.zeros(4, dtype=torch.int16)
        buf[:2] = x
        return buf + buf

    out, facts = _eval(f, torch.zeros(2, dtype=torch.int16))
    assert [fact.primitive for fact in facts] == ["add"]
    out, facts = _eval(lambda x: torch.zeros(4, dtype=torch.int16) + x[:1],
                       torch.zeros(2, dtype=torch.int8))
    assert facts == [] and out == Interval(-128.0, 127.0)


def test_masked_bits_of_a_float_view_are_bounded():
    # the packing idiom: a bit view reads its dtype's full range, and an and
    # with a nonnegative mask bounds it again, so the sub after it is safe
    out, facts = _eval(lambda x: ((x.view(torch.int32) >> 23) & 255) - 127,
                       torch.ones(4, dtype=torch.float32))
    assert facts == [] and out == Interval(-127.0, 128.0)


def test_overflow_violations_walk_named_recordings():
    mplan = ModelPlan(layers={"ffn/w": TL1Plan(64, 16, act_bits=8)})
    _, bad = record(lambda x: x + x, torch.zeros(4, dtype=torch.int16))
    hits = overflow_violations(mplan, graphs=(("decode", bad),))
    assert [v.primitive for v in hits] == ["add"] and hits[0].detail.startswith("decode:")
    _, clean = record(lambda x: x + 1, torch.zeros(4, dtype=torch.int32))
    assert overflow_violations(mplan, graphs=(("decode", clean),)) == []


def test_kernel_model_bounds_an_int_kernel_leaf_by_its_certificate():
    mplan = ModelPlan(layers={"ffn/w": TL1Plan(64, 16, act_bits=8)})

    def kernel_then_add(acts):
        acc = torch.zeros((acts.shape[0], 16), dtype=torch.int32)
        common.RECORDER("lut_tl1", (acts,), (acc,))
        return acc + acc

    _, ops = record(kernel_then_add, torch.zeros((2, 64), dtype=torch.int32))
    assert overflow_violations(mplan, graphs=(("decode", ops),)) == []
    # without the certificate the leaf spans int32, and the add escapes it
    hits = overflow_violations(mplan, graphs=(("decode", ops),),
                               kernel_model=lambda op, ins: None)
    assert [v.primitive for v in hits] == ["add"]
    env, _ = interval_eval(ops, kernel_model=kernel_interval_model(mplan))
    leaf = next(op for op in ops if op.opaque)
    bound = layer_range_cert(mplan.layers["ffn/w"]).max_abs_acc  # 2 * 127 * 32 chunks
    assert output_interval(env, leaf.outputs[0]) == Interval(-bound, bound) == Interval(
        -8128.0, 8128.0)


def test_fake_kernel_report_is_one_opaque_leaf():
    codes = torch.zeros((4, 3, 64), dtype=torch.int32)
    tables = torch.zeros((64, 32, 128), dtype=torch.int8)

    def step(codes, tables):
        out = torch.empty((1, 4, 128), dtype=torch.float32)
        common.RECORDER("lut_affine_grouped", (codes, tables), (out,))
        return out[0] * 2.0

    _, ops = record(step, codes, tables)
    leaves = [i for i, op in enumerate(ops) if op.opaque]
    assert len(leaves) == 1
    leaf = ops[leaves[0]]
    assert leaf.name == "lut_affine_grouped"
    assert [m.shape for m in leaf.inputs] == [(4, 3, 64), (64, 32, 128)]
    assert [m.shape for m in leaf.outputs] == [(1, 4, 128)]
    assert ops[-1].name == "mul" and leaves[0] in [
        ops[i].producers[0] for i in range(leaves[0] + 1, len(ops))]
    assert kernel_leaves(ops) == {"lut_affine_grouped": 1}
    assert op_census(ops)["lut_affine_grouped"] == 1
    # a leaf is opaque: a table-shaped operand in it is never a multiplier
    assert multiplier_free_violations(ops, table_shapes=[(64, 32, 128)]) == []


def test_recorder_costs_nothing_when_off(traced):
    art = traced["granite_weight"]
    assert common.RECORDER is None
    outs, counts = [], []
    for recorded in (False, True):
        before = [dict(c) for c in common.launch_counters()]
        pt = art["point"]
        cache = make_cache(art["cfg"], pt.batch, pt.cache_len, art["ctx"], device="cpu")
        tok = torch.zeros((pt.batch, 1), dtype=torch.int32)
        with torch.no_grad():
            if recorded:
                out, _ = record(art["decode"], art["template"], cache, tok)
            else:
                out = art["decode"](art["template"], cache, tok)
        outs.append((out[0], out[1], cache["layers"]["k"].clone()))
        counts.append([{k: c[k] - b[k] for k in c}
                       for c, b in zip(common.launch_counters(), before)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # the point's signed fp16 packs run pack_codes (no kernel takes them):
    # counted alike with the recorder on and off
    assert counts[0] == counts[1] and counts[0][4]["pack_codes"] > 0
    assert common.RECORDER is None
    with pytest.raises(ZeroDivisionError):
        record(lambda: 1 // 0)
    assert common.RECORDER is None


@pytest.mark.parametrize("rewrite", ["rebound", "copied_back"])
def test_out_of_place_cache_rewrite_trips_inplace(traced, rewrite):
    art = traced["granite_weight"]
    pt = art["point"]
    cache = make_cache(art["cfg"], pt.batch, pt.cache_len, art["ctx"], device="cpu")
    before, shapes = storage_map(cache), state_shapes(cache)

    def rewriting(params, cache, tokens):
        out = art["decode"](params, cache, tokens)
        k = out[2]["layers"]["k"]
        if rewrite == "rebound":
            out[2]["layers"]["k"] = k.clone()
        else:
            k.copy_(k.clone())
        return out

    with torch.no_grad():
        (_, _, after), ops = record(rewriting, art["template"], cache,
                                    torch.zeros((1, 1), dtype=torch.int32))
    got = {v.primitive for v in inplace_violations(before, after, ops, shapes)}
    assert got == ({"moved_cache_leaf", "clone"} if rewrite == "rebound" else {"clone"})
    # the step as served keeps every leaf in place
    assert not art["inplace"]["decode"] and not art["inplace"]["prefill"]


# ---------------------------------------------------------------------------
# manifest and CLI
# ---------------------------------------------------------------------------


def test_cli_check_passes_against_committed_baseline(capsys):
    assert audit_main(["--check"]) == 0
    assert "audit OK: 3 points" in capsys.readouterr().out


def test_cli_write_refuses_a_manifest_with_violations(tmp_path, monkeypatch, capsys):
    import repro_torch.audit.__main__ as cli

    bad = load_manifest(DEFAULT_BASELINE)
    bad["points"]["granite_weight"]["rules"]["multiplier_free"] = [
        {"rule": "multiplier_free", "primitive": "mm", "detail": "operands [(64, 64)]"}]
    monkeypatch.setattr(cli, "build_manifest", lambda points=None: bad)
    out = tmp_path / "baseline.json"
    assert audit_main(["--write", "--baseline", str(out)]) == 1
    assert not out.exists()
    assert "refusing to write" in capsys.readouterr().err


def test_diff_manifests_names_census_drift():
    base = load_manifest(DEFAULT_BASELINE)
    fresh = json.loads(json.dumps(base))
    census = fresh["points"]["granite_weight"]["census"]["decode"]
    census["mm"] = census.get("mm", 0) + 1
    census["lut_affine"] = 1
    assert diff_manifests(base, base) == []
    (line,) = diff_manifests(fresh, base)
    assert line.startswith("granite_weight/decode: op census drift:")
    assert "lut_affine 0->1 (+1)" in line and "mm " in line
