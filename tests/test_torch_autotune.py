"""The port's autotuner (``repro_torch.kernels.lut_affine.autotune``)
against the JAX package's, on the CPU.

The point, the plan field, the JSON and the CLI are the reference's: the
port's ``TunePoint``s equal the reference's field for field on the same
plans of reduced granite_8b (weight recipe and TL1), and a Hopper-tuned
plan's JSON round-trips through both packages' ``ModelPlan``.  The tiles
differ by design (Pallas grid tiles under a VMEM budget there, the Hopper
kernels' compiled tiles and k splits here): the reference's TPU tiles trip
the port's ``blocks_over_smem`` and make each of the five wrappers raise
``ValueError`` on the plain path, as on the card.  Then the analytic
search's determinism (only points that fit one row tile of the decode or
TL1 kernel are tuned), the cost fit (``benchmarks/fit_autotune_cost.py``),
the baseline's write / check / drift cycle and the committed baseline, the
tiling rules obeying tiles on a dispatch that fits one row tile of the
kernel they name and keeping the shape rule on every other (prefills of
2,432 rows among them), the memoised legality check, and ``measured``
raising without a card.
"""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.audit import points as jpoints
from repro.configs.base import get_config as jget_config
from repro.core.planner import ModelPlan as JModelPlan
from repro.core.planner import plan_model as jplan_model
from repro.kernels.lut_affine import autotune as jat
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import abstract_params as jabstract_params
from repro_torch.audit import AUDIT_POINTS, plan_consistency_violations
from repro_torch.audit.points import build_point
from repro_torch.benchmarks import fit_autotune_cost
from repro_torch.configs.base import get_config
from repro_torch.core.convert import convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.kernels.lut_affine import autotune
from repro_torch.kernels.lut_affine import ops
from repro_torch.kernels.lut_affine.autotune import (
    TunePoint,
    analytic_cost,
    attach_tuned_blocks,
    blocks_fit_smem,
    candidate_blocks,
    check_baseline,
    points_from_model_plan,
    search_blocks,
    write_baseline,
)
from repro_torch.kernels.lut_tl1 import ops as tl1_ops
from repro_torch.models.model import model_specs
from repro_torch.models.params import params_from_numpy, tree_map

TPU_TILES = (8, 128, 64)  # a tiling the reference's autotune picks
RECIPE = dict(modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
              table_formats=(None, "i8"))
SMS = 132


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops only: one intra-op thread keeps them off the other test
    workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _recipe(plan_fn, params, family):
    """The serving recipe's weight plan (``serving_model_plan``) or the TL1
    plan (``serving_tl1_plan``), before tiles."""
    if family == "tl1":
        return plan_fn(params, float("inf"), families=("tl1",))
    uniform = plan_fn(params, float("inf"), max_chunk=2)
    return plan_fn(params, uniform.total_lut_bytes // 2, max_chunk=2, **RECIPE)


@pytest.fixture(scope="module")
def granite():
    """Reduced granite_8b weights drawn from a seed with numpy, in both
    packages, and both packages' plans of them per family."""
    cfg = jget_config("granite_8b", reduced=True)
    rng = np.random.default_rng(5)
    weights = jax.tree.map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(s.dtype),
        jabstract_params(jmodel_specs(cfg)),
    )
    jp = jax.tree.map(jnp.asarray, weights)
    tp = params_from_numpy(weights, device="cpu")
    plans = {f: (_recipe(jplan_model, jp, f), _recipe(plan_model, tp, f))
             for f in ("weight", "tl1")}
    return {"tp": tp, "plans": plans}


def _main_path_plans():
    """The main path's plans at full-width granite_8b (one layer: the points
    do not depend on depth), on shapes alone."""
    full = get_config("granite_8b")
    cfg = dataclasses.replace(full, num_layers=1)
    meta = tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype or torch.float32, device="meta"),
        model_specs(cfg),
    )
    return [_recipe(plan_model, meta, f) for f in ("weight", "tl1")]


def _strip(d: dict) -> dict:
    """A plan's JSON without the tiles (they differ by design)."""
    return {**d, "layers": {k: {n: v for n, v in e.items() if n != "blocks"}
                            for k, e in d["layers"].items()}}


# ---------------------------------------------------------------------------
# the point, the plan field, the JSON
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["weight", "tl1"])
def test_tune_points_match_reference(granite, family):
    jm, tm = granite["plans"][family]
    assert tm.to_json() == jm.to_json()
    for batch in (1, 4):
        got = [pt.to_json() for pt in points_from_model_plan(tm, batch)]
        want = [pt.to_json() for pt in jat.points_from_model_plan(jm, batch)]
        assert got == want and got
        for row in got:
            assert TunePoint.from_json(row).to_json() == jat.TunePoint.from_json(row).to_json()
    sizes = autotune._group_sizes(tm)
    for key, plan in tm.layers.items():
        got = TunePoint.from_plan(plan, 4, G=sizes.get(key, 1))
        want = jat.TunePoint.from_plan(jm.layers[key], 4, G=sizes.get(key, 1))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("family", ["weight", "tl1"])
def test_attach_sets_every_layer_and_groups_share(granite, family):
    _, tm = granite["plans"][family]
    tuned = attach_tuned_blocks(tm, 4)
    sizes = autotune._group_sizes(tm)
    assert tuned.layers.keys() == tm.layers.keys() and tuned.groups == tm.groups
    for key, plan in tuned.layers.items():
        pt = TunePoint.from_plan(plan, 4, G=sizes.get(key, 1))
        assert plan.blocks == search_blocks(pt) and plan.blocks in candidate_blocks(pt)
        assert dataclasses.replace(plan, blocks=None) == tm.layers[key]
    assert tm.groups
    for group in tuned.groups:
        assert all(tuned.layers[k] == tuned.layers[group[0]] for k in group)
    assert plan_consistency_violations(tuned, _convert(granite["tp"], tuned), batch=4) == []


@pytest.mark.parametrize("family", ["weight", "tl1"])
def test_tuned_plan_json_round_trips_both_packages(granite, family):
    _, tm = granite["plans"][family]
    d = attach_tuned_blocks(tm, 4).to_json()
    assert all(e["blocks"] for e in d["layers"].values())
    assert ModelPlan.from_json(d).to_json() == d == JModelPlan.from_json(d).to_json()
    # the reference tunes the same point to its own TPU tiles
    jd = jat.attach_tuned_blocks(JModelPlan.from_json(tm.to_json()), 4).to_json()
    assert _strip(jd) == _strip(d) and jd != d


def test_audit_points_match_reference_without_tiles():
    """Both packages' ``build_point`` attach tiles at the point's batch: the
    plans equal with the tiles stripped, and their points equal."""
    pt = AUDIT_POINTS[0]
    art = build_point(pt)
    mine, ref = art["mplan"], jpoints.build_point(jpoints.AUDIT_POINTS[0])["mplan"]
    assert _strip(mine.to_json()) == _strip(ref.to_json())
    assert all(p.blocks for p in mine.layers.values())
    assert [p.to_json() for p in points_from_model_plan(mine, pt.batch)] == [
        p.to_json() for p in jat.points_from_model_plan(ref, pt.batch)]
    assert plan_consistency_violations(mine, art["template"], batch=pt.batch) == []


# ---------------------------------------------------------------------------
# the reference's TPU tiles are refused
# ---------------------------------------------------------------------------


def _convert(tp, mplan):
    lut, _ = convert_params(tp, plan=mplan, table_dtype=torch.float16)
    return lut


@pytest.mark.parametrize("family", ["weight", "tl1"])
def test_tpu_tiles_trip_blocks_over_smem(granite, family):
    _, tm = granite["plans"][family]
    tpu = dataclasses.replace(tm, layers={
        k: dataclasses.replace(p, blocks=TPU_TILES) for k, p in tm.layers.items()})
    hits = plan_consistency_violations(tpu, _convert(granite["tp"], tpu), batch=4)
    assert {(v.rule, v.primitive) for v in hits} == {("plan_consistency", "blocks_over_smem")}
    assert sorted(v.detail.split("'")[1] for v in hits) == sorted(tm.layers)
    assert all(str(TPU_TILES) in v.detail and "TunePoint(" in v.detail for v in hits)


def _wrapper_calls(blocks):
    """Each of the five wrappers on small CPU operands under ``blocks``."""
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 32, (4, 3, 40)).astype(np.int32))
    tables = torch.from_numpy(rng.integers(-127, 128, (2, 40, 32, 96)).astype(np.int8))
    gs = torch.tensor([1, 0, 3])
    etables = torch.from_numpy(rng.integers(-127, 128, (3, 2, 40, 32, 96)).astype(np.int8))
    acts = torch.from_numpy(rng.integers(-127, 128, (4, 160)).astype(np.int32))
    nibbles = rng.integers(0, 9, (2, 2, 40, 1030))  # two base-3 pair indices a byte
    packed = torch.from_numpy((nibbles[0] + 16 * nibbles[1]).astype(np.uint8))
    s = [1.0, -2.0, 0.5]
    return {
        "lut_affine": lambda: ops.lut_affine(codes, tables[0], s, blocks=blocks),
        "lut_affine_grouped": lambda: ops.lut_affine_grouped(codes, tables, s, blocks=blocks),
        "lut_affine_experts": lambda: ops.lut_affine_experts(codes, etables, s, gs,
                                                             blocks=blocks),
        "lut_tl1": lambda: tl1_ops.lut_tl1(acts, packed[0], blocks=blocks),
        "lut_tl1_grouped": lambda: tl1_ops.lut_tl1_grouped(acts, packed, blocks=blocks),
    }


WRAPPERS = list(_wrapper_calls(None))


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_refuse_tpu_tiles(name):
    with pytest.raises(ValueError, match=r"blocks \(8, 128, 64\) are not a legal Hopper "
                                         r"tiling at point TunePoint\("):
        _wrapper_calls(TPU_TILES)[name]()


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_take_legal_tiles_on_the_plain_path(name):
    """A legal tiling passes the check, and the plain version ignores it."""
    tl1 = name.startswith("lut_tl1")
    blocks = (4, 1024, 8) if tl1 else (4, 512, 8)
    want = _wrapper_calls(None)[name]()
    assert torch.equal(_wrapper_calls(blocks)[name](), want)
    # the same tiling with block_k past k, or on a row tile no kernel has
    for bad in ((blocks[0], blocks[1], 41), (3, blocks[1], 8)):
        with pytest.raises(ValueError, match="not a legal Hopper tiling"):
            _wrapper_calls(bad)[name]()


# ---------------------------------------------------------------------------
# candidates, legality, the cost model and its search
# ---------------------------------------------------------------------------


POINTS = [
    TunePoint(B=4, k=4096, entries=32, p=4096, n=3, table_bytes=1),  # wq
    TunePoint(B=4, k=14336, entries=32, p=4096, n=3, table_bytes=1),  # w_down
    TunePoint(B=128, k=96, entries=32, p=300, n=3, G=2, table_bytes=1),  # prefill
    TunePoint(B=8, k=4, entries=65536, p=128, n=11, table_bytes=4),  # wide tables, 4 tiles
    TunePoint(B=2, k=4, entries=65536, p=128, n=11, table_bytes=4),  # the same, one tile
    TunePoint(B=2, k=64, entries=32, p=64, n=3, table_bytes=1),
    TunePoint(B=4, k=2048, entries=1024, p=4096, n=3, table_bytes=1),  # chunk 2
    TunePoint(B=4, k=1024, entries=9, p=1024, n=1, G=2, table_bytes=1, family="tl1"),
    TunePoint(B=8, k=1024, entries=9, p=14336, n=1, G=2, table_bytes=1, family="tl1"),
    TunePoint(B=40, k=3584, entries=9, p=4096, n=1, table_bytes=1, family="tl1"),
]
TUNABLE = [pt for pt in POINTS if autotune.tunable(pt)]


def _wave_splits(pt):
    """The shape rule's splits and those filling one wave on 132 SMs, from
    the kernels' tiles."""
    if pt.family == "tl1":
        tiles = pt.G * -(-pt.B // tl1_ops.tile_rows(pt.B)) * -(-pt.p // 1024)
        slots = 3 * SMS
        rule = tl1_ops.k_splits(pt.G, pt.B, pt.k, pt.p, SMS)
    else:
        t = ops.tiling(pt.G, pt.B, pt.n, pt.k, pt.entries, pt.p * pt.table_bytes, SMS)
        tiles, slots, rule = t.tiles, ops.BLOCKS_PER_SM[t.regime] * SMS, t.splits
    return [s for s in (rule, slots // tiles) if s >= 1]


def _pid(pt):
    return f"{pt.family}-B{pt.B}-k{pt.k}-E{pt.entries}"


@pytest.mark.parametrize("pt", POINTS, ids=_pid)
def test_candidates_are_legal_on_the_point_kernel(pt):
    rows, cols = autotune.point_rows(pt), autotune.point_cols(pt)
    cands = candidate_blocks(pt)
    one_tile = pt.B <= rows
    prefill = autotune.point_kernels(pt)[rows] == "prefill"
    assert autotune.tunable(pt) == (one_tile and not prefill)
    if not autotune.tunable(pt):
        # tiles would not govern its dispatch (or the model has no term for
        # its kernel): no candidates, no tiles
        assert cands == [] and search_blocks(pt) is None
    else:
        bks = [bk for _, _, bk in cands]
        powers = {1 << i for i in range(pt.k.bit_length()) if 1 << i <= pt.k}
        waves = {-(-pt.k // min(s, pt.k)) for s in _wave_splits(pt)}
        assert bks == sorted(powers | waves | {pt.k})
        for blk in cands:
            assert blocks_fit_smem(pt, blk) and blk[:2] == (rows, cols)
    # legality is the kernel's, tuned or not
    assert blocks_fit_smem(pt, (rows, cols, 1)) and blocks_fit_smem(pt, (rows, cols, pt.k))
    assert not blocks_fit_smem(pt, (rows, cols, 0))
    assert not blocks_fit_smem(pt, (rows, cols, pt.k + 1))
    assert not blocks_fit_smem(pt, (rows, cols * 2, 1))
    assert not blocks_fit_smem(pt, TPU_TILES)
    if pt.family == "weight":
        want = 64 if pt.B * pt.n >= pt.entries and pt.entries <= 64 else min(4, 32 // pt.n)
        assert rows == want and cols == 512 // pt.table_bytes
    else:
        assert (rows, cols) == (tl1_ops.tile_rows(pt.B), 1024)


def test_smem_mirrors_the_source_rules():
    # decode_kernel needs at most 24 KB; prefill at most ~121 KB (E = 64)
    assert max(autotune.decode_smem(n) for n in range(1, 33)) == 24 * 1024
    assert autotune.decode_smem(3) == 24 * 1024 and autotune.decode_smem(32) == 24576
    assert autotune.prefill_smem(3, 64) == 128 + 3 * (64 * 512 + 16) + 16 * 64 * 3 * 8
    assert max(autotune.prefill_smem(n, E) for n in range(1, 33)
               for E in (1, 2, 8, 16, 32, 64)) <= 121 * 1024 <= autotune.MAX_SMEM
    assert autotune.MAX_SMEM == 200 * 1024


@pytest.mark.parametrize("pt", TUNABLE, ids=_pid)
def test_analytic_search_is_deterministic(pt):
    winners = {search_blocks(pt, mode="analytic") for _ in range(3)}
    assert len(winners) == 1
    blk = winners.pop()
    assert blk in candidate_blocks(pt)
    costs = {c: analytic_cost(pt, c) for c in candidate_blocks(pt)}
    assert costs[blk] == min(costs.values()) and min(costs.values()) > 0
    assert blk == min(c for c in costs if costs[c] == costs[blk])


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown autotune mode"):
        search_blocks(POINTS[0], mode="wallclock")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_measured_raises_without_a_gpu():
    with pytest.raises(RuntimeError, match="measured.*CUDA device"):
        search_blocks(POINTS[4], mode="measured")
    with pytest.raises(RuntimeError, match="CUDA device"):
        attach_tuned_blocks(_main_path_plans()[1], 4, mode="measured")


def test_analytic_cost_has_no_prefill_term():
    pt = POINTS[2]
    with pytest.raises(ValueError, match="no term for the prefill kernel"):
        analytic_cost(pt, (64, 512, 8))


def test_cost_fit_recovers_its_constants():
    """Samples made by the model with known constants give them back."""
    truth = {"launch": 3.0, "chunk_decode": 0.24, "chunk_tl1": 0.3, "bytes": 1 / 2.9e6,
             "partial": 1 / 2.2e6, "sum": 0.2, "launch_tl1": 4.0, "partial_tl1": 1 / 1.5e6,
             "sum_tl1": 0.1}
    assert truth.keys() == autotune.COST.keys()
    samples = [(pt, blk, analytic_cost(pt, blk, truth) * 1e-6)
               for pt in TUNABLE for blk in candidate_blocks(pt)]
    got = fit_autotune_cost.fit_cost(samples)
    for name, want in truth.items():
        assert got[name] == pytest.approx(want, rel=1e-6), name


# ---------------------------------------------------------------------------
# the tiling rules: tiles in their regime, the shape rule outside it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sms", [132, 114])
def test_dense_tiling_obeys_tiles_in_their_regime(sms):
    wq = dict(G=1, n=3, k=4096, E=32, row_bytes=4096, sms=sms)
    rule = ops.tiling(B=4, **wq)
    assert (rule.regime, rule.rows, rule.splits) == ("decode", 4, 2 * sms // 8)
    assert ops.tiling(B=4, blocks=(4, 512, 128), **wq).splits == 32
    assert ops.tiling(B=4, blocks=(4, 512, 4096), **wq).splits == 1
    assert ops.tiling(B=4, blocks=(4, 512, 1), **wq).splits == 4096
    assert ops.tiling(B=1, blocks=(4, 512, 128), **wq).splits == 32
    # tiles naming the prefill kernel leave a decode dispatch to the rule
    assert ops.tiling(B=4, blocks=(64, 512, 128), **wq) == rule
    # a dispatch of more rows than one tile keeps the shape rule, bit for bit:
    # 8 rows on the decode kernel, and prefills under decode tiles ...
    assert ops.tiling(B=8, blocks=(4, 512, 128), **wq) == ops.tiling(B=8, **wq)
    for B in (128, 2432):
        pre = ops.tiling(B=B, **wq)
        assert pre.regime == "prefill"
        assert ops.tiling(B=B, blocks=(4, 512, 128), **wq) == pre
        # ... and under tiles of their own kernel past its 64 rows
        assert ops.tiling(B=B, blocks=(64, 512, 256), **wq) == pre
    # a prefill of one 64-row tile obeys tiles that name its kernel
    assert ops.tiling(B=64, blocks=(64, 512, 256), **wq).splits == 16
    # E > 64: every batch runs the decode kernel; only its 4-row dispatches obey
    wide = dict(wq, E=128)
    assert ops.tiling(B=4, blocks=(4, 512, 512), **wide).splits == 8
    assert ops.tiling(B=128, blocks=(4, 512, 512), **wide) == ops.tiling(B=128, **wide)


@pytest.mark.parametrize("sms", [132, 114])
def test_tiles_tuned_at_decode_never_govern_a_2432_row_prefill(sms):
    """A chunk-2 layer (1024 entries: the decode kernel at every batch) tuned
    at 4 rows, and a TL1 plan tuned at an 8-slot engine's batch (``tile_rows``
    8 at every batch past 4), dispatched at a 2,432-row VLM prefill: the
    shape rule's splits, so its partials."""
    wq2 = TunePoint(B=4, k=2048, entries=1024, p=4096, n=3, table_bytes=1)
    blocks = search_blocks(wq2)
    assert blocks is not None and blocks[0] == 4
    shape = dict(G=1, n=3, k=2048, E=1024, row_bytes=4096, sms=sms)
    assert ops.tiling(B=4, blocks=blocks, **shape).splits == -(-2048 // blocks[2])
    pre = ops.tiling(B=2432, **shape)
    assert pre.regime == "decode" and ops.tiling(B=2432, blocks=blocks, **shape) == pre
    assert pre.splits == 1  # 608 row tiles x 8 slabs fill the card unsplit
    tl1 = attach_tuned_blocks(_main_path_plans()[1], 8)
    sizes = autotune._group_sizes(tl1)
    for key, plan in tl1.layers.items():
        G, kb, p = sizes.get(key, 1), plan.packed_chunks, plan.out_features
        assert plan.blocks[0] == 8
        assert tl1_ops.k_splits(G, 8, kb, p, sms, plan.blocks) == -(-kb // plan.blocks[2])
        for B in (9, 128, 2432):
            rule = tl1_ops.k_splits(G, B, kb, p, sms)
            assert tl1_ops.k_splits(G, B, kb, p, sms, plan.blocks) == rule


@pytest.mark.parametrize("family", ["weight", "tl1"])
def test_points_past_one_row_tile_are_not_tuned(family):
    """At an 8-slot engine's batch the main path's dense points span two
    4-row decode tiles, so tiles could never govern them: none attached;
    TL1's 8-row kernel holds the batch in one tile, so each gets its own."""
    mp = _main_path_plans()[family == "tl1"]
    tuned = attach_tuned_blocks(mp, 8)
    blocks = {p.blocks for p in tuned.layers.values()}
    if family == "weight":
        assert blocks == {None}
    else:
        assert None not in blocks and {b[:2] for b in blocks} == {(8, 1024)}


@pytest.mark.parametrize("sms", [132, 114])
def test_experts_tiling_keeps_the_shape_rule(sms):
    """The ragged kernel's grid depends on its shapes alone: its plan's
    tiles are checked and never govern it."""
    gate_up = dict(G=2, k=2048, row_bytes=1408, sms=sms)
    dec = ops.experts_tiling(T=16, **gate_up)
    assert dec.tiles == 2 * 4 * 3 and dec.splits == min(2048, 2 * sms // dec.tiles) > 1
    pre = ops.experts_tiling(T=512, **gate_up)
    assert pre.splits == 1
    with pytest.raises(TypeError):
        ops.experts_tiling(T=16, blocks=(4, 512, 256), **gate_up)


@pytest.mark.parametrize("sms", [132, 114])
def test_tl1_splits_obey_tiles_in_their_regime(sms):
    assert tl1_ops.k_splits(1, 4, 1024, 4096, 132) == 64
    assert tl1_ops.k_splits(1, 4, 1024, 4096, sms, blocks=(4, 1024, 32)) == 32
    assert tl1_ops.k_splits(1, 4, 1024, 4096, sms, blocks=(4, 1024, 1)) == 1024
    assert tl1_ops.k_splits(1, 4, 1024, 4096, sms, blocks=(4, 1024, 1024)) == 1
    for B in (5, 128, 2432):  # 8-row dispatches keep the rule under 4-row tiles
        rule = tl1_ops.k_splits(2, B, 1024, 14336, sms)
        assert tl1_ops.k_splits(2, B, 1024, 14336, sms, blocks=(4, 1024, 16)) == rule
    # 8-row tiles govern the dispatches one 8-row tile holds, and no more
    assert tl1_ops.k_splits(2, 5, 1024, 14336, sms, blocks=(8, 1024, 16)) == 64
    for B in (9, 128, 2432):
        rule = tl1_ops.k_splits(2, B, 1024, 14336, sms)
        assert tl1_ops.k_splits(2, B, 1024, 14336, sms, blocks=(8, 1024, 16)) == rule


@pytest.mark.parametrize("name", WRAPPERS)
def test_legal_tiles_are_checked_once_per_shape(name, monkeypatch):
    """A legal verdict is kept per shape and tiling: a served step pays a
    lookup, not a fresh check; an illegal tiling is refused at every
    call."""
    tl1 = name.startswith("lut_tl1")
    blocks = (4, 1024, 7) if tl1 else (4, 512, 7)
    calls = []
    real = autotune.blocks_fit_smem

    def counted(pt, blk):
        calls.append(blk)
        return real(pt, blk)

    monkeypatch.setattr(autotune, "blocks_fit_smem", counted)
    (tl1_ops if tl1 else ops).LEGAL_BLOCKS.clear()
    run = _wrapper_calls(blocks)[name]
    run(), run(), run()
    assert calls == [blocks]
    bad = _wrapper_calls((3, blocks[1], 7))[name]
    for _ in range(2):
        with pytest.raises(ValueError, match="not a legal Hopper tiling"):
            bad()


# ---------------------------------------------------------------------------
# the baseline and the CLI
# ---------------------------------------------------------------------------


def test_write_check_and_drift(tmp_path, granite):
    path = tmp_path / "autotune.json"
    points = points_from_model_plan(granite["plans"]["weight"][1], 4)
    payload = write_baseline(path, points)
    assert payload["mode"] == "analytic" and len(payload["points"]) == len(points)
    assert check_baseline(path) == []
    assert autotune.main(["check", "--baseline", str(path)]) == 0
    payload["points"][0]["blocks"][2] += 1
    path.write_text(json.dumps(payload))
    errs = check_baseline(path)
    assert len(errs) == 1 and "re-search found" in errs[0]
    assert autotune.main(["check", "--baseline", str(path)]) == 1
    # write without --plan refreshes the recorded points' winners
    assert autotune.main(["write", "--baseline", str(path)]) == 0
    assert check_baseline(path) == []
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(granite["plans"]["tl1"][1].to_json()))
    assert autotune.main(["write", "--baseline", str(path), "--plan", str(plan),
                          "--batch", "4"]) == 0
    rows = json.loads(path.read_text())["points"]
    assert {r["family"] for r in rows} == {"tl1"} and all(r["B"] == 4 for r in rows)


def test_committed_baseline_is_the_main_path_without_drift():
    assert check_baseline(autotune.BASELINE) == []
    rows = json.loads(autotune.BASELINE.read_text())
    want = [pt for mp in _main_path_plans() for pt in points_from_model_plan(mp, 4)]
    assert [TunePoint.from_json(r) for r in rows["points"]] == want
    assert rows["mode"] == "analytic"


def test_fit_reads_the_chip_log(tmp_path, capsys):
    """``benchmarks/fit_autotune_cost.py`` reads the autotune phase's
    ``point`` lines (dense and TL1; not the ragged kernel's) and recovers
    the constants that made them."""
    truth = dict(autotune.COST, launch=2.5, bytes=1 / 3.1e6)
    lines = ["NVIDIA H100 80GB HBM3, 700.00 W"]
    for pt in TUNABLE:
        times = {str(b[2]): analytic_cost(pt, b, truth) * 1e-3 for b in candidate_blocks(pt)}
        lines.append(json.dumps({"phase": "autotune", "step": "point", "kernel": None,
                                 "point": pt.to_json(), "candidate_ms": times}))
    lines.append(json.dumps({"phase": "autotune", "step": "point",
                             "kernel": "lut_affine_experts", "point": POINTS[0].to_json(),
                             "candidate_ms": {"1": 1.0}}))
    samples = fit_autotune_cost.samples_from_log(lines)
    assert len(samples) == sum(len(candidate_blocks(pt)) for pt in POINTS)
    log = tmp_path / "smoke.jsonl"
    log.write_text("\n".join(lines) + "\n")
    assert fit_autotune_cost.main([str(log)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["samples"] == len(samples)
    for name in ("launch", "bytes", "chunk_decode"):
        assert got["fitted"][name] == pytest.approx(truth[name], rel=1e-6), name


def test_cli_check_passes():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.lut_affine.autotune", "check"],
        capture_output=True, text=True, check=False,
    )
    assert out.returncode == 0, out.stderr
    assert "autotune baseline OK: 8 points re-searched, no drift" in out.stdout
