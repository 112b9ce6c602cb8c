"""``ExecCfg(linear_mode="onehot_mxu")`` against the JAX package, on the CPU.

The reference's one-hot branch (``repro/models/layers.py::_lut_apply``)
runs where its Pallas kernels are off: a one-hot of each code, an einsum
with the tables rounded to bf16 and fp32 accumulation, then the plane
scales and the bias.  The port's (``models/layers.py::_onehot_apply``)
runs where its kernels are off (``use_kernels=False``, the reference's
``use_pallas=False``).  Both packages get the same numpy weights and
inputs, the plan through ``plan_to_json``, the reference's converted
tables carried across (``params_from_numpy``), so that the outputs agree
to fp32 summation order: ONEHOT_TOL x max|reference|.

* ``linear`` on lone projections: fp16 plans at chunk 1 and 2 with fp32
  and fp16 tables, fixed-point plans with i8 tables and their narrow-table
  ``scale``, with and without a bias; a ``bitplane_shift`` plan, whose
  codes cannot feed a one-hot, gathers (equal to the standard mode's
  output bit for bit).
* ``fused_linears`` on a ``wq+wk+wv`` group with ``lut_grouped=True``: a
  fp16 plan does not fuse (no grouped launch; each member equal to its
  lone one-hot call bit for bit), a ``bitplane_shift`` plan fuses and
  equals the gather bit for bit.
* Row blocks: a one-hot built in blocks gives the unblocked result bit for
  bit (here; cuBLAS picks its reduction by the product's shape).
* Reduced granite_8b's converted logits, flat and grouped, on fixed-point
  8/6 chunk-2 plans with fp32 tables (every projection one-hot) and on a
  mix of chunk-1 i8 attention and the serving recipe's ``bitplane_shift``
  FFN (gathered), synchronized by
  ``tests/test_torch_dense_families.py``'s :class:`Tape`; on the same codes
  the one-hot logits differ from the gather's by the bf16 rounding of the
  tables, within ONEHOT_BF16_TOL in norm (0.21 % for ``fixed``, 0 for
  ``mixed``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import ModelPlan as JModelPlan
from repro.core.planner import plan_from_json as jplan_from_json
from repro.core.planner import plan_model as jplan_model
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.models.layers import fused_linears as jfused_linears
from repro.models.layers import linear as jlinear
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTGroup, LUTLinear
from repro_torch.core.planner import ModelPlan, plan_to_json
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx, ExecCfg, fused_linears, linear
from repro_torch.models.model import model_specs
from repro_torch.models.params import params_from_numpy
from test_torch_dense_families import TOKENS, Tape, _close, _jlogits, _logits, _recipe
from test_torch_moe import numpy_params

ONEHOT_TOL = 1e-5  # x max|reference|: the same bf16 products, fp32 sums in another order
# one-hot against the gather on the same codes: bf16 rounds each table entry
# by at most 2**-9 of itself (0.2 %), so 5x that, x max (a layer) or in norm
# (logits)
ONEHOT_BF16_TOL = 1e-2
Q, P = 24, 20

FP16 = {"kind": "float16", "signed": True}
FIXED = {"kind": "fixed", "total_bits": 8, "frac_bits": 6, "signed": True}
CASES = {
    "fp16-c1-fp32-bias": (dict(chunk_size=1, fmt=FP16, mode="bitplane"), None, True),
    "fp16-c2-fp16tab-bias": (dict(chunk_size=2, fmt=FP16, mode="bitplane"), "float16", True),
    "fp16-c2-fp32": (dict(chunk_size=2, fmt=FP16, mode="bitplane"), None, False),
    "fixed-c2-i8-bias": (dict(chunk_size=2, fmt=FIXED, mode="bitplane", table_format="i8"),
                         None, True),
    "fixed-c1-i8": (dict(chunk_size=1, fmt=FIXED, mode="bitplane", table_format="i8"),
                    None, False),
}
SHIFT = dict(chunk_size=1, fmt={**FP16, "mantissa_radix": 4}, mode="bitplane_shift",
             table_format="i8")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plan_json(q, p, chunk_size, fmt, mode, table_format=None):
    d = {"in_features": q, "out_features": p, "chunk_size": chunk_size, "fmt": fmt,
         "mode": mode, "out_bits": 16}
    if table_format is not None:
        d["table_format"] = table_format
    return d


def _converted(tree, plans: dict, groups=(), table_dtype=None):
    """The reference's conversion of the numpy ``tree`` under ``plans``
    (path -> plan JSON) and the same tables in the port's tree; the plans
    cross through ``plan_to_json``."""
    jm = JModelPlan({k: jplan_from_json(v) for k, v in plans.items()}, groups=groups)
    mplan = ModelPlan.from_json(jm.to_json())
    assert {k: plan_to_json(v) for k, v in mplan.layers.items()} == {
        k: v for k, v in jm.to_json()["layers"].items()}
    kw = {} if table_dtype is None else {"table_dtype": getattr(jnp, table_dtype)}
    jlut, _ = jconvert(jax.tree.map(jnp.asarray, tree), plan=jm, **kw)
    tlut = params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan)
    return jlut, tlut


def _lin(rng, q, p, bias):
    d = {"w": (rng.standard_normal((q, p)) / np.sqrt(q)).astype(np.float32)}
    if bias:
        d["b"] = (rng.standard_normal(p) * 0.1).astype(np.float32)
    return d


def _x(seed, q=Q):
    return (np.random.default_rng(seed).standard_normal((2, 3, q)) * 0.7).astype(np.float32)


def _ctxs(**kw):
    cfg, jcfg = get_config("granite_8b", reduced=True), jget_config("granite_8b", reduced=True)
    return (Ctx(cfg, ex=ExecCfg(remat="none", use_kernels=False, **kw)),
            JCtx(jcfg, ex=JExecCfg(remat="none", **kw)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_linear_matches_reference(case):
    plan, table_dtype, bias = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    tree = {"proj": _lin(rng, Q, P, bias)}
    jlut, tlut = _converted(tree, {"proj": _plan_json(Q, P, **plan)}, table_dtype=table_dtype)
    node = tlut["proj"]
    assert isinstance(node, LUTLinear) and (node.scale is not None) == ("table_format" in plan)
    x = _x(10)
    ctx, jctx = _ctxs(linear_mode="onehot_mxu")
    want = np.asarray(jlinear(jlut["proj"], jnp.asarray(x), jctx))
    got = linear(node, torch.from_numpy(x), ctx)
    assert got.dtype == torch.float32 and got.shape == (2, 3, P)
    _close(got, want, ONEHOT_TOL)
    # the gather on the same codes differs by the tables' bf16 rounding only
    gather = linear(node, torch.from_numpy(x), _ctxs()[0])
    if node.tables.dtype == torch.int8:  # i8 entries: bf16 holds them exactly
        _close(got, gather.numpy(), ONEHOT_TOL)
    else:
        assert not torch.equal(got, gather)
        _close(got, gather.numpy(), ONEHOT_BF16_TOL)


def test_shift_plan_gathers():
    """``bitplane_shift`` codes carry the exponent above the index bits: the
    one-hot mode gathers them, bit for bit the standard mode's output."""
    rng = np.random.default_rng(20)
    tree = {"proj": _lin(rng, Q, P, True)}
    jlut, tlut = _converted(tree, {"proj": _plan_json(Q, P, **SHIFT)})
    x = torch.from_numpy(_x(21))
    ctx, jctx = _ctxs(linear_mode="onehot_mxu")
    got = linear(tlut["proj"], x, ctx)
    assert torch.equal(got, linear(tlut["proj"], x, _ctxs()[0]))
    _close(got, np.asarray(jlinear(jlut["proj"], jnp.asarray(x.numpy()), jctx)), ONEHOT_TOL)


@pytest.fixture
def grouped_launches(monkeypatch):
    """Counts ``lut_affine_grouped`` calls made by ``models/layers.py``."""
    calls = []
    fn = L.lut_affine_grouped

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(L, "lut_affine_grouped", spy)
    return calls


@pytest.mark.parametrize("kind", ["fp16", "shift"])
def test_group_fuses_only_on_shift_plans(kind, grouped_launches):
    plan = dict(chunk_size=2, fmt=FP16, mode="bitplane") if kind == "fp16" else SHIFT
    rng = np.random.default_rng(30)
    names = ("wq", "wk", "wv")
    tree = {"blk": {n: _lin(rng, Q, P, True) for n in names}}
    plans = {f"blk/{n}": _plan_json(Q, P, **plan) for n in names}
    jlut, tlut = _converted(tree, plans, groups=(tuple(f"blk/{n}" for n in names),))
    node = tlut["blk"]["wq+wk+wv"]
    assert isinstance(node, LUTGroup)
    x = torch.from_numpy(_x(31))
    ctx, jctx = _ctxs(linear_mode="onehot_mxu", lut_grouped=True)
    got = fused_linears(tlut["blk"], names, x, ctx)
    want = jfused_linears(jlut["blk"], names, jnp.asarray(x.numpy()), jctx)
    for a, b in zip(got, want):
        _close(a, np.asarray(b), ONEHOT_TOL)
    if kind == "fp16":  # no fusion: each member is its lone one-hot call
        assert grouped_launches == []
        lone = _ctxs(linear_mode="onehot_mxu")[0]
        for g, a in enumerate(got):
            b = L._lut_apply(node.tables[g], node.member_bias(g), node.plan, x, lone,
                             scale=node.scale)
            assert torch.equal(a, b)
    else:  # fused, and equal to the standard mode's grouped gather
        assert grouped_launches == [1]
        base = fused_linears(tlut["blk"], names, x, _ctxs(lut_grouped=True)[0])
        assert grouped_launches == [1, 1]
        assert all(torch.equal(a, b) for a, b in zip(got, base))


def test_row_blocks_are_bit_exact(monkeypatch):
    """A one-hot built in row blocks of 4 rows (the last padded) gives the
    one-block result bit for bit on the CPU (on the card to fp32 summation
    order: ``tests/test_torch_kernels_cuda.py``)."""
    rng = np.random.default_rng(40)
    tree = {"proj": _lin(rng, Q, P, True)}
    _, tlut = _converted(tree, {"proj": _plan_json(Q, P, 2, FP16, "bitplane")})
    node = tlut["proj"]
    x = torch.from_numpy(np.random.default_rng(41).standard_normal((11, Q)).astype(np.float32))
    ctx = _ctxs(linear_mode="onehot_mxu")[0]
    whole = linear(node, x, ctx)
    n, k, E = node.plan.num_planes, node.plan.num_chunks, node.plan.num_entries
    monkeypatch.setattr(L, "_ONEHOT_BYTES", 4 * n * k * E * 4)
    assert torch.equal(linear(node, x, ctx), whole)


def _granite_plans(jp) -> dict:
    """Plan JSONs over reduced granite_8b's projections: ``fixed``, every
    projection fixed-point 8/6 at chunk 2 with fp32 tables (one-hot
    throughout, its bf16 rounding visible); ``mixed``, attention at chunk 1
    with i8 tables (exact in bf16) and the FFN on the serving recipe's
    ``bitplane_shift`` plans (gathered)."""
    uniform = jplan_model(jp, float("inf"), max_chunk=2).to_json()
    recipe = _recipe(jp, jplan_model).to_json()
    fixed = {k: _plan_json(v["in_features"], v["out_features"], 2, FIXED, "bitplane")
             for k, v in uniform["layers"].items()}
    mixed = {k: (_plan_json(v["in_features"], v["out_features"], 1, FIXED, "bitplane", "i8")
                 if "/attn/" in k else recipe["layers"][k])
             for k, v in uniform["layers"].items()}
    mixed_groups = ([g for g in uniform["groups"] if "/attn/" in g[0]]
                    + [g for g in recipe["groups"] if "/ffn/" in g[0]])
    return {"fixed": (fixed, uniform["groups"]), "mixed": (mixed, mixed_groups)}


@pytest.fixture(scope="module")
def granite():
    jcfg = jget_config("granite_8b", reduced=True)
    cfg = get_config("granite_8b", reduced=True)
    tree = numpy_params(model_specs(cfg), 71)
    trees = {}
    for name, (plans, groups) in _granite_plans(jax.tree.map(jnp.asarray, tree)).items():
        jlut, tlut = _converted(tree, plans, groups=tuple(map(tuple, groups)))
        trees[name] = (jlut, tlut, ModelPlan.from_json({"layers": plans, "groups": groups}))
    return jcfg, cfg, trees


@pytest.mark.parametrize("plan", ["fixed", "mixed"])
def test_granite_logits_match_reference(granite, plan):
    jcfg, cfg, trees = granite
    jlut, tlut, mplan = trees[plan]
    shifted = sum(p.mode == "bitplane_shift" for p in mplan.layers.values())
    assert (shifted == 0) == (plan == "fixed") and shifted < len(mplan.layers)
    assert mplan.groups
    jctx = JCtx(jcfg, ex=JExecCfg(remat="none", linear_mode="onehot_mxu"))
    tape = Tape()
    with tape.record():
        want = _jlogits(jlut, jctx)
    sites = tape.sites

    def replayed(check=True, **ex):
        tape = Tape()
        tape.sites = sites
        with tape.replay():
            got = _logits(tlut, Ctx(cfg, ex=ExecCfg(remat="none", use_kernels=False, **ex)))
        if check:
            tape.check()
        return got

    for grouped in (False, True):
        got = replayed(linear_mode="onehot_mxu", lut_grouped=grouped)
        _close(got, want, ONEHOT_TOL)
    # the gather on the same codes at every site (its own inputs there
    # differ): apart by the bf16 rounding
    gather = replayed(check=False)
    if plan == "fixed":
        assert not torch.equal(got, gather)
    fro = float(torch.linalg.norm(got - gather) / torch.linalg.norm(gather))
    assert fro <= ONEHOT_BF16_TOL, fro
