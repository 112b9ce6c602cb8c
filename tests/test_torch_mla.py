"""minicpm3_4b's MLA attention and latent KV cache in the port against the
JAX package's, on the CPU: reduced minicpm3_4b, fp32 weights from a numpy
seed (random norm scales) carried across by ``params_from_numpy``.

* ``mla_attention`` without a cache within 1e-5 x max of the reference's
  (fp32 sums in another order); the spec tree and the cache layouts leaf
  for leaf.
* ``update_mla_cache`` bit for bit with the reference's: the dense ``S ==
  T`` fresh-row fast path (gated on a pre-write index of 0) and the
  scatter, masked and overflowing, and the paged write and view through
  the page routing (an unmapped page, a slot past capacity, masked
  tokens).  The GQA fast path, now written by the same helper, bit for bit
  too.  bf16 pools, fp32 writes.
* The serving recipe's plan of the tree with ``wk_b``/``wv_b`` vetoed
  (``mla_convertible``) equals the reference's through its JSON; converted
  (the reference's tables carried across, and the port's own conversion),
  ``generate`` streams equal the reference's, dense and paged at
  ``page_size=4``, and ``BatchingEngine`` streams too, with prefix sharing
  and a copy-on-write hit (greedy, compared whole: tolerance none).
* A tree whose ``wk_b`` was converted raises ``ValueError`` naming the
  veto (the reference fails there with a ``TypeError``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.models.layers import mla_attention as j_mla_attention
from repro.models.model import model_specs as jmodel_specs
from repro.serve import BatchingEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import generate as jgenerate
from repro.serve._cache import advance_meta as j_advance_meta
from repro.serve._cache import cache_specs as j_cache_specs
from repro.serve._cache import update_kv_cache as j_update_kv_cache
from repro.serve._cache import update_mla_cache as j_update_mla_cache
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTLinear, convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.models.layers import (
    MLA_RAW_WEIGHTS,
    Ctx,
    ExecCfg,
    mla_attention,
    mla_convertible,
)
from repro_torch.models.model import model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import (
    BatchingEngine,
    Request,
    advance_meta,
    cache_specs,
    generate,
    update_kv_cache,
    update_mla_cache,
)
from test_torch_moe import numpy_params
from test_torch_paged_cache import PROMPTS, ROUTES, _route, _same

ATTN_TOL = 1e-5  # x max|reference|: fp32 sums in another order
B, T = 3, 8
SLOTS, MAX_LEN, MAX_NEW = 3, 32, 6
GEN_PROMPT = np.asarray([[5, 9, 2, 7, 1]], np.int32)


def _recipe(params, plan_fn):
    """The serving recipe (``benchmarks/serving.py::serving_model_plan``)
    with the latent up-projections vetoed (the port's predicate serves both
    packages' planners)."""
    uniform = plan_fn(params, float("inf"), max_chunk=2, predicate=mla_convertible)
    return plan_fn(params, uniform.total_lut_bytes // 2, max_chunk=2,
                   modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                   table_formats=(None, "i8"), predicate=mla_convertible)


@pytest.fixture(scope="module")
def world():
    jcfg = jget_config("minicpm3_4b", reduced=True)
    cfg = get_config("minicpm3_4b", reduced=True)
    tree = numpy_params(model_specs(cfg), 41)
    rng = np.random.default_rng(42)
    for name in ("q_norm", "kv_norm"):
        s = tree["blocks"]["attn"][name]["scale"]
        tree["blocks"]["attn"][name]["scale"] = (1 + 0.2 * rng.standard_normal(s.shape)).astype(
            np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    jm = _recipe(jp, jplan_model)
    jlut, _ = jconvert(jp, plan=jm, predicate=mla_convertible)
    mplan = ModelPlan.from_json(jm.to_json())
    jctx = JCtx(jcfg, ex=JExecCfg(remat="none"))
    gen = {ps: np.asarray(jgenerate(jlut, jctx, jnp.asarray(GEN_PROMPT), max_new=6, max_len=16,
                                    page_size=ps)) for ps in (None, 4)}
    return dict(
        jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jm=jm, jlut=jlut, gen=gen,
        tlut=params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan),
        tconv=convert_params(tp, plan=mplan, predicate=mla_convertible)[0],
    )


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _shapes(t, f"{prefix}/{n}").items()}
    return {prefix: (tuple(tree.shape), tree.init)}


def test_specs_and_cache_layouts_match_reference(world):
    """The MLA spec tree leaf for leaf; the latent cache's leaves dense and
    paged (the port's pool has one more page, the sink)."""
    cfg, jcfg = world["cfg"], world["jcfg"]
    assert _shapes(model_specs(cfg)) == _shapes(jmodel_specs(jcfg))
    dense, jdense = cache_specs(cfg, 2, 16), j_cache_specs(jcfg, 2, 16)
    paged, jpaged = cache_specs(cfg, 2, 16, page_size=4), j_cache_specs(jcfg, 2, 16, page_size=4)
    for name in ("c_kv", "k_rope"):
        assert dense["layers"][name].shape == jdense["layers"][name].shape
        want = jpaged["layers"][name].shape
        assert paged["layers"][name].shape == (want[0], want[1] + 1) + want[2:]
    assert set(paged["layers"]) == {"c_kv", "k_rope"}
    assert paged["page_table"].shape == jpaged["page_table"].shape


def test_mla_attention_matches_reference(world):
    """One layer's MLA attention on a prefill without a cache, at
    positions that do not start at 0."""
    jcfg, cfg = world["jcfg"], world["cfg"]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.asarray([[0], [5]])).astype(np.int32)
    jlayer = jax.tree.map(lambda a: a[0], world["jp"]["blocks"]["attn"])
    tlayer = {k: {n: t[0] for n, t in v.items()}
              for k, v in world["tp"]["blocks"]["attn"].items()}
    want, _ = j_mla_attention(jlayer, jnp.asarray(x), JCtx(jcfg, ex=JExecCfg(remat="none")),
                              jnp.asarray(pos))
    got = mla_attention(tlayer, torch.from_numpy(x), Ctx(cfg), torch.from_numpy(pos))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ATTN_TOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# update_mla_cache (and the GQA fast path through the same helper)
# ---------------------------------------------------------------------------

LEAVES = {"gqa": {"k": (2, 4), "v": (2, 4)}, "mla": {"c_kv": (6,), "k_rope": (4,)}}


def _meta(index, S, mask=None):
    """The same dense metadata cache in both packages, advanced over S
    tokens from ``index``: (reference cache, write, port cache, write)."""
    index = np.asarray(index, np.int32)
    positions = (index[:, None] + np.arange(S)[None, :]).astype(np.int32)
    j = {"pos": jnp.zeros((B, T), jnp.int32), "valid": jnp.zeros((B, T), bool),
         "index": jnp.asarray(index), "overflow": jnp.zeros((B,), bool)}
    t = {"pos": torch.zeros((B, T), dtype=torch.int32),
         "valid": torch.zeros((B, T), dtype=torch.bool),
         "index": torch.from_numpy(index.copy()), "overflow": torch.zeros(B, dtype=torch.bool)}
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    jc, jw = j_advance_meta(j, jnp.asarray(positions), None, jmask)
    tc, tw = advance_meta(t, torch.from_numpy(positions), None, tmask)
    return jc, jw, tc, tw


def _leaf_pair(lead, tail, seed):
    """A bf16 cache leaf with random contents in both packages."""
    vals = np.random.default_rng(seed).standard_normal(lead + tail).astype(np.float32)
    return torch.from_numpy(vals).to(torch.bfloat16), jnp.asarray(vals).astype(jnp.bfloat16)


def _update(kind, jw, tw, S, lead, seed=0):
    """Write fp32 values of S tokens into bf16 leaves of ``lead`` through
    both packages' update function; returns (port leaves, port result,
    reference result)."""
    rng = np.random.default_rng(seed + 100)
    leaves = LEAVES[kind]
    rows = tw.slots.shape[0]
    news = [rng.standard_normal((rows, S) + tail).astype(np.float32) for tail in leaves.values()]
    pairs = {name: _leaf_pair(lead, tail, seed + i) for i, (name, tail) in
             enumerate(leaves.items())}
    jfn, tfn = ((j_update_kv_cache, update_kv_cache) if kind == "gqa"
                else (j_update_mla_cache, update_mla_cache))
    jcache = {name: jl for name, (_, jl) in pairs.items()}
    tcache = {name: tl for name, (tl, _) in pairs.items()}
    positions = tw.positions
    jctx = JCtx(jget_config("minicpm3_4b", reduced=True))
    want = jfn(dict(jcache, _meta=jw), *(jnp.asarray(n) for n in news),
               jnp.asarray(positions.numpy()), jctx)
    got = tfn(dict(tcache, _meta=tw), *(torch.from_numpy(n) for n in news), positions,
              Ctx(get_config("minicpm3_4b", reduced=True)))
    return tcache, got, want


@pytest.mark.parametrize("kind", ["gqa", "mla"])
def test_fresh_row_fast_path_matches_reference(kind):
    """``S == T``: fresh rows (pre-write index 0) are overwritten whole, a
    row mid-decode is left as it was and flags overflow, with no slot of it
    marked valid; leaves, views and metadata bit for bit with the
    reference's."""
    jc, jw, tc, tw = _meta([0, 2, 0], T)
    tcache, got, want = _update(kind, jw, tw, T, (B, T))
    for i, name in enumerate(LEAVES[kind]):
        _same(tcache[name], want[0][name], name)
        _same(got[i], want[1 + i], f"{name} view")
    _same(got[-2], want[-2], "pos")
    _same(got[-1], want[-1], "valid")
    _same(tc["overflow"], jc["overflow"], "overflow")
    assert tc["overflow"].tolist() == [False, True, False]
    assert not tc["valid"][1].any()


SCATTERS = {  # name -> (index, S, mask seed or None)
    "decode": ([0, 3, 7], 1, None),
    "overflowing": ([0, 3, 6], 4, None),
    "masked": ([1, 0, 5], 5, 9),
}


@pytest.mark.parametrize("name", list(SCATTERS))
def test_update_mla_cache_scatter_matches_reference(name):
    """``S < T``: the scatter of each token to its slot, a masked token
    writing nothing, a token past T dropped (overflow flagged); bit for
    bit with the reference's one-hot writes."""
    index, S, mseed = SCATTERS[name]
    mask = None if mseed is None else np.random.default_rng(mseed).random((B, S)) < 0.6
    jc, jw, tc, tw = _meta(index, S, mask)
    tcache, got, want = _update("mla", jw, tw, S, (B, T), seed=len(name))
    for i, leaf in enumerate(LEAVES["mla"]):
        _same(tcache[leaf], want[0][leaf], leaf)
        _same(got[i], want[1 + i], f"{leaf} view")
    _same(got[-1], want[-1], "valid")
    _same(tc["overflow"], jc["overflow"], "overflow")
    assert tc["overflow"].any() == (name == "overflowing")


@pytest.mark.parametrize("name", ["unmapped", "past_capacity", "masked"])
def test_update_mla_cache_paged_matches_reference(name):
    """The paged write and view of the latents through the page routing
    (``tests/test_torch_paged_cache.py``'s routes): the pool's mapped pages,
    the gathered views, pos and valid bit for bit with the reference's;
    dropped and masked tokens land in the sink page only."""
    jc, jw, tc, tw = _route(name)
    pages = int(ROUTES[name][0].max()) + 1
    S = tw.slots.shape[1]
    tpool, got, want = _update("mla", jw, tw, S, (pages + 1, 4), seed=len(name))
    for i, leaf in enumerate(LEAVES["mla"]):
        _same(tpool[leaf][:pages], want[0][leaf][:pages], f"{leaf} pool")
        _same(got[i], want[1 + i], f"{leaf} view")
    _same(got[-2], want[-2], "pos")
    _same(got[-1], want[-1], "valid")
    _same(tc["overflow"], jc["overflow"], "overflow")


# ---------------------------------------------------------------------------
# the plan, the converted model served
# ---------------------------------------------------------------------------


def test_vetoed_plan_matches_reference(world):
    """The serving recipe with ``wk_b``/``wv_b`` vetoed: the port's plan of
    the same weights is the reference's, JSON for JSON, and holds neither;
    the converted tree keeps them as raw weights."""
    tm = _recipe(world["tp"], plan_model)
    assert tm.to_json() == world["jm"].to_json()
    keys = set(tm.layers)
    assert not any(k.rsplit("/", 1)[-1] in MLA_RAW_WEIGHTS for k in keys)
    assert {"blocks/attn/wq_a", "blocks/attn/wkv_a", "blocks/attn/wo"} <= keys
    attn = world["tconv"]["blocks"]["attn"]
    assert all(isinstance(attn[n], dict) for n in MLA_RAW_WEIGHTS)
    assert isinstance(attn["wq_b"], LUTLinear)


@pytest.mark.parametrize("params", ["tlut", "tconv"])
def test_converted_generate_matches_reference_dense_and_paged(world, params):
    """``generate`` on the converted tree (the reference's tables carried
    across, or the port's own conversion under the same plan): dense and
    paged at ``page_size=4``, each the reference's stream."""
    ctx = Ctx(world["cfg"])
    for page_size, want in world["gen"].items():
        got = generate(world[params], ctx, GEN_PROMPT, 6, max_len=16, page_size=page_size,
                       device="cpu")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(page_size))


def _engine_streams(cls, req, params, ctx, prompts, **kw):
    eng = cls(params, ctx, SLOTS, MAX_LEN, **kw)
    reqs = [req(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_engine_streams_match_reference(world, page_size):
    """``BatchingEngine`` on the converted tree with grouped launches, dense
    and paged with prefix sharing (two prompts share a two-page prefix, one
    is that prefix: a copy-on-write hit): the reference's streams and
    prefilled tokens."""
    kw = {} if page_size is None else {"page_size": page_size}
    jctx = JCtx(world["jcfg"], ex=JExecCfg(remat="none", lut_grouped=True))
    want, jeng = _engine_streams(JEngine, JRequest, world["jlut"], jctx,
                                 [jnp.asarray(p, jnp.int32) for p in PROMPTS], **kw)
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True))
    got, eng = _engine_streams(BatchingEngine, Request, world["tlut"], ctx,
                               [np.asarray(p, np.int32) for p in PROMPTS], device="cpu", **kw)
    assert got == want
    assert eng.prefill_tokens == jeng.prefill_tokens
    if page_size is not None:
        assert eng.prefill_tokens < sum(len(p) for p in PROMPTS)
        assert eng.alloc.pages_in_use == jeng.alloc.pages_in_use


def test_converted_latent_weights_raise(world):
    """Converting without the veto puts ``wk_b``/``wv_b`` on tables, which
    the absorbed form cannot read: a ``ValueError`` naming the veto, not
    the reference's ``TypeError``."""
    bad, _ = convert_params(world["tp"], chunk_size=1)
    assert isinstance(bad["blocks"]["attn"]["wk_b"], LUTLinear)
    with pytest.raises(ValueError, match="mla_convertible"):
        generate(bad, Ctx(world["cfg"]), GEN_PROMPT, 2, max_len=8, device="cpu")
