"""The port's paged KV cache and copy-on-write prefix sharing against the
JAX package's, on the CPU, case for case with ``tests/test_paged_cache.py``.

* The allocator (``serve/_paging.py``, the port's own copy): one scripted
  sequence of admissions, registrations, decode pages, retires, evictions
  and exhaustion gives identical tables, refcounts, free lists, registries
  and plans in both packages; ``admit_windowed`` too.
* ``advance_meta``'s page routing (an unmapped page, a slot past capacity,
  masked tokens), ``paged_write``, ``paged_view`` and ``copy_pages`` (-1
  sentinels, dropped tokens), in fp32 and bf16: bit for bit with the
  reference's one-hot versions.  The port's pool holds one more page, the
  sink that takes every dropped write; its other pages are compared.
* Paged ``generate`` and ``BatchingEngine`` streams equal the reference's
  paged streams and the port's dense ones: dense params, LUT per
  projection and grouped, batched and per-slot admission, and the reduced
  qwen2_moe_a2_7b grouped-LUT tree.  Greedy streams are compared whole
  (tolerance: none).
* Prefix sharing step by step against the reference: tables, pages in
  use, prefilled tokens; allocation in proportion to length; EOS and the
  budget at a page's final slot; a dry pool defers admission, and raises
  ``CacheOverflowError`` with no active slot or mid-decode; every cache
  tensor (the page table and the K/V pool included) keeps its storage.

The weights are the reference test's (``PRNGKey(0)``), on which its dense
and paged streams agree: a paged prefill attends over the bf16 cached keys
where a dense one attends over its fp32 in-flight keys, so on other
weights the two can part (the card's ``paged_serve`` phase compares them
by first tokens and logits for that reason).
"""
import dataclasses
import importlib

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
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro.serve import BatchingEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import generate as jgenerate
from repro.serve._cache import _onehot_write as j_onehot_write
from repro.serve._cache import _paged_write as j_paged_write
from repro.serve._cache import advance_meta as j_advance_meta
from repro.serve._cache import cache_specs as j_cache_specs
from repro.serve._cache import copy_pages as j_copy_pages
from repro.serve._cache import paged_view as j_paged_view
from repro.serve._cache import update_kv_cache as j_update_kv_cache
from repro.serve._paging import PageAllocator as JPageAllocator
from repro_torch.configs.base import get_config
from repro_torch.core.planner import ModelPlan
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import (
    BatchingEngine,
    CacheOverflowError,
    PageAllocator,
    Request,
    advance_meta,
    cache_specs,
    generate,
    make_cache,
    update_kv_cache,
)
from repro_torch.serve._cache import copy_pages, paged_view, paged_write, view_index, write_rows
from test_torch_moe import numpy_params
from test_torch_moe_serve import _serving_plan

B, T, PS, KV, HD = 2, 16, 4, 2, 4
MP = T // PS
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
SLOTS, MAX_LEN, MAX_NEW = 3, 32, 6
ROUNDED_TOL = 1e-3  # x max|paged|, see test_paged_prefill_is_the_dense_prefill_on_bf16_kv
SYS = (3, 1, 4, 1, 5, 9, 2, 6)  # a two-page system prompt
# the engine's prompts: two share SYS and diverge, one IS the registered
# prefix (a whole-prompt hit: copy-on-write), two share nothing
PROMPTS = (
    SYS + (20, 30, 40),
    (7, 8, 9, 10, 11),
    SYS + (21, 31),
    SYS,
    (12, 13, 14, 15, 16, 17, 18, 19, 22),
)


def _np(x) -> np.ndarray:
    """A torch tensor or a JAX array as numpy, bf16 widened to fp32 (exact)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _same(got, want, msg=""):
    """Bit for bit (tolerance: none)."""
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=msg)


# ---------------------------------------------------------------------------
# advance_meta page routing
# ---------------------------------------------------------------------------


def _meta_pair(table, index, seed):
    """The same paged metadata cache in both packages, from a seed.  The
    port's routes every dropped write to its pool's last page, so it gets
    an empty stand-in pool whose last page is the one past the table's
    highest, where ``_pool_pair`` puts the sink."""
    rng = np.random.default_rng(seed)
    Bn = table.shape[0]
    pos = rng.integers(0, 50, (Bn, T)).astype(np.int32)
    valid = rng.random((Bn, T)) < 0.5
    j = {"pos": jnp.asarray(pos), "valid": jnp.asarray(valid),
         "index": jnp.asarray(index, jnp.int32), "overflow": jnp.zeros((Bn,), bool),
         "page_table": jnp.asarray(table, jnp.int32)}
    t = {"pos": torch.from_numpy(pos.copy()), "valid": torch.from_numpy(valid.copy()),
         "index": torch.tensor(index, dtype=torch.int32),
         "overflow": torch.zeros(Bn, dtype=torch.bool),
         "page_table": torch.from_numpy(np.asarray(table, np.int32).copy()),
         "layers": {"k": torch.empty((0, int(np.max(table)) + 2))}}
    return j, t


def _identity():
    return np.arange(B * MP, dtype=np.int32).reshape(B, MP)


def _shuffled(seed, holes):
    """A slot -> page table over a pool of 2 * B * MP pages, with -1 holes."""
    rng = np.random.default_rng(seed)
    table = rng.permutation(2 * B * MP)[: B * MP].astype(np.int32).reshape(B, MP)
    for b, g in holes:
        table[b, g] = -1
    return table


ROUTES = {  # name -> (table, index, S, mask seed or None)
    "identity": (_identity(), [0, 5], 6, None),
    "unmapped": (_shuffled(1, [(1, 1)]), [0, 0], 6, None),
    "past_capacity": (_identity(), [0, T - 2], 4, None),
    "masked": (_shuffled(2, [(0, 2), (1, 0)]), [3, 13], 7, 5),
    "one_token": (_shuffled(3, [(0, 1)]), [4, 15], 1, None),
}


def _route(name):
    table, index, S, mseed = ROUTES[name]
    jc, tc = _meta_pair(table, index, seed=len(name))
    positions = (np.asarray(index)[:, None] + np.arange(S)[None, :]).astype(np.int32)
    mask = None if mseed is None else np.random.default_rng(mseed).random((B, S)) < 0.7
    jc, jw = j_advance_meta(jc, jnp.asarray(positions), None,
                            None if mask is None else jnp.asarray(mask))
    tc, tw = advance_meta(tc, torch.from_numpy(positions), None,
                          None if mask is None else torch.from_numpy(mask))
    return jc, jw, tc, tw


@pytest.mark.parametrize("name", list(ROUTES))
def test_advance_meta_routes_pages_as_reference(name):
    """Page ids (-1 where dropped), offsets, the write mask, overflow and
    the advanced metadata, identical to the reference's."""
    jc, jw, tc, tw = _route(name)
    for key in ("pos", "valid", "index", "overflow"):
        _same(tc[key], jc[key], key)
    for field in ("slots", "mask", "page_ids", "page_offsets", "index", "overflow"):
        _same(getattr(tw, field), getattr(jw, field), field)


def test_advance_meta_routes_pages():
    _, _, cache, w = _route("identity")
    slots = w.slots.numpy()
    np.testing.assert_array_equal(w.page_offsets.numpy(), slots % PS)
    want_pid = np.take_along_axis(_identity(), slots // PS, axis=1)
    np.testing.assert_array_equal(w.page_ids.numpy(), want_pid)
    assert not bool(cache["overflow"].any())
    assert cache["index"].tolist() == [6, 11]


def test_advance_meta_unmapped_page_flags_overflow():
    """A write into an unmapped page flags overflow and leaves the write
    mask and pos/valid, never silently dropped with metadata claiming it."""
    table = _identity()
    table[1, 1] = -1
    jc, tc = _meta_pair(table, [0, 0], seed=0)
    tc["valid"].zero_()
    positions = torch.arange(6, dtype=torch.int32)[None].expand(B, 6)
    cache, w = advance_meta(tc, positions, None)
    assert cache["overflow"].tolist() == [False, True]
    assert (w.page_ids[1, 4:] == -1).all()
    assert w.mask[0].all() and not w.mask[1, 4:].any()
    assert cache["valid"][0, :6].all()
    assert cache["valid"][1, :4].all() and not cache["valid"][1, 4:].any()


def test_advance_meta_past_capacity_flags_overflow_paged():
    _, _, cache, w = _route("past_capacity")
    assert cache["overflow"].tolist() == [False, True]
    assert (w.page_ids[1, 2:] == -1).all()


# ---------------------------------------------------------------------------
# paged write / view / copy against the reference's one-hot versions
# ---------------------------------------------------------------------------


def _pool_pair(dtype, pages, lead=(), seed=0):
    """A random pool in both packages; the port's has the sink page after
    them, filled with other values (a write must not read it back into a
    mapped page)."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(lead + (pages, PS, KV, HD)).astype(np.float32)
    sink = rng.standard_normal(lead + (1, PS, KV, HD)).astype(np.float32) + 100
    t = torch.from_numpy(np.concatenate([vals, sink], axis=len(lead))).to(tdt)
    return t, jnp.asarray(vals).astype(jdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["identity", "unmapped", "masked", "one_token"])
def test_paged_write_and_view_match_reference(dtype, name):
    """``paged_write`` then ``paged_view`` through the routes above: the
    pool's mapped pages and the gathered view (unmapped groups as zeros)
    bit for bit with the reference's, dropped tokens written nowhere."""
    _, jw, _, tw = _route(name)
    pages = int(ROUTES[name][0].max()) + 1
    tpool, jpool = _pool_pair(dtype, pages, seed=7)
    rng = np.random.default_rng(11)
    new = rng.standard_normal(tuple(tw.slots.shape) + (KV, HD)).astype(np.float32)
    tnew = torch.from_numpy(new).to(tpool.dtype)
    jnew = jnp.asarray(new).astype(jpool.dtype)
    want = j_paged_write(jpool, jnew, jw.page_ids, jw.page_offsets, jw.mask)
    sink = tpool[-1].clone()
    paged_write(tpool, tnew, tw.page_rows)
    _same(tpool[:pages], want, "pool")
    table = ROUTES[name][0]
    _same(paged_view(tpool, tw.view_pages, tw.view_mapped),
          j_paged_view(want, jnp.asarray(table)), "view")
    if not tw.mask.all():  # a dropped or masked token went to the sink
        assert not torch.equal(tpool[-1], sink)


def test_paged_write_view_matches_dense_reference():
    """The reference's case: unique slots per row, straddling a page
    boundary in row 1, one token masked; the paged write and view equal the
    dense one-hot write (identity layout)."""
    rng = np.random.default_rng(0)
    S = 5
    dense = rng.standard_normal((B, T, KV, HD)).astype(np.float32)
    new = rng.standard_normal((B, S, KV, HD)).astype(np.float32)
    slots = np.stack([np.arange(S) + 3 * b for b in range(B)]).astype(np.int32)
    mask = np.asarray([[True] * S, [True, True, False, True, True]])
    want = j_onehot_write(jnp.asarray(dense), jnp.asarray(new), jnp.asarray(slots),
                          jnp.asarray(mask))
    table = torch.from_numpy(_identity())
    pool = torch.from_numpy(
        np.concatenate([dense.reshape(B * MP, PS, KV, HD), np.zeros((1, PS, KV, HD), np.float32)])
    )
    pids = torch.gather(table, 1, torch.from_numpy(slots // PS).long())
    rows = write_rows(pids, torch.from_numpy(slots % PS), torch.from_numpy(mask), B * MP, PS)
    paged_write(pool, torch.from_numpy(new), rows)
    np.testing.assert_allclose(paged_view(pool, *view_index(table)).numpy(), np.asarray(want),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pairs", [((2, 5), (-1, -1)), ((-1, -1), (-1, -1)),
                                   ((0, 9), (-1, -1), (4, 0))])
def test_copy_pages_matches_reference(dtype, pairs):
    """Whole-page copies over the layer axis, -1 pairs no-ops: the pool's
    pages bit for bit with the reference's."""
    L, pages = 3, 12
    tpool, jpool = _pool_pair(dtype, pages, lead=(L,), seed=len(pairs))
    src = np.asarray([p[0] for p in pairs], np.int32)
    dst = np.asarray([p[1] for p in pairs], np.int32)
    want = j_copy_pages(jpool, jnp.asarray(src), jnp.asarray(dst))
    ref = np.asarray(jpool.astype(jnp.float32)).copy()
    for s, d in pairs:
        if s >= 0:
            ref[:, d] = ref[:, s]
    copy_pages(tpool, torch.from_numpy(src), torch.from_numpy(dst))
    _same(tpool[:, :pages], want)
    np.testing.assert_array_equal(_np(tpool[:, :pages]), ref)


@pytest.mark.parametrize("masked", [False, True])
def test_update_kv_cache_paged_matches_reference(masked):
    """Through ``update_kv_cache`` as a layer calls it: fp32 K/V rounded into
    a bf16 pool, the views the layer attends over, pos and valid."""
    name = "masked" if masked else "unmapped"
    jc, jw, tc, tw = _route(name)
    pages = int(ROUTES[name][0].max()) + 1
    tk, jk = _pool_pair("bf16", pages, seed=3)
    tv, jv = _pool_pair("bf16", pages, seed=4)
    rng = np.random.default_rng(5)
    shape = tuple(tw.slots.shape) + (KV, HD)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jcfg, cfg = jget_config("granite_8b", reduced=True), get_config("granite_8b", reduced=True)
    positions = tw.positions
    jout = j_update_kv_cache({"k": jk, "v": jv, "_meta": jw}, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(positions.numpy()), JCtx(jcfg))
    tout = update_kv_cache({"k": tk, "v": tv, "_meta": tw}, torch.from_numpy(k),
                           torch.from_numpy(v), positions, Ctx(cfg))
    _same(tk[:pages], jout[0]["k"], "k pool")
    _same(tv[:pages], jout[0]["v"], "v pool")
    for got, want, what in zip(tout, jout[1:], ("k view", "v view", "pos", "valid")):
        _same(got, want, what)


def test_cache_specs_rejects_ragged_pages():
    cfg = get_config("granite_8b", reduced=True)
    with pytest.raises(ValueError, match="whole number of pages"):
        cache_specs(cfg, 2, 10, page_size=4)
    specs = cache_specs(cfg, 2, 16, page_size=4)
    kv = (cfg.num_layers, 2 * 4 + 1, 4, cfg.num_kv_heads, cfg.head_dim)
    assert specs["layers"]["k"].shape == kv and specs["layers"]["v"].shape == kv
    assert specs["page_table"].shape == (2, 4) and specs["page_table"].dtype == torch.int32
    assert cache_specs(cfg, 2, 16, page_size=4, num_pages=5)["layers"]["k"].shape[1] == 6


@pytest.mark.parametrize("table", ["identity", "empty"])
def test_make_cache_page_tables(table):
    cfg = get_config("granite_8b", reduced=True)
    cache = make_cache(cfg, 2, 16, page_size=4, page_table=table, device="cpu")
    want = _identity() if table == "identity" else np.full((2, 4), -1, np.int32)
    np.testing.assert_array_equal(cache["page_table"].numpy(), want)
    with pytest.raises(ValueError, match="identity page table needs"):
        make_cache(cfg, 2, 16, page_size=4, num_pages=7, device="cpu")


# ---------------------------------------------------------------------------
# the host allocator, scripted on both packages
# ---------------------------------------------------------------------------


def _state(al):
    return (al.table.copy(), al._ref.copy(), list(al._free), dict(al._registry),
            al.pages_in_use)


def _assert_same_state(got, want, where):
    for a, b, what in zip(got, want, ("table", "refcounts", "free list", "registry",
                                      "pages in use")):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} after {where}")
        else:
            assert a == b, f"{what} after {where}"


def _run_script(cls, script, **kw):
    """Run ``script`` (a list of (op, args)) on an allocator of ``cls``;
    returns each op's result (plans as tuples, raises by name) and state."""
    al = cls(**kw)
    out = []
    for op, args in script:
        try:
            res = getattr(al, op)(*args)
        except Exception as e:  # noqa: BLE001 - the exception's name is compared
            res = type(e).__name__
        if res is not None and hasattr(res, "slot"):
            res = (res.slot, res.start, res.copy_src, res.copy_dst)
        out.append((op, res, _state(al)))
    return out


def _random_script(seed, num_slots=4, steps=60):
    """Admissions over prompts that share page-aligned prefixes, their
    registrations, decode pages, retires, and now and then a release."""
    rng = np.random.default_rng(seed)
    stems = [rng.integers(0, 50, 8).astype(np.int32) for _ in range(3)]
    lens = {}
    script = []
    for _ in range(steps):
        s = int(rng.integers(num_slots))
        if s not in lens:
            stem = stems[int(rng.integers(3))][: int(rng.integers(0, 9))]
            tail = rng.integers(50, 99, int(rng.integers(1, 7))).astype(np.int32)
            prompt = np.concatenate([stem, tail]).astype(np.int32)
            if rng.random() < 0.15:  # a whole-prompt hit on a registered prefix
                prompt = stems[0][: 4 * int(rng.integers(1, 3))].copy()
            script += [("admit", (s, prompt)), ("register", (s, prompt))]
            lens[s] = len(prompt)
        elif rng.random() < 0.3:
            script.append(("retire", (s,)))
            del lens[s]
        else:
            script.append(("ensure_page", (s, lens[s])))
            lens[s] = min(lens[s] + 1, 4 * 6 - 1)
        if rng.random() < 0.03:
            script.append(("release_prefixes", ()))
    return script


@pytest.mark.parametrize("seed,num_pages", [(0, 10), (1, 14), (2, 24), (3, 7)])
def test_allocator_script_matches_reference(seed, num_pages):
    """Tables, refcounts, free lists, registries, plans and exhaustion after
    every op, identical in both packages (small pools evict and run dry)."""
    kw = dict(num_pages=num_pages, page_size=4, num_slots=4, pages_per_slot=6)
    script = _random_script(seed)
    got, want = _run_script(PageAllocator, script, **kw), _run_script(JPageAllocator, script, **kw)
    for i, ((op, res, st), (_, wres, wst)) in enumerate(zip(got, want)):
        assert res == wres, f"op {i} {op}: {res} != {wres}"
        _assert_same_state(st, wst, f"op {i} {op}")
    ops = {op for op, res, _ in got}
    assert {"admit", "register", "ensure_page", "retire"} <= ops


def test_allocator_windowed_matches_reference():
    kw = dict(num_pages=5, page_size=4, num_slots=3, pages_per_slot=2, share=False)
    script = [("admit_windowed", (0,)), ("ensure_page", (0, 37)), ("admit_windowed", (1,)),
              ("admit_windowed", (2,)), ("retire", (0,)), ("admit_windowed", (2,)),
              ("register", (2, np.arange(9, dtype=np.int32))), ("retire", (1,)),
              ("retire", (2,))]
    got, want = _run_script(PageAllocator, script, **kw), _run_script(JPageAllocator, script, **kw)
    for i, ((op, res, st), (_, wres, wst)) in enumerate(zip(got, want)):
        assert res == wres, f"op {i} {op}"
        _assert_same_state(st, wst, f"op {i} {op}")
    assert got[3][1] is None and got[5][1] == (2, 0, -1, -1)  # dry, then mapped
    assert got[-1][2][4] == 0


def test_allocator_admit_register_retire_refcounts():
    al = PageAllocator(num_pages=16, page_size=4, num_slots=4, pages_per_slot=4)
    prompt = np.arange(10, dtype=np.int32)  # 2 full pages + 2 tail tokens
    plan = al.admit(0, prompt)
    assert plan.start == 0 and plan.copy_src == -1
    assert al.pages_in_use == 3
    al.register(0, prompt)
    assert al.pages_in_use == 3
    p2 = np.concatenate([prompt[:8], np.asarray([99, 98], np.int32)])
    plan2 = al.admit(1, p2)
    assert plan2.start == 8 and plan2.copy_src == -1
    assert al.pages_in_use == 4
    plan3 = al.admit(2, prompt[:8])  # a whole-prompt hit: COW of page 2
    assert plan3.start == 7
    assert plan3.copy_src >= 0 and plan3.copy_dst >= 0 and plan3.copy_src != plan3.copy_dst
    assert al.pages_in_use == 5
    al.retire(1), al.retire(2)
    assert al.pages_in_use == 3
    al.retire(0)
    assert al.pages_in_use == 2
    al.release_prefixes()
    assert al.pages_in_use == 0


def test_allocator_eviction_then_exhaustion():
    al = PageAllocator(num_pages=4, page_size=4, num_slots=2, pages_per_slot=4)
    p = np.arange(8, dtype=np.int32)
    assert al.admit(0, p) is not None
    al.register(0, p)
    al.retire(0)
    assert al.pages_in_use == 2
    assert al.admit(0, np.arange(100, 116, dtype=np.int32)) is not None  # evicts
    assert al.pages_in_use == 4
    assert al.admit(1, np.arange(50, 54, dtype=np.int32)) is None
    al.retire(0)
    assert al.admit(1, np.arange(50, 54, dtype=np.int32)) is not None


def test_allocator_windowed_maps_full_ring():
    al = PageAllocator(num_pages=8, page_size=4, num_slots=2, pages_per_slot=2, share=False)
    plan = al.admit_windowed(0)
    assert plan.start == 0 and (al.table[0] >= 0).all() and al.pages_in_use == 2
    assert not al.ensure_page(0, 37)
    al.retire(0)
    assert al.pages_in_use == 0


def test_serve_public_api_surface():
    import repro_torch.serve as serve

    for name in ("BatchingEngine", "Request", "generate", "make_cache", "CacheOverflowError",
                 "SampleCfg", "CacheWrite", "PageAllocator", "PagePoolExhausted"):
        assert hasattr(serve, name), name
    for name in ("repro_torch.serve.cache", "repro_torch.serve.engine"):
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(name)


# ---------------------------------------------------------------------------
# generate and BatchingEngine against the reference
# ---------------------------------------------------------------------------


def _jrun(params, jctx, prompts, max_new=MAX_NEW, slots=SLOTS, **kw):
    eng = JEngine(params, jctx, slots, MAX_LEN, **kw)
    reqs = [JRequest(i, jnp.asarray(p, jnp.int32), max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.generated for r in reqs], eng


def _run(params, ctx, prompts, max_new=MAX_NEW, slots=SLOTS, **kw):
    eng = BatchingEngine(params, ctx, slots, MAX_LEN, device="cpu", **kw)
    reqs = [Request(i, np.asarray(p, np.int32), max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.generated for r in reqs], eng


@pytest.fixture(scope="module")
def world():
    """Reduced granite_8b on the reference test's weights, as is and
    converted by the serving recipe; the reference's paged streams."""
    jcfg = jget_config("granite_8b", reduced=True)
    cfg = get_config("granite_8b", reduced=True)
    jp = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0))
    uniform = jplan_model(jp, float("inf"), max_chunk=2)
    jm = jplan_model(jp, uniform.total_lut_bytes // 2, max_chunk=2,
                     modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                     table_formats=(None, "i8"))
    jlut, _ = jconvert(jp, plan=jm)
    mplan = ModelPlan.from_json(jm.to_json())
    from repro_torch.core.convert import convert_params

    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ref = {}
    for name, params, grouped in (("dense", jp, False), ("lut", jlut, True)):
        jctx = JCtx(jcfg, ex=JExecCfg(remat="none", lut_grouped=grouped))
        for admit in ("batched", "per-slot"):
            ref[name, admit] = _jrun(params, jctx, PROMPTS, admit=admit, page_size=4)[0]
    jctx = JCtx(jcfg, ex=JExecCfg(remat="none"))
    for plen, max_new in ((6, 5), (5, 12)):
        prompts = jnp.asarray([list(range(1, plen + 1))], jnp.int32)
        ref["generate", plen] = np.asarray(
            jgenerate(jp, jctx, prompts, max_new=max_new, max_len=16, page_size=4))
    return dict(
        jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, ref=ref,
        tlut=params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan),
        tflat=convert_params(tp, plan=mplan, group_siblings=False)[0],
    )


@pytest.mark.parametrize("plen,max_new", [(6, 5), (5, 12)], ids=["short", "at_capacity"])
def test_generate_paged_matches_reference_and_dense(world, plen, max_new):
    """Paged ``generate`` (identity table) equals the reference's paged
    stream and the port's dense one; ``prompt + max_new - 1 == max_len``
    completes without a spurious overflow."""
    ctx = Ctx(world["cfg"])
    prompts = np.asarray([list(range(1, plen + 1))], np.int32)
    got = generate(world["tp"], ctx, prompts, max_new, max_len=16, page_size=4, device="cpu")
    dense = generate(world["tp"], ctx, prompts, max_new, max_len=16, device="cpu")
    np.testing.assert_array_equal(got.numpy(), world["ref"]["generate", plen])
    np.testing.assert_array_equal(got.numpy(), dense.numpy())
    assert tuple(got.shape) == (1, max_new)


SETTINGS = [  # (port params, lut_grouped, reference streams)
    ("tp", False, "dense"),
    ("tflat", False, "lut"),
    ("tlut", True, "lut"),
]


@pytest.mark.parametrize("params,grouped,ref", SETTINGS)
@pytest.mark.parametrize("admit", ["batched", "per-slot"])
def test_engine_paged_streams_identical_to_reference(world, params, grouped, ref, admit):
    """Paged engine streams (shared prefixes, a copy-on-write hit) equal the
    reference's paged ones and the port's dense engine's; drained, only the
    registry pins pages, and releasing it empties the pool."""
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped))
    got, eng = _run(world[params], ctx, PROMPTS, admit=admit, page_size=4)
    assert got == world["ref"][ref, admit]
    dense, _ = _run(world[params], ctx, PROMPTS, admit=admit)
    assert got == dense
    assert eng.alloc.pages_in_use > 0
    eng.alloc.release_prefixes()
    assert eng.alloc.pages_in_use == 0


REF_PROMPTS = ((1, 2, 3, 4), (5, 6, 7), (9, 10, 11, 12, 13))  # tests/test_paged_cache.py's


def _moe_trees(tree):
    """(JAX tree, port tree, prompts, engine kw) of a grouped-LUT reduced
    qwen2_moe_a2_7b: the serving recipe's plan with ``convert_experts=True``,
    or the reference test's own case (``PRNGKey(3)``, chunk 1, 2 slots)."""
    jcfg = jget_config("qwen2_moe_a2_7b", reduced=True)
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    if tree == "recipe":
        jp = jax.tree.map(jnp.asarray, numpy_params(model_specs(cfg), 31))
        jm = _serving_plan(jp)
        jlut, _ = jconvert(jp, plan=jm, convert_experts=True)
        tlut = params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu",
                                 plan=ModelPlan.from_json(jm.to_json()))
        return jcfg, cfg, jlut, tlut, PROMPTS, {}
    from repro_torch.core.convert import convert_params

    jp = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(3))
    jlut, _ = jconvert(jp, chunk_size=1, convert_experts=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tlut, _ = convert_params(tp, chunk_size=1, convert_experts=True)
    return jcfg, cfg, jlut, tlut, REF_PROMPTS, dict(max_new=4, slots=2)


@pytest.mark.parametrize("tree", ["recipe", "reference_case"])
def test_engine_paged_moe_grouped_lut_tree_identical_to_reference(tree):
    """Grouped-LUT MoE trees: paged streams equal the reference's paged
    ones, dense the reference's dense.  On the reference test's own case
    paged equals dense, as it asserts; on the recipe's tree and these
    prompts one token parts in both packages alike (a paged prefill attends
    over bf16 cached keys, a dense one over fp32 in-flight keys)."""
    jcfg, cfg, jlut, tlut, prompts, kw = _moe_trees(tree)
    jctx = JCtx(jcfg, ex=JExecCfg(remat="none", lut_grouped=True))
    want = _jrun(jlut, jctx, prompts, page_size=4, **kw)[0]
    want_dense = _jrun(jlut, jctx, prompts, **kw)[0]
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    got = _run(tlut, ctx, prompts, page_size=4, **kw)[0]
    dense = _run(tlut, ctx, prompts, **kw)[0]
    assert got == want
    assert dense == want_dense
    assert (got == dense) == (want == want_dense)
    if tree == "reference_case":
        assert got == dense


def _storage(cache: dict) -> dict:
    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            out.update({f"{key}/{k}": v for k, v in _storage(val).items()})
        else:
            out[key] = val.data_ptr()
    return out


def _lockstep(world, **kw):
    """The reference's and the port's paged engines (``page_size=4``,
    ``kw``) stepped together over PROMPTS: after every step the same slot ->
    page tables, pages in use, prefilled tokens, read-backs, slot lengths
    and tokens; every cache tensor of the port's engine, ``page_table`` and
    the K/V pool included, keeps the storage it was made with (what a
    captured decode graph needs).  Returns the port's engine, its requests
    and the admission plans its allocator made."""
    jctx = JCtx(world["jcfg"], ex=JExecCfg(remat="none"))
    jeng = JEngine(world["jp"], jctx, SLOTS, MAX_LEN, page_size=4, **kw)
    eng = BatchingEngine(world["tp"], Ctx(world["cfg"]), SLOTS, MAX_LEN, page_size=4,
                         device="cpu", **kw)
    made = _storage(eng.cache)
    assert {"page_table", "layers/k", "layers/v"} <= set(made)
    jreqs = [JRequest(i, jnp.asarray(p, jnp.int32), MAX_NEW) for i, p in enumerate(PROMPTS)]
    reqs = [Request(i, np.asarray(p, np.int32), MAX_NEW) for i, p in enumerate(PROMPTS)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    plans, admit = [], eng.alloc.admit

    def recorded(slot, prompt):
        plans.append(admit(slot, prompt))
        return plans[-1]

    eng.alloc.admit = recorded
    steps = 0
    while True:
        more = eng.step()
        assert more == jeng.step()
        steps += 1
        np.testing.assert_array_equal(eng.alloc.table, jeng.alloc.table, err_msg=f"step {steps}")
        assert eng.alloc.pages_in_use == jeng.alloc.pages_in_use
        assert (eng.prefill_tokens, eng.readbacks) == (jeng.prefill_tokens, jeng.readbacks)
        assert eng._slot_len == jeng._slot_len
        assert [r.generated for r in reqs] == [r.generated for r in jreqs]
        assert _storage(eng.cache) == made, f"a cache tensor was rebound at step {steps}"
        # the device table is uploaded before each step that reads it; a row
        # retired since is stale there until the next upload
        live = [i for i, r in enumerate(eng.slots) if r is not None]
        np.testing.assert_array_equal(eng.cache["page_table"].numpy()[live],
                                      eng.alloc.table[live])
        if not more:
            break
    assert all(r.done for r in reqs)
    return eng, reqs, plans


def test_paged_engine_matches_reference_step_by_step(world):
    """Both engines stepped together (``_lockstep``) over the shared-prefix
    prompts and a copy-on-write hit."""
    eng, _, plans = _lockstep(world)
    # later holders of the shared prompt mapped it; the whole-prompt hit
    # copied its last page
    assert any(p is not None and p.start > 0 and p.copy_src < 0 for p in plans)
    assert any(p is not None and p.copy_src >= 0 for p in plans)
    assert eng.prefill_tokens < sum(len(p) for p in PROMPTS)


def test_paged_engine_unshared_matches_reference_step_by_step(world):
    """``share_prefixes=False`` on both engines stepped together
    (``_lockstep``): every prompt maps private pages and prefills in full,
    with no copy-on-write; the streams equal the dense engine's, and the
    drained pool holds no page (nothing is registered)."""
    eng, reqs, plans = _lockstep(world, share_prefixes=False)
    assert plans and all(p is not None and p.start == 0 and p.copy_src < 0 for p in plans)
    assert eng.prefill_tokens == sum(len(p) for p in PROMPTS)
    assert eng.alloc.pages_in_use == 0
    dense, _ = _run(world["tp"], Ctx(world["cfg"]), PROMPTS)
    assert [r.generated for r in reqs] == dense


def test_engine_prefix_sharing_prefills_once_and_frees(world):
    """The reference's case: an 8-token system prompt across 3 admissions
    is prefilled once, later admissions prefill their 2-token tails; the
    registry pins the prefix after the drain, and releasing it frees all."""
    ctx = Ctx(world["cfg"])
    prompts = tuple(SYS + (20 + i, 30 + i) for i in range(3))
    dense, d_eng = _run(world["tp"], ctx, prompts, max_new=4, slots=2, prefill_bucket=16)
    paged, p_eng = _run(world["tp"], ctx, prompts, max_new=4, slots=2, prefill_bucket=16,
                        page_size=4)
    jctx = JCtx(world["jcfg"], ex=JExecCfg(remat="none"))
    want, j_eng = _jrun(world["jp"], jctx, prompts, max_new=4, slots=2, prefill_bucket=16,
                        page_size=4)
    assert dense == paged == want
    assert d_eng.prefill_tokens == sum(len(p) for p in prompts)
    assert p_eng.prefill_tokens == len(prompts[0]) + 2 * (len(prompts) - 1)
    assert p_eng.prefill_tokens == j_eng.prefill_tokens
    assert p_eng.alloc.pages_in_use == len(SYS) // 4 == j_eng.alloc.pages_in_use
    p_eng.alloc.release_prefixes()
    assert p_eng.alloc.pages_in_use == 0


def test_engine_paged_allocates_proportional_to_length(world):
    """Three 3-token prompts take one page each, not the max_len rectangle
    (3 * 32 / 4 = 24 pages), as in the reference."""
    ctx = Ctx(world["cfg"])
    eng = BatchingEngine(world["tp"], ctx, 3, MAX_LEN, page_size=4, device="cpu")
    jeng = JEngine(world["jp"], JCtx(world["jcfg"], ex=JExecCfg(remat="none")), 3, MAX_LEN,
                   page_size=4)
    for i in range(3):
        eng.submit(Request(i, np.asarray([7 + i, 8, 9], np.int32), 3))
        jeng.submit(JRequest(i, jnp.asarray([7 + i, 8, 9], jnp.int32), 3))
    assert eng.step() and jeng.step()
    assert eng.alloc.pages_in_use == 3 == jeng.alloc.pages_in_use
    while eng.step():
        pass
    eng.alloc.release_prefixes()
    assert eng.alloc.pages_in_use == 0


def test_engine_eos_or_budget_at_final_page_slot(world):
    """A 4-token prompt and 5 new tokens: the last decode write lands at slot
    7, page 1's final slot; no overflow, no dangling page, the dense and the
    reference's streams.  Then EOS on the token written there."""
    ctx = Ctx(world["cfg"])
    jp = jinit_params(jmodel_specs(world["jcfg"]), jax.random.PRNGKey(4))  # the reference's
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = ((1, 2, 3, 4),)
    dense, _ = _run(tp, ctx, prompts, max_new=5)
    paged, eng = _run(tp, ctx, prompts, max_new=5, page_size=4)
    assert dense == paged and len(paged[0]) == 5
    eng.alloc.release_prefixes()
    assert eng.alloc.pages_in_use == 0
    eos = int(dense[0][4])
    assert eos not in dense[0][:4]  # the boundary token is new on these weights
    jctx = JCtx(world["jcfg"], ex=JExecCfg(remat="none"))
    want, _ = _jrun(jp, jctx, prompts, max_new=8, eos_id=eos, page_size=4)
    d2, _ = _run(tp, ctx, prompts, max_new=8, eos_id=eos)
    p2, eng2 = _run(tp, ctx, prompts, max_new=8, eos_id=eos, page_size=4)
    assert d2 == p2 == want
    assert p2[0][-1] == eos and len(p2[0]) == 5
    eng2.alloc.release_prefixes()
    assert eng2.alloc.pages_in_use == 0


DRY = ((30, 31, 32, 33, 34, 35, 36, 37, 38), (40, 41, 42, 43, 44, 45, 46, 47, 48))


def test_dry_pool_defers_admission_as_reference(world):
    """Five pages for two 9-token prompts (3 pages each): the second waits
    for the first to retire (its slot stays free with the request queued),
    then runs; streams, tables and pages in use as the reference's."""
    ctx = Ctx(world["cfg"])
    jctx = JCtx(world["jcfg"], ex=JExecCfg(remat="none"))
    eng = BatchingEngine(world["tp"], ctx, 2, MAX_LEN, page_size=4, num_pages=5, device="cpu")
    jeng = JEngine(world["jp"], jctx, 2, MAX_LEN, page_size=4, num_pages=5)
    reqs = [Request(i, np.asarray(p, np.int32), 4) for i, p in enumerate(DRY)]
    jreqs = [JRequest(i, jnp.asarray(p, jnp.int32), 4) for i, p in enumerate(DRY)]
    for r, jr in zip(reqs, jreqs):
        eng.submit(r)
        jeng.submit(jr)
    deferred = 0
    while True:
        more = eng.step()
        assert more == jeng.step()
        np.testing.assert_array_equal(eng.alloc.table, jeng.alloc.table)
        assert eng.alloc.pages_in_use == jeng.alloc.pages_in_use
        deferred += bool(eng.queue) and any(s is None for s in eng.slots)
        if not more:
            break
    assert deferred > 0
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [r.generated for r in reqs] == _run(world["tp"], ctx, DRY, max_new=4, slots=2)[0]


@pytest.mark.parametrize("num_pages,max_new,where", [(2, 4, "admission"), (3, 8, "decode")])
def test_exhausted_pool_raises_cache_overflow_as_reference(world, num_pages, max_new, where):
    """A pool that cannot hold a lone prompt raises ``CacheOverflowError`` at
    admission (no active slot to wait for); one that cannot hold its decode
    pages raises it mid-decode.  The reference raises at the same step."""
    ctx = Ctx(world["cfg"])
    jctx = JCtx(world["jcfg"], ex=JExecCfg(remat="none"))
    eng = BatchingEngine(world["tp"], ctx, 2, MAX_LEN, page_size=4, num_pages=num_pages,
                         device="cpu")
    jeng = JEngine(world["jp"], jctx, 2, MAX_LEN, page_size=4, num_pages=num_pages)
    eng.submit(Request(0, np.asarray(DRY[0], np.int32), max_new))
    jeng.submit(JRequest(0, jnp.asarray(DRY[0], jnp.int32), max_new))
    steps = {}
    for name, e, exc in (("port", eng, CacheOverflowError), ("ref", jeng, Exception)):
        n = 0
        with pytest.raises(exc, match="exhausted|pages are referenced"):
            while True:
                n += 1
                e.step()
        steps[name] = n
    assert steps["port"] == steps["ref"]
    assert (steps["port"] == 1) == (where == "admission")


def test_paged_sliding_window_is_refused():
    """A paged ring is refused only where the reference refuses it, when
    its capacity T = min(window, max_len) is not a whole number of pages;
    otherwise its specs are the reference's: T = the window, whole pages,
    the pool one page larger (the port's sink)."""
    for name in ("granite_8b", "mixtral_8x7b"):
        cfg = dataclasses.replace(get_config(name, reduced=True), sliding_window=6)
        jcfg = dataclasses.replace(jget_config(name, reduced=True), sliding_window=6)
        with pytest.raises(ValueError, match="whole number of pages"):
            cache_specs(cfg, 2, 16, page_size=4)
        with pytest.raises(ValueError, match="whole number of pages"):
            j_cache_specs(jcfg, 2, 16, page_size=4)
    cfg, jcfg = get_config("mixtral_8x7b", reduced=True), jget_config("mixtral_8x7b", reduced=True)
    assert cfg.sliding_window == jcfg.sliding_window == 16
    for max_len, page_size in ((64, 4), (12, 4), (64, None)):
        got = cache_specs(cfg, 2, max_len, page_size=page_size)
        want = j_cache_specs(jcfg, 2, max_len, page_size=page_size)
        for key in ("pos", "valid", "index") + (("page_table",) if page_size else ()):
            assert got[key].shape == want[key].shape, key
        for name in ("k", "v"):
            g, w = got["layers"][name].shape, want["layers"][name].shape
            assert g == ((w[0], w[1] + 1) + w[2:] if page_size else w), name
        assert got["pos"].shape[1] == min(16, max_len)


@pytest.mark.parametrize("params,grouped", [("tp", False), ("tlut", True)])
def test_paged_prefill_is_the_dense_prefill_on_bf16_kv(world, params, grouped, monkeypatch):
    """What parts a paged prefill from a dense one: the paged prefill
    attends over its K/V read back from the bf16 pool, the dense one over
    its fp32 in-flight K/V.  With those rounded to bf16 before attention,
    the dense prefill's logits are the paged one's at every real token
    within ROUNDED_TOL x max (the softmax sums over 16 cached keys against
    12 in flight, another fp32 order; on the LUT tree such a step can move
    one fp16 code); without, they are at least ten times further apart."""
    from repro_torch.models import layers
    from repro_torch.models.model import model_forward

    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped))
    rng = np.random.default_rng(41)
    tokens = torch.from_numpy(rng.integers(0, world["cfg"].vocab_size, (3, 12)).astype(np.int32))
    mask = torch.arange(12)[None, :] < torch.tensor([[12], [7], [10]])
    inputs = {"tokens": tokens, "token_mask": mask}

    def prefill(page_size=None):
        cache = make_cache(world["cfg"], 3, 16, ctx, page_size=page_size, device="cpu")
        with torch.no_grad():
            return model_forward(world[params], inputs, ctx, cache=cache)[0][mask].numpy()

    paged, dense = prefill(4), prefill()
    sdpa = layers._sdpa
    monkeypatch.setattr(layers, "_sdpa", lambda q, k, v, m: sdpa(
        q, k.to(torch.bfloat16), v.to(torch.bfloat16), m))
    rounded = prefill()
    scale = np.abs(paged).max()
    near, far = np.abs(paged - rounded).max(), np.abs(paged - dense).max()
    assert near <= ROUNDED_TOL * scale
    assert far >= 10 * near and far > 0
