"""mixtral_8x7b's sliding-window ring KV cache in the port against the JAX
package's, on the CPU: reduced mixtral_8x7b (window 16, 4 experts top-2,
no shared experts), fp32 weights from a numpy seed carried across by
``params_from_numpy``.

* ``advance_meta`` on ring caches, dense and paged, bit for bit with the
  reference's: slots ``positions % T``, pos, valid, index, overflow, the
  write mask and the page routing, for writes shorter than, as long as and
  longer than T (the last T tokens kept), right-padded masks and decode
  past the wrap; an unmapped page still flags overflow.
* ``update_kv_cache`` on a write longer than T keeps its LAST T tokens at
  ``p % T``, dense and paged (a cut to the first T fails here), bit for bit
  with the reference's one-hot writes.
* ``causal_mask`` with a window, and one layer's attention past the
  window, against the reference's.
* Prefill then decode past the window (``tests/test_serve.py``'s
  ``test_swa_ring_cache_beyond_window``): each decode's logits within
  2e-3 x max of the port's windowed full forward and of the reference's
  decode logits, dense and paged at ``page_size=4``.
* ``generate`` streams, dense and paged at ``page_size=4``, with a prompt
  shorter and one longer than the window, equal to the reference's whole;
  ``BatchingEngine`` streams, dense and paged, too: sharing stays off under
  ``share_prefixes=True``, every page of a slot is mapped at admission, and
  every cache tensor keeps its storage through the wrap (what a captured
  decode step needs).  Greedy, compared whole: tolerance none.
* The MoE FFN as mixtral runs it: no shared experts, top-2 routing,
  ``moe_ffn`` against the reference's at 4 and at the published 8 experts,
  two ``lut_affine_experts`` calls a converted layer, and the ragged
  kernel's grid at the published widths.
* The converted tree's logits (the serving recipe with
  ``convert_experts=True``) within 1e-5 x max, synchronized as
  ``tests/test_torch_dense_families.py`` synchronizes them (its
  :class:`Tape`, here with the MoE FFN's pack sites too): without it, fp16
  input codes at rounding boundaries move these logits by up to 7e-3 x max.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro_torch.models.layers as L
import repro_torch.models.moe as tmoe
from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.models.layers import attention as j_attention
from repro.models.layers import causal_mask as j_causal_mask
from repro.models.model import model_forward as jmodel_forward
from repro.models.model import model_specs as jmodel_specs
from repro.serve import BatchingEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import generate as jgenerate
from repro.serve import make_cache as jmake_cache
from repro.serve import make_decode_step as jmake_decode_step
from repro.serve import make_prefill_step as jmake_prefill_step
from repro.serve._cache import advance_meta as j_advance_meta
from repro.serve._cache import update_kv_cache as j_update_kv_cache
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTGroup, convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.kernels.lut_affine import ops as lut_ops
from repro_torch.models.layers import Ctx, ExecCfg, attention, causal_mask
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import (
    BatchingEngine,
    Request,
    advance_meta,
    generate,
    make_cache,
    make_decode_step,
    make_prefill_step,
    update_kv_cache,
)
from test_torch_dense_families import Tape
from test_torch_moe import FFN_TOL, _ffn_pair, _ffn_inputs, numpy_params
from test_torch_moe_serve import _serving_plan
from test_torch_paged_cache import _same, _storage

ARCH = "mixtral_8x7b"
WINDOW = 16  # the reduced config's
B, RT, RPS = 2, 8, 4  # the metadata cases: slots, ring capacity, page size
ATTN_TOL = 1e-5  # x max|reference|: fp32 sums in another order
LOGITS_TOL = 1e-5  # the same, through two layers and the head
RING_TOL = 2e-3  # x max, tests/test_serve.py::test_swa_ring_cache_beyond_window's
SLOTS, MAX_LEN, MAX_NEW = 2, 32, 24  # T = min(16, 32): every request wraps
TOKENS = np.random.default_rng(7).integers(0, 512, (2, 24)).astype(np.int32)
# the engine's prompts: 1 and 3 share an 8-token prefix (two pages), which a
# ring never shares
ENGINE_PROMPTS = (tuple(TOKENS[0, :5]), tuple(TOKENS[1, :12]), tuple(TOKENS[0, 3:19]),
                  tuple(TOKENS[1, :8]) + (7, 9, 11))
GEN_LENS = (6, 20)  # generate's prompts: shorter and longer than the window


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    tree = numpy_params(model_specs(cfg), 51)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    jm = _serving_plan(jp)
    mplan = ModelPlan.from_json(jm.to_json())
    jlut, _ = jconvert(jp, plan=jm, convert_experts=True)
    return dict(
        jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jm=jm, jlut=jlut,
        tlut=params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan),
        tconv=convert_params(tp, plan=mplan, convert_experts=True)[0],
    )


def _jctx(jcfg, **kw):
    return JCtx(jcfg, ex=JExecCfg(remat="none", **kw))


def test_config_matches_reference():
    """The published config and ``reduced()`` field for field (the name
    aside, the reference's ``ModelConfig`` has more fields: its other
    families'), and the spec trees' shapes."""
    for reduced in (True, False):
        got = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        want = dataclasses.asdict(jget_config(ARCH, reduced=reduced))
        assert got == {k: want[k] for k in got}
        specs = model_specs(get_config(ARCH, reduced=reduced))
        jspecs = jmodel_specs(jget_config(ARCH, reduced=reduced))
        assert jax.tree.map(lambda s: tuple(s.shape), specs["blocks"]["ffn"]) == jax.tree.map(
            lambda s: tuple(s.shape), jspecs["blocks"]["ffn"])
    full = get_config(ARCH)
    assert (full.sliding_window, full.num_experts, full.num_experts_per_tok,
            full.moe_d_ff, full.num_shared_experts) == (4096, 8, 2, 14336, 0)
    assert get_config(ARCH, reduced=True).sliding_window == WINDOW


# ---------------------------------------------------------------------------
# advance_meta on ring caches
# ---------------------------------------------------------------------------

# name -> (pre-write index, S, real tokens per row or None)
RINGS = {
    "short": ([0, 3], 5, None),
    "full": ([0, 0], RT, None),
    "long": ([0, 0], 13, None),
    "long_masked": ([0, 0], 13, [13, 10]),
    "masked": ([2, 6], 6, [6, 3]),
    "decode_wrapped": ([13, 21], 1, None),
    "decode_masked": ([13, 21], 1, [1, 0]),
}


def _ring_pair(index, table=None, seed=0):
    """The same ring metadata cache (capacity RT) in both packages, from a
    seed; paged with ``table`` (the port's gets a stand-in pool whose last
    page, past the table's highest, is its sink)."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 50, (B, RT)).astype(np.int32)
    valid = rng.random((B, RT)) < 0.5
    j = {"pos": jnp.asarray(pos), "valid": jnp.asarray(valid),
         "index": jnp.asarray(index, jnp.int32), "overflow": jnp.zeros((B,), bool)}
    t = {"pos": torch.from_numpy(pos.copy()), "valid": torch.from_numpy(valid.copy()),
         "index": torch.tensor(index, dtype=torch.int32),
         "overflow": torch.zeros(B, dtype=torch.bool)}
    if table is not None:
        j["page_table"] = jnp.asarray(table, jnp.int32)
        t["page_table"] = torch.from_numpy(np.asarray(table, np.int32).copy())
        t["layers"] = {"k": torch.empty((0, int(np.max(table)) + 2))}
    return j, t


TABLES = {
    None: None,
    "paged": np.asarray([[5, 2], [0, 7]], np.int32),
    "unmapped": np.asarray([[5, 2], [0, -1]], np.int32),
}


def _ring(name, table=None):
    index, S, lens = RINGS[name]
    jc, tc = _ring_pair(index, TABLES[table], seed=len(name))
    positions = (np.asarray(index)[:, None] + np.arange(S)[None, :]).astype(np.int32)
    mask = None if lens is None else np.arange(S)[None, :] < np.asarray(lens)[:, None]
    jc, jw = j_advance_meta(jc, jnp.asarray(positions), RT,
                            None if mask is None else jnp.asarray(mask))
    tc, tw = advance_meta(tc, torch.from_numpy(positions), RT,
                          None if mask is None else torch.from_numpy(mask))
    return jc, jw, tc, tw


@pytest.mark.parametrize("table", list(TABLES), ids=["dense", "paged", "unmapped"])
@pytest.mark.parametrize("name", list(RINGS))
def test_advance_meta_ring_matches_reference(name, table):
    """Slots ``positions % T`` (a write longer than T cut to its last T
    tokens), the mask, pos, valid, index and overflow, and the page routing,
    identical to the reference's."""
    jc, jw, tc, tw = _ring(name, table)
    for key in ("pos", "valid", "index", "overflow"):
        _same(tc[key], jc[key], key)
    fields = ["slots", "mask", "positions", "index", "overflow"]
    if table is not None:
        fields += ["page_ids", "page_offsets"]
    for field in fields:
        got, want = getattr(tw, field), getattr(jw, field)
        assert (got is None) == (want is None), field
        if got is not None:
            _same(got, want, field)
    assert tw.slots.shape[1] == min(RINGS[name][1], RT)
    # the ring overflows only where a page is unmapped
    assert bool(tc["overflow"].any()) == (table == "unmapped" and name != "decode_masked")


def test_advance_meta_ring_slot_holds_latest_position():
    """After a write longer than T, slot j holds the latest written position
    p with p % T == j, and every slot is valid; ``index`` advanced by S."""
    _, _, tc, tw = _ring("long")
    for b in range(B):
        want = [max(p for p in range(13) if p % RT == j) for j in range(RT)]
        assert tc["pos"][b].tolist() == want
    assert tc["valid"].all() and tc["index"].tolist() == [13, 13]


def _kv(rows, S, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, S, 2, 4)).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("table", [None, "paged"], ids=["dense", "paged"])
def test_ring_write_keeps_last_tokens(table):
    """A 13-token write into an 8-slot ring: slot ``p % 8`` holds token p's
    K/V for the last 8 tokens p = 5..12, never the first 8's (the scatter's
    cut of a too-long write to its first T tokens would leave tokens 0..7
    there); leaves and views bit for bit with the reference's."""
    jc, jw, tc, tw = _ring("long", table)
    k, v = _kv(B, 13, 3)
    ctx, jctx = Ctx(get_config(ARCH, reduced=True)), _jctx(jget_config(ARCH, reduced=True))
    if table is None:
        lead = (B, RT)
    else:
        lead = (int(TABLES[table].max()) + 2, RPS)
    init = np.random.default_rng(4).standard_normal(lead + (2, 4)).astype(np.float32)
    tcache = {"k": torch.from_numpy(init.copy()), "v": torch.from_numpy(init.copy()),
              "_meta": tw}
    jcache = {"k": jnp.asarray(init[:-1] if table else init),
              "v": jnp.asarray(init[:-1] if table else init), "_meta": jw}
    positions = np.arange(13, dtype=np.int32)[None].repeat(B, 0)  # as the layer passes them
    got = update_kv_cache(tcache, torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(positions), ctx)
    want = j_update_kv_cache(jcache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(positions),
                             jctx)
    for i, name in enumerate(("k", "v")):
        leaf = tcache[name][:-1] if table else tcache[name]
        _same(leaf, want[0][name], name)
        _same(got[i], want[1 + i], f"{name} view")
        view = got[i].numpy()
        src = (k, v)[i]
        for p in range(5, 13):
            np.testing.assert_array_equal(view[:, p % RT], src[:, p])


# ---------------------------------------------------------------------------
# the window mask and attention
# ---------------------------------------------------------------------------


def test_causal_mask_window_matches_reference():
    rng = np.random.default_rng(5)
    q = rng.integers(0, 40, (2, 7)).astype(np.int32)
    k = rng.integers(0, 40, (2, 11)).astype(np.int32)
    valid = rng.random((2, 11)) < 0.8
    for window in (None, 1, 5, WINDOW):
        for kv in (None, valid):
            got = causal_mask(torch.from_numpy(q), torch.from_numpy(k),
                              None if kv is None else torch.from_numpy(kv), window)
            want = j_causal_mask(jnp.asarray(q), jnp.asarray(k),
                                 None if kv is None else jnp.asarray(kv), window)
            _same(got, want, str(window))


def test_attention_past_window_matches_reference(world):
    """One layer's attention without a cache over 24 tokens (past the
    window of 16), at positions that do not start at 0."""
    cfg = world["cfg"]
    x = np.random.default_rng(6).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = (np.arange(24)[None, :] + np.asarray([[0], [9]])).astype(np.int32)
    jlayer = jax.tree.map(lambda a: a[0], world["jp"]["blocks"]["attn"])
    tlayer = {k: {n: t[0] for n, t in v.items()}
              for k, v in world["tp"]["blocks"]["attn"].items()}
    want, _ = j_attention(jlayer, jnp.asarray(x), _jctx(world["jcfg"]), jnp.asarray(pos))
    got = attention(tlayer, torch.from_numpy(x), Ctx(cfg), torch.from_numpy(pos))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATTN_TOL * np.abs(want).max())
    nowin = attention(tlayer, torch.from_numpy(x),
                      Ctx(dataclasses.replace(cfg, sliding_window=None)), torch.from_numpy(pos))
    assert np.abs(nowin.numpy() - want)[:, WINDOW:].max() > 100 * ATTN_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# prefill and decode past the window
# ---------------------------------------------------------------------------


def _decode_past_window(params, ctx, page_size, tokens=TOKENS, prefill_len=20):
    """Prefill ``prefill_len`` tokens into an fp32 ring, then decode the
    rest one fed token at a time: each decode's logits (rows, steps, vocab)."""
    Bn, S = tokens.shape
    cache = make_cache(ctx.cfg, Bn, S + 4, ctx, dtype=torch.float32, page_size=page_size,
                       device="cpu")
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        _, cache = make_prefill_step(ctx)(params, {"tokens": tok[:, :prefill_len]}, cache)
        decode, outs = make_decode_step(ctx), []
        for t in range(prefill_len, S):
            _, lg, cache = decode(params, cache, tok[:, t:t + 1])
            outs.append(lg[:, -1])
    return torch.stack(outs, 1).numpy(), cache


@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_decode_past_window_matches_full_forward(world, page_size):
    """Prefill 20 tokens (past the window: the ring keeps the last 16), then
    decode positions 20..23: each step's logits within RING_TOL x max of the
    port's windowed full forward at the same position and of the
    reference's own prefill-and-decode (dense: its ring; paged: its paged
    ring), and the ring's metadata is the reference's."""
    cfg, ctx = world["cfg"], Ctx(world["cfg"])
    got, cache = _decode_past_window(world["tp"], ctx, page_size)
    with torch.no_grad():
        full = model_forward(world["tp"], {"tokens": torch.from_numpy(TOKENS)}, ctx)[0].numpy()
    want = full[:, 20:24]
    np.testing.assert_allclose(got, want, rtol=0, atol=RING_TOL * np.abs(want).max())
    # the reference's decode past the window
    jctx = _jctx(world["jcfg"])
    jc = jmake_cache(world["jcfg"], 2, 28, jctx, dtype=jnp.float32, page_size=page_size)
    jtok = jnp.asarray(TOKENS)
    _, jc = jax.jit(jmake_prefill_step(jctx))(world["jp"], {"tokens": jtok[:, :20]}, jc)
    jdecode, jouts = jax.jit(jmake_decode_step(jctx)), []
    for t in range(20, 24):
        _, lg, jc = jdecode(world["jp"], jc, jtok[:, t:t + 1])
        jouts.append(np.asarray(lg[:, -1]))
    jwant = np.stack(jouts, 1)
    np.testing.assert_allclose(got, jwant, rtol=0, atol=RING_TOL * np.abs(jwant).max())
    for key in ("pos", "valid", "index"):
        _same(cache[key], jc[key], key)
    assert cache["pos"].shape[1] == WINDOW
    assert sorted(cache["pos"][0].tolist()) == list(range(23 - WINDOW + 1, 24))


# ---------------------------------------------------------------------------
# generate and BatchingEngine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gen_ref(world):
    """The reference's ``generate`` streams on its converted tree: (prompt
    length, page_size) -> (1, 14) tokens."""
    return {
        (plen, ps): np.asarray(jgenerate(
            world["jlut"], _jctx(world["jcfg"]), jnp.asarray(TOKENS[:1, :plen]), max_new=14,
            max_len=MAX_LEN, page_size=ps))
        for plen in GEN_LENS for ps in (None, 4)
    }


@pytest.mark.parametrize("params", ["tlut", "tconv"])
@pytest.mark.parametrize("plen", GEN_LENS, ids=["short", "past_window"])
def test_generate_matches_reference_dense_and_paged(world, gen_ref, params, plen):
    """``generate`` on the converted tree (the reference's tables carried
    across, or the port's own conversion under the same plan) with a prompt
    of 6 tokens (the ring wraps while decoding) and one of 20 (its prefill
    keeps the last 16), max_len 32, dense and paged at ``page_size=4``: the
    reference's streams whole."""
    ctx = Ctx(world["cfg"])
    for ps in (None, 4):
        got = generate(world[params], ctx, TOKENS[:1, :plen], 14, max_len=MAX_LEN,
                       page_size=ps, device="cpu")
        np.testing.assert_array_equal(got.numpy(), gen_ref[plen, ps], err_msg=str(ps))


def _engine(cls, req, params, ctx, prompts, watch=None, **kw):
    eng = cls(params, ctx, SLOTS, MAX_LEN, **kw)
    reqs = [req(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    while eng.step():
        if watch is not None:
            watch(eng)
    return [r.generated for r in reqs], eng


@pytest.mark.parametrize("params", ["tp", "tlut"])
@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_engine_streams_match_reference(world, params, page_size):
    """``BatchingEngine`` (2 slots, max_len 32: a ring of 16; every request
    outlasts it, which ``submit`` accepts), grouped launches, dense and
    paged with ``share_prefixes=True``: the reference's streams whole and
    its prefilled tokens (sharing is off for a ring: every prompt token is
    prefilled); a paged slot maps all its pages at admission, and every
    page is free once the engine drains."""
    kw = {} if page_size is None else {"page_size": page_size, "share_prefixes": True}
    jkey = {"tp": "jp", "tlut": "jlut"}[params]
    want, jeng = _engine(JEngine, JRequest, world[jkey], _jctx(world["jcfg"], lut_grouped=True),
                         [jnp.asarray(p, jnp.int32) for p in ENGINE_PROMPTS], **kw)
    mapped = []

    def watch(eng):
        if eng.alloc is not None:
            rows = eng.alloc.table[[s for s, r in enumerate(eng.slots) if r is not None]]
            mapped.append(bool((rows >= 0).all()))

    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True))
    got, eng = _engine(BatchingEngine, Request, world[params], ctx,
                       [np.asarray(p, np.int32) for p in ENGINE_PROMPTS], watch=watch,
                       device="cpu", **kw)
    assert got == want
    assert eng.prefill_tokens == jeng.prefill_tokens == sum(len(p) for p in ENGINE_PROMPTS)
    assert max(len(p) for p in ENGINE_PROMPTS) + MAX_NEW - 1 > MAX_LEN
    if page_size is not None:
        assert not eng.alloc.share and not jeng.alloc.share
        assert mapped and all(mapped)
        assert eng.alloc.pages_in_use == jeng.alloc.pages_in_use == 0


@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_engine_ring_keeps_cache_storage(world, page_size):
    """Every cache tensor keeps its storage through admissions and the
    ring's wraps (a captured decode step reads fixed addresses), and the
    ring's metadata at the end is what the host works out: slot j of each
    finished request's row holds its latest written position p with
    p % 16 == j."""
    kw = {} if page_size is None else {"page_size": page_size}
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True))
    eng = BatchingEngine(world["tlut"], ctx, SLOTS, MAX_LEN, device="cpu", **kw)
    before = _storage(eng.cache)
    prompts = ENGINE_PROMPTS[:2]
    reqs = [Request(i, np.asarray(p, np.int32), MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert _storage(eng.cache) == before
    for s, p in enumerate(prompts):
        last = len(p) + MAX_NEW - 2  # the final token is sampled, never written
        want = [max(q for q in range(last + 1) if q % WINDOW == j) for j in range(WINDOW)]
        assert eng.cache["pos"][s].tolist() == want
        assert eng.cache["valid"][s].all()


# ---------------------------------------------------------------------------
# the MoE FFN as mixtral runs it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("experts", [4, 8], ids=["reduced", "published_experts"])
def test_moe_ffn_top2_no_shared_matches_reference(experts):
    """``moe_ffn`` with no shared experts and top-2 routing, at the reduced
    config's 4 experts and at the published 8 (narrow widths), on the dense
    experts and on chunk-1 tables (two ``lut_affine_experts`` launches: the
    pre-stacked ``w_gate+w_up`` and ``w_down``), within FFN_TOL x max of
    the reference's."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), num_experts=experts)
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True), num_experts=experts)
    specs = model_specs(cfg)
    assert "shared" not in specs["blocks"]["ffn"] and cfg.num_experts_per_tok == 2
    tree = numpy_params(specs, 52)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")
    x = _ffn_inputs(cfg)
    got, want = _ffn_pair(jp, tp, cfg, jcfg, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FFN_TOL * np.abs(np.asarray(want)).max())
    weights, idx, _ = tmoe._route(torch.from_numpy(x).reshape(-1, cfg.d_model),
                                  tp["blocks"]["ffn"]["router"][0], cfg)
    assert idx.shape[1] == 2 and torch.allclose(weights.sum(-1), torch.ones(1))
    jc, _ = jconvert(jp, chunk_size=1, convert_experts=True)
    tc, _ = convert_params(tp, chunk_size=1, convert_experts=True)
    calls = []
    experts_call = tmoe.lut_affine_experts

    def spy(*a, **k):
        calls.append(1)
        return experts_call(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmoe, "lut_affine_experts", spy)
        got, want = _ffn_pair(jc, tc, cfg, jcfg, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FFN_TOL * np.abs(np.asarray(want)).max())
    assert len(calls) == 2
    assert isinstance(tc["blocks"]["ffn"]["w_gate+w_up"], LUTGroup)


@pytest.mark.parametrize("rows,proj,want", [
    (8, "w_gate+w_up", (28, 112, 2)), (8, "w_down", (8, 16, 16)),
    (16384, "w_gate+w_up", (28, 229376, 1)), (16384, "w_down", (8, 32768, 1)),
])
def test_experts_tiling_at_published_widths(rows, proj, want):
    """The ragged kernel's grid at mixtral's widths on a 132-SM card (i8
    tables): decode (4 tokens, 8 expert rows) and a 2 x 4096-token prefill
    (16,384 rows): (slabs, tiles, k splits); the grid's y (slabs) and z
    (G x splits) stay far below their 65,535 limit, x takes the row blocks."""
    full = get_config(ARCH)
    G, k, p = ((2, full.d_model, full.moe_d_ff) if proj == "w_gate+w_up"
               else (1, full.moe_d_ff, full.d_model))
    t = lut_ops.experts_tiling(G, rows, k, p, 132)
    assert (t.slabs, t.tiles, t.splits) == want
    assert t.slabs <= 65535 and G * t.splits <= 65535


# ---------------------------------------------------------------------------
# the converted tree's logits, synchronized
# ---------------------------------------------------------------------------


def test_serving_plan_matches_reference(world):
    """The serving recipe with ``convert_experts=True`` (the plan the card's
    ``mixtral_serve`` phase uses, there with chunks capped at 1): the port's
    plan of the same weights is the reference's, JSON for JSON, with the
    ``wk+wv`` and ``w_gate+w_up`` groups."""
    uniform = plan_model(world["tp"], float("inf"), max_chunk=2, convert_experts=True)
    tm = plan_model(world["tp"], uniform.total_lut_bytes // 2, max_chunk=2,
                    modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                    table_formats=(None, "i8"), convert_experts=True)
    assert tm.to_json() == world["jm"].to_json()
    groups = {tuple(k.rsplit("/", 1)[-1] for k in g) for g in tm.groups}
    assert groups == {("wk", "wv"), ("w_gate", "w_up")}


class MoETape(Tape):
    """:class:`Tape` with the MoE FFN's pack sites too (each package's
    ``moe`` module packs through its own name for the packing function)."""

    @contextlib.contextmanager
    def record(self):
        with super().record(), pytest.MonkeyPatch.context() as mp:
            import repro.models.layers as JL

            mp.setattr(jmoe, "pack_codes", JL.pack_codes)
            yield

    @contextlib.contextmanager
    def replay(self):
        with super().replay(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmoe, "pack", L.pack)
            yield


@pytest.fixture(scope="module")
def logits_tape(world):
    """The reference's converted logits over TOKENS (24 tokens, past the
    window), with every pack site recorded."""
    tape = MoETape()
    jctx = _jctx(world["jcfg"])
    with tape.record():
        fwd = jax.jit(lambda p, t: jmodel_forward(p, {"tokens": t}, jctx)[0])
        want = np.asarray(fwd(world["jlut"], jnp.asarray(TOKENS)))
    return want, tape.sites


@pytest.mark.parametrize("params", ["tlut", "tconv"])
@pytest.mark.parametrize("grouped", [False, True], ids=["flat", "grouped"])
def test_converted_logits_match_reference(world, logits_tape, params, grouped):
    """``model_forward`` on the converted tree (the reference's tables, or
    the port's own conversion under the same plan; flat and grouped
    launches), the port's pack sites given the reference's codes: logits
    within LOGITS_TOL x max, each site's own input within 1e-5 x max of the
    reference's and its pack of the reference's input bit for bit."""
    want, sites = logits_tape
    tape = MoETape()
    tape.sites = sites
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped))
    with tape.replay(), torch.no_grad():
        got = model_forward(world[params], {"tokens": torch.from_numpy(TOKENS)}, ctx)[0]
    tape.check()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGITS_TOL * np.abs(want).max())
