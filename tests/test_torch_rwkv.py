"""The RWKV-6 family (rwkv6_3b) in the port against the JAX package, on the
CPU: the reduced config (2 layers, d_model 64, 4 heads of 16, d_ff 224,
LoRA rank 8), fp32 weights from a numpy seed carried across by
``params_from_numpy``.  ``init_params`` zeroes the token-shift mixes
``mu_*``, the bonus ``u`` and ``decay_base``; at zero the shift multiplies
the carried state by 0 and the bonus vanishes, so a wrong carry would show
nothing.  Here they are drawn from a seed (``mu_*`` ~ U(0, 1), ``u`` ~
N(0, 0.5), ``decay_base`` ~ U(-6, 1)), with the per-head norm's scale and
bias, and both packages get the same values.

* ``wkv_chunked`` (chunks 1, 4, 32, with and without ``init_state``, and
  under strong decay), ``wkv_decode_step``, ``_token_shift``,
  ``_group_norm`` and ``_pick_chunk`` against the reference's functions,
  within 1e-5 x max (fp32 sums in another order); a chunked prefill
  followed by decode steps equals one chunked pass.
* The config, the spec tree, the cache specs, the serving recipe's plan
  (JSON for JSON: the eight projections a layer and ``lm_head``, no sibling
  group, the decay LoRA raw) and ``advance_meta``'s index-only branch.
* Whole-model logits: unconverted within 1e-5 x max, converted (the
  reference's tables carried across, and the port's own conversion under
  the same plan) synchronized at every pack site by
  ``tests/test_torch_dense_families.py``'s :class:`Tape`.
* Prefill then decode through the cache against the reference's, on fp32
  and bf16 caches; greedy ``generate`` streams against the reference's.
* The refusals: ``page_size``, ``token_mask``, ``BatchingEngine``, and
  ``CacheOverflowError``, which the reference applies to this family too.

The shift states: the reference declares them in the cache's dtype (bf16
by default), but its forward returns them in the activations' dtype, so
after its first write it carries them in fp32 whatever the cache declares.
The port allocates them in fp32 and writes them in place, so on either
cache dtype the packages agree to fp32 order.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.serve._engine as tengine
from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.models import rwkv as jrwkv
from repro.models.model import model_forward as jmodel_forward
from repro.models.model import model_specs as jmodel_specs
from repro.serve import BatchingEngine as JEngine
from repro.serve import CacheOverflowError as JCacheOverflowError
from repro.serve import generate as jgenerate
from repro.serve import make_cache as jmake_cache
from repro.serve._cache import advance_meta as jadvance_meta
from repro.serve._cache import cache_specs as jcache_specs
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTLinear, convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.models import rwkv
from repro_torch.models.layers import Ctx
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import (
    BatchingEngine,
    CacheOverflowError,
    generate,
    make_cache,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.serve._cache import advance_meta, cache_specs
from test_torch_dense_families import _close, _jctx, _recipe, _shapes, _synced
from test_torch_moe import numpy_params

ARCH = "rwkv6_3b"
TOL = 1e-5  # x max|reference|: fp32 sums in another order
TOKENS = np.random.default_rng(81).integers(0, 512, (2, 12)).astype(np.int32)
GEN_PROMPT = np.asarray([[5, 9, 2, 7, 1, 30, 4], [3, 8, 4, 6, 11, 2, 9]], np.int32)
GEN_NEW = 6
PROJECTIONS = ("time/w_r", "time/w_k", "time/w_v", "time/w_g", "time/w_o",
               "channel/w_k", "channel/w_v", "channel/w_r")


def seeded_leaves(tree: dict, seed: int) -> dict:
    """``tree`` (numpy) with the leaves ``init_params`` zeroes drawn from a
    seed: ``mu_*`` ~ U(0, 1), ``u`` ~ N(0, 0.5), ``decay_base`` ~ U(-6, 1),
    and the per-head norm's ``ln_scale`` ~ 1 + N(0, 0.2), ``ln_bias`` ~
    N(0, 0.1); the block norms' scales ~ 1 + N(0, 0.2)."""
    rng = np.random.default_rng(seed)
    blocks = tree["blocks"]
    draws = {
        "mu": lambda s: rng.uniform(0.0, 1.0, s),
        "u": lambda s: rng.normal(0.0, 0.5, s),
        "decay_base": lambda s: rng.uniform(-6.0, 1.0, s),
        "ln_scale": lambda s: 1 + 0.2 * rng.standard_normal(s),
        "ln_bias": lambda s: 0.1 * rng.standard_normal(s),
    }
    for part in ("time", "channel"):
        for name, leaf in blocks[part].items():
            draw = draws.get("mu" if name.startswith("mu_") else name)
            if draw is not None:
                blocks[part][name] = draw(leaf.shape).astype(np.float32)
    for part in ("ln1", "ln2"):
        s = blocks[part]["scale"]
        blocks[part]["scale"] = (1 + 0.2 * rng.standard_normal(s.shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    tree = seeded_leaves(numpy_params(model_specs(cfg), 82), 83)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    jm = _recipe(jp, jplan_model)
    mplan = ModelPlan.from_json(jm.to_json())
    jlut, _ = jconvert(jp, plan=jm)
    return dict(
        jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jm=jm, jlut=jlut,
        tlut=params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan),
        tconv=convert_params(tp, plan=mplan)[0], tapes={},
    )


# ---------------------------------------------------------------------------
# The recurrence's functions
# ---------------------------------------------------------------------------


def _wkv_inputs(seed: int, L: int, strong: bool = False, B: int = 2, H: int = 3, K: int = 8):
    """r, k, v, logw (B, L, H, K), u (H, K) and a state (B, H, K, K) from a
    numpy seed; ``strong``: logw near -e^4, the clip's floor of the decay's
    exponent, where a factored exp(-cum) form overflows."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, L, H, K)).astype(np.float32) for _ in range(3))
    expo = rng.uniform(3.5, 4.0, (B, L, H, K)) if strong else rng.standard_normal((B, L, H, K))
    logw = (-np.exp(expo)).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, K))).astype(np.float32)
    state = rng.standard_normal((B, H, K, K)).astype(np.float32)
    return r, k, v, logw, u, state


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("chunk,init,strong", [
    (1, False, False), (4, False, False), (32, False, False),
    (1, True, False), (4, True, False), (32, True, False),
    (32, False, True), (4, True, True),
])
def test_wkv_chunked_matches_reference(chunk, init, strong):
    """``wkv_chunked`` over 64 tokens: outputs and the final state within
    TOL x max of the reference's, from zeros or a given state.  Under
    strong decay both are finite and within ``_strong_tol(chunk)`` of the
    reference's and of an fp64 recurrence (``tests/test_recurrences.py``'s,
    from a given state too):
    the exponent ``cum_in_i - cum_j`` is a difference of cumulative sums
    that reach chunk x e^4 in size, so the packages' fp32 cumsums, taken in
    other orders, differ by that times fp32's rounding before the exp."""
    r, k, v, logw, u, state = _wkv_inputs(10 + chunk, 64, strong)
    s0 = state if init else None
    want_y, want_s = jrwkv.wkv_chunked(
        *map(jnp.asarray, (r, k, v, logw, u)), chunk=chunk,
        init_state=None if s0 is None else jnp.asarray(s0))
    got_y, got_s = rwkv.wkv_chunked(*_t(r, k, v, logw, u), chunk=chunk,
                                    init_state=None if s0 is None else torch.from_numpy(s0))
    assert torch.isfinite(got_y).all() and torch.isfinite(got_s).all()
    tol = _strong_tol(chunk) if strong else TOL
    _close(got_y, np.asarray(want_y), tol)
    _close(got_s, np.asarray(want_s), tol)
    if strong:
        exact_y, exact_s = wkv_recurrent_ref(r, k, v, logw, u, s0)
        for got, want in ((got_y, exact_y), (got_s, exact_s)):
            _close(got, want, tol)


def _strong_tol(chunk: int) -> float:
    """x max: a cumulative log decay of ``chunk`` steps of up to e^4 each,
    times twice fp32's unit roundoff."""
    return chunk * float(np.exp(4.0)) * 2.0**-23


def wkv_recurrent_ref(r, k, v, logw, u, state=None):
    """The O(L) recurrence in fp64, from zeros or ``state``:
    y_t = r_t (S_t + diag(u) k_t v_t^T); S_{t+1} = diag(w_t) S_t + k_t v_t^T."""
    B, L, H, K = r.shape
    S = np.zeros((B, H, K, v.shape[-1])) if state is None else state.astype(np.float64)
    r, k, v, logw, u = (np.asarray(t, np.float64) for t in (r, k, v, logw, u))
    ys = []
    for t in range(L):
        kv = np.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(np.einsum("bhk,bhkv->bhv", r[:, t], S + u[None, :, :, None] * kv))
        S = S * np.exp(logw[:, t])[..., None] + kv
    return np.stack(ys, 1), S


def test_wkv_decode_step_and_chunked_prefill_continue_one_pass():
    """``wkv_decode_step`` against the reference's from a given state; a
    chunked prefill of 24 tokens (chunk 8) then 4 decode steps give the
    outputs and the state of one chunked pass over all 28 (chunk 4), in
    both packages."""
    r, k, v, logw, u, state = _wkv_inputs(21, 28)
    one = [a[:, :1] for a in (r, k, v, logw)]
    want = jrwkv.wkv_decode_step(*map(jnp.asarray, one + [u, state]))
    got = rwkv.wkv_decode_step(*_t(*one, u, state))
    for g, w in zip(got, want):
        _close(g, np.asarray(w), TOL)

    y_all, s_all = rwkv.wkv_chunked(*_t(r, k, v, logw, u), chunk=4)
    ys, s = rwkv.wkv_chunked(*_t(*(a[:, :24] for a in (r, k, v, logw)), u), chunk=8)
    ys = [ys]
    for t in range(24, 28):
        y, s = rwkv.wkv_decode_step(*_t(*(a[:, t:t + 1] for a in (r, k, v, logw)), u), s)
        ys.append(y)
    _close(torch.cat(ys, 1), y_all.numpy(), TOL)
    _close(s, s_all.numpy(), TOL)
    jy, js = jrwkv.wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u)), chunk=4)
    _close(y_all, np.asarray(jy), TOL)
    _close(s_all, np.asarray(js), TOL)


@pytest.mark.parametrize("last", [None, "float32", "bfloat16"])
def test_token_shift_and_group_norm_match_reference(last):
    """``_token_shift`` (zeros at t = 0, or the cached last token cast to
    the input's dtype, bf16 too) bit for bit, and ``_group_norm`` within
    TOL x max, against the reference's."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    prev = None if last is None else rng.standard_normal((2, 64)).astype(np.float32)
    jprev = None if prev is None else jnp.asarray(prev).astype(last)
    tprev = None if prev is None else torch.from_numpy(prev).to(getattr(torch, last))
    want = np.asarray(jrwkv._token_shift(jnp.asarray(x), jprev))
    np.testing.assert_array_equal(rwkv._token_shift(torch.from_numpy(x), tprev).numpy(), want)
    scale = (1 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = np.asarray(jrwkv._group_norm(jnp.asarray(x), 4, jnp.asarray(scale),
                                        jnp.asarray(bias), 1e-5))
    _close(rwkv._group_norm(*_t(x), 4, *_t(scale, bias), 1e-5), want, TOL)


def test_pick_chunk_matches_reference():
    """The largest of 32, 16, 8, 4, 2, 1 dividing L, for L = 1..64: an odd
    prompt runs chunk 1."""
    got = [rwkv._pick_chunk(n) for n in range(1, 65)]
    assert got == [jrwkv._pick_chunk(n) for n in range(1, 65)]
    assert rwkv._pick_chunk(511) == 1 and rwkv._pick_chunk(512) == 32


# ---------------------------------------------------------------------------
# Config, specs, plan, cache
# ---------------------------------------------------------------------------


def _spec_dtypes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items()
                for k, v in _spec_dtypes(t, f"{prefix}/{n}").items()}
    return {prefix: None if tree.dtype is None else str(tree.dtype).split(".")[-1].strip("'>")}


def test_config_specs_and_cache_specs_match_reference():
    """The published config and ``reduced()`` field for field, the spec
    trees leaf for leaf (shape, axes, init), and the decode cache's specs:
    shapes, axes, inits and dtypes (``wkv`` in fp32, ``index`` int32; no
    pos/valid), but for the shift states: fp32 in the port, where the
    reference declares the cache's default dtype and carries fp32 (the
    module docstring says why)."""
    for reduced in (True, False):
        got = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        want = dataclasses.asdict(jget_config(ARCH, reduced=reduced))
        assert got == {k: want[k] for k in got}
        cfg, jcfg = get_config(ARCH, reduced=reduced), jget_config(ARCH, reduced=reduced)
        assert cfg.rwkv_heads == jcfg.rwkv_heads
        assert _shapes(model_specs(cfg)) == _shapes(jmodel_specs(jcfg))
        got, want = cache_specs(cfg, 3, 40), jcache_specs(jcfg, 3, 40)
        assert _shapes(got) == _shapes(want)
        dtypes, want_dtypes = _spec_dtypes(got), _spec_dtypes(want)
        for key in ("/layers/shift_a", "/layers/shift_c"):
            assert dtypes.pop(key) == "float32" and want_dtypes.pop(key) is None
        assert dtypes == want_dtypes
    assert set(cache_specs(get_config(ARCH), 4, 544)) == {"index", "layers"}
    assert cache_specs(get_config(ARCH), 4, 544)["layers"]["wkv"].shape == (32, 4, 40, 64, 64)


def test_serving_plan_matches_reference(world):
    """The recipe's plan of the same weights is the reference's, JSON for
    JSON: the eight projections a layer and ``lm_head``, no sibling group
    (each projection reads its own mixed input), the decay LoRA, mixes and
    bonus raw; the converted trees hold one ``LUTLinear`` per projection
    and the plan's table bytes."""
    tm = _recipe(world["tp"], plan_model)
    assert tm.to_json() == world["jm"].to_json()
    assert set(tm.layers) == {f"blocks/{p}" for p in PROJECTIONS} | {"lm_head"}
    assert not tm.groups and tm.total_lut_bytes == world["jm"].total_lut_bytes
    for tree in (world["tlut"], world["tconv"]):
        for path in PROJECTIONS:
            part, name = path.split("/")
            assert isinstance(tree["blocks"][part][name], LUTLinear)
        assert isinstance(tree["blocks"]["time"]["decay_A"], torch.Tensor)
    conv = convert_params(world["tp"], plan=ModelPlan.from_json(tm.to_json()))[1]
    assert conv.table_bytes == tm.total_lut_bytes and conv.converted == len(tm.layers)


@pytest.mark.parametrize("masked", [False, True])
def test_advance_meta_index_only_matches_reference(world, masked):
    """An O(1)-state cache advances ``index`` alone: by S, or by each row's
    real tokens under ``token_mask``; the write carries the pre-write
    index, as the reference's."""
    cfg, jcfg = world["cfg"], world["jcfg"]
    mask = np.arange(5)[None, :] < np.asarray([5, 3])[:, None] if masked else None
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)) + 2
    cache = make_cache(cfg, 2, 16, Ctx(cfg), device="cpu")
    cache["index"].fill_(2)
    jc = dict(jmake_cache(jcfg, 2, 16, _jctx(jcfg)), index=jnp.full((2,), 2, jnp.int32))
    cache, w = advance_meta(cache, torch.from_numpy(pos.copy()), None,
                            None if mask is None else torch.from_numpy(mask))
    jc, jw = jadvance_meta(jc, jnp.asarray(pos), None, None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(cache["index"].numpy(), np.asarray(jc["index"]))
    np.testing.assert_array_equal(w.index.numpy(), np.asarray(jw.index))
    assert cache["index"].tolist() == ([7, 5] if masked else [7, 7])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _jlogits(params, jcfg, tokens=TOKENS):
    fwd = jax.jit(lambda p, t: jmodel_forward(p, {"tokens": t}, _jctx(jcfg))[0])
    return np.asarray(fwd(params, jnp.asarray(tokens)))


def _logits(params, cfg, tokens=TOKENS):
    with torch.no_grad():
        return model_forward(params, {"tokens": torch.from_numpy(tokens)}, Ctx(cfg))[0]


@pytest.mark.parametrize("params", ["tp", "tlut", "tconv"])
def test_logits_match_reference(world, params):
    """``model_forward`` logits over 12 tokens (chunk 4) on the dense tree
    within TOL x max; on the converted trees synchronized at every pack
    site (8 a layer and the head's), the same tolerance."""
    if params == "tp":
        _close(_logits(world["tp"], world["cfg"]), _jlogits(world["jp"], world["jcfg"]), TOL)
        return
    want, got = _synced(world, "logits", lambda: _jlogits(world["jlut"], world["jcfg"]),
                        lambda: _logits(world[params], world["cfg"]))
    _close(got, want, TOL)


def _jprefill_decode(params, jcfg, n_pre: int, dtype):
    """The reference's prefill of ``n_pre`` tokens then one fed token at a
    time: the logits at positions n_pre - 1 .. S - 2, the layer states
    after the prefill and the final cache."""
    jctx = _jctx(jcfg)
    jc = jmake_cache(jcfg, 2, TOKENS.shape[1], jctx, dtype=dtype)
    fwd = jax.jit(lambda p, t, c: jmodel_forward(p, {"tokens": t}, jctx, cache=c)[:2])
    lg, jc = fwd(params, jnp.asarray(TOKENS[:, :n_pre]), jc)
    prefilled = jax.tree.map(np.asarray, jc["layers"])
    out = [np.asarray(lg[:, -1])]
    for t in range(n_pre, TOKENS.shape[1] - 1):
        lg, jc = fwd(params, jnp.asarray(TOKENS[:, t:t + 1]), jc)
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out, 1), prefilled, jax.tree.map(np.asarray, jc)


def _prefill_decode(params, cfg, n_pre: int, dtype):
    """The port's :func:`_jprefill_decode` through ``make_prefill_step`` /
    ``make_decode_step``."""
    ctx = Ctx(cfg)
    cache = make_cache(cfg, 2, TOKENS.shape[1], ctx, dtype=dtype, device="cpu")
    tok = torch.from_numpy(TOKENS)
    with torch.no_grad():
        lg, cache = make_prefill_step(ctx)(params, {"tokens": tok[:, :n_pre]}, cache)
        prefilled = {k: v.clone() for k, v in cache["layers"].items()}
        out, decode = [lg[:, -1]], make_decode_step(ctx)
        for t in range(n_pre, TOKENS.shape[1] - 1):
            _, lg, cache = decode(params, cache, tok[:, t:t + 1])
            out.append(lg[:, -1])
    return torch.stack(out, 1), prefilled, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_reference(world, dtype):
    """A 7-token prefill (chunk 1) then 4 fed decode steps through a cache
    of the given dtype, against the reference's and against one chunked
    forward over the sequence.  After the prefill the WKV and shift states
    are within TOL x max of the reference's, the shift states fp32 on
    either cache (the reference's fp32 carry); the decode logits and final
    states within TOL."""
    n_pre = 7
    got, prefilled, cache = _prefill_decode(world["tp"], world["cfg"], n_pre,
                                            getattr(torch, dtype))
    want, jprefilled, jc = _jprefill_decode(world["jp"], world["jcfg"], n_pre,
                                            getattr(jnp, dtype))
    full = _logits(world["tp"], world["cfg"]).numpy()[:, n_pre - 1:-1]
    _close(got, want, TOL)
    _close(got, full, TOL)
    np.testing.assert_array_equal(cache["index"].numpy(), jc["index"])
    assert cache["index"].tolist() == [TOKENS.shape[1] - 1] * 2
    _close(prefilled["wkv"], jprefilled["wkv"], TOL)
    for key in ("shift_a", "shift_c"):
        assert prefilled[key].dtype == cache["layers"][key].dtype == torch.float32
        assert jprefilled[key].dtype == np.float32
        _close(prefilled[key], jprefilled[key], TOL)
    for key, t in cache["layers"].items():
        _close(t.float(), np.asarray(jc["layers"][key], np.float32), TOL)


@pytest.mark.parametrize("params", ["tlut", "tconv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_reference(world, params, dtype):
    """Greedy ``generate`` (a 7-token prompt, chunk 1; 6 new tokens) on the
    converted trees, synchronized at every pack site, with the port's cache
    made of ``dtype`` (bf16 is the default; the recurrent states are fp32
    on either): the reference's streams whole."""
    cache_of = functools.partial(make_cache, dtype=getattr(torch, dtype))
    want, got = _synced(
        world, "generate",
        lambda: np.asarray(jgenerate(world["jlut"], _jctx(world["jcfg"]),
                                     jnp.asarray(GEN_PROMPT), max_new=GEN_NEW)),
        lambda: _with_cache(cache_of, lambda: generate(
            world[params], Ctx(world["cfg"]), GEN_PROMPT, GEN_NEW, device="cpu").numpy()))
    np.testing.assert_array_equal(got, want)


def _with_cache(maker, fn):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "make_cache", maker)
        return fn()


def test_generate_on_the_default_cache(world):
    """Greedy ``generate`` on the dense tree and its default (bf16) cache:
    the reference's streams whole."""
    want = np.asarray(jgenerate(world["jp"], _jctx(world["jcfg"]), jnp.asarray(GEN_PROMPT),
                                max_new=GEN_NEW))
    got = generate(world["tp"], Ctx(world["cfg"]), GEN_PROMPT, GEN_NEW, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_refusals_match_reference(world):
    """Both packages refuse a ``page_size`` (``ValueError``), a
    ``token_mask`` and ``BatchingEngine`` (``NotImplementedError``, a
    recurrent state has no slot-targeted write), and raise
    ``CacheOverflowError`` up front when prompt + max_new - 1 exceeds
    ``max_len``; one slot more serves."""
    cfg, jcfg, jctx = world["cfg"], world["jcfg"], _jctx(world["jcfg"])
    with pytest.raises(ValueError, match="O\\(1\\)-state"):
        generate(world["tp"], Ctx(cfg), GEN_PROMPT, 2, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="O\\(1\\)-state"):
        jgenerate(world["jp"], jctx, jnp.asarray(GEN_PROMPT), max_new=2, page_size=8)
    mask = np.ones(TOKENS.shape, bool)
    with pytest.raises(NotImplementedError, match="token_mask"):
        model_forward(world["tp"], {"tokens": torch.from_numpy(TOKENS),
                                    "token_mask": torch.from_numpy(mask)}, Ctx(cfg))
    with pytest.raises(NotImplementedError, match="token_mask"):
        jmodel_forward(world["jp"], {"tokens": jnp.asarray(TOKENS),
                                     "token_mask": jnp.asarray(mask)}, jctx)
    with pytest.raises(NotImplementedError, match="slot-targeted"):
        BatchingEngine(world["tp"], Ctx(cfg), 2, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="slot-targeted"):
        JEngine(world["jp"], jctx, 2, 16)
    S = GEN_PROMPT.shape[1]
    with pytest.raises(CacheOverflowError):
        generate(world["tp"], Ctx(cfg), GEN_PROMPT, 3, max_len=S + 1, device="cpu")
    with pytest.raises(JCacheOverflowError):
        jgenerate(world["jp"], jctx, jnp.asarray(GEN_PROMPT), max_new=3, max_len=S + 1)
    assert generate(world["tp"], Ctx(cfg), GEN_PROMPT, 3, max_len=S + 2,
                    device="cpu").shape == (2, 3)
