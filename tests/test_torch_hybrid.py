"""The zamba2 hybrid family (zamba2_1_2b) in the port against the JAX
package, on the CPU: the reduced config (5 mamba layers, d_model 64, 8
mamba heads of 16, state 16, conv 4; the shared attention + MLP block every
2 layers, so segments [2, 2, 1] and 2 shared invocations), fp32 weights
from a numpy seed carried across by ``params_from_numpy``.

``init_params`` zeroes ``A_log`` and ``dt_bias`` (every head would decay at
A = -1) and sets ``D`` and the norm scales to 1, where a head-order slip
in ``D`` (``jnp.repeat`` repeats each head's value P times; torch's
``Tensor.repeat`` would tile them) shows nothing.  Here they are drawn from
a seed: A ~ U[1, 16] with ``A_log = log A`` and dt log-uniform in [1e-3,
1e-1] with ``dt_bias = dt + log(-expm1(-dt))``, Mamba-2's published
initialisation, and ``D``, ``conv_b`` and the norm scales at random; both
packages get the same values.

* ``ssd_chunked`` at several lengths and chunks, from zeros or a state, in
  fp32 and with bf16 intra-chunk tensors, ``ssd_decode_step``,
  ``_causal_conv_full``, the cached conv window and ``_pick_chunk``,
  against the reference's functions and an fp64 recurrence.
* ``mamba_block`` in its three branches (no cache, decode, a prefill
  continuing from a cached state).
* The config, the spec tree, ``segments``, the cache specs dense and paged,
  the serving recipe's plan (JSON for JSON: the G = 3 ``wq+wk+wv`` group
  of the shared block), ``params_from_numpy`` on the raw and converted
  trees.
* Whole-model logits, unconverted and converted, and greedy ``generate``
  streams, whole, synchronized at every pack site and cache write by
  ``tests/test_torch_dense_families.py``'s :class:`Tape`.
* The refusals: ``page_size``, ``token_mask``, ``BatchingEngine``, and
  ``CacheOverflowError``.

The SSD states are fp32 in both packages; the conv window is fp32 in the
port's cache and in the activations' dtype (fp32 here) in the reference's
carry, so the two carries are the same.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve._engine as jengine
import repro_torch.serve._engine as tengine
from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.models import hybrid as jhybrid
from repro.models import ssm as jssm
from repro.models.model import model_forward as jmodel_forward
from repro.models.model import model_specs as jmodel_specs
from repro.serve import BatchingEngine as JEngine
from repro.serve import CacheOverflowError as JCacheOverflowError
from repro.serve import generate as jgenerate
from repro.serve import make_cache as jmake_cache
from repro.serve._cache import cache_specs as jcache_specs
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTGroup, LUTLinear, convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.models import hybrid, ssm
from repro_torch.models.layers import Ctx, ExecCfg
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
from repro_torch.serve._cache import cache_specs
from test_torch_dense_families import _close, _jctx, _recipe, _shapes, _synced
from test_torch_moe import numpy_params
from test_torch_rwkv import _spec_dtypes

ARCH = "zamba2_1_2b"
TOL = 1e-5  # x max|reference|: fp32 sums in another order
# x max|reference| with bf16 intra-chunk tensors: the same roundings in both
# packages, then fp32 sums in another order
BF16_TOL = 1e-4
TOKENS = np.random.default_rng(91).integers(0, 512, (2, 12)).astype(np.int32)
GEN_PROMPT = np.asarray([[5, 9, 2, 7, 1, 30, 4], [3, 8, 4, 6, 11, 2, 9]], np.int32)
GEN_NEW = 6
MAMBA = ("mamba/mix/in_proj", "mamba/mix/out_proj")


def seeded_leaves(tree: dict, seed: int) -> dict:
    """``tree`` (numpy) with the leaves ``init_params`` sets to constants
    drawn from a seed: ``A_log = log A``, A ~ U[1, 16]; ``dt_bias`` the
    inverse softplus of dt, log-uniform in [1e-3, 1e-1] (Mamba-2's
    initialisation); ``D`` ~ U(0.5, 1.5), ``conv_b`` ~ N(0, 0.1), and every
    norm scale ~ 1 + N(0, 0.2)."""
    rng = np.random.default_rng(seed)
    mix = tree["mamba"]["mix"]
    shape = mix["A_log"].shape
    mix["A_log"] = np.log(rng.uniform(1.0, 16.0, shape)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
    mix["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
    mix["D"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
    mix["conv_b"] = (0.1 * rng.standard_normal(mix["conv_b"].shape)).astype(np.float32)
    mix["norm_scale"] = (1 + 0.2 * rng.standard_normal(mix["norm_scale"].shape)).astype(
        np.float32)
    for norm in (tree["mamba"]["ln"], tree["shared"]["ln1"], tree["shared"]["ln2"],
                 tree["ln_f"]):
        norm["scale"] = (1 + 0.2 * rng.standard_normal(norm["scale"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    tree = seeded_leaves(numpy_params(model_specs(cfg), 92), 93)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    jm = _recipe(jp, jplan_model)
    mplan = ModelPlan.from_json(jm.to_json())
    jlut, _ = jconvert(jp, plan=jm)
    return dict(
        jcfg=jcfg, cfg=cfg, tree=tree, jp=jp, tp=tp, jm=jm, jlut=jlut,
        tlut=params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan),
        tconv=convert_params(tp, plan=mplan)[0], tapes={},
    )


# ---------------------------------------------------------------------------
# The SSD scan, the conv, the mixer
# ---------------------------------------------------------------------------


def _ssd_inputs(seed: int, L: int, B: int = 2, H: int = 3, P: int = 4, N: int = 5):
    """x (B, L, H, P), dt (B, L, H) post-softplus, A (H,), B and C (B, L,
    N) and a state (B, H, P, N) from a numpy seed, dt and A at Mamba-2's
    initialisation's ranges (dt in [1e-3, 1e-1] and a little beyond, A in
    [-16, -1])."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(3e-1), (B, L, H))).astype(np.float32)
    A = -rng.uniform(1.0, 16.0, H).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, L, N)).astype(np.float32) for _ in range(2))
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, state


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def ssd_recurrent_ref(x, dt, A, Bm, Cm, state=None):
    """The O(L) recurrence in fp64, from zeros or ``state``:
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t^T;  y_t = h_t C_t."""
    x, dt, A, Bm, Cm = (np.asarray(a, np.float64) for a in (x, dt, A, Bm, Cm))
    B, L, H, P = x.shape
    h = np.zeros((B, H, P, Bm.shape[-1])) if state is None else state.astype(np.float64)
    ys = []
    for t in range(L):
        h = h * np.exp(dt[:, t] * A)[:, :, None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t][..., None], Bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return np.stack(ys, 1), h


@pytest.mark.parametrize("L,chunk,init,bf16", [
    (16, 1, False, False), (16, 4, True, False), (64, 16, False, False),
    (64, 64, True, False), (64, 16, False, True), (64, 64, True, True),
])
def test_ssd_chunked_matches_reference(L, chunk, init, bf16):
    """``ssd_chunked``: outputs and the final state within TOL x max of the
    reference's (BF16_TOL with bf16 intra-chunk tensors, the reference run
    the same way), from zeros or a given state; in fp32 both within TOL of
    an fp64 recurrence, and an L that ``chunk`` does not divide raises."""
    x, dt, A, Bm, Cm, state = _ssd_inputs(L + chunk, L)
    s0 = state if init else None
    ref = jax.jit(functools.partial(jssm.ssd_chunked, chunk=chunk,
                                    compute_dtype=jnp.bfloat16 if bf16 else jnp.float32))
    want_y, want_s = ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                         init_state=None if s0 is None else jnp.asarray(s0))
    got_y, got_s = ssm.ssd_chunked(
        *_t(x, dt, A, Bm, Cm), chunk=chunk,
        init_state=None if s0 is None else torch.from_numpy(s0),
        compute_dtype=torch.bfloat16 if bf16 else torch.float32)
    assert got_y.dtype == got_s.dtype == torch.float32
    tol = BF16_TOL if bf16 else TOL
    _close(got_y, np.asarray(want_y), tol)
    _close(got_s, np.asarray(want_s), tol)
    if not bf16:
        exact_y, exact_s = ssd_recurrent_ref(x, dt, A, Bm, Cm, s0)
        for got, want in ((got_y, exact_y), (got_s, exact_s),
                          (np.asarray(want_y), exact_y), (np.asarray(want_s), exact_s)):
            _close(got, want, TOL)
    if chunk > 1:
        with pytest.raises(ValueError, match="does not divide"):
            ssm.ssd_chunked(*_t(x[:, :-1], dt[:, :-1], A, Bm[:, :-1], Cm[:, :-1]), chunk=chunk)


def test_ssd_decode_step_and_chunked_prefill_continue_one_pass():
    """``ssd_decode_step`` against the reference's from a given state; a
    chunked prefill of 24 tokens (chunk 8) then 4 decode steps give the
    outputs and the state of one chunked pass over all 28 (chunk 4)."""
    x, dt, A, Bm, Cm, state = _ssd_inputs(5, 28)
    one = [a[:, :1] for a in (x, dt)] + [A] + [a[:, :1] for a in (Bm, Cm)]
    want = jssm.ssd_decode_step(*map(jnp.asarray, one + [state]))
    got = ssm.ssd_decode_step(*_t(*one, state))
    for g, w in zip(got, want):
        _close(g, np.asarray(w), TOL)

    y_all, s_all = ssm.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk=4)
    ys, s = ssm.ssd_chunked(*_t(x[:, :24], dt[:, :24], A, Bm[:, :24], Cm[:, :24]), chunk=8)
    ys = [ys]
    for t in range(24, 28):
        y, s = ssm.ssd_decode_step(*_t(x[:, t:t + 1], dt[:, t:t + 1], A, Bm[:, t:t + 1],
                                       Cm[:, t:t + 1]), s)
        ys.append(y)
    _close(torch.cat(ys, 1), y_all.numpy(), TOL)
    _close(s, s_all.numpy(), TOL)


def test_causal_conv_and_cached_window():
    """``_causal_conv_full`` against the reference's; over a cached window
    (the last K - 1 inputs before the step, then the step's) it gives the
    full sequence's conv at the step's positions."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    want = np.asarray(jssm._causal_conv_full(*map(jnp.asarray, (x, w, b))))
    full = ssm._causal_conv_full(*_t(x, w, b))
    _close(full, want, TOL)
    for start in (3, 5, 8):  # steps of 6, 4 and 1 tokens after start inputs
        window = torch.from_numpy(x[:, start - 3:])
        got = ssm._causal_conv_full(window, *_t(w, b))[:, 3:]
        _close(got, full.numpy()[:, start:], TOL)


def test_pick_chunk_matches_reference():
    """The largest of 64, 32, ..., 1 dividing L, for L = 1..130: an odd
    prompt runs chunk 1."""
    got = [ssm._pick_chunk(n) for n in range(1, 131)]
    assert got == [jssm._pick_chunk(n) for n in range(1, 131)]
    assert ssm._pick_chunk(127) == 1 and ssm._pick_chunk(512) == 64


def _jmamba(jcfg, **ex):
    """The reference's ``mamba_block``, jitted: (params, x, cache)."""
    jctx = _jctx(jcfg, **ex)
    return jax.jit(lambda p, x, c: jssm.mamba_block(p, x, jctx, cache=c))


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["mamba"]["mix"])


@pytest.mark.parametrize("branch", ["none", "decode", "prefill"])
def test_mamba_block_matches_reference(world, branch):
    """Layer 0's mixer on the dense tree in each branch: without a cache
    over 8 tokens; decode (1 token) and a 6-token prefill from a cached
    conv window and SSD state.  Outputs and the new cache within TOL x max
    of the reference's; the new conv window is the last K - 1 inputs."""
    cfg, jcfg = world["cfg"], world["jcfg"]
    layer = _layer0(world["tree"])
    rng = np.random.default_rng(7)
    L = {"none": 8, "decode": 1, "prefill": 6}[branch]
    x = rng.standard_normal((2, L, cfg.d_model)).astype(np.float32)
    cache = None
    if branch != "none":
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        cache = {
            "conv": rng.standard_normal((2, cfg.conv_kernel - 1, conv_dim)).astype(np.float32),
            "state": rng.standard_normal((2, cfg.mamba_heads, cfg.mamba_head_dim,
                                          cfg.ssm_state)).astype(np.float32),
        }
    want, want_c = _jmamba(jcfg)(jax.tree.map(jnp.asarray, layer), jnp.asarray(x),
                                 None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, got_c = ssm.mamba_block(params_from_numpy(layer, device="cpu"), torch.from_numpy(x),
                                 Ctx(cfg), cache=None if cache is None else
                                 {k: torch.from_numpy(v) for k, v in cache.items()})
    _close(got, np.asarray(want), TOL)
    if cache is None:
        assert got_c is None and want_c is None
        return
    for key in ("conv", "state"):
        _close(got_c[key], np.asarray(want_c[key]), TOL)
    din, N = cfg.d_inner, cfg.ssm_state
    xBC = (x @ layer["in_proj"]["w"])[..., din:2 * din + 2 * N]
    tail = np.concatenate([cache["conv"], xBC], 1)[:, -(cfg.conv_kernel - 1):]
    _close(got_c["conv"], tail, TOL)


def test_mamba_block_bf16_intra_chunk_and_chunk_knob(world):
    """``ExecCfg(ssd_bf16=True)`` on a forward without a cache against the
    reference's (BF16_TOL), and within 1e-2 x max of the fp32 forward;
    ``ssd_chunk`` picks the chunk (2 and 8 give one answer within TOL) and
    one that does not divide the length raises, as the reference asserts."""
    cfg, jcfg = world["cfg"], world["jcfg"]
    layer = _layer0(world["tree"])
    x = np.random.default_rng(8).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    tl = params_from_numpy(layer, device="cpu")
    want = _jmamba(jcfg, ssd_bf16=True)(jax.tree.map(jnp.asarray, layer), jnp.asarray(x),
                                        None)[0]
    got = ssm.mamba_block(tl, torch.from_numpy(x), Ctx(cfg, ex=ExecCfg(ssd_bf16=True)))[0]
    _close(got, np.asarray(want), BF16_TOL)
    f32 = ssm.mamba_block(tl, torch.from_numpy(x), Ctx(cfg))[0]
    _close(got, f32.numpy(), 1e-2)
    by_chunk = [ssm.mamba_block(tl, torch.from_numpy(x), Ctx(cfg, ex=ExecCfg(ssd_chunk=c)))[0]
                for c in (2, 8)]
    _close(by_chunk[0], by_chunk[1].numpy(), TOL)
    with pytest.raises(ValueError, match="does not divide"):
        ssm.mamba_block(tl, torch.from_numpy(x[:, :15]), Ctx(cfg, ex=ExecCfg(ssd_chunk=4)))


# ---------------------------------------------------------------------------
# Config, specs, plan, cache, params
# ---------------------------------------------------------------------------


def test_config_specs_and_cache_specs_match_reference():
    """The published config and ``reduced()`` field for field with the
    derived widths, ``segments``, the spec trees leaf for leaf (shape, axes,
    init), and the decode cache's specs, dense and paged: shapes, axes and
    inits the reference's (paged: the port's pool has one page more, the
    sink), dtypes the reference's but for the conv window, fp32 in the port
    (the module docstring says why)."""
    for reduced in (True, False):
        cfg, jcfg = get_config(ARCH, reduced=reduced), jget_config(ARCH, reduced=reduced)
        got = dataclasses.asdict(cfg)
        assert got == {k: dataclasses.asdict(jcfg)[k] for k in got}
        assert (cfg.d_inner, cfg.mamba_heads) == (jcfg.d_inner, jcfg.mamba_heads)
        assert hybrid.segments(cfg) == jhybrid.segments(jcfg)
        assert _shapes(model_specs(cfg)) == _shapes(jmodel_specs(jcfg))
        for page_size in (None, 4):
            got, want = (cache_specs(cfg, 3, 40, page_size=page_size),
                         jcache_specs(jcfg, 3, 40, page_size=page_size))
            if page_size is not None:  # the sink page
                for name, spec in want["shared_attn"].items():
                    want["shared_attn"][name] = dataclasses.replace(
                        spec, shape=(spec.shape[0], spec.shape[1] + 1) + spec.shape[2:])
            assert _shapes(got) == _shapes(want)
            dtypes, want_dtypes = _spec_dtypes(got), _spec_dtypes(want)
            assert dtypes.pop("/layers/conv") == "float32" and want_dtypes.pop(
                "/layers/conv") is None
            assert dtypes == want_dtypes
    assert hybrid.segments(get_config(ARCH)) == [6] * 6 + [2]
    full = cache_specs(get_config(ARCH), 4, 544)
    assert full["shared_attn"]["k"].shape == (6, 4, 544, 32, 64)
    assert full["layers"]["state"].shape == (38, 4, 64, 64, 64)
    assert full["layers"]["conv"].shape == (38, 4, 3, 4224)


def test_serving_plan_and_params_from_numpy(world):
    """The recipe's plan of the same weights is the reference's, JSON for
    JSON: the mamba layers' ``in_proj`` / ``out_proj`` and the shared
    block's ``wo``, ``w_down`` and ``lm_head`` lone, its ``wq+wk+wv``
    (G = 3: reduced and published zamba2 have as many KV heads as heads)
    and ``w_gate+w_up`` grouped; the conv, ``A_log``, ``dt_bias``, ``D``
    and norms raw.  ``params_from_numpy`` carries the raw tree leaf for
    leaf and the reference's converted tree node for node (stacked mamba
    tables, the shared block's groups), as the port's own conversion
    builds them; both take the plan's table bytes."""
    tm = _recipe(world["tp"], plan_model)
    assert tm.to_json() == world["jm"].to_json()
    groups = {tuple(k.rsplit("/", 1)[-1] for k in g) for g in tm.groups}
    assert groups == {("wq", "wk", "wv"), ("w_gate", "w_up")}
    lone = {"mamba/mix/in_proj", "mamba/mix/out_proj", "shared/attn/wo", "shared/mlp/w_down",
            "lm_head"}
    assert lone <= set(tm.layers) and len(tm.layers) == len(lone) + 5
    for key, leaf in jax.tree_util.tree_leaves_with_path(world["jp"]):
        path = tuple(k.key for k in key)
        node = world["tp"]
        for k in path:
            node = node[k]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    for tree in (world["tlut"], world["tconv"]):
        mix, shared = tree["mamba"]["mix"], tree["shared"]
        for name in ("in_proj", "out_proj"):
            assert isinstance(mix[name], LUTLinear) and mix[name].tables.shape[0] == 5
        assert isinstance(shared["attn"]["wq+wk+wv"], LUTGroup)
        assert shared["attn"]["wq+wk+wv"].tables.shape[0] == 3
        assert isinstance(shared["mlp"]["w_gate+w_up"], LUTGroup)
        assert set(shared["attn"]) == set(world["jlut"]["shared"]["attn"])
        assert isinstance(mix["A_log"], torch.Tensor)
    got = world["tlut"]["mamba"]["mix"]["in_proj"].tables
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(world["jlut"]["mamba"]["mix"]["in_proj"].tables))
    np.testing.assert_array_equal(world["tconv"]["mamba"]["mix"]["in_proj"].tables.numpy(),
                                  got.numpy())
    conv = convert_params(world["tp"], plan=ModelPlan.from_json(tm.to_json()))[1]
    assert conv.table_bytes == tm.total_lut_bytes == world["jm"].total_lut_bytes


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _jlogits(params, jcfg, tokens=TOKENS):
    fwd = jax.jit(lambda p, t: jmodel_forward(p, {"tokens": t}, _jctx(jcfg))[0])
    return np.asarray(fwd(params, jnp.asarray(tokens)))


def _logits(params, cfg, tokens=TOKENS, **ex):
    with torch.no_grad():
        return model_forward(params, {"tokens": torch.from_numpy(tokens)},
                             Ctx(cfg, ex=ExecCfg(**ex)))[0]


@pytest.mark.parametrize("params", ["tp", "tlut", "tconv"])
def test_logits_match_reference(world, params):
    """``model_forward`` logits over 12 tokens (chunk 4) on the dense tree
    within TOL x max; on the converted trees synchronized at every pack
    site, flat and grouped launches, the same tolerance."""
    if params == "tp":
        _close(_logits(world["tp"], world["cfg"]), _jlogits(world["jp"], world["jcfg"]), TOL)
        return
    for grouped in (False, True):
        want, got = _synced(world, "logits", lambda: _jlogits(world["jlut"], world["jcfg"]),
                            lambda: _logits(world[params], world["cfg"], lut_grouped=grouped))
        _close(got, want, TOL)


def _jprefill_decode(params, jcfg, n_pre: int):
    """The reference's prefill of ``n_pre`` tokens then one fed token at a
    time into its default (bf16) cache: the logits at positions n_pre - 1
    .. S - 2 and the final cache."""
    jctx = _jctx(jcfg)
    jc = jmake_cache(jcfg, 2, TOKENS.shape[1], jctx)
    fwd = jax.jit(lambda p, t, c: jmodel_forward(p, {"tokens": t}, jctx, cache=c)[:2])
    lg, jc = fwd(params, jnp.asarray(TOKENS[:, :n_pre]), jc)
    out = [np.asarray(lg[:, -1])]
    for t in range(n_pre, TOKENS.shape[1] - 1):
        lg, jc = fwd(params, jnp.asarray(TOKENS[:, t:t + 1]), jc)
        out.append(np.asarray(lg[:, -1]))
    return np.stack(out, 1), jax.tree.map(np.asarray, jc)


def _prefill_decode(params, cfg, n_pre: int):
    """The port's :func:`_jprefill_decode` through ``make_prefill_step`` /
    ``make_decode_step``, into the default (bf16) cache."""
    ctx = Ctx(cfg)
    cache = make_cache(cfg, 2, TOKENS.shape[1], ctx, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache["layers"].items()}
    tok = torch.from_numpy(TOKENS)
    with torch.no_grad():
        lg, cache = make_prefill_step(ctx)(params, {"tokens": tok[:, :n_pre]}, cache)
        out, decode = [lg[:, -1]], make_decode_step(ctx)
        for t in range(n_pre, TOKENS.shape[1] - 1):
            _, lg, cache = decode(params, cache, tok[:, t:t + 1])
            out.append(lg[:, -1])
    assert ptrs == {k: v.data_ptr() for k, v in cache["layers"].items()}  # in place
    return torch.stack(out, 1), cache


def test_prefill_then_decode_matches_reference(world):
    """A 7-token prefill (chunk 1) then 4 fed decode steps through the
    default cache (the shared block's K/V in bf16, the SSD states fp32), on
    the dense tree, synchronized at every cache write (the reference's K/V
    rounded by both): logits within TOL x max of the reference's and of one
    chunked forward over the sequence less TOL's share of the bf16 K/V (a
    forward without a cache attends over fp32 K/V: 1e-2), every cache leaf
    within TOL of the reference's, ``pos`` / ``valid`` / ``index`` equal."""
    n_pre = 7
    want, got = _synced(world, "prefill_decode",
                        lambda: _jprefill_decode(world["jp"], world["jcfg"], n_pre),
                        lambda: _prefill_decode(world["tp"], world["cfg"], n_pre))
    (want, jc), (got, cache) = want, got
    _close(got, want, TOL)
    full = _logits(world["tp"], world["cfg"]).numpy()[:, n_pre - 1:-1]
    _close(got, full, 1e-2)
    for part in ("layers", "shared_attn"):
        for key, t in cache[part].items():
            _close(t.float(), np.asarray(jc[part][key], np.float32), TOL)
    for key in ("pos", "valid", "index"):
        np.testing.assert_array_equal(cache[key].numpy(), jc[key])
    assert cache["index"].tolist() == [TOKENS.shape[1] - 1] * 2


def _with_make_cache(module, maker, fn):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "make_cache", maker)
        return fn()


@pytest.mark.parametrize("params", ["tlut", "tconv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_reference(world, params, dtype):
    """Greedy ``generate`` (a 7-token prompt, chunk 1 at the prefill; 6 new
    tokens) on the converted trees, synchronized at every pack site and
    cache write, both packages' caches of ``dtype`` (the reference's made so
    in the test): the reference's streams, whole."""
    jmaker = functools.partial(jengine.make_cache, dtype=getattr(jnp, dtype))
    tmaker = functools.partial(tengine.make_cache, dtype=getattr(torch, dtype))
    want, got = _synced(
        world, ("generate", dtype),
        lambda: _with_make_cache(jengine, jmaker, lambda: np.asarray(jgenerate(
            world["jlut"], _jctx(world["jcfg"]), jnp.asarray(GEN_PROMPT), max_new=GEN_NEW))),
        lambda: _with_make_cache(tengine, tmaker, lambda: generate(
            world[params], Ctx(world["cfg"]), GEN_PROMPT, GEN_NEW, device="cpu").numpy()))
    np.testing.assert_array_equal(got, want)


def test_refusals_match_reference(world):
    """Both packages refuse ``generate(..., page_size=...)`` with a
    ``ValueError`` (the reference's ``make_cache`` sizes its identity page
    table's pool from the SSD conv state), a ``token_mask`` and
    ``BatchingEngine`` (``NotImplementedError``: a recurrent state has no
    slot-targeted write), and raise ``CacheOverflowError`` up front when
    prompt + max_new - 1 exceeds ``max_len``; one slot more serves."""
    cfg, jcfg, jctx = world["cfg"], world["jcfg"], _jctx(world["jcfg"])
    with pytest.raises(ValueError, match="identity page table"):
        generate(world["tp"], Ctx(cfg), GEN_PROMPT, 2, max_len=16, page_size=4, device="cpu")
    with pytest.raises(ValueError, match="identity page table"):
        jgenerate(world["jp"], jctx, jnp.asarray(GEN_PROMPT), max_new=2, max_len=16,
                  page_size=4)
    paged = make_cache(cfg, 2, 16, Ctx(cfg), page_size=4, page_table="empty", device="cpu")
    assert paged["shared_attn"]["k"].shape == (2, 2 * 4 + 1, 4, 4, 16)
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
