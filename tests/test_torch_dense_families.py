"""phi3_medium_14b and minitron_4b in the port against the JAX package, on
the CPU: the reduced configs, fp32 weights from a numpy seed (random norm
scales) carried across by ``params_from_numpy``.

phi3 is dense GQA with the gated SwiGLU MLP; its reduced config has as many
KV heads as heads (5 = 5), so ``wq``, ``wk`` and ``wv`` all map 80 -> 80
and the planner fuses them into one G = 3 group (at full width only
``wk+wv`` fuse).  minitron has ``act="relu2"``, nemotron's two-matrix
squared-ReLU MLP (``w_in``, ``w_out``, no bias), whose projections stay
lone.

* The spec trees leaf for leaf; ``mlp`` within 1e-6 x max of the
  reference's, ``silu`` and ``relu2`` (fp32 sums in another order).
* The serving recipe's plan equals the reference's through its JSON.
* Converted (the reference's tables carried across, and the port's own
  conversion under the same plan): ``model_forward`` logits within 1e-5 x
  max; ``generate`` streams equal the reference's whole, dense and paged at
  ``page_size=4``; paged ``BatchingEngine`` streams too, with prefix
  sharing and a copy-on-write hit (greedy, compared whole: tolerance none).
* minitron under the TL1 plan and under ``linear_mode="binary_matmul"``:
  logits to the tolerances of ``tests/test_torch_tl1_serve.py`` and
  ``tests/test_torch_binary_serve.py``.

A converted model rounds twice where a small fp32 difference can move a
value across a boundary: every projection's input to fp16 codes, and every
cached K/V to bf16.  The packages sum in other fp32 orders (~1e-7
relative), so an activation that close to a rounding boundary takes the
neighbouring value in one of them, and i8 tables turn an fp16 code step
into a move of up to ~1 % of the logits (reduced phi3 on these weights: two
codes of layer 0's MLP input, then 7e-3 x max at later positions, and one
greedy token of the twelve that ``generate`` gives).  So the converted
comparisons run synchronized (:class:`Tape`): the reference runs with each
``pack_codes`` and ``update_kv_cache`` call recorded by an ordered
callback, and the port's sites, in the same order, take the reference's
codes and the reference's K/V.  At each site the port's own input must lie
within 1e-5 x max of the reference's, and its pack of the reference's input
must give the reference's codes bit for bit: a value the port would have
rounded otherwise is an input at a rounding boundary and nothing else.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.serve._cache as jcache
import repro_torch.models.layers as L
import repro_torch.serve._cache as tcache
from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.models.layers import mlp as j_mlp
from repro.models.model import model_forward as jmodel_forward
from repro.models.model import model_specs as jmodel_specs
from repro.serve import BatchingEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import generate as jgenerate
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTGroup, LUTLinear, convert_params
from repro_torch.core.lut import pack_codes
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.models.layers import Ctx, ExecCfg, mlp
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import BatchingEngine, Request, generate
from test_torch_moe import numpy_params
from test_torch_paged_cache import PROMPTS

FAMILIES = ["phi3_medium_14b", "minitron_4b"]
MLP_TOL = 1e-6  # x max|reference|: fp32 sums in another order
LOGITS_TOL = 1e-5  # x max|reference|: the same, through two layers and the head
TL1_TOL = 1e-4  # tests/test_torch_tl1_serve.py's: the layers around the integer accumulate
BINARY_TOL = 1e-5  # tests/test_torch_binary_serve.py's
SITE_TOL = 1e-5  # x max|reference's| at a pack site or cache write: fp32 sums in another order
SLOTS, MAX_LEN, MAX_NEW = 3, 32, 6
GEN_PROMPT = np.asarray([[5, 9, 2, 7, 1], [3, 8, 4, 6, 11]], np.int32)
TOKENS = np.random.default_rng(7).integers(0, 512, (2, 9)).astype(np.int32)


def _recipe(params, plan_fn, **kw):
    """The serving recipe (``benchmarks/serving.py::serving_model_plan``:
    half the uniform chunk-2 footprint, the widened frontier)."""
    uniform = plan_fn(params, float("inf"), max_chunk=2, **kw)
    return plan_fn(params, uniform.total_lut_bytes // 2, max_chunk=2,
                   modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
                   table_formats=(None, "i8"), **kw)


def _jctx(jcfg, **kw):
    return JCtx(jcfg, ex=JExecCfg(remat="none", **kw))


def _jlogits(params, jctx, tokens=TOKENS):
    fwd = jax.jit(lambda p, t: jmodel_forward(p, {"tokens": t}, jctx)[0])
    return np.asarray(fwd(params, jnp.asarray(tokens)))


def _logits(params, ctx, tokens=TOKENS):
    return model_forward(params, {"tokens": torch.from_numpy(tokens)}, ctx)[0]


def _close(got, want, tol: float) -> None:
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()))


@pytest.fixture(scope="module", params=FAMILIES)
def world(request):
    arch = request.param
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    tree = numpy_params(model_specs(cfg), 61)
    rng = np.random.default_rng(62)
    for part in ("ln1", "ln2"):  # random norm scales, so that they are exercised
        s = tree["blocks"][part]["scale"]
        tree["blocks"][part]["scale"] = (1 + 0.2 * rng.standard_normal(s.shape)).astype(
            np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    jm = _recipe(jp, jplan_model)
    mplan = ModelPlan.from_json(jm.to_json())
    jlut, _ = jconvert(jp, plan=jm)
    return dict(
        arch=arch, jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jm=jm, jlut=jlut,
        tlut=params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan),
        tconv=convert_params(tp, plan=mplan)[0], tapes={},
    )


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _shapes(t, f"{prefix}/{n}").items()}
    return {prefix: (tuple(tree.shape), tree.axes, tree.init)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_specs_match_reference(arch):
    """The spec tree leaf for leaf (shape, axes, init), reduced and full;
    minitron's FFN is ``w_in``/``w_out`` with no bias."""
    for reduced in (True, False):
        got = _shapes(model_specs(get_config(arch, reduced=reduced)))
        assert got == _shapes(jmodel_specs(jget_config(arch, reduced=reduced)))
    ffn = set(model_specs(get_config(arch))["blocks"]["ffn"])
    assert ffn == ({"w_in", "w_out"} if arch == "minitron_4b" else {"w_gate", "w_up", "w_down"})


@pytest.mark.parametrize("arch", FAMILIES, ids=["silu", "relu2"])
def test_mlp_matches_reference(arch):
    """One layer's MLP on the dense tree: the gated SwiGLU (phi3) and the
    two-matrix squared ReLU (minitron), with negative pre-activations so
    that the ReLU cuts."""
    cfg, jcfg = get_config(arch, reduced=True), jget_config(arch, reduced=True)
    tree = numpy_params(model_specs(cfg), 63)["blocks"]["ffn"]
    layer = {k: {n: t[0] for n, t in v.items()} for k, v in tree.items()}
    x = np.random.default_rng(64).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = np.asarray(j_mlp(jax.tree.map(jnp.asarray, layer), jnp.asarray(x), _jctx(jcfg)))
    got = mlp(params_from_numpy(layer, device="cpu"), torch.from_numpy(x), Ctx(cfg))
    _close(got, want, MLP_TOL)
    if cfg.act == "relu2":
        h = x @ layer["w_in"]["w"]
        assert (h < 0).any() and (h > 0).any()


def test_serving_plan_matches_reference(world):
    """The port's plan of the same weights is the reference's, JSON for
    JSON; its sibling groups: phi3-reduced's G = 3 ``wq+wk+wv``, minitron's
    ``wk+wv`` beside lone ``w_in``/``w_out``; the converted trees hold them."""
    tm = _recipe(world["tp"], plan_model)
    assert tm.to_json() == world["jm"].to_json()
    groups = {tuple(k.rsplit("/", 1)[-1] for k in g) for g in tm.groups}
    attn, ffn = world["tconv"]["blocks"]["attn"], world["tconv"]["blocks"]["ffn"]
    if world["arch"] == "phi3_medium_14b":
        assert groups == {("wq", "wk", "wv"), ("w_gate", "w_up")}
        assert isinstance(attn["wq+wk+wv"], LUTGroup) and attn["wq+wk+wv"].tables.shape[1] == 3
    else:
        assert groups == {("wk", "wv")}
        assert isinstance(attn["wk+wv"], LUTGroup)
        assert isinstance(ffn["w_in"], LUTLinear) and isinstance(ffn["w_out"], LUTLinear)
    for tree in (world["tlut"], world["tconv"]):
        assert set(tree["blocks"]["attn"]) == set(world["jlut"]["blocks"]["attn"])
        assert set(tree["blocks"]["ffn"]) == set(world["jlut"]["blocks"]["ffn"])


class Tape:
    """The reference's roundings, recorded site by site, and the port's
    sites replaying them (see the module docstring): each pack site's
    codes, and the K/V each cache write rounds to bf16."""

    def __init__(self):
        self.sites = []  # the reference's (kind, input, result), in call order
        self.seen = []  # the port's (kind, own input, own result, reference's site, plan)

    @contextlib.contextmanager
    def record(self):
        """Run the reference (jitted or not) with each ``pack_codes`` call and
        each ``update_kv_cache`` call recorded by an ordered callback."""
        pack_codes0, update0 = JL.pack_codes, jcache.update_kv_cache

        def put(kind):
            return lambda a, b: self.sites.append((kind, np.asarray(a), np.asarray(b)))

        def pack_codes_(x, plan):
            codes = pack_codes0(x, plan)
            jax.debug.callback(put("pack"), x, codes, ordered=True)
            return codes

        def update_kv_cache_(cache, k, v, positions, ctx):
            jax.debug.callback(put("kv"), k, v, ordered=True)
            return update0(cache, k, v, positions, ctx)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JL, "pack_codes", pack_codes_)
            mp.setattr(jcache, "update_kv_cache", update_kv_cache_)
            yield

    @contextlib.contextmanager
    def replay(self):
        """Give each of the port's pack sites the reference's codes of the
        same site, and each cache write the reference's K/V; every recorded
        site must be replayed, in order."""
        pack0, update0, sites = L.pack, tcache.update_kv_cache, iter(self.sites)

        def take(kind):
            site = next(sites)
            assert site[0] == kind, (site[0], kind)
            return site

        def pack(x, plan, use_kernels=True):
            site = take("pack")
            own = pack0(x, plan, use_kernels=use_kernels)
            self.seen.append(("pack", x.numpy().copy(), own.numpy(), site, plan))
            return torch.from_numpy(site[2].copy())

        def update_kv_cache(cache, k, v, positions, ctx):
            site = take("kv")
            self.seen.append(("kv", k.numpy().copy(), v.numpy().copy(), site, None))
            k, v = (torch.from_numpy(a.copy()) for a in site[1:])
            return update0(cache, k, v, positions, ctx)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(L, "pack", pack)
            mp.setattr(tcache, "update_kv_cache", update_kv_cache)
            yield
        assert next(sites, None) is None, "a recorded site was not replayed"

    def check(self) -> None:
        """Every replayed site: the port's own inputs within SITE_TOL x max of
        the reference's (K and V at a cache write); at a pack site the port's
        pack of the reference's input is the reference's codes, bit for bit."""
        assert self.seen and len(self.seen) == len(self.sites)
        for kind, a, b, (_, a_ref, b_ref), plan in self.seen:  # (input, own codes) or (k, v)
            if kind == "kv":
                _close(a, a_ref, SITE_TOL)
                _close(b, b_ref, SITE_TOL)
                continue
            _close(a, a_ref, SITE_TOL)
            np.testing.assert_array_equal(pack_codes(torch.tensor(a_ref), plan).numpy(), b_ref)


def _synced(world, key, jrun, trun):
    """(reference result, port result) of one run each, the port replaying
    the reference's roundings; the reference's run is taken once per
    ``key`` and family."""
    if key not in world["tapes"]:
        tape = Tape()
        with tape.record():
            world["tapes"][key] = (jrun(), tape.sites)
    want, sites = world["tapes"][key]
    tape = Tape()
    tape.sites = sites
    with tape.replay():
        got = trun()
    tape.check()
    return want, got


@pytest.mark.parametrize("params", ["tp", "tlut", "tconv"])
def test_logits_match_reference(world, params):
    """``model_forward`` logits on the dense tree, and, synchronized, on the
    converted tree (the reference's tables carried across, or the port's
    own conversion under the same plan), flat and grouped launches (both
    pack each group's input once, so one reference run serves both)."""
    if params == "tp":
        want = _jlogits(world["jp"], _jctx(world["jcfg"]))
        _close(_logits(world["tp"], Ctx(world["cfg"])), want, LOGITS_TOL)
        return
    for grouped in (False, True):
        want, got = _synced(
            world, "logits", lambda: _jlogits(world["jlut"], _jctx(world["jcfg"])),
            lambda: _logits(world[params], Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped))))
        _close(got, want, LOGITS_TOL)


@pytest.mark.parametrize("params", ["tlut", "tconv"])
@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_converted_generate_matches_reference(world, params, page_size):
    """Greedy ``generate`` on the converted tree, dense and paged at
    ``page_size=4``, synchronized: the reference's stream, whole."""
    want, got = _synced(
        world, ("generate", page_size),
        lambda: np.asarray(jgenerate(world["jlut"], _jctx(world["jcfg"]),
                                     jnp.asarray(GEN_PROMPT), max_new=MAX_NEW, max_len=16,
                                     page_size=page_size)),
        lambda: generate(world[params], Ctx(world["cfg"]), GEN_PROMPT, MAX_NEW, max_len=16,
                         page_size=page_size, device="cpu").numpy())
    np.testing.assert_array_equal(got, want)


def _engine_streams(cls, req, params, ctx, prompts, **kw):
    eng = cls(params, ctx, SLOTS, MAX_LEN, **kw)
    reqs = [req(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.generated for r in reqs], eng.prefill_tokens


def test_engine_streams_match_reference(world):
    """``BatchingEngine`` on the converted tree with grouped launches, paged
    at ``page_size=4`` with prefix sharing (two prompts share a two-page
    prefix, one is that prefix: a copy-on-write hit), synchronized: the
    reference's streams and prefilled tokens, fewer than the prompts'."""
    want, got = _synced(
        world, "engine",
        lambda: _engine_streams(JEngine, JRequest, world["jlut"],
                                _jctx(world["jcfg"], lut_grouped=True),
                                [jnp.asarray(p, jnp.int32) for p in PROMPTS], page_size=4),
        lambda: _engine_streams(BatchingEngine, Request, world["tlut"],
                                Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True)),
                                [np.asarray(p, np.int32) for p in PROMPTS], device="cpu",
                                page_size=4))
    assert got == want
    assert got[1] < sum(len(p) for p in PROMPTS)


@pytest.fixture(scope="module")
def minitron():
    cfg, jcfg = get_config("minitron_4b", reduced=True), jget_config("minitron_4b", reduced=True)
    tree = numpy_params(model_specs(cfg), 65)
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")


def test_minitron_tl1_logits_match_reference(minitron):
    """The TL1 plan (int8 activations) converts every projection, ``w_in``
    and ``w_out`` included, to ternary pair tables; the reference's tables
    carried across give its logits, with grouped launches (``wk+wv``
    grouped, the rest lone)."""
    cfg, jcfg, jp, _ = minitron
    jm = jplan_model(jp, float("inf"), families=("tl1",))
    assert {"blocks/ffn/w_in", "blocks/ffn/w_out"} <= set(jm.layers)
    jlut = jax.jit(lambda p: jconvert(p, plan=jm)[0])(jp)  # eager: ~10x slower here
    tlut = params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu",
                             plan=ModelPlan.from_json(jm.to_json()))
    want = _jlogits(jlut, _jctx(jcfg, lut_grouped=True))
    _close(_logits(tlut, Ctx(cfg, ex=ExecCfg(lut_grouped=True))), want, TL1_TOL)


def test_minitron_binary_matmul_logits_match_reference(minitron):
    """``linear_mode="binary_matmul"`` on the dense tree: every projection,
    ``w_in``/``w_out`` included, packed to signed 8/6 bitplanes; the
    reference's jnp form of the mode (the oracle its Pallas kernels are held
    to) gives the same logits and argmaxes; the standard mode does not."""
    cfg, jcfg, jp, tp = minitron
    want = _jlogits(jp, _jctx(jcfg, linear_mode="binary_matmul"))
    got = _logits(tp, Ctx(cfg, ex=ExecCfg(linear_mode="binary_matmul")))
    _close(got, want, BINARY_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    assert np.abs(_logits(tp, Ctx(cfg)).numpy() - want).max() > 1e-3
