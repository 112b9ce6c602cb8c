"""The enc-dec family (whisper_base) in the port against the JAX package, on
the CPU: the reduced config (2 encoder and 2 decoder layers, d_model 64, 4
heads of 16, d_ff 128), fp32 weights from a numpy seed carried across by
``params_from_numpy`` (biases and every LayerNorm's scale and bias drawn
at random, so that they are exercised) and encoder frame embeddings from a
numpy seed at std 0.1, as ``tests/test_serve.py`` seeds them (the audio
frontend is a stub in both packages: the frames are the model's input).
The reference runs on its jnp oracle.

* The config and ``reduced()`` field for field, the spec trees, the
  serving recipe's plan JSON for JSON (three G = 3 ``wq+wk+wv`` groups:
  the encoder's, the decoder's self- and cross-attention's, each with its
  stacked biases) and the LUT calls a prefill and a decode step make.
* ``encode`` and each layer's cross K/V within 1e-5 x max.
* ``model_forward`` logits on the dense tree within 1e-5 x max and, on the
  converted trees (the reference's tables carried across, and the port's
  own conversion), synchronized by ``tests/test_torch_dense_families.py``'s
  ``Tape`` (the reference's fp16 codes and bf16 K/V at the port's sites),
  with flat and grouped launches.
* Prefill then decode against the full forward, dense and paged
  (``tests/test_serve.py``'s 2e-3 x max).
* Greedy ``generate(enc_embeds=...)`` dense and at ``page_size=4``,
  synchronized: the reference's streams, whole.  Its 20 frames outnumber
  the 12-slot decoder cache.
* After the prefill the cross K/V are fp32 at S_enc (20 frames, with caches
  of 12 and 32 slots), equal to the reference's, beside bf16 self K/V.
* The refusals with the reference's messages, and ``CacheOverflowError``
  counting decoder tokens only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.layers as L
from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.models.encdec import _cross_kv_from as j_cross_kv_from
from repro.models.encdec import encode as jencode
from repro.models.model import model_forward as jmodel_forward
from repro.models.model import model_specs as jmodel_specs
from repro.serve import BatchingEngine as JEngine
from repro.serve import CacheOverflowError as JCacheOverflowError
from repro.serve import generate as jgenerate
from repro.serve import make_cache as jmake_cache
from repro.serve import make_prefill_step as jmake_prefill_step
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTGroup, convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.models.encdec import _cross_kv_from, encode
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.models.transformer import layer_params
from repro_torch.serve import (
    BatchingEngine,
    CacheOverflowError,
    generate,
    make_cache,
    make_decode_step,
    make_prefill_step,
)
from test_torch_dense_families import _close, _jctx, _recipe, _shapes, _synced
from test_torch_moe import numpy_params

ARCH = "whisper_base"
LOGITS_TOL = 1e-5  # x max|reference|: fp32 sums in another order, 2 + 2 layers and the head
DECODE_TOL = 2e-3  # x max, tests/test_serve.py::test_prefill_then_decode_matches_full_forward
S_ENC = 20
TOKENS = np.random.default_rng(81).integers(0, 512, (2, 12)).astype(np.int32)
ENC = (np.random.default_rng(82).standard_normal((2, S_ENC, 64)) * 0.1).astype(np.float32)
GEN_PROMPT = np.asarray([[5, 9, 2, 7], [3, 8, 4, 6]], np.int32)
GEN_NEW, GEN_LEN = 6, 12  # 4 + 6 - 1 = 9 writes in a cache of 12 = 3 pages of 4
NORMS = ("ln1", "ln2", "ln_x")


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    tree = numpy_params(model_specs(cfg), 83)
    rng = np.random.default_rng(84)

    def seeded_norm(p):  # random LayerNorm scales and biases, so that they are exercised
        return {"scale": (1 + 0.2 * rng.standard_normal(p["scale"].shape)).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(p["bias"].shape)).astype(np.float32)}

    for stack in ("encoder", "decoder"):
        for part in NORMS:
            if part in tree[stack]:
                tree[stack][part] = seeded_norm(tree[stack][part])
    for part in ("enc_ln_f", "ln_f"):
        tree[part] = seeded_norm(tree[part])
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


def test_config_specs_and_plan_match_reference(world):
    """The published config and ``reduced()`` field for field, the spec
    trees leaf for leaf (every norm with a ``bias``, ``w_in``/``w_out``
    and ``wq``/``wk``/``wv`` biased, ``wo`` not), and the serving recipe's
    plan of the same weights JSON for JSON: 16 entries and three G = 3
    ``wq+wk+wv`` groups, which both converted trees hold with their
    stacked (L, 3, d) biases."""
    for reduced in (True, False):
        got = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        want = dataclasses.asdict(jget_config(ARCH, reduced=reduced))
        assert got == {k: want[k] for k in got}
        assert _shapes(model_specs(get_config(ARCH, reduced=reduced))) == _shapes(
            jmodel_specs(jget_config(ARCH, reduced=reduced)))
    specs = model_specs(world["cfg"])
    assert set(specs) == {"embed", "encoder", "enc_ln_f", "decoder", "ln_f"}
    assert set(specs["decoder"]["ln_x"]) == {"scale", "bias"}
    assert "b" in specs["decoder"]["mlp"]["w_in"] and "b" not in specs["encoder"]["attn"]["wo"]
    tm = _recipe(world["tp"], plan_model)
    assert tm.to_json() == world["jm"].to_json()
    assert len(tm.layers) == 16 and "lm_head" not in tm.layers
    groups = sorted(tuple(sorted(g)) for g in tm.groups)
    assert groups == sorted(tuple(sorted(f"{path}/{m}" for m in ("wq", "wk", "wv")))
                            for path in ("encoder/attn", "decoder/self_attn",
                                         "decoder/cross_attn"))
    L_, d = world["cfg"].num_layers, world["cfg"].d_model
    for tree in (world["tlut"], world["tconv"]):
        node = tree["decoder"]["cross_attn"]["wq+wk+wv"]
        assert isinstance(node, LUTGroup) and node.tables.shape[:2] == (L_, 3)
        assert node.b.shape == (L_, 3, d)
        _close(node.b, np.stack([world["jp"]["decoder"]["cross_attn"][m]["b"]
                                 for m in ("wq", "wk", "wv")], 1), 0)
        assert set(tree["encoder"]["attn"]) == set(world["jlut"]["encoder"]["attn"])


def test_encode_and_cross_kv_match_reference(world):
    """The encoder's output and each decoder layer's cross K/V from it, on
    the dense tree, within LOGITS_TOL x max of the reference's."""
    jctx, ctx = _jctx(world["jcfg"]), Ctx(world["cfg"])
    jenc = jax.jit(lambda p, e: jencode(p, e, jctx))(world["jp"], jnp.asarray(ENC))
    with torch.no_grad():
        enc = encode(world["tp"], torch.from_numpy(ENC), ctx)
    assert enc.shape == (2, S_ENC, 64)
    _close(enc, np.asarray(jenc), LOGITS_TOL)
    for i in range(world["cfg"].num_layers):
        jlayer = jax.tree.map(lambda a: a[i], world["jp"]["decoder"]["cross_attn"])
        want = j_cross_kv_from(jlayer, jenc, jctx)
        with torch.no_grad():
            got = _cross_kv_from(layer_params(world["tp"]["decoder"]["cross_attn"], i), enc, ctx)
        for g, w in zip(got, want):
            assert g.shape == (2, S_ENC, 4, 16)
            _close(g, np.asarray(w), LOGITS_TOL)


def _jlogits(params, jctx, inputs):
    fwd = jax.jit(lambda p, i: jmodel_forward(p, i, jctx)[0])
    return np.asarray(fwd(params, {k: jnp.asarray(v) for k, v in inputs.items()}))


def _logits(params, ctx, inputs):
    with torch.no_grad():
        return model_forward(params, {k: torch.from_numpy(v) for k, v in inputs.items()},
                             ctx)[0]


@pytest.mark.parametrize("params", ["tp", "tlut", "tconv"])
def test_forward_matches_reference(world, params):
    """``model_forward`` with ``enc_embeds`` and no cache (each layer's
    cross K/V recomputed between its self- and cross-attention): on the
    dense tree, and synchronized on the converted trees with flat and
    grouped launches (both pack each input once, so one reference run
    serves both)."""
    inputs = {"tokens": TOKENS, "enc_embeds": ENC}
    if params == "tp":
        want = _jlogits(world["jp"], _jctx(world["jcfg"]), inputs)
        got = _logits(world["tp"], Ctx(world["cfg"]), inputs)
        assert got.shape == (2, TOKENS.shape[1], world["cfg"].padded_vocab)
        _close(got, want, LOGITS_TOL)
        return
    for grouped in (False, True):
        want, got = _synced(
            world, "logits", lambda: _jlogits(world["jlut"], _jctx(world["jcfg"]), inputs),
            lambda: _logits(world[params], Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped)),
                            inputs))
        _close(got, want, LOGITS_TOL)


def test_calls_per_forward_as_the_tree_plans(world):
    """On the converted tree with grouped launches, a cached prefill makes
    3Le + 7L ``lut_affine`` calls, Le + L grouped ones and 4Le + 7L packs
    (the encoder; each layer's cross ``wk``/``wv`` as two lone calls on
    the group's leaf after one pack; the decoder), and a decode step 5L /
    L / 6L: no head call (the tied head is a plain product)."""
    cfg = world["cfg"]
    Le, Ld = cfg.encoder_layers, cfg.num_layers
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    calls = dict.fromkeys(("lut_affine", "lut_affine_grouped", "pack"), 0)

    def spy(name):
        fn = getattr(L, name)

        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        return call

    cache = make_cache(cfg, 2, 16, ctx, device="cpu", enc_len=S_ENC)
    tok = torch.from_numpy(TOKENS[:, :4])
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        for name in calls:
            mp.setattr(L, name, spy(name))
        logits, cache = make_prefill_step(ctx)(world["tconv"], {
            "tokens": tok, "enc_embeds": torch.from_numpy(ENC)}, cache)
        prefill = dict(calls)
        calls.update(dict.fromkeys(calls, 0))
        make_decode_step(ctx)(world["tconv"], cache, tok[:, :1])
    assert prefill == {"lut_affine": 3 * Le + 7 * Ld, "lut_affine_grouped": Le + Ld,
                       "pack": 4 * Le + 7 * Ld}
    assert calls == {"lut_affine": 5 * Ld, "lut_affine_grouped": Ld, "pack": 6 * Ld}


@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_prefill_then_decode_matches_full_forward(world, page_size):
    """8 tokens prefilled with the frames into an fp32 cache (24 slots, 6
    pages of 4 when paged), the last 4 decoded one fed token at a time: each
    step's logits within DECODE_TOL x max of the full forward's, the port's
    and the reference's; the frames take no slot (index = tokens)."""
    ctx, n_pre = Ctx(world["cfg"]), 8
    inputs = {"tokens": TOKENS, "enc_embeds": ENC}
    full = _logits(world["tp"], ctx, inputs).numpy()
    jfull = _jlogits(world["jp"], _jctx(world["jcfg"]), inputs)
    cache = make_cache(world["cfg"], 2, 24, ctx, dtype=torch.float32, page_size=page_size,
                       device="cpu", enc_len=S_ENC)
    tok = torch.from_numpy(TOKENS)
    with torch.no_grad():
        lg, cache = make_prefill_step(ctx)(
            world["tp"], {"tokens": tok[:, :n_pre], "enc_embeds": torch.from_numpy(ENC)}, cache)
        got, decode = [lg[:, -1]], make_decode_step(ctx)
        for t in range(n_pre, TOKENS.shape[1] - 1):
            _, lg, cache = decode(world["tp"], cache, tok[:, t:t + 1])
            got.append(lg[:, -1])
    got = torch.stack(got, 1).numpy()
    positions = np.arange(n_pre - 1, TOKENS.shape[1] - 1)
    for want in (full, jfull):
        want = want[:, positions]
        np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_TOL * np.abs(want).max())
    assert cache["index"].tolist() == [TOKENS.shape[1] - 1] * 2


@pytest.mark.parametrize("params", ["tlut", "tconv"])
@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_generate_matches_reference(world, params, page_size):
    """Greedy ``generate(enc_embeds=...)`` on the converted tree, dense and
    paged at ``page_size=4`` (only the self K/V paged), synchronized: the
    reference's stream, whole.  The 20 frames outnumber the cache's 12
    slots: the cross K/V are held apart, at S_enc."""
    want, got = _synced(
        world, ("generate", page_size),
        lambda: np.asarray(jgenerate(world["jlut"], _jctx(world["jcfg"]),
                                     jnp.asarray(GEN_PROMPT), max_new=GEN_NEW, max_len=GEN_LEN,
                                     enc_embeds=jnp.asarray(ENC), page_size=page_size)),
        lambda: generate(world[params], Ctx(world["cfg"]), GEN_PROMPT, GEN_NEW,
                         max_len=GEN_LEN, page_size=page_size, device="cpu",
                         enc_embeds=ENC).numpy())
    assert got.shape == (2, GEN_NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_len", [12, 32])
def test_cross_cache_is_fp32_at_enc_len(world, max_len):
    """After a prefill into the default (bf16) cache the cross K/V are
    float32 at (L, B, S_enc, K, hd), with caches shorter (12 slots) and
    longer (32) than the 20 frames, and within LOGITS_TOL x max of the
    reference's (whose prefill binds fp32 S_enc stacks in place of the
    (L, B, max_len) bf16 leaves it declares); the self K/V stay bf16 at
    max_len, the port's and the reference's, and a prefill whose frames
    the cache was not made for raises."""
    cfg, jcfg = world["cfg"], world["jcfg"]
    ctx, jctx = Ctx(cfg), _jctx(jcfg)
    cache = make_cache(cfg, 2, max_len, ctx, device="cpu", enc_len=S_ENC)
    assert cache["cross"]["k"].dtype == torch.float32
    inputs = {"tokens": TOKENS[:, :4], "enc_embeds": ENC}
    with torch.no_grad():
        _, cache = make_prefill_step(ctx)(
            world["tp"], {k: torch.from_numpy(v) for k, v in inputs.items()}, cache)
    jc = jmake_cache(jcfg, 2, max_len, jctx)
    _, jc = jax.jit(jmake_prefill_step(jctx))(
        world["jp"], {k: jnp.asarray(v) for k, v in inputs.items()}, jc)
    shape = (cfg.num_layers, 2, S_ENC, cfg.num_kv_heads, cfg.head_dim)
    for key in ("k", "v"):
        got, want = cache["cross"][key], jc["cross"][key]
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        assert want.dtype == jnp.float32 and want.shape == shape
        _close(got, np.asarray(want), LOGITS_TOL)
        assert cache["layers"][key].dtype == torch.bfloat16
        assert jc["layers"][key].dtype == jnp.bfloat16
        assert cache["layers"][key].shape[2] == max_len == jc["layers"][key].shape[2]
    with pytest.raises(ValueError, match="enc_len"):
        make_prefill_step(ctx)(world["tp"], {"tokens": torch.from_numpy(TOKENS[:, :4]),
                                             "enc_embeds": torch.from_numpy(ENC[:, :8])},
                               make_cache(cfg, 2, max_len, ctx, device="cpu", enc_len=S_ENC))


def test_refusals_match_reference(world):
    """Both packages refuse ``BatchingEngine`` (a cross cache has no
    slot-targeted write) and a ``token_mask``, with the reference's
    messages; the port's enc-dec cache needs the frames' count."""
    cfg, jctx = world["cfg"], _jctx(world["jcfg"])
    message = ("BatchingEngine needs slot-targeted cache writes; family 'encdec' has "
               "recurrent/cross caches without them")
    with pytest.raises(NotImplementedError) as got:
        BatchingEngine(world["tp"], Ctx(cfg), 2, 16, device="cpu")
    with pytest.raises(NotImplementedError) as want:
        JEngine(world["jp"], jctx, 2, 16)
    assert str(got.value) == str(want.value) == message
    mask = np.ones(TOKENS.shape, bool)
    with pytest.raises(NotImplementedError) as got:
        model_forward(world["tp"], {"tokens": torch.from_numpy(TOKENS),
                                    "enc_embeds": torch.from_numpy(ENC),
                                    "token_mask": torch.from_numpy(mask)}, Ctx(cfg))
    with pytest.raises(NotImplementedError) as want:
        jmodel_forward(world["jp"], {"tokens": jnp.asarray(TOKENS), "enc_embeds": jnp.asarray(ENC),
                                     "token_mask": jnp.asarray(mask)}, jctx)
    assert str(got.value) == str(want.value) and "'encdec'" in str(got.value)
    with pytest.raises(ValueError, match="enc_len"):
        make_cache(cfg, 2, 16, Ctx(cfg), device="cpu")


def test_generate_overflow_counts_decoder_tokens_only(world):
    """A cache one slot short of prompt + max_new - 1 raises
    ``CacheOverflowError`` up front in both packages, naming the 4 prompt
    tokens: the 20 frames count for nothing; a cache of exactly that many
    slots serves."""
    S = GEN_PROMPT.shape[1]
    tight = S + GEN_NEW - 1
    message = f"prompt \\({S} tokens\\)"
    with pytest.raises(CacheOverflowError, match=message):
        generate(world["tp"], Ctx(world["cfg"]), GEN_PROMPT, GEN_NEW, max_len=tight - 1,
                 device="cpu", enc_embeds=ENC)
    with pytest.raises(JCacheOverflowError, match=message):
        jgenerate(world["jp"], _jctx(world["jcfg"]), jnp.asarray(GEN_PROMPT), max_new=GEN_NEW,
                  max_len=tight - 1, enc_embeds=jnp.asarray(ENC))
    out = generate(world["tp"], Ctx(world["cfg"]), GEN_PROMPT, GEN_NEW, max_len=tight,
                   device="cpu", enc_embeds=ENC)
    assert out.shape == (2, GEN_NEW)
