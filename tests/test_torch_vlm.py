"""The VLM family (llava_next_mistral_7b) in the port against the JAX
package, on the CPU: the reduced config (2 layers, d_model 64, 8 image
tokens), fp32 weights from a numpy seed carried across by
``params_from_numpy``, image patch embeddings from a numpy seed at the
scale of the seeded embedding rows (the vision tower is a stub in both
packages: the embeddings are the model's input).

* The config and ``reduced()`` field for field, the spec trees, and the
  serving recipe's plan JSON for JSON.
* ``model_forward`` with ``embeds`` (image tokens first): on the dense tree
  within 1e-5 x max of the reference's logits, and on the converted tree
  (the reference's tables carried across, and the port's own conversion
  under the same plan) synchronized as ``tests/test_torch_dense_families.py``
  synchronizes it (its :class:`Tape`: the reference's fp16 codes and bf16
  K/V at the port's sites), within the same tolerance.  Without
  ``embeds`` the text positions' logits differ: the prefix moves them.
* A masked prefill of right-padded prompts behind the image tokens into a
  cache: the image block is prepended to ``token_mask``, so each row's
  index is ``S_img + len``, and the cache's pos / valid / index equal the
  reference's exactly, its K/V and the logits within 1e-5 x max.
* Prefill then decode against the full forward at offset
  ``num_image_tokens`` (``tests/test_serve.py``'s
  ``test_prefill_then_decode_matches_full_forward``, its 2e-3 x max),
  dense and paged.
* Greedy ``generate(embeds=...)`` dense and paged at ``page_size=4``, and
  ``BatchingEngine`` (text-only, as the reference's engine serves the
  family), dense and paged with prefix sharing: the reference's streams,
  whole (tolerance none), synchronized.
* ``CacheOverflowError`` counts the image tokens in the cache length.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.models.model import model_forward as jmodel_forward
from repro.models.model import model_specs as jmodel_specs
from repro.serve import BatchingEngine as JEngine
from repro.serve import CacheOverflowError as JCacheOverflowError
from repro.serve import Request as JRequest
from repro.serve import generate as jgenerate
from repro.serve import make_cache as jmake_cache
from repro_torch.configs.base import get_config
from repro_torch.core.convert import convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import (
    BatchingEngine,
    CacheOverflowError,
    Request,
    generate,
    make_cache,
    make_decode_step,
    make_prefill_step,
)
from test_torch_dense_families import _close, _jctx, _recipe, _shapes, _synced
from test_torch_moe import numpy_params
from test_torch_paged_cache import PROMPTS

ARCH = "llava_next_mistral_7b"
LOGITS_TOL = 1e-5  # x max|reference|: fp32 sums in another order, two layers and the head
DECODE_TOL = 2e-3  # x max, tests/test_serve.py::test_prefill_then_decode_matches_full_forward
EMBED_STD = 0.02  # numpy_params' embedding rows
S_IMG = 8  # the reduced config's num_image_tokens
TOKENS = np.random.default_rng(71).integers(0, 512, (2, 9)).astype(np.int32)
EMBEDS = (np.random.default_rng(72).standard_normal((2, S_IMG, 64)) * EMBED_STD).astype(
    np.float32)
LENS = (9, 5)  # the masked prefill's right-padded prompt lengths
GEN_PROMPT = np.asarray([[5, 9, 2, 7, 1], [3, 8, 4, 6, 11]], np.int32)
GEN_NEW, GEN_LEN = 6, 24  # 8 + 5 + 6 - 1 = 18 writes in a cache of 24 = 6 pages of 4
SLOTS, MAX_LEN, MAX_NEW = 3, 32, 6


@pytest.fixture(scope="module")
def world():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    tree = numpy_params(model_specs(cfg), 73)
    rng = np.random.default_rng(74)
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
        jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, jm=jm, jlut=jlut,
        tlut=params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan),
        tconv=convert_params(tp, plan=mplan)[0], tapes={},
    )


def test_config_specs_and_plan_match_reference(world):
    """The published config and ``reduced()`` field for field (the
    reference's ``ModelConfig`` has more fields: its other families'), the
    spec trees leaf for leaf, and the serving recipe's plan of the same
    weights JSON for JSON."""
    for reduced in (True, False):
        got = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        want = dataclasses.asdict(jget_config(ARCH, reduced=reduced))
        assert got == {k: want[k] for k in got}
        assert _shapes(model_specs(get_config(ARCH, reduced=reduced))) == _shapes(
            jmodel_specs(jget_config(ARCH, reduced=reduced)))
    assert get_config(ARCH).num_image_tokens == 576 and world["cfg"].family == "vlm"
    assert _recipe(world["tp"], plan_model).to_json() == world["jm"].to_json()


def _jlogits(params, jctx, inputs):
    fwd = jax.jit(lambda p, i: jmodel_forward(p, i, jctx)[0])
    return np.asarray(fwd(params, {k: jnp.asarray(v) for k, v in inputs.items()}))


def _logits(params, ctx, inputs):
    with torch.no_grad():
        return model_forward(params, {k: torch.from_numpy(v) for k, v in inputs.items()},
                             ctx)[0]


@pytest.mark.parametrize("params", ["tp", "tlut", "tconv"])
def test_forward_with_embeds_matches_reference(world, params):
    """``model_forward`` with ``embeds``: S_img + S positions of logits, on
    the dense tree and, synchronized, on the converted trees (flat and
    grouped launches, which pack each input once alike); on the dense tree
    the same prompts without ``embeds`` give other text logits."""
    inputs = {"tokens": TOKENS, "embeds": EMBEDS}
    if params == "tp":
        want = _jlogits(world["jp"], _jctx(world["jcfg"]), inputs)
        got = _logits(world["tp"], Ctx(world["cfg"]), inputs)
        assert got.shape == (2, S_IMG + TOKENS.shape[1], world["cfg"].padded_vocab)
        _close(got, want, LOGITS_TOL)
        text = _logits(world["tp"], Ctx(world["cfg"]), {"tokens": TOKENS}).numpy()
        assert np.abs(text - want[:, S_IMG:]).max() > 0.1 * np.abs(want).max()
        return
    for grouped in (False, True):
        want, got = _synced(
            world, "logits", lambda: _jlogits(world["jlut"], _jctx(world["jcfg"]), inputs),
            lambda: _logits(world[params], Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped)),
                            inputs))
        _close(got, want, LOGITS_TOL)


@pytest.mark.parametrize("params", ["tp", "tconv"])
def test_masked_prefill_with_embeds_matches_reference(world, params):
    """A right-padded prefill (prompts of 9 and 5 tokens) behind the image
    tokens, into an fp32 cache: the port prepends an all-True image block
    to ``token_mask``, so each row advances by S_img + its length; the
    cache's pos / valid / index are the reference's bit for bit, its K/V
    and the logits within LOGITS_TOL x max (converted: synchronized)."""
    mask = np.arange(TOKENS.shape[1])[None, :] < np.asarray(LENS)[:, None]
    tokens = np.where(mask, TOKENS, 0).astype(np.int32)
    T = 24
    jkey = {"tp": "jp", "tconv": "jlut"}[params]

    def jrun():
        jctx = _jctx(world["jcfg"])
        jc = jmake_cache(world["jcfg"], 2, T, jctx, dtype=jnp.float32)
        fwd = jax.jit(lambda p, i, c: jmodel_forward(p, i, jctx, cache=c)[:2])
        logits, jc = fwd(world[jkey], {"tokens": jnp.asarray(tokens),
                                       "embeds": jnp.asarray(EMBEDS),
                                       "token_mask": jnp.asarray(mask)}, jc)
        return np.asarray(logits), jax.tree.map(np.asarray, jc)

    def trun():
        ctx = Ctx(world["cfg"])
        cache = make_cache(world["cfg"], 2, T, ctx, dtype=torch.float32, device="cpu")
        with torch.no_grad():
            logits, cache, _ = model_forward(
                world[params], {"tokens": torch.from_numpy(tokens),
                                "embeds": torch.from_numpy(EMBEDS),
                                "token_mask": torch.from_numpy(mask)}, ctx, cache=cache)
        return logits, cache

    if params == "tp":
        (want, jc), (got, cache) = jrun(), trun()
    else:
        (want, jc), (got, cache) = _synced(world, "masked", jrun, trun)
    _close(got, want, LOGITS_TOL)
    assert cache["index"].tolist() == [S_IMG + n for n in LENS]
    for key in ("pos", "valid", "index"):
        np.testing.assert_array_equal(cache[key].numpy(), jc[key], err_msg=key)
    for key in ("k", "v"):
        _close(cache["layers"][key], jc["layers"][key], LOGITS_TOL)


@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_prefill_then_decode_matches_full_forward(world, page_size):
    """The image tokens and the first 5 prompt tokens prefilled into an fp32
    cache (24 slots, 6 pages of 4 when paged), the last 4 decoded one fed
    token at a time: each step's logits within DECODE_TOL x max of the full
    forward's at offset S_img + t, the port's and the reference's."""
    ctx, n_pre = Ctx(world["cfg"]), 5
    inputs = {"tokens": TOKENS, "embeds": EMBEDS}
    full = _logits(world["tp"], ctx, inputs).numpy()
    jfull = _jlogits(world["jp"], _jctx(world["jcfg"]), inputs)
    cache = make_cache(world["cfg"], 2, 24, ctx, dtype=torch.float32, page_size=page_size,
                       device="cpu")
    tok = torch.from_numpy(TOKENS)
    with torch.no_grad():
        lg, cache = make_prefill_step(ctx)(
            world["tp"], {"tokens": tok[:, :n_pre], "embeds": torch.from_numpy(EMBEDS)}, cache)
        got, decode = [lg[:, -1]], make_decode_step(ctx)
        for t in range(n_pre, TOKENS.shape[1] - 1):
            _, lg, cache = decode(world["tp"], cache, tok[:, t:t + 1])
            got.append(lg[:, -1])
    got = torch.stack(got, 1).numpy()
    positions = S_IMG + np.arange(n_pre - 1, TOKENS.shape[1] - 1)
    for want in (full, jfull):
        want = want[:, positions]
        np.testing.assert_allclose(got, want, rtol=0, atol=DECODE_TOL * np.abs(want).max())
    assert cache["index"].tolist() == [S_IMG + TOKENS.shape[1] - 1] * 2


@pytest.mark.parametrize("params", ["tlut", "tconv"])
@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_generate_with_embeds_matches_reference(world, params, page_size):
    """Greedy ``generate(embeds=...)`` on the converted tree, dense and paged
    at ``page_size=4``, synchronized: the reference's stream, whole."""
    want, got = _synced(
        world, ("generate", page_size),
        lambda: np.asarray(jgenerate(world["jlut"], _jctx(world["jcfg"]),
                                     jnp.asarray(GEN_PROMPT), max_new=GEN_NEW, max_len=GEN_LEN,
                                     embeds=jnp.asarray(EMBEDS), page_size=page_size)),
        lambda: generate(world[params], Ctx(world["cfg"]), GEN_PROMPT, GEN_NEW,
                         max_len=GEN_LEN, page_size=page_size, device="cpu",
                         embeds=EMBEDS).numpy())
    np.testing.assert_array_equal(got, want)


def _engine_streams(cls, req, params, ctx, prompts, **kw):
    eng = cls(params, ctx, SLOTS, MAX_LEN, **kw)
    reqs = [req(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.generated for r in reqs], eng.prefill_tokens


@pytest.mark.parametrize("page_size", [None, 4], ids=["dense", "paged"])
def test_engine_streams_match_reference(world, page_size):
    """``BatchingEngine`` on the converted tree with grouped launches, text
    only (a ``Request`` carries no image, in either package), dense and
    paged at ``page_size=4`` with prefix sharing (two prompts share a
    two-page prefix, one is that prefix), synchronized: the reference's
    streams and prefilled tokens."""
    kw = {} if page_size is None else {"page_size": page_size}
    want, got = _synced(
        world, ("engine", page_size),
        lambda: _engine_streams(JEngine, JRequest, world["jlut"],
                                _jctx(world["jcfg"], lut_grouped=True),
                                [jnp.asarray(p, jnp.int32) for p in PROMPTS], **kw),
        lambda: _engine_streams(BatchingEngine, Request, world["tlut"],
                                Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True)),
                                [np.asarray(p, np.int32) for p in PROMPTS], device="cpu",
                                **kw))
    assert got == want
    if page_size is not None:
        assert got[1] < sum(len(p) for p in PROMPTS)


def test_generate_overflow_counts_image_tokens(world):
    """A cache that holds the prompt and its new tokens but not the image
    tokens before them raises ``CacheOverflowError`` up front in both
    packages, naming S_img + S prompt tokens; one more than the writes
    need serves."""
    S = GEN_PROMPT.shape[1]
    tight = S_IMG + S + GEN_NEW - 1
    message = f"prompt \\({S_IMG + S} tokens\\)"
    with pytest.raises(CacheOverflowError, match=message):
        generate(world["tp"], Ctx(world["cfg"]), GEN_PROMPT, GEN_NEW, max_len=tight - 1,
                 device="cpu", embeds=EMBEDS)
    with pytest.raises(JCacheOverflowError, match=message):
        jgenerate(world["jp"], _jctx(world["jcfg"]), jnp.asarray(GEN_PROMPT), max_new=GEN_NEW,
                  max_len=tight - 1, embeds=jnp.asarray(EMBEDS))
    out = generate(world["tp"], Ctx(world["cfg"]), GEN_PROMPT, GEN_NEW, max_len=tight,
                   device="cpu", embeds=EMBEDS)
    assert out.shape == (2, GEN_NEW)
