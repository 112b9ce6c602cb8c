"""TL1-planned reduced granite_8b served by the port against the JAX
package: prefill logits from a JAX-converted tree carried across, greedy
``generate`` and ``BatchingEngine`` streams identical to the JAX ones
(int8 activations, lone and grouped launches), and the port's own exact
(``act_bits=None``) TL1 stream equal to its ternarised-dense stream."""
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
from repro.models.model import model_forward as jmodel_forward
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro.serve import BatchingEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import generate as jgenerate
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTGroup, convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.core.quantize import ternary_fake_quant
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import init_params, params_from_numpy
from repro_torch.serve import BatchingEngine, Request, generate

MAX_NEW, MAX_LEN, SLOTS = 8, 32, 3


def _prompts(seed=11, n=5, vocab=512):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, vocab, int(rng.integers(3, 14))).astype(np.int32)
        for _ in range(n)
    ]


def _engine_streams(params, ctx, prompts, engine=BatchingEngine, request=Request, **kw):
    eng = engine(params, ctx, SLOTS, MAX_LEN, **kw)
    reqs = [request(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return [r.generated for r in eng.run()]


@pytest.fixture(scope="module")
def world():
    jcfg = jget_config("granite_8b", reduced=True)
    cfg = get_config("granite_8b", reduced=True)
    jp = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(12))
    jm = jplan_model(jp, float("inf"), families=("tl1",))
    mplan = ModelPlan.from_json(jm.to_json())
    jlut, _ = jconvert(jp, plan=jm)
    # the JAX-converted tree crosses as it is: tables, scales, plan JSON
    tlut = params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan)
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jctx = JCtx(jcfg, ex=JExecCfg(remat="none", lut_grouped=True))
    logits, _, _ = jmodel_forward(jlut, {"tokens": jnp.asarray(prompts)}, jctx)
    ref = {
        "logits": np.asarray(logits),
        "generate": np.asarray(jgenerate(jlut, jctx, jnp.asarray(prompts), MAX_NEW)),
        "engine": _engine_streams(
            jlut, jctx, [jnp.asarray(p) for p in _prompts()], JEngine, JRequest
        ),
    }
    return dict(cfg=cfg, tlut=tlut, mplan=mplan, prompts=prompts, ref=ref)


def test_tree_crosses_with_its_groups(world):
    attn = world["tlut"]["blocks"]["attn"]
    assert isinstance(attn["wk+wv"], LUTGroup)
    assert attn["wk+wv"].tables.dtype == torch.uint8
    assert tuple(attn["wk+wv"].scale.shape) == (2, 2)  # (layers, members)
    assert world["mplan"].families == ("tl1",)


@pytest.mark.parametrize("grouped", [False, True])
def test_prefill_logits_match_reference(world, grouped):
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped))
    got, _, _ = model_forward(
        world["tlut"], {"tokens": torch.from_numpy(world["prompts"])}, ctx
    )
    want = world["ref"]["logits"]
    # the layers around the integer TL1 accumulate (norms, attention,
    # softmax) sum fp32 in another order
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=1e-4 * float(np.abs(want).max())
    )


@pytest.mark.parametrize("grouped", [False, True])
def test_generate_streams_identical_to_reference(world, grouped):
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped))
    got = generate(world["tlut"], ctx, world["prompts"], MAX_NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), world["ref"]["generate"])


@pytest.mark.parametrize("admit", ["batched", "per-slot"])
def test_engine_streams_identical_to_reference(world, admit):
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True))
    got = _engine_streams(world["tlut"], ctx, _prompts(), admit=admit, device="cpu")
    assert got == world["ref"]["engine"]


def _ternarised(params, mplan):
    """``params`` with every planned weight replaced by its ternary
    stand-in ``s * t``, one scale per layer of a stacked leaf."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    for key in mplan.layers:
        parts = key.split("/")
        node = out
        for part in parts[:-1]:
            node[part] = dict(node[part])
            node = node[part]
        leaf = dict(node[parts[-1]])
        w = leaf["w"]
        leaf["w"] = torch.stack([ternary_fake_quant(w[i]) for i in range(w.shape[0])])
        node[parts[-1]] = leaf
    return out


@pytest.fixture(scope="module")
def exact_world():
    cfg = get_config("granite_8b", reduced=True)
    params = init_params(
        model_specs(cfg), torch.Generator().manual_seed(14), device="cpu"
    )
    mplan = plan_model(params, float("inf"), families=("tl1",), tl1_act_bits=None)
    assert mplan.families == ("tl1",) and mplan.groups
    tl1_params, report = convert_params(params, plan=mplan)
    assert report.grouped == 2
    return cfg, _ternarised(params, mplan), tl1_params


def test_exact_tl1_generate_equals_ternarised_dense(exact_world):
    cfg, tern, tl1_params = exact_world
    tokens = np.asarray([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)
    want = generate(tern, Ctx(cfg), tokens, max_new=6, max_len=32, device="cpu")
    got = generate(
        tl1_params, Ctx(cfg, ex=ExecCfg(lut_grouped=True)), tokens, max_new=6,
        max_len=32, device="cpu",
    )
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_exact_tl1_engine_equals_ternarised_dense(exact_world):
    cfg, tern, tl1_params = exact_world
    prompts = _prompts(seed=15)
    dense = _engine_streams(tern, Ctx(cfg), prompts, device="cpu")
    tl1 = _engine_streams(
        tl1_params, Ctx(cfg, ex=ExecCfg(lut_grouped=True)), prompts, device="cpu"
    )
    assert dense == tl1
