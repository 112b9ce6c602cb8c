"""Reduced qwen2_moe_a2_7b served by the port against the JAX package:
a tree the JAX package planned (the serving recipe with
``convert_experts=True``) and converted crosses as it is; prefill logits
agree, and greedy ``generate`` and ``BatchingEngine`` streams are
identical to the JAX ones on planned LUT experts with grouped launches,
and on a TL1-planned tree."""
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
from repro.serve import BatchingEngine as JEngine
from repro.serve import Request as JRequest
from repro.serve import generate as jgenerate
from repro_torch.configs.base import get_config
from repro_torch.core.convert import LUTGroup, LUTLinear
from repro_torch.core.planner import ModelPlan
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import BatchingEngine, Request, generate
from test_torch_moe import numpy_params

MAX_NEW, MAX_LEN, SLOTS = 6, 32, 3
# the decoder's fp32 sums (norms, attention, softmax, router) in another
# order than XLA's
LOGITS_TOL = 1e-4
# a position whose LUT input took the neighbouring fp16 code in one package
# (see test_prefill_logits_match_reference)
FLIP_TOL = 1e-3


def _prompts(seed=17, n=5, vocab=512):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, vocab, int(rng.integers(3, 12))).astype(np.int32)
        for _ in range(n)
    ]


def _engine_streams(params, ctx, prompts, engine=BatchingEngine, request=Request, **kw):
    eng = engine(params, ctx, SLOTS, MAX_LEN, **kw)
    reqs = [request(i, p, MAX_NEW) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return [r.generated for r in eng.run()]


def _serving_plan(jp):
    uniform = jplan_model(jp, float("inf"), max_chunk=2, convert_experts=True)
    return jplan_model(
        jp,
        uniform.total_lut_bytes // 2,
        max_chunk=2,
        modes=("bitplane", "bitplane_shift"),
        radices=(1, 2, 4),
        table_formats=(None, "i8"),
        convert_experts=True,
    )


def _world(family: str):
    jcfg = jget_config("qwen2_moe_a2_7b", reduced=True)
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    tree = numpy_params(model_specs(cfg), 31)
    jp = jax.tree.map(jnp.asarray, tree)
    if family == "tl1":
        jm = jplan_model(jp, float("inf"), families=("tl1",), convert_experts=True)
    else:
        jm = _serving_plan(jp)
    mplan = ModelPlan.from_json(jm.to_json())
    jlut, _ = jconvert(jp, plan=jm, convert_experts=True)
    tlut = params_from_numpy(jax.tree.map(np.asarray, jlut), device="cpu", plan=mplan)
    prompts = np.random.default_rng(33).integers(0, cfg.vocab_size, (2, 9))
    prompts = prompts.astype(np.int32)
    jctx = JCtx(jcfg, ex=JExecCfg(remat="none", lut_grouped=True))
    logits, _, _ = jax.jit(lambda p, t: jmodel_forward(p, {"tokens": t}, jctx))(
        jlut, jnp.asarray(prompts)
    )
    ref = {
        "logits": np.asarray(logits),
        "generate": np.asarray(jgenerate(jlut, jctx, jnp.asarray(prompts), MAX_NEW)),
        "engine": _engine_streams(
            jlut, jctx, [jnp.asarray(p) for p in _prompts()], JEngine, JRequest
        ),
    }
    return dict(cfg=cfg, tlut=tlut, mplan=mplan, prompts=prompts, ref=ref)


@pytest.fixture(scope="module")
def world():
    return _world("weight")


@pytest.fixture(scope="module")
def tl1_world():
    return _world("tl1")


def test_tree_crosses_with_its_expert_groups(world):
    ffn = world["tlut"]["blocks"]["ffn"]
    assert isinstance(ffn["w_gate+w_up"], LUTGroup)
    assert isinstance(ffn["w_down"], LUTLinear)
    assert tuple(ffn["w_gate+w_up"].tables.shape[:3]) == (2, 8, 2)  # (L, E, G)
    assert tuple(ffn["w_gate+w_up"].scale.shape) == (2,)  # one per layer
    assert isinstance(world["tlut"]["blocks"]["attn"]["wq+wk+wv"], LUTGroup)
    kinds = {
        (p.mode, p.fmt.mantissa_radix, p.table_format, p.chunk_size)
        for p in world["mplan"].layers.values()
    }
    assert kinds == {("bitplane_shift", 4, "i8", 1)}


@pytest.mark.parametrize("grouped", [False, True])
def test_prefill_logits_match_reference(world, grouped):
    """Within LOGITS_TOL x max|ref| at every position but where a LUT
    layer's fp16 input code flipped between the packages: the two sum in
    other orders (~1e-7), an activation that close to an fp16 rounding
    boundary takes the neighbouring code (a step of 2**-11 of its value),
    and the next layer carries the step on.  On these inputs that happens
    at one of the 18 positions (batch row 1, position 4: 4.3e-4 against a
    tolerance of 3.6e-4; every other position within 1.3e-7).  One such
    position is allowed, held to FLIP_TOL, with every argmax equal; the
    dense-expert test below holds every position to LOGITS_TOL."""
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped))
    got, _, _ = model_forward(
        world["tlut"], {"tokens": torch.from_numpy(world["prompts"])}, ctx
    )
    got, want = got.numpy(), world["ref"]["logits"]
    scale = float(np.abs(want).max())
    per_pos = np.abs(got - want).max(axis=-1)
    assert (per_pos > LOGITS_TOL * scale).sum() <= 1, per_pos
    assert per_pos.max() <= FLIP_TOL * scale, per_pos
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_dense_prefill_logits_match_reference():
    """Dense experts (no fp16 input quantization anywhere): every position
    within LOGITS_TOL x max|ref|."""
    jcfg = jget_config("qwen2_moe_a2_7b", reduced=True)
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    tree = numpy_params(model_specs(cfg), 31)
    prompts = np.random.default_rng(33).integers(0, cfg.vocab_size, (2, 9))
    prompts = prompts.astype(np.int32)
    jctx = JCtx(jcfg, ex=JExecCfg(remat="none"))
    want, _, jaux = jax.jit(lambda p, t: jmodel_forward(p, {"tokens": t}, jctx))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(prompts)
    )
    got, _, aux = model_forward(
        params_from_numpy(tree, device="cpu"), {"tokens": torch.from_numpy(prompts)},
        Ctx(cfg),
    )
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=LOGITS_TOL * float(np.abs(want).max())
    )
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))


def test_generate_streams_identical_to_reference(world):
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True))
    got = generate(world["tlut"], ctx, world["prompts"], MAX_NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), world["ref"]["generate"])


@pytest.mark.parametrize("admit", ["batched", "per-slot"])
def test_engine_streams_identical_to_reference(world, admit):
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True))
    got = _engine_streams(world["tlut"], ctx, _prompts(), admit=admit, device="cpu")
    assert got == world["ref"]["engine"]


def test_tl1_tree_streams_identical_to_reference(tl1_world):
    w = tl1_world
    assert w["mplan"].families == ("tl1",)
    ctx = Ctx(w["cfg"], ex=ExecCfg(lut_grouped=True))
    got = generate(w["tlut"], ctx, w["prompts"], MAX_NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), w["ref"]["generate"])
    streams = _engine_streams(w["tlut"], ctx, _prompts(), device="cpu")
    assert streams == w["ref"]["engine"]
    logits, _, _ = model_forward(w["tlut"], {"tokens": torch.from_numpy(w["prompts"])}, ctx)
    want = w["ref"]["logits"]
    np.testing.assert_allclose(
        logits.numpy(), want, rtol=0, atol=LOGITS_TOL * float(np.abs(want).max())
    )
