"""Reduced granite_8b served by the port under
``ExecCfg(linear_mode="binary_matmul")`` against the JAX package under
``ExecCfg(linear_mode="binary_matmul", use_pallas=True)`` (its Pallas
kernels in interpret mode): prefill logits agree on a dense tree and on a
mixed tree (attention converted to tables, the MLP dense), and greedy
``generate`` and ``BatchingEngine`` streams are identical.  The tree with
its projections rounded once to bf16 (``bf16_projections``, what the mode
serves on the card) gives the fp32 tree's outputs bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import ModelPlan as JModelPlan
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
from repro_torch.core.convert import LUTGroup
from repro_torch.core.planner import ModelPlan
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_forward
from repro_torch.models.params import bf16_projections, params_from_numpy
from repro_torch.serve import BatchingEngine, Request, generate

MAX_NEW, MAX_LEN, SLOTS = 8, 32, 3
# The decoder's fp32 sums (norms, attention, softmax, the binary products)
# in another order than XLA's: ~2e-7 of max|logit| on these inputs.  Each
# projection re-quantizes its input to 8/6 fixed point (a step of 1/64),
# so an activation within ~1e-7 of a rounding boundary would take the
# neighbouring code in one package and move the logits by ~1e-3 of max;
# no input here sits that close, which this tolerance holds to.
LOGITS_TOL = 1e-5
# positions downstream of such a code flip (see the mixed-tree test)
FLIP_TOL = 1e-2


def _prompts(seed=43, n=5, vocab=512):
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


def _jctx(jcfg, **kw):
    return JCtx(
        jcfg, ex=JExecCfg(remat="none", linear_mode="binary_matmul", use_pallas=True, **kw)
    )


def _jlogits(params, jctx, prompts):
    fwd = jax.jit(lambda p, t: jmodel_forward(p, {"tokens": t}, jctx)[0])
    return np.asarray(fwd(params, jnp.asarray(prompts)))


@pytest.fixture(scope="module")
def world():
    jcfg = jget_config("granite_8b", reduced=True)
    cfg = get_config("granite_8b", reduced=True)
    jp = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(41))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    prompts = np.random.default_rng(42).integers(0, cfg.vocab_size, (2, 10))
    prompts = prompts.astype(np.int32)
    jctx = _jctx(jcfg)
    ref = {
        "logits": _jlogits(jp, jctx, prompts),
        "generate": np.asarray(jgenerate(jp, jctx, jnp.asarray(prompts), MAX_NEW)),
        "engine": _engine_streams(
            jp, jctx, [jnp.asarray(p) for p in _prompts()], JEngine, JRequest
        ),
    }
    return dict(cfg=cfg, jcfg=jcfg, jp=jp, tp=tp, prompts=prompts, ref=ref)


def _ctx(cfg, **kw):
    return Ctx(cfg, ex=ExecCfg(linear_mode="binary_matmul", **kw))


def _assert_logits(got: torch.Tensor, want: np.ndarray) -> None:
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGITS_TOL * scale)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_prefill_logits_match_reference(world):
    got, _, _ = model_forward(
        world["tp"], {"tokens": torch.from_numpy(world["prompts"])}, _ctx(world["cfg"])
    )
    _assert_logits(got, world["ref"]["logits"])
    # the mode is on: the standard path gives other logits (8/6 inputs)
    std, _, _ = model_forward(
        world["tp"], {"tokens": torch.from_numpy(world["prompts"])}, Ctx(world["cfg"])
    )
    assert np.abs(std.numpy() - world["ref"]["logits"]).max() > 1e-3


def test_generate_streams_identical_to_reference(world):
    got = generate(world["tp"], _ctx(world["cfg"]), world["prompts"], MAX_NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), world["ref"]["generate"])


@pytest.mark.parametrize("admit", ["batched", "per-slot"])
def test_engine_streams_identical_to_reference(world, admit):
    got = _engine_streams(
        world["tp"], _ctx(world["cfg"]), _prompts(), admit=admit, device="cpu"
    )
    assert got == world["ref"]["engine"]


@pytest.mark.parametrize("grouped", [False, True])
def test_mixed_tree_logits_match_reference(world, grouped):
    """Attention converted to chunk-1 tables (lone wq, grouped wk+wv and
    wo), the MLP left dense: converted layers take their LUT path and the
    dense ones the binary path, in both packages.

    On these inputs one LUT layer's fp16 input code flips between the
    packages at batch row 1, position 6 (the same flip moves the standard
    mode's logits there by 1.2e-4 of max); the binary MLP's 8/6
    re-quantization grows it to 7.9e-3 of max, and causal attention carries
    it to that row's later positions (3.3e-3 to 3.9e-3).  The reference's
    own two paths (Pallas and einsum) differ by 1.9e-3 of max on this tree
    by the same mechanism.  So: every position before the flip within
    LOGITS_TOL, at most the last 4 positions of one row within FLIP_TOL,
    and every argmax equal."""
    jp = world["jp"]
    jm = jplan_model(jp, float("inf"), max_chunk=1)
    keep = {k: v for k, v in jm.layers.items() if "/attn/" in k}
    jm = JModelPlan(
        keep, groups=tuple(g for g in jm.groups if all(k in keep for k in g)),
        copies={k: v for k, v in jm.copies.items() if k in keep},
    )
    jlut, _ = jconvert(jp, plan=jm)
    tlut = params_from_numpy(
        jax.tree.map(np.asarray, jlut), device="cpu", plan=ModelPlan.from_json(jm.to_json())
    )
    assert isinstance(tlut["blocks"]["attn"]["wk+wv"], LUTGroup)
    assert isinstance(tlut["blocks"]["ffn"]["w_up"], dict)
    want = _jlogits(jlut, _jctx(world["jcfg"], lut_grouped=grouped), world["prompts"])
    got, _, _ = model_forward(
        tlut, {"tokens": torch.from_numpy(world["prompts"])},
        _ctx(world["cfg"], lut_grouped=grouped),
    )
    scale = float(np.abs(want).max())
    per_pos = np.abs(got.numpy() - want).max(axis=-1)  # (rows, positions)
    rows, cols = np.nonzero(per_pos > LOGITS_TOL * scale)
    assert len(set(rows)) <= 1 and len(cols) <= 4, per_pos / scale
    if len(cols):  # a suffix of one row: the flip and what attends to it
        assert list(cols) == list(range(cols[0], per_pos.shape[1])), per_pos / scale
    assert per_pos.max() <= FLIP_TOL * scale, per_pos / scale
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def bf16_tree(world):
    tree = bf16_projections(world["tp"])
    # only the projections' w changed: embedding, norms (and biases) stay fp32
    assert tree["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert tree["blocks"]["ffn"]["w_down"]["w"].dtype == torch.bfloat16
    assert tree["embed"].dtype == torch.float32
    assert tree["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert tree["ln_f"]["scale"].dtype == torch.float32
    return tree


def test_bf16_projection_tree_prefill_logits_identical(world, bf16_tree):
    tokens = {"tokens": torch.from_numpy(world["prompts"])}
    want, _, _ = model_forward(world["tp"], tokens, _ctx(world["cfg"]))
    got, _, _ = model_forward(bf16_tree, tokens, _ctx(world["cfg"]))
    assert torch.equal(got, want)  # W is rounded to bf16 before the product either way
    _assert_logits(got, world["ref"]["logits"])


def test_bf16_projection_tree_generate_identical(world, bf16_tree):
    want = generate(world["tp"], _ctx(world["cfg"]), world["prompts"], MAX_NEW, device="cpu")
    got = generate(bf16_tree, _ctx(world["cfg"]), world["prompts"], MAX_NEW, device="cpu")
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), world["ref"]["generate"])


@pytest.mark.parametrize("admit", ["batched", "per-slot"])
def test_bf16_projection_tree_engine_streams_identical(world, bf16_tree, admit):
    want = _engine_streams(world["tp"], _ctx(world["cfg"]), _prompts(), admit=admit, device="cpu")
    got = _engine_streams(bf16_tree, _ctx(world["cfg"]), _prompts(), admit=admit, device="cpu")
    assert got == want == world["ref"]["engine"]
