"""``repro_torch.models`` against ``repro.models`` on the same weights and
tokens: reduced granite_8b logits for dense, LUT per-projection and
LUT-grouped params, plus the init rules, the explicit-device contract, every
ported config's parameter count and the MLPs not ported yet."""
import dataclasses
import math

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
from repro.models.model import model_forward as jforward
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro_torch.configs.base import ARCH_NAMES, get_config
from repro_torch.core.convert import convert_params
from repro_torch.core.planner import ModelPlan
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_forward, model_specs
from repro_torch.models.params import PSpec, init_params, params_from_numpy

SERVING = dict(
    max_chunk=2,
    modes=("bitplane", "bitplane_shift"),
    radices=(1, 2, 4),
    table_formats=(None, "i8"),
)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("granite_8b", reduced=True)
    jp = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    uniform = jplan_model(jp, float("inf"), max_chunk=2)
    jm = jplan_model(jp, uniform.total_lut_bytes // 2, **SERVING)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, jp, tp, jm, tokens


@pytest.mark.parametrize("layout", ["dense", "lut_flat", "lut_grouped"])
def test_forward_logits_match_reference(setup, layout):
    jcfg, jp, tp, jm, tokens = setup
    cfg = get_config("granite_8b", reduced=True)
    grouped = layout == "lut_grouped"
    if layout != "dense":
        jp, _ = jconvert(jp, plan=jm, group_siblings=grouped)
        tp, _ = convert_params(
            tp, plan=ModelPlan.from_json(jm.to_json()), group_siblings=grouped
        )
    jctx = JCtx(jcfg, ex=JExecCfg(remat="none", lut_grouped=grouped))
    want, _, _ = jforward(jp, {"tokens": jnp.asarray(tokens)}, jctx)
    got, _, _ = model_forward(
        tp,
        {"tokens": torch.from_numpy(tokens)},
        Ctx(cfg, ex=ExecCfg(lut_grouped=grouped)),
    )
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    # fp32 sums in other orders; at most one fp16 code of an activation
    # moves by an ulp (2**-11) before a table lookup
    np.testing.assert_allclose(
        got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max()
    )
    assert (got.numpy().argmax(-1) == want.argmax(-1)).all()


def test_grouped_and_flat_layouts_agree_exactly(setup):
    _, _, tp, jm, tokens = setup
    cfg = get_config("granite_8b", reduced=True)
    mp = ModelPlan.from_json(jm.to_json())
    out = []
    for grouped in (False, True):
        conv, _ = convert_params(tp, plan=mp, group_siblings=True)
        logits, _, _ = model_forward(
            conv,
            {"tokens": torch.from_numpy(tokens)},
            Ctx(cfg, ex=ExecCfg(lut_grouped=grouped)),
        )
        out.append(logits)
    assert torch.equal(out[0], out[1])


def test_init_rules_follow_the_reference():
    specs = {
        "stacked": PSpec((4, 256, 64), ("layers", "embed", "mlp")),
        "embed": PSpec((512, 64), ("vocab", "embed"), init="embed"),
        "ones": PSpec((64,), ("embed",), init="ones"),
    }
    p = init_params(specs, torch.Generator().manual_seed(0), device="cpu")
    # a stacked (L, q, p) leaf takes std 1/sqrt(L*q), as in the reference
    assert abs(p["stacked"].std().item() - 1 / math.sqrt(4 * 256)) < 2e-3
    assert abs(p["embed"].std().item() - 0.02) < 1e-3
    assert torch.equal(p["ones"], torch.ones(64))
    again = init_params(specs, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["stacked"], again["stacked"])

    # the spec tree is the reference's, leaf for leaf
    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {
                k: v for n, t in tree.items()
                for k, v in shapes(t, f"{prefix}/{n}").items()
            }
        return {prefix: (tuple(tree.shape), tree.init)}

    jspecs = jmodel_specs(jget_config("granite_8b", reduced=True))
    assert shapes(model_specs(get_config("granite_8b", reduced=True))) == shapes(jspecs)


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params({"w": PSpec((2, 2), (None, None))}, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({"w": np.zeros((2, 2), np.float32)})


def test_other_families_raise():
    """Only the enc-dec family is left to port: its specs raise, naming its
    slice, as does whisper's config; the hybrid family's config and specs
    now build."""
    from repro_torch.configs.base import ModelConfig

    for family, slice_ in (("encdec", "enc-dec"),):
        cfg = ModelConfig("x", family, 1, 8, 2, 2, 8, 16)
        with pytest.raises(NotImplementedError, match=slice_):
            model_specs(cfg)
    layernorm = ModelConfig("x", "moe", 1, 8, 2, 2, 8, 16, norm="layernorm", num_experts=2)
    with pytest.raises(NotImplementedError):
        model_specs(layernorm)
    with pytest.raises(NotImplementedError):
        get_config("whisper_base")
    hybrid = get_config("zamba2_1_2b")
    assert hybrid.family == "hybrid" and set(model_specs(hybrid)) == {
        "embed", "mamba", "shared", "ln_f", "lm_head"}


# each published config's parameter count (tests/test_models_smoke.py's ranges)
PARAM_RANGES = {
    "granite_8b": (7.3e9, 8.6e9),
    "llava_next_mistral_7b": (6.8e9, 7.8e9),
    "minicpm3_4b": (3.6e9, 4.8e9),
    "minitron_4b": (3.7e9, 4.8e9),
    "mixtral_8x7b": (45e9, 48e9),
    "phi3_medium_14b": (13e9, 15e9),
    "qwen2_moe_a2_7b": (13e9, 15.5e9),
    "rwkv6_3b": (2.7e9, 3.6e9),
    "zamba2_1_2b": (1.0e9, 1.6e9),
}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_full_config(arch):
    """Every ported architecture at its published widths: the parameter
    count of its spec tree, counted on the shapes without allocating, lands
    in the reference's ballpark."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return math.prod(tree.shape)

    lo, hi = PARAM_RANGES[arch]
    n = count(model_specs(get_config(arch)))
    assert lo <= n <= hi, f"{arch}: {n / 1e9:.2f}B params"


def test_gelu_mlp_raises_naming_its_slice():
    """whisper's biased GELU MLP is not ported: its spec raises, naming the
    enc-dec slice."""
    cfg = dataclasses.replace(get_config("granite_8b", reduced=True), act="gelu")
    with pytest.raises(NotImplementedError, match="enc-dec slice"):
        model_specs(cfg)
