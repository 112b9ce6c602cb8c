"""``repro_torch.models`` against ``repro.models`` on the same weights and
tokens: reduced granite_8b logits for dense, LUT per-projection and
LUT-grouped params, plus the init rules, the explicit-device contract, every
family building, every config's parameter count, whisper's GELU MLP and the
norms."""
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
    """Every family of the reference now builds: each of its configs is the
    port's, and its spec tree is the reference's, leaf for leaf (shapes);
    a decoder-only family with LayerNorm, which the reference never builds,
    still raises."""
    from repro.configs.base import ARCH_NAMES as JARCH_NAMES
    from repro_torch.configs.base import ModelConfig

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for n, t in tree.items() for k, v in shapes(t, f"{prefix}/{n}").items()}
        return {prefix: tuple(tree.shape)}

    assert sorted(ARCH_NAMES) == sorted(JARCH_NAMES)
    families = set()
    for arch in JARCH_NAMES:
        cfg = get_config(arch, reduced=True)
        families.add(cfg.family)
        assert shapes(model_specs(cfg)) == shapes(jmodel_specs(jget_config(arch, reduced=True)))
    assert families == {"dense", "moe", "vlm", "ssm", "hybrid", "encdec"}
    assert set(model_specs(get_config("whisper_base"))) == {
        "embed", "encoder", "enc_ln_f", "decoder", "ln_f"}
    layernorm = ModelConfig("x", "moe", 1, 8, 2, 2, 8, 16, norm="layernorm", num_experts=2)
    with pytest.raises(NotImplementedError):
        model_specs(layernorm)


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
    "whisper_base": (55e6, 110e6),
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
    """whisper's biased GELU MLP (``act="gelu"``): ``w_in`` and ``w_out``
    both with a bias, and ``mlp`` within 1e-6 x max of the reference's on
    pre-activations over [-4, 4], the tanh form that ``jax.nn.gelu`` takes
    by default (the erf form is 4.1e-4 off there)."""
    from repro.models.layers import mlp as jmlp
    from repro_torch.models.layers import mlp, mlp_specs

    cfg = get_config("whisper_base", reduced=True)
    jcfg = jget_config("whisper_base", reduced=True)
    specs = mlp_specs(cfg)
    assert {k: set(v) for k, v in specs.items()} == {"w_in": {"w", "b"}, "w_out": {"w", "b"}}
    rng = np.random.default_rng(5)
    p = {"w_in": {"w": rng.standard_normal((64, 128)).astype(np.float32) / 4,
                  "b": rng.standard_normal(128).astype(np.float32) * 0.1},
         "w_out": {"w": rng.standard_normal((128, 64)).astype(np.float32) / 11,
                   "b": rng.standard_normal(64).astype(np.float32) * 0.1}}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(jmlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           JCtx(jcfg, ex=JExecCfg(remat="none"))))
    got = mlp(params_from_numpy(p, device="cpu"), torch.from_numpy(x), Ctx(cfg)).numpy()
    h = x @ p["w_in"]["w"] + p["w_in"]["b"]
    assert h.min() < -2 and h.max() > 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def _rmsnorm_before_layernorm(p, x, cfg):
    """``apply_norm`` as it was before LayerNorm came (RMSNorm alone)."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_reference(norm, dtype):
    """``apply_norm`` under ``cfg.norm``: LayerNorm (biased variance, a bias,
    ``cfg.norm_eps``) and RMSNorm within 1e-6 x max of the reference's on
    fp32 input (fp32 sums in another order) and within one bf16 ulp on bf16
    input (the fp32 result rounded once); RMSNorm bit for bit what it was
    before LayerNorm came, and ``norm_spec`` with the reference's keys."""
    from repro.models.layers import apply_norm as japply_norm
    from repro.models.layers import norm_spec as jnorm_spec
    from repro_torch.models.layers import apply_norm, norm_spec

    base = get_config("whisper_base", reduced=True)
    cfg = dataclasses.replace(base, norm=norm, norm_eps=1e-5 if norm == "layernorm" else 1e-6)
    jcfg = dataclasses.replace(jget_config("whisper_base", reduced=True), norm=cfg.norm,
                               norm_eps=cfg.norm_eps)
    assert set(norm_spec(cfg)) == set(jnorm_spec(jcfg))
    rng = np.random.default_rng(6)
    p = {"scale": (1 + 0.2 * rng.standard_normal(64)).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = (0.1 * rng.standard_normal(64)).astype(np.float32)
    x = (3 + 2 * rng.standard_normal((2, 5, 64))).astype(np.float32)  # a mean to remove
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tp = params_from_numpy(p, device="cpu")
    got = apply_norm(tp, tx, cfg)
    want = np.asarray(japply_norm(jax.tree.map(jnp.asarray, p), jx, jcfg).astype(jnp.float32))
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    if norm == "rmsnorm":
        assert torch.equal(got, _rmsnorm_before_layernorm(tp, tx, cfg))
