"""The RWKV-6, zamba2 hybrid and whisper enc-dec families under autograd,
against the JAX package, on the CPU.

* One gradient step (``make_grad_fn``, which the train step runs before
  AdamW) of reduced ``rwkv6_3b``, ``zamba2_1_2b`` and ``whisper_base`` from
  the same numpy weights (the leaves ``init_params`` zeroes drawn from a
  seed, as the families' serve tests draw them) and the same batch (for
  whisper with ``enc_embeds``), fp32 compute: loss and the gradients'
  global norm within GRAD_TOL relative of the reference's (remat
  ``"none"`` in the reference; ``"full"`` in the port).
* Remat: each family's gradients under ``"full"``, ``"dots"`` and
  ``"dots_no_batch"`` bit for bit those under ``"none"`` at bf16 compute,
  every loss and gradient finite and at least 90 % of the gradient leaves
  non-zero (``tests/test_models_smoke.py``'s rule), the encoder's among
  them (the gradient reaches it through the recomputed cross K/V).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.optim.adamw import global_norm as jglobal_norm
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_grad_fn as jmake_grad_fn
from repro_torch.configs.base import get_config
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_specs
from repro_torch.models.params import params_from_numpy, tree_flatten
from repro_torch.optim.adamw import global_norm
from repro_torch.train.trainer import TrainConfig, make_grad_fn
from test_torch_hybrid import seeded_leaves as hybrid_leaves
from test_torch_moe import numpy_params
from test_torch_rwkv import seeded_leaves as rwkv_leaves

ARCHS = ["rwkv6_3b", "zamba2_1_2b", "whisper_base"]
GRAD_TOL = 1e-4  # relative, as tests/test_torch_train.py's one-step checks
B, L, S_ENC = 2, 16, 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _encdec_leaves(tree: dict, seed: int) -> dict:
    """Every LayerNorm's scale ~ 1 + N(0, 0.2) and bias ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict) and set(v) == {"scale", "bias"}:
                v["scale"] = (1 + 0.2 * rng.standard_normal(v["scale"].shape)).astype(np.float32)
                v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
            elif isinstance(v, dict):
                walk(v)

    walk(tree)
    return tree


SEEDED = {"rwkv6_3b": rwkv_leaves, "zamba2_1_2b": hybrid_leaves, "whisper_base": _encdec_leaves}


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    arch = request.param
    cfg = get_config(arch, reduced=True)
    tree = SEEDED[arch](numpy_params(model_specs(cfg), 101), 102)
    rng = np.random.default_rng(103)
    toks = rng.integers(0, cfg.vocab_size, (B, L + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_embeds"] = (rng.standard_normal((B, S_ENC, cfg.d_model)) * 0.1).astype(
            np.float32)
    return arch, cfg, tree, batch


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def test_one_step_matches_reference(family):
    arch, cfg, tree, batch = family
    jcfg = jget_config(arch, reduced=True)
    jgrad = jmake_grad_fn(JCtx(jcfg, ex=JExecCfg(remat="none")),
                          JTrainConfig(compute_dtype=jnp.float32))

    def jstep(p, b):
        g, loss, aux, _ = jgrad(p, b, None)
        return loss, jglobal_norm(g)

    want = jax.jit(jstep)(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    ctx = Ctx(cfg, ex=ExecCfg(remat="full"))
    g, loss, aux = make_grad_fn(ctx, TrainConfig(compute_dtype=torch.float32))(
        params_from_numpy(tree, device="cpu"), _t(batch))
    for w, got in zip(map(float, want), (float(loss), float(global_norm(g)))):
        assert abs(w - got) <= GRAD_TOL * abs(w), (arch, want, loss, global_norm(g))
    assert float(aux) == 0.0


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_gradients_equal_none(family, policy):
    arch, cfg, tree, batch = family
    params = params_from_numpy(tree, device="cpu")
    tc = TrainConfig(compute_dtype=torch.bfloat16)
    runs = {}
    for mode in ("none", policy):
        g, loss, aux = make_grad_fn(Ctx(cfg, ex=ExecCfg(remat=mode)), tc)(params, _t(batch))
        runs[mode] = (g, loss)
    (g0, loss0), (g1, loss1) = runs["none"], runs[policy]
    base, got = tree_flatten(g0)[0], tree_flatten(g1)[0]
    assert torch.equal(loss0, loss1) and bool(torch.isfinite(loss0))
    assert all(torch.equal(a, b) for a, b in zip(base, got))
    assert all(bool(torch.isfinite(a).all()) for a in base)
    nonzero = sum(bool((a != 0).any()) for a in base)
    assert nonzero >= int(0.9 * len(base)), f"{nonzero}/{len(base)} gradient leaves non-zero"
    if arch == "whisper_base":  # through the cross K/V recomputed in every layer
        assert all(bool((a != 0).any()) for a in tree_flatten(g0["encoder"])[0])
