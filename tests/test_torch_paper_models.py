"""The paper's three networks in the port against the JAX package, on the
same weights (the reference's, carried across with ``params_from_numpy``)
and the same numpy inputs: ``im2col`` / ``maxpool2`` exactly, the dense
forwards, the converted trees (tables bit for bit; logits of the port's
plain versions against the reference's jnp oracles), the TL1 head, the
accuracy rows of ``benchmarks/accuracy_vs_bits.py`` and the new entry
points' device rule.

The reference's conversions of the whole networks are slow on the CPU, so
the converted cases take only the small layers (``convert_params``'s
``predicate``): all of the linear classifier, the MLP's ``fc3``, LeNet's
``conv1``, ``conv2`` and ``fc2``; the rest stays dense."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.lut import LUTPlan as JLUTPlan
from repro.core.lut_tl1 import TL1Plan as JTL1Plan
from repro.core.planner import ModelPlan as JModelPlan
from repro.core.quantize import FixedPointFormat as JFixed
from repro.models import paper_models as jpm
from repro.models.layers import Ctx as JCtx
from repro.models.layers import linear as jlinear
from repro.models.params import init_params as jinit_params
from repro_torch.benchmarks import accuracy_vs_bits
from repro_torch.core.convert import LUTLinear, convert_params
from repro_torch.core.lut import LUTPlan
from repro_torch.core.lut_tl1 import TL1Plan
from repro_torch.core.planner import ModelPlan
from repro_torch.core.quantize import FixedPointFormat
from repro_torch.data.synthetic import image_batch
from repro_torch.examples import tablenet_mnist
from repro_torch.models import paper_models as pm
from repro_torch.models.layers import linear
from repro_torch.models.params import params_from_numpy
from test_torch_paper import _reference_script

# fp32 sums of the same products taken in another order (dense matmuls,
# LUT gathers): a few ulps of the largest logit
DENSE_TOL = 1e-5
# one converted layer on the same input: the port's plain LUT sums against
# the reference's einsum, in another order
LUT_TOL = 2e-5
# a whole converted network: a layer's input is the output of layers whose
# fp32 sums run in another order in the two packages, so an element at an
# fp16 rounding boundary can pack one fp16 step (2**-11 of itself) apart;
# one such flip moved an MLP logit by 3.4e-5 of max (fc3's input, chunk 1)
NET_TOL = 1e-3
# the TL1 exact path's fp32 sums (as tests/test_torch_tl1.py); the int
# path is integer arithmetic with a ternary scale a few ulps off
TL1_TOL = 1e-5

SUBSET = {
    "linear": ("fc",),
    "mlp": ("fc3",),
    "lenet": ("conv1", "conv2", "fc2"),
}
# LeNet's conv2 at chunk 2 holds 420 MiB of tables (1.6 GiB signed) in each
# package; its chunk-2 cases keep it dense
SUBSET_C2 = {"linear": ("fc",), "mlp": ("fc3",), "lenet": ("conv1", "fc2")}


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=0, atol=tol * float(np.abs(want).max())
    )


@pytest.fixture(scope="module")
def jctx():
    return JCtx(jget_config("granite_8b", reduced=True))


@pytest.fixture(scope="module")
def nets():
    """name -> (reference params, port params, numpy images): seeded
    reference weights and [0, 1] images, B = 4 (LeNet 2)."""
    out = {}
    for i, name in enumerate(("linear", "mlp", "lenet")):
        specs, _ = jpm.PAPER_MODELS[name]
        jp = jinit_params(specs(), jax.random.PRNGKey(10 + i))
        B = 2 if name == "lenet" else 4
        x = np.random.default_rng(i).uniform(0, 1, (B, 28, 28)).astype(np.float32)
        out[name] = (jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"), x)
    return out


# ---------------------------------------------------------------------------
# im2col, maxpool2, dense forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,k", [((2, 28, 28, 1), 5), ((1, 14, 14, 32), 5),
                                     ((3, 6, 8, 3), 3), ((1, 5, 5, 2), 1)])
def test_im2col_is_the_references_exactly(shape, k):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = pm.im2col(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpm.im2col(jnp.asarray(x), k)))


@pytest.mark.parametrize("shape", [(2, 28, 28, 32), (1, 14, 14, 64), (3, 4, 6, 1)])
def test_maxpool2_is_the_references_exactly(shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    got = pm.maxpool2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpm.maxpool2(jnp.asarray(x))))


@pytest.mark.parametrize("name", ["linear", "mlp", "lenet"])
def test_dense_forward_matches_the_reference(name, nets, jctx):
    jp, tp, x = nets[name]
    _, jfwd = jpm.PAPER_MODELS[name]
    _, fwd = pm.PAPER_MODELS[name]
    want = jfwd(jp, jnp.asarray(x), jctx)
    got = fwd(tp, torch.from_numpy(x), pm.paper_ctx())
    assert tuple(got.shape) == (x.shape[0], 10)
    _close(got.numpy(), want, DENSE_TOL)


@pytest.mark.parametrize("name", ["linear", "mlp", "lenet"])
def test_specs_are_the_references(name):
    spec = pm.PAPER_MODELS[name][0]()
    jspec = jpm.PAPER_MODELS[name][0]()
    assert {k: {kk: tuple(v.shape) for kk, v in d.items()} for k, d in spec.items()} == {
        k: {kk: tuple(v.shape) for kk, v in d.items()} for k, d in jspec.items()
    }


# ---------------------------------------------------------------------------
# converted trees
# ---------------------------------------------------------------------------


def _predicate(layers):
    return lambda path, node: path[-1] in layers


def _same_tables(tree, jtree, layers):
    for key in tree:
        node, jnode = tree[key], jtree[key]
        if key in layers:
            assert isinstance(node, LUTLinear) and node.scale is None
            np.testing.assert_array_equal(node.tables.numpy(), np.asarray(jnode.tables))
            np.testing.assert_array_equal(node.b.numpy(), np.asarray(jnode.b))
        else:
            assert isinstance(node, dict) and not hasattr(jnode, "tables")


@pytest.mark.parametrize("signed", [False, True], ids=["unsigned", "signed"])
@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("name", ["linear", "mlp", "lenet"])
def test_converted_tables_and_logits_match_the_reference(name, chunk, signed, nets, jctx):
    jp, tp, x = nets[name]
    layers = (SUBSET if chunk == 1 else SUBSET_C2)[name]
    if name == "lenet" and chunk == 2 and signed:
        layers = ("conv1",)  # fc2's signed chunk-2 tables: 335 MiB a package
    jconv, jrep = jconvert(jp, chunk_size=chunk, signed=signed,
                           predicate=_predicate(layers))
    conv, rep = convert_params(tp, chunk_size=chunk, signed=signed,
                               predicate=_predicate(layers))
    assert (rep.converted, rep.skipped, rep.table_bytes) == (
        jrep.converted, jrep.skipped, jrep.table_bytes
    )
    assert rep.converted == len(layers)
    _same_tables(conv, jconv, layers)
    ctx = pm.paper_ctx()
    rng = np.random.default_rng(5)
    for layer in layers:  # each converted layer on one input: ReLU-like, rows 6
        xin = rng.uniform(0, 3, (6, conv[layer].plan.in_features)).astype(np.float32)
        xin[:, ::7] = 0.0
        want = jlinear(jconv[layer], jnp.asarray(xin), jctx)
        _close(linear(conv[layer], torch.from_numpy(xin), ctx).numpy(), want, LUT_TOL)
    want = np.asarray(jpm.PAPER_MODELS[name][1](jconv, jnp.asarray(x), jctx))
    got = pm.PAPER_MODELS[name][1](conv, torch.from_numpy(x), ctx).numpy()
    _close(got, want, NET_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_fig5_fixed_point_plan_is_the_references_and_the_quantized_model():
    """The paper's Fig. 5 point: the classifier at 3/3 fixed point, chunk
    14 (56 tables of 16384 entries).  Tables bit for bit; on 3-bit inputs
    the LUT logits are the dense model's on the same inputs (the paper's
    exactness claim) and the reference's."""
    jp = jinit_params(jpm.linear_classifier_specs(), jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jconv, _ = jconvert(jp, plan=JModelPlan({"fc": JLUTPlan(784, 10, 14, JFixed(3, 3))}))
    plan = LUTPlan(784, 10, 14, FixedPointFormat(3, 3))
    assert (plan.num_chunks, plan.num_entries) == (56, 16384)
    conv, rep = convert_params(tp, plan=ModelPlan({"fc": plan}))
    assert rep.table_bytes == plan.num_chunks * plan.num_entries * 10 * 4
    _same_tables(conv, jconv, ("fc",))
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (8, 28, 28)).astype(np.float32))
    x3 = pm.quantize_inputs(x, 3)
    ctx = pm.paper_ctx()
    got = pm.linear_classifier_forward(conv, x3, ctx)
    dense = pm.linear_classifier_forward(tp, x3, ctx)
    want = jpm.linear_classifier_forward(jconv, jnp.asarray(x3.numpy()), JCtx(
        jget_config("granite_8b", reduced=True)))
    _close(got.numpy(), want, LUT_TOL)
    _close(got.numpy(), dense.numpy(), LUT_TOL)


@pytest.mark.parametrize("act_bits", [None, 8, 2])
def test_tl1_head_matches_the_reference(act_bits, nets, jctx):
    jp, tp, x = nets["linear"]
    jconv, _ = jconvert(jp, plan=JModelPlan({"fc": JTL1Plan(784, 10, act_bits=act_bits)}))
    conv, _ = convert_params(tp, plan=ModelPlan({"fc": TL1Plan(784, 10, act_bits=act_bits)}))
    assert conv["fc"].tables.dtype == torch.uint8
    np.testing.assert_array_equal(conv["fc"].tables.numpy(), np.asarray(jconv["fc"].tables))
    want = jpm.linear_classifier_forward(jconv, jnp.asarray(x), jctx)
    got = pm.linear_classifier_forward(conv, torch.from_numpy(x), pm.paper_ctx())
    _close(got.numpy(), want, TL1_TOL)


# ---------------------------------------------------------------------------
# the accuracy rows
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained():
    """A short reference training run of the classifier (40 steps of 64
    images), carried across."""
    ref = _reference_script("accuracy_vs_bits")
    jp, jctx = ref.train_linear(steps=40, batch=64)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return ref, jp, jctx, tp


# 2000 images in 4 batches of 500: at most one image a batch may differ
# (an argmax tie moved by fp32 sums in another order)
ROW_TOL = 4 / 2000


@pytest.mark.parametrize("bits", [None, 1, 2, 3, 4, 5, 6, 7, 8])
def test_accuracy_rows_match_the_reference(bits, trained):
    ref, jp, jctx, tp = trained
    got = accuracy_vs_bits.accuracy(tp, pm.paper_ctx(), bits, device="cpu")
    want = ref.accuracy(jp, jctx, bits)
    assert abs(got - want) <= ROW_TOL, (got, want)


@pytest.mark.parametrize("act_bits", [None, 8, 4, 2])
def test_tl1_accuracy_rows_match_the_reference(act_bits, trained):
    ref, jp, jctx, tp = trained
    got = accuracy_vs_bits.tl1_accuracy(tp, pm.paper_ctx(), act_bits,
                                        device="cpu")
    want = ref.tl1_accuracy(jp, jctx, act_bits)
    assert abs(got - want) <= ROW_TOL, (got, want)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")


ENTRY_POINTS = {
    "image_batch": lambda: image_batch(2, 0),
    "train": lambda: tablenet_mnist.train("linear", steps=1),
    "accuracy": lambda: tablenet_mnist.accuracy(None, None, None),
    "main": lambda: tablenet_mnist.main(["--steps", "1"]),
    "train_linear": lambda: accuracy_vs_bits.train_linear(steps=1),
    "bits_accuracy": lambda: accuracy_vs_bits.accuracy(None, None, None),
    "tl1_accuracy": lambda: accuracy_vs_bits.tl1_accuracy(None, None, None),
    "rows": lambda: accuracy_vs_bits.rows(),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    _no_card()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ENTRY_POINTS[entry]()


@pytest.mark.parametrize("name", ["linear", "mlp", "lenet"])
def test_train_runs_on_the_cpu_and_lowers_the_loss(name):
    params, forward, ctx = tablenet_mnist.train(name, steps=0, device="cpu")
    x, y = image_batch(128, 0, device="cpu")
    before = float(pm.cross_entropy(forward(params, x, ctx), y))
    trained, _, _ = tablenet_mnist.train(name, steps=3, lr=0.1, device="cpu")
    after = float(pm.cross_entropy(forward(trained, x, ctx), y))
    assert np.isfinite(after) and after < before
    assert all(not t.requires_grad for d in trained.values() for t in d.values())
    acc = tablenet_mnist.accuracy(forward, trained, ctx, bits=4, n=500, device="cpu")
    assert 0.0 <= acc <= 1.0


def test_tablenet_main_runs_on_the_cpu(capsys):
    assert tablenet_mnist.main(["--model", "linear", "--steps", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "argmax agreement" in out and "m=14" not in out and "m= 1" in out


def test_accuracy_rows_run_on_the_cpu(monkeypatch):
    real = accuracy_vs_bits.train_linear
    monkeypatch.setattr(accuracy_vs_bits, "train_linear",
                        lambda device: real(steps=5, batch=64, device=device))
    rows = accuracy_vs_bits.rows(device="cpu")
    names = [r[0] for r in rows]
    assert names == (["fig4/reference_fp32"] + [f"fig4/bits_{b}" for b in range(1, 9)]
                     + ["fig4/tl1_fp", "fig4/tl1_a8", "fig4/tl1_a4", "fig4/tl1_a2"])
    assert all(0.0 <= r[1] <= 1.0 for r in rows)
