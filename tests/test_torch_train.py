"""The port's training path against the JAX package, on the CPU.

* ``optim/schedule.py::warmup_cosine`` equal to the reference's at steps 0 ..
  total + 2 (fp32, the C library's ``cosf`` as XLA:CPU calls it).
* ``train/losses.py::cross_entropy`` on a padded vocabulary with ``-1``
  labels: within 1e-6 relative, the count exact.
* ``optim/adamw.py::adamw_update`` over 3 steps of a tree with fp32 and bf16,
  1-D and 2-D leaves, clip on and off: params, ``m``, ``v`` and
  ``grad_norm`` within 1e-6 x max, ``step`` exact.
* ``data/synthetic.py::lm_batch`` at vocab 512, 2,048 and 32,000: keys,
  threefry bits, uniforms and the ``repeat`` mask bit for bit; at least
  99.99 % of tokens equal, and every differing categorical draw one where
  the reference's two largest ``logits + gumbel`` lie within 4 ulp (fp32
  ``log`` differs between XLA and torch in the last bit).  ``lm_stream``
  from step k is the tail of the stream from 0; ``prefetch`` keeps order.
* ``dist/checkpoint.py``: fp32 / int32 / bf16 / scalar leaves round trip,
  ``.tmp_*`` and a step without ``meta.json`` ignored, ``keep_last``,
  ``aux``; the reference saves and the port restores bit for bit, and the
  reverse, ``meta.json`` for ``meta.json``; a port Trainer resumes from the
  reference Trainer's checkpoint.
* Remat: gradients under ``"full"``, ``"dots"`` and ``"dots_no_batch"`` bit
  for bit those under ``"none"``.
* ``train/trainer.py`` on reduced granite_8b from the same initial weights
  (``params_from_numpy`` of the reference's ``init_params``) and the same
  batches (the reference's ``lm_stream``, as numpy): 8 steps at fp32
  compute, loss and ``grad_norm`` within 1e-4 relative; at bf16 within 1e-2
  (measured: 6.4e-4 and 2.5e-3); one step with ``microbatches=2``, one of
  reduced qwen2_moe_a2_7b (the router's aux) and one of reduced
  llava_next_mistral_7b (image positions labelled -1): loss, aux and the
  gradients' global norm within 1e-4.
* Port-only twins of ``tests/test_trainer.py``: the loss falls, a restart
  resumes bit for bit, an injected failure and a NaN loss replay from the
  checkpoint, preemption checkpoints and exits.
* The port's quickstart: the standard rows equal the LUT rows.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.data.pipeline import lm_stream as jlm_stream
from repro.data.synthetic import LMStreamConfig as JLMStreamConfig
from repro.data.synthetic import lm_batch as jlm_batch
from repro.dist import checkpoint as jckpt
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.adamw import global_norm as jglobal_norm
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro.train.losses import cross_entropy as jcross_entropy
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import make_grad_fn as jmake_grad_fn
from repro_torch.configs.base import get_config
from repro_torch.data import synthetic as S
from repro_torch.data.pipeline import lm_stream, prefetch
from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist.sharding import ShardCtx
from repro_torch.examples import quickstart
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_specs
from repro_torch.models.params import init_params, params_from_numpy, tree_leaves
from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm, init_opt_state
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.losses import cross_entropy
from repro_torch.train.trainer import TrainConfig, Trainer, make_grad_fn

STEPS = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's steps here are many small ops: one intra-op thread keeps
    them off the other test workers' cores (and off their spin-waits)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-30)


# ---------------------------------------------------------------------------
# schedule, loss, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("peak,warm,total", [(1e-2, 2, 8), (3e-4, 5, 40), (3e-4, 30, 300)])
def test_warmup_cosine_matches_reference(peak, warm, total):
    for s in range(total + 3):
        want = np.float32(jwarmup_cosine(s, peak_lr=peak, warmup_steps=warm, total_steps=total))
        got = warmup_cosine(s, peak_lr=peak, warmup_steps=warm, total_steps=total)
        assert float(want) == got, (s, want, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(0)
    V, Vp = 50, 64
    logits = rng.standard_normal((3, 7, Vp)).astype(np.float32) * 3
    labels = rng.integers(0, V, (3, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[2, 5] = -1
    jl = jnp.asarray(logits).astype(dtype)
    want, wcount = jcross_entropy(jl, jnp.asarray(labels), V)
    got, count = cross_entropy(torch.from_numpy(np.array(jl.astype(jnp.float32))).to(
        getattr(torch, dtype)), torch.from_numpy(labels), V)
    assert int(count) == int(wcount) == 21 - 4
    assert _rel(float(want), float(got)) <= 1e-6


def _opt_tree(rng):
    return {
        "w": rng.standard_normal((6, 5)).astype(np.float32),
        "stack": rng.standard_normal((2, 4, 3)).astype(np.float32),
        "b": rng.standard_normal((5,)).astype(np.float32),
        "half": {"w": rng.standard_normal((4, 4)).astype(np.float32),
                 "scale": rng.standard_normal((4,)).astype(np.float32)},
    }


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(1)
    p0 = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    half = lambda t, cast: {**t, "half": {k: cast(v) for k, v in t["half"].items()}}  # noqa: E731
    cfg_kw = dict(clip_norm=clip, weight_decay=0.1)
    jp = half(jax.tree.map(jnp.asarray, p0), lambda v: v.astype(jnp.bfloat16))
    jopt = jinit_opt_state(jp)
    tp = half(params_from_numpy(p0, device="cpu"), lambda v: v.to(torch.bfloat16))
    topt = init_opt_state(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, jopt, jn = jax.jit(jadamw_update, static_argnums=4)(
            jax.tree.map(jnp.asarray, g), jopt, jp, lr, JAdamWConfig(**cfg_kw))
        tp, topt, tn = adamw_update(params_from_numpy(g, device="cpu"), topt, tp, lr,
                                    AdamWConfig(**cfg_kw))
        assert _rel(float(jn), float(tn)) <= 1e-6
    assert int(topt["step"]) == int(jopt["step"]) == 3
    assert topt["step"].dtype == torch.int32
    for name, want, got in (("params", jp, tp), ("m", jopt["m"], topt["m"]),
                            ("v", jopt["v"], topt["v"])):
        for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
            a = np.asarray(a.astype(jnp.float32))
            err = np.abs(b.float().numpy() - a).max()
            assert err <= 1e-6 * np.abs(a).max(), (name, err)
    # a bf16 leaf stays bf16; its moments are fp32, as the reference's
    assert tp["half"]["w"].dtype == torch.bfloat16
    assert topt["m"]["half"]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the LM stream
# ---------------------------------------------------------------------------

STREAM_CASES = {  # vocab: (rows, seq, (seed, step) pairs)
    512: (8, 64, ((0, 0), (5, 123))),
    2048: (4, 64, ((3, 5), (1000, 2))),
    32000: (2, 16, ((0, 0), (7, 40))),
}


@pytest.mark.parametrize("V", sorted(STREAM_CASES))
def test_lm_batch_matches_reference(V):
    B, L, draws = STREAM_CASES[V]
    n = B * (L + 1)
    logits = S.lm_logits(V, "cpu")
    j_logits = -1.1 * jnp.log(jnp.arange(1, V + 1, dtype=jnp.float32))
    equal = total = differing = 0
    for seed, step in draws:
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        jk1, jk2 = jax.random.split(jkey)
        k1, k2 = S.split(S.fold_in(S.prng_key(seed), step))
        assert (k1, k2) == (tuple(int(x) for x in np.asarray(jk1)),
                            tuple(int(x) for x in np.asarray(jk2)))
        bits = S.random_bits(k1, 0, n * V, "cpu").numpy().view(np.uint32)
        np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(jk1, (B, L + 1, V))).ravel())
        u = S.uniform_from_bits(S.random_bits(k2, 0, n, "cpu"))
        np.testing.assert_array_equal(u.numpy(), np.asarray(jax.random.uniform(jk2, (B, L + 1))).ravel())
        np.testing.assert_array_equal(
            (u < torch.tensor(0.3)).numpy(),
            np.asarray(jax.random.bernoulli(jk2, 0.3, (B, L + 1))).ravel())
        base = S.categorical(k1, logits, n).numpy()
        want_base = np.asarray(jax.random.categorical(jk1, j_logits, shape=(B, L + 1))).ravel()
        if (base != want_base).any():
            scores = np.asarray(jax.random.gumbel(jk1, (B, L + 1, V)) + j_logits).reshape(n, V)
        for i in np.flatnonzero(base != want_base):
            top2 = np.sort(scores[i])[-2:]
            assert top2[1] - top2[0] <= 4 * np.spacing(np.abs(top2).max()), (seed, step, i)
            differing += 1
        want = _np(jlm_batch(JLMStreamConfig(V, L, B, seed=seed), step))
        got = S.lm_batch(S.LMStreamConfig(V, L, B, seed=seed), step, device="cpu")
        assert got["tokens"].dtype == torch.int32 and got["tokens"].shape == (B, L)
        np.testing.assert_array_equal(got["labels"][:, :-1].numpy(), got["tokens"][:, 1:].numpy())
        equal += int((got["tokens"].numpy() == want["tokens"]).sum())
        total += want["tokens"].size
    print(f"vocab {V}: {differing} categorical draws differ; {total - equal} of {total} "
          "tokens differ")
    assert equal >= 0.9999 * total


def test_lm_stream_resumes_and_prefetch_keeps_order():
    head = lm_stream(512, 8, 4, seed=2, device="cpu")
    full = [next(head) for _ in range(5)]
    tail = lm_stream(512, 8, 4, seed=2, start_step=3, device="cpu")
    for want in full[3:]:
        got = next(tail)
        assert all(torch.equal(got[k], want[k]) for k in ("tokens", "labels"))
    assert not torch.equal(full[0]["tokens"], full[1]["tokens"])
    j = next(jlm_stream(512, 8, 4, seed=2, start_step=3))
    assert (np.asarray(j["tokens"]) == full[3]["tokens"].numpy()).mean() >= 0.9999
    assert list(prefetch(iter(range(20)), size=4)) == list(range(20))


def test_entry_points_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cpu"):
        S.lm_batch(S.LMStreamConfig(512, 8, 2), 0)
    with pytest.raises(RuntimeError, match="cpu"):
        next(lm_stream(512, 8, 2))
    with pytest.raises(RuntimeError, match="cpu"):
        quickstart.main()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ckpt_tree():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    h = rng.standard_normal((5,)).astype(np.float32)
    return {
        "a": w,
        "nested": {"b": np.arange(6, dtype=np.int32).reshape(2, 3), "c": np.float32(3.5),
                   "h": h},
        "z": np.int32(-7),
    }


def _port_tree(t):
    out = params_from_numpy(t, device="cpu")
    out["nested"]["h"] = out["nested"]["h"].to(torch.bfloat16)
    return out


def _jax_tree(t):
    out = jax.tree.map(jnp.asarray, t)
    out["nested"]["h"] = out["nested"]["h"].astype(jnp.bfloat16)
    return out


def _same(port, ref):
    for a, b in zip(tree_leaves(port), jax.tree.leaves(ref)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert a.contiguous().view(-1).view(torch.uint8).numpy().tobytes() == b.tobytes()


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = _port_tree(_ckpt_tree())
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 5, tree)
    ckpt.save_checkpoint(d, 10, tree, aux={"model_plan": {"x": [1, 2]}})
    assert ckpt.latest_step(d) == 10
    assert ckpt.load_aux(d, 10) == {"model_plan": {"x": [1, 2]}}
    assert ckpt.load_aux(d, 5) is None
    out = ckpt.restore_checkpoint(d, 10, tree)
    for a, b in zip(tree_leaves(out), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert out["nested"]["h"].dtype == torch.bfloat16 and out["z"].shape == ()
    # a partial write and a step directory without meta.json are ignored
    os.makedirs(os.path.join(d, ".tmp_crashed"))
    os.makedirs(os.path.join(d, "step_00000099"))
    assert ckpt.latest_step(d) == 10
    # replacing a step commits the new one
    ckpt.save_checkpoint(d, 10, tree, aux={"v": 2})
    assert ckpt.load_aux(d, 10) == {"v": 2}
    # keep_last GC: fewer committed steps than keep_last are all kept (the
    # reference's slice would delete the oldest)
    ckpt.save_checkpoint(d, 12, tree, keep_last=10)
    assert ckpt.latest_step(d) == 12 and ckpt.load_aux(d, 5) is None
    for s in (15, 20, 25):
        ckpt.save_checkpoint(d, s, tree, keep_last=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_") and
                   os.path.exists(os.path.join(d, x, "meta.json")))
    assert steps == ["step_00000020", "step_00000025"]
    assert [x for x in os.listdir(d) if x.startswith(".tmp")] == [".tmp_crashed"]
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(d, 25, {**tree, "a": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore_checkpoint(d, 25, {**tree, "a": tree["a"].double()})


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    t = _ckpt_tree()
    jt, pt = _jax_tree(t), _port_tree(t)
    d = str(tmp_path / "ck")
    if direction == "reference_to_port":
        jckpt.save_checkpoint(d, 3, jt, aux={"k": 1})
        got = ckpt.restore_checkpoint(d, ckpt.latest_step(d), pt)
        _same(got, jt)
        assert ckpt.load_aux(d, 3) == {"k": 1}
    else:
        ckpt.save_checkpoint(d, 3, pt, aux={"k": 1})
        like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jt)
        got = jckpt.restore_checkpoint(d, jckpt.latest_step(d), like)
        _same(pt, got)
        assert jckpt.load_aux(d, 3) == {"k": 1}
    with open(os.path.join(d, "step_00000003", "meta.json")) as f:
        meta = json.load(f)
    assert [r["dtype"] for r in meta["leaves"]] == [
        "float32", "int32", "float32", "bfloat16", "int32"]


# ---------------------------------------------------------------------------
# the trainer against the reference
# ---------------------------------------------------------------------------


def _granite():
    jcfg = jget_config("granite_8b", reduced=True)
    p0 = _np(jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(0)))
    batches = [_np(b) for b, _ in zip(jlm_stream(jcfg.vocab_size, 16, 4, seed=1), range(STEPS))]
    return jcfg, p0, batches


def _run_reference(jcfg, p0, batches, out, compute):
    tc = JTrainConfig(peak_lr=1e-2, warmup_steps=2, total_steps=STEPS, checkpoint_every=4,
                      out_dir=str(out), compute_dtype=compute)
    t = JTrainer(JCtx(jcfg, ex=JExecCfg(remat="none")), tc, jax.tree.map(jnp.asarray, p0),
                 iter([jax.tree.map(jnp.asarray, b) for b in batches]))
    return t.run(STEPS), t


def _port_trainer(p0, batches, out, compute, remat="none", steps=STEPS):
    cfg = get_config("granite_8b", reduced=True)
    tc = TrainConfig(peak_lr=1e-2, warmup_steps=2, total_steps=steps, checkpoint_every=4,
                     out_dir=str(out), compute_dtype=compute)
    return Trainer(Ctx(cfg, ex=ExecCfg(remat=remat)), tc, params_from_numpy(p0, device="cpu"),
                   iter([_t(b) for b in batches]))


@pytest.fixture(scope="module")
def granite_runs(tmp_path_factory):
    jcfg, p0, batches = _granite()
    runs = {}
    for name, jdt, tdt in (("fp32", jnp.float32, torch.float32),
                           ("bf16", jnp.bfloat16, torch.bfloat16)):
        jlog, jt = _run_reference(jcfg, p0, batches, tmp_path_factory.mktemp(f"j{name}"), jdt)
        t = _port_trainer(p0, batches, tmp_path_factory.mktemp(f"t{name}"), tdt)
        runs[name] = (jlog, t.run(STEPS), jt)
    return p0, batches, runs


@pytest.mark.parametrize("compute,tol", [("fp32", 1e-4), ("bf16", 1e-2)])
def test_trainer_matches_reference(granite_runs, compute, tol):
    jlog, tlog, _ = granite_runs[2][compute]
    assert [r["step"] for r in tlog] == list(range(1, STEPS + 1))
    for a, b in zip(jlog, tlog):
        assert _rel(a["loss"], b["loss"]) <= tol, (a, b)
        assert _rel(a["grad_norm"], b["grad_norm"]) <= tol, (a, b)
        assert _rel(a["lr"], b["lr"]) <= 1e-6
        assert b["time_s"] > 0


def test_port_resumes_from_reference_checkpoint(granite_runs, tmp_path):
    """The reference Trainer's step-8 checkpoint restores into a port
    Trainer, its parameters and optimizer state bit for bit."""
    p0, batches, runs = granite_runs
    jt = runs["fp32"][2]
    t = _port_trainer(p0, batches, jt.tc.out_dir, torch.float32)
    assert t.start_step == STEPS
    _same(t.params, jt.params)
    _same(t.opt_state, jt.opt_state)


def _one_step(arch, microbatches=1, seed=1):
    """One step's gradients of reduced ``arch`` in both packages from the
    same weights and batch (``make_grad_fn``, which the train step runs
    before AdamW); returns (reference, port) {loss, aux, grad_norm}."""
    jcfg = jget_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    p0 = jax.tree.map(lambda t: t.numpy(), init_params(  # the port's draw is quicker
        model_specs(cfg), torch.Generator().manual_seed(seed), device="cpu"))
    rng = np.random.default_rng(seed)
    B, L = 4, 12
    toks = rng.integers(0, jcfg.vocab_size, (B, L + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jcfg.family == "vlm":
        batch["embeds"] = (rng.standard_normal((B, jcfg.num_image_tokens, jcfg.d_model))
                           * 0.02).astype(np.float32)
    jtc = JTrainConfig(microbatches=microbatches, compute_dtype=jnp.float32)
    jgrad = jmake_grad_fn(JCtx(jcfg, ex=JExecCfg(remat="none")), jtc)

    def jstep(p, b):
        g, loss, aux, _ = jgrad(p, b, None)
        return loss, aux, jglobal_norm(g)

    want = jax.jit(jstep)(jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, batch))
    tc = TrainConfig(microbatches=microbatches, compute_dtype=torch.float32)
    ctx = Ctx(cfg, ex=ExecCfg(remat="full"))
    g, loss, aux = make_grad_fn(ctx, tc)(params_from_numpy(p0, device="cpu"), _t(batch))
    got = (loss, aux, global_norm(g))
    keys = ("loss", "aux", "grad_norm")
    return dict(zip(keys, map(float, want))), dict(zip(keys, map(float, got)))


@pytest.mark.parametrize("arch,microbatches", [
    ("granite_8b", 2), ("qwen2_moe_a2_7b", 1), ("llava_next_mistral_7b", 1)])
def test_one_step_matches_reference(arch, microbatches):
    want, got = _one_step(arch, microbatches)
    for k in ("loss", "grad_norm"):
        assert _rel(want[k], got[k]) <= 1e-4, (k, want, got)
    assert abs(want["aux"] - got["aux"]) <= 1e-4 * max(abs(want["aux"]), 1.0)
    if arch == "qwen2_moe_a2_7b":
        assert got["aux"] > 0


@pytest.mark.parametrize("remat", ["full", "dots", "dots_no_batch"])
def test_remat_gradients_equal_none(remat):
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(3), device="cpu")
    batch = S.lm_batch(S.LMStreamConfig(cfg.vocab_size, 12, 2, seed=4), 0, device="cpu")
    tc = TrainConfig(compute_dtype=torch.bfloat16)
    grads = {}
    for mode in ("none", remat):
        g, loss, aux = make_grad_fn(Ctx(cfg, ex=ExecCfg(remat=mode)), tc)(params, batch)
        grads[mode] = (tree_leaves(g), loss, aux)
    for a, b in zip(grads["none"][0], grads[remat][0]):
        assert torch.equal(a, b)
    assert torch.equal(grads["none"][1], grads[remat][1])
    with pytest.raises(ValueError, match="remat"):
        ExecCfg(remat="everything")


def test_pod_compression_is_not_ported():
    """Pod compression is ported (``tests/test_torch_dist_world.py``); what
    is not is a mesh whose model axis has more than one rank, which raises
    naming the ROADMAP's next slice.  Without a pod axis compression has
    nothing to compress across, as in the reference."""
    cfg = get_config("granite_8b", reduced=True)
    with pytest.raises(ValueError, match="pod"):
        make_grad_fn(Ctx(cfg), TrainConfig(compress_pod_grads=True))
    mesh = type("Mesh", (), {"mesh_dim_names": ("pod", "data", "model"),
                             "shape": (1, 1, 2)})()
    for compress in (False, True):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_grad_fn(Ctx(cfg, shard=ShardCtx(mesh)), TrainConfig(compress_pod_grads=compress))


# ---------------------------------------------------------------------------
# port-only twins of tests/test_trainer.py
# ---------------------------------------------------------------------------


def _tiny(tmp, steps):
    cfg = get_config("granite_8b", reduced=True)
    ctx = Ctx(cfg, ex=ExecCfg(remat="none"))
    tc = TrainConfig(peak_lr=1e-2, warmup_steps=2, total_steps=steps, checkpoint_every=4,
                     out_dir=str(tmp), compute_dtype=torch.float32)
    params = lambda: init_params(model_specs(cfg), torch.Generator().manual_seed(0),  # noqa: E731
                                 device="cpu")
    data = lambda start=0: lm_stream(cfg.vocab_size, 16, 4, seed=1, start_step=start,  # noqa: E731
                                     device="cpu")
    return ctx, tc, params, data


def test_loss_decreases(tmp_path):
    ctx, tc, params, data = _tiny(tmp_path, 30)
    log = Trainer(ctx, tc, params(), data()).run(30)
    first = np.mean([r["loss"] for r in log[:5]])
    last = np.mean([r["loss"] for r in log[-5:]])
    assert last < first - 0.1, (first, last)
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == list(range(1, 31))
    assert set(recs[0]) == {"step", "time_s", "loss", "aux", "grad_norm", "lr"}


def test_restart_resumes_bit_for_bit(tmp_path):
    """8 steps straight equal 4 steps, then a fresh Trainer restored at 4
    finishing, bit for bit (losses and parameters)."""
    ctx, tc, params, data = _tiny(tmp_path / "a", STEPS)
    straight = Trainer(ctx, tc, params(), data())
    log_a = straight.run(STEPS)
    assert ckpt.latest_step(os.path.join(tc.out_dir, "checkpoints")) == STEPS
    ctx, tc, params, data = _tiny(tmp_path / "b", STEPS)
    first = Trainer(ctx, tc, params(), data())
    log_b = first.run(4)
    second = Trainer(ctx, tc, params(), data(4))
    assert second.start_step == 4
    log_b = log_b + second.run(STEPS)
    assert [r["loss"] for r in log_a] == [r["loss"] for r in log_b]
    for a, b in zip(tree_leaves(straight.params), tree_leaves(second.params)):
        assert torch.equal(a, b)
    again = Trainer(ctx, tc, params(), data(STEPS))
    assert again.start_step == STEPS
    for a, b in zip(tree_leaves(again.params), tree_leaves(second.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fault", ["exception", "nan"])
def test_failure_restores_and_replays(tmp_path, fault):
    ctx, tc, params, data = _tiny(tmp_path, STEPS)
    t = Trainer(ctx, tc, params(), data())
    real_step = t.step_fn
    calls = {"n": 0}

    def flaky(p, o, b):
        calls["n"] += 1
        if calls["n"] == 6:
            if fault == "exception":
                raise RuntimeError("injected node failure")
            p, o, m = real_step(p, o, b)
            return p, o, {**m, "loss": torch.tensor(math.nan)}
        return real_step(p, o, b)

    t.step_fn = flaky
    log = t.run(STEPS)
    assert log[-1]["step"] == STEPS
    # step 6 failed after the step-4 checkpoint: steps 5 and 6 replayed
    assert [r["step"] for r in log] == [1, 2, 3, 4, 5, 5, 6, 7, 8]
    assert calls["n"] == 10


def test_too_many_failures_raise(tmp_path):
    ctx, tc, params, data = _tiny(tmp_path, STEPS)
    t = Trainer(ctx, tc, params(), data())

    def broken(p, o, b):
        raise RuntimeError("always")

    t.step_fn = broken
    with pytest.raises(RuntimeError, match="always"):
        t.run(STEPS, max_failures=2)


def test_preemption_checkpoints_and_exits(tmp_path):
    ctx, tc, params, data = _tiny(tmp_path, 100)
    t = Trainer(ctx, tc, params(), data())
    orig = t.step_fn

    def step_then_preempt(p, o, b):
        out = orig(p, o, b)
        t.request_preemption()
        return out

    t.step_fn = step_then_preempt
    log = t.run(100)
    assert len(log) == 1
    assert ckpt.latest_step(os.path.join(str(tmp_path), "checkpoints")) == 1


def test_quickstart_serves_standard_equal_lut(tmp_path):
    rows = quickstart.main(device="cpu", out=str(tmp_path / "qs"))
    assert rows["log"][-1]["step"] == 24
    assert rows["log"][-1]["loss"] < rows["log"][0]["loss"]
    assert rows["plan"].total_lut_bytes <= rows["uniform"].total_lut_bytes // 2
    assert rows["standard"] == rows["lut"]
    assert len(rows["standard"]) == 2 and len(rows["standard"][0]) == 8
