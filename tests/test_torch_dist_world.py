"""Data-parallel and pod-compressed training of the port across a 4-rank
gloo world on the CPU, against the one-process port and the JAX package.

One module fixture spawns the world (``torch.multiprocessing``, a
``file://`` store, pod 2 x data 2, one torch thread a rank); the ranks
(``tests/torch_dist_ranks.py``) run every case and write their results,
which the tests below compare here:

* ``compressed_all_reduce`` over the pod group equals the reference's
  ``compressed_psum`` under ``jax.vmap(axis_name="pod")`` bit for bit;
* the mesh's gradients of reduced granite_8b (2 layers, fp32 compute), and
  one Trainer step, equal the one-process port's on the global batch and
  the reference's ``make_grad_fn``, to the stated tolerance (the
  all-reduce sums in another fp32 order), also with masked labels whose
  counts differ per rank (the weighting by valid labels);
* the compressed gradients equal a reference composed of the reference's
  functions (``make_grad_fn`` per pod, the vmapped ``compressed_psum``)
  within one quantization step, the share of elements a step apart
  bounded; AdamW on them is the reference's ``adamw_update``;
* a checkpoint at step 2 restored by the world replays bit for bit, its
  ``err`` leaf the reference's ``(n_pods, ...)`` shape;
* the collectives of a step, recorded by the audit's walker as opaque
  leaves, and their ``collective_stats``;
* reduced mixtral_8x7b's gradients on the mesh equal a reference
  composed of the reference's loss per rank (each rank's router aux over
  its own tokens, averaged, as the reference's mesh step's ``shard_map``
  computes it), to the stated tolerance;
* SIGTERM on one rank stops every rank after the same step, with one
  checkpoint there; any other failure of a step raises on every rank
  rather than restore one rank alone;
* a ``model`` axis of 2 raises ``NotImplementedError``.

The multi-rank stream is the reference's contract (each host seeds its
own slice), so the ranks are handed their slices of one global batch.
"""
from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_ranks as R
from repro.configs.base import get_config as jget_config
from repro.dist.compression import compressed_psum
from repro.dist.sharding import ShardCtx as JShardCtx
from repro.launch import hlo_analysis as H
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_update as jadamw_update
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_loss_fn as jmake_loss_fn
from repro.train.trainer import make_grad_fn as jmake_grad_fn
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.params import params_from_numpy, tree_flatten
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train.trainer import Trainer, make_grad_fn

WORLD_SECONDS = 240  # the world's deadline; it takes ~10-20 s


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the 4 ranks once; returns their output directory."""
    out = tmp_path_factory.mktemp("world")
    store = "file://" + str(out / "store")
    procs = mp.start_processes(R.run_rank, args=(store, str(out)), nprocs=R.WORLD,
                               join=False, start_method="spawn")
    deadline = time.monotonic() + WORLD_SECONDS
    try:
        while not procs.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {R.WORLD}-rank world ran past {WORLD_SECONDS} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    return out


def _npz(out, name, rank):
    with np.load(out / f"{name}_r{rank}.npz") as z:
        return {k: z[k] for k in z.files}


def _json(out, name, rank):
    with open(out / f"{name}_r{rank}.json") as f:
        return json.load(f)


def _coord(rank):
    return rank // 2, rank % 2


# -- the mesh ----------------------------------------------------------------------


def test_device_mesh_queries_match_reference(world):
    from jax.sharding import AbstractMesh

    theirs = JShardCtx(AbstractMesh(*R.MESH))
    for r in range(R.WORLD):
        got = _json(world, "mesh", r)
        pod, data = _coord(r)
        assert got["coordinate"] == [pod, data]
        assert got["batch_index"] == [r, R.WORLD]
        hb = R.GLOBAL_B // R.WORLD
        assert got["host_slice"] == [hb, r * hb]
        assert got["local_rows"] == list(range(r * hb, (r + 1) * hb))
        want = [list(p) if isinstance(p, tuple) else p
                for p in theirs.spec(("batch", "embed"), (R.GLOBAL_B, 64))]
        assert got["spec_batch_embed"] == want
        assert got["axis_size"] == [theirs.axis_size("pod"), theirs.axis_size("data"),
                                    theirs.axis_size("pod", "data")]
        assert got["data_axes"] == list(theirs.data_axes)


# -- compressed_all_reduce ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_all_reduce_matches_reference_bit_for_bit(world, dtype):
    tree = R.compression_tree(2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    g = {k: jnp.asarray(v).astype(jdt) for k, v in tree["g"].items()}
    e = {k: jnp.asarray(v) for k, v in tree["e"].items()}
    fn = jax.vmap(lambda g, e: compressed_psum(g, e, "pod"), axis_name="pod")
    for step in range(2):
        mean, e = fn(g, e)
        for r in range(R.WORLD):
            pod, _ = _coord(r)
            got = _npz(world, f"car_{dtype}_{step}", r)
            for k in tree["g"]:
                want_bits = np.asarray(mean[k][pod]).view(
                    np.int16 if dtype == "bfloat16" else np.int32)
                np.testing.assert_array_equal(got[f"mean_{k}"], want_bits, (step, r, k))
                np.testing.assert_array_equal(got[f"err_{k}"], np.asarray(e[k][pod]),
                                              (step, r, k))


# -- data parallelism --------------------------------------------------------------


def _one_process(masked: bool, tmp_path):
    """The port's one-process gradients and Trainer step on the global batch."""
    cfg, p0 = R.model()
    batch = {k: torch.from_numpy(v) for k, v in R.global_batch(0, cfg.vocab_size, masked).items()}
    ctx = Ctx(cfg, ex=ExecCfg(remat="none"))
    tc = R.train_config(str(tmp_path / "one"))
    grads, loss, aux = make_grad_fn(ctx, tc)(params_from_numpy(p0, device="cpu"), batch)
    t = Trainer(ctx, tc, params_from_numpy(p0, device="cpu"), iter([batch]))
    log = t.run(1)
    return grads, float(loss), t.params, log[0]


_JGRAD = []  # the reference's jitted gradient function, made once


def _reference_grads(batch: dict):
    """The reference's fp32 gradients and loss of reduced granite_8b on
    ``batch`` (one device, no mesh)."""
    _, p0 = R.model()
    if not _JGRAD:
        jcfg = jget_config("granite_8b", reduced=True)
        jgrad = jmake_grad_fn(JCtx(jcfg, ex=JExecCfg(remat="none")),
                              JTrainConfig(compute_dtype=jnp.float32))
        _JGRAD.append(jax.jit(lambda p, b: jgrad(p, b, None)[:2]))
    g, loss = _JGRAD[0](jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, batch))
    return g, float(loss)


def _close(got: np.ndarray, want: np.ndarray, rel: float, what):
    """Each element within ``rel`` x the leaf's max |want| (fp32 sums in
    another order)."""
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, what


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked_labels"])
def test_data_parallel_step_matches_one_process_and_reference(world, masked, tmp_path):
    tag = "masked" if masked else "plain"
    grads, loss, params, rec = _one_process(masked, tmp_path)
    g_leaves = [g.numpy() for g in tree_flatten(grads)[0]]
    p_leaves = [p.numpy() for p in tree_flatten(params)[0]]
    cfg, _ = R.model()
    jg, jloss = _reference_grads(R.global_batch(0, cfg.vocab_size, masked))
    jg_leaves = [np.asarray(a) for a in jax.tree.leaves(jg)]
    ranks = [_npz(world, f"dp_grads_{tag}", r) for r in range(R.WORLD)]
    steps = [_npz(world, f"dp_step_{tag}", r) for r in range(R.WORLD)]
    for r in range(R.WORLD):  # the ranks agree bit for bit
        for k in ranks[0]:
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k], (r, k))
        for k in steps[0]:
            np.testing.assert_array_equal(steps[r][k], steps[0][k], (r, k))
    got = ranks[0]
    assert abs(float(got["loss"]) - loss) <= 1e-6 * abs(loss)
    assert abs(float(got["loss"]) - jloss) <= 1e-5 * abs(jloss)
    for i, (one, ref) in enumerate(zip(g_leaves, jg_leaves)):
        _close(got[f"leaf_{i}"], one, 1e-5, ("one process", i))
        _close(got[f"leaf_{i}"], ref, 1e-4, ("reference", i))
    step = steps[0]
    assert abs(float(step["loss"]) - rec["loss"]) <= 1e-6 * abs(rec["loss"])
    assert abs(float(step["grad_norm"]) - rec["grad_norm"]) <= 1e-5 * rec["grad_norm"]
    # AdamW's first step moves each weight by ~lr (1e-2): the updated
    # weights within 1e-5 (1e-3 of that) of the one-process step's
    for i, one in enumerate(p_leaves):
        assert float(np.abs(step[f"leaf_{i}"] - one).max()) <= 1e-5, i


def test_masked_labels_weight_the_ranks_by_their_counts(world):
    """An unweighted mean of the ranks' losses (1/n each) is not the global
    mean when the counts differ: the ranks' loss is the weighted one."""
    cfg, p0 = R.model()
    batch = R.global_batch(0, cfg.vocab_size, masked=True)
    counts = [int((batch["labels"][2 * r:2 * r + 2] >= 0).sum()) for r in range(R.WORLD)]
    assert len(set(counts)) == R.WORLD
    ctx = Ctx(cfg, ex=ExecCfg(remat="none"))
    tc = R.train_config("unused")
    losses = []
    for r in range(R.WORLD):
        part = {k: torch.from_numpy(v[2 * r:2 * r + 2]) for k, v in batch.items()}
        losses.append(float(make_grad_fn(ctx, tc)(params_from_numpy(p0, device="cpu"),
                                                  part)[1]))
    weighted = sum(c * l for c, l in zip(counts, losses)) / sum(counts)
    got = float(_npz(world, "dp_grads_masked", 0)["loss"])
    assert abs(got - weighted) <= 1e-6 * weighted
    assert abs(got - np.mean(losses)) > 1e-4 * weighted


# -- the compressed step -----------------------------------------------------------------


def test_compressed_step_matches_composed_reference(world):
    """Per pod the reference's gradients of the pod's batch, then the
    vmapped ``compressed_psum`` (zero residuals): the ranks' gradients lie
    within one quantization step of its means (their inputs differ by fp32
    summation order only, which can move a code across a rounding edge),
    at most 1 % of the elements a step apart; AdamW on them is the
    reference's."""
    cfg, p0 = R.model()
    batch = R.global_batch(0, cfg.vocab_size)
    pods = [{k: v[4 * p:4 * p + 4] for k, v in batch.items()} for p in range(2)]
    per_pod = [_reference_grads(b) for b in pods]
    stack = jax.tree.map(lambda *a: jnp.stack(a), *[g for g, _ in per_pod])
    zeros = jax.tree.map(jnp.zeros_like, stack)
    # jitted (it runs so in the reference's step): compared within a step
    mean, new_err = jax.jit(jax.vmap(lambda g, e: compressed_psum(g, e, "pod"),
                                     axis_name="pod"))(stack, zeros)
    mean_leaves = [np.asarray(a[0]) for a in jax.tree.leaves(mean)]
    err_leaves = [np.asarray(a) for a in jax.tree.leaves(new_err)]
    c_leaves = [np.asarray(a) for a in jax.tree.leaves(stack)]
    ranks = [_npz(world, "pod_grads", r) for r in range(R.WORLD)]
    for r in range(R.WORLD):
        for k in ranks[0]:
            if not k.startswith("err_"):  # every rank holds the same mean
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k], (r, k))
    got = ranks[0]
    off, total = 0, 0
    for i, (want, c) in enumerate(zip(mean_leaves, c_leaves)):
        step = max(float(np.abs(c).max()), np.finfo(np.float32).tiny) / 127
        diff = np.abs(got[f"leaf_{i}"] - want)
        assert float(diff.max()) <= step * (1 + 1e-3), i
        off += int((diff > 1e-3 * step).sum())
        total += diff.size
    print(f"compressed: {off} of {total} elements a step apart")
    assert off <= 0.01 * total, (off, total)
    # each rank's residual row is its pod's, within a step of the reference's
    for r in range(R.WORLD):
        pod, _ = _coord(r)
        for i, want in enumerate(err_leaves):
            row = _npz(world, "pod_grads", r)[f"err_leaf_{i}"]
            assert row.shape == want.shape  # (n_pods, ...) as the reference's
            step = max(float(np.abs(c_leaves[i]).max()), np.finfo(np.float32).tiny) / 127
            assert float(np.abs(row[pod] - want[pod]).max()) <= step * (1 + 1e-3), (r, i)
    assert abs(float(got["loss"]) - np.mean([l for _, l in per_pod])) <= 1e-5
    # AdamW on the ranks' gradients: the reference's adamw_update
    jp = jax.tree.map(jnp.asarray, p0)
    treedef = jax.tree.structure(jp)
    jgrads = jax.tree.unflatten(treedef, [jnp.asarray(got[f"leaf_{i}"])
                                          for i in range(len(mean_leaves))])
    new_p, _, _ = jax.jit(jadamw_update, static_argnums=4)(
        jgrads, jinit_opt_state(jp), jp, 5e-3, JAdamWConfig())
    tp = params_from_numpy(p0, device="cpu")
    tgrads = tree_flatten(tp)[1]([torch.from_numpy(got[f"leaf_{i}"])
                                  for i in range(len(mean_leaves))])
    adamw_update(tgrads, init_opt_state(tp), tp, 5e-3, AdamWConfig())
    for a, b in zip(jax.tree.leaves(new_p), tree_flatten(tp)[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def test_restart_on_the_mesh_replays_bit_for_bit(world):
    """Parameters, moments and each rank's own ``err`` row (a rank keeps
    its pod's row; the others are filled only by a restore)."""
    cfg, p0 = R.model()
    shapes = [list(a.shape) for a in tree_flatten(p0)[0]]
    for r in range(R.WORLD):
        pod, _ = _coord(r)
        got = _npz(world, "ckpt", r)
        assert int(got["resumed_at"]) == 2
        a = {k[2:]: v for k, v in got.items() if k.startswith("a_")}
        b = {k[2:]: v for k, v in got.items() if k.startswith("b_")}
        assert a.keys() == b.keys() and a
        for k in a:  # flatten order: opt {err, m, step, v}, then params
            if int(k.split("_")[-1]) < len(shapes):
                np.testing.assert_array_equal(a[k][pod], b[k][pod], (r, k))
            else:
                np.testing.assert_array_equal(a[k], b[k], (r, k))
    # the checkpoint's err leaves: the reference's (n_pods, ...) shape
    step_dir = world / "ckpt_b" / "checkpoints" / "step_00000002"
    meta = json.loads((step_dir / "meta.json").read_text())
    leaves = meta["leaves"]
    # flatten order: opt {err, m, step, v}, then params
    assert [rec["shape"] for rec in leaves[:len(shapes)]] == [[2] + s for s in shapes]
    assert all(rec["dtype"] == "float32" for rec in leaves[:len(shapes)])


# -- the collectives of a step ----------------------------------------------------


def test_step_collectives_are_recorded_as_opaque_leaves(world):
    cfg, p0 = R.model()
    n_params = sum(int(np.prod(a.shape)) for a in tree_flatten(p0)[0])
    n_leaves = len(tree_flatten(p0)[0])
    for r in range(R.WORLD):
        rec = _json(world, "pod_collectives", r)
        assert rec["c10d_ops"] == []  # each collective is its one leaf
        got = [(x["collective"], x["reduce"], x["dtype"], x["shape"], x["bytes"],
                x["group_size"]) for x in rec["leaves"]]
        assert got == [
            ("all-reduce", "sum", "torch.int64", [1], 8, 2),  # valid labels, data
            ("all-reduce", "sum", "torch.float32", [2], 8, 2),  # loss, aux
            ("all-reduce", "sum", "torch.float32", [n_params], 4 * n_params, 2),  # grads
            ("all-reduce", "max", "torch.float32", [n_leaves], 4 * n_leaves, 2),  # pod absmax
            ("all-reduce", "sum", "torch.int32", [n_params], 4 * n_params, 2),  # int8 codes
            ("all-reduce", "sum", "torch.float32", [2], 8, 2),  # pod mean loss, aux
        ]
        hlo = {"torch.int64": "s64", "torch.float32": "f32", "torch.int32": "s32"}
        lines = "\n".join(
            f"%c.{i} = {hlo[x['dtype']]}[{','.join(map(str, x['shape']))}]{{0}} "
            f"all-reduce(%x.{i}), replica_groups=[2,2]<=[4]"
            for i, x in enumerate(rec["leaves"]))
        want = H.collective_stats(lines).to_dict()
        assert rec["stats"]["by_op"].keys() == want["by_op"].keys()
        for op, w in want["by_op"].items():
            g = rec["stats"]["by_op"][op]
            assert (g["count"], g["result_bytes"]) == (w["count"], w["result_bytes"])
            assert g["link_bytes"] == pytest.approx(w["link_bytes"], rel=1e-12)
        assert rec["stats"]["link_bytes"] == pytest.approx(want["link_bytes"], rel=1e-12)


def test_moe_step_averages_each_ranks_aux_as_the_reference_mesh_step(world):
    """The reference's MoE layer runs under ``shard_map`` over the batch
    axes on a mesh and averages the shards' router aux; composed here from
    the reference's loss per rank: the gradient of ``share_r * loss_r +
    aux_coef / n * aux_r`` summed over the ranks (``share_r``: the rank's
    share of the valid labels).  The ranks' gradients within 1e-4 of each
    leaf's largest |element| (fp32 sums in another order), loss and aux
    within 1e-5; the mean of the ranks' aux is not the aux of the whole
    batch (a product of means), which a one-device step would take."""
    cfg, p0 = R.moe_model()
    batch = R.global_batch(0, cfg.vocab_size)
    jcfg = jget_config("mixtral_8x7b", reduced=True)
    jloss = jmake_loss_fn(JCtx(jcfg, ex=JExecCfg(remat="none")),
                          JTrainConfig(compute_dtype=jnp.float32))

    def objective(p, b, share, w_aux):
        _, (loss, aux) = jloss(p, b)
        return share * loss + w_aux * aux, (loss, aux)

    grad = jax.jit(jax.value_and_grad(objective, has_aux=True))
    jp = jax.tree.map(jnp.asarray, p0)
    parts = [{k: jnp.asarray(v[2 * r:2 * r + 2]) for k, v in batch.items()}
             for r in range(R.WORLD)]
    counts = [int((p["labels"] >= 0).sum()) for p in parts]
    want, loss, auxs = None, 0.0, []
    for part, count in zip(parts, counts):
        (_, (l_r, a_r)), g = grad(jp, part, count / sum(counts), R.MOE_AUX_COEF / R.WORLD)
        want = g if want is None else jax.tree.map(jnp.add, want, g)
        loss += count / sum(counts) * float(l_r)
        auxs.append(float(a_r))
    ranks = [_npz(world, "moe_grads", r) for r in range(R.WORLD)]
    for r in range(R.WORLD):
        for k in ranks[0]:
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k], (r, k))
    got = ranks[0]
    assert abs(float(got["loss"]) - loss) <= 1e-5 * abs(loss)
    assert abs(float(got["aux"]) - np.mean(auxs)) <= 1e-5 * abs(np.mean(auxs))
    for i, ref in enumerate(jax.tree.leaves(want)):
        _close(got[f"leaf_{i}"], np.asarray(ref), 1e-4, i)
    _, (_, whole) = jax.jit(jloss)(jp, jax.tree.map(jnp.asarray, batch))
    assert abs(float(whole) - np.mean(auxs)) > 1e-3 * abs(float(whole))


def test_preemption_on_one_rank_stops_every_rank_at_the_same_step(world):
    for r in range(R.WORLD):
        got = _json(world, "preempt", r)
        assert got == {"steps": 1, "checkpoints": ["step_00000001"], "resumed_at": 1}, r


def test_a_failed_step_on_the_mesh_raises_on_every_rank(world):
    for r in range(R.WORLD):
        got = _json(world, "fail", r)
        assert got["raised"] is not None and "labels" in got["raised"], r
        assert got["steps"] == 0, r


def test_model_axis_raises(world):
    for r in range(R.WORLD):
        raised = _json(world, "tp", r)["raised"]
        assert raised is not None and "ROADMAP" in raised and "tensor parallelism" in raised
