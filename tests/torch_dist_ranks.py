"""The ranks of the 4-rank gloo world that ``test_torch_dist_world.py``
spawns (pod 2 x data 2, one torch thread a rank).  Each rank runs every
case and writes its results as numpy files (and JSON) into the output
directory; the tests compare them in the pytest process.  Nothing here
imports JAX: the shared inputs are made from seeds with numpy and torch.

Rank ``r`` sits at mesh coordinate ``(pod, data) = (r // 2, r % 2)`` and
holds rows ``[2r, 2r + 2)`` of each 8-row global batch.
"""
from __future__ import annotations

import datetime
import json
import os
import signal

import numpy as np
import torch

WORLD = 4
MESH = ((2, 2), ("pod", "data"))
GLOBAL_B, SEQ = 8, 12
STEPS = 4
SEED = 3
MOE_AUX_COEF = 1.0  # large enough that the aux term moves the router's gradient
PREEMPTED_RANK = 1  # signals itself while it fetches the first batch


def compression_tree(pods: int, seed: int = 7) -> dict:
    """fp32 gradient stacks (one row per pod) with a leaf of zeros and a
    leaf on .5 code ties, and residual stacks (non-zero but on those two)."""
    rng = np.random.default_rng(seed)
    g = {
        "w": rng.standard_normal((pods, 6, 5)).astype(np.float32),
        "b": (rng.standard_normal((pods, 7)) * 1e-3).astype(np.float32),
        "zeros": np.zeros((pods, 4), np.float32),
        "ties": np.tile(np.array([127.0, 2.5, -3.5, 0.5, 1.5, -0.5], np.float32), (pods, 1)),
    }
    e = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32) for k, v in g.items()}
    e["zeros"] = np.zeros_like(g["zeros"])
    e["ties"] = np.zeros_like(g["ties"])
    return {"g": g, "e": e}


def global_batch(step: int, vocab: int, masked: bool = False) -> dict:
    """One global LM batch of ``GLOBAL_B`` rows.  ``masked``: each rank's
    two rows lose ``3 r`` labels, so the ranks' valid counts differ."""
    rng = np.random.default_rng(1000 + step)
    toks = rng.integers(0, vocab, (GLOBAL_B, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}
    if masked:
        for r in range(WORLD):
            batch["labels"][2 * r, : 3 * r] = -1
            batch["labels"][2 * r + 1, SEQ - (3 * r) // 2:] = -1
    return batch


def model():
    """Reduced granite_8b (2 layers) and its weights as numpy, drawn from
    ``SEED`` by the port's ``init_params``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params, tree_map

    cfg = get_config("granite_8b", reduced=True)
    p0 = init_params(model_specs(cfg), torch.Generator().manual_seed(SEED), device="cpu")
    return cfg, tree_map(lambda t: t.numpy(), p0)


def moe_model():
    """Reduced mixtral_8x7b (2 layers, 4 experts, top 2) and its weights as
    numpy, drawn from ``SEED`` by the port's ``init_params``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params, tree_map

    cfg = get_config("mixtral_8x7b", reduced=True)
    p0 = init_params(model_specs(cfg), torch.Generator().manual_seed(SEED), device="cpu")
    return cfg, tree_map(lambda t: t.numpy(), p0)


def train_config(out_dir: str, compress: bool = False, **kw):
    from repro_torch.train.trainer import TrainConfig

    return TrainConfig(peak_lr=1e-2, warmup_steps=2, total_steps=STEPS, checkpoint_every=2,
                       out_dir=out_dir, compute_dtype=torch.float32,
                       compress_pod_grads=compress, **kw)


def _leaves(tree) -> dict:
    from repro_torch.models.params import tree_flatten

    leaves, _ = tree_flatten(tree)
    return {f"leaf_{i}": t.detach().to(torch.float32).numpy() for i, t in enumerate(leaves)}


def run_rank(rank: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.audit.walker import record
    from repro_torch.dist.compression import collective_stats, compressed_all_reduce
    from repro_torch.dist.sharding import ShardCtx
    from repro_torch.data.pipeline import host_slice
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.trainer import Trainer, init_train_state, make_grad_fn

    init_world(rank, WORLD, device="cpu", init_method=store,
               timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(*MESH, device="cpu")
    sh = ShardCtx(mesh)
    pod = int(mesh.get_coordinate()[0])

    def save(name: str, **arrays):
        np.savez(os.path.join(out, f"{name}_r{rank}.npz"), **arrays)

    def save_json(name: str, obj):
        with open(os.path.join(out, f"{name}_r{rank}.json"), "w") as f:
            json.dump(obj, f)

    # -- the mesh's queries on a DeviceMesh ------------------------------------
    save_json("mesh", {
        "coordinate": [int(c) for c in mesh.get_coordinate()],
        "batch_index": list(sh.batch_index(GLOBAL_B)),
        "host_slice": list(host_slice(GLOBAL_B)),
        "local_rows": sh.local_batch(torch.arange(GLOBAL_B)).tolist(),
        "spec_batch_embed": [p if not isinstance(p, tuple) else list(p)
                             for p in sh.spec(("batch", "embed"), (GLOBAL_B, 64))],
        "axis_size": [sh.axis_size("pod"), sh.axis_size("data"), sh.axis_size("pod", "data")],
        "data_axes": list(sh.data_axes),
    })

    # -- compressed_all_reduce over the pod group --------------------------------
    tree = compression_tree(MESH[0][0])
    for dtype in (torch.float32, torch.bfloat16):
        g = {k: torch.from_numpy(v[pod].copy()).to(dtype) for k, v in tree["g"].items()}
        e = {k: torch.from_numpy(v[pod].copy()) for k, v in tree["e"].items()}
        for step in range(2):  # the second feeds the residual back
            mean, e = compressed_all_reduce(g, e, mesh.get_group("pod"))
            name = str(dtype).split(".")[-1]
            save(f"car_{name}_{step}",
                 **{f"mean_{k}": v.view(torch.int16 if v.element_size() == 2 else torch.int32)
                    .numpy() for k, v in mean.items()},
                 **{f"err_{k}": v.numpy() for k, v in e.items()})

    cfg, p0 = model()
    ctx = Ctx(cfg, ex=ExecCfg(remat="none"), shard=sh)

    def local(batch: dict) -> dict:
        return {k: sh.local_batch(torch.from_numpy(v)) for k, v in batch.items()}

    # -- data-parallel gradients and one Trainer step -------------------------------
    for masked in (False, True):
        tag = "masked" if masked else "plain"
        batch = local(global_batch(0, cfg.vocab_size, masked))
        tc = train_config(os.path.join(out, f"dp_{tag}"))
        grads, loss, aux = make_grad_fn(ctx, tc)(params_from_numpy(p0, device="cpu"), batch)
        save(f"dp_grads_{tag}", loss=loss.numpy(), aux=aux.numpy(), **_leaves(grads))
        t = Trainer(ctx, tc, params_from_numpy(p0, device="cpu"), iter([batch]))
        log = t.run(1)
        save(f"dp_step_{tag}", loss=np.float64(log[0]["loss"]),
             grad_norm=np.float64(log[0]["grad_norm"]), **_leaves(t.params))

    # -- the compressed step, its collectives recorded -------------------------------
    tc = train_config(os.path.join(out, "pod_grads"), compress=True)
    params = params_from_numpy(p0, device="cpu")
    opt = init_train_state(ctx, tc, params)
    batch = local(global_batch(0, cfg.vocab_size))
    (grads, loss, aux), ops = record(make_grad_fn(ctx, tc), params, batch, opt["err"])
    save("pod_grads", loss=loss.numpy(), aux=aux.numpy(), **_leaves(grads),
         **{f"err_{k}": v for k, v in _leaves(opt["err"]).items()})
    leaves = [dict(op.kwargs, name=op.name, shape=list(op.kwargs["shape"]))
              for op in ops if "collective" in op.kwargs]
    save_json("pod_collectives", {
        "leaves": leaves,
        "c10d_ops": sorted({op.name for op in ops if "allreduce" in op.name
                            or "allgather" in op.name}),
        "stats": collective_stats(ops).to_dict(),
    })

    # -- checkpoint / restart on the mesh ---------------------------------------------
    batches = [local(global_batch(s, cfg.vocab_size)) for s in range(STEPS)]
    straight = Trainer(ctx, train_config(os.path.join(out, "ckpt_a"), compress=True),
                       params_from_numpy(p0, device="cpu"), iter(batches))
    straight.run(STEPS)
    first = Trainer(ctx, train_config(os.path.join(out, "ckpt_b"), compress=True),
                    params_from_numpy(p0, device="cpu"), iter(batches))
    first.run(2)
    again = Trainer(ctx, train_config(os.path.join(out, "ckpt_b"), compress=True),
                    params_from_numpy(p0, device="cpu"), iter(batches[2:]))
    resumed_at = again.start_step
    again.run(STEPS)
    save("ckpt", resumed_at=np.int64(resumed_at),
         **{f"a_{k}": v for k, v in _leaves({"p": straight.params,
                                             "o": straight.opt_state}).items()},
         **{f"b_{k}": v for k, v in _leaves({"p": again.params, "o": again.opt_state}).items()})

    # -- MoE: each rank's aux over its own tokens, averaged -----------------------------
    mcfg, mp0 = moe_model()
    mctx = Ctx(mcfg, ex=ExecCfg(remat="none"), shard=sh)
    tc = train_config(os.path.join(out, "moe"), aux_coef=MOE_AUX_COEF)
    grads, loss, aux = make_grad_fn(mctx, tc)(params_from_numpy(mp0, device="cpu"),
                                              local(global_batch(0, mcfg.vocab_size)))
    save("moe_grads", loss=loss.numpy(), aux=aux.numpy(), **_leaves(grads))

    # -- preemption on one rank: every rank saves and stops at the same step ---------
    def signalled(batches):
        for i, b in enumerate(batches):
            if rank == PREEMPTED_RANK and i == 0:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b

    tc = train_config(os.path.join(out, "preempt"), compress=True)
    log = Trainer(ctx, tc, params_from_numpy(p0, device="cpu"), signalled(batches)).run(STEPS)
    resumed = Trainer(ctx, tc, params_from_numpy(p0, device="cpu"), iter(())).start_step
    save_json("preempt", {
        "steps": len(log),
        "checkpoints": sorted(os.listdir(os.path.join(tc.out_dir, "checkpoints"))),
        "resumed_at": resumed,
    })

    # -- a failed step on a mesh raises rather than restore one rank alone --------------
    no_labels = {k: v for k, v in batches[0].items() if k != "labels"}
    t = Trainer(ctx, train_config(os.path.join(out, "fail")),
                params_from_numpy(p0, device="cpu"), iter([no_labels, batches[0]]))
    try:
        t.run(1)
        raised = None
    except KeyError as err:
        raised = repr(err)
    save_json("fail", {"raised": raised, "steps": len(t.metrics_log)})

    # -- a model axis raises -------------------------------------------------------------
    tp_mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    try:
        make_grad_fn(Ctx(cfg, shard=ShardCtx(tp_mesh)), train_config(out))
        raised = None
    except NotImplementedError as err:
        raised = str(err)
    save_json("tp", {"raised": raised})
    torch.distributed.destroy_process_group()
