"""Fault-tolerant training loop (counterpart of ``repro/train/trainer.py``).

* checkpoint / restart: atomic checkpoints every ``checkpoint_every`` steps
  (``dist.checkpoint``, the reference's format); on a failed step (an
  exception, or a NaN loss) the loop restores the last committed step and
  replays from it, up to ``max_failures`` times.
* preemption: SIGTERM (or :meth:`Trainer.request_preemption`) checkpoints
  and exits at the next step boundary.
* stragglers: each step is timed (``time_s`` in ``metrics.jsonl``).

A step is ``autograd`` over the dense tree (every projection a plain
``x @ W``, as in the reference, whose Pallas kernels have no backward),
bf16 compute on fp32 master weights, a warmup-cosine learning rate and
AdamW.  Where the reference donates the parameters and optimizer state to
its jitted step, this one updates the parameter tensors in place: a
:class:`Trainer` owns the tree it is given.

On a mesh (``ctx.shard.mesh``, a ``DeviceMesh`` over ``("pod", "data")``
from ``launch/mesh.py``) each rank takes the batch it is handed as its
slice of the global batch along the ``batch`` rule's axes, and the ranks
average their gradients with one fp32 all-reduce.  Each rank's cross
entropy is weighted by its share of the valid labels, so the average is
the gradient of the global mean cross entropy, as the reference's GSPMD
step computes it.  The aux term (the MoE router's load-balance loss, a
product of means over the tokens) is each rank's own over its tokens,
weighted by 1/n: the reference's mesh step computes the same, since its
MoE layer runs under ``shard_map`` over the batch axes and averages the
shards' aux (``repro/models/moe.py``, ``moe_ffn``), and that differs from
a one-device step's aux over the whole batch.  The reported loss and aux
are those means.  With ``compress_pod_grads`` the average runs within
each pod over ``data``, uncompressed, and then across pods as the int8
error-feedback all-reduce of ``dist/compression.py``; ``opt["err"]`` has
the reference's ``(n_pods,) + param.shape`` in fp32, and each rank keeps
its pod's row.  Rank 0 writes the checkpoints (the ``err`` rows gathered
over ``pod`` first) while the others wait; every rank restores.  The ranks
agree on preemption after every step (one MAX all-reduce), so all of them
save and stop at the same step; a NaN loss, the same all-reduced value on
every rank, is retried from the last checkpoint by all of them, and any
other failure of a step raises (a rank that restored alone would pair its
collectives with the others' next step).  Parameters are replicated on
every rank: a ``model`` axis larger than 1 (tensor parallelism, and
placing parameters by the rules) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import tempfile
import time
from typing import Any, Callable, Iterator, Optional

import torch
import torch.distributed as dist

from repro_torch.dist import checkpoint as ckpt
from repro_torch.dist import collectives
from repro_torch.dist.compression import compressed_all_reduce
from repro_torch.models.layers import Ctx
from repro_torch.models.model import model_forward
from repro_torch.models.params import tree_flatten, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.losses import cross_entropy

_NO_TP = ("a mesh axis of {} ranks under the model rules: tensor parallelism and "
          "placing parameters by the rules are not ported yet (ROADMAP.md, Queue 1: "
          "MoE expert TP and FSDP / TP placement)")


class _NaNLoss(FloatingPointError):
    """A step's loss is NaN (on a mesh the same on every rank)."""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    adamw: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    aux_coef: float = 0.001
    compute_dtype: Any = torch.bfloat16
    checkpoint_every: int = 100
    keep_last: int = 3
    out_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_run")
    compress_pod_grads: bool = False
    seed: int = 0


def _cast_for_compute(params, dtype):
    return tree_map(
        lambda a: a.to(dtype) if a.dtype == torch.float32 and a.ndim >= 2 else a, params
    )


def make_loss_fn(ctx: Ctx, tc: TrainConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss + aux_coef * aux, (loss, aux))``:
    the forward on the tree's fp32 matrices cast to ``compute_dtype``, and
    the cross entropy of the labels (a VLM's image positions labelled -1).
    ``loss_fn(params, batch, (w_loss, w_aux))`` returns ``w_loss * loss +
    w_aux * aux`` as the objective instead (a rank's share on a mesh)."""
    cfg = ctx.cfg

    def loss_fn(params, batch, weights=None):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _, aux = model_forward(
            _cast_for_compute(params, tc.compute_dtype), inputs, ctx
        )
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:  # VLM: no loss on image tokens
            pad = logits.shape[1] - labels.shape[1]
            labels = torch.cat([labels.new_full(labels.shape[:1] + (pad,), -1), labels], 1)
        loss, _ = cross_entropy(logits, labels, cfg.vocab_size)
        if weights is not None:
            return weights[0] * loss + weights[1] * aux, (loss, aux)
        return loss + tc.aux_coef * aux, (loss, aux)

    return loss_fn


@dataclasses.dataclass
class _World:
    """The process groups a step on a mesh reduces over: ``group`` averages
    the gradients uncompressed (every batch rank, or the pod's ``data``
    ranks under compression), ``pod_group`` carries the compressed hop
    (None without compression), ``pod`` is this rank's pod."""

    group: Any
    n: int
    pod_group: Any = None
    n_pods: int = 1
    pod: int = 0


def _world(ctx: Ctx, tc: TrainConfig) -> Optional[_World]:
    """The groups of ``ctx.shard.mesh`` (None without a mesh).  Raises
    ``NotImplementedError`` for a model axis larger than 1 and
    ``ValueError`` for compression without a ``pod`` axis."""
    sh = ctx.shard
    if sh.mesh is None:
        if tc.compress_pod_grads:
            raise ValueError("compress_pod_grads needs a mesh with a 'pod' axis")
        return None
    tp = sh.axis_size(*sh.model_axes)
    if tp > 1:
        raise NotImplementedError(_NO_TP.format(tp))
    names = tuple(sh.mesh.mesh_dim_names)
    if tc.compress_pod_grads and "pod" not in names:
        raise ValueError("compress_pod_grads needs a mesh with a 'pod' axis")
    batch = tuple(a for a in sh.data_axes if not (tc.compress_pod_grads and a == "pod"))
    if len(batch) == 1:
        group = sh.mesh.get_group(batch[0])
    elif not batch:  # a group of one rank each (every rank makes every group)
        group = [dist.new_group([r]) for r in range(dist.get_world_size())][dist.get_rank()]
    else:  # every other axis has size 1: the batch axes span the whole mesh
        ranks = sorted(int(r) for r in sh.mesh.mesh.flatten().tolist())
        group = None if len(ranks) == dist.get_world_size() else dist.new_group(ranks)
    w = _World(group, dist.get_world_size(group))
    if tc.compress_pod_grads:
        w.pod_group = sh.mesh.get_group("pod")
        w.n_pods = dist.get_world_size(w.pod_group)
        w.pod = int(sh.mesh.get_coordinate()[names.index("pod")])
    return w


def _flat_all_reduce(tensors: list, group) -> list:
    """``tensors`` summed over ``group`` in fp32, as one all-reduce of
    their concatenation; each comes back in its own dtype."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    collectives.all_reduce(flat, "sum", group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def make_grad_fn(ctx: Ctx, tc: TrainConfig) -> Callable:
    """``grads_of(params, batch) -> (grads, loss, aux)``.  With
    ``microbatches > 1`` the batch splits along its first axis and the
    microbatches' gradients add up in fp32, then divide by their number (the
    reference's ``lax.scan``); loss and aux are the microbatches' means.

    On a mesh ``batch`` is this rank's slice and the result is the mesh's
    (module docstring); microbatch ``i`` of every rank together make one
    global microbatch.  With ``compress_pod_grads`` the call is
    ``grads_of(params, batch, err)``, ``err`` the ``(n_pods, ...)`` residual
    tree, whose row of this rank's pod it updates in place."""
    world = _world(ctx, tc)
    loss_fn = make_loss_fn(ctx, tc)

    def one(params, batch, weights=None):
        """(gradient leaves in flatten order, unflatten, loss, aux)."""
        leaves, unflatten = tree_flatten(params)
        live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
        with torch.enable_grad():
            total, (loss, aux) = loss_fn(unflatten(live), batch, weights)
            wrt = [p for p in live if p.requires_grad]
            got = iter(torch.autograd.grad(total, wrt, allow_unused=True))
        grads = []
        for p in live:
            g = next(got) if p.requires_grad else None
            grads.append(torch.zeros_like(p) if g is None else g)
        return grads, unflatten, loss.detach(), aux.detach()

    def microbatches(batch):
        nm = tc.microbatches
        if nm == 1:
            return [batch]
        if any(v.shape[0] % nm for v in batch.values()):
            raise ValueError(f"batch does not split into {nm} microbatches")
        return [{k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])[i]
                 for k, v in batch.items()} for i in range(nm)]

    def grads_of(params, batch):
        nm = tc.microbatches
        if nm == 1:
            grads, unflatten, loss, aux = one(params, batch)
            return unflatten(grads), loss, aux
        acc, losses, auxs = None, [], []
        for mb in microbatches(batch):
            grads, unflatten, loss, aux = one(params, mb)
            grads = [g.to(torch.float32) for g in grads]
            acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
            losses.append(loss)
            auxs.append(aux.to(torch.float32))
        grads = unflatten([a / nm for a in acc])
        return grads, torch.stack(losses).mean(), torch.stack(auxs).mean()

    if world is None:
        return grads_of

    def mesh_grads(params, batch):
        """This rank's weighted gradients summed over ``world.group``: the
        gradient of the group's mean loss, and that loss and aux."""
        mbs = microbatches(batch)
        nm = len(mbs)
        counts = torch.stack([(mb["labels"] >= 0).sum() for mb in mbs]).to(torch.int64)
        totals = collectives.all_reduce(counts.clone(), "sum", world.group)
        shares = counts.to(torch.float32) / torch.clamp(totals, min=1).to(torch.float32)
        w_aux = tc.aux_coef / world.n
        acc, parts = None, []
        for i, mb in enumerate(mbs):
            grads, unflatten, loss, aux = one(params, mb, (shares[i], w_aux))
            if nm > 1:
                grads = [g.to(torch.float32) for g in grads]
            acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
            parts += [shares[i] * loss, aux.to(torch.float32) / world.n]
        if nm > 1:
            acc = [a / nm for a in acc]
        sums = collectives.all_reduce(torch.stack(parts), "sum", world.group)
        grads = unflatten(_flat_all_reduce(acc, world.group))
        return grads, sums[0::2].mean(), sums[1::2].mean()

    if not tc.compress_pod_grads:
        return mesh_grads

    def compressed(params, batch, err):
        grads, loss, aux = mesh_grads(params, batch)
        rows = tree_map(lambda e: e[world.pod], err)
        grads, new_rows = compressed_all_reduce(grads, rows, world.pod_group)
        for row, new in zip(tree_flatten(rows)[0], tree_flatten(new_rows)[0]):
            row.copy_(new)
        means = collectives.all_reduce(torch.stack([loss, aux]), "sum",
                                       world.pod_group) / world.n_pods
        return grads, means[0], means[1]

    return compressed


def make_train_step(ctx: Ctx, tc: TrainConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: gradients, the learning rate at the pre-update step, and
    AdamW (params in place).  ``metrics`` holds loss, aux and grad_norm as
    0-d device tensors and lr as a float (the schedule runs on the host)."""
    grad_fn = make_grad_fn(ctx, tc)

    def train_step(params, opt_state, batch):
        if tc.compress_pod_grads:
            grads, loss, aux = grad_fn(params, batch, opt_state["err"])
        else:
            grads, loss, aux = grad_fn(params, batch)
        lr = warmup_cosine(
            int(opt_state["step"]),
            peak_lr=tc.peak_lr,
            warmup_steps=tc.warmup_steps,
            total_steps=tc.total_steps,
        )
        params, opt_state, gnorm = adamw_update(grads, opt_state, params, lr, tc.adamw)
        return params, opt_state, {"loss": loss, "aux": aux, "grad_norm": gnorm, "lr": lr}

    return train_step


def init_train_state(ctx: Ctx, tc: TrainConfig, params) -> dict:
    """AdamW's state, and under ``compress_pod_grads`` the residuals
    ``opt["err"]``: fp32 zeros of ``(n_pods,) + param.shape``."""
    opt = init_opt_state(params)
    if tc.compress_pod_grads:
        n_pods = ctx.shard.axis_size("pod")
        opt["err"] = tree_map(
            lambda a: torch.zeros((n_pods,) + tuple(a.shape), dtype=torch.float32,
                                  device=a.device), params)
    return opt


class Trainer:
    """Drives the loop with checkpoint / restart and preemption handling.
    A new Trainer resumes from the newest checkpoint under ``tc.out_dir``
    (``start_step``); the caller positions ``data`` there."""

    def __init__(self, ctx: Ctx, tc: TrainConfig, params, data: Iterator[dict]):
        self.ctx, self.tc = ctx, tc
        self.data = data
        self.step_fn = make_train_step(ctx, tc)
        self.params = params
        self.opt_state = init_train_state(ctx, tc, params)
        self.metrics_log: list[dict] = []
        self._preempted = False
        self.start_step = 0
        self._maybe_restore()

    # -- fault tolerance ------------------------------------------------------
    def _ckpt_dir(self) -> str:
        return os.path.join(self.tc.out_dir, "checkpoints")

    def _maybe_restore(self) -> int:
        last = ckpt.latest_step(self._ckpt_dir())
        if last is not None:
            state = {"params": self.params, "opt": self.opt_state}
            state = ckpt.restore_checkpoint(self._ckpt_dir(), last, state)
            self.params, self.opt_state = state["params"], state["opt"]
            self.start_step = last
        return self.start_step

    def _writes(self) -> bool:
        """Whether this rank writes the checkpoints and metrics: rank 0 of
        a mesh, or the one process."""
        return self.ctx.shard.mesh is None or dist.get_rank() == 0

    def _save(self, step: int):
        opt = self.opt_state
        mesh = self.ctx.shard.mesh
        if mesh is not None and "err" in opt:  # every pod's row, from its ranks
            pod = int(mesh.get_coordinate()[list(mesh.mesh_dim_names).index("pod")])
            pods = mesh.get_group("pod")
            opt = dict(opt, err=tree_map(lambda e: collectives.all_gather(e[pod], pods),
                                         opt["err"]))
        if self._writes():
            ckpt.save_checkpoint(
                self._ckpt_dir(), step, {"params": self.params, "opt": opt},
                keep_last=self.tc.keep_last,
            )
        if mesh is not None:
            collectives.barrier()  # the step is committed before any rank goes on

    def request_preemption(self, *_):
        self._preempted = True

    def _agree_on_preemption(self) -> bool:
        """Whether to stop after this step: this rank's flag, or on a mesh
        any rank's (one MAX all-reduce over the world), so that every rank
        saves and stops at the same step."""
        if self.ctx.shard.mesh is not None:
            leaf = tree_flatten(self.params)[0][0]
            flag = torch.tensor([int(self._preempted)], dtype=torch.int32, device=leaf.device)
            self._preempted = bool(collectives.all_reduce(flag, "max").item())
        return self._preempted

    # -- main loop ------------------------------------------------------------
    def run(self, num_steps: Optional[int] = None, max_failures: int = 3) -> list[dict]:
        """Train up to step ``num_steps`` (default ``tc.total_steps``);
        returns the metrics log, one record per completed step."""
        total = num_steps if num_steps is not None else self.tc.total_steps
        step = self.start_step
        failures = 0
        os.makedirs(self.tc.out_dir, exist_ok=True)
        try:
            previous = signal.signal(signal.SIGTERM, self.request_preemption)
        except ValueError:
            previous = None  # not on the main thread (tests)
        metrics_path = (os.path.join(self.tc.out_dir, "metrics.jsonl") if self._writes()
                        else os.devnull)
        try:
            with open(metrics_path, "a") as mfile:
                while step < total:
                    batch = next(self.data)
                    t0 = time.perf_counter()
                    try:
                        self.params, self.opt_state, metrics = self.step_fn(
                            self.params, self.opt_state, batch
                        )
                        loss = float(metrics["loss"])  # waits for the step
                        if math.isnan(loss):  # NaN: treated as a failure
                            raise _NaNLoss(f"NaN loss at step {step}")
                    except Exception as e:
                        failures += 1
                        if failures > max_failures or (
                                self.ctx.shard.mesh is not None and not isinstance(e, _NaNLoss)):
                            raise
                        # restore and replay from the last committed step
                        self.start_step = 0
                        step = self._maybe_restore()
                        continue
                    dt = time.perf_counter() - t0
                    step += 1
                    rec = {
                        "step": step, "time_s": dt,
                        **{k: float(v) for k, v in metrics.items()},
                    }
                    self.metrics_log.append(rec)
                    mfile.write(json.dumps(rec) + "\n")
                    mfile.flush()
                    stop = self._agree_on_preemption()
                    if step % self.tc.checkpoint_every == 0 or step == total or stop:
                        self._save(step)
                    if stop:
                        break
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
        return self.metrics_log
