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
:class:`Trainer` owns the tree it is given.  Gradient compression across
pods and the pod mesh come with the distribution slice of the port.
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

from repro_torch.dist import checkpoint as ckpt
from repro_torch.models.layers import Ctx
from repro_torch.models.model import model_forward
from repro_torch.models.params import tree_flatten, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.losses import cross_entropy

_NOT_PORTED = ("{} is not ported yet: it needs torch.distributed across pods "
               "(ROADMAP.md, Queue 1: dist sharding and compressed_psum)")


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
    the cross entropy of the labels (a VLM's image positions labelled -1)."""
    cfg = ctx.cfg

    def loss_fn(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _, aux = model_forward(
            _cast_for_compute(params, tc.compute_dtype), inputs, ctx
        )
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:  # VLM: no loss on image tokens
            pad = logits.shape[1] - labels.shape[1]
            labels = torch.cat([labels.new_full(labels.shape[:1] + (pad,), -1), labels], 1)
        loss, _ = cross_entropy(logits, labels, cfg.vocab_size)
        return loss + tc.aux_coef * aux, (loss, aux)

    return loss_fn


def make_grad_fn(ctx: Ctx, tc: TrainConfig) -> Callable:
    """``grads_of(params, batch) -> (grads, loss, aux)``.  With
    ``microbatches > 1`` the batch splits along its first axis and the
    microbatches' gradients add up in fp32, then divide by their number (the
    reference's ``lax.scan``); loss and aux are the microbatches' means."""
    if tc.compress_pod_grads:
        raise NotImplementedError(_NOT_PORTED.format("compress_pod_grads"))
    loss_fn = make_loss_fn(ctx, tc)

    def one(params, batch):
        """(gradient leaves in flatten order, unflatten, loss, aux)."""
        leaves, unflatten = tree_flatten(params)
        live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
        with torch.enable_grad():
            total, (loss, aux) = loss_fn(unflatten(live), batch)
            wrt = [p for p in live if p.requires_grad]
            got = iter(torch.autograd.grad(total, wrt, allow_unused=True))
        grads = []
        for p in live:
            g = next(got) if p.requires_grad else None
            grads.append(torch.zeros_like(p) if g is None else g)
        return grads, unflatten, loss.detach(), aux.detach()

    def grads_of(params, batch):
        nm = tc.microbatches
        if nm == 1:
            grads, unflatten, loss, aux = one(params, batch)
            return unflatten(grads), loss, aux
        if any(v.shape[0] % nm for v in batch.values()):
            raise ValueError(f"batch does not split into {nm} microbatches")
        acc, losses, auxs = None, [], []
        for i in range(nm):
            mb = {k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])[i]
                  for k, v in batch.items()}
            grads, unflatten, loss, aux = one(params, mb)
            grads = [g.to(torch.float32) for g in grads]
            acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
            losses.append(loss)
            auxs.append(aux.to(torch.float32))
        grads = unflatten([a / nm for a in acc])
        return grads, torch.stack(losses).mean(), torch.stack(auxs).mean()

    return grads_of


def make_train_step(ctx: Ctx, tc: TrainConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: gradients, the learning rate at the pre-update step, and
    AdamW (params in place).  ``metrics`` holds loss, aux and grad_norm as
    0-d device tensors and lr as a float (the schedule runs on the host)."""
    grad_fn = make_grad_fn(ctx, tc)

    def train_step(params, opt_state, batch):
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
    if tc.compress_pod_grads:
        raise NotImplementedError(_NOT_PORTED.format("compress_pod_grads"))
    return init_opt_state(params)


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

    def _save(self, step: int):
        ckpt.save_checkpoint(
            self._ckpt_dir(), step, {"params": self.params, "opt": self.opt_state},
            keep_last=self.tc.keep_last,
        )

    def request_preemption(self, *_):
        self._preempted = True

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
        try:
            with open(os.path.join(self.tc.out_dir, "metrics.jsonl"), "a") as mfile:
                while step < total:
                    batch = next(self.data)
                    t0 = time.perf_counter()
                    try:
                        self.params, self.opt_state, metrics = self.step_fn(
                            self.params, self.opt_state, batch
                        )
                        loss = float(metrics["loss"])  # waits for the step
                        if math.isnan(loss):  # NaN: treated as a failure
                            raise FloatingPointError(f"NaN loss at step {step}")
                    except Exception:
                        failures += 1
                        if failures > max_failures:
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
                    if (step % self.tc.checkpoint_every == 0 or step == total
                            or self._preempted):
                        self._save(step)
                    if self._preempted:
                        break
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
        return self.metrics_log
