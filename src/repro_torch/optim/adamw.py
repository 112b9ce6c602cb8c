"""AdamW with a global-norm clip (counterpart of ``repro/optim/adamw.py``).

The arithmetic is the reference's: fp32 moments, bias corrections from the
step counter as fp32, the clip scale ``min(1, max_norm / (norm + 1e-9))``,
weight decay only on leaves of two or more dimensions (not on norms and
biases), and ``(p.float() - lr * delta).to(p.dtype)``.  Where the reference
donates the parameter and moment buffers to its jitted update, this one
writes the parameters in place under ``torch.no_grad()``.  Trees are nested dicts of
tensors, walked in the reference's flatten order (sorted keys).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import tree_flatten, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init_opt_state(params) -> dict:
    """Zero moments shaped like ``params`` and a 0-d int32 step counter."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's fp32
    sum of squares."""
    total = None
    for g in tree_leaves(tree):
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by ``min(1, max_norm / (norm + 1e-9))``, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, lr: torch.Tensor | float,
                 cfg: AdamWConfig):
    """One AdamW step.  Writes the leaves of ``params`` in place, puts the
    new fp32 moments and the incremented step counter into ``opt_state``,
    and returns ``(params, opt_state, grad_norm)``."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.clip_norm > 0:
        grads, norm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        norm = global_norm(grads)
    step = opt_state["step"] + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device), stepf)
    flat_p, unflatten = tree_flatten(params)
    new_m, new_v = [], []
    for p, g, m, v in zip(flat_p, tree_leaves(grads), tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:  # no decay on norms / biases
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_m.append(m2)  # fp32, as the reference's (a bf16 leaf's zeros widen)
        new_v.append(v2)
    opt_state["m"], opt_state["v"] = unflatten(new_m), unflatten(new_v)
    opt_state["step"] = step
    return params, opt_state, norm
