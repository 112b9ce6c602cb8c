"""Losses (counterpart of ``repro/train/losses.py``): next-token cross
entropy with the padded vocabulary's columns and ``-1`` labels masked."""
from __future__ import annotations

import torch


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V_padded)
    labels: torch.Tensor,  # (B, S) integer; -1 = ignore
    vocab_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (mean loss over valid tokens, valid-token count), in fp32."""
    lf = logits.to(torch.float32)
    if lf.shape[-1] > vocab_size:  # mask Megatron-style vocab padding columns
        col = torch.arange(lf.shape[-1], device=lf.device)
        lf = torch.where(col < vocab_size, lf, lf.new_tensor(-1e9))
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).to(torch.int64)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, torch.zeros_like(lse))
    count = torch.clamp(valid.sum(), min=1)
    return nll.sum() / count, count
