"""Plain PyTorch version of the bitplane binary matmul (counterpart of
``repro/kernels/binary_matmul/ref.py``)."""
from __future__ import annotations

import torch


def binary_matmul_ref(
    planes: torch.Tensor,  # (B, n, q) {0, 1} bits, any integer dtype
    W: torch.Tensor,  # (q, p)
    scales: torch.Tensor,  # (n,) fp32
) -> torch.Tensor:
    """``out[b] = sum_j scales[j] * planes[b, j] @ W`` -> (B, p) fp32, with
    ``W`` rounded to bf16 and every product and sum in fp32, as the
    kernels' bf16 operands with fp32 accumulation.  (A bf16 x bf16
    ``torch.matmul`` would return bf16, so ``W`` is widened back to fp32
    after its rounding; a bit times a bf16 value is exact in fp32.)"""
    w = W.to(torch.bfloat16).to(torch.float32)
    prod = planes.to(torch.float32) @ w  # (B, n, p)
    return (prod * scales.to(torch.float32)[:, None]).sum(dim=1)
