"""Paper Figs. 4/6: accuracy against input bit width for the linear
classifier (counterpart of ``benchmarks/accuracy_vs_bits.py``).

The synthetic MNIST stand-in reproduces the paper's trend: accuracy
saturates by ~3 input bits.  The ``fig4/tl1_*`` rows extend the sweep
down the table-bytes axis with the TL1 family: the classifier's weights
ternarized (absmean) and served from packed base-3 pair indices on the
``lut_tl1`` kernel (its plain version on the CPU), across activation bit
widths.

    PYTHONPATH=src python -m repro_torch.benchmarks.accuracy_vs_bits [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.convert import convert_params
from repro_torch.core.lut import LUTPlan
from repro_torch.core.lut_tl1 import TL1Plan
from repro_torch.core.planner import ModelPlan
from repro_torch.core.quantize import FixedPointFormat
from repro_torch.data.synthetic import image_batch
from repro_torch.device import resolve_device
from repro_torch.models.paper_models import (
    linear_classifier_forward,
    linear_classifier_specs,
    paper_ctx,
    quantize_inputs,
    sgd,
)
from repro_torch.models.params import init_params


def train_linear(
    steps: int = 400, batch: int = 256, lr: float = 0.3, seed: int = 0,
    device: str | torch.device = "cuda",
):
    """The reference's recipe for the classifier: ``steps`` SGD steps on
    ``image_batch(batch, s, seed=seed)``.  Returns (params, ctx)."""
    dev = resolve_device(device)
    ctx = paper_ctx()
    params = init_params(
        linear_classifier_specs(), torch.Generator().manual_seed(seed), device=dev
    )
    batches = (image_batch(batch, s, seed=seed, device=dev) for s in range(steps))
    return sgd(params, linear_classifier_forward, ctx, batches, lr), ctx


@torch.no_grad()
def _correct(params, ctx, bits, n, seed, dev) -> float:
    correct = tot = 0
    for s in range(n // 500):
        x, y = image_batch(500, 10_000 + s, seed=seed, device=dev)
        logits = linear_classifier_forward(params, quantize_inputs(x, bits), ctx)
        correct += int((logits.argmax(-1) == y).sum())
        tot += 500
    return correct / tot


def accuracy(
    params, ctx, bits: int | None, n: int = 2000, seed: int = 0,
    device: str | torch.device = "cuda",
) -> float:
    """Accuracy over ``n`` held-out images (batches of 500 from step
    10,000), inputs on the ``bits``/``bits`` fixed-point grid when given."""
    return _correct(params, ctx, bits, n, seed, resolve_device(device))


def tl1_accuracy(
    params, ctx, act_bits: int | None, n: int = 2000, seed: int = 0,
    device: str | torch.device = "cuda",
) -> float:
    """Accuracy with ``fc`` converted to the TL1 family (ternary weights,
    activation-side LUT) at ``act_bits`` activation quantization."""
    dev = resolve_device(device)
    q, p = params["fc"]["w"].shape
    plan = ModelPlan({"fc": TL1Plan(q, p, act_bits=act_bits)})
    conv, _ = convert_params(params, plan=plan)
    return _correct(conv, ctx, None, n, seed, dev)


def rows(device: str | torch.device = "cuda") -> list[tuple[str, float, str]]:
    dev = resolve_device(device)
    params, ctx = train_linear(device=dev)
    ref = accuracy(params, ctx, None, device=dev)
    out = [("fig4/reference_fp32", round(ref, 4), "full precision")]
    for bits in range(1, 9):
        acc = accuracy(params, ctx, bits, device=dev)
        out.append((f"fig4/bits_{bits}", round(acc, 4), f"delta={acc - ref:+.4f}"))
    # accuracy against TABLE BYTES: ternary weights cost q*p/4 persistent
    # bytes against the weight family's tables (reference: the int8-input
    # bitplane chunk-2 plan, the regime the fig4 sweep saturates in)
    q, p = params["fc"]["w"].shape
    weight_bytes = LUTPlan(
        q, p, 2, FixedPointFormat(8, 8, signed=False), mode="bitplane"
    ).total_lut_bytes
    for act_bits in (None, 8, 4, 2):
        acc = tl1_accuracy(params, ctx, act_bits, device=dev)
        tl1_bytes = TL1Plan(q, p, act_bits=act_bits).total_lut_bytes
        label = "fp" if act_bits is None else f"a{act_bits}"
        out.append((
            f"fig4/tl1_{label}",
            round(acc, 4),
            f"{tl1_bytes}B tables (weight-family {weight_bytes}B), "
            f"delta={acc - ref:+.4f}",
        ))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for name, value, note in rows(args.device):
        print(f"{name:24s} {value:>10} {note}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
