"""Paper reproduction (counterpart of ``examples/tablenet_mnist.py``):
the linear, MLP and LeNet classifiers on the synthetic MNIST stand-in --
train, quantise inputs, convert to LUTs, compare.

Reproduces (offline versions of):
  Fig. 4/6: accuracy against input bits (trend: saturation by ~3 bits)
  Fig. 5/7/8: LUT size against shift-adds (analytic, exact)
  the LUT path == quantised model equivalence the paper rests on

  PYTHONPATH=src python -m repro_torch.examples.tablenet_mnist [--model mlp]
      [--steps 300] [--device cuda]

Training is SGD through ``torch.autograd`` on the dense tree, with the
reference's recipe (300 steps of 128 images, lr 0.3).  Its sums run in
another order than ``jax.grad``'s, so the trained weights are the
reference recipe's, not its bits.  The converted network runs on the LUT
kernels when ``--device cuda`` (the default), on their plain versions with
``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.analysis import LINEAR_CLASSIFIER, MLP, figure_curve
from repro_torch.core.convert import conversion_summary, convert_params
from repro_torch.core.quantize import FixedPointFormat, Float16Format
from repro_torch.data.synthetic import image_batch
from repro_torch.device import resolve_device
from repro_torch.models.paper_models import PAPER_MODELS, paper_ctx, quantize_inputs, sgd
from repro_torch.models.params import init_params


def train(
    model: str, steps: int = 300, lr: float = 0.3, seed: int = 0,
    device: str | torch.device = "cuda",
):
    """The reference's recipe: ``steps`` SGD steps on ``image_batch(128,
    s)`` from weights drawn with ``seed``.  Returns (params, forward, ctx)."""
    dev = resolve_device(device)
    specs_fn, forward = PAPER_MODELS[model]
    ctx = paper_ctx()
    params = init_params(specs_fn(), torch.Generator().manual_seed(seed), device=dev)
    batches = (image_batch(128, s, device=dev) for s in range(steps))
    return sgd(params, forward, ctx, batches, lr), forward, ctx


@torch.no_grad()
def accuracy(
    forward, params, ctx, bits: int | None = None, n: int = 1500,
    device: str | torch.device = "cuda",
) -> float:
    """Top-1 accuracy over ``n`` held-out images (batches of 500 from step
    50,000), inputs quantised to ``bits`` when given."""
    dev = resolve_device(device)
    ok = tot = 0
    for s in range(n // 500):
        x, y = image_batch(500, 50_000 + s, device=dev)
        logits = forward(params, quantize_inputs(x, bits), ctx)
        ok += int((logits.argmax(-1) == y).sum())
        tot += 500
    return ok / tot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="linear", choices=list(PAPER_MODELS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    params, forward, ctx = train(args.model, args.steps, args.lr, device=dev)
    ref = accuracy(forward, params, ctx, device=dev)
    print(f"[{args.model}] reference (fp32) accuracy: {ref:.3f}")
    print("accuracy vs input bits (paper Fig. 4/6 -- expect ~3-bit saturation):")
    for bits in range(1, 9):
        print(f"  {bits} bits: {accuracy(forward, params, ctx, bits, device=dev):.3f}")

    lut_params, report = convert_params(params, chunk_size=1, signed=False)
    print("conversion:", conversion_summary(report))
    x, _ = image_batch(500, 99_999, device=dev)
    with torch.no_grad():
        a_ref = forward(params, x, ctx)
        a_lut = forward(lut_params, x, ctx)
    agree = float((a_ref.argmax(-1) == a_lut.argmax(-1)).float().mean())
    print(f"LUT path vs full model: argmax agreement {agree:.4f}, "
          f"max |dlogit| {float((a_ref - a_lut).abs().max()):.4f}")

    print("\nLUT size vs ops tradeoff (paper Fig. 5):")
    layers = LINEAR_CLASSIFIER if args.model == "linear" else MLP
    fmt = FixedPointFormat(3, 3) if args.model == "linear" else Float16Format()
    for r in figure_curve(layers, fmt)[:8]:
        print(f"  {r['mode']:9s} m={r['chunk']:2d}: {r['bytes']:>12,} B "
              f"{r['shift_adds']:>12,} shift-adds")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
