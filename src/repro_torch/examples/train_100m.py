"""End-to-end training example (counterpart of ``examples/train_100m.py``):
a 153M-parameter LM for a few hundred steps with checkpointing, restart
and metrics -- the port's full train path.

  PYTHONPATH=src python -m repro_torch.examples.train_100m --preset tiny --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_100m --preset 100m --steps 300

The 100m preset is the deliverable configuration (a granite-style dense
decoder, 12 layers of d_model 768); the tiny preset (1.5M) exercises the
same path on a CPU.  Both run: deterministic sharded data -> autograd step
(remat ``"dots"``, bf16 compute on fp32 weights, AdamW and warmup-cosine)
-> atomic checkpoints every ``--ckpt-every`` steps.  ``--demo-restart``
stops halfway and resumes from the checkpoint in a fresh :class:`Trainer`.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import lm_stream
from repro_torch.device import resolve_device
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_specs
from repro_torch.models.params import count_params, init_params
from repro_torch.train.trainer import TrainConfig, Trainer

PRESETS = {
    "tiny": ModelConfig(
        name="lm-tiny", family="dense", num_layers=4, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
        vocab_pad_multiple=16,
    ),
    "100m": ModelConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32000,
    ),
}


def setup(cfg: ModelConfig, steps: int, batch: int, seq: int, ckpt_every: int, out: str,
          device):
    """The example's recipe: (ctx, train config, a params maker from the
    seed-0 generator, a data maker from a step)."""
    ctx = Ctx(cfg, ex=ExecCfg(remat="dots"))
    specs = model_specs(cfg)
    tc = TrainConfig(
        peak_lr=3e-4, warmup_steps=max(steps // 10, 5), total_steps=steps,
        checkpoint_every=ckpt_every, out_dir=out,
    )

    def params():
        return init_params(specs, torch.Generator().manual_seed(0), device=device)

    def data_from(step):
        return lm_stream(cfg.vocab_size, seq, batch, seed=0, start_step=step, device=device)

    return ctx, tc, params, data_from


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "train_100m_run"))
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--demo-restart", action="store_true",
                    help="stop halfway, then resume from the checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.fresh and os.path.isdir(args.out):
        shutil.rmtree(args.out)
    cfg = PRESETS[args.preset]
    ctx, tc, params, data_from = setup(cfg, args.steps, args.batch, args.seq,
                                       args.ckpt_every, args.out, device)
    print(f"{cfg.name}: {count_params(model_specs(cfg)) / 1e6:.1f}M params, "
          f"{args.steps} steps of {args.batch}x{args.seq} tokens on {device}")

    t = Trainer(ctx, tc, params(), data_from(0))
    if t.start_step:
        print(f"resumed from checkpoint at step {t.start_step}")
        t.data = data_from(t.start_step)

    if args.demo_restart and t.start_step == 0:
        half = args.steps // 2
        t.run(half)
        print(f"--- simulating preemption at step {half}; restarting ---")
        t = Trainer(ctx, tc, params(), data_from(half))
        assert t.start_step == half, t.start_step

    log = t.run(args.steps)
    first = sum(r["loss"] for r in log[:3]) / max(len(log[:3]), 1)
    last = sum(r["loss"] for r in log[-3:]) / max(len(log[-3:]), 1)
    times = sorted(r["time_s"] for r in log)
    p50 = times[len(times) // 2]
    p99 = times[max(int(len(times) * 0.99) - 1, 0)]
    print(f"loss {first:.3f} -> {last:.3f}; step p50={p50:.3f}s p99={p99:.3f}s")
    print(f"checkpoints + metrics.jsonl in {args.out}")
    return log


if __name__ == "__main__":
    main()
