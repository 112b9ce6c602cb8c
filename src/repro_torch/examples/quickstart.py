"""Quickstart (counterpart of ``examples/quickstart.py``): train a small LM,
plan its LUT budget per layer, convert, and serve it multiplier-free.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The paper's pipeline, in the reference's order: train 24 steps in float,
restore the trained tree from its checkpoint, plan a uniform chunk-2 LUT
footprint and then a plan at half its bytes, convert, commit the plan with
a checkpoint as ``aux`` and read it back, then serve the dense tree and the
converted one (grouped LUT launches) and print both token rows.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.convert import conversion_summary, convert_params
from repro_torch.core.planner import ModelPlan, plan_model
from repro_torch.data.pipeline import lm_stream
from repro_torch.device import resolve_device
from repro_torch.dist.checkpoint import latest_step, load_aux, save_checkpoint
from repro_torch.models.layers import Ctx, ExecCfg
from repro_torch.models.model import model_specs
from repro_torch.models.params import count_params, init_params
from repro_torch.serve import generate
from repro_torch.train.trainer import TrainConfig, Trainer


def main(device: str | torch.device = "cuda",
         out: str = os.path.join(tempfile.gettempdir(), "quickstart_run")) -> dict:
    """Runs the quickstart under ``out`` (emptied first); returns its rows:
    the training log, both plans, the conversion report, the prompts and the
    standard and LUT token rows."""
    dev = resolve_device(device)
    cfg = get_config("granite_8b", reduced=True)
    ctx = Ctx(cfg, ex=ExecCfg(remat="none"))
    specs = model_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0), device=dev)
    print(f"model: {cfg.name} (reduced) — {count_params(specs):,} params")

    shutil.rmtree(out, ignore_errors=True)  # fresh demo run
    tc = TrainConfig(peak_lr=1e-2, warmup_steps=5, total_steps=24,
                     checkpoint_every=12, out_dir=out)
    data = lm_stream(cfg.vocab_size, seq_len=32, global_batch=8, seed=0, device=dev)
    log = Trainer(ctx, tc, params, data).run(24)
    print(f"trained 24 steps: loss {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}")
    fresh = init_params(specs, torch.Generator().manual_seed(0), device=dev)
    trainer_params = Trainer(ctx, tc, fresh, data).params  # restored from ckpt

    # the paper's post-training conversion, planned per layer: spend half the
    # uniform chunk-2 LUT budget where it buys the most shift/add reduction
    uniform = plan_model(trainer_params, float("inf"), max_chunk=2)
    plan = plan_model(trainer_params, uniform.total_lut_bytes // 2, max_chunk=2)
    print("uniform plan  :", uniform.summary())
    print("planned (0.5x):", plan.summary())
    lut_params, report = convert_params(trainer_params, plan=plan)
    print("TableNet conversion:", conversion_summary(report))

    # the plan rides along with the checkpoint and survives restore
    ckpt_dir = os.path.join(out, "lut_ckpt")
    save_checkpoint(ckpt_dir, 0, trainer_params, aux={"model_plan": plan.to_json()})
    restored = ModelPlan.from_json(load_aux(ckpt_dir, latest_step(ckpt_dir))["model_plan"])
    assert dict(restored.layers) == dict(plan.layers)

    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(7),
                            dtype=torch.int32).to(dev)
    ref = generate(trainer_params, ctx, prompts, max_new=8, device=dev)
    # grouped serving: QKV / gate-up fuse into one LUT dispatch per step
    lut_ctx = Ctx(cfg, ex=ExecCfg(remat="none", lut_grouped=True))
    lut = generate(lut_params, lut_ctx, prompts, max_new=8, device=dev)
    print("standard serve :", ref.tolist())
    print("LUT serve      :", lut.tolist())
    return {"log": log, "uniform": uniform, "plan": plan, "report": report,
            "prompts": prompts, "standard": ref.tolist(), "lut": lut.tolist()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "quickstart_run"))
    args = ap.parse_args()
    main(args.device, args.out)
