"""Batched LUT-mode serving (counterpart of ``examples/serve_lut.py``): the
device-resident scheduler over a TableNet-converted LM, with per-layer
planned conversion, grouped (fused QKV / gate-up) launches, batched
multi-slot admission and on-device sampling.

  PYTHONPATH=src python -m repro_torch.examples.serve_lut [--arch granite_8b] \
      [--requests 6] [--temperature 0.8] [--top-k 40] [--admit per-slot] [--device cpu]

The reference's steps in its order: the reduced config with seeded
weights, the uniform chunk-2 plan and a plan at ``--budget-frac`` of its
bytes, ``convert_params``, then ``BatchingEngine(lut_grouped=True)`` over
seeded prompts of 3 to 9 tokens.  It runs on the card (the LUT kernels)
unless ``--device cpu`` asks for the plain versions.  The token streams do
not depend on ``--admit``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.core.convert import conversion_summary, convert_params
from repro_torch.core.planner import plan_model
from repro_torch.device import resolve_device
from repro_torch.models.layers import Ctx, ExecCfg, SampleCfg
from repro_torch.models.model import model_specs
from repro_torch.models.params import init_params
from repro_torch.serve import BatchingEngine, Request


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--budget-frac", type=float, default=0.5,
                    help="LUT byte budget as a fraction of the uniform plan")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples on the device")
    ap.add_argument("--top-k", type=int, default=0,
                    help="with --temperature: restrict draws to the top k")
    ap.add_argument("--seed", type=int, default=0, help="sampling seed")
    ap.add_argument("--admit", default="batched", choices=("batched", "per-slot"),
                    help="admission schedule (token streams are identical)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Serves the requests; returns the plans, the engine and its requests,
    the decode steps, the seconds and the tokens per second."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    # grouped LUT decode: one fused launch per same-shape projection group
    ctx = Ctx(cfg, ex=ExecCfg(remat="none", lut_grouped=True))
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0), device=dev)

    uniform = plan_model(params, float("inf"), max_chunk=2)
    budget = int(uniform.total_lut_bytes * args.budget_frac)
    plan = plan_model(params, budget, max_chunk=2)
    print(f"serving {cfg.name} (reduced) in planned LUT mode")
    print("  " + plan.summary()
          + f" (budget {budget / 2**20:.0f} MiB of"
          f" {uniform.total_lut_bytes / 2**20:.0f} MiB uniform)")
    lut_params, report = convert_params(params, plan=plan)
    print("  " + conversion_summary(report))

    if args.temperature > 0:
        mode = "top_k" if args.top_k > 0 else "temperature"
        sample = SampleCfg(mode=mode, temperature=args.temperature, top_k=args.top_k)
    else:
        sample = SampleCfg()
    print(f"  sampling: {sample.mode}, admission: {args.admit}")
    eng = BatchingEngine(lut_params, ctx, num_slots=args.slots, max_len=64, sample=sample,
                         seed=args.seed, admit=args.admit, device=dev)
    gen = torch.Generator().manual_seed(1)
    reqs = []
    for i in range(args.requests):
        plen = int(torch.randint(3, 10, (), generator=gen))
        prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=gen, dtype=torch.int32)
        r = Request(uid=i, prompt=prompt, max_new=args.max_new)  # the engine uploads it
        reqs.append(r)
        eng.submit(r)

    t0 = time.perf_counter()
    steps = 0
    while eng.step():
        steps += 1
    dt = time.perf_counter() - t0
    total = sum(len(r.generated) for r in reqs)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU plain versions"
    print(f"{len(reqs)} requests on {args.slots} slots: {steps} decode steps, "
          f"{total} tokens in {dt:.1f}s ({total / dt:.1f} tok/s, {where}; "
          f"{eng.readbacks} host readbacks)")
    for r in reqs:
        print(f"  req {r.uid}: prompt {r.prompt.tolist()} -> {r.generated}")
    return {"plan": plan, "uniform": uniform, "report": report, "engine": eng,
            "requests": reqs, "steps": steps, "seconds": dt, "tokens": total,
            "tok_per_s": total / dt}


if __name__ == "__main__":
    main()
