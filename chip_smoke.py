#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py [--phases device,kernel,serve] [--iters 20]

Phases, one JSON object per line:

1. ``device``  the card, torch/CUDA versions, and the build of every
   kernel from ``src/repro_torch/csrc`` with nvcc for sm_90a.
2. ``kernel``  each Hopper kernel against its plain PyTorch version on the
   card, at the main path's full-width granite_8b shapes (decode B = 4 and
   prefill B = 4 slots x 32 tokens) and on a grid of table types,
   shift_bits and ragged edges; with the kernel's time, the plain
   version's, the least time the card could take (``bound_ms``) and, for
   context, the dense bf16 matmul the tables replace.
3. ``serve``   full-width granite_8b, depth cut to 4 layers, planned
   with the serving recipe, converted to i8 tables and served through
   ``BatchingEngine`` on the kernels; then the same requests on the plain
   versions, the prefill logits of both compared and every request's
   first token held equal.

Then one ``kernels`` summary line, the card's name and power limit as
nvidia-smi prints them, and last ``{"ok": true, "device": {...}}``.  Any
failure raises: the script exits non-zero without that last line.  It
exits non-zero at once when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
KERNEL_TOL = 1e-5  # x max|plain|: fp32 sums taken in another order
LOGITS_TOL = 5e-2  # x max|plain|, see the serve phase
LOGITS_FRO_TOL = 5e-2  # ||kernel - plain|| / ||plain|| over the prefill logits

# the serve phase: depth (cut by memory), requests, new tokens each
LAYERS, REQUESTS, MAX_NEW = 4, 8, 16

# main-path shapes of full-width granite_8b: name -> (G, k, p)
LONE = {"wq": (1, 4096, 4096), "wo": (1, 4096, 4096), "w_down": (1, 14336, 4096)}
GROUPED = {"wk+wv": (2, 4096, 1024), "w_gate+w_up": (2, 4096, 14336)}
SOURCE = "src/repro_torch/csrc/lut_affine.cu"
REPLACES = {
    "lut_affine": "src/repro/kernels/lut_affine/lut_affine.py:275",
    "lut_affine_grouped": "src/repro/kernels/lut_affine/lut_affine.py:239",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median over ``iters`` launches of ``fn``, each between its own CUDA
    events, after ``warmup`` untimed calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def bound(codes, G, E, p, itemsize, shift_bits):
    """Least time for the card: the table rows this run's codes touch (each
    read once), the codes and the output, over HBM bandwidth; or the
    shift + add per gathered element over the fp32 rate."""
    import torch

    B, n, k = codes.shape
    idx = codes & (E - 1) if shift_bits else codes
    chunk = torch.arange(k, device=codes.device, dtype=torch.int64)
    rows = torch.unique(chunk * E + idx.to(torch.int64)).numel()
    nbytes = G * rows * p * itemsize + codes.numel() * 4 + G * B * p * 4
    ops = 2 * G * B * n * k * p
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def make_case(gen, B, n, k, E, p, G, dtype, shift_bits, scales, real_codes=None):
    import torch

    dev = DEV
    if real_codes is not None:
        codes = real_codes
    else:
        idx = torch.randint(0, E, (B, n, k), generator=gen, device=dev, dtype=torch.int32)
        if shift_bits:
            exp = torch.randint(0, 31, (B, 1, k), generator=gen, device=dev, dtype=torch.int32)
            idx = idx + (exp << shift_bits)
        codes = idx
    shape = (G, k, E, p)
    if dtype in (torch.int8, torch.int16):
        hi = 127 if dtype == torch.int8 else 32767
        tables = torch.randint(-hi, hi + 1, shape, generator=gen, device=dev, dtype=dtype)
    else:
        tables = torch.randn(shape, generator=gen, device=dev).to(dtype)
    return codes.contiguous(), tables, scales


def run_case(name, codes, tables, scales, shift_bits, iters, plain_iters, lib_fn=None):
    import torch

    from repro_torch.kernels.lut_affine import ops

    G, k, E, p = tables.shape
    B, n, _ = codes.shape
    if name == "lut_affine":
        t = tables[0]

        def kern():
            return ops.lut_affine(codes, t, scales, shift_bits=shift_bits)

        def plain():
            return ops.lut_affine(codes, t, scales, shift_bits=shift_bits, use_kernels=False)
    else:

        def kern():
            return ops.lut_affine_grouped(codes, tables, scales, shift_bits=shift_bits)

        def plain():
            return ops.lut_affine_grouped(
                codes, tables, scales, shift_bits=shift_bits, use_kernels=False
            )

    got = kern()
    torch.cuda.synchronize()
    ref = plain()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = KERNEL_TOL * scale
    if not (err <= tol and torch.isfinite(got).all().item()):
        raise AssertionError(f"{name} B={B} n={n} k={k} E={E} p={p}: err {err} > tol {tol}")
    del got, ref
    ms = cuda_ms(kern, iters)
    plain_ms = cuda_ms(plain, plain_iters, warmup=1)
    calls = 1 if name == "lut_affine" else G
    bms, by = bound(codes, calls, E, p, tables.element_size(), shift_bits)
    lib_ms = cuda_ms(lib_fn, iters) if lib_fn is not None else None
    return {
        "max_abs_err": err, "tol": tol,
        "tol_reason": f"{KERNEL_TOL} x max|plain|: fp32 sums in another order",
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "dense_matmul_ms": dense_ms(B, calls, k, p, iters),
    }


def embedding_bag_fn(codes, tables, scales, shift_bits):
    """One PyTorch call computing the same function for f32 tables:
    ``embedding_bag(mode="sum")`` over the flattened tables with the shifts
    as per-sample weights (G bags per row, one call)."""
    import torch
    import torch.nn.functional as F

    G, k, E, p = tables.shape
    B, n, _ = codes.shape
    idx = (codes & (E - 1) if shift_bits else codes).to(torch.int64)
    chunk = torch.arange(k, device=codes.device, dtype=torch.int64)
    flat = chunk * E + idx  # (B, n, k)
    s = torch.as_tensor(scales, dtype=torch.float32, device=codes.device)[None, :, None]
    w = s.expand(B, n, k)
    if shift_bits:
        w = w * torch.exp2((torch.clamp(codes >> shift_bits, min=1) - 25).float())
    g = torch.arange(G, device=codes.device, dtype=torch.int64)[:, None, None] * (k * E)
    inp = (flat.reshape(1, B, n * k) + g).reshape(G * B, n * k)
    psw = w.reshape(1, B, n * k).expand(G, B, n * k).reshape(G * B, n * k).contiguous()
    weight = tables.reshape(G * k * E, p)
    return lambda: F.embedding_bag(inp, weight, mode="sum", per_sample_weights=psw)


def dense_ms(B, G, k, p, iters):
    import torch

    x = torch.randn(B, k, device=DEV, dtype=torch.bfloat16)
    ws = torch.randn(G, k, p, device=DEV, dtype=torch.bfloat16)
    return cuda_ms(lambda: [x @ ws[g] for g in range(G)], iters)


def kernel_phase(iters: int, prefill_rows: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.lut import LUTPlan, pack_codes, plane_scales
    from repro_torch.core.quantize import Float16Format

    gen = torch.Generator(device=DEV).manual_seed(1)
    # worst error at the main path's shapes (the grid's values span other
    # magnitudes; each grid line is held to its own tolerance)
    worst = {"lut_affine": 0.0, "lut_affine_grouped": 0.0}
    main = {}  # decode-shape numbers per kernel, summed per layer
    # main path: bitplane_shift radix 4, i8, scales = plane scales * 2**-6
    fmt = Float16Format(signed=True, mantissa_radix=4)
    for rows in (4, prefill_rows):
        for name, shapes in (("lut_affine", LONE), ("lut_affine_grouped", GROUPED)):
            for proj, (G, k, p) in shapes.items():
                plan = LUTPlan(k, p, 1, fmt, mode="bitplane_shift", table_format="i8")
                x = torch.randn(rows, k, generator=gen, device=DEV)
                codes = pack_codes(x, plan)
                scales = plane_scales(plan).astype(np.float32) * np.float32(2.0**-6)
                c, t, s = make_case(
                    gen, rows, plan.num_planes, k, plan.num_entries, p, G,
                    torch.int8, plan.shift_bits, scales, real_codes=codes,
                )
                r = run_case(name, c, t, s, plan.shift_bits, iters, 5 if rows > 4 else 10)
                emit({"phase": "kernel", "kernel": name, "proj": proj, "rows": rows,
                      "G": G, "n": plan.num_planes, "k": k, "E": plan.num_entries, "p": p,
                      "table": "i8", "shift_bits": plan.shift_bits, **r})
                worst[name] = max(worst[name], r["max_abs_err"])
                if rows == 4:
                    m = main.setdefault(
                        name,
                        {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": set()},
                    )
                    for key in ("kernel_ms", "plain_ms", "bound_ms"):
                        m[key] += r[key]
                    m["bound_by"].add(r["bound_by"])
                del c, t
                torch.cuda.empty_cache()
    # grid: table types, shift_bits 0/5, ragged k/p/B, negative plane scales
    grid = [
        # B, n, k, E, p, G, dtype, shift_bits, scales
        (3, 3, 37, 32, 130, 1, torch.float32, 5, [1.0, 16.0, 256.0]),
        (3, 3, 37, 32, 130, 2, torch.bfloat16, 5, [0.5, 8.0, 128.0]),
        (5, 3, 64, 32, 257, 1, torch.int16, 5, [2.0**-10, 2.0**-6, 2.0**-2]),
        (7, 11, 50, 128, 67, 1, torch.float32, 0, [2.0**j for j in range(11)]),
        (9, 8, 33, 16, 258, 2, torch.float32, 0, [2.0**j for j in range(7)] + [-128.0]),
        (17, 8, 45, 16, 131, 1, torch.int8, 0, [2.0**j for j in range(7)] + [-128.0]),
        (33, 6, 29, 64, 1000, 2, torch.int16, 0, [4.0**j for j in range(6)]),
        (2, 1, 20, 1024, 96, 1, torch.bfloat16, 0, [1.0]),
    ]
    for B, n, k, E, p, G, dtype, shift, scales in grid:
        c, t, s = make_case(gen, B, n, k, E, p, G, dtype, shift, np.asarray(scales, np.float32))
        for name in ("lut_affine", "lut_affine_grouped"):
            lib = embedding_bag_fn(c, t[:1] if name == "lut_affine" else t, s, shift) \
                if dtype == torch.float32 else None
            r = run_case(name, c, t, s, shift, iters, 5, lib_fn=lib)
            emit({"phase": "kernel", "kernel": name, "grid": True, "rows": B,
                  "G": G if name != "lut_affine" else 1, "n": n, "k": k, "E": E, "p": p,
                  "table": str(dtype).replace("torch.", ""), "shift_bits": shift, **r})
    return {"worst": worst, "main": main}


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


def serve_phase(layers: int, requests: int, max_new: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.kernels.lut_affine import ops
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward, model_specs
    from repro_torch.models.params import init_params
    from repro_torch.serve import BatchingEngine, Request, make_cache

    full = get_config("granite_8b")
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), gen, device=DEV)
    uniform = plan_model(params, float("inf"), max_chunk=2)
    mplan = plan_model(
        params,
        uniform.total_lut_bytes // 2,
        max_chunk=2,
        modes=("bitplane", "bitplane_shift"),
        radices=(1, 2, 4),
        table_formats=(None, "i8"),
    )
    kinds = sorted({
        f"{p.mode}-r{p.fmt.mantissa_radix}-{p.table_format}-c{p.chunk_size}"
        for p in mplan.layers.values()
    })
    per_layer = mplan.total_lut_bytes / layers / 2**20
    emit({"phase": "serve", "step": "plan", "summary": mplan.summary(),
          "table_mib": mplan.total_lut_bytes / 2**20, "table_mib_per_layer": per_layer,
          "plans": kinds,
          "depth": {"layers": layers, "published": full.num_layers,
                    "reason": f"{per_layer:.0f} MiB of tables per layer: all "
                              f"{full.num_layers} layers would need "
                              f"{per_layer * full.num_layers / 1024:.0f} GiB, more than "
                              "the card's 80 GB; widths are the published ones"}})
    lut, report = convert_params(params, plan=mplan)
    del params
    torch.cuda.synchronize()
    emit({"phase": "serve", "step": "convert", "summary": conversion_summary(report),
          "seconds": time.perf_counter() - t0,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab_size, int(rng.integers(8, 33))).astype(np.int32)
        for _ in range(requests)
    ]
    slots, max_len, bucket = 4, 64, 32

    def serve(use_kernels: bool):
        ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        eng = BatchingEngine(lut, ctx, slots, max_len, prefill_bucket=bucket, device=DEV)
        reqs = [Request(i, pr, max_new) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        decode_ms = []
        torch.cuda.synchronize()
        start = time.perf_counter()
        while True:
            before, t = eng.prefill_tokens, time.perf_counter()
            if not eng.step():
                break
            if eng.prefill_tokens == before:  # a pure decode step
                decode_ms.append((time.perf_counter() - t) * 1e3)
        wall = time.perf_counter() - start
        return reqs, eng, wall, decode_ms

    for key in ops.LAUNCHES:
        ops.LAUNCHES[key] = 0
    reqs, eng, wall, decode_ms = serve(True)
    launches = dict(ops.LAUNCHES)
    forwards = eng.readbacks
    expect = {"lut_affine": 3 * layers * forwards, "lut_affine_grouped": 2 * layers * forwards}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "serve", "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": {"lut_affine": 3 * layers, "lut_affine_grouped": 2 * layers},
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or min(launches.values()) <= 0:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new")

    emit({"phase": "serve", "step": "decode_profile",
          **profile_decode(lut, cfg, prompts[:slots], slots, max_len, bucket, max_new)})

    plain_reqs, _, plain_wall, plain_decode = serve(False)
    first_ok = all(a.generated[0] == b.generated[0] for a, b in zip(reqs, plain_reqs))
    same = sum(
        x == y for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)
    )
    emit({"phase": "serve", "step": "plain", "tok_per_s": tokens / plain_wall,
          "median_decode_step_ms": statistics.median(plain_decode),
          "first_tokens_identical": first_ok, "identical_token_share": same / tokens})
    if not first_ok:
        raise AssertionError("kernel and plain paths disagree on a first token")

    # one prefill batch, both paths, fresh caches; first at every depth up to
    # the served one, to show how the paths' difference grows layer by layer
    tok = np.zeros((slots, bucket), np.int32)
    mask = np.zeros((slots, bucket), bool)
    for s in range(slots):
        tok[s, : len(prompts[s])] = prompts[s]
        mask[s, : len(prompts[s])] = True
    inputs = {"tokens": torch.from_numpy(tok).to(DEV), "token_mask": torch.from_numpy(mask).to(DEV)}

    def prefill_logits(depth: int, use_kernels: bool):
        dcfg = dataclasses.replace(cfg, num_layers=depth)
        params = dict(lut, blocks=first_layers(lut["blocks"], depth))
        ctx = Ctx(dcfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        cache = make_cache(dcfg, slots, max_len, ctx, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(params, inputs, ctx, cache=cache)
        return logits[inputs["token_mask"]]

    def compare(a, b):
        d = a - b
        return {"max_abs_err": d.abs().max().item(), "max_abs_ref": b.abs().max().item(),
                "rel_fro_err": (d.norm() / b.norm()).item(),
                "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item()}

    for depth in range(1, layers):
        emit({"phase": "serve", "step": "prefill_logits_by_depth", "layers": depth,
              **compare(prefill_logits(depth, True), prefill_logits(depth, False))})
    got, ref = prefill_logits(layers, True), prefill_logits(layers, False)
    # noise floor: the plain path against itself with its sums cut into
    # other chunk slices (the same function, another fp32 order)
    with plain_gather_bytes(64 * 2**20):
        floor = compare(prefill_logits(layers, False), ref)
    res = compare(got, ref)
    finite = bool(torch.isfinite(got).all().item())
    tol = LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": "serve", "step": "prefill_logits", "layers": layers, "shape": list(got.shape),
          **res, "tol": tol, "rel_fro_tol": LOGITS_FRO_TOL, "finite": finite,
          "plain_vs_plain": floor,
          "tol_reason": "the paths sum in other orders (~1e-7 relative); where that moves an "
                        "activation across an fp16 rounding boundary before the next table "
                        "lookup, its code changes by 2**-11, and the random-init layers carry "
                        "and grow these steps to the logits (plain_vs_plain shows the same "
                        "effect between two orders of the plain version)"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= LOGITS_FRO_TOL):
        raise AssertionError(f"prefill logits differ: {res} (tol {tol}, {LOGITS_FRO_TOL})")
    return {"launches": launches}


def profile_decode(lut, cfg, prompts, slots, max_len, bucket, max_new, steps=4):
    """Where a steady decode step's time goes: ``torch.profiler`` over
    ``steps`` engine steps after admission.  ``busy_ms`` sums the device
    time of every kernel; the idle share is the rest of the host-clock
    wall time.  (Its launches are not the main-path run's: the counts were
    read before.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request

    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    eng = BatchingEngine(lut, ctx, slots, max_len, prefill_bucket=bucket, device=DEV)
    for i, pr in enumerate(prompts):
        eng.submit(Request(i, pr, max_new))
    eng.step()  # admission prefill + first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            eng.step()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "busy_ms_per_step": busy / steps,
        "idle_share": 1.0 - busy / wall_ms if busy > 0 else None,
        "top_kernels_ms_per_step": {
            e.key[:60]: e.self_device_time_total / 1e3 / steps for e in top
        },
    }


def first_layers(tree, depth: int):
    """Views of the first ``depth`` layers of a stacked block tree."""
    from repro_torch.core.convert import LUTGroup, LUTLinear

    if isinstance(tree, dict):
        return {k: first_layers(v, depth) for k, v in tree.items()}
    if isinstance(tree, (LUTLinear, LUTGroup)):
        return dataclasses.replace(
            tree, tables=tree.tables[:depth],
            b=None if tree.b is None else tree.b[:depth],
            scale=None if tree.scale is None else tree.scale[:depth],
        )
    return tree[:depth]


@contextlib.contextmanager
def plain_gather_bytes(nbytes: int):
    """Run the plain versions with another chunk-slice size (so another
    fp32 summation order) inside a ``with`` block."""
    from repro_torch.kernels.lut_affine import ops

    saved = ops.lut_affine_ref, ops.lut_affine_grouped_ref
    ops.lut_affine_ref = functools.partial(saved[0], max_gather_bytes=nbytes)
    ops.lut_affine_grouped_ref = functools.partial(saved[1], max_gather_bytes=nbytes)
    try:
        yield
    finally:
        ops.lut_affine_ref, ops.lut_affine_grouped_ref = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="device,kernel,serve")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    built = build.build(force=True)
    ptxas = [ln.strip() for log in build.BUILD_LOG.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "tf32": {"matmul": False, "cudnn": False},
          "build_seconds": build.BUILD_SECONDS, "libraries": {k: str(v) for k, v in built.items()},
          "ptxas": ptxas})
    kern = kernel_phase(args.iters, 4 * 32) if "kernel" in phases else None
    srv = serve_phase(LAYERS, REQUESTS, MAX_NEW) if "serve" in phases else None
    if kern is not None and srv is not None:
        emit({"kernels": [
            {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
             "launches": srv["launches"][name], "max_abs_err": kern["worst"][name],
             "ms": kern["main"][name]["kernel_ms"],
             "plain_ms": kern["main"][name]["plain_ms"],
             "bound_ms": kern["main"][name]["bound_ms"],
             "bound_by": "/".join(sorted(kern["main"][name]["bound_by"])),
             "library_ms": None}
            for name in ("lut_affine", "lut_affine_grouped")
        ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
