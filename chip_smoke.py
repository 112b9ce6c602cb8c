#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it end to end.

    python3 chip_smoke.py [--phases device,pack_kernel,kernel,serve,tl1_kernel,
                                    tl1_serve,moe_kernel,moe_serve,bmm_kernel,
                                    bmm_serve,paper]
                          [--iters 20]

Phases, one JSON object per line:

1. ``device``  the card, torch/CUDA versions, and the build of every
   kernel from ``src/repro_torch/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together).
1b. ``pack_kernel``  the packing kernel (``bitplane_pack``) against its
   plain version, bit for bit, in each of its three kinds: ``shift`` at
   the inputs of the weight cell (granite_8b) and the MoE cell
   (qwen2_moe_a2_7b), ``fixed`` 8/6 at the binary cell's, ``float16`` (off
   every served path) at granite_8b's widths; decode and prefill rows, fp32
   (the paths' dtype) and bf16 input.  Each with the kernel's time, the
   plain version's and the bound, beside the launch floor (a one-row,
   4-element pack of the same kind) and the ratio to it; per layer, the
   sum over the cell's packs.  Then a grid of every kind and radix, both
   dtypes, ragged ``q``, a base one element off, leading dims, rows past
   the grid's y limit and fp16 rounding's edge values.
2. ``kernel``  each weight-family kernel (``lut_affine``) against its
   plain PyTorch version on the card, at the main path's full-width
   granite_8b shapes (decode B = 4 and prefill B = 4 slots x 32 tokens) and
   on a grid of table types, shift_bits and ragged edges; with the
   kernel's time, the plain version's, the least time the card could take
   (``bound_ms``) and, for context, the dense bf16 matmul the tables
   replace; repeated split launches checked bit-identical, and ptxas's
   report of the dense kernels.
3. ``serve``   full-width granite_8b, depth cut to 4 layers, planned
   with the serving recipe, converted to i8 tables and served through
   ``BatchingEngine`` on the kernels (every projection's input packed by
   ``bitplane_pack``: ``plain_pack_codes_calls`` must be 0); then the same
   requests on the plain versions, whose ``pack_codes`` calls must equal
   the kernel run's packs, the prefill logits of both compared and every
   request's first token held equal.  The decode profiles count device
   kernels per step, with the graph, eager, and eager with the pack sites
   on the eager ``pack_codes`` (the packing before the kernel took it).
4. ``tl1_kernel``  each TL1 kernel (``lut_tl1``) against its plain
   version at the same full-width shapes and on a grid of int8/int4/exact
   fp32, ragged ``q`` and ``p``, leading dims and bias: int cases bit for
   bit, fp32 cases within 1e-5 x max|plain|; with ``torch._int_mm`` (a
   cuBLAS int8 GEMM over the unpacked ternary weights) as the library
   yardstick and an independent check of the integer accumulate.
5. ``tl1_serve``  full-width granite_8b at all 36 layers, planned into
   TL1 as the reference's ``serving_tl1_plan`` plans it (int8
   activations), converted, its fp32 weights freed, served through
   ``BatchingEngine`` on the kernels and then on the plain versions:
   every stream identical, prefill logits within 1e-5 x max|plain|.
6. ``moe_kernel``  the ragged MoE kernel (``lut_affine_experts``) against
   its plain version at full-width qwen2_moe_a2_7b expert shapes (60
   experts, top-4, expert width 1408; decode 4 tokens = 16 expert rows and
   prefill 128 tokens = 512 rows, routed by a seeded router; each line
   with the k ``splits`` the wrapper chose, the decode split launch
   repeated and checked bit-identical) and on a grid of table types,
   shift_bits, empty experts, ragged T and p, G 1/2/3 and a zero tail;
   then one decode-shaped ``moe_ffn`` on the kernels under
   ``torch.cuda.set_sync_debug_mode("error")``: no read-back may happen;
   last ptxas's report of the ragged kernel.
7. ``moe_serve``  full-width qwen2_moe_a2_7b, depth set by the card's
   memory (2 of 24 layers), planned by the serving recipe with
   ``convert_experts=True``, converted to i8 tables and served through
   ``BatchingEngine`` on the kernels, then on the plain versions: every
   first token identical, packs and prefill logits held as in ``serve``.
8. ``bmm_kernel``  the binary-matmul mode's two kernels against their
   plain versions at full-width granite_8b shapes (decode 4 rows x 8
   planes = 32 folded rows, prefill 128 rows = 1024 folded rows; W in bf16
   as the path holds it, an fp32 W's time beside it): ``bitplane_pack`` bit
   for bit, ``binary_matmul``
   within 1e-5 x max|plain|, with a cuBLAS bf16 GEMM of the folded planes
   (``torch.matmul``) as the library yardstick and the dense bf16 ``x @ W``
   the mode replaces for context; then a grid of plane counts, ragged
   ``q``/``p``, leading dims, bias, bf16 ``W`` and every packing mode.
9. ``bmm_serve``  full-width granite_8b at all 36 layers, its projection
   weights rounded once to bf16 (``models/params.py::bf16_projections``;
   prefill logits identical to the fp32 tree's on both paths, checked),
   served through ``BatchingEngine`` under
   ``ExecCfg(linear_mode="binary_matmul")``
   on the kernels (7 packs and 7 binary matmuls per layer and forward, no
   LUT kernel), then on the plain versions: every first token identical,
   prefill logits compared at several depths and held to BMM_LOGITS_TOL.
10. ``paper``  the paper's own networks at their published widths (the
   linear classifier, the 784-1024-512-10 MLP, LeNet by im2col), each
   trained on the card with the reference's recipe
   (``repro_torch.examples.tablenet_mnist.train``: 300 SGD steps of 128
   images at lr 0.3; LeNet, unstable there, also at lr 0.1, which is the
   one converted), its dense accuracy over 1500 held-out images and at input bits
   1..8; converted to unsigned fp16 bitplane tables (chunk 1 for all
   three, chunk 2 for the classifier and the MLP) and run over the same
   images on the kernels (one ``bitplane_pack`` and one ``lut_affine``
   launch per converted layer and forward, ``plain_pack_codes_calls`` 0)
   and on the plain versions: every layer within 1e-5 x max|plain| of its
   plain version on the same input, at least 499 of 500 argmaxes equal per
   batch, accuracies beside the dense model's on fp16-rounded inputs,
   table bytes, peak memory, the table copies of the 10-column heads (and
   the head's time with and without a pre-padded operand), and device ms
   and images/s at B = 500 of the kernel path, the plain path and the
   dense fp32 forward.  Then the classifier at the Fig. 5 fixed 3/3 plan,
   chunks 1 / 2 / 7 / 14, whose accuracy on 3-bit inputs must equal the
   dense model's on the same inputs within one image; then the TL1 rows of
   ``repro_torch.benchmarks.accuracy_vs_bits`` on ``lut_tl1``, against the
   plain version.

The four serve phases (3, 5, 7, 9) serve their requests on the kernels
with the engine's decode step captured as a CUDA graph and replayed (the
engine's default on the card, the main path) and eager
(``cuda_graph=False``), in turns: eager, graph, graph, eager, after one
untimed eager run (:func:`serve_paths`).  Each run must launch the
phase's kernels as often per forward as the eager step does (the replays
count what the capture recorded) and serve the same streams, whole; one
``graph_vs_eager`` line gives each path's median decode step, tok/s,
device kernels, busy ms and idle share per step (the decode profile of
each path: ``decode_profile`` with the graph, whose kernels the profiler
records per replay, beside the captured graph's nodes;
``decode_profile_eager`` without).  The plain versions run eager: they
copy host scales to the card inside the step, which a capture refuses.

Kernel and library times are device times (:func:`device_ms`): many
calls back to back between one pair of CUDA events, each call on its own
copy of the tables so that it reads them from HBM as serving does, held
behind a spin kernel until the host has enqueued them all.

Every path is driven with the kernels' launch counts set to 0 just before
it and read just after.  Then one ``kernels`` summary line (the row of
``bitplane_pack`` sums its launches over the four paths that pack,
``launches_by_path``, and times one binary-cell decode layer's 7 packs;
``lut_affine`` and ``lut_tl1`` add the paper networks' launches to their
serve phase's),
the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits non-zero
without that last line.  It exits non-zero at once when no CUDA device is
present.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores
# fp32 adds: one per fp32 lane (128 per SM) per clock; int32 adds: the 64
# INT32 lanes per SM each retire a three-input IADD3, two adds per clock
ADDS_PER_S = 128 * 132 * 1.98e9
L2_BYTES = 50 * 2**20  # H100 SXM
SPIN_CYCLES_PER_S = 1.98e9  # torch.cuda._sleep counts SM clock cycles
KERNEL_TOL = 1e-5  # x max|plain|: fp32 sums taken in another order
LOGITS_TOL = 5e-2  # x max|plain|, see the serve phase
LOGITS_FRO_TOL = 5e-2  # ||kernel - plain|| / ||plain|| over the prefill logits

# the serve phase: depth (cut by memory), requests, new tokens each
LAYERS, REQUESTS, MAX_NEW = 4, 8, 16
SLOTS, MAX_LEN, BUCKET = 4, 64, 32  # engine slots, cache length, prefill bucket
TL1_LAYERS = 36  # the published depth: TL1 tables take 52 MiB per layer
TL1_TOL = 1e-5  # x max|plain| on the exact fp32 path; the int path is exact
# the moe_serve phase: memory kept free beside the converted model (the
# plain path's 1 GiB gathers, the caches, the allocator's slack)
MOE_HEADROOM = 16 * 2**30
BF16_OPS_PER_S = 989e12  # H100 SXM, dense bf16 on the tensor cores
# the bmm_serve phase: the published depth (its fp32 weights take 30 GiB)
# and the prefill logits' tolerance (see bmm_serve_phase)
BMM_LAYERS = 36
BMM_DEPTHS = (1, 4, 12, 36)
BMM_LOGITS_TOL = 1e-1  # x max|plain|
BMM_LOGITS_FRO_TOL = 1e-1
BMM_FIXED = (8, 6)  # ExecCfg.fixed_bits / fixed_frac: signed 8/6 fixed point

# the pack_kernel phase: per cell, the model, the kind of its packs and
# its packed inputs: (input, width, rows at decode, rows at prefill, packs
# per layer); the float16 kind is on no served path
# the paper phase: each network's chunks (unsigned fp16 bitplane tables;
# LeNet's fc1 alone would take 26 GB of tables at chunk 2), the held-out
# batches of tablenet_mnist.accuracy, the least argmax agreement of the
# kernel path with the plain one per batch, the Fig. 5 plan's input bits
# and chunks, the TL1 rows' activation widths
PAPER_CHUNKS = {"linear": (1, 2), "mlp": (1, 2), "lenet": (1,)}
# each network's learning rates, the recipe's first; the last one's weights
# are converted.  LeNet's 0.3 is at the edge of stability: on the same seeds
# it collapsed to chance in the JAX package (CPU) and in the port on the
# card, and reached 0.82 in the port on the CPU; at 0.1 it trains in all three
PAPER_LR = {"linear": (0.3,), "mlp": (0.3,), "lenet": (0.3, 0.1)}
PAPER_BATCHES, PAPER_ROWS = 3, 500
PAPER_AGREE = 499
TL1_BATCHES = 4  # accuracy_vs_bits' 2000 held-out images, batches of 500
FIG5_BITS, FIG5_CHUNKS = 3, (1, 2, 7, 14)
TL1_ACT_BITS = (None, 8, 4, 2)
PACK_SERVED = {
    "weight": ("granite_8b", dict(kind="shift", m=1, signed=True, radix=4),
               [("d_model", 4096, 4, 128, 4), ("d_ff", 14336, 4, 128, 1)]),
    "moe": ("qwen2_moe_a2_7b", dict(kind="shift", m=1, signed=True, radix=4),
            [("d_model", 2048, 4, 128, 4), ("moe_d_ff", 1408, 16, 512, 1),
             ("shared_d_ff", 5632, 4, 128, 1)]),
    "binary": ("granite_8b", dict(kind="fixed", m=1, bits=BMM_FIXED[0], frac=BMM_FIXED[1],
                                  signed=True),
               [("d_model", 4096, 4, 128, 6), ("d_ff", 14336, 4, 128, 1)]),
    "float16": ("granite_8b", dict(kind="float16", m=1),
                [("d_model", 4096, 4, 128, 1), ("d_ff", 14336, 4, 128, 1)]),
}
# fp16 rounding's edges: +-0, subnormals (the smallest, ties to 0 and up),
# the smallest normal, RNE ties at 1, 65504, the overflow tie, +-inf
PACK_EDGES = [0.0, -0.0, 2.0**-24, -(2.0**-24), 2.0**-25, 3 * 2.0**-26, 2.0**-26,
              2.0**-14 - 2.0**-24, 2.0**-14, 1 + 2.0**-11, 1 + 3 * 2.0**-11, 65504.0,
              65519.996, 65520.0, -65520.0, 1e6, float("inf"), float("-inf"), -3.0, 0.5]

# main-path shapes of full-width granite_8b: name -> (G, k, p)
LONE = {"wq": (1, 4096, 4096), "wo": (1, 4096, 4096), "w_down": (1, 14336, 4096)}
GROUPED = {"wk+wv": (2, 4096, 1024), "w_gate+w_up": (2, 4096, 14336)}
# the binary-matmul path's projections: name -> (q, p, calls per layer)
BMM_SHAPES = {"wq|wo": (4096, 4096, 2), "wk|wv": (4096, 1024, 2),
              "w_gate|w_up": (4096, 14336, 2), "w_down": (14336, 4096, 1)}
SOURCES = {
    "lut_affine": "src/repro_torch/csrc/lut_affine.cu",
    "lut_affine_grouped": "src/repro_torch/csrc/lut_affine.cu",
    "lut_tl1": "src/repro_torch/csrc/lut_tl1.cu",
    "lut_tl1_grouped": "src/repro_torch/csrc/lut_tl1.cu",
    "lut_affine_experts": "src/repro_torch/csrc/lut_affine.cu",
    "binary_matmul": "src/repro_torch/csrc/binary_matmul.cu",
    "bitplane_pack": "src/repro_torch/csrc/bitplane_pack.cu",
}
REPLACES = {
    "lut_affine": "src/repro/kernels/lut_affine/lut_affine.py:275",
    "lut_affine_grouped": "src/repro/kernels/lut_affine/lut_affine.py:239",
    "lut_tl1": "src/repro/kernels/lut_tl1/lut_tl1.py:125",
    "lut_tl1_grouped": "src/repro/kernels/lut_tl1/lut_tl1.py:154",
    "lut_affine_experts": "src/repro/kernels/lut_affine/lut_affine.py:181",
    "binary_matmul": "src/repro/kernels/binary_matmul/binary_matmul.py:47",
    "bitplane_pack": "src/repro/kernels/bitplane_pack/bitplane_pack.py:56",
}


def ptxas_report(log: str) -> dict:
    """ptxas -v's report per kernel: registers, static shared memory, stack
    frame and spill bytes (dynamic shared memory is set at launch and
    reported beside it)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", ln)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        row = out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            row["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            row["static_smem"] = int(sm.group(1)) if sm else 0
    return {k: v for k, v in out.items() if "registers" in v}


def sass_loops(lib_path, kernels=("decode_kernel", "prefill_kernel", "experts_kernel")) -> dict:
    """Per named kernel of a built library (cuobjdump -sass): the innermost
    loop holding byte permutes (the span of a backward branch) -- its
    instructions, PRMTs and FADDs, and instructions per PRMT, which on the
    integer magic path is instructions per gathered entry."""
    from repro_torch.kernels import build

    exe = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for func, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S):
        if not any(k in func for k in kernels):
            continue
        ins = [(int(a, 16), t.strip())
               for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        best = None
        for a, t in ins:
            m = re.search(r"\bBRA\b[^0-9]*(0x[0-9a-f]+)", t)
            if not m or int(m.group(1), 16) > a:
                continue
            span = [x[1] for x in ins if int(m.group(1), 16) <= x[0] <= a]
            prmt = sum(" PRMT " in f" {x} " or x.startswith("PRMT") for x in span)
            if prmt and (best is None or len(span) < best["instructions"]):
                fadd = sum(re.search(r"(^|\s)FADD", x) is not None for x in span)
                best = {"instructions": len(span), "prmt": prmt, "fadd": fadd,
                        "per_prmt": len(span) / prmt}
        out[func] = best
    return out


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fns, iters: int, warmup: int = 2, hold: bool = True) -> float:
    """Time of one call: ``iters`` calls of ``fns`` (cycled, so that each
    can read its own copy of the operands, see :func:`copies_of`) back to
    back between one pair of CUDA events, over the count, after ``warmup``
    untimed calls.

    With ``hold``, a spin kernel keeps the stream busy until the host has
    enqueued every call, so the reading is the device's time alone and not
    the host's enqueue (allocation, the ctypes call); it is checked that
    the device had not reached the first event when the host was done.
    Without it (the plain versions, hundreds of small launches per call at
    prefill, more than the stream's queue holds) the reading includes the
    host's enqueue wherever that outlasts the device's work."""
    import torch

    fns = list(fns)
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fns[0]()
    torch.cuda.synchronize()
    spin_s = 2 * iters * (time.perf_counter() - t0) + 1e-3  # host + device, with room
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        a.record()
        for i in range(iters):
            fns[i % len(fns)]()
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead or not hold:
            return a.elapsed_time(b) / iters
        spin_s *= 4
    raise AssertionError("the host did not get ahead of the device; timing refused")


def copies_of(t) -> list:
    """``t`` and enough copies of it that together they hold twice the L2:
    between two reads of one copy the others stream more than the L2
    holds (or ``t`` alone exceeds it), so every timed call finds its
    operand in HBM, as the main path does, which reads each layer's tables
    once per step."""
    n = min(64, max(1, -(-2 * L2_BYTES // max(1, t.numel() * t.element_size()))))
    return [t] + [t.clone() for _ in range(n - 1)]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def bound(codes, G, E, p, itemsize, shift_bits, expert_of=None):
    """Least time for the card: the table rows this run's codes touch (each
    read once), the codes and the output, over HBM bandwidth; or the
    shift + add per gathered element over the fp32 rate.  ``expert_of``
    (the ragged MoE form) gives each code row's expert: a row is then
    keyed by (expert, chunk, index)."""
    import torch

    B, n, k = codes.shape
    idx = codes & (E - 1) if shift_bits else codes
    chunk = torch.arange(k, device=codes.device, dtype=torch.int64)
    key = chunk * E + idx.to(torch.int64)
    if expert_of is not None:
        key = key + expert_of.to(torch.int64)[:, None, None] * (k * E)
    rows = torch.unique(key).numel()
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

    def kern(t=tables):
        if name == "lut_affine":
            return ops.lut_affine(codes, t[0], scales, shift_bits=shift_bits)
        return ops.lut_affine_grouped(codes, t, scales, shift_bits=shift_bits)

    def plain():
        if name == "lut_affine":
            return ops.lut_affine(
                codes, tables[0], scales, shift_bits=shift_bits, use_kernels=False
            )
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
    ms = device_ms([functools.partial(kern, c) for c in copies_of(tables)], iters)
    plain_ms = device_ms([plain], plain_iters, warmup=1, hold=False)
    calls = 1 if name == "lut_affine" else G
    bms, by = bound(codes, calls, E, p, tables.element_size(), shift_bits)
    lib_ms = device_ms([lib_fn], iters) if lib_fn is not None else None
    t = lut_tiling(name, codes, tables)
    return {
        "regime": t.regime, "splits": t.splits,
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
    return device_ms(
        [functools.partial(lambda w: [x @ w[g] for g in range(G)], c) for c in copies_of(ws)],
        iters,
    )


def kernel_phase(iters: int, prefill_rows: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.lut import LUTPlan, pack_codes, plane_scales
    from repro_torch.core.quantize import Float16Format
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_affine import ops

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
                m = main.setdefault(
                    name,
                    {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": set(),
                     "prefill_ms": 0.0, "prefill_bound_ms": 0.0},
                )
                if rows == 4:
                    for key in ("kernel_ms", "plain_ms", "bound_ms"):
                        m[key] += r[key]
                    m["bound_by"].add(r["bound_by"])
                else:  # the engine's prefill: per call, summed over the layer's calls
                    m["prefill_ms"] += r["kernel_ms"]
                    m["prefill_bound_ms"] += r["bound_ms"]
                if rows == 4 and proj in ("wq", "w_gate+w_up"):
                    fn = ops.lut_affine if name == "lut_affine" else ops.lut_affine_grouped
                    determinism("kernel", name, functools.partial(
                        fn, c, t[0] if name == "lut_affine" else t, s,
                        shift_bits=plan.shift_bits),
                        {"rows": rows, "k": k, "p": p, "splits": r["splits"]})
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
        # the prefill kernel: a ragged 64-row tile, ragged slabs, i16 / f32
        (129, 3, 40, 32, 1000, 2, torch.int8, 5, [2.0**-6, 2.0**-4, -(2.0**-2)]),
        (70, 1, 24, 64, 4100, 1, torch.int16, 5, [2.0**-3]),
        (65, 3, 17, 16, 513, 3, torch.float32, 0, [1.0, 2.0, -4.0]),
    ]
    for B, n, k, E, p, G, dtype, shift, scales in grid:
        c, t, s = make_case(gen, B, n, k, E, p, G, dtype, shift, np.asarray(scales, np.float32))
        if p == 4100:  # tables at an odd base, which the wrapper copies first
            flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=DEV)
            flat[1:] = t.reshape(-1)
            t = flat[1:].reshape(t.shape)
        for name in ("lut_affine", "lut_affine_grouped"):
            lib = embedding_bag_fn(c, t[:1] if name == "lut_affine" else t, s, shift) \
                if dtype == torch.float32 else None
            r = run_case(name, c, t, s, shift, iters, 5, lib_fn=lib)
            emit({"phase": "kernel", "kernel": name, "grid": True, "rows": B,
                  "G": G if name != "lut_affine" else 1, "n": n, "k": k, "E": E, "p": p,
                  "table": str(dtype).replace("torch.", ""), "shift_bits": shift, **r})
    emit({"phase": "kernel", "step": "ptxas",
          "kernels": {k: v for k, v in ptxas_report(build.BUILD_LOG.get("lut_affine", "")).items()
                      if "decode" in k or "prefill" in k}})
    return {"worst": worst, "main": main}


def lut_tiling(name, codes, tables):
    """The dense launch's kernel and grid for these operands (ops.tiling on
    the row pitch the kernels read)."""
    import torch

    from repro_torch.kernels.lut_affine import ops

    G, k, E, p = tables.shape
    B, n, _ = codes.shape
    vec = ops.ROW_ALIGN // tables.element_size()
    row_bytes = -(-p // vec) * vec * tables.element_size()
    return ops.tiling(1 if name == "lut_affine" else G, B, n, k, E, row_bytes,
                      torch.cuda.get_device_properties(0).multi_processor_count)


def determinism(phase, name, call, fields, repeats: int = 4) -> None:
    """Repeated launches of one case give equal bits (the split sums run in
    a fixed order)."""
    import torch

    outs = [call() for _ in range(repeats)]
    same = all(torch.equal(o, outs[0]) for o in outs[1:])
    emit({"phase": phase, "step": "determinism", "kernel": name, **fields, "repeats": repeats,
          "bit_identical": same})
    if not same:
        raise AssertionError(f"{name}: repeated launches differ")


# ---------------------------------------------------------------------------
# serve phase
# ---------------------------------------------------------------------------


def serve_phase(layers: int, requests: int, max_new: int) -> dict:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward, model_specs
    from repro_torch.models.params import init_params
    from repro_torch.serve import make_cache

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

    prompts = serve_requests(cfg, requests)
    # one pack per lone projection and group: wq, wk+wv, wo, w_gate+w_up, w_down
    per_forward = {"lut_affine": 3 * layers, "lut_affine_grouped": 2 * layers,
                   "bitplane_pack": 5 * layers}
    reqs, eng, wall, decode_ms, launches, uncovered = serve_paths(
        "serve", lut, cfg, prompts, max_new, per_forward, eager_pack_profile=True)
    forwards = eng.readbacks
    expect = {**no_launches(), **{k: v * forwards for k, v in per_forward.items()}}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "serve", "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": per_forward, "plain_pack_codes_calls": uncovered,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or forwards <= 0 or uncovered:
        raise AssertionError(f"launch counts {launches} != expected {expect}, "
                             f"or {uncovered} packs off the kernel")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new")

    with count_plain_packs() as packs:
        plain_reqs, _, plain_wall, plain_decode = run_engine(lut, cfg, prompts, max_new,
                                                             False, cuda_graph=False)
    first_ok = all(a.generated[0] == b.generated[0] for a, b in zip(reqs, plain_reqs))
    same = sum(
        x == y for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)
    )
    emit({"phase": "serve", "step": "plain", "tok_per_s": tokens / plain_wall,
          "median_decode_step_ms": statistics.median(plain_decode),
          "first_tokens_identical": first_ok, "identical_token_share": same / tokens,
          "pack_codes_calls": packs["calls"]})
    if not first_ok:
        raise AssertionError("kernel and plain paths disagree on a first token")
    if packs["calls"] != launches["bitplane_pack"]:
        raise AssertionError(f"the plain run packed {packs['calls']} times, the kernel run "
                             f"{launches['bitplane_pack']}")

    # one prefill batch, both paths, fresh caches; first at every depth up to
    # the served one, to show how the paths' difference grows layer by layer
    inputs = prefill_inputs(prompts)

    def prefill_logits(depth: int, use_kernels: bool):
        dcfg = dataclasses.replace(cfg, num_layers=depth)
        params = dict(lut, blocks=first_layers(lut["blocks"], depth))
        ctx = Ctx(dcfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        cache = make_cache(dcfg, SLOTS, MAX_LEN, ctx, device=DEV)
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


def _launch_counts() -> tuple:
    from repro_torch.kernels.binary_matmul import ops as bmm_ops
    from repro_torch.kernels.bitplane_pack import ops as pack_ops
    from repro_torch.kernels.lut_affine import ops
    from repro_torch.kernels.lut_tl1 import ops as tl1_ops

    return ops.LAUNCHES, tl1_ops.LAUNCHES, pack_ops.LAUNCHES, bmm_ops.LAUNCHES


def reset_launches() -> None:
    """Every kernel's launch count, the count of packs off the kernel and
    the count of table copies before a launch, to 0."""
    from repro_torch.kernels.common import launch_counters

    for counts in launch_counters():
        counts.update(dict.fromkeys(counts, 0))


def plain_pack_codes_calls() -> int:
    """Packs since :func:`reset_launches` of plans the packing kernel does
    not implement (``pack_codes`` on the card)."""
    from repro_torch.kernels.bitplane_pack import ops as pack_ops

    return pack_ops.PLAIN_CALLS["pack_codes"]


@contextlib.contextmanager
def count_plain_packs():
    """Count, inside a ``with`` block, the packs the plain versions make
    (``ref.py``'s, and ``pack_codes`` for the plans the kernel does not
    implement)."""
    from repro_torch.kernels.bitplane_pack import ops

    n = {"calls": 0}
    saved = ops.bitplane_pack_ref, ops.pack_codes

    def counted(fn):
        def call(*args, **kw):
            n["calls"] += 1
            return fn(*args, **kw)

        return call

    ops.bitplane_pack_ref, ops.pack_codes = (counted(fn) for fn in saved)
    try:
        yield n
    finally:
        ops.bitplane_pack_ref, ops.pack_codes = saved


@contextlib.contextmanager
def eager_pack():
    """The model's pack sites on the eager ``core/lut.py::pack_codes`` (the
    packing before the kernel took it) inside a ``with`` block."""
    from repro_torch.core.lut import pack_codes
    from repro_torch.models import layers, moe

    saved = layers.pack, moe.pack

    def plain(x, plan, use_kernels=True):
        return pack_codes(x, plan)

    layers.pack = moe.pack = plain
    try:
        yield
    finally:
        layers.pack, moe.pack = saved


PATH_ORDER = (False, True, True, False)  # eager, graph, graph, eager


def serve_paths(phase, params, cfg, prompts, max_new, per_forward, eager_pack_profile=False,
                **ex):
    """Serve ``prompts`` on the kernels with the decode step eager and as
    CUDA graph replays, in turns (PATH_ORDER, after one untimed eager run
    that takes the process's first-use costs off the first timed run), each
    run's launch counts set to 0 just before it and read just after: every
    run must launch
    ``per_forward`` of each kernel per forward (replays count what the
    capture recorded), pack nothing off the kernel, and serve the same
    streams, whole.  Then the decode profile of each path (and, with
    ``eager_pack_profile``, of the eager step with the pack sites on eager
    ``pack_codes``), one ``graph_vs_eager`` line, and the first graph run
    (the main path) returned as (requests, engine, wall s, decode step ms,
    launches, packs off the kernel)."""
    import torch

    run_engine(params, cfg, prompts, max_new, True, cuda_graph=False, **ex)
    runs = []
    for graph in PATH_ORDER:
        reset_launches()
        reqs, eng, wall, decode_ms = run_engine(params, cfg, prompts, max_new, True,
                                                cuda_graph=graph, **ex)
        launches, uncovered = read_launches(), plain_pack_codes_calls()
        expect = {**no_launches(), **{k: v * eng.readbacks for k, v in per_forward.items()}}
        if launches != expect or uncovered or eng.readbacks <= 0:
            raise AssertionError(f"{phase} ({'graph' if graph else 'eager'}): launch counts "
                                 f"{launches} != expected {expect}, or {uncovered} packs off "
                                 "the kernel")
        if eng.cuda_graph is not graph or (graph and eng._graph is None):
            raise AssertionError(f"{phase}: the engine did not run the step as asked "
                                 f"(cuda_graph {graph})")
        runs.append({"reqs": reqs, "eng": eng, "wall": wall, "decode_ms": decode_ms,
                     "launches": launches, "uncovered": uncovered})
    streams = [[r.generated for r in run["reqs"]] for run in runs]
    identical = all(s == streams[0] for s in streams)
    sub = prompts[:SLOTS]
    profiles = {"graph": profile_decode(params, cfg, sub, max_new, cuda_graph=True, **ex),
                "eager": profile_decode(params, cfg, sub, max_new, cuda_graph=False, **ex)}
    emit({"phase": phase, "step": "decode_profile", **profiles["graph"]})
    emit({"phase": phase, "step": "decode_profile_eager", **profiles["eager"]})
    if eager_pack_profile:
        with eager_pack():
            packs = profile_decode(params, cfg, sub, max_new, cuda_graph=False, **ex)
        emit({"phase": phase, "step": "decode_profile_eager_pack", **packs,
              "device_kernels_removed_per_step": packs["device_kernels_per_step"]
              - profiles["eager"]["device_kernels_per_step"],
              "busy_ms_saved_per_step": packs["busy_ms_per_step"]
              - profiles["eager"]["busy_ms_per_step"]})
    tokens = sum(len(r.generated) for r in runs[0]["reqs"])
    paths = {}
    for name, graph in (("eager", False), ("graph", True)):
        mine = [run for run, g in zip(runs, PATH_ORDER) if g is graph]
        steps = [ms for run in mine for ms in run["decode_ms"]]
        prof = profiles[name]
        paths[name] = {
            "median_decode_step_ms": statistics.median(steps),
            "median_decode_step_ms_by_run": [statistics.median(r["decode_ms"]) for r in mine],
            "tok_per_s": tokens * len(mine) / sum(r["wall"] for r in mine),
            "tok_per_s_by_run": [tokens / r["wall"] for r in mine],
            # the graph's: its capture and first replay
            "second_decode_step_ms_by_run": [r["decode_ms"][0] for r in mine],
            "device_kernels_per_step": prof["device_kernels_per_step"],
            "busy_ms_per_step": prof["busy_ms_per_step"],
            "idle_share": prof["idle_share"],
            "profiled_wall_ms_per_step": prof["wall_ms_per_step"],
            # the profiler slows the host: the share of the timed median step
            # that the profiled busy time leaves idle
            "idle_share_at_median_step": 1.0 - prof["busy_ms_per_step"]
            / statistics.median(steps),
        }
    emit({"phase": phase, "step": "graph_vs_eager",
          "order": ["graph" if g else "eager" for g in PATH_ORDER], "tokens": tokens,
          "forwards": runs[1]["eng"].readbacks, "streams_identical": identical, **paths,
          "median_step_ratio_eager_over_graph": paths["eager"]["median_decode_step_ms"]
          / paths["graph"]["median_decode_step_ms"],
          "graph_nodes": profiles["graph"]["graph_nodes"],
          "nvidia_smi": smi_line(),
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if not identical:
        raise AssertionError(f"{phase}: the graph and eager runs served different streams")
    main = runs[1]
    return (main["reqs"], main["eng"], main["wall"], main["decode_ms"], main["launches"],
            main["uncovered"])


def read_launches() -> dict:
    return {k: v for counts in _launch_counts() for k, v in counts.items()}


def no_launches() -> dict:
    """Every kernel's name with a count of 0 (what a path that does not run
    a kernel expects of it)."""
    return dict.fromkeys(read_launches(), 0)


def serve_requests(cfg, requests: int):
    """The serve phases' requests: prompts of 8..32 tokens from a seed."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [
        rng.integers(0, cfg.vocab_size, int(rng.integers(8, 33))).astype(np.int32)
        for _ in range(requests)
    ]


def run_engine(params, cfg, prompts, max_new: int, use_kernels: bool, cuda_graph=None, **ex):
    """Serve ``prompts`` through ``BatchingEngine`` (SLOTS slots, grouped
    launches, ``ex`` further ExecCfg fields) on the kernels or the plain
    versions, the decode step as graph replays (the engine's default on the
    card) or eager (``cuda_graph=False``; the plain versions copy host
    scales to the card in the step, which a capture refuses); returns the
    requests, the engine, the wall seconds and each pure decode step's ms."""
    import torch

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request

    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels, **ex))
    eng = BatchingEngine(params, ctx, SLOTS, MAX_LEN, prefill_bucket=BUCKET, device=DEV,
                         cuda_graph=cuda_graph)
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
    return reqs, eng, time.perf_counter() - start, decode_ms


def prefill_inputs(prompts):
    """The first SLOTS prompts right-padded into one masked prefill batch."""
    import numpy as np
    import torch

    tok = np.zeros((SLOTS, BUCKET), np.int32)
    mask = np.zeros((SLOTS, BUCKET), bool)
    for i in range(SLOTS):
        tok[i, : len(prompts[i])] = prompts[i]
        mask[i, : len(prompts[i])] = True
    return {"tokens": torch.from_numpy(tok).to(DEV),
            "token_mask": torch.from_numpy(mask).to(DEV)}


# ---------------------------------------------------------------------------
# TL1 kernel phase
# ---------------------------------------------------------------------------


def tl1_bound(G, B, kb, p):
    """Least time for the card: the packed tables, the codes and the output
    once over HBM bandwidth; or the adds over the add rate.  The least work
    is one add per packed byte per column (an 81-entry LUT per packed byte,
    i.e. per pair of pairs), plus building those LUTs: the two 9-entry pair
    LUTs and the 81 entries, one add each, per token and packed byte."""
    nbytes = G * kb * p + B * 4 * kb * 4 + G * B * p * 4
    ops = G * B * kb * p + B * kb * (2 * 9 + 81)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ADDS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def int_mm_fn(codes, tables):
    """One cuBLAS call computing the same int32 accumulate: ``_int_mm`` of
    the int8 codes (rows padded to 32, as it takes no fewer than 17) and
    the unpacked int8 ternary weights of all G members side by side,
    stored column-major.
    Returns ``(calls, result reshaped to (G, B, p))``, one call for each of
    :func:`copies_of` the weights; ``(None, None)`` where ``_int_mm``
    refuses the shape."""
    import torch

    from repro_torch.core.lut_tl1 import unpack_indices

    G, kb, p = tables.shape
    B = codes.shape[0]
    if p % 8 or kb % 2 or codes.is_floating_point():  # _int_mm: dims multiples of 8
        return None, None
    idx = unpack_indices(tables)  # (G, 2kb, p): pair j covers elements 2j, 2j+1
    t = torch.stack([idx // 3 - 1, idx % 3 - 1], dim=2).reshape(G, 4 * kb, p)
    # column-major, the layout cuBLAS's int8 tensor-core GEMM takes as is
    w = t.to(torch.int8).permute(1, 0, 2).reshape(4 * kb, G * p).t().contiguous().t()
    rows = max(32, -(-B // 8) * 8)
    a = torch.zeros((rows, 4 * kb), dtype=torch.int8, device=codes.device)
    a[:B] = codes.to(torch.int8)
    calls = [functools.partial(torch._int_mm, a, c) for c in copies_of(w)]
    return calls, calls[0]()[:B].reshape(B, G, p).permute(1, 0, 2)


def run_tl1_case(name, acts, act_scale, tables, scale, bias, iters, plain_iters, plan):
    """Kernel vs plain on one case under ``plan`` (which sets the kernel's
    entry width): the int path bit for bit (raw accumulate and dequantized
    output), the fp32 path within TL1_TOL x max|plain|; then the kernel's,
    the plain version's and ``_int_mm``'s times."""
    import torch

    from repro_torch.kernels.lut_tl1 import ops
    from repro_torch.kernels.lut_tl1.ref import lut_tl1_grouped_ref

    G, kb, p = tables.shape
    exact = not acts.is_floating_point()
    if name == "lut_tl1":
        got = ops.lut_tl1(acts, tables[0], act_scale, scale[0], bias=bias[0], plan=plan)[None]
        want = ops.lut_tl1(
            acts, tables[0], act_scale, scale[0], bias=bias[0], use_kernels=False
        )[None]
    else:
        got = ops.lut_tl1_grouped(acts, tables, act_scale, scale, biases=bias, plan=plan)
        want = ops.lut_tl1_grouped(
            acts, tables, act_scale, scale, biases=bias, use_kernels=False
        )
    flat = acts.reshape(-1, acts.shape[-1])
    B = flat.shape[0]
    raw = ops._launch(name, flat, tables, plan)
    torch.cuda.synchronize()
    raw_plain = lut_tl1_grouped_ref(flat, tables)
    err = max((got - want).abs().max().item(), (raw - raw_plain).abs().max().item())
    scale_ref = want.abs().max().item()
    tol = 0.0 if exact else TL1_TOL * scale_ref
    if not (err <= tol and torch.isfinite(got).all().item()):
        raise AssertionError(f"{name} B={B} kb={kb} p={p} G={G}: err {err} > tol {tol}")
    lib, lib_out = int_mm_fn(flat, tables)
    if lib_out is not None and not torch.equal(lib_out, raw):
        raise AssertionError(f"{name} B={B} kb={kb} p={p}: _int_mm disagrees with the kernel")
    del got, want, raw, raw_plain, lib_out
    ms = device_ms(
        [functools.partial(ops._launch, name, flat, t, plan) for t in copies_of(tables)], iters
    )
    plain_ms = device_ms(
        [lambda: lut_tl1_grouped_ref(flat, tables)], plain_iters, warmup=1, hold=False
    )
    lib_ms = device_ms(lib, iters) if lib is not None else None
    bms, by = tl1_bound(G, B, kb, p)
    return {
        "max_abs_err": err, "tol": tol,
        "tol_reason": "int path: integer accumulate, bit for bit" if exact
        else f"{TL1_TOL} x max|plain|: fp32 sums in another order",
        "int_mm_agrees": None if lib is None else True,
        "entry": ops.entry_format(plan, not exact),
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms,
    }


def tl1_kernel_phase(iters: int, prefill_rows: int) -> dict:
    import torch

    from repro_torch.core.lut_tl1 import TL1Plan, build_tl1_tables, quantize_acts

    gen = torch.Generator(device=DEV).manual_seed(2)
    worst = {"lut_tl1": 0.0, "lut_tl1_grouped": 0.0}
    main = {}  # decode-shape numbers per kernel, summed over one layer's calls
    for rows in (4, prefill_rows):
        for name, shapes in (("lut_tl1", LONE), ("lut_tl1_grouped", GROUPED)):
            for proj, (G, q, p) in shapes.items():
                plan = TL1Plan(q, p, act_bits=8)
                built = [
                    build_tl1_tables(torch.randn(q, p, generator=gen, device=DEV))
                    for _ in range(G)
                ]
                tables = torch.stack([t for t, _ in built])
                scale = torch.stack([s for _, s in built])
                bias = torch.randn(G, p, generator=gen, device=DEV)
                x = torch.randn(rows, q, generator=gen, device=DEV)
                codes, act_scale = quantize_acts(x, plan)
                r = run_tl1_case(name, codes, act_scale, tables, scale, bias, iters,
                                 5 if rows > 4 else 10, plan)
                emit({"phase": "tl1_kernel", "kernel": name, "proj": proj, "rows": rows,
                      "G": G, "q": q, "kb": plan.packed_chunks, "p": p, "act_bits": 8, **r})
                worst[name] = max(worst[name], r["max_abs_err"])
                if rows == 4:
                    m = main.setdefault(name, {"kernel_ms": 0.0, "plain_ms": 0.0,
                                               "bound_ms": 0.0, "library_ms": 0.0,
                                               "bound_by": set()})
                    for key in ("kernel_ms", "plain_ms", "bound_ms", "library_ms"):
                        m[key] += r[key]
                    m["bound_by"].add(r["bound_by"])
                del tables, built, codes
                torch.cuda.empty_cache()
    # grid: int8 / int4 / exact fp32 codes, ragged q (zero-padded tail),
    # p off the 1024-column tile and off 4, leading dims, few packed rows,
    # packed rows around the 64-row stage of the int16 entries, G = 3; the
    # first token's codes at +-qa, where folded entries are largest
    grid = [
        # lead, kb, p, G
        ((2, 5), 77, 130, 2),
        ((3,), 50, 67, 2),
        ((40,), 9, 256, 2),
        ((1,), 300, 1000, 1),
        ((4,), 63, 1030, 3),
        ((9,), 65, 2100, 2),
        ((4,), 129, 513, 3),
    ]
    for act_bits in (8, 4, None):
        for lead, kb, p, G in grid:
            q = 4 * kb - 3
            if act_bits is None:
                acts = torch.randn(lead + (4 * kb,), generator=gen, device=DEV)
                act_scale = None
            else:
                qa = 2 ** (act_bits - 1) - 1
                acts = torch.randint(-qa, qa + 1, lead + (4 * kb,), generator=gen,
                                     device=DEV, dtype=torch.int32)
                act_scale = torch.rand(lead + (1,), generator=gen, device=DEV)
                first = acts.view(-1, 4 * kb)[0]
                first.copy_(torch.where(first < 0, -qa, qa))
            acts[..., q:] = 0
            nib = torch.randint(0, 9, (G, kb, p, 2), generator=gen, device=DEV)
            tables = (nib[..., 0] | (nib[..., 1] << 4)).to(torch.uint8)
            scale = torch.rand(G, generator=gen, device=DEV)
            bias = torch.randn(G, p, generator=gen, device=DEV)
            for name in ("lut_tl1", "lut_tl1_grouped"):
                t, s, b = (tables[:1], scale[:1], bias[:1]) if name == "lut_tl1" \
                    else (tables, scale, bias)
                r = run_tl1_case(name, acts, act_scale, t, s, b, iters, 5,
                                 TL1Plan(q, p, act_bits=act_bits))
                emit({"phase": "tl1_kernel", "kernel": name, "grid": True,
                      "lead": list(lead), "G": t.shape[0], "q": q, "kb": kb, "p": p,
                      "act_bits": act_bits, **r})
    return {"worst": worst, "main": main}


# ---------------------------------------------------------------------------
# TL1 serve phase
# ---------------------------------------------------------------------------


def tl1_serve_phase(layers: int, requests: int, max_new: int) -> dict:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward, model_specs
    from repro_torch.models.params import init_params
    from repro_torch.serve import make_cache

    full = get_config("granite_8b")
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), gen, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the reference's serving_tl1_plan: every projection into TL1, int8
    # activations (its TPU block sizes are the port's own business)
    mplan = plan_model(params, float("inf"), families=("tl1",))
    emit({"phase": "tl1_serve", "step": "plan", "summary": mplan.summary(),
          "families": list(mplan.families), "table_mib": mplan.total_lut_bytes / 2**20,
          "table_mib_per_layer": mplan.total_lut_bytes / layers / 2**20,
          "act_bits": sorted({p.act_bits for p in mplan.layers.values()}),
          "depth": {"layers": layers, "published": full.num_layers},
          "init_seconds": init_s})
    t0 = time.perf_counter()
    tl1, report = convert_params(params, plan=mplan)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    peak_convert = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()
    emit({"phase": "tl1_serve", "step": "convert", "summary": conversion_summary(report),
          "seconds": convert_s, "max_memory_allocated_gib": peak_convert,
          "table_bytes": report.table_bytes, "planned_fp32_gib": report.weight_bytes / 2**30,
          "memory_allocated_after_free_gib": torch.cuda.memory_allocated() / 2**30})
    if report.table_bytes != mplan.total_lut_bytes:
        raise AssertionError(f"tables {report.table_bytes} B != plan {mplan.total_lut_bytes} B")

    prompts = serve_requests(cfg, requests)
    torch.cuda.reset_peak_memory_stats()
    per_forward = {"lut_tl1": 3 * layers, "lut_tl1_grouped": 2 * layers}
    reqs, eng, wall, decode_ms, launches, _ = serve_paths(
        "tl1_serve", tl1, cfg, prompts, max_new, per_forward)
    forwards = eng.readbacks
    expect = {**no_launches(), **{k: v * forwards for k, v in per_forward.items()}}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "tl1_serve", "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": per_forward,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or forwards <= 0:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new")

    plain_reqs, _, plain_wall, plain_decode = run_engine(tl1, cfg, prompts, max_new, False,
                                                         cuda_graph=False)
    same = sum(
        x == y for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)
    )
    identical = all(a.generated == b.generated for a, b in zip(reqs, plain_reqs))
    emit({"phase": "tl1_serve", "step": "plain", "layers": layers,
          "tok_per_s": tokens / plain_wall, "wall_s": plain_wall,
          "median_decode_step_ms": statistics.median(plain_decode),
          "streams_identical": identical, "identical_token_share": same / tokens})
    if not identical:
        raise AssertionError("kernel and plain paths disagree on a TL1 stream")

    inputs = prefill_inputs(prompts)

    def prefill_logits(use_kernels: bool):
        ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        cache = make_cache(cfg, SLOTS, MAX_LEN, ctx, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(tl1, inputs, ctx, cache=cache)
        return logits[inputs["token_mask"]]

    got, ref = prefill_logits(True), prefill_logits(False)
    err = (got - ref).abs().max().item()
    tol = TL1_TOL * ref.abs().max().item()
    finite = bool(torch.isfinite(got).all().item())
    emit({"phase": "tl1_serve", "step": "prefill_logits", "layers": layers,
          "shape": list(got.shape), "max_abs_err": err, "max_abs_ref": ref.abs().max().item(),
          "tol": tol, "finite": finite,
          "argmax_agree": (got.argmax(-1) == ref.argmax(-1)).float().mean().item(),
          "tol_reason": f"{TL1_TOL} x max|plain|; the integer TL1 accumulate makes both "
                        "paths compute the same values, so 0 is expected"})
    if not (finite and err <= tol):
        raise AssertionError(f"TL1 prefill logits differ: {err} > {tol}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# MoE kernel phase
# ---------------------------------------------------------------------------


def moe_fmt_plan(k, p):
    """The serving plan of every qwen2_moe_a2_7b projection at full width."""
    from repro_torch.core.lut import LUTPlan
    from repro_torch.core.quantize import Float16Format

    fmt = Float16Format(signed=True, mantissa_radix=4)
    return LUTPlan(k, p, 1, fmt, mode="bitplane_shift", table_format="i8")


def sorted_expert_of(gs, T):
    """(T,) expert of each expert-sorted row (measurement helper)."""
    import torch

    return torch.repeat_interleave(
        torch.arange(gs.numel(), device=gs.device), gs, output_size=T
    )


def run_experts_case(codes, tables, scales, gs, shift_bits, iters, plain_iters):
    """Kernel vs plain on one ragged case, then the kernel's device time,
    the plain version's time and the bound."""
    import torch

    from repro_torch.kernels.lut_affine import ops

    E, G, k, En, p = tables.shape
    T = codes.shape[0]

    def kern(t=tables):
        return ops.lut_affine_experts(codes, t, scales, gs, shift_bits=shift_bits)

    def plain():
        return ops.lut_affine_experts(
            codes, tables, scales, gs, shift_bits=shift_bits, use_kernels=False
        )

    got = kern()
    torch.cuda.synchronize()
    ref = plain()
    err = (got - ref).abs().max().item() if got.numel() else 0.0
    tol = KERNEL_TOL * (ref.abs().max().item() if ref.numel() else 0.0)
    live = int(gs.sum().item())
    if not (err <= tol and torch.isfinite(got).all().item() and not got[:, live:].any()):
        raise AssertionError(f"lut_affine_experts E={E} G={G} T={T} k={k} p={p}: "
                             f"err {err} > tol {tol} (or a nonzero tail row)")
    del got, ref
    ms = device_ms([functools.partial(kern, c) for c in copies_of(tables)], iters)
    plain_ms = device_ms([plain], plain_iters, warmup=1, hold=False)
    eot = sorted_expert_of(gs, live)
    bms, by = bound(codes[:live], G, En, p, tables.element_size(), shift_bits, expert_of=eot)
    vec = ops.ROW_ALIGN // tables.element_size()
    t = ops.experts_tiling(G, T, k, -(-p // vec) * vec * tables.element_size(),
                           torch.cuda.get_device_properties(0).multi_processor_count)
    return {
        "splits": t.splits, "max_abs_err": err, "tol": tol,
        "tol_reason": f"{KERNEL_TOL} x max|plain|: fp32 sums in another order",
        "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": None,
        "library_reason": "no PyTorch call takes i8 expert tables with exponent shifts",
    }


def dense_experts_ms(rows, gs, k, p, iters):
    """For context only: the dense bf16 expert products the tables replace,
    each sorted row times its expert's (k, p) weights -- one
    ``torch._grouped_mm`` where this torch has it, else a ``torch.matmul``
    per occupied expert."""
    import torch

    E = gs.numel()
    xs = torch.randn(rows, k, device=DEV, dtype=torch.bfloat16)
    w = torch.randn(E, p, k, device=DEV, dtype=torch.bfloat16).transpose(1, 2)
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    if hasattr(torch, "_grouped_mm"):
        how = "torch._grouped_mm"
        fn = functools.partial(torch._grouped_mm, xs, w, offs=offs)
    else:
        how = "torch.matmul per occupied expert"
        ends = offs.tolist()
        spans = [(e, a, b) for e, (a, b) in enumerate(zip([0] + ends[:-1], ends)) if b > a]

        def fn():
            return [xs[a:b] @ w[e] for e, a, b in spans]
    return device_ms([fn], iters), how


def moe_kernel_phase(iters: int, prefill_tokens: int) -> dict:
    import math

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import LUTGroup, LUTLinear
    from repro_torch.core.lut import pack_codes, plane_scales
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_affine import ops
    from repro_torch.models import moe
    from repro_torch.models.layers import Ctx, ExecCfg

    cfg = get_config("qwen2_moe_a2_7b")
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    gen = torch.Generator(device=DEV).manual_seed(3)
    router = torch.randn(d, E, generator=gen, device=DEV) / math.sqrt(d)
    plans = {"w_gate+w_up": (2, moe_fmt_plan(d, f)), "w_down": (1, moe_fmt_plan(f, d))}
    tables = {
        name: torch.randint(-127, 128, (E, G, plan.num_chunks, plan.num_entries,
                                        plan.out_features),
                            generator=gen, device=DEV, dtype=torch.int8)
        for name, (G, plan) in plans.items()
    }
    dequant = 2.0**-6
    worst, main = 0.0, {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "bound_by": set(), "prefill_ms": 0.0, "prefill_bound_ms": 0.0}
    for tokens in (SLOTS, prefill_tokens):
        # real routing of seeded activations through a seeded router
        x = torch.randn(tokens, d, generator=gen, device=DEV)
        _, _, order, token_of, gs = moe.dispatch(x, router, cfg)
        T = token_of.numel()
        h = torch.randn(T, f, generator=gen, device=DEV) * 0.1
        for name, (G, plan) in plans.items():
            src = x[token_of] if name == "w_gate+w_up" else h
            codes = pack_codes(src, plan)
            scales = plane_scales(plan).astype(np.float32) * np.float32(dequant)
            r = run_experts_case(codes, tables[name], scales, gs, plan.shift_bits, iters,
                                 2 if T > 16 else 5)
            dense, how = dense_experts_ms(T, gs, plan.in_features, G * plan.out_features,
                                          iters)
            emit({"phase": "moe_kernel", "kernel": "lut_affine_experts", "proj": name,
                  "tokens": tokens, "rows": T, "experts": E,
                  "occupied_experts": int((gs > 0).sum().item()), "G": G,
                  "n": plan.num_planes, "k": plan.num_chunks, "En": plan.num_entries,
                  "p": plan.out_features, "table": "i8", "shift_bits": plan.shift_bits,
                  **r, "dense_bf16_ms": dense, "dense_bf16_how": how})
            worst = max(worst, r["max_abs_err"])
            if tokens == SLOTS:
                for key in ("kernel_ms", "plain_ms", "bound_ms"):
                    main[key] += r[key]
                main["bound_by"].add(r["bound_by"])
            else:  # the engine's prefill: summed over the layer's calls
                main["prefill_ms"] += r["kernel_ms"]
                main["prefill_bound_ms"] += r["bound_ms"]
            if tokens == SLOTS and name == "w_gate+w_up":  # a split launch
                determinism("moe_kernel", "lut_affine_experts", functools.partial(
                    ops.lut_affine_experts, codes, tables[name], scales, gs,
                    shift_bits=plan.shift_bits),
                    {"proj": name, "rows": T, "k": plan.num_chunks, "p": plan.out_features,
                     "splits": r["splits"]})
        torch.cuda.empty_cache()

    # grid: table types x shift_bits, empty experts, every row on one
    # expert, T = 1, ragged T and p, G 1/2/3, a zero tail past the groups
    grid = [
        # E, G, T, n, k, En, p, group sizes
        (5, 2, 11, 3, 77, 32, 130, (3, 0, 6, 2, 0)),
        (3, 3, 9, 3, 40, 32, 96, (0, 9, 0)),
        (4, 1, 1, 3, 64, 32, 67, (0, 0, 1, 0)),
        (6, 1, 30, 3, 33, 32, 64, (5, 1, 0, 7, 4, 2)),
        (60, 2, 37, 3, 48, 32, 45, tuple(int(v) for v in np.bincount(
            np.random.default_rng(0).integers(0, 60, 37), minlength=60))),
    ]
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.int16):
        for shift in (0, 5):
            for Ex, G, T, n, k, En, p, sizes in grid:
                c, t, s = make_case(gen, T, n, k, En, p, Ex * G, dtype, shift,
                                    np.asarray([1.0, -16.0, 2.0**-5], np.float32))
                t = t.reshape(Ex, G, k, En, p)
                gs = torch.tensor(sizes, dtype=torch.int64, device=DEV)
                r = run_experts_case(c, t, s, gs, shift, iters, 5)
                emit({"phase": "moe_kernel", "kernel": "lut_affine_experts", "grid": True,
                      "experts": Ex, "G": G, "rows": T, "live_rows": sum(sizes), "n": n,
                      "k": k, "En": En, "p": p, "table": str(dtype).replace("torch.", ""),
                      "shift_bits": shift, **r})

    # one decode-shaped moe_ffn on the kernels with the stream's sync
    # debugging set to raise: routing, sort, dispatch and combine must not
    # read the device back
    shared = {"w_gate+w_up": (2, moe_fmt_plan(d, cfg.d_ff)),
              "w_down": (1, moe_fmt_plan(cfg.d_ff, d))}
    sh = {}
    for name, (G, plan) in shared.items():
        shape = (G,) if G > 1 else ()
        t = torch.randint(-127, 128, shape + (plan.num_chunks, plan.num_entries,
                                              plan.out_features),
                          generator=gen, device=DEV, dtype=torch.int8)
        sh[name] = (LUTGroup(t, plan, ("w_gate", "w_up"), scale=torch.tensor(dequant))
                    if G > 1 else LUTLinear(t, plan, scale=torch.tensor(dequant)))
    params = {
        "router": router,
        "w_gate+w_up": LUTGroup(tables["w_gate+w_up"], plans["w_gate+w_up"][1],
                                ("w_gate", "w_up"), scale=torch.tensor(dequant)),
        "w_down": LUTLinear(tables["w_down"][:, 0], plans["w_down"][1],
                            scale=torch.tensor(dequant)),
        "shared": sh,
        "shared_gate": torch.randn(d, 1, generator=gen, device=DEV) / math.sqrt(d),
    }
    x = torch.randn(SLOTS, 1, d, generator=gen, device=DEV)
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    with torch.no_grad():
        moe.moe_ffn(params, x, ctx)  # warm: the first call builds nothing new
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        y, aux = moe.moe_ffn(params, x, ctx)
        torch.cuda.set_sync_debug_mode(0)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        want, _ = moe.moe_ffn(params, x, Ctx(cfg, ex=ExecCfg(lut_grouped=True,
                                                             use_kernels=False)))
    err = (y - want).abs().max().item()
    scale = want.abs().max().item()
    expect = {"lut_affine": 1, "lut_affine_grouped": 1, "lut_affine_experts": 2}
    emit({"phase": "moe_kernel", "step": "moe_ffn_sync_debug", "sync_debug_mode": "error",
          "raised": False, "x": list(x.shape), "launches": launched,
          "expected_launches": expect, "max_abs_err": err, "max_abs_ref": scale,
          "tol": LOGITS_TOL * scale, "aux": aux.item()})
    if launched != expect:
        raise AssertionError(f"moe_ffn launches {launched} != {expect}")
    if not err <= LOGITS_TOL * scale:
        raise AssertionError(f"moe_ffn kernel vs plain: {err} > {LOGITS_TOL * scale}")
    del tables, params, sh
    torch.cuda.empty_cache()
    emit({"phase": "moe_kernel", "step": "ptxas",
          "kernels": {k: v for k, v in ptxas_report(build.BUILD_LOG.get("lut_affine", "")).items()
                      if "experts" in k}})
    return {"worst": {"lut_affine_experts": worst}, "main": {"lut_affine_experts": main}}


# ---------------------------------------------------------------------------
# MoE serve phase
# ---------------------------------------------------------------------------


def moe_serving_plan(params):
    """The serving recipe (``benchmarks/serving.py::serving_model_plan``:
    half the uniform chunk-2 footprint, the widened frontier) with
    ``convert_experts=True`` and chunks capped at 1; returns (plan, the
    uncapped recipe's plan)."""
    from repro_torch.core.planner import plan_model

    uniform = plan_model(params, float("inf"), max_chunk=2, convert_experts=True)
    kw = dict(modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4),
              table_formats=(None, "i8"), convert_experts=True)
    budget = uniform.total_lut_bytes // 2
    return (plan_model(params, budget, max_chunk=1, **kw),
            plan_model(params, budget, max_chunk=2, **kw))


def moe_depth(full) -> tuple[int, dict]:
    """Layers of full-width ``full`` that convert on this card: a 1-layer
    plan's table bytes (on shapes alone) plus the fp32 weights held while
    converting, against the card's memory less MOE_HEADROOM."""
    import torch

    from repro_torch.models.model import model_specs
    from repro_torch.models.params import tree_map

    def meta(cfg):
        return tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype or torch.float32, device="meta"),
            model_specs(cfg),
        )

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    one = meta(dataclasses.replace(full, num_layers=1))
    plan, uncapped = moe_serving_plan(one)
    head = plan.layers["lm_head"].total_lut_bytes
    layer_tables = plan.total_lut_bytes - head
    layer_fp32 = nbytes(one["blocks"])
    rest_fp32 = nbytes(one) - layer_fp32
    total = torch.cuda.get_device_properties(0).total_memory
    avail = total - MOE_HEADROOM

    def peak(n):
        return head + n * (layer_tables + layer_fp32) + rest_fp32

    layers = max([n for n in range(1, full.num_layers + 1) if peak(n) <= avail] or [0])
    if layers < 1:
        raise AssertionError(f"not one layer of {full.name} fits: {peak(1) / 2**30:.1f} GiB")
    gib = 2**30
    return layers, {
        "layers": layers, "published": full.num_layers,
        "table_gib_per_layer": layer_tables / gib, "lm_head_table_gib": head / gib,
        "conversion_peak_gib": peak(layers) / gib,
        "next_depth_peak_gib": peak(layers + 1) / gib,
        "card_gib": total / gib, "headroom_gib": MOE_HEADROOM / gib,
        "uncapped_recipe_table_gib_1_layer": uncapped.total_lut_bytes / gib,
        "reason": f"{layer_tables / gib:.1f} GiB of i8 tables per layer and "
                  f"{head / gib:.1f} GiB for lm_head: converting {layers} layers peaks at "
                  f"{peak(layers) / gib:.1f} GiB with the fp32 weights, {layers + 1} "
                  f"would reach {peak(layers + 1) / gib:.1f} GiB, over the card's "
                  f"{total / gib:.1f} GiB less {MOE_HEADROOM / gib:.0f} GiB kept for the "
                  f"plain path's 1 GiB gathers and the allocator; all {full.num_layers} "
                  f"layers would need {(head + full.num_layers * layer_tables) / gib:.0f} "
                  "GiB of tables; widths are the published ones",
        "chunk_cap_reason": "the recipe's halved uniform budget admits chunk-2 tables at "
                            "full width (a 1-layer plan of "
                            f"{uncapped.total_lut_bytes / gib:.0f} GiB); at chunk 1 it "
                            "plans what it plans on the reduced config",
    }


def moe_serve_phase(requests: int, max_new: int) -> dict:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward, model_specs
    from repro_torch.models.params import init_params
    from repro_torch.serve import make_cache

    full = get_config("qwen2_moe_a2_7b")
    torch.cuda.empty_cache()
    layers, depth = moe_depth(full)
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(model_specs(cfg), gen, device=DEV)
    mplan, _ = moe_serving_plan(params)
    kinds = sorted({
        f"{p.mode}-r{p.fmt.mantissa_radix}-{p.table_format}-c{p.chunk_size}"
        for p in mplan.layers.values()
    })
    emit({"phase": "moe_serve", "step": "plan", "summary": mplan.summary(),
          "table_mib": mplan.total_lut_bytes / 2**20, "plans": kinds,
          "groups": [list(g) for g in mplan.groups], "depth": depth})
    lut, report = convert_params(params, plan=mplan, convert_experts=True)
    torch.cuda.synchronize()
    peak_convert = torch.cuda.max_memory_allocated() / 2**30
    del params
    torch.cuda.empty_cache()
    emit({"phase": "moe_serve", "step": "convert", "summary": conversion_summary(report),
          "seconds": time.perf_counter() - t0, "max_memory_allocated_gib": peak_convert,
          "table_bytes": report.table_bytes,
          "memory_allocated_after_free_gib": torch.cuda.memory_allocated() / 2**30})
    if report.table_bytes != mplan.total_lut_bytes:
        raise AssertionError(f"tables {report.table_bytes} B != plan {mplan.total_lut_bytes} B")

    prompts = serve_requests(cfg, requests)
    torch.cuda.reset_peak_memory_stats()
    # packs: the attention group, wo, the routed gate+up (once per token)
    # and w_down, the shared expert's gate+up and w_down, and lm_head
    per_forward = {"lut_affine": 2 * layers + 1, "lut_affine_grouped": 2 * layers,
                   "lut_affine_experts": 2 * layers, "bitplane_pack": 6 * layers + 1}
    reqs, eng, wall, decode_ms, launches, uncovered = serve_paths(
        "moe_serve", lut, cfg, prompts, max_new, per_forward, eager_pack_profile=True)
    forwards = eng.readbacks
    expect = {**no_launches(), **{k: v * forwards for k, v in per_forward.items()}}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "moe_serve", "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": per_forward, "plain_pack_codes_calls": uncovered,
          "table_mib": report.table_bytes / 2**20,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or forwards <= 0 or uncovered:
        raise AssertionError(f"launch counts {launches} != expected {expect}, "
                             f"or {uncovered} packs off the kernel")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new")

    with count_plain_packs() as packs:
        plain_reqs, _, plain_wall, plain_decode = run_engine(lut, cfg, prompts, max_new,
                                                             False, cuda_graph=False)
    first_ok = all(a.generated[0] == b.generated[0] for a, b in zip(reqs, plain_reqs))
    same = sum(
        x == y for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)
    )
    emit({"phase": "moe_serve", "step": "plain", "tok_per_s": tokens / plain_wall,
          "wall_s": plain_wall, "median_decode_step_ms": statistics.median(plain_decode),
          "first_tokens_identical": first_ok, "identical_token_share": same / tokens,
          "pack_codes_calls": packs["calls"]})
    if not first_ok:
        raise AssertionError("kernel and plain paths disagree on a first token")
    if packs["calls"] != launches["bitplane_pack"]:
        raise AssertionError(f"the plain run packed {packs['calls']} times, the kernel run "
                             f"{launches['bitplane_pack']}")

    inputs = prefill_inputs(prompts)

    def prefill_logits(use_kernels: bool):
        ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels))
        cache = make_cache(cfg, SLOTS, MAX_LEN, ctx, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(lut, inputs, ctx, cache=cache)
        return logits[inputs["token_mask"]]

    got, ref = prefill_logits(True), prefill_logits(False)
    with plain_gather_bytes(64 * 2**20):
        other = prefill_logits(False)
    res, floor = compare_logits(got, ref), compare_logits(other, ref)
    finite = bool(torch.isfinite(got).all().item())
    tol = LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": "moe_serve", "step": "prefill_logits", "layers": layers,
          "shape": list(got.shape), **res, "tol": tol, "rel_fro_tol": LOGITS_FRO_TOL,
          "finite": finite, "plain_vs_plain": floor,
          "tol_reason": "as the serve phase's: the paths sum in other orders, an "
                        "activation near an fp16 rounding boundary takes the neighbouring "
                        "code before the next lookup, and top-k routing is a second "
                        "discontinuity"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= LOGITS_FRO_TOL):
        raise AssertionError(f"MoE prefill logits differ: {res} (tol {tol}, {LOGITS_FRO_TOL})")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# binary-matmul kernel phase
# ---------------------------------------------------------------------------


def pack_bound(x, n, k):
    """Least time for the card: the input read once and the codes written
    once over HBM bandwidth; or, per element, a multiply, a rounding and two
    clamps, and per plane a shift, a mask and an OR, over the add rate."""
    B, q = x.shape
    nbytes = x.numel() * x.element_size() + B * n * k * 4
    ops = B * q * (4 + 3 * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ADDS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bmm_bound(planes, W, p):
    """Least time for the card: the planes and W read once and the output
    written once over HBM bandwidth; or the 2*(B*n)*q*p products and sums of
    the folded GEMM over the bf16 tensor-core rate."""
    B, n, q = planes.shape
    nbytes = planes.numel() * planes.element_size() + W.numel() * W.element_size() + B * p * 4
    ops = 2 * B * n * q * p
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def run_pack_case(x, iters, plain_iters, **kw):
    """Kernel vs plain packing, bit for bit; then their times and the bound."""
    import torch

    from repro_torch.kernels.bitplane_pack import ops

    got = ops.bitplane_pack(x, **kw)
    torch.cuda.synchronize()
    want = ops.bitplane_pack(x, use_kernels=False, **kw)
    if not torch.equal(got, want):
        bad = int((got != want).sum().item())
        raise AssertionError(f"bitplane_pack {kw} x{list(x.shape)}: {bad} codes differ")
    n, k = got.shape[-2:]
    bms, by = pack_bound(x.reshape(-1, x.shape[-1]), n, k)
    return {
        "max_abs_err": 0, "tol": 0, "tol_reason": "integer codes: bit for bit",
        "kernel_ms": device_ms([lambda: ops.bitplane_pack(x, **kw)], iters),
        "plain_ms": device_ms([lambda: ops.bitplane_pack(x, use_kernels=False, **kw)],
                              plain_iters, warmup=1, hold=False),
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "library_reason": "no single PyTorch call packs bitplanes",
    }, got


def check_bmm(planes, W, scales, bias=None):
    """Kernel vs plain binary matmul within KERNEL_TOL x max|plain|."""
    import torch

    from repro_torch.kernels.binary_matmul import ops

    got = ops.binary_matmul(planes, W, scales, bias=bias)
    torch.cuda.synchronize()
    want = ops.binary_matmul(planes, W, scales, bias=bias, use_kernels=False)
    err = (got - want).abs().max().item()
    tol = KERNEL_TOL * want.abs().max().item()
    if not (err <= tol and torch.isfinite(got).all().item()):
        raise AssertionError(
            f"binary_matmul planes{list(planes.shape)} W{list(W.shape)} {W.dtype}: "
            f"err {err} > tol {tol}"
        )
    return err, tol


def bmm_kernel_phase(iters: int, prefill_rows: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.quantize import FixedPointFormat
    from repro_torch.kernels.binary_matmul import ops as bmm_ops
    from repro_torch.kernels.bitplane_pack import ops as pack_ops

    gen = torch.Generator(device=DEV).manual_seed(4)
    bits, frac = BMM_FIXED
    scales = FixedPointFormat(bits, frac, signed=True).plane_scales()
    pack_kw = dict(kind="fixed", m=1, bits=bits, frac=frac, signed=True)
    worst = {"binary_matmul": 0.0}
    keys = ("kernel_ms", "plain_ms", "bound_ms", "library_ms")
    main = {"binary_matmul": {**dict.fromkeys(keys, 0.0), "bound_by": set()}}
    for rows in (SLOTS, prefill_rows):
        for proj, (q, p, calls) in BMM_SHAPES.items():
            # a normed activation's scale: the 8/6 range [-2, 2) clips its tails
            x = torch.randn(rows, q, generator=gen, device=DEV)
            rp, planes = run_pack_case(x, iters, 10 if rows == SLOTS else 5, **pack_kw)
            emit({"phase": "bmm_kernel", "kernel": "bitplane_pack", "proj": proj, "rows": rows,
                  "q": q, "n": bits, "fixed": [bits, frac], **rp})
            W = torch.randn(q, p, generator=gen, device=DEV) / q**0.5
            Wb = W.to(torch.bfloat16)  # the path's W (models/params.py::bf16_projections)
            err, tol = check_bmm(planes, Wb, scales)
            err32, tol32 = check_bmm(planes, W, scales)  # fp32 W: rounded by the wrapper
            worst["binary_matmul"] = max(worst["binary_matmul"], err, err32)
            wb = copies_of(Wb)
            ms = device_ms(
                [functools.partial(bmm_ops.binary_matmul, planes, w, scales) for w in wb], iters
            )
            folded = planes.reshape(rows * bits, q).to(torch.bfloat16)
            lib_ms = device_ms([functools.partial(torch.matmul, folded, w) for w in wb], iters)
            plain_ms = device_ms(
                [lambda: bmm_ops.binary_matmul(planes, Wb, scales, use_kernels=False)],
                10 if rows == SLOTS else 3, warmup=1, hold=False,
            )
            del wb, folded
            ws = copies_of(W)
            fp32_w_ms = device_ms(
                [functools.partial(bmm_ops.binary_matmul, planes, w, scales) for w in ws], iters
            )
            del ws
            bms, by = bmm_bound(planes, Wb, p)
            emit({"phase": "bmm_kernel", "kernel": "binary_matmul", "proj": proj, "rows": rows,
                  "folded_rows": rows * bits, "q": q, "p": p, "w": "bfloat16",
                  "planes": str(planes.dtype).replace("torch.", ""),
                  "max_abs_err": err, "tol": tol, "fp32_w_max_abs_err": err32,
                  "fp32_w_tol": tol32,
                  "tol_reason": f"{KERNEL_TOL} x max|plain|: exact bit x bf16 products, "
                                "fp32 sums in another order",
                  "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                  "library_ms": lib_ms,
                  "library_how": "torch.matmul of the folded planes and W, both bf16 "
                                 "(cuBLAS; the same W bytes as the kernel; no plane sum)",
                  "kernel_fp32_w_ms": fp32_w_ms,
                  "fp32_w_how": "an fp32 W, rounded to bf16 by the wrapper (one copy) "
                                "before the same kernel; the serve path never takes it",
                  "dense_bf16_ms": dense_ms(rows, 1, q, p, iters),
                  "tile": list(bmm_ops.tile(rows, bits)),
                  "splits": bmm_ops.k_splits(rows, bits, q, p,
                                             bmm_ops._sm_count(torch.device(DEV)))})
            if rows == SLOTS:
                m = main["binary_matmul"]
                for key, v in zip(keys, (ms, plain_ms, bms, lib_ms)):
                    m[key] += calls * v
                m["bound_by"].add(by)
            del W, Wb, planes, x
            torch.cuda.empty_cache()

    # grid, after tests/test_kernels.py: binary_matmul over n 1..16, ragged
    # q and p, leading dims, bias, int8 / int32 planes, fp32 / bf16 W, 800
    # folded rows (not a multiple of the tile), a W at an unaligned base
    for lead, n, q, p, wdt, pdt, bias in [
        ((1,), 1, 1, 1, torch.float32, torch.int8, False),
        ((4,), 8, 100, 30, torch.bfloat16, torch.int8, True),
        ((65,), 11, 300, 140, torch.float32, torch.int32, False),
        ((2,), 16, 513, 257, torch.bfloat16, torch.int32, True),
        ((2, 3), 8, 4096, 1024, torch.float32, torch.int32, True),
        ((5,), 3, 64, 64, torch.float32, torch.int8, False),
        ((100,), 8, 4096, 1024, torch.bfloat16, torch.int32, False),
        ((4,), 8, 1000, 600, "bf16_unaligned", torch.int32, True),
    ]:
        planes = (torch.rand(lead + (n, q), generator=gen, device=DEV) < 0.5).to(pdt)
        if wdt == "bf16_unaligned":  # a contiguous W at a 2-byte offset
            buf = (torch.randn(q * p + 1, generator=gen, device=DEV) / q**0.5).to(torch.bfloat16)
            W = buf[1:].view(q, p)
        else:
            W = (torch.randn(q, p, generator=gen, device=DEV) / q**0.5).to(wdt)
        scales = 0.5 ** np.arange(n)
        scales[-1] = -scales[-1]
        b = torch.randn(p, generator=gen, device=DEV) if bias else None
        err, tol = check_bmm(planes, W, scales, b)
        emit({"phase": "bmm_kernel", "kernel": "binary_matmul", "grid": True,
              "lead": list(lead), "n": n, "q": q, "p": p,
              "w": str(W.dtype).replace("torch.", ""), "planes": str(pdt).replace("torch.", ""),
              "w_aligned_16": W.data_ptr() % 16 == 0,
              "bias": bias, "max_abs_err": err, "tol": tol})
    # bitplane_pack: fixed bits 2..8, frac 0..4, both signs, m 1..4; fp16
    # with m 1..4, zeros, subnormals, negatives and overflow
    cases = [dict(kind="fixed", bits=b, frac=f, signed=sg, m=m)
             for b, f, sg, m in [(2, 0, False, 1), (3, 1, True, 2), (4, 2, False, 3),
                                 (5, 3, True, 4), (6, 4, False, 1), (7, 0, True, 3),
                                 (8, 4, False, 4), (8, 6, True, 1)]]
    cases += [dict(kind="float16", m=m) for m in (1, 2, 3, 4)]
    for kw in cases:
        x = torch.rand(2, 3, 70, generator=gen, device=DEV) * 8 - 4
        if kw["kind"] == "float16":
            x = x.abs() * 25
            x[0, 0, :6] = torch.tensor([0.0, 5.96e-8, 1.2e-7, 6.0e-5, -3.0, 1e6], device=DEV)
            x[1, 2] = 0.0
        out = pack_ops.bitplane_pack(x, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, pack_ops.bitplane_pack(x, use_kernels=False, **kw)):
            raise AssertionError(f"bitplane_pack {kw}: codes differ")
        emit({"phase": "bmm_kernel", "kernel": "bitplane_pack", "grid": True,
              "x": list(x.shape), **kw, "codes": list(out.shape), "max_abs_err": 0})
    return {"worst": worst, "main": main}


# ---------------------------------------------------------------------------
# packing kernel phase
# ---------------------------------------------------------------------------


def pack_kernel_phase(iters: int) -> dict:
    import torch

    from repro_torch.kernels.bitplane_pack import ops

    gen = torch.Generator(device=DEV).manual_seed(5)
    floor = {}
    for _, kw, _ in PACK_SERVED.values():
        x = torch.randn(1, 4, generator=gen, device=DEV)
        floor[kw["kind"]] = device_ms([functools.partial(ops.bitplane_pack, x, **kw)],
                                      10 * iters)
    emit({"phase": "pack_kernel", "step": "launch_floor", "ms": floor,
          "how": "a one-row, 4-element fp32 pack of each kind (one thread of the "
                 "4-element path) back to back under device_ms"})
    layers = {}
    for cell, (model, kw, inputs) in PACK_SERVED.items():
        kind = kw["kind"]
        layer = {**dict.fromkeys(("kernel_ms", "plain_ms", "bound_ms", "prefill_ms",
                                  "prefill_bound_ms"), 0.0), "bound_by": set()}
        ratios = []
        for name, q, decode_rows, prefill_rows, calls in inputs:
            for regime, rows in (("decode", decode_rows), ("prefill", prefill_rows)):
                for dtype in (torch.float32, torch.bfloat16):
                    # a normed activation's scale
                    x = torch.randn(rows, q, generator=gen, device=DEV).to(dtype)
                    r, _ = run_pack_case(x, iters, 10 if regime == "decode" else 5, **kw)
                    ratio = r["kernel_ms"] / floor[kind]
                    emit({"phase": "pack_kernel", "kernel": "bitplane_pack", "cell": cell,
                          "model": model, "input": name, "regime": regime, "rows": rows,
                          "q": q, **kw, "dtype": str(dtype).replace("torch.", ""),
                          "packs_per_layer": calls,
                          "vectorized": ops.vectorized(q, kw["m"], x.data_ptr(),
                                                       x.element_size()),
                          **r, "launch_floor_ms": floor[kind], "over_launch_floor": ratio})
                    if dtype != torch.float32:  # the served paths hand in fp32
                        continue
                    if regime == "decode":
                        for key in ("kernel_ms", "plain_ms", "bound_ms"):
                            layer[key] += calls * r[key]
                        layer["bound_by"].add(r["bound_by"])
                        ratios.append(ratio)
                    else:
                        layer["prefill_ms"] += calls * r["kernel_ms"]
                        layer["prefill_bound_ms"] += calls * r["bound_ms"]
        layers[cell] = layer
        emit({"phase": "pack_kernel", "step": "layer", "cell": cell, "model": model,
              **kw, "served": cell != "float16", "calls": sum(c for *_, c in inputs),
              **{k: v for k, v in layer.items() if k != "bound_by"},
              "max_decode_over_launch_floor": max(ratios)})

    # grid: every kind and radix, both dtypes; the launch floor's shape,
    # q % 4 != 0, a base one element off, leading dims, rows past the
    # grid's y limit; values over fp16's range, its edges first
    kinds = [dict(kind="fixed", m=1, bits=8, frac=6, signed=True),
             dict(kind="fixed", m=2, bits=12, frac=3, signed=True),
             dict(kind="fixed", m=4, bits=3, frac=0, signed=False),
             dict(kind="float16", m=1), dict(kind="float16", m=3)]
    kinds += [dict(kind="shift", m=1, signed=sg, radix=r)
              for r in (1, 2, 3, 4, 5, 11) for sg in (False, True)]
    shapes = [((1,), 4, 0), ((3,), 37, 0), ((2,), 4096, 1), ((2, 3), 1408, 0),
              ((1,), 4098, 0), ((70000,), 8, 0)]
    edges = torch.tensor(PACK_EDGES, device=DEV)
    for kw in kinds:
        for dtype in (torch.float32, torch.bfloat16):
            for lead, q, off in shapes:
                n = math.prod(lead) * q
                flat = torch.randn(n + off, generator=gen, device=DEV) * torch.exp2(
                    torch.randint(-26, 18, (n + off,), generator=gen, device=DEV).float())
                flat[off: off + len(PACK_EDGES)] = edges[: n]
                x = flat.to(dtype)[off:].view(*lead, q)
                got = ops.bitplane_pack(x, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, ops.bitplane_pack(x, use_kernels=False, **kw)):
                    raise AssertionError(f"bitplane_pack {kw} {dtype} x{[*lead, q]}+{off}: "
                                         "codes differ")
            emit({"phase": "pack_kernel", "kernel": "bitplane_pack", "grid": True, **kw,
                  "dtype": str(dtype).replace("torch.", ""),
                  "shapes": [[*lead, q, off] for lead, q, off in shapes], "max_abs_err": 0})
    return {"worst": {"bitplane_pack": 0}, "layers": layers}


# ---------------------------------------------------------------------------
# binary-matmul serve phase
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_bmm_split(parts: int):
    """Run the plain binary matmul with q cut into ``parts`` slices whose
    products are summed in order (another fp32 order of the same function)
    inside a ``with`` block."""
    from repro_torch.kernels.binary_matmul import ops

    saved = ops.binary_matmul_ref

    def split(planes, W, scales):
        cuts = [W.shape[0] * i // parts for i in range(parts + 1)]
        out = None
        for a, b in zip(cuts[:-1], cuts[1:]):
            y = saved(planes[..., a:b], W[a:b], scales)
            out = y if out is None else out + y
        return out

    ops.binary_matmul_ref = split
    try:
        yield
    finally:
        ops.binary_matmul_ref = saved


def bmm_serve_phase(layers: int, requests: int, max_new: int) -> dict:
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.models.model import model_forward, model_specs
    from repro_torch.models.params import bf16_projections, init_params
    from repro_torch.serve import make_cache

    full = get_config("granite_8b")
    cfg = dataclasses.replace(full, num_layers=layers)
    bits, frac = BMM_FIXED
    mode = dict(linear_mode="binary_matmul", fixed_bits=bits, fixed_frac=frac)
    prompts = serve_requests(cfg, requests)
    inputs = prefill_inputs(prompts)

    def prefill_logits(tree, depth: int, use_kernels: bool):
        dcfg = dataclasses.replace(cfg, num_layers=depth)
        dparams = dict(tree, blocks=first_layers(tree["blocks"], depth))
        ctx = Ctx(dcfg, ex=ExecCfg(lut_grouped=True, use_kernels=use_kernels, **mode))
        cache = make_cache(dcfg, SLOTS, MAX_LEN, ctx, device=DEV)
        with torch.no_grad():
            logits, _, _ = model_forward(dparams, inputs, ctx, cache=cache)
        return logits[inputs["token_mask"]]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params32 = init_params(model_specs(cfg), gen, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the fp32 tree's prefill logits on both paths, before its projections
    # are rounded once to bf16 (both paths round W to bf16 before the
    # product, so the bf16 tree must give them bit for bit)
    depth = BMM_DEPTHS[1]
    ref32 = {uk: prefill_logits(params32, depth, uk) for uk in (True, False)}
    t0 = time.perf_counter()
    params = bf16_projections(params32)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    del params32
    torch.cuda.empty_cache()
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    proj_bytes = sum(t.numel() * t.element_size() for t in _leaves(params["blocks"])
                     if t.ndim == 3)
    emit({"phase": "bmm_serve", "step": "init", "seconds": init_s, "round_seconds": round_s,
          "weight_gib": weight_bytes / 2**30, "projection_gib": proj_bytes / 2**30,
          "projection_dtype": "bfloat16",
          "depth": {"layers": layers, "published": full.num_layers}, "fixed": [bits, frac],
          "memory_allocated_gib": torch.cuda.memory_allocated() / 2**30,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    same = {("kernels" if uk else "plain"): torch.equal(prefill_logits(params, depth, uk), ref)
            for uk, ref in ref32.items()}
    emit({"phase": "bmm_serve", "step": "bf16_tree", "layers": depth,
          "logits_identical_to_fp32_tree": same})
    if not all(same.values()):
        raise AssertionError(f"the bf16-projection tree changed the prefill logits: {same}")
    del ref32

    torch.cuda.reset_peak_memory_stats()
    per_forward = {"bitplane_pack": 7 * layers, "binary_matmul": 7 * layers}
    reqs, eng, wall, decode_ms, launches, _ = serve_paths(
        "bmm_serve", params, cfg, prompts, max_new, per_forward, **mode)
    forwards = eng.readbacks
    expect = {**no_launches(), **{k: v * forwards for k, v in per_forward.items()}}
    tokens = sum(len(r.generated) for r in reqs)
    emit({"phase": "bmm_serve", "step": "kernels", "requests": len(reqs), "tokens": tokens,
          "tok_per_s": tokens / wall, "wall_s": wall,
          "median_decode_step_ms": statistics.median(decode_ms),
          "forwards": forwards, "launches": launches, "expected_launches": expect,
          "per_forward": per_forward,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
    if launches != expect or forwards <= 0:
        raise AssertionError(f"launch counts {launches} != expected {expect}")
    if not all(len(r.generated) == max_new for r in reqs):
        raise AssertionError("a request stopped short of max_new")

    plain_reqs, _, plain_wall, plain_decode = run_engine(params, cfg, prompts, max_new, False,
                                                         cuda_graph=False, **mode)
    first_ok = all(a.generated[0] == b.generated[0] for a, b in zip(reqs, plain_reqs))
    same = sum(
        x == y for a, b in zip(reqs, plain_reqs) for x, y in zip(a.generated, b.generated)
    )
    emit({"phase": "bmm_serve", "step": "plain", "tok_per_s": tokens / plain_wall,
          "wall_s": plain_wall, "median_decode_step_ms": statistics.median(plain_decode),
          "first_tokens_identical": first_ok, "identical_token_share": same / tokens,
          "streams_identical": all(a.generated == b.generated
                                   for a, b in zip(reqs, plain_reqs))})
    if not first_ok:
        raise AssertionError("kernel and plain paths disagree on a first token")

    for depth in BMM_DEPTHS:
        if depth < layers:
            emit({"phase": "bmm_serve", "step": "prefill_logits_by_depth", "layers": depth,
                  **compare_logits(prefill_logits(params, depth, True),
                                   prefill_logits(params, depth, False))})
    got, ref = prefill_logits(params, layers, True), prefill_logits(params, layers, False)
    # noise floor: the plain path against itself with q cut in two (the
    # same function, another fp32 order)
    with plain_bmm_split(2):
        floor = compare_logits(prefill_logits(params, layers, False), ref)
    res = compare_logits(got, ref)
    finite = bool(torch.isfinite(got).all().item())
    tol = BMM_LOGITS_TOL * res["max_abs_ref"]
    emit({"phase": "bmm_serve", "step": "prefill_logits", "layers": layers,
          "shape": list(got.shape), **res, "tol": tol, "rel_fro_tol": BMM_LOGITS_FRO_TOL,
          "finite": finite, "plain_vs_plain": floor,
          "tol_reason": "the paths sum each projection's products in other fp32 orders "
                        "(~1e-7 relative); each projection re-quantizes its input to 8/6 "
                        "fixed point (a step of 1/64), so an activation that close to a "
                        "rounding boundary takes the neighbouring code, and 36 random-init "
                        "layers carry these steps to the logits: measured on an H100, the "
                        "norm error grows 0.07 / 2.1 / 3.3 / 4.4 % at 1 / 4 / 12 / 36 "
                        "layers, and the plain version against itself in another order "
                        "(plain_vs_plain) differs by as much; the tolerance is about twice "
                        "that (a wrong plane, row or sign shows in the bmm_kernel lines, "
                        "each call held to 1e-5 x max|plain|)"})
    if not (finite and res["max_abs_err"] <= tol and res["rel_fro_err"] <= BMM_LOGITS_FRO_TOL):
        raise AssertionError(f"prefill logits differ: {res} (tol {tol}, {BMM_LOGITS_FRO_TOL})")
    del params
    torch.cuda.empty_cache()
    return {"launches": launches}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def compare_logits(a, b) -> dict:
    d = a - b
    return {"max_abs_err": d.abs().max().item(), "max_abs_ref": b.abs().max().item(),
            "rel_fro_err": (d.norm() / b.norm()).item(),
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item()}


def graph_nodes(graph) -> dict:
    """The nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``) by type, from CUDA's runtime (``cudaGraphGetNodes``
    and ``cudaGraphNodeGetType``, through the runtime torch loaded)."""
    import ctypes

    import torch

    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    rt.cudaGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    rt.cudaGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(g, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if rt.cudaGraphGetNodes(g, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cudaGraphGetNodes failed")
    # cudaGraphNodeType: kernel 0, memcpy 1, memset 2, the rest other
    names = {0: "kernel", 1: "memcpy", 2: "memset"}
    kinds: dict = {}
    for node in nodes:
        t = ctypes.c_int(-1)
        if rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) != 0:
            raise RuntimeError("cudaGraphNodeGetType failed")
        kind = names.get(t.value, f"type_{t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
    return kinds


def profile_decode(lut, cfg, prompts, max_new, steps=4, cuda_graph=True, **ex):
    """Where a steady decode step's time goes: ``torch.profiler`` over
    ``steps`` engine steps after admission and two decode steps (with the
    graph: the eager warm-up and the capture, whose graph is kept so that
    its nodes can be counted beside the profiler's records).  ``busy_ms``
    sums the device time of every kernel; the idle share is the rest of the
    host-clock wall time.  (Its launches are not the main-path run's: the
    counts were read before.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.layers import Ctx, ExecCfg
    from repro_torch.serve import BatchingEngine, Request

    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True, **ex))
    eng = BatchingEngine(lut, ctx, SLOTS, MAX_LEN, prefill_bucket=BUCKET, device=DEV,
                         cuda_graph=cuda_graph)
    for i, pr in enumerate(prompts):
        eng.submit(Request(i, pr, max_new))
    made = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = functools.partial(made, keep_graph=True)
    try:
        eng.step()  # admission prefill + first decode (the graph's warm-up)
        eng.step()  # with the graph: its capture and first replay
    finally:
        torch.cuda.CUDAGraph = made
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            eng.step()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    packs = [e for e in kernels if "pack_kernel" in e.key]
    profiled = sum(e.count for e in kernels) / steps
    # the profiler records each kernel of a replay; the captured graph's
    # nodes (kernels and copies; the step's readback is outside) beside them
    nodes = graph_nodes(eng._graph[0]) if cuda_graph else None
    if not profiled:
        raise AssertionError(f"the profiler recorded no kernel (cuda_graph {cuda_graph})")
    return {
        "cuda_graph": cuda_graph, "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "busy_ms_per_step": busy / steps,
        "idle_share": 1.0 - busy / wall_ms,
        "device_kernels_per_step": profiled, "graph_nodes": nodes,
        "pack_kernels_per_step": sum(e.count for e in packs) / steps,
        "pack_ms_per_step": sum(e.self_device_time_total for e in packs) / 1e3 / steps,
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

    names = ("lut_affine_ref", "lut_affine_grouped_ref", "lut_affine_experts_ref")
    saved = {name: getattr(ops, name) for name in names}
    for name, fn in saved.items():
        setattr(ops, name, functools.partial(fn, max_gather_bytes=nbytes))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


# ---------------------------------------------------------------------------
# paper phase: the paper's own networks, trained, converted and evaluated
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def paper_layer_spy(fn):
    """Inside a ``with`` block, every ``linear`` call of the paper models
    (``models/paper_models.py`` imports it by name) also calls ``fn(p, x,
    y)`` with its parameters, input and output."""
    from repro_torch.models import paper_models

    saved = paper_models.linear

    def spy(p, x, ctx):
        y = saved(p, x, ctx)
        fn(p, x, y)
        return y

    paper_models.linear = spy
    try:
        yield
    finally:
        paper_models.linear = saved


def head_copy_ms(node, x, iters: int) -> dict:
    """One converted head's ``lut_affine`` call on its B = 500 input, as
    served (10 fp32 columns, 40-byte rows: ``table_operand`` copies the
    tables into 48-byte rows first) and on tables padded once to 12
    columns (no copy); with the served call's bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.bitplane_pack.ops import pack
    from repro_torch.kernels.lut_affine import ops
    from repro_torch.models.layers import _host_scales

    codes = pack(x, node.plan)
    scales = _host_scales(node.plan, node.scale)
    p = node.tables.shape[-1]
    served = copies_of(node.tables)
    padded = [F.pad(t, (0, -p % (ops.ROW_ALIGN // t.element_size()))) for t in served]
    before = ops.TABLE_COPIES["table_operand"]
    got = ops.lut_affine(codes, padded[0], scales)[:, :p]
    if ops.TABLE_COPIES["table_operand"] != before:
        raise AssertionError("a pre-padded table was copied")
    ops.lut_affine(codes, served[0], scales)
    copies = ops.TABLE_COPIES["table_operand"] - before
    want = ops.lut_affine(codes, node.tables, scales, use_kernels=False)
    err = (got - want).abs().max().item()
    if err > KERNEL_TOL * want.abs().max().item():
        raise AssertionError(f"the pre-padded head is {err} off its plain version")
    with_copy = device_ms([functools.partial(ops.lut_affine, codes, t, scales)
                           for t in served], iters)
    pre_padded = device_ms([functools.partial(ops.lut_affine, codes, t, scales)
                            for t in padded], iters)
    b_ms, b_by = bound(codes, 1, node.tables.shape[-2], p, node.tables.element_size(), 0)
    return {"copies_per_call": copies, "ms_with_copy": with_copy,
            "ms_pre_padded": pre_padded, "copy_ms": with_copy - pre_padded,
            "table_bytes": node.tables.numel() * node.tables.element_size(),
            "bound_ms": b_ms, "bound_by": b_by, "codes_shape": list(codes.shape),
            "max_abs_err_pre_padded": err}


def paper_layer_ms(node, x, ctx, iters: int) -> dict:
    """Where a converted forward's time goes: one layer's ``linear`` call
    (its pack, any table copy and its ``lut_affine``) and its pack alone,
    on the layer's own input in the forward, with the regime the wrapper
    picks and the bound of the ``lut_affine`` call (its tables are read in
    place, so a small layer's may sit in L2 between calls)."""
    from repro_torch.kernels.bitplane_pack.ops import pack
    from repro_torch.models.layers import linear

    codes = pack(x, node.plan)
    t = node.tables
    b_ms, b_by = bound(codes, 1, t.shape[-2], t.shape[-1], t.element_size(), 0)
    return {"rows": x.shape[0], "q": x.shape[1], "p": t.shape[-1],
            "n": node.plan.num_planes, "k": node.plan.num_chunks, "E": t.shape[-2],
            "regime": lut_tiling("lut_affine", codes, t[None]).regime,
            "ms": device_ms([functools.partial(linear, node, x, ctx)], iters),
            "pack_ms": device_ms([functools.partial(pack, x, node.plan)], iters),
            "lut_affine_bound_ms": b_ms, "bound_by": b_by}


def paper_batches(bits=None):
    """The held-out images of ``examples/tablenet_mnist.py::accuracy`` (3
    batches of 500 from step 50,000) on the card, on the ``bits`` grid
    when given."""
    from repro_torch.data.synthetic import image_batch
    from repro_torch.models.paper_models import quantize_inputs

    out = []
    for s in range(PAPER_BATCHES):
        x, y = image_batch(PAPER_ROWS, 50_000 + s, device=DEV)
        out.append((quantize_inputs(x, bits), y))
    return out


def run_converted(tag: dict, lut, report, params, forward, batches, iters: int,
                  dense_inputs) -> dict:
    """A converted paper network over ``batches``: one counted pass on the
    kernels (per forward one ``bitplane_pack`` and one ``lut_affine`` launch
    per converted layer, no pack off the kernel), the plain versions on the
    same images, every converted layer against its plain version on the
    same input, device times of the kernel path, the plain path and the
    dense forward at B = 500, and the 10-column head's table copy.
    ``dense_inputs`` maps an image batch to the dense model's input for the
    accuracy beside the LUT path's."""
    import torch

    from repro_torch.core.convert import LUTLinear
    from repro_torch.kernels.lut_affine import ops as lut_ops
    from repro_torch.models.layers import linear
    from repro_torch.models.paper_models import paper_ctx

    kctx, pctx = paper_ctx(), paper_ctx(use_kernels=False)
    names = [k for k, v in lut.items() if isinstance(v, LUTLinear)]
    by_node = {id(lut[k]): k for k in names}
    reset_launches()
    with torch.no_grad():
        kern = [forward(lut, x, kctx) for x, _ in batches]
    torch.cuda.synchronize()
    launches, uncovered = read_launches(), plain_pack_codes_calls()
    copies = lut_ops.TABLE_COPIES["table_operand"]
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    expect = {**no_launches(), "lut_affine": len(names) * n, "bitplane_pack": len(names) * n}
    if launches != expect or uncovered:
        raise AssertionError(f"{tag}: launches {launches} != {expect}, or {uncovered} "
                             "packs off the kernel")
    with torch.no_grad():
        plain = [forward(lut, x, pctx) for x, _ in batches]
        dense = [forward(params, dense_inputs(x), kctx) for x, _ in batches]
    labels = [y for _, y in batches]
    agree = [int((a.argmax(-1) == b.argmax(-1)).sum()) for a, b in zip(kern, plain)]
    cat_k, cat_p = torch.cat(kern), torch.cat(plain)
    finite = bool(torch.isfinite(cat_k).all())

    def correct(logits):
        return sum(int((lg.argmax(-1) == y).sum()) for lg, y in zip(logits, labels))

    # every converted layer against its plain version on the same input
    layer_err, layer_in = {}, {}

    def check(p, x, y):
        if not isinstance(p, LUTLinear):
            return
        name = by_node[id(p)]
        want = linear(p, x, pctx)
        err, ref = (y - want).abs().max().item(), want.abs().max().item()
        layer_err[name] = {"rows": x.numel() // x.shape[-1], "max_abs_err": err,
                           "max_abs_ref": ref, "ok": err <= KERNEL_TOL * ref}
        layer_in[name] = x.reshape(-1, x.shape[-1])

    with torch.no_grad(), paper_layer_spy(check):
        forward(lut, batches[0][0], kctx)
    x0 = batches[0][0]
    with torch.no_grad():
        kernel_ms = device_ms([functools.partial(forward, lut, x0, kctx)], iters)
        plain_ms = device_ms([functools.partial(forward, lut, x0, pctx)], max(1, iters // 4),
                             warmup=1, hold=False)
        dense_x = dense_inputs(x0)
        dense_ms = device_ms([functools.partial(forward, params, dense_x, kctx)], iters)
        per_layer = {k: paper_layer_ms(lut[k], x, kctx, iters) for k, x in layer_in.items()}
        heads = {k: head_copy_ms(lut[k], x, iters) for k, x in layer_in.items()
                 if lut[k].tables.shape[-1] * lut[k].tables.element_size()
                 % lut_ops.ROW_ALIGN}
    del layer_in
    res = {
        **tag, "converted_layers": names, "table_bytes": report.table_bytes,
        "weight_bytes": report.weight_bytes, "peak_bytes": peak,
        "launches": launches, "per_forward": {k: v // n for k, v in launches.items() if v},
        "plain_pack_codes_calls": uncovered, "table_copies_per_forward": copies / n,
        "layers": layer_err, "argmax_agree_per_batch": agree, "argmax_agree_min": PAPER_AGREE,
        "finite": finite, **compare_logits(cat_k, cat_p),
        "lut_correct": correct(kern), "plain_correct": correct(plain),
        "dense_correct": correct(dense), "images": n * PAPER_ROWS,
        "device_ms": {"kernel": kernel_ms, "plain": plain_ms, "dense_fp32": dense_ms},
        "images_per_s": {"kernel": PAPER_ROWS / kernel_ms * 1e3,
                         "plain": PAPER_ROWS / plain_ms * 1e3,
                         "dense_fp32": PAPER_ROWS / dense_ms * 1e3},
        "per_layer": per_layer, "heads": heads,
    }
    res["lut_accuracy"] = res["lut_correct"] / res["images"]
    res["dense_accuracy"] = res["dense_correct"] / res["images"]
    emit({"phase": "paper", **res})
    bad = [k for k, v in layer_err.items() if not v["ok"]]
    if bad or set(layer_err) != set(names):
        raise AssertionError(f"{tag}: layers {bad} off their plain version (or unchecked)")
    if min(agree) < PAPER_AGREE or not finite:
        raise AssertionError(f"{tag}: argmax agreement {agree} below {PAPER_AGREE} a batch")
    return res


def paper_phase(iters: int) -> dict:
    """The paper's three networks at their published widths, each trained on
    the card with the reference's recipe (``examples/tablenet_mnist.py``;
    LeNet also at a stable learning rate, :data:`PAPER_LR`), its dense
    accuracy over 1500 held-out images and at input bits 1..8,
    converted to unsigned fp16 bitplane tables (chunk 1 for all three,
    chunk 2 for the classifier and the MLP) and run on the kernels and on
    the plain versions; then the classifier at the Fig. 5 fixed 3/3 plan,
    chunks 1 / 2 / 7 / 14, against the dense model on the same 3-bit
    inputs; then the TL1 rows of ``benchmarks/accuracy_vs_bits.py`` on
    ``lut_tl1``, the head's output held against its plain version on every
    batch (the accuracies beside the plain version's are a report)."""
    import torch

    from repro_torch.benchmarks import accuracy_vs_bits as avb
    from repro_torch.core.convert import conversion_summary, convert_params
    from repro_torch.core.lut import LUTPlan
    from repro_torch.core.lut_tl1 import TL1Plan
    from repro_torch.core.planner import ModelPlan
    from repro_torch.core.quantize import FixedPointFormat
    from repro_torch.examples import tablenet_mnist as tm
    from repro_torch.models.layers import linear
    from repro_torch.models.paper_models import paper_ctx

    total = no_launches()

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    for name, chunks in PAPER_CHUNKS.items():
        for lr in PAPER_LR[name]:
            t0 = time.perf_counter()
            params, forward, ctx = tm.train(name, lr=lr, device=DEV)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            emit({"phase": "paper", "net": name, "step": "train", "steps": 300,
                  "batch": 128, "lr": lr, "recipe": lr == 0.3, "train_s": train_s,
                  "converted": lr == PAPER_LR[name][-1],
                  "accuracy_fp32": tm.accuracy(forward, params, ctx, device=DEV),
                  "accuracy_by_input_bits": {str(b): tm.accuracy(forward, params, ctx, b,
                                                                 device=DEV)
                                             for b in range(1, 9)}})
        batches = paper_batches()
        for chunk in chunks:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            lut, report = convert_params(params, chunk_size=chunk, signed=False)
            torch.cuda.synchronize()
            tag = {"net": name, "step": "lut", "plan": f"fp16-unsigned-bitplane-c{chunk}",
                   "convert_s": time.perf_counter() - t0,
                   "summary": conversion_summary(report)}
            res = run_converted(tag, lut, report, params, forward, batches, iters,
                                lambda x: x.half().float())
            add(res["launches"])
            del lut
            torch.cuda.empty_cache()
        if name == "linear":  # the Fig. 5 point: 3-bit inputs, fixed-point tables
            fig5 = paper_batches(FIG5_BITS)
            fmt = FixedPointFormat(FIG5_BITS, FIG5_BITS)
            for m in FIG5_CHUNKS:
                torch.cuda.reset_peak_memory_stats()
                plan = LUTPlan(784, 10, m, fmt)
                lut, report = convert_params(params, plan=ModelPlan({"fc": plan}))
                tag = {"net": name, "step": "fig5",
                       "plan": f"fixed{FIG5_BITS}/{FIG5_BITS}-unsigned-bitplane-c{m}",
                       "entries": plan.num_entries, "tables": plan.num_chunks}
                res = run_converted(tag, lut, report, params, forward, fig5, iters,
                                    lambda x: x)
                if abs(res["lut_correct"] - res["dense_correct"]) > 1:
                    raise AssertionError(f"fig5 c{m}: {res['lut_correct']} LUT against "
                                         f"{res['dense_correct']} dense correct images")
                add(res["launches"])
                del lut
        del params
        torch.cuda.empty_cache()

    # the TL1 rows of accuracy_vs_bits: its recipe, its held-out images
    params, ctx = avb.train_linear(device=DEV)
    ref = avb.accuracy(params, ctx, None, device=DEV)
    emit({"phase": "paper", "net": "linear", "step": "fig4", "recipe": "accuracy_vs_bits",
          "accuracy_fp32": ref,
          "accuracy_by_input_bits": {str(b): avb.accuracy(params, ctx, b, device=DEV)
                                     for b in range(1, 9)}})
    pctx = paper_ctx(use_kernels=False)
    for act_bits in TL1_ACT_BITS:
        # the TL1 node's kernel output against its plain version on the same
        # input, every batch: the int path bit for bit (integer accumulate),
        # the fp32 path within TL1_TOL x max|plain| (sums in another order)
        batch_err = []

        def check(p, x, y):
            want = linear(p, x, pctx)
            err, top = (y - want).abs().max().item(), want.abs().max().item()
            tol = 0.0 if act_bits is not None else TL1_TOL * top
            batch_err.append({"max_abs_err": err, "max_abs_ref": top, "tol": tol,
                              "ok": err <= tol and bool(torch.isfinite(y).all())})

        reset_launches()
        with paper_layer_spy(check):
            acc = avb.tl1_accuracy(params, ctx, act_bits, device=DEV)
        torch.cuda.synchronize()
        launches = read_launches()
        plain = avb.tl1_accuracy(params, pctx, act_bits, device=DEV)
        expect = {**no_launches(), "lut_tl1": TL1_BATCHES}
        plan = TL1Plan(784, 10, act_bits=act_bits)
        err = max(b["max_abs_err"] for b in batch_err)
        emit({"phase": "paper", "net": "linear", "step": "tl1", "act_bits": act_bits,
              "accuracy": acc, "plain_accuracy": plain, "accuracy_fp32": ref,
              "table_bytes": plan.total_lut_bytes, "launches": launches,
              "expected_launches": expect, "max_abs_err": err, "batches": batch_err})
        if launches != expect:
            raise AssertionError(f"tl1 a{act_bits}: launches {launches} != {expect}")
        if len(batch_err) != TL1_BATCHES or not all(b["ok"] for b in batch_err):
            raise AssertionError(f"tl1 a{act_bits}: the kernel is off its plain version "
                                 f"(or a batch went unchecked): {batch_err}")
        add(launches)
    return {"launches": total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--phases",
        default="device,pack_kernel,kernel,serve,tl1_kernel,tl1_serve,moe_kernel,"
                "moe_serve,bmm_kernel,bmm_serve,paper",
    )
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
    from repro_torch.kernels.lut_affine import ops as lut_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    built = build.build(force=True)
    ptxas = {name: ptxas_report(log) for name, log in build.BUILD_LOG.items()}
    dynamic_smem = {
        "binary_matmul": {tile: build.load("binary_matmul").binary_matmul_smem_bytes(i)
                          for i, tile in enumerate(("decode", "prefill"))},
        "lut_tl1": build.load("lut_tl1").lut_tl1_smem_bytes(),
        # the main path's n = 3 planes, 32 entries
        "lut_affine": {regime: lut_ops._lib().lut_affine_smem_bytes(i, 3, 32)
                       for i, regime in enumerate(lut_ops.REGIMES)},
    }
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "tf32": {"matmul": False, "cudnn": False},
          "build_seconds": build.BUILD_SECONDS, "libraries": {k: str(v) for k, v in built.items()},
          "ptxas": ptxas, "dynamic_smem_bytes": dynamic_smem,
          "lut_affine_sass_loops": sass_loops(built["lut_affine"])})
    pkern = pack_kernel_phase(args.iters) if "pack_kernel" in phases else None
    kern = kernel_phase(args.iters, 4 * 32) if "kernel" in phases else None
    srv = serve_phase(LAYERS, REQUESTS, MAX_NEW) if "serve" in phases else None
    torch.cuda.empty_cache()
    tkern = tl1_kernel_phase(args.iters, 4 * 32) if "tl1_kernel" in phases else None
    tsrv = tl1_serve_phase(TL1_LAYERS, REQUESTS, MAX_NEW) if "tl1_serve" in phases else None
    torch.cuda.empty_cache()
    mkern = moe_kernel_phase(args.iters, SLOTS * BUCKET) if "moe_kernel" in phases else None
    msrv = moe_serve_phase(REQUESTS, MAX_NEW) if "moe_serve" in phases else None
    torch.cuda.empty_cache()
    bkern = bmm_kernel_phase(args.iters, SLOTS * BUCKET) if "bmm_kernel" in phases else None
    bsrv = bmm_serve_phase(BMM_LAYERS, REQUESTS, MAX_NEW) if "bmm_serve" in phases else None
    torch.cuda.empty_cache()
    paper = paper_phase(args.iters) if "paper" in phases else None
    rows = []
    for k, s, path, names in ((kern, srv, "serve", ("lut_affine", "lut_affine_grouped")),
                              (tkern, tsrv, "tl1_serve", ("lut_tl1", "lut_tl1_grouped")),
                              (mkern, msrv, "moe_serve", ("lut_affine_experts",)),
                              (bkern, bsrv, "bmm_serve", ("binary_matmul",))):
        if k is None or s is None:
            continue
        for name in names:
            m = k["main"][name]
            # lut_affine and lut_tl1 also run the paper networks
            by_path = {path: s["launches"][name]}
            if paper is not None and paper["launches"][name]:
                by_path["paper"] = paper["launches"][name]
            rows.append({
                "name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": sum(by_path.values()),
                **({"launches_by_path": by_path} if len(by_path) > 1 else {}),
                "max_abs_err": k["worst"][name], "ms": m["kernel_ms"],
                "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                "bound_by": "/".join(sorted(m["bound_by"])),
                "library_ms": m.get("library_ms"),
                **({"prefill_ms": m["prefill_ms"], "prefill_bound_ms": m["prefill_bound_ms"]}
                   if "prefill_ms" in m else {}),
            })
    # the packing kernel runs on four paths; its times are one binary-cell
    # decode layer's 7 packs (layer_ms and layer_bound_ms: each cell's layer)
    paths = {name: s for name, s in (("serve", srv), ("moe_serve", msrv), ("bmm_serve", bsrv),
                                     ("paper", paper))
             if s is not None}
    if pkern is not None and paths:
        m = pkern["layers"]["binary"]
        by_path = {name: s["launches"]["bitplane_pack"] for name, s in paths.items()}
        rows.append({
            "name": "bitplane_pack", "route": "cuda", "source": SOURCES["bitplane_pack"],
            "replaces": REPLACES["bitplane_pack"], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": pkern["worst"]["bitplane_pack"],
            "ms": m["kernel_ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": "/".join(sorted(m["bound_by"])), "library_ms": None,
            "prefill_ms": m["prefill_ms"], "prefill_bound_ms": m["prefill_bound_ms"],
            "layer_ms": {cell: c["kernel_ms"] for cell, c in pkern["layers"].items()},
            "layer_bound_ms": {cell: c["bound_ms"] for cell, c in pkern["layers"].items()},
        })
    if rows:
        emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
