"""Autotuner of the Hopper LUT kernels' tilings (counterpart of
``repro/kernels/lut_affine/autotune.py``: the same point, plan field, JSON
and CLI; another search space, legality check and cost model).

The reference tunes Pallas grid tiles ``(block_b, block_p, block_k)``
under a 4 MiB VMEM budget.  The port's kernels compile their row and
column tiles (``csrc/lut_affine.cu``: 512-byte slabs of every table row, 4
decode rows or 64 prefill rows a block; ``csrc/lut_tl1.cu``: 1024 columns,
``tile_rows(B)`` rows), so what a launch chooses is how k is cut: into
``splits`` balanced ranges, each its own blocks, whose fp32 (TL1: int32)
partials ``sum_splits`` adds in split order.  The axes keep their meaning:

* ``block_b`` -- batch rows per block: the compiled row count of the
  kernel the point runs (``min(4, 32 // n)`` for the dense decode kernel,
  64 for prefill, which takes only ``E <= 64``; ``tile_rows(B)`` for TL1);
* ``block_p`` -- output columns per block: ``512 // table_bytes`` for the
  LUT kernels, 1024 for TL1 (one value each);
* ``block_k`` -- chunks (TL1: packed rows) per k range, so ``splits =
  ceil(k / block_k)``.

A plan carries its winner in ``plan.blocks``; the dense wrappers
(``kernels/lut_affine/ops.py``, ``kernels/lut_tl1/ops.py``) obey it on a
dispatch that fits one row tile of the kernel it names -- the shape-rule
kernel has ``block_b`` rows and ``B <= block_b`` -- and keep the shape
rule, bit for bit, on every other (tiles tuned at a decode batch never
govern a prefill, whose partials at the decode's splits would take
gigabytes); the ragged expert kernel keeps its shape rule.  Every wrapper
refuses an illegal tiling (:func:`check_blocks`) on the kernel path and on
the plain path alike.  So only a point that fits one row tile of the
decode or TL1 kernel is tuned (:func:`tunable`); any other keeps ``None``.

Two search modes:

* ``analytic`` (default) -- :func:`analytic_cost`, a deterministic model of
  an H100 SXM (132 SMs) in microseconds: launches, waves of blocks, each
  block's walk over its chunks, the table bytes the blocks read and the
  partials, with constants fitted to the card's measured times
  (:data:`COST`).  A pure function of the point, so the
  committed baseline is re-searched on any host and drift fails (``python
  -m repro_torch.kernels.lut_affine.autotune check``).
* ``measured`` -- each candidate's device time on the card
  (:func:`_measure`, CUDA events; ``chip_smoke.py``'s autotune phase times
  through it too); raises without a CUDA device, since the plain versions
  ignore tiles.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import types
from pathlib import Path
from typing import Iterable, Mapping, Sequence

from repro_torch.kernels.lut_affine import ops as lut_ops
from repro_torch.kernels.lut_tl1 import ops as tl1_ops

BASELINE = Path(__file__).with_name("autotune_baseline.json")

SMS = 132  # H100 SXM
# dynamic shared memory a dense block may ask for (csrc/lut_affine.cu::kMaxSmem),
# within the 227 KB an H100 block has
MAX_SMEM = 200 * 1024
GRID_Z = 65535  # G * splits blocks along the grid's z
L2_BYTES = 50 * 2**20  # H100 SXM: measured operands are cycled past it
SPIN_CYCLES_PER_S = 1.98e9
_MEASURE_TRIES = 8  # rounds _measure may spend before it refuses to time

# mirrors of csrc/lut_affine.cu's shared-memory rules (decode_smem,
# prefill_smem) and csrc/lut_tl1.cu's kLutSmemBytes
_META_BYTES = 24 * 1024
_RED_BYTES = lut_ops.DECODE_ROWS * 32 * 16 * 4
_PREFILL_RING_BYTES = 96 * 1024
TL1_SMEM_BYTES = 64 * 1024
TL1_ROWS = (4, 8)  # the TL1 kernel's two instantiations (csrc/lut_tl1.cu::run)

# The cost model's constants (microseconds; fitted by
# repro_torch/benchmarks/fit_autotune_cost.py to device times measured on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit, see PERF.md): a launch (the
# kernel, and sum_splits when k is split), one chunk of a block's walk per
# kernel, a byte of table reads and of partials (written, then read back by
# sum_splits), and one step of sum_splits' walk over the splits; the _tl1
# ones TL1's kernels'.
COST = {
    "launch": 4.683,
    "chunk_decode": 0.2234,
    "chunk_tl1": 0.244,
    "bytes": 2.893e-07,
    "partial": 1.23e-06,
    "sum": 0.1651,
    "launch_tl1": 4.512,
    "partial_tl1": 3.979e-07,
    "sum_tl1": 0.1113,
}
# threads sum_splits keeps on the card at once (2048 an SM)
_SUM_THREADS = 2048 * SMS


@dataclasses.dataclass(frozen=True)
class TunePoint:
    """The shape a LUT dispatch presents to the kernel (either family).

    For ``family="tl1"`` the axes reinterpret: ``k`` counts *packed bytes*
    along the input (the ``lut_tl1`` chunk axis), ``entries`` is the 9-entry
    per-pair activation LUT, ``n`` is 1 and ``table_bytes`` 1 (uint8 packed
    indices).
    """

    B: int  # batch rows per dispatch (decode: batch size)
    k: int  # chunks (tl1: packed bytes)
    entries: int  # table entries per chunk (tl1: 9)
    p: int  # output features
    n: int  # planes (tl1: 1)
    G: int = 1  # grouped fan-out (1 = ungrouped)
    table_bytes: int = 4  # bytes per stored table element (4/2/1)
    family: str = "weight"  # table family: "weight" | "tl1"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Mapping) -> "TunePoint":
        # "family" is a string and absent from pre-TL1 baseline rows
        vals = {
            f.name: int(d[f.name])
            for f in dataclasses.fields(cls)
            if f.name != "family"
        }
        return cls(**vals, family=str(d.get("family", "weight")))

    @classmethod
    def from_plan(cls, plan, batch: int, G: int = 1) -> "TunePoint":
        if plan.table_family == "tl1":
            return cls(
                B=int(batch),
                k=plan.packed_chunks,
                entries=plan.num_entries,
                p=plan.out_features,
                n=1,
                G=int(G),
                table_bytes=1,
                family="tl1",
            )
        from repro_torch.core.lut import plane_scales

        return cls(
            B=int(batch),
            k=plan.num_chunks,
            entries=plan.num_entries,
            p=plan.out_features,
            n=len(plane_scales(plan)),
            G=int(G),
            table_bytes=max(1, plan.storage_bits // 8),
        )


# ---------------------------------------------------------------------------
# the kernels' tiles and legality
# ---------------------------------------------------------------------------


def decode_smem(n: int) -> int:
    """Dynamic shared memory of a decode block (``decode_smem`` in the source)."""
    rows = lut_ops.regime_rows("decode", n)
    kt = min(_META_BYTES // (rows * n * 8), 512)
    return max(kt * rows * n * 8, _RED_BYTES)


def prefill_smem(n: int, E: int) -> int:
    """Dynamic shared memory of a prefill block (``prefill_smem``): its
    ring of 3 or 4 ``E x 512``-byte stages and its staged references."""
    stages = 3 if _PREFILL_RING_BYTES // (E * lut_ops.SLAB_BYTES) < 4 else 4
    chunks = max(1, _META_BYTES // (lut_ops.PREFILL_ROWS * n * 8))
    return 128 + stages * (E * lut_ops.SLAB_BYTES + 16) + chunks * lut_ops.PREFILL_ROWS * n * 8


def point_kernels(pt: TunePoint) -> dict[int, str]:
    """Row tile -> kernel, for every compiled kernel that can run ``pt``."""
    if pt.family == "tl1":
        return {rows: "tl1" for rows in TL1_ROWS}
    kernels = {lut_ops.regime_rows("decode", pt.n): "decode"}
    if pt.entries <= lut_ops.PREFILL_MAX_E:
        kernels[lut_ops.PREFILL_ROWS] = "prefill"
    return kernels


def point_cols(pt: TunePoint) -> int:
    """Output columns a block owns (``block_p``)."""
    if pt.family == "tl1":
        return tl1_ops.TILE_COLS
    return lut_ops.SLAB_BYTES // pt.table_bytes


def point_rows(pt: TunePoint) -> int:
    """Row tile of the kernel the shape rule runs ``pt`` on (``block_b``)."""
    if pt.family == "tl1":
        return tl1_ops.tile_rows(pt.B)
    return lut_ops.regime_rows(lut_ops.regime_of(pt.B, pt.n, pt.entries), pt.n)


def kernel_smem(kernel: str, pt: TunePoint) -> int:
    if kernel == "tl1":
        return TL1_SMEM_BYTES
    if kernel == "prefill":
        return prefill_smem(pt.n, pt.entries)
    return decode_smem(pt.n)


def blocks_fit_smem(pt: TunePoint, blocks) -> bool:
    """Whether ``blocks`` is a legal Hopper tiling of ``pt``: ``block_b``
    and ``block_p`` are the compiled tiles of a kernel that can run the
    point, that kernel's shared memory fits :data:`MAX_SMEM`, and ``1 <=
    block_k <= k`` (with ``G * splits`` within the grid's z).

    The reusable legality predicate: :func:`candidate_blocks` enumerates
    with it, the wrappers refuse what it refuses (:func:`check_blocks`), and
    ``repro_torch.audit``'s ``blocks_over_smem`` re-checks every plan's."""
    if len(blocks) != 3:
        return False
    bb, bp, bk = (int(v) for v in blocks)
    kernel = point_kernels(pt).get(bb)
    if kernel is None or bp != point_cols(pt):
        return False
    if kernel_smem(kernel, pt) > MAX_SMEM or not 1 <= bk <= pt.k:
        return False
    return pt.G * -(-pt.k // bk) <= GRID_Z


def check_blocks(op: str, pt: TunePoint, blocks) -> None:
    """Raise ``ValueError`` naming the tiling and the point unless
    ``blocks`` (None: the shape rule) is legal for ``pt``."""
    if blocks is not None and not blocks_fit_smem(pt, blocks):
        raise ValueError(
            f"{op}: blocks {tuple(blocks)} are not a legal Hopper tiling at point "
            f"{pt} (block_b a compiled row tile {sorted(point_kernels(pt))}, "
            f"block_p {point_cols(pt)}, 1 <= block_k <= {pt.k})"
        )


def _grid(pt: TunePoint, rows: int) -> tuple[str, int, int]:
    """(kernel, output tiles, block slots of one wave on SMS SMs) of ``pt``
    on the kernel of ``rows`` rows."""
    kernel = point_kernels(pt)[rows]
    if kernel == "tl1":
        cols, slots = -(-pt.p // tl1_ops.TILE_COLS), tl1_ops.BLOCKS_PER_SM * SMS
    else:
        cols = -(-pt.p * pt.table_bytes // lut_ops.SLAB_BYTES)
        slots = lut_ops.BLOCKS_PER_SM[kernel] * SMS
    return kernel, pt.G * -(-pt.B // rows) * cols, slots


def rule_splits(pt: TunePoint) -> int:
    """The shape rule's k splits for ``pt`` on SMS SMs (``ops.tiling``,
    ``lut_tl1.ops.k_splits``)."""
    if pt.family == "tl1":
        return tl1_ops.k_splits(pt.G, pt.B, pt.k, pt.p, SMS)
    return lut_ops.tiling(pt.G, pt.B, pt.n, pt.k, pt.entries, pt.p * pt.table_bytes,
                          SMS).splits


def tunable(pt: TunePoint) -> bool:
    """Whether tiles would govern ``pt``'s dispatch and the cost model
    covers its kernel: it fits one row tile (``B <= block_b``) of the dense
    decode kernel or of the TL1 kernel.  A prefill point runs the shape
    rule (no tuned point is one yet, so the model has no prefill term)."""
    rows = point_rows(pt)
    return pt.B <= rows and point_kernels(pt)[rows] != "prefill"


def candidate_blocks(pt: TunePoint) -> list[tuple[int, int, int]]:
    """All candidate tilings of a :func:`tunable` ``pt`` (none of any
    other), on the kernel the shape rule runs it on: ``block_k`` over the
    powers of two up to ``k`` and ``k`` itself, and the ``block_k`` of the
    shape rule's splits and of the splits that fill one whole wave of
    blocks (on an H100 the one-wave split beats every power of two where
    the tiles divide the slots unevenly: TL1's ``w_gate+w_up`` at 14
    splits, PERF.md).

    The kernel is not a search axis: tiles govern only the dispatches
    whose shape-rule kernel has ``block_b`` rows, so a winner on another
    kernel would never run at its own point."""
    if not tunable(pt):
        return []
    rows, cols = point_rows(pt), point_cols(pt)
    _, tiles, slots = _grid(pt, rows)
    bks, bk = {pt.k}, 1
    while bk <= pt.k:
        bks.add(bk)
        bk *= 2
    for splits in (rule_splits(pt), slots // tiles):
        if splits >= 1:
            bks.add(-(-pt.k // min(splits, pt.k)))
    return [(rows, cols, b) for b in sorted(bks) if blocks_fit_smem(pt, (rows, cols, b))]


# ---------------------------------------------------------------------------
# the analytic cost model
# ---------------------------------------------------------------------------


def cost_terms(pt: TunePoint, blocks, cost: Mapping[str, float] | None = None
               ) -> dict[str, float]:
    """The cost model's terms for a :func:`tunable` ``pt`` under a legal
    ``blocks``, each read off the kernel's code (:data:`COST`, or ``cost``,
    weighs them):

    * ``launch`` -- the kernel, and ``sum_splits`` when k is split;
    * per wave of blocks (output tiles x splits over ``BLOCKS_PER_SM[kernel]
      x 132`` SMs), the longer of two: ``chunk_<kernel>``, the chunks
      (packed rows) a block walks in turn, its range of k (each step waits
      on its loads); or ``bytes``, the table bytes the wave's blocks read
      (the decode kernel only the 512-byte lines its references touch: the
      expected distinct rows of ``rows x n`` uniform codes among ``E``; TL1
      its columns of each packed row);
    * ``bytes`` also the codes read and the output written once;
    * ``partial`` -- ``splits x G x B x p x 4`` bytes of partials written
      and read again by ``sum_splits``;
    * ``sum`` -- ``sum_splits``' walk: each thread adds its element's
      partials eight loads at a time, in ``ceil(splits / 8)`` dependent
      steps, over as many rounds as its threads outnumber the card's.

    TL1's kernels are other kernels (a block builds its rows' LUTs; its
    ``sum_splits`` adds int32): their launch, partial and sum terms carry
    the suffix ``_tl1`` and constants of their own.
    """
    cost = COST if cost is None else cost
    bb, _, bk = (int(v) for v in blocks)
    kernel, tiles, slots = _grid(pt, bb)
    if kernel == "prefill":
        raise ValueError(f"the cost model has no term for the prefill kernel ({pt})")
    splits = -(-pt.k // bk)
    walk = -(-pt.k // splits)  # chunks of the largest range
    rows = min(bb, pt.B)
    if kernel == "tl1":
        per_chunk = min(pt.p, tl1_ops.TILE_COLS)  # a block's bytes of a packed row
        io = pt.B * 4 * pt.k * 4 + pt.G * pt.B * pt.p * 4
    else:
        slab = min(pt.p * pt.table_bytes, lut_ops.SLAB_BYTES)
        per_chunk = pt.entries * (1 - (1 - 1 / pt.entries) ** (rows * pt.n)) * slab
        io = pt.B * pt.n * pt.k * 4 + pt.G * pt.B * pt.p * 4
    chunk = f"chunk_{kernel}"
    blocks_n = tiles * splits
    waves = -(-blocks_n // slots)
    count = pt.G * pt.B * pt.p
    sfx = "_tl1" if kernel == "tl1" else ""
    terms = {"launch" + sfx: 1.0 + (splits > 1), chunk: 0.0, "bytes": float(io),
             "partial" + sfx: 0.0, "sum" + sfx: 0.0}
    if splits > 1:
        terms["partial" + sfx] = float(2 * splits * count * 4)
        terms["sum" + sfx] = float(-(-splits // 8) * -(-count // _SUM_THREADS))
    # the full waves, then the last (it holds the rest)
    for n_blocks, times in ((slots, waves - 1), (blocks_n - (waves - 1) * slots, 1)):
        wave_bytes = n_blocks * walk * per_chunk
        if walk * cost[chunk] >= wave_bytes * cost["bytes"]:
            terms[chunk] += times * walk
        else:
            terms["bytes"] += times * wave_bytes
    return terms


def analytic_cost(pt: TunePoint, blocks, cost: Mapping[str, float] | None = None) -> float:
    """Modelled microseconds of ``pt`` under ``blocks`` on an H100 (lower =
    better); ``cost`` overrides :data:`COST`."""
    cost = COST if cost is None else cost
    return sum(cost[name] * v for name, v in cost_terms(pt, blocks, cost).items())


# ---------------------------------------------------------------------------
# measured mode
# ---------------------------------------------------------------------------

# the TL1 kernels are timed at int8 activations, every TL1 plan's entry
# format (uint16 entries: kernels/lut_tl1/ops.py::entry_format)
_TL1_TIMING_PLAN = types.SimpleNamespace(act_bits=8)


def _require_cuda() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "autotune mode 'measured' times the kernels on a CUDA device, and none "
            "is available (the plain versions ignore tiles)"
        )


def measure_operands(pt: TunePoint) -> dict:
    """Random codes (TL1: int8 activation codes) and zero tables of
    ``pt``'s shape, as ``{"call", "tables"}``: ``call(blocks, t)`` launches
    the port's kernel for ``pt`` on one of ``tables``, as many copies as
    cycle past the L2, so that every timed call reads them from HBM as
    serving does."""
    import torch

    _require_cuda()
    device = "cuda"
    gen = torch.Generator(device=device).manual_seed(0)
    if pt.family == "tl1":
        inputs = torch.randint(-127, 128, (pt.B, 4 * pt.k), generator=gen,
                               dtype=torch.int32, device=device)
        shape, dtype = (pt.G, pt.k, pt.p), torch.uint8
    else:
        inputs = torch.randint(0, pt.entries, (pt.B, pt.n, pt.k), generator=gen,
                               dtype=torch.int32, device=device)
        shape = (pt.G, pt.k, pt.entries, pt.p)
        dtype = {1: torch.int8, 2: torch.int16, 4: torch.float32}[pt.table_bytes]
    nbytes = math.prod(shape) * pt.table_bytes
    copies = min(64, max(1, -(-2 * L2_BYTES // max(1, nbytes))))
    tables = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(copies)]
    scales = [1.0] * pt.n

    def call(blocks, t):
        if pt.family == "tl1":
            entry = "lut_tl1" if pt.G == 1 else "lut_tl1_grouped"
            return tl1_ops._launch(entry, inputs, t, _TL1_TIMING_PLAN, blocks=blocks)
        if pt.G == 1:
            return lut_ops.lut_affine(inputs, t[0], scales, blocks=blocks)
        return lut_ops.lut_affine_grouped(inputs, t, scales, blocks=blocks)

    return {"call": call, "tables": tables}


def _measure(operands: dict, blocks, reps: int = 5) -> float:
    """Median device seconds of one ``operands["call"](blocks, t)`` (None:
    the shape rule), ``t`` cycling over ``operands["tables"]``: ``reps``
    calls back to back between a pair of CUDA events, held behind a spin
    kernel until the host has enqueued them all, over three rounds.
    Raises without a CUDA device: the plain versions ignore tiles."""
    import time

    import torch

    _require_cuda()
    call, tables = operands["call"], operands["tables"]

    def run(i):
        return call(blocks, tables[i % len(tables)])

    run(0), run(1)  # build, first-use costs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(0)
    torch.cuda.synchronize()
    spin = 2 * reps * (time.perf_counter() - t0) + 1e-3
    times = []
    for _ in range(_MEASURE_TRIES):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin * SPIN_CYCLES_PER_S))
        a.record()
        for i in range(reps):
            run(i)
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead:
            times.append(a.elapsed_time(b) / reps / 1e3)
            if len(times) == 3:
                return statistics.median(times)
        else:  # the device caught up with the host: hold it longer
            spin *= 4
    raise RuntimeError("autotune: the host never got ahead of the device; timing refused")


def measure_candidates(pt: TunePoint, reps: int = 5, operands: dict | None = None
                       ) -> dict[tuple | None, float]:
    """The shape rule (``None``) and every candidate tiling of ``pt`` -> its
    :func:`_measure` seconds, on one set of operands (``operands``, as
    :func:`measure_operands` makes them, or those)."""
    operands = measure_operands(pt) if operands is None else operands
    return {blk: _measure(operands, blk, reps) for blk in [None, *candidate_blocks(pt)]}


def search_blocks(
    pt: TunePoint, mode: str = "analytic", reps: int = 5
) -> tuple[int, int, int] | None:
    """Best ``(block_b, block_p, block_k)`` for ``pt`` under ``mode``.

    Ties break lexicographically on the tiling itself, so the analytic
    winner is a pure function of the point -- the property the drift check
    relies on."""
    if mode not in ("analytic", "measured"):
        raise ValueError(f"unknown autotune mode {mode!r}")
    cands = candidate_blocks(pt)
    if not cands:
        return None
    if mode == "analytic":
        return min(cands, key=lambda blk: (analytic_cost(pt, blk), blk))
    times = measure_candidates(pt, reps)
    return min(cands, key=lambda blk: (times[blk], blk))


# ---------------------------------------------------------------------------
# ModelPlan integration
# ---------------------------------------------------------------------------


def _group_sizes(mplan) -> dict[str, int]:
    """Layer key -> fused fan-out G (members of the same pre-stacked group)."""
    sizes: dict[str, int] = {}
    for group in mplan.groups:
        for key in group:
            sizes[key] = len(group)
    return sizes


def attach_tuned_blocks(mplan, batch: int, mode: str = "analytic"):
    """Return ``mplan`` with every layer plan's ``blocks`` set to the tuned
    tiling for a ``batch``-row dispatch (decode: the serving batch size).

    Group members present one point (the same plan, the group's ``G``), so
    the same search gives them the same tiles and pre-stacked groups still
    fuse.  An expert layer's point is its plan's, as in the reference; the
    ragged kernel checks its tiles and keeps its shape rule
    (``ops.experts_tiling``).  A point that is not :func:`tunable` gets
    ``None``."""
    sizes = _group_sizes(mplan)
    found: dict[TunePoint, tuple | None] = {}
    layers = {}
    for key, plan in mplan.layers.items():
        pt = TunePoint.from_plan(plan, batch, G=sizes.get(key, 1))
        if pt not in found:
            found[pt] = search_blocks(pt, mode)
        layers[key] = dataclasses.replace(plan, blocks=found[pt])
    return dataclasses.replace(mplan, layers=layers)


# ---------------------------------------------------------------------------
# Baseline file + drift check
# ---------------------------------------------------------------------------


def points_from_model_plan(mplan, batch: int) -> list[TunePoint]:
    """Deduplicated shape points a ModelPlan dispatches at ``batch`` rows."""
    sizes = _group_sizes(mplan)
    seen: dict[TunePoint, None] = {}
    for key, plan in sorted(mplan.layers.items()):
        seen.setdefault(TunePoint.from_plan(plan, batch, G=sizes.get(key, 1)))
    return list(seen)


def write_baseline(path, points: Iterable[TunePoint], mode: str = "analytic"):
    rows = []
    for pt in points:
        blocks = search_blocks(pt, mode)
        rows.append({**pt.to_json(), "blocks": list(blocks) if blocks else None})
    payload = {"mode": mode, "points": rows}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return payload


def check_baseline(path) -> list[str]:
    """Re-search every recorded point; return human-readable mismatches."""
    with open(path) as f:
        payload = json.load(f)
    errs = []
    for row in payload["points"]:
        pt = TunePoint.from_json(row)
        got = search_blocks(pt, payload.get("mode", "analytic"))
        want = tuple(row["blocks"]) if row["blocks"] is not None else None
        if (tuple(got) if got else None) != want:
            errs.append(f"{pt}: committed {want}, re-search found {got}")
    return errs


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("write", "check"):
        sp = sub.add_parser(name)
        sp.add_argument("--baseline", default=str(BASELINE))
        if name == "write":
            sp.add_argument("--mode", default="analytic")
            sp.add_argument(
                "--plan", help="ModelPlan JSON to derive shape points from"
            )
            sp.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    if args.cmd == "check":
        errs = check_baseline(args.baseline)
        for e in errs:
            print(f"autotune drift: {e}", file=sys.stderr)
        if errs:
            return 1
        with open(args.baseline) as f:
            n = len(json.load(f)["points"])
        print(f"autotune baseline OK: {n} points re-searched, no drift")
        return 0
    if args.plan:
        from repro_torch.core.planner import ModelPlan

        with open(args.plan) as f:
            mplan = ModelPlan.from_json(json.load(f))
        points = points_from_model_plan(mplan, args.batch)
    else:  # refresh winners for the points already recorded
        with open(args.baseline) as f:
            points = [TunePoint.from_json(r) for r in json.load(f)["points"]]
    write_baseline(args.baseline, points, args.mode)
    print(f"wrote {args.baseline}: {len(points)} points ({args.mode})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
