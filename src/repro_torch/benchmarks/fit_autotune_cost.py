"""Fit the Hopper autotuner's cost model (``kernels/lut_affine/autotune.py``
:data:`~repro_torch.kernels.lut_affine.autotune.COST`) to the device times
that ``chip_smoke.py``'s autotune phase measured on the card.

The phase prints one ``point`` line per tuned point with every candidate
tiling's time (``candidate_ms``); this script reads those lines from a log
of ``chip_smoke.py``'s standard output and prints the fitted constants,
which go into ``COST`` by hand, beside the card's name and power limit:

    python3 chip_smoke.py --phases device,autotune > smoke.jsonl   # on the card
    PYTHONPATH=src python -m repro_torch.benchmarks.fit_autotune_cost smoke.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Iterable, Mapping, Sequence

from repro_torch.kernels.lut_affine.autotune import (
    COST,
    TunePoint,
    analytic_cost,
    cost_terms,
    point_cols,
    point_rows,
)

FIT_ROUNDS = 50  # rounds at most (the fit stops when a round repeats)


def _lstsq(rows: list, start: Mapping[str, float]) -> dict[str, float]:
    """Non-negative least squares on the relative error of ``(terms, us)``
    rows: a constant that comes out negative is set to 0 and the rest
    refitted; a term no row exercises keeps its ``start`` value."""
    import numpy as np

    names = [n for n in start if any(t.get(n) for t, _ in rows)]
    fitted = dict(start)
    live = list(names)
    while live:
        a = np.array([[t.get(n, 0.0) / us for n in live] for t, us in rows])
        coef, *_ = np.linalg.lstsq(a, np.ones(len(rows)), rcond=None)
        if (coef >= 0).all():
            fitted.update({n: float(c) for n, c in zip(live, coef)})
            break
        live.pop(int(np.argmin(coef)))
    fitted.update({n: 0.0 for n in names if n not in live})
    return fitted


def fit_cost(samples: Iterable[tuple[TunePoint, tuple, float]]) -> dict[str, float]:
    """Constants for ``analytic_cost`` from measured ``(point, blocks,
    seconds)`` samples.  Each wave's term depends on the constants (the
    longer of its walk and its bytes), so the fit alternates: the terms
    under the current constants, then least squares on the relative error
    with every constant non-negative (``COST`` to start); it returns the
    constants of the round with the least squared relative error."""
    samples = [(pt, blocks, s * 1e6) for pt, blocks, s in samples]
    fitted, best = dict(COST), (math.inf, dict(COST))
    for _ in range(FIT_ROUNDS):
        rows = [(cost_terms(pt, blocks, fitted), us) for pt, blocks, us in samples]
        fitted = _lstsq(rows, fitted)
        err = sum((analytic_cost(pt, blocks, fitted) / us - 1) ** 2
                  for pt, blocks, us in samples)
        if err < best[0]:
            best = (err, dict(fitted))
        elif err == best[0]:
            break
    return best[1]


def samples_from_log(lines: Iterable[str]) -> list[tuple[TunePoint, tuple, float]]:
    """``(point, blocks, seconds)`` of every candidate the autotune phase
    timed on the dense and TL1 kernels (its ``point`` lines; the ragged
    expert kernel is not the model's)."""
    out = []
    for line in lines:
        if not line.startswith("{"):
            continue
        row = json.loads(line)
        if (row.get("phase"), row.get("step"), row.get("kernel")) != ("autotune", "point", None):
            continue
        pt = TunePoint.from_json(row["point"])
        rows, cols = point_rows(pt), point_cols(pt)
        out += [(pt, (rows, cols, int(bk)), ms * 1e-3) for bk, ms in row["candidate_ms"].items()]
    return out


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logs", nargs="+", help="chip_smoke.py standard output with autotune lines")
    args = ap.parse_args(argv)
    samples = []
    for path in args.logs:
        with open(path) as f:
            samples += samples_from_log(f)
    print(json.dumps({"samples": len(samples), "fitted": fit_cost(samples)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
