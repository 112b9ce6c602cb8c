"""CLI: audit the committed config matrix, gate on the baseline.

Modes (mutually exclusive):

* default      -- build the manifest, print a summary (and ``--out`` it)
* ``--check``  -- rebuild fresh, fail on any rule violation, op-census
                  drift vs ``--baseline``, or missing point
* ``--write``  -- regenerate ``--baseline`` after a reviewed step change;
                  refuses to snapshot a manifest with violations

``--point NAME`` (repeat for several) restricts the run to the named
points; under ``--check`` the baseline comparison restricts to the same
selection.  ``--point`` is not valid with ``--write``: a partial baseline
would silently drop the other gates.  Every point runs on the CPU, on the
reduced configs (~10 s for all three).  Exit 1 = violation or drift, 2 =
missing or malformed baseline.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Sequence

from repro_torch.audit.manifest import (
    ManifestError,
    build_manifest,
    diff_manifests,
    load_manifest,
    manifest_violations,
    write_manifest,
)

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def _summarise(manifest: dict) -> str:
    lines = []
    for name, entry in sorted(manifest["points"].items()):
        n_viol = sum(len(v) for v in entry["rules"].values())
        plan = entry["plan"]
        census = entry["census"]["decode"]
        lines.append(
            f"  {name}: {plan['layers']} layers "
            f"({'+'.join(plan['families'])}), "
            f"{plan['total_lut_bytes'] / 2**20:.1f} MiB tables, "
            f"{sum(census.values())} decode ops, "
            f"{n_viol} violations"
        )
    return "\n".join(lines)


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.audit", description=__doc__.splitlines()[0]
    )
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true", help="gate against the baseline")
    mode.add_argument("--write", action="store_true", help="regenerate the baseline")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--out", help="also write the fresh manifest here")
    ap.add_argument(
        "--point", action="append", metavar="NAME",
        help="restrict to the named audit point (repeatable)",
    )
    args = ap.parse_args(argv)
    if args.point and args.write:
        ap.error("--point is not valid with --write (partial baseline)")

    points = None
    if args.point:
        from repro_torch.audit.points import AUDIT_POINTS

        by_name = {pt.name: pt for pt in AUDIT_POINTS}
        unknown = sorted(set(args.point) - set(by_name))
        if unknown:
            ap.error(f"unknown audit point(s) {unknown}; known: {sorted(by_name)}")
        points = tuple(by_name[n] for n in dict.fromkeys(args.point))

    baseline = None
    if args.check:
        # load before the fresh build so a missing or malformed baseline
        # fails loudly and at once
        try:
            baseline = load_manifest(args.baseline)
        except ManifestError as e:
            print(f"audit: {e}", file=sys.stderr)
            return 2

    fresh = build_manifest(points=points)
    violations = manifest_violations(fresh)
    if args.out:
        write_manifest(args.out, fresh)

    if args.check:
        if points is not None:
            # compare only the selected points: a restricted run must not
            # report the unselected baseline points as deleted gates
            baseline = dict(baseline)
            baseline["points"] = {
                k: v for k, v in baseline.get("points", {}).items() if k in fresh["points"]
            }
        errs = violations + diff_manifests(fresh, baseline)
        for e in errs:
            print(f"audit: {e}", file=sys.stderr)
        if errs:
            return 1
        n = len(fresh["points"])
        print(f"audit OK: {n} points, all invariants hold, census matches")
        print(_summarise(fresh))
        return 0

    if args.write:
        if violations:
            for e in violations:
                print(f"audit: {e}", file=sys.stderr)
            print("audit: refusing to write a baseline with violations", file=sys.stderr)
            return 1
        write_manifest(args.baseline, fresh)
        print(f"wrote {args.baseline}: {len(fresh['points'])} points")
        print(_summarise(fresh))
        return 0

    for e in violations:
        print(f"audit: {e}", file=sys.stderr)
    print(f"audited {len(fresh['points'])} points:")
    print(_summarise(fresh))
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
