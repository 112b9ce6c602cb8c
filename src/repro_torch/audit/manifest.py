"""Audit manifest: build, persist, and diff the per-point verdicts
(counterpart of ``repro/audit/manifest.py``).

The manifest is the JSON ``python -m repro_torch.audit`` emits and the
package commits as ``audit/baseline.json``: one entry per audit point with
its rule verdicts, plan summary, op census and precision report.
``--check`` rebuilds it fresh and fails on

* any rule violation in the fresh manifest (the invariants themselves);
* op-census drift against the baseline (a silent change of a step: new
  ops in a decode step, a vanished kernel launch);
* precision drift against the baseline (a layer's proved accumulator
  bound, minimal safe dtype or worst-case error bound changed: the numbers
  are certificates, so any movement is a semantics change);
* a baseline point missing from the fresh run (a deleted gate).

The census is of aten ops as this installation's PyTorch dispatches them,
recorded on the CPU's plain path: another PyTorch version may decompose
differently, so the baseline is regenerated with ``--write`` (which
refuses a manifest that violates the invariants) when the installation
moves, and a card's run checks the rules alone.
"""
from __future__ import annotations

import json

# v1: the port's first manifest (the reference's v2 rules plus "inplace",
# minus "donation")
MANIFEST_VERSION = 1


class ManifestError(Exception):
    """A malformed or unusable manifest file."""


def build_manifest(points=None) -> dict:
    from repro_torch.audit.points import AUDIT_POINTS, audit_point

    points = AUDIT_POINTS if points is None else points
    return {
        "version": MANIFEST_VERSION,
        "points": {pt.name: audit_point(pt) for pt in points},
    }


def manifest_violations(manifest: dict) -> list[str]:
    """Flatten every rule violation in a manifest to human-readable lines."""
    out = []
    for name, entry in sorted(manifest.get("points", {}).items()):
        for rule, violations in sorted(entry.get("rules", {}).items()):
            for v in violations:
                out.append(
                    f"{name}: {rule} violated by {v['primitive']}: {v['detail']}"
                )
    return out


def diff_manifests(fresh: dict, baseline: dict) -> list[str]:
    """Census/precision/coverage drift against the committed baseline, one
    line per point and step listing every drifted op as ``op base->fresh
    (+-d)``."""
    out = []
    base_points = baseline.get("points", {})
    fresh_points = fresh.get("points", {})
    for name in sorted(set(base_points) - set(fresh_points)):
        out.append(f"{name}: baseline point missing from fresh audit")
    for name in sorted(set(fresh_points) - set(base_points)):
        out.append(f"{name}: new audit point not in baseline (run --write)")
    for name in sorted(set(base_points) & set(fresh_points)):
        base_census = base_points[name].get("census", {})
        fresh_census = fresh_points[name].get("census", {})
        for graph in sorted(set(base_census) | set(fresh_census)):
            b = base_census.get(graph, {})
            f = fresh_census.get(graph, {})
            drifted = [
                f"{op} {b.get(op, 0)}->{f.get(op, 0)} "
                f"({f.get(op, 0) - b.get(op, 0):+d})"
                for op in sorted(set(b) | set(f))
                if b.get(op, 0) != f.get(op, 0)
            ]
            if drifted:
                out.append(f"{name}/{graph}: op census drift: " + ", ".join(drifted))
        bp = base_points[name].get("precision", {})
        fp = fresh_points[name].get("precision", {})
        for layer in sorted(set(bp) - set(fp)):
            out.append(f"{name}: precision entry {layer!r} missing from fresh audit")
        for layer in sorted(set(fp) - set(bp)):
            out.append(f"{name}: new precision entry {layer!r} not in baseline")
        for layer in sorted(set(bp) & set(fp)):
            bl, fl = bp[layer], fp[layer]
            changed = [
                f"{k} {bl.get(k)}->{fl.get(k)}"
                for k in sorted(set(bl) | set(fl))
                if bl.get(k) != fl.get(k)
            ]
            if changed:
                out.append(f"{name}: precision drift at {layer!r}: " + ", ".join(changed))
    return out


def load_manifest(path: str) -> dict:
    """Load a manifest, raising :class:`ManifestError` on anything off."""
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise ManifestError(
            f"manifest {path!r} not found — generate it with "
            f"`python -m repro_torch.audit --write`"
        ) from None
    except json.JSONDecodeError as e:
        raise ManifestError(f"manifest {path!r} is not valid JSON: {e}") from None
    if not isinstance(manifest, dict) or "points" not in manifest:
        raise ManifestError(
            f"manifest {path!r} is malformed: expected an object with a "
            f"'points' key"
        )
    if manifest.get("version") != MANIFEST_VERSION:
        raise ManifestError(
            f"manifest {path!r} has version {manifest.get('version')!r}, "
            f"this tool expects {MANIFEST_VERSION}"
        )
    return manifest


def write_manifest(path: str, manifest: dict) -> None:
    with open(path, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
