"""Partition planner (counterpart of ``repro/core/planner.py``, both
table families).

:func:`plan_model` walks a parameter tree, enumerates the Pareto frontier
of plans for every eligible linear layer (fusable sibling groups as one
item), drops candidates whose certified accumulator bound overflows, and
greedily spends a global LUT byte budget where it buys the largest
reduction in shift/add work.  It reads only shapes, so ``meta`` tensors
plan a full-width model without allocating it.  The resulting
:class:`ModelPlan` JSON is the reference's: a plan made by either package
converts identically in the other.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence, Union

from repro_torch.core.lut import LUTPlan
from repro_torch.core.lut_tl1 import TL1Plan
from repro_torch.core.quantize import FixedPointFormat, Float16Format

TABLE_FAMILIES = ("weight", "tl1")
AnyPlan = Union[LUTPlan, TL1Plan]


@dataclasses.dataclass(frozen=True)
class PlanPoint:
    plan: AnyPlan
    num_tables: int
    lut_bytes: int
    lut_evaluations: int
    shift_add_ops: int

    @staticmethod
    def of(plan: AnyPlan) -> "PlanPoint":
        return PlanPoint(
            plan=plan,
            num_tables=plan.num_chunks,
            lut_bytes=plan.total_lut_bytes,
            lut_evaluations=plan.lut_evaluations,
            shift_add_ops=plan.shift_add_ops,
        )


def _narrow_format_safe(fmt, mode: str) -> bool:
    """i8/i16 storage with one power-of-2 scale per table set is accuracy
    safe only where entries do not bake in the fp16 exponent range."""
    if isinstance(fmt, Float16Format):
        return mode == "bitplane_shift"
    return mode == "bitplane"


def enumerate_plans(
    in_features: int,
    out_features: int,
    fmt,
    modes: Sequence[str] = ("bitplane", "full"),
    max_index_bits: int = 24,
    max_chunk: int | None = None,
    table_formats: Sequence[str | None] = (None,),
) -> list[PlanPoint]:
    """All uniform-chunk plans whose index width stays implementable."""
    points: list[PlanPoint] = []
    is_float = isinstance(fmt, Float16Format)
    for mode in modes:
        if is_float:
            if mode == "bitplane":
                fpe = fmt.fields_per_element
            elif mode == "bitplane_shift":
                fpe = fmt.mantissa_radix + (1 if fmt.signed else 0)
            else:
                fpe = 15
        else:
            if mode == "bitplane_shift":
                continue
            fpe = 1 if mode == "bitplane" else fmt.total_bits
        hi = max_index_bits // fpe
        if max_chunk is not None:
            hi = min(hi, max_chunk)
        for m in range(1, max(hi, 0) + 1):
            if mode in ("full", "bitplane_shift") and is_float and m != 1:
                continue
            for table_format in table_formats:
                if table_format is not None and not _narrow_format_safe(fmt, mode):
                    continue
                try:
                    plan = LUTPlan(
                        in_features,
                        out_features,
                        m,
                        fmt,
                        mode=mode,
                        table_format=table_format,
                    )
                except ValueError:
                    continue
                points.append(PlanPoint.of(plan))
    return points


def tradeoff_curve(points: Iterable[PlanPoint]) -> list[PlanPoint]:
    """Pareto frontier of (lut_bytes, shift_add_ops), sorted by size."""
    pts = sorted(points, key=lambda p: (p.lut_bytes, p.shift_add_ops))
    frontier: list[PlanPoint] = []
    best_ops = math.inf
    for p in pts:
        if p.shift_add_ops < best_ops:
            frontier.append(p)
            best_ops = p.shift_add_ops
    return frontier


# ---------------------------------------------------------------------------
# JSON, shared with the reference
# ---------------------------------------------------------------------------


def _fmt_to_json(fmt) -> dict:
    if isinstance(fmt, Float16Format):
        out = {"kind": "float16", "signed": fmt.signed}
        if fmt.mantissa_radix != 1:
            out["mantissa_radix"] = fmt.mantissa_radix
        return out
    return {
        "kind": "fixed",
        "total_bits": fmt.total_bits,
        "frac_bits": fmt.frac_bits,
        "signed": fmt.signed,
    }


def _fmt_from_json(d: Mapping) -> Any:
    if d["kind"] == "float16":
        return Float16Format(
            signed=d["signed"], mantissa_radix=d.get("mantissa_radix", 1)
        )
    return FixedPointFormat(d["total_bits"], d["frac_bits"], signed=d["signed"])


def plan_to_json(plan: AnyPlan) -> dict:
    if isinstance(plan, TL1Plan):
        out = {
            "family": "tl1",
            "in_features": plan.in_features,
            "out_features": plan.out_features,
            "act_bits": plan.act_bits,
        }
        if plan.blocks is not None:
            out["blocks"] = list(plan.blocks)
        # defaults stay implicit, as in the reference's JSON
        if plan.act_bits is not None and plan.acc_dtype != "int32":
            out["acc_dtype"] = plan.acc_dtype
        if plan.max_abs_acc is not None:
            out["max_abs_acc"] = plan.max_abs_acc
        return out
    out = {
        "in_features": plan.in_features,
        "out_features": plan.out_features,
        "chunk_size": plan.chunk_size,
        "fmt": _fmt_to_json(plan.fmt),
        "mode": plan.mode,
        "out_bits": plan.out_bits,
    }
    if plan.table_format is not None:
        out["table_format"] = plan.table_format
    if plan.blocks is not None:
        out["blocks"] = list(plan.blocks)
    if plan.acc_dtype != "float32":
        out["acc_dtype"] = plan.acc_dtype
    if plan.max_abs_acc is not None:
        out["max_abs_acc"] = plan.max_abs_acc
    return out


def plan_from_json(d: Mapping) -> AnyPlan:
    # plans written before the TL1 family existed carry no "family"
    family = d.get("family", "weight")
    blocks = d.get("blocks")
    if family == "tl1":
        return TL1Plan(
            d["in_features"],
            d["out_features"],
            act_bits=d.get("act_bits", 8),
            blocks=tuple(blocks) if blocks is not None else None,
            acc_dtype=d.get("acc_dtype", "int32"),
            max_abs_acc=d.get("max_abs_acc"),
        )
    if family != "weight":
        raise ValueError(f"unknown table family {family!r}")
    return LUTPlan(
        d["in_features"],
        d["out_features"],
        d["chunk_size"],
        _fmt_from_json(d["fmt"]),
        mode=d["mode"],
        out_bits=d["out_bits"],
        table_format=d.get("table_format"),
        blocks=tuple(blocks) if blocks is not None else None,
        acc_dtype=d.get("acc_dtype", "float32"),
        max_abs_acc=d.get("max_abs_acc"),
    )


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    """Per-layer LUT plans keyed by the layer's ``"/"``-joined tree path,
    the fusable sibling ``groups`` and the per-entry table-set ``copies``
    (product of leading scan dims)."""

    layers: Mapping[str, AnyPlan]
    budget_bytes: int | None = None
    groups: tuple = ()
    copies: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @property
    def families(self) -> tuple[str, ...]:
        present = {p.table_family for p in self.layers.values()}
        return tuple(f for f in TABLE_FAMILIES if f in present)

    @property
    def total_lut_bytes(self) -> int:
        return sum(
            self.copies.get(k, 1) * p.total_lut_bytes for k, p in self.layers.items()
        )

    @property
    def total_shift_add_ops(self) -> int:
        return sum(
            self.copies.get(k, 1) * p.shift_add_ops for k, p in self.layers.items()
        )

    def to_json(self) -> dict:
        return {
            "budget_bytes": self.budget_bytes,
            "layers": {k: plan_to_json(p) for k, p in sorted(self.layers.items())},
            "groups": [list(g) for g in self.groups],
            "copies": {k: v for k, v in sorted(self.copies.items()) if v != 1},
        }

    @classmethod
    def from_json(cls, d: Mapping) -> "ModelPlan":
        return cls(
            layers={k: plan_from_json(v) for k, v in d["layers"].items()},
            budget_bytes=d.get("budget_bytes"),
            groups=tuple(tuple(g) for g in d.get("groups", [])),
            copies=dict(d.get("copies", {})),
        )

    def summary(self) -> str:
        return (
            f"ModelPlan: {len(self.layers)} layers "
            f"({len(self.groups)} fused groups, "
            f"families {'+'.join(self.families) or 'none'}), "
            f"{self.total_lut_bytes / 2**20:.1f} MiB tables, "
            f"{self.total_shift_add_ops:,} shift/add ops"
        )


def path_key(path: Sequence) -> str:
    return "/".join(str(p) for p in path)


def _copies(w) -> int:
    return int(math.prod(int(d) for d in w.shape[:-2]))


def iter_linear_layers(
    params: dict,
    min_features: int = 1,
    predicate: Callable[[tuple, dict], bool] | None = None,
    convert_experts: bool = False,
) -> Iterator[tuple[str, tuple[int, int], int]]:
    """Yield ``(path_key, (in_features, out_features), copies)`` for every
    linear node ``convert_params`` would convert (same eligibility); with
    ``convert_experts`` the raw MoE expert stacks too (``.../w_gate`` ...),
    each one item whose ``copies`` is the product of its leading
    (layer, expert) dims."""
    from repro_torch.core.convert import (
        EXPERT_WEIGHT_KEYS,
        _is_expert_stack,
        _is_linear_node,
    )

    def eligible(path: tuple, node: dict) -> bool:
        q = node["w"].shape[-2]
        return q >= min_features and (predicate is None or predicate(path, node))

    def walk(path: tuple, node: Any):
        if _is_linear_node(node):
            if eligible(path, node):
                q, p = node["w"].shape[-2:]
                yield path_key(path), (int(q), int(p)), _copies(node["w"])
            return
        if not isinstance(node, dict):
            return
        if convert_experts and _is_expert_stack(node):
            for k, v in node.items():
                if k in EXPERT_WEIGHT_KEYS:
                    mpath = path + (k,)
                    if eligible(mpath, {"w": v}):
                        q, p = v.shape[-2:]
                        yield path_key(mpath), (int(q), int(p)), _copies(v)
                else:
                    yield from walk(path + (k,), v)
            return
        for k in node:
            yield from walk(path + (k,), node[k])

    yield from walk((), params)


def iter_sibling_groups(
    params: dict,
    min_features: int = 1,
    predicate: Callable[[tuple, dict], bool] | None = None,
    convert_experts: bool = False,
) -> Iterator[tuple[str, ...]]:
    """Yield fusable sibling groups as tuples of layer path keys, the same
    detection ``convert_params(group_siblings=True)`` runs; with
    ``convert_experts`` the same-shape expert stacks (gate/up) too."""
    from repro_torch.core.convert import (
        EXPERT_WEIGHT_KEYS,
        _is_expert_stack,
        _is_linear_node,
        expert_sibling_groups,
        sibling_groups,
    )

    def eligible(path: tuple, node: dict) -> bool:
        q = node["w"].shape[-2]
        return q >= min_features and (predicate is None or predicate(path, node))

    def walk(path: tuple, node: Any):
        if not isinstance(node, dict) or _is_linear_node(node):
            return
        if _is_expert_stack(node):
            if convert_experts:
                for members in expert_sibling_groups(node):
                    if all(eligible(path + (m,), {"w": node[m]}) for m in members):
                        yield tuple(path_key(path + (m,)) for m in members)
            for k, v in node.items():
                if k not in EXPERT_WEIGHT_KEYS:
                    yield from walk(path + (k,), v)
            return
        for members in sibling_groups(node):
            if all(eligible(path + (m,), node[m]) for m in members):
                yield tuple(path_key(path + (m,)) for m in members)
        for k, v in node.items():
            yield from walk(path + (k,), v)

    yield from walk((), params)


def plan_model(
    params: dict,
    max_lut_bytes: int | float,
    fmt=None,
    modes: Sequence[str] = ("bitplane",),
    max_chunk: int | None = None,
    min_features: int = 1,
    predicate: Callable[[tuple, dict], bool] | None = None,
    signed: bool = True,
    group_siblings: bool = True,
    convert_experts: bool = False,
    radices: Sequence[int] = (1,),
    table_formats: Sequence[str | None] = (None,),
    families: Sequence[str] = ("weight",),
    tl1_act_bits: int | None = 8,
    tl1_acc_dtype: str = "int32",
) -> ModelPlan:
    """Choose a per-layer plan for every eligible linear under a global
    byte budget: the reference's greedy knapsack over each item's Pareto
    frontier, certificate gate included.  With ``"tl1"`` in ``families``
    each frontier also carries the TL1 point (``tl1_act_bits``
    activations, ``tl1_acc_dtype`` accumulator), so layers may land in
    different families.  Raises ``ValueError`` if even the minimal plans
    exceed the budget or no candidate of a layer passes its certificate."""
    from repro_torch.audit.ranges import layer_range_cert
    from repro_torch.kernels.common import acc_capacity

    families = tuple(families)
    if not families or any(f not in TABLE_FAMILIES for f in families):
        raise ValueError(
            f"families must be a non-empty subset of {TABLE_FAMILIES}, "
            f"got {families}"
        )
    fmt = fmt if fmt is not None else Float16Format(signed=signed)
    if isinstance(fmt, Float16Format):
        fmt_variants = [
            dataclasses.replace(fmt, mantissa_radix=r) for r in sorted(set(radices))
        ]
    else:
        fmt_variants = [fmt]
    entries = list(
        iter_linear_layers(params, min_features, predicate, convert_experts)
    )
    shapes = {key: shape for key, shape, _ in entries}
    copies = {key: n for key, _, n in entries}
    groups: list[tuple[str, ...]] = (
        sorted(iter_sibling_groups(params, min_features, predicate, convert_experts))
        if group_siblings
        else []
    )
    in_group = {key for g in groups for key in g}
    items: list[tuple[str, ...]] = groups + [
        (key,) for key in shapes if key not in in_group
    ]
    items.sort()
    mult = {item: sum(copies[k] for k in item) for item in items}

    frontiers: dict[tuple[str, ...], list[PlanPoint]] = {}
    frontier_cache: dict[tuple[int, int], list[PlanPoint]] = {}
    for item in items:
        q, p = shapes[item[0]]
        assert all(shapes[k] == (q, p) for k in item), item
        if (q, p) not in frontier_cache:
            pts = []
            if "weight" in families:
                pts += [
                    pt
                    for fv in fmt_variants
                    for pt in enumerate_plans(
                        q,
                        p,
                        fv,
                        modes=modes,
                        max_chunk=max_chunk,
                        table_formats=table_formats,
                    )
                ]
            if "tl1" in families:
                pts.append(
                    PlanPoint.of(
                        TL1Plan(q, p, act_bits=tl1_act_bits, acc_dtype=tl1_acc_dtype)
                    )
                )
            kept, rejected = [], []
            for pt in pts:
                cert = layer_range_cert(pt.plan)
                if cert.max_abs_acc > acc_capacity(pt.plan.acc_dtype):
                    rejected.append((pt.plan, cert))
                else:
                    kept.append(
                        PlanPoint.of(
                            dataclasses.replace(pt.plan, max_abs_acc=cert.max_abs_acc)
                        )
                    )
            if not kept and rejected:
                plan, cert = rejected[0]
                raise ValueError(
                    f"no overflow-safe plan for {q}x{p}: e.g. "
                    f"{type(plan).__name__} proves |acc| <= "
                    f"{cert.max_abs_acc:.6g}, which overflows "
                    f"acc_dtype={plan.acc_dtype!r} (capacity "
                    f"{acc_capacity(plan.acc_dtype):.6g}; minimal safe "
                    f"dtype {cert.min_acc_dtype})"
                )
            frontier_cache[(q, p)] = tradeoff_curve(kept)
        frontier = frontier_cache[(q, p)]
        if not frontier:
            raise ValueError(f"no feasible LUT plan for {item[0]} ({q}x{p})")
        frontiers[item] = frontier

    choice = {item: 0 for item in items}
    spent = sum(mult[item] * frontiers[item][0].lut_bytes for item in items)
    if spent > max_lut_bytes:
        raise ValueError(
            f"budget {max_lut_bytes} bytes < minimal model footprint "
            f"{spent} bytes ({len(shapes)} layers)"
        )

    while True:
        best = None  # (ops_saved_per_byte, -bytes_added, item, frontier index)
        for item in items:
            fr = frontiers[item]
            cur = fr[choice[item]]
            for j in range(choice[item] + 1, len(fr)):
                d_bytes = mult[item] * (fr[j].lut_bytes - cur.lut_bytes)
                if spent + d_bytes > max_lut_bytes:
                    break
                d_ops = mult[item] * (cur.shift_add_ops - fr[j].shift_add_ops)
                score = (d_ops / d_bytes, -d_bytes)
                if best is None or score > best[:2]:
                    best = (*score, item, j)
        if best is None:
            break
        _, _, item, j = best
        spent += mult[item] * (
            frontiers[item][j].lut_bytes - frontiers[item][choice[item]].lut_bytes
        )
        choice[item] = j

    layers = {
        key: frontiers[item][choice[item]].plan for item in items for key in item
    }
    budget = None if math.isinf(max_lut_bytes) else int(max_lut_bytes)
    return ModelPlan(
        layers=dict(sorted(layers.items())),
        budget_bytes=budget,
        groups=tuple(groups),
        copies={k: v for k, v in sorted(copies.items()) if v != 1},
    )
