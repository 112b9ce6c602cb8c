"""Model -> TableNet conversion pass (counterpart of
``repro/core/convert.py``, both table families, dense and MoE models).

Walks a parameter tree of tensors and replaces every eligible linear node
(``{"w": (..., q, p)}``, optionally with ``"b"``) by its tables:

* :class:`LUTLinear` — one projection: ``tables (..., k, E, p)``.
* :class:`LUTGroup` — fusable sibling projections (K/V, gate/up, QKV
  with equal shapes) pre-stacked into one ``(..., G, k, E, p)`` tensor
  under an ``"a+b"`` key: the layout the grouped kernel reads in place.

Both carry their plan, so execution never infers it from table shapes.
Narrow weight-family tables (``table_format`` i8/i16) carry ``scale``: one
power-of-2 dequant scale per table set, a host fp32 tensor shaped like the
leading (layer) dims -- the kernels take it with the launch as an exponent.

Weight-family tables are built and quantized a slice of chunks at a time,
with the scale taken first from the set's global max, so no whole fp32
table set is ever held; every entry equals the whole-array build bit for
bit.

With ``convert_experts=True`` the raw MoE expert stacks ``(L, E, q, p)``
convert too: gate/up into one ``(L, E, G, k, En, p)`` :class:`LUTGroup`,
``w_down`` into an ``(L, E, k, En, p)`` :class:`LUTLinear`.  A layer's E
experts (and G members) form ONE table set with one dequant scale, as the
reference gives them, so the experts kernel applies it as one shift.

TL1-planned projections store ``(..., [G,] kb, p)`` uint8 packed base-3
indices and ``scale``, the ternary weight scale of each matrix: a float32
tensor on the tables' device shaped ``(...)`` (``(..., G)`` for a group),
applied after the integer accumulate.  They are built one leading (layer)
index at a time, so a stacked fp32 model never needs temporaries of its
own size.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Optional

import torch

from repro_torch.core.lut import (
    TABLE_DTYPES,
    LUTPlan,
    build_luts,
    quantize_with_scale,
    scale_from_maxabs,
)
from repro_torch.core.lut_tl1 import TL1Plan, build_tl1_tables
from repro_torch.core.planner import AnyPlan, ModelPlan, path_key
from repro_torch.core.quantize import Float16Format

FUSABLE_SIBLINGS = (("wq", "wk", "wv"), ("w_gate", "w_up"))

EXPERT_WEIGHT_KEYS = ("w_gate", "w_up", "w_down")

# fp32 bytes of one chunk slice built at a time
SLICE_BYTES = 256 * 2**20


def _index(x, i):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_index(v, i) for v in x)
    return x[i]


@dataclasses.dataclass(eq=False)
class LUTLinear:
    """A converted projection: kernel-ready tables + its conversion plan."""

    tables: Any  # weight: (..., k, E, p); tl1: (..., kb, p) uint8
    plan: AnyPlan
    b: Any = None  # (..., p) or None
    # weight: host fp32 (...) dequant scale for i8/i16 tables, else None;
    # tl1: the (...) ternary weight scale, on the tables' device
    scale: Any = None

    def layer(self, i: int) -> "LUTLinear":
        """View of layer ``i`` of a scan-stacked node (no copy)."""
        return LUTLinear(
            self.tables[i], self.plan, _index(self.b, i), _index(self.scale, i)
        )


@dataclasses.dataclass(eq=False)
class LUTGroup:
    """Pre-stacked fusable sibling projections sharing one plan.

    ``b`` is ``None``, a stacked ``(..., G, p)`` tensor (every member has a
    bias) or a per-member tuple with ``None`` holes.  Weight family:
    ``scale`` is ONE dequant scale per table set shared by every member;
    TL1: one ternary scale per member, ``(..., G)``."""

    tables: Any  # weight: (..., G, k, E, p); tl1: (..., G, kb, p) uint8
    plan: AnyPlan
    members: tuple
    b: Any = None
    scale: Any = None

    def layer(self, i: int) -> "LUTGroup":
        return LUTGroup(
            self.tables[i], self.plan, self.members, _index(self.b, i),
            _index(self.scale, i),
        )

    def member_bias(self, g: int):
        if self.b is None:
            return None
        if isinstance(self.b, tuple):
            return self.b[g]
        return self.b[..., g, :]


@dataclasses.dataclass(frozen=True)
class ConvertReport:
    converted: int
    skipped: int
    weight_bytes: int
    table_bytes: int
    grouped: int = 0


def _is_linear_node(node: Any) -> bool:
    return (
        isinstance(node, dict)
        and "w" in node
        and hasattr(node["w"], "ndim")
        and node["w"].ndim in (2, 3)
        and set(node) <= {"w", "b"}
    )


def _is_expert_stack(node: Any) -> bool:
    return (
        isinstance(node, dict)
        and {"w_gate", "w_up", "w_down", "router"} <= set(node)
        and hasattr(node["w_gate"], "ndim")
        and node["w_gate"].ndim in (3, 4)
    )


def sibling_groups(node: dict) -> list[tuple[str, ...]]:
    """Fusable sibling sets present in ``node``: same-``w``-shape classes
    with >= 2 members of each candidate key set (shared with the planner)."""
    out: list[tuple[str, ...]] = []
    for base in FUSABLE_SIBLINGS:
        present = [n for n in base if n in node and _is_linear_node(node[n])]
        by_shape: dict[tuple, list[str]] = {}
        for n in present:
            by_shape.setdefault(tuple(node[n]["w"].shape), []).append(n)
        for members in by_shape.values():
            if len(members) > 1:
                out.append(tuple(members))
    return out


def expert_sibling_groups(node: dict) -> list[tuple[str, ...]]:
    """Fusable sibling sets among the raw expert-stack weights of ``node``
    (an expert stack: bare ``(..., E, q, p)`` tensors, not linear nodes),
    same-shape classes as :func:`sibling_groups` (shared with the planner)."""
    out: list[tuple[str, ...]] = []
    for base in FUSABLE_SIBLINGS:
        present = [
            n for n in base if n in EXPERT_WEIGHT_KEYS and hasattr(node.get(n), "ndim")
        ]
        by_shape: dict[tuple, list[str]] = {}
        for n in present:
            by_shape.setdefault(tuple(node[n].shape), []).append(n)
        for members in by_shape.values():
            if len(members) > 1:
                out.append(tuple(members))
    return out


def group_key(members: tuple) -> str:
    return "+".join(members)


def _chunk_slices(plan: LUTPlan, slice_bytes: int):
    step = max(1, slice_bytes // (plan.num_entries * plan.out_features * 4))
    k = plan.num_chunks
    return [(c0, min(k, c0 + step)) for c0 in range(0, k, step)]


def build_table_sets(
    ws: list[torch.Tensor],
    plan: LUTPlan,
    table_dtype=torch.float32,
    grouped: bool = False,
    slice_bytes: int = SLICE_BYTES,
    set_dims: int = 0,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Tables for the member weights ``ws`` (each ``(*lead, *inner, q,
    p)``, with ``set_dims`` inner dims): ``(*lead, *inner, [G,] k, E, p)``
    plus, when the plan stores narrow tables, the scale of each table set
    (``lead``-shaped, on the host) -- one set per leading index, covering
    every inner index and member: an expert stack ``(L, E, q, p)`` with
    ``set_dims=1`` has one scale per layer across its E experts, as the
    reference's ``quantize_tables(trailing=)`` gives it."""
    dims = tuple(ws[0].shape[:-2])
    lead, inner = dims[: len(dims) - set_dims], dims[len(dims) - set_dims :]
    k, E, p = plan.num_chunks, plan.num_entries, plan.out_features
    narrow = plan.table_format
    shape = dims + ((len(ws),) if grouped else ()) + (k, E, p)
    dtype = TABLE_DTYPES[narrow] if narrow else table_dtype
    out = torch.empty(shape, dtype=dtype, device=ws[0].device)
    scales = torch.empty(lead, dtype=torch.float32) if narrow else None
    slices = _chunk_slices(plan, slice_bytes)
    inner_idx = list(itertools.product(*(range(d) for d in inner)))
    for li in itertools.product(*(range(d) for d in lead)):
        s = None
        if narrow:
            # the set's scale comes first, from its global max over every
            # inner index, member and chunk slice
            maxabs = torch.zeros((), dtype=torch.float32, device=out.device)
            for ii in inner_idx:
                for w in ws:
                    for sl in slices:
                        t = build_luts(w[li + ii], plan, sl)
                        maxabs = torch.maximum(maxabs, t.abs().amax())
            s = scale_from_maxabs(maxabs.cpu(), narrow)
            scales[li] = s
        for ii in inner_idx:
            dst = out[li + ii]
            for g, w in enumerate(ws):
                dg = dst[g] if grouped else dst
                for c0, c1 in slices:
                    t = build_luts(w[li + ii], plan, (c0, c1))
                    dg[c0:c1] = (
                        quantize_with_scale(t, s, narrow) if narrow else t.to(dtype)
                    )
    return out, scales


def build_tl1_sets(
    ws: list[torch.Tensor], plan: TL1Plan, grouped: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed TL1 tables for the member weights ``ws`` (each ``(*lead, q,
    p)``): ``(*lead, [G,] kb, p)`` uint8 and the ternary scales ``(*lead,
    [G])`` float32, one leading index and member at a time."""
    lead = tuple(ws[0].shape[:-2])
    G = (len(ws),) if grouped else ()
    dev = ws[0].device
    shape = lead + G + (plan.packed_chunks, plan.out_features)
    tables = torch.empty(shape, dtype=torch.uint8, device=dev)
    scales = torch.empty(lead + G, dtype=torch.float32, device=dev)
    for li in itertools.product(*(range(d) for d in lead)):
        for g, w in enumerate(ws):
            at = li + ((g,) if grouped else ())
            tables[at], scales[at] = build_tl1_tables(w[li])
    return tables, scales


def convert_params(
    params: dict,
    chunk_size: int = 1,
    min_features: int = 1,
    predicate: Callable[[tuple, dict], bool] | None = None,
    table_dtype=torch.float32,
    convert_experts: bool = False,
    signed: bool = True,
    plan: Optional[ModelPlan] = None,
    group_siblings: bool = True,
    slice_bytes: int = SLICE_BYTES,
) -> tuple[dict, ConvertReport]:
    """Returns (converted tree, report), with the reference's semantics:
    under ``plan`` each layer takes its own plan by tree path, layers
    absent from it stay dense, and a plan entry the converter never
    consumes raises; ``group_siblings`` emits exactly the plan's groups (or,
    without a plan, every fusable group) as pre-stacked :class:`LUTGroup`s.
    """
    stats = {"converted": 0, "skipped": 0, "w_bytes": 0, "t_bytes": 0, "groups": 0}
    fmt = Float16Format(signed=signed)
    used_plan_keys: set[str] = set()
    declared_groups = (
        {frozenset(g) for g in plan.groups} if plan is not None else None
    )

    def member_plan(path: tuple, node: dict) -> Optional[AnyPlan]:
        w = node["w"]
        q, p = w.shape[-2:]
        if q < min_features or (predicate and not predicate(path, node)):
            return None
        if plan is None:
            return LUTPlan(q, p, chunk_size, fmt, mode="bitplane")
        layer_plan = plan.layers.get(path_key(path))
        if layer_plan is None:
            return None
        if (layer_plan.in_features, layer_plan.out_features) != (q, p):
            raise ValueError(
                f"plan for {path_key(path)} is "
                f"{layer_plan.in_features}x{layer_plan.out_features}, "
                f"layer is {q}x{p}"
            )
        used_plan_keys.add(path_key(path))
        return layer_plan

    def account(ws, tables):
        for w in ws:
            stats["w_bytes"] += w.numel() * w.element_size()
        stats["t_bytes"] += tables.numel() * tables.element_size()

    def build(ws, layer_plan: AnyPlan, grouped: bool, expert: bool):
        if isinstance(layer_plan, TL1Plan):
            # one ternary scale per matrix: per layer, expert and member
            return build_tl1_sets(ws, layer_plan, grouped=grouped)
        # an expert stack's E experts belong to one table set of the layer
        return build_table_sets(
            ws, layer_plan, table_dtype, grouped=grouped, slice_bytes=slice_bytes,
            set_dims=int(expert),
        )

    def convert_one(node: dict, layer_plan: AnyPlan, expert: bool = False) -> LUTLinear:
        tables, scale = build([node["w"]], layer_plan, grouped=False, expert=expert)
        stats["converted"] += 1
        account([node["w"]], tables)
        return LUTLinear(tables=tables, plan=layer_plan, b=node.get("b"), scale=scale)

    def convert_group(
        path: tuple, node: dict, members: tuple, expert: bool = False
    ) -> Optional[LUTGroup]:
        key_tuple = frozenset(path_key(path + (m,)) for m in members)
        declared = declared_groups is not None and key_tuple in declared_groups
        if declared_groups is not None and not declared:
            return None
        plans = [member_plan(path + (m,), node[m]) for m in members]
        if any(p is None for p in plans):
            if declared:
                raise ValueError(
                    f"plan declares group {group_key(members)} at "
                    f"{path_key(path)} but not every member is convertible"
                )
            return None
        if any(p != plans[0] for p in plans[1:]):
            raise ValueError(
                f"group {group_key(members)} at {path_key(path)} has "
                f"mismatched member plans — grouped siblings must share one"
            )
        ws = [node[m]["w"] for m in members]
        tables, scale = build(ws, plans[0], grouped=True, expert=expert)
        stats["converted"] += len(members)
        account(ws, tables)
        biases = [node[m].get("b") for m in members]
        if all(b is not None for b in biases):
            b = torch.stack(biases, dim=biases[0].ndim - 1)
        elif any(b is not None for b in biases):
            b = tuple(biases)
        else:
            b = None
        stats["groups"] += 1
        return LUTGroup(tables=tables, plan=plans[0], members=members, b=b, scale=scale)

    def convert_expert_member(path: tuple, key: str, w) -> Any:
        layer_plan = member_plan(path + (key,), {"w": w})
        if layer_plan is None:
            stats["skipped"] += 1
            return w
        return convert_one({"w": w}, layer_plan, expert=True)

    def walk(path: tuple, node: Any):
        if _is_linear_node(node):
            layer_plan = member_plan(path, node)
            if layer_plan is None:
                stats["skipped"] += 1
                return node
            return convert_one(node, layer_plan)
        if not isinstance(node, dict):
            return node
        # an expert stack's raw (L, E, q, p) weights are wrapped as linear
        # nodes, so the group rules apply unchanged; a group's leaf is then
        # (L, E, G, k, En, p), the layout the experts kernel reads
        expert = convert_experts and _is_expert_stack(node)
        if expert:
            members_of = expert_sibling_groups(node)
            source = {k: {"w": v} for k, v in node.items() if k in EXPERT_WEIGHT_KEYS}
        else:
            members_of, source = sibling_groups(node), node
        grouped: dict[str, LUTGroup] = {}
        consumed: set[str] = set()
        if group_siblings:
            for members in members_of:
                g = convert_group(path, source, members, expert=expert)
                if g is not None:
                    grouped[group_key(members)] = g
                    consumed |= set(members)
        out: dict[str, Any] = {}
        for k, v in node.items():
            if k in consumed:
                gk = next(gk for gk, g in grouped.items() if k in g.members)
                if gk not in out:
                    out[gk] = grouped[gk]
            elif expert and k in EXPERT_WEIGHT_KEYS:
                out[k] = convert_expert_member(path, k, v)
            else:
                out[k] = walk(path + (k,), v)
        return out

    out = walk((), params)
    if plan is not None:
        unused = sorted(set(plan.layers) - used_plan_keys)
        if unused:
            raise ValueError(
                "plan entries the converter never consumed (planner/converter "
                f"eligibility mismatch — check predicate/min_features): {unused}"
            )
    report = ConvertReport(
        stats["converted"],
        stats["skipped"],
        stats["w_bytes"],
        stats["t_bytes"],
        stats["groups"],
    )
    return out, report


def conversion_summary(report: ConvertReport) -> str:
    ratio = report.table_bytes / max(report.weight_bytes, 1)
    return (
        f"converted {report.converted} linears ({report.skipped} skipped, "
        f"{report.grouped} pre-stacked groups): "
        f"{report.weight_bytes / 2**20:.1f} MiB weights -> "
        f"{report.table_bytes / 2**20:.1f} MiB tables ({ratio:.0f}x)"
    )
