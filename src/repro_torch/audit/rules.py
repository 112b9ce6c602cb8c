"""Structural invariant rules over recorded steps and converted trees
(counterpart of ``repro/audit/rules.py``, restated for aten ops).

Each rule returns a list of :class:`Violation` (empty == the invariant
holds), so the same predicates serve the tests, ``python -m
repro_torch.audit`` and ``chip_smoke.py``'s audit phase.

Rule classes
------------
* :func:`multiplier_free_violations` -- the paper's contract: no grouped
  expert product (``_grouped_mm``, the counterpart of ``ragged_dot``)
  anywhere, and no contraction or ``mul`` whose operand is a planned weight
  (shape-suffix match against the plan's ``(q, p)`` projections) or a
  stored table leaf.  The contractions are those dispatch sees once
  ``matmul``, ``einsum`` and ``linear`` have decomposed (:data:`CONTRACTIONS`);
  ``_embedding_bag`` with ``per_sample_weights`` multiplies the rows it
  gathers, so it counts as a ``mul`` over its table.  Scalar and
  activation-sized multiplies match neither shape and pass.
* :func:`zero_copy_violations` -- a decode step never materialises a
  table-shaped value: no ``cat``, ``stack``, ``clone``, ``_to_copy`` or
  ``copy_`` whose *output* ends in a stored table leaf's shape.  A view
  (``t``, ``transpose``, ``permute``) copies nothing and passes; a
  ``.contiguous()`` after it is a ``clone`` and is flagged.
* :func:`plan_consistency_violations` -- the ``ModelPlan`` and the
  converted tree tell the same story: every plan entry is consumed by
  exactly the leaves it planned, per-layer plans match, and the table
  bytes materialised equal ``total_lut_bytes``, and every tuned tiling a
  plan carries is legal on the Hopper kernels (``blocks_over_smem``, the
  reference's ``blocks_over_vmem``: compiled row and column tiles, shared
  memory within ``kMaxSmem``, ``1 <= block_k <= k``;
  ``kernels.lut_affine.autotune.blocks_fit_smem``), which the wrappers
  would otherwise refuse at the first dispatch.

Shape-suffix matching makes the rules robust to stacking: a layer-stacked
``(L, q, p)`` dense fallback, an expert-stacked ``(L, E, q, p)`` one, and
a bare ``(q, p)`` weight all end in the planned ``(q, p)``, while the LUT
path's own small products (plane-scale sums, rope rotations, attention
scores) match nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch.audit.walker import Ref, as_ops

# aten contractions after dispatch has decomposed matmul / einsum / linear
CONTRACTIONS = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
    "convolution", "_int_mm", "_scaled_mm",
})
# products over expert weight stacks: always a violation
GROUPED_CONTRACTIONS = frozenset({"_grouped_mm", "_scaled_grouped_mm"})
ZERO_COPY_OPS = ("cat", "stack", "clone", "_to_copy", "copy_")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule breach, serialisable into the audit manifest."""

    rule: str
    primitive: str
    detail: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d) -> "Violation":
        return cls(str(d["rule"]), str(d["primitive"]), str(d["detail"]))


def _has_suffix(shape: Sequence[int], suffix: Sequence[int]) -> bool:
    return len(shape) >= len(suffix) and tuple(shape[-len(suffix):]) == tuple(suffix)


def _matches_any(shape: Sequence[int], suffixes: Iterable[Sequence[int]]) -> bool:
    return any(_has_suffix(shape, s) for s in suffixes)


def planned_weight_shapes(mplan) -> frozenset[tuple[int, int]]:
    """Forbidden ``(q, p)`` suffixes for a plan: every planned projection's
    weight shape and its transpose (a dense fallback may present either)."""
    out = set()
    for plan in mplan.layers.values():
        out.add((plan.in_features, plan.out_features))
        out.add((plan.out_features, plan.in_features))
    return frozenset(out)


def table_leaf_shapes(tree) -> frozenset[tuple[int, ...]]:
    """Forbidden table suffixes: the trailing table-set dims of every stored
    ``LUTLinear`` / ``LUTGroup`` leaf (one set per layer or expert copy),
    with the group axis included for grouped leaves -- exactly the shape a
    per-step re-stack or table copy would produce."""
    from repro_torch.core.convert import LUTGroup, LUTLinear

    out: set[tuple[int, ...]] = set()

    def walk(node):
        if isinstance(node, (LUTLinear, LUTGroup)):
            ndim = 2 if node.plan.table_family == "tl1" else 3
            if isinstance(node, LUTGroup):
                ndim += 1
            out.add(tuple(node.tables.shape[-ndim:]))
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)

    walk(tree)
    return frozenset(out)


def _embedding_bag_table(op) -> tuple[int, ...] | None:
    """The table shape of an ``_embedding_bag`` that weighs its rows
    (``per_sample_weights``, its 7th argument), else None."""
    psw = op.kwargs.get("per_sample_weights")
    if psw is None and len(op.args) > 6:
        psw = op.args[6]
    if not isinstance(psw, Ref):
        return None
    return op.inputs[op.args[0].i].shape


def multiplier_free_violations(
    ops,
    *,
    weight_shapes: Iterable[Sequence[int]] = (),
    table_shapes: Iterable[Sequence[int]] = (),
    exempt_dims: Iterable[int] = (),
) -> list[Violation]:
    """The paper's contract: the recording holds no multiplier over
    weight- or table-shaped operands.

    A grouped expert product is always a violation.  A contraction is
    flagged when an operand shape ends in a ``weight_shapes`` suffix.
    ``mul`` (and a weighted ``_embedding_bag``) is flagged on
    weight- or table-shaped operands only.  Ops with an operand carrying a
    dim in ``exempt_dims`` (the vocabulary) are skipped.  Kernel launches
    are opaque leaves and never flagged.
    """
    weight_shapes = tuple(tuple(s) for s in weight_shapes)
    table_shapes = tuple(tuple(s) for s in table_shapes)
    exempt = frozenset(exempt_dims)
    out = []
    for op in as_ops(ops):
        if op.opaque:
            continue
        name = op.base
        if name in GROUPED_CONTRACTIONS:
            out.append(Violation("multiplier_free", name, "grouped expert contraction"))
            continue
        bag = _embedding_bag_table(op) if name == "_embedding_bag" else None
        if name not in CONTRACTIONS and name != "mul" and bag is None:
            continue
        shapes = [m.shape for m in op.inputs]
        if exempt and any(d in exempt for s in shapes for d in s):
            continue
        if name in CONTRACTIONS:
            hit = any(_matches_any(s, weight_shapes) for s in shapes)
        else:  # mul, weighted bag: only weight/table-shaped operands
            forbidden = weight_shapes + table_shapes
            hit = any(_matches_any(s, forbidden) for s in shapes)
        if hit:
            out.append(Violation("multiplier_free", name, f"operands {shapes}"))
    return out


def zero_copy_violations(ops, *, table_shapes: Iterable[Sequence[int]] = ()) -> list[Violation]:
    """The layout contract: the recorded step never materialises a
    table-shaped value through :data:`ZERO_COPY_OPS` -- the stored
    pre-stacked leaves are read as they are.  Flags ops whose *output* ends
    in a ``table_shapes`` suffix."""
    table_shapes = tuple(tuple(s) for s in table_shapes)
    out = []
    for op in as_ops(ops):
        if op.opaque or op.name not in ZERO_COPY_OPS:
            continue
        shapes = [m.shape for m in op.outputs]
        if any(_matches_any(s, table_shapes) for s in shapes):
            out.append(Violation("zero_copy", op.name, f"outputs {shapes}"))
    return out


def plan_consistency_violations(mplan, tree, *, batch: int = 1) -> list[Violation]:
    """The plan and the converted tree agree.

    Checks, per the ``ModelPlan`` contract:
    * every plan entry is consumed by a converted leaf, and every leaf's
      layer appears in the plan (no silent dense leftovers);
    * each leaf carries the exact per-layer plan (family included);
    * the bytes materialised across table leaves equal
      ``mplan.total_lut_bytes``;
    * any tuned ``blocks`` riding a plan are a legal Hopper tiling of its
      point at ``batch`` rows (``autotune.blocks_fit_smem``).
    """
    from repro_torch.core.convert import LUTGroup, LUTLinear
    from repro_torch.core.planner import path_key
    from repro_torch.kernels.lut_affine.autotune import (
        TunePoint,
        _group_sizes,
        blocks_fit_smem,
    )

    out = []
    consumed: dict[str, object] = {}
    table_bytes = 0

    def walk(node, path):
        nonlocal table_bytes
        if isinstance(node, LUTLinear):
            consumed[path_key(path)] = node
            table_bytes += node.tables.numel() * node.tables.element_size()
        elif isinstance(node, LUTGroup):
            for name in node.members:
                consumed[path_key(path[:-1] + (name,))] = node
            table_bytes += node.tables.numel() * node.tables.element_size()
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))

    walk(tree, ())

    for key in sorted(set(mplan.layers) - set(consumed)):
        out.append(
            Violation("plan_consistency", "never_consumed", f"plan entry {key!r}")
        )
    for key in sorted(set(consumed) - set(mplan.layers)):
        out.append(
            Violation("plan_consistency", "unplanned_leaf", f"converted leaf {key!r}")
        )
    group_sizes = _group_sizes(mplan)
    for key, node in sorted(consumed.items()):
        plan = mplan.layers.get(key)
        if plan is None:
            continue
        if node.plan != plan:
            out.append(
                Violation(
                    "plan_consistency",
                    "plan_mismatch",
                    f"{key!r}: leaf plan {node.plan} != planned {plan}",
                )
            )
        if plan.blocks is not None:
            pt = TunePoint.from_plan(plan, batch, G=group_sizes.get(key, 1))
            if not blocks_fit_smem(pt, plan.blocks):
                out.append(
                    Violation(
                        "plan_consistency",
                        "blocks_over_smem",
                        f"{key!r}: blocks {plan.blocks} are no legal Hopper "
                        f"tiling at point {pt}",
                    )
                )
    if table_bytes != mplan.total_lut_bytes:
        out.append(
            Violation(
                "plan_consistency",
                "byte_mismatch",
                f"materialised {table_bytes} table bytes != plan "
                f"total_lut_bytes {mplan.total_lut_bytes}",
            )
        )
    return out
