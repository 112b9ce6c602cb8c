"""Closed-form range certificates for both table families (counterpart of
``repro/audit/ranges.py::layer_range_cert``).

Every gathered entry is ``sum_i coeff_i * W_i`` with the per-element
dequantised coefficient bounded by ``elem_max``: fp16 ``full`` mode 65504,
fp16 bitplane modes ``32 * (2**(r*n) - 1)``, fixed point
``max(|min_value|, max_value)`` (full) or ``(2**n - 1) * 2**-f``
(bitplane).  Hence ``max_abs_acc = padded_in * elem_max * w_max``; i8/i16
storage inflates it by ``(1 + 1/qmax)``.

TL1's int path counts CODE units: with ``qa = 2**(act_bits-1) - 1`` every
entry is ``|+-a0 +- a1| <= 2*qa`` and ``max_abs_acc = 2*qa*num_chunks``;
its exact path is fp32.  The planner stamps each chosen plan with its
bound and the kernels check it before every dispatch.

The audit reads the same certificates: :func:`precision_report` per planned
layer for the manifest, :func:`overflow_violations` for the ``overflow``
rule class (three plan-level checks, then the interval pass of
:mod:`audit.interp` over recorded steps), and :func:`kernel_interval_model`
bounds an opaque kernel's outputs in that pass.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.audit.interp import Interval, dtype_interval, interval_eval
from repro_torch.audit.rules import Violation
from repro_torch.core.lut import TABLE_QMAX, LUTPlan
from repro_torch.core.lut_tl1 import TL1Plan
from repro_torch.core.quantize import Float16Format
from repro_torch.kernels.common import ACC_CAPACITY, acc_capacity

_F16_MAX = 65504.0
_F16_SIGMA_MAX = 32.0  # 2**(30 - 25): max exponent field 30 for finite f16
_INT16_MAX = 32767.0
_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)


@dataclasses.dataclass(frozen=True)
class RangeCert:
    """The proved range/precision facts for one planned layer."""

    family: str
    integer: bool  # True when max_abs_acc counts integer CODE units
    max_abs_acc: float
    min_acc_dtype: str
    entry_max: float
    table_quant_err: float
    act_quant_err: float

    @property
    def total_err(self) -> float:
        return self.table_quant_err + self.act_quant_err

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("max_abs_acc", "entry_max", "table_quant_err", "act_quant_err"):
            d[k] = float(f"{d[k]:.8g}")  # stable across platforms in the manifest
        d["total_err"] = float(f"{self.total_err:.8g}")
        return d


def _min_acc_dtype(bound: float, integer: bool) -> str:
    if integer:
        for name in ("int16", "int32", "int64"):
            if bound <= ACC_CAPACITY[name]:
                return name
    return "float32"


def _weight_elem_max(plan: LUTPlan) -> float:
    """Max |dequantised value| one input element contributes through the
    tables, plane scales included."""
    fmt = plan.fmt
    if isinstance(fmt, Float16Format):
        if plan.mode == "full":
            return _F16_MAX
        r = fmt.mantissa_radix
        return _F16_SIGMA_MAX * float(2 ** (r * fmt.num_planes) - 1)
    if plan.mode == "full":
        return max(abs(fmt.min_value), abs(fmt.max_value))
    return float(2**fmt.total_bits - 1) * fmt.scale


def _tl1_cert(plan: TL1Plan, w_max: float, act_max: float) -> RangeCert:
    if plan.act_bits is not None:
        qa = float(2 ** (int(plan.act_bits) - 1) - 1)
        entry_max = 2.0 * qa  # |+-a0 +- a1| in code units
        max_abs_acc = entry_max * plan.num_chunks
        # absmax rounding <= scale/2 = act_max/(2*qa) per element, through
        # a |weight| <= w_max, summed over the input width
        return RangeCert(
            family="tl1",
            integer=True,
            max_abs_acc=max_abs_acc,
            min_acc_dtype=_min_acc_dtype(max_abs_acc, integer=True),
            entry_max=entry_max,
            table_quant_err=0.0,  # ternary indices are stored exactly
            act_quant_err=plan.in_features * w_max * act_max / (2.0 * qa),
        )
    entry_max = 2.0 * act_max
    return RangeCert(
        family="tl1",
        integer=False,
        max_abs_acc=entry_max * plan.num_chunks,
        min_acc_dtype="float32",
        entry_max=entry_max,
        table_quant_err=0.0,
        act_quant_err=0.0,  # the exact path quantizes nothing
    )


def layer_range_cert(
    plan: LUTPlan | TL1Plan, *, w_max: float = 1.0, act_max: float = 1.0
) -> RangeCert:
    """Closed-form :class:`RangeCert` for one plan (either family)."""
    if isinstance(plan, TL1Plan):
        return _tl1_cert(plan, w_max, act_max)
    elem_max = _weight_elem_max(plan)
    exact_acc = plan.padded_in * elem_max * w_max
    if plan.table_format is not None:
        qmax = TABLE_QMAX[plan.table_format]
        max_abs_acc = exact_acc * (1.0 + 1.0 / qmax)
        table_err = exact_acc / qmax
    else:
        max_abs_acc = exact_acc
        table_err = 0.0
    if isinstance(plan.fmt, Float16Format):
        act_err = plan.padded_in * w_max * act_max * 2.0**-11
    else:
        act_err = plan.padded_in * w_max * plan.fmt.scale / 2.0
    return RangeCert(
        family="weight",
        integer=False,
        max_abs_acc=max_abs_acc,
        min_acc_dtype=_min_acc_dtype(max_abs_acc, integer=False),
        entry_max=elem_max * plan.chunk_size * w_max,
        table_quant_err=table_err,
        act_quant_err=act_err,
    )


def precision_report(mplan) -> dict:
    """Per-layer certificate summary for the audit manifest (JSON-stable),
    in normalised units (``w_max = act_max = 1``)."""
    out = {}
    for key in sorted(mplan.layers):
        plan = mplan.layers[key]
        cert = layer_range_cert(plan)
        out[key] = {"acc_dtype": plan.acc_dtype, **cert.to_json()}
    return out


def kernel_interval_model(mplan):
    """Closed-form interval model for opaque kernel leaves (the counterpart
    of the reference's ``pallas_interval_model``).

    The interval pass cannot see inside a kernel, but the kernels implement
    exactly the per-family contracts certified here, so their *outputs* are
    bounded by the certificates: integer results (TL1's int accumulators,
    before the fp32 rescale) stay within the largest certified
    ``max_abs_acc`` of any integer-path plan; everything else takes its
    dtype range.
    """
    int_bound = 0.0
    for plan in mplan.layers.values():
        cert = layer_range_cert(plan)
        if cert.integer:
            int_bound = max(int_bound, cert.max_abs_acc, cert.entry_max)

    def model(op, ins):
        outs = []
        for m in op.outputs:
            rng = dtype_interval(m.dtype)
            if m.dtype in _SIGNED and int_bound > 0:
                outs.append(Interval(max(rng.lo, -int_bound), min(rng.hi, int_bound)))
            else:
                outs.append(rng)
        return outs

    return model


def overflow_violations(mplan, *, graphs=(), kernel_model=None) -> list[Violation]:
    """The numerical-safety rule class: a clean pipeline returns ``[]``.

    Three plan-level checks per layer -- the proved ``max_abs_acc`` fits the
    plan's declared ``acc_dtype``, TL1 int entries fit their int16 storage,
    and any bound stamped on the plan matches what the certificate proves
    now (a stale stamp means a plan rode a checkpoint across a semantics
    change) -- plus one graph-level check: the interval pass over each named
    recording in ``graphs`` (``(name, ops)`` pairs, e.g. the decode and
    prefill steps) flags every signed-integer op whose ideal result escapes
    its machine dtype.  ``kernel_model`` defaults to
    :func:`kernel_interval_model` over the same plan.
    """
    out = []
    for key in sorted(mplan.layers):
        plan = mplan.layers[key]
        cert = layer_range_cert(plan)
        cap = acc_capacity(plan.acc_dtype)
        if cert.max_abs_acc > cap:
            out.append(
                Violation(
                    rule="overflow",
                    primitive="accumulate",
                    detail=(
                        f"{key}: proved |acc| bound {cert.max_abs_acc:.6g} "
                        f"exceeds acc_dtype={plan.acc_dtype!r} capacity "
                        f"{cap:.6g} (minimal safe dtype: "
                        f"{cert.min_acc_dtype})"
                    ),
                )
            )
        if cert.integer and cert.entry_max > _INT16_MAX:
            out.append(
                Violation(
                    rule="overflow",
                    primitive="table_entry",
                    detail=(
                        f"{key}: TL1 activation-LUT entry bound "
                        f"{cert.entry_max:.6g} exceeds the int16 entry "
                        f"dtype ({_INT16_MAX:.0f})"
                    ),
                )
            )
        stamped = getattr(plan, "max_abs_acc", None)
        if stamped is not None and not math.isclose(
            stamped, cert.max_abs_acc, rel_tol=1e-6
        ):
            out.append(
                Violation(
                    rule="overflow",
                    primitive="stale_bound",
                    detail=(
                        f"{key}: stamped max_abs_acc {stamped:.6g} != "
                        f"certified {cert.max_abs_acc:.6g} — restamp via "
                        f"plan_model"
                    ),
                )
            )
    model = kernel_model if kernel_model is not None else kernel_interval_model(mplan)
    for name, ops in graphs:
        _, facts = interval_eval(ops, kernel_model=model)
        for f in facts:
            out.append(Violation(rule="overflow", primitive=f.primitive,
                                 detail=f"{name}: {f.detail}"))
    return out
