"""Interval abstract interpretation over recorded steps (the range /
overflow pass; counterpart of ``repro/audit/interp.py``).

The structural rules in :mod:`audit.rules` prove what a step *is*; this
module proves what its values can *be*.  It walks the ops of a recording
(:func:`audit.walker.record`) with one conservative interval ``[lo, hi]``
per buffer as each dtype reads it (a sound join over its elements),
applies a transfer function per aten op, and flags every *signed-integer*
arithmetic op whose ideal-arithmetic result escapes its machine dtype: a
potential accumulator or index-packing overflow.

The reference's soundness conventions, kept:

* Unknown ops and opaque kernel leaves take the full range of their
  outputs' dtypes (``kernel_model`` -- :func:`audit.ranges.kernel_interval_model`
  -- bounds a kernel's outputs by the per-family certificates instead).
* Unsigned arithmetic is never flagged: wrapping is defined behaviour.
  Overflowing unsigned results widen to the dtype range.
* Dtype casts (``_to_copy``, ``copy_`` into another dtype) narrow: the
  result is clamped to the target dtype, never flagged.
* Integer step *inputs* (tensors no recorded op wrote: token ids, cache
  positions, tables) are bounded by ``+-INT_INPUT_BOUND`` (``2**24``)
  rather than their dtype range, a documented precondition ("integer step
  inputs fit in 24 bits").

A recording has no loops to run to a fixpoint (the run unrolled them).
Two things are the port's own: intervals live per buffer and per dtype,
so a write through a view reaches every alias (joined with what the
buffer held: a write may cover part of it), and a bit reinterpretation
(``view(dtype)``) reads the full range of its new dtype; and a host
constant lifted by ``torch.tensor`` takes its recorded values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.audit.walker import LIFTS, Op, Ref, as_ops

# Precondition on integer step inputs (see module docstring).
INT_INPUT_BOUND = 2**24

_INF = math.inf


@dataclasses.dataclass(frozen=True)
class Interval:
    """Conservative ``[lo, hi]`` bound on every element of a buffer."""

    lo: float
    hi: float

    def __post_init__(self):
        if not (self.lo <= self.hi):
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @staticmethod
    def point(v: float) -> "Interval":
        return Interval(float(v), float(v))

    def join(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def within(self, other: "Interval") -> bool:
        return other.lo <= self.lo and self.hi <= other.hi

    @property
    def mag(self) -> float:
        """max |value| the interval admits."""
        return max(abs(self.lo), abs(self.hi))


TOP = Interval(-_INF, _INF)
ZERO_ONE = Interval(0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class OverflowFact:
    """One signed-integer op whose ideal result escapes its dtype."""

    primitive: str
    dtype: str
    ideal: tuple[float, float]
    detail: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _signed(d: torch.dtype) -> bool:
    return d in (torch.int8, torch.int16, torch.int32, torch.int64)


def _unsigned(d: torch.dtype) -> bool:
    return d == torch.bool or (not d.is_floating_point and not d.is_complex and not _signed(d))


def dtype_interval(dtype: torch.dtype) -> Interval:
    """The machine range of a dtype (bool ``[0, 1]``, floats +-max finite)."""
    if dtype == torch.bool:
        return ZERO_ONE
    if dtype.is_floating_point:
        fi = torch.finfo(dtype)
        return Interval(-float(fi.max), float(fi.max))
    if dtype.is_complex:
        return TOP
    ii = torch.iinfo(dtype)
    return Interval(float(ii.min), float(ii.max))


def input_interval(dtype: torch.dtype) -> Interval:
    """The documented input policy: signed ints +-``INT_INPUT_BOUND``
    (clipped to the dtype range, so int8 stays int8), unsigned / bool /
    narrow floats their dtype range, wide floats TOP."""
    rng = dtype_interval(dtype)
    if _signed(dtype):
        bound = float(INT_INPUT_BOUND)
        return Interval(max(rng.lo, -bound), min(rng.hi, bound))
    if dtype.is_floating_point and dtype.itemsize >= 4:
        return TOP
    return rng


# ---------------------------------------------------------------------------
# interval arithmetic helpers
# ---------------------------------------------------------------------------


def _mul_bound(a: float, b: float) -> float:
    # inf * 0 is nan under IEEE; in interval arithmetic it is exactly 0
    if a == 0.0 or b == 0.0:
        return 0.0
    return a * b


def _i_add(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo + b.lo, a.hi + b.hi)


def _i_sub(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo - b.hi, a.hi - b.lo)


def _i_mul(a: Interval, b: Interval) -> Interval:
    cands = [_mul_bound(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return Interval(min(cands), max(cands))


def _i_neg(a: Interval) -> Interval:
    return Interval(-a.hi, -a.lo)


def _i_abs(a: Interval) -> Interval:
    if a.lo >= 0:
        return a
    if a.hi <= 0:
        return _i_neg(a)
    return Interval(0.0, a.mag)


def _i_scale(a: Interval, c: float) -> Interval:
    return _i_mul(a, Interval.point(c))


def _join_all(ivals) -> Interval:
    out = None
    for iv in ivals:
        if iv is not None:
            out = iv if out is None else out.join(iv)
    return TOP if out is None else out


def _clamp_to(iv: Interval, rng: Interval) -> Interval:
    lo = min(max(iv.lo, rng.lo), rng.hi)
    hi = max(min(iv.hi, rng.hi), rng.lo)
    return Interval(lo, hi)


def _shift(a: Interval, s: Interval, left: bool) -> Interval:
    if not (0 <= s.lo and s.hi <= 64) or a.mag == _INF:
        return TOP
    op = (lambda x, k: x << k) if left else (lambda x, k: x >> k)
    cands = [op(int(x), int(k)) for x in (a.lo, a.hi) for k in (s.lo, s.hi)]
    return Interval(float(min(cands)), float(max(cands)))


def _bits_max(hi: float) -> float:
    """Largest value a nonnegative or / xor of values <= hi can take."""
    return float(2 ** int(hi).bit_length() - 1)


# ---------------------------------------------------------------------------
# transfer functions: (op, a) -> list of IDEAL out intervals, where
# a(x) reads an argument (a tensor input's interval, or a scalar's point)
# ---------------------------------------------------------------------------


def _arg(op: Op, k: int, name: str | None = None, default=None):
    if name is not None and name in op.kwargs:
        return op.kwargs[name]
    return op.args[k] if k < len(op.args) else default


def _reduced_count(op: Op) -> int:
    n_in = math.prod(op.inputs[0].shape) or 1
    n_out = math.prod(op.outputs[0].shape) or 1
    return max(1, n_in // n_out)


def _dim_size(op: Op, dim) -> int:
    """Elements along ``dim`` (a dim, a list of dims, or None: all)."""
    shape = op.inputs[0].shape
    if dim is None or not shape:
        return math.prod(shape)
    if isinstance(dim, (list, tuple)):
        return math.prod(shape[d] for d in dim) if dim else math.prod(shape)
    return shape[dim]


def _t_sum(op, a):
    x, n = a(op.args[0]), float(_reduced_count(op))
    if x.lo < 0:
        return [_i_scale(x, n)]
    return [Interval(x.lo, _mul_bound(n, x.hi))]


def _t_cumsum(op, a):
    x = a(op.args[0])
    n = float(_dim_size(op, _arg(op, 1, "dim")) or 1)
    return [Interval(min(x.lo, _mul_bound(n, x.lo)), max(x.hi, _mul_bound(n, x.hi)))]


def _contract(op, a, lhs: int, rhs: int, acc: int | None = None, beta=1, alpha=1):
    k = op.inputs[op.args[lhs].i].shape[-1] if isinstance(op.args[lhs], Ref) else 1
    prod = _i_scale(_i_mul(a(op.args[lhs]), a(op.args[rhs])), float(max(k, 1)) * alpha)
    if acc is None:
        return [prod]
    return [_i_add(_i_scale(a(op.args[acc]), beta), prod)]


def _t_addmm(op, a):
    return _contract(op, a, 1, 2, acc=0, beta=_arg(op, 3, "beta", 1), alpha=_arg(op, 4, "alpha", 1))


def _t_binary(fn):
    return lambda op, a: [fn(a(op.args[0]), a(op.args[1]))]


def _t_add(op, a):
    return [_i_add(a(op.args[0]), _i_scale(a(op.args[1]), _arg(op, 2, "alpha", 1)))]


def _t_sub(op, a):
    return [_i_sub(a(op.args[0]), _i_scale(a(op.args[1]), _arg(op, 2, "alpha", 1)))]


def _t_rsub(op, a):
    return [_i_sub(a(op.args[1]), _i_scale(a(op.args[0]), _arg(op, 2, "alpha", 1)))]


def _t_div(op, a):
    x, y = a(op.args[0]), a(op.args[1])
    if y.lo <= 0.0 <= y.hi:
        return [TOP]
    cands = [u / v for u in (x.lo, x.hi) for v in (y.lo, y.hi)]
    out = Interval(min(cands), max(cands))
    mode = _arg(op, 2, "rounding_mode")
    if mode == "floor" or op.base == "floor_divide":
        return [Interval(math.floor(out.lo), math.floor(out.hi))]
    if mode == "trunc":
        return [Interval(math.trunc(out.lo), math.trunc(out.hi))]
    return [out]


def _t_remainder(op, a):
    m = a(op.args[1])
    if m.lo > 0:  # torch's remainder takes the divisor's sign
        return [Interval(0.0, m.hi)]
    return [Interval(-m.mag, m.mag)] if m.mag < _INF else [TOP]


def _t_minmax(pick):
    def fn(op, a):
        if len(op.args) >= 2 and isinstance(op.args[1], Ref):  # elementwise
            x, y = a(op.args[0]), a(op.args[1])
            return [Interval(pick(x.lo, y.lo), pick(x.hi, y.hi))]
        # a reduction: the values pass, the indices count along the dim
        n = _dim_size(op, _arg(op, 1, "dim"))
        return [a(op.args[0]), Interval(0.0, float(max(n - 1, 0)))][: len(op.outputs)]
    return fn


def _t_clamp(op, a):
    x = a(op.args[0])
    lo_b, hi_b = _arg(op, 1, "min"), _arg(op, 2, "max")
    if op.base == "clamp_max":
        lo_b, hi_b = None, _arg(op, 1, "max")
    lo, hi = x.lo, x.hi
    if lo_b is not None:
        b = a(lo_b)
        lo, hi = max(lo, b.lo), max(hi, b.hi)
    if hi_b is not None:
        b = a(hi_b)
        lo, hi = min(lo, b.lo), min(hi, b.hi)
    return [Interval(min(lo, hi), max(lo, hi))]


def _t_and(op, a):
    x, y = a(op.args[0]), a(op.args[1])
    nonneg = [v.hi for v in (x, y) if v.lo >= 0]
    if nonneg:  # and with a nonnegative operand lies in [0, that operand]
        return [Interval(0.0, min(nonneg))]
    return [dtype_interval(op.outputs[0].dtype)]


def _t_or(op, a):
    x, y = a(op.args[0]), a(op.args[1])
    if x.lo < 0 or y.lo < 0 or max(x.hi, y.hi) == _INF:
        return [dtype_interval(op.outputs[0].dtype)]
    return [Interval(0.0, _bits_max(max(x.hi, y.hi)))]


def _t_pow(op, a):
    base, e = op.args[0], op.args[1]
    if isinstance(e, (int, float)) and not isinstance(e, bool) and float(e).is_integer():
        y = int(e)
        if not 0 <= y <= 64:
            return [TOP]
        out = Interval.point(1.0)
        for _ in range(y):
            out = _i_mul(out, a(base))
        if y % 2 == 0:
            out = Interval(max(out.lo, 0.0), out.hi)
        return [out]
    if isinstance(base, (int, float)) and base > 0 and isinstance(e, Ref):
        x = a(e)
        try:
            lo = base ** x.lo if x.lo > -_INF else 0.0
            hi = base ** x.hi if x.hi < _INF else _INF
        except OverflowError:
            return [TOP]
        return [Interval(min(lo, hi), max(lo, hi))]
    return [TOP]


def _t_exp(op, a):
    x = a(op.args[0])
    lo = math.exp(x.lo) if x.lo > -_INF else 0.0
    hi = math.exp(x.hi) if x.hi < 709 else _INF
    return [Interval(lo, hi)]


def _t_round(op, a):
    x = a(op.args[0])
    lo = math.floor(x.lo) if x.lo > -_INF else x.lo
    hi = math.ceil(x.hi) if x.hi < _INF else x.hi
    return [Interval(float(lo), float(hi))]


def _t_arange(op, a):
    args = list(op.args)
    if len(args) == 1:
        start, end, step = 0, args[0], 1
    else:
        start, end = args[0], args[1]
        step = args[2] if len(args) > 2 else op.kwargs.get("step", 1)
    n = max(0, math.ceil((end - start) / step))
    if n == 0:
        return [Interval.point(0.0)]
    last = start + (n - 1) * step
    return [Interval(float(min(start, last)), float(max(start, last)))]


def _t_full(k: int):
    return lambda op, a: [a(op.args[k])]


def _t_point(v: float):
    return lambda op, a: [Interval.point(v)]


def _t_pass(op, a):
    return [a(op.args[0])] * len(op.outputs)


def _t_join_tensors(op, a):
    return [_join_all(a(Ref(i)) for i in range(len(op.inputs)))] * len(op.outputs)


def _t_where(op, a):
    return [a(op.args[1]).join(a(op.args[2]))]


def _t_masked_fill(op, a):
    return [a(op.args[0]).join(a(op.args[2]))]


def _t_pad(op, a):
    value = _arg(op, 2, "value", 0) or 0
    return [a(op.args[0]).join(Interval.point(value))]


def _t_index_put(op, a):
    x, v = a(op.args[0]), a(op.args[2])
    if _arg(op, 3, "accumulate", False):
        n = float(math.prod(op.inputs[op.args[2].i].shape)) if isinstance(op.args[2], Ref) else 1.0
        return [Interval(x.lo + min(0.0, _mul_bound(n, v.lo)), x.hi + max(0.0, _mul_bound(n, v.hi)))]
    return [x.join(v)]


def _t_scatter(op, a):
    src = _arg(op, 3, "src", _arg(op, 3, "value"))
    return [a(op.args[0]).join(a(src))]


def _t_scatter_add(op, a):
    # worst case every source element lands on one element
    x, src = a(op.args[0]), a(op.args[3])
    n = float(math.prod(op.inputs[op.args[3].i].shape)) if isinstance(op.args[3], Ref) else 1.0
    return [Interval(x.lo + min(0.0, _mul_bound(n, src.lo)), x.hi + max(0.0, _mul_bound(n, src.hi)))]


def _t_index_copy(op, a):
    return [a(op.args[0]).join(a(op.args[3]))]


def _t_index_add(op, a):
    x, src = a(op.args[0]), _i_scale(a(op.args[3]), _arg(op, 4, "alpha", 1))
    n = float(op.inputs[op.args[3].i].shape[op.args[1]]) if isinstance(op.args[3], Ref) else 1.0
    return [Interval(x.lo + min(0.0, _mul_bound(n, src.lo)), x.hi + max(0.0, _mul_bound(n, src.hi)))]


def _t_top_k(op, a):
    n = op.inputs[0].shape[_arg(op, 2, "dim", -1)] if op.inputs[0].shape else 1
    return [a(op.args[0]), Interval(0.0, float(max(n - 1, 0)))]


def _t_sort(op, a):
    dim = _arg(op, 1, "dim", -1)
    n = op.inputs[0].shape[dim] if op.inputs[0].shape and isinstance(dim, int) else 1
    return [a(op.args[0]), Interval(0.0, float(max(n - 1, 0)))]


def _t_argminmax(op, a):
    n = _dim_size(op, _arg(op, 1, "dim"))
    return [Interval(0.0, float(max(n - 1, 0)))]


def _t_sqrt(op, a):
    x = a(op.args[0])
    return [Interval(math.sqrt(max(x.lo, 0.0)), math.sqrt(x.hi) if x.hi < _INF else _INF)]


_UNIT = lambda op, a: [Interval(-1.0, 1.0)]  # noqa: E731
_ZERO_ONE = lambda op, a: [ZERO_ONE] * len(op.outputs)  # noqa: E731
_NONNEG = lambda op, a: [Interval(0.0, _INF)]  # noqa: E731

_TRANSFER: dict[str, Callable] = {
    "add": _t_add,
    "sub": _t_sub,
    "rsub": _t_rsub,
    "mul": _t_binary(_i_mul),
    "div": _t_div,
    "floor_divide": _t_div,
    "remainder": _t_remainder,
    "fmod": _t_remainder,
    "neg": lambda op, a: [_i_neg(a(op.args[0]))],
    "abs": lambda op, a: [_i_abs(a(op.args[0]))],
    "sign": _UNIT,
    "maximum": _t_binary(lambda x, y: Interval(max(x.lo, y.lo), max(x.hi, y.hi))),
    "minimum": _t_binary(lambda x, y: Interval(min(x.lo, y.lo), min(x.hi, y.hi))),
    "max": _t_minmax(max),
    "min": _t_minmax(min),
    "amax": _t_pass,
    "amin": _t_pass,
    "clamp": _t_clamp,
    "clamp_min": _t_clamp,
    "clamp_max": _t_clamp,
    "where": _t_where,
    "masked_fill": _t_masked_fill,
    "bitwise_and": _t_and,
    "__and__": _t_and,
    "bitwise_or": _t_or,
    "__or__": _t_or,
    "bitwise_xor": _t_or,
    "__xor__": _t_or,
    "bitwise_left_shift": lambda op, a: [_shift(a(op.args[0]), a(op.args[1]), True)],
    "__lshift__": lambda op, a: [_shift(a(op.args[0]), a(op.args[1]), True)],
    "bitwise_right_shift": lambda op, a: [_shift(a(op.args[0]), a(op.args[1]), False)],
    "__rshift__": lambda op, a: [_shift(a(op.args[0]), a(op.args[1]), False)],
    "sum": _t_sum,
    "cumsum": _t_cumsum,
    "mean": _t_pass,
    "mm": lambda op, a: _contract(op, a, 0, 1),
    "bmm": lambda op, a: _contract(op, a, 0, 1),
    "mv": lambda op, a: _contract(op, a, 0, 1),
    "dot": lambda op, a: _contract(op, a, 0, 1),
    "_int_mm": lambda op, a: _contract(op, a, 0, 1),
    "addmm": _t_addmm,
    "baddbmm": _t_addmm,
    "addbmm": _t_addmm,
    "addmv": _t_addmm,
    "arange": _t_arange,
    "full": _t_full(1),
    "full_like": _t_full(1),
    "new_full": _t_full(2),
    "scalar_tensor": _t_full(0),
    "fill": _t_full(1),
    "zeros": _t_point(0.0),
    "zeros_like": _t_point(0.0),
    "new_zeros": _t_point(0.0),
    "zero": _t_point(0.0),
    "ones": _t_point(1.0),
    "ones_like": _t_point(1.0),
    "new_ones": _t_point(1.0),
    "argmax": _t_argminmax,
    "argmin": _t_argminmax,
    "topk": _t_top_k,
    "sort": _t_sort,
    "clone": _t_pass,
    "_unsafe_view": _t_pass,
    "_to_copy": _t_pass,
    "copy": lambda op, a: [a(op.args[1])],
    "index": _t_pass,
    "index_select": _t_pass,
    "gather": _t_pass,
    "take": _t_pass,
    "embedding": _t_pass,
    "repeat": _t_pass,
    "repeat_interleave": lambda op, a: (
        [a(op.args[0])] if isinstance(op.args[0], Ref) and op.inputs[0].dtype.is_floating_point
        else [dtype_interval(op.outputs[0].dtype)]
    ),
    "flip": _t_pass,
    "roll": _t_pass,
    "cat": _t_join_tensors,
    "stack": _t_join_tensors,
    "constant_pad_nd": _t_pad,
    "tril": lambda op, a: [a(op.args[0]).join(Interval.point(0.0))],
    "triu": lambda op, a: [a(op.args[0]).join(Interval.point(0.0))],
    "index_put": _t_index_put,
    "index_copy": _t_index_copy,
    "index_add": _t_index_add,
    "scatter": _t_scatter,
    "scatter_add": _t_scatter_add,
    "relu": lambda op, a: [Interval(max(a(op.args[0]).lo, 0.0), max(a(op.args[0]).hi, 0.0))],
    "tanh": _UNIT,
    "sin": _UNIT,
    "cos": _UNIT,
    "erf": _UNIT,
    "sigmoid": _ZERO_ONE,
    "_softmax": _ZERO_ONE,
    "exp": _t_exp,
    "exp2": lambda op, a: _t_pow(
        Op("pow", op.inputs, op.outputs, (), (2.0, op.args[0])), a),
    "pow": _t_pow,
    "square": lambda op, a: _t_pow(Op("pow", op.inputs, op.outputs, (), (op.args[0], 2)), a),
    "floor": _t_round,
    "ceil": _t_round,
    "round": _t_round,
    "trunc": _t_round,
    "sqrt": _t_sqrt,
    "rsqrt": _NONNEG,
    "eq": _ZERO_ONE,
    "ne": _ZERO_ONE,
    "lt": _ZERO_ONE,
    "le": _ZERO_ONE,
    "gt": _ZERO_ONE,
    "ge": _ZERO_ONE,
    "logical_and": _ZERO_ONE,
    "logical_or": _ZERO_ONE,
    "logical_not": _ZERO_ONE,
    "logical_xor": _ZERO_ONE,
    "isnan": _ZERO_ONE,
    "isinf": _ZERO_ONE,
    "isfinite": _ZERO_ONE,
    "any": _ZERO_ONE,
    "all": _ZERO_ONE,
}

# Signed-integer arithmetic flagged when its ideal interval escapes the
# machine dtype (casts narrow on purpose; unsigned ops wrap by definition).
FLAGGED = frozenset({
    "add", "sub", "rsub", "mul", "mm", "bmm", "mv", "dot", "_int_mm", "addmm",
    "baddbmm", "addbmm", "addmv", "sum", "cumsum", "scatter_add", "index_add",
    "index_put", "bitwise_left_shift", "__lshift__", "pow", "square",
})
# creation ops that allocate without writing
_EMPTY = frozenset({"empty", "empty_like", "new_empty", "empty_strided"})


class _Interp:
    def __init__(self, kernel_model):
        self.kernel_model = kernel_model
        # storage id -> {dtype: interval}: the buffer as each dtype reads it
        # (None: allocated, not yet written)
        self.env: dict[int, dict[torch.dtype, Interval | None]] = {}
        self.facts: list[OverflowFact] = []

    def read(self, meta) -> Interval:
        views = self.env.get(meta.storage)
        if views is None:  # a step input
            iv = input_interval(meta.dtype)
            self.env[meta.storage] = {meta.dtype: iv}
            return iv
        got = views.get(meta.dtype)  # absent: a bit reinterpretation
        return got if got is not None else dtype_interval(meta.dtype)

    def write(self, op: Op, meta, ideal: Interval, join: bool):
        d = meta.dtype
        machine = dtype_interval(d)
        if _signed(d) and not ideal.within(machine):
            if op.base in FLAGGED:
                name = str(d).replace("torch.", "")
                self.facts.append(OverflowFact(
                    primitive=op.base,
                    dtype=name,
                    ideal=(ideal.lo, ideal.hi),
                    detail=(
                        f"{op.base} -> {name} {meta.shape}: ideal range "
                        f"[{ideal.lo:.6g}, {ideal.hi:.6g}] escapes "
                        f"[{machine.lo:.0f}, {machine.hi:.0f}]"
                    ),
                ))
            ideal = machine  # a wrapped value can be anywhere in the dtype
        elif not d.is_floating_point and not ideal.within(machine):
            ideal = machine if _unsigned(d) else _clamp_to(ideal, machine)
        old = self.env.get(meta.storage, {}).get(d)
        if join and old is not None:
            ideal = old.join(ideal)
        # every other dtype's reading of the buffer is stale now
        self.env[meta.storage] = {d: ideal}

    def step(self, op: Op):
        if op.view:  # an alias: its buffer's intervals already stand for it
            return
        ins = [self.read(m) for m in op.inputs]

        def a(x):
            if isinstance(x, Ref):
                return ins[x.i]
            if isinstance(x, (bool, int, float)) and not math.isnan(x):
                return Interval.point(float(x))
            return TOP

        in_storages = {m.storage for m in op.inputs}
        if op.opaque:
            outs = self.kernel_model(op, ins) if self.kernel_model is not None else None
            if outs is None:
                outs = [dtype_interval(m.dtype) for m in op.outputs]
        elif op.base in _EMPTY:
            for m in op.outputs:
                self.env[m.storage] = {m.dtype: None}
            return
        elif op.base in LIFTS:
            outs = [Interval(*op.const) if op.const else dtype_interval(op.outputs[0].dtype)]
        else:
            fn = _TRANSFER.get(op.base)
            outs = None
            if fn is not None:
                try:
                    outs = fn(op, a)
                except (KeyError, IndexError, ValueError, TypeError, OverflowError,
                        AttributeError, ZeroDivisionError):
                    outs = None
            if outs is None or len(outs) != len(op.outputs):
                outs = [dtype_interval(m.dtype) for m in op.outputs]
        for m, iv in zip(op.outputs, outs):
            if m.storage in in_storages and not op.mutates and not op.opaque:
                continue  # hands back an input's buffer unchanged
            if op.base in ("_to_copy", "copy") or m.dtype == torch.bool:
                iv = _clamp_to(iv, dtype_interval(m.dtype))
            self.write(op, m, iv, join=op.mutates and not op.opaque)


def interval_eval(ops, *, kernel_model=None) -> tuple[dict, list[OverflowFact]]:
    """Propagate intervals through the recorded ``ops``; return ``(env,
    facts)``: ``env[storage id][dtype]`` each buffer's final interval as
    that dtype reads it (``None``: allocated, never written) and every
    signed-integer overflow found on the way.  ``kernel_model(op,
    in_intervals) -> list[Interval] | None`` bounds an opaque kernel's
    outputs."""
    interp = _Interp(kernel_model)
    for op in as_ops(ops):
        interp.step(op)
    return interp.env, interp.facts
