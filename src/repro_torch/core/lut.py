"""TableNet LUT construction and plain application (counterpart of
``repro/core/lut.py``).

An affine map ``y = W x + b`` becomes ``k`` tables of ``E`` rows: table
``c`` maps the chunk-``c`` index (a bit pattern of the quantized input) to
the partial output ``W_chunk · alpha``.  The three modes are the
reference's:

* ``"bitplane"`` (fixed point or binary16): the same tables serve every
  input bitplane, and plane sums are shift-added.
* ``"full"`` (fixed point; binary16 at chunk 1): one index per chunk from
  all of its bits.
* ``"bitplane_shift"`` (binary16, chunk 1): the fp16 exponent is factored
  out of the tables and rides in the high bits of each packed code; the
  accumulate applies ``sigma(e) = 2**(max(e,1)-25)`` as a shift.

Tables can be built a chunk slice at a time (``chunks=``); every entry is
computed exactly as in the whole-array build, so a sliced build is
bit-identical to it.  That is what lets the converter build full-width
tables without ever holding a whole fp32 table set.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from repro_torch.core.quantize import FixedPointFormat, Float16Format
from repro_torch.kernels.lut_affine.ref import lut_affine_ref

Format = Union[FixedPointFormat, Float16Format]

TABLE_QMAX = {"i8": 127.0, "i16": 32767.0}
TABLE_DTYPES = {"i8": torch.int8, "i16": torch.int16}


@dataclasses.dataclass(frozen=True)
class LUTPlan:
    """How one affine layer (q -> p) is mapped onto LUTs."""

    in_features: int  # q
    out_features: int  # p
    chunk_size: int  # m: input elements per table
    fmt: Format
    mode: str = "bitplane"  # "bitplane" | "full" | "bitplane_shift"
    out_bits: int = 16  # r_O, for size accounting only (compute is fp32)
    # Storage format of the table entries: None keeps the converter's
    # table_dtype (accounted at out_bits); "i8"/"i16" store integer tables
    # with one power-of-2 dequant scale per table set.
    table_format: str | None = None
    # TPU tile sizes of a plan read from the reference's JSON.  The port's
    # kernels tile on their own and never read this; it only round-trips.
    blocks: tuple[int, int, int] | None = None
    # Accumulator contract: the dtype the kernels accumulate in and the
    # statically proved worst-case |accumulator| (stamped by plan_model;
    # derived metadata, so excluded from equality).
    acc_dtype: str = "float32"
    max_abs_acc: float | None = dataclasses.field(default=None, compare=False)

    table_family = "weight"

    def __post_init__(self):
        if self.mode not in ("bitplane", "full", "bitplane_shift"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == "full" and isinstance(self.fmt, Float16Format):
            if self.chunk_size != 1:
                raise ValueError("full-bits float LUTs only support chunk_size=1")
        if self.mode == "bitplane_shift":
            if not isinstance(self.fmt, Float16Format):
                raise ValueError("bitplane_shift requires Float16Format")
            if self.chunk_size != 1:
                raise ValueError("bitplane_shift only supports chunk_size=1")
        if self.table_format not in (None, "i8", "i16"):
            raise ValueError(f"unknown table_format {self.table_format!r}")
        if self.blocks is not None:
            object.__setattr__(self, "blocks", tuple(int(v) for v in self.blocks))
            if len(self.blocks) != 3 or any(v <= 0 for v in self.blocks):
                raise ValueError(f"blocks must be 3 positive ints, got {self.blocks}")
        if self.acc_dtype not in ("int16", "int32", "float32"):
            raise ValueError(f"unknown acc_dtype {self.acc_dtype!r}")
        if self.max_abs_acc is not None:
            object.__setattr__(self, "max_abs_acc", float(self.max_abs_acc))
            if self.max_abs_acc < 0:
                raise ValueError(f"max_abs_acc must be >= 0, got {self.max_abs_acc}")
        if self.index_bits > 24:
            raise ValueError(
                f"LUT index width {self.index_bits} bits is impractically large"
            )

    @property
    def num_chunks(self) -> int:  # k
        return -(-self.in_features // self.chunk_size)

    @property
    def padded_in(self) -> int:
        return self.num_chunks * self.chunk_size

    @property
    def fields_per_element(self) -> int:
        """Index bits contributed by one input element."""
        if isinstance(self.fmt, Float16Format):
            if self.mode == "full":
                return 15
            if self.mode == "bitplane_shift":
                return self.fmt.mantissa_radix + (1 if self.fmt.signed else 0)
            return self.fmt.fields_per_element
        return 1 if self.mode == "bitplane" else self.fmt.total_bits

    @property
    def index_bits(self) -> int:
        return self.chunk_size * self.fields_per_element

    @property
    def num_entries(self) -> int:
        return 2**self.index_bits

    @property
    def num_planes(self) -> int:
        if self.mode == "full":
            return 1
        return self.fmt.num_planes

    @property
    def shift_bits(self) -> int:
        """The kernels' ``shift_bits`` argument: the index width for
        ``bitplane_shift`` codes (exponent above it), 0 otherwise."""
        return self.index_bits if self.mode == "bitplane_shift" else 0

    # -- the paper's cost accounting -----------------------------------------
    @property
    def lut_evaluations(self) -> int:
        return self.num_planes * self.num_chunks

    @property
    def shift_add_ops(self) -> int:
        """p-element adds: p * (n*k - 1)."""
        return self.out_features * (self.lut_evaluations - 1)

    @property
    def storage_bits(self) -> int:
        if self.table_format == "i8":
            return 8
        if self.table_format == "i16":
            return 16
        return self.out_bits

    @property
    def total_lut_bits(self) -> int:
        per_entry = self.out_features * self.storage_bits
        return self.num_chunks * self.num_entries * per_entry

    @property
    def total_lut_bytes(self) -> int:
        return self.total_lut_bits // 8


# ---------------------------------------------------------------------------
# Table construction
# ---------------------------------------------------------------------------


def _fixed_full_coeffs(plan: LUTPlan) -> np.ndarray:
    fmt: FixedPointFormat = plan.fmt  # type: ignore[assignment]
    r = fmt.total_bits
    idx = np.arange(plan.num_entries, dtype=np.int64)
    slots = np.arange(plan.chunk_size)
    codes = (idx[:, None] >> (slots[None, :] * r)) & (2**r - 1)
    if fmt.signed:
        codes = codes - (codes >= 2 ** (r - 1)) * 2**r
    return codes.astype(np.float64) * fmt.scale


def _float_bitplane_coeffs(plan: LUTPlan) -> np.ndarray:
    fmt: Float16Format = plan.fmt  # type: ignore[assignment]
    f = fmt.fields_per_element
    r = fmt.mantissa_radix
    idx = np.arange(plan.num_entries, dtype=np.int64)
    slots = np.arange(plan.chunk_size)
    fields = (idx[:, None] >> (slots[None, :] * f)) & (2**f - 1)
    slices = (fields >> fmt.exp_bits) & (2**r - 1)
    exps = fields & (2**fmt.exp_bits - 1)
    sigma = 2.0 ** (np.maximum(exps, 1).astype(np.float64) - 25.0)
    coeff = slices.astype(np.float64) * sigma
    if fmt.signed:
        sign = fields >> (fmt.exp_bits + r)
        coeff = coeff * (1.0 - 2.0 * sign)
    return coeff


def _float_shift_coeffs(plan: LUTPlan) -> np.ndarray:
    fmt: Float16Format = plan.fmt  # type: ignore[assignment]
    r = fmt.mantissa_radix
    idx = np.arange(plan.num_entries, dtype=np.int64)
    coeff = (idx & (2**r - 1)).astype(np.float64)
    if fmt.signed:
        coeff = coeff * (1.0 - 2.0 * (idx >> r))
    return coeff[:, None]


def _float_full_coeffs(plan: LUTPlan) -> np.ndarray:
    idx = np.arange(plan.num_entries, dtype=np.uint16)
    return idx.view(np.float16).astype(np.float64)[:, None]


def lut_coeffs(plan: LUTPlan) -> np.ndarray:
    """(entries, m) dequantised coefficient of each element slot per index."""
    if isinstance(plan.fmt, Float16Format):
        if plan.mode == "bitplane":
            return _float_bitplane_coeffs(plan)
        if plan.mode == "bitplane_shift":
            return _float_shift_coeffs(plan)
        return _float_full_coeffs(plan)
    if plan.mode == "bitplane":
        idx = np.arange(plan.num_entries, dtype=np.int64)
        slots = np.arange(plan.chunk_size)
        return ((idx[:, None] >> slots[None, :]) & 1).astype(np.float64)
    return _fixed_full_coeffs(plan)


def build_luts(
    W: torch.Tensor, plan: LUTPlan, chunks: tuple[int, int] | None = None
) -> torch.Tensor:
    """fp32 tables ``(k, entries, p)`` for ``W (q, p)`` — or only chunks
    ``[c0, c1)`` of them, shape ``(c1 - c0, entries, p)``.

    ``T[c, e, :] = sum_i coeff_i(e) * W[c*m + i, :]``, summed over the slot
    ``i`` in order (at chunk 1: one exact product).  The ragged tail chunk
    reads zero rows, as the reference's zero padding does.
    """
    q, p = W.shape
    assert q == plan.in_features and p == plan.out_features, (W.shape, plan)
    m = plan.chunk_size
    c0, c1 = chunks if chunks is not None else (0, plan.num_chunks)
    rows = W[c0 * m : min(c1 * m, q)].to(torch.float32)
    pad = (c1 - c0) * m - rows.shape[0]
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, p))])
    Wc = rows.reshape(c1 - c0, m, p)
    coeffs = torch.as_tensor(lut_coeffs(plan), dtype=torch.float32, device=W.device)
    # summed from +0.0 as a dot product is, so an all-zero entry is +0.0
    out = Wc.new_zeros((c1 - c0, plan.num_entries, p))
    for i in range(m):
        out = out + coeffs[None, :, i, None] * Wc[:, None, i, :]
    return out


def plane_scales(plan: LUTPlan) -> np.ndarray:
    """(num_planes,) multipliers applied to per-plane table sums."""
    if plan.mode == "full":
        return np.ones((1,), np.float64)
    return plan.fmt.plane_scales()


# ---------------------------------------------------------------------------
# Input packing: float -> LUT index codes
# ---------------------------------------------------------------------------


def _pack_fields(fields: torch.Tensor, plan: LUTPlan) -> torch.Tensor:
    """(..., q_padded) per-element field ints -> (..., k) chunk indices."""
    f = plan.fields_per_element
    chunked = fields.reshape(fields.shape[:-1] + (plan.num_chunks, plan.chunk_size))
    shifts = (
        torch.arange(plan.chunk_size, dtype=torch.int32, device=fields.device) * f
    ).reshape((1,) * (chunked.ndim - 1) + (-1,))
    return torch.sum(chunked << shifts, dim=-1).to(torch.int32)


def _pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


def pack_codes(x: torch.Tensor, plan: LUTPlan) -> torch.Tensor:
    """Quantise ``x`` (..., q) and emit LUT indices of shape (..., n, k)."""
    pad = plan.padded_in - plan.in_features
    if isinstance(plan.fmt, Float16Format):
        h = _pad_last(plan.fmt.quantize(x), pad)
        if plan.mode == "full":
            u = Float16Format._bits(h)
            return u[..., None, :]
        exp, planes = plan.fmt.decompose(h)  # (...,q), (n,...,q)
        if plan.mode == "bitplane_shift":
            r = plan.fmt.mantissa_radix
            fields = planes
            if plan.fmt.signed:
                fields = fields + (plan.fmt.sign_bits(h) << r)[None]
            # exponent rides in the high bits: gather with
            # ``code & (entries-1)``, shift with ``code >> index_bits``.
            codes = fields + (exp << plan.index_bits)[None]
            return torch.movedim(codes.to(torch.int32), 0, -2)
        fields = (planes << plan.fmt.exp_bits) + exp[None]
        if plan.fmt.signed:
            sign = plan.fmt.sign_bits(h)
            shift = plan.fmt.exp_bits + plan.fmt.mantissa_radix
            fields = fields + (sign << shift)[None]
        return torch.movedim(_pack_fields(fields, plan), 0, -2)
    fmt: FixedPointFormat = plan.fmt  # type: ignore[assignment]
    c = _pad_last(fmt.quantize(x), pad)
    if plan.mode == "full":
        return _pack_fields(fmt.to_unsigned_bits(c), plan)[..., None, :]
    return torch.movedim(_pack_fields(fmt.bitplanes(c), plan), 0, -2)


# ---------------------------------------------------------------------------
# Narrow table storage
# ---------------------------------------------------------------------------


def scale_from_maxabs(maxabs: torch.Tensor, table_format: str) -> torch.Tensor:
    """``2**ceil(log2(maxabs / qmax))`` in fp32, the reference's formula
    (a power of two, so folding it into the accumulate stays a shift).

    The power of two is built from its exponent bits: torch's vectorised
    CPU ``exp2`` lands ulps off 2**e at integer arguments, where the
    reference's is exact."""
    m = torch.clamp(
        maxabs.to(torch.float32), min=torch.finfo(torch.float32).tiny
    )
    e = torch.ceil(torch.log2(m / TABLE_QMAX[table_format]))
    exact = ((e.to(torch.int32).clamp(-126, 127) + 127) << 23).view(torch.float32)
    return torch.where(e >= -126, exact, torch.exp2(e))


def table_scale(
    tables: torch.Tensor, table_format: str, trailing: int | None = None
) -> torch.Tensor:
    """Power-of-2 dequant scale; ``trailing`` dims form one table set and
    share a scalar, leading (layer) dims keep one entry each."""
    t = tables.to(torch.float32).abs()
    if trailing is None or trailing >= tables.ndim:
        maxabs = t.max()
    else:
        maxabs = t.amax(dim=tuple(range(tables.ndim - trailing, tables.ndim)))
    return scale_from_maxabs(maxabs, table_format)


def quantize_with_scale(
    tables: torch.Tensor, scale: torch.Tensor, table_format: str
) -> torch.Tensor:
    qmax = TABLE_QMAX[table_format]
    s = scale.to(tables.device).reshape(scale.shape + (1,) * (tables.ndim - scale.ndim))
    q = torch.clamp(torch.round(tables.to(torch.float32) / s), -qmax, qmax)
    return q.to(TABLE_DTYPES[table_format])


def quantize_tables(
    tables: torch.Tensor, table_format: str, trailing: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 tables -> (narrow integer tables, power-of-2 dequant scale)."""
    s = table_scale(tables, table_format, trailing)
    return quantize_with_scale(tables, s, table_format), s


# ---------------------------------------------------------------------------
# Plain application
# ---------------------------------------------------------------------------


def apply_luts(
    tables: torch.Tensor,
    codes: torch.Tensor,
    plan: LUTPlan,
    bias: torch.Tensor | None = None,
    scales=None,
) -> torch.Tensor:
    """``(..., n, k)`` codes + ``(k, E, p)`` tables -> ``(..., p)`` fp32:
    ``sum_j scale_j * sum_c T[c, codes[..., j, c], :]`` (+ bias)."""
    if scales is None:
        scales = plane_scales(plan)
    *lead, n, k = codes.shape
    s = torch.as_tensor(np.asarray(scales, np.float32), device=codes.device)
    out = lut_affine_ref(codes.reshape(-1, n, k), tables, s, plan.shift_bits)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.reshape(*lead, out.shape[-1])


def lut_affine_reference(
    x: torch.Tensor, W: torch.Tensor, b: torch.Tensor | None, plan: LUTPlan
) -> torch.Tensor:
    """End-to-end plain path: pack -> tables -> apply."""
    return apply_luts(build_luts(W, plan), pack_codes(x, plan), plan, bias=b)
