"""TL1 activation-side look-up tables, the second table family
(counterpart of ``repro/core/lut_tl1.py``).

The weight family (:mod:`repro_torch.core.lut`) builds tables from the
weights and indexes them with activation codes.  TL1 inverts that:

* Convert time: weights are ternarised (absmean, -1/0/+1, one fp32 scale
  per weight matrix) and each pair along the input axis becomes a base-3
  index ``(t0+1)*3 + (t1+1)`` in ``0..8``.  Two indices pack per byte,
  low nibble first, so a projection stores ``(kb, p)`` uint8 with
  ``kb = ceil(ceil(q/2)/2)``: ``q*p/4`` bytes.
* Run time: activations are quantized per token (int8 absmax by default)
  and each pair ``(a0, a1)`` gets a 9-entry LUT of ``s0*a0 + s1*a1``,
  ``s = (i//3 - 1, i%3 - 1)``, in the order
  ``[-a0-a1, -a0, a1-a0, -a1, 0, a1, a0-a1, a0, a0+a1]``: sums and
  differences only.  ``y[p] = s_w * s_a * sum_c lut[c, widx[c, p]]``.

int8 codes give int16 entries (|entry| <= 254) and an int32 accumulator,
whose width ``repro_torch.audit.ranges`` proves per plan.  ``act_bits=None``
is the exact fp32 variant: no activation quantization, adds only.

This module is the plain oracle; ``repro_torch.kernels.lut_tl1`` runs the
same contract on the Hopper kernels.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import absmax_int_quantize, ternary_quantize


@dataclasses.dataclass(frozen=True)
class TL1Plan:
    """How one affine layer (q -> p) maps onto TL1 activation-side tables,
    with the accounting surface of :class:`~repro_torch.core.lut.LUTPlan`."""

    in_features: int  # q
    out_features: int  # p
    # Activation quantization width (per-token absmax); None = exact fp32.
    act_bits: int | None = 8
    # TPU tile sizes of a plan read from the reference's JSON.  The port's
    # kernels tile on their own and never read this; it only round-trips.
    blocks: tuple[int, int, int] | None = None
    # Accumulator contract: int32 (fp32 on the exact path) and the proved
    # worst-case |accumulator| in code units, stamped by plan_model
    # (derived metadata, so excluded from equality).
    acc_dtype: str = "int32"
    max_abs_acc: float | None = dataclasses.field(default=None, compare=False)

    table_family = "tl1"

    def __post_init__(self):
        if self.act_bits is not None and not (2 <= int(self.act_bits) <= 8):
            raise ValueError(f"act_bits must be None or in [2, 8], got {self.act_bits}")
        if self.blocks is not None:
            object.__setattr__(self, "blocks", tuple(int(v) for v in self.blocks))
            if len(self.blocks) != 3 or any(v <= 0 for v in self.blocks):
                raise ValueError(f"blocks must be 3 positive ints, got {self.blocks}")
        if self.acc_dtype not in ("int16", "int32", "float32"):
            raise ValueError(f"unknown acc_dtype {self.acc_dtype!r}")
        if self.act_bits is None:
            # the exact path's codes are fp32, so every path accumulates fp32
            object.__setattr__(self, "acc_dtype", "float32")
        if self.max_abs_acc is not None:
            object.__setattr__(self, "max_abs_acc", float(self.max_abs_acc))
            if self.max_abs_acc < 0:
                raise ValueError(f"max_abs_acc must be >= 0, got {self.max_abs_acc}")

    @property
    def chunk_size(self) -> int:  # input elements per index
        return 2

    @property
    def num_chunks(self) -> int:  # k: weight pairs (4-bit indices)
        return -(-self.in_features // 2)

    @property
    def packed_chunks(self) -> int:  # kb: bytes per output column
        return -(-self.num_chunks // 2)

    @property
    def padded_in(self) -> int:
        return 4 * self.packed_chunks

    @property
    def num_entries(self) -> int:
        return 9

    @property
    def num_planes(self) -> int:
        return 1

    @property
    def lut_evaluations(self) -> int:
        return self.num_chunks

    @property
    def shift_add_ops(self) -> int:
        """Adds per token: ``p*(k-1)`` accumulate + ``9k`` LUT build."""
        return self.out_features * (self.num_chunks - 1) + 9 * self.num_chunks

    @property
    def storage_bits(self) -> int:  # per packed index pair (one byte)
        return 8

    @property
    def total_lut_bits(self) -> int:
        """Persistent bytes only: the packed index leaf (the per-step
        activation LUT is transient and not charged)."""
        return self.packed_chunks * self.out_features * self.storage_bits

    @property
    def total_lut_bytes(self) -> int:
        return self.total_lut_bits // 8


# ---------------------------------------------------------------------------
# Packing (convert time)
# ---------------------------------------------------------------------------


def pack_ternary(t: torch.Tensor) -> torch.Tensor:
    """(q, p) ternary codes -> (kb, p) uint8 packed base-3 pair indices,
    low nibble first; the ragged tail pads with ternary 0."""
    q, p = t.shape
    tp = F.pad(t.to(torch.int32), (0, 0, 0, -q % 4))
    idx = (tp[0::2] + 1) * 3 + (tp[1::2] + 1)  # (2*kb, p) in 0..8
    return (idx[0::2] | (idx[1::2] << 4)).to(torch.uint8)


def unpack_indices(packed: torch.Tensor) -> torch.Tensor:
    """(..., kb, p) uint8 -> (..., 2*kb, p) int32 base-3 indices in 0..8."""
    b = packed.to(torch.int32)
    stacked = torch.stack([b & 15, b >> 4], dim=-2)  # (..., kb, 2, p)
    return stacked.reshape(*packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])


def build_tl1_tables(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, p) weights -> (packed (kb, p) uint8, 0-d float32 scale)."""
    t, s = ternary_quantize(w)
    return pack_ternary(t), s


# ---------------------------------------------------------------------------
# Application (run time)
# ---------------------------------------------------------------------------


def quantize_acts(
    x: torch.Tensor, plan: TL1Plan
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(..., q) -> (codes (..., padded_in), per-token scale (..., 1) | None).

    int path: int32 codes and a float32 scale; exact path: float32 values
    and no scale.  The padding is zeros, so padded pairs add 0."""
    q = plan.in_features
    if x.shape[-1] != q:
        raise ValueError(f"activation width {x.shape[-1]} != plan in_features {q}")
    pad = plan.padded_in - q
    if plan.act_bits is None:
        return F.pad(x.to(torch.float32), (0, pad)), None
    codes, scale = absmax_int_quantize(x, bits=int(plan.act_bits), axis=-1)
    return F.pad(codes, (0, pad)), scale


def build_act_lut(acts: torch.Tensor) -> torch.Tensor:
    """(..., 2k) activation codes -> (..., k, 9) per-pair LUT, adds only:
    int16 entries from integer codes, float32 from float codes."""
    a0, a1 = acts[..., 0::2], acts[..., 1::2]
    z = torch.zeros_like(a0)
    lut = torch.stack(
        [-a0 - a1, -a0, a1 - a0, -a1, z, a1, a0 - a1, a0, a0 + a1], dim=-1
    )
    return lut if lut.is_floating_point() else lut.to(torch.int16)


def apply_tl1(
    tables: torch.Tensor,
    x: torch.Tensor,
    plan: TL1Plan,
    bias: torch.Tensor | None = None,
    scale: torch.Tensor | None = None,
    acts: tuple[torch.Tensor, torch.Tensor | None] | None = None,
) -> torch.Tensor:
    """Plain TL1 affine: tables (kb, p) uint8, x (..., q) -> (..., p).

    ``scale`` is the ternary weight scale (default 1); ``acts`` optionally
    carries already quantized activations.  Dequant order as the
    reference: accumulate, then the activation scale, then ``scale``,
    then ``bias``."""
    # call-time import: the plain kernel version builds on this module
    from repro_torch.kernels.lut_tl1.ref import lut_tl1_ref

    codes, s_a = quantize_acts(x, plan) if acts is None else acts
    acc = lut_tl1_ref(codes.reshape(-1, codes.shape[-1]), tables)
    acc = acc.reshape(*codes.shape[:-1], tables.shape[-1]).to(torch.float32)
    y = acc * s_a if s_a is not None else acc
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias
    return y


def tl1_linear_reference(w: torch.Tensor, x: torch.Tensor, plan: TL1Plan, bias=None):
    """Convert and apply in one call (tests)."""
    packed, s = build_tl1_tables(w)
    return apply_tl1(packed, x, plan, bias=bias, scale=s)
