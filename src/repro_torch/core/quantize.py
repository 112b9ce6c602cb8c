"""Number formats for TableNet LUT inputs (counterpart of
``repro/core/quantize.py``).

* :class:`FixedPointFormat` — n-bit fixed point, signed (two's complement)
  or unsigned, with ``frac_bits`` fractional bits.  Bitplane ``j`` of the
  stored code contributes ``bit * 2**(j - frac_bits)``; the MSB of a signed
  code contributes ``-2**(n-1-frac_bits)``.
* :class:`Float16Format` — IEEE binary16.  The 11-bit mantissa (10 stored
  bits plus the implicit one) is cut into ``mantissa_radix``-bit planes;
  plane ``j`` of ``x`` contributes ``slice_j * (2**r)**j * sigma(e)`` with
  ``sigma(e) = 2**(max(e,1) - 25)``, exact for normals and subnormals.

Both decompositions are bit-exact against the reference on the same
inputs.

* :func:`ternary_quantize` / :func:`ternary_fake_quant` — absmean
  ternarisation of a weight matrix for the TL1 family, and
  :func:`absmax_int_quantize`, its per-token activation quantizer.
* :func:`build_stochastic_rounding_lut` / :func:`stochastic_round_via_lut`
  — the paper's stochastic rounding as a table indexed by (counter mod R,
  input code), the table built in numpy exactly as the reference builds it.

``dequantize`` and ``fake_quant`` are bit for bit the reference's on fp32
input.  ``FixedPointFormat.quantize_stochastic`` draws from a
``torch.Generator`` where the reference takes a JAX key: the same rule,
other random numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """``total_bits``-wide fixed point with ``frac_bits`` fractional bits."""

    total_bits: int
    frac_bits: int
    signed: bool = False

    def __post_init__(self):
        if not (1 <= self.total_bits <= 24):
            raise ValueError(f"total_bits must be in [1, 24], got {self.total_bits}")

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.frac_bits)

    @property
    def code_min(self) -> int:
        return -(2 ** (self.total_bits - 1)) if self.signed else 0

    @property
    def code_max(self) -> int:
        return 2 ** (self.total_bits - 1) - 1 if self.signed else 2**self.total_bits - 1

    @property
    def min_value(self) -> float:
        return self.code_min * self.scale

    @property
    def max_value(self) -> float:
        return self.code_max * self.scale

    @property
    def num_planes(self) -> int:
        return self.total_bits

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """float -> integer code (round-to-nearest-even, saturating)."""
        c = torch.round(x / self.scale)
        return torch.clamp(c, self.code_min, self.code_max).to(torch.int32)

    def quantize_stochastic(
        self, x: torch.Tensor, generator: torch.Generator
    ) -> torch.Tensor:
        """Paper §Stochastic rounding: ``P(up) = frac(x / eps)``, with the
        uniform draws taken from ``generator`` (on its own device, then
        moved to ``x``'s)."""
        v = x / self.scale
        lo = torch.floor(v)
        u = torch.rand(
            x.shape, generator=generator, dtype=torch.float32, device=generator.device
        ).to(x.device)
        c = lo + (u < v - lo).to(lo.dtype)
        return torch.clamp(c, self.code_min, self.code_max).to(torch.int32)

    def dequantize(self, codes: torch.Tensor) -> torch.Tensor:
        return codes.to(torch.float32) * self.scale

    def fake_quant(self, x: torch.Tensor) -> torch.Tensor:
        """Quantize + dequantize with a straight-through gradient (QAT)."""
        y = self.dequantize(self.quantize(x))
        return x + (y - x).detach()

    def to_unsigned_bits(self, codes: torch.Tensor) -> torch.Tensor:
        """Two's-complement bit pattern of the code as a non-negative int."""
        codes = codes.to(torch.int32)
        if self.signed:
            return torch.where(codes < 0, codes + 2**self.total_bits, codes)
        return codes

    def bitplanes(self, codes: torch.Tensor) -> torch.Tensor:
        """Bits with a new leading axis of size ``num_planes``."""
        u = self.to_unsigned_bits(codes)
        planes = torch.arange(self.num_planes, dtype=torch.int32, device=u.device)
        return (u[None, ...] >> planes.reshape((-1,) + (1,) * u.ndim)) & 1

    def plane_scales(self) -> np.ndarray:
        """Per-plane multiplier; MSB is negative for signed formats."""
        s = (2.0 ** np.arange(self.num_planes)) * self.scale
        if self.signed:
            s[-1] = -s[-1]
        return s.astype(np.float64)


_F16_EXP_BITS = 5
_F16_MAN_BITS = 10
_F16_BIAS = 15


@dataclasses.dataclass(frozen=True)
class Float16Format:
    """binary16 LUT input format (see the reference for the paper's
    ``signed`` and ``mantissa_radix`` extensions)."""

    signed: bool = False
    mantissa_radix: int = 1

    def __post_init__(self):
        if not (1 <= self.mantissa_radix <= _F16_MAN_BITS + 1):
            raise ValueError(
                f"mantissa_radix must be in [1, {_F16_MAN_BITS + 1}], "
                f"got {self.mantissa_radix}"
            )

    @property
    def exp_bits(self) -> int:
        return _F16_EXP_BITS

    @property
    def num_planes(self) -> int:
        return -(-(_F16_MAN_BITS + 1) // self.mantissa_radix)

    @property
    def fields_per_element(self) -> int:
        return self.mantissa_radix + _F16_EXP_BITS + (1 if self.signed else 0)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """float -> binary16 (unsigned mode clamps negatives to 0)."""
        if self.signed:
            return x.to(torch.float16)
        # "+ 0.0" turns clamp's -0.0 into +0.0, as the reference's maximum
        return (torch.clamp(x, min=0.0) + 0.0).to(torch.float16)

    def fake_quant(self, x: torch.Tensor) -> torch.Tensor:
        y = self.quantize(x).to(torch.float32)
        return x + (y - x).detach()

    def dequantize(self, h: torch.Tensor) -> torch.Tensor:
        return h.to(torch.float32)

    @staticmethod
    def _bits(h: torch.Tensor) -> torch.Tensor:
        # int16 views are signed: widen, then mask back to the 16-bit pattern
        return h.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF

    def decompose(self, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(exponent, mantissa_planes)``: the 5-bit exponent field as int32
        with ``h``'s shape, and a leading axis of ``num_planes`` radix-bit
        slices of the 11-bit mantissa (implicit bit = 1 iff normal)."""
        r = self.mantissa_radix
        bits = self._bits(h)
        exp = (bits >> _F16_MAN_BITS) & (2**_F16_EXP_BITS - 1)
        man = bits & (2**_F16_MAN_BITS - 1)
        man = man | ((exp > 0).to(torch.int32) << _F16_MAN_BITS)
        shifts = r * torch.arange(self.num_planes, dtype=torch.int32, device=h.device)
        slices = (man[None, ...] >> shifts.reshape((-1,) + (1,) * man.ndim)) & (
            2**r - 1
        )
        return exp, slices

    @classmethod
    def sign_bits(cls, h: torch.Tensor) -> torch.Tensor:
        return (cls._bits(h) >> 15) & 1

    def plane_scales(self) -> np.ndarray:
        r = self.mantissa_radix
        return (2.0 ** (r * np.arange(self.num_planes))).astype(np.float64)


# ---------------------------------------------------------------------------
# Ternary weights and integer activations (the TL1 family)
# ---------------------------------------------------------------------------


def ternary_quantize(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absmean ternarisation: ``w ~= s * t`` with ``t`` in {-1, 0, +1}.

    ``t = clip(round(w / mean|w|), -1, 1)``, then the scale is refit in
    closed form over the chosen codes, ``s = <w, t> / <t, t>``, which makes
    the quantizer idempotent.  Returns ``t`` int8 of ``w``'s shape and
    ``s`` a 0-d float32 tensor (one per call: loop over leading dims for
    stacked weights).  ``mean|w|`` and the refit are float reductions whose
    order differs from the reference's, so ``s`` can differ in its last
    ulps and ``t`` only on elements exactly at a rounding boundary.
    """
    w = w.to(torch.float32)
    s0 = torch.clamp(w.abs().mean(), min=1e-12)
    t = torch.clamp(torch.round(w / s0), -1.0, 1.0)
    s = (w * t).sum() / torch.clamp((t * t).sum(), min=1.0)
    return t.to(torch.int8), s.to(torch.float32)


def ternary_fake_quant(w: torch.Tensor) -> torch.Tensor:
    """``s * t`` at ``w``'s dtype: the dense stand-in for a TL1 layer."""
    t, s = ternary_quantize(w)
    return (s * t.to(torch.float32)).to(w.dtype)


def absmax_int_quantize(
    x: torch.Tensor, bits: int = 8, axis: int = -1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric absmax quantization of activations.

    Returns ``(q, scale)``: ``q`` int32 codes in ``[-(2**(bits-1)-1),
    2**(bits-1)-1]`` (round half to even, as the reference) and ``scale``
    float32 shaped like ``x`` with ``axis`` kept at size 1, so that
    ``x ~= q * scale``.
    """
    qmax = float(2 ** (bits - 1) - 1)
    amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    return q, scale.to(torch.float32)


# ---------------------------------------------------------------------------
# Stochastic rounding as a LUT (paper §Stochastic rounding)
# ---------------------------------------------------------------------------


def build_stochastic_rounding_lut(
    fmt: FixedPointFormat, in_bits: int, R: int, seed: int = 0
) -> np.ndarray:
    """The paper's rounding LUT ``(R, 2**in_bits)`` int32, row = counter
    mod ``R``, column = the ``in_bits``-wide input code's bit pattern (same
    ``frac_bits`` and signedness as ``fmt``), mapped down to ``fmt``; the
    random sequence r(i) is fixed when the table is built.  Built by the
    reference's numpy calls in the reference's order, so the same ``seed``
    gives the same array.

    For a signed ``fmt`` a column's pattern is two's complement: negative
    codes floor toward -inf (an arithmetic shift), round up with the same
    ``P(up) = frac`` rule and saturate at ``fmt.code_min``."""
    if in_bits <= fmt.total_bits:
        raise ValueError("input format must be wider than the output format")
    rng = np.random.default_rng(seed)
    r = rng.uniform(size=R)
    shift = in_bits - fmt.total_bits
    codes = np.arange(2**in_bits, dtype=np.int64)
    if fmt.signed:
        codes = codes - (codes >= 2 ** (in_bits - 1)) * 2**in_bits
    lo = codes >> shift
    frac = (codes & (2**shift - 1)) / float(2**shift)
    # f(x, i) = floor(x) if r(i) <= 1 - frac else floor(x) + eps
    table = lo[None, :] + (r[:, None] > 1.0 - frac[None, :]).astype(np.int64)
    return np.clip(table, fmt.code_min, fmt.code_max).astype(np.int32)


def stochastic_round_via_lut(table, codes: torch.Tensor, step) -> torch.Tensor:
    """Apply the rounding LUT with a replayable counter (``step``, an int
    or an integer tensor): row ``step mod R``, column the code's
    two's-complement bit pattern (a negative code wraps modulo the table
    width), as :func:`build_stochastic_rounding_lut` lays the columns out.
    The result lies on ``codes``' device."""
    t = torch.as_tensor(table, device=codes.device)
    R, width = t.shape
    i = torch.as_tensor(step, dtype=torch.int64, device=codes.device) % R
    cols = torch.where(codes < 0, codes + width, codes).to(torch.int64)
    return t[i, cols]
