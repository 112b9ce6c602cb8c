"""Wrappers of the Hopper LUT affine kernels (counterpart of
``repro/kernels/lut_affine/ops.py``).

Contract kept from the reference: leading batch dims, bias added after
the accumulate, and the plan's accumulator contract checked first.

Dispatch: a CUDA tensor with ``use_kernels=True`` launches the kernel in
``csrc/lut_affine.cu`` or raises; a CPU tensor, or ``use_kernels=False``
(an explicit request for the plain version, made by the tests and the
comparison phase of ``chip_smoke.py``), runs ``ref.py``.  Each wrapper
counts its launches in :data:`LAUNCHES`, right where it launches.

``scales`` are host values (a sequence, numpy array or CPU tensor): the
kernels take each plane scale as an integer exponent and a sign, passed
with the launch, so they must be powers of two -- every plane scale and
narrow-table dequant scale the planner produces is one.

The dense entries pick their kernel and grid from the shapes alone
(:func:`tiling`): a decode batch, whose chunk codes touch few table rows,
runs the kernel that reads only those rows, each as whole lines; anything
larger the kernel that brings whole chunk tiles into shared memory; k is
split into enough ranges for one wave of blocks.  The ragged entry runs one
kernel at every shape, on blocks of 4 expert-sorted rows whatever their
experts (:func:`experts_tiling`).  The kernels read tables whose base is
16-byte aligned and whose rows are a multiple of 16 bytes; any other table
is first copied into such a buffer (:func:`table_operand`), counted in
:data:`TABLE_COPIES` (a 10-column fp32 head, 40-byte rows, takes it on
every call).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_acc_contract
from repro_torch.kernels.lut_affine.ref import (
    EXPERT_ROWS,
    lut_affine_experts_ref,
    lut_affine_grouped_ref,
    lut_affine_ref,
)

LAUNCHES = {"lut_affine": 0, "lut_affine_grouped": 0, "lut_affine_experts": 0}
# tables copied by table_operand before a launch
TABLE_COPIES = {"table_operand": 0}

MAX_PLANES = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int16: 3}
# the dense kernels' tiles (csrc/lut_affine.cu): every block owns a 512-byte
# slab of each table row; a decode block up to 4 batch rows (4 * n <= 32
# references a chunk), a prefill block 64, and only tables of E <= 64 rows
# a chunk take the prefill kernel (a chunk's E x 512-byte tile is one stage)
SLAB_BYTES = 512
DECODE_ROWS, DECODE_REFS = 4, 32
PREFILL_ROWS, PREFILL_MAX_E = 64, 64
ROW_ALIGN = 16  # bytes: table base and row pitch
REGIMES = ("decode", "prefill")
_HEAD = (
    [ctypes.c_void_p] * 4  # codes, tables, out, k-split partials
    + [ctypes.c_void_p, ctypes.c_uint]  # plane exponents (host), sign mask
    + [ctypes.c_int]  # dtype code
)
_DIMS = [ctypes.c_int] * 9  # B, n, k, E, p, ldt, shift_bits, regime, splits


def host_scales(scales) -> np.ndarray:
    """``scales`` as a host float64 vector (refuses device tensors: reading
    one back would stall the stream every call)."""
    if isinstance(scales, torch.Tensor):
        if scales.device.type != "cpu":
            raise ValueError("lut_affine scales must be host values, not on a device")
        scales = scales.numpy()
    return np.asarray(scales, np.float64).reshape(-1)


def plane_shifts(scales) -> tuple[list[int], int]:
    """Host plane scales -> (exponents, negative-sign bit mask), so that
    ``scales[j] == (-1 if mask >> j & 1 else 1) * 2**exps[j]``.  Raises
    unless every scale is +-2**e."""
    vals = host_scales(scales)
    if not 1 <= len(vals) <= MAX_PLANES:
        raise ValueError(f"the kernels take 1..{MAX_PLANES} planes, got {len(vals)}")
    exps, neg = [], 0
    for j, s in enumerate(vals):
        mant, e = math.frexp(abs(float(s)))
        if not math.isfinite(s) or mant != 0.5:
            raise ValueError(
                f"plane scale {j} = {s!r} is not +-2**e: the kernels apply "
                "scales as exponent shifts"
            )
        exps.append(e - 1)
        if s < 0:
            neg |= 1 << j
    return exps, neg


def _lib() -> ctypes.CDLL:
    lib = build.load("lut_affine")
    if not getattr(lib, "_bound", False):
        lib.lut_affine_launch.argtypes = _HEAD + _DIMS + [ctypes.c_void_p]
        lib.lut_affine_grouped_launch.argtypes = (
            _HEAD + [ctypes.c_int] + _DIMS + [ctypes.c_void_p]
        )
        # codes, tables, offsets, out, k-split partials, plane exponents,
        # sign mask, dtype, experts, G, T, n, k, En, p, ldt, shift_bits,
        # splits, stream
        lib.lut_affine_experts_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_uint] + [ctypes.c_int] * 11
            + [ctypes.c_void_p]
        )
        lib.lut_affine_launch.restype = ctypes.c_int
        lib.lut_affine_grouped_launch.restype = ctypes.c_int
        lib.lut_affine_experts_launch.restype = ctypes.c_int
        lib.lut_affine_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.lut_affine_smem_bytes.restype = ctypes.c_int
        lib.lut_affine_error_string.argtypes = [ctypes.c_int]
        lib.lut_affine_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _check_operands(codes: torch.Tensor, tables: torch.Tensor, shift_bits: int):
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32, got {codes.dtype}")
    if tables.dtype not in _DTYPE_CODE:
        raise TypeError(f"tables must be f32/bf16/i8/i16, got {tables.dtype}")
    if codes.device != tables.device:
        raise ValueError(f"codes on {codes.device}, tables on {tables.device}")
    if not (codes.is_contiguous() and tables.is_contiguous()):
        raise ValueError("the kernels take contiguous codes and tables")
    E = tables.shape[-2]
    if shift_bits and E & (E - 1):
        raise ValueError(f"shift_bits needs a power-of-two entry count, got {E}")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclasses.dataclass(frozen=True)
class Tiling:
    """One launch's kernel and grid (see :func:`tiling`, :func:`experts_tiling`)."""

    regime: str  # "decode" or "prefill" (dense), "experts" (ragged)
    rows: int  # batch rows per block
    slabs: int  # 512-byte column slabs per table row
    tiles: int  # output tiles: G x batch tiles x slabs
    splits: int  # k ranges, each its own blocks


# blocks an SM holds at once; at decode two measured fastest on an H100 (one
# 18 % slower, three even, four more than one wave)
BLOCKS_PER_SM = {"decode": 2, "prefill": 1}


def tiling(G: int, B: int, n: int, k: int, E: int, row_bytes: int, sms: int) -> Tiling:
    """The dense kernels' grid, from the shapes alone.  Decode when a
    chunk's ``B * n`` codes are fewer than its ``E`` rows (or its tile would
    not fit a stage), prefill otherwise.  ``splits`` cuts k into as many
    ranges as one wave of blocks holds beside the output tiles (never more
    blocks than ``BLOCKS_PER_SM`` per SM, never more ranges than chunks)."""
    regime = "prefill" if B * n >= E and E <= PREFILL_MAX_E else "decode"
    rows = PREFILL_ROWS if regime == "prefill" else min(DECODE_ROWS, DECODE_REFS // n)
    slabs = -(-row_bytes // SLAB_BYTES)
    tiles = G * -(-B // rows) * slabs
    slots = BLOCKS_PER_SM[regime] * sms
    return Tiling(regime, rows, slabs, tiles, max(1, min(k, slots // tiles)))


def experts_tiling(G: int, T: int, k: int, row_bytes: int, sms: int) -> Tiling:
    """The ragged kernel's grid, from the shapes alone: blocks of
    ``EXPERT_ROWS`` consecutive expert-sorted rows, whatever their experts,
    x a 512-byte slab x one table set, with k cut as at decode into as many
    ranges as one wave of ``BLOCKS_PER_SM["decode"]`` blocks per SM holds
    beside the output tiles (never more ranges than chunks)."""
    slabs = -(-row_bytes // SLAB_BYTES)
    tiles = G * -(-T // EXPERT_ROWS) * slabs
    slots = BLOCKS_PER_SM["decode"] * sms
    return Tiling("experts", EXPERT_ROWS, slabs, tiles, max(1, min(k, slots // tiles)))


def table_operand(tables: torch.Tensor) -> torch.Tensor:
    """``tables`` as the dense kernels read them: a 16-byte aligned base and
    rows of a multiple of 16 bytes.  Other tables (a view at an odd offset,
    ``p * itemsize % 16 != 0``) are copied into a fresh buffer with their
    rows zero-padded: one extra pass over the tables, every call."""
    vec = ROW_ALIGN // tables.element_size()
    p = tables.shape[-1]
    pad = -p % vec
    if tables.data_ptr() % ROW_ALIGN == 0 and not pad:
        return tables
    TABLE_COPIES["table_operand"] += 1
    return torch.nn.functional.pad(tables, (0, pad)) if pad else tables.clone()


def _operands(codes, tables, scales, shift_bits):
    """Shared launch arguments: (out, the buffers the launch reads that the
    caller must hold until it has launched, ctypes args before the dims,
    dims).  The caching allocator orders any later reuse on the stream."""
    _check_operands(codes, tables, shift_bits)
    B, n, k = codes.shape
    G, _, E, p = tables.shape
    exps, neg = plane_shifts(scales)
    if len(exps) != n:
        raise ValueError(f"{len(exps)} scales for {n} planes")
    tables = table_operand(tables)
    ldt = tables.shape[-1]
    t = tiling(G, B, n, k, E, ldt * tables.element_size(), _sm_count(codes.device))
    out = torch.empty((G, B, p), dtype=torch.float32, device=codes.device)
    part = None
    if t.splits > 1:
        part = torch.empty((t.splits, G, B, p), dtype=torch.float32, device=codes.device)
    head = (
        codes.data_ptr(),
        tables.data_ptr(),
        out.data_ptr(),
        part.data_ptr() if part is not None else None,
        (ctypes.c_int * n)(*exps),  # read by the host entry before it returns
        neg,
        _DTYPE_CODE[tables.dtype],
    )
    dims = (B, n, k, E, p, ldt, shift_bits, REGIMES.index(t.regime), t.splits)
    return out, (tables, part), head, dims


def _raise_on(err: int, op: str):
    if err != 0:
        msg = _lib().lut_affine_error_string(err).decode()
        raise RuntimeError(f"{op}: kernel launch failed with CUDA error {err} ({msg})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def lut_affine(
    codes: torch.Tensor,  # (..., n, k) int32
    tables: torch.Tensor,  # (k, E, p)
    scales,  # (n,) host powers of two
    bias: torch.Tensor | None = None,
    *,
    shift_bits: int = 0,
    plan=None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """``out[..., :] = sum_j scales[j] * sum_c tables[c, idx, :] (+ bias)``
    in fp32, ``idx`` per the ``shift_bits`` code contract."""
    if plan is not None:
        check_acc_contract("lut_affine", plan, "float32")
    *lead, n, k = codes.shape
    k2, E, p = tables.shape
    if k != k2:
        raise ValueError(f"codes have {k} chunks, tables {k2}")
    codes2 = codes.reshape(-1, n, k)
    if use_kernels and codes2.is_cuda:
        out, held, head, dims = _operands(
            codes2.contiguous(), tables[None], scales, shift_bits
        )
        err = _lib().lut_affine_launch(*head, *dims, _stream(codes2))
        _raise_on(err, "lut_affine")
        LAUNCHES["lut_affine"] += 1
        out = out[0]
    else:
        s = torch.tensor(host_scales(scales), dtype=torch.float32, device=tables.device)
        out = lut_affine_ref(codes2, tables, s, shift_bits)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.reshape(*lead, p)


def lut_affine_grouped(
    codes: torch.Tensor,  # (..., n, k) int32, one packed input for the group
    tables: torch.Tensor,  # (G, k, E, p), the LUTGroup leaf as stored
    scales,  # (n,) host powers of two
    biases: torch.Tensor | None = None,  # (G, p)
    *,
    shift_bits: int = 0,
    plan=None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """``out[g] = lut_affine(codes, tables[g], scales) (+ biases[g])`` for
    all ``G`` projections in one launch -> ``(G, ..., p)``."""
    if plan is not None:
        check_acc_contract("lut_affine_grouped", plan, "float32")
    *lead, n, k = codes.shape
    G, k2, E, p = tables.shape
    if k != k2:
        raise ValueError(f"codes have {k} chunks, tables {k2}")
    codes2 = codes.reshape(-1, n, k)
    if use_kernels and codes2.is_cuda:
        codes2 = codes2.contiguous()
        out, held, head, dims = _operands(codes2, tables, scales, shift_bits)
        err = _lib().lut_affine_grouped_launch(*head, G, *dims, _stream(codes2))
        _raise_on(err, "lut_affine_grouped")
        LAUNCHES["lut_affine_grouped"] += 1
    else:
        s = torch.tensor(host_scales(scales), dtype=torch.float32, device=tables.device)
        out = lut_affine_grouped_ref(codes2, tables, s, shift_bits)
    if biases is not None:
        out = out + biases[:, None, :].to(torch.float32)
    return out.reshape(G, *lead, p)


def lut_affine_experts(
    codes: torch.Tensor,  # (T, n, k) int32, rows sorted by expert
    tables: torch.Tensor,  # (E, G, k, En, p), the expert LUTGroup leaf as stored
    scales,  # (n,) host powers of two
    group_sizes: torch.Tensor,  # (E,) rows per expert, on the codes' device
    *,
    shift_bits: int = 0,
    plan=None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Ragged MoE form -> ``(G, T, p)`` fp32: row ``t`` against its expert's
    ``tables[e(t)]`` for all ``G`` projections in one launch; rows past
    ``sum(group_sizes)`` give 0.  The expert offsets are a cumulative sum
    on the device, so nothing is read back."""
    if plan is not None:
        check_acc_contract("lut_affine_experts", plan, "float32")
    T, n, k = codes.shape
    E, G, k2, En, p = tables.shape
    if k != k2:
        raise ValueError(f"codes have {k} chunks, tables {k2}")
    if tuple(group_sizes.shape) != (E,):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} for {E} experts")
    if not (use_kernels and codes.is_cuda):
        s = torch.tensor(host_scales(scales), dtype=torch.float32, device=tables.device)
        return lut_affine_experts_ref(codes, tables, s, group_sizes, shift_bits)
    codes = codes.contiguous()
    _check_operands(codes, tables, shift_bits)
    if group_sizes.device != codes.device:
        raise ValueError(
            f"group_sizes on {group_sizes.device}, codes on {codes.device}"
        )
    exps, neg = plane_shifts(scales)
    if len(exps) != n:
        raise ValueError(f"{len(exps)} scales for {n} planes")
    out = torch.empty((G, T, p), dtype=torch.float32, device=codes.device)
    if T == 0:
        return out
    tables = table_operand(tables)
    ldt = tables.shape[-1]
    t = experts_tiling(G, T, k, ldt * tables.element_size(), _sm_count(codes.device))
    part = None
    if t.splits > 1:
        part = torch.empty((t.splits, G, T, p), dtype=torch.float32, device=codes.device)
    offsets = torch.zeros(E + 1, dtype=torch.int32, device=codes.device)
    torch.cumsum(group_sizes, 0, dtype=torch.int32, out=offsets[1:])
    err = _lib().lut_affine_experts_launch(
        codes.data_ptr(), tables.data_ptr(), offsets.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        (ctypes.c_int * n)(*exps), neg, _DTYPE_CODE[tables.dtype],
        E, G, T, n, k, En, p, ldt, shift_bits, t.splits, _stream(codes),
    )
    _raise_on(err, "lut_affine_experts")
    LAUNCHES["lut_affine_experts"] += 1
    return out
