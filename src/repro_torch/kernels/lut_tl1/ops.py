"""Wrappers of the Hopper TL1 kernels (counterpart of
``repro/kernels/lut_tl1/ops.py``).

Contract kept from the reference: ``acts`` is the flat padded code vector
``core.lut_tl1.quantize_acts`` makes (``(..., 4*kb)``, int32 codes or
float32 on the exact path), leading batch dims, ragged ``q`` and ``p``,
the plan's accumulator contract checked before every launch, and the
dequant (activation scale, then the ternary ``scale``, then ``bias``)
applied with torch ops after the integer accumulate, in the reference's
order.

Dispatch: a CUDA tensor with ``use_kernels=True`` launches the kernel in
``csrc/lut_tl1.cu`` or raises; a CPU tensor, or ``use_kernels=False`` (an
explicit request for the plain version, made by the tests and the
comparison phases of ``chip_smoke.py``), runs ``ref.py``.  Each wrapper
counts its launches in :data:`LAUNCHES`, right where it launches, and
reports each to the audit's recorder when one is active
(``kernels/common.py::RECORDER``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, common
from repro_torch.kernels.common import check_acc_contract
from repro_torch.kernels.lut_tl1.ref import lut_tl1_grouped_ref, lut_tl1_ref

LAUNCHES = {"lut_tl1": 0, "lut_tl1_grouped": 0}

MAX_SPLITS = 96
# packed rows a split keeps at least (its share of the LUT build and of the
# second pass's partials grows as its rows shrink)
_MIN_SPLIT_ROWS = 16
# the kernel's output tile: tile_rows(B) batch rows x 1024 columns per block
# (8 warps of 128 columns each)
TILE_COLS = 1024
# blocks the kernel keeps on an SM (64 KB of staged LUTs each)
BLOCKS_PER_SM = 3
# folded entries (one per packed byte: two pair-LUT values) stored as
# uint16 biased by +512, two tokens to a 32-bit add: every |entry| <= 511
_BIASED_MAX = 511
# entry formats of the C entries
ENTRY_CODES = {"int32": 0, "float32": 1, "int16": 2}
_ARGS = (
    [ctypes.c_void_p] * 4  # acts, tables, out, k-split partials
    + [ctypes.c_int] * 7  # entry format, B, kb, p, tile_rows, vec, splits
    + [ctypes.c_void_p]  # stream
)


def _lib() -> ctypes.CDLL:
    lib = build.load("lut_tl1")
    if not getattr(lib, "_bound", False):
        lib.lut_tl1_launch.argtypes = _ARGS
        lib.lut_tl1_grouped_launch.argtypes = _ARGS[:4] + [ctypes.c_int] + _ARGS[4:]
        lib.lut_tl1_launch.restype = ctypes.c_int
        lib.lut_tl1_grouped_launch.restype = ctypes.c_int
        lib.lut_tl1_error_string.argtypes = [ctypes.c_int]
        lib.lut_tl1_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def tile_rows(B: int) -> int:
    """Batch rows per block: 4 for a decode batch, else 8."""
    return 4 if B <= 4 else 8


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k_splits(G: int, B: int, kb: int, p: int, sms: int, blocks=None) -> int:
    """How many packed-row ranges the launch cuts the work into.  From a
    plan's tuned ``blocks`` when the dispatch fits one row tile of the
    kernel they name (``block_b == tile_rows(B)`` and ``B <= block_b``):
    ``ceil(kb / block_k)``.  Else, and with no ``blocks``, the shape rule:
    one wave of blocks that fills the card's block slots as far as whole
    multiples of the output tiles allow (a decode batch), at most
    ``MAX_SPLITS`` and with at least ``_MIN_SPLIT_ROWS`` packed rows each;
    one when the output tiles alone fill the slots.  Tiles tuned at a
    decode batch (4 or 8 rows) thus never govern a prefill."""
    if blocks is not None and blocks[0] == tile_rows(B) and B <= blocks[0]:
        return -(-kb // blocks[2])
    tiles = G * -(-B // tile_rows(B)) * -(-p // TILE_COLS)
    return max(1, min(MAX_SPLITS, kb // _MIN_SPLIT_ROWS, BLOCKS_PER_SM * sms // tiles))


# legality verdicts of the tiles a wrapper was given: (B, G, kb, p, blocks) -> bool
LEGAL_BLOCKS: dict = {}


def check_blocks(op: str, B: int, G: int, kb: int, p: int, blocks) -> None:
    """Refuse an illegal tiling, from the shapes alone (the same on the
    kernel path and the plain path): ``ValueError`` naming the tiling and
    the point (``lut_affine.autotune.check_blocks``).  Each verdict is kept
    in :data:`LEGAL_BLOCKS`, so a served step pays a lookup."""
    if blocks is None:
        return
    key = (B, G, kb, p, tuple(blocks))
    if LEGAL_BLOCKS.get(key):
        return
    from repro_torch.kernels.lut_affine import autotune

    pt = autotune.TunePoint(B=B, k=kb, entries=9, p=p, n=1, G=G, table_bytes=1,
                            family="tl1")
    autotune.check_blocks(op, pt, blocks)
    LEGAL_BLOCKS[key] = True


def entry_format(plan, is_float: bool) -> str:
    """How the kernel stores a folded entry (the sum of two pair-LUT values,
    bounded by ``4 * qa`` in code units), decided from the plan alone,
    never from the codes: ``"float32"`` on the exact path; ``"int16"``
    (biased by +512, two tokens per 32-bit add) where the plan's
    ``act_bits`` prove ``4 * qa <= 511``, as every TL1 plan's do
    (``act_bits <= 8``); else ``"int32"`` (no plan, or a plan without
    ``act_bits``)."""
    if is_float:
        return "float32"
    bits = getattr(plan, "act_bits", None)
    if bits is not None and 4 * (2 ** (int(bits) - 1) - 1) <= _BIASED_MAX:
        return "int16"
    return "int32"


def _acc_dtype(acts: torch.Tensor) -> torch.dtype:
    if acts.dtype == torch.int32:
        return torch.int32
    if acts.dtype == torch.float32:
        return torch.float32
    raise TypeError(f"acts must be int32 codes or float32, got {acts.dtype}")


def _launch(entry: str, acts: torch.Tensor, tables: torch.Tensor, plan=None,
            blocks=None) -> torch.Tensor:
    """One launch of ``entry`` on ``acts (B, 4*kb)`` and ``tables (G, kb,
    p)``, its entry width from ``plan`` (:func:`entry_format`), its k splits
    from ``blocks`` or the shape rule (:func:`k_splits`); returns the raw
    accumulate ``(G, B, p)``."""
    if tables.dtype != torch.uint8:
        raise TypeError(f"tables must be uint8 packed indices, got {tables.dtype}")
    if acts.device != tables.device:
        raise ValueError(f"acts on {acts.device}, tables on {tables.device}")
    if not tables.is_contiguous():
        raise ValueError("the kernels take contiguous tables")
    acts = acts.contiguous()
    acc = _acc_dtype(acts)
    B = acts.shape[0]
    G, kb, p = tables.shape
    splits = k_splits(G, B, kb, p, _sm_count(acts.device), blocks)
    out = torch.empty((G, B, p), dtype=acc, device=acts.device)
    # the partials live until this function returns, after the launch; the
    # caching allocator orders any reuse on the stream
    part = (
        torch.empty((splits, G, B, p), dtype=acc, device=acts.device)
        if splits > 1 else None
    )
    vec = int(p % 4 == 0 and tables.data_ptr() % 4 == 0)
    args = [
        acts.data_ptr(),
        tables.data_ptr(),
        out.data_ptr(),
        part.data_ptr() if part is not None else None,
    ]
    if entry == "lut_tl1_grouped":
        args.append(G)
    fmt = entry_format(plan, acc == torch.float32)
    args += [ENTRY_CODES[fmt], B, kb, p, tile_rows(B), vec, splits]
    stream = torch.cuda.current_stream(acts.device).cuda_stream
    lib = _lib()
    err = getattr(lib, f"{entry}_launch")(*args, stream)
    if err != 0:
        msg = lib.lut_tl1_error_string(err).decode()
        raise RuntimeError(
            f"{entry}: kernel launch failed with CUDA error {err} ({msg})"
        )
    LAUNCHES[entry] += 1
    if common.RECORDER is not None:
        common.RECORDER(entry, (acts, tables), (out,))
    return out


def _dequant(out, act_scale, scale, bias):
    out = out.to(torch.float32)
    if act_scale is not None:
        out = out * act_scale
    if scale is not None:
        out = out * scale
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _flat(acts: torch.Tensor, kb: int):
    *lead, q4 = acts.shape
    if q4 != 4 * kb:
        raise ValueError(f"acts width {q4} != 4 * {kb} packed rows")
    return acts.reshape(-1, q4), lead


def lut_tl1(
    acts: torch.Tensor,  # (..., 4*kb) int32 codes (float32: exact path)
    tables: torch.Tensor,  # (kb, p) uint8 packed base-3 indices
    act_scale: torch.Tensor | None = None,  # (..., 1) per-token scale
    scale: torch.Tensor | None = None,  # ternary weight scale
    bias: torch.Tensor | None = None,  # (p,)
    *,
    plan=None,
    blocks=None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """``out[..., :] = act_scale * scale * sum_c lut[c, widx[c, :]] + bias``
    in float32.  ``blocks``: a plan's tuned tiling (``lut_affine.autotune``);
    it sets the k splits of a dispatch that fits one row tile of the kernel
    it names (:func:`k_splits`), the shape rule sets every other's, and an
    illegal one raises ``ValueError`` on either path."""
    if plan is not None:
        check_acc_contract(
            "lut_tl1", plan, "float32" if acts.is_floating_point() else "int32"
        )
    kb, p = tables.shape
    acts2, lead = _flat(acts, kb)
    check_blocks("lut_tl1", acts2.shape[0], 1, kb, p, blocks)
    if use_kernels and acts2.is_cuda:
        out = _launch("lut_tl1", acts2, tables[None], plan, blocks)[0]
    else:
        out = lut_tl1_ref(acts2, tables)
    out = out.reshape(*lead, p)
    if act_scale is not None:
        act_scale = act_scale.reshape(*lead, 1)
    return _dequant(out, act_scale, scale, bias)


def lut_tl1_grouped(
    acts: torch.Tensor,  # (..., 4*kb), one quantized input for the group
    tables: torch.Tensor,  # (G, kb, p) uint8, the LUTGroup leaf as stored
    act_scale: torch.Tensor | None = None,  # (..., 1)
    scale: torch.Tensor | None = None,  # (G,) per-member ternary scales
    biases: torch.Tensor | None = None,  # (G, p)
    *,
    plan=None,
    blocks=None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """``out[g] = lut_tl1(acts, tables[g], act_scale, scale[g]) (+
    biases[g])`` for all ``G`` projections in one launch -> ``(G, ..., p)``.
    ``blocks`` as :func:`lut_tl1`'s."""
    if plan is not None:
        check_acc_contract(
            "lut_tl1_grouped", plan, "float32" if acts.is_floating_point() else "int32"
        )
    G, kb, p = tables.shape
    acts2, lead = _flat(acts, kb)
    check_blocks("lut_tl1_grouped", acts2.shape[0], G, kb, p, blocks)
    if use_kernels and acts2.is_cuda:
        out = _launch("lut_tl1_grouped", acts2, tables, plan, blocks)
    else:
        out = lut_tl1_grouped_ref(acts2, tables)
    out = out.reshape(G, *lead, p)
    if act_scale is not None:
        act_scale = act_scale.reshape(*lead, 1)
    if scale is not None:
        scale = scale.reshape(G, *([1] * (out.ndim - 1)))
    if biases is not None:
        biases = biases.reshape(G, *([1] * (out.ndim - 2)), p)
    return _dequant(out, act_scale, scale, biases)
