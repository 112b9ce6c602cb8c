"""Wrapper of the Hopper bitplane binary matmul (counterpart of
``repro/kernels/binary_matmul/ops.py``).

Contract kept from the reference: ``planes (..., n, q)`` {0, 1} bits with
leading batch dims, ``W (q, p)`` (fp32 or bf16, rounded to bf16 before the
product), fp32 output, bias added after the accumulate.  Ragged ``B*n``,
``q`` and ``p`` are masked in the kernel (TMA zero-fills W past q and p).

The kernel reads W and the planes through TMA tensor maps, which take a
bf16 W and int32 planes, each with a 16-byte aligned base and rows of a
multiple of 16 bytes: the serve path's bf16 weights
(``models/params.py::bf16_projections``) and the int32 planes
``bitplane_pack`` writes go in as they are, with no cast between the two
kernels; any other operand (an fp32 W, int8 planes, an odd ``p`` or ``q``,
an unaligned base) is copied once per call into such a buffer by
:func:`w_operand` / :func:`planes_operand` -- the kernel runs all the same,
never the plain version.  An fp32 W costs that copy on every call, so a
caller of the mode rounds its tree once with ``bf16_projections``.

Dispatch: a CUDA tensor with ``use_kernels=True`` launches the kernel in
``csrc/binary_matmul.cu`` or raises; a CPU tensor, or
``use_kernels=False`` (an explicit request for the plain version), runs
``ref.py``.  The launch count is :data:`LAUNCHES`, counted right where
the kernel launches.

``scales`` are host values, each ``+-2**e`` (the plane scales of a
bitplane plan are): they travel with the launch, so nothing is read back.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.binary_matmul.ref import binary_matmul_ref
from repro_torch.kernels.lut_affine.ops import host_scales, plane_shifts

LAUNCHES = {"binary_matmul": 0}

MAX_PLANES = 32
MAX_SPLITS = 16
# the kernel's depth per stage (one TMA box of W is 64 columns x 64 deep)
_TILE_K = 64
# the kernel's two block tiles: (folded rows, output columns, blocks per SM)
DECODE_TILE = (64, 128, 2)  # one consumer warpgroup, a 6-stage ring
PREFILL_TILE = (128, 256, 1)  # two consumer warpgroups, a 4-stage ring
_PLANE_DTYPES = (torch.int8, torch.int32)
_PLANES_INT32 = 1
_W_BF16 = 1


def _lib() -> ctypes.CDLL:
    lib = build.load("binary_matmul")
    if not getattr(lib, "_bound", False):
        # planes, w, out, k-split partials, scales (host), plane type, w
        # type, B, n, q, p, vec_a, vec_b, splits, stream
        lib.binary_matmul_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        )
        lib.binary_matmul_launch.restype = ctypes.c_int
        lib.binary_matmul_error_string.argtypes = [ctypes.c_int]
        lib.binary_matmul_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _fp32_scales(scales, n: int) -> np.ndarray:
    """Host plane scales as fp32 values, each ``+-2**e`` and exact in fp32
    (raises otherwise)."""
    vals = host_scales(scales)
    if len(vals) != n:
        raise ValueError(f"{len(vals)} scales for {n} planes")
    plane_shifts(vals)
    f32 = vals.astype(np.float32)
    if not np.array_equal(f32.astype(np.float64), vals):
        raise ValueError(f"plane scales {vals} are not exact in fp32")
    return f32


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def tile(B: int, n: int) -> tuple[int, int, int]:
    """The kernel's block tile for ``B`` batch rows of ``n`` planes:
    ``(folded rows, columns, blocks per SM)``.  A decode batch of at most
    64 folded rows takes :data:`DECODE_TILE`, anything larger
    :data:`PREFILL_TILE` (the rule of ``binary_matmul.cu::launch_tile``)."""
    return DECODE_TILE if B * n <= 64 else PREFILL_TILE


def k_splits(B: int, n: int, q: int, p: int, sms: int) -> int:
    """How many q ranges the launch cuts the work into: one wave of blocks
    that fills the card's block slots as far as whole multiples of the
    output tiles allow (a decode batch streams W from every SM; a second
    wave costs more than its share), at most ``MAX_SPLITS`` and the 64-deep
    steps; one when the output tiles alone fill the slots."""
    rows, cols, per_sm = tile(B, n)
    tiles = -(-B // (rows // n)) * -(-p // cols)
    steps = -(-q // _TILE_K)
    return max(1, min(MAX_SPLITS, steps, per_sm * sms // tiles))


def planes_operand(planes: torch.Tensor) -> torch.Tensor:
    """``planes (B, n, q)`` as the kernel's tensor map takes them: int32,
    contiguous, a 16-byte aligned base and ``q`` a multiple of 4.  Planes
    that are so already (``bitplane_pack``'s output at the served shapes)
    are returned as they are; any other (int8 planes, a ragged q, an
    unaligned base) are copied once into a new int32 buffer, their depth
    padded up to a multiple of 4 with zeros (:func:`w_operand` pads W's rows
    to match, so the padding adds nothing to a sum)."""
    B, n, q = planes.shape
    if (
        planes.dtype == torch.int32 and planes.is_contiguous() and q % 4 == 0
        and planes.data_ptr() % 16 == 0
    ):
        return planes
    pp = torch.zeros((B, n, q + (-q) % 4), dtype=torch.int32, device=planes.device)
    pp[..., :q] = planes
    return pp


def w_operand(W: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """W as the kernel's tensor map takes it: bf16, contiguous, a 16-byte
    aligned base and a row pitch of a multiple of 8 elements, with ``rows``
    rows (default: W's own q; more when the planes' depth was padded by
    :func:`planes_operand`).  A W that is so already is returned as it is;
    any other (an fp32 W, the rounding both packages apply before the
    product; an odd p; an unaligned base; rows past q) is copied once into a
    new bf16 buffer, its p padded up to a multiple of 8 and its rows up to
    ``rows`` with zeros; the extra columns give output columns the caller
    drops."""
    q, p = W.shape
    rows = q if rows is None else rows
    if rows < q:
        raise ValueError(f"W has {q} rows, more than the {rows} asked for")
    if (
        W.dtype == torch.bfloat16 and W.is_contiguous() and p % 8 == 0
        and W.data_ptr() % 16 == 0 and rows == q
    ):
        return W
    if p % 8 == 0 and rows == q:
        return W.to(torch.bfloat16, copy=True).contiguous()
    wp = torch.zeros((rows, p + (-p) % 8), dtype=torch.bfloat16, device=W.device)
    wp[:q, :p] = W
    return wp


def _launch(planes: torch.Tensor, W: torch.Tensor, scales: np.ndarray) -> torch.Tensor:
    """One launch on ``planes (B, n, q)`` and ``W (q, p)`` -> (B, p) fp32."""
    if planes.dtype not in _PLANE_DTYPES:
        raise TypeError(f"planes must be int8 or int32, got {planes.dtype}")
    if W.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"W must be fp32 or bf16, got {W.dtype}")
    if planes.device != W.device:
        raise ValueError(f"planes on {planes.device}, W on {W.device}")
    if not W.is_contiguous():
        raise ValueError("the kernel takes a contiguous W")
    if planes.shape[1] > MAX_PLANES:
        raise ValueError(f"the kernel takes at most {MAX_PLANES} planes")
    B, n, q = planes.shape
    p = W.shape[1]
    if B == 0 or p == 0:
        return torch.empty((B, p), dtype=torch.float32, device=planes.device)
    # the copies (if any) live until this function returns, after the
    # launch; the caching allocator orders any reuse on the stream
    Ak = planes_operand(planes)
    Wk = w_operand(W, Ak.shape[2])
    qk, pk = Wk.shape
    out = torch.empty((B, pk), dtype=torch.float32, device=planes.device)
    splits = k_splits(B, n, qk, pk, _sm_count(planes.device))
    part = (
        torch.empty((splits, B, pk), dtype=torch.float32, device=planes.device)
        if splits > 1 else None
    )
    lib = _lib()
    err = lib.binary_matmul_launch(
        Ak.data_ptr(), Wk.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        scales.ctypes.data,  # read by the host entry before it returns
        _PLANES_INT32, _W_BF16, B, n, qk, pk, 1, 1,
        splits, torch.cuda.current_stream(planes.device).cuda_stream,
    )
    if err != 0:
        msg = lib.binary_matmul_error_string(err).decode()
        raise RuntimeError(f"binary_matmul: kernel launch failed with error {err} ({msg})")
    LAUNCHES["binary_matmul"] += 1
    return out if pk == p else out[:, :p]


def binary_matmul(
    planes: torch.Tensor,  # (..., n, q) {0, 1} bitplanes
    W: torch.Tensor,  # (q, p)
    scales,  # (n,) host powers of two
    bias: torch.Tensor | None = None,  # (p,)
    *,
    use_kernels: bool = True,
) -> torch.Tensor:
    """``out[..., :] = sum_j scales[j] * planes[..., j, :] @ bf16(W) (+
    bias)`` in fp32."""
    *lead, n, q = planes.shape
    q2, p = W.shape
    if q != q2:
        raise ValueError(f"planes have depth {q}, W {q2}")
    vals = _fp32_scales(scales, n)
    planes2 = planes.reshape(-1, n, q)
    if use_kernels and planes2.is_cuda:
        out = _launch(planes2, W, vals)
    else:
        out = binary_matmul_ref(planes2, W, torch.from_numpy(vals).to(W.device))
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.reshape(*lead, p)
