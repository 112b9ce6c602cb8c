"""Wrapper of the Hopper bitplane binary matmul (counterpart of
``repro/kernels/binary_matmul/ops.py``).

Contract kept from the reference: ``planes (..., n, q)`` {0, 1} bits with
leading batch dims, ``W (q, p)`` (fp32 or bf16, rounded to bf16 by the
kernel), fp32 output, bias added after the accumulate.  Ragged ``B*n``,
``q`` and ``p`` are masked in the kernel, not padded on the host.

Dispatch: a CUDA tensor with ``use_kernels=True`` launches the kernel in
``csrc/binary_matmul.cu`` or raises; a CPU tensor, or
``use_kernels=False`` (an explicit request for the plain version), runs
``ref.py``.  The launch count is :data:`LAUNCHES`, counted right where
the kernel launches.

``scales`` are host values, each ``+-2**e`` (the plane scales of a
bitplane plan are): they travel with the launch, so nothing is read back.
The planes may be int8 or the int32 codes ``bitplane_pack`` writes; the
kernel reads either, so no cast runs between the two kernels.
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
# the kernel's block tile: 64 folded (batch row, plane) rows x 64 output
# columns, walking q 32 deep at a time
_TILE_ROWS, _TILE_COLS, _TILE_K = 64, 64, 32
_PLANE_CODE = {torch.int8: 0, torch.int32: 1}
_W_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def k_splits(B: int, n: int, q: int, p: int, sms: int) -> int:
    """How many q ranges the launch cuts the work into: enough blocks for
    about four per SM when the output tiles alone are fewer (a decode
    batch), at most ``MAX_SPLITS`` and never more than the 32-deep steps."""
    tiles = -(-B // (_TILE_ROWS // n)) * -(-p // _TILE_COLS)
    return max(1, min(MAX_SPLITS, -(-q // _TILE_K), -(-4 * sms // tiles)))


def _launch(planes: torch.Tensor, W: torch.Tensor, scales: np.ndarray) -> torch.Tensor:
    """One launch on ``planes (B, n, q)`` and ``W (q, p)`` -> (B, p) fp32."""
    if planes.dtype not in _PLANE_CODE:
        raise TypeError(f"planes must be int8 or int32, got {planes.dtype}")
    if W.dtype not in _W_CODE:
        raise TypeError(f"W must be fp32 or bf16, got {W.dtype}")
    if planes.device != W.device:
        raise ValueError(f"planes on {planes.device}, W on {W.device}")
    if not W.is_contiguous():
        raise ValueError("the kernel takes a contiguous W")
    if planes.shape[1] > MAX_PLANES:
        raise ValueError(f"the kernel takes at most {MAX_PLANES} planes")
    planes = planes.contiguous()
    B, n, q = planes.shape
    p = W.shape[1]
    out = torch.empty((B, p), dtype=torch.float32, device=planes.device)
    if B == 0 or p == 0:
        return out
    splits = k_splits(B, n, q, p, _sm_count(planes.device))
    # the partials live until this function returns, after the launch; the
    # caching allocator orders any reuse on the stream
    part = (
        torch.empty((splits, B, p), dtype=torch.float32, device=planes.device)
        if splits > 1 else None
    )
    va = 16 // planes.element_size()
    vb = 16 // W.element_size()
    vec_a = q % va == 0 and planes.data_ptr() % 16 == 0
    vec_b = p % vb == 0 and W.data_ptr() % 16 == 0
    lib = _lib()
    err = lib.binary_matmul_launch(
        planes.data_ptr(), W.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        scales.ctypes.data,  # read by the host entry before it returns
        _PLANE_CODE[planes.dtype], _W_CODE[W.dtype], B, n, q, p, int(vec_a), int(vec_b),
        splits, torch.cuda.current_stream(planes.device).cuda_stream,
    )
    if err != 0:
        msg = lib.binary_matmul_error_string(err).decode()
        raise RuntimeError(f"binary_matmul: kernel launch failed with CUDA error {err} ({msg})")
    LAUNCHES["binary_matmul"] += 1
    return out


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
