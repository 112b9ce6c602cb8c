"""Wrapper of the Hopper packing kernel (counterpart of
``repro/kernels/bitplane_pack/ops.py``).

Contract kept from the reference: ``(..., q)`` -> ``(..., n, ceil(q/m))``
int32 codes, leading dims flattened, and ``q`` zero-padded to ``k*m``
(the kernel masks the elements past ``q``, which packs exactly what zero
padding packs, so nothing is copied on the host).

Dispatch: a CUDA tensor with ``use_kernels=True`` launches the kernel in
``csrc/bitplane_pack.cu`` or raises; a CPU tensor, or ``use_kernels=False``
(an explicit request for the plain version), runs ``ref.py``.  The launch
count is :data:`LAUNCHES`, counted right where the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitplane_pack.ref import bitplane_pack_ref, pack_plan

LAUNCHES = {"bitplane_pack": 0}

_KIND_CODE = {"fixed": 0, "float16": 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("bitplane_pack")
    if not getattr(lib, "_bound", False):
        # x, out, kind, B, q, m, bits, frac, signed, stream
        lib.bitplane_pack_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        lib.bitplane_pack_launch.restype = ctypes.c_int
        lib.bitplane_pack_error_string.argtypes = [ctypes.c_int]
        lib.bitplane_pack_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def bitplane_pack(
    x: torch.Tensor,  # (..., q)
    *,
    kind: str,  # "fixed" | "float16"
    m: int,
    bits: int = 16,
    frac: int = 0,
    signed: bool = False,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Quantize ``x`` and emit its bitplane LUT indices ``(..., n, k)``:
    fixed point with ``n = bits`` planes of ``m``-bit chunk indices, or
    unsigned fp16 with ``n = 11`` planes of 6-bit fields per element."""
    *lead, q = x.shape
    plan = pack_plan(q, kind=kind, bits=bits, frac=frac, signed=signed, m=m)
    n, k = plan.num_planes, plan.num_chunks
    x2 = x.reshape(-1, q)
    if not (use_kernels and x2.is_cuda):
        out = bitplane_pack_ref(x2, kind=kind, bits=bits, frac=frac, signed=signed, m=m)
        return out.reshape(*lead, n, k)
    if x2.dtype != torch.float32:
        raise TypeError(f"the packing kernel takes fp32 input, got {x2.dtype}")
    x2 = x2.contiguous()
    B = x2.shape[0]
    out = torch.empty((B, n, k), dtype=torch.int32, device=x2.device)
    if B and q:
        lib = _lib()
        err = lib.bitplane_pack_launch(
            x2.data_ptr(), out.data_ptr(), _KIND_CODE[kind], B, q, m, bits, frac,
            int(signed), torch.cuda.current_stream(x2.device).cuda_stream,
        )
        if err != 0:
            msg = lib.bitplane_pack_error_string(err).decode()
            raise RuntimeError(
                f"bitplane_pack: kernel launch failed with CUDA error {err} ({msg})"
            )
        LAUNCHES["bitplane_pack"] += 1
    return out.reshape(*lead, n, k)
