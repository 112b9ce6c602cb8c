"""Wrapper of the Hopper packing kernel (counterpart of
``repro/kernels/bitplane_pack/ops.py``).

Contract kept from the reference: ``(..., q)`` -> ``(..., n, ceil(q/m))``
int32 codes, leading dims flattened, and ``q`` zero-padded to ``k*m``
(the kernel masks the elements past ``q``, which packs exactly what zero
padding packs, so nothing is copied on the host).  The input is fp32 or
bf16, as the caller holds it; a bf16 input is widened exactly inside the
kernel, never cast on the host.  Codes match ``core/lut.py::pack_codes``
bit for bit for every finite or infinite input; NaN is outside that
contract (torch's CPU and CUDA conversions to fp16 give it other bits).

Dispatch: a CUDA tensor with ``use_kernels=True`` launches the kernel in
``csrc/bitplane_pack.cu`` or raises; a CPU tensor, or ``use_kernels=False``
(an explicit request for the plain version), runs ``ref.py``.  The launch
count is :data:`LAUNCHES`, counted right where the kernel launches.

:func:`pack` is the plan-taking entry the model calls in place of
``pack_codes``; :func:`kernel_args` maps a plan onto the kernel's
arguments.  :func:`pack` refuses a bf16 input on a fixed-point plan whose
clip bounds bf16 cannot hold (:func:`check_bf16_bounds`): ``pack_codes``
clamps in the input's dtype, so such a bound would round (2047 to 2048)
and a saturated code would wrap or lose its top bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.lut import LUTPlan, pack_codes
from repro_torch.core.quantize import FixedPointFormat
from repro_torch.kernels import build
from repro_torch.kernels.bitplane_pack.ref import bitplane_pack_ref, pack_plan

LAUNCHES = {"bitplane_pack": 0}
# plans the kernel does not implement, packed by core/lut.py::pack_codes
PLAIN_CALLS = {"pack_codes": 0}

_KIND_CODE = {"fixed": 0, "float16": 1, "shift": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("bitplane_pack")
    if not getattr(lib, "_bound", False):
        # x, out, kind, dtype, B, q, m, bits, frac, signed, radix, vec, stream
        lib.bitplane_pack_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        )
        lib.bitplane_pack_launch.restype = ctypes.c_int
        lib.bitplane_pack_error_string.argtypes = [ctypes.c_int]
        lib.bitplane_pack_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def kernel_args(plan: LUTPlan) -> dict | None:
    """The kernel's arguments (:func:`bitplane_pack`'s keywords) for the
    plans it implements: a fixed-point ``bitplane`` plan, an unsigned
    radix-1 fp16 ``bitplane`` plan (any chunk) and any ``bitplane_shift``
    plan.  ``None`` for the rest -- the ``full`` modes, and fp16
    ``bitplane`` with a sign or a radix above 1 -- which neither the Pallas
    kernel nor this one packs: :func:`pack` runs ``pack_codes`` for them."""
    fmt = plan.fmt
    args = {"m": plan.chunk_size, "bits": 16, "frac": 0, "signed": False, "radix": 1}
    if plan.mode == "bitplane_shift":
        return {**args, "kind": "shift", "signed": fmt.signed, "radix": fmt.mantissa_radix}
    if plan.mode != "bitplane":
        return None
    if isinstance(fmt, FixedPointFormat):
        return {**args, "kind": "fixed", "bits": fmt.total_bits, "frac": fmt.frac_bits,
                "signed": fmt.signed}
    if fmt.signed or fmt.mantissa_radix != 1:
        return None
    return {**args, "kind": "float16"}


def check_bf16_bounds(x: torch.Tensor, plan: LUTPlan) -> None:
    """Raise ``ValueError`` for a bf16 ``x`` on a fixed-point plan whose
    ``code_min`` or ``code_max`` is not exact in bf16 (signed formats of
    10 bits or more, unsigned of 9 or more)."""
    fmt = plan.fmt
    if x.dtype != torch.bfloat16 or not isinstance(fmt, FixedPointFormat):
        return
    bounds = torch.tensor([fmt.code_min, fmt.code_max], dtype=torch.float64)
    if not torch.equal(bounds.to(torch.bfloat16).to(torch.float64), bounds):
        raise ValueError(
            f"bf16 input on {fmt}: its clip bounds [{fmt.code_min}, "
            f"{fmt.code_max}] are not exact in bf16, so saturated codes would "
            "be wrong; pass fp32 input"
        )


def vectorized(q: int, m: int, ptr: int, itemsize: int) -> bool:
    """Whether a launch takes the kernel's 4-element path: chunk 1, rows a
    whole number of 4-element groups and a base aligned to 4 elements (16
    bytes fp32, 8 bf16).  The output, from ``torch.empty``, is always
    aligned.  Otherwise the scalar path runs on the same operands."""
    return m == 1 and q % 4 == 0 and ptr % (4 * itemsize) == 0


def launch(x2: torch.Tensor, out: torch.Tensor, *, kind: str, m: int, bits: int, frac: int,
           signed: bool, radix: int, vec: bool) -> None:
    """One launch on ``x2`` (B, q) into ``out`` (B, n, k), both contiguous
    on the card; raises with CUDA's message if the C entry refuses the
    arguments or the launch fails."""
    lib = _lib()
    B, q = x2.shape
    err = lib.bitplane_pack_launch(
        x2.data_ptr(), out.data_ptr(), _KIND_CODE[kind], _DTYPE_CODE[x2.dtype], B, q, m,
        bits, frac, int(signed), radix, int(vec),
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if err != 0:
        msg = lib.bitplane_pack_error_string(err).decode()
        raise RuntimeError(f"bitplane_pack: kernel launch failed with CUDA error {err} ({msg})")
    LAUNCHES["bitplane_pack"] += 1


def _pack(x: torch.Tensor, plan: LUTPlan, args: dict, use_kernels: bool) -> torch.Tensor:
    *lead, q = x.shape
    n, k = plan.num_planes, plan.num_chunks
    x2 = x.reshape(-1, q)
    if not (use_kernels and x2.is_cuda):
        return bitplane_pack_ref(x2, **args).reshape(*lead, n, k)
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"the packing kernel takes fp32 or bf16 input, got {x2.dtype}")
    x2 = x2.contiguous()
    out = torch.empty((x2.shape[0], n, k), dtype=torch.int32, device=x2.device)
    if x2.shape[0] and q:
        vec = vectorized(q, args["m"], x2.data_ptr(), x2.element_size())
        launch(x2, out, vec=vec, **args)
    return out.reshape(*lead, n, k)


def bitplane_pack(
    x: torch.Tensor,  # (..., q) fp32 or bf16
    *,
    kind: str,  # "fixed" | "float16" | "shift"
    m: int,
    bits: int = 16,
    frac: int = 0,
    signed: bool = False,
    radix: int = 1,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Quantize ``x`` and emit its LUT indices ``(..., n, k)``: fixed point
    with ``n = bits`` planes of ``m``-bit chunk indices; unsigned fp16 with
    ``n = 11`` planes of 6-bit fields per element; or (``kind="shift"``,
    chunk 1) the ``bitplane_shift`` codes of ``Float16Format(signed,
    radix)``, ``n = ceil(11 / radix)``, the exponent above the index bits."""
    args = dict(kind=kind, m=m, bits=bits, frac=frac, signed=signed, radix=radix)
    return _pack(x, pack_plan(x.shape[-1], **args), args, use_kernels)


def pack(x: torch.Tensor, plan: LUTPlan, use_kernels: bool = True) -> torch.Tensor:
    """``core/lut.py::pack_codes(x, plan)``, bit for bit: on the kernel for
    the plans :func:`kernel_args` covers (under the dispatch above), else
    ``pack_codes`` itself, counted in :data:`PLAIN_CALLS`."""
    if x.shape[-1] != plan.in_features:
        raise ValueError(f"input width {x.shape[-1]} != plan.in_features {plan.in_features}")
    check_bf16_bounds(x, plan)
    args = kernel_args(plan)
    if args is None:
        PLAIN_CALLS["pack_codes"] += 1
        return pack_codes(x, plan)
    return _pack(x, plan, args, use_kernels)
