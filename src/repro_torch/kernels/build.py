"""Build the port's CUDA sources into shared libraries and load them.

Each source under ``src/repro_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a library with a plain C interface, bound with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries go
to ``build/repro_torch/`` at the repository root, named by a hash of the
source text and the flags: a fresh checkout builds on first use, and an
edited source never loads a stale library.  :func:`build` starts one
``nvcc`` per source, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

# library name -> source files under csrc/
SOURCES: dict[str, tuple[str, ...]] = {
    "lut_affine": ("lut_affine.cu",),
    "lut_tl1": ("lut_tl1.cu",),
    "bitplane_pack": ("bitplane_pack.cu",),
    "binary_matmul": ("binary_matmul.cu",),
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

BUILD_SECONDS: dict[str, float] = {}  # wall time of the last build, per library
BUILD_LOG: dict[str, str] = {}  # nvcc's output (ptxas register/spill report)
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels are built from source on the machine with the card"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None, force: bool = False) -> dict[str, Path]:
    """Compile the named libraries (default: all) concurrently; returns
    their paths.  Raises with nvcc's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        srcs = [str(CSRC / s) for s in SOURCES[name]]
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), *srcs]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
            time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if no current build exists."""
    if name not in _LIBS:
        path = library_path(name)
        if not path.exists():
            build([name])
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
