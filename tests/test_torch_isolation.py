"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py`` and not the card's tests (which run where JAX is not
installed) import JAX or the JAX package, and no kernel wrapper hides a
launch behind a ``try`` that could fall back."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "tests" / "test_torch_kernels_cuda.py",
]
BANNED = ("jax", "jaxlib", "repro")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_file_list_is_the_port():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    assert {
        "kernels/lut_affine/ops.py",
        "kernels/lut_tl1/ops.py",
        "kernels/binary_matmul/ops.py",
        "kernels/bitplane_pack/ops.py",
        "serve/_engine.py",
        "core/lut.py",
        "core/lut_tl1.py",
        "models/moe.py",
    } <= names


def test_kernel_wrappers_have_no_try():
    for ops in PORT.glob("kernels/**/ops.py"):
        tree = ast.parse(ops.read_text())
        tries = [
            n.lineno for n in ast.walk(tree) if isinstance(n, (ast.Try, ast.TryStar))
        ]
        assert not tries, f"{ops.relative_to(ROOT)} has try blocks at lines {tries}"
