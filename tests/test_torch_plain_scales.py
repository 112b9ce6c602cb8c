"""The plain versions' plane scales held on the device
(``kernels/common.py::device_scales``).

A plain LUT or binary-matmul call made while the engine's decode step is
captured as a CUDA graph cannot copy its host scales to the card, so each
call reads one tensor made by the first call for those values (the engine's
eager warm-up step).  Here, on the CPU: the second call of every plain
entry builds no new scale tensor (the first call's object is the one its
plain version reads), and the outputs equal, bit for bit, the plain
versions fed a scale tensor made on the spot as before.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.binary_matmul import ops as bmm_ops
from repro_torch.kernels.binary_matmul.ref import binary_matmul_ref
from repro_torch.kernels.lut_affine import ops as lut_ops
from repro_torch.kernels.lut_affine.ref import (
    lut_affine_experts_ref,
    lut_affine_grouped_ref,
    lut_affine_ref,
)
from repro_torch.models import layers

SCALES = np.array([-2.0, 1.0, 0.5, 0.25], np.float32)
B, N, K, E, P, G = 3, 4, 5, 16, 24, 2
SIZES = torch.tensor([2, 1], dtype=torch.int32)  # rows of each of G experts


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fresh_scales(monkeypatch):
    """An empty cache for the test, so its first call makes the entry."""
    monkeypatch.setattr(common, "SCALES", {})


def _inputs():
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, E, (B, N, K), dtype=np.int32))
    tables = torch.from_numpy(rng.standard_normal((G, K, E, P)).astype(np.float32))
    return codes, tables


def _made_on_the_spot():
    return torch.tensor(SCALES.astype(np.float64), dtype=torch.float32)


def _lut_affine(codes, tables, use_ref=False):
    if use_ref:
        return lut_affine_ref(codes, tables[0], _made_on_the_spot())
    return lut_ops.lut_affine(codes, tables[0], SCALES, use_kernels=False)


def _lut_affine_grouped(codes, tables, use_ref=False):
    if use_ref:
        return lut_affine_grouped_ref(codes, tables, _made_on_the_spot())
    return lut_ops.lut_affine_grouped(codes, tables, SCALES, use_kernels=False)


def _lut_affine_experts(codes, tables, use_ref=False):
    ex = tables[:, None]  # (E=G experts, 1 projection, k, En, p)
    if use_ref:
        return lut_affine_experts_ref(codes, ex, _made_on_the_spot(), SIZES)
    return lut_ops.lut_affine_experts(codes, ex, SCALES, SIZES, use_kernels=False)


def _binary_matmul(codes, tables, use_ref=False):
    planes = codes[..., :1].expand(B, N, 8) & 1
    W = tables[0, 0, :8, :]
    if use_ref:
        return binary_matmul_ref(planes, W, _made_on_the_spot())
    return bmm_ops.binary_matmul(planes, W, SCALES, use_kernels=False)


def _onehot(codes, tables, use_ref=False):
    if use_ref:  # the scales made on the spot, as before the cache
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers, "device_scales", lambda v, d: torch.as_tensor(
                v, dtype=torch.float32).to(d))
            return layers._onehot_apply(tables[0], None, codes, SCALES)
    return layers._onehot_apply(tables[0], None, codes, SCALES)


ENTRIES = {
    "lut_affine": _lut_affine,
    "lut_affine_grouped": _lut_affine_grouped,
    "lut_affine_experts": _lut_affine_experts,
    "binary_matmul": _binary_matmul,
    "onehot_apply": _onehot,
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_second_plain_call_builds_no_scale_tensor(entry, fresh_scales):
    fn = ENTRIES[entry]
    codes, tables = _inputs()
    made = []
    real = torch.tensor

    def counting_tensor(*a, **k):
        made.append(a)
        return real(*a, **k)

    first = fn(codes, tables)
    assert len(common.SCALES) == 1
    (key, held), = common.SCALES.items()
    assert key[1] == torch.device("cpu")
    assert torch.equal(held, torch.from_numpy(SCALES))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "tensor", counting_tensor)
        second = fn(codes, tables)
    assert list(common.SCALES) == [key] and common.SCALES[key] is held
    assert made == []
    assert torch.equal(first, second)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_plain_outputs_unchanged_bit_for_bit(entry, fresh_scales):
    fn = ENTRIES[entry]
    codes, tables = _inputs()
    assert torch.equal(fn(codes, tables), fn(codes, tables, use_ref=True))


def test_cached_scales_are_per_device_and_values(fresh_scales):
    a = common.device_scales(SCALES, torch.device("cpu"))
    b = common.device_scales(SCALES.astype(np.float64), "cpu")
    c = common.device_scales(SCALES[::-1].copy(), torch.device("cpu"))
    assert a is b and a is not c
    assert a.dtype == torch.float32 and torch.equal(c, torch.from_numpy(SCALES[::-1].copy()))
    assert len(common.SCALES) == 2
