"""The Hopper LUT affine kernels against their plain PyTorch versions, on
the card.  The kernels have no CPU mode, so every test here is marked
``cuda`` and skips without a card.  The file imports neither JAX nor the
JAX package, so it runs on a machine that has only the port's
dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.lut_affine import ops

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8": torch.int8, "i16": torch.int16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, B, n, k, E, p, G, dtype, shift_bits):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, E, (B, n, k)).astype(np.int32)
    if shift_bits:
        exp = rng.integers(0, 31, (B, 1, k)).astype(np.int32)
        codes = codes + (exp << shift_bits)
    if dtype in ("i8", "i16"):
        hi = 127 if dtype == "i8" else 32767
        tables = rng.integers(-hi, hi + 1, (G, k, E, p)).astype(np.float32)
    else:
        tables = rng.standard_normal((G, k, E, p)).astype(np.float32)
    scales = (2.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    scales[-1] = -scales[-1]  # a negative plane (signed fixed-point MSB)
    return codes, torch.from_numpy(tables).to(DTYPES[dtype]), scales


def _close(got: torch.Tensor, want: torch.Tensor) -> None:
    got, want = got.cpu().numpy(), want.cpu().numpy()
    # fp32 sums taken in another order
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * max(1e-30, np.abs(want).max())
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift_bits", [0, 5])
def test_kernels_match_plain_on_card(cuda_device, dtype, shift_bits):
    # B = 10 rows over 130 columns: few output tiles, so the launch also
    # splits k across blocks; ragged B and p edges
    codes, tables, scales = _case(7, 10, 3, 77, 32, 130, 2, dtype, shift_bits)
    c, t = torch.from_numpy(codes).to(cuda_device), tables.to(cuda_device)
    lead = c.reshape(2, 5, 3, 77)
    before = dict(ops.LAUNCHES)
    got1 = ops.lut_affine(lead, t[0], scales, shift_bits=shift_bits)
    got2 = ops.lut_affine_grouped(c, t, scales, shift_bits=shift_bits)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lut_affine"] == before["lut_affine"] + 1
    assert ops.LAUNCHES["lut_affine_grouped"] == before["lut_affine_grouped"] + 1
    want = ops.lut_affine_grouped(c, t, scales, shift_bits=shift_bits, use_kernels=False)
    assert tuple(got1.shape) == (2, 5, 130)
    _close(got1.reshape(10, 130), want[0])
    _close(got2, want)


@pytest.mark.cuda
def test_kernels_take_bias_and_one_row(cuda_device):
    codes, tables, scales = _case(8, 1, 3, 64, 32, 96, 2, "i8", 5)
    c, t = torch.from_numpy(codes).to(cuda_device), tables.to(cuda_device)
    bias = torch.randn((2, 96), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    got = ops.lut_affine_grouped(c, t, scales, biases=bias, shift_bits=5)
    want = ops.lut_affine_grouped(
        c, t, scales, biases=bias, shift_bits=5, use_kernels=False
    )
    _close(got, want)
    got1 = ops.lut_affine(c, t[1], scales, bias=bias[1], shift_bits=5)
    _close(got1, want[1])
