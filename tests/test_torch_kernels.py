"""The port's LUT affine wrappers and plain versions against the JAX
package's ``repro.kernels.lut_affine`` (its jnp oracle, and once its
Pallas kernel in interpret mode), plus the wrappers' dispatch rules.

The Hopper kernels themselves run only on the card:
``test_torch_kernels_cuda.py`` holds them against the plain versions
there."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lut_affine import ops as jops
from repro.kernels.lut_affine import ref as jref
from repro_torch.kernels.lut_affine import ops
from repro_torch.kernels.lut_affine.ref import lut_affine_grouped_ref, lut_affine_ref

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "i8": (jnp.int8, torch.int8), "i16": (jnp.int16, torch.int16)}


def _case(seed, lead, n, k, E, p, dtype, shift_bits, G=None):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, E, lead + (n, k)).astype(np.int32)
    if shift_bits:
        exp = rng.integers(0, 31, lead + (1, k)).astype(np.int32)
        codes = codes + (exp << shift_bits)
    shape = ((G,) if G else ()) + (k, E, p)
    if dtype in ("i8", "i16"):
        hi = 127 if dtype == "i8" else 32767
        tables = rng.integers(-hi, hi + 1, shape).astype(np.float32)
    else:
        tables = rng.standard_normal(shape).astype(np.float32)
    scales = (2.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    scales[-1] = -scales[-1]  # a negative plane (signed fixed-point MSB)
    jd, td = DTYPES[dtype]
    jt = jnp.asarray(tables).astype(jd)
    tt = torch.from_numpy(tables).to(td)
    return codes, jt, tt, scales


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    # fp32 sums taken in another order
    np.testing.assert_allclose(
        got.numpy(), want, rtol=1e-5, atol=1e-5 * max(1e-30, np.abs(want).max())
    )


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shift_bits", [0, 5])
def test_plain_lut_affine_matches_reference(dtype, shift_bits):
    E = 32 if shift_bits else 16
    codes, jt, tt, scales = _case(0, (5,), 3, 19, E, 37, dtype, shift_bits)
    want = jref.lut_affine_ref(jnp.asarray(codes), jt, jnp.asarray(scales), shift_bits)
    got = lut_affine_ref(
        torch.from_numpy(codes), tt, torch.from_numpy(scales), shift_bits
    )
    _close(got, want)
    # k-sliced gathers (a small gather budget) give the same sums
    sliced = lut_affine_ref(
        torch.from_numpy(codes), tt, torch.from_numpy(scales), shift_bits,
        max_gather_bytes=5 * 3 * 37 * 4 * 4,
    )
    _close(sliced, want)


@pytest.mark.parametrize("dtype", ["f32", "i8"])
@pytest.mark.parametrize("shift_bits", [0, 5])
def test_plain_grouped_matches_reference(dtype, shift_bits):
    codes, jt, tt, scales = _case(1, (4,), 3, 11, 32, 20, dtype, shift_bits, G=3)
    want = jref.lut_affine_grouped_ref(
        jnp.asarray(codes), jt, jnp.asarray(scales), shift_bits
    )
    got = lut_affine_grouped_ref(
        torch.from_numpy(codes), tt, torch.from_numpy(scales), shift_bits
    )
    _close(got, want)


@pytest.mark.parametrize("grouped", [False, True])
def test_wrappers_leading_dims_and_bias(grouped):
    G = 2 if grouped else None
    codes, jt, tt, scales = _case(2, (2, 3), 3, 9, 32, 16, "i16", 5, G=G)
    rng = np.random.default_rng(3)
    bias = rng.standard_normal(((G,) if G else ()) + (16,)).astype(np.float32)
    if grouped:
        want = jops.lut_affine_grouped(
            jnp.asarray(codes), jt, jnp.asarray(scales), biases=jnp.asarray(bias),
            shift_bits=5, interpret=True,
        )
        got = ops.lut_affine_grouped(
            torch.from_numpy(codes), tt, scales, biases=torch.from_numpy(bias),
            shift_bits=5,
        )
    else:
        want = jops.lut_affine(
            jnp.asarray(codes), jt, jnp.asarray(scales), bias=jnp.asarray(bias),
            shift_bits=5, interpret=True,
        )
        got = ops.lut_affine(
            torch.from_numpy(codes), tt, scales, bias=torch.from_numpy(bias),
            shift_bits=5,
        )
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    codes, _, tt, scales = _case(4, (3,), 3, 8, 32, 12, "i8", 5)
    before = dict(ops.LAUNCHES)
    a = ops.lut_affine(torch.from_numpy(codes), tt, scales, shift_bits=5)
    b = ops.lut_affine(
        torch.from_numpy(codes), tt, scales, shift_bits=5, use_kernels=False
    )
    c = ops.lut_affine_grouped(torch.from_numpy(codes), tt[None], scales, shift_bits=5)
    assert ops.LAUNCHES == before
    assert torch.equal(a, b) and torch.equal(a, c[0])


def test_plane_shifts_accept_only_signed_powers_of_two():
    exps, neg = ops.plane_shifts(np.array([1.0, 2.0**-7, -2.0**5, 2.0**20], np.float32))
    assert exps == [0, -7, 5, 20] and neg == 0b0100
    for bad in ([3.0], [0.0], [float("inf")], [1.0] * (ops.MAX_PLANES + 1)):
        with pytest.raises(ValueError):
            ops.plane_shifts(bad)
    with pytest.raises(ValueError):
        ops.host_scales(torch.ones(3, device="meta"))


def test_k_splits_fill_the_card_only_when_tiles_are_few():
    sms = 132

    def splits(G, B, k, p):  # n = 3 planes, 32 entries, i8 tables
        return ops.tiling(G, B, 3, k, 32, p, sms).splits

    assert splits(1, 4, 4096, 4096) == 33  # decode wq: 8 tiles, 2 blocks an SM
    assert splits(2, 4, 4096, 1024) == 66  # decode wk+wv: 4 tiles
    assert splits(1, 128, 4096, 4096) == 8  # prefill wq: 16 tiles
    assert splits(1, 640, 4096, 65536) == 1  # prefill, tiles enough: 1280
    assert splits(1, 3, 5, 144) == 5  # never more than the chunks


def test_wrappers_check_the_accumulator_contract():
    codes, _, tt, scales = _case(5, (2,), 3, 8, 32, 12, "i8", 5)
    plan = types.SimpleNamespace(acc_dtype="int16", max_abs_acc=1e9)
    with pytest.raises(ValueError, match="exceeds"):
        ops.lut_affine(torch.from_numpy(codes), tt, scales, shift_bits=5, plan=plan)
    with pytest.raises(ValueError, match="exceeds"):
        ops.lut_affine_grouped(torch.from_numpy(codes), tt[None], scales, plan=plan)


def test_plain_matches_pallas_kernel_in_interpret_mode():
    """One tiny case against the TPU kernel itself, run by Pallas'
    interpreter on the CPU."""
    codes, jt, tt, scales = _case(6, (3,), 3, 4, 32, 8, "i8", 5)
    want = jops.lut_affine(
        jnp.asarray(codes), jt, jnp.asarray(scales), shift_bits=5, interpret=True,
        blocks=(8, 128, 2),
    )
    got = ops.lut_affine(torch.from_numpy(codes), tt, scales, shift_bits=5)
    _close(got, want)
