"""The port's int8 error-feedback reduction (``repro_torch.dist.
compression``) against the JAX package's ``compressed_psum``, and its
``collective_stats`` against the reference's HLO parser.

The reference runs its collectives under ``jax.vmap(..., axis_name="pod")``
here (one stacked row per pod, ``pmax`` and ``psum`` over the mapped
axis): its ``shard_map`` form fails under this JAX.  The plain
``compressed_psum_ref`` must equal it bit for bit: 1, 2 and 4 pods, fp32
and bf16 gradients, a non-zero residual, a leaf of zeros (the ``tiny``
floor of the scale), codes on exact .5 ties (round half to even) and two
steps with the residual fed back.  The process-group form is held to the
same oracle across a 4-rank world in ``test_torch_dist_world.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.compression import compressed_psum
from repro.launch import hlo_analysis as H
from repro_torch.dist.compression import collective_stats, compressed_psum_ref


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the reference's per-pod outputs, under vmap over the pod axis, op by op
# (under jit, XLA:CPU contracts ``c - codes * scale`` into other roundings)
ref_step = jax.vmap(lambda g, e: compressed_psum(g, e, "pod"), axis_name="pod")


def tree(pods: int, seed: int) -> tuple[dict, dict]:
    """fp32 gradients (numpy) with a leaf of zeros and a leaf whose codes
    fall on .5 ties, and residuals: non-zero on the other leaves."""
    rng = np.random.default_rng(seed)
    g = {
        "w": rng.standard_normal((pods, 6, 5)).astype(np.float32),
        "b": (rng.standard_normal((pods, 7)) * 1e-3).astype(np.float32),
        "zeros": np.zeros((pods, 4), np.float32),
        # absmax 127 makes the scale 1, so c / scale lands on the ties
        "ties": np.tile(np.array([127.0, 2.5, -3.5, 0.5, 1.5, -0.5], np.float32), (pods, 1)),
    }
    e = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32) for k, v in g.items()}
    e["zeros"] = np.zeros_like(g["zeros"])
    e["ties"] = np.zeros_like(g["ties"])
    return g, e


def _to_torch(d, dtype=None):
    out = {k: torch.from_numpy(np.asarray(v, np.float32).copy()) for k, v in d.items()}
    return {k: v.to(dtype) for k, v in out.items()} if dtype is not None else out


def _bits(x) -> np.ndarray:
    """Raw bits of a torch or JAX array (bf16 included)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(x)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("pods", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_psum_ref_matches_reference_bit_for_bit(pods, dtype):
    g_np, e_np = tree(pods, seed=pods)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    g_j = {k: jnp.asarray(v).astype(jdt) for k, v in g_np.items()}
    e_j = {k: jnp.asarray(v) for k, v in e_np.items()}
    g_t = _to_torch(g_np, tdt)  # bf16: both round to nearest even
    e_t = _to_torch(e_np)
    for step in range(2):  # the second step feeds the residual back
        want_mean, want_err = ref_step(g_j, e_j)
        got_mean, got_err = compressed_psum_ref(g_t, e_t)
        for k in g_np:
            assert got_mean[k].dtype == tdt
            for p in range(pods):  # every pod receives the same mean
                np.testing.assert_array_equal(_bits(got_mean[k]), _bits(want_mean[k][p]), k)
            np.testing.assert_array_equal(_bits(got_err[k]), _bits(want_err[k]), k)
            scale = np.float32(max(np.abs(np.asarray(g_t[k].float() + e_t[k])).max(),
                                   np.finfo(np.float32).tiny) / np.float32(127))
            # half a step, and the fp32 rounding of c / scale (|c / scale| <=
            # 127: 127 * 2**-24 of a step, twice that kept as margin)
            assert np.abs(got_err[k].numpy()).max() <= (0.5 + 2**-15) * scale
        # the zeros leaf: the tiny floor gives codes 0, a mean and residual of 0
        assert not got_mean["zeros"].any() and not got_err["zeros"].any()
        if step == 0:  # the ties round half to even: 2.5 -> 2, -3.5 -> -4, ...
            np.testing.assert_array_equal(
                got_err["ties"][0].numpy(),
                np.array([0, 0.5, 0.5, 0.5, -0.5, -0.5], np.float32))
        e_j, e_t = want_err, got_err


# -- collective_stats ------------------------------------------------------------

_HLO_DT = {"torch.float32": "f32", "torch.int32": "s32", "torch.bfloat16": "bf16",
           "torch.int8": "s8"}

RECORDS = [
    {"collective": "all-reduce", "reduce": "max", "dtype": "torch.float32",
     "shape": (5,), "bytes": 20, "group_size": 2},
    {"collective": "all-reduce", "reduce": "sum", "dtype": "torch.int32",
     "shape": (1000,), "bytes": 4000, "group_size": 2},
    {"collective": "all-reduce", "reduce": "sum", "dtype": "torch.float32",
     "shape": (64, 8), "bytes": 2048, "group_size": 4},
    {"collective": "all-gather", "reduce": None, "dtype": "torch.float32",
     "shape": (2, 16), "bytes": 128, "group_size": 2},
    {"collective": "all-gather", "reduce": None, "dtype": "torch.bfloat16",
     "shape": (16, 3), "bytes": 96, "group_size": 16},
    {"collective": "barrier", "reduce": None, "dtype": None, "shape": (),
     "bytes": 0, "group_size": 4},
]


def _hlo_line(i: int, r: dict, n: int) -> str:
    """One HLO instruction standing for a recorded collective, in the
    format the reference parses (``[G,N]`` replica groups of ``N``)."""
    dims = ",".join(str(d) for d in r["shape"])
    return (f"%c.{i} = {_HLO_DT[r['dtype']]}[{dims}]{{0}} {r['collective']}(%x.{i}), "
            f"replica_groups=[{64 // n},{n}]<=[64]")


@pytest.mark.parametrize("group_size", [None, 1, 2, 16])
def test_collective_stats_matches_reference(group_size):
    lines = [_hlo_line(i, r, group_size or r["group_size"])
             for i, r in enumerate(RECORDS) if r["collective"] != "barrier"]
    want = H.collective_stats("\n".join(lines)).to_dict()
    got = collective_stats(RECORDS, group_size=group_size).to_dict()
    assert got["by_op"].keys() == want["by_op"].keys()
    for op, rec in want["by_op"].items():
        assert got["by_op"][op]["count"] == rec["count"]
        assert got["by_op"][op]["result_bytes"] == rec["result_bytes"]
        assert got["by_op"][op]["link_bytes"] == pytest.approx(rec["link_bytes"], rel=1e-12)
    assert got["result_bytes"] == want["result_bytes"]
    assert got["link_bytes"] == pytest.approx(want["link_bytes"], rel=1e-12)


def test_collective_stats_of_nothing():
    st = collective_stats([])
    assert st.by_op == {} and st.result_bytes == 0 and st.link_bytes == 0.0
