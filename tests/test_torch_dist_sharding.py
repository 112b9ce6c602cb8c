"""The port's sharding rules (``repro_torch.dist.sharding``) and mesh
shapes (``repro_torch.launch.mesh``) against the JAX package's.

The reference's ``ShardCtx`` resolves specs on a device-less
``jax.sharding.AbstractMesh``; the port's on anything with a
``DeviceMesh``'s ``mesh_dim_names`` and ``shape`` (a 4-rank ``DeviceMesh``
itself is held to the reference in ``test_torch_dist_world.py``).  Every
query must resolve as the reference's: absent axes dropped, each mesh axis
once per tensor, trailing axes peeled until they divide.
"""
from __future__ import annotations

import dataclasses
import itertools

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.dist import sharding as ref
from repro.launch import mesh as ref_mesh
from repro_torch.dist import sharding as port
from repro_torch.launch import mesh as port_mesh


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """What the port's ``ShardCtx`` reads of a ``DeviceMesh``."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


MESHES = {
    "pod_data_model_2x2x4": ((2, 2, 4), ("pod", "data", "model")),
    "data_model_16x16": ((16, 16), ("data", "model")),
    "data_1": ((1,), ("data",)),
    "data_model_4x2_no_pod": ((4, 2), ("data", "model")),
    "pod_data_2x8": ((2, 8), ("pod", "data")),
}
RULES = {
    "default": ref.DEFAULT_RULES,
    "no_fsdp": ref.NO_FSDP_RULES,
    "default_without_pod": ref.rules_without_axis(ref.DEFAULT_RULES, "pod"),
    "no_fsdp_without_pod": ref.rules_without_axis(ref.NO_FSDP_RULES, "pod"),
}
# (logical axes, shape): dims that divide, that peel a trailing axis, that
# divide by nothing, a mesh axis claimed twice, absent and unnamed axes
CASES = [
    (("batch", None), (32, 7)),
    (("batch", "embed"), (8, 64)),
    (("batch", "embed"), (2, 64)),
    (("batch", "seq_kv"), (6, 48)),
    (("batch",), (3,)),
    (("embed", "heads_flat"), (64, 128)),
    (("embed", "mlp"), (48, 36)),
    (("heads", "kv_heads"), (8, 4)),
    (("mlp", "heads_flat"), (64, 64)),
    (("vocab", "embed"), (1000, 32)),
    (("layers", "embed", "mlp"), (4, 32, 8)),
    (("experts", "embed", "mlp"), (8, 16, 12)),
    (("qseq", None, "seq_kv"), (16, 3, 32)),
    ((None, "batch"), (5, 16)),
    (("unknown", "embed"), (4, 4)),
]


def _ctxs(mesh_key, rules_key):
    shape, names = MESHES[mesh_key]
    theirs = ref.ShardCtx(AbstractMesh(shape, names), RULES[rules_key])
    ours = port.ShardCtx(MeshShape(names, shape), port_rules(rules_key))
    return theirs, ours


def port_rules(key):
    base = port.DEFAULT_RULES if key.startswith("default") else port.NO_FSDP_RULES
    return port.rules_without_axis(base, "pod") if key.endswith("without_pod") else base


@pytest.mark.parametrize(
    "mesh_key,rules_key", list(itertools.product(sorted(MESHES), sorted(RULES))))
def test_shard_ctx_matches_reference(mesh_key, rules_key):
    theirs, ours = _ctxs(mesh_key, rules_key)
    assert ours.rules == theirs.rules
    for axes, shape in CASES:
        want = tuple(theirs.spec(axes, shape))
        got = ours.spec(axes, shape)
        # PartitionSpec drops nothing: one entry per dimension, as the port's
        assert got == want + (None,) * (len(shape) - len(want)), (axes, shape)
        assert ours.param_sharding(type("S", (), {"axes": axes, "shape": shape})()) == got
    for names in [("pod",), ("data",), ("model",), ("pod", "data"), ("data", "model"),
                  ("pod", "data", "model"), ("absent",), ()]:
        assert ours.axis_size(*names) == theirs.axis_size(*names), names
    assert ours.data_axes == theirs.data_axes
    assert ours.model_axes == theirs.model_axes
    for n in (1, 2, 3, 4, 8, 12, 16, 32, 40):
        assert ours.heads_shardable(n) == theirs.heads_shardable(n), n


def test_no_mesh_is_inert():
    sh = port.ShardCtx()
    x = torch.ones(4, 8)
    assert sh.constrain(x, "batch", None) is x
    assert sh.local_batch(x) is x
    assert sh.batch_index(4) == (0, 1)
    assert sh.sharding(("batch", None), (4, 8)) is None
    assert sh.param_sharding(type("S", (), {"axes": ("embed",), "shape": (8,)})()) is None
    assert sh.axis_size("data") == 0 and sh.axis_size("data", "model") == 0
    assert not sh.heads_shardable(16)
    assert sh.data_axes == () and sh.model_axes == ()
    theirs = ref.ShardCtx()
    assert (theirs.axis_size("pod"), theirs.data_axes) == (sh.axis_size("pod"), sh.data_axes)


def test_rule_sets_equal_the_reference():
    assert port.DEFAULT_RULES == ref.DEFAULT_RULES
    assert port.NO_FSDP_RULES == ref.NO_FSDP_RULES
    assert set(port.RULE_SETS) == set(ref.RULE_SETS)
    for k in ref.RULE_SETS:
        assert port.RULE_SETS[k] == ref.RULE_SETS[k]
    for axis in ("pod", "data", "model", "absent"):
        for rules in (ref.DEFAULT_RULES, ref.NO_FSDP_RULES):
            assert port.rules_without_axis(rules, axis) == ref.rules_without_axis(rules, axis)


def test_constrain_is_the_identity_on_a_mesh():
    _, ours = _ctxs("pod_data_model_2x2x4", "default")
    x = torch.ones(8, 4)
    assert ours.constrain(x, "batch", "embed") is x


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shape_matches_reference(multi_pod, monkeypatch):
    seen = {}

    def fake_make_mesh(shape, axes, axis_types=None):
        seen["shape"], seen["axes"] = tuple(shape), tuple(axes)

    monkeypatch.setattr(ref_mesh, "make_mesh", fake_make_mesh)
    ref_mesh.make_production_mesh(multi_pod=multi_pod)
    assert port_mesh.production_mesh_shape(multi_pod) == (seen["shape"], seen["axes"])
