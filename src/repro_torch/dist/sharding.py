"""Logical-axis sharding rules and the ``ShardCtx`` carried in ``Ctx``
(counterpart of ``repro/dist/sharding.py``).

Parameters declare *logical* axes (``embed``, ``heads_flat``, ``mlp``, ...)
in their ``PSpec``; a *rule set*, an ordered tuple of ``(logical_axis,
mesh_axes)`` pairs, maps those names onto the axes of the job's
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names``, with
``mesh.shape`` as their sizes).  The same model code runs on one device,
where every method is inert, and on a mesh.

Resolution, per tensor and per dimension, as the reference resolves it:

* rules may name mesh axes the mesh lacks (``pod`` on a one-pod mesh):
  absent axes are dropped;
* a mesh axis is used at most once per tensor (the first dimension wins);
* an assignment must divide the dimension, else trailing mesh axes are
  peeled off until it does (down to unsharded).

:meth:`ShardCtx.spec` gives a ``PartitionSpec``'s content as a tuple, one
entry per dimension: ``None``, a mesh axis name, or a tuple of names.
PyTorch has no GSPMD: each rank holds its own activations, so
:meth:`ShardCtx.constrain` is the identity, and the trainer takes each
rank's slice of a batch with :meth:`ShardCtx.local_batch`.  Parameters are
replicated on every rank; :meth:`ShardCtx.param_sharding` resolves where
the rules would place one, and placing them by it (FSDP over ``data``, TP
over ``model``) is not ported yet.

``RULE_SETS`` registers the named sets: ``default`` (TP over ``model``,
batch over ``pod`` + ``data``, FSDP of the ``embed`` dimension over
``data``) and ``no_fsdp`` (the same with every non-TP parameter dimension
replicated).  Nothing here reads a mesh or a process group at import.
"""
from __future__ import annotations

import dataclasses
import math
from functools import cached_property
from typing import Any, Optional

import torch

Rules = tuple[tuple[str, tuple[str, ...]], ...]

DEFAULT_RULES: Rules = (
    ("batch", ("pod", "data")),
    ("embed", ("data",)),  # FSDP: shard the param embed dim over data
    ("heads_flat", ("model",)),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("mlp", ("model",)),
    ("vocab", ("model",)),
    ("qseq", ("model",)),
    ("seq_kv", ("model",)),
    ("experts", ()),
    ("layers", ()),
)

NO_FSDP_RULES: Rules = tuple(
    (name, () if name == "embed" else axes) for name, axes in DEFAULT_RULES
)

RULE_SETS: dict[str, Rules] = {
    "default": DEFAULT_RULES,
    "no_fsdp": NO_FSDP_RULES,
}


def rules_without_axis(rules: Rules, mesh_axis: str) -> Rules:
    """Drop one mesh axis from every rule (the reference strips ``pod``
    inside the shard_map that handles the pod axis by hand)."""
    return tuple(
        (name, tuple(a for a in axes if a != mesh_axis)) for name, axes in rules
    )


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh and rule set, every query safe on a mesh-less context.
    ``mesh`` is a ``DeviceMesh`` (anything with ``mesh_dim_names`` and
    ``shape`` resolves specs; :meth:`local_batch` also needs
    ``get_coordinate``)."""

    mesh: Optional[Any] = None
    rules: Rules = DEFAULT_RULES

    @cached_property
    def _rule_map(self) -> dict[str, tuple[str, ...]]:
        return dict(self.rules)

    @cached_property
    def _sizes(self) -> dict[str, int]:
        """Mesh axis name -> size ({} without a mesh)."""
        if self.mesh is None:
            return {}
        return dict(zip(self.mesh.mesh_dim_names, (int(n) for n in self.mesh.shape)))

    def _mesh_axes(self, logical: Any) -> tuple[str, ...]:
        """Mesh axes (present in this mesh) one logical axis maps to."""
        if self.mesh is None or logical is None:
            return ()
        rule = self._rule_map.get(logical, ())
        return tuple(a for a in rule if a in self._sizes)

    # -- size queries ------------------------------------------------------
    def axis_size(self, *names: str) -> int:
        """Product of the named mesh axes' sizes; 0 if none exist."""
        present = [self._sizes[n] for n in names if n in self._sizes]
        return math.prod(present) if present else 0

    @property
    def data_axes(self) -> tuple[str, ...]:
        return self._mesh_axes("batch")

    @property
    def model_axes(self) -> tuple[str, ...]:
        return self._mesh_axes("mlp")

    def heads_shardable(self, n: int) -> bool:
        tp = self.axis_size(*self.model_axes) if self.model_axes else 0
        return tp > 1 and n % tp == 0

    # -- specs -------------------------------------------------------------
    def spec(self, axes, shape) -> tuple:
        """The ``PartitionSpec`` content for per-dimension logical axis
        names against a shape: per dimension ``None``, one mesh axis name,
        or a tuple of them."""
        assert self.mesh is not None
        used: set[str] = set()
        parts = []
        for dim, logical in zip(shape, axes):
            cand = tuple(a for a in self._mesh_axes(logical) if a not in used)
            while cand and dim % math.prod(self._sizes[a] for a in cand):
                cand = cand[:-1]  # peel until the assignment divides evenly
            used.update(cand)
            parts.append(cand if len(cand) > 1 else (cand[0] if cand else None))
        return tuple(parts)

    def sharding(self, axes, shape) -> Optional[tuple]:
        if self.mesh is None:
            return None
        return self.spec(axes, shape)

    def param_sharding(self, spec) -> Optional[tuple]:
        """The resolved spec of one parameter declaration (``PSpec``-like:
        ``.axes`` and ``.shape``); None without a mesh.  The parameter stays
        replicated: nothing places it by this spec yet."""
        if self.mesh is None:
            return None
        return self.sharding(spec.axes, spec.shape)

    def constrain(self, x: torch.Tensor, *axes) -> torch.Tensor:
        """The identity: each rank holds its own activations."""
        return x

    # -- this rank's data ----------------------------------------------------
    def batch_index(self, global_batch: int) -> tuple[int, int]:
        """(this rank's index, the number of slices) along a batch of
        ``global_batch`` rows, over the mesh axes the ``batch`` rule
        resolves to for that size (the first axis the major one); (0, 1)
        without a mesh."""
        if self.mesh is None:
            return 0, 1
        part = self.spec(("batch",), (global_batch,))[0]
        names = () if part is None else (part,) if isinstance(part, str) else part
        coord = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        index, count = 0, 1
        for a in names:
            index = index * self._sizes[a] + int(coord[a])
            count *= self._sizes[a]
        return index, count

    def local_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``x`` along its first (batch) dimension;
        ``x`` itself without a mesh."""
        index, count = self.batch_index(x.shape[0])
        if count == 1:
            return x
        rows = x.shape[0] // count
        return x[index * rows:(index + 1) * rows]
