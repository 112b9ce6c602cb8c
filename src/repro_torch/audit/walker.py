"""Recorded serving steps: the port's counterpart of the reference's jaxpr
walker (``repro/audit/walker.py``).

PyTorch keeps no traced program to walk, so the audit runs a step once,
eagerly, under a ``TorchDispatchMode`` and records every aten op that
reaches dispatch, in order (:func:`record`).  ``matmul``, ``einsum`` and
``linear`` decompose before dispatch, so a product shows as ``mm``,
``bmm`` or ``addmm``.  There are no sub-programs to descend into: the run
itself unrolls every Python loop.

Each recorded :class:`Op` carries its aten name, the shapes and dtypes of
its tensor inputs and outputs, its scalar arguments, and per input the op
that wrote that tensor last (``producers``, through tensor identity) and
per tensor a storage id shared by every view of one buffer (so the
interval pass in :mod:`audit.interp` sees writes through a view).

The hand-written kernels are bound with ``ctypes``, so no dispatcher sees
a launch.  Each wrapper reports its launch to ``kernels.common.RECORDER``;
the report becomes one opaque leaf (``opaque=True``), in order with the
aten ops around it, the counterpart of an opaque ``pallas_call``: the
rules never look inside a kernel, and the census counts launches.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Callable, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import common

# The port's hand-written kernels: recorded as opaque leaves, never opened.
OPAQUE_KERNELS = frozenset({
    "lut_affine",
    "lut_affine_grouped",
    "lut_affine_experts",
    "lut_tl1",
    "lut_tl1_grouped",
    "binary_matmul",
    "bitplane_pack",
})

# creation ops whose host constant the interval pass reads (``torch.tensor``)
LIFTS = frozenset({"lift_fresh", "lift_fresh_copy"})
_CONST_NUMEL = 4096


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    shape: tuple[int, ...]
    dtype: torch.dtype
    storage: int  # one id per buffer, shared by its views


@dataclasses.dataclass(frozen=True)
class Ref:
    """Stands for the ``i``-th tensor input inside an op's ``args``."""

    i: int


@dataclasses.dataclass
class Op:
    """One recorded op: an aten op, or a kernel launch (``opaque``)."""

    name: str  # aten packet name ("mm", "add_", ...) or the kernel's name
    inputs: tuple[TensorMeta, ...]
    outputs: tuple[TensorMeta, ...]
    producers: tuple[int | None, ...]  # per input; None: a step input
    args: tuple = ()  # the call's arguments, tensors as Ref
    kwargs: dict = dataclasses.field(default_factory=dict)
    opaque: bool = False
    mutates: bool = False  # writes into an input (in place or ``out=``)
    view: bool = False
    const: tuple[float, float] | None = None  # a lifted host constant's range

    @property
    def base(self) -> str:
        """The name without an in-place underscore (``add_`` -> ``add``)."""
        n = self.name
        return n[:-1] if n.endswith("_") and not n.endswith("__") else n


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: list[Op] = []
        self._producer = WeakIdKeyDictionary()
        self._storage_of: dict[int, int] = {}  # storage base address -> id
        self._next = 0

    # -- storage ids --------------------------------------------------------
    def _new_storage(self, t: torch.Tensor) -> int:
        sid = self._next
        self._next += 1
        ptr = t.untyped_storage().data_ptr()
        if ptr:
            self._storage_of[(t.device.type, ptr)] = sid
        return sid

    def _storage(self, t: torch.Tensor) -> int:
        ptr = t.untyped_storage().data_ptr()
        key = (t.device.type, ptr)
        if ptr and key in self._storage_of:
            return self._storage_of[key]
        return self._new_storage(t)

    def _meta_in(self, t: torch.Tensor) -> TensorMeta:
        return TensorMeta(tuple(t.shape), t.dtype, self._storage(t))

    def _meta_out(self, t: torch.Tensor, in_storages: set) -> TensorMeta:
        """An output shares its buffer's id with the input it aliases (a
        view, an in-place or ``out=`` write); any other output is a new
        buffer, also where the allocator reuses a freed address."""
        key = (t.device.type, t.untyped_storage().data_ptr())
        sid = self._storage_of.get(key) if key[1] else None
        if sid is None or sid not in in_storages:
            sid = self._new_storage(t)
        return TensorMeta(tuple(t.shape), t.dtype, sid)

    # -- recording ----------------------------------------------------------
    def _add(self, name, inputs, outputs, args=(), kwargs=None, opaque=False,
             mutates=False, view=False, const=None):
        in_meta = tuple(self._meta_in(t) for t in inputs)
        producers = tuple(self._producer.get(t) for t in inputs)
        in_storages = {m.storage for m in in_meta}
        out_meta = tuple(self._meta_out(t, in_storages) for t in outputs)
        idx = len(self.ops)
        self.ops.append(Op(name, in_meta, out_meta, producers, args, kwargs or {},
                           opaque, mutates, view, const))
        for t in outputs:
            self._producer[t] = idx

    def kernel(self, name: str, inputs: tuple, outputs: tuple, **facts) -> None:
        """``kernels.common.RECORDER``: one launch, or one collective, as an
        opaque leaf; a collective's ``facts`` (op, group size, ...) go into
        the leaf's ``kwargs``."""
        ins = [t for t in inputs if isinstance(t, torch.Tensor)]
        outs = [t for t in outputs if isinstance(t, torch.Tensor)]
        self._add(name, ins, outs, kwargs=facts, opaque=True, mutates=True)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            return out  # a collective: its wrapper reports it as one leaf
        flat_in, _ = tree_flatten((args, kwargs))
        inputs = [t for t in flat_in if isinstance(t, torch.Tensor)]
        pos = {id(t): i for i, t in reversed(list(enumerate(inputs)))}

        def ref(x):
            return Ref(pos[id(x)]) if isinstance(x, torch.Tensor) else x

        flat_out, _ = tree_flatten(out)
        outputs = [t for t in flat_out if isinstance(t, torch.Tensor)]
        schema = func._schema
        name = func.overloadpacket.__name__
        const = None
        if name in LIFTS and inputs and inputs[0].numel() <= _CONST_NUMEL:
            const = _host_range(inputs[0])
        self._add(
            name, inputs, outputs, tree_map(ref, tuple(args)),
            {k: tree_map(ref, v) for k, v in kwargs.items()},
            mutates=schema.is_mutable, view=func.is_view, const=const,
        )
        return out


def _host_range(t: torch.Tensor) -> tuple[float, float] | None:
    if t.device.type != "cpu" or t.numel() == 0 or t.dtype == torch.bool:
        return (0.0, 1.0) if t.dtype == torch.bool else None
    v = t.detach().to(torch.float64)
    lo, hi = float(v.min()), float(v.max())
    if lo != lo or hi != hi:
        return None
    return lo, hi


def record(fn: Callable, *args, **kwargs) -> tuple[Any, list[Op]]:
    """Run ``fn(*args, **kwargs)`` once and return ``(its result, the
    recorded ops)``: every aten op that reached dispatch, and every kernel
    launch the wrappers reported, in the order they ran."""
    if common.RECORDER is not None:
        raise RuntimeError("a recording is already active")
    rec = _Recorder()
    common.RECORDER = rec.kernel
    # the plain versions' device scales start empty, so a recording shows
    # each one's making whatever ran before it (the engine's tensors stay)
    scales, common.SCALES = common.SCALES, {}
    try:
        with rec:
            out = fn(*args, **kwargs)
    finally:
        common.RECORDER = None
        common.SCALES = scales
    return out, rec.ops


def as_ops(ops: Iterable[Op]) -> list[Op]:
    """The recorded op list, materialised once (pass-through for a list),
    so every rule over one point shares one recording."""
    return ops if isinstance(ops, list) else list(ops)


def op_census(ops: Iterable[Op]) -> dict[str, int]:
    """Op name -> occurrences over the recording, sorted by name so the
    manifest diffs it across commits.  A kernel launch counts under the
    kernel's name."""
    counts = Counter(op.name for op in as_ops(ops))
    return dict(sorted(counts.items()))


def kernel_leaves(ops: Iterable[Op]) -> dict[str, int]:
    """Kernel name -> opaque leaves in the recording."""
    return dict(sorted(Counter(op.name for op in as_ops(ops) if op.opaque).items()))
