"""Atomic checkpoints (counterpart of ``repro/dist/checkpoint.py``), in the
reference's format on disk, so either package restores what the other
saved.

Layout: ``<dir>/step_00000123/`` holding ``arrays.npz`` (entry ``leaf_i``:
leaf ``i`` of the tree in JAX's flatten order, dict keys sorted, as its raw
bytes in a uint8 array) and ``meta.json`` (``step``, each leaf's ``dtype``
and ``shape``, and an optional JSON ``aux`` payload).  A bf16 leaf is
written under the dtype string ``"bfloat16"``, its bytes taken through
torch (numpy has no bf16).

* **atomic**: writes land in a ``.tmp_*`` sibling that is renamed into
  place; a step directory without ``meta.json`` is never picked up, and a
  step being replaced is parked aside until its replacement is committed.
* **placement**: checkpoints store whole tensors, and
  :func:`restore_checkpoint` puts each on the device of the ``like`` leaf.
* **GC**: ``keep_last=N`` prunes all but the newest N steps after a
  successful commit.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_flatten

_PREFIX = "step_"

# dtype string (numpy's name, and "bfloat16" as ml_dtypes names it) <-> torch
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{step:08d}")


def _raw(leaf) -> tuple[np.ndarray, str, list[int]]:
    """(raw bytes as a uint8 array, dtype string, shape) of one tensor leaf
    on any device."""
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"checkpoint leaves are tensors, got {type(leaf).__name__}")
    if leaf.dtype not in _NAMES:
        raise TypeError(f"no checkpoint dtype for {leaf.dtype}")
    t = leaf.detach().contiguous().cpu()
    raw = t.reshape(-1).view(torch.uint8).numpy()
    return raw, _NAMES[leaf.dtype], list(t.shape)


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    keep_last: Optional[int] = None,
    aux: Optional[dict] = None,
) -> str:
    """Commit ``tree`` (a nested dict / list / tuple of tensors) as
    ``step``; returns the step's directory.

    ``aux`` is an optional JSON-serializable payload committed atomically
    with the arrays (inside ``meta.json``), e.g. a serialized
    ``core.planner.ModelPlan``, so that a converted model restores with the
    plans it was built with.  Read it back with :func:`load_aux`."""
    os.makedirs(directory, exist_ok=True)
    leaves, _ = tree_flatten(tree)
    raws = [_raw(leaf) for leaf in leaves]
    tmp = tempfile.mkdtemp(prefix=".tmp_", dir=directory)
    try:
        np.savez(
            os.path.join(tmp, "arrays.npz"),
            **{f"leaf_{i}": raw for i, (raw, _, _) in enumerate(raws)},
        )
        recs = [{"dtype": dtype, "shape": shape} for _, dtype, shape in raws]
        meta = {"step": step, "leaves": recs}
        if aux is not None:
            meta["aux"] = aux
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        final = _step_dir(directory, step)
        aside = None
        if os.path.exists(final):
            # never delete a committed step before its replacement lands: a
            # crash in between would lose it; park it aside instead
            aside = tmp + ".old"
            os.rename(final, aside)
        os.rename(tmp, final)  # the commit point
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if aside is not None:
        shutil.rmtree(aside, ignore_errors=True)
    if keep_last is not None:
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        steps = sorted(_list_steps(directory))
        # max(0, ...): the reference's slice deletes steps while fewer than
        # keep_last exist (a negative end counts from the back)
        for old in steps[: max(0, len(steps) - keep_last)]:
            shutil.rmtree(_step_dir(directory, old), ignore_errors=True)
    return _step_dir(directory, step)


def _list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith(_PREFIX):
            continue
        if not os.path.exists(os.path.join(directory, name, "meta.json")):
            continue  # partial / corrupt: never committed
        try:
            steps.append(int(name[len(_PREFIX):]))
        except ValueError:
            continue
    return steps


def latest_step(directory: str) -> Optional[int]:
    """Newest committed step, or None for a missing, empty or partial-only
    directory."""
    steps = _list_steps(directory)
    return max(steps) if steps else None


def load_aux(directory: str, step: int) -> Optional[dict]:
    """The ``aux`` payload committed with ``step`` (None if absent)."""
    with open(os.path.join(_step_dir(directory, step), "meta.json")) as f:
        return json.load(f).get("aux")


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Restore ``step`` as a tree shaped like ``like`` (a tree of tensors),
    each leaf on the device of its ``like`` tensor.  Raises ``ValueError``
    when the leaf count, a shape or a dtype differs from ``like``'s."""
    path = _step_dir(directory, step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    like_leaves, unflatten = tree_flatten(like)
    if len(like_leaves) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint {path} has {len(meta['leaves'])} leaves, "
            f"restore target has {len(like_leaves)}"
        )
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for i, (rec, leaf) in enumerate(zip(meta["leaves"], like_leaves)):
            if rec["dtype"] not in _DTYPES:
                raise ValueError(f"leaf {i}: no torch dtype for {rec['dtype']!r}")
            dtype = _DTYPES[rec["dtype"]]
            raw = torch.from_numpy(z[f"leaf_{i}"])
            t = raw.view(dtype) if raw.numel() else torch.empty(0, dtype=dtype)
            t = t.reshape(rec["shape"])
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"leaf {i}: restore target is {type(leaf).__name__}, "
                                "not a tensor")
            if t.shape != leaf.shape:
                raise ValueError(
                    f"leaf {i}: checkpoint shape {tuple(t.shape)} != "
                    f"target shape {tuple(leaf.shape)}"
                )
            if leaf.dtype != dtype:
                raise ValueError(
                    f"leaf {i}: checkpoint dtype {rec['dtype']} != target dtype {leaf.dtype}"
                )
            out.append(t.to(leaf.device))
    return unflatten(out)
