"""The in-place cache rule (the port's counterpart of the reference's
donation check, ``repro/audit/compiled.py``).

The reference jits its serving steps with the cache donated, and proves on
the compiled HLO that every cache leaf aliases an output buffer.  The port
runs its steps eagerly and writes the cache in place (and a CUDA graph
replays the decode step on the same buffers), so the same contract reads:

* every cache leaf keeps its storage (``data_ptr``) across the step;
* the recorded step holds no out-of-place op whose output has the shape
  of a cache state leaf (a K/V or latent stack, a recurrent state): a
  rewrite of the whole leaf into a new buffer, even one copied back.

The small per-slot leaves (``pos``, ``valid``, ``index``, the page table)
share their shapes with the step's own index arithmetic, so only their
storage is held.  Collective traffic, the other half of the reference's
compiled report, has no counterpart on one card; it waits for the ``dist``
and ``launch`` items of the port.
"""
from __future__ import annotations

import torch

from repro_torch.audit.rules import Violation
from repro_torch.audit.walker import as_ops

# a state leaf is layer-stacked: (layers, batch or pages, ...) and more
STATE_MIN_NDIM = 3


def cache_leaves(cache, prefix: str = "") -> dict[str, torch.Tensor]:
    """Path -> tensor for every tensor leaf of a cache tree (keys starting
    with ``_``, the step's own metadata, are skipped)."""
    out = {}
    if isinstance(cache, dict):
        for k, v in cache.items():
            if str(k).startswith("_"):
                continue
            out.update(cache_leaves(v, f"{prefix}{k}/"))
    elif isinstance(cache, (list, tuple)):
        for i, v in enumerate(cache):
            out.update(cache_leaves(v, f"{prefix}{i}/"))
    elif isinstance(cache, torch.Tensor):
        out[prefix.rstrip("/")] = cache
    return out


def storage_map(cache) -> dict[str, int]:
    """Path -> ``data_ptr`` of every cache leaf: take it before the step."""
    return {k: t.data_ptr() for k, t in cache_leaves(cache).items()}


def state_shapes(cache) -> dict[tuple[int, ...], str]:
    """Shape -> path of every cache state leaf (``STATE_MIN_NDIM`` dims
    or more)."""
    return {
        tuple(t.shape): k for k, t in cache_leaves(cache).items()
        if t.dim() >= STATE_MIN_NDIM
    }


def inplace_violations(before: dict[str, int], cache_after, ops=(),
                       shapes: dict | None = None) -> list[Violation]:
    """``before`` (:func:`storage_map` of the cache handed to the step)
    against the cache the step returned, and the step's recorded ``ops``
    against the state leaves' ``shapes`` (:func:`state_shapes`; taken from
    ``cache_after`` when not given)."""
    out = []
    after = storage_map(cache_after)
    for key in sorted(before):
        if key not in after:
            out.append(Violation("inplace", "dropped_cache_leaf",
                                 f"cache leaf {key!r} missing after the step"))
        elif after[key] != before[key]:
            out.append(Violation("inplace", "moved_cache_leaf",
                                 f"cache leaf {key!r} changed storage in the step"))
    for key in sorted(set(after) - set(before)):
        out.append(Violation("inplace", "new_cache_leaf",
                             f"cache leaf {key!r} appeared in the step"))
    if shapes is None:
        shapes = state_shapes(cache_after)
    for op in as_ops(ops):
        if op.opaque or op.view or op.mutates:
            continue
        for m in op.outputs:
            if m.shape in shapes:
                out.append(Violation(
                    "inplace", op.name,
                    f"out-of-place output {m.shape} has the shape of cache leaf "
                    f"{shapes[m.shape]!r}",
                ))
    return out
