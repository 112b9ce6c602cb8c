"""Host data pipeline (counterpart of ``repro/data/pipeline.py``):
deterministic sharded batches and a background prefetch.

Each process generates only its slice of the global batch (data-parallel
sharding by rank), and a batch is fully determined by ``(seed, step)``:
the properties that make an input pipeline restartable and replayable.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import torch

from repro_torch.data.synthetic import LMStreamConfig, lm_batch


def host_slice(global_batch: int) -> tuple[int, int]:
    """(this process's batch, its offset in the global batch): the rank and
    world size of ``torch.distributed`` when it is initialised, else one
    process.  Under every mesh the Trainer takes (a ``model`` axis of 1,
    the ``DeviceMesh`` row-major over ``("pod", "data")``) that is the
    rank's coordinate along the ``batch`` rule's axes."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over {n} processes")
    hb = global_batch // n
    return hb, i * hb


def lm_stream(
    vocab_size: int, seq_len: int, global_batch: int, seed: int = 0, start_step: int = 0,
    device: str | torch.device = "cuda",
) -> Iterator[dict]:
    """This process's slice of the LM stream from ``start_step`` on: step
    ``s`` yields :func:`lm_batch` of the slice's own seed
    (``seed * 1000 + offset``) at ``s`` (the reference's contract: a
    multi-process stream is not a slice of the one-process stream)."""
    hb, off = host_slice(global_batch)
    cfg = LMStreamConfig(vocab_size, seq_len, hb, seed=seed * 1000 + off)
    step = start_step
    while True:
        yield lm_batch(cfg, step, device=device)
        step += 1


def prefetch(it: Iterator, size: int = 2) -> Iterator:
    """Items of ``it`` in order, drawn ahead by a background thread into a
    queue of ``size``.  An exception in ``it`` ends the stream."""
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
