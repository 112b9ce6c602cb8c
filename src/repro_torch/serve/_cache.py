"""Dense decode cache for the GQA decoder (counterpart of the dense half of
``repro/serve/_cache.py``).

Layout: ``k``/``v`` ``(L, B, T, n_kv, head_dim)`` with T = max_len, plus
``pos`` (B, T) absolute position per slot, ``valid`` (B, T) and ``index``
(B,), the next write offset per slot.

Writes keep the reference's semantics with direct indexing in place of
its one-hot contractions: a masked token writes nothing and does not
advance ``index``; a write whose slot falls at or past T is dropped and
flags the row's ``overflow``, which the serving layer raises on
(:class:`CacheOverflowError`); the ``S == T`` fresh-row fast path
overwrites whole rows whose pre-write index is 0 and rejects any other row
as a unit.  Sliding-window rings and pages come with their slices.

Every write lands in place, in the buffer the cache was made with, never
in a new tensor bound to its key: a CUDA graph captured over a step reads
and writes fixed addresses, so only then does its replay see the step's
own updates (the counterpart of the reference's donated cache).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import PSpec


class CacheOverflowError(ValueError):
    """A cache write would land past the sequence capacity T."""


class CacheWrite(NamedTuple):
    """Typed result of :func:`advance_meta`: everything a per-layer write
    needs.  ``slots`` (B, S) explicit write slots; ``mask`` (B, S) bool or
    None; ``positions`` written; ``overflow`` (B,) accumulated flags or
    None; ``pos``/``valid`` post-write metadata; ``index`` the PRE-write
    per-slot offset (gates the fresh-row fast path)."""

    slots: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None
    overflow: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    index: Optional[torch.Tensor] = None


def cache_specs(
    cfg: ModelConfig, batch: int, max_len: int, page_size: int | None = None
) -> dict:
    """PSpec tree for a fresh dense decode cache."""
    if page_size is not None:
        raise NotImplementedError("paged caches come with the paging slice")
    if (
        cfg.family not in ("dense", "moe")
        or cfg.attention != "gqa"
        or cfg.sliding_window
    ):
        raise NotImplementedError(
            f"{cfg.family}/{cfg.attention} caches and sliding-window rings come "
            "with their family's slice"
        )
    kv = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "seq_kv", None, None)
    meta = ("batch", "seq_kv")
    return {
        "pos": PSpec((batch, max_len), meta, init="zeros", dtype=torch.int32),
        "valid": PSpec((batch, max_len), meta, init="zeros", dtype=torch.bool),
        "index": PSpec((batch,), ("batch",), init="zeros", dtype=torch.int32),
        "layers": {
            "k": PSpec(kv, axes, init="zeros"),
            "v": PSpec(kv, axes, init="zeros"),
        },
    }


def scatter_rows(
    buf: torch.Tensor, new: torch.Tensor, slots: torch.Tensor, ok: torch.Tensor
) -> None:
    """In place ``buf[b, slots[b, s]] = new[b, s]`` where ``ok[b, s]``.

    ``buf`` is (B, T, ...), ``new`` (B, S, ...).  Rejected tokens write
    back the value already in their slot, so nothing syncs with the host.
    A row's slots are consecutive, hence distinct mod T over any T tokens;
    tokens past the first T are always out of range, so they are cut
    first."""
    T = buf.shape[1]
    if slots.shape[1] > T:
        slots, new, ok = slots[:, :T], new[:, :T], ok[:, :T]
    tail = buf.shape[2:]
    idx = torch.remainder(slots, T).to(torch.int64)
    idx = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    cur = torch.gather(buf, 1, idx)
    keep = ok.reshape(ok.shape + (1,) * len(tail))
    buf.scatter_(1, idx, torch.where(keep, new.to(buf.dtype), cur))


def advance_meta(
    cache: dict,
    positions: torch.Tensor,
    window: int | None,
    token_mask: torch.Tensor | None = None,
) -> tuple[dict, CacheWrite]:
    """Advance pos/valid/index (and ``overflow`` where the cache has it)
    for the S tokens written this step, each in its own buffer, and return
    ``(cache, write)``.  ``window`` must be None here."""
    if window is not None:
        raise NotImplementedError("sliding-window rings come with the mixtral slice")
    S = positions.shape[1]
    T = cache["pos"].shape[1]
    index = cache["index"].clone()  # the pre-write offsets, kept past the advance
    slots = index[:, None] + torch.arange(S, dtype=torch.int32, device=index.device)
    over = slots >= T
    if token_mask is not None:
        over = over & token_mask
    overflow = cache.get("overflow")
    meta_mask = token_mask
    if token_mask is None and S == T:
        # the per-layer writes take the whole-row fast path, which cannot
        # express a partially in-range write: suppress those rows' pos/valid
        # too (their overflow is flagged)
        meta_mask = (index == 0)[:, None].expand(slots.shape)
    ok = slots < T
    if meta_mask is not None:
        ok = ok & meta_mask
    scatter_rows(cache["pos"], positions.to(torch.int32), slots, ok)
    scatter_rows(cache["valid"], torch.ones_like(ok), slots, ok)
    adv = token_mask.sum(1).to(torch.int32) if token_mask is not None else S
    cache["index"].add_(adv)
    if overflow is not None:
        overflow |= over.any(1)
    write = CacheWrite(
        slots=slots,
        mask=token_mask,
        positions=positions,
        overflow=overflow,
        pos=cache["pos"],
        valid=cache["valid"],
        index=index,
    )
    return cache, write


def update_kv_cache(cache: dict, k, v, positions, ctx) -> tuple[Any, ...]:
    """Write new K/V (B, S, ...) into one layer's cache views in place and
    return ``(k_all, v_all, pos, valid)``, the views decode attends over."""
    w: CacheWrite = cache["_meta"]
    T = cache["k"].shape[1]
    if w.slots.shape[1] == T and w.mask is None:
        fresh = (w.index == 0).reshape(-1, 1, 1, 1)
        for name, new in (("k", k), ("v", v)):
            buf = cache[name]
            buf.copy_(torch.where(fresh, new.to(buf.dtype), buf))
    else:
        ok = w.slots < T
        if w.mask is not None:
            ok = ok & w.mask
        scatter_rows(cache["k"], k, w.slots, ok)
        scatter_rows(cache["v"], v, w.slots, ok)
    return cache["k"], cache["v"], w.pos, w.valid
