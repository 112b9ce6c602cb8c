"""Decode caches for the dense decoder, GQA and MLA, RWKV-6's O(1)
recurrent state, the zamba2 hybrid's and the enc-dec family's (counterpart
of ``repro/serve/_cache.py``).

RWKV-6 (``family="ssm"``) keeps per layer its token-shift states
``shift_a`` / ``shift_c`` (L, B, d) and its WKV state ``wkv`` (L, B, H,
head_dim, head_dim), plus ``index``: no ring, no ``pos``/``valid``, no
pages (``page_size`` raises).  The zamba2 hybrid (``family="hybrid"``)
keeps per mamba layer the causal conv's window ``layers.conv`` (L, B, K -
1, conv_dim) and the SSD state ``layers.state`` (L, B, H, P, N), and per
invocation of its shared attention block the K/V ``shared_attn.k`` /
``.v`` (n_shared, B, T, n_kv, head_dim), dense or paged, beside
``pos``/``valid``/``index``.

The enc-dec family (``family="encdec"``, whisper) keeps its decoder's
self K/V ``layers.k`` / ``.v`` (L, B, T, n_kv, head_dim), dense or paged,
beside ``pos``/``valid``/``index``, and the static cross K/V ``cross.k``
/ ``.v`` (L, B, S_enc, n_kv, head_dim), dense whatever the paging, which
the prefill writes in place and decode steps only read.

The recurrent states and the cross K/V are fp32 whatever the cache's
dtype: the reference declares the token-shift states and the conv window
in the cache's dtype, but its forward returns them in the activations'
dtype and carries them so after the first write; an fp32 buffer holds
that carry exactly, and the models cast it to the activations' dtype on
read.  The reference declares the cross K/V at (L, B, max_len, ...) in the
cache's dtype, and its prefill binds fp32 (L, B, S_enc, ...) stacks in
their place: a bf16 buffer of max_len would round the keys and attend over
zero keys past S_enc, or could not hold S_enc > max_len frames.  The port sizes
the cross leaves from the frames' count when the cache is made
(``cache_specs(..., enc_len=)``; ``generate`` passes its
``enc_embeds.shape[1]``) and writes them in place, which holds the
reference's values and keeps every cache buffer the one the cache was
made with (below).

Dense layout: per layer-stacked leaf ``(L, B, T, ...)`` with T = max_len --
GQA's ``k``/``v`` ``(L, B, T, n_kv, head_dim)``, MLA's latent ``c_kv``
``(L, B, T, kv_lora)`` and shared ``k_rope`` ``(L, B, T, rope_dim)`` --
plus ``pos`` (B, T) absolute position per slot, ``valid`` (B, T) and
``index`` (B,), the next write offset per slot.

Paged layout (``cache_specs(..., page_size=)``): the leaves are a pool of
fixed-size pages shared by all slots, ``(L, num_pages + 1, page_size,
...)``, behind a ``page_table`` (B, max_pages) int32 that maps
each slot's logical page group to a physical page (-1 = unmapped).
``pos``/``valid``/``index`` keep their dense (B, T) shapes, T = max_pages
* page_size.  The pool's last page is a *sink* that no allocator maps:
every token that writes nothing (masked, past T, or in an unmapped page)
is routed there, so a write is one scatter whose valid targets are
distinct -- a slot owns the pages it writes (copy-on-write duplicates a
shared page first) -- and no valid write can collide with a dropped one.
Allocation is the serving layer's job (``serve/_paging.py``).

Writes keep the reference's semantics with direct indexing in place of
its one-hot contractions: a masked token writes nothing and does not
advance ``index``; a write whose slot falls at or past T, or whose page is
unmapped, is dropped and flags the row's ``overflow``, which the serving
layer raises on (:class:`CacheOverflowError`); the dense ``S == T``
fresh-row fast path overwrites whole rows whose pre-write index is 0 and
rejects any other row as a unit.

Sliding-window models keep a ring: T = min(window, max_len) (paged: a
whole number of pages), a token at absolute position p lands in slot
``p % T``, a write longer than T keeps its last T tokens, and nothing
overflows -- ``pos`` keeps each slot's absolute position, so the window
mask reads the ring's order from it.

Every write lands in place, in the buffer the cache was made with, never
in a new tensor bound to its key, and nothing is read back to the host: a
CUDA graph captured over a step reads and writes fixed addresses, so only
then does its replay see the step's own updates (the counterpart of the
reference's donated cache).  The engine updates ``page_table`` in place
too, between steps.
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
    needs.  ``slots`` (B, S) explicit write slots (a ring's: its last T
    tokens'); ``mask`` (B, S) bool or None (paged: tokens whose page is
    unmapped are masked out here too);
    ``positions`` written; ``overflow`` (B,) accumulated flags or None;
    ``pos``/``valid`` post-write metadata; ``index`` the PRE-write per-slot
    offset (gates the fresh-row fast path).  Paged caches also carry
    ``page_ids`` (B, S) the physical page per token (-1 = dropped),
    ``page_offsets`` (B, S) the offset in it, ``page_table`` the slot ->
    page map, and what every layer's write and view reuse, computed once a
    step: ``page_rows`` (B * S,) the flat pool row each token lands in
    (:func:`write_rows`), ``view_pages`` (B * max_pages,) and
    ``view_mapped`` (B, max_pages) the pages the views gather
    (:func:`view_index`)."""

    slots: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None
    overflow: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None
    index: Optional[torch.Tensor] = None
    page_ids: Optional[torch.Tensor] = None
    page_offsets: Optional[torch.Tensor] = None
    page_table: Optional[torch.Tensor] = None
    page_rows: Optional[torch.Tensor] = None
    view_pages: Optional[torch.Tensor] = None
    view_mapped: Optional[torch.Tensor] = None


def cache_specs(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    page_size: int | None = None,
    num_pages: int | None = None,
    enc_len: int | None = None,
) -> dict:
    """PSpec tree for a fresh decode cache.

    With ``page_size`` set, the leaves are paged: (L, num_pages + 1,
    page_size, ...) -- the last page the sink -- plus a (batch, max_pages)
    int32 ``page_table``.  ``num_pages`` (the pages an allocator may map)
    defaults to ``batch * max_pages``: every slot can hold a full
    rectangle, and prefix sharing only shrinks from there.  The capacity
    T -- ``max_len``, or a sliding-window model's ring ``min(window,
    max_len)`` -- must be a whole number of pages.  The hybrid's K/V
    leaves (its shared block's, one per invocation) are the ones paged; its
    SSD states stay per slot.  The enc-dec family's decoder self K/V are
    paged; its cross K/V, ``enc_len`` (the encoder's frames) long, stay
    dense."""
    if cfg.family == "ssm":
        return _rwkv_cache_specs(cfg, batch, page_size)
    families = ("dense", "moe", "vlm", "hybrid", "encdec")
    if cfg.family not in families or cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.family}/{cfg.attention} caches come with their family's slice"
        )
    T = max_len if cfg.sliding_window is None else min(cfg.sliding_window, max_len)
    hybrid = cfg.family == "hybrid"
    kv_layers = _num_shared_invocations(cfg) if hybrid else cfg.num_layers
    lead = (kv_layers, batch, T)
    axes = ("layers", "batch", "seq_kv")
    meta = ("batch", "seq_kv")
    tree = {
        "pos": PSpec((batch, T), meta, init="zeros", dtype=torch.int32),
        "valid": PSpec((batch, T), meta, init="zeros", dtype=torch.bool),
        "index": PSpec((batch,), ("batch",), init="zeros", dtype=torch.int32),
    }
    if page_size is not None:
        if T % page_size:
            raise ValueError(
                f"cache capacity {T} must be a whole number of pages "
                f"(page_size {page_size}); pad max_len or the window"
            )
        max_pages = T // page_size
        if num_pages is None:
            num_pages = batch * max_pages
        lead = (kv_layers, num_pages + 1, page_size)
        axes = ("layers", "seq_kv", None)
        tree["page_table"] = PSpec(
            (batch, max_pages), ("batch", None), init="zeros", dtype=torch.int32
        )
    if cfg.attention == "mla":
        tails = {"c_kv": (cfg.kv_lora_rank,), "k_rope": (cfg.qk_rope_head_dim,)}
    else:
        kv = (cfg.num_kv_heads, cfg.head_dim)
        tails = {"k": kv, "v": kv}
    kv_tree = {
        name: PSpec(lead + tail, axes + (None,) * len(tail), init="zeros")
        for name, tail in tails.items()
    }
    if hybrid:
        tree["layers"] = _ssd_state_specs(cfg, batch)
        tree["shared_attn"] = kv_tree
    else:
        tree["layers"] = kv_tree
    if cfg.family == "encdec":
        tree["cross"] = _cross_specs(cfg, batch, enc_len)
    return tree


def _cross_specs(cfg: ModelConfig, batch: int, enc_len: int | None) -> dict:
    """The enc-dec family's static cross K/V ``cross.k`` / ``.v`` (L, B,
    enc_len, n_kv, head_dim), fp32, dense whatever the paging (the module
    docstring says why)."""
    if enc_len is None:
        raise ValueError("an enc-dec cache needs enc_len, the encoder frames' count")
    shape = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "seq_kv", None, None)
    return {name: PSpec(shape, axes, init="zeros", dtype=torch.float32) for name in ("k", "v")}


def _num_shared_invocations(cfg: ModelConfig) -> int:
    if not cfg.shared_attn_every:
        return 0
    return cfg.num_layers // cfg.shared_attn_every


def _ssd_state_specs(cfg: ModelConfig, batch: int) -> dict:
    """The hybrid's per-mamba-layer state: the causal conv's window
    ``conv`` (B, K - 1, conv_dim) and the SSD state ``state`` (B, H, P, N),
    both fp32 (the module docstring says why for ``conv``)."""
    L, conv_dim = cfg.num_layers, cfg.d_inner + 2 * cfg.ssm_state
    f32 = torch.float32
    return {
        "conv": PSpec((L, batch, cfg.conv_kernel - 1, conv_dim),
                      ("layers", "batch", None, None), init="zeros", dtype=f32),
        "state": PSpec((L, batch, cfg.mamba_heads, cfg.mamba_head_dim, cfg.ssm_state),
                       ("layers", "batch", "heads", None, None), init="zeros", dtype=f32),
    }


def _rwkv_cache_specs(cfg: ModelConfig, batch: int, page_size: int | None) -> dict:
    """RWKV-6's O(1) state: per layer the token-shift states ``shift_a`` and
    ``shift_c`` (B, d) and the WKV state ``wkv`` (B, H, K, V), all fp32 (the
    module docstring says why for the shift states), and ``index``; no
    ``pos``/``valid`` ring and nothing to page."""
    if page_size is not None:
        raise ValueError("page_size is meaningless for O(1)-state families")
    L, H, hd = cfg.num_layers, cfg.rwkv_heads, cfg.rwkv_head_dim
    shift_axes = ("layers", "batch", None)
    f32 = torch.float32
    return {
        "index": PSpec((batch,), ("batch",), init="zeros", dtype=torch.int32),
        "layers": {
            "shift_a": PSpec((L, batch, cfg.d_model), shift_axes, init="zeros", dtype=f32),
            "shift_c": PSpec((L, batch, cfg.d_model), shift_axes, init="zeros", dtype=f32),
            "wkv": PSpec((L, batch, H, hd, hd), ("layers", "batch", "heads", None, None),
                         init="zeros", dtype=f32),
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
    first (a ring's write was cut to its last T before it came here)."""
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
    ``(cache, write)``.  For paged caches the write also carries each
    token's (page, offset), resolved through its slot's ``page_table`` row;
    a token whose slot is past T or whose page is unmapped is dropped from
    the write mask and flags ``overflow``.

    With a ``window`` the cache is a ring: the write keeps the last T of
    the S tokens (``positions`` and the mask cut to them; T consecutive
    positions are distinct mod T), its slots are ``positions % T``, and no
    slot is past T -- only an unmapped page flags ``overflow``.

    An O(1)-state cache (RWKV-6: no ``pos``) advances ``index`` only: by S,
    or by each row's real tokens under ``token_mask``."""
    if "pos" not in cache:
        index = cache["index"].clone()
        adv = positions.shape[1] if token_mask is None else token_mask.sum(1).to(torch.int32)
        cache["index"].add_(adv)
        return cache, CacheWrite(positions=positions, index=index)
    T = cache["pos"].shape[1]
    paged = "page_table" in cache
    index = cache["index"].clone()  # the pre-write offsets, kept past the advance
    S = positions.shape[1]
    adv = S if token_mask is None else token_mask.sum(1).to(torch.int32)
    mask = token_mask
    if window is not None and S > T:
        positions = positions[:, -T:]
        mask = mask[:, -T:] if mask is not None else None
        S = T
    if window is not None:
        slots = torch.remainder(positions, T).to(torch.int32)
    else:
        slots = index[:, None] + torch.arange(S, dtype=torch.int32, device=index.device)
    over = slots >= T
    if mask is not None:
        over = over & mask
    overflow = cache.get("overflow")
    meta_mask = mask
    if mask is None and S == T and not paged and window is None:
        # the per-layer writes take the whole-row fast path, which cannot
        # express a partially in-range write: suppress those rows' pos/valid
        # too (their overflow is flagged)
        meta_mask = (index == 0)[:, None].expand(slots.shape)
    page_ids = page_offsets = table = rows = view_pages = view_mapped = None
    if paged:
        table = cache["page_table"]
        max_pages = table.shape[1]
        page_size = T // max_pages
        grp = torch.clamp(slots // page_size, 0, max_pages - 1)
        page_offsets = slots % page_size
        pid = torch.gather(table, 1, grp.to(torch.int64))
        dropped = (slots >= T) | (pid < 0)
        if mask is not None:
            dropped = dropped & mask
        over = dropped
        page_ids = torch.where(dropped, -1, pid)
        mask = meta_mask = ~dropped if mask is None else mask & ~dropped
        sink = pool_pages(cache)  # the sink is the page past the mappable ones
        rows = write_rows(page_ids, page_offsets, mask, sink, page_size)
        view_pages, view_mapped = view_index(table)
    ok = slots < T
    if meta_mask is not None:
        ok = ok & meta_mask
    scatter_rows(cache["pos"], positions.to(torch.int32), slots, ok)
    scatter_rows(cache["valid"], torch.ones_like(ok), slots, ok)
    cache["index"].add_(adv)
    if overflow is not None:
        overflow |= over.any(1)
    write = CacheWrite(
        slots=slots,
        mask=mask,
        positions=positions,
        overflow=overflow,
        pos=cache["pos"],
        valid=cache["valid"],
        index=index,
        page_ids=page_ids,
        page_offsets=page_offsets,
        page_table=table,
        page_rows=rows,
        view_pages=view_pages,
        view_mapped=view_mapped,
    )
    return cache, write


def pool_pages(cache: dict) -> int:
    """The pages of a paged cache's pool that an allocator may map: every
    paged leaf's second dimension (the hybrid's: its ``shared_attn``), less
    the sink."""
    paged = cache.get("shared_attn", cache["layers"])
    return next(iter(paged.values())).shape[1] - 1


def write_rows(
    page_ids: torch.Tensor,
    page_offsets: torch.Tensor,
    mask: torch.Tensor,
    sink: int,
    page_size: int,
) -> torch.Tensor:
    """The flat rows (``page * page_size + offset``, int64, (B * S,)) of a
    layer's pool viewed as (pages * page_size, ...) that the (B, S) tokens
    write: the token's page where ``mask``, else the sink page.  The valid
    targets are distinct by the allocator's contract, so they never share
    a row with a dropped token."""
    pages = torch.where(mask, page_ids, sink).to(torch.int64)
    return (pages * page_size + page_offsets).reshape(-1)


def view_index(page_table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(pages, mapped)`` for :func:`paged_view`: the table's pages, -1
    clamped to page 0, flat int64 (B * max_pages,), and which groups are
    mapped (B, max_pages)."""
    pages = torch.clamp(page_table, min=0).reshape(-1).to(torch.int64)
    return pages, page_table >= 0


def paged_write(buf: torch.Tensor, new: torch.Tensor, rows: torch.Tensor) -> None:
    """In place, write ``new`` (B, S, ...) into one layer's pool ``buf``
    (num_pages + 1, page_size, ...) at the flat ``rows`` of
    :func:`write_rows`."""
    tail = buf.shape[2:]
    buf.view((-1,) + tail).index_copy_(0, rows, new.reshape((-1,) + tail).to(buf.dtype))


def paged_view(buf: torch.Tensor, pages: torch.Tensor, mapped: torch.Tensor) -> torch.Tensor:
    """The (B, T, ...) logical view of one layer's pool ``buf`` (pages,
    page_size, ...) through :func:`view_index`'s ``pages`` and ``mapped``:
    a gather of each slot's pages; unmapped groups read as zeros, as the
    reference's one-hot gather gives them (``valid`` masks them
    downstream)."""
    B, max_pages = mapped.shape
    page_size, tail = buf.shape[1], buf.shape[2:]
    got = buf.index_select(0, pages).view((B, max_pages, page_size) + tail)
    got = torch.where(mapped.view((B, max_pages) + (1,) * (1 + len(tail))), got, 0)
    return got.view((B, max_pages * page_size) + tail)


def copy_pages(buf: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> None:
    """In place, copy whole pages ``src[i] -> dst[i]`` of a layer-stacked
    pool (L, num_pages + 1, page_size, ...): the device half of
    copy-on-write, run before the divergent tail is written over the copy.
    A -1 pair (src and dst are -1 together) copies the sink onto itself,
    which changes no page an allocator maps; nothing is read back."""
    sink = buf.shape[1] - 1
    s = torch.where(src < 0, sink, src).to(torch.int64)
    d = torch.where(dst < 0, sink, dst).to(torch.int64)
    buf.index_copy_(1, d, buf.index_select(1, s))


def _update_leaves(cache: dict, new: dict, window: int | None = None) -> tuple:
    """Write each ``new[name]`` (B, S, ...) into the layer's cache view
    ``cache[name]`` in place and return the views attended over, in
    ``new``'s order (paged: gathered through the page table after the
    write).  Each leaf keeps the tokens the write has slots for: a ring
    (``window`` set) its last T.  The dense ``S == T`` fast path, which a
    ring never takes, overwrites whole fresh rows (pre-write index 0) and
    leaves every other row as it was."""
    w: CacheWrite = cache["_meta"]
    S_w = w.slots.shape[1]
    new = {name: t[:, -S_w:] for name, t in new.items()}
    if w.page_rows is not None:
        for name, t in new.items():
            paged_write(cache[name], t, w.page_rows)
        return tuple(paged_view(cache[name], w.view_pages, w.view_mapped) for name in new)
    T = w.pos.shape[1]
    if S_w == T and w.mask is None and window is None:
        for name, t in new.items():
            buf = cache[name]
            fresh = (w.index == 0).reshape((-1,) + (1,) * (buf.dim() - 1))
            buf.copy_(torch.where(fresh, t.to(buf.dtype), buf))
    else:
        ok = w.slots < T
        if w.mask is not None:
            ok = ok & w.mask
        for name, t in new.items():
            scatter_rows(cache[name], t, w.slots, ok)
    return tuple(cache[name] for name in new)


def update_kv_cache(cache: dict, k, v, positions, ctx) -> tuple[Any, ...]:
    """Write new K/V (B, S, ...) into one layer's cache views in place and
    return ``(k_all, v_all, pos, valid)``, the views decode attends over
    (paged: gathered through the page table after the write)."""
    w: CacheWrite = cache["_meta"]
    leaves = _update_leaves(cache, {"k": k, "v": v}, ctx.cfg.sliding_window)
    return (*leaves, w.pos, w.valid)


def update_mla_cache(cache: dict, c_kv, k_rope, positions, ctx) -> tuple[Any, ...]:
    """MLA's :func:`update_kv_cache`: write the latent ``c_kv`` (B, S,
    kv_lora) and the shared ``k_rope`` (B, S, rope_dim) into one layer's
    cache views in place and return ``(c_all, r_all, pos, valid)``."""
    w: CacheWrite = cache["_meta"]
    return (*_update_leaves(cache, {"c_kv": c_kv, "k_rope": k_rope}), w.pos, w.valid)
