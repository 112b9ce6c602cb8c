"""Serving engine: a device-resident batched scheduler over slot caches
(counterpart of the dense half of ``repro/serve/_engine.py``).

Pass converted params (``core.convert.convert_params``, ideally planned by
``core.planner.plan_model``) and every converted projection runs on the
Hopper kernels; ``ExecCfg(lut_grouped=True)`` fuses each pre-stacked group
into one grouped launch.  The scheduler is agnostic to all of it.

``BatchingEngine`` keeps the reference's contracts:

* Per-slot state (``slot_active`` / ``slot_remaining`` / ``slot_key`` /
  ``next_tok`` / ``overflow``) lives in the cache, on the device; the
  cache is updated in place by both steps.
* Sampling runs on the device; non-greedy draws are keyed by
  ``fold(slot_key, index)`` with ``slot_key = fold(seed, uid)``, so a
  sampled stream depends only on (seed, uid, position) and is the same
  under batched and per-slot admission.
* Admission right-pads up to ``num_slots`` queued prompts into one masked
  prefill that writes each prompt into its slot (``admit="per-slot"``
  admits one request per prefill instead).
* Each step returns a packed (B, 3) int32 ``[token, done, overflow]``
  that the host reads back once (``readbacks`` counts them); an overflow
  flag raises :class:`CacheOverflowError`.
* On a CUDA device the decode step is captured once as a CUDA graph and
  replayed (the counterpart of the reference's ``jax.jit`` with a donated
  cache): its shapes (``num_slots`` x 1 token) and sampling mode are fixed
  per engine, and both steps write the cache in place.  Admission prefill
  and :func:`generate` stay eager.  The kernels' launch counts are kept
  per replay (``kernels/common.py::replay_counted``).

``generate`` and ``BatchingEngine`` serve GQA and (minicpm3) MLA trees
alike: the cache's leaves are K/V or MLA's latents, and every cache
operation here runs over whichever it holds.  RWKV-6 (``ssm``), the
zamba2 hybrid (``hybrid``: SSD states and its shared block's K/V) and
whisper's encoder-decoder (``encdec``: ``generate(..., enc_embeds=)``,
dense or paged, its cross K/V static beside the decoder's) are served
through ``generate`` alone: as in the reference, ``BatchingEngine`` needs
slot-targeted cache writes, which a recurrent state or a cross cache has
no form for; the recurrent families refuse a ``page_size``.

Paged mode (``page_size=``) keeps the reference's contracts too: K/V live
in fixed-size pages behind a slot -> page table (``serve/_cache.py``); a
host :class:`~repro_torch.serve._paging.PageAllocator` maps pages at
admission and before each decode step and frees them, refcounted, on
retire.  A request whose leading full pages match an earlier prompt maps
those pages and prefills only its tail, with at most one copy-on-write
page duplication at the start of the prefill when the whole prompt
matched; a request whose prefix would match pages written in the same
admission round waits one round, so that it shares them.  The device
``page_table`` is one tensor for the engine's life: when the host table
changes, it is copied in place from a pinned staging buffer, on the
engine's stream, before the prefill or the decode replay that reads it
(a captured graph reads the table's address, so a rebound table would
never be seen).  ``prefill_tokens`` counts the tokens actually prefilled
(tails only, under sharing); ``alloc.pages_in_use`` the physical pages
referenced.  The pool running dry defers admission while a slot is active
and raises :class:`CacheOverflowError` when none is, or mid-decode.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.common import captured_counts, replay_counted
from repro_torch.models.layers import Ctx, SampleCfg, fold_key, sample_tokens
from repro_torch.models.model import model_forward
from repro_torch.models.params import init_params
from repro_torch.serve._cache import CacheOverflowError, cache_specs, copy_pages, pool_pages
from repro_torch.serve._paging import PageAllocator, PagePoolExhausted, _prefix_key

_ENGINE_FAMILIES = ("dense", "moe", "vlm")


def make_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    ctx: Ctx | None = None,
    dtype: torch.dtype = torch.bfloat16,
    page_size: int | None = None,
    num_pages: int | None = None,
    page_table: str = "identity",
    device: str | torch.device = "cuda",
    enc_len: int | None = None,
) -> dict:
    """A fresh zeroed cache on ``device`` (K/V, or MLA's latents, in
    ``dtype``; an enc-dec cache's cross K/V, fp32 at ``enc_len`` encoder
    frames).  With ``page_size``, they are paged (``serve/_cache.py``):
    ``page_table="identity"`` maps slot b's group g to page ``b * max_pages
    + g``, a paged cache that behaves as the dense rectangle (``generate``
    uses it); ``"empty"`` starts unmapped, for an allocator to fill.

    A paged hybrid cache takes no identity table, as in the reference:
    there ``make_cache`` reads the pool's size from the first leaf of
    ``cache["layers"]``, which for this family is the SSD conv state,
    whose dim 1 is the batch, so the table it needs cannot be built and
    ``generate(..., page_size=...)`` raises; the port raises the same way,
    before anything is allocated."""
    if page_size is not None and page_table == "identity" and cfg.family == "hybrid":
        raise ValueError(
            "identity page table cannot be built for a hybrid cache: the reference's "
            "make_cache sizes the pool from the SSD conv state (dim 1 is the batch), "
            "so a paged hybrid cache serves on no entry point"
        )
    specs = cache_specs(cfg, batch, max_len, page_size=page_size, num_pages=num_pages,
                        enc_len=enc_len)
    cache = init_params(specs, torch.Generator(), device=device, default_dtype=dtype)
    if page_size is not None:
        table = cache["page_table"]
        max_pages = table.shape[1]
        if page_table == "identity":
            pool = pool_pages(cache)  # the sink is never mapped
            if pool < batch * max_pages:
                raise ValueError(
                    f"identity page table needs {batch * max_pages} pages; "
                    f"pool has {pool}"
                )
            table.copy_(torch.arange(batch * max_pages, dtype=torch.int32).view(table.shape))
        elif page_table == "empty":
            table.fill_(-1)
        else:
            raise ValueError(f"page_table must be 'identity' or 'empty': {page_table!r}")
    return cache


def _slot_keys(cache: dict) -> torch.Tensor:
    """Per-slot sampling keys at the current write offsets (B,) int64."""
    return fold_key(cache["slot_key"], cache["index"])


def make_prefill_step(ctx: Ctx) -> Callable:
    """(params, inputs, cache) -> (last-token logits, filled cache)."""

    def prefill(params, inputs, cache):
        logits, cache, _ = model_forward(params, inputs, ctx, cache=cache)
        return logits[:, -1:], cache

    return prefill


def make_decode_step(ctx: Ctx, sample: SampleCfg | None = None) -> Callable:
    """(params, cache, tokens (B,1)) -> (next tokens (B,1), logits, cache)."""
    scfg = sample or SampleCfg()

    def decode(params, cache, tokens):
        logits, cache, _ = model_forward(params, {"tokens": tokens}, ctx, cache=cache)
        keys = _slot_keys(cache) if scfg.mode != "greedy" else None
        return sample_tokens(logits[:, -1], scfg, keys)[:, None], logits, cache

    return decode


@torch.no_grad()
def generate(
    params,
    ctx: Ctx,
    prompts,
    max_new: int,
    max_len: int | None = None,
    eos_id: Optional[int] = None,
    sample: SampleCfg | None = None,
    seed: int = 0,
    page_size: int | None = None,
    device: str | torch.device = "cuda",
    embeds=None,
    enc_embeds=None,
) -> torch.Tensor:
    """Reference generation loop, aligned with :class:`BatchingEngine`:
    each row stops at its first ``eos_id`` (emitted), later positions are
    padded with ``eos_id``; raises :class:`CacheOverflowError` up front when
    ``prompt + max_new - 1`` writes cannot fit in ``max_len`` (a
    sliding-window model's ring never overflows: its prefill keeps the
    prompt's last T tokens).  With ``page_size``, K/V are paged behind an
    identity page table: the same semantics in the paged layout.  A VLM's
    ``embeds`` (B, S_img, d) image patch embeddings go before each prompt
    and count in the prompt's length.  An enc-dec model's ``enc_embeds``
    (B, S_enc, d) audio frame embeddings go to its encoder at the prefill:
    they take no slot of the decoder's cache and do not count in the
    prompt's length, and the cache holds their cross K/V apart."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, dtype=torch.int32).to(dev)
    B, S = prompts.shape
    scfg = sample or SampleCfg()
    inputs = {"tokens": prompts}
    if embeds is not None:
        inputs["embeds"] = torch.as_tensor(embeds).to(dev)
    enc_len = None
    if enc_embeds is not None:
        inputs["enc_embeds"] = torch.as_tensor(enc_embeds).to(dev)
        enc_len = enc_embeds.shape[1]
    pre = S + (embeds.shape[1] if embeds is not None else 0)
    T = max_len or (pre + max_new)
    if ctx.cfg.sliding_window is None and pre + max_new - 1 > T:
        raise CacheOverflowError(
            f"prompt ({pre} tokens) + max_new ({max_new}) needs "
            f"{pre + max_new - 1} cache slots but max_len is {T}; raise max_len"
        )
    cache = make_cache(ctx.cfg, B, T, ctx, page_size=page_size, device=dev, enc_len=enc_len)
    if scfg.mode != "greedy":
        base = torch.tensor(seed, dtype=torch.int64, device=dev)
        cache["slot_key"] = fold_key(base, torch.arange(B, device=dev))
    prefill, decode = make_prefill_step(ctx), make_decode_step(ctx, scfg)
    logits, cache = prefill(params, inputs, cache)
    keys = _slot_keys(cache) if scfg.mode != "greedy" else None
    tok = sample_tokens(logits[:, -1], scfg, keys)[:, None]
    out = [tok]
    done = np.zeros((B,), bool)
    for _ in range(max_new - 1):
        if eos_id is not None:
            done = done | (tok[:, 0].cpu().numpy() == eos_id)
            if done.all():
                break
        tok, _, cache = decode(params, cache, tok)
        if eos_id is not None:
            tok = torch.where(torch.as_tensor(done, device=dev)[:, None], eos_id, tok)
        out.append(tok)
    toks = torch.cat(out, dim=1)
    if toks.shape[1] < max_new:  # every row hit EOS early: pad the rectangle
        pad = torch.full_like(toks[:, :1], eos_id).expand(B, max_new - toks.shape[1])
        toks = torch.cat([toks, pad], dim=1)
    return toks


# ---------------------------------------------------------------------------
# Device-resident batched scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any  # (S,) int32
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def _engine_steps(ctx: Ctx, scfg: SampleCfg, eos_id: Optional[int]):
    """The engine's two steps, each writing the cache in place (into the
    buffers the engine allocated, so that a captured decode step's replay
    sees what the steps wrote):

    prefill: (params, cache, tokens, lens, admit, uids, max_news, base_key,
             starts, copy_src=None, copy_dst=None) -> packed; ``starts``
             (B,) int32 is each slot's first prefilled position (everything
             before it is mapped from shared pages; 0 on a dense cache), and
             a paged cache takes (B,) int32 ``copy_src``/``copy_dst``, at
             most one copy-on-write page copy a slot (-1: none), done first
    decode:  (params, cache) -> packed

    with packed (B, 3) int32 = [sampled token, done, overflow].  Logits are
    kept for every position: the batched prefill reads each slot's logits
    at its own last real token."""
    sctx = dataclasses.replace(ctx, ex=dataclasses.replace(ctx.ex, logits="all"))

    def _sample(last, cache):
        keys = _slot_keys(cache) if scfg.mode != "greedy" else None
        return sample_tokens(last, scfg, keys)

    def _packed(tok, done, cache):
        return torch.stack(
            [tok, done.to(torch.int32), cache["overflow"].to(torch.int32)], dim=1
        )

    def _eos(tok):
        if eos_id is None:
            return torch.zeros_like(tok, dtype=torch.bool)
        return tok == eos_id

    @torch.no_grad()
    def prefill(
        params, cache, tokens, lens, admit, uids, max_news, base_key, starts,
        copy_src=None, copy_dst=None,
    ):
        if "page_table" in cache:
            # copy-on-write first: the tail below writes only private copies,
            # never pages other slots still map
            for leaf in cache["layers"].values():
                copy_pages(leaf, copy_src, copy_dst)
        T = cache["pos"].shape[1]
        adm1 = admit[:, None]
        tpos = torch.arange(T, dtype=torch.int32, device=tokens.device)[None, :]
        shared = tpos < starts[:, None]  # mapped from the prefix registry
        cache["index"].copy_(torch.where(admit, starts, cache["index"]))
        # the shared slots are valid at their absolute positions; the masked
        # forward writes the tail
        cache["pos"].copy_(torch.where(adm1, torch.where(shared, tpos, 0), cache["pos"]))
        cache["valid"].copy_(torch.where(adm1, shared, cache["valid"]))
        cache["overflow"] &= ~admit
        fresh_keys = fold_key(base_key, uids)
        cache["slot_key"].copy_(torch.where(admit, fresh_keys, cache["slot_key"]))
        cache["slot_remaining"].copy_(
            torch.where(admit, max_news - 1, cache["slot_remaining"])
        )
        # the masked forward, and each slot's sample at its last real token
        S = tokens.shape[1]
        steps = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
        mask = (steps < lens[:, None]) & adm1
        logits, cache, _ = model_forward(
            params, {"tokens": tokens, "token_mask": mask}, sctx, cache=cache
        )
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        last = logits[rows, torch.clamp(lens - 1, min=0).to(torch.int64)]
        tok = _sample(last, cache)
        done = admit & (_eos(tok) | (cache["slot_remaining"] <= 0))
        cache["slot_active"].copy_((cache["slot_active"] | admit) & ~done)
        cache["next_tok"].copy_(torch.where(adm1, tok[:, None], cache["next_tok"]))
        return _packed(tok, done, cache)

    @torch.no_grad()
    def decode(params, cache):
        active = cache["slot_active"].clone()  # read after the in-place update below
        logits, cache, _ = model_forward(
            params,
            {"tokens": cache["next_tok"], "token_mask": active[:, None]},
            sctx,
            cache=cache,
        )
        tok = _sample(logits[:, -1], cache)
        remaining = cache["slot_remaining"] - active.to(torch.int32)
        done = active & (_eos(tok) | (remaining <= 0))
        cache["slot_remaining"].copy_(remaining)
        cache["slot_active"].copy_(active & ~done)
        act1 = active[:, None]
        cache["next_tok"].copy_(torch.where(act1, tok[:, None], cache["next_tok"]))
        return _packed(tok, done, cache)

    return prefill, decode


def _bucket(n: int, cap: int) -> int:
    """Right-pad prompts to a power-of-two bucket."""
    b = 4
    while b < n:
        b *= 2
    return min(b, cap)


class BatchingEngine:
    """Fixed-slot continuous batching, device-resident: finished sequences
    are swapped for queued requests between decode steps by batched masked
    prefill (see the module docstring for the contracts).

    ``cuda_graph`` (default: on for a CUDA device, off on the CPU, where
    ``True`` raises) runs the decode step as replays of one captured CUDA
    graph; ``False`` keeps the eager step.  ``page_size`` pages the cache
    (``num_pages`` physical pages, default ``num_slots * max_len /
    page_size``; ``share_prefixes`` maps registered prompt prefixes).

    A sliding-window model's cache is a ring of T = min(window, max_len)
    slots: a request may outlast T (no overflow check), a paged slot maps
    all its pages at admission (``PageAllocator.admit_windowed``), and
    prefixes are never shared, since a ring's contents depend on the
    position.  A VLM is served text-only, as the reference's engine serves
    it: a :class:`Request` carries no image embeddings (``generate`` takes
    them).  The recurrent-state families (``ssm``, ``hybrid``) and the
    enc-dec family raise: their recurrent and cross caches have no
    slot-targeted writes."""

    def __init__(
        self,
        params,
        ctx: Ctx,
        num_slots: int,
        max_len: int,
        eos_id: Optional[int] = None,
        sample: SampleCfg | None = None,
        seed: int = 0,
        admit: str = "batched",
        prefill_bucket: int | None = None,
        page_size: int | None = None,
        num_pages: int | None = None,
        share_prefixes: bool = True,
        device: str | torch.device = "cuda",
        cuda_graph: bool | None = None,
    ):
        if ctx.cfg.family not in _ENGINE_FAMILIES:
            raise NotImplementedError(
                f"BatchingEngine needs slot-targeted cache writes; family "
                f"{ctx.cfg.family!r} has recurrent/cross caches without them"
            )
        if admit not in ("batched", "per-slot"):
            raise ValueError(f"admit must be 'batched' or 'per-slot': {admit!r}")
        self.device = resolve_device(device)
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        elif cuda_graph and self.device.type != "cuda":
            raise ValueError(f"cuda_graph=True needs a CUDA device, not {self.device}")
        self.cuda_graph = cuda_graph
        self._graph = None  # (CUDAGraph, its packed output, the counts a replay adds)
        self._warmed_up = False
        self.params, self.ctx = params, ctx
        self.num_slots, self.max_len = num_slots, max_len
        self.eos_id = eos_id
        self.sample = sample or SampleCfg()
        self.admit_mode = admit
        self.queue: list[Request] = []
        self.slots: list[Optional[Request]] = [None] * num_slots
        self.page_size = page_size
        self._windowed = ctx.cfg.sliding_window is not None
        self.cache = make_cache(
            ctx.cfg, num_slots, max_len, ctx, page_size=page_size,
            num_pages=num_pages, page_table="empty", device=self.device,
        )
        self._T = self.cache["pos"].shape[1]
        self.alloc: Optional[PageAllocator] = None
        if page_size is not None:
            pages_per_slot = self._T // page_size
            self.alloc = PageAllocator(
                num_pages or num_slots * pages_per_slot, page_size, num_slots,
                pages_per_slot, share=share_prefixes and not self._windowed,
            )
            # the host side of the device table's in-place uploads
            self._table_host = torch.empty(
                self.alloc.table.shape, dtype=torch.int32,
                pin_memory=self.device.type == "cuda",
            )
        self.prefill_bucket = prefill_bucket
        if prefill_bucket is not None and prefill_bucket > self._T:
            raise ValueError(
                f"prefill_bucket {prefill_bucket} exceeds cache capacity {self._T}"
            )
        dev = self.device
        self.cache.update(
            overflow=torch.zeros((num_slots,), dtype=torch.bool, device=dev),
            slot_active=torch.zeros((num_slots,), dtype=torch.bool, device=dev),
            slot_remaining=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
            slot_key=torch.zeros((num_slots,), dtype=torch.int64, device=dev),
            next_tok=torch.zeros((num_slots, 1), dtype=torch.int32, device=dev),
        )
        self._base_key = torch.tensor(seed, dtype=torch.int64, device=dev)
        self._prefill, self._decode = _engine_steps(ctx, self.sample, eos_id)
        self.readbacks = 0  # host syncs: 1/decode step + 1/admission prefill
        self.prefill_tokens = 0  # tokens actually prefilled (tails only)
        self._slot_len = [0] * num_slots  # host mirror of each slot's index

    def submit(self, req: Request):
        plen = int(len(req.prompt))
        if plen < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        cap = self.prefill_bucket or self._T
        if plen > cap:
            raise ValueError(
                f"request {req.uid}: prompt ({plen}) exceeds the prefill "
                f"capacity ({cap} tokens)"
            )
        if not self._windowed and plen + req.max_new - 1 > self.max_len:
            raise CacheOverflowError(
                f"request {req.uid}: prompt ({plen}) + max_new ({req.max_new}) "
                f"needs {plen + req.max_new - 1} cache slots but max_len is "
                f"{self.max_len}; overflowing writes would drop tokens"
            )
        self.queue.append(req)

    def _check(self, packed: torch.Tensor) -> np.ndarray:
        """The ONE host readback per step; backstop overflow check."""
        arr = packed.cpu().numpy()
        self.readbacks += 1
        if arr[:, 2].any():
            raise CacheOverflowError(
                f"cache overflow flagged for slots {arr[:, 2].nonzero()[0].tolist()}"
            )
        return arr

    def _upload_table(self):
        """Copy the allocator's table into the device ``page_table`` in
        place, through the pinned staging buffer, on the engine's stream
        (each step's read-back completes the copy before the buffer is
        written again)."""
        self._table_host.copy_(torch.from_numpy(self.alloc.table))
        self.cache["page_table"].copy_(self._table_host, non_blocking=True)

    def _plan_batch(self, free: list[int], limit: int):
        """Pop up to ``limit`` admittable requests, assigning slots (and,
        when paged, page mappings).  A candidate whose prefix would match
        pages written in this same round waits a round, to share them."""
        placed: list[tuple[Request, int, Any]] = []
        pending: set[bytes] = set()
        while self.queue and len(placed) < limit:
            req = self.queue.pop(0)
            if req.max_new <= 0:
                req.done = True  # nothing requested; don't pay a prefill
                continue
            s = free[len(placed)]
            if self.alloc is None:
                placed.append((req, s, None))
                continue
            pnp = np.asarray(req.prompt, np.int32)
            keys = (
                [
                    _prefix_key(pnp, m * self.page_size)
                    for m in range(1, len(pnp) // self.page_size + 1)
                ]
                if self.alloc.share
                else []
            )
            if any(k in pending and not self.alloc.has_prefix(k) for k in keys):
                self.queue.insert(0, req)  # share with this round's donor
                break  # once it registers, next round
            if self._windowed:
                plan = self.alloc.admit_windowed(s)
            else:
                plan = self.alloc.admit(s, pnp)
            if plan is None:  # pool dry: wait for retires to free pages
                self.queue.insert(0, req)
                break
            pending.update(keys)
            placed.append((req, s, plan))
        return placed

    def _admit(self):
        while self.queue and any(s is None for s in self.slots):
            free = [i for i, s in enumerate(self.slots) if s is None]
            limit = 1 if self.admit_mode == "per-slot" else len(free)
            placed = self._plan_batch(free, limit)
            if not placed:
                if self.alloc is not None and self.queue and all(
                    r is None for r in self.slots
                ):
                    raise CacheOverflowError(
                        f"request {self.queue[0].uid}: page pool exhausted with no "
                        "active slots to retire; raise num_pages"
                    )
                return
            B = self.num_slots
            tails = [
                np.asarray(r.prompt, np.int32)[(p.start if p else 0):]
                for r, _, p in placed
            ]
            S = self.prefill_bucket or _bucket(max(len(t) for t in tails), self._T)
            tokens = np.zeros((B, S), np.int32)
            lens = np.ones((B,), np.int32)
            admit = np.zeros((B,), bool)
            uids = np.zeros((B,), np.int64)
            max_news = np.ones((B,), np.int32)
            starts = np.zeros((B,), np.int32)
            copy_src = np.full((B,), -1, np.int32)
            copy_dst = np.full((B,), -1, np.int32)
            for (req, s, plan), tail in zip(placed, tails):
                tokens[s, : len(tail)] = tail
                lens[s], admit[s] = len(tail), True
                uids[s], max_news[s] = req.uid, req.max_new
                if plan is not None:
                    starts[s] = plan.start
                    copy_src[s], copy_dst[s] = plan.copy_src, plan.copy_dst
            dev = self.device
            copies = []
            if self.alloc is not None:
                self._upload_table()
                copies = [copy_src, copy_dst]
            args = [torch.from_numpy(a).to(dev) for a in (tokens, lens, admit, uids, max_news)]
            packed = self._prefill(
                self.params, self.cache, *args, self._base_key,
                *(torch.from_numpy(a).to(dev) for a in [starts] + copies),
            )
            for (req, s, plan), tail in zip(placed, tails):
                if self.alloc is not None:
                    # the prefill writing these pages has been issued: safe
                    # to register them for later admissions to map
                    self.alloc.register(s, np.asarray(req.prompt, np.int32))
                self._slot_len[s] = (plan.start if plan else 0) + len(tail)
            self.prefill_tokens += int(sum(len(t) for t in tails))
            arr = self._check(packed)
            for req, s, _ in placed:
                req.generated.append(int(arr[s, 0]))
                if arr[s, 1]:  # EOS at prefill or max_new == 1: free the slot
                    req.done = True
                    if self.alloc is not None:
                        self.alloc.retire(s)
                else:
                    self.slots[s] = req

    def _decode_step(self) -> torch.Tensor:
        """The decode step, eager; or under ``cuda_graph`` eager the first
        time (which also warms up every kernel's build, attributes and
        tensor maps, and the allocator), captured into the engine's own
        graph and memory pool the second time, then replayed.  A capture
        that fails raises: the step never falls back to eager.  The cyclic
        garbage collector runs before the capture and is held off during
        it: a dead engine's graph freed by the collector mid-capture (torch
        no longer collects when a capture begins) invalidates the capture."""
        if not self.cuda_graph or not self._warmed_up:
            self._warmed_up = True
            return self._decode(self.params, self.cache)
        if self._graph is None:
            graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(self.device)

            def record():
                # the outer context restores the engine's stream also when
                # the capture fails (a failed end of capture skips the inner)
                with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
                    return self._decode(self.params, self.cache)

            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                packed, added = captured_counts(record)
            except Exception as e:
                raise RuntimeError(
                    f"capturing the decode step as a CUDA graph failed: {e}"
                ) from e
            finally:
                if collecting:
                    gc.enable()
            self._graph = graph, packed, added
        graph, packed, added = self._graph
        replay_counted(graph, added)
        return packed

    def step(self) -> bool:
        """One decode step over all active slots; returns True if any active."""
        self._admit()
        if all(r is None for r in self.slots):
            return False
        if self.alloc is not None:
            dirty = False
            for s, req in enumerate(self.slots):
                if req is not None:
                    try:
                        # the decode below writes this slot's K/V at its
                        # current length: map that page first
                        dirty |= self.alloc.ensure_page(s, self._slot_len[s])
                    except PagePoolExhausted as e:
                        raise CacheOverflowError(str(e)) from None
            if dirty:
                self._upload_table()
        arr = self._check(self._decode_step())
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            self._slot_len[s] += 1
            req.generated.append(int(arr[s, 0]))
            if arr[s, 1]:
                req.done = True
                self.slots[s] = None
                if self.alloc is not None:
                    self.alloc.retire(s)
        return True

    def run(self) -> list[Request]:
        all_reqs = list(self.queue)
        while self.step():
            pass
        return all_reqs
