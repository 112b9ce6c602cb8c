"""Host-side page accounting for the paged KV cache (the port's own copy
of ``repro/serve/_paging.py``, which imports only numpy; the port imports
nothing of the JAX package).

The device side (``repro_torch.serve._cache``) only routes writes through
a ``page_table`` — it never allocates.  This module owns the physical page
pool: a free list, per-page refcounts, and a prompt-prefix registry that
backs copy-on-write prefix sharing.

Contracts (relied on by ``BatchingEngine`` and asserted in tests):

* **Refcounts.**  A page is owned by every slot row that maps it plus every
  registry entry that pins it; it returns to the free list exactly when the
  count hits zero (``retire`` / registry eviction).
* **Registry.**  Keys are *full-page-aligned* token prefixes (the raw int32
  bytes of ``prompt[:m * page_size]`` for every m); values are the physical
  pages holding exactly those tokens.  Entries are registered after the
  prefill that writes them was issued, so a hit always references fully
  written, immutable pages: registered pages cover only whole prompt pages
  (group < plen // page_size) and decode writes start at group
  ``plen // page_size`` — a shared page is never written again in place.
* **Copy-on-write.**  When a hit covers the entire prompt, the final token
  still needs its logits, so the last matched page is *duplicated* into a
  private page (the copy pair in :class:`AdmitPlan`) and the tail — at
  least one token — is re-prefilled over the copy.  This is the only case
  where a write would target a shared page, and it targets the copy.
* **Exhaustion.**  Allocation first evicts registry entries (oldest first);
  if the pool is still dry, :class:`PagePoolExhausted` propagates — the
  engine defers admission or surfaces ``CacheOverflowError`` mid-decode.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class PagePoolExhausted(RuntimeError):
    """No free physical page, even after evicting the prefix registry."""


@dataclasses.dataclass
class AdmitPlan:
    """Host-side admission outcome: prefill starts at logical token
    ``start`` (everything before it is mapped from shared pages), with at
    most one COW page duplication (``copy_src -> copy_dst``, -1 = none)."""

    slot: int
    start: int
    copy_src: int = -1
    copy_dst: int = -1


def _prefix_key(prompt: np.ndarray, n_tokens: int) -> bytes:
    return np.ascontiguousarray(prompt[:n_tokens], dtype=np.int32).tobytes()


class PageAllocator:
    def __init__(
        self,
        num_pages: int,
        page_size: int,
        num_slots: int,
        pages_per_slot: int,
        share: bool = True,
    ):
        self.num_pages, self.page_size = num_pages, page_size
        self.pages_per_slot = pages_per_slot
        self.share = share
        self._free = list(range(num_pages - 1, -1, -1))  # pop() -> page 0 first
        self._ref = np.zeros((num_pages,), np.int64)
        # the slot→page map mirrored on host; uploaded before each step
        self.table = np.full((num_slots, pages_per_slot), -1, np.int32)
        self._registry: dict[bytes, tuple[int, ...]] = {}  # insertion-ordered

    # -- pool primitives ----------------------------------------------------

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def _alloc(self) -> int:
        if not self._free:
            raise PagePoolExhausted(
                f"all {self.num_pages} physical pages are referenced"
            )
        p = self._free.pop()
        self._ref[p] = 1
        return p

    def _retain(self, page: int) -> None:
        self._ref[page] += 1

    def _release(self, page: int) -> None:
        self._ref[page] -= 1
        assert self._ref[page] >= 0, f"refcount underflow on page {page}"
        if self._ref[page] == 0:
            self._free.append(page)

    def _evict_one(self) -> bool:
        """Drop the oldest registry entry (its pages free once no active
        slot maps them)."""
        if not self._registry:
            return False
        key = next(iter(self._registry))
        for p in self._registry.pop(key):
            self._release(p)
        return True

    def _reserve(self, n: int) -> bool:
        while len(self._free) < n:
            if not self._evict_one():
                return False
        return True

    # -- admission / decode / retire ----------------------------------------

    def has_prefix(self, key: bytes) -> bool:
        return key in self._registry

    def lookup(self, prompt: np.ndarray) -> tuple[int, ...]:
        """Longest registered full-page prefix of ``prompt`` (may be ())."""
        if not self.share:
            return ()
        for m in range(len(prompt) // self.page_size, 0, -1):
            hit = self._registry.get(_prefix_key(prompt, m * self.page_size))
            if hit is not None:
                return hit
        return ()

    def admit(self, slot: int, prompt: np.ndarray) -> AdmitPlan | None:
        """Map shared prefix pages into ``slot`` and allocate pages for the
        divergent tail; returns None (nothing mutated) when the pool cannot
        cover the tail even after registry eviction."""
        plen = len(prompt)
        ps = self.page_size
        row = self.table[slot]
        assert (row < 0).all(), f"slot {slot} was not retired before re-admission"
        shared = self.lookup(prompt)
        # always re-prefill at least the final token: its logits seed decode
        start = min(len(shared) * ps, plen - 1)
        g_full, rem = divmod(start, ps)
        # retain the match before reserving: eviction must not free (and
        # recycle) the very pages we are about to map
        for p in shared[:g_full + (1 if rem else 0)]:
            self._retain(p)
        n_fresh = (plen - 1) // ps - g_full + 1 if plen else 0
        if not self._reserve(n_fresh):
            for p in shared[:g_full + (1 if rem else 0)]:
                self._release(p)
            return None
        row[:g_full] = shared[:g_full]
        plan = AdmitPlan(slot=slot, start=start)
        g0 = g_full
        if rem:  # COW: duplicate the partially reused page, rewrite its tail
            dst = self._alloc()
            row[g_full] = dst
            plan.copy_src, plan.copy_dst = shared[g_full], dst
            self._release(shared[g_full])  # retained above only to pin it
            g0 += 1
        for g in range(g0, (plen - 1) // ps + 1):
            row[g] = self._alloc()
        return plan

    def admit_windowed(self, slot: int) -> AdmitPlan | None:
        """Ring caches reuse every page cyclically: map the full budget up
        front (sharing is disabled — ring contents are position-dependent)."""
        row = self.table[slot]
        assert (row < 0).all(), f"slot {slot} was not retired before re-admission"
        if not self._reserve(self.pages_per_slot):
            return None
        for g in range(self.pages_per_slot):
            row[g] = self._alloc()
        return AdmitPlan(slot=slot, start=0)

    def register(self, slot: int, prompt: np.ndarray) -> None:
        """Pin ``slot``'s full prompt pages under their prefix keys (call
        after the prefill writing them has been issued)."""
        if not self.share:
            return
        row = self.table[slot]
        for m in range(1, len(prompt) // self.page_size + 1):
            key = _prefix_key(prompt, m * self.page_size)
            if key in self._registry:
                continue
            pages = tuple(int(p) for p in row[:m])
            if any(p < 0 for p in pages):
                return
            for p in pages:
                self._retain(p)
            self._registry[key] = pages

    def ensure_page(self, slot: int, t: int) -> bool:
        """Map a page for the decode write at logical position ``t`` if its
        group is unmapped; returns True when the table changed."""
        capacity = self.pages_per_slot * self.page_size
        g = (t % capacity) // self.page_size
        if self.table[slot, g] >= 0:
            return False
        if not self._reserve(1):
            raise PagePoolExhausted(
                f"slot {slot} needs a page for position {t} but all "
                f"{self.num_pages} pages are referenced"
            )
        self.table[slot, g] = self._alloc()
        return True

    def retire(self, slot: int) -> None:
        """Release every page the slot maps (frees them at refcount zero;
        registry pins keep shared prefixes warm for future admissions)."""
        row = self.table[slot]
        for g in range(self.pages_per_slot):
            if row[g] >= 0:
                self._release(int(row[g]))
                row[g] = -1

    def release_prefixes(self) -> None:
        """Drop every registry pin (e.g. engine shutdown/tests)."""
        while self._evict_one():
            pass
