"""Paged KV block pool: the host-side allocator of the paged serving engine.

Why pages
---------
The unpaged engine allocates one worst-case ``max_len`` KV strip per slot,
so device memory is bound by the LONGEST request the engine might see.
The paged engine owns one global pool of fixed-size pages (``page_size``
tokens each, aligned to the ABFP tile width, so an int8 KV page never
straddles a quantization tile) and grows each live request page by page
as it decodes.  On the device every layer's cache is a ``(num_pages + 1,
page_size, ...)`` pool tensor and one ``(capacity, max_pages)`` int32
page table maps each slot's logical pages to physical pages; the table is
read by every pass from device memory (``models.layers`` paged paths), so
occupancy is data, not shape, and a CUDA graph of a pass replays under
any table.

This module is the HOST side, numpy only: a free-list allocator with
reference counts, copy-on-write, a hash-chained prefix cache (shared
prompt prefixes prefill once), LRU eviction of cache-only pages, and
per-tenant accounting for quota enforcement.  It never touches device
memory: the engine owns the page copies and calls in here to pick page
indices.

Invariants (tests/test_torch_pages.py, the ``tests/test_pages.py`` cases):
  * every page is in exactly one of {free list, ref > 0};
  * ``ref[p]`` counts slot holders plus 1 if the prefix cache holds ``p``;
  * pages on the free list are never referenced by any slot or cache entry;
  * a page is only written by a slot whose ref on it is exclusive — shared
    pages are copy-on-write (``cow()``), so prefix sharing never aliases
    writes.

Sentinel convention: page index ``num_pages`` (one past the pool) marks an
unallocated page-table entry.  On the device it is the pool's scratch
page: every write routed to it (a sentinel entry, a position past the
table, a padding lane) lands there and is never read, so the scatter has a
fixed shape; gathers clamp to the last real page and the garbage they read
sits at positions the attention masks, exactly like unpaged out-of-range
slots.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages required to hold ``tokens`` cache positions."""
    return -(-int(tokens) // int(page_size))


def prefix_key(prev: Optional[int], block: Sequence[int]) -> int:
    """Chained hash over full page-size token blocks: the key of a page
    commits to the ENTIRE prefix up to and including its tokens, so two
    prompts share a cached page iff they agree on every token before it."""
    return hash((prev, tuple(int(t) for t in block)))


@dataclasses.dataclass
class PoolStats:
    num_pages: int
    page_size: int
    free: int            # pages with ref == 0 (immediately allocatable)
    cached: int          # pages held ONLY by the prefix cache (evictable)
    held: int            # pages referenced by at least one slot
    prefix_hits: int
    prefix_evictions: int
    cow_copies: int

    @property
    def pressure(self) -> float:
        """Fraction of the pool pinned by live slots — the watermark signal
        for shedding / degraded modes (cache-only pages are reclaimable and
        do NOT count as pressure)."""
        return self.held / max(1, self.num_pages)

    @property
    def occupancy(self) -> float:
        """Fraction of the pool allocated to anything (slots + cache)."""
        return 1.0 - self.free / max(1, self.num_pages)


class PagePool:
    """Free-list page allocator with refcounts, prefix cache, and CoW."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 1 or page_size < 1:
            raise ValueError("pool needs >= 1 page of >= 1 token")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.sentinel = self.num_pages          # one-past-the-end marker
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self.ref = np.zeros(self.num_pages, np.int32)
        # Prefix cache: chain-key -> page, plus the reverse map and an LRU
        # order (python dicts iterate in insertion order; re-inserting on
        # touch makes the first key the least recently used).
        self._cache: Dict[int, int] = {}
        self._page_key: Dict[int, int] = {}
        self._tenant_held: Dict[str, int] = {}
        self.prefix_hits = 0
        self.prefix_evictions = 0
        self.cow_copies = 0

    # -- accounting -------------------------------------------------------
    def stats(self) -> PoolStats:
        cached_only = sum(1 for p in self._cache.values() if self.ref[p] == 1)
        held = int(np.sum(self.ref > 0)) - cached_only
        return PoolStats(
            num_pages=self.num_pages, page_size=self.page_size,
            free=len(self._free), cached=cached_only, held=held,
            prefix_hits=self.prefix_hits,
            prefix_evictions=self.prefix_evictions,
            cow_copies=self.cow_copies)

    def pressure(self) -> float:
        return self.stats().pressure

    def available(self) -> int:
        """Pages allocatable right now: the free list plus cache-only pages
        that LRU eviction can reclaim on demand."""
        return len(self._free) + sum(
            1 for p in self._cache.values() if self.ref[p] == 1)

    def tenant_held(self, tenant: str) -> int:
        return self._tenant_held.get(tenant, 0)

    # -- allocation -------------------------------------------------------
    def _evict_one_cached(self) -> bool:
        """Drop the least-recently-used cache-ONLY page back to the free
        list.  Pages a live slot still shares are skipped (evicting them
        would not free memory; the slot's ref keeps the page pinned)."""
        for key in list(self._cache):
            p = self._cache[key]
            if self.ref[p] == 1:                # cache is the only holder
                del self._cache[key]
                del self._page_key[p]
                self.ref[p] = 0
                self._free.append(p)
                self.prefix_evictions += 1
                return True
        return False

    def alloc(self, n: int, tenant: str = "default") -> Optional[List[int]]:
        """Allocate ``n`` private pages (ref = 1) for ``tenant``; evicts
        cache-only pages LRU-first when the free list runs dry.  All-or-
        nothing: returns None (and allocates nothing) if the pool cannot
        supply ``n`` pages even after eviction."""
        if n <= 0:
            return []
        while len(self._free) < n:
            if not self._evict_one_cached():
                return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self.ref[p] = 1
        self._tenant_held[tenant] = self._tenant_held.get(tenant, 0) + n
        return out

    def share(self, pages: Sequence[int], tenant: str = "default") -> None:
        """Take a reference on already-allocated pages (prefix attach)."""
        for p in pages:
            assert self.ref[p] > 0, f"sharing unallocated page {p}"
            self.ref[p] += 1
        self._tenant_held[tenant] = (
            self._tenant_held.get(tenant, 0) + len(pages))

    def release(self, pages: Sequence[int], tenant: str = "default") -> None:
        """Drop one reference per page; pages that reach ref == 0 return to
        the free list.  Pages the prefix cache still holds stay allocated
        (ref >= 1) and remain reusable until evicted."""
        for p in pages:
            assert self.ref[p] > 0, f"releasing free page {p}"
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self._free.append(p)
        held = self._tenant_held.get(tenant, 0) - len(pages)
        if held > 0:
            self._tenant_held[tenant] = held
        else:
            self._tenant_held.pop(tenant, None)

    # -- copy-on-write ----------------------------------------------------
    def cow(self, page: int, tenant: str = "default") -> Optional[int]:
        """Prepare ``page`` for writing by ``tenant``.

        Exclusive pages (ref == 1, not cached) are returned unchanged.  A
        shared or cached page is split: the caller's reference moves to a
        freshly allocated private page and the caller must copy the device
        contents (the engine's page copy).  Returns the page to write
        to, or None if the pool cannot supply the copy target."""
        if self.ref[page] == 1 and page not in self._page_key:
            return int(page)
        got = self.alloc(1, tenant)
        if got is None:
            return None
        # Caller held one reference on the shared page; hand it back.
        self.release([page], tenant)
        self.cow_copies += 1
        return got[0]

    # -- prefix cache -----------------------------------------------------
    def lookup(self, key: int) -> Optional[int]:
        """Cached page for a chain key (LRU-touched), else None."""
        p = self._cache.get(key)
        if p is None:
            return None
        self._cache.pop(key)
        self._cache[key] = p                     # move to MRU position
        self.prefix_hits += 1
        return p

    def register(self, key: int, page: int) -> None:
        """Publish a fully-written prompt page under its chain key.  The
        cache takes its own reference, so the page outlives the request
        that prefilled it (until LRU eviction reclaims it)."""
        if key in self._cache or page in self._page_key:
            return
        assert self.ref[page] > 0, "registering an unallocated page"
        self._cache[key] = page
        self._page_key[page] = key
        self.ref[page] += 1

    def cached_pages(self) -> int:
        return len(self._cache)

    # -- integrity (tests) ------------------------------------------------
    def check(self) -> None:
        """Assert the allocator invariants; used by the property tests."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate free-list entries"
        for p in free:
            assert self.ref[p] == 0, f"free page {p} has ref {self.ref[p]}"
        for p in range(self.num_pages):
            if self.ref[p] == 0:
                assert p in free, f"leaked page {p}"
        for key, p in self._cache.items():
            assert self._page_key.get(p) == key
            assert self.ref[p] >= 1


def page_table_array(capacity: int, max_pages: int,
                     sentinel: int) -> np.ndarray:
    """Host mirror of the device page table, initialized to the sentinel
    (= ``num_pages``): every entry routes to the drop lane until a page is
    allocated, so dead or short slots can never scatter into live pages."""
    return np.full((capacity, max_pages), sentinel, np.int32)


def plan_chunk(slot_len: int, need: int, pages: List[int],
               page_size: int) -> Tuple[int, List[int]]:
    """For a slot about to append ``need`` tokens at ``slot_len``: returns
    ``(extra_pages, write_page_indices)`` — how many new pages must be
    allocated and which HELD page indices fall in the write range (the CoW
    guard checks those for shared refs)."""
    required = pages_needed(slot_len + need, page_size)
    first = slot_len // page_size
    last = (slot_len + max(need, 1) - 1) // page_size
    writes = [j for j in range(first, min(last + 1, len(pages)))]
    return max(0, required - len(pages)), writes
