"""Paged KV-cache page pool: the host-side allocator behind the
engine's paged device buffers.  The port's own copy of
container_engine_accelerators_tpu/serving/kvpool.py (PagePool with its
export pins, PoolExhausted and MigrationTicket, same behaviour).

The device side is a flat pool of fixed-size pages per decoder block
(models/generate.py init_paged_cache / the int8 twin): physical page 0
is the reserved NULL page (unmapped block-table entries and clamped
writes land there; no row ever attends to it unmasked), pages 1..total
are allocatable.  This module owns WHICH physical page holds WHOSE
tokens:

  - `PagePool` — free-list allocation plus per-page REFERENCE COUNTS.
    A page is referenced by every active row whose block table maps it
    and by the radix prefix cache when it retains the page after the
    row retires (serving/prefix_cache.py); it returns to the free list
    only when the last reference drops.  That is what makes prefix
    pages shareable copy-on-write: admissions take references instead
    of copies, and the first divergent write goes to a freshly
    allocated page, never a shared one.

Capacity follows TOKENS RESIDENT, not worst-case row length: a row
holds ceil((prompt + generated) / page) pages minus whatever prefix it
shares, so at fixed cache memory the paged engine admits strictly more
concurrent rows than the slot-contiguous layout's
`slots x max_seq` (the oversubscription the prefix-heavy bench arm
measures).

Thread-safety: all mutation happens on the engine scheduler thread;
snapshot readers (/metrics gauges) come from scrape threads, so every
method takes the pool's own small lock.  The lock never nests around
the engine lock (lock-order hygiene).
"""

from __future__ import annotations

import threading
from typing import List


class PoolExhausted(RuntimeError):
    """alloc() could not find enough free pages — the caller decides
    whether to evict prefix pages, wait for retirements, or fail the
    request as structurally unadmittable."""


class PagePool:
    """Free-list + refcount allocator over `total` usable pages
    (physical ids 1..total; id 0 is the reserved null page and is
    never handed out)."""

    def __init__(self, total: int):
        if total < 1:
            raise ValueError(f"pool needs >= 1 usable page, got {total}")
        self.total = int(total)
        self._lock = threading.Lock()
        # Low ids first purely for debuggability of dumps/tests.
        self._free: List[int] = list(range(self.total, 0, -1))  # guarded-by: _lock
        self._rc = [0] * (self.total + 1)  # guarded-by: _lock

    # -- allocation ------------------------------------------------------
    # owns-pages
    def alloc(self, n: int) -> List[int]:
        """Allocate `n` pages with refcount 1 each, or raise
        PoolExhausted WITHOUT allocating any (all-or-nothing, so a
        failed admission never leaks a partial allocation)."""
        if n < 0:
            raise ValueError(f"alloc needs n >= 0, got {n}")
        with self._lock:
            if len(self._free) < n:
                raise PoolExhausted(
                    f"need {n} pages, {len(self._free)} free of "
                    f"{self.total}"
                )
            pages = [self._free.pop() for _ in range(n)]
            for p in pages:
                self._rc[p] = 1
        return pages

    # owns-pages
    def ref(self, page: int) -> None:
        """Take one more reference on an allocated page (a new row
        sharing a prefix page, or the radix cache retaining it)."""
        with self._lock:
            if not 1 <= page <= self.total or self._rc[page] < 1:
                raise ValueError(f"ref of unallocated page {page}")
            self._rc[page] += 1

    # owns-pages
    def unref(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed
        (refcount hit zero and it returned to the free list)."""
        with self._lock:
            if not 1 <= page <= self.total or self._rc[page] < 1:
                raise ValueError(f"unref of unallocated page {page}")
            self._rc[page] -= 1
            if self._rc[page] == 0:
                self._free.append(page)
                return True
        return False

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._rc[page]

    # -- cross-replica page migration / tier demotion --------------------
    # borrows-pages
    def export_pages(self, pages: List[int]) -> None:
        """Pin `pages` for serialization: one extra reference on EACH,
        taken under a single lock acquisition (all-or-nothing — a
        partially pinned export would leak references on the failure
        path).  The pin is what closes the export-under-refcount race:
        the LRU evictor may drop the radix trie's hold on a page while
        its bytes are mid-gather, and without this reference the page
        would return to the free list and be rewritten by the next
        admission UNDER the serializer.  Callers pair every
        export_pages with release_pages.  Two consumers share this
        seam: cross-replica migration and tier demotion
        (serving/kvtier.py) — the latter serializes the page
        into a host/disk byte store BEFORE dropping the trie's hold,
        so the pool's refcounts stay authoritative for HBM and the
        store never holds a page id."""
        with self._lock:
            for p in pages:
                if not 1 <= p <= self.total or self._rc[p] < 1:
                    raise ValueError(
                        f"export of unallocated page {p}"
                    )
            for p in pages:
                self._rc[p] += 1

    # owns-pages
    def release_pages(self, pages: List[int]) -> int:
        """Drop the export pins (or any batch of references) taken as
        a group; returns how many pages actually freed."""
        freed = 0
        for p in pages:
            if self.unref(p):
                freed += 1
        return freed

    # owns-pages
    def reset(self) -> None:
        """Forget every allocation and reference — used when the
        device-side pool is rebuilt (engine revive / cache-loss
        rebuild): the KV content is gone, so host bookkeeping that
        outlives it would map rows onto zeros."""
        with self._lock:
            self._free = list(range(self.total, 0, -1))
            self._rc = [0] * (self.total + 1)

    # -- introspection ---------------------------------------------------
    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.total - len(self._free)

    def check_leaks(self) -> int:
        """Pages still allocated — the chaos suite asserts 0 after an
        engine death + supervisor rebuild (the no-leak contract)."""
        return self.in_use


# state-machine: migration field: state states: exported,streaming,adopted,released terminal: released
class MigrationTicket:
    """One cross-replica page migration (the export -> adopt seam), as
    an explicit lifecycle object.

    The exporter creates one over the pinned page ids (`exported`),
    marks it `streaming` when the gather/serialize begins, and
    `released` when the pins drop (the export job's finally block —
    success and failure alike).  The adopter boots its own ticket at
    `initial="streaming"` over the freshly allocated pages and marks
    it `adopted` once the radix trie commits the handoff, or
    `released` when an unwind unrefs them.  `released` is terminal:
    a ticket whose pages went back to the pool must never be marked
    again (the double-release dual refcheck guards at the refcount
    layer, restated here at the lifecycle layer).

    Single-threaded by construction — both jobs run on the engine
    scheduler thread (_side_call), so transitions need no lock."""

    __slots__ = ("pages", "state")

    def __init__(self, pages: List[int], initial: str = "exported"):
        if initial not in ("exported", "streaming"):
            raise ValueError(
                f"migration ticket cannot boot in state {initial!r}"
            )
        self.pages = list(pages)
        self.state = initial

    def mark_streaming(self) -> None:
        # transition: exported -> streaming
        self.state = "streaming"

    def mark_adopted(self) -> None:
        # transition: streaming -> adopted
        self.state = "adopted"

    def mark_released(self) -> None:
        # transition: exported|streaming|adopted -> released
        self.state = "released"
