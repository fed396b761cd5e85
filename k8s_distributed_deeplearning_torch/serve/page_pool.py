"""Refcounted page allocator for the paged KV pool (host-side bookkeeping).

The port's own copy of ``k8s_distributed_deeplearning_tpu/serve/
page_pool.py`` (without the owner ledger, which feeds telemetry the port
does not have yet). Page 0 is the reserved SCRATCH page: never handed
out, block tables default to it, and out-of-table pad writes land there.
Reservations make decode growth infallible: admission reserves a slot's
worst-case growth, and :meth:`alloc_reserved` draws from it.
"""
from __future__ import annotations

import numpy as np


class PagePool:
    """Free-list + refcount bookkeeping over ``num_pages`` KV pages.

    Invariants: page 0 is scratch (never allocated or freed, refcount
    pinned at 1); a page is on the free list iff its refcount is 0;
    ``reserved`` free pages are promised to admitted slots, and
    :meth:`available` excludes them.
    """

    def __init__(self, num_pages: int, page_tokens: int):
        if num_pages < 2:
            raise ValueError(
                f"PagePool needs >= 2 pages (scratch + 1 usable), got "
                f"{num_pages}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        self._refs = np.zeros(self.num_pages, np.int32)
        self._refs[0] = 1          # scratch: pinned forever
        # LIFO free list: recently freed pages are re-issued first.
        self._free = list(range(self.num_pages - 1, 0, -1))
        self.reserved = 0

    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` fresh pages (refcount 1 each). Raises on exhaustion:
        admission gates on :meth:`available` first, so this is a bug."""
        if n > len(self._free) - self.reserved:
            raise RuntimeError(
                f"page pool exhausted: want {n}, have "
                f"{len(self._free) - self.reserved} unreserved free pages "
                f"(admission must gate on available())")
        pages = [self._free.pop() for _ in range(n)]
        self._refs[pages] = 1
        return pages

    def alloc_reserved(self, n: int) -> list[int]:
        """Pop ``n`` pages against an existing reservation (decode growth)."""
        if n > self.reserved:
            raise RuntimeError(
                f"alloc_reserved({n}) exceeds outstanding reservation "
                f"({self.reserved}) — growth accounting bug")
        self.reserved -= n
        pages = [self._free.pop() for _ in range(n)]
        self._refs[pages] = 1
        return pages

    def deref(self, page: int) -> None:
        """Drop a reference; the page returns to the free list at zero."""
        if page <= 0 or self._refs[page] == 0:
            raise RuntimeError(f"deref() on dead or scratch page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)

    def reserve(self, n: int) -> None:
        """Promise ``n`` free pages to a slot's future decode growth."""
        if n > len(self._free) - self.reserved:
            raise RuntimeError(
                f"cannot reserve {n} pages: only "
                f"{len(self._free) - self.reserved} unreserved free")
        self.reserved += n

    def unreserve(self, n: int) -> None:
        """Return unused growth headroom (request finished early)."""
        if n > self.reserved:
            raise RuntimeError(
                f"unreserve({n}) exceeds outstanding reservation "
                f"({self.reserved})")
        self.reserved -= n

    def available(self) -> int:
        """Pages an admission may claim right now (free minus reserved)."""
        return len(self._free) - self.reserved

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def counters(self) -> dict:
        """Utilization snapshot (scratch page excluded throughout)."""
        return {
            "pages_total": self.num_pages - 1,
            "pages_used": int(np.count_nonzero(self._refs[1:])),
            "pages_shared": int(np.count_nonzero(self._refs[1:] >= 2)),
            "pages_reserved": self.reserved,
        }
