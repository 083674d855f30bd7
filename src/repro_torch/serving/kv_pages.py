"""Paged compressed KV cache: fixed-size pages from a device-resident pool
(the port of ``repro.serving.kv_pages``).

The pool replaces the dense ``(batch, max_len)`` KV cache for models whose
decode path routes through ``layers.decode_attention`` (``supports_paged_kv``).
Layout per layer: ``(n_pages, page_size, kv_heads, head_dim)`` — exactly the
model's own ``cache_spec`` with ``(batch, max_len)`` reinterpreted as
``(n_pages, page_size)``, so ``blockfloat8`` pages ride the existing int8
block-quantized machinery unchanged (codes + per-(token, head) scales).

Why pages: admitted work is bounded by *cache capacity* (pool bytes), not by
``batch_slots`` — a slot only costs what its request actually needs
(``ceil(tokens / page_size)`` pages, reserved up-front so a request can never
OOM mid-flight), and a compressed pool holds ~2x the pages of a bf16 pool at
equal bytes, which is exactly the serving-capacity claim of the fixed-rate
mode.

Isolation contract (the PR-9 bugfix): page 0 is a reserved zero page that is
never allocated; free lanes' page-table rows point at it, so any gather
through a dead slot reads exact zeros. Pages freed on request completion are
zeroed on-device *and* returned to the free list — a recycled slot can never
observe a previous occupant's keys/values, regardless of masking.

Allocation is host-side (plain Python lists); only the page *contents* and
the zeroing of freed pages touch the device. The page table is rebuilt as a
(batch_slots, max_pages) int32 array each tick.  The pool lives on the
model's device (``model.init_cache``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class PoolExhausted(Exception):
    """Requested pages exceed the free pool (admission must defer)."""


class PageAccountingError(RuntimeError):
    """Page bookkeeping violated — a double-freed page id, a free touching
    the reserved zero page, or an id outside the pool.  Raised instead of
    silently corrupting the free list (a double-freed page handed to two
    requests at once would be a cross-request leak)."""


class PagePool:
    """Host-side page allocator over a device-resident pooled KV cache."""

    def __init__(self, model, codec, batch_slots: int, max_len: int,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 pool_bytes: Optional[int] = None):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.page_size = page_size
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.max_pages = -(-max_len // page_size)  # table width per slot
        # bytes of ONE page across all layers, from the model's own spec
        self.page_nbytes = sum(s.nbytes for s in model.cache_spec(1, page_size, codec).values())
        if pool_bytes is not None:
            n_pages = max(1, pool_bytes // self.page_nbytes)
        if n_pages is None:
            # default: enough pages for every slot at full max_len
            n_pages = batch_slots * self.max_pages
        self.n_pages = int(n_pages) + 1  # +1: reserved zero page (id 0)
        # the pool IS the model cache with (batch, max_len) -> (pages, page)
        self.cache = model.init_cache(self.n_pages, page_size, codec)
        self._free: list[int] = list(range(self.n_pages - 1, 0, -1))
        self._slot_pages: dict[int, list[int]] = {}

    # ---------------------------------------------------------- queries --
    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(1, n_tokens) // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        return len(self._free) >= self.pages_needed(n_tokens)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently mapped to slots."""
        total = self.n_pages - 1
        return self.used_pages / total if total else 0.0

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in self.cache.values())

    def capacity_requests(self, n_tokens: int) -> int:
        """How many requests of ``n_tokens`` the pool can hold concurrently."""
        return (self.n_pages - 1) // self.pages_needed(n_tokens)

    # ------------------------------------------------------- allocation --
    def allocate(self, slot: int, n_tokens: int) -> list[int]:
        """Reserve pages covering ``n_tokens`` for ``slot`` (worst case is
        reserved up-front: a request can never run out mid-flight).  On
        :class:`PoolExhausted` nothing is mutated — the free count and the
        slot map are exactly as before the call."""
        return self.reserve_pages(
            slot, self.pages_needed(min(n_tokens, self.max_len)))

    def reserve_pages(self, owner, n_pages: int) -> list[int]:
        """Map ``n_pages`` raw pages to ``owner`` — a batch slot id, or any
        hashable for out-of-band reservations (the fault drill's
        pool-pressure events squeeze capacity through this, never by
        reaching into the free list)."""
        if owner in self._slot_pages:
            raise ValueError(f"slot {owner!r} already holds pages")
        if n_pages > len(self._free):
            raise PoolExhausted(
                f"slot {owner!r} needs {n_pages} pages, "
                f"{len(self._free)} free")
        pages = [self._free.pop() for _ in range(n_pages)]
        self._slot_pages[owner] = pages
        return pages

    def free_slot(self, slot) -> list[int]:
        """Unmap ``slot``'s pages and return their ids — the engine zeroes
        them on-device before they can be handed to another request.
        Raises :class:`PageAccountingError` on a double-freed id, the
        reserved zero page, or an id outside the pool, with the mapping
        left untouched."""
        pages = self._slot_pages.get(slot, [])
        free = set(self._free)
        for p in pages:
            if p == 0:
                raise PageAccountingError(
                    f"slot {slot!r} maps the reserved zero page")
            if not 0 < p < self.n_pages:
                raise PageAccountingError(
                    f"slot {slot!r} maps page {p} outside the pool "
                    f"(n_pages={self.n_pages})")
            if p in free:
                raise PageAccountingError(
                    f"double free: page {p} of slot {slot!r} is already on "
                    "the free list")
        self._slot_pages.pop(slot, None)
        self._free.extend(pages)
        return pages

    def reset(self) -> None:
        """Zero the pooled cache and rebuild the free list — a replica
        'restart'.  Refuses while any owner still maps pages."""
        if self._slot_pages:
            raise PageAccountingError(
                f"reset() with pages still mapped: {sorted(map(str, self._slot_pages))}")
        for x in self.cache.values():
            x.zero_()
        self._free = list(range(self.n_pages - 1, 0, -1))

    def owners(self) -> list:
        """Everything currently mapping pages — batch slot ids and any
        out-of-band reservation owners."""
        return list(self._slot_pages)

    def free_ids(self) -> tuple[int, ...]:
        """Page ids that must be exactly zero right now: the reserved zero
        page plus every unallocated page (the zero-on-free invariant the
        router's integrity probe checks)."""
        return (0, *self._free)

    def page_table(self) -> np.ndarray:
        """(batch_slots, max_pages) int32; unmapped entries = 0 (zero page).
        Non-slot owners (out-of-band reservations) hold pages but have no
        table row — their pages are simply unavailable."""
        table = np.zeros((self.batch_slots, self.max_pages), np.int32)
        for slot, pages in self._slot_pages.items():
            if isinstance(slot, int) and 0 <= slot < self.batch_slots:
                table[slot, :len(pages)] = pages
        return table

    def slot_pages(self, slot) -> list[int]:
        return list(self._slot_pages.get(slot, ()))
