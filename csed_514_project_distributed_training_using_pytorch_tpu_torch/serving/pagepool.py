"""The paged-KV allocator: host-side bookkeeping for a fixed page pool.

The port's own copy of the JAX package's ``serving/pagepool.py`` (which imports no JAX; the
port keeps a copy so that it imports nothing of that package). The paged cache splits the
engine's KV store into fixed-size pages — device pools ``[num_pages, page_size, KV_H, Dh]``
per layer — and this module owns the HOST side of that store: which pages are free, which
slot holds which, and how many owners each page has. Nothing here touches a device tensor;
the pool is pure integer bookkeeping. Its ledger is pinned bitwise equal to the JAX
package's over a random walk (``tests/test_torch_port_serving.py``).

Design points (each one an engine invariant):

- **Reservation at admission.** The engine allocates a request's FULL page
  span (``ceil(total_len / page_size)``) before binding it to a slot, so
  exhaustion can only ever surface as a typed refusal (:class:`PagePoolExhausted`)
  at admission time — never as a mid-decode OOM with tokens already emitted.
  ``alloc`` is all-or-nothing for the same reason.
- **Refcounts, not copies.** Prefix-cache hits, park/resume, and snapshot
  sharing are ``ref`` bumps on already-written pages; a page frees only when
  its last owner drops it. Double-free and dangling-ref are hard errors —
  the property tests' no-leak/no-double-free invariants live on these checks.
- **The null page.** Page index 0 of every group is reserved: it is never
  allocated and never freed, and unmapped page-table entries point at it so
  a stray write (a parked slot's decode-program row, a dropped verify row)
  lands somewhere harmless instead of corrupting a neighbour. Reads through
  null entries only ever happen at positions the attention mask hides.
- **Group partitioning.** With slot-DP sharding (``serving/shard.py``), the
  pool's page axis shards over the ``data`` mesh axis; partitioning the free
  lists into ``groups`` contiguous ranges (one per dp group, each with its
  own null page) keeps every slot's pages inside its group's shard, so the
  paged gather never has a structural reason to cross dp shards.
"""

from __future__ import annotations

from typing import Iterable, Sequence


class PagePoolExhausted(RuntimeError):
    """Typed admission refusal: the pool cannot cover a reservation.

    Carries the shortfall so callers (engine admission, the server loop) can
    requeue and retry after a drain instead of guessing from a message."""

    def __init__(self, needed: int, free: int, *, group: int = 0):
        self.needed = int(needed)
        self.free = int(free)
        self.group = int(group)
        super().__init__(
            f"page pool exhausted: need {needed} pages, {free} free "
            f"in group {group} — admission refused (drain frees pages)")


class PagePool:
    """Free-list + refcount ledger for ``num_pages`` fixed-size pages.

    ``groups`` partitions the page-id space into equal contiguous ranges
    (``num_pages`` must divide evenly); group ``g`` allocates only from its
    own range and reserves its range's first page as the null page. The
    single-group default is the unsharded engine."""

    def __init__(self, num_pages: int, *, page_size: int, groups: int = 1):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if groups < 1:
            raise ValueError(f"groups must be >= 1, got {groups}")
        if num_pages % groups:
            raise ValueError(f"num_pages {num_pages} must divide evenly into "
                             f"{groups} groups")
        per = num_pages // groups
        if per < 2:
            raise ValueError(
                f"{num_pages} pages over {groups} groups leaves {per} per "
                f"group — need >= 2 (one null page + one allocatable)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.groups = int(groups)
        self._per_group = per
        self._ref = [0] * num_pages
        # Descending stacks so pop() hands out ascending ids — deterministic
        # allocation order, which the token-identity tests lean on.
        self._free: list[list[int]] = []
        for g in range(groups):
            lo, hi = g * per, (g + 1) * per
            self._ref[lo] = 1                     # the group's null page: pinned
            self._free.append(list(range(hi - 1, lo, -1)))
        # Ledger counters (page_stats / telemetry).
        self.allocs = 0
        self.frees = 0
        self.refusals = 0
        self.peak_in_use = 0

    # ------------------------------------------------------------------ queries

    def null_page(self, group: int = 0) -> int:
        """The reserved null page of ``group`` — what unmapped table entries
        point at."""
        self._check_group(group)
        return group * self._per_group

    def group_of(self, page: int) -> int:
        self._check_page(page)
        return page // self._per_group

    @property
    def usable_pages(self) -> int:
        """Allocatable pages (total minus the per-group null pages)."""
        return self.num_pages - self.groups

    def free_pages(self, group: int | None = None) -> int:
        if group is None:
            return sum(len(f) for f in self._free)
        self._check_group(group)
        return len(self._free[group])

    def refcount(self, page: int) -> int:
        self._check_page(page)
        return self._ref[page]

    # ------------------------------------------------------------------ alloc

    def alloc(self, n: int, *, group: int = 0) -> list[int]:
        """Take ``n`` pages from ``group``'s free list (refcount 1 each).

        ALL-OR-NOTHING: raises :class:`PagePoolExhausted` without taking any
        page when fewer than ``n`` are free — the reservation-at-admission
        contract has no partial success."""
        self._check_group(group)
        if n < 0:
            raise ValueError(f"cannot alloc {n} pages")
        free = self._free[group]
        if n > len(free):
            self.refusals += 1
            raise PagePoolExhausted(n, len(free), group=group)
        pages = [free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.allocs += n
        self.peak_in_use = max(self.peak_in_use,
                               self.usable_pages - self.free_pages())
        return pages

    def ref(self, pages: Iterable[int]) -> None:
        """Add one owner to each page (prefix-cache share, park transfer).
        Refusing null and free pages keeps a stale id from resurrecting."""
        pages = list(pages)
        for p in pages:                            # validate before mutating
            self._check_page(p)
            if p % self._per_group == 0:
                raise ValueError(f"page {p} is a null page — never shared")
            if self._ref[p] <= 0:
                raise ValueError(f"page {p} is free — cannot ref a page "
                                 f"nobody owns (dangling id)")
        for p in pages:
            self._ref[p] += 1

    def unref(self, pages: Iterable[int]) -> None:
        """Drop one owner from each page; a page whose last owner leaves goes
        back to its group's free list. Double-free is a hard error."""
        pages = list(pages)
        for p in pages:
            self._check_page(p)
            if p % self._per_group == 0:
                raise ValueError(f"page {p} is a null page — never freed")
            if self._ref[p] <= 0:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free[p // self._per_group].append(p)
                self.frees += 1

    # ------------------------------------------------------------------ stats

    def reset_counters(self) -> None:
        """Zero the ledger counters (engine ``reset_stats`` — benchmark
        hygiene) without touching ownership state; peak restarts from the
        CURRENT residency so a warmup can't inflate the measured run."""
        self.allocs = 0
        self.frees = 0
        self.refusals = 0
        self.peak_in_use = self.usable_pages - self.free_pages()

    def stats(self) -> dict:
        """The ``kv_pages`` telemetry payload (fragmentation is the engine's
        to add — only it knows live token counts)."""
        free = self.free_pages()
        in_use = self.usable_pages - free
        shared = sum(1 for g in range(self.groups)
                     for p in range(g * self._per_group + 1,
                                    (g + 1) * self._per_group)
                     if self._ref[p] >= 2)
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "groups": self.groups,
            "usable": self.usable_pages,
            "free": free,
            "in_use": in_use,
            "shared": shared,
            "allocs": self.allocs,
            "frees": self.frees,
            "refusals": self.refusals,
            "peak_in_use": self.peak_in_use,
        }

    # ------------------------------------------------------------------ checks

    def _check_group(self, group: int) -> None:
        if not 0 <= group < self.groups:
            raise ValueError(f"group {group} outside [0, {self.groups})")

    def _check_page(self, page: int) -> None:
        if not 0 <= page < self.num_pages:
            raise ValueError(f"page {page} outside [0, {self.num_pages})")


def pages_for(tokens: int, page_size: int) -> int:
    """Pages covering ``tokens`` positions — THE reservation formula
    (``ceil(tokens / page_size)``), one owner so the engine, the prefix
    cache's share math, and the planner's pricing can never disagree."""
    if tokens < 0:
        raise ValueError(f"cannot page {tokens} tokens")
    return -(-tokens // page_size)
