"""Host-side prefix KV reuse: an LRU of prefilled prompt caches keyed by tokens.

The port's own copy of the JAX package's ``serving/prefix_cache.py`` (which imports no
JAX); only ``_tree_nbytes`` differs, measuring torch tensors as well as numpy arrays.
Repeated prompt prefixes (the system-prompt pattern) pay the prefill tax once:
after the engine finishes prefilling a prompt, it snapshots the slot's full
``[S, KV_H, Dh]`` K/V planes (per layer) into this cache; a later admission whose
prompt shares a token prefix gets those planes copied into its fresh slot and only
chunk-prefills the remainder — a full-prefix hit skips prefill entirely.

Why a token-prefix match is sufficient: cache row ``p`` holds the K/V of the
shift-right input at position ``p`` (BOS at 0, ``prompt[p-1]`` after), computed
from hidden states that depend only on positions ``<= p`` — i.e. rows ``[0, M)``
are a pure function of ``prompt[:M-1]`` (and the params). So if a stored entry's
tokens and a new prompt agree on their first ``M`` tokens, the entry's first ``M``
rows are byte-for-byte the rows the new prompt's prefill would have produced, at
ANY ``M`` up to the common prefix — no chunk-boundary alignment required. Rows
beyond ``M`` in the installed planes are the donor's leftovers; they are
invisible (the per-slot ``pos <= t`` mask) until the chunk/decode path overwrites
them, the same garbage-tolerance the engine's slot recycling already relies on.

The structure is deliberately host-simple: an ``OrderedDict`` LRU over whole-slot
snapshots (entries are device tensors — eviction just drops the reference; a paged
engine's entries are page ids whose refcounts ``on_evict`` returns), exact
``np.ndarray`` token comparison (no hash-collision exposure), O(entries ·
prefix_len) lookup. Capacity is counted in entries; each entry costs one slot's
full cache (``layers · 2 · S · KV_H · Dh`` elements).
"""

from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np


def common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the longest common token prefix — THE matching rule (the JAX
    package's router routes by the same rule, so a fleet's affinity and this
    cache agree on what a hit is)."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


def _tree_nbytes(planes) -> int:
    """Measured bytes of a planes payload: ``size * itemsize`` summed over
    every array leaf of a (possibly nested) dict — so an int8 entry is charged
    its int8 codes plus its f32 scale planes, never a logical fp32 size.
    Duck-typed (torch tensors by ``numel · element_size``, numpy arrays by
    ``size · itemsize``); reads only shape metadata, never a buffer. Non-array
    leaves (layout stamps, step counters, test sentinels) charge zero bytes."""
    total, stack = 0, [planes]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif hasattr(node, "element_size") and hasattr(node, "numel"):
            total += node.numel() * node.element_size()
        elif hasattr(node, "size") and hasattr(node, "dtype"):
            total += int(node.size) * node.dtype.itemsize
    return total


@dataclasses.dataclass
class PrefixEntry:
    """One stored prefill: the prompt tokens whose rows the planes hold, the
    per-layer ``{"k": [S, KV_H, Dh], "v": ...}`` device planes (rows
    ``[0, len(tokens))`` valid, the rest donor garbage), the plane
    ``layout`` signature (``ops.quant.cache_layout``) the planes were written
    under — dtype + scale-plane structure, the compatibility key — and the
    entry's measured ``nbytes`` (what it charges a byte budget)."""

    tokens: np.ndarray
    planes: dict
    layout: str | None = None
    nbytes: int = 0


class PrefixCache:
    """LRU of ``PrefixEntry``s. ``capacity`` is the max entry count (>= 1).

    ``layout`` is the owning engine's plane-layout signature: every insert is
    stamped with it and every lookup filters on it, so a snapshot written
    under one dtype/scale layout (say fp32 planes) can never silently install
    into an engine running another (int8 planes + per-head scales) — the
    bytes would be reinterpreted garbage. Mismatches are counted in
    ``layout_rejects`` rather than raised: a foreign-layout entry is simply
    not a hit (the regression case is a cache object handed across engines).

    ``capacity_bytes`` adds a MEASURED byte budget on top of the entry count:
    every insert is charged its leaves' actual ``size * itemsize`` (or an
    explicit ``nbytes`` — the paged engine passes its page-span cost), so an
    int8 engine's entries cost what int8 planes plus f32 scales cost, not a
    logical fp32 figure — the same budget holds ~3-4x the entries. ``None``
    (the default) keeps the pure entry-count LRU.

    ``on_evict`` is called with the dropped entry's ``planes`` whenever an
    entry leaves for ANY reason (LRU pressure, byte pressure, covered-drop,
    ``clear``) — the paged engine's hook for returning page refcounts; the
    callback runs under the cache lock, so it must not re-enter the cache."""

    def __init__(self, capacity: int, *, layout: str | None = None,
                 capacity_bytes: int | None = None,
                 on_evict=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if capacity_bytes is not None and capacity_bytes < 1:
            raise ValueError(f"capacity_bytes must be >= 1, "
                             f"got {capacity_bytes}")
        self.capacity = int(capacity)
        self.capacity_bytes = (None if capacity_bytes is None
                               else int(capacity_bytes))
        self.on_evict = on_evict
        self.layout = layout
        # One reentrant lock serializes the OrderedDict mutations (lookup
        # mutates too: move_to_end + counters), so the cache may be shared
        # across threads as the reference's is.
        self._lock = threading.RLock()
        self._entries: collections.OrderedDict[int, PrefixEntry] = \
            collections.OrderedDict()
        self._next_key = 0
        self.bytes = 0                # measured bytes of the resident entries
        self.queries = 0
        self.hits = 0
        self.hit_tokens = 0
        self.insertions = 0
        self.evictions = 0
        self.layout_rejects = 0

    def __len__(self) -> int:
        return len(self._entries)

    _common_prefix = staticmethod(common_prefix_len)

    def lookup(self, prompt: np.ndarray, *, min_len: int = 1,
               layout: str | None = None) -> tuple[int, dict | None]:
        """Longest-common-prefix match against the stored entries: returns
        ``(hit_len, planes)`` for the best entry (``(0, None)`` on a miss) and
        refreshes its LRU position. ``hit_len`` may be any length up to
        ``len(prompt)`` — the caller chunk-prefills ``[hit_len, P)``.

        ``min_len`` floors a PARTIAL hit's useful length (the engine passes its
        smallest chunk size): installing a whole plane to save fewer prompt
        tokens than one chunk costs more than it saves, so coincidental 1-token
        overlaps between random prompts don't trigger copies. A full-prompt hit
        always qualifies — it skips prefill entirely.

        ``layout`` (default: the cache's own) must match an entry's recorded
        plane layout for it to hit — the dtype/scale compatibility guard."""
        with self._lock:
            self.queries += 1
            want = self.layout if layout is None else layout
            prompt = np.asarray(prompt, np.int32)
            best_key, best_len, rejected = None, 0, False
            for key, entry in self._entries.items():
                if entry.layout != want:
                    rejected = True
                    continue
                m = self._common_prefix(entry.tokens, prompt)
                if m > best_len and (m == len(prompt) or m >= min_len):
                    best_key, best_len = key, m
            # At most one reject per LOOKUP: the counter answers "how many
            # lookups saw a layout-incompatible entry", not "entry
            # comparisons".
            if rejected:
                self.layout_rejects += 1
            if best_key is None:
                return 0, None
            self._entries.move_to_end(best_key)
            self.hits += 1
            self.hit_tokens += best_len
            return best_len, self._entries[best_key].planes

    def insert(self, tokens: np.ndarray, planes: dict, *,
               layout: str | None = None, nbytes: int | None = None) -> None:
        """Store a finished prefill (and drop any entry the new one strictly
        covers — same tokens as a prefix of the new entry's AND the same plane
        layout, so every future lookup the old entry could win, the new one
        wins longer). The entry is stamped with ``layout`` (default: the
        cache's own) — the key :meth:`lookup` filters on — and charged
        ``nbytes`` against the byte budget (default: the planes' measured
        leaf bytes)."""
        with self._lock:
            layout = self.layout if layout is None else layout
            tokens = np.asarray(tokens, np.int32).copy()
            nbytes = _tree_nbytes(planes) if nbytes is None else int(nbytes)
            covered = [
                k for k, e in self._entries.items()
                if e.layout == layout and len(e.tokens) <= len(tokens)
                and self._common_prefix(e.tokens, tokens) == len(e.tokens)]
            for k in covered:
                self._drop(k)
            self._entries[self._next_key] = PrefixEntry(
                tokens=tokens, planes=planes, layout=layout, nbytes=nbytes)
            self.bytes += nbytes
            self._next_key += 1
            self.insertions += 1
            while len(self._entries) > self.capacity or (
                    self.capacity_bytes is not None
                    and self.bytes > self.capacity_bytes
                    and len(self._entries) > 1):
                self._drop(next(iter(self._entries)))     # LRU victim
                self.evictions += 1

    def _drop(self, key: int) -> None:
        """Remove one entry (lock held), settle the byte ledger, and hand its
        planes to ``on_evict`` — the ONE exit path for entries, so a paged
        engine's page refcounts can never leak through an eviction flavor."""
        entry = self._entries.pop(key)
        self.bytes -= entry.nbytes
        if self.on_evict is not None:
            self.on_evict(entry.planes)

    def clear(self) -> None:
        """Drop every entry (``on_evict`` fires per entry) — engine
        ``reset_stats`` and allocator-pressure recovery."""
        with self._lock:
            while self._entries:
                self._drop(next(iter(self._entries)))

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "bytes": self.bytes,
                "capacity_bytes": self.capacity_bytes,
                "queries": self.queries,
                "hits": self.hits,
                "hit_tokens": self.hit_tokens,
                "insertions": self.insertions,
                "evictions": self.evictions,
                "layout_rejects": self.layout_rejects,
            }
