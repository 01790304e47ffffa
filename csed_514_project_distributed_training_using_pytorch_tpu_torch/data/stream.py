"""A sharded token corpus on disk and its deterministic cursor loader.

The port's own copy of the JAX package's ``data/stream.py`` (numpy and the standard
library only; the port imports nothing of the JAX package). Plans, batches, digests and
cursors are bitwise the JAX package's for the same corpus, seed and batch size.

A corpus directory holds fixed-length token-sequence shards and a ``corpus.json`` that
lists them with their sha256. ``StreamLoader``'s epoch order is a pure function of
``(seed, epoch)``: a shard visit order and one permutation per shard, drawn from
``default_rng(SeedSequence([seed, epoch]))``. Its ``cursor`` (shard, offset within the
shard, the epoch plan's CRC) is what ``utils/checkpoint.py::save_versioned`` stamps into
the checkpoint manifest; a resume re-derives the plan, checks the stored cursor against it
(``verify_cursor``: a corpus that changed under a checkpoint raises) and replays the rest
of the stream bitwise.

Every second the consumer spends blocked on the loader (shard reads, hashing, the
optional ``throttle_s`` brake) accumulates in ``wait_s``; ``pop_wait_s`` hands it to the
trainer's epoch accounting.

Corpus layout::

    corpus.json   {"version": 1, "tokenizer": "byte", "vocab": V, "seq_len": S,
                   "shards": [{"file": "shard_0000.npy", "sequences": N,
                               "sha256": "..."}, ...],
                   "eval": {"file": "eval.npy", "sequences": M, "sha256": ...}}
    shard_*.npy   uint16 [N, S] token-id matrices (BOS is not stored; the model
                  prepends it; vocab ids are 0..V-1)

The loader yields host numpy batches; where they live is the trainer's business.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import time
import zlib

import numpy as np

META_NAME = "corpus.json"

#: Cursor schema version — bump on any change to the fields or their meaning.
CURSOR_VERSION = 1


class CorpusError(ValueError):
    """A corpus directory that cannot be trusted: missing/torn meta, a shard
    whose bytes do not match the recorded sha256, or a resume cursor that the
    re-derived epoch plan contradicts (the corpus changed under a checkpoint)."""


def load_meta(corpus_dir: str) -> dict:
    """Read + sanity-check ``corpus.json``. Raises :class:`CorpusError` with the
    offending path (never a raw KeyError) — this is the first call of every
    consumer and must name what is wrong."""
    path = os.path.join(corpus_dir, META_NAME)
    try:
        with open(path) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise CorpusError(f"unreadable corpus meta {path}: {e}") from None
    for key in ("version", "vocab", "seq_len", "shards"):
        if key not in meta:
            raise CorpusError(f"corpus meta {path} missing {key!r}")
    if not meta["shards"]:
        raise CorpusError(f"corpus meta {path} lists zero shards")
    return meta


def _load_shard(corpus_dir: str, entry: dict, *, verify: bool = True) -> np.ndarray:
    path = os.path.join(corpus_dir, entry["file"])
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CorpusError(f"unreadable corpus shard {path}: {e}") from None
    if verify and entry.get("sha256"):
        digest = hashlib.sha256(raw).hexdigest()
        if digest != entry["sha256"]:
            raise CorpusError(
                f"corpus shard {path} sha256 mismatch (manifest "
                f"{entry['sha256'][:12]}..., file {digest[:12]}...) — the corpus "
                f"changed under its meta; rebuild it")
    arr = np.load(io.BytesIO(raw), allow_pickle=False)
    if arr.ndim != 2:
        raise CorpusError(f"corpus shard {path} is {arr.ndim}-d, expected [N, S]")
    return arr


def eval_tokens(corpus_dir: str, *, verify: bool = True) -> np.ndarray | None:
    """The held-out eval split as one ``[M, S]`` int32 array, or None when the
    corpus was built without one (``--eval-frac 0``)."""
    meta = load_meta(corpus_dir)
    entry = meta.get("eval")
    if not entry:
        return None
    return _load_shard(corpus_dir, entry, verify=verify).astype(np.int32)


class StreamLoader:
    """Deterministic shard-shuffling batch stream over a token corpus.

    The epoch plan — shard visit order plus one intra-shard permutation per
    shard — is drawn from ``default_rng(SeedSequence([seed, epoch]))`` exactly
    once per epoch, eagerly (index-level only, cheap: the plan never loads
    token bytes). The epoch's sequence stream is the concatenation of the
    permuted shards in visit order; batches are consecutive ``batch_size``
    slices of that stream; the ragged tail is dropped so every epoch has the
    same ``batches_per_epoch`` (the captured epoch's step count must
    not wobble across epochs).

    Shard DATA loads lazily, one shard resident at a time, sha256-verified on
    first touch per epoch. ``throttle_s`` sleeps that long per batch: a
    data-starvation brake that shows the trainer's data wait is measured.
    """

    def __init__(self, corpus_dir: str, batch_size: int, *, seed: int = 0,
                 throttle_s: float = 0.0, verify: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.corpus_dir = corpus_dir
        self.meta = load_meta(corpus_dir)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.throttle_s = float(throttle_s)
        self.verify = verify
        self.vocab = int(self.meta["vocab"])
        self.seq_len = int(self.meta["seq_len"])
        self._shards = list(self.meta["shards"])
        self._sizes = [int(e["sequences"]) for e in self._shards]
        self.num_sequences = sum(self._sizes)
        if self.num_sequences < self.batch_size:
            raise CorpusError(
                f"corpus {corpus_dir} has {self.num_sequences} sequences — "
                f"fewer than one batch of {self.batch_size}")
        #: Seconds the consumer spent blocked on this loader (reads, hashing,
        #: throttle). Monotonic; read the per-window delta via pop_wait_s().
        self.wait_s = 0.0
        # One-slot RAW shard cache: the visit order touches each shard once
        # per epoch, so a single slot is a perfect within-epoch cache and a
        # best-effort cross-epoch one.
        self._cached: tuple[int, np.ndarray] | None = None

    # -- epoch plan (pure in (seed, epoch)) ----------------------------------

    @property
    def batches_per_epoch(self) -> int:
        return self.num_sequences // self.batch_size

    def epoch_plan(self, epoch: int) -> dict:
        """The epoch's full order: ``{"order": shard visit order,
        "perms": {shard: permutation}, "crc": plan digest}``. Index-level only
        — no token bytes. The CRC digests the order and every permutation, so
        two corpora that merely LOOK alike (same shard count/sizes) still
        collide only if the actual plan is identical."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(epoch)]))
        order = rng.permutation(len(self._shards)).astype(np.int64)
        perms = {int(s): rng.permutation(self._sizes[int(s)]).astype(np.int64)
                 for s in order}
        crc = zlib.crc32(order.tobytes())
        for s in order:
            crc = zlib.crc32(perms[int(s)].tobytes(), crc)
        return {"order": order, "perms": perms, "crc": int(crc)}

    def cursor(self, epoch: int, batch: int, *, plan: dict | None = None) -> dict:
        """The durable resume position BEFORE batch ``batch`` of ``epoch``:
        which shard the stream is inside, how many of its sequences this epoch
        already consumed, and the epoch-plan CRC that pins the shuffle RNG
        state (the plan is pure in ``(seed, epoch)``, so the CRC *is* the RNG
        state, one derivation step early). This dict is what
        ``save_versioned(cursor=...)`` keys into the checkpoint manifest."""
        plan = plan or self.epoch_plan(epoch)
        pos = int(batch) * self.batch_size
        if not 0 <= pos <= self.num_sequences:
            raise ValueError(f"batch {batch} outside epoch "
                             f"(batches_per_epoch {self.batches_per_epoch})")
        shard, offset = int(plan["order"][0]), 0
        remaining = pos
        for s in plan["order"]:
            size = self._sizes[int(s)]
            if remaining < size:
                shard, offset = int(s), remaining
                break
            remaining -= size
        else:                               # pos == num_sequences: epoch end
            shard, offset = int(plan["order"][-1]), self._sizes[
                int(plan["order"][-1])]
        return {"version": CURSOR_VERSION, "kind": "stream",
                "seed": self.seed, "epoch": int(epoch), "batch": int(batch),
                "shard": shard, "offset": int(offset),
                "plan_crc": int(plan["crc"])}

    def verify_cursor(self, cursor: dict) -> tuple[int, int]:
        """Validate a manifest cursor against THIS corpus and return
        ``(epoch, batch)`` to resume from. The re-derived plan must agree with
        the stored shard/offset/CRC — a mismatch means the corpus (or seed)
        changed under the checkpoint, and silently resuming would feed a
        different stream than the one the checkpoint's step count paid for."""
        if cursor.get("kind") != "stream":
            raise CorpusError(f"not a stream cursor: {cursor!r}")
        if cursor.get("version") != CURSOR_VERSION:
            raise CorpusError(f"unknown cursor version {cursor.get('version')!r} "
                              f"(this build speaks {CURSOR_VERSION})")
        if int(cursor.get("seed", -1)) != self.seed:
            raise CorpusError(
                f"cursor seed {cursor.get('seed')} != loader seed {self.seed} — "
                f"resuming would reshuffle the stream")
        epoch, batch = int(cursor["epoch"]), int(cursor["batch"])
        derived = self.cursor(epoch, batch)
        for key in ("shard", "offset", "plan_crc"):
            if derived[key] != cursor.get(key):
                raise CorpusError(
                    f"cursor {key} mismatch (manifest {cursor.get(key)!r}, "
                    f"derived {derived[key]!r}) — the corpus changed under the "
                    f"checkpoint; rebuild or restart from scratch")
        return epoch, batch

    # -- batch stream --------------------------------------------------------

    def _shard_data(self, shard: int) -> np.ndarray:
        """One shard's RAW token matrix, sha256-verified on load, one-slot
        cached. Callers time the call — blocked time charges to ``wait_s``
        at the iter_batches site, once."""
        if self._cached and self._cached[0] == shard:
            return self._cached[1]
        data = _load_shard(self.corpus_dir, self._shards[shard],
                           verify=self.verify)
        self._cached = (shard, data)
        return data

    def iter_batches(self, epoch: int, *, start_batch: int = 0):
        """Yield ``[batch_size, seq_len]`` int32 batches of epoch ``epoch``,
        starting at ``start_batch`` (the cursor's resume entry point — skipped
        batches cost index arithmetic only, never shard reads). Time the
        consumer spends blocked in here (shard IO, hashing, throttle)
        accumulates in ``wait_s``."""
        plan = self.epoch_plan(epoch)
        b = self.batch_size
        # The permuted global stream as (shard, local index) pairs is implied;
        # walk it shard-by-shard, slicing batches across shard boundaries.
        start_pos = int(start_batch) * b
        end_pos = self.batches_per_epoch * b
        if start_pos >= end_pos:
            return
        pos = 0
        pending: list[np.ndarray] = []
        pending_n = 0
        for s in plan["order"]:
            s = int(s)
            size = self._sizes[s]
            if pos + size <= start_pos:     # wholly before the cursor: skip
                pos += size                  # without touching the bytes
                continue
            lo = max(0, start_pos - pos)
            hi = min(size, end_pos - pos)
            if lo < hi:
                t0 = time.perf_counter()
                data = self._shard_data(s)
                # Gather only the cursor-onward slice of the permutation — the
                # resume cost of a skipped prefix is index arithmetic, not IO.
                chunk = data[plan["perms"][s][lo:hi]]
                self.wait_s += time.perf_counter() - t0
                pending.append(chunk)
                pending_n += len(chunk)
                while pending_n >= b:
                    t1 = time.perf_counter()
                    flat = (pending[0] if len(pending) == 1
                            else np.concatenate(pending, axis=0))
                    batch, rest = flat[:b], flat[b:]
                    pending = [rest] if len(rest) else []
                    pending_n = len(rest)
                    if self.throttle_s:
                        time.sleep(self.throttle_s)
                    self.wait_s += time.perf_counter() - t1
                    yield np.ascontiguousarray(batch, dtype=np.int32)
            pos += size
            if pos >= end_pos:
                break

    def epoch_tokens(self, epoch: int, *, start_batch: int = 0) -> np.ndarray:
        """Materialize the epoch's (remaining) batch stream as one
        ``[n_batches * batch_size, seq_len]`` int32 array, in stream order —
        the device-resident feed of the epoch program. The loader
        wall (reads, hashing, throttle) lands in ``wait_s`` as usual."""
        batches = list(self.iter_batches(epoch, start_batch=start_batch))
        if not batches:
            return np.zeros((0, self.seq_len), np.int32)
        return np.concatenate(batches, axis=0)

    def stream_digest(self, epoch: int, *, start_batch: int = 0) -> int:
        """CRC32 of the epoch's (remaining) token bytes in stream order — the
        cheap bitwise pin to compare across a kill/resume boundary."""
        crc = 0
        for batch in self.iter_batches(epoch, start_batch=start_batch):
            crc = zlib.crc32(batch.tobytes(), crc)
        return int(crc)

    def pop_wait_s(self) -> float:
        """Return and reset the accumulated consumer-blocked seconds — the
        per-epoch ``data_s`` charge the trainers emit."""
        w, self.wait_s = self.wait_s, 0.0
        return w
