"""Continuous-batching decode engine: N requests through a fixed ``[num_slots]`` batch.

Counterpart of the JAX package's ``serving/engine.py``. One decode step advances every slot
one position; every source of per-request variation is data, never shape: per-slot K/V
caches written at each slot's own position (``models.lm.decode_step_slots``), per-slot
positions, prompts and length bounds, and per-request sampling parameters
(greedy/temperature/top-k/top-p, ``filter_logits_per_slot``). Finished slots are freed on
the host and refilled from the queue between steps.

Prompts are prefilled in chunks (``models.lm.prefill_chunk``): a length-P prompt fills its
slot's cache in ``plan_prefill``'s chunks drawn from a small static size set
(``prefill_chunk_sizes``), interleaved with decode under ``prefill_chunk_budget`` chunks
per step. ``prefill_chunk_sizes=()`` teacher-forces prompts through the decode loop one
token per step instead (the contiguous layout only).

Two KV layouts. ``"contiguous"``: per-slot planes ``[num_slots, S, KV_H, Dh]``.
``"paged"``: per-layer page pools ``[num_pages, page_size, KV_H, Dh]`` with the host
allocator ``serving.pagepool.PagePool`` and a per-slot page table; a request's whole page
span is reserved at admission, so pool exhaustion surfaces only there, as the typed
``KVPagesExhausted`` refusal (``run`` requeues and drains). The paged decode step attends
through the table with the hand-written paged-decode kernel on the card
(``ops.paged_attention.paged_attend``; its plain version on the CPU).

The engine runs on ``device`` (the card by default; the CPU must be asked for). Host state
(positions, lengths, sampling parameters, the page table) lives in numpy and travels to the
device through pinned staging buffers without a host sync; the caches and the prompt
buffer stay on the device. The host syncs once per step: the ``[num_slots]`` token fetch.
Prompt positions are forced on the host after that fetch (the emitted token at ``t <
prompt_len`` is the prompt's), and the sampling filters run only in steps where a slot
samples. Temperature sampling draws Gumbel noise from a ``torch.Generator`` seeded from
``seed``: reproducible for a seed and a request mix, not bitwise equal to ``jax.random``.

Not ported yet (each raises ``ValueError`` naming ROADMAP A9): the prefix cache
(``prefix_cache_entries``/``prefix_cache_bytes``), quantized KV planes and weights
(``kv_dtype`` other than ``"model"``, ``quant_policy`` other than ``"off"``), speculative
decoding (``spec``/``drafter``) and the serve mesh (``mesh``); park/preempt, the
``Server`` front end, ``RequestQueue`` and tenancy, and tracing wait too.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm as lm_mod
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    MASK_VALUE,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.pagepool import (
    PagePool,
    PagePoolExhausted,
    pages_for,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    Request,
    SamplingParams,
)


@dataclasses.dataclass
class Completion:
    """A finished request: the emitted token stream (prompt prefix + generated suffix)
    and its latency accounting. ``finish`` is ``"ok"`` or ``"timeout"`` (deadline hit —
    for a mid-decode timeout ``tokens`` holds the partial stream)."""

    request: Request
    tokens: np.ndarray
    finish: str
    prompt_len: int
    new_tokens: int
    queue_wait_s: float | None = None
    ttft_s: float | None = None       # arrival -> first GENERATED token
    tpot_s: float | None = None       # mean inter-token time after the first
    e2e_s: float | None = None        # arrival -> completion

    @property
    def ok(self) -> bool:
        return self.finish == "ok"


class KVPagesExhausted(RuntimeError):
    """Typed admission backpressure from the paged KV store: the page pool could not
    cover every requested reservation. Raised by ``admit_many`` AFTER binding what fit.

    ``admitted`` holds the ``(slot, request)`` pairs this call did bind; ``refused`` the
    requests (FIFO order) left unbound with their slots free — requeue them and retry
    once decode frees pages. ``needed``/``free`` carry the first refusal's shortfall."""

    def __init__(self, admitted: list, refused: list, cause: PagePoolExhausted):
        self.admitted = admitted
        self.refused = refused
        self.needed = cause.needed
        self.free = cause.free
        super().__init__(
            f"kv page pool exhausted: {len(refused)} admission(s) refused "
            f"(first needs {cause.needed} pages, {cause.free} free), "
            f"{len(admitted)} admitted — requeue and retry after a drain")


def filter_logits_per_slot(log_probs: torch.Tensor, top_k: torch.Tensor,
                           top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k/top-p masking with ``top_k``/``top_p`` as ``[B]`` tensors, the JAX
    package's semantics: row ``b`` keeps entries ``>=`` its k-th largest (``top_k[b] = 0``
    keeps all) and, of those, the entries ``>=`` the smallest member of the nucleus of the
    renormalised top-k survivors (``top_p[b] = 1.0`` keeps every survivor with mass).
    Masked entries become ``MASK_VALUE``."""
    v = log_probs.shape[-1]
    sorted_lp = torch.sort(log_probs, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, v).long()
    kth = torch.gather(sorted_lp, -1, (k[:, None] - 1).clamp(0, v - 1))
    out = torch.where(log_probs < kth, MASK_VALUE, log_probs)
    sorted_masked = torch.sort(out, dim=-1, descending=True).values
    probs = torch.softmax(sorted_masked, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs                 # exclusive mass
    kept = before < top_p[:, None]                               # the argmax always kept
    thresh = torch.where(kept, sorted_masked, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(out < thresh, MASK_VALUE, out)


def sample_categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from ``softmax(logits)`` by the Gumbel-max rule, with noise from
    ``generator`` (on the logits' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def greedy_chunk_plan(sizes: tuple[int, ...], start: int,
                      end: int) -> list[tuple[int, int, int]]:
    """``(start, length, chunk_size)`` triples covering ``[start, end)``: greedily the
    biggest configured size that fits, then the smallest size PADDED for the tail, so a
    single configured size ``c`` costs exactly ``ceil((end - start) / c)`` invocations
    (the JAX package's ``serving.spec.drafter.greedy_chunk_plan``)."""
    plan = []
    while start < end:
        rem = end - start
        fit = [c for c in sizes if c <= rem]
        size = max(fit) if fit else sizes[0]
        length = min(rem, size)
        plan.append((start, length, size))
        start += length
    return plan


def _refuse_unported(*, prefix_cache_entries, prefix_cache_bytes, kv_dtype, quant_policy,
                     spec, drafter, mesh) -> None:
    if prefix_cache_entries or prefix_cache_bytes:
        raise ValueError("the prefix cache is not ported yet (ROADMAP A9: "
                         "serving/prefix_cache.py)")
    if kv_dtype != "model":
        raise ValueError(f"kv_dtype {kv_dtype!r} is not ported yet (ROADMAP A9: "
                         f"ops/quant.py); the port serves kv_dtype='model'")
    if quant_policy != "off":
        raise ValueError(f"quant_policy {quant_policy!r} is not ported yet (ROADMAP A9: "
                         f"ops/quant.py); the port serves quant_policy='off'")
    if spec != "off" or drafter is not None:
        raise ValueError("speculative decoding is not ported yet (ROADMAP A9: "
                         "serving/spec/)")
    if mesh is not None:
        raise ValueError("the serve mesh is not ported yet (ROADMAP A9: serving/shard.py)")


class ContinuousBatchingEngine:
    """Slot-based continuous batching over ``models.lm``'s KV-cache decoder.

    ``params`` is the model's flat parameter dict (``TransformerLM.init``, or
    ``models.transformer.params_from_jax`` of a JAX tree); it is moved to ``device``.
    Single-threaded: callers drive ``step``/``run`` from one thread."""

    def __init__(self, model: lm_mod.TransformerLM, params: dict, *, num_slots: int,
                 seed: int = 0,
                 prefill_chunk_sizes: tuple[int, ...] = lm_mod.PREFILL_CHUNK_SIZES,
                 prefill_chunk_budget: int = 1,
                 prefix_cache_entries: int = 0,
                 prefix_cache_bytes: int | None = None,
                 kv_dtype: str = "model",
                 quant_policy: str = "off",
                 kv_layout: str = "contiguous",
                 page_size: int = 64,
                 num_pages: int | None = None,
                 spec: str = "off",
                 drafter: object = None,
                 mesh: object = None,
                 device: torch.device | str = "cuda"):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        _refuse_unported(prefix_cache_entries=prefix_cache_entries,
                         prefix_cache_bytes=prefix_cache_bytes, kv_dtype=kv_dtype,
                         quant_policy=quant_policy, spec=spec, drafter=drafter, mesh=mesh)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise ValueError("device 'cuda' needs a CUDA device, and "
                             "torch.cuda.is_available() is false: pass device='cpu'")
        self.model = model
        self.params = {name: p.to(self.device) for name, p in params.items()}
        self.num_slots = b = int(num_slots)
        s = model.seq_len
        self.steps = 0                # decode steps executed
        self.slot_steps = 0           # sum of occupied slots over steps (occupancy)
        self.generated_tokens = 0     # emitted non-forced tokens
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r} "
                             f"(choices: contiguous, paged)")
        self.kv_layout = kv_layout
        self._pagepool: PagePool | None = None
        self._table: np.ndarray | None = None
        self._table_dev: torch.Tensor | None = None
        if kv_layout == "paged":
            if not tuple(prefill_chunk_sizes or ()):
                raise ValueError("the paged KV layout rides the chunked-prefill path — "
                                 "enable prefill_chunk_sizes to use it")
            # The page size clips to seq_len; the default pool matches the contiguous
            # layout token for token (full-context reservations plus the null page).
            ps = max(1, min(int(page_size), s))
            p_max = lm_mod.pages_per_slot(s, ps)
            if num_pages is None:
                num_pages = b * p_max + 1
            self.page_size = ps
            self._pagepool = PagePool(int(num_pages), page_size=ps)
            self._cache = lm_mod.init_page_pool(model, int(num_pages), page_size=ps,
                                                device=self.device)
            self._table = np.full((b, p_max), self._pagepool.null_page(), np.int32)
            self._slot_pages: list[list[int]] = [[] for _ in range(b)]
        else:
            self.page_size = None
            self._cache = lm_mod.init_cache(model, b, device=self.device)
        self._ids = np.full((b,), model.vocab_size - 1, np.int32)   # BOS
        self._t = np.zeros((b,), np.int32)
        self._active = np.zeros((b,), bool)
        # The [B, S] prompt buffer stays on the device (prefill reads it there); admission
        # writes the admitted rows in one transfer.
        self._prompt = torch.zeros((b, s), dtype=torch.int32, device=self.device)
        self._prompt_len = np.zeros((b,), np.int32)
        self._fill_len = np.zeros((b,), np.int32)      # positions that arrive by prefill
        self._stream: list[np.ndarray | None] = [None] * b
        self._total_len = np.zeros((b,), np.int32)
        self._temp = np.zeros((b,), np.float32)
        self._top_k = np.zeros((b,), np.int32)
        self._top_p = np.ones((b,), np.float32)
        self._requests: list[Request | None] = [None] * b
        self._out: list[list[int]] = [[] for _ in range(b)]
        self._admit_s = np.zeros((b,), np.float64)
        self._first_tok_s: list[float | None] = [None] * b
        # --- chunked prefill state: chunk sizes clip to seq_len and dedupe ---------------
        sizes = {min(int(c), s) for c in (prefill_chunk_sizes or ())}
        if any(c < 1 for c in sizes):
            raise ValueError(f"prefill chunk sizes must be >= 1, got {prefill_chunk_sizes}")
        self.prefill_chunk_sizes = tuple(sorted(sizes))
        if prefill_chunk_budget < 1:
            raise ValueError(f"prefill_chunk_budget must be >= 1, got {prefill_chunk_budget}")
        self.prefill_chunk_budget = int(prefill_chunk_budget)
        self.prefill_invocations = 0  # chunk executions
        self.prefill_tokens = 0       # prompt tokens prefilled
        self._pending_chunks: list[list[tuple[int, int, int]]] = [[] for _ in range(b)]
        self._prefill_fifo: collections.deque[int] = collections.deque()
        self._chunks_done = np.zeros((b,), np.int32)

    # ------------------------------------------------------------------ host -> device

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array as a device tensor without a host sync: on the card a pinned
        staging copy and an asynchronous transfer on the current stream (the caching host
        allocator keeps the staging block until the transfer has run); on the CPU a
        copy, so that later host writes do not reach it."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return host.clone()
        return host.pin_memory().to(self.device, non_blocking=True)

    def _device_table(self) -> torch.Tensor:
        """The page table on the device, sent again only after admission or release
        changed it."""
        if self._table_dev is None:
            self._table_dev = self._to_device(self._table)
        return self._table_dev

    # ------------------------------------------------------------------ step programs

    def _step_program(self, ids: torch.Tensor, t: torch.Tensor,
                      fresh: np.ndarray) -> torch.Tensor:
        """The decode step, contiguous layout: wipe the recycled slots joining at t = 0,
        advance every slot one position, sample."""
        if fresh.any():
            lm_mod.reset_slots(self._cache, self._to_device(fresh))
        _, log_probs = lm_mod.decode_step_slots(self.model, self.params, self._cache,
                                                ids, t)
        return self._sample_token(log_probs)

    def _paged_step_program(self, ids: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The decode step, paged layout: ``models.lm.paged_decode_step_slots`` through
        the page table (the paged-decode kernel on the card), then the same sampling. No
        wipe: recycled pages hold finite rows and every masked score is ``MASK_VALUE``,
        so greedy decode equals the contiguous step's."""
        _, log_probs = lm_mod.paged_decode_step_slots(
            self.model, self.params, self._cache, self._device_table(), ids, t)
        return self._sample_token(log_probs)

    def _sample_token(self, log_probs: torch.Tensor) -> torch.Tensor:
        """The emission tail shared by both layouts: mask BOS (input-only), then greedy,
        or per-slot temperature/top-k/top-p sampling in steps where an active slot
        samples. Prompt forcing happens on the host after the fetch."""
        log_probs[:, self.model.vocab_size - 1] = MASK_VALUE
        greedy = torch.argmax(log_probs, dim=-1)
        if not (self._active & (self._temp > 0.0)).any():
            return greedy
        policy = self._to_device(np.stack([self._temp, self._top_p,
                                           self._top_k.astype(np.float32)]))
        temp, top_p, top_k = policy[0], policy[1], policy[2].long()
        safe_temp = torch.where(temp > 0.0, temp, 1.0)
        scaled = filter_logits_per_slot(log_probs / safe_temp[:, None], top_k, top_p)
        return torch.where(temp > 0.0, sample_categorical(scaled, self._gen), greedy)

    # ------------------------------------------------------------------ paging

    def _page_reserve(self, slot: int, total: int) -> None:
        """Reservation at admission: an all-or-nothing allocation of every page ``total``
        positions can touch (raises ``PagePoolExhausted``; on failure the slot owns
        nothing)."""
        pages = self._pagepool.alloc(pages_for(int(total), self._pagepool.page_size))
        self._slot_pages[slot] = pages
        row = self._table[slot]
        row[:] = self._pagepool.null_page()
        row[:len(pages)] = pages
        self._table_dev = None

    def _release_pages(self, slot: int) -> None:
        """Drop the slot's reservation (finish/expire); its table row returns to the null
        page, so the decode step's writes for the now inactive slot land there."""
        if self._slot_pages[slot]:
            self._pagepool.unref(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._table[slot, :] = self._pagepool.null_page()
        self._table_dev = None

    # ------------------------------------------------------------------ slots

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._requests)

    def free_slots(self) -> list[int]:
        return [i for i in range(self.num_slots) if self._requests[i] is None]

    def validate(self, request: Request) -> int:
        """Admission-control check. Returns the request's total stream length."""
        request.sampling.validate(self.model.vocab_size)
        p = len(request.prompt)
        if p >= self.model.seq_len:
            raise ValueError(f"prompt length {p} fills the model's seq_len "
                             f"{self.model.seq_len} — nothing left to generate")
        if request.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {request.max_new_tokens}")
        return min(p + request.max_new_tokens, self.model.seq_len)

    def plan_prefill(self, start: int, end: int) -> list[tuple[int, int, int]]:
        """``(start, length, chunk_size)`` triples covering prompt positions
        ``[start, end)`` (``greedy_chunk_plan`` over ``prefill_chunk_sizes``)."""
        return greedy_chunk_plan(self.prefill_chunk_sizes, start, end)

    def admit(self, slot: int, request: Request, *, now: float | None = None) -> None:
        """Bind ``request`` to a free slot (single-request ``admit_many``)."""
        self.admit_many([(slot, request)], now=now)

    def admit_many(self, admissions: list[tuple[int, Request]], *,
                   now: float | None = None) -> None:
        """Bind a batch of requests to free slots: host writes plus ONE transfer of the
        admitted prompt rows into the device prompt buffer. Each prompt is then
        chunk-prefilled (interleaved with decode by ``step``) or, with prefill disabled,
        teacher-forced through the decode loop. In the paged layout each request's page
        span is reserved first; what does not fit is refused with ``KVPagesExhausted``
        after the rest is bound."""
        if not admissions:
            return
        now = time.monotonic() if now is None else now
        seen: set[int] = set()
        entries: list[tuple[int, Request, np.ndarray]] = []
        for slot, request in admissions:
            if self._requests[slot] is not None or slot in seen:
                raise ValueError(f"slot {slot} is occupied")
            seen.add(slot)
            self.validate(request)
            entries.append((slot, request, np.asarray(request.prompt, np.int32).reshape(-1)))
        b, s = self.num_slots, self.model.seq_len
        if len(admissions) > b:
            raise ValueError(f"{len(admissions)} admissions > {b} slots")
        refused: list[Request] = []
        refusal: PagePoolExhausted | None = None
        if self._pagepool is not None:
            kept = []
            for entry in entries:
                slot, request, _ = entry
                try:
                    self._page_reserve(slot, min(len(request.prompt)
                                                 + request.max_new_tokens, s))
                    kept.append(entry)
                except PagePoolExhausted as exc:
                    refused.append(request)
                    refusal = refusal or exc
            entries = kept
        if entries:
            rows = np.zeros((len(entries), s), np.int32)
            for j, (_, _, stream) in enumerate(entries):
                rows[j, :len(stream)] = stream
            slots = np.asarray([slot for slot, _, _ in entries], np.int64)
            self._prompt[self._to_device(slots)] = self._to_device(rows)
        for slot, request, stream in entries:
            total = min(len(request.prompt) + request.max_new_tokens, s)
            self._admit_one(slot, request, total, now, stream)
        if refused:
            raise KVPagesExhausted([(slot, request) for slot, request, _ in entries],
                                   refused, refusal)

    def _admit_one(self, slot: int, request: Request, total: int, now: float,
                   stream: np.ndarray) -> None:
        self._requests[slot] = request
        self._prompt_len[slot] = len(request.prompt)
        self._total_len[slot] = total
        self._temp[slot] = request.sampling.temperature
        self._top_k[slot] = request.sampling.top_k
        self._top_p[slot] = request.sampling.top_p
        fill = len(stream)
        self._stream[slot] = stream
        self._fill_len[slot] = fill
        self._chunks_done[slot] = 0
        if request.arrival_s is None:
            request.arrival_s = now
        self._admit_s[slot] = now
        self._first_tok_s[slot] = None
        if not self.prefill_chunk_sizes or fill == 0:
            # Prefill-as-decode (or nothing to prefill): the slot joins the decode step
            # at t = 0; a contiguous slot is wiped there.
            self._active[slot] = True
            self._ids[slot] = self.model.vocab_size - 1          # BOS restart
            self._t[slot] = 0
            self._out[slot] = []
        else:
            # Chunked prefill over [0, fill): the slot stays out of the decode batch until
            # its plan drains. Its t parks at seq_len - 1, so the decode step's
            # unconditional per-slot write lands on a row that is rewritten before it can
            # become visible (contiguous), or on the null page (paged).
            self._pending_chunks[slot] = self.plan_prefill(0, fill)
            self._prefill_fifo.append(slot)
            self._active[slot] = False
            self._t[slot] = self.model.seq_len - 1
            self._out[slot] = []

    def _activate_prefilled(self, slot: int) -> None:
        """Promote a slot whose cache holds its whole prompt into the decode batch: the
        emitted stream so far is the prompt, and the next step samples position
        ``fill``."""
        fill = int(self._fill_len[slot])
        stream = self._stream[slot]
        self._ids[slot] = int(stream[fill - 1])
        self._t[slot] = fill
        self._out[slot] = [int(x) for x in stream]
        self._active[slot] = True

    def reset_stats(self) -> None:
        """Zero the perf counters (benchmark hygiene: warm up, then measure from a clean
        ledger). Only valid while no request is in flight."""
        if self.num_active:
            raise RuntimeError("reset_stats with requests in flight")
        self.steps = 0
        self.slot_steps = 0
        self.generated_tokens = 0
        self.prefill_invocations = 0
        self.prefill_tokens = 0
        if self._pagepool is not None:
            self._pagepool.reset_counters()

    def page_stats(self) -> dict | None:
        """The allocator ledger plus internal fragmentation (reserved-but-unwritten share
        of slot-held pages), in the JAX engine's keys; None in the contiguous layout.
        ``cow_copies`` (boundary pages copied for prefix-cache hits) is 0: the prefix
        cache is not ported."""
        if self._pagepool is None:
            return None
        s = self._pagepool.stats()
        held = live = 0
        for i in range(self.num_slots):
            pages = self._slot_pages[i]
            if not pages:
                continue
            held += len(pages)
            if self._pending_chunks[i]:
                live += int(self._pending_chunks[i][0][0])   # rows settled
            elif self._active[i]:
                live += int(self._t[i])
            elif self._requests[i] is not None:
                live += int(self._fill_len[i])
        s["slot_pages_held"] = held
        s["slot_tokens_live"] = live
        s["fragmentation"] = (round(1.0 - live / (held * self._pagepool.page_size), 4)
                              if held else 0.0)
        s["cow_copies"] = 0
        return s

    def _finish(self, slot: int, finish: str, now: float) -> Completion:
        req = self._requests[slot]
        if self._pending_chunks[slot]:
            # Mid-prefill expiry: the emitted stream is the prompt prefix covered so far.
            tokens = np.asarray(self._stream[slot][:self._pending_chunks[slot][0][0]],
                                np.int32)
            self._pending_chunks[slot] = []
            self._prefill_fifo.remove(slot)
        else:
            tokens = np.asarray(self._out[slot], np.int32)
        plen = int(self._prompt_len[slot])
        new = max(len(tokens) - plen, 0)
        arrival = req.arrival_s if req.arrival_s is not None else self._admit_s[slot]
        first = self._first_tok_s[slot]
        comp = Completion(
            request=req, tokens=tokens, finish=finish, prompt_len=plen, new_tokens=new,
            queue_wait_s=self._admit_s[slot] - arrival,
            ttft_s=None if first is None else first - arrival,
            tpot_s=(now - first) / (new - 1) if first is not None and new > 1 else None,
            e2e_s=now - arrival)
        self._requests[slot] = None
        self._active[slot] = False
        self._out[slot] = []
        self._first_tok_s[slot] = None
        self._stream[slot] = None
        if self._pagepool is not None:
            self._release_pages(slot)
        return comp

    # ------------------------------------------------------------------ stepping

    @property
    def num_prefilling(self) -> int:
        """Slots whose prompt prefill plan has not drained yet."""
        return len(self._prefill_fifo)

    def _next_prefill_slot(self) -> int:
        """Highest request priority first, FIFO within a priority."""
        return max(((i, slot) for i, slot in enumerate(self._prefill_fifo)),
                   key=lambda it: (self._requests[it[1]].priority, -it[0]))[1]

    def _run_prefill(self) -> None:
        """Run up to ``prefill_chunk_budget`` chunks, finishing slots mid-budget: prefill
        and decode interleave at chunk granularity."""
        budget = self.prefill_chunk_budget
        while budget > 0 and self._prefill_fifo:
            slot = self._next_prefill_slot()
            start, length, size = self._pending_chunks[slot].pop(0)
            if self._pagepool is not None:
                lm_mod.paged_prefill_chunk(self.model, self.params, self._cache,
                                           self._device_table(), self._prompt, slot, start,
                                           length, chunk=size)
            else:
                lm_mod.prefill_chunk(self.model, self.params, self._cache, self._prompt,
                                     slot, start, length, self._chunks_done[slot] == 0,
                                     chunk=size)
            self.prefill_invocations += 1
            self.prefill_tokens += length
            self._chunks_done[slot] += 1
            budget -= 1
            if not self._pending_chunks[slot]:
                self._prefill_fifo.remove(slot)
                self._activate_prefilled(slot)

    def step(self) -> list[Completion]:
        """Advance the engine: up to ``prefill_chunk_budget`` prefill chunks, then one
        decode step over every decode-ready slot; returns the requests that finished.
        One host sync: the ``[num_slots]`` token fetch."""
        if self.num_active == 0:
            return []
        self._run_prefill()
        if not self._active.any():            # everything in flight is prefilling
            return []
        ids_t = self._to_device(np.stack([self._ids, self._t]))
        ids, t = ids_t[0], ids_t[1]
        if self._pagepool is not None:
            tok = self._paged_step_program(ids, t)
        else:
            tok = self._step_program(ids, t, self._active & (self._t == 0))
        tok = tok.cpu().numpy()               # THE per-step host sync
        now = time.monotonic()
        self.steps += 1
        self.slot_steps += self.num_active
        done: list[Completion] = []
        for i in range(self.num_slots):
            if not self._active[i]:
                continue
            t_i = int(self._t[i])
            if t_i < self._prompt_len[i]:     # a prompt position: the prompt's token
                token = int(self._stream[i][t_i])
            else:
                token = int(tok[i])
                self.generated_tokens += 1
                if self._first_tok_s[i] is None:
                    self._first_tok_s[i] = now
            self._out[i].append(token)
            self._t[i] = t_i + 1
            self._ids[i] = token
            if self._t[i] >= self._total_len[i]:
                done.append(self._finish(i, "ok", now))
        return done

    def expire(self, now: float | None = None) -> list[Completion]:
        """Force-finish in-flight requests whose deadline passed (``finish="timeout"``,
        partial tokens)."""
        now = time.monotonic() if now is None else now
        return [self._finish(i, "timeout", now)
                for i, req in enumerate(self._requests)
                if req is not None and req.deadline_s is not None and now > req.deadline_s]

    @property
    def slot_occupancy(self) -> float | None:
        """Mean fraction of slots active per executed step (batching efficiency)."""
        return self.slot_steps / (self.steps * self.num_slots) if self.steps else None

    def run(self, requests: list[Request], *,
            max_steps: int | None = None) -> list[Completion]:
        """Serve ``requests`` FIFO to completion: the minimal drive loop."""
        pending = list(requests)
        out: list[Completion] = []
        budget = max_steps
        while pending or self.num_active:
            batch = []
            for slot in self.free_slots():
                if not pending:
                    break
                batch.append((slot, pending.pop(0)))
            try:
                self.admit_many(batch)
            except KVPagesExhausted as exc:
                # Typed backpressure, not an error: requeue the refused requests in order
                # and let the in-flight work drain pages. With nothing in flight, stepping
                # cannot free anything: the pool cannot fit one request.
                pending[:0] = exc.refused
                if not exc.admitted and self.num_active == 0:
                    raise
            out.extend(self.step())
            if budget is not None:
                budget -= 1
                if budget <= 0 and (pending or self.num_active):
                    raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return out


__all__ = ["Completion", "ContinuousBatchingEngine", "KVPagesExhausted", "Request",
           "SamplingParams", "filter_logits_per_slot", "greedy_chunk_plan",
           "sample_categorical"]
