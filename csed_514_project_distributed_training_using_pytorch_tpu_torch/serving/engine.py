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

Quantized execution (``ops/quant.py``): ``kv_dtype`` picks the KV plane format
(``"int8"``/``"fp8"``: quantize-on-write planes with per-head f32 scales, which the paged
step hands to the paged-decode kernel as they are) and ``quant_policy`` the weight
matmuls (``"w8"``/``"w8a8"``: ``quant.quantize_params`` at construction).
``byte_accounting`` reports what the live buffers cost.

The prefix cache (``prefix_cache_entries``/``prefix_cache_bytes``,
``serving/prefix_cache.py``): a finished prefill, a parked stream or a mid-prefill park's
covered prefix is stored under its tokens; a later admission sharing a token prefix
installs the stored rows and prefills only the rest. Contiguous entries are snapshots of
the slot's planes (one copy each way); paged entries hold refcounts on the slot's pages,
and a hit that ends mid-page copies that one boundary page (copy-on-write).

Park and resume: ``park`` evicts a preemptible slot (its emitted stream and its rows go to
the prefix cache) and returns a ``scheduler.Parked`` record (or, mid-prefill, the plain
request) to requeue; ``admit_many`` takes it back and re-admits the stream, prompt plus
the tokens so far, through chunked prefill (or a cache hit), so a greedy resume continues
token for token. The threaded front end that drives this is ``serving.server.Server``.

Speculative decoding (``spec``/``spec_k``/``drafter``, ``serving/spec/``) replaces the
decode tick with propose -> verify -> accept: a drafter guesses up to ``spec_k`` tokens per
slot, one verify pass (``models.lm.verify_chunk``, or ``paged_verify_chunk`` on the
table's gathered view, as the JAX package does) scores them, and ``accept_fold`` emits the
longest correct prefix plus a correction, 1..spec_k+1 tokens per pass over the cache, with
one host fetch (tokens and counts) per tick. Greedy acceptance is token-identical to
sequential decode; temperature > 0 is exact rejection sampling (drafters are
deterministic, so the residual is ``p`` with the draft masked), with draws from the
engine's ``torch.Generator``. Spec mode never runs the decode step: ``decode_calls`` and
``verify_calls`` (per width) count the two programs, so on the paged layout the
paged-decode kernel is not launched under speculation. Rollback is position bookkeeping
only.

The serve mesh (``mesh=serving.shard.build_serve_mesh(tp, dp)``, a world of ``tp * dp``
ranks each running this engine): every rank keeps the same host state and runs the same
programs on what it holds (``serving/shard.py``): its shards of the parameters (the
``model`` axis: its own query and KV heads, two row-parallel all-reduces a layer), and the
planes of its own heads for its own slot group (contiguous) or its group's page range
(paged: ``PagePool(groups=dp)``, the table's global page ids turned into indices of the
rank's pool before the paged-decode kernel sees them, so on the card B6 runs on each
rank's own heads and pages). The step's fetch gathers the slot groups' log-probs over the
``data`` axis, and every rank then runs the emission tail on the whole batch, drawing
what the unsharded engine draws. A contiguous prefix-cache entry holds each rank's own
head planes of the slot (broadcast over the ``data`` axis from the slot's group, so any
group can install it); a paged entry stays in its group's pages, and a hit from another
group is a miss, as in the JAX package. ``byte_accounting`` gathers every rank's row into
``per_chip``.

Two host-side hooks, both None (and free) by default: ``on_step(steps)``, called at the top
of every step (the replica process points it at ``resilience.faults.on_tick``, so kill,
preempt and stall faults fire after N decode steps, with requests in flight), and
``tracer`` (a ``utils.trace.Tracer``, set by the ``Server``): requests that carry a
``trace_id`` get ``queue_wait`` (arrival to admission), ``resume`` (a parked request's wait),
``prefill`` (one a chunk, host time of its dispatch), ``decode`` (decode-ready to done,
with the first-token split), spec mode's ``draft``/``verify`` (one each a verify tick) and
``preempt_park`` spans, as in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm as lm_mod
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import quant
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    MASK_VALUE,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    collectives,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    shard as shard_mod,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.pagepool import (
    PagePool,
    PagePoolExhausted,
    pages_for,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.prefix_cache import (
    PrefixCache,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.scheduler import (
    Parked,
    Request,
    SamplingParams,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.spec.drafter import (
    Drafter,
    NGramDrafter,
    greedy_chunk_plan,
)


@dataclasses.dataclass
class Completion:
    """A finished request: the emitted token stream (prompt prefix + generated suffix)
    and its latency accounting. ``finish`` is ``"ok"`` (the stream reached its length),
    ``"timeout"`` (deadline hit — for a mid-decode timeout ``tokens`` holds the partial
    stream) or, from the server, ``"shed"``."""

    request: Request
    tokens: np.ndarray
    finish: str
    prompt_len: int
    new_tokens: int
    queue_wait_s: float | None = None
    ttft_s: float | None = None       # arrival -> first GENERATED token
    tpot_s: float | None = None       # mean inter-token time after the first
    e2e_s: float | None = None        # arrival -> completion
    preemptions: int = 0              # times this request was parked mid-decode

    @property
    def ok(self) -> bool:
        return self.finish == "ok"


class KVPagesExhausted(RuntimeError):
    """Typed admission backpressure from the paged KV store: the page pool could not
    cover every requested reservation. Raised by ``admit_many`` AFTER binding what fit.

    ``admitted`` holds the ``(slot, request)`` pairs this call did bind; ``refused`` the
    items (``Request``/``Parked``, FIFO order) left unbound with their slots free —
    requeue them and retry once decode frees pages. ``needed``/``free`` carry the first
    refusal's shortfall."""

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


def accept_fold(log_probs: torch.Tensor, draft: torch.Tensor, draft_len: torch.Tensor,
                temp: torch.Tensor | None, top_k: torch.Tensor | None,
                top_p: torch.Tensor | None, generator: torch.Generator
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The verify pass's accept rule, the JAX engine's ``_accept_fold``: ``log_probs [B,
    k+1, V]`` (BOS already masked), ``draft [B, k]``, ``draft_len [B]`` -> ``(tokens [B,
    k+1], counts [B])``, ``counts[b]`` = accepted drafts + 1 (the correction or bonus row);
    rows past it are junk the host never reads. A draft at ``j >= draft_len[b]`` is never
    accepted, so a slot without proposals takes one plain decode row.

    - greedy (``temp[b] <= 0``, or ``temp`` None for an all-greedy batch): accept the
      longest prefix on which the draft equals the argmax; every emitted row is the
      argmax, so the stream is sequential decode's;
    - ``temp[b] > 0``: exact rejection sampling against ``p`` = ``filter_logits_per_slot``
      of the temperature-scaled row. Accept draft ``d`` with probability ``p(d)``; the
      stopping row emits a draw from ``p`` with ``d`` masked after a rejection, or a plain
      draw from ``p`` where it had no draft. The emitted token at each position is then
      distributed exactly as ``p``. Uniforms and Gumbel noise come from ``generator``."""
    b, w, v = log_probs.shape
    k = w - 1
    dev = log_probs.device
    greedy_tok = torch.argmax(log_probs, dim=-1)                     # [B, W]
    valid = torch.arange(k, device=dev)[None] < draft_len[:, None]
    draft = draft.long()
    acc = (greedy_tok[:, :k] == draft) & valid
    if temp is None:
        accepted = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        return greedy_tok, accepted + 1
    sampling = temp > 0.0
    safe_temp = torch.where(sampling, temp, 1.0)
    filt = filter_logits_per_slot((log_probs / safe_temp[:, None, None]).reshape(b * w, v),
                                  top_k.repeat_interleave(w), top_p.repeat_interleave(w)
                                  ).reshape(b, w, v)
    probs = torch.softmax(filt, dim=-1)
    p_draft = torch.gather(probs[:, :k], -1, draft[..., None])[..., 0]   # [B, k]
    u = torch.rand((b, k), generator=generator, device=dev)
    acc = torch.where(sampling[:, None], (u < p_draft) & valid, acc)
    accepted = torch.cumprod(acc.long(), dim=1).sum(dim=1)
    masked = torch.where(torch.nn.functional.one_hot(draft, v).bool(), MASK_VALUE,
                         filt[:, :k])
    resampled = lm_mod.sample_categorical(masked, generator)          # [B, k]
    plain = lm_mod.sample_categorical(filt, generator)                # [B, W]
    rows = torch.arange(w, device=dev)[None]
    pad = torch.zeros((b, 1), dtype=torch.long, device=dev)
    stop_tok = torch.where(rows < draft_len[:, None], torch.cat([resampled, pad], dim=1),
                           plain)
    sampled_tok = torch.where(rows < accepted[:, None], torch.cat([draft, pad], dim=1),
                              stop_tok)
    return torch.where(sampling[:, None], sampled_tok, greedy_tok), accepted + 1


class ContinuousBatchingEngine:
    """Slot-based continuous batching over ``models.lm``'s KV-cache decoder.

    ``params`` is the model's flat parameter dict (``TransformerLM.init``, or
    ``models.transformer.params_from_jax`` of a JAX tree); it is moved to ``device`` and
    quantized there for ``quant_policy``. Single-threaded: callers drive ``step``/``run``
    from one thread (``serving.server.Server`` serializes all engine access on its loop
    thread)."""

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
                 spec_k: int = 4,
                 drafter: Drafter | None = None,
                 mesh: shard_mod.ServeMesh | None = None,
                 device: torch.device | str = "cuda"):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        # The serve mesh: None is the one-device engine. With a mesh this rank holds its
        # parameter shards, and the planes of its own heads for its own slot group.
        self.mesh = mesh
        if mesh is not None:
            shard_mod.validate_engine_mesh(model, int(num_slots), mesh)
        self._tp = mesh.model if mesh is not None else lm_mod.NO_TP
        self._dp = mesh.dp if mesh is not None else 1
        self._group = mesh.data.index if mesh is not None else 0
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise ValueError("device 'cuda' needs a CUDA device, and "
                                 "torch.cuda.is_available() is false: pass device='cpu'")
            if self.device.index is None:   # pinned, so another thread can make it current
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model
        # kv_dtype picks the KV plane format, quant_policy the weight matmuls; both off
        # is the unquantized path (quantize_params returns the dict itself).
        self.quant = quant.QuantPolicy(kv_dtype=kv_dtype, weights=quant_policy)
        self.params = quant.quantize_params(
            {name: p.to(self.device) for name, p in params.items()}, self.quant)
        self._params_bytes = quant.tree_bytes(self.params)     # the logical total
        if mesh is not None:
            # quantized whole, then split: the scales are the unsharded engine's
            self.params = shard_mod.param_shardings(self.params, mesh)
        self.num_slots = b = int(num_slots)
        self._local_slots = bl = b // self._dp       # this rank's slot group
        self._slot0 = self._group * bl
        self._crc = 0                 # host_digest: the finished requests' ids and tokens
        self._finished = 0
        s = model.seq_len
        self.steps = 0                # decode (or verify) steps executed
        self.decode_calls = 0         # decode-step invocations (never under spec)
        self.slot_steps = 0           # sum of occupied slots over steps (occupancy)
        self.generated_tokens = 0     # emitted non-forced tokens
        self.preemptions = 0          # slots parked (priority pressure)
        self.resumes = 0              # parked requests re-admitted
        self.on_step = None           # host hook: on_step(steps) at the top of each step
        self.tracer = None            # utils.trace.Tracer (the Server sets it)
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
            # layout token for token (each dp group's full-context reservations plus its
            # null page). A rank's pool is its group's page range.
            ps = max(1, min(int(page_size), s))
            p_max = lm_mod.pages_per_slot(s, ps)
            if num_pages is None:
                num_pages = self._dp * (max(bl, 1) * p_max + 1)
            self.page_size = ps
            self._pagepool = PagePool(int(num_pages), page_size=ps, groups=self._dp)
            self._pages_per_group = int(num_pages) // self._dp
            self._cache = lm_mod.init_page_pool(model, self._pages_per_group, page_size=ps,
                                                kv_dtype=self.quant.kv_dtype,
                                                device=self.device, tp=self._tp)
            # Paged entries are page ids, not planes: their own layout signature keeps
            # them from installing into a contiguous engine (and the reverse).
            self.plane_layout = f"paged:{ps}:" + quant.cache_layout(self._cache)
            self._table = np.empty((b, p_max), np.int32)
            for i in range(b):
                self._table[i, :] = self._pagepool.null_page(self._slot_group(i))
            self._slot_pages: list[list[int]] = [[] for _ in range(b)]
            self.cow_copies = 0       # boundary pages copied for prefix-cache hits
        else:
            self.page_size = None
            self._cache = lm_mod.init_cache(model, bl, kv_dtype=self.quant.kv_dtype,
                                            device=self.device, tp=self._tp)
            self.plane_layout = quant.cache_layout(self._cache)
        self._ids = np.full((b,), model.vocab_size - 1, np.int32)   # BOS
        self._t = np.zeros((b,), np.int32)
        self._active = np.zeros((b,), bool)
        # The prompt buffer stays on the device (prefill reads it there), the rank's slot
        # group's rows of it; admission writes the admitted rows in one transfer.
        self._prompt = torch.zeros((bl, s), dtype=torch.int32, device=self.device)
        self._prompt_len = np.zeros((b,), np.int32)
        # Positions that arrive by prefill: the prompt's, or on a resume the parked
        # stream's (prompt plus the tokens generated before the park).
        self._fill_len = np.zeros((b,), np.int32)
        self._stream: list[np.ndarray | None] = [None] * b
        self._parks = np.zeros((b,), np.int32)   # this occupant's park count
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
        if (prefix_cache_entries or prefix_cache_bytes) and not self.prefill_chunk_sizes:
            raise ValueError("the prefix cache rides the chunked-prefill path — "
                             "enable prefill_chunk_sizes to use it")
        self._prefix_cache_entries = int(prefix_cache_entries)
        self._prefix_cache_bytes = (None if prefix_cache_bytes is None
                                    else int(prefix_cache_bytes))
        self.prefix_cache = self._build_prefix_cache()
        self.prefill_invocations = 0  # chunk executions
        self.prefill_tokens = 0       # prompt tokens prefilled (cache hits excluded)
        self._pending_chunks: list[list[tuple[int, int, int]]] = [[] for _ in range(b)]
        self._prefill_fifo: collections.deque[int] = collections.deque()
        self._hit_len = np.zeros((b,), np.int32)
        self._chunks_done = np.zeros((b,), np.int32)
        self._prefill_t0 = np.zeros((b,), np.float64)
        self._ready_s = np.zeros((b,), np.float64)    # decode-ready stamps (the spans')
        self._prefill_records: list[dict] = []
        # --- speculative decoding (serving/spec/): ``spec`` names the mode, ``drafter``
        # injects the implementation (required for "draft-lm"). The two must agree: a
        # drafter with spec="off", or with another mode's name, is refused, so an A/B that
        # toggles ``spec`` with a drafter held fixed never runs speculation on both sides.
        if drafter is not None:
            if spec == "off":
                raise ValueError(
                    "a drafter was injected but spec='off' — pass spec=drafter.name to "
                    "enable it (speculation is never enabled implicitly)")
            if spec != drafter.name:
                raise ValueError(f"spec={spec!r} does not match the injected drafter's "
                                 f"mode {drafter.name!r}")
        elif spec == "draft-lm":
            raise ValueError("spec='draft-lm' needs a constructed DraftLMDrafter passed "
                             "as drafter=")
        elif spec == "ngram":
            drafter = NGramDrafter()
        elif spec != "off":
            raise ValueError(f"unknown spec mode {spec!r} (choices: off, ngram, draft-lm "
                             f"— or inject a custom drafter with spec=drafter.name)")
        self.drafter = drafter
        self.spec = "off" if drafter is None else drafter.name
        self.spec_k = int(spec_k)
        self.verify_calls: dict[int, int] = {}   # verify invocations per width k
        self.spec_steps = 0           # verify invocations
        self.spec_slot_steps = 0      # per-slot verify participations
        self.spec_proposed = 0        # draft tokens offered to verify
        self.spec_accepted = 0        # draft tokens that survived verify
        self._spec_records: list[dict] = []
        if self.drafter is not None:
            if not 1 <= self.spec_k < s:
                raise ValueError(f"spec_k {self.spec_k} outside [1, {s})")
            if not self.prefill_chunk_sizes:
                # prefill-as-decode forces prompt tokens in the decode step; the verify
                # pass has no forcing path (prompts enter through chunked prefill)
                raise ValueError("speculative decoding rides the chunked-prefill path — "
                                 "enable prefill_chunk_sizes to use it")
            self.drafter.bind(num_slots=b, vocab_size=model.vocab_size, seq_len=s,
                              device=self.device)

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
        """The page table of this rank's slot group on the device, its global page ids
        turned into indices of the rank's pool (the group's page range), sent again only
        after admission or release changed it."""
        if self._table_dev is None:
            rows = self._table[self._slot0:self._slot0 + self._local_slots]
            self._table_dev = self._to_device(rows - self._group * self._pages_per_group)
        return self._table_dev

    # ------------------------------------------------------------------ the serve mesh

    def _slot_group(self, slot: int) -> int:
        """The dp group that holds ``slot``'s planes (and allocates its pages)."""
        return slot // max(self.num_slots // self._dp, 1)

    def _own(self, slot: int) -> bool:
        """True when ``slot`` lies in this rank's slot group."""
        return self._slot_group(slot) == self._group

    def _mine(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of a ``[num_slots, ...]`` tensor that this rank's slot group holds."""
        return x[self._slot0:self._slot0 + self._local_slots]

    def _gather_slots(self, rows: torch.Tensor) -> torch.Tensor:
        """Every slot group's rows of a step's output, in slot order, on every rank: the
        all-gather of the step's fetch over the ``data`` axis (a no-op unsharded)."""
        if self._dp == 1:
            return rows
        return collectives.all_gather(rows, group=self.mesh.data.group).flatten(0, 1)

    # ------------------------------------------------------------------ step programs

    def _step_program(self, ids: torch.Tensor, t: torch.Tensor,
                      fresh: np.ndarray) -> torch.Tensor:
        """The decode step, contiguous layout: wipe the recycled slots joining at t = 0,
        advance every slot one position, sample."""
        self.decode_calls += 1
        fresh = fresh[self._slot0:self._slot0 + self._local_slots]
        if fresh.any():
            lm_mod.reset_slots(self._cache, self._to_device(fresh))
        _, log_probs = lm_mod.decode_step_slots(self.model, self.params, self._cache,
                                                self._mine(ids), self._mine(t), tp=self._tp)
        return self._sample_token(self._gather_slots(log_probs))

    def _paged_step_program(self, ids: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The decode step, paged layout: ``models.lm.paged_decode_step_slots`` through
        the page table (the paged-decode kernel on the card, which reads a quantized pool
        with its scale pools), then the same sampling. No wipe: recycled pages hold finite
        rows and every masked score is ``MASK_VALUE``, so greedy decode equals the
        contiguous step's."""
        self.decode_calls += 1
        _, log_probs = lm_mod.paged_decode_step_slots(
            self.model, self.params, self._cache, self._device_table(), self._mine(ids),
            self._mine(t), tp=self._tp)
        return self._sample_token(self._gather_slots(log_probs))

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
        return torch.where(temp > 0.0, lm_mod.sample_categorical(scaled, self._gen), greedy)

    def _verify_program(self, k: int, ids: torch.Tensor, t: torch.Tensor,
                        draft: torch.Tensor, draft_len: torch.Tensor,
                        fresh: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """The speculative step, contiguous layout: wipe the recycled slots joining at
        t = 0, score ``[ids, d_1..d_k]`` with ``models.lm.verify_chunk``, accept."""
        self.verify_calls[k] = self.verify_calls.get(k, 0) + 1
        fresh = fresh[self._slot0:self._slot0 + self._local_slots]
        if fresh.any():
            lm_mod.reset_slots(self._cache, self._to_device(fresh))
        _, log_probs = lm_mod.verify_chunk(self.model, self.params, self._cache,
                                           self._mine(ids), self._mine(t), self._mine(draft),
                                           k=k, tp=self._tp)
        return self._accept(self._gather_slots(log_probs), draft, draft_len)

    def _paged_verify_program(self, k: int, ids: torch.Tensor, t: torch.Tensor,
                              draft: torch.Tensor, draft_len: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The speculative step, paged layout: ``models.lm.paged_verify_chunk`` on the
        table's gathered view, then the same accept rule. No wipe (the paged decode
        step's argument)."""
        self.verify_calls[k] = self.verify_calls.get(k, 0) + 1
        _, log_probs = lm_mod.paged_verify_chunk(
            self.model, self.params, self._cache, self._device_table(), self._mine(ids),
            self._mine(t), self._mine(draft), k=k, tp=self._tp)
        return self._accept(self._gather_slots(log_probs), draft, draft_len)

    def _accept(self, log_probs: torch.Tensor, draft: torch.Tensor,
                draft_len: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``accept_fold`` with BOS masked (input-only, as in the decode step) and the
        per-slot sampling parameters sent only in ticks where an active slot samples."""
        log_probs[:, :, self.model.vocab_size - 1] = MASK_VALUE
        if not (self._active & (self._temp > 0.0)).any():
            return accept_fold(log_probs, draft, draft_len, None, None, None, self._gen)
        policy = self._to_device(np.stack([self._temp, self._top_p,
                                           self._top_k.astype(np.float32)]))
        return accept_fold(log_probs, draft, draft_len, policy[0], policy[2].long(),
                           policy[1], self._gen)

    def _snapshot(self, slot: int) -> dict:
        """A contiguous slot's planes (every leaf, scales included) as a prefix-cache
        entry: one copy. Under the serve mesh the entry holds this rank's heads of the
        slot, broadcast over the ``data`` axis from the slot's group, so a slot of any
        group can install it."""
        group = self._slot_group(slot)
        local = slot - group * self._local_slots
        out = {}
        for name, layer in self._cache.items():
            out[name] = {}
            for key, x in layer.items():
                plane = x[local].clone() if group == self._group else torch.empty_like(x[0])
                if self._dp > 1:
                    collectives.broadcast_(plane, src=group, group=self.mesh.data.group)
                out[name][key] = plane
        return out

    def _install(self, planes: dict, slot: int) -> None:
        """A contiguous prefix-cache hit: copy a stored entry's planes into ``slot`` (rows
        past the hit length are the donor's, hidden by the position mask until prefill or
        decode overwrites them). Only the slot's group holds its planes."""
        if not self._own(slot):
            return
        for name, layer in self._cache.items():
            for key, x in layer.items():
                x[slot - self._slot0].copy_(planes[name][key])

    def _cow(self, dst: int, src: int) -> None:
        """Copy-on-write: duplicate one page (every leaf's rows and scales) into a
        freshly allocated page, so a hit whose boundary lands mid-page keeps the shared
        entry's page intact while this slot writes past the boundary. Only the ranks of
        the pages' group hold them."""
        if self._pagepool.group_of(dst) != self._group:
            return
        off = self._group * self._pages_per_group
        for layer in self._cache.values():
            for x in layer.values():
                x[dst - off] = x[src - off]

    # ------------------------------------------------------------------ paging

    def _page_bytes(self) -> int:
        """Bytes of one page across every leaf (codes and scales) and every head: the
        rank's pool holds its heads' share of its group's pages."""
        return quant.tree_bytes(self._cache) * self._tp.size // self._pages_per_group

    def _build_prefix_cache(self) -> PrefixCache | None:
        if not self._prefix_cache_entries and not self._prefix_cache_bytes:
            return None
        # A bytes-only budget leaves the entry count unbounded: the measured bytes are
        # then the only eviction pressure.
        entries = self._prefix_cache_entries or (1 << 30)
        return PrefixCache(entries, layout=self.plane_layout,
                           capacity_bytes=self._prefix_cache_bytes,
                           on_evict=(self._on_prefix_evict if self._pagepool is not None
                                     else None))

    def _on_prefix_evict(self, planes: dict) -> None:
        """Eviction hook (paged): the entry's refcounts on its pages return to the pool."""
        self._pagepool.unref(int(p) for p in planes["pages"])

    def _page_reserve(self, slot: int, stream: np.ndarray, total: int) -> int:
        """Reservation at admission: a prefix lookup, then an all-or-nothing allocation
        of every page ``total`` positions can touch (raises ``PagePoolExhausted``; on
        failure the slot owns nothing). A hit's full pages are shared by refcount; a
        boundary page (hit length mid-page) is copied. Returns the hit length."""
        pool = self._pagepool
        ps = pool.page_size
        group = self._slot_group(slot)
        hit_len, entry_pages = 0, None
        if self.prefix_cache is not None and len(stream):
            hit_len, payload = self.prefix_cache.lookup(
                stream, min_len=min(self.prefill_chunk_sizes), layout=self.plane_layout)
            if hit_len:
                entry_pages = [int(p) for p in payload["pages"]]
                if pool.group_of(entry_pages[0]) != group:
                    # another dp group's pages: a miss (they are not in this slot's pool)
                    hit_len, entry_pages = 0, None
        shared = hit_len // ps
        new_pages = pool.alloc(pages_for(int(total), ps) - shared, group=group)  # may raise
        shared_pages = entry_pages[:shared] if shared else []
        if shared_pages:
            pool.ref(shared_pages)
        pages = shared_pages + new_pages
        if hit_len % ps:
            # Boundary copy-on-write: the entry's page `shared` holds rows
            # [0, hit_len % ps) this slot needs, in a page of its own.
            self._cow(pages[shared], entry_pages[shared])
            self.cow_copies += 1
        self._slot_pages[slot] = pages
        row = self._table[slot]
        row[:] = pool.null_page(group)
        row[:len(pages)] = pages
        self._table_dev = None
        return hit_len

    def _release_pages(self, slot: int) -> None:
        """Drop the slot's reservation (finish/park/expire); pages shared with prefix-cache
        entries stay alive under the entries' refcounts. The table row returns to the
        null page, so the decode step's writes for the now inactive slot land there."""
        if self._slot_pages[slot]:
            self._pagepool.unref(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._table[slot, :] = self._pagepool.null_page(self._slot_group(slot))
        self._table_dev = None

    def _prefix_insert_pages(self, slot: int, tokens: np.ndarray) -> None:
        """A paged prefix-cache insert: the entry takes a refcount on the pages covering
        ``tokens``, no copy. The slot may keep writing the last covered page at positions
        ``>= len(tokens)``, outside every row the entry claims."""
        n = pages_for(len(tokens), self._pagepool.page_size)
        pages = self._slot_pages[slot][:n]
        if not pages:
            return
        self._pagepool.ref(pages)
        self.prefix_cache.insert(np.asarray(tokens, np.int32),
                                 {"pages": np.asarray(pages, np.int32)},
                                 layout=self.plane_layout,
                                 nbytes=len(pages) * self._page_bytes())

    def _prefix_insert(self, slot: int, tokens: np.ndarray) -> None:
        """Store the slot's rows ``[0, len(tokens))`` under their tokens: page refcounts
        (paged) or a snapshot of the planes (contiguous)."""
        if self._pagepool is not None:
            self._prefix_insert_pages(slot, tokens)
            return
        planes = self._snapshot(slot)
        # the logical entry's bytes (every head's planes), whatever share this rank holds:
        # the byte budget's evictions are the unsharded engine's
        self.prefix_cache.insert(np.asarray(tokens, np.int32), planes,
                                 layout=self.plane_layout,
                                 nbytes=quant.tree_bytes(planes) * self._tp.size)

    # ------------------------------------------------------------------ slots

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._requests)

    def free_slots(self) -> list[int]:
        return [i for i in range(self.num_slots) if self._requests[i] is None]

    def validate(self, request: Request) -> int:
        """Admission-control check (the server's submit path calls it too, so callers
        fail before queueing). Returns the request's total stream length."""
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

    def admit_many(self, admissions: list[tuple[int, Request | Parked]], *,
                   now: float | None = None) -> None:
        """Bind a batch of requests to free slots: host writes plus ONE transfer of the
        admitted prompt rows into the device prompt buffer. Each prompt is then
        chunk-prefilled (interleaved with decode by ``step``), served from the prefix
        cache, or, with prefill disabled, teacher-forced through the decode loop. In the
        paged layout each request's page span is reserved first; what does not fit is
        refused with ``KVPagesExhausted`` after the rest is bound.

        An admission may be a ``Parked`` record (a request evicted by ``park``): its row
        is the emitted stream, prompt plus the tokens generated so far, re-admitted
        through the prefix cache or chunked prefill like a prompt of those tokens."""
        if not admissions:
            return
        now = time.monotonic() if now is None else now
        seen: set[int] = set()
        entries: list[tuple[int, Request, Parked | None, np.ndarray]] = []
        for slot, item in admissions:
            if self._requests[slot] is not None or slot in seen:
                raise ValueError(f"slot {slot} is occupied")
            seen.add(slot)
            parked = item if isinstance(item, Parked) else None
            request = parked.request if parked is not None else item
            if parked is not None:
                if not self.prefill_chunk_sizes:
                    raise ValueError("preemption resume rides the chunked-prefill path — "
                                     "enable prefill_chunk_sizes to use it")
                stream = np.asarray(parked.tokens, np.int32).reshape(-1)
                if not len(request.prompt) <= len(stream) < self.model.seq_len:
                    raise ValueError(f"parked stream length {len(stream)} outside "
                                     f"[prompt_len, seq_len)")
            else:
                self.validate(request)
                stream = np.asarray(request.prompt, np.int32).reshape(-1)
            entries.append((slot, request, parked, stream))
        b, s = self.num_slots, self.model.seq_len
        if len(admissions) > b:
            raise ValueError(f"{len(admissions)} admissions > {b} slots")
        page_hits: dict[int, int] = {}
        refused: list = []
        refusal: PagePoolExhausted | None = None
        if self._pagepool is not None:
            kept = []
            for entry in entries:
                slot, request, parked, stream = entry
                total = min(len(request.prompt) + request.max_new_tokens, s)
                try:
                    page_hits[slot] = self._page_reserve(slot, stream, total)
                    kept.append(entry)
                except PagePoolExhausted as exc:
                    refused.append(parked if parked is not None else request)
                    refusal = refusal or exc
            entries = kept
        mine = [(slot, stream) for slot, _, _, stream in entries if self._own(slot)]
        if mine:
            rows = np.zeros((len(mine), s), np.int32)
            for j, (_, stream) in enumerate(mine):
                rows[j, :len(stream)] = stream
            slots = np.asarray([slot - self._slot0 for slot, _ in mine], np.int64)
            self._prompt[self._to_device(slots)] = self._to_device(rows)
        for slot, request, parked, stream in entries:
            total = min(len(request.prompt) + request.max_new_tokens, s)
            self._admit_one(slot, request, total, now, stream, parked=parked,
                            page_hit=page_hits.get(slot))
        if refused:
            raise KVPagesExhausted([(slot, request) for slot, request, _, _ in entries],
                                   refused, refusal)

    def _admit_one(self, slot: int, request: Request, total: int, now: float,
                   stream: np.ndarray, *, parked: Parked | None = None,
                   page_hit: int | None = None) -> None:
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
        # a request that arrived after the caller read its clock is admitted on arrival
        # (a server's loop stamps a pass once; a submit may land inside the pass)
        now = max(now, request.arrival_s)
        if parked is None:
            self._admit_s[slot] = now
            self._first_tok_s[slot] = None
            self._parks[slot] = 0
            if self.tracer is not None:
                self.tracer.span("queue_wait", request.trace_id, request.arrival_s, now,
                                 request_id=request.request_id, slot=slot)
        else:
            # A resume keeps the first admission's stamps: queue wait and TTFT were paid
            # once; e2e keeps growing through the parked gap.
            self.resumes += 1
            self._admit_s[slot] = parked.admit_s
            self._first_tok_s[slot] = parked.first_tok_s
            self._parks[slot] = parked.parks
            if self.tracer is not None:
                self.tracer.span("resume", request.trace_id, parked.parked_s, now,
                                 request_id=request.request_id, slot=slot,
                                 parks=parked.parks, resumed_at=fill)
        self._ready_s[slot] = now
        hit_len = 0
        if page_hit is not None:
            hit_len = page_hit           # paged: looked up and shared at reservation
        elif self.prefix_cache is not None and fill:
            hit_len, planes = self.prefix_cache.lookup(
                stream, min_len=min(self.prefill_chunk_sizes), layout=self.plane_layout)
            if hit_len:
                self._install(planes, slot)
        self._hit_len[slot] = hit_len
        if not self.prefill_chunk_sizes or fill == 0:
            # Prefill-as-decode (or nothing to prefill): the slot joins the decode step
            # at t = 0; a contiguous slot is wiped there.
            self._active[slot] = True
            self._ids[slot] = self.model.vocab_size - 1          # BOS restart
            self._t[slot] = 0
            self._out[slot] = []
            if self.drafter is not None:         # spec mode implies fill == 0 here
                self.drafter.on_activate(slot, [])
        elif hit_len == fill:
            # A full prefix hit: the installed rows are the prefill.
            self._prefill_t0[slot] = now
            self._activate_prefilled(slot)
        else:
            # Chunked prefill over [hit_len, fill): the slot stays out of the decode batch
            # until its plan drains. Its t parks at seq_len - 1, so the decode step's
            # unconditional per-slot write lands on a row that is rewritten before it can
            # become visible (contiguous), or on the null page (paged).
            self._pending_chunks[slot] = self.plan_prefill(hit_len, fill)
            self._prefill_fifo.append(slot)
            self._prefill_t0[slot] = now
            self._active[slot] = False
            self._t[slot] = self.model.seq_len - 1
            self._out[slot] = []

    def _activate_prefilled(self, slot: int) -> None:
        """Promote a slot whose cache holds its whole stream into the decode batch: the
        emitted stream so far is the prompt (prompt plus generated tokens after a
        resume), and the next step samples position ``fill``."""
        fill = int(self._fill_len[slot])
        stream = self._stream[slot]
        self._ids[slot] = int(stream[fill - 1])
        self._t[slot] = fill
        self._out[slot] = [int(x) for x in stream]
        self._active[slot] = True
        self._ready_s[slot] = time.monotonic()
        if self.drafter is not None:
            # the drafter follows the slot's stream from here (the draft LM installs the
            # prompt into its own cache through the chunk plan)
            self.drafter.on_activate(slot, self._out[slot])
        # the "prefill" telemetry record: admission to decode-ready on the host clock; no
        # chunk wall (no device fence is put around a chunk, so none is measured)
        req = self._requests[slot]
        self._prefill_records.append({
            "request_id": req.request_id, "prompt_len": int(self._prompt_len[slot]),
            "chunks": int(self._chunks_done[slot]),
            "tokens": fill - int(self._hit_len[slot]),
            "cache_hit_len": int(self._hit_len[slot]), "wall_s": None,
            "latency_s": time.monotonic() - float(self._prefill_t0[slot])})

    def take_prefill_records(self) -> list[dict]:
        """Drain the completed-prefill records (one dict per prompt: chunks, tokens,
        cache_hit_len, latency_s; ``wall_s`` None) gathered since the last call: the
        server's ``"prefill"`` telemetry events."""
        records, self._prefill_records = self._prefill_records, []
        return records

    def reset_stats(self) -> None:
        """Zero the perf counters and the prefix cache's contents (benchmark hygiene: warm
        up, then measure from a clean ledger). Only valid while no request is in
        flight."""
        if self.num_active:
            raise RuntimeError("reset_stats with requests in flight")
        self.steps = 0
        self.slot_steps = 0
        self.generated_tokens = 0
        self.preemptions = 0
        self.resumes = 0
        self.prefill_invocations = 0
        self.prefill_tokens = 0
        self.decode_calls = 0
        self.verify_calls = {}
        self.spec_steps = 0
        self.spec_slot_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._spec_records = []
        self._prefill_records = []
        if self.prefix_cache is not None:
            # clear() fires the eviction hook per entry: paged refcounts return first.
            self.prefix_cache.clear()
            self.prefix_cache = self._build_prefix_cache()
        if self._pagepool is not None:
            self._pagepool.reset_counters()
            self.cow_copies = 0

    # The reference budget of ``slots_at_budget``: the A/B ratio it feeds is
    # budget-independent past the parameters.
    HBM_BUDGET_BYTES = 1 << 30

    def byte_accounting(self, *, hbm_budget_bytes: int | None = None) -> dict:
        """Byte-true accounting of the decode working set from the live tensors, in the
        JAX engine's keys: ``decode_bytes_per_step`` (the whole KV store, the parameters
        and the prompt buffer: every step reads all ``[B, S]`` rows), over ``num_slots``
        as ``decode_bytes_per_token``; ``kv_bytes_per_slot``; ``slots_at_budget`` under a
        reference budget. ``per_chip`` has one row (key 0) on one device, equal to the
        logical totals; under the serve mesh one row a rank, keyed by global rank
        (``serving.shard.per_device_bytes``: a collective, every rank calls it), the
        logical totals then counting each array once."""
        budget = (self.HBM_BUDGET_BYTES if hbm_budget_bytes is None
                  else int(hbm_budget_bytes))
        held = {name: shard_mod.per_device_bytes(tree, sm=self.mesh)
                for name, tree in (("params_bytes", self.params), ("kv_bytes", self._cache),
                                   ("prompt_bytes", self._prompt))}
        per_chip = {r: {name: rows[r] for name, rows in held.items()}
                    for r in held["params_bytes"]}
        for chip in per_chip.values():
            chip["total_bytes"] = sum(chip.values())
        params_bytes = self._params_bytes
        kv_bytes = sum(r["kv_bytes"] for r in per_chip.values())   # planes split whole
        prompt_bytes = self.num_slots * self.model.seq_len * self._prompt.element_size()
        if self._pagepool is not None:
            # A paged slot's cost is its reservation; the conservative figure is the
            # full-context span (P_max pages).
            per_slot = self._table.shape[1] * self._page_bytes()
        else:
            per_slot = kv_bytes // self.num_slots
        per_step = kv_bytes + params_bytes + prompt_bytes
        doc = {
            "kv_layout": self.kv_layout,
            "kv_dtype": self.quant.kv_dtype,
            "quant_policy": self.quant.weights,
            "plane_layout": self.plane_layout,
            "params_bytes": params_bytes,
            "kv_bytes_resident": kv_bytes,
            "kv_bytes_per_slot": per_slot,
            "prompt_bytes": prompt_bytes,
            "decode_bytes_per_step": per_step,
            "decode_bytes_per_token": per_step / self.num_slots,
            "hbm_budget_bytes": budget,
            "slots_at_budget": max(
                (budget - params_bytes) // (per_slot + prompt_bytes // self.num_slots), 0),
        }
        if self._pagepool is not None:
            doc["page_size"] = self._pagepool.page_size
            doc["num_pages"] = self._pagepool.num_pages
            doc["page_bytes"] = self._page_bytes()
            doc["page_token_capacity"] = (self._pagepool.usable_pages
                                          * self._pagepool.page_size)
        doc["per_chip"] = per_chip
        doc["bytes_per_chip_max"] = max(r["total_bytes"] for r in per_chip.values())
        doc["params_kv_bytes_per_chip_max"] = max(r["params_bytes"] + r["kv_bytes"]
                                                  for r in per_chip.values())
        doc["mesh"] = self.mesh.describe() if self.mesh is not None else None
        if self.mesh is not None:
            # the budget is per chip: a dp group holds num_slots/dp slots, so one more
            # slot costs each chip of its group kv_slot/tp bytes (the JAX engine's rule)
            group = max(self.num_slots // self._dp, 1)
            params_chip = max(r["params_bytes"] for r in per_chip.values())
            kv_chip = max(r["kv_bytes"] for r in per_chip.values())
            prompt_chip = max(r["prompt_bytes"] for r in per_chip.values())
            slot_cost = max(kv_chip // group + prompt_chip // group, 1)
            doc["slots_at_budget"] = self._dp * max((budget - params_chip) // slot_cost, 0)
        return doc

    def page_stats(self) -> dict | None:
        """The allocator ledger plus internal fragmentation (reserved-but-unwritten share
        of slot-held pages) and the copy-on-write count, in the JAX engine's keys; None
        in the contiguous layout."""
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
        s["cow_copies"] = self.cow_copies
        return s

    def _vacate(self, slot: int) -> None:
        """Free a slot after finish or park: host state back to empty, pages released,
        the drafter told."""
        self._requests[slot] = None
        self._active[slot] = False
        self._out[slot] = []
        self._first_tok_s[slot] = None
        self._hit_len[slot] = 0
        self._stream[slot] = None
        self._parks[slot] = 0
        if self._pagepool is not None:
            self._release_pages(slot)
        if self.drafter is not None:
            self.drafter.on_release(slot)

    def _finish(self, slot: int, finish: str, now: float) -> Completion:
        req = self._requests[slot]
        if self.tracer is not None and not self._pending_chunks[slot]:
            # decode-ready -> done, with the first-token split: its offset into the span
            # (the decode_first/decode_tail segments) and its stamp (the span's TTFT)
            first = self._first_tok_s[slot]
            ready = float(self._ready_s[slot])
            self.tracer.span(
                "decode", req.trace_id, ready, now, request_id=req.request_id, slot=slot,
                finish=finish,
                new_tokens=max(len(self._out[slot]) - int(self._prompt_len[slot]), 0),
                first_token_s=(None if first is None
                               else round(max(0.0, first - ready), 6)),
                first_token_ts=first)
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
            e2e_s=now - arrival, preemptions=int(self._parks[slot]))
        self._crc = shard_mod.crc_of(req.request_id, tokens, self._crc)
        self._finished += 1
        self._vacate(slot)
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
            local = slot - self._slot0       # the chunk runs on the ranks of slot's group
            t0 = time.monotonic()
            if not self._own(slot):
                pass
            elif self._pagepool is not None:
                lm_mod.paged_prefill_chunk(self.model, self.params, self._cache,
                                           self._device_table(), self._prompt, local, start,
                                           length, chunk=size, tp=self._tp)
            else:
                fresh = self._chunks_done[slot] == 0 and self._hit_len[slot] == 0
                lm_mod.prefill_chunk(self.model, self.params, self._cache, self._prompt,
                                     local, start, length, fresh, chunk=size, tp=self._tp)
            if self.tracer is not None:
                req = self._requests[slot]
                self.tracer.span("prefill", req.trace_id, t0, time.monotonic(),
                                 request_id=req.request_id, slot=slot, chunk=size,
                                 start=start, length=length,
                                 cache_hit_len=int(self._hit_len[slot]))
            self.prefill_invocations += 1
            self.prefill_tokens += length
            self._chunks_done[slot] += 1
            budget -= 1
            if not self._pending_chunks[slot]:
                self._prefill_fifo.remove(slot)
                if self.prefix_cache is not None:
                    self._prefix_insert(slot, self._stream[slot])
                self._activate_prefilled(slot)

    def step(self) -> list[Completion]:
        """Advance the engine: up to ``prefill_chunk_budget`` prefill chunks, then one
        decode (or speculative propose -> verify -> accept) step over every decode-ready
        slot; returns the requests that finished. One host sync either way: the
        ``[num_slots]`` token fetch (tokens and counts under spec)."""
        if self.num_active == 0:
            return []
        if self.on_step is not None:
            self.on_step(self.steps)
        self._run_prefill()
        if not self._active.any():            # everything in flight is prefilling
            return []
        if self.drafter is not None:
            return self._spec_tick()
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

    def _spec_tick(self) -> list[Completion]:
        """One propose -> verify -> accept round: host drafts for every decode-ready
        slot, one verify invocation over the whole slot batch, then per-slot variable
        acceptance. Rollback after a partial acceptance is position bookkeeping only
        (``_t`` advances by the emitted count; the next pass's write-before-attend covers
        every stale row); accepted rows are never rewritten."""
        k = self.spec_k
        b = self.num_slots
        vocab = self.model.vocab_size
        entries = [(i, self._out[i], int(self._ids[i])) for i in range(b) if self._active[i]]
        draft = np.zeros((b, k), np.int32)
        dlen = np.zeros((b,), np.int32)
        t0 = time.monotonic()
        for (i, _, _), d in zip(entries, self.drafter.propose_batch(entries, k)):
            d = np.asarray(d, np.int32).reshape(-1)[:k]
            # The window's last row always emits the correction or bonus, so only
            # remaining - 1 drafts can land: never draft past the request's budget.
            room = int(self._total_len[i]) - int(self._t[i]) - 1
            n = max(min(len(d), room), 0)
            if n and not ((d[:n] >= 0) & (d[:n] < vocab)).all():
                raise ValueError(f"drafter {self.drafter.name!r} proposed ids outside "
                                 f"[0, {vocab}) for slot {i}: {d[:n].tolist()}")
            draft[i, :n] = d[:n]
            dlen[i] = n
        if self.mesh is not None and self.mesh.num_devices > 1:
            # rank 0's proposals on every rank (the drafters are deterministic; this
            # keeps a drafter's host state from ever parting the ranks' programs)
            draft, dlen = shard_mod.broadcast_from_leader((draft, dlen))
        t_draft = time.monotonic()
        staged = self._to_device(np.concatenate(
            [self._ids[:, None], self._t[:, None], dlen[:, None], draft], axis=1))
        ids, t, draft_dev, dlen_dev = staged[:, 0], staged[:, 1], staged[:, 3:], staged[:, 2]
        if self._pagepool is not None:
            tok, counts = self._paged_verify_program(k, ids, t, draft_dev, dlen_dev)
        else:
            tok, counts = self._verify_program(k, ids, t, draft_dev, dlen_dev,
                                               self._active & (self._t == 0))
        # THE per-tick host sync: one fetch of the tokens and the counts
        fetched = torch.cat([tok, counts[:, None]], dim=1).cpu().numpy()
        tok, counts = fetched[:, :-1], fetched[:, -1]
        now = time.monotonic()
        self.steps += 1
        self.spec_steps += 1
        self.slot_steps += self.num_active
        done: list[Completion] = []
        proposed = accepted = emitted = 0
        for i in range(b):
            if not self._active[i]:
                continue
            n = min(int(counts[i]), int(self._total_len[i]) - int(self._t[i]))
            self._out[i].extend(int(x) for x in tok[i, :n])
            if self._first_tok_s[i] is None and n:
                self._first_tok_s[i] = now
            proposed += int(dlen[i])
            accepted += max(n - 1, 0)
            emitted += n
            if self.tracer is not None:
                req = self._requests[i]
                self.tracer.span("draft", req.trace_id, t0, t_draft,
                                 request_id=req.request_id, slot=i, k=k,
                                 proposed=int(dlen[i]))
                self.tracer.span("verify", req.trace_id, t_draft, now,
                                 request_id=req.request_id, slot=i,
                                 accepted=max(n - 1, 0), emitted=n)
            self._t[i] += n
            self._ids[i] = int(tok[i, n - 1])
            if self._t[i] >= self._total_len[i]:
                done.append(self._finish(i, "ok", now))
        self.generated_tokens += emitted
        self.spec_slot_steps += len(entries)
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self._spec_records.append({
            "step": self.spec_steps, "active": len(entries), "proposed": proposed,
            "accepted": accepted, "emitted": emitted, "draft_wall_s": t_draft - t0,
            "verify_wall_s": now - t_draft})
        return done

    def spec_stats(self) -> dict | None:
        """The speculative-decoding ledger (None with spec off), in the JAX engine's keys:
        proposal and acceptance totals, the acceptance rate, and
        ``accepted_tokens_per_step``, emitted tokens per slot per verify invocation (plain
        decode is exactly 1.0)."""
        if self.drafter is None:
            return None
        return {
            "mode": self.spec,
            "k": self.spec_k,
            "steps": self.spec_steps,
            "slot_steps": self.spec_slot_steps,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else None),
            "accepted_tokens_per_step": (self.generated_tokens / self.spec_slot_steps
                                         if self.spec_slot_steps else None),
        }

    def take_spec_records(self) -> list[dict]:
        """Drain the per-tick accept records (one dict per verify invocation: active
        slots, proposed/accepted/emitted, draft and verify wall) gathered since the last
        call."""
        records, self._spec_records = self._spec_records, []
        return records

    # ------------------------------------------------------------------ preemption

    def preemptible_slots(self) -> list[tuple[int, int]]:
        """The park candidates, ``(slot, priority)``: occupied slots whose request is
        preemptible, decode-ready with at least one row or mid-prefill. Order: lowest
        priority first; within a tier mid-prefill slots first (no generated tokens yet),
        then the most recently admitted."""
        out = []
        for i, req in enumerate(self._requests):
            if req is None or not req.preemptible:
                continue
            if self._pending_chunks[i] or (self._active[i] and self._t[i] >= 1):
                out.append((i, req.priority))
        return sorted(out, key=lambda ip: (ip[1], bool(self._active[ip[0]]),
                                           -self._admit_s[ip[0]]))

    def park(self, slot: int, *, now: float | None = None) -> Parked | Request:
        """Evict one occupied slot (priority preemption): its rows so far go to the prefix
        cache (when there is one), the slot frees, and the returned record requeues for
        re-admission. A decode-ready slot returns a ``Parked`` (its emitted stream is the
        resume key); a mid-prefill slot returns its plain ``Request``
        (``_park_mid_prefill``).
        A greedy resume continues token for token: the stream is re-admitted like a prompt
        of the same tokens, whose rows are a function of the tokens and the parameters;
        a cache hit only skips the recompute."""
        if not self.prefill_chunk_sizes:
            raise RuntimeError("park/resume rides the chunked-prefill path — "
                               "enable prefill_chunk_sizes to use it")
        req = self._requests[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty")
        now = time.monotonic() if now is None else now
        if self._pending_chunks[slot]:
            return self._park_mid_prefill(slot, req, now)
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not decode-ready")
        t = int(self._t[slot])
        if t < 1:
            raise ValueError(f"slot {slot} has no cache rows to park")
        tokens = np.asarray(self._out[slot], np.int32)
        if len(tokens) != t:
            raise RuntimeError(f"slot {slot}: emitted stream of {len(tokens)} tokens at "
                               f"position {t}")
        if self.prefix_cache is not None:
            self._prefix_insert(slot, tokens)
        parked = Parked(request=req, tokens=tokens, first_tok_s=self._first_tok_s[slot],
                        admit_s=float(self._admit_s[slot]), parked_s=now,
                        parks=int(self._parks[slot]) + 1)
        if self.tracer is not None:
            # the evicted decode stint; the final decode span covers the post-resume one
            self.tracer.span("preempt_park", req.trace_id, float(self._ready_s[slot]), now,
                             request_id=req.request_id, slot=slot, tokens_done=t,
                             parks=parked.parks)
        self.preemptions += 1
        self._vacate(slot)
        return parked

    def _park_mid_prefill(self, slot: int, req: Request, now: float) -> Parked | Request:
        """The mid-prefill eviction: the covered prefix's rows (``[0, start)``, settled:
        chunks run in order) go to the prefix cache under their tokens and the request
        requeues. A fresh occupant requeues as its plain request; a resumed one (parked
        before) keeps its ``Parked`` identity, its full stream and its first stamps."""
        start = self._pending_chunks[slot][0][0]
        if self.prefix_cache is not None and start > 0:
            self._prefix_insert(slot, np.asarray(self._stream[slot][:start], np.int32))
        self._pending_chunks[slot] = []
        self._prefill_fifo.remove(slot)
        parks = int(self._parks[slot])
        if parks > 0:
            back = Parked(request=req, tokens=np.asarray(self._stream[slot], np.int32),
                          first_tok_s=self._first_tok_s[slot],
                          admit_s=float(self._admit_s[slot]), parked_s=now,
                          parks=parks + 1)
        else:
            back = req
        if self.tracer is not None:
            self.tracer.span("preempt_park", req.trace_id, float(self._admit_s[slot]), now,
                             request_id=req.request_id, slot=slot, tokens_done=int(start),
                             parks=parks + 1, mid_prefill=True)
        self.preemptions += 1
        self._vacate(slot)
        return back

    def active_tenant_counts(self) -> dict[str, int]:
        """Occupied slots per tenant (the server's per-tenant slot caps)."""
        counts: dict[str, int] = {}
        for req in self._requests:
            if req is not None:
                counts[req.tenant] = counts.get(req.tenant, 0) + 1
        return counts

    def expired_slots(self, now: float) -> list[int]:
        """The occupied slots whose deadline passed at ``now``."""
        return [i for i, req in enumerate(self._requests)
                if req is not None and req.deadline_s is not None and now > req.deadline_s]

    def expire_slots(self, slots: list[int], now: float) -> list[Completion]:
        """Force-finish ``slots`` (``finish="timeout"``, partial tokens): the decision a
        serve mesh's leader broadcasts."""
        return [self._finish(i, "timeout", now) for i in slots]

    def expire(self, now: float | None = None) -> list[Completion]:
        """Force-finish in-flight requests whose deadline passed (``finish="timeout"``,
        partial tokens)."""
        now = time.monotonic() if now is None else now
        return self.expire_slots(self.expired_slots(now), now)

    def drop_prefix_cache(self) -> None:
        """Empty the prefix cache (its entries are droppable by definition: paged, their
        pages return to the pool): the refusal path's last resort."""
        if self.prefix_cache is not None:
            self.prefix_cache.clear()

    def host_digest(self) -> dict:
        """The host ledger the serve mesh's replica check compares across ranks: the
        program counters and a CRC over every finished request's id and tokens."""
        return {"steps": self.steps, "decode_calls": self.decode_calls,
                "verify_calls": dict(self.verify_calls),
                "prefill_invocations": self.prefill_invocations,
                "generated_tokens": self.generated_tokens, "finished": self._finished,
                "crc": self._crc}

    @property
    def slot_occupancy(self) -> float | None:
        """Mean fraction of slots active per executed step (batching efficiency)."""
        return self.slot_steps / (self.steps * self.num_slots) if self.steps else None

    def run(self, requests: list[Request], *,
            max_steps: int | None = None) -> list[Completion]:
        """Serve ``requests`` FIFO to completion: the minimal drive loop (the threaded
        front end is ``serving.server.Server``)."""
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
                # and let the in-flight work drain pages. With nothing in flight, drop the
                # prefix cache's holdings (droppable by definition) and retry; still stuck
                # means the pool cannot fit one request.
                pending[:0] = exc.refused
                if not exc.admitted and self.num_active == 0:
                    if self.prefix_cache is not None and len(self.prefix_cache):
                        self.drop_prefix_cache()
                        continue
                    raise
            out.extend(self.step())
            if budget is not None:
                budget -= 1
                if budget <= 0 and (pending or self.num_active):
                    raise RuntimeError(f"engine did not drain in {max_steps} steps")
        return out


__all__ = ["Completion", "ContinuousBatchingEngine", "KVPagesExhausted", "Parked",
           "Request", "SamplingParams", "accept_fold", "filter_logits_per_slot",
           "greedy_chunk_plan"]
