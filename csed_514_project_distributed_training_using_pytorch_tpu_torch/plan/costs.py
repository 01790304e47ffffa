"""Analytical per-step cost model: one parallel layout -> predicted time + memory.

Counterpart of the JAX package's ``plan/costs.py``, its arithmetic copied exactly. Given a
model's static stats, a topology, and one candidate DP×FSDP×TP×PP factorization, it
prices

- **memory**: param / optimizer / gradient / activation bytes per device under the
  candidate's sharding (the feasibility gate ``plan/search.py`` prunes by);
- **compute**: train FLOPs per optimizer step over the devices' aggregate peak, inflated
  by the GPipe bubble ``(M+S-1)/M`` when a stage axis is present;
- **collectives**: per-axis bytes over per-link bandwidths: the once-per-step DP
  gradient ring all-reduce, Megatron TP's per-layer activation all-reduces, PP's
  stage-boundary sends, each routed inside a host or across hosts by whether the axis
  spans granules (``Topology.num_slices``).

A deliberately simple machine model (no compute/comm overlap, ring collectives at
``2(n-1)/n`` efficiency, uniform per-link bandwidth): it ranks candidates, it does not
forecast wall clocks; ``plan_report`` renders predicted against measured, and ``--plan
tune`` re-ranks by measurement.

The per-kind tables are the H100's nominal published figures (the JAX package's are a
TPU's): NVLink 4 inside a host, one 400 Gb/s NDR port a GPU across hosts, HBM3 and the
bf16 dense peak from ``utils/benchmarks.py``. Unknown kinds and the CPU keep the JAX
package's defaults, so stubbed and CPU topologies price alike in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# Nominal per-link, one-direction interconnect bandwidths (bytes/s) by device-name
# substring, published figures, not measurements (first match wins): NVLink 4 moves
# 900 GB/s both ways, 450 GB/s one way.
ICI_BYTES_BY_KIND = [("h100", 4.5e11)]
# Across hosts: one 400 Gb/s NDR InfiniBand port a GPU, 50 GB/s.
DCN_BYTES_BY_KIND = [("h100", 5.0e10)]
DEFAULT_ICI_BYTES = 1.0e10    # unknown kind / CPU test platform: deterministic
DEFAULT_DCN_BYTES = 3.125e9   # ~25 Gbit/s per device across hosts

# Per-pass host/dispatch overhead (seconds) charged to every extra microbatch
# (grad-accum pass or pipeline tick). Small by design: its role is to break
# ties AGAINST gratuitous microbatching when memory doesn't demand it, not to
# model real dispatch cost.
MICROBATCH_OVERHEAD_S = 50e-6


def ici_bytes_per_s(device_kind: str) -> float:
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.benchmarks import (
        lookup_by_kind,
    )

    return lookup_by_kind(ICI_BYTES_BY_KIND, device_kind, DEFAULT_ICI_BYTES)


def dcn_bytes_per_s(device_kind: str) -> float:
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.benchmarks import (
        lookup_by_kind,
    )

    return lookup_by_kind(DCN_BYTES_BY_KIND, device_kind, DEFAULT_DCN_BYTES)


@dataclass(frozen=True)
class Topology:
    """The hardware facts one candidate is priced against. Built from the live process
    group and device by ``detect()`` or stubbed outright in tests and synthetic
    scenarios: every field is plain data."""

    num_devices: int
    device_kind: str = "cpu"
    hbm_bytes: float = 16 << 30        # usable device memory per device
    hbm_source: str = "nominal"        # env | runtime | spec | nominal
    peak_flops: float = 1e12           # per device (the bf16 dense peak)
    ici_bytes: float = DEFAULT_ICI_BYTES   # per-link one-way bytes/s inside a host
    dcn_bytes: float = DEFAULT_DCN_BYTES   # per-device bytes/s across hosts
    num_slices: int = 1                # granules: the hosts the world spans

    @classmethod
    def detect(cls, device="cuda") -> "Topology":
        """Snapshot the live world and ``device`` (``parallel.mesh.topology_summary``,
        a collective at more than one rank) plus the per-kind bandwidth and peak
        tables. Raises on ``"cuda"`` without a card."""
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
            topology_summary,
        )
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.benchmarks import (
            peak_flops,
        )

        t = topology_summary(device)
        return cls(
            num_devices=t["device_count"],
            device_kind=t["device_kind"],
            hbm_bytes=float(t["hbm_bytes"]),
            hbm_source=t["hbm_source"],
            peak_flops=peak_flops(t["device_kind"]) or 1e12,
            ici_bytes=ici_bytes_per_s(t["device_kind"]),
            dcn_bytes=dcn_bytes_per_s(t["device_kind"]),
            num_slices=t["num_granules"],
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class ModelStats:
    """Static per-model quantities the cost model consumes.

    ``flops_per_example`` is TRAIN FLOPs (fwd + backward ≈ 3× fwd).
    ``act_bytes_per_layer_per_example`` is the resident activation footprint of
    one layer for one example (the remat knob halves what must persist — callers
    bake that in); ``score_bytes_per_example`` the dense-attention ``[H, S, S]``
    score tile (0 when a flash/streaming core is used). ``shardable_fraction``
    is the fraction of parameter bytes Megatron TP actually splits (block
    kernels; embeddings/LN/head replicate)."""

    name: str
    param_bytes: float
    flops_per_example: float
    num_layers: int = 1
    num_heads: int = 1
    seq_len: int = 1
    embed_dim: int = 1
    dtype_bytes: int = 4
    act_bytes_per_layer_per_example: float = 0.0
    score_bytes_per_example: float = 0.0
    optimizer_mult: float = 1.0        # extra state as a multiple of params
                                       # (SGD velocity 1, AdamW 2; +1 with EMA)
    shardable_fraction: float = 1.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class Candidate:
    """One point of the DP×FSDP×TP×PP search space: mesh axis sizes plus the
    microbatch split. ``data·model·stage`` must equal the device count the
    search ran at; ``microbatches`` is the GPipe split (stage>1 only) and
    ``grad_accum`` the gradient-accumulation split (activation-memory knob)."""

    data: int = 1
    model: int = 1
    stage: int = 1
    fsdp: bool = False
    grad_accum: int = 1
    microbatches: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.stage

    def mesh_spec(self) -> str:
        """The trainer-facing ``--mesh`` string. The data axis always appears
        (every trainer accepts ``data=1``, and the LM trainer requires the axis
        to exist); model/stage axes of size 1 are elided."""
        parts = [("data", self.data)] + [
            (n, s) for n, s in (("model", self.model), ("stage", self.stage))
            if s > 1]
        return ",".join(f"{n}={s}" for n, s in parts)

    def axes(self) -> dict:
        return {"data": self.data, "model": self.model, "stage": self.stage}

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class CostBreakdown:
    """The priced candidate: per-phase seconds, per-chip bytes, feasibility."""

    compute_s: float
    bubble_s: float
    dp_comm_s: float
    tp_comm_s: float
    pp_comm_s: float
    overhead_s: float
    step_s: float                  # the ranking key: sum of the above
    param_bytes_per_chip: float
    opt_bytes_per_chip: float
    grad_bytes_per_chip: float
    act_bytes_per_chip: float
    total_bytes_per_chip: float
    hbm_budget_bytes: float
    fits: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# Per-device HBM streaming bandwidth (bytes/s), the serving cost model's denominator
# (batched decode is memory-bound: every step re-reads the params and the resident KV
# planes): the published figures of ``utils.benchmarks.PEAK_HBM_BYTES_BY_KIND``.
DEFAULT_HBM_BYTES = 5.0e10    # unknown kind / CPU test platform: deterministic


def hbm_bytes_per_s(device_kind: str) -> float:
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.benchmarks import (
        PEAK_HBM_BYTES_BY_KIND,
        lookup_by_kind,
    )

    return lookup_by_kind(PEAK_HBM_BYTES_BY_KIND, device_kind, DEFAULT_HBM_BYTES)


def _ring_time(nbytes: float, participants: int, link_bytes_per_s: float) -> float:
    """Ring all-reduce wall time for ``nbytes`` of payload per participant:
    ``2(n-1)/n`` traversals of the payload over one link's bandwidth (the
    standard bandwidth-optimal schedule; latency terms ignored)."""
    if participants <= 1 or nbytes <= 0:
        return 0.0
    return 2.0 * (participants - 1) / participants * nbytes / link_bytes_per_s


def _split_axis_over_dcn(axis_size: int, num_slices: int) -> tuple[int, int]:
    """Decompose an axis that spans granules into (dcn_factor, ici_factor) —
    the hybrid-mesh layout (``make_hybrid_mesh``): the LEADING factor strides
    slices, the remainder stays inside one. Axes that don't divide the granule
    count keep everything on the slower network (conservative)."""
    if num_slices <= 1:
        return 1, axis_size
    if axis_size % num_slices == 0:
        return num_slices, axis_size // num_slices
    return axis_size, 1


def predict(stats: ModelStats, topo: Topology, cand: Candidate, *,
            global_batch: int, hbm_fraction: float = 0.9) -> CostBreakdown:
    """Price one candidate layout: per-step seconds by phase + per-chip bytes.

    Machine-model assumptions (DESIGN.md §13): no compute/comm overlap (phases
    sum), ring collectives at ``2(n-1)/n``, the data axis is the one that spans
    DCN granules when granules exist (the hybrid-mesh recipe — model/stage
    crossing DCN is priced at DCN bandwidth as a deliberate penalty), gradients
    materialize one full shard alongside params, and TP shards activations and
    the dense score tile evenly."""
    d, m, s = cand.data, cand.model, cand.stage
    n = cand.num_devices

    # ---- memory (bytes per chip) -------------------------------------------
    # TP only splits the shardable fraction; PP/FSDP split everything they see.
    tp_sharded = (stats.param_bytes * stats.shardable_fraction / m
                  + stats.param_bytes * (1.0 - stats.shardable_fraction))
    param_pc = tp_sharded / (s * (d if cand.fsdp else 1))
    opt_pc = param_pc * stats.optimizer_mult
    grad_pc = param_pc                       # one transient grad shard
    micro = global_batch / (cand.grad_accum * cand.microbatches)
    # GPipe keeps EVERY microbatch's forward activations resident until its
    # backward — all M are in flight through the fill — so a stage split does
    # not shrink activation memory with M (only grad_accum does); modeling one
    # microbatch would let the bubble term steer the pick toward high-M
    # layouts the feasibility gate then under-counts 16×.
    inflight = cand.microbatches if s > 1 else 1
    micro_pc = micro * inflight / d          # examples resident per chip
    layers_pc = max(stats.num_layers / s, 1.0)
    act_pc = (micro_pc * layers_pc * stats.act_bytes_per_layer_per_example / m
              + micro_pc * stats.score_bytes_per_example / m)
    total_pc = param_pc + opt_pc + grad_pc + act_pc
    # The budget keeps ``1 - hbm_fraction`` headroom for what the model doesn't
    # count (compiler scratch, the replicated dataset, fragmentation).
    budget = topo.hbm_bytes * hbm_fraction

    # ---- compute ------------------------------------------------------------
    flops_step = stats.flops_per_example * global_batch
    compute_s = flops_step / (n * topo.peak_flops)
    bubble_s = 0.0
    if s > 1:
        # GPipe fill/drain: the stage pipeline runs M+S-1 ticks for M microbatch
        # ticks of useful work — charged per accumulation pass.
        bubble_s = compute_s * (s - 1) / cand.microbatches

    # ---- collectives --------------------------------------------------------
    # DP gradient all-reduce: once per step, one grad shard's bytes, split
    # hierarchically when the data axis spans DCN granules.
    grad_bytes = tp_sharded / s
    dcn_d, ici_d = _split_axis_over_dcn(d, topo.num_slices)
    dp_comm_s = (_ring_time(grad_bytes, ici_d, topo.ici_bytes)
                 + _ring_time(grad_bytes / max(ici_d, 1), dcn_d, topo.dcn_bytes))
    if cand.fsdp:
        # ZeRO adds a params all-gather per accumulation pass on top of the
        # grad reduce-scatter+all-gather (≙ the all-reduce above): same ring
        # volume again, times the extra passes.
        dp_comm_s *= 1.0 + 0.5 * cand.grad_accum

    # TP: Megatron inserts ~4 activation all-reduces per layer per pass
    # (fwd row-parallel + its backward, ×2 for attention + MLP); total volume
    # over the step covers the full batch regardless of the accum split. Any
    # model/stage axis is assumed inside one granule (ICI); if granules exist
    # and data can't absorb them, these axes pay DCN bandwidth.
    intra_bw = (topo.ici_bytes if topo.num_slices <= 1
                or _split_axis_over_dcn(d, topo.num_slices)[0] == topo.num_slices
                else topo.dcn_bytes)
    act_bytes_step = (global_batch / d) * stats.seq_len * stats.embed_dim \
        * stats.dtype_bytes
    tp_comm_s = (4 * stats.num_layers * _ring_time(act_bytes_step, m, intra_bw)
                 if m > 1 else 0.0)

    # PP: each microbatch's activations cross S-1 stage boundaries forward and
    # backward — point-to-point, one payload traversal each.
    pp_comm_s = (2 * (s - 1) * act_bytes_step / intra_bw if s > 1 else 0.0)

    overhead_s = MICROBATCH_OVERHEAD_S * (
        cand.grad_accum * cand.microbatches - 1)

    step_s = compute_s + bubble_s + dp_comm_s + tp_comm_s + pp_comm_s + overhead_s
    return CostBreakdown(
        compute_s=compute_s, bubble_s=bubble_s, dp_comm_s=dp_comm_s,
        tp_comm_s=tp_comm_s, pp_comm_s=pp_comm_s, overhead_s=overhead_s,
        step_s=step_s,
        param_bytes_per_chip=param_pc, opt_bytes_per_chip=opt_pc,
        grad_bytes_per_chip=grad_pc, act_bytes_per_chip=act_pc,
        total_bytes_per_chip=total_pc, hbm_budget_bytes=budget,
        fits=total_pc <= budget)


# =========================================================================================
# Serving: price a TP×(slot-DP) replica mesh (serving/shard.py) — the decode
# regime is the inverse of training: no optimizer/grad state, memory-BOUND
# steps (every decode step re-reads params + resident KV), and the objective
# is tokens/s and admissible slots under the HBM budget and a TTFT SLO.
# =========================================================================================


@dataclass(frozen=True)
class ServeStats:
    """Static per-model serving quantities (counted exactly from the model's parameter
    shapes and ``models.lm.init_cache``'s planes on the meta device, by
    ``plan.scenarios.for_serve``: no hand formulas to drift).

    ``kv_bytes_per_slot`` is ONE slot's full cache planes across all layers
    (narrow K/V plus any scale planes — the int8 layout prices itself);
    ``prompt_bytes_per_slot`` the engine's per-slot host-prompt row.
    ``flops_per_token`` is the decode forward for one token (2·params plus the
    attention einsums); ``shardable_fraction`` the parameter bytes
    ``tensor_parallel.param_partition_specs`` actually splits over heads."""

    name: str
    param_bytes: float
    kv_bytes_per_slot: float
    prompt_bytes_per_slot: float = 0.0
    flops_per_token: float = 0.0
    num_layers: int = 1
    num_heads: int = 1
    num_kv_heads: int = 1
    seq_len: int = 1
    embed_dim: int = 1
    dtype_bytes: int = 4
    shardable_fraction: float = 1.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class ServeCostBreakdown:
    """One priced serve mesh: per-chip residency, the decode-step roofline,
    the prefill-derived TTFT estimate, and both feasibility gates."""

    decode_step_s: float           # one token for every slot of the replica
    decode_mem_s: float            # HBM-stream term (usually the binding one)
    decode_compute_s: float        # FLOPs term
    tp_comm_s: float               # per-step TP activation collectives
    ttft_s: float                  # prefill of one prompt_len prompt
    tokens_per_s: float            # num_slots / decode_step_s — the objective
    params_bytes_per_chip: float
    kv_bytes_per_chip: float
    total_bytes_per_chip: float
    hbm_budget_bytes: float
    slots_at_budget: int           # max admissible slots under the budget
    fits: bool                     # per-chip residency within the budget
    meets_ttft: bool               # TTFT estimate within the SLO (True if none)

    @property
    def feasible(self) -> bool:
        return self.fits and self.meets_ttft

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["feasible"] = self.feasible
        return d


def predict_serve(stats: ServeStats, topo: Topology, *, tp: int, dp: int,
                  num_slots: int, prompt_len: int,
                  ttft_slo_s: float | None = None,
                  hbm_fraction: float = 0.9,
                  kv_layout: str = "contiguous", page_size: int = 64,
                  context_tokens: int | None = None) -> ServeCostBreakdown:
    """Price one TP×(slot-DP) serve mesh.

    Residency follows ``serving/shard.py``'s byte-true accounting exactly:
    params replicate their unshardable fraction and split the shardable one
    over ``tp``; a dp group holds ``num_slots/dp`` slots whose KV planes split
    over ``tp`` (heads axis); the host-prompt rows shard over slots only. The
    decode step is a roofline — ``max(HBM stream, FLOPs)`` of one token for
    every resident slot — plus Megatron-style per-layer TP all-reduces of the
    step's activations. TTFT is the compute-bound prefill of one
    ``prompt_len`` prompt on one dp group (slot-DP doesn't speed up a single
    request — exactly why the disaggregated prefill tier exists).

    ``kv_layout="paged"`` prices page-pool residency instead of whole-context
    planes: a slot serving ``context_tokens`` (default: the full ``seq_len`` —
    the conservative pin) holds ``pages_for(context, page_size)`` pages, so
    both the per-slot HBM charge and the decode step's KV stream shrink to the
    page span actually reserved (the fused kernel's dead-page fetch elision
    makes the stream term real, not aspirational). The page-count formula is
    ``serving.pagepool.pages_for`` — the engine's own reservation math — and
    the contiguous default leaves every number bitwise unchanged."""
    if kv_layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r} "
                         f"(want 'contiguous' or 'paged')")
    kv_bytes_slot = stats.kv_bytes_per_slot
    if kv_layout == "paged":
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.pagepool import (
            pages_for,
        )

        ctx = min(int(context_tokens or stats.seq_len), stats.seq_len)
        ps = max(1, min(int(page_size), stats.seq_len))
        kv_bytes_slot = (stats.kv_bytes_per_slot / max(stats.seq_len, 1)
                         * pages_for(ctx, ps) * ps)
    group_slots = max(num_slots // max(dp, 1), 1)
    params_pc = (stats.param_bytes * stats.shardable_fraction / tp
                 + stats.param_bytes * (1.0 - stats.shardable_fraction))
    kv_slot_pc = kv_bytes_slot / tp
    kv_pc = kv_slot_pc * group_slots
    prompt_pc = stats.prompt_bytes_per_slot * group_slots
    total_pc = params_pc + kv_pc + prompt_pc
    budget = topo.hbm_bytes * hbm_fraction
    slot_cost = max(kv_slot_pc + stats.prompt_bytes_per_slot, 1.0)
    slots_at_budget = max(dp, 1) * int(max(budget - params_pc, 0.0) // slot_cost)

    hbm_bw = hbm_bytes_per_s(topo.device_kind)
    # One decode step streams the param shard once (batched over the group's
    # slots) and each slot's resident KV once.
    decode_mem_s = (params_pc + kv_pc) / hbm_bw
    decode_compute_s = stats.flops_per_token * group_slots / (tp * topo.peak_flops)
    # Two all-reduces per layer per step (attention out-proj + MLP row-parallel)
    # over the step's [group_slots, embed] activations.
    step_act_bytes = group_slots * stats.embed_dim * stats.dtype_bytes
    tp_comm_s = (2 * stats.num_layers * _ring_time(step_act_bytes, tp,
                                                   topo.ici_bytes)
                 if tp > 1 else 0.0)
    decode_step_s = max(decode_mem_s, decode_compute_s) + tp_comm_s
    tokens_per_s = (num_slots / decode_step_s) if decode_step_s > 0 else 0.0

    # TTFT: prefill is compute-bound (the whole prompt's forward in chunks),
    # parallel over tp only, plus the same per-layer collectives over the
    # prompt's activations.
    prefill_act_bytes = prompt_len * stats.embed_dim * stats.dtype_bytes
    ttft_s = (stats.flops_per_token * prompt_len / (tp * topo.peak_flops)
              + (2 * stats.num_layers * _ring_time(prefill_act_bytes, tp,
                                                   topo.ici_bytes)
                 if tp > 1 else 0.0))
    return ServeCostBreakdown(
        decode_step_s=decode_step_s, decode_mem_s=decode_mem_s,
        decode_compute_s=decode_compute_s, tp_comm_s=tp_comm_s,
        ttft_s=ttft_s, tokens_per_s=tokens_per_s,
        params_bytes_per_chip=params_pc, kv_bytes_per_chip=kv_pc,
        total_bytes_per_chip=total_pc, hbm_budget_bytes=budget,
        slots_at_budget=slots_at_budget,
        fits=total_pc <= budget,
        meets_ttft=(ttft_slo_s is None or ttft_s <= ttft_slo_s))
