"""Layout search: enumerate legal DP×FSDP×TP×PP factorizations, prune, rank.

Counterpart of the JAX package's ``plan/search.py``: the same enumeration, legality
filter and ordering, training and serving. The search space is small by construction
(factor triples of the device count times a few microbatch splits), so the search is
exhaustive enumeration plus a deterministic sort, never a different answer than
brute-force evaluation of ``plan.costs.predict`` over the same candidates. The legality
filter applies the trainers' own divisibility and composition rules
(``train/composed.py::validate_config``) up front, so an emitted plan never dies in the
trainer's validation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable

from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.costs import (
    Candidate, CostBreakdown, ModelStats, ServeCostBreakdown, ServeStats,
    Topology, predict, predict_serve,
)

MAX_GRAD_ACCUM = 8       # accumulation splits tried when the scenario allows
MAX_MICROBATCHES = 16    # GPipe splits tried per stage candidate


@dataclass
class Scenario:
    """Everything one planning run needs: the model's stats, the topology, the
    batch, and which parts of the space the target trainer can execute
    (``axes``/``allow_fsdp`` mirror the trainer's own composition rules)."""

    run_type: str                       # 'composed' | 'lm' | 'cnn'
    stats: ModelStats
    topo: Topology
    global_batch: int
    axes: tuple = ("data", "model", "stage")
    allow_fsdp: bool = True
    allow_grad_accum: bool = False
    fixed_grad_accum: int = 1
    test_batch: int = 0      # eval batch a stage split must also divide
                             # (composed: batch_size_test % microbatches); 0 off
    hbm_fraction: float = 0.9
    # Optional empirical trial: candidate -> measured step seconds (None =
    # unmeasurable, e.g. a stage layout the trial harness doesn't build).
    # Installed by plan/scenarios.py; consumed by plan/autotune.py only.
    trial: Callable | None = field(default=None, repr=False)


@dataclass(frozen=True)
class Ranked:
    """One search result row: the candidate, its predicted costs, and (after
    ``plan.autotune.refine``) its measured step time + compile stats."""

    candidate: Candidate
    costs: CostBreakdown
    measured_step_s: float | None = None
    compile_s: float | None = None
    measured_flops_per_step: float | None = None

    @property
    def best_step_s(self) -> float:
        return (self.measured_step_s if self.measured_step_s is not None
                else self.costs.step_s)

    def to_dict(self) -> dict:
        return {"candidate": self.candidate.to_dict(),
                "costs": self.costs.to_dict(),
                "measured_step_s": self.measured_step_s,
                "compile_s": self.compile_s,
                "measured_flops_per_step": self.measured_flops_per_step}


def _factor_pairs(n: int):
    for a in range(1, n + 1):
        if n % a == 0:
            yield a, n // a


def _pow2_divisors(n: int, cap: int):
    d = 1
    while d <= min(n, cap):
        if n % d == 0:
            yield d
        d *= 2


def enumerate_candidates(scenario: Scenario) -> list[Candidate]:
    """Every LEGAL candidate for the scenario — the brute-force ground set.

    Legality mirrors the trainers' own guards: the global batch (and each
    accumulation microbatch) shards evenly over ``data``; ``model`` divides the
    attention heads and the embedding width (Megatron column/row splits);
    ``stage`` divides the layer stack, composes with data/model only, and
    carries a microbatch split the per-call batch divides by; ``fsdp`` never
    composes with a stage axis. Candidates are deduplicated and deterministic
    in order."""
    st, n = scenario.stats, scenario.topo.num_devices
    out: list[Candidate] = []
    accums = ([scenario.fixed_grad_accum] if not scenario.allow_grad_accum
              else sorted({scenario.fixed_grad_accum}
                          | set(_pow2_divisors(scenario.global_batch,
                                               MAX_GRAD_ACCUM))))
    for d, rest in _factor_pairs(n):
        if "data" not in scenario.axes and d > 1:
            continue
        if scenario.global_batch % d:
            continue
        for m, s in _factor_pairs(rest):
            if m > 1 and ("model" not in scenario.axes
                          or st.num_heads % m or st.embed_dim % m):
                continue
            if s > 1 and ("stage" not in scenario.axes
                          or st.num_layers % s):
                continue
            for accum in accums:
                step_batch = scenario.global_batch // accum
                if step_batch % d or (step_batch // d) == 0:
                    continue
                if s == 1:
                    out.append(Candidate(data=d, model=m, stage=s,
                                         grad_accum=accum))
                    if scenario.allow_fsdp and d > 1:
                        out.append(Candidate(data=d, model=m, stage=s,
                                             fsdp=True, grad_accum=accum))
                    continue
                for mb in _pow2_divisors(step_batch, MAX_MICROBATCHES):
                    if (step_batch // mb) % d:
                        continue
                    if scenario.test_batch and scenario.test_batch % mb:
                        # The composed trainer's eval engine pipelines the
                        # SAME microbatch split over the test batch — a plan
                        # that fails that guard must never be emitted.
                        continue
                    out.append(Candidate(data=d, model=m, stage=s,
                                         grad_accum=accum, microbatches=mb))
    return out


def _sort_key(row: Ranked):
    """Deterministic ranking: feasible first, then predicted step time, then a
    simplicity preference (fewer mesh axes, no FSDP, less microbatching, more
    data parallelism) so cost-model ties never flap between runs."""
    c = row.candidate
    axes_used = (c.model > 1) + (c.stage > 1)
    return (not row.costs.fits, row.costs.step_s, axes_used, c.fsdp,
            c.grad_accum * c.microbatches, -c.data, c.model, c.stage)


def search(scenario: Scenario, *, top: int = 10) -> list[Ranked]:
    """Enumerate, price, and rank the scenario's layouts; the head of the list
    is the planner's pick. Returns at most ``top`` rows, feasible-first; raises
    when NO candidate fits the memory budget (an infeasible plan must never be
    silently emitted — the error names the smallest observed footprint so the
    user can grow accum/devices or shrink the model)."""
    cands = enumerate_candidates(scenario)
    if not cands:
        raise ValueError(
            f"no legal parallel layout for {scenario.topo.num_devices} devices "
            f"at global batch {scenario.global_batch} (model "
            f"{scenario.stats.name!r})")
    rows = [Ranked(c, predict(scenario.stats, scenario.topo, c,
                              global_batch=scenario.global_batch,
                              hbm_fraction=scenario.hbm_fraction))
            for c in cands]
    rows.sort(key=_sort_key)
    if not rows[0].costs.fits:
        tightest = min(r.costs.total_bytes_per_chip for r in rows)
        raise ValueError(
            f"no layout fits the per-chip memory budget "
            f"({rows[0].costs.hbm_budget_bytes / 2**30:.2f} GiB usable): the "
            f"smallest candidate footprint is {tightest / 2**30:.2f} GiB — "
            f"add devices, enable grad accumulation, or shrink the model")
    return rows[:top]


# =========================================================================================
# Serving mesh search (the serve-plan half of DESIGN.md §25): enumerate the
# TP×(slot-DP) factorizations serving/shard.py can legally build, price them
# with plan.costs.predict_serve, and — when the scenario carries a measure
# hook — let MEASUREMENT pick the winner among the analytically-shortlisted
# candidates. The analytical model prunes; it never outranks a measurement.
# =========================================================================================


@dataclass
class ServeScenario:
    """One serve-planning run: the model's serving stats, the topology, the
    slot count, the workload shape (typical prompt length), and the SLO.
    ``measure`` is an optional empirical hook ``(tp, dp) -> tokens/s | None``
    (None = candidate unmeasurable); installed by the bench/loadgen caller,
    never by ``scenarios.for_serve`` — measuring means serving real traffic."""

    stats: ServeStats
    topo: Topology
    num_slots: int
    prompt_len: int
    ttft_slo_s: float | None = None
    hbm_fraction: float = 0.9
    measure: Callable | None = field(default=None, repr=False)


@dataclass(frozen=True)
class ServeRanked:
    """One serve search row: the (tp, dp) mesh, its predicted costs, and —
    after the measure pass — the observed tokens/s."""

    tp: int
    dp: int
    costs: ServeCostBreakdown
    measured_tokens_per_s: float | None = None

    @property
    def best_tokens_per_s(self) -> float:
        return (self.measured_tokens_per_s
                if self.measured_tokens_per_s is not None
                else self.costs.tokens_per_s)

    def shard_spec(self) -> str:
        """The replica-facing ``--shard`` string (serving/tiers.py twin)."""
        return f"tp={self.tp},dp={self.dp}"

    def to_dict(self) -> dict:
        return {"tp": self.tp, "dp": self.dp,
                "shard_spec": self.shard_spec(),
                "costs": self.costs.to_dict(),
                "measured_tokens_per_s": self.measured_tokens_per_s}


def enumerate_serve_candidates(scenario: ServeScenario) -> list[tuple[int, int]]:
    """Every legal ``(tp, dp)`` pair for the device count: legality mirrors
    ``serving.shard.validate_engine_mesh`` exactly — ``tp`` divides both the
    query heads and the KV heads (head-sharded attention + cache planes),
    ``dp`` divides the slot count (whole slots per data group). Deterministic
    order: tp ascending."""
    st, n = scenario.stats, scenario.topo.num_devices
    out: list[tuple[int, int]] = []
    for tp, dp in _factor_pairs(n):
        if st.num_heads % tp or st.num_kv_heads % tp:
            continue
        if scenario.num_slots % dp:
            continue
        out.append((tp, dp))
    return out


def _serve_sort_key(row: ServeRanked):
    """Feasible first, highest throughput first, then simplicity (less TP —
    fewer collectives and a smaller blast radius) so model ties never flap."""
    return (not row.costs.feasible, -row.best_tokens_per_s, row.tp, row.dp)


def search_serve(scenario: ServeScenario, *, top: int = 10,
                 measure_top: int = 3) -> list[ServeRanked]:
    """Enumerate, price, rank — then, when the scenario carries a ``measure``
    hook, run it over the analytical top ``measure_top`` candidates and
    re-rank by measurement: the head of the returned list is the PICK, and it
    is always the measured-best among the measured set (the plan artifact's
    acceptance gate). Raises when no candidate is legal or none fits."""
    cands = enumerate_serve_candidates(scenario)
    if not cands:
        raise ValueError(
            f"no legal serve mesh for {scenario.topo.num_devices} devices "
            f"(heads {scenario.stats.num_heads}/{scenario.stats.num_kv_heads}, "
            f"slots {scenario.num_slots})")
    rows = [ServeRanked(tp, dp, predict_serve(
                scenario.stats, scenario.topo, tp=tp, dp=dp,
                num_slots=scenario.num_slots, prompt_len=scenario.prompt_len,
                ttft_slo_s=scenario.ttft_slo_s,
                hbm_fraction=scenario.hbm_fraction))
            for tp, dp in cands]
    rows.sort(key=_serve_sort_key)
    if not rows[0].costs.fits:
        tightest = min(r.costs.total_bytes_per_chip for r in rows)
        raise ValueError(
            f"no serve mesh fits the per-chip memory budget "
            f"({rows[0].costs.hbm_budget_bytes / 2**30:.2f} GiB usable): the "
            f"smallest candidate footprint is {tightest / 2**30:.2f} GiB — "
            f"add devices, shrink slots, or quantize the KV cache")
    rows = rows[:top]
    if scenario.measure is not None:
        measured = [dataclasses.replace(
                        r, measured_tokens_per_s=scenario.measure(r.tp, r.dp))
                    for r in rows[:measure_top]]
        # Measured rows outrank unmeasured ones outright; among measured,
        # observed tokens/s decides — the model only chose WHO got measured.
        measured.sort(key=lambda r: (r.measured_tokens_per_s is None,
                                     -(r.measured_tokens_per_s or 0.0),
                                     r.tp, r.dp))
        rows = measured + rows[measure_top:]
    return rows
