"""Empirical refinement: measure the top-K analytical candidates, re-rank by fact.

Counterpart of the JAX package's ``plan/autotune.py``, with its ranking rule. The
analytical model (``plan/costs.py``) is built to rank; its absolute numbers inherit every
nominal bandwidth in the tables. ``--plan tune`` closes the loop: the top-K candidates of
the analytical ranking are each trialed for a few steps on the run's device (the trial
harness of ``plan/scenarios.py``: the trainer's own step, its warm-up seconds reported as
``compile_s``, its flops from ``utils.telemetry.train_step_flops``), and the final ranking
sorts by measured step time. Candidates the harness cannot build keep their analytical
estimate and stay in the ranking, flagged unmeasured.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable

from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.search import (
    Ranked, Scenario,
)


def refine(scenario: Scenario, ranked: list[Ranked], *, top_k: int = 3,
           emit: Callable | None = None) -> list[Ranked]:
    """Measure the first ``top_k`` rows with the scenario's trial harness and
    re-rank: measured rows by measured step seconds, unmeasured rows after them
    by their analytical estimate (a measured fact always outranks a prediction
    — an unmeasured stage candidate predicted faster than every measured row
    stays behind them rather than winning on an untested number).

    ``emit`` (optional) receives one ``utils.telemetry.autotune_event`` dict per trialed
    candidate: the trainers buffer them until their telemetry writer exists; tests pass
    a list appender."""
    if scenario.trial is None:
        return ranked
    out = []
    for rank, row in enumerate(ranked):
        if rank < top_k and row.costs.fits:
            trial = scenario.trial(row.candidate)
            if trial is not None:
                row = replace(row,
                              measured_step_s=trial.get("step_s"),
                              compile_s=trial.get("compile_s"),
                              measured_flops_per_step=trial.get("flops_per_step"))
            if emit is not None:
                from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
                    telemetry as T,
                )

                emit(T.autotune_event(
                    mesh=row.candidate.mesh_spec(), fsdp=row.candidate.fsdp,
                    grad_accum=row.candidate.grad_accum,
                    microbatches=row.candidate.microbatches, rank=rank,
                    predicted_step_s=row.costs.step_s,
                    measured_step_s=row.measured_step_s,
                    compile_s=row.compile_s,
                    flops_per_step=row.measured_flops_per_step))
        out.append(row)
    measured = [r for r in out if r.measured_step_s is not None]
    unmeasured = [r for r in out if r.measured_step_s is None]
    measured.sort(key=lambda r: r.measured_step_s)
    return measured + unmeasured
