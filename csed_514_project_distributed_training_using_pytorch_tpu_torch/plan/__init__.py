"""Automatic parallelism planning: pick the mesh layout instead of knowing it.

Counterpart of the JAX package's ``plan/``, module for module:

- ``costs.py``      — the analytical per-step cost model (memory / FLOPs / per-axis
  collective bytes inside and across hosts) for a model on an axis-shaped mesh, with the
  H100's nominal tables;
- ``search.py``     — enumerate legal DP×FSDP×TP×PP factorizations of the device count,
  prune by per-device memory, rank by predicted step time (and the serve mesh's);
- ``autotune.py``   — optional empirical re-rank: short trials of the top-K candidates
  on the run's device;
- ``scenarios.py``  — one scenario per trainer surface + the trial harness;
- ``artifact.py``   — the serializable ``Plan`` JSON (render it with ``python -m
  csed_514_project_distributed_training_using_pytorch_tpu_torch.plan_report``, replay it
  with ``--plan path.json``).

Trainer surface (``train/composed.py``, ``train/lm.py``)::

    --plan auto         # analytical pick
    --plan tune         # analytical top-K, re-ranked by measured step time
    --plan plan.json    # replay a saved/edited plan verbatim

``--plan`` omitted leaves the trainers bitwise as they were. Every rank of a world
resolves the same plan: ``auto`` and a file are deterministic, and ``tune`` degrades to
``auto`` at a world of more than one rank (each rank's wall clock could rank differently).
"""

from __future__ import annotations

import dataclasses
import os

import torch.distributed as dist

from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.artifact import (
    Plan,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.costs import (
    Candidate,
    CostBreakdown,
    ModelStats,
    ServeCostBreakdown,
    ServeStats,
    Topology,
    predict,
    predict_serve,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.search import (
    Ranked,
    Scenario,
    ServeRanked,
    ServeScenario,
    enumerate_candidates,
    enumerate_serve_candidates,
    search,
    search_serve,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan import (
    autotune,
    scenarios,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import metrics as M

__all__ = [
    "Plan", "Candidate", "CostBreakdown", "ModelStats", "Topology", "Ranked",
    "Scenario", "predict", "enumerate_candidates", "search", "autotune",
    "scenarios", "resolve", "apply_plan", "AUTOTUNE_TOP_K",
    "ServeStats", "ServeCostBreakdown", "ServeScenario", "ServeRanked",
    "predict_serve", "enumerate_serve_candidates", "search_serve",
]

AUTOTUNE_TOP_K = 3


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _plan_from_ranked(scenario: Scenario, ranked: list[Ranked],
                      source: str) -> Plan:
    best = ranked[0]
    c = best.candidate
    return Plan(
        run_type=scenario.run_type, device_count=c.num_devices,
        mesh=c.mesh_spec(), axes=c.axes(), fsdp=c.fsdp,
        grad_accum=c.grad_accum, pipeline_microbatches=c.microbatches,
        source=source, predicted=best.costs.to_dict(),
        measured_step_s=best.measured_step_s,
        topology=scenario.topo.to_dict(), model=scenario.stats.to_dict(),
        global_batch=scenario.global_batch,
        candidates=[r.to_dict() for r in ranked])


def resolve(spec: str, scenario: Scenario, *, emit=None) -> Plan:
    """``--plan`` value -> ``Plan``: ``"auto"`` searches the analytical model, ``"tune"``
    additionally measures the top-K (degrading to ``auto`` at a world of more than one
    rank, where per-process wall clocks could rank differently and desynchronize the
    layout), anything else is a path to a saved artifact, validated against the live
    device count before the trainer builds a grid from it."""
    if spec in ("auto", "tune"):
        ranked = search(scenario)
        source = spec
        if spec == "tune" and _world() > 1:
            M.log("WARNING: --plan tune on a multi-process fleet would rank by "
                  "per-host wall clocks; degrading to the analytical 'auto' "
                  "ranking (identical on every process)")
            source = "auto"
        elif spec == "tune":
            ranked = autotune.refine(scenario, ranked, top_k=AUTOTUNE_TOP_K,
                                     emit=emit)
        return _plan_from_ranked(scenario, ranked, source)
    plan = Plan.load(spec)
    if plan.run_type != scenario.run_type:
        raise ValueError(
            f"plan {spec!r} was made for the {plan.run_type!r} trainer, not "
            f"{scenario.run_type!r} — regenerate with --plan auto")
    avail = scenario.topo.num_devices
    if plan.device_count > avail:
        raise ValueError(
            f"plan {spec!r} targets {plan.device_count} devices but only "
            f"{avail} are addressable — regenerate with --plan auto")
    return dataclasses.replace(plan, source="file")


def apply_plan(config, run_type: str, *, topo: Topology | None = None,
               emit=None, device=None):
    """Resolve ``config.plan`` and fold the pick back into the (frozen) trainer config.
    Returns ``(new_config, Plan)``; with ``config.plan`` empty the config object is
    returned untouched (the bitwise-identity contract).

    ``topo`` stubs the topology (default: ``Topology.detect(device)``, a collective at
    more than one rank, so every rank calls this); ``device`` (default ``config.device``)
    is where the topology is read and the ``tune`` trials run. The artifact is saved to
    ``<results_dir>/plan_<run_type>.json`` (rank 0, atomic) whenever it was computed here
    rather than loaded, so every ``--plan auto|tune`` run leaves a replayable record."""
    if not config.plan:
        return config, None
    if run_type == "composed":
        scenario = scenarios.for_composed(config, topo, device=device)
    elif run_type == "lm":
        scenario = scenarios.for_lm(config, topo, device=device)
    else:
        raise ValueError(f"no planning scenario for run_type {run_type!r}")
    plan = resolve(config.plan, scenario, emit=emit)
    if plan.source != "file" and config.results_dir and M.is_logging_process():
        path = os.path.join(config.results_dir, f"plan_{run_type}.json")
        plan.save(path)
        M.log(f"Saved {path}")
    repl = {"mesh": plan.mesh, "grad_accum": plan.grad_accum}
    if run_type == "composed":
        repl["fsdp"] = plan.fsdp
        if plan.axes.get("stage", 1) > 1:
            repl["pipeline_microbatches"] = plan.pipeline_microbatches
    M.log(f"Plan ({plan.source}): mesh {plan.mesh}"
          + (", fsdp" if plan.fsdp else "")
          + f", grad_accum {plan.grad_accum}"
          + (f", microbatches {plan.pipeline_microbatches}"
             if plan.axes.get("stage", 1) > 1 else "")
          + " — predicted step "
          + (f"{plan.predicted.get('step_s', 0) * 1e3:.3f} ms"
             if plan.predicted else "n/a")
          + (f", measured {plan.measured_step_s * 1e3:.3f} ms"
             if plan.measured_step_s else ""))
    return dataclasses.replace(config, **repl), plan
