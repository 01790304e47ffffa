"""Render a parallelism-plan artifact (``plan/``) as candidate tables + deltas.

The port's counterpart of the JAX package's ``tools/plan_report.py``, with its flags and
output. Input is the JSON a ``--plan auto|tune`` run saved (``plan_<run_type>.json`` in
its results directory, or anything ``plan.Plan.save`` wrote; a plan of either package).
Prints the chosen layout, the topology it was priced against, and the ranked candidate
table: predicted step time, per-device memory, feasibility and (tune) the measured step
time with its predicted-vs-measured delta.

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.plan_report \
        results/plan_composed.json [--telemetry run.jsonl]

``--telemetry`` joins the plan against a training run's telemetry JSONL (``--telemetry``
on the trainer): the run's best measured step seconds (its ``epoch`` events) next to the
plan's prediction, and any ``autotune`` trial lines folded into the table.
"""

from __future__ import annotations

import argparse
import sys

from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.artifact import (
    Plan,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.metrics import (
    load_metrics_jsonl,
)


def _fmt_ms(x) -> str:
    return f"{x * 1e3:.3f}" if isinstance(x, (int, float)) else "-"


def _fmt_gib(x) -> str:
    return f"{x / 2**30:.3f}" if isinstance(x, (int, float)) else "-"


def _delta(pred, meas) -> str:
    if not isinstance(pred, (int, float)) or not isinstance(meas, (int, float)) \
            or not pred:
        return "-"
    return f"{(meas - pred) / pred * 100:+.0f}%"


def _cand_label(c: dict) -> str:
    label = ",".join(f"{k}={v}" for k, v in c.get("axes", {}).items()
                     if v > 1) or "data=1"
    if c.get("fsdp"):
        label += "+fsdp"
    return label


def measured_step_from_telemetry(rows: list[dict]) -> float | None:
    """Best measured step seconds of a run: min over epoch events of
    ``execute_s / steps`` — the same steady-state quantity the ``mfu`` event
    uses, recomputed here so partial logs still report."""
    best = None
    for r in rows:
        if r.get("event") == "epoch" and r.get("execute_s") and r.get("steps"):
            s = r["execute_s"] / r["steps"]
            best = s if best is None else min(best, s)
    return best


def render(plan: Plan, telemetry_rows: list[dict] | None = None,
           out=sys.stdout) -> None:
    w = lambda line="": print(line, file=out)
    topo = plan.topology or {}
    w(f"# plan: {plan.run_type} · source={plan.source} · "
      f"{plan.device_count} devices · global batch {plan.global_batch}")
    if topo:
        w(f"  topology: {topo.get('device_kind', '?')} · "
          f"hbm {_fmt_gib(topo.get('hbm_bytes'))} GiB/chip "
          f"({topo.get('hbm_source', '?')}) · "
          f"ici {topo.get('ici_bytes', 0) / 1e9:.0f} GB/s · "
          f"dcn {topo.get('dcn_bytes', 0) / 1e9:.2f} GB/s · "
          f"{topo.get('num_slices', 1)} granule(s)")
    pred = plan.predicted or {}
    w(f"  chosen: mesh {plan.mesh}" + (" +fsdp" if plan.fsdp else "")
      + f" · grad_accum {plan.grad_accum}"
      + (f" · microbatches {plan.pipeline_microbatches}"
         if plan.axes.get("stage", 1) > 1 else ""))
    w(f"  predicted: step {_fmt_ms(pred.get('step_s'))} ms · "
      f"{_fmt_gib(pred.get('total_bytes_per_chip'))} GiB/chip"
      + (f" · measured (tune) {_fmt_ms(plan.measured_step_s)} ms "
         f"[{_delta(pred.get('step_s'), plan.measured_step_s)}]"
         if plan.measured_step_s is not None else ""))

    # Autotune lines from telemetry augment rows the plan didn't carry.
    tuned = {}
    run_measured = None
    if telemetry_rows:
        for r in telemetry_rows:
            if r.get("event") == "autotune" and r.get("measured_step_s"):
                key = (r.get("mesh"), bool(r.get("fsdp")),
                       int(r.get("grad_accum") or 1),
                       int(r.get("microbatches") or 1))
                tuned[key] = r["measured_step_s"]
        run_measured = measured_step_from_telemetry(telemetry_rows)

    if plan.candidates:
        w()
        w("  rank  layout                    accum  micro  pred_ms  meas_ms  "
          "delta  GiB/chip  fits")
        for i, row in enumerate(plan.candidates):
            c, costs = row.get("candidate", {}), row.get("costs", {})
            cand_axes = {"data": c.get("data", 1), "model": c.get("model", 1),
                         "stage": c.get("stage", 1)}
            label = _cand_label({"axes": cand_axes, "fsdp": c.get("fsdp")})
            meas = row.get("measured_step_s")
            if meas is None:
                mesh_str = ",".join(
                    [f"data={c.get('data', 1)}"]
                    + [f"{k}={v}" for k, v in (("model", c.get("model", 1)),
                                               ("stage", c.get("stage", 1)))
                       if v > 1])
                meas = tuned.get((mesh_str, bool(c.get("fsdp")),
                                  int(c.get("grad_accum") or 1),
                                  int(c.get("microbatches") or 1)))
            w(f"  {i:>4}  {label:<24}  {c.get('grad_accum', 1):>5}  "
              f"{c.get('microbatches', 1):>5}  "
              f"{_fmt_ms(costs.get('step_s')):>7}  {_fmt_ms(meas):>7}  "
              f"{_delta(costs.get('step_s'), meas):>5}  "
              f"{_fmt_gib(costs.get('total_bytes_per_chip')):>8}  "
              f"{'yes' if costs.get('fits') else 'NO'}")

    if run_measured is not None:
        w()
        w(f"  run measured (telemetry): best step {_fmt_ms(run_measured)} ms vs "
          f"predicted {_fmt_ms(pred.get('step_s'))} ms "
          f"[{_delta(pred.get('step_s'), run_measured)}]")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n", 1)[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("plan", help="plan JSON artifact (plan.Plan.save output)")
    parser.add_argument("--telemetry", default="",
                        help="telemetry JSONL of a run to compare measured step "
                             "time (epoch/autotune events) against the plan")
    args = parser.parse_args(argv)
    plan = Plan.load(args.plan)
    rows = load_metrics_jsonl(args.telemetry) if args.telemetry else None
    render(plan, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
