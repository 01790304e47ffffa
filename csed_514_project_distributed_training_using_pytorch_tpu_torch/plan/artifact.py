"""The serializable ``Plan``: what the planner decided and why, as one JSON file.

Counterpart of the JAX package's ``plan/artifact.py``: the same keys, the same
validation and the same errors, so a plan saved by either package loads in the other.
The trainer that ran ``--plan auto|tune`` writes it beside its checkpoints
(``<results_dir>/plan_<run_type>.json``); ``python -m
csed_514_project_distributed_training_using_pytorch_tpu_torch.plan_report`` renders it;
``--plan path.json`` replays it on a later run with the same device count. It carries the
chosen mesh and microbatch split, the predicted time and memory breakdown, the topology it
was priced against and the ranked runner-up candidates.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field

from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.costs import (
    Candidate,
)

PLAN_SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Plan:
    """The planner's pick, in trainer-consumable and JSON-stable form."""

    run_type: str                       # 'composed' | 'lm' | 'cnn'
    device_count: int
    mesh: str                           # the --mesh spec string
    axes: dict                          # {'data': d, 'model': m, 'stage': s}
    fsdp: bool = False
    grad_accum: int = 1
    pipeline_microbatches: int = 1
    source: str = "auto"                # 'auto' | 'tune' | 'file'
    predicted: dict = field(default_factory=dict)   # CostBreakdown.to_dict()
    measured_step_s: float | None = None            # tune mode only
    topology: dict = field(default_factory=dict)    # Topology.to_dict()
    model: dict = field(default_factory=dict)       # ModelStats.to_dict()
    global_batch: int = 0
    candidates: list = field(default_factory=list)  # Ranked.to_dict() rows
    schema_version: int = PLAN_SCHEMA_VERSION

    @property
    def candidate(self) -> Candidate:
        return Candidate(data=int(self.axes.get("data", 1)),
                         model=int(self.axes.get("model", 1)),
                         stage=int(self.axes.get("stage", 1)),
                         fsdp=self.fsdp, grad_accum=self.grad_accum,
                         microbatches=self.pipeline_microbatches)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "Plan":
        if not isinstance(d, dict) or "mesh" not in d or "axes" not in d:
            raise ValueError("not a plan artifact: missing 'mesh'/'axes' keys")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            # Forward-compat: a NEWER writer may add fields; ignore but only
            # when the schema version says so, else it's probably not a plan.
            if int(d.get("schema_version", 0)) <= PLAN_SCHEMA_VERSION:
                raise ValueError(f"plan artifact has unknown keys {sorted(unknown)} "
                                 f"at schema_version <= {PLAN_SCHEMA_VERSION}")
        try:
            plan = cls(**{k: v for k, v in d.items() if k in known})
        except TypeError as e:
            # Hand-edited artifacts are a documented workflow: missing
            # required fields must surface as the corrupt-plan ValueError the
            # load contract promises, not a bare __init__ TypeError.
            raise ValueError(f"corrupt plan artifact: {e}") from e
        if plan.candidate.num_devices != plan.device_count:
            raise ValueError(
                f"corrupt plan: axes {plan.axes} product "
                f"{plan.candidate.num_devices} != device_count {plan.device_count}")
        return plan

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        """Atomic write (the checkpoint writer's tmp + rename), so a reader never
        observes a torn artifact."""
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.checkpoint import (
            _atomic_write,
        )

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _atomic_write(path, (self.to_json() + "\n").encode())

    @classmethod
    def load(cls, path: str) -> "Plan":
        with open(path) as fh:
            return cls.from_json(fh.read())
