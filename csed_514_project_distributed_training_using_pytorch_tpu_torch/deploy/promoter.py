"""Checkpoint promotion with canary rollout and auto-rollback.

Counterpart of the JAX package's ``deploy/promoter.py``: the same gate, canary, verdicts,
ledger rows and ``promote``/``canary`` telemetry events, over the port's versioned store
(``utils/checkpoint.py::save_versioned``: manifest entries carry ``health`` and
``cursor``) and the port's router (``serving/router.py``'s canary trio). The trainer
publishes health-stamped checkpoints into the store; the promoter watches it and walks
every new candidate through a fixed pipeline:

1. **Gate** (cheap, offline, ordered cheapest-first):
   a. *health stamp*: a candidate its own trainer stamped ``clean: false`` (the guard
      fired that epoch) is rejected without ever touching the fleet;
   b. *accuracy budget*: the candidate's held-out NLL may exceed the incumbent's by at
      most ``nll_budget`` (an absolute nats/token margin);
   c. *perf tolerance*: the median of ``perf_probes`` timed probes may exceed the
      incumbent's by at most ``perf_tolerance`` (relative).
2. **Canary**: survivors roll onto ONE replica (``Router.canary_reload``) while the rest
   of the fleet serves the incumbent; after the observation window the canary's windowed
   SLO attainment and sampled-token NLL are compared against the rest of the fleet
   (windows and margins, not raw latencies).
3. **Verdict**: pass promotes fleet-wide (``Router.promote_canary``, the
   never-below-N-1-ready roll); fail or inconclusive rolls back to the incumbent
   (``Router.rollback_canary``). Every transition lands in an append-only JSONL
   promotion ledger plus ``promote``/``canary`` telemetry events, so the whole trajectory
   is auditable from the stream alone.

The accuracy and perf probes are injected callables
(``nll_fn(path)``, ``perf_fn(path)``, ``sample_nll_fn(samples)``), so the gate, canary
and ledger logic test on echo fleets, and a caller supplies scorers backed by
``models.lm.decode_nll`` on the card.
"""

import dataclasses
import json
import os
import time

from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    telemetry as T,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    JsonlWriter,
)


@dataclasses.dataclass
class GateConfig:
    """The offline qualification gate, ordered cheapest-first.

    ``nll_budget`` is ABSOLUTE (nats/token the candidate may regress vs the
    incumbent); ``perf_tolerance`` is RELATIVE (fraction the candidate's
    median probe may exceed the incumbent's — the bench_guard idiom).
    ``require_stamp`` escalates the health check from "not stamped unclean"
    to "stamped clean" (guard-off trainers produce no stamp at all, and a
    legacy store must stay promotable)."""

    nll_budget: float = 0.05
    perf_tolerance: float = 0.5
    perf_probes: int = 3
    require_stamp: bool = False


@dataclasses.dataclass
class CanaryConfig:
    """The canary observation window and its pass margins.

    ``min_requests`` floors BOTH sides of the comparison — with fewer
    completions than that on either side the verdict is ``inconclusive``
    (which rolls back: an unjudgeable candidate must not ship).
    ``attainment_margin`` is how far below the fleet's windowed attainment
    the canary may sit; ``nll_margin`` how far above the fleet's
    sampled-token NLL (both under the ONE shared scorer)."""

    window_s: float = 5.0
    min_requests: int = 3
    attainment_margin: float = 0.10
    nll_margin: float = 0.10


class PromotionLedger:
    """Append-only JSONL promotion history: one line per lifecycle transition
    (``candidate_seen``/``superseded``/``gate_pass``/``gate_fail``/
    ``canary_start``/``canary_pass``/``canary_fail``/``promoted``/
    ``rolled_back``). Append, never truncate — a restarted promoter resumes
    onto the same file and the run's full trajectory survives. ``path`` empty
    disables writes (record still returns the row)."""

    def __init__(self, path: str):
        self.path = path or ""
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)

    def record(self, action: str, candidate: str, **fields) -> dict:
        row = {"t": round(time.time(), 3), "action": action,
               "candidate": candidate, **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
        return row


def read_ledger(path: str) -> list[dict]:
    """Load a promotion ledger, tolerating a torn final line (the promoter
    may be mid-append when a reader samples the file)."""
    rows: list[dict] = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return rows


class Promoter:
    """The promotion controller. ``ckpt_dir`` is the watched versioned store;
    ``router`` a started ``serving.router.Router`` (None = gate-only mode:
    qualification verdicts without a fleet, for offline qualification and
    unit tests). ``incumbent`` seeds last-good (None = the first qualifying
    candidate promotes unopposed — there is no incumbent to regress
    against)."""

    def __init__(self, ckpt_dir: str, *, router=None,
                 nll_fn=None, perf_fn=None, sample_nll_fn=None,
                 gate: GateConfig | None = None,
                 canary: CanaryConfig | None = None,
                 ledger_path: str = "", telemetry: str = "",
                 incumbent: str | None = None,
                 dwell_fn=None):
        self.ckpt_dir = ckpt_dir
        self.router = router
        self.nll_fn = nll_fn
        self.perf_fn = perf_fn
        self.sample_nll_fn = sample_nll_fn
        self.gate = gate or GateConfig()
        self.canary = canary or CanaryConfig()
        self.ledger = PromotionLedger(ledger_path)
        self._writer = JsonlWriter(telemetry)
        # The dwell hook: how the canary window passes. Default wall-clock
        # sleep; the serve loop injects its own (drive traffic while
        # waiting), tests inject a no-op.
        self._dwell = dwell_fn or (lambda s: time.sleep(s))
        self.incumbent = incumbent
        self.incumbent_nll: float | None = None
        self.incumbent_perf_s: float | None = None
        self._seen: set[str] = set()
        if incumbent:
            self._seen.add(os.path.basename(incumbent))
        self.counts = {"promoted": 0, "gate_fail": 0, "rolled_back": 0,
                       "superseded": 0}

    def close(self) -> None:
        self._writer.close()

    # ------------------------------------------------------------- discovery

    def candidates(self) -> list[dict]:
        """Unseen manifest entries whose bytes exist, oldest-first. The
        manifest is the source of truth (it carries the health stamp and the
        data cursor); a ``ckpt_*.msgpack`` that never made the manifest is a
        torn publish and is invisible here by design."""
        out = []
        for entry in checkpoint.load_manifest(self.ckpt_dir)["entries"]:
            name = entry.get("file")
            if not name or name in self._seen:
                continue
            if not os.path.exists(os.path.join(self.ckpt_dir, name)):
                continue
            out.append(entry)
        out.sort(key=lambda e: e.get("step", 0))
        return out

    # ------------------------------------------------------------------ gate

    def qualify(self, entry: dict) -> tuple[bool, str, dict]:
        """Run one candidate through the gate. Returns ``(ok, reason,
        measured)`` where ``measured`` carries the probe numbers (recorded in
        the ledger either way, so a rejection's margin is auditable)."""
        path = os.path.join(self.ckpt_dir, entry["file"])
        measured: dict = {}
        health = entry.get("health")
        if health is not None and not health.get("clean", True):
            return False, "unclean_health_stamp", measured
        if self.gate.require_stamp and health is None:
            return False, "missing_health_stamp", measured
        if self.nll_fn is not None:
            self._ensure_baseline()
            nll = float(self.nll_fn(path))
            measured["nll"] = nll
            measured["incumbent_nll"] = self.incumbent_nll
            if (self.incumbent_nll is not None
                    and nll > self.incumbent_nll + self.gate.nll_budget):
                return False, "nll_over_budget", measured
        if self.perf_fn is not None:
            self._ensure_baseline()
            probes = sorted(float(self.perf_fn(path))
                            for _ in range(max(1, self.gate.perf_probes)))
            perf = probes[len(probes) // 2]
            measured["perf_s"] = perf
            measured["incumbent_perf_s"] = self.incumbent_perf_s
            if (self.incumbent_perf_s is not None and perf >
                    self.incumbent_perf_s * (1.0 + self.gate.perf_tolerance)):
                return False, "perf_over_tolerance", measured
        return True, "", measured

    def _ensure_baseline(self) -> None:
        """Lazily measure the incumbent's NLL/perf ONCE — the yardstick every
        gate comparison uses until a promotion replaces it."""
        if self.incumbent is None:
            return
        if self.nll_fn is not None and self.incumbent_nll is None:
            self.incumbent_nll = float(self.nll_fn(self.incumbent))
        if self.perf_fn is not None and self.incumbent_perf_s is None:
            probes = sorted(float(self.perf_fn(self.incumbent))
                            for _ in range(max(1, self.gate.perf_probes)))
            self.incumbent_perf_s = probes[len(probes) // 2]

    # ---------------------------------------------------------------- canary

    def judge_canary(self, report: dict,
                     canary_nll: float | None,
                     fleet_nll: float | None) -> tuple[str, str]:
        """The canary verdict from one ``Router.canary_report`` plus the two
        sampled-token NLL scores: ``(verdict, reason)`` with verdict ``pass``
        / ``fail`` / ``inconclusive``. Attainment compares WINDOWS (fractions
        of the SLO promise kept over the same wall-clock window), never raw
        latencies — a canary absorbing the fleet's heaviest prompts would
        fail a raw-latency bar while keeping every promise."""
        c, f = report["canary"], report["fleet"]
        if (c["requests"] < self.canary.min_requests
                or f["requests"] < self.canary.min_requests):
            return "inconclusive", (
                f"too few requests (canary {c['requests']}, "
                f"fleet {f['requests']}, need {self.canary.min_requests})")
        if (c["attainment"] is not None and f["attainment"] is not None
                and c["attainment"]
                < f["attainment"] - self.canary.attainment_margin):
            return "fail", (
                f"attainment {c['attainment']:.3f} < fleet "
                f"{f['attainment']:.3f} - {self.canary.attainment_margin}")
        if (canary_nll is not None and fleet_nll is not None
                and canary_nll > fleet_nll + self.canary.nll_margin):
            return "fail", (
                f"sampled nll {canary_nll:.4f} > fleet {fleet_nll:.4f} "
                f"+ {self.canary.nll_margin}")
        return "pass", ""

    # ------------------------------------------------------------- lifecycle

    def process(self, entry: dict) -> str:
        """Walk ONE candidate through gate → canary → promote/rollback.
        Returns the terminal action (``gate_fail`` / ``promoted`` /
        ``rolled_back``). Gate-only mode (no router) promotes on gate pass —
        qualification IS the deployment decision when there is no fleet."""
        name = entry["file"]
        path = os.path.join(self.ckpt_dir, name)
        step = entry.get("step")
        self._seen.add(name)
        self.ledger.record("candidate_seen", name, step=step,
                           health=entry.get("health"))
        self._writer.emit(T.promote_event(
            action="candidate_seen", candidate=name, step=step,
            incumbent=self.incumbent or ""))
        ok, reason, measured = self.qualify(entry)
        if not ok:
            self.counts["gate_fail"] += 1
            self.ledger.record("gate_fail", name, step=step, reason=reason,
                               **measured)
            self._writer.emit(T.promote_event(
                action="gate_fail", candidate=name, step=step, reason=reason,
                incumbent=self.incumbent or "",
                nll=measured.get("nll"),
                incumbent_nll=measured.get("incumbent_nll"),
                perf_s=measured.get("perf_s"),
                incumbent_perf_s=measured.get("incumbent_perf_s")))
            return "gate_fail"
        self.ledger.record("gate_pass", name, step=step, **measured)
        self._writer.emit(T.promote_event(
            action="gate_pass", candidate=name, step=step,
            incumbent=self.incumbent or "",
            nll=measured.get("nll"),
            incumbent_nll=measured.get("incumbent_nll"),
            perf_s=measured.get("perf_s"),
            incumbent_perf_s=measured.get("incumbent_perf_s")))
        if self.router is None:
            self._promote_state(path, measured)
            self.ledger.record("promoted", name, step=step, canaried=False)
            self._writer.emit(T.promote_event(
                action="promoted", candidate=name, step=step,
                reason="gate_only", incumbent=self.incumbent or ""))
            return "promoted"
        return self._canary_and_settle(entry, path, measured)

    def _canary_and_settle(self, entry: dict, path: str,
                           measured: dict) -> str:
        name, step = entry["file"], entry.get("step")
        self.ledger.record("canary_start", name, step=step)
        self._writer.emit(T.promote_event(
            action="canary_start", candidate=name, step=step,
            incumbent=self.incumbent or ""))
        roll = self.router.canary_reload(path)
        self._dwell(self.canary.window_s)
        report = self.router.canary_report()
        canary_nll = fleet_nll = None
        if self.sample_nll_fn is not None:
            if report["canary_samples"]:
                canary_nll = float(self.sample_nll_fn(
                    report["canary_samples"]))
            if report["fleet_samples"]:
                fleet_nll = float(self.sample_nll_fn(report["fleet_samples"]))
        verdict, reason = self.judge_canary(report, canary_nll, fleet_nll)
        self._writer.emit(T.canary_event(
            candidate=name, replica=roll["replica"], verdict=verdict,
            window_s=self.canary.window_s,
            canary_attainment=report["canary"]["attainment"],
            fleet_attainment=report["fleet"]["attainment"],
            canary_nll=canary_nll, fleet_nll=fleet_nll,
            canary_requests=report["canary"]["requests"],
            fleet_requests=report["fleet"]["requests"],
            reason=reason))
        self.ledger.record(
            "canary_pass" if verdict == "pass" else "canary_fail", name,
            step=step, verdict=verdict, reason=reason,
            replica=roll["replica"],
            canary_attainment=report["canary"]["attainment"],
            fleet_attainment=report["fleet"]["attainment"],
            canary_nll=canary_nll, fleet_nll=fleet_nll,
            canary_requests=report["canary"]["requests"],
            fleet_requests=report["fleet"]["requests"])
        if verdict == "pass":
            self.router.promote_canary()
            self._promote_state(path, measured)
            self.ledger.record("promoted", name, step=step, canaried=True)
            self._writer.emit(T.promote_event(
                action="promoted", candidate=name, step=step,
                incumbent=self.incumbent or ""))
            return "promoted"
        self.router.rollback_canary()
        self.counts["rolled_back"] += 1
        self.ledger.record("rolled_back", name, step=step, reason=reason,
                           incumbent=self.incumbent or "")
        self._writer.emit(T.promote_event(
            action="rolled_back", candidate=name, step=step, reason=reason,
            incumbent=self.incumbent or ""))
        return "rolled_back"

    def _promote_state(self, path: str, measured: dict) -> None:
        """The new last-good: the candidate's OWN gate measurements become
        the next comparison's incumbent baseline (re-probing the same file
        later would only add noise)."""
        self.counts["promoted"] += 1
        self.incumbent = path
        self.incumbent_nll = measured.get("nll", self.incumbent_nll)
        self.incumbent_perf_s = measured.get("perf_s", self.incumbent_perf_s)

    def run_once(self) -> list[str]:
        """One poll: process the NEWEST unseen candidate; older unseen ones
        are marked ``superseded`` (a faster trainer than promoter must not
        queue an ever-growing canary backlog — the newest checkpoint
        subsumes its elders). Returns the terminal actions taken."""
        cands = self.candidates()
        if not cands:
            return []
        for stale in cands[:-1]:
            self._seen.add(stale["file"])
            self.counts["superseded"] += 1
            self.ledger.record("superseded", stale["file"],
                               step=stale.get("step"),
                               by=cands[-1]["file"])
        return [self.process(cands[-1])]

    def run(self, *, stop_fn, poll_s: float = 0.5) -> dict:
        """The watch loop of a train-and-serve loop: poll the store until
        ``stop_fn()`` goes true, then drain any final unseen candidate before
        returning the action counts."""
        while not stop_fn():
            self.run_once()
            time.sleep(poll_s)
        self.run_once()
        return dict(self.counts)
