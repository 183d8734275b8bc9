"""Per-slot consensus health ledger (the telemetry plane's chain half;
the port's copy of consensus_specs_tpu/chain/health.py).

The Beacon-client security review (PAPERS.md) catalogues the slow-burn
failure modes — participation decay, growing finality lag, deferral-
buffer growth, reorg churn — that no point-in-time gauge can catch: each
one looks healthy in any single sample and only shows up as a TREND.
This module computes the consensus-semantic numbers once per slot from
the structures that already exist (the proto-array's vote/balance
tables, the spec store's checkpoints, ``ChainMetrics`` counters) and
exports them as the ``health.*`` gauge family, which the time-series
store (``obs/timeseries.py``) then samples into history:

- **participation_rate** — attesting balance / total balance in the
  proto-array's balance table (the spec's own weighting, so a validator
  set change moves the denominator the same slot it moves fork choice);
- **head_churn** — head pointer moves this slot;
- **reorg_depth** — deepest rollback among this slot's reorgs (0 when
  the head only extended);
- **finality_lag_slots** — current slot minus the finalized checkpoint
  epoch's start slot: THE liveness number, meaningful only measured
  continuously (a healthy chain holds it near 2 epochs);
- **deferral_depth** — deferral-buffer depth (gossip arriving ahead of
  its dependencies);
- **rollback_rate** — speculative batches reverted this slot;
- **unexplained_reorgs** — cumulative reorgs observed OUTSIDE windows
  the caller declared disruption for (``expect_reorgs=``): the soak's
  "zero unexplained reorgs" gate reads this.

``observe_slot`` is cheap (counter reads + two dict sums), so calling it
every simulated slot for thousands of slots is free relative to the
slot's own processing. ``summary()`` + ``evaluate_gate()`` produce the
"HEALTH DIVERGED" state ``tools/bench_compare.py`` gates on.
"""
from collections import deque
from typing import Dict, List, Optional

from ..obs.registry import node_label
from ..ops import profiling

# the gauge family, in export order (the obs drift gate scans this tuple:
# every name must be registered in obs/registry.py and documented in the
# README metric table)
GAUGE_LABELS = (
    "health.participation_rate",
    "health.head_churn",
    "health.reorg_depth",
    "health.finality_lag_slots",
    "health.deferral_depth",
    "health.rollback_rate",
    "health.unexplained_reorgs",
)

# gate defaults (the soak's acceptance thresholds; scenarios with
# declared disruption pass explicit bounds)
DEFAULT_PARTICIPATION_FLOOR = 0.60
DEFAULT_FINALITY_LAG_MAX_SLOTS = 64


class HealthLedger:
    """Per-slot health records for one :class:`HeadService`.

    ``node`` labels the exported family (``health[<node>].<name>``) so N
    simnet instances publish side by side — same contract as
    ``ChainMetrics``. ``window`` bounds the retained per-slot records
    (the TSDB is the long-horizon store; this ring only feeds
    ``summary()``'s extremes, which are tracked cumulatively anyway)."""

    def __init__(self, head_service, *, node: Optional[str] = None,
                 window: int = 4096):
        self._svc = head_service
        self.node = node
        self._labels = tuple(node_label(label, node)
                             for label in GAUGE_LABELS)
        self._records: "deque[Dict]" = deque(maxlen=window)
        self._prev: Optional[Dict] = None
        self.slots_observed = 0
        self.unexplained_reorgs = 0
        self.participation_min: Optional[float] = None
        self.participation_sum = 0.0
        self.finality_lag_max = 0
        self.reorg_depth_max = 0
        self.deferral_depth_max = 0
        self.head_churn_total = 0
        self.reorgs_total = 0
        self.rollbacks_total = 0

    # -- recording -----------------------------------------------------------

    def observe_slot(self, slot: Optional[int] = None,
                     expect_reorgs: bool = False) -> Dict:
        """Compute + record this slot's health row. ``expect_reorgs``
        declares that disruption (a partition heal, an equivocation
        window) makes reorgs explainable right now — reorgs observed
        while it is False accumulate into ``unexplained_reorgs``."""
        svc = self._svc
        spec, store = svc.spec, svc.store
        if slot is None:
            slot = int(spec.get_current_slot(store))
        balances = svc.fc._balances
        total = sum(balances.values())
        voted = sum(balances.get(v, 0) for v in svc.fc.votes)
        participation = (voted / total) if total else 0.0
        fin_epoch = int(store.finalized_checkpoint.epoch)
        fin_slot = int(spec.compute_start_slot_at_epoch(fin_epoch))
        finality_lag = max(0, int(slot) - fin_slot)
        counters = svc.metrics.counters()
        prev = self._prev or {"head_changes": 0, "reorgs": 0,
                              "rollbacks": 0, "last_reorg_depth": 0}
        churn = counters["head_changes"] - prev["head_changes"]
        reorgs = counters["reorgs"] - prev["reorgs"]
        rollbacks = counters["rollbacks"] - prev["rollbacks"]
        reorg_depth = counters["last_reorg_depth"] if reorgs else 0
        self._prev = counters
        if reorgs and not expect_reorgs:
            self.unexplained_reorgs += reorgs
        record = {
            "slot": int(slot),
            "participation_rate": round(participation, 6),
            "head_churn": churn,
            "reorg_depth": reorg_depth,
            "finality_lag_slots": finality_lag,
            "deferral_depth": svc.deferred_count,
            "rollback_rate": rollbacks,
            "unexplained_reorgs": self.unexplained_reorgs,
            "expected_reorgs": bool(expect_reorgs),
        }
        self._records.append(record)
        self.slots_observed += 1
        self.participation_sum += participation
        if (self.participation_min is None
                or participation < self.participation_min):
            self.participation_min = participation
        self.finality_lag_max = max(self.finality_lag_max, finality_lag)
        self.reorg_depth_max = max(self.reorg_depth_max, reorg_depth)
        self.deferral_depth_max = max(self.deferral_depth_max,
                                      record["deferral_depth"])
        self.head_churn_total += churn
        self.reorgs_total += reorgs
        self.rollbacks_total += rollbacks
        self.export_gauges(record)
        return record

    def export_gauges(self, record: Dict) -> None:
        """Publish the latest row onto the profiling surface (and so into
        every TSDB sample). Values line up with ``GAUGE_LABELS``."""
        values = (
            record["participation_rate"],
            record["head_churn"],
            record["reorg_depth"],
            record["finality_lag_slots"],
            record["deferral_depth"],
            record["rollback_rate"],
            record["unexplained_reorgs"],
        )
        for label, value in zip(self._labels, values):
            profiling.set_gauge(label, value)

    # -- reading -------------------------------------------------------------

    def records(self) -> List[Dict]:
        return list(self._records)

    def summary(self) -> Dict:
        """The gate-facing aggregate over every observed slot."""
        n = max(1, self.slots_observed)
        last = self._records[-1] if self._records else None
        return {
            "slots_observed": self.slots_observed,
            "participation_min": round(self.participation_min or 0.0, 6),
            "participation_mean": round(self.participation_sum / n, 6),
            "participation_last": (last["participation_rate"]
                                   if last else 0.0),
            "finality_lag_max": self.finality_lag_max,
            "finality_lag_last": (last["finality_lag_slots"]
                                  if last else 0),
            "reorg_depth_max": self.reorg_depth_max,
            "reorgs_total": self.reorgs_total,
            "unexplained_reorgs": self.unexplained_reorgs,
            "head_churn_total": self.head_churn_total,
            "rollbacks_total": self.rollbacks_total,
            "deferral_depth_max": self.deferral_depth_max,
        }


def aggregate_summaries(summaries: List[Dict]) -> Dict:
    """Fleet/simnet aggregate: the WORST case across nodes per bound
    (min of participation floors, max of lags/depths, sum of reorg
    counts) — the number the gate judges, because one sick node is a
    sick deployment."""
    if not summaries:
        return {"slots_observed": 0, "participation_min": 0.0,
                "participation_mean": 0.0, "participation_last": 0.0,
                "finality_lag_max": 0, "finality_lag_last": 0,
                "reorg_depth_max": 0, "reorgs_total": 0,
                "unexplained_reorgs": 0, "head_churn_total": 0,
                "rollbacks_total": 0, "deferral_depth_max": 0}
    n = len(summaries)
    return {
        "slots_observed": max(s["slots_observed"] for s in summaries),
        "participation_min": round(
            min(s["participation_min"] for s in summaries), 6),
        "participation_mean": round(
            sum(s["participation_mean"] for s in summaries) / n, 6),
        "participation_last": round(
            min(s["participation_last"] for s in summaries), 6),
        "finality_lag_max": max(s["finality_lag_max"] for s in summaries),
        "finality_lag_last": max(s["finality_lag_last"] for s in summaries),
        "reorg_depth_max": max(s["reorg_depth_max"] for s in summaries),
        "reorgs_total": sum(s["reorgs_total"] for s in summaries),
        "unexplained_reorgs": sum(s["unexplained_reorgs"]
                                  for s in summaries),
        "head_churn_total": sum(s["head_churn_total"] for s in summaries),
        "rollbacks_total": sum(s["rollbacks_total"] for s in summaries),
        "deferral_depth_max": max(s["deferral_depth_max"]
                                  for s in summaries),
    }


def evaluate_gate(summary: Dict, *,
                  participation_floor: float = DEFAULT_PARTICIPATION_FLOOR,
                  finality_lag_max_slots: int = DEFAULT_FINALITY_LAG_MAX_SLOTS,
                  max_unexplained_reorgs: int = 0) -> Dict:
    """The "HEALTH DIVERGED" verdict over a (possibly aggregated)
    summary: participation never below the floor, finality lag bounded
    over the WHOLE horizon (monotone-bounded: the max, not the exit
    sample — a lag that grew and recovered still fails a bound it
    crossed), and zero reorgs outside declared disruption windows."""
    reasons = []
    if summary["slots_observed"] <= 0:
        reasons.append("no slots observed")
    if summary["participation_min"] < participation_floor:
        reasons.append(
            f"participation_min {summary['participation_min']:.4f} "
            f"< floor {participation_floor:.4f}")
    if summary["finality_lag_max"] > finality_lag_max_slots:
        reasons.append(
            f"finality_lag_max {summary['finality_lag_max']} "
            f"> bound {finality_lag_max_slots}")
    if summary["unexplained_reorgs"] > max_unexplained_reorgs:
        reasons.append(
            f"unexplained_reorgs {summary['unexplained_reorgs']} "
            f"> allowed {max_unexplained_reorgs}")
    return {
        "ok": not reasons,
        "reasons": reasons,
        "participation_floor": participation_floor,
        "finality_lag_max_slots": finality_lag_max_slots,
        "max_unexplained_reorgs": max_unexplained_reorgs,
        "summary": dict(summary),
    }
