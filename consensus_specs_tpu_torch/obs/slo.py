"""Declared SLOs and multi-window burn rates over the mergeable
histograms (the port's copy of consensus_specs_tpu/obs/slo.py), and the
fleet's shed policy.

A latency objective is "``q``% of requests complete under
``threshold``". This module turns the histogram bucket counts behind
``ops/profiling.record_latency`` into the two numbers an operator pages
on:

- **attainment**: the live ``q``-th percentile against the threshold,
  read by interpolation from the fixed log buckets every process shares;
- **burn rate**: how fast the error budget is being consumed, per
  lookback window. ``count_over(threshold)`` is exact bucket mass, so
  ``bad_fraction / (1 - q/100)`` needs no sampling: burn 1.0 drains the
  budget exactly at the sustainable rate, 10x pages. Two windows (fast
  and slow) keep one spike from paging while a sustained burn fires fast.

Surfaces: the ``slo.ok`` / ``slo.violations`` / ``slo.worst_burn_rate``
gauges on ``/metrics``; the ``/healthz`` body (liveness AND objective
state, ``obs/exposition.py``); and the fleet router, which evaluates the
burn on its MERGED worker histograms and feeds it through ``ShedPolicy``.

Objectives are env-tunable: ``CONSENSUS_SPECS_TPU_SLO`` is a comma list
of ``key=value_ms`` overrides (``serve_p99_ms``, ``chain_p99_ms``,
``gossip_to_head_p99_ms``).
"""
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

SLO_ENV = "CONSENSUS_SPECS_TPU_SLO"

# (name, latency label, quantile, default threshold ms): the declared
# objectives, the JAX package's list and defaults, so both packages'
# trackers evaluate (and their shed policies decide) alike on the same
# histograms. The defaults are loose; a deployment tightens them by env.
# The chain and gossip->head objectives read histograms of planes the
# port does not run yet: with no observations they are vacuously met.
_DEFAULTS: Tuple[Tuple[str, str, float, float], ...] = (
    ("serve_p99", "serve.submit_to_result", 99.0, 30_000.0),
    ("chain_p99", "chain.apply_batch", 99.0, 2_000.0),
    # the per-slot end-to-end objective: 99% of gossip items must move
    # the head within one sub-second budget
    ("gossip_to_head_p99", "latency.gossip_to_head", 99.0, 1_000.0),
)

# fast + slow burn windows (seconds): the classic multi-window pair,
# container-scaled so a bench run spans several fast windows
WINDOWS: Tuple[float, ...] = (60.0, 300.0)


def _env_overrides() -> Dict[str, float]:
    raw = os.environ.get(SLO_ENV, "")
    out: Dict[str, float] = {}
    for part in raw.split(","):
        if "=" not in part:
            continue
        key, _, val = part.partition("=")
        try:
            out[key.strip()] = float(val)
        except ValueError:
            continue
    return out


def declared_objectives() -> List[Dict]:
    """The objective list, env overrides applied (``<name>_ms=value``)."""
    overrides = _env_overrides()
    objectives = []
    for name, label, quantile, default_ms in _DEFAULTS:
        threshold_ms = overrides.get(f"{name}_ms", default_ms)
        objectives.append({
            "name": name,
            "label": label,
            "quantile": quantile,
            "threshold_s": threshold_ms / 1e3,
        })
    return objectives


class SloTracker:
    """Burn-rate bookkeeping over the process's latency histograms.

    Every ``evaluate()`` snapshots (count, count_over) per objective into
    a bounded checkpoint ring (rate-limited to one checkpoint per second,
    so a 10 Hz health prober cannot churn the 512-entry ring below the
    slow window's span); a window's burn rate diffs the live counts
    against the checkpoint CLOSEST to the window start (``now - w``) —
    never a lifetime total, so one stale reading after an idle gap decays
    as soon as fresher checkpoints exist. ``clock`` is injectable so
    tests can march time deterministically.
    """

    # minimum seconds between stored checkpoints: 512 entries at this
    # spacing span >= 512 s, comfortably past the 300 s slow window
    _CHECKPOINT_SPACING = 1.0

    def __init__(self, objectives: Optional[List[Dict]] = None,
                 windows: Tuple[float, ...] = WINDOWS,
                 clock=time.monotonic):
        self._objectives = (objectives if objectives is not None
                            else declared_objectives())
        self._windows = tuple(windows)
        self._clock = clock
        self._lock = threading.Lock()
        # (t, {objective name: (count, count_over)})
        self._checkpoints: "deque[Tuple[float, Dict]]" = deque(maxlen=512)

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, hists=None, export: bool = True) -> Dict[str, Dict]:
        """Current objective state + burn rates; also records a checkpoint
        and (by default) publishes the ``slo.*`` gauges.

        ``hists`` overrides the histogram source: the default is THIS
        process's ``profiling.latency_histograms()``, but the fleet
        router passes its aggregator's MERGED cross-process histograms —
        fleet burn rates are computed on exact fleet-wide bucket mass,
        not on any one worker's view. Per-worker attribution trackers
        pass each worker's own decoded histograms with ``export=False``
        so they never stomp the fleet-level ``slo.*`` gauges."""
        if hists is None:
            from ..ops import profiling

            hists = profiling.latency_histograms()
        now = self._clock()
        counts: Dict[str, Tuple[int, int]] = {}
        out: Dict[str, Dict] = {}
        for obj in self._objectives:
            h = hists.get(obj["label"])
            n = h.count if h is not None else 0
            over = h.count_over(obj["threshold_s"]) if h is not None else 0
            counts[obj["name"]] = (n, over)
            attained_s = (h.percentile(obj["quantile"])
                          if h is not None and n else 0.0)
            budget = max(1e-9, 1.0 - obj["quantile"] / 100.0)
            entry = {
                "label": obj["label"],
                "objective_ms": round(obj["threshold_s"] * 1e3, 3),
                "quantile": obj["quantile"],
                "n": n,
                "attained_ms": round(attained_s * 1e3, 3),
                # vacuously met with no observations (a plane that never
                # ran cannot violate its objective)
                "ok": (n == 0) or attained_s <= obj["threshold_s"],
                "bad_fraction": round(over / n, 6) if n else 0.0,
            }
            burn = {}
            with self._lock:
                for w in self._windows:
                    # baseline: the checkpoint closest to the window start
                    # (now - w) — the best available approximation of the
                    # state w seconds ago. No checkpoints at all -> zero
                    # burn (nothing to diff against), never a lifetime
                    # total masquerading as a window.
                    target = now - w
                    base, best = None, None
                    for t, snap in self._checkpoints:
                        dist = abs(t - target)
                        if best is None or dist < best:
                            best, base = dist, snap.get(obj["name"], (0, 0))
                    b_n, b_over = base if base is not None else (n, over)
                    d_n, d_over = n - b_n, over - b_over
                    rate = ((d_over / d_n) / budget) if d_n > 0 else 0.0
                    burn[f"{w:g}s"] = round(rate, 4)
            entry["burn_rate"] = burn
            if n:
                entry["margin"] = round(
                    obj["threshold_s"] / max(attained_s, 1e-9), 4)
            out[obj["name"]] = entry
        with self._lock:
            if (not self._checkpoints
                    or now - self._checkpoints[-1][0]
                    >= self._CHECKPOINT_SPACING):
                self._checkpoints.append((now, counts))
        if export:
            self._export_gauges(out)
        return out

    def _export_gauges(self, evaluated: Dict[str, Dict]) -> None:
        from ..ops import profiling

        violations = sum(1 for e in evaluated.values() if not e["ok"])
        worst = 0.0
        for e in evaluated.values():
            for rate in e["burn_rate"].values():
                worst = max(worst, rate)
        profiling.set_gauge("slo.ok", 0 if violations else 1)
        profiling.set_gauge("slo.violations", violations)
        profiling.set_gauge("slo.worst_burn_rate", worst)

    # -- surfaces ------------------------------------------------------------

    def healthz(self) -> Dict:
        """The upgraded ``/healthz`` body: liveness + objective state."""
        evaluated = self.evaluate()
        return {
            "ok": all(e["ok"] for e in evaluated.values()),
            "slo": evaluated,
        }

    def bench_section(self) -> Dict[str, Dict]:
        """The ``slo`` section of a bench JSON line: compact per-objective
        state (``margin`` is objective / attained, > 1 == meeting with
        room; absent when the objective saw no traffic this run)."""
        evaluated = self.evaluate()
        section = {}
        for name, e in evaluated.items():
            row = {
                "ok": bool(e["ok"]),
                "n": e["n"],
                "objective_ms": e["objective_ms"],
                "attained_ms": e["attained_ms"],
                "burn_rate": e["burn_rate"],
            }
            if "margin" in e:
                row["margin"] = e["margin"]
            section[name] = row
        return section


# -- fleet shed policy ---------------------------------------------------------
#
# The first time the obs plane CLOSES the loop from measurement to
# control: the fleet router computes burn rates on the MERGED worker
# histograms (evaluate(hists=...) above) and feeds them through this
# policy — the decision is which worker to push one rung down the
# existing RLC -> per-group -> oracle degradation ladder (shed), or to
# remove from the ring entirely (drain), when a window burns.

SHED_BURN_ENV = "CONSENSUS_SPECS_TPU_FLEET_SHED_BURN"
DRAIN_BURN_ENV = "CONSENSUS_SPECS_TPU_FLEET_DRAIN_BURN"

# burn-rate thresholds (multiples of the sustainable error-budget rate):
# 1.0 drains the budget exactly on schedule; the defaults page well past
# noise — shed at 4x, drain at 32x or when a shed-to-the-bottom worker
# keeps burning. Env-tunable without code, like the objectives above.
DEFAULT_SHED_BURN = 4.0
DEFAULT_DRAIN_BURN = 32.0


def worst_burn(evaluated: Dict[str, Dict]):
    """(objective name, window key, rate) of the highest burn rate in an
    ``evaluate()`` result — (None, None, 0.0) when nothing burns."""
    worst = (None, None, 0.0)
    for name, entry in sorted(evaluated.items()):
        for window, rate in sorted(entry.get("burn_rate", {}).items()):
            if rate > worst[2]:
                worst = (name, window, rate)
    return worst


class ShedDecision:
    """One policy verdict: ``action`` ("shed" | "drain") against
    ``worker``, with the burn evidence that justified it (objective,
    window, rate) — exactly what the router journals as the fleet
    flight event."""

    __slots__ = ("worker", "action", "objective", "window", "burn")

    def __init__(self, worker, action, objective, window, burn):
        self.worker = worker
        self.action = action
        self.objective = objective
        self.window = window
        self.burn = burn

    def as_dict(self) -> Dict:
        return {"worker": self.worker, "action": self.action,
                "objective": self.objective, "window": self.window,
                "burn": round(self.burn, 4)}

    def __repr__(self):
        return (f"ShedDecision({self.action} {self.worker}: "
                f"{self.objective}/{self.window} burn {self.burn:.1f}x)")


class ShedPolicy:
    """Multi-window burn rates -> load-shedding decisions.

    ``decide`` looks at the FLEET evaluation first (is any window burning
    past the shed threshold at all?), then attributes: the worker whose
    own histograms show the worst burn is the one acted on. Escalation:
    a burn past ``drain_burn`` — or a shed-to-the-bottom worker (ladder
    rung 2) still burning past ``shed_burn`` — drains; anything else
    past ``shed_burn`` sheds one rung. At most ONE decision per call:
    shedding changes the system, so the next control tick re-measures
    before anything else moves (the router adds a per-worker hold-down
    on top, since burn windows look back past the action)."""

    def __init__(self, shed_burn: Optional[float] = None,
                 drain_burn: Optional[float] = None):
        if shed_burn is None:
            shed_burn = float(os.environ.get(SHED_BURN_ENV,
                                             str(DEFAULT_SHED_BURN)))
        if drain_burn is None:
            drain_burn = float(os.environ.get(DRAIN_BURN_ENV,
                                              str(DEFAULT_DRAIN_BURN)))
        self.shed_burn = shed_burn
        self.drain_burn = max(drain_burn, shed_burn)

    def decide(self, fleet_eval: Dict[str, Dict],
               worker_evals: Dict[str, Dict[str, Dict]],
               rungs: Optional[Dict[str, int]] = None
               ) -> List[ShedDecision]:
        rungs = rungs or {}
        _, _, fleet_rate = worst_burn(fleet_eval)
        if fleet_rate < self.shed_burn:
            return []
        # attribution: the worker whose own burn is worst (ties break by
        # label order — deterministic)
        target, t_obj, t_window, t_rate = None, None, None, 0.0
        for worker, evaluated in sorted(worker_evals.items()):
            obj, window, rate = worst_burn(evaluated)
            if rate > t_rate:
                target, t_obj, t_window, t_rate = worker, obj, window, rate
        if target is None or t_rate < self.shed_burn:
            return []  # fleet-level burn with no attributable worker
        action = ("drain" if t_rate >= self.drain_burn
                  or rungs.get(target, 0) >= 2 else "shed")
        return [ShedDecision(target, action, t_obj, t_window, t_rate)]


# -- process-global tracker ---------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[SloTracker] = None


def global_tracker() -> SloTracker:
    """The process tracker (/healthz evaluates it on every probe; the
    serve/head benches read their ``slo`` sections from it)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = SloTracker()
        return _global


def reset_global() -> None:
    """Fresh tracker + objectives (tests, multi-mode bench runs — also
    re-reads the env overrides)."""
    global _global
    with _global_lock:
        _global = None
