"""The end-to-end gossip→head latency matrix of the port (the counterpart
of consensus_specs_tpu/bench/latency_pipeline.py),
``run_latency_bench(device=None)``: every node's services on ``device``
(None: the CUDA card), crypto-free, no kernel launched.

The ``gossip_to_head_p99`` number is measured ADVERSARIALLY — under
simnet's ``latency_skew`` (one laggard node on ~20x links, heavy deferral
churn) and ``lossy_links`` (15% i.i.d. loss with anti-entropy recovery)
scenarios — and the deadline-aware flush scheduler must lower it against
the classic size-OR-deadline baseline. Each scenario therefore runs three
times through the full per-node HeadService+VerificationService stacks:

- **baseline**: the classic flush rule (``max_wait_ms`` alone bounds the
  batching wait — every lone gossip item eats the full window);
- **deadline**: one shared :class:`~..serve.service.SlotClock` arms the
  slot-budget rule on every node — a flush fires as soon as the most
  urgent queued item's remaining slot budget minus the live downstream
  p99 (``obs/latency.downstream_p99_s``) would otherwise be blown;
- **speculative**: deadline flushing PLUS speculative head application
  (``CONSENSUS_SPECS_TPU_SPECULATE`` semantics): the head reflects a
  batch before its verdicts return, so gossip→head additionally stops
  paying the signature wait; invalid-signature traffic in the scenarios
  exercises the rollback path for real.

The result's ``latency`` section carries one row per scenario — ``ok``
(converged AND the deadline-mode p99 meets the declared
``gossip_to_head_p99`` objective), the three p99s, and the improvement
flag. The ``slo`` section evaluates the declared objective over the EXACT
merge of the deadline-mode histograms (the same merge algebra the fleet
uses).

Env knobs: LATENCY_SCENARIOS (csv, default "latency_skew,lossy_links"),
LATENCY_MAX_WAIT_MS (40), LATENCY_SLOT_MS (20), LATENCY_NODES,
LATENCY_SEED, LATENCY_EVENTS (events/epoch override).
"""
import os
import time
from typing import Dict, Optional

from ..obs import latency as obs_latency
from ..obs import slo
from ..ops import profiling
from ..serve.service import SlotClock
from ..sim.runner import FLIGHT_DIR_ENV, build_world, run_scenario
from ..sim.scenarios import get_scenario

MODES = ("baseline", "deadline", "speculative")


def _run_one(scenario_name: str, mode: str, *, world, seed: int,
             nodes: Optional[int], events: Optional[int],
             wait_ms: float, slot_ms: float,
             flight_dir: Optional[str], device) -> Dict:
    """One (scenario, mode) run from a clean metric slate; returns the
    per-run row plus the detached gossip_to_head histogram snapshot (so
    the caller can merge across runs without re-observing)."""
    spec, anchor_state, anchor_block = world
    profiling.reset()
    obs_latency.reset()

    service_kwargs: Dict = {"max_wait_ms": wait_ms, "max_batch": 8}
    head_kwargs: Dict = {}
    if mode != "baseline":
        # ONE slot grid shared by every node — the network-wide slot
        # boundary a real deployment schedules against
        service_kwargs["slot_clock"] = SlotClock(slot_ms / 1e3)
    if mode == "speculative":
        head_kwargs["speculative"] = True

    t0 = time.perf_counter()
    report = run_scenario(
        get_scenario(scenario_name), spec=spec, anchor_state=anchor_state,
        anchor_block=anchor_block, seed=seed, nodes=nodes,
        events_per_epoch=events, strict=False,
        flight_dir=flight_dir, query_rounds=32,
        service_kwargs=service_kwargs, head_kwargs=head_kwargs,
        device=device)
    wall_s = time.perf_counter() - t0

    hists = profiling.latency_histograms()
    h = hists.get(obs_latency.GOSSIP_TO_HEAD_LABEL)
    summary = h.summary() if h is not None else {}
    per_node = report.per_node or {}
    row = {
        "converged": bool(report.converged),
        "error": report.error,
        "n": int(summary.get("n", 0)),
        "p50_ms": summary.get("p50_ms", 0.0),
        "p99_ms": summary.get("p99_ms", 0.0),
        "max_ms": summary.get("max_ms", 0.0),
        "deadline_flushes": sum(
            int(v.get("deadline_flushes", 0)) for v in per_node.values()),
        "speculative_applied": sum(
            int(v.get("speculative_applied", 0)) for v in per_node.values()),
        "rollbacks": sum(
            int(v.get("rollbacks", 0)) for v in per_node.values()),
        "applied": sum(int(v.get("applied", 0)) for v in per_node.values()),
        "wall_s": round(wall_s, 3),
    }
    return {"row": row, "hist": h}


def run_latency_bench(device=None) -> dict:
    """The scenario × flush-policy matrix on ``device`` (None: the CUDA
    card); returns the JAX bench's result dict."""
    from ..device import resolve_device
    from ..obs import programs as obs_programs

    device = resolve_device(device)
    profiling.reset()
    obs_programs.export_gauges()
    slo.reset_global()

    scenario_names = [
        tok.strip() for tok in os.environ.get(
            "LATENCY_SCENARIOS", "latency_skew,lossy_links").split(",")
        if tok.strip()
    ]
    wait_ms = float(os.environ.get("LATENCY_MAX_WAIT_MS", "40"))
    slot_ms = float(os.environ.get("LATENCY_SLOT_MS", "20"))
    nodes = int(os.environ.get("LATENCY_NODES", "0")) or None
    seed = int(os.environ.get("LATENCY_SEED", "7"))
    events = int(os.environ.get("LATENCY_EVENTS", "0")) or None
    flight_dir = (os.environ.get(FLIGHT_DIR_ENV) or "").strip() or None

    objective_ms = next(
        (obj["threshold_s"] * 1e3 for obj in slo.declared_objectives()
         if obj["name"] == "gossip_to_head_p99"), 1_000.0)

    world = build_world()
    detail: Dict[str, Dict] = {}
    section: Dict[str, Dict] = {}
    deadline_hists = []
    for name in scenario_names:
        rows = {}
        for mode in MODES:
            out = _run_one(name, mode, world=world, seed=seed, nodes=nodes,
                           events=events, wait_ms=wait_ms, slot_ms=slot_ms,
                           flight_dir=flight_dir, device=device)
            rows[mode] = out["row"]
            if mode == "deadline" and out["hist"] is not None:
                deadline_hists.append(out["hist"])
        detail[name] = rows
        base, dl, spec_row = (rows["baseline"], rows["deadline"],
                              rows["speculative"])
        section[name] = {
            # the gated state: the scenario converged under every flush
            # policy, the end-to-end histogram actually filled, and the
            # deadline-mode p99 meets the declared per-slot objective
            "ok": bool(
                all(r["converged"] for r in rows.values())
                and dl["n"] > 0
                and dl["p99_ms"] <= objective_ms),
            "converged": bool(all(r["converged"] for r in rows.values())),
            "n": dl["n"],
            "p99_ms": dl["p99_ms"],
            "baseline_p99_ms": base["p99_ms"],
            "speculative_p99_ms": spec_row["p99_ms"],
            "improved": bool(dl["p99_ms"] < base["p99_ms"]),
            "deadline_flushes": dl["deadline_flushes"],
            "rollbacks": spec_row["rollbacks"],
        }

    # the declared-objective evaluation over the EXACT merge of the
    # deadline-mode histograms (the fleet merge algebra: bucket mass sums)
    merged = None
    for h in deadline_hists:
        merged = h if merged is None else merged.merge(h)
    slo_section: Dict[str, Dict] = {}
    if merged is not None:
        tracker = slo.SloTracker([
            obj for obj in slo.declared_objectives()
            if obj["name"] == "gossip_to_head_p99"])
        evaluated = tracker.evaluate(
            hists={obs_latency.GOSSIP_TO_HEAD_LABEL: merged}, export=False)
        for obj_name, e in evaluated.items():
            row = {"ok": bool(e["ok"]), "n": e["n"],
                   "objective_ms": e["objective_ms"],
                   "attained_ms": e["attained_ms"],
                   "burn_rate": e["burn_rate"]}
            if "margin" in e:
                row["margin"] = e["margin"]
            slo_section[obj_name] = row

    # the worst scenario BY DEADLINE p99, and that same scenario's
    # baseline — both numbers must come from one scenario or the ratio
    # can pair scenario A's baseline with scenario B's deadline tail
    worst_row = max(
        (row for row in section.values() if row["n"]),
        key=lambda row: row["p99_ms"], default=None)
    worst_deadline = worst_row["p99_ms"] if worst_row else 0.0
    worst_baseline = worst_row["baseline_p99_ms"] if worst_row else 0.0
    value = 1e3 / worst_deadline if worst_deadline > 0 else 0.0
    return dict(
        metric="worst-scenario gossip→head p99 under deadline-aware "
               "flushing, as 1/p99 (latency pipeline)",
        value=round(value, 2),
        # the deadline-flush win itself: baseline p99 over deadline p99
        # at the worst scenario (> 1 == the scheduler lowered the tail)
        vs_baseline=round(worst_baseline / worst_deadline, 4)
        if worst_deadline > 0 else 0.0,
        unit="1/s",
        platform=device.type,
        mode="latency",
        scenarios=scenario_names,
        max_wait_ms=wait_ms,
        slot_ms=slot_ms,
        objective_ms=objective_ms,
        worst_deadline_p99_ms=round(worst_deadline, 3),
        worst_baseline_p99_ms=round(worst_baseline, 3),
        latency=section,
        latency_detail=detail,
        slo=slo_section,
    )
