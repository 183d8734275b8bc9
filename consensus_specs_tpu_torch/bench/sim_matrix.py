"""The scenario-matrix run of the port (the counterpart of
consensus_specs_tpu/bench/sim_matrix.py): ``run_sim_bench(device=None)``.

Drives every named simnet scenario (sim/scenarios.py)
through the deterministic discrete-event runner and reports the matrix:
per-scenario convergence (the differential gate's verdict, non-strict —
a diverging scenario is recorded, the bench line still lands), partition
heal-to-convergence latency, per-node ``get_head`` serving rates, fault
mix, and fabric traffic counters. Per-node flight-recorder journals dump
to ``CONSENSUS_SPECS_TPU_SIM_FLIGHT_DIR`` when set (the CI failure
artifact).

The JSON line's ``value`` is total gossip deliveries/sec of wall time
across the matrix (the throughput of the whole simulated cluster —
every delivery runs the real validate/verify/apply pipeline on its
node); ``vs_baseline`` is the converged share of the matrix (1.0 = every
scenario's gate green — the acceptance bar). The ``sim`` section
(scenario -> converged + heal latency) has the JAX bench's layout. Every
node's service runs on ``device`` (None: the card) and launches no
kernel.

Env knobs: CONSENSUS_SPECS_TPU_SIM_SCENARIOS (csv filter, default all),
CONSENSUS_SPECS_TPU_SIM_NODES (default 4), CONSENSUS_SPECS_TPU_SIM_SEED
(default 7), CONSENSUS_SPECS_TPU_SIM_EVENTS (attestation aggregates per
epoch), CONSENSUS_SPECS_TPU_SIM_FLIGHT_DIR (journal directory).
"""
import os
import time
from typing import Dict, Optional

from ..sim.runner import (
    FLIGHT_DIR_ENV,
    NODES_ENV,
    SCENARIOS_ENV,
    SEED_ENV,
    build_world,
    run_scenario,
)
from ..sim.scenarios import SCENARIOS, get_scenario


def _selected_scenarios():
    raw = (os.environ.get(SCENARIOS_ENV) or "").strip()
    if not raw:
        return list(SCENARIOS.values())
    return [get_scenario(name.strip()) for name in raw.split(",")
            if name.strip()]


def run_sim_bench(device=None) -> dict:
    """Run the matrix; returns the JAX bench's result dict."""
    from ..obs import programs as obs_programs
    from ..ops import profiling

    profiling.reset()
    obs_programs.export_gauges()

    nodes = int(os.environ.get(NODES_ENV, "4"))
    seed = int(os.environ.get(SEED_ENV, "7"))
    flight_dir: Optional[str] = (os.environ.get(FLIGHT_DIR_ENV)
                                 or "").strip() or None
    scenarios = _selected_scenarios()

    spec, anchor_state, anchor_block = build_world()
    matrix: Dict[str, dict] = {}
    sim_section: Dict[str, dict] = {}
    total_deliveries = 0
    total_wall = 0.0
    converged = 0
    t0 = time.perf_counter()
    for scenario in scenarios:
        report = run_scenario(
            scenario, spec=spec, anchor_state=anchor_state,
            anchor_block=anchor_block, seed=seed, nodes=nodes,
            strict=False, flight_dir=flight_dir, device=device)
        entry = report.to_dict()
        matrix[scenario.name] = entry
        sim_section[scenario.name] = {
            "converged": report.converged,
            "heal_to_convergence_s": report.heal_to_convergence_s,
            "nodes": report.nodes,
            "deliveries": report.deliveries,
        }
        total_deliveries += report.deliveries
        total_wall += report.wall_s
        converged += bool(report.converged)
    elapsed = time.perf_counter() - t0

    value = total_deliveries / total_wall if total_wall > 0 else 0.0
    per_mode_best = {
        f"sim[{name}]": round(
            entry["deliveries"] / matrix[name]["wall_s"], 2)
        for name, entry in sim_section.items()
        if matrix[name]["wall_s"] > 0
    }
    result = dict(
        metric="simnet gossip deliveries/sec across the scenario matrix",
        value=round(value, 2),
        # the acceptance bar is the matrix itself: 1.0 == every scenario
        # converged through the differential gate
        vs_baseline=round(converged / len(scenarios), 4) if scenarios else 0.0,
        unit="deliveries/sec",
        mode="sim",
        nodes=nodes,
        seed=seed,
        scenarios=len(scenarios),
        converged=converged,
        diverged=[name for name, e in sim_section.items()
                  if not e["converged"]],
        deliveries=total_deliveries,
        elapsed_s=round(elapsed, 3),
        heads_per_sec_min=min(
            (m["heads_per_sec_min"] for m in matrix.values()), default=0.0),
        sim=sim_section,
        matrix=matrix,
        per_mode_best=per_mode_best,
        profile=profiling.summary(),
    )
    if flight_dir:
        result["flight_dir"] = flight_dir
    return result
