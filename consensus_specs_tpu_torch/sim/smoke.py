"""The simnet's convergence canary of the port (the counterpart of
consensus_specs_tpu/sim/smoke.py):

    python -m consensus_specs_tpu_torch.sim.smoke

One small 4-node partition-and-heal scenario through the strict
differential gate, every node's service on ``device`` (None: the card).
Per-node flight journals always dump to CONSENSUS_SPECS_TPU_SIM_FLIGHT_DIR
(default ``sim_flight/``), so the post-mortem (every node's block
arrivals, deferrals, drops, on the simulated clock) exists without a
rerun.

Exit status: 0 on convergence, 1 with the divergence diagnosis on
stderr otherwise.
"""
import os
import sys

from .runner import FLIGHT_DIR_ENV, SEED_ENV, build_world, run_scenario
from .scenarios import get_scenario


def main(device=None, report=None) -> int:
    """The canary on ``device``; ``report`` (a dict) receives the
    ``ScenarioReport`` (``scenario``)."""
    flight_dir = (os.environ.get(FLIGHT_DIR_ENV) or "").strip() \
        or "sim_flight"
    seed = int(os.environ.get(SEED_ENV, "7"))
    spec, anchor_state, anchor_block = build_world()
    run = run_scenario(
        get_scenario("partition_heal"), spec=spec,
        anchor_state=anchor_state, anchor_block=anchor_block,
        seed=seed, strict=False, flight_dir=flight_dir, device=device)
    if report is not None:
        report["scenario"] = run
    print(
        f"sim-smoke: scenario=partition_heal nodes={run.nodes} "
        f"seed={seed} converged={run.converged} "
        f"heal_to_convergence={run.heal_to_convergence_s}s "
        f"deliveries={run.deliveries} "
        f"diverged_samples={run.diverged_samples} "
        f"journals={flight_dir}/"
    )
    if not run.converged:
        print(f"sim-smoke: FAIL — {run.error}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
