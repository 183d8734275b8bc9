"""The gossip→head latency-plane canary of the port (the counterpart of
consensus_specs_tpu/sim/latency_smoke.py):

    python -m consensus_specs_tpu_torch.sim.latency_smoke

The mirror of ``sim/smoke.py`` for the latency plane: one short
``latency_skew`` scenario (the laggard-node class — maximal deferral
churn per event) runs with the deadline-aware flush scheduler armed (a
shared :class:`~..serve.service.SlotClock`) and speculative head
application on, through the STRICT differential convergence gate — and
then the run must additionally prove the latency plane itself worked:

- the ``latency.gossip_to_head`` histogram is non-empty (every applied
  attestation landed an end-to-end observation);
- the declared ``gossip_to_head_p99`` objective evaluates with ``n > 0``
  and is met (the presence assert — a refactor that silently stops
  feeding the histogram fails HERE, not in a dashboard).

Per-node flight journals always dump to CONSENSUS_SPECS_TPU_SIM_FLIGHT_DIR
(default ``sim_flight/``), so the speculative_apply/rollback/
deadline_flush event stream survives a failure. Every node's service runs
on ``device`` (None: the card) and launches no kernel.

Exit status: 0 on success; 1 with the diagnosis on stderr otherwise.
"""
import os
import sys

from ..obs import latency as obs_latency
from ..obs import slo
from ..ops import profiling
from ..serve.service import SlotClock
from .runner import FLIGHT_DIR_ENV, SEED_ENV, build_world, run_scenario
from .scenarios import get_scenario


def main(device=None) -> int:
    flight_dir = (os.environ.get(FLIGHT_DIR_ENV) or "").strip() \
        or "sim_flight"
    seed = int(os.environ.get(SEED_ENV, "7"))
    profiling.reset()
    obs_latency.reset()
    slo.reset_global()
    spec, anchor_state, anchor_block = build_world()
    report = run_scenario(
        get_scenario("latency_skew"), spec=spec,
        anchor_state=anchor_state, anchor_block=anchor_block,
        seed=seed, strict=False, flight_dir=flight_dir,
        service_kwargs={"max_wait_ms": 25.0, "max_batch": 8,
                        "slot_clock": SlotClock(0.010)},
        head_kwargs={"speculative": True}, device=device)

    evaluated = slo.global_tracker().evaluate(export=False)
    g2h = evaluated.get("gossip_to_head_p99", {})
    per_node = report.per_node or {}
    deadline_flushes = sum(int(v.get("deadline_flushes", 0))
                           for v in per_node.values())
    speculated = sum(int(v.get("speculative_applied", 0))
                     for v in per_node.values())
    print(
        f"latency-smoke: scenario=latency_skew nodes={report.nodes} "
        f"seed={seed} converged={report.converged} "
        f"gossip_to_head_n={g2h.get('n', 0)} "
        f"gossip_to_head_p99={g2h.get('attained_ms', 0.0)}ms "
        f"slo_ok={g2h.get('ok')} deadline_flushes={deadline_flushes} "
        f"speculative_applied={speculated} journals={flight_dir}/"
    )
    if not report.converged:
        print(f"latency-smoke: FAIL — {report.error}", file=sys.stderr)
        return 1
    if g2h.get("n", 0) <= 0:
        print("latency-smoke: FAIL — latency.gossip_to_head recorded no "
              "observations (the end-to-end plane went dark)",
              file=sys.stderr)
        return 1
    if not g2h.get("ok", False):
        print(
            "latency-smoke: FAIL — gossip_to_head_p99 violated: "
            f"{g2h.get('attained_ms')}ms attained vs "
            f"{g2h.get('objective_ms')}ms objective", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
