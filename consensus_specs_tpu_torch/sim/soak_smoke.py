"""The telemetry-plane canary of the port (the counterpart of
consensus_specs_tpu/sim/soak_smoke.py), ``main(device=None)``.

The full soak (``python -m consensus_specs_tpu_torch.bench --mode soak``)
runs 128 epochs; this runs the SAME pipeline at 26 epochs (~200 slots)
on ``device`` (None: the CUDA card) and turns its claims into an exit
status:

- the consensus health gate (participation floor, bounded finality lag,
  zero unexplained reorgs) must be green over the whole horizon;
- the scenario must converge through the differential gate;
- the stitched Chrome trace must carry spans from at least two worker
  pids joined to router-side flows by matching flow ids (the
  cross-process stitching claim, checked on live output);
- the sim-clock TSDB must have recorded at least one sample per
  observed slot.

Artifacts (timeseries JSONL, stitched trace, merged fleet timeseries)
land in CONSENSUS_SPECS_TPU_SOAK_DIR (default ``soak_artifacts/``), so a
red gate ships its own post-mortem. Exit status: 0 when every claim
holds, 1 with the diagnosis on stderr otherwise.
"""
import json
import os
import sys

from ..bench.soak import EPOCHS_ENV, run_soak_bench


def main(device=None) -> int:
    epochs = int(os.environ.get(EPOCHS_ENV, "26"))
    result = run_soak_bench(epochs=epochs, device=device)
    health = result["health"]
    gate = health["gate"]
    trace = result["soak"]["trace"]
    ts = result["soak"]["timeseries"]
    print(
        f"soak-smoke: epochs={epochs} slots={result['slots']} "
        f"observed={health['slots_observed']} "
        f"converged={result['converged']} gate_ok={gate['ok']} "
        f"participation_min={gate['summary']['participation_min']} "
        f"unexplained_reorgs={gate['summary']['unexplained_reorgs']} "
        f"worker_pids={trace['worker_pids']} "
        f"flow_joins={trace['flow_joins']} "
        f"ts_samples={ts['samples']} artifacts={ts['path']}"
    )
    failures = []
    if not gate["ok"]:
        failures.append("health gate diverged: "
                        + "; ".join(gate["reasons"]))
    if not result["converged"]:
        failures.append("scenario did not converge")
    if len(trace["worker_pids"]) < 2:
        failures.append(
            f"stitched trace carries spans from "
            f"{len(trace['worker_pids'])} worker pid(s), need >= 2")
    if trace["flow_joins"] <= 0:
        failures.append("no worker flow start matched a router-side "
                        "flow finish")
    if ts["samples"] < result["slots"]:
        failures.append(
            f"TSDB recorded {ts['samples']} samples for "
            f"{result['slots']} slots")
    if failures:
        print("soak-smoke: FAIL — " + " | ".join(failures),
              file=sys.stderr)
        print(json.dumps(health, sort_keys=True), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
