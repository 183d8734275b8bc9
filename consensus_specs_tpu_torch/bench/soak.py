"""The long-horizon telemetry soak of the port (the counterpart of
consensus_specs_tpu/bench/soak.py), ``run_soak_bench(device=None)``: the
nodes' services and the verdict-mode fleet workers on ``device`` (None:
the CUDA card), crypto-free, no kernel launched.

Every bench so far measures minutes of behavior; the failure modes the
telemetry plane exists for — participation decay, finality-lag growth,
deferral-buffer creep, reorg churn — only show up over HOURS of slots.
This mode runs a thousand-plus-slot simnet scenario against the REAL
fleet deployment shape (`sim/fleet_replay.py` wiring: every node's
signature checks cross a process boundary to verdict-mode workers) and
records the whole telemetry plane while it runs:

- a per-node `chain/health.py` ledger observes every simulated slot past
  a short warm-up (the runner's ``slot_hook`` fires once per crossed
  slot boundary, quiet stretches included);
- a sim-clock `obs/timeseries.py` store samples the live gauge surface
  (the ``health[<node>].*`` family among them) once per slot at base
  resolution, downsampling into the coarser rings exactly as the
  wall-clock stores do;
- the workers' own wall-clock TSDBs and span rings ship home through
  the snapshot protocol and merge in the router's aggregator — the
  stitched Chrome trace at the end carries spans from every worker pid
  joined to router-side flows by matching flow ids.

The health verdict is `chain/health.evaluate_gate` over the worst-case
aggregate across nodes. One honesty note on the
finality bound: the simnet imports blocks by crafted-state ingress
(`import_block_unchecked` — no per-block state transitions), so the
finalized checkpoint stays at the genesis anchor and the lag grows one
slot per slot BY CONSTRUCTION. The bound passed here is therefore the
horizon itself: it asserts the lag never exceeds the clock (monotone,
rate <= 1 slot/slot — a regression or clock runaway still fails), while
participation and unexplained reorgs are the live gates. The soak
scenario keeps the canonical chain linear (``fork_rate=0``) so "zero
unexplained reorgs" is a REAL claim: any reorg in a fork-free run is a
fork-choice bug, not noise.

Scheduling honors the scenario library's invariant: every periodic
partition forms early in epoch ``e`` and heals early in epoch ``e+1``,
so no node ever ages an aggregate past the fork-choice's two-epoch
acceptance window.

Env knobs: CONSENSUS_SPECS_TPU_SOAK_EPOCHS (default 128 — 1023 slots on
the minimal preset's 8-slot epochs; ``sim/soak_smoke.py`` sets 26),
CONSENSUS_SPECS_TPU_SOAK_WORKERS (default 2),
CONSENSUS_SPECS_TPU_SOAK_DIR (artifact directory, default
``soak_artifacts``), plus the simnet's NODES/SEED envs.
"""
import json
import os
import sys
import time
from dataclasses import replace
from typing import Dict, List, Optional

from ..chain import health
from ..obs import timeseries, tracing
from ..sim.fabric import PartitionWindow
from ..sim.fleet_replay import FleetVerdictBackend
from ..sim.runner import NODES_ENV, SEED_ENV, build_world, run_scenario
from ..sim.scenarios import get_scenario

EPOCHS_ENV = "CONSENSUS_SPECS_TPU_SOAK_EPOCHS"
WORKERS_ENV = "CONSENSUS_SPECS_TPU_SOAK_WORKERS"
DIR_ENV = "CONSENSUS_SPECS_TPU_SOAK_DIR"

# health rows start after the vote tables warm up: proto-array
# participation counts validators with a latest message, which takes the
# first committees a couple of epochs to cover — gating those ramp slots
# would fail every run on an artifact of "the chain just started"
WARMUP_EPOCHS = 2


def soak_scenario(epochs: int, *, nodes: int = 4,
                  slots_per_epoch: int = 8):
    """The long-horizon scenario: `partition_heal`'s shape repeated.

    A two-way split forms early in epoch ``e`` and heals early in epoch
    ``e+1`` every eighth epoch (first at epoch 3, past the warm-up), on
    top of a steady 5% invalid-signature and 5% censored-aggregate diet.
    ``fork_rate=0`` keeps the canonical chain linear — see the module
    docstring for why that makes the zero-reorg gate meaningful."""
    spe = int(slots_per_epoch)
    half = nodes // 2
    windows = tuple(
        PartitionWindow(
            form_slot=float(e * spe + 2),
            heal_slot=float((e + 1) * spe + 1),
            groups=(tuple(range(half)), tuple(range(half, nodes))),
        )
        for e in range(3, epochs - 1, 8)
    )
    base = get_scenario("partition_heal")
    return replace(
        base,
        name="telemetry_soak",
        description="long-horizon soak: periodic two-way partitions over "
                    "a linear canonical chain with invalid and censored "
                    "aggregates; the health ledger observes every slot",
        nodes=nodes,
        epochs=int(epochs),
        fork_rate=0.0,
        partitions=windows,
        invalid_rate=0.05,
        censor_rate=0.05,
    )


def _trace_join_stats(path: str) -> Dict:
    """Read the stitched Chrome trace back and count the acceptance
    evidence: worker pids carrying spans, and flow ids that appear both
    as a worker-side START ("s" on a worker pid) and a router-side
    FINISH ("f")."""
    with open(path) as f:
        doc = json.load(f)
    worker_pids = set()
    starts_by_pid: Dict[int, set] = {}
    finishes = set()
    for ev in doc.get("traceEvents", ()):
        pid = int(ev.get("pid", 0))
        if pid >= tracing.WORKER_PID_BASE and ev.get("ph") == "X":
            worker_pids.add(pid)
        if ev.get("ph") == "s":
            starts_by_pid.setdefault(pid, set()).add(int(ev["id"]))
        elif ev.get("ph") == "f":
            finishes.add(int(ev["id"]))
    worker_starts = set()
    for pid, ids in starts_by_pid.items():
        if pid >= tracing.WORKER_PID_BASE:
            worker_starts |= ids
    return {
        "worker_pids": sorted(worker_pids),
        "worker_flow_starts": len(worker_starts),
        "flow_joins": len(worker_starts & finishes),
    }


def run_soak_bench(epochs: Optional[int] = None,
                   workers: Optional[int] = None, device=None) -> dict:
    """Run the soak on ``device`` (None: the CUDA card); returns the JAX
    bench's result dict."""
    from ..device import resolve_device
    from ..obs import programs as obs_programs
    from ..ops import profiling
    from ..serve.fleet import FleetRouter

    device = resolve_device(device)
    # the telemetry plane under test must be ON: the TSDB env arms the
    # worker samplers (inherited through spawn), the trace env arms the
    # node-side and worker-side tracers whose spans the stitch joins
    os.environ.setdefault(timeseries.TS_ENV, "1")
    os.environ.setdefault(tracing.TRACE_ENV, "1")
    profiling.reset()
    obs_programs.export_gauges()

    epochs = int(os.environ.get(EPOCHS_ENV, "128") if epochs is None
                 else epochs)
    workers = int(os.environ.get(WORKERS_ENV, "2") if workers is None
                  else workers)
    nodes = int(os.environ.get(NODES_ENV, "4"))
    seed = int(os.environ.get(SEED_ENV, "7"))
    out_dir = (os.environ.get(DIR_ENV) or "soak_artifacts").strip()
    os.makedirs(out_dir, exist_ok=True)

    spec, anchor_state, anchor_block = build_world()
    sps = int(spec.config.SECONDS_PER_SLOT)
    spe = int(spec.SLOTS_PER_EPOCH)
    scenario = soak_scenario(epochs, nodes=nodes, slots_per_epoch=spe)
    total_slots = spe * epochs - 1
    warmup_slots = WARMUP_EPOCHS * spe
    # the spec's fork choice (`filter_block_tree`, `get_ancestor`) recurses
    # once per block of tree depth, and the simnet anchors finality at
    # genesis so the store never prunes: by the end of the horizon the
    # tree is `total_slots` deep and the interpreter's default 1000-frame
    # limit dies mid-soak. ~3 frames per recursion level (call + the two
    # comprehensions), plus headroom for the caller stack.
    needed = 4 * (total_slots + 4 * spe) + 2000
    if sys.getrecursionlimit() < needed:
        sys.setrecursionlimit(needed)
    disruption = [(w.form_slot, w.heal_slot + 2.0)
                  for w in scenario.partitions]

    # the health time series lives on the SIMULATED clock: one base
    # sample per slot (interval = the slot time), capacity sized so the
    # whole horizon is retained at base resolution — the soak artifact
    # is the full history, not the trailing window
    store = timeseries.TimeSeriesStore(
        interval_s=float(sps), capacity=total_slots + 256)
    ledgers: Dict[str, health.HealthLedger] = {}
    hook_slots = [0]

    def slot_hook(slot: int, sim_nodes: List) -> None:
        hook_slots[0] = slot
        if not ledgers:
            for node in sim_nodes:
                ledgers[node.name] = health.HealthLedger(
                    node.head, node=node.name)
        if slot > warmup_slots:
            expect = any(a <= slot <= b for a, b in disruption)
            for node in sim_nodes:
                ledgers[node.name].observe_slot(
                    slot=slot, expect_reorgs=expect)
        store.export_gauges()
        store.sample(now=float(slot) * sps)

    router = FleetRouter(
        workers=workers, backend="verdict", device=device,
        env={"SERVE_MAX_WAIT_MS": "2",
             timeseries.TS_ENV: "1",
             tracing.TRACE_ENV: "1"})
    t0 = time.perf_counter()
    try:
        report = run_scenario(
            scenario, spec=spec, anchor_state=anchor_state,
            anchor_block=anchor_block, seed=seed, nodes=nodes,
            strict=False,
            backend_factory=lambda name: FleetVerdictBackend(router, name),
            slot_hook=slot_hook, device=device)
        snaps = router.poll_snapshots()
        per_worker = {
            label: {
                "pid": snap.get("pid"),
                "submits": snap["extra"]["serve"]["submits"],
                "cache_hits": snap["extra"]["serve"]["cache_hits"],
                "batches": snap["extra"]["serve"]["batches"],
            }
            for label, snap in sorted(snaps.items())
        }
        trace_path = os.path.join(out_dir, "soak_trace.json")
        router.dump_trace(trace_path)
        fleet_ts_path = os.path.join(out_dir, "fleet_timeseries.json")
        with open(fleet_ts_path, "w") as f:
            json.dump(router.timeseries_doc(), f, sort_keys=True)
    finally:
        router.close()
    wall_s = time.perf_counter() - t0

    ts_path = os.path.join(out_dir, "soak_timeseries.jsonl")
    store.dump_jsonl(ts_path)
    joins = _trace_join_stats(trace_path)

    per_node = {name: led.summary() for name, led in sorted(ledgers.items())}
    aggregate = health.aggregate_summaries(list(per_node.values()))
    gate = health.evaluate_gate(
        aggregate,
        participation_floor=health.DEFAULT_PARTICIPATION_FLOOR,
        # see the module docstring: the simnet anchors finality at
        # genesis, so the bound is the horizon — lag must never exceed
        # the clock (the final ticks run the hook a few slots past the
        # last scripted slot, hence the epoch of margin)
        finality_lag_max_slots=total_slots + 4 * spe,
        max_unexplained_reorgs=0)

    slots = hook_slots[0]
    value = slots / wall_s if wall_s > 0 else 0.0
    return dict(
        metric="simulated slots soaked per second of wall time "
               "(health ledger + TSDB sampling every slot, fleet-routed "
               "verification)",
        value=round(value, 2),
        # the acceptance bar: 1.0 == the health gate held over the whole
        # horizon on every node
        vs_baseline=1.0 if gate["ok"] else 0.0,
        unit="slots/sec",
        mode="soak",
        platform=device.type,
        nodes=nodes,
        seed=seed,
        epochs=epochs,
        slots=slots,
        warmup_slots=warmup_slots,
        converged=report.converged,
        deliveries=report.deliveries,
        elapsed_s=round(wall_s, 3),
        health=dict(
            gate=gate,
            aggregate=aggregate,
            per_node=per_node,
            slots_observed=aggregate["slots_observed"],
            warmup_slots=warmup_slots,
        ),
        soak=dict(
            scenario=scenario.name,
            partitions=len(scenario.partitions),
            timeseries=dict(
                samples=store.samples,
                evicted=store.evicted,
                interval_s=float(sps),
                path=ts_path,
            ),
            trace=dict(path=trace_path, **joins),
            fleet_timeseries_path=fleet_ts_path,
            fleet=dict(
                workers=sorted(snaps),
                routed=router.requests,
                per_worker=per_worker,
            ),
        ),
        per_mode_best={"soak[slots]": float(slots)},
        profile=profiling.summary(),
    )
