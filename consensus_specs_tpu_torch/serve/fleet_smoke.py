"""Fleet control-plane canary of the port (the counterpart of
consensus_specs_tpu/serve/fleet_smoke.py):

    python -m consensus_specs_tpu_torch.serve.fleet_smoke

Two phases, both against a REAL 2-worker fleet (``serve/worker.py``
processes, the port's bls backend on the card):

1. **Verdict identity**: a batch exercising every input class (valid
   committees, a corrupted message (RLC bisection), a malformed
   signature, an infinity pubkey) submitted through the fleet router
   must answer bit-identically to (a) a single-process
   ``VerificationService`` over the same backend and (b) the pure-Python
   host oracle. The merged ``/metrics`` scrape must hold every
   observation. Every worker's snapshot must report the router's device;
   on the card, its name and at least one launch of each kernel (the
   step kernel and the Montgomery kernel): the kernels ran in the
   workers and nothing fell back.

2. **Forced worker fault -> SLO-burn-driven decision**: one worker's
   backend is armed to fail, distinct committees routed to THAT worker
   are pushed through it (every flush degrades down the ladder to the
   sequential oracle: slow but correct), and the router's control loop
   must reach a shed or drain decision from the burn rates on the MERGED
   histograms. The merged flight journal must reconstruct it: the fleet
   decision event (worker provenance, burn evidence), the worker's own
   ``shed_rung`` transition (for a shed) and its degradation events, and
   a merged-scrape delta (``fleet.sheds`` / ``fleet.drains`` moved,
   merged observation counts grew).

Between the two, every worker must report background warming of the
fused VM lowering armed (``extra["warm_bg"]``), as the JAX smoke gates.
The merged journal dumps to ``fleet_flight.jsonl``. Exit 0 on pass, 1 with a diagnosis.
"""
import json
import os
import sys
import time

WORKERS = 2
JOURNAL_PATH = "fleet_flight.jsonl"
# the smoke's objective: tight enough that the fault phase's degradation
# cascade (two failed RLC attempts, two failed group attempts, then the
# sequential pure-Python oracle at seconds an item) blows it
# deterministically. Phase 1's latencies are baselined out by the
# post-identity control tick, and the burn windows diff against that
# checkpoint, so only fault-phase mass can burn.
SLO_OVERRIDE = "serve_p99_ms=500"
_DEGRADED = ("backend_retry", "degraded_rlc_to_groups", "degraded_to_oracle",
             "device_stage_error", "prep_error")


def _scrape_gauge(text: str, name: str) -> float:
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _scrape_hist_count(text: str) -> int:
    fam = ("consensus_specs_tpu_serve_submit_to_result_"
           "latency_hist_seconds_count")
    return int(_scrape_gauge(text, fam))


def check_worker_devices(snaps, device) -> None:
    """Every worker runs on the router's device; on the card each names
    the card and has launched both kernels at least once."""
    for label, snap in sorted(snaps.items()):
        extra = snap.get("extra", {})
        assert extra.get("device") == device.type, (
            f"worker {label} resolved {extra.get('device')!r}, the fleet "
            f"runs on {device.type!r}")
        if device.type == "cuda":
            kernels = extra.get("kernels", {})
            assert extra.get("device_name"), f"worker {label}: no card name"
            assert kernels.get("vm_step", 0) > 0 and \
                kernels.get("mont_mul", 0) > 0, (
                    f"worker {label} launched no kernel of a path that "
                    f"needs both: {kernels}")


def committee(tag, k=1, good=True):
    """A fast-aggregate check of ``k`` fresh keys over one message
    (``good=False``: the message is corrupted after signing)."""
    from ..utils import bls
    from ..utils.bls12_381 import R

    sks = [7000 * tag + j + 1 for j in range(k)]
    pks = [bls.SkToPk(sk) for sk in sks]
    msg = (b"flt%03d" % tag) + b"\x00" * 26
    sig = bls.Sign(sum(sks) % R, msg)
    if not good:
        msg = b"\xff" + msg[1:]
    return ("fast_aggregate", pks, msg, sig)


def identity_items():
    """(items, verdicts): every input class of phase 1."""
    from ..utils import bls

    items = [
        committee(1, k=2),
        committee(2),
        committee(3, good=False),                      # corrupted: bisection
        ("fast_aggregate", [bls.SkToPk(7)], b"m" * 32,
         b"\xa0" + b"\x01" * 95),                      # undecodable signature
        ("fast_aggregate", [b"\xc0" + b"\x00" * 47],
         b"p" * 32, bls.Sign(9, b"p" * 32)),           # infinity pubkey
    ]
    return items, [True, True, False, False, False]


def fault_decision(router, n_items: int = 5, first_tag: int = 100) -> dict:
    """Phase 2 on a live ``router`` whose burn windows the caller has
    baselined (one ``control_tick`` after any traffic that must not
    burn): ``n_items`` distinct valid committees that consistent-hash to
    ONE worker, that worker's backend armed to fail, every verdict still
    right (through the oracle), then control ticks until a shed or drain
    decision, which must name that worker and reconstruct from the merged
    journal and scrape. Returns the decision, its journal and the scrape
    counts; raises AssertionError otherwise."""
    from .cache import check_key

    before = router.scrape_text()
    n_before = _scrape_hist_count(before)
    acts_before = (_scrape_gauge(before, "consensus_specs_tpu_fleet_sheds")
                   + _scrape_gauge(before, "consensus_specs_tpu_fleet_drains"))
    target, fault_items, tag = None, [], first_tag
    while len(fault_items) < n_items and tag < first_tag + 300:
        it = committee(tag, k=1)
        label = router.route_label(check_key(*it))
        if target is None:
            target = label
        if label == target:
            fault_items.append(it)
        tag += 1
    assert len(fault_items) >= n_items, "could not craft affine fault traffic"
    router.handle(target).inject_fault(calls=64, mode="fail")

    fault_futs = [router.submit(*it) for it in fault_items]
    got_fault = [bool(f.result(timeout=600)) for f in fault_futs]
    assert all(got_fault), (
        f"fault-phase verdicts wrong (oracle fallback must stay "
        f"correct): {got_fault}")

    time.sleep(1.1)  # burn-tracker checkpoint spacing
    decisions = []
    for _ in range(20):
        decisions = router.control_tick()["decisions"]
        if decisions:
            break
        time.sleep(0.5)
    assert decisions, (
        "no shed/drain decision: the burn on the merged histograms "
        f"never crossed the policy ({router.healthz()['slo']})")
    assert decisions[0]["worker"] == target, (
        f"decision hit {decisions[0]['worker']}, the fault was on {target}")

    # -- reconstruction from the merged journal ---------------------------
    router.poll_snapshots()  # absorb the worker's post-shed journal
    journal = router.journal_jsonl(reason="fleet_smoke")
    events = [json.loads(line) for line in journal.splitlines()[1:]]
    fleet_decisions = [e for e in events if e["plane"] == "fleet"
                       and e["kind"] in ("shed", "drain")]
    assert fleet_decisions, "decision missing from the merged journal"
    devt = fleet_decisions[-1]
    assert devt["data"].get("worker") == target
    assert devt["data"].get("burn", 0) > 0
    if devt["kind"] == "shed":
        transitions = [e for e in events if e["kind"] == "shed_rung"
                       and e.get("worker") == target]
        assert transitions, (
            "worker ladder transition missing from the merged journal")
    ladder_evidence = [e for e in events if e.get("worker") == target
                       and e["kind"].startswith("degraded")]
    assert ladder_evidence, (
        "the faulted worker's own degradation events missing from the "
        "merged journal")

    # -- merged-scrape delta ----------------------------------------------
    after = router.scrape_text()
    n_after = _scrape_hist_count(after)
    acts_after = (_scrape_gauge(after, "consensus_specs_tpu_fleet_sheds")
                  + _scrape_gauge(after, "consensus_specs_tpu_fleet_drains"))
    assert n_after >= n_before + len(fault_items), (
        f"merged scrape missed the fault traffic: {n_before} -> {n_after}")
    assert acts_after > acts_before, (
        "fleet.sheds/fleet.drains did not move on the merged scrape")
    return {"target": target, "decision": devt["kind"],
            "burn": devt["data"].get("burn"),
            "objective": devt["data"].get("objective"),
            "window": devt["data"].get("window"),
            "fault_items": len(fault_items),
            "ladder_events": len(ladder_evidence),
            "scrape_observations": [n_before, n_after],
            "journal": journal, "events": events}


def run(device=None, report=None) -> dict:
    """Both phases on ``device`` (None: the card). Returns the pass record;
    raises AssertionError (or the worker's error) on any failure. When
    ``report`` is a dict it receives each worker's last snapshot
    (``snapshots``)."""
    os.environ["CONSENSUS_SPECS_TPU_FLIGHT"] = "1"
    os.environ.setdefault("CONSENSUS_SPECS_TPU_FLIGHT_DUMP", JOURNAL_PATH)
    os.environ.setdefault("CONSENSUS_SPECS_TPU_SLO", SLO_OVERRIDE)

    from ..obs.slo import ShedPolicy
    from ..utils import bls
    from .fleet import FleetRouter
    from .service import VerificationService

    items, want = identity_items()
    report = {} if report is None else report

    # host-oracle truth (the reference's exception-swallowing rules)
    oracle = [bls.oracle_fast_aggregate_verify(*it[1:]) for it in items]
    assert oracle == want, (
        f"oracle drifted from the pinned pattern: {oracle} != {want}")

    router = FleetRouter(
        workers=WORKERS, backend="bls", device=device,
        env={"SERVE_MAX_WAIT_MS": "300",
             "CONSENSUS_SPECS_TPU_FLIGHT": "1",
             "CONSENSUS_SPECS_TPU_SLO": os.environ["CONSENSUS_SPECS_TPU_SLO"]},
        policy=ShedPolicy(),  # stock thresholds: shed 4x, drain 32x
    )
    try:
        # -- phase 1: verdict identity ------------------------------------
        fleet_futs = [router.submit(*it) for it in items]
        got_fleet = [bool(f.result(timeout=600)) for f in fleet_futs]

        svc = VerificationService(device=router.device, max_wait_ms=300.0)
        try:
            single_futs = [svc.submit(*it) for it in items]
            got_single = [bool(f.result(timeout=600)) for f in single_futs]
        finally:
            svc.close(timeout=60)
        assert got_fleet == got_single == oracle == want, (
            f"verdict identity violated: fleet={got_fleet} "
            f"single={got_single} oracle={oracle} want={want}")

        snaps = router.poll_snapshots()
        report["snapshots"] = snaps
        assert len(snaps) == WORKERS, f"snapshots from {sorted(snaps)}"
        check_worker_devices(snaps, router.device)
        degraded = [e for e in router.aggregator.journal_events()
                    if e["kind"] in _DEGRADED]
        assert not degraded, f"phase 1 degraded: {degraded[:3]}"
        # background warming armed on every worker: a fresh process builds
        # a measured-faster fused signature off the serving path
        warm_flags = {label: snap.get("extra", {}).get("warm_bg")
                      for label, snap in snaps.items()}
        assert all(warm_flags.values()), (
            f"background VM warming not armed on every worker: "
            f"{warm_flags}")

        # baseline: merge the identity-phase state and checkpoint the
        # burn windows: only fault-phase mass can burn from here
        router.control_tick()
        n_items = _scrape_hist_count(router.scrape_text())
        assert n_items >= len(items), (
            f"merged scrape lost observations: {n_items} < {len(items)}")

        # -- phase 2: forced worker fault -> burn -> decision -------------
        fault = fault_decision(router)
        report["snapshots"] = {
            label: router.aggregator.worker_snapshot(label)
            for label in router.aggregator.workers}
        with open(JOURNAL_PATH, "w") as fh:
            fh.write(fault["journal"])
        return {"workers": WORKERS, "device": router.device.type,
                "verdicts": got_fleet, "fault_worker": fault["target"],
                "decision": fault["decision"], "burn": fault["burn"],
                "objective": fault["objective"], "window": fault["window"],
                "scrape_observations": fault["scrape_observations"],
                "journal_events": len(fault["events"]),
                "journal": JOURNAL_PATH}
    except BaseException:
        try:
            with open(JOURNAL_PATH, "w") as fh:
                fh.write(router.journal_jsonl(reason="fleet_smoke_fail"))
        except OSError:
            pass
        raise
    finally:
        router.close()


def main(device=None, report=None) -> int:
    try:
        res = run(device=device, report=report)
    except Exception as e:  # noqa: BLE001 - the smoke's diagnosis
        print(f"fleet-smoke FAIL: {type(e).__name__}: {e}")
        return 1
    print(f"fleet-smoke OK: {res['workers']} workers on {res['device']}, "
          f"verdicts == single-process == oracle, fault on "
          f"{res['fault_worker']} -> {res['decision']} (burn "
          f"{res['burn']:.1f}x {res['objective']}/{res['window']}), merged "
          f"scrape {res['scrape_observations'][0]} -> "
          f"{res['scrape_observations'][1]} observations, journal "
          f"{res['journal']} ({res['journal_events']} events)")
    if report is not None:
        report["result"] = res
    return 0


if __name__ == "__main__":
    sys.exit(main())
