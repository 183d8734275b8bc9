"""The multi-process fleet scaling sweep of the port (the counterpart of
consensus_specs_tpu/bench/fleet_sweep.py), ``run_fleet_bench(device=None)``.

One measurement per worker count: spawn a real `serve/fleet.FleetRouter`
fleet (bls backend — real pairings in every worker process, each worker
its own CUDA context on ``device``, None: the card), warm each
worker's flush shapes OUTSIDE the timed window (the parent knows the
consistent-hash routing, so it warms each worker at exactly the flush
sizes its share of the stream will produce), then push ``rounds`` bursts
of distinct committee aggregates through the router and measure
aggregate verified signatures/sec across the fleet.

The result's ``fleet`` section carries one row per worker count:
``sigs_per_sec``, per-worker submit splits and kernel launches (each
worker's own counts, from its snapshot), the merged p99, and
``merge_exact`` — the acceptance property that the merged ``/metrics``
scrape equals the exact merge of the per-worker snapshots (observation
counts sum, per-bucket mass sums; verified here against both the decoded
wire snapshots and the rendered Prometheus text). ``bars`` pre-evaluates
the acceptance checks: two workers >= 1.2x one worker, and every gated
count merge-exact with correct verdicts; sigs/sec and the speedup are
report-only numbers.

Env: SERVE_FLEET_WORKERS ("1,2,4"), SERVE_FLEET_COMMITTEES (32),
SERVE_FLEET_K (8), SERVE_FLEET_ROUNDS (2), SERVE_FLEET_TIMEOUT (s per
fleet, 900).
"""
import os
import threading
import time
from typing import Dict, List

from ..serve.cache import check_key
from ..serve.worker import _warm_committees

# north-star share, same constant as the other serve benches
TARGET_PER_CHIP = 150_000 / 8


def _round_traffic(committees: int, k: int, rounds: int):
    """Per-round distinct valid committees (content disjoint across
    rounds so no cross-round cache hit pollutes the scaling number)."""
    return [_warm_committees(k, committees, seed=1000 + r)
            for r in range(rounds)]


def _expected_sizes(traffic, route_label) -> Dict[str, List[int]]:
    """worker label -> warm sizes: for each round, the number of distinct
    items the consistent-hash ring sends that worker (its flush size),
    plus the half/2/1 ladder the serve bench warms (bisection and
    straggler shapes)."""
    sizes: Dict[str, set] = {}
    for round_items in traffic:
        per_worker: Dict[str, int] = {}
        for kind, pks, msg, sig in round_items:
            label = route_label(check_key(kind, pks, msg, sig))
            per_worker[label] = per_worker.get(label, 0) + 1
        for label, n in per_worker.items():
            sizes.setdefault(label, set()).update(
                {n, max(1, n // 2), 2, 1})
    return {label: sorted(s, reverse=True) for label, s in sizes.items()}


def _check_merge_exact(router, scrape_text: str) -> Dict:
    """The acceptance property: merged scrape == exact merge of the
    per-worker snapshots for the submit->result histogram — observation
    counts sum AND per-bucket mass sums."""
    label = "serve.submit_to_result"
    wires = []
    for worker in router.aggregator.workers:
        snap = router.aggregator.worker_snapshot(worker)
        wire = (snap or {}).get("hists", {}).get(label)
        if wire is not None:
            wires.append(wire)
    if not wires:
        return {"ok": False, "error": "no worker histograms"}
    expect_count = sum(int(w["count"]) for w in wires)
    expect_buckets: Dict[int, int] = {}
    for w in wires:
        for idx, n in w["counts"].items():
            expect_buckets[int(idx)] = expect_buckets.get(int(idx), 0) + n
    merged = router.aggregator.merged_hists().get(label)
    merged_state = merged.state() if merged is not None else {}
    counts_ok = (merged_state.get("count") == expect_count
                 and merged_state.get("counts") == expect_buckets)
    # and the RENDERED text agrees (the scrape a Prometheus server sees)
    fam = "consensus_specs_tpu_serve_submit_to_result_latency_hist_seconds"
    scrape_count = None
    for line in scrape_text.splitlines():
        if line.startswith(fam + "_count "):
            scrape_count = int(float(line.rsplit(" ", 1)[1]))
    return {
        "ok": bool(counts_ok and scrape_count == expect_count),
        "n_merged": merged_state.get("count", 0),
        "n_expected": expect_count,
        "n_scrape": scrape_count,
        "buckets": len(expect_buckets),
    }


def _measure_count(n_workers: int, committees: int, k: int, rounds: int,
                   future_timeout: float, device) -> Dict:
    """One fleet at one worker count: warm, drive, verify, measure."""
    from ..serve.fleet import FleetRouter

    traffic = _round_traffic(committees, k, rounds)
    router = FleetRouter(
        workers=n_workers, backend="bls", device=device,
        # one flush per round per worker: the burst (pipe writes, tens
        # of ms) lands inside the wait window, so the warmed shapes are
        # the executed shapes; the window is also per-round DEAD TIME
        # every count pays once, so it stays small relative to a flush
        env={"SERVE_MAX_WAIT_MS": "100", "SERVE_MAX_BATCH": "64"})
    try:
        warm_sizes = _expected_sizes(traffic, router.route_label)
        # warm every worker CONCURRENTLY (each is its own process; the
        # wall cost is the slowest worker, not the sum)
        errs: List[str] = []

        def _warm(label, sizes):
            try:
                router.handle(label).warm(k, sizes, timeout=future_timeout)
            except Exception as e:
                errs.append(f"{label}: {type(e).__name__}: {e}"[:200])

        threads = [threading.Thread(target=_warm, args=(label, sizes))
                   for label, sizes in warm_sizes.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(future_timeout)
        if errs:
            return {"ok": False, "error": f"warm failed: {errs[0]}"}

        served = 0
        wrong = 0
        elapsed = 0.0
        for round_items in traffic:
            t0 = time.perf_counter()
            futures = [router.submit(kind, pks, msg, sig)
                       for kind, pks, msg, sig in round_items]
            results = [bool(f.result(timeout=future_timeout))
                       for f in futures]
            elapsed += time.perf_counter() - t0
            served += sum(len(pks) for _, pks, _, _ in round_items)
            wrong += sum(1 for got in results if got is not True)
        if wrong:
            return {"ok": False,
                    "error": f"{wrong} wrong verdicts on valid traffic"}

        snaps = router.poll_snapshots()
        merge = _check_merge_exact(router, router.scrape_text())
        merged_hist = router.aggregator.merged_hists().get(
            "serve.submit_to_result")
        per_worker = {
            label: snap["extra"]["serve"]["submits"]
            for label, snap in sorted(snaps.items())
        }
        worker_kernels = {
            label: snap["extra"].get("kernels", {})
            for label, snap in sorted(snaps.items())
        }
        return {
            "ok": bool(merge["ok"]),
            "workers": n_workers,
            "sigs_per_sec": round(served / elapsed, 2) if elapsed else 0.0,
            "elapsed_s": round(elapsed, 3),
            "served": served,
            "per_worker_submits": per_worker,
            "worker_kernels": worker_kernels,
            "p99_ms": (round(merged_hist.percentile(99) * 1e3, 3)
                       if merged_hist is not None else 0.0),
            "merge_exact": merge,
        }
    except Exception as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}
    finally:
        router.close()


def run_fleet_bench(device=None) -> dict:
    """Drive the sweep with every worker on ``device`` (None: the CUDA
    card); returns the JAX bench's result dict."""
    from ..device import resolve_device

    device = resolve_device(device)
    counts = []
    for tok in os.environ.get("SERVE_FLEET_WORKERS", "1,2,4").split(","):
        tok = tok.strip()
        if tok.isdigit() and int(tok) > 0:
            counts.append(int(tok))
    # 32 distinct committees per round: enough crypto per flush that the
    # per-round fixed costs (flush wait window, host finalization) stop
    # diluting the scaling signal
    committees = int(os.environ.get("SERVE_FLEET_COMMITTEES", "32"))
    k = int(os.environ.get("SERVE_FLEET_K", "8"))
    rounds = int(os.environ.get("SERVE_FLEET_ROUNDS", "2"))
    timeout = float(os.environ.get("SERVE_FLEET_TIMEOUT", "900"))

    fleet: Dict[str, Dict] = {}
    for n in counts:
        fleet[str(n)] = _measure_count(n, committees, k, rounds, timeout,
                                       device)

    one = fleet.get("1", {})
    two = fleet.get("2", {})
    base = one.get("sigs_per_sec", 0.0) if one.get("ok") else 0.0
    speedup = None
    if base > 0 and two.get("ok"):
        speedup = round(two["sigs_per_sec"] / base, 4)
        two["speedup_vs_1"] = speedup
    for n_str, row in fleet.items():
        d = int(n_str)
        if row.get("ok") and base > 0 and d > 1:
            row["efficiency"] = round(row["sigs_per_sec"] / (d * base), 4)

    ok_rows = [r for r in fleet.values() if r.get("ok")]
    best = max((r["sigs_per_sec"] for r in ok_rows), default=0.0)
    bars = {
        # the acceptance bar: two processes must beat one by >= 1.2x
        # aggregate sigs/sec (counts past 2 are report-only)
        "two_workers_ge_1_2x": bool(speedup is not None and speedup >= 1.2),
        "gated_counts_ok": all(
            fleet.get(str(n), {}).get("ok", False) for n in (1, 2)
            if str(n) in fleet),
        "merge_exact_everywhere": all(
            r.get("merge_exact", {}).get("ok", False) for r in ok_rows),
    }
    return dict(
        metric="aggregate BLS signatures verified/sec (serve fleet)",
        value=best,
        vs_baseline=best / TARGET_PER_CHIP,
        platform=device.type,
        mode="serve-fleet",
        worker_counts=counts,
        committees=committees,
        k=k,
        rounds=rounds,
        fleet=fleet,
        bars=bars,
    )
