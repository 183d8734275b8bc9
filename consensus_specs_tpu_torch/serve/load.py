"""Synthetic gossip load and the serve bench (the port's copy of
consensus_specs_tpu/serve/load.py's signature bench).

Models the serve plane's production shape: Poisson arrivals of committee
aggregates (n committees of k validators), heavy duplication (the same
aggregate heard from several peers), one known-bad aggregate (wrong
message for its signature: must come back False), and an injected backend
failure at the start of the run (the poisoned flush must degrade down the
ladder without losing or corrupting a single request).

``run_serve_bench`` returns the JSON record of the JAX package's
``bench.py --mode serve``: served and verified signatures/s, occupancy,
cache hit rate, latency percentiles, the prep/device split and the RLC
amortization. Env knobs (the JAX package's names and defaults):
  SERVE_COMMITTEES, SERVE_K, SERVE_EVENTS, SERVE_RATE_HZ,
  SERVE_MAX_BATCH, SERVE_MAX_WAIT_MS, SERVE_INJECT_FAILURE (1/0),
  SERVE_SEED, SERVE_METRICS_PORT (opt-in /metrics + /snapshot + /healthz
  endpoint during the run; 0 = ephemeral port, reported in the record)
With a mesh armed (CONSENSUS_SPECS_TPU_MESH, the bench entry's
``--mesh``) the record carries ``mesh_devices``, ``mesh_fallbacks``,
``mesh_warmup_s`` and ``mesh_distinct_devices``. ``run_serve_mesh_sweep``
(the entry's ``serve-mesh`` mode) runs one serve child a slot count in
SERVE_MESH_DEVICES (default 1,2,4,8; SERVE_MESH_TIMEOUT, default 900 s).

It also holds the crypto-free pieces that fleet workers in verdict mode,
and the tests, run on: ``VerdictBackend`` (the verdict rides in the
signature bytes) and the per-event gossip fault plan.
"""
import concurrent.futures as cf
import json
import os
import random
import subprocess
import sys
import time
from collections.abc import Sequence
from dataclasses import dataclass
from typing import List, Tuple

from ..device import resolve_device
from ..ops import profiling

# the north-star share, 150,000 verifications/s over 8 chips: the
# denominator of ``vs_baseline``, as in the JAX package's record
TARGET_PER_CHIP = 150_000 / 8


class FailingBackendProxy:
    """Delegates to a real backend module but raises on chosen call
    numbers: the bench's device-failure injection. Failing calls 1 and 2
    poisons the FIRST flush twice (attempt and bounded retry), forcing it
    down the ladder while later flushes prove the backend recovers."""

    def __init__(self, backend, fail_calls=(1, 2)):
        self._backend = backend
        self._fail_calls = set(fail_calls)
        self.calls = 0
        self.fired = 0

    def _maybe_fail(self):
        self.calls += 1
        if self.calls in self._fail_calls:
            self.fired += 1
            raise RuntimeError(f"injected device failure (call {self.calls})")

    def batch_fast_aggregate_verify(self, *args, **kwargs):
        self._maybe_fail()
        return self._backend.batch_fast_aggregate_verify(*args, **kwargs)

    def batch_aggregate_verify(self, *args, **kwargs):
        self._maybe_fail()
        return self._backend.batch_aggregate_verify(*args, **kwargs)

    def batch_verify_rlc(self, *args, **kwargs):
        # the RLC route counts against the same injected-failure schedule
        self._maybe_fail()
        return self._backend.batch_verify_rlc(*args, **kwargs)

    def prewarm_host_caches(self, *args, **kwargs):
        # codec prep never fails here: the injection targets verification
        return self._backend.prewarm_host_caches(*args, **kwargs)


# -- crypto-free verdicts and gossip fault plans -------------------------------
#
# A gossip fault plan is a per-event kind string:
#   "ok"            a valid attestation of a known committee;
#   "invalid_sig"   its signature is BAD_SIGNATURE (the verdict backend and
#                   the worker's per-item oracle answer False);
#   "orphan"        it votes for a block no honest node has seen yet;
#   "equivocation"  a conflicting twin proposal at the same slot, published
#                   to a different subset of the network;
#   "censored_agg"  the adversarial aggregator never publishes this
#                   committee's aggregate.

BAD_SIGNATURE = b"\xba" * 96  # the injected invalid-signature marker

# every kind a fault plan may carry, in draw-priority order
FAULT_KINDS = ("ok", "invalid_sig", "orphan", "equivocation", "censored_agg")


@dataclass(frozen=True)
class GossipFaultPlan(Sequence):
    """The stable per-event fault plan: Sequence-shaped over the per-event
    kind strings (``plan[e]``, ``len(plan)``, ``plan.count("orphan")``)
    while carrying the rates that produced it. Equality is structural:
    same seed, same rates, identical plan."""

    kinds: Tuple[str, ...]
    invalid_rate: float = 0.0
    orphan_rate: float = 0.0
    equivocation_rate: float = 0.0
    censor_rate: float = 0.0

    def __post_init__(self):
        unknown = set(self.kinds) - set(FAULT_KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds in plan: {sorted(unknown)}")

    def __len__(self) -> int:
        return len(self.kinds)

    def __getitem__(self, index):
        return self.kinds[index]

    def counts(self) -> dict:
        """{kind: occurrences} over every kind, zeros included."""
        return {kind: self.kinds.count(kind) for kind in FAULT_KINDS}


class VerdictBackend:
    """Crypto-free batched backend: the verdict rides IN the signature
    bytes (``BAD_SIGNATURE`` -> False, anything else -> True), so replays
    and fleet workers exercise the whole service pipeline (batching,
    dedup, caching, False-verdict routing) without paying pairings.
    Counts calls and items like the real backend's CALL_COUNTS. It does
    no device work: ``device`` is accepted, as the service passes it, and
    ignored."""

    def __init__(self):
        self.calls = 0
        self.items = 0

    def _verdicts(self, signatures):
        self.calls += 1
        self.items += len(signatures)
        return [sig != BAD_SIGNATURE for sig in signatures]

    def batch_fast_aggregate_verify(self, pubkey_sets, messages, signatures,
                                    device=None):
        return self._verdicts([bytes(s) for s in signatures])

    def batch_aggregate_verify(self, pubkey_sets, message_sets, signatures,
                               device=None):
        return self._verdicts([bytes(s) for s in signatures])


def plan_gossip_faults(rng: random.Random, events: int,
                       invalid_rate: float = 0.0,
                       orphan_rate: float = 0.0,
                       equivocation_rate: float = 0.0,
                       censor_rate: float = 0.0) -> GossipFaultPlan:
    """Per-event fault plan for an attestation gossip replay: one kind
    from ``FAULT_KINDS`` drawn independently per event (a single uniform
    draw split across the rate bands, so adding a rate never perturbs the
    draws of the kinds before it at a fixed seed). The first event is
    always clean so a replay never starts with an empty applied set."""
    kinds = []
    bands = (
        ("invalid_sig", invalid_rate),
        ("orphan", orphan_rate),
        ("equivocation", equivocation_rate),
        ("censored_agg", censor_rate),
    )
    for e in range(events):
        draw = rng.random()
        kind = "ok"
        if e:
            upper = 0.0
            for name, rate in bands:
                upper += rate
                if draw < upper:
                    kind = name
                    break
        kinds.append(kind)
    return GossipFaultPlan(
        kinds=tuple(kinds),
        invalid_rate=invalid_rate,
        orphan_rate=orphan_rate,
        equivocation_rate=equivocation_rate,
        censor_rate=censor_rate,
    )


def build_committees(n_committees: int, k: int, seed: int = 7
                     ) -> List[Tuple[list, bytes, bytes, bool]]:
    """(pubkeys, message, signature, expected) per committee. The last
    committee is corrupted (message swapped after signing) so the stream
    carries a known False. Signing uses the summed-secret-key identity (an
    aggregate of same-message signatures equals one signature by the
    summed key), so setup is n signs, not n*k."""
    from ..utils import bls
    from ..utils.bls12_381 import R

    committees = []
    for ci in range(n_committees):
        sks = [seed * 100_000 + ci * 1_000 + j + 1 for j in range(k)]
        pks = [bls.SkToPk(sk) for sk in sks]
        msg = ci.to_bytes(32, "little")
        sig = bls.Sign(sum(sks) % R, msg)
        committees.append((pks, msg, sig, True))
    if committees:
        pks, msg, sig, _ = committees[-1]
        committees[-1] = (pks, b"\xff" + msg[1:], sig, False)
    return committees


def _event_schedule(rng: random.Random, committees, events: int):
    """Committee index per event. The first half of the stream only draws
    from the first half of the committees, the rest join later, so new
    distinct content keeps arriving after the (injected-failure) first
    flushes and the recovered backend demonstrably serves it."""
    n = len(committees)
    early = max(1, n // 2)
    picks = []
    for e in range(events):
        pool = early if e < events // 2 else n
        picks.append(rng.randrange(pool))
    return picks


def run_serve_bench(target: float = TARGET_PER_CHIP, device=None) -> dict:
    """Drive a synthetic Poisson gossip stream through a
    VerificationService on ``device`` (None: the CUDA card); returns the
    bench record. Raises if any request is lost or answered wrong: a serve
    bench that corrupts the stream fails loudly instead of recording a
    throughput number."""
    from ..obs import devices, programs as obs_programs
    from ..ops import bls_backend
    from .service import VerificationService

    dev = resolve_device(device)
    # clean slate: the record attaches profiling.summary(), so an earlier
    # run's histograms and gauges must not bleed into it; the once-per-
    # process vm-cache gauges are re-published, and the occupancy ledger
    # starts its denominators at this run
    profiling.reset()
    obs_programs.export_gauges()
    devices.reset_global()

    # rate sized so a max_wait flush window catches several events (~4 ms
    # apart at 256 Hz): micro-batches then carry more than one distinct
    # committee and the RLC combine really combines
    n_committees = int(os.environ.get("SERVE_COMMITTEES", "8"))
    k = int(os.environ.get("SERVE_K", "8"))
    events = int(os.environ.get("SERVE_EVENTS", "64"))
    rate_hz = float(os.environ.get("SERVE_RATE_HZ", "256"))
    max_batch = int(os.environ.get("SERVE_MAX_BATCH", "32"))
    max_wait_ms = float(os.environ.get("SERVE_MAX_WAIT_MS", "20"))
    inject = os.environ.get("SERVE_INJECT_FAILURE", "1") == "1"
    seed = int(os.environ.get("SERVE_SEED", "7"))

    rng = random.Random(seed)
    committees = build_committees(n_committees, k, seed=seed)
    picks = _event_schedule(rng, committees, events)

    # program assembly outside the timed window: one warm-up verify of a
    # committee NOT in the stream, straight through the real backend
    from ..utils import bls
    from ..utils.bls12_381 import R

    warm_sks = list(range(1, k + 1))
    warm_msg = b"warmup" + b"\x00" * 26
    t0 = time.perf_counter()
    warm_ok = bls_backend.batch_fast_aggregate_verify(
        [[bls.SkToPk(sk) for sk in warm_sks]],
        [warm_msg],
        [bls.Sign(sum(warm_sks) % R, warm_msg)],
        device=dev,
    )
    warmup_s = time.perf_counter() - t0
    if not bool(warm_ok[0]):
        raise AssertionError("serve bench warmup verification failed")

    # with a mesh armed (CONSENSUS_SPECS_TPU_MESH / the entry's --mesh),
    # assemble the sharded shapes' programs outside the timed window too:
    # flush-shaped RLC batches of warm-only committees (another seed, so
    # none of their content is in the stream), the corrupted last item
    # included so the bisection's shapes warm as well. Sizes below the
    # slot count warm unsharded, as the service routes such flushes
    from ..utils import torch_env

    warm_mesh = torch_env.maybe_mesh(dev)
    mesh_warmup_s = 0.0
    if warm_mesh is not None:
        t0 = time.perf_counter()
        warm_items = [
            ("fast_aggregate", pks, msg, sig)
            for pks, msg, sig, _ok in build_committees(
                n_committees, k, seed=seed + 1)
        ]
        for size in sorted({len(warm_items), max(1, len(warm_items) // 2),
                            2, 1}, reverse=True):
            bls_backend.batch_verify_rlc(
                warm_items[:size], device=dev,
                mesh=warm_mesh if size >= warm_mesh.size else None)
        mesh_warmup_s = time.perf_counter() - t0

    backend = FailingBackendProxy(bls_backend) if inject else bls_backend
    svc = VerificationService(
        backend=backend, device=dev, max_batch=max_batch,
        max_wait_ms=max_wait_ms,
    )
    # opt-in exposition endpoint, live DURING the load (SERVE_METRICS_PORT;
    # 0 = ephemeral): /metrics Prometheus text, /snapshot ServeMetrics
    # JSON, /healthz, scraped once mid-load to show it answers under load.
    # The whole load runs under try/finally: the service drains and the
    # port unbinds even when a submit or the (non-fatal) scrape fails.
    exposition, scrape = None, None
    port_env = (os.environ.get("SERVE_METRICS_PORT") or "").strip()
    try:
        if port_env:
            from ..obs.exposition import start_exposition

            exposition = start_exposition(metrics=svc.metrics,
                                          port=int(port_env))
        futures, expected, sig_count = [], [], 0
        t_start = time.perf_counter()
        t_next = t_start
        for ci in picks:
            pks, msg, sig, ok = committees[ci]
            futures.append(svc.submit("fast_aggregate", pks, msg, sig))
            expected.append(ok)
            sig_count += len(pks)
            t_next += rng.expovariate(rate_hz)
            pause = t_next - time.perf_counter()
            if pause > 0:
                time.sleep(pause)
        scrape_thread, scrape_box = None, {}
        if exposition is not None:
            # the stream is submitted but far from drained: this scrape
            # happens under live traffic, on a helper thread, so a slow
            # endpoint never inflates the window the sigs/s headline
            # divides by. A failed scrape is a recorded observation
            # (scrape stays None), never the reason the measurement dies
            import threading
            import urllib.request

            def _scrape():
                try:
                    with urllib.request.urlopen(exposition.url("/metrics"),
                                                timeout=30) as resp:
                        scrape_box["body"] = resp.read().decode()
                except OSError:
                    pass

            scrape_thread = threading.Thread(target=_scrape, daemon=True)
            scrape_thread.start()
        # bounded wait FIRST, then harvest: f.result(timeout=...) in a loop
        # would raise on the first unresolved future and never reach the
        # lost-request accounting below
        _, pending = cf.wait(futures, timeout=600)
        elapsed = time.perf_counter() - t_start
        if scrape_thread is not None:
            scrape_thread.join(35)
            scrape = scrape_box.get("body")
    finally:
        svc.close(timeout=60)
        if exposition is not None:
            exposition.close()

    lost = len(pending)
    results = [bool(f.result()) if f.done() else None for f in futures]
    wrong = sum(
        1 for r, ok in zip(results, expected)
        if r is not None and r is not ok
    )
    if lost or wrong:
        raise AssertionError(
            f"serve stream integrity violated: {lost} lost, {wrong} wrong "
            f"of {events} requests (injected_failures="
            f"{getattr(backend, 'fired', 0)})"
        )

    snap = svc.metrics.snapshot()
    ledger = devices.maybe_ledger()
    devices_section = None
    if ledger is not None:
        ledger.export_gauges()
        devices_section = ledger.snapshot()
    # SERVED vs VERIFIED: the duplicate-heavy stream is answered mostly by
    # the cache and dedup layer, so served/s is the serving headline while
    # verified/s (distinct content that reached the crypto) is what
    # compares with raw verification
    served_per_sec = sig_count / elapsed
    verified_keys = sum(len(committees[ci][0]) for ci in set(picks))
    verified_per_sec = verified_keys / elapsed
    result = dict(
        metric="sustained aggregate BLS signatures served/sec (serve)",
        value=served_per_sec,
        vs_baseline=verified_per_sec / target,
        verified_sigs_per_sec=round(verified_per_sec, 2),
        sigs_served=sig_count,
        sigs_verified=verified_keys,
        mode="serve",
        device=str(dev),
        events=events,
        committees=n_committees,
        k=k,
        rate_hz=rate_hz,
        elapsed_s=round(elapsed, 3),
        warmup_s=round(warmup_s, 3),
        occupancy_mean=snap["occupancy_rows"],
        occupancy_lanes=snap["occupancy_lanes"],
        cache_hit_rate=snap["cache_hit_rate"],
        p50_ms=snap["latency"].get("p50_ms", 0.0),
        p95_ms=snap["latency"].get("p95_ms", 0.0),
        p99_ms=snap["latency"].get("p99_ms", 0.0),
        latency_n=snap["latency"].get("n", 0),
        batches=snap["batches"],
        # the prep of the NEXT flush overlaps the device stage of this one,
        # so the pipeline's critical path is max(prep, device), not the sum
        prep_ms_per_flush=snap["prep_ms_per_flush"],
        device_ms_per_flush=snap["device_ms_per_flush"],
        prep_serial_fallback_items=snap["prep"].get(
            "serial_fallback_items", 0
        ),
        final_exps_per_item=snap["final_exps_per_item"],
        rlc_combines=snap["rlc"].get("combines", 0),
        rlc_bisections=snap["rlc"].get("bisections", 0),
        fallback_items=snap["fallback_items"],
        fault_injected=bool(inject and getattr(backend, "fired", 0)),
        lost=lost,
        wrong=wrong,
        profile=profiling.summary(),
    )
    if svc.mesh_devices:
        # the single-run mesh record (the per-count rows are the sweep's)
        result["mesh_devices"] = svc.mesh_devices
        result["mesh_fallbacks"] = snap["mesh_fallbacks"]
        result["mesh_warmup_s"] = round(mesh_warmup_s, 3)
        result["mesh_distinct_devices"] = warm_mesh.distinct_devices
    if devices_section is not None:
        result["devices"] = devices_section
    if exposition is not None:
        result["metrics_port"] = exposition.port
        result["metrics_scrape_ok"] = scrape is not None
        result["metrics_scrape_lines"] = len((scrape or "").splitlines())
    return result


# -- mesh scaling sweep (the bench entry's ``--mode serve-mesh``) -------------


def _parse_last_json_line(stdout: bytes):
    """Last parseable JSON object in a child's stdout, or None."""
    parsed = None
    for line in stdout.decode(errors="replace").strip().splitlines():
        try:
            parsed = json.loads(line)
        except ValueError:
            continue
    return parsed


def run_serve_mesh_sweep(device=None) -> dict:
    """The serve plane's mesh matrix: one ``python -m
    consensus_specs_tpu_torch.bench --mode serve --mesh <d>`` child a slot
    count in SERVE_MESH_DEVICES (default 1,2,4,8), on ``device`` (None:
    the card; "cpu": the children run with ``--device cpu``), fault
    injection off (SERVE_INJECT_FAILURE=0 forced: the sweep measures
    clean traffic, and an injected failure would make every child's first
    sharded flush a mesh fallback). Returns the record; its ``mesh``
    section maps the slot count to {ok, sigs_per_sec,
    verified_sigs_per_sec, final_exps_per_item, fallbacks, p99_ms, lanes,
    distinct_devices, efficiency}. Efficiency (sigs/s at d slots over d
    times the 1-slot sigs/s) is report-only: slots that share one card
    share its SMs."""
    dev = resolve_device(device)
    counts = []
    for tok in os.environ.get("SERVE_MESH_DEVICES", "1,2,4,8").split(","):
        tok = tok.strip()
        if tok and tok.isdigit() and int(tok) > 0:
            counts.append(int(tok))
    timeout = float(os.environ.get("SERVE_MESH_TIMEOUT", "900"))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    rows = {}
    for d in counts:
        env = os.environ.copy()
        env["SERVE_INJECT_FAILURE"] = "0"
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        cmd = [sys.executable, "-m", "consensus_specs_tpu_torch.bench",
               "--mode", "serve", "--mesh", str(d)]
        if dev.type == "cpu":
            cmd += ["--device", "cpu"]
        try:
            out = subprocess.run(cmd, capture_output=True, timeout=timeout,
                                 env=env, cwd=root)
            parsed = _parse_last_json_line(out.stdout)
        except subprocess.TimeoutExpired:
            rows[str(d)] = {"ok": False,
                            "error": f"child exceeded {timeout:.0f}s"}
            continue
        if parsed is None or "error" in parsed or parsed.get("value", 0) <= 0:
            err = (parsed or {}).get("error") or (
                out.stderr.decode(errors="replace").strip()
                .splitlines()[-1:] or ["no parseable output"])[0]
            rows[str(d)] = {"ok": False, "error": str(err)[:300]}
            continue
        lanes = {}
        for lane, entry in (parsed.get("devices") or {}).get(
                "lanes", {}).items():
            lanes[lane] = entry.get("utilization", 0.0)
        rows[str(d)] = {
            "ok": True,
            "sigs_per_sec": round(float(parsed["value"]), 2),
            "verified_sigs_per_sec": parsed.get("verified_sigs_per_sec", 0.0),
            "final_exps_per_item": parsed.get("final_exps_per_item", 0.0),
            "fallbacks": parsed.get("mesh_fallbacks", 0),
            "mesh_devices": parsed.get("mesh_devices", 0),
            "distinct_devices": parsed.get("mesh_distinct_devices", 1),
            "p99_ms": parsed.get("p99_ms", 0.0),
            "launches": parsed.get("launches"),
            "lanes": lanes,
        }

    single = rows.get("1", {})
    base = single.get("sigs_per_sec", 0.0) if single.get("ok") else 0.0
    for d_str, row in rows.items():
        d = int(d_str)
        if row.get("ok") and base > 0 and d > 1:
            row["efficiency"] = round(row["sigs_per_sec"] / (d * base), 4)
            row["within_10pct_of_single"] = bool(
                row["sigs_per_sec"] >= 0.9 * base)

    ok_rows = {d: r for d, r in rows.items() if r.get("ok")}
    best = max((r["sigs_per_sec"] for r in ok_rows.values()), default=0.0)
    best_verified = max(
        (float(r.get("verified_sigs_per_sec") or 0.0)
         for r in ok_rows.values()), default=0.0)
    return dict(
        metric="sustained aggregate BLS signatures served/sec "
               "(serve, mesh sweep)",
        value=best,
        vs_baseline=best_verified / TARGET_PER_CHIP,
        mode="serve-mesh",
        device_counts=counts,
        mesh=rows,
    )
