"""The port's serve fleet (consensus_specs_tpu_torch/serve/fleet.py and
worker.py, obs/fleet.py, obs/snapshot.py, obs/slo.py) against the JAX
package's, on the CPU.

Each case of tests/test_fleet.py runs on both packages as one test
parametrised over the package: the consistent-hash ring, the aggregator's
merge algebra, the shed policy, and REAL verdict-backend fleets of worker
processes (the port's with ``device="cpu"``). Then the cross-package
cases: both rings route the same keys to the same labels, a JAX worker's
snapshot and a port worker's snapshot each merge to the same scrape in
both aggregators, both SLO trackers and shed policies decide alike on the
same histogram sequence, and a port ``bls`` worker on the CPU answers as
the JAX single-process service does (exact verdicts). The simnet replays
of tests/test_fleet.py and tests/test_latency.py run a scenario on each
package's ``sim/fleet_replay.py`` against that package's fleet.
"""
import json
import os
import time
import urllib.request

import numpy as np
import pytest

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

from consensus_specs_tpu.obs import fleet as jofleet  # noqa: E402
from consensus_specs_tpu.obs import flight as jflight  # noqa: E402
from consensus_specs_tpu.obs import hist as jhist  # noqa: E402
from consensus_specs_tpu.obs import registry as jregistry  # noqa: E402
from consensus_specs_tpu.obs import slo as jslo  # noqa: E402
from consensus_specs_tpu.obs import snapshot as jsnap  # noqa: E402
from consensus_specs_tpu.ops import profiling as jprofiling  # noqa: E402
from consensus_specs_tpu.serve import cache as jcache  # noqa: E402
from consensus_specs_tpu.serve import fleet as jfleet  # noqa: E402
from consensus_specs_tpu.serve import load as jload  # noqa: E402
from consensus_specs_tpu_torch.obs import fleet as tofleet  # noqa: E402
from consensus_specs_tpu_torch.obs import flight as tflight  # noqa: E402
from consensus_specs_tpu_torch.obs import hist as thist  # noqa: E402
from consensus_specs_tpu_torch.obs import registry as tregistry  # noqa: E402
from consensus_specs_tpu_torch.obs import slo as tslo  # noqa: E402
from consensus_specs_tpu_torch.obs import snapshot as tsnap  # noqa: E402
from consensus_specs_tpu_torch.ops import profiling as tprofiling  # noqa: E402
from consensus_specs_tpu_torch.serve import cache as tcache  # noqa: E402
from consensus_specs_tpu_torch.serve import fleet as tfleet  # noqa: E402
from consensus_specs_tpu_torch.serve import load as tload  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

PKGS = ("jax", "torch")
PK = b"\x01" * 48


class Pkg:
    """One package's fleet surface: its modules and its router kwargs."""

    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.fleet = jfleet if jax else tfleet
        self.ofleet = jofleet if jax else tofleet
        self.flight = jflight if jax else tflight
        self.hist = jhist if jax else thist
        self.registry = jregistry if jax else tregistry
        self.slo = jslo if jax else tslo
        self.snap = jsnap if jax else tsnap
        self.profiling = jprofiling if jax else tprofiling
        self.cache = jcache if jax else tcache
        self.load = jload if jax else tload
        # the port resolves its device at construction: the CPU here
        self.kw = {} if jax else {"device": "cpu"}

    def router(self, **kw):
        return self.fleet.FleetRouter(**{**self.kw, **kw})

    def key(self, i):
        return self.cache.check_key("fast_aggregate", [_pk(i)],
                                    bytes([i]) * 32, bytes([i]) * 96)

    def wire(self, values):
        h = self.hist.Histogram()
        for v in values:
            h.observe(v)
        return self.snap.hist_to_wire(h)

    def snapshot(self, worker, hists=None, gauges=None, stats=None,
                 events=None, pid=1, spans=None):
        snap = {"v": self.snap.WIRE_VERSION, "worker": worker, "pid": pid,
                "hists": hists or {}, "gauges": gauges or {},
                "stats": stats or {}}
        if events is not None:
            snap["flight"] = {"counters": {"events": len(events)},
                              "events": events}
        if spans is not None:
            snap["spans"] = {"traces": spans}
        return snap


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


@pytest.fixture(autouse=True)
def _clean_profiling():
    jprofiling.reset()
    tprofiling.reset()
    yield
    jprofiling.reset()
    tprofiling.reset()


def _pk(i):
    return bytes([i]) * 48


def _ev(seq, t=None):
    return {"seq": seq, "t": t if t is not None else seq / 10.0,
            "plane": "serve", "kind": "flush", "data": {}}


# -- consistent-hash ring ----------------------------------------------------


def test_ring_routes_deterministically_and_affinely(pkg):
    ring = pkg.fleet.HashRing()
    for label in ("w0", "w1", "w2"):
        ring.add(label)
    keys = [pkg.key(i) for i in range(64)]
    first = [ring.route(k) for k in keys]
    assert [ring.route(k) for k in keys] == first  # same key, same worker
    assert len(set(first)) == 3  # all workers own some arc


def test_ring_removal_only_remaps_the_drained_workers_keys(pkg):
    ring = pkg.fleet.HashRing()
    for label in ("w0", "w1", "w2"):
        ring.add(label)
    keys = [pkg.key(i) for i in range(128)]
    before = {k: ring.route(k) for k in keys}
    ring.remove("w1")
    for k, owner in before.items():
        if owner != "w1":
            # surviving workers keep every key they had
            assert ring.route(k) == owner
        else:
            assert ring.route(k) in ("w0", "w2")


def test_rings_of_both_packages_route_alike():
    """1,000 keys drawn from a numpy seed, through both packages' rings at
    two and three workers and after a removal: the same labels."""
    rng = np.random.default_rng(20261017)
    keys = [bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
            for _ in range(1000)]
    rings = {name: Pkg(name).fleet.HashRing() for name in PKGS}
    for labels in (("w0", "w1"), ("w2",)):
        for ring in rings.values():
            for label in labels:
                ring.add(label)
        routed = {name: [r.route(k) for k in keys]
                  for name, r in rings.items()}
        assert routed["torch"] == routed["jax"]
        assert set(routed["torch"]) == set(rings["torch"]._table[1])
    for ring in rings.values():
        ring.remove("w0")
    assert [rings["torch"].route(k) for k in keys] == \
        [rings["jax"].route(k) for k in keys]


# -- aggregator merge algebra ------------------------------------------------


def test_aggregator_merges_hists_exactly_and_namespaces_gauges(pkg):
    aggr = pkg.ofleet.FleetAggregator()
    a, b = [0.01, 0.02, 0.5], [0.015, 4.0]
    aggr.ingest("w0", pkg.snapshot(
        "w0", hists={"serve.submit_to_result": pkg.wire(a)},
        gauges={"serve.queue_depth": 2.0, "bls.rlc_combines": 3.0,
                "slo.ok": 1.0},
        stats={"serve.batch_flush": {"calls": 2, "total_s": 1.0,
                                     "max_s": 0.7}}))
    aggr.ingest("w1", pkg.snapshot(
        "w1", hists={"serve.submit_to_result": pkg.wire(b)},
        gauges={"serve.queue_depth": 5.0, "bls.rlc_combines": 4.0},
        stats={"serve.batch_flush": {"calls": 1, "total_s": 0.2,
                                     "max_s": 0.2}}))
    merged = aggr.merged_hists()["serve.submit_to_result"]
    whole = pkg.hist.Histogram()
    for v in a + b:
        whole.observe(v)
    assert merged.state()["counts"] == whole.state()["counts"]
    assert merged.count == 5
    gauges = aggr.merged_gauges()
    # instance gauges re-scope per worker; counters sum; slo.* drops
    assert gauges["serve[w0].queue_depth"] == 2.0
    assert gauges["serve[w1].queue_depth"] == 5.0
    assert gauges["bls.rlc_combines"] == 7.0
    assert not any(g.startswith("slo.") for g in gauges)
    stats = aggr.merged_stats()["serve.batch_flush"]
    assert stats == {"calls": 3, "total_s": 1.2, "max_s": 0.7}
    # the merged view renders through the standard Prometheus renderer
    text = aggr.render_metrics(local_gauges={"fleet.workers": 2.0})
    assert ("consensus_specs_tpu_serve_submit_to_result_latency_hist_"
            "seconds_count 5") in text
    assert "consensus_specs_tpu_fleet_workers 2.0" in text
    assert 'serve_node{label="serve[w0].queue_depth"} 2.0' in text


def test_merged_view_local_gauges_never_clobber_worker_counters(pkg):
    aggr = pkg.ofleet.FleetAggregator()
    aggr.ingest("w0", pkg.snapshot("w0", gauges={"flight.events": 5.0}))
    aggr.ingest("w1", pkg.snapshot("w1", gauges={"flight.events": 7.0}))
    _, gauges, _ = aggr.merged_view(local_gauges={
        "flight.events": 1.0, "fleet.workers": 2.0, "slo.ok": 1.0})
    assert gauges["flight.events"] == 12.0  # worker sum, not the local 1.0
    assert gauges["fleet.workers"] == 2.0
    assert gauges["slo.ok"] == 1.0


def test_snapshot_flight_since_ships_only_new_events(pkg, monkeypatch):
    monkeypatch.setenv(pkg.flight.FLIGHT_ENV, "1")
    pkg.flight.reset_global()
    try:
        rec = pkg.flight.global_recorder()
        for i in range(3):
            rec.note("serve", "flush", items=i)
        full = pkg.snap.take_process_snapshot(worker="w0")
        assert [e["seq"] for e in full["flight"]["events"]] == [1, 2, 3]
        delta = pkg.snap.take_process_snapshot(worker="w0", flight_since=2)
        assert [e["seq"] for e in delta["flight"]["events"]] == [3]
        # counters stay cumulative on the delta snapshot
        assert delta["flight"]["counters"]["events"] == 3
        aggr = pkg.ofleet.FleetAggregator()
        aggr.ingest("w0", full)
        assert aggr.last_seq("w0") == 3
        rec.note("serve", "flush", items=3)
        aggr.ingest("w0", pkg.snap.take_process_snapshot(
            worker="w0", flight_since=aggr.last_seq("w0")))
        assert [e["seq"] for e in aggr.journal_events()] == [1, 2, 3, 4]
        # the process.* gauges ride every snapshot
        for label in pkg.snap.PROCESS_GAUGE_LABELS:
            assert label in full["gauges"] and pkg.registry.known(label)
    finally:
        pkg.flight.reset_global()


def test_aggregator_journal_is_incremental_and_worker_stamped(pkg):
    aggr = pkg.ofleet.FleetAggregator()
    ev = [_ev(1), {"seq": 2, "t": 0.2, "plane": "serve",
                   "kind": "cache_hit", "data": {}}]
    aggr.ingest("w0", pkg.snapshot("w0", events=ev))
    # re-ingesting the same ring must not duplicate events
    aggr.ingest("w0", pkg.snapshot("w0", events=ev + [_ev(3)]))
    events = aggr.journal_events()
    assert [e["seq"] for e in events] == [1, 2, 3]
    assert all(e["worker"] == "w0" for e in events)
    header = json.loads(aggr.journal_jsonl(reason="test").splitlines()[0])
    assert header["events"] == 3 and header["workers"] == ["w0"]


def test_aggregator_restart_resets_watermarks_and_keeps_both_journals(pkg):
    aggr = pkg.ofleet.FleetAggregator()
    aggr.ingest("w0", pkg.snapshot(
        "w0", pid=100, events=[_ev(1), _ev(2), _ev(3)],
        spans=[{"rid": 1, "spans": []}, {"rid": 2, "spans": []}]))
    assert aggr.last_seq("w0", pid=100) == 3
    assert aggr.last_rid("w0", pid=100) == 2
    # a pid the aggregator has never seen (a respawn): the cursors are 0
    assert aggr.last_seq("w0", pid=200) == 0
    assert aggr.last_rid("w0", pid=200) == 0
    aggr.ingest("w0", pkg.snapshot(
        "w0", pid=200, events=[_ev(1, t=9.1), _ev(2, t=9.2)],
        spans=[{"rid": 1, "spans": []}]))
    events = aggr.journal_events()
    assert [e["seq"] for e in events] == [1, 2, 3, 1, 2]
    assert [e["pid"] for e in events] == [100, 100, 100, 200, 200]
    assert aggr.last_seq("w0", pid=200) == 2
    assert aggr.last_rid("w0", pid=200) == 1
    assert aggr.worker_span_sections()["w0"]["pid"] == 200


def test_aggregator_same_pid_reingest_still_dedupes(pkg):
    aggr = pkg.ofleet.FleetAggregator()
    aggr.ingest("w0", pkg.snapshot("w0", pid=100, events=[_ev(1), _ev(2)]))
    aggr.ingest("w0", pkg.snapshot("w0", pid=100,
                                   events=[_ev(1), _ev(2), _ev(3)]))
    assert [e["seq"] for e in aggr.journal_events()] == [1, 2, 3]


def test_aggregator_rejects_wrong_wire_version(pkg):
    aggr = pkg.ofleet.FleetAggregator()
    with pytest.raises(pkg.snap.WireError):
        aggr.ingest("w0", {"v": 999})


def test_snapshot_wire_decodes_in_either_package():
    """The wire is shared: the same version, field names and histogram
    bucket bounds, so either package decodes the other's histograms to
    the same state."""
    assert tsnap.WIRE_VERSION == jsnap.WIRE_VERSION
    rng = np.random.default_rng(7)
    values = list(rng.lognormal(-4.0, 1.5, size=500))
    wires = {name: Pkg(name).wire(values) for name in PKGS}
    assert wires["torch"] == wires["jax"]
    for dec in (jsnap, tsnap):
        states = [dec.hist_from_wire(json.loads(json.dumps(w))).state()
                  for w in wires.values()]
        assert states[0] == states[1]


# -- the crypto-free pieces of serve/load.py ----------------------------------


@pytest.mark.parametrize("rates", [
    dict(), dict(invalid_rate=0.1), dict(orphan_rate=0.05,
                                         equivocation_rate=0.02),
    dict(invalid_rate=0.1, orphan_rate=0.1, equivocation_rate=0.1,
         censor_rate=0.1),
])
def test_gossip_fault_plans_equal_across_packages(rates):
    import random

    plans = {name: Pkg(name).load.plan_gossip_faults(
        random.Random(31), 200, **rates) for name in PKGS}
    assert tuple(plans["torch"]) == tuple(plans["jax"])
    assert plans["torch"].counts() == plans["jax"].counts()
    assert plans["torch"][0] == "ok" and len(plans["torch"]) == 200
    assert (plans["torch"].invalid_rate, plans["torch"].censor_rate) == (
        rates.get("invalid_rate", 0.0), rates.get("censor_rate", 0.0))
    with pytest.raises(ValueError):
        tload.GossipFaultPlan(kinds=("ok", "no_such_kind"))


def test_verdict_backends_equal_across_packages():
    sigs = [b"\x01" * 96, tload.BAD_SIGNATURE, b"\x02" * 96]
    assert tload.BAD_SIGNATURE == jload.BAD_SIGNATURE
    assert tload.FAULT_KINDS == jload.FAULT_KINDS
    got = {}
    for name in PKGS:
        backend = Pkg(name).load.VerdictBackend()
        fast = backend.batch_fast_aggregate_verify([[PK]] * 3, [b"m"] * 3,
                                                   sigs)
        agg = backend.batch_aggregate_verify([[PK]] * 3, [[b"m"]] * 3, sigs)
        got[name] = (fast, agg, backend.calls, backend.items)
    assert got["torch"] == got["jax"] == (
        [True, False, True], [True, False, True], 2, 6)


# -- shed policy ---------------------------------------------------------------


def _eval(burns, ok=True, n=10):
    return {"serve_p99": {"label": "serve.submit_to_result", "ok": ok,
                          "n": n, "burn_rate": burns}}


def test_policy_quiet_fleet_decides_nothing(pkg):
    policy = pkg.slo.ShedPolicy(shed_burn=4.0, drain_burn=32.0)
    assert policy.decide(_eval({"60s": 0.5}),
                         {"w0": _eval({"60s": 0.9})}) == []


def test_policy_sheds_the_worst_burning_worker(pkg):
    policy = pkg.slo.ShedPolicy(shed_burn=4.0, drain_burn=32.0)
    decisions = policy.decide(
        _eval({"60s": 6.0}),
        {"w0": _eval({"60s": 1.0}), "w1": _eval({"60s": 9.0})})
    assert len(decisions) == 1
    d = decisions[0]
    assert (d.worker, d.action) == ("w1", "shed")
    assert d.burn == 9.0 and d.objective == "serve_p99"


def test_policy_escalates_to_drain(pkg):
    policy = pkg.slo.ShedPolicy(shed_burn=4.0, drain_burn=32.0)
    d = policy.decide(_eval({"60s": 40.0}),
                      {"w0": _eval({"60s": 40.0})})[0]
    assert d.action == "drain"
    d = policy.decide(_eval({"60s": 6.0}), {"w0": _eval({"60s": 6.0})},
                      rungs={"w0": 2})[0]
    assert d.action == "drain"


def test_worst_burn_picks_the_peak_window(pkg):
    obj, window, rate = pkg.slo.worst_burn(_eval({"60s": 2.0, "300s": 7.5}))
    assert (obj, window, rate) == ("serve_p99", "300s", 7.5)


def test_slo_trackers_and_policies_decide_alike():
    """The same histogram sequence (numpy-seeded latencies for two
    workers, one of them turning slow) through both packages' fleet and
    per-worker trackers on one injected clock, and both shed policies:
    the same evaluations and the same decisions at every tick."""
    rng = np.random.default_rng(11)
    objectives = [{"name": "serve_p99", "label": "serve.submit_to_result",
                   "quantile": 99.0, "threshold_s": 0.05}]
    clock = [0.0]
    state = {}
    for name in PKGS:
        p = Pkg(name)
        state[name] = {
            "p": p,
            "fleet": p.slo.SloTracker(objectives, clock=lambda: clock[0]),
            "workers": {w: p.slo.SloTracker(objectives,
                                            clock=lambda: clock[0])
                        for w in ("w0", "w1")},
            "hists": {w: p.hist.Histogram() for w in ("w0", "w1")},
            "policy": p.slo.ShedPolicy(shed_burn=2.0, drain_burn=40.0),
        }
    rungs = {"w0": 0, "w1": 0}
    seen = []
    for tick in range(12):
        clock[0] = 10.0 * tick
        draws = {"w0": rng.lognormal(-5.0, 0.5, size=40),
                 "w1": rng.lognormal(-5.0 if tick < 4 else -2.0, 0.5,
                                     size=40)}
        out = {}
        for name, st in state.items():
            for w, values in draws.items():
                for v in values:
                    st["hists"][w].observe(float(v))
            merged = st["hists"]["w0"].merge(st["hists"]["w1"])
            fleet_eval = st["fleet"].evaluate(
                hists={"serve.submit_to_result": merged}, export=False)
            worker_evals = {
                w: tr.evaluate(hists={"serve.submit_to_result": h},
                               export=False)
                for (w, tr), h in zip(sorted(st["workers"].items()),
                                      (st["hists"]["w0"], st["hists"]["w1"]))}
            decisions = st["policy"].decide(fleet_eval, worker_evals,
                                            dict(rungs))
            out[name] = (fleet_eval, worker_evals,
                         [d.as_dict() for d in decisions])
        assert out["torch"] == out["jax"], f"tick {tick}"
        for d in out["torch"][2]:
            if d["action"] == "shed":
                rungs[d["worker"]] = min(2, rungs[d["worker"]] + 1)
            seen.append((d["worker"], d["action"]))
    # the slow worker was shed, then (at the bottom) drained
    assert ("w1", "shed") in seen and ("w1", "drain") in seen
    assert all(w == "w1" for w, _ in seen)


# -- real verdict fleets (one per package, spawned once per module) ----------


@pytest.fixture(scope="module")
def fleets():
    routers = {}
    try:
        for name in PKGS:
            # the TSDB off whatever an earlier test left in os.environ
            routers[name] = Pkg(name).router(
                workers=2, backend="verdict",
                env={"SERVE_MAX_WAIT_MS": "2",
                     "CONSENSUS_SPECS_TPU_TS": "0"})
        yield routers
    finally:
        for router in routers.values():
            router.close()


@pytest.fixture
def fleet(fleets, pkg):
    return fleets[pkg.name]


def test_fleet_verdict_identity_and_affinity(fleet, pkg):
    pks = [_pk(1), _pk(2)]
    futs, want = [], []
    for i in range(24):
        msg = bytes([i]) * 32
        sig = pkg.load.BAD_SIGNATURE if i % 6 == 5 else bytes([i]) * 96
        futs.append(fleet.submit("fast_aggregate", pks, msg, sig))
        want.append(i % 6 != 5)
    assert [f.result(timeout=30) for f in futs] == want
    # affinity: identical content goes to the same worker and is
    # answered by ITS cache
    snaps = fleet.poll_snapshots()
    hits_before = {w: s["extra"]["serve"]["cache_hits"]
                   for w, s in snaps.items()}
    futs = [fleet.submit("fast_aggregate", pks, bytes([i]) * 32,
                         bytes([i]) * 96) for i in range(4)]
    assert all(f.result(timeout=30) for f in futs)
    snaps = fleet.poll_snapshots()
    gained = sum(s["extra"]["serve"]["cache_hits"] - hits_before[w]
                 for w, s in snaps.items())
    assert gained == 4


def test_both_packages_fleets_route_and_answer_alike(fleets):
    """The same 32 checks (numpy-seeded content, every sixth one bad)
    through both packages' 2-worker verdict fleets: the same verdicts,
    and each check routed to the same worker label."""
    rng = np.random.default_rng(5)
    checks = []
    for i in range(32):
        pks = [bytes(rng.integers(0, 256, size=48, dtype=np.uint8))]
        msg = bytes(rng.integers(0, 256, size=32, dtype=np.uint8))
        sig = (jload.BAD_SIGNATURE if i % 6 == 5
               else bytes(rng.integers(0, 256, size=96, dtype=np.uint8)))
        checks.append(("fast_aggregate", pks, msg, sig))
    got = {}
    for name, router in fleets.items():
        p = Pkg(name)
        labels = [router.route_label(p.cache.check_key(*c)) for c in checks]
        verdicts = [f.result(timeout=30)
                    for f in [router.submit(*c) for c in checks]]
        got[name] = (labels, verdicts)
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == [i % 6 != 5 for i in range(32)]
    assert set(got["torch"][0]) == {"w0", "w1"}


def test_fleet_merged_scrape_is_exact_merge_of_worker_snapshots(fleet):
    snaps = fleet.poll_snapshots()
    label = "serve.submit_to_result"
    wires = [s["hists"][label] for s in snaps.values()]
    expect_count = sum(w["count"] for w in wires)
    expect_buckets = {}
    for w in wires:
        for idx, n in w["counts"].items():
            expect_buckets[int(idx)] = expect_buckets.get(int(idx), 0) + n
    merged = fleet.aggregator.merged_hists()[label]
    assert merged.count == expect_count
    assert merged.state()["counts"] == expect_buckets
    fam = ("consensus_specs_tpu_serve_submit_to_result_latency_hist_"
           "seconds_count")
    text = fleet.scrape_text()
    [count_line] = [ln for ln in text.splitlines()
                    if ln.startswith(fam + " ")]
    assert int(count_line.rsplit(" ", 1)[1]) == expect_count
    assert 'label="serve[w0].queue_depth"' in text
    assert 'label="process[w1].rss_bytes"' in text


def test_either_aggregator_merges_either_packages_snapshots_alike(fleets):
    """A JAX worker's snapshot and a port worker's snapshot, each fed to
    both packages' aggregators (and both together): the same Prometheus
    text, the same merged histograms and the same journal."""
    snaps = {name: router.poll_snapshots() for name, router in
             fleets.items()}
    feeds = [{"w0": snaps["jax"]["w0"]}, {"w1": snaps["torch"]["w1"]},
             {"w0": snaps["jax"]["w0"], "w1": snaps["torch"]["w1"]}]
    for feed in feeds:
        wire = json.loads(json.dumps(feed))  # what crosses the pipe
        out = {}
        for name in PKGS:
            aggr = Pkg(name).ofleet.FleetAggregator()
            for worker, snap in wire.items():
                aggr.ingest(worker, snap)
            out[name] = (aggr.render_metrics(),
                         {k: h.state() for k, h in
                          aggr.merged_hists().items()},
                         aggr.journal_events())
        assert out["torch"] == out["jax"], sorted(feed)
        assert "consensus_specs_tpu_unregistered" not in out["torch"][0]


def test_fleet_healthz_and_exposition_endpoint(fleet):
    server = fleet.start_exposition(port=0)
    try:
        with urllib.request.urlopen(server.url("/healthz"),
                                    timeout=10) as resp:
            hz = json.loads(resp.read())
        assert hz["ok"] is True and hz["workers"] == ["w0", "w1"]
        with urllib.request.urlopen(server.url("/metrics"),
                                    timeout=10) as resp:
            body = resp.read().decode()
        assert "consensus_specs_tpu_fleet_workers 2.0" in body
        with urllib.request.urlopen(server.url("/snapshot"),
                                    timeout=10) as resp:
            doc = json.loads(resp.read())
        assert sorted(doc["workers"]) == ["w0", "w1"]
    finally:
        server.close()


def test_fleet_timeseries_and_stitched_trace_surfaces(fleet, tmp_path):
    """The router's /timeseries document (no worker armed the TSDB: an
    empty merge) and its stitched Chrome dump (no worker traced: the
    router's own lanes, no worker pids)."""
    doc = fleet.timeseries_doc()
    assert doc["levels"] == [] and doc["v"] == 1
    path = fleet.dump_trace(str(tmp_path / "fleet_trace.json"))
    with open(path) as fh:
        trace = json.load(fh)
    assert trace["otherData"]["workerPids"] == {}
    assert isinstance(trace["traceEvents"], list)


def test_worker_protocol_answers_unknown_ops_with_errors(fleet, pkg):
    with pytest.raises(pkg.fleet.WorkerProtocolError, match="unknown op"):
        fleet.handle("w0").rpc({"op": "no_such_op"}, timeout=10)


def test_port_workers_report_their_device_and_no_kernel(fleets):
    """Verdict workers on the CPU: the device is the router's, CUDA was
    never initialized and no kernel module was loaded (0 launches);
    background warming of the fused VM lowering is armed, as in the JAX
    workers, and left the launch counts exact (a verdict worker runs no
    program, so its warm thread captured and launched nothing)."""
    for label, snap in fleets["torch"].poll_snapshots().items():
        extra = snap["extra"]
        assert extra["device"] == "cpu", label
        assert extra["cuda_initialized"] is False
        assert extra["warm_bg"] is True
        assert extra["kernels"] == {"vm_step": 0, "vm_step_steps": 0,
                                    "mont_mul": 0, "mont_mul_captures": 0}


def _replay(pkg):
    if pkg.name == "jax":
        from consensus_specs_tpu.sim.fleet_replay import run_fleet_replay
    else:
        from consensus_specs_tpu_torch.sim.fleet_replay import (
            run_fleet_replay)
    return run_fleet_replay


def test_sim_partition_heal_replayed_against_the_live_fleet(fleet, pkg):
    """tests/test_fleet.py's simnet case: a real scenario, real worker
    processes doing every node's verification, and the strict
    differential convergence gate still green; the port's run gives the
    JAX package's digest and head (the script does not depend on the
    fleet), and its workers report the router's device."""
    out = _replay(pkg)("partition_heal", strict=True, router=fleet)
    assert out["report"].converged
    assert out["fleet"]["routed"] > 0
    submits = [w["submits"] for w in out["fleet"]["per_worker"].values()]
    assert sum(submits) > 0 and len(submits) == 2
    assert out["report"].digest == "32cd72ad34dcfbce"
    if pkg.name == "torch":
        assert {w["device"] for w in out["fleet"]["per_worker"].values()} \
            == {"cpu"}


def test_fleet_merged_scrape_carries_gossip_to_head(pkg):
    """tests/test_latency.py's fleet case: router-side HeadServices consume
    fleet-routed verdicts while the end-to-end histogram accumulates in
    the router process; the merged fleet scrape and /healthz carry it
    beside the worker families."""
    router = pkg.router(workers=2, backend="verdict",
                        env={"SERVE_MAX_WAIT_MS": "2"})
    try:
        out = _replay(pkg)("partition_heal", router=router, seed=7,
                           strict=True)
        assert out["report"].converged
        text = router.scrape_text()
        fam = ("consensus_specs_tpu_latency_gossip_to_head_latency_hist_"
               "seconds_count")
        [line] = [ln for ln in text.splitlines()
                  if ln.startswith(fam + " ")]
        assert int(line.rsplit(" ", 1)[1]) > 0
        assert "consensus_specs_tpu_serve_node" in text
        health = router.healthz()
        assert health["slo"]["gossip_to_head_p99"]["n"] > 0
    finally:
        router.close()


# -- forced fault -> burn -> shed escalation (its own fleet) ----------------


def test_fault_burns_merged_slo_and_sheds_then_drains(pkg, monkeypatch):
    """The control loop end to end: a slow-fault on one worker lights up
    the MERGED histograms, the policy sheds THAT worker down the ladder
    (journaled on both sides), hold-down-free ticks escalate to rung 2 and
    then drain, and the drained worker's keys re-home."""
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "1")
    pkg.flight.reset_global()
    objectives = [{"name": "serve_p99", "label": "serve.submit_to_result",
                   "quantile": 99.0, "threshold_s": 0.05}]
    router = pkg.router(
        workers=2, backend="verdict",
        env={"SERVE_MAX_WAIT_MS": "2", "CONSENSUS_SPECS_TPU_FLIGHT": "1"},
        objectives=objectives,
        policy=pkg.slo.ShedPolicy(shed_burn=2.0, drain_burn=10000.0),
        holddown_s=0.0)
    try:
        pks = [_pk(3)]
        futs = [router.submit("fast_aggregate", pks, bytes([i]) * 32,
                              bytes([i]) * 96) for i in range(6)]
        [f.result(timeout=30) for f in futs]
        router.control_tick()  # baseline checkpoint: clean traffic

        target, items, i = None, [], 50
        while len(items) < 6 and i < 250:
            msg, sig = bytes([i]) * 32, bytes([i]) * 96
            label = router.route_label(
                pkg.cache.check_key("fast_aggregate", pks, msg, sig))
            if target is None:
                target = label
            if label == target:
                items.append((msg, sig))
            i += 1
        router.handle(target).inject_fault(calls=64, mode="slow", ms=150)
        futs = [router.submit("fast_aggregate", pks, m, s)
                for m, s in items]
        assert all(f.result(timeout=60) for f in futs)

        time.sleep(1.1)  # checkpoint spacing
        tick = router.control_tick()
        assert tick["decisions"], f"no decision: {tick['slo']}"
        d = tick["decisions"][0]
        assert d["worker"] == target and d["action"] == "shed"
        assert d["rung_to"] == 1 and d["burn"] >= 2.0
        snap = router.poll_snapshots()[target]
        assert snap["extra"]["ladder_rung"] == 1

        d2 = router.control_tick()["decisions"][0]
        assert (d2["action"], d2["rung_to"]) == ("shed", 2)
        d3 = router.control_tick()["decisions"][0]
        assert d3["action"] == "drain"
        assert router.live_workers == [w for w in ("w0", "w1")
                                       if w != target]

        events = [json.loads(ln) for ln in
                  router.journal_jsonl().splitlines()[1:]]
        fleet_kinds = [e["kind"] for e in events if e["plane"] == "fleet"]
        assert fleet_kinds.count("shed") == 2 and "drain" in fleet_kinds
        transitions = [e["data"] for e in events
                       if e["kind"] == "shed_rung"
                       and e.get("worker") == target]
        assert [(t["rung_from"], t["rung_to"]) for t in transitions] == \
            [(0, 1), (1, 2)]

        fut = router.submit("fast_aggregate", pks, b"\xee" * 32,
                            b"\xdd" * 96)
        assert fut.result(timeout=30) is True
        assert router.sheds == 2 and router.drains == 1
    finally:
        router.close()
        pkg.flight.reset_global()


def test_drain_answers_submits_already_on_the_pipe(pkg):
    router = pkg.router(workers=1, backend="verdict",
                        env={"SERVE_MAX_WAIT_MS": "2"})
    try:
        h = router.handle("w0")
        h.rpc({"op": "drain"}, timeout=10)
        # acked, stdin still open: this submit sits behind the drain
        fut = h.submit("fast_aggregate", [_pk(1)], b"\x02" * 32,
                       b"\x03" * 96)
        assert fut.result(timeout=30) is True
    finally:
        router.close()


def test_crashed_worker_is_reaped_from_the_ring(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "1")
    pkg.flight.reset_global()
    router = pkg.router(workers=2, backend="verdict",
                        env={"SERVE_MAX_WAIT_MS": "2"})
    try:
        victim = router.route_label(b"\xaa" * 32)
        router.handle(victim)._proc.kill()
        router.handle(victim)._proc.wait(timeout=10)
        router.control_tick()
        assert victim not in router.live_workers
        survivor = [w for w in ("w0", "w1") if w != victim][0]
        for i in range(16):
            assert router.route_label(bytes([i]) * 32) == survivor
        fut = router.submit("fast_aggregate", [_pk(9)], b"\xaa" * 32,
                            b"\xbb" * 96)
        assert fut.result(timeout=30) is True
        lost = [e for e in router.journal_jsonl().splitlines()[1:]
                if json.loads(e)["kind"] == "worker_lost"]
        assert len(lost) == 1
        assert json.loads(lost[0])["data"]["worker"] == victim
    finally:
        router.close()
        pkg.flight.reset_global()


# -- devices, flight paths, registry -----------------------------------------


def test_port_worker_without_a_card_raises_at_startup(monkeypatch):
    """A port worker given no device on a machine without a card exits
    at startup with the device error (no CPU default anywhere), and the
    port's router given no device refuses to start."""
    import subprocess
    import sys

    import torch

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CONSENSUS_SPECS_TPU_FLEET")}
    env["CONSENSUS_SPECS_TPU_FLEET_BACKEND"] = "verdict"
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, here or on a GPU machine
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "consensus_specs_tpu_torch.serve.worker"],
        env=env, input="", capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""  # never reported ready
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.FleetRouter(workers=1, backend="verdict")


def test_flight_dump_paths_are_worker_suffixed(pkg, tmp_path, monkeypatch):
    base = str(tmp_path / "flight_dump.jsonl")
    monkeypatch.delenv(pkg.flight.WORKER_ENV, raising=False)
    assert pkg.flight.resolve_dump_path(base) == base  # untouched outside
    monkeypatch.setenv(pkg.flight.WORKER_ENV, "w3")
    resolved = pkg.flight.resolve_dump_path(base)
    assert resolved.endswith(f".w3-pid{os.getpid()}.jsonl")
    rec = pkg.flight.FlightRecorder()
    rec.note("serve", "flush", items=1)
    written = rec.dump(base, reason="test")
    assert written == resolved and os.path.exists(written)
    monkeypatch.setenv(pkg.flight.WORKER_ENV, "w4")
    assert pkg.flight.resolve_dump_path(base) != resolved


def test_fleet_gauges_are_registered_and_documented_shapes(pkg):
    for name in ("fleet.workers", "fleet.snapshots", "fleet.requests",
                 "fleet.sheds", "fleet.drains", "serve.ladder_rung",
                 "slo.ok", "timeseries.points", "process.rss_bytes",
                 "scale.committees_routed", "scale.affinity_moves"):
        assert pkg.registry.known(name), f"{name} unregistered"
    assert pkg.registry.known("serve[w0].submit_to_result")
    assert pkg.registry.known("process[w0].rss_bytes")
    assert pkg.registry.node_label("serve.ladder_rung", "w1") == \
        "serve[w1].ladder_rung"


def test_slo_tracker_accepts_explicit_hists(pkg):
    h = pkg.hist.Histogram()
    for v in (0.01, 0.02, 5.0):
        h.observe(v)
    clock = [0.0]
    tracker = pkg.slo.SloTracker(
        objectives=[{"name": "serve_p99",
                     "label": "serve.submit_to_result",
                     "quantile": 99.0, "threshold_s": 1.0}],
        clock=lambda: clock[0])
    tracker.evaluate(hists={"serve.submit_to_result": pkg.hist.Histogram()},
                     export=False)
    clock[0] = 120.0
    out = tracker.evaluate(hists={"serve.submit_to_result": h},
                           export=False)["serve_p99"]
    assert out["n"] == 3 and out["ok"] is False
    assert out["burn_rate"]["60s"] == pytest.approx((1 / 3) / 0.01)
    assert "slo.ok" not in pkg.profiling.stats_and_gauges()[1]


# -- a bls port worker on the CPU against the JAX single-process service ----


@pytest.fixture
def _reference_modes(monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_VM_EXEC", "interp")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_PALLAS", "0")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_RLC_CHUNK", "2")
    for var in ("CONSENSUS_SPECS_TPU_HARD_PART", "CONSENSUS_SPECS_TPU_RLC_FINAL",
                "CONSENSUS_SPECS_TPU_RLC_BACKEND", "CONSENSUS_SPECS_TPU_RLC",
                "CONSENSUS_SPECS_TPU_BATCH_CODEC", "CONSENSUS_SPECS_TPU_MESH",
                "CONSENSUS_SPECS_TPU_FINAL_EXP_WINDOW_MS"):
        monkeypatch.delenv(var, raising=False)


def test_bls_port_worker_answers_as_the_jax_service(_reference_modes):
    """tests/test_torch_serve.py's two committees of k=2 (one good, one
    whose signature does not match its keys) and a repeat, through ONE
    port ``bls`` worker with ``device="cpu"`` and through the JAX
    single-process service on its real backend: exact verdicts."""
    from consensus_specs_tpu.serve import VerificationService
    from consensus_specs_tpu.utils import bls as jbls_api

    was = jbls_api.bls_active
    jbls_api.bls_active = True
    sk1, sk2 = 41, 42
    pk1, pk2 = jbls_api.SkToPk(sk1), jbls_api.SkToPk(sk2)
    msg = b"\x05" * 32
    agg = jbls_api.Aggregate([jbls_api.Sign(sk1, msg),
                              jbls_api.Sign(sk2, msg)])
    items = [("fast_aggregate", [pk1, pk2], msg, agg),
             ("fast_aggregate", [pk1, pk1], msg, agg)]
    try:
        svc = VerificationService(max_batch=2, max_wait_ms=10_000)
        try:
            want = [f.result(timeout=300)
                    for f in [svc.submit(*it) for it in items]]
            want.append(svc.submit(*items[0]).result(timeout=60))
        finally:
            svc.close(timeout=60)
    finally:
        jbls_api.bls_active = was
    router = tfleet.FleetRouter(
        workers=1, backend="bls", device="cpu",
        env={"SERVE_MAX_BATCH": "2", "SERVE_MAX_WAIT_MS": "10000"})
    try:
        got = [f.result(timeout=600)
               for f in [router.submit(*it) for it in items]]
        got.append(router.submit(*items[0]).result(timeout=120))
        snap = router.poll_snapshots()["w0"]
    finally:
        router.close()
    assert want == [True, False, True]
    assert got == want
    serve = snap["extra"]["serve"]
    assert serve["fallback_items"] == 0 and serve["cache_hits"] == 1
    assert snap["extra"]["device"] == "cpu"
