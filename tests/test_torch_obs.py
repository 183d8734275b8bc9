"""The port's observability plane (consensus_specs_tpu_torch/ops/
profiling.py and obs/) against the JAX package's, on the CPU.

The same seeded samples, records, stages, spans and journal events go
through both packages; histograms, summaries, the downstream p99, node
labels, the Chrome export of a fixed span sequence on a fixed clock and
the flight journal must come out equal. Then the port's own hooks: the
``vm.execute`` timing, ledger and tracer notes, the backend's counters
and gauges, and ``profiling.trace`` on torch.profiler.
"""
import json
import os

import numpy as np
import pytest
import torch

from consensus_specs_tpu.obs import devices as jdevices
from consensus_specs_tpu.obs import flight as jflight
from consensus_specs_tpu.obs import hist as jhist
from consensus_specs_tpu.obs import latency as jlatency
from consensus_specs_tpu.obs import registry as jregistry
from consensus_specs_tpu.obs import tracing as jtracing
from consensus_specs_tpu.ops import profiling as jprofiling
from consensus_specs_tpu_torch.obs import devices, flight, hist, latency
from consensus_specs_tpu_torch.obs import programs as obs_programs
from consensus_specs_tpu_torch.obs import registry, tracing
from consensus_specs_tpu_torch.ops import profiling
from tests.torch_threads import one_thread

one_thread()

BOTH = {
    "jax": (jprofiling, jlatency, jhist),
    "torch": (profiling, latency, hist),
}


@pytest.fixture(autouse=True)
def _clean():
    for prof, lat, _ in BOTH.values():
        prof.reset()
        lat.reset()
    yield
    for prof, lat, _ in BOTH.values():
        prof.reset()
        lat.reset()


def _samples(seed, n=2000):
    """Seeded latencies spanning ~7 decades, zeros and edges included."""
    rng = np.random.default_rng(seed)
    xs = np.exp(rng.uniform(np.log(1e-6), np.log(20.0), n))
    return [0.0, 1e-300, 1e300] + [float(x) for x in xs]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_histograms_equal(seed):
    xs = _samples(seed)
    half = len(xs) // 2
    got = {}
    for name, (_, _, h_mod) in BOTH.items():
        a, b, whole = h_mod.Histogram(), h_mod.Histogram(), h_mod.Histogram()
        for x in xs[:half]:
            a.observe(x)
        for x in xs[half:]:
            b.observe(x)
        for x in xs:
            whole.observe(x)
        merged = a.merge(b)
        assert merged.state() == whole.state()
        got[name] = {
            "state": merged.state(),
            "percentiles": [merged.percentile(q)
                            for q in (0.1, 1, 25, 50, 90, 95, 99, 99.9, 100)],
            "over": [merged.count_over(t) for t in (1e-4, 0.01, 1.0, 10.0)],
            "buckets": list(merged.buckets()),
            "summary": merged.summary(),
        }
    assert got["torch"] == got["jax"]


def _drive(prof, lat):
    """One fixed sequence of records, latencies, gauges and stages."""
    rng = np.random.default_rng(7)
    for i in range(50):
        prof.record("serve.prep_flush", float(rng.uniform(0, 0.2)))
        prof.record_latency("serve.submit_to_result",
                            float(rng.exponential(0.05)))
        for stage in ("prep", "device", "finalize", "queue_wait"):
            lat.note_stage(stage, float(rng.exponential(0.01)))
    prof.record("serve.rlc_error", 0.0)
    prof.set_gauge("serve.queue_depth", 3)
    prof.set_gauge("bls.final_exps", 12)
    with prof.timed("vm[steps=4,regs=8,batch=(2,),sharded=False]"):
        pass


def test_profiling_summary_and_downstream_p99_equal():
    got = {}
    for name, (prof, lat, _) in BOTH.items():
        _drive(prof, lat)
        summ = prof.summary()
        # the timed block's wall differs between the two runs
        summ.pop("vm[steps=4,regs=8,batch=(2,),sharded=False]")
        got[name] = (summ, lat.downstream_p99_s(max_age_s=0.0),
                     {k: v.state() for k, v in
                      prof.latency_histograms().items()},
                     lat.snapshot())
    assert got["torch"] == got["jax"]
    assert got["torch"][1] > 0
    assert profiling.snapshot() == profiling.summary()


@pytest.mark.parametrize("base,node", [
    ("serve.queue_depth", None), ("serve.queue_depth", "n0"),
    ("serve.submit_to_result", "node-7"), ("serve.cache_hit_rate", "a"),
])
def test_node_label_equal(base, node):
    assert registry.node_label(base, node) == jregistry.node_label(base, node)


def test_registry_knows_every_label_the_port_publishes():
    for label in ("serve.prep_error", "serve.rlc_error", "serve.backend_error",
                  "bls.rlc_combines", "bls.final_exp_rows_inflight",
                  "bls.prep_serial_fallback_items", "hist.families",
                  "device[host]", "latency[prep]", "flight.events",
                  "vm[steps=1,regs=2,batch=(1,),sharded=False]"):
        assert registry.known(label), label
    # the chain plane is the port's since it has its own spec, and the
    # light client's families since it has the proof plane
    assert registry.node_label("chain.head_slot", "n0") == \
        jregistry.node_label("chain.head_slot", "n0")
    assert registry.node_label("lightclient.updates_verified", "n0") == \
        jregistry.node_label("lightclient.updates_verified", "n0")
    for label in ("lightclient.proofs_served", "latency[proof_serve]",
                  "lightclient[n0].cache_hit_rate"):
        assert registry.known(label), label


def test_render_prometheus_histogram_lines():
    _drive(profiling, latency)
    text = registry.render_prometheus()
    name = "consensus_specs_tpu_serve_submit_to_result_latency_hist_seconds"
    assert f"# TYPE {name} histogram" in text
    assert f'{name}_bucket{{le="+Inf"}} 50' in text
    assert f"{name}_count 50" in text
    assert "consensus_specs_tpu_unregistered" not in text


def _fixed_trace(mod):
    """A fixed span sequence on a fixed clock through ``mod.Tracer``."""
    ticks = iter(np.arange(1.0, 200.0, 0.25).tolist())
    tr = mod.Tracer(capacity=8, exemplar_capacity=4,
                    clock=lambda: next(ticks))
    for rid in range(6):
        t = 2.0 + rid
        req = tr.begin("fast_aggregate", 3 + rid, t,
                       flow=100 + rid if rid % 2 else None)
        if rid == 5:
            tr.span(req, "ingress", t - 0.5, t)
        tr.span(req, "queue_wait", t, t + 0.01)
        tr.span_many([req, None], "prep", t + 0.01, t + 0.02)
        tr.span(req, "device", t + 0.02, t + 0.05 * (rid + 1))
        tr.span(req, "combine", t + 0.03, t + 0.04)
        tr.span(req, "finalize", t + 0.05 * (rid + 1), t + 0.06 * (rid + 1))
        tr.finish(req, rid != 3, t + 0.06 * (rid + 1))
    tr.note_execution(steps=256, regs=64, batch=(2,), sharded=False,
                      t0=0.5, seconds=0.125)
    return tr


def test_chrome_export_equal():
    got = {}
    for name, mod in (("jax", jtracing), ("torch", tracing)):
        doc = _fixed_trace(mod).to_chrome()
        doc.pop("programRegistry")  # each package's own program registry
        got[name] = json.loads(json.dumps(doc, sort_keys=True))
    assert got["torch"] == got["jax"]
    names = {e["name"] for e in got["torch"]["traceEvents"]}
    assert set(tracing.STAGES) | set(tracing.LATENCY_STAGES) <= names


def test_flight_journal_equal():
    out = {}
    for name, mod in (("jax", jflight), ("torch", flight)):
        ticks = iter(np.arange(10.0, 20.0, 0.5).tolist())
        rec = mod.FlightRecorder(capacity=4, clock=lambda: next(ticks),
                                 node="n1")
        rec.note("serve", "flush", items=3, groups=1)
        rec.note("serve", "backend_retry", stage="rlc", attempt=1)
        rec.note("vm", "final_exp_route", route="device", rows=2)
        rec.note("serve", "degraded_to_oracle", items=3)
        rec.note("serve", "cache_hit", check_kind="fast_aggregate")
        out[name] = (rec.to_jsonl("test"), rec.counters(),
                     rec.chrome_events(lambda t: round(t * 1e6, 3)))
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["dropped"] == 1


def test_flight_dump_on_fault(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_ENV, "1")
    monkeypatch.setenv(flight.DUMP_ENV, str(tmp_path / "journal.jsonl"))
    flight.reset_global()
    try:
        rec = flight.maybe_recorder()
        assert rec is flight.maybe_recorder()
        flight.note("vm", "program_resolved", key="k")
        path = rec.dump_on_fault("test_fault")
        lines = open(path).read().splitlines()
        header = json.loads(lines[0])
        assert header["reason"] == "test_fault" and header["events"] == 2
        assert json.loads(lines[-1])["kind"] == "fault"
    finally:
        flight.reset_global()
    monkeypatch.delenv(flight.FLIGHT_ENV)
    assert flight.maybe_recorder() is None


def test_device_ledger_equal_and_lanes():
    snaps = []
    for mod in (jdevices, devices):
        ticks = iter([0.0, 10.0])
        led = mod.DeviceLedger(clock=lambda: next(ticks))
        led.note_busy(mod.HOST_LANE, 1.0, 2.5, label="prep")
        led.note_busy(0, 2.0, 4.0, label="vm[steps=8]")
        led.note_busy(0, 5.0, 4.5)  # reversed interval
        snaps.append((led.snapshot(), led.timeline()))
    assert snaps[0] == snaps[1]
    assert devices.lane_of(torch.device("cpu")) == "cpu"
    assert devices.lane_of("cuda:1") == 1


@pytest.mark.parametrize("capacity", [4, 1024])
def test_device_lane_busy_is_the_union_of_its_intervals(monkeypatch,
                                                        capacity):
    """Two threads busy on one lane at once count that time once: a
    lane's busy seconds equal the length of the union of its intervals
    (here 200 seeded overlapping intervals, noted in order of their ends,
    as concurrent threads note them), and the share is not capped."""
    monkeypatch.setattr(devices, "INTERVAL_CAPACITY", capacity)
    rng = np.random.default_rng(5)
    starts = np.cumsum(rng.uniform(0.0, 0.5, 200))
    spans = sorted(((a, a + d) for a, d in
                    zip(starts, rng.uniform(0.0, 1.5, 200))),
                   key=lambda iv: iv[1])
    ticks = iter([0.0, 1.0])
    led = devices.DeviceLedger(clock=lambda: next(ticks))
    for a, b in spans:
        led.note_busy(0, a, b)
    union, hi = 0.0, -1.0
    for a, b in sorted(spans):
        union += max(0.0, b - max(a, hi))
        hi = max(hi, b)
    assert union < sum(b - a for a, b in spans)
    assert led._lanes[0].busy_s == pytest.approx(union, rel=1e-12)
    assert led.utilization(now=1.0)["0"] == pytest.approx(union,
                                                          rel=1e-12)


def _tiny_program():
    from consensus_specs_tpu_torch.ops import vm

    p = vm.Prog()
    a = p.inp("a")
    p.out(a * a + a, "y")
    return p.assemble(w_mul=2, w_lin=4)


def test_vm_execute_notes_time_lane_and_trace(monkeypatch):
    from consensus_specs_tpu_torch.ops import fq, vm

    monkeypatch.setenv(tracing.TRACE_ENV, "1")
    tracing.reset_global()
    devices.reset_global()
    try:
        prog = _tiny_program()
        out = vm.execute(prog, {"a": np.stack([fq.to_mont_int(3)] * 2)},
                         batch_shape=(2,), device="cpu")
        assert fq.from_mont_limbs(out["y"][1]) == 12
        label = (f"vm[steps={prog.n_steps},regs={prog.n_regs},"
                 "batch=(2,),sharded=False]")
        assert profiling.summary()[label]["calls"] == 1
        lanes = devices.global_ledger().snapshot()["lanes"]
        assert lanes["cpu"]["events"] == 1
        (ex,) = tracing.global_tracer().executions()
        assert (ex["steps"], ex["batch"]) == (prog.n_steps, [2])
    finally:
        tracing.reset_global()
        devices.reset_global()


def test_dump_trace_composes_lanes(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_ENV, "1")
    flight.reset_global()
    tracing.reset_global()
    devices.reset_global()
    try:
        devices.global_ledger().note_busy(devices.HOST_LANE, 1.0, 2.0,
                                          label="prep")
        flight.note("serve", "flush", items=1)
        tr = tracing.global_tracer()
        req = tr.begin("fast_aggregate", 1, 1.5)
        tr.span(req, "prep", 1.5, 1.6)
        tr.finish(req, True, 1.7)
        doc = json.load(open(tracing.dump_trace(str(tmp_path / "t.json"))))
        pids = {e.get("pid") for e in doc["traceEvents"]}
        assert {1, 2, 3, 4} <= pids
        assert min(e.get("ts", 0) for e in doc["traceEvents"]) >= 0
        assert "vm_cache" in doc["programRegistry"]
    finally:
        flight.reset_global()
        tracing.reset_global()
        devices.reset_global()


def test_backend_counters_gauges_and_calls_match_reference():
    from consensus_specs_tpu.ops import bls_backend as jbls
    from consensus_specs_tpu_torch.ops import bls_backend as tbls

    got = {}
    for name, mod, kw in (("jax", jbls, {}), ("torch", tbls,
                                             {"device": "cpu"})):
        mod.reset_call_counts()
        mod.reset_rlc_stats()
        mod.batch_fast_aggregate_verify([], [], [], **kw)
        mod.batch_aggregate_verify([], [], [], **kw)
        mod.batch_verify_rlc([], **kw)
        got[name] = dict(mod.CALL_COUNTS)
    assert got["torch"] == got["jax"] == {
        "batch_fast_aggregate_verify": 1, "batch_aggregate_verify": 1,
        "batch_verify_rlc": 1, "items": 0}
    tbls.reset_call_counts()
    assert set(tbls.CALL_COUNTS.values()) == {0}
    summ = profiling.summary()
    for label in ("bls.rlc_combines", "bls.rlc_bisections", "bls.final_exps"):
        assert summ[label] == {"gauge": 0.0}
    assert tbls.rlc_enabled() == jbls.rlc_enabled()


def test_program_resolution_is_registered():
    from consensus_specs_tpu_torch.ops import bls_backend

    bls_backend._program("hard_part_frobenius", 0, 1)
    snap = obs_programs.registry_snapshot()
    entry = snap["programs"]["hard_part_frobenius[k=0,fold=1]"]
    assert entry["steps"] > 0 and entry["vm_cache"] in ("hit", "miss")
    assert sum(snap["vm_cache"].values()) >= 1


def test_profiling_trace_writes_a_torch_profiler_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert any(f.endswith(".json") for f in files), files


def test_counters_exact_under_threads():
    """More threads than cores bump the backend's counters and kernel 2's
    launch count with a short switch interval: no update is lost, and a
    thread inside a chain capture tallies its launches apart instead of
    touching the global count."""
    import sys
    import threading

    from consensus_specs_tpu_torch.ops import bls_backend, cuda_fq

    n_threads, n = 2 * (os.cpu_count() or 1) + 2, 300
    bls_backend.reset_call_counts()
    rlc0 = dict(bls_backend.RLC_STATS)
    launches0 = cuda_fq.LAUNCHES
    tallies = []
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait(30)
        capturing = i % 2 == 1
        if capturing:
            cuda_fq._THREAD.capture = [0]
        try:
            for _ in range(n):
                bls_backend._count_call("batch_verify_rlc", 3)
                bls_backend._bump(bls_backend.RLC_STATS, combines=1,
                                  final_exps=2)
                cuda_fq._count_launch()
        finally:
            if capturing:
                tallies.append(cuda_fq._THREAD.capture[0])
                cuda_fq._THREAD.capture = None

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n
    assert bls_backend.CALL_COUNTS["batch_verify_rlc"] == total
    assert bls_backend.CALL_COUNTS["items"] == 3 * total
    assert bls_backend.RLC_STATS["combines"] - rlc0["combines"] == total
    assert bls_backend.RLC_STATS["final_exps"] - rlc0["final_exps"] == 2 * total
    capturing = n_threads // 2
    assert tallies == [n] * capturing
    assert cuda_fq.LAUNCHES - launches0 == (n_threads - capturing) * n
    bls_backend.reset_call_counts()
